"""Parity of the port's doubly-permuted DFT, mirror, noise-plane and
row-power modules (``orphics_tpu_torch.ops.dft``, ``.mirror``,
``.noise_planes``, ``.rowpower``; kernels B3, B4, B4b, B5, B5n, B6 and B7)
with ``orphics_tpu.ops.pallas_fft``.

The JAX side runs its Pallas kernels with ``interpret=True``, as the JAX
package's own tests do; the port runs its plain versions (CPU tensors).
Inputs come from a numpy seed. Bounds: the layout tables and the mirror
are array-equal; the transforms agree to 2e-5 of max|ref|, inside the
JAX tests' own 1e-5 to 3e-5 against numpy (tests/test_core.py), since
both sides are fp32 transforms by different factorizations. The lane
chunk 0 and the fused half-plane fields agree to 1e-5 of max|ref| (~4e-7
seen).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from orphics_tpu import geometry as jgeo
from orphics_tpu.ops import pallas_fft as pf

import orphics_tpu_torch as tp
from orphics_tpu_torch.ops import dft as D
from orphics_tpu_torch.ops import mirror as M
from orphics_tpu_torch.ops import rowpower as RP
from orphics_tpu_torch.ops.noise_planes import noise_planes, seed_words

torch.set_num_threads(1)

TOL = 2e-5
TOL_QC = 1e-5

# port function name -> (JAX function, takes a scale plane)
_FUNCS = {
    "colfft": (pf.colfft, False),
    "colifft": (pf.colifft, False),
    "rowfft": (pf.rowfft, False),
    "rowifft": (pf.rowifft, False),
    "rowifft_scaled_y": (pf.rowifft_scaled_y, True),
    "fft2pp": (pf.fft2pp, False),
    "ifft2pp": (pf.ifft2pp, False),
    "ifft2pp_scaled": (pf.ifft2pp_scaled, True),
}


@pytest.fixture(scope="module", params=[256, 384])
def case(request):
    """Inputs at (2, n, n) and every JAX output, computed once per n."""
    n = request.param
    rng = np.random.default_rng(n)
    xr = rng.standard_normal((2, n, n)).astype(np.float32)
    xi = rng.standard_normal((2, n, n)).astype(np.float32)
    sc = rng.uniform(0.5, 2.0, (n, n)).astype(np.float32)
    jx = (jnp.asarray(xr), jnp.asarray(xi))
    ref = {}
    for name, (fn, scaled) in _FUNCS.items():
        args = jx + ((jnp.asarray(sc),) if scaled else ())
        ref[name] = tuple(np.array(a) for a in fn(*args, interpret=True))
    ref["mirror_pp"] = tuple(np.array(a) for a in
                             pf.mirror_pp(*jx, interpret=True))
    for name in ("rowfft_blk0", "rowqc_pp", "fft2pp_qc"):
        ref[name] = tuple(np.array(a) for a in
                          getattr(pf, name)(*jx, interpret=True))
    return n, (xr, xi, sc), ref


@pytest.mark.parametrize("n", [256, 384, 640, 2048])
def test_layout_tables_match_jax(n):
    for got, want in zip(D.row_perm(n), pf.row_perm(n)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for got, want in zip(D.full_perm(n), pf.full_perm(n)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(M._mirror_tables(n),
                                  pf._mirror_tables(n)[0])
    for got, want in zip(D._plan(n, False) + D._plan(n, True),
                         pf._plan(n, False) + pf._plan(n, True)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [256, 384])
def test_permuted_bin_tables_match_jax(n):
    jg = jgeo.rect_geometry(width_arcmin=n * 2.0, px_res_arcmin=2.0)
    tg = tp.rect_geometry(width_arcmin=n * 2.0, px_res_arcmin=2.0)
    edges = np.arange(40, 3000, 80.0)
    perm, _ = D.row_perm(n)
    ml_t = tg.modlmap(torch.float32).double().numpy()
    ml_j = np.asarray(jg.modlmap(jnp.float32), np.float64)
    # the fp32 |l| planes differ by an ulp here and there (XLA's sqrt)
    assert np.abs(ml_t - ml_j).max() <= 2e-7 * ml_j.max()
    jidc, jicnt, jnseg = pf.permuted_bin_tables(ml_j, perm, edges)
    # the same input gives the same tables, and so does each side's own
    # |l| plane (no mode lies within an ulp of an edge)
    for ml in (ml_j, ml_t):
        idc, icnt, nseg = D.permuted_bin_tables(ml, perm, edges)
        assert nseg == jnseg and idc.dtype == torch.int32
        np.testing.assert_array_equal(idc.numpy(), np.asarray(jidc))
        np.testing.assert_array_equal(icnt.numpy(), np.asarray(jicnt))
    # digitize(right=True): a mode on an edge bins as Bin2D does; the
    # overflow folds into segment 0 (tests/test_qe_pallas.py's case)
    idc, _, _ = D.permuted_bin_tables(np.array([[40.0, 80.0], [120.0, 200.0]]),
                                      np.arange(2), [40.0, 120.0])
    assert idc.tolist() == [0, 1, 1, 0]


@pytest.mark.parametrize("name", sorted(_FUNCS))
def test_dft_matches_jax(case, name):
    n, (xr, xi, sc), ref = case
    args = (torch.as_tensor(xr), torch.as_tensor(xi))
    if _FUNCS[name][1]:
        args += (torch.as_tensor(sc),)
    got = getattr(D, name)(*args)
    scale = max(np.abs(r).max() for r in ref[name])
    for g, r in zip(got, ref[name]):
        assert g.shape == r.shape and g.dtype == torch.float32
        assert np.abs(g.numpy() - r).max() <= TOL * scale, name


def test_half_rows_match_jax():
    for n in (256, 384, 2048):
        p_of_h, pnyq = D.half_rows(n)
        want, wnyq = pf.half_rows(n)
        assert p_of_h.dtype == want.dtype and pnyq == wnyq == 64
        np.testing.assert_array_equal(p_of_h, want)


@pytest.mark.parametrize("name,mod", [("rowfft_blk0", D),
                                      ("rowqc_pp", RP), ("fft2pp_qc", RP)])
def test_row_power_matches_jax(case, name, mod):
    """B4b and the fused half-plane fields (B6 with its strip patches;
    plain versions here) against the JAX functions."""
    n, (xr, xi, _), ref = case
    got = getattr(mod, name)(torch.as_tensor(xr), torch.as_tensor(xi))
    assert len(got) == len(ref[name])
    for g, r in zip(got, ref[name]):
        assert g.shape == r.shape and g.dtype == torch.float32
        assert np.abs(g.numpy() - r).max() <= TOL_QC * np.abs(r).max(), name
    if name == "rowqc_pp":
        plain = RP.rowqc_pp_ref(torch.as_tensor(xr), torch.as_tensor(xi))
        for g, r in zip(plain, ref[name]):
            assert np.abs(g.numpy() - r).max() <= TOL_QC * np.abs(r).max()
        # the kernel's own plain version covers the whole half plane
        qs, c = RP.rowqc_half(torch.as_tensor(xr), torch.as_tensor(xi))
        np.testing.assert_array_equal(qs.numpy(), plain[0].numpy())
        np.testing.assert_array_equal(c.numpy(), plain[1].numpy())


def test_rowifft_noise_y_law():
    """As tests/test_core.py holds the JAX interpret fallback: Y' of unit
    white noise has variance 1/n per part, the maps 1/n^2; the plain
    version is rowifft_ref of noise_planes_ref."""
    n = 256
    sc = torch.ones((n, n))
    yr, yi = D.rowifft_noise_y(sc, 11, 2)
    assert yr.shape == yi.shape == (2, n, n) and yr.dtype == torch.float32
    assert torch.isfinite(yr).all() and torch.isfinite(yi).all()
    for y in (yr, yi):
        np.testing.assert_allclose(y.double().var().item() * n, 1.0,
                                   rtol=0.02)
    pr, pi = D.rowifft_ref(*noise_planes(sc, 11, 2))
    assert torch.equal(yr, pr) and torch.equal(yi, pi)
    m1, m2 = D.ifft2pp_noise(sc, 11, 2)
    np.testing.assert_allclose(m1.double().var().item() * n * n, 1.0,
                               rtol=0.05)
    b1, b2, y1, y2 = D.ifft2pp_noise_y(sc, 11, 2)
    assert torch.equal(b1, m1) and torch.equal(b2, m2)
    assert torch.equal(y1, yr) and torch.equal(y2, yi)
    # the analysis column pass inverts the synthesis one
    cr, ci = D.colfft(m1, m2)
    assert (cr - yr).abs().max().item() <= 1e-5 * yr.abs().max().item()
    with pytest.raises(ValueError, match="2D float32"):
        D.rowifft_noise_y(sc[None], 11, 2)


def test_mirror_matches_jax(case):
    n, (xr, xi, _), ref = case
    got = M.mirror_pp(torch.as_tensor(xr), torch.as_tensor(xi))
    for g, r in zip(got, ref["mirror_pp"]):
        np.testing.assert_array_equal(g.numpy(), r)
    # and it is Z(-k): natural order, flip and roll by one
    _, inv = D.row_perm(n)
    z = xr[0] + 1j * xi[0]
    nat = lambda a: a[inv][:, inv]
    want = np.roll(nat(z)[::-1, ::-1], (1, 1), (0, 1))
    np.testing.assert_array_equal(nat(got[0][0].numpy())
                                  + 1j * nat(got[1][0].numpy()), want)


def test_natural_rows_and_roundtrip(case):
    n, (xr, xi, _), ref = case
    yr, yi = ref["colfft"]
    nat = D.natural_rows(torch.as_tensor(yr)).numpy()
    np.testing.assert_array_equal(nat, np.asarray(pf.natural_rows(
        jnp.asarray(yr))))
    want = np.fft.fft(xr.astype(np.float64) + 1j * xi, axis=-2).real
    assert np.abs(nat - want).max() <= 1e-5 * np.abs(want).max()
    br, bi = D.ifft2pp(*D.fft2pp(torch.as_tensor(xr), torch.as_tensor(xi)))
    np.testing.assert_allclose(br.numpy(), xr, atol=3e-5)
    np.testing.assert_allclose(bi.numpy(), xi, atol=3e-5)


def test_pfft2_nonsquare_matches_jax():
    """Each axis un-permutes with its own length's permutation."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((256, 384)).astype(np.float32)
    ref = np.asarray(pf.pfft2(jnp.asarray(x), interpret=True))
    got = D.pfft2(torch.as_tensor(x)).numpy()
    assert got.shape == ref.shape == (256, 384)
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= TOL * scale
    assert np.abs(got - np.fft.fft2(x)).max() <= TOL * scale
    back_j = np.asarray(pf.pifft2(jnp.asarray(ref), interpret=True))
    back = D.pifft2(torch.as_tensor(got)).numpy()
    assert np.abs(back - back_j).max() <= TOL * np.abs(x).max()
    np.testing.assert_allclose(back.real, x, atol=3e-5)
    # batched complex input
    z = (x + 1j * x[::-1]).astype(np.complex64)[None].repeat(2, 0)
    np.testing.assert_allclose(D.pfft2(torch.as_tensor(z)).numpy(),
                               np.fft.fft2(z), atol=TOL * np.abs(
                                   np.fft.fft2(z)).max())


def test_dft_rejects_what_the_kernels_do_not_take():
    x = torch.zeros((1, 192, 256))
    with pytest.raises(ValueError, match="128"):
        D.colfft(x, x)                      # 192 is not 128*B
    D.rowfft(x, x)                          # rows of 256: fine
    with pytest.raises(ValueError, match="128"):
        D.colfft(torch.zeros((1, 128, 128)), torch.zeros((1, 128, 128)))
    with pytest.raises(ValueError, match="float32"):
        D.rowfft(x.double(), x.double())
    with pytest.raises(ValueError, match="shape"):
        D.rowfft(x[0], x[0])
    with pytest.raises(ValueError, match="scale"):
        D.rowifft_scaled_y(x, x, torch.zeros((256, 192)))
    with pytest.raises(ValueError, match="n, n"):
        M.mirror_pp(x, x)


def test_noise_planes_law():
    """As tests/test_qe_pallas.py holds the JAX fallback: the law of
    ``z / scale`` (plain version: torch.randn; the kernel's Philox stream
    is held to the same law on the card)."""
    n = 256
    scale = torch.as_tensor(np.linspace(0.5, 2.0, n * n).reshape(n, n)
                            .astype(np.float32))
    zr, zi = noise_planes(scale, 7, 2)
    assert zr.shape == zi.shape == (2, n, n)
    assert zr.dtype == torch.float32
    r = (zr / scale).double()
    i = (zi / scale).double()
    assert abs(r.std().item() - 1.0) < 0.02
    assert abs(i.std().item() - 1.0) < 0.02
    N = r.numel()
    assert abs(r.mean().item()) < 5 / N ** 0.5
    assert abs((r * i).mean().item()) < 5 / N ** 0.5


def test_noise_planes_seeds():
    """Word pairs and scalar seeds, as pallas_fft.noise_planes takes them:
    the same words reproduce, distinct words differ, anything else
    raises."""
    scale = torch.ones((8, 8))
    r1, i1 = noise_planes(scale, torch.tensor([5, 9], dtype=torch.int32), 1)
    r1b, _ = noise_planes(scale, [5, 9], 1)
    r2, _ = noise_planes(scale, np.array([5, 10], np.int32), 1)
    r3, _ = noise_planes(scale, 5, 1)
    r3b, _ = noise_planes(scale, torch.tensor(5), 1)
    assert torch.isfinite(r1).all() and torch.isfinite(i1).all()
    assert torch.equal(r1, r1b) and torch.equal(r3, r3b)
    assert not torch.equal(r1, r2) and not torch.equal(r1, r3)
    # scalar seeds fill the first word: the CPU generator, which keeps
    # only 32 bits of its seed, still gives each its own stream
    r4, _ = noise_planes(scale, 6, 1)
    r5, _ = noise_planes(scale, [5, 1], 1)
    assert not torch.equal(r3, r4) and not torch.equal(r3, r5)
    assert not torch.equal(r1, i1)
    assert seed_words(5).tolist() == [5, 0]
    assert seed_words([-1, 3]).tolist() == [-1, 3]
    with pytest.raises(ValueError, match="scalar or"):
        noise_planes(scale, torch.zeros(3, dtype=torch.int32), 1)
    with pytest.raises(ValueError, match="scalar or"):
        noise_planes(scale, np.zeros((2, 2), np.int32), 1)
