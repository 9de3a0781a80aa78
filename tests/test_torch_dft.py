"""Parity of the port's doubly-permuted DFT, mirror, noise-plane and
row-power modules (``orphics_tpu_torch.ops.dft``, ``.mirror``,
``.noise_planes``, ``.rowpower``; kernels B3, B3s, B4, B4b, B5, B5n, B6,
B6s, B6h, B6h' and B7)
with ``orphics_tpu.ops.pallas_fft``.

The JAX side runs its Pallas kernels with ``interpret=True``, as the JAX
package's own tests do; the port runs its plain versions (CPU tensors).
Inputs come from a numpy seed. Bounds: the layout tables and the mirror
are array-equal; the transforms agree to 2e-5 of max|ref|, inside the
JAX tests' own 1e-5 to 3e-5 against numpy (tests/test_core.py), since
both sides are fp32 transforms by different factorizations. The lane
chunk 0 and the fused half-plane fields agree to 1e-5 of max|ref| (~4e-7
seen). ``qc_pp_half`` / ``s_pp_half`` on a stored plane agree with the JAX
functions to 2e-5 absolute on unit-variance planes (tests/test_core.py's
``atol``); ``fft2p`` / ``ifft2p`` to 1e-5 of max|ref|. The
register-resident B6 / B6s kernel cannot run here: its algorithm, written
out in plain PyTorch (``rowfft_split_emul``, ``half_fields_emul``), is held
to the plain versions within 1.5e-5 of max for the transform and 3e-5 for
the fields, and to the JAX functions within 2e-5. So is the register-resident
B3 / B3s column kernel's (``colfft_split_emul``, ``colifft_split_emul``):
within 1.5e-5 of the plain versions at n = 256 .. 4096, and of the JAX
functions within 2e-5 (1.5e-5 at n = 2048); and the B4 / B5 row kernels'
inverse (``rowifft_split_emul``, the scaled form multiplying first): of the
plain versions and the JAX ``rowifft`` / ``rowifft_scaled_y`` within 2e-5
(1.5e-5 at n = 2048). B4b's order (``rowfft_blk0_split_emul``) equals the
row kernel's columns [0, 128) bit for bit. A numpy model of B5n's index
map (``_noise_index_map``: which thread of ``csrc/noise.cu`` writes which
element from which Philox pair and word) writes every element once, from
pair e // 2.
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
    "colfft_scaled": (pf.colfft_scaled, True),
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
    for name in ("rowfft_blk0", "rowqc_pp", "fft2pp_qc", "rows_pp",
                 "fft2pp_s", "qc_pp_half"):
        ref[name] = tuple(np.array(a) for a in
                          getattr(pf, name)(*jx, interpret=True))
    ref["s_pp_half"] = (np.array(pf.s_pp_half(*jx, interpret=True)),)
    # pf.fft2p / ifft2p take no ``interpret``: their bodies, with the
    # column kernel in interpret mode and XLA's row FFT as they have it
    k = jnp.fft.fft(jnp.asarray(ref["colfft"][0])
                    + 1j * jnp.asarray(ref["colfft"][1]), axis=-1)
    ref["fft2p"] = (np.array(k.real), np.array(k.imag))
    z = jnp.fft.ifft(jx[0] + 1j * jx[1], axis=-1)
    ref["ifft2p"] = tuple(np.array(a) for a in pf.colifft(
        z.real.astype(jnp.float32), z.imag.astype(jnp.float32),
        interpret=True))
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
    ml_t = tg.modlmap(torch.float32, "cpu").double().numpy()
    ml_j = np.asarray(jg.modlmap(jnp.float32), np.float64)
    # the fp32 |l| planes differ by an ulp here and there (XLA's sqrt)
    assert np.abs(ml_t - ml_j).max() <= 2e-7 * ml_j.max()
    jidc, jicnt, jnseg = pf.permuted_bin_tables(ml_j, perm, edges)
    # the same input gives the same tables, and so does each side's own
    # |l| plane (no mode lies within an ulp of an edge)
    for ml in (ml_j, ml_t):
        idc, icnt, nseg = D.permuted_bin_tables(ml, perm, edges,
                                                device="cpu")
        assert nseg == jnseg and idc.dtype == torch.int32
        np.testing.assert_array_equal(idc.numpy(), np.asarray(jidc))
        np.testing.assert_array_equal(icnt.numpy(), np.asarray(jicnt))
    # digitize(right=True): a mode on an edge bins as Bin2D does; the
    # overflow folds into segment 0 (tests/test_qe_pallas.py's case)
    idc, _, _ = D.permuted_bin_tables(np.array([[40.0, 80.0], [120.0, 200.0]]),
                                      np.arange(2), [40.0, 120.0], "cpu")
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
                                      ("rowqc_pp", RP), ("fft2pp_qc", RP),
                                      ("rows_pp", RP), ("fft2pp_s", RP)])
def test_row_power_matches_jax(case, name, mod):
    """B4b and the fused half-plane fields (B6 and B6s; plain versions
    here, which patch no strip) against the JAX functions."""
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
    if name == "rows_pp":
        plain = RP.rows_pp_ref(torch.as_tensor(xr), torch.as_tensor(xi))
        for g, r in zip(plain, ref[name]):
            assert np.abs(g.numpy() - r).max() <= TOL_QC * np.abs(r).max()
        s = RP.rows_half(torch.as_tensor(xr), torch.as_tensor(xi))
        np.testing.assert_array_equal(s.numpy(), plain[0].numpy())


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


# qc_pp_half / s_pp_half: the same fp32 products on both sides, on
# unit-variance planes: tests/test_core.py's atol
ATOL_HALF = 2e-5
# fft2p / ifft2p: an fp32 column DFT by the 128*B split and a library row
# FFT on each side
TOL_FFT2P = 1e-5


@pytest.mark.parametrize("name", ["qc_pp_half", "s_pp_half"])
def test_half_plane_fields_match_jax(case, name):
    """B6h / B6h' (plain versions here) on a stored plane against the JAX
    functions, strip patches and all; and against the direct mirror
    formula on every row of the half plane."""
    n, (xr, xi, _), ref = case
    zr, zi = torch.as_tensor(xr), torch.as_tensor(xi)
    got = getattr(RP, name)(zr, zi)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(ref[name])
    for g, r in zip(got, ref[name]):
        assert g.shape == r.shape == (2, n // 2, n)
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), r, atol=ATOL_HALF)
    plain = getattr(RP, name + "_ref")(zr, zi)
    plain = plain if isinstance(plain, tuple) else (plain,)
    for g, r in zip(got, plain):
        assert torch.equal(g, r)
    mrow = M._mirror_tables(n)
    p_of_h, _ = D.half_rows(n)
    mr, mi = xr[:, mrow][:, :, mrow], xi[:, mrow][:, :, mrow]
    fields = ((0.5 * (xr ** 2 + xi ** 2 + mr ** 2 + mi ** 2),
               xr * mr - xi * mi) if name == "qc_pp_half"
              else (xr * mi + xi * mr,))
    for g, f in zip(got, fields):
        np.testing.assert_allclose(g.numpy(), f[:, p_of_h], atol=ATOL_HALF)


def test_half_plane_fields_recover_full_plane_sums(case):
    """2 * half - row(ky = 0) + row(ky = n/2) is the full plane's sum for
    each mirror-even field, and qs sums to the plane's power."""
    n, (xr, xi, _), _ = case
    zr, zi = torch.as_tensor(xr), torch.as_tensor(xi)
    qs, c = RP.qc_pp_half(zr, zi)
    s = RP.s_pp_half(zr, zi)
    mr, mi = M.mirror_pp_ref(zr, zi)
    full = {"qs": RP.qc_fields(zr, zi, mr, mi)[0],
            "c": RP.qc_fields(zr, zi, mr, mi)[1],
            "s": RP.s_field(zr, zi, mr, mi)[0]}
    _, pnyq = D.half_rows(n)
    for name, half in (("qs", qs), ("c", c), ("s", s)):
        f = full[name].double()
        recon = (2 * half.double().sum((1, 2)) - f[:, 0].sum(1)
                 + f[:, pnyq].sum(1))
        want = f.sum((1, 2))
        scale = f.abs().sum((1, 2))
        assert ((recon - want).abs() <= 1e-6 * scale).all(), name
    power = (zr.double() ** 2 + zi.double() ** 2).sum((1, 2))
    np.testing.assert_allclose(full["qs"].double().sum((1, 2)).numpy(),
                               power.numpy(), rtol=1e-6)


def test_half_plane_fields_equal_fused_row_pass(case):
    """tests/test_core.py's composition: the fields of ``rowfft(Y)`` are
    the fused ``rowqc_pp`` / ``rows_pp`` of ``Y``."""
    n, (xr, xi, _), _ = case
    yr, yi = torch.as_tensor(xr), torch.as_tensor(xi)
    zr, zi = D.rowfft(yr, yi)
    qs, c = RP.qc_pp_half(zr, zi)
    fq, fc = RP.rowqc_half(yr, yi)
    assert torch.equal(qs, fq) and torch.equal(c, fc)
    assert torch.equal(RP.s_pp_half(zr, zi), RP.rows_half(yr, yi))


def test_half_plane_fields_reject_bad_planes():
    x = torch.zeros((1, 256, 384))
    with pytest.raises(ValueError, match="n, n"):
        RP.qc_pp_half(x, x)
    with pytest.raises(ValueError, match="float32"):
        RP.s_pp_half(torch.zeros((1, 256, 256), dtype=torch.float64),
                     torch.zeros((1, 256, 256), dtype=torch.float64))
    with pytest.raises(ValueError, match="128"):
        RP.qc_pp_half(torch.zeros((1, 192, 192)), torch.zeros((1, 192, 192)))


@pytest.mark.parametrize("name", ["fft2p", "ifft2p"])
def test_fft2p_matches_jax(case, name):
    n, (xr, xi, _), ref = case
    got = getattr(D, name)(torch.as_tensor(xr), torch.as_tensor(xi))
    scale = max(np.abs(r).max() for r in ref[name])
    for g, r in zip(got, ref[name]):
        assert g.shape == r.shape and g.dtype == torch.float32
        assert g.is_contiguous()
        assert np.abs(g.numpy() - r).max() <= TOL_FFT2P * scale


def test_fft2p_is_fft2_with_permuted_rows(case):
    n, (xr, xi, _), _ = case
    kr, ki = D.fft2p(torch.as_tensor(xr), torch.as_tensor(xi))
    want = np.fft.fft2(xr.astype(np.float64) + 1j * xi)
    perm, _ = D.row_perm(n)
    scale = np.abs(want).max()
    assert np.abs(kr.numpy() - want.real[:, perm]).max() <= TOL_FFT2P * scale
    assert np.abs(ki.numpy() - want.imag[:, perm]).max() <= TOL_FFT2P * scale
    nat = D.natural_rows(torch.complex(kr, ki)).numpy()
    assert np.abs(nat - want).max() <= TOL_FFT2P * scale
    br, bi = D.ifft2p(kr, ki)
    np.testing.assert_allclose(br.numpy(), xr, atol=3e-5)
    np.testing.assert_allclose(bi.numpy(), xi, atol=3e-5)


# ---- the register-resident B6 / B6s kernel's algorithm --------------------

# the transform contract, and the fields' (two transforms multiplied)
TOL_SPLIT = 1.5e-5
TOL_FIELDS = 3e-5
TOL_JAX = 2e-5


def _planes(seed, shape):
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.standard_normal(shape)
                                 .astype(np.float32)) for _ in range(2))


@pytest.mark.parametrize("m", [2, 4, 8, 16, 32])
def test_register_fft_matches_numpy(m):
    """``fft_regs``: the radix-2 butterflies with the nine constants, every
    size the kernels instantiate (stage 1 at Bk = 2 .. 32, the 16- and the
    8-point factor of the 128-point stage), in natural output order; and
    ``fft_regs<M, true>`` (conjugate constants, no 1/M) against
    ``numpy.fft.ifft``."""
    xr, xi = _planes(m, (m, 3, 37))
    x64 = xr.numpy().astype(np.float64) + 1j * xi.numpy()
    for inverse, want in ((False, np.fft.fft(x64, axis=0)),
                          (True, m * np.fft.ifft(x64, axis=0))):
        got = D._fft_regs_emul(torch.complex(xr, xi), inverse).numpy()
        assert got.dtype == np.complex64
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    with pytest.raises(ValueError, match="2, 4, 8, 16 or 32"):
        D._fft_regs_emul(torch.zeros((3, 4), dtype=torch.complex64))


def test_register_fft_roots_are_the_float64_roots():
    w = np.exp(-2j * np.pi * np.arange(16) / 32)
    got = D._roots32().numpy()
    assert np.abs(got - w).max() <= 2.0 ** -24
    assert got[0] == 1 and got[8] == -1j            # the exact quarter turns


@pytest.mark.parametrize("n,rows", [
    pytest.param(n, rows, id=str(n) if rows == 3 else f"{n}-{rows}rows")
    for rows in (3, 7, 130) for n in (256, 512, 1024, 2048, 4096)])
def test_rowfft_split_emul_matches_ref(n, rows):
    """Stage 1 in radix 2, the twiddle, the 16 x 8 split of the 128-point
    stage with its digit orders: the kernel's row transform; row counts
    that fill no block of the kernel (7, 130) included."""
    xr, xi = _planes(n, (2, rows, n) if rows == 3 else (1, rows, n))
    got = D.rowfft_split_emul(xr, xi)
    ref = D.rowfft_ref(xr, xi)
    scale = max(r.abs().max().item() for r in ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == torch.float32
        assert (g - r).abs().max().item() <= TOL_SPLIT * scale


def test_rowfft_split_emul_matches_jax(case):
    n, (xr, xi, _), ref = case
    args = (torch.as_tensor(xr), torch.as_tensor(xi))
    if n == 384:                      # Bk = 3: the radix-2 core's shape
        with pytest.raises(ValueError, match="2, 4, 8, 16 or 32"):
            D.rowfft_split_emul(*args)
        return
    scale = max(np.abs(r).max() for r in ref["rowfft"])
    for g, r in zip(D.rowfft_split_emul(*args), ref["rowfft"]):
        assert np.abs(g.numpy() - r).max() <= TOL_JAX * scale


# ---- the register-resident B4 / B5 row kernels' inverse ----------------------

_ROW_NS = (256, 512, 1024, 2048)
_ROWS = 8


def _row_tol(n):
    return TOL_SPLIT if n == 2048 else TOL_JAX


@pytest.fixture(scope="module")
def row_case():
    """(1, 8, n) inputs, an (8, n) scale and the JAX ``rowifft`` /
    ``rowifft_scaled_y`` (interpret mode, one tile of 8 rows) at every n of
    ``_ROW_NS``, once."""
    out = {}
    for n in _ROW_NS:
        xr, xi = (a.numpy() for a in _planes(5 * n, (1, _ROWS, n)))
        sc = np.random.default_rng(n).uniform(0.5, 2.0, (_ROWS, n)).astype(
            np.float32)
        jx = (jnp.asarray(xr), jnp.asarray(xi))
        out[n] = ((xr, xi, sc), {
            "rowifft": tuple(np.array(a) for a in pf.rowifft(
                *jx, rtile=_ROWS, interpret=True)),
            "rowifft_scaled_y": tuple(np.array(a) for a in pf.rowifft_scaled_y(
                *jx, jnp.asarray(sc), rtile=_ROWS, interpret=True))})
    return out


def _row_inv_emul(name, xr, xi, sc):
    """The row kernel's inverse on the input its load forms: the scaled
    form multiplies before the split, as the kernel's load does."""
    if name == "rowifft_scaled_y":
        xr, xi = xr * sc, xi * sc
    return D.rowifft_split_emul(xr, xi)


@pytest.mark.parametrize("name", ["rowifft", "rowifft_scaled_y"])
@pytest.mark.parametrize("n", _ROW_NS)
@pytest.mark.parametrize("rows", [3, 7, 130])
def test_rowifft_split_emul_matches_ref(name, n, rows):
    """``fft128_seg<true>``, the conjugate twiddle, ``fft_regs<Bk, true>``
    and 1/n along the rows against the plain versions, at row counts that
    fill the kernel's blocks or not."""
    xr, xi = _planes(n + rows, (2, rows, n) if rows == 3 else (1, rows, n))
    sc = torch.as_tensor(np.random.default_rng(rows).uniform(
        0.5, 2.0, (rows, n)).astype(np.float32))
    got = _row_inv_emul(name, xr, xi, sc)
    ref = (D.rowifft_ref(xr, xi) if name == "rowifft"
           else D.rowifft_scaled_y_ref(xr, xi, sc))
    scale = max(r.abs().max().item() for r in ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == torch.float32
        assert g.is_contiguous()
        assert (g - r).abs().max().item() <= _row_tol(n) * scale


@pytest.mark.parametrize("name", ["rowifft", "rowifft_scaled_y"])
@pytest.mark.parametrize("n", _ROW_NS)
def test_rowifft_split_emul_matches_jax(row_case, name, n):
    (xr, xi, sc), ref = row_case[n]
    args = (torch.as_tensor(xr), torch.as_tensor(xi), torch.as_tensor(sc))
    scale = max(np.abs(r).max() for r in ref[name])
    for g, r in zip(_row_inv_emul(name, *args), ref[name]):
        assert g.shape == r.shape
        assert np.abs(g.numpy() - r).max() <= _row_tol(n) * scale
    # and the port's wrapper on the CPU is the plain version
    plain = (D.rowifft_ref(*args[:2]) if name == "rowifft"
             else D.rowifft_scaled_y_ref(*args))
    for g, r in zip(getattr(D, name)(*args[:2 if name == "rowifft" else 3]),
                    plain):
        assert torch.equal(g, r)


def test_rowifft_split_emul_roundtrip():
    """rowifft_split_emul inverts rowfft_split_emul; Bk = 3 has no
    register-resident form (the radix-2 kernel takes it)."""
    xr, xi = _planes(9, (2, 5, 1024))
    br, bi = D.rowifft_split_emul(*D.rowfft_split_emul(xr, xi))
    assert (br - xr).abs().max().item() <= 3e-6 * xr.abs().max().item()
    assert (bi - xi).abs().max().item() <= 3e-6 * xi.abs().max().item()
    with pytest.raises(ValueError, match="2, 4, 8, 16 or 32"):
        D.rowifft_split_emul(*_planes(6, (1, 2, 384)))


@pytest.mark.parametrize("n,rows", [(256, 7), (512, 130), (1024, 33),
                                    (2048, 5), (4096, 2)])
def test_rowfft_blk0_split_emul_is_rowfft_columns(n, rows):
    """B4b's register-resident order (the Bk blocks summed by fft_regs'
    tree, then fft128_seg) gives the row kernel's columns [0, 128) bit for
    bit, which the card checks hold B4b to; and it is B4b's plain version
    within the transform contract."""
    yr, yi = _planes(n + rows, (1, rows, n))
    got = D.rowfft_blk0_split_emul(yr, yi)
    full = D.rowfft_split_emul(yr, yi)
    for g, f in zip(got, full):
        assert g.shape == (1, rows, 128) and g.is_contiguous()
        assert torch.equal(g, f[..., :128])
    ref = D.rowfft_blk0_ref(yr, yi)
    scale = max(r.abs().max().item() for r in ref)
    for g, r in zip(got, ref):
        assert (g - r).abs().max().item() <= TOL_SPLIT * scale


# ---- the register-resident B3 / B3s column kernel's algorithm ---------------

_COL_NS = (256, 512, 1024, 2048)
_COLS = 8


@pytest.fixture(scope="module")
def col_case():
    """(1, n, 8) inputs and the JAX ``colfft`` / ``colifft`` (interpret
    mode, one tile of 8 columns) at every n of ``_COL_NS``, once."""
    out = {}
    for n in _COL_NS:
        xr, xi = (a.numpy() for a in _planes(3 * n, (1, n, _COLS)))
        jx = (jnp.asarray(xr), jnp.asarray(xi))
        out[n] = ((xr, xi), {
            name: tuple(np.array(a) for a in
                        getattr(pf, name)(*jx, ctile=_COLS, interpret=True))
            for name in ("colfft", "colifft")})
    return out


_COL_EMUL = {"colfft": (D.colfft_split_emul, D.colfft_ref),
             "colifft": (D.colifft_split_emul, D.colifft_ref)}


@pytest.mark.parametrize("name", sorted(_COL_EMUL))
@pytest.mark.parametrize("n,cols", [(256, 3), (512, 7), (1024, 5),
                                    (2048, 3), (4096, 2)])
def test_col_split_emul_matches_ref(name, n, cols):
    """The column kernel's decomposition, forward (the row kernel's split
    along axis -2) and inverse (``fft128_seg<true>``, the conjugate
    twiddle, ``fft_regs<Bk, true>``, 1/n), against the plain versions."""
    emul, ref_fn = _COL_EMUL[name]
    xr, xi = _planes(n + cols, (2, n, cols))
    got = emul(xr, xi)
    ref = ref_fn(xr, xi)
    scale = max(r.abs().max().item() for r in ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == torch.float32
        assert g.is_contiguous()
        assert (g - r).abs().max().item() <= TOL_SPLIT * scale


@pytest.mark.parametrize("name", sorted(_COL_EMUL))
@pytest.mark.parametrize("n", _COL_NS)
def test_col_split_emul_matches_jax(col_case, name, n):
    (xr, xi), ref = col_case[n]
    tol = TOL_SPLIT if n == 2048 else TOL_JAX
    args = (torch.as_tensor(xr), torch.as_tensor(xi))
    scale = max(np.abs(r).max() for r in ref[name])
    for g, r in zip(_COL_EMUL[name][0](*args), ref[name]):
        assert g.shape == r.shape
        assert np.abs(g.numpy() - r).max() <= tol * scale
    # and the port's wrapper on the CPU is the plain version
    for g, r in zip(getattr(D, name)(*args), _COL_EMUL[name][1](*args)):
        assert torch.equal(g, r)


def test_col_split_emul_roundtrip():
    """colifft_split_emul inverts colfft_split_emul; Bk = 3 has no
    register-resident form (the radix-2 kernel takes it)."""
    xr, xi = _planes(5, (2, 1024, 4))
    br, bi = D.colifft_split_emul(*D.colfft_split_emul(xr, xi))
    assert (br - xr).abs().max().item() <= 3e-6 * xr.abs().max().item()
    assert (bi - xi).abs().max().item() <= 3e-6 * xi.abs().max().item()
    for emul in (D.colfft_split_emul, D.colifft_split_emul):
        with pytest.raises(ValueError, match="2, 4, 8, 16 or 32"):
            emul(*_planes(6, (1, 384, 2)))


@pytest.mark.parametrize("n", [256, 384, 512, 2048, 4096])
def test_mirror_pos_is_the_mirror_table(n):
    np.testing.assert_array_equal(RP.mirror_pos(np.arange(n), n // 128),
                                  M._mirror_tables(n))


@pytest.mark.parametrize("field", ["qc", "s"])
@pytest.mark.parametrize("n,rows", [(256, None), (512, None), (2048, [0]),
                                    (2048, [63]), (2048, [777])])
def test_half_fields_emul_matches_ref(n, rows, field):
    """The kernel's pairing, Z[p, q] with the mirror row's value at
    mirror_pos(q), on the emulated transform: every half row at 256 and
    512, one row pair at 2048 (h = 0 pairs row 0 with itself)."""
    yr, yi = _planes(n + 5, (2 if n < 2048 else 1, n, n))
    if field == "qc":
        got = RP.half_fields_emul(yr, yi, RP.qc_fields, rows)
        ref = RP.rowqc_pp_ref(yr, yi)[:2]
    else:
        got = RP.half_fields_emul(yr, yi, RP.s_field, rows)
        ref = RP.rows_pp_ref(yr, yi)[:1]
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        scale = r.abs().max().item()
        r = r if rows is None else r[:, rows]
        assert g.shape == r.shape and g.dtype == torch.float32
        assert (g - r).abs().max().item() <= TOL_FIELDS * scale


@pytest.mark.parametrize("name", ["rowqc_pp", "rows_pp"])
def test_half_fields_emul_matches_jax(case, name):
    n, (xr, xi, _), ref = case
    field = RP.qc_fields if name == "rowqc_pp" else RP.s_field
    args = (torch.as_tensor(xr), torch.as_tensor(xi), field)
    if n == 384:                      # Bk = 3: the radix-2 core's shape
        with pytest.raises(ValueError, match="2, 4, 8, 16 or 32"):
            RP.half_fields_emul(*args)
        return
    got = RP.half_fields_emul(*args)
    for g, r in zip(got, ref[name]):
        assert g.shape == r.shape
        assert np.abs(g.numpy() - r).max() <= TOL_JAX * np.abs(r).max()


@pytest.mark.parametrize("name", ["rowqc_pp", "rows_pp"])
def test_fused_fields_on_cpu_are_the_plain_version(case, name):
    """No strip is patched: on the CPU ``rowqc_pp`` / ``rows_pp`` return
    their plain versions' tuples, bit for bit."""
    _, (xr, xi, _), _ = case
    args = (torch.as_tensor(xr), torch.as_tensor(xi))
    got = getattr(RP, name)(*args)
    plain = getattr(RP, name + "_ref")(*args)
    assert len(got) == len(plain) == (4 if name == "rowqc_pp" else 3)
    for g, r in zip(got, plain):
        assert torch.equal(g, r)


_NOISE_THREADS = 256  # csrc/noise.cu: THREADS


def _noise_index_map(batch: int, plane: int, vec=None):
    """A numpy model of the writes of ``csrc/noise.cu``'s launch for
    ``(batch, plane)`` outputs, as arrays ``(b, i, e, q, word)``, one entry
    per store of
    an element to ``ore`` and ``oim``: batch entry ``b`` and plane index
    ``i`` as the kernel forms them from its grid (x over chunks of 256
    threads of four plane elements, y over the batch), the flat index ``e``
    it writes, the Philox pair ``q`` it draws and the word it takes for the
    real part (0: x, 1: y; the imaginary part takes word + 2). ``vec``:
    the 16-byte kernel (default: where ``plane`` is a multiple of 4, as the
    launch picks it for aligned arrays), else the element-wise one."""
    vec = plane % 4 == 0 if vec is None else vec
    if vec and plane % 4:
        raise ValueError("the 16-byte kernel takes planes of a multiple of 4 "
                         "elements")
    quads = -(-plane // 4)
    grid_x = -(-quads // _NOISE_THREADS)
    t = np.arange(grid_x * _NOISE_THREADS)        # thread of the plane
    rows = []
    for b in range(batch):                        # blockIdx.y (gridDim.y)
        if vec:
            t_ = t[t < quads]
            e = 4 * (np.int64(b) * quads + t_)
            q0 = e >> 1
            for k, (dq, word) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
                rows.append((np.full(t_.size, b), 4 * t_ + k, e + k, q0 + dq,
                             np.full(t_.size, word)))
        else:
            i0 = 4 * t[4 * t < plane]
            for k in range(4):
                i = i0 + k
                i = i[i < plane]                  # the last chunk's cut
                e = np.int64(b) * plane + i
                rows.append((np.full(i.size, b), i, e, e >> 1, e & 1))
    return tuple(np.concatenate(c) for c in zip(*rows))


@pytest.mark.parametrize("batch,shape", [(3, (5, 7)), (3, (6, 6)),
                                         (2, (3, 4)), (1, (1, 1)),
                                         (4, (9, 130)), (32, (64, 64))])
def test_noise_index_map_writes_each_element_once(batch, shape):
    """B5n's kernels (``csrc/noise.cu``): each (batch, plane) element is
    written exactly once, at its flat index, from pair e // 2 with word x
    (re) or z (im) for even e and y or w for odd e, at odd totals (3 x 35)
    and at planes that are not a multiple of 4; at planes that are, both
    kernels write the same map."""
    plane = shape[0] * shape[1]
    vecs = (False, True) if plane % 4 == 0 else (False,)
    maps = []
    for vec in vecs:
        b, i, e, q, word = _noise_index_map(batch, plane, vec)
        assert np.array_equal(np.sort(e), np.arange(batch * plane))
        assert np.array_equal(e, b * plane + i)
        assert ((i >= 0) & (i < plane)).all()
        assert np.array_equal(q, e // 2) and np.array_equal(word, e % 2)
        order = np.argsort(e)
        maps.append(np.stack([q[order], word[order]]))
    assert all(np.array_equal(maps[0], m) for m in maps[1:])
    with pytest.raises(ValueError, match="multiple of 4"):
        _noise_index_map(1, 6, vec=True)

