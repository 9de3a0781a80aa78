"""Parity of the port's ILC module (``orphics_tpu_torch.models.ilc``) and its
kernel B9 (``ops.rowcombine.rowcombine_pp``) with ``orphics_tpu.models.ilc``
and ``orphics_tpu.ops.pallas_fft.rowcombine_pp``.

The JAX side runs its Pallas kernels with ``interpret=True``, each
reference computed once per module in a fixture; the port runs its plain
versions (CPU tensors). Inputs come from numpy seeds. Bounds:

* per-pixel ILC algebra in float64 (weights, silc/cilc and their noise):
  1e-10 relative to each output's max; ``ilc_cov`` is host numpy on both
  sides: array-equal; ``ilc_cinv`` inverts by eigendecomposition in
  float64 on each side: 1e-8 of each ell's max |Cinv|;
* ``rowcombine_pp`` at n = 384 (Bk = 3), nq 3, two coadds: 1e-5 of
  max|ref| (fp32 transforms by two factorizations, tests/test_core.py's
  own bound for the JAX kernel);
* the register-resident B9 kernel's algorithm (``rowcombine_split_emul``:
  row pairs through ``mirror_pos``, G coadds sharing one weight load, q in
  fixed order), which cannot run here: 1e-5 of max|ref| against
  ``rowcombine_pp_ref`` at n = 256 and 512, nq 1 and 3, ncoadds 1, G - 1
  and G + 1, and against the JAX ``rowcombine_pp`` at n = 256 (the same
  bound, for the same reason);
* the fused coadds at 256^2, four bands: 1e-5 of max|ref|, against the
  JAX fused functions and against ``ifft2(cilc(fft2(maps)))``, with each
  package's own weights and with the JAX weights carried across by
  ``convert.load_ilc_weights``.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from orphics_tpu import geometry as jgeo
from orphics_tpu.models import foregrounds as JFG
from orphics_tpu.models import ilc as JI
from orphics_tpu.ops import pallas_fft as pf
from orphics_tpu.ops.binning import Bin2D as JBin2D

import orphics_tpu_torch as tp
from orphics_tpu_torch.convert import load_ilc_weights
from orphics_tpu_torch.models import foregrounds as TFG
from orphics_tpu_torch.models import ilc as TI
from orphics_tpu_torch.ops import dft as D
from orphics_tpu_torch.ops.binning import Bin2D
from orphics_tpu_torch.ops.mirror import mirror_pp_ref
from orphics_tpu_torch.ops.rowcombine import (coadds_per_block, row_pairs,
                                              rowcombine_pp,
                                              rowcombine_pp_ref,
                                              rowcombine_split_emul)

torch.set_num_threads(1)

TOL_ALG = 1e-10
TOL_FUSED = 1e-5
NF, NCO, N = 4, 2, 256


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def _iso_cinv(n, nf, seed):
    """A mirror-symmetric (isotropic) float32 ``(nf, nf, n, n)`` inverse
    covariance, as tests/test_core.py:test_cilc_coadd_fused_library_api
    builds it."""
    rng = np.random.default_rng(seed)
    g = jgeo.rect_geometry(width_arcmin=n * 2.0, px_res_arcmin=2.0)
    ml = g.modlmap_np()
    ells = np.arange(2, 6000)
    cov1d = rng.standard_normal((nf, nf, len(ells)))
    cov1d = np.einsum("ik...,jk...->ij...", cov1d, cov1d) \
        + 5 * np.eye(nf)[:, :, None]
    cinv1d = np.moveaxis(np.linalg.inv(
        np.moveaxis(cov1d, (0, 1), (-2, -1))), (-2, -1), (0, 1))
    return np.stack([[np.interp(ml, ells, cinv1d[i, j], left=0, right=0)
                      for j in range(nf)]
                     for i in range(nf)]).astype(np.float32)


@pytest.fixture(scope="module")
def fused():
    """Maps, weights and every JAX fused coadd at 256^2, four bands."""
    rng = np.random.default_rng(1)
    cinv = _iso_cinv(N, NF, 7)
    a = np.ones(NF, np.float32)
    b = np.asarray([1.0, -2.0, 0.5, 3.0], np.float32)
    maps = rng.standard_normal((NCO, NF, N, N)).astype(np.float32)
    kb = rng.uniform(0.2, 1.0, (NF, N, N))
    kb = 0.5 * (kb + np.roll(kb[:, ::-1, ::-1], 1, (1, 2)))    # w(-k) = w(k)
    kn = rng.uniform(0.5, 2.0, (NF, 1, 1)) * np.ones((NF, N, N))
    jw = np.asarray(JI.cilc_weights(jnp.asarray(cinv), a, b))
    ref = dict(
        cilc=np.asarray(JI.cilc_coadd_fused(maps, cinv, a, b,
                                            interpret=True)),
        silc=np.asarray(JI.silc_coadd_fused(maps, cinv, interpret=True)),
        kspace=np.asarray(JI.kspace_coadd_fused(maps, kb, kn,
                                                interpret=True)),
        exact=np.stack([np.fft.ifft2(np.asarray(JI.cilc(
            jnp.asarray(np.fft.fft2(maps[j])), jnp.asarray(cinv),
            jnp.asarray(a), jnp.asarray(b)))).real for j in range(NCO)]))
    return dict(cinv=cinv, a=a, b=b, maps=maps, kb=kb, kn=kn, jw=jw, ref=ref)


@pytest.fixture(scope="module")
def combine():
    """Pair intermediates, weights and the JAX ``rowcombine_pp`` at 384."""
    rng = np.random.default_rng(21)
    n, nq, nco = 384, 3, 2
    yr, yi = (rng.standard_normal((nco * nq, n, n)).astype(np.float32)
              for _ in range(2))
    w = [rng.standard_normal((nq, n, n)).astype(np.float32)
         for _ in range(4)]
    ref = pf.rowcombine_pp(jnp.asarray(yr), jnp.asarray(yi),
                           *(jnp.asarray(x) for x in w), nq, interpret=True)
    return nq, yr, yi, w, tuple(np.asarray(r) for r in ref)


@pytest.fixture(scope="module")
def combine256():
    """Pair intermediates, weights and the JAX ``rowcombine_pp`` at 256
    (Bk = 2, G = 8), nq 3, three coadds."""
    rng = np.random.default_rng(22)
    n, nq, nco = 256, 3, 3
    yr, yi = (rng.standard_normal((nco * nq, n, n)).astype(np.float32)
              for _ in range(2))
    w = [rng.standard_normal((nq, n, n)).astype(np.float32)
         for _ in range(4)]
    ref = pf.rowcombine_pp(jnp.asarray(yr), jnp.asarray(yi),
                           *(jnp.asarray(x) for x in w), nq, interpret=True)
    return nq, yr, yi, w, tuple(np.asarray(r) for r in ref)


def _ilc_planes(seed, shape=(6, 5)):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((NF, NF) + shape)
    cinv = np.einsum("ik...,jk...->ij...", m, m) \
        + 2.0 * np.eye(NF)[:, :, None, None]
    kmaps = rng.standard_normal((NF,) + shape) \
        + 1j * rng.standard_normal((NF,) + shape)
    return cinv, kmaps


def test_ilc_algebra_matches_jax():
    cinv, kmaps = _ilc_planes(3)
    a = np.ones(NF)
    b = np.array([1.0, -2.0, 0.5, 3.0])
    tc, tk = torch.as_tensor(cinv), torch.as_tensor(kmaps)
    jc, jk = jnp.asarray(cinv), jnp.asarray(kmaps)
    pairs = [
        (TI.silc(tk, tc), JI.silc(jk, jc)),
        (TI.silc(tk, tc, b), JI.silc(jk, jc, b)),
        (TI.cilc(tk, tc, a, b), JI.cilc(jk, jc, a, b)),
        (TI.silc_noise(tc), JI.silc_noise(jc)),
        (TI.cilc_noise(tc, a, b), JI.cilc_noise(jc, a, b)),
        (TI.silc_weights(tc), JI.silc_weights(jc)),
        (TI.cilc_weights(tc, a, b), JI.cilc_weights(jc, a, b)),
        (TI.ilc_map_term(tk, tc, b), JI.ilc_map_term(jk, jc, b)),
        (TI.ilc_map_term(tk.real, tc, b), JI.ilc_map_term(jk.real, jc, b)),
        (TI.ilc_comb_a_b(a, b, tc), JI.ilc_comb_a_b(a, b, jc)),
        (TI.ilc_def_response(None, tc), JI.ilc_def_response(None, jc)),
    ]
    for k, (got, want) in enumerate(pairs):
        got = got.numpy()
        assert got.shape == np.asarray(want).shape, k
        assert _rel(got, want) <= TOL_ALG, k
    # the weights reproduce the combinations they linearize
    w = TI.cilc_weights(tc, a, b)
    np.testing.assert_allclose((w * tk).sum(0).numpy(),
                               TI.cilc(tk, tc, a, b).numpy(), rtol=1e-9,
                               atol=1e-12)
    # a singular pixel gives 0, as the JAX guard does
    z = tc.clone()
    z[..., 0, 0] = 0.0
    assert TI.silc_noise(z)[0, 0] == 0 and TI.cilc(tk, z, a, b)[0, 0] == 0
    assert TI.ilc_index(3) == JI.ilc_index(3) == "p"
    assert TI.ilc_index(4) == JI.ilc_index(4) == "pq"
    with pytest.raises(ValueError):
        TI.ilc_index(2)


def test_ilc_cov_and_cinv_with_foregrounds():
    """bench config 4's covariance (six bands, tSZ + CIB + kSZ), short ell
    range."""
    freqs = np.array([39.0, 93.0, 145.0, 225.0, 280.0, 350.0])
    beams = np.array([5.1, 2.2, 1.4, 1.0, 0.9, 0.8])
    noises = (np.array([36.0, 8.0, 10.0, 22.0, 54.0, 100.0])
              * tp.arcmin) ** 2
    ells = np.arange(2, 3000)
    cltt = 1e3 / (ells + 10.0) ** 2
    kbeams = [np.exp(-(b * tp.arcmin) ** 2 * ells ** 2 / (16 * np.log(2)))
              for b in beams]
    comps = ("tsz", "cibc", "ksz")
    kw = dict(components=comps)
    cov = TI.ilc_cov(ells, cltt, kbeams, freqs, noises,
                     fdict=TFG.fg_dict(10.0 + 0 * freqs, freqs), **kw)
    jcov = JI.ilc_cov(ells, cltt, kbeams, freqs, noises,
                      fdict=JFG.fg_dict(10.0 + 0 * freqs, freqs), **kw)
    np.testing.assert_array_equal(cov, jcov)
    cinv, cov2 = TI.ilc_cinv(ells, cltt, kbeams, freqs, noises,
                             fdict=TFG.fg_dict(10.0 + 0 * freqs, freqs),
                             device="cpu", **kw)
    jcinv, _ = JI.ilc_cinv(ells, cltt, kbeams, freqs, noises,
                           fdict=JFG.fg_dict(10.0 + 0 * freqs, freqs), **kw)
    np.testing.assert_array_equal(cov2, cov)
    assert cinv.dtype == torch.float64 and cinv.shape == (6, 6, len(ells))
    scale = np.abs(np.asarray(jcinv)).max(axis=(0, 1))
    assert np.max(np.abs(cinv.numpy() - np.asarray(jcinv)) / scale) <= 1e-8
    direct, _ = TI.ilc_cinv(ells, cltt, kbeams, freqs, noises,
                            fdict=TFG.fg_dict(10.0 + 0 * freqs, freqs),
                            eigpow=False, device="cpu", **kw)
    assert np.max(np.abs(direct.numpy() - cinv.numpy()) / scale) <= 1e-8
    # lmin/lmax cuts become infinite variance
    cut = TI.ilc_cov(ells, cltt, kbeams, freqs, noises, lmins=[100] * 6,
                     lmaxs=[2500] * 6)
    assert (cut[0, 0][ells < 100] == 1e30).all()


def test_coadd_helpers_match_jax():
    rng = np.random.default_rng(9)
    kmaps = (rng.standard_normal((3, 8, 8))
             + 1j * rng.standard_normal((3, 8, 8)))
    kb = rng.uniform(0.0, 1.0, (3, 8, 8))
    kn = rng.uniform(0.5, 2.0, (3, 8, 8))
    kn[0, 0, 0] = 0.0
    got = TI.kspace_coadd(torch.as_tensor(kmaps), kb, kn, 0.7).numpy()
    want = np.asarray(JI.kspace_coadd(kmaps, kb, kn, 0.7))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)
    # empirical covariance, raw and binned-and-repainted
    g = tp.rect_geometry(width_arcmin=32 * 2.0, px_res_arcmin=2.0)
    jg = jgeo.rect_geometry(width_arcmin=32 * 2.0, px_res_arcmin=2.0)
    km = (rng.standard_normal((2, 32, 32))
          + 1j * rng.standard_normal((2, 32, 32))).astype(np.complex64)
    # fp32 complex products (XLA may fuse them): 1e-6 of the max
    assert _rel(TI.ilc_empirical_cov(torch.as_tensor(km)).numpy(),
                JI.ilc_empirical_cov(jnp.asarray(km))) <= 1e-6
    edges = np.arange(100, 5000, 400.0)
    ml = g.modlmap_np()
    got = TI.ilc_empirical_cov(torch.as_tensor(km),
                               Bin2D(ml, edges, device="cpu"), ml).numpy()
    want = np.asarray(JI.ilc_empirical_cov(
        jnp.asarray(km), JBin2D(jg.modlmap_np(), edges), jnp.asarray(ml)))
    assert got.shape == want.shape == (2, 2, 32, 32)
    assert _rel(got, want) <= 1e-5
    # per-ell harmonic weights (host float64 on both sides)
    lmax = 300
    ell = np.arange(lmax + 1)
    beams = [np.exp(-ell * (ell + 1) * s) for s in (1e-6, 3e-6)]
    model = {(0, 0): 2.0 + 0 * ell, (0, 1): 1.0 + 0 * ell,
             (1, 1): 3.0 + 1e-3 * ell}
    np.testing.assert_allclose(
        TI.calculate_harmonic_coadd_weights(lmax, model, None, beams),
        JI.calculate_harmonic_coadd_weights(lmax, model, None, beams),
        rtol=1e-12)
    # the harmonic coadd of two alm sets on those weights (ops/alm):
    # float64 per-ell products, 1e-12 of max
    nalm = (lmax + 1) * (lmax + 2) // 2
    alms = rng.standard_normal((2, nalm)) + 1j * rng.standard_normal(
        (2, nalm))
    got, w = TI.harmonic_coaddition(list(torch.as_tensor(alms)), beams,
                                    model, beams[0])
    ref, wj = JI.harmonic_coaddition(list(alms), beams, model, beams[0])
    np.testing.assert_allclose(w, wj, rtol=1e-12)
    assert _rel(got.numpy(), ref) <= 1e-12
    got = TI.apply_harmonic_coadd_weights(list(torch.as_tensor(alms)), w,
                                          beams[1])
    ref = JI.apply_harmonic_coadd_weights(list(alms), wj, beams[1])
    assert _rel(got.numpy(), ref) <= 1e-12


def test_rowcombine_matches_jax(combine):
    nq, yr, yi, w, ref = combine
    args = (torch.as_tensor(yr), torch.as_tensor(yi),
            *(torch.as_tensor(x) for x in w))
    got = rowcombine_pp(*args, nq)
    scale = np.abs(ref[0]).max()
    for g, r in zip(got, ref):
        assert g.shape == r.shape == (2, 384, 384)
        assert np.abs(g.numpy() - r).max() <= TOL_FUSED * scale
    plain = rowcombine_pp_ref(*args, nq)
    for g, p in zip(got, plain):
        np.testing.assert_array_equal(g.numpy(), p.numpy())
    # C = sum_b w_b F_b: the Hermitian split of fft2pp by hand
    zr, zi = D.rowfft(*args[:2])
    mr, mi = mirror_pp_ref(zr, zi)
    wa = torch.as_tensor(w[0]) * 2.0
    wb = -torch.as_tensor(w[1]) * 2.0
    f1r, f1i = 0.5 * (zr + mr), 0.5 * (zi - mi)
    f2r, f2i = 0.5 * (zi + mi), 0.5 * (mr - zr)
    sh = (2, nq, 384, 384)
    cr = (f1r.reshape(sh) * wa + f2r.reshape(sh) * wb).sum(1)
    ci = (f1i.reshape(sh) * wa + f2i.reshape(sh) * wb).sum(1)
    wsplit = (0.5 * wa, -0.5 * wb, 0.5 * wa, 0.5 * wb)
    hc = rowcombine_pp(*args[:2], *(x.contiguous() for x in wsplit), nq)
    assert np.abs(hc[0].numpy() - cr.numpy()).max() <= 1e-5 * cr.abs().max()
    assert np.abs(hc[1].numpy() - ci.numpy()).max() <= 1e-5 * cr.abs().max()


@pytest.mark.parametrize("nco", ["1", "G-1", "G+1"])
@pytest.mark.parametrize("nq", [1, 3])
@pytest.mark.parametrize("n", [256, 512])
def test_rowcombine_split_emul_matches_ref(n, nq, nco):
    """The register-resident B9 kernel's order (blocks of row pairs, G
    coadds a block, coadd counts that fill no block) against the plain
    version."""
    g = coadds_per_block(n)
    nco = {"1": 1, "G-1": g - 1, "G+1": g + 1}[nco]
    rng = np.random.default_rng(n + 10 * nq + nco)
    y = [torch.as_tensor(rng.standard_normal((nco * nq, n, n))
                         .astype(np.float32)) for _ in range(2)]
    w = [torch.as_tensor(rng.standard_normal((nq, n, n)).astype(np.float32))
         for _ in range(4)]
    got = rowcombine_split_emul(*y, *w, nq)
    ref = rowcombine_pp_ref(*y, *w, nq)
    scale = max(r.abs().max().item() for r in ref)
    for gg, r in zip(got, ref):
        assert gg.shape == r.shape == (nco, n, n)
        assert (gg - r).abs().max().item() <= TOL_FUSED * scale


def test_rowcombine_split_emul_matches_jax(combine256):
    nq, yr, yi, w, ref = combine256
    got = rowcombine_split_emul(torch.as_tensor(yr), torch.as_tensor(yi),
                                *(torch.as_tensor(x) for x in w), nq)
    scale = np.abs(ref[0]).max()
    for g, r in zip(got, ref):
        assert g.shape == r.shape == (3, 256, 256)
        assert np.abs(g.numpy() - r).max() <= TOL_FUSED * scale


@pytest.mark.parametrize("n", [256, 512, 1024, 4096])
def test_rowcombine_row_pairs_cover_every_row_once(n):
    """The kernel's blocks: n / 2 row pairs covering every row once, each
    pair a row and its mirror row, block 0 the two rows that are their
    own mirror (0 and 64)."""
    from orphics_tpu_torch.ops.rowpower import mirror_pos
    p, pm, self_mirror = row_pairs(n)
    assert np.array_equal(np.sort(np.concatenate([p, pm])), np.arange(n))
    assert np.array_equal(self_mirror, np.arange(n // 2) == 0)
    assert (p[0], pm[0]) == (0, 64)
    assert mirror_pos(0, n // 128) == 0 and mirror_pos(64, n // 128) == 64
    assert np.array_equal(mirror_pos(p[1:], n // 128), pm[1:])


def test_rowcombine_rejects_what_the_kernel_does_not_take(combine):
    nq, yr, yi, w, _ = combine
    y = torch.as_tensor(yr)
    ws = [torch.as_tensor(x) for x in w]
    with pytest.raises(ValueError, match="multiple of"):
        rowcombine_pp(y[:5], y[:5], *ws, nq)
    with pytest.raises(ValueError, match="weight planes"):
        rowcombine_pp(y, y, *ws[:3], ws[3][:2], nq)
    with pytest.raises(ValueError, match="weight planes"):
        rowcombine_pp(y, y, *ws[:3], ws[3].double(), nq)


@pytest.mark.parametrize("kind", ["cilc", "silc", "kspace"])
def test_fused_coadds_match_jax(fused, kind):
    f = fused
    maps = torch.as_tensor(f["maps"])
    if kind == "cilc":
        got = TI.cilc_coadd_fused(maps, f["cinv"], f["a"], f["b"])
    elif kind == "silc":
        got = TI.silc_coadd_fused(maps, f["cinv"])
    else:
        got = TI.kspace_coadd_fused(maps, f["kb"], f["kn"])
    assert got.shape == (NCO, N, N) and got.dtype == torch.float32
    assert _rel(got.numpy(), f["ref"][kind]) <= TOL_FUSED
    if kind == "cilc":
        assert _rel(got.numpy(), f["ref"]["exact"]) <= TOL_FUSED


def test_fused_coadd_on_jax_weights_and_odd_batch(fused):
    f = fused
    w = load_ilc_weights(f["jw"], device="cpu")
    assert w.dtype == torch.float32 and w.is_contiguous()
    got = TI.linear_coadd_fused(torch.as_tensor(f["maps"]), w)
    assert _rel(got.numpy(), f["ref"]["cilc"]) <= TOL_FUSED
    # the port's own weights agree with the JAX ones
    tw = TI.cilc_weights(torch.as_tensor(f["cinv"]), f["a"], f["b"])
    assert _rel(tw.numpy(), f["jw"]) <= 1e-5
    # an odd number of coadds takes the unpacked inverse; numpy input
    one = TI.linear_coadd_fused(f["maps"][:1], w, device="cpu")
    assert _rel(one.numpy(), f["ref"]["cilc"][:1]) <= TOL_FUSED
    with pytest.raises(ValueError, match="even"):
        TI.linear_coadd_fused(f["maps"][:, :3], w[:3], device="cpu")
    with pytest.raises(ValueError, match="nfreq, n, n"):
        load_ilc_weights(f["jw"][0], device="cpu")
