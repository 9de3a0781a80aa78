"""models/mapstools of the port against the JAX module on the same numpy
inputs, group by group: (a) stacking and filters, (b) map utilities, (c)
pure B, (d) hole filling, (e) resampling, (f) profiles and convolutions,
(g) covariances, (h) draws (through their ``*_from_noise`` twins, fed the
JAX keys' own normals) and (i) healpix thumbnails.

Tolerances: deterministic float64 functions 1e-10 of max|ref| (the same
arithmetic in another order; FFTs by another library); float32 1e-5 of
max; binned outputs 1e-6 of max (the port's Bin2D sums float32 planes in
float64, the JAX one sums float64 planes); the CG fill 1e-6 of max at
eps = 1e-10 (both stop on |r| <= eps |b|, from the same x0, so they differ
by the CG tolerance and rounding, not bit for bit); the distance
transform is held to the JAX function run eagerly (its compiled form is
wrong on some CPU inputs, ROADMAP C), as tests/test_torch_distance.py does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orphics_tpu import geometry as jgeo
from orphics_tpu.models import grf as JG
from orphics_tpu.models import mapstools as JM
from orphics_tpu.models.theory import default_theory
from orphics_tpu.ops import alm as jalm
from orphics_tpu.ops import fourier as JF
from orphics_tpu.ops.windows import get_taper as jget_taper

import orphics_tpu_torch as tp
from orphics_tpu_torch.geometry import arcmin
from orphics_tpu_torch.models import grf as TG
from orphics_tpu_torch.models import mapstools as TM
from orphics_tpu_torch.ops import binning as TB
from orphics_tpu_torch.ops.windows import get_taper as tget_taper

torch.set_num_threads(1)

TOL64 = 1e-10
TOL32 = 1e-5
TOL_BIN = 1e-6
TOL_CG = 1e-6
CPU = "cpu"


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _rel(got, ref):
    got, ref = _np(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)),
                                                  1e-300))


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def g64():
    """A 64^2 2' patch at dec -20 deg, both packages."""
    kw = dict(width_arcmin=64 * 2.0, px_res_arcmin=2.0, y0_deg=-20.0)
    return jgeo.rect_geometry(**kw), tp.rect_geometry(**kw)


@pytest.fixture(scope="module")
def th():
    return default_theory()


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(14)


@pytest.fixture(scope="module")
def cl_tt(th):
    ells = np.arange(th.lpad + 1)
    return ells, np.asarray(th.lCl("TT", ells))


# ---------------------------------------------------------------- (a)

def test_flux_and_matched_filter(g64, rng, cl_tt):
    jg, tg = g64
    thumbs = rng.standard_normal((3,) + jg.shape)
    assert _rel(TM.flux(_t(thumbs), 6 * arcmin, tg),
                JM.flux(thumbs, 6 * arcmin, jg)) <= TOL64
    assert _rel(TM.flux(thumbs, 5 * arcmin, tg, annulus_width=3 * arcmin,
                        device=CPU),
                JM.flux(thumbs, 5 * arcmin, jg, annulus_width=3 * arcmin)) \
        <= TOL64
    ells, cl = cl_tt
    n2d = np.array(JF.interp1d_to_2d(ells, cl, jg, dtype=jnp.float64))
    n2d[0, 0] = 0.0                     # an infinite weight, zeroed
    temp = np.exp(-0.5 * jg.modrmap_np() ** 2 / (5 * arcmin) ** 2)
    kmask = np.asarray(JF.mask_kspace(jg, lmin=80, lmax=4000,
                                      dtype=jnp.float64))
    imap = thumbs[0] + 30 * temp
    want = JM.MatchedFilter(jg, temp, n2d).apply(imap, kmask=kmask)
    got = TM.MatchedFilter(tg, temp, n2d, device=CPU).apply(imap,
                                                            kmask=kmask)
    for a, b in zip(got, want):
        assert _rel(a, b) <= TOL64
    kmap = np.fft.fft2(imap)
    ktemp = np.fft.fft2(temp)
    want = JM.matched_filter(kmap, ktemp, n2d, jg)
    got = TM.matched_filter(_t(kmap), ktemp, n2d, tg)
    for a, b in zip(got, want):
        assert _rel(a, b) <= TOL64
    assert _rel(TM.get_normalized_center(tg, device=CPU),
                JM.get_normalized_center(jg)) == 0.0


def test_fourier_stack_and_transfer_function(g64, rng):
    jg, tg = g64
    edges = np.arange(200, 4000, 400.0)
    kmap = np.fft.fft2(rng.standard_normal(jg.shape))
    _, want = JM.FourierStack(jg, edges).apply(kmap)
    cents, got = TM.FourierStack(tg, edges, device=CPU).apply(_t(kmap))
    assert _rel(got, want) <= TOL_BIN
    np.testing.assert_allclose(cents, 0.5 * (edges[1:] + edges[:-1]))
    assert _rel(TM.fourier_stack(_t(kmap), edges, tg)[1],
                JM.fourier_stack(kmap, edges, jg)[1]) <= TOL_BIN
    kfilt = np.asarray(JF.mask_kspace(jg, lxcut=300, lmin=100))
    assert _rel(TM.analytical_tf(tg, kfilt, edges, device=CPU)[1],
                JM.analytical_tf(jg, kfilt, edges)[1]) <= TOL_BIN


# ---------------------------------------------------------------- (b)

def test_center_crop_and_ell_helpers(g64, rng):
    jg, tg = g64
    for shape in ((6, 7), (2, 5, 6)):
        x = rng.standard_normal(shape)
        got = _np(TM.mask_center(x, device=CPU))
        want = np.asarray(JM.mask_center(x))
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_array_equal(got[~np.isnan(got)],
                                      want[~np.isnan(want)])
    x = rng.standard_normal((3, 20, 17))
    np.testing.assert_array_equal(_np(TM.crop_center(_t(x), 8, 5)),
                                  JM.crop_center(x, 8, 5))
    np.testing.assert_array_equal(_np(TM.get_central(_t(x), 0.5)),
                                  JM.get_central(x, 0.5))
    assert TM.minimum_ell(tg) == JM.minimum_ell(jg)
    ls = np.linspace(0, 3000, 301)
    np.testing.assert_array_equal(TM.cosine_taper(ls, 1000, 500),
                                  JM.cosine_taper(ls, 1000, 500))
    assert TM.resolution(tg) == JM.resolution(jg)
    assert TM.rgeo(1.5, 2.0).shape == JM.rgeo(1.5, 2.0).shape
    ps = np.exp(-np.arange(5000) / 900.0)
    for dt, tol in ((torch.float64, TOL64), (torch.float32, TOL32)):
        assert _rel(TM.spec1d_to_2d(tg, ps, dtype=dt, device=CPU),
                    JM.spec1d_to_2d(jg, ps, dtype=jnp.float64)) <= tol
    rs = np.linspace(0, 20 * arcmin, 50)
    prof = np.exp(-rs / (3 * arcmin))
    assert _rel(TM.spec1d_like_profile_k(tg, rs, prof, torch.float64, CPU),
                JM.spec1d_like_profile_k(jg, rs, prof, jnp.float64)) <= TOL64


@pytest.mark.parametrize("exp,ncomp", [(None, 0), (0.5, 0), (0.5, 2)])
def test_downsample_power(g64, rng, exp, ncomp):
    jg, tg = g64
    if ncomp:
        a = rng.standard_normal((ncomp, ncomp) + jg.shape)
        p = np.einsum("ik...,jk...->ij...", a, a) + 0.1 * np.eye(ncomp)[
            :, :, None, None]
    else:
        p = rng.uniform(0.5, 1.5, jg.shape)
    for ndown in (8, 5):
        assert _rel(TM.downsample_power(p, tg, ndown, exp=exp, device=CPU),
                    JM.downsample_power(p, jg, ndown, exp=exp)) <= TOL64
    assert _rel(TM.downsample_power(_t(p), tg, 4, fftshift=False),
                JM.downsample_power(p, jg, 4, fftshift=False)) <= TOL64


def test_host_helpers(g64, rng):
    jg, tg = g64
    data = rng.standard_normal((6, 4, 5))
    tm, jm = TM.symmat_from_data(data), JM.symmat_from_data(data)
    assert tm.ncomp == jm.ncomp == 3
    np.testing.assert_array_equal(tm.to_array(), jm.to_array())
    np.testing.assert_array_equal(tm.to_array(flatten=True, sel=np.s_[3:9]),
                                  jm.to_array(flatten=True, sel=np.s_[3:9]))
    s = TM.SymMat(2, (3,))
    s[1, 0] = np.ones(3)
    assert np.all(s[0, 1] == 1.0) and s.yx_to_k(1, 1) == 2
    ells = np.arange(4000)
    beam = np.exp(-ells * (ells + 1) * (np.deg2rad(4 / 60) ** 2) / 16)
    np.testing.assert_allclose(TM.sanitize_beam(ells, beam),
                               JM.sanitize_beam(ells, beam), rtol=1e-12)
    for args in ((5.0, 3, 10.0), (2.0, 4, 7.0, -10.0, 30.0, 60.0)):
        for a, b in zip(TM.split_sky(*args), JM.split_sky(*args)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(TM.cutup((40, 30), 3, 4, pad=2),
                                  JM.cutup((40, 30), 3, 4, pad=2))
    np.testing.assert_array_equal(TM.bounds_from_list([-5, 10, 5, 20]),
                                  JM.bounds_from_list([-5, 10, 5, 20]))
    box = np.array([[-0.7, -0.5], [0.4, 0.6]]) * 30 * arcmin
    box[:, 0] += jg.y0
    for inc in (False, True):
        assert TM.slice_from_box(tg, box, inc) == JM.slice_from_box(jg, box,
                                                                    inc)
    img = np.exp(-((np.arange(30)[:, None] - 14) ** 2 / 30.0
                   + (np.arange(30)[None, :] - 15) ** 2 / 12.0))
    assert TM.get_ecc(img) == JM.get_ecc(img)
    gy, gx = np.linspace(0, 1, 12), np.linspace(0, 2, 15)
    grid = np.sin(gy[:, None] * 3) * np.cos(gx[None, :])
    oy, ox = np.linspace(0.1, 0.9, 7), np.linspace(0.2, 1.8, 5)
    np.testing.assert_array_equal(TM.interpolate_grid(grid, gy, gx, oy, ox),
                                  JM.interpolate_grid(grid, gy, gx, oy, ox))


def test_masks_areas_and_small_maps(g64, rng):
    jg, tg = g64
    mask = rng.uniform(0, 1, jg.shape)
    assert _rel(TM.binary_mask(mask, device=CPU),
                JM.binary_mask(mask)) == 0.0
    for name in ("area", "fsky", "area_sqdeg"):
        a = getattr(TM, name)(mask, tg, 0.3, device=CPU)
        b = getattr(JM, name)(mask, jg, 0.3)
        assert a == pytest.approx(b, rel=TOL64)
    a, fa = TM.area_from_mask(mask, tg, device=CPU)
    b, fb = JM.area_from_mask(mask, jg)
    assert a == pytest.approx(b, rel=TOL64) and fa == pytest.approx(fb)
    assert _rel(TM.psizemap(tg, device=CPU), JM.psizemap(jg)) <= TOL64
    x = rng.standard_normal((2,) + jg.shape)
    assert _rel(TM.block_smooth(x, 4, device=CPU),
                JM.block_smooth(x, 4)) <= TOL64
    with pytest.raises(ValueError):
        TM.block_smooth(x, 5, device=CPU)
    cls = rng.uniform(0, 1, (2, 300))
    assert _rel(TM.field_variance(cls, device=CPU),
                JM.field_variance(cls)) <= TOL64
    p2d = rng.uniform(1, 2, jg.shape)
    assert _rel(TM.ftrans(p2d, device=CPU), JM.ftrans(p2d)) <= TOL64
    covinv = np.linalg.inv(np.eye(36) + 0.1 * np.ones((36, 36)))
    stamp = rng.standard_normal((6, 6))
    assert _rel(TM.get_lnlike(covinv, stamp, device=CPU),
                JM.get_lnlike(covinv, stamp)) <= TOL64
    lmax = 40
    alm = (rng.standard_normal(jalm.nalm(lmax))
           + 1j * rng.standard_normal(jalm.nalm(lmax)))
    assert _rel(TM.filter_alms(_t(alm), 5, 30),
                JM.filter_alms(jnp.asarray(alm), 5, 30)) <= TOL64


# ---------------------------------------------------------------- (c)

@pytest.fixture(scope="module")
def pure_inputs(g64, rng):
    jg, tg = g64
    win = np.asarray(jget_taper(jg, taper_percent=18.0)[0], np.float64)
    iqu = rng.standard_normal((2, 3) + jg.shape) * win
    return win, iqu


def test_deriv_window(g64, pure_inputs):
    jg, tg = g64
    win, _ = pure_inputs
    want = JM.init_deriv_window(jnp.asarray(win), jg)
    got = TM.init_deriv_window(win, tg, device=CPU)
    assert set(got) == set(want)
    for k in want:
        assert _rel(got[k], want[k]) <= TOL64, k
    assert _rel(TM._deriv4(_t(win), -2, 0.5),
                JM._deriv4(jnp.asarray(win), -2, 0.5)) <= TOL64


@pytest.mark.parametrize("method,iau", [("standard", False),
                                        ("hybrid", False), ("pure", False),
                                        ("pure", True)])
def test_pure_lteb(g64, pure_inputs, method, iau):
    jg, tg = g64
    win, iqu = pure_inputs
    jwd = JM.init_deriv_window(jnp.asarray(win), jg)
    twd = TM.init_deriv_window(win, tg, device=CPU)
    want = [JM.iqu_to_pure_lteb(*(jnp.asarray(iqu[s, c]) for c in range(3)),
                                jg, jwd, method=method, iau=iau)
            for s in range(2)]
    got = TM.iqu_to_pure_lteb(*(_t(iqu[:, c]) for c in range(3)), tg, twd,
                              method=method, iau=iau)
    # Purify on the batch (2, 3, ny, nx): the same three transforms
    pur = TM.Purify(tg, win, device=CPU).lteb_from_iqu(_t(iqu), method,
                                                      iau)
    for f in range(3):
        ref = np.stack([np.asarray(w[f]) for w in want])
        assert _rel(got[f], ref) <= TOL64
        assert _rel(pur[f], ref) <= TOL64
    # float32 maps and window: the tables and window derivatives formed in
    # float64 and stored in float32
    got32 = TM.Purify(tg, win.astype(np.float32), device=CPU).lteb_from_iqu(
        _t(iqu.astype(np.float32)), method, iau)
    for f in range(3):
        ref = np.stack([np.asarray(w[f]) for w in want])
        assert _rel(got32[f], ref) <= TOL32


def test_pure_b_leakage_suppression(th):
    """E-only sims through an 18 % taper at 128^2, float64, drawn on the
    CPU by the port: the pure estimator suppresses the standard one's
    E->B leakage by > 100x per bin (tests/test_mapstools.py's thresholds)."""
    g = tp.rect_geometry(width_arcmin=128 * 2.0, px_res_arcmin=2.0)
    lmax = 5000
    ells = np.arange(lmax + 1)
    ps = np.zeros((3, 3, lmax + 1))
    ps[1, 1] = np.asarray(th.lCl("EE", ells))
    ps[0, 0] = np.asarray(th.lCl("TT", ells))
    mgen = TG.MapGen(g, ps, dtype=torch.float64, device=CPU)
    window = tget_taper(g, taper_percent=18.0, device=CPU)[0].to(
        torch.float64)
    pur = TM.Purify(g, window)
    binner = TB.Bin2D(g.modlmap_np(), np.arange(300, 2500, 200.0),
                      device=CPU)
    norm = g.area / g.npix ** 2
    iqu = mgen.get_map(torch.Generator().manual_seed(2), batch=(16,)) \
        * window
    _, _, b_std = pur.lteb_from_iqu(iqu, method="standard")
    _, _, b_pure = pur.lteb_from_iqu(iqu, method="pure")
    p = lambda f: binner.bin(((f.conj() * f).real * norm).to(
        torch.float32))[1].double().mean(0)
    r = (p(b_pure) / p(b_std)).numpy()
    assert np.all(r < 0.01), r
    assert r.mean() < 0.002, r


# ---------------------------------------------------------------- (d)

def test_inpaint_cg(g64, cl_tt, rng):
    jg, tg = g64
    ells, cl = cl_tt
    noise = 1e-4 * cl.max()
    p2d = np.asarray(JF.interp1d_to_2d(ells, cl, jg, dtype=jnp.float64)) \
        + noise
    mgen = JG.MapGen(jg, (cl + noise)[None, None], dtype=jnp.float64)
    imap = np.asarray(mgen.get_map(jax.random.PRNGKey(3)))
    rand = np.asarray(mgen.get_map(jax.random.PRNGKey(4)))
    mask = (jg.modrmap_np() > 10 * arcmin).astype(np.float64)
    want = np.asarray(JM.inpaint_cg(imap * mask, rand, mask, p2d, jg,
                                    eps=1e-10))
    got, iters = TM._inpaint_cg(imap * mask, rand, mask, p2d, 1e-10, 500,
                                CPU)
    assert 0 < iters < 500
    assert _rel(got, want) <= TOL_CG
    assert _rel(TM.inpaint_cg(_t(imap * mask), rand, mask, p2d, tg,
                              eps=1e-10), want) <= TOL_CG
    # the good pixels pass through untouched
    np.testing.assert_array_equal(_np(got)[mask > 0], (imap * mask)[mask > 0])


def test_gapfill_edge_conv_flat(g64, rng):
    jg, tg = g64
    imap = rng.standard_normal(jg.shape)
    mask = np.zeros(jg.shape, bool)
    mask[20:30, 34:41] = True
    mask[50, 10] = True
    ivar = rng.uniform(1.0, 2.0, jg.shape)
    key = jax.random.PRNGKey(7)
    with jax.disable_jit():
        want = np.asarray(JM.gapfill_edge_conv_flat(imap, mask, jg))
        want_n = np.asarray(JM.gapfill_edge_conv_flat(imap, mask, jg,
                                                      ivar=ivar, key=key))
    got = TM.gapfill_edge_conv_flat(imap, mask, tg, device=CPU)
    assert _rel(got, want) <= TOL64
    z = np.asarray(jax.random.normal(key, jg.shape, jnp.float64))
    got = TM.gapfill_edge_conv_flat_from_noise(_t(z), _t(imap), mask, tg,
                                               ivar=ivar)
    assert _rel(got, want_n) <= TOL64
    # a generator draw only changes the holes
    got = TM.gapfill_edge_conv_flat(_t(imap), mask, tg, ivar=ivar,
                                    generator=torch.Generator()
                                    .manual_seed(1))
    np.testing.assert_array_equal(_np(got)[~mask], imap[~mask])


# ---------------------------------------------------------------- (e)

def test_bilinear_rescale_rotate(g64, rng):
    jg, tg = g64
    imap = rng.standard_normal((2,) + jg.shape)
    py = rng.uniform(-2, jg.ny + 1, (9, 11))
    px = rng.uniform(-2, jg.nx + 1, (9, 11))
    py[0, :3] = [0.0, jg.ny - 1, -5e-6]
    px[0, :3] = [0.0, jg.nx - 1 + 5e-6, 3.0]
    assert _rel(TM._bilinear_at(_t(imap), _t(py), _t(px)),
                JM._bilinear_at(jnp.asarray(imap), jnp.asarray(py),
                                jnp.asarray(px))) <= TOL64
    for f in (1.7, 0.6):
        assert _rel(TM.rescale(imap, f, tg, device=CPU),
                    JM.rescale(imap, f, jg)) <= TOL64
    assert _rel(TM.rotate(_t(imap), 0.4, tg),
                JM.rotate(imap, 0.4, jg)) <= TOL64
    # float32 maps: weights in float32
    assert _rel(TM.rotate(_t(imap.astype(np.float32)), 0.4, tg),
                JM.rotate(imap, 0.4, jg)) <= TOL32
    gs = jgeo.rect_geometry(width_arcmin=80 * 2.0, px_res_arcmin=2.0,
                            y0_deg=-19.5)
    ts = tp.rect_geometry(width_arcmin=80 * 2.0, px_res_arcmin=2.0,
                          y0_deg=-19.5)
    src = rng.standard_normal(gs.shape)
    assert _rel(TM.MapRotator(ts, tg, device=CPU).rotate(src),
                JM.MapRotator(gs, jg).rotate(src)) <= TOL64


@pytest.mark.parametrize("shape,res", [((64, 64), 3.0), ((64, 64), 1.3),
                                       ((37, 48), 2.7), ((48, 37), 1.7)])
def test_resample_fft(rng, shape, res):
    ny, nx = shape
    jg = jgeo.Geometry(ny, nx, 2 * arcmin, 2.3 * arcmin)
    tg = tp.Geometry(ny, nx, 2 * arcmin, 2.3 * arcmin)
    imap = rng.standard_normal((2, ny, nx))
    want, wg = JM.resample_fft(imap, jg, res * arcmin)
    got, og = TM.resample_fft(imap, tg, res * arcmin, device=CPU)
    assert og.shape == wg.shape == TM.resampled_geometry(tg, res * arcmin) \
        .shape
    assert _rel(got, want) <= TOL64


# ---------------------------------------------------------------- (f)

@pytest.mark.parametrize("window", ["kaiser", "cosine", "quintic"])
def test_radial_windows(g64, window):
    jg, tg = g64
    r = np.linspace(0, 30 * arcmin, 200)
    a, b = 5 * arcmin, 12 * arcmin
    assert _rel(TM.radial_window(r, a, b, window, device=CPU),
                JM.radial_window(r, a, b, window)) <= TOL64
    prof = np.cos(r / (40 * arcmin))
    assert _rel(TM.apodize_profile(r, prof, a, 4 * arcmin, window,
                                   device=CPU),
                JM.apodize_profile(r, prof, a, 4 * arcmin, window)) <= TOL64
    assert _rel(TM.radial_mask(tg, a, b - a, window, dtype=torch.float64,
                               device=CPU),
                JM.radial_mask(jg, a, b - a, window, dtype=jnp.float64)) \
        <= TOL64
    with pytest.raises(ValueError):
        TM.radial_window(r, a, b, "hann", device=CPU)


def test_kernels_and_convolutions(g64, rng):
    jg, tg = g64
    ells = np.arange(5000.0)
    assert _rel(TM.butterworth(ells, 2000.0, 3, device=CPU),
                JM.butterworth(ells, 2000.0, 3)) <= TOL64
    assert _rel(TM.gauss_kern(1.5, 2.2, device=CPU),
                JM.gauss_kern(1.5, 2.2)) <= TOL64
    rs = np.linspace(0, 10 * arcmin, 80)
    bprof = np.exp(-0.5 * (rs / (1.5 * arcmin)) ** 2)
    assert _rel(TM.gkern_interp(tg, rs, bprof, 3.0, nsigma=4.0, device=CPU),
                JM.gkern_interp(jg, rs, bprof, 3.0, nsigma=4.0)) <= TOL64
    imap = rng.standard_normal((3,) + jg.shape)
    ker = rng.uniform(0, 1, (5, 8))
    assert _rel(TM.convolve(imap, ker, device=CPU),
                JM.convolve(imap, ker)) <= TOL64
    assert _rel(TM.convolve_gaussian(_t(imap), tg, 6.0),
                JM.convolve_gaussian(imap, jg, 6.0)) <= TOL64
    assert _rel(TM.convolve_profile(_t(imap[0]), tg, rs, bprof, 3.0,
                                    nsigma=4.0),
                JM.convolve_profile(imap[0], jg, rs, bprof, 3.0,
                                    nsigma=4.0)) <= TOL64
    kfilt = np.asarray(JF.gauss_beam(jg.modlmap_np(), 5.0))
    assert _rel(TM.real_space_filter(kfilt, device=CPU),
                JM.real_space_filter(kfilt)) <= TOL32
    assert _rel(TM.rfilter(imap[0], kfilt, device=CPU),
                JM.rfilter(imap[0], kfilt)) <= TOL32


def test_circular_mask_and_autofilter(g64, rng):
    jg, tg = g64
    with jax.disable_jit():
        want = [np.asarray(JM.circular_mask(jg, (30.4, 20.0), 6 * arcmin,
                                            apo_deg=0.1, **kw))
                for kw in ({}, dict(smooth_fwhm_rad=2 * arcmin))]
        want.append(np.asarray(JM.circular_mask(jg, (10, 50), 3 * arcmin)))
        ivar = rng.uniform(1, 2, jg.shape)
        ivar[:6] = 0.0
        imap = rng.standard_normal(jg.shape)
        fw, mw = JM.autofiltered_maps(imap, jg, ivar=ivar, apod_deg=0.1,
                                      grow_deg=0.1)
    got = [TM.circular_mask(tg, (30.4, 20.0), 6 * arcmin, apo_deg=0.1,
                            device=CPU, **kw)
           for kw in ({}, dict(smooth_fwhm_rad=2 * arcmin))]
    got.append(TM.circular_mask(tg, (10, 50), 3 * arcmin, device=CPU))
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and _rel(a, b) <= TOL32
    fg, mg = TM.autofiltered_maps(imap, tg, ivar=ivar, apod_deg=0.1,
                                  grow_deg=0.1, device=CPU)
    assert _rel(mg, mw) <= TOL32 and _rel(fg, fw) <= TOL32


# ---------------------------------------------------------------- (g)

def test_covariances(rng, cl_tt):
    ells, cl = cl_tt
    jg = jgeo.Geometry(6, 6, 2 * arcmin, 2 * arcmin)
    tg = tp.Geometry(6, 6, 2 * arcmin, 2 * arcmin)
    p2d = np.asarray(JF.interp1d_to_2d(ells, cl, jg, dtype=jnp.float64))
    assert _rel(TM.diagonal_cov(p2d, tg, device=CPU),
                JM.diagonal_cov(p2d, jg)) <= TOL64
    p3 = np.stack([np.stack([p2d, 0.3 * p2d]), np.stack([0.3 * p2d, p2d])])
    assert _rel(TM.diagonal_cov(_t(p3), tg), JM.diagonal_cov(p3, jg)) \
        <= TOL64
    assert _rel(TM.ncov(tg, 10.0, device=CPU), JM.ncov(jg, 10.0)) <= TOL64
    fc = rng.standard_normal((1, 1) + jg.shape + jg.shape)
    assert _rel(TM.pixcov(tg, fc, device=CPU), JM.pixcov(jg, fc)) <= TOL32


@pytest.mark.parametrize("pad", [0, 2])
def test_pixcov_sim(rng, cl_tt, pad):
    ells, cl = cl_tt
    jg = jgeo.Geometry(6, 6, 2 * arcmin, 2 * arcmin)
    tg = tp.Geometry(6, 6, 2 * arcmin, 2 * arcmin)
    ps = cl[None, None]
    key = jax.random.PRNGKey(11)
    want = JM.pixcov_sim(jg, ps, 40, key=key, pad=pad)
    g = jgeo.Geometry(6 + 2 * pad, 6 + 2 * pad, 2 * arcmin, 2 * arcmin)
    eta = np.stack([np.asarray(JG.rand_kmap(k, g, 1, dtype=jnp.float32))
                    for k in jax.random.split(key, 40)])
    got = TM.pixcov_sim_from_noise(_t(eta), tg, ps, pad=pad)
    assert _rel(got, want) <= TOL32
    drawn = TM.pixcov_sim(tg, ps, 40, torch.Generator().manual_seed(1),
                          pad=pad, device=CPU)
    assert drawn.shape == (36, 36) and np.all(np.diag(drawn) > 0)


# ---------------------------------------------------------------- (h)

def test_random_source_map(g64):
    jg, tg = g64
    key = jax.random.PRNGKey(5)
    kpos, _ = jax.random.split(key)
    pix = np.asarray(jax.random.randint(
        kpos, (40, 2), 0, jnp.asarray([jg.ny, jg.nx])[None, :]))
    amps = np.linspace(1, 2, 40)
    rs = np.linspace(0, 10 * arcmin, 50)
    for kw in (dict(), dict(fwhm=3.0), dict(amps=amps),
               dict(profile=(rs, np.exp(-rs / arcmin)))):
        want = JM.random_source_map(key, jg, 40, **kw)
        got = TM.random_source_map_from_noise(_t(pix), tg, **kw)
        assert got.dtype == torch.float32 and _rel(got, want) <= TOL32
    got = TM.random_source_map(torch.Generator().manual_seed(3), tg, 40,
                               fwhm=3.0, device=CPU)
    assert got.shape == tg.shape


def test_grf_draws(g64, th, cl_tt):
    jg, tg = g64
    ells, cl = cl_tt
    key = jax.random.PRNGKey(8)
    p2d = np.asarray(JF.interp1d_to_2d(ells, cl, jg, dtype=jnp.float64))
    m = np.stack([np.stack([p2d, 0.5 * p2d]), np.stack([0.5 * p2d, p2d])])
    for power, ncomp in ((p2d, 1), (p2d[None, None], 1), (m, 2)):
        eta = np.asarray(JG.rand_kmap(key, jg, ncomp, dtype=jnp.float32))
        want = JM.get_grf_realization(key, jg, power)
        got = TM.get_grf_realization_from_noise(_t(eta), tg, power)
        assert _rel(got, want) <= TOL32
        got = TM.get_grf_realization(torch.Generator().manual_seed(0), tg,
                                     power, device=CPU)
        assert got.shape == tuple(want.shape)
    eta = np.asarray(JG.rand_kmap(key, jg, 1, dtype=jnp.float32))
    assert _rel(TM.get_grf_cmb_from_noise(_t(eta), tg, th, "EE"),
                JM.get_grf_cmb(key, jg, th, "EE")) <= TOL32
    assert TM.get_grf_cmb(torch.Generator(), tg, th, "TT", device=CPU) \
        .shape == tg.shape
    gj, mlj, _, mgj = JM.flat_sim(2.0, 2.0, lmax=3000, pol=True)
    gt, mlt, _, mgt = TM.flat_sim(2.0, 2.0, lmax=3000, pol=True, device=CPU)
    assert gt.shape == gj.shape and _rel(mlt, mlj) <= TOL64
    assert _rel(mgt.covsqrt, mgj.covsqrt) <= TOL32


def test_generate_correlated_alm(rng):
    lmax = 30
    n = jalm.nalm(lmax)
    alm = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    ls = np.arange(lmax + 1.0)
    c11, c22, c12 = 1 / (ls + 5), 2 / (ls + 5), 0.5 / (ls + 5)
    c11[0] = 0.0
    key = jax.random.PRNGKey(12)
    kr, ki = jax.random.split(key)
    re = np.asarray(jax.random.normal(kr, (n,)))
    im = np.asarray(jax.random.normal(ki, (n,)))
    want = JM.generate_correlated_alm(jnp.asarray(alm), c11, c22, c12,
                                      key=key)
    got = TM.generate_correlated_alm_from_noise(_t(re), _t(im), alm, c11,
                                                c22, c12)
    assert _rel(got, want) <= TOL32
    got = TM.generate_correlated_alm(_t(alm), c11, c22, c12)
    assert got.shape == (n,) and got.dtype == torch.complex128


# ---------------------------------------------------------------- (i)

def test_healpix_thumbnails(g64, rng):
    jg, tg = g64
    nside = 32
    hmap = rng.standard_normal(12 * nside * nside)
    tj, gj = JM.thumbnail_healpix(hmap, 40.0, -30.0, 120.0, 4.0)
    tt, gt = TM.thumbnail_healpix(hmap, 40.0, -30.0, 120.0, 4.0)
    np.testing.assert_array_equal(tt, tj)
    assert gt.shape == gj.shape
    np.testing.assert_array_equal(
        _np(TM.get_planck_cutout(hmap, 40.0, -30.0, 100.0, px=4.0,
                                 arcmin_y=60.0, device=CPU)),
        JM.get_planck_cutout(hmap, 40.0, -30.0, 100.0, px=4.0,
                             arcmin_y=60.0))
    got = TM.galactic_mask(tg, 64, 1.92, 2.5, device=CPU)
    want = JM.galactic_mask(jg, 64, 1.92, 2.5)
    np.testing.assert_array_equal(_np(got), want)
    assert 0 < float(got.mean()) < 1
