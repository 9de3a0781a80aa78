"""Parity of the port's ``models/nfwfit`` with the JAX package: NFW
profiles, the binned and fitted profiles, the two-halo and miscentered
terms, the matched-filter S/N, and the lensed pixel covariances, on the
same cosmology, geometry and inputs.

Tolerances: float64 profile math on both sides, 1e-10 relative (host
quadratures) or 1e-8 (tensor math in another library); binned profiles
are Fourier-filtered in float64 and binned from float32 on the port
(``Bin2D`` takes float32 maps), so 1e-6 of the profile's max (the float32
map-path budget of 1e-5 holds with room); the lensed covariances displace
float32 rows by B-splines on both sides: 2e-5 of the max, the
displacement contract (``tests/test_lensing.py:249``).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from orphics_tpu import geometry as jgeo
from orphics_tpu.geometry import arcmin
from orphics_tpu.models import cosmology as JC, nfwfit as JNF

import orphics_tpu_torch as tp
from orphics_tpu_torch.models import cosmology as TC, nfwfit as TNF

torch.set_num_threads(1)

RTOL_HOST = 1e-10
RTOL_TORCH64 = 1e-8
RTOL_BIN = 1e-6
RTOL_LENS = 2e-5


def _rel(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


@pytest.fixture(scope="module")
def setup():
    """Cosmologies and a 32^2 stamp at 0.5' (both packages)."""
    kw = dict(width_arcmin=32 * 0.5, px_res_arcmin=0.5)
    return (JC.Cosmology(), TC.Cosmology(), jgeo.rect_geometry(**kw),
            tp.rect_geometry(**kw))


@pytest.fixture(scope="module")
def covs():
    """A 16^2 (256 x 256) float32 covariance and a deflection of ~0.7
    pixels rms, and the JAX lensed covariances (computed once)."""
    g = jgeo.rect_geometry(width_arcmin=16 * 2.0, px_res_arcmin=2.0)
    rng = np.random.default_rng(3)
    A = rng.standard_normal((256, 256))
    U = (A @ A.T / 256).astype(np.float32)
    alpha = (rng.standard_normal((2, 16, 16)) * g.dy * 0.7).astype(np.float32)
    kb = np.exp(-(g.modlmap_np() / 3000.0) ** 2)
    want = {None: np.asarray(JNF.lens_cov(U, alpha, g)),
            "beam": np.asarray(JNF.lens_cov(U, alpha, g, kbeam=kb))}
    return g, U, alpha, kb, want


def test_nfw_kappa_profiles(setup):
    jc, tc, jg, tg = setup
    modr = jg.modrmap_np()
    k_t = TNF.nfw_kappa(2e14, modr, tc, device="cpu")
    assert k_t.dtype == torch.float64
    assert _rel(k_t, JNF.nfw_kappa(2e14, jnp.asarray(modr), jc)) \
        <= RTOL_TORCH64
    assert _rel(TNF.nfw_kappa(-3e14, torch.as_tensor(modr), tc,
                              critical=True, at_cluster_z=True,
                              overdensity=500.0),
                JNF.nfw_kappa(-3e14, jnp.asarray(modr), jc, critical=True,
                              at_cluster_z=True, overdensity=500.0)) \
        <= RTOL_TORCH64
    th = np.linspace(0.1, 5.0, 9)
    kt, rt = TNF.NFWkappa(tc, 2e14, 3.2, 0.5, th, 0.4, device="cpu")
    kj, rj = JNF.NFWkappa(jc, 2e14, 3.2, 0.5, th, 0.4)
    assert _rel(kt, kj) <= RTOL_TORCH64 and rt == pytest.approx(rj)
    t = np.geomspace(1e-5, 1e-3, 9)
    assert _rel(TNF.kappa_nfw(2e14, 3.2, 1.2, t, tc, 0.5, device="cpu"),
                JNF.kappa_nfw(2e14, 3.2, 1.2, t, jc, 0.5)) <= RTOL_TORCH64
    # the line-of-sight quadrature (500000 samples): its own sum order
    assert _rel(TNF.kappa_from_rhofunc(2e14, 3.2, 1.2, t[:3], tc, 0.5,
                                       device="cpu"),
                JNF.kappa_from_rhofunc(2e14, 3.2, 1.2, t[:3], jc, 0.5)) \
        <= 1e-9
    np.testing.assert_allclose(TNF.rayleigh(t, 1e-4),
                               np.asarray(JNF.rayleigh(t, 1e-4)),
                               rtol=RTOL_HOST)


def test_two_halo_and_miscentering(setup):
    jc, tc, jg, tg = setup
    assert TNF.halo_bias(2e14, 0.5, tc) == pytest.approx(
        JNF.halo_bias(2e14, 0.5, jc), rel=RTOL_HOST)
    assert TNF.halo_bias(2e14, 0.5, tc, critical=True, overdensity=500.0) \
        == pytest.approx(JNF.halo_bias(2e14, 0.5, jc, critical=True,
                                       overdensity=500.0), rel=RTOL_HOST)
    th = np.geomspace(1e-5, 1e-3, 9)
    assert _rel(TNF.kappa_2h_profile(th, 2e14, 0.5, tc, nl=256),
                JNF.kappa_2h_profile(th, 2e14, 0.5, jc, nl=256)) \
        <= RTOL_HOST
    assert _rel(TNF.kappa_2h_map(tg, -2e14, 0.5, tc, device="cpu"),
                JNF.kappa_2h_map(jg, -2e14, 0.5, jc)) <= RTOL_TORCH64
    a = TNF.kappa_nfw_profiley1d(th, R_off_Mpc=0.2, cc=tc, device="cpu")
    b = JNF.kappa_nfw_profiley1d(th, R_off_Mpc=0.2, cc=jc)
    assert _rel(a[0], b[0]) <= RTOL_TORCH64 and _rel(a[1], b[1]) \
        <= RTOL_TORCH64
    assert _rel(TNF.kappa_nfw_profiley(tg, R_off_Mpc=0.2, cc=tc,
                                       device="cpu"),
                JNF.kappa_nfw_profiley(jg, R_off_Mpc=0.2, cc=jc)) \
        <= RTOL_TORCH64


@pytest.mark.parametrize("model", ["nfw", "nfw+2h+miscentered"])
def test_binned_nfw(setup, model):
    jc, tc, jg, tg = setup
    edges = np.arange(0.0, 8.0, 1.0)
    kw = {} if model == "nfw" else dict(include_2h=True, sigma_mis=0.5)
    cj, pj = JNF.binned_nfw(2e14, 0.7, 3.2, jc, jg, edges, lmax=20000, **kw)
    ct, pt = TNF.binned_nfw(2e14, 0.7, 3.2, tc, tg, edges, lmax=20000,
                            device="cpu", **kw)
    np.testing.assert_array_equal(ct, cj)
    assert pt.dtype == torch.float32 and _rel(pt, pj) <= RTOL_BIN


def test_fit_nfw_profile(setup):
    jc, tc, jg, tg = setup
    edges = np.arange(0.0, 8.0, 1.0)
    _, prof = JNF.binned_nfw(2.2e14, 0.7, 3.2, jc, jg, edges, lmax=20000)
    prof = np.asarray(prof, np.float64)
    cov = np.diag((0.1 * np.abs(prof) + 1e-4) ** 2)
    masses = np.linspace(1e14, 4e14, 7)
    got = TNF.fit_nfw_profile(prof, cov, masses, 0.7, 3.2, tc, tg, edges,
                              20000, device="cpu")
    want = JNF.fit_nfw_profile(prof, cov, masses, 0.7, 3.2, jc, jg, edges,
                               20000)
    # lnL, the fitted curve, mass and error, the profiles: the float32
    # binning's 1e-7 carried through chi^2 and the Gaussian fit
    for a, b in zip(got, want):
        assert _rel(a, b) <= 1e-5


def test_filter_bin_and_matched_filter(setup):
    jc, tc, jg, tg = setup
    om = np.array(JNF.nfw_kappa(2e14, jnp.asarray(jg.modrmap_np()), jc))
    kw = dict(lmin=100, lmax=20000, rmax=6 * arcmin, rwidth=0.5 * arcmin)
    a = JNF.filter_bin_kappa2d(om, jg, **kw)
    b = TNF.filter_bin_kappa2d(om, tg, device="cpu", **kw)
    assert _rel(b[1], a[1]) <= RTOL_BIN
    fls = np.exp(-np.arange(20000.0) / 8000.0)
    a = JNF.filter_bin_kappa2d(om, jg, fls=fls, **kw)
    b = TNF.filter_bin_kappa2d(torch.as_tensor(om), tg, fls=fls, **kw)
    assert _rel(b[1], a[1]) <= RTOL_BIN
    th = np.geomspace(1e-6, 5e-3, 64)
    kap = np.asarray(JNF.NFWkappa(jc, 2e14, 3.2, 0.5, th / arcmin, 0.4)[0])
    kw1 = dict(res=0.2 * arcmin, rstamp=12 * arcmin, rmax=5 * arcmin,
               rwidth=0.5 * arcmin)
    a = JNF.filter_bin_kappa1d(th, kap, **kw1)
    b = TNF.filter_bin_kappa1d(th, kap, device="cpu", **kw1)
    assert _rel(b[1], a[1]) <= RTOL_BIN
    ells = np.arange(2, 5000.0)
    nls = 1e-7 * (1 + ells / 2000.0)
    got = TNF.NFWMatchedFilterSN(tc, 14.5, 3.2, 0.5, ells, nls, 3000,
                                 arc_stamp=20, px_stamp=0.2,
                                 rayleigh_sigma_arcmin=0.5, device="cpu")
    want = JNF.NFWMatchedFilterSN(jc, 14.5, 3.2, 0.5, ells, nls, 3000,
                                  arc_stamp=20, px_stamp=0.2,
                                  rayleigh_sigma_arcmin=0.5)
    for a, b in zip(got, want):
        assert a == pytest.approx(b, rel=RTOL_HOST)
    # mass_estimate on the port's MatchedFilter (ROADMAP queue A item 13b):
    # a 3e14 halo in white noise, fitted from a 2e14 guess, three rounds
    rng = np.random.default_rng(9)
    kap = np.asarray(JNF.nfw_kappa(3e14, jnp.asarray(jg.modrmap_np()), jc)) \
        + 1e-3 * rng.standard_normal(jg.shape)
    n2d = np.full(jg.shape, 1e-9)
    kmask = (jg.modlmap_np() < 20000).astype(np.float64)
    want = JNF.mass_estimate(kap, n2d, jg, 2e14, 3.2, 0.5, cc=jc,
                             kmask=kmask)
    got = TNF.mass_estimate(kap, n2d, tg, 2e14, 3.2, 0.5, cc=tc,
                            kmask=kmask, device="cpu")
    for a, b in zip(got, want):
        assert a == pytest.approx(b, rel=RTOL_TORCH64)


@pytest.mark.parametrize("beam", [None, "beam"])
def test_lens_cov_matches_jax(covs, beam):
    g, U, alpha, kb, want = covs
    tg = tp.rect_geometry(width_arcmin=16 * 2.0, px_res_arcmin=2.0)
    got = TNF.lens_cov(torch.as_tensor(U), torch.as_tensor(alpha), tg,
                       kbeam=None if beam is None else torch.as_tensor(kb))
    assert got.dtype == torch.float32 and tuple(got.shape) == U.shape
    assert _rel(got, want[beam]) <= RTOL_LENS
    if beam is None:
        # host arrays go to the named device
        host = TNF.lens_cov(U, alpha, tg, device="cpu")
        assert torch.equal(host, got)


def test_lens_cov_is_one_batched_call_per_side(covs, monkeypatch):
    """Each side of L U L^T is one call of lens_map_spline on the whole
    (npix, ny, nx) batch of rows (one B8 launch on the card), not a loop
    over rows."""
    g, U, alpha, kb, want = covs
    tg = tp.rect_geometry(width_arcmin=16 * 2.0, px_res_arcmin=2.0)
    calls = []
    real = TNF.lens_map_spline

    def counted(imap, a, geom, order=5):
        calls.append(tuple(imap.shape))
        return real(imap, a, geom, order=order)

    monkeypatch.setattr(TNF, "lens_map_spline", counted)
    TNF.lens_cov(torch.as_tensor(U), torch.as_tensor(alpha), tg)
    assert calls == [(256, 16, 16), (256, 16, 16)]


def test_lens_cov_pol_and_beam_cov(covs):
    g, U, alpha, kb, want = covs
    tg = tp.rect_geometry(width_arcmin=16 * 2.0, px_res_arcmin=2.0)
    Z = np.zeros_like(U)
    U3 = np.stack([np.stack([U, 0.3 * U, Z]), np.stack([0.3 * U, U, Z]),
                   np.stack([Z, Z, U])])
    apx = (np.asarray(alpha) / g.dy).astype(np.float32)
    a = TNF.lens_cov_pol(torch.as_tensor(U3), torch.as_tensor(apx), tg)
    b = JNF.lens_cov_pol(U3, apx, g)
    assert tuple(a.shape) == (3, 3, 256, 256) and _rel(a, b) <= RTOL_LENS
    a = TNF.beam_cov(torch.as_tensor(U), torch.as_tensor(kb), tg)
    b = JNF.beam_cov(U, kb, g)
    assert _rel(a, b) <= 1e-6
