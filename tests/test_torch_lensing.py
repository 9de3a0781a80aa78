"""Parity of the rest of the port's ``models/lensing.py`` with the JAX
package: ``gradient``, ``taylens``, ``FixedLens``, polarized
``FlatLensingSims``, the NFW profiles and the host utilities.

Inputs come from a numpy seed or, for the draws, from the JAX key's own
white noise handed to the port's ``*_from_noise`` twins. Every port call
runs on the CPU, where the displacement takes kernel B8's plain version.
Bounds: fp32 maps through FFTs and spline taps, 2e-5 of the map's max
(tests/test_lensing.py's bound for the lensing operators), whole sims
(GRF synthesis, lensing, beam and noise in fp32 on both sides) too; NFW
profiles 1e-5 relative in float64; host numpy utilities array-equal.
"""
import warnings

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from orphics_tpu import geometry as jgeo
from orphics_tpu.models import grf as jgrf, lensing as jlens, theory as jtheory

import orphics_tpu_torch as tp
from orphics_tpu_torch.models import lensing as tlens, theory as ttheory
from orphics_tpu_torch.ops.lens import lens_map_kernel

torch.set_num_threads(1)

TOL_LENS = 2e-5
TOL_SIM = 2e-5
RTOL_NFW = 1e-5


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got, want, tol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), what


@pytest.fixture(scope="module")
def setup():
    kw = dict(width_arcmin=64 * 3.0, px_res_arcmin=3.0)
    jg, tg = jgeo.rect_geometry(**kw), tp.rect_geometry(**kw)
    jth, tth = jtheory.default_theory(), ttheory.default_theory()
    fls = jlens.FlatLensingSims(jg, jth, beam_arcmin=1.5, noise_uk_arcmin=7.0)
    kc, kk = jax.random.split(jax.random.PRNGKey(5))
    imap = np.asarray(fls.get_unlensed(kc)).astype(np.float32)
    kappa = np.asarray(fls.get_kappa(kk)).astype(np.float32)
    alpha = np.asarray(jlens.alpha_from_kappa(jnp.asarray(kappa), jg)) \
        .astype(np.float32)
    return jg, tg, jth, tth, imap, kappa, alpha


def test_gradient_matches_jax(setup):
    jg, tg, _, _, imap, _, _ = setup
    got = tlens.gradient(_t(imap), tg)
    want = np.asarray(jlens.gradient(jnp.asarray(imap), jg))
    assert got.shape == (2,) + tg.shape
    _close(got.numpy(), want, TOL_LENS, "gradient")


@pytest.mark.parametrize("order", [3, 5])
def test_taylens_matches_jax(setup, order):
    jg, tg, _, _, imap, _, alpha = setup
    want = np.asarray(jlens.taylens(jnp.asarray(imap), jnp.asarray(alpha),
                                    jg, order=order))
    got = tlens.taylens(_t(imap), _t(alpha), tg, order=order)
    _close(got.numpy(), want, TOL_LENS, "taylens")
    # with leading component axes, and against the spline operator: the
    # two lensing methods agree to the Taylor remainder
    stack = np.stack([imap, 2 * imap])
    got2 = tlens.taylens(_t(stack), _t(alpha), tg, order=order)
    _close(got2[0].numpy(), got.numpy(), 1e-6, "component axis")
    if order == 5:
        spline = tlens.lens_map_spline(_t(imap), _t(alpha), tg, order=5)
        _close(got.numpy(), spline.numpy(), 2e-2, "taylens vs spline")


@pytest.mark.parametrize("pol", [False, True])
def test_fixed_lens_matches_jax(setup, pol):
    jg, tg, jth, tth, _, kappa, _ = setup
    jf = jlens.FixedLens(jg, jth, kappa, pol=pol)
    tf = tlens.FixedLens(tg, tth, kappa, pol=pol, device="cpu")
    _close(tf.alpha.numpy(), np.asarray(jf.alpha), TOL_LENS, "alpha")
    key = jax.random.PRNGKey(2)
    un_j, le_j = jf.generate_sim(key)
    ncomp = 3 if pol else 1
    eta = np.asarray(jgrf.rand_kmap(key, jg, ncomp, dtype=jnp.float32))
    un_t, le_t = tf.generate_sim_from_noise(_t(eta))
    _close(un_t.numpy(), np.asarray(un_j), TOL_SIM, "unlensed")
    _close(le_t.numpy(), np.asarray(le_j), TOL_SIM, "lensed")
    # a batch of draws; a new kappa moves the deflection
    un_b, le_b = tf.generate_sim(torch.Generator().manual_seed(1), batch=(2,))
    assert un_b.shape == le_b.shape == (2,) + un_t.shape
    assert bool(torch.isfinite(le_b).all())
    tf.update_kappa(2 * kappa)
    _close(tf.alpha.numpy(), 2 * np.asarray(jf.alpha), TOL_LENS, "update")


@pytest.mark.parametrize("pol,method", [(True, "spline"),
                                        (False, "taylens")])
def test_flat_lensing_sims_same_draws(setup, pol, method):
    """``get_sim`` of a polarized ``FlatLensingSims`` on the JAX key's own
    white noise: every intermediate and the observed (I, Q, U) maps; and
    the ``taylens`` method on a scalar sim (the JAX ``taylens`` takes no
    component axis)."""
    jg, tg, jth, tth = setup[:4]
    kw = dict(beam_arcmin=1.5, noise_uk_arcmin=7.0, pol=pol, lens_order=5,
              lens_method=method)
    jf = jlens.FlatLensingSims(jg, jth, **kw)
    tf = tlens.FlatLensingSims(tg, tth, device="cpu", **kw)
    key = jax.random.PRNGKey(9)
    obs_j, ex_j = jf.get_sim(key, return_intermediate=True)
    nc = 3 if pol else 1
    etas = [np.asarray(jgrf.rand_kmap(k, jg, c, dtype=jnp.float32))
            for k, c in zip(jax.random.split(key, 3), (nc, 1, nc))]
    obs_t, ex_t = tf.get_sim_from_noise(*map(_t, etas),
                                        return_intermediate=True)
    assert obs_t.shape == ((3,) if pol else ()) + tg.shape
    for name in ("unlensed", "kappa", "lensed", "beamed", "noise"):
        _close(ex_t[name].numpy(), np.asarray(ex_j[name]), TOL_SIM, name)
    _close(obs_t.numpy(), np.asarray(obs_j), TOL_SIM, "observed")
    if pol:
        # polarization noise defaults to sqrt(2) x the temperature's
        ratio = ex_t["noise"][1].std() / ex_t["noise"][0].std()
        assert abs(ratio.item() - np.sqrt(2.0)) < 0.05


def test_polarized_sims_batch_and_skip_lensing(setup):
    jg, tg, jth, tth = setup[:4]
    tf = tlens.FlatLensingSims(tg, tth, 1.5, 7.0, pol=True, device="cpu")
    gen = torch.Generator().manual_seed(4)
    etas = tf.draw_noise(gen, batch=(2,))
    assert [e.shape[1] for e in etas] == [3, 1, 3]
    obs, ex = tf.get_sim_from_noise(*etas, return_intermediate=True)
    assert obs.shape == (2, 3) + tg.shape
    # each batch entry is the single-sim call on its own noise
    one = tf.get_sim_from_noise(*(e[1] for e in etas))
    _close(obs[1].numpy(), one.numpy(), 1e-6, "batch entry")
    # the displacement of three components by one deflection is the kernel
    # wrapper's, component by component
    alpha = tlens.alpha_from_kappa(ex["kappa"], tg)
    t_only = lens_map_kernel(ex["unlensed"][:, :1].contiguous(),
                             alpha.contiguous(), tg, order=5,
                             maxdisp_px=max(tg.shape))
    _close(ex["lensed"][:, :1].numpy(), t_only.numpy(), 1e-6, "T leg")
    skipped, ex0 = tf.get_sim_from_noise(*etas, return_intermediate=True,
                                         skip_lensing=True)
    assert torch.equal(ex0["lensed"], ex0["unlensed"])
    assert not bool(ex0["kappa"].any())
    assert tf.get_sim(gen, skip_lensing=True).shape == (3,) + tg.shape
    with pytest.raises(ValueError, match="lens_method"):
        tlens.FlatLensingSims(tg, tth, 1.5, 7.0, lens_method="nearest",
                              device="cpu")


# ---- NFW profiles ------------------------------------------------------

def test_gnfw_and_helpers_match_jax():
    x = np.concatenate([np.geomspace(1e-3, 0.999, 40), [1.0, 1.0 + 5e-7],
                        np.geomspace(1.001, 50.0, 40)])
    np.testing.assert_allclose(tlens.gnfw(_t(x)).numpy(),
                               np.asarray(jlens.gnfw(x)), rtol=RTOL_NFW)
    np.testing.assert_allclose(float(tlens.f_c(3.2)), float(jlens.f_c(3.2)),
                               rtol=1e-12)
    np.testing.assert_allclose(tlens.fnfw(_t(x)).numpy(),
                               np.asarray(jlens.fnfw(x)), rtol=1e-12)
    assert (tlens.G_MPC_S_MSUN, tlens.C_MPC_S, tlens.TWO_G_OVER_C2) == (
        jlens.G_MPC_S_MSUN, jlens.C_MPC_S, jlens.TWO_G_OVER_C2)


def test_nfw_density_and_projection_match_jax():
    M, c, R, comL, z, win = 2e14, 3.2, 1.5, 1500.0, 0.7, 0.4
    r = np.geomspace(0.01, 5.0, 30)
    np.testing.assert_allclose(tlens.rho_nfw(M, c, R)(_t(r)).numpy(),
                               np.asarray(jlens.rho_nfw(M, c, R)(r)),
                               rtol=RTOL_NFW)
    thetas = np.geomspace(1e-5, 3e-3, 11)
    np.testing.assert_allclose(
        tlens.proj_rho_nfw(_t(thetas), comL, M, c, R).numpy(),
        np.asarray(jlens.proj_rho_nfw(thetas, comL, M, c, R)), rtol=RTOL_NFW)
    np.testing.assert_allclose(
        tlens.kappa_nfw_generic(_t(thetas), z, comL, M, c, R, win).numpy(),
        np.asarray(jlens.kappa_nfw_generic(thetas, z, comL, M, c, R, win)),
        rtol=RTOL_NFW)
    # the quadrature, at a sample count the CPU takes in no time; in chunks
    # of thetas that do and do not divide their number
    want = np.asarray(jlens.projected_rho(thetas, comL,
                                          jlens.rho_nfw(M, c, R),
                                          pmax=200.0, nps=4001))
    for chunk in (8, 4, 11):
        got = tlens.projected_rho(_t(thetas), comL, tlens.rho_nfw(M, c, R),
                                  pmax=200.0, nps=4001, chunk=chunk)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL_NFW)
    np.testing.assert_allclose(
        tlens.kappa_generic(_t(thetas), z, comL, tlens.rho_nfw(M, c, R), win,
                            pmax=200.0, nps=4001).numpy(),
        np.asarray(jlens.kappa_generic(thetas, z, comL,
                                       jlens.rho_nfw(M, c, R), win,
                                       pmax=200.0, nps=4001)),
        rtol=RTOL_NFW)
    # a scalar theta gives one value
    assert tlens.projected_rho(1e-4, comL, tlens.rho_nfw(M, c, R),
                               pmax=200.0, nps=401,
                               device="cpu").shape == (1,)


def test_nfw_profiles_take_host_arrays():
    """Host numbers and arrays go to ``device`` as float64 and give what
    the same values give as tensors."""
    M, c, R, comL, z, win = 2e14, 3.2, 1.5, 1500.0, 0.7, 0.4
    thetas = np.geomspace(1e-5, 3e-3, 11)
    rho = tlens.rho_nfw(M, c, R)
    pairs = [
        (tlens.gnfw(thetas * 1e3, device="cpu"), tlens.gnfw(_t(thetas * 1e3))),
        (tlens.proj_rho_nfw(thetas, comL, M, c, R, device="cpu"),
         tlens.proj_rho_nfw(_t(thetas), comL, M, c, R)),
        (tlens.kappa_nfw_generic(thetas, z, comL, M, c, R, win, device="cpu"),
         tlens.kappa_nfw_generic(_t(thetas), z, comL, M, c, R, win)),
        (tlens.projected_rho(thetas, comL, rho, 200.0, 401, device="cpu"),
         tlens.projected_rho(_t(thetas), comL, rho, 200.0, 401)),
        (tlens.kappa_generic(thetas, z, comL, rho, win, 200.0, 401,
                             device="cpu"),
         tlens.kappa_generic(_t(thetas), z, comL, rho, win, 200.0, 401)),
        (tlens.nfw_kappa_profile(thetas, M, comL, win, z, rdel_mpc_overh=R,
                                 device="cpu"),
         tlens.nfw_kappa_profile(_t(thetas), M, comL, win, z,
                                 rdel_mpc_overh=R)),
    ]
    for host, tens in pairs:
        assert host.dtype == torch.float64 and host.device.type == "cpu"
        assert torch.equal(host, tens)


@pytest.mark.parametrize("mass", [2e14, -1e14])
def test_nfw_kappa_profile_matches_jax(setup, mass):
    jg, tg = setup[:2]
    kw = dict(comL_mpc_overh=1200.0, win_at_lens=0.35, z_lens=0.6)
    want = np.asarray(jlens.nfw_kappa_profile(
        jg.modrmap(jnp.float64), mass, rdel_mpc_overh=1.2, **kw))
    got = tlens.nfw_kappa_profile(tg.modrmap(torch.float64, "cpu"), mass,
                                  rdel_mpc_overh=1.2, **kw)
    assert got.shape == tg.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL_NFW)
    # R_delta from the mean density
    want = np.asarray(jlens.nfw_kappa_profile(
        jg.modrmap(jnp.float64), mass, rho_mean_z=8e10, **kw))
    got = tlens.nfw_kappa_profile(tg.modrmap(torch.float64, "cpu"), mass,
                                  rho_mean_z=8e10, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL_NFW)
    with pytest.raises(ValueError, match="rdel_mpc_overh"):
        tlens.nfw_kappa_profile(tg.modrmap(torch.float64, "cpu"), mass, **kw)


# ---- host utilities ----------------------------------------------------

def test_fill_low_ell_and_sanitize_power_match_jax():
    ells = np.arange(2, 200)
    cls = 1.0 / ells ** 2.0
    for got, want in zip(tlens.fill_low_ell(ells, cls, 30),
                         jlens.fill_low_ell(ells, cls, 30)):
        np.testing.assert_array_equal(got, want)
    nl = np.linspace(-1.0, 3.0, 50) ** 3
    nl[20] = np.nan
    np.testing.assert_array_equal(tlens.sanitize_power(nl),
                                  jlens.sanitize_power(nl))
    assert np.all(tlens.sanitize_power(nl)[5:] >= 0)


def test_validate_geometry_warns_as_jax():
    ok = tp.rect_geometry(width_arcmin=64 * 3.0, px_res_arcmin=3.0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tlens.validate_geometry(ok)
    for bad in (tp.Geometry(4, 4, 1e-7, 1e-7), tp.Geometry(4, 4, 1.0, 1.0)):
        jbad = jgeo.Geometry(bad.ny, bad.nx, bad.dy, bad.dx)
        with pytest.warns(UserWarning) as tw:
            tlens.validate_geometry(bad)
        with pytest.warns(UserWarning) as jw:
            jlens.validate_geometry(jbad)
        assert len(tw) == len(jw)
