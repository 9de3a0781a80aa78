"""Parity of the port's real-space geometry grids, the rest of its Fourier
calculus (the Q/U <-> E/B rotation, 2D power), the polarized GRF transforms,
``white_noise`` and the two theory helpers with the JAX package.

Inputs come from a numpy seed; every port call runs on the CPU. Bounds:
host numpy functions are array-equal; float32 grids agree to 1e-6 relative
(the same float64 axes rounded once); transforms and rotations in fp32 to
1e-5 of the output's max (XLA's and PyTorch's FFTs round differently).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from orphics_tpu import geometry as jgeo
from orphics_tpu.models import grf as jgrf, theory as jtheory
from orphics_tpu.ops import fourier as JF

import orphics_tpu_torch as tp
from orphics_tpu_torch.models import grf as tgrf, theory as ttheory
from orphics_tpu_torch.ops import fourier as TF

torch.set_num_threads(1)

RTOL_GRID = 1e-6
TOL_FFT = 1e-5

_GEOMS = {"square": dict(width_arcmin=48 * 2.0, px_res_arcmin=2.0),
          "rect": dict(width_arcmin=40 * 1.5, height_arcmin=24 * 1.5,
                       px_res_arcmin=1.5, y0_deg=-35.0)}


@pytest.fixture(scope="module", params=sorted(_GEOMS))
def geoms(request):
    kw = _GEOMS[request.param]
    return jgeo.rect_geometry(**kw), tp.rect_geometry(**kw)


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _close(got, want, tol, what=""):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, what
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= tol * scale, what


def test_extent_scaled_and_host_grids(geoms):
    jg, tg = geoms
    assert tg.extent == jg.extent
    assert tg.scaled(2) == tp.Geometry(*[getattr(jg.scaled(2), f) for f in
                                         ("ny", "nx", "dy", "dx", "y0")])
    np.testing.assert_array_equal(tg.modrmap_np(), jg.modrmap_np())


@pytest.mark.parametrize("name", ["yaxis", "xaxis", "posmap", "modrmap",
                                  "pixmap"])
def test_real_space_grids_match_jax(geoms, name):
    jg, tg = geoms
    got = getattr(tg, name)(torch.float32, "cpu")
    want = np.asarray(getattr(jg, name)(jnp.float32))
    assert got.dtype == torch.float32
    _close(got, want, RTOL_GRID, name)
    got64 = getattr(tg, name)(torch.float64, "cpu")
    np.testing.assert_allclose(got64.numpy(),
                               np.asarray(getattr(jg, name)(jnp.float64)),
                               rtol=1e-14, atol=1e-18)


def test_sky2pix_pix2sky(geoms):
    jg, tg = geoms
    rng = np.random.default_rng(3)
    coords = rng.uniform(-0.01, 0.01, (2, 7, 5))
    pix = tg.sky2pix(_t(coords))
    np.testing.assert_allclose(pix.numpy(), np.asarray(jg.sky2pix(coords)),
                               rtol=1e-13)
    np.testing.assert_allclose(tg.pix2sky(pix).numpy(), coords, rtol=1e-10,
                               atol=1e-15)
    np.testing.assert_allclose(tg.pix2sky(pix).numpy(),
                               np.asarray(jg.pix2sky(np.asarray(pix))),
                               rtol=1e-13, atol=1e-18)


def test_theory_astype_and_planck(geoms):
    jth, tth = jtheory.default_theory(), ttheory.default_theory()
    t32 = tth.astype(np.float32)
    assert all(v.dtype == np.float32 for v in t32.tables.values())
    assert (t32.lpad, t32.dimensionless) == (tth.lpad, tth.dimensionless)
    j32 = jth.astype(jnp.float32)
    for k, v in t32.tables.items():
        np.testing.assert_array_equal(v, np.asarray(j32.tables[k]))
    ells = np.arange(2, 2500, 7.0)
    np.testing.assert_array_equal(ttheory.planck_theory(ells),
                                  jtheory.planck_theory(ells))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("iau", [False, True])
def test_queb_rotmat_matches_jax(geoms, inverse, iau):
    jg, tg = geoms
    got = TF.queb_rotmat(tg, inverse=inverse, iau=iau, device="cpu")
    want = np.asarray(JF.queb_rotmat(jg, inverse=inverse, iau=iau))
    assert got.shape == (2, 2) + tg.shape
    assert np.abs(got.numpy() - want).max() <= 1e-6


def _kmaps(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("ncomp", [2, 3])
def test_iqu2teb_teb2iqu_match_jax(geoms, ncomp):
    jg, tg = geoms
    k = _kmaps((2, ncomp) + tg.shape, ncomp)
    teb = TF.iqu2teb(_t(k), tg)
    _close(teb, JF.iqu2teb(jnp.asarray(k), jg), 1e-6, "iqu2teb")
    back = TF.teb2iqu(teb, tg)
    _close(back, JF.teb2iqu(JF.iqu2teb(jnp.asarray(k), jg), jg), 1e-6,
           "teb2iqu")
    _close(back, k, 1e-6, "roundtrip")
    _close(TF.iqu2teb(_t(k), tg, iau=True),
           JF.iqu2teb(jnp.asarray(k), jg, iau=True), 1e-6, "iau")


def test_f2power_power2d_match_jax(geoms):
    jg, tg = geoms
    rng = np.random.default_rng(5)
    m1 = rng.standard_normal((3,) + tg.shape).astype(np.float32)
    m2 = rng.standard_normal((3,) + tg.shape).astype(np.float32)
    k1, k2 = _kmaps(tg.shape, 6), _kmaps(tg.shape, 7)
    for pix in (False, True):
        _close(TF.f2power(_t(k1), _t(k2), tg, pixel_units=pix),
               JF.f2power(jnp.asarray(k1), jnp.asarray(k2), jg,
                          pixel_units=pix), 1e-6, "f2power")
    # scalar auto, scalar cross, polarized (3, 3) matrix, rot off
    for args, kw in (((m1[0],), {}), ((m1[0], m2[0]), {}), ((m1, m2), {}),
                     ((m1,), {"rot": False}), ((m1, m2), {"iau": True})):
        got = TF.power2d(*(_t(a) for a in args), geom=tg, **kw)
        want = JF.power2d(*(jnp.asarray(a) for a in args), geom=jg, **kw)
        for g, w, what in zip(got, want, ("p2d", "kmap1", "kmap2")):
            _close(g, w, TOL_FFT, what)
    assert TF.power2d(_t(m1), geom=tg)[0].shape == (3, 3) + tg.shape


def test_gauss_beam_real_and_filter_map(geoms):
    jg, tg = geoms
    rs = np.linspace(0.0, 0.003, 50)     # XLA flushes the far tail to 0
    np.testing.assert_allclose(TF.gauss_beam_real(rs, 1.4),
                               np.asarray(JF.gauss_beam_real(rs, 1.4)),
                               rtol=1e-12)
    np.testing.assert_allclose(TF.gauss_beam_real(_t(rs), 1.4).numpy(),
                               np.asarray(JF.gauss_beam_real(rs, 1.4)),
                               rtol=1e-12)
    assert TF.filter_map is TF.kfilter


def test_polarized_harm2map_map2harm_match_jax(geoms):
    jg, tg = geoms
    k = _kmaps((2, 3) + tg.shape, 8)
    for iau in (False, True):
        _close(tgrf.harm2map(_t(k), tg, iau=iau),
               jgrf.harm2map(jnp.asarray(k), jg, iau=iau), TOL_FFT, "harm2map")
    # two components are a scalar pair: no rotation
    _close(tgrf.harm2map(_t(k[:, :2]), tg),
           jgrf.harm2map(jnp.asarray(k[:, :2]), jg), TOL_FFT, "pair")
    rng = np.random.default_rng(9)
    m = rng.standard_normal((2, 3) + tg.shape).astype(np.float32)
    got = tgrf.map2harm(_t(m), tg)
    _close(got, jgrf.map2harm(jnp.asarray(m), jg), TOL_FFT, "map2harm")
    _close(tgrf.harm2map(got, tg), m, TOL_FFT, "roundtrip")


def test_polarized_rand_map_from_noise_matches_jax(geoms):
    """A (T, E, B) draw on the same white noise: covsqrt (the 3x3 matrix
    square root per l), the product and the rotation."""
    jg, tg = geoms
    jth, tth = jtheory.default_theory(), ttheory.default_theory()
    lmax = int(tg.lmax()) + 1
    ps_j = jgrf.cmb_ps(jth, lmax)
    ps_t = tgrf.cmb_ps(tth, lmax)
    np.testing.assert_array_equal(ps_t, ps_j)
    jm = jgrf.MapGen(jg, ps_j)
    tm = tgrf.MapGen(tg, ps_t, device="cpu")
    _close(tm.covsqrt, jm.covsqrt, 2e-5, "covsqrt")
    eta = _kmaps((2, 3) + tg.shape, 10)
    want_k = np.stack([np.asarray(jnp.einsum(
        "abyx,byx->ayx", jm.covsqrt.astype(jnp.float32), jnp.asarray(e)))
        for e in eta])
    _close(tm.get_map_from_noise(_t(eta), harm=True), want_k, 2e-5, "harm")
    want = np.stack([np.asarray(jgrf.harm2map(jnp.asarray(kk), jg))
                     for kk in want_k])
    _close(tm.get_map_from_noise(_t(eta)), want, 2e-5, "maps")
    out = tm.get_map(torch.Generator().manual_seed(0), batch=(2,))
    assert out.shape == (2, 3) + tg.shape and bool(torch.isfinite(out).all())


def test_cl2flat_and_white_noise_match_jax(geoms):
    jg, tg = geoms
    ells = np.arange(3000.0)
    cls = 1.0 / (1.0 + ells) ** 2
    _close(tgrf.cl2flat(tg, ells, cls, device="cpu"),
           jgrf.cl2flat(jg, ells, cls), 1e-6, "cl2flat")
    # white noise from the same normals: sigma = noise * arcmin / sqrt(pixel
    # solid angle), with the cos(dec) factor by default
    z = np.random.default_rng(11).standard_normal((3,) + tg.shape) \
        .astype(np.float32)
    got = tgrf.white_noise_from_noise(_t(z), tg, 6.0)
    sigma = (6.0 * jgeo.arcmin) / np.sqrt(np.asarray(
        jg.pixsizemap(jnp.float32)))
    _close(got, z * sigma, 1e-6, "white_noise")
    flat = tgrf.white_noise_from_noise(_t(z), tg, 6.0,
                                       ipsizemap=torch.tensor(tg.pixsize))
    _close(flat, z * (6.0 * jgeo.arcmin / np.sqrt(tg.pixsize)), 1e-6, "flat")
    drawn = tgrf.white_noise(tg, 6.0, torch.Generator().manual_seed(2),
                             shape=(64,) + tg.shape, device="cpu")
    assert drawn.shape == (64,) + tg.shape
    ratio = (drawn / _t(sigma)).double().std().item()
    assert abs(ratio - 1.0) < 0.02
