"""utils/healpix of the port against the JAX module.

The pixel functions are the same numpy code (``ang2pix`` / ``pix2ang`` on
the port's native library, with numpy's cosine and arccos), so their
outputs are equal exactly. The ring bridge runs the port's SHT at nside <= 32 and lmax <=
63: the host sampling is equal exactly, the transforms within 1e-10 of
max|ref| in float64 (the same Legendre sums in another order, ring FFTs
by another library).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orphics_tpu.utils import healpix as JH

from orphics_tpu_torch.ops import sht as tsht
from orphics_tpu_torch.utils import healpix as TH

torch.set_num_threads(1)

TOL64 = 1e-10


def _rel(got, ref):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("nside", [1, 4, 16])
def test_pixel_functions_equal(nside):
    rng = np.random.default_rng(nside)
    npix = 12 * nside * nside
    assert TH.nside2npix(nside) == JH.nside2npix(nside) == npix
    assert TH.npix2nside(npix) == nside
    assert TH.nside2pixarea(nside) == JH.nside2pixarea(nside)
    theta = np.arccos(rng.uniform(-1, 1, 500))
    phi = rng.uniform(0, 2 * np.pi, 500)
    np.testing.assert_array_equal(TH.ang2pix(nside, theta, phi),
                                  JH.ang2pix(nside, theta, phi))
    lon, lat = np.degrees(phi), 90 - np.degrees(theta)
    np.testing.assert_array_equal(TH.ang2pix(nside, lon, lat, lonlat=True),
                                  JH.ang2pix(nside, lon, lat, lonlat=True))
    pix = np.arange(npix)
    for a, b in zip(TH.pix2ang(nside, pix), JH.pix2ang(nside, pix)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(TH.pix2ang(nside, pix, lonlat=True),
                    JH.pix2ang(nside, pix, lonlat=True)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(TH.ring2nest(nside, pix),
                                  JH.ring2nest(nside, pix))
    np.testing.assert_array_equal(TH.nest2ring(nside, pix),
                                  JH.nest2ring(nside, pix))
    np.testing.assert_array_equal(TH.query_strip(nside, 0.5, 1.9),
                                  JH.query_strip(nside, 0.5, 1.9))
    hmap = rng.standard_normal((2, npix))
    for nout, power in ((2 * nside, None), (max(nside // 2, 1), -2)):
        np.testing.assert_array_equal(TH.ud_grade(hmap, nout, power),
                                      JH.ud_grade(hmap, nout, power))
    with pytest.raises(ValueError):
        TH.npix2nside(npix + 1)


def test_no_native_library():
    """The port builds its native library where g++ is installed, and its
    functions still equal the JAX package's numpy code (above)."""
    assert TH.have_native() is True
    assert set(TH.__all__) >= set(JH.__all__)


@pytest.mark.parametrize("nside,lmax", [(8, None), (32, 63)])
def test_ring_bridge(nside, lmax):
    rng = np.random.default_rng(nside)
    hmap = rng.standard_normal(12 * nside * nside)
    rj, ringsj, lj = JH.healpix_to_rings(hmap, lmax)
    rt, ringst, lt = TH.healpix_to_rings(torch.as_tensor(hmap), lmax)
    np.testing.assert_array_equal(rt, rj)
    assert lt == lj and ringst.shape == ringsj.shape
    np.testing.assert_array_equal(TH.rings_to_healpix(rt, ringst, nside),
                                  JH.rings_to_healpix(rj, ringsj, nside))
    alm_j = JH.map2alm(hmap, lmax)
    alm_t = TH.map2alm(hmap, lmax, device="cpu")
    assert alm_t.dtype == torch.complex128
    assert _rel(alm_t, alm_j) <= TOL64
    assert _rel(TH.map2alm(torch.as_tensor(hmap), lmax), alm_j) <= TOL64
    back_j = JH.alm2map(jnp.asarray(alm_j), nside)
    back_t = TH.alm2map(alm_t, nside)
    assert isinstance(back_t, np.ndarray)
    assert _rel(back_t, back_j) <= TOL64
    fwhm = np.deg2rad(3 * 60.0 / nside)
    assert _rel(TH.smoothing(hmap, fwhm, lmax, device="cpu"),
                JH.smoothing(hmap, fwhm, lmax)) <= TOL64


def test_bridge_rings():
    """The bridge samples onto the port's Gauss-Legendre rings, the same
    ones the JAX bridge uses."""
    _, rings, lmax = TH.healpix_to_rings(np.zeros(12 * 16 * 16))
    assert lmax == 32 and rings == tsht.gauss_legendre_rings(32)
