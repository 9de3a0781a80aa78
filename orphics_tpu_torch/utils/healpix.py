"""HEALPix RING pixelization without healpy (port of
``orphics_tpu.utils.healpix``).

The pixel functions are the JAX package's vectorized numpy
implementation, copied: ``ang2pix``, ``pix2ang``, ``nside2npix``,
``npix2nside``, ``nside2pixarea``, ``query_strip``, ``ring2nest``,
``nest2ring``, ``ud_grade``. ``ang2pix`` / ``pix2ang`` run the native C++
library ``csrc/healpix.cpp`` (OpenMP), built with ``g++`` at first use
(:func:`orphics_tpu_torch._build.healpix_library`) and loaded with
ctypes, as the JAX package loads its own build; :func:`have_native` says
whether it built, and where it did not the numpy code runs. The cosine
and arccos are numpy's on both paths (numpy's SIMD float64 ``arccos``
differs from libm's ``acos`` by an ulp on ~10 % of pixels), so the two
give the same pixels and angles exactly (``tests/test_torch_packages.py``).

The harmonic bridge (``map2alm``, ``alm2map``, ``smoothing``) samples the
healpix grid onto Gauss-Legendre rings on the host, as the JAX package
does, and transforms on the port's ``ops/sht`` (kernels B10a / B10s on
the card).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from .._device import resolve

__all__ = ["nside2npix", "npix2nside", "nside2pixarea", "ang2pix",
           "pix2ang", "query_strip", "have_native"]


def _f64(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _i64(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def have_native() -> bool:
    """True where the native library built (the first call builds it)."""
    return _build.healpix_library() is not None


def nside2npix(nside: int) -> int:
    return 12 * nside * nside


def npix2nside(npix: int) -> int:
    nside = int(np.sqrt(npix / 12))
    if nside2npix(nside) != npix:
        raise ValueError("invalid npix")
    return nside


def nside2pixarea(nside: int) -> float:
    return 4 * np.pi / nside2npix(nside)


def _ang2pix_np(nside, theta, phi):
    """Vectorized RING ang2pix (HEALPix primer algorithm)."""
    z = np.cos(theta)
    za = np.abs(z)
    tt = np.mod(phi / (0.5 * np.pi), 4.0)
    npix = nside2npix(nside)
    pix = np.empty(z.shape, dtype=np.int64)

    eq = za <= 2.0 / 3.0
    # equatorial belt
    temp1 = nside * (0.5 + tt[eq])
    temp2 = nside * z[eq] * 0.75
    jp = np.floor(temp1 - temp2).astype(np.int64)
    jm = np.floor(temp1 + temp2).astype(np.int64)
    ir = nside + 1 + jp - jm
    kshift = 1 - (ir & 1)
    nl4 = 4 * nside
    ip = np.floor((jp + jm - nside + kshift + 1) / 2.0).astype(np.int64) % nl4
    pix[eq] = 2 * nside * (nside - 1) + (ir - 1) * nl4 + ip
    # polar caps
    po = ~eq
    tp = tt[po] - np.floor(tt[po])
    tmp = nside * np.sqrt(3.0 * (1.0 - za[po]))
    jp = np.floor(tp * tmp).astype(np.int64)
    jm = np.floor((1.0 - tp) * tmp).astype(np.int64)
    ir = jp + jm + 1
    ipp = np.floor(tt[po] * ir).astype(np.int64) % (4 * ir)
    north = z[po] > 0
    pp = np.where(north, 2 * ir * (ir - 1) + ipp,
                  npix - 2 * ir * (ir + 1) + ipp)
    pix[po] = pp
    return pix


def _pix2ang_np(nside, pix):
    pix = np.asarray(pix, dtype=np.int64)
    npix = nside2npix(nside)
    ncap = 2 * nside * (nside - 1)
    z = np.empty(pix.shape)
    phi = np.empty(pix.shape)

    north = pix < ncap
    p = pix[north]
    iring = ((1 + np.sqrt(1.0 + 2.0 * p)) * 0.5).astype(np.int64)
    iring = np.where(2 * iring * (iring - 1) > p, iring - 1, iring)
    iring = np.where(2 * iring * (iring + 1) <= p, iring + 1, iring)
    iphi = p - 2 * iring * (iring - 1) + 1
    z[north] = 1.0 - iring.astype(float) ** 2 / (3.0 * nside ** 2)
    phi[north] = (iphi - 0.5) * np.pi / (2.0 * iring)

    eq = (pix >= ncap) & (pix < npix - ncap)
    ip = pix[eq] - ncap
    nl4 = 4 * nside
    iring = ip // nl4 + nside
    iphi = ip % nl4 + 1
    fodd = np.where((iring + nside) & 1, 1.0, 0.5)
    z[eq] = (2.0 * nside - iring) * 2.0 / (3.0 * nside)
    phi[eq] = (iphi - fodd) * np.pi / (2.0 * nside)

    south = pix >= npix - ncap
    ip = npix - pix[south]
    iring = ((1 + np.sqrt(2.0 * ip - 1.0)) * 0.5).astype(np.int64)
    iring = np.where(2 * iring * (iring - 1) >= ip, iring - 1, iring)
    iring = np.where(2 * iring * (iring + 1) < ip, iring + 1, iring)
    iphi = 4 * iring + 1 - (ip - 2 * iring * (iring - 1))
    z[south] = -1.0 + iring.astype(float) ** 2 / (3.0 * nside ** 2)
    phi[south] = (iphi - 0.5) * np.pi / (2.0 * iring)
    return np.arccos(np.clip(z, -1, 1)), np.mod(phi, 2 * np.pi)


def ang2pix(nside, theta, phi, lonlat: bool = False):
    """healpy-compatible RING ang2pix."""
    theta = np.ascontiguousarray(np.atleast_1d(theta), dtype=np.float64)
    phi = np.ascontiguousarray(np.atleast_1d(phi), dtype=np.float64)
    if lonlat:
        lon, lat = theta, phi
        theta = np.radians(90.0 - lat)
        phi = np.radians(lon)
        theta = np.ascontiguousarray(theta)
        phi = np.ascontiguousarray(phi)
    lib = _build.healpix_library()
    if lib is not None:
        # the cosine here, as the numpy code takes it
        z = np.cos(theta)
        out = np.empty(theta.shape, dtype=np.int64)
        lib.ang2pix_ring_z(int(nside), _f64(z), _f64(phi), _i64(out),
                           theta.size)
        return out
    return _ang2pix_np(int(nside), theta, phi)


def pix2ang(nside, pix, lonlat: bool = False):
    """healpy-compatible RING pix2ang (pixel centers)."""
    pix = np.ascontiguousarray(np.atleast_1d(pix), dtype=np.int64)
    lib = _build.healpix_library()
    if lib is not None:
        z = np.empty(pix.shape, dtype=np.float64)
        phi = np.empty(pix.shape, dtype=np.float64)
        lib.pix2z_ring(int(nside), _i64(pix), _f64(z), _f64(phi), pix.size)
        # the arccos here, as the numpy code takes it
        theta = np.arccos(np.clip(z, -1, 1))
    else:
        theta, phi = _pix2ang_np(int(nside), pix)
    if lonlat:
        return np.degrees(phi), 90.0 - np.degrees(theta)
    return theta, phi


def query_strip(nside, theta1, theta2):
    """Pixels whose centers fall in the colatitude strip [theta1, theta2]
    (healpy ``query_strip``, used by reference ``galactic_mask``,
    ``orphics/maps.py:1186``)."""
    pix = np.arange(nside2npix(nside), dtype=np.int64)
    theta, _ = pix2ang(nside, pix)
    return pix[(theta >= theta1) & (theta <= theta2)]


# ---------------------------------------------------------------------
# RING <-> NEST and ud_grade (healpy surface used by reference masks)
# ---------------------------------------------------------------------

_JRLL = np.array([2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4])
_JPLL = np.array([1, 3, 5, 7, 0, 2, 4, 6, 1, 3, 5, 7])


def _isqrt(v):
    return np.floor(np.sqrt(v.astype(np.float64) + 0.5)).astype(np.int64)


def _ring2xyf(nside, pix):
    pix = np.asarray(pix, np.int64)
    npix = 12 * nside * nside
    ncap = 2 * nside * (nside - 1)
    iring = np.empty_like(pix)
    iphi = np.empty_like(pix)
    kshift = np.zeros_like(pix)
    face = np.empty_like(pix)
    nr = np.empty_like(pix)

    north = pix < ncap
    eq = (~north) & (pix < npix - ncap)
    south = pix >= npix - ncap

    if np.any(north):
        p = pix[north]
        ir = (1 + _isqrt(1 + 2 * p)) >> 1
        ip = p + 1 - 2 * ir * (ir - 1)
        iring[north] = ir
        iphi[north] = ip
        nr[north] = ir
        face[north] = (ip - 1) // ir
    if np.any(eq):
        p = pix[eq] - ncap
        ir = p // (4 * nside) + nside
        ip = p % (4 * nside) + 1
        iring[eq] = ir
        iphi[eq] = ip
        kshift[eq] = (ir + nside) & 1
        nr[eq] = nside
        ire = ir - nside + 1
        irm = 2 * nside + 2 - ire
        ifm = (ip - ire // 2 + nside - 1) // nside
        ifp = (ip - irm // 2 + nside - 1) // nside
        f = np.where(ifp == ifm, ifp | 4,
                     np.where(ifp < ifm, ifp, ifm + 8))
        face[eq] = f
    if np.any(south):
        p = npix - pix[south]
        ir = (1 + _isqrt(2 * p - 1)) >> 1
        ip = 4 * ir + 1 - (p - 2 * ir * (ir - 1))
        iphi[south] = ip
        nr[south] = ir
        face[south] = (ip - 1) // ir + 8
        iring[south] = 4 * nside - ir

    irt = iring - _JRLL[face] * nside + 1
    ipt = 2 * iphi - _JPLL[face] * nr - kshift - 1
    ipt = np.where(ipt >= 2 * nside, ipt - 8 * nside, ipt)
    ix = (ipt - irt) >> 1
    iy = (-(ipt + irt)) >> 1
    return ix, iy, face


def _xyf2ring(nside, ix, iy, face):
    nl4 = 4 * nside
    npix = 12 * nside * nside
    ncap = 2 * nside * (nside - 1)
    jr = _JRLL[face] * nside - ix - iy - 1
    north = jr < nside
    south = jr > 3 * nside
    eq = ~(north | south)
    nr = np.where(north, jr, np.where(south, nl4 - jr, nside))
    n_before = np.where(
        north, 2 * nr * (nr - 1),
        np.where(south, npix - 2 * nr * (nr + 1),
                 ncap + (jr - nside) * nl4))
    kshift = np.where(eq, (jr - nside) & 1, 0)
    jp = (_JPLL[face] * nr + ix - iy + 1 + kshift) // 2
    jp = np.where(jp > nl4, jp - nl4, np.where(jp < 1, jp + nl4, jp))
    return n_before + jp - 1


def _interleave(v):
    """Spread the low 29 bits of v into even positions."""
    v = np.asarray(v, np.uint64)
    v &= np.uint64(0x1FFFFFFF)
    v = (v | (v << np.uint64(16))) & np.uint64(0x0000FFFF0000FFFF)
    v = (v | (v << np.uint64(8))) & np.uint64(0x00FF00FF00FF00FF)
    v = (v | (v << np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    v = (v | (v << np.uint64(2))) & np.uint64(0x3333333333333333)
    v = (v | (v << np.uint64(1))) & np.uint64(0x5555555555555555)
    return v


def _deinterleave(v):
    v = np.asarray(v, np.uint64) & np.uint64(0x5555555555555555)
    v = (v | (v >> np.uint64(1))) & np.uint64(0x3333333333333333)
    v = (v | (v >> np.uint64(2))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    v = (v | (v >> np.uint64(4))) & np.uint64(0x00FF00FF00FF00FF)
    v = (v | (v >> np.uint64(8))) & np.uint64(0x0000FFFF0000FFFF)
    v = (v | (v >> np.uint64(16))) & np.uint64(0x00000000FFFFFFFF)
    return v


def ring2nest(nside, pix):
    """RING -> NEST pixel indices (healpy ``ring2nest``)."""
    ix, iy, face = _ring2xyf(nside, pix)
    return (face.astype(np.int64) * nside * nside
            + (_interleave(ix) | (_interleave(iy) << np.uint64(1)))
            .astype(np.int64))


def nest2ring(nside, pix):
    """NEST -> RING pixel indices (healpy ``nest2ring``)."""
    pix = np.asarray(pix, np.int64)
    face = pix // (nside * nside)
    rem = (pix % (nside * nside)).astype(np.uint64)
    ix = _deinterleave(rem).astype(np.int64)
    iy = _deinterleave(rem >> np.uint64(1)).astype(np.int64)
    return _xyf2ring(nside, ix, iy, face)


def ud_grade(hmap, nside_out, power=None):
    """Up/downgrade a RING map (healpy ``ud_grade``): children are
    averaged on degrade, replicated on upgrade. ``power=-2`` rescales
    like a count/ivar map (sum-preserving)."""
    hmap = np.asarray(hmap, np.float64)
    nside_in = npix2nside(hmap.shape[-1])
    if nside_out == nside_in:
        return hmap.copy()
    nest_in = hmap[..., nest2ring(nside_in, np.arange(hmap.shape[-1]))]
    if nside_out < nside_in:
        rat = (nside_in // nside_out) ** 2
        nest_out = nest_in.reshape(hmap.shape[:-1]
                                   + (12 * nside_out ** 2, rat)).mean(-1)
    else:
        rat = (nside_out // nside_in) ** 2
        nest_out = np.repeat(nest_in, rat, axis=-1)
    if power is not None:
        nest_out = nest_out * (float(nside_in) / nside_out) ** (-power)
    npo = 12 * nside_out ** 2
    out = np.empty(hmap.shape[:-1] + (npo,), hmap.dtype)
    out[..., _xyf2ring_of_nest(nside_out)] = nest_out
    return out


def _xyf2ring_of_nest(nside):
    """ring index of each nest-ordered pixel (cache-free helper)."""
    return nest2ring(nside, np.arange(12 * nside * nside))


__all__ += ["ring2nest", "nest2ring", "ud_grade"]


# ---------------------------------------------------------------------------
# Harmonic operations on healpix RING maps via the ring SHT (the
# hp.smoothing / map2alm surface used by the reference for masks, e.g.
# orphics/maps.py:1186ff). The healpix grid is bridged to the iso-latitude
# Gauss-Legendre grid by nearest-neighbour sampling on the host (the same
# order-0 fidelity the reference uses for healpix mask work), so these are
# mask/template-grade transforms, not exact healpix SHTs.
# ---------------------------------------------------------------------------

def _rings_for_nside(nside, lmax=None):
    from ..ops import sht
    if lmax is None:
        lmax = 2 * nside
    return sht.gauss_legendre_rings(int(lmax)), int(lmax)


def _host(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def healpix_to_rings(hmap, lmax=None):
    """Sample a RING healpix map onto the Gauss-Legendre ring grid
    (nearest neighbour, host numpy). Returns (ring_map, rings, lmax)."""
    hmap = _host(hmap)
    nside = npix2nside(hmap.size)
    rings, lmax = _rings_for_nside(nside, lmax)
    theta = rings.theta_array()
    phi = np.arange(rings.nphi) * (2 * np.pi / rings.nphi) + rings.phi0
    tt = np.repeat(theta, rings.nphi)
    pp = np.tile(phi, rings.ntheta)
    pix = ang2pix(nside, tt, pp)
    return hmap[pix].reshape(rings.ntheta, rings.nphi), rings, lmax


def rings_to_healpix(ring_map, rings, nside):
    """Sample a ring-grid map back at healpix RING pixel centers
    (bilinear in theta, nearest in phi; host numpy)."""
    ring_map = _host(ring_map)
    theta = rings.theta_array()
    npix = nside2npix(nside)
    tt, pp = pix2ang(nside, np.arange(npix))
    it = np.clip(np.searchsorted(theta, tt) - 1, 0, rings.ntheta - 2)
    w = np.clip((tt - theta[it]) / (theta[it + 1] - theta[it]), 0, 1)
    ip = np.rint((pp - rings.phi0) / (2 * np.pi / rings.nphi)
                 ).astype(np.int64) % rings.nphi
    return (ring_map[it, ip] * (1 - w) + ring_map[it + 1, ip] * w)


def map2alm(hmap, lmax=None, device=None):
    """healpy-packed alm of a RING healpix map (the ring bridge, then the
    port's SHT on ``hmap``'s device, or ``device`` for a host map; the
    map's float dtype is kept)."""
    from ..ops import sht
    dev = hmap.device if torch.is_tensor(hmap) else resolve(device)
    ring_map, rings, lmax = healpix_to_rings(hmap, lmax)
    return sht.map2alm(torch.as_tensor(ring_map, device=dev), rings, lmax)


def alm2map(alm, nside, lmax=None):
    """RING healpix map (host numpy) from healpy-packed alm: the port's SHT
    on the alm's device, then the bridge."""
    from ..ops import sht
    from ..ops import alm as almops
    alm = torch.as_tensor(alm)
    if lmax is None:
        lmax = almops.getlmax(alm.shape[-1])
    rings = sht.gauss_legendre_rings(int(lmax))
    return rings_to_healpix(sht.alm2map(alm, rings, int(lmax)), rings, nside)


def smoothing(hmap, fwhm_rad, lmax=None, device=None):
    """Gaussian-beam smoothing of a RING healpix map (the ``hp.smoothing``
    role): map2alm -> b_l -> alm2map through the ring bridge; returns a
    host numpy map."""
    from ..ops import alm as almops
    nside = npix2nside(_host(hmap).size)
    alm = map2alm(hmap, lmax, device)
    lmax_eff = almops.getlmax(alm.shape[-1])
    ells = np.arange(lmax_eff + 1)
    sigma = fwhm_rad / np.sqrt(8.0 * np.log(2.0))
    bl = np.exp(-0.5 * ells * (ells + 1.0) * sigma ** 2)
    return alm2map(almops.almxfl(alm, bl), nside, lmax_eff)


__all__ += ["healpix_to_rings", "rings_to_healpix", "map2alm", "alm2map",
            "smoothing"]
