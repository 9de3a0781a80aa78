"""Instrument noise models: white, atmospheric (red), inverse-variance (port
of ``orphics_tpu.models.noise``).

Reference: ``orphics/maps.py`` ``atm_factor`` (:1137), ``rednoise``
(:1142), ``modulated_noise_map`` (:1152), ``rms_from_ivar`` (:1204),
``ivar`` (:1240), ``white_noise`` (:1246), ``get_masked_ivar`` (:80);
``orphics/cosmology.py`` ``noise_func`` (:1143), ``getAtmosphere``
(:1173). Draws take a ``torch.Generator``; tensors follow their inputs,
and what is made from nothing goes to ``device`` (the card unless it
names another).
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve
from ..geometry import Geometry, arcmin
from ..ops import fourier as F

__all__ = ["atm_factor", "rednoise", "ivar", "rms_from_ivar", "white_noise",
           "white_noise_with_atm_func", "modulated_noise_map",
           "get_masked_ivar", "noise_func", "get_atmosphere",
           "getAtmosphere"]


def _ells(ells, device):
    """``ells`` as a tensor: a tensor keeps its dtype and device, anything
    else becomes float64 on ``device`` (the card unless it names
    another)."""
    if torch.is_tensor(ells):
        return ells if ells.is_floating_point() else ells.double()
    return torch.as_tensor(np.asarray(ells, np.float64),
                           device=resolve(device))


def atm_factor(ells, lknee, alpha, device=None):
    """``(lknee / l)^(-alpha)`` atmospheric factor, 0 at l = 0 (reference
    ``maps.py:1137``). A tensor ``ells`` keeps its device; other ells go
    to ``device``."""
    ells = _ells(ells, device)
    if lknee > 1e-3:
        inv = torch.where(ells > 0, 1.0 / torch.where(ells == 0, 1.0, ells),
                          0.0)
        return (lknee * inv) ** (-alpha)
    return torch.zeros_like(ells)


def rednoise(ells, rms_noise, lknee=0.0, alpha=1.0, device=None):
    """``[(lknee/l)^(-alpha) + 1] (rms in rad)^2`` (reference
    ``maps.py:1142``); ``device`` as in :func:`atm_factor`."""
    return (atm_factor(ells, lknee, alpha, device) + 1.0) \
        * (rms_noise * arcmin) ** 2


def noise_func(ell, fwhm, rms_noise, lknee=0.0, alpha=0.0,
               dimensionless=False, TCMB=2.7255e6, device=None):
    """Beam-deconvolved noise power (reference ``cosmology.py:1143``);
    ``device`` as in :func:`atm_factor`."""
    ell = _ells(ell, device)
    out = (atm_factor(ell, lknee, alpha) + 1.0) * (rms_noise * arcmin) ** 2 \
        / F.gauss_beam(ell, fwhm) ** 2
    return out / TCMB ** 2 if dimensionless else out


def get_atmosphere(beam_fwhm_arcmin):
    """(lknee_T, alpha_T, lknee_P, alpha_P) vs beam FWHM: the Hasselfield
    best-fit atmosphere at 150 GHz for 0.5/5/7-m apertures, linear in the
    diffraction beam 1.22 lambda / D with linear extrapolation (reference
    ``cosmology.py:1173``)."""
    tt_alpha = -4.7
    tt_lknee = np.array([350.0, 3400.0, 4900.0])
    pp_lknee = np.array([60.0, 330.0, 460.0])
    pp_alpha = np.array([-2.6, -3.8, -3.9])
    size_m = np.array([0.5, 5.0, 7.0])
    wavelength = 299792458.0 / 150.0e9
    resin = 1.22 * wavelength / size_m * 60.0 * 180.0 / np.pi  # arcmin
    order = np.argsort(resin)
    b = np.asarray(beam_fwhm_arcmin, dtype=float)

    def interp_extrap(ys):
        xs = resin[order]
        yy = ys[order]
        out = np.interp(b, xs, yy)
        out = np.where(b < xs[0], yy[0] + (b - xs[0]) * (yy[1] - yy[0])
                       / (xs[1] - xs[0]), out)
        out = np.where(b > xs[-1], yy[-1] + (b - xs[-1]) * (yy[-1] - yy[-2])
                       / (xs[-1] - xs[-2]), out)
        return float(out) if np.ndim(beam_fwhm_arcmin) == 0 else out

    tt_a = (tt_alpha if np.ndim(beam_fwhm_arcmin) == 0
            else np.full(np.shape(beam_fwhm_arcmin), tt_alpha))
    return (interp_extrap(tt_lknee), tt_a, interp_extrap(pp_lknee),
            interp_extrap(pp_alpha))


def getAtmosphere(beamFWHMArcmin=None, returnFunctions=False):
    """Reference-signature alias of :func:`get_atmosphere`; with
    ``returnFunctions=True`` the four callables of the beam."""
    if beamFWHMArcmin is None and not returnFunctions:
        raise ValueError("need a beam FWHM or returnFunctions=True")
    if not returnFunctions:
        return get_atmosphere(beamFWHMArcmin)
    return tuple((lambda b, i=i: get_atmosphere(b)[i]) for i in range(4))


def ivar(geom: Geometry, noise_muK_arcmin, ipsizemap=None, device=None):
    """Inverse-variance map for a white noise level (reference
    ``maps.py:1240``)."""
    if ipsizemap is None:
        ipsizemap = geom.pixsizemap(device=device)
    return ipsizemap * (180.0 * 60.0 / np.pi) ** 2 / noise_muK_arcmin ** 2


def rms_from_ivar(ivar_map, parea=None, geom: Geometry = None):
    """Per-pixel rms (uK-arcmin) from an ivar map (reference
    ``maps.py:1204``)."""
    ivar_map = torch.as_tensor(ivar_map)
    if parea is None:
        parea = geom.pixsizemap(ivar_map.dtype, ivar_map.device)
    var = torch.where(ivar_map > 0, 1.0 / torch.where(ivar_map <= 0, 1.0,
                                                       ivar_map), 0.0)
    return torch.sqrt(var * parea) * 180.0 * 60.0 / np.pi


def white_noise(generator: torch.Generator, geom: Geometry = None,
                noise_muK_arcmin=None, div=None, shape=None,
                dtype=torch.float32, device=None):
    """Non-band-limited white noise map (reference ``maps.py:1246``): unit
    normals drawn with ``generator`` over ``sqrt(div)``."""
    if div is None:
        div = ivar(geom, noise_muK_arcmin, device=device)
    shape = tuple(shape) if shape is not None else tuple(div.shape)
    z = torch.randn(shape, generator=generator, dtype=dtype,
                    device=div.device)
    return z / torch.sqrt(div).to(dtype)


def modulated_noise_map(generator: torch.Generator, ivar_map, geom: Geometry,
                        lknee=None, alpha=None, lmax=None,
                        n_ell_standard=None, lmin=None, dtype=torch.float32):
    """Noise with spatial modulation from ``ivar_map`` and an l-shape from
    a whitened N_ell (reference ``maps.py:1152``), flat sky: a GRF with
    spectrum ``n_ell_standard`` (-> 1) times the per-pixel rms, on
    ``ivar_map``'s device."""
    ivar_map = torch.as_tensor(ivar_map)
    if n_ell_standard is None and lknee is not None:
        ells = np.arange((lmax or int(geom.lmax())) + 1)
        nl = np.nan_to_num(atm_factor(ells, lknee, alpha, "cpu").numpy()) \
            + 1.0
        if lmin is not None:
            nl[ells < lmin] = 0
        n_ell_standard = nl
    if n_ell_standard is None:
        z = torch.randn(geom.shape, generator=generator, dtype=dtype,
                        device=ivar_map.device)
        return z / torch.sqrt(ivar_map)
    from .grf import MapGen
    mgen = MapGen(geom, np.asarray(n_ell_standard)[None, None], dtype=dtype,
                  device=ivar_map.device)
    smap = mgen.get_map(generator)
    rms = rms_from_ivar(ivar_map, geom=geom)
    return rms * smap * np.pi / 180.0 / 60.0


def get_masked_ivar(ivar_map, geom: Geometry, grow_arcmin=10.0,
                    threshold=1e-10):
    """Zero ivar within ``grow_arcmin`` of empty regions (reference
    ``maps.py:80``); follows the device of ``ivar_map``."""
    from ..ops.distance import grow_mask
    mask = (ivar_map > threshold).to(torch.float32)
    g = grow_mask(mask, geom, grow_arcmin * arcmin)
    return torch.where(g > 0, ivar_map,
                       torch.zeros((), dtype=ivar_map.dtype,
                                   device=ivar_map.device))


def white_noise_with_atm_func(ells, uk_arcmin, lknee, alpha,
                              dimensionless=False, TCMB=2.7255e6,
                              device=None):
    """White noise power with a 1/f atmosphere factor (reference
    ``cosmology.py:1164``); ``device`` as in :func:`atm_factor`."""
    noise_white = (uk_arcmin * np.pi / (180.0 * 60.0)) ** 2
    dfact = (1.0 / TCMB ** 2) if dimensionless else 1.0
    return (atm_factor(ells, lknee, alpha, device) + 1.0) * noise_white \
        * dfact
