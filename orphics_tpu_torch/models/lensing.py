"""Flat-sky CMB lensing (port of ``orphics_tpu.models.lensing``, the
parts on the lensed-simulation path):

  * ``kappa_to_fphi/kappa_to_phi``: phi(l) = 2 kappa(l) / (l(l+1)), zeroed
    below l = 2;
  * ``alpha_from_kappa``: deflection = grad(phi) by i*l multiplication;
  * ``lens_map_spline``: periodic B-spline interpolation at displaced
    positions (no displacement cap; the kernel path with a cap is
    :func:`orphics_tpu_torch.ops.lens.lens_map_kernel`);
  * :class:`FlatLensingSims`: unlensed GRF + kappa GRF -> lens -> beam ->
    noise (scalar maps, spline lensing).

``taylens``, ``FixedLens`` and the NFW profiles are not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve
from ..geometry import Geometry, arcmin
from ..ops import fourier as F
from ..ops.lens import spline_coeffs, spline_taps
from . import grf as _grf

__all__ = ["fkappa_to_fphi", "kappa_to_fphi", "kappa_to_phi",
           "alpha_from_kappa", "lens_map_spline", "FlatLensingSims"]


def fkappa_to_fphi(fkappa, geom: Geometry):
    """phi(l) = 2 kappa(l) / (l(l+1)), zero for l < 2."""
    modlmap = geom.modlmap(torch.float32, fkappa.device)
    denom = modlmap * (modlmap + 1.0)
    zero = torch.zeros((), dtype=fkappa.dtype, device=fkappa.device)
    fphi = torch.where(denom > 0,
                       2.0 * fkappa / torch.where(denom > 0, denom, 1.0), zero)
    return torch.where(modlmap < 2.0, zero, fphi)


def kappa_to_fphi(kappa, geom: Geometry):
    return fkappa_to_fphi(F.fft2(kappa, geom, "phys"), geom)


def kappa_to_phi(kappa, geom: Geometry):
    """Convergence map -> lensing potential map."""
    return F.ifft2(kappa_to_fphi(kappa, geom), geom, "phys").real


def alpha_from_kappa(kappa, geom: Geometry):
    """Deflection field ``(..., 2, ny, nx)`` = grad(phi) from kappa maps."""
    fphi = kappa_to_fphi(kappa, geom)
    lmap = geom.lmap(torch.float32, kappa.device)
    ay = F.ifft2(1j * lmap[0] * fphi, geom, "phys").real
    ax = F.ifft2(1j * lmap[1] * fphi, geom, "phys").real
    return torch.stack([ay, ax], dim=-3)


def _eval_spline_coeffs(coeffs, alpha, geom: Geometry, order: int):
    """Evaluate prefiltered spline coefficients ``(..., ny, nx)`` at the
    positions displaced by ``alpha`` ``(2, ny, nx)`` (radians), uncapped."""
    py = alpha[0] / geom.dy
    px = alpha[1] / geom.dx
    iy = torch.arange(geom.ny, dtype=torch.float32, device=alpha.device)[:, None] + py
    ix = torch.arange(geom.nx, dtype=torch.float32, device=alpha.device)[None, :] + px
    yb = torch.floor(iy)
    xb = torch.floor(ix)
    return spline_taps(coeffs, yb.to(torch.long), xb.to(torch.long),
                       iy - yb, ix - xb, order)


def lens_map_spline(imap, alpha, geom: Geometry, order: int = 5):
    """Evaluate ``imap`` (leading component axes allowed) at positions
    displaced by ``alpha`` (radians, ``(2, ny, nx)``), periodic, with
    B-spline interpolation of ``order`` 3 or 5."""
    if order not in (3, 5):
        raise ValueError("order must be 3 or 5")
    return _eval_spline_coeffs(spline_coeffs(imap, geom, order), alpha, geom,
                               order)


class FlatLensingSims:
    """Lensed CMB temperature simulations: unlensed GRF, GRF kappa, spline
    lensing, Gaussian beam, white noise.

    >>> fls = FlatLensingSims(geom, theory, 1.4, 7.0, device="cuda")
    >>> obs = fls.get_sim(generator)
    """

    def __init__(self, geom: Geometry, theory, beam_arcmin, noise_uk_arcmin,
                 pol: bool = False, lens_order: int = 5,
                 lens_method: str = "spline", dtype=torch.float32,
                 device=None):
        if pol:
            raise NotImplementedError("polarized sims are not ported yet")
        if lens_method != "spline":
            raise NotImplementedError(f"lens_method={lens_method!r} is not "
                                      "ported yet (spline only)")
        self.geom = geom
        self.lens_order = lens_order
        device = resolve(device)
        lmax = int(geom.lmax()) + 1
        ells = np.arange(lmax)
        ps_cmb = np.asarray(theory.uCl("TT", ells))[None, None]
        self.mgen = _grf.MapGen(geom, ps_cmb, dtype=dtype, device=device)
        ps_kk = np.asarray(theory.gCl("kk", ells))[None, None]
        self.kgen = _grf.MapGen(geom, ps_kk, dtype=dtype, device=device)
        self.kbeam = F.gauss_beam(geom.modlmap(dtype, device), beam_arcmin)
        ps_noise = np.full((1, 1, lmax), (noise_uk_arcmin * arcmin) ** 2)
        self.ngen = _grf.MapGen(geom, ps_noise, dtype=dtype, device=device)

    def lens(self, unlensed, kappa):
        alpha = alpha_from_kappa(kappa, self.geom)
        return lens_map_spline(unlensed, alpha, self.geom,
                               order=self.lens_order)

    def get_sim_from_noise(self, eta_c, eta_k, eta_n,
                           return_intermediate: bool = False):
        """Observed map from the three complex white-noise planes (CMB,
        kappa, instrument noise), each ``(1, ny, nx)``."""
        unlensed = self.mgen.get_map_from_noise(eta_c)
        kappa = self.kgen.get_map_from_noise(eta_k)
        lensed = self.lens(unlensed, kappa)
        beamed = F.kfilter(lensed, self.kbeam, self.geom)
        noise = self.ngen.get_map_from_noise(eta_n)
        observed = beamed + noise
        if return_intermediate:
            return observed, dict(unlensed=unlensed, kappa=kappa,
                                  lensed=lensed, beamed=beamed, noise=noise)
        return observed

    def draw_noise(self, generator: torch.Generator):
        """The three white-noise planes :meth:`get_sim_from_noise` takes."""
        cov = self.mgen.covsqrt
        return tuple(_grf.rand_kmap(self.geom, generator, 1, dtype=cov.dtype,
                                    device=cov.device) for _ in range(3))

    def get_sim(self, generator: torch.Generator,
                return_intermediate: bool = False):
        return self.get_sim_from_noise(*self.draw_noise(generator),
                                       return_intermediate=return_intermediate)
