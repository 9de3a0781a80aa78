"""Flat-sky CMB lensing (port of ``orphics_tpu.models.lensing``):

  * ``kappa_to_fphi/kappa_to_phi``: phi(l) = 2 kappa(l) / (l(l+1)), zeroed
    below l = 2;
  * ``alpha_from_kappa``: deflection = grad(phi) by i*l multiplication;
    ``gradient``: the same calculus for any map;
  * ``lens_map_spline``: periodic B-spline interpolation at displaced
    positions;
  * ``taylens``: integer-pixel shift + Taylor expansion of the sub-pixel
    remainder (Naess & Louis 2013);
  * :class:`FlatLensingSims`: unlensed GRF (+pol) + kappa GRF -> lens ->
    beam -> noise; :class:`FixedLens`: unlensed GRF displaced by a fixed
    deflection. They and ``lens_map_spline`` displace through
    :func:`orphics_tpu_torch.ops.lens.lens_map_kernel` (kernel B8 for CUDA
    tensors, its plain version for CPU tensors) with a cap of one whole
    grid, which on a periodic map never binds;
  * NFW kappa profiles as tensor math (a tensor argument keeps its device;
    host numbers and arrays go to ``device``, the card by default), and the
    small host utilities.
"""
from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from .._device import resolve
from ..geometry import Geometry, arcmin
from ..ops import fourier as F
from ..ops.lens import lens_map_kernel, spline_coeffs
from . import grf as _grf

__all__ = ["fkappa_to_fphi", "kappa_to_fphi", "kappa_to_phi",
           "alpha_from_kappa", "gradient", "lens_map_spline", "taylens",
           "FixedLens", "FlatLensingSims",
           "gnfw", "f_c", "fnfw", "rho_nfw", "proj_rho_nfw", "projected_rho",
           "kappa_nfw_generic", "kappa_generic", "nfw_kappa_profile",
           "sanitize_power", "fill_low_ell", "validate_geometry"]


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


def gradient(x, geom: Geometry):
    """``(2, ny, nx)`` gradient of a map via Fourier i*l multiplication."""
    k = F.fft2(x, geom, "raw")
    lmap = geom.lmap(torch.float32, x.device)
    gy = F.ifft2(1j * lmap[0] * k, geom, "raw").real
    gx = F.ifft2(1j * lmap[1] * k, geom, "raw").real
    return torch.stack([gy, gx])


def alpha_from_kappa(kappa, geom: Geometry):
    """Deflection field ``(..., 2, ny, nx)`` = grad(phi) from kappa maps."""
    fphi = kappa_to_fphi(kappa, geom)
    lmap = geom.lmap(torch.float32, kappa.device)
    ay = F.ifft2(1j * lmap[0] * fphi, geom, "phys").real
    ax = F.ifft2(1j * lmap[1] * fphi, geom, "phys").real
    return torch.stack([ay, ax], dim=-3)


def _displace(imap, alpha, geom: Geometry, order: int):
    """``imap`` (``lead + ([ncomp,] ny, nx)``) displaced by ``alpha``
    (``lead + (2, ny, nx)``) through :func:`lens_map_kernel`: kernel B8 for
    CUDA tensors, its plain version for CPU tensors. The displacement cap
    is one whole grid, which on the periodic map never binds."""
    a4 = alpha.reshape((-1, 2) + geom.shape)
    m4 = imap.reshape((a4.shape[0], -1) + geom.shape)
    coeffs = spline_coeffs(m4, geom, order).contiguous()
    out = lens_map_kernel(coeffs, a4.contiguous(), geom, order,
                          maxdisp_px=max(geom.shape), prefiltered=True)
    return out.reshape(imap.shape)


def lens_map_spline(imap, alpha, geom: Geometry, order: int = 5):
    """Evaluate ``imap`` (float32; leading component axes allowed) at
    positions displaced by ``alpha`` (radians, ``(2, ny, nx)``), periodic,
    with B-spline interpolation of ``order`` 3 or 5."""
    if order not in (3, 5):
        raise ValueError("order must be 3 or 5")
    return _displace(imap, alpha, geom, order)


def taylens(imap, alpha, geom: Geometry, order: int = 5):
    """Lens via integer-pixel displacement + Taylor series of the sub-pixel
    remainder (Naess & Louis 2013): one nearest-pixel gather per derivative
    field, all derivative algebra on the Fourier plane. ``imap`` may carry
    leading component axes; ``alpha`` is ``(2, ny, nx)`` radians."""
    py = alpha[0] / geom.dy
    px = alpha[1] / geom.dx
    ay0 = torch.round(py)
    ax0 = torch.round(px)
    dy = (py - ay0) * geom.dy
    dx = (px - ax0) * geom.dx
    dev = alpha.device
    iy = torch.arange(geom.ny, dtype=torch.float32, device=dev)[:, None] + ay0
    ix = torch.arange(geom.nx, dtype=torch.float32, device=dev)[None, :] + ax0
    idx = (torch.remainder(iy.to(torch.long), geom.ny) * geom.nx
           + torch.remainder(ix.to(torch.long), geom.nx)).reshape(-1)

    kmap = F.fft2(imap, geom, "phys")
    lmap = geom.lmap(torch.float32, dev)
    ly, lx = lmap[0], lmap[1]
    fields = [imap]
    monomials = [torch.ones_like(dx)]
    for n in range(1, order):
        fac0 = 1.0 / math.factorial(n)
        for k in range(n + 1):
            fields.append(F.ifft2((1j ** n) * (lx ** (n - k)) * (ly ** k)
                                  * kmap, geom, "phys").real)
            monomials.append((dx ** (n - k)) * (dy ** k)
                             * (fac0 * math.comb(n, k)))
    stack = torch.stack(fields)
    vals = stack.reshape(stack.shape[0], -1, geom.npix) \
        .index_select(-1, idx).reshape(stack.shape)
    out = torch.zeros_like(imap)
    for v, mono in zip(vals, monomials):
        out = out + v * mono
    return out


def _cmb_ps(theory, lmax: int, pol: bool):
    """Unlensed ``(ncomp, ncomp, lmax)`` CMB power matrix (T, or T, E, B)
    over ``arange(lmax)``."""
    ps = _grf.cmb_ps(theory, lmax - 1, lensed=False)
    return ps if pol else ps[:1, :1]


class FixedLens:
    """Lensed sims with a *fixed* deflection profile (e.g. a cluster halo):
    unlensed GRF -> displace by the fixed alpha."""

    def __init__(self, geom: Geometry, theory, kappa_fixed,
                 lens_order: int = 5, pol: bool = False, dtype=torch.float32,
                 device=None):
        self.geom = geom
        self.lens_order = lens_order
        self.dtype = dtype
        self.device = resolve(device)
        lmax = int(geom.lmax()) + 1
        self.mgen = _grf.MapGen(geom, _cmb_ps(theory, lmax, pol), dtype=dtype,
                                device=self.device)
        self.update_kappa(kappa_fixed)

    def update_kappa(self, kappa):
        self.kappa = torch.as_tensor(kappa, dtype=self.dtype,
                                     device=self.device)
        self.alpha = alpha_from_kappa(self.kappa, self.geom)

    def generate_sim_from_noise(self, eta):
        """``(unlensed, lensed)`` from the complex white-noise planes
        ``(..., ncomp, ny, nx)``."""
        unlensed = self.mgen.get_map_from_noise(eta)
        lead = eta.shape[:-3]
        alpha = self.alpha.expand(lead + self.alpha.shape)
        return unlensed, _displace(unlensed, alpha, self.geom,
                                   self.lens_order)

    def generate_sim(self, generator: torch.Generator, batch=()):
        eta = _grf.rand_kmap(self.geom, generator, self.mgen.ncomp,
                             batch=batch, dtype=self.dtype,
                             device=self.device)
        return self.generate_sim_from_noise(eta)


class FlatLensingSims:
    """Lensed CMB simulations: unlensed GRF (+pol), GRF kappa, spline
    lensing, Gaussian beam, white noise.

    >>> fls = FlatLensingSims(geom, theory, 1.4, 7.0, device="cuda")
    >>> obs = fls.get_sim(generator)
    >>> obs, extras = fls.get_sim(generator, return_intermediate=True)
    """

    def __init__(self, geom: Geometry, theory, beam_arcmin, noise_uk_arcmin,
                 noise_e_uk_arcmin=None, noise_b_uk_arcmin=None,
                 pol: bool = False, lens_order: int = 5,
                 lens_method: str = "spline", dtype=torch.float32,
                 device=None):
        if lens_method not in ("spline", "taylens"):
            raise ValueError(f"unknown lens_method {lens_method!r}")
        self.geom = geom
        self.pol = pol
        self.lens_order = lens_order
        self.lens_method = lens_method
        if noise_e_uk_arcmin is None:
            noise_e_uk_arcmin = np.sqrt(2.0) * noise_uk_arcmin
        if noise_b_uk_arcmin is None:
            noise_b_uk_arcmin = noise_e_uk_arcmin
        device = resolve(device)
        lmax = int(geom.lmax()) + 1
        ells = np.arange(lmax)
        ncomp = 3 if pol else 1
        self.mgen = _grf.MapGen(geom, _cmb_ps(theory, lmax, pol), dtype=dtype,
                                device=device)
        ps_kk = np.asarray(theory.gCl("kk", ells))[None, None]
        self.kgen = _grf.MapGen(geom, ps_kk, dtype=dtype, device=device)
        self.kbeam = F.gauss_beam(geom.modlmap(dtype, device), beam_arcmin)
        ps_noise = np.zeros((ncomp, ncomp, lmax))
        ps_noise[0, 0] = (noise_uk_arcmin * arcmin) ** 2
        if pol:
            ps_noise[1, 1] = (noise_e_uk_arcmin * arcmin) ** 2
            ps_noise[2, 2] = (noise_b_uk_arcmin * arcmin) ** 2
        self.ngen = _grf.MapGen(geom, ps_noise, dtype=dtype, device=device)

    def lens(self, unlensed, kappa):
        """``unlensed`` (``lead + ([3,] ny, nx)``) lensed by ``kappa``
        (``lead + (ny, nx)``)."""
        alpha = alpha_from_kappa(kappa, self.geom)
        if self.lens_method == "taylens":
            if alpha.ndim != 3:
                raise ValueError("taylens takes one kappa map, not a batch")
            return taylens(unlensed, alpha, self.geom, order=self.lens_order)
        return _displace(unlensed, alpha, self.geom, self.lens_order)

    def get_sim_from_noise(self, eta_c, eta_k, eta_n,
                           return_intermediate: bool = False,
                           skip_lensing: bool = False):
        """Observed map(s) from the three complex white-noise stacks: CMB
        and instrument noise ``(..., ncomp, ny, nx)``, kappa
        ``(..., 1, ny, nx)``."""
        unlensed = self.mgen.get_map_from_noise(eta_c)
        if skip_lensing:
            kappa = torch.zeros(eta_k.shape[:-3] + self.geom.shape,
                                dtype=unlensed.dtype, device=unlensed.device)
            lensed = unlensed
        else:
            kappa = self.kgen.get_map_from_noise(eta_k)
            lensed = self.lens(unlensed, kappa)
        beamed = F.kfilter(lensed, self.kbeam, self.geom)
        noise = self.ngen.get_map_from_noise(eta_n)
        observed = beamed + noise
        if return_intermediate:
            return observed, dict(unlensed=unlensed, kappa=kappa,
                                  lensed=lensed, beamed=beamed, noise=noise)
        return observed

    def draw_noise(self, generator: torch.Generator, batch=()):
        """The three white-noise stacks :meth:`get_sim_from_noise` takes."""
        cov = self.mgen.covsqrt
        return tuple(_grf.rand_kmap(self.geom, generator, nc, batch=batch,
                                    dtype=cov.dtype, device=cov.device)
                     for nc in (self.mgen.ncomp, 1, self.mgen.ncomp))

    def get_sim(self, generator: torch.Generator,
                return_intermediate: bool = False,
                skip_lensing: bool = False, batch=()):
        return self.get_sim_from_noise(
            *self.draw_noise(generator, batch),
            return_intermediate=return_intermediate,
            skip_lensing=skip_lensing)


# ------------------------------------------------------------------
# NFW halo profiles
# ------------------------------------------------------------------

def _as_f64(x, device=None):
    """A tensor as it is, on its own device; host numbers and arrays as
    float64 tensors on ``device`` (``None``: the card)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x, dtype=np.float64),
                           device=resolve(device))


def gnfw(x, device=None):
    """Projected NFW profile shape g(theta/thetaS) (Hu, DeDeo & Vale
    2007)."""
    x = _as_f64(x, device)
    xm1 = x * x - 1.0
    den = torch.where(xm1.abs() < 1e-12, torch.ones_like(xm1), xm1)
    root = torch.sqrt(xm1.abs())
    hi = (1.0 - 2.0 / root
          * torch.atan(torch.sqrt(((x - 1.0) / (x + 1.0)).abs()))) / den
    lo = (1.0 - 2.0 / root
          * torch.atanh(torch.sqrt(((1.0 - x) / (x + 1.0)).abs()))) / den
    out = torch.where(x > 1.0, hi, lo)
    return torch.where((x - 1.0).abs() < 1e-6,
                       torch.full_like(out, 1.0 / 3.0), out)


def f_c(c):
    if not isinstance(c, torch.Tensor):
        return float(np.log(1.0 + c) - c / (1.0 + c))
    return torch.log(1.0 + c) - c / (1.0 + c)


def fnfw(x):
    return 1.0 / (x * (1.0 + x) ** 2)


G_MPC_S_MSUN = 4.517e-48   # Newton G in Mpc^3 / Msun / s^2
C_MPC_S = 9.716e-15        # speed of light in Mpc/s
TWO_G_OVER_C2 = 9.571e-20  # 2 G / c^2 in Mpc / Msun


def rho_nfw(M, c, R):
    """NFW 3D density (Msun/Mpc^3) as a function of radius r (Mpc)."""
    return lambda r: (c / R) ** 3 * M / (4.0 * np.pi * f_c(c)) * fnfw(c * r / R)


def proj_rho_nfw(theta, comL, M, c, R, device=None):
    """LOS-projected NFW density (Msun/Mpc^2) vs angle theta (radians)."""
    thetaS = R / c / comL
    return ((c / R) ** 2 * M / (4.0 * np.pi * f_c(c)) * 2.0
            * gnfw(_as_f64(theta, device) / thetaS))


def projected_rho(thetas, comL, rho_func, pmax=2000.0, nps=500000,
                  chunk: int = 8, device=None):
    """Generic LOS projection of a 3D density profile by trapezoid
    quadrature over ``nps`` samples in ``[-pmax, pmax]``; the thetas are
    taken ``chunk`` at a time so that the work array stays ``chunk * nps``."""
    th = torch.atleast_1d(_as_f64(thetas, device))
    pz = torch.linspace(-pmax, pmax, nps, dtype=th.dtype, device=th.device)
    out = [torch.trapezoid(
        rho_func(torch.sqrt(pz ** 2 + (t[:, None] * comL) ** 2)), pz)
        for t in th.split(chunk)]
    return torch.cat(out)


def kappa_nfw_generic(theta, z, comL, M, c, R, win_at_lens, device=None):
    """NFW convergence profile vs angle."""
    return (4.0 * np.pi * G_MPC_S_MSUN * (1 + z) * comL * win_at_lens
            * proj_rho_nfw(theta, comL, M, c, R, device) / C_MPC_S ** 2)


def kappa_generic(theta, z, comL, rho_func, win_at_lens, pmax=2000.0,
                  nps=500000, device=None):
    return (4.0 * np.pi * G_MPC_S_MSUN * (1 + z) * comL * win_at_lens
            * projected_rho(theta, comL, rho_func, pmax, nps, device=device)
            / C_MPC_S ** 2)


def nfw_kappa_profile(modrmap, mass_msun_overh, comL_mpc_overh, win_at_lens,
                      z_lens, concentration=3.2, rdel_mpc_overh=None,
                      overdensity=180.0, rho_mean_z=None, device=None):
    """NFW kappa on a radial grid (a tensor, which the result follows; a
    host array goes to ``device``), in closed form:

      kappa(theta) = (2G/c^2) * comL (1+z) W * M/(rS^2 f_c) * g(theta/thetaS)

    ``rdel_mpc_overh``: the overdensity radius R_delta in Mpc/h; if None it
    is computed from ``rho_mean_z`` (mean matter density at the relevant z
    in (Msun/h)/(Mpc/h)^3) via M = (4/3) pi delta rho R^3.
    """
    M = abs(mass_msun_overh)
    if rdel_mpc_overh is None:
        if rho_mean_z is None:
            raise ValueError("need rdel_mpc_overh or rho_mean_z")
        rdel_mpc_overh = (3.0 * M / (4.0 * np.pi * overdensity
                                     * rho_mean_z)) ** (1.0 / 3.0)
    c = concentration
    rS = rdel_mpc_overh / c
    thetaS = rS / comL_mpc_overh
    consts = (TWO_G_OVER_C2 * comL_mpc_overh * (1.0 + z_lens) * win_at_lens
              * M / (rS * rS) / f_c(c))
    return float(np.sign(mass_msun_overh)) * consts * gnfw(
        _as_f64(modrmap, device) / thetaS)


# ------------------------------------------------------------------
# small host utilities
# ------------------------------------------------------------------

def fill_low_ell(ells, cls, ellmin):
    """Extend a spectrum to l=2 with its value at ellmin (host-side)."""
    ells = np.asarray(ells)
    cls = np.asarray(cls)
    low = np.where(ells > ellmin)[0][0]
    fill = np.arange(2, ells[low])
    return (np.concatenate([fill, ells[low:]]),
            np.concatenate([np.full(len(fill), cls[low]), cls[low:]]))


def sanitize_power(nl):
    """Replace negative values by NaN then interpolate over them."""
    nl = np.asarray(nl, dtype=np.float64).copy()
    nl[nl < 0] = np.nan
    bad = np.isnan(nl)
    if bad.any():
        nl[bad] = np.interp(np.flatnonzero(bad), np.flatnonzero(~bad),
                            nl[~bad])
    return nl


def validate_geometry(geom: Geometry, verbose: bool = False):
    """Sanity-check a geometry's area and pixel size, warning on
    pathological values."""
    area_sqdeg = float(geom.area) * (180.0 / np.pi) ** 2
    if verbose:
        print("Geometry area : ", area_sqdeg, " sq.deg.")
    if area_sqdeg > 41252.0:
        warnings.warn(f"Geometry has area larger than full-sky: {geom}")
    if area_sqdeg < (1.0 / 60.0 / 60.0):
        warnings.warn(f"Geometry has area less than 1 arcmin^2: {geom}")
    res_deg = np.rad2deg(max(geom.dy, geom.dx))
    if verbose:
        print("Geometry pixel width : ", res_deg * 60.0, " arcmin.")
    if res_deg > 30.0:
        warnings.warn(f"Geometry has pixel larger than 30 degrees: {geom}")
    if res_deg < (1.0 / 60.0 / 60.0):
        warnings.warn(f"Geometry has pixel smaller than 1 arcsecond: {geom}")
