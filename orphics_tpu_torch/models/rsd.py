"""Redshift-space k-mode power spectra and Fisher forecasts (port of
``orphics_tpu.models.rsd``).

The reference sketches this machinery in ``orphics/cosmology.py:1436-1610``
(``kmode_derivatives`` is an empty stub there and ``kmode_fisher`` /
``Pgg_Pvv_Pgv`` reference undefined locals — i.e. the reference ships
broken drafts). This module implements the intended, documented behavior
natively and working:

* ``Pgg_Pvv_Pgv`` — anisotropic galaxy, velocity and cross power on a
  (mu, k) grid in the linear Kaiser model:
      P_gg = (b + f mu^2)^2 W^2 P_mm
      P_vv = (f a H / k)^2 P_mm
      P_gv = (b + f mu^2) (f a H / k) W P_mm
  with optional photo-z damping ``W = exp(-k^2 mu^2 sigma_chi^2 / 2)``.
* ``kmode_derivatives`` — finite-difference derivative dicts over a
  parameter list (the reference's empty stub, implemented).
* ``kmode_fisher`` — the 2x2 field-covariance Fisher integral
  F_ij = V/2 int k^2 dk dmu / (2pi)^2 Tr[dC_i Cinv dC_j Cinv],
  fully vectorized over the (mu, k) grid (no Python double loop).

The (mu, k) grids are float64 tensors on the device of a tensor ``ks``,
else on ``device`` (``None``: the card); the Fisher sums are host float64
numpy and take tensors or arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import as_tensor

__all__ = ["growth_rate", "Pgg_Pvv_Pgv", "kmode_derivatives",
           "kmode_fisher"]


def growth_rate(cc, z, dz=0.01):
    """f(z) = dlnD/dlna via central difference of the native growth
    solution (``Cosmology.D_growth``)."""
    a0 = 1.0 / (1.0 + z + dz)
    a1 = 1.0 / (1.0 + max(z - dz, 0.0))
    d0 = float(cc.D_growth(np.asarray([a0]))[0])
    d1 = float(cc.D_growth(np.asarray([a1]))[0])
    return (np.log(d1) - np.log(d0)) / (np.log(a1) - np.log(a0))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def Pgg_Pvv_Pgv(ks, mus, z, cc=None, bg=2.0, sigz=None, device=None):
    """Linear Kaiser (mu, k) power spectra at redshift ``z``.

    ks : 1D wavenumbers [1/Mpc];  mus : 1D cosines;  bg : linear bias;
    sigz : optional photo-z scatter sigma_z (damps the galaxy field by
    ``exp(-k^2 mu^2 sigma_chi^2 / 2)`` with sigma_chi = c sigma_z / H).
    Returns (Pgg, Pgv, Pvv) of shape (nmu, nk) [Mpc^3] — note the
    ordering matches the reference docstring (gg, gv, vv is the natural
    covariance order used by :func:`kmode_fisher`).
    """
    from .cosmology import Cosmology
    if cc is None:
        cc = Cosmology()
    ks = as_tensor(ks, device, torch.float64)
    mus = as_tensor(mus, ks.device, torch.float64)
    pm = torch.as_tensor(np.asarray(cc.P_lin(_np(ks), z), np.float64),
                         device=ks.device)   # (nk,) Mpc^3
    f = growth_rate(cc, z)
    a = 1.0 / (1.0 + z)
    Hz = cc.hubble_parameter(z) / 299792.458   # 1/Mpc (H/c)
    mu2 = mus[:, None] ** 2
    bgeff = bg + f * mu2                     # (nmu, 1)
    if sigz is not None:
        sig_chi = 299792.458 * sigz * (1 + z) / cc.hubble_parameter(z)
        W = torch.exp(-0.5 * (ks[None, :] * mus[:, None] * sig_chi) ** 2)
    else:
        W = 1.0
    fahk = f * a * Hz / ks[None, :]          # (1, nk) dimensionless
    Pgg = bgeff ** 2 * pm[None, :] * W ** 2
    Pvv = fahk ** 2 * pm[None, :] + 0.0 * mu2
    Pgv = bgeff * fahk * pm[None, :] * W
    return Pgg, Pgv, Pvv


def kmode_derivatives(ks, mus, param_list, fid_dict, step_dict, z,
                      bg=2.0, sigz=None, extra_getter=None, device=None):
    """Finite-difference derivative dicts of (Pgg, Pgv, Pvv) over
    cosmological parameters (the reference's empty
    ``cosmology.py:1436`` stub, implemented).

    fid_dict / step_dict : parameter name -> fiducial / step. The
    special names "bg" and "fnl-like" extras can be handled by passing
    ``extra_getter(params, bg) -> (Pgg, Pgv, Pvv)``; by default
    cosmological parameters are routed through ``Cosmology(params)``.
    Returns (dPgg, dPgv, dPvv) dicts keyed by parameter.
    """
    from .cosmology import Cosmology

    def get(params, bgv):
        if extra_getter is not None:
            return extra_getter(params, bgv)
        return Pgg_Pvv_Pgv(ks, mus, z, cc=Cosmology(params), bg=bgv,
                           sigz=sigz, device=device)

    dPgg, dPgv, dPvv = {}, {}, {}
    for name in param_list:
        step = step_dict[name]
        up = dict(fid_dict)
        dn = dict(fid_dict)
        bup = bdn = bg
        if name == "bg":
            bup, bdn = bg + step, bg - step
        else:
            up[name] = fid_dict[name] + step
            dn[name] = fid_dict[name] - step
        pu = get({k: v for k, v in up.items() if k != "bg"}, bup)
        pd = get({k: v for k, v in dn.items() if k != "bg"}, bdn)
        dPgg[name] = (pu[0] - pd[0]) / (2 * step)
        dPgv[name] = (pu[1] - pd[1]) / (2 * step)
        dPvv[name] = (pu[2] - pd[2]) / (2 * step)
    return dPgg, dPgv, dPvv


def kmode_fisher(ks, mus, volume_mpc3, param_list, dPgg, dPgv, dPvv,
                 fPgg, fPgv, fPvv, Ngg, Nvv):
    """Fisher matrices for the (g, v) field pair and for g alone
    (reference ``cosmology.py:1440``, vectorized).

    All spectra are (nmu, nk) grids; Ngg/Nvv are noise powers (scalar or
    grid). Returns (F_gv, F_g) as plain (nP, nP) ndarrays ordered like
    ``param_list``.
    """
    ks = _np(ks)
    mus = _np(mus)
    dk = np.diff(ks)
    dmu = np.diff(mus)
    # midpoint measure on the (mu, k) cell grid, matching the
    # reference's left-point Riemann sum structure
    kk = ks[:-1]
    pref = (kk[None, :] ** 2 * dk[None, :] * dmu[:, None]
            * volume_mpc3 / (2 * np.pi) ** 2 / 2.0)     # (nmu-1, nk-1)

    def cell(x):
        x = _np(x) + np.zeros((mus.size, ks.size))
        return x[:-1, :-1]

    C = np.stack([np.stack([cell(fPgg) + cell(Ngg), cell(fPgv)], 0),
                  np.stack([cell(fPgv), cell(fPvv) + cell(Nvv)], 0)], 1)
    # C: (2, 2, nmu-1, nk-1) -> per-cell inverse of a 2x2
    det = C[0, 0] * C[1, 1] - C[0, 1] * C[1, 0]
    Cinv = np.empty_like(C)
    Cinv[0, 0] = C[1, 1] / det
    Cinv[1, 1] = C[0, 0] / det
    Cinv[0, 1] = -C[0, 1] / det
    Cinv[1, 0] = -C[1, 0] / det
    CinvG = 1.0 / (cell(fPgg) + cell(Ngg))

    nP = len(param_list)
    dCs = []
    for name in param_list:
        dCs.append(np.stack([
            np.stack([cell(dPgg[name]), cell(dPgv[name])], 0),
            np.stack([cell(dPgv[name]), cell(dPvv[name])], 0)], 1))
    F = np.zeros((nP, nP))
    FG = np.zeros((nP, nP))
    for i in range(nP):
        Mi = np.einsum("ab...,bc...->ac...", dCs[i], Cinv)
        for j in range(i, nP):
            Mj = np.einsum("ab...,bc...->ac...", dCs[j], Cinv)
            tr = np.einsum("ab...,ba...->...", Mi, Mj)
            F[i, j] = F[j, i] = np.sum(pref * tr)
            trG = dCs[i][0, 0] * dCs[j][0, 0] * CinvG ** 2
            FG[i, j] = FG[j, i] = np.sum(pref * trG)
    return F, FG
