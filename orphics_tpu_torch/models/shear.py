"""Cosmic-shear Limber likelihood and forecasts (port of
``orphics_tpu.models.shear``: the JAX package's numpy module, with the
Limber quadrature of :class:`LimberCosmology` on ``device``).

Native replacement for the reference's cobaya ``GenericLimberCosmicShear``
likelihood (``orphics/cosmology.py:1771``): binned C_L^kk data vector for
a delta-function source plane, Gaussian (Knox) band covariance, and a
chi-square log-likelihood — built entirely on the in-repo
:class:`~orphics_tpu_torch.models.cosmology.LimberCosmology` machinery instead
of camb/cobaya/pyfisher.
"""
from __future__ import annotations

import numpy as np

from ..ops.binning import bin1d

__all__ = ["gaussian_band_covariance", "LimberCosmicShear"]


def gaussian_band_covariance(bin_edges, cl, nl, fsky):
    """Diagonal Knox band covariance of binned auto-spectra:
    Var(b) = [sum_{l in b} (2l+1) fsky / (2 (C_l+N_l)^2)]^{-1}
    (the pyfisher.gaussian_band_covariance role in the reference)."""
    ls = np.arange(len(cl), dtype=np.float64)
    tot = np.asarray(cl) + np.asarray(nl)
    out = np.zeros(len(bin_edges) - 1)
    for i in range(len(out)):
        sel = (ls >= bin_edges[i]) & (ls < bin_edges[i + 1])
        info = np.sum((2 * ls[sel] + 1) * fsky / (2.0 * tot[sel] ** 2))
        out[i] = 1.0 / info if info > 0 else np.inf
    return out


class LimberCosmicShear:
    """Gaussian cosmic-shear likelihood on binned C_L^kappakappa.

    Parameters mirror the reference class: a single delta source plane at
    ``zsrc``, shape noise N_L = sigma_e^2 / (2 n_gal), Knox band
    covariance at ``fsky``. The mock data vector is the fiducial
    cosmology's own C_L (as in the reference's ``get_mock_theory``). Each
    theory curve runs the Limber quadrature on ``device`` (``None``: the
    card); the likelihood itself is host numpy.
    """

    def __init__(self, zsrc, ngal_arcmin2, fsky, glmin=10, lmin=10,
                 lmax=500, nell=20, shape_std=0.3, trim_lmax=599,
                 fiducial_params=None, kmax=10.0, nz_pk=120, nk_pk=300,
                 device=None):
        self.zsrc = zsrc
        self.fsky = fsky
        bin_edges = np.geomspace(glmin, lmax, nell)
        self.bin_edges = bin_edges[bin_edges > lmin]
        self.ls = np.arange(0, trim_lmax + 2, dtype=np.float64)
        # shape noise per steradian: ngal per arcmin^2 -> per sr
        arcmin2_per_sr = 1.18e7
        self.nlkk = np.full(len(self.ls),
                            shape_std ** 2
                            / (2.0 * ngal_arcmin2 * arcmin2_per_sr))
        self._limber_kw = dict(lmax=trim_lmax + 2, kmax=kmax,
                               nz_pk=nz_pk, nk_pk=nk_pk, device=device)
        self._fid = fiducial_params or {}
        cl_fid = self.get_theory(self._fid)
        self.cents, self.data_binned = bin1d(self.ls, cl_fid,
                                             self.bin_edges)
        cov = gaussian_band_covariance(self.bin_edges, cl_fid, self.nlkk,
                                       fsky)
        self.cov = cov
        self.cinv = np.diag(1.0 / cov)
        self._cl_fid = cl_fid

    def get_theory(self, params=None):
        """C_L^kk for a delta source at zsrc in the given cosmology."""
        from .cosmology import LimberCosmology
        lc = LimberCosmology(params=dict(params or {}), **self._limber_kw)
        lc.addDeltaNz("s", self.zsrc)
        lc.generateCls(self.ls)
        return np.asarray(lc.Clmatrix["s,s"])

    def logp(self, params=None, cl_kk=None):
        """Gaussian log-likelihood of a parameter point (or directly of a
        theory C_L^kk curve)."""
        if cl_kk is None:
            cl_kk = self.get_theory(params)
        _, bth = bin1d(self.ls, cl_kk, self.bin_edges)
        delta = self.data_binned - bth
        return -0.5 * delta @ self.cinv @ delta

    def sn(self):
        """Total detection S/N of the fiducial data vector."""
        return float(np.sqrt(self.data_binned @ self.cinv
                             @ self.data_binned))

    def fisher(self, param_steps):
        """Fisher matrix over parameters via symmetric finite differences.

        param_steps: dict name -> (fiducial, step). Returns (names, F).
        """
        names = list(param_steps.keys())
        derivs = []
        for name in names:
            fid, step = param_steps[name]
            up = dict(self._fid)
            dn = dict(self._fid)
            up[name] = fid + step
            dn[name] = fid - step
            cu = self.get_theory(up)
            cd = self.get_theory(dn)
            _, bu = bin1d(self.ls, cu, self.bin_edges)
            _, bd = bin1d(self.ls, cd, self.bin_edges)
            derivs.append((bu - bd) / (2 * step))
        nP = len(names)
        F = np.zeros((nP, nP))
        for i in range(nP):
            for j in range(nP):
                F[i, j] = derivs[i] @ self.cinv @ derivs[j]
        return names, F
