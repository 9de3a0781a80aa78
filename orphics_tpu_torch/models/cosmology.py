"""Background cosmology, linear matter power, Limber integrals, forecasts
(port of ``orphics_tpu.models.cosmology``).

As in the JAX package, there is no CAMB (Fortran) dependency: the
Boltzmann-level CMB spectra come from shipped tables
(:mod:`orphics_tpu_torch.models.theory`), while background distances, the
EH98 transfer function, growth, Limber C_l integrals and Knox forecasting
are implemented natively. Host float64 numpy does the one-off setup
(distance and growth grids, ``Cosmology`` itself); the Limber quadrature
is one float64 torch computation over (ell, z) on the cosmology's device
(``LimberCosmology(device=None)``: the card), with P(k, z) as a static
interpolation table, in place of the per-ell Python loop at reference
``cosmology.py:585-595``. ``get_lensed_cls`` bins on the port's
:class:`~orphics_tpu_torch.ops.binning.Bin2D` (kernel B1 on the card).

The ``camb`` / ``classy`` glue (``CAMB``, ``save_glens_cls_from_ini``,
``class_cls``) imports those optional packages and raises without them,
as the JAX functions do; ``ClassCosmology`` raises always.

Key reference anchors: ``defaultCosmology/defaultConstants``
(``cosmology.py:22-68``), EH98 transfer (``:389-468``), ``D_growth``
(``:470``), ``LimberCosmology`` (``:526``) with ``addDeltaNz/addStepNz/
addNz`` (``:648-691``), ``generateCls`` (``:570``), ``_initWkappaCMB``
(``:720``), ``LensForecast``/``KnoxCov``/``sn`` (``:952-1094``),
``s8_from_as/As_from_s8`` (``:1535,1561``),
``get_limber_clkk_flat_universe`` (``:1719``).
"""
from __future__ import annotations

import itertools
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .._device import resolve

__all__ = ["defaultConstants", "defaultCosmology", "Cosmology",
           "LimberCosmology", "LensForecast", "s8_from_as", "As_from_s8",
           "get_limber_clkk_flat_universe", "pkgrid_from_table",
           "load_camb_pk", "CAMB"]

C_KM_S = 299792.458  # km/s

defaultConstants = {
    'TCMB': 2.7255, 'G_CGS': 6.67259e-08, 'MSUN_CGS': 1.98900e+33,
    'MPC2CM': 3.085678e+24, 'ERRTOL': 1e-12, 'K_CGS': 1.3806488e-16,
    'H_CGS': 6.62608e-27, 'C': 2.99792e+10,
    'A_ps': 3.1, 'A_g': 0.9, 'nu0': 150., 'n_g': -0.7, 'al_g': 3.8,
    'al_ps': -0.5, 'Td': 9.7, 'al_cib': 2.2, 'A_cibp': 6.9, 'A_cibc': 4.9,
    'n_cib': 1.2, 'A_tsz': 5.6, 'ell0sec': 3000.,
}

# DR4 / Erminia cosmology, as in the reference (cosmology.py:48)
defaultCosmology = {
    'omch2': 0.1203058, 'ombh2': 0.02219218, 'H0': 67.02393,
    'ns': 0.9625356, 'As': 2.15086031154146e-9, 'mnu': 0.06,
    'w0': -1.0, 'tau': 0.06574325, 'nnu': 3.046, 'wa': 0.,
    'Ysig': 0.127, 'gammaYsig': 0., 'betaYsig': 0., 'Y_star': 2.42e-10,
    'alpha_ym': 1.79, 'b_ym': 0.8, 'beta_ym': 0.0, 'b_wl': 1.,
    'gamma_ym': 0.0,
}


class Cosmology:
    """Flat w0-wa background + EH98 linear matter power.

    The stand-in for the reference ``Cosmology`` object (``cosmology.py:111``)
    minus the CAMB Boltzmann solve. Provides ``results``-style methods:
    ``comoving_radial_distance``, ``redshift_at_comoving_radial_distance``,
    ``hubble_parameter``, plus transfer/growth/P(k,z)/sigma8/sigmaR.

    ``pkgrid_override``: callable P(z, k[1/Mpc]) -> Mpc^3 replacing the
    internal EH98 power (the reference's test-injection hook,
    ``cosmology.py:327-335``).
    """

    def __init__(self, params: Dict = None, constants: Dict = None,
                 zmax: float = 1200.0, nz: int = 4096,
                 pkgrid_override: Optional[Callable] = None,
                 transfer: str = "eisenhu_osc",
                 lmax: int = None, pickling: bool = False,
                 dimensionless: bool = False, skipCls: bool = False,
                 skipPower: bool = False, skip_growth: bool = False,
                 low_acc: bool = False, verbose: bool = False):
        # lmax/pickling/dimensionless/skip*/low_acc/verbose are the
        # reference constructor's CAMB-solve knobs
        # (``cosmology.py:111``): accepted for tutorial call
        # compatibility; the native object has no Boltzmann solve to
        # configure (theory Cls come from shipped tables /
        # default_theory), so they are recorded but inert.
        self.lmax = lmax
        self.dimensionless = bool(dimensionless)
        p = dict(defaultCosmology)
        p.update(params or {})
        self.params = p
        self.c = dict(defaultConstants)
        self.c.update(constants or {})
        self.H0 = p['H0']
        self.h = self.H0 / 100.0
        self.omch2 = p['omch2']
        self.ombh2 = p['ombh2']
        self.omnuh2 = p.get('mnu', 0.0) / 93.14
        self.om = (self.omch2 + self.ombh2 + self.omnuh2) / self.h ** 2
        self.ob = self.ombh2 / self.h ** 2
        self.ode = 1.0 - self.om  # flat
        self.w0 = p.get('w0', -1.0)
        self.wa = p.get('wa', 0.0)
        self.ns = p['ns']
        self.As = p['As']
        self.tcmb = self.c['TCMB']
        self.cmbZ = 1100.0
        self._transfer_type = transfer
        self._pkgrid_override = pkgrid_override

        # --- distance grid (host) ----
        self._zgrid = np.linspace(0.0, zmax, nz)
        ez = self.Ez(self._zgrid)
        integ = C_KM_S / (self.H0 * ez)
        self._chigrid = np.concatenate(
            [[0.0], np.cumsum(0.5 * (integ[1:] + integ[:-1])
                              * np.diff(self._zgrid))])
        self.chistar = float(np.interp(self.cmbZ, self._zgrid, self._chigrid))

        # --- growth (host ODE) ----
        self._init_growth()
        self._sigma8 = None
        self.results = self  # reference code accesses cc.results.*

    # ---- background -------------------------------------------------
    def f_de(self, a):
        eps = 1e-9
        return -3.0 * (1.0 + self.w0) + 3.0 * self.wa * (
            (a - 1.0) / np.log(a - eps) - 1.0)

    def Ez(self, z):
        a = 1.0 / (1.0 + np.asarray(z))
        return np.sqrt(self.om * a ** -3 + self.ode * a ** self.f_de(a))

    def hubble_parameter(self, z):
        """H(z) in km/s/Mpc (camb results API)."""
        return self.H0 * self.Ez(z)

    def comoving_radial_distance(self, z):
        """chi(z) in Mpc."""
        return np.interp(np.asarray(z), self._zgrid, self._chigrid)

    def redshift_at_comoving_radial_distance(self, chi):
        return np.interp(np.asarray(chi), self._chigrid, self._zgrid)

    def angular_diameter_distance(self, z):
        return self.comoving_radial_distance(z) / (1.0 + np.asarray(z))

    def rho_crit0_h2(self):
        """Critical density today in (Msun/h) / (Mpc/h)^3 / h^2-units:
        rho_crit = 2.7754e11 h^2 Msun/Mpc^3 -> 2.7754e11 (Msun/h)/(Mpc/h)^3."""
        return 2.7754e11

    def rho_matter_z(self, z):
        """Mean matter density in (Msun/h)/(Mpc/h)^3 (comoving -> physical
        factor (1+z)^3)."""
        return self.rho_crit0_h2() * self.om * (1.0 + np.asarray(z)) ** 3

    def rdel_m(self, M, z, overdensity=180.0):
        """R_delta (Mpc/h) of mass M (Msun/h) wrt mean matter density."""
        rho = self.rho_matter_z(z)
        return (3.0 * M / (4.0 * np.pi * overdensity * rho)) ** (1.0 / 3.0)

    def rdel_c(self, M, z, overdensity=500.0):
        """R_delta (Mpc/h) wrt critical density at z."""
        rhoc = self.rho_crit0_h2() * self.Ez(z) ** 2
        return (3.0 * M / (4.0 * np.pi * overdensity * rhoc)) ** (1.0 / 3.0)

    # ---- growth -------------------------------------------------------
    def _init_growth(self):
        from scipy.integrate import odeint

        amin, amax, na = 1e-3, 1.0, 2000
        atab = np.linspace(amin, amax, na)

        def om_a(a):
            return self.om * a ** -3 / (self.om * a ** -3
                                        + self.ode * a ** self.f_de(a))

        def ode_a(a):
            return 1.0 - om_a(a)

        def w(a):
            return self.w0 + (1.0 - a) * self.wa

        def derivs(y, a):
            q = (2.0 - 0.5 * (om_a(a) + (1.0 + 3.0 * w(a)) * ode_a(a))) / a
            r = 1.5 * om_a(a) / a / a
            return [y[1], -q * y[1] + r * y[0]]

        y = odeint(derivs, [amin, 1.0], atab)
        self._atab = atab
        self._dtab = y[:, 0]
        self._d1 = float(np.interp(1.0, atab, self._dtab))

    def D_growth(self, a, norm: str = "z0"):
        """Growth factor; ``norm='z0'`` -> D(1)=1 (reference
        ``D_growth(type='camb_z0norm')``); ``norm='matter'`` -> D ~ a in
        matter domination (used in the P(k) normalization)."""
        d = np.interp(np.asarray(a), self._atab, self._dtab)
        if norm == "z0":
            return d / self._d1
        return d  # ODE started with D=a in the matter era

    # ---- transfer function (EH98) --------------------------------------
    def transfer(self, k_invmpc, type: str = None):
        """EH98 transfer function; ``k`` in 1/Mpc. 'eisenhu' = no-wiggle
        (EH98 eq 29), 'eisenhu_osc' = full with baryon oscillations
        (reference ``cosmology.py:389-468``)."""
        type = type or self._transfer_type
        k = np.asarray(k_invmpc, dtype=np.float64) / self.h  # h/Mpc below
        w_m = self.omch2 + self.ombh2
        w_b = self.ombh2
        fb = w_b / w_m
        fc = (w_m - w_b) / w_m
        theta = self.tcmb / 2.7
        # EH98 eq 2-6
        z_eq = 2.50e4 * w_m * theta ** -4
        k_eq = 7.46e-2 * w_m * theta ** -2 / self.h   # h/Mpc
        b1 = 0.313 * w_m ** -0.419 * (1 + 0.607 * w_m ** 0.674)
        b2 = 0.238 * w_m ** 0.223
        z_d = 1291.0 * w_m ** 0.251 / (1 + 0.659 * w_m ** 0.828) \
            * (1 + b1 * w_b ** b2)
        R_of = lambda z: 31.5 * w_b * theta ** -4 * (z / 1e3) ** -1
        R_d = R_of(z_d)
        R_eq = R_of(z_eq)
        # sound horizon (eq 6), Mpc -> Mpc/h
        s = (2.0 / (3.0 * k_eq * self.h) * np.sqrt(6.0 / R_eq)
             * np.log((np.sqrt(1 + R_d) + np.sqrt(R_d + R_eq))
                      / (1 + np.sqrt(R_eq)))) * self.h
        k_silk = 1.6 * w_b ** 0.52 * w_m ** 0.73 \
            * (1 + (10.4 * w_m) ** -0.95) / self.h  # h/Mpc

        if type == "eisenhu":
            alpha_gamma = (1 - 0.328 * np.log(431. * w_m) * w_b / w_m
                           + 0.38 * np.log(22.3 * w_m) * fb ** 2)
            gamma_eff = self.om * self.h * (
                alpha_gamma + (1 - alpha_gamma) / (1 + (0.43 * k * s) ** 4))
            q = k * theta ** 2 / gamma_eff
            L = np.log(2 * np.e + 1.8 * q)
            C = 14.2 + 731.0 / (1 + 62.5 * q)
            return L / (L + C * q * q)

        # eisenhu_osc
        a1 = (46.9 * w_m) ** 0.670 * (1 + (32.1 * w_m) ** -0.532)
        a2 = (12.0 * w_m) ** 0.424 * (1 + (45.0 * w_m) ** -0.582)
        alpha_c = a1 ** -fb * a2 ** (-fb ** 3)
        bb1 = 0.944 / (1 + (458.0 * w_m) ** -0.708)
        bb2 = (0.395 * w_m) ** -0.0266
        beta_c = 1.0 / (1 + bb1 * (fc ** bb2 - 1))

        def T_tilde(k1, alpha, beta):
            q = k1 / (13.41 * k_eq)
            L = np.log(np.e + 1.8 * beta * q)
            C = 14.2 / alpha + 386.0 / (1 + 69.9 * q ** 1.08)
            return L / (L + C * q * q)

        f = 1.0 / (1 + (k * s / 5.4) ** 4)
        Tc = f * T_tilde(k, 1.0, beta_c) + (1 - f) * T_tilde(k, alpha_c, beta_c)
        y = (1 + z_eq) / (1 + z_d)
        x = np.sqrt(1 + y)
        G = y * (-6 * x + (2 + 3 * y) * np.log((x + 1) / (x - 1)))
        # note: k_eq here back in h/Mpc; alpha_b uses k_eq*s consistently
        alpha_b = 2.07 * k_eq * s * (1 + R_d) ** -0.75 * G
        beta_node = 8.41 * w_m ** 0.435
        tilde_s = s / (1 + (beta_node / (k * s)) ** 3) ** (1.0 / 3.0)
        beta_b = 0.5 + fb + (3 - 2 * fb) * np.sqrt((17.2 * w_m) ** 2 + 1)
        Tb = (T_tilde(k, 1.0, 1.0) / (1 + (k * s / 5.2) ** 2)
              + alpha_b / (1 + (beta_b / (k * s)) ** 3)
              * np.exp(-(k / k_silk) ** 1.4)) * np.sinc(k * tilde_s / np.pi)
        return fb * Tb + fc * Tc

    # ---- matter power ---------------------------------------------------
    def P_lin(self, k_invmpc, z):
        """Linear matter P(k, z) in Mpc^3, k in 1/Mpc.

        delta(k, z) = (2/5) (c k)^2/(Om H0^2) T(k) D_md(z) R(k), so
        P = (8 pi^2/25) As (k/kp)^(ns-1) k (c/H0)^4 / Om^2 T^2 D^2.
        """
        if self._pkgrid_override is not None:
            return self._pkgrid_override(z, k_invmpc)
        k = np.asarray(k_invmpc, dtype=np.float64)
        kp = 0.05  # 1/Mpc
        T = self.transfer(k)
        a = 1.0 / (1.0 + np.asarray(z))
        D = self.D_growth(a, norm="matter")
        pref = (8 * np.pi ** 2 / 25.0) * self.As / self.om ** 2 \
            * (C_KM_S / self.H0) ** 4
        return pref * (k / kp) ** (self.ns - 1) * k * T ** 2 * D ** 2

    def sigmaR(self, R_mpc_over_h, z=0.0):
        """rms of matter fluctuations in spheres of R (Mpc/h)."""
        R = np.asarray(R_mpc_over_h) / self.h  # Mpc
        k = np.logspace(-4, 1.5, 4000)  # 1/Mpc
        P = self.P_lin(k, z)
        x = k * R
        W = 3 * (np.sin(x) - x * np.cos(x)) / x ** 3
        integ = k ** 2 * P * W ** 2 / (2 * np.pi ** 2)
        return float(np.sqrt(np.trapezoid(integ, k)))

    def sigma8(self, z=0.0):
        if self._sigma8 is None or z != 0.0:
            s8 = self.sigmaR(8.0, z)
            if z == 0.0:
                self._sigma8 = s8
            return s8
        return self._sigma8


def s8_from_as(As, params=None, **kw):
    """sigma8 for a given As (reference ``cosmology.py:1535``)."""
    p = dict(defaultCosmology)
    p.update(params or {})
    p['As'] = As
    return Cosmology(p, **kw).sigma8()


def As_from_s8(sigma8=0.81, params=None, **kw):
    """As matching a target sigma8 (sigma8 ~ sqrt(As) scaling exactly for
    linear power; reference ``cosmology.py:1561``)."""
    p = dict(defaultCosmology)
    p.update(params or {})
    base = Cosmology(p, **kw)
    s80 = base.sigma8()
    return base.As * (sigma8 / s80) ** 2


def pkgrid_from_table(zs, ks_invmpc, P_mpc3):
    """Build a ``pkgrid_override`` callable from a tabulated P(k, z) grid.

    The table-ingestion path for reference-parity accuracy: the internal
    EH98 transfer is ~2% off a Boltzmann P(k); feeding an externally
    computed (e.g. CAMB/CLASS) grid through this override recovers it
    (reference behavior: ``camb.get_matter_power_interpolator``,
    used at ``orphics/cosmology.py:633``).

    Parameters
    ----------
    zs : (nz,) increasing redshifts
    ks_invmpc : (nk,) increasing wavenumbers [1/Mpc]
    P_mpc3 : (nz, nk) linear power [Mpc^3]

    Returns a callable ``pk(z, k_invmpc)`` (elementwise broadcast,
    log-log interpolation in k, linear-in-z of log P, constant
    extrapolation at the grid edges).
    """
    zs = np.asarray(zs, dtype=np.float64)
    lk = np.log(np.asarray(ks_invmpc, dtype=np.float64))
    lP = np.log(np.maximum(np.asarray(P_mpc3, dtype=np.float64), 1e-300))
    if lP.shape != (len(zs), len(lk)):
        raise ValueError(f"P grid shape {lP.shape} != ({len(zs)},{len(lk)})")

    def pk(z, k_invmpc):
        z = np.asarray(z, dtype=np.float64)
        logk = np.log(np.maximum(np.asarray(k_invmpc, np.float64), 1e-300))
        z, logk = np.broadcast_arrays(z, logk)
        iz = np.interp(z, zs, np.arange(len(zs)))
        iz0 = np.clip(iz.astype(int), 0, max(len(zs) - 2, 0))
        fz = np.clip(iz - iz0, 0.0, 1.0)
        flat_lk = logk.reshape(-1)
        flat0 = np.empty_like(flat_lk)
        flat1 = np.empty_like(flat_lk)
        iz0f = iz0.reshape(-1)
        for row in np.unique(iz0f):
            sel = iz0f == row
            flat0[sel] = np.interp(flat_lk[sel], lk, lP[row])
            flat1[sel] = np.interp(flat_lk[sel], lk,
                                   lP[min(row + 1, len(zs) - 1)])
        lp = (flat0.reshape(logk.shape) * (1 - fz)
              + flat1.reshape(logk.shape) * fz)
        return np.exp(lp)

    return pk


def load_camb_pk(paths, zs, h, k_hunits=True):
    """Load CAMB ``*_matterpower_*.dat`` outputs into a pkgrid override.

    Parameters
    ----------
    paths : list of per-redshift two-column text files (k, P), in the
        same order as ``zs``. CAMB's default output has k in h/Mpc and
        P in (Mpc/h)^3 (``k_hunits=True``); pass False for 1/Mpc units.
    zs : redshifts of the files (increasing).
    h : dimensionless Hubble parameter used for unit conversion.

    Returns ``(pk_callable, (zs, ks_invmpc, P_mpc3))``.
    """
    zs = np.asarray(zs, dtype=np.float64)
    if len(paths) != len(zs):
        raise ValueError("need one file per redshift")
    ks = None
    rows = []
    for p in paths:
        tab = np.loadtxt(p)
        if ks is None:
            ks = tab[:, 0]
        elif not np.allclose(ks, tab[:, 0]):
            raise ValueError(f"{p}: k grid differs between files")
        rows.append(tab[:, 1])
    P = np.asarray(rows)
    if k_hunits:
        ks = ks * h           # h/Mpc -> 1/Mpc
        P = P / h ** 3        # (Mpc/h)^3 -> Mpc^3
    order = np.argsort(zs)
    zs, P = zs[order], P[order]
    return pkgrid_from_table(zs, ks, P), (zs, ks, P)


def _interp_index(x, xp):
    """``jnp.interp(x, xp, arange(len(xp)))`` in torch: the fractional
    index of ``x`` on the increasing grid ``xp``, clamped to its ends."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1,
                    n - 1)
    x0 = xp[i - 1]
    f = (i - 1).to(x.dtype) + (x - x0) / (xp[i] - x0)
    f = torch.where(x < xp[0], torch.zeros_like(f), f)
    return torch.where(x > xp[-1], torch.full_like(f, n - 1.0), f)


class LimberCosmology(Cosmology):
    """Limber auto/cross C_l for lensing and counts windows
    (reference ``cosmology.py:526``).

    Usage matches the reference:
      lc = LimberCosmology(); lc.addNz('g', zs, nz, bias=1.6)
      lc.generateCls(ells); clkg = lc.getCl('cmb', 'g')
    """

    def __init__(self, params=None, constants=None, lmax=2000, numz=1000,
                 kmax=42.47, zmax=1200.0, pkgrid_override=None,
                 nz_pk=500, nk_pk=600, device=None, **kw):
        # where generateCls runs its quadrature (None: the card)
        self.device = resolve(device)
        super().__init__(params, constants, zmax=zmax,
                         pkgrid_override=pkgrid_override, **kw)
        self.kmax = kmax
        chis = np.linspace(0.0, self.chistar, numz)
        zs = self.redshift_at_comoving_radial_distance(chis)
        self.dchis = (chis[2:] - chis[:-2]) / 2.0
        self.chis = chis[1:-1]
        self.zs = zs[1:-1]
        self.Hzs = self.hubble_parameter(self.zs)
        self.kernels: Dict[str, Dict] = {}
        self._init_wkappa_cmb()
        self.precalcFactor = self.Hzs ** 2 / self.chis / self.chis / C_KM_S ** 2
        # P(k, z) table for the on-device Limber quadrature. The z grid is
        # uniform in log(1+z): growth varies fast at low z, so a linear
        # grid to z~1100 would interpolate P(z~1) from z=0 and z~9 rows
        # (a ~2x error in clkk).
        self._logk = np.linspace(np.log(1e-4), np.log(kmax), nk_pk)
        ztop = min(zmax, self.zs.max() * 1.001)
        zt = np.expm1(np.linspace(0.0, np.log1p(ztop), nz_pk))
        tab = np.zeros((nz_pk, nk_pk))
        for i, zz in enumerate(zt):
            tab[i] = self.P_lin(np.exp(self._logk), zz)
        self._pk_zt = zt
        self._logpk_tab = np.log(np.maximum(tab, 1e-300))

    # camb-compatible PK.P interface
    def PK_P(self, zs, ks, grid=False):
        """P(k,z) from the table (log-log interp in k, linear in z).

        ``grid=True`` returns the (nz, nk) outer-product grid (the camb
        ``PK.P`` contract); ``grid=False`` evaluates elementwise and
        requires matching shapes."""
        zs_a = np.atleast_1d(np.asarray(zs, np.float64))
        ks_a = np.atleast_1d(np.asarray(ks, np.float64))
        if grid:
            rows = [self.PK_P(np.full(ks_a.shape, z), ks_a, grid=False)
                    for z in zs_a]
            return np.stack(rows)
        if zs_a.shape != ks_a.shape:
            if zs_a.size == 1:
                zs_a = np.full(ks_a.shape, zs_a.reshape(()))
            else:
                raise ValueError(
                    f"elementwise PK_P needs matching shapes (got "
                    f"{zs_a.shape} vs {ks_a.shape}); pass grid=True "
                    "for the outer-product grid")
        logk = np.log(np.maximum(ks_a, 1e-300))
        iz = np.interp(zs_a, self._pk_zt,
                       np.arange(len(self._pk_zt)))
        iz0 = np.clip(iz.astype(int), 0, len(self._pk_zt) - 2)
        fz = iz - iz0
        def at(izi):
            out = np.empty_like(logk)
            for row in np.unique(izi):
                sel = izi == row
                out[sel] = np.interp(logk[sel], self._logk,
                                     self._logpk_tab[row])
            return out
        lp = at(iz0) * (1 - fz) + at(iz0 + 1) * fz
        return np.exp(lp)

    def _lens_prefactor(self):
        return (1.5 * (self.omch2 + self.ombh2 + self.omnuh2) * 100.0 * 100.0
                * (1.0 + self.zs) * self.chis / self.Hzs / C_KM_S)

    def _init_wkappa_cmb(self):
        wz = (self.chistar - self.chis) / self.chistar
        self.kernels['cmb'] = {
            'W': self._lens_prefactor() * wz,
            'window_z': lambda z: np.interp(z, self.zs, wz),
            'type': 'lensing',
        }

    def _lens_window(self, kernel, numz_integral=300):
        if kernel['dndz'] == "delta":
            zs = kernel['zdelta']
            chi_s = self.comoving_radial_distance(zs)
            ret = 1.0 - self.chis / chi_s
            ret[self.zs > zs] = 0.0
            return ret
        ret = np.zeros_like(self.chis)
        for i, (chinow, znow) in enumerate(zip(self.chis, self.zs)):
            if znow > kernel['zmax']:
                continue
            zstart = max(znow, kernel['zmin'])
            zgrid = np.linspace(zstart, kernel['zmax'], numz_integral)
            dz = (zgrid[2:] - zgrid[:-2]) / 2.0
            zg = zgrid[1:-1]
            vals = kernel['dndz'](zg) * (
                1.0 - chinow / self.comoving_radial_distance(zg))
            ret[i] = np.dot(dz, vals)
        return ret

    def _generate_window(self, tag, bias, magbias, numz_integral):
        k = self.kernels[tag]
        if bias is None:
            ret = self._lens_window(k, numz_integral)
            k['window_z'] = lambda z: np.interp(z, self.zs, ret)
            k['W'] = ret * self._lens_prefactor()
            k['type'] = 'lensing'
        else:
            # counts windows carry no H/c factor: the dz/dchi Jacobians are
            # folded into precalcFactor (reference cosmology.py:700-703)
            W = bias * k['dndz'](self.zs)
            W[self.zs < k['zmin']] = 0
            W[self.zs > k['zmax']] = 0
            k['W'] = W
            k['type'] = 'counts'
            if magbias is not None:
                # the magnification correction IS a lensing kernel
                # weighted by (5s - 2): use the same prefactor the
                # CAMB-validated kappa kernel uses (one 1/Hz). The
                # reference divides by Hz^2 (cosmology.py:710, flagged
                # there as "needs to be checked again") which
                # suppresses the term by ~Hz — a dimensional error we
                # deliberately do not reproduce.
                ret = self._lens_window(k, numz_integral)
                mag = ret * (5.0 * magbias - 2.0) * self._lens_prefactor()
                k['W'] = k['W'] + mag

    def addDeltaNz(self, tag, zsource, bias=None, magbias=None,
                   ignore_exists=False):
        if not ignore_exists and tag in self.kernels:
            raise ValueError("tag exists")
        if tag == "cmb":
            raise ValueError("'cmb' is reserved")
        self.kernels[tag] = {'dndz': "delta", 'zdelta': zsource}
        self._generate_window(tag, bias, magbias, None)

    def addStepNz(self, tag, zmin, zmax, bias=None, magbias=None,
                  numz_integral=300, ignore_exists=False):
        if not ignore_exists and tag in self.kernels:
            raise ValueError("tag exists")
        norm = zmax - zmin
        self.kernels[tag] = {'zmin': zmin, 'zmax': zmax,
                             'dndz': lambda z: np.ones_like(np.asarray(z)) / norm}
        self._generate_window(tag, bias, magbias, numz_integral)

    def addNz(self, tag, zs, nz, bias=None, magbias=None,
              numz_integral=300, ignore_exists=False):
        if not ignore_exists and tag in self.kernels:
            raise ValueError("tag exists")
        zs = np.asarray(zs)
        nz = np.asarray(nz)
        norm = np.trapezoid(nz, zs)
        self.kernels[tag] = {
            'dndz': lambda z: np.interp(z, zs, nz / norm, left=0, right=0),
            'zmin': zs.min(), 'zmax': zs.max()}
        self._generate_window(tag, bias, magbias, numz_integral)

    def generateCls(self, ellrange, autoOnly=False, zmin=0.0):
        """Limber quadrature over all kernel pairs: the hot loop of
        reference ``cosmology.py:570-595`` as one float64 (ell, z)
        computation on ``self.device``; ``Clmatrix`` holds host arrays.
        """
        f64 = dict(dtype=torch.float64, device=self.device)
        ells = torch.as_tensor(np.asarray(ellrange, dtype=np.float64), **f64)
        chis = torch.as_tensor(self.chis, **f64)
        sel = torch.as_tensor((self.zs >= zmin).astype(np.float64), **f64)
        dchis = torch.as_tensor(self.dchis, **f64)
        pre = torch.as_tensor(self.precalcFactor, **f64)
        logk_tab = torch.as_tensor(self._logk, **f64)
        logpk = torch.as_tensor(self._logpk_tab, **f64)
        zt = torch.as_tensor(self._pk_zt, **f64)
        zs = torch.as_tensor(self.zs, **f64)
        nzt, nk = logpk.shape

        # bilinear in (z, logk) on the log-P table, k = (ell + 1/2) / chi
        k = (ells[:, None] + 0.5) / chis[None, :]             # (nell, nz)
        w = ((k >= 1e-4) & (k < self.kmax)).to(torch.float64)
        logkq = torch.log(torch.clamp(k, min=1e-30))
        iz = _interp_index(zs, zt)
        iz0 = torch.clamp(iz.to(torch.int64), 0, nzt - 2)
        fz = iz - iz0
        ik = _interp_index(logkq, logk_tab)
        ik0 = torch.clamp(ik.to(torch.int64), 0, nk - 2)
        fk = ik - ik0
        v00 = logpk[iz0, ik0]
        v01 = logpk[iz0, ik0 + 1]
        v10 = logpk[iz0 + 1, ik0]
        v11 = logpk[iz0 + 1, ik0 + 1]
        lp = (v00 * (1 - fz) * (1 - fk) + v01 * (1 - fz) * fk
              + v10 * fz * (1 - fk) + v11 * fz * fk)
        common = w * torch.exp(lp) * pre * sel                # (nell, nz)

        keys = list(self.kernels.keys())
        if autoOnly:
            pairs = [(k1, k1) for k1 in keys]
        else:
            pairs = list(itertools.combinations_with_replacement(keys, 2))
        Ws = {k1: torch.as_tensor(np.asarray(self.kernels[k1]['W'],
                                             dtype=np.float64), **f64)
              for k1 in keys}
        out = torch.stack([(common * Ws[k1] * Ws[k2]) @ dchis
                           for k1, k2 in pairs], dim=1).cpu().numpy()
        self.Clmatrix = {f"{k1},{k2}": out[:, i]
                         for i, (k1, k2) in enumerate(pairs)}
        self.ellrange = np.asarray(ellrange)

    def getCl(self, key1, key2):
        try:
            return self.Clmatrix[key1 + "," + key2]
        except KeyError:
            return self.Clmatrix[key2 + "," + key1]


def get_limber_clkk_flat_universe(results, ells=None, lmax=2000,
                                  kmax=42.47, nz=1000, zsrc=None,
                                  device=None):
    """CMB lensing (or zsrc-source) kappa auto-Cl by Limber on a flat
    universe (reference ``cosmology.py:1719``). ``results`` is a
    :class:`Cosmology` (or LimberCosmology); a LimberCosmology built here
    runs its quadrature on ``device`` (``None``: the card)."""
    lc = results if isinstance(results, LimberCosmology) else None
    if lc is None:
        # carry over EVERYTHING that shapes P(k): a dropped
        # pkgrid_override would silently fall back to EH98 (the ~2-6%
        # error the override exists to remove)
        lc = LimberCosmology(params=results.params,
                             constants=getattr(results, "c", None),
                             lmax=lmax, numz=nz, kmax=kmax,
                             pkgrid_override=getattr(
                                 results, "pkgrid_override", None),
                             transfer=getattr(results, "_transfer_type",
                                              "eisenhu_osc"),
                             device=device)
    if zsrc is not None:
        lc.addDeltaNz('src', zsrc, ignore_exists=True)
        tag = 'src'
    else:
        tag = 'cmb'
    if ells is None:
        ells = np.arange(2, lmax)
    lc.generateCls(ells, autoOnly=False)
    return np.asarray(ells), lc.getCl(tag, tag)


class LensForecast:
    """Knox-formula S/N forecasting for K(appa)/S(hear)/G(alaxy)
    auto/cross spectra (reference ``cosmology.py:952``)."""

    def __init__(self, theory=None):
        from .theory import TheorySpectra
        self.theory = theory if theory is not None else TheorySpectra({})
        self.Nls: Dict[str, Callable] = {}

    def _load(self, spec, ells, cls, lpad=30000):
        self.theory.loadGenericCls(np.asarray(ells), np.asarray(cls), spec,
                                   lpad=lpad)

    def loadKK(self, ellsCls, Cls, ellsNls=None, Nls=None, lpad=30000):
        if ellsNls is not None:
            self.Nls['kk'] = lambda x: np.interp(
                np.asarray(x), np.asarray(ellsNls), np.asarray(Nls),
                left=np.inf, right=np.inf)
        self._load('kk', ellsCls, Cls, lpad)

    def loadGG(self, ellsCls, Cls, ngal=None, lpad=30000, ells_n=None,
               nells=None):
        if ells_n is None:
            self.Nls['gg'] = lambda x: np.asarray(x) * 0. + 1.0 / (ngal * 1.18e7)
        else:
            self.Nls['gg'] = lambda x: np.interp(np.asarray(x), ells_n, nells)
        self._load('gg', ellsCls, Cls, lpad)

    def loadSS(self, ellsCls, Cls, ngal, shapeNoise=0.3):
        sn = 0.3 if (shapeNoise is None or shapeNoise < 1e-9) else shapeNoise
        self.shapeNoise = sn
        self.Nls['ss'] = lambda x: np.asarray(x) * 0. + sn ** 2 / (2 * ngal * 1.18e7)
        self._load('ss', ellsCls, Cls)

    def loadSG(self, ellsCls, Cls):
        self._load('sg', ellsCls, Cls)

    def loadKG(self, ellsCls, Cls):
        self._load('kg', ellsCls, Cls)

    def loadKS(self, ellsCls, Cls):
        self._load('ks', ellsCls, Cls)

    def loadGenericCls(self, specType, ellsCls, Cls, ellsNls=None, Nls=None):
        if Nls is not None:
            self.Nls[specType] = lambda x: np.interp(
                np.asarray(x), np.asarray(ellsNls), np.asarray(Nls),
                left=np.inf, right=np.inf)
        self._load(specType, ellsCls, Cls)

    def _bin_cls(self, spec, ell_left, ell_right, noise=True, ntot=False):
        a, b = spec
        ells = np.arange(ell_left, ell_right + 1, 1)
        cls = np.asarray(self.theory.gCl(spec, ells))
        Noise = 0.0
        if noise and a == b:
            # loaders allow omitting the noise curve (unlike the
            # reference, where it was required positional): default to
            # the noiseless forecast instead of KeyError deep in the
            # covariance loop
            fn = self.Nls.get(spec)
            Noise = fn(ells) if fn is not None else 0.0
        tot = Noise if (ntot and a == b and noise) else cls + Noise
        return np.sum(ells * tot) / np.sum(ells)

    def KnoxCov(self, specTypeXY, specTypeWZ, ellBinEdges, fsky, ntot=False):
        """cov(Cl_XY, Cl_WZ) + per-bin (S/N)^2 (reference
        ``cosmology.py:1054``)."""
        X, Y = specTypeXY
        W, Z = specTypeWZ
        covs, sigs1, sigs2 = [], [], []
        for ell_left, ell_right in zip(ellBinEdges[:-1], ellBinEdges[1:]):
            ClSum = (self._bin_cls(X + W, ell_left, ell_right, ntot=ntot)
                     * self._bin_cls(Y + Z, ell_left, ell_right, ntot=ntot)
                     + self._bin_cls(X + Z, ell_left, ell_right, ntot=ntot)
                     * self._bin_cls(Y + W, ell_left, ell_right, ntot=ntot))
            ellMid = (ell_right + ell_left) / 2.0
            ellWidth = ell_right - ell_left
            var = ClSum / (2.0 * ellMid + 1.0) / ellWidth / fsky
            covs.append(var)
            s1 = self._bin_cls(specTypeXY, ell_left, ell_right, noise=False)
            s2 = self._bin_cls(specTypeWZ, ell_left, ell_right, noise=False)
            sigs1.append(s1 ** 2 * np.nan_to_num(1.0 / var))
            sigs2.append(s2 ** 2 * np.nan_to_num(1.0 / var))
        return np.array(covs), np.array(sigs1), np.array(sigs2)

    def sigmaClSquared(self, specType, ellBinEdges, fsky, ntot=False):
        return self.KnoxCov(specType, specType, ellBinEdges, fsky, ntot)[0]

    def sn(self, ellBinEdges, fsky, specType, ntot=False):
        """Total S/N and per-bin errors (reference ``cosmology.py:1087``)."""
        var, sigs1, _ = self.KnoxCov(specType, specType, ellBinEdges, fsky,
                                     ntot)
        return np.sqrt(sigs1.sum()), np.sqrt(var)


def noise_pad_infinity(nl_func, ellmin, ellmax):
    """Wrap a noise curve to be infinite outside [ellmin, ellmax]
    (reference ``cosmology.py:1170``)."""
    def f(x):
        x = np.asarray(x, dtype=float)
        out = np.asarray(nl_func(x), dtype=float)
        return np.where((x < ellmin) | (x > ellmax), np.inf, out)
    return f


def get_lensed_cls_exact(ells, ucltt, clkk, lmax=None, lmax_out=None,
                         ucl_ee=None, ucl_bb=None, ucl_te=None):
    """Lensed spectra from unlensed spectra and a (possibly modified)
    C_L^kk, via the curved-sky correlation-function method
    (:mod:`orphics_tpu_torch.models.lensed_cls`) — the exact replacement for
    the reference's ``camb.correlations.lensed_cls`` call at
    ``cosmology.py:1206`` (<0.15% vs CAMB for 30 < l < 3000).

    Returns ``(ells_out, lensed_tt)`` when only TT is given, else
    ``(ells_out, dict)`` with 'TT','EE','BB','TE'.
    """
    from .lensed_cls import lensed_cls as _lcls
    ells = np.asarray(ells, dtype=np.float64)
    if lmax is None:
        lmax = int(ells.max())
    lmax_out = lmax_out or lmax
    grid = np.arange(lmax + 1, dtype=np.float64)

    def regrid(c):
        if c is None:
            return np.zeros(lmax + 1)
        return np.interp(grid, ells, np.asarray(c, np.float64),
                         left=0, right=0)

    tt = regrid(ucltt)
    ee = regrid(ucl_ee)
    bb = regrid(ucl_bb)
    te = regrid(ucl_te)
    clkk_g = regrid(clkk)
    with np.errstate(divide="ignore", invalid="ignore"):
        pp = np.nan_to_num(4.0 * clkk_g / (grid * (grid + 1.0)) ** 2)
    out = _lcls(tt, ee, bb, te, pp, lmax=lmax, lmax_out=lmax_out)
    ells_out = np.arange(lmax_out + 1, dtype=np.float64)
    if ucl_ee is None and ucl_te is None:
        return ells_out, out["TT"]
    return ells_out, out


def get_lensed_cls(ells, ucltt, clkk, lmax=None, npix=2048,
                   px_res_arcmin=1.0, nterms=14, device=None):
    """Lensed TT spectrum from an unlensed spectrum and a (possibly
    modified) C_L^kk.

    Replaces the reference's ``camb.correlations``-based
    ``get_lensed_cls`` (``cosmology.py:1206``) with the flat-sky
    correlation-function method under isotropic Gaussian resummation
    (Seljak 1996): the lensed correlation function is

      xi~(r) = int d^2l/(2pi)^2 C_l e^{il.r} e^{-l^2 [sigma^2 - A(r)]/2},

    with A(r) the deflection correlation (FFT of l^2 Cphi) and
    sigma^2 = A(0). The l-r coupling is expanded in powers of A(r)
    (fast-converging; ``nterms`` terms), so the whole computation is a
    handful of 2D FFTs. Captures the acoustic-peak smoothing
    non-perturbatively; neglects the small anisotropic Cgl,2 term.

    The FFTs are host float64 numpy, as in the JAX package; the radial
    average is the port's ``Bin2D`` on ``device`` (``None``: the card,
    kernel B1), summed in float64 from the float32 plane.
    """
    from ..geometry import Geometry, arcmin

    dev = resolve(device)
    ells = np.asarray(ells, dtype=np.float64)
    ucltt = np.asarray(ucltt, dtype=np.float64)
    clkk = np.asarray(clkk, dtype=np.float64)
    if lmax is None:
        lmax = int(ells.max())
    d = px_res_arcmin * arcmin
    geom = Geometry(npix, npix, d, d)
    ml = geom.modlmap_np()
    with np.errstate(divide="ignore", invalid="ignore"):
        clphi = np.nan_to_num(4.0 * clkk / (ells * (ells + 1.0)) ** 2)
    C2 = np.interp(ml, ells, ucltt, left=0, right=0)
    P2 = np.interp(ml, ells, clphi, left=0, right=0)
    fac = geom.npix / geom.area  # sum over modes -> int d^2l/(2pi)^2

    A = np.fft.ifft2(ml ** 2 * P2).real * fac        # deflection corr A(r)
    sigma2 = A.flat[0]                                # A(r=0)
    u = 0.5 * ml ** 2 * sigma2                        # normalized exponent
    gauss = np.exp(-u)
    ratio = A / sigma2                                # |ratio| <= 1
    xi = np.zeros_like(A)
    rn = np.ones_like(A)
    term = np.ones_like(u)                            # u^n / n!, bounded
    for n in range(nterms):
        Tn = np.fft.ifft2(term * C2 * gauss).real * fac
        xi += rn * Tn
        rn = rn * ratio
        term = term * u / (n + 1)
    lensed2d = np.fft.fft2(xi).real / fac
    # radial average back to 1D at the grid's fundamental mode spacing
    from ..ops.binning import Bin2D
    dl = 2 * np.pi / (npix * d)
    edges = np.arange(2, min(lmax + 2 * dl, geom.lmax() - 2), dl) - 0.5 * dl
    binner = Bin2D(ml, edges, device=dev)
    cents, l1d = binner.bin(torch.as_tensor(lensed2d, dtype=torch.float32,
                                            device=dev))
    out_ells = np.arange(lmax + 1, dtype=np.float64)
    lensed = np.interp(out_ells, cents, l1d.cpu().numpy().astype(np.float64),
                       left=0, right=0)
    lensed[:2] = 0
    return out_ells, lensed


# ---------------------------------------------------------------------------
# Theory-matrix glue (reference cosmology.py:732, 747, 769, 1612, 1694)
# ---------------------------------------------------------------------------

def phi2kappa(ls):
    """phi -> kappa multipole factor l(l+1)/2 (reference
    ``cosmology.py:1694``); a tensor stays a tensor, anything else
    becomes host numpy."""
    if not isinstance(ls, torch.Tensor):
        ls = np.asarray(ls)
    return ls * (ls + 1.0) / 2.0


def unpack_cmb_theory(theory, ells, lensed=False):
    """(cltt, clee, clte, clbb) tuple from a TheorySpectra (reference
    ``cosmology.py:732``)."""
    get = theory.lCl if lensed else theory.uCl
    return (get("TT", ells), get("EE", ells), get("TE", ells),
            get("BB", ells))


def enmap_power_from_orphics_theory(theory, lmax=None, ells=None,
                                    lensed=False, dimensionless=True,
                                    orphics_dimensionless=True,
                                    TCMB=2.7255e6):
    """(3, 3, ...) TEB power matrix with the reference's dimensionless
    conversion conventions (reference ``cosmology.py:747``). ``ells``
    may be 1D or a 2D modlmap; host float64 numpy, or a float64 tensor on
    the device of a tensor ``ells``."""
    if orphics_dimensionless and not dimensionless:
        tmul = TCMB ** 2
    elif (not orphics_dimensionless) and dimensionless:
        tmul = 1.0 / TCMB ** 2
    else:
        tmul = 1.0
    if ells is None:
        ells = np.arange(0, lmax, 1)
    dev = ells.device if isinstance(ells, torch.Tensor) else None
    if dev is not None:
        ells = ells.detach().cpu().numpy()
    cltt, clee, clte, clbb = (np.asarray(c, np.float64) for c in
                              unpack_cmb_theory(theory, np.asarray(ells),
                                                lensed=lensed))
    z = np.zeros_like(cltt)
    ps = np.stack([np.stack([cltt, clte, z]), np.stack([clte, clee, z]),
                   np.stack([z, z, clbb])]) * tmul
    return ps if dev is None else torch.as_tensor(ps, device=dev)


def loadTheorySpectraFromPycambResults(results, pars, kellmax,
                                       unlensedEqualsLensed=False,
                                       useTotal=False, TCMB=2.7255e6,
                                       lpad=9000, get_dimensionless=True,
                                       **_ignored):
    """Build a TheorySpectra from a pycamb ``results`` object (reference
    ``cosmology.py:769``). Requires the optional ``camb`` dependency
    only to *produce* ``results`` — this function just unpacks the
    standard ``get_cmb_power_spectra`` dict, so any object with that
    method (or a plain dict of the same arrays) works.
    """
    from .theory import TheorySpectra
    tmul = 1.0 if get_dimensionless else TCMB ** 2
    if hasattr(results, "get_cmb_power_spectra"):
        cmbmat = results.get_cmb_power_spectra(pars)
    else:
        cmbmat = results
    lkey = "total" if useTotal else "lensed_scalar"
    ukey = "unlensed_total" if useTotal else "unlensed_scalar"
    theory = TheorySpectra(tables={}, lpad=lpad)
    for which, key in (("l", lkey), ("u", ukey)):
        if which == "u" and unlensedEqualsLensed:
            key = lkey
        mat = np.asarray(cmbmat[key])
        ells = np.arange(mat.shape[0])
        with np.errstate(divide="ignore", invalid="ignore"):
            norm = np.nan_to_num(2.0 * np.pi / ells / (ells + 1.0))
        for i, pol in enumerate(("TT", "EE", "BB", "TE")):
            cls = mat[:, i] * norm * tmul
            sel = ells < kellmax
            theory.loadCls(ells[sel], cls[sel], pol,
                           lensed=(which == "l"), lpad=lpad)
    # the lensing-potential 'kk' table the reference loads too
    # (cosmology.py:830-840): clkk = (2pi/4) * [l(l+1)]^2 C_phi / 2pi
    # from ell 2 — downstream gCl('kk') consumers (lenspipe,
    # FlatLensingSims) require it
    lp = None
    if hasattr(results, "get_lens_potential_cls"):
        lp = np.asarray(results.get_lens_potential_cls(lmax=lpad))
    elif isinstance(cmbmat, dict) and "lens_potential" in cmbmat:
        lp = np.asarray(cmbmat["lens_potential"])
    if lp is not None:
        clphi = lp[2:, 0]
        clkk = clphi * (2.0 * np.pi / 4.0)
        ells_k = np.arange(2, len(clkk) + 2)
        sel = ells_k < kellmax
        theory.loadGenericCls(ells_k[sel], clkk[sel], "kk", lpad=lpad)
    theory.dimensionless = bool(get_dimensionless)
    return theory


def get_lss_cls(windows, lmax, nonlinear=True, params=None, device=None):
    """Limber auto/cross Cls for a dict of LSS windows (the role of
    reference ``cosmology.py:1612``, natively via LimberCosmology
    instead of camb.sources; the nonlinear flag is accepted for
    signature parity — the native P(k) is linear/EH98 unless a
    ``pkgrid_override`` table is installed).

    windows: name -> dict with ``stype`` ('counts'|'lensing'), and
    either ``wtype='gaussian'`` (zmean, zsigma) or ``wtype='spline'``
    (zs, dndz); counts windows take a bias ``b``.
    Returns dict of 'name1,name2' -> Cl arrays over ells = 0..lmax; the
    quadrature runs on ``device`` (``None``: the card).
    """
    lc = LimberCosmology(params=dict(params or {}), lmax=lmax,
                         device=device)
    for key, ws in dict(windows).items():
        if ("P" in key) or ("x" in key):
            raise ValueError("window names may not contain 'P' or 'x'")
        stype = ws["stype"].strip().lower()
        if stype not in ("counts", "lensing"):
            raise ValueError(f"unknown stype {ws['stype']!r}: expected "
                             "'counts' or 'lensing'")
        if stype == "counts":
            # missing bias must not silently become a LENSING window
            # (bias=None is the lensing branch in addNz)
            if "b" not in ws or ws["b"] is None:
                raise KeyError(f"counts window {key!r} needs a bias 'b'")
            bias = ws["b"]
        else:
            bias = None
        wtype = ws["wtype"].strip().lower()
        if wtype == "gaussian":
            zs = np.linspace(max(ws["zmean"] - 5 * ws["zsigma"], 1e-3),
                             ws["zmean"] + 5 * ws["zsigma"], 160)
            dndz = np.exp(-0.5 * ((zs - ws["zmean"]) / ws["zsigma"]) ** 2)
        elif wtype == "spline":
            zs = np.asarray(ws["zs"])
            dndz = np.asarray(ws["dndz"])
        else:
            raise ValueError(wtype)
        # bias=None -> lensing window, else galaxy-counts window (the
        # LimberCosmology convention, mirroring the reference)
        lc.addNz(key, zs, dndz, bias=(None if stype == "lensing"
                                      else bias))
    ells = np.arange(lmax + 1, dtype=np.float64)
    lc.generateCls(ells)
    out = {}
    names = list(dict(windows).keys())
    for i, a in enumerate(names):
        for b in names[i:]:
            out[f"{a},{b}"] = np.asarray(lc.getCl(a, b))
    return out


def fk_comparison(param, z, val1, val2, oparams=None, ks=None,
                  plot_file=None):
    """Fractional change of the growth rate f(k->scale-indep) between
    two values of a parameter (reference ``cosmology.py`` comparison
    helper, natively via the ODE growth solution). Returns (ks, ratio).
    """
    from .rsd import growth_rate
    ks = np.logspace(-4, np.log10(0.3), 500) if ks is None else ks
    out = []
    for val in (val1, val2):
        params = dict(oparams or {})
        params[param] = val
        cc = Cosmology(params)
        out.append(growth_rate(cc, z))
    ratio = np.full(len(ks), out[1] / out[0])
    if plot_file:
        from ..utils.plot import Plotter
        pl = Plotter(xlabel="$k$", ylabel="$f_2/f_1$", xscale="log")
        pl.add(ks, ratio)
        pl.done(plot_file)
    return ks, ratio


def pk_comparison(param, z, val1, val2, oparams=None, ks=None,
                  plot_file=None):
    """Fractional change of P(k, z) between two parameter values
    (reference ``cosmology.py`` ``pk_comparison``, natively).
    Returns (ks, P2/P1)."""
    ks = np.logspace(-4, np.log10(0.3), 500) if ks is None else ks
    pks = []
    for val in (val1, val2):
        params = dict(oparams or {})
        params[param] = val
        cc = Cosmology(params)
        pks.append(np.asarray(cc.P_lin(np.asarray(ks), z)))
    ratio = pks[1] / pks[0]
    if plot_file:
        from ..utils.plot import Plotter
        pl = Plotter(xlabel="$k$", ylabel="$P_2/P_1$", xscale="log")
        pl.add(ks, ratio)
        pl.done(plot_file)
    return ks, ratio


def get_camb_lens_obj(nz, kmax, zmax=None):
    """(zs, chis) sampling for Limber integration (the role of
    reference ``cosmology.py`` ``get_camb_lens_obj``, natively from the
    background cosmology instead of a camb results object): ``nz``
    points equally spaced in comoving distance from today to ``zmax``
    (or to recombination)."""
    cc = Cosmology()
    zmax = zmax if zmax is not None else cc.cmbZ
    chistar = cc.comoving_radial_distance(zmax)
    chis = np.linspace(0, chistar, nz)
    zs = np.asarray([cc.redshift_at_comoving_radial_distance(c)
                     for c in chis[1:]])
    zs = np.concatenate([[0.0], zs])
    return dict(chis=chis, zs=zs, kmax=kmax, cosmology=cc)


def load_theory_from_glens(out_name, total=False, lpad=9000,
                           TCMB=2.7255e6):
    """TheorySpectra (with gradient Cls as generic entries) from the
    text files written by a glens/camb dump (reference ``cosmology.py``
    ``load_theory_from_glens``): ``<out_name>_gradient.txt`` plus
    ``<out_name>_{lensed_scalar|total}.txt`` and
    ``<out_name>_unlensed_scalar.txt``."""
    from .theory import TheorySpectra
    gcls = np.loadtxt(f"{out_name}_gradient.txt")
    lcls = np.loadtxt(f"{out_name}_{'total' if total else 'lensed_scalar'}.txt")
    theory = TheorySpectra(tables={}, lpad=lpad)
    lells = np.arange(2, len(lcls[2:, 0]) + 2)
    with np.errstate(divide="ignore", invalid="ignore"):
        lnorm = 2 * np.pi / lells / (lells + 1.0)
    for i, pol in enumerate(("TT", "EE", "BB", "TE")):
        theory.loadCls(lells, lcls[2:, i] * lnorm, pol, lensed=True,
                       lpad=lpad)
    try:
        ucls = np.loadtxt(f"{out_name}_unlensed_scalar.txt")
        for i, pol in enumerate(("TT", "EE", "BB", "TE")):
            theory.loadCls(lells, ucls[2:, i] * lnorm, pol, lensed=False,
                           lpad=lpad)
    except OSError:
        for i, pol in enumerate(("TT", "EE", "BB", "TE")):
            theory.loadCls(lells, lcls[2:, i] * lnorm, pol, lensed=False,
                           lpad=lpad)
    gells = np.arange(2, len(gcls[2:, 0]) + 2)
    # gradient files are raw_cl in muK^2: convert to dimensionless
    for i, pol in enumerate(("TT", "EE", "BB", "TE")):
        theory.loadGenericCls(gells, gcls[2:, i] / TCMB ** 2,
                              f"gCl_grad_{pol}", lpad=lpad)
    return theory


def save_glens_cls_from_ini(ini_file, out_name, glmax=8000):
    """camb-glue dump of lensed-gradient Cls (reference
    ``cosmology.py`` ``save_glens_cls_from_ini``); requires the
    optional ``camb`` package, exactly like the reference."""
    import camb
    from camb import model
    pars = camb.read_ini(ini_file)
    pars.NonLinear = model.NonLinear_both
    pars.set_for_lmax(lmax=10000, lens_potential_accuracy=1)
    results = camb.get_results(pars)
    spec = results.get_cmb_power_spectra(pars)
    gcls = results.get_lensed_gradient_cls(lmax=glmax, CMB_unit="muK",
                                           raw_cl=True)
    for key in spec:
        np.savetxt(f"{out_name}_{key}.txt", spec[key])
    np.savetxt(f"{out_name}_gradient.txt", gcls)


def class_cls(lmax, params=None, cosmo=None, zmin=None, zmax=None,
              bias=None, dndz_file=None):
    """CLASS number-count Cls (reference ``cosmology.py:1361``
    ``class_cls``): same parameter assembly (tophat selection from
    [zmin, zmax], optional dN/dz file and param overrides) and the same
    ``(retcls, cosmo, params)`` return with 'kg'/'kk'/'gg'/'ells' keys.
    Runs when the optional ``classy`` package is installed; the
    dependency-free equivalent is :func:`get_lss_cls` (native Limber).
    """
    from classy import Class  # optional dep, same gate as reference
    smean = (zmin + zmax) / 2.0
    shalf = (zmax - zmin) / 2.0
    oparams = {
        "output": "tCl lCl dCl",
        "l_max_scalars": lmax,
        "lensing": "yes",
        "A_s": 2.3e-9,
        "n_s": 0.9624,
        "h": 0.6711,
        "omega_b": 0.022068,
        "omega_cdm": 0.12029,
        "selection": "tophat",
        "selection_mean": f"{smean:f}",
        "selection_width": f"{shalf:f}",
        "selection_bias": f"{bias:f}",
        "number count contributions": "density, rsd, lensing, gr",
        "l_max_lss": lmax,
    }
    if dndz_file is not None:
        oparams["dNdz_selection"] = str(dndz_file)
    if params is not None:
        oparams.update(params)
    if cosmo is None:
        cosmo = Class()
        cosmo.set(oparams)
        cosmo.compute()
    cls = cosmo.density_cl(lmax)
    cls2 = cosmo.lensed_cl(lmax)
    ells = np.asarray(cls["ell"], dtype=float)
    lfact = ells * (ells + 1.0) / 2.0
    return ({"kg": np.asarray(cls["pd"][0]) * lfact,
             "kk": np.asarray(cls2["pp"]) * lfact ** 2,
             "gg": np.asarray(cls["dd"][0]),
             "ells": ells}, cosmo, params)


class ClassCosmology:
    """Explicitly unsupported: the reference's ``ClassCosmology``
    (``cosmology.py:1414``) is dead code upstream — its ``__init__``
    references undefined names (``lmax``/``smean``/...) and raises
    ``NameError`` on any instantiation, so there is no working behavior
    to match. Use the native :class:`Cosmology` / :class:`LimberCosmology`
    (background/growth/Limber without CLASS), or :func:`class_cls` for
    the CLASS number-count spectra when ``classy`` is installed."""

    def __init__(self, *a, **kw):
        raise NotImplementedError(
            "ClassCosmology is unsupported (broken in the reference "
            "itself); use Cosmology/LimberCosmology (native) or "
            "class_cls(...) with classy installed")


class CAMB:
    """Driver for the python ``camb`` package with the reference's
    parameter plumbing (reference ``cosmology.py:70``): accepts the
    ``defaultCosmology`` dict schema (``theta100`` overrides ``H0``,
    ``w0/wa`` dark energy, optional transfer/power computation) and
    exposes ``.pars``, ``.results`` and — with ``perturbations`` —
    ``.powers`` (raw Cls in muK^2).

    Gated: ``camb`` is an optional dependency not shipped in this
    build. The framework's native theory path is :class:`Cosmology` /
    :class:`LimberCosmology` with the shipped high-accuracy tables
    (``load_camb_pk`` / ``theory.default_theory``).
    """

    def __init__(self, params=None, perturbations=False, redshifts=(0.0,),
                 nonlinear=True, kmax=2.0, lmax=2000,
                 lens_potential_accuracy=1, raw_cl=True):
        try:
            import camb
            from camb import model
        except ImportError as e:
            raise ImportError(
                "the CAMB driver needs the python 'camb' package; the "
                "native equivalents are Cosmology/LimberCosmology with "
                "the shipped tables (see load_camb_pk, "
                "theory.default_theory)") from e
        p = dict(defaultCosmology)
        p.update(params or {})
        pars = camb.CAMBparams(want_zstar=True)
        pars.set_dark_energy(w=p['w0'], wa=p['wa'])
        theta = p.get('theta100')
        pars.set_cosmology(
            H0=None if theta is not None else p['H0'],
            cosmomc_theta=theta / 100.0 if theta is not None else None,
            ombh2=p['ombh2'], omch2=p['omch2'], mnu=p['mnu'],
            tau=p['tau'], nnu=p['nnu'])
        if perturbations:
            pars.InitPower.set_params(ns=p['ns'], As=p['As'])
            pars.WantTransfer = True
            pars.NonLinear = (model.NonLinear_both if nonlinear
                              else model.NonLinear_none)
            pars.set_for_lmax(
                lmax=lmax + 500,
                lens_potential_accuracy=(lens_potential_accuracy
                                         if nonlinear else 0))
            pars.set_matter_power(redshifts=list(redshifts), kmax=kmax)
        else:
            pars.WantTransfer = False
        self.pars = pars
        self.results = camb.get_background(pars)
        if perturbations:
            self.results.calc_transfers(pars)
            self.results.calc_power_spectra(pars)
            self.powers = self.results.get_cmb_power_spectra(
                pars, CMB_unit='muK', raw_cl=raw_cl)
