"""Foreground SEDs, power templates, ILC noise forecasts, multi-frequency
spectrum fitting (port of ``orphics_tpu.models.foregrounds``: the same
host numpy code, its templates read from ``orphics_tpu/data`` by path).

Re-design of reference ``orphics/foregrounds.py``: SED unit conversions
(``dBnudT/ItoDeltaT`` :54-62, after tilec/fg.py), tSZ spectral functions
(``g_tsz/ffunc`` :72,603), template spectra from the shipped data files
(``power_y_template`` :103, ``power_ksz_reion/late`` :614,621), Lagache+19
radio source counts and (cross) power (``get_radio_power`` :224,
``parse_Kij_file`` :310), DR6-style dust (``dust_mu``/
``dust_C_ell_Louis25`` :1232,1242), ILC noise forecasts (``ilc_power``
:492, ``get_ilc_noise``/``get_official_ilc_noise`` :550,541) and the
bounded least-squares multi-frequency fit (``quick_fit/fg_fit`` :802,850).

All template evaluation is host numpy (setup-time); the resulting curves
are fed into the ILC/covariance pipelines as static tables.
"""
from __future__ import annotations

import glob
import itertools
import os
import warnings
import numpy as np

from ..geometry import arcmin

from .theory import DATA_DIR

__all__ = ["default_constants", "dBnudT", "ItoDeltaT", "planck", "g_tsz",
           "ffunc", "cltsz", "dl_filler", "power_y_template",
           "power_ksz_reion", "power_ksz_late", "power_cibp", "power_cibc",
           "power_radps", "get_radio_differential_source_counts",
           "get_radio_power", "parse_Kij_file", "dust_mu",
           "dust_C_ell_Louis25", "get_official_ilc_noise", "get_ilc_noise",
           "ilc_power", "fg_cl", "get_noise", "sky_model", "wnoise_cl",
           "fg_fit", "quick_fit", "evaluate_model_dict", "fg_dict",
           "model_vec", "fit_cross_leastsq", "power_tsz"]

default_constants = {
    'A_tsz': 5.6, 'TCMB': 2.726, 'nu0': 150., 'TCMBmuk': 2.726e6,
    'Td': 24., 'al_cib': 1.2, 'A_cibp': 6.9, 'A_cibc': 4.9, 'n_cib': 1.2,
    'ell0sec': 3000., 'A_ps': 3.1, 'al_ps': -0.5, 'zeta': 0.1,
}

TCMB = 2.726
TCMB_uK = 2.726e6
hplanck = 6.626068e-34
kboltz = 1.3806503e-23
clight = 299792458.0


# ------------------------------------------------------------------
# SED units (reference foregrounds.py:54-76; after tilec/fg.py)
# ------------------------------------------------------------------

def dBnudT(nu_ghz):
    """Blackbody derivative, 1e-26 Jy/sr per uK_CMB."""
    nu = 1e9 * np.asarray(nu_ghz)
    X = hplanck * nu / (kboltz * TCMB)
    return (2.0 * hplanck * nu ** 3) / clight ** 2 \
        * np.exp(X) / (np.expm1(X)) ** 2 * X / TCMB_uK


def ItoDeltaT(nu_ghz):
    """1e-26 Jy/sr -> uK_CMB conversion."""
    return 1.0 / dBnudT(nu_ghz)


def planck(nu_hz, T):
    """Planck intensity B_nu (W m^-2 Hz^-1 sr^-1)."""
    x = hplanck * np.asarray(nu_hz) / (kboltz * T)
    return (2.0 * hplanck * np.asarray(nu_hz) ** 3 / clight ** 2) / np.expm1(x)


def g_tsz(nu_ghz, T_cmb=TCMB):
    """tSZ spectral function x coth(x/2) - 4 (dimensionless); the
    coth form is overflow-free for any x. Uses the CODATA h/k the
    reference's ``g_tsz`` takes from scipy.constants (:72-74)."""
    x = (6.62607015e-34 * np.asarray(nu_ghz) * 1e9) / (1.380649e-23 * T_cmb)
    return x / np.tanh(x / 2.0) - 4.0


# same spectral function, CGS constant set — the reference keeps BOTH
# (``ffunc``, :603, with H_CGS/K_CGS, feeds power_y_template; ``g_tsz``
# with CODATA h/k feeds cltsz), and they differ in the 6th digit
H_CGS = 6.62608e-27
K_CGS = 1.3806488e-16


def ffunc(nu, tcmb=None):
    """tSZ frequency function with the szar CGS constants (reference
    ``foregrounds.py:603``)."""
    if tcmb is None:
        tcmb = default_constants['TCMB']
    mu = H_CGS * (1e9 * np.asarray(nu)) / (K_CGS * tcmb)
    return mu / np.tanh(mu / 2.0) - 4.0


def cltsz(atsz, nu1, nu2, clyy):
    """tSZ TT power from a Compton-y spectrum (reference :76)."""
    return atsz * g_tsz(nu1) * g_tsz(nu2) * np.asarray(clyy) * TCMB_uK ** 2


# ------------------------------------------------------------------
# template spectra from shipped data files
# ------------------------------------------------------------------

def dl_filler(ells, ls, cls, fill_type="extrapolate", fill_positive=False,
              silence=False):
    """Interpolate a D_l template onto ``ells`` with an explicit
    out-of-range fill policy (the role of reference :80):

    - ``"extrapolate"``: linear extrapolation from the end segments,
    - ``"constant_dl"``: 0 below the table, last value above it,
    - ``"zeros"``: 0 outside the table.
    """
    ells = np.asarray(ells, dtype=float)
    ls = np.asarray(ls, dtype=float)
    cls = np.asarray(cls, dtype=float)
    if ls.size > 1 and np.any(np.diff(ls) < 0):
        order = np.argsort(ls)           # np.interp needs ascending xp
        ls, cls = ls[order], cls[order]
    if not silence and ells.max() > ls.max():
        warnings.warn("Requested ells above available range; filling per "
                      f"fill_type={fill_type}")
    out = np.interp(ells, ls, cls)       # linear inside, clamped outside
    lo = ells < ls[0]
    hi = ells > ls[-1]
    if fill_type == "extrapolate" and ls.size > 1:
        out[lo] = cls[0] + (cls[1] - cls[0]) / (ls[1] - ls[0]) * (
            ells[lo] - ls[0])
        out[hi] = cls[-1] + (cls[-1] - cls[-2]) / (ls[-1] - ls[-2]) * (
            ells[hi] - ls[-1])
    elif fill_type == "extrapolate":
        pass                             # 1-point table: clamp
    elif fill_type == "constant_dl":
        out[lo] = 0.0
        out[hi] = cls[-1]
    elif fill_type == "zeros":
        out[lo | hi] = 0.0
    else:
        raise ValueError(fill_type)
    if fill_positive:
        out[out < 0] = 0
    return out


def _dl_to_cl(ells, dls):
    # the monopole (and any ell<=0 entry) carries no D_l information:
    # map it to Cl=0 rather than letting 1/0 -> inf -> 1.8e308 poison
    # downstream covariances
    ells = np.asarray(ells, np.float64)
    fac = np.zeros(np.broadcast(ells, dls).shape, np.float64)
    pos = ells > 0
    fac[..., pos] = 2 * np.pi / (ells[pos] * (ells[pos] + 1.0))
    return dls * fac


from functools import lru_cache as _lru_cache


@_lru_cache(maxsize=8)
def _load_template(fname, delimiter=None):
    """Disk templates load ONCE per process (fg_fit evaluates the model
    thousands of times inside least_squares — file I/O must not sit in
    that loop)."""
    return np.loadtxt(os.path.join(DATA_DIR, "foregrounds", fname),
                      unpack=True, delimiter=delimiter)


def power_y_template(ells, A_tsz=None, fill_type="extrapolate", silence=False):
    """Compton-y power from the Battaglia template (reference :103)."""
    if A_tsz is None:
        A_tsz = default_constants['A_tsz']
    ells = np.asarray(ells)
    ls, icls = _load_template("sz_template_battaglia.csv",
                              delimiter=",")
    dls = dl_filler(ells, ls, icls, fill_type, fill_positive=True,
                    silence=silence)
    return A_tsz * _dl_to_cl(ells, dls) / ffunc(150.0) ** 2 / TCMB_uK ** 2


def power_tsz(ells, nu1, nu2, A_tsz=None, fill_type="extrapolate",
              silence=False):
    """tSZ TT cross power in uK^2 between two frequencies."""
    clyy = power_y_template(ells, A_tsz=1.0, fill_type=fill_type,
                            silence=silence)
    A = default_constants['A_tsz'] if A_tsz is None else A_tsz
    return cltsz(A, nu1, nu2, clyy)


def power_ksz_reion(ells, A_rksz=1, fill_type="extrapolate", silence=True):
    ells = np.asarray(ells)
    ls, icls = _load_template("early_ksz.txt")
    dls = dl_filler(ells, ls, icls, fill_type, fill_positive=True,
                    silence=silence)
    return A_rksz * _dl_to_cl(ells, dls)


def power_ksz_late(ells, A_lksz=1, fill_type="extrapolate", silence=True):
    ells = np.asarray(ells)
    ls, icls = _load_template("late_ksz.txt")
    dls = dl_filler(ells, ls, icls, fill_type, fill_positive=True,
                    silence=silence)
    return A_lksz * _dl_to_cl(ells, dls)


# ------------------------------------------------------------------
# CIB (modified blackbody SED, Dunkley-style power laws — the szar
# power_cibp/power_cibc capability the reference imports)
# ------------------------------------------------------------------

def _cib_mu(nu_ghz, beta=None, Td=None):
    beta = default_constants['al_cib'] if beta is None else beta
    Td = default_constants['Td'] if Td is None else Td
    nu = np.asarray(nu_ghz, dtype=float)
    return nu ** beta * planck(nu * 1e9, Td) * ItoDeltaT(nu)


def power_cibp(ells, nu1, nu2=None, A_cibp=None):
    """Poisson CIB: flat C_l with D_3000 amplitude A_cibp at 150 GHz."""
    if nu2 is None:
        nu2 = nu1
    A = default_constants['A_cibp'] if A_cibp is None else A_cibp
    ells = np.asarray(ells, dtype=float)
    mu0 = _cib_mu(default_constants['nu0'])
    f = _cib_mu(nu1) * _cib_mu(nu2) / mu0 ** 2
    cl3000 = A * 2 * np.pi / (3000.0 * 3001.0)
    return np.full(ells.shape, cl3000 * f)


def power_cibc(ells, nu1, nu2=None, A_cibc=None, n_cib=None):
    """Clustered CIB: D_l = A (l/3000)^(2 - n_cib)."""
    if nu2 is None:
        nu2 = nu1
    A = default_constants['A_cibc'] if A_cibc is None else A_cibc
    n = default_constants['n_cib'] if n_cib is None else n_cib
    ells = np.asarray(ells, dtype=float)
    mu0 = _cib_mu(default_constants['nu0'])
    f = _cib_mu(nu1) * _cib_mu(nu2) / mu0 ** 2
    with np.errstate(divide="ignore", invalid="ignore"):
        # posinf=0: for n > 2 the ell=0 power-law is 0**neg -> inf,
        # and the monopole must not carry 1.8e308 into covariances
        dl = A * np.nan_to_num((ells / 3000.0) ** (2.0 - n), posinf=0.0)
    return _dl_to_cl(ells, dl) * f


# ------------------------------------------------------------------
# radio sources (Lagache et al 2019 counts; reference :198-330)
# ------------------------------------------------------------------

def get_radio_differential_source_counts(fluxes_mJy, freq_ghz):
    """dN/dS in 1/mJy/sr at the tabulated frequency closest to freq_ghz."""
    from scipy.interpolate import interp1d
    rpath = os.path.join(DATA_DIR, "radio_counts")
    files = glob.glob(os.path.join(rpath, "ns*_radio.dat"))
    freqs = np.asarray(sorted(float(os.path.basename(f).split("_")[0][2:])
                              for f in files))
    closest = int(freqs[np.argmin(np.abs(freqs - freq_ghz))])
    fluxes_Jy, nS = np.loadtxt(os.path.join(rpath, f"ns{closest}_radio.dat"),
                               unpack=True)
    return interp1d(fluxes_Jy * 1000, nS / 1000, kind="cubic")(fluxes_mJy)


def parse_Kij_file():
    """Lagache 2019 cross-power polynomial coefficients (reference :310)."""
    fname = os.path.join(DATA_DIR, "radio_counts", "Para_6degPol_XPS_Scut.dat")
    Kijs = {}
    key = None
    with open(fname) as f:
        for line in f:
            elems = line.split()
            if len(elems) == 2:
                key = (int(elems[0]), int(elems[1]))
                Kijs[key] = []
            else:
                Kijs[key].append(np.asarray([float(e) for e in elems]))
    return {k: np.asarray(v) for k, v in Kijs.items()}


def get_radio_power(flux_limit_mJy, freq_ghz, flux_limit_mJy_2=None,
                    freq_ghz_2=None, flux_min_mJy=1.6e-2, num_flux=10000,
                    prefit=True, units_Jy_sr=False, zero_above_ghz=200.0):
    """(Cross-)power of unresolved radio sources in uK^2-sr
    (reference ``foregrounds.py:224``)."""
    f2 = freq_ghz if freq_ghz_2 is None else freq_ghz_2
    if freq_ghz > zero_above_ghz or f2 > zero_above_ghz:
        return 0.0
    if (freq_ghz_2 is not None) != (flux_limit_mJy_2 is not None):
        # a second frequency without its flux limit (or vice versa)
        # would silently return an auto power with a mixed-frequency
        # unit conversion
        raise ValueError("cross radio power needs BOTH freq_ghz_2 and "
                         "flux_limit_mJy_2")
    cross = flux_limit_mJy_2 is not None
    if cross and abs(freq_ghz - f2) < 1e-3:
        if abs(flux_limit_mJy - flux_limit_mJy_2) > 1e-3:
            raise ValueError("same freq but different flux limits")
        cross = False
    if cross and not prefit:
        raise NotImplementedError(
            "cross-frequency radio power is only available from the "
            "prefit Kij tables (reference behavior)")
    if not prefit and not cross:
        fluxes = np.geomspace(flux_min_mJy, flux_limit_mJy, num_flux)
        nS = get_radio_differential_source_counts(fluxes, freq_ghz)
        ps = np.trapezoid(nS * fluxes ** 2, fluxes) * 1e-6  # (Jy/sr)^2 sr
    elif not cross:
        rpath = os.path.join(DATA_DIR, "radio_counts")
        freqs, logAs, logS0s, alphas, betas = np.loadtxt(
            os.path.join(rpath, "auto_fit_vals.dat"), unpack=True,
            delimiter=",")
        idx = np.argmin(np.abs(freqs - freq_ghz))
        A, S0 = 10.0 ** logAs[idx], 10.0 ** logS0s[idx]
        Slim = flux_limit_mJy * 1e-3
        ps = Slim * 2 * A / ((Slim / S0) ** alphas[idx]
                             + (Slim / S0) ** betas[idx])
    else:
        Kijs = parse_Kij_file()
        pfreqs = np.asarray([30, 44, 70, 100, 143, 217, 353, 545, 857])
        c1 = int(pfreqs[np.argmin(np.abs(pfreqs - freq_ghz))])
        c2 = int(pfreqs[np.argmin(np.abs(pfreqs - f2))])
        Kij = Kijs.get((c1, c2), Kijs.get((c2, c1)))
        t1 = (np.log10(flux_limit_mJy * 1e-3) + 3) / 0.2
        t2 = (np.log10(flux_limit_mJy_2 * 1e-3) + 3) / 0.2
        logC = sum(Kij[i, j] * t1 ** j * t2 ** i
                   for i in range(7) for j in range(7))
        ps = 10.0 ** logC
    if units_Jy_sr:
        return ps
    return ps * (1e-26) ** 2 * ItoDeltaT(freq_ghz) * ItoDeltaT(f2)


def power_radps(ells, nu1, nu2, flim1_mJy=7.0, flim2_mJy=None):
    """Radio Poisson power painted flat in C_l."""
    flim2 = flim1_mJy if flim2_mJy is None else flim2_mJy
    ps = get_radio_power(flim1_mJy, nu1, flux_limit_mJy_2=flim2,
                         freq_ghz_2=nu2)
    return np.full(np.asarray(ells).shape, ps)


# ------------------------------------------------------------------
# dust (reference :1232-1300)
# ------------------------------------------------------------------

def _planck_Bnu_ratio(nu_ghz, nu0_ghz, T):
    return planck(np.asarray(nu_ghz) * 1e9, T) / planck(nu0_ghz * 1e9, T)


def _g_nu_ratio(nu_ghz, nu0_ghz):
    """dB/dT(nu0)/dB/dT(nu): converts the MBB ratio into K_CMB units."""
    return dBnudT(nu0_ghz) / dBnudT(nu_ghz)


def dust_mu(nu_ghz, beta_d=1.5, Tdust_K=19.6, nu0_ghz=353.0):
    """Modified-blackbody SED ratio in K_CMB units (reference :1232)."""
    nu = np.asarray(nu_ghz, dtype=float)
    return ((nu / nu0_ghz) ** beta_d * _planck_Bnu_ratio(nu, nu0_ghz, Tdust_K)
            * _g_nu_ratio(nu, nu0_ghz))


def dust_C_ell_Louis25(ell, nu_i_ghz, nu_j_ghz, a_amp, XY="TT", alpha=None,
                       beta_d=1.5, Tdust_K=19.6, ell0=500.0, nu0_ghz=353.0):
    """DR6-style dust power (reference :1242)."""
    if alpha is None:
        alpha = -0.6 if XY.upper() == "TT" else -0.4
    ell = np.asarray(ell, dtype=float)
    scale = np.zeros_like(ell)
    pos = ell > 0
    scale[pos] = (ell[pos] / ell0) ** alpha
    s_i = dust_mu(nu_i_ghz, beta_d, Tdust_K, nu0_ghz)
    s_j = dust_mu(nu_j_ghz, beta_d, Tdust_K, nu0_ghz)
    D = a_amp * scale * s_i * s_j
    C = np.zeros_like(D)
    valid = ell >= 2
    C[valid] = D[valid] * 2 * np.pi / (ell[valid] * (ell[valid] + 1))
    return C


# ------------------------------------------------------------------
# standard fg dictionary for covariance builders
# ------------------------------------------------------------------

def fg_dict(flux_limits_mJy=None, freqs=None):
    """dict of component -> f(ells, nu1, nu2) callables for
    :func:`orphics_tpu.models.ilc.ilc_cov` (reference ilc_power's fdict,
    ``foregrounds.py:505-513``)."""
    def flim(nu):
        if flux_limits_mJy is None:
            return 7.0
        return np.asarray(flux_limits_mJy)[
            np.argmin(np.abs(np.asarray(freqs) - nu))]

    return {
        'tsz': lambda ells, nu1, nu2: power_tsz(ells, nu1, nu2),
        'cibc': lambda ells, nu1, nu2: power_cibc(ells, nu1, nu2),
        'cibp': lambda ells, nu1, nu2: power_cibp(ells, nu1, nu2),
        'radps': lambda ells, nu1, nu2: power_radps(
            ells, nu1, nu2, flim(nu1), flim(nu2)),
        'ksz': lambda ells, nu1, nu2: (power_ksz_reion(ells)
                                       + power_ksz_late(ells)),
    }


# ------------------------------------------------------------------
# ILC noise forecasts (reference :492-601)
# ------------------------------------------------------------------

def ilc_power(beams, noises, freqs, flux_limits_mJy,
              inv_noise_weighting=False, total=False, include_fg=True,
              ellmax=25000, lensed_theory=None):
    """Standard-ILC noise curve for a multi-frequency config
    (reference ``foregrounds.py:492``)."""
    from . import ilc as _ilc
    from ..ops.fourier import gauss_beam
    from .theory import default_theory
    noises_rad2 = (np.asarray(noises) * arcmin) ** 2
    ells = np.arange(0, ellmax, 1)
    kbeams = [np.asarray(gauss_beam(ells, b)) for b in beams]
    th = lensed_theory if lensed_theory is not None else default_theory(
        lpad=ellmax)
    cltt = np.asarray(th.lCl("TT", ells))
    components = ('cibc', 'tsz', 'ksz', 'radps', 'cibp') if include_fg else ()
    fdict = fg_dict(flux_limits_mJy, freqs)
    cov = _ilc.ilc_cov(ells, cltt, kbeams, freqs, noises_rad2, components,
                       fdict=fdict)
    covl = np.rollaxis(np.nan_to_num(cov), 2, 0)  # (L, nf, nf)
    if inv_noise_weighting:
        ncov = np.rollaxis(np.nan_to_num(_ilc.ilc_cov(
            ells, cltt, kbeams, freqs, noises_rad2, (), noise_only=True)), 2, 0)
        ninv = np.linalg.inv(ncov[2:])
        ntot = np.sum(ninv, axis=(-2, -1))
        nout = np.zeros(len(ells))
        nout[2:] = np.sum(ninv @ covl[2:] @ ninv, axis=(-2, -1)) / ntot ** 2
    else:
        nout = np.zeros(len(ells))
        cinvl = np.linalg.inv(covl[2:])
        a = np.ones(len(freqs))
        nout[2:] = 1.0 / np.einsum("i,lij,j->l", a, cinvl, a)
    csub = 0 if total else cltt
    nell = np.nan_to_num(nout - csub)
    nell[ells < 2] = 0
    return ells, nell


def get_official_ilc_noise(exp):
    """SO / S4 published post-ILC CMB noise curves (reference :541)."""
    if exp == "so":
        f = os.path.join(DATA_DIR,
                         "SO_LAT_Nell_T_atmv1_baseline_fsky0p4_ILC_CMB.txt")
    elif exp == "s4":
        f = os.path.join(
            DATA_DIR, "S4_190604d_2LAT_T_default_noisecurves_deproj0_SENS0_"
            "mask_16000_ell_TT_yy.txt")
    else:
        raise ValueError(exp)
    ells, nells = np.loadtxt(f, unpack=True, usecols=[0, 1])
    return ells, nells


def get_ilc_noise(exp, scale_noise=1.0, ellmax=25000):
    """Analytic ILC noise for SO/S4/HD-like configs (reference :550)."""
    freqs = np.array([39., 93., 145., 225., 280.])
    beams = {
        's4': np.array([5.1, 2.2, 1.4, 1.0, 0.9]),
        'so': np.array([5.1, 2.2, 1.4, 1.0, 0.9]),
        'hd': (10. / 60.) * 145. / freqs,
    }[exp]
    noises = {
        's4': np.array([12.4, 2.0, 2.0, 6.9, 16.7]),
        'so': np.array([36., 8., 10., 22., 54.]),
        # CMB-HD-like: the reference derives this as s4 * 0.5/1.8
        # (foregrounds.py:562)
        'hd': np.array([12.4, 2.0, 2.0, 6.9, 16.7]) * 0.5 / 1.8,
    }[exp] * scale_noise
    # per-experiment flux cuts (reference keeps a dict: CMB-HD resolves
    # far deeper sources than SO/S4)
    fluxes = {'so': np.array([10., 7., 10., 10., 10.]),
              's4': np.array([10., 7., 10., 10., 10.]),
              'hd': np.array([2., 1., 1., 1., 1.])}[exp]
    return ilc_power(beams, noises, freqs, fluxes, ellmax=ellmax)


# ------------------------------------------------------------------
# multi-frequency power-spectrum model + fitting (reference :707-1100)
# ------------------------------------------------------------------

def wnoise_cl(rms_uk_arcmin):
    return (rms_uk_arcmin * arcmin) ** 2


def fg_cl(ell, p, nu_i, nu_j, cl_tsz_tmpl, freqs, pivot_cib=150.0,
          components=None):
    """Foreground-only model for frequencies i x j (reference :707)."""
    if components is None:
        components = ['tsz', 'cib', 'poisson', 'dust', 'ksz']
    ell = np.asarray(ell, dtype=float)
    nu1, nu2 = freqs[nu_i], freqs[nu_j]
    out = np.zeros_like(ell)
    if 'poisson' in components:
        out = out + p[f"Aps_{nu_i}_{nu_j}"]
    if 'cib' in components:
        Acib, alpha = p["Acib_150"], p["alpha_cib"]
        with np.errstate(divide="ignore"):
            out = out + (np.sqrt(Acib * (nu1 / pivot_cib) ** alpha
                                 * Acib * (nu2 / pivot_cib) ** alpha)
                         * np.nan_to_num((ell / 3000.0) ** (-1.2),
                                         posinf=0.0))
    if 'tsz' in components:
        out = out + cltsz(p["Atsz"], nu1, nu2, cl_tsz_tmpl)
    if 'dust' in components:
        out = out + dust_C_ell_Louis25(ell, nu1, nu2, p['A_dust'],
                                       beta_d=p['beta_dust'])
    if 'ksz' in components:
        out = out + p['A_ksz'] * (power_ksz_reion(ell) + power_ksz_late(ell))
    out[ell < 2] = 0
    return out


def get_noise(ell, i, j, sig_i, sig_j, lknees, alphas, atm_corr=0.0):
    """Noise bias model: red noise on autos, correlated-atmosphere tail on
    crosses (reference :743)."""
    if i == j:
        if lknees[i] > 0:
            return np.asarray(_rednoise(ell, sig_i, lknees[i], alphas[i]))
        return np.full(np.asarray(ell).shape, wnoise_cl(sig_i))
    lk = np.sqrt(lknees[i] * lknees[j])
    al = 0.5 * (alphas[i] + alphas[j])
    wn = (np.sqrt(sig_i * sig_j) * arcmin) ** 2
    red = (lk / np.maximum(np.asarray(ell, float), 1.0)) ** (-al) * wn
    return atm_corr * red


def _rednoise(ells, rms_noise, lknee, alpha):
    """``[(lknee/l)^(-alpha) + 1] (rms in rad)^2`` in float64
    (``orphics_tpu.models.noise.rednoise``; reference ``maps.py:1142``)."""
    ells = np.asarray(ells, np.float64)
    atm = np.zeros_like(ells)
    if lknee > 1e-3:
        inv = np.where(ells > 0, 1.0 / np.where(ells == 0, 1.0, ells), 0.0)
        atm = (lknee * inv) ** (-alpha)
    return (atm + 1.0) * (rms_noise * arcmin) ** 2


def sky_model(ell, nu_i, nu_j, p, freqs, theory=None, return_fg=False,
              **kwargs):
    """CMB + foregrounds model (reference :786)."""
    from .theory import default_theory
    th = theory if theory is not None else default_theory()
    ell = np.asarray(ell, dtype=float)
    cl_cmb = p.get('A_cmb', 1.0) * np.asarray(th.lCl('TT', ell))
    clyy = power_y_template(ell)
    fg = fg_cl(ell, p, nu_i, nu_j, clyy, freqs, **kwargs)
    mod = cl_cmb + fg
    mod[ell < 2] = 0
    if return_fg:
        return mod, fg
    return mod


def _default_param_template(freqs):
    p = {"A_cmb": 1.0, "Atsz": 1.0, "Acib_150": 10.0, "alpha_cib": 3.5,
         "A_dust": 1.0, "beta_dust": 1.6, "A_ksz": 1.0, "Aatm_corr": 0.0}
    for i in range(len(freqs)):
        p[f"rN_{int(freqs[i])}"] = 1.0
        for j in range(i, len(freqs)):
            p[f"Aps_{i}_{j}"] = 3.0
    return p


def fg_fit(ell, cl_dict, freqs, dT_guess, beams, lknees, alphas, fsky,
           fcl_cmb_tmpl, fcl_yy, fixed_params=None, priors=None,
           delta_ell=20, verbose=False):
    """Bounded least-squares fit of CMB+fg+noise amplitudes to a set of
    frequency cross-spectra (reference ``fg_fit``, :850). Returns the
    best-fit parameter dict and 1-sigma uncertainties."""
    from scipy.optimize import least_squares
    from ..ops.fourier import gauss_beam

    fixed_params = dict(fixed_params or {})
    priors = dict(priors or {})
    freqs = np.asarray(freqs)
    nf = len(freqs)
    ell = np.asarray(ell, dtype=float)
    if callable(beams[0]):
        beam_fns = beams
    else:
        beam_fns = [lambda x, b=b: np.asarray(gauss_beam(x, b)) for b in beams]

    # binning
    edges = np.arange(ell.min(), ell.max() + delta_ell, delta_ell)
    idx_bins = [np.where((ell >= lo) & (ell < hi))[0]
                for lo, hi in zip(edges[:-1], edges[1:])]
    idx_bins = [ix for ix in idx_bins if ix.size > 0]

    def binv(arr):
        return np.array([arr[ix].mean() for ix in idx_bins])

    cl_cmb = fcl_cmb_tmpl(ell)
    cl_yy = fcl_yy(ell)

    params0 = _default_param_template(freqs)
    params0.update(fixed_params)
    free = [k for k in params0 if k not in fixed_params]

    pairs = list(itertools.combinations_with_replacement(range(nf), 2))

    def model_pair(p, i, j):
        b1, b2 = beam_fns[i](ell), beam_fns[j](ell)
        mod = (p["A_cmb"] * cl_cmb
               + fg_cl(ell, p, i, j, cl_yy, freqs)) * b1 * b2
        sig_i = dT_guess[i] * p[f"rN_{int(freqs[i])}"]
        sig_j = dT_guess[j] * p[f"rN_{int(freqs[j])}"]
        return mod + get_noise(ell, i, j, sig_i, sig_j, lknees, alphas,
                               p.get("Aatm_corr", 0.0))

    # Knox errors from the data themselves
    errs = {}
    for (i, j) in pairs:
        cii = np.asarray(cl_dict[(i, i)])
        cjj = np.asarray(cl_dict[(j, j)])
        cij = np.asarray(cl_dict[(i, j)])
        var = (cij ** 2 + cii * cjj) / (2 * ell + 1) / fsky
        bvar = binv(var) / np.array([ix.size for ix in idx_bins])
        errs[(i, j)] = np.sqrt(np.maximum(bvar, 1e-300))

    def residuals(x):
        p = dict(params0)
        p.update(dict(zip(free, x)))
        res = []
        for (i, j) in pairs:
            m = binv(model_pair(p, i, j))
            d = binv(np.asarray(cl_dict[(i, j)]))
            res.append((d - m) / errs[(i, j)])
        for name, (mu, sd) in priors.items():
            if name in free:
                res.append(np.atleast_1d((p[name] - mu) / sd))
        return np.concatenate(res)

    x0 = np.array([params0[k] for k in free])
    lb = np.array([0.0 if not k.startswith("alpha") else -10.0 for k in free])
    ub = np.full(len(free), np.inf)
    sol = least_squares(residuals, x0, bounds=(lb, ub), method="trf",
                        max_nfev=3000, verbose=1 if verbose else 0)
    # parameter covariance from J^T J
    try:
        JTJ = sol.jac.T @ sol.jac
        pcov = np.linalg.inv(JTJ)
        perr = np.sqrt(np.diagonal(pcov))
    except np.linalg.LinAlgError:
        perr = np.full(len(free), np.nan)
    best = dict(params0)
    best.update(dict(zip(free, sol.x)))
    errors = dict(zip(free, perr))
    return best, errors, sol


def quick_fit(ell, cl_dict, freqs, dT_guess, beams, lknees, alphas, fsky,
              fixed_params=None, priors=None, delta_ell=20, theory=None,
              verbose=False):
    """Convenience wrapper with default CMB+y templates (reference :802)."""
    from .theory import default_theory
    th = theory if theory is not None else default_theory()
    if fixed_params is None:
        # A_ksz = 0: the CMB template fcltt below ALREADY includes the
        # reion+late kSZ spectra — a nonzero A_ksz would double-count
        # ~3 uK^2 at l~3000 and bias every other amplitude low
        fixed_params = {"alpha_cib": 3.5, "Aatm_corr": 0.0,
                        "beta_dust": 1.6, "A_dust": 0.0, "A_ksz": 0.0}
    if priors is None:
        priors = {"A_cmb": (1.0, 0.03), "Atsz": (1.0, 0.4)}
    fcltt = lambda x: (np.asarray(th.lCl('TT', x)) + power_ksz_reion(x)
                       + power_ksz_late(x))
    fclyy = lambda x: power_y_template(x)
    return fg_fit(ell, cl_dict, freqs, dT_guess, beams, lknees, alphas,
                  fsky, fcltt, fclyy, fixed_params, priors, delta_ell,
                  verbose)


def _rn(params, freq):
    """Noise-scale lookup tolerant to key formatting: the reference keys
    ``rN_{nu}`` with the raw float (``rN_93.0``), our fitters key with
    ``int`` (``rN_93``)."""
    for key in (f"rN_{freq}", f"rN_{int(freq)}", f"rN_{float(freq)}"):
        if key in params:
            return params[key]
    raise KeyError(f"rN_{freq}")


def evaluate_model_dict(ell, best, freqs, dT_guess, beams, lknees, alphas,
                        cl_cmb_tmpl=None, cl_yy=None, theory=None):
    """Per-pair model curves from a fitted parameter dict, broken into
    ``{'total'|'cmb'|'foreground'|'noise': {(i, j): C_ell}}`` blocks
    (reference ``foregrounds.py:1146``). ``cl_cmb_tmpl``/``cl_yy``
    default to the shipped theory / Battaglia templates."""
    from .theory import default_theory
    from ..ops.fourier import gauss_beam
    freqs = np.asarray(freqs)
    ell = np.asarray(ell, dtype=float)
    if callable(beams[0]):
        beam_fns = beams
    else:
        beam_fns = [lambda x, b=b: np.asarray(gauss_beam(x, b)) for b in beams]
    if cl_cmb_tmpl is None:
        th = theory if theory is not None else default_theory()
        cl_cmb_tmpl = np.asarray(th.lCl('TT', ell))
    if cl_yy is None:
        cl_yy = power_y_template(ell)

    def _clean(y):
        y = np.asarray(y, dtype=float).copy()
        y[ell < 2] = 0
        return y

    out = {'total': {}, 'cmb': {}, 'foreground': {}, 'noise': {}}
    for i, j in itertools.combinations_with_replacement(range(len(freqs)), 2):
        b1, b2 = beam_fns[i](ell), beam_fns[j](ell)
        cmb = best["A_cmb"] * np.asarray(cl_cmb_tmpl)
        fg = fg_cl(ell, best, i, j, cl_yy, freqs)
        sig_i = dT_guess[i] * _rn(best, freqs[i])
        sig_j = dT_guess[j] * _rn(best, freqs[j])
        noise = get_noise(ell, i, j, sig_i, sig_j, lknees, alphas,
                          best.get("Aatm_corr", 0.0))
        out['total'][(i, j)] = _clean((cmb + fg) * b1 * b2 + noise)
        out['cmb'][(i, j)] = _clean(cmb)
        out['foreground'][(i, j)] = _clean(fg)
        out['noise'][(i, j)] = _clean(noise + np.zeros_like(ell))
    return out


def model_vec(all_params, params, ell, freqs, dT_guess, beams, lknees,
              alphas, cl_cmb_tmpl, cl_tsz_tmpl):
    """Stacked model vector over all frequency pairs: beam-convolved
    CMB x A_cmb + foregrounds, plus the noise bias on autos (reference
    ``orphics/foregrounds.py:760``)."""
    import itertools
    p = dict(zip(all_params, params))
    blocks = []
    for i, j in itertools.combinations_with_replacement(
            range(len(freqs)), 2):
        b1, b2 = beams[i](ell), beams[j](ell)
        mod = (p["A_cmb"] * cl_cmb_tmpl
               + fg_cl(ell, p, i, j, cl_tsz_tmpl, freqs)) * b1 * b2
        # per-LEG noise amplitudes (cross pairs carry sig_i, sig_j —
        # cf. evaluate_model_dict; a single sig biased Aatm_corr fits)
        sig1 = dT_guess[i] * _rn(p, freqs[i])
        sig2 = dT_guess[j] * _rn(p, freqs[j])
        mod = mod + get_noise(ell, i, j, sig1, sig2, lknees, alphas,
                              p["Aatm_corr"])
        blocks.append(mod)
    return np.concatenate(blocks)


def fit_cross_leastsq(data, freqs_ghz, P, ell_cuts, theory_func, params0,
                      fixed=None, bounds=None, ell=None, index_base=0,
                      method="trf", max_nfev=2000, xtol=1e-10, verbose=0):
    """Nonlinear weighted least-squares fit of binned frequency
    cross-spectra through a binning matrix (reference
    ``orphics/foregrounds.py:1301``).

    ``data[(i, j)]`` -> ``(bp, err)`` or ``{"bp":..., "err":...}`` of
    length Nb; ``P`` is the (Nb, L) binning matrix mapping C_ell to
    bandpowers; ``ell_cuts[(i, j)]`` is a boolean keep mask (Nb,) or a
    list of (lmin, lmax) ranges to INCLUDE; ``theory_func(ell, nu_i,
    nu_j, params_dict)`` returns the model C_ell (length L).  Per-pair
    point-source amplitudes ``Aps_{i}_{j}`` are added automatically.
    Returns (best-fit dict, scipy OptimizeResult).
    """
    from scipy.optimize import least_squares
    P = np.asarray(P, dtype=float)
    Nb, L = P.shape
    ell = np.arange(L, dtype=float) if ell is None else np.asarray(
        ell, dtype=float)
    if ell.shape[0] != L:
        raise ValueError("ell length must match P.shape[1]")
    freqs_ghz = np.asarray(freqs_ghz, dtype=float)
    Nf = freqs_ghz.size
    params0 = dict(params0)
    bounds = {} if bounds is None else dict(bounds)

    def norm_pair(pair):
        i0, j0 = int(pair[0]) - index_base, int(pair[1]) - index_base
        if not (0 <= i0 < Nf and 0 <= j0 < Nf):
            raise ValueError(f"pair {pair} out of range")
        return i0, j0

    pairs = list(data.keys())
    bandpowers, errors, keeps = {}, {}, {}
    has_weight = P != 0.0
    for pair in pairs:
        item = data[pair]
        if isinstance(item, dict):
            bp, er = np.asarray(item["bp"], float), np.asarray(
                item["err"], float)
        else:
            bp, er = np.asarray(item[0], float), np.asarray(item[1], float)
        if bp.shape != (Nb,) or er.shape != (Nb,):
            raise ValueError(f"bandpowers for {pair} must be (Nb,)")
        bandpowers[pair], errors[pair] = bp, er
        cuts = ell_cuts.get(pair)
        if cuts is None:
            keeps[pair] = np.ones(Nb, bool)
        elif (isinstance(cuts, (list, tuple)) and len(cuts)
              and np.ndim(cuts[0]) == 1):
            # (lmin, lmax) ranges select by PHYSICAL ell value, not
            # column index (the two only coincide for ell=arange(L))
            inc = np.zeros(L, bool)
            for lmin, lmax in cuts:
                lmin, lmax = sorted((float(lmin), float(lmax)))
                inc |= (ell >= lmin) & (ell <= lmax)
            keeps[pair] = np.any(has_weight[:, inc], axis=1)
        else:
            km = np.asarray(cuts, bool)
            if km.shape != (Nb,):
                raise ValueError(f"bad ell_cuts for {pair}")
            keeps[pair] = km

    for pair in pairs:
        i0, j0 = norm_pair(pair)
        params0.setdefault(f"Aps_{i0}_{j0}", 1e-5)
        bounds.setdefault(f"Aps_{i0}_{j0}", (0, np.inf))
    if fixed is None:
        fixed = {}
    elif not isinstance(fixed, dict):
        fixed = {name: params0[name] for name in fixed}
    free = [n for n in params0 if n not in fixed]
    if not free:
        raise ValueError("no free parameters")
    x0 = np.array([params0[n] for n in free], float)
    lo = np.array([bounds.get(n, (-np.inf, np.inf))[0] for n in free])
    hi = np.array([bounds.get(n, (-np.inf, np.inf))[1] for n in free])

    def pack(x):
        d = dict(zip(free, x))
        d.update(fixed)
        return d

    def resid(x):
        p = pack(x)
        out = []
        for pair in pairs:
            i0, j0 = norm_pair(pair)
            cl = np.asarray(theory_func(ell, freqs_ghz[i0], freqs_ghz[j0],
                                        p), float)
            cl = cl + p[f"Aps_{i0}_{j0}"]
            mod_bp = P @ cl
            k = keeps[pair]
            out.append((bandpowers[pair][k] - mod_bp[k]) / errors[pair][k])
        return np.concatenate(out)

    res = least_squares(resid, x0, bounds=(lo, hi), method=method,
                        max_nfev=max_nfev, xtol=xtol, verbose=verbose)
    return pack(res.x), res
