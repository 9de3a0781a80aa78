"""Native halo-model thermal-SZ power spectra (the port's copy of
``orphics_tpu.models.szhalo``: host float64 numpy on the port's
``cosmology`` and ``foregrounds``).

Replaces the reference's hmvec-backed ``compute_cl_yy`` /
``compute_tsz_power`` (``orphics/foregrounds.py:123,168``) with an owned
implementation: Tinker et al. (2008) mass function + Tinker et al.
(2010) bias at Delta=200*mean, NFW mass-definition conversion (Duffy
concentrations, vectorized bisection), the Battaglia et al. (2012)
AGN-feedback GNFW pressure profile at Delta=200*critical, and a Limber
projection — all dense vectorized quadratures over (z, M, l) grids
(vmap-friendly; the setup is host float64 numpy like the rest of the
theory layer).

Validated against the reference's shipped Battaglia simulation template
(``data/foregrounds/sz_template_battaglia.csv``) at the template's own
simulation cosmology: *shape* agreement is <=5% over l in [400, 8000]
(<=16% at l=300) after a single fitted amplitude, and the fitted
amplitude itself is 0.90 +- a few % — i.e. the raw curves agree at the
~10% level. In every reference use of this template the amplitude
``A_tsz`` is a free fitted parameter (``power_y_template``,
``fg_fit``; reference foregrounds.py:103), so shape parity is the
operative statement. The ~10% raw amplitude offset is the expected
halo-model-vs-simulation level (Tinker mass function accuracy ~5%,
EH98-based sigma(R) shape ~2%, both exponentially amplified at cluster
masses).

The low-z regulator: the exact per-halo 1-halo term
``int dz dV/dz int dn/dlnM y_l^2`` formally diverges as z -> 0 (a
nearby cluster's y_l grows like 1/d_A^2 while dV/dz only shrinks like
chi^2), so the unmasked low-l power is dominated by a handful of rare
local clusters. Real analyses mask them, and the simulation template's
light cone does not contain them; the reference's hmvec path
(foregrounds.py:123) truncates them silently through its coarse linear
z grid. We regulate explicitly instead: ``zmin`` defaults to 0.1 and is
documented as the local-cluster mask. (Convergence: the default
nz=96/nm=96 grid is within ~1% of nz=240/nm=192.)
"""
from __future__ import annotations

import numpy as np

__all__ = ["tinker_f", "tinker_bias", "duffy_c200c", "m200c_to_m200m",
           "battaglia_yl", "HaloModelYY", "compute_cl_yy",
           "compute_tsz_power", "clyy", "clyy_classy_sz", "shang_sed",
           "subhalo_mf", "CIBHaloModel", "compton_y_cib_powers"]

# cgs constants for the pressure -> y conversion
_SIGMA_T = 6.6524587e-25          # cm^2
_ME_C2 = 8.1871057e-7             # erg
_G_CGS = 6.67430e-8               # cm^3 g^-1 s^-2
_MSUN_G = 1.98892e33              # g
_MPC_CM = 3.0856776e24            # cm
_RHO_CRIT0_H2 = 2.7754e11         # Msun / Mpc^3 (times h^2)
_PTH_TO_PE = 0.5176               # (2+2X)/(3+5X), X = 0.76


def tinker_f(sigma, z):
    """Tinker et al. 2008 f(sigma) at Delta = 200 x mean density, with
    their redshift evolution (capped at z=3 as in the paper)."""
    zc = np.minimum(np.asarray(z, np.float64), 3.0)
    A = 0.186 * (1 + zc) ** -0.14
    a = 1.47 * (1 + zc) ** -0.06
    # alpha = 10^{-(0.75/log10(Delta/75))^1.2} with Delta=200
    alpha = 10 ** (-(0.75 / np.log10(200.0 / 75.0)) ** 1.2)
    b = 2.57 * (1 + zc) ** -alpha
    c = 1.19
    s = np.asarray(sigma, np.float64)
    return A * ((s / b) ** -a + 1.0) * np.exp(-c / s ** 2)


def tinker_bias(nu):
    """Tinker et al. 2010 halo bias at Delta = 200 x mean."""
    y = np.log10(200.0)
    expy = np.exp(-((4.0 / y) ** 4))
    A = 1.0 + 0.24 * y * expy
    a = 0.44 * y - 0.88
    B = 0.183
    b = 1.5
    C = 0.019 + 0.107 * y + 0.19 * expy
    c = 2.4
    dc = 1.686
    nu = np.asarray(nu, np.float64)
    return 1.0 - A * nu ** a / (nu ** a + dc ** a) + B * nu ** b \
        + C * nu ** c


def duffy_c200c(m200c_msun, z, h):
    """Duffy et al. 2008 c200c(M, z) (full-sample fit)."""
    mpivot = 2e12 / h  # Msun
    return 5.71 * (np.asarray(m200c_msun) / mpivot) ** -0.084 \
        * (1 + np.asarray(z)) ** -0.47


def _nfw_mu(x):
    return np.log(1.0 + x) - x / (1.0 + x)


def m200c_to_m200m(m200c, z, cc):
    """Convert M200c -> M200m assuming an NFW profile with Duffy
    concentration (vectorized bisection over the outer radius).

    m200c: (nm,) Msun; z: scalar. Returns (m200m, r200c_phys_mpc).
    """
    m200c = np.asarray(m200c, np.float64)
    h = cc.h
    rho_c = _RHO_CRIT0_H2 * h ** 2 * cc.Ez(z) ** 2          # Msun/Mpc^3
    rho_m = _RHO_CRIT0_H2 * h ** 2 * cc.om * (1 + z) ** 3   # physical
    r200c = (3 * m200c / (4 * np.pi * 200.0 * rho_c)) ** (1 / 3.0)
    c = duffy_c200c(m200c, z, h)
    rs = r200c / c
    rho_s = m200c / (4 * np.pi * rs ** 3 * _nfw_mu(c))
    # solve 4 pi rho_s rs^3 mu(r/rs) = (4 pi/3) r^3 200 rho_m
    lo = 0.5 * r200c
    hi = 10.0 * r200c

    def g(r):
        return rho_s * rs ** 3 * _nfw_mu(r / rs) \
            - (200.0 / 3.0) * rho_m * r ** 3

    for _ in range(60):
        mid = 0.5 * (lo + hi)
        pos = g(mid) > 0
        lo = np.where(pos, mid, lo)
        hi = np.where(pos, hi, mid)
    r200m = 0.5 * (lo + hi)
    m200m = (4 * np.pi / 3.0) * 200.0 * rho_m * r200m ** 3
    return m200m, r200c


def battaglia_yl(ells, m200c, z, cc, xmax=6.0, nx=200):
    """Fourier-space Compton-y profile y_l(M, z) for the Battaglia 2012
    AGN-feedback pressure fit (Delta = 200 critical).

    ells: (nl,), m200c: (nm,) Msun. Returns (nm, nl).
    """
    ells = np.asarray(ells, np.float64)
    m200c = np.asarray(m200c, np.float64)
    h = cc.h
    rho_c = _RHO_CRIT0_H2 * h ** 2 * cc.Ez(z) ** 2          # Msun/Mpc^3
    r200c = (3 * m200c / (4 * np.pi * 200.0 * rho_c)) ** (1 / 3.0)  # phys
    m14 = m200c / (1e14 / 1.0)
    # Battaglia 2012 Table 1 (AGN feedback, Delta=200c) scalings
    P0 = 18.1 * m14 ** 0.154 * (1 + z) ** -0.758
    xc = 0.497 * m14 ** -0.00865 * (1 + z) ** 0.731
    beta = 4.35 * m14 ** 0.0393 * (1 + z) ** 0.415
    gamma, alpha = -0.3, 1.0
    # P200 = G M200 * 200 rho_c(z) f_b / (2 R200)   [cgs]
    fb = cc.ob / cc.om
    P200 = (_G_CGS * (m200c * _MSUN_G) * 200.0
            * (rho_c * _MSUN_G / _MPC_CM ** 3) * fb
            / (2.0 * r200c * _MPC_CM))                       # erg/cm^3
    x = np.linspace(1e-4, xmax, nx)                          # r / R200c
    xx = x[None, :] / xc[:, None]
    pe = _PTH_TO_PE * P0[:, None] * xx ** gamma \
        * (1.0 + xx ** alpha) ** -beta[:, None]              # (nm, nx)
    # l_s = d_A(z)/R200 (both physical); y_l = sigT/(me c^2) * 4 pi R200
    #       / l_s^2 * int dx x^2 P_e(x) sinc((l+1/2) x / l_s)
    d_a = cc.comoving_radial_distance(z) / (1 + z)           # phys Mpc
    ls = d_a / r200c                                         # (nm,)
    q = (ells[None, None, :] + 0.5) * x[None, :, None] / ls[:, None, None]
    sinc = np.sin(q) / q
    integrand = (x ** 2)[None, :, None] * pe[:, :, None] * sinc
    integral = np.trapezoid(integrand, x, axis=1)            # (nm, nl)
    pref = (_SIGMA_T / _ME_C2) * 4 * np.pi * (r200c * _MPC_CM) \
        / ls ** 2 * P200
    return pref[:, None] * integral


class HaloModelYY:
    """Compton-y halo-model power on dense (z, M, l) grids."""

    def __init__(self, cc=None, zmin=0.1, zmax=5.0, nz=96,
                 m_min=1e11, m_max=2e15, nm=96):
        if cc is None:
            from .cosmology import Cosmology
            cc = Cosmology()
        self.cc = cc
        self.zs = np.linspace(zmin, zmax, nz)
        self.ms = np.geomspace(m_min, m_max, nm)   # M200c, Msun
        self._init_mass_function()

    def _sigma_grid(self, r_mpch, z):
        """sigma(R, z) for an array of Lagrangian radii (Mpc/h)."""
        cc = self.cc
        k = np.logspace(-4, 1.5, 600)             # 1/Mpc
        P = cc.P_lin(k, z)                        # Mpc^3
        R = np.asarray(r_mpch) / cc.h             # Mpc
        kR = k[None, :] * R[:, None]
        W = 3 * (np.sin(kR) - kR * np.cos(kR)) / kR ** 3
        integ = (k ** 2 * P)[None, :] * W ** 2 / (2 * np.pi ** 2)
        return np.sqrt(np.trapezoid(integ, k, axis=1))

    def _init_mass_function(self):
        """dn/dlnM200c (comoving Mpc^-3) and bias on the (z, M) grid."""
        cc = self.cc
        nz, nm = len(self.zs), len(self.ms)
        self.dndlnm = np.zeros((nz, nm))
        self.bias = np.zeros((nz, nm))
        self.r200c = np.zeros((nz, nm))
        rho_m0 = _RHO_CRIT0_H2 * cc.h ** 2 * cc.om      # Msun/Mpc^3 comoving
        for iz, z in enumerate(self.zs):
            m200m, r200c = m200c_to_m200m(self.ms, z, cc)
            self.r200c[iz] = r200c
            # Lagrangian radius of M200m (comoving Mpc/h)
            rlag = (3 * m200m / (4 * np.pi * rho_m0)) ** (1 / 3.0) * cc.h
            sig = self._sigma_grid(rlag, z)
            f = tinker_f(sig, z)
            dlnsinv_dlnm = -np.gradient(np.log(sig), np.log(m200m))
            dndlnm_200m = f * (rho_m0 / m200m) * dlnsinv_dlnm
            # change variables to the M200c grid
            jac = np.gradient(np.log(m200m), np.log(self.ms))
            self.dndlnm[iz] = dndlnm_200m * jac
            self.bias[iz] = tinker_bias(1.686 / sig)

    def cl_yy(self, ells, include_2h=True):
        """C_l^yy (dimensionless y^2)."""
        cc = self.cc
        ells = np.asarray(ells, np.float64)
        zs, ms = self.zs, self.ms
        chi = np.array([cc.comoving_radial_distance(z) for z in zs])
        Hz = np.array([cc.hubble_parameter(z) for z in zs])   # km/s/Mpc
        c_kms = 299792.458
        dvdz = c_kms / Hz * chi ** 2                          # Mpc^3/sr
        one = np.zeros((len(zs), len(ells)))
        two = np.zeros((len(zs), len(ells)))
        lnm = np.log(ms)
        for iz, z in enumerate(zs):
            yl = battaglia_yl(ells, ms, z, cc)                # (nm, nl)
            w = self.dndlnm[iz]                               # per lnM
            one[iz] = np.trapezoid(w[:, None] * yl ** 2, lnm, axis=0)
            if include_2h:
                by = np.trapezoid((w * self.bias[iz])[:, None] * yl,
                                  lnm, axis=0)                # (nl,)
                k = (ells + 0.5) / chi[iz]                    # 1/Mpc
                two[iz] = by ** 2 * cc.P_lin(k, z)
        cl1 = np.trapezoid(dvdz[:, None] * one, zs, axis=0)
        cl2 = np.trapezoid(dvdz[:, None] * two, zs, axis=0)
        return (cl1 + cl2) if include_2h else cl1


def compute_cl_yy(ell, M_min=1e11, M_max=2e15, zmin=0.1, zmax=5.0,
                  nm=96, nz=96, include_2h=True, cc=None):
    """Thermal-SZ y-power with clusters above ``M_max`` masked
    (reference ``compute_cl_yy``, ``foregrounds.py:123``). ``zmin``
    additionally masks local clusters — see the module docstring for
    why the default is 0.1 rather than the reference's nominal 0.001
    (whose hmvec quadrature truncates low z silently)."""
    hm = HaloModelYY(cc=cc, zmin=zmin, zmax=zmax, nz=nz,
                     m_min=M_min, m_max=M_max, nm=nm)
    return hm.cl_yy(np.asarray(ell), include_2h=include_2h)


def compute_tsz_power(ell, nu_i_ghz, nu_j_ghz, Cyy=None, **kw):
    """tSZ power in thermodynamic uK^2 at a frequency pair (reference
    ``compute_tsz_power``, ``foregrounds.py:168``)."""
    from .foregrounds import g_tsz, TCMB_uK
    if Cyy is None:
        Cyy = compute_cl_yy(ell, **kw)
    return np.asarray(Cyy) * np.asarray(g_tsz(nu_i_ghz)) \
        * np.asarray(g_tsz(nu_j_ghz)) * TCMB_uK ** 2


def clyy(ells, zmin=0.1, zmax=5.0, mmin=1e11, mmax=5e15, **kw):
    """Named parity surface for the reference's ``clyy_classy_sz``
    (``foregrounds.py:629``, a classy_sz 1-halo Cl_yy wrapper) on the
    native halo model."""
    return compute_cl_yy(np.asarray(ells), M_min=mmin, M_max=mmax,
                         zmin=zmin, zmax=zmax, **kw)




def clyy_classy_sz(ells, zmin=0.001, zmax=5.0, mmin=1e11, mmax=5e15, **kw):
    """Exact-name parity for the reference's classy_sz 1-halo Cl_yy
    wrapper (``foregrounds.py:629``), served by the native halo model.
    ``zmin`` below the 0.1 low-z regulator is clamped — the exact
    per-halo 1-halo term diverges as z->0 and the reference's backend
    only avoids it through its coarse z grid (see module docstring)."""
    return clyy(ells, zmin=max(zmin, 0.1), zmax=zmax, mmin=mmin,
                mmax=mmax, **kw)


# ---------------------------------------------------------------------------
# Shang/WebSky CIB halo model + y x CIB cross power
# (reference compton_y_cib_powers, foregrounds.py:334 — a classy_sz
# wrapper configured with the WebSky CIB parameters quoted there)
# ---------------------------------------------------------------------------

# WebSky CIB parameters as quoted in the reference's classy_sz config
# (foregrounds.py:403-452): Shang et al. 2012 model 2 / Stein et al.
# WebSky choices.
SHANG_DEFAULTS = dict(
    Td0=20.7,          # dust temperature today [K]
    alpha_z=0.2,       # Td(z) = Td0 (1+z)^alpha_z
    beta=1.6,          # emissivity index
    alpha_hi=1.7,      # high-frequency power-law index of the SED
    eta=1.28,          # (1+z)^eta evolution of the L-M normalization
    zplat=2.0,         # L-M evolution plateaus above this z
    logMpeak=12.3,     # most efficient halo mass [log10 Msun]
    sigmaM=0.3,        # log10-mass width of the L-M relation
    msub_min=1e11,     # minimum subhalo mass [Msun]
)

# Jiang & van den Bosch (2014) unevolved subhalo mass function
# dN/dln(m/M) = [g1 (m/M)^a1 + g2 (m/M)^a2] exp(-b (m/M)^z) — the
# 'JvdB14' choice in the reference's config (WebSky eq. 3.9).
_JB14 = dict(g1=0.13, a1=-0.83, g2=1.33, a2=-0.02, b=5.67, zt=1.19)


def subhalo_mf(m_over_M):
    """JvdB14 dN/dln(m/M)."""
    x = np.asarray(m_over_M, np.float64)
    p = _JB14
    return (p["g1"] * x ** p["a1"] + p["g2"] * x ** p["a2"]) \
        * np.exp(-p["b"] * x ** p["zt"])


def _sed_knee_x(beta, alpha_hi):
    """x = h nu / k Td where the modified blackbody's log-slope equals
    -alpha_hi (temperature-independent); bisection on
    beta + 3 - x e^x/(e^x - 1) = -alpha_hi."""
    f = lambda x: beta + 3.0 - x / (1.0 - np.exp(-x)) + alpha_hi
    lo, hi = 1e-3, 50.0
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        if f(mid) > 0:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def shang_sed(nu_ghz, z, p=None):
    """CIB SED Theta(nu_rest, Td(z)): modified blackbody nu^beta B_nu(Td)
    joined to a nu^-alpha_hi power law where the slopes match,
    normalized to 1 at rest-frame 353 GHz (the pivot convention is
    degenerate with L0 — see cib_powers)."""
    p = {**SHANG_DEFAULTS, **(p or {})}
    from .foregrounds import planck as _bnu
    nu = np.atleast_1d(np.asarray(nu_ghz, np.float64))
    z = np.asarray(z, np.float64)
    Td = p["Td0"] * (1.0 + z) ** p["alpha_z"]
    kB_h_GHz = 20.836619  # k_B/h in GHz/K
    nu_knee = _sed_knee_x(p["beta"], p["alpha_hi"]) * kB_h_GHz * Td
    mbb = lambda f: f ** p["beta"] * _bnu(f * 1e9, Td)
    lowf = mbb(np.minimum(nu, nu_knee))
    hif = mbb(nu_knee) * (nu / nu_knee) ** (-p["alpha_hi"])
    theta = np.where(nu <= nu_knee, lowf, hif)
    return theta / mbb(np.asarray(353.0))


def _u_nfw(k_invmpc, m200c, z, cc):
    """Normalized NFW profile Fourier transform u(k|M,z), truncated at
    r200c (Duffy c200c), standard Si/Ci closed form."""
    from scipy.special import sici
    m200c = np.atleast_1d(np.asarray(m200c, np.float64))
    k = np.atleast_1d(np.asarray(k_invmpc, np.float64))
    h = cc.h
    rho_c = _RHO_CRIT0_H2 * h ** 2 * cc.Ez(z) ** 2
    r200 = (3 * m200c / (4 * np.pi * 200.0 * rho_c)) ** (1 / 3.0)  # phys
    c = duffy_c200c(m200c, z, h)
    rs = (r200 / c) * (1 + z)          # comoving rs for comoving k
    mu = _nfw_mu(c)
    x = k[None, :] * rs[:, None]       # (nm, nk)
    si_x, ci_x = sici(x)
    si_cx, ci_cx = sici((1 + c[:, None]) * x)
    u = (np.sin(x) * (si_cx - si_x) + np.cos(x) * (ci_cx - ci_x)
         - np.sin(c[:, None] * x) / ((1 + c[:, None]) * x)) / mu[:, None]
    return np.clip(u, 0.0, 1.0)


# sentinel: "inherit leg 1's flux cut" — distinct from None ("no cut")
_SAME_CUT = object()


class CIBHaloModel(HaloModelYY):
    """Shang/WebSky CIB emissivity on the same Tinker/Limber machinery
    as the tSZ halo model, plus the y x CIB cross.

    The SED pivot convention makes the overall amplitude degenerate
    with ``L0``; by default L0 is calibrated once so the clustered
    143x143 GHz power matches the shipped analytic CIB-clustered
    template at l=3000 (``foregrounds.power_cibc``, the same
    measurement-fit normalization every reference use of CIB power
    carries). Shapes in (l, nu, z, M) are pure halo-model predictions.
    """

    def __init__(self, cc=None, shang=None, L0=None, **kw):
        super().__init__(cc=cc, **kw)
        self.p = {**SHANG_DEFAULTS, **(shang or {})}
        self._sat_lum_cache = {}
        self.L0 = L0 if L0 is not None else self._calibrate_L0()

    # --- luminosity pieces -------------------------------------------
    def _sigma_M(self, m):
        p = self.p
        lg = np.log10(np.asarray(m, np.float64))
        return np.asarray(m, np.float64) / np.sqrt(
            2 * np.pi * p["sigmaM"] ** 2) * np.exp(
            -(lg - p["logMpeak"]) ** 2 / (2 * p["sigmaM"] ** 2))

    def _phi_z(self, z):
        p = self.p
        return (1.0 + np.minimum(np.asarray(z, np.float64),
                                 p["zplat"])) ** p["eta"]

    def _sat_sigma(self, iz):
        """Sum of Sigma(m_sub) over the JvdB14 subhalo population for
        every host mass on the grid (z-independent in this model, but
        cached per iz for clarity)."""
        if iz in self._sat_lum_cache:
            return self._sat_lum_cache[iz]
        ms = self.ms
        out = np.zeros_like(ms)
        for i, M in enumerate(ms):
            if self.p["msub_min"] >= M:
                continue
            lx = np.linspace(np.log(self.p["msub_min"] / M), 0.0, 64)
            x = np.exp(lx)
            out[i] = np.trapezoid(subhalo_mf(x) * self._sigma_M(x * M),
                                  lx)
        self._sat_lum_cache[iz] = out
        return out

    def _flux(self, nu_ghz, iz, flux_cut_mJy=None):
        """(S_cen, S_sat) in Jy for every grid mass at zs[iz], observed
        frequency nu_ghz: S = L0 Phi(z) Sigma Theta((1+z)nu) /
        (4 pi chi^2 (1+z))."""
        z = self.zs[iz]
        cc = self.cc
        chi = cc.comoving_radial_distance(z)            # comoving Mpc
        theta = shang_sed((1.0 + z) * nu_ghz, z, self.p)
        pref = self.L0 * self._phi_z(z) * theta \
            / (4.0 * np.pi * chi ** 2 * (1.0 + z))
        s_cen = pref * self._sigma_M(self.ms)
        s_sat = pref * self._sat_sigma(iz)
        if flux_cut_mJy is not None:
            s_cen = np.where(s_cen > flux_cut_mJy * 1e-3, 0.0, s_cen)
        return s_cen, s_sat

    def _calibrate_L0(self):
        from . import foregrounds as fg
        self.L0 = 1.0
        l0 = np.array([3000.0])
        want = float(np.asarray(fg.power_cibc(l0, 143.0))[0])
        got = float(self.cib_cl(l0, 143.0, in_uk2=True)["total"][0])
        self._sat_lum_cache.clear()
        return float(np.sqrt(want / max(got, 1e-300)))

    # --- power spectra -----------------------------------------------
    def _limber_weights(self):
        cc = self.cc
        zs = self.zs
        chi = np.array([cc.comoving_radial_distance(z) for z in zs])
        Hz = np.array([cc.hubble_parameter(z) for z in zs])
        dvdz = 299792.458 / Hz * chi ** 2               # Mpc^3 / sr
        return chi, dvdz

    def cib_cl(self, ells, nu1_ghz, nu2_ghz=None, flux_cut_mJy=None,
               flux_cut2_mJy=_SAME_CUT, in_uk2=False):
        """Clustered CIB power (1h cen-sat + sat-sat, 2h) at a
        frequency pair. Returns dict with '1h', '2h', 'total' in
        Jy^2/sr, or thermodynamic uK^2 with ``in_uk2``. The pure
        Poisson (cen-cen shot noise) term is intentionally excluded —
        the reference covers it with the separate ``power_cibp``
        template. ``flux_cut2_mJy`` sets the second leg's flux limit;
        when omitted it inherits the first's — pass ``None`` EXPLICITLY
        for "no cut on leg 2" (per-frequency cuts differ in any real
        survey, including mixed cut/uncut pairs)."""
        from .foregrounds import ItoDeltaT
        if nu2_ghz is None:
            nu2_ghz = nu1_ghz
        if flux_cut2_mJy is _SAME_CUT:
            flux_cut2_mJy = flux_cut_mJy
        ells = np.asarray(ells, np.float64)
        chi, dvdz = self._limber_weights()
        one = np.zeros((len(self.zs), len(ells)))
        two = np.zeros_like(one)
        lnm = np.log(self.ms)
        for iz, z in enumerate(self.zs):
            k = (ells + 0.5) / chi[iz]
            u = _u_nfw(k, self.ms, z, self.cc)          # (nm, nl)
            w = self.dndlnm[iz]
            s1c, s1s = self._flux(nu1_ghz, iz, flux_cut_mJy)
            s2c, s2s = self._flux(nu2_ghz, iz, flux_cut2_mJy)
            oneh = (s1c[:, None] * s2s[:, None] * u
                    + s2c[:, None] * s1s[:, None] * u
                    + s1s[:, None] * s2s[:, None] * u ** 2)
            one[iz] = np.trapezoid(w[:, None] * oneh, lnm, axis=0)
            b = self.bias[iz]
            j1 = np.trapezoid((w * b)[:, None]
                              * (s1c[:, None] + s1s[:, None] * u),
                              lnm, axis=0)
            j2 = np.trapezoid((w * b)[:, None]
                              * (s2c[:, None] + s2s[:, None] * u),
                              lnm, axis=0)
            two[iz] = j1 * j2 * self.cc.P_lin(k, z)
        cl1 = np.trapezoid(dvdz[:, None] * one, self.zs, axis=0)
        cl2 = np.trapezoid(dvdz[:, None] * two, self.zs, axis=0)
        fac = 1.0
        if in_uk2:
            fac = (1e-26) ** 2 * float(np.asarray(ItoDeltaT(nu1_ghz))) \
                * float(np.asarray(ItoDeltaT(nu2_ghz)))
        return {"1h": cl1 * fac, "2h": cl2 * fac,
                "total": (cl1 + cl2) * fac}

    def y_cib_cl(self, ells, nu_ghz, flux_cut_mJy=None, in_uk=False):
        """y x CIB cross power (1h + 2h): the Compton-y profile against
        the CIB flux of the same halos. Jy/sr per unit y, or uK (times
        the tSZ spectral factor applied by the caller) with
        ``in_uk``."""
        from .foregrounds import ItoDeltaT
        ells = np.asarray(ells, np.float64)
        chi, dvdz = self._limber_weights()
        one = np.zeros((len(self.zs), len(ells)))
        two = np.zeros_like(one)
        lnm = np.log(self.ms)
        for iz, z in enumerate(self.zs):
            k = (ells + 0.5) / chi[iz]
            u = _u_nfw(k, self.ms, z, self.cc)
            w = self.dndlnm[iz]
            yl = battaglia_yl(ells, self.ms, z, self.cc)   # (nm, nl)
            sc, ss = self._flux(nu_ghz, iz, flux_cut_mJy)
            cib = sc[:, None] + ss[:, None] * u
            one[iz] = np.trapezoid(w[:, None] * yl * cib, lnm, axis=0)
            b = self.bias[iz]
            jy = np.trapezoid((w * b)[:, None] * yl, lnm, axis=0)
            jc = np.trapezoid((w * b)[:, None] * cib, lnm, axis=0)
            two[iz] = jy * jc * self.cc.P_lin(k, z)
        cl1 = np.trapezoid(dvdz[:, None] * one, self.zs, axis=0)
        cl2 = np.trapezoid(dvdz[:, None] * two, self.zs, axis=0)
        fac = 1.0
        if in_uk:
            fac = 1e-26 * float(np.asarray(ItoDeltaT(nu_ghz)))
        return {"1h": cl1 * fac, "2h": cl2 * fac,
                "total": (cl1 + cl2) * fac}


def compton_y_cib_powers(freqs_ghz, flux_limits_mJy=None, lmin=2,
                         lmax=4000, nl=40, cc=None, **kw):
    """Native counterpart of the reference's classy_sz wrapper
    (``foregrounds.py:334``). Returns a dict with

      - ``ells``: (nl,) log-spaced multipoles in [lmin, lmax]
      - ``yy``: (nl,) dimensionless Compton-y power (1h+2h)
      - ``cib_cib``: (nf, nf, nl) clustered CIB power in Jy^2/sr
      - ``y_cib``: (nf, nl) y x CIB cross in Jy/sr

    (The reference function *documents* this trio but — see its tail —
    actually returns only the yy piece; we return all three.)
    """
    freqs_ghz = np.atleast_1d(np.asarray(freqs_ghz, np.float64))
    nf = len(freqs_ghz)
    if flux_limits_mJy is None:
        flux_limits_mJy = [None] * nf
    ells = np.geomspace(max(lmin, 2), lmax, nl)
    hm = CIBHaloModel(cc=cc, **kw)
    yy = hm.cl_yy(ells)
    cib = np.zeros((nf, nf, nl))
    ycib = np.zeros((nf, nl))
    for i in range(nf):
        ycib[i] = hm.y_cib_cl(ells, freqs_ghz[i],
                              flux_cut_mJy=flux_limits_mJy[i])["total"]
        for j in range(i, nf):
            cij = hm.cib_cl(ells, freqs_ghz[i], freqs_ghz[j],
                            flux_cut_mJy=flux_limits_mJy[i],
                            flux_cut2_mJy=flux_limits_mJy[j])["total"]
            cib[i, j] = cij
            cib[j, i] = cij
    return {"ells": ells, "yy": yy, "cib_cib": cib, "y_cib": ycib}
