"""NFW kappa profile binning/fitting and lensed pixel covariances (port of
``orphics_tpu.models.nfwfit``).

Reference anchors: ``nfw_kappa``/``NFWkappa`` (``orphics/lensing.py:711,
723``), ``binned_nfw`` (``:285``), ``fit_nfw_profile`` (``:313``),
``filter_bin_kappa1d/2d`` (``:108,115``), ``lens_cov_pol``/``lens_cov``/
``beam_cov`` (``:525,588,626``).

The NFW profiles are float64 tensors: a tensor argument keeps its
device, host numbers and arrays go to ``device`` (``None``: the card).
The distances and the halo-model pieces (bias, mass conversions, the
two-halo Hankel transform) stay host float64 numpy, as in the JAX
package. Binned profiles go through the port's ``Bin2D`` (kernel B1 on
the card) on the float32 filtered map. The lensed covariance lenses all
covariance rows as one batch of maps in one call of
``lensing.lens_map_spline`` (kernel B8 on the card), then all columns:
the row-parallel MPI loop of reference ``lens_cov_pol``.
:func:`fit_nfw_profile` walks its profile models in a Python loop like
the reference. :func:`mass_estimate` fits NFW templates with
``mapstools.MatchedFilter`` (ROADMAP queue A, item 13b).
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import as_tensor, resolve
from ..geometry import Geometry, arcmin
from ..ops import fourier as F
from ..ops.binning import Bin2D
from ..ops.interp import interp
from ..ops.windows import get_taper
from .lensing import _as_f64, nfw_kappa_profile, lens_map_spline

__all__ = ["nfw_kappa", "NFWkappa", "binned_nfw", "fit_nfw_profile",
           "kappa_2h_profile", "halo_bias",
           "filter_bin_kappa2d", "filter_bin_kappa1d", "lens_cov",
           "beam_cov", "lens_cov_pol"]


def nfw_kappa(mass_msun_overh, modrmap_radians, cc, zL=0.7,
              concentration=3.2, overdensity=180.0, critical=False,
              at_cluster_z=False, z_s=None, device=None):
    """NFW convergence on a radial grid using a Cosmology for distances
    (reference ``lensing.py:711``; source plane ``z_s`` defaults to the
    CMB as there). Float64: a tensor grid keeps its device, a host grid
    goes to ``device``."""
    comS = cc.comoving_radial_distance(cc.cmbZ if z_s is None
                                       else z_s) * cc.h
    comL = cc.comoving_radial_distance(zL) * cc.h
    win = (comS - comL) / comS
    zdensity = zL if at_cluster_z else 0.0
    M = abs(mass_msun_overh)
    if critical:
        rdel = cc.rdel_c(M, zdensity, overdensity)
    else:
        rdel = cc.rdel_m(M, zdensity, overdensity)
    return nfw_kappa_profile(modrmap_radians, mass_msun_overh,
                             comL, win, zL, concentration,
                             rdel_mpc_overh=rdel, device=device)


def NFWkappa(cc, mass_msun_overh, concentration, zL, theta_arcmin,
             win_at_lens, overdensity=500.0, critical=True,
             at_cluster_z=True, device=None):
    """(kappa, R_delta) on an arcminute grid (reference
    ``lensing.py:723``); ``device`` as in :func:`nfw_kappa`."""
    comL = cc.comoving_radial_distance(zL) * cc.h
    zdensity = zL if at_cluster_z else 0.0
    M = abs(mass_msun_overh)
    rdel = (cc.rdel_c(M, zdensity, overdensity) if critical
            else cc.rdel_m(M, zdensity, overdensity))
    theta = _as_f64(theta_arcmin, device) * arcmin
    kappa = nfw_kappa_profile(theta, mass_msun_overh, comL, win_at_lens, zL,
                              concentration, rdel_mpc_overh=rdel)
    return kappa, rdel


def _mdelta_to_m200m(m_msun, z, cc, delta, critical, at_cluster_z=True):
    """Convert M_delta (Msun, at ``delta`` x rho_{crit|mean}) to the
    200-mean definition, assuming an NFW profile with Duffy c200c(M):
    outer bisection on M200c such that the NFW mass enclosed at the
    delta-overdensity radius equals ``m_msun``; then the existing
    M200c -> M200m conversion. ``at_cluster_z`` selects whether the
    input definition's reference density is evaluated at ``z`` or at
    z = 0 — it must match the 1-halo profile's convention
    (``nfw_kappa``'s ``at_cluster_z``).

    The inner enclosed-mass solve parallels ``szhalo.m200c_to_m200m``
    generalized to (delta, rho_ref); the wider 0.05-20 r200c bracket
    covers low overdensities (delta ~ 100 mean) whose radii exceed
    10 r200c."""
    from .szhalo import (m200c_to_m200m, duffy_c200c, _nfw_mu,
                         _RHO_CRIT0_H2)
    if delta == 200 and not critical:
        return m_msun
    if delta == 200 and critical and at_cluster_z:
        m200m, _ = m200c_to_m200m(np.atleast_1d(m_msun), z, cc)
        return float(np.asarray(m200m).reshape(-1)[0])
    h = cc.h
    zden = z if at_cluster_z else 0.0
    rho_c = _RHO_CRIT0_H2 * h ** 2 * cc.Ez(z) ** 2       # Msun/Mpc^3
    rho_ref = (_RHO_CRIT0_H2 * h ** 2 * cc.Ez(zden) ** 2) if critical \
        else _RHO_CRIT0_H2 * h ** 2 * cc.om * (1 + zden) ** 3

    def mass_at_delta(m200c):
        r200c = (3 * m200c / (4 * np.pi * 200.0 * rho_c)) ** (1 / 3.0)
        c = float(duffy_c200c(m200c, z, h))
        rs = r200c / c
        rho_s = m200c / (4 * np.pi * rs ** 3 * _nfw_mu(c))
        # inner bisection: M(r) = (4 pi/3) delta rho_ref r^3
        glo, ghi = 0.05 * r200c, 20.0 * r200c
        for _ in range(60):
            mid = 0.5 * (glo + ghi)
            if (rho_s * rs ** 3 * _nfw_mu(mid / rs)
                    > (delta / 3.0) * rho_ref * mid ** 3):
                glo = mid
            else:
                ghi = mid
        r_d = 0.5 * (glo + ghi)
        return (4 * np.pi / 3.0) * delta * rho_ref * r_d ** 3

    lo, hi = m_msun * 1e-2, m_msun * 1e2
    for _ in range(80):                # monotone in m200c
        mid = np.sqrt(lo * hi)
        if mass_at_delta(mid) < m_msun:
            lo = mid
        else:
            hi = mid
    m200c = np.sqrt(lo * hi)
    m200m, _ = m200c_to_m200m(np.atleast_1d(m200c), z, cc)
    return float(np.asarray(m200m).reshape(-1)[0])


def halo_bias(mass_msun_overh, z, cc, critical=False, overdensity=200.0,
              at_cluster_z=True):
    """Tinker et al. 2010 linear bias for a halo of the given mass
    (|Msun/h|; the sign convention of signed-template fits is applied
    by the caller) in the (``overdensity``, ``critical``,
    ``at_cluster_z``) definition; the mass is converted to the 200-mean
    definition the bias fit is calibrated at (NFW + Duffy
    concentration, :func:`_mdelta_to_m200m`) before forming the peak
    height."""
    m_msun = _mdelta_to_m200m(abs(float(mass_msun_overh)) / cc.h, z, cc,
                              float(overdensity), bool(critical),
                              at_cluster_z=bool(at_cluster_z))
    from .szhalo import tinker_bias
    rho_m0 = cc.rho_crit0_h2() * cc.h ** 2 * cc.om       # Msun/Mpc^3
    R_mpc = (3.0 * m_msun / (4.0 * np.pi * rho_m0)) ** (1.0 / 3.0)
    sig = float(cc.sigmaR(R_mpc * cc.h, z))
    return float(tinker_bias(1.686 / sig))


def kappa_2h_profile(thetas_rad, mass_msun_overh, z, cc, z_s=1100.0,
                     critical=False, overdensity=200.0, bias=None,
                     lmin=2, lmax=10000, nl=2048, at_cluster_z=True):
    """Two-halo convergence profile of a halo at ``z`` (reference
    ``binned_nfw``'s ``hm.kappa_2h_profiles``, ``orphics/lensing.py:300``
    — the hmvec optional dependency made native).

    The halo-convergence cross spectrum in Limber form,

        C_L^{h kappa} = b(M) W_kappa(chi_L) / chi_L^2
                        P_lin((L + 1/2)/chi_L, z),

    Hankel-transformed back to angle:
    ``kappa_2h(theta) = int L dL/(2 pi) J_0(L theta) C_L``.
    thetas in radians; mass in Msun/h. ``bias`` overrides the Tinker
    b(M) (:func:`halo_bias`).
    """
    from scipy.special import j0
    if bias is None:
        bias = halo_bias(mass_msun_overh, z, cc, critical=critical,
                         overdensity=overdensity,
                         at_cluster_z=at_cluster_z)
    chiL = float(cc.comoving_radial_distance(z))         # Mpc
    chiS = float(cc.comoving_radial_distance(z_s))
    H0_invmpc = cc.H0 / 299792.458                       # 1/Mpc
    Wk = 1.5 * cc.om * H0_invmpc ** 2 * (1.0 + z) * chiL \
        * (chiS - chiL) / chiS                           # 1/Mpc
    ls = np.linspace(float(lmin), float(lmax), int(nl))
    k = (ls + 0.5) / chiL                                # 1/Mpc
    P = np.asarray(cc.P_lin(k, z), np.float64)           # Mpc^3
    cl = bias * Wk / chiL ** 2 * P
    thetas = np.atleast_1d(np.asarray(thetas_rad, np.float64))
    # J_0 kernel on the (theta, L) grid; trapezoid over L
    J = j0(np.outer(thetas, ls))
    integ = J * (ls * cl)[None, :] / (2.0 * np.pi)
    return np.trapezoid(integ, ls, axis=-1)


def kappa_2h_map(geom: Geometry, mass, z, cc, z_s=1100.0,
                 critical=False, overdensity=200.0, at_cluster_z=True,
                 bias=None, device=None):
    """Paint :func:`kappa_2h_profile` on a geometry's distance map, a
    float64 tensor on ``device``. Signed-mass templates
    (``fit_nfw_profile``'s null-test scans): the bias is evaluated at |M|
    and the 2-halo term carries the sign of the mass, mirroring
    ``nfw_kappa``'s convention."""
    modr = geom.modrmap_np()
    ths = np.geomspace(max(modr[modr > 0].min() * 0.5, 1e-7),
                       modr.max() * 1.05, 128)
    sgn = -1.0 if float(mass) < 0 else 1.0
    k2h = kappa_2h_profile(ths, abs(float(mass)), z, cc, z_s=z_s,
                           critical=critical, overdensity=overdensity,
                           at_cluster_z=at_cluster_z, bias=bias)
    modr_t = torch.as_tensor(modr.reshape(-1), dtype=torch.float64,
                             device=resolve(device))
    return sgn * interp(modr_t, ths, k2h, left=float(k2h[0]),
                        right=float(k2h[-1])).reshape(geom.shape)


def binned_nfw(mass, z, conc, cc, geom: Geometry, bin_edges_arcmin,
               lmax=None, lmin=None, overdensity=200.0, critical=False,
               at_cluster_z=True, kmask=None, include_2h=False,
               sigma_mis=None, z_s=1100.0, device=None):
    """Fourier-filtered, radially binned NFW kappa profile (reference
    ``lensing.py:285``). ``include_2h=True`` adds the native two-halo
    term (:func:`kappa_2h_profile`) and ``sigma_mis`` (arcmin) a
    Rayleigh miscentering convolution
    (:func:`kappa_nfw_profiley1d`) — together the reference's
    ``improved=True`` path via hmvec, natively. The kappa map is float64
    on ``device`` (``None``: the card); it is filtered there and binned
    as float32 by ``Bin2D`` (kernel B1 on the card)."""
    dev = resolve(device)
    modrmap = geom.modrmap_np()
    binner = Bin2D(modrmap, np.asarray(bin_edges_arcmin) * arcmin,
                   device=dev)
    if sigma_mis is not None and float(sigma_mis) > 0:
        # zero/None width means centered: rayleigh(., 0) is 0/0 NaN
        com_mpc = float(cc.comoving_radial_distance(z))
        R_off = float(sigma_mis) * arcmin * com_mpc   # comoving Mpc
        k = kappa_nfw_profiley(
            geom, mass=mass, conc=conc, z=z, z_s=z_s,
            delta=overdensity, critical=critical, R_off_Mpc=R_off,
            R_off_Mpc_max=max(4.0 * R_off, 1.0),
            at_cluster_z=at_cluster_z, cc=cc, device=dev)
    else:
        k = nfw_kappa(mass, modrmap, cc, zL=z, concentration=conc,
                      overdensity=overdensity, critical=critical,
                      at_cluster_z=at_cluster_z, z_s=z_s, device=dev)
    if include_2h:
        k = k + kappa_2h_map(geom, mass, z, cc, z_s=z_s,
                             critical=critical, overdensity=overdensity,
                             at_cluster_z=at_cluster_z, device=dev)
    if kmask is None:
        kmask = F.mask_kspace(geom, lmin=lmin, lmax=lmax, device=dev)
    kf = F.kfilter(k, torch.as_tensor(kmask, device=dev), geom)
    return binner.bin(kf.to(torch.float32).contiguous())


def fit_nfw_profile(profile_data, profile_cov, masses, z, conc, cc,
                    geom: Geometry, bin_edges_arcmin, lmax, lmin=None,
                    overdensity=200.0, critical=False, at_cluster_z=True,
                    mass_guess=2e14, sigma_guess=2e13, kmask=None,
                    include_2h=False, sigma_mis=None, device=None):
    """Mass likelihood from a measured kappa profile (reference
    ``lensing.py:313``): scan lnL(M), Gaussian fit for (M, sigma_M).
    ``include_2h``/``sigma_mis`` forward to :func:`binned_nfw` (the
    reference's ``improved=True`` model); the profiles are binned on
    ``device`` (``None``: the card), the likelihood is host numpy."""
    from ..utils.fitting import fit_gauss
    dev = resolve(device)
    cinv = np.linalg.inv(np.asarray(profile_cov))
    p2h_unit = None
    if include_2h:
        # the 2-halo term is exactly linear in the scalar bias b(M):
        # bin the unit-bias profile ONCE and scale per scanned mass
        # (the Limber + Hankel quadrature is mass-independent)
        kmask_eff = kmask if kmask is not None \
            else F.mask_kspace(geom, lmin=lmin, lmax=lmax, device=dev)
        k2h_unit = kappa_2h_map(geom, 1.0, z, cc, critical=critical,
                                overdensity=overdensity,
                                at_cluster_z=at_cluster_z, bias=1.0,
                                device=dev)
        modrmap = geom.modrmap_np()
        b2 = Bin2D(modrmap,
                   np.asarray(bin_edges_arcmin) * arcmin, device=dev)
        kf = F.kfilter(k2h_unit, torch.as_tensor(kmask_eff, device=dev),
                       geom)
        _, p2h = b2.bin(kf.to(torch.float32).contiguous())
        p2h_unit = p2h.cpu().numpy().astype(np.float64)
    lnlikes = []
    fprofiles = []
    for mass in masses:
        _, prof = binned_nfw(mass, z, conc, cc, geom, bin_edges_arcmin,
                             lmax, lmin, overdensity, critical,
                             at_cluster_z, kmask=kmask,
                             include_2h=False, sigma_mis=sigma_mis,
                             device=dev)
        prof = prof.cpu().numpy().astype(np.float64)
        if include_2h:
            b = halo_bias(abs(float(mass)), z, cc, critical=critical,
                          overdensity=overdensity,
                          at_cluster_z=at_cluster_z)
            prof = prof + np.sign(float(mass)) * b * p2h_unit
        diff = np.asarray(profile_data) - prof
        fprofiles.append(prof)
        lnlikes.append(-0.5 * diff @ cinv @ diff)
    lnlikes = np.asarray(lnlikes)
    like = np.exp(lnlikes - lnlikes.max())
    fit_mass, mass_err, _, _ = fit_gauss(np.asarray(masses), like,
                                         mu_guess=mass_guess,
                                         sigma_guess=sigma_guess)
    gaussian = lambda t, mu, s: np.exp(-(t - mu) ** 2 / 2 / s ** 2) \
        / np.sqrt(2 * np.pi * s ** 2)
    like_fit = gaussian(np.asarray(masses), fit_mass, mass_err)
    _, fit_profile = binned_nfw(fit_mass, z, conc, cc, geom,
                                bin_edges_arcmin, lmax, lmin, overdensity,
                                critical, at_cluster_z, kmask=kmask,
                                include_2h=include_2h,
                                sigma_mis=sigma_mis, device=dev)
    return (lnlikes, like_fit, fit_mass, mass_err, np.asarray(fprofiles),
            fit_profile.cpu().numpy().astype(np.float64))


def filter_bin_kappa2d(omap, geom: Geometry, fls=None, lmin=200, lmax=6000,
                       rmin=0.0, rmax=15 * arcmin, rwidth=0.1 * arcmin,
                       taper_per=12.0, device=None):
    """Taper, Fourier-filter and radially bin a kappa stamp (reference
    ``lensing.py:115``): a tensor ``omap`` keeps its device, a host array
    goes to ``device`` (``None``: the card); binned as float32."""
    omap = as_tensor(omap, device, torch.float32)
    dev = omap.device
    taper, _ = get_taper(geom, taper_percent=taper_per, device=dev)
    kmask = F.mask_kspace(geom, lmin=lmin, lmax=lmax, device=dev)
    if fls is not None:
        kfilt = F.interp1d_to_2d(np.arange(len(fls)), fls, geom, device=dev)
        kfilt = kfilt * kmask
    else:
        kfilt = kmask
    fmap = F.kfilter(omap * taper, kfilt, geom)
    edges = np.arange(rmin, rmax, rwidth)
    binner = Bin2D(geom.modrmap_np(), edges, device=dev)
    return binner.bin(fmap.contiguous())


def filter_bin_kappa1d(thetas, kappas, fls=None, lmin=200, lmax=6000,
                       res=0.05 * arcmin, rstamp=30.0 * arcmin,
                       rmin=0.0, rmax=15 * arcmin, rwidth=0.1 * arcmin,
                       device=None):
    """Paint a 1D kappa profile onto a stamp, then filter+bin (reference
    ``lensing.py:108``) on ``device`` (``None``: the card)."""
    n = int(rstamp / res)
    g = Geometry(n, n, res, res)
    modr = g.modrmap_np()
    omap = np.interp(modr, np.asarray(thetas), np.asarray(kappas))
    return filter_bin_kappa2d(omap, g, fls=fls, lmin=lmin, lmax=lmax,
                              rmin=rmin, rmax=rmax, rwidth=rwidth,
                              device=device)


# ------------------------------------------------------------------
# lensed pixel-pixel covariances (reference lensing.py:525-648)
# ------------------------------------------------------------------

def _lens_rows(cov, alpha, geom: Geometry, order: int):
    """Every row of a (npix, npix) covariance lensed as a map: one call of
    :func:`lens_map_spline` on the (npix, ny, nx) batch, the deflection
    shared by the batch."""
    rows = cov.reshape((-1,) + geom.shape)
    out = lens_map_spline(rows, alpha.expand((rows.shape[0],)
                                             + tuple(alpha.shape)),
                          geom, order=order)
    return out.reshape(cov.shape)


def _beam_rows(cov, kbeam, geom: Geometry):
    rows = cov.reshape((-1,) + geom.shape)
    return F.kfilter(rows, kbeam, geom).reshape(cov.shape)


def lens_cov(ucov, alpha, geom: Geometry, lens_order: int = 5, kbeam=None,
             device=None):
    """Lensed covariance L U L^T (+ beam) from the unlensed pix-pix
    covariance (reference ``lens_cov``, ``lensing.py:588``): lens rows,
    then columns (transpose), then optionally beam-convolve both sides.
    Float32: tensors keep their device, host arrays go to ``device``
    (``None``: the card); each side is one batched B8 call there."""
    ucov = as_tensor(ucov, device, torch.float32)
    alpha = as_tensor(alpha, ucov.device, torch.float32)
    cov = _lens_rows(ucov, alpha, geom, lens_order)
    cov = _lens_rows(cov.T.contiguous(), alpha, geom, lens_order)
    if kbeam is not None:
        kbeam = torch.as_tensor(kbeam, dtype=cov.dtype, device=cov.device)
        cov = _beam_rows(cov.T, kbeam, geom)
        cov = _beam_rows(cov.T, kbeam, geom)
    return cov


def beam_cov(cov, kbeam, geom: Geometry, device=None):
    """Beam-convolve a pix-pix covariance on both sides (reference
    ``beam_cov``, ``lensing.py:626``); ``device`` as in
    :func:`lens_cov`."""
    cov = as_tensor(cov, device, torch.float32)
    kbeam = torch.as_tensor(kbeam, dtype=cov.dtype, device=cov.device)
    out = _beam_rows(cov, kbeam, geom)
    return _beam_rows(out.T, kbeam, geom)


def lens_cov_pol(ucov, alpha_pix, geom: Geometry, lens_order: int = 5,
                 kbeam=None, device=None):
    """Polarized lensed covariance: (ncomp, ncomp, npix, npix) blocks,
    each lensed like :func:`lens_cov` (reference ``lensing.py:525``; the
    comm-rank row loop is a batch of maps here)."""
    ucov = as_tensor(ucov, device, torch.float32)
    ncomp = ucov.shape[0]
    scale = torch.tensor([geom.dy, geom.dx], dtype=torch.float32,
                         device=ucov.device).reshape(2, 1, 1)
    alpha = as_tensor(alpha_pix, ucov.device, torch.float32) * scale
    return torch.stack([
        torch.stack([lens_cov(ucov[i, j], alpha, geom, lens_order, kbeam)
                     for j in range(ncomp)])
        for i in range(ncomp)])


# ---------------------------------------------------------------------------
# Generic projected-density kappa, explicit-(M, c, R) NFW, matched-filter
# mass estimate and the Rayleigh profile (reference lensing.py:828-866,
# 730, 960)
# ---------------------------------------------------------------------------

def rayleigh(theta, sigma):
    """Rayleigh miscentering distribution theta/sigma^2
    exp(-theta^2/2sigma^2) (reference ``lensing.py:960``); a tensor stays
    a tensor, anything else becomes host numpy."""
    if isinstance(theta, torch.Tensor):
        ex = torch.exp
    else:
        theta, ex = np.asarray(theta), np.exp
    s2 = sigma * sigma
    return theta / s2 * ex(-0.5 * theta * theta / s2)


def _atleast_1d(theta, device):
    return torch.atleast_1d(_as_f64(theta, device))


def kappa_from_rhofunc(M, c, R, theta, cc, z, rho_func=None, device=None):
    """Convergence from a generic 3D density rho(r) at lens redshift z
    (reference ``lensing.py:828``): delegates the LOS projection to
    ``lensing.kappa_generic``; defaults to the NFW density of
    (M, c, R). ``device`` as in :func:`nfw_kappa`."""
    from .lensing import kappa_generic, rho_nfw
    sgn = 1.0 if M > 0 else -1.0
    if rho_func is None:
        rho_func = rho_nfw(abs(M), c, R)
    comS = cc.comoving_radial_distance(cc.cmbZ) * cc.h
    comL = cc.comoving_radial_distance(z) * cc.h
    win = (comS - comL) / comS
    return sgn * kappa_generic(_atleast_1d(theta, device), z,
                               comL, rho_func, win)


def kappa_nfw(M, c, R, theta, cc, z, device=None):
    """NFW convergence at explicit (mass, concentration, R) — reference
    ``lensing.py:858`` (vs ``nfw_kappa``'s overdensity-implied R);
    ``device`` as in :func:`nfw_kappa`."""
    from .lensing import kappa_nfw_generic
    sgn = 1.0 if M > 0 else -1.0
    comS = cc.comoving_radial_distance(cc.cmbZ) * cc.h
    comL = cc.comoving_radial_distance(z) * cc.h
    win = (comS - comL) / comS
    return sgn * kappa_nfw_generic(_atleast_1d(theta, device), z,
                                   comL, abs(M), c, R, win)


def mass_estimate(kappa_recon, kappa_noise_2d, geom: Geometry,
                  mass_guess, concentration, z, cc=None, kmask=None,
                  niter=3, device=None):
    """Matched-filter mass estimate of a cutout kappa reconstruction (the
    JAX package's working version of reference ``lensing.py:730``): fit
    the amplitude of an NFW template with the 2D-noise-weighted matched
    filter (``mapstools.MatchedFilter``), convert amplitude to mass, and
    iterate the template mass to self-consistency. Runs on
    ``kappa_recon``'s device (``device`` for a host map).

    Returns (mass, mass_variance)."""
    from .cosmology import Cosmology
    from .mapstools import MatchedFilter
    if cc is None:
        cc = Cosmology()
    kappa_recon = as_tensor(kappa_recon, device)
    dev = kappa_recon.device
    modr = torch.as_tensor(geom.modrmap_np(), device=dev)
    m = float(mass_guess)
    for _ in range(niter):
        temp = nfw_kappa(m, modr, cc, zL=z,
                         concentration=concentration).reshape(geom.shape)
        mf = MatchedFilter(geom, temp, kappa_noise_2d)
        amp, var = mf.apply(kappa_recon, kmask=kmask)
        m = float(amp) * m
    return m, float(var) * mass_guess ** 2


def kappa_nfw_profiley1d(thetas, mass=2e14, conc=3.0, z=0.7, z_s=1100.0,
                         delta=500, critical=True, R_off_Mpc=None,
                         R_off_Mpc_max=1.0, N_off=50, N_phi=64,
                         at_cluster_z=True, cc=None, device=None):
    """Miscentered NFW convergence profile (the role of reference
    ``lensing.py`` ``kappa_nfw_profiley1d``, natively instead of the
    profiley/pyccl/colossus stack): the centered profile from the
    closed-form NFW kappa, then an offset convolution

        kappa_off(R) = int dR' P(R') <kappa(|R - R'|)>_phi

    with the azimuthal average on an ``N_phi`` quadrature and a
    Rayleigh offset distribution of width ``R_off_Mpc`` truncated at
    ``R_off_Mpc_max`` (``N_off`` nodes). thetas in radians (float64: a
    tensor keeps its device, host values go to ``device``); returns the
    kappa profile (and the centered one when miscentering is on).
    """
    from .cosmology import Cosmology
    if cc is None:
        cc = Cosmology()
    comL = cc.comoving_radial_distance(z) * cc.h
    comS = cc.comoving_radial_distance(z_s) * cc.h
    win = (comS - comL) / comS
    thetas = _atleast_1d(thetas, device)
    f64 = dict(dtype=torch.float64, device=thetas.device)
    zdensity = z if at_cluster_z else 0.0
    # |M| for the radius (signed-mass templates scale the amplitude
    # only — same convention as nfw_kappa)
    rdel = (cc.rdel_c(abs(mass), zdensity, delta) if critical
            else cc.rdel_m(abs(mass), zdensity, delta))
    kap = lambda th: nfw_kappa_profile(
        th, mass, comL, win, z, conc, rdel_mpc_overh=float(rdel))
    k1 = kap(thetas)
    if R_off_Mpc is None:
        return k1
    if R_off_Mpc <= 0:
        # zero offset width = centered (rayleigh(., 0) is 0/0 NaN);
        # keep the two-element return contract of the offset branch
        return k1, k1
    # offsets in angle: R_off [Mpc/h] -> theta_off = R_off / comL
    roffs = torch.linspace(1e-4, R_off_Mpc_max, N_off, **f64) * cc.h
    toffs = roffs / comL                                      # Mpc/h above
    pr = rayleigh(roffs, R_off_Mpc * cc.h)
    pr = pr / torch.trapezoid(pr, roffs)
    phis = torch.linspace(0.0, 2 * np.pi, N_phi + 1, **f64)[:-1]
    # |theta - theta_off| on the (theta, off, phi) grid
    t = thetas[:, None, None]
    to = toffs[None, :, None]
    ph = phis[None, None, :]
    sep = torch.sqrt(t ** 2 + to ** 2 - 2 * t * to * torch.cos(ph))
    kgrid = kap(sep.reshape(-1)).reshape(sep.shape)
    kphi = kgrid.mean(dim=-1)                        # azimuthal average
    koff = torch.trapezoid(kphi * pr[None, :], roffs, dim=-1)
    return koff, k1


def kappa_nfw_profiley(geom: Geometry, mass=2e14, conc=3.0, z=0.7,
                       z_s=1100.0, delta=500, critical=True,
                       R_off_Mpc=None, device=None, **kw):
    """2D miscentered NFW kappa stamp on a geometry (reference
    ``lensing.py`` ``kappa_nfw_profiley``): paints the 1D profile of
    :func:`kappa_nfw_profiley1d` on the distance-to-center map, a
    float64 tensor on ``device`` (``None``: the card)."""
    modr = geom.modrmap_np()
    dev = resolve(device)
    ths = torch.as_tensor(np.geomspace(
        max(float(modr[modr > 0].min()) * 0.5, 1e-7),
        float(modr.max()) * 1.05, 256), dtype=torch.float64, device=dev)
    prof = kappa_nfw_profiley1d(ths, mass=mass, conc=conc, z=z, z_s=z_s,
                                delta=delta, critical=critical,
                                R_off_Mpc=R_off_Mpc, **kw)
    if R_off_Mpc is not None:
        prof = prof[0]
    modr_t = torch.as_tensor(modr.reshape(-1), dtype=torch.float64,
                             device=dev)
    return interp(modr_t, ths, prof, left=prof[0],
                  right=prof[-1]).reshape(geom.shape)


def NFWMatchedFilterSN(cc, log10Moverh, c, z, ells, Nls, kellmax,
                       overdensity=500.0, critical=True, at_cluster_z=True,
                       arc_stamp=100.0, px_stamp=0.05,
                       rayleigh_sigma_arcmin=None, win_at_lens=None,
                       return_kappa=False, verbose=False, device=None):
    """Matched-filter S/N forecast for an NFW cluster kappa profile
    against a lensing-reconstruction noise curve (reference
    ``orphics/lensing.py:771``).

    Builds the normalized cluster template U = kappa/k500 on a fine
    stamp, optionally convolves with a Rayleigh miscentering
    distribution, and returns (S/N, k500, sigma) with
    1/sigma^2 = sum_l |U(l)|^2 / N_l over the annulus
    [2pi/stamp, kellmax]. The template is painted on ``device``
    (``None``: the card); the filter sums are host numpy.
    """
    M = 10.0 ** log10Moverh
    n = int(arc_stamp / px_stamp)
    g = Geometry(n, n, px_stamp * arcmin, px_stamp * arcmin)
    kellmin = 2.0 * np.pi / (arc_stamp * arcmin)

    modrmap = g.modrmap_np()
    modlmap = g.modlmap_np()

    if win_at_lens is None:  # CMB lensing source plane
        comS = cc.comoving_radial_distance(cc.cmbZ) * cc.h
        comL = cc.comoving_radial_distance(z) * cc.h
        win_at_lens = (comS - comL) / comS

    kappa, r_del = NFWkappa(cc, M, c, z, modrmap * 180.0 * 60.0 / np.pi,
                            win_at_lens, overdensity=overdensity,
                            critical=critical, at_cluster_z=at_cluster_z,
                            device=device)
    kappa = kappa.cpu().numpy()
    dAz = cc.angular_diameter_distance(z) * cc.h
    th500 = r_del / dAz
    fiveth500 = 5.0 * th500

    kappa = np.where(modrmap > fiveth500, 0.0, kappa)
    pixarea = float(g.dy) * float(g.dx)
    k500 = kappa.sum() * pixarea
    if verbose:
        print("integral of kappa inside disc ", k500)
    Ukappa = kappa / k500

    Uft = np.fft.fft2(Ukappa)
    if rayleigh_sigma_arcmin is not None:
        assert rayleigh_sigma_arcmin >= px_stamp
        pray = rayleigh(modrmap * 180.0 * 60.0 / np.pi,
                        rayleigh_sigma_arcmin)
        rayk = np.fft.fft2(np.fft.ifftshift(np.asarray(pray)))
        rayk = rayk / rayk[modlmap < 1e-3]
        Uft = Uft * rayk
    Upower = (Uft * Uft.conj()).real * float(g.area) / g.npix ** 2

    Nls = np.asarray(Nls, dtype=float).copy()
    Nls[Nls < 0] = 0.0
    nl2d = np.interp(modlmap, np.asarray(ells, float), Nls)
    filt = np.zeros_like(Upower)
    sel = (modlmap >= kellmin) & (modlmap <= kellmax) & (nl2d > 0)
    filt[sel] = Upower[sel] / nl2d[sel]
    varinv = filt.sum()
    std = np.sqrt(1.0 / varinv)
    sn = k500 / std
    if verbose:
        print(sn)
    if return_kappa:
        return sn, np.fft.ifft2(Uft).real * k500
    return sn, k500, std
