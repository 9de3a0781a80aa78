"""Curved-sky map operations on the native SHT (port of the SHT half and
the masks of ``orphics_tpu.models.curved``).

Replacements for the reference's ``pixell.curvedsky`` / ``healpy`` call
sites: ``rand_map`` / ``rand_cmb_sim`` (reference ``orphics/maps.py:716,
1052``), ``wfactor`` (:936), ``cosine_stitch`` / ``stitched_noise``
(:967, :975), ``kspace_coadd_alms`` (:1121), ``modulated_noise_map``
(:1155), ``hp.smoothing``-style beams, and the analytic ``galactic_mask``
(:1186). Sphere fields live on :class:`~orphics_tpu_torch.ops.sht.RingGeom`
grids as dense ``(ntheta, nphi)`` tensors; alms use healpy packing.

Every draw takes a ``torch.Generator`` and has a ``*_from_noise`` twin that
takes the standard normals, so the tests feed both packages the same draws.
Not ported yet: ``rotate_map``, ``MapRotator``, ``MapRotatorEquator``,
``get_rotated_pixels`` (they resample through ``mapstools._bilinear_at``,
ROADMAP queue A item 13b) and ``cutout_gnomonic`` (``utils/healpix``, item
21); each raises ``NotImplementedError``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .._device import resolve
from ..geometry import Geometry
from ..ops import alm as almops
from ..ops import sht
from ..ops.sht import RingGeom

__all__ = [
    "synalm_matrix", "synalm_matrix_from_noise", "rand_map",
    "rand_map_from_noise", "rand_cmb_sim", "smoothing", "pixsize_map",
    "wfactor", "masked_cls", "cosine_taper_ells", "cosine_stitch",
    "white_noise", "stitched_noise", "kspace_coadd_alms",
    "modulated_noise_map", "gal2equ_rotation", "pointing_rotation",
    "galactic_mask", "galactic_mask_rings", "galactic_mask_equ",
    "north_galactic_mask", "south_galactic_mask", "rotate_map",
    "MapRotator", "MapRotatorEquator", "get_rotated_pixels",
    "cutout_gnomonic",
]


# ---------------------------------------------------------------------------
# Correlated alm synthesis
# ---------------------------------------------------------------------------

def _ps_root(ps, lmax):
    """Per-l symmetric PSD square root of ``ps`` (nc, nc, nl) (eigh with
    the eigenvalues clamped at 0), padded or cut to lmax + 1: (L1, nc,
    nc) float64 numpy."""
    mats = np.moveaxis(np.asarray(ps, np.float64), -1, 0)
    mats = 0.5 * (mats + np.swapaxes(mats, -1, -2))
    evals, evecs = np.linalg.eigh(mats)
    root = np.einsum("lij,lj,lkj->lik", evecs,
                     np.sqrt(np.clip(evals, 0.0, None)), evecs)
    if root.shape[0] < lmax + 1:
        root = np.pad(root, ((0, lmax + 1 - root.shape[0]), (0, 0), (0, 0)))
    return root[: lmax + 1]


def synalm_matrix_from_noise(re, im, ps, lmax: int):
    """Correlated alms ``(..., nc, nalm)`` from standard normals ``re, im``
    ``(..., nc, nalm)`` and a spectra matrix ``ps`` (nc, nc, nl): unit
    alms (:func:`~orphics_tpu_torch.ops.alm.synalm_from_noise`) mixed by
    the per-l square root of ``ps``."""
    unit = almops.synalm_from_noise(re, im, np.ones(lmax + 1), lmax)
    ls, _ = almops.lm_indices(lmax)
    mix = torch.as_tensor(_ps_root(ps, lmax)[ls], dtype=re.dtype,
                          device=re.device)               # (nalm, nc, nc)
    return torch.einsum("kij,...jk->...ik", mix.to(unit.dtype), unit)


def synalm_matrix(generator: torch.Generator, ps, lmax: int,
                  dtype=torch.float32, device=None):
    """Correlated ``(nc, nalm)`` alms of the spectra matrix ``ps`` (nc, nc,
    nl), drawn with ``generator`` (reference ``cs.rand_map``'s ps input)."""
    nc = np.shape(ps)[0]
    shape = (nc, almops.nalm(lmax))
    device = resolve(device)
    re = torch.randn(shape, generator=generator, dtype=dtype, device=device)
    im = torch.randn(shape, generator=generator, dtype=dtype, device=device)
    return synalm_matrix_from_noise(re, im, ps, lmax)


def _check_pol(ps, pol):
    if pol is not None and bool(pol) != (ps.ndim == 3 and ps.shape[0] == 3):
        raise ValueError(
            f"pol={pol} inconsistent with ps shape {ps.shape}: polarized "
            "synthesis needs a (3, 3, nl) T/E/B spectra matrix, spin-0 a 1D "
            "(or (1, 1, nl)) spectrum")


def rand_map_from_noise(re, im, rings: RingGeom, ps, lmax: int):
    """Curved-sky GRF from standard normals: ``re, im`` ``(..., nalm)``
    for a 1D spectrum ``ps``, ``(..., nc, nalm)`` for a matrix. Returns
    ``(..., ntheta, nphi)`` (one component) or ``(..., 3, ntheta, nphi)``
    (T, Q, U)."""
    ps = np.asarray(ps)
    if ps.ndim == 1:
        return sht.alm2map(almops.synalm_from_noise(re, im, ps, lmax),
                           rings, lmax)
    alms = synalm_matrix_from_noise(re, im, ps, lmax)
    if ps.shape[0] == 1:
        return sht.alm2map(alms[..., 0, :], rings, lmax)
    return sht.alm2map_pol(alms, rings, lmax)


def rand_map(generator: torch.Generator, rings: RingGeom, ps, lmax: int,
             pol: bool = None, nsims: int = None, dtype=torch.float32,
             device=None):
    """Curved-sky GRF realization (reference ``cs.rand_map``,
    ``orphics/maps.py:744``): a 1D TT spectrum or a (nc, nc, nl) matrix in
    T, E, B order (polarization through spin 2). With ``nsims`` a leading
    sims axis; the batch rides the packed Legendre kernels."""
    ps = np.asarray(ps.cpu() if torch.is_tensor(ps) else ps)
    _check_pol(ps, pol)
    shape = (() if nsims is None else (nsims,)) \
        + (() if ps.ndim == 1 else (ps.shape[0],)) + (almops.nalm(lmax),)
    device = resolve(device)
    re = torch.randn(shape, generator=generator, dtype=dtype, device=device)
    im = torch.randn(shape, generator=generator, dtype=dtype, device=device)
    return rand_map_from_noise(re, im, rings, ps, lmax)


def rand_cmb_sim(generator: torch.Generator, rings: RingGeom, lmax: int,
                 lensed=True, theory=None, dtype=torch.float32, device=None):
    """Lensed-CMB T, Q, U sky (reference ``rand_cmb_sim``,
    ``maps.py:1052``)."""
    from .grf import cmb_ps
    from .theory import default_theory
    theory = default_theory() if theory is None else theory
    return rand_map(generator, rings, cmb_ps(theory, lmax=lmax,
                                             lensed=lensed), lmax,
                    dtype=dtype, device=device)


def _gauss_bl(fwhm_arcmin, lmax):
    sigma = np.deg2rad(fwhm_arcmin / 60.0) / math.sqrt(8.0 * math.log(2.0))
    ell = np.arange(lmax + 1)
    return np.exp(-0.5 * ell * (ell + 1) * sigma ** 2)


def smoothing(imap, rings: RingGeom, fwhm_arcmin: float, lmax: int):
    """Gaussian-beam smoothing on the sphere (``hp.smoothing`` /
    ``cs.filter`` role, reference ``maps.py:2979``)."""
    a = sht.map2alm(imap, rings, lmax)
    return sht.alm2map(almops.almxfl(a, _gauss_bl(fwhm_arcmin, lmax)),
                       rings, lmax)


# ---------------------------------------------------------------------------
# Mask factors and masked spectra
# ---------------------------------------------------------------------------

def pixsize_map(rings: RingGeom, dtype=torch.float64, device=None):
    """Per-pixel solid angle of a ring grid (quadrature weight x dphi)."""
    w = torch.as_tensor(rings.weights_array() * (2 * np.pi / rings.nphi),
                        dtype=dtype, device=resolve(device))
    return w[:, None].expand(rings.shape)


def wfactor(n: int, mask, rings: RingGeom = None, sht_norm: bool = True):
    """Mask power correction ``<mask^n>`` (reference ``wfactor``,
    ``maps.py:936``), float64: to the full sky's 4 pi with ``sht_norm``,
    else to the mask's own area; a plain mean without ``rings``."""
    mask = torch.as_tensor(mask).to(torch.float64)
    if rings is None:
        return torch.mean(mask ** n)
    pmap = pixsize_map(rings, device=mask.device)
    tot = torch.sum(mask ** n * pmap)
    return tot / (4 * np.pi) if sht_norm else tot / torch.sum(pmap)


def masked_cls(alm, w2):
    """Mask-debiased pseudo-Cl (reference ``maps.py:1009``)."""
    return almops.alm2cl(alm) / w2


# ---------------------------------------------------------------------------
# Stitched noise (reference maps.py:967-1025)
# ---------------------------------------------------------------------------

def cosine_taper_ells(ls, lstart, lwidth, device=None):
    """1 up to ``lstart``, a cosine ramp to 0 over ``lwidth``, float64; a
    tensor ``ls`` keeps its device, other ls go to ``device`` (the card
    unless it names another)."""
    if torch.is_tensor(ls):
        ls = ls.to(torch.float64)
    else:
        ls = torch.as_tensor(np.asarray(ls), dtype=torch.float64,
                             device=resolve(device))
    ramp = 1 - 0.5 * (1 - torch.cos(-np.pi * (ls - lstart) / lwidth))
    fl = torch.where(ls > lstart, ramp, torch.ones_like(ls))
    return torch.where(ls > lstart + lwidth, 0.0, fl)


def cosine_stitch(alm1, map2, rings: RingGeom, lstitch, lcosine, mlmax):
    """Stitch a band-limited alm with a real-space map: ``alm1`` tapers off
    above ``lstitch``; map2's large scales below are removed in quadrature
    (reference ``cosine_stitch``, ``maps.py:967``)."""
    fl1 = cosine_taper_ells(np.arange(mlmax + 1), lstitch, lcosine,
                            alm1.device)
    fl2 = torch.sqrt(torch.clamp(1.0 - fl1 ** 2, min=0.0))
    alm1 = almops.change_alm_lmax(alm1, mlmax)
    a2 = sht.map2alm(map2, rings, mlmax)
    omap2 = map2 - sht.alm2map(almops.almxfl(a2, 1.0 - fl2), rings, mlmax)
    return sht.alm2map(almops.almxfl(alm1, fl1), rings, mlmax) + omap2


def white_noise(generator: torch.Generator, rings: RingGeom, rms_uk_arcmin,
                dtype=torch.float64, device=None):
    """White noise of ``rms_uk_arcmin`` on a ring grid (per-pixel sigma
    ``Delta / sqrt(Omega_pix)``)."""
    device = resolve(device)
    sig = rms_uk_arcmin * np.pi / (180.0 * 60.0) \
        / torch.sqrt(pixsize_map(rings, dtype, device))
    return torch.randn(rings.shape, generator=generator, dtype=dtype,
                       device=device) * sig


def stitched_noise(generator: torch.Generator, rings: RingGeom, alm, mask,
                   rms_uk_arcmin=None, lstitch=None, lcosine=80, mlmax=None,
                   alpha=-4, flmin=700):
    """Stitch homogeneous white noise onto a band-limited noise sim
    (reference ``stitched_noise``, ``maps.py:975``); without a white level
    it is fit (host, scipy) from the red+white model of the alm's masked
    spectrum, as the reference does. Runs on ``alm``'s device."""
    almax = almops.getlmax(alm.shape[-1])
    mlmax = min(almax + 800, 2 * almax) if mlmax is None else mlmax
    lstitch = almax - max(2 * lcosine, 100) if lstitch is None else lstitch
    mask = torch.as_tensor(mask, device=alm.device)
    bmask = mask > 0.5
    if rms_uk_arcmin is None:
        from scipy.optimize import curve_fit
        from .noise import rednoise
        w2 = float(wfactor(2, mask, rings))
        wcls = masked_cls(alm, w2).cpu().numpy()
        ls = np.arange(wcls.size)
        sel = ls > flmin
        rfunc = lambda l, rms, lknee: rednoise(l, rms, lknee=lknee,
                                               alpha=alpha,
                                               device="cpu").numpy()
        popt, _ = curve_fit(rfunc, ls[sel], wcls[sel], p0=[1e-3, 1000])
        rms = popt[0]
    else:
        rms = rms_uk_arcmin
    wmap = white_noise(generator, rings, rms, alm.real.dtype,
                       alm.device) * bmask
    return cosine_stitch(alm, wmap, rings, lstitch, lcosine, mlmax) * bmask


def kspace_coadd_alms(alms, lbeams, nls, fkbeam=1.0):
    """Inverse-noise coadd in alm space (reference ``kspace_coadd_alms``,
    ``maps.py:1121``): ``w_i = b_i f / N_i / sum_j b_j^2 / N_j``."""
    lbeams = torch.as_tensor(np.asarray(lbeams), dtype=torch.float64)
    nls = torch.as_tensor(np.asarray(nls), dtype=torch.float64)
    weight = lbeams * fkbeam / nls / torch.sum(lbeams ** 2 / nls, dim=0)
    weight = torch.nan_to_num(weight, nan=0.0, posinf=0.0, neginf=0.0)
    out = 0.0
    for i in range(len(alms)):
        out = out + almops.almxfl(alms[i], weight[i])
    return out


def modulated_noise_map(generator: torch.Generator, ivar, rings: RingGeom,
                        lknee=None, alpha=None, lmax=None,
                        n_ell_standard=None):
    """Inhomogeneous 1/f-modulated noise (reference
    ``modulated_noise_map``, ``maps.py:1155``): a GRF of the whitened
    N_ell, modulated by the per-pixel rms from ``ivar``, on ``ivar``'s
    device and in its dtype."""
    from .noise import atm_factor
    ivar = torch.as_tensor(ivar)
    rms = torch.where(ivar > 0, 1.0 / torch.sqrt(torch.clamp(ivar,
                                                             min=1e-30)),
                      0.0)
    if n_ell_standard is None and lknee is None:
        return torch.randn(rings.shape, generator=generator,
                           dtype=ivar.dtype, device=ivar.device) * rms
    if n_ell_standard is None:
        n_ell_standard = np.nan_to_num(atm_factor(
            np.arange(lmax + 1), lknee, alpha, "cpu").numpy()) + 1.0
    n_ell_standard = np.asarray(n_ell_standard)
    smap = rand_map(generator, rings, n_ell_standard,
                    lmax=len(n_ell_standard) - 1, dtype=ivar.dtype,
                    device=ivar.device)
    return rms * smap


# ---------------------------------------------------------------------------
# Rotations and galactic masks
# ---------------------------------------------------------------------------

# J2000 equatorial -> galactic rotation (IAU); rows are the galactic basis
# vectors in equatorial coordinates.
_R_GAL = np.array([
    [-0.0548755604, -0.8734370902, -0.4838350155],
    [+0.4941094279, -0.4448296300, +0.7469822445],
    [-0.8676661490, -0.1980763734, +0.4559837762]])


def gal2equ_rotation(inverse=False):
    """3x3 rotation taking galactic unit vectors to equatorial
    (``inverse=True``: equatorial -> galactic)."""
    return _R_GAL if inverse else _R_GAL.T


def pointing_rotation(center_source, center_target):
    """Rotation mapping target-frame unit vectors to the source frame
    (undo the target RA, rotate the dec difference about y, apply the
    source RA), float64 numpy."""
    decs, ras = center_source
    dect, rat = center_target

    def rz(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])

    def ry(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])

    return rz(ras) @ ry(dect - decs) @ rz(-rat)


def _strip_mask(dec, ra, theta1, theta2, coords, dtype, device):
    """1 outside the galactic colatitude strip [theta1, theta2], 0 inside,
    evaluated in float64 on the host at (dec, ra)."""
    cd = np.cos(dec)
    v = np.stack([cd * np.cos(ra), cd * np.sin(ra), np.sin(dec)], -1)
    vg = np.einsum("ij,...j->...i", _R_GAL, v) if coords == "equ" else v
    colat = np.arccos(np.clip(vg[..., 2], -1.0, 1.0))
    inside = (colat >= min(theta1, theta2)) & (colat <= max(theta1, theta2))
    return torch.as_tensor(np.where(inside, 0.0, 1.0), dtype=dtype,
                           device=resolve(device))


def galactic_mask(geom: Geometry, theta1, theta2, coords="equ",
                  dtype=torch.float32, device=None):
    """Mask of the galactic colatitude strip [theta1, theta2] on a flat
    equatorial patch (reference ``galactic_mask``, ``maps.py:1186``): 1
    outside the strip, 0 inside."""
    iy = (np.arange(geom.ny) - (geom.ny - 1) / 2) * geom.dy
    ix = (np.arange(geom.nx) - (geom.nx - 1) / 2) * geom.dx
    dec, ra = np.meshgrid(geom.y0 + iy, ix, indexing="ij")
    return _strip_mask(dec, ra, theta1, theta2, coords, dtype, device)


def galactic_mask_rings(rings: RingGeom, theta1, theta2, coords="equ",
                        dtype=torch.float32, device=None):
    """The same strip mask on a full-sky ring grid."""
    phi = rings.phi0 + 2 * np.pi * np.arange(rings.nphi) / rings.nphi
    dec, ra = np.meshgrid(np.pi / 2 - rings.theta_array(), phi,
                          indexing="ij")
    return _strip_mask(dec, ra, theta1, theta2, coords, dtype, device)


def galactic_mask_equ(geom, theta1, theta2, **kw):
    """Galactic strip mask with colatitudes from the galactic equator
    (reference ``maps.py:1193``)."""
    return galactic_mask(geom, np.pi / 2.0 - theta1, np.pi / 2.0 - theta2,
                         **kw)


def north_galactic_mask(geom, **kw):
    """Keeps the northern galactic hemisphere (reference ``maps.py:1197``)."""
    return galactic_mask(geom, np.deg2rad(90.0), np.deg2rad(180.0), **kw)


def south_galactic_mask(geom, **kw):
    """Keeps the southern galactic hemisphere (reference ``maps.py:1200``)."""
    return galactic_mask(geom, 0.0, np.deg2rad(90.0), **kw)


_WAIT = ("needs the port of models/mapstools' _bilinear_at (ROADMAP queue "
         "A, item 13b)")


def get_rotated_pixels(*args, **kwargs):
    """Reference ``get_rotated_pixels`` (``maps.py:1738``): not ported."""
    raise NotImplementedError("get_rotated_pixels waits with rotate_map, "
                              "which " + _WAIT)


def rotate_map(*args, **kwargs):
    """Reference ``rotate_map`` (``maps.py:1780``): not ported."""
    raise NotImplementedError("rotate_map " + _WAIT)


class MapRotator:
    """Reference ``MapRotator`` (``maps.py:1681``): not ported."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("MapRotator " + _WAIT)


class MapRotatorEquator(MapRotator):
    """Reference ``MapRotatorEquator`` (``maps.py:1687``): not ported."""


def cutout_gnomonic(*args, **kwargs):
    """Reference ``cutout_gnomonic`` (``maps.py:2425``): not ported."""
    raise NotImplementedError("cutout_gnomonic needs the port of "
                              "utils/healpix (ROADMAP queue A, item 21)")
