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
The patch rotations (``get_rotated_pixels``, ``rotate_map``,
``MapRotator``, ``MapRotatorEquator``; ROADMAP queue A item 18b) resample
through ``mapstools._bilinear_at`` (item 13b); ``cutout_gnomonic`` samples
a healpix map through ``utils/healpix`` (item 21), on the host.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .._device import as_tensor, resolve
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


def _geom_posang(geom: Geometry, dtype=torch.float64, device=None):
    """Absolute (dec, ra) of every pixel of a flat patch (small-patch
    cylindrical approximation consistent with ``Geometry``)."""
    device = resolve(device)
    iy = (torch.arange(geom.ny, dtype=dtype, device=device)
          - (geom.ny - 1) / 2) * geom.dy
    ix = (torch.arange(geom.nx, dtype=dtype, device=device)
          - (geom.nx - 1) / 2) * geom.dx
    return torch.meshgrid(geom.y0 + iy, ix, indexing="ij")


def _source_pixels(dec_s, ra_s, geom_source, source_ra0, xp):
    """Fractional source pixels of absolute (dec, ra) in numpy or torch
    (``xp``), the RA taken relative to ``source_ra0`` and wrapped."""
    ra_s = ra_s - source_ra0
    ra_s = xp.arctan2(xp.sin(ra_s), xp.cos(ra_s))
    py = ((dec_s - float(geom_source.y0)) / float(geom_source.dy)
          + (geom_source.ny - 1) / 2)
    px = ra_s / float(geom_source.dx) + (geom_source.nx - 1) / 2
    return py, px


def get_rotated_pixels(geom_source: Geometry, geom_target: Geometry,
                       inverse=False, rot=None, source_ra0=0.0,
                       center_source=None, center_target=None, device=None):
    """Fractional source-pixel positions (2, ny, nx), float64, of every
    target pixel after recentring the source patch onto the target patch
    (reference ``get_rotated_pixels``, ``maps.py:1738``). ``rot``
    overrides the recentring rotation; ``center_source`` /
    ``center_target`` override the (dec, ra) patch centers otherwise
    taken from the geometries (``y0`` is the dec center; the source RA
    origin is ``source_ra0``). ``inverse`` swaps the sense of the
    recentring.

    A host ``rot`` (the common case) gives positions computed in host
    float64 numpy and put on ``device``, so the card and the CPU sample
    the same positions. A tensor ``rot`` gives positions computed in
    float64 on its device."""
    if rot is None:
        cs = ((geom_source.y0, source_ra0) if center_source is None
              else center_source)
        ct = ((geom_target.y0, 0.0) if center_target is None
              else center_target)
        if inverse:
            cs, ct = ct, cs
        rot = pointing_rotation(cs, ct)
    if torch.is_tensor(rot):
        rot = rot.to(torch.float64)
        dec_t, ra_t = _geom_posang(geom_target, device=rot.device)
        cd = torch.cos(dec_t)
        v = torch.stack([cd * torch.cos(ra_t), cd * torch.sin(ra_t),
                         torch.sin(dec_t)], -1)
        vs = torch.einsum("ij,...j->...i", rot, v)
        dec_s = torch.arcsin(torch.clamp(vs[..., 2], -1.0, 1.0))
        ra_s = torch.atan2(vs[..., 1], vs[..., 0])
        py, px = _source_pixels(dec_s, ra_s, geom_source, source_ra0,
                                torch)
        return torch.stack([py, px])
    rot = np.asarray(rot, np.float64)
    gt = geom_target
    iy = (np.arange(gt.ny) - (gt.ny - 1) / 2) * float(gt.dy) + float(gt.y0)
    ix = (np.arange(gt.nx) - (gt.nx - 1) / 2) * float(gt.dx)
    dec_t, ra_t = np.meshgrid(iy, ix, indexing="ij")
    v = np.stack([np.cos(dec_t) * np.cos(ra_t),
                  np.cos(dec_t) * np.sin(ra_t), np.sin(dec_t)], -1)
    vs = np.einsum("ij,...j->...i", rot, v)
    dec_s = np.arcsin(np.clip(vs[..., 2], -1.0, 1.0))
    ra_s = np.arctan2(vs[..., 1], vs[..., 0])
    py, px = _source_pixels(dec_s, ra_s, geom_source, source_ra0, np)
    return torch.as_tensor(np.stack([py, px]), device=resolve(device))


def _sample(imap, pix, order):
    from .mapstools import _bilinear_at
    if order not in (0, 1):
        raise NotImplementedError(
            "rotate_map implements order 0 (nearest) and 1 (bilinear); "
            "higher-order spline resampling is not available")
    py, px = pix[0], pix[1]
    if order == 0:
        py, px = torch.round(py), torch.round(px)
    return _bilinear_at(imap, py, px)


def rotate_map(imap, geom_source: Geometry, geom_target: Geometry,
               rot=None, order=1, source_ra0=0.0, device=None):
    """Resample ``imap`` (on ``geom_source``) onto ``geom_target`` through
    a real spherical rotation (reference ``rotate_map``/``MapRotator``,
    ``maps.py:1780,1681``), on ``imap``'s device. ``rot`` is a 3x3
    rotation taking target coordinates to source coordinates; by default
    the recentering rotation between the two patch centers.
    ``source_ra0`` is the absolute RA of the source patch center, needed
    whenever ``rot`` lands vectors at a nonzero source RA (as in
    :class:`MapRotatorEquator`). ``order``: 0 (nearest) or 1
    (bilinear)."""
    imap = as_tensor(imap, device)
    if torch.is_tensor(rot):
        rot = rot.to(imap.device)
    pix = get_rotated_pixels(geom_source, geom_target, rot=rot,
                             source_ra0=source_ra0, device=imap.device)
    return _sample(imap, pix, order)


class MapRotator:
    """Rotate maps from one patch geometry to another through the proper
    spherical pointing transform (reference ``MapRotator``,
    ``maps.py:1681``). The source positions are formed once, on
    ``device`` (a tensor ``rot``'s own device)."""

    def __init__(self, geom_source: Geometry, geom_target: Geometry,
                 rot=None, source_ra0=0.0, device=None):
        self.geom_source = geom_source
        self.geom_target = geom_target
        self.rot = rot
        self.source_ra0 = float(source_ra0)
        self.pix = get_rotated_pixels(geom_source, geom_target, rot=rot,
                                      source_ra0=self.source_ra0,
                                      device=device)

    def rotate(self, imap):
        return _sample(as_tensor(imap, self.pix.device), self.pix, 1)


class MapRotatorEquator(MapRotator):
    """Rotate a map from a source geometry onto an equator-centered
    target patch (reference ``maps.py:1687``): the target geometry is
    built from the requested patch size, with the pixel size matched to
    the source's (scaled by cos(max |dec|) of the source, the reference's
    recommended-pixel logic, unless overridden), then rotation proceeds as
    in :class:`MapRotator` through the pointing rotation that carries the
    source center to the target center; optionally Fourier-resampled to
    ``downsample_pix_arcmin``."""

    def __init__(self, geom_source: Geometry, center_source,
                 patch_width_deg, patch_height_deg,
                 width_multiplier=1.0, height_multiplier=1.5,
                 pix_target_override_arcmin=None, downsample_pix_arcmin=None,
                 device=None):
        from ..geometry import arcmin as ARCMIN, rect_geometry
        source_pix_arcmin = min(geom_source.dy, geom_source.dx) / ARCMIN
        if pix_target_override_arcmin is None:
            max_dec = abs(center_source[0]) + geom_source.ny \
                * geom_source.dy / 2.0
            pix = source_pix_arcmin * np.cos(min(max_dec, np.pi / 2.2))
        else:
            pix = pix_target_override_arcmin
        geom_target = rect_geometry(
            width_arcmin=patch_width_deg * 60.0 * width_multiplier,
            height_arcmin=patch_height_deg * 60.0 * height_multiplier,
            px_res_arcmin=pix)
        rot = pointing_rotation(center_source, (0.0, 0.0))
        # the rotation lands target vectors at the source's ABSOLUTE RA
        super().__init__(geom_source, geom_target, rot=rot,
                         source_ra0=center_source[1], device=device)
        self.downsample_pix_arcmin = downsample_pix_arcmin

    def rotate(self, imap):
        out = super().rotate(imap)
        if self.downsample_pix_arcmin is not None:
            from ..geometry import arcmin as ARCMIN
            from .mapstools import resample_fft
            out, _ = resample_fft(out, self.geom_target,
                                  self.downsample_pix_arcmin * ARCMIN)
        return out


def cutout_gnomonic(hp_map, rot=None, coord=None, xsize=200, ysize=None,
                    reso=1.5, nest=False, remove_dip=False,
                    remove_mono=False, gal_cut=0, flip="astro"):
    """Gnomonic (tangent-plane) cutout of a healpix map (reference
    ``cutout_gnomonic``, ``maps.py:2425``, a healpy.gnomview derivative).
    Host-side viewer helper, numpy throughout, as in the JAX package.

    ``rot`` is (lon, lat[, psi]) in degrees placing that point at the
    cutout center with an extra ``psi`` rotation about the line of
    sight; ``coord`` of 'G'/'C' (or a pair rotating first->second)
    reinterprets the map's frame through the galactic<->equatorial
    rotation; ``reso`` is the pixel size in arcmin; ``flip='astro'`` puts
    east on the left (rows increase northward in both conventions).
    Sampling is nearest-pixel; healpy UNSEEN sentinel values pass through
    unchanged. ``remove_mono``/``remove_dip`` subtract the monopole (and
    dipole) fitted over finite, non-UNSEEN pixels outside ``|b| <
    gal_cut`` degrees."""
    from ..utils import healpix as hpx
    hp_map = np.asarray(hp_map.cpu() if torch.is_tensor(hp_map) else hp_map,
                        np.float64)
    nside = hpx.npix2nside(hp_map.size)

    if remove_dip or remove_mono:
        pix = np.arange(hp_map.size)
        th, ph = hpx.pix2ang(nside, hpx.nest2ring(nside, pix)
                             if nest else pix)
        # exclude healpy's UNSEEN sentinel (finite but ~-1.6e30) as well
        # as nan/inf from the fit, like healpy's mask_bad
        good = np.isfinite(hp_map) & (np.abs(hp_map) < 1e25)
        if gal_cut > 0:
            good &= np.abs(90.0 - np.degrees(th)) >= gal_cut
        v = np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                      np.cos(th)], -1)
        if remove_dip:
            A = np.concatenate([np.ones((good.sum(), 1)), v[good]], 1)
            coef, *_ = np.linalg.lstsq(A, hp_map[good], rcond=None)
            hp_map = hp_map - coef[0] - v @ coef[1:]
        else:
            hp_map = hp_map - hp_map[good].mean()

    if ysize is None:
        ysize = xsize
    if rot is None:
        rot = (0.0, 0.0, 0.0)
    rot = tuple(np.atleast_1d(rot).astype(np.float64)) + (0.0, 0.0)
    lon0, lat0, psi = np.radians(rot[0]), np.radians(rot[1]), \
        np.radians(rot[2])

    # tangent-plane coordinates (radians); screen x rightward, y upward
    step = np.radians(reso / 60.0)
    xs = (np.arange(xsize) - (xsize - 1) / 2.0) * step
    ys = (np.arange(ysize) - (ysize - 1) / 2.0) * step
    X, Y = np.meshgrid(xs, ys)
    if flip == "astro":
        X = -X                       # east toward the left
    if psi != 0.0:
        c, s = np.cos(psi), np.sin(psi)
        X, Y = c * X - s * Y, s * X + c * Y

    # gnomonic inverse: direction = center + X e_east + Y e_north
    n_hat = np.array([np.cos(lat0) * np.cos(lon0),
                      np.cos(lat0) * np.sin(lon0), np.sin(lat0)])
    e_east = np.array([-np.sin(lon0), np.cos(lon0), 0.0])
    e_north = np.array([-np.sin(lat0) * np.cos(lon0),
                        -np.sin(lat0) * np.sin(lon0), np.cos(lat0)])
    d = (n_hat[None, None] + X[..., None] * e_east[None, None]
         + Y[..., None] * e_north[None, None])
    d /= np.linalg.norm(d, axis=-1, keepdims=True)

    if coord is not None:
        coord = [coord] if isinstance(coord, str) else list(coord)
        if len(coord) == 2 and coord[0] != coord[1]:
            # directions are in the SECOND frame; pull back to the map's
            pair = (coord[0], coord[1])
            if pair not in (("G", "C"), ("C", "G")):
                raise NotImplementedError(
                    "cutout_gnomonic supports G<->C rotations")
            R = np.asarray(gal2equ_rotation(inverse=(pair == ("C", "G"))))
            d = d @ R                # R^T applied to row vectors
    theta = np.arccos(np.clip(d[..., 2], -1.0, 1.0))
    phi = np.arctan2(d[..., 1], d[..., 0]) % (2 * np.pi)
    pix = hpx.ang2pix(nside, theta.ravel(), phi.ravel())
    if nest:
        pix = hpx.ring2nest(nside, pix)
    # rows increase northward regardless of flip (healpy's projected-map
    # convention; display with origin='lower')
    return hp_map[pix].reshape(ysize, xsize)
