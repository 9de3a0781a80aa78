"""Map-space toolkit (port of ``orphics_tpu.models.mapstools``): stacking
and aperture photometry, matched filters, pure-B purification, CG
inpainting, power downsampling, beam sanitization, gap filling, map
rotation and rescaling, Fourier resampling, radial windows and
convolutions, covariance blocks, draws and healpix thumbnails.

Reference anchors as in the JAX module: ``flux`` (``orphics/maps.py:2500``),
``MatchedFilter`` (:2576), ``FourierStack`` (:65), ``Purify`` /
``iqu_to_pure_lteb`` (:2624, 2666), ``inpaint_cg`` (:2185),
``downsample_power`` (:1501), ``SymMat`` (:2882), ``sanitize_beam`` (:299),
``gapfill_edge_conv_flat`` (:819), ``MapRotator`` (:1681), the maxlike
covariance block (:1792-1870), ``thumbnail_healpix`` (:614),
``galactic_mask`` (:1186).

Functions that take a tensor follow its device; a host array goes to
``device`` (``None``: the card, raising where there is none). Host numpy
helpers of the JAX module stay host numpy here. Binning goes through the
port's ``Bin2D`` (kernel B1 on the card), which sums float32 planes in
float64. Every draw takes a ``torch.Generator`` and has a ``*_from_noise``
twin that takes the draw itself.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import as_tensor, resolve
from ..geometry import Geometry, arcmin, degree
from ..ops import fourier as F
from ..ops.binning import Bin2D
from ..ops.interp import interp

__all__ = [
    "flux", "MatchedFilter", "matched_filter", "get_normalized_center",
    "FourierStack", "mask_center", "crop_center", "get_central", "Purify",
    "radial_window", "apodize_profile", "radial_mask", "circular_mask",
    "butterworth", "gauss_kern", "gkern_interp", "block_smooth",
    "field_variance", "random_source_map", "get_ecc", "filter_alms",
    "area_from_mask", "flat_sim", "resample_fft", "resampled_geometry",
    "split_sky", "cutup", "bounds_from_list", "spec1d_to_2d",
    "get_lnlike", "get_grf_cmb", "get_grf_realization", "rgeo",
    "resolution", "autofiltered_maps", "fourier_stack",
    "iqu_to_pure_lteb", "inpaint_cg", "analytical_tf", "minimum_ell",
    "cosine_taper", "downsample_power", "SymMat", "symmat_from_data",
    "sanitize_beam", "gapfill_edge_conv_flat", "binary_mask", "area",
    "fsky", "area_sqdeg", "rescale", "rotate", "MapRotator",
    "diagonal_cov", "ncov", "pixcov", "psizemap", "thumbnail_healpix",
    "galactic_mask",
    "convolve", "convolve_gaussian", "convolve_profile", "pixcov_sim",
    "get_planck_cutout",
    "generate_correlated_alm", "ftrans", "real_space_filter", "rfilter",
    # the draws' twins, which take the draw itself
    "random_source_map_from_noise", "get_grf_realization_from_noise",
    "get_grf_cmb_from_noise", "gapfill_edge_conv_flat_from_noise",
    "generate_correlated_alm_from_noise", "pixcov_sim_from_noise",
]


# ------------------------------------------------------------------
# stacking / aperture photometry / matched filtering
# ------------------------------------------------------------------

def flux(thumbs, aperture_radius, geom: Geometry, annulus_width=None,
         modrmap=None, pixsizemap=None, device=None):
    """Aperture photometry with annulus mean subtraction (reference
    ``orphics/maps.py:2500``), batched over leading dims."""
    thumbs = as_tensor(thumbs, device)
    dev = thumbs.device
    modrmap = (geom.modrmap(thumbs.dtype, dev) if modrmap is None
               else as_tensor(modrmap, dev))
    if annulus_width is None:
        annulus_width = (np.sqrt(2.0) - 1.0) * aperture_radius
    pixsizemap = (geom.pixsizemap(thumbs.dtype, dev) if pixsizemap is None
                  else as_tensor(pixsizemap, dev))
    ann = ((modrmap > aperture_radius)
           & (modrmap < aperture_radius + annulus_width))
    disk = modrmap <= aperture_radius
    wann = pixsizemap * ann
    num = torch.sum(thumbs * wann, dim=(-2, -1))
    den = torch.sum(wann)
    mean = (num / den)[..., None, None]
    return torch.sum((thumbs - mean) * pixsizemap * disk, dim=(-2, -1))


class MatchedFilter:
    """Optimal amplitude of a known template in noisy data (reference
    ``orphics/maps.py:2576``): ``apply`` returns (amplitude, variance). The
    template's transform lives on ``device`` (a tensor template keeps its
    own)."""

    def __init__(self, geom: Geometry, template=None, noise_power=None,
                 device=None):
        self.geom = geom
        self.normfact = geom.area / geom.npix ** 2
        self.n2d = noise_power
        self.ktemp = (torch.fft.fft2(as_tensor(template, device))
                      if template is not None else None)

    def apply(self, imap=None, kmap=None, template=None, noise_power=None,
              kmask=None):
        if kmap is None:
            dev = None if self.ktemp is None else self.ktemp.device
            kmap = torch.fft.fft2(as_tensor(imap, dev))
        dev = kmap.device
        ktemp = (self.ktemp if template is None
                 else torch.fft.fft2(as_tensor(template, dev)))
        n2d = as_tensor(self.n2d if noise_power is None else noise_power,
                        dev)
        kmask = 1.0 if kmask is None else as_tensor(kmask, dev)
        in2d = torch.nan_to_num(1.0 / n2d, nan=0.0, posinf=0.0, neginf=0.0)
        phi_un = torch.sum((ktemp.conj() * kmap).real
                           * self.normfact * kmask * in2d)
        phi_var = 1.0 / torch.sum((ktemp.conj() * ktemp).real
                                  * self.normfact * kmask * in2d)
        return phi_un * phi_var, phi_var


def matched_filter(kmap, ktemplate, n2d, geom: Geometry, kmask=None):
    """Functional matched filter on k-maps (reference
    ``orphics/maps.py:677``); runs on ``kmap``'s device."""
    mf = MatchedFilter(geom)
    mf.ktemp = as_tensor(ktemplate, kmap.device)
    mf.n2d = n2d
    return mf.apply(kmap=kmap, kmask=kmask)


def get_normalized_center(geom: Geometry, dtype=torch.float32, device=None):
    """Unit-integral delta at the patch center (reference
    ``orphics/maps.py:55``)."""
    t = torch.zeros(geom.shape, dtype=dtype, device=resolve(device))
    t[geom.ny // 2, geom.nx // 2] = 1.0 / geom.pixsize
    return t


class FourierStack:
    """Bin kmap x conj(k-delta-template): radial Fourier-space stacking
    (reference ``orphics/maps.py:65``). The binner and the template live
    on ``device``; ``apply`` bins the float32 product on B1."""

    def __init__(self, geom: Geometry, bin_edges, device=None):
        self.geom = geom
        self.binner = Bin2D(geom.modlmap_np(), bin_edges, device=device)
        temp = get_normalized_center(geom, device=device)
        self.ktemp = F.fft2(temp, geom, "phys")

    def apply(self, kmap):
        return self.binner.bin((kmap * self.ktemp.conj()).real
                               .to(torch.float32))


def mask_center(imap, device=None):
    """NaN the central pixel(s) (reference ``orphics/maps.py:2601``); each
    axis gets its own center, so non-square maps are handled."""
    out = as_tensor(imap, device).clone()
    ny, nx = out.shape[-2], out.shape[-1]
    cy, cx = ny // 2, nx // 2
    rows = [cy] if ny % 2 == 1 else [cy - 1, cy]
    cols = [cx] if nx % 2 == 1 else [cx - 1, cx]
    for r in rows:
        for c in cols:
            out[..., r, c] = float("nan")
    return out


def crop_center(imap, ny, nx=None):
    nx = ny if nx is None else nx
    Ny, Nx = imap.shape[-2:]
    y0 = (Ny - ny) // 2
    x0 = (Nx - nx) // 2
    return imap[..., y0:y0 + ny, x0:x0 + nx]


def get_central(imap, frac):
    """Central fraction of a map (reference ``get_central``)."""
    if frac is None or frac == 1:
        return imap
    Ny, Nx = imap.shape[-2:]
    return crop_center(imap, int(Ny * frac), int(Nx * frac))


# ------------------------------------------------------------------
# pure-B purification (Smith estimator; reference maps.py:2624-2730)
# ------------------------------------------------------------------

def _deriv4(win, axis, delta):
    """4th-order centered finite difference along an axis (periodic)."""
    def sh(k):
        return torch.roll(win, -k, dims=axis)
    return (-sh(2) + 8 * sh(1) - 8 * sh(-1) + sh(-2)) / (12.0 * delta)


def init_deriv_window(window, geom: Geometry, device=None):
    """Window derivatives for the pure-B estimator (reference
    ``orphics/maps.py:2640``). The stencils run in float64 and the
    derivatives are stored in the window's dtype: the second derivatives
    scale as 1/dx^2 (about 3e6 at 2'), and float32 stencils would lose
    about 1e-3 of them to the window's own rounding."""
    w = as_tensor(window, device)
    w64 = w.to(torch.float64)
    dx = _deriv4(w64, -1, abs(geom.dx))
    dy = _deriv4(w64, -2, abs(geom.dy))
    d2x = _deriv4(dx, -1, abs(geom.dx))
    d2y = _deriv4(dy, -2, abs(geom.dy))
    dxdy = _deriv4(dy, -1, abs(geom.dx))
    return dict(Win=w, dWin_dx=dx.to(w.dtype), dWin_dy=dy.to(w.dtype),
                d2Win_dx2=d2x.to(w.dtype), d2Win_dy2=d2y.to(w.dtype),
                d2Win_dxdy=dxdy.to(w.dtype))


def _teb_tables(geom: Geometry, iau: bool, dtype, device):
    """|l| (clamped to >= 1) and the cos / sin of phi_l and 2 phi_l,
    phi_l = atan2(lx, ly) (negated under ``iau``), formed in host float64
    and stored in ``dtype`` on ``device``."""
    ml = geom.modlmap_np()
    ml = np.where(ml < 1.0, 1.0, ml)
    ly, lx = geom.laxes_np()
    ang = np.arctan2(lx[None, :], ly[:, None])
    if iau:
        ang = -ang
    return tuple(torch.as_tensor(a, dtype=dtype, device=device)
                 for a in (ml, np.cos(ang), np.sin(ang), np.cos(2 * ang),
                           np.sin(2 * ang)))


def _safe(w):
    return torch.where(torch.abs(w) > 1e-8, w, torch.ones_like(w))


def _pure_lteb(tmap, qmap, umap, w, tables, method):
    ml, c1, s1, c2, s2 = tables
    fT = torch.fft.fft2(tmap)
    fQ = torch.fft.fft2(qmap)
    fU = torch.fft.fft2(umap)
    fE = fQ * c2 + fU * s2
    fB = -fQ * s2 + fU * c2
    if method == "standard":
        return fT, fE, fB
    Wx, Wy = w["dWin_dx"], w["dWin_dy"]
    Wxx, Wyy, Wxy = w["d2Win_dx2"], w["d2Win_dy2"], w["d2Win_dxdy"]
    sw = _safe(w["Win"])
    q = qmap / sw
    u = umap / sw
    fA = torch.fft.fft2(q * Wy + u * Wx)   # A = Q Wy + U Wx
    fC = torch.fft.fft2(u * Wy - q * Wx)   # C = U Wy - Q Wx
    fB = fB + (2.0j / ml) * (c1 * fC - s1 * fA) \
        - torch.fft.fft2(u * (Wyy - Wxx) - 2.0 * q * Wxy) / ml ** 2
    if method == "hybrid":
        return fT, fE, fB
    fE = fE + (2.0j / ml) * (c1 * fA + s1 * fC) \
        - torch.fft.fft2(q * (Wyy - Wxx) + 2.0 * u * Wxy) / ml ** 2
    return fT, fE, fB


def iqu_to_pure_lteb(tmap, qmap, umap, geom: Geometry, windict,
                     method: str = "pure", iau: bool = False):
    """(fT, fE, fB) with E->B leakage purification (Smith 2006 pure
    estimator; reference ``orphics/maps.py:2666``). Maps ``(..., ny, nx)``
    must already carry the window; raw-FFT outputs; ``method`` is
    "standard", "hybrid" (B purified) or "pure" (E and B).

    With E + iB = e^{-2 i phi_l} fft(W (Q+iU)), phi_l = atan2(lx, ly), and
    the spin-lowering operator D = d/dy - i d/dx moved off the plane wave
    onto W P+ by parts:

      B_pure = B_std + (2i/l)[cos(phi) fft(U Wy - Q Wx)
                              - sin(phi) fft(Q Wy + U Wx)]
                     - (1/l^2) fft(U (Wyy - Wxx) - 2 Q Wxy)
      E_pure = E_std + (2i/l)[cos(phi) fft(Q Wy + U Wx)
                              + sin(phi) fft(U Wy - Q Wx)]
                     - (1/l^2) fft(Q (Wyy - Wxx) + 2 U Wxy)

    with Q, U the unwindowed fields (divided by W where |W| > 1e-8)."""
    tables = _teb_tables(geom, iau, qmap.dtype, qmap.device)
    return _pure_lteb(tmap, qmap, umap, windict, tables, method)


class Purify:
    """Pure-B spectra estimator (reference ``orphics/maps.py:2624``). The
    window's derivatives and the Fourier-plane tables are formed once, on
    the window's device (``device`` for a host window).

    >>> pur = Purify(geom, window)
    >>> fT, fE, fB = pur.lteb_from_iqu(iqu * window)   # (..., 3, ny, nx)
    """

    def __init__(self, geom: Geometry, window, device=None):
        self.geom = geom
        self.windict = init_deriv_window(window, geom, device)
        self._tables = {}

    def lteb_from_iqu(self, imap, method: str = "pure", iau: bool = False):
        """(fT, fE, fB) of ``imap`` ``(..., 3, ny, nx)`` (I, Q, U on the
        third axis from the end, any leading batch dimensions)."""
        key = (iau, imap.dtype, imap.device)
        if key not in self._tables:
            self._tables[key] = _teb_tables(self.geom, iau, imap.dtype,
                                            imap.device)
        return _pure_lteb(imap[..., 0, :, :], imap[..., 1, :, :],
                          imap[..., 2, :, :], self.windict,
                          self._tables[key], method)


# ------------------------------------------------------------------
# CG inpainting (reference maps.py:2185)
# ------------------------------------------------------------------

def _inpaint_cg(imap, rand_map, mask, power2d, eps, maxiter, device):
    """:func:`inpaint_cg` and its iteration count."""
    imap = as_tensor(imap, device)
    dev = imap.device
    rand_map = as_tensor(rand_map, dev)
    mask = as_tensor(mask, dev)
    ipow = 1.0 / as_tensor(power2d, dev)

    def cinv(x):
        return torch.fft.ifft2(torch.fft.fft2(x) * ipow).real

    bad = 1.0 - mask

    def A(x):
        return bad * cinv(bad * x)

    b = -(bad * cinv(mask * (imap - rand_map)))
    # jax.scipy.sparse.linalg.cg with x0 = b, M = identity, atol = 0
    atol2 = eps ** 2 * torch.sum(b * b)
    x = b
    r = b - A(x)
    p = r
    gamma = torch.sum(r * r)
    k = 0
    while k < maxiter and bool(gamma > atol2):
        Ap = A(p)
        alpha = gamma / torch.sum(p * Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        gamma_ = torch.sum(r * r)
        p = r + (gamma_ / gamma) * p
        gamma = gamma_
        k += 1
    x = x + rand_map * bad
    return imap * mask + x * bad, k


def inpaint_cg(imap, rand_map, mask, power2d, geom: Geometry, eps=1e-8,
               maxiter=500, device=None):
    """Constrained-realization hole filling by conjugate-gradient Wiener
    solve (Thibaut Louis' algorithm; reference ``orphics/maps.py:2185``).

    ``mask`` is 1 in the good region; ``power2d`` must be nonzero to pixel
    scale. The CG loop is that of ``jax.scipy.sparse.linalg.cg`` (x0 = b,
    stop when |r| <= eps |b| or after ``maxiter`` steps) on ``imap``'s
    device; the loop reads the residual on the host once per iteration
    (one synchronization each), so it stops after the same iteration as
    JAX's, and results agree with it to the CG tolerance."""
    return _inpaint_cg(imap, rand_map, mask, power2d, eps, maxiter,
                       device)[0]


# ------------------------------------------------------------------
# misc spectra utilities
# ------------------------------------------------------------------

def analytical_tf(geom: Geometry, kfilter, bin_edges, device=None):
    """Binned k-mask transfer function (reference ``orphics/maps.py:89``);
    the filter is binned as float32 on B1 (float64 sums) on its device."""
    k = as_tensor(kfilter, device)
    binner = Bin2D(geom.modlmap_np(), bin_edges, device=k.device)
    return binner.bin(k.to(torch.float32))


def minimum_ell(geom: Geometry) -> int:
    """Lowest nonzero |l| on the grid (reference ``orphics/maps.py:363``)."""
    ml = geom.modlmap_np()
    return int(ml[ml > 0].min())


def cosine_taper(ls, lstart, lwidth):
    """Low-pass cosine taper filter (reference ``orphics/maps.py:960``)."""
    ls = np.asarray(ls, dtype=float)
    fl = np.ones_like(ls)
    sel = ls > lstart
    fl[sel] = 1 - 0.5 * (1 - np.cos(-np.pi * (ls[sel] - lstart) / lwidth))
    fl[ls > lstart + lwidth] = 0
    return fl


def downsample_power(p2d, geom: Geometry, ndown=16, exp=None, fftshift=True,
                     device=None):
    """Smooth a 2D power spectrum by block averaging (noise-model /
    empirical-covariance smoothing; reference ``orphics/maps.py:1501``)."""
    from .grf import eig_pow
    p = as_tensor(p2d, device)
    if ndown < 1:
        return p
    ny, nx = p.shape[-2:]
    if fftshift:
        p = torch.fft.fftshift(p, dim=(-2, -1))
    by, bx = ny // ndown, nx // ndown
    trimmed = p[..., :by * ndown, :bx * ndown]
    low = trimmed.reshape(p.shape[:-2] + (by, ndown, bx, ndown)).mean(
        dim=(-3, -1))
    if exp is not None:
        if low.ndim == 4:  # (ncomp, ncomp, by, bx)
            stack = torch.movedim(low, (0, 1), (-2, -1))
            low = torch.movedim(eig_pow(stack, exp), (-2, -1), (0, 1))
        else:
            low = torch.abs(low) ** exp * torch.sign(low)
    # nearest-neighbour upsample back, the trimmed borders filled with the
    # edge values
    up = low.repeat_interleave(ndown, -2).repeat_interleave(ndown, -1)
    out = torch.zeros_like(p)
    out[..., :by * ndown, :bx * ndown] = up
    out[..., by * ndown:, :] = out[..., by * ndown - 1:by * ndown, :]
    out[..., :, bx * ndown:] = out[..., :, bx * ndown - 1:bx * ndown]
    if fftshift:
        out = torch.fft.ifftshift(out, dim=(-2, -1))
    return out


class SymMat:
    """Upper-triangle storage of a symmetric (ncomp, ncomp, ...) matrix
    (reference ``orphics/maps.py:2882``; host numpy)."""

    def __init__(self, ncomp, shape, data=None):
        self.ncomp = ncomp
        self.shape = shape
        ndat = ncomp * (ncomp + 1) // 2
        self.data = (data if data is not None
                     else np.empty((ndat,) + tuple(shape)))

    def yx_to_k(self, y, x):
        if y > x:
            return self.yx_to_k(x, y)
        return y * self.ncomp + x - y * (y + 1) // 2

    def __getitem__(self, tup):
        y, x = tup
        return self.data[self.yx_to_k(y, x)]

    def __setitem__(self, tup, value):
        y, x = tup
        self.data[self.yx_to_k(y, x)] = value

    def to_array(self, sel=np.s_[...], flatten=False):
        oshape = (self.data[0].reshape(-1)[sel].shape if flatten
                  else self.data[0][sel].shape)
        out = np.empty((self.ncomp, self.ncomp) + oshape)
        for y in range(self.ncomp):
            for x in range(y, self.ncomp):
                d = self.data[self.yx_to_k(y, x)]
                d = d.reshape(-1) if flatten else d
                out[y, x] = d[sel]
                if x != y:
                    out[x, y] = out[y, x]
        return out


def symmat_from_data(data):
    ndat = data.shape[0]
    ncomp = int(0.5 * (np.sqrt(8 * ndat + 1) - 1))
    return SymMat(ncomp, data.shape[1:], data=data)


def sanitize_beam(ells, lbeam, sval=1e-3, verbose=False):
    """Normalize a beam and continue it with a matched Gaussian below
    ``sval`` (reference ``orphics/maps.py:299``; host numpy)."""
    ells = np.asarray(ells)
    if ells[0] != 0 or not np.all(np.diff(ells) == 1):
        raise ValueError("ells must be 0..lmax with unit spacing")
    lbeam = np.asarray(lbeam, dtype=float) / lbeam[0]
    if sval is None:
        return lbeam
    low = np.where(lbeam < sval)[0]
    if low.size == 0:
        return lbeam
    i0 = int(low[0]) - 1
    oell, olb = ells[i0], lbeam[i0]
    theta2 = -(16.0 * np.log(2.0)) * np.log(olb) / oell ** 2
    theta_fwhm = np.degrees(np.sqrt(theta2)) * 60.0
    obeam = lbeam.copy()
    obeam[low] = F.gauss_beam(ells[low], theta_fwhm)
    return obeam


def _gapfill(imap, mask, geom, alpha, edge_rad, rmin, tol):
    from ..ops.distance import distance_transform
    dev = imap.device
    mask = as_tensor(mask, dev).to(torch.bool)
    # centered radial profile (periodic)
    y = np.fft.fftfreq(geom.ny) * geom.ny * abs(geom.dy)
    x = np.fft.fftfreq(geom.nx) * geom.nx * abs(geom.dx)
    r = np.sqrt(y[:, None] ** 2 + x[None, :] ** 2)
    r = np.maximum(r, rmin)
    lprof = torch.fft.fft2(torch.as_tensor((r / arcmin) ** alpha,
                                           dtype=imap.dtype, device=dev))
    # weight = ring of good pixels at the mask edge (at least ~1.5 px wide
    # so coarse grids don't produce an empty ring)
    edge_rad = max(edge_rad, 1.6 * max(abs(geom.dy), abs(geom.dx)))
    edist = distance_transform(mask, abs(geom.dy), abs(geom.dx))
    weight = ((edist > 0) & (edist < edge_rad)).to(imap.dtype)

    def conv(m):
        return torch.fft.ifft2(lprof * torch.fft.fft2(m)).real

    rhs = conv(weight * imap)
    div = conv(weight)
    div = torch.clamp(div, min=float(torch.max(div)) * tol * 100)
    return torch.where(mask, rhs / div, imap), mask


def gapfill_edge_conv_flat_from_noise(noise, imap, mask, geom: Geometry,
                                      ivar=None, alpha=-3,
                                      edge_rad=1 * arcmin, rmin=2 * arcmin,
                                      tol=1e-8, device=None):
    """:func:`gapfill_edge_conv_flat` with the standard normals ``noise``
    ``(ny, nx)`` of its hole noise given (ignored without ``ivar``)."""
    imap = as_tensor(imap, device)
    omap, mask = _gapfill(imap, mask, geom, alpha, edge_rad, rmin, tol)
    if ivar is None:
        return omap
    n = as_tensor(noise, imap.device) / torch.sqrt(as_tensor(ivar,
                                                             imap.device))
    return torch.where(mask, omap + n, omap)


def gapfill_edge_conv_flat(imap, mask, geom: Geometry, ivar=None, alpha=-3,
                           edge_rad=1 * arcmin, rmin=2 * arcmin, tol=1e-8,
                           generator=None, device=None):
    """Gapfill by masked convolution with an r^alpha profile prioritizing
    the hole edges (reference ``orphics/maps.py:819``). ``mask`` is True
    in BAD regions. With ``ivar``, white noise of that inverse variance is
    added in the holes, drawn with ``generator`` (by default one seeded
    with 0 on ``imap``'s device, as the JAX function's key 0)."""
    imap = as_tensor(imap, device)
    noise = None
    if ivar is not None:
        if generator is None:
            generator = torch.Generator(device=imap.device).manual_seed(0)
        noise = torch.randn(geom.shape, generator=generator,
                            dtype=imap.dtype, device=imap.device)
    return gapfill_edge_conv_flat_from_noise(noise, imap, mask, geom, ivar,
                                             alpha, edge_rad, rmin, tol)


def binary_mask(mask, threshold=0.5, device=None):
    return (as_tensor(mask, device) > threshold).to(torch.float32)


def area(mask, geom: Geometry, threshold=0.5, device=None):
    """Unmasked area in steradians (reference ``orphics/maps.py:1033``)."""
    m = binary_mask(mask, threshold, device)
    return float(torch.sum(m * geom.pixsizemap(torch.float64, m.device)))


def fsky(mask, geom: Geometry, threshold=0.5, device=None):
    return area(mask, geom, threshold, device) / 4.0 / np.pi


def area_sqdeg(mask, geom: Geometry, threshold=0.5, device=None):
    return area(mask, geom, threshold, device) / degree ** 2


# ------------------------------------------------------------------
# interpolation-based map transforms
# ------------------------------------------------------------------

def _bilinear_at(imap, py, px):
    """Bilinear sample of ``(..., ny, nx)`` at fractional pixel coords
    ``py, px`` (any shape, on ``imap``'s device): corners from the floor
    clipped to [0, n-2], zero outside the patch (1e-5 px of roundoff
    tolerated at its edge). The weights are taken in ``imap``'s dtype."""
    ny, nx = imap.shape[-2:]
    y0 = torch.clamp(torch.floor(py).to(torch.int64), 0, ny - 2)
    x0 = torch.clamp(torch.floor(px).to(torch.int64), 0, nx - 2)
    wdt = imap.dtype if imap.is_floating_point() else py.dtype
    ty = torch.clamp(py - y0, 0.0, 1.0).to(wdt)
    tx = torch.clamp(px - x0, 0.0, 1.0).to(wdt)
    eps = 1e-5
    inside = (py >= -eps) & (py <= ny - 1 + eps) \
        & (px >= -eps) & (px <= nx - 1 + eps)
    flat = imap.reshape(imap.shape[:-2] + (-1,))
    base = (y0 * nx + x0).reshape(-1)

    def at(off):
        return flat.index_select(-1, base + off).reshape(
            imap.shape[:-2] + tuple(py.shape))

    out = (at(0) * (1 - ty) * (1 - tx) + at(1) * (1 - ty) * tx
           + at(nx) * ty * (1 - tx) + at(nx + 1) * ty * tx)
    return torch.where(inside, out, torch.zeros((), dtype=out.dtype,
                                                device=out.device))


def rescale(imap, factor, geom: Geometry, device=None):
    """Zoom a thumbnail by ``factor`` keeping its shape: factor > 1
    MAGNIFIES, as in the reference (``orphics/maps.py:rescale``). Output
    pixel i samples source (i - c)/factor."""
    imap = as_tensor(imap, device)
    ny, nx = geom.shape
    cy, cx = (ny - 1) / 2.0, (nx - 1) / 2.0
    ar = lambda n: torch.arange(n, dtype=torch.float64, device=imap.device)
    iy = (ar(ny) - cy) / factor + cy
    ix = (ar(nx) - cx) / factor + cx
    return _bilinear_at(imap, iy[:, None].expand(ny, nx),
                        ix[None, :].expand(ny, nx))


def rotate(imap, angle, geom: Geometry, device=None):
    """Rotate a map about its center by ``angle`` radians (clockwise
    positive, reference ``orphics/maps.py:rotate``)."""
    imap = as_tensor(imap, device)
    ny, nx = geom.shape
    cy, cx = (ny - 1) / 2.0, (nx - 1) / 2.0
    ar = lambda n: torch.arange(n, dtype=torch.float64, device=imap.device)
    yy = ar(ny)[:, None] - cy
    xx = ar(nx)[None, :] - cx
    angle = torch.as_tensor(angle, dtype=torch.float64, device=imap.device)
    c, s = torch.cos(angle), torch.sin(angle)
    py = c * yy - s * xx + cy
    px = s * yy + c * xx + cx
    return _bilinear_at(imap, py.expand(ny, nx), px.expand(ny, nx))


class MapRotator:
    """Recenter a source-geometry patch onto a target geometry by sky-
    coordinate lookup + bilinear interpolation (flat-sky version of
    reference ``orphics/maps.py:1681``). The float64 source positions live
    on ``device``."""

    def __init__(self, geom_source: Geometry, geom_target: Geometry,
                 device=None):
        self.gs = geom_source
        self.gt = geom_target
        pos = geom_target.posmap(torch.float64, device)
        # recenter: target coords relative to its center land on source
        # coords relative to the source center
        src = torch.stack([pos[0] - geom_target.y0 + geom_source.y0, pos[1]])
        self.pix_target = geom_source.sky2pix(src)

    def rotate(self, imap):
        return _bilinear_at(as_tensor(imap, self.pix_target.device),
                            self.pix_target[0], self.pix_target[1])


# ------------------------------------------------------------------
# maxlike covariance block (reference maps.py:1792-1870)
# ------------------------------------------------------------------

def diagonal_cov(power2d, geom: Geometry, device=None):
    """Dense pix-pix covariance of a diagonal (in Fourier) power: the
    block-circulant construction (reference ``orphics/maps.py:1792``)."""
    from .pixcov import ps2d_to_mat
    p = as_tensor(power2d, device)
    if p.ndim == 2:
        p = p[None, None]
    ncomp = p.shape[0]
    return torch.stack([torch.stack([ps2d_to_mat(p[i, j], geom)
                                     for j in range(ncomp)])
                        for i in range(ncomp)])


def ncov(geom: Geometry, noise_uk_arcmin, device=None):
    """White-noise pixel covariance (reference ``orphics/maps.py:1810``),
    float64."""
    var = (noise_uk_arcmin * arcmin) ** 2 / geom.pixsize
    return torch.eye(geom.npix, dtype=torch.float64,
                     device=resolve(device)) * var


def pixcov(geom: Geometry, fourier_cov, device=None):
    """Pixel-pixel covariance from a general (ncomp, ncomp, ny, nx, ny,
    nx) Fourier-space covariance (reference ``orphics/maps.py:1817``):
    normalized inverse FFT over the first grid pair, unnormalized forward
    FFT over the second, times npix/area, in complex64 as the JAX
    function."""
    fc = as_tensor(fourier_cov, device).to(torch.complex64)
    out = torch.fft.ifft2(fc, dim=(-4, -3))
    out = torch.fft.fft2(out, dim=(-2, -1)).real
    return out * (geom.npix / geom.area)


def psizemap(geom: Geometry, dtype=torch.float64, device=None):
    """Map of per-pixel solid angles in steradians (reference
    ``orphics/maps.py:1228``; ``Geometry.pixsizemap``)."""
    return geom.pixsizemap(dtype, device)


# ------------------------------------------------------------------
# healpix interop (host numpy, as in the JAX module)
# ------------------------------------------------------------------

def _posmap_np(geom: Geometry):
    """(dec, ra) offsets of every pixel, host float64 (``Geometry.posmap``)."""
    dec = np.broadcast_to((geom.yaxis_np() + geom.y0)[:, None], geom.shape)
    ra = np.broadcast_to(geom.xaxis_np()[None, :], geom.shape)
    return dec, ra


def thumbnail_healpix(hp_map, ra_deg, dec_deg, width_arcmin=30.0,
                      px_res_arcmin=0.5):
    """Nearest-neighbour gnomonic-style thumbnail from a healpix RING map
    (reference ``thumbnail_healpix``/``cutout_gnomonic``,
    ``orphics/maps.py:614,2425``): (host numpy thumbnail, its Geometry)."""
    from ..utils import healpix as hp
    hp_map = np.asarray(hp_map)
    nside = hp.npix2nside(hp_map.size)
    n = int(width_arcmin / px_res_arcmin)
    g = Geometry(n, n, px_res_arcmin * arcmin, px_res_arcmin * arcmin)
    pdec, pra = _posmap_np(g)
    dec0 = np.radians(dec_deg)
    ra0 = np.radians(ra_deg)
    dec = dec0 + pdec
    ra = ra0 + pra / np.cos(dec0)
    pix = hp.ang2pix(nside, np.pi / 2 - dec.reshape(-1),
                     np.mod(ra.reshape(-1), 2 * np.pi))
    return hp_map[pix].reshape(n, n), g


def galactic_mask(geom: Geometry, nside, theta1, theta2, device=None):
    """Mask a colatitude strip (e.g. the galactic plane in galactic
    coords) projected onto a flat geometry (reference
    ``orphics/maps.py:1186``; identity rotation), float64 on ``device``."""
    from ..utils import healpix as hp
    orig = np.ones(hp.nside2npix(nside))
    orig[hp.query_strip(nside, theta1, theta2)] = 0
    pdec, pra = _posmap_np(geom)
    theta = np.pi / 2 - pdec.reshape(-1)
    phi = np.mod(pra.reshape(-1), 2 * np.pi)
    pix = hp.ang2pix(nside, theta, phi)
    return torch.as_tensor(orig[pix].reshape(geom.shape),
                           device=resolve(device))


def generate_correlated_alm_from_noise(re, im, input_alm_f1, Clf1f1, Clf2f2,
                                       Clf1f2):
    """:func:`generate_correlated_alm` with the standard normals ``re, im``
    ``(nalm,)`` of its uncorrelated part given."""
    from ..ops.alm import almxfl, getlmax, synalm_from_noise
    Clf1f1 = np.asarray(Clf1f1)
    Clf1f2 = np.asarray(Clf1f2)
    Clf2f2 = np.asarray(Clf2f2)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.nan_to_num(Clf1f2 / Clf1f1)
        ps_noise = Clf2f2 - np.nan_to_num(Clf1f2 ** 2 / Clf1f1)
    ps_noise[ps_noise < 0] = 0
    alm = as_tensor(input_alm_f1, re.device)
    correlated = almxfl(alm, ratio)
    lmax = getlmax(alm.shape[-1])
    return correlated + synalm_from_noise(re, im, ps_noise, lmax)


def generate_correlated_alm(input_alm_f1, Clf1f1, Clf2f2, Clf1f2,
                            generator=None, device=None):
    """alm of a field correlated with an existing one per given spectra
    (reference ``orphics/maps.py:generate_correlated_alm``): the input
    scaled by C12/C11 plus a float32 draw of C22 - C12^2/C11, made with
    ``generator`` (by default one seeded with 0) on the alm's device."""
    alm = as_tensor(input_alm_f1, device)
    if generator is None:
        generator = torch.Generator(device=alm.device).manual_seed(0)
    shape = (alm.shape[-1],)
    re = torch.randn(shape, generator=generator, device=alm.device)
    im = torch.randn(shape, generator=generator, device=alm.device)
    return generate_correlated_alm_from_noise(re, im, alm, Clf1f1, Clf2f2,
                                              Clf1f2)


def interpolate_grid(in_grid, in_y, in_x, out_y=None, out_x=None, kx=3,
                     ky=3, **kwargs):
    """Regular-grid spline interpolation (reference
    ``orphics/maps.py:interpolate_grid``; host-side scipy)."""
    from scipy.interpolate import RectBivariateSpline
    spl = RectBivariateSpline(np.asarray(in_y), np.asarray(in_x),
                              np.asarray(in_grid), kx=kx, ky=ky, **kwargs)
    if out_y is None and out_x is None:
        return spl
    return spl(np.asarray(out_y), np.asarray(out_x))


def ftrans(p2d, tfunc=torch.log10, device=None):
    """fftshift + transform for visualizing 2D spectra (reference
    ``orphics/maps.py:ftrans``)."""
    return tfunc(torch.fft.fftshift(as_tensor(p2d, device), dim=(-2, -1)))


def real_space_filter(kfilter, device=None):
    """Real-space kernel of a k-space filter (reference
    ``orphics/maps.py:real_space_filter``), formed in complex64 as the JAX
    function."""
    k = as_tensor(kfilter, device).to(torch.complex64)
    return torch.fft.ifftshift(torch.fft.ifft2(k).real, dim=(-2, -1))


def rfilter(imap, kfilter=None, rfilt=None, device=None):
    """Filter by real-space convolution (periodic; reference
    ``orphics/maps.py:rfilter``)."""
    imap = as_tensor(imap, device)
    if rfilt is None:
        rfilt = real_space_filter(kfilter, imap.device)
    kf = torch.fft.fft2(torch.fft.ifftshift(as_tensor(rfilt, imap.device),
                                            dim=(-2, -1)))
    return torch.fft.ifft2(torch.fft.fft2(imap) * kf).real


# ---------------------------------------------------------------------------
# Radial windows / kernels / masks (reference maps.py:505-600, 2736-2800,
# 2970)
# ---------------------------------------------------------------------------

def radial_window(r, r0, r1, window="kaiser", beta=6.0, device=None):
    """Taper smoothly from 1 (r <= r0) to 0 (r >= r1) (reference
    ``maps.py:505``). windows: kaiser | cosine | quintic."""
    r = as_tensor(r, device)
    x = torch.clamp((r - r0) / (r1 - r0), 0.0, 1.0)
    if window == "kaiser":
        i0 = torch.special.i0
        w = i0(beta * torch.sqrt(1.0 - x ** 2)) / float(np.i0(beta))
    elif window == "cosine":
        w = 0.5 * (1.0 + torch.cos(np.pi * x))
    elif window == "quintic":
        w = 1.0 - (10.0 * x ** 3 - 15.0 * x ** 4 + 6.0 * x ** 5)
    else:
        raise ValueError('window must be "kaiser", "cosine" or "quintic"')
    one, zero = torch.ones_like(w), torch.zeros_like(w)
    return torch.where(r <= r0, one, torch.where(r >= r1, zero, w))


def apodize_profile(thetas, profile, roll_start, roll_width,
                    window="kaiser", beta=6.0, device=None):
    """Taper a 1D radial profile to zero over [roll_start,
    roll_start + roll_width] (reference ``maps.py:547``)."""
    thetas = as_tensor(thetas, device)
    w = radial_window(thetas, roll_start, roll_start + roll_width,
                      window=window, beta=beta)
    return as_tensor(profile, thetas.device) * w


def radial_mask(geom: Geometry, roll_start, roll_width, window="kaiser",
                beta=6.0, dtype=torch.float32, device=None):
    """Circular mask from the distance-to-center map (reference
    ``maps.py:581``): 1 inside ``roll_start`` (radians), tapering to 0
    over ``roll_width``."""
    return radial_window(geom.modrmap(dtype, device), roll_start,
                         roll_start + roll_width, window=window,
                         beta=beta).to(dtype)


def circular_mask(geom: Geometry, center_pix, radius_rad, apo_deg=None,
                  smooth_fwhm_rad=None, dtype=torch.float32, device=None):
    """Zero a disc of ``radius_rad`` around ``center_pix`` = (y, x),
    optionally cosine-apodized and/or beam-smoothed (reference
    ``maps.py:2970`` up to its coordinate conventions: centers are pixel
    coordinates here, not degrees)."""
    from ..ops import distance as D
    srcs = np.asarray(center_pix, np.float64).reshape(1, 2)
    mask = 1.0 - D.mask_srcs(geom, srcs, float(radius_rad), device=device)
    if apo_deg:
        mask = D.cosine_apodize(binary_mask(mask), geom, apo_deg)
    if smooth_fwhm_rad:
        fwhm_arcmin = float(smooth_fwhm_rad) * 180.0 * 60.0 / np.pi
        bl2d = F.gauss_beam(torch.as_tensor(geom.modlmap_np(),
                                            device=mask.device), fwhm_arcmin)
        mask = F.kfilter(mask.to(dtype), bl2d.to(dtype), geom)
    return mask.to(dtype)


def butterworth(ells, ell0, n, device=None):
    """Butterworth low-pass 1/(1 + (l/l0)^{2n}) (reference
    ``maps.py:1869``)."""
    return 1.0 / (1.0 + (as_tensor(ells, device) / ell0) ** (2.0 * n))


def gauss_kern(sigma_y, sigma_x, nsigma=5.0, device=None):
    """Normalized 2D Gaussian convolution kernel (reference
    ``maps.py:2736``); sigmas in pixels; float64."""
    sy = int(nsigma * sigma_y)
    sx = int(nsigma * sigma_x)
    device = resolve(device)
    y = torch.arange(-sy, sy + 1, dtype=torch.float64, device=device)[:, None]
    x = torch.arange(-sx, sx + 1, dtype=torch.float64, device=device)[None, :]
    g = torch.exp(-(x ** 2 / (2 * sigma_x ** 2)
                    + y ** 2 / (2 * sigma_y ** 2)))
    return g / g.sum()


def gkern_interp(geom: Geometry, rs, bprof, fwhm_guess_arcmin,
                 nsigma=20.0, device=None):
    """Normalized 2D kernel from a 1D radial profile, cropped to ~nsigma
    of the guess width (reference ``maps.py:2753``). ``rs`` in radians;
    zero beyond the tabulated profile, as the reference's
    ``interp1d(..., fill_value=0)``."""
    fwhm = fwhm_guess_arcmin * np.pi / (180.0 * 60.0)
    sigma = fwhm / np.sqrt(8.0 * np.log(2.0))
    ny, nx = geom.shape
    sy = int(nsigma * sigma / abs(geom.dy))
    sx = int(nsigma * sigma / abs(geom.dx))
    if ((ny % 2 == 0) == (sy % 2 == 1)):
        sy += 1
    if ((nx % 2 == 0) == (sx % 2 == 1)):
        sx += 1
    rmap = torch.as_tensor(np.ascontiguousarray(
        crop_center(geom.modrmap_np(), sy, sx)), device=resolve(device))
    g = interp(rmap, np.asarray(rs), np.asarray(bprof), left=0.0, right=0.0)
    return g / g.sum()


# ---------------------------------------------------------------------------
# Map utilities tail (reference maps.py:703, 759, 774, 1262-1320,
# 1366-1480, 1591, 1830, 2836-2880)
# ---------------------------------------------------------------------------

def block_smooth(imap, factor, device=None):
    """Block-average in ``factor`` x ``factor`` tiles and project back to
    the original pixelization (reference ``maps.py:703``)."""
    imap = as_tensor(imap, device)
    ny, nx = imap.shape[-2:]
    if ny % factor or nx % factor:
        raise ValueError(f"map shape {(ny, nx)} is not a multiple of "
                         f"{factor}")
    down = imap.reshape(imap.shape[:-2]
                        + (ny // factor, factor, nx // factor, factor)
                        ).mean(dim=(-3, -1))
    return down.repeat_interleave(factor, -2).repeat_interleave(factor, -1)


def field_variance(cls, device=None):
    """Real-space variance sum (2l+1) C_l / 4pi (reference
    ``maps.py:759``)."""
    cls = as_tensor(cls, device)
    ells = torch.arange(cls.shape[-1], device=cls.device)
    return torch.sum((2 * ells + 1) * cls / (4 * np.pi), dim=-1)


def random_source_map_from_noise(pix, geom: Geometry, fwhm=None,
                                 profile=None, amps=None,
                                 dtype=torch.float32):
    """:func:`random_source_map` with its draw, the ``(nobj, 2)`` source
    pixels (y, x), given; the map lives on ``pix``'s device."""
    pix = torch.as_tensor(pix).to(torch.int64)
    dev = pix.device
    nobj = pix.shape[0]
    amps = (torch.ones((nobj,), dtype=dtype, device=dev) if amps is None
            else as_tensor(amps, dev, dtype))
    srcmap = torch.zeros(geom.shape, dtype=dtype, device=dev)
    srcmap.index_put_((pix[:, 0], pix[:, 1]), amps, accumulate=True)
    if fwhm is not None:
        bl2d = F.gauss_beam(torch.as_tensor(geom.modlmap_np(), device=dev),
                            fwhm)
        return F.kfilter(srcmap, bl2d.to(dtype), geom)
    if profile is not None:
        rs, bprof = profile
        ker = spec1d_like_profile_k(geom, rs, bprof, device=dev)
        return F.kfilter(srcmap, ker.to(dtype), geom)
    return srcmap


def random_source_map(generator: torch.Generator, geom: Geometry, nobj,
                      fwhm=None, profile=None, amps=None,
                      dtype=torch.float32, device=None):
    """Map of ``nobj`` point sources at uniform-random pixels (drawn with
    ``generator``), convolved with a Gaussian beam or a 1D profile
    (reference ``maps.py:774``, flat-sky)."""
    device = resolve(device)
    ny, nx = geom.shape
    pix = torch.stack([
        torch.randint(0, ny, (nobj,), generator=generator, device=device),
        torch.randint(0, nx, (nobj,), generator=generator, device=device)],
        -1)
    return random_source_map_from_noise(pix, geom, fwhm, profile, amps,
                                        dtype)


def spec1d_like_profile_k(geom: Geometry, rs, bprof, dtype=torch.float32,
                          device=None):
    """k-space filter equal to the FFT of a radial real-space profile
    (helper for profile-convolved source maps)."""
    r2d = torch.as_tensor(geom.modrmap_np(), device=resolve(device))
    bprof = np.asarray(bprof)
    prof2d = interp(r2d, np.asarray(rs), bprof, left=float(bprof[0]),
                    right=0.0)
    k = torch.fft.fft2(torch.fft.ifftshift(prof2d, dim=(-2, -1)))
    return k.real.to(dtype)


def get_ecc(img):
    """Eccentricity from central image moments (reference
    ``maps.py:1262``; host numpy)."""
    img = np.asarray(img, np.float64)
    ny, nx = img.shape[-2:]
    y = np.arange(ny)[:, None]
    x = np.arange(nx)[None, :]
    m00 = img.sum()
    cy = (img * y).sum() / m00
    cx = (img * x).sum() / m00
    mu20 = (img * (y - cy) ** 2).sum() / m00
    mu02 = (img * (x - cx) ** 2).sum() / m00
    mu11 = (img * (y - cy) * (x - cx)).sum() / m00
    disc = np.sqrt(4.0 * mu11 ** 2 + (mu20 - mu02) ** 2)
    l1 = (mu20 + mu02) / 2.0 + disc / 2.0
    l2 = (mu20 + mu02) / 2.0 - disc / 2.0
    return np.sqrt(1.0 - l2 / l1)


def filter_alms(alms, lmin, lmax):
    """Top-hat multipole filter on packed alms (reference
    ``maps.py:1282``)."""
    from ..ops import alm as almops
    nalm_lmax = almops.getlmax(alms.shape[-1])
    ells = np.arange(nalm_lmax + 1)
    fl = ((ells >= lmin) & (ells <= lmax)).astype(np.float32)
    return almops.almxfl(alms, fl)


def area_from_mask(mask, geom: Geometry, device=None):
    """(area in sq deg, unmasked fraction) of a binary mask (the role of
    reference ``maps.py:1316``, via the equal-area flat geometry)."""
    frac = float(fsky_frac(mask, device=device))
    return frac * geom.area * (180.0 / np.pi) ** 2, frac


def fsky_frac(mask, threshold=0.5, device=None):
    m = binary_mask(mask, threshold, device)
    return m.sum() / np.prod(m.shape[-2:])


def flat_sim(deg, px, lmax=6000, lensed=True, pol=False, device=None):
    """One-liner bundle for flat-sky sims (reference ``maps.py:1366``):
    returns (geom, modlmap, theory, MapGen), the tensors on ``device``."""
    from . import theory as theory_mod
    from .grf import MapGen
    from ..geometry import rect_geometry
    geom = rect_geometry(width_deg=deg, px_res_arcmin=px)
    th = theory_mod.default_theory()
    ells = np.arange(min(lmax, th.lpad) + 1)
    cfun = th.lCl if lensed else th.uCl
    if pol:
        ps = np.zeros((3, 3, len(ells)))
        ps[0, 0] = cfun("TT", ells)
        ps[0, 1] = ps[1, 0] = cfun("TE", ells)
        ps[1, 1] = cfun("EE", ells)
        ps[2, 2] = cfun("BB", ells)
    else:
        ps = np.asarray(cfun("TT", ells))[None, None]
    device = resolve(device)
    return (geom, torch.as_tensor(geom.modlmap_np(), device=device), th,
            MapGen(geom, ps, device=device))


def resampled_geometry(geom: Geometry, res_rad):
    """Geometry covering the same patch at pixel size ``res_rad``
    (reference ``maps.py:1397``)."""
    ny = int(round(geom.ny * geom.dy / res_rad))
    nx = int(round(geom.nx * geom.dx / res_rad))
    return Geometry(ny, nx, res_rad, res_rad)


def _fit_axis(kk, size_in, size_out, axis):
    """Crop or zero-pad the fftshifted axis ``axis`` from ``size_in`` to
    ``size_out`` keeping the DC bin, which fftshift puts at n//2, at
    ``size_out//2`` (a "centered" (n-m)//2 crop misplaces it by one when
    the parities differ)."""
    cin, cout = size_in // 2, size_out // 2
    if size_out <= size_in:
        return kk.narrow(axis, cin - cout, size_out)
    shape = list(kk.shape)
    shape[axis] = size_out
    out = kk.new_zeros(shape)
    out.narrow(axis, cout - cin, size_in).copy_(kk)
    return out


def resample_fft(imap, geom: Geometry, res_rad, device=None):
    """Fourier resampling to pixel size ``res_rad`` (reference
    ``maps.py:1383``): crop or zero-pad the Fourier plane per axis (an
    anisotropic pixel can need a crop along one axis and a pad along the
    other), preserving the mean. Input must be periodic/windowed.
    Returns (map, geometry)."""
    imap = as_tensor(imap, device)
    ogeom = resampled_geometry(geom, res_rad)
    ny, nx = imap.shape[-2:]
    oy, ox = ogeom.shape
    k = torch.fft.fftshift(torch.fft.fft2(imap), dim=(-2, -1))
    k = _fit_axis(k, ny, oy, k.ndim - 2)
    k = _fit_axis(k, nx, ox, k.ndim - 1)
    k = torch.fft.ifftshift(k, dim=(-2, -1))
    out = torch.fft.ifft2(k).real * (oy * ox) / (ny * nx)
    return out, ogeom


def split_sky(dec_width, num_decs, ra_width, dec_start=0.0, ra_start=0.0,
              ra_extent=90.0):
    """Tile the sky into boxes of roughly constant solid angle
    (reference ``maps.py:1404``); degrees in, list of [[dec0, ra0],
    [dec1, ra1]] boxes out."""
    boxes = []
    for yindex in range(num_decs):
        y0 = dec_start + yindex * dec_width
        y1 = dec_start + (yindex + 1) * dec_width
        cosfact = np.cos(np.deg2rad((y0 + y1) / 2.0))
        nx = int(ra_extent * cosfact / ra_width)
        for xindex in range(nx):
            x0 = ra_start + xindex * ra_width / cosfact
            x1 = ra_start + (xindex + 1) * ra_width / cosfact
            boxes.append(np.array([[y0, x0], [y1, x1]]))
    return boxes


def cutup(shape, numy, numx, pad=0):
    """Pixel bounding boxes tiling a map into numy x numx (optionally
    padded, clipped) blocks (reference ``maps.py:1446``)."""
    Ny, Nx = shape[-2:]
    pixs_y = np.linspace(0, Ny, num=numy + 1, endpoint=True)
    pixs_x = np.linspace(0, Nx, num=numx + 1, endpoint=True)
    boxes = np.zeros((numy * numx, 2, 2))
    boxes[:, 0, 0] = np.clip(np.tile(pixs_y[:-1], numx) - pad, 0, None)
    boxes[:, 1, 0] = np.clip(np.tile(pixs_y[1:], numx) + pad, None, Ny - 1)
    boxes[:, 0, 1] = np.clip(np.repeat(pixs_x[:-1], numy) - pad, 0, None)
    boxes[:, 1, 1] = np.clip(np.repeat(pixs_x[1:], numy) + pad, None,
                             Nx - 1)
    return boxes.astype(int)


def bounds_from_list(blist):
    """[dec0, ra0, dec1, ra1] degrees -> [[dec0, ra0], [dec1, ra1]]
    radians (reference ``maps.py:1465``)."""
    return np.array(blist).reshape((2, 2)) * np.pi / 180.0


def spec1d_to_2d(geom: Geometry, ps, dtype=torch.float32, device=None):
    """1D spectrum painted on the 2D Fourier plane in physical units
    (reference ``maps.py:1591``: spec2flat divided by npix/area)."""
    ps = np.asarray(ps, np.float64)
    ells = np.arange(ps.shape[-1], dtype=np.float64)
    return F.interp1d_to_2d(ells, ps, geom, dtype=dtype, device=device)


def get_lnlike(covinv, instamp, device=None):
    """Gaussian chi^2 kernel v^T Cinv v of a flattened stamp (reference
    ``maps.py:1830``)."""
    vec = as_tensor(instamp, device).reshape(-1)
    return vec @ as_tensor(covinv, vec.device) @ vec


def _grf_covsqrt(geom: Geometry, power2d, device):
    """float32 (ncomp, ncomp, ny, nx) covsqrt of a power plane in spectrum
    units, formed in float64: the elementwise root for one component, the
    eigen root for a matrix."""
    from .grf import eig_pow
    p = as_tensor(power2d, device, torch.float64)
    fac = geom.npix / geom.area
    if p.ndim == 2 or (p.ndim == 4 and p.shape[0] == 1):
        covsqrt = torch.sqrt(torch.clamp(p * fac, min=0.0))
    else:
        stack = torch.movedim(p * fac, (0, 1), (-2, -1))
        covsqrt = torch.movedim(eig_pow(stack, 0.5), (-2, -1), (0, 1))
    if covsqrt.ndim == 2:
        covsqrt = covsqrt[None, None]
    return covsqrt.to(torch.float32)


def get_grf_realization_from_noise(eta, geom: Geometry, power2d):
    """:func:`get_grf_realization` from complex white noise ``eta``
    ``(..., ncomp, ny, nx)``, on its device."""
    from .grf import rand_map_from_noise
    return rand_map_from_noise(eta, geom, _grf_covsqrt(geom, power2d,
                                                       eta.device))


def get_grf_realization(generator: torch.Generator, geom: Geometry, power2d,
                        device=None):
    """One float32 GRF realization from a 2D power plane in spectrum units
    (``(ny, nx)``, ``(1, 1, ny, nx)`` or a full ``(ncomp, ncomp, ny, nx)``
    matrix; reference ``maps.py:2844``), drawn with ``generator``."""
    from .grf import rand_kmap, rand_map_from_noise
    cs = _grf_covsqrt(geom, power2d, device)
    eta = rand_kmap(geom, generator, cs.shape[0], device=cs.device)
    return rand_map_from_noise(eta, geom, cs)


def _cmb_power2d(geom: Geometry, theory, spec):
    """The theory spectrum interpolated onto modlmap, host float64
    (1, 1, ny, nx) (reference ``maps.py:2836``)."""
    ml = geom.modlmap_np()
    ells = np.arange(int(ml.max()) + 1)
    cl = np.asarray(theory.gCl(spec, ells))
    return np.interp(ml, ells, cl, left=0.0, right=0.0)[None, None]


def get_grf_cmb_from_noise(eta, geom: Geometry, theory, spec):
    """:func:`get_grf_cmb` from complex white noise ``eta``."""
    return get_grf_realization_from_noise(eta, geom,
                                          _cmb_power2d(geom, theory, spec))


def get_grf_cmb(generator: torch.Generator, geom: Geometry, theory, spec,
                device=None):
    """GRF with a theory spectrum painted on this geometry's modlmap
    (reference ``maps.py:2836``)."""
    return get_grf_realization(generator, geom,
                               _cmb_power2d(geom, theory, spec), device)


def rgeo(degrees, pixarcmin, **kwargs):
    """rect_geometry(width_deg=degrees, px_res_arcmin=pixarcmin)
    (reference ``maps.py:2873``)."""
    from ..geometry import rect_geometry
    return rect_geometry(width_deg=degrees, px_res_arcmin=pixarcmin,
                         **kwargs)


def resolution(geom: Geometry):
    """Geometric-mean pixel size in radians (reference
    ``maps.py:2181``); sign-safe for CAR-style negative dy."""
    return float(np.sqrt(abs(geom.dy * geom.dx)))


def autofiltered_maps(imap, geom: Geometry, ivar=None, mask=None,
                      threshold=1e-8, apod_deg=1.5, grow_deg=1.5,
                      lxcut=10, lycut=10, lmin=None, lmax=None, device=None):
    """Quick-look filtered map + auto-generated mask (reference
    ``maps.py:16``): threshold the ivar into a mask, grow + apodize it,
    apply a plus-shaped k-space filter, zero the masked region."""
    from ..ops import distance as D
    imap = as_tensor(imap, device)
    dev = imap.device
    if mask is None:
        bmask = (as_tensor(ivar, dev) > threshold).to(torch.float32)
        grown = D.grow_mask(bmask, geom, np.deg2rad(grow_deg))
        mask = D.cosine_apodize(grown, geom, apod_deg)
    mask = as_tensor(mask, dev)
    if (lxcut is not None) or (lycut is not None):
        kmask = F.mask_kspace(geom, lxcut=lxcut, lycut=lycut, lmin=lmin,
                              lmax=lmax, device=dev)
        fmap = F.kfilter(mask * imap, kmask, geom)
    else:
        fmap = imap
    fmap = torch.where(mask <= (1 - threshold),
                       torch.zeros((), dtype=fmap.dtype, device=dev), fmap)
    return fmap, mask


def fourier_stack(kmap, bin_edges, geom: Geometry):
    """One-shot FourierStack.apply (reference ``maps.py:76``), on
    ``kmap``'s device."""
    return FourierStack(geom, bin_edges, device=kmap.device).apply(kmap)


def slice_from_box(geom: Geometry, box_rad, inclusive=False):
    """numpy slice selecting the pixels inside [[dec0, ra0], [dec1,
    ra1]] (radians, patch-centered coordinates): the role of reference
    ``maps.py:1426`` for the flat Geometry."""
    box = np.asarray(box_rad)
    y0 = int(np.floor((box[0, 0] - geom.y0) / geom.dy
                      + (geom.ny - 1) / 2 + (0 if inclusive else 0.5)))
    y1 = int(np.floor((box[1, 0] - geom.y0) / geom.dy
                      + (geom.ny - 1) / 2 + (1 if inclusive else 0.5)))
    x0 = int(np.floor(box[0, 1] / geom.dx + (geom.nx - 1) / 2
                      + (0 if inclusive else 0.5)))
    x1 = int(np.floor(box[1, 1] / geom.dx + (geom.nx - 1) / 2
                      + (1 if inclusive else 0.5)))
    return np.s_[..., max(y0, 0):min(y1, geom.ny),
                 max(x0, 0):min(x1, geom.nx)]


# ------------------------------------------------------------------
# real-space convolution (reference maps.py:2785-2833)
# ------------------------------------------------------------------

def convolve(imap, kernel, device=None):
    """Linear ('same'-mode) real-space convolution of map(s) with a 2D
    kernel (reference ``orphics/maps.py:2795``) by a zero-padded FFT
    convolution; supports leading component axes."""
    imap = as_tensor(imap, device)
    kernel = as_tensor(kernel, imap.device, imap.dtype)
    ny, nx = imap.shape[-2:]
    ky, kx = kernel.shape
    py, px = ny + ky - 1, nx + kx - 1
    fi = torch.fft.rfft2(imap, s=(py, px))
    fk = torch.fft.rfft2(kernel, s=(py, px))
    full = torch.fft.irfft2(fi * fk, s=(py, px))
    # crop to scipy.signal.convolve(mode='same') alignment
    y0, x0 = (ky - 1) // 2, (kx - 1) // 2
    return full[..., y0:y0 + ny, x0:x0 + nx]


def convolve_gaussian(imap, geom: Geometry, fwhm_arcmin, nsigma=5.0,
                      device=None):
    """Convolve with a real-space Gaussian beam kernel (reference
    ``orphics/maps.py:2813``)."""
    imap = as_tensor(imap, device)
    fwhm = fwhm_arcmin * arcmin
    sigma_y = fwhm / (np.sqrt(8.0 * np.log(2.0)) * abs(geom.dy))
    sigma_x = fwhm / (np.sqrt(8.0 * np.log(2.0)) * abs(geom.dx))
    return convolve(imap, gauss_kern(sigma_y, sigma_x, nsigma=nsigma,
                                     device=imap.device))


def convolve_profile(imap, geom: Geometry, rs, bprof, fwhm_guess_arcmin,
                     nsigma=20.0, device=None):
    """Convolve with a kernel interpolated from a 1D radial profile
    (reference ``orphics/maps.py:2785``); ``rs`` in radians."""
    imap = as_tensor(imap, device)
    g = gkern_interp(geom, rs, bprof, fwhm_guess_arcmin, nsigma=nsigma,
                     device=imap.device)
    return convolve(imap, g)


def pixcov_sim_from_noise(eta, geom: Geometry, ps, mean_sub=True, pad=0):
    """:func:`pixcov_sim` from complex white noise ``eta`` ``(nsims,
    ncomp, ny + 2 pad, nx + 2 pad)``, on its device."""
    from .grf import MapGen
    g = (Geometry(geom.ny + 2 * pad, geom.nx + 2 * pad, geom.dy, geom.dx,
                  geom.y0) if pad > 0 else geom)
    sims = MapGen(g, np.asarray(ps), device=eta.device).get_map_from_noise(
        eta)                                   # (nsims[, ncomp], ny, nx)
    if mean_sub:
        sims = sims - sims.mean(dim=(-2, -1), keepdim=True)
    if pad > 0:
        sims = sims[..., pad:-pad, pad:-pad]
    X = sims.reshape(eta.shape[0], -1).cpu().numpy()
    return np.cov(X.T)


def pixcov_sim(geom: Geometry, ps, nsims, generator=None, mean_sub=True,
               pad=0, device=None):
    """Brute-force Monte-Carlo pixel-pixel covariance of GRF sims
    (reference ``orphics/maps.py:1840``): ``nsims`` sims drawn as one batch
    with ``generator`` (by default one seeded with 0) on the padded
    geometry, centers extracted, host covariance."""
    from .grf import rand_kmap
    device = resolve(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    ps = np.asarray(ps)
    ncomp = 1 if ps.ndim == 1 else ps.shape[0]
    g = Geometry(geom.ny + 2 * pad, geom.nx + 2 * pad, geom.dy, geom.dx,
                 geom.y0)
    eta = rand_kmap(g, generator, ncomp, batch=(nsims,), device=device)
    return pixcov_sim_from_noise(eta, geom, ps, mean_sub, pad)


def get_planck_cutout(hp_map, ra_deg, dec_deg, arcmin_width, px=2.0,
                      arcmin_y=None, device=None):
    """Gnomonic cutout of a healpix map around (ra, dec) (reference
    ``orphics/maps.py:2417``; coordinates in the map's frame), on
    ``device``."""
    if arcmin_y is None:
        arcmin_y = arcmin_width
    thumb, g = thumbnail_healpix(hp_map, ra_deg, dec_deg,
                                 width_arcmin=max(arcmin_width, arcmin_y),
                                 px_res_arcmin=px)
    ny = int(arcmin_y / px)
    nx = int(arcmin_width / px)
    return crop_center(as_tensor(thumb, device), ny, nx)
