"""Pixel-pixel covariances for small stamps; maximum-likelihood inpainting
(port of ``orphics_tpu.models.pixcov``; reference ``orphics/pixcov.py``).

The brute-force inpainting of circular holes (Eq 3 of arXiv:1109.0286):
the per-source dense algebra is batched ``torch.linalg`` calls on the
covariance's device and dtype, and the per-map fill (mean infill plus an
optional covsqrt draw) is matrix products. Math as in the JAX package:

  * the stamp covariance is block-circulant: C[p1, p2] = xi((x1-x2) mod n)
    with xi = raw_ifft(P2d * npix/area) (``pixcov.py:21-38,87-102``);
  * IQU ordering is component-major blocks (``pixcov.py:243``);
  * the common mode of each component is deprojected with a Woodbury
    correction (``pixcov.py:249-253``);
  * hole pixels m1, context m2; mean infill = -Cinv[m1,m1]^{-1} Cinv[m1,m2]
    applied to the context; fluctuation drawn with covsqrt =
    eigpow(inv(Cinv[m1,m1]), 1/2) (``pixcov.py:255-266``).

One hole geometry is often shared by every stamp (bench config 5): then
:func:`inpaint_stamps_batched` takes a 2-D ``meanmul`` / ``covsqrt`` and
the fill of B stamps is one (B, nc) @ (nc, nh) product; a per-stamp 3-D
stack whose batch stride is 0 (an ``expand``) is read as the shared one,
never copied. Tensors keep their device; host arrays and the factories
go to ``device`` (``None``: the card). Each draw takes a
``torch.Generator``, or the standard normals themselves as ``noise``.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from .._device import as_tensor as _t, resolve
from ..geometry import Geometry, arcmin
from ..ops import fourier as F
from .grf import eig_pow

__all__ = [
    "ps2d_to_mat", "rotate_pol_power", "stamp_pixcov_from_theory",
    "scov_from_theory", "ncov_ivar_diag", "get_geometry_regions",
    "make_geometry", "make_geometries_batched", "inpaint_stamp",
    "inpaint_stamps_batched", "extract_stamps", "insert_stamps", "inpaint",
    "save_geometries", "load_geometries", "map_ifft", "resolution",
    "get_regions", "paste", "pcov_from_ivar", "tpcov_from_ivar",
    "cinv_inpaint", "preload_geometries",
    "corrfun_thumb", "corr_to_mat", "fcov_to_rcorr", "ncov_from_ivar",
]


def _idx(m, device):
    """Flat pixel indices as an int64 tensor on ``device``."""
    if isinstance(m, torch.Tensor):
        return m.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(m, dtype=np.int64), device=device)


def ps2d_to_mat(p2d, geom_stamp: Geometry, device=None):
    """2D power (stamp Fourier grid, physical units) -> (n^2, n^2)
    block-circulant pixel covariance (reference ``pixcov.py:33`` + the
    npix/area scaling of ``fcov_to_rcorr`` at ``pixcov.py:87``)."""
    p2d = _t(p2d, device)
    n_y, n_x = geom_stamp.shape
    corr = torch.fft.ifft2(p2d * (geom_stamp.npix / geom_stamp.area)).real
    iy = np.arange(n_y)
    ix = np.arange(n_x)
    dy = _idx(((iy[:, None] - iy[None, :]) % n_y).T, corr.device)
    dx = _idx(((ix[:, None] - ix[None, :]) % n_x).T, corr.device)
    # mat[(i,j),(k,l)] = corr[(k-i)%n, (l-j)%n]
    mat = corr[dy[:, None, :, None], dx[None, :, None, :]]
    return mat.reshape(n_y * n_x, n_y * n_x)


def rotate_pol_power(geom: Geometry, cov, iau: bool = False,
                     inverse: bool = False):
    """Rotate (3,3,ny,nx) 2D power between TEB and TQU
    (reference ``pixcov.py:42``); the rotation is formed in float32, as
    in the JAX package."""
    prot = F.queb_rotmat(geom, inverse=inverse, iau=iau,
                         device=cov.device).to(cov.dtype)
    rot = torch.zeros((3, 3) + geom.shape, dtype=cov.dtype,
                      device=cov.device)
    rot[0, 0] = 1.0
    rot[1:, 1:] = prot
    return torch.einsum("ab...,bc...,dc...->ad...", rot, cov, rot)


def stamp_pixcov_from_theory(geom_stamp: Geometry, cmb2d_TEB, n2d_IQU=0.0,
                             beam2d=1.0, iau: bool = False, device=None):
    """(ncomp, ncomp, n^2, n^2) stamp covariance from 2D TEB CMB power,
    beam and IQU noise power (reference ``pixcov.py:67``), in the dtype
    of ``cmb2d_TEB``."""
    cmb2d = _t(cmb2d_TEB, device)
    ncomp = cmb2d.shape[0]
    if ncomp == 3:
        cmb2d = rotate_pol_power(geom_stamp, cmb2d, iau=iau, inverse=True)
    beam2d = _t(beam2d, cmb2d.device, cmb2d.dtype)
    n2d = _t(n2d_IQU, cmb2d.device, cmb2d.dtype)
    p2d = cmb2d * beam2d ** 2 + n2d
    npx = geom_stamp.npix
    out = torch.zeros((ncomp, ncomp, npx, npx), dtype=p2d.dtype,
                      device=p2d.device)
    for i in range(ncomp):
        for j in range(i, ncomp):
            m = ps2d_to_mat(p2d[i, j], geom_stamp)
            out[i, j] = m
            if i != j:
                out[j, i] = m
    return out


def scov_from_theory(geom_stamp: Geometry, theory, beam_fn=None,
                     ncomp: int = 3, iau: bool = False,
                     dtype=torch.float64, device=None):
    """Signal stamp covariance from a TheorySpectra + beam function
    (reference ``pixcov.py:117``), flattened to component-major
    (ncomp n^2, ncomp n^2), in ``dtype`` on ``device``."""
    dev = resolve(device)
    modlmap = geom_stamp.modlmap_np()
    ells = np.arange(theory.lpad + 1)

    def cl2d(spec):
        return np.interp(modlmap, ells, np.asarray(theory.lCl(spec, ells)),
                         left=0, right=0)

    cmb = np.zeros((ncomp, ncomp) + geom_stamp.shape)
    cmb[0, 0] = cl2d("TT")
    if ncomp > 1:
        cmb[1, 1] = cl2d("EE")
        cmb[2, 2] = cl2d("BB")
        cmb[0, 1] = cmb[1, 0] = cl2d("TE")
    beam2d = np.asarray(beam_fn(modlmap)) if beam_fn is not None else 1.0
    cov = stamp_pixcov_from_theory(
        geom_stamp, torch.as_tensor(cmb, dtype=dtype, device=dev), 0.0,
        beam2d, iau)
    return _comp_major(cov)


def _comp_major(cov4):
    """(ncomp,ncomp,npix,npix) -> (ncomp*npix, ncomp*npix), component-major
    blocks (the reference's transpose(0,2,1,3) ordering, pixcov.py:243)."""
    ncomp, _, npx, _ = cov4.shape
    return cov4.permute(0, 2, 1, 3).reshape(ncomp * npx, ncomp * npx)


def ncov_ivar_diag(ivar_stamp, ncomp: int = 3, device=None):
    """Diagonal white-noise variance vector (comp-major, len ncomp*n^2)
    from ivar stamp(s) ``(..., n, n)``; QQ = UU = 2 II (reference
    ``pixcov.py:104``)."""
    iv = _t(ivar_stamp, device)
    iv = iv.reshape(iv.shape[:-2] + (-1,))
    pos = iv > 0
    maxvar = 1.0 / torch.where(pos, iv, -torch.inf).amax(-1, keepdim=True)
    var = torch.where(pos, 1.0 / torch.where(pos, iv, 1.0), maxvar)
    comps = [var] + [2.0 * var] * (ncomp - 1)
    return torch.cat(comps[:ncomp], dim=-1)


def get_geometry_regions(ncomp: int, n: int, res: float, hole_radius: float):
    """Static hole (m1) and context (m2) index arrays, comp-major
    (reference ``pixcov.py:448``); host numpy."""
    y = (np.arange(n) - (n - 1) / 2.0) * res
    modrmap = np.sqrt(y[:, None] ** 2 + y[None, :] ** 2)
    a = np.tile(modrmap.reshape(-1), ncomp)
    m1 = np.where(a < hole_radius)[0]
    m2 = np.where(a >= hole_radius)[0]
    return m1, m2


def make_geometry(pcov, m1, m2, deproject: bool = True, ncomp: int = 3):
    """covsqrt + meanmul from a (..., ncomp n^2, ncomp n^2) pixel
    covariance (reference ``pixcov.py:193``), in its dtype on its device;
    leading batch axes are solved together."""
    pcov = _t(pcov)
    N = pcov.shape[-1]
    npx = N // ncomp
    cinv = torch.linalg.inv(pcov)
    if deproject:
        u = torch.zeros((N, ncomp), dtype=pcov.dtype, device=pcov.device)
        for i in range(ncomp):
            u[i * npx:(i + 1) * npx, i] = 1.0
        cinvu = torch.linalg.solve(pcov, u.expand(pcov.shape[:-2] + u.shape))
        inner = torch.linalg.solve(u.T @ cinvu, u.T.expand(
            pcov.shape[:-2] + u.T.shape))
        cinv = cinv - cinvu @ (inner @ cinv)
    m1 = _idx(m1, pcov.device)
    m2 = _idx(m2, pcov.device)
    rows = cinv.index_select(-2, m1)
    c11 = rows.index_select(-1, m1)
    c12 = rows.index_select(-1, m2)
    meanmul = -torch.linalg.solve(c11, c12)
    cov = torch.linalg.inv(c11)
    covsqrt = eig_pow(cov, 0.5)
    return covsqrt, meanmul


def make_geometries_batched(scov, ivar_stamps, m1, m2, ncomp: int = 3,
                            deproject: bool = True):
    """Batched geometry precompute: one static signal covariance + per-stamp
    diagonal noise (the batched replacement for the MPI-over-sources loop
    of reference ``pixcov.py:520``). Returns (B, nh, nh) covsqrt and
    (B, nh, nc) meanmul, in the dtype of ``scov`` on its device."""
    scov = _t(scov)
    nvar = ncov_ivar_diag(_t(ivar_stamps, scov.device), ncomp).to(scov.dtype)
    pcov = scov + torch.diag_embed(nvar)
    return make_geometry(pcov, m1, m2, deproject=deproject, ncomp=ncomp)


def _shared(mat):
    """The 2-D matrix behind a shared geometry: a 2-D ``mat`` itself, or a
    3-D stack broadcast along its batch axis (stride 0); else None."""
    if mat.ndim == 2:
        return mat
    if mat.stride(0) == 0 or mat.shape[0] == 1:
        return mat[0]
    return None


def _apply(mat, vec):
    """``mat @ vec`` per stamp: ``vec`` (B, k); ``mat`` (m, k) shared, or
    (B, m, k) per stamp. Returns (B, m)."""
    shared = _shared(mat)
    if shared is not None:
        return vec @ shared.T
    return torch.bmm(mat, vec[..., None])[..., 0]


def inpaint_stamps_batched(stamps, covsqrts, meanmuls, m1, m2,
                           generator=None, noise=None):
    """Max-like fill of the holes of (B, ncomp, n, n) stamps (reference
    ``pixcov.py:296``, batched). ``meanmuls`` is (nh, nc) for a geometry
    shared by every stamp (one matrix product for the batch; a 3-D stack
    whose batch stride is 0 counts as shared) or (B, nh, nc) per stamp;
    ``covsqrts`` likewise (nh, nh) or (B, nh, nh). The fill is computed
    in ``meanmuls``' dtype and written in the stamps'. With neither
    ``generator`` nor ``noise`` the fill is the mean; else
    ``covsqrt @ r`` is added, r standard normals of shape (B, nh) drawn
    from ``generator`` or given as ``noise``."""
    if generator is not None and noise is not None:
        raise ValueError("pass generator or noise, not both")
    B = stamps.shape[0]
    dev = stamps.device
    m1 = _idx(m1, dev)
    m2 = _idx(m2, dev)
    flat = stamps.reshape(B, -1)
    ctx = flat.index_select(1, m2).to(meanmuls.dtype)
    sim = _apply(meanmuls, ctx)
    if generator is not None:
        noise = torch.randn((B, m1.shape[0]), generator=generator,
                            dtype=covsqrts.dtype, device=dev)
    if noise is not None:
        sim = sim + _apply(covsqrts, noise.to(covsqrts.dtype))
    out = flat.index_copy(1, m1, sim.to(flat.dtype))
    return out.reshape(stamps.shape)


def inpaint_stamp(stamp, covsqrt, meanmul, m1, m2, generator=None,
                  noise=None):
    """Max-like fill of the hole of one (ncomp, n, n) stamp (reference
    ``pixcov.py:296``); comp-major flattening. Mean only unless a
    ``generator`` or the (nh,) standard normals ``noise`` are given."""
    if noise is not None:
        noise = noise[None]
    out = inpaint_stamps_batched(stamp[None], covsqrt, meanmul, m1, m2,
                                 generator=generator, noise=noise)
    return out[0]


# ------------------------------------------------------------------
# big-map cutout plumbing
# ------------------------------------------------------------------

def _starts(pix_coords, n, shape, device):
    """Top-left corners of the stamps as the JAX package's dynamic slices
    take them: a negative corner counts from the far edge, then every
    corner is clamped so that the stamp lies inside the map."""
    pix = torch.as_tensor(np.asarray(pix_coords)) \
        if not isinstance(pix_coords, torch.Tensor) else pix_coords
    start = pix.to(device=device, dtype=torch.int64) - n // 2
    dims = torch.tensor(tuple(shape), device=device)
    start = torch.where(start < 0, start + dims, start)
    return torch.minimum(torch.clamp(start, min=0), dims - n)


def extract_stamps(imap, pix_coords, n: int, device=None):
    """(B, ..., n, n) stamps centered at integer pixel coords (B, 2)
    (reference ``extract_cutouts``, ``pixcov.py:865``); corners are taken
    as the JAX package's dynamic slices take them (:func:`_starts`), so
    keep the stamps inside the map."""
    imap = _t(imap, device)
    start = _starts(pix_coords, n, imap.shape[-2:], imap.device)
    ar = torch.arange(n, device=imap.device)
    ys = (start[:, 0, None] + ar)[:, :, None]           # (B, n, 1)
    xs = (start[:, 1, None] + ar)[:, None, :]           # (B, 1, n)
    out = imap[..., ys, xs]                             # (..., B, n, n)
    return out.movedim(-3, 0)


def insert_stamps(imap, stamps, pix_coords, n: int, device=None):
    """Write stamps back at their locations in order (stamps may overlap;
    the last writer wins, as in the reference's in-place loop)."""
    out = _t(imap, device).clone()
    stamps = _t(stamps, out.device)
    start = _starts(pix_coords, n, out.shape[-2:], out.device).tolist()
    for st, (y, x) in zip(stamps, start):
        out[..., y:y + n, x:x + n] = st
    return out


def inpaint(imap, coords_pix, geom: Geometry, theory, beam_fn,
            ivar=None, noise_uk_arcmin=None, hole_radius_arcmin=5.0,
            npix_context: int = 40, ncomp: int = None, generator=None,
            deproject: bool = True, noise=None, device=None):
    """End-to-end joint IQU inpainting of circular holes (reference
    ``pixcov.py:334``): build the stamp geometry from theory+beam+noise
    (float64), batch-precompute, extract stamps, fill, re-insert. A tensor
    ``imap`` keeps its device, a host map goes to ``device``; ``generator``
    or ``noise`` ((B, nh) standard normals for the kept sources) add the
    fluctuation.
    """
    imap = _t(imap, device)
    dev = imap.device
    if ncomp is None:
        ncomp = imap.shape[0] if imap.ndim == 3 else 1
    n = npix_context
    gstamp = Geometry(n, n, geom.dy, geom.dx)
    scov = scov_from_theory(gstamp, theory, beam_fn, ncomp=ncomp,
                            device=dev)
    # hole/context selection from the STAMP's own (possibly anisotropic)
    # physical distance map, so the partition and the covariance agree
    # for dy != dx geometries
    m1, m2 = get_regions(ncomp, gstamp.modrmap_np(),
                         hole_radius_arcmin * arcmin)
    coords_pix = np.asarray(coords_pix)
    # skip sources whose context stamp would overlap the map edge: a
    # clamped stamp is mis-centered and its infill would overwrite good
    # pixels offset from the source (the reference skips these,
    # pixcov.py:414-426)
    ny_m, nx_m = imap.shape[-2:]
    half = n // 2
    good = ((coords_pix[:, 0] >= half) & (coords_pix[:, 0] < ny_m - half)
            & (coords_pix[:, 1] >= half) & (coords_pix[:, 1] < nx_m - half))
    nskip = int((~good).sum())
    if nskip:
        warnings.warn(f"inpaint: skipping {nskip}/{len(good)} sources "
                      "whose context stamps overlap the map edge")
        coords_pix = coords_pix[good]
        if coords_pix.shape[0] == 0:
            return imap
    B = coords_pix.shape[0]
    if ivar is not None:
        ivar_stamps = extract_stamps(_t(ivar, dev), coords_pix, n)
    else:
        iv = 1.0 / ((noise_uk_arcmin * arcmin) ** 2 / geom.pixsize)
        ivar_stamps = torch.full((B, n, n), iv, dtype=torch.float64,
                                 device=dev)
    covsqrts, meanmuls = make_geometries_batched(scov, ivar_stamps, m1, m2,
                                                 ncomp=ncomp,
                                                 deproject=deproject)
    full = imap if imap.ndim == 3 else imap[None]
    stamps = extract_stamps(full, coords_pix, n)
    filled = inpaint_stamps_batched(stamps, covsqrts, meanmuls, m1, m2,
                                    generator=generator, noise=noise)
    out = insert_stamps(full, filled, coords_pix, n)
    return out if imap.ndim == 3 else out[0]


def save_geometries(fname, covsqrts, meanmuls, m1, m2, meta=None):
    """Persist batched inpainting geometries in one npz (the JAX
    package's file format; reference saves per-source HDF5,
    ``pixcov.py:677``)."""
    host = lambda a: (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                      else np.asarray(a))
    np.savez(fname, covsqrts=host(covsqrts), meanmuls=host(meanmuls),
             m1=host(m1), m2=host(m2), **(meta or {}))


def load_geometries(fname, device=None):
    """``(covsqrts, meanmuls, m1, m2)`` from :func:`save_geometries` (or
    the JAX package's): the matrices as tensors on ``device`` (``None``:
    the card), the index arrays as host numpy."""
    d = np.load(fname)
    dev = resolve(device)
    return (torch.as_tensor(d["covsqrts"], device=dev),
            torch.as_tensor(d["meanmuls"], device=dev), d["m1"], d["m2"])


# ---------------------------------------------------------------------------
# Reference-surface tail (pixcov.py:19, 104, 208, 239, 303, 361, 520, 586)
# ---------------------------------------------------------------------------

def map_ifft(x, geom: Geometry = None, device=None):
    """Real part of the inverse FFT (reference ``pixcov.py:19``)."""
    return torch.fft.ifft2(_t(x, device)).real


def corrfun_thumb(corr, n_y, n_x=None, device=None):
    """Cut the (2 n_y, 2 n_x) separation thumbnail out of a full-map
    correlation function (reference ``pixcov.py:21``): cyclic shifts
    place separations ``[-n, n)`` contiguously before cropping, then
    shift back so index 0 is zero separation again."""
    if n_x is None:
        n_x = n_y
    corr = _t(corr, device)
    tmp = torch.roll(torch.roll(corr, n_x, -1)[..., :2 * n_x],
                     n_y, -2)[..., :2 * n_y, :]
    return torch.roll(torch.roll(tmp, -n_x, -1), -n_y, -2)


def corr_to_mat(corr, n_y, n_x=None, device=None):
    """(n_y*n_x per side) pixel-pixel matrix from a cyclic correlation
    thumbnail: ``mat[i,j,k,l] = corr[(k-i) % H, (l-j) % W]`` (reference
    ``pixcov.py:25`` — the double roll loop, done as one gather)."""
    if n_x is None:
        n_x = n_y
    corr = _t(corr, device)
    h, w = corr.shape[-2:]
    iy = np.arange(n_y)
    ix = np.arange(n_x)
    dy = _idx((iy[None, :] - iy[:, None]) % h, corr.device)    # (i, k)
    dx = _idx((ix[None, :] - ix[:, None]) % w, corr.device)    # (j, l)
    return corr[..., dy[:, None, :, None], dx[None, :, None, :]]


def fcov_to_rcorr(geom: Geometry, p2d, n_y, n_x=None, device=None):
    """(ncomp, ncomp, Ny, Nx) 2D power -> (ncomp, ncomp, n_y*n_x,
    n_y*n_x) pixel covariance for an ``n_y x n_x`` thumbnail (reference
    ``pixcov.py:87``): npix/area physical scaling, correlation via the
    inverse FFT, cyclic thumbnail, separation gather. ``geom`` is the
    geometry the power grid lives on (its shape must match p2d)."""
    if n_x is None:
        n_x = n_y
    p2d = _t(p2d, device)
    if p2d.ndim == 2:
        p2d = p2d[None, None]
    ncomp = p2d.shape[0]
    corr = torch.fft.ifft2(p2d * (geom.npix / geom.area)).real
    thumb = corrfun_thumb(corr, n_y, n_x)
    mat = corr_to_mat(thumb, n_y, n_x)            # (nc, nc, ny, nx, ny, nx)
    return mat.reshape(ncomp, ncomp, n_y * n_x, n_y * n_x)


def ncov_from_ivar(ivar, ncomp: int = 3, device=None):
    """Dense diagonal IQU noise covariance from an inverse-variance map
    (reference ``pixcov.py:104``): var = 1/ivar, with zero-ivar pixels
    assigned ``1/max(ivar)`` — the variance of the *best*-measured
    pixel, i.e. the reference's regularization. QQ = UU = 2 II. Returns
    (ncomp, ncomp, N, N) with N = ny*nx. The diagonal-vector form used
    by the batched inpainting path is ``ncov_ivar_diag``."""
    ivar = _t(ivar, device)
    if ivar.ndim != 2:
        raise ValueError("ivar must be a 2D map")
    var = ncov_ivar_diag(ivar, 1)
    n = var.shape[0]
    out = torch.zeros((ncomp, ncomp, n, n), dtype=var.dtype,
                      device=var.device)
    for c in range(ncomp):
        fac = 1.0 if c == 0 else 2.0
        out[c, c] = torch.diag(fac * var)
    return out


def resolution(geom: Geometry):
    """Pixel size in radians (reference ``pixcov.py:104`` applies
    abs(): CAR-style negative dy must not flip the sign)."""
    return float(min(abs(geom.dy), abs(geom.dx)))


def get_regions(ncomp: int, modrmap, hole_radius):
    """Hole (m1) / context (m2) flat indices across components from a
    distance map (reference ``pixcov.py:520``); host numpy."""
    modrmap = np.asarray(modrmap)
    if modrmap.ndim != 2:
        raise ValueError("modrmap must be 2D")
    rep = np.repeat(modrmap[None], ncomp, 0).reshape(-1)
    m1 = np.where(rep < hole_radius)[0]
    m2 = np.where(rep >= hole_radius)[0]
    return m1, m2


def paste(stamp, m, paste_this, device=None):
    """Write values into the flat indices ``m`` of a stamp (reference
    ``pixcov.py:303``), returning the updated stamp."""
    stamp = _t(stamp, device)
    flat = stamp.reshape(-1).index_copy(
        0, _idx(m, stamp.device), _t(paste_this, stamp.device, stamp.dtype))
    return flat.reshape(stamp.shape)


def _var_from_ivar(ivar_stamp):
    ivar = np.asarray(ivar_stamp, dtype=np.float64)
    with np.errstate(divide="ignore"):
        var = 1.0 / ivar
    var[~np.isfinite(var)] = 1.0 / ivar[ivar > 0].max()
    return var


def pcov_from_ivar(n, ivar_stamp, theory_fn, beam_fn, geom_stamp: Geometry,
                   iau=False, device=None):
    """(3, 3, n^2, n^2) IQU pixel covariance from an inverse-variance
    stamp + theory/beam functions (reference ``pixcov.py:239``), float64
    on ``device``: signal pixcov from theory plus a diagonal noise cov with
    the pol variance doubled."""
    dev = resolve(device)
    var = _var_from_ivar(ivar_stamp)
    modlmap = geom_stamp.modlmap_np()
    cmb2d = np.zeros((3, 3, n, n))
    for i, s in enumerate(("TT", "EE", "BB")):
        cmb2d[i, i] = theory_fn(s, modlmap)
    cmb2d[0, 1] = cmb2d[1, 0] = theory_fn("TE", modlmap)
    scov = stamp_pixcov_from_theory(
        geom_stamp, torch.as_tensor(cmb2d, device=dev), n2d_IQU=0.0,
        beam2d=np.asarray(beam_fn(modlmap), np.float64), iau=iau)
    ncov = np.zeros((3, 3, n * n, n * n))
    d = np.diag(var.reshape(-1))
    ncov[0, 0] = d
    ncov[1, 1] = d * 2.0
    ncov[2, 2] = d * 2.0
    return scov + torch.as_tensor(ncov, device=dev)


def tpcov_from_ivar(n, ivar_stamp, theory_fn, beam_fn,
                    geom_stamp: Geometry, device=None):
    """Temperature-only (1, 1, n^2, n^2) pixel covariance from ivar +
    theory/beam (reference ``pixcov.py:208``), float64 on ``device``."""
    dev = resolve(device)
    var = _var_from_ivar(ivar_stamp)
    modlmap = geom_stamp.modlmap_np()
    cmb2d = np.zeros((1, 1, n, n))
    cmb2d[0, 0] = theory_fn("TT", modlmap)
    tcov = stamp_pixcov_from_theory(
        geom_stamp, torch.as_tensor(cmb2d, device=dev), n2d_IQU=0.0,
        beam2d=np.asarray(beam_fn(modlmap), np.float64))
    ncov = np.diag(var.reshape(-1))[None, None]
    return tcov + torch.as_tensor(ncov, device=dev)


def cinv_inpaint(imap, geom: Geometry, mask=None, lpower_total=None,
                 geometry=None, generator=None, add_noise=True, noise=None,
                 device=None):
    """Inpaint a small map by constrained Gaussian fill (reference
    ``pixcov.py:361``): either pass a precomputed ``geometry`` dict
    (covsqrt/meanmul/m1/m2) or a boolean hole ``mask`` + total 1D power
    ``lpower_total`` from which the geometry is built (float64). The
    fluctuation is drawn from ``generator`` or given as ``noise``."""
    imap = _t(imap, device)
    if geometry is None:
        if mask is None or lpower_total is None:
            raise ValueError("need geometry, or mask + lpower_total")
        mask = np.asarray(mask, bool).reshape(-1)
        m1 = np.where(mask)[0]
        m2 = np.where(~mask)[0]
        p2d = np.interp(geom.modlmap_np(),
                        np.arange(len(lpower_total)), lpower_total)
        pcov = ps2d_to_mat(torch.as_tensor(p2d, device=imap.device), geom)
        covsqrt, meanmul = make_geometry(pcov, m1, m2, ncomp=1)
        geometry = dict(covsqrt=covsqrt, meanmul=meanmul, m1=m1, m2=m2)
    if not add_noise:
        generator = noise = None
    return inpaint_stamp(imap, _t(geometry["covsqrt"], imap.device),
                         _t(geometry["meanmul"], imap.device),
                         geometry["m1"], geometry["m2"],
                         generator=generator, noise=noise)


def preload_geometries(fnames, device=None):
    """Load many saved inpainting geometries into one dict keyed by
    index (reference ``pixcov.py:586``)."""
    return {i: load_geometries(f, device) for i, f in enumerate(fnames)}
