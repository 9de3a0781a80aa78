"""2D Fourier calculus on flat-sky geometries (port of
``orphics_tpu.ops.fourier``).

Normalizations, as in the JAX package:

  * ``norm='raw'``   : plain ``torch.fft.fft2`` / ``ifft2``;
  * ``norm='ortho'`` : unitary, raw scaled by ``npix**-0.5`` (fft) and
                       ``npix**+0.5`` (ifft);
  * ``norm='phys'``  : ortho additionally scaled by ``pixsize**±0.5``.

Power spectra: ``f2power(k1, k2) = Re(conj(k1) k2) area / npix**2`` with
*raw* ffts.

Everything broadcasts over leading batch dimensions and runs on the
device of its input (cuFFT on the card, in full fp32).
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve
from ..geometry import Geometry, arcmin
from ..utils.profiling import spanned
from .interp import interp

__all__ = ["fft2", "ifft2", "rfft2", "irfft2", "queb_rotmat", "iqu2teb",
           "teb2iqu", "f2power", "power2d", "mask_kspace", "kfilter",
           "filter_map", "gauss_beam", "gauss_beam_real", "interp1d_to_2d"]


def _norm_factor(geom: Geometry, norm: str, inverse: bool):
    n = geom.npix
    if norm == "raw":
        return 1.0
    if norm == "ortho":
        return n ** 0.5 if inverse else n ** -0.5
    if norm == "phys":
        if inverse:
            return (n ** 0.5) / (geom.pixsize ** 0.5)
        return (n ** -0.5) * (geom.pixsize ** 0.5)
    raise ValueError(f"unknown norm {norm!r}")


@spanned("orphics.transforms.fft2")
def fft2(x, geom: Geometry, norm: str = "raw"):
    """Forward 2D FFT over the trailing two axes."""
    k = torch.fft.fft2(x, dim=(-2, -1))
    fac = _norm_factor(geom, norm, inverse=False)
    return k if fac == 1.0 else k * fac


@spanned("orphics.transforms.ifft2")
def ifft2(k, geom: Geometry, norm: str = "raw"):
    """Inverse 2D FFT over the trailing two axes ('raw' is numpy's
    default inverse, which divides by npix)."""
    x = torch.fft.ifft2(k, dim=(-2, -1))
    fac = _norm_factor(geom, norm, inverse=True)
    return x if fac == 1.0 else x * fac


@spanned("orphics.transforms.rfft2")
def rfft2(x, geom: Geometry, norm: str = "raw"):
    k = torch.fft.rfft2(x, dim=(-2, -1))
    fac = _norm_factor(geom, norm, inverse=False)
    return k if fac == 1.0 else k * fac


@spanned("orphics.transforms.irfft2")
def irfft2(k, geom: Geometry, norm: str = "raw"):
    """Inverse of :func:`rfft2`; ``s=geom.shape`` keeps odd-nx grids right."""
    x = torch.fft.irfft2(k, s=geom.shape, dim=(-2, -1))
    fac = _norm_factor(geom, norm, inverse=True)
    return x if fac == 1.0 else x * fac


def queb_rotmat(geom: Geometry, inverse: bool = False, iau: bool = False,
                spin: int = 2, dtype=torch.float32, device=None):
    """(2, 2, ny, nx) Fourier-plane rotation matrix between (Q, U) and
    (E, B). Healpix convention by default; IAU flips the angle sign."""
    lmap = geom.lmap(dtype, device)
    sgn = -1.0 if iau else 1.0
    a = sgn * spin * torch.atan2(-lmap[1], lmap[0])
    c, s = torch.cos(a), torch.sin(a)
    if inverse:
        s = -s
    return torch.stack([torch.stack([c, -s]), torch.stack([s, c])])


def _rotate_last_two(kmaps, rot):
    """Apply ``rot`` to the last two components of ``(..., ncomp, ny, nx)``
    k-maps (a (2, ny, nx) Q/U stack has no T slot)."""
    a, b = kmaps[..., -2, :, :], kmaps[..., -1, :, :]
    out = torch.stack([rot[0, 0] * a + rot[0, 1] * b,
                       rot[1, 0] * a + rot[1, 1] * b], dim=-3)
    return torch.cat([kmaps[..., :-2, :, :], out], dim=-3)


def _rot_for(kmaps, geom, inverse, iau):
    dtype = torch.float64 if kmaps.dtype in (torch.complex128,
                                             torch.float64) else torch.float32
    return queb_rotmat(geom, inverse=inverse, iau=iau, dtype=dtype,
                       device=kmaps.device)


def iqu2teb(kmaps, geom: Geometry, iau: bool = False):
    """Rotate raw-FFT'd (I, Q, U) k-maps, ``(..., 3, ny, nx)`` complex,
    into (T, E, B)."""
    return _rotate_last_two(kmaps, _rot_for(kmaps, geom, False, iau))


def teb2iqu(kmaps, geom: Geometry, iau: bool = False):
    """Inverse rotation: (T, E, B) k-maps -> (I, Q, U) k-maps."""
    return _rotate_last_two(kmaps, _rot_for(kmaps, geom, True, iau))


def f2power(kmap1, kmap2, geom: Geometry, pixel_units: bool = False):
    """2D cross power of two *raw* FFT k-maps:
    ``Re(conj(k1) k2) * area / npix^2``."""
    norm = 1.0 if pixel_units else geom.area / geom.npix ** 2
    return (kmap1.conj() * kmap2).real * norm


def power2d(map1, map2=None, geom: Geometry = None, iau: bool = False,
            kmap1=None, kmap2=None, rot: bool = True):
    """2D (cross-)power of maps; with several components, the full
    ``(ncomp, ncomp)`` matrix in TEB. Returns ``(p2d, kmap1, kmap2)``, the
    k-maps raw FFTs with the last two components rotated Q/U -> E/B for any
    ncomp > 1; pass ``rot=False`` for stacks that are not polarization."""
    def to_k(m):
        k = fft2(m, geom, "raw")
        if rot and m.ndim >= 3 and m.shape[-3] >= 2:
            k = iqu2teb(k, geom, iau=iau)
        return k

    if kmap1 is None:
        kmap1 = to_k(map1)
    if kmap2 is None:
        kmap2 = to_k(map2) if map2 is not None else kmap1
    if kmap1.ndim >= 3 and kmap1.shape[-3] > 1:
        p2d = f2power(kmap1[..., :, None, :, :], kmap2[..., None, :, :, :],
                      geom)
    else:
        p2d = f2power(kmap1, kmap2, geom)
    return p2d, kmap1, kmap2


def mask_kspace(geom: Geometry, lxcut=None, lycut=None, lmin=None, lmax=None,
                dtype=torch.float32, device=None):
    """Binary Fourier-space mask: zero ``modlmap <= lmin`` and
    ``>= lmax`` (strict keep), and ``|lx| < lxcut``, ``|ly| < lycut``."""
    device = resolve(device)
    ly, lx = geom.laxes(dtype, device)
    mask = torch.ones(geom.shape, dtype=dtype, device=device)
    if lmin is not None or lmax is not None:
        modlmap = geom.modlmap(dtype, device)
        if lmin is not None:
            mask = mask * (modlmap > lmin)
        if lmax is not None:
            mask = mask * (modlmap < lmax)
    if lxcut is not None:
        mask = mask * (lx.abs()[None, :] >= lxcut)
    if lycut is not None:
        mask = mask * (ly.abs()[:, None] >= lycut)
    return mask


def kfilter(x, kfilt, geom: Geometry):
    """Apply a 2D Fourier filter to a real map: ``ifft(filt * fft(x)).real``."""
    k = fft2(x, geom, "raw")
    return ifft2(k * kfilt, geom, "raw").real


filter_map = kfilter


def gauss_beam(ell, fwhm_arcmin):
    """Gaussian beam transfer function b(l); numpy or tensor ``ell``."""
    tht_fwhm = fwhm_arcmin * arcmin
    arg = -(tht_fwhm ** 2.0) * (ell ** 2.0) / (16.0 * np.log(2.0))
    return torch.exp(arg) if isinstance(ell, torch.Tensor) else np.exp(arg)


def gauss_beam_real(rs, fwhm_arcmin):
    """Real-space Gaussian beam profile, normalized to unit integral;
    numpy or tensor ``rs``."""
    sigma = fwhm_arcmin * arcmin / np.sqrt(8.0 * np.log(2.0))
    arg = -0.5 * rs ** 2 / sigma ** 2
    ex = torch.exp(arg) if isinstance(rs, torch.Tensor) else np.exp(arg)
    return ex / (2 * np.pi * sigma ** 2)


def interp1d_to_2d(ells, cls, geom: Geometry = None, modlmap=None,
                   fill_value=0.0, dtype=torch.float32, device=None):
    """Evaluate a 1D ell function on the 2D |l| grid by linear
    interpolation, in the dtype of ``modlmap``."""
    if modlmap is None:
        modlmap = geom.modlmap(dtype, resolve(device))
    return interp(modlmap, ells, cls, left=fill_value, right=fill_value)
