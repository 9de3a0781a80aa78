"""2D Fourier calculus on flat-sky geometries (port of
``orphics_tpu.ops.fourier``).

Normalizations, as in the JAX package:

  * ``norm='raw'``   : plain ``torch.fft.fft2`` / ``ifft2``;
  * ``norm='ortho'`` : unitary, raw scaled by ``npix**-0.5`` (fft) and
                       ``npix**+0.5`` (ifft);
  * ``norm='phys'``  : ortho additionally scaled by ``pixsize**±0.5``.

Everything broadcasts over leading batch dimensions and runs on the
device of its input (cuFFT on the card, in full fp32).
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve
from ..geometry import Geometry, arcmin
from .interp import interp

__all__ = ["fft2", "ifft2", "rfft2", "irfft2", "mask_kspace", "kfilter",
           "gauss_beam", "interp1d_to_2d"]


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


def fft2(x, geom: Geometry, norm: str = "raw"):
    """Forward 2D FFT over the trailing two axes."""
    k = torch.fft.fft2(x, dim=(-2, -1))
    fac = _norm_factor(geom, norm, inverse=False)
    return k if fac == 1.0 else k * fac


def ifft2(k, geom: Geometry, norm: str = "raw"):
    """Inverse 2D FFT over the trailing two axes ('raw' is numpy's
    default inverse, which divides by npix)."""
    x = torch.fft.ifft2(k, dim=(-2, -1))
    fac = _norm_factor(geom, norm, inverse=True)
    return x if fac == 1.0 else x * fac


def rfft2(x, geom: Geometry, norm: str = "raw"):
    k = torch.fft.rfft2(x, dim=(-2, -1))
    fac = _norm_factor(geom, norm, inverse=False)
    return k if fac == 1.0 else k * fac


def irfft2(k, geom: Geometry, norm: str = "raw"):
    """Inverse of :func:`rfft2`; ``s=geom.shape`` keeps odd-nx grids right."""
    x = torch.fft.irfft2(k, s=geom.shape, dim=(-2, -1))
    fac = _norm_factor(geom, norm, inverse=True)
    return x if fac == 1.0 else x * fac


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


def gauss_beam(ell, fwhm_arcmin):
    """Gaussian beam transfer function b(l); numpy or tensor ``ell``."""
    tht_fwhm = fwhm_arcmin * arcmin
    arg = -(tht_fwhm ** 2.0) * (ell ** 2.0) / (16.0 * np.log(2.0))
    return torch.exp(arg) if isinstance(ell, torch.Tensor) else np.exp(arg)


def interp1d_to_2d(ells, cls, geom: Geometry = None, modlmap=None,
                   fill_value=0.0, dtype=torch.float32, device=None):
    """Evaluate a 1D ell function on the 2D |l| grid by linear
    interpolation, in the dtype of ``modlmap``."""
    if modlmap is None:
        modlmap = geom.modlmap(dtype, resolve(device))
    return interp(modlmap, ells, cls, left=fill_value, right=fill_value)
