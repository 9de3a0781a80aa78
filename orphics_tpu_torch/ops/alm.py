"""Spherical-harmonic coefficient utilities (port of ``orphics_tpu.ops.alm``).

Index arithmetic on the healpy alm packing ``idx = m (2 lmax + 1 - m) / 2
+ l`` (reference ``orphics/maps.py:2961``): ``almxfl``, ``alm2cl``,
``getlmax``, ``change_alm_lmax`` and ``synalm``. Functions that take tensors
run on their device; ``synalm`` draws with a ``torch.Generator`` and has a
``synalm_from_noise`` twin that takes the two standard-normal vectors, so
tests can feed both packages the same draws.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .._device import resolve

__all__ = ["nalm", "getlmax", "lm_indices", "almxfl", "alm2cl",
           "change_alm_lmax", "synalm", "synalm_from_noise"]


def nalm(lmax: int) -> int:
    return (lmax + 1) * (lmax + 2) // 2


def getlmax(size: int) -> int:
    """Invert nalm (healpy ``Alm.getlmax``)."""
    lmax = int((np.sqrt(1 + 8 * size) - 3) // 2)
    if size <= 0 or nalm(lmax) != size:
        raise ValueError(f"size {size} is not a valid alm length")
    return lmax


@lru_cache(maxsize=32)
def lm_indices(lmax: int):
    """(ells, ems) int32 numpy arrays for each healpix-packed alm index."""
    ls = np.concatenate([np.arange(m, lmax + 1) for m in range(lmax + 1)])
    ms = np.concatenate([np.full(lmax + 1 - m, m) for m in range(lmax + 1)])
    return ls.astype(np.int32), ms.astype(np.int32)


@lru_cache(maxsize=32)
def _ls_tensor(lmax: int, device: str):
    """The ell of each packed index, int64 on ``device`` (cached: a host
    copy per call would stall the stream)."""
    return torch.as_tensor(lm_indices(lmax)[0].astype(np.int64),
                           device=device)


@lru_cache(maxsize=32)
def _m0_tensor(lmax: int, device: str):
    """True at the m = 0 packed indices, on ``device`` (cached)."""
    return torch.as_tensor(lm_indices(lmax)[1] == 0, device=device)


def almxfl(alm, fl):
    """Multiply alm ``(..., nalm)`` by a per-ell function (healpy
    ``almxfl``); ``fl`` shorter than lmax + 1 is zero-padded."""
    lmax = getlmax(alm.shape[-1])
    fl = torch.as_tensor(fl, device=alm.device)
    fl = fl.to(alm.real.dtype if alm.is_complex() else alm.dtype)
    if fl.shape[0] < lmax + 1:
        fl = torch.nn.functional.pad(fl, (0, lmax + 1 - fl.shape[0]))
    return alm * fl[_ls_tensor(lmax, str(alm.device))]


def alm2cl(alm1, alm2=None):
    """Cross power spectrum of two alm arrays ``(..., nalm)`` (healpy
    ``alm2cl``): the sum over m of ``Re(a1 conj(a2))``, m > 0 twice, over
    ``2l + 1``."""
    alm2 = alm1 if alm2 is None else alm2
    lmax = getlmax(alm1.shape[-1])
    prod = (alm1 * alm2.conj()).real
    dev = str(prod.device)
    w = torch.where(_m0_tensor(lmax, dev), 1.0, 2.0).to(prod.dtype)
    flat = (prod * w).reshape(-1, prod.shape[-1])
    sums = torch.zeros((flat.shape[0], lmax + 1), dtype=prod.dtype,
                       device=prod.device)
    sums.index_add_(1, _ls_tensor(lmax, dev), flat)
    ell = torch.arange(lmax + 1, dtype=prod.dtype, device=prod.device)
    return (sums / (2.0 * ell + 1.0)).reshape(prod.shape[:-1] + (lmax + 1,))


def change_alm_lmax(alm, lmax_new: int):
    """Truncate or zero-pad alms to a new lmax (reference
    ``orphics/maps.py:2961``), on ``alm``'s device."""
    lmax_old = getlmax(alm.shape[-1])
    out = torch.zeros(alm.shape[:-1] + (nalm(lmax_new),), dtype=alm.dtype,
                      device=alm.device)
    lmin = min(lmax_old, lmax_new)
    for m in range(lmin + 1):
        old0 = m * (2 * lmax_old + 1 - m) // 2 + m   # index of (l=m, m)
        new0 = m * (2 * lmax_new + 1 - m) // 2 + m
        n = lmin + 1 - m
        out[..., new0: new0 + n] = alm[..., old0: old0 + n]
    return out


def synalm_from_noise(re, im, cl, lmax: int = None):
    """Gaussian alm from standard normals ``re, im`` ``(..., nalm)``: m = 0
    modes ``re sqrt(C_l)`` (real), m > 0 ``(re + i im) sqrt(C_l / 2)``.
    Complex of ``re``'s precision."""
    cl = torch.as_tensor(cl, dtype=re.dtype, device=re.device)
    lmax = cl.shape[0] - 1 if lmax is None else lmax
    if cl.shape[0] < lmax + 1:
        cl = torch.nn.functional.pad(cl, (0, lmax + 1 - cl.shape[0]))
    dev = str(re.device)
    sig = torch.sqrt(torch.clamp(cl, min=0.0))[_ls_tensor(lmax, dev)]
    m0 = _m0_tensor(lmax, dev)
    half = sig * (2.0 ** -0.5)
    return torch.complex(torch.where(m0, re * sig, re * half),
                         torch.where(m0, torch.zeros_like(im), im * half))


def synalm(generator: torch.Generator, cl, lmax: int = None, batch=(),
           dtype=torch.complex64, device=None):
    """Gaussian alm realization(s) of a spectrum (healpy ``synalm``), shape
    ``batch + (nalm,)``, drawn with ``generator`` on ``device`` (the card
    unless it names another)."""
    cl = np.asarray(cl.cpu() if torch.is_tensor(cl) else cl)
    lmax = cl.shape[0] - 1 if lmax is None else lmax
    rdt = torch.empty((), dtype=dtype).real.dtype
    shape = tuple(batch) + (nalm(lmax),)
    device = resolve(device)
    re = torch.randn(shape, generator=generator, dtype=rdt, device=device)
    im = torch.randn(shape, generator=generator, dtype=rdt, device=device)
    return synalm_from_noise(re, im, cl, lmax)
