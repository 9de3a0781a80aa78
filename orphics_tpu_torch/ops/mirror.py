"""Fourier-plane mirror ``Zm(k) = Z(-k)`` in the doubly-permuted layout
(kernel B7; counterpart of ``orphics_tpu/ops/pallas_fft.py:mirror_pp``).

For CUDA tensors :func:`mirror_pp` launches ``csrc/mirror.cu``, one
static gather through :func:`_mirror_tables`' ``mrow`` on both axes; for
CPU tensors it runs the plain version :func:`mirror_pp_ref`, two
``index_select``. Both are bit-exact copies.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _build
from ..utils.profiling import spanned
from .dft import row_perm

__all__ = ["mirror_pp", "mirror_pp_ref"]


@functools.lru_cache(maxsize=8)
def _mirror_tables(n):
    """``mrow``, the first of ``pallas_fft._mirror_tables``: ``mrow[p]``
    is the permuted slot of the frequency ``-k(p)``. (The TPU's second
    table, an anti-identity for its in-register reversal, has no use
    here.)"""
    perm, inv = row_perm(n)
    return inv[(n - perm) % n].astype(np.int32)


@functools.lru_cache(maxsize=8)
def _mrow(n, device, dtype):
    return torch.as_tensor(_mirror_tables(n), dtype=dtype, device=device)


def mirror_pp_ref(zr, zi):
    """Plain version: both axes gathered through ``mrow``."""
    m = _mrow(zr.shape[-1], zr.device, torch.long)
    return (zr.index_select(-2, m).index_select(-1, m),
            zi.index_select(-2, m).index_select(-1, m))


@spanned("orphics.transforms.mirror_pp")
def mirror_pp(zr, zi):
    """``(Zm_re, Zm_im)`` with ``Zm(k) = Z(-k)``, both in the
    doubly-permuted layout of ``fft2pp``. ``zr, zi``: ``(batch, n, n)``
    float32, ``n = 128 * B``, ``B >= 2``."""
    if zr.dtype != torch.float32 or zi.dtype != torch.float32:
        raise ValueError("mirror_pp takes float32 planes")
    if zr.ndim != 3 or zr.shape != zi.shape or zr.shape[-1] != zr.shape[-2]:
        raise ValueError(f"mirror_pp takes two (batch, n, n) planes, got "
                         f"{tuple(zr.shape)}, {tuple(zi.shape)}")
    n = zr.shape[-1]
    if n % 128 or n < 256:
        raise ValueError(f"n={n} must be 128*B with B >= 2")
    if zr.device != zi.device:
        raise ValueError("zr and zi must share one device")
    if zr.is_cuda:
        if not (zr.is_contiguous() and zi.is_contiguous()):
            raise ValueError("mirror_pp needs contiguous tensors")
        orr = torch.empty_like(zr)
        oi = torch.empty_like(zi)
        lib = _build.library()
        err = lib.mirror_launch(
            zr.data_ptr(), zi.data_ptr(),
            _mrow(n, zr.device, torch.int32).data_ptr(), orr.data_ptr(),
            oi.data_ptr(), zr.shape[0], n,
            torch.cuda.current_stream(zr.device).cuda_stream)
        _build.check(err, "mirror_pp")
        mirror_pp.launches += 1
        return orr, oi
    if zr.device.type == "cpu":
        return mirror_pp_ref(zr, zi)
    raise ValueError(f"mirror_pp: unsupported device {zr.device}")


mirror_pp.launches = 0
