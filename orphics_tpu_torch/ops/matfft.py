"""DFTs by the A*B split's plan (port of ``orphics_tpu.ops.matfft``).

The JAX module evaluates the DFT as two dense einsums and a twiddle on
the TPU's matrix unit, a device trick; on the card ``torch.fft`` (cuFFT)
computes the same transform, so the port keeps the functions, their
normalization (raw forward, 1/n inverse) and their ~1.5e-5 relative
contract, and ``good_size`` keeps the JAX plan rule exactly.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

__all__ = ["matfft2", "matifft2", "matfft_axis", "good_size"]


def _split(n):
    """Pick A*B = n with A, B as close as possible (A >= B)."""
    a = int(np.sqrt(n))
    while a >= 2:
        if n % a == 0:
            return max(n // a, a), min(n // a, a)
        a -= 1
    return None


@lru_cache(maxsize=64)
def _plan(n):
    """The JAX module's (A, B) split of ``n``, or None where it falls back
    to a library FFT."""
    sp = _split(n)
    if sp is None or sp[1] < 2:
        return None
    return sp


def good_size(n: int) -> bool:
    """True where the JAX module factors ``n`` as A*B (A, B >= 2)."""
    return _plan(n) is not None


def matfft_axis(x, axis: int = -1, inverse: bool = False):
    """DFT along one axis (complex out; the inverse carries 1/n)."""
    f = torch.fft.ifft if inverse else torch.fft.fft
    return f(x, dim=axis)


def matfft2(x):
    """2D forward DFT over the trailing two axes (raw normalization),
    complex64."""
    return torch.fft.fft2(x.to(torch.complex64))


def matifft2(x):
    """2D inverse DFT over the trailing two axes (numpy ifft norm),
    complex64."""
    return torch.fft.ifft2(x.to(torch.complex64))
