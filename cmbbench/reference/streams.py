"""The white-noise stream the port's card kernels draw, written out in numpy.

Frozen here so that the references can regenerate, from the seed words a
step was given, the very normals the program drew on the card. This is the
stream's definition, not the program's code:

* element ``e`` of a flat ``(batch, plane)`` output takes the counter pair
  ``q = e // 2``: Philox-4x32-10 of the counter ``(low word of q, high word
  of q, 0, 0)`` keyed by the two 32-bit seed words; its words ``x, y`` give
  the real parts of elements ``2q, 2q + 1`` and ``z, w`` their imaginary
  parts;
* a word becomes a normal by its low 23 bits: ``u = (bits + 0.5) / 2**23``,
  ``eta = sqrt(2) erfinv(2u - 1)``;
* the planes are stored in the doubly-permuted order of the transforms:
  position ``p = 128 (k mod B) + k // B`` holds frequency ``k`` along each
  axis of an ``n = 128 B`` grid.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["philox4x32", "normals", "row_perm", "natural_plane"]

_M32 = np.uint64(0xFFFFFFFF)
_MUL0 = np.uint64(0xD2511F53)
_MUL1 = np.uint64(0xCD9E8D57)
_KEY0 = 0x9E3779B9
_KEY1 = 0xBB67AE85


def philox4x32(q, key0: int, key1: int):
    """The four 32-bit words (uint64 arrays) of Philox-4x32-10 at the
    counters ``(q low, q high, 0, 0)``, ``q`` a uint64 array."""
    q = np.asarray(q, dtype=np.uint64)
    c0 = q & _M32
    c1 = q >> np.uint64(32)
    c2 = np.zeros_like(q)
    c3 = np.zeros_like(q)
    for r in range(10):
        kx = np.uint64((key0 + r * _KEY0) & 0xFFFFFFFF)
        ky = np.uint64((key1 + r * _KEY1) & 0xFFFFFFFF)
        p0 = _MUL0 * c0
        p1 = _MUL1 * c2
        c0, c1, c2, c3 = ((p1 >> np.uint64(32)) ^ c1 ^ kx, p1 & _M32,
                          (p0 >> np.uint64(32)) ^ c3 ^ ky, p0 & _M32)
    return c0, c1, c2, c3


def _normal(bits):
    u = ((bits & np.uint64(0x7FFFFF)).astype(np.float64) + 0.5) / 2.0 ** 23
    x = torch.from_numpy(2.0 * u - 1.0)
    return (np.sqrt(2.0) * torch.erfinv(x)).numpy()


def normals(words, e0: int, count: int):
    """``(re, im)`` float64 normals of the flat elements ``e0 .. e0 + count
    - 1`` of the stream keyed by the two int32 seed ``words``."""
    if e0 % 2 or count % 2:
        raise ValueError("draw whole counter pairs: even e0 and count")
    k0, k1 = (int(w) & 0xFFFFFFFF for w in words)
    q = np.arange(e0 // 2, (e0 + count) // 2, dtype=np.uint64)
    x, y, z, w = philox4x32(q, k0, k1)
    re = np.empty(count)
    im = np.empty(count)
    re[0::2], re[1::2] = _normal(x), _normal(y)
    im[0::2], im[1::2] = _normal(z), _normal(w)
    return re, im


def row_perm(n: int):
    """``(perm, inv)`` of the doubly-permuted order: ``permuted =
    natural[perm]`` and ``natural = permuted[inv]``."""
    b = n // 128
    if b * 128 != n or b < 2:
        raise ValueError(f"n = {n} is not 128 B with B >= 2")
    k = np.arange(n)
    inv = 128 * (k % b) + k // b
    return np.argsort(inv), inv


def natural_plane(words, index: int, n: int):
    """Plane ``index`` of the ``(batch, n, n)`` stream as a complex128
    ``(n, n)`` array in natural frequency order."""
    re, im = normals(words, index * n * n, n * n)
    _, inv = row_perm(n)
    z = (re + 1j * im).reshape(n, n)
    return z[inv][:, inv]
