"""The least work of the spherical-harmonic transforms, counted from the
geometry and the functions, never from the kernels that implement it.

Legendre step: a folded transform at ``lmax`` on ``ntheta``
Gauss-Legendre rings runs the recurrence of ``lambda_lm`` over (northern
ring, m, l) steps; a step is live from the first l at which
``|lambda_lm(theta)|`` reaches the plain reference's underflow threshold
(``reference.curved.TAU``, found by its own scaled recurrence) to
``lmax``. Below it every value is zero to the reference, so an exact
transform needs no more. Per live step: the recurrence's two multiply-adds
and a multiply (5 fp64 operations), and per map the contraction of a
complex value with a real one, two multiply-adds (4 operations, counted at
the fp32 rate, which is also the rate of the fp64 tensor cores). Bytes:
the input and the output of every map once, and one float64 seed per (m,
northern ring) and the rings' cosines.

Ring transforms: one real transform of ``nphi`` points a ring and map,
half the ``5 n log2 n`` operations of a complex one; bytes the float32
ring and its ``lmax + 1`` complex64 coefficients, each once.
"""
from __future__ import annotations

import functools

from . import work as W
from .reference.curved import gl_rule, live_starts

__all__ = ["live_steps", "legendre_work", "ring_fft_work"]


@functools.lru_cache(maxsize=4)
def _live_steps(lmax, ntheta, device):
    x, _ = gl_rule(ntheta)
    starts = live_starts(lmax, x[:ntheta // 2], device)
    return float((lmax + 1 - starts).sum().item())


def live_steps(lmax: int, ntheta: int, device="cpu"):
    """The live (northern ring, m, l) steps of one folded transform."""
    return _live_steps(int(lmax), int(ntheta), str(device))


def legendre_work(lmax: int, ntheta: int, ana_maps: int, syn_maps: int,
                  device="cpu"):
    """``{"legendre_ana": (bytes, fp32, fp64 operations), "legendre_syn":
    ...}`` of one analysis of ``ana_maps`` and one synthesis of
    ``syn_maps`` maps."""
    steps = live_steps(lmax, ntheta, device)
    M1 = lmax + 1
    nalm = M1 * (M1 + 1) // 2
    rings = 8.0 * ntheta * M1            # a map's ring coefficients
    tables = 8.0 * M1 * (ntheta // 2) + 8.0 * (ntheta // 2)

    def work(maps):
        return (maps * (rings + 8.0 * nalm) + tables, 4.0 * maps * steps,
                5.0 * steps)

    return {"legendre_ana": work(ana_maps), "legendre_syn": work(syn_maps)}


def ring_fft_work(lmax: int, ntheta: int, nphi: int, maps: int):
    """``(bytes, fp32 operations)`` of the ring transforms of ``maps``
    maps, forward and inverse alike."""
    count = maps * ntheta
    return (count * (4.0 * nphi + 8.0 * (lmax + 1)),
            W.fft_flops(nphi, 0.5 * count))
