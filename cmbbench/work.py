"""The roofline arithmetic: published peaks of one NVIDIA H100 and the
least time a piece of work could take on it.

A piece of work is ``(bytes, fp32 operations, fp64 operations, 32-bit
integer operations)``: each input read once and each output written once,
``5 n log2 n`` operations a complex transform of length ``n``, the Philox
draw's integer instructions, counted from shapes and never from the
launches that implement them. Its least time is the larger of the bytes
over the memory rate and the operations over their pipes (:func:`ops_ms`).

Peaks (NVIDIA's H100 SXM data sheet, dense, at the full 700 W): HBM 3.35
TB/s, fp32 67 TFLOP/s and fp64 34 TFLOP/s outside the tensor cores;
32-bit integer instructions at 64 lanes per SM and clock beside the 128
fp32 lanes, and 128 lanes of instructions issued per SM and clock in all
(CUDA C++ Programming Guide, arithmetic instruction throughput, compute
capability 9.0), 132 SMs at the 1980 MHz boost clock. A card set below
700 W runs slower than these; every run prints its power limit beside the
shares.
"""
from __future__ import annotations

import math

import numpy as np

__all__ = ["HBM_BYTES_PER_S", "FP32_FLOP_PER_S", "FP64_FLOP_PER_S",
           "INT32_OP_PER_S", "INSTR_LANES_PER_S", "PHILOX_INT_OPS_PER_PAIR",
           "NORMAL_FP32_OPS", "ops_ms", "bound", "fft_flops", "fft2_flops",
           "live_sectors", "bin_bytes", "kept_modes"]

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
FP64_FLOP_PER_S = 34e12
INT32_OP_PER_S = 64 * 132 * 1.98e9
INSTR_LANES_PER_S = 128 * 132 * 1.98e9
# Philox-4x32-10 per counter pair: ten rounds of two 32 x 32 -> 64-bit
# multiplies (two integer instructions each) and two three-way xors, and
# four to form the counter
PHILOX_INT_OPS_PER_PAIR = 10 * (2 * 2 + 2) + 4
# fp32 operations per drawn normal: erfinv, the uniform, the scale
NORMAL_FP32_OPS = 25.0


def ops_ms(flops, flops64=0.0, intops=0.0):
    """Least ms for the operations: the pipes run side by side, so the
    longest pipe, or the issue of the fp32 and integer instructions
    together, whichever is longer."""
    t32 = flops / FP32_FLOP_PER_S
    return max(t32, flops64 / FP64_FLOP_PER_S, intops / INT32_OP_PER_S,
               t32 + intops / INSTR_LANES_PER_S) * 1e3


def bound(nbytes, flops=0.0, flops64=0.0, intops=0.0):
    """``(ms, "bytes" or "operations")``: the least time of the work."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_ms(flops, flops64, intops)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fft_flops(n, count):
    """Operations of ``count`` complex ``n``-point transforms."""
    return 5.0 * n * math.log2(n) * count


def fft2_flops(n, count):
    """Operations of ``count`` complex ``n x n`` 2D transforms."""
    return fft_flops(n * n, count)


def live_sectors(ids, nseg):
    """The 32-byte sectors (8 float32) of a row laid out as ``ids`` (a 1D
    integer array) that hold an id in ``[0, nseg)``."""
    ids = np.asarray(ids).ravel()
    kept = (ids >= 0) & (ids < nseg)
    kept = np.pad(kept, (0, (-kept.size) % 8))
    return int(kept.reshape(-1, 8).any(1).sum())


def bin_bytes(ids, nseg, planes, out_bytes):
    """Bytes a segment sum of ``planes`` float32 ``(B, N)`` planes over
    ``ids`` (int32) must move: where every id is kept each plane once, else
    the 32-byte sectors of each row that hold a kept id; the ids and the
    outputs once."""
    ids = np.asarray(ids).ravel()
    B, N, count = planes
    sectors = live_sectors(ids, nseg)
    data = 4 * B * N * count if sectors * 8 >= N else sectors * 32 * B * count
    return data + 4 * ids.size + out_bytes


def kept_modes(ml, edges, rows=None):
    """How many modes of the ``|l|`` plane ``ml`` fall in a bin
    (``edges[0] < |l| <= edges[-1]``), over the rows ``rows`` (a boolean
    mask of natural rows: the Hermitian half plane) or all of them."""
    ml = np.asarray(ml)
    if rows is not None:
        ml = ml[rows]
    return int(((ml > edges[0]) & (ml <= edges[-1])).sum())
