"""Weighted segment sums, the reduction under every radial binner
(kernels B1, B2 and B2').

``bin_reduce`` is the port of ``orphics_tpu/ops/pallas_kernels.py:bin_matmul``,
``bin2_reduce`` that of ``bin2_matmul`` and ``bin_pair_power`` that of
``bin_pair_power``, with the same contracts and no ``block`` or tail special
case. ``bin_reduce`` follows its data's dtype: float32 data (and weights)
give float32 sums, float64 data float64 sums (the kernel's float64
instance); the other two take float32:

    bin_reduce:  out[b, s] = sum_n data[b, n] * weights[n] * [ids[n] == s]
    bin2_reduce: the same without weights for two inputs over one id table
    bin_pair_power: ``bin2_reduce`` of the fields ``q = |Z|^2`` (or
        ``(|Z|^2 + |Zm|^2) / 2``) and ``c = Re(Z Zm)`` of a packed Fourier
        pair and its mirror, formed as the planes are read

Ids outside ``[0, nseg)`` are dropped, as the JAX one-hot drops them; a
caller that throws segments away passes -1 for them, and the kernel then
reads no data where a warp's ids are all dropped. For a CUDA tensor each
launches the hand-written kernel in ``csrc/bin_reduce.cu``: a block walks
a few batch rows over one id table, fp64 partials per warp in shared
memory, then fixed-order sums over warps and element spans, so the result
is deterministic with no atomics. Any segment count: segments beyond the
kernel's per-block cap are split into tiles (:func:`_seg_tiles`), each
reading the data once. For a CPU tensor each runs its plain version. There
is no fallback from one to the other.
"""
from __future__ import annotations

import torch

from .. import _build
from ..utils.profiling import spanned

__all__ = ["bin_reduce", "bin_reduce_ref", "bin2_reduce", "bin2_reduce_ref",
           "bin_pair_power", "bin_pair_power_ref"]


def bin_reduce_ref(data, ids, nseg: int, weights=None):
    """Plain PyTorch version: ``index_add_`` over the segment axis in
    float64, returned in the data's dtype; ids outside ``[0, nseg)`` are
    dropped (summed into a column that is cut off)."""
    x = data.to(torch.float64)
    if weights is not None:
        x = x * weights.to(torch.float64)
    idx = ids.to(torch.long)
    idx = torch.where((idx >= 0) & (idx < nseg), idx, nseg)
    out = torch.zeros((data.shape[0], nseg + 1), dtype=torch.float64,
                      device=data.device)
    out.index_add_(1, idx, x)
    return out[:, :nseg].to(data.dtype)


def bin2_reduce_ref(d1, d2, ids, nseg: int):
    """Plain version of :func:`bin2_reduce`: two :func:`bin_reduce_ref`."""
    return bin_reduce_ref(d1, ids, nseg), bin_reduce_ref(d2, ids, nseg)


def bin_pair_power_ref(zr, zi, zmr, zmi, ids, nseg: int, sym: bool = False):
    """Plain version of :func:`bin_pair_power`: the two fields in float32,
    as the kernel forms them, then :func:`bin2_reduce_ref`."""
    q = zr * zr + zi * zi
    if sym:
        q = 0.5 * (q + zmr * zmr + zmi * zmi)
    return bin2_reduce_ref(q, zr * zmr - zi * zmi, ids, nseg)


def _seg_tiles(nseg: int, cap: int):
    """``(tile, ntiles)``: the fewest tiles of at most ``cap`` segments, of
    equal size but the last; tile ``z`` covers
    ``[z * tile, min(nseg, (z + 1) * tile))``."""
    ntiles = -(-nseg // cap)
    return -(-nseg // ntiles), ntiles


def _check(data, ids, weights, nseg, what="data",
           dtypes=(torch.float32,)):
    if data.dtype not in dtypes or data.ndim != 2:
        names = " or ".join(str(d).replace("torch.", "") for d in dtypes)
        raise ValueError(f"{what} must be (B, N) {names}, got {data.dtype} "
                         f"{tuple(data.shape)}")
    n = data.shape[1]
    if ids.dtype != torch.int32 or tuple(ids.shape) != (n,):
        raise ValueError(f"ids must be ({n},) int32, got {ids.dtype} "
                         f"{tuple(ids.shape)}")
    if weights is not None and (weights.dtype != data.dtype
                                or tuple(weights.shape) != (n,)):
        raise ValueError(f"weights must be ({n},) {data.dtype}")
    for t in (data, ids) + (() if weights is None else (weights,)):
        if t.device != data.device:
            raise ValueError(f"{what}, ids and weights must share one device")
    if nseg < 1:
        raise ValueError("nseg must be positive")
    if data.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {data.device}")


def _launch(inputs, ids, nseg, weights, what, sym=False):
    if not all(t.is_contiguous() for t in inputs + (ids,)) or not (
            weights is None or weights.is_contiguous()):
        raise ValueError(f"{what} needs contiguous tensors")
    lib = _build.library()
    B, N = inputs[0].shape
    nd = min(len(inputs), 2)
    tile, ntiles = _seg_tiles(nseg, lib.bin_reduce_seg_cap())
    nspan = lib.bin_reduce_nspan(B, N, ntiles)
    dev = inputs[0].device
    scratch = torch.empty((nd, nspan, B, nseg), dtype=torch.float64,
                          device=dev)
    out = torch.empty((nd, B, nseg), dtype=inputs[0].dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if nd == 1:
        launch = (lib.bin_reduce64_launch if out.dtype == torch.float64
                  else lib.bin_reduce_launch)
        err = launch(
            inputs[0].data_ptr(), ids.data_ptr(),
            None if weights is None else weights.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), B, N, nseg, tile, ntiles,
            stream)
    elif len(inputs) == 4:
        err = lib.bin_pair_power_launch(
            *(t.data_ptr() for t in inputs), ids.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), B, N, nseg, tile, ntiles,
            int(sym), stream)
    else:
        err = lib.bin2_reduce_launch(
            inputs[0].data_ptr(), inputs[1].data_ptr(), ids.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), B, N, nseg, tile, ntiles,
            stream)
    _build.check(err, what)
    return out


@spanned("orphics.binning.bin_reduce")
def bin_reduce(data, ids, nseg: int, weights=None):
    """``(B, N)`` float32 or float64 data, ``(N,)`` int32 ids (those outside
    ``[0, nseg)`` dropped), optional ``(N,)`` weights of the data's dtype ->
    ``(B, nseg)`` sums of the data's dtype (B1). ``launches`` counts every
    kernel launch, ``launches_f64`` those of the float64 instance."""
    _check(data, ids, weights, nseg,
           dtypes=(torch.float32, torch.float64))
    if data.is_cuda:
        out = _launch((data,), ids, nseg, weights, "bin_reduce")[0]
        bin_reduce.launches += 1
        if data.dtype == torch.float64:
            bin_reduce.launches_f64 += 1
        return out
    return bin_reduce_ref(data, ids, nseg, weights)


@spanned("orphics.binning.bin2_reduce")
def bin2_reduce(d1, d2, ids, nseg: int):
    """``(bin(d1), bin(d2))``: two ``(B, N)`` float32 inputs over one
    ``(N,)`` int32 id table -> two ``(B, nseg)`` float32 sums (B2; the
    port of ``bin2_matmul``)."""
    _check(d1, ids, None, nseg, "d1")
    _check(d2, ids, None, nseg, "d2")
    if d1.shape != d2.shape:
        raise ValueError(f"d1 and d2 must match: {tuple(d1.shape)} vs "
                         f"{tuple(d2.shape)}")
    if d1.is_cuda:
        out = _launch((d1, d2), ids, nseg, None, "bin2_reduce")
        bin2_reduce.launches += 1
        return out[0], out[1]
    return bin2_reduce_ref(d1, d2, ids, nseg)


@spanned("orphics.binning.bin_pair_power")
def bin_pair_power(zr, zi, zmr, zmi, ids, nseg: int, sym: bool = False):
    """``(bin(q), bin(c))``, each ``(B, nseg)`` float32, for ``Z = F1 + i F2``
    the transform of two packed real maps and ``Zm(k) = Z(-k)`` its mirror,
    all four ``(B, N)`` float32 planes over one ``(N,)`` int32 id table (B2';
    the port of ``bin_pair_power``). ``q = |Z|^2``, or with ``sym`` the
    mirror-even ``(|Z|^2 + |Zm|^2) / 2``; ``c = Re(Z Zm)``. With mirror-
    symmetric bins ``bin|F1|^2 = (bq + bc) / 2`` and ``bin|F2|^2 =
    (bq - bc) / 2``."""
    planes = (zr, zi, zmr, zmi)
    for t, name in zip(planes, ("zr", "zi", "zmr", "zmi")):
        _check(t, ids, None, nseg, name)
        if t.shape != zr.shape:
            raise ValueError(f"{name} must match zr: {tuple(t.shape)} vs "
                             f"{tuple(zr.shape)}")
    if zr.is_cuda:
        out = _launch(planes, ids, nseg, None, "bin_pair_power", sym)
        bin_pair_power.launches += 1
        return out[0], out[1]
    return bin_pair_power_ref(zr, zi, zmr, zmi, ids, nseg, sym)


bin_reduce.launches = 0
bin_reduce.launches_f64 = 0
bin2_reduce.launches = 0
bin_pair_power.launches = 0
