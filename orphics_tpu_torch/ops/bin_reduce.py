"""Weighted segment sum, the reduction under every radial binner (kernel B1).

``bin_reduce`` is the port of ``orphics_tpu/ops/pallas_kernels.py:bin_matmul``
with the same contract and no ``block`` or tail special case:

    out[b, s] = sum_n data[b, n] * weights[n] * [ids[n] == s]

For a CUDA tensor it launches the hand-written kernel in
``csrc/bin_reduce.cu`` (shared-memory fp64 partials per chunk, then a
fixed-order sum over chunks: deterministic, no atomics). For a CPU tensor
it runs the plain version :func:`bin_reduce_ref`. There is no fallback
from one to the other.
"""
from __future__ import annotations

import torch

from .. import _build

__all__ = ["bin_reduce", "bin_reduce_ref"]


def bin_reduce_ref(data, ids, nseg: int, weights=None):
    """Plain PyTorch version: ``index_add_`` over the segment axis in
    float64, returned as float32."""
    x = data.to(torch.float64)
    if weights is not None:
        x = x * weights.to(torch.float64)
    out = torch.zeros((data.shape[0], nseg), dtype=torch.float64,
                      device=data.device)
    out.index_add_(1, ids.to(torch.long), x)
    return out.to(torch.float32)


def _check(data, ids, weights, nseg):
    if data.dtype != torch.float32 or data.ndim != 2:
        raise ValueError(f"data must be (B, N) float32, got {data.dtype} "
                         f"{tuple(data.shape)}")
    n = data.shape[1]
    if ids.dtype != torch.int32 or tuple(ids.shape) != (n,):
        raise ValueError(f"ids must be ({n},) int32, got {ids.dtype} "
                         f"{tuple(ids.shape)}")
    if weights is not None and (weights.dtype != torch.float32
                                or tuple(weights.shape) != (n,)):
        raise ValueError(f"weights must be ({n},) float32")
    for t in (data, ids) + (() if weights is None else (weights,)):
        if t.device != data.device:
            raise ValueError("data, ids and weights must share one device")
    if nseg < 1:
        raise ValueError("nseg must be positive")


def _launch(data, ids, nseg, weights):
    lib = _build.library()
    if nseg > lib.bin_reduce_max_nseg():
        raise ValueError(f"nseg={nseg} exceeds the shared memory of one block "
                         f"(max {lib.bin_reduce_max_nseg()})")
    if not (data.is_contiguous() and ids.is_contiguous()
            and (weights is None or weights.is_contiguous())):
        raise ValueError("bin_reduce needs contiguous tensors")
    B, N = data.shape
    chunk = lib.bin_reduce_chunk()
    nchunks = -(-N // chunk)
    scratch = torch.empty((nchunks, B, nseg), dtype=torch.float64,
                          device=data.device)
    out = torch.empty((B, nseg), dtype=torch.float32, device=data.device)
    stream = torch.cuda.current_stream(data.device).cuda_stream
    err = lib.bin_reduce_launch(
        data.data_ptr(), ids.data_ptr(),
        None if weights is None else weights.data_ptr(),
        scratch.data_ptr(), out.data_ptr(), B, N, nseg, stream)
    _build.check(err, "bin_reduce")
    bin_reduce.launches += 1
    return out


def bin_reduce(data, ids, nseg: int, weights=None):
    """``(B, N)`` float32 data, ``(N,)`` int32 ids in ``[0, nseg)``,
    optional ``(N,)`` float32 weights -> ``(B, nseg)`` float32 sums."""
    _check(data, ids, weights, nseg)
    if data.is_cuda:
        return _launch(data, ids, nseg, weights)
    if data.device.type == "cpu":
        return bin_reduce_ref(data, ids, nseg, weights)
    raise ValueError(f"bin_reduce: unsupported device {data.device}")


bin_reduce.launches = 0
