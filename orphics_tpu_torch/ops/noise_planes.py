"""Scaled complex white noise planes (kernel B5n; counterpart of
``orphics_tpu/ops/pallas_fft.py:noise_planes``).

``noise_planes(scale, seed, batch)`` returns ``(batch,) + scale.shape``
re and im float32 planes of ``scale * eta``, eta standard normal. For a
CUDA ``scale`` it launches ``csrc/noise.cu``: Philox-4x32-10 keyed by the
two seed words, which the kernel reads from device memory, so the words
may be drawn on the card with no host round trip; element ``e`` of the
flat output takes pair ``e // 2`` of the stream, and a thread writes four
neighbouring elements of one plane. For a CPU ``scale`` it runs the plain version :func:`noise_planes_ref`: ``torch.randn`` from a
generator seeded by the words. The two are different streams with the
same law, as the JAX package's on-chip draw and its CPU fallback are.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..utils.profiling import spanned

__all__ = ["noise_planes", "noise_planes_ref", "seed_words"]


def seed_words(seed, device=None):
    """``(2,)`` int32 words from a scalar stream id (second word 0) or a
    word pair; a tensor stays on its device unless ``device`` is given.
    Words from a Python value reach a CUDA ``device`` as two fills, whose
    values travel as kernel arguments: a copy from pageable host memory
    would synchronize the stream, so that a step drawn from an integer seed
    could not queue its kernels ahead of the card."""
    if isinstance(seed, torch.Tensor):
        w = seed.to(device=device if device is not None else seed.device,
                    dtype=torch.int32)
    else:
        w = np.asarray(seed, dtype=np.int64).astype(np.int32)
        w = w.reshape(-1) if w.ndim <= 1 else w
        if w.shape == (1,):
            w = np.append(w, np.int32(0))
        if (w.shape == (2,) and device is not None
                and torch.device(device).type == "cuda"):
            out = torch.full((2,), int(w[0]), dtype=torch.int32,
                             device=device)
            out[1:].fill_(int(w[1]))
            return out
        w = torch.as_tensor(w, device=device)
    w = w.reshape(-1) if w.ndim <= 1 else w
    if tuple(w.shape) not in ((1,), (2,)):
        raise ValueError(f"seed must be a scalar or (2,) words; got shape "
                         f"{tuple(w.shape)}")
    if w.shape[0] == 1:
        w = torch.cat([w, torch.zeros_like(w)])
    return w.contiguous()


def _mix64(x: int) -> int:
    """splitmix64's finalizer: a bijection of 64-bit integers whose low 32
    bits depend on every input bit."""
    m = (1 << 64) - 1
    x = (x + 0x9E3779B97F4A7C15) & m
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & m
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & m
    return x ^ (x >> 31)


def noise_planes_ref(scale, seed, batch: int):
    """Plain version: two ``torch.randn`` planes from a generator on
    ``scale``'s device, times ``scale``. The generator's seed is the two
    words' 64 bits through :func:`_mix64`, since the CPU generator keeps
    only the low 32 bits of its seed. Reads the words on the host."""
    w0, w1 = (int(v) & 0xFFFFFFFF for v in seed_words(seed).tolist())
    gen = torch.Generator(device=scale.device)
    gen.manual_seed(_mix64((w0 << 32) | w1))
    shape = (batch,) + tuple(scale.shape)
    er = torch.randn(shape, generator=gen, dtype=torch.float32,
                     device=scale.device)
    ei = torch.randn(shape, generator=gen, dtype=torch.float32,
                     device=scale.device)
    return er * scale, ei * scale


@spanned("orphics.transforms.noise_planes")
def noise_planes(scale, seed, batch: int):
    """``(batch,) + scale.shape`` float32 re and im planes of
    ``scale * eta``, eta standard complex white noise (reproducible per
    seed). ``scale``: float32 plane in whatever layout the consumer uses
    (typically a doubly-permuted covsqrt). ``seed``: a scalar stream id
    or a ``(2,)`` int32 word pair (the full 64 bits seed the stream), a
    Python value or a tensor."""
    if scale.dtype != torch.float32 or scale.ndim != 2:
        raise ValueError("scale must be a 2D float32 plane")
    if batch < 1:
        raise ValueError("batch must be positive")
    if scale.is_cuda:
        words = seed_words(seed, scale.device)
        if not scale.is_contiguous():
            raise ValueError("noise_planes needs a contiguous scale")
        shape = (batch,) + tuple(scale.shape)
        ore = torch.empty(shape, dtype=torch.float32, device=scale.device)
        oim = torch.empty_like(ore)
        lib = _build.library()
        err = lib.noise_planes_launch(
            scale.data_ptr(), words.data_ptr(), ore.data_ptr(),
            oim.data_ptr(), batch, scale.numel(),
            torch.cuda.current_stream(scale.device).cuda_stream)
        _build.check(err, "noise_planes")
        noise_planes.launches += 1
        return ore, oim
    if scale.device.type == "cpu":
        return noise_planes_ref(scale, seed, batch)
    raise ValueError(f"noise_planes: unsupported device {scale.device}")


noise_planes.launches = 0
