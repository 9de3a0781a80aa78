"""Spline-interpolated map displacement (port of
``orphics_tpu.ops.pallas_lens``; kernel B8).

A map is held as periodic B-spline coefficients (the exact Fourier
prefilter :func:`spline_coeffs`) and evaluated at displaced positions.
:func:`lens_map_kernel` is the counterpart of ``lens_map_pallas``: the
displacement is clipped to ``[-maxdisp_px, maxdisp_px]`` pixels per axis
and the (order+1)^2 taps are summed. For a CUDA tensor it launches
``csrc/lens_spline.cu``: a ``TILE`` of outputs per block, weights in the
closed form of :func:`spline_weights`, taps from a shared-memory window
of the block's deflection range (blocks whose range exceeds
``WINDOW_RANGE`` pixels take their taps from device memory and are counted
by ``lens_map_kernel.wide_blocks``). For a CPU tensor it runs the plain
version :func:`lens_map_ref`. It takes any (ny, nx): :func:`blocks` and
:func:`supported` stay only for parity with the JAX package's API.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..geometry import Geometry
from ..utils.profiling import spanned
from . import fourier as F

__all__ = ["lens_map_kernel", "lens_map_ref", "spline_coeffs", "blocks",
           "supported", "spline_taps", "spline_weights", "TILE",
           "WINDOW_RANGE"]

_OFFS = {3: (-1, 0, 1, 2), 5: (-2, -1, 0, 1, 2, 3)}
# The B-spline's polynomial pieces on t in [0, 1): the weight of tap k is
# sum_i _SPLINE_POLY[order][k][i] t^i (csrc/lens_spline.cu: W3, W5)
_SPLINE_POLY = {
    3: np.array([[1, -3, 3, -1], [4, 0, -6, 3], [1, 3, 3, -3],
                 [0, 0, 0, 1]], np.float64) / 6.0,
    5: np.array([[1, -5, 10, -10, 5, -1], [26, -50, 20, 20, -20, 5],
                 [66, 0, -60, 0, 30, -10], [26, 50, 20, -20, -20, 10],
                 [1, 5, 10, 10, 5, -5], [0, 0, 0, 0, 0, 1]],
                np.float64) / 120.0}
# the kernel's output tile (rows, columns) per block, and the largest range
# of deflection floors per axis that a block's shared-memory window holds
# (csrc/lens_spline.cu: TY, TX, RMAX)
TILE = (64, 32)
WINDOW_RANGE = 16


def _bspline3_weights(t):
    """Cubic B-spline basis at taps floor+(-1,0,1,2) for fraction t."""
    w0 = (1.0 - t) ** 3 / 6.0
    w1 = 2.0 / 3.0 - t * t + 0.5 * t ** 3
    w2 = 2.0 / 3.0 - (1 - t) ** 2 + 0.5 * (1 - t) ** 3
    w3 = t ** 3 / 6.0
    return (w0, w1, w2, w3)


def _bspline5_weights(t):
    """Quintic B-spline basis at taps floor+(-2..3) for fraction t."""
    def b5(x):
        ax = x.abs()
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        r = torch.where(ax < 1, (33.0 - 30 * ax ** 2 + 15 * ax ** 4
                                 - 5 * ax ** 5) / 60.0, zero)
        r = torch.where((ax >= 1) & (ax < 2),
                        (51.0 + 75 * ax - 210 * ax ** 2 + 150 * ax ** 3
                         - 45 * ax ** 4 + 5 * ax ** 5) / 120.0, r)
        return torch.where((ax >= 2) & (ax < 3), (3.0 - ax) ** 5 / 120.0, r)
    return tuple(b5(t - m) for m in (-2, -1, 0, 1, 2, 3))


def spline_weights(t, order: int):
    """The ``order + 1`` B-spline weights at fraction ``t`` in ``[0, 1)``
    (taps ``floor + _OFFS[order]``) in closed form: each weight's
    polynomial piece by Horner, in ``t``'s dtype, as the kernel evaluates
    them (no absolute value, no branch). Equals ``_bspline3_weights`` /
    ``_bspline5_weights``."""
    poly = _SPLINE_POLY[order].astype(np.float32 if t.dtype == torch.float32
                                      else np.float64)
    out = []
    for row in poly:
        p = torch.full_like(t, float(row[-1]))
        for c in row[-2::-1]:
            p = p * t + float(c)
        out.append(p)
    return tuple(out)


def _bspline_freq_response(n, order):
    """Frequency response of the centered B-spline sampling kernel
    (float64 numpy)."""
    taps = {3: np.array([1.0, 4.0, 1.0]) / 6.0,
            5: np.array([1.0, 26.0, 66.0, 26.0, 1.0]) / 120.0}[order]
    w = 2 * np.pi * np.fft.fftfreq(n)
    half = (len(taps) - 1) // 2
    resp = np.full(n, taps[half])
    for j in range(1, half + 1):
        resp = resp + 2.0 * taps[half + j] * np.cos(j * w)
    return resp


def spline_coeffs(imap, geom: Geometry, order: int):
    """Periodic B-spline coefficients of ``imap`` via the exact Fourier
    prefilter (deconvolve the sampling-kernel response)."""
    ry = torch.as_tensor(_bspline_freq_response(geom.ny, order),
                         dtype=torch.float32, device=imap.device)
    rx = torch.as_tensor(_bspline_freq_response(geom.nx, order),
                         dtype=torch.float32, device=imap.device)
    k = F.fft2(imap, geom, "raw")
    return F.ifft2(k / (ry[:, None] * rx[None, :]), geom, "raw").real


def spline_taps(coeffs, yb, xb, ty, tx, order: int):
    """Sum the (order+1)^2 spline taps of ``coeffs`` (``(..., ny, nx)``)
    around integer base positions ``(yb, xb)`` with fractions ``(ty, tx)``.

    The shared-index gather formulation: the coefficient map is pre-rolled
    by every static stencil offset and all taps are gathered at one base
    index. ``yb, xb, ty, tx`` broadcast against ``coeffs`` minus any
    component axes between them (shape ``(ny, nx)`` or ``(B, 1, ny, nx)``).
    """
    ny, nx = coeffs.shape[-2:]
    offs = _OFFS[order]
    wfn = _bspline3_weights if order == 3 else _bspline5_weights
    wys = wfn(ty)
    wxs = wfn(tx)
    base = (torch.remainder(yb, ny) * nx + torch.remainder(xb, nx))
    shifted = torch.stack([torch.roll(coeffs, (-m, -n), dims=(-2, -1))
                           for m in offs for n in offs])
    sflat = shifted.reshape(shifted.shape[:-2] + (-1,))
    idx = base.reshape(base.shape[:-2] + (-1,)).expand(
        sflat.shape[1:-1] + (ny * nx,))
    vals = torch.take_along_dim(sflat, idx[None].expand(sflat.shape), dim=-1)
    vals = vals.reshape(shifted.shape)
    out = torch.zeros_like(coeffs)
    t = 0
    for mi in range(len(offs)):
        for ni in range(len(offs)):
            out = out + wys[mi] * wxs[ni] * vals[t]
            t += 1
    return out


def _as4(imap, alpha):
    if imap.ndim == 2:
        imap4 = imap[None, None]
    elif imap.ndim == 3:
        imap4 = imap[None]
    elif imap.ndim == 4:
        imap4 = imap
    else:
        raise ValueError(f"imap rank {imap.ndim} unsupported")
    alpha4 = alpha[None] if alpha.ndim == 3 else alpha
    if alpha4.ndim != 4 or alpha4.shape[1] != 2:
        raise ValueError(f"alpha must be (2, ny, nx) or (B, 2, ny, nx), got "
                         f"{tuple(alpha.shape)}")
    if alpha4.shape[0] != imap4.shape[0]:
        raise ValueError(f"alpha batch {alpha4.shape[0]} != imap batch "
                         f"{imap4.shape[0]}")
    if alpha4.shape[-2:] != imap4.shape[-2:]:
        raise ValueError("alpha and imap grids differ")
    return imap4, alpha4


def lens_map_ref(coeffs, alpha, geom: Geometry, order: int = 5,
                 maxdisp_px: int = 8):
    """Plain PyTorch version of the kernel: spline coefficients
    ``(B, C, ny, nx)``, deflection ``(B, 2, ny, nx)`` radians, the
    displacement clipped to ``[-D, D]`` pixels, taps by gather."""
    if order not in _OFFS:
        raise ValueError("order must be 3 or 5")
    D = float(maxdisp_px)
    py = torch.clamp(alpha[:, 0:1] / geom.dy, -D, D)
    px = torch.clamp(alpha[:, 1:2] / geom.dx, -D, D)
    fy = torch.floor(py)
    fx = torch.floor(px)
    iy = torch.arange(geom.ny, device=alpha.device)[:, None]
    ix = torch.arange(geom.nx, device=alpha.device)[None, :]
    yb = iy + fy.to(torch.long)
    xb = ix + fx.to(torch.long)
    return spline_taps(coeffs, yb, xb, py - fy, px - fx, order)


# per device: the count of blocks that took their taps from device memory
_WIDE = {}


def _wide_counter(device):
    if device not in _WIDE:
        _WIDE[device] = torch.zeros(1, dtype=torch.int64, device=device)
    return _WIDE[device]


def _wide_blocks(reset: bool = False) -> int:
    """Blocks of the kernel's launches (all devices, since the last reset)
    whose deflection range exceeded the shared-memory window, so that
    their taps came from device memory; ``reset`` sets the count to 0
    after reading it. Reading synchronizes with the device."""
    total = sum(int(t.item()) for t in _WIDE.values())
    if reset:
        for t in _WIDE.values():
            t.zero_()
    return total


def _launch(coeffs, alpha, geom, order, maxdisp_px):
    if not (coeffs.is_contiguous() and alpha.is_contiguous()):
        raise ValueError("lens_map_kernel needs contiguous tensors")
    B, C, ny, nx = coeffs.shape
    out = torch.empty_like(coeffs)
    lib = _build.library()
    stream = torch.cuda.current_stream(coeffs.device).cuda_stream
    err = lib.lens_spline_launch(coeffs.data_ptr(), alpha.data_ptr(),
                                 out.data_ptr(),
                                 _wide_counter(coeffs.device).data_ptr(),
                                 B, C, ny, nx, float(geom.dy),
                                 float(geom.dx), order, int(maxdisp_px),
                                 stream)
    _build.check(err, "lens_map_kernel")
    lens_map_kernel.launches += 1
    return out


@spanned("orphics.lens.lens_map_kernel")
def lens_map_kernel(imap, alpha, geom: Geometry, order: int = 5,
                    maxdisp_px: int = 8, prefiltered: bool = False):
    """Displace ``imap`` by the deflection ``alpha`` with periodic
    B-spline interpolation; the displacement is clipped to
    ``maxdisp_px`` pixels per axis.

    ``imap``: ``(ny, nx)``, ``(C, ny, nx)`` or ``(B, C, ny, nx)`` float32;
    ``alpha``: ``(2, ny, nx)`` or ``(B, 2, ny, nx)`` float32 radians
    (dy, dx), shared by the components. ``prefiltered``: ``imap`` already
    holds spline coefficients. Returns the shape of ``imap``.
    """
    if order not in _OFFS:
        raise ValueError("order must be 3 or 5")
    if imap.dtype != torch.float32 or alpha.dtype != torch.float32:
        raise ValueError("lens_map_kernel takes float32 maps and deflections")
    if imap.device != alpha.device:
        raise ValueError("imap and alpha must share one device")
    if tuple(imap.shape[-2:]) != geom.shape:
        raise ValueError(f"map shape {tuple(imap.shape[-2:])} != geometry "
                         f"{geom.shape}")
    coeffs = imap if prefiltered else spline_coeffs(imap, geom, order)
    coeffs4, alpha4 = _as4(coeffs, alpha)
    if coeffs4.is_cuda:
        out = _launch(coeffs4, alpha4, geom, order, maxdisp_px)
    elif coeffs4.device.type == "cpu":
        out = lens_map_ref(coeffs4, alpha4, geom, order, maxdisp_px)
    else:
        raise ValueError(f"lens_map_kernel: unsupported device {imap.device}")
    return out.reshape(imap.shape)


lens_map_kernel.launches = 0
lens_map_kernel.wide_blocks = _wide_blocks


def blocks(ny, nx):
    """The JAX kernel's (row, col) tiling for an (ny, nx) map, or None
    where it has none (API parity; the CUDA kernel takes any shape)."""
    if ny <= 64:
        bh = ny
    else:
        bh = next((b for b in range(64, 7, -8) if ny % b == 0), None)
    if nx <= 256:
        bw = nx
    else:
        bw = next((b for b in (256, 128) if nx % b == 0), None)
    return bh, bw


def supported(geom: Geometry) -> bool:
    """Always True: the CUDA kernel has no tiling constraint."""
    return True
