"""Euclidean distance transforms for mask growth and apodization (port of
``orphics_tpu.ops.distance``).

Jump flooding (Rong & Tan 2006), as in the JAX package: each pixel
carries the float32 coordinates of its nearest seed candidate, and rounds
of 8-neighbour propagation at strides 2^k, ..., 2, 1, plus one more
stride-1 round (1+JFA), refine it. Each round is eight ``torch.roll``
shifts with the edge rows and columns filled (or, with ``wrap``, the
candidates unwrapped to the nearest periodic image) and elementwise
selects. The sweep order and the float32 arithmetic are the JAX
function's, so both give the same distances to float32 rounding.

Functions that take a tensor follow its device; a host array goes to
``device`` (``None``: the card).
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import as_tensor

__all__ = ["distance_transform", "distance_from_mask_edge", "grow_mask",
           "cosine_apodize", "mask_srcs"]

_BIG = 1e30


def _steps(ny: int, nx: int):
    """The strides of the sweep: 2^ceil(log2 max(ny, nx)) down to 1, then
    1 again."""
    s = 1 << int(np.ceil(np.log2(max(ny, nx))))
    out = []
    while s >= 1:
        out.append(s)
        s //= 2
    return out + [1]


def distance_transform(seeds, dy: float = 1.0, dx: float = 1.0,
                       wrap: bool = False, device=None):
    """Distance (in units set by ``dy``/``dx``) from each pixel to the
    nearest True pixel of ``seeds`` (ny, nx), float32. ``wrap``: periodic
    boundaries (False: nothing enters from beyond an edge)."""
    seeds = as_tensor(seeds, device, torch.bool)
    ny, nx = seeds.shape
    dev = seeds.device
    iy = torch.arange(ny, dtype=torch.float32, device=dev)[:, None] \
        .expand(ny, nx)
    ix = torch.arange(nx, dtype=torch.float32, device=dev)[None, :] \
        .expand(ny, nx)
    big = torch.tensor(_BIG, dtype=torch.float32, device=dev)
    py = torch.where(seeds, iy, big)
    px = torch.where(seeds, ix, big)

    def dist2(py_, px_):
        dyy = (py_ - iy) * dy
        dxx = (px_ - ix) * dx
        return torch.where(py_ > 1e29, big, dyy * dyy + dxx * dxx)

    def shift(a, oy, ox):
        out = torch.roll(a, (oy, ox), dims=(0, 1))
        if not wrap:
            if oy > 0:
                out[:oy, :] = _BIG
            elif oy < 0:
                out[oy:, :] = _BIG
            if ox > 0:
                out[:, :ox] = _BIG
            elif ox < 0:
                out[:, ox:] = _BIG
        return out

    for s in _steps(ny, nx):
        best = dist2(py, px)
        for oy in (-s, 0, s):
            for ox in (-s, 0, s):
                if oy == 0 and ox == 0:
                    continue
                cy = shift(py, oy, ox)
                cx = shift(px, oy, ox)
                if wrap:
                    # unwrap the candidate to the nearest periodic image
                    cy = torch.where(cy > 1e29, cy,
                                     cy + torch.round((iy - cy) / ny) * ny)
                    cx = torch.where(cx > 1e29, cx,
                                     cx + torch.round((ix - cx) / nx) * nx)
                d = dist2(cy, cx)
                take = d < best
                py = torch.where(take, cy, py)
                px = torch.where(take, cx, px)
                best = torch.minimum(best, d)
    return torch.sqrt(dist2(py, px))


def distance_from_mask_edge(mask, dy=1.0, dx=1.0, device=None):
    """Distance of each inside (mask > 0) pixel from the masked region
    (mask == 0); 0 outside."""
    inside = as_tensor(mask, device, torch.float32) > 0
    d = distance_transform(~inside, dy, dx)
    return torch.where(inside, d, torch.zeros((), dtype=d.dtype,
                                              device=d.device))


def grow_mask(mask, geom, width_rad, device=None):
    """Grow the zero (masked) region of a binary mask by ``width_rad``
    (reference ``orphics/maps.py:1084``), float32."""
    m = as_tensor(mask, device, torch.float32)
    d = distance_transform(m <= 0, abs(geom.dy), abs(geom.dx))
    return (d > width_rad).to(torch.float32)


def cosine_apodize(bmask, geom, width_deg, device=None):
    """Cosine-taper a binary mask over ``width_deg`` from its edges
    (reference ``orphics/maps.py:1092``)."""
    width = width_deg * np.pi / 180.0
    m = as_tensor(bmask, device, torch.float32)
    r = distance_from_mask_edge(m, abs(geom.dy), abs(geom.dx))
    x = torch.clamp(r / width, 0.0, 1.0)
    return 0.5 * (1 - torch.cos(np.pi * x)) * (m > 0)


def mask_srcs(geom, srcs_pix, radius_rad, device=None):
    """Zero out circles of ``radius_rad`` around source pixel coordinates
    (N, 2) (reference ``orphics/maps.py:1057``); a tensor of coordinates
    sets the device."""
    pix = as_tensor(srcs_pix, device, torch.long)
    seeds = torch.zeros(geom.shape, dtype=torch.bool, device=pix.device)
    seeds[pix[:, 0], pix[:, 1]] = True
    d = distance_transform(seeds, abs(geom.dy), abs(geom.dx))
    return (d > radius_rad).to(torch.float32)
