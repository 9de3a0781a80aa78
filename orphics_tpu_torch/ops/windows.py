"""Apodization windows and tapers (port of ``orphics_tpu.ops.windows``;
reference ``orphics/maps.py:1873-1920``).

Pure functions of static shapes, computed in numpy as the JAX package
does and returned as float32 tensors on ``device`` (the card unless it
names another).
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve

__all__ = ["cosine_window", "get_taper", "get_taper_deg",
           "sigma_from_fwhm", "fwhm_from_sigma"]


def _cosine_window_np(ny, nx, len_apod_y, len_apod_x, pad_y, pad_x):
    win = np.ones((ny, nx))
    ii = np.arange(nx)[None, :] * np.ones((ny, 1))
    jj = np.arange(ny)[:, None] * np.ones((1, nx))
    if len_apod_x > 0:
        r = ii - pad_x
        sel = ii <= (len_apod_x + pad_x)
        win[sel] = 0.5 * (1 - np.cos(-np.pi * r[sel] / len_apod_x))
        r = (nx - 1) - ii - pad_x
        sel = ii >= ((nx - 1) - len_apod_x - pad_x)
        win[sel] = 0.5 * (1 - np.cos(-np.pi * r[sel] / len_apod_x))
    if len_apod_y > 0:
        r = jj - pad_y
        sel = jj <= (len_apod_y + pad_y)
        win[sel] *= 0.5 * (1 - np.cos(-np.pi * r[sel] / len_apod_y))
        r = (ny - 1) - jj - pad_y
        sel = jj >= ((ny - 1) - len_apod_y - pad_y)
        win[sel] *= 0.5 * (1 - np.cos(-np.pi * r[sel] / len_apod_y))
    if pad_y:
        win[:pad_y, :] = 0
        win[ny - pad_y:, :] = 0
    if pad_x:
        win[:, :pad_x] = 0
        win[:, nx - pad_x:] = 0
    return win.astype(np.float32)


def cosine_window(ny, nx, len_apod_y=30, len_apod_x=30, pad_y=0, pad_x=0,
                  device=None):
    """Separable cosine-squared edge taper (reference ``maps.py:1891``,
    after a routine by Thibaut Louis), ``(ny, nx)`` float32."""
    return torch.as_tensor(_cosine_window_np(ny, nx, len_apod_y, len_apod_x,
                                             pad_y, pad_x),
                           device=resolve(device))


def _with_w2(taper, weight, device):
    """``(taper, w2)``: the taper times ``weight`` on ``device`` and the
    mean of its float32 square, summed in float64 and rounded to float32
    (the JAX package sums in float32, in XLA's order: a few ulp apart)."""
    taper = torch.as_tensor(taper)
    if weight is not None:
        taper = taper * torch.as_tensor(weight, dtype=torch.float32)
    w2 = float(np.float32(np.mean(np.square(taper.numpy()),
                                  dtype=np.float64)))
    return taper.to(resolve(device)), w2


def get_taper(geom, taper_percent=12.0, pad_percent=3.0, weight=None,
              device=None):
    """Percent-of-patch cosine taper; returns ``(taper, w2)`` (reference
    ``maps.py:1873``)."""
    ny, nx = geom.shape
    n = int(min(ny, nx))
    apod = int(taper_percent * n / 100.0)
    pad = int(pad_percent * n / 100.0)
    return _with_w2(_cosine_window_np(ny, nx, apod, apod, pad, pad), weight,
                    device)


def get_taper_deg(geom, taper_width_degrees=1.0, pad_width_degrees=0.0,
                  weight=None, only_y=False, device=None):
    """Degree-width cosine taper; returns ``(taper, w2)`` (reference
    ``maps.py:1880``)."""
    ny, nx = geom.shape
    res = min(abs(geom.dy), abs(geom.dx))
    pix_apod = int(taper_width_degrees * np.pi / 180.0 / res)
    pix_pad = int(pad_width_degrees * np.pi / 180.0 / res)
    return _with_w2(_cosine_window_np(ny, nx, pix_apod,
                                      0 if only_y else pix_apod, pix_pad,
                                      0 if only_y else pix_pad),
                    weight, device)


def sigma_from_fwhm(fwhm):
    return fwhm / (2.0 * np.sqrt(2.0 * np.log(2.0)))


def fwhm_from_sigma(sigma):
    return sigma * 2.0 * np.sqrt(2.0 * np.log(2.0))
