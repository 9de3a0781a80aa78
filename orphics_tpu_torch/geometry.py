"""Flat-sky map geometry as pure data (PyTorch port of ``orphics_tpu.geometry``).

A :class:`Geometry` is a small immutable record of integers and floats.
Derived Fourier grids are built on request, on the device the caller
names (the card when it names none); the host-float64 ``*_np`` twins
stay in numpy for the binners and other host-side precomputes.

Conventions (same as the JAX package):
  * maps are ``(..., ny, nx)`` row-major, y = declination-like axis;
  * pixel sizes ``dy, dx`` are in radians;
  * wavenumbers ``ly, lx = 2*pi*fftfreq(n, d)``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ._device import resolve

arcmin = np.pi / (180.0 * 60.0)
degree = np.pi / 180.0

__all__ = ["Geometry", "rect_geometry", "arcmin", "degree"]


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Immutable flat-sky patch geometry: ``ny, nx`` pixels of extent
    ``dy, dx`` radians; ``y0`` is the patch-centre declination."""

    ny: int
    nx: int
    dy: float
    dx: float
    y0: float = 0.0

    @property
    def shape(self):
        return (self.ny, self.nx)

    @property
    def npix(self) -> int:
        return self.ny * self.nx

    @property
    def pixsize(self) -> float:
        """Pixel solid angle in steradians (flat approximation)."""
        return abs(self.dy * self.dx)

    @property
    def area(self) -> float:
        """Patch area in steradians (flat approximation)."""
        return self.npix * self.pixsize

    @property
    def extent(self):
        """(height, width) of the patch in radians."""
        return (self.ny * abs(self.dy), self.nx * abs(self.dx))

    def lmax(self) -> float:
        """Largest |l| representable on the grid (corner of the l-plane)."""
        return math.hypot(math.pi / abs(self.dy), math.pi / abs(self.dx))

    def ellmax_safe(self) -> float:
        """Nyquist along the more coarsely sampled axis."""
        return math.pi / max(abs(self.dy), abs(self.dx))

    def scaled(self, factor: int) -> "Geometry":
        """Geometry downgraded by an integer factor (pixel size grows)."""
        return Geometry(self.ny // factor, self.nx // factor,
                        self.dy * factor, self.dx * factor, self.y0)

    # ----- host-precision (numpy float64) grids ---------------------
    def laxes_np(self):
        ly = 2 * np.pi * np.fft.fftfreq(self.ny, d=self.dy)
        lx = 2 * np.pi * np.fft.fftfreq(self.nx, d=self.dx)
        return ly, lx

    def modlmap_np(self):
        """(ny, nx) |l| grid in numpy float64 (host; for binners)."""
        ly, lx = self.laxes_np()
        return np.hypot(ly[:, None], lx[None, :])

    def modlmap_r_np(self):
        """|l| on the rfft half-plane in numpy float64 (host)."""
        ly = 2 * np.pi * np.fft.fftfreq(self.ny, d=self.dy)
        lx = 2 * np.pi * np.fft.rfftfreq(self.nx, d=self.dx)
        return np.hypot(ly[:, None], lx[None, :])

    def yaxis_np(self):
        """Pixel-centre y offsets from the patch centre (radians)."""
        return (np.arange(self.ny) - (self.ny - 1) / 2.0) * self.dy

    def xaxis_np(self):
        """Pixel-centre x offsets from the patch centre (radians)."""
        return (np.arange(self.nx) - (self.nx - 1) / 2.0) * self.dx

    def modrmap_np(self):
        """(ny, nx) radius grid in numpy float64 (host; for binners)."""
        return np.hypot(self.yaxis_np()[:, None], self.xaxis_np()[None, :])

    # ----- real-space grids on a device -----------------------------
    def yaxis(self, dtype=torch.float32, device=None):
        return torch.as_tensor(self.yaxis_np(), dtype=dtype,
                               device=resolve(device))

    def xaxis(self, dtype=torch.float32, device=None):
        return torch.as_tensor(self.xaxis_np(), dtype=dtype,
                               device=resolve(device))

    def posmap(self, dtype=torch.float32, device=None):
        """(2, ny, nx) tensor of (dec, ra) sky offsets from patch centre."""
        y = self.yaxis(dtype, device) + self.y0
        x = self.xaxis(dtype, device)
        return torch.stack([y[:, None].expand(self.shape),
                            x[None, :].expand(self.shape)])

    def modrmap(self, dtype=torch.float32, device=None):
        """(ny, nx) angular distance from patch centre."""
        y = self.yaxis(dtype, device)
        x = self.xaxis(dtype, device)
        return torch.sqrt(y[:, None] ** 2 + x[None, :] ** 2)

    def pixmap(self, dtype=torch.float32, device=None):
        """(2, ny, nx) pixel coordinate grids."""
        device = resolve(device)
        iy = torch.arange(self.ny, dtype=dtype, device=device)
        ix = torch.arange(self.nx, dtype=dtype, device=device)
        return torch.stack([iy[:, None].expand(self.shape),
                            ix[None, :].expand(self.shape)])

    def sky2pix(self, coords):
        """Map (dec, ra) offsets (radians, tensor ``(2, ...)``) to
        fractional pixels; the result follows ``coords``."""
        py = (coords[0] - self.y0) / self.dy + (self.ny - 1) / 2.0
        px = coords[1] / self.dx + (self.nx - 1) / 2.0
        return torch.stack([py, px])

    def pix2sky(self, pix):
        """Inverse of :meth:`sky2pix`."""
        y = (pix[0] - (self.ny - 1) / 2.0) * self.dy + self.y0
        x = (pix[1] - (self.nx - 1) / 2.0) * self.dx
        return torch.stack([y, x])

    def pixsizemap(self, dtype=torch.float32, device=None):
        """(ny, nx) per-pixel solid angle with the CAR cos(dec) factor
        (reference ``orphics/maps.py:1228-1238``)."""
        psize = abs(self.dy * self.dx) * np.cos(self.yaxis_np() + self.y0)
        col = torch.as_tensor(psize, dtype=dtype, device=resolve(device))
        return col[:, None].expand(self.ny, self.nx)

    # ----- Fourier-plane grids on a device --------------------------
    def laxes(self, dtype=torch.float32, device=None):
        """1D angular wavenumbers along y and x: ``2*pi*fftfreq``."""
        ly, lx = self.laxes_np()
        device = resolve(device)
        return (torch.as_tensor(ly, dtype=dtype, device=device),
                torch.as_tensor(lx, dtype=dtype, device=device))

    def rlaxes(self, dtype=torch.float32, device=None):
        """Wavenumbers for the rfft half-plane: full ly, half lx."""
        ly = 2 * np.pi * np.fft.fftfreq(self.ny, d=self.dy)
        lx = 2 * np.pi * np.fft.rfftfreq(self.nx, d=self.dx)
        device = resolve(device)
        return (torch.as_tensor(ly, dtype=dtype, device=device),
                torch.as_tensor(lx, dtype=dtype, device=device))

    def lmap(self, dtype=torch.float32, device=None):
        """(2, ny, nx) tensor of (ly, lx) per Fourier pixel."""
        ly, lx = self.laxes(dtype, device)
        return torch.stack([ly[:, None].expand(self.shape),
                            lx[None, :].expand(self.shape)])

    def modlmap(self, dtype=torch.float32, device=None):
        """(ny, nx) |l| per Fourier pixel, computed in ``dtype``."""
        ly, lx = self.laxes(dtype, device)
        return torch.sqrt(ly[:, None] ** 2 + lx[None, :] ** 2)

    def modlmap_r(self, dtype=torch.float32, device=None):
        """|l| on the rfft half-plane, shape (ny, nx//2+1)."""
        ly, lx = self.rlaxes(dtype, device)
        return torch.sqrt(ly[:, None] ** 2 + lx[None, :] ** 2)


def rect_geometry(width_deg=None, px_res_arcmin=0.5, height_deg=None,
                  width_arcmin=None, height_arcmin=None,
                  y0_deg=0.0) -> Geometry:
    """Rectangular patch of the given width/height with square pixels of
    ``px_res_arcmin`` (``orphics_tpu.geometry.rect_geometry``)."""
    if width_deg is not None:
        width_arcmin = width_deg * 60.0
    if height_deg is not None:
        height_arcmin = height_deg * 60.0
    if width_arcmin is None:
        raise ValueError("specify width_deg or width_arcmin")
    if height_arcmin is None:
        height_arcmin = width_arcmin
    nx = int(round(width_arcmin / px_res_arcmin))
    ny = int(round(height_arcmin / px_res_arcmin))
    d = px_res_arcmin * arcmin
    return Geometry(ny=ny, nx=nx, dy=d, dx=d, y0=y0_deg * degree)
