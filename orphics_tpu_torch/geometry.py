"""Flat-sky map geometry as pure data (PyTorch port of ``orphics_tpu.geometry``).

A :class:`Geometry` is a small immutable record of integers and floats.
Derived Fourier grids are built on request, on the device the caller
names; the host-float64 ``*_np`` twins stay in numpy for the binners and
other host-side precomputes.

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

    def lmax(self) -> float:
        """Largest |l| representable on the grid (corner of the l-plane)."""
        return math.hypot(math.pi / abs(self.dy), math.pi / abs(self.dx))

    def ellmax_safe(self) -> float:
        """Nyquist along the more coarsely sampled axis."""
        return math.pi / max(abs(self.dy), abs(self.dx))

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

    # ----- Fourier-plane grids on a device --------------------------
    def laxes(self, dtype=torch.float32, device=None):
        """1D angular wavenumbers along y and x: ``2*pi*fftfreq``."""
        ly, lx = self.laxes_np()
        return (torch.as_tensor(ly, dtype=dtype, device=device),
                torch.as_tensor(lx, dtype=dtype, device=device))

    def rlaxes(self, dtype=torch.float32, device=None):
        """Wavenumbers for the rfft half-plane: full ly, half lx."""
        ly = 2 * np.pi * np.fft.fftfreq(self.ny, d=self.dy)
        lx = 2 * np.pi * np.fft.rfftfreq(self.nx, d=self.dx)
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
