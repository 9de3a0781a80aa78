"""Plain flat-sky references: the grid, annular binning, GRF bandpowers and
windowed cross spectra, in float64 PyTorch (or the control's lower
precision), written from the definitions and not from the program.

Conventions of the configurations: ``l = 2 pi fftfreq(n, d)`` on each
axis; a map's power is ``|fft2(m)|^2 area / npix^2``; a GRF of spectrum
``C`` has Fourier modes ``sqrt(C(|l|) npix / area) sqrt(npix) eta`` with
``eta`` complex unit normal, and its two real maps are the real and
imaginary parts of ``ifft2`` of one such plane; bins follow
``np.digitize(|l|, edges, right=True)`` and a bin's value is the mean over
every mode of the plane that falls in it.
"""
from __future__ import annotations

import numpy as np
import torch

from . import streams

__all__ = ["Prec", "Grid", "Binner", "cosine_taper", "sim_bandpowers",
           "cross_bandpowers"]

ARCMIN = np.pi / (180.0 * 60.0)


class Prec:
    """The precision a reference computes in: ``"float64"`` (the reference)
    or ``"bfloat16"`` (the control: float32 arithmetic with every stage's
    result rounded to bfloat16, the nearest precision below the
    configurations' float32)."""

    def __init__(self, name: str = "float64"):
        if name not in ("float64", "bfloat16"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.real = torch.float64 if name == "float64" else torch.float32
        self.complex = (torch.complex128 if name == "float64"
                        else torch.complex64)

    def q(self, t):
        """``t`` in this precision (rounded through bfloat16 for the
        control)."""
        if t.is_complex():
            t = t.to(self.complex)
            if self.name == "bfloat16":
                t = torch.complex(self.q(t.real), self.q(t.imag))
            return t
        t = t.to(self.real)
        if self.name == "bfloat16":
            t = t.to(torch.bfloat16).to(self.real)
        return t

    def fft2(self, x):
        return self.q(torch.fft.fft2(self.q(x)))

    def ifft2(self, x):
        return self.q(torch.fft.ifft2(self.q(x)))


class Grid:
    """A square ``n x n`` patch of ``px_arcmin`` pixels."""

    def __init__(self, n: int, px_arcmin: float):
        self.n = n
        self.d = px_arcmin * ARCMIN
        self.npix = n * n
        self.area = self.npix * self.d * self.d
        l1 = 2.0 * np.pi * np.fft.fftfreq(n, d=self.d)
        self.ly = np.broadcast_to(l1[:, None], (n, n))
        self.lx = np.broadcast_to(l1[None, :], (n, n))
        self.ml = np.hypot(self.ly, self.lx)
        self.nyquist = np.pi / self.d

    def interp(self, table):
        """A per-integer-ell table on ``|l|``, linear, zero outside."""
        table = np.asarray(table, np.float64)
        return np.interp(self.ml, np.arange(len(table), dtype=np.float64),
                         table, left=0.0, right=0.0)


class Binner:
    """Means over the modes of each bin ``edges[i] < |l| <= edges[i+1]``
    (float64 sums)."""

    def __init__(self, ml, edges, device):
        edges = np.asarray(edges, np.float64)
        dig = np.digitize(np.asarray(ml).ravel(), edges, right=True)
        self.nbins = len(edges) - 1
        keep = (dig >= 1) & (dig <= self.nbins)
        self.kept = int(keep.sum())
        self.idx = torch.as_tensor(np.where(keep, dig - 1, self.nbins),
                                   device=device)
        counts = np.bincount(dig[keep] - 1, minlength=self.nbins)
        self.inv = torch.as_tensor(1.0 / np.maximum(counts, 1),
                                   device=device)

    def mean(self, planes):
        """``(B, nbins)`` float64 bin means of real ``(B, n, n)`` planes."""
        x = planes.reshape(planes.shape[0], -1).to(torch.float64)
        out = torch.zeros((x.shape[0], self.nbins + 1), dtype=torch.float64,
                          device=x.device)
        out.index_add_(1, self.idx, x)
        return out[:, :self.nbins] * self.inv


def cosine_taper(n: int, taper_percent: float, pad_percent: float):
    """The separable cosine edge taper of a square patch: ``pad`` zero
    pixels at each edge, then ``apod`` pixels rising as ``(1 - cos)/2``
    (float64 numpy)."""
    apod = int(taper_percent * n / 100.0)
    pad = int(pad_percent * n / 100.0)
    i = np.arange(n, dtype=np.float64)
    w = np.ones(n)
    if apod > 0:
        lo = i <= apod + pad
        w[lo] = 0.5 * (1 - np.cos(-np.pi * (i[lo] - pad) / apod))
        hi = i >= (n - 1) - apod - pad
        w[hi] = 0.5 * (1 - np.cos(-np.pi * ((n - 1) - i[hi] - pad) / apod))
    if pad:
        w[:pad] = 0.0
        w[n - pad:] = 0.0
    return w[:, None] * w[None, :]


def grf_scale(grid: Grid, cl_table):
    """``sqrt(C(|l|) npix / area) sqrt(npix)``: the Fourier amplitude of a
    GRF of spectrum ``C`` per unit complex normal (float64 numpy)."""
    cl = np.maximum(grid.interp(cl_table), 0.0)
    return np.sqrt(cl * grid.npix / grid.area) * np.sqrt(grid.npix)


def sim_bandpowers(words, pairs, grid: Grid, cl_table, binner: Binner,
                   prec: Prec, device):
    """Bandpowers of the two real GRF maps of each pair in ``pairs``, drawn
    from the stream of ``words``: ``(len(pairs), 2, nbins)`` float64, the
    real part's map first."""
    scale = prec.q(torch.as_tensor(grf_scale(grid, cl_table), device=device))
    norm = grid.area / grid.npix ** 2
    out = []
    for p in pairs:
        eta = torch.as_tensor(streams.natural_plane(words, p, grid.n),
                              device=device)
        z = prec.ifft2(prec.q(scale * prec.q(eta)))
        maps = torch.stack([z.real, z.imag])
        f = prec.fft2(maps)
        power = prec.q(prec.q(f.real ** 2 + f.imag ** 2) * norm)
        out.append(binner.mean(power))
    return torch.stack(out)


def cross_bandpowers(m1, m2, taper, w2, grid: Grid, binner: Binner,
                     prec: Prec):
    """``(cross, auto1, auto2)`` binned spectra of tapered map pairs
    ``(B, n, n)``: ``Re(F1 conj F2)``, ``|F1|^2``, ``|F2|^2`` times ``area
    / npix^2``, each divided by ``w2``."""
    t = prec.q(taper)
    f1 = prec.fft2(prec.q(prec.q(m1) * t))
    f2 = prec.fft2(prec.q(prec.q(m2) * t))
    norm = grid.area / grid.npix ** 2 / w2
    cross = prec.q(f1.real * f2.real + f1.imag * f2.imag) * norm
    a1 = prec.q(f1.real ** 2 + f1.imag ** 2) * norm
    a2 = prec.q(f2.real ** 2 + f2.imag ** 2) * norm
    return (binner.mean(prec.q(cross)), binner.mean(prec.q(a1)),
            binner.mean(prec.q(a2)))
