"""Radial binning of 2D spectra (port of ``orphics_tpu.ops.binning``).

Each Fourier pixel's bin is a pure function of the geometry and the bin
edges, so it is computed once on the host in float64
(``np.digitize(..., right=True)``, segments 0 and ``nbins+1`` dropped).
The per-map reduction is :func:`~orphics_tpu_torch.ops.bin_reduce.bin_reduce`
for every tensor: it picks the kernel or its plain version by the
tensor's device (the JAX package picks by ``ORPHICS_TPU_BIN``/backend).
"""
from __future__ import annotations

import numpy as np
import torch

from .bin_reduce import bin_reduce

__all__ = ["Bin2D", "RfftBin2D"]


class Bin2D:
    """Annular binner over a fixed 2D modulus map (``modlmap`` for
    spectra). ``bin_edges`` follow ``np.digitize(..., right=True)``:
    ``edges[i-1] < v <= edges[i]`` falls in bin ``i-1``; values outside
    the edges are dropped. Tables live on ``device``."""

    def __init__(self, modmap, bin_edges, device=None):
        modmap = np.asarray(modmap, dtype=np.float64)
        bin_edges = np.asarray(bin_edges, dtype=np.float64)
        self.bin_edges = bin_edges
        self.centers = (bin_edges[1:] + bin_edges[:-1]) / 2.0
        self.cents = self.centers
        self.nbins = len(bin_edges) - 1
        self._nseg = self.nbins + 2
        dig = np.digitize(modmap.reshape(-1), bin_edges, right=True)
        self.counts = np.bincount(dig, minlength=self._nseg)[1:-1]
        self.shape = modmap.shape
        self._ids = torch.as_tensor(dig.astype(np.int32), device=device)
        safe = np.where(self.counts == 0, 1, self.counts)
        self._inv_counts = torch.as_tensor(
            (1.0 / safe * (self.counts > 0)).astype(np.float32), device=device)

    def sum(self, data2d):
        """Per-bin sums of ``data2d`` (leading batch dims OK)."""
        lead = data2d.shape[:-2]
        flat = data2d.reshape(-1, data2d.shape[-2] * data2d.shape[-1])
        out = bin_reduce(flat.contiguous(), self._ids, self._nseg)
        return out.reshape(lead + (self._nseg,))[..., 1:-1]

    def bin(self, data2d, weights=None):
        """``(centers, means)`` of a 2D (or batch of 2D) array."""
        if weights is None:
            return self.centers, self.sum(data2d) * self._inv_counts
        w = torch.as_tensor(weights, dtype=data2d.dtype,
                            device=data2d.device).expand(data2d.shape[-2:])
        num = self.sum(data2d * w)
        den = self.sum(w.expand(data2d.shape))
        return self.centers, num / den

    def bin_err(self, data2d):
        """``(centers, means, scatter-in-bin error)``."""
        cents, means = self.bin(data2d)
        sq = self.sum(data2d * data2d) * self._inv_counts
        counts = torch.as_tensor(np.maximum(self.counts, 2), dtype=means.dtype,
                                 device=means.device)
        var = (sq - means ** 2) * counts / (counts - 1.0)
        err = torch.sqrt(torch.clamp(var, min=0.0) / counts)
        return cents, means, err


class RfftBin2D:
    """Radial binner over the rfft half-plane that reproduces full-plane
    binning exactly for Hermitian-symmetric data: half-plane sums carry
    multiplicity weight 2 except on the self-conjugate columns (lx=0 and
    the even-nx Nyquist column), and the divisor is the full-plane count.
    """

    def __init__(self, geom, bin_edges, device=None):
        full = geom.modlmap_np()
        half = full[:, :geom.nx // 2 + 1]
        bin_edges = np.asarray(bin_edges, dtype=np.float64)
        self.bin_edges = bin_edges
        self.centers = (bin_edges[1:] + bin_edges[:-1]) / 2.0
        self.cents = self.centers
        self.nbins = len(bin_edges) - 1
        self._nseg = self.nbins + 2
        digf = np.digitize(full.reshape(-1), bin_edges, right=True)
        self.counts = np.bincount(digf, minlength=self._nseg)[1:-1]
        dig = np.digitize(half.reshape(-1), bin_edges, right=True)
        self._ids = torch.as_tensor(dig.astype(np.int32), device=device)
        w = np.full(half.shape, 2.0, dtype=np.float32)
        w[:, 0] = 1.0
        if geom.nx % 2 == 0:
            w[:, -1] = 1.0
        self._w = torch.as_tensor(w.reshape(-1), device=device)
        safe = np.where(self.counts == 0, 1, self.counts)
        self._inv_counts = torch.as_tensor(
            (1.0 / safe * (self.counts > 0)).astype(np.float32), device=device)

    def bin(self, data2d_half):
        """``(centers, full-plane-equivalent bin means)`` from half-plane
        data ``(..., ny, nx//2+1)``."""
        lead = data2d_half.shape[:-2]
        flat = data2d_half.reshape(-1, data2d_half.shape[-2]
                                   * data2d_half.shape[-1])
        out = bin_reduce(flat.contiguous(), self._ids, self._nseg,
                         weights=self._w)
        sums = out.reshape(lead + (self._nseg,))[..., 1:-1]
        return self.centers, sums * self._inv_counts
