"""Binned power spectra of GRF sims and of given maps on the fused
full-plane kernels (port of ``orphics_tpu.models.fastcl``).

:class:`FastCl` keeps the Fourier plane in the doubly-permuted layout end
to end and packs two real maps per complex transform:

  * synthesis: B5 ``dft.rowifft_noise_y`` draws the white noise inside the
    inverse row DFT, with the covsqrt multiply on its load; the column
    pass is skipped, since ``colfft(colifft(Y')) == Y'``;
  * analysis: B6 ``rowpower.rowqc_pp`` (row DFT, mirror, Hermitian split
    and power in one half-plane pass, which also writes the rows
    ``[0, 128)`` of the transform that hold the two boundary rows), B2
    ``bin2_reduce`` of the two half-plane fields, and B1 ``bin_reduce`` of
    the two boundary rows (ky = 0 and n/2), whose mirror lies within the
    row;
  * ``map_bandpowers`` adds B3 ``colfft`` of the given maps in front;
  * ``cross_bandpowers`` packs the two map sets as ``x + i y``: B3s
    ``colfft_scaled`` (the window on the load) or B3 ``colfft``, then B6s
    ``rowpower.rows_pp`` (the cross field ``s = Im(Z Zm)`` over the half
    plane), B1 of ``s`` and of the boundary rows' ``s``.

It is the engine of the JAX package's ``bench.py`` configs 1 and 2. Grids
must be ``n = 128 B`` with ``B >= 2``. The tables live on ``device`` (the
card unless it names another); CPU tensors run every kernel's plain
version.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve
from ..geometry import Geometry
from ..ops import dft as D
from ..ops.bin_reduce import bin2_reduce, bin_reduce
from ..ops.mirror import _mirror_tables
from ..ops.rowpower import qc_fields, rows_pp, rowqc_pp, s_field
from ..utils.profiling import span, spanned
from .grf import spec2flat

__all__ = ["FastCl", "drop_edge_segments"]


def drop_edge_segments(ids, nseg: int):
    """``ids`` (numpy) with the under- and overflow segments 0 and
    ``nseg - 1`` set to -1. The binning kernels drop ids outside
    ``[0, nseg)`` and read no data where a warp's ids are all dropped; the
    bandpowers never use those two segments (``[:, 1:-1]``), whose bins
    then come out 0."""
    ids = np.asarray(ids, dtype=np.int32)
    return np.where((ids == 0) | (ids == nseg - 1), np.int32(-1), ids)


class FastCl:
    """Fused GRF-simulation / bandpower engine on a fixed geometry.

    Parameters
    ----------
    geom : Geometry with shape (n, n), n = 128*B, B >= 2.
    ells, cl1d : 1D theory spectrum for simulation; ells that do not start
        at 0 with unit step are re-gridded. Optional: pass None to use
        :meth:`map_bandpowers` only.
    bin_edges : radial bin edges (``np.digitize(..., right=True)``, as
        ``Bin2D``).
    device : where the tables live and the work runs.
    """

    def __init__(self, geom: Geometry, ells=None, cl1d=None, bin_edges=None,
                 device=None):
        n = geom.shape[-1]
        if geom.shape[-2] != n or n % 128 or n < 256:
            raise ValueError("FastCl needs a square n = 128*B grid, B>=2")
        if bin_edges is None:
            raise ValueError("FastCl requires bin_edges")
        dev = resolve(device)
        self.geom = geom
        self.n = n
        self.device = dev
        perm, _ = D.row_perm(n)
        edges = np.asarray(bin_edges, dtype=np.float64)
        self.centers = (edges[1:] + edges[:-1]) / 2.0
        # Bin2D's tables on the doubly-permuted |l| plane: segment 0 and
        # nbins + 1 are the under- and overflow
        dig2d = np.digitize(geom.modlmap_np()[perm][:, perm], edges,
                            right=True).astype(np.int32)
        self._nsg = len(edges) + 1
        counts = np.bincount(dig2d.ravel(), minlength=self._nsg)[1:-1]
        safe = np.where(counts == 0, 1, counts)
        self._icnt = torch.as_tensor(
            (1.0 / safe * (counts > 0)).astype(np.float32), device=dev)
        self._norm = float(np.float32(geom.area / geom.npix ** 2))
        p_of_h, self._pnyq = D.half_rows(n)
        # the bin tables carry -1 for the edge segments, which the
        # bandpowers drop: the kernels then skip the data there (89 % of
        # the half plane at bench config 1)
        ids = lambda a: torch.as_tensor(
            np.ascontiguousarray(drop_edge_segments(a, self._nsg)),
            device=dev)
        self._idc = ids(dig2d[p_of_h].reshape(-1))
        self._mrow = torch.as_tensor(_mirror_tables(n), dtype=torch.long,
                                     device=dev)
        # the boundary rows' ids, for B1 (the JAX package's one-hots _oh0,
        # _ohn)
        self._ids0 = ids(dig2d[0])
        self._idsn = ids(dig2d[self._pnyq])
        self._covsqrt_pp = None
        if cl1d is not None:
            cl = np.asarray(cl1d, np.float64)
            if ells is not None:
                # spec2flat paints by integer index: re-grid spectra whose
                # ells do not start at 0 with unit step (CAMB tables from
                # ell 2) instead of shifting every multipole
                ells = np.asarray(ells)
                if len(ells) != len(cl):
                    raise ValueError("ells and cl1d length mismatch")
                if ells[0] != 0 or np.any(np.diff(ells) != 1):
                    dense = np.arange(int(ells[-1]) + 1)
                    cl = np.interp(dense, ells, cl, left=0.0, right=0.0)
            cs = spec2flat(geom, cl[None, None], exp=0.5,
                           dtype=torch.float32, device="cpu")[0, 0].numpy()
            self._covsqrt_pp = torch.as_tensor(
                np.ascontiguousarray(cs[perm][:, perm]
                                     * np.sqrt(geom.npix).astype(np.float32)),
                device=dev)

    def _row_bins(self, zrow_r, zrow_i, p, ids, field=qc_fields):
        """Bins of ``field`` (:func:`qc_fields` or :func:`s_field`) on
        boundary row ``p`` of ``zrow``: its mirror is a permutation of the
        same row (B1, every field in one call)."""
        zr, zi = zrow_r[:, p], zrow_i[:, p]
        fields = field(zr, zi, zr.index_select(1, self._mrow),
                       zi.index_select(1, self._mrow))
        out = bin_reduce(torch.cat(fields), ids, self._nsg)
        return out.split(zr.shape[0])

    def _pair_bandpowers(self, m1, m2):
        """Binned ``|F1|^2``, ``|F2|^2`` of packed real-map pairs: B3
        ``colfft``, then :meth:`_pair_bandpowers_y`."""
        with span("orphics.fastcl.colfft"):
            y = D.colfft(m1, m2)
        return self._pair_bandpowers_y(*y)

    def _pair_bandpowers_y(self, yr, yi):
        """The same from the column intermediate ``Y`` (a synthesis passes
        its pre-column ``Y'`` directly)."""
        npairs = yr.shape[0]
        with span("orphics.fastcl.power"):
            qs, cc, zrow_r, zrow_i = rowqc_pp(yr, yi)
        with span("orphics.fastcl.bin"):
            bqc, bcc = bin2_reduce(qs.reshape(npairs, -1),
                                   cc.reshape(npairs, -1), self._idc,
                                   self._nsg)
            del qs, cc
            bq0, bc0 = self._row_bins(zrow_r, zrow_i, 0, self._ids0)
            bqn, bcn = self._row_bins(zrow_r, zrow_i, self._pnyq,
                                      self._idsn)
            bq = (2.0 * bqc - bq0 + bqn)[:, 1:-1]
            bc = (2.0 * bcc - bc0 + bcn)[:, 1:-1]
            hn = float(np.float32(0.5) * np.float32(self._norm))
            b1 = (bq + bc) * hn * self._icnt
            b2 = (bq - bc) * hn * self._icnt
        return b1, b2

    def _check_sim(self, batch):
        if self._covsqrt_pp is None:
            raise ValueError("construct FastCl with (ells, cl1d) to sim")
        if batch % 2:
            raise ValueError("batch must be even (pair-packed sims)")

    @spanned("orphics.fastcl.sim_bandpowers")
    def sim_bandpowers(self, seed, batch: int):
        """``(batch, nbins)`` binned auto bandpowers of ``batch`` fresh GRF
        sims, two maps per complex synthesis (``batch`` must be even).
        ``seed``: a scalar stream id or ``(2,)`` int32 words (a Python
        value or a device tensor), or a ``torch.Generator`` on the
        engine's device, which draws the two words there with no host
        round trip. The white noise is drawn inside B5."""
        self._check_sim(batch)
        with span("orphics.fastcl.synth"):
            if isinstance(seed, torch.Generator):
                seed = torch.randint(-2 ** 31, 2 ** 31, (2,), generator=seed,
                                     dtype=torch.int64, device=self.device) \
                    .to(torch.int32)
            yr, yi = D.rowifft_noise_y(self._covsqrt_pp, seed, batch // 2)
        return torch.cat(self._pair_bandpowers_y(yr, yi))

    @spanned("orphics.fastcl.sim_bandpowers_from_noise")
    def sim_bandpowers_from_noise(self, er, ei):
        """:meth:`sim_bandpowers` from given white noise ``(npairs, n, n)``
        re/im planes in the doubly-permuted layout (B4
        ``rowifft_scaled_y``; the JAX method's key branch)."""
        self._check_sim(2 * er.shape[0])
        with span("orphics.fastcl.synth"):
            yr, yi = D.rowifft_scaled_y(er, ei, self._covsqrt_pp)
        return torch.cat(self._pair_bandpowers_y(yr, yi))

    @spanned("orphics.fastcl.cross_bandpowers")
    def cross_bandpowers(self, maps1, maps2, window=None):
        """``(B, nbins)`` binned cross spectra ``Re(x_hat conj(y_hat))`` of
        two real map sets ``(B, n, n)``, one packed transform per pair: for
        ``Z = fft2(x + i y)`` the cross power is ``Im(Z(k) Z(-k)) / 2``, a
        mirror-even field binned on the half plane. An optional ``(n, n)``
        ``window`` is applied on the first transform's load (B3s; the
        windowed maps never reach device memory); debias the result by the
        window's ``w2`` yourself."""
        with span("orphics.fastcl.colfft"):
            m1 = torch.as_tensor(maps1, dtype=torch.float32,
                                 device=self.device)
            m2 = torch.as_tensor(maps2, dtype=torch.float32,
                                 device=self.device)
            if m1.ndim == 2:
                m1, m2 = m1[None], m2[None]
            if m1.shape != m2.shape:
                raise ValueError(f"map sets must match: {tuple(m1.shape)} "
                                 f"vs {tuple(m2.shape)}")
            m1, m2 = m1.contiguous(), m2.contiguous()
            if window is not None:
                w = torch.as_tensor(window, dtype=torch.float32,
                                    device=self.device).contiguous()
                yr, yi = D.colfft_scaled(m1, m2, w)
            else:
                yr, yi = D.colfft(m1, m2)
        with span("orphics.fastcl.power"):
            s, zrow_r, zrow_i = rows_pp(yr, yi)
            del yr, yi
        with span("orphics.fastcl.bin"):
            bsh = bin_reduce(s.reshape(s.shape[0], -1), self._idc,
                             self._nsg)
            del s
            (s0,) = self._row_bins(zrow_r, zrow_i, 0, self._ids0, s_field)
            (sn,) = self._row_bins(zrow_r, zrow_i, self._pnyq, self._idsn,
                                   s_field)
            bs = (2.0 * bsh - s0 + sn)[:, 1:-1]
            hn = float(np.float32(0.5) * np.float32(self._norm))
            return bs * hn * self._icnt

    @spanned("orphics.fastcl.map_bandpowers")
    def map_bandpowers(self, maps):
        """``(B, nbins)`` binned auto power spectra of real maps
        ``(B, n, n)``; odd ``B`` is padded with a zero map internally."""
        maps = torch.as_tensor(maps, dtype=torch.float32, device=self.device)
        if maps.ndim == 2:
            maps = maps[None]
        B = maps.shape[0]
        if B % 2:
            maps = torch.cat([maps, maps.new_zeros((1,) + maps.shape[1:])])
        b1, b2 = self._pair_bandpowers(maps[0::2].contiguous(),
                                       maps[1::2].contiguous())
        return torch.stack([b1, b2], dim=1).reshape(-1, b1.shape[-1])[:B]
