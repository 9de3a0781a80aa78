"""``CurvedQE.kappa_from_alm`` of given full-sky T alms: the curved-sky TT
estimator (one B10s synthesis of the 4 B stacked legs, one B10a analysis of
the 3 B product maps), then the auto spectrum less the interpolated N0,
binned by a fixed averaging matrix."""
from __future__ import annotations

import math

import numpy as np

from ..reference.curved import bin_matrix, total_spectrum
from ..work_sht import legendre_work, ring_fft_work
from . import Entry, as_rows

_CHUNK = 8


class CurvedQERecon(Entry):
    def __init__(self, cfg, traffic, tables, feed, device):
        import torch
        from orphics_tpu_torch.models.curved_qe import CurvedQE
        from orphics_tpu_torch.ops import sht
        self.cfg, self.tables, self.device = cfg, tables, device
        self.batch = self.units = self.items = traffic["batch"]
        count = traffic["inputs"]["count"]
        if count % self.batch:
            raise ValueError("held inputs must be whole batches")
        self.turns = count // self.batch
        lmax, r = cfg["lmax"], cfg["rings"]
        if r["kind"] != "gauss_legendre" or cfg["dtype"] != "float32":
            raise ValueError("this entry runs float32 data on "
                             "Gauss-Legendre rings only")
        self.rings = sht.gauss_legendre_rings(r["lmax"])
        if self.rings.shape != (r["ntheta"], r["nphi"]):
            raise ValueError(f"rings {self.rings.shape} are not the "
                             f"configuration's {(r['ntheta'], r['nphi'])}")
        cl = np.asarray(tables["lCl_TT"], np.float64)[:lmax + 1]
        ctot = total_spectrum(cfg, cl)
        self.fast = cfg["fast"]
        self.qe = CurvedQE(self.rings, lmax, cl, ctot, lmin=cfg["lmin"],
                           device=device)
        Ls, n0 = self.qe.n0("kappa")
        f32 = dict(dtype=torch.float32, device=device)
        self.n0 = torch.as_tensor(np.interp(np.arange(lmax + 1), Ls, n0),
                                  **f32)
        b = cfg["bins"]
        edges = np.arange(b["start"], b["stop"], float(b["step"]))
        self.bins_t = torch.as_tensor(bin_matrix(edges, lmax).T, **f32)
        self.alms = self._held(feed.generator, ctot, count)
        self.refs = None

    def _held(self, gen, ctot, count):
        """``count`` Gaussian T alms of ``ctot`` (m = 0 real), complex64,
        drawn in a few large calls from the feed's generator."""
        import torch
        lmax = self.cfg["lmax"]
        ls = np.concatenate([np.arange(m, lmax + 1) for m in range(lmax + 1)])
        m0 = np.arange(ls.size) <= lmax     # the packed m = 0 column
        sig = np.sqrt(ctot[ls])
        s_re = torch.as_tensor(np.where(m0, sig, sig / math.sqrt(2.0)),
                               dtype=torch.float32, device=self.device)
        s_im = torch.as_tensor(np.where(m0, 0.0, sig / math.sqrt(2.0)),
                               dtype=torch.float32, device=self.device)
        out = torch.empty((count, ls.size), dtype=torch.complex64,
                          device=self.device)
        for i in range(0, count, _CHUNK):
            n = min(_CHUNK, count - i)
            z = torch.randn((n, 2, ls.size), generator=gen,
                            device=self.device)
            out[i:i + n] = torch.complex(z[:, 0] * s_re, z[:, 1] * s_im)
        return out

    def _first(self, i):
        return (i % self.turns) * self.batch

    def step(self, i):
        from orphics_tpu_torch.ops import alm as almops
        j = self._first(i)
        k = self.qe.kappa_from_alm(self.alms[j:j + self.batch],
                                   fast=self.fast)
        return (almops.alm2cl(k) - self.n0) @ self.bins_t

    def answer(self, out, j):
        return as_rows(out[j:j + 1])

    def reference(self, i, j, prec):
        from ..reference.curved import CurvedQERef
        if self.refs is None:
            self.refs = CurvedQERef(self.cfg, self.tables, self.device)
        g = self._first(i) + j
        raw, debiased = self.refs.spectra(self.alms[g:g + 1], prec)
        return debiased.cpu().numpy(), raw.cpu().numpy()

    def release(self):
        from orphics_tpu_torch.ops import legendre as leg
        del self.qe, self.n0, self.bins_t
        leg.clear_tables()

    def work(self):
        lmax, r, B = self.cfg["lmax"], self.cfg["rings"], self.batch
        # the synthesis of 4 B stacked legs, the analysis of 3 B products
        return {**legendre_work(lmax, r["ntheta"], 3 * B, 4 * B,
                                self.device),
                "transforms": ring_fft_work(lmax, r["ntheta"], r["nphi"],
                                            7 * B)}


def build(cfg, traffic, tables, feed, device):
    return CurvedQERecon(cfg, traffic, tables, feed, device)
