"""``FastCl.cross_bandpowers(m1, m2, window=taper) / w2``: the windowed
cross spectra of given map pairs, the taper fused on the first
transform's load."""
from __future__ import annotations

import numpy as np
import torch

from .. import work as W
from ..reference import flat
from . import Entry, as_rows
from .fastcl import binning_work, build_fastcl, reference_grid


class FastClCross(Entry):
    def __init__(self, cfg, traffic, tables, feed, device):
        self.cfg, self.feed = cfg, feed
        self.batch = self.units = self.items = traffic["batch"]
        self.device = device
        win = traffic["window"]
        taper = flat.cosine_taper(cfg["n"], win["taper_percent"],
                                  win["pad_percent"]).astype(np.float32)
        self.taper64 = torch.as_tensor(taper.astype(np.float64),
                                       device=device)
        self.taper = torch.as_tensor(taper, device=device)
        self.w2 = float(np.mean(taper.astype(np.float64) ** 2))
        self.fc = build_fastcl(cfg, tables, device)

    def step(self, i):
        m1, m2 = self.feed.at(i)
        return self.fc.cross_bandpowers(m1, m2, window=self.taper) / self.w2

    def answer(self, out, j):
        return as_rows(out[j:j + 1])

    def reference(self, i, j, prec):
        grid, binner = reference_grid(self.cfg, self.device)
        g = self.feed.rows(i).start + j
        cross, a1, a2 = flat.cross_bandpowers(
            self.feed.m1[g:g + 1], self.feed.m2[g:g + 1], self.taper64,
            self.w2, grid, binner, prec)
        scale = torch.sqrt(a1 * a2)
        return cross.cpu().numpy(), scale.cpu().numpy()

    def release(self):
        del self.fc

    def work(self):
        n, P = self.cfg["n"], self.batch
        N = n * n
        grid, _ = reference_grid(self.cfg, "cpu")
        # packed x + i y: the two map sets and the taper in, the column and
        # row passes with the taper on the load, the half-plane cross
        # field and the boundary rows (re, im) out
        transforms = (2 * 4.0 * P * N + 4.0 * N + 4.0 * P * N / 2
                      + 2 * 2 * 4.0 * P * n,
                      W.fft2_flops(n, P) + 2 * 2.0 * P * N + 3.0 * P * N / 2)
        return {"transforms": transforms,
                "binning": binning_work(self.cfg, grid, 1, P)}


def build(cfg, traffic, tables, feed, device):
    return FastClCross(cfg, traffic, tables, feed, device)
