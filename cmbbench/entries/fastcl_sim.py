"""``FastCl.sim_bandpowers(words, batch)``: fresh GRF sims drawn inside the
synthesis transform from two seed words a step, analysed and binned."""
from __future__ import annotations

from .. import work as W
from ..reference import flat
from . import Entry, as_rows
from .fastcl import binning_work, build_fastcl, reference_grid


class FastClSim(Entry):
    def __init__(self, cfg, traffic, tables, feed, device):
        self.cfg, self.feed = cfg, feed
        self.batch = self.units = traffic["batch"]
        self.items = self.batch // 2          # a packed pair of sims
        self.tables = tables
        self.device = device
        self.fc = build_fastcl(cfg, tables, device)

    def step(self, i):
        return self.fc.sim_bandpowers(self.feed.at(i), self.batch)

    def answer(self, out, j):
        # rows [0, P) are the pairs' real-part maps, [P, 2P) the imaginary
        return as_rows(out[[j, j + self.items]])

    def reference(self, i, j, prec):
        grid, binner = reference_grid(self.cfg, self.device)
        words = self.feed.at(i).cpu().numpy()
        rows = flat.sim_bandpowers(words, [j], grid, self.tables["lCl_TT"],
                                   binner, prec, self.device)[0]
        rows = rows.cpu().numpy()
        return rows, rows

    def release(self):
        del self.fc

    def work(self):
        n, P = self.cfg["n"], self.items
        N = n * n
        grid, _ = reference_grid(self.cfg, "cpu")
        # draw + inverse row pass + forward row pass + power fields: the
        # covsqrt plane in, the two half-plane fields and the two boundary
        # rows (re, im) out; the column passes cancel
        transforms = (4.0 * N + 2 * 4.0 * P * N / 2 + 2 * 2 * 4.0 * P * n,
                      W.fft_flops(n, 2 * P * n)
                      + W.NORMAL_FP32_OPS * 2 * P * N + 8.0 * P * N / 2,
                      0.0, W.PHILOX_INT_OPS_PER_PAIR * P * N / 2)
        return {"transforms": transforms,
                "binning": binning_work(self.cfg, grid, 2, P)}


def build(cfg, traffic, tables, feed, device):
    return FastClSim(cfg, traffic, tables, feed, device)
