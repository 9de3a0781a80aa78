"""``LensedQEPipeline.step(batch, generator)``: fresh lensed sims drawn on
the card, lensed (B8), observed, reconstructed by the TT estimator and
binned into cross, input auto and N0-debiased output auto spectra."""
from __future__ import annotations

import numpy as np

from .. import work as W
from . import Entry, as_rows
from .lensqe import References, build_pipeline, kept_modes


class LensQESim(Entry):
    def __init__(self, cfg, traffic, tables, feed, device):
        self.cfg, self.feed = cfg, feed
        self.batch = self.units = traffic["batch"]
        self.items = self.batch // 2          # a packed pair of sims
        self.pipe = build_pipeline(cfg, tables, device)
        self._words = {}
        self.refs = References(cfg, tables, device)

    def step(self, i):
        return self.pipe.step(self.batch, self.feed.generator)

    def answer(self, out, j):
        # pairs are adjacent: sims 2j and 2j + 1 are pair j's two maps
        return as_rows(out[2 * j:2 * j + 2])

    def reference(self, i, j, prec):
        if i not in self._words:
            self._words[i] = self.feed.step_words(i, (3, 2))
        ref = self.refs(prec)
        rows, raw = ref.sims(self._words[i], j)
        rows = rows.cpu().numpy()
        raw = raw.cpu().numpy()
        # cross and debiased auto against the raw output auto, the input
        # auto against itself
        scale = np.stack([raw, rows[:, 1], raw], axis=1)
        return rows, scale

    def release(self):
        del self.pipe

    def work(self):
        n, B = self.cfg["n"], self.batch
        P, N = B // 2, n * n
        # transforms layer (draws, mirrors, 2D transforms): every plane it
        # hands to or takes from the model algebra, the lens or the binning
        # once, its noise scales in, and its operations: 3P + 3B complex 2D
        # transforms, 3 draws of P N complex normals
        crossing = (3 * 4.0 * N            # the three noise scales
                    + 8.0 * P * N * 2      # kappa and noise draws out
                    + 8.0 * P * N          # kappa mirror out
                    + 8.0 * P * N          # coefficient maps out
                    + 8.0 * B * N * 2      # deflection transform in, out
                    + 4.0 * B * N + 8.0 * P * N   # observed transform
                    + 8.0 * P * N * 2      # observed mirror in, out
                    + 8.0 * B * N * 2      # estimator leg a + i alpha_y
                    + 8.0 * P * N * 2      # estimator legs alpha_x
                    + 8.0 * B * N * 3)     # source transform in, out, mirror
        transforms = (crossing,
                      W.fft2_flops(n, 3 * P + 3 * B)
                      + W.NORMAL_FP32_OPS * 3 * 2 * P * N, 0.0,
                      W.PHILOX_INT_OPS_PER_PAIR * 3 * P * N / 2)
        order = self.cfg["lens_order"]
        lens = (16.0 * B * N,
                B * N * (2.0 * (order + 1) ** 2 + 16.0 * (order + 1)))
        kept = kept_modes(self.cfg)
        binning = (4.0 * (3 * B + 1) * kept, 3.0 * B * kept)
        return {"transforms": transforms, "lens": lens, "binning": binning}


def build(cfg, traffic, tables, feed, device):
    return LensQESim(cfg, traffic, tables, feed, device)
