"""``QE.kappa_from_map("TT", k)`` of given beam-deconvolved k-maps, with the
configuration's pipeline's estimator, then the N0-debiased auto power
(``N_L_kk("TT")``) binned by ``Bin2D`` on the pipeline's bins."""
from __future__ import annotations

from .. import work as W
from . import Entry, as_rows
from .lensqe import References, build_pipeline, kept_modes


class QERecon(Entry):
    def __init__(self, cfg, traffic, tables, feed, device):
        from orphics_tpu_torch.ops.binning import Bin2D
        self.cfg, self.feed = cfg, feed
        self.batch = self.units = self.items = traffic["batch"]
        pipe = build_pipeline(cfg, tables, device)
        self.qe = pipe.qe
        self.n0 = self.qe.N_L_kk("TT")
        geom = pipe.geom
        self.binner = Bin2D(geom.modlmap_np(), pipe.binner.bin_edges,
                            device=device)
        self.norm = float(geom.area) / float(geom.npix) ** 2
        self.refs = References(cfg, tables, device)

    def step(self, i):
        fk = self.qe.kappa_from_map("TT", self.feed.at(i))
        auto = (fk.real ** 2 + fk.imag ** 2) * self.norm - self.n0
        return self.binner.bin(auto)[1]

    def answer(self, out, j):
        return as_rows(out[j:j + 1])

    def reference(self, i, j, prec):
        ref = self.refs(prec)
        g = self.feed.rows(i).start + j
        fk = ref.kappa(self.feed.k[g:g + 1])
        raw, debiased = ref.spectra(fk)
        return debiased.cpu().numpy(), raw.cpu().numpy()

    def release(self):
        del self.qe, self.n0, self.binner

    def work(self):
        n, B = self.cfg["n"], self.batch
        N = n * n
        # the TT estimator of one real leg needs 3 real inverse transforms
        # (a, alpha_y, alpha_x) and 2 real forward ones (S_y, S_x) a map:
        # each a half-plane spectrum (8 N / 2 bytes) and a real map (4 N)
        transforms = (5 * 8.0 * N * B, W.fft2_flops(n, 2.5 * B))
        kept = kept_modes(self.cfg)
        return {"transforms": transforms,
                "binning": (4.0 * (B + 1) * kept, 1.0 * B * kept)}


def build(cfg, traffic, tables, feed, device):
    return QERecon(cfg, traffic, tables, feed, device)
