"""A lensing Monte Carlo campaign as orphics runs it under MPI: each rank
draws, lenses and reconstructs its block of sims, folds their spectra
into float64 moments and their kappa estimates into a mean-field stack,
and one all-reduce ends the campaign. The step is
``parallel.runtime.ensemble_stats`` of ``LensedQEPipeline.step_kappa``
over ``get_mesh()``, in its batched form (one pipeline call a chunk);
it returns the reduced statistics, replicated on every rank, and the
rank's per-sim spectra, the records orphics' ``Stats`` keeps.

The check holds the campaign to the float64 reference, and the step's
moments to a two-pass float64 reduction of the same records: the
pipeline's float32 rounding reads ~2e-4 of a bin's spread against the
reference, more than float32 accumulators add, so only the second part
tells float64 moments from float32 ones."""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from ..generate import subseed
from ..reference.ensemble import Campaign
from . import Entry
from .lensqe import build_pipeline
from .lensqe_sim import LensQESim

LABELS = ("cross", "auto_in", "auto_rec")
# the scale of the accumulation part, as a share of each bin's spread
# (sqrt C_ii, sqrt(C_ii C_jj)): at the limit 1e-2, 1e-8 of the spread
ACC_SCALE = 1e-6


def rows(mean, cov, stack_re, stack_im):
    """The compared numbers of a campaign, flat float64: the spectra's
    means, their covariances, the mean field's real and imaginary planes
    (natural order)."""
    return np.concatenate([np.ravel(mean), np.ravel(cov), np.ravel(stack_re),
                           np.ravel(stack_im)]).astype(np.float64)


class LensQEEnsemble(Entry):
    items = 1

    def __init__(self, cfg, traffic, tables, feed, device):
        from orphics_tpu_torch.ops.dft import row_perm
        from orphics_tpu_torch.parallel import get_mesh
        ens = cfg["ensemble"]
        self.cfg, self.tables, self.device = cfg, tables, device
        self.nsims, self.chunk = ens["sims"], ens["chunk"]
        self.mesh = get_mesh(device=device)
        ranks = self.mesh.axis("sims").size
        if self.nsims % (ranks * self.chunk):
            raise ValueError(f"{self.nsims} sims are not whole chunks of "
                             f"{self.chunk} on {ranks} ranks")
        self.units = self.nsims // ranks
        self.pipe = build_pipeline(cfg, tables, device)
        if self.pipe.impl != "pallas":
            raise ValueError("the campaign's stack is read in the "
                             "full-plane layout: the grid must take it")
        self._inv = row_perm(cfg["n"])[1]
        self._refs = {}
        self.seed = feed.seed

    def campaign_seed(self, i):
        return subseed(self.seed, f"campaign {i}")

    def _task(self, generator, count):
        spectra, (kr, ki) = self.pipe.step_kappa(count, generator)
        self._records.append(spectra)
        return ({k: spectra[:, j] for j, k in enumerate(LABELS)},
                {"kappa_re": kr, "kappa_im": ki})

    def step(self, i):
        from orphics_tpu_torch.parallel.runtime import ensemble_stats
        self._records = []
        stats = ensemble_stats(self._task, self.nsims,
                               seed=self.campaign_seed(i), mesh=self.mesh,
                               chunk=self.chunk, batched=True)
        return stats, self._records

    def answer(self, out, j):
        import torch
        stats, records = out
        host = lambda t: t.detach().cpu().double().numpy()
        mean = np.stack([host(stats[k].mean()) for k in LABELS])
        cov = np.stack([host(stats[k].cov()) for k in LABELS])
        inv = self._inv
        planes = [host(stats[k].stack_mean())[inv][:, inv]
                  for k in ("kappa_re", "kappa_im")]
        # every rank's records, reduced in two float64 passes
        x = host(self.mesh.axis("sims").all_gather(torch.cat(records), 0))
        m2 = x.mean(axis=0)
        dev = x - m2
        c2 = np.einsum("sli,slj->lij", dev, dev) / (len(x) - 1)
        return np.concatenate([rows(mean, cov, *planes), np.ravel(mean - m2),
                               np.ravel(cov - c2)])

    def reference(self, i, j, prec):
        key = (i, prec.name)
        if key not in self._refs:
            camp = Campaign(self.cfg, self.tables, self.device, prec)
            self._refs[key] = camp.run(self.campaign_seed(i), self.nsims,
                                       self.chunk)
        r = self._refs[key]
        raw, auto_in = r["raw_mean"], r["mean"][1]
        # the means as the sim cell scales its spectra: cross and debiased
        # auto against the raw output auto, the input auto against itself;
        # each covariance against sqrt(C_ii C_jj); the mean field against
        # the rms of one sim's estimate; the step's moments less the
        # records' two-pass ones against 0, over ACC_SCALE of the spread
        mscale = np.stack([raw, auto_in, raw])
        d = np.sqrt(np.abs(np.einsum("lii->li", r["cov"])))
        cscale = d[:, :, None] * d[:, None, :]
        sm = r["stack_mean"]
        full = np.full(sm.shape, r["rms"])
        acc = ACC_SCALE * np.concatenate([np.ravel(d), np.ravel(cscale)])
        return (np.concatenate([rows(r["mean"], r["cov"], sm.real, sm.imag),
                                np.zeros(acc.size)]),
                np.concatenate([rows(mscale, cscale, full, full), acc]))

    def release(self):
        del self.pipe

    def work(self):
        # a rank's step: lensqe512.sim's work for each of its chunks
        one = LensQESim.work(SimpleNamespace(cfg=self.cfg, batch=self.chunk))
        k = self.units // self.chunk
        return {name: tuple(k * v for v in w) for name, w in one.items()}


def build(cfg, traffic, tables, feed, device):
    return LensQEEnsemble(cfg, traffic, tables, feed, device)
