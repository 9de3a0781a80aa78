"""Plain float64 reference of a lensing Monte Carlo campaign: every sim of
the campaign through the flat lensing reference (:mod:`.lensqe`), then
its moments and its mean-field stack reduced in numpy float64, written
from the definitions and not from the program.

A campaign of ``nsims`` sims at ``seed`` runs in chunks of ``chunk``
sims. The chunk that starts at sim ``c`` draws its three seed words
(kappa, CMB coefficients, instrument noise) as one ``torch.randint(-2**31,
2**31, (3, 2))`` from a ``torch.Generator`` of the device seeded with
``SeedSequence([seed, c]).generate_state(1, uint64)[0]`` (the campaign's
stream rule, frozen here), and sim ``c + 2j`` and ``c + 2j + 1`` are the
two maps of pair ``j`` of those noise sets (:mod:`.streams`). The
Philox stream is regenerated on the device in int64 arithmetic, word for
word the stream of :func:`.streams.philox4x32`.

Reduced: per spectrum (cross, input auto, debiased output auto) the mean
over the sims and the covariance about it (two passes), the mean of the
raw output auto, the mean of the raw-fft kappa estimates (the mean
field) and the rms of the first sim's estimate over its plane.
"""
from __future__ import annotations

import numpy as np
import torch

from . import streams
from .flat import Prec
from .lensqe import LensQE, lens

__all__ = ["task_seed", "chunk_words", "philox4x32", "natural_planes",
           "Campaign"]

_M32 = 0xFFFFFFFF
_MUL0 = 0xD2511F53
_MUL1 = 0xCD9E8D57
_KEY0 = 0x9E3779B9
_KEY1 = 0xBB67AE85
_SUB = 16           # sims a pass of the reference holds at once


def task_seed(seed: int, index: int) -> int:
    """The 64-bit generator seed of the chunk that starts at sim
    ``index``."""
    return int(np.random.SeedSequence([int(seed), int(index)])
               .generate_state(1, np.uint64)[0])


def chunk_words(seed: int, first: int, device):
    """The ``(3, 2)`` int32 seed words the chunk from sim ``first`` draws."""
    g = torch.Generator(device=device)
    g.manual_seed(task_seed(seed, first))
    w = torch.randint(-2 ** 31, 2 ** 31, (3, 2), generator=g,
                      dtype=torch.int64, device=device)
    return w.to(torch.int32).cpu().numpy()


def _mulhilo(a, m: int):
    """``(high, low)`` 32-bit words of ``a * m`` for int64 ``a`` and ``m``
    below 2**32, in 16-bit halves of ``m`` so that no product passes
    2**63."""
    lo = a * (m & 0xFFFF)
    hi = a * (m >> 16)
    mid = lo + ((hi & 0xFFFF) << 16)
    return (hi >> 16) + (mid >> 32), mid & _M32


def philox4x32(q, key0: int, key1: int):
    """The four 32-bit words (int64 tensors) of Philox-4x32-10 at the
    counters ``(q low, q high, 0, 0)``, ``q`` an int64 tensor."""
    c0, c1 = q & _M32, q >> 32
    c2 = torch.zeros_like(q)
    c3 = torch.zeros_like(q)
    for r in range(10):
        kx = (key0 + r * _KEY0) & _M32
        ky = (key1 + r * _KEY1) & _M32
        hi0, lo0 = _mulhilo(c0, _MUL0)
        hi1, lo1 = _mulhilo(c2, _MUL1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ kx, lo1, hi0 ^ c3 ^ ky, lo0
    return c0, c1, c2, c3


def _normal(bits):
    u = ((bits & 0x7FFFFF).to(torch.float64) + 0.5) / 2.0 ** 23
    return np.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)


def natural_planes(words, first: int, count: int, n: int, device):
    """Planes ``first .. first + count - 1`` of the ``(batch, n, n)``
    stream of the two int32 seed ``words``, complex128 in natural
    frequency order (:func:`.streams.natural_plane` for many planes)."""
    k0, k1 = (int(w) & _M32 for w in words)
    npl = n * n
    q = torch.arange(first * npl // 2, (first + count) * npl // 2,
                     dtype=torch.int64, device=device)
    x, y, z, w = philox4x32(q, k0, k1)
    re = torch.stack([_normal(x), _normal(y)], dim=1).reshape(-1)
    im = torch.stack([_normal(z), _normal(w)], dim=1).reshape(-1)
    planes = torch.complex(re, im).reshape(count, n, n)
    inv = torch.as_tensor(streams.row_perm(n)[1], device=device)
    return planes[:, inv][:, :, inv]


class Campaign:
    """The configuration's campaigns in ``prec`` on ``device``: its sims
    through :class:`.lensqe.LensQE`, reduced in float64."""

    def __init__(self, cfg, tables, device, prec: Prec = None):
        self.ref = LensQE(cfg, tables, device, prec or Prec())
        self.cfg = cfg
        self.dev = device

    def _maps(self, words, pair0, pairs, scale):
        """The two real maps of pairs ``pair0 ..`` of a noise set, in sim
        order ``(2 pairs, n, n)``."""
        p, n = self.ref.prec, self.ref.grid.n
        eta = natural_planes(words, pair0, pairs, n, self.dev)
        z = p.ifft2(p.q(scale * p.q(eta)))
        return torch.stack([z.real, z.imag], dim=1).reshape(2 * pairs, n, n)

    def sims(self, words3, pair0, pairs):
        """Sims ``2 pair0 .. 2 (pair0 + pairs) - 1`` of a chunk drawn from
        ``words3``: binned ``(cross, auto_in, auto - N0)`` ``(2 pairs, 3,
        nbins)``, the raw output auto ``(2 pairs, nbins)`` (float64) and
        the raw-fft kappa estimates ``(2 pairs, n, n)``."""
        ref, p = self.ref, self.ref.prec
        kap = self._maps(words3[0], pair0, pairs, ref.s_kk)
        K = p.fft2(kap)
        coeffs = self._maps(words3[1], pair0, pairs, ref.s_cc)
        ay = p.ifft2(p.q(ref.iphi_y * K)).real
        ax = p.ifft2(p.q(ref.iphi_x * K)).real
        lensed = lens(coeffs, ay, ax, ref.grid.d,
                      float(self.cfg["maxdisp_px"]), p)
        noise = self._maps(words3[2], pair0, pairs, ref.s_ww)
        fk = ref.kappa(p.fft2(p.q(lensed + noise)))
        raw, debiased, cross, auto_in = ref.spectra(fk, K)
        return torch.stack([cross, auto_in, debiased], dim=1), raw, fk

    def run(self, seed: int, nsims: int, chunk: int):
        """The campaign's reduced statistics: ``mean`` ``(3, nbins)``,
        ``cov`` ``(3, nbins, nbins)`` (ddof 1), ``raw_mean`` ``(nbins,)``,
        ``stack_mean`` (complex ``(n, n)``, natural order) and ``rms``,
        numpy float64."""
        rows, raws = [], []
        stack, rms = 0.0, None
        for c0 in range(0, nsims, chunk):
            words3 = chunk_words(seed, c0, self.dev)
            valid = min(chunk, nsims - c0)
            for pair0 in range(0, (valid + 1) // 2, _SUB // 2):
                pairs = min(_SUB // 2, (valid + 1) // 2 - pair0)
                keep = min(2 * pairs, valid - 2 * pair0)
                r, raw, fk = self.sims(words3, pair0, pairs)
                rows.append(r[:keep].cpu().numpy())
                raws.append(raw[:keep].cpu().numpy())
                fk = fk[:keep].to(torch.complex128)
                stack = stack + fk.sum(dim=0).cpu().numpy()
                if rms is None:
                    rms = float(torch.sqrt((fk[0].abs() ** 2).mean()))
        x = np.concatenate(rows)
        mean = x.mean(axis=0)
        d = x - mean
        cov = np.einsum("sli,slj->lij", d, d) / (nsims - 1)
        return {"mean": mean, "cov": cov,
                "raw_mean": np.concatenate(raws).mean(axis=0),
                "stack_mean": stack / nsims, "rms": rms}
