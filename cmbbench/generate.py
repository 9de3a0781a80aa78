"""The one input generator: it reads a traffic file's ``inputs`` block and
makes, from the run's seed, what every step of the window is fed.

Kinds of input (a traffic file picks one and sets its parameters):

* ``seed_words``: a table of ``words`` int32 seed words per step, drawn on
  the card from the seed; step ``i`` takes row ``i`` (modulo the table's
  ``MAX_STEPS`` rows, more than a window holds).
* ``generator``: a ``torch.Generator`` on the card seeded from the seed,
  handed to the program, which draws its own words from it each step.
* ``map_pairs``: two held batches of ``count`` real Gaussian maps of the
  configuration's grid with the spectrum ``spectrum``, the second
  correlated with the first by ``correlation``; step ``i`` takes the
  ``batch`` pairs ``[batch j, batch (j + 1))`` with ``j = i mod (count /
  batch)``.
* ``kmaps``: ``count`` held raw-fft k-maps of beam-deconvolved Gaussian
  maps (the spectrum plus, with ``noise``, the configuration's white noise
  over its beam squared), taken in turn as the map pairs are.

Everything is made on the card in a few large calls; the same seed gives the
same inputs.
"""
from __future__ import annotations

import numpy as np
import torch

from .reference.flat import ARCMIN, Grid

__all__ = ["Feed", "subseed", "MAX_STEPS"]

MAX_STEPS = 1 << 16
_CHUNK = 32


def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed for the stream ``tag`` of the run's ``seed``
    (splitmix64's finalizer over both)."""
    m = (1 << 64) - 1
    x = (int(seed) * 0x9E3779B97F4A7C15
         + sum(map(ord, tag)) * 0xD1B54A32D192ED03) & m
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & m
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & m
    return (x ^ (x >> 31)) & ((1 << 63) - 1)


def _gen(seed, tag, device):
    g = torch.Generator(device=device)
    g.manual_seed(subseed(seed, tag))
    return g


def _spectrum(cfg, tables, key, noise: bool):
    """Per-mode spectrum on the configuration's grid, float64 numpy."""
    grid = Grid(cfg["n"], cfg["px_arcmin"])
    cl = grid.interp(tables[key])
    if noise:
        beam = np.exp(-(cfg["beam_arcmin"] * ARCMIN) ** 2 * grid.ml ** 2
                      / (16.0 * np.log(2.0)))
        cl = cl + ((cfg["noise_uk_arcmin"] * ARCMIN) ** 2
                   / np.maximum(beam ** 2, 1e-30))
    return grid, cl


class Feed:
    """What the steps of one run are fed, made from ``seed`` on
    ``device``. ``at(i)`` is step ``i``'s input."""

    def __init__(self, cfg, traffic, tables, seed: int, device):
        spec = traffic["inputs"]
        self.kind = spec["kind"]
        self.seed = seed
        self.device = device
        self.batch = traffic["batch"]
        if self.kind == "seed_words":
            g = _gen(seed, "words", device)
            self.words = torch.randint(
                -2 ** 31, 2 ** 31, (MAX_STEPS, spec["words"]), generator=g,
                dtype=torch.int64, device=device).to(torch.int32)
        elif self.kind == "generator":
            self.generator = _gen(seed, "generator", device)
        elif self.kind in ("map_pairs", "kmaps"):
            count = spec["count"]
            if count % self.batch:
                raise ValueError("held inputs must be whole batches")
            self.turns = count // self.batch
            grid, cl = _spectrum(cfg, tables, spec["spectrum"],
                                 spec.get("noise", False))
            scale = torch.as_tensor(np.sqrt(cl * grid.npix / grid.area),
                                    dtype=torch.float32, device=device)
            g = _gen(seed, "held", device)
            if self.kind == "map_pairs":
                rho = float(spec["correlation"])
                self.m1 = self._maps(g, count, grid.n, scale)
                other = self._maps(g, count, grid.n, scale)
                self.m2 = self.m1 * rho
                self.m2.add_(other, alpha=float(np.sqrt(1.0 - rho * rho)))
                del other
            else:
                self.k = self._kmaps(g, count, grid.n, scale)
        else:
            raise ValueError(f"unknown input kind {self.kind!r}")

    def _kmaps(self, g, count, n, scale):
        out = torch.empty((count, n, n), dtype=torch.complex64,
                          device=self.device)
        for i in range(0, count, _CHUNK):
            w = torch.randn((min(_CHUNK, count - i), n, n), generator=g,
                            device=self.device)
            out[i:i + len(w)] = torch.fft.fft2(w) * scale
        return out

    def _maps(self, g, count, n, scale):
        out = torch.empty((count, n, n), dtype=torch.float32,
                          device=self.device)
        for i in range(0, count, _CHUNK):
            k = self._kmaps(g, min(_CHUNK, count - i), n, scale)
            out[i:i + len(k)] = torch.fft.ifft2(k).real
        return out

    def rows(self, i: int):
        """The slice of held inputs that step ``i`` takes."""
        j = (i % self.turns) * self.batch
        return slice(j, j + self.batch)

    def at(self, i: int):
        if self.kind == "seed_words":
            return self.words[i % MAX_STEPS]
        if self.kind == "generator":
            return self.generator
        r = self.rows(i)
        if self.kind == "map_pairs":
            return self.m1[r], self.m2[r]
        return self.k[r]

    def step_words(self, i: int, shape):
        """The words the program drew from the ``generator`` feed at step
        ``i``: the ``(i + 1)``-th draw of ``torch.randint(-2**31, 2**31,
        shape)`` from a generator seeded as the feed's (one draw a step)."""
        g = _gen(self.seed, "generator", self.device)
        for _ in range(i + 1):
            w = torch.randint(-2 ** 31, 2 ** 31, shape, generator=g,
                              dtype=torch.int64, device=self.device)
        return w.to(torch.int32).cpu().numpy()
