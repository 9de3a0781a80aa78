"""The program's entry points the benchmark drives, one module each, found
by the ``entry`` a traffic file names.

A module defines ``build(cfg, traffic, tables, feed, device)`` returning an
:class:`Entry`: the program's objects built from the configuration, and
what the window, the output check and the rooflines need of them.
"""
from __future__ import annotations

import numpy as np

__all__ = ["Entry"]


class Entry:
    """One cell's program side.

    ``units`` per step; ``items`` answers per step that the check can
    sample (a sim pair, a map pair, a reconstruction); ``step(i)`` runs
    step ``i`` and returns its output tensor; ``answer(out, j)`` is item
    ``j``'s rows of an output as float64; ``reference(i, j, prec)`` the
    plain reference's ``(rows, scale)`` for the same item, the error read
    as ``max |answer - rows| / scale``; ``work()`` the least work of a
    step per layer; ``release()`` frees the program's state before the
    references run.
    """

    units = 0
    items = 0

    def step(self, i):
        raise NotImplementedError

    def answer(self, out, j):
        raise NotImplementedError

    def reference(self, i, j, prec):
        raise NotImplementedError

    def work(self):
        return {}

    def release(self):
        pass

    def sample(self, steps, rng, count):
        """``count`` distinct ``(step, item)`` pairs drawn by ``rng`` from
        the kept ``steps``."""
        pool = [(i, j) for i in steps for j in range(self.items)]
        pick = rng.choice(len(pool), size=min(count, len(pool)),
                          replace=False)
        return [pool[k] for k in sorted(pick)]


def as_rows(t):
    """A tensor as float64 numpy."""
    return t.detach().to("cpu").double().numpy()


def scaled_error(got, ref, scale):
    """``max |got - ref| / scale`` (an empty bin, of scale 0, reads 0 where
    the answer is 0 too), inf where anything is not finite or the shapes
    differ."""
    got = np.asarray(got, np.float64)
    if got.shape != ref.shape or not np.all(np.isfinite(got)):
        return float("inf")
    gap = np.abs(got - ref)
    err = np.where(scale > 0, gap / np.where(scale > 0, scale, 1.0),
                   np.where(gap == 0, 0.0, np.inf))
    return float(np.max(err))
