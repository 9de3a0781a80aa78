"""The output check of every cell on the CPU at a small size: the plain
references agree with the port's plain path, the bfloat16 control fails
the cell's limit, and a run whose timed path is broken reads
``correct: false``."""
from __future__ import annotations

import contextlib
import importlib

import pytest

from cmbbench.control import control_errors
from cmbbench.run import run_cell
from cmbbench.tests.small import CELLS, card_stream, small_cell

# what the port's plain CPU path is held to at the small size (float32
# against float64; the card's runs read 1e-6 to 2e-4, PERF.md)
CPU_TOL = 1e-3
# the program entry each cell's step calls
_ENTRY = {
    "tt2048.sim": ("orphics_tpu_torch.models.fastcl", "FastCl",
                   "sim_bandpowers"),
    "tt2048.cross": ("orphics_tpu_torch.models.fastcl", "FastCl",
                     "cross_bandpowers"),
    "lensqe512.sim": ("orphics_tpu_torch.models.lenspipe",
                      "LensedQEPipeline", "step"),
    "lensqe512.recon": ("orphics_tpu_torch.models.qe", "QE",
                        "kappa_from_map"),
    "curvedqe2047.recon": ("orphics_tpu_torch.models.curved_qe", "CurvedQE",
                           "kappa_from_alm"),
}
# cells whose altered answer is the whole reconstruction rescaled: one bin
# of a flat k-map moves a residual near zero, and alm 3 (l = 3) lies below
# the curved cell's first bin
_RESCALED = ("lensqe512.recon", "curvedqe2047.recon")


def _run(name, seconds=0.5, seed=2 ** 33 + 5):
    bench, wl, cfg, traffic = small_cell(name)
    with card_stream():
        return run_cell(bench, wl, cfg, traffic, seed, seconds, 0, "cpu",
                        log=lambda s: None), traffic


@pytest.mark.parametrize("name", CELLS)
def test_reference_matches_plain_path(name):
    res, traffic = _run(name)
    got = res["checked"][traffic["check"]["name"]]["value"]
    assert got is not None and got <= CPU_TOL, res["checked"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limit(name):
    _, _, cfg, traffic = small_cell(name)
    limit = traffic["check"]["limit"]
    assert limit is not None, f"{name} has no limit"
    errs = control_errors(cfg, traffic, 77, "cpu", steps=8)
    assert errs and max(errs) > limit, (errs, limit)


def _stale(fn):
    first = {}

    def wrapped(*a, **k):
        if "out" not in first:
            first["out"] = fn(*a, **k)
        return first["out"]
    return wrapped


def _half_mean(fn):
    def wrapped(*a, **k):
        out = fn(*a, **k).clone()
        h = out.shape[0] // 2
        out[h:] = out[:h].mean(0)
        return out
    return wrapped


def _altered(fn):
    """One bin of every answer 5 % off."""
    def wrapped(*a, **k):
        out = fn(*a, **k).clone()
        out[..., 3] *= 1.05
        return out
    return wrapped


def _rescaled(fn):
    """Every reconstruction 5 % off where it is produced (a 5 % change of
    the debiased auto alone is 5 % of a residual near zero)."""
    def wrapped(*a, **k):
        return fn(*a, **k) * 1.05
    return wrapped


@contextlib.contextmanager
def _broken(name, fault):
    mod, cls, meth = _ENTRY[name]
    if fault is _altered and name in _RESCALED:
        fault = _rescaled
    owner = getattr(importlib.import_module(mod), cls)
    saved = getattr(owner, meth)
    setattr(owner, meth, fault(saved))
    try:
        yield
    finally:
        setattr(owner, meth, saved)


@pytest.mark.parametrize("fault", [_stale, _half_mean, _altered],
                         ids=["state_unchanged", "half_batch_mean",
                              "answer_altered"])
@pytest.mark.parametrize("name", CELLS)
def test_broken_path_reads_incorrect(name, fault):
    with _broken(name, fault):
        res, _ = _run(name, seconds=1.0)
    assert res["correct"] is False
    assert res["failed"] > 0


def test_sound_run_reads_correct():
    res, _ = _run("tt2048.cross")
    assert res["correct"] is True and res["failed"] == 0
