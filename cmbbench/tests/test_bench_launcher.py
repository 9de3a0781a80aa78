"""A cell on several cards, run on the CPU: two gloo ranks of a small
``tt2048.sim`` take the same steps in one window, the line sums their
units and counts both, the answers are checked, a rank that raises stops
the run with no result, and a one-card run is the one-process run with
the result line's keys unchanged."""
from __future__ import annotations

import copy
import json
import subprocess
import sys
import time

import pytest

from cmbbench import launch as L
from cmbbench import run as R
from cmbbench.tests.small import card_stream, small_cell

CELL = "tt2048.sim"
SECONDS = 0.3
HELPER = (sys.executable, "-m", "cmbbench.tests.cpu_rank")
ONE_CARD_KEYS = ["correct", "attempted", "failed", "metrics", "device",
                 "checked"]
ONE_CARD_DEVICE = {"platform", "kind", "count", "memory_peak_bytes",
                   "power_limit_w"}


def _two_rank_cell():
    """The small cell on two cards (under its own name, so that it reports
    the cell's metrics)."""
    bench, wl, cfg, traffic = small_cell(CELL)
    return bench, {**copy.deepcopy(wl), "chips": 2}, cfg, traffic


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The launcher's run of the two-rank cell, and each rank's steps."""
    rec = tmp_path_factory.mktemp("ranks")
    bench, wl, cfg, traffic = _two_rank_cell()
    code, res = L.launch(bench, wl, cfg, traffic, 2 ** 34 + 7, SECONDS, 0,
                         device="cpu", command=(*HELPER, "--record",
                                                str(rec)), timeout=60)
    records = [json.loads((rec / f"rank{r}.json").read_text())
               for r in range(2)]
    return code, res, records, traffic


def test_ranks_run_the_same_steps(two_ranks):
    code, _, records, _ = two_ranks
    assert code == 0
    assert records[0]["steps"] == records[1]["steps"]
    assert len(records[0]["steps"]) > R.WARMUP_STEPS


def test_entries_find_the_world(two_ranks):
    """Each rank's entry is built inside the world that
    ``parallel.init_multihost`` joined: ``get_mesh()`` spans both ranks."""
    _, _, records, _ = two_ranks
    assert [r["mesh"] for r in records] == [[2, 2.0], [2, 2.0]]


def test_units_summed_and_ranks_counted(two_ranks):
    _, res, records, traffic = two_ranks
    window_steps = len(records[0]["steps"]) - R.WARMUP_STEPS
    assert res["attempted"] == 2 * window_steps * traffic["batch"]
    assert res["device"]["count"] == 2
    assert res["device"]["platform"] == "cpu"
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checked"


def test_two_rank_answers_are_correct(two_ranks):
    _, res, _, traffic = two_ranks
    got = res["checked"][traffic["check"]["name"]]
    assert res["correct"] is True and res["failed"] == 0
    assert got["value"] is not None and got["value"] <= got["limit"]


def test_traced_ranks_run_the_same_steps(tmp_path):
    """With ``--trace 1`` every rank traces and times its dispatch over the
    same steps; the line carries the per-layer metrics."""
    bench, wl, cfg, traffic = _two_rank_cell()
    code, res = L.launch(bench, wl, cfg, traffic, 2 ** 34 + 8, SECONDS, 1,
                         device="cpu", command=(*HELPER, "--record",
                                                str(tmp_path)), timeout=60)
    steps = [json.loads((tmp_path / f"rank{r}.json").read_text())["steps"]
             for r in range(2)]
    assert code == 0 and res["correct"] is True
    assert steps[0] == steps[1]
    assert len(steps[0]) > R.WARMUP_STEPS + 1 + R.DISPATCH_STEPS
    assert "dispatch_ms" in res["metrics"]
    assert "sims_per_s" not in res["metrics"]


# ``main`` in a fresh interpreter (this one has JAX loaded by the tests'
# conftest) on the two-rank cell, its ranks on the CPU, or asking for the
# cards that this machine lacks
_MAIN = """
import functools, sys
from cmbbench import launch as L, run as R
from cmbbench.tests import test_bench_launcher as T
cell = T._two_rank_cell()
R.load_cell = lambda name: cell
L.launch = functools.partial(L.launch, device={device!r},
                             command={command!r}, timeout=60)
sys.exit(R.main(["--workload", cell[1]["name"], "--seed", "{seed}",
                 "--seconds", "{seconds}", "--trace", "0"]))
"""


def _main(device, helper_args):
    command = (*HELPER, *helper_args)
    code = _MAIN.format(device=device, command=command, seed=2 ** 33 + 1,
                        seconds=SECONDS)
    return subprocess.run([sys.executable, "-c", code], cwd=R.REPO,
                          capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("device,helper_args,rc", [
    ("cpu", (), 0), ("cpu", ("--fail", "1:3"), 1),
    ("cpu", ("--loads", "jax"), 3), ("cuda", (), 2)],
    ids=["sound", "rank_raises", "rank_loads_jax", "no_cards"])
def test_main_prints_one_line_or_none(device, helper_args, rc):
    """``main`` on a two-card cell: the result line alone on standard
    output and the compared number last on standard error; where a rank
    raises, its exit code, where one loads JAX 3, and where the cards are
    missing 2, with nothing on standard output."""
    torch = pytest.importorskip("torch")
    if device == "cuda" and torch.cuda.is_available():
        pytest.skip("a card is present")
    t = time.monotonic()
    out = _main(device, helper_args)
    assert out.returncode == rc, out.stderr[-3000:]
    assert time.monotonic() - t < 60        # the group's timeout
    if rc:
        assert out.stdout.strip() == ""
        return
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert res["device"]["count"] == 2 and res["correct"] is True
    name = _two_rank_cell()[3]["check"]["name"]
    assert out.stderr.strip().splitlines()[-1].startswith(name + " ")


def test_one_card_run_is_unchanged(monkeypatch):
    """No child process, no process group, and the line's keys as they
    were before cells could take several cards."""
    torch = pytest.importorskip("torch")

    def no_child(*a, **k):
        raise AssertionError("a one-card run started a process")
    monkeypatch.setattr(subprocess, "Popen", no_child)
    bench, wl, cfg, traffic = small_cell(CELL)
    assert wl["chips"] == 1
    with card_stream():
        res = R.run_cell(bench, wl, cfg, traffic, 2 ** 33 + 3, SECONDS, 0,
                         "cpu", log=lambda s: None)
    assert list(res) == ONE_CARD_KEYS
    assert set(res["device"]) == ONE_CARD_DEVICE
    assert res["device"]["count"] == 1 and res["correct"] is True
    assert not torch.distributed.is_initialized()


def _part(units, window_s, p95, peak, err, correct=True, failed=0,
          busy=None):
    device = {"platform": "gpu", "kind": "card", "count": 1,
              "memory_peak_bytes": peak, "power_limit_w": 700.0}
    if busy is not None:
        device.update(busy_s=busy, window_s=2.0)
    return {"window_s": window_s, "result": {
        "correct": correct, "attempted": units, "failed": failed,
        "metrics": {"sims_per_s": {"value": units / window_s,
                                   "unit": "sims/s"},
                    "step_ms_p95": {"value": p95, "unit": "ms"},
                    "setup_s": {"value": 9.0 + p95, "unit": "s"}},
        "device": device, "checked": {"e": {"value": err,
                                            "limit": 1e-3}}}}


def test_combine_rules():
    parts = [_part(100, 2.0, 1.5, 10, 2e-5),
             _part(120, 2.1, 1.7, 30, 4e-5, failed=1, correct=False)]
    out = L.combine(parts)
    assert out["attempted"] == 220 and out["failed"] == 1
    assert out["correct"] is False
    assert out["metrics"]["sims_per_s"]["value"] == 220 / 2.0
    assert out["metrics"]["step_ms_p95"]["value"] == 1.7
    assert out["metrics"]["setup_s"]["value"] == 10.5       # rank 0's
    assert out["device"]["count"] == 2
    assert out["device"]["memory_peak_bytes"] == 30
    assert out["checked"]["e"] == {"value": 4e-5, "limit": 1e-3}
    assert list(out) == ONE_CARD_KEYS
    traced = L.combine([_part(1, 1.0, 1.0, 1, None, busy=1.0),
                        _part(1, 1.0, 1.0, 1, 1e-5, busy=1.5)])
    assert traced["device"]["busy_s"] == 1.25
    assert traced["checked"]["e"]["value"] is None
