"""The harness: ``BENCHMARK.json`` against the contract, every piece found
by name, nothing of JAX loaded, the result line's keys, and no result
without a card."""
from __future__ import annotations

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from cmbbench import run as R
from cmbbench.trace import families
from cmbbench.tests.small import CELLS, card_stream, small_cell

HERE = Path(R.__file__).resolve().parent
REPO = HERE.parent
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "orphics_tpu"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def _contract(bench, size=None):
    """``bench`` against the contract; ``size``: the file's bytes."""
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["cmbbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert all(_line(w) for w in bench["command"])
    assert size is None or size <= 64 * 1024
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("cmbbench/")
        assert (REPO / c["file"]).is_file()
        assert json.loads((REPO / c["file"]).read_text())["reduced"] \
            == c["reduced"]
        names.add(c["name"])
    cells = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _line(w["why"])
        cells.add(w["name"])
    assert len(cells) == len(bench["workloads"])
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(cells) // 4)
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert {"sims_per_s", "step_ms_p95", "peak_mem_gib", "setup_s"} == e2e
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert _line(m["layer"])
    assert len({m["name"] for m in bench["per_layer"]}) \
        == len(bench["per_layer"])
    return cells


def test_benchmark_json_contract():
    cells = _contract(BENCH, (REPO / "BENCHMARK.json").stat().st_size)
    assert cells == set(CELLS)


def _with_cells(chips):
    """``BENCHMARK.json`` with one more cell of each count in ``chips``."""
    bench = json.loads(json.dumps(BENCH))
    for k, n in enumerate(chips):
        bench["workloads"].append({**bench["workloads"][0],
                                   "name": f"zz_cell{k}", "chips": n})
    return bench


@pytest.mark.parametrize("chips,ok", [
    ((4,), True),           # one four-chip cell is always allowed
    ((4, 4), False),        # 7 cells: at most one
    ((4, 1, 1, 4), True),   # 9 cells: two
    ((4, 1, 1, 4, 4), False),
    ((2,), False),          # a cell takes 1 or 4 chips
], ids=["one_of_six", "two_of_seven", "two_of_nine", "three_of_ten",
        "two_chips"])
def test_four_chip_cells_counted(chips, ok):
    bench = _with_cells(chips)
    if ok:
        _contract(bench)
    else:
        with pytest.raises(AssertionError):
            _contract(bench)


def test_pieces_found_by_name():
    for w in BENCH["workloads"]:
        _, wl, cfg, traffic = R.load_cell(w["name"])
        entry = __import__(f"cmbbench.entries.{traffic['entry']}",
                           fromlist=["build"])
        assert callable(entry.build)
        assert cfg["name"] == wl["config"]
    for m in BENCH["per_layer"]:
        assert callable(R.metric_reader(m["name"]))
    fams = [f for f, _, _ in families()]
    assert {"transforms", "binning", "lens", "elementwise"} <= set(fams)


def test_new_traffic_file_is_picked_up(tmp_path):
    """A later cell adds a traffic file and an entry in BENCHMARK.json and
    edits no file of the harness."""
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "tt2048.sim_small_batch",
                               "config": "flat_tt_2048",
                               "traffic": "zz_test_sim24", "chips": 1,
                               "why": "a test cell"})
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    traffic = json.loads((HERE / "traffic" / "fastcl_sim192.json")
                         .read_text())
    traffic["batch"] = 24
    extra = HERE / "traffic" / "zz_test_sim24.json"
    extra.write_text(json.dumps(traffic))
    try:
        _, wl, cfg, tr = R.load_cell("tt2048.sim_small_batch", path)
        assert tr["batch"] == 24 and cfg["name"] == "flat_tt_2048"
        assert wl["traffic"] == "zz_test_sim24"
    finally:
        extra.unlink()


def _imports(path):
    tree = ast.parse(Path(path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources_import_no_jax():
    for p in HERE.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(p)}
        assert not tops & FORBIDDEN, (p, tops & FORBIDDEN)
    for p in (HERE / "reference").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(p)}
        assert "orphics_tpu_torch" not in tops, p


def test_run_loads_no_jax():
    """Every module a run loads (the port's included), in a fresh
    process."""
    code = (
        "import sys, importlib\n"
        "from cmbbench import run, control, trace, generate\n"
        "from cmbbench.tests.small import CELLS, small_cell\n"
        "for c in CELLS:\n"
        "    _, _, cfg, tr = small_cell(c)\n"
        "    importlib.import_module('cmbbench.entries.' + tr['entry'])\n"
        "import orphics_tpu_torch.models.fastcl, orphics_tpu_torch.models."
        "lenspipe, orphics_tpu_torch.ops.binning\n"
        "for m in run.load_cell(CELLS[0])[0]['per_layer']:\n"
        "    run.metric_reader(m['name'])\n"
        "print(' '.join(run.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_result_line_keys():
    bench, wl, cfg, traffic = small_cell("tt2048.cross")
    with card_stream():
        res = R.run_cell(bench, wl, cfg, traffic, 3, 0.3, 1, "cpu",
                         log=lambda s: None)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checked"
    assert set(res) <= {"correct", "attempted", "failed", "metrics",
                        "device", "breakdown", "checked"}
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    json.dumps(res)


def test_no_card_no_result():
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "-m", "cmbbench.run", "--workload", "tt2048.sim",
         "--seed", str(2 ** 31 + 11), "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.cuda
def test_card_run_is_correct():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "-m", "cmbbench.run", "--workload", "tt2048.cross",
         "--seed", str(2 ** 31 + 13), "--seconds", "2", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
