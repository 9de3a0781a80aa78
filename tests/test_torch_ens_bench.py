"""The benchmark cell ``lensqe512.ens.x4`` on the CPU: a lensing Monte Carlo
campaign as four ranks of one gloo world run it through ``cmbbench.launch``
(``ensemble_stats``' batched form over ``LensedQEPipeline.step_kappa``,
float64 moments and the kappa stack all-reduced), held to the plain float64
campaign of ``cmbbench/reference/ensemble.py``; the bfloat16 control and
float32 moments, which the check must fail; the family and reader of ``allreduce_ms``; and the
cell's entries in ``BENCHMARK.json``.

Size: the full-plane path's smallest grid, 256^2 (the cell's 512^2 at the
same 2' pixels, cut for the CPU), 32 sims a campaign in chunks of 4 (8 a
rank), one sampled campaign checked. Each rank runs one thread, so that the
four share the CPU, and draws the card's Philox stream through the plain
noise planes (``cmbbench.tests.small.card_stream``), as the card does.
"""
import copy
import json
import subprocess
import sys
from pathlib import Path

import pytest

from cmbbench import launch as L
from cmbbench import run as R
from cmbbench import trace as bench_trace
from cmbbench.control import control_errors

REPO = Path(__file__).resolve().parent.parent
CELL = "lensqe512.ens.x4"
SIMS = 32
# one rank of the launcher's world on one thread
RANK = ("import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "torch.set_num_threads = lambda n: None\n"
        "from cmbbench.tests import cpu_rank\n"
        "sys.exit(cpu_rank.main(sys.argv[1:]))\n")


def _small(sims=SIMS):
    """The cell at 256^2, ``sims`` a campaign in chunks of 4, every step
    kept, one campaign checked."""
    bench, wl, cfg, traffic = R.load_cell(CELL)
    cfg = {**cfg, "n": 256,
           "ensemble": {**cfg["ensemble"], "sims": sims, "chunk": 4}}
    traffic = copy.deepcopy(traffic)
    traffic["keep_every"] = 1
    traffic["check"]["sample"] = 1
    return bench, wl, cfg, traffic


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The launcher's run of the small cell on four gloo ranks, and each
    rank's steps and world."""
    rec = tmp_path_factory.mktemp("ens")
    bench, wl, cfg, traffic = _small()
    assert wl["chips"] == 4
    code, res = L.launch(bench, wl, cfg, traffic, 2 ** 34 + 29, 0.3, 0,
                         device="cpu", command=(sys.executable, "-c", RANK,
                                                "--record", str(rec)),
                         timeout=120)
    records = ([json.loads((rec / f"rank{r}.json").read_text())
                for r in range(4)] if code == 0 else None)
    return code, res, records, traffic


def test_campaign_is_correct(four_ranks):
    """Every rank's reduced campaign agrees with the float64 reference
    within the cell's limit."""
    code, res, _, traffic = four_ranks
    assert code == 0
    got = res["checked"]["ens_err"]
    assert res["correct"] is True and res["failed"] == 0
    assert got["limit"] == traffic["check"]["limit"]
    assert got["value"] is not None and got["value"] <= got["limit"]


def test_units_are_the_campaigns_sims(four_ranks):
    """One campaign a step on every rank, its sims split over the world:
    the line's units are the steps times the campaign's sims."""
    code, res, records, _ = four_ranks
    assert code == 0
    steps = len(records[0]["steps"]) - R.WARMUP_STEPS
    assert all(r["steps"] == records[0]["steps"] for r in records)
    assert [r["mesh"] for r in records] == 4 * [[4, 4.0]]
    assert res["attempted"] == steps * SIMS
    assert res["device"]["count"] == 4


@pytest.fixture(scope="module")
def one_rank_campaign():
    """One campaign of the small cell on this process's one-rank mesh: the
    entry, its step's output and the reference's rows and scale."""
    import importlib

    from cmbbench.generate import Feed
    from cmbbench.reference.flat import Prec
    from cmbbench.tests.small import card_stream
    from cmbbench.theory import load_tables
    _, _, cfg, traffic = _small()
    mod = importlib.import_module("cmbbench.entries.lensqe_ens")
    with card_stream():
        tables = load_tables(cfg["theory"]["root"], cfg["theory"]["lpad"])
        feed = Feed(cfg, traffic, tables, 2 ** 40 + 7, "cpu")
        entry = mod.build(cfg, traffic, tables, feed, "cpu")
        out = entry.step(0)
        ref = entry.reference(0, 0, Prec("float64"))
    return mod, entry, out, ref, traffic["check"]["limit"]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_check_tells_the_moments_precision(one_rank_campaign, dtype):
    """The step's float64 moments pass the check, and its records folded
    into float32 accumulators fail it by the accumulation part alone (the
    step's moments against a two-pass float64 reduction of its records):
    against the reference, the pipeline's own float32 rounding hides
    theirs."""
    import torch

    from cmbbench.entries import scaled_error
    from orphics_tpu_torch.parallel.statistics import SuffStats
    mod, entry, (stats, records), (ref, scale), limit = one_rank_campaign
    x = torch.cat(records)
    nb = x.shape[-1]
    if dtype == "float32":
        stats = dict(stats)
        for j, k in enumerate(mod.LABELS):
            stats[k] = SuffStats.zeros(nb, True, torch.float32,
                                       "cpu").add(x[:, j])
    got = entry.answer((stats, records), 0)
    cut = got.size - 3 * nb - 3 * nb * nb
    main = scaled_error(got[:cut], ref[:cut], scale[:cut])
    acc = scaled_error(got[cut:], ref[cut:], scale[cut:])
    assert stats["cross"].ss.dtype == getattr(torch, dtype)
    assert main <= limit / 10
    if dtype == "float64":
        assert acc <= limit / 1e3
        assert scaled_error(got, ref, scale) <= limit
    else:
        assert acc > 100 * limit


def test_bfloat16_control_fails_the_limit():
    """The reference computed in bfloat16 reads above the limit (an
    8-sim campaign: the error is one of precision, not of size)."""
    _, _, cfg, traffic = _small(sims=8)
    errs = control_errors(cfg, traffic, 2 ** 35 + 1, "cpu", steps=1)
    assert len(errs) == 1
    assert errs[0] > traffic["check"]["limit"]


@pytest.mark.parametrize("module,allowed", [
    ("cmbbench.reference.ensemble", ()),
    ("cmbbench.entries.lensqe_ens", ("orphics_tpu_torch",))])
def test_reference_and_entry_import_no_jax(module, allowed):
    """The reference loads nothing of JAX, the JAX package or the port;
    the entry nothing of JAX or the JAX package (it imports the port
    inside its functions)."""
    code = (f"import sys, {module}\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(json.loads(out.stdout.strip().replace("'", '"')))
    bad = {t for t in tops if t in ("jax", "jaxlib", "orphics_tpu")
           or (t.startswith("orphics_tpu") and t not in allowed)}
    assert not bad


def test_collective_family_and_reader():
    """NCCL's kernels fall in the ``collective`` family and no other
    family's kernels do; ``allreduce_ms`` reads that family's device ms a
    step and nothing where the trace has none."""
    fams = bench_trace.families()
    names = [f for f, _, _ in fams]
    assert "collective" in names
    for kernel in ("ncclDevKernel_AllReduce_Sum_f64_RING_LL(ncclDevComm*, "
                   "unsigned long, ncclWork*)",
                   "ncclKernel_AllReduce_RING_LL_Sum_double"):
        assert bench_trace.family_of(kernel, fams) == "collective"
    for kernel in ("seg_sum_kernel", "lens_kernel", "vector_fft_512u",
                   "at::native::vectorized_elementwise_kernel"):
        assert bench_trace.family_of(kernel, fams) != "collective"
    read = R.metric_reader("allreduce_ms")
    assert read(R.Readings({"family_ms": {"collective": 0.25}}, {},
                           0.0)) == 0.25
    assert read(R.Readings({"family_ms": {"lens": 1.0}}, {}, 0.0)) is None
    assert read(R.Readings(None, {}, 0.0)) is None


def test_benchmark_lists_the_cell():
    """The configuration, the cell and ``allreduce_ms`` are the last of
    their lists; the configuration keeps every number of
    ``lens_qe_512``; at most one cell in four takes four cards."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    conf, cell = bench["configs"][-1], bench["workloads"][-1]
    metric = bench["per_layer"][-1]
    assert conf["name"] == "lens_qe_512_ens4" and conf["reduced"] == []
    assert (cell["name"], cell["config"], cell["chips"]) == (
        CELL, "lens_qe_512_ens4", 4)
    assert metric["name"] == "allreduce_ms"
    assert metric["workloads"] == [CELL] and metric["moves"] == "sims_per_s"
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)
    base = json.loads((REPO / "cmbbench/configs/lens_qe_512.json")
                      .read_text())
    ens = json.loads((REPO / conf["file"]).read_text())
    for k, v in base.items():
        if k not in ("name", "source", "assumed"):
            assert ens[k] == v, k
    assert ens["ensemble"]["ranks"] == cell["chips"]
