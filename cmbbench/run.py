"""Run one cell of the benchmark once on its cards.

    python3 -m cmbbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell, its configuration and its traffic
are found by name through ``BENCHMARK.json``: ``configs/<config>.json``,
``traffic/<traffic>.json``, the entry module ``entries/<entry>.py`` the
traffic names, and with ``--trace 1`` one reader ``layer_metrics/<metric>.py``
per per-layer metric. In order: import the port and load its kernels
(built into the checkout on first use), build the cell's objects and held
inputs on the card from the seed, warm up the cell's own shapes, run the
closed loop for ``--seconds`` (each step enqueued when the host returns
from the last, no per-step synchronize), check a sample of the window's
answers against the plain reference, and print one JSON line last on
standard output. The compared numbers and their limits are the last lines
on standard error and the last key of that line.

A cell of one card runs in this process, with no process group. A cell of
``chips`` S > 1 runs as S rank processes, one a card, that this process
starts and supervises (:mod:`cmbbench.launch`): each rank builds the cell
from the same seed in one NCCL world, every rank runs the same steps, and
rank 0's clock ends the window. Its line sums the ranks' units, attempts
and failures, takes the largest rank's ``step_ms_p95`` and peak, and
counts ``setup_s`` from this process's start.

With ``--trace 0`` the line carries the end-to-end metrics: ``sims_per_s``
(units over the window, from a synchronize before the first step to the
synchronize after the last), ``step_ms_p95`` (95th percentile of the gaps
between CUDA events recorded after each step), ``peak_mem_gib`` (peak
allocated over the window, held inputs included) and ``setup_s`` (process
start to the window's start). With ``--trace 1`` it carries the per-layer
metrics, read from ``torch.profiler`` over part of the window, and
``breakdown``.

No card, or fewer than the cell asks for: exit 2 with no result. A JAX
module loaded in this process (or in a rank's) once the window has
closed: exit 3 with no result. A rank that fails: its exit code, no
result.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
WARMUP_STEPS = 3
TRACE_AFTER_S = 0.25    # the traced stretch starts this share into the window
TRACE_FOR_S = 1.5       # and takes as many steps as this many seconds hold
DISPATCH_STEPS = 30
FORBIDDEN = ("jax", "jaxlib", "flax", "orphics_tpu")
GIB = float(2 ** 30)

__all__ = ["main", "run_cell", "load_cell", "Readings"]


def _uptime_since_start(pid="self"):
    """Seconds since process ``pid`` started (the kernel's boot clock), or
    None where ``/proc`` does not say."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


_IMPORTED = time.perf_counter()


def _process_start(pid="self"):
    """The start of process ``pid`` (this one by default) on this process's
    ``perf_counter`` clock (the harness's import where ``/proc`` does not
    say)."""
    since = _uptime_since_start(pid)
    return _IMPORTED if since is None else time.perf_counter() - since


def load_cell(name, bench_path=REPO / "BENCHMARK.json"):
    """``(bench, workload, config, traffic)`` dicts of the cell ``name``."""
    bench = json.loads(Path(bench_path).read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"cmbbench: no workload {name!r} in {bench_path}")
    wl = cells[name]
    confs = {c["name"]: c for c in bench["configs"]}
    cfg = json.loads((REPO / confs[wl["config"]]["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{wl['traffic']}.json")
                         .read_text())
    return bench, wl, cfg, traffic


def metric_reader(name):
    """The ``read`` function of ``layer_metrics/<name>.py``."""
    path = HERE / "layer_metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "cmbbench.layer_metrics._" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench, cell, kind):
    """The ``end_to_end`` or ``per_layer`` metrics the cell reports."""
    return [m for m in bench[kind]
            if cell in m.get("workloads", [cell])]


class Readings:
    """What a per-layer reader reads: ``trace`` (:meth:`Tracer.read`),
    ``work`` (the entry's least work a step per layer) and
    ``dispatch_ms``."""

    def __init__(self, trace, work, dispatch_ms):
        self.trace = trace
        self.work = work
        self.dispatch_ms = dispatch_ms


def _power_limit():
    """The card's power limit in W from ``nvidia-smi``, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return None


def _launch_counts():
    """The port's per-wrapper launch counters, where they are non-zero."""
    out = {}
    for modname in ("dft", "bin_reduce", "lens", "noise_planes", "mirror",
                    "rowpower", "legendre", "qe_conv"):
        mod = sys.modules.get("orphics_tpu_torch.ops." + modname)
        if mod is None:
            continue
        for key, fn in vars(mod).items():
            n = getattr(fn, "launches", 0)
            if callable(fn) and isinstance(n, int) and n:
                out[f"{modname}.{key}"] = n
    return out


def run_cell(bench, wl, cfg, traffic, seed, seconds, trace, device,
             log=print, ranks=None):
    """Run the cell once; returns the result line's dict (``checked``
    last). With ``ranks`` (a :class:`cmbbench.launch.Ranks`) this process
    is one rank of a multi-card run: set-up counts from the launcher's
    start, rank 0's clock ends the window, and rank 0 returns the line of
    all ranks (the others None)."""
    import numpy as np
    import torch

    from .entries import scaled_error
    from .generate import Feed, subseed
    from .reference.flat import Prec
    from .theory import load_tables
    from .trace import Tracer

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    started = _process_start() if ranks is None else ranks.started
    phases = [("start", time.perf_counter() - started)]

    def mark(what):
        sync()
        phases.append((what, time.perf_counter() - started))

    if cuda:
        torch.zeros(1, device=device)
        mark("card")
        from orphics_tpu_torch import _build
        _build.library()
        mark("kernels")
    tables = load_tables(cfg["theory"]["root"], cfg["theory"]["lpad"])
    feed = Feed(cfg, traffic, tables, seed, device)
    mark("inputs")
    entry = importlib.import_module(
        f"cmbbench.entries.{traffic['entry']}").build(cfg, traffic, tables,
                                                      feed, device)
    mark("program")
    i = 0
    for _ in range(WARMUP_STEPS):
        entry.step(i)
        i += 1
    mark("warm-up")
    log("cmbbench: set-up s since the process started: " + ", ".join(
        f"{k} {v:.3f}" for k, v in phases))
    rng = np.random.default_rng(subseed(seed, "check"))
    keep_every = traffic["keep_every"]
    offset = int(rng.integers(keep_every))
    tracer = None
    if trace:
        # pay the profiler's start-up here, not in the window
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            entry.step(i)
            i += 1
            sync()
        tracer = Tracer(Path(tempfile.gettempdir())
                        / f"cmbbench_trace_{os.getpid()}.json")
    trace_from = TRACE_AFTER_S * seconds
    traced_from = trace_steps = None
    if cuda:
        torch.cuda.reset_peak_memory_stats()
        marks = [torch.cuda.Event(enable_timing=True)]
    sync()
    if ranks is not None:
        ranks.barrier()
    setup_s = time.perf_counter() - started
    t0 = time.perf_counter()
    if cuda:
        marks[0].record()
    first = i
    kept = {}
    while True:
        out = entry.step(i)
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
        if (i - first) % keep_every == offset:
            kept[i] = out
        i += 1
        now = time.perf_counter() - t0
        if ranks is not None:
            now = ranks.clock(now, i - first)
        if tracer is not None:
            if traced_from is None and now >= trace_from:
                # the stretch: as many steps as take TRACE_FOR_S so far
                trace_steps = max(20, int(TRACE_FOR_S * (i - first) / now))
                tracer.start()
                traced_from = i
            elif (tracer.prof is not None
                  and i - traced_from >= trace_steps):
                tracer.stop(i - traced_from)
        if now >= seconds and (tracer is None or tracer.prof is None):
            break
    if tracer is not None and tracer.prof is not None:
        tracer.stop(i - traced_from)
    sync()
    if ranks is not None:
        ranks.barrier()
    window_s = time.perf_counter() - t0
    nsteps = i - first
    units = nsteps * entry.units
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    e2e = {"sims_per_s": units / window_s, "setup_s": setup_s,
           "peak_mem_gib": peak / GIB}
    if cuda:
        gaps = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        e2e["step_ms_p95"] = float(np.percentile(gaps, 95))
        log(f"cmbbench: {nsteps} steps of {entry.units} in {window_s:.4f} s; "
            f"step ms median {np.median(gaps):.4f}, p95 "
            f"{e2e['step_ms_p95']:.4f}, max {max(gaps):.4f}")
    readings = None
    if trace:
        times = []
        for _ in range(DISPATCH_STEPS):
            sync()
            t = time.perf_counter()
            entry.step(i)
            times.append(time.perf_counter() - t)
            i += 1
        sync()
        readings = Readings(tracer.read() if traced_from is not None else
                            None, entry.work(), 1e3 * float(np.mean(times)))
        log("cmbbench: launches over the run " + json.dumps(_launch_counts()))
        if readings.trace:
            log("cmbbench: device ms a step by family "
                + json.dumps(readings.trace["family_ms"]))
    entry.release()
    del out
    if cuda:
        torch.cuda.empty_cache()

    # the window's answers against the plain reference
    check = traffic["check"]
    items = entry.sample(sorted(kept), rng, check["sample"])
    errs = [scaled_error(entry.answer(kept[s], j),
                         *entry.reference(s, j, Prec("float64")))
            for s, j in items]
    limit = check["limit"]
    worst = max(errs) if errs else float("inf")
    failed = (sum(not e <= limit for e in errs) if limit is not None
              else len(errs))
    correct = bool(errs) and limit is not None and failed == 0
    name = check["name"]
    log(f"cmbbench: {len(errs)} sampled answers, errors "
        + ", ".join(f"{e:.3e}" for e in errs))

    result = {"correct": correct, "attempted": units, "failed": failed}
    if trace:
        metrics = {}
        for m in cell_metrics(bench, wl["name"], "per_layer"):
            v = metric_reader(m["name"])(readings)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result["metrics"] = metrics
    else:
        result["metrics"] = {m["name"]: {"value": e2e[m["name"]],
                                         "unit": m["unit"]}
                             for m in cell_metrics(bench, wl["name"],
                                                   "end_to_end")
                             if m["name"] in e2e}
    result["device"] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": 1, "memory_peak_bytes": int(peak),
        "power_limit_w": _power_limit() if cuda else None}
    if trace and readings.trace:
        result["device"]["busy_s"] = readings.trace["busy_s"]
        result["device"]["window_s"] = readings.trace["window_s"]
        result["breakdown"] = {"device_ops": readings.trace["device_ops"],
                               "idle_gaps": readings.trace["idle_gaps"]}
    result["checked"] = {name: {"value": worst if np.isfinite(worst)
                                else None, "limit": limit}}
    if ranks is not None:
        return ranks.result(result, window_s)
    return result


def forbidden_modules():
    """Loaded modules whose top-level name is a JAX package or the JAX
    port's reference package."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m cmbbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every cache the run writes lives at a fixed path inside the checkout
    cache = REPO / ".cmbbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    bench, wl, cfg, traffic = load_cell(args.workload)
    if wl["chips"] > 1:
        # the ranks check the cards; this process imports no torch, so
        # that they start at once
        from .launch import launch
        code, result = launch(bench, wl, cfg, traffic, args.seed,
                              args.seconds, args.trace)
        if code:
            print(f"cmbbench: a rank of {wl['name']} exited {code}; no "
                  "result", file=sys.stderr)
            return code
    else:
        import torch
        torch.set_num_threads(4)
        if not torch.cuda.is_available() or (torch.cuda.device_count()
                                             < wl["chips"]):
            print(f"cmbbench: {wl['name']} needs {wl['chips']} CUDA "
                  f"device(s); torch.cuda.is_available() is "
                  f"{torch.cuda.is_available()}", file=sys.stderr)
            return 2
        log = lambda s: print(s, file=sys.stderr, flush=True)
        result = run_cell(bench, wl, cfg, traffic, args.seed, args.seconds,
                          args.trace, "cuda", log)
    bad = forbidden_modules()
    if bad:
        print(f"cmbbench: loaded in the measuring process: {bad}",
              file=sys.stderr)
        return 3
    for key, c in result["checked"].items():
        print(f"{key} {c['value']} limit {c['limit']}", file=sys.stderr,
              flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
