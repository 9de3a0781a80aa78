"""A cell on several cards: one rank process per card, one window for all.

:func:`launch` is what ``python3 -m cmbbench.run`` does for a cell whose
``chips`` is S > 1. It writes the run's spec to a temporary directory,
starts S processes of ``python3 -m cmbbench.launch --spec <file> --rank
<r>`` from the checkout's root and supervises them. Each rank
(:func:`rank_main`) dies with the launcher, checks that there are S cards
(exit 2 where not), sets its card, joins an NCCL world through the
port's ``parallel.init_multihost`` (``127.0.0.1`` and a port the launcher
picked, bounded by the group's ``timeout``), so that an entry's
``get_mesh()`` finds it, and opens a gloo group on the host for the
harness alone. It then runs :func:`cmbbench.run.run_cell` with a
:class:`Ranks`: every rank builds the cell from the same seed through the
entry's ``build``, so the entry decides what its rank does, and every rank
runs the same steps. Rank 0's clock decides the window: every
:data:`CLOCK_EVERY` steps one host broadcast on the gloo group hands its
reading to all ranks (no device synchronize); the window opens and closes
at a synchronize and a barrier; with ``--trace 1`` every rank traces the
same steps. After the answers are checked, rank 0 gathers each rank's
readings and writes the result line that :func:`combine` makes of them.

A rank that raises, exits non-zero or loads JAX (exit 3) makes the
launcher stop the others and return that rank's exit code with no result;
no rank waits on a dead one past the group's ``timeout``.
"""
from __future__ import annotations

import argparse
import ctypes
import datetime
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from .run import REPO, _process_start, forbidden_modules, run_cell

__all__ = ["launch", "combine", "Ranks", "rank_main", "RANK_COMMAND"]

RANK_COMMAND = (sys.executable, "-m", "cmbbench.launch")
GROUP_TIMEOUT_S = 300     # bounds every collective of a rank's two groups
STOP_GRACE_S = 10         # SIGTERM to SIGKILL when a rank has failed
# steps between two readings of rank 0's clock: read at every step, the
# host broadcast held four ranks of a 2 ms step to 91-99 % of four times
# one card's rate on a four-H100 host (the hosts, not the cards, set the
# pace); every 16 steps, to 99.7-100 %
CLOCK_EVERY = 16
_PR_SET_PDEATHSIG = 1


def _free_port():
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _supervise(procs):
    """Wait until every rank has exited 0 (returns 0) or one has failed
    (returns its exit code, 1 for a signal)."""
    while True:
        codes = [p.poll() for p in procs]
        bad = [c for c in codes if c not in (None, 0)]
        if bad:
            return bad[0] if bad[0] > 0 else 1
        if all(c == 0 for c in codes):
            return 0
        time.sleep(0.05)


def _stop(procs):
    """End every rank still running and wait for each."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.monotonic() + STOP_GRACE_S
    for p in procs:
        try:
            p.wait(max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def launch(bench, wl, cfg, traffic, seed, seconds, trace, device="cuda",
           command=RANK_COMMAND, timeout=GROUP_TIMEOUT_S):
    """Run the cell as ``wl["chips"]`` ranks; returns ``(exit code,
    result line's dict or None)``. ``device="cpu"`` runs the ranks on the
    host over gloo (the tests); ``command`` starts one rank when given
    ``--spec <file> --rank <r>``."""
    size = int(wl["chips"])
    with tempfile.TemporaryDirectory(prefix="cmbbench_ranks_") as tmp:
        out = Path(tmp) / "result.json"
        spec = Path(tmp) / "spec.json"
        spec.write_text(json.dumps({
            "bench": bench, "wl": wl, "cfg": cfg, "traffic": traffic,
            "seed": seed, "seconds": seconds, "trace": trace,
            "device": device, "size": size, "timeout": timeout,
            "init": f"tcp://127.0.0.1:{_free_port()}",
            "launcher_pid": os.getpid(), "out": str(out)}))
        procs = []
        try:
            for r in range(size):
                procs.append(subprocess.Popen(
                    [*command, "--spec", str(spec), "--rank", str(r)],
                    cwd=REPO, stdin=subprocess.DEVNULL, stdout=2))
            code = _supervise(procs)
        finally:
            _stop(procs)
        if code:
            return code, None
        return 0, json.loads(out.read_text())


def combine(parts):
    """The result line of a run from its ranks' ``{"result", "window_s"}``,
    in rank order: attempts and failures summed, ``sims_per_s`` the summed
    units over rank 0's window, ``step_ms_p95`` and ``peak_mem_gib`` the
    largest rank's, ``setup_s`` rank 0's (from the launcher's start),
    ``correct`` every rank's, each compared number the worst rank's;
    ``device``'s ``count`` the ranks, ``memory_peak_bytes`` the largest,
    a traced run's ``busy_s`` and ``window_s`` the ranks' mean; a traced
    run's per-layer metrics and breakdown are rank 0's."""
    res = [p["result"] for p in parts]
    first = res[0]
    units = sum(r["attempted"] for r in res)

    def largest(k):
        return max(r["metrics"][k]["value"] for r in res)

    rule = {"sims_per_s": lambda k: units / parts[0]["window_s"],
            "step_ms_p95": largest, "peak_mem_gib": largest}
    metrics = {k: ({**m, "value": rule[k](k)} if k in rule else m)
               for k, m in first["metrics"].items()}
    device = {**first["device"], "count": len(res),
              "memory_peak_bytes": max(r["device"]["memory_peak_bytes"]
                                       for r in res)}
    for key in ("busy_s", "window_s"):
        if key in device:
            device[key] = sum(r["device"][key] for r in res) / len(res)
    out = {"correct": all(r["correct"] for r in res), "attempted": units,
           "failed": sum(r["failed"] for r in res), "metrics": metrics,
           "device": device}
    if "breakdown" in first:
        out["breakdown"] = first["breakdown"]
    out["checked"] = {}
    for key, c in first["checked"].items():
        vals = [r["checked"][key]["value"] for r in res]
        out["checked"][key] = {"value": None if None in vals else max(vals),
                               "limit": c["limit"]}
    return out


class Ranks:
    """What :func:`~cmbbench.run.run_cell` needs of the other ranks: this
    rank's ``index`` and the ``size``, ``started`` (the launcher's start
    on this process's ``perf_counter`` clock), and the collectives of the
    harness's gloo group."""

    def __init__(self, index, size, group, started):
        self.index, self.size, self.group = index, size, group
        self.started = started
        self.now = 0.0

    def clock(self, now, steps):
        """Rank 0's reading of the window's clock after ``steps`` steps: one
        host broadcast every :data:`CLOCK_EVERY` steps, the last reading
        held between them, so that every rank decides alike at the same
        steps and no rank waits on the others at every step."""
        if steps % CLOCK_EVERY == 0:
            import torch
            import torch.distributed as dist
            t = torch.tensor([now], dtype=torch.float64)
            dist.broadcast(t, src=0, group=self.group)
            self.now = float(t[0])
        return self.now

    def barrier(self):
        import torch.distributed as dist
        dist.barrier(group=self.group)

    def result(self, result, window_s):
        """Rank 0: the run's result line (:func:`combine` of every rank's
        ``result`` and ``window_s``); the other ranks: None."""
        import torch.distributed as dist
        parts = [None] * self.size if self.index == 0 else None
        dist.gather_object({"result": result, "window_s": window_s}, parts,
                           dst=0, group=self.group)
        return combine(parts) if self.index == 0 else None


def _die_with(pid):
    """Have the kernel end this process when the launcher ``pid`` ends."""
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl(_PR_SET_PDEATHSIG, signal.SIGTERM, 0, 0, 0)
    except (OSError, AttributeError):
        pass
    if os.getppid() != pid:           # the launcher ended before the call
        sys.exit(1)


def rank_main(argv=None):
    """One rank of :func:`launch`."""
    ap = argparse.ArgumentParser(prog="python3 -m cmbbench.launch")
    ap.add_argument("--spec", required=True)
    ap.add_argument("--rank", type=int, required=True)
    args = ap.parse_args(argv)
    spec = json.loads(Path(args.spec).read_text())
    _die_with(spec["launcher_pid"])
    rank, size, device = args.rank, spec["size"], spec["device"]
    log = lambda s: print(f"[rank {rank}] {s}", file=sys.stderr, flush=True)
    import torch
    import torch.distributed as dist

    from orphics_tpu_torch.parallel import init_multihost
    torch.set_num_threads(4)
    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < size:
            log(f"cmbbench: {spec['wl']['name']} needs {size} CUDA "
                f"device(s); torch.cuda.is_available() is "
                f"{torch.cuda.is_available()}")
            return 2
        torch.cuda.set_device(rank)
    init_multihost(init_method=spec["init"], world_size=size, rank=rank,
                   local_rank=rank, device=device, timeout=spec["timeout"])
    group = dist.new_group(backend="gloo", timeout=datetime.timedelta(
        seconds=spec["timeout"]))
    ranks = Ranks(rank, size, group, _process_start(spec["launcher_pid"]))
    result = run_cell(spec["bench"], spec["wl"], spec["cfg"],
                      spec["traffic"], spec["seed"], spec["seconds"],
                      spec["trace"], device, log, ranks=ranks)
    bad = forbidden_modules()
    if bad:
        log(f"cmbbench: loaded in a rank's process: {bad}")
        return 3
    if rank == 0:
        part = Path(spec["out"] + ".part")
        part.write_text(json.dumps(result))
        os.replace(part, spec["out"])
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(rank_main())
