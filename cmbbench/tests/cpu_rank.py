"""One rank of a multi-card run on the CPU, for the launcher's tests.

    python -m cmbbench.tests.cpu_rank [--record DIR] [--fail R:STEP] \
        [--loads NAME] --spec <file> --rank <r>

Runs :func:`cmbbench.launch.rank_main` with the port's plain noise draws on
the card's stream (:func:`cmbbench.tests.small.card_stream`). ``--record``
writes to ``DIR/rank<r>.json`` the steps this rank's entry ran and the
world its ``get_mesh()`` found (the size, an all-reduce of ones);
``--fail R:STEP`` makes rank R's entry raise at step STEP; ``--loads
NAME`` puts an empty module ``NAME`` into rank 1's ``sys.modules``.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
import types
from pathlib import Path

from cmbbench import launch
from cmbbench.tests.small import card_stream


def _instrument(entry_module, rank, record, fail):
    """Wrap the entry's ``build``: note the world that ``get_mesh()`` finds
    (its size and an all-reduce of ones over it) and each step the entry
    runs, and raise at ``fail``'s step on its rank."""
    mod = importlib.import_module(f"cmbbench.entries.{entry_module}")
    build = mod.build

    def built(cfg, traffic, tables, feed, device):
        import torch

        from orphics_tpu_torch.parallel import get_mesh
        mesh = get_mesh(device=device)
        ones = torch.ones(1, device=mesh.device)
        record["mesh"] = [mesh.size, float(mesh.axis("sims").all_reduce(
            ones)[0])]
        entry = build(cfg, traffic, tables, feed, device)
        step = entry.step

        def counted(i):
            if fail is not None and fail == (rank, i):
                raise RuntimeError(f"rank {rank} fails at step {i} at "
                                   f"{time.time():.3f} s")
            record["steps"].append(i)
            return step(i)
        entry.step = counted
        return entry
    mod.build = built


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m cmbbench.tests.cpu_rank")
    ap.add_argument("--record")
    ap.add_argument("--fail")
    ap.add_argument("--loads")
    ap.add_argument("--spec", required=True)
    ap.add_argument("--rank", type=int, required=True)
    args = ap.parse_args(argv)
    spec = json.loads(Path(args.spec).read_text())
    fail = (None if args.fail is None
            else tuple(int(v) for v in args.fail.split(":")))
    record = {"steps": []}
    if args.loads and args.rank == 1:
        sys.modules[args.loads] = types.ModuleType(args.loads)
    _instrument(spec["traffic"]["entry"], args.rank, record, fail)
    with card_stream():
        code = launch.rank_main(["--spec", args.spec,
                                 "--rank", str(args.rank)])
    if args.record:
        (Path(args.record) / f"rank{args.rank}.json").write_text(
            json.dumps(record))
    return code


if __name__ == "__main__":
    sys.exit(main())
