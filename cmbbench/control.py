"""The control of a cell's output check: the plain reference put in the
program's place and computed in bfloat16 (float32 arithmetic, every
stage rounded to bfloat16: the precision below the configurations'
float32), judged by the same comparison with the float64 reference.

    python3 -m cmbbench.control --workload <cell> --seeds 11,12,13 \
        [--steps 1000]

For each seed it builds the cell's inputs as a run does, samples the
traffic's ``check.sample`` answers among the first ``--steps`` steps of a
window by the run's rule, and prints the largest scaled error the control
reads, then one JSON line with every seed's reading. A control that reads
no more than the cell's limit would pass a lower precision: the check has
to fail it.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys

from .run import load_cell

__all__ = ["control_errors"]


def control_errors(cfg, traffic, seed, device, steps=1000, first=3):
    """Scaled errors of the bfloat16 control on the sampled answers of a
    run of ``steps`` steps."""
    import numpy as np

    from .entries import scaled_error
    from .generate import Feed, subseed
    from .reference.flat import Prec
    from .theory import load_tables

    tables = load_tables(cfg["theory"]["root"], cfg["theory"]["lpad"])
    feed = Feed(cfg, traffic, tables, seed, device)
    entry = importlib.import_module(
        f"cmbbench.entries.{traffic['entry']}").build(cfg, traffic, tables,
                                                      feed, device)
    entry.release()
    rng = np.random.default_rng(subseed(seed, "check"))
    every = traffic["keep_every"]
    offset = int(rng.integers(every))
    kept = [first + k for k in range(steps) if k % every == offset]
    items = entry.sample(kept, rng, traffic["check"]["sample"])
    errs = []
    for s, j in items:
        ctrl, _ = entry.reference(s, j, Prec("bfloat16"))
        ref, scale = entry.reference(s, j, Prec("float64"))
        errs.append(scaled_error(ctrl, ref, scale))
    return errs


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m cmbbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    _, wl, cfg, traffic = load_cell(args.workload)
    out = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        errs = control_errors(cfg, traffic, seed, args.device, args.steps)
        out[seed] = max(errs)
        print(f"{wl['name']} seed {seed}: control "
              f"{traffic['check']['name']} {max(errs):.6e} (min "
              f"{min(errs):.6e} over {len(errs)} answers), limit "
              f"{traffic['check']['limit']}", flush=True)
    print(json.dumps({"workload": wl["name"], "control": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
