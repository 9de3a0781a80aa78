"""The port's own spans in a traced stretch: each device operation tied to
the stage of the program that launched it.

The port enters a ``record_function`` range named ``orphics.<stage or
layer>.<name>`` at its stage boundaries (``models/fastcl.py``,
``models/lenspipe.py``, ``models/qe.py``) and around its ops wrappers
(``orphics.transforms.*``, ``orphics.binning.*``, ``orphics.lens.*``, the
layer spans) while a profiler runs. Kineto writes those ranges
(``user_annotation``), the CUDA runtime and driver calls and the device
operations on one clock. Each kernel, copy and fill carries the
``correlation`` id of the runtime call that launched it; the launch lies
inside the spans open on its thread at that moment, innermost last.

:func:`read` gives, a step, per span name and in total:

* ``launches_per_step``: device operations launched inside the outermost
  program spans (an ``orphics.*`` span no other one encloses);
* ``program_host_ms``: host ms of the outermost program spans less the
  runtime and driver calls inside them (a wait in a full launch queue is
  such a call);
* ``algebra_self_ms``: device ms of operations launched inside program
  spans but inside no layer span;
* ``qe_device_ms``: device ms launched inside an ``orphics.qe.*`` span;
* ``idle_in_program``: % of the device window (first device operation to
  the end of the last) in which no device operation runs while the host is
  inside an outermost program span.

``python3 -m cmbbench.spans --workload <cell> --seed <n> --seconds <s>``
runs the cell's traced run of ``cmbbench.run`` with these readings added,
and the checks of the spans against the families of ``trace.py``, the
ops wrappers' ``.launches`` counters and the launch order; one JSON line
on standard output.
"""
from __future__ import annotations

import argparse
import bisect
import json
import re
import sys
from pathlib import Path

__all__ = ["read", "attribute", "launch_check", "traced_run", "PROGRAM",
           "LAYERS", "ESTIMATOR"]

PROGRAM = "orphics."
LAYERS = ("orphics.transforms.", "orphics.binning.", "orphics.lens.")
ESTIMATOR = "orphics.qe."
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_PER_SPAN = ("calls", "host_ms", "device_ms", "launches", "self_ms",
             "self_launches")


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap(a, b):
    """Length of the intersection of two merged, sorted interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _parse(events):
    """``(spans, launches, device)``: the program's spans ``[thread, start,
    end, name]``, the runtime and driver calls ``[thread, start, end,
    correlation]`` and the device operations ``[start, end, name,
    correlation]`` of a Chrome trace's events, in microseconds."""
    spans, launches, device = [], [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = ev.get("cat", "")
        s = float(ev["ts"])
        e = s + float(ev["dur"])
        name = ev.get("name", "")
        corr = (ev.get("args") or {}).get("correlation")
        if cat in _DEVICE_CATS:
            device.append((s, e, name, corr))
        elif cat in _LAUNCH_CATS:
            launches.append(((ev.get("pid"), ev.get("tid")), s, e, corr))
        elif cat == "user_annotation" and name.startswith(PROGRAM):
            spans.append(((ev.get("pid"), ev.get("tid")), s, e, name))
    return spans, launches, device


def _enclosing(spans, launches):
    """Per launch, the indices into ``spans`` of the spans on its thread
    whose interval holds its start, outermost first; and per span whether
    it is outermost."""
    by_thread = {}
    for k, sp in enumerate(spans):
        by_thread.setdefault(sp[0], ([], []))[0].append(k)
    for k, ln in enumerate(launches):
        by_thread.setdefault(ln[0], ([], []))[1].append(k)
    chains = [()] * len(launches)
    outer = [False] * len(spans)
    for sidx, lidx in by_thread.values():
        # outer spans first where two start together
        sidx.sort(key=lambda k: (spans[k][1], -spans[k][2]))
        lidx.sort(key=lambda k: launches[k][1])
        stack, j = [], 0
        for k in lidx:
            t = launches[k][1]
            while j < len(sidx) and spans[sidx[j]][1] <= t:
                s = spans[sidx[j]][1]
                while stack and spans[stack[-1]][2] <= s:
                    stack.pop()
                outer[sidx[j]] = not stack
                stack.append(sidx[j])
                j += 1
            while stack and spans[stack[-1]][2] <= t:
                stack.pop()
            chains[k] = tuple(stack)
        for k in sidx[j:]:
            s = spans[k][1]
            while stack and spans[stack[-1]][2] <= s:
                stack.pop()
            outer[k] = not stack
            stack.append(k)
    return chains, outer


def attribute(events):
    """``(spans, outer, launches, ops)``: the program's spans and whether
    each is outermost, the runtime and driver calls, and per device
    operation ``(start, end, name, chain,
    launch_start)``: ``chain`` the indices of the spans open on the
    launching thread at its launch, outermost first (empty outside every
    span), ``launch_start`` None where the trace holds no launching
    call."""
    spans, launches, device = _parse(events)
    chains, outer = _enclosing(spans, launches)
    by_corr = {ln[3]: k for k, ln in enumerate(launches)
               if ln[3] is not None}
    ops = []
    for s, e, name, corr in device:
        k = by_corr.get(corr)
        if k is None:
            ops.append((s, e, name, (), None))
        else:
            ops.append((s, e, name, chains[k], launches[k][1]))
    return spans, outer, launches, ops


def read(events, steps):
    """The spans' readings of a traced stretch of ``steps`` steps (see the
    module's docstring), or None where it holds no device operation.
    ``spans``: per span name, a step, ``calls``, ``host_ms`` (its
    intervals), ``device_ms`` and ``launches`` (launched inside it, nested
    spans included) and ``self_ms`` / ``self_launches`` (where it is the
    innermost). ``unspanned_ms``: device ms a step launched outside every
    span, or by no call in the trace (``unlinked`` operations);
    ``early``: operations that start before their launching call, and
    ``early_max_us`` the most by which one does."""
    spans, outer, launches, ops = attribute(events)
    if not ops:
        return None
    per = max(int(steps), 1)
    names = {}
    for _, s, e, name in spans:
        d = names.setdefault(name, dict.fromkeys(_PER_SPAN, 0))
        d["calls"] += 1
        d["host_ms"] += e - s
    total = unspanned = algebra = qe = 0.0
    launched = unlinked = early = 0
    lead = 0.0
    for s, e, _, chain, t_launch in ops:
        dur = e - s
        total += dur
        if t_launch is None:
            unlinked += 1
        elif s < t_launch:
            early += 1
            lead = max(lead, t_launch - s)
        if not chain:
            unspanned += dur
            continue
        launched += 1
        inside = {spans[k][3] for k in chain}
        for name in inside:
            d = names[name]
            d["device_ms"] += dur
            d["launches"] += 1
        d = names[spans[chain[-1]][3]]
        d["self_ms"] += dur
        d["self_launches"] += 1
        if not any(n.startswith(LAYERS) for n in inside):
            algebra += dur
        if any(n.startswith(ESTIMATOR) for n in inside):
            qe += dur

    # host: outermost spans less the runtime and driver calls inside them
    calls = {}
    for thread, s, e, _ in launches:
        calls.setdefault(thread, []).append((s, e))
    calls = {t: _merge(v) for t, v in calls.items()}
    starts = {t: [iv[0] for iv in v] for t, v in calls.items()}
    host = 0.0
    program = []
    for k, (thread, s, e, _) in enumerate(spans):
        if not outer[k]:
            continue
        program.append((s, e))
        host += e - s
        ivs = calls.get(thread, [])
        i = max(bisect.bisect_right(starts.get(thread, []), s) - 1, 0)
        while i < len(ivs) and ivs[i][0] < e:
            lo, hi = max(ivs[i][0], s), min(ivs[i][1], e)
            if hi > lo:
                host -= hi - lo
            i += 1

    busy = _merge([(s, e) for s, e, _, _, _ in ops])
    t0, t1 = busy[0][0], busy[-1][1]
    program = _merge(program)
    idle_prog = (_overlap([[t0, t1]], program) - _overlap(busy, program))
    ms = lambda us: us * 1e-3 / per
    return {
        "steps": steps,
        "launches_per_step": launched / per,
        "program_host_ms": ms(host),
        "algebra_self_ms": ms(algebra),
        "qe_device_ms": ms(qe),
        "idle_in_program": (100.0 * idle_prog / (t1 - t0) if t1 > t0
                            else 0.0),
        "device_ms": ms(total),
        "unspanned_ms": ms(unspanned),
        "unlinked": unlinked,
        "early": early,
        "early_max_us": lead,
        "spans": {name: {k: ms(v) if k.endswith("_ms") else v / per
                         for k, v in d.items()}
                  for name, d in sorted(names.items())},
    }


# ---- the traced run with the spans read too ------------------------------

# the port's hand kernels by name: the patterns of the families outside
# the model algebra, less cuFFT's generic ones
_CUFFT = ("fft", "FFT", "radix", "Radix")


def _hand_kernels():
    pats = []
    for p in sorted((Path(__file__).parent / "families").glob("*.json")):
        spec = json.loads(p.read_text())
        if spec["layer"] != "model algebra":
            pats += [q for q in spec["patterns"] if q not in _CUFFT]
    return re.compile("|".join(re.escape(q) for q in pats))


# the wrapper spans that move each ``.launches`` counter
_COUNTED = {"rowpower.rowqc_half": ("rowqc_half", "rowqc_pp"),
            "rowpower.rows_half": ("rows_half", "rows_pp")}


def launch_check(events, before, after, steps):
    """Per ``.launches`` counter that moved or whose wrapper launched a hand
    kernel in the stretch, a step: the counter's delta, the calls of its
    wrapper spans that launched a hand kernel, and the hand kernels they
    launched."""
    spans, _, _, ops = attribute(events)
    hand = _hand_kernels()
    per = max(int(steps), 1)
    span_calls, kernels = {}, {}
    for _, _, name, chain, _ in ops:
        if not chain or not hand.search(name):
            continue
        k = chain[-1]
        short = spans[k][3].rsplit(".", 1)[-1]
        kernels[short] = kernels.get(short, 0) + 1
        span_calls.setdefault(short, set()).add(k)
    out = {}
    keys = set(before) | set(after)
    for key in sorted(keys):
        delta = after.get(key, 0) - before.get(key, 0)
        wraps = _COUNTED.get(key, (key.split(".", 1)[1],))
        calls = sum(len(span_calls.get(w, ())) for w in wraps)
        kern = sum(kernels.get(w, 0) for w in wraps)
        if delta or calls:
            out[key] = {"counter": delta / per, "span_calls": calls / per,
                        "hand_kernels": kern / per}
    counted = {w for key in keys
               for w in _COUNTED.get(key, (key.split(".", 1)[1],))}
    for short in sorted(set(kernels) - counted):
        out["uncounted." + short] = {"counter": None,
                                     "span_calls": len(span_calls[short])
                                     / per,
                                     "hand_kernels": kernels[short] / per}
    return out


class _Written:
    """A profile already written out, as :meth:`Tracer.read` takes it."""

    def __init__(self, text):
        self.text = text

    def export_chrome_trace(self, path):
        Path(path).write_text(self.text)


def traced_run(bench, wl, cfg, traffic, seed, seconds, device, log):
    """The cell's traced run (``run.run_cell`` with ``--trace 1``), its
    result line with ``spans`` (:func:`read`) and ``checks`` added:
    the families' device ms a step against the spans' and the unspanned,
    :func:`launch_check` over the traced steps, the operations with no
    launching call or that start before it, and ``idle_gaps``. The
    harness's :class:`~cmbbench.trace.Tracer` reads as it does in every
    traced run; a subclass reads the spans from the same trace."""
    from . import run, trace
    kept = {}

    class SpanTracer(trace.Tracer):
        def start(self):
            self.before = run._launch_counts()
            super().start()

        def stop(self, steps):
            super().stop(steps)
            self.after = run._launch_counts()

        def read(self):
            # kineto writes a trace once: hand the written text on to the
            # harness's reading
            self.done.export_chrome_trace(str(self.path))
            text = self.path.read_text()
            self.done = _Written(text)
            out = super().read()
            events = json.loads(text).get("traceEvents", [])
            kept.update(trace=out or {}, spans=read(events, self.steps),
                        launches=launch_check(events, self.before,
                                              self.after, self.steps))
            return out

    plain = trace.Tracer
    trace.Tracer = SpanTracer
    try:
        result = run.run_cell(bench, wl, cfg, traffic, seed, seconds, 1,
                              device, log)
    finally:
        trace.Tracer = plain
    t = kept.get("trace", {})
    sp = kept.get("spans") or {}
    result["spans"] = sp
    result["checks"] = {
        "family_ms_total": sum(t.get("family_ms", {}).values()),
        "spans_plus_unspanned_ms": (sum(d["self_ms"] for d in
                                        sp.get("spans", {}).values())
                                    + sp.get("unspanned_ms", 0.0)),
        "launches": kept.get("launches"),
        "early": sp.get("early"), "early_max_us": sp.get("early_max_us"),
        "unlinked": sp.get("unlinked"),
        "idle_gaps": t.get("idle_gaps")}
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m cmbbench.spans")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch

    from .run import load_cell
    bench, wl, cfg, traffic = load_cell(args.workload)
    torch.set_num_threads(4)
    if not torch.cuda.is_available():
        print("cmbbench.spans: no CUDA device", file=sys.stderr)
        return 2
    result = traced_run(bench, wl, cfg, traffic, args.seed, args.seconds,
                        "cuda", lambda s: print(s, file=sys.stderr,
                                                flush=True))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
