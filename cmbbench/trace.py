"""The traced run's reading of the device: ``torch.profiler`` (CPU and CUDA
activity) over a steady stretch of the window with no per-step
synchronize, its Chrome trace read back for the kernel intervals.

Every kernel, copy and fill the card ran in the stretch is put in a family
by the name patterns of the files in ``families/`` (the lowest ``order``
that matches; ``other`` where none does). The device window runs from the
first recorded device operation to the end of the last; busy time is the
union of their intervals. An idle gap is named by the innermost host call
that was running at its middle.
"""
from __future__ import annotations

import json
import os
import re
from pathlib import Path

import numpy as np

__all__ = ["families", "Tracer"]

_HERE = Path(__file__).resolve().parent
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
              "python_function")


def families(folder=_HERE / "families"):
    """``[(name, layer, regex)]`` of every family file, by ``order``."""
    out = []
    for p in sorted(Path(folder).glob("*.json")):
        spec = json.loads(p.read_text())
        rx = re.compile("|".join(re.escape(s) for s in spec["patterns"]))
        out.append((spec["order"], p.stem, spec["layer"], rx))
    return [(name, layer, rx) for _, name, layer, rx in sorted(out)]


def family_of(name, fams):
    for fam, _, rx in fams:
        if rx.search(name):
            return fam
    return "other"


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _short(name, width=96):
    name = re.sub(r"\(anonymous namespace\)::", "", name)
    name = re.sub(r"^void ", "", name)
    return name[:width]


class Tracer:
    """Starts and stops ``torch.profiler`` around part of the window and
    reads what it saw. ``path``: where the Chrome trace is written (under
    the run's temporary directory)."""

    def __init__(self, path):
        self.path = Path(path)
        self.prof = self.done = None
        self.steps = 0

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()

    def stop(self, steps: int):
        self.prof.__exit__(None, None, None)
        self.steps = steps
        self.done, self.prof = self.prof, None

    def read(self):
        """``{"steps", "busy_s", "window_s", "family_ms" (device ms a
        step), "device_ops", "idle_gaps"}``, or None where the trace holds
        no device operation. Call after the window: it writes the trace
        out and reads it back."""
        self.done.export_chrome_trace(str(self.path))
        self.done = None
        events = json.loads(self.path.read_text()).get("traceEvents", [])
        try:
            os.remove(self.path)
        except OSError:
            pass
        fams = families()
        dev, host = [], []
        for ev in events:
            if ev.get("ph") != "X" or "dur" not in ev:
                continue
            cat = ev.get("cat", "")
            s, d = float(ev["ts"]), float(ev["dur"])
            if cat in _DEVICE_CATS:
                dev.append((s, s + d, ev.get("name", "")))
            elif cat in _HOST_CATS:
                host.append((s, s + d, ev.get("name", "")))
        if not dev:
            return None
        merged = _merge([(s, e) for s, e, _ in dev])
        t0, t1 = merged[0][0], merged[-1][1]
        busy = sum(e - s for s, e in merged)
        by_fam, by_name = {}, {}
        for s, e, name in dev:
            fam = family_of(name, fams)
            by_fam[fam] = by_fam.get(fam, 0.0) + (e - s)
            key = _short(name)
            by_name[key] = by_name.get(key, 0.0) + (e - s)
        steps = max(self.steps, 1)
        gaps = []
        for (_, e0), (s1, _) in zip(merged, merged[1:]):
            if s1 > e0:
                gaps.append((s1 - e0, 0.5 * (e0 + s1)))
        gaps.sort(reverse=True)
        hs = np.array([h[0] for h in host])
        he = np.array([h[1] for h in host])
        named = {}
        for length, mid in gaps[:200]:
            inner = np.flatnonzero((hs <= mid) & (he >= mid))
            who = (host[inner[np.argmin(he[inner] - hs[inner])]][2]
                   if inner.size else "no host call")
            named[_short(who)] = named.get(_short(who), 0.0) + length * 1e-6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        return {
            "steps": self.steps,
            "busy_s": busy * 1e-6,
            "window_s": (t1 - t0) * 1e-6,
            "family_ms": {k: v * 1e-3 / steps for k, v in by_fam.items()},
            "device_ops": [[k, v * 1e-6] for k, v in top],
            "idle_gaps": sorted(([k, v] for k, v in named.items()),
                                key=lambda kv: -kv[1])[:10],
        }
