"""One reader per per-layer metric, in a file named after the metric,
found by the name in ``BENCHMARK.json``. A reader is ``read(ctx)``
returning the metric's value, or None where this cell gives it nothing to
read; ``ctx`` is a :class:`cmbbench.run.Readings`."""
from __future__ import annotations

from .. import work as W

__all__ = ["roofline"]


def roofline(ctx, family):
    """The share (%) of the least time of the layer's work in a step over
    the device time a step of the family's kernels took; None where the
    cell has no such work or the trace no such kernel."""
    work = ctx.work.get(family)
    dev_ms = (ctx.trace or {}).get("family_ms", {}).get(family)
    if work is None or not dev_ms:
        return None
    return 100.0 * W.bound(*work)[0] / dev_ms
