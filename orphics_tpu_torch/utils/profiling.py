"""Tracing / profiling utilities (port of ``orphics_tpu.utils.profiling``,
SURVEY §5.1).

The reference's tracing layer is minimal: ``pixell.bench.show`` context
blocks (reference ``lensing.py:152``, ``pixcov.py:3``,
``foregrounds.py:10``) and a ``stats.timeit`` wall-time decorator
(reference ``stats.py:902-913``). The port keeps those shapes on
``torch.profiler``: a trace of host calls and card kernels written as a
Chrome trace (open it in Perfetto or ``chrome://tracing``), and named
ranges that label the calls and kernels inside them.

Usage::

    from orphics_tpu_torch.utils import profiling as prof

    with prof.trace("/tmp/torchtrace"):        # host + card trace
        out = step(gen)
        prof.sync(out)

    with prof.show("qe recon"):                # bench.show analog
        out = step(gen)
        prof.sync(out)

    with prof.annotate("filter"):              # a named range in the trace
        y = filt(x)
"""
from __future__ import annotations

import contextlib
import os
import time

import torch

from .fitting import _sync, timeit  # re-export: decorator form lives there

__all__ = ["trace", "annotate", "show", "sync", "timeit"]


def sync(out):
    """Block until ``out`` is computed: ``torch.cuda.synchronize`` on the
    devices of its CUDA tensors (a tensor or nested lists, tuples and dicts
    of them); CPU tensors are ready when returned. Returns ``out``."""
    return _sync(out)


@contextlib.contextmanager
def trace(logdir: str, record_shapes: bool = False):
    """A ``torch.profiler.profile`` of the block (host calls, and the
    card's kernels where CUDA is available), written to
    ``logdir/trace.json`` as a Chrome trace when the block ends. Yields
    the profiler (``key_averages()`` sums by kernel)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts, record_shapes=record_shapes) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """A named range (``torch.profiler.record_function``): the host calls
    and card kernels issued inside it group under ``name`` in a trace."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def show(label: str = "block"):
    """The ``pixell.bench.show`` analog: wall-time a block and print it.
    The card's queue is synchronized before the clock starts and when the
    block ends, so the time is the block's work, not its enqueue. Prints
    ``<label>: <seconds> s`` like the reference."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        print(f"{label}: {time.perf_counter() - t0:.6f} s")
