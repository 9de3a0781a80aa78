"""Sufficient-statistics Monte-Carlo accumulator over a process mesh (port
of ``orphics_tpu.parallel.statistics``).

The reference's MPI reducers (``orphics/stats.py:577`` ``Stats`` and
``orphics/stats.py:918`` ``Statistics``, an ``MPI.Allreduce(IN_PLACE,
SUM)`` of counts, sums and outer-product sums) keep their reduction shape,
(N, sum x, sum x x^T) plus stack sums; the transport is one
``torch.distributed`` all-reduce over a mesh axis's process group
(:meth:`SuffStats.psum`, :func:`psum_states`). The accumulator is a
dataclass of tensors and its methods are pure: each returns a new one.

Derived statistics: mean = sum x / N, cov = (sum x x^T - sum x sum x^T /
N) / (N - ddof), as ``stats.py:1338-1394``. A batch is cast to the
accumulator's dtype as it is added, so float64 accumulators (orphics
accumulates in float64 numpy) keep a long campaign's moments from the
cancellation of float32 sums.

The npz format of :func:`state_to_arrays` is the JAX package's
(``{label}__{field}``), so either package reads the other's files.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from .._device import as_tensor, resolve
from ..utils.profiling import span

__all__ = ["SuffStats", "Statistics", "Stats", "get_stats",
           "dump_stats", "load_stats", "state_to_arrays",
           "state_from_arrays", "psum_states"]

_SUFF_FIELDS = ("n", "s", "ss", "stack", "nstack")


def psum_states(states: Dict[str, "SuffStats"], axis):
    """All-reduce every field of every label of ``states`` over a mesh axis
    (``mesh.axis("sims")``: its process group's all-reduce): the fields of
    one dtype and device are packed into one buffer, so a dict of
    accumulators costs one collective per dtype. The counters
    ``psum_states.collectives`` and ``psum_states.bytes`` count the
    all-reduces issued and the bytes of their buffers (the identity on a
    one-rank axis counts too)."""
    groups = {}
    for label, st in states.items():
        for field in _SUFF_FIELDS:
            v = getattr(st, field)
            if v is not None:
                groups.setdefault((v.dtype, v.device), []).append(
                    (label, field, v))
    new = {label: {} for label in states}
    for items in groups.values():
        with span("orphics.parallel.allreduce"):
            flat = axis.all_reduce(torch.cat([v.reshape(-1)
                                              for _, _, v in items]))
        psum_states.collectives += 1
        psum_states.bytes += flat.numel() * flat.element_size()
        pos = 0
        for label, field, v in items:
            new[label][field] = flat[pos: pos + v.numel()].reshape(v.shape)
            pos += v.numel()
    return {label: dataclasses.replace(st, **new[label])
            for label, st in states.items()}


psum_states.collectives = 0
psum_states.bytes = 0


@dataclasses.dataclass
class SuffStats:
    """Sufficient statistics of a stream of d-vectors (and optional
    stacks), as tensors on one device."""

    n: torch.Tensor                       # scalar sample count
    s: torch.Tensor                       # (d,) running sum
    ss: Optional[torch.Tensor] = None     # (d, d) sum of outer products
    stack: Optional[torch.Tensor] = None  # running stack sum, any shape
    nstack: Optional[torch.Tensor] = None

    # ---- constructors ------------------------------------------------
    @staticmethod
    def zeros(dim: int, do_cov: bool = True, dtype=torch.float32,
              device=None) -> "SuffStats":
        """Empty statistics of ``dim``-vectors on ``device`` (``None``: the
        card)."""
        dev = resolve(device)
        z = lambda shape: torch.zeros(shape, dtype=dtype, device=dev)
        return SuffStats(n=z(()), s=z((dim,)),
                         ss=z((dim, dim)) if do_cov else None)

    @staticmethod
    def zeros_stack(shape, dtype=torch.float32, device=None) -> "SuffStats":
        """An empty stack sum of ``shape`` arrays on ``device`` (``None``:
        the card)."""
        dev = resolve(device)
        z = lambda sh: torch.zeros(sh, dtype=dtype, device=dev)
        return SuffStats(n=z(()), s=z((0,)), ss=None, stack=z(tuple(shape)),
                         nstack=z(()))

    # ---- accumulation (pure) -----------------------------------------
    def add(self, x, w=None) -> "SuffStats":
        """Add one (d,) sample or a (B, d) batch, cast to the accumulator's
        dtype; optional (B,) 0/1 weights exclude padding entries from the
        statistics."""
        x = torch.atleast_2d(as_tensor(x, self.s.device)).to(self.s.dtype)
        if w is None:
            n_add = x.shape[0]
            xw = x
        else:
            w = torch.as_tensor(w, dtype=x.dtype, device=x.device)
            n_add = w.sum()
            xw = x * w[:, None]
        new = dataclasses.replace(self, n=self.n + n_add,
                                  s=self.s + xw.sum(dim=0))
        if self.ss is not None:
            new = dataclasses.replace(
                new, ss=self.ss + torch.einsum("bi,bj->ij", xw, x).to(
                    self.ss.dtype))
        return new

    def add_stack(self, arr, w=None) -> "SuffStats":
        """Add one array (or (B, ...) batch) to the running stack sum, the
        batch summed in one reduction in the stack's dtype; optional (B,)
        0/1 weights exclude padding entries."""
        arr = as_tensor(arr, self.stack.device)
        if arr.ndim == self.stack.ndim:
            arr = arr[None]
        if w is None:
            n_add = arr.shape[0]
        else:
            w = torch.as_tensor(w, dtype=arr.dtype, device=arr.device)
            n_add = w.sum()
            arr = arr * w.reshape((-1,) + (1,) * (arr.ndim - 1))
        return dataclasses.replace(
            self, stack=self.stack + arr.sum(dim=0, dtype=self.stack.dtype),
            nstack=self.nstack + n_add)

    # ---- reduction -----------------------------------------------------
    def psum(self, group) -> "SuffStats":
        """All-reduce every field over a mesh axis (``mesh.axis("sims")``,
        the axis's process group; the JAX package's ``psum`` over a mesh
        axis): one collective."""
        return psum_states({"_": self}, group)["_"]

    def merge(self, other: "SuffStats") -> "SuffStats":
        return SuffStats(*(None if a is None else a + b for a, b in zip(
            (getattr(self, f) for f in _SUFF_FIELDS),
            (getattr(other, f) for f in _SUFF_FIELDS))))

    # ---- derived statistics --------------------------------------------
    def mean(self):
        return self.s / self.n

    def cov(self, ddof: int = 1):
        m = self.s[:, None] * self.s[None, :] / self.n
        return (self.ss - m) / (self.n - ddof)

    def var(self, ddof: int = 1):
        return torch.diagonal(self.cov(ddof))

    def std(self, ddof: int = 1):
        return torch.sqrt(self.var(ddof))

    def err(self):
        """Standard error of the mean."""
        return torch.sqrt(self.var() / self.n)

    def corr(self, ddof: int = 1):
        c = self.cov(ddof)
        d = torch.sqrt(torch.diagonal(c))
        return c / d[:, None] / d[None, :]

    def stack_mean(self):
        return self.stack / self.nstack


def state_to_arrays(state: Dict[str, SuffStats]) -> Dict[str, np.ndarray]:
    """Flatten a {label: SuffStats} dict to npz-ready host arrays keyed
    ``{label}__{field}`` (the on-disk format of ``save_reduced`` and of the
    checkpointed ensemble, the JAX package's). Parsing is rsplit-based, so
    labels may themselves contain ``__``; field names never do."""
    out = {}
    for label, st in state.items():
        for field in _SUFF_FIELDS:
            v = getattr(st, field)
            if v is not None:
                out[f"{label}__{field}"] = v.detach().cpu().numpy()
    return out


def state_from_arrays(data: Dict[str, np.ndarray],
                      device=None) -> Dict[str, SuffStats]:
    """Inverse of :func:`state_to_arrays`, the tensors on ``device``
    (``None``: the card)."""
    dev = resolve(device)
    labels: Dict[str, Dict[str, torch.Tensor]] = {}
    for k, v in data.items():
        label, field = k.rsplit("__", 1)
        labels.setdefault(label, {})[field] = torch.as_tensor(
            np.array(v), device=dev)
    return {label: SuffStats(**{f: fields.get(f) for f in _SUFF_FIELDS})
            for label, fields in labels.items()}


class Statistics:
    """Label-keyed accumulator with the reference's ``Statistics`` surface
    (``orphics/stats.py:918``): ``add``/``extend``/``add_stack`` then
    ``allreduce`` then ``mean/cov/var/stack_mean``. Host arrays go to
    ``device`` (``None``: the card); tensors keep theirs."""

    def __init__(self, device=None):
        self.state: Dict[str, SuffStats] = {}
        self.device = device

    def add(self, label: str, x, do_cov: bool = True):
        x = torch.atleast_2d(as_tensor(x, self.device))
        if label not in self.state:
            self.state[label] = SuffStats.zeros(x.shape[-1], do_cov, x.dtype,
                                                x.device)
        self.state[label] = self.state[label].add(x)

    extend = add  # batch add is the same pure op

    def add_stack(self, label: str, arr, batched: bool = False):
        """Add a sample array (or, with ``batched``, a (B, ...) batch) to
        the running stack sum for ``label``."""
        arr = as_tensor(arr, self.device)
        if label not in self.state:
            shape = arr.shape[1:] if batched else arr.shape
            self.state[label] = SuffStats.zeros_stack(shape, arr.dtype,
                                                      arr.device)
        self.state[label] = self.state[label].add_stack(arr)

    def allreduce(self, axis=None):
        """With no ``axis`` a no-op (one rank holds everything, the
        ``fakeMpiComm`` case); given a mesh axis (``mesh.axis("sims")``),
        every label's statistics are summed over its process group in one
        collective per dtype."""
        if axis is not None:
            self.state = psum_states(self.state, axis)
        return self

    def mean(self, label):
        return self.state[label].mean()

    def cov(self, label, ddof: int = 1):
        return self.state[label].cov(ddof)

    def var(self, label, ddof: int = 1):
        return self.state[label].var(ddof)

    def corr(self, label, ddof: int = 1):
        return self.state[label].corr(ddof)

    def err(self, label):
        return self.state[label].err()

    def stack_mean(self, label):
        return self.state[label].stack_mean()

    # ---- persistence (reference save_reduced/load_reduced,
    #      stats.py:1455-1530) -----------------------------------------
    def save_reduced(self, fname: str):
        np.savez(fname, **state_to_arrays(self.state))

    @classmethod
    def load_reduced(cls, fname: str, device=None) -> "Statistics":
        """The statistics written by :meth:`save_reduced` (of either
        package), on ``device`` (``None``: the card)."""
        with np.load(fname) as data:
            arrays = {k: data[k] for k in data.files}
        obj = cls(device=device)
        obj.state.update(state_from_arrays(arrays, device))
        return obj


class Stats(Statistics):
    """Back-compat alias of the older accumulator (reference
    ``orphics/stats.py:577``) — ``add_to_stats``/``add_to_stack``/
    ``get_stats`` naming."""

    def __init__(self, comm=None, device=None):
        super().__init__(device=device)

    def add_to_stats(self, label, x):
        self.add(label, x)

    def add_to_stack(self, label, arr):
        self.add_stack(label, arr)

    def dump(self, path):
        dump_stats(self, path)

    def get_stacks(self):
        self.stacks = {k: v.stack_mean().cpu().numpy()
                       for k, v in self.state.items() if v.stack is not None}
        return self.stacks

    def get_stats(self):
        self.stats = {}
        for k, v in self.state.items():
            if v.ss is None:
                continue
            cov = v.cov().cpu().numpy()
            err = np.sqrt(np.diag(cov))
            n = int(v.n)
            # reference key set/semantics (``orphics/stats.py:859``):
            # err = per-sample scatter, errmean = standard error of mean
            self.stats[k] = {
                "mean": v.mean().cpu().numpy(),
                "cov": cov,
                "covmean": cov / n,
                "corr": v.corr().cpu().numpy(),
                "err": err,
                "errmean": err / np.sqrt(n),
                "N": n,
            }
        return self.stats


def get_stats(binned_vectors, device=None):
    """mean/cov/covmean/err/errmean/corr of a (nsamples, dim) array — same
    keys and semantics as reference ``orphics/stats.py:859``: ``err`` is
    the per-sample scatter sqrt(diag cov) and ``errmean`` is the standard
    error of the mean err/sqrt(N). A tensor keeps its device; a host array
    goes to ``device`` (``None``: the card)."""
    x = as_tensor(binned_vectors, device)
    st = SuffStats.zeros(x.shape[-1], dtype=x.dtype, device=x.device).add(x)
    n = int(st.n)
    cov = st.cov()
    err = torch.sqrt(torch.diagonal(cov))
    return {"mean": st.mean(), "cov": cov, "covmean": cov / n,
            "err": err, "errmean": err / np.sqrt(n),
            "corr": st.corr(), "N": n}


def dump_stats(stats: "Statistics", path: str):
    """Write a Statistics accumulator to a directory in the reference's
    ``Stats.dump`` layout (``stats.py:737``): per-label
    ``mstats_dump_vectors_<label>.npy`` sample matrices are not retained
    by the sufficient-statistics design, so this writes the reduced
    products — ``mstats_dump_stats_<label>_{mean,err,cov}.txt`` — plus
    ``mstats_dump_stack_<label>.npy`` stack means; round-trips through
    :func:`load_stats`."""
    import os
    os.makedirs(path, exist_ok=True)
    host = lambda t: t.detach().cpu().numpy()
    for label, st in stats.state.items():
        if st.stack is not None:
            np.save(os.path.join(path, f"mstats_dump_stack_{label}.npy"),
                    host(st.stack_mean()))
            continue
        np.savetxt(os.path.join(path,
                                f"mstats_dump_stats_{label}_mean.txt"),
                   np.atleast_1d(host(st.mean())))
        np.savetxt(os.path.join(path,
                                f"mstats_dump_stats_{label}_err.txt"),
                   np.atleast_1d(host(st.err())))
        if st.ss is not None:
            np.savetxt(os.path.join(path,
                                    f"mstats_dump_stats_{label}_cov.txt"),
                       np.atleast_2d(host(st.cov())))


def load_stats(path: str):
    """Load a directory written by :func:`dump_stats` (or the reference's
    ``Stats.dump``) into a simple namespace with ``stats``, ``stacks`` and
    ``vectors`` dicts of host arrays (reference ``stats.py:744``)."""
    import glob
    import os
    import re
    import types
    s = types.SimpleNamespace(vectors={}, stats={}, stacks={})
    for sstr, sdict in (("vectors", s.vectors), ("stack", s.stacks)):
        for vfile in glob.glob(os.path.join(
                path, f"mstats_dump_{sstr}_*.npy")):
            key = re.search(rf"mstats_dump_{sstr}_(.*?)\.npy",
                            os.path.basename(vfile)).group(1)
            sdict[key] = np.load(vfile)
    keys = set()
    for vfile in glob.glob(os.path.join(path,
                                        "mstats_dump_stats_*_mean.txt")):
        keys.add(re.search(r"mstats_dump_stats_(.*?)_mean\.txt",
                           os.path.basename(vfile)).group(1))
    for key in keys:
        s.stats[key] = {}
        for vfile in glob.glob(os.path.join(
                path, f"mstats_dump_stats_{key}_*.txt")):
            skey = re.search(rf"mstats_dump_stats_{key}_(.*?)\.txt",
                             os.path.basename(vfile)).group(1)
            arr = np.loadtxt(vfile)
            if arr.size == 1:
                arr = arr.ravel()[0]
            s.stats[key][skey] = arr
    return s
