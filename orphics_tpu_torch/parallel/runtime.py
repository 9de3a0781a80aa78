"""Process-mesh ensemble runtime — the MPI replacement (port of
``orphics_tpu.parallel.runtime``).

Replaces the reference's ``orphics/mpi.py`` (``mpi_distribute``/
``distribute``, ``fakeMpiComm``) and the MPI ensemble loops of SURVEY §3.5,
in PyTorch's idiom:

  * one process per rank, started by ``torchrun`` (or any launcher) and
    joined by :func:`init_multihost` into a ``torch.distributed`` process
    group: NCCL on the card, gloo on the CPU;
  * :func:`get_mesh`: a :class:`Mesh` over a ``DeviceMesh`` with the named
    axes ``("sims", "grid")``; each axis has its process group, this
    rank's coordinate and its collectives (``all_reduce``,
    ``all_to_all_single``, ``all_gather_into_tensor``);
  * ``fakeMpiComm``'s serial fallback: with no process group,
    :func:`get_mesh` returns a one-rank mesh whose collectives are the
    identity;
  * task distribution: ``fn(generator)`` per task, each task's
    ``torch.Generator`` seeded from ``(seed, task index)``, tasks split
    over the ``sims`` axis, one all-reduce of the sufficient statistics.

The distributed functions of :mod:`.fourier` and :mod:`.sht` are per-rank
bodies over a mesh axis (its ``index``, ``size`` and collectives).
:func:`emulate` runs every rank of a mesh as a thread of one process, the
collectives exchanging blocks by slicing, so one process (a CPU test, one
card) runs the arithmetic of an S-rank decomposition.
"""
from __future__ import annotations

import contextlib
import datetime
import math
import os
import threading
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from .._device import resolve
from .statistics import (SuffStats, psum_states, state_from_arrays,
                         state_to_arrays)

__all__ = ["get_mesh", "distribute", "mpi_distribute", "ensemble",
           "ensemble_stats", "ensemble_stats_checkpointed",
           "init_multihost", "mpi_abort_on_exception", "Mesh", "emulate",
           "task_generator"]


def init_multihost(init_method=None, world_size=None, rank=None,
                   local_rank=None, device=None, timeout=None):
    """Join this process to a ``torch.distributed`` world — the analog of
    the reference's MPI world setup (``orphics/mpi.py:62-74``: import
    mpi4py, fall back to ``fakeMpiComm`` when absent).

    Under ``torchrun`` call it with no arguments: ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK`` and ``MASTER_ADDR``/``MASTER_PORT`` come from the
    environment. Other launchers pass ``init_method`` (``file://...`` or
    ``tcp://host:port``), ``world_size`` and ``rank``. The backend is NCCL
    when ``device`` resolves to the card (``None``: the card; the process
    then works on card ``local_rank``) and gloo for ``device="cpu"``;
    ``timeout`` (seconds) bounds every collective of the group.

    With nothing configured this is a no-op returning ``(0, 1)`` — the
    ``fakeMpiComm`` degradation. Calling twice is safe; other errors
    propagate. Returns ``(rank, world_size)``.
    """
    env = os.environ
    if not (init_method or env.get("MASTER_ADDR")):
        return 0, 1
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    rank = int(env.get("RANK", 0)) if rank is None else int(rank)
    world_size = (int(env.get("WORLD_SIZE", 1)) if world_size is None
                  else int(world_size))
    local_rank = (int(env.get("LOCAL_RANK", rank)) if local_rank is None
                  else int(local_rank))
    dev = resolve(device)
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank)
    kw = {} if timeout is None else {
        "timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init_method or "env://",
                            world_size=world_size, rank=rank, **kw)
    return rank, world_size


# ---------------------------------------------------------------------------
# Mesh axes: this rank's coordinate and the axis's collectives
# ---------------------------------------------------------------------------

def _as_real(t):
    return torch.view_as_real(t) if t.is_complex() else t


def _split_blocks(x, split_axis, size):
    """``(size, ...)``: ``x`` cut into ``size`` equal blocks along
    ``split_axis``, block ``j`` first-axis entry ``j`` (what rank ``j``
    receives)."""
    a = split_axis % x.ndim
    if x.shape[a] % size:
        raise ValueError(f"axis {a} of length {x.shape[a]} does not split "
                         f"into {size} equal blocks")
    return x.unflatten(a, (size, x.shape[a] // size)).movedim(a, 0)


class _OneRankAxis:
    """An axis of one rank: its collectives are the identity."""

    index = 0
    size = 1
    group = None

    def all_reduce(self, t):
        return t

    def all_to_all(self, x, split_axis, concat_axis):
        return x

    def all_gather(self, x, axis):
        return x

    def barrier(self):
        pass


class _GroupAxis:
    """An axis over a ``torch.distributed`` process group. Every collective
    takes tensors on the mesh's device type only: NCCL reads the card's
    memory, gloo the host's, and nothing is copied across."""

    def __init__(self, group, index, size, device):
        self.group, self.index, self.size = group, index, size
        self.device = device

    def _check(self, t):
        if t.device.type != self.device.type:
            raise ValueError(f"a collective of a {self.device.type} mesh got "
                             f"a tensor on {t.device}")

    def all_reduce(self, t):
        """The sum of ``t`` over the axis (a new tensor)."""
        self._check(t)
        out = t.contiguous().clone()
        dist.all_reduce(_as_real(out), group=self.group)
        return out

    def all_to_all(self, x, split_axis, concat_axis):
        """Tiled all-to-all (``jax.lax.all_to_all(..., tiled=True)``): block
        ``j`` of ``x`` along ``split_axis`` goes to rank ``j``; the blocks
        received are joined along ``concat_axis`` in rank order."""
        self._check(x)
        concat_axis %= x.ndim
        send = _split_blocks(x, split_axis, self.size).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(_as_real(recv), _as_real(send),
                               group=self.group)
        return torch.cat(recv.unbind(0), dim=concat_axis)

    def all_gather(self, x, axis):
        """Every rank's ``x`` joined along ``axis`` in rank order."""
        self._check(x)
        x = x.contiguous()
        out = torch.empty((self.size * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(_as_real(out), _as_real(x),
                                    group=self.group)
        return torch.cat(out.unflatten(0, (self.size, x.shape[0])).unbind(0),
                         dim=axis % x.ndim)

    def barrier(self):
        dist.barrier(group=self.group)


class _ThreadGroup:
    """The ranks of one emulated axis: threads of one process that meet at
    a barrier and read each other's blocks. One thread runs at a time: it
    holds ``turn`` and hands it on while it waits at a barrier."""

    def __init__(self, size, timeout, turn):
        self.barrier = threading.Barrier(size, timeout=timeout)
        self.slots = [None] * size
        self._turn = turn

    def wait(self):
        self._turn.release()
        try:
            self.barrier.wait()
        finally:
            self._turn.acquire()

    def exchange(self, index, obj):
        self.slots[index] = obj
        self.wait()
        out = list(self.slots)
        self.wait()                  # nobody writes before everyone read
        return out


class _ThreadAxis:
    """An axis of :func:`emulate`: the collectives of :class:`_GroupAxis`
    by slicing the other threads' tensors (the sum in rank order, so every
    rank holds the same bits)."""

    group = None

    def __init__(self, tgroup, index, size):
        self._t, self.index, self.size = tgroup, index, size

    def all_reduce(self, t):
        parts = self._t.exchange(self.index, t)
        out = parts[0].clone()
        for p in parts[1:]:
            out += p
        return out

    def all_to_all(self, x, split_axis, concat_axis):
        concat_axis %= x.ndim
        parts = self._t.exchange(self.index,
                                 _split_blocks(x, split_axis, self.size))
        return torch.cat([p[self.index] for p in parts], dim=concat_axis)

    def all_gather(self, x, axis):
        return torch.cat(self._t.exchange(self.index, x), dim=axis % x.ndim)

    def barrier(self):
        self._t.wait()


class Mesh:
    """A mesh of ranks with named axes (the port's counterpart of
    ``jax.sharding.Mesh``): ``mesh.shape[name]`` is an axis's size,
    ``mesh.axis(name)`` its handle (``index``: this rank's coordinate,
    ``size``, ``group``: the process group or ``None``, and the
    collectives ``all_reduce``, ``all_to_all``, ``all_gather``,
    ``barrier``), ``mesh.axis(names)`` for all axes together the flattened
    axis (rank order row-major, as ``PartitionSpec(("sims", "grid"))``),
    ``mesh.device`` where the ranks keep their tensors and
    ``mesh.device_mesh`` the ``DeviceMesh`` (``None`` for one rank and
    for :func:`emulate`)."""

    def __init__(self, axis_names, shape, axes, flat, device,
                 device_mesh=None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self._axes = dict(zip(self.axis_names, axes))
        self._flat = flat
        self.device = device
        self.device_mesh = device_mesh

    @property
    def size(self) -> int:
        """The number of ranks."""
        return math.prod(self.shape.values())

    def axis(self, names):
        """The handle of one axis, or of a tuple of axes: one name, or every
        axis in the mesh's order (flattened)."""
        if isinstance(names, str):
            return self._axes[names]
        names = tuple(names)
        if len(names) == 1:
            return self._axes[names[0]]
        if names == self.axis_names:
            return self._flat
        raise ValueError(f"axes {names}: give one axis or all of "
                         f"{self.axis_names} in order")

    def barrier(self):
        self._flat.barrier()

    def __repr__(self):
        return f"Mesh({self.shape}, device={self.device})"


def _one_rank_mesh(axis_names, device):
    one = _OneRankAxis()
    return Mesh(axis_names, (1,) * len(axis_names),
                (one,) * len(axis_names), one, device)


def get_mesh(shape=None, axis_names=("sims", "grid"), device=None) -> Mesh:
    """A :class:`Mesh` of the world's ranks. Default shape: every rank on
    the ``sims`` axis and a trivial ``grid`` axis (flat-sky ensembles are
    data-parallel first; the grid axis shards very large maps or covariance
    rows). ``device``: where the ranks' tensors live (``None``: the card,
    which needs the NCCL backend; ``"cpu"`` needs gloo).

    With no process group (:func:`init_multihost` found nothing to join)
    this is a one-rank mesh whose collectives are the identity."""
    dev = resolve(device)
    axis_names = tuple(axis_names)
    if not (dist.is_available() and dist.is_initialized()):
        if shape is not None and math.prod(shape) != 1:
            raise ValueError(f"a mesh of shape {tuple(shape)} needs a "
                             "process group: call init_multihost first")
        return _one_rank_mesh(axis_names, dev)
    world = dist.get_world_size()
    shape = (world,) + (1,) * (len(axis_names) - 1) if shape is None \
        else tuple(int(s) for s in shape)
    if math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} does not hold the world's "
                         f"{world} ranks")
    nccl = dist.get_backend() == "nccl"
    if nccl != (dev.type == "cuda"):
        raise ValueError(f"a {dist.get_backend()} process group cannot "
                         f"carry tensors on {dev.type}")
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    dm = init_device_mesh(dev.type, shape, mesh_dim_names=axis_names)
    axes = [_GroupAxis(dm.get_group(n), dm.get_local_rank(n), dm.size(i),
                       dev) for i, n in enumerate(axis_names)]
    # the mesh lays the world's ranks out row-major, so its flattened axis
    # is the default group
    flat = _GroupAxis(None, dist.get_rank(), world, dev)
    return Mesh(axis_names, shape, axes, flat, dev, dm)


def emulate(fn: Callable, shape, axis_names=("sims", "grid"), device=None,
            timeout: float = 600.0):
    """Run ``fn(mesh)`` for every rank of a ``shape`` mesh as threads of
    this process, the collectives exchanging blocks by slicing, and return
    the ranks' results in rank order. One process (a CPU test, one card)
    runs the arithmetic of the S-rank decomposition this way; ``device``
    (``None``: the card) holds every rank's tensors. The ranks take turns:
    one runs until its next collective, so the split costs the sum of the
    ranks' work and the threads do not contend. A rank that raises aborts
    the others' waits (``timeout`` seconds bounds each) and its exception
    is raised here."""
    dev = resolve(device)
    shape = tuple(int(s) for s in shape)
    axis_names = tuple(axis_names)
    nrank = math.prod(shape)
    turn = threading.Lock()
    groups = {}          # (axis, the other axes' coordinates) -> its ranks
    flat_group = _ThreadGroup(nrank, timeout, turn)
    meshes = []
    for r in range(nrank):
        c = tuple(int(i) for i in np.unravel_index(r, shape))
        axes = []
        for k in range(len(shape)):
            g = groups.setdefault((k,) + c[:k] + c[k + 1:],
                                  _ThreadGroup(shape[k], timeout, turn))
            axes.append(_ThreadAxis(g, c[k], shape[k]))
        meshes.append(Mesh(axis_names, shape, axes,
                           _ThreadAxis(flat_group, r, nrank), dev))
    results = [None] * nrank
    errors = [None] * nrank

    def run(r):
        turn.acquire()
        try:
            results[r] = fn(meshes[r])
        except BaseException as e:       # re-raised below, in this thread
            errors[r] = e
            for g in list(groups.values()) + [flat_group]:
                g.barrier.abort()
        finally:
            turn.release()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(nrank)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    errs = [e for e in errors if e is not None]
    if errs:
        # a rank's own exception, not the broken barrier the others saw
        errs.sort(key=lambda e: isinstance(e, threading.BrokenBarrierError))
        raise errs[0]
    return results


# ---------------------------------------------------------------------------
# Tasks
# ---------------------------------------------------------------------------

def mpi_distribute(num_tasks: int, num_cores: int, allow_empty: bool = False):
    """Contiguous task chunking with the remainder on the *last* ranks —
    same assignment policy AND return signature as reference
    ``orphics/mpi.py:78`` (rank 0 is never overloaded). Returns
    ``(num_each, task_dist)``: a per-core count array and a list of
    task-index lists per core."""
    if not allow_empty:
        assert num_cores <= num_tasks, "fewer tasks than cores"
    base = num_tasks // num_cores
    rem = num_tasks % num_cores
    counts = [base + (1 if i >= num_cores - rem else 0)
              for i in range(num_cores)]
    out, start = [], 0
    for c in counts:
        out.append(list(range(start, start + c)))
        start += c
    return np.asarray(counts), out


def _mix(seed: int, index: int) -> int:
    """A 64-bit seed from ``(seed, index)`` (``numpy.random.SeedSequence``:
    well mixed in every bit, so the CPU generator's low 32 bits are as
    good as the card's 64)."""
    return int(np.random.SeedSequence([int(seed), int(index)])
               .generate_state(1, np.uint64)[0])


def task_generator(seed: int, index: int, device=None) -> torch.Generator:
    """Task ``index``'s ``torch.Generator`` on ``device`` (``None``: the
    card), seeded from ``(seed, index)``: every task has its own
    reproducible stream whatever the number of ranks."""
    g = torch.Generator(device=resolve(device))
    g.manual_seed(_mix(seed, index))
    return g


def distribute(nsims: int, seed: int = 0, mesh: Optional[Mesh] = None):
    """Split ``nsims`` tasks over the mesh's ranks: the analog of reference
    ``mpi.distribute(Nsims)`` (``orphics/mpi.py:95``). Returns ``(mesh,
    seeds)``, ``seeds`` an (nranks, nsims_per_rank) uint64 array of the
    tasks' generator seeds (rank-major, as :func:`task_generator` makes
    them; entries past ``nsims`` are padding)."""
    if mesh is None:
        mesh = get_mesh()
    per = math.ceil(nsims / mesh.size)
    seeds = np.array([_mix(seed, i) for i in range(mesh.size * per)],
                     np.uint64)
    return mesh, seeds.reshape(mesh.size, per)


def _rank_tasks(nsims, ax, per):
    """This rank's tasks on the ``sims`` axis: the block ``[index * per,
    (index + 1) * per)`` cut at ``nsims`` (the JAX package's device-major
    order); a rank whose block lies past ``nsims`` gets its first padding
    task with weight 0, so it knows the outputs' shapes."""
    start = ax.index * per
    valid = list(range(start, min(start + per, nsims)))
    return (valid, 1.0) if valid else ([start], 0.0)


def _stacked(outs):
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def ensemble_stats(fn: Callable, nsims: int, seed: int = 0,
                   mesh: Optional[Mesh] = None, chunk: int = 1,
                   do_cov: bool = True,
                   stack_fn: Optional[Callable] = None):
    """Run ``fn(generator) -> dict[str, 1-D tensor]`` for ``nsims``
    independent tasks across the mesh's ``sims`` axis and return fully
    reduced :class:`SuffStats` per label, replicated on every rank (the
    ``Statistics.allreduce`` pattern of ``orphics/stats.py:1184``).

    Task ``i`` gets :func:`task_generator` ``(seed, i)`` on the mesh's
    device. Each rank runs its block of tasks (ranks of the other axes
    repeat their ``sims`` coordinate's block), folding ``chunk`` tasks at a
    time into its accumulator; tasks beyond ``nsims`` carry weight 0 and
    do not bias the statistics. One all-reduce over ``sims`` ends it.
    ``stack_fn``: optional ``fn(generator) -> dict[str, tensor]`` of map-
    like outputs to be stack-summed (``add_to_stack``), on a generator of
    the same seed as ``fn``'s.
    """
    if mesh is None:
        mesh = get_mesh()
    ax = mesh.axis("sims")
    per = math.ceil(nsims / ax.size / chunk) * chunk
    tasks, weight = _rank_tasks(nsims, ax, per)
    dev = mesh.device
    st, sst = None, {}
    for c0 in range(0, len(tasks), chunk):
        idx = tasks[c0: c0 + chunk]
        w = None if weight else torch.zeros(len(idx), dtype=torch.float64)
        vals = _stacked([fn(task_generator(seed, i, dev)) for i in idx])
        if st is None:
            st = {k: SuffStats.zeros(v[0].numel(), do_cov, v.dtype, v.device)
                  for k, v in vals.items()}
        st = {k: st[k].add(vals[k].reshape(len(idx), -1), w=w) for k in st}
        if stack_fn is not None:
            svals = _stacked([stack_fn(task_generator(seed, i, dev))
                              for i in idx])
            if not sst:
                sst = {k: SuffStats.zeros_stack(v.shape[1:], v.dtype,
                                                v.device)
                       for k, v in svals.items()}
            sst = {k: sst[k].add_stack(svals[k], w=w) for k in sst}
    out = dict(st)
    out.update(sst)
    return psum_states(out, ax)


def ensemble(fn: Callable, nsims: int, seed: int = 0,
             mesh: Optional[Mesh] = None, chunk: int = 1):
    """Gather (not reduce) per-task outputs: the stacked dict of
    ``fn(generator)`` over ``nsims`` tasks (generators as
    :func:`ensemble_stats` makes them), computed data-parallel over the
    ``sims`` axis and gathered on every rank. For small outputs (binned
    spectra); use :func:`ensemble_stats` when only moments are needed.
    ``chunk`` is accepted for the JAX signature and changes nothing."""
    if mesh is None:
        mesh = get_mesh()
    ax = mesh.axis("sims")
    per = math.ceil(nsims / ax.size)
    tasks, _ = _rank_tasks(nsims, ax, per)
    vals = _stacked([fn(task_generator(seed, i, mesh.device))
                     for i in tasks])
    out = {}
    for k, v in vals.items():
        block = v.new_zeros((per,) + tuple(v.shape[1:]))
        valid = max(0, min(per, nsims - ax.index * per))
        block[:valid] = v[:valid]
        out[k] = ax.all_gather(block, 0)[:nsims]
    return out


def ensemble_stats_checkpointed(fn: Callable, nsims: int, path: str,
                                every: int = None, seed: int = 0,
                                mesh: Optional[Mesh] = None,
                                chunk: int = 1, do_cov: bool = True,
                                stack_fn: Optional[Callable] = None,
                                _interrupt_after: int = None):
    """Preemption-safe :func:`ensemble_stats`: run the Monte Carlo in
    rounds of ``every`` tasks, persisting the accumulated sufficient
    statistics and a round cursor to ``path`` after each round (rank 0
    writes, by an atomic ``os.replace``; every rank waits for it).
    Re-invoking with the same arguments loads the completed rounds (every
    rank reads the file) and computes only the remainder — the version of
    the reference's long MPI loops that dump ``Statistics`` periodically
    so a killed job can resume.

    Determinism across interruptions: round ``r`` seeds its tasks from
    ``(seed, r)``, so the result is bitwise identical to an uninterrupted
    run with the same ``every``. A fingerprint of ``(nsims, every, chunk,
    do_cov, sims size, seed, stack_fn given)`` refuses a resume with other
    arguments (``ValueError``): the ``sims`` size matters because the
    ranks' partial sums, and so the rounding, follow it. The state between
    rounds lives on the host.

    ``_interrupt_after`` is a testing hook: stop (returning ``None``)
    after that many newly-computed rounds, as a stand-in for preemption.
    """
    if mesh is None:
        mesh = get_mesh()
    nsims_axis = mesh.shape["sims"]
    if every is None:
        every = max(int(nsims_axis) * chunk, 1)
    nrounds = math.ceil(nsims / every)
    fhash = repr((int(nsims), int(every), int(chunk), bool(do_cov),
                  int(nsims_axis), int(seed), stack_fn is not None))
    meta = ("fingerprint", "rounds_done")
    writer = mesh.axis(mesh.axis_names).index == 0

    def save(state, rounds_done):
        if writer:
            flat = state_to_arrays(state)
            flat["fingerprint"] = np.asarray(fhash)
            flat["rounds_done"] = np.asarray(rounds_done)
            tmp = path + ".tmp.npz"          # np.savez keeps an .npz suffix
            np.savez(tmp, **flat)
            os.replace(tmp, path)
        mesh.barrier()

    def load():
        if not os.path.exists(path):
            return None, 0
        with np.load(path, allow_pickle=False) as z:
            if str(z["fingerprint"]) != fhash:
                raise ValueError(
                    f"checkpoint {path} was written with different "
                    "arguments (nsims/every/chunk/seed/mesh); refusing "
                    "to mix")
            rounds_done = int(z["rounds_done"])
            state = state_from_arrays({k: z[k] for k in z.files
                                       if k not in meta}, "cpu")
        return state, rounds_done

    state, r0 = load()
    done = 0
    for r in range(r0, nrounds):
        count = min(every, nsims - r * every)
        st = ensemble_stats(fn, count, seed=_mix(seed, r), mesh=mesh,
                            chunk=chunk, do_cov=do_cov, stack_fn=stack_fn)
        st = state_from_arrays(state_to_arrays(st), "cpu")   # off-device
        state = st if state is None else \
            {k: state[k].merge(st[k]) for k in state}
        save(state, r + 1)
        done += 1
        if _interrupt_after is not None and done >= _interrupt_after \
                and r + 1 < nrounds:
            return None
    return state


@contextlib.contextmanager
def mpi_abort_on_exception(comm=None):
    """Abort all ranks on an uncaught exception with a rank-0 traceback
    (reference ``mpi.py:31``): the traceback is printed once (on rank 0 of
    ``comm``, else of the process group), ``comm.Abort`` is called where
    ``comm`` has one, and the exception is re-raised."""
    import sys
    import traceback
    try:
        yield
    except Exception as e:
        if comm is not None:
            rank = comm.Get_rank()
        else:
            rank = dist.get_rank() if dist.is_initialized() else 0
        if rank == 0:
            print(f"Exception: {e}", file=sys.stderr)
            traceback.print_exc()
        if comm is not None and hasattr(comm, "Abort"):
            comm.Abort(1)
        raise
