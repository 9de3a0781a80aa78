"""Carry state across from the JAX package.

This system has no weights: its state is the theory tables and the
precomputed planes of a pipeline. Both cross as numpy arrays, so this
module needs neither jax nor ``orphics_tpu``:

  * :func:`theory_from_numpy` builds a :class:`TheorySpectra` from
    ``orphics_tpu``'s ``TheorySpectra.tables`` (as numpy);
  * :func:`load_pipeline_planes` overwrites a port
    :class:`~orphics_tpu_torch.models.lenspipe.LensedQEPipeline`'s planes
    with those of a JAX pipeline, so ``core`` can be held to the JAX step
    separately from the planes' own construction;
  * :func:`load_pipeline_pp_planes` does the same for the full-plane
    path's doubly-permuted planes, bin tables and ``_tt_pp`` plans
    (``_pp_core``). Both packages use the same layout, so the arrays
    cross unchanged;
  * :func:`load_fastcl_tables` does the same for a
    :class:`~orphics_tpu_torch.models.fastcl.FastCl`;
  * :func:`load_ilc_weights` takes the per-band weight planes of an ILC
    (``orphics_tpu.models.ilc.cilc_weights`` / ``silc_weights``) as the
    tensor that :func:`~orphics_tpu_torch.models.ilc.linear_coadd_fused`
    coadds with;
  * :func:`load_sht_tables` copies a port
    :func:`~orphics_tpu_torch.ops.legendre.tables` entry with the JAX
    Legendre kernel's prepared tables
    (``orphics_tpu.ops.pallas_sht._prep_host``) as its kernel tables, so
    the port's kernels can run on JAX's own captured seeds.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ._device import resolve
from .ops import legendre
from .models.fastcl import drop_edge_segments
from .models.lenspipe import PLANE_NAMES, PP_PLANE_NAMES
from .models.theory import TheorySpectra

__all__ = ["theory_from_numpy", "load_pipeline_planes",
           "load_pipeline_pp_planes", "load_fastcl_tables",
           "load_ilc_weights", "load_sht_tables", "TT_HALF_NAMES",
           "TT_PP_NAMES", "FASTCL_TABLE_NAMES"]

# the arrays of QE._tt_half_plans(), in its tuple order (sym excluded)
TT_HALF_NAMES = ("wa0", "wag", "wb0", "wbg", "post", "Lh")
# the arrays of QE._tt_pp_plans(), in its tuple order
TT_PP_NAMES = ("wA", "wX", "Ly", "Lx", "post")
# the attributes of the JAX FastCl that load_fastcl_tables takes
FASTCL_TABLE_NAMES = ("_covsqrt_pp", "_idc", "_icnt", "_nsg", "_mrow",
                      "_oh0", "_ohn", "centers")


def theory_from_numpy(tables: Dict[str, np.ndarray], lpad: int = 9000,
                      dimensionless: bool = False) -> TheorySpectra:
    """TheorySpectra from host arrays (kept as float64 numpy)."""
    return TheorySpectra({k: np.asarray(v, dtype=np.float64)
                          for k, v in tables.items()}, lpad, dimensionless)


def load_pipeline_planes(pipe, planes: Dict[str, np.ndarray]) -> None:
    """Overwrite ``pipe``'s precomputed planes in place.

    ``planes`` holds every name of ``PLANE_NAMES``, the scalars
    ``ncov_h`` and ``norm``, and the ``qe._tt_half_plans()`` arrays under
    ``"tt_half.<name>"`` for ``<name>`` in ``TT_HALF_NAMES`` (``wb0`` and
    ``wbg`` may be absent or None when the leg masks are symmetric).
    """
    dev = pipe.device
    for name in PLANE_NAMES:
        arr = np.array(planes[name])          # a writable host copy
        dtype = torch.complex64 if np.iscomplexobj(arr) else pipe.dtype
        setattr(pipe, name, torch.as_tensor(arr, device=dev).to(dtype)
                .contiguous())
    pipe.ncov_h = float(planes["ncov_h"])
    pipe.norm = float(planes["norm"])
    plans = []
    for name in TT_HALF_NAMES:
        arr = planes.get("tt_half." + name)
        plans.append(None if arr is None else torch.as_tensor(
            np.array(arr), device=dev).to(pipe.dtype).contiguous())
    sym = plans[2] is None
    pipe.qe._cache["_tt_half"] = tuple(plans) + (sym,)


def load_pipeline_pp_planes(pipe, planes: Dict[str, np.ndarray]) -> None:
    """Overwrite a full-plane (``impl == "pallas"``) ``pipe``'s planes in
    place.

    ``planes`` holds every name of ``PP_PLANE_NAMES``, the bin tables
    ``idc`` (flat segment ids), ``icnt`` (inverse counts) and ``nseg``,
    the scalar ``norm``, and the ``qe._tt_pp_plans()`` arrays under
    ``"tt_pp.<name>"`` for ``<name>`` in ``TT_PP_NAMES``, all in the
    doubly-permuted layout.
    """
    if pipe.impl != "pallas":
        raise ValueError("load_pipeline_pp_planes needs a full-plane "
                         "pipeline (impl 'pallas')")
    dev = pipe.device
    as_f32 = lambda a: torch.as_tensor(np.array(a, dtype=np.float32),
                                       device=dev).contiguous()
    for name in PP_PLANE_NAMES:
        setattr(pipe, name, as_f32(planes[name]))
    pipe._idc = torch.as_tensor(np.array(planes["idc"], dtype=np.int32)
                                .ravel(), device=dev)
    pipe._icnt = as_f32(planes["icnt"])
    pipe._nseg = int(planes["nseg"])
    pipe.norm = float(planes["norm"])
    pipe.qe._cache["_tt_pp"] = tuple(as_f32(planes["tt_pp." + name])
                                     for name in TT_PP_NAMES)


def load_fastcl_tables(fc, tables: Dict[str, np.ndarray]) -> None:
    """Overwrite a port ``FastCl``'s tables in place with those of a JAX
    ``FastCl``.

    ``tables`` holds every name of ``FASTCL_TABLE_NAMES`` as numpy arrays
    (``_covsqrt_pp`` may be None); the boundary-row one-hots ``_oh0``
    and ``_ohn`` ``(n, nseg)`` become the row ids that the port bins with
    (their ``argmax`` over axis 1). As the port's own tables, the ids carry
    -1 for the edge segments (``fastcl.drop_edge_segments``).
    """
    dev = fc.device
    nseg = int(tables["_nsg"])
    ids = lambda a: torch.as_tensor(drop_edge_segments(a, nseg), device=dev)
    cs = tables["_covsqrt_pp"]
    fc._covsqrt_pp = None if cs is None else torch.as_tensor(
        np.array(cs, dtype=np.float32), device=dev).contiguous()
    fc._idc = ids(np.asarray(tables["_idc"]).ravel())
    fc._icnt = torch.as_tensor(np.array(tables["_icnt"], dtype=np.float32),
                               device=dev)
    fc._nsg = nseg
    fc._mrow = torch.as_tensor(np.array(tables["_mrow"], dtype=np.int64),
                               device=dev)
    fc._ids0 = ids(np.argmax(np.asarray(tables["_oh0"]), axis=1))
    fc._idsn = ids(np.argmax(np.asarray(tables["_ohn"]), axis=1))
    fc.centers = np.array(tables["centers"], dtype=np.float64)


def load_ilc_weights(w2d: np.ndarray, device=None) -> torch.Tensor:
    """The JAX package's ``(nfreq, n, n)`` per-band ILC weight planes
    (natural layout, as numpy) as a contiguous float32 tensor on
    ``device`` (the card unless it names another), ready for
    ``models.ilc.linear_coadd_fused``."""
    w = np.array(w2d, dtype=np.float32)
    if w.ndim != 3 or w.shape[1] != w.shape[2]:
        raise ValueError(f"ILC weights must be (nfreq, n, n), got {w.shape}")
    return torch.as_tensor(w, device=resolve(device)).contiguous()


def load_sht_tables(tab: dict, host: Dict[str, np.ndarray]) -> dict:
    """A copy of ``tab`` (an ``ops.legendre.tables(lmax, rings, ns, ni,
    layout, device)`` entry) whose kernel tables come from the JAX kernel's
    host tables ``pallas_sht._prep_host(lmax, rings, 128, 256, ns, ni,
    fold)`` (numpy), ``fold`` True for the port's "fold" and "half"
    layouts: the hi/lo recurrence tables ``Ah + Al``, ..., the captured
    seeds ``(sm + sl, smP + slP, se, l0)``. JAX's ``bounds`` are for its
    (128-m, 256-ring) tiles and chunks of 8 l-steps; they are checked against the port's copy of
    ``_bounds_table`` on JAX's ``l0`` and the port's own tile bounds are
    derived from the same ``l0``. Pass the copy to ``legendre_ana`` /
    ``legendre_syn``; ``tab`` and the port's caches are left as they
    were."""
    lmax, Tk = tab["lmax"], tab["Tk"]
    L1 = lmax + 1
    dev = tab["A"].device
    f64 = lambda *names: torch.as_tensor(
        sum(np.asarray(host[n], np.float64) for n in names),
        dtype=torch.float64, device=dev)
    cut = lambda a: a[:Tk, :L1].T.contiguous()
    l0 = np.asarray(host["l0"], np.int32)
    Lp, Mp = np.shape(host["Ah"])
    Tp = np.shape(host["sm"])[0]
    want = legendre._bounds_table(l0[:Tk, :L1], lmax, tab["theta"][:Tk],
                                  128, 256, Lp, Tp, Mp, lc=8)
    if not np.array_equal(want, np.asarray(host["bounds"])):
        raise ValueError("host bounds do not follow from its l0 grid: the "
                         "tables are not _prep_host's for these rings")
    return dict(tab, kernel=legendre._kernel_tables_from(
        lmax, tab["theta"], *(f64(h, lo)[:L1, :L1] for h, lo in
                              (("Ah", "Al"), ("Bh", "Bl"), ("Ch", "Cl"))),
        cut(f64("smP", "slP")), cut(f64("sm", "sl")),
        cut(torch.as_tensor(np.asarray(host["se"], np.int32), device=dev)),
        cut(torch.as_tensor(l0, device=dev))))
