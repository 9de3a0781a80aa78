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
    :class:`~orphics_tpu_torch.models.fastcl.FastCl`.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .models.lenspipe import PLANE_NAMES, PP_PLANE_NAMES
from .models.theory import TheorySpectra

__all__ = ["theory_from_numpy", "load_pipeline_planes",
           "load_pipeline_pp_planes", "load_fastcl_tables", "TT_HALF_NAMES",
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
    (their ``argmax`` over axis 1).
    """
    dev = fc.device
    ids = lambda a: torch.as_tensor(np.array(a, dtype=np.int32),
                                    device=dev)
    cs = tables["_covsqrt_pp"]
    fc._covsqrt_pp = None if cs is None else torch.as_tensor(
        np.array(cs, dtype=np.float32), device=dev).contiguous()
    fc._idc = ids(np.asarray(tables["_idc"]).ravel())
    fc._icnt = torch.as_tensor(np.array(tables["_icnt"], dtype=np.float32),
                               device=dev)
    fc._nsg = int(tables["_nsg"])
    fc._mrow = torch.as_tensor(np.array(tables["_mrow"], dtype=np.int64),
                               device=dev)
    fc._ids0 = ids(np.argmax(np.asarray(tables["_oh0"]), axis=1))
    fc._idsn = ids(np.argmax(np.asarray(tables["_ohn"]), axis=1))
    fc.centers = np.array(tables["centers"], dtype=np.float64)
