"""Carry state across from the JAX package.

This system has no weights: its state is the theory tables and the
precomputed planes of a pipeline. Both cross as numpy arrays, so this
module needs neither jax nor ``orphics_tpu``:

  * :func:`theory_from_numpy` builds a :class:`TheorySpectra` from
    ``orphics_tpu``'s ``TheorySpectra.tables`` (as numpy);
  * :func:`load_pipeline_planes` overwrites a port
    :class:`~orphics_tpu_torch.models.lenspipe.LensedQEPipeline`'s planes
    with those of a JAX pipeline, so ``core`` can be held to the JAX step
    separately from the planes' own construction.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .models.lenspipe import PLANE_NAMES
from .models.theory import TheorySpectra

__all__ = ["theory_from_numpy", "load_pipeline_planes", "TT_HALF_NAMES"]

# the arrays of QE._tt_half_plans(), in its tuple order (sym excluded)
TT_HALF_NAMES = ("wa0", "wag", "wb0", "wbg", "post", "Lh")


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
