"""Vectorized root finding (port of ``orphics_tpu.ops.algorithms``;
reference ``orphics/algorithms.py:4``)."""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve

__all__ = ["vectorized_bisection_search"]


def vectorized_bisection_search(x, inv_func, ybounds, monotonicity,
                                rtol=1e-4, max_iter=200, verbose=False,
                                hang_check_num_iter=None, device=None):
    """Find y(x) given the inverse x(y) by elementwise bisection.

    The loop of the JAX function: every element halves its bracket until
    all relative residuals are within ``rtol`` or ``max_iter`` steps ran.
    ``x`` as a tensor keeps its device; a host array becomes float64 on
    ``device`` (``None``: the card). ``inv_func`` takes and returns
    tensors. ``verbose`` and ``hang_check_num_iter`` are accepted for the
    reference's signature; the hang check is ``max_iter``.
    """
    if hang_check_num_iter is not None:
        max_iter = max(max_iter, 10 * hang_check_num_iter)
    if monotonicity not in ("increasing", "decreasing"):
        raise ValueError(monotonicity)
    inc = monotonicity == "increasing"
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x, dtype=np.float64),
                            device=resolve(device))
    yl = torch.full_like(x, ybounds[0])
    yr = torch.full_like(x, ybounds[1])
    tol = torch.full_like(x, float("inf"))
    i = 0
    while i < max_iter and bool((tol.abs() > rtol).any()):
        ynow = 0.5 * (yl + yr)
        tol = (inv_func(ynow) - x) / x
        up, down = tol > 0, tol <= 0
        if inc:
            yr = torch.where(up, ynow, yr)
            yl = torch.where(down, ynow, yl)
        else:
            yl = torch.where(up, ynow, yl)
            yr = torch.where(down, ynow, yr)
        i += 1
    return 0.5 * (yl + yr)
