"""Linear interpolation on tensors (the port's ``jnp.interp``).

PyTorch has no ``interp``; this one follows ``jnp.interp``'s arithmetic
(``searchsorted(side='right')``, clipped to the interior, then
``fp[i-1] + (x - xp[i-1]) / dx * df``) in the dtype of ``x``, with the
``left``/``right`` fill values. Every table lookup of the port uses it.
"""
from __future__ import annotations

import torch

__all__ = ["interp"]


def interp(x: torch.Tensor, xp, fp, left=0.0, right=0.0) -> torch.Tensor:
    """Evaluate the piecewise-linear function ``(xp, fp)`` at ``x``.

    ``xp`` must be sorted and one-dimensional; ``xp`` and ``fp`` (numpy or
    tensors) are cast to ``x``'s dtype and device first, as ``jnp.interp``
    promotes them. Points below ``xp[0]`` get ``left``, points above
    ``xp[-1]`` get ``right``.
    """
    xp = torch.as_tensor(xp, dtype=x.dtype, device=x.device)
    fp = torch.as_tensor(fp, dtype=x.dtype, device=x.device)
    if xp.ndim != 1 or xp.shape != fp.shape:
        raise ValueError("xp and fp must be one-dimensional of equal size")
    i = torch.searchsorted(xp, x.contiguous(), right=True)
    i = i.clamp(1, xp.shape[0] - 1)
    x0 = xp[i - 1]
    f0 = fp[i - 1]
    dx = xp[i] - x0
    df = fp[i] - f0
    dx0 = dx == 0
    f =torch.where(dx0, f0, f0 + ((x - x0) / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], torch.as_tensor(left, dtype=x.dtype,
                                               device=x.device), f)
    return torch.where(x > xp[-1], torch.as_tensor(right, dtype=x.dtype,
                                                   device=x.device), f)
