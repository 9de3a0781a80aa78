"""Where the port's entry points put what they create.

Every constructor and factory that makes tensors from nothing takes a
``device`` argument and resolves it here: ``None`` means the card. A caller
who wants the CPU (the tests, a host-side check) says ``device="cpu"``;
nothing falls back to the CPU on its own.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve", "as_tensor", "device_of", "to_numpy"]


def resolve(device=None) -> torch.device:
    """``None`` -> ``cuda``; an explicit device passes through. Raises if
    the card is asked for (by ``None`` or by name) and CUDA is not
    available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the card by "
            "default: pass device=\"cpu\" to run on the CPU")
    return dev


def as_tensor(x, device=None, dtype=None) -> torch.Tensor:
    """A tensor keeps its device (cast to ``dtype`` if one is given); a host
    number or array becomes a tensor (of ``dtype``, else its own) on
    ``resolve(device)``, copied so that it shares no memory with the
    caller's array."""
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(dtype)
    return torch.as_tensor(np.array(x), dtype=dtype, device=resolve(device))


def device_of(x, device=None) -> torch.device:
    """The device of a tensor ``x``; for a host array, ``resolve(device)``."""
    return x.device if isinstance(x, torch.Tensor) else resolve(device)


def to_numpy(x):
    """A tensor (on any device) or an array-like as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
