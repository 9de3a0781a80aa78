"""Where the port's entry points put what they create.

Every constructor and factory that makes tensors from nothing takes a
``device`` argument and resolves it here: ``None`` means the card. A caller
who wants the CPU (the tests, a host-side check) says ``device="cpu"``;
nothing falls back to the CPU on its own.
"""
from __future__ import annotations

import torch

__all__ = ["resolve"]


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
