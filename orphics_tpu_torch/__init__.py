"""orphics_tpu_torch: the PyTorch / CUDA (Hopper) port of ``orphics_tpu``.

The package mirrors ``orphics_tpu``'s module paths. It imports torch and
numpy only, never jax: the JAX package is the reference that the tests
hold each ported function against. Theory tables are read by file path
from ``orphics_tpu/data``.

Hand-written CUDA kernels live in ``csrc/`` and are built with ``nvcc`` at
first use (see :mod:`orphics_tpu_torch._build`); every kernel wrapper runs
its plain PyTorch version for a CPU tensor and its kernel for a CUDA one.
"""
from .geometry import Geometry, rect_geometry, arcmin, degree

__all__ = ["Geometry", "rect_geometry", "arcmin", "degree"]
