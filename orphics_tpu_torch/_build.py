"""Build and load the port's CUDA kernels.

All ``csrc/*.cu`` sources are compiled by ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface, loaded
with ctypes. The build runs at first use into ``orphics_tpu_torch/_build/``
(listed in ``.gitignore``), keyed by a hash of the sources, so a fresh
checkout builds its kernels from the sources it holds. Nothing is
compiled at import; a failed build raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["library", "build_log", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_VP = ctypes.c_void_p
_INT = ctypes.c_int
_F32 = ctypes.c_float
# name -> (argtypes, restype) of every exported C function
_SIGNATURES = {
    "bin_reduce_launch": ([_VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT, _VP],
                          _INT),
    "bin_reduce_chunk": ([], _INT),
    "bin_reduce_max_nseg": ([], _INT),
    "lens_spline_launch": ([_VP, _VP, _VP, _INT, _INT, _INT, _INT, _F32,
                            _F32, _INT, _INT, _VP], _INT),
}


def _sources():
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (put it on PATH or set CUDA_HOME); "
                       "the port's CUDA kernels cannot be built")


def _digest():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _lib_path():
    return BUILD_DIR / f"liborphics_tpu_torch_{_digest()}.so"


def build_log() -> str:
    """The compiler's output of the current build (ptxas register and
    shared-memory report), or '' if this checkout has not built yet."""
    log = _lib_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    path = _lib_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cu = [str(p) for p in sorted(SRC_DIR.glob("*.cu"))]
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError("nvcc failed:\n" + " ".join(cmd) + "\n"
                               + res.stdout + res.stderr)
        path.with_suffix(".log").write_text(res.stdout + res.stderr)
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
