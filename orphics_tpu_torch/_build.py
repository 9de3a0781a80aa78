"""Build and load the port's CUDA kernels.

All ``csrc/*.cu`` sources are compiled by ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` process per source, all started together, and
linked into one shared library with a plain C interface, loaded with
ctypes. The build runs at first use into ``orphics_tpu_torch/_build/``
(listed in ``.gitignore``), keyed by a hash of the sources, so a fresh
checkout builds its kernels from the sources it holds. Nothing is
compiled at import; a failed build raises.

The one host library, ``csrc/healpix.cpp`` (HEALPix pixel math with
OpenMP), is built by ``g++`` the same way (:func:`healpix_library`):
digest-named, into a temporary directory, then renamed into place, so
that processes building at once do not race. Where it does not build,
the caller runs its numpy code instead.
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

__all__ = ["library", "build_log", "healpix_library", "healpix_build_log",
           "NVCC_FLAGS", "HOST_FLAGS"]

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

# the host library: no -march=native and no contraction into FMAs, so
# that its float64 arithmetic rounds as numpy's does
HOST_FLAGS = ["-O3", "-fPIC", "-shared", "-fopenmp", "-std=c++17",
              "-ffp-contract=off"]

_VP = ctypes.c_void_p
_INT = ctypes.c_int
_I64 = ctypes.c_longlong
_F32 = ctypes.c_float
# name -> (argtypes, restype) of every exported C function
_SIGNATURES = {
    "bin_reduce_launch": ([_VP] * 5 + [_INT] * 5 + [_VP], _INT),
    "bin_reduce64_launch": ([_VP] * 5 + [_INT] * 5 + [_VP], _INT),
    "bin2_reduce_launch": ([_VP] * 5 + [_INT] * 5 + [_VP], _INT),
    "bin_pair_power_launch": ([_VP] * 7 + [_INT] * 6 + [_VP], _INT),
    "bin_reduce_nspan": ([_INT, _INT, _INT], _INT),
    "bin_reduce_seg_cap": ([], _INT),
    "lens_spline_launch": ([_VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT,
                            _F32, _F32, _INT, _INT, _VP], _INT),
    "lens_spline_tile_rows": ([], _INT),
    "lens_spline_tile_cols": ([], _INT),
    "lens_spline_window_range": ([], _INT),
    "dft_launch": ([_VP, _VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT,
                    _INT, _VP], _INT),
    "dft_noise_launch": ([_VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT, _VP],
                         _INT),
    "dft_max_n": ([], _INT),
    "colfft_regs_launches": ([], _I64),
    "rowfft_regs_launches": ([], _I64),
    "rowqc_half_launch": ([_VP] * 7 + [_INT, _INT, _VP], _INT),
    "rows_half_launch": ([_VP] * 6 + [_INT, _INT, _VP], _INT),
    "rowqc_half_occupancy": ([_INT, _INT, _VP], _INT),
    "qc_pp_half_launch": ([_VP, _VP, _VP, _VP, _INT, _INT, _VP], _INT),
    "s_pp_half_launch": ([_VP, _VP, _VP, _INT, _INT, _VP], _INT),
    "rowcombine_launch": ([_VP] * 9 + [_INT, _INT, _INT, _VP], _INT),
    "rowcombine_regs_launches": ([], _I64),
    "rowfft_blk0_launch": ([_VP, _VP, _VP, _VP, _VP, _INT, _INT, _VP], _INT),
    "noise_planes_launch": ([_VP, _VP, _VP, _VP, _INT, _I64, _VP], _INT),
    "mirror_launch": ([_VP, _VP, _VP, _VP, _VP, _INT, _INT, _VP], _INT),
    "legendre_ana_launch": ([_VP] * 12 + [_INT] * 13 + [_VP], _INT),
    "legendre_ana1_launch": ([_VP] * 12 + [_INT] * 10 + [_VP], _INT),
    "legendre_syn_launch": ([_VP] * 12 + [_INT] * 10 + [_VP], _INT),
    "qe_leg_launch": ([_VP] * 3 + [_INT, _INT, _I64, _INT, _VP], _INT),
    "qe_pair_launch": ([_VP] * 2 + [_INT] + [_VP] * 4 + [_INT] + [_VP] * 4
                       + [_INT, _I64, _INT, _VP], _INT),
    "qe_post_launch": ([_VP] * 4 + [_INT, _I64, _INT, _VP], _INT),
    "qe_conv_max_legs": ([], _INT),
    "qe_conv_max_products": ([], _INT),
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
        _compile_and_link(path)
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def _compile_and_link(path: Path) -> None:
    """One nvcc per source, all running at once, then one link; the
    compiler output goes to the ``.log`` beside the library."""
    nvcc = _nvcc()
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        jobs = []
        for src in sorted(SRC_DIR.glob("*.cu")):
            obj = work / (src.stem + ".o")
            log = open(work / (src.stem + ".log"), "w")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            try:
                proc = subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT)
            finally:
                log.close()
            jobs.append((src, obj, cmd, proc))
        logs, failed = [], []
        for src, obj, cmd, proc in jobs:
            proc.wait()
            out = (work / (src.stem + ".log")).read_text()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(" ".join(cmd) + "\n" + out)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp = work / path.name
        cmd = [nvcc, *_ARCH, "-shared", "-o", str(tmp),
               *(str(obj) for _, obj, _, _ in jobs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + " ".join(cmd) + "\n"
                               + res.stdout + res.stderr)
        path.with_suffix(".log").write_text("".join(logs) + res.stdout
                                            + res.stderr)
        os.replace(tmp, path)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def check(err: int, what: str) -> None:
    """Raise if a C launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def _healpix_path():
    h = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    h.update((SRC_DIR / "healpix.cpp").read_bytes())
    return BUILD_DIR / f"liborphics_healpix_{h.hexdigest()[:16]}.so"


def healpix_build_log() -> str:
    """Why the host library did not build (the compiler's output, or that
    there is no compiler), or '' if it built or was not tried."""
    log = _healpix_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


@functools.lru_cache(maxsize=None)
def healpix_library():
    """Build (once per source hash) and load ``csrc/healpix.cpp`` with
    ``g++``; ``None`` where there is no compiler or the build fails
    (:func:`healpix_build_log` says why)."""
    path = _healpix_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cxx = shutil.which("g++")
        if cxx is None:
            path.with_suffix(".log").write_text("no g++ on PATH\n")
            return None
        work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
        try:
            tmp = work / path.name
            cmd = [cxx, *HOST_FLAGS, "-o", str(tmp), str(SRC_DIR /
                                                        "healpix.cpp")]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                path.with_suffix(".log").write_text(
                    " ".join(cmd) + "\n" + res.stdout + res.stderr)
                return None
            os.replace(tmp, path)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    lib = ctypes.CDLL(str(path))
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.ang2pix_ring_z.argtypes = [ctypes.c_long, f64p, f64p, i64p,
                                   ctypes.c_long]
    lib.ang2pix_ring_z.restype = None
    lib.pix2z_ring.argtypes = [ctypes.c_long, i64p, f64p, f64p,
                               ctypes.c_long]
    lib.pix2z_ring.restype = None
    return lib
