"""Card check and timing of the fused row-power functions: B6
``rowqc_half`` / ``rowqc_pp`` and B6s ``rows_half`` / ``rows_pp``.

Run from the repository root on a machine with one NVIDIA Hopper GPU and
nvcc:

    python3 scripts/bench_rowpower.py [--tree DIR] [--quick]

It imports ``orphics_tpu_torch`` from ``DIR`` (default: this checkout), so
two commits are compared on one card by unpacking the other with ``git
archive`` into a git-ignored directory and running parent, change, change,
parent in one job. It prints the compiler's resource report of the
row-power kernels, registers and blocks per SM where the library can say,
the error against ``rowqc_pp_ref`` / ``rows_pp_ref`` at n = 256 .. 4096 and
n = 384 with two runs bit-equal, and CUDA-event times at FastCl's shapes
with the achieved device-memory rate and the bound, beside B6h
``qc_pp_half`` (a streaming pass that moves B6's bytes and transforms
nothing) and ``torch.fft.fft`` along the rows. ``--quick`` stops after the
checks and one short timing.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

HBM_BYTES_PER_S = 3.35e12


def cuda_ms(fn, reps, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def rel(got, ref):
    return max(((g - r).abs().max() / r.abs().max()).item()
               for g, r in zip(got, ref))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--quick", action="store_true")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_rowpower: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, opts.tree)
    from orphics_tpu_torch import _build
    from orphics_tpu_torch.ops import dft
    from orphics_tpu_torch.ops import rowpower as rp

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"tree: {opts.tree}")
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    lib = _build.library()
    keep = False
    for line in _build.build_log().splitlines():
        if line.startswith("=="):
            keep = line.startswith("== rowpower")
        if keep and ("row_qc" in line or "registers" in line
                     or "spill" in line):
            print("  " + line.strip())
    if hasattr(lib, "rowqc_half_occupancy"):
        for n in (256, 512, 1024, 2048, 4096):
            for s in (0, 1):
                regs = ctypes.c_int(0)
                blocks = lib.rowqc_half_occupancy(n, s, ctypes.byref(regs))
                print(f"occupancy n={n} {'B6s' if s else 'B6'}: {regs.value} "
                      f"registers, {blocks} blocks of 256 threads per SM")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)

    def planes(b, n):
        return tuple(torch.randn((b, n, n), generator=gen, device=dev)
                     for _ in range(2))

    ok = True
    for n, b in ((256, 3), (384, 3), (512, 5), (1024, 3), (2048, 3),
                 (4096, 1)):
        y = planes(b, n)
        ref = rp.rowqc_pp_ref(*y) + rp.rows_pp_ref(*y)
        got = rp.rowqc_pp(*y) + rp.rows_pp(*y)
        again = rp.rowqc_pp(*y) + rp.rows_pp(*y)
        alone = rp.rowqc_half(*y) + (rp.rows_half(*y),)
        torch.cuda.synchronize()
        err = rel(got, ref)
        e_alone = rel(alone, ref[:2] + ref[4:5])
        same = all(torch.equal(g, a) for g, a in zip(got, again))
        good = err <= 1.5e-5 and e_alone <= 1.5e-5 and same
        ok = ok and good
        print(f"check ({b}, {n}, {n}): rowqc_pp and rows_pp (fields and zrow) "
              f"{err:.3e}, rowqc_half and rows_half {e_alone:.3e} of "
              f"max|ref| (<= 1.5e-5); two runs bit-equal: {same}"
              + ("" if good else "  FAILED"))
        del y, ref, got, again, alone
        torch.cuda.empty_cache()
    if not ok:
        return 1

    shapes = ((8, 2048),) if opts.quick else (
        (96, 2048), (64, 2048), (64, 512), (192, 1024), (16, 4096), (64, 256))
    reps = 3 if opts.quick else 10
    for b, n in shapes:
        y = planes(b, n)
        tag = f"({b}, {n}, {n})"
        yc = torch.complex(*y)
        lib_ms = cuda_ms(lambda: torch.fft.fft(yc, dim=-1), reps)
        del yc
        z = dft.rowfft(*y)
        stream_ms = cuda_ms(lambda: rp.qc_pp_half(*z), reps)
        del z
        print(f"time {tag}: torch.fft.fft along the rows {lib_ms:.4f} ms; "
              f"B6h qc_pp_half of the stored transform {stream_ms:.4f} ms")
        for name, nout in (("rowqc_half", 2), ("rows_half", 1),
                           ("rowqc_pp", 2), ("rows_pp", 1)):
            fn = getattr(rp, name)
            ms = cuda_ms(lambda: fn(*y), reps)
            nbytes = 4 * b * n * n * (2 + nout / 2)
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            print(f"time {name} {tag}: {ms:.4f} ms; {nbytes / ms / 1e9:.3f} "
                  f"TB/s of the fields' bytes, bound {bound:.4f} ms = "
                  f"{bound / ms:.3f} of the time")
        del y
        torch.cuda.empty_cache()
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
