"""Timing of the redesigned kernels: B6 ``rowqc_half`` / ``rowqc_pp`` and
B6s ``rows_half`` / ``rows_pp`` (``--kernel rowpower``), B3 ``colfft`` /
``colifft`` and B3s ``colfft_scaled`` (``--kernel colfft``), B4 ``rowfft``
/ ``rowifft`` / ``rowifft_scaled_y``, B5 ``rowifft_noise_y`` and B4b
``rowfft_blk0`` (``--kernel rowfft``), the Legendre kernels B10a
``legendre_ana`` and B10s ``legendre_syn`` (``--kernel legendre``), the
lensing displacement B8 ``lens_map_kernel`` (``--kernel lens``) and the
segment sums B1 ``bin_reduce``, B2 ``bin2_reduce`` and B2'
``bin_pair_power`` (``--kernel binreduce``).

Run from the repository root on a machine with one NVIDIA Hopper GPU and
nvcc:

    python3 scripts/bench_kernels.py --kernel
        {rowpower,colfft,rowfft,legendre,lens,binreduce} [--tree DIR] [--quick]

It imports ``orphics_tpu_torch`` from ``DIR`` (default: this checkout), so
two commits are compared on one card by unpacking the other with ``git
archive`` into a git-ignored directory and running parent, change, change,
parent in one job. It prints the compiler's resource report of the family's
kernels (registers and spills, from the ``-Xptxas -v`` build log) and, at
the main paths' shapes, each function's CUDA-event time, achieved
device-memory rate and bound, its error against the plain version, the
library call (``torch.fft`` along the same axis) and, for ``colfft`` and
``rowfft``, the kernel each call took where the library counts it. The bound
printed is the bytes' alone (B5's, which its Philox and erfinvf work sets,
is ``chip_smoke.py``'s). ``--quick`` times one small shape. ``legendre``
times B10a and B10s, dd and fast, at ``chip_smoke.py`` phase 2's shapes
(bench configs 8, 8p and 7) and at 16 folded maps, with the launches each
call took and the bound from phase 2's operation count. ``lens`` times
B8 at ``chip_smoke.py`` phase 2's (64, 1, 512^2) with config 6's
deflection (a kappa GRF, D = 8), orders 5 and 3, three components, and
phase 14's unclipped D, with the blocks that took their taps from device
memory where the tree counts them. ``binreduce`` times B1, B2 and B2' at
bench config 1's half plane (96 rows of 2048^2 / 2) over FastCl's full
digitized ids and over the kept ones (edge segments -1), B1 at the
lensing pipeline's (192, 131,584) weighted, and B2' at phase 13's full
plane; each bound counts the 32-byte sectors that hold a kept id, the ids
and the outputs once, and each error is read against float64 sums of
|data| made here, so that a tree whose plain versions predate dropped ids
is timed the same way. The correctness checks (every n, ragged shapes,
two runs bit-equal) are ``chip_smoke.py``'s and
``tests/test_torch_cuda.py``'s.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
FP64_FLOP_PER_S = 34e12
# B10: (label, lmax, maps, Wigner columns, layout, columns timed)
LEGENDRE_SHAPES = (("config 8", 1023, 8, (0,), "fold", (0,)),
                   ("16 folded maps", 1023, 16, (0,), "fold", (0,)),
                   ("config 8p", 1023, 16, (-2, 2), "half", (0, 1)),
                   ("config 7", 2047, 1, (0,), "fold", (0,)))
SHAPES = ((96, 2048), (64, 2048), (64, 512), (192, 1024), (16, 4096),
          (64, 256))


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


def rowpower_cases(y, gen):
    """(name, call, plain call, bytes moved) of B6 / B6s on planes y, and
    the library call and a streaming pass that moves B6's bytes"""
    from orphics_tpu_torch.ops import dft
    from orphics_tpu_torch.ops import rowpower as rp
    b, n, _ = y[0].shape
    field = 4 * b * n * n
    cases = (("rowqc_half", lambda: rp.rowqc_half(*y),
              lambda: rp.rowqc_pp_ref(*y)[:2], 3 * field),
             ("rows_half", lambda: (rp.rows_half(*y),),
              lambda: rp.rows_pp_ref(*y)[:1], 2.5 * field),
             ("rowqc_pp", lambda: rp.rowqc_pp(*y), lambda: rp.rowqc_pp_ref(*y),
              3 * field),
             ("rows_pp", lambda: rp.rows_pp(*y), lambda: rp.rows_pp_ref(*y),
              2.5 * field))
    yc = torch.complex(*y)
    z = dft.rowfft(*y)
    refs = (("torch.fft.fft along the rows", lambda: torch.fft.fft(yc, dim=-1)),
            ("B6h qc_pp_half of the stored transform",
             lambda: rp.qc_pp_half(*z)))
    return cases, refs


def colfft_cases(x, gen):
    """(name, call, plain call, bytes moved) of B3 / B3s on planes x, and
    the library calls"""
    from orphics_tpu_torch.ops import dft
    b, n, c = x[0].shape
    w = torch.rand((n, c), generator=gen, device=x[0].device)
    planes = 16 * b * n * c
    cases = (("colfft", lambda: dft.colfft(*x), lambda: dft.colfft_ref(*x),
              planes),
             ("colifft", lambda: dft.colifft(*x), lambda: dft.colifft_ref(*x),
              planes),
             ("colfft_scaled", lambda: dft.colfft_scaled(*x, w),
              lambda: dft.colfft_scaled_ref(*x, w), planes + 4 * n * c))
    xc = torch.complex(*x)
    refs = (("torch.fft.fft along the columns",
             lambda: torch.fft.fft(xc, dim=-2)),
            ("torch.fft.ifft along the columns",
             lambda: torch.fft.ifft(xc, dim=-2)))
    return cases, refs


def rowfft_cases(x, gen):
    """(name, call, plain call, bytes moved) of B4 and B5 on planes x (B5
    draws planes of x's shape), and the library calls and B4b"""
    from orphics_tpu_torch.ops import dft
    from orphics_tpu_torch.ops.noise_planes import noise_planes
    b, r, n = x[0].shape
    w = torch.rand((r, n), generator=gen, device=x[0].device) + 0.5
    words = torch.tensor([20260512, -77], dtype=torch.int32,
                         device=x[0].device)
    planes = 16 * b * r * n
    cases = (("rowfft", lambda: dft.rowfft(*x), lambda: dft.rowfft_ref(*x),
              planes),
             ("rowifft", lambda: dft.rowifft(*x), lambda: dft.rowifft_ref(*x),
              planes),
             ("rowifft_scaled_y", lambda: dft.rowifft_scaled_y(*x, w),
              lambda: dft.rowifft_scaled_y_ref(*x, w), planes + 4 * r * n),
             # against B4's inverse of B5n's identical draw
             ("rowifft_noise_y", lambda: dft.rowifft_noise_y(w, words, b),
              lambda: dft.rowifft(*noise_planes(w, words, b)),
              planes // 2 + 4 * r * n))
    xc = torch.complex(*x)
    refs = (("torch.fft.fft along the rows", lambda: torch.fft.fft(xc, dim=-1)),
            ("torch.fft.ifft along the rows",
             lambda: torch.fft.ifft(xc, dim=-1)),
            ("B4b rowfft_blk0", lambda: dft.rowfft_blk0(*x)))
    return cases, refs


def legendre_bench(reps, quick):
    """B10a / B10s at LEGENDRE_SHAPES (``quick``: config 8 only), dd and
    fast: CUDA-event time, launches per call and the bound of
    ``chip_smoke.py`` phase 2 (5 operations a live step for the recurrence
    in fp64 in dd, 9 in fp32 in fast, 4 a map and step for the contraction at
    the fp32 rate; the tables, the input and the output once)."""
    from orphics_tpu_torch.ops import legendre as leg
    from orphics_tpu_torch.ops import sht
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(10)
    for label, lmax, nm, ns, layout, nis in (
            LEGENDRE_SHAPES[:1] if quick else LEGENDRE_SHAPES):
        rings = sht.gauss_legendre_rings(lmax)
        M1 = lmax + 1
        for ni in nis:
            tab = leg.tables(lmax, rings, ns, ni, layout, dev)
            k = leg.kernel_tables(tab)
            ls = k["ls"]
            steps = float(((M1 - ls) * (ls >= 0)).sum().item())
            G = torch.complex(*(torch.randn((nm, tab["Tr"], M1),
                                            generator=gen, device=dev)
                                for _ in range(2)))
            a = torch.complex(*(torch.randn((nm, M1, M1), generator=gen,
                                            device=dev) for _ in range(2)))
            tabb = sum(t.numel() * t.element_size() for t in
                       (tab["A"], tab["B"], tab["C"], k["s1"], k["s0"], ls))
            for name, fn, x, out_b in (
                    ("legendre_ana", leg.legendre_ana, G, 8 * nm * M1 * M1),
                    ("legendre_syn", leg.legendre_syn, a,
                     8 * nm * tab["Tr"] * M1)):
                for mode in ("dd", "fast"):
                    fast = mode == "fast"
                    before = fn.launches
                    fn(x, tab, fast)
                    torch.cuda.synchronize()
                    launches = fn.launches - before
                    ms = cuda_ms(lambda: fn(x, tab, fast), reps)
                    rec = (9.0 if fast else 5.0) * steps
                    t_ops = ((rec if fast else 0.0) + 4.0 * nm * steps) \
                        / FP32_FLOP_PER_S + (0.0 if fast else rec) \
                        / FP64_FLOP_PER_S
                    t_bytes = (x.numel() * x.element_size() + tabb + out_b) \
                        / HBM_BYTES_PER_S
                    bound = max(t_ops, t_bytes) * 1e3
                    print(f"time {name} {label} lmax {lmax} x{nm} {layout} "
                          f"n={ns[ni]} {mode}: {ms:.4f} ms in {launches} "
                          f"launch(es); bound {bound:.4f} ms "
                          f"({'operations' if t_ops >= t_bytes else 'bytes'})"
                          f" = {bound / ms:.3f} of the time")
            del G, a
        leg.clear_tables()
        torch.cuda.empty_cache()


def lens_bench(reps, quick):
    """B8 at phase 2's shape with config 6's deflection: CUDA-event time,
    bytes bound, error against ``lens_map_ref`` and, where the tree counts
    them, the blocks that took their taps from device memory."""
    import numpy as np
    from orphics_tpu_torch import rect_geometry
    from orphics_tpu_torch.models import grf, lensing
    from orphics_tpu_torch.models.theory import default_theory
    from orphics_tpu_torch.ops.lens import (lens_map_kernel, lens_map_ref,
                                            spline_coeffs)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    geom = rect_geometry(width_arcmin=512 * 2.0, px_res_arcmin=2.0)
    th = default_theory()
    ells = np.arange(int(geom.lmax()) + 1)
    kgen = grf.MapGen(geom, np.asarray(th.gCl("kk", ells))[None, None],
                      device=dev)
    cgen = grf.MapGen(geom, np.asarray(th.uCl("TT", ells))[None, None],
                      device=dev)
    batch = 8 if quick else 64
    alpha = lensing.alpha_from_kappa(kgen.get_map(gen, batch=(batch,)),
                                     geom).contiguous()
    print(f"config 6 deflection: max|alpha|/dy "
          f"{(alpha.abs().max() / geom.dy).item():.3f}")
    wide = getattr(lens_map_kernel, "wide_blocks", None)
    for C, order, D in ((1, 5, 8), (1, 3, 8), (3, 5, 8),
                        (1, 5, max(geom.shape))):
        cmb = cgen.get_map(gen, batch=(batch, C))
        coeffs = spline_coeffs(cmb, geom, order).contiguous()
        del cmb
        if wide:
            wide(reset=True)
        out = lens_map_kernel(coeffs, alpha, geom, order=order, maxdisp_px=D,
                              prefiltered=True)
        nwide = f"; wide blocks {wide()}" if wide else ""
        ref = lens_map_ref(coeffs, alpha, geom, order, D)
        err = ((out - ref).abs().max() / ref.abs().max()).item()
        ms = cuda_ms(lambda: lens_map_kernel(coeffs, alpha, geom, order=order,
                                             maxdisp_px=D, prefiltered=True),
                     reps)
        nbytes = 4.0 * alpha[:, 0].numel() * (2 + 2 * C)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"time lens_map_kernel ({batch}, {C}, 512, 512) order {order} "
              f"D={D}: {ms:.4f} ms; {nbytes / ms / 1e9:.3f} TB/s, bound "
              f"{bound:.4f} ms = {bound / ms:.3f} of the time; error "
              f"{err:.3e} of max|ref|{nwide}")
        del coeffs, out, ref
        torch.cuda.empty_cache()


def binreduce_bench(reps, quick):
    """B1, B2 and B2' over bench config 1's full and kept ids: CUDA-event
    time, the bound of ``chip_smoke.py`` phase 2 (the 32-byte sectors that
    hold a kept id, the ids and the outputs), error against float64 sums
    made here."""
    import numpy as np
    from orphics_tpu_torch import rect_geometry
    from orphics_tpu_torch.ops import dft
    from orphics_tpu_torch.ops.binning import RfftBin2D
    from orphics_tpu_torch.ops.bin_reduce import (bin2_reduce, bin_pair_power,
                                                  bin_reduce)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    n = 2048
    geom = rect_geometry(width_arcmin=n * 0.5, px_res_arcmin=0.5)
    edges = np.arange(80, 8000, 80.0)
    nseg = len(edges) + 1
    perm, _ = dft.row_perm(n)
    dig = np.digitize(geom.modlmap_np()[perm][:, perm], edges,
                      right=True).astype(np.int32)
    drop = lambda a: np.where((a == 0) | (a == nseg - 1), -1, a)
    half = dig[dft.half_rows(n)[0]].reshape(-1)
    as_ids = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.int32),
                                       device=dev)
    id_sets = (("full ids", as_ids(half), as_ids(dig.reshape(-1))),
               ("kept ids", as_ids(drop(half)), as_ids(drop(dig.ravel()))))

    def exact(x, ids, nseg, w=None):
        """float64 sums of x and of |x| over the ids in [0, nseg)"""
        idx = torch.where((ids >= 0) & (ids < nseg), ids, nseg).long()
        xd = x.double() * (1.0 if w is None else w.double())
        s = torch.zeros((x.shape[0], nseg + 1), dtype=torch.float64,
                        device=dev)
        a = torch.zeros_like(s)
        s.index_add_(1, idx, xd)
        a.index_add_(1, idx, xd.abs())
        return s[:, :-1], a[:, :-1]

    def report(name, tag, ms, outs, refs, planes, ids, nseg):
        kept = (ids >= 0) & (ids < nseg)
        kept = torch.nn.functional.pad(kept, (0, (-kept.numel()) % 8))
        sectors = kept.view(-1, 8).any(1).sum().item()
        nbytes = (sectors * 32 * planes[0].shape[0] * len(planes)
                  + 4 * ids.numel() + sum(4 * o.numel() for o in outs))
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        err = max(((o.double() - s).abs() / a.clamp_min(1e-300)).max().item()
                  for o, (s, a) in zip(outs, refs))
        print(f"time {name} {tag}: {ms:.4f} ms; bound {bound:.4f} ms (bytes "
              f"of the {sectors} live 32-byte sectors of "
              f"{kept.numel() // 8})"
              f" = {bound / ms:.3f} of the time; error {err:.3e} of the "
              "binned |data|")

    rows = 8 if quick else 96
    d1, d2 = (torch.randn((rows, n * n // 2), generator=gen, device=dev)
              for _ in range(2))
    for tag, ids, _ in id_sets:
        tag = f"({rows}, {n * n // 2}) {tag} nseg {nseg}"
        out = bin2_reduce(d1, d2, ids, nseg)
        ms = cuda_ms(lambda: bin2_reduce(d1, d2, ids, nseg), reps)
        report("bin2_reduce", tag, ms, out,
               (exact(d1, ids, nseg), exact(d2, ids, nseg)), (d1, d2), ids,
               nseg)
        out = bin_reduce(d1, ids, nseg)
        ms = cuda_ms(lambda: bin_reduce(d1, ids, nseg), reps)
        report("bin_reduce", tag, ms, (out,), (exact(d1, ids, nseg),),
               (d1,), ids, nseg)
    del d1, d2
    # B1 at the lensing pipeline's RfftBin2D (3 spectra x 64, weighted)
    g512 = rect_geometry(width_arcmin=512 * 2.0, px_res_arcmin=2.0)
    rb = RfftBin2D(g512, np.arange(40, 3000, 80.0), device=dev)
    x = torch.randn((192, rb._ids.numel()), generator=gen, device=dev)
    out = bin_reduce(x, rb._ids, rb._nseg, rb._w)
    ms = cuda_ms(lambda: bin_reduce(x, rb._ids, rb._nseg, rb._w), reps)
    report("bin_reduce", f"(192, {rb._ids.numel()}) RfftBin2D weighted nseg "
           f"{rb._nseg}", ms, (out,), (exact(x, rb._ids, rb._nseg, rb._w),),
           (x,), rb._ids, rb._nseg)
    del x
    # B2' at phase 13's full plane, 96 pairs
    four = [torch.randn((rows, n * n), generator=gen, device=dev)
            for _ in range(4)]
    zr, zi, mr, mi = four
    q, c = zr * zr + zi * zi, zr * mr - zi * mi
    for tag, _, ids in id_sets:
        out = bin_pair_power(*four, ids, nseg)
        ms = cuda_ms(lambda: bin_pair_power(*four, ids, nseg), reps)
        report("bin_pair_power", f"({rows}, {n * n}) x 4 {tag} nseg {nseg}",
               ms, out, (exact(q, ids, nseg), exact(c, ids, nseg)), four, ids,
               nseg)


# family -> (cases, sources whose resource report is printed, shapes,
# counter of the register-resident kernel's launches or None)
FAMILIES = {"rowpower": (rowpower_cases, ("rowpower.cu",), SHAPES, None),
            "colfft": (colfft_cases, ("colfft.cu",), SHAPES,
                       "colfft_regs_launches"),
            "rowfft": (rowfft_cases, ("rowfft.cu", "rowpower.cu"),
                       ((96, 2048), (64, 512)), "rowfft_regs_launches"),
            "legendre": (legendre_bench, ("legendre.cu",), (), None),
            "lens": (lens_bench, ("lens_spline.cu",), (), None),
            "binreduce": (binreduce_bench, ("bin_reduce.cu",), (), None)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=sorted(FAMILIES), required=True)
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--quick", action="store_true")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_kernels: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, opts.tree)
    from orphics_tpu_torch import _build

    cases_of, sources, shapes, counter_name = FAMILIES[opts.kernel]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"tree: {opts.tree}; kernel family {opts.kernel}")
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    lib = _build.library()
    keep = False
    for line in _build.build_log().splitlines():
        if line.startswith("=="):
            keep = line[3:].strip() in sources
        if keep and ("entry function" in line or "registers" in line
                     or "spill" in line):
            print("  " + line.strip())
    # the register-resident kernel's launch counter (absent in trees
    # without that kernel)
    counter = getattr(lib, counter_name, None) if counter_name else None

    reps = 3 if opts.quick else 10
    if not shapes:
        cases_of(reps, opts.quick)    # a family with its own shapes
        print(f"card: {card}")
        return 0
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    for b, n in ((8, 2048),) if opts.quick else shapes:
        x = tuple(torch.randn((b, n, n), generator=gen, device=dev)
                  for _ in range(2))
        tag = f"({b}, {n}, {n})"
        cases, refs = cases_of(x, gen)
        for name, fn in refs:
            print(f"time {tag} {name}: {cuda_ms(fn, reps):.4f} ms")
        for name, fn, ref_fn, nbytes in cases:
            before = counter() if counter else 0
            err = rel(fn(), ref_fn())
            route = ""
            if counter:
                route = ("; register-resident kernel" if counter() > before
                         else "; radix-2 kernel")
            ms = cuda_ms(fn, reps)
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            print(f"time {name} {tag}: {ms:.4f} ms; {nbytes / ms / 1e9:.3f} "
                  f"TB/s, bound {bound:.4f} ms = {bound / ms:.3f} of the time;"
                  f" error {err:.3e} of max|ref|{route}")
        del x, cases, refs
        torch.cuda.empty_cache()
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
