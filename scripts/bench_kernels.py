"""The port's kernels timed alone, one family a run: at the main paths'
shapes, each function's CUDA-event time, achieved device-memory rate and
least time (its bound, by ``cmbbench/work.py``), its error against its
plain version, and the library call beside it.

    rowpower      B6 ``rowqc_half`` / ``rowqc_pp``, B6s ``rows_half`` /
                  ``rows_pp``, B6h ``qc_pp_half`` and B6h' ``s_pp_half`` on
                  the stored transform; ``torch.fft`` along the rows
    colfft        B3 ``colfft`` / ``colifft``, B3s ``colfft_scaled``;
                  ``torch.fft`` along the columns
    rowfft        B4 ``rowfft`` / ``rowifft`` / ``rowifft_scaled_y``, B5
                  ``rowifft_noise_y``, B4b ``rowfft_blk0``; ``torch.fft``
                  along the rows
    mirror        B7 ``mirror_pp`` at the lensing pipeline's (32, 512^2)
    qeconv        Q1-Q3 ``qe_leg``, ``qe_pair``, ``qe_post`` at the cell
                  lensqe512.recon's (64, 512^2) complex64
    legendre      B10a ``legendre_ana`` and B10s ``legendre_syn``, dd and
                  fast, at bench configs 8, 8p (n = -2, 2, 16 maps) and 7,
                  16 folded maps, layout "full" (a rank's 2048 rings) and
                  the curved-sky QE's 16 syntheses on 3072 rings
    legendre_ana  B10a alone at those shapes, the curved-sky QE's 12
                  folded products and one map on its grid, with the
                  one-pass launches and partial planes a call took
    sht_io        the curved-sky QE's 16-map synthesis and 12-map analysis
                  (lmax 2047, 3072 x 6144 rings) on the scalar SHT's
                  layouts, B10s from packed alms into the half spectrum
                  and B10a from the rfft output into packed alms, beside
                  the matrix layouts with their PyTorch passes: the
                  kernels alone and with cuFFT
    lens          B8 ``lens_map_kernel`` at (64, 1, 512^2) with config 6's
                  deflection (a kappa GRF, D = 8), orders 5 and 3, three
                  components, and phase 14's unclipped D
    binreduce     B1 ``bin_reduce``, B2 ``bin2_reduce`` and B2'
                  ``bin_pair_power`` over FastCl's full and kept ids (edge
                  segments -1) at bench config 1, B1 at 400 segments, at
                  the lensing pipeline's RfftBin2D and over Bin2D's ids at
                  the flagship step, bench config 5, the pure-B path and,
                  in float64, the galaxy-catalog path (beside one
                  ``index_add_``)
    rowcombine    B9 ``rowcombine_pp`` at bench config 4's (96, 512^2), nq
                  3, and at (6, 384^2); the row transform alone beside
    noise         B5n ``noise_planes`` at (32, 512^2) and (3, 5, 7), its
                  device time in a profiler trace, ``torch.randn`` of the
                  same values beside; first the digests of a few draws of
                  B5n and B5 on fixed words, equal on two trees where the
                  stream is

Run from the repository root on a machine with one NVIDIA Hopper GPU and
nvcc:

    python3 scripts/bench_kernels.py --kernel FAMILY [--tree DIR] [--quick]

It imports ``orphics_tpu_torch`` from ``DIR`` (default: this checkout) and
the roofline from this checkout's ``cmbbench/work.py``, so two commits are
compared on one card against one yardstick: unpack the other with ``git
archive`` into a git-ignored directory and run parent, change, change,
parent in one job. It prints the compiler's resource report of the
family's kernels (registers and spills, from the ``-Xptxas -v`` build log)
and, for ``colfft``, ``rowfft`` and ``rowcombine``, the kernel each call
took where the tree counts it. A bound counts each input byte read once and
each output byte written once; B5's is printed with its operations beside
the bytes' (its transform, ~25 fp32 operations a normal and Philox's
integer instructions). B10's counts the live (ring, m,
l) steps of the captured seeds (:func:`b10_steps`), where the benchmark's
``cmbbench/work_sht.py`` counts them from the reference's underflow
threshold. A segment sum's counts the 32-byte sectors that hold a kept id.
``--quick`` times one small shape. The correctness checks (every n, ragged
shapes, two runs bit-equal, the route) are ``chip_smoke.py``'s and
``tests/test_torch_cuda.py``'s.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

# the roofline comes from this checkout, before --tree puts another tree's
# packages first on the path
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from cmbbench.work import (FP32_FLOP_PER_S, FP64_FLOP_PER_S,  # noqa: E402
                           HBM_BYTES_PER_S, NORMAL_FP32_OPS,
                           PHILOX_INT_OPS_PER_PAIR, bin_bytes, bound,
                           fft_flops, live_sectors, ops_ms)

# B10: (label, lmax, maps, Wigner columns, layout, columns timed,
# Gauss-Legendre rings: None for lmax + 1)
LEGENDRE_SHAPES = (("config 8", 1023, 8, (0,), "fold", (0,), None),
                   ("16 folded maps", 1023, 16, (0,), "fold", (0,), None),
                   ("config 8p", 1023, 16, (-2, 2), "half", (0, 1), None),
                   ("config 7", 2047, 1, (0,), "fold", (0,), None),
                   ("layout full", 2047, 1, (0,), "full", (0,), None),
                   ("curved QE syntheses", 2047, 16, (0,), "fold", (0,),
                    3071))
# B10a alone (--kernel legendre_ana): those, the curved-sky QE's folded
# products (12 maps on the 3072 rings exact to degree 3 lmax) and one map
# on that grid
LEGENDRE_ANA_SHAPES = LEGENDRE_SHAPES + (
    ("curved QE", 2047, 12, (0,), "fold", (0,), 3071),
    ("curved grid, one map", 2047, 1, (0,), "fold", (0,), 3071))
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


def device_ms(fn, reps):
    """Device time per call of ``fn``: its kernels' time in a
    ``torch.profiler`` trace of ``reps`` calls, no host time between them."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) \
        / reps / 1e3


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def rel(got, ref):
    as_tuple = lambda t: t if isinstance(t, tuple) else (t,)
    return max(((g - r).abs().max() / r.abs().max()).item()
               for g, r in zip(as_tuple(got), as_tuple(ref)))


def b10_steps(tab, ktab):
    """The live (ring, m, l) steps of a B10 call: from each (ring, m)'s
    captured seed l_s to lmax, none where it has no seed."""
    ls = ktab["ls"]
    return float(((tab["lmax"] + 1 - ls) * (ls >= 0)).sum().item())


def b10_work(x, tab, ktab, out_b, nm, steps, fast):
    """(bytes, fp32, fp64 operations) of one B10a / B10s call on ``nm`` maps
    of ``x``: bytes x in, the output (``out_b``), the tables once.
    Operations per live step: the recurrence's two FMAs and a multiply (5,
    in fp64; fp32 in fast, with two FMAs more for the factor's low parts:
    9), and per map the complex contraction's two FMAs (4), counted at the
    fp32 rate (67 TFLOP/s), which is also the fp64 tensor cores' rate that
    B10a and B10s contract at."""
    rec = (9.0 if fast else 5.0) * steps
    return (nbytes(x, tab["A"], tab["B"], tab["C"], ktab["s1"], ktab["s0"],
                   ktab["ls"]) + out_b,
            (rec if fast else 0.0) + 4.0 * nm * steps, 0.0 if fast else rec)


def rowpower_cases(y, gen):
    """(name, call, plain call, bytes moved) of B6 / B6s on planes y and of
    B6h / B6h' on their stored transform z, and the library call"""
    from orphics_tpu_torch.ops import dft
    from orphics_tpu_torch.ops import rowpower as rp
    b, n, _ = y[0].shape
    field = 4 * b * n * n
    z = dft.rowfft(*y)
    cases = (("rowqc_half", lambda: rp.rowqc_half(*y),
              lambda: rp.rowqc_pp_ref(*y)[:2], 3 * field),
             ("rows_half", lambda: (rp.rows_half(*y),),
              lambda: rp.rows_pp_ref(*y)[:1], 2.5 * field),
             ("rowqc_pp", lambda: rp.rowqc_pp(*y), lambda: rp.rowqc_pp_ref(*y),
              3 * field),
             ("rows_pp", lambda: rp.rows_pp(*y), lambda: rp.rows_pp_ref(*y),
              2.5 * field),
             # the stored transform in, the half-plane fields out
             ("qc_pp_half", lambda: rp.qc_pp_half(*z),
              lambda: rp.qc_pp_half_ref(*z), 3 * field),
             ("s_pp_half", lambda: rp.s_pp_half(*z),
              lambda: rp.s_pp_half_ref(*z), 2.5 * field))
    yc = torch.complex(*y)
    refs = (("torch.fft.fft along the rows",
             lambda: torch.fft.fft(yc, dim=-1)),)
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
    """(name, call, plain call, bytes moved[, operations]) of B4 and B5 on
    planes x (B5 draws planes of x's shape), and the library calls and
    B4b"""
    from orphics_tpu_torch.ops import dft
    from orphics_tpu_torch.ops.noise_planes import noise_planes
    b, r, n = x[0].shape
    w = torch.rand((r, n), generator=gen, device=x[0].device) + 0.5
    words = torch.tensor([20260512, -77], dtype=torch.int32,
                         device=x[0].device)
    planes = 16 * b * r * n
    values = b * r * n
    cases = (("rowfft", lambda: dft.rowfft(*x), lambda: dft.rowfft_ref(*x),
              planes),
             ("rowifft", lambda: dft.rowifft(*x), lambda: dft.rowifft_ref(*x),
              planes),
             ("rowifft_scaled_y", lambda: dft.rowifft_scaled_y(*x, w),
              lambda: dft.rowifft_scaled_y_ref(*x, w), planes + 4 * r * n),
             # against B4's inverse of B5n's identical draw; operations: the
             # transform, a normal's and Philox's a pair
             ("rowifft_noise_y", lambda: dft.rowifft_noise_y(w, words, b),
              lambda: dft.rowifft(*noise_planes(w, words, b)),
              planes // 2 + 4 * r * n,
              (fft_flops(n, b * r) + NORMAL_FP32_OPS * 2 * values, 0.0,
               PHILOX_INT_OPS_PER_PAIR * values / 2)))
    xc = torch.complex(*x)
    refs = (("torch.fft.fft along the rows", lambda: torch.fft.fft(xc, dim=-1)),
            ("torch.fft.ifft along the rows",
             lambda: torch.fft.ifft(xc, dim=-1)),
            ("B4b rowfft_blk0", lambda: dft.rowfft_blk0(*x)))
    return cases, refs


def mirror_cases(z, gen):
    """(name, call, plain call, bytes moved) of B7 on planes z; no PyTorch
    call gathers Z(-k) in the permuted layout"""
    from orphics_tpu_torch.ops.mirror import mirror_pp, mirror_pp_ref
    b, n, _ = z[0].shape
    return (("mirror_pp", lambda: mirror_pp(*z), lambda: mirror_pp_ref(*z),
             16 * b * n * n),), ()


def qeconv_cases(x, gen):
    """(name, call, plain call, bytes moved) of Q1-Q3 on the k-map x[0] +
    i x[1]: its three legs, S_y and S_x from them, the post of two spectra.
    No PyTorch call computes this algebra"""
    from orphics_tpu_torch.ops import qe_conv as qc
    _, n, _ = x[0].shape
    dev = x[0].device
    k = torch.complex(*x)
    planes3 = torch.randn((3, n, n), generator=gen, device=dev)
    legs3 = qc.qe_leg(k, planes3)
    post2 = torch.randn((2, n, n), generator=gen, device=dev)
    pairs2 = ((0, 2.0, 1, 0), (1, 2.0, 2, 0))
    return (("qe_leg", lambda: qc.qe_leg(k, planes3),
             lambda: qc.qe_leg_ref(k, planes3),
             nbytes(k, planes3) + 3 * nbytes(k)),
            ("qe_pair", lambda: qc.qe_pair(legs3, pairs2, None),
             lambda: qc.qe_pair_ref(legs3, pairs2, None),
             nbytes(*legs3) + 2 * nbytes(k)),
            ("qe_post", lambda: qc.qe_post(legs3[0], legs3[1], post2),
             lambda: qc.qe_post_ref(legs3[0], legs3[1], post2),
             3 * nbytes(k) + nbytes(post2))), ()


def legendre_bench(reps, quick, shapes=LEGENDRE_SHAPES, ana_only=False):
    """B10a / B10s at ``shapes`` (``quick``: config 8 only), dd and
    fast: CUDA-event time, launches per call and the bound of
    :func:`b10_work`. With ``ana_only``, B10a alone, with the one-pass
    launches and partial planes a call took where the tree counts them."""
    from orphics_tpu_torch.ops import legendre as leg
    from orphics_tpu_torch.ops import sht
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(10)
    for label, lmax, nm, ns, layout, nis, nrings in (
            shapes[:1] if quick else shapes):
        rings = sht.gauss_legendre_rings(nrings or lmax)
        M1 = lmax + 1
        for ni in nis:
            tab = leg.tables(lmax, rings, ns, ni, layout, dev)
            k = leg.kernel_tables(tab)
            steps = b10_steps(tab, k)
            G = torch.complex(*(torch.randn((nm, tab["Tr"], M1),
                                            generator=gen, device=dev)
                                for _ in range(2)))
            a = torch.complex(*(torch.randn((nm, M1, M1), generator=gen,
                                            device=dev) for _ in range(2)))
            for name, fn, x, out_b in (
                    ("legendre_ana", leg.legendre_ana, G, 8 * nm * M1 * M1),
                    ("legendre_syn", leg.legendre_syn, a,
                     8 * nm * tab["Tr"] * M1))[:1 if ana_only else 2]:
                for mode in ("dd", "fast"):
                    fast = mode == "fast"
                    names = ("launches", "one_pass", "partial_planes")
                    counts = [getattr(fn, c, 0) for c in names]
                    fn(x, tab, fast)
                    torch.cuda.synchronize()
                    launches, one_pass, planes = (
                        getattr(fn, c, 0) - b for c, b in zip(names, counts))
                    how = (f" ({one_pass} one-pass, {planes} partial "
                           f"planes)" if ana_only else "")
                    ms = cuda_ms(lambda: fn(x, tab, fast), reps)
                    bms, by = bound(*b10_work(x, tab, k, out_b, nm, steps,
                                              fast))
                    print(f"time {name} {label} lmax {lmax} x{nm} {layout} "
                          f"n={ns[ni]} {mode}: {ms:.4f} ms in {launches} "
                          f"launch(es){how}; bound {bms:.4f} ms ({by}; "
                          f"{steps:.6e} live steps) = {bms / ms:.3f} of the "
                          "time")
            del G, a
        leg.clear_tables()
        torch.cuda.empty_cache()


def sht_io_bench(reps, quick):
    """The curved-sky QE's scalar transforms, ``quick``: at lmax 255. Per
    direction: the kernel on the matrix layouts and on the scalar SHT's
    (packed alms, the half spectrum in place), with the bound of
    :func:`b10_work`; then the whole transform without and with the
    layouts (the matrix layouts' pack, phase, pad, scale and weight passes
    against none), each with its cuFFT call, and the two results' gap.
    Trees without the layouts (``legendre_syn.ring_io`` absent) time the
    matrix layouts alone."""
    from orphics_tpu_torch.ops import legendre as leg
    from orphics_tpu_torch.ops import sht
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(26)
    lmax = 255 if quick else 2047
    rings = sht.gauss_legendre_rings(-(-3 * lmax // 2))
    M1, T, nh = lmax + 1, rings.ntheta, rings.nphi // 2 + 1
    tab = leg.tables(lmax, rings, (0,), 0, "fold", dev)
    k = leg.kernel_tables(tab)
    steps = b10_steps(tab, k)
    layouts = hasattr(leg.legendre_syn, "ring_io")
    cplx = lambda *s: torch.complex(*(torch.randn(s, generator=gen,
                                                  device=dev)
                                      for _ in range(2)))
    # B10s: the QE's 16 syntheses
    a = sht._mat2alm(cplx(16, M1, M1), lmax)
    mat = sht._alm2mat(a, lmax)
    cases = [("legendre_syn matrix layouts", mat,
              lambda: leg.legendre_syn(mat, tab), 8 * 16 * T * M1)]
    if layouts:
        cases.append(("legendre_syn packed alms -> half spectrum", a,
                      lambda: leg.legendre_syn(a, tab, False, None, True, nh),
                      8 * 16 * T * nh))
    for label, x, fn, out_b in cases:
        bms, by = bound(*b10_work(x, tab, k, out_b, 16, steps, False))
        ms = cuda_ms(fn, reps)
        print(f"time {label} lmax {lmax} x16 fold: {ms:.4f} ms; bound "
              f"{bms:.4f} ms ({by}) = {bms / ms:.3f} of the time")
    old = lambda: sht._ring_synthesis(leg.legendre_syn(sht._alm2mat(
        a, lmax), tab), rings)
    steps_syn = [("alm2map, matrix layouts and passes", old)]
    if layouts:
        steps_syn.append(("alm2map, the kernel's layouts", lambda: (
            sht._synthesis_rings(a, rings, lmax, tab, False))))
    for label, fn in steps_syn:
        print(f"time {label} lmax {lmax} x16 with cuFFT: "
              f"{cuda_ms(fn, reps):.4f} ms")
    maps = old()
    if layouts:
        print(f"alm2map gap, kernel's layouts vs matrix layouts: "
              f"{rel(steps_syn[1][1](), maps):.3e} of max")
    del a, mat
    # B10a: the QE's 12 analyses
    maps = maps[:12].contiguous()
    F = torch.fft.rfft(maps, dim=-1)
    w = sht._weights(rings, torch.float32, dev)
    w64 = sht._weights(rings, torch.float64, dev)
    G = (F[..., :M1] * w[:, None]).contiguous()
    cases = [("legendre_ana matrix layouts", G,
              lambda: leg.legendre_ana(G, tab), 8 * 12 * M1 * M1)]
    if layouts:
        # the kernel reads M1 of the nh columns
        cases.append(("legendre_ana rfft output in place -> packed alms",
                      F[..., :M1], lambda: leg.legendre_ana(
                          F, tab, False, w64, None, True),
                      8 * 12 * M1 * (M1 + 1) // 2))
    for label, x, fn, out_b in cases:
        bms, by = bound(*b10_work(x, tab, k, out_b, 12, steps, False))
        ms = cuda_ms(fn, reps)
        print(f"time {label} lmax {lmax} x12 fold: {ms:.4f} ms; bound "
              f"{bms:.4f} ms ({by}) = {bms / ms:.3f} of the time")
    old = lambda: sht._mat2alm(leg.legendre_ana(sht._ring_analysis(
        maps, rings, lmax) * w[:, None], tab), lmax)
    steps_ana = [("map2alm, matrix layouts and passes", old)]
    if layouts:
        steps_ana.append(("map2alm, the kernel's layouts", lambda: (
            sht._analysis_rings(maps, rings, lmax, tab, False))))
    for label, fn in steps_ana:
        print(f"time {label} lmax {lmax} x12 with cuFFT: "
              f"{cuda_ms(fn, reps):.4f} ms")
    if layouts:
        print(f"map2alm gap, kernel's layouts vs matrix layouts: "
              f"{rel(steps_ana[1][1](), old()):.3e} of max")
    fft_ms = cuda_ms(lambda: torch.fft.rfft(maps, dim=-1), reps)
    ifft_ms = cuda_ms(lambda: torch.fft.irfft(F, n=rings.nphi, dim=-1),
                      reps)
    print(f"time rfft x12 alone: {fft_ms:.4f} ms; irfft x12 alone: "
          f"{ifft_ms:.4f} ms")
    leg.clear_tables()
    torch.cuda.empty_cache()


def lens_bench(reps, quick):
    """B8 at (64, 1, 512^2) with config 6's deflection: CUDA-event time,
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
        nb = 4.0 * alpha[:, 0].numel() * (2 + 2 * C)
        bms = bound(nb)[0]
        print(f"time lens_map_kernel ({batch}, {C}, 512, 512) order {order} "
              f"D={D}: {ms:.4f} ms; {nb / ms / 1e9:.3f} TB/s, bound "
              f"{bms:.4f} ms = {bms / ms:.3f} of the time; error "
              f"{err:.3e} of max|ref|{nwide}")
        del coeffs, out, ref
        torch.cuda.empty_cache()


def binreduce_bench(reps, quick):
    """B1, B2 and B2' over bench config 1's full and kept ids, B1 at 400
    segments and at the lensing pipeline's RfftBin2D: CUDA-event time, the
    bound of the 32-byte sectors that hold a kept id, the ids and the
    outputs, error against float64 sums made here. Then B1 over Bin2D's ids
    (every pixel an id, the edge segments summed and cut off) at the
    flagship step, bench config 5, the pure-B path and, in float64, the
    galaxy-catalog path, beside one ``index_add_`` of the same data."""
    import numpy as np
    from orphics_tpu_torch import Geometry, rect_geometry
    from orphics_tpu_torch.geometry import arcmin
    from orphics_tpu_torch.ops import dft
    from orphics_tpu_torch.ops.binning import Bin2D, RfftBin2D
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

    def error(outs, refs):
        return max(((o.double() - s).abs() / a.clamp_min(1e-300)).max().item()
                   for o, (s, a) in zip(outs, refs))

    def report(name, tag, ms, outs, refs, planes, ids, nseg):
        ids_np = ids.cpu().numpy()
        sectors = live_sectors(ids_np, nseg)
        B, N = planes[0].shape
        bms = bound(bin_bytes(ids_np, nseg, (B, N, len(planes)),
                              sum(4 * o.numel() for o in outs)))[0]
        print(f"time {name} {tag}: {ms:.4f} ms; bound {bms:.4f} ms (bytes "
              f"of the {sectors} live 32-byte sectors of "
              f"{-(-ids_np.size // 8)}) = {bms / ms:.3f} of the time; error "
              f"{error(outs, refs):.3e} of the binned |data|")

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
    # B1 over dl = 20 edges out to l = 8000 (400 segments, two tiles)
    ids400 = as_ids(np.digitize(geom.modlmap_np()[perm][:, perm][
        dft.half_rows(n)[0]].ravel(), np.arange(20, 8000, 20.0), right=True))
    out = bin_reduce(d1, ids400, 400)
    ms = cuda_ms(lambda: bin_reduce(d1, ids400, 400), reps)
    report("bin_reduce", f"({rows}, {n * n // 2}) nseg 400", ms, (out,),
           (exact(d1, ids400, 400),), (d1,), ids400, 400)
    del d1, d2, ids400
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
    del four, zr, zi, mr, mi, q, c
    torch.cuda.empty_cache()
    # B1 over Bin2D's ids; bound: the data, ids and output once, one add an
    # element (fp64 for float64 data)
    g64 = Geometry(64, 64, 0.5 * arcmin, 0.5 * arcmin)
    g1024 = rect_geometry(width_arcmin=1024 * 2.0, px_res_arcmin=2.0)
    for tag, ml, bins, b, dtype in (
            ("flagship", g512.modlmap_np(),
             np.arange(40, min(1000, int(g512.ellmax_safe() * 0.8)), 60.0),
             1, torch.float32),
            ("config 5", g64.modrmap_np(),
             np.arange(0.0, 10.0, 1.0) * arcmin, 10_000, torch.float32),
            ("pure-B", g1024.modlmap_np(), np.arange(300, 2500, 200.0), 48,
             torch.float32),
            ("galaxy catalogs, float64", geom.modlmap_np(),
             np.arange(200.0, 3001.0, 200.0), 24, torch.float64)):
        bins2d = Bin2D(ml, bins, device=dev)
        ids, ns = bins2d._ids, bins2d._nseg
        b = min(b, 8) if quick else b
        x = torch.randn((b, ids.numel()), generator=gen, device=dev,
                        dtype=dtype)
        out = bin_reduce(x, ids, ns)
        err = error((out,), (exact(x, ids, ns),))
        ms = cuda_ms(lambda: bin_reduce(x, ids, ns), reps)
        acc = torch.zeros((b, ns), dtype=dtype, device=dev)
        ids_l = ids.long()
        lib = cuda_ms(lambda: acc.index_add_(1, ids_l, x), reps)
        f64 = dtype == torch.float64
        bms, by = bound(nbytes(x, ids, out), 0.0 if f64 else x.numel(),
                        x.numel() if f64 else 0.0)
        kept = ""
        if tag == "pure-B":
            # the sectors of kept ids, had Bin2D dropped its edge segments
            ids_np = ids.cpu().numpy()
            ids_np = np.where((ids_np > 0) & (ids_np < ns - 1), ids_np, -1)
            kb = bound(bin_bytes(ids_np, ns, (b, ids.numel(), 1),
                                 4 * out.numel()))[0]
            kept = f"; {kb:.4f} ms for the sectors of kept ids"
        print(f"time bin_reduce {tag} ({b}, {ids.numel()}) "
              f"{str(dtype).replace('torch.', '')} nseg {ns}: {ms:.4f} ms; "
              f"bound {bms:.4f} ms ({by}{kept}) = {bms / ms:.3f} of the "
              f"time; error {err:.3e} of the binned |data|; index_add_ "
              f"{lib:.4f} ms")
        del x, out, acc, ids_l
        torch.cuda.empty_cache()


def rowcombine_cases(y, gen):
    """(name, call, plain call, bytes moved) of B9 on pair planes y with
    nq 3 (1 where the pairs are not a multiple of 3; Y, the weights and the
    coadd planes once each), and the library call: the row transform
    alone"""
    from orphics_tpu_torch.ops.rowcombine import (rowcombine_pp,
                                                  rowcombine_pp_ref)
    npt, n, _ = y[0].shape
    nq = 3 if npt % 3 == 0 else 1
    w = tuple(torch.randn((nq, n, n), generator=gen, device=y[0].device)
              for _ in range(4))
    nb = 8 * npt * n * n + 16 * nq * n * n + 8 * (npt // nq) * n * n
    cases = (("rowcombine_pp", lambda: rowcombine_pp(*y, *w, nq),
              lambda: rowcombine_pp_ref(*y, *w, nq), nb),)
    yc = torch.complex(*y)
    refs = (("torch.fft.fft along the rows (the row transform alone)",
             lambda: torch.fft.fft(yc, dim=-1)),)
    return cases, refs


def noise_bench(reps, quick):
    """B5n at the lensing pipeline's (32, 512^2) and at (3, 5, 7): CUDA-event
    time, the bound (bytes: the scale, the words and the two outputs once;
    operations: a normal's fp32 operations a value and Philox's integer
    instructions a pair), and one ``torch.randn`` of the same values (the
    draw alone)."""
    import hashlib
    from orphics_tpu_torch.ops import dft
    from orphics_tpu_torch.ops.noise_planes import noise_planes
    dev = torch.device("cuda")
    words = torch.tensor([123456789, -98765], dtype=torch.int32, device=dev)
    # the stream's digest: equal digests on two trees mean the same bits
    # (tests/test_torch_cuda.py::test_noise_stream_is_pinned holds them)
    for tag, outs in (
            ("B5n (3, 64, 64)", noise_planes(
                torch.ones((64, 64), device=dev), words, 3)),
            ("B5n (3, 5, 7)", noise_planes(
                torch.ones((5, 7), device=dev), words, 3)),
            ("B5 (2, 256, 256)", dft.rowifft_noise_y(
                torch.ones((256, 256), device=dev), words, 2))):
        h = hashlib.sha256()
        for o in outs:
            h.update(o.cpu().numpy().tobytes())
        print(f"stream {tag}: sha256 {h.hexdigest()[:16]}")
    for batch, shape in ((8, (512, 512)),) if quick else (
            (32, (512, 512)), (3, (5, 7))):
        scale = torch.linspace(0.5, 2.0, shape[0] * shape[1],
                               device=dev).reshape(shape)
        values = batch * scale.numel()
        ms = cuda_ms(lambda: noise_planes(scale, words, batch), reps)
        dev_ms = device_ms(lambda: noise_planes(scale, words, batch), reps)
        draw = cuda_ms(lambda: torch.randn((2, batch) + shape, device=dev),
                       reps)
        nb = 4 * scale.numel() + 8 + 8 * values
        ops = (NORMAL_FP32_OPS * 2 * values, 0.0,
               PHILOX_INT_OPS_PER_PAIR * values / 2)
        bms, by = bound(nb, *ops)
        print(f"time noise_planes ({batch}, {shape[0]}, {shape[1]}) x 2: "
              f"{ms:.4f} ms (device time in a profiler trace {dev_ms:.4f} "
              f"ms); bound {bms:.4f} ms ({by}: bytes "
              f"{bound(nb)[0]:.4f}, operations {ops_ms(*ops):.4f}) = "
              f"{bms / ms:.3f} of the time; torch.randn of the same "
              f"values (the draw alone) {draw:.4f} ms")


# family -> (cases, sources whose resource report is printed, shapes,
# counter of the register-resident kernel's launches or None)
FAMILIES = {"rowpower": (rowpower_cases, ("rowpower.cu",), SHAPES, None),
            "colfft": (colfft_cases, ("colfft.cu",), SHAPES,
                       "colfft_regs_launches"),
            "rowfft": (rowfft_cases, ("rowfft.cu", "rowpower.cu"),
                       ((96, 2048), (64, 512)), "rowfft_regs_launches"),
            "mirror": (mirror_cases, ("mirror.cu",), ((32, 512),), None),
            "qeconv": (qeconv_cases, ("qe_conv.cu",), ((64, 512),), None),
            "legendre": (legendre_bench, ("legendre.cu",), (), None),
            "legendre_ana": (
                lambda reps, quick: legendre_bench(
                    reps, quick, LEGENDRE_ANA_SHAPES, ana_only=True),
                ("legendre.cu",), (), None),
            "sht_io": (sht_io_bench, ("legendre.cu",), (), None),
            "lens": (lens_bench, ("lens_spline.cu",), (), None),
            "binreduce": (binreduce_bench, ("bin_reduce.cu",), (), None),
            "rowcombine": (rowcombine_cases, ("rowcombine.cu",),
                           ((96, 512), (6, 384)), "rowcombine_regs_launches"),
            "noise": (noise_bench, ("noise.cu",), (), None)}


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
    print(f"peaks (cmbbench/work.py): HBM {HBM_BYTES_PER_S / 1e12} TB/s, fp32 "
          f"{FP32_FLOP_PER_S / 1e12} and fp64 {FP64_FLOP_PER_S / 1e12} "
          "TFLOP/s")
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
        for name, fn, ref_fn, nb, *ops in cases:
            before = counter() if counter else 0
            err = rel(fn(), ref_fn())
            route = ""
            if counter:
                route = ("; register-resident kernel" if counter() > before
                         else "; radix-2 kernel")
            ms = cuda_ms(fn, reps)
            bms = bound(nb)[0]
            line = (f"time {name} {tag}: {ms:.4f} ms; {nb / ms / 1e9:.3f} "
                    f"TB/s, bound {bms:.4f} ms = {bms / ms:.3f} of the time")
            if ops:
                full, by = bound(nb, *ops[0])
                line += (f"; with its operations {full:.4f} ms ({by}) = "
                         f"{full / ms:.3f}")
            print(f"{line}; error {err:.3e} of max|ref|{route}")
        del x, cases, refs
        torch.cuda.empty_cache()
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
