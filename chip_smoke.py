"""Card check of the PyTorch / CUDA port: build its kernels, hold each to
its plain PyTorch version at the main path's shapes, drive the flagship
step and both paths of the lensing pipeline on the card, and check what
comes out.

Run from the repository root on a machine with one NVIDIA Hopper GPU
and nvcc:

    python3 chip_smoke.py

Phases: 0 card, 1 build, 2 kernels vs plain versions, 3 flagship step,
4 half-plane pipeline, 5 full-plane pipeline (the path ``impl="auto"``
takes at 512^2), 6 FastCl at the JAX package's bench config 1 (2048^2,
0.5', batch 192, nseg 100). Phases 3-6 each set the launch counts to 0
before they drive their path and check them after; 4-6 print throughput,
peak memory, device time by kernel, a statistical check of the output and
the card-vs-CPU agreement.
The JSON object on a line before the last holds each kernel's launches
(on the full-plane lensing path for the kernels it runs, on the FastCl
path for the rest), error and times; the last line is
``{"ok": true, "device": {"platform": "gpu", ...}}``. Any failed check
raises, so the exit code is non-zero and no result line is printed. It
imports nothing of JAX.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch


def check(cond, msg):
    if not cond:
        raise RuntimeError("check failed: " + msg)


def rel_err(got, ref):
    """(max abs error, max abs error / max|ref|) over paired planes."""
    err = max((g - r).abs().max().item() for g, r in zip(got, ref))
    scale = max(r.abs().max().item() for r in ref)
    return err, err / scale


def profile_steps(step, nsteps, step_ms, tag):
    """Device time by kernel over ``nsteps`` steps (torch.profiler), and
    the busy share against the unprofiled step time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(nsteps):
            step()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    kern.sort(key=lambda e: -e.self_device_time_total)
    dev_ms = sum(e.self_device_time_total for e in kern) / (nsteps * 1e3)
    print(f"[{tag}] device time {dev_ms:.4f} ms per step = "
          f"{dev_ms / step_ms:.3f} of the unprofiled step time; top kernels "
          "(ms per step):")
    for e in kern[:12]:
        print(f"[{tag}]   {e.self_device_time_total / (nsteps * 1e3):9.4f}  "
              f"{e.count // nsteps:4d}x  {e.key[:90]}")


def throughput(step, batch, nsteps, label, unit, card, tag):
    """Rate of ``step()`` after two warm-up steps (host clock around steps
    ending in a synchronize), with the peak memory; returns ms per step."""
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(nsteps):
        step()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[{tag}] {label}: {nsteps * batch / dt:.2f} {unit} "
          f"({dt / nsteps * 1e3:.3f} ms/step over {nsteps} steps, peak "
          f"{peak:.3f} GiB) on {card}")
    return dt / nsteps * 1e3


def pipeline_rate(pipe, batch, gen, nsteps, card, tag):
    """Throughput of ``pipe.step``."""
    return throughput(lambda: pipe.step(batch, gen), batch, nsteps,
                      f"pipeline impl={pipe.impl} 512^2 2' beam 1.4' 6 uK' "
                      f"order 5 batch {batch}", "sims/s", card, tag)


def ratio_gate(pipe, batch, gen, tag):
    """The 128-sim cross/auto_in check of tests/test_lensing.py."""
    outs = torch.cat([pipe.step(batch, gen) for _ in range(128 // batch)])
    check(bool(torch.isfinite(outs).all()), f"{tag}: pipeline output not "
                                            "finite")
    cross = outs[:, 0].double().mean(0)
    auto_in = outs[:, 1].double().mean(0)
    ratio = (cross / auto_in).cpu().numpy()
    dev_ratio = float(np.mean(np.abs(ratio - 1.0)))
    check(dev_ratio < 0.06, f"{tag}: cross/auto_in mean|ratio-1| = "
                            f"{dev_ratio:.4f}")
    print(f"[{tag}] {outs.shape[0]} sims: cross/auto_in mean|ratio-1| = "
          f"{dev_ratio:.4f} over {ratio.size} bins (< 0.06)")


def spectra_err(got, ref):
    """Max error as a share of each spectrum's max, (B, 3, nbins)."""
    scale = np.abs(ref).max(axis=(0, 2), keepdims=True)
    return float(np.max(np.abs(got - ref) / scale))


def cuda_ms(fn, reps, warmup=2):
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
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


def card_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def main():
    # ---- 0. card
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    from orphics_tpu_torch import _build, rect_geometry
    from orphics_tpu_torch.entry import entry
    from orphics_tpu_torch.models import grf, lensing
    from orphics_tpu_torch.models.lenspipe import LensedQEPipeline
    from orphics_tpu_torch.models.theory import default_theory
    from orphics_tpu_torch.models.fastcl import FastCl
    from orphics_tpu_torch.ops import dft
    from orphics_tpu_torch.ops.bin_reduce import (bin2_reduce,
                                                  bin2_reduce_ref,
                                                  bin_reduce, bin_reduce_ref)
    from orphics_tpu_torch.ops.binning import Bin2D, RfftBin2D
    from orphics_tpu_torch.ops.lens import (lens_map_kernel, lens_map_ref,
                                            spline_coeffs)
    from orphics_tpu_torch.ops.mirror import mirror_pp, mirror_pp_ref
    from orphics_tpu_torch.ops.noise_planes import (noise_planes,
                                                    noise_planes_ref)
    from orphics_tpu_torch.ops.rowpower import (rowqc_half, rowqc_pp,
                                                rowqc_pp_ref)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[0] card: {card}")
    print(f"[0] device: {kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; devices visible: {torch.cuda.device_count()}")

    # ---- 1. build
    t0 = time.perf_counter()
    _build.library()
    print(f"[1] build: {time.perf_counter() - t0:.3f} s (nvcc "
          f"{' '.join(_build.NVCC_FLAGS)}, one process per source)")
    for line in _build.build_log().splitlines():
        if ("registers" in line or "spill" in line or "Compiling" in line
                or line.startswith("==")):
            print("[1]   " + line.strip())

    # ---- 2. kernels vs plain versions at the main path's shapes
    geom = rect_geometry(width_arcmin=512 * 2.0, px_res_arcmin=2.0)
    th = default_theory()
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    lmax_grid = geom.ellmax_safe()
    results = {}

    # B1: RfftBin2D of the pipeline (3 spectra x batch 64, weights 2/1,
    # 36 bins) and Bin2D of the flagship step (one plane, 15 bins)
    pipe_edges = np.arange(40, min(3000, int(lmax_grid * 0.8)), 80.0)
    rb = RfftBin2D(geom, pipe_edges, device=dev)
    flag_edges = np.arange(40, min(1000, int(lmax_grid * 0.8)), 60.0)
    fb = Bin2D(geom.modlmap_np(), flag_edges, device=dev)
    b1_err = 0.0
    b1_times = None
    for label, B, ids, nseg, w in (
            ("rfft", 192, rb._ids, rb._nseg, rb._w),
            ("full", 1, fb._ids, fb._nseg, None)):
        n = ids.shape[0]
        data = torch.randn((B, n), generator=gen, device=dev) ** 2 - 0.5
        out = bin_reduce(data, ids, nseg, w)
        again = bin_reduce(data, ids, nseg, w)
        ref = bin_reduce_ref(data, ids, nseg, w)
        absref = bin_reduce_ref(data.abs(), ids, nseg, w)
        torch.cuda.synchronize()
        err = (out - ref).abs()
        rel = (err / absref.clamp_min(1e-30)).max().item()
        check(rel <= 1e-6, f"B1 {label}: error {rel:.3e} of binned |data| "
                           "> 1e-6")
        check(torch.equal(out, again), f"B1 {label}: two runs differ")
        b1_err = max(b1_err, err.max().item())
        ms = cuda_ms(lambda: bin_reduce(data, ids, nseg, w), 50)
        plain = cuda_ms(lambda: bin_reduce_ref(data, ids, nseg, w), 10)
        print(f"[2] B1 bin_reduce {label} ({B}, {n}) nseg={nseg}: max rel err "
              f"{rel:.3e} of binned |data|, reproducible; kernel {ms:.4f} ms,"
              f" plain {plain:.4f} ms")
        if b1_times is None:
            b1_times = (ms, plain)
    results["bin_reduce"] = dict(
        name="bin_reduce", route="cuda",
        source="orphics_tpu_torch/csrc/bin_reduce.cu",
        replaces="orphics_tpu/ops/pallas_kernels.py:94",
        max_abs_err=b1_err, ms=b1_times[0], plain_ms=b1_times[1])

    # B8: the pipeline's displacement, (64, 1, 512, 512), alpha from a
    # kappa GRF, D = 8
    ells = np.arange(int(geom.lmax()) + 1)
    kgen = grf.MapGen(geom, np.asarray(th.gCl("kk", ells))[None, None],
                      device=dev)
    cgen = grf.MapGen(geom, np.asarray(th.uCl("TT", ells))[None, None],
                      device=dev)
    kappa = kgen.get_map(gen, batch=(64,))
    alpha = lensing.alpha_from_kappa(kappa, geom).contiguous()
    amax = (alpha.abs().max() / geom.dy).item()
    check(amax < 8.0, f"B8: max|alpha|/dy = {amax:.3f} not inside the cap")
    cmb = cgen.get_map(gen, batch=(64,))[:, None]
    b8_err = 0.0
    b8_times = None
    for order in (5, 3):
        coeffs = spline_coeffs(cmb, geom, order).contiguous()
        out = lens_map_kernel(coeffs, alpha, geom, order=order, maxdisp_px=8,
                              prefiltered=True)
        ref = lens_map_ref(coeffs, alpha, geom, order, 8)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        scale = ref.abs().max().item()
        check(err <= 2e-5 * scale, f"B8 order {order}: error {err:.3e} > "
                                   f"2e-5 * {scale:.3e}")
        b8_err = max(b8_err, err)
        ms = cuda_ms(lambda: lens_map_kernel(coeffs, alpha, geom, order=order,
                                             maxdisp_px=8, prefiltered=True),
                     20)
        plain = cuda_ms(lambda: lens_map_ref(coeffs, alpha, geom, order, 8),
                        3, warmup=1)
        print(f"[2] B8 lens_map_kernel order {order} (64, 1, 512, 512) D=8: "
              f"max|alpha|/dy {amax:.3f}, max abs err {err:.3e} "
              f"(max|ref| {scale:.3e}); kernel {ms:.4f} ms, plain "
              f"{plain:.4f} ms")
        if b8_times is None:
            b8_times = (ms, plain)
        del coeffs, out, ref
    results["lens_map_kernel"] = dict(
        name="lens_map_kernel", route="cuda",
        source="orphics_tpu_torch/csrc/lens_spline.cu",
        replaces="orphics_tpu/ops/pallas_lens.py:263",
        max_abs_err=b8_err, ms=b8_times[0], plain_ms=b8_times[1])
    del kappa, alpha, cmb
    torch.cuda.empty_cache()

    # B3 (colfft/colifft) and B4 (rowfft/rowifft/rowifft_scaled_y): the
    # path's (64, 512, 512) and (32, 512, 512) planes at 2e-5 of max|ref|;
    # n = 384 (B = 3, mixed radix) at 2e-5; n = 2048 at the 1.5e-5 contract
    def planes(shape):
        return tuple(torch.randn(shape, generator=gen, device=dev)
                     for _ in range(2))

    dft_cases = (("B3", "colfft", dft.colfft, dft.colfft_ref),
                 ("B3", "colifft", dft.colifft, dft.colifft_ref),
                 ("B4", "rowfft", dft.rowfft, dft.rowfft_ref),
                 ("B4", "rowifft", dft.rowifft, dft.rowifft_ref))
    dft_err = {"B3": 0.0, "B4": 0.0}
    dft_times = {}
    for shape, tol, timed in (((64, 512, 512), 2e-5, True),
                              ((32, 512, 512), 2e-5, False),
                              ((64, 384, 384), 2e-5, False),
                              ((4, 2048, 2048), 1.5e-5, False)):
        x = planes(shape)
        for kid, name, fn, ref_fn in dft_cases:
            err, rel = rel_err(fn(*x), ref_fn(*x))
            torch.cuda.synchronize()
            check(rel <= tol, f"{kid} {name} {shape}: error {rel:.3e} of "
                              f"max|ref| > {tol}")
            dft_err[kid] = max(dft_err[kid], err)
            line = (f"[2] {kid} {name} {shape}: max abs err {err:.3e} = "
                    f"{rel:.3e} of max|ref| (<= {tol})")
            if timed:
                ms = cuda_ms(lambda: fn(*x), 20)
                plain = cuda_ms(lambda: ref_fn(*x), 20)
                dft_times[name] = (ms, plain)
                line += f"; kernel {ms:.4f} ms, plain {plain:.4f} ms"
            print(line)
        del x
    x = planes((64, 512, 512))
    sc = torch.rand((512, 512), generator=gen, device=dev) + 0.5
    err, rel = rel_err(dft.rowifft_scaled_y(*x, sc),
                       dft.rowifft_scaled_y_ref(*x, sc))
    check(rel <= 2e-5, f"B4 rowifft_scaled_y: error {rel:.3e} of max|ref|")
    dft_err["B4"] = max(dft_err["B4"], err)
    ms = cuda_ms(lambda: dft.rowifft_scaled_y(*x, sc), 20)
    plain = cuda_ms(lambda: dft.rowifft_scaled_y_ref(*x, sc), 20)
    print(f"[2] B4 rowifft_scaled_y (64, 512, 512): max abs err {err:.3e} = "
          f"{rel:.3e} of max|ref| (<= 2e-5); kernel {ms:.4f} ms, plain "
          f"{plain:.4f} ms")
    # the 2D composition the pipeline runs, for the record
    ms = cuda_ms(lambda: dft.fft2pp(*x), 20)
    plain = cuda_ms(lambda: torch.fft.fft2(torch.complex(*x)), 20)
    print(f"[2] fft2pp (64, 512, 512) on B3+B4: {ms:.4f} ms; torch.fft.fft2 "
          f"(cuFFT, natural order, no split planes): {plain:.4f} ms")
    results["colfft"] = dict(
        name="colfft", route="cuda", source="orphics_tpu_torch/csrc/dft.cu",
        replaces="orphics_tpu/ops/pallas_fft.py:288",
        max_abs_err=dft_err["B3"], ms=dft_times["colfft"][0],
        plain_ms=dft_times["colfft"][1])
    results["rowfft"] = dict(
        name="rowfft", route="cuda", source="orphics_tpu_torch/csrc/dft.cu",
        replaces="orphics_tpu/ops/pallas_fft.py:791",
        max_abs_err=dft_err["B4"], ms=dft_times["rowfft"][0],
        plain_ms=dft_times["rowfft"][1])

    # B7: bit-exact against two index_select gathers
    for shape in ((32, 512, 512), (64, 512, 512), (4, 384, 384)):
        z = planes(shape)
        got = mirror_pp(*z)
        ref = mirror_pp_ref(*z)
        torch.cuda.synchronize()
        check(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]),
              f"B7 mirror_pp {shape}: not bit-exact")
    z = planes((32, 512, 512))
    ms = cuda_ms(lambda: mirror_pp(*z), 20)
    plain = cuda_ms(lambda: mirror_pp_ref(*z), 20)
    print(f"[2] B7 mirror_pp (32, 512, 512), (64, 512, 512), (4, 384, 384): "
          f"bit-exact; (32, 512, 512) kernel {ms:.4f} ms, plain "
          f"{plain:.4f} ms")
    results["mirror_pp"] = dict(
        name="mirror_pp", route="cuda",
        source="orphics_tpu_torch/csrc/mirror.cu",
        replaces="orphics_tpu/ops/pallas_fft.py:1078", max_abs_err=0.0,
        ms=ms, plain_ms=plain)
    del x, z, got, ref
    torch.cuda.empty_cache()

    # B5n: the law of z / scale over (32, 512, 512) re and im, where
    # scale > 0 (a quarter of the plane is 0, as a covsqrt is beyond its
    # l range); the same words reproduce, other words differ
    scale = torch.linspace(0.5, 2.0, 512 * 512, device=dev).reshape(512, 512)
    scale[:, :128] = 0.0
    words = torch.tensor([123456789, -98765], dtype=torch.int32, device=dev)
    zr, zi = noise_planes(scale, words, 32)
    zr2, zi2 = noise_planes(scale, words, 32)
    zr3, _ = noise_planes(scale, words + 1, 32)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(zr).all() and torch.isfinite(zi).all()),
          "B5n: non-finite draws")
    check(torch.equal(zr, zr2) and torch.equal(zi, zi2),
          "B5n: the same words do not reproduce")
    check(not torch.equal(zr, zr3), "B5n: different words give one stream")
    check(bool((zr[:, :, :128] == 0).all()), "B5n: scale 0 gives non-zero")
    pos = scale > 0
    er = (zr / scale)[:, pos].double()
    ei = (zi / scale)[:, pos].double()
    e = torch.cat([er.ravel(), ei.ravel()])
    N = e.numel()
    mean = e.mean().item()
    std = e.std().item()
    tail = (e.abs() > 4.0).double().mean().item()
    corr = ((er * ei).mean() / (er.std() * ei.std())).item()
    p4 = math.erfc(4.0 / math.sqrt(2.0))
    check(abs(mean) < 5.0 / math.sqrt(N), f"B5n: mean {mean:.3e}")
    check(abs(std - 1.0) < 2e-3, f"B5n: std {std:.6f}")
    check(abs(tail / p4 - 1.0) < 0.3, f"B5n: share beyond 4 sigma {tail:.3e}"
                                      f" vs {p4:.3e}")
    check(abs(corr) < 1e-3, f"B5n: corr(re, im) {corr:.3e}")
    ms = cuda_ms(lambda: noise_planes(scale, words, 32), 20)
    plain = cuda_ms(lambda: noise_planes_ref(scale, words, 32), 20)
    print(f"[2] B5n noise_planes (32, 512, 512) x 2: {N} values finite, "
          f"mean {mean:.3e} (5 sigma {5.0 / math.sqrt(N):.3e}), |std-1| "
          f"{abs(std - 1.0):.3e} (< 2e-3), share beyond 4 sigma {tail:.4e} vs "
          f"{p4:.4e}, corr(re, im) {corr:.3e}, reproducible; kernel "
          f"{ms:.4f} ms, plain (torch.randn x scale) {plain:.4f} ms")
    results["noise_planes"] = dict(
        name="noise_planes", route="cuda",
        source="orphics_tpu_torch/csrc/noise.cu",
        replaces="orphics_tpu/ops/pallas_fft.py:737",
        max_abs_err=abs(std - 1.0), ms=ms, plain_ms=plain)
    del zr, zi, zr2, zi2, zr3, er, ei, e
    torch.cuda.empty_cache()

    # FastCl's kernels at bench config 1's shapes: 2048^2 at 0.5', edges
    # arange(80, 8000, 80) (nseg 100), 96 packed pairs
    geom1 = rect_geometry(width_arcmin=2048 * 0.5, px_res_arcmin=0.5)
    ells_th = np.arange(th.lpad + 1)
    cltt = np.asarray(th.lCl("TT", ells_th))
    edges1 = np.arange(80, 8000, 80.0)
    fc1 = FastCl(geom1, ells_th, cltt, bin_edges=edges1, device=dev)
    P1, n1 = 96, 2048

    # B1 at the half plane's (96, 2097152) with FastCl's ids (nseg 100) and
    # with dl = 20 edges out to l = 8000 (nseg 400, two segment tiles)
    perm1, _ = dft.row_perm(n1)
    ml_half = geom1.modlmap_np()[perm1][:, perm1][dft.half_rows(n1)[0]]
    ids400 = torch.as_tensor(np.digitize(
        ml_half.ravel(), np.arange(20, 8000, 20.0), right=True)
        .astype(np.int32), device=dev)
    del ml_half
    data = torch.randn((P1, n1 * n1 // 2), generator=gen, device=dev) ** 2 \
        - 0.5
    data2 = torch.randn((P1, n1 * n1 // 2), generator=gen, device=dev) ** 2 \
        - 0.5
    for nseg, ids in ((fc1._nsg, fc1._idc), (400, ids400)):
        out = bin_reduce(data, ids, nseg)
        again = bin_reduce(data, ids, nseg)
        ref = bin_reduce_ref(data, ids, nseg)
        absref = bin_reduce_ref(data.abs(), ids, nseg)
        torch.cuda.synchronize()
        err = (out - ref).abs()
        rel = (err / absref.clamp_min(1e-30)).max().item()
        check(rel <= 1e-6, f"B1 nseg {nseg}: error {rel:.3e} of binned "
                           "|data| > 1e-6")
        check(torch.equal(out, again), f"B1 nseg {nseg}: two runs differ")
        b1_err = max(b1_err, err.max().item())
        ms = cuda_ms(lambda: bin_reduce(data, ids, nseg), 10)
        plain = cuda_ms(lambda: bin_reduce_ref(data, ids, nseg), 3, warmup=1)
        print(f"[2] B1 bin_reduce ({P1}, {n1 * n1 // 2}) nseg={nseg}: max rel "
              f"err {rel:.3e} of binned |data|, reproducible; kernel "
              f"{ms:.4f} ms, plain {plain:.4f} ms")
    results["bin_reduce"]["max_abs_err"] = b1_err

    # B2: the two half-plane fields of 96 pairs over FastCl's ids
    out = bin2_reduce(data, data2, fc1._idc, fc1._nsg)
    again = bin2_reduce(data, data2, fc1._idc, fc1._nsg)
    ref = bin2_reduce_ref(data, data2, fc1._idc, fc1._nsg)
    b2_err = 0.0
    for k, (o, a, r, x) in enumerate(zip(out, again, ref, (data, data2))):
        absref = bin_reduce_ref(x.abs(), fc1._idc, fc1._nsg)
        err = (o - r).abs()
        rel = (err / absref.clamp_min(1e-30)).max().item()
        check(rel <= 1e-6, f"B2 output {k}: error {rel:.3e} of binned "
                           "|data| > 1e-6")
        check(torch.equal(o, a), f"B2 output {k}: two runs differ")
        b2_err = max(b2_err, err.max().item())
    ms = cuda_ms(lambda: bin2_reduce(data, data2, fc1._idc, fc1._nsg), 10)
    plain = cuda_ms(lambda: bin2_reduce_ref(data, data2, fc1._idc,
                                            fc1._nsg), 3, warmup=1)
    print(f"[2] B2 bin2_reduce ({P1}, {n1 * n1 // 2}) x 2 nseg={fc1._nsg}: "
          f"each output within 1e-6 of binned |data| (max abs err "
          f"{b2_err:.3e}), reproducible; kernel {ms:.4f} ms, plain "
          f"{plain:.4f} ms")
    results["bin2_reduce"] = dict(
        name="bin2_reduce", route="cuda",
        source="orphics_tpu_torch/csrc/bin_reduce.cu",
        replaces="orphics_tpu/ops/pallas_kernels.py:163",
        max_abs_err=b2_err, ms=ms, plain_ms=plain)
    del data, data2, out, again, ref, absref, err, ids, ids400, o, a, r, x
    torch.cuda.empty_cache()

    # B4b and B6 on a (96, 2048, 2048) column intermediate, and at n = 384
    y = planes((P1, n1, n1))
    blk_err = 0.0
    for yy, tag in ((y, f"({P1}, {n1}, {n1})"), (planes((4, 384, 384)),
                                                 "(4, 384, 384)")):
        err, rel = rel_err(dft.rowfft_blk0(*yy), dft.rowfft_blk0_ref(*yy))
        torch.cuda.synchronize()
        check(rel <= 1.5e-5, f"B4b rowfft_blk0 {tag}: error {rel:.3e} of "
                             "max|ref| > 1.5e-5")
        blk_err = max(blk_err, err)
        print(f"[2] B4b rowfft_blk0 {tag}: max abs err {err:.3e} = "
              f"{rel:.3e} of max|ref| (<= 1.5e-5)")
    ms = cuda_ms(lambda: dft.rowfft_blk0(*y), 10)
    plain = cuda_ms(lambda: dft.rowfft_blk0_ref(*y), 3, warmup=1)
    print(f"[2] B4b rowfft_blk0 ({P1}, {n1}, {n1}): kernel {ms:.4f} ms, plain "
          f"{plain:.4f} ms")
    results["rowfft_blk0"] = dict(
        name="rowfft_blk0", route="cuda",
        source="orphics_tpu_torch/csrc/rowpower.cu",
        replaces="orphics_tpu/ops/pallas_fft.py:1301",
        max_abs_err=blk_err, ms=ms, plain_ms=plain)
    qc_err = 0.0
    for yy, tag in ((y, f"({P1}, {n1}, {n1})"), (planes((4, 384, 384)),
                                                 "(4, 384, 384)")):
        got = rowqc_pp(*yy)
        ref = rowqc_pp_ref(*yy)
        torch.cuda.synchronize()
        line = f"[2] B6 rowqc_pp {tag}:"
        for name, g, r, tol in zip(("qs", "c", "zrow_r", "zrow_i"), got, ref,
                                   (3e-5, 3e-5, 1.5e-5, 1.5e-5)):
            check(g.shape == r.shape, f"B6 {name} {tag}: shape "
                                      f"{tuple(g.shape)}")
            err, rel = rel_err((g,), (r,))
            check(rel <= tol, f"B6 {name} {tag}: error {rel:.3e} of "
                              f"max|ref| > {tol}")
            if name in ("qs", "c"):
                qc_err = max(qc_err, err)
            line += f" {name} {rel:.3e} (<= {tol})"
        print(line + " of max|ref|")
        del got, ref, g, r
    del yy
    torch.cuda.empty_cache()
    ms = cuda_ms(lambda: rowqc_half(*y), 10)
    ms_pp = cuda_ms(lambda: rowqc_pp(*y), 10)
    plain = cuda_ms(lambda: rowqc_pp_ref(*y), 3, warmup=1)
    print(f"[2] B6 ({P1}, {n1}, {n1}): kernel rowqc_half {ms:.4f} ms; "
          f"rowqc_pp (B6 + B4 zrow + B4b + strip patches) {ms_pp:.4f} ms; "
          f"plain rowqc_pp_ref {plain:.4f} ms")
    results["rowqc_half"] = dict(
        name="rowqc_half", route="cuda",
        source="orphics_tpu_torch/csrc/rowpower.cu",
        replaces="orphics_tpu/ops/pallas_fft.py:1344",
        max_abs_err=qc_err, ms=ms, plain_ms=plain)
    del y
    torch.cuda.empty_cache()

    # B5: the config-1 covsqrt scale, 96 pairs; B5n's stream through B4's
    # inverse on the same words, the law under a unit scale, the seeds
    sc1 = fc1._covsqrt_pp
    w = torch.tensor([20260512, -77], dtype=torch.int32, device=dev)
    got = dft.rowifft_noise_y(sc1, w, P1)
    ref = dft.rowifft(*noise_planes(sc1, w, P1))
    torch.cuda.synchronize()
    b5_err, rel = rel_err(got, ref)
    exact = torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    check(rel <= 1.5e-5, f"B5 vs rowifft(noise_planes): error {rel:.3e} of "
                         "max|ref| > 1.5e-5")
    del ref
    again = dft.rowifft_noise_y(sc1, w, P1)
    check(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]),
          "B5: the same words do not reproduce")
    del again
    other = dft.rowifft_noise_y(sc1, w + 1, P1)
    check(not torch.equal(got[0], other[0]), "B5: other words, same stream")
    del got, other
    ur, ui = dft.rowifft_noise_y(torch.ones_like(sc1), w, P1)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(ur).all() and torch.isfinite(ui).all()),
          "B5: non-finite Y'")
    var_r = ur.double().var().item() * n1
    var_i = ui.double().var().item() * n1
    corr = (ur.double() * ui.double()).mean().item() * n1
    check(abs(var_r - 1.0) < 2e-3 and abs(var_i - 1.0) < 2e-3,
          f"B5: n var(Y') = {var_r:.6f}, {var_i:.6f}")
    check(abs(corr) < 1e-3, f"B5: n E[re im] = {corr:.3e}")
    del ur, ui
    ms = cuda_ms(lambda: dft.rowifft_noise_y(sc1, w, P1), 10)
    plain = cuda_ms(lambda: dft.rowifft_noise_y_ref(sc1, w, P1), 3, warmup=1)
    print(f"[2] B5 rowifft_noise_y ({P1}, {n1}, {n1}) x 2: vs "
          f"rowifft(noise_planes) on the same words {rel:.3e} of max|ref| "
          f"(<= 1.5e-5; bit-equal: {exact}); unit scale: n var(Y') "
          f"{var_r:.6f} (re), {var_i:.6f} (im) (within 2e-3 of 1), "
          f"n E[re im] {corr:.3e}; reproducible; kernel {ms:.4f} ms, plain "
          f"(torch.randn, then torch.fft.ifft) {plain:.4f} ms")
    results["rowifft_noise_y"] = dict(
        name="rowifft_noise_y", route="cuda",
        source="orphics_tpu_torch/csrc/dft.cu",
        replaces="orphics_tpu/ops/pallas_fft.py:658",
        max_abs_err=b5_err, ms=ms, plain_ms=plain)
    del fc1, sc1
    torch.cuda.empty_cache()

    counters = {"bin_reduce": (bin_reduce,),
                "lens_map_kernel": (lens_map_kernel,),
                "colfft": (dft.colfft, dft.colifft),
                "rowfft": (dft.rowfft, dft.rowifft, dft.rowifft_scaled_y),
                "noise_planes": (noise_planes,),
                "mirror_pp": (mirror_pp,),
                "bin2_reduce": (bin2_reduce,),
                "rowfft_blk0": (dft.rowfft_blk0,),
                "rowifft_noise_y": (dft.rowifft_noise_y,),
                "rowqc_half": (rowqc_half,)}

    def reset_counts():
        for fns in counters.values():
            for fn in fns:
                fn.launches = 0

    def read_counts(names, tag):
        counts = {k: sum(fn.launches for fn in counters[k]) for k in counters}
        print(f"[{tag}] launches on this path: {counts}")
        for name in names:
            check(counts[name] > 0, f"{tag}: {name} was not launched")
        return counts

    # ---- 3. flagship step (counts from 0)
    reset_counts()
    fn, fargs = entry(device=dev)
    t0 = time.perf_counter()
    for i in range(3):
        out = fn(*fargs)
        torch.cuda.synchronize()
        check(tuple(out.shape) == (3, 15), f"flagship shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), "flagship output not finite")
    print(f"[3] flagship entry() 512^2 2': 3 steps finite (3, 15) in "
          f"{time.perf_counter() - t0:.3f} s; cross[:4] "
          f"{out[0, :4].tolist()}")
    read_counts(("bin_reduce",), "3")
    batch = 64

    # ---- 4. half-plane pipeline (impl="xla") at bench config 6's settings
    reset_counts()
    pipe = LensedQEPipeline(geom, th, beam_arcmin=1.4, noise_uk_arcmin=6.0,
                            lens_order=5, device=dev, impl="xla")
    check(pipe.impl == "xla", "impl='xla' did not select the half-plane path")
    step_ms = pipeline_rate(pipe, batch, gen, 5, card, "4")
    ratio_gate(pipe, batch, gen, "4")
    read_counts(("bin_reduce", "lens_map_kernel"), "4")
    # the kernel path agrees with the plain path on a small input
    small = rect_geometry(width_arcmin=128 * 2.0, px_res_arcmin=2.0)
    p_gpu = LensedQEPipeline(small, th, lens_order=5, device=dev)
    p_cpu = LensedQEPipeline(small, th, lens_order=5, device="cpu")
    g_cpu = torch.Generator().manual_seed(7)
    etas = p_cpu.draw_noise(4, g_cpu)
    ref = p_cpu.core(*etas).numpy()
    got = p_gpu.core(*(e.to(dev) for e in etas)).cpu().numpy()
    small_err = spectra_err(got, ref)
    check(small_err <= 2e-4, f"card vs CPU pipeline at 128^2: {small_err:.3e}"
                             " of each spectrum's max > 2e-4")
    print(f"[4] 128^2 card (kernels) vs CPU (plain versions), same draws: "
          f"{small_err:.3e} of each spectrum's max (<= 2e-4)")
    profile_steps(lambda: pipe.step(batch, gen), 3, step_ms, "4")
    del pipe, p_gpu, p_cpu
    torch.cuda.empty_cache()

    # ---- 5. full-plane pipeline: what impl="auto" runs at 512^2
    reset_counts()
    pipe = LensedQEPipeline(geom, th, beam_arcmin=1.4, noise_uk_arcmin=6.0,
                            lens_order=5, device=dev)
    check(pipe.impl == "pallas", "impl='auto' did not select the full-plane "
                                 "path at 512^2")
    step_ms = pipeline_rate(pipe, batch, gen, 10, card, "5")
    ratio_gate(pipe, batch, gen, "5")
    lens_path = ("bin_reduce", "lens_map_kernel", "colfft", "rowfft",
                 "noise_planes", "mirror_pp")
    counts = read_counts(lens_path, "5")
    for name in lens_path:
        results[name]["launches"] = counts[name]
    # card (kernels) vs CPU (plain versions) on the same injected planes
    mid = rect_geometry(width_arcmin=256 * 2.0, px_res_arcmin=2.0)
    p_gpu = LensedQEPipeline(mid, th, lens_order=5, device=dev)
    p_cpu = LensedQEPipeline(mid, th, lens_order=5, device="cpu")
    check(p_gpu.impl == p_cpu.impl == "pallas", "256^2 is not full-plane")
    planes_cpu = p_cpu.draw_noise_pp(4, torch.Generator().manual_seed(11))
    ref = p_cpu._pp_core(*planes_cpu, 4).numpy()
    got = p_gpu._pp_core(*(tuple(a.to(dev) for a in z) for z in planes_cpu),
                         4).cpu().numpy()
    mid_err = spectra_err(got, ref)
    check(bool(np.isfinite(got).all()), "full-plane card output not finite")
    check(mid_err <= 2e-4, f"card vs CPU _pp_core at 256^2: {mid_err:.3e} "
                           "of each spectrum's max > 2e-4")
    print(f"[5] 256^2 _pp_core card (kernels) vs CPU (plain versions), same "
          f"planes: {mid_err:.3e} of each spectrum's max (<= 2e-4)")
    profile_steps(lambda: pipe.step(batch, gen), 3, step_ms, "5")
    del pipe, p_gpu, p_cpu, planes_cpu
    torch.cuda.empty_cache()

    # ---- 6. FastCl at bench config 1's settings: 2048^2 0.5', lensed TT,
    # edges arange(80, 8000, 80), batch 192 (96 packed pairs)
    reset_counts()
    fc = FastCl(geom1, ells_th, cltt, bin_edges=edges1, device=dev)
    nb = len(edges1) - 1
    batch6 = 192
    out = fc.sim_bandpowers(0, batch6)
    torch.cuda.synchronize()
    check(tuple(out.shape) == (batch6, nb), f"sim_bandpowers shape "
                                       f"{tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "sim_bandpowers not finite")
    gen6 = torch.Generator(device=dev).manual_seed(6)
    cell = f"2048^2 0.5' nseg {fc._nsg} batch {batch6}"
    sim_ms = throughput(lambda: fc.sim_bandpowers(gen6, batch6), batch6, 10,
                        f"FastCl.sim_bandpowers(generator, 192) {cell}",
                        "sims/s", card, "6")

    def config1_step(seed):
        """bench.py config 1's step body: synthesis with the maps
        materialized, then the fused analysis of the pre-column Y'."""
        m1, m2, yr, yi = dft.ifft2pp_noise_y(fc._covsqrt_pp, seed,
                                             batch6 // 2)
        b1, b2 = fc._pair_bandpowers_y(yr, yi)
        return torch.cat([b1, b2]), m1, m2

    step1_ms = throughput(
        lambda: config1_step(1), batch6, 10, "config-1 step body (port's "
        f"grf_fft_bin_pipelines_per_sec_2048x2048_fp32) {cell}",
        "pipelines/s", card, "6")
    # map_bandpowers on the step's own maps gives the step's bandpowers:
    # colfft(colifft(Y')) = Y' up to rounding
    bp, m1, m2 = config1_step(123)
    maps = torch.stack([m1, m2], dim=1).reshape(batch6, n1, n1)
    del m1, m2
    mbp = fc.map_bandpowers(maps)
    torch.cuda.synchronize()
    del maps
    ordered = torch.stack([bp[:batch6 // 2], bp[batch6 // 2:]], dim=1) \
        .reshape(batch6, nb)
    check(tuple(mbp.shape) == (batch6, nb)
          and bool(torch.isfinite(mbp).all()), "map_bandpowers: bad output")
    mrel = ((mbp - ordered).abs() / ordered.abs()).max().item()
    check(mrel <= 1e-3, f"map_bandpowers vs the sims' own bandpowers: "
                        f"{mrel:.3e} relative")
    print(f"[6] map_bandpowers of the step's {batch6} maps ({batch6}, {nb}) "
          f"vs the step's bandpowers: max {mrel:.3e} relative per bin "
          "(<= 1e-3)")
    counts6 = read_counts(("bin_reduce", "bin2_reduce", "colfft", "rowfft",
                           "rowfft_blk0", "rowifft_noise_y", "rowqc_half"),
                          "6")
    for name in ("bin2_reduce", "rowfft_blk0", "rowifft_noise_y",
                 "rowqc_half"):
        results[name]["launches"] = counts6[name]
    profile_steps(lambda: fc.sim_bandpowers(gen6, batch6), 3, sim_ms, "6")
    profile_steps(lambda: config1_step(7), 3, step1_ms, "6 config-1")
    del fc, bp, mbp, ordered, out
    torch.cuda.empty_cache()

    # spectral recovery: 512 sims at 512^2 recover the input spectrum
    # (tests/test_tpu_chip.py's gate)
    g512 = rect_geometry(width_arcmin=512 * 2.0, px_res_arcmin=2.0)
    e512 = np.arange(200, 4000, 200.0)
    fc512 = FastCl(g512, ells_th, cltt, bin_edges=e512, device=dev)
    sims = torch.cat([fc512.sim_bandpowers(s, 128) for s in (11, 22, 33, 44)])
    mean = sims.double().mean(0).cpu().numpy()
    # the expectation is the annulus mean of the 2D theory
    ml = g512.modlmap_np().ravel()
    dig = np.digitize(ml, e512, right=True)
    cl_sum = np.bincount(dig, np.interp(ml, ells_th, cltt), len(e512) + 1)
    count = np.bincount(dig, minlength=len(e512) + 1)
    ratio = mean / (cl_sum / np.maximum(count, 1))[1:-1]
    check(bool(np.all(np.isfinite(ratio))), "recovery: non-finite ratio")
    check(bool(np.all(np.abs(ratio - 1.0) < 0.03)), f"recovery: per-bin "
          f"|ratio - 1| up to {np.abs(ratio - 1.0).max():.4f} >= 0.03")
    check(abs(ratio.mean() - 1.0) < 0.005, f"recovery: mean ratio "
                                           f"{ratio.mean():.5f}")
    print(f"[6] 512 sims at 512^2 2' ({len(ratio)} bins): max per-bin "
          f"|ratio - 1| {np.abs(ratio - 1.0).max():.4f} (< 0.03), mean ratio "
          f"{ratio.mean():.5f} (within 0.005 of 1)")
    del fc512, sims

    # card (kernels) vs CPU (plain versions) at 256^2 on the same noise
    # and the same maps
    g256 = rect_geometry(width_arcmin=256 * 2.0, px_res_arcmin=2.0)
    e256 = np.arange(80, 4000, 160.0)
    f_gpu = FastCl(g256, ells_th, cltt, bin_edges=e256, device=dev)
    f_cpu = FastCl(g256, ells_th, cltt, bin_edges=e256)
    rng = np.random.default_rng(256)
    er, ei = (torch.as_tensor(rng.standard_normal((2, 256, 256))
                              .astype(np.float32)) for _ in range(2))
    mp = torch.as_tensor(rng.standard_normal((3, 256, 256))
                         .astype(np.float32))
    worst = 0.0
    for tag, got, ref in (
            ("sim_bandpowers_from_noise",
             f_gpu.sim_bandpowers_from_noise(er.to(dev), ei.to(dev)),
             f_cpu.sim_bandpowers_from_noise(er, ei)),
            ("map_bandpowers", f_gpu.map_bandpowers(mp.to(dev)),
             f_cpu.map_bandpowers(mp))):
        got = got.cpu().numpy()
        ref = ref.numpy()
        rel = float(np.max(np.abs(got - ref) / np.abs(ref)))
        check(bool(np.isfinite(got).all()) and rel <= 5e-5,
              f"card vs CPU {tag} at 256^2: {rel:.3e} relative per bin")
        worst = max(worst, rel)
    print(f"[6] 256^2 card (kernels) vs CPU (plain versions), same noise and "
          f"same maps: max {worst:.3e} relative per bin (<= 5e-5)")

    print(json.dumps({"kernels": [results[k] for k in counters]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
