"""Card check of the PyTorch / CUDA port: build its kernels, hold each to
its plain PyTorch version at the main path's shapes, drive the flagship
step and the lensing pipeline on the card, and check what comes out.

Run from the repository root on a machine with one NVIDIA Hopper GPU
and nvcc:

    python3 chip_smoke.py

Phases: 0 card, 1 build, 2 kernels vs plain versions, 3 flagship step,
4 pipeline (throughput, device time by kernel, lensing-reconstruction
check, launch counts).
The line before the last is a JSON object with each kernel's launches,
error and times; the last line is
``{"ok": true, "device": {"platform": "gpu", ...}}``. Any failed check
raises, so the exit code is non-zero and no result line is printed. It
imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch


def check(cond, msg):
    if not cond:
        raise RuntimeError("check failed: " + msg)


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
    from orphics_tpu_torch.ops.bin_reduce import bin_reduce, bin_reduce_ref
    from orphics_tpu_torch.ops.binning import Bin2D, RfftBin2D
    from orphics_tpu_torch.ops.lens import (lens_map_kernel, lens_map_ref,
                                            spline_coeffs)

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
          f"{' '.join(_build.NVCC_FLAGS)})")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
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

    # ---- 3. flagship step (main path from here on: counts start at 0)
    bin_reduce.launches = 0
    lens_map_kernel.launches = 0
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

    # ---- 4. pipeline at bench config 6's settings
    pipe = LensedQEPipeline(geom, th, beam_arcmin=1.4, noise_uk_arcmin=6.0,
                            lens_order=5, device=dev)
    batch = 64
    for _ in range(2):
        pipe.step(batch, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nsteps = 10
    t0 = time.perf_counter()
    for _ in range(nsteps):
        out = pipe.step(batch, gen)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rate = nsteps * batch / dt
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[4] pipeline 512^2 2' beam 1.4' 6 uK' order 5 batch {batch}: "
          f"{rate:.2f} sims/s ({dt / nsteps * 1e3:.3f} ms/step, peak "
          f"{peak:.3f} GiB) on {card}")
    outs = torch.cat([pipe.step(batch, gen) for _ in range(2)])
    check(bool(torch.isfinite(outs).all()), "pipeline output not finite")
    cross = outs[:, 0].double().mean(0)
    auto_in = outs[:, 1].double().mean(0)
    ratio = (cross / auto_in).cpu().numpy()
    dev_ratio = float(np.mean(np.abs(ratio - 1.0)))
    check(dev_ratio < 0.06, f"cross/auto_in mean|ratio-1| = {dev_ratio:.4f}")
    print(f"[4] {outs.shape[0]} sims: cross/auto_in mean|ratio-1| = "
          f"{dev_ratio:.4f} over {ratio.size} bins (< 0.06)")
    counts = {"bin_reduce": bin_reduce.launches,
              "lens_map_kernel": lens_map_kernel.launches}
    print(f"[4] launches on the main path: {counts}")
    for name, c in counts.items():
        check(c > 0, f"{name} was not launched on the main path")
        results[name]["launches"] = c

    # the kernel path agrees with the plain path on a small input
    small = rect_geometry(width_arcmin=128 * 2.0, px_res_arcmin=2.0)
    p_gpu = LensedQEPipeline(small, th, lens_order=5, device=dev)
    p_cpu = LensedQEPipeline(small, th, lens_order=5, device="cpu")
    g_cpu = torch.Generator().manual_seed(7)
    etas = p_cpu.draw_noise(4, g_cpu)
    ref = p_cpu.core(*etas).numpy()
    got = p_gpu.core(*(e.to(dev) for e in etas)).cpu().numpy()
    scale = np.abs(ref).max(axis=(0, 2), keepdims=True)
    small_err = float(np.max(np.abs(got - ref) / scale))
    check(small_err <= 2e-4, f"card vs CPU pipeline at 128^2: {small_err:.3e}"
                             " of each spectrum's max > 2e-4")
    print(f"[4] 128^2 card (kernels) vs CPU (plain versions), same draws: "
          f"{small_err:.3e} of each spectrum's max (<= 2e-4)")

    # device time by kernel over 3 steps (profiler), against the unprofiled
    # step time above: the device's busy share
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            pipe.step(batch, gen)
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    kern.sort(key=lambda e: -e.self_device_time_total)
    dev_ms = sum(e.self_device_time_total for e in kern) / 3e3
    print(f"[4] device time {dev_ms:.4f} ms per step = {dev_ms / (dt / nsteps * 1e3):.3f}"
          f" of the unprofiled step time; top kernels (ms per step):")
    for e in kern[:12]:
        print(f"[4]   {e.self_device_time_total / 3e3:9.4f}  "
              f"{e.count // 3:4d}x  {e.key[:90]}")

    print(json.dumps({"kernels": [results["bin_reduce"],
                                  results["lens_map_kernel"]]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
