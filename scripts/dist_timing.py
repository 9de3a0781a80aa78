"""Timing of the distributed layer (``parallel/``) across cards, beside
one card:

* ``part: "fft"``: the grid-distributed Fourier transforms
  ``parallel.fourier.fft2_dist`` and ``masked_bandpowers_dist`` (one
  all-to-all each) on a (1, S) mesh, every rank on ``grid``, at
  ``examples/torch/distributed_fft.py``'s 2048^2 0.5' map and at 4096^2;
* ``part: "sht"``: the ring-split ``parallel.sht.map2alm_dist`` (one
  all-reduce of the (l, m) matrix) and ``alm2map_dist`` (one all-gather
  of the rings) at lmax 2047 on ``gauss_legendre_rings(2047)``, one map,
  on the same (1, S) mesh, beside the serial folded ``ops.sht`` transforms
  on one card;
* ``part: "ensemble"``: ``parallel.runtime.ensemble_stats`` of the
  flagship step (``entry.build_qe_pipeline`` at 512^2 2') over 256 sims,
  chunk 16, on an (S, 1) mesh, every rank on ``sims``, and its one
  all-reduce (``psum_states`` of the reduced statistics) alone.

Run it under ``torchrun`` on a machine with S NVIDIA GPUs (S = 1 gives the
one-card times to hold the others against):

    torchrun --standalone --nproc-per-node S scripts/dist_timing.py

Each rank joins the world through ``parallel.init_multihost`` (NCCL),
draws the same inputs from seeded generators and checks each distributed
call against the serial one (``torch.fft.fft2``, the plain bandpowers
binned on the rank's card, the serial transforms within the dd contract
3.2e-6 of max, the ensemble's count), then times each call by CUDA events
after ``WARMUP`` calls: ``WINDOWS`` windows of ``REPS`` calls (one call a
window for the ensemble), the ranks starting each window together (a
barrier), a window's time the slowest rank's. Rank 0 prints one JSON line
per part and size with the card's name and power limit: each time is the
median window's milliseconds per call, with the fastest and slowest
windows beside it (``*_range``).
"""
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np
import torch
import torch.distributed as dist

from orphics_tpu_torch import rect_geometry
from orphics_tpu_torch.entry import build_qe_pipeline
from orphics_tpu_torch.models import grf, theory
from orphics_tpu_torch.ops import alm as almops
from orphics_tpu_torch.ops import sht
from orphics_tpu_torch.ops.windows import get_taper
from orphics_tpu_torch.parallel import get_mesh, init_multihost
from orphics_tpu_torch.parallel.fourier import (fft2_dist,
                                                masked_bandpowers_dist)
from orphics_tpu_torch.parallel.runtime import ensemble_stats
from orphics_tpu_torch.parallel.sht import alm2map_dist, map2alm_dist
from orphics_tpu_torch.parallel.statistics import psum_states

WARMUP = 5
WINDOWS = 7
REPS = 20


def card_line():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]


def timed(fn, reps=REPS, warmup=WARMUP):
    """``(median, [fastest, slowest])`` over the windows of the slowest
    rank's mean milliseconds per call of ``fn``."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    wins = []
    for _ in range(WINDOWS):
        torch.cuda.synchronize()
        dist.barrier()
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        ms = torch.tensor([start.elapsed_time(stop) / reps], device="cuda")
        dist.all_reduce(ms, op=dist.ReduceOp.MAX)
        wins.append(float(ms))
    return float(np.median(wins)), [min(wins), max(wins)]


def main():
    if not torch.cuda.is_available():
        sys.exit("dist_timing: no CUDA device")
    if "WORLD_SIZE" not in os.environ:
        sys.exit("dist_timing: run it under torchrun")
    init_multihost(timeout=300)
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = get_mesh(shape=(1, world))
    th = theory.default_theory()
    ells = np.arange(20000)
    cl = np.asarray(th.lCl("TT", ells))
    card = card_line()
    for n in (2048, 4096):
        geom = rect_geometry(width_arcmin=n * 0.5, px_res_arcmin=0.5)
        m = grf.MapGen(geom, cl, device=dev).get_map(
            torch.Generator(device=dev).manual_seed(0))
        taper, w2 = get_taper(geom, taper_percent=12.0, device=dev)
        taper = taper.to(torch.float32)
        edges = np.arange(200, 6000, 200.0)
        dig = np.digitize(geom.modlmap_np(), edges).astype(np.int32)
        dig[dig == len(edges)] = 0
        nbins = len(edges) - 1
        norm = float(geom.area) / float(geom.npix) ** 2
        dig_t = torch.as_tensor(dig, device=dev)
        mc = m.to(torch.complex64)
        ks = torch.fft.fft2(m)
        kd = fft2_dist(mc, mesh)
        fft_err = float((kd - ks).abs().max() / ks.abs().max())
        bp = masked_bandpowers_dist(m, taper, dig_t, nbins, norm, mesh)
        p = (torch.fft.fft2(m * taper).abs() ** 2 * norm).double().reshape(-1)
        ids = torch.as_tensor(dig.reshape(-1), device=dev).long()
        sums = torch.zeros(nbins + 1, dtype=torch.float64, device=dev)
        sums.index_add_(0, ids, p)
        cnt = torch.bincount(ids, minlength=nbins + 1).double()
        bp_s = (sums / cnt.clamp_min(1))[1:]
        bp_err = float(((bp.double() - bp_s).abs() / bp_s.abs()).max())
        if fft_err > 1e-4 or bp_err > 1e-4:
            raise RuntimeError(f"{n}^2: fft2_dist {fft_err:.3e}, "
                               f"masked_bandpowers_dist {bp_err:.3e}")
        ms_fft, rg_fft = timed(lambda: fft2_dist(mc, mesh))
        ms_bp, rg_bp = timed(lambda: masked_bandpowers_dist(
            m, taper, dig_t, nbins, norm, mesh))
        ms_ser, rg_ser = timed(lambda: torch.fft.fft2(mc))
        if rank == 0:
            print(json.dumps({
                "part": "fft", "n": n, "ranks": world, "card": card,
                "windows": WINDOWS, "calls_per_window": REPS,
                "fft2_dist_ms": ms_fft, "fft2_dist_ms_range": rg_fft,
                "masked_bandpowers_dist_ms": ms_bp,
                "masked_bandpowers_dist_ms_range": rg_bp,
                "serial_fft2_ms": ms_ser, "serial_fft2_ms_range": rg_ser,
                "fft2_dist_rel_err": fft_err,
                "bandpowers_rel_err": bp_err,
                "w2": float(w2)}), flush=True)
        del m, mc, ks, kd, taper, dig_t
        torch.cuda.empty_cache()
    time_sht(mesh, dev, card, rank, world)
    time_ensemble(dev, th, card, rank, world)
    dist.destroy_process_group()


def time_sht(mesh, dev, card, rank, world):
    """The ring-split transforms at lmax 2047, one map, beside the serial
    folded ones."""
    lmax = 2047
    rings = sht.gauss_legendre_rings(lmax)
    gen = torch.Generator(device=dev).manual_seed(2047)
    n = almops.nalm(lmax)
    a = torch.complex(torch.randn(n, generator=gen, device=dev),
                      torch.randn(n, generator=gen, device=dev))
    a[: lmax + 1] = a[: lmax + 1].real.to(a.dtype)
    m = sht.alm2map(a, rings, lmax)
    a_ser = sht.map2alm(m, rings, lmax)
    a_d = map2alm_dist(m, rings, lmax, mesh, axis="grid")
    m_d = alm2map_dist(a, rings, lmax, mesh, axis="grid")
    err_a = float((a_d - a_ser).abs().max() / a_ser.abs().max())
    err_m = float((m_d - m).abs().max() / m.abs().max())
    if err_a > 3.2e-6 or err_m > 3.2e-6:
        raise RuntimeError(f"ring-split SHT: map2alm_dist {err_a:.3e}, "
                           f"alm2map_dist {err_m:.3e}")
    ms_a, rg_a = timed(lambda: map2alm_dist(m, rings, lmax, mesh,
                                            axis="grid"))
    ms_s, rg_s = timed(lambda: alm2map_dist(a, rings, lmax, mesh,
                                            axis="grid"))
    ms_as, rg_as = timed(lambda: sht.map2alm(m, rings, lmax))
    ms_ss, rg_ss = timed(lambda: sht.alm2map(a, rings, lmax))
    if rank == 0:
        print(json.dumps({
            "part": "sht", "lmax": lmax, "rings": rings.ntheta,
            "ranks": world, "card": card, "windows": WINDOWS,
            "calls_per_window": REPS,
            "map2alm_dist_ms": ms_a, "map2alm_dist_ms_range": rg_a,
            "alm2map_dist_ms": ms_s, "alm2map_dist_ms_range": rg_s,
            "serial_map2alm_ms": ms_as, "serial_map2alm_ms_range": rg_as,
            "serial_alm2map_ms": ms_ss, "serial_alm2map_ms_range": rg_ss,
            "map2alm_dist_rel_err": err_a,
            "alm2map_dist_rel_err": err_m}), flush=True)
    del a, m, a_ser, a_d, m_d
    torch.cuda.empty_cache()


def time_ensemble(dev, th, card, rank, world, nsims=256, chunk=16):
    """``ensemble_stats`` of the flagship step over ``nsims`` sims, the
    sims split over every rank, and its all-reduce alone."""
    mesh = get_mesh(shape=(world, 1))
    step = build_qe_pipeline(
        rect_geometry(width_arcmin=512 * 2.0, px_res_arcmin=2.0), th,
        device=dev)
    labels = ("cross", "auto_in", "auto_rec")

    def sim(g):
        return dict(zip(labels, step.step(g)))

    def run():
        return ensemble_stats(sim, nsims, seed=18, mesh=mesh, chunk=chunk)

    # a 2-sim ensemble first: its all-reduce sets up the communicator
    ensemble_stats(sim, 2, seed=18, mesh=mesh)
    st = run()
    counts = {k: float(st[k].n) for k in labels}
    if any(abs(c - nsims) > 1e-9 for c in counts.values()):
        raise RuntimeError(f"ensemble_stats counted {counts}, not {nsims}")
    ax = mesh.axis("sims")
    floats = sum(v.numel() for s_ in st.values() for v in (s_.n, s_.s, s_.ss)
                 if v is not None)
    ms_e, rg_e = timed(run, reps=1, warmup=1)
    ms_r, rg_r = timed(lambda: psum_states(st, ax))
    if rank == 0:
        print(json.dumps({
            "part": "ensemble", "nsims": nsims, "chunk": chunk,
            "ranks": world, "card": card, "windows": WINDOWS,
            "ensemble_stats_ms": ms_e, "ensemble_stats_ms_range": rg_e,
            "sims_per_s": nsims / ms_e * 1e3,
            "all_reduce_ms": ms_r, "all_reduce_ms_range": rg_r,
            "all_reduce_calls_per_window": REPS,
            "values_reduced": floats}), flush=True)


if __name__ == "__main__":
    main()
