"""The flagship step of the port (counterpart of ``__graft_entry__.py``'s
``_build_qe_pipeline`` / ``entry``): lensed CMB simulation -> beam ->
noise -> TT quadratic-estimator kappa reconstruction -> binned
cross / auto spectra, through the port's production modules; and
:func:`dryrun_multichip`, the multi-rank dry run of the distributed layer
(:mod:`.parallel`): the flagship step's ensemble, the grid-split filter and
FFT, the ring-split SHT and the distributed masked bandpowers, each held
to its serial counterpart, on ``n`` processes (NCCL on the cards, gloo on
the CPU).
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from . import _build
from ._device import resolve
from .geometry import Geometry, rect_geometry
from .models import lensing, qe
from .models.theory import default_theory
from .ops import fourier as F
from .ops import legendre as leg
from .ops import sht
from .ops.binning import Bin2D
from .ops.windows import get_taper
from .parallel import fourier as pfourier
from .parallel import sht as psht
from .parallel.runtime import ensemble_stats, get_mesh, init_multihost

__all__ = ["QEPipelineStep", "build_qe_pipeline", "entry",
           "dryrun_multichip"]


class QEPipelineStep:
    """One flagship step. ``step(generator)`` draws the three white-noise
    planes; ``step_from_noise(eta_c, eta_k, eta_n)`` takes them (each
    ``(1, ny, nx)`` complex). Both return ``(3, nbins)`` float32:
    cross, auto_in and auto_rec."""

    def __init__(self, geom: Geometry, th, beam=1.5, noise=7.0,
                 dtype=torch.float32, device=None):
        device = resolve(device)
        self.geom = geom
        self.fls = lensing.FlatLensingSims(geom, th, beam_arcmin=beam,
                                           noise_uk_arcmin=noise, lens_order=3,
                                           dtype=dtype, device=device)
        ctot = qe.lensing_noise_2d(geom, th, beam, noise, dtype=dtype,
                                   device=device)
        lmax_grid = geom.ellmax_safe()
        self.qe = qe.QE(
            geom, th, ctot,
            xmask=F.mask_kspace(geom, lmin=100, lmax=min(3000, lmax_grid),
                                dtype=dtype, device=device),
            kmask=F.mask_kspace(geom, lmin=40, lmax=min(1000, lmax_grid * 0.8),
                                dtype=dtype, device=device),
            dtype=dtype, device=device)
        self.qe.A_L("TT")
        edges = np.arange(40, min(1000, int(lmax_grid * 0.8)), 60.0)
        self.binner = Bin2D(geom.modlmap_np(), edges, device=device)
        self.norm = geom.area / geom.npix ** 2
        self.kbeam_floor = torch.clamp(self.fls.kbeam, min=1e-8)

    def step_from_noise(self, eta_c, eta_k, eta_n):
        observed, extras = self.fls.get_sim_from_noise(
            eta_c, eta_k, eta_n, return_intermediate=True)
        kobs = torch.fft.fft2(observed) / self.kbeam_floor
        fkrec = self.qe.kappa_from_map("TT", kobs)
        fkin = torch.fft.fft2(extras["kappa"])
        _, cross = self.binner.bin((fkrec.conj() * fkin).real * self.norm)
        _, auto_in = self.binner.bin((fkin.conj() * fkin).real * self.norm)
        _, auto_rec = self.binner.bin((fkrec.conj() * fkrec).real * self.norm)
        return torch.stack([cross, auto_in, auto_rec]).to(torch.float32)

    def step(self, generator: torch.Generator):
        return self.step_from_noise(*self.fls.draw_noise(generator))


def build_qe_pipeline(geom: Geometry, th, beam=1.5, noise=7.0, device=None,
                      dtype=torch.float32) -> QEPipelineStep:
    """Build the flagship step for a geometry and theory (on the card
    unless ``device`` names another)."""
    return QEPipelineStep(geom, th, beam=beam, noise=noise, dtype=dtype,
                          device=resolve(device))


def entry(device=None):
    """``(fn, example_args)``: one flagship step at 512^2 and 2' on
    ``device`` (the card unless it names another), with a seeded
    generator."""
    device = resolve(device)
    # nothing in the slice is worth TF32's three digits: keep fp32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    geom = rect_geometry(width_arcmin=512 * 2.0, px_res_arcmin=2.0)
    pipe = build_qe_pipeline(geom, default_theory(), device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return pipe.step, (gen,)


def _require(cond, what):
    if not cond:
        raise RuntimeError("dryrun_multichip: " + what)


def _dryrun_impl(n_devices: int, device) -> None:
    """One rank's legs of the dry run (``__graft_entry__.py:144-260``), on a
    process group of ``n_devices`` ranks: every collective of the
    distributed layer runs, and each leg is held to its serial
    counterpart."""
    dev = resolve(device)
    shape = (n_devices // 2, 2) if n_devices % 2 == 0 else (n_devices, 1)
    mesh = get_mesh(shape, device=dev)
    geom = rect_geometry(width_arcmin=64 * 8.0, px_res_arcmin=8.0)  # 64x64
    step = build_qe_pipeline(geom, default_theory(), beam=8.0, noise=10.0,
                             device=dev)

    def sim(generator):
        out = step.step(generator)
        return {"cross": out[0], "auto_in": out[1], "auto_rec": out[2]}

    # 1) the data-parallel ensemble: tasks split over 'sims', one
    #    all-reduce of the (N, sum, outer-product) statistics
    st = ensemble_stats(sim, nsims=2 * mesh.shape["sims"], seed=0,
                        mesh=mesh)
    for k in ("cross", "auto_in", "auto_rec"):
        _require(int(st[k].n) == 2 * mesh.shape["sims"]
                 and bool(torch.isfinite(st[k].mean()).all()), k)

    # 2) the grid-split k-space filter (rows over 'grid', the pencil FFT
    #    both ways) against the serial ops.fourier.kfilter
    m_np = np.random.default_rng(1).standard_normal(geom.shape).astype(
        np.float32)
    m = torch.as_tensor(m_np, device=dev)
    kfilt = (geom.modlmap(device=dev) < 1000).to(torch.float32)
    filt = pfourier.ifft2_dist(pfourier.fft2_dist(m, mesh, "grid") * kfilt,
                               mesh, "grid").real
    ref = F.kfilter(m, kfilt, geom)
    _require(float((filt - ref).abs().max()) <= 1e-5 * float(
        ref.abs().max()), "grid-split kfilter")

    # 3) the pencil FFT against numpy's
    z = pfourier.fft2_dist(m, mesh, axis="grid").cpu().numpy()
    zref = np.fft.fft2(m_np)
    _require(np.abs(z - zref).max() < 1e-3 * np.abs(zref).max(),
             "fft2_dist")

    # 4) the ring-split SHT over 'sims' against the serial transform (its
    #    Legendre analysis the plain version: no kernel in the reference)
    lmax = 16
    rings = sht.gauss_legendre_rings(lmax)
    m0 = torch.as_tensor(np.random.default_rng(0).standard_normal(
        rings.shape).astype(np.float32), device=dev)
    a_dist = psht.map2alm_dist(m0, rings, lmax, mesh, axis="sims")
    a_ser = sht.map2alm(m0, rings, lmax, ana=leg.legendre_ana_ref)
    _require(float((a_dist - a_ser).abs().max()) <= 1e-4, "map2alm_dist")
    m_dist = psht.alm2map_dist(a_dist, rings, lmax, mesh, axis="sims")
    _require(bool(torch.isfinite(m_dist).all()), "alm2map_dist")

    # 5) moderate-scale legs, every rank on 'grid' so the collectives move
    #    data: 512^2 masked bandpowers against the numpy bincount
    flat = get_mesh((1, n_devices), device=dev)
    n = 512
    geom_bp = rect_geometry(width_arcmin=n * 2.0, px_res_arcmin=2.0)
    mbig = np.random.default_rng(2).standard_normal((n, n)).astype(
        np.float32)
    taper = get_taper(geom_bp, taper_percent=12.0, device="cpu")[0].to(
        torch.float32).numpy()
    edges = np.arange(80, 5000, 200.0)
    dig = np.digitize(geom_bp.modlmap_np(), edges).astype(np.int32)
    dig[dig == len(edges)] = 0
    nbins = len(edges) - 1
    norm = float(geom_bp.area) / float(geom_bp.npix) ** 2
    bp = pfourier.masked_bandpowers_dist(mbig, taper, dig, nbins, norm, flat,
                                         axis="grid").cpu().numpy()
    zs = np.fft.fft2((mbig * taper).astype(np.complex64))
    ps = (np.abs(zs) ** 2).astype(np.float64) * norm
    sums = np.bincount(dig.ravel(), weights=ps.ravel(), minlength=nbins + 1)
    cnts = np.bincount(dig.ravel(), minlength=nbins + 1)
    ref_bp = sums[1:] / np.maximum(cnts[1:], 1)
    _require(np.allclose(bp, ref_bp, rtol=5e-4), "masked_bandpowers_dist")

    # 6) the lmax-256 ring-split analysis over 'grid' against the serial one
    #    (plain Legendre analysis, as in 4)
    lmax = 256
    rings = sht.gauss_legendre_rings(lmax)
    m1 = torch.as_tensor(np.random.default_rng(3).standard_normal(
        rings.shape).astype(np.float32), device=dev)
    a_dist = psht.map2alm_dist(m1, rings, lmax, flat, axis="grid")
    a_ser = sht.map2alm(m1, rings, lmax, ana=leg.legendre_ana_ref)
    _require(float((a_dist - a_ser).abs().max())
             < 1e-4 * float(a_ser.abs().max()), "map2alm_dist at lmax 256")


_RANK_CODE = """
import sys
sys.path.insert(0, {repo!r})
from orphics_tpu_torch.entry import _dryrun_rank
_dryrun_rank(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
             float(sys.argv[5]))
"""


def _dryrun_rank(rank, n_devices, store, device_type, timeout):
    """A spawned rank of :func:`dryrun_multichip`: join the file-store world
    (NCCL on card ``rank``, gloo on the CPU), run the legs, leave."""
    if device_type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n_devices))
    init_multihost(init_method="file://" + store, world_size=n_devices,
                   rank=rank, local_rank=rank, device=device_type,
                   timeout=timeout)
    try:
        _dryrun_impl(n_devices, device_type)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _dryrun_one_rank(dev, timeout):
    """``n_devices == 1``: the legs in this process on a one-rank group of
    its own, destroyed at the end."""
    _require(not dist.is_initialized(), "n_devices == 1 starts its own "
             "one-rank group, and this process already has a group")
    local = (dev.index if dev.index is not None else
             torch.cuda.current_device()) if dev.type == "cuda" else 0
    with tempfile.TemporaryDirectory() as tmp:
        init_multihost(init_method="file://" + os.path.join(tmp, "store"),
                       world_size=1, rank=0, local_rank=local, device=dev,
                       timeout=timeout)
        try:
            _dryrun_impl(1, dev)
        finally:
            dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device=None,
                     timeout: float = 600.0) -> None:
    """Run the distributed layer's dry run (``__graft_entry__.py:59-260``)
    on ``n_devices`` ranks: the flagship step's ensemble over a (n/2, 2)
    (odd n: (n, 1)) mesh, the grid-split k-space filter and pencil FFT, the
    ring-split SHT at lmax 16, then on a (1, n) mesh the 512^2 masked
    bandpowers and the lmax-256 ring-split analysis, each held to its
    serial counterpart.

    ``device``: ``None`` or ``"cuda"`` runs rank ``r`` on card ``r`` over
    NCCL, and needs ``n_devices`` cards; ``"cpu"`` runs the ranks on the
    CPU over gloo. ``n_devices == 1`` runs in this process on a one-rank
    group; more ranks are processes started here, which meet through a
    file store in a temporary directory (no network port of their own).
    ``timeout`` (seconds) bounds every collective and the wait for the
    ranks; a rank that fails or outlives it raises here with its output.
    """
    dev = resolve(device)
    if dev.type == "cuda" and n_devices > torch.cuda.device_count():
        raise RuntimeError(
            f"dryrun_multichip({n_devices}) needs {n_devices} cards and "
            f"{torch.cuda.device_count()} are visible: pass device=\"cpu\" "
            "to run the ranks on the CPU")
    if n_devices == 1:
        return _dryrun_one_rank(dev, timeout)
    if dev.type == "cuda":
        _build.library()             # once here, not in every rank
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = _RANK_CODE.format(repo=repo)
    with tempfile.TemporaryDirectory() as tmp:
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+")
                for r in range(n_devices)]
        procs = [subprocess.Popen(
            [sys.executable, "-c", code, str(r), str(n_devices),
             os.path.join(tmp, "store"), dev.type, str(timeout)],
            cwd=repo, stdout=logs[r], stderr=subprocess.STDOUT)
            for r in range(n_devices)]
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
        out = []
        for r in failed:
            logs[r].seek(0)
            out.append(f"--- rank {r} (exit {procs[r].returncode}):\n"
                       + logs[r].read()[-3000:])
        for f in logs:
            f.close()
    if failed:
        raise RuntimeError(f"dryrun_multichip({n_devices}): ranks {failed} "
                           "failed or timed out\n" + "\n".join(out))
