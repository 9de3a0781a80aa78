"""Card check of the PyTorch / CUDA port: each kernel against its plain
PyTorch version, and every path of the port driven on the card, what comes
out held to the plain versions, the CPU or a known law. Kernels are timed
alone by ``scripts/bench_kernels.py``, the benchmark cells by ``python3 -m
cmbbench.run``.

Run from the repository root on a machine with one NVIDIA Hopper GPU and
nvcc:

    python3 chip_smoke.py

Phases:
 0 the card;
 1 the build: the kernels, and the host HEALPix library by g++;
 2 every kernel against its plain version at the main paths' shapes;
 3 the flagship step;
 4 the half-plane lensing pipeline (impl="xla");
 5 the full-plane lensing pipeline (what impl="auto" runs at 512^2);
 6 FastCl at bench config 1 (2048^2 0.5', batch 192, nseg 100);
 7 FastCl.cross_bandpowers at bench config 2 (the 12 % taper);
 8 the fused ILC coadd at bench config 4 (six bands, tSZ deprojected);
 9 SHT roundtrips at bench config 7 (lmax 2047, dd and fast);
 10, 11 curved-sky masked spectra at bench configs 8 and 8p (lmax 1023);
 12 the TT QE reconstruction-only step at bench config 3, both branches;
 13 the unfused pair spectra at config 1's shape (B6h + B2, B7 + B2');
 14 the N0 / N1 debias at config 3's settings;
 15 cluster stacking at bench config 5 (10^4 stamps of 64^2);
 16 pure-B bandpowers at 1024^2 2' and the map-tools slice;
 17 the distributed layer on a one-rank NCCL group and a (1, 1) mesh;
 18 the galaxy-catalog slice at a 2048^2 0.5' patch;
 19 the fifteen user examples of ``examples/torch/``, in this process;
 20 the curved-sky TT quadratic estimator at lmax 2047.

Phases 3-20 set the launch counts to 0 before they drive their path and
check them after; 4 and 8-18, whose paths no benchmark cell runs, print one
throughput line each. The JSON object on a line before the last holds each
kernel's record (its launches by path and its error against its plain
version); the last is ``{"ok": true, "device": {"platform": "gpu", ...}}``.
Any failed check raises, so the exit code is non-zero and no result line is
printed. It imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import io
import itertools
import json
import math
import os
import runpy
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from orphics_tpu_torch import Geometry, _build, rect_geometry
from orphics_tpu_torch._printed import text_gap
from orphics_tpu_torch.entry import build_qe_pipeline, dryrun_multichip, entry
from orphics_tpu_torch.geometry import arcmin
from orphics_tpu_torch.models import catalogs as cats
from orphics_tpu_torch.models import curved
from orphics_tpu_torch.models import curved_qe as cqe
from orphics_tpu_torch.models import foregrounds as fg
from orphics_tpu_torch.models import grf, ilc, lensing, mapstools, nfwfit
from orphics_tpu_torch.models import pixcov
from orphics_tpu_torch.models import qe as qemod
from orphics_tpu_torch.models.cosmology import Cosmology, LimberCosmology
from orphics_tpu_torch.models.fastcl import FastCl, drop_edge_segments
from orphics_tpu_torch.models.lenspipe import LensedQEPipeline
from orphics_tpu_torch.models.theory import default_theory
from orphics_tpu_torch.ops import alm as almops
from orphics_tpu_torch.ops import dft, lens
from orphics_tpu_torch.ops import legendre as leg
from orphics_tpu_torch.ops import qe_conv as qc
from orphics_tpu_torch.ops import sht
from orphics_tpu_torch.ops.bin_reduce import (bin2_reduce, bin2_reduce_ref,
                                              bin_pair_power,
                                              bin_pair_power_ref, bin_reduce,
                                              bin_reduce_ref)
from orphics_tpu_torch.ops.binning import Bin2D, RfftBin2D
from orphics_tpu_torch.ops.fourier import gauss_beam, kfilter, mask_kspace
from orphics_tpu_torch.ops.lens import (lens_map_kernel, lens_map_ref,
                                        spline_coeffs)
from orphics_tpu_torch.ops.mirror import mirror_pp, mirror_pp_ref
from orphics_tpu_torch.ops.noise_planes import noise_planes
from orphics_tpu_torch.ops.rowcombine import rowcombine_pp, rowcombine_pp_ref
from orphics_tpu_torch.ops.rowpower import (qc_pp_half, qc_pp_half_ref,
                                            rowqc_half, rowqc_pp,
                                            rowqc_pp_ref, rows_half, rows_pp,
                                            rows_pp_ref, s_field, s_pp_half,
                                            s_pp_half_ref)
from orphics_tpu_torch.ops.windows import get_taper
from orphics_tpu_torch.parallel import fourier as pfourier
from orphics_tpu_torch.parallel import runtime as prt
from orphics_tpu_torch.parallel import sht as psht
from orphics_tpu_torch.parallel.statistics import SuffStats
from orphics_tpu_torch.utils import healpix

# B10a / B10s fast mode (float32 recurrence). Against the fast mode's own
# plain version (the same float32 recurrence emulated in torch, each FMA
# rounded once: the same Lambda bit for bit): 2^-22, two float32 ulps of
# max|ref|, since the float64 sums run in another order and an output may
# round to the neighbouring float32 value (8 seeds read 0 to 1.0e-10).
# Against the fp64 loop: the float32 recurrence's own error, which the
# plain version reads to the same digits. With the recurrence's factor
# rounded once from float64 coefficients (legendre.cu: factor), 8 seeds at
# config 8's shape read at most 6.8e-4 (B10a) and 1.3e-3 (B10s), the other
# lmax 1023 shapes at most 9.3e-4, and lmax 2047 7.7e-4 and 1.1e-3
# (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6): 3e-3 at both lmax
B10_FAST_SEEDS = 8
B10_FAST_TOL = {1023: 3e-3, 2047: 3e-3}
B10_FAST_PLAIN_TOL = 2.0 ** -22

# the galaxy-catalog path's bandpower edges (phase 18 and B1's float64
# check in phase 2): ell 200 to 3000 by 200
CAT_EDGES = np.arange(200.0, 3001.0, 200.0)
# bench config 3's bandpower edges (phases 2, 12 and 14)
EDGES3 = np.arange(40, 2000, 80.0)


def config1(th):
    """Bench config 1's sky: the 2048^2 0.5' geometry, the ells and lensed
    TT of ``th``, and the edges arange(80, 8000, 80) (nseg 100)."""
    ells = np.arange(th.lpad + 1)
    return (rect_geometry(width_arcmin=2048 * 0.5, px_res_arcmin=0.5), ells,
            np.asarray(th.lCl("TT", ells)), np.arange(80, 8000, 80.0))


def with_full_ids(fc, edges):
    """A shallow copy of the FastCl ``fc`` that bins with its full
    digitized tables (the edge segments 0 and nseg - 1 kept, as the JAX
    package's FastCl bins), for the kept-vs-full checks of phases 6 and 7."""
    import copy
    perm, _ = dft.row_perm(fc.n)
    dig = np.digitize(fc.geom.modlmap_np()[perm][:, perm], edges,
                      right=True).astype(np.int32)
    p_of_h, pnyq = dft.half_rows(fc.n)
    full = copy.copy(fc)
    ids = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=fc.device)
    full._idc = ids(dig[p_of_h].reshape(-1))
    full._ids0 = ids(dig[0])
    full._idsn = ids(dig[pnyq])
    return full


def kernel_entry(name, source, replaces, err):
    """One kernel's record (``replaces`` None: no TPU kernel); the phases
    that drive its paths add its launches."""
    return dict(name=name, route="cuda",
                source="orphics_tpu_torch/csrc/" + source,
                replaces=(None if replaces is None
                          else "orphics_tpu/ops/" + replaces),
                max_abs_err=err)


def check(cond, msg):
    if not cond:
        raise RuntimeError("check failed: " + msg)


def rel_err(got, ref):
    """(max abs error, max abs error / max|ref|) over paired planes."""
    err = max((g - r).abs().max().item() for g, r in zip(got, ref))
    scale = max(r.abs().max().item() for r in ref)
    return err, err / scale


def throughput(step, batch, nsteps, label, unit, card, tag):
    """Rate of ``step()`` after two warm-up steps (host clock around steps
    ending in a synchronize), with the peak memory."""
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


class Launches:
    """The launch counters of the kernels' entry points, by record name.
    ``reset()`` sets them to 0; ``read(names, tag)`` prints them and checks
    that each of ``names`` launched since."""

    def __init__(self):
        self.lib = _build.library()
        self.counters = {
            "bin_reduce": (bin_reduce,),
            "lens_map_kernel": (lens_map_kernel,),
            "colfft": (dft.colfft, dft.colifft),
            "rowfft": (dft.rowfft, dft.rowifft, dft.rowifft_scaled_y),
            "noise_planes": (noise_planes,),
            "mirror_pp": (mirror_pp,),
            "bin2_reduce": (bin2_reduce,),
            "rowfft_blk0": (dft.rowfft_blk0,),
            "rowifft_noise_y": (dft.rowifft_noise_y,),
            "rowqc_half": (rowqc_half,),
            "colfft_scaled": (dft.colfft_scaled,),
            "rows_half": (rows_half,),
            "rowcombine_pp": (rowcombine_pp,),
            "legendre_ana": (leg.legendre_ana,),
            "legendre_syn": (leg.legendre_syn,),
            "qc_pp_half": (qc_pp_half,),
            "s_pp_half": (s_pp_half,),
            "bin_pair_power": (bin_pair_power,),
            "qe_leg": (qc.qe_leg,),
            "qe_pair": (qc.qe_pair,),
            "qe_post": (qc.qe_post,)}
        self.row_regs = self.b9_regs = 0

    def reset(self):
        for fns in self.counters.values():
            for fn in fns:
                fn.launches = 0
        bin_reduce.launches_f64 = 0
        leg.legendre_ana.ring_io = leg.legendre_syn.ring_io = 0
        self.row_regs = self.lib.rowfft_regs_launches()
        self.b9_regs = self.lib.rowcombine_regs_launches()
        lens_map_kernel.wide_blocks(reset=True)

    def count(self, key):
        return sum(fn.launches for fn in self.counters[key])

    def read(self, names, tag):
        counts = {k: self.count(k) for k in self.counters}
        print(f"[{tag}] launches on this path: {counts}")
        for name in names:
            check(counts[name] > 0, f"{tag}: {name} was not launched")
        return counts

    def read_wide(self, tag, must_be_zero):
        """B8's blocks since reset() whose deflection range exceeded the
        shared-memory window (their taps came from device memory)"""
        wide = lens_map_kernel.wide_blocks()
        print(f"[{tag}] B8 blocks with taps from device memory: {wide}"
              + (" (must be 0 at the pipeline's cap D = 8)" if must_be_zero
                 else ""))
        if must_be_zero:
            check(wide == 0, f"{tag}: {wide} B8 blocks wider than the window")

    def check_row_route(self, counts, tag):
        """Every B4 and B5 launch of the path since reset() took the
        register-resident row kernel (its transforms are 128 * 2^k long)"""
        regs = self.lib.rowfft_regs_launches() - self.row_regs
        rows = counts["rowfft"] + counts["rowifft_noise_y"]
        check(regs == rows, f"{tag}: {regs} of {rows} B4/B5 launches on the "
                            "register-resident row kernel")
        print(f"[{tag}] B4/B5 launches on the register-resident row kernel: "
              f"{regs} of {rows}")


# phase 19: the port's user examples (examples/torch/), in the order of
# the JAX scripts' table: arguments after the script, and the kernels each
# must launch on the card (counter names); the last seven are the
# deterministic forecasts, also run with --device cpu and compared
EXAMPLES19 = (
    ("tt_verification.py", ["512"], ("lens_map_kernel", "bin_reduce",
                                      "qe_leg", "qe_pair", "qe_post")),
    ("fastcl_demo.py", [], ("rowifft_noise_y", "rowqc_half", "bin2_reduce",
                            "bin_reduce", "colfft", "colfft_scaled",
                            "rows_half")),
    ("demo_grf.py", [], ("bin_reduce",)),
    ("curved_sky_demo.py", [], ("legendre_ana", "legendre_syn")),
    ("rdn0_demo.py", [], ("bin_reduce",)),
    ("mesh_ensemble.py", [], ("bin_reduce", "legendre_ana@full",
                              "legendre_syn@full")),
    ("distributed_fft.py", [], ("bin_reduce",)),
    ("inpainting.py", [], ()),
    ("ilc_forecast.py", [], ()),
    ("limber_forecast.py", [], ()),
    ("qe_mv_noise.py", [], ()),
    ("lensing_noise_curves.py", [], ()),
    ("rsd_kmode_fisher.py", [], ()),
    ("shear_corner.py", [], ()),
    ("tsz_halomodel.py", [], ()),
)
DETERMINISTIC19 = {n for n, _, _ in EXAMPLES19[8:]}
# the two QE forecasts take minutes on the CPU at their default size
# (~5e4 FFTs of 400^2, float32; of 128^2 in float64): their card-vs-CPU
# comparison runs both sides at the quick size
QUICK_CMP19 = {"qe_mv_noise.py", "lensing_noise_curves.py"}
# each example's check line: its gate, or for a forecast its last result
CHECK19 = {"tt_verification.py": "verification ", "distributed_fft.py": "OK",
           "rsd_kmode_fisher.py": "OK", "ilc_forecast.py": "deprojection",
           "limber_forecast.py": "S/N", "qe_mv_noise.py": "full-MV",
           "lensing_noise_curves.py": "S4-like", "shear_corner.py": "DES-like",
           "tsz_halomodel.py": "tSZ power"}


def run_example(path, argv):
    """Run an example script in this process as ``python path *argv`` would
    (``runpy``, ``sys.argv`` set): ``(stdout, exit code, wall seconds)``,
    the card synchronized before the clock stops. An exception of the
    script propagates."""
    old = sys.argv
    buf = io.StringIO()
    code = 0
    sys.argv = [path] + list(argv)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(path, run_name="__main__")
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else (0 if e.code is None
                                                       else 1)
    finally:
        sys.argv = old
    torch.cuda.synchronize()
    return buf.getvalue(), code, time.perf_counter() - t0


def describe(value):
    """A short text of an argument: a tensor's shape and dtype, a Legendre
    table's lmax and layout, a scalar's value, else its type"""
    if isinstance(value, torch.Tensor):
        return ("x".join(map(str, value.shape)) + " "
                + str(value.dtype).replace("torch.", ""))
    if isinstance(value, dict) and "layout" in value:
        return f"lmax {value['lmax']} {value['layout']}"
    if isinstance(value, tuple):
        if value and all(isinstance(v, torch.Tensor) for v in value):
            return "(" + ", ".join(describe(v) for v in value) + ")"
        return f"{len(value)}-tuple"
    if value is None or isinstance(value, (bool, int, float, str)):
        return repr(value)
    return type(value).__name__


def on_card(value):
    """A CUDA tensor, or a tuple holding one"""
    if isinstance(value, tuple):
        return any(on_card(v) for v in value)
    return isinstance(value, torch.Tensor) and value.is_cuda


def copied(value):
    """A copy of a tensor, or of the tensors of a tuple; else the value"""
    if isinstance(value, tuple):
        return tuple(copied(v) for v in value)
    if isinstance(value, torch.Tensor):
        return value.detach().clone()
    return value


class CallRecorder:
    """While on, records each call on the card of the given kernel entry
    points (``{function: counter name}``): per function and argument
    shapes, a copy of the first call's arguments, the calls, and the
    launches of the function's counter during them (``count(name)`` reads
    it). ``sys.monitoring`` watches only those functions' code, so nothing
    else runs slower; the copy is made before the function runs. A tuple
    of tensors (``qe_pair``'s legs) counts and is copied as its tensors."""

    def __init__(self, entries, count):
        self.entries = entries
        self.count = count
        self.code = {}
        for fn in entries:
            # a span wrapper's own code is shared and takes *args: watch
            # the function it wraps
            co = getattr(fn, "__wrapped__", fn).__code__
            check(co.co_kwonlyargcount == 0 and not co.co_flags & 0x0C,
                  f"{fn.__name__}: not a plain positional signature")
            self.code[co] = fn
        self.records = {}
        self.stack = []
        self.tool = None

    def _start(self, code, _offset):
        fn = self.code[code]
        loc = sys._getframe(1).f_locals
        args = tuple(loc[n] for n in code.co_varnames[:code.co_argcount])
        if not any(on_card(a) for a in args):
            self.stack.append((code, None, 0))
            return
        sig = f"{fn.__name__}({', '.join(describe(a) for a in args)})"
        rec = self.records.get((fn, sig))
        if rec is None:
            rec = self.records[(fn, sig)] = dict(
                fn=fn, key=self.entries[fn], sig=sig, calls=0, launches=0,
                args=copied(args),
                layout=next((a["layout"] for a in args
                             if isinstance(a, dict) and "layout" in a), None))
        rec["calls"] += 1
        self.stack.append((code, rec, self.count(rec["key"])))

    def _end(self, code, _offset, _value):
        # calls that raised never return: their entries are dropped here
        while self.stack:
            co, rec, before = self.stack.pop()
            if co is code:
                if rec is not None:
                    rec["launches"] += self.count(rec["key"]) - before
                return

    def __enter__(self):
        mon = sys.monitoring
        self.tool = next(i for i in range(6) if mon.get_tool(i) is None)
        mon.use_tool_id(self.tool, "chip_smoke phase 19")
        ev = mon.events
        mon.register_callback(self.tool, ev.PY_START, self._start)
        mon.register_callback(self.tool, ev.PY_RETURN, self._end)
        for co in self.code:
            mon.set_local_events(self.tool, co, ev.PY_START | ev.PY_RETURN)
        self.records, self.stack = {}, []
        return self

    def __exit__(self, *exc):
        mon = sys.monitoring
        for co in self.code:
            mon.set_local_events(self.tool, co, 0)
        for ev in (mon.events.PY_START, mon.events.PY_RETURN):
            mon.register_callback(self.tool, ev, None)
        mon.free_tool_id(self.tool)
        return False


# the QE's filter algebra (csrc/qe_conv.cu) against its plain versions:
# the same float32 products, contracted into FMAs by the compiler (of max)
QE_CONV_TOL = 1e-6


def fft_tol(a):
    """phase 2's tolerance of the DFT kernels, of max|ref|"""
    return 1.5e-5 if max(a[0].shape[-2:]) >= 2048 else 2e-5


def plain_versions():
    """Every Python entry point that launches a kernel: ``{function:
    (counter, plain version on the same arguments, each output's
    tolerance, None or the scale of each output's error)}``. The tolerance
    is of max|ref|, or for the segment sums of the binned |data|, as phase
    2 holds each kernel. B5 is held to the plain inverse of B5n's planes on
    the same words, the stream both kernels draw (phase 2); B5n itself has
    no elementwise plain version and no entry here."""

    def b10_plain(ref):
        # the call's layouts (phase, weights, packed alms) passed on
        return lambda x, tab, fast, *io: ref(x, tab, bool(fast), *io)

    def b10_tol(a):
        return B10_FAST_PLAIN_TOL if a[2] else 1e-6

    return {
        bin_reduce: ("bin_reduce", bin_reduce_ref,
                     lambda a: 1e-12 if a[0].dtype == torch.float64
                     else 1e-6,
                     lambda a: (bin_reduce_ref(a[0].abs(), *a[1:]),)),
        bin2_reduce: ("bin2_reduce", bin2_reduce_ref, 1e-6,
                      lambda a: tuple(bin_reduce_ref(d.abs(), *a[2:])
                                      for d in a[:2])),
        bin_pair_power: ("bin_pair_power", bin_pair_power_ref, 1e-6, None),
        lens._launch: ("lens_map_kernel", lens.lens_map_ref, 2e-5, None),
        dft.colfft: ("colfft", dft.colfft_ref, fft_tol, None),
        dft.colifft: ("colfft", dft.colifft_ref, fft_tol, None),
        dft.colfft_scaled: ("colfft_scaled", dft.colfft_scaled_ref, fft_tol,
                            None),
        dft.rowfft: ("rowfft", dft.rowfft_ref, fft_tol, None),
        dft.rowifft: ("rowfft", dft.rowifft_ref, fft_tol, None),
        dft.rowifft_scaled_y: ("rowfft", dft.rowifft_scaled_y_ref, fft_tol,
                               None),
        dft.rowfft_blk0: ("rowfft_blk0", dft.rowfft_blk0_ref, fft_tol, None),
        dft.rowifft_noise_y: ("rowifft_noise_y", lambda sc, w, b: (
            dft.rowifft_ref(*noise_planes(sc, w, b))), lambda a: fft_tol(
                (a[0][None],)), None),
        mirror_pp: ("mirror_pp", mirror_pp_ref, 0.0, None),
        rowqc_half: ("rowqc_half", lambda yr, yi: rowqc_pp_ref(yr, yi)[:2],
                     3e-5, None),
        rowqc_pp: ("rowqc_half", rowqc_pp_ref, (3e-5, 3e-5, 1.5e-5, 1.5e-5),
                   None),
        rows_half: ("rows_half", lambda yr, yi: rows_pp_ref(yr, yi)[0], 3e-5,
                    None),
        rows_pp: ("rows_half", rows_pp_ref, (3e-5, 1.5e-5, 1.5e-5), None),
        qc_pp_half: ("qc_pp_half", qc_pp_half_ref, 1e-6, None),
        s_pp_half: ("s_pp_half", s_pp_half_ref, 1e-6, None),
        rowcombine_pp: ("rowcombine_pp", rowcombine_pp_ref, 1e-5, None),
        qc.qe_leg: ("qe_leg", qc.qe_leg_ref, QE_CONV_TOL, None),
        qc.qe_pair: ("qe_pair", qc.qe_pair_ref, QE_CONV_TOL, None),
        qc.qe_post: ("qe_post", qc.qe_post_ref, QE_CONV_TOL, None),
        leg.legendre_ana: ("legendre_ana", b10_plain(leg.legendre_ana_ref),
                           b10_tol, None),
        leg.legendre_syn: ("legendre_syn", b10_plain(leg.legendre_syn_ref),
                           b10_tol, None)}


def plain_gap(rec, plain):
    """A recorded call's kernel output against its plain version on the
    call's own arguments (``plain``: :func:`plain_versions`): the worst
    output's (error, tolerance), the error in the tolerance's metric.
    Launches made here are not the path's: phase 19 reads its counts
    before."""
    _, ref_fn, tol, scale = plain[rec["fn"]]
    a = rec["args"]
    got, ref = rec["fn"](*a), ref_fn(*a)
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    tols = tol(a) if callable(tol) else tol
    tols = tols if isinstance(tols, tuple) else (tols,) * len(ref)
    scales = scale(a) if scale else (None,) * len(ref)
    check(len(got) == len(ref) == len(tols) == len(scales),
          f"{rec['sig']}: {len(got)} outputs, {len(ref)} plain")
    gaps = []
    for g, r, t, sc in zip(got, ref, tols, scales):
        check(g.shape == r.shape, f"{rec['sig']}: shape {tuple(g.shape)} vs "
                                  f"{tuple(r.shape)}")
        if t == 0.0:
            e = 0.0 if torch.equal(g, r) else math.inf
        elif sc is None:
            e = ((g - r).abs().max() / r.abs().max().clamp_min(1e-300)).item()
        else:
            e = ((g - r).abs() / sc.clamp_min(1e-30)).max().item()
        gaps.append((e / t if t else e, e, t))
    return max(gaps)[1:]


def curved_qe_phase(dev, card, results, reset_counts, read_counts):
    """Phase 20: the curved-sky TT quadratic estimator
    (``models/curved_qe``) at full width: lmax 2047 (Planck's TT range) on
    ``gauss_legendre_rings(3071)`` (3072 x 6144, exact to degree 6143 >= 3
    lmax: the estimator analyses products of three band-lmax fields), the
    lensed TT and C^phiphi of ``default_theory()``, 10 uK-arcmin white
    noise, no beam (ctot = cl + N).

    (a) ``CurvedQE`` with its sums on the card at the default 112 Ls, the
    build's seconds; R and N0num at three of its Ls held to the sums run
    with ``device="cpu"`` (1e-12 relative). (b) The B10s input of one
    ``phi_from_alm`` call on 4 sims (16 stacked alms) and its B10a input
    (12 weighted product rings) against ``legendre_syn_ref`` /
    ``legendre_ana_ref`` on the same tensors (phase 2's 1e-6 of max|ref|).
    (c) ``phi_from_alm`` of one draw at lmax
    255 on ``gauss_legendre_rings(383)``, card (kernels) against CPU (plain
    versions): each entry within 1e-5 of max|gbar| times its L's 1/R_L (1/R
    spans decades, so the normalized output's own max would read float32
    residue at L <= 1 scaled by 1/R_1). (d) Closure: phi from C^phiphi, T0
    from the estimator's lensed TT, T = T0 +- grad_dot(phi, T0) + noise, S
    = 16 sims in 4 calls of 4; then 16 Gaussian sims of ctot (phi = 0). In
    bins of dL = 100 over L in [20, 1000]: the cross ratio r_b = sum (2L+1)
    C^{phihat phi}_L / sum (2L+1) C^{phi phi}_L (sums over the bin and the
    sims, phihat at +phi) and the +-phi ratio r_d, the same with (phihat(+)
    - phihat(-)) / 2, in which the noise terms even in phi cancel, must each
    equal the expectation e_b, and the auto ratio sum (2L+1) C^{phihat
    phihat}_L / (S sum (2L+1) N0_L e_L^2) of the phi = 0 sims must be 1,
    each within 5 sigma. N0_L is ``n0_tt``'s at every L and e_L = R_L /
    R_interp(L) the exact response over the one the engine applies (1 at
    its 112 sampled Ls, linear interpolation of 1/R between them; e_b its
    mode average). sigma_G^2 = sum (2L+1) (C^phiphi_L + N_L) C^phiphi_L / (S
    [sum (2L+1) C^phiphi_L]^2), the Gaussian scatter from the bin's modes,
    where N_L is the reconstruction noise power these sims carry, the
    power of (phihat(+) + phihat(-)) / 2: N0 with ctot's power, and more,
    since first-order lensed T carries power that ctot lacks (at l ~ 2000
    grad(phi) . grad(T) is not small). sigma_R^2 = sum X^2 / [sum (2L+1)
    C^{phi phi}_L]^2 with X = Re([(phihat(+) - phihat(-)) / 2 - e_L phi]
    phi*) per mode (m > 0 twice): the measured scatter of the response,
    which a finite T0 couples to every phi mode (the term behind the N1
    bias). r_b's sigma is sqrt(sigma_G^2 + sigma_R^2), r_d's sigma_R; the
    auto's sigma'^2 = 2 sum (2L+1) (N0_L e_L^2)^2 / (S [sum (2L+1) N0_L
    e_L^2]^2). With N0 in sigma_G and no sigma_R, card runs read pulls up
    to 3.13 (PERF.md, section 6). T0 takes the lensed TT because the
    first-order response to it is R with that spectrum in the coupling;
    from the unlensed TT it would be R with the unlensed spectrum there,
    which the engine does not compute. With the JAX function's sign on the
    last two terms the ratios are negative. (f) From counts at 0: exactly
    one B10s and one B10a launch, both on layout "fold", per
    ``phi_from_alm`` call of 4 sims."""
    t20 = time.perf_counter()
    lmax, nsims, nbatch = 2047, 4, 4
    rings = sht.gauss_legendre_rings(3071)
    check(rings.shape == (3072, 6144), f"20: rings {rings.shape}")
    ells = np.arange(lmax + 1)
    th = default_theory()
    cl = np.asarray(th.lCl("TT", ells))
    nl = (10.0 * math.pi / 10800.0) ** 2
    ctot = cl + nl
    clpp = np.zeros(lmax + 1)
    clpp[1:] = 4.0 * np.asarray(th.gCl("kk", ells[1:])) / (
        ells[1:] * (ells[1:] + 1.0)) ** 2

    # (a) the engine, its sums on the card; three Ls against the CPU
    t0 = time.perf_counter()
    qe = cqe.CurvedQE(rings, lmax, cl, ctot, device=dev)
    torch.cuda.synchronize()
    dt_build = time.perf_counter() - t0
    idx = [int(np.argmin(np.abs(qe.Ls - L))) for L in (10, 500, 1500)]
    Ls3 = qe.Ls[idx]
    t0 = time.perf_counter()
    R3, N3 = cqe._qtt_sums(cl, ctot, lmax, Ls3, device="cpu")
    dt_cpu = time.perf_counter() - t0
    errR = float(np.max(np.abs(qe.R[idx] - R3) / np.abs(R3)))
    errN = float(np.max(np.abs(qe.N0num[idx] - N3) / np.abs(N3)))
    check(errR <= 1e-12 and errN <= 1e-12, f"20: sums card vs CPU at L "
          f"{Ls3.tolist()}: R {errR:.3e}, N0num {errN:.3e}")
    print(f"[20a] CurvedQE lmax {lmax}, {qe.Ls.size} Ls, sums in float64 on "
          f"the card: {dt_build:.3f} s; at L {Ls3.tolist()} R "
          f"{qe.R[idx].tolist()} vs the CPU's ({dt_cpu:.3f} s for the "
          f"three) {errR:.3e}, N0num {errN:.3e} relative (<= 1e-12)")

    # the exact sums at every L of the closure's range, (d)
    t0 = time.perf_counter()
    Ld = np.arange(20, 1001)
    Rd, Nd = cqe._qtt_sums(cl, ctot, lmax, Ld, device=dev, chunk=lmax + 1)
    dt_dense = time.perf_counter() - t0
    e_L = Rd * qe._rinv_dense[Ld]
    n0_L = Nd / Rd ** 2
    ls_p, ms_p = almops.lm_indices(lmax)
    e_dense = np.ones(lmax + 1)
    e_dense[Ld] = e_L
    e_p = torch.as_tensor(e_dense[ls_p], device=dev)
    c_p = torch.as_tensor(np.where(ms_p == 0, 1.0, 2.0), device=dev)
    l_p = torch.as_tensor(ls_p.astype(np.int64), device=dev)

    # the sims, nbatch calls of nsims: phi ~ C^phiphi, T0 ~ cl (the
    # engine's), noise ~ N, T = T0 +- grad_dot(phi, T0) + noise, and
    # Gaussian sims of ctot (phi = 0). The first call is the main path's
    # run (f): counts from 0, one B10s and one B10a launch, on folded
    # tables; its kernels' inputs are recorded for (b)
    gen = torch.Generator(device=dev).manual_seed(2020)
    draw = lambda c: almops.synalm(gen, c, lmax, batch=(nsims,), device=dev)
    c128 = lambda a: a.to(torch.complex128)
    spec = {k: np.zeros(lmax + 1)
            for k in ("cross", "cross_d", "phi", "even", "null", "X2")}
    recorder = CallRecorder({leg.legendre_ana: "legendre_ana",
                             leg.legendre_syn: "legendre_syn"},
                            lambda k: getattr(leg, k).launches)
    for i in range(nbatch):
        phi = draw(clpp)
        t0lm = draw(cl)
        dT = cqe.grad_dot(phi, t0lm, rings, lmax)
        nlm = draw(np.full(lmax + 1, nl))
        tlm = t0lm + dT + nlm
        check(bool(torch.isfinite(torch.view_as_real(tlm)).all()),
              "20: lensed sims not finite")
        if i == 0:
            reset_counts()
            with recorder:
                phihat = qe.phi_from_alm(tlm)
                torch.cuda.synchronize()
            counts = read_counts(("legendre_ana", "legendre_syn"), "20")
            ring_io = (leg.legendre_ana.ring_io, leg.legendre_syn.ring_io)
        else:
            phihat = qe.phi_from_alm(tlm)
        phihat_m = qe.phi_from_alm(t0lm - dT + nlm)     # the same at -phi
        phihat0 = qe.phi_from_alm(draw(ctot))
        p = c128(phi)
        d = 0.5 * (c128(phihat) - c128(phihat_m))
        ev = 0.5 * (c128(phihat) + c128(phihat_m))
        # per packed mode (m > 0 twice), the response term's share of the
        # numerator: its squares sum to sigma_R's variance
        X = c_p * ((d - e_p * p) * p.conj()).real
        for k, v in (("cross", almops.alm2cl(c128(phihat), p)),
                     ("cross_d", almops.alm2cl(d, p)),
                     ("phi", almops.alm2cl(p)), ("even", almops.alm2cl(ev)),
                     ("null", almops.alm2cl(c128(phihat0)))):
            spec[k] += v.sum(0).cpu().numpy()
        spec["X2"] += torch.zeros(lmax + 1, dtype=torch.float64,
                                  device=dev).index_add_(
            0, l_p, (X * X).sum(0)).cpu().numpy()
    nsim_d = nsims * nbatch
    del phi, t0lm, dT, nlm, tlm, phihat, phihat_m, phihat0, p, d, ev, X
    recs = sorted(recorder.records.values(), key=lambda r: r["key"])
    seen = [(r["key"], r["layout"], r["calls"], r["launches"]) for r in recs]
    check((counts["legendre_ana"], counts["legendre_syn"]) == (1, 1)
          and seen == [("legendre_ana", "fold", 1, 1),
                       ("legendre_syn", "fold", 1, 1)],
          f"20: one phi_from_alm call of {nsims} sims launched B10a "
          f"{counts['legendre_ana']}, B10s {counts['legendre_syn']} times "
          f"({seen}), not once each on layout fold")
    print(f"[20f] one phi_from_alm call of {nsims} sims: "
          + ", ".join(f"{r['sig']}: {r['launches']} launch" for r in recs))
    ref_of = {"legendre_ana": leg.legendre_ana_ref,
              "legendre_syn": leg.legendre_syn_ref}
    check(ring_io == (1, 1), f"20: {ring_io} B10a/B10s launches on the "
                             "scalar SHT's layouts, not (1, 1)")
    print(f"[20f] both launches on the scalar SHT's layouts (ring_io "
          f"{ring_io})")
    for r in recs:
        name, fn, args = r["key"], r["fn"], r["args"]
        x, tab = args[:2]
        ktab = leg.kernel_tables(tab)
        err, rel = rel_err((fn(*args),), (ref_of[name](*args),))
        check(rel <= 1e-6, f"20: {name} on the path's inputs {tuple(x.shape)}"
                           f": {rel:.3e} of max|ref| > 1e-6")
        key = name + "_qe"
        results[key] = kernel_entry(
            key, "legendre.cu", "pallas_sht.py:1216,1230"
            if name == "legendre_ana" else "pallas_sht.py:1260,1273", err)
        print(f"[20b] {name} on the path's input {tuple(x.shape)} (layout "
              f"{tab['layout']}, {ktab['Tk']} kernel rings, {ktab['ng']} "
              f"groups of 32): max abs err {err:.3e} = {rel:.3e} of max|ref| "
              f"(<= 1e-6)")
    del recorder, recs, r, x

    # (c) card vs CPU at lmax 255
    lc = 255
    rings_c = sht.gauss_legendre_rings(383)
    qe_c = cqe.CurvedQE(rings_c, lc, cl[: lc + 1], ctot[: lc + 1],
                        device=dev)
    tc = almops.synalm(torch.Generator(device=dev).manual_seed(255),
                       ctot[: lc + 1], lc, device=dev)
    phi_card = qe_c.phi_from_alm(tc).cpu().numpy()
    phi_cpu = qe_c.phi_from_alm(tc.cpu()).numpy()
    gbar_cpu = cqe.qtt_bar(tc.cpu(), rings_c, lc, qe_c.fl,
                           qe_c.wl).numpy()
    ls_c = almops.lm_indices(lc)[0]
    scale = np.max(np.abs(gbar_cpu)) * qe_c._rinv_dense[ls_c]
    errc = float(np.max(np.abs(phi_card - phi_cpu) / scale))
    errc_max = float(np.max(np.abs(phi_card - phi_cpu))
                     / np.max(np.abs(phi_cpu)))
    check(np.isfinite(phi_card).all() and errc <= 1e-5,
          f"20: phi_from_alm card vs CPU at lmax {lc}: {errc:.3e}")
    print(f"[20c] phi_from_alm lmax {lc} on {rings_c.ntheta} rings, one "
          f"draw: card vs "
          f"CPU {errc:.3e} of max|gbar| x 1/R_L (<= 1e-5); {errc_max:.3e} "
          "of max|phi|")

    # (d) closure: binned cross, +-phi and N0 ratios against expectations
    edges = np.append(np.arange(20, 1000, 100), 1001)
    worst = 0.0
    nbins = 0
    for lo, hi in zip(edges[:-1], edges[1:]):
        sel = (Ld >= lo) & (Ld < hi)
        L, w = Ld[sel], 2.0 * Ld[sel] + 1.0
        c, n0 = clpp[L], n0_L[sel]
        den = np.sum(w * spec["phi"][L])
        r = float(np.sum(w * spec["cross"][L]) / den)
        r_d = float(np.sum(w * spec["cross_d"][L]) / den)
        e = float(np.sum(w * c * e_L[sel]) / np.sum(w * c))
        n_rec = spec["even"][L] / nsim_d
        sig_g = math.sqrt(np.sum(w * (c + n_rec) * c) / nsim_d) / np.sum(
            w * c)
        sig_r = math.sqrt(np.sum(spec["X2"][L])) / den
        sig = math.hypot(sig_g, sig_r)
        ne = n0 * e_L[sel] ** 2
        a = float(np.sum(w * spec["null"][L]) / (nsim_d * np.sum(w * ne)))
        a_raw = float(np.sum(w * spec["null"][L])
                      / (nsim_d * np.sum(w * n0)))
        sig0 = math.sqrt(2.0 * np.sum(w * ne ** 2) / nsim_d) / np.sum(w * ne)
        pull, pull_d = (r - e) / sig, (r_d - e) / sig_r
        pull0 = (a - 1.0) / sig0
        worst = max(worst, abs(pull), abs(pull_d), abs(pull0))
        nbins += 1
        print(f"[20d] L {lo}-{hi - 1}: expected {e:.5f}; cross r = "
              f"{r:.5f}, sigma {sig:.5f} (Gaussian {sig_g:.5f} with the "
              f"sims' noise power {np.sum(w * n_rec) / np.sum(w * ne):.3f} "
              f"N0, response {sig_r:.5f}), pull {pull:+.2f}; +-phi r_d = "
              f"{r_d:.5f}, pull {pull_d:+.2f}; N0 auto ratio {a:.5f} (to "
              f"n0_tt alone {a_raw:.5f}), sigma {sig0:.5f}, pull "
              f"{pull0:+.2f}")
    check(worst <= 5.0, f"20: closure off by {worst:.2f} sigma")
    print(f"[20d] closure over L 20-1000 in {nbins} bins, {nsim_d} lensed "
          f"sims at +-phi and {nsim_d} phi = 0 sims: worst pull {worst:.2f} "
          f"(<= 5); the exact sums at {Ld.size} Ls on the card "
          f"{dt_dense:.3f} s")

    results["legendre_ana_qe"]["launches"] = counts["legendre_ana"]
    results["legendre_syn_qe"]["launches"] = counts["legendre_syn"]
    for k in ("legendre_ana", "legendre_syn"):
        results[k].setdefault("launches_by_path", {})["curved_qe"] = \
            counts[k]
    del qe, qe_c
    leg.clear_tables()
    torch.cuda.empty_cache()
    print(f"[20] the phase took {time.perf_counter() - t20:.3f} s on {card}")


def card_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]




def kernels_phase(dev, results, gen, geom, th):
    """Phase 2: every kernel against its plain version at the main paths'
    shapes, two runs bit-equal, the kernel each shape takes; a record of
    each kernel in ``results``."""
    lmax_grid = geom.ellmax_safe()

    # B1: RfftBin2D of the pipeline (3 spectra x batch 64, weights 2/1,
    # 36 bins) and Bin2D of the flagship step (one plane, 15 bins)
    pipe_edges = np.arange(40, min(3000, int(lmax_grid * 0.8)), 80.0)
    rb = RfftBin2D(geom, pipe_edges, device=dev)
    flag_edges = np.arange(40, min(1000, int(lmax_grid * 0.8)), 60.0)
    fb = Bin2D(geom.modlmap_np(), flag_edges, device=dev)
    b1_err = 0.0
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
        print(f"[2] B1 bin_reduce {label} ({B}, {n}) nseg={nseg}: max rel err "
              f"{rel:.3e} of binned |data|, reproducible")
    results["bin_reduce"] = kernel_entry(
        "bin_reduce", "bin_reduce.cu", "pallas_kernels.py:94", b1_err)

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
    for order in (5, 3):
        coeffs = spline_coeffs(cmb, geom, order).contiguous()
        lens_map_kernel.wide_blocks(reset=True)
        out = lens_map_kernel(coeffs, alpha, geom, order=order, maxdisp_px=8,
                              prefiltered=True)
        again = lens_map_kernel(coeffs, alpha, geom, order=order,
                                maxdisp_px=8, prefiltered=True)
        wide = lens_map_kernel.wide_blocks()
        ref = lens_map_ref(coeffs, alpha, geom, order, 8)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        scale = ref.abs().max().item()
        check(err <= 2e-5 * scale, f"B8 order {order}: error {err:.3e} > "
                                   f"2e-5 * {scale:.3e}")
        check(torch.equal(out, again), f"B8 order {order}: two runs differ")
        # a clip of D = 8 keeps every block's floor range within the
        # shared-memory window (2 D = 16 pixels)
        check(wide == 0, f"B8 order {order}: {wide} blocks took their taps "
                         "from device memory at config 6's deflection")
        del again
        b8_err = max(b8_err, err)
        print(f"[2] B8 lens_map_kernel order {order} (64, 1, 512, 512) D=8: "
              f"max|alpha|/dy {amax:.3f}, max abs err {err:.3e} "
              f"(max|ref| {scale:.3e}), reproducible, wide blocks {wide} "
              f"(must be 0)")
        del coeffs, out, ref
    results["lens_map_kernel"] = kernel_entry(
        "lens_map_kernel", "lens_spline.cu", "pallas_lens.py:263", b8_err)
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
    for shape, tol in (((64, 512, 512), 2e-5), ((32, 512, 512), 2e-5),
                       ((64, 384, 384), 2e-5), ((4, 2048, 2048), 1.5e-5)):
        x = planes(shape)
        for kid, name, fn, ref_fn in dft_cases:
            err, rel = rel_err(fn(*x), ref_fn(*x))
            torch.cuda.synchronize()
            check(rel <= tol, f"{kid} {name} {shape}: error {rel:.3e} of "
                              f"max|ref| > {tol}")
            dft_err[kid] = max(dft_err[kid], err)
            print(f"[2] {kid} {name} {shape}: max abs err {err:.3e} = "
                  f"{rel:.3e} of max|ref| (<= {tol})")
        del x
    x = planes((64, 512, 512))
    sc = torch.rand((512, 512), generator=gen, device=dev) + 0.5
    err, rel = rel_err(dft.rowifft_scaled_y(*x, sc),
                       dft.rowifft_scaled_y_ref(*x, sc))
    check(rel <= 2e-5, f"B4 rowifft_scaled_y: error {rel:.3e} of max|ref|")
    dft_err["B4"] = max(dft_err["B4"], err)
    print(f"[2] B4 rowifft_scaled_y (64, 512, 512): max abs err {err:.3e} = "
          f"{rel:.3e} of max|ref| (<= 2e-5)")
    del x

    # B4 on the register-resident row kernel at n = 256 .. 4096 and at row
    # counts that fill no block (7, 130), n = 384 and 640 on the radix-2
    # one: each entry point against its plain version at 1.5e-5 of max|ref|
    # at n >= 2048 (2e-5 below), two runs bit-equal, and the kernel each
    # shape launched (rowfft_regs_launches counts the row kernels'
    # launches). A generator of their own, as B3's checks below
    klib = _build.library()
    gen4 = torch.Generator(device=dev)
    gen4.manual_seed(4)

    def row_route(kid, fn, args, n, tag):
        """Two runs of a row transform: the output, after checking both
        launches took the kernel that n calls for and agree bit for bit"""
        bk = n // 128
        want = 0 if bk & (bk - 1) else 2
        before = klib.rowfft_regs_launches()
        got = fn(*args)
        again = fn(*args)
        torch.cuda.synchronize()
        regs = klib.rowfft_regs_launches() - before
        check(regs == want, f"{kid} {fn.__name__} {tag}: {regs} of 2 "
                            "launches on the register-resident row kernel")
        check(all(torch.equal(g, a) for g, a in zip(got, again)),
              f"{kid} {fn.__name__} {tag}: two runs differ")
        return got

    for shape in ((8, 256, 256), (4, 384, 384), (2, 640, 640),
                  (8, 512, 512), (4, 1024, 1024), (2, 2048, 2048),
                  (1, 4096, 4096), (1, 7, 2048), (2, 130, 512)):
        xb = tuple(torch.randn(shape, generator=gen4, device=dev)
                   for _ in range(2))
        wb = torch.rand(shape[1:], generator=gen4, device=dev) + 0.5
        n, bk = shape[2], shape[2] // 128
        tol = 1.5e-5 if n >= 2048 else 2e-5
        line = (f"[2] B4 {shape} on the "
                f"{'radix-2' if bk & (bk - 1) else 'register-resident'} "
                "kernel:")
        for fn, ref_fn, args in (
                (dft.rowfft, dft.rowfft_ref, xb),
                (dft.rowifft, dft.rowifft_ref, xb),
                (dft.rowifft_scaled_y, dft.rowifft_scaled_y_ref, xb + (wb,))):
            got = row_route("B4", fn, args, n, str(shape))
            err, rel = rel_err(got, ref_fn(*args))
            check(rel <= tol, f"B4 {fn.__name__} {shape}: error {rel:.3e} of "
                              f"max|ref| > {tol}")
            dft_err["B4"] = max(dft_err["B4"], err)
            line += f" {fn.__name__} {rel:.3e}"
        print(line + f" of max|ref| (<= {tol}), two runs bit-equal")
        del xb, wb, got
    torch.cuda.empty_cache()

    # B3 and B3s on the register-resident column kernel at n = 256 .. 4096
    # and at ragged column counts, n = 384 on the radix-2 one: 1.5e-5 of
    # max|ref|, two runs bit-equal, and the kernel each shape launched
    # (colfft_regs_launches counts the register-resident kernel's launches).
    # Their inputs come from a generator of their own, so that the later
    # checks see the draws they always saw
    gen3 = torch.Generator(device=dev)
    gen3.manual_seed(3)
    b3s_err = 0.0
    for shape in ((8, 256, 256), (4, 384, 384), (8, 512, 512),
                  (4, 1024, 1024), (2, 2048, 2048), (1, 4096, 4096),
                  (3, 2048, 1025), (2, 512, 7)):
        xb = tuple(torch.randn(shape, generator=gen3, device=dev)
                   for _ in range(2))
        wb = torch.rand(shape[1:], generator=gen3, device=dev)
        bk = shape[1] // 128
        regs_want = 0 if bk & (bk - 1) else 2
        line = (f"[2] B3/B3s {shape} on the "
                f"{'radix-2' if regs_want == 0 else 'register-resident'} "
                "kernel:")
        for name, fn, ref_fn, args in (
                ("colfft", dft.colfft, dft.colfft_ref, xb),
                ("colifft", dft.colifft, dft.colifft_ref, xb),
                ("colfft_scaled", dft.colfft_scaled, dft.colfft_scaled_ref,
                 xb + (wb,))):
            before = klib.colfft_regs_launches()
            gb = fn(*args)
            ab = fn(*args)
            torch.cuda.synchronize()
            regs = klib.colfft_regs_launches() - before
            check(regs == regs_want, f"{name} {shape}: {regs} of 2 launches "
                                     "on the register-resident kernel")
            check(all(torch.equal(g, a) for g, a in zip(gb, ab)),
                  f"{name} {shape}: two runs differ")
            err, rel = rel_err(gb, ref_fn(*args))
            check(rel <= 1.5e-5, f"{name} {shape}: error {rel:.3e} of "
                                 "max|ref| > 1.5e-5")
            if name == "colfft_scaled":
                b3s_err = max(b3s_err, err)
            else:
                dft_err["B3"] = max(dft_err["B3"], err)
            line += f" {name} {rel:.3e}"
        print(line + " of max|ref| (<= 1.5e-5), two runs bit-equal")
        del xb, wb, gb, ab
    torch.cuda.empty_cache()

    # B7: bit-exact against two index_select gathers
    for shape in ((32, 512, 512), (64, 512, 512), (4, 384, 384)):
        z = planes(shape)
        got = mirror_pp(*z)
        ref = mirror_pp_ref(*z)
        torch.cuda.synchronize()
        check(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]),
              f"B7 mirror_pp {shape}: not bit-exact")
    print("[2] B7 mirror_pp (32, 512, 512), (64, 512, 512), (4, 384, 384): "
          "bit-exact")
    results["mirror_pp"] = kernel_entry(
        "mirror_pp", "mirror.cu", "pallas_fft.py:1078", 0.0)
    del z, got, ref
    torch.cuda.empty_cache()

    # the generic QE's filter algebra (csrc/qe_conv.cu) at the
    # lensqe512.recon cell's shape, (64, 512, 512) complex64: the three
    # legs of one k-map, S_y and S_x from them, the post of two spectra;
    # against the plain versions on the same inputs
    k64 = torch.complex(*(torch.randn((64, 512, 512), generator=gen,
                                      device=dev) for _ in range(2)))
    planes3 = torch.randn((3, 512, 512), generator=gen, device=dev)
    legs3 = qc.qe_leg(k64, planes3)
    post2 = torch.randn((2, 512, 512), generator=gen, device=dev)
    pairs2 = ((0, 2.0, 1, 0), (1, 2.0, 2, 0))
    for name, fn, ref_fn, args in (
            ("qe_leg", qc.qe_leg, qc.qe_leg_ref, (k64, planes3)),
            ("qe_pair", qc.qe_pair, qc.qe_pair_ref, (legs3, pairs2, None)),
            ("qe_post", qc.qe_post, qc.qe_post_ref,
             (legs3[0], legs3[1], post2))):
        before = fn.launches
        got = fn(*args)
        again = fn(*args)
        ref = ref_fn(*args)
        torch.cuda.synchronize()
        check(fn.launches == before + 2, f"{name}: {fn.launches - before} "
                                         "launches for two calls")
        got, again, ref = (t if isinstance(t, tuple) else (t,)
                           for t in (got, again, ref))
        err, rel = rel_err(got, ref)
        check(rel <= QE_CONV_TOL, f"{name}: error {rel:.3e} of max|ref| > "
                                  f"{QE_CONV_TOL}")
        check(all(torch.equal(g, a) for g, a in zip(got, again)),
              f"{name}: two runs differ")
        del got, again, ref
        print(f"[2] {name} (64, 512, 512) complex64: max abs err {err:.3e} "
              f"= {rel:.3e} of max|ref| (<= {QE_CONV_TOL}), two runs "
              f"bit-equal, {fn.launches - before} launches counted")
        # no TPU kernel: XLA fuses this algebra on the TPU
        results[name] = kernel_entry(name, "qe_conv.cu", None, err)
    del k64, planes3, legs3, post2
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
    print(f"[2] B5n noise_planes (32, 512, 512) x 2: {N} values finite, "
          f"mean {mean:.3e} (5 sigma {5.0 / math.sqrt(N):.3e}), |std-1| "
          f"{abs(std - 1.0):.3e} (< 2e-3), share beyond 4 sigma {tail:.4e} vs "
          f"{p4:.4e}, corr(re, im) {corr:.3e}, reproducible")
    results["noise_planes"] = kernel_entry(
        "noise_planes", "noise.cu", "pallas_fft.py:737", abs(std - 1.0))
    del zr, zi, zr2, zi2, zr3, er, ei, e
    torch.cuda.empty_cache()

    # FastCl's kernels at bench config 1's shapes: 2048^2 at 0.5', edges
    # arange(80, 8000, 80) (nseg 100), 96 packed pairs
    geom1, ells_th, cltt, edges1 = config1(th)
    fc1 = FastCl(geom1, ells_th, cltt, bin_edges=edges1, device=dev)
    P1, P2, n1 = 96, 64, 2048

    # B1 at the half plane's (96, 2097152) over FastCl's ids: the full
    # digitized table (nseg 100) and the kept one FastCl bins with (edge
    # segments -1, drop_edge_segments), and over dl = 20 edges out to
    # l = 8000 (nseg 400, two segment tiles)
    perm1, _ = dft.row_perm(n1)
    ml_half = geom1.modlmap_np()[perm1][:, perm1][dft.half_rows(n1)[0]]
    ids400 = torch.as_tensor(np.digitize(
        ml_half.ravel(), np.arange(20, 8000, 20.0), right=True)
        .astype(np.int32), device=dev)
    full_np = np.digitize(ml_half.ravel(), edges1, right=True) \
        .astype(np.int32)
    del ml_half
    ids_full = torch.as_tensor(full_np, device=dev)
    ids_kept = fc1._idc
    check(torch.equal(ids_kept.cpu(), torch.as_tensor(
        drop_edge_segments(full_np, fc1._nsg))),
        "FastCl's ids are not its digitized table with the edge segments "
        "dropped")
    del full_np
    kept_share = (ids_kept >= 0).double().mean().item()
    data = torch.randn((P1, n1 * n1 // 2), generator=gen, device=dev) ** 2 \
        - 0.5
    data2 = torch.randn((P1, n1 * n1 // 2), generator=gen, device=dev) ** 2 \
        - 0.5
    print(f"[2] FastCl's half-plane ids: {kept_share:.4f} of the elements "
          "kept")
    b2_cases = (("full ids", ids_full, fc1._nsg),
                ("kept ids", ids_kept, fc1._nsg))
    for tag, ids, nseg in b2_cases + (("nseg 400", ids400, 400),):
        out = bin_reduce(data, ids, nseg)
        again = bin_reduce(data, ids, nseg)
        ref = bin_reduce_ref(data, ids, nseg)
        absref = bin_reduce_ref(data.abs(), ids, nseg)
        torch.cuda.synchronize()
        err = (out - ref).abs()
        rel = (err / absref.clamp_min(1e-30)).max().item()
        check(rel <= 1e-6, f"B1 {tag}: error {rel:.3e} of binned |data| > "
                           "1e-6")
        check(torch.equal(out, again), f"B1 {tag}: two runs differ")
        b1_err = max(b1_err, err.max().item())
        print(f"[2] B1 bin_reduce ({P1}, {n1 * n1 // 2}) {tag} nseg={nseg}: "
              f"max rel err {rel:.3e} of binned |data|, reproducible")
    results["bin_reduce"]["max_abs_err"] = b1_err

    # B1 at bench config 5's profile binning: 10^4 stamps of 64^2 at 0.5'
    # over the ids of Bin2D(modrmap, arange(0, 10, 1)'), nseg 11. Bin2D
    # passes every pixel an id; those beyond 9' go to the last segment,
    # which Bin2D cuts off after the sum
    g5 = Geometry(64, 64, 0.5 * arcmin, 0.5 * arcmin)
    pbin5 = Bin2D(g5.modrmap_np(), np.arange(0.0, 10.0, 1.0) * arcmin,
                  device=dev)
    ids5, nseg5 = pbin5._ids, pbin5._nseg
    beyond5 = (ids5 == nseg5 - 1).double().mean().item()
    data5 = torch.randn((10_000, ids5.numel()), generator=gen, device=dev)
    out = bin_reduce(data5, ids5, nseg5)
    again = bin_reduce(data5, ids5, nseg5)
    ref = bin_reduce_ref(data5, ids5, nseg5)
    absref = bin_reduce_ref(data5.abs(), ids5, nseg5)
    torch.cuda.synchronize()
    err = (out - ref).abs()
    rel = (err / absref.clamp_min(1e-30)).max().item()
    check(rel <= 1e-6, f"B1 config 5: error {rel:.3e} of binned |data| > "
                       "1e-6")
    check(torch.equal(out, again), "B1 config 5: two runs differ")
    print(f"[2] B1 bin_reduce config 5 (10000, 4096) nseg={nseg5}: "
          f"{beyond5:.4f} of the pixels lie beyond 9' (the last segment, "
          f"summed and cut off); max rel err {rel:.3e} of binned |data|, "
          f"reproducible")
    results["bin_reduce_config5"] = kernel_entry(
        "bin_reduce_config5", "bin_reduce.cu", "pallas_kernels.py:94",
        err.max().item())
    del data5, out, again, ref, absref, err
    torch.cuda.empty_cache()

    # B1's float64 instance at the galaxy-catalog path's shape (phase 18):
    # one Bin2D of 8 mocks' three float64 power planes at 2048^2 0.5',
    # edges 200..3000 by 200 (nseg 16). Held to the float64 plain version
    # at 1e-12 of the binned |data|
    g18b = rect_geometry(width_arcmin=2048 * 0.5, px_res_arcmin=0.5)
    b64 = Bin2D(g18b.modlmap_np(), CAT_EDGES, device=dev)
    ids64, nseg64 = b64._ids, b64._nseg
    data64 = torch.rand((24, ids64.numel()), generator=gen, device=dev,
                        dtype=torch.float64) - 0.25
    out = bin_reduce(data64, ids64, nseg64)
    again = bin_reduce(data64, ids64, nseg64)
    ref = bin_reduce_ref(data64, ids64, nseg64)
    absref = bin_reduce_ref(data64.abs(), ids64, nseg64)
    torch.cuda.synchronize()
    check(out.dtype == torch.float64, f"B1 float64: output {out.dtype}")
    err = (out - ref).abs()
    rel = (err / absref.clamp_min(1e-300)).max().item()
    check(rel <= 1e-12, f"B1 float64: error {rel:.3e} of binned |data| > "
                        "1e-12")
    check(torch.equal(out, again), "B1 float64: two runs differ")
    print(f"[2] B1 bin_reduce float64 (24, {ids64.numel()}) nseg={nseg64}: "
          f"max rel err {rel:.3e} of binned |data| (<= 1e-12), reproducible")
    results["bin_reduce_f64"] = kernel_entry(
        "bin_reduce_f64", "bin_reduce.cu", "pallas_kernels.py:94",
        err.max().item())
    del data64, out, again, ref, absref, err, b64, ids64
    torch.cuda.empty_cache()

    # B2: the two half-plane fields of 96 pairs over FastCl's kept ids (its
    # call since the edge segments are dropped; the record) and over the
    # full ids
    b2_err = 0.0
    for tag, ids, nseg in b2_cases:
        out = bin2_reduce(data, data2, ids, nseg)
        again = bin2_reduce(data, data2, ids, nseg)
        ref = bin2_reduce_ref(data, data2, ids, nseg)
        for k, (o, a, r, x) in enumerate(zip(out, again, ref, (data, data2))):
            absref = bin_reduce_ref(x.abs(), ids, nseg)
            err = (o - r).abs()
            rel = (err / absref.clamp_min(1e-30)).max().item()
            check(rel <= 1e-6, f"B2 {tag} output {k}: error {rel:.3e} of "
                               "binned |data| > 1e-6")
            check(torch.equal(o, a), f"B2 {tag} output {k}: two runs differ")
            b2_err = max(b2_err, err.max().item())
        print(f"[2] B2 bin2_reduce ({P1}, {n1 * n1 // 2}) x 2 {tag} "
              f"nseg={nseg}: each output within 1e-6 of binned |data| (max "
              f"abs err {b2_err:.3e}), reproducible")
    results["bin2_reduce"] = kernel_entry(
        "bin2_reduce", "bin_reduce.cu", "pallas_kernels.py:163", b2_err)
    del data, data2, out, again, ref, absref, err, ids, ids400, o, a, r, x
    del ids_full
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
    results["rowfft_blk0"] = kernel_entry(
        "rowfft_blk0", "rowpower.cu", "pallas_fft.py:1301", blk_err)
    # B4 at the same shape: rowfft (phase 13's fft2pp), rowifft and
    # rowifft_scaled_y (an (n, n) scale from B4's generator), held to the
    # plain versions at 1.5e-5 of max|ref| with two runs bit-equal on the
    # register-resident row kernel
    w96 = torch.rand((n1, n1), generator=gen4, device=dev) + 0.5
    tag = f"({P1}, {n1}, {n1})"
    for fn, ref_fn, args in (
            (dft.rowfft, dft.rowfft_ref, y),
            (dft.rowifft, dft.rowifft_ref, y),
            (dft.rowifft_scaled_y, dft.rowifft_scaled_y_ref, y + (w96,))):
        got = row_route("B4", fn, args, n1, tag)
        err, rel = rel_err(got, ref_fn(*args))
        check(rel <= 1.5e-5, f"B4 {fn.__name__} {tag}: error {rel:.3e} of "
                             "max|ref| > 1.5e-5")
        dft_err["B4"] = max(dft_err["B4"], err)
        del got
        torch.cuda.empty_cache()
        print(f"[2] B4 {fn.__name__} {tag}: max abs err {err:.3e} = "
              f"{rel:.3e} of max|ref| (<= 1.5e-5), two runs bit-equal on "
              f"the register-resident row kernel")
    del w96
    results["rowfft"] = kernel_entry(
        "rowfft", "rowfft.cu", "pallas_fft.py:791", dft_err["B4"])
    # B3 at the same shape: colfft (FastCl's map analysis, phase 13's fused
    # analysis) and colifft (the config-1 step body), held to the plain
    # versions at 1.5e-5 of max|ref| with two runs bit-equal on the
    # register-resident kernel, at config 1's 96 planes and at config 2's 64
    # (its cross spectra's colifft)
    for name, fn, ref_fn in (("colfft", dft.colfft, dft.colfft_ref),
                             ("colifft", dft.colifft, dft.colifft_ref)):
        for planes_n in (P1, P2):
            yy = tuple(t[:planes_n] for t in y)
            tag = f"({planes_n}, {n1}, {n1})"
            before = klib.colfft_regs_launches()
            got = fn(*yy)
            again = fn(*yy)
            torch.cuda.synchronize()
            regs = klib.colfft_regs_launches() - before
            check(regs == 2, f"B3 {name} {tag}: {regs} of 2 launches on the "
                             "register-resident kernel")
            check(all(torch.equal(g, a) for g, a in zip(got, again)),
                  f"B3 {name} {tag}: two runs differ")
            del again
            err, rel = rel_err(got, ref_fn(*yy))
            check(rel <= 1.5e-5, f"B3 {name} {tag}: error {rel:.3e} of "
                                 "max|ref| > 1.5e-5")
            dft_err["B3"] = max(dft_err["B3"], err)
            print(f"[2] B3 {name} {tag}: max abs err {err:.3e} = {rel:.3e} "
                  "of max|ref| (<= 1.5e-5), two runs bit-equal, both on the "
                  "register-resident kernel")
            del got, yy
        torch.cuda.empty_cache()
    results["colfft"] = kernel_entry(
        "colfft", "colfft.cu", "pallas_fft.py:288", dft_err["B3"])
    # B6: the fields and Z's rows [0, 128) from one launch (no B4, no B4b,
    # no strip patch); n = 2048 takes the register-resident kernel, n = 384
    # (Bk = 3) the one on the radix-2 core; two runs bit-equal
    qc_err = 0.0
    for yy, tag in ((y, f"({P1}, {n1}, {n1})"), (planes((4, 384, 384)),
                                                 "(4, 384, 384)")):
        before = (rowqc_half.launches, dft.rowfft.launches,
                  dft.rowfft_blk0.launches)
        got = rowqc_pp(*yy)
        check((rowqc_half.launches, dft.rowfft.launches,
               dft.rowfft_blk0.launches) == (before[0] + 1,) + before[1:],
              f"B6 rowqc_pp {tag}: not one B6 launch and nothing else")
        again = rowqc_pp(*yy)
        check(all(torch.equal(g, a) for g, a in zip(got, again)),
              f"B6 rowqc_pp {tag}: two runs differ")
        del again
        ref = rowqc_pp_ref(*yy)
        torch.cuda.synchronize()
        line = f"[2] B6 rowqc_pp {tag}: reproducible;"
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
    results["rowqc_half"] = kernel_entry(
        "rowqc_half", "rowpower.cu", "pallas_fft.py:1344", qc_err)

    # B6h (qc_pp_half) and B6h' (s_pp_half) on the stored Z = rowfft(Y): 96
    # pairs at 2048^2 (config 1's) and 64 (config 2's), and n = 384. Each
    # against its plain version (the same float32 products, which the
    # compiler contracts to fused multiply-adds: 1e-6 of max|ref|), two
    # runs bit-equal, and against B6 / B6s, which transform Y's rows
    # themselves, on the same Y (1e-6 of max; the share of bit-equal
    # values is printed)
    y384 = planes((4, 384, 384))
    half_err = {"qc_pp_half": 0.0, "s_pp_half": 0.0}
    z1 = dft.rowfft(*y)
    for z, yy in ((z1, y), (dft.rowfft(*y384), y384)):
        for name, fn, ref_fn, fused_fn, nb_ in (
                ("qc_pp_half", qc_pp_half, qc_pp_half_ref, rowqc_half,
                 yy[0].shape[0]),
                ("s_pp_half", lambda a, b: (s_pp_half(a, b),),
                 lambda a, b: (s_pp_half_ref(a, b),),
                 lambda a, b: (rows_half(a, b),), min(yy[0].shape[0], P2))):
            zz = tuple(a[:nb_] for a in z)
            tag = f"({nb_}, {zz[0].shape[1]}, {zz[0].shape[2]})"
            got = fn(*zz)
            again = fn(*zz)
            ref = ref_fn(*zz)
            torch.cuda.synchronize()
            err, rel = rel_err(got, ref)
            check(rel <= 1e-6, f"{name} {tag}: error {rel:.3e} of max|ref| "
                               "> 1e-6")
            check(all(torch.equal(g, a) for g, a in zip(got, again)),
                  f"{name} {tag}: two runs differ")
            check(all(tuple(g.shape) == (nb_, zz[0].shape[1] // 2,
                                         zz[0].shape[2]) for g in got),
                  f"{name} {tag}: output shape")
            del again, ref
            fused = fused_fn(*(a[:nb_] for a in yy))
            torch.cuda.synchronize()
            _, frel = rel_err(got, fused)
            same = min((g == f).float().mean().item()
                       for g, f in zip(got, fused))
            check(frel <= 1e-6, f"{name} {tag} vs the fused kernel: "
                                f"{frel:.3e} of max > 1e-6")
            half_err[name] = max(half_err[name], err)
            print(f"[2] {name} {tag}: max abs err {err:.3e} = {rel:.3e} of "
                  f"max|ref| (<= 1e-6), reproducible; vs the fused row pass "
                  f"on the same Y {frel:.3e} of max (<= 1e-6), {same:.6f} "
                  "of the values bit-equal")
            del fused, got, zz
    del z, y384
    results["qc_pp_half"] = kernel_entry(
        "qc_pp_half", "rowpower.cu", "pallas_fft.py:1006",
        half_err["qc_pp_half"])
    results["s_pp_half"] = kernel_entry(
        "s_pp_half", "rowpower.cu", "pallas_fft.py:934",
        half_err["s_pp_half"])
    del y
    torch.cuda.empty_cache()

    # B2' (bin_pair_power) on Z and its mirror: 96 pairs at 2048^2 over
    # config 1's full-plane ids (nseg 100; phase 13's call, the record) and
    # over the same ids with the edge segments dropped, and 32 pairs at
    # 512^2 over config 3's permuted_bin_tables ids; sym False and True.
    # bin(q) within 1e-6 of itself, bin(c), which cancels, within 1e-6 of
    # bin(|c|); two runs bit-equal
    full_np = np.digitize(geom1.modlmap_np()[perm1][:, perm1].ravel(),
                          edges1, right=True).astype(np.int32)
    ids_full1 = torch.as_tensor(full_np, device=dev)
    ids_kept1 = torch.as_tensor(drop_edge_segments(full_np, len(edges1) + 1),
                                device=dev)
    del full_np
    perm3, _ = dft.row_perm(512)
    ids3, _, nseg3 = dft.permuted_bin_tables(geom.modlmap_np(), perm3, EDGES3,
                                             device=dev)
    z3 = planes((32, 512, 512))
    pp_err = 0.0
    for zz, ids, nseg, what in (
            (z3, ids3, nseg3, ""),
            (z1, ids_full1, len(edges1) + 1, " full ids"),
            (z1, ids_kept1, len(edges1) + 1, " kept ids")):
        B = zz[0].shape[0]
        four = tuple(a.reshape(B, -1)
                     for a in tuple(zz) + tuple(mirror_pp(*zz)))
        tag = f"({B}, {four[0].shape[1]}) nseg={nseg}{what}"
        absc = bin_reduce_ref((four[0] * four[2] - four[1] * four[3]).abs(),
                              ids, nseg)
        for sym in (False, True):
            got = bin_pair_power(*four, ids, nseg, sym=sym)
            again = bin_pair_power(*four, ids, nseg, sym=sym)
            ref = bin_pair_power_ref(*four, ids, nseg, sym)
            torch.cuda.synchronize()
            rel_q = ((got[0] - ref[0]).abs()
                     / ref[0].clamp_min(1e-30)).max().item()
            rel_c = ((got[1] - ref[1]).abs()
                     / absc.clamp_min(1e-30)).max().item()
            check(rel_q <= 1e-6 and rel_c <= 1e-6,
                  f"B2' {tag} sym={sym}: bin(q) {rel_q:.3e}, bin(c) "
                  f"{rel_c:.3e} of binned |field| > 1e-6")
            check(torch.equal(got[0], again[0])
                  and torch.equal(got[1], again[1]),
                  f"B2' {tag} sym={sym}: two runs differ")
            pp_err = max(pp_err, rel_err(got, ref)[0])
            print(f"[2] B2' bin_pair_power {tag} sym={sym}: bin(q) "
                  f"{rel_q:.3e}, bin(c) {rel_c:.3e} of binned |field| "
                  "(<= 1e-6), reproducible")
            del got, again, ref
        del four, absc
    results["bin_pair_power"] = kernel_entry(
        "bin_pair_power", "bin_reduce.cu", "pallas_kernels.py:262", pp_err)
    del z1, z3, zz, ids_full1, ids_kept1, ids3
    torch.cuda.empty_cache()

    # B5: the config-1 covsqrt scale, 96 pairs; B5n's stream through B4's
    # inverse on the same words, the law under a unit scale, the seeds
    sc1 = fc1._covsqrt_pp
    w = torch.tensor([20260512, -77], dtype=torch.int32, device=dev)
    got = row_route("B5", dft.rowifft_noise_y, (sc1, w, P1), n1,
                    f"({P1}, {n1}, {n1})")
    ref = dft.rowifft(*noise_planes(sc1, w, P1))
    torch.cuda.synchronize()
    b5_err, rel = rel_err(got, ref)
    exact = torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    check(rel <= 1.5e-5, f"B5 vs rowifft(noise_planes): error {rel:.3e} of "
                         "max|ref| > 1.5e-5")
    check(exact, "B5 and rowifft(noise_planes) on the same words differ: "
                 "the two kernels no longer draw one stream")
    del ref
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
    print(f"[2] B5 rowifft_noise_y ({P1}, {n1}, {n1}) x 2: vs "
          f"rowifft(noise_planes) on the same words {rel:.3e} of max|ref| "
          f"(<= 1.5e-5; bit-equal: {exact}); two runs bit-equal on the "
          f"register-resident row kernel; unit scale: n var(Y') "
          f"{var_r:.6f} (re), {var_i:.6f} (im) (within 2e-3 of 1), "
          f"n E[re im] {corr:.3e}")
    results["rowifft_noise_y"] = kernel_entry(
        "rowifft_noise_y", "rowfft.cu", "pallas_fft.py:658", b5_err)
    del fc1, sc1
    torch.cuda.empty_cache()

    # B3s and B6s at bench config 2's shapes: 64 packed pairs at 2048^2,
    # the 12 % taper on the column pass's load (two runs bit-equal on the
    # register-resident kernel); and at n = 384 (the radix-2 one)
    taper1, _ = get_taper(geom1, taper_percent=12.0, device=dev)
    x = planes((P2, n1, n1))
    x384 = planes((4, 384, 384))
    t384 = torch.rand((384, 384), generator=gen, device=dev)
    for xx, tt, tag, regs_want in ((x, taper1, f"({P2}, {n1}, {n1})", 2),
                                   (x384, t384, "(4, 384, 384)", 0)):
        before = klib.colfft_regs_launches()
        got = dft.colfft_scaled(*xx, tt)
        again = dft.colfft_scaled(*xx, tt)
        torch.cuda.synchronize()
        regs = klib.colfft_regs_launches() - before
        check(regs == regs_want, f"B3s colfft_scaled {tag}: {regs} of 2 "
                                 "launches on the register-resident kernel")
        check(all(torch.equal(g, a) for g, a in zip(got, again)),
              f"B3s colfft_scaled {tag}: two runs differ")
        err, rel = rel_err(got, dft.colfft_scaled_ref(*xx, tt))
        check(rel <= 1.5e-5, f"B3s colfft_scaled {tag}: error {rel:.3e} of "
                             "max|ref| > 1.5e-5")
        b3s_err = max(b3s_err, err)
        print(f"[2] B3s colfft_scaled {tag}: max abs err {err:.3e} = "
              f"{rel:.3e} of max|ref| (<= 1.5e-5), two runs bit-equal")
        del got, again
    results["colfft_scaled"] = kernel_entry(
        "colfft_scaled", "colfft.cu", "pallas_fft.py:325", b3s_err)
    s_err = 0.0
    for yy, tag in ((x, f"({P2}, {n1}, {n1})"), (x384, "(4, 384, 384)")):
        before = (rows_half.launches, dft.rowfft.launches,
                  dft.rowfft_blk0.launches)
        got = rows_pp(*yy)
        check((rows_half.launches, dft.rowfft.launches,
               dft.rowfft_blk0.launches) == (before[0] + 1,) + before[1:],
              f"B6s rows_pp {tag}: not one B6s launch and nothing else")
        again = rows_pp(*yy)
        check(all(torch.equal(g, a) for g, a in zip(got, again)),
              f"B6s rows_pp {tag}: two runs differ")
        del again
        ref = rows_pp_ref(*yy)
        torch.cuda.synchronize()
        line = f"[2] B6s rows_pp {tag}: reproducible;"
        for name, g, r, tol in zip(("s", "zrow_r", "zrow_i"), got, ref,
                                   (3e-5, 1.5e-5, 1.5e-5)):
            check(g.shape == r.shape, f"B6s {name} {tag}: shape "
                                      f"{tuple(g.shape)}")
            err, rel = rel_err((g,), (r,))
            check(rel <= tol, f"B6s {name} {tag}: error {rel:.3e} of "
                              f"max|ref| > {tol}")
            if name == "s":
                s_err = max(s_err, err)
            line += f" {name} {rel:.3e} (<= {tol})"
        print(line + " of max|ref|")
        del got, ref, g, r
    del yy
    torch.cuda.empty_cache()
    results["rows_half"] = kernel_entry(
        "rows_half", "rowpower.cu", "pallas_fft.py:1456", s_err)
    del x, x384, taper1, t384
    torch.cuda.empty_cache()

    # B9 at bench config 4's shape: 32 coadds of 3 band pairs at 512^2
    # (96 pairs), on the register-resident kernel, and at n = 384 (nq 3,
    # two coadds) on the radix-2 one; 1e-5 of max|ref| (tests/test_core.py's
    # bound for the JAX kernel), two runs bit-equal
    b9_err = 0.0
    for npt, nq, n9 in ((96, 3, 512), (6, 3, 384)):
        y9 = planes((npt, n9, n9))
        w9 = tuple(torch.randn((nq, n9, n9), generator=gen, device=dev)
                   for _ in range(4))
        before = klib.rowcombine_regs_launches()
        got = rowcombine_pp(*y9, *w9, nq)
        again = rowcombine_pp(*y9, *w9, nq)
        torch.cuda.synchronize()
        regs = klib.rowcombine_regs_launches() - before
        want = 2 if n9 == 512 else 0
        check(regs == want, f"B9 ({npt}, {n9}, {n9}): {regs} of 2 launches "
                            f"on the register-resident kernel, not {want}")
        check(all(torch.equal(g, a) for g, a in zip(got, again)),
              f"B9 ({npt}, {n9}, {n9}): two runs differ")
        err, rel = rel_err(got, rowcombine_pp_ref(*y9, *w9, nq))
        check(rel <= 1e-5, f"B9 rowcombine_pp ({npt}, {n9}, {n9}) nq {nq}: "
                           f"error {rel:.3e} of max|ref| > 1e-5")
        b9_err = max(b9_err, err)
        print(f"[2] B9 rowcombine_pp ({npt}, {n9}, {n9}) nq {nq}, "
              f"{npt // nq} coadds: max abs err {err:.3e} = {rel:.3e} of "
              f"max|ref| (<= 1e-5); two runs bit-equal on the "
              + ("register-resident" if regs else "radix-2") + " kernel")
        del got, again
    results["rowcombine_pp"] = kernel_entry(
        "rowcombine_pp", "rowcombine.cu", "pallas_fft.py:1603", b9_err)
    del y9, w9
    torch.cuda.empty_cache()
    # B10a/B10s against their plain fp64 loops (no captured seeds, no group
    # bounds) at the path's shapes: config 8's (lmax 1023, 8 maps, folded),
    # config 8p's (lmax 1023, the spin-2 columns n = -2 and +2 on the
    # northern rings, 16 maps in one launch) and config 7's (lmax 2047, one
    # map, folded), dd and fast; fast also against its own plain version,
    # the kernels' float32 recurrence emulated in torch (legendre_*_ref with
    # fast=True)
    b10_err = {}
    b10_gen = torch.Generator(device=dev).manual_seed(10)
    for lmax, nm, ns, layout in ((1023, 8, (0,), "fold"),
                                 (1023, 16, (-2, 2), "half"),
                                 (2047, 1, (0,), "fold")):
        rings = sht.gauss_legendre_rings(lmax)
        M1 = lmax + 1
        for ni in range(len(ns)):
            shape = f"lmax {lmax} x{nm} {layout} n={ns[ni]}"
            tab = leg.tables(lmax, rings, ns, ni, layout, dev)
            ktab = leg.kernel_tables(tab)
            dead = int((ktab["bounds"][M1:2 * M1] == 0).sum().item())
            print(f"[2] B10 tables {shape}: {ktab['Tk']} kernel rings, {dead} "
                  "dead (m, 32-ring group) pairs")
            G = torch.complex(*(torch.randn((nm, tab["Tr"], M1),
                                            generator=b10_gen, device=dev)
                                for _ in range(2)))
            a = torch.complex(*(torch.randn((nm, M1, M1), generator=b10_gen,
                                            device=dev) for _ in range(2)))
            for name, fn, ref_fn, x in (
                    ("legendre_ana", leg.legendre_ana, leg.legendre_ana_ref,
                     G),
                    ("legendre_syn", leg.legendre_syn, leg.legendre_syn_ref,
                     a)):
                ref = ref_fn(x, tab)
                for mode in ("dd", "fast"):
                    fast = mode == "fast"
                    got = fn(x, tab, fast)
                    again = fn(x, tab, fast)
                    one = fn(x[-1:], tab, fast)
                    torch.cuda.synchronize()
                    err, rel = rel_err((got,), (ref,))
                    tol = B10_FAST_TOL[lmax] if fast else 1e-6
                    check(rel <= tol, f"{name} {shape} {mode}: error "
                                      f"{rel:.3e} of max|ref| > {tol}")
                    check(torch.equal(got, again),
                          f"{name} {shape} {mode}: two runs differ")
                    check(torch.equal(one[0], got[-1]),
                          f"{name} {shape} {mode}: a map alone differs from "
                          "the packed launch")
                    own = ""
                    if fast:
                        _, rel32 = rel_err((got,), (ref_fn(x, tab, True),))
                        check(rel32 <= B10_FAST_PLAIN_TOL,
                              f"{name} {shape} fast: {rel32:.3e} of the fp32 "
                              f"plain version > {B10_FAST_PLAIN_TOL}")
                        own = (f"; {rel32:.3e} of its fp32 plain version "
                               f"(<= {B10_FAST_PLAIN_TOL})")
                    print(f"[2] {name} {shape} {mode}: max abs err "
                          f"{err:.3e} = {rel:.3e} of max|ref| (<= {tol})"
                          f"{own}, reproducible, a map alone = packed")
                    b10_err[(name, lmax, ns[ni], mode)] = err
            del G, a, got, again, one, ref
    # the fast gate over seeds, at config 8's shape: the fast kernel and its
    # fp32 plain version against the fp64 loop, and against each other
    tab = leg.tables(1023, sht.gauss_legendre_rings(1023), (0,), 0, "fold",
                     dev)
    worst = {}
    ftol = B10_FAST_TOL[1023]
    for seed in range(B10_FAST_SEEDS):
        gs = torch.Generator(device=dev).manual_seed(100 + seed)
        G = torch.complex(*(torch.randn((8, tab["Tr"], 1024), generator=gs,
                                        device=dev) for _ in range(2)))
        a = torch.complex(*(torch.randn((8, 1024, 1024), generator=gs,
                                        device=dev) for _ in range(2)))
        for name, fn, ref_fn, x in (
                ("legendre_ana", leg.legendre_ana, leg.legendre_ana_ref, G),
                ("legendre_syn", leg.legendre_syn, leg.legendre_syn_ref, a)):
            ref = ref_fn(x, tab)
            plain32 = ref_fn(x, tab, True)
            got = fn(x, tab, True)
            _, rk = rel_err((got,), (ref,))
            _, rp = rel_err((plain32,), (ref,))
            _, rkp = rel_err((got,), (plain32,))
            print(f"[2] B10 fast gate, seed {100 + seed}: {name} kernel "
                  f"{rk:.4e}, fp32 plain version {rp:.4e} of the fp64 loop's "
                  f"max; kernel vs fp32 plain version {rkp:.4e}")
            w = worst.setdefault(name, [0.0, 0.0, 0.0])
            for k, v in enumerate((rk, rp, rkp)):
                w[k] = max(w[k], v)
        del G, a, ref, plain32, got
    for name, (rk, rp, rkp) in worst.items():
        print(f"[2] B10 fast gate, worst of {B10_FAST_SEEDS} seeds: {name} "
              f"kernel {rk:.4e}, fp32 plain version {rp:.4e} (limit "
              f"{ftol}); kernel vs fp32 plain version {rkp:.4e} "
              f"(limit {B10_FAST_PLAIN_TOL})")
        check(rk <= ftol and rkp <= B10_FAST_PLAIN_TOL,
              f"{name} fast over {B10_FAST_SEEDS} seeds: {rk:.3e} (<= "
              f"{ftol}), {rkp:.3e} (<= {B10_FAST_PLAIN_TOL})")
    # phases 9-11 build their own tables: these would count in the peak
    # memory of phases 3-8
    del tab, ktab
    leg.clear_tables()
    torch.cuda.empty_cache()
    # each record's error at config 7's shape
    for name, sites in (("legendre_ana", "pallas_sht.py:1216,1230,1310,1325"),
                        ("legendre_syn",
                         "pallas_sht.py:1260,1273,1364,1379")):
        results[name] = kernel_entry(name, "legendre.cu", sites,
                                     b10_err[(name, 2047, 0, "dd")])


def flagship_phase(dev, results, launches):
    """Phase 3: the flagship step, its launches from 0."""
    launches.reset()
    fn, fargs = entry(device=dev)
    t0 = time.perf_counter()
    for _ in range(3):
        out = fn(*fargs)
        torch.cuda.synchronize()
        check(tuple(out.shape) == (3, 15), f"flagship shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), "flagship output not finite")
    print(f"[3] flagship entry() 512^2 2': 3 steps finite (3, 15) in "
          f"{time.perf_counter() - t0:.3f} s; cross[:4] "
          f"{out[0, :4].tolist()}")
    counts3 = launches.read(("bin_reduce", "qe_leg", "qe_pair", "qe_post"),
                          "3")
    # the generic TT estimator of one k-map: one launch of each of the
    # QE's kernels a step (its three distinct legs in one wave)
    for name in ("qe_leg", "qe_pair", "qe_post"):
        check(counts3[name] == 3, f"3: {counts3[name]} {name} launches in "
                                  "3 steps")
        results[name]["launches"] = counts3[name]


def half_plane_phase(dev, card, launches, gen, geom, th):
    """Phase 4: the half-plane lensing pipeline (impl="xla") at bench config
    6's settings, batch 64."""
    launches.reset()
    pipe = LensedQEPipeline(geom, th, beam_arcmin=1.4, noise_uk_arcmin=6.0,
                            lens_order=5, device=dev, impl="xla")
    check(pipe.impl == "xla", "impl='xla' did not select the half-plane path")
    batch = 64
    throughput(lambda: pipe.step(batch, gen), batch, 5,
               f"pipeline impl={pipe.impl} 512^2 2' beam 1.4' 6 uK' order 5 "
               f"batch {batch}", "sims/s", card, "4")
    ratio_gate(pipe, batch, gen, "4")
    launches.read(("bin_reduce", "lens_map_kernel"), "4")
    launches.read_wide("4", True)
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
    del pipe, p_gpu, p_cpu
    torch.cuda.empty_cache()


def full_plane_phase(dev, results, launches, gen, geom, th):
    """Phase 5: the full-plane lensing pipeline, what impl="auto" runs at
    512^2, batch 64 (the cell lensqe512.sim times it)."""
    launches.reset()
    pipe = LensedQEPipeline(geom, th, beam_arcmin=1.4, noise_uk_arcmin=6.0,
                            lens_order=5, device=dev)
    check(pipe.impl == "pallas", "impl='auto' did not select the full-plane "
                                 "path at 512^2")
    ratio_gate(pipe, 64, gen, "5")
    lens_path = ("bin_reduce", "lens_map_kernel", "colfft", "rowfft",
                 "noise_planes", "mirror_pp")
    counts = launches.read(lens_path, "5")
    launches.read_wide("5", True)
    launches.check_row_route(counts, "5")
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
    del pipe, p_gpu, p_cpu, planes_cpu
    torch.cuda.empty_cache()


def fastcl_phase(dev, results, launches, th):
    """Phase 6: FastCl at bench config 1's settings: 2048^2 0.5', lensed
    TT, edges arange(80, 8000, 80), batch 192 (96 packed pairs); the
    512-sim recovery gate at 512^2; card vs CPU at 256^2."""
    launches.reset()
    geom1, ells_th, cltt, edges1 = config1(th)
    n1 = 2048
    fc = FastCl(geom1, ells_th, cltt, bin_edges=edges1, device=dev)
    nb = len(edges1) - 1
    batch6 = 192
    out = fc.sim_bandpowers(0, batch6)
    torch.cuda.synchronize()
    check(tuple(out.shape) == (batch6, nb), f"sim_bandpowers shape "
                                       f"{tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "sim_bandpowers not finite")

    def config1_step(seed):
        """bench.py config 1's step body: synthesis with the maps
        materialized, then the fused analysis of the pre-column Y'."""
        m1, m2, yr, yi = dft.ifft2pp_noise_y(fc._covsqrt_pp, seed,
                                             batch6 // 2)
        b1, b2 = fc._pair_bandpowers_y(yr, yi)
        return torch.cat([b1, b2]), m1, m2

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
    counts6 = launches.read(("bin_reduce", "bin2_reduce", "colfft",
                             "rowifft_noise_y", "rowqc_half"), "6")
    check(counts6["rowfft"] == counts6["rowfft_blk0"] == 0,
          "6: FastCl's analysis launched B4 or B4b beside B6")
    launches.check_row_route(counts6, "6")
    for name in ("bin2_reduce", "colfft", "rowifft_noise_y", "rowqc_half"):
        results[name]["launches"] = counts6[name]
    # FastCl bins with the edge segments dropped (-1 ids): its bandpowers
    # equal those from the full ids, which sum the edge segments too and
    # then cut them off, to 1e-6 relative per bin
    fc_full = with_full_ids(fc, edges1)
    kept_bp = fc.sim_bandpowers(99, batch6)
    full_bp = fc_full.sim_bandpowers(99, batch6)
    krel = ((kept_bp - full_bp).abs() / full_bp.abs()).max().item()
    check(krel <= 1e-6, f"config 1: bandpowers from the kept ids vs the full "
                        f"ids {krel:.3e} relative")
    print(f"[6] config 1's {batch6} bandpowers from the kept ids vs the full "
          f"ids: {krel:.3e} relative per bin (<= 1e-6), bit-equal: "
          f"{torch.equal(kept_bp, full_bp)}")
    del fc_full, kept_bp, full_bp
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
    f_cpu = FastCl(g256, ells_th, cltt, bin_edges=e256, device="cpu")
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
    torch.cuda.empty_cache()


def cross_spectra_phase(dev, results, launches, th):
    """Phase 7: FastCl.cross_bandpowers at bench config 2's settings:
    2048^2 0.5', lensed TT, edges arange(80, 8000, 80), batch 128 (64 pairs
    of independent sims), the 12 % taper on the analysis transform's load,
    debiased by w2, Knox errors (bench.py:239-298); card vs CPU at
    256^2."""
    launches.reset()
    geom1, ells_th, cltt, edges1 = config1(th)
    nb = len(edges1) - 1
    fc = FastCl(geom1, ells_th, cltt, bin_edges=edges1)
    check(fc.device == torch.device("cuda"), f"FastCl built with no device "
                                             f"lives on {fc.device}")
    taper, w2 = get_taper(geom1, taper_percent=12.0)
    check(taper.is_cuda, "get_taper with no device is not on the card")
    fsky = geom1.area / (4 * np.pi) * w2
    knox = torch.as_tensor(np.sqrt(2.0 / np.maximum(
        (2 * fc.centers + 1) * (edges1[1] - edges1[0]) * fsky, 1e-30)),
        dtype=torch.float32, device=dev)
    pairs7 = 128 // 2

    def config2_step(seed):
        """bench.py config 2's step: fresh sim pairs, the taper fused on
        the load, cross spectra debiased by w2, Knox errors."""
        m1, m2 = dft.ifft2pp_noise(fc._covsqrt_pp, seed, pairs7)
        bs = fc.cross_bandpowers(m1, m2, window=taper) / w2
        return bs, bs * knox

    bs, errs = config2_step(0)
    torch.cuda.synchronize()
    check(tuple(bs.shape) == tuple(errs.shape) == (pairs7, nb),
          f"config 2 output shape {tuple(bs.shape)}")
    check(bool(torch.isfinite(bs).all() and torch.isfinite(errs).all()),
          "config 2 output not finite")
    counts7 = launches.read(("bin_reduce", "colfft", "colfft_scaled",
                             "rowifft_noise_y", "rows_half"), "7")
    check(counts7["rowfft"] == counts7["rowfft_blk0"] == 0,
          "7: cross_bandpowers launched B4 or B4b beside B6s")
    print(f"[7] one step: {counts7['rows_half']} B6s, "
          f"{counts7['colfft_scaled']} B3s, {counts7['bin_reduce']} B1 "
          "launches")
    for name in ("colfft_scaled", "rows_half"):
        results[name]["launches"] = counts7[name]
    # the step's own output at its own shape (64 pairs at 2048^2):
    # card (kernels) vs a CPU FastCl (plain versions) on the same maps.
    # The cross spectrum of independent maps sums terms of scale
    # sqrt(P11 P22) that cancel to ~1/sqrt(modes) of it, so its error is
    # read against sqrt(P11 P22), the two tapered auto spectra, as the auto
    # gate below reads its own; against the bin's largest |cross| over the
    # pairs it is printed, not gated
    bs, errs = config2_step(0)
    m1, m2 = dft.ifft2pp_noise(fc._covsqrt_pp, 0, pairs7)
    fc_cpu = FastCl(geom1, ells_th, cltt, bin_edges=edges1, device="cpu")
    taper_cpu, _ = get_taper(geom1, taper_percent=12.0, device="cpu")
    bs_cpu = fc_cpu.cross_bandpowers(m1.cpu(), m2.cpu(),
                                     window=taper_cpu) / w2
    p12 = (fc.map_bandpowers(m1 * taper) * fc.map_bandpowers(m2 * taper)
           ).sqrt().cpu() / w2
    srel, xrel = 0.0, 0.0
    for got, ref, scale in ((bs, bs_cpu, p12),
                            (errs, bs_cpu * knox.cpu(), p12 * knox.cpu())):
        diff = (got.cpu() - ref).abs()
        srel = max(srel, (diff / scale).max().item())
        xrel = max(xrel, (diff.amax(0) / ref.abs().amax(0)).max().item())
    check(bool(torch.isfinite(bs).all()) and srel <= 5e-5,
          f"config-2 step, card vs CPU: {srel:.3e} of sqrt(P11 P22)")
    print(f"[7] the config-2 step's output ({pairs7} pairs at 2048^2, "
          f"bandpowers and Knox errors), card (kernels) vs CPU (plain "
          f"versions) on the same maps: {srel:.3e} of sqrt(P11 P22) per bin "
          f"(<= 5e-5); {xrel:.3e} of the bin's max |cross| over the pairs")
    del fc_cpu, taper_cpu, bs_cpu, p12
    # the same step's maps binned with the full ids (edge segments summed,
    # then cut off): 1e-6 of each bin's largest |cross| over the pairs
    fc_full = with_full_ids(fc, edges1)
    full_bs = fc_full.cross_bandpowers(m1, m2, window=taper) / w2
    kdiff = (bs - full_bs).abs().amax(0) / full_bs.abs().amax(0)
    krel = kdiff.max().item()
    check(krel <= 1e-6, f"config 2: cross spectra from the kept ids vs the "
                        f"full ids {krel:.3e} of the bin's max")
    print(f"[7] config 2's {pairs7} cross spectra from the kept ids vs the "
          f"full ids: {krel:.3e} of each bin's max |cross| (<= 1e-6), "
          f"bit-equal: {torch.equal(bs, full_bs)}")
    del fc_full, full_bs, kdiff
    # gates on the step's own maps (8 of each): cross(m, m) is the auto
    # spectrum; the fused taper equals pre-multiplied maps (a correlated
    # pair, so that no bin is near 0)
    m1, m2 = dft.ifft2pp_noise(fc._covsqrt_pp, 77, 8)
    m2 = m1 + m2
    auto = fc.map_bandpowers(m1)
    rel = ((fc.cross_bandpowers(m1, m1) - auto).abs() / auto.abs()).max()
    check(rel.item() <= 5e-5, f"cross_bandpowers(m, m) vs map_bandpowers(m):"
                              f" {rel.item():.3e} relative per bin")
    fused = fc.cross_bandpowers(m1, m2, window=taper)
    premul = fc.cross_bandpowers(m1 * taper, m2 * taper)
    frel = ((fused - premul).abs() / premul.abs()).max().item()
    check(frel <= 2e-5, f"fused taper vs pre-multiplied maps: {frel:.3e} "
                        "relative per bin")
    print(f"[7] 8 maps at 2048^2: cross_bandpowers(m, m) vs map_bandpowers(m)"
          f" {rel.item():.3e} relative per bin (<= 5e-5); fused taper vs "
          f"pre-multiplied maps {frel:.3e} (<= 2e-5)")
    del fc, m1, m2, auto, fused, premul, bs, errs
    torch.cuda.empty_cache()
    # card (kernels) vs CPU (plain versions) at 256^2, same maps, with and
    # without the taper
    g256 = rect_geometry(width_arcmin=256 * 2.0, px_res_arcmin=2.0)
    f_gpu, f_cpu = (FastCl(g256, ells_th, cltt,
                           bin_edges=np.arange(80, 4000, 160.0), device=d)
                    for d in (dev, "cpu"))
    rng = np.random.default_rng(256)
    mp = torch.as_tensor(rng.standard_normal((3, 256, 256))
                         .astype(np.float32))
    mp2 = mp + 0.5 * torch.as_tensor(rng.standard_normal((3, 256, 256))
                                     .astype(np.float32))
    t_gpu, _ = get_taper(g256, taper_percent=12.0, device=dev)
    t_cpu, _ = get_taper(g256, taper_percent=12.0, device="cpu")
    worst = 0.0
    for tg, tc in ((None, None), (t_gpu, t_cpu)):
        got = f_gpu.cross_bandpowers(mp.to(dev), mp2.to(dev),
                                     window=tg).cpu().numpy()
        ref = f_cpu.cross_bandpowers(mp, mp2, window=tc).numpy()
        rel = float(np.max(np.abs(got - ref) / np.abs(ref)))
        check(bool(np.isfinite(got).all()) and rel <= 5e-5,
              f"card vs CPU cross_bandpowers at 256^2: {rel:.3e} relative")
        worst = max(worst, rel)
    print(f"[7] 256^2 cross_bandpowers card (kernels) vs CPU (plain "
          f"versions), with and without the taper: max {worst:.3e} relative "
          "per bin (<= 5e-5)")
    del f_gpu, f_cpu


def ilc_phase(dev, card, results, launches, geom, th):
    """Phase 8: the fused ILC coadd at bench config 4's settings: 512^2 2',
    six bands 39-350 GHz, ilc_cinv with tSZ, CIB-C and kSZ, cilc_weights
    deprojecting tSZ, 32 coadds per step (bench.py:461-578)."""
    launches.reset()
    _, _, cltt, _ = config1(th)
    freqs = np.array([39.0, 93.0, 145.0, 225.0, 280.0, 350.0])
    beams = np.array([5.1, 2.2, 1.4, 1.0, 0.9, 0.8])
    noises = np.array([36.0, 8.0, 10.0, 22.0, 54.0, 100.0])
    nf = len(freqs)
    ells4 = np.arange(2, int(geom.ellmax_safe()))
    cinv1d, _ = ilc.ilc_cinv(
        ells4, np.asarray(th.lCl("TT", ells4)),
        [gauss_beam(ells4, b) for b in beams], freqs,
        (noises * arcmin) ** 2, components=("tsz", "cibc", "ksz"),
        fdict=fg.fg_dict(10.0 + 0 * freqs, freqs), device="cpu")
    cinv1d = cinv1d.numpy()

    def cinv_2d(g, device):
        """The (nf, nf, n, n) Cinv painted on ``g``'s |l| grid, in float64:
        the tSZ constraint cancels bands of opposite sign, so weights
        solved from bench.py's float32 cinv2d leave more tSZ in the coadd
        than weights solved in float64 and rounded to float32 planes. The
        phase prints the residual of both."""
        ml = g.modlmap_np()
        return torch.as_tensor(np.stack([
            [np.interp(ml, ells4, cinv1d[i, j], left=0, right=0)
             for j in range(nf)] for i in range(nf)]), device=device)

    a_cmb = np.ones(nf, np.float32)
    a_tsz = np.asarray(fg.g_tsz(freqs), np.float32)
    w2d = ilc.cilc_weights(cinv_2d(geom, dev), a_cmb, a_tsz)
    weights = ilc.coadd_weights_pp(w2d)
    perm4, _ = dft.row_perm(geom.ny)
    cs = grf.spec2flat(geom, cltt[None, None], exp=0.5,
                       device="cpu")[0, 0].numpy()
    covsqrt4 = torch.as_tensor(np.ascontiguousarray(
        cs[perm4][:, perm4] * np.sqrt(geom.npix).astype(np.float32)),
        device=dev)
    batch8 = 32
    pairs8 = batch8 * nf // 2

    def config4_step(seed):
        """bench.py config 4's step: B5 draws the bands' pre-column
        intermediates, B9 combines the bands of each coadd, B3/B4 invert
        the coadds in packed pairs."""
        yr, yi = dft.rowifft_noise_y(covsqrt4, seed, pairs8)
        return ilc.coadd_from_y(yr, yi, weights)

    out8 = config4_step(0)
    torch.cuda.synchronize()
    check(tuple(out8.shape) == (batch8, geom.ny, geom.nx)
          and bool(torch.isfinite(out8).all()), "config 4 output: shape "
          f"{tuple(out8.shape)} or not finite")
    seeds = itertools.count(1)
    throughput(lambda: config4_step(next(seeds)), batch8, 50, "config-4 step "
               "(port's ilc_6band_deproj_coadds_per_sec_512x512_fp32) 512^2 "
               f"2' {nf} bands tSZ deprojected batch {batch8}", "coadds/s",
               card, "8")
    counts8 = launches.read(("colfft", "rowfft", "rowifft_noise_y",
                             "rowcombine_pp"), "8")
    launches.check_row_route(counts8, "8")
    b9_regs = launches.lib.rowcombine_regs_launches() - launches.b9_regs
    check(b9_regs == counts8["rowcombine_pp"],
          f"8: {b9_regs} of {counts8['rowcombine_pp']} B9 launches on the "
          "register-resident kernel")
    print(f"[8] B9 launches on the register-resident kernel: {b9_regs} of "
          f"{counts8['rowcombine_pp']}")
    print(f"[8] 53 steps (1 check, 2 warm-up, 50 timed): "
          f"{counts8['rowcombine_pp'] / 53:.0f} B9, "
          f"{counts8['rowifft_noise_y'] / 53:.0f} B5, "
          f"{counts8['colfft'] / 53:.0f} B3, {counts8['rowfft'] / 53:.0f} B4 "
          "launches per step")
    results["rowcombine_pp"]["launches"] = counts8["rowcombine_pp"]
    # the timed step's own output at its own shape (32 coadds, 96 pairs at
    # 512^2): card (B5 -> B9 -> packed ifft2pp) vs the CPU's plain versions
    # on the same noise, which B5n draws as B5 does (phase 2)
    out8 = config4_step(5)
    nr, ni = noise_planes(covsqrt4, 5, pairs8)
    ref8 = ilc.coadd_from_y(*dft.rowifft(nr.cpu(), ni.cpu()),
                            [x.cpu() for x in weights])
    _, srel = rel_err((out8.cpu(),), (ref8,))
    check(bool(torch.isfinite(out8).all()) and srel <= 1e-5,
          f"config-4 step, card vs CPU: {srel:.3e} of max")
    print(f"[8] the config-4 step's output ({batch8} coadds, {pairs8} band "
          f"pairs at 512^2), card (kernels) vs CPU (plain versions) on the "
          f"same noise: {srel:.3e} of max (<= 1e-5)")
    del out8, nr, ni, ref8
    # the constraint at 512^2 on the config's weights: bands that carry
    # only a tSZ-SED map coadd to ~0; bands that carry one CMB map coadd
    # to that map, kept where the weights are defined
    tmap = torch.as_tensor(np.random.default_rng(8).standard_normal(
        (4, 1, geom.ny, geom.nx)).astype(np.float32), device=dev)
    g_t = torch.as_tensor(a_tsz, device=dev)[None, :, None, None]
    tsz_in = tmap * g_t
    tsz_out = ilc.linear_coadd_fused(tsz_in, w2d)
    tsz_rel = (tsz_out.abs().max() / tsz_in.abs().max()).item()
    check(tsz_rel <= 1e-4, f"tSZ-only bands coadd to {tsz_rel:.3e} of the "
                           "input's max")
    # the same weights solved as bench.py's config 4 does, from a float32
    # Cinv: read, not gated (cinv_2d's docstring)
    w2d_32 = ilc.cilc_weights(cinv_2d(geom, dev).to(torch.float32), a_cmb,
                              a_tsz)
    for tag, w in (("float64", w2d), ("float32", w2d_32)):
        resp = (w.to(torch.float32).double() * g_t[0].double()).sum(0)
        res = ilc.linear_coadd_fused(tsz_in, w).abs().max() / tsz_in.abs().max()
        print(f"[8] weights solved from a {tag} Cinv: max|sum_b w_b g_b| "
              f"{resp.abs().max().item():.3e}; tSZ-only bands coadd to "
              f"{res.item():.3e} of the input's max")
    del w2d_32
    cmb_out = ilc.linear_coadd_fused(tmap.expand(-1, nf, -1, -1), w2d)
    kept = (w2d.abs().sum(0) > 0).to(torch.float32)
    cmb_ref = torch.fft.ifft2(torch.fft.fft2(tmap[:, 0]) * kept).real
    cmb_err, cmb_rel = rel_err((cmb_out,), (cmb_ref,))
    check(cmb_rel <= 1e-4, f"CMB-only bands coadd: {cmb_rel:.3e} of max")
    print(f"[8] 512^2, 4 coadds on the config's weights: tSZ-only bands "
          f"{tsz_rel:.3e} of the input's max (<= 1e-4); CMB-only bands vs "
          f"the map kept where the weights are defined {cmb_rel:.3e} of max "
          "(<= 1e-4)")
    # cilc_coadd_fused vs ifft2(cilc(fft2(maps))).real on the card, and
    # card vs CPU, at 256^2 on the config's Cinv
    g256 = rect_geometry(width_arcmin=256 * 2.0, px_res_arcmin=2.0)
    maps = np.random.default_rng(44).standard_normal(
        (4, nf, 256, 256)).astype(np.float32)
    ci_gpu = cinv_2d(g256, dev)
    fused = ilc.cilc_coadd_fused(torch.as_tensor(maps, device=dev), ci_gpu,
                                 a_cmb, a_tsz)
    direct = torch.stack([torch.fft.ifft2(ilc.cilc(
        torch.fft.fft2(torch.as_tensor(m, device=dev)), ci_gpu, a_cmb,
        a_tsz)).real for m in maps])
    _, drel = rel_err((fused,), (direct,))
    check(drel <= 1e-5, f"cilc_coadd_fused vs ifft2(cilc(fft2)) at 256^2: "
                        f"{drel:.3e} of max")
    cpu = ilc.cilc_coadd_fused(torch.as_tensor(maps), cinv_2d(g256, "cpu"),
                               a_cmb, a_tsz)
    _, crel = rel_err((fused.cpu(),), (cpu,))
    check(bool(torch.isfinite(fused).all()) and crel <= 1e-5,
          f"card vs CPU cilc_coadd_fused at 256^2: {crel:.3e} of max")
    print(f"[8] 256^2, 4 coadds: cilc_coadd_fused vs ifft2(cilc(fft2(maps)))"
          f" on the card {drel:.3e} of max (<= 1e-5); card (kernels) vs CPU "
          f"(plain versions) {crel:.3e} of max (<= 1e-5)")


def sht_roundtrip_phase(dev, card, results, launches):
    """Phase 9: bench config 7's SHT roundtrips map2alm(alm2map(a)) at lmax
    2047 on Gauss-Legendre rings, one unit-variance complex64 alm
    (bench.py:659-721), in dd and in fast; the fast roundtrip also at lmax
    1023. B10a's and B10s's launches start their records' counts."""
    launches.reset()
    lmax7 = 2047
    rings7 = sht.gauss_legendre_rings(lmax7)
    n7 = almops.nalm(lmax7)
    g7 = torch.Generator(device=dev).manual_seed(7)
    a0 = torch.complex(torch.randn(n7, generator=g7, device=dev),
                       torch.randn(n7, generator=g7, device=dev))
    a0[: lmax7 + 1] = a0[: lmax7 + 1].real.to(a0.dtype)    # m = 0 real
    # gates: the reference's roundtrip contracts at lmax 2047, 3.2e-6 in dd
    # and 6.4e-3 in fast (orphics_tpu/ops/pallas_sht.py:145-150)
    for fast, tol, tag in ((False, 3.2e-6, ""), (True, 6.4e-3, "_fast")):
        def roundtrip(a, fast=fast):
            return sht.map2alm(sht.alm2map(a, rings7, lmax7, fast=fast),
                               rings7, lmax7, fast=fast)
        err = (roundtrip(a0) - a0).abs().max().item()
        check(err <= tol, f"config 7{tag}: roundtrip max-abs error "
                          f"{err:.3e} > {tol}")
        print(f"[9] config 7{tag}: roundtrip max-abs error {err:.3e} "
              f"(<= {tol})")
        state = {"a": a0}

        def step(roundtrip=roundtrip, state=state):
            state["a"] = roundtrip(state["a"])
        throughput(step, 1, 10, f"sht_roundtrips_per_sec_lmax{lmax7}{tag} "
                   "(GL rings, one map)", "roundtrips/s", card, "9")
        check(bool(torch.isfinite(state["a"]).all()), "config 7: not finite")
    counts9 = launches.read(("legendre_ana", "legendre_syn"), "9")
    for name in ("legendre_ana", "legendre_syn"):
        results[name]["launches"] = counts9[name]
        ring_io = getattr(leg, name).ring_io
        check(ring_io == counts9[name], f"9: {ring_io} of {counts9[name]} "
                                        f"{name} launches on the scalar "
                                        "SHT's layouts")
        print(f"[9] {name}: {ring_io} of {counts9[name]} launches on the "
              "scalar SHT's layouts")
    del a0, state
    # the fast roundtrip at lmax 1023 against the reference's 1.8e-3
    # (pallas_sht.py:146-147), one unit-variance complex64 alm as bench.py
    # config 7 makes it, the dd error beside it; after the launch counts,
    # which are config 7's
    lmax7b = 1023
    rings7b = sht.gauss_legendre_rings(lmax7b)
    n7b = almops.nalm(lmax7b)
    a0 = torch.complex(torch.randn(n7b, generator=g7, device=dev),
                       torch.randn(n7b, generator=g7, device=dev))
    a0[: lmax7b + 1] = a0[: lmax7b + 1].real.to(a0.dtype)
    errs7b = {}
    for fast in (False, True):
        a2 = sht.map2alm(sht.alm2map(a0, rings7b, lmax7b, fast=fast),
                         rings7b, lmax7b, fast=fast)
        errs7b[fast] = (a2 - a0).abs().max().item()
    check(errs7b[True] <= 1.8e-3, f"lmax 1023 fast roundtrip: "
                                  f"{errs7b[True]:.3e} > 1.8e-3")
    print(f"[9] lmax {lmax7b} roundtrip max-abs error: fast "
          f"{errs7b[True]:.3e} (<= 1.8e-3), dd {errs7b[False]:.3e} "
          "(the reference's 2.2e-6, read)")
    del a0, a2, rings7b
    torch.cuda.empty_cache()


def curved_spectra_phase(dev, card, results, launches):
    """Phases 10 and 11: bench config 8's curved-sky masked-spectrum Monte
    Carlo at lmax 1023, batch 8 (synalm -> 10' beam -> alm2map -> galactic
    strip 76-104 deg (equatorial) -> map2alm -> alm2cl / w2,
    bench.py:724-786), dd and fast; then its spin-2 leg, config 8p. Each
    step held to the plain Legendre loops on the card's tensors."""
    lmax8, batch8s = 1023, 8
    rings8 = sht.gauss_legendre_rings(lmax8)
    ells8 = np.arange(lmax8 + 1)
    th8 = default_theory()
    sig8 = np.deg2rad(10.0 / 60.0) / np.sqrt(8.0 * np.log(2.0))
    bl8 = np.exp(-0.5 * ells8 * (ells8 + 1.0) * sig8 * sig8)
    bl8_d = torch.as_tensor(bl8, dtype=torch.float32, device=dev)
    mask8 = curved.galactic_mask_rings(rings8, np.deg2rad(76.0),
                                       np.deg2rad(104.0), "equ")
    w2_8 = float(curved.wfactor(2, mask8, rings8))
    sel8 = (ells8 > 100) & (ells8 < lmax8 // 2)
    n8 = almops.nalm(lmax8)

    def spectra_gate(cls, want, tag):
        ratio = (cls.double().mean(0).cpu().numpy()[sel8] / want).mean()
        check(abs(ratio - 1.0) < 0.2, f"{tag}: mean ratio {ratio:.4f}")
        return ratio

    def plain_legendre(plain):
        """(ana, syn) for the transforms: with ``plain`` the plain Legendre
        versions on the card's tensors (the timed steps' reference), else
        the kernels."""
        return ((leg.legendre_ana_ref, leg.legendre_syn_ref) if plain
                else (None, None))

    def plain_gate(step_from_noise, re, im, fast, tag):
        got = step_from_noise(re, im, fast)
        ref = step_from_noise(re, im, False, plain=True)
        d = (got - ref).abs()[:, sel8]
        rel = (d.amax(1) / ref.abs()[:, sel8].amax(1)).max().item()
        tol = 2e-3 if fast else 1e-5
        check(bool(torch.isfinite(got).all()) and rel <= tol,
              f"{tag}: timed step vs plain path {rel:.3e} > {tol}")
        return rel

    for spin in (0, 2):
        launches.reset()
        if spin == 0:
            cl8 = np.asarray(th8.lCl("TT", ells8))
            want8 = (cl8 * bl8 ** 2)[sel8]
            cl8_d = torch.as_tensor(cl8, dtype=torch.float32, device=dev)

            def step_from_noise(re, im, fast, plain=False):
                ana, syn = plain_legendre(plain)
                alms = almops.synalm_from_noise(re, im, cl8_d, lmax8)
                m = sht.alm2map(almops.almxfl(alms, bl8_d), rings8, lmax8,
                                fast=fast, syn=syn)
                a2 = sht.map2alm(m * mask8, rings8, lmax8, fast=fast,
                                 ana=ana)
                return almops.alm2cl(a2) / w2_8
            shape8 = (batch8s, n8)
            modes8 = (False, True)
            name8, tag8 = "curved_masked_cl_sims_per_sec", "10"
        else:
            clee = np.asarray(th8.lCl("EE", ells8))
            clbb = np.asarray(th8.lCl("BB", ells8))
            want8 = ((clee + clbb) * bl8 ** 2)[sel8]
            clee_d, clbb_d = (torch.as_tensor(c, dtype=torch.float32,
                                              device=dev)
                              for c in (clee, clbb))

            def step_from_noise(re, im, fast, plain=False):
                ana, syn = plain_legendre(plain)
                ealm = almops.almxfl(almops.synalm_from_noise(
                    re[:, 0], im[:, 0], clee_d, lmax8), bl8_d)
                balm = almops.almxfl(almops.synalm_from_noise(
                    re[:, 1], im[:, 1], clbb_d, lmax8), bl8_d)
                q, u = sht.alm2map_spin(ealm, balm, rings8, lmax8, fast=fast,
                                        syn=syn)
                e2, b2 = sht.map2alm_spin(q * mask8, u * mask8, rings8,
                                          lmax8, fast=fast, ana=ana)
                return (almops.alm2cl(e2) + almops.alm2cl(b2)) / w2_8
            shape8 = (batch8s, 2, n8)
            modes8 = (False,)
            name8, tag8 = "curved_masked_pol_sims_per_sec", "11"
        g8 = torch.Generator(device=dev).manual_seed(8 + spin)
        for fast in modes8:
            tag = "_fast" if fast else ""

            def step(fast=fast, step_from_noise=step_from_noise,
                     shape8=shape8):
                re = torch.randn(shape8, generator=g8, device=dev)
                im = torch.randn(shape8, generator=g8, device=dev)
                return step_from_noise(re, im, fast)
            cls = step()
            torch.cuda.synchronize()
            check(tuple(cls.shape) == (batch8s, lmax8 + 1),
                  f"config 8 spin {spin}: shape {tuple(cls.shape)}")
            ratio = spectra_gate(cls, want8, f"config 8 spin {spin}{tag}")
            throughput(step, batch8s, 10,
                       f"{name8}_lmax{lmax8}_batch{batch8s}{tag} (GL rings, "
                       "10' beam, galactic strip 76-104 deg)", "sims/s", card,
                       tag8)
            re = torch.randn(shape8, generator=g8, device=dev)
            im = torch.randn(shape8, generator=g8, device=dev)
            rel = plain_gate(step_from_noise, re, im, fast,
                             f"config 8 spin {spin}{tag}")
            print(f"[{tag8}] spin {spin}{tag}: mean C_l / (C_l b_l^2) over "
                  f"100 < l < {lmax8 // 2}: {ratio:.4f} (|ratio - 1| < 0.2); "
                  f"the timed step's output vs the plain path on the same "
                  f"normals: {rel:.3e} of each spectrum's max "
                  f"(<= {2e-3 if fast else 1e-5})")
            if not fast:
                # one step: each Legendre kernel once per Wigner column
                # (spin 2: n = -2 and +2, all 16 paired maps a launch)
                before = (leg.legendre_ana.launches,
                          leg.legendre_syn.launches)
                step()
                torch.cuda.synchronize()
                per = (leg.legendre_ana.launches - before[0],
                       leg.legendre_syn.launches - before[1])
                want = (1, 1) if spin == 0 else (2, 2)
                check(per == want, f"config 8 spin {spin}: one step launched "
                                   f"B10a / B10s {per}, expected {want}")
                print(f"[{tag8}] one step launches B10a {per[0]} and B10s "
                      f"{per[1]} times")
        counts = launches.read(("legendre_ana", "legendre_syn"), tag8)
        for name in ("legendre_ana", "legendre_syn"):
            results[name]["launches"] += counts[name]
        torch.cuda.empty_cache()


def qe_recon_phase(dev, card, launches, geom, th):
    """Phase 12: bench config 3's TT QE reconstruction-only step at 512^2
    2', beam 1.4', noise 6 uK', batch 64, edges arange(40, 2000, 80), both
    branches of bench.py:347-424. Full-plane: B5n draws 32 packed pairs,
    B7 mirrors them, the Hermitian split gives 64 fields, kappa_tt_pallas
    (B3/B4/B7) reconstructs, the N0-debiased power is binned by B1.
    Half-plane: rand_hermitian_half -> kappa_tt_rfft (cuFFT) -> RfftBin2D.
    Returns the engine, for phase 14."""
    launches.reset()
    _, ells_th, cltt, _ = config1(th)
    lmax_grid = geom.ellmax_safe()
    perm3, _ = dft.row_perm(geom.ny)
    n3, batch3 = geom.ny, 64
    q3 = qemod.QE(
        geom, th, qemod.lensing_noise_2d(geom, th, 1.4, 6.0),
        xmask=mask_kspace(geom, lmin=100, lmax=min(3000, lmax_grid - 1)),
        kmask=mask_kspace(geom, lmin=40, lmax=min(3000, lmax_grid * 0.8)))
    check(q3.device.type == "cuda", "QE built with no device is not on the "
                                    "card")
    norm3 = float(np.float32(geom.area / geom.npix ** 2))
    ml3 = geom.modlmap_np()
    amp3 = np.sqrt(np.maximum(np.interp(ml3, ells_th, cltt, left=0, right=0),
                              0.0)) * (geom.npix / float(geom.area) ** 0.5)

    def pp_tables(device, n0):
        """Config 3's doubly-permuted tables on ``device``: the synthesis
        scale, the N0 plane and the bin tables."""
        ip = torch.as_tensor(perm3, dtype=torch.long, device=device)
        scale = torch.as_tensor(np.ascontiguousarray(
            amp3[perm3][:, perm3].astype(np.float32)), device=device)
        n0_pp = n0.index_select(0, ip).index_select(1, ip).contiguous()
        return (scale, n0_pp) + dft.permuted_bin_tables(ml3, perm3, EDGES3,
                                                        device=device)

    def full_from_planes(engine, zr, zi, n0_pp, idc, icnt, nseg):
        zmr, zmi = mirror_pp(zr, zi)
        Zr = torch.stack([0.5 * (zr + zmr), 0.5 * (zi + zmi)], 1) \
            .reshape(batch3, n3, n3)
        Zi = torch.stack([0.5 * (zi - zmi), 0.5 * (zmr - zr)], 1) \
            .reshape(batch3, n3, n3)
        our, oui = engine.kappa_tt_pallas(Zr, Zi)
        p = (our * our + oui * oui) * norm3 - n0_pp
        return bin_reduce(p.reshape(batch3, -1), idc, nseg)[:, 1:] * icnt

    scale3, *tabs3 = pp_tables(dev, q3.N_L_kk("TT"))

    def full_step(seed):
        return full_from_planes(q3, *noise_planes(scale3, seed, batch3 // 2),
                                *tabs3)

    covsqrt_h3 = grf.covsqrt_half(geom, ells_th, cltt)
    binner3 = RfftBin2D(geom, EDGES3)
    check(covsqrt_h3.is_cuda and binner3._ids.is_cuda, "covsqrt_half / "
          "RfftBin2D built with no device are not on the card")
    n0_h3 = q3.N_L_kk("TT")[:, :geom.nx // 2 + 1]
    g12 = torch.Generator(device=dev).manual_seed(12)

    def half_step():
        eta = grf.rand_hermitian_half(geom, g12, batch=(batch3,))
        fk = q3.kappa_tt_rfft(covsqrt_h3 * eta)
        return binner3.bin((fk.conj() * fk).real * norm3 - n0_h3)[1]

    nb3 = len(EDGES3) - 1
    for out in (full_step(0), half_step()):
        torch.cuda.synchronize()
        check(tuple(out.shape) == (batch3, nb3)
              and bool(torch.isfinite(out).all()), "config 3 output: shape "
              f"{tuple(out.shape)} or not finite")
    seeds = itertools.count(1)
    cell12 = f"512^2 2' beam 1.4' 6 uK' batch {batch3} {nb3} bins"
    throughput(lambda: full_step(next(seeds)), batch3, 20, "config-3 "
               "full-plane step (port's qe_tt_recon_only_per_sec_512x512_"
               f"fp32) {cell12}", "recons/s", card, "12")
    counts12 = launches.read(("noise_planes", "mirror_pp", "colfft", "rowfft",
                              "bin_reduce"), "12")
    launches.check_row_route(counts12, "12")
    print("[12] 23 full-plane steps and 1 half-plane step (1 check, 2 "
          "warm-up, 20 timed): "
          + ", ".join(f"{counts12[k] / 23:.1f} {k}" for k in
                      ("noise_planes", "mirror_pp", "colfft", "rowfft"))
          + f", {(counts12['bin_reduce'] - 1) / 23:.1f} bin_reduce launches "
          "per full-plane step")
    # the timed full-plane step's own output at its own shape, card
    # (kernels) vs CPU (plain versions) on B5n's identical noise
    out12 = full_step(5)
    q3c = qemod.QE(
        geom, th, qemod.lensing_noise_2d(geom, th, 1.4, 6.0, device="cpu"),
        xmask=mask_kspace(geom, lmin=100, lmax=min(3000, lmax_grid - 1),
                          device="cpu"),
        kmask=mask_kspace(geom, lmin=40, lmax=min(3000, lmax_grid * 0.8),
                          device="cpu"), device="cpu")
    _, *tabs3c = pp_tables("cpu", q3c.N_L_kk("TT"))
    zr, zi = noise_planes(scale3, 5, batch3 // 2)
    ref12 = full_from_planes(q3c, zr.cpu(), zi.cpu(), *tabs3c)
    d12 = (out12.cpu() - ref12).abs().amax(1)
    rel12 = (d12 / ref12.abs().amax(1)).max().item()
    # the debias cancels about nine tenths of each spectrum, so what is left
    # depends on the seed and the bin: the gate reads the error against the
    # reconstruction's own power (N0 added back); against the debiased
    # spectrum it is printed only
    n0_b3 = tabs3c[0].reshape(1, -1)
    n0_b3 = bin_reduce(n0_b3, *tabs3c[1::2])[:, 1:] * tabs3c[2]
    raw12 = (d12 / (ref12 + n0_b3).abs().amax(1)).max().item()
    check(raw12 <= 1e-4, f"config-3 step, card vs CPU: {raw12:.3e} of each "
                         "spectrum's max before the debias > 1e-4")
    print(f"[12] the full-plane step's output ({batch3} spectra), card "
          f"(kernels) vs CPU (plain versions) on the same noise: "
          f"{raw12:.3e} of each spectrum's max before the debias (<= 1e-4), "
          f"{rel12:.3e} of each debiased spectrum's max (not gated)")
    del q3c, tabs3c, zr, zi, ref12, out12
    # the two branches draw different streams: their mean debiased spectra
    # over 512 sims each agree within the Monte-Carlo error
    full = torch.cat([full_step(1000 + i) for i in range(8)]).double()
    half = torch.cat([half_step() for _ in range(8)]).double()
    se = (full.var(0) / full.shape[0] + half.var(0) / half.shape[0]).sqrt()
    pull = ((full.mean(0) - half.mean(0)).abs() / se).max().item()
    n0_b = binner3.bin(n0_h3)[1]
    bias = max((x.mean(0).abs() / n0_b.double()).max().item()
               for x in (full, half))
    check(pull < 5.0, f"config 3: full- and half-plane mean spectra differ "
                      f"by {pull:.2f} sigma")
    print(f"[12] {full.shape[0]} sims per branch: the mean debiased spectra "
          f"differ by at most {pull:.2f} of their Monte-Carlo error per bin "
          f"(< 5); |mean debiased| <= {bias:.4f} of the binned N0")
    del full, half, covsqrt_h3, binner3, scale3, tabs3
    torch.cuda.empty_cache()
    return q3


def pair_spectra_phase(dev, card, results, launches, th):
    """Phase 13: the unfused pair spectra at bench config 1's shape: 96
    packed pairs at 2048^2 0.5', nseg 100. (a) fft2pp -> B6h qc_pp_half ->
    B2 on the half plane + the two boundary rows (B1); (b) fft2pp -> B7
    mirror_pp -> B2' bin_pair_power on the full plane. Both are held to
    FastCl's fused analysis of the same maps."""
    launches.reset()
    geom1, ells_th, cltt, edges1 = config1(th)
    P1, n1 = 96, 2048
    perm1, _ = dft.row_perm(n1)
    fc = FastCl(geom1, ells_th, cltt, bin_edges=edges1)
    m1, m2 = dft.ifft2pp_noise(fc._covsqrt_pp, 13, P1)
    ids_full = torch.as_tensor(np.digitize(
        geom1.modlmap_np()[perm1][:, perm1].ravel(), edges1, right=True)
        .astype(np.int32), device=dev)
    hn = float(np.float32(0.5) * np.float32(fc._norm))

    def bandpowers(bq, bc):
        return (torch.cat([bq + bc, bq - bc])[:, 1:-1]) * hn * fc._icnt

    def path_a():
        zr, zi = dft.fft2pp(m1, m2)
        qs, cc = qc_pp_half(zr, zi)
        bqc, bcc = bin2_reduce(qs.reshape(P1, -1), cc.reshape(P1, -1),
                               fc._idc, fc._nsg)
        del qs, cc
        bq0, bc0 = fc._row_bins(zr, zi, 0, fc._ids0)
        bqn, bcn = fc._row_bins(zr, zi, fc._pnyq, fc._idsn)
        return bandpowers(2.0 * bqc - bq0 + bqn, 2.0 * bcc - bc0 + bcn)

    def path_b():
        zr, zi = dft.fft2pp(m1, m2)
        zmr, zmi = mirror_pp(zr, zi)
        return bandpowers(*bin_pair_power(
            *(a.reshape(P1, -1) for a in (zr, zi, zmr, zmi)), ids_full,
            fc._nsg))

    def fused():
        return torch.cat(fc._pair_bandpowers(m1, m2))

    ref13 = fused()
    cell13 = f"2048^2 0.5' nseg {fc._nsg}, {P1} pairs"
    for tag, path in (("(a) fft2pp, B6h qc_pp_half, B2 + boundary rows",
                       path_a),
                      ("(b) fft2pp, B7 mirror_pp, B2' bin_pair_power",
                       path_b)):
        got = path()
        torch.cuda.synchronize()
        check(tuple(got.shape) == tuple(ref13.shape)
              and bool(torch.isfinite(got).all()), f"13 {tag}: bad output")
        rel = ((got - ref13).abs().amax(1) / ref13.abs().amax(1)).max().item()
        check(rel <= 1e-5, f"13 {tag} vs FastCl's fused analysis: {rel:.3e} "
                           "of each spectrum's max > 1e-5")
        print(f"[13] {tag}: {2 * P1} spectra vs FastCl's fused analysis of "
              f"the same maps: {rel:.3e} of each spectrum's max (<= 1e-5)")
        del got
        torch.cuda.empty_cache()
        throughput(path, 2 * P1, 3, f"unfused pair spectra {tag} {cell13}",
                   "spectra/s", card, "13")
        torch.cuda.empty_cache()
    counts13 = launches.read(("qc_pp_half", "bin_pair_power", "bin2_reduce",
                              "mirror_pp", "colfft", "rowfft", "bin_reduce"),
                             "13")
    launches.check_row_route(counts13, "13")
    print(f"[13] 6 runs of each unfused path (1 check, 2 warm-up, 3 timed): "
          f"{counts13['qc_pp_half'] / 6:.0f} B6h, "
          f"{counts13['bin_pair_power'] / 6:.0f} B2', "
          f"{counts13['mirror_pp'] / 6:.0f} B7 launches per run")
    for name in ("qc_pp_half", "bin_pair_power"):
        results[name]["launches"] = counts13[name]
    # B6h' on the same planes: the cross spectrum of each pair from the
    # stored Z, against FastCl.cross_bandpowers of the same maps, read
    # against sqrt(P11 P22) as phase 7 reads it
    zr, zi = dft.fft2pp(m1, m2)
    sh = s_pp_half(zr, zi)
    bsh = bin_reduce(sh.reshape(P1, -1), fc._idc, fc._nsg)
    (s0,) = fc._row_bins(zr, zi, 0, fc._ids0, s_field)
    (sn,) = fc._row_bins(zr, zi, fc._pnyq, fc._idsn, s_field)
    cross = (2.0 * bsh - s0 + sn)[:, 1:-1] * hn * fc._icnt
    del zr, zi, sh
    xref = fc.cross_bandpowers(m1, m2)
    p12 = (ref13[:P1] * ref13[P1:]).sqrt()
    xrel = ((cross - xref).abs() / p12).max().item()
    check(xrel <= 5e-5, f"13 s_pp_half cross spectra vs cross_bandpowers: "
                        f"{xrel:.3e} of sqrt(P11 P22)")
    print(f"[13] B6h' s_pp_half: {P1} cross spectra from the stored Z vs "
          f"FastCl.cross_bandpowers of the same maps: {xrel:.3e} of "
          "sqrt(P11 P22) per bin (<= 5e-5)")
    results["s_pp_half"]["launches"] = launches.read(("s_pp_half",),
                                                     "13")["s_pp_half"]
    del ids_full, ref13, cross, xref, p12
    # B4b at config 1's width: lane chunk 0 of the row pass of the same
    # maps' column intermediate equals B4's first 128 columns bit for bit
    # (no composition launches B4b: B6 needs no strip patch)
    y13 = dft.colfft(m1, m2)
    del m1, m2
    blk = dft.rowfft_blk0(*y13)
    z13 = dft.rowfft(*y13)
    torch.cuda.synchronize()
    check(all(tuple(a.shape) == (P1, n1, 128) and torch.equal(a, z[..., :128])
              for a, z in zip(blk, z13)),
          "13: rowfft_blk0(Y) differs from rowfft(Y)[..., :128]")
    print(f"[13] B4b rowfft_blk0 on the ({P1}, {n1}, {n1}) column "
          "intermediate: equal to B4 rowfft's columns [0, 128) bit for bit")
    results["rowfft_blk0"]["launches"] = launches.read(("rowfft_blk0",),
                                                       "13")["rowfft_blk0"]
    del fc, y13, blk, z13
    torch.cuda.empty_cache()


def debias_phase(dev, card, results, launches, geom, th, q3):
    """Phase 14: the N0 debias on the card at config 3's settings, on phase
    12's engine ``q3``: 64 lensed sims from FlatLensingSims (B8) -> fft2 /
    kbeam -> mcn0 and rdn0 (sim 0 as data) beside NlGenerator's binned
    analytic N0; one n1_tt call; one polarized get_sim."""
    launches.reset()
    _, ells_th, _, _ = config1(th)
    lmax_grid = geom.ellmax_safe()
    n3, ml3 = geom.ny, geom.modlmap_np()
    fls = lensing.FlatLensingSims(geom, th, 1.4, 6.0)
    check(fls.kbeam.is_cuda, "FlatLensingSims built with no device is not "
                             "on the card")
    g14 = torch.Generator(device=dev).manual_seed(14)
    obs = fls.get_sim(g14, batch=(64,))
    torch.cuda.synchronize()
    check(tuple(obs.shape) == (64, n3, n3) and bool(torch.isfinite(obs).all()),
          f"14: sims {tuple(obs.shape)} or not finite")
    kmaps = torch.fft.fft2(obs) / fls.kbeam
    del obs
    nlg = qemod.NlGenerator(geom, th, EDGES3).update_noise(
        1.4, 6.0, tellmin=100, tellmax=min(3000, lmax_grid - 1), kmin=40,
        kmax=min(3000, lmax_grid * 0.8))
    cents14, n0_nlg = nlg.get_nl("TT")
    n0_th = Bin2D(ml3, EDGES3).bin(q3.N_L_kk("TT"))[1].cpu().numpy()
    check(np.allclose(n0_nlg, n0_th, rtol=1e-5),
          "14: NlGenerator's N0 differs from the engine's")
    _, n0_mc = qemod.mcn0(q3, "TT", kmaps[1:], EDGES3)
    torch.cuda.synchronize()
    ran14 = (q3.transforms_inverse, q3.transforms_forward, q3.legs_merged)
    t0 = time.perf_counter()
    _, rd, _ = qemod.rdn0(q3, "TT", kmaps[0], kmaps[1:], EDGES3)
    dt14 = time.perf_counter() - t0          # rdn0 returns host arrays
    ran14 = [b - a for a, b in zip(ran14, (q3.transforms_inverse,
                                           q3.transforms_forward,
                                           q3.legs_merged))]
    # two distinct legs a reconstruction: 6 inverse transforms (nothing
    # merges) and one forward transform a component
    check(ran14[1] == 2 * 16 and ran14[0] == 3 * ran14[1] and not ran14[2],
          f"14: rdn0's 16 reconstructions ran (inverse, forward, merged) "
          f"{ran14}, not 6, 2, 0 each")
    print(f"[14] rdn0's 16 two-leg reconstructions: {ran14[0]} inverse and "
          f"{ran14[1]} forward transforms, {ran14[2]} legs merged")
    sel = n0_th > 0
    r_mc, r_rd = n0_mc[sel] / n0_th[sel], rd[sel] / n0_th[sel]
    # tests/test_qe_mv.py's tolerances at 8 sims of 128^2: per-bin 35 % and
    # mean 10 % (MCN0), mean 20 % (RDN0); 63 sims here, so they hold easily
    check(abs(r_mc.mean() - 1.0) < 0.1 and bool(np.all(np.abs(r_mc - 1.0)
                                                       < 0.35)),
          f"14: MCN0 / N0 = {r_mc}")
    check(abs(r_rd.mean() - 1.0) < 0.2, f"14: RDN0 / N0 = {r_rd}")
    print(f"[14] 63 lensed sims at 512^2 2': MCN0 / N0 mean {r_mc.mean():.4f}"
          f" (within 0.1 of 1), per bin within {np.abs(r_mc - 1).max():.4f} "
          f"(< 0.35); RDN0 / N0 mean {r_rd.mean():.4f} (within 0.2 of 1), per "
          f"bin within {np.abs(r_rd - 1).max():.4f}; NlGenerator.get_nl('TT') "
          f"equals the engine's binned N0; rdn0: {63 / dt14:.2f} sims/s "
          f"({dt14 * 1e3:.1f} ms for 63 sims, 4 reconstructions each) on "
          f"{card}")
    del kmaps
    torch.cuda.empty_cache()
    Ls14 = np.array([100.0, 300.0, 500.0, 700.0, 900.0])
    clkk = np.asarray(th.gCl("kk", ells_th))
    _, n1 = qemod.n1_tt(q3, Ls14, clkk, pad=2)
    n0_at = np.interp(Ls14, cents14, n0_th)
    check(bool(np.all(n1 > 0) and np.all(n1 < n0_at)),
          f"14: N1 {n1} not inside (0, N0 {n0_at})")
    print(f"[14] n1_tt at L = {Ls14.tolist()}, pad 2 (a 1024^2 lattice): "
          f"N1 / N0 = {(n1 / n0_at).tolist()} (each inside (0, 1))")
    # one polarized get_sim at batch 16: finite (16, 3, 512, 512); its T leg
    # is the scalar chain (B8 with one component, beam, noise) applied to
    # the polarized sim's own unlensed T, kappa and T noise
    flp = lensing.FlatLensingSims(geom, th, 1.4, 6.0, pol=True)
    eta14 = flp.draw_noise(g14, batch=(16,))
    obs_p, ex = flp.get_sim_from_noise(*eta14, return_intermediate=True)
    torch.cuda.synchronize()
    check(tuple(obs_p.shape) == (16, 3, n3, n3)
          and bool(torch.isfinite(obs_p).all()),
          f"14: polarized sims {tuple(obs_p.shape)} or not finite")
    t_leg = (kfilter(fls.lens(ex["unlensed"][:, 0].contiguous(),
                              ex["kappa"]), fls.kbeam, geom)
             + fls.ngen.get_map_from_noise(eta14[2][:, :1]))
    _, trel = rel_err((obs_p[:, 0],), (t_leg,))
    check(trel <= 2e-5, f"14: polarized T leg vs the scalar path {trel:.3e}")
    print(f"[14] polarized get_sim batch 16: finite (16, 3, {n3}, {n3}); T "
          f"leg vs the scalar chain on the same unlensed T, kappa and noise: "
          f"{trel:.3e} of max (<= 2e-5)")
    # the NFW profiles on host angles, no device named: the 500000-sample
    # line-of-sight quadrature of the NFW density runs on the card and
    # agrees with the closed-form projection
    halo = dict(M=2e14, c=3.2, R=1.5)
    th14 = np.geomspace(1e-4, 3e-3, 16)
    k_quad = lensing.kappa_generic(th14, 0.7, 1500.0,
                                   lensing.rho_nfw(**halo), 0.4)
    k_form = lensing.kappa_nfw_generic(th14, 0.7, 1500.0, win_at_lens=0.4,
                                       **halo)
    check(k_quad.is_cuda and k_form.is_cuda and k_quad.dtype == torch.float64,
          "14: NFW profiles of host angles are not float64 on the card")
    nfw_rel = ((k_quad - k_form).abs() / k_form).max().item()
    check(nfw_rel <= 1e-4, f"14: NFW quadrature vs closed form {nfw_rel:.3e}")
    print(f"[14] kappa_generic on {len(th14)} host angles (500000 samples "
          f"each, on the card) vs kappa_nfw_generic: {nfw_rel:.3e} relative "
          "(<= 1e-4: the quadrature stops at 2000 Mpc)")
    counts14 = launches.read(("lens_map_kernel", "bin_reduce", "qe_leg",
                            "qe_pair", "qe_post"), "14")
    for name in ("qe_leg", "qe_pair", "qe_post"):
        results[name].setdefault("launches_by_path", {})["debias"] = \
            counts14[name]
    launches.read_wide("14", False)
    del flp, fls, obs_p, ex, eta14, q3
    torch.cuda.empty_cache()


def stacking_phase(dev, card, results, launches, th):
    """Phase 15: bench config 5's cluster stacking (bench.py:581-656), 10^4
    stamps of 64^2 at 0.5', beam 1.4'; a 5' hole filled by the shared
    max-likelihood geometry (10 uK' white noise in pcov); Bin2D profiles on
    edges arange(0, 10, 1)' (B1); chi^2 against 16 NFW templates, masses
    geomspace(5e13, 8e14), cinv = 1e4 I; argmin. Then nfwfit.lens_cov at
    32^2 on B8."""
    nst5, n5 = 10_000, 64
    g5 = Geometry(n5, n5, 0.5 * arcmin, 0.5 * arcmin)
    pbin5 = Bin2D(g5.modrmap_np(), np.arange(0.0, 10.0, 1.0) * arcmin,
                  device=dev)
    # memory the earlier phases still hold: the step's footprint is read
    # above it, as a process running config 5 alone would see it
    base15 = torch.cuda.memory_allocated()
    beam5 = lambda l: gauss_beam(l, 1.4)
    nvar5 = (10.0 * arcmin) ** 2 / (g5.dy * g5.dx)
    m1, m2 = pixcov.get_geometry_regions(1, n5, 0.5 * arcmin, 5.0 * arcmin)
    t0 = time.perf_counter()
    eye5 = torch.eye(n5 * n5, dtype=torch.float64, device=dev)
    pcov5 = pixcov.scov_from_theory(g5, th, beam5, ncomp=1) + nvar5 * eye5
    check(pcov5.is_cuda and pcov5.dtype == torch.float64,
          "15: scov_from_theory with no device is not float64 on the card")
    cs64, mm64 = pixcov.make_geometry(pcov5, m1, m2, ncomp=1)
    cs5, mm5 = cs64.to(torch.float32), mm64.to(torch.float32)
    del pcov5
    torch.cuda.synchronize()
    geo_s = time.perf_counter() - t0
    # the same geometry built entirely in float32 (as the TPU bench does)
    pcov32 = pixcov.scov_from_theory(g5, th, beam5, ncomp=1,
                                     dtype=torch.float32) \
        + nvar5 * eye5.to(torch.float32)
    _, mm_f32 = pixcov.make_geometry(pcov32, m1, m2, ncomp=1)
    del pcov32, eye5
    cc5 = Cosmology()
    masses5 = np.geomspace(5e13, 8e14, 16)
    modr5 = g5.modrmap_np()
    temps5 = torch.stack([pbin5.bin(nfwfit.nfw_kappa(m, modr5, cc5)
                                    .to(torch.float32))[1] for m in masses5])
    nb5 = temps5.shape[-1]
    cinv5 = torch.eye(nb5, device=dev) * 1e4
    ells5 = np.arange(th.lpad + 1)
    ps5 = np.asarray(th.lCl("TT", ells5))[None, None]
    mgen5 = grf.MapGen(g5, ps5)
    gen15 = torch.Generator(device=dev).manual_seed(15)
    print(f"[15] geometry: {len(m1)} hole and {len(m2)} context pixels; "
          f"float64 pcov (4096^2) inverted, deprojected and solved on the "
          f"card in {geo_s:.3f} s; meanmul cast to float32 for the fill; "
          f"16 NFW templates over {nb5} bins")

    def fill_profiles(stamps, covsqrt, meanmul, binner):
        filled = pixcov.inpaint_stamps_batched(stamps, covsqrt, meanmul,
                                               m1, m2)
        return filled, binner.bin(filled[:, 0])[1]

    def chi2_of(profs, temps, cinv):
        diff = profs[:, None, :] - temps[None, :, :]
        return torch.einsum("bmi,ij,bmj->bm", diff, cinv, diff)

    def step5():
        stamps = mgen5.get_map(gen15, batch=(nst5,))[:, None]
        _, profs = fill_profiles(stamps, cs5, mm5, pbin5)
        return chi2_of(profs, temps5, cinv5).argmin(dim=1)

    cell5 = (f"{nst5} stamps of {n5}^2 0.5' beam 1.4' 5' hole, 16 masses, "
             f"{nb5} profile bins")
    launches.reset()
    best5 = step5()
    torch.cuda.synchronize()
    check(tuple(best5.shape) == (nst5,) and int(best5.min()) >= 0
          and int(best5.max()) < 16, "15: argmin out of range")
    throughput(step5, nst5, 5, "config-5 step (port's "
               f"stack_inpaint_nfwfit_stamps_per_sec_64x64) {cell5}",
               "stamps/s", card, "15")
    peak_all = torch.cuda.max_memory_allocated()
    peak5 = (peak_all - base15) / 1e9
    check(peak5 <= 4.0, f"15: the step's peak memory {peak5:.3f} GB > 4 GB")
    counts15 = launches.read(("bin_reduce",), "15")
    check(counts15["bin_reduce"] == 8, f"15: {counts15['bin_reduce']} B1 "
          "launches in 8 steps (1 check, 2 warm-up, 5 timed)")
    print(f"[15] peak memory {peak5:.3f} GB above the {base15 / 1e9:.3f} GB "
          f"that phases 2-14 still hold ({peak_all / 1e9:.3f} GB in all; <= "
          f"4 GB; a (B, nh, nc) meanmul would take "
          f"{nst5 * len(m1) * len(m2) * 4 / 1e9:.1f} GB in float32); B1 "
          f"launches: {counts15['bin_reduce']} in 8 steps")
    # card (kernels) against the CPU (plain versions): 256 stamps on the
    # same injected noise, the same float32 geometry and templates
    eta5 = grf.rand_kmap(g5, torch.Generator().manual_seed(55), 1,
                         batch=(256,), device="cpu")
    mgen5c = grf.MapGen(g5, ps5, device="cpu")
    pbin5c = Bin2D(modr5, np.arange(0.0, 10.0, 1.0) * arcmin, device="cpu")
    st_g = mgen5.get_map_from_noise(eta5.to(dev))[:, None]
    st_c = mgen5c.get_map_from_noise(eta5)[:, None]
    f_g, p_g = fill_profiles(st_g, cs5, mm5, pbin5)
    f_c, p_c = fill_profiles(st_c, cs5.cpu(), mm5.cpu(), pbin5c)
    x_g = chi2_of(p_g, temps5, cinv5).cpu().double().numpy()
    x_c = chi2_of(p_c, temps5.cpu(), cinv5.cpu()).double().numpy()
    _, f_err = rel_err((f_g.cpu(),), (f_c,))
    _, p_err = rel_err((p_g.cpu(),), (p_c,))
    x_err = float(np.max(np.abs(x_g - x_c) / x_c))
    two = np.sort(x_c, axis=1)[:, :2]
    clear = (two[:, 1] - two[:, 0]) / two[:, 0] > 1e-3
    same = np.array_equal(x_g.argmin(1)[clear], x_c.argmin(1)[clear])
    check(f_err <= 1e-5 and p_err <= 1e-5 and x_err <= 1e-4 and same,
          f"15: card vs CPU: fill {f_err:.3e}, profiles {p_err:.3e}, chi^2 "
          f"{x_err:.3e}, argmin equal where clear: {same}")
    print(f"[15] 256 stamps, card (kernels) vs CPU (plain versions) on the "
          f"same noise: filled stamps {f_err:.3e} of max (<= 1e-5), "
          f"profiles {p_err:.3e} (<= 1e-5), chi^2 {x_err:.3e} relative "
          f"(<= 1e-4), argmin equal on the {int(clear.sum())} stamps whose "
          f"two smallest chi^2 differ by > 1e-3")
    # finding, not a gate: the fill from a geometry built in float32
    f32 = pixcov.inpaint_stamps_batched(st_g, cs5, mm_f32, m1, m2)
    _, f32_err = rel_err((f32,), (f_g,))
    print(f"[15] the fill from a geometry built entirely in float32 differs "
          f"from the float64-built one by {f32_err:.3e} of max")
    del st_g, st_c, f_g, f_c, p_g, p_c, f32, mm_f32, eta5, mgen5c
    # the conditional-variance identity (tests/test_pixcov.py:42-76) at
    # 64^2: no beam, no deprojection, 10^4 float64 GRF + noise stamps
    pcov_nb = pixcov.scov_from_theory(g5, th, None, ncomp=1) + nvar5 \
        * torch.eye(n5 * n5, dtype=torch.float64, device=dev)
    cs_nb, mm_nb = pixcov.make_geometry(pcov_nb, m1, m2, deproject=False,
                                        ncomp=1)
    del pcov_nb
    pred = torch.diagonal(cs_nb @ cs_nb.T)
    mg64 = grf.MapGen(g5, ps5, dtype=torch.float64)
    sims = (mg64.get_map(gen15, batch=(nst5,))
            + torch.randn((nst5, n5, n5), generator=gen15,
                          dtype=torch.float64, device=dev)
            * math.sqrt(nvar5)).reshape(nst5, -1)
    m1t = torch.as_tensor(m1, device=dev)
    res5 = sims[:, m1t] - sims[:, torch.as_tensor(m2, device=dev)] @ mm_nb.T
    ratio = (res5.var(dim=0) / pred).cpu().numpy()
    check(abs(ratio.mean() - 1.0) < 0.05,
          f"15: residual / predicted variance mean {ratio.mean():.4f}")
    print(f"[15] {nst5} noisy stamps of 64^2: residual variance / "
          f"diag(covsqrt covsqrt^T) mean {ratio.mean():.4f} (within 0.05 of "
          f"1), range [{ratio.min():.4f}, {ratio.max():.4f}] over "
          f"{ratio.size} hole pixels")
    del sims, res5, mg64, cs_nb, mm_nb, pred
    torch.cuda.empty_cache()
    # nfwfit.lens_cov at 32^2, order 5: the lensed covariance of a 1e15
    # halo's deflection, one B8 launch a side, against the CPU's plain path
    g32 = Geometry(32, 32, 0.5 * arcmin, 0.5 * arcmin)
    ucov = pixcov.scov_from_theory(g32, th, beam5, ncomp=1,
                                   dtype=torch.float32)
    kap32 = nfwfit.nfw_kappa(1e15, g32.modrmap_np(), cc5).to(torch.float32)
    alpha32 = lensing.alpha_from_kappa(kap32, g32).contiguous()
    launches.reset()
    lc_g = nfwfit.lens_cov(ucov, alpha32, g32, lens_order=5)
    torch.cuda.synchronize()
    counts_lc = launches.read(("lens_map_kernel",), "15")
    check(counts_lc["lens_map_kernel"] == 2, f"15: lens_cov launched B8 "
          f"{counts_lc['lens_map_kernel']} times (one a side)")
    lc_c = nfwfit.lens_cov(ucov.cpu(), alpha32.cpu(), g32, lens_order=5)
    _, lc_err = rel_err((lc_g.cpu(),), (lc_c,))
    check(lc_err <= 2e-5, f"15: lens_cov card vs CPU {lc_err:.3e} > 2e-5")
    print(f"[15] nfwfit.lens_cov (1024, 1024) at 32^2 order 5, max|alpha|/dx "
          f"{(alpha32.abs().max() / g32.dx).item():.3f}: card (2 B8 "
          f"launches) vs CPU {lc_err:.3e} of max (<= 2e-5)")
    results["bin_reduce_config5"]["launches"] = counts15["bin_reduce"]
    results["bin_reduce"]["launches_by_path"] = {
        "lensing": results["bin_reduce"]["launches"],
        "config5": counts15["bin_reduce"]}
    results["lens_map_kernel"]["launches_by_path"] = {
        "lensing": results["lens_map_kernel"]["launches"],
        "lens_cov": counts_lc["lens_map_kernel"]}
    del ucov, lc_g, lc_c, cs5, mm5, cs64, mm64, temps5
    torch.cuda.empty_cache()


def pure_b_phase(dev, card, results, launches, th):
    """Phase 16: pure-B bandpowers of masked polarization sims (the Smith
    2006 estimator of BB analyses: mapstools.Purify) at a ground-based BB
    field's size: 1024^2 at 2' (34 deg, ~1165 deg^2), 16 lensed TT/EE/BB/TE
    sims a step from MapGen (3 x 3 ps), the 18 % taper, the pure (T, E, B)
    transforms, the TT, EE and BB auto powers x area / npix^2, and one
    Bin2D over all 48 planes on edges arange(300, 2500, 200): one B1 launch
    a step. Then the map-tools slice's card checks against the CPU."""
    n16, nsim16 = 1024, 16
    g16 = rect_geometry(width_arcmin=n16 * 2.0, px_res_arcmin=2.0)
    ps16 = grf.cmb_ps(th)
    edges16 = np.arange(300, 2500, 200.0)
    base16 = torch.cuda.memory_allocated()
    mg16 = grf.MapGen(g16, ps16)
    win16 = get_taper(g16, taper_percent=18.0)[0]
    pur16 = mapstools.Purify(g16, win16)
    bin16 = Bin2D(g16.modlmap_np(), edges16)
    check(win16.is_cuda and bin16._ids.is_cuda and pur16.windict[
        "d2Win_dx2"].is_cuda, "16: Purify / Bin2D built with no device are "
                              "not on the card")
    gen16 = torch.Generator(device=dev).manual_seed(16)

    def pure_spectra(iqu, pur, binner, method="pure"):
        """(B, 3, nbins) binned TT, EE, BB auto powers of the purified
        (T, E, B) transforms of ``iqu * window``: one Bin2D call."""
        f = torch.stack(pur.lteb_from_iqu(iqu * pur.windict["Win"],
                                          method=method), -3)
        p2d = (f.real ** 2 + f.imag ** 2) * (g16.area / g16.npix ** 2)
        return binner.bin(p2d.to(torch.float32))[1]

    def step16():
        return pure_spectra(mg16.get_map(gen16, batch=(nsim16,)), pur16,
                            bin16)

    cell16 = (f"{n16}^2 2' ({n16 * 2 / 60:.1f} deg), {nsim16} lensed IQU "
              f"sims, 18 % taper, pure TEB, {len(edges16) - 1} bins")
    launches.reset()
    throughput(step16, nsim16, 5, f"pure-B bandpowers {cell16}", "sims/s",
               card, "16")
    peak16 = (torch.cuda.max_memory_allocated() - base16) / 1e9
    counts16 = launches.read(("bin_reduce",), "16")
    check(counts16["bin_reduce"] == 7, f"16: {counts16['bin_reduce']} B1 "
          "launches in 7 steps (2 warm-up, 5 timed)")
    print(f"[16] peak memory {peak16:.3f} GB above the {base16 / 1e9:.3f} GB "
          f"that phases 2-15 still hold; B1 launches: "
          f"{counts16['bin_reduce']} in 7 steps (one a step)")
    # gate 1: card against the CPU on the same noise, 2 sims: float32 on
    # both (cuFFT vs pocketfft, B1 vs its plain version), then the CPU in
    # float64 (the window's derivatives are float64-built on both)
    eta16 = grf.rand_kmap(g16, torch.Generator().manual_seed(161), 3,
                          batch=(2,), device="cpu")
    got16 = pure_spectra(mg16.get_map_from_noise(eta16.to(dev)), pur16,
                         bin16).cpu().double().numpy()
    bin16c = Bin2D(g16.modlmap_np(), edges16, device="cpu")
    errs16 = {}
    for dt, cdt, tol in ((torch.float32, torch.complex64, 1e-5),
                         (torch.float64, torch.complex128, 1e-4)):
        mgc = grf.MapGen(g16, ps16, dtype=dt, device="cpu")
        purc = mapstools.Purify(g16, win16.cpu().to(dt))
        ref = pure_spectra(mgc.get_map_from_noise(eta16.to(cdt)), purc,
                           bin16c).double().numpy()
        errs16[dt] = spectra_err(got16, ref)
        check(errs16[dt] <= tol, f"16: card vs CPU {dt}: {errs16[dt]:.3e} "
                                 f"of each spectrum's max > {tol}")
    print(f"[16] 2 sims, card (float32, kernels) vs CPU on the same noise: "
          f"{errs16[torch.float32]:.3e} of each spectrum's max vs the CPU's "
          f"float32 (<= 1e-5), {errs16[torch.float64]:.3e} vs its float64 "
          f"(<= 1e-4)")
    del mgc, purc, eta16
    # gate 2: 16 E-only sims (B = 0) at full size: the pure estimator's BB
    # over the standard one's, the thresholds of tests/test_mapstools.py
    ps16e = np.zeros_like(ps16)
    ps16e[0, 0], ps16e[1, 1] = ps16[0, 0], ps16[1, 1]
    iqu_e = grf.MapGen(g16, ps16e).get_map(gen16, batch=(nsim16,))
    bb = {m: pure_spectra(iqu_e, pur16, bin16, m)[:, 2].double().mean(0)
          for m in ("standard", "pure")}
    r16 = (bb["pure"] / bb["standard"]).cpu().numpy()
    check(bool(np.all(r16 < 0.01)) and r16.mean() < 0.002,
          f"16: pure / standard BB on E-only sims {r16}")
    print(f"[16] {nsim16} E-only sims: pure / standard BB per bin "
          f"{np.array2string(r16, precision=6)} (each < 0.01), mean "
          f"{r16.mean():.3e} (< 0.002)")
    del iqu_e, bb
    torch.cuda.empty_cache()
    # B1 at this path's shape: (48, 1048576) fp32 over Bin2D's full ids
    # (every pixel an id; segments 0 and nseg - 1, about 83 % of the
    # pixels, summed and cut off)
    ids16, nseg16 = bin16._ids, bin16._nseg
    edge16 = ((ids16 == 0) | (ids16 == nseg16 - 1)).double().mean().item()
    data16 = torch.randn((3 * nsim16, g16.npix), generator=gen16, device=dev)
    out = bin_reduce(data16, ids16, nseg16)
    again = bin_reduce(data16, ids16, nseg16)
    ref = bin_reduce_ref(data16, ids16, nseg16)
    absref = bin_reduce_ref(data16.abs(), ids16, nseg16)
    torch.cuda.synchronize()
    err = (out - ref).abs()
    rel = (err / absref.clamp_min(1e-30)).max().item()
    check(rel <= 1e-6 and torch.equal(out, again),
          f"B1 pure-B shape: error {rel:.3e} of binned |data|, or two runs "
          "differ")
    print(f"[16] B1 bin_reduce ({3 * nsim16}, {g16.npix}) nseg={nseg16}: "
          f"{edge16:.4f} of the pixels in the two edge segments Bin2D cuts "
          f"off; max rel err {rel:.3e} of binned |data|, reproducible")
    results["bin_reduce_pureb"] = kernel_entry(
        "bin_reduce_pureb", "bin_reduce.cu", "pallas_kernels.py:94",
        err.max().item())
    results["bin_reduce_pureb"]["launches"] = counts16["bin_reduce"]
    results["bin_reduce"]["launches_by_path"]["pureb"] = \
        counts16["bin_reduce"]
    del data16, out, again, ref, absref, err
    del mg16, pur16, win16
    torch.cuda.empty_cache()
    # untimed card checks of the slice, each against the CPU
    # utils/healpix.smoothing of an nside-512 float64 map at lmax 1024
    # through the ring bridge: B10a and B10s on the card, the plain fp64
    # loop on the CPU
    launches.reset()
    nside16 = 512
    hmap16 = np.random.default_rng(512).standard_normal(12 * nside16 ** 2)
    t0 = time.perf_counter()
    sm_g = healpix.smoothing(hmap16, np.deg2rad(0.5), lmax=1024)
    dt_g = time.perf_counter() - t0
    counts_hp = launches.read(("legendre_ana", "legendre_syn"), "16")
    t0 = time.perf_counter()
    sm_c = healpix.smoothing(hmap16, np.deg2rad(0.5), lmax=1024,
                             device="cpu")
    dt_c = time.perf_counter() - t0
    hp_err = float(np.abs(sm_g - sm_c).max() / np.abs(sm_c).max())
    check(hp_err <= 1e-5, f"16: healpix.smoothing card vs CPU {hp_err:.3e}")
    print(f"[16] utils/healpix.smoothing nside {nside16} lmax 1024 float64 "
          f"(B10a {counts_hp['legendre_ana']}, B10s "
          f"{counts_hp['legendre_syn']} launches; {dt_g:.3f} s with the host "
          f"bridge, CPU {dt_c:.3f} s): {hp_err:.3e} of max (<= 1e-5)")
    for name in ("legendre_ana", "legendre_syn"):
        results[name]["launches_by_path"] = {
            "sht": results[name]["launches"], "healpix": counts_hp[name]}
    del hmap16, sm_g, sm_c
    leg.clear_tables()
    torch.cuda.empty_cache()
    # curved.MapRotatorEquator of a 1024^2 2' float32 GRF centred at dec
    # -40 deg onto a 20 x 12 deg equatorial patch (host float64 positions,
    # float32 weights on both devices)
    g16r = rect_geometry(width_arcmin=n16 * 2.0, px_res_arcmin=2.0,
                         y0_deg=-40.0)
    map16 = grf.MapGen(g16r, ps16[:1, :1], device="cpu").get_map_from_noise(
        grf.rand_kmap(g16r, torch.Generator().manual_seed(40), 1,
                      device="cpu"))
    kw16 = dict(center_source=(g16r.y0, 0.3), patch_width_deg=20.0,
                patch_height_deg=12.0)
    rot_g = curved.MapRotatorEquator(g16r, **kw16).rotate(map16.to(dev))
    rot_c = curved.MapRotatorEquator(g16r, device="cpu", **kw16).rotate(
        map16)
    _, rot_err = rel_err((rot_g.cpu(),), (rot_c,))
    check(rot_c.abs().max() > 0 and rot_err <= 1e-6,
          f"16: MapRotatorEquator card vs CPU {rot_err:.3e}")
    print(f"[16] curved.MapRotatorEquator {tuple(g16r.shape)} at dec -40 "
          f"-> {tuple(rot_g.shape)}: card vs CPU {rot_err:.3e} of max "
          "(<= 1e-6)")
    del map16, rot_g, rot_c
    # inpaint_cg at 256^2 2', float64, the 10' central hole of
    # tests/test_mapstools.py
    g16i = rect_geometry(width_arcmin=256 * 2.0, px_res_arcmin=2.0)
    ells16 = np.arange(th.lpad + 1)
    cltt16 = np.asarray(th.lCl("TT", ells16))
    p2d16 = grf.cl2flat(g16i, ells16, cltt16, dtype=torch.float64,
                        device="cpu") + 1e-4 * cltt16.max()
    mgi = grf.MapGen(g16i, (cltt16 + 1e-4 * cltt16.max())[None, None],
                     dtype=torch.float64, device="cpu")
    gci = torch.Generator().manual_seed(3)
    imap16, rand16 = mgi.get_map(gci), mgi.get_map(gci)
    mask16 = torch.as_tensor((g16i.modrmap_np() > 10 * arcmin).astype(
        np.float64))
    fill_g, it_g = mapstools._inpaint_cg(
        (imap16 * mask16).to(dev), rand16.to(dev), mask16.to(dev),
        p2d16.to(dev), 1e-6, 500, None)
    fill_c, it_c = mapstools._inpaint_cg(imap16 * mask16, rand16, mask16,
                                         p2d16, 1e-6, 500, None)
    _, cg_err = rel_err((fill_g.cpu(),), (fill_c,))
    check(cg_err <= 1e-6, f"16: inpaint_cg card vs CPU {cg_err:.3e}")
    print(f"[16] inpaint_cg 256^2 float64 10' hole, eps 1e-6: {it_g} CG "
          f"iterations on the card, {it_c} on the CPU; card vs CPU "
          f"{cg_err:.3e} of max (<= 1e-6)")
    # nfwfit.mass_estimate on a 64^2 0.5' stamp: a 3e14 halo in white
    # noise from a 2e14 guess
    g16m = Geometry(64, 64, 0.5 * arcmin, 0.5 * arcmin)
    kap16 = nfwfit.nfw_kappa(3e14, g16m.modrmap_np(), Cosmology(),
                             device="cpu") \
        + 1e-3 * torch.randn(g16m.shape, generator=gci, dtype=torch.float64)
    n2d16 = np.full(g16m.shape, 1e-9)
    m_g = nfwfit.mass_estimate(kap16.to(dev), n2d16, g16m, 2e14, 3.2, 0.5)
    m_c = nfwfit.mass_estimate(kap16, n2d16, g16m, 2e14, 3.2, 0.5)
    m_err = max(abs(a - b) / abs(b) for a, b in zip(m_g, m_c))
    check(m_err <= 1e-4, f"16: mass_estimate card vs CPU {m_err:.3e}")
    print(f"[16] nfwfit.mass_estimate 64^2: mass {m_g[0]:.6e} (card), "
          f"{m_c[0]:.6e} (CPU), {m_err:.3e} relative (<= 1e-4)")


def distributed_phase(dev, card, results, launches, geom, th):
    """Phase 17: the distributed layer (parallel/) on a one-rank NCCL group
    and a (1, 1) mesh: each leg at a size users run, held to the serial
    path; the S = 4 split of each run as four threads of this process
    (runtime.emulate) on the same inputs. Launches count only in the mesh
    runs (dist_run)."""
    tally17 = {k: 0 for k in ("bin_reduce", "lens_map_kernel",
                              "legendre_ana", "legendre_syn")}

    def dist_run(fn):
        """``fn()`` with the launch counts from 0; its launches join the
        phase's"""
        launches.reset()
        out = fn()
        torch.cuda.synchronize()
        for k in tally17:
            tally17[k] += launches.count(k)
        return out

    t17 = time.perf_counter()
    store17 = tempfile.TemporaryDirectory()
    t0 = time.perf_counter()
    check(prt.init_multihost(init_method="file://" + store17.name + "/store",
                             world_size=1, rank=0,
                             local_rank=torch.cuda.current_device(),
                             device=dev, timeout=300) == (0, 1),
          "17: init_multihost")
    mesh17 = prt.get_mesh((1, 1), device=dev)
    check(dist.get_backend() == "nccl" and mesh17.device_mesh is not None,
          "17: not a NCCL DeviceMesh")
    print(f"[17] one-rank NCCL group (file store) and a (1, 1) DeviceMesh "
          f"in {time.perf_counter() - t0:.3f} s")
    # (a) ensemble_stats of the flagship step at entry()'s size (512^2,
    # 2'), 64 sims, chunk 16, against a plain loop of step() on the same
    # task generators
    step17 = build_qe_pipeline(geom, th, device=dev)
    labels17 = ("cross", "auto_in", "auto_rec")

    def sim17(g):
        return dict(zip(labels17, step17.step(g)))

    nsims17, seed17 = 64, 17
    # warm-up: a 2-sim ensemble, whose all-reduce sets up the sims axis's
    # NCCL communicator
    t0 = time.perf_counter()
    prt.ensemble_stats(sim17, 2, seed=seed17, mesh=mesh17)
    torch.cuda.synchronize()
    dt_warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    st17 = dist_run(lambda: prt.ensemble_stats(sim17, nsims17, seed=seed17,
                                               mesh=mesh17, chunk=16))
    dt_ens = time.perf_counter() - t0
    t0 = time.perf_counter()
    outs17 = [step17.step(prt.task_generator(seed17, i, dev))
              for i in range(nsims17)]
    torch.cuda.synchronize()
    dt_loop = time.perf_counter() - t0
    ens_err = 0.0
    for j, k in enumerate(labels17):
        x17 = torch.stack([o[j] for o in outs17])
        ser = SuffStats.zeros(x17.shape[1], device=dev).add(x17)
        for f in ("n", "s", "ss"):
            ens_err = max(ens_err, rel_err((getattr(st17[k], f),),
                                           (getattr(ser, f),))[1])
    check(ens_err <= 1e-6, f"17: ensemble_stats vs serial SuffStats "
                           f"{ens_err:.3e}")
    print(f"[17a] ensemble_stats of the flagship step 512^2 2', {nsims17} "
          f"sims, chunk 16: {nsims17 / dt_ens:.2f} sims/s ({dt_ens:.3f} s) "
          f"against a plain loop of step() {nsims17 / dt_loop:.2f} sims/s "
          f"({dt_loop:.3f} s), after a 2-sim warm-up ensemble ({dt_warm:.3f} "
          f"s with the communicator's set-up); N, sum, sum x x^T vs a serial "
          f"SuffStats of the same outputs {ens_err:.3e} of max (<= 1e-6) on "
          f"{card}")
    del outs17, step17
    # (b) masked bandpowers at 4096^2, 0.5' (34 deg), 12 % taper, edges
    # arange(80, 8000, 400) (tests/test_parallel.py:330), against the
    # serial power (torch.fft.fft2, |Z|^2) binned by B1's plain version
    # (float64 index_add_)
    n17 = 4096
    g17 = rect_geometry(width_arcmin=n17 * 0.5, px_res_arcmin=0.5)
    gen17 = torch.Generator(device=dev).manual_seed(170)
    m17 = torch.randn((n17, n17), generator=gen17, device=dev)
    taper17 = get_taper(g17, taper_percent=12.0, device=dev)[0].to(
        torch.float32).contiguous()
    edges17 = np.arange(80, 8000, 400.0)
    dig17 = np.digitize(g17.modlmap_np(), edges17).astype(np.int32)
    dig17[dig17 == len(edges17)] = 0
    dig17 = torch.as_tensor(dig17, device=dev)
    nb17 = len(edges17) - 1
    norm17 = float(g17.area) / float(g17.npix) ** 2
    ids17 = torch.where((dig17 >= 1) & (dig17 <= nb17), dig17 - 1,
                        -1).to(torch.int32).reshape(-1).contiguous()
    cnt17 = torch.bincount(ids17[ids17 >= 0].long(), minlength=nb17)

    def bp_dist(mesh):
        return pfourier.masked_bandpowers_dist(m17, taper17, dig17, nb17,
                                               norm17, mesh)

    def power17():
        z = torch.fft.fft2((m17 * taper17).to(torch.complex64))
        return ((z.real * z.real + z.imag * z.imag) * norm17).reshape(
            1, -1).contiguous()

    bp_d = dist_run(lambda: bp_dist(mesh17))
    bp_s = (bin_reduce_ref(power17(), ids17, nb17)[0].double()
            / cnt17.clamp_min(1)).float()
    t0 = time.perf_counter()
    bp_e = prt.emulate(bp_dist, (1, 4), device=dev)
    torch.cuda.synchronize()
    dt_emul = time.perf_counter() - t0
    bp_err = ((bp_d - bp_s).abs() / bp_s.abs()).max().item()
    bp_eerr = max(((b - bp_s).abs() / bp_s.abs()).max().item() for b in bp_e)
    check(bp_err <= 1e-5 and bp_eerr <= 1e-5, f"17: masked bandpowers "
          f"{bp_err:.3e}, S = 4 {bp_eerr:.3e} of the plain binning")
    print(f"[17b] masked_bandpowers_dist 4096^2 0.5' ({nb17} bins) on the "
          f"(1, 1) mesh (B1 also counting the bins' pixels), the S = 4 split "
          f"in one process {dt_emul:.3f} s (host clock, first call); max "
          f"relative error per bin vs the serial power binned in float64 "
          f"(plain version) {bp_err:.3e}, S = 4 {bp_eerr:.3e} (<= 1e-5)")
    del m17, taper17, dig17, ids17, bp_e
    torch.cuda.empty_cache()
    # (c) the ring-split SHT at lmax 2047 (bench config 7's size) and the
    # spin analysis at lmax 1023, B10a/B10s in layout "full", against the
    # serial folded transforms, within the dd contract (3.2e-6 of max)
    lmax17 = 2047
    rings17 = sht.gauss_legendre_rings(lmax17)
    n17a = almops.nalm(lmax17)
    a17 = torch.complex(torch.randn(n17a, generator=gen17, device=dev),
                        torch.randn(n17a, generator=gen17, device=dev))
    a17[: lmax17 + 1] = a17[: lmax17 + 1].real.to(a17.dtype)
    map17 = sht.alm2map(a17, rings17, lmax17)
    t0 = time.perf_counter()
    a_dist = dist_run(lambda: psht.map2alm_dist(map17, rings17, lmax17,
                                                mesh17))
    m_dist = dist_run(lambda: psht.alm2map_dist(a17, rings17, lmax17,
                                                mesh17))
    dt_first = time.perf_counter() - t0
    a_ser = sht.map2alm(map17, rings17, lmax17)
    t0 = time.perf_counter()
    a_em = prt.emulate(lambda mm: psht.map2alm_dist(
        map17, rings17, lmax17, mm, axis="grid"), (1, 4), device=dev)
    m_em = prt.emulate(lambda mm: psht.alm2map_dist(
        a17, rings17, lmax17, mm, axis="grid"), (1, 4), device=dev)
    torch.cuda.synchronize()
    dt_emul = time.perf_counter() - t0
    errs = {"map2alm": rel_err((a_dist,), (a_ser,))[1],
            "alm2map": rel_err((m_dist,), (map17,))[1],
            "map2alm S=4": max(rel_err((a,), (a_ser,))[1] for a in a_em),
            "alm2map S=4": max(rel_err((m,), (map17,))[1] for m in m_em)}
    check(max(errs.values()) <= 3.2e-6, f"17: ring-split SHT {errs}")
    print(f"[17c] ring-split SHT lmax {lmax17}, one map, dd, layout full: "
          f"first calls with the capture passes {dt_first:.3f} s, the S = 4 "
          f"split {dt_emul:.3f} s; error of max vs serial: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + " (<= 3.2e-6)")
    # the B10a/B10s record at layout "full", lmax 2047, one map: the
    # kernel vs its plain version
    tab17 = leg.tables(lmax17, rings17, (0,), 0, "full", dev)
    M17 = lmax17 + 1
    G17 = torch.complex(*(torch.randn((1, tab17["Tr"], M17), generator=gen17,
                                      device=dev) for _ in range(2)))
    A17 = torch.complex(*(torch.randn((1, M17, M17), generator=gen17,
                                      device=dev) for _ in range(2)))
    for name, fn, ref_fn, x in (
            ("legendre_ana", leg.legendre_ana, leg.legendre_ana_ref, G17),
            ("legendre_syn", leg.legendre_syn, leg.legendre_syn_ref, A17)):
        err, rel = rel_err((fn(x, tab17),), (ref_fn(x, tab17),))
        check(rel <= 1e-6, f"17: {name} full lmax {lmax17}: {rel:.3e} of "
                           "max|ref|")
        results[name + "_full"] = kernel_entry(
            name + "_full", "legendre.cu", "pallas_sht.py:1230,1325"
            if name == "legendre_ana" else "pallas_sht.py:1273,1379", err)
        print(f"[17c] {name} layout full lmax {lmax17} x1 dd: max abs err "
              f"{err:.3e} = {rel:.3e} of max|ref| (<= 1e-6)")
    del G17, A17, a_em, m_em, a_dist, m_dist, a_ser, map17, a17
    # the spin analysis at lmax 1023 (bench config 8p's size)
    lmax17s = 1023
    rings17s = sht.gauss_legendre_rings(lmax17s)
    n17s = almops.nalm(lmax17s)
    e17, b17 = (torch.complex(torch.randn(n17s, generator=gen17, device=dev),
                              torch.randn(n17s, generator=gen17, device=dev))
                for _ in range(2))
    q17, u17 = sht.alm2map_spin(e17, b17, rings17s, lmax17s)
    eb_dist = dist_run(lambda: psht.map2alm_spin_dist(q17, u17, rings17s,
                                                      lmax17s, mesh17))
    eb_ser = sht.map2alm_spin(q17, u17, rings17s, lmax17s)
    eb_em = prt.emulate(lambda mm: psht.map2alm_spin_dist(
        q17, u17, rings17s, lmax17s, mm, axis="grid"), (1, 4), device=dev)
    sp_err = rel_err(eb_dist, eb_ser)[1]
    sp_eerr = max(rel_err(eb, eb_ser)[1] for eb in eb_em)
    check(max(sp_err, sp_eerr) <= 3.2e-6, f"17: map2alm_spin_dist "
          f"{sp_err:.3e}, S = 4 {sp_eerr:.3e}")
    print(f"[17c] map2alm_spin_dist lmax {lmax17s}: error of max vs serial "
          f"{sp_err:.3e}, S = 4 {sp_eerr:.3e} (<= 3.2e-6)")
    del e17, b17, q17, u17, eb_dist, eb_ser, eb_em
    leg.clear_tables()
    torch.cuda.empty_cache()
    # (d) the row-split lensed covariance at 32^2 (npix 1024, phase 15's
    # lens_cov), B8 on each rank's rows, against nfwfit.lens_cov
    g17c = Geometry(32, 32, 0.5 * arcmin, 0.5 * arcmin)
    ucov17 = pixcov.scov_from_theory(g17c, th, lambda l: gauss_beam(l, 1.4),
                                     ncomp=1, dtype=torch.float32)
    alpha17 = lensing.alpha_from_kappa(nfwfit.nfw_kappa(
        1e15, g17c.modrmap_np(), Cosmology()).to(torch.float32),
        g17c).contiguous()
    lc_d = dist_run(lambda: pfourier.lens_cov_dist(ucov17, alpha17, g17c,
                                                   mesh17, lens_order=5))
    lc_s = nfwfit.lens_cov(ucov17, alpha17, g17c, lens_order=5)
    lc_e = prt.emulate(lambda mm: pfourier.lens_cov_dist(
        ucov17, alpha17, g17c, mm, lens_order=5), (2, 2), device=dev)
    lc_err = rel_err((lc_d,), (lc_s,))[1]
    lc_eerr = max(rel_err((c,), (lc_s,))[1] for c in lc_e)
    check(max(lc_err, lc_eerr) <= 1e-6, f"17: lens_cov_dist {lc_err:.3e}, "
          f"S = 4 {lc_eerr:.3e} of max")
    print(f"[17d] lens_cov_dist (1024, 1024) at 32^2 order 5: vs "
          f"nfwfit.lens_cov {lc_err:.3e} of max, the S = 4 row split "
          f"{lc_eerr:.3e} (<= 1e-6)")
    del ucov17, alpha17, lc_d, lc_s, lc_e
    dist.destroy_process_group()
    store17.cleanup()
    # (e) the dry run on one card: its own one-rank NCCL group
    t0 = time.perf_counter()
    dist_run(lambda: dryrun_multichip(1))
    check(not dist.is_initialized(), "17: the dry run left its group")
    print(f"[17e] entry.dryrun_multichip(1) over NCCL: every leg within its "
          f"gate in {time.perf_counter() - t0:.3f} s")
    for k, v in tally17.items():
        check(v > 0, f"17: {k} was not launched on the distributed path")
    # every B10 launch counted here is a layout-"full" call of a
    # distributed transform (the dry run's references run the plain
    # analysis): B10a for map2alm_dist at lmax 2047, the two of
    # map2alm_spin_dist and the dry run's two; B10s for alm2map_dist at
    # lmax 2047 and the dry run's
    check((tally17["legendre_ana"], tally17["legendre_syn"]) == (5, 2),
          f"17: B10a/B10s launched {tally17['legendre_ana']}/"
          f"{tally17['legendre_syn']} times on the distributed path, not 5/2")
    print(f"[17] launches on the distributed path: {tally17}; the phase "
          f"took {time.perf_counter() - t17:.3f} s")
    for k in ("bin_reduce", "lens_map_kernel", "legendre_ana",
              "legendre_syn"):
        results[k]["launches_by_path"]["dist"] = tally17[k]
    for k in ("legendre_ana", "legendre_syn"):
        results[k + "_full"]["launches"] = tally17[k]
    torch.cuda.empty_cache()


def catalog_phase(dev, card, results, launches):
    """Phase 18: the galaxy-catalog slice (models/catalogs) at a survey's
    size: a 2048^2 0.5' patch (17 deg square, ~291 deg^2, a DES/HSC-size
    field). (a) Pow2Cat mocks at 3 galaxies/arcmin^2 in float64, 8 a step,
    as tests/test_facade.py:68-100 runs them: correlated (delta_g, kappa)
    from Limber spectra (LimberCosmology with catalogs.dndz, bias 1.5),
    Poisson counts, delta_g from the counts, fft2 of both, the three power
    planes, one Bin2D of all of them (one float64 B1 launch a step); (b)
    binned_map of 10^7 weighted sources; (c) healpix_binned_map of the same
    at nside 2048; (d) reconstruct_velocities of 10^6 galaxies and 10^7
    randoms at nmesh 256 (a BOSS-CMASS-size run)."""
    t18 = time.perf_counter()
    g18 = rect_geometry(width_arcmin=2048 * 0.5, px_res_arcmin=0.5)
    t0 = time.perf_counter()
    lc18 = LimberCosmology(numz=300, nz_pk=200, nk_pk=300, device=dev)
    zs18 = np.linspace(0.01, 4.0, 300)
    lc18.addNz("g", zs18, cats.dndz(zs18), bias=1.5)
    ells18 = np.arange(3001.0)
    lc18.generateCls(ells18)
    clgg18, clkg18, clkk18 = (lc18.getCl("g", "g"), lc18.getCl("cmb", "g"),
                              lc18.getCl("cmb", "cmb"))
    check(bool(np.all(np.isfinite([clgg18, clkg18, clkk18]))),
          "18: Limber spectra not finite")
    p2c = cats.Pow2Cat(g18, ells18, clgg18, clkg18, clkk18,
                       ngal_per_arcmin2=3.0)
    check(p2c.mgen.covsqrt.is_cuda
          and p2c.mgen.covsqrt.dtype == torch.float64,
          "18: Pow2Cat's covsqrt is not float64 on the card")
    bin18 = Bin2D(g18.modlmap_np(), CAT_EDGES)
    print(f"[18] Limber spectra (ell 0..3000, bias 1.5, dndz z0 1/3) and "
          f"Pow2Cat / Bin2D tables in {time.perf_counter() - t0:.3f} s; "
          f"nbar {p2c.nbar:.4f} galaxies a pixel")
    gen18 = torch.Generator(device=dev).manual_seed(18)
    nmock = 8
    norm18 = g18.area / g18.npix ** 2

    def spectra18(counts, kappa):
        """(B, 3, nbins) float64 binned <dg k>, <dg dg>, <k k>: one B1"""
        dg = counts / counts.mean(dim=(-2, -1), keepdim=True) - 1.0
        kd, kk = torch.fft.fft2(dg), torch.fft.fft2(kappa)
        planes = torch.stack([(kd.conj() * kk).real,
                              kd.real ** 2 + kd.imag ** 2,
                              kk.real ** 2 + kk.imag ** 2], 1) * norm18
        return bin18.bin(planes)[1]

    def step18():
        counts, kappa = p2c.get_cat(gen18, batch=(nmock,))
        return spectra18(counts, kappa)

    cell18 = (f"2048^2 0.5' (~291 deg^2), 3 gal/arcmin^2, float64, "
              f"{nmock} mocks a step, {len(CAT_EDGES) - 1} bins")
    launches.reset()
    base18 = torch.cuda.memory_allocated()
    throughput(step18, nmock, 4, f"Pow2Cat mocks -> binned spectra {cell18}",
               "mocks/s", card, "18")
    peak18 = (torch.cuda.max_memory_allocated() - base18) / 1e9
    counts18 = launches.read(("bin_reduce",), "18")
    f64_18 = bin_reduce.launches_f64
    check(counts18["bin_reduce"] == 6 and f64_18 == 6,
          f"18: {counts18['bin_reduce']} B1 launches ({f64_18} float64) in "
          "6 steps (2 warm-up, 4 timed)")
    print(f"[18] peak memory {peak18:.3f} GB above the {base18 / 1e9:.3f} GB "
          f"held before; B1 launches {counts18['bin_reduce']} in 6 steps, "
          f"all {f64_18} on float64 data")
    # gate: Poisson counts by statistics, counts - lambda over the pixels
    # of 8 mocks: mean 0 and variance <lambda> within 5 sigma
    delta, kappa = p2c.get_maps(gen18, batch=(nmock,))
    lam = torch.clamp(p2c.nbar * (1.0 + delta), min=0.0)
    res = p2c.counts_from_delta(delta, gen18) - lam
    n18 = res.numel()
    lbar = lam.mean().item()
    sd_var = math.sqrt((lbar + 2 * (lam ** 2).mean().item()) / n18)
    pm, pv = res.mean().item(), res.var().item()
    check(abs(pm) <= 5 * math.sqrt(lbar / n18)
          and abs(pv - lbar) <= 5 * sd_var,
          f"18: Poisson counts - lambda: mean {pm:.3e}, variance {pv:.6f} "
          f"against <lambda> {lbar:.6f}")
    print(f"[18] Poisson counts - lambda over {n18} pixels: mean {pm:.3e} "
          f"({abs(pm) / math.sqrt(lbar / n18):.2f} sigma), variance "
          f"{pv:.6f} against <lambda> {lbar:.6f} "
          f"({abs(pv - lbar) / sd_var:.2f} sigma; <= 5)")
    del delta, kappa, lam, res
    # gate: the recovery of <delta_g kappa> over 32 mocks, each bin within
    # 5 sigma (the mocks' scatter / sqrt(32)) of the same Bin2D of clkg
    # painted on the l-plane
    launches.reset()
    sp18 = torch.cat([step18() for _ in range(4)]).cpu().numpy()
    check(bin_reduce.launches_f64 == 4, "18: the recovery's 4 B1 launches "
                                        "were not all float64")
    want18 = bin18.bin(grf.cl2flat(g18, ells18, clkg18, dtype=torch.float64,
                                   device=dev))[1].cpu().numpy()
    mean18 = sp18[:, 0].mean(axis=0)
    sig18 = sp18[:, 0].std(axis=0, ddof=1) / math.sqrt(sp18.shape[0])
    nsig18 = np.abs(mean18 - want18) / sig18
    check(bool(np.all(np.isfinite(sp18))) and bool(np.all(nsig18 <= 5.0)),
          f"18: <dg kappa> over {sp18.shape[0]} mocks off by {nsig18} sigma")
    print(f"[18] <delta_g kappa> over {sp18.shape[0]} mocks vs Bin2D of the "
          f"painted clkg: |mean - theory| / sigma max {nsig18.max():.3f} "
          f"(<= 5), ratio {np.round(mean18 / want18, 4).tolist()}")
    # gate: Pow2Cat.get_maps_from_noise, card vs CPU on the same noise (one
    # mock at full size)
    eta18 = grf.rand_kmap(g18, torch.Generator().manual_seed(181), 2,
                          dtype=torch.float64, device="cpu")
    p2c_c = cats.Pow2Cat(g18, ells18, clgg18, clkg18, clkk18,
                         ngal_per_arcmin2=3.0, device="cpu")
    mg_g = p2c.get_maps_from_noise(eta18.to(dev))
    mg_c = p2c_c.get_maps_from_noise(eta18)
    _, m18_err = rel_err(tuple(m.cpu() for m in mg_g), mg_c)
    check(m18_err <= 1e-10, f"18: get_maps_from_noise card vs CPU "
                            f"{m18_err:.3e} of max > 1e-10")
    print(f"[18] Pow2Cat.get_maps_from_noise 2048^2 float64, card vs CPU on "
          f"the same noise: {m18_err:.3e} of max (<= 1e-10)")
    del eta18, p2c_c, mg_g, mg_c
    # (b) binned_map of 10^7 weighted random sources into the 2048^2 map
    nsrc = 10 ** 7
    decs18, ras18 = cats.random_catalog_flat(gen18, g18, nsrc, device=dev)
    w18 = torch.rand(nsrc, generator=gen18, device=dev,
                     dtype=torch.float64) + 0.5
    cnt_g = cats.binned_map(decs18, ras18, g18)
    wm_g = cats.binned_map(decs18, ras18, g18, w18)
    cnt_c = cats.binned_map(decs18.cpu(), ras18.cpu(), g18)
    wm_c = cats.binned_map(decs18.cpu(), ras18.cpu(), g18, w18.cpu())
    check(torch.equal(cnt_g.cpu(), cnt_c), "18: binned_map counts differ "
                                           "between the card and the CPU")
    _, bm_err = rel_err((wm_g.cpu(),), (wm_c,))
    check(bm_err <= 1e-12, f"18: weighted binned_map card vs CPU "
                           f"{bm_err:.3e} > 1e-12")
    print(f"[18] binned_map of {nsrc} weighted sources into 2048^2, card vs "
          f"CPU: counts equal ({int(cnt_g.sum().item())} in the "
          f"map), weighted {bm_err:.3e} of max (<= 1e-12)")
    del cnt_g, wm_g, cnt_c, wm_c
    # (c) healpix_binned_map of the same sources at nside 2048: ang2pix on
    # the host (the native library, built in phase 1), the counts by
    # index_add_ on the card
    hp_g = cats.healpix_binned_map(decs18, ras18, 2048)
    hp_c = cats.healpix_binned_map(decs18.cpu(), ras18.cpu(), 2048)
    check(torch.equal(hp_g.cpu(), hp_c) and int(hp_c.sum().item()) == nsrc,
          "18: healpix_binned_map card vs CPU")
    print(f"[18] healpix_binned_map of {nsrc} sources at nside 2048 "
          f"(native library: {healpix.have_native()}; host ang2pix, copies, "
          "index_add_): equal to the CPU's")
    del hp_g, hp_c, decs18, ras18, w18
    torch.cuda.empty_cache()
    # (d) reconstruct_velocities: 10^6 galaxies (uniform, and 10 % in a
    # clump) and 10^7 randoms over a 20 x 20 deg, 0.43 < z < 0.7 volume
    rng18 = np.random.default_rng(18)
    ng18, nr18 = 10 ** 6, 10 ** 7

    def shell(n):
        return (rng18.uniform(-10, 10, n), rng18.uniform(-10, 10, n),
                rng18.uniform(0.43, 0.7, n))

    ra_g, dec_g, z_g = shell(ng18 - ng18 // 10)
    nc = ng18 // 10
    ra_g = np.concatenate([ra_g, rng18.normal(0, 0.7, nc)])
    dec_g = np.concatenate([dec_g, rng18.normal(0, 0.7, nc)])
    z_g = np.clip(np.concatenate([z_g, rng18.normal(0.55, 0.012, nc)]),
                  0.43, 0.7)
    ra_r, dec_r, z_r = shell(nr18)
    cat_g = [torch.as_tensor(a, device=dev) for a in (ra_g, dec_g, z_g,
                                                      ra_r, dec_r, z_r)]
    kw18 = dict(zeff=0.55, nmesh=256, smoothing_radius=10.0)
    v_g = cats.reconstruct_velocities(*cat_g, **kw18)
    v_c = cats.reconstruct_velocities(ra_g, dec_g, z_g, ra_r, dec_r, z_r,
                                      device="cpu", **kw18)
    _, v_err = rel_err((v_g.cpu(),), (v_c,))
    check(bool(torch.isfinite(v_g).all()) and v_err <= 1e-8,
          f"18: reconstruct_velocities card vs CPU {v_err:.3e} > 1e-8")
    vc = v_c.numpy()[ng18 - nc:]
    zc = z_g[ng18 - nc:]
    front = vc[(zc > 0.52) & (zc < 0.545)].mean()
    behind = vc[(zc > 0.555) & (zc < 0.58)].mean()
    print(f"[18] reconstruct_velocities {ng18} galaxies, {nr18} randoms, "
          f"nmesh 256: card vs CPU {v_err:.3e} of max |v| (<= 1e-8); the "
          "clump's mean LOS "
          f"velocity in front {front:.2f}, behind {behind:.2f} km/s")
    del cat_g, v_g, v_c
    # JAX's infall sign test (tests/test_surveys.py:122-150) on the card
    rng3 = np.random.default_rng(3)
    nr, ngu, ngc = 40000, 8000, 4000
    ras_r, decs_r, zs_r = (rng3.uniform(-10, 10, nr),
                           rng3.uniform(-10, 10, nr),
                           rng3.uniform(0.4, 0.7, nr))
    ras3 = np.concatenate([rng3.uniform(-10, 10, ngu),
                           rng3.normal(0, 0.7, ngc)])
    decs3 = np.concatenate([rng3.uniform(-10, 10, ngu),
                            rng3.normal(0, 0.7, ngc)])
    zs3 = np.clip(np.concatenate([rng3.uniform(0.4, 0.7, ngu),
                                  rng3.normal(0.55, 0.012, ngc)]), 0.4, 0.7)
    v3 = cats.reconstruct_velocities(ras3, decs3, zs3, ras_r, decs_r, zs_r,
                                     zeff=0.55, nmesh=64,
                                     smoothing_radius=15.0).cpu().numpy()
    check(v3.dtype == np.float64 and bool(np.all(np.isfinite(v3))),
          "18: infall test output")
    vc3, zc3 = v3[ngu:], zs3[ngu:]
    f3 = vc3[(zc3 > 0.52) & (zc3 < 0.545)].mean()
    b3 = vc3[(zc3 > 0.555) & (zc3 < 0.58)].mean()
    check(f3 > 10.0 and b3 < -10.0, f"18: infall sign test {f3:.2f}, "
                                    f"{b3:.2f} km/s")
    print(f"[18] tests/test_surveys.py's infall test on the card: in front "
          f"{f3:.2f} km/s (> 10), behind {b3:.2f} km/s (< -10)")
    results["bin_reduce_f64"]["launches"] = f64_18
    results["bin_reduce"]["launches_by_path"]["catalog"] = \
        counts18["bin_reduce"]
    print(f"[18] the phase took {time.perf_counter() - t18:.3f} s")
    torch.cuda.empty_cache()


def examples_phase(dev, card, results, launches):
    """Phase 19: the user examples (examples/torch/) on the card, in this
    process as a user runs them: each at its default (not quick) size with
    --no-plot, device None (the card), tt_verification at 512 sims; the
    distributed pair on a one-rank NCCL group set up here as phase 17 sets
    up its own. Each example's launches from 0, its wall seconds and its
    check line; every kernel call held to its plain version; the seven
    forecasts also with --device cpu, their printed numbers held to the
    card's (QUICK_CMP19: both sides at the quick size)."""
    t19 = time.perf_counter()
    ex_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "examples", "torch")
    check(sorted(f for f in os.listdir(ex_dir) if f.endswith(".py"))
          == sorted(n for n, _, _ in EXAMPLES19),
          f"19: {ex_dir} does not hold the fifteen examples")
    os.environ.pop("ORPHICS_TPU_EXAMPLE_QUICK", None)

    plain19 = plain_versions()
    recorder = CallRecorder({fn: v[0] for fn, v in plain19.items()},
                            launches.count)
    store19 = tempfile.TemporaryDirectory()
    tally19 = {k: 0 for k in launches.counters}
    full19 = {"legendre_ana": 0, "legendre_syn": 0}
    rows19 = []
    for name, argv, need in EXAMPLES19:
        path = os.path.join(ex_dir, name)
        group = name in ("mesh_ensemble.py", "distributed_fft.py")
        if group:
            check(prt.init_multihost(
                init_method="file://" + store19.name + "/" + name,
                world_size=1, rank=0, local_rank=torch.cuda.current_device(),
                device=dev, timeout=300) == (0, 1), "19: init_multihost")
            check(dist.get_backend() == "nccl", "19: not a NCCL group")
        launches.reset()
        with recorder:
            out, code, secs = run_example(path, argv + ["--no-plot"])
        counts = {k: launches.count(k) for k in launches.counters}
        recs = list(recorder.records.values())
        recorder.records = {}
        if group:
            dist.destroy_process_group()
        for line in out.splitlines():
            print(f"[19] {name}: {line}")
        check(code == 0, f"19: {name} exited {code}")
        # every launch came through a recorded call; the required kernels
        # (kernel@layout: on Legendre tables of that layout) launched
        for k, v in counts.items():
            seen = sum(r["launches"] for r in recs if r["key"] == k)
            check(seen == v, f"19: {name}: {v} {k} launches, {seen} of them "
                             "in recorded calls")
        for item in need:
            k, _, layout = item.partition("@")
            n = sum(r["launches"] for r in recs if r["key"] == k
                    and (not layout or r["layout"] == layout))
            check(n > 0, f"19: {name} launched no {item}")
        for k, v in counts.items():
            tally19[k] += v
        for r in recs:
            if r["layout"] == "full":
                full19[r["key"]] += r["launches"]
            e, t = plain_gap(r, plain19)
            check(e <= t, f"19: {name}: {r['sig']}: kernel vs plain version "
                          f"{e:.3e} > {t}")
            print(f"[19] {name}: {r['sig']}: {r['calls']} calls, "
                  f"{r['launches']} launches; on the first call's inputs "
                  f"kernel vs plain version {e:.3e} (<= {t})")
        del recs
        key = CHECK19.get(name, "gate: ")
        lines = [ln for ln in out.splitlines() if ln.startswith(key)]
        check(lines and "FAILED" not in out, f"19: {name}'s check line")
        gate = lines[-1]
        if name in DETERMINISTIC19:
            out_g = out
            if name in QUICK_CMP19:
                os.environ["ORPHICS_TPU_EXAMPLE_QUICK"] = "1"
                out_g, code_g, _ = run_example(path, argv + ["--no-plot"])
                check(code_g == 0, f"19: {name} quick exited {code_g}")
            out_c, code_c, secs_c = run_example(path, argv + [
                "--device", "cpu", "--no-plot"])
            os.environ.pop("ORPHICS_TPU_EXAMPLE_QUICK", None)
            check(code_c == 0, f"19: {name} on the CPU exited {code_c}")
            try:
                cpu = text_gap(out_g, out_c, 1e-6)
            except ValueError as e:
                check(False, f"19: {name}: card vs CPU: {e}")
            check(cpu <= 1.0, f"19: {name}: card vs CPU {cpu:.3f} units "
                              "of the printed precision")
            both = ", both at the quick size" if name in QUICK_CMP19 else ""
            gate += (f"; card vs CPU {cpu:.3f} of the printed precision "
                     f"(<= 1{both}; CPU run {secs_c:.3f} s)")
        launched = {k: v for k, v in counts.items() if v}
        print(f"[19] {name}: {secs:.3f} s on the card, launches {launched}"
              f" (required: {', '.join(need) or 'none'}); check: {gate}")
        rows19.append((name, secs))
        torch.cuda.empty_cache()
    store19.cleanup()
    print("[19] fifteen examples at default size: "
          + ", ".join(f"{n} {t:.3f} s" for n, t in rows19)
          + f"; launches in all {({k: v for k, v in tally19.items() if v})}"
          f"; the phase took {time.perf_counter() - t19:.3f} s on {card}")
    for k, v in tally19.items():
        if v:
            results[k].setdefault("launches_by_path", {})["examples"] = v
    for k, v in full19.items():
        results[k + "_full"].setdefault("launches_by_path", {})[
            "examples"] = v


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[0] card: {card}")
    print(f"[0] device: {kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; devices visible: {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    _build.library()
    print(f"[1] build: {time.perf_counter() - t0:.3f} s (nvcc "
          f"{' '.join(_build.NVCC_FLAGS)}, one process per source)")
    for line in _build.build_log().splitlines():
        if ("registers" in line or "spill" in line or "Compiling" in line
                or line.startswith("==")):
            print("[1]   " + line.strip())
    t0 = time.perf_counter()
    check(_build.healpix_library() is not None, "the native HEALPix "
          "library did not build: " + _build.healpix_build_log())
    print(f"[1] host library csrc/healpix.cpp: {time.perf_counter() - t0:.3f}"
          f" s (g++ {' '.join(_build.HOST_FLAGS)})")

    # the records of phase 2, the launch counters and the 512^2 2'
    # geometry, theory and generator that phases 2, 4 and 5 draw from
    results = {}
    launches = Launches()
    geom = rect_geometry(width_arcmin=512 * 2.0, px_res_arcmin=2.0)
    th = default_theory()
    gen = torch.Generator(device=dev).manual_seed(1234)
    kernels_phase(dev, results, gen, geom, th)
    flagship_phase(dev, results, launches)
    half_plane_phase(dev, card, launches, gen, geom, th)
    full_plane_phase(dev, results, launches, gen, geom, th)
    fastcl_phase(dev, results, launches, th)
    cross_spectra_phase(dev, results, launches, th)
    ilc_phase(dev, card, results, launches, geom, th)
    sht_roundtrip_phase(dev, card, results, launches)
    curved_spectra_phase(dev, card, results, launches)
    q3 = qe_recon_phase(dev, card, launches, geom, th)
    pair_spectra_phase(dev, card, results, launches, th)
    debias_phase(dev, card, results, launches, geom, th, q3)
    del q3
    stacking_phase(dev, card, results, launches, th)
    pure_b_phase(dev, card, results, launches, th)
    distributed_phase(dev, card, results, launches, geom, th)
    catalog_phase(dev, card, results, launches)
    examples_phase(dev, card, results, launches)
    curved_qe_phase(dev, card, results, launches.reset, launches.read)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err")
    for r in results.values():
        check(all(k in r for k in keys), f"{r['name']}: record lacks "
              f"{[k for k in keys if k not in r]}")
    print(json.dumps({"kernels": [results[k] for k in launches.counters]
                      + [results[k] for k in (
                          "bin_reduce_config5", "bin_reduce_pureb",
                          "bin_reduce_f64", "legendre_ana_full",
                          "legendre_syn_full", "legendre_ana_qe",
                          "legendre_syn_qe")]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
