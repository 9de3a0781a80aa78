"""The port's spans (``utils/profiling.span`` / ``spanned``) and the
benchmark's reading of them (``cmbbench/spans.py``), on the CPU:

  * with no profiler running a span is the shared null context and enters
    no ``record_function``; it follows the profiler's flag as read at the
    call;
  * under ``torch.profiler`` the stage and layer spans of the full- and
    half-plane ``LensedQEPipeline.step``, ``FastCl``'s sims, cross and map
    spectra and ``QE.kappa_from_map`` nest as the stages run, and the
    outputs are bit-equal to those of an untraced call;
  * the reader, on a hand-built Chrome trace of two steps, gives exact
    launches, host ms, self ms, estimator ms and idle share, and
    ``Tracer.read`` gives its readings of the same trace.
"""
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import orphics_tpu_torch as tp
from cmbbench import spans as S
from cmbbench.trace import Tracer
from orphics_tpu_torch.models import lenspipe as tpipe, theory as ttheory
from orphics_tpu_torch.models.fastcl import FastCl
from orphics_tpu_torch.ops import dft as D
from orphics_tpu_torch.utils import profiling as P

torch.set_num_threads(1)


# ---- the primitive --------------------------------------------------------

class _Range:
    """Stands in for ``record_function``: records the names entered."""
    entered = []

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        _Range.entered.append(self.name)

    def __exit__(self, *exc):
        return False


def _refuse(name):
    raise AssertionError(f"record_function({name!r}) entered")


def test_span_without_profiler_is_the_shared_null_context(monkeypatch):
    assert not torch.autograd.profiler._is_profiler_enabled
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    assert P.span("orphics.a") is P.span("orphics.b") is P._NO_SPAN
    with P.span("orphics.a"):
        with P.span("orphics.b"):
            pass
    f = P.spanned("orphics.f")(lambda x, y=1: x + y)
    assert f(1, y=2) == 3


@pytest.mark.parametrize("form", ["span", "spanned"])
def test_span_follows_the_profiler_flag(monkeypatch, form):
    """The flag is read through ``torch.autograd.profiler`` at each call."""
    monkeypatch.setattr(torch.profiler, "record_function", _Range)
    monkeypatch.setattr(_Range, "entered", [])
    if form == "span":
        run = lambda: P.span("orphics.t").__enter__()
    else:
        run = P.spanned("orphics.t")(lambda: None)
    run()
    assert _Range.entered == []
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled",
                        True)
    run()
    assert _Range.entered == ["orphics.t"]


def test_spanned_wrapper_keeps_the_function():
    def colfft_like(a, b):
        """doc"""
        return a + b

    w = P.spanned("orphics.transforms.x")(colfft_like)
    assert w.__name__ == "colfft_like" and w.__doc__ == "doc"
    assert w.__wrapped__ is colfft_like
    # the launch counters live on the module's (wrapped) entry points
    assert isinstance(D.colfft.launches, int)
    assert D.colfft.__wrapped__.__name__ == "colfft"


# ---- the span trees of the port's entry points ----------------------------

def _tree(prof, path):
    """The ``orphics.*`` ranges of a profile as nested ``(name, children)``
    (a leaf is its name alone), the prefix dropped, in order."""
    prof.export_chrome_trace(str(path))
    evs = [e for e in json.loads(path.read_text())["traceEvents"]
           if e.get("cat") == "user_annotation"
           and e["name"].startswith(S.PROGRAM)]
    evs.sort(key=lambda e: (e["ts"], -e["dur"]))
    roots, stack = [], []
    for e in evs:
        while stack and stack[-1][0]["ts"] + stack[-1][0]["dur"] <= e["ts"]:
            stack.pop()
        node = (e, [])
        (stack[-1][1] if stack else roots).append(node)
        stack.append(node)

    def short(node):
        e, kids = node
        name = e["name"][len(S.PROGRAM):]
        return (name, [short(k) for k in kids]) if kids else name

    return [short(n) for n in roots]


IFFT = ("transforms.ifft2pp", ["transforms.rowifft", "transforms.colifft"])
FFT = ("transforms.fft2pp", ["transforms.colfft", "transforms.rowfft"])
# the generic TT estimator of one k-map with one leg mask: three distinct
# legs (one leg kernel), each inverse unscaled, one pair kernel, one
# forward transform a component, one post kernel
LEGS = ("qe.kappa_from_map.legs", ["qe.qe_leg"])
CONV = ("qe.kappa_from_map.conv",
        3 * ["transforms.qe_ifft2"] + ["qe.qe_pair"]
        + 2 * ["transforms.qe_fft2"])
NORMALIZE = ("qe.kappa_from_map.normalize", ["qe.qe_post"])
ROW_BINS = ["binning.bin_reduce", "binning.bin_reduce"]

TREES = {
    "lenspipe_pp": [("lenspipe.step", [
        ("lenspipe.draw", ["transforms.noise_planes"] * 3),
        ("lenspipe.kappa", ["transforms.mirror_pp"]),
        ("lenspipe.deflect", [IFFT, IFFT]),
        ("lenspipe.lens", ["lens.lens_map_kernel"]),
        ("lenspipe.observe", [FFT, "transforms.mirror_pp"]),
        ("qe.kappa_tt_pallas", [
            ("qe.kappa_tt_pallas.legs", [IFFT, IFFT]),
            ("qe.kappa_tt_pallas.source", [FFT]),
            ("qe.kappa_tt_pallas.post", ["transforms.mirror_pp"])]),
        ("lenspipe.spectra", ["binning.bin_reduce"])])],
    "lenspipe_half": [("lenspipe.step", [
        "lenspipe.draw",
        ("lenspipe.deflect", ["transforms.irfft2"]),
        "lenspipe.kappa",
        ("lenspipe.deflect", ["transforms.irfft2"]),
        ("lenspipe.lens", ["lens.lens_map_kernel"]),
        ("lenspipe.observe", ["transforms.rfft2"]),
        ("qe.kappa_tt_rfft", ["transforms.irfft2", "transforms.irfft2",
                              "transforms.rfft2"]),
        ("lenspipe.spectra", [("binning.RfftBin2D.bin",
                               ["binning.bin_reduce"])])])],
    "fastcl_sim": [("fastcl.sim_bandpowers", [
        ("fastcl.synth", ["transforms.rowifft_noise_y"]),
        ("fastcl.power", ["transforms.rowqc_pp"]),
        ("fastcl.bin", ["binning.bin2_reduce"] + ROW_BINS)])],
    "fastcl_cross": [("fastcl.cross_bandpowers", [
        ("fastcl.colfft", ["transforms.colfft_scaled"]),
        ("fastcl.power", ["transforms.rows_pp"]),
        ("fastcl.bin", ["binning.bin_reduce"] + ROW_BINS)])],
    "fastcl_map": [("fastcl.map_bandpowers", [
        ("fastcl.colfft", ["transforms.colfft"]),
        ("fastcl.power", ["transforms.rowqc_pp"]),
        ("fastcl.bin", ["binning.bin2_reduce"] + ROW_BINS)])],
    "qe_kappa_from_map": [("qe.kappa_from_map", [LEGS, CONV, NORMALIZE])],
}


@pytest.fixture(scope="module")
def calls():
    """Each case's call, a fresh set of inputs per call."""
    th = ttheory.default_theory()
    g256 = tp.rect_geometry(width_arcmin=256 * 2.0, px_res_arcmin=2.0)
    g64 = tp.rect_geometry(width_arcmin=64 * 3.0, px_res_arcmin=3.0)
    pp = tpipe.LensedQEPipeline(g256, th, lens_order=3, impl="pallas",
                                device="cpu")
    half = tpipe.LensedQEPipeline(g64, th, lens_order=5, device="cpu",
                                  beam_arcmin=2.0, noise_uk_arcmin=5.0,
                                  xlmax=3000, klmax=2000)
    assert (pp.impl, half.impl) == ("pallas", "xla")
    ells = np.arange(6000)
    fc = FastCl(g256, ells, 1.0 / (ells + 10.0) ** 2,
                bin_edges=np.arange(100, 4000, 200), device="cpu")
    gen = torch.Generator().manual_seed(11)
    maps = torch.randn((2, 2, 256, 256), generator=gen)
    taper = 0.5 + torch.rand((256, 256), generator=gen)
    kmaps = torch.fft.fft2(torch.randn((2, 256, 256), generator=gen))
    pp.qe.A_L("TT")                     # the cached normalization, built
    return {
        "lenspipe_pp": lambda: pp.step(2, torch.Generator().manual_seed(3)),
        "lenspipe_half": lambda: half.step(
            3, torch.Generator().manual_seed(0)),
        "fastcl_sim": lambda: fc.sim_bandpowers(5, 4),
        "fastcl_cross": lambda: fc.cross_bandpowers(maps[0], maps[1],
                                                    window=taper),
        "fastcl_map": lambda: fc.map_bandpowers(maps[0]),
        "qe_kappa_from_map": lambda: pp.qe.kappa_from_map("TT", kmaps),
    }


@pytest.mark.parametrize("case", sorted(TREES))
def test_span_tree(calls, case, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        calls[case]()
    assert _tree(prof, tmp_path / "trace.json") == TREES[case]


@pytest.mark.parametrize("case", sorted(TREES))
def test_outputs_bit_equal_under_the_profiler(calls, case):
    plain = calls[case]()
    with profile(activities=[ProfilerActivity.CPU]):
        traced = calls[case]()
    assert plain.dtype == traced.dtype and plain.shape == traced.shape
    assert torch.equal(plain, traced)


# ---- the reader on a hand-built trace --------------------------------------

def _x(cat, name, ts, dur, tid, corr=None, pid=7):
    ev = {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
          "ts": ts, "dur": dur}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def hand_trace():
    """Two steps 1000 us apart. Host thread 11: the step span [0, 100]
    holding the draw (a noise launch in its layer span), the estimator (a
    packed transform's two launches in nested layer spans, one elementwise
    launch of its own) and a launch of the step's own; a copy launched
    outside every span. Host thread 12 launches a fill while thread 11 is
    in the step. The device: idle 85-90 and 95-100 inside the step span,
    95-115 and 120-1030 outside it."""
    ev = []
    for k in range(2):
        t, c = 1000.0 * k, 100 * k
        ua = lambda name, ts, dur: _x("user_annotation", name, t + ts, dur,
                                      11)
        rt = lambda ts, i, tid=11, name="cudaLaunchKernel": _x(
            "cuda_runtime", name, t + ts, 2.0, tid, c + i)
        dev = lambda cat, name, ts, dur, i: _x(cat, name, t + ts, dur, 7,
                                                c + i, pid=0)
        ev += [
            ua("orphics.lenspipe.step", 0.0, 100.0),
            ua("orphics.lenspipe.draw", 5.0, 15.0),
            ua("orphics.transforms.noise_planes", 6.0, 4.0), rt(7.0, 1),
            ua("orphics.qe.kappa_tt_pallas", 25.0, 55.0),
            ua("orphics.transforms.fft2pp", 30.0, 20.0),
            ua("orphics.transforms.colfft", 31.0, 5.0), rt(32.0, 2),
            ua("orphics.transforms.rowfft", 40.0, 5.0), rt(41.0, 3),
            _x("cpu_op", "aten::mul", t + 54.0, 4.0, 11), rt(55.0, 4),
            rt(85.0, 5),
            rt(110.0, 6, name="cudaMemcpyAsync"),
            rt(50.0, 7, tid=12, name="cudaMemsetAsync"),
            dev("kernel", "noise_vec_kernel<16>", 30.0, 10.0, 1),
            dev("kernel", "col_fwd_kernel<16, true>", 40.0, 20.0, 2),
            dev("kernel", "row_fwd_kernel<16>", 60.0, 15.0, 3),
            dev("kernel", "at::native::vectorized_elementwise_kernel<4>",
                75.0, 10.0, 4),
            dev("kernel", "at::native::reduce_kernel<512>", 90.0, 5.0, 5),
            dev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 115.0,
                3.0, 6),
            dev("gpu_memset", "Memset (Device)", 118.0, 2.0, 7),
            # read by neither reader: the device copy of a range, a flow
            _x("gpu_user_annotation", "orphics.lenspipe.step", t + 30.0,
               60.0, 7, pid=0),
            {"ph": "s", "cat": "ac2g", "name": "ac2g", "id": c + 1,
             "pid": 7, "tid": 11, "ts": t + 7.0},
        ]
    return ev


READINGS = {
    "launches_per_step": 5.0,
    "program_host_ms": 0.090,
    "algebra_self_ms": 0.015,
    "qe_device_ms": 0.045,
    "idle_in_program": 100.0 * 50.0 / 1090.0,
    "device_ms": 0.065,
    "unspanned_ms": 0.005,
    "unlinked": 0,
    "early": 0,
    "early_max_us": 0.0,
    "steps": 2,
}

SPAN_TABLE = {  # calls, host_ms, device_ms, launches, self_ms, self_launches
    "orphics.lenspipe.step": (1, 0.100, 0.060, 5, 0.005, 1),
    "orphics.lenspipe.draw": (1, 0.015, 0.010, 1, 0.0, 0),
    "orphics.transforms.noise_planes": (1, 0.004, 0.010, 1, 0.010, 1),
    "orphics.qe.kappa_tt_pallas": (1, 0.055, 0.045, 3, 0.010, 1),
    "orphics.transforms.fft2pp": (1, 0.020, 0.035, 2, 0.0, 0),
    "orphics.transforms.colfft": (1, 0.005, 0.020, 1, 0.020, 1),
    "orphics.transforms.rowfft": (1, 0.005, 0.015, 1, 0.015, 1),
}


@pytest.mark.parametrize("key", sorted(READINGS))
def test_span_readings_of_hand_trace(key):
    got = S.read(hand_trace(), 2)[key]
    assert got == pytest.approx(READINGS[key], rel=1e-12, abs=1e-15)


@pytest.mark.parametrize("name", sorted(SPAN_TABLE))
def test_span_table_of_hand_trace(name):
    got = S.read(hand_trace(), 2)["spans"]
    assert set(got) == set(SPAN_TABLE)
    keys = ("calls", "host_ms", "device_ms", "launches", "self_ms",
            "self_launches")
    assert [got[name][k] for k in keys] == pytest.approx(
        list(SPAN_TABLE[name]), rel=1e-12, abs=1e-15)


def test_span_reader_edges():
    assert S.read([], 3) is None
    # a device operation with no launching call in the trace, and one that
    # starts before its launching call, each counted
    ev = hand_trace()
    ev.append(_x("kernel", "orphan_kernel", 2000.0, 1.0, 7, 999, pid=0))
    ev.append(_x("cuda_runtime", "cudaLaunchKernel", 3000.0, 2.0, 11, 998))
    ev.append(_x("kernel", "early_kernel", 2999.0, 1.0, 7, 998, pid=0))
    got = S.read(ev, 2)
    assert (got["unlinked"], got["early"]) == (1, 1)
    assert got["early_max_us"] == 1.0
    assert got["unspanned_ms"] == pytest.approx(0.005 + 0.002 / 2)


def test_launch_check_of_hand_trace():
    before = {"noise_planes.noise_planes": 4, "dft.colfft": 10,
              "dft.rowfft": 10, "dft.colifft": 3}
    after = {"noise_planes.noise_planes": 6, "dft.colfft": 12,
             "dft.rowfft": 12, "dft.colifft": 3}
    one = {"counter": 1.0, "span_calls": 1.0, "hand_kernels": 1.0}
    assert S.launch_check(hand_trace(), before, after, 2) == {
        "dft.colfft": one, "dft.rowfft": one,
        "noise_planes.noise_planes": one}


class _Written:
    def __init__(self, events):
        self.events = events

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)


TRACER = {
    "steps": 2,
    "busy_s": 130e-6,
    "window_s": 1090e-6,
    "family_ms": {"transforms": 0.045, "elementwise": 0.020},
    "device_ops": [["col_fwd_kernel<16, true>", 40e-6],
                   ["row_fwd_kernel<16>", 30e-6],
                   ["noise_vec_kernel<16>", 20e-6],
                   ["at::native::vectorized_elementwise_kernel<4>", 20e-6],
                   ["at::native::reduce_kernel<512>", 10e-6],
                   ["Memcpy HtoD (Pageable -> Device)", 6e-6],
                   ["Memset (Device)", 4e-6]],
    # an idle gap is named by the innermost host call at its middle: the
    # step span where no runtime call holds it
    "idle_gaps": [["no host call", 950e-6],
                  ["orphics.lenspipe.step", 10e-6]],
}


def _tracer_read(tmp_path):
    tr = Tracer(tmp_path / "trace.json")
    tr.done, tr.steps = _Written(hand_trace()), 2
    return tr.read()


@pytest.mark.parametrize("key", sorted(TRACER))
def test_tracer_read_of_hand_trace(key, tmp_path):
    got = _tracer_read(tmp_path)
    assert set(got) == set(TRACER)
    want = TRACER[key]
    if key == "family_ms":
        assert set(got[key]) == set(want)
        for fam in want:
            assert got[key][fam] == pytest.approx(want[fam], rel=1e-12)
    elif isinstance(want, list):
        assert [k for k, _ in got[key]] == [k for k, _ in want]
        assert [v for _, v in got[key]] == pytest.approx(
            [v for _, v in want], rel=1e-12)
    else:
        assert got[key] == pytest.approx(want, rel=1e-12)


def test_spans_account_for_the_families(tmp_path):
    """The spans' device ms a step and the unspanned equal the families'."""
    fam = sum(_tracer_read(tmp_path)["family_ms"].values())
    got = S.read(hand_trace(), 2)
    assert got["device_ms"] == pytest.approx(fam, rel=1e-12)
    assert (sum(d["self_ms"] for d in got["spans"].values())
            + got["unspanned_ms"]) == pytest.approx(fam, rel=1e-12)
