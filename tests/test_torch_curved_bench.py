"""The benchmark cell ``curvedqe2047.recon`` on the CPU: its plain float64
full-sky reference (``cmbbench/reference/curved.py``), the B10 work count
its rooflines read (``cmbbench/work_sht.py``), its kernel families, the
whole entry against the reference at a small size, and the port's spans on
the curved-sky estimator.

The reference's own tests import nothing of JAX; (b) holds its sums to the
port's.
"""
import copy
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from numpy.polynomial.legendre import legval
from torch.profiler import ProfilerActivity, profile

from cmbbench import trace as bench_trace
from cmbbench import work as W
from cmbbench import work_sht
from cmbbench.control import control_errors
from cmbbench.reference import curved as ref
from cmbbench.reference.flat import Prec
from cmbbench.run import load_cell, run_cell
from cmbbench.theory import load_tables
from orphics_tpu_torch.models import curved_qe as cqe
from orphics_tpu_torch.ops import legendre as leg
from test_torch_spans import _tree

REPO = Path(__file__).resolve().parent.parent
CELL = "curvedqe2047.recon"
FAMILIES = ("legendre_ana", "legendre_syn")

torch.set_num_threads(4)


def _small():
    """The cell at lmax 63 on ``gauss_legendre_rings(95)`` (96 x 192), 2
    sims a step from 4 held alms, every step kept."""
    bench, wl, cfg, traffic = load_cell(CELL)
    cfg = {**cfg, "lmax": 63, "lmin": 8,
           "rings": {"kind": "gauss_legendre", "lmax": 95, "ntheta": 96,
                     "nphi": 192},
           "bins": {"start": 8, "stop": 64, "step": 8}}
    traffic = copy.deepcopy(traffic)
    traffic["batch"] = 2
    traffic["inputs"]["count"] = 4
    traffic["keep_every"] = 1
    return bench, wl, cfg, traffic


# ---- (a) the reference's transforms and Legendre functions -----------------

@pytest.mark.parametrize("lmax,ntheta", [(31, 32), (47, 72), (63, 96)])
def test_reference_sht_roundtrip(lmax, ntheta):
    """On its own rings the analysis inverts the synthesis to 1e-12 of
    max|a| (float64; reads ~1e-14)."""
    s = ref.Sphere(lmax, ntheta, 2 * lmax + 2, "cpu")
    nalm = (lmax + 1) * (lmax + 2) // 2
    gen = torch.Generator().manual_seed(lmax)
    a = torch.complex(torch.randn(3, nalm, generator=gen, dtype=torch.float64),
                      torch.randn(3, nalm, generator=gen, dtype=torch.float64))
    a[:, :lmax + 1] = a[:, :lmax + 1].real.to(a.dtype)      # m = 0 real
    back = s.map2alm(s.alm2map(a, Prec()), Prec())
    assert ((back - a).abs().max() / a.abs().max()).item() <= 1e-12


def test_reference_gl_rule():
    """Its nodes are the roots of P_n (mirrored about the equator) and its
    weights integrate x^k exactly to k = 2n - 1."""
    n = 96
    x, w = ref.gl_rule(n)
    assert np.all(np.diff(x) < 0) and np.array_equal(x, -x[::-1])
    assert np.max(np.abs(legval(x, np.eye(n + 1)[n]))) <= 1e-12
    for k in (0, 2, 50, 2 * n - 2):
        assert abs(np.sum(w * x ** k) - 2.0 / (k + 1)) <= 1e-13


def test_reference_lambda_closed_forms():
    """lambda_l0 = sqrt((2l+1)/4pi) P_l and lambda_ll = (-1)^l
    sqrt((2l+1)!/4pi) / (2^l l!) sin^l theta at three angles, l <= 63, to
    1e-13 (relative for lambda_ll, whose values span decades)."""
    th = np.array([0.8, 1.2, 1.5])
    x = np.cos(th)
    blocks, _ = ref.lambda_tables(63, x, "cpu")
    for l in range(64):
        y0 = math.sqrt((2 * l + 1) / (4 * math.pi)) * legval(
            x, np.eye(l + 1)[l])
        lg = (0.5 * (math.log((2 * l + 1) / (4 * math.pi))
                     + math.lgamma(2 * l + 1))
              - l * math.log(2.0) - math.lgamma(l + 1))
        yll = (-1) ** l * np.exp(lg + l * np.log(np.sin(th)))
        got0 = blocks[0][0, l].numpy()
        gotl = blocks[l // 64][l % 64, l - 64 * (l // 64)].numpy()
        assert np.max(np.abs(got0 - y0)) <= 1e-13
        assert np.max(np.abs(gotl - yll) / np.abs(yll)) <= 1e-13


def test_live_starts_are_the_tables_own():
    """At lmax 255 on 384 rings (seeds down to 1e-570, many rescaled
    lanes) the count's starts equal the tables': every value before a
    lane's start is zero, its start's value reaches TAU."""
    x, _ = ref.gl_rule(384)
    xn = x[:192]
    blocks, starts = ref.lambda_tables(255, xn, "cpu")
    assert torch.equal(ref.live_starts(255, xn, "cpu"), starts)
    assert int((starts == 256).sum()) > 0 and int((starts > torch.arange(
        256)[:, None]).sum()) > 0
    for m in (0, 100, 200, 255):
        b, i = divmod(m, 64)
        rows = blocks[b][i]                       # (256 - 64 b, rings)
        ls = torch.arange(64 * b, 256)[:, None]
        st = starts[m][None, :]
        assert bool((rows[ls < st] == 0).all())
        first = rows.gather(0, (st.clamp(max=255) - 64 * b)).squeeze(0)
        live = starts[m] <= 255
        assert bool((first[live].abs() >= ref.TAU).all())


# ---- (b) the reference's normalization against the port's -------------------

def test_reference_sums_match_the_port():
    """R_L and N0_L at lmax 63 (lmin 8, the benchmark's lensed TT and
    instrument) against ``response_tt`` / ``n0_tt``, 1e-10 relative; the
    reference samples the port's Ls (112 at lmax 2047)."""
    _, _, cfg, _ = _small()
    tables = load_tables(cfg["theory"]["root"], cfg["theory"]["lpad"])
    lmax = 63
    cl = tables["lCl_TT"][:lmax + 1]
    ctot = ref.total_spectrum(cfg, cl)
    Ls = ref.sampled_Ls(lmax)
    R, N0num = ref.qe_sums(cl, ctot, lmax, 8, Ls, "cpu")
    Lp, Rp = cqe.response_tt(cl, ctot, lmax, lmin=8, device="cpu")
    _, N0p = cqe.n0_tt(cl, ctot, lmax, lmin=8, device="cpu")
    assert np.array_equal(Lp, Ls)
    live = Rp != 0
    assert np.max(np.abs(R - Rp)[live] / np.abs(Rp[live])) <= 1e-10
    N0 = N0num[live] / R[live] ** 2
    assert np.max(np.abs(N0 - N0p[live]) / np.abs(N0p[live])) <= 1e-10
    assert np.array_equal(ref.sampled_Ls(2047), cqe._default_Ls(2047))
    assert ref.sampled_Ls(2047).size == 112


# ---- (c) the whole entry against the reference ---------------------------------

def test_entry_matches_reference_at_small_size():
    """``build``, ``step``, ``answer`` and ``reference`` on the CPU (the
    port's plain Legendre loops) at lmax 63: every sampled answer within
    the cell's limit."""
    bench, wl, cfg, traffic = _small()
    limit = traffic["check"]["limit"]
    res = run_cell(bench, wl, cfg, traffic, 2 ** 40 + 3, 0.3, 0, "cpu",
                   log=lambda s: None)
    got = res["checked"]["recon_err"]
    assert got["limit"] == limit and limit is not None
    assert res["correct"] and got["value"] <= limit, got


def test_control_fails_the_limit_at_small_size():
    """The bfloat16 control of the reference reads above the cell's
    limit."""
    _, _, cfg, traffic = _small()
    errs = control_errors(cfg, traffic, 77, "cpu", steps=4)
    assert errs and min(errs) > traffic["check"]["limit"], errs


# ---- (d) the work count --------------------------------------------------------

# PERF.md section 6, rows B10a / B10s at the curved QE's shape: the port's
# own live steps (2.205e9, from each lane's captured seed) at 12 and 16
# maps
PORT_BOUND_MS = {"legendre_ana": 1.5800, "legendre_syn": 2.1067}


def test_work_count_at_lmax_2047():
    """The reference's live steps at lmax 2047 on 3072 rings: at most the
    port's (its kernel captures a lane's seed at or before the reference's
    start) and within 1 % of them (PERF.md says why they differ); the
    bound is set by the operations."""
    r = json.loads((REPO / "cmbbench/configs/curved_tt_2047.json")
                   .read_text())["rings"]
    work = work_sht.legendre_work(2047, r["ntheta"], 12, 16)
    assert set(work) == set(FAMILIES)
    for fam, port in PORT_BOUND_MS.items():
        ms, by = W.bound(*work[fam])
        assert by == "operations" and 0.99 * port <= ms <= port, (fam, ms)
    steps = work_sht.live_steps(2047, r["ntheta"])
    assert 0.99 * 2.205e9 <= steps <= 2.205e9
    # the ring transforms of a step's 28 maps move 3.52 GB: bound by bytes
    ms, by = W.bound(*work_sht.ring_fft_work(2047, r["ntheta"], r["nphi"],
                                             28))
    assert by == "bytes" and abs(ms - 28 * 3072 * 40960 / 3.35e9) < 1e-9


# ---- (e) the families ----------------------------------------------------------

# The device operations of the four flat cells' breakdowns in the
# ledger (as the trace names them, cut to 64 characters), frozen here
FLAT_KERNELS = (
    'Memcpy_DtoD__Device_-__Device_',
    'at::native::CatArrayBatchedCopy_vectorized_at::native::OpaqueTyp',
    'at::native::_scatter_gather_elementwise_kernel_128__8__at::nativ',
    'at::native::elementwise_kernel_128__2__at::native::gpu_kernel_im',
    'at::native::elementwise_kernel_128__4__at::native::gpu_kernel_im',
    'at::native::vectorized_elementwise_kernel_2__at::native::AUnaryF',
    'at::native::vectorized_elementwise_kernel_2__at::native::BUnaryF',
    'at::native::vectorized_elementwise_kernel_2__at::native::BinaryF',
    'at::native::vectorized_elementwise_kernel_2__at::native::CUDAFun',
    'at::native::vectorized_elementwise_kernel_4__at::native::AUnaryF',
    'at::native::vectorized_elementwise_kernel_4__at::native::BinaryF',
    'at::native::vectorized_elementwise_kernel_4__at::native::CUDAFun',
    'col_fwd_kernel_16__true__float_const___float_const___float_const',
    'col_fwd_kernel_4__false__float_const___float_const___float_const',
    'col_inv_kernel_4__float_const___float_const___float2_const___flo',
    'lens_kernel_5__float_const___float_const___float___unsigned_long',
    'mirror_kernel_float_const___float_const___int_const___float___fl',
    'qe_leg_kernel_float__LegParams_',
    'qe_pair_kernel_float__PairParams_',
    'qe_post_kernel_float__PostParams_',
    'regular_fft_512u__EPT_8u___8u__4u___padding_t_14___twiddle_t_0__',
    'row_inv_kernel_16__2__float_const___float_const___float_const___',
    'row_inv_kernel_4__0__float_const___float_const___float_const___i',
    'row_qc_kernel_16__false__float_const___float_const___float2_cons',
    'row_qc_kernel_16__true__float_const___float_const___float2_const',
    'seg_finish_kernel_float__double_const___float___int__int__int_',
    'seg_sum_kernel__Mode_0__float__float_const___float_const___float',
    'seg_sum_kernel__Mode_1__float__float_const___float_const___float',
    'vector_fft_512u__EPT_8u___1u__32u___padding_t_70___twiddle_t_0__',
)


def test_families_match_the_b10_kernels_only():
    fams = bench_trace.families()
    old = [f for f in fams if f[0] not in FAMILIES]
    for name, fam in (
            ("void (anonymous namespace)::ana_kernel<float2, double, true, "
             "8, 1>(Tabs, float2 const*, void*, int, int, int, int, int, "
             "int)", "legendre_ana"),
            ("void syn_kernel<float2, double, true, 16, 1>(Tabs)",
             "legendre_syn"),
            ("void syn_cc_kernel<float2, double, true, 2, 1>(Tabs)",
             "legendre_syn")):
        assert bench_trace.family_of(name, fams) == fam
    for name in FLAT_KERNELS:
        assert bench_trace.family_of(name, fams) \
            == bench_trace.family_of(name, old) not in FAMILIES
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for fam in FAMILIES:
        m = next(x for x in bench["per_layer"]
                 if x["name"] == fam + ".roofline")
        assert m["workloads"] == [CELL] and m["layer"] \
            == "spherical transforms"


# ---- (f) the port's spans --------------------------------------------------------

@pytest.fixture(scope="module")
def small_qe():
    from orphics_tpu_torch.ops import alm as almops
    from orphics_tpu_torch.ops import sht
    lmax = 31
    rings = sht.gauss_legendre_rings(47)
    cl = 1.0 / (np.arange(lmax + 1) + 10.0) ** 2
    qe = cqe.CurvedQE(rings, lmax, cl, cl + 1e-4, lmin=2, device="cpu")
    talm = almops.synalm(torch.Generator().manual_seed(5), cl + 1e-4, lmax,
                         batch=(2,), device="cpu")
    return qe, talm


def test_kappa_from_alm_spans(small_qe, tmp_path):
    """One call opens each stage span once, nested as the stages run; the
    output is bit-equal to an untraced call's."""
    qe, talm = small_qe
    plain = qe.kappa_from_alm(talm)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = qe.kappa_from_alm(talm)
    assert _tree(prof, tmp_path / "trace.json") == [
        ("curved_qe.kappa_from_alm", [("curved_qe.phi_from_alm", [
            "curved_qe.legs",
            ("curved_qe.synth", ["transforms.legendre_syn",
                                 "transforms.ring_ifft"]),
            "curved_qe.products",
            ("curved_qe.analysis", ["transforms.ring_fft",
                                    "transforms.legendre_ana"]),
            "curved_qe.combine"])])]
    assert torch.equal(plain, traced)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        qe.phi_from_alm(talm)
    assert _tree(prof, tmp_path / "phi.json")[0][0] \
        == "curved_qe.phi_from_alm"


def test_partial_planes_span_and_counter(tmp_path):
    """B10a's cross-group sum adds its partial planes in ring order in the
    span ``orphics.transforms.legendre_ana.partials`` and counts them."""
    part = torch.randn((3, 2, 5, 4, 2), dtype=torch.float64)
    dst = torch.empty((2, 5, 4, 2), dtype=torch.float64)
    before = leg.legendre_ana.partial_planes
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        leg._sum_partials(part, dst)
    assert leg.legendre_ana.partial_planes - before == 3
    assert torch.equal(dst, (part[0] + part[1]) + part[2])
    assert _tree(prof, tmp_path / "trace.json") == [
        "transforms.legendre_ana.partials"]


def test_reference_imports_no_program():
    """In a fresh interpreter, the reference and the work count load
    neither the port nor JAX."""
    code = ("import sys, cmbbench.reference.curved, cmbbench.work_sht\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'orphics_tpu', 'orphics_tpu_torch'}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
