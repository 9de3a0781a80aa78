"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here is marked ``cuda`` and skips where no CUDA device is
visible (the kernels have no CPU mode). This file imports no jax, so it
also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

The same comparisons at the main path's full shapes run in chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import orphics_tpu_torch as tp
from orphics_tpu_torch import _build
from orphics_tpu_torch.models import grf, lensing
from orphics_tpu_torch.models.theory import default_theory
from orphics_tpu_torch.ops import dft
from orphics_tpu_torch.ops import legendre as leg
from orphics_tpu_torch.ops import sht
from orphics_tpu_torch.ops.bin_reduce import (bin2_reduce, bin2_reduce_ref,
                                               bin_pair_power,
                                               bin_pair_power_ref,
                                               bin_reduce, bin_reduce_ref)
from orphics_tpu_torch.ops.lens import (TILE, WINDOW_RANGE, lens_map_kernel,
                                        lens_map_ref, spline_coeffs)
from orphics_tpu_torch.ops.mirror import mirror_pp, mirror_pp_ref
from orphics_tpu_torch.ops.noise_planes import noise_planes
from orphics_tpu_torch.models.fastcl import FastCl
from orphics_tpu_torch.ops.rowcombine import (coadds_per_block, rowcombine_pp,
                                              rowcombine_pp_ref)
from orphics_tpu_torch.ops.rowpower import (qc_pp_half, qc_pp_half_ref,
                                            rowqc_half, rowqc_pp,
                                            rowqc_pp_ref, rows_half, rows_pp,
                                            rows_pp_ref, s_pp_half,
                                            s_pp_half_ref)
from orphics_tpu_torch.ops.windows import get_taper

torch.set_num_threads(1)

# B1: |kernel - float64 sum| <= 1e-6 of the binned |data| per bin.
TOL_BIN = 1e-6
# B8: fp32 tap sums in another order than the gather version: 2e-5 of max.
TOL_LENS = 2e-5
# B3/B4: fp32 transforms by another factorization than cuFFT's: 2e-5 of
# max|ref|, the JAX package's own bound for its kernels (test_core.py).
TOL_DFT = 2e-5
# B6: products of two transforms, each within TOL_DFT: 3e-5 of max|ref|.
TOL_QC = 3e-5
# B6h, B6h': the plain version's own float32 products, contracted to fused
# multiply-adds by the compiler: 1e-6 of max|ref|.
TOL_HALF = 1e-6
# B10: fp64 recurrence from captured seeds vs the plain fp64 loop from the
# l0 seeds; fp32 inputs and outputs: 1e-6 of max|ref| (the JAX kernel's own
# bound against its scan is 2e-6), fp64: 1e-10; the fast mode's fp32
# recurrence, whose rounding grows ~l^2 on the near-polar low-m lanes
# (pallas_sht.py:529-541): 3e-3 at lmax 1023, where random inputs read at
# most 1.3e-3 on the H100 since the factor a x + b rounds once from float64
# (chip_smoke.py: B10_FAST_TOL).
# The fast kernel against the fast mode's own plain version (the same fp32
# recurrence emulated in torch, each FMA rounded once: the same Lambda bit
# for bit): 2^-22, two fp32 ulps of max|ref|, since the fp64 sums run in
# another order and an output may round to the neighbouring fp32 value.
TOL_LEG = {"f32": 1e-6, "f64": 1e-10, "fast": 3e-3, "fast_plain": 2.0 ** -22}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,nseg,weighted", [(3, 512 * 257, 38, True),
                                               (1, 512 * 512, 17, False),
                                               (2, 1000, 5, True)])
def test_bin_reduce_kernel_matches_ref(cuda_device, B, n, nseg, weighted):
    rng = np.random.default_rng(n)
    data = torch.as_tensor(rng.standard_normal((B, n)).astype(np.float32),
                           device=cuda_device)
    ids = torch.as_tensor(rng.integers(0, nseg, n).astype(np.int32),
                          device=cuda_device)
    w = (torch.as_tensor(rng.integers(1, 3, n).astype(np.float32),
                         device=cuda_device) if weighted else None)
    before = bin_reduce.launches
    out = bin_reduce(data, ids, nseg, w)
    again = bin_reduce(data, ids, nseg, w)
    torch.cuda.synchronize()
    assert bin_reduce.launches == before + 2
    ref = bin_reduce_ref(data, ids, nseg, w)
    absref = bin_reduce_ref(data.abs(), ids, nseg, w)
    assert ((out - ref).abs() <= TOL_BIN * absref).all()
    assert torch.equal(out, again)           # fixed-order sums: reproducible


@pytest.mark.cuda
@pytest.mark.parametrize("order", [3, 5])
def test_lens_kernel_matches_ref(cuda_device, order):
    geom = tp.rect_geometry(width_arcmin=96 * 3.0, height_arcmin=80 * 3.0,
                            px_res_arcmin=3.0)
    th = default_theory()
    ells = np.arange(int(geom.lmax()) + 1)
    gen = torch.Generator(device=cuda_device).manual_seed(order)
    kgen = grf.MapGen(geom, np.asarray(th.gCl("kk", ells))[None, None],
                      device=cuda_device)
    cgen = grf.MapGen(geom, np.asarray(th.uCl("TT", ells))[None, None],
                      device=cuda_device)
    alpha = lensing.alpha_from_kappa(kgen.get_map(gen, batch=(2,)), geom)
    cmb = cgen.get_map(gen, batch=(2, 3))
    coeffs = spline_coeffs(cmb, geom, order).contiguous()
    for scale_a, D in ((1.0, 8), (12.0, 4)):
        a = (alpha * scale_a).contiguous()
        before = lens_map_kernel.launches
        out = lens_map_kernel(coeffs, a, geom, order=order, maxdisp_px=D,
                              prefiltered=True)
        torch.cuda.synchronize()
        assert lens_map_kernel.launches == before + 1
        ref = lens_map_ref(coeffs, a, geom, order, D)
        err = (out - ref).abs().max().item()
        assert err <= TOL_LENS * ref.abs().max().item(), (scale_a, D, err)


_DFT_CASES = {
    "colfft": (dft.colfft, dft.colfft_ref),
    "colifft": (dft.colifft, dft.colifft_ref),
    "rowfft": (dft.rowfft, dft.rowfft_ref),
    "rowifft": (dft.rowifft, dft.rowifft_ref),
}


# transform lengths 256 .. 4096 (Bk = 2 .. 32) and 384, 640 (Bk = 3, 5: the
# radix-2 kernel); column counts square, ragged (7, 100, 200, 1025) and wide
_DFT_SHAPES = [(2, 256, 256), (3, 384, 384), (2, 256, 200), (1, 640, 640),
               (2, 512, 512), (2, 1024, 1024), (1, 2048, 2048),
               (1, 4096, 4096), (2, 512, 7), (3, 2048, 100),
               (2, 1024, 1025), (1, 4096, 129)]


def _col_route(fn, args, n):
    """Run a column transform twice; the outputs, and whether the
    register-resident kernel took both launches (power-of-two Bk) or the
    radix-2 kernel did (any other Bk)."""
    lib = _build.library()
    before = fn.launches, lib.colfft_regs_launches()
    got = fn(*args)
    again = fn(*args)
    torch.cuda.synchronize()
    regs = lib.colfft_regs_launches() - before[1]
    assert fn.launches == before[0] + 2
    bk = n // 128
    assert regs == (0 if bk & (bk - 1) else 2), (fn.__name__, n, regs)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    return got


def _row_route(fn, args, n):
    """Run a row transform twice (B4, or B5 on its words); the outputs, and
    whether the register-resident row kernel took both launches
    (power-of-two Bk) or the radix-2 kernel did (any other Bk)."""
    lib = _build.library()
    before = fn.launches, lib.rowfft_regs_launches()
    got = fn(*args)
    again = fn(*args)
    torch.cuda.synchronize()
    regs = lib.rowfft_regs_launches() - before[1]
    assert fn.launches == before[0] + 2
    bk = n // 128
    assert regs == (0 if bk & (bk - 1) else 2), (fn.__name__, n, regs)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_DFT_CASES))
@pytest.mark.parametrize("shape", _DFT_SHAPES)
def test_dft_kernels_match_ref(cuda_device, name, shape):
    """B3 / B4 against their plain versions; two runs bit-equal, by the
    register-resident column or row kernel at power-of-two Bk and by the
    radix-2 kernel otherwise."""
    fn, ref_fn = _DFT_CASES[name]
    if name.startswith("row"):
        shape = (shape[0], shape[2], shape[1])    # the transform axis is -1
    rng = np.random.default_rng(sum(shape))
    xr, xi = (torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                              device=cuda_device) for _ in range(2))
    if name.startswith("col"):
        gr, gi = _col_route(fn, (xr, xi), shape[1])
    else:
        gr, gi = _row_route(fn, (xr, xi), shape[2])
    rr, ri = ref_fn(xr, xi)
    scale = max(rr.abs().max().item(), ri.abs().max().item())
    err = max((gr - rr).abs().max().item(), (gi - ri).abs().max().item())
    assert err <= TOL_DFT * scale, (name, shape, err / scale)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256, 384, 512, 2048])
def test_rowifft_scaled_and_roundtrip(cuda_device, n):
    """rowifft_scaled_y on the register-resident row kernel (256, 512,
    2048) and on the radix-2 one (384): against its plain version, two runs
    bit-equal, rows 2 n (and 7 n, which fill no block) over an (n, n) scale
    whose rows repeat per batch entry; then the 2D compositions' round
    trip."""
    rng = np.random.default_rng(5 + n)
    b = 2 if n < 2048 else 1
    kr, ki = (torch.as_tensor(rng.standard_normal((b, n, n))
                              .astype(np.float32), device=cuda_device)
              for _ in range(2))
    sc = torch.as_tensor(rng.uniform(0.5, 2.0, (n, n)).astype(np.float32),
                         device=cuda_device)
    gr, gi = _row_route(dft.rowifft_scaled_y, (kr, ki, sc), n)
    rr, ri = dft.rowifft_scaled_y_ref(kr, ki, sc)
    scale = rr.abs().max().item()
    assert (gr - rr).abs().max().item() <= TOL_DFT * scale
    assert (gi - ri).abs().max().item() <= TOL_DFT * scale
    k7 = tuple(a[:1, :7].contiguous() for a in (kr, ki))
    g7 = _row_route(dft.rowifft_scaled_y, k7 + (sc[:7].contiguous(),), n)
    r7 = dft.rowifft_scaled_y_ref(*k7, sc[:7])
    for g, r in zip(g7, r7):
        assert (g - r).abs().max().item() <= TOL_DFT * r.abs().max().item()
    # the 2D compositions on the kernels round-trip
    br, bi = dft.ifft2pp(*dft.fft2pp(kr, ki))
    assert (br - kr).abs().max().item() <= 3e-5 * kr.abs().max().item()
    assert (bi - ki).abs().max().item() <= 3e-5 * ki.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256, 384])
def test_mirror_kernel_is_exact(cuda_device, n):
    rng = np.random.default_rng(n)
    zr, zi = (torch.as_tensor(rng.standard_normal((3, n, n))
                              .astype(np.float32), device=cuda_device)
              for _ in range(2))
    before = mirror_pp.launches
    mr, mi = mirror_pp(zr, zi)
    torch.cuda.synchronize()
    assert mirror_pp.launches == before + 1
    rr, ri = mirror_pp_ref(zr, zi)
    assert torch.equal(mr, rr) and torch.equal(mi, ri)


@pytest.mark.cuda
def test_noise_kernel_law_and_seeds(cuda_device):
    n = 256
    scale = torch.linspace(0.5, 2.0, n * n, device=cuda_device).reshape(n, n)
    words = torch.tensor([5, 9], dtype=torch.int32, device=cuda_device)
    before = noise_planes.launches
    r1, i1 = noise_planes(scale, words, 8)
    r2, _ = noise_planes(scale, words, 8)
    r3, _ = noise_planes(scale, [5, 10], 8)
    r4, _ = noise_planes(scale, 5, 8)
    torch.cuda.synchronize()
    assert noise_planes.launches == before + 4
    assert r1.shape == (8, n, n) and torch.isfinite(r1).all()
    assert torch.equal(r1, r2)
    assert not torch.equal(r1, r3) and not torch.equal(r1, r4)
    z = torch.cat([r1 / scale, i1 / scale]).double()
    N = z.numel()
    assert abs(z.mean().item()) < 5.0 / N ** 0.5
    assert abs(z.std().item() - 1.0) < 5.0 / (2 * N) ** 0.5
    corr = ((r1 / scale).double() * (i1 / scale).double()).mean().item()
    assert abs(corr) < 5.0 / (N / 2) ** 0.5
    with pytest.raises(ValueError, match="scalar or"):
        noise_planes(scale, torch.zeros(3, dtype=torch.int32), 1)


# sha256 (first 16 hex digits) of the re and im planes that B5n and B5
# draw on the words (123456789, -98765) under a unit scale, as
# scripts/bench_kernels.py --kernel noise prints them; equal for the
# kernels before and after their 16-byte and conversion-free forms
_STREAM_DIGESTS = {("noise_planes", 3, (64, 64)): "053b0a667124014d",
                   ("noise_planes", 3, (5, 7)): "5442f6b4eac055ef",
                   ("rowifft_noise_y", 2, (256, 256)): "c57697196e182706"}


@pytest.mark.cuda
@pytest.mark.parametrize("fn,batch,shape", list(_STREAM_DIGESTS))
def test_noise_stream_is_pinned(cuda_device, fn, batch, shape):
    """The Philox stream of B5n (16-byte and element-wise kernels) and B5,
    bit for bit."""
    import hashlib
    words = torch.tensor([123456789, -98765], dtype=torch.int32,
                         device=cuda_device)
    draw = noise_planes if fn == "noise_planes" else dft.rowifft_noise_y
    outs = draw(torch.ones(shape, device=cuda_device), words, batch)
    h = hashlib.sha256()
    for o in outs:
        h.update(o.cpu().numpy().tobytes())
    assert h.hexdigest()[:16] == _STREAM_DIGESTS[(fn, batch, shape)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(5, 7), (6, 6), (3, 4)])
def test_noise_kernel_odd_and_ragged_planes(cuda_device, shape):
    """B5n at batch 3 on planes of 35 (an odd total), 36 (a multiple of 4)
    and 12 elements: each flat element e takes the stream's pair e // 2, so
    the draw equals scale times the flat draw of one unit plane of 108
    elements (the 16-byte kernel) bit for bit; two runs bit-equal."""
    rng = np.random.default_rng(sum(shape))
    scale = torch.as_tensor(rng.uniform(0.5, 2.0, shape).astype(np.float32),
                            device=cuda_device)
    words = torch.tensor([31, -7], dtype=torch.int32, device=cuda_device)
    before = noise_planes.launches
    r, i = noise_planes(scale, words, 3)
    r2, i2 = noise_planes(scale, words, 3)
    ur, ui = noise_planes(torch.ones((1, 108), device=cuda_device), words, 1)
    torch.cuda.synchronize()
    assert noise_planes.launches == before + 3
    assert r.shape == i.shape == (3,) + shape
    assert torch.equal(r, r2) and torch.equal(i, i2)
    tot = 3 * scale.numel()
    sc = scale.reshape(1, -1).expand(3, -1).reshape(-1)
    assert torch.equal(r.reshape(-1), sc * ur.reshape(-1)[:tot])
    assert torch.equal(i.reshape(-1), sc * ui.reshape(-1)[:tot])


@pytest.mark.cuda
@pytest.mark.parametrize("nseg", [113, 400, 1000])
def test_bin_reduce_any_nseg(cuda_device, nseg):
    """Segment counts above one tile of the kernel (256) and above the
    113 that one fp64 slot per thread and segment would fit."""
    rng = np.random.default_rng(nseg)
    B, n = 3, 300_000
    data = torch.as_tensor(rng.standard_normal((B, n)).astype(np.float32),
                           device=cuda_device)
    ids = torch.as_tensor(rng.integers(0, nseg, n).astype(np.int32),
                          device=cuda_device)
    before = bin_reduce.launches
    out = bin_reduce(data, ids, nseg)
    again = bin_reduce(data, ids, nseg)
    torch.cuda.synchronize()
    assert bin_reduce.launches == before + 2
    ref = bin_reduce_ref(data, ids, nseg)
    absref = bin_reduce_ref(data.abs(), ids, nseg)
    assert ((out - ref).abs() <= TOL_BIN * absref).all()
    assert torch.equal(out, again)


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,nseg", [(4, 128 * 256, 24), (2, 500_000, 400)])
def test_bin2_reduce_kernel_matches_ref(cuda_device, B, n, nseg):
    rng = np.random.default_rng(n)
    d1, d2 = (torch.as_tensor(rng.standard_normal((B, n)).astype(np.float32),
                              device=cuda_device) for _ in range(2))
    ids = torch.as_tensor(rng.integers(0, nseg, n).astype(np.int32),
                          device=cuda_device)
    before = bin2_reduce.launches
    out = bin2_reduce(d1, d2, ids, nseg)
    again = bin2_reduce(d1, d2, ids, nseg)
    torch.cuda.synchronize()
    assert bin2_reduce.launches == before + 2
    for o, a, r, x in zip(out, again, bin2_reduce_ref(d1, d2, ids, nseg),
                          (d1, d2)):
        absref = bin_reduce_ref(x.abs(), ids, nseg)
        assert ((o - r).abs() <= TOL_BIN * absref).all()
        assert torch.equal(o, a)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 256, 256), (3, 384, 384),
                                   (2, 130, 512)])
def test_rowfft_blk0_kernel_matches_ref(cuda_device, shape):
    rng = np.random.default_rng(sum(shape))
    yr, yi = (torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                              device=cuda_device) for _ in range(2))
    before = dft.rowfft_blk0.launches
    gr, gi = dft.rowfft_blk0(yr, yi)
    torch.cuda.synchronize()
    assert dft.rowfft_blk0.launches == before + 1
    rr, ri = dft.rowfft_blk0_ref(yr, yi)
    scale = max(rr.abs().max().item(), ri.abs().max().item())
    assert max((gr - rr).abs().max().item(),
               (gi - ri).abs().max().item()) <= TOL_DFT * scale
    # and it is the first lane chunk of the B4 kernel, bit for bit
    fr, fi = dft.rowfft(yr, yi)
    assert torch.equal(gr, fr[..., :128]) and torch.equal(gi, fi[..., :128])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256, 384, 512, 2048])
def test_rowifft_noise_kernel(cuda_device, n):
    """B5 draws B5n's stream: it equals rowifft(noise_planes(...)) on the
    same words, bit for bit where both take the same kernel template (the
    register-resident one at 256, 512 and 2048; the radix-2 one at 384);
    two runs bit-equal; the law of Y' under a unit scale: var 1/n per
    part."""
    rng = np.random.default_rng(n)
    b = 4 if n < 2048 else 2
    sc = torch.as_tensor(rng.uniform(0.5, 2.0, (n, n)).astype(np.float32),
                         device=cuda_device)
    words = torch.tensor([77, -5], dtype=torch.int32, device=cuda_device)
    before = dft.rowifft_noise_y.launches
    yr, yi = _row_route(dft.rowifft_noise_y, (sc, words, b), n)
    other = dft.rowifft_noise_y(sc, [77, -4], b)
    torch.cuda.synchronize()
    assert dft.rowifft_noise_y.launches == before + 3
    rr, ri = dft.rowifft(*noise_planes(sc, words, b))
    scale = max(rr.abs().max().item(), ri.abs().max().item())
    assert max((yr - rr).abs().max().item(),
               (yi - ri).abs().max().item()) <= TOL_DFT * scale
    assert torch.equal(yr, rr) and torch.equal(yi, ri)
    assert not torch.equal(yr, other[0])
    ur, ui = dft.rowifft_noise_y(torch.ones_like(sc), 3, 8)
    z = torch.cat([ur.ravel(), ui.ravel()]).double() * n ** 0.5
    assert torch.isfinite(z).all()
    assert abs(z.var().item() - 1.0) < 5.0 * (2.0 / z.numel()) ** 0.5
    corr = (ur.double() * ui.double()).mean().item() * n
    assert abs(corr) < 5.0 / (ur.numel()) ** 0.5


# B6 / B6s shapes: Bk = 2, 3 (the radix-2 core), 4, 8, 16 and 32 (the
# register-resident kernel), batches odd and even
_QC_SHAPES = [(3, 256), (3, 384), (3, 512), (5, 1024), (3, 2048), (1, 4096)]


def _fused_case(pp, half, pp_ref, b, n, device):
    """One B6 / B6s case: ``pp`` (fields and zrow from one launch of
    ``half``'s kernel: no B4, no B4b) against ``pp_ref``, two runs
    bit-equal, and ``half`` alone equal to ``pp``'s fields bit for bit."""
    rng = np.random.default_rng(n + b)
    yr, yi = (torch.as_tensor(rng.standard_normal((b, n, n))
                              .astype(np.float32), device=device)
              for _ in range(2))
    counts = lambda: (half.launches, dft.rowfft.launches,
                      dft.rowfft_blk0.launches)
    before = counts()
    got = pp(yr, yi)
    torch.cuda.synchronize()
    assert counts() == (before[0] + 1, before[1], before[2])
    ref = pp_ref(yr, yi)
    nf = len(ref) - 2
    assert len(got) == len(ref)
    for k, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape
        err = (g - r).abs().max().item()
        tol = TOL_QC if k < nf else TOL_DFT
        assert err <= tol * r.abs().max().item(), (k, n, err)
    again = pp(yr, yi)
    alone = half(yr, yi)
    alone = alone if isinstance(alone, tuple) else (alone,)
    torch.cuda.synchronize()
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    assert all(torch.equal(g, a) for g, a in zip(got, alone))


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", _QC_SHAPES)
def test_rowqc_kernel_matches_ref(cuda_device, b, n):
    _fused_case(rowqc_pp, rowqc_half, rowqc_pp_ref, b, n, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 256, 256), (3, 384, 384),
                                   (2, 512, 256), (2, 1024, 1024),
                                   (1, 2048, 2048), (1, 4096, 4096),
                                   (2, 512, 7), (3, 2048, 100),
                                   (2, 1024, 1025)])
def test_colfft_scaled_kernel_matches_ref(cuda_device, shape):
    """B3s: the window on the column kernel's load, shared by the batch;
    two runs bit-equal, on the register-resident kernel at power-of-two
    Bk."""
    rng = np.random.default_rng(sum(shape) + 3)
    xr, xi = (torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                              device=cuda_device) for _ in range(2))
    sc = torch.as_tensor(rng.uniform(0.0, 1.0, shape[1:]).astype(np.float32),
                         device=cuda_device)
    gr, gi = _col_route(dft.colfft_scaled, (xr, xi, sc), shape[1])
    rr, ri = dft.colfft_scaled_ref(xr, xi, sc)
    scale = max(rr.abs().max().item(), ri.abs().max().item())
    assert max((gr - rr).abs().max().item(),
               (gi - ri).abs().max().item()) <= TOL_DFT * scale


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", _QC_SHAPES)
def test_rows_kernel_matches_ref(cuda_device, b, n):
    """B6s, alone and with the rows of zrow that rows_pp adds."""
    _fused_case(rows_pp, rows_half, rows_pp_ref, b, n, cuda_device)


def _rowcombine_case(n, nq, nco, device, seed):
    """B9 at (nco nq, n, n) on data drawn from ``seed`` against its plain
    version (rowfft, mirror, weighted sum over q) at TOL_QC, two runs
    bit-equal (fixed band order, fixed ownership), both launches on the
    register-resident kernel at a power-of-two Bk and on the radix-2
    kernel at any other Bk."""
    rng = np.random.default_rng(seed)
    yr, yi = (torch.as_tensor(rng.standard_normal((nco * nq, n, n))
                              .astype(np.float32), device=device)
              for _ in range(2))
    w = [torch.as_tensor(rng.standard_normal((nq, n, n)).astype(np.float32),
                         device=device) for _ in range(4)]
    lib = _build.library()
    before = rowcombine_pp.launches, lib.rowcombine_regs_launches()
    got = rowcombine_pp(yr, yi, *w, nq)
    again = rowcombine_pp(yr, yi, *w, nq)
    torch.cuda.synchronize()
    assert rowcombine_pp.launches == before[0] + 2
    bk = n // 128
    regs = lib.rowcombine_regs_launches() - before[1]
    assert regs == (0 if bk & (bk - 1) else 2), (n, regs)
    ref = rowcombine_pp_ref(yr, yi, *w, nq)
    scale = ref[0].abs().max().item()
    for g, a, r in zip(got, again, ref):
        assert g.shape == r.shape == (nco, n, n)
        assert (g - r).abs().max().item() <= TOL_QC * scale
        assert torch.equal(g, a)


@pytest.mark.cuda
@pytest.mark.parametrize("n,nq,nco", [(256, 2, 3), (384, 3, 2), (512, 1, 2)])
def test_rowcombine_kernel_matches_ref(cuda_device, n, nq, nco):
    """B9 against its plain version, bit-reproducible, on the kernel its Bk
    calls for."""
    _rowcombine_case(n, nq, nco, cuda_device, n + nq)


# B9 on the register-resident kernel at every power-of-two Bk: coadd
# counts that fill no block of G = coadds_per_block(n) coadds (1, G + 1,
# 33), nq 1 and 3; 33 coadds of 3 pairs up to 512, one pair above; one
# coadd of one pair at 4096 (the plain version's memory)
_B9_GROUPS = [(n, nq, nco) for n in (256, 512) for nq in (1, 3)
              for nco in ("1", "G+1", "33")] \
    + [(n, nq, nco) for n in (1024, 2048) for nq in (1, 3)
       for nco in ("1", "G+1")] \
    + [(1024, 1, "33"), (2048, 1, "33"), (4096, 1, "1")]


@pytest.mark.cuda
@pytest.mark.parametrize("n,nq,nco", _B9_GROUPS)
def test_rowcombine_regs_kernel_coadd_groups(cuda_device, n, nq, nco):
    """The register-resident B9 with coadd counts that fill no block."""
    g = coadds_per_block(n)
    nco = {"1": 1, "G+1": g + 1, "33": 33}[nco]
    _rowcombine_case(n, nq, nco, cuda_device, n + nq + nco)


@pytest.mark.cuda
def test_cross_bandpowers_on_the_card(cuda_device):
    """cross_bandpowers(m, m) is map_bandpowers(m) on the kernels, and the
    fused window equals pre-multiplied maps."""
    n = 256
    geom = tp.rect_geometry(width_arcmin=n * 2.0, px_res_arcmin=2.0)
    fc = FastCl(geom, bin_edges=np.arange(100, 2500, 150.0))
    assert fc.device.type == "cuda"
    rng = np.random.default_rng(8)
    m1, m2 = (torch.as_tensor(rng.standard_normal((4, n, n))
                              .astype(np.float32), device=cuda_device)
              for _ in range(2))
    before = (dft.colfft_scaled.launches, rows_half.launches)
    auto = fc.map_bandpowers(m1)
    cross = fc.cross_bandpowers(m1, m1)
    assert ((cross - auto).abs() / auto.abs()).max().item() <= 5e-5
    taper, _ = get_taper(geom, taper_percent=12.0)
    a = fc.cross_bandpowers(m1, m2, window=taper)
    b = fc.cross_bandpowers(m1 * taper, m2 * taper)
    torch.cuda.synchronize()
    assert (dft.colfft_scaled.launches, rows_half.launches) == \
        (before[0] + 1, before[1] + 3)
    assert (a - b).abs().max().item() <= 2e-5 * b.abs().max().item()


def _asym_rings(lmax):
    """A Gauss-Legendre grid with its first ring moved: not north-south
    symmetric, so the transforms take the unfolded kernels."""
    r = sht.gauss_legendre_rings(lmax)
    th = np.asarray(r.theta_array())
    th[0] *= 0.9
    return sht.RingGeom(tuple(th.tolist()), r.weights, r.nphi)


@pytest.mark.cuda
@pytest.mark.parametrize("lmax,grid,ns,ni,B,mode", [
    (1023, "gl", (0,), 0, 3, "f32"),       # fold, 16 warps, dead groups
    (1023, "gl", (0,), 0, 9, "fast"),      # B10a: groups of 5 + 4 maps
    (300, "asym", (0,), 0, 2, "f32"),      # unfolded, 301 rings: ragged
    (300, "gl", (-2, 2), 1, 2, "f64"),     # spin column, northern rings
    (1023, "gl", (-2, 2), 0, 16, "f32"),   # config 8p: 16 maps, one launch
    (200, "cc", (0,), 0, 1, "f64"),        # Clenshaw-Curtis, odd T
    (1023, "gl", (0,), 0, 16, "f32"),      # fold, 16 maps: B10s one launch
    (1023, "gl", (0,), 0, 16, "fast"),     # the same, fast
    (700, "asym", (0,), 0, 3, "f32"),      # 701 rings: two per lane, ragged
    (1100, "asym", (0,), 0, 5, "f64"),     # 1101 rings: three B10a groups
    (300, "over", (0,), 0, 12, "f32"),     # rings exact to 3 lmax: 451
    (1023, "over", (0,), 0, 12, "f32"),    # 1535 rings, 12 maps, folded
    (2047, "over", (0,), 0, 12, "f32"),    # the curved-sky QE's B10a: 3072
                                           # rings, one pass, a cluster of 6
    (1023, "x2", (0,), 0, 9, "fast"),      # one pass, 2050 rings: 5 blocks
    (1023, "x2", (0,), 0, 16, "f64"),      # one pass, 16 maps, float64
])
def test_legendre_kernels_match_ref(cuda_device, lmax, grid, ns, ni, B,
                                    mode):
    rings = {"gl": sht.gauss_legendre_rings, "asym": _asym_rings,
             "cc": lambda L: sht.clenshaw_curtis_rings(2 * L + 1),
             # the curved-sky QE's grid: exact to degree 3 lmax
             "over": lambda L: sht.gauss_legendre_rings(-(-3 * L // 2)),
             # 1025 kernel rings: B10a's one-pass form
             "x2": lambda L: sht.gauss_legendre_rings(2 * L + 3)}[
                 grid](lmax)
    layout = ("full" if grid == "asym" else
              "half" if ns != (0,) else "fold")
    tab = leg.tables(lmax, rings, ns, ni, layout, cuda_device)
    k = leg.kernel_tables(tab)
    M1 = lmax + 1
    if lmax >= 1023:
        # the dead-group skip engaged: groups that run no chunk
        assert k["ng"] >= 16 and (k["bounds"][M1:2 * M1] == 0).any()
    rdt = torch.float64 if mode == "f64" else torch.float32
    rng = np.random.default_rng(lmax + B)
    cplx = lambda *s: torch.complex(
        *(torch.as_tensor(rng.standard_normal(s), dtype=rdt,
                          device=cuda_device) for _ in range(2)))
    fast = mode == "fast"
    G = cplx(B, tab["Tr"], lmax + 1)
    a = cplx(B, lmax + 1, lmax + 1)
    for fn, ref_fn, x in (
            (leg.legendre_ana, leg.legendre_ana_ref, G),
            (leg.legendre_syn, leg.legendre_syn_ref, a)):
        before = fn.launches
        got = fn(x, tab, fast)
        again = fn(x, tab, fast)
        one = fn(x[-1:], tab, fast)
        torch.cuda.synchronize()
        assert fn.launches == before + 2 * (-(-B // 16)) + 1  # 16 a launch
        assert got.dtype == x.dtype
        ref = ref_fn(x, tab)
        err = (got - ref).abs().max().item() / ref.abs().max().item()
        assert err <= TOL_LEG[mode], (fn.__name__, err)
        if fast:
            # the fast mode's plain version: the same float32 recurrence
            ref = ref_fn(x, tab, True)
            err = (got - ref).abs().max().item() / ref.abs().max().item()
            assert err <= TOL_LEG["fast_plain"], (fn.__name__, err)
        assert torch.equal(got, again)
        assert torch.equal(one[0], got[-1])     # a map alone = packed


@pytest.mark.cuda
@pytest.mark.parametrize("lmax", [255, 256])
def test_sht_card_vs_cpu(cuda_device, lmax):
    """The public transforms on the card (B10a/B10s) against the CPU's
    plain versions, spin 0 and spin 2, even and odd ring counts."""
    rings = sht.gauss_legendre_rings(lmax)
    rng = np.random.default_rng(lmax)
    maps = torch.as_tensor(rng.standard_normal((3, 2) + rings.shape)
                           .astype(np.float32))
    cases = ((sht.map2alm, (maps[:, 0],)),
             (sht.map2alm_spin, (maps[:, 0], maps[:, 1])))
    for fn, args in cases:
        got = fn(*(x.to(cuda_device) for x in args), rings, lmax)
        ref = fn(*args, rings, lmax)
        for g, r in zip(got if isinstance(got, tuple) else (got,),
                        ref if isinstance(ref, tuple) else (ref,)):
            err = (g.cpu() - r).abs().max().item() / r.abs().max().item()
            assert err <= 1e-6, (fn.__name__, err)
    alm = sht.map2alm(maps[:, 0], rings, lmax)
    for fn, args in ((sht.alm2map, (alm,)), (sht.alm2map_spin, (alm, alm))):
        got = fn(*(x.to(cuda_device) for x in args), rings, lmax)
        ref = fn(*args, rings, lmax)
        for g, r in zip(got if isinstance(got, tuple) else (got,),
                        ref if isinstance(ref, tuple) else (ref,)):
            err = (g.cpu() - r).abs().max().item() / r.abs().max().item()
            assert err <= 1e-6, (fn.__name__, err)


def _randn(rng, shape, device):
    return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                           device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(3, 256), (5, 384), (1, 2048)])
def test_half_plane_field_kernels_match_ref(cuda_device, b, n):
    """B6h ``qc_pp_half`` and B6h' ``s_pp_half`` on a stored plane: within
    TOL_HALF of the plain versions, two runs bit-equal, and the full-plane
    sums recovered from the half plane and the two boundary rows."""
    rng = np.random.default_rng(n + b)
    zr, zi = _randn(rng, (b, n, n), cuda_device), _randn(rng, (b, n, n),
                                                         cuda_device)
    before = qc_pp_half.launches, s_pp_half.launches
    qs, c = qc_pp_half(zr, zi)
    s = s_pp_half(zr, zi)
    qs2, c2 = qc_pp_half(zr, zi)
    s2 = s_pp_half(zr, zi)
    torch.cuda.synchronize()
    assert (qc_pp_half.launches, s_pp_half.launches) == (before[0] + 2,
                                                         before[1] + 2)
    rq, rc = qc_pp_half_ref(zr, zi)
    rs = s_pp_half_ref(zr, zi)
    for got, ref, again in ((qs, rq, qs2), (c, rc, c2), (s, rs, s2)):
        assert got.shape == (b, n // 2, n)
        assert (got - ref).abs().max().item() \
            <= TOL_HALF * ref.abs().max().item()
        assert torch.equal(got, again)
    # 2 * half - row(ky = 0) + row(ky = n/2) is the full plane's sum
    full = (zr.double() ** 2 + zi.double() ** 2).sum((1, 2))
    half = 2 * qs.double().sum((1, 2)) - qs[:, 0].double().sum(1)
    p = dft.half_rows(n)[0]
    assert p[0] == 0
    mr, mi = mirror_pp_ref(zr, zi)
    nyq = 0.5 * (zr[:, 64].double() ** 2 + zi[:, 64].double() ** 2
                 + mr[:, 64].double() ** 2 + mi[:, 64].double() ** 2).sum(1)
    assert torch.allclose(half + nyq, full, rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [384, 512, 2048])
def test_half_plane_field_kernels_match_fused(cuda_device, n):
    """B6h/B6h' on ``Z = rowfft(Y)`` against B6/B6s, which transform the
    rows themselves: within TOL_HALF of max, and where both transforms run
    the same core (n = 384) within an ulp of each term's size (``qs``
    bounds ``|c|`` and ``|s|`` pointwise)."""
    rng = np.random.default_rng(17)
    yr, yi = _randn(rng, (2, n, n), cuda_device), _randn(
        rng, (2, n, n), cuda_device)
    zr, zi = dft.rowfft(yr, yi)
    qs, c = qc_pp_half(zr, zi)
    s = s_pp_half(zr, zi)
    fq, fc = rowqc_half(yr, yi)
    fs = rows_half(yr, yi)
    ulp = 2.0 ** -23 * qs + 1e-30
    for got, fused in ((qs, fq), (c, fc), (s, fs)):
        assert (got - fused).abs().max().item() \
            <= TOL_HALF * qs.abs().max().item()
        if n == 384:
            assert ((got - fused).abs() <= 2 * ulp).all()


@pytest.mark.cuda
def test_half_plane_field_kernels_refuse_strides(cuda_device):
    z = torch.zeros((2, 256, 512), device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        qc_pp_half(z[:, :, ::2], z[:, :, ::2])
    with pytest.raises(ValueError, match="contiguous"):
        s_pp_half(z[:, :, ::2], z[:, :, ::2])
    flat = torch.zeros((2, 1000), device=cuda_device)
    ids = torch.zeros(500, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        bin_pair_power(*(flat[:, ::2],) * 4, ids, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("sym", [False, True])
@pytest.mark.parametrize("B,n,nseg", [(3, 256 * 256, 1), (5, 384 * 384, 24),
                                      (2, 2048 * 2048, 100),
                                      (1, 512 * 512 + 37, 400)])
def test_bin_pair_power_kernel_matches_ref(cuda_device, B, n, nseg, sym):
    """B2': within TOL_BIN of the binned |field| (c cancels, so its error
    is read against bin(|c|)), two runs bit-equal; most pixels in the last
    segment, as radial binning leaves them."""
    rng = np.random.default_rng(n + nseg)
    planes = [_randn(rng, (B, n), cuda_device) for _ in range(4)]
    ids_np = rng.integers(0, nseg, n)
    ids_np[rng.random(n) < 0.6] = nseg - 1
    ids = torch.as_tensor(ids_np.astype(np.int32), device=cuda_device)
    before = bin_pair_power.launches
    bq, bc = bin_pair_power(*planes, ids, nseg, sym=sym)
    bq2, bc2 = bin_pair_power(*planes, ids, nseg, sym=sym)
    torch.cuda.synchronize()
    assert bin_pair_power.launches == before + 2
    rq, rc = bin_pair_power_ref(*planes, ids, nseg, sym)
    zr, zi, mr, mi = planes
    absc = bin_reduce_ref((zr * mr - zi * mi).abs(), ids, nseg)
    assert bq.shape == bc.shape == (B, nseg)
    assert ((bq - rq).abs() <= TOL_BIN * rq).all()
    assert ((bc - rc).abs() <= TOL_BIN * absc).all()
    assert torch.equal(bq, bq2) and torch.equal(bc, bc2)


def _dropped_ids(rng, n, nseg, device):
    """Ids in [0, nseg) with -1 (dropped segments) on about 80 % of the
    elements, in runs as FastCl's edge segments leave them, including one
    run longer than a block's span (40,000 elements: every step of a block
    dead), and a few ids >= nseg."""
    ids = rng.integers(0, nseg, n)
    runs = rng.random(n // 64 + 1) < 0.8
    ids[np.repeat(runs, 64)[:n]] = -1
    ids[1000:41000] = -1
    ids[rng.random(n) < 0.001] = nseg + 5
    return torch.as_tensor(ids.astype(np.int32), device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,nseg", [(7, 300_000, 100), (5, 131_073, 400),
                                      (1, 70_000, 3)])
def test_bin_kernels_with_dropped_ids(cuda_device, B, n, nseg):
    """B1 (weighted and not), B2 and B2' (sym False and True) over ids with
    -1 runs: spans with only dropped ids, batch counts that are not a
    multiple of a block's rows, nseg 400 over two segment tiles. Each
    output within TOL_BIN of the binned |field| (the dropped elements are
    in no bin), two runs bit-equal."""
    rng = np.random.default_rng(B * n + nseg)
    ids = _dropped_ids(rng, n, nseg, cuda_device)
    d = [_randn(rng, (B, n), cuda_device) for _ in range(4)]
    w = torch.as_tensor(rng.integers(1, 3, n).astype(np.float32),
                        device=cuda_device)
    for weights in (None, w):
        out = bin_reduce(d[0], ids, nseg, weights)
        again = bin_reduce(d[0], ids, nseg, weights)
        torch.cuda.synchronize()
        ref = bin_reduce_ref(d[0], ids, nseg, weights)
        absref = bin_reduce_ref(d[0].abs(), ids, nseg, weights)
        assert ((out - ref).abs() <= TOL_BIN * absref).all()
        assert torch.equal(out, again)
    out = bin2_reduce(d[0], d[1], ids, nseg)
    again = bin2_reduce(d[0], d[1], ids, nseg)
    torch.cuda.synchronize()
    for o, a, r, x in zip(out, again, bin2_reduce_ref(d[0], d[1], ids, nseg),
                          d[:2]):
        absref = bin_reduce_ref(x.abs(), ids, nseg)
        assert ((o - r).abs() <= TOL_BIN * absref).all()
        assert torch.equal(o, a)
    zr, zi, mr, mi = d
    absc = bin_reduce_ref((zr * mr - zi * mi).abs(), ids, nseg)
    for sym in (False, True):
        bq, bc = bin_pair_power(*d, ids, nseg, sym=sym)
        bq2, bc2 = bin_pair_power(*d, ids, nseg, sym=sym)
        torch.cuda.synchronize()
        rq, rc = bin_pair_power_ref(*d, ids, nseg, sym)
        assert ((bq - rq).abs() <= TOL_BIN * rq).all()
        assert ((bc - rc).abs() <= TOL_BIN * absc).all()
        assert torch.equal(bq, bq2) and torch.equal(bc, bc2)
    # every id dropped: zeros, and no data read
    none = torch.full((n,), -1, dtype=torch.int32, device=cuda_device)
    assert not bin2_reduce(d[0], d[1], none, nseg)[0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("order", [3, 5])
def test_lens_kernel_ragged_components_wide_blocks(cuda_device, order):
    """B8 on a ragged 250 x 130 grid (no side a multiple of the tile), two
    batch entries of three components: at the pipeline's cap D = 8 no block
    is wide; with D = max(ny, nx) and a deflection of up to 15 pixels
    some blocks' floors span more than the window and take their taps from
    device memory (the counter shows them). Within TOL_LENS of
    ``lens_map_ref`` either way; two runs bit-equal."""
    lib = _build.library()
    assert (lib.lens_spline_tile_rows(), lib.lens_spline_tile_cols()) \
        == TILE
    assert lib.lens_spline_window_range() == WINDOW_RANGE
    geom = tp.rect_geometry(width_arcmin=130 * 2.0, height_arcmin=250 * 2.0,
                            px_res_arcmin=2.0)
    assert geom.shape == (250, 130)
    rng = np.random.default_rng(order)
    maps = _randn(rng, (2, 3) + geom.shape, cuda_device)
    coeffs = spline_coeffs(maps, geom, order).contiguous()
    k = np.fft.fft2(rng.standard_normal((2, 2) + geom.shape))
    ky = np.fft.fftfreq(geom.shape[0])[:, None]
    kx = np.fft.fftfreq(geom.shape[1])[None, :]
    smooth = np.fft.ifft2(k * np.exp(-(ky ** 2 + kx ** 2) / 0.001)).real
    smooth /= np.abs(smooth).max()
    nblocks = 2 * (-(-250 // TILE[0])) * (-(-130 // TILE[1]))
    for amax_px, D, wide in ((6.0, 8, False), (15.0, max(geom.shape), True)):
        alpha = torch.as_tensor((smooth * amax_px * geom.dy)
                                .astype(np.float32), device=cuda_device)
        lens_map_kernel.wide_blocks(reset=True)
        out = lens_map_kernel(coeffs, alpha, geom, order=order,
                              maxdisp_px=D, prefiltered=True)
        again = lens_map_kernel(coeffs, alpha, geom, order=order,
                                maxdisp_px=D, prefiltered=True)
        count = lens_map_kernel.wide_blocks()
        assert (0 < count < 2 * nblocks) if wide else count == 0, count
        ref = lens_map_ref(coeffs, alpha, geom, order, D)
        err = (out - ref).abs().max().item()
        assert err <= TOL_LENS * ref.abs().max().item(), (amax_px, err)
        assert torch.equal(out, again)


@pytest.mark.cuda
def test_bin_reduce_at_config5_ids(cuda_device):
    """B1 at bench config 5's profile binning: 10^4 stamps of 64^2 at 0.5'
    over the ids of Bin2D(modrmap, arange(0, 10, 1)'), nseg 11 (most
    pixels lie beyond 9' and are summed into the last segment)."""
    from orphics_tpu_torch.geometry import arcmin
    from orphics_tpu_torch.ops.binning import Bin2D
    g = tp.Geometry(64, 64, 0.5 * arcmin, 0.5 * arcmin)
    pb = Bin2D(g.modrmap_np(), np.arange(0.0, 10.0, 1.0) * arcmin,
               device=cuda_device)
    assert pb._nseg == 11
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    data = torch.randn((10_000, 4096), generator=gen, device=cuda_device)
    before = bin_reduce.launches
    out = bin_reduce(data, pb._ids, pb._nseg)
    again = bin_reduce(data, pb._ids, pb._nseg)
    torch.cuda.synchronize()
    assert bin_reduce.launches == before + 2
    ref = bin_reduce_ref(data, pb._ids, pb._nseg)
    absref = bin_reduce_ref(data.abs(), pb._ids, pb._nseg)
    assert ((out - ref).abs() <= TOL_BIN * absref).all()
    assert torch.equal(out, again)


@pytest.mark.cuda
def test_stacking_step_card_matches_cpu(cuda_device):
    """Config 5's fill and profiles at 64^2 on 64 stamps: the card (one
    shared-geometry product, B1) against the CPU (plain versions) on the
    same stamps and float32 geometry."""
    from orphics_tpu_torch.geometry import arcmin
    from orphics_tpu_torch.ops.binning import Bin2D
    from orphics_tpu_torch.ops.fourier import gauss_beam
    from orphics_tpu_torch.models import pixcov
    g = tp.Geometry(64, 64, 0.5 * arcmin, 0.5 * arcmin)
    th = default_theory()
    m1, m2 = pixcov.get_geometry_regions(1, 64, 0.5 * arcmin, 5 * arcmin)
    scov = pixcov.scov_from_theory(g, th, lambda l: gauss_beam(l, 1.4),
                                   ncomp=1, device=cuda_device)
    nvar = (10.0 * arcmin) ** 2 / (g.dy * g.dx)
    cs, mm = pixcov.make_geometry(
        scov + nvar * torch.eye(4096, dtype=torch.float64,
                                device=cuda_device), m1, m2, ncomp=1)
    mm = mm.to(torch.float32)
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    st = torch.randn((64, 1, 64, 64), generator=gen, device=cuda_device)
    got = pixcov.inpaint_stamps_batched(st, cs, mm, m1, m2)
    want = pixcov.inpaint_stamps_batched(st.cpu(), cs.cpu(), mm.cpu(), m1, m2)
    assert (got.cpu() - want).abs().max() <= 1e-5 * want.abs().max()
    edges = np.arange(0.0, 10.0, 1.0) * arcmin
    pg = Bin2D(g.modrmap_np(), edges, device=cuda_device).bin(got[:, 0])[1]
    pc = Bin2D(g.modrmap_np(), edges, device="cpu").bin(want[:, 0])[1]
    assert (pg.cpu() - pc).abs().max() <= 1e-5 * pc.abs().max()


@pytest.mark.cuda
def test_lens_cov_card_matches_cpu(cuda_device):
    """nfwfit.lens_cov at 32^2, order 5: two B8 launches on the card
    against the CPU's plain path, within the displacement contract."""
    from orphics_tpu_torch.models import nfwfit
    g = tp.rect_geometry(width_arcmin=32 * 2.0, px_res_arcmin=2.0)
    rng = np.random.default_rng(7)
    A = rng.standard_normal((1024, 1024)).astype(np.float32)
    U = torch.as_tensor(A @ A.T / 1024)
    alpha = torch.as_tensor((rng.standard_normal((2, 32, 32)) * g.dy * 0.7)
                            .astype(np.float32))
    before = lens_map_kernel.launches
    got = nfwfit.lens_cov(U.to(cuda_device), alpha.to(cuda_device), g)
    torch.cuda.synchronize()
    assert lens_map_kernel.launches == before + 2
    want = nfwfit.lens_cov(U, alpha, g)
    assert (got.cpu() - want).abs().max() <= TOL_LENS * want.abs().max()


# Map-tools slice. Pure B: the card's float32 binned spectra against the
# CPU's float32 run of the same path, 1e-5 of each spectrum's max (cuFFT
# against pocketfft, B1 against its plain version), and against the CPU's
# float64 run, 1e-4 (chip_smoke.py phase 16 states the reading). Rotation:
# the same host float64 positions and float32 weights on both devices,
# 1e-6 of max. healpix.smoothing in float64: the B10 kernels' fp64 sums
# against the plain loop, 1e-10 of max.
TOL_PUREB = {torch.float32: 1e-5, torch.float64: 1e-4}


def _pure_b_spectra(geom, iqu, window, binner):
    from orphics_tpu_torch.models.mapstools import Purify
    fT, fE, fB = Purify(geom, window).lteb_from_iqu(iqu * window)
    f = torch.stack([fT, fE, fB], -3)
    p2d = (f.conj() * f).real * (geom.area / geom.npix ** 2)
    return binner.bin(p2d.to(torch.float32))[1]


@pytest.mark.cuda
def test_pure_b_card_matches_cpu(cuda_device):
    from orphics_tpu_torch.ops.binning import Bin2D
    geom = tp.rect_geometry(width_arcmin=256 * 2.0, px_res_arcmin=2.0)
    mg = grf.MapGen(geom, grf.cmb_ps(default_theory()), device="cpu")
    eta = grf.rand_kmap(geom, torch.Generator().manual_seed(16), 3,
                        batch=(2,), device="cpu")
    iqu = mg.get_map_from_noise(eta)
    win = get_taper(geom, taper_percent=18.0, device="cpu")[0]
    edges = np.arange(300, 2500, 200.0)
    before = bin_reduce.launches
    got = _pure_b_spectra(geom, iqu.to(cuda_device), win.to(cuda_device),
                          Bin2D(geom.modlmap_np(), edges,
                                device=cuda_device)).cpu()
    assert bin_reduce.launches == before + 1
    binner = Bin2D(geom.modlmap_np(), edges, device="cpu")
    for dt, tol in TOL_PUREB.items():
        ref = _pure_b_spectra(geom, iqu.to(dt), win.to(dt), binner)
        scale = ref.abs().amax(dim=-1, keepdim=True)
        assert ((got - ref).abs() <= tol * scale).all(), dt


@pytest.mark.cuda
def test_rotate_map_card_matches_cpu(cuda_device):
    from orphics_tpu_torch.models import curved
    src = tp.rect_geometry(width_arcmin=256 * 2.0, px_res_arcmin=2.0,
                           y0_deg=-40.0)
    rng = np.random.default_rng(40)
    imap = torch.as_tensor(rng.standard_normal(src.shape).astype(np.float32))
    rot = curved.MapRotatorEquator(src, (src.y0, 0.2), 4.0, 3.0,
                                   device=cuda_device)
    got = rot.rotate(imap.to(cuda_device)).cpu()
    ref = curved.MapRotatorEquator(src, (src.y0, 0.2), 4.0, 3.0,
                                   device="cpu").rotate(imap)
    assert ref.abs().max() > 0
    assert (got - ref).abs().max() <= 1e-6 * ref.abs().max()
    tgt = tp.rect_geometry(width_arcmin=200 * 2.0, px_res_arcmin=2.0,
                           y0_deg=-39.0)
    got = curved.rotate_map(imap.to(cuda_device), src, tgt).cpu()
    ref = curved.rotate_map(imap, src, tgt)
    assert ref.abs().max() > 0
    assert (got - ref).abs().max() <= 1e-6 * ref.abs().max()


@pytest.mark.cuda
def test_healpix_smoothing_card_matches_cpu(cuda_device):
    from orphics_tpu_torch.utils import healpix
    nside = 64
    hmap = np.random.default_rng(64).standard_normal(12 * nside * nside)
    a0, s0 = leg.legendre_ana.launches, leg.legendre_syn.launches
    got = healpix.smoothing(hmap, np.deg2rad(1.0), device=cuda_device)
    assert leg.legendre_ana.launches > a0 and leg.legendre_syn.launches > s0
    ref = healpix.smoothing(hmap, np.deg2rad(1.0), device="cpu")
    assert np.abs(got - ref).max() <= 1e-10 * np.abs(ref).max()


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,nseg,weighted", [(24, 512 * 512, 16, False),
                                               (3, 1000, 300, True)])
def test_bin_reduce_float64_kernel_matches_ref(cuda_device, B, n, nseg,
                                               weighted):
    """B1's float64 instance: float64 sums within 1e-12 of the binned |data|
    of the float64 plain version, reproducible; ids outside [0, nseg)
    dropped; nseg 300 takes two segment tiles."""
    rng = np.random.default_rng(n + 64)
    data = torch.as_tensor(rng.standard_normal((B, n)), device=cuda_device)
    ids = torch.as_tensor(rng.integers(-1, nseg + 1, n).astype(np.int32),
                          device=cuda_device)
    w = (torch.as_tensor(rng.uniform(0.5, 2.0, n), device=cuda_device)
         if weighted else None)
    before, b64 = bin_reduce.launches, bin_reduce.launches_f64
    out = bin_reduce(data, ids, nseg, w)
    again = bin_reduce(data, ids, nseg, w)
    torch.cuda.synchronize()
    assert bin_reduce.launches == before + 2
    assert bin_reduce.launches_f64 == b64 + 2
    assert out.dtype == torch.float64
    ref = bin_reduce_ref(data, ids, nseg, w)
    absref = bin_reduce_ref(data.abs(), ids, nseg, w)
    assert ((out - ref).abs() <= 1e-12 * absref).all()
    assert torch.equal(out, again)


@pytest.mark.cuda
def test_binned_map_card_matches_cpu(cuda_device):
    """catalogs.binned_map: unweighted counts equal, weighted 1e-12 of max,
    and the float64 Bin2D of a map on B1 against the CPU's."""
    from orphics_tpu_torch.models import catalogs as cats
    from orphics_tpu_torch.ops.binning import Bin2D
    geom = tp.rect_geometry(width_arcmin=256 * 0.5, px_res_arcmin=0.5)
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    decs, ras = cats.random_catalog_flat(gen, geom, 200_000,
                                         device=cuda_device)
    w = torch.rand(200_000, generator=gen, device=cuda_device,
                   dtype=torch.float64) + 0.5
    cnt = cats.binned_map(decs, ras, geom)
    assert cnt.is_cuda and cnt.dtype == torch.float64
    assert torch.equal(cnt.cpu(), cats.binned_map(decs.cpu(), ras.cpu(),
                                                  geom))
    wm = cats.binned_map(decs, ras, geom, w).cpu()
    ref = cats.binned_map(decs.cpu(), ras.cpu(), geom, w.cpu())
    assert (wm - ref).abs().max() <= 1e-12 * ref.abs().max()
    edges = np.arange(200.0, 3001.0, 200.0)
    before = bin_reduce.launches_f64
    got = Bin2D(geom.modlmap_np(), edges, device=cuda_device).bin(
        torch.fft.fft2(cnt).abs() ** 2)[1]
    assert bin_reduce.launches_f64 == before + 1 and got.dtype == \
        torch.float64
    want = Bin2D(geom.modlmap_np(), edges, device="cpu").bin(
        torch.fft.fft2(cnt.cpu()).abs() ** 2)[1]
    assert ((got.cpu() - want).abs() <= 1e-10 * want.abs()).all()


@pytest.mark.cuda
def test_reconstruct_velocities_card_matches_cpu(cuda_device):
    from orphics_tpu_torch.models import catalogs as cats
    rng = np.random.default_rng(32)
    cat = [rng.uniform(-10, 10, 20000), rng.uniform(-10, 10, 20000),
           rng.uniform(0.4, 0.7, 20000), rng.uniform(-10, 10, 100000),
           rng.uniform(-10, 10, 100000), rng.uniform(0.4, 0.7, 100000)]
    kw = dict(zeff=0.55, nmesh=48, smoothing_radius=15.0)
    got = cats.reconstruct_velocities(*(torch.as_tensor(a, device=cuda_device)
                                        for a in cat), **kw)
    assert got.is_cuda and got.dtype == torch.float64
    ref = cats.reconstruct_velocities(*cat, device="cpu", **kw)
    assert (got.cpu() - ref).abs().max() <= 1e-8 * ref.abs().max()


# the QE's filter algebra: the kernels compute the plain versions' products
# in the same order but contract them into fused multiply-adds: 1e-6 of max
# (float32), 1e-13 (float64)
TOL_QE_CONV = {torch.float32: 1e-6, torch.float64: 1e-13}


@pytest.mark.cuda
@pytest.mark.parametrize("real", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(3, 64, 64), (2, 37, 50), (9, 512, 512)])
def test_qe_conv_kernels_match_ref(cuda_device, real, shape):
    """The leg, pair and post kernels against their plain versions: a
    ragged plane, a batch past the leg and post kernels' rows a block, a
    leg of batch 1 against legs of the batch, self-products, earlier sums,
    and the most legs and products a launch takes."""
    from orphics_tpu_torch.ops import qe_conv as qc
    lib = _build.library()
    assert (lib.qe_conv_max_legs(), lib.qe_conv_max_products()) == \
        (qc.MAX_LEGS, qc.MAX_PRODUCTS)
    cplx = torch.complex64 if real == torch.float32 else torch.complex128
    gen = torch.Generator(device=cuda_device).manual_seed(sum(shape))
    rnd = lambda *s, dt=real: torch.randn(s, generator=gen, dtype=dt,
                                          device=cuda_device)
    b = shape[0]
    rel = lambda g, r: ((g - r).abs().max() / r.abs().max()).item()
    tol = TOL_QE_CONV[real]
    src = rnd(*shape, dt=cplx)
    planes = rnd(qc.MAX_LEGS, *shape[1:])
    before = qc.qe_leg.launches
    got = qc.qe_leg(src, planes)
    assert qc.qe_leg.launches == before + 1
    for g, r in zip(got, qc.qe_leg_ref(src, planes)):
        assert g.dtype == cplx and rel(g, r) <= tol
    legs = (rnd(1, *shape[1:], dt=cplx),) + tuple(
        rnd(*shape, dt=cplx) for _ in range(qc.MAX_LEGS - 1))
    pairs = tuple((j % 2, 0.5 + j, j % qc.MAX_LEGS, (3 * j + 1) % qc.MAX_LEGS)
                  for j in range(qc.MAX_PRODUCTS - 1)) + ((1, -2.0, 0, 0),)
    prev = (rnd(*shape, dt=cplx), rnd(*shape, dt=cplx))
    for p in (None, prev):
        before = qc.qe_pair.launches
        got = qc.qe_pair(legs, pairs, p)
        assert qc.qe_pair.launches == before + 1
        for g, r in zip(got, qc.qe_pair_ref(legs, pairs, p)):
            assert g.shape == (b,) + shape[1:] and rel(g, r) <= tol
    fy, fx = rnd(*shape, dt=cplx), rnd(*shape, dt=cplx)
    post = rnd(2, *shape[1:])
    before = qc.qe_post.launches
    got = qc.qe_post(fy, fx, post)
    assert qc.qe_post.launches == before + 1
    assert rel(got, qc.qe_post_ref(fy, fx, post)) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("est", ["TT", "EB"])
def test_kappa_from_map_card_matches_cpu(cuda_device, est):
    """The generic reconstruction on the three kernels and cuFFT against
    the same engine on the CPU, one leg and two; one launch of each kernel
    a call for TT's one leg (three distinct legs, one wave)."""
    from orphics_tpu_torch.models import qe as qemod
    from orphics_tpu_torch.models.theory import default_theory
    from orphics_tpu_torch.ops import fourier as F
    from orphics_tpu_torch.ops import qe_conv as qc
    geom = tp.rect_geometry(width_arcmin=128 * 2.0, px_res_arcmin=2.0)
    th = default_theory()
    engines = []
    for dev in (cuda_device, "cpu"):
        ct = qemod.lensing_noise_2d(geom, th, 1.4, 6.0, device=dev)
        engines.append(qemod.QE(
            geom, th, ct, xmask=F.mask_kspace(geom, lmin=100, lmax=3000,
                                              device=dev),
            kmask=F.mask_kspace(geom, lmin=40, lmax=2500, device=dev),
            device=dev))
    rng = np.random.default_rng(4)
    kx, ky = (np.fft.fft2(rng.standard_normal((4, 128, 128))).astype(
        np.complex64) for _ in range(2))
    for legs in ((kx,), (kx, ky)):
        counts = [f.launches for f in (qc.qe_leg, qc.qe_pair, qc.qe_post)]
        got = engines[0].kappa_from_map(
            est, *(torch.as_tensor(k, device=cuda_device) for k in legs))
        ran = [f.launches - c for f, c in zip(
            (qc.qe_leg, qc.qe_pair, qc.qe_post), counts)]
        if est == "TT" and len(legs) == 1:
            assert ran == [1, 1, 1]
        ref = engines[1].kappa_from_map(est, *(torch.as_tensor(k)
                                               for k in legs))
        assert ((got.cpu() - ref).abs().max() / ref.abs().max()).item() \
            <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("nrings,planes", [(1535, 2), (2303, 0)])
def test_curved_kappa_partial_planes(cuda_device, nrings, planes):
    """One ``kappa_from_alm`` call of 4 sims at lmax 1023 on
    ``gauss_legendre_rings(nrings)`` (12 folded product maps) under the
    profiler: one B10s and one B10a launch, and the output equal to the
    untraced call's. On 768 kernel rings B10a runs two ring groups, whose
    two partial planes the wrapper sums once in their span; on 1152 in one
    pass (a cluster of 5 blocks sums every ring on chip): no partial planes
    and no span of their sum."""
    import json
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from orphics_tpu_torch.models.curved_qe import CurvedQE
    from orphics_tpu_torch.ops import alm as almops
    lmax = 1023
    rings = sht.gauss_legendre_rings(nrings)
    cl = np.asarray(default_theory().lCl("TT", np.arange(lmax + 1)))
    ctot = cl + (10.0 * np.pi / 10800.0) ** 2
    qe = CurvedQE(rings, lmax, cl, ctot, lmin=100, device=cuda_device)
    talm = almops.synalm(torch.Generator(device=cuda_device).manual_seed(9),
                         ctot, lmax, batch=(4,), device=cuda_device)
    plain = qe.kappa_from_alm(talm)
    counters = lambda: (leg.legendre_ana.launches, leg.legendre_syn.launches,
                        leg.legendre_ana.partial_planes,
                        leg.legendre_ana.one_pass)
    before = counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced = qe.kappa_from_alm(talm)
        torch.cuda.synchronize()
    ran = [n - b for n, b in zip(counters(), before)]
    assert ran == [1, 1, planes, int(planes == 0)]
    with tempfile.TemporaryDirectory() as d:
        path = d + "/trace.json"
        prof.export_chrome_trace(path)
        with open(path) as f:
            names = [e["name"] for e in json.load(f)["traceEvents"]
                     if e.get("cat") == "user_annotation"]
    assert names.count("orphics.transforms.legendre_ana.partials") == \
        int(planes > 0)
    assert names.count("orphics.transforms.legendre_ana") == 1
    assert names.count("orphics.curved_qe.kappa_from_alm") == 1
    assert torch.equal(plain, traced)
