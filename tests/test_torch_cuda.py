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
from orphics_tpu_torch.models import grf, lensing
from orphics_tpu_torch.models.theory import default_theory
from orphics_tpu_torch.ops import dft
from orphics_tpu_torch.ops.bin_reduce import bin_reduce, bin_reduce_ref
from orphics_tpu_torch.ops.lens import lens_map_kernel, lens_map_ref, spline_coeffs
from orphics_tpu_torch.ops.mirror import mirror_pp, mirror_pp_ref
from orphics_tpu_torch.ops.noise_planes import noise_planes

torch.set_num_threads(1)

# B1: |kernel - float64 sum| <= 1e-6 of the binned |data| per bin.
TOL_BIN = 1e-6
# B8: fp32 tap sums in another order than the gather version: 2e-5 of max.
TOL_LENS = 2e-5
# B3/B4: fp32 transforms by another factorization than cuFFT's: 2e-5 of
# max|ref|, the JAX package's own bound for its kernels (test_core.py).
TOL_DFT = 2e-5


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


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_DFT_CASES))
@pytest.mark.parametrize("shape", [(2, 256, 256), (3, 384, 384),
                                   (2, 256, 200), (1, 640, 640)])
def test_dft_kernels_match_ref(cuda_device, name, shape):
    fn, ref_fn = _DFT_CASES[name]
    if name.startswith("row"):
        shape = (shape[0], shape[2], shape[1])    # the transform axis is -1
    rng = np.random.default_rng(sum(shape))
    xr, xi = (torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                              device=cuda_device) for _ in range(2))
    before = fn.launches
    gr, gi = fn(xr, xi)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    rr, ri = ref_fn(xr, xi)
    scale = max(rr.abs().max().item(), ri.abs().max().item())
    err = max((gr - rr).abs().max().item(), (gi - ri).abs().max().item())
    assert err <= TOL_DFT * scale, (name, shape, err / scale)


@pytest.mark.cuda
def test_rowifft_scaled_and_roundtrip(cuda_device):
    rng = np.random.default_rng(5)
    n = 384
    kr, ki = (torch.as_tensor(rng.standard_normal((2, n, n))
                              .astype(np.float32), device=cuda_device)
              for _ in range(2))
    sc = torch.as_tensor(rng.uniform(0.5, 2.0, (n, n)).astype(np.float32),
                         device=cuda_device)
    before = dft.rowifft_scaled_y.launches
    gr, gi = dft.rowifft_scaled_y(kr, ki, sc)
    torch.cuda.synchronize()
    assert dft.rowifft_scaled_y.launches == before + 1
    rr, ri = dft.rowifft_scaled_y_ref(kr, ki, sc)
    scale = rr.abs().max().item()
    assert (gr - rr).abs().max().item() <= TOL_DFT * scale
    assert (gi - ri).abs().max().item() <= TOL_DFT * scale
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
