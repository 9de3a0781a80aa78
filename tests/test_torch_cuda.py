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
from orphics_tpu_torch.ops.bin_reduce import bin_reduce, bin_reduce_ref
from orphics_tpu_torch.ops.lens import lens_map_kernel, lens_map_ref, spline_coeffs

torch.set_num_threads(1)

# B1: |kernel - float64 sum| <= 1e-6 of the binned |data| per bin.
TOL_BIN = 1e-6
# B8: fp32 tap sums in another order than the gather version: 2e-5 of max.
TOL_LENS = 2e-5


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
