"""``work.py``'s least times equal the bound column of PERF.md's kernel
table at the shapes given there."""
from __future__ import annotations

import numpy as np
import pytest

from cmbbench import work as W

F4 = 4.0


def _ms(*work):
    return round(W.bound(*work)[0], 4)


def test_transform_bounds():
    rows = 96 * 2048
    planes = 96 * 2048 * 2048 * F4
    # B3 colfft (96, 2048^2) and (64, 512^2): re, im in and out
    assert _ms(2 * 2 * planes, W.fft_flops(2048, rows)) == 1.9231
    assert _ms(2 * 2 * 64 * 512 * 512 * F4, W.fft_flops(512, 64 * 512)) \
        == 0.0801
    # B3s colfft_scaled (64, 2048^2) with the taper
    rows2 = 64 * 2048
    assert _ms(2 * 2 * 64 * 2048 * 2048 * F4 + 2048 * 2048 * F4,
               W.fft_flops(2048, rows2) + 4.0 * rows2 * 2048) == 1.2871
    # B5 rowifft_noise_y (96, 2048^2) x 2: the draw's operations bound it
    b5 = (2048 * 2048 * F4 + 2 * F4 + 2 * F4 * rows * 2048,
          W.fft_flops(2048, rows) + W.NORMAL_FP32_OPS * 2 * rows * 2048, 0.0,
          W.PHILOX_INT_OPS_PER_PAIR * rows * 2048 / 2)
    assert _ms(*b5) == 1.0162 and W.bound(*b5)[1] == "operations"
    # B6 rowqc (96, 2048^2): Y in, the two half-plane fields out
    assert _ms(2 * planes + 2 * F4 * rows * 1024,
               W.fft_flops(2048, rows) + 8.0 * rows * 1024) == 1.4423


def test_lens_and_segment_sum_bounds():
    # B8 (64, 1, 512^2): coefficients, two deflections, the output
    n = 64 * 512 * 512
    assert _ms(4 * F4 * n, n * (2.0 * 36 + 16.0 * 6)) == 0.0801
    # B1 (192, 131,584), nseg 38, weighted
    B, N = 192, 131584
    assert _ms(F4 * (B * N + 2 * N + B * 38), 2.0 * B * N) == 0.0305


def test_kept_id_sectors_of_fastcl():
    """B2 over FastCl's kept ids at (96, 2,097,152) x 2, nseg 100: the
    32-byte sectors that hold a kept id."""
    dft = pytest.importorskip("orphics_tpu_torch.ops.dft")
    from orphics_tpu_torch.geometry import rect_geometry
    from orphics_tpu_torch.models.fastcl import drop_edge_segments
    geom = rect_geometry(width_arcmin=2048 * 0.5, px_res_arcmin=0.5)
    perm, _ = dft.row_perm(2048)
    edges = np.arange(80, 8000, 80.0)
    dig = np.digitize(geom.modlmap_np()[perm][:, perm], edges, right=True)
    p_of_h, _ = dft.half_rows(2048)
    ids = drop_edge_segments(dig[p_of_h].reshape(-1), 100)
    nb = W.bin_bytes(ids, 100, (96, ids.size, 2), 2 * 96 * 100 * F4)
    assert _ms(nb) == 0.0608


def test_bound_picks_the_larger():
    assert W.bound(3.35e9)[1] == "bytes"
    assert W.bound(0.0, 67e12)[0] == pytest.approx(1e3)
    assert W.ops_ms(0.0, 0.0, W.INT32_OP_PER_S) == pytest.approx(1e3)
