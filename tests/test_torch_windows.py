"""Parity of the port's apodization windows (``orphics_tpu_torch.ops.windows``)
with ``orphics_tpu.ops.windows``.

Both packages compute the windows in float64 numpy and round them to
float32, so the taper planes are array-equal. ``w2`` is the mean of the
float32 square: the port sums it in float64, the JAX package in float32
in XLA's order, so the two agree to 2e-6 relative (a few float32 ulp).
"""
import numpy as np
import pytest
import torch

from orphics_tpu import geometry as jgeo
from orphics_tpu.ops import windows as JW

import orphics_tpu_torch as tp
from orphics_tpu_torch.ops import windows as TW

torch.set_num_threads(1)

RTOL_W2 = 2e-6


def _geoms(ny, nx, res):
    kw = dict(width_arcmin=nx * res, height_arcmin=ny * res,
              px_res_arcmin=res)
    return jgeo.rect_geometry(**kw), tp.rect_geometry(**kw)


@pytest.mark.parametrize("args", [(64, 64, 30, 30, 0, 0),
                                  (48, 80, 10, 5, 3, 2),
                                  (33, 40, 0, 7, 0, 4),
                                  (20, 20, 6, 0, 2, 0)])
def test_cosine_window_equal(args):
    got = TW.cosine_window(*args, device="cpu")
    want = np.asarray(JW.cosine_window(*args))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape,res,kw", [
    ((256, 256), 2.0, dict(taper_percent=12.0)),
    ((2048, 2048), 0.5, dict(taper_percent=12.0)),
    ((96, 160), 1.0, dict(taper_percent=8.0, pad_percent=1.0)),
])
def test_get_taper_equal(shape, res, kw):
    jg, tg = _geoms(*shape, res)
    want, w2_want = JW.get_taper(jg, **kw)
    got, w2 = TW.get_taper(tg, device="cpu", **kw)
    assert got.device.type == "cpu" and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert isinstance(w2, float)
    assert abs(w2 - w2_want) <= RTOL_W2 * w2_want


def test_get_taper_weight_and_degrees():
    jg, tg = _geoms(96, 128, 1.0)
    weight = np.random.default_rng(4).uniform(0.5, 1.0, (96, 128)) \
        .astype(np.float32)
    want, w2_want = JW.get_taper(jg, weight=weight)
    got, w2 = TW.get_taper(tg, weight=weight, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert abs(w2 - w2_want) <= RTOL_W2 * w2_want
    for kw in (dict(taper_width_degrees=0.3),
               dict(taper_width_degrees=0.2, pad_width_degrees=0.05),
               dict(taper_width_degrees=0.3, only_y=True)):
        want, w2_want = JW.get_taper_deg(jg, **kw)
        got, w2 = TW.get_taper_deg(tg, device="cpu", **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert abs(w2 - w2_want) <= RTOL_W2 * w2_want


def test_fwhm_sigma():
    for v in (0.5, 1.4, 7.0):
        assert TW.sigma_from_fwhm(v) == JW.sigma_from_fwhm(v)
        assert TW.fwhm_from_sigma(v) == JW.fwhm_from_sigma(v)
        assert abs(TW.fwhm_from_sigma(TW.sigma_from_fwhm(v)) - v) < 1e-12
