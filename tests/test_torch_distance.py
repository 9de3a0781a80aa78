"""Parity of the port's flat-sky ops with the JAX package: the distance
transform and the masks built on it (``ops/distance``), ``noise.
get_masked_ivar``, the DFTs of ``ops/matfft`` and the bisection of
``ops/algorithms``, on the same seeded numpy inputs.

The JAX distance transform is run eagerly (``jax.disable_jit``): the same
code, op by op. Compiled by XLA on the CPU, it returns distances off by up
to several pixels on some inputs (5.2 pixels on the anisotropic case
below, where its eager run and scipy's exact transform agree to 1e-6; see
ROADMAP queue C), so the port is held to the eager run and to the exact
transform.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from scipy.ndimage import distance_transform_edt

from orphics_tpu import geometry as jgeo
from orphics_tpu.geometry import arcmin
from orphics_tpu.ops import algorithms as JA, distance as JD, matfft as JM
from orphics_tpu.models import noise as JN

import orphics_tpu_torch as tp
from orphics_tpu_torch.ops import algorithms as TA, distance as TD
from orphics_tpu_torch.ops import matfft as TM
from orphics_tpu_torch.models import noise as TN

torch.set_num_threads(1)

# Distances: both sides carry float32 seed coordinates through the same
# sweep, so they agree to float32 rounding of the final sqrt: 1e-6 of the
# largest distance. The jump-flooding result is itself within 1e-6 of the
# exact transform on these grids.
RTOL_DIST = 1e-6
# matfft: the JAX DFT by HIGHEST-precision einsums against cuFFT / pocketfft
# in fp32: the module's 1.5e-5 relative contract.
RTOL_FFT = 1.5e-5


def _rel(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


@pytest.fixture(scope="module")
def geoms():
    kw = dict(width_arcmin=40 * 2.0, height_arcmin=37 * 2.0,
              px_res_arcmin=2.0)
    return jgeo.rect_geometry(**kw), tp.rect_geometry(**kw)


@pytest.fixture(scope="module")
def seeds():
    return np.random.default_rng(0).uniform(size=(37, 40)) < 0.02


@pytest.mark.parametrize("wrap", [False, True])
def test_distance_transform_matches_jax(seeds, wrap):
    for dy, dx in ((1.0, 1.0), (1.0, 1.3), (arcmin, arcmin)):
        with jax.disable_jit():
            j = np.asarray(JD.distance_transform(seeds, dy, dx, wrap=wrap))
        t = TD.distance_transform(torch.as_tensor(seeds), dy, dx, wrap=wrap)
        assert t.dtype == torch.float32 and tuple(t.shape) == seeds.shape
        assert _rel(t, j) <= RTOL_DIST, (dy, dx)
        if not wrap:
            ex = distance_transform_edt(~seeds, sampling=(dy, dx))
            assert _rel(t, ex) <= RTOL_DIST, (dy, dx)


def test_masks_match_jax(geoms):
    jg, tg = geoms
    rng = np.random.default_rng(1)
    mask = (rng.uniform(size=jg.shape) > 0.05).astype(np.float32)
    tmask = torch.as_tensor(mask)
    srcs = rng.integers(0, 36, (5, 2))
    with jax.disable_jit():
        grown = np.asarray(JD.grow_mask(mask, jg, 5 * arcmin))
        edge = np.asarray(JD.distance_from_mask_edge(mask, jg.dy, jg.dx))
        apod = np.asarray(JD.cosine_apodize(mask, jg, 0.1))
        holes = np.asarray(JD.mask_srcs(jg, srcs, 6 * arcmin))
    # binary masks: equal (no distance sits within rounding of the width)
    np.testing.assert_array_equal(TD.grow_mask(tmask, tg, 5 * arcmin).numpy(),
                                  grown)
    np.testing.assert_array_equal(
        TD.mask_srcs(tg, torch.as_tensor(srcs), 6 * arcmin).numpy(), holes)
    np.testing.assert_array_equal(
        TD.mask_srcs(tg, srcs, 6 * arcmin, device="cpu").numpy(), holes)
    assert _rel(TD.distance_from_mask_edge(tmask, tg.dy, tg.dx), edge) \
        <= RTOL_DIST
    # the taper: cos of the float32 distance ratio, 1e-6 of its max (1)
    assert _rel(TD.cosine_apodize(tmask, tg, 0.1), apod) <= 1e-6
    # host arrays go to the named device
    assert TD.grow_mask(mask, tg, 5 * arcmin, device="cpu").device.type \
        == "cpu"


def test_get_masked_ivar_matches_jax(geoms):
    jg, tg = geoms
    rng = np.random.default_rng(2)
    iv = rng.uniform(1.0, 2.0, jg.shape).astype(np.float32)
    iv[5:9, 5:9] = 0.0
    iv[30:, 0] = 0.0
    with jax.disable_jit():
        want = np.asarray(JN.get_masked_ivar(jnp.asarray(iv), jg,
                                             grow_arcmin=4.0))
    got = TN.get_masked_ivar(torch.as_tensor(iv), tg, grow_arcmin=4.0)
    assert got.dtype == torch.float32
    # a selection of the input values: equal
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() == 0).sum() > (iv == 0).sum()


def test_good_size_matches_jax():
    for n in list(range(1, 70)) + [97, 127, 128, 384, 2048, 4093]:
        assert TM.good_size(n) == JM.good_size(n), n


@pytest.mark.parametrize("which", ["matfft2", "matifft2", "axis0", "axis1"])
def test_matfft_matches_jax(which):
    rng = np.random.default_rng(3)
    # 48 = 8 * 6 takes the JAX split; 37 falls back to jnp.fft there
    x = (rng.standard_normal((3, 48, 37))
         + 1j * rng.standard_normal((3, 48, 37))).astype(np.complex64)
    xt, xj = torch.as_tensor(x), jnp.asarray(x)
    if which in ("matfft2", "matifft2"):
        got = getattr(TM, which)(xt.real)
        want = getattr(JM, which)(xj.real)
    else:
        axis = -2 if which == "axis0" else -1
        got = TM.matfft_axis(xt, axis=axis, inverse=axis == -1)
        want = JM.matfft_axis(xj, axis=axis, inverse=axis == -1)
    assert got.dtype == torch.complex64 and tuple(got.shape) == x.shape
    assert _rel(got, want) <= RTOL_FFT


@pytest.mark.parametrize("mono", ["increasing", "decreasing"])
def test_bisection_matches_jax(mono):
    xs = np.linspace(1.0, 50.0, 33)
    if mono == "increasing":
        f_j, f_t, bounds = (lambda y: y ** 2 + y), (lambda y: y ** 2 + y), \
            (0.0, 10.0)
    else:
        f_j, f_t, bounds = (lambda y: 100.0 / y), (lambda y: 100.0 / y), \
            (0.5, 200.0)
    want = np.asarray(JA.vectorized_bisection_search(xs, f_j, bounds, mono,
                                                     rtol=1e-9))
    got = TA.vectorized_bisection_search(xs, f_t, bounds, mono, rtol=1e-9,
                                         device="cpu")
    assert got.dtype == torch.float64
    # the same float64 halvings in the same order: equal
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        TA.vectorized_bisection_search(xs, f_t, bounds, "flat", device="cpu")
