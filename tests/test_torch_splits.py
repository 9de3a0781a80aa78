"""Parity of the port's ``models/splits`` and ``models/splitlens`` with the
JAX package on the same split maps: the split power estimates, the noise
and TEB cross power from splits, the cross-split spectra (flat and from
alms), the Knox errors, and the cross-only split-lensing estimator on the
port's ``QE``.

Tolerances: the split algebra is float64 on both sides, 1e-12 relative,
except the TEB cross power, whose Q/U -> E/B rotation the JAX package
forms in float32 (the port from the float64 k-maps): 1e-6; the
split-lensing power runs float32 QE fragments on both sides (different
FFT libraries), the QE's 1e-4 budget.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from orphics_tpu import geometry as jgeo
from orphics_tpu.ops import fourier as JF
from orphics_tpu.models import qe as jqe, splitlens as JSL, splits as JSp
from orphics_tpu.models import theory as jtheory

import orphics_tpu_torch as tp
from orphics_tpu_torch.ops import fourier as TF
from orphics_tpu_torch.ops.binning import Bin2D
from orphics_tpu_torch.models import qe as tqe, splitlens as TSL
from orphics_tpu_torch.models import splits as TSp, theory as ttheory

torch.set_num_threads(1)

RTOL_F64 = 1e-12


def _rel(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


@pytest.fixture(scope="module")
def geoms():
    kw = dict(width_arcmin=16 * 2.0, px_res_arcmin=2.0)
    return jgeo.rect_geometry(**kw), tp.rect_geometry(**kw)


def _ksplits(n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, 16, 16)) + 1j * rng.standard_normal(
        (n, 16, 16))


@pytest.mark.parametrize("alt", [True, False])
def test_split_calc(geoms, alt):
    jg, tg = geoms
    ki, kj = _ksplits(4, 0), _ksplits(4, 1)
    ci, cj = ki.mean(0), kj.mean(0)
    want = JSp.split_calc(jnp.asarray(ki), jnp.asarray(kj), jnp.asarray(ci),
                          jnp.asarray(cj), jg, alt=alt)
    got = TSp.split_calc(torch.as_tensor(ki), torch.as_tensor(kj),
                         torch.as_tensor(ci), torch.as_tensor(cj), tg,
                         alt=alt)
    for a, b in zip(got, want):
        assert _rel(a, b) <= RTOL_F64


@pytest.mark.parametrize("ncomp", [1, 3])
def test_noise_from_splits(geoms, ncomp):
    jg, tg = geoms
    sp = np.random.default_rng(2).standard_normal((3, ncomp, 16, 16))
    nj, xj = JSp.noise_from_splits(sp, jg)
    nt, xt = TSp.noise_from_splits(torch.as_tensor(sp), tg)
    assert _rel(nt, nj) <= RTOL_F64
    assert _rel(xt, xj) <= (1e-6 if ncomp == 3 else RTOL_F64)
    nt2, none = TSp.noise_from_splits(sp[:, 0], tg, do_cross=False,
                                      device="cpu")
    assert none is None and _rel(nt2, JSp.noise_from_splits(
        sp[:, 0], jg, do_cross=False)[0]) <= RTOL_F64


def test_cross_split_spectra(geoms):
    jg, tg = geoms
    k1, k2 = _ksplits(3, 3), _ksplits(3, 4)
    assert _rel(TSp.cross_split_spectrum(torch.as_tensor(k1), geom=tg),
                JSp.cross_split_spectrum(k1, geom=jg)) <= RTOL_F64
    assert _rel(TSp.cross_split_spectrum(k1, k2, geom=tg, device="cpu"),
                JSp.cross_split_spectrum(k1, k2, geom=jg)) <= RTOL_F64
    # binned through the port's Bin2D (float32)
    edges = np.arange(200.0, 8000.0, 800.0)
    spec = TSp.cross_split_spectrum(torch.as_tensor(k1), geom=tg)
    cents, bp = TSp.cross_split_spectrum(
        torch.as_tensor(k1), geom=tg,
        binner=Bin2D(tg.modlmap_np(), edges, device="cpu"))
    assert _rel(bp, Bin2D(tg.modlmap_np(), edges, device="cpu").bin(
        spec.to(torch.float32))[1]) == 0
    with pytest.raises(ValueError):
        TSp.cross_split_spectrum(torch.as_tensor(k1[:1]), geom=tg)
    rng = np.random.default_rng(5)
    nalm = 11 * 12 // 2                                    # lmax 10
    a1 = rng.standard_normal((3, nalm)) + 1j * rng.standard_normal((3, nalm))
    a2 = rng.standard_normal((3, nalm)) + 1j * rng.standard_normal((3, nalm))
    assert _rel(TSp.cross_split_spectrum_alms(torch.as_tensor(a1),
                                              torch.as_tensor(a2)),
                JSp.cross_split_spectrum_alms(a1, a2)) <= RTOL_F64


def test_knox_errors():
    rng = np.random.default_rng(6)
    mask = rng.uniform(0.0, 1.0, (20, 20))
    assert TSp.error_fsky(torch.as_tensor(mask)) == pytest.approx(
        JSp.error_fsky(mask), rel=RTOL_F64)
    assert TSp.error_fsky(mask) == pytest.approx(JSp.error_fsky(mask),
                                                 rel=RTOL_F64)
    ells = np.arange(3000.0)
    cltt = 1e3 / (1.0 + ells) ** 2
    beam = np.exp(-(ells / 3000.0) ** 2)
    edges = np.arange(100, 2900, 200)
    for kw in (dict(mask=mask), dict(f_sky_eff=0.3)):
        a = TSp.crossband_errors(cltt, edges, 10.0, 15.0, beam, beam,
                                 n_splits=4, **kw)
        b = JSp.crossband_errors(cltt, edges, 10.0, 15.0, beam, beam,
                                 n_splits=4, **kw)
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, rtol=RTOL_F64)


def test_split_lensing_matches_jax():
    """The four-split cross-only kappa power on the port's QE against the
    JAX estimator on the JAX QE, at 64^2 and 3' (the engines of
    tests/test_torch_qe.py)."""
    jg = jgeo.rect_geometry(width_arcmin=64 * 3.0, px_res_arcmin=3.0)
    tg = tp.rect_geometry(width_arcmin=64 * 3.0, px_res_arcmin=3.0)
    jth, tth = jtheory.default_theory(), ttheory.default_theory()
    jct = jqe.lensing_noise_2d(jg, jth, 1.5, 6.0, dtype=jnp.float32)
    tct = tqe.lensing_noise_2d(tg, tth, 1.5, 6.0, device="cpu")
    kw, kk = dict(lmin=100, lmax=3000), dict(lmin=40, lmax=2500)
    jq = jqe.QE(jg, jth, jct, xmask=JF.mask_kspace(jg, **kw),
                kmask=JF.mask_kspace(jg, **kk), dtype=jnp.float32)
    tq = tqe.QE(tg, tth, tct, xmask=TF.mask_kspace(tg, **kw, device="cpu"),
                kmask=TF.mask_kspace(tg, **kk, device="cpu"), device="cpu")
    rng = np.random.default_rng(7)
    filt = 1.0 / (1.0 + jg.modlmap_np() / 300.0) ** 2
    maps = rng.standard_normal((4,) + jg.shape)
    ks = (np.fft.fft2(maps) * filt).astype(np.complex64)
    want = np.asarray(JSL.SplitLensing(jg, jq).cross_estimator(ks))
    got = TSL.SplitLensing(tg, tq).cross_estimator(torch.as_tensor(ks))
    kmask = np.asarray(jq.kmask) > 0
    err = np.abs(got.numpy() - want)[kmask].max()
    assert err <= 1e-4 * np.abs(want[kmask]).max()
