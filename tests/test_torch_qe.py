"""Parity of the port's quadratic estimator with the JAX package: the
normalization ``A_L``, the Gaussian noise ``N_L_kk``, the generic
``kappa_from_map`` and the fused half-plane ``kappa_tt_rfft``, on the
same theory, masks and observed maps."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from orphics_tpu import geometry as jgeo
from orphics_tpu.ops import fourier as JF
from orphics_tpu.models import qe as jqe, theory as jtheory

import orphics_tpu_torch as tp
from orphics_tpu_torch.ops import fourier as TF
from orphics_tpu_torch.models import qe as tqe, theory as ttheory

torch.set_num_threads(1)

# The normalization and reconstruction are sums of fp32 FFT convolutions
# on both sides, computed by different FFT libraries: 1e-4 relative inside
# kmask (the budget of BASELINE.md for kappa).
RTOL_QE = 1e-4


@pytest.fixture(scope="module")
def engines():
    jg = jgeo.rect_geometry(width_arcmin=64 * 3.0, px_res_arcmin=3.0)
    tg = tp.rect_geometry(width_arcmin=64 * 3.0, px_res_arcmin=3.0)
    jth, tth = jtheory.default_theory(), ttheory.default_theory()
    beam, noise = 1.5, 6.0
    jct = jqe.lensing_noise_2d(jg, jth, beam, noise, dtype=jnp.float32)
    tct = tqe.lensing_noise_2d(tg, tth, beam, noise)
    for k in jct:
        np.testing.assert_allclose(tct[k].numpy(), np.asarray(jct[k]),
                                   rtol=1e-6)
    kw = dict(lmin=100, lmax=3000)
    kk = dict(lmin=40, lmax=2500)
    jq = jqe.QE(jg, jth, jct, xmask=JF.mask_kspace(jg, **kw),
                kmask=JF.mask_kspace(jg, **kk), dtype=jnp.float32)
    tq = tqe.QE(tg, tth, tct, xmask=TF.mask_kspace(tg, **kw),
                kmask=TF.mask_kspace(tg, **kk))
    return jg, tg, jq, tq


def _rel_in_mask(a, b, mask):
    a, b = np.asarray(a), np.asarray(b)
    m = np.asarray(mask) > 0
    return np.max(np.abs(a - b)[m]) / np.max(np.abs(b)[m])


@pytest.mark.parametrize("est", ["TT", "EB"])
def test_normalization_and_noise(engines, est):
    jg, tg, jq, tq = engines
    al_t = tq.A_L(est)
    al_j = np.asarray(jq.A_L(est))
    assert al_t.dtype == torch.float32 and tuple(al_t.shape) == jg.shape
    assert _rel_in_mask(al_t.numpy(), al_j, jq.kmask) <= RTOL_QE
    n0_t = tq.N_L_kk(est).numpy()
    n0_j = np.asarray(jq.N_L_kk(est))
    kmask = np.asarray(jq.kmask) > 0
    # The JAX N0 forms A_L * A_L first; at high L that product falls below
    # the fp32 normal range and XLA flushes it to zero, so compare where
    # it stays normal (the port multiplies in an order that cannot
    # underflow; see ROADMAP queue C).
    normal = kmask & (al_j.astype(np.float64) ** 2
                      >= np.finfo(np.float32).tiny)
    assert normal.sum() > 100
    assert _rel_in_mask(n0_t, n0_j, normal) <= RTOL_QE
    # Everywhere in kmask the port holds the minimum-variance identity
    # N_kk = (L^4 / 4) A_L of exact filters (TT, and EB without TB/EB
    # total cross-spectra).
    L = tg.modlmap_np()
    mv = L ** 4 / 4.0 * al_t.numpy().astype(np.float64)
    assert _rel_in_mask(n0_t, mv, kmask) <= RTOL_QE
    assert np.all(n0_t[~kmask] == 0)


def _observed(jg, seed, batch=()):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal(tuple(batch) + jg.shape).astype(np.float32)
    # redden the white map so the legs carry CMB-like low-l power
    filt = 1.0 / (1.0 + np.asarray(jg.modlmap_np()) / 300.0) ** 2
    return np.real(np.fft.ifft2(np.fft.fft2(m) * filt)).astype(np.float32)


def test_kappa_from_map(engines):
    jg, tg, jq, tq = engines
    m = _observed(jg, 7)
    kx = np.fft.fft2(m).astype(np.complex64)
    k_t = tq.kappa_from_map("TT", torch.as_tensor(kx)).numpy()
    k_j = np.asarray(jq.kappa_from_map("TT", jnp.asarray(kx)))
    assert _rel_in_mask(k_t, k_j, jq.kmask) <= RTOL_QE
    # the real-map form
    r_t = tq.kappa_from_map("TT", torch.as_tensor(kx), return_ft=False)
    r_j = jq.kappa_from_map("TT", jnp.asarray(kx), return_ft=False)
    assert np.abs(r_t.numpy() - np.asarray(r_j)).max() \
        <= RTOL_QE * np.abs(np.asarray(r_j)).max()


def test_kappa_tt_rfft(engines):
    jg, tg, jq, tq = engines
    m = _observed(jg, 8, batch=(2,))
    xh = np.fft.rfft2(m).astype(np.complex64)
    nxr = jg.nx // 2 + 1
    k_t = tq.kappa_tt_rfft(torch.as_tensor(xh)).numpy()
    k_j = np.asarray(jq.kappa_tt_rfft(jnp.asarray(xh)))
    assert k_t.shape == k_j.shape == (2, jg.ny, nxr)
    mask = np.broadcast_to(np.asarray(jq.kmask)[:, :nxr], k_j.shape)
    assert _rel_in_mask(k_t, k_j, mask) <= RTOL_QE
    # the fused half-plane path equals the generic one (masks below Nyquist)
    full = tq.kappa_from_map("TT", torch.fft.fft2(torch.as_tensor(m))).numpy()
    assert _rel_in_mask(k_t, full[..., :nxr], mask) <= RTOL_QE
    # two legs
    y = np.fft.rfft2(_observed(jg, 9, batch=(2,))).astype(np.complex64)
    c_t = tq.kappa_tt_rfft(torch.as_tensor(xh), torch.as_tensor(y)).numpy()
    c_j = np.asarray(jq.kappa_tt_rfft(jnp.asarray(xh), jnp.asarray(y)))
    assert _rel_in_mask(c_t, c_j, mask) <= RTOL_QE
    # the cached half-plane plans themselves
    for a, b in zip(tq._tt_half_plans()[:6], jq._tt_half_plans()[:6]):
        if b is None:
            assert a is None
            continue
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= RTOL_QE * np.abs(b).max()
