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
from orphics_tpu_torch.ops import qe_conv as qconv
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
    tct = tqe.lensing_noise_2d(tg, tth, beam, noise, device="cpu")
    for k in jct:
        np.testing.assert_allclose(tct[k].numpy(), np.asarray(jct[k]),
                                   rtol=1e-6)
    kw = dict(lmin=100, lmax=3000)
    kk = dict(lmin=40, lmax=2500)
    jq = jqe.QE(jg, jth, jct, xmask=JF.mask_kspace(jg, **kw),
                kmask=JF.mask_kspace(jg, **kk), dtype=jnp.float32)
    tq = tqe.QE(tg, tth, tct, xmask=TF.mask_kspace(tg, **kw, device="cpu"),
                kmask=TF.mask_kspace(tg, **kk, device="cpu"), device="cpu")
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


# the generic reconstruction of every estimator against the JAX engine:
# one leg (ky omitted, one source), two distinct legs, TT with a gradient
# cut (the two leg masks differ, so no leg merges), and one data map
# against a batch of sims as rdn0 passes them; with the transforms the
# planned schedule ran (inverse, forward) and the legs it merged
GENERIC_CASES = ([(est, legs) for est in tqe.ESTIMATORS
                  for legs in ("one", "two")]
                 + [("TT", "grad_cut"), ("TT", "broadcast")])
SCHEDULE = {("TT", "one"): (3, 2, 3), ("TT", "two"): (6, 2, 0),
            ("TT", "grad_cut"): (6, 2, 0), ("TT", "broadcast"): (6, 2, 0)}


@pytest.fixture(scope="module")
def engines_grad_cut(engines):
    jg, tg, jq, tq = engines
    jth, tth = jtheory.default_theory(), ttheory.default_theory()
    kw = dict(lmin=100, lmax=3000)
    kk = dict(lmin=40, lmax=2500)
    jct = {k: jnp.asarray(v.numpy()) for k, v in tq.ctot.items()}
    jgc = jqe.QE(jg, jth, jct, xmask=JF.mask_kspace(jg, **kw),
                 kmask=JF.mask_kspace(jg, **kk), dtype=jnp.float32,
                 grad_cut=2000.0)
    tgc = tqe.QE(tg, tth, tq.ctot, xmask=TF.mask_kspace(tg, **kw,
                                                        device="cpu"),
                 kmask=TF.mask_kspace(tg, **kk, device="cpu"), device="cpu",
                 grad_cut=2000.0)
    return jgc, tgc


@pytest.mark.parametrize("est,legs", GENERIC_CASES,
                         ids=[f"{e}-{g}" for e, g in GENERIC_CASES])
def test_kappa_from_map_estimators(engines, engines_grad_cut, est, legs):
    jg, tg, jq, tq = engines
    if legs == "grad_cut":
        jq, tq = engines_grad_cut
    kx = np.fft.fft2(_observed(jg, 21, batch=(2,))).astype(np.complex64)
    ky = np.fft.fft2(_observed(jg, 22, batch=(2,))).astype(np.complex64)
    if legs == "broadcast":
        kx = kx[:1]
        ky = np.fft.fft2(_observed(jg, 23, batch=(3,))).astype(np.complex64)
    before = (tq.transforms_inverse, tq.transforms_forward, tq.legs_merged)
    if legs in ("one", "grad_cut"):
        k_t = tq.kappa_from_map(est, torch.as_tensor(kx)).numpy()
        k_j = np.asarray(jq.kappa_from_map(est, jnp.asarray(kx)))
    else:
        k_t = tq.kappa_from_map(est, torch.as_tensor(kx),
                                torch.as_tensor(ky)).numpy()
        jx = np.broadcast_to(kx, ky.shape) if legs == "broadcast" else kx
        k_j = np.asarray(jq.kappa_from_map(est, jnp.asarray(jx),
                                           jnp.asarray(ky)))
    assert k_t.shape == k_j.shape == ky.shape and k_t.dtype == np.complex64
    mask = np.broadcast_to(np.asarray(jq.kmask), k_j.shape)
    assert _rel_in_mask(k_t, k_j, mask) <= RTOL_QE
    ran = tuple(a - b for a, b in zip(
        (tq.transforms_inverse, tq.transforms_forward, tq.legs_merged),
        before))
    assert ran[1] == 2
    if (est, legs) in SCHEDULE:
        assert ran == SCHEDULE[(est, legs)]
    # never more inverses than the unfused loop's two a product
    assert 0 < ran[0] <= 4 * len(tq._filter_terms(est)) * 2


# ---- the three kernels' plain versions against the unfused algebra -------

# float64 on both sides: the same sums in another order
RTOL_F64 = 1e-12


@pytest.fixture(scope="module")
def engine64():
    g = tp.rect_geometry(width_arcmin=32 * 3.0, px_res_arcmin=3.0)
    th = ttheory.default_theory()
    ct = tqe.lensing_noise_2d(g, th, 1.5, 6.0, dtype=torch.float64,
                              device="cpu")
    q = tqe.QE(g, th, ct, xmask=TF.mask_kspace(g, lmin=100, lmax=3000,
                                               device="cpu"),
               kmask=TF.mask_kspace(g, lmin=40, lmax=2500, device="cpu"),
               dtype=torch.float64, device="cpu")
    gen = torch.Generator().manual_seed(5)
    rand = lambda *shape: torch.complex(
        torch.randn(shape, generator=gen, dtype=torch.float64),
        torch.randn(shape, generator=gen, dtype=torch.float64))
    return q, rand


def _unfused_kappa(q, est, kx, ky):
    """The reconstruction as the engine ran it before its planned schedule:
    every filter term, angle pair and component through its own two scaled
    inverse transforms, product and forward transform."""
    X, Y = kx * q._phys, ky * q._phys
    Li = (q.ly, q.lx)
    out = 0.0
    for (d, a, w1, w2) in q._filter_terms(est):
        for (u1, u2, c) in q._angle_pairs(a):
            c = -c if a == "s" else c
            A1, A2 = u1 * w1 * X, u2 * w2 * Y
            for i in range(2):
                B1 = A1 * Li[i] if d == 1 else A1
                B2 = A2 * Li[i] if d == 2 else A2
                out = out + (c * Li[i]) * torch.fft.fft2(
                    torch.fft.ifft2(B1) * torch.fft.ifft2(B2)) * q._conv_fac
    phi = q.A_L(est) * out * q.kmask * float(q.geom.area) ** 0.5
    return 0.5 * q.modlmap ** 2 * phi / q._phys


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


@pytest.mark.parametrize("what", ["leg", "pair", "post", "schedule"])
def test_plain_kernels_match_unfused_algebra(engine64, what):
    q, rand = engine64
    n = q.geom.npix
    kx = rand(2, *q.geom.shape)
    (d, a, w1, w2) = q._filter_terms("TT")[0]
    u1 = q._angle_pairs(a)[0][0]
    if what == "leg":
        # X phys, u w X, B L_i and the inverse's 1/N: one plane, unscaled
        planes = torch.stack([u1 * w1 * Li * q._phys / n
                              for Li in (q.ly, q.lx, q._one())])
        got = [torch.fft.ifft2(g, norm="forward")
               for g in qconv.qe_leg_ref(kx, planes)]
        assert [tuple(g.shape) for g in got] == [tuple(kx.shape)] * 3
        for g, Li in zip(got, (q.ly, q.lx, q._one())):
            ref = torch.fft.ifft2(((kx * q._phys) * (u1 * w1)) * Li)
            assert _rel(g, ref) <= RTOL_F64
        assert all(torch.equal(g, r) for g, r in zip(
            qconv.qe_leg(kx, planes), qconv.qe_leg_ref(kx, planes)))
    elif what == "pair":
        # sum over products before one forward transform per component,
        # a leg of batch 1 against legs of batch 2, on top of earlier sums
        A = [rand(1, *q.geom.shape)] + [rand(2, *q.geom.shape)
                                        for _ in range(2)]
        legs = tuple(torch.fft.ifft2(x) for x in A)
        pairs = ((0, 2.0, 1, 0), (1, 2.0, 2, 0), (0, -0.5, 1, 1),
                 (1, 0.25, 0, 0))
        prev = (rand(2, *q.geom.shape), rand(2, *q.geom.shape))
        S = qconv.qe_pair_ref(legs, pairs, prev)
        for i in range(2):
            ref = torch.fft.fft2(prev[i]) + sum(
                c * torch.fft.fft2(torch.fft.ifft2(A[p]) * torch.fft.ifft2(
                    A[r])) for j, c, p, r in pairs if j == i)
            assert _rel(torch.fft.fft2(S[i]), ref) <= RTOL_F64
        assert all(torch.equal(g, r) for g, r in zip(
            qconv.qe_pair(legs, pairs, prev), S))
    elif what == "post":
        # L_i, npix/area, A_L, kmask, sqrt(area), L^2/2 and 1/phys
        F = (rand(2, *q.geom.shape), rand(2, *q.geom.shape))
        got = qconv.qe_post_ref(*F, q._post_planes("TT", "kappa",
                                                   torch.float64))
        uphi = (q.ly * F[0] + q.lx * F[1]) * q._conv_fac
        phi = q.A_L("TT") * uphi * q.kmask * float(q.geom.area) ** 0.5
        assert _rel(got, 0.5 * q.modlmap ** 2 * phi / q._phys) <= RTOL_F64
    else:
        # the whole planned schedule, every estimator, one and two legs
        ky = rand(2, *q.geom.shape)
        for est in tqe.ESTIMATORS:
            assert _rel(q.kappa_from_map(est, kx),
                        _unfused_kappa(q, est, kx, kx)) <= 1e-10
            assert _rel(q.kappa_from_map(est, kx, ky),
                        _unfused_kappa(q, est, kx, ky)) <= 1e-10


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


# ---- the full-plane doubly-permuted TT path (kappa_tt_pallas) ----------

# 2e-4 of max: the bound tests/test_qe_pallas.py holds the JAX Pallas path
# to against the full-plane XLA reconstruction.
TOL_PP = 2e-4


@pytest.fixture(scope="module")
def engines256():
    """The setup of tests/test_qe_pallas.py (256^2, 2', 1.4', 6 uK'), both
    packages, plus two observed maps and their pp-permuted spectra."""
    from orphics_tpu.ops import pallas_fft as pf
    n = 256
    jg = jgeo.rect_geometry(width_arcmin=n * 2.0, px_res_arcmin=2.0)
    tg = tp.rect_geometry(width_arcmin=n * 2.0, px_res_arcmin=2.0)
    jth, tth = jtheory.default_theory(), ttheory.default_theory()
    jct = jqe.lensing_noise_2d(jg, jth, 1.4, 6.0, dtype=jnp.float32)
    tct = tqe.lensing_noise_2d(tg, tth, 1.4, 6.0, device="cpu")
    lmax_grid = jg.ellmax_safe()
    kw = dict(lmin=100, lmax=min(3000, lmax_grid - 1))
    kk = dict(lmin=40, lmax=min(3000, lmax_grid * 0.8))
    jq = jqe.QE(jg, jth, jct, xmask=JF.mask_kspace(jg, **kw),
                kmask=JF.mask_kspace(jg, **kk), dtype=jnp.float32)
    tq = tqe.QE(tg, tth, tct, xmask=TF.mask_kspace(tg, **kw, device="cpu"),
                kmask=TF.mask_kspace(tg, **kk, device="cpu"), device="cpu")
    maps = np.random.default_rng(0).standard_normal((2, n, n)).astype(
        np.float32)
    perm, inv = pf.row_perm(n)
    Z = np.fft.fft2(maps)
    zr = Z.real[:, perm][:, :, perm].astype(np.float32)
    zi = Z.imag[:, perm][:, :, perm].astype(np.float32)
    jr, ji = jq.kappa_tt_pallas(jnp.asarray(zr), jnp.asarray(zi),
                                interpret=True)
    return dict(jq=jq, tq=tq, maps=maps, zr=zr, zi=zi, inv=inv,
                ref=np.asarray(jr) + 1j * np.asarray(ji))


def test_tt_pp_plans_match_jax(engines256):
    jq, tq = engines256["jq"], engines256["tq"]
    names = ("wA", "wX", "Ly", "Lx", "post")
    for name, a, b in zip(names, tq._tt_pp_plans(), jq._tt_pp_plans()):
        b = np.asarray(b)
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        # post carries A_L, whose fp32 convolution sums round differently
        # on the two sides (1.3e-4 of max at the high-L edge at 256^2):
        # held to the bound of the kappa it scales; the rest are the same
        # fp32 products
        tol = TOL_PP if name == "post" else 1e-6
        assert np.abs(a.numpy() - b).max() <= tol * np.abs(b).max(), name


def test_kappa_tt_pallas_matches_jax(engines256):
    e = engines256
    tr, ti = e["tq"].kappa_tt_pallas(torch.as_tensor(e["zr"]),
                                     torch.as_tensor(e["zi"]))
    got = tr.numpy() + 1j * ti.numpy()
    ref = e["ref"]
    assert got.shape == ref.shape == (2, 256, 256)
    assert np.abs(got - ref).max() <= TOL_PP * np.abs(ref).max()
    # and the port's own generic reconstruction, in natural order
    inv = e["inv"]
    full = np.stack([e["tq"].kappa_from_map(
        "TT", torch.fft.fft2(torch.as_tensor(m))).numpy()
        for m in e["maps"]])
    nat = got[:, inv][:, :, inv]
    assert np.abs(nat - full).max() <= TOL_PP * np.abs(full).max()


def test_kappa_tt_pallas_rejects(engines, engines256):
    tq = engines256["tq"]
    z = torch.zeros((3, 256, 256))
    with pytest.raises(ValueError, match="even"):
        tq.kappa_tt_pallas(z, z)
    # a 64^2 grid has no full-plane path
    with pytest.raises(ValueError, match="square 128"):
        engines[3]._tt_pp_plans()
