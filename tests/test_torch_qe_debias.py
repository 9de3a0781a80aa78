"""Parity of the port's N0 / N1 debias tools (``NlGenerator``, ``rdn0``,
``mcn0``, ``n1_tt`` of ``orphics_tpu_torch.models.qe``) with the JAX
package, on the CPU at small sizes.

Both sides run in float64 (XLA flushes the fp32 ``A_L**2`` to zero at high
L, so an fp32 N0 is comparable only at low L; one fp32 case checks that).
Bounds: binned N0 curves 1e-4 relative (the same FFT algebra, binned by
fp64-accumulated sums on the port's side); RDN0 / MCN0 on the same sim
k-maps 1e-4 of the curve's max; ``n1_tt`` 1e-6 relative to the JAX value
and 1e-10 to the direct 4D lattice sum, whose radial tables the test
makes itself in numpy (the two sums differ in their order over 576^2
terms, which leaves about 1e-12).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from orphics_tpu import geometry as jgeo
from orphics_tpu.models import qe as jqe, theory as jtheory
from orphics_tpu.ops import fourier as JF

import orphics_tpu_torch as tp
from orphics_tpu_torch.models import qe as tqe, theory as ttheory
from orphics_tpu_torch.ops import fourier as TF

torch.set_num_threads(1)

RTOL_NL = 1e-4
TOL_RDN0 = 1e-4
RTOL_N1 = 1e-6
RTOL_LATTICE = 1e-10


@pytest.fixture(scope="module")
def theories():
    return jtheory.default_theory(), ttheory.default_theory()


# ---- NlGenerator -------------------------------------------------------

_EDGES = np.arange(100, 2100, 200.0)
_NOISE = dict(beam_arcmin=1.5, noise_t_uk_arcmin=6.0, tellmin=100,
              tellmax=3000, pellmin=100, pellmax=3000, kmin=40, kmax=2500)


@pytest.fixture(scope="module")
def nlgens(theories):
    jth, tth = theories
    kw = dict(width_arcmin=64 * 3.0, px_res_arcmin=3.0)
    jn = jqe.NlGenerator(jgeo.rect_geometry(**kw), jth, _EDGES,
                         dtype=jnp.float64).update_noise(**_NOISE)
    tn = tqe.NlGenerator(tp.rect_geometry(**kw), tth, _EDGES,
                         dtype=torch.float64, device="cpu") \
        .update_noise(**_NOISE)
    return jn, tn


def test_nlgenerator_needs_update_noise(theories):
    g = tp.rect_geometry(width_arcmin=64 * 3.0, px_res_arcmin=3.0)
    with pytest.raises(RuntimeError, match="update_noise"):
        tqe.NlGenerator(g, theories[1], _EDGES, device="cpu").get_nl("TT")


@pytest.mark.parametrize("est", ["TT", "TE", "EE", "EB", "TB"])
def test_get_nl_matches_jax(nlgens, est):
    jn, tn = nlgens
    cj, nj = jn.get_nl(est)
    ct, nt = tn.get_nl(est)
    np.testing.assert_array_equal(ct, np.asarray(cj))
    assert np.all(nj > 0) and nt.shape == nj.shape
    np.testing.assert_allclose(nt, nj, rtol=RTOL_NL)
    assert tn.getNl == tn.get_nl and tn.updateNoise == tn.update_noise


@pytest.mark.parametrize("pair", [("TT", "TE"), ("TT", "EE"), ("EE", "EB")])
def test_get_nl_cross_matches_jax(nlgens, pair):
    jn, tn = nlgens
    _, nj = jn.get_nl_cross(*pair)
    _, nt = tn.get_nl_cross(*pair)
    scale = np.sqrt(jn.get_nl(pair[0])[1] * jn.get_nl(pair[1])[1])
    # a cross N0 may vanish (EE x EB): read it against the two autos
    assert np.abs(nt - nj).max() <= RTOL_NL * scale.max()
    assert np.all(np.abs(nt - nj) <= RTOL_NL * scale)


@pytest.mark.parametrize("naive", [False, True])
def test_get_nl_mv_matches_jax(nlgens, naive):
    jn, tn = nlgens
    cj, nj = jn.get_nl_mv(naive=naive)
    ct, nt = tn.get_nl_mv(naive=naive)
    np.testing.assert_array_equal(ct, np.asarray(cj))
    np.testing.assert_allclose(nt, nj, rtol=RTOL_NL)
    # the minimum-variance curve lies below every single estimator's
    assert np.all(nt <= tn.get_nl("TT")[1] * (1 + 1e-6))


def test_get_nl_fp32_matches_fp64_at_low_L(nlgens, theories):
    """The fp32 engine (the card's default) against the fp64 one where the
    fp32 product is well inside the normal range."""
    _, tn = nlgens
    t32 = tqe.NlGenerator(tn.geom, theories[1], _EDGES, device="cpu") \
        .update_noise(**_NOISE)
    n32, n64 = t32.get_nl("TT")[1], tn.get_nl("TT")[1]
    assert n32.dtype == np.float32
    np.testing.assert_allclose(n32[:5], n64[:5], rtol=1e-4)


# ---- rdn0 / mcn0 -------------------------------------------------------

@pytest.fixture(scope="module")
def rd_case(theories):
    """One JAX rdn0 call (its sim loop is one jitted map) on 6 sim k-maps
    and a data k-map at 64^2, made from a numpy seed."""
    jth, tth = theories
    kw = dict(width_arcmin=64 * 3.0, px_res_arcmin=3.0)
    jg, tg = jgeo.rect_geometry(**kw), tp.rect_geometry(**kw)
    beam, noise = 1.5, 5.0
    jq = jqe.QE(jg, jth, jqe.lensing_noise_2d(jg, jth, beam, noise),
                xmask=JF.mask_kspace(jg, lmin=100, lmax=3000),
                kmask=JF.mask_kspace(jg, lmin=40, lmax=1500),
                dtype=jnp.float64)
    tq = tqe.QE(tg, tth,
                tqe.lensing_noise_2d(tg, tth, beam, noise, device="cpu"),
                xmask=TF.mask_kspace(tg, lmin=100, lmax=3000, device="cpu"),
                kmask=TF.mask_kspace(tg, lmin=40, lmax=1500, device="cpu"),
                dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(64)
    amp = np.sqrt(np.asarray(jq.ctot["TT"]) * tg.npix ** 2 / tg.area)
    kmaps = np.fft.fft2(np.fft.ifft2(
        amp * (rng.standard_normal((7,) + tg.shape)
               + 1j * rng.standard_normal((7,) + tg.shape))).real)
    edges = np.arange(80, 1400, 120.0)
    ref = jqe.rdn0(jq, "TT", jnp.asarray(kmaps[0]), jnp.asarray(kmaps[1:]),
                   edges)
    return tq, kmaps, edges, [np.asarray(r) for r in ref]


@pytest.mark.parametrize("chunk", [16, 4])
def test_rdn0_matches_jax(rd_case, chunk):
    tq, kmaps, edges, (cj, rdj, mcj) = rd_case
    ct, rd, mc = tqe.rdn0(tq, "TT", torch.as_tensor(kmaps[0]),
                          torch.as_tensor(kmaps[1:]), edges, chunk=chunk)
    np.testing.assert_array_equal(ct, cj)
    assert np.abs(mcj).max() > 0
    assert np.abs(rd - rdj).max() <= TOL_RDN0 * np.abs(rdj).max()
    assert np.abs(mc - mcj).max() <= TOL_RDN0 * np.abs(mcj).max()


@pytest.mark.parametrize("shift", [1, 2])
def test_mcn0_matches_rdn0_sim_terms(rd_case, shift):
    """mcn0 is rdn0's sim-pair terms alone; the pairing follows
    ``pair_shift`` (shift 1 is the JAX call's)."""
    tq, kmaps, edges, (_, _, mcj) = rd_case
    sims = torch.as_tensor(kmaps[1:])
    _, mc = tqe.mcn0(tq, "TT", sims, edges, pair_shift=shift, chunk=4)
    _, _, mc_rd = tqe.rdn0(tq, "TT", torch.as_tensor(kmaps[0]), sims, edges,
                           pair_shift=shift)
    np.testing.assert_allclose(mc, mc_rd, rtol=1e-6)
    if shift == 1:
        assert np.abs(mc - mcj).max() <= TOL_RDN0 * np.abs(mcj).max()


def test_rdn0_tracks_data_power_and_needs_two_sims(rd_case):
    """Scaling the data by alpha scales the data-anchored terms by alpha^2
    (tests/test_qe_mv.py's identity)."""
    tq, kmaps, edges, _ = rd_case
    d, sims = torch.as_tensor(kmaps[0]), torch.as_tensor(kmaps[1:5])
    _, rd1, mc1 = tqe.rdn0(tq, "TT", d, sims, edges)
    _, rd2, mc2 = tqe.rdn0(tq, "TT", 1.5 * d, sims, edges)
    np.testing.assert_allclose(mc1, mc2, rtol=1e-6)
    sel = mc1 > 0
    np.testing.assert_allclose((rd2 + mc2)[sel], 2.25 * (rd1 + mc1)[sel],
                               rtol=1e-5)
    with pytest.raises(ValueError, match="2 sims"):
        tqe.rdn0(tq, "TT", d, sims[:1], edges)
    with pytest.raises(ValueError, match="2 sims"):
        tqe.mcn0(tq, "TT", sims[:1], edges)


# ---- n1_tt -------------------------------------------------------------

def _n1_engines(theories, lmax_frac=None):
    jth, tth = theories
    kw = dict(width_arcmin=24 * 8.0, px_res_arcmin=8.0)
    jg, tg = jgeo.rect_geometry(**kw), tp.rect_geometry(**kw)
    lmax = 1200 if lmax_frac is None else \
        lmax_frac * np.pi / np.radians(8.0 / 60.0)
    jq = jqe.QE(jg, jth, jqe.lensing_noise_2d(jg, jth, 5.0, 15.0),
                xmask=JF.mask_kspace(jg, lmin=100, lmax=lmax),
                dtype=jnp.float64)
    tq = tqe.QE(tg, tth,
                tqe.lensing_noise_2d(tg, tth, 5.0, 15.0, device="cpu"),
                xmask=TF.mask_kspace(tg, lmin=100, lmax=lmax, device="cpu"),
                dtype=torch.float64, device="cpu")
    return jq, tq


_DL = 2 * np.pi / np.radians(24 * 8.0 / 60.0)
_LS = np.array([2 * _DL, 5 * _DL, 9 * _DL, 300.0])


@pytest.fixture(scope="module")
def n1_case(theories):
    jq, tq = _n1_engines(theories)
    ells = np.arange(theories[1].lpad + 1)
    clkk = np.asarray(theories[1].gCl("kk", ells))
    _, want = jqe.n1_tt(jq, _LS, clkk, ells=ells, pad=2)
    return tq, ells, clkk, np.asarray(want)


def test_n1_tt_matches_jax(n1_case):
    tq, ells, clkk, want = n1_case
    Ls, got = tqe.n1_tt(tq, _LS, clkk, ells=ells, pad=2)
    np.testing.assert_array_equal(Ls, _LS)
    assert np.all(want != 0)
    np.testing.assert_allclose(got, want, rtol=RTOL_N1)
    # linear in the lensing spectrum; ells defaults to arange(len(clkk))
    _, tripled = tqe.n1_tt(tq, _LS[-1:], 3.0 * clkk)
    np.testing.assert_allclose(tripled, 3.0 * got[-1:], rtol=1e-9)


def _radial(geom, grid2d):
    """(l, value) samples of an isotropic Fourier grid along its ly = 0
    row, sorted by l, one per distinct l: plain numpy, independent of the
    port's own radialization."""
    lx = 2 * np.pi * np.fft.fftfreq(geom.nx, d=geom.dx)
    row = np.asarray(grid2d)[0]
    lu = np.unique(np.abs(lx))
    return lu, np.array([row[np.flatnonzero(np.abs(lx) == l)[0]] for l in lu])


def _brute_n1_phi(qe, Lx, ells, clkk):
    """Direct 4D lattice sum: N1^pp(L)/A^2 = 2/area^2 * sum_{l1,l3}
    F(l1,l2) F(l3,l4) C^pp(|l1+l3|) f(l1,l3) f(l2,l4), l2 = L-l1,
    l4 = -L-l3, with the radialized 1D tables n1_tt uses (the port of
    tests/test_qe_n1.py's)."""
    geom = qe.geom
    lsafe = np.where(ells > 0, ells, 1.0)
    clpp = np.where(ells > 0, 4.0 * np.asarray(clkk) / lsafe ** 4, 0.0)
    lt, ct = _radial(geom, qe.cl2d["TT"])
    _, ctot = _radial(geom, qe.ctot["TT"])
    _, m1 = _radial(geom, qe.gmask)
    _, m2 = _radial(geom, qe.ymask)
    safe = np.where(ctot > 0, ctot, 1)
    w1t = np.where(ctot > 0, m1 / safe, 0.0)
    w2t = np.where(ctot > 0, m2 / safe, 0.0)
    cl = lambda m: np.interp(m, lt, ct, left=0.0, right=0.0)
    w1 = lambda m: np.interp(m, lt, w1t, left=0.0, right=0.0)
    w2 = lambda m: np.interp(m, lt, w2t, left=0.0, right=0.0)
    lmap = geom.lmap(torch.float64, "cpu").numpy()
    ly, lx = lmap[0].ravel(), lmap[1].ravel()
    ml = np.hypot(lx, ly)
    l2x, l2y = Lx - lx, -ly
    l4x, l4y = -Lx - lx, -ly
    ml2, ml4 = np.hypot(l2x, l2y), np.hypot(l4x, l4y)
    C1, C2, C4 = cl(ml), cl(ml2), cl(ml4)
    F12 = 0.5 * (C1 * (Lx * lx) + C2 * (Lx * l2x)) * w1(ml) * w2(ml2)
    F34 = 0.5 * (C1 * (-Lx * lx) + C4 * (-Lx * l4x)) * w1(ml) * w2(ml4)
    dots13 = lx[:, None] * lx[None, :] + ly[:, None] * ly[None, :]
    f13 = (C1 * ml ** 2)[:, None] + (C1 * ml ** 2)[None, :] \
        + (C1[:, None] + C1[None, :]) * dots13
    dots24 = l2x[:, None] * l4x[None, :] + l2y[:, None] * l4y[None, :]
    f24 = (C2 * ml2 ** 2)[:, None] + (C4 * ml4 ** 2)[None, :] \
        + (C2[:, None] + C4[None, :]) * dots24
    msum = np.hypot(lx[:, None] + lx[None, :], ly[:, None] + ly[None, :])
    cpp = np.interp(msum, ells, clpp, left=0.0, right=0.0)
    tot = np.einsum("i,j,ij,ij,ij->", F12, F34, cpp, f13, f24,
                    optimize=True)
    f12 = C1 * (Lx * lx) + C2 * (Lx * l2x)
    invA = (f12 * F12).sum() / float(geom.area)
    return 2.0 * tot / float(geom.area) ** 2, 1.0 / invA


@pytest.mark.parametrize("i", range(3))
def test_n1_tt_matches_4d_lattice_sum(n1_case, i):
    tq, ells, clkk, _ = n1_case
    L = _LS[i]
    _, got = tqe.n1_tt(tq, [L], clkk, ells=ells, pad=2)
    n1phi_over_a2, aL = _brute_n1_phi(tq, L, ells, clkk)
    want = (L ** 4 / 4.0) * aL ** 2 * n1phi_over_a2
    assert want != 0.0
    assert abs(got[0] / want - 1.0) < RTOL_LATTICE, (L, got[0], want)


def test_iso_profile_is_the_ly0_row(n1_case):
    """The port's radial tables against the test's own numpy ones."""
    tq = n1_case[0]
    for grid in (tq.cl2d["TT"], tq.ctot["TT"], tq.gmask, tq.ymask):
        lt, vt = tqe._iso_profile(tq.geom, grid)
        lr, vr = _radial(tq.geom, grid)
        np.testing.assert_allclose(lt, lr, rtol=1e-12)
        np.testing.assert_array_equal(vt, vr)


def test_n1_tt_unpadded_lattice_aliases(theories):
    """pad=1 differs from the exact answer when the masks allow |l1+l3|
    past Nyquist; the port's pad=1 equals JAX's pad=1 all the same."""
    jq, tq = _n1_engines(theories, lmax_frac=0.95)
    ells = np.arange(theories[1].lpad + 1)
    clkk = np.asarray(theories[1].gCl("kk", ells))
    Ls = np.array([3 * _DL])
    _, padded = tqe.n1_tt(tq, Ls, clkk, ells=ells, pad=2)
    _, nopad = tqe.n1_tt(tq, Ls, clkk, ells=ells, pad=1)
    assert abs(nopad[0] / padded[0] - 1.0) > 1e-3
    _, jnopad = jqe.n1_tt(jq, Ls, clkk, ells=ells, pad=1)
    np.testing.assert_allclose(nopad, np.asarray(jnopad), rtol=RTOL_N1)
