"""models/curved_qe of the port against the JAX package, with the sign of
the JAX ``qtt_bar`` repaired.

Tolerances:
* the closed-form sums (``_w3j000_sq``, ``_qtt_sums``, ``response_tt``,
  ``n0_tt``) and the ``CurvedQE`` tables against JAX's host float64 numpy,
  at lmax 64 (every L sampled) and lmax 200 (the log grid): 1e-12
  relative. Both build the log-factorial table with scipy's ``gammaln``
  and add the exponent's terms in the same order, so the sums differ by
  the order of the last additions only (~1e-16 read);
* ``grad_dot`` and ``qtt_bar`` on complex64 alms: 1e-5 of max, the float32
  SHT tolerance of ``tests/test_torch_sht.py``. ``qtt_bar`` is held to a
  reference composed of JAX public functions only,
  -[grad_dot(Tbar, W) + map2alm(alm2map(Tbar) alm2map(W_lm l(l+1) -> -))]
  = -int Y* div(Tbar grad W), not to JAX's ``qtt_bar``, whose last two
  terms carry the wrong sign (ROADMAP queue C): it differs from that
  reference by more than 10 % of max;
* the first-order response of the normalized ``CurvedQE.phi_from_alm``,
  exact in float64 (a trace over a real basis of T's modes, below): 1 to
  1e-3 at every L in [2, lmax]. The same trace through JAX's ``CurvedQE``
  records its misnormalization: more than 50 % off at some L <= 10.

Every ring grid here is exact to degree 3 lmax
(``gauss_legendre_rings(ceil(3 lmax / 2))``): the estimator analyses
products of three band-lmax fields; on ``gauss_legendre_rings(lmax)`` the
trace is more than 10 % off at L = lmax (a record of the requirement).
Each JAX reference is computed once per module, in a fixture.
"""
import jax  # noqa: F401  (the JAX package runs on its CPU backend)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orphics_tpu.models import curved_qe as jqe
from orphics_tpu.ops import alm as jalm
from orphics_tpu.ops import sht as jsht
from orphics_tpu_torch.models import curved_qe as tqe
from orphics_tpu_torch.models.theory import default_theory
from orphics_tpu_torch.ops import alm as talm
from orphics_tpu_torch.ops import sht as tsht

torch.set_num_threads(1)

TOL_SUMS = 1e-12
TOL_F32 = 1e-5
TOL_RESP = 1e-3
NOISE = (10.0 * np.pi / 10800.0) ** 2     # 10 uK-arcmin white noise
LMAX_SHT = 24          # grad_dot, qtt_bar, qtt
LMAX_RESP = 16         # the exact first-order trace


def _spectra(lmax):
    """Lensed TT and its total with 10 uK-arcmin white noise, to lmax."""
    cl = default_theory().lCl("TT", np.arange(lmax + 1))
    return cl, cl + NOISE


def _rings(mod, lmax):
    """The package's Gauss-Legendre grid exact to degree 3 lmax."""
    return mod.gauss_legendre_rings(-(-3 * lmax // 2))


def _alm(rng, cl, shape=(), dtype=np.complex64):
    """Gaussian alms of ``cl`` in healpy packing, m = 0 real."""
    lmax = cl.size - 1
    ls, ms = talm.lm_indices(lmax)
    re, im = rng.standard_normal((2,) + shape + (ls.size,))
    sig = np.sqrt(cl[ls] / np.where(ms == 0, 1.0, 2.0))
    return ((re + 1j * np.where(ms == 0, 0.0, im)) * sig).astype(dtype)


def _rel(got, ref):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def _elementwise(got, ref):
    """max |got - ref| / |ref| over the entries of ``ref`` that are not 0;
    the zero entries must be zero."""
    got, ref = np.asarray(got), np.asarray(ref)
    nz = ref != 0
    assert np.all(got[~nz] == 0)
    return float(np.max(np.abs(got[nz] - ref[nz]) / np.abs(ref[nz])))


def _basis(lmax):
    """A real basis of T's healpy-packed modes with each mode's share of
    C_l: (E (N, nalm) complex128, l of each, share): a unit real part at m
    = 0 (variance C_l), a unit real and a unit imaginary part at m > 0
    (C_l / 2 each)."""
    ls, ms = talm.lm_indices(lmax)
    rows, ells, share = [], [], []
    for i, (l, m) in enumerate(zip(ls, ms)):
        for v in ((1.0,) if m == 0 else (1.0, 1j)):
            e = np.zeros(ls.size, np.complex128)
            e[i] = v
            rows.append(e)
            ells.append(l)
            share.append(1.0 if m == 0 else 0.5)
    return np.array(rows), np.array(ells), np.array(share)


def _phi_mode(lmax, L):
    """phi with the single mode (L, M = L // 2): 0.7 - 0.4 i (0.7 at
    M = 0)."""
    ls, ms = talm.lm_indices(lmax)
    i = int(np.flatnonzero((ls == L) & (ms == L // 2))[0])
    phi = np.zeros(ls.size, np.complex128)
    phi[i] = 0.7 if L // 2 == 0 else 0.7 - 0.4j
    return phi, i


def _first_order_trace(grad_dot, phi_from_alm, cl, lmax, Ls=None):
    """For each L in ``Ls`` (default [2, lmax]): the exact expectation over T0 ~ cl of the
    normalized estimator of T = T0 + grad(phi) . grad(T0), to first order
    in a single-mode phi, through the public quadratic estimator only:
    sum_k C_k [P(e_k + de_k) - P(e_k) - P(de_k)] = sum_k C_k [B(e_k,
    de_k) + B(de_k, e_k)], de_k = grad_dot(phi, e_k), B the estimator's
    bilinear form and P its quadratic one. Returns {L: (expectation,
    phi)}."""
    E, ells, share = _basis(lmax)
    keep = cl[ells] > 0
    E, c = E[keep], (cl[ells] * share)[keep]
    out = {}
    for L in range(2, lmax + 1) if Ls is None else Ls:
        phi, _ = _phi_mode(lmax, L)
        dE = np.asarray(grad_dot(np.broadcast_to(phi, E.shape).copy(), E))
        P = np.asarray(phi_from_alm(np.concatenate([E + dE, E, dE])))
        n = E.shape[0]
        d = P[:n] - P[n:2 * n] - P[2 * n:]
        out[L] = (np.einsum("k,ki->i", c, d), phi)
    return out


@pytest.fixture(scope="module")
def jref():
    """The JAX package's outputs on the module's inputs."""
    out = {}
    for lmax in (64, 200):
        cl, ctot = _spectra(lmax)
        Ls = jqe._default_Ls(lmax)
        out[("sums", lmax)] = (Ls, *jqe._qtt_sums(cl, ctot, lmax, Ls))
        out[("resp", lmax)] = jqe.response_tt(cl, ctot, lmax)
        out[("n0", lmax)] = jqe.n0_tt(cl, ctot, lmax)
        out[("n0", lmax, "Ls")] = jqe.n0_tt(cl, ctot, lmax,
                                            Ls=[2, 7, 30, lmax], lmin=5)
        qe = jqe.CurvedQE(_rings(jsht, 4), lmax, cl, ctot)
        out[("engine", lmax)] = {k: np.asarray(getattr(qe, k)) for k in (
            "Ls", "R", "N0num", "n0_phi", "_rinv_dense", "fl", "wl")}
        out[("engine", lmax, "kappa")] = qe.n0("kappa")
    lg = jqe._lgfact(3 * 200 + 200 + 2)
    l1, l2 = np.arange(201)[:, None], np.arange(201)[None, :]
    out["w3j"] = {L: jqe._w3j000_sq(l1, l2, L, lg) for L in (0, 1, 7, 64,
                                                            200)}
    # complex64 SHT-level functions at LMAX_SHT
    lmax = LMAX_SHT
    cl, ctot = _spectra(lmax)
    rings = _rings(jsht, lmax)
    rng = np.random.default_rng(18)
    # one batch size (3) throughout: the JAX transforms compile per shape
    a, b = _alm(rng, cl, (3,)), _alm(rng, 1e-7 / (np.arange(lmax + 1)
                                                  + 1.0) ** 3, (3,))
    out["grad_dot"] = (a, b, np.asarray(jqe.grad_dot(a, b, rings, lmax)))
    t = _alm(rng, ctot, (3,))
    qe = jqe.CurvedQE(rings, lmax, cl, ctot)
    f32 = lambda f: jnp.asarray(np.asarray(f, np.float32))
    tbar = jalm.almxfl(t, f32(qe.fl))
    w = jalm.almxfl(t, f32(qe.wl))
    ells = np.arange(lmax + 1.0)
    lapw = jalm.almxfl(w, f32(-ells * (ells + 1.0)))
    ref = -(jqe.grad_dot(tbar, w, rings, lmax)
            + jsht.map2alm(jsht.alm2map(tbar, rings, lmax)
                           * jsht.alm2map(lapw, rings, lmax), rings, lmax))
    out["qtt_bar"] = (t, np.asarray(ref),
                      np.asarray(jqe.qtt_bar(t, rings, lmax, qe.fl, qe.wl)),
                      qe._rinv_dense, jqe.qtt(t, rings, lmax, cl, ctot,
                                              norm="kappa")[1])
    # the first-order trace through JAX's CurvedQE, float64
    lmax = LMAX_RESP
    cl, ctot = _spectra(lmax)
    rings = _rings(jsht, lmax)
    qe = jqe.CurvedQE(rings, lmax, cl, ctot)
    out["trace"] = _first_order_trace(
        lambda p, e: jqe.grad_dot(p, e, rings, lmax), qe.phi_from_alm, cl,
        lmax)
    return out


# ----------------------------------------------------------- the sums

def test_w3j000_sq_matches_jax(jref):
    lg = tqe._lgfact(3 * 200 + 200 + 2, "cpu")
    l1 = torch.arange(201)[:, None]
    l2 = torch.arange(201)[None, :]
    for L, ref in jref["w3j"].items():
        got = tqe._w3j000_sq(l1, l2, L, lg).numpy()
        assert _elementwise(got, ref) <= TOL_SUMS, L
    # the triangle and parity rules, and one closed value:
    # (1 1 0; 0 0 0)^2 = 1/3
    assert float(tqe._w3j000_sq(torch.tensor(1), torch.tensor(1), 0, lg)) \
        == pytest.approx(1.0 / 3.0, rel=1e-15)
    assert float(tqe._w3j000_sq(torch.tensor(1), torch.tensor(2), 0,
                                lg)) == 0.0


@pytest.mark.parametrize("lmax", [64, 200])
def test_qtt_sums_match_jax(jref, lmax):
    Ls, R, N0num = jref[("sums", lmax)]
    cl, ctot = _spectra(lmax)
    got_R, got_N = tqe._qtt_sums(cl, ctot, lmax, Ls, device="cpu")
    assert _elementwise(got_R, R) <= TOL_SUMS
    assert _elementwise(got_N, N0num) <= TOL_SUMS
    assert np.array_equal(tqe._default_Ls(lmax), Ls)


@pytest.mark.parametrize("lmax", [64, 200])
def test_response_and_n0_match_jax(jref, lmax):
    cl, ctot = _spectra(lmax)
    for key, fn, kw in (
            (("resp", lmax), tqe.response_tt, {}),
            (("n0", lmax), tqe.n0_tt, {}),
            (("n0", lmax, "Ls"), tqe.n0_tt,
             dict(Ls=[2, 7, 30, lmax], lmin=5))):
        Ls, ref = jref[key]
        got_Ls, got = fn(cl, ctot, lmax, device="cpu", **kw)
        assert np.array_equal(got_Ls, Ls)
        assert isinstance(got, np.ndarray) and got.dtype == np.float64
        assert _elementwise(got, ref) <= TOL_SUMS, key


@pytest.mark.parametrize("lmax", [64, 200])
def test_curved_qe_tables_match_jax(jref, lmax):
    cl, ctot = _spectra(lmax)
    qe = tqe.CurvedQE(_rings(tsht, 4), lmax, cl, ctot, device="cpu")
    ref = jref[("engine", lmax)]
    assert np.array_equal(qe.Ls, ref["Ls"])
    for name in ("R", "N0num", "n0_phi", "_rinv_dense", "fl", "wl"):
        got = getattr(qe, name)
        assert isinstance(got, np.ndarray) and got.dtype == np.float64
        assert _elementwise(got, ref[name]) <= TOL_SUMS, name
    Ls, n0k = qe.n0("kappa")
    assert np.array_equal(Ls, jref[("engine", lmax, "kappa")][0])
    assert _elementwise(n0k, jref[("engine", lmax, "kappa")][1]) <= TOL_SUMS


# ------------------------------------------------- the device path

def test_grad_dot_matches_jax(jref):
    a, b, ref = jref["grad_dot"]
    got = tqe.grad_dot(torch.as_tensor(a), torch.as_tensor(b),
                       _rings(tsht, LMAX_SHT), LMAX_SHT)
    assert got.dtype == torch.complex64 and got.shape == ref.shape
    assert _rel(got, ref) <= TOL_F32


def test_qtt_bar_matches_the_composed_reference(jref):
    """The port's gbar equals -int Y* div(Tbar grad W) composed of JAX
    public functions; JAX's own qtt_bar does not (the sign fault)."""
    t, ref, jax_own, _, _ = jref["qtt_bar"]
    cl, ctot = _spectra(LMAX_SHT)
    qe = tqe.CurvedQE(_rings(tsht, LMAX_SHT), LMAX_SHT, cl, ctot,
                      device="cpu")
    got = tqe.qtt_bar(torch.as_tensor(t), qe.rings, LMAX_SHT, qe.fl, qe.wl)
    assert got.dtype == torch.complex64 and got.shape == ref.shape
    assert _rel(got, ref) <= TOL_F32
    assert _rel(jax_own, ref) > 0.1
    # leading batch dimensions are carried: each map alone is the same
    one = tqe.qtt_bar(torch.as_tensor(t[1]), qe.rings, LMAX_SHT, qe.fl,
                      qe.wl)
    assert _rel(one, ref[1]) <= TOL_F32
    both = tqe.qtt_bar(torch.as_tensor(t[:2].reshape(1, 2, -1)), qe.rings,
                       LMAX_SHT, qe.fl, qe.wl)
    assert both.shape == (1, 2, ref.shape[-1])
    assert _rel(both[0], ref[:2]) <= TOL_F32


def test_qtt_and_kappa_from_alm_match_the_reference(jref):
    """qtt and CurvedQE normalize the repaired gbar by 1/R (phi) and by
    L(L+1)/(2R) (kappa); qtt's N0 is JAX's, in each convention. Each entry
    within TOL_F32 of max|gbar| times its L's factor: 1/R_L spans four
    decades, so a tolerance of the normalized output's max would read the
    float32 residue of the monopole (zero analytically) times 1/R_1."""
    t, ref, _, rinv, (Ls_k, n0_k) = jref["qtt_bar"]
    ells = np.arange(LMAX_SHT + 1.0)
    ls = talm.lm_indices(LMAX_SHT)[0]
    cl, ctot = _spectra(LMAX_SHT)
    rings = _rings(tsht, LMAX_SHT)
    tt = torch.as_tensor(t)
    qe = tqe.CurvedQE(rings, LMAX_SHT, cl, ctot, device="cpu")
    for norm, fac, got in (
            ("phi", rinv, tqe.qtt(tt, rings, LMAX_SHT, cl, ctot)[0]),
            ("kappa", rinv * ells * (ells + 1.0) / 2.0,
             tqe.qtt(tt, rings, LMAX_SHT, cl, ctot, norm="kappa")[0]),
            ("phi", rinv, qe.phi_from_alm(tt)),
            ("kappa", rinv * ells * (ells + 1.0) / 2.0,
             qe.kappa_from_alm(tt))):
        got = got.numpy()
        scale = np.max(np.abs(ref)) * fac[ls]
        assert np.all(got[..., scale == 0] == 0), norm
        err = np.abs(got - ref * fac[ls])[..., scale > 0] / scale[scale > 0]
        assert err.max() <= TOL_F32, norm
    _, (Ls, n0) = tqe.qtt(tt, rings, LMAX_SHT, cl, ctot)
    _, (Ls2, n0k) = tqe.qtt(tt, rings, LMAX_SHT, cl, ctot, norm="kappa")
    assert np.array_equal(Ls2, Ls_k) and np.array_equal(Ls, Ls_k)
    assert _elementwise(n0k, n0_k) <= TOL_SUMS
    Lf = Ls.astype(np.float64)
    assert _elementwise(n0k, (Lf * (Lf + 1.0) / 2.0) ** 2 * n0) <= 1e-15


@pytest.fixture(scope="module")
def port_trace():
    lmax = LMAX_RESP
    cl, ctot = _spectra(lmax)
    rings = _rings(tsht, lmax)
    qe = tqe.CurvedQE(rings, lmax, cl, ctot, device="cpu")
    return _first_order_trace(
        lambda p, e: tqe.grad_dot(torch.as_tensor(p), torch.as_tensor(e),
                                  rings, lmax),
        qe.phi_from_alm, cl, lmax)


@pytest.mark.parametrize("L", range(2, LMAX_RESP + 1))
def test_first_order_response_is_exact(port_trace, L):
    """The expectation of the normalized estimator over T0 is phi itself,
    to first order: the ratio at (L, M) is 1 within TOL_RESP, and no other
    mode responds by more than TOL_RESP of phi_LM."""
    want, phi = port_trace[L]
    _, i = _phi_mode(LMAX_RESP, L)
    assert abs(want[i] / phi[i] - 1.0) <= TOL_RESP
    assert np.max(np.abs(want - phi)) <= TOL_RESP * abs(phi[i])


def test_natural_rings_alias_the_response():
    """Why every grid here is exact to degree 3 lmax: on
    ``gauss_legendre_rings(lmax)`` (exact to 2 lmax + 1) the products
    alias and the same trace reads a response more than 10 % off 1 at L =
    lmax (ROADMAP queue C)."""
    lmax = LMAX_RESP
    cl, ctot = _spectra(lmax)
    rings = tsht.gauss_legendre_rings(lmax)
    qe = tqe.CurvedQE(rings, lmax, cl, ctot, device="cpu")
    want, phi = _first_order_trace(
        lambda p, e: tqe.grad_dot(torch.as_tensor(p), torch.as_tensor(e),
                                  rings, lmax),
        qe.phi_from_alm, cl, lmax, Ls=[lmax])[lmax]
    _, i = _phi_mode(lmax, lmax)
    assert abs(want[i] / phi[i] - 1.0) > 0.1


def test_jax_curved_qe_is_misnormalized(jref):
    """A record of the JAX estimator's fault: the same trace through its
    CurvedQE is more than 50 % off at some L <= 10 (ROADMAP queue C; the
    ratios are in CHANGES.md)."""
    ratio = {}
    for L, (want, phi) in jref["trace"].items():
        _, i = _phi_mode(LMAX_RESP, L)
        ratio[L] = (want[i] / phi[i]).real
    assert max(abs(ratio[L] - 1.0) for L in range(2, 11)) > 0.5, ratio


# ------------------------------------------------------ the device rule

@pytest.mark.parametrize("call", ["CurvedQE", "response_tt", "n0_tt",
                                  "qtt"])
def test_no_card_raises(call):
    """With no ``device``, the sums go to the card; where CUDA is not
    available they raise the port's RuntimeError, naming device="cpu"."""
    if torch.cuda.is_available():
        assert tqe.resolve(None) == torch.device("cuda")
        return
    lmax = 8
    cl, ctot = _spectra(lmax)
    rings = _rings(tsht, lmax)
    fn = {"CurvedQE": lambda: tqe.CurvedQE(rings, lmax, cl, ctot),
          "response_tt": lambda: tqe.response_tt(cl, ctot, lmax),
          "n0_tt": lambda: tqe.n0_tt(cl, ctot, lmax),
          "qtt": lambda: tqe.qtt(np.zeros(talm.nalm(lmax), np.complex64),
                                 rings, lmax, cl, ctot)}[call]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        fn()


if __name__ == "__main__":
    # PYTHONPATH=. python tests/test_torch_curved_qe.py: the readings the
    # tests above gate, and the log-factorial table's choice
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    ref = jref.__wrapped__()
    for lmax in (64, 200):
        Ls, R, N0num = ref[("sums", lmax)]
        got_R, got_N = tqe._qtt_sums(*_spectra(lmax), lmax, Ls,
                                     device="cpu")
        print(f"sums at lmax {lmax} vs JAX: R {_elementwise(got_R, R):.3e},"
              f" N0num {_elementwise(got_N, N0num):.3e} relative")
    ratio = lambda tr: {L: float((w[_phi_mode(LMAX_RESP, L)[1]]
                                  / p[_phi_mode(LMAX_RESP, L)[1]]).real)
                        for L, (w, p) in tr.items()}
    print("JAX CurvedQE first-order ratios:", {
        L: round(v, 4) for L, v in ratio(ref["trace"]).items()})
    lmax = LMAX_RESP
    cl, ctot = _spectra(lmax)
    for name, rings in (("exact to 3 lmax", _rings(tsht, lmax)),
                        ("gauss_legendre_rings(lmax)",
                         tsht.gauss_legendre_rings(lmax))):
        qe = tqe.CurvedQE(rings, lmax, cl, ctot, device="cpu")
        r = ratio(_first_order_trace(
            lambda p, e: tqe.grad_dot(torch.as_tensor(p),
                                      torch.as_tensor(e), rings, lmax),
            qe.phi_from_alm, cl, lmax))
        print(f"port first-order ratios, rings {name}: min "
              f"{min(r.values())}, max {max(r.values())}")
    t, gref, jax_own, _, _ = ref["qtt_bar"]
    cl, ctot = _spectra(LMAX_SHT)
    rings = _rings(tsht, LMAX_SHT)
    qe = tqe.CurvedQE(rings, LMAX_SHT, cl, ctot, device="cpu")
    a, b, gd = ref["grad_dot"]
    got = tqe.qtt_bar(torch.as_tensor(t), rings, LMAX_SHT, qe.fl, qe.wl)
    got_gd = tqe.grad_dot(torch.as_tensor(a), torch.as_tensor(b), rings,
                          LMAX_SHT)
    print(f"qtt_bar vs the composed reference: port {_rel(got, gref):.3e}, "
          f"JAX {_rel(jax_own, gref):.3e}; grad_dot port vs JAX "
          f"{_rel(got_gd, gd):.3e}")
    n = torch.arange(802, dtype=torch.float64) + 1.0
    lg_t = torch.lgamma(n)
    lg_s = tqe._lgfact(801, "cpu")
    ulp = ((lg_t - lg_s).abs() / torch.finfo(torch.float64).eps
           / lg_s.abs().clamp_min(1.0)).max().item()
    l1, l2 = torch.arange(201)[:, None], torch.arange(201)[None, :]
    w_s = tqe._w3j000_sq(l1, l2, 200, lg_s)
    w_t = tqe._w3j000_sq(l1, l2, 200, lg_t)
    nz = w_s != 0
    print(f"torch.lgamma vs scipy's gammaln to n = 801: {ulp:.2f} ulp; "
          f"(l1 l2 200; 0 0 0)^2 with it: "
          f"{((w_t - w_s).abs()[nz] / w_s[nz]).max().item():.3e} relative")
