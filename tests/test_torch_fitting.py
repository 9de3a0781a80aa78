"""Parity of the port's ``utils/fitting`` and ``utils/profiling`` with the
JAX package's, on the CPU.

The host functions (numpy and scipy in both packages) agree to 1e-12
relative; the torch linear algebra (``Solver``, ``OQE``, ``sm_update``,
``CinvUpdater``) to 1e-10 relative in float64 (LAPACK's solves in another
order). The draws take a ``torch.Generator`` in place of a JAX key, so
``sim_pte``, the PTE from sims and the samplers are held to the analytic
answer within their Monte-Carlo error, and the samplers' table lookups to
JAX's ``jnp.interp`` on the same uniforms (1e-12).
"""
import json
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from scipy.stats import chi2

from orphics_tpu.utils import fitting as JFIT
from orphics_tpu_torch.utils import fitting as TFIT
from orphics_tpu_torch.utils import profiling as TPROF

torch.set_num_threads(1)

TOL_HOST = 1e-12
TOL_LINALG = 1e-10


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _spd(n, seed):
    a = np.random.default_rng(seed).standard_normal((n, n))
    return a @ a.T / n + np.eye(n)


def test_host_helpers():
    for scale in ("lin", "log"):
        assert _rel(TFIT.npspace(1.0, 100.0, 7, scale),
                    JFIT.npspace(1.0, 100.0, 7, scale)) <= TOL_HOST
    with pytest.raises(ValueError):
        TFIT.npspace(1.0, 2.0, 3, "cubic")
    p = np.array([0.5, 0.05, 0.003])
    assert _rel(TFIT.nsigma_from_pte(p), JFIT.nsigma_from_pte(p)) <= TOL_HOST
    assert _rel(TFIT.pte_from_nsigma(p * 10), JFIT.pte_from_nsigma(p * 10)) \
        <= TOL_HOST
    sims = np.random.default_rng(0).chisquare(5, 1000)
    assert TFIT.get_pte(6.0, sims) == JFIT.get_pte(6.0, sims)
    assert TFIT.alpha_from_confidence(0.95) == JFIT.alpha_from_confidence(
        0.95)
    c = _spd(6, 1)
    assert _rel(TFIT.cov2corr(c), JFIT.cov2corr(c)) <= TOL_HOST
    t = _spd(6, 2)
    for cap in (True, False):
        assert _rel(TFIT.correlated_hybrid_matrix(c, t, cap=cap),
                    JFIT.correlated_hybrid_matrix(c, t, cap=cap)) <= TOL_HOST
    x = np.linspace(10.0, 100.0, 30)
    y = 3.0 * x ** -1.5
    for a, b in zip(TFIT.extrapolate_power_law(x, y, [120.0, 150.0]),
                    JFIT.extrapolate_power_law(x, y, [120.0, 150.0])):
        assert _rel(a, b) <= 1e-8
    ells = np.arange(100.0, 2000.0, 100.0)
    cls = 1e-3 / ells ** 2
    for kw in ({}, {"ell0": 500.0, "alpha": -3.0},
               {"ell0": 500.0, "w0p": 7.0, "ell0p": 400.0, "alphap": -2.0,
                "clxx": cls, "clyy": cls}):
        assert _rel(TFIT.get_sigma2(ells, cls, 5.0, 100.0, 0.1, **kw),
                    JFIT.get_sigma2(ells, cls, 5.0, 100.0, 0.1, **kw)) \
            <= TOL_HOST


def test_fit_linear_model_and_cltt_power():
    rng = np.random.default_rng(3)
    x = np.linspace(0.0, 1.0, 12)
    cov = 0.01 * _spd(12, 4)
    y = 1.0 + 2.0 * x + rng.multivariate_normal(np.zeros(12), cov)
    # deprojecting the monopole leaves a constant template unconstrained:
    # the deprojected fit takes templates orthogonal to it
    for deproject, funcs in (
            (False, [lambda t: np.ones_like(t), lambda t: t]),
            (True, [lambda t: t, lambda t: t ** 2])):
        for a, b in zip(TFIT.fit_linear_model(x, y, cov, funcs,
                                              deproject=deproject),
                        JFIT.fit_linear_model(x, y, cov, funcs,
                                              deproject=deproject)):
            assert _rel(a, b) <= TOL_LINALG
    ells = np.arange(200.0, 3000.0, 100.0)
    theory = lambda l: 1e-2 / np.asarray(l, float) ** 2
    w0 = 10.0
    cls = theory(ells) + 2.0 * (w0 * np.pi / 10800) ** 2
    s2 = (0.05 * cls) ** 2
    ft, fj = (m.fit_cltt_power(ells, cls, theory, w0, s2, fix_knee=True)
              for m in (TFIT, JFIT))
    assert _rel(ft(ells), fj(ells)) <= 1e-8


def test_fit_linear_model_pte_from_sims():
    """The fit is the JAX package's (host numpy); the PTE against 4000
    fiducial sims lies within their Monte-Carlo error of the chi^2 law's
    (the draws differ from JAX's)."""
    rng = np.random.default_rng(5)
    x = np.linspace(0.0, 1.0, 10)
    cov = 0.01 * _spd(10, 6)
    fid = 1.0 + 2.0 * x
    y = fid + rng.multivariate_normal(np.zeros(10), cov)
    funcs = [lambda t: np.ones_like(t), lambda t: t]
    got = TFIT.fit_linear_model_pte_from_sims(
        x, y, cov, funcs, fid, nsims=4000,
        generator=torch.Generator().manual_seed(1), device="cpu")
    want = JFIT.fit_linear_model_pte_from_sims(x, y, cov, funcs, fid,
                                               nsims=4000)
    for a, b in zip(got[:3], want[:3]):
        assert _rel(a, b) <= TOL_LINALG
    exact = 1 - chi2.cdf(got[2] * 8, 8)
    assert abs(got[3] - exact) < 0.03 and abs(want[3] - exact) < 0.03


def test_sim_pte():
    cov = _spd(6, 7)
    data = np.linalg.cholesky(cov) @ np.array([1.0, -0.5, 0.3, 2.0, 0.1,
                                                -1.2])
    chisq = data @ np.linalg.solve(cov, data)
    exact = 1 - chi2.cdf(chisq, 6)
    got = TFIT.sim_pte(data, cov, 20000, device="cpu")
    assert abs(got - exact) < 0.015
    assert abs(JFIT.sim_pte(data, cov, 20000) - exact) < 0.015
    again = TFIT.sim_pte(data, torch.as_tensor(cov), 20000,
                         generator=torch.Generator().manual_seed(0))
    assert again == got          # the default generator is seed 0


def test_solver_oqe_and_rank_one_updates():
    C = _spd(8, 8)
    u = np.random.default_rng(9).standard_normal((8, 2))
    xv = np.random.default_rng(10).standard_normal(8)
    assert _rel(TFIT.Solver(C, u, device="cpu").solve(xv).numpy(),
                JFIT.Solver(C, u).solve(xv)) <= TOL_LINALG
    assert _rel(TFIT.solve(C, xv, device="cpu"), JFIT.solve(C, xv)) \
        <= TOL_LINALG
    dC = {"a": _spd(8, 11), "b": np.diag(np.linspace(1.0, 2.0, 8))}
    fids = {"a": 1.0, "b": 0.5}
    for deproject in (False, True):
        t = TFIT.OQE(C, dC, fids, deproject=deproject, device="cpu")
        j = JFIT.OQE(C, dC, fids, deproject=deproject)
        assert _rel(t.Fisher, j.Fisher) <= TOL_LINALG
        assert t.sigma() == pytest.approx(j.sigma(), rel=TOL_LINALG)
        et, ej = t.estimate(xv), j.estimate(xv)
        assert all(et[k] == pytest.approx(ej[k], rel=1e-8) for k in et)
    assert TFIT.OQESlim is TFIT.OQE
    Ainv = np.linalg.inv(C)
    for v in (None, u[:, 1]):
        (at, dt), (aj, dj) = (TFIT.sm_update(Ainv, u[:, 0], v, device="cpu"),
                              JFIT.sm_update(Ainv, u[:, 0], v))
        assert _rel(at.numpy(), aj) <= TOL_LINALG
        assert dt == pytest.approx(dj, rel=TOL_LINALG)
    cinvs = [Ainv, np.linalg.inv(_spd(8, 12))]
    t = TFIT.CinvUpdater(cinvs, [0.1, 0.2], u[:, 0], device="cpu")
    j = JFIT.CinvUpdater(cinvs, [0.1, 0.2], u[:, 0])
    for i in (0, 1):
        (ct, lt), (cj, lj) = t.get_cinv(i, 0.7), j.get_cinv(i, 0.7)
        assert _rel(ct.numpy(), cj) <= TOL_LINALG
        assert lt == pytest.approx(lj, rel=TOL_LINALG)


def test_inverse_transform_sampling():
    """The samplers' tables equal JAX's, their lookups equal ``jnp.interp``
    on the same uniforms, and the draws follow the tabulated law."""
    x = np.linspace(0.0, 5.0, 201)
    pdf = x * np.exp(-x)
    t = TFIT.InverseTransformSampling(x, pdf, device="cpu")
    j = JFIT.InverseTransformSampling(x, pdf)
    assert _rel(t._cdf.numpy(), j._cdf) <= TOL_HOST
    u = np.concatenate([[0.0, 1.0], np.random.default_rng(13).random(500)])
    look = TFIT._interp(torch.as_tensor(u), t._cdf, t._x)
    assert _rel(look.numpy(), jnp.interp(u, j._cdf, j._x)) <= TOL_HOST
    s = t.generate(40000, generator=torch.Generator().manual_seed(2))
    mean = np.trapezoid(x * pdf, x) / np.trapezoid(pdf, x)
    assert abs(float(s.mean()) - mean) < 0.03
    ys, xs = np.linspace(0.0, 1.0, 31), np.linspace(0.0, 2.0, 41)
    p2 = np.outer(1.0 + ys, np.exp(-xs))
    t2 = TFIT.InverseTransformSampling2D(ys, xs, p2, device="cpu")
    j2 = JFIT.InverseTransformSampling2D(ys, xs, p2)
    assert _rel(t2._ccdf.numpy(), j2._ccdf) <= TOL_HOST
    assert _rel(t2._cdf_y.numpy(), j2._cdf_y) <= TOL_HOST
    ysamp, xsamp = t2.generate(40000, generator=torch.Generator()
                               .manual_seed(3))
    assert ysamp.shape == xsamp.shape == (40000,)
    wy = np.trapezoid(p2, xs)
    assert abs(float(ysamp.mean()) - np.trapezoid(ys * wy, ys)
               / np.trapezoid(wy, ys)) < 0.01
    assert float(xsamp.min()) >= 0.0 and float(xsamp.max()) <= 2.0


def test_eig_analyze_and_timeit(capsys):
    m = np.random.default_rng(14).standard_normal((2, 2, 4, 4))
    m = m + m.transpose(1, 0, 2, 3)
    assert _rel(TFIT.eig_analyze(m), JFIT.eig_analyze(m)) <= TOL_HOST

    @TFIT.timeit
    def work(n):
        return {"a": torch.ones(n), "b": [torch.zeros(2)]}

    out = work(3)
    assert torch.equal(out["a"], torch.ones(3))
    assert "work: " in capsys.readouterr().out


def test_profiling_trace_annotate_show(tmp_path, capsys):
    """``trace`` writes a Chrome trace holding the ``annotate`` range;
    ``show`` prints the block's seconds; ``sync`` returns its argument."""
    with TPROF.trace(str(tmp_path / "tr")):
        with TPROF.annotate("port_range"):
            y = TPROF.sync(torch.ones(64) * 2.0)
    with open(tmp_path / "tr" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "port_range" in names and float(y.sum()) == 128.0
    with TPROF.show("blk"):
        pass
    assert capsys.readouterr().out.startswith("blk: ")
    assert TPROF.timeit is TFIT.timeit
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0
