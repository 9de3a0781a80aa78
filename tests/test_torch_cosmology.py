"""Parity of the port's theory and forecasting modules with the JAX
package: ``models/cosmology`` (background, growth, EH98 power, the Limber
quadrature, Knox forecasts, the lensed-spectra routes and the theory
glue), ``models/rsd`` and ``models/lensed_cls``, on the same parameters.

Tolerances: the host float64 numpy copies run the same arithmetic, so
they agree to 1e-10 relative (most are bit-equal); the Limber quadrature
is a float64 torch computation against the JAX float64 (x64) one, 1e-8;
``get_lensed_cls`` bins a float32 plane on the port (B1's plain version
sums it in float64) where the JAX side bins the float64 plane: 1e-5 of
the spectrum's max, the float32 map-path budget.
"""
import os

import numpy as np
import pytest
import torch

from orphics_tpu.models import cosmology as JC, lensed_cls as JL, rsd as JR
from orphics_tpu.models import theory as JT

from orphics_tpu_torch.models import cosmology as TC, lensed_cls as TL
from orphics_tpu_torch.models import rsd as TR, theory as TT

torch.set_num_threads(1)

RTOL_HOST = 1e-10
RTOL_TORCH64 = 1e-8
RTOL_F32_MAP = 1e-5


def _rel(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


@pytest.fixture(scope="module")
def cosmos():
    return JC.Cosmology(), TC.Cosmology()


@pytest.fixture(scope="module")
def theories():
    return JT.default_theory(), TT.default_theory()


@pytest.fixture(scope="module")
def limbers():
    """Both Limber cosmologies with a step, a sampled and a delta n(z), at
    small grids, and their C_l over 40 ells (each computed once)."""
    kw = dict(numz=100, nz_pk=60, nk_pk=80)
    out = []
    for lc in (JC.LimberCosmology(**kw), TC.LimberCosmology(device="cpu",
                                                            **kw)):
        zs = np.linspace(0.1, 2.0, 40)
        lc.addStepNz("g", 0.2, 1.0, bias=1.5)
        lc.addNz("s", zs, np.exp(-zs))
        lc.addNz("m", zs, np.exp(-(zs - 1) ** 2), bias=1.2, magbias=0.4)
        lc.addDeltaNz("d", 1.5)
        lc.generateCls(np.arange(10, 1500, 37.0))
        out.append(lc)
    return out


def test_background_growth_power(cosmos):
    jc, tc = cosmos
    z = np.linspace(0.0, 3.0, 7)
    a = 1.0 / (1.0 + z)
    k = np.geomspace(1e-4, 10.0, 50)
    for name, args in (("comoving_radial_distance", (z,)),
                       ("redshift_at_comoving_radial_distance",
                        (np.linspace(0, 7000, 9),)),
                       ("angular_diameter_distance", (z,)),
                       ("hubble_parameter", (z,)), ("Ez", (z,)),
                       ("rho_matter_z", (z,)), ("D_growth", (a,)),
                       ("P_lin", (k, 0.7)), ("transfer", (k,))):
        assert _rel(getattr(tc, name)(*args), getattr(jc, name)(*args)) \
            <= RTOL_HOST, name
    assert _rel(tc.transfer(k, type="eisenhu"),
                jc.transfer(k, type="eisenhu")) <= RTOL_HOST
    assert _rel(tc.D_growth(a, norm="matter"), jc.D_growth(a, norm="matter")) \
        <= RTOL_HOST
    assert tc.rdel_m(2e14, 0.5) == pytest.approx(jc.rdel_m(2e14, 0.5),
                                                 rel=RTOL_HOST)
    assert tc.rdel_c(2e14, 0.5) == pytest.approx(jc.rdel_c(2e14, 0.5),
                                                 rel=RTOL_HOST)
    assert tc.sigma8() == pytest.approx(jc.sigma8(), rel=RTOL_HOST)
    assert tc.sigmaR(4.0, 1.0) == pytest.approx(jc.sigmaR(4.0, 1.0),
                                                rel=RTOL_HOST)
    assert tc.chistar == pytest.approx(jc.chistar, rel=RTOL_HOST)
    p = {"H0": 70.0, "As": 2.0e-9}
    assert TC.s8_from_as(2.2e-9, p) == pytest.approx(
        JC.s8_from_as(2.2e-9, p), rel=RTOL_HOST)
    assert TC.As_from_s8(0.8, p) == pytest.approx(JC.As_from_s8(0.8, p),
                                                  rel=RTOL_HOST)


def test_pk_tables(cosmos, tmp_path):
    jc, _ = cosmos
    zs = np.array([0.0, 0.5, 1.0, 2.0])
    ks = np.geomspace(1e-4, 5.0, 60)
    P = np.stack([jc.P_lin(ks, z) for z in zs])
    zq, kq = np.array([0.3, 1.7, 2.5]), np.array([1e-3, 0.1, 3.0])
    assert _rel(TC.pkgrid_from_table(zs, ks, P)(zq, kq),
                JC.pkgrid_from_table(zs, ks, P)(zq, kq)) <= RTOL_HOST
    paths = []
    for i, z in enumerate(zs):
        paths.append(os.path.join(tmp_path, f"pk{i}.dat"))
        np.savetxt(paths[-1], np.stack([ks / 0.7, P[i] * 0.7 ** 3], 1))
    tf, tab = TC.load_camb_pk(paths, zs, 0.7)
    jf, jtab = JC.load_camb_pk(paths, zs, 0.7)
    assert _rel(tf(zq, kq), jf(zq, kq)) <= RTOL_HOST
    for a, b in zip(tab, jtab):
        assert _rel(a, b) <= RTOL_HOST
    # the override reaches P_lin
    over = TC.Cosmology(pkgrid_override=tf)
    assert _rel(over.P_lin(kq, 1.0), jf(1.0, kq)) <= RTOL_HOST


def test_limber_cls(limbers):
    jl, tl = limbers
    assert tl.device.type == "cpu"
    assert sorted(tl.Clmatrix) == sorted(jl.Clmatrix)
    for k in jl.Clmatrix:
        assert _rel(tl.Clmatrix[k], jl.Clmatrix[k]) <= RTOL_TORCH64, k
    assert _rel(tl.getCl("s", "g"), jl.getCl("g", "s")) <= RTOL_TORCH64
    zs, ks = np.array([0.2, 0.9, 2.0]), np.array([1e-3, 0.05, 2.0])
    assert _rel(tl.PK_P(zs, ks), jl.PK_P(zs, ks)) <= RTOL_HOST
    assert _rel(tl.PK_P(zs, ks, grid=True), jl.PK_P(zs, ks, grid=True)) \
        <= RTOL_HOST
    tl.generateCls(np.arange(20, 400, 50.0), autoOnly=True, zmin=0.3)
    jl.generateCls(np.arange(20, 400, 50.0), autoOnly=True, zmin=0.3)
    for k in jl.Clmatrix:
        assert _rel(tl.Clmatrix[k], jl.Clmatrix[k]) <= RTOL_TORCH64, k


def test_limber_clkk_and_lss(cosmos):
    jc, tc = cosmos
    ells = np.arange(10, 1500, 37.0)
    e1, c1 = JC.get_limber_clkk_flat_universe(jc, ells=ells, nz=100)
    e2, c2 = TC.get_limber_clkk_flat_universe(tc, ells=ells, nz=100,
                                              device="cpu")
    assert _rel(e2, e1) == 0 and _rel(c2, c1) <= RTOL_TORCH64
    _, c1 = JC.get_limber_clkk_flat_universe(jc, ells=ells, nz=100, zsrc=1.0)
    _, c2 = TC.get_limber_clkk_flat_universe(tc, ells=ells, nz=100, zsrc=1.0,
                                             device="cpu")
    assert _rel(c2, c1) <= RTOL_TORCH64
    win = {"g": dict(stype="counts", wtype="gaussian", zmean=0.8,
                     zsigma=0.2, b=1.4),
           "s": dict(stype="lensing", wtype="spline",
                     zs=np.linspace(0.1, 2, 30),
                     dndz=np.ones(30))}
    a = JC.get_lss_cls(win, 300)
    b = TC.get_lss_cls(win, 300, device="cpu")
    assert sorted(a) == sorted(b)
    for k in a:
        assert _rel(b[k], a[k]) <= RTOL_TORCH64, k


def test_lens_forecast(theories):
    jth, _ = theories
    ells = np.arange(2, 3000.0)
    clkk = np.asarray(jth.gCl("kk", ells))
    out = []
    for mod in (JC, TC):
        lf = mod.LensForecast()
        lf.loadKK(ells, clkk, ells, clkk * 0.5)
        lf.loadGG(ells, clkk * 3.0, ngal=10.0)
        lf.loadKG(ells, clkk * 0.8)
        lf.loadSS(ells, clkk * 2.0, ngal=20.0)
        edges = np.arange(50, 2000, 150)
        out.append((lf.KnoxCov("kg", "kg", edges, 0.4),
                    lf.sn(edges, 0.4, "kk"),
                    lf.sigmaClSquared("gg", edges, 0.4, ntot=True)))
    (ja, jb, jcv), (ta, tb, tcv) = out
    for a, b in zip(ta + tb + (tcv,), ja + jb + (jcv,)):
        assert _rel(a, b) <= RTOL_HOST
    f_t = TC.noise_pad_infinity(lambda x: x * 2.0, 10, 100)
    f_j = JC.noise_pad_infinity(lambda x: x * 2.0, 10, 100)
    x = np.array([5.0, 50.0, 500.0])
    np.testing.assert_array_equal(f_t(x), f_j(x))


def test_lensed_cls_routes(theories):
    jth, tth = theories
    ells = np.arange(0, 161.0)
    args = [np.asarray(jth.uCl(s, ells)) for s in ("TT", "EE", "BB", "TE")]
    with np.errstate(divide="ignore", invalid="ignore"):
        pp = np.nan_to_num(4.0 * np.asarray(jth.gCl("kk", ells))
                           / (ells * (ells + 1.0)) ** 2)
    a = JL.lensed_cls(*args, pp, lmax=160)
    b = TL.lensed_cls(*args, pp, lmax=160)
    for k in a:
        assert _rel(b[k], a[k]) <= RTOL_HOST, k
    for x, y in zip(TL.lensed_correlations(*args, pp, lmax=160),
                    JL.lensed_correlations(*args, pp, lmax=160)):
        assert _rel(x, y) <= RTOL_HOST
    ee = np.arange(2, 161.0)
    uk = [np.asarray(jth.uCl(s, ee)) for s in ("TT", "EE", "BB", "TE")]
    kk = np.asarray(jth.gCl("kk", ee))
    _, ja = JC.get_lensed_cls_exact(ee, uk[0], kk, ucl_ee=uk[1],
                                    ucl_bb=uk[2], ucl_te=uk[3])
    _, ta = TC.get_lensed_cls_exact(ee, uk[0], kk, ucl_ee=uk[1],
                                    ucl_bb=uk[2], ucl_te=uk[3])
    for k in ja:
        assert _rel(ta[k], ja[k]) <= RTOL_HOST, k
    # the flat-sky route: numpy FFTs, then Bin2D (B1's plain version here)
    big = np.arange(3000.0)
    e1, l1 = JC.get_lensed_cls(big, jth.uCl("TT", big), jth.gCl("kk", big),
                               lmax=2500, npix=128, px_res_arcmin=2.0)
    e2, l2 = TC.get_lensed_cls(big, tth.uCl("TT", big), tth.gCl("kk", big),
                               lmax=2500, npix=128, px_res_arcmin=2.0,
                               device="cpu")
    np.testing.assert_array_equal(e2, e1)
    assert _rel(l2, l1) <= RTOL_F32_MAP


def test_theory_glue(theories, tmp_path):
    jth, tth = theories
    ls = np.arange(6.0)
    np.testing.assert_array_equal(TC.phi2kappa(ls), np.asarray(
        JC.phi2kappa(ls)))
    assert torch.equal(TC.phi2kappa(torch.arange(6.0)),
                       torch.as_tensor(TC.phi2kappa(ls), dtype=torch.float32))
    for kw in (dict(lmax=50), dict(ells=np.linspace(2, 40, 7), lensed=True,
                                   dimensionless=False)):
        assert _rel(TC.enmap_power_from_orphics_theory(tth, **kw),
                    JC.enmap_power_from_orphics_theory(jth, **kw)) \
            <= RTOL_HOST
    ml = torch.rand(4, 4, dtype=torch.float64) * 3000
    p = TC.enmap_power_from_orphics_theory(tth, ells=ml)
    assert isinstance(p, torch.Tensor) and tuple(p.shape) == (3, 3, 4, 4)
    for a, b in zip(TC.unpack_cmb_theory(tth, ls, lensed=True),
                    JC.unpack_cmb_theory(jth, ls, lensed=True)):
        assert _rel(a, b) <= RTOL_HOST
    # a pycamb-style dict of raw spectra
    L = 400
    mat = np.abs(np.random.default_rng(4).standard_normal((L, 4))) * 1e3
    mat[:2] = 0.0                            # CAMB's rows l = 0, 1
    lp = np.abs(np.random.default_rng(5).standard_normal((L + 2, 3))) * 1e-7
    res = {"lensed_scalar": mat, "unlensed_scalar": mat * 1.1,
           "lens_potential": lp}
    t_th = TC.loadTheorySpectraFromPycambResults(res, None, 300, lpad=500)
    j_th = JC.loadTheorySpectraFromPycambResults(res, None, 300, lpad=500)
    for k in j_th.tables:
        np.testing.assert_array_equal(t_th.tables[k],
                                      np.asarray(j_th.tables[k]))
    base = os.path.join(tmp_path, "gl")
    for name in ("gradient", "lensed_scalar", "unlensed_scalar"):
        np.savetxt(f"{base}_{name}.txt", mat * (1.2 if name == "gradient"
                                                else 1.0))
    t_gl, j_gl = TC.load_theory_from_glens(base, lpad=500), \
        JC.load_theory_from_glens(base, lpad=500)
    for k in j_gl.tables:
        np.testing.assert_array_equal(t_gl.tables[k],
                                      np.asarray(j_gl.tables[k]))
    a, b = TC.get_camb_lens_obj(50, 2.0), JC.get_camb_lens_obj(50, 2.0)
    assert _rel(a["zs"], b["zs"]) <= RTOL_HOST and a["kmax"] == b["kmax"]


def test_comparisons_and_gates(tmp_path):
    ks = np.geomspace(1e-3, 0.3, 9)
    for name in ("fk_comparison", "pk_comparison"):
        kt, rt = getattr(TC, name)("H0", 0.5, 67.0, 70.0, ks=ks)
        kj, rj = getattr(JC, name)("H0", 0.5, 67.0, 70.0, ks=ks)
        assert _rel(rt, rj) <= RTOL_HOST
        # the plot, on utils/plot since the galaxy-catalog slice
        out = tmp_path / f"{name}.png"
        _, rp = getattr(TC, name)("H0", 0.5, 67.0, 70.0, ks=ks,
                                  plot_file=str(out))
        np.testing.assert_array_equal(rp, rt)
        assert out.stat().st_size > 0
    # the camb / classy glue raises as the JAX package's does without them
    for name, args in (("CAMB", ()), ("save_glens_cls_from_ini",
                                      ("a.ini", "out")),
                       ("class_cls", (100,))):
        with pytest.raises(ImportError) as jerr:
            getattr(JC, name)(*args)
        with pytest.raises(jerr.type):
            getattr(TC, name)(*args)
    with pytest.raises(NotImplementedError):
        TC.ClassCosmology()


def test_rsd(cosmos):
    jc, tc = cosmos
    assert TR.growth_rate(tc, 0.5) == pytest.approx(JR.growth_rate(jc, 0.5),
                                                    rel=RTOL_HOST)
    ks = np.geomspace(1e-3, 0.3, 20)
    mus = np.linspace(0.0, 1.0, 9)
    for sigz in (None, 0.01):
        a = JR.Pgg_Pvv_Pgv(ks, mus, 0.5, cc=jc, sigz=sigz)
        b = TR.Pgg_Pvv_Pgv(ks, mus, 0.5, cc=tc, sigz=sigz, device="cpu")
        for x, y in zip(b, a):
            assert x.dtype == torch.float64
            assert _rel(x, y) <= RTOL_TORCH64
    params = ["bg", "ns"]
    fid = {"ns": 0.9625356}
    step = {"bg": 0.1, "ns": 0.01}
    dj = JR.kmode_derivatives(ks, mus, params, fid, step, 0.5)
    dt = TR.kmode_derivatives(ks, mus, params, fid, step, 0.5, device="cpu")
    for x, y in zip(dt, dj):
        for p in params:
            assert _rel(x[p], y[p]) <= RTOL_TORCH64, p
    fj = JR.Pgg_Pvv_Pgv(ks, mus, 0.5, cc=jc)
    ft = TR.Pgg_Pvv_Pgv(ks, mus, 0.5, cc=tc, device="cpu")
    Fj = JR.kmode_fisher(ks, mus, 1e9, params, *dj, *fj, 1e3, 1e6)
    Ft = TR.kmode_fisher(ks, mus, 1e9, params, *dt, *ft, 1e3, 1e6)
    for x, y in zip(Ft, Fj):
        assert _rel(x, y) <= RTOL_TORCH64
