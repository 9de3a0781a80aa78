"""Parity of the port's foreground module (``orphics_tpu_torch.models.
foregrounds``) with ``orphics_tpu.models.foregrounds``.

Both modules are host numpy code reading the same templates from
``orphics_tpu/data``, so SEDs, templates and the ``fg_dict`` components
agree to 1e-12 relative (the same arithmetic; only the red-noise factor,
which the JAX package takes from its jnp ``noise`` module, is recomputed
in numpy). ``ilc_power`` goes through each package's ``ilc_cov``, theory
tables and beams: 1e-10 relative.
"""
import numpy as np
import pytest

from orphics_tpu.models import foregrounds as JFG

from orphics_tpu_torch.models import foregrounds as TFG

RTOL = 1e-12
FREQS = np.array([39.0, 93.0, 145.0, 225.0, 280.0, 350.0])


def test_seds_equal():
    nu = np.linspace(20.0, 900.0, 57)
    for name in ("dBnudT", "ItoDeltaT", "g_tsz", "ffunc", "dust_mu"):
        np.testing.assert_allclose(getattr(TFG, name)(nu),
                                   getattr(JFG, name)(nu), rtol=RTOL,
                                   err_msg=name)
    np.testing.assert_allclose(TFG.planck(nu * 1e9, 19.6),
                               JFG.planck(nu * 1e9, 19.6), rtol=RTOL)
    assert TFG.default_constants == JFG.default_constants
    np.testing.assert_array_equal(TFG.g_tsz(FREQS), JFG.g_tsz(FREQS))


@pytest.mark.parametrize("comp", ["tsz", "cibc", "cibp", "radps", "ksz"])
def test_fg_dict_components_equal(comp):
    ells = np.arange(2, 9000, 7.0)
    flux = 10.0 + 0 * FREQS
    got = TFG.fg_dict(flux, FREQS)[comp]
    want = JFG.fg_dict(flux, FREQS)[comp]
    for nu1, nu2 in ((39.0, 39.0), (93.0, 145.0), (350.0, 225.0)):
        np.testing.assert_allclose(got(ells, nu1, nu2), want(ells, nu1, nu2),
                                   rtol=RTOL, err_msg=f"{comp} {nu1}x{nu2}")


def test_templates_and_models_equal():
    ells = np.arange(0, 12000, 3.0)
    for name in ("power_y_template", "power_ksz_reion", "power_ksz_late"):
        np.testing.assert_allclose(getattr(TFG, name)(ells),
                                   getattr(JFG, name)(ells), rtol=RTOL,
                                   err_msg=name)
    np.testing.assert_allclose(
        TFG.dust_C_ell_Louis25(ells, 145.0, 225.0, 2.0),
        JFG.dust_C_ell_Louis25(ells, 145.0, 225.0, 2.0), rtol=RTOL)
    p = JFG._default_param_template(FREQS)
    assert TFG._default_param_template(FREQS) == p
    yy = JFG.power_y_template(ells)
    np.testing.assert_allclose(TFG.fg_cl(ells, p, 1, 2, yy, FREQS),
                               JFG.fg_cl(ells, p, 1, 2, yy, FREQS), rtol=RTOL)
    # the red-noise auto and the correlated-atmosphere cross
    lk, al = [2000.0, 0.0, 1500.0], [-3.5, -3.5, -4.0]
    for i, j in ((0, 0), (1, 1), (0, 2)):
        np.testing.assert_allclose(
            TFG.get_noise(ells, i, j, 8.0, 12.0, lk, al, atm_corr=0.3),
            JFG.get_noise(ells, i, j, 8.0, 12.0, lk, al, atm_corr=0.3),
            rtol=RTOL)
    np.testing.assert_allclose(TFG.sky_model(ells, 0, 1, p, FREQS),
                               JFG.sky_model(ells, 0, 1, p, FREQS),
                               rtol=1e-10)


ELLS = np.arange(0, 9000, 11.0)
BEAMS2 = [lambda x, b=b: np.exp(-(b * np.pi / 10800) ** 2 * x ** 2
                                / (16 * np.log(2))) for b in (2.2, 1.4)]
FIT_ELL = np.arange(100.0, 3000.0, 5.0)
FIT_ARGS = dict(freqs=np.array([93.0, 145.0]), dT_guess=[8.0, 10.0],
                beams=BEAMS2, lknees=[0.0, 0.0], alphas=[-3.5, -3.5])


def _model(mod):
    """Model curves of a fixed parameter set with the shipped templates:
    the fits' data, made by the module under test."""
    p = mod._default_param_template(FIT_ARGS["freqs"])
    th = _theory()
    return mod.evaluate_model_dict(
        FIT_ELL, p, cl_cmb_tmpl=np.asarray(th.lCl("TT", FIT_ELL)),
        cl_yy=mod.power_y_template(FIT_ELL), **FIT_ARGS)


def _theory():
    # one theory object for both modules, so that the fits see the same
    # numbers (each package's own tables agree only to ~1e-10)
    from orphics_tpu_torch.models.theory import default_theory
    return default_theory()


def _quick_fit(mod):
    best, err, _ = mod.quick_fit(FIT_ELL, _model(mod)["total"], fsky=0.4,
                                 delta_ell=100, theory=_theory(), **FIT_ARGS)
    return best, err


def _fit_cross_leastsq(mod):
    ell = np.arange(0.0, 3000.0)
    P = np.zeros((29, ell.size))
    for b in range(29):
        P[b, 100 * (b + 1):100 * (b + 2)] = 0.01
    th = _theory()

    def theory_func(ells, nu1, nu2, p):
        return (p["A_cmb"] * np.asarray(th.lCl("TT", ells))
                + mod.power_tsz(ells, nu1, nu2, A_tsz=p["A_tsz"],
                                silence=True))

    truth = {"A_cmb": 1.02, "A_tsz": 4.0}
    data = {}
    for pair, (n1, n2) in {(0, 0): (93.0, 93.0), (0, 1): (93.0, 145.0),
                           (1, 1): (145.0, 145.0)}.items():
        bp = P @ (theory_func(ell, n1, n2, truth) + 2e-6)
        data[pair] = (bp, 0.02 * np.abs(bp) + 1e-9)
    best, res = mod.fit_cross_leastsq(
        data, [93.0, 145.0], P, {(0, 1): [(300.0, 2500.0)]}, theory_func,
        {"A_cmb": 1.0, "A_tsz": 5.0})
    return best, res.x


# every public function of the copy that no test above holds, on each
# module: the guard against the two copies drifting apart
COPIED = {
    "cltsz": lambda m: m.cltsz(1.3, 93.0, 145.0, m.power_y_template(ELLS)),
    "dl_filler": lambda m: [m.dl_filler(ELLS, [100.0, 50.0, 4000.0],
                                        [3.0, 1.0, 7.0], fill, pos, True)
                            for fill in ("extrapolate", "constant_dl",
                                         "zeros") for pos in (False, True)],
    "power_tsz": lambda m: m.power_tsz(ELLS, 93.0, 225.0, silence=True),
    "power_cibp": lambda m: m.power_cibp(ELLS, 145.0, 280.0),
    "power_cibc": lambda m: m.power_cibc(ELLS, 93.0, n_cib=2.5),
    "power_radps": lambda m: m.power_radps(ELLS, 93.0, 145.0, 7.0, 10.0),
    "get_radio_differential_source_counts": lambda m: (
        m.get_radio_differential_source_counts(np.geomspace(0.1, 50, 40),
                                               93.0)),
    "parse_Kij_file": lambda m: m.parse_Kij_file(),
    "get_radio_power": lambda m: [
        m.get_radio_power(7.0, 93.0), m.get_radio_power(5.0, 145.0,
                                                        prefit=False),
        m.get_radio_power(7.0, 93.0, 10.0, 145.0),
        m.get_radio_power(7.0, 280.0)],
    "get_official_ilc_noise": lambda m: [m.get_official_ilc_noise(e)
                                         for e in ("so", "s4")],
    "get_ilc_noise": lambda m: m.get_ilc_noise("hd", ellmax=3000),
    "wnoise_cl": lambda m: m.wnoise_cl(np.array([2.0, 8.0, 36.0])),
    "evaluate_model_dict": _model,
    "model_vec": lambda m: m.model_vec(
        list(m._default_param_template(FIT_ARGS["freqs"])),
        list(m._default_param_template(FIT_ARGS["freqs"]).values()),
        FIT_ELL, FIT_ARGS["freqs"], FIT_ARGS["dT_guess"], BEAMS2,
        [2000.0, 1500.0], [-3.5, -4.0], np.asarray(
            _theory().lCl("TT", FIT_ELL)), m.power_y_template(FIT_ELL)),
    "quick_fit+fg_fit": _quick_fit,
    "fit_cross_leastsq": _fit_cross_leastsq,
}


def _assert_same(got, want, what):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _assert_same(got[k], want[k], f"{what}[{k}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{what}[{i}]")
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=what)


@pytest.mark.parametrize("name", sorted(COPIED))
def test_copied_functions_equal(name):
    _assert_same(COPIED[name](TFG), COPIED[name](JFG), name)


def test_ilc_power_equal():
    beams = np.array([5.1, 2.2, 1.4])
    noises = np.array([36.0, 8.0, 10.0])
    freqs = FREQS[:3]
    flux = np.array([10.0, 7.0, 10.0])
    for kw in (dict(), dict(inv_noise_weighting=True),
               dict(include_fg=False, total=True)):
        ells, got = TFG.ilc_power(beams, noises, freqs, flux, ellmax=4000,
                                  **kw)
        jells, want = JFG.ilc_power(beams, noises, freqs, flux, ellmax=4000,
                                    **kw)
        np.testing.assert_array_equal(ells, jells)
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)
