"""The port's facades and the modules of the map-tools slice against the
JAX package: every public name resolves at the same path, the maps
facade's own functions agree with the JAX ones, and models/shear (numpy
on the Limber quadrature) agrees with the JAX module.

Tolerances: the maps facade's float64 functions 1e-10 of max|ref|; its
Q/U -> E/B rotated transforms and spectra 1e-6 (the JAX package forms the
rotation matrix in float32, the port in the data's float64); its binned
power 1e-6 of max (Bin2D sums float32 planes in float64); shear
1e-8 relative (the Limber quadrature in float64 torch against JAX's float64
in another order, carried through the binned chi^2 and Fisher sums).
"""
import importlib
import inspect
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orphics_tpu import geometry as jgeo
from orphics_tpu import maps as JMAPS
from orphics_tpu.models import shear as JS

import orphics_tpu_torch as tp
from orphics_tpu_torch import maps as TMAPS
from orphics_tpu_torch.models import shear as TS

torch.set_num_threads(1)

TOL64 = 1e-10
TOL_ROT = 1e-6
TOL_BIN = 1e-6
TOL_SHEAR = 1e-8

FACADES = ("maps", "lensing", "pixcov", "foregrounds", "algorithms",
           "cosmology", "mpi", "stats", "io", "catalogs", "time",
           "interfaces", "ephem", "time_utils")
MODULES = ("models.mapstools", "utils.healpix", "models.curved",
           "models.shear")


def _ours(v):
    """Not a module, and not a function or class of another library
    (``functools.partial`` and the like)."""
    if isinstance(v, types.ModuleType):
        return False
    if callable(v) and hasattr(v, "__module__"):
        return (v.__module__ or "").startswith("orphics_tpu")
    return True


def _public(mod):
    """Public names of a module: its ``__all__`` and every attribute
    without a leading underscore that is a value or a function or class
    of the package."""
    names = {n for n, v in vars(mod).items()
             if not n.startswith("_") and _ours(v) and n != "annotations"}
    return names | set(getattr(mod, "__all__", ()))


@pytest.mark.parametrize("path", FACADES + MODULES)
def test_public_names_resolve(path):
    """Every public name of the JAX module resolves in the port's module
    of the same path, and every public function or class defined there
    too."""
    jmod = importlib.import_module("orphics_tpu." + path)
    tmod = importlib.import_module("orphics_tpu_torch." + path)
    missing = sorted(n for n in _public(jmod) if not hasattr(tmod, n))
    assert not missing, missing
    assert set(getattr(tmod, "__all__", ())) >= set(getattr(jmod, "__all__",
                                                             ()))
    for n in _public(jmod):
        if inspect.isfunction(getattr(jmod, n)) or inspect.isclass(
                getattr(jmod, n)):
            assert callable(getattr(tmod, n)), n


def test_maps_facade_functions():
    kw = dict(width_arcmin=48 * 2.0, px_res_arcmin=2.0)
    jg, tg = jgeo.rect_geometry(**kw), tp.rect_geometry(**kw)
    rng = np.random.default_rng(3)
    imap = rng.standard_normal((3,) + jg.shape)
    mask = rng.uniform(0.5, 1.0, jg.shape)
    tmap = torch.as_tensor(imap)
    assert TMAPS.MapRotator is importlib.import_module(
        "orphics_tpu_torch.models.curved").MapRotator
    jfc, tfc = JMAPS.FourierCalc(jg), TMAPS.FourierCalc(tg)
    for a, b in zip(tfc.power2d(tmap), jfc.power2d(imap)):
        assert float(np.max(np.abs(a.numpy() - np.asarray(b)))) \
            <= TOL_ROT * float(np.max(np.abs(np.asarray(b))))
    k1 = tfc.iqu2teb(tmap)
    assert np.allclose(k1.numpy(), np.asarray(jfc.iqu2teb(imap)),
                       rtol=0, atol=TOL_ROT * np.abs(k1.numpy()).max())
    p, _ = tfc.f1power(tmap, k1)
    pj = np.asarray(jfc.f1power(imap, np.asarray(k1))[0])
    assert np.max(np.abs(p.numpy() - pj)) <= TOL_ROT * np.max(np.abs(pj))
    assert np.allclose(tfc.ifft(tfc.fft(tmap)).real.numpy(), imap)
    for ps in (None, np.asarray(jg.pixsizemap(jnp.float64))):
        assert float(TMAPS.wfactor(2, mask, pixsizemap=ps, device="cpu")) \
            == pytest.approx(float(JMAPS.wfactor(2, mask, pixsizemap=ps)),
                             rel=TOL64)
    edges = np.arange(200, 4000, 300.0)
    cj, pj = JMAPS.binned_power(imap[0], edges, mask=mask, geom=jg)
    ct, pt = TMAPS.binned_power(tmap[0], edges, mask=mask, geom=tg)
    np.testing.assert_array_equal(ct, cj)
    assert float(np.max(np.abs(pt.numpy() - np.asarray(pj)))) \
        <= TOL_BIN * float(np.max(np.abs(np.asarray(pj))))
    x = np.linspace(0, 10, 11)
    f_t, f_j = TMAPS.interp(x, x ** 2, -1.0), JMAPS.interp(x, x ** 2, -1.0)
    q = np.array([-1.0, 0.5, 3.3, 10.0, 12.0])
    np.testing.assert_allclose(f_t(q, device="cpu").numpy(),
                               np.asarray(f_j(q)), rtol=TOL64)


@pytest.fixture(scope="module")
def shear_pair():
    kw = dict(zsrc=1.0, ngal_arcmin2=20.0, fsky=0.4, nell=8, trim_lmax=300,
              lmax=250, nz_pk=40, nk_pk=80)
    return JS.LimberCosmicShear(**kw), TS.LimberCosmicShear(device="cpu",
                                                            **kw)


def test_shear_likelihood(shear_pair):
    js, ts = shear_pair
    np.testing.assert_array_equal(ts.bin_edges, js.bin_edges)
    np.testing.assert_allclose(ts.data_binned, js.data_binned,
                               rtol=TOL_SHEAR)
    np.testing.assert_allclose(ts.cov, js.cov, rtol=TOL_SHEAR)
    assert ts.sn() == pytest.approx(js.sn(), rel=TOL_SHEAR)
    assert ts.logp(cl_kk=ts._cl_fid) == 0.0
    assert ts.logp(cl_kk=js._cl_fid * 1.05) == pytest.approx(
        js.logp(cl_kk=js._cl_fid * 1.05), rel=TOL_SHEAR)
    names_t, F_t = ts.fisher({"H0": (67.5, 1.0)})
    names_j, F_j = js.fisher({"H0": (67.5, 1.0)})
    assert names_t == names_j
    np.testing.assert_allclose(F_t, F_j, rtol=1e-6)
    cl = 1.0 / (np.arange(600) + 10.0) ** 2
    edges = np.geomspace(20, 500, 8)
    np.testing.assert_array_equal(
        TS.gaussian_band_covariance(edges, cl, np.full(600, 1e-8), 0.4),
        JS.gaussian_band_covariance(edges, cl, np.full(600, 1e-8), 0.4))
