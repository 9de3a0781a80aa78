"""Parity of the port's copy of ``models/szhalo`` with the JAX package's:
the halo-model pieces, the Compton-y power and the CIB / y x CIB powers,
each on the port's own ``Cosmology`` and ``foregrounds``.

Both modules are host float64 numpy running the same arithmetic, so every
comparison is held to 1e-10 relative (they are bit-equal today); the
quadratures run at small grids (nz, nm <= 8) to stay quick.
"""
import numpy as np
import pytest

from orphics_tpu.models import cosmology as JC, szhalo as JS
from orphics_tpu_torch.models import cosmology as TC, szhalo as TS

RTOL_HOST = 1e-10


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


@pytest.fixture(scope="module")
def cosmos():
    return JC.Cosmology(), TC.Cosmology()


def test_halo_pieces(cosmos):
    jc, tc = cosmos
    sig = np.linspace(0.3, 3.0, 11)
    ms = np.geomspace(1e12, 1e15, 6)
    ells = np.geomspace(100, 8000, 7)
    assert _rel(TS.tinker_f(sig, 0.5), JS.tinker_f(sig, 0.5)) <= RTOL_HOST
    assert _rel(TS.tinker_bias(sig), JS.tinker_bias(sig)) <= RTOL_HOST
    assert _rel(TS.duffy_c200c(ms, 0.5, 0.7), JS.duffy_c200c(ms, 0.5, 0.7)) \
        <= RTOL_HOST
    for a, b in zip(TS.m200c_to_m200m(ms, 0.5, tc),
                    JS.m200c_to_m200m(ms, 0.5, jc)):
        assert _rel(a, b) <= RTOL_HOST
    assert _rel(TS.battaglia_yl(ells, ms, 0.5, tc),
                JS.battaglia_yl(ells, ms, 0.5, jc)) <= RTOL_HOST
    x = np.geomspace(1e-3, 1.0, 9)
    assert _rel(TS.subhalo_mf(x), JS.subhalo_mf(x)) <= RTOL_HOST
    nu = np.array([100.0, 353.0, 857.0])
    assert _rel(TS.shang_sed(nu, 1.2), JS.shang_sed(nu, 1.2)) <= RTOL_HOST


def test_cl_yy(cosmos):
    jc, tc = cosmos
    ells = np.geomspace(100, 5000, 8)
    grid = dict(nz=8, nm=8)
    a = JS.compute_cl_yy(ells, cc=jc, **grid)
    b = TS.compute_cl_yy(ells, cc=tc, **grid)
    assert _rel(b, a) <= RTOL_HOST
    assert _rel(TS.compute_cl_yy(ells, cc=tc, include_2h=False, **grid),
                JS.compute_cl_yy(ells, cc=jc, include_2h=False, **grid)) \
        <= RTOL_HOST
    assert _rel(TS.compute_tsz_power(ells, 90.0, 150.0, Cyy=b),
                JS.compute_tsz_power(ells, 90.0, 150.0, Cyy=a)) <= RTOL_HOST
    assert _rel(TS.clyy(ells, cc=tc, **grid), JS.clyy(ells, cc=jc, **grid)) \
        <= RTOL_HOST
    assert _rel(TS.clyy_classy_sz(ells, cc=tc, **grid),
                JS.clyy_classy_sz(ells, cc=jc, **grid)) <= RTOL_HOST


def test_cib_powers(cosmos):
    jc, tc = cosmos
    kw = dict(nl=5, nz=6, nm=6)
    a = JS.compton_y_cib_powers([150.0, 220.0], [None, 300.0], cc=jc, **kw)
    b = TS.compton_y_cib_powers([150.0, 220.0], [None, 300.0], cc=tc, **kw)
    assert sorted(a) == sorted(b)
    for k in a:
        assert _rel(b[k], a[k]) <= RTOL_HOST, k
    hj = JS.CIBHaloModel(cc=jc, nz=6, nm=6, L0=2.0)
    ht = TS.CIBHaloModel(cc=tc, nz=6, nm=6, L0=2.0)
    ells = np.array([500.0, 3000.0])
    for k, v in hj.cib_cl(ells, 143.0, 217.0, in_uk2=True).items():
        assert _rel(ht.cib_cl(ells, 143.0, 217.0, in_uk2=True)[k], v) \
            <= RTOL_HOST
    for k, v in hj.y_cib_cl(ells, 353.0, in_uk=True).items():
        assert _rel(ht.y_cib_cl(ells, 353.0, in_uk=True)[k], v) <= RTOL_HOST
