"""Parity of the port's ``FastCl`` (``orphics_tpu_torch.models.fastcl``)
with the JAX package's ``orphics_tpu.models.fastcl.FastCl``.

The JAX side runs its Pallas kernels in interpret mode (its default on the
CPU), each reference computed once per module in a fixture; the port runs
its kernels' plain versions (CPU tensors). Inputs come from a numpy seed.
Each comparison runs twice: with the port's own tables and with the JAX
tables carried across by ``convert.load_fastcl_tables``. The cross spectra
(``cross_bandpowers``, kernels B3s and B6s) are held the same way, with
and without the 12 % taper of ``get_taper``.

Bounds: bandpowers agree to 5e-5 relative per bin (fp32 transforms by two
factorizations, fp32 products, bin sums in fp64 on the port and in bf16
hi/lo pairs on the JAX side: ~1e-6 seen); against the float64
``fft2 -> f2power -> Bin2D`` reference, tests/test_core.py's rtol 2e-5.
Cross spectra agree to 5e-5 of the largest |bandpower| (a cross spectrum
of independent maps crosses zero, so a per-bin relative bound is
undefined); ``cross_bandpowers(m, m)`` equals ``map_bandpowers(m)`` to
5e-5 relative per bin, and the fused window equals pre-multiplied maps
to tests/test_core.py's rtol 2e-5.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from orphics_tpu import geometry as jgeo
from orphics_tpu.models import theory as jtheory
from orphics_tpu.models.fastcl import FastCl as JFastCl
from orphics_tpu.ops import fourier as JF
from orphics_tpu.ops import pallas_fft as pf
from orphics_tpu.ops.binning import Bin2D as JBin2D
from orphics_tpu.ops.windows import get_taper as jget_taper

import orphics_tpu_torch as tp
from orphics_tpu_torch.convert import FASTCL_TABLE_NAMES, load_fastcl_tables
from orphics_tpu_torch.models.fastcl import FastCl
from orphics_tpu_torch.ops.windows import get_taper

torch.set_num_threads(1)

N = 256
EDGES = np.arange(80, 4000, 160.0)
RTOL = 5e-5


def _geoms(n=N):
    return (jgeo.rect_geometry(width_arcmin=n * 2.0, px_res_arcmin=2.0),
            tp.rect_geometry(width_arcmin=n * 2.0, px_res_arcmin=2.0))


@pytest.fixture(scope="module")
def ref():
    """The JAX FastCl's outputs and tables at 256^2, lensed TT."""
    th = jtheory.default_theory()
    ells = np.arange(th.lpad + 1)
    cltt = np.asarray(th.lCl("TT", ells))
    jg, _ = _geoms()
    fc = JFastCl(jg, ells, cltt, bin_edges=EDGES)
    rng = np.random.default_rng(21)
    maps = rng.standard_normal((3, N, N)).astype(np.float32)
    er = rng.standard_normal((2, N, N)).astype(np.float32)
    ei = rng.standard_normal((2, N, N)).astype(np.float32)
    yr, yi = pf.rowifft_scaled_y(jnp.asarray(er), jnp.asarray(ei),
                                 fc._covsqrt_pp, interpret=True)
    b1, b2 = fc._pair_bandpowers_y(yr, yi)
    binner = JBin2D(jg.modlmap_np(), EDGES, strategy="rowcum")
    exact = []
    for m in maps:
        k = JF.fft2(jnp.asarray(m, jnp.float64), jg, "raw")
        exact.append(np.asarray(binner.bin(JF.f2power(k, k, jg))[1]))
    tables = {name: (None if getattr(fc, name) is None
                     else np.asarray(getattr(fc, name)))
              for name in FASTCL_TABLE_NAMES}
    maps2 = rng.standard_normal((3, N, N)).astype(np.float32)
    taper, w2 = jget_taper(jg, taper_percent=12.0)
    taper = np.asarray(taper)
    return dict(ells=ells, cltt=cltt, maps=maps, er=er, ei=ei, maps2=maps2,
                taper=taper, w2=w2,
                map_bp=np.asarray(fc.map_bandpowers(maps)),
                sim_bp=np.concatenate([np.asarray(b1), np.asarray(b2)]),
                cross=np.asarray(fc.cross_bandpowers(maps, maps2)),
                cross_w=np.asarray(fc.cross_bandpowers(maps, maps2,
                                                       window=taper)),
                exact=np.stack(exact), tables=tables)


@pytest.fixture(params=["own_tables", "jax_tables"])
def fc(request, ref):
    _, tg = _geoms()
    out = FastCl(tg, ref["ells"], ref["cltt"], bin_edges=EDGES, device="cpu")
    if request.param == "jax_tables":
        load_fastcl_tables(out, ref["tables"])
    return out


def _rel(got, want):
    return np.max(np.abs(got - want) / np.abs(want))


def test_tables_match_jax(ref):
    _, tg = _geoms()
    fc = FastCl(tg, ref["ells"], ref["cltt"], bin_edges=EDGES, device="cpu")
    t = ref["tables"]
    np.testing.assert_array_equal(fc._idc.numpy(), t["_idc"])
    np.testing.assert_array_equal(fc._icnt.numpy(), t["_icnt"])
    assert fc._nsg == int(t["_nsg"]) == len(EDGES) + 1
    np.testing.assert_array_equal(fc._mrow.numpy(), t["_mrow"])
    np.testing.assert_array_equal(fc._ids0.numpy(), t["_oh0"].argmax(1))
    np.testing.assert_array_equal(fc._idsn.numpy(), t["_ohn"].argmax(1))
    np.testing.assert_array_equal(fc.centers, t["centers"])
    # the fp32 |l| planes differ by an ulp on ~1 % of pixels (XLA's sqrt)
    cs = t["_covsqrt_pp"]
    assert fc._covsqrt_pp.is_contiguous()
    assert np.abs(fc._covsqrt_pp.numpy() - cs).max() <= 1e-6 * cs.max()
    assert fc._norm == float(np.float32(tg.area / tg.npix ** 2))


def test_map_bandpowers_matches_jax(fc, ref):
    got = fc.map_bandpowers(ref["maps"])
    assert got.shape == (3, len(EDGES) - 1) and got.dtype == torch.float32
    got = got.numpy()
    assert _rel(got, ref["map_bp"]) <= RTOL
    np.testing.assert_allclose(got, ref["exact"], rtol=2e-5, atol=1e-8)
    # a single 2D map is a batch of one; the odd batch was zero-padded
    one = fc.map_bandpowers(torch.as_tensor(ref["maps"][2])).numpy()
    np.testing.assert_allclose(one[0], got[2], rtol=1e-6)


def test_sim_from_noise_matches_jax(fc, ref):
    got = fc.sim_bandpowers_from_noise(torch.as_tensor(ref["er"]),
                                       torch.as_tensor(ref["ei"]))
    assert got.shape == (4, len(EDGES) - 1)
    assert _rel(got.numpy(), ref["sim_bp"]) <= RTOL


@pytest.mark.parametrize("windowed", [False, True])
def test_cross_bandpowers_matches_jax(fc, ref, windowed):
    """B3s/B3 then B6s and B1 (plain versions here) against the JAX
    FastCl, with and without the taper; the port's taper is the JAX one."""
    _, tg = _geoms()
    window = None
    if windowed:
        window, w2 = get_taper(tg, taper_percent=12.0, device="cpu")
        np.testing.assert_array_equal(window.numpy(), ref["taper"])
        assert abs(w2 - ref["w2"]) <= 2e-6 * ref["w2"]
    got = fc.cross_bandpowers(torch.as_tensor(ref["maps"]),
                              torch.as_tensor(ref["maps2"]), window=window)
    assert got.shape == (3, len(EDGES) - 1) and got.dtype == torch.float32
    want = ref["cross_w" if windowed else "cross"]
    assert np.abs(got.numpy() - want).max() <= RTOL * np.abs(want).max()


def test_cross_bandpowers_auto_and_window(ref):
    """``cross(m, m)`` is ``map_bandpowers(m)``; the fused window equals
    pre-multiplied maps (tests/test_core.py:test_fastcl_cross_window_fused);
    a single 2D pair is a batch of one."""
    _, tg = _geoms()
    fc = FastCl(tg, bin_edges=EDGES, device="cpu")
    m = torch.as_tensor(ref["maps"])
    auto = fc.map_bandpowers(m).numpy()
    assert _rel(fc.cross_bandpowers(m, m).numpy(), auto) <= RTOL
    taper, _ = get_taper(tg, taper_percent=12.0, device="cpu")
    m2 = torch.as_tensor(ref["maps2"])
    a = fc.cross_bandpowers(m, m2, window=taper).numpy()
    b = fc.cross_bandpowers(m * taper, m2 * taper).numpy()
    np.testing.assert_allclose(a, b, rtol=2e-5, atol=1e-8)
    one = fc.cross_bandpowers(m[1], m2[1]).numpy()
    np.testing.assert_allclose(one[0], fc.cross_bandpowers(m, m2)[1].numpy(),
                               rtol=1e-6, atol=1e-12)


def test_sim_bandpowers_seeds_and_law(ref):
    """Int seeds, word pairs and a generator all run the B5 path (its plain
    version here): reproducible per seed, and the mean over 16 sims of
    each bin's ratio to the binned theory is near 1."""
    jg, tg = _geoms()
    fc = FastCl(tg, ref["ells"], ref["cltt"], bin_edges=EDGES, device="cpu")
    a = fc.sim_bandpowers(5, 16)
    assert a.shape == (16, len(EDGES) - 1) and torch.isfinite(a).all()
    assert torch.equal(a, fc.sim_bandpowers(5, 16))
    assert torch.equal(a, fc.sim_bandpowers([5, 0], 16))
    assert not torch.equal(a, fc.sim_bandpowers(6, 16))
    g1 = fc.sim_bandpowers(torch.Generator().manual_seed(3), 4)
    g2 = fc.sim_bandpowers(torch.Generator().manual_seed(3), 4)
    assert torch.equal(g1, g2)
    ml = tg.modlmap_np()
    dig = np.digitize(ml.ravel(), EDGES, right=True)
    cl2d = np.interp(ml.ravel(), ref["ells"], ref["cltt"])
    nb = len(EDGES) - 1
    thb = (np.bincount(dig, cl2d, minlength=nb + 2)
           / np.maximum(np.bincount(dig, minlength=nb + 2), 1))[1:-1]
    ratio = a.double().mean(0).numpy() / thb
    assert abs(ratio.mean() - 1.0) < 0.05, ratio


def test_nonzero_start_ells():
    """Spectra whose ells start at 2 (CAMB tables) are re-gridded, as in
    tests/test_core.py's test_fastcl_nonzero_start_ells."""
    _, tg = _geoms()
    lmax = 8000
    dense = 1e3 / (np.arange(lmax + 1) + 100.0) ** 2
    dense[:2] = 0.0
    edges = np.arange(100, 3000, 200.0)
    fc_dense = FastCl(tg, np.arange(lmax + 1), dense, bin_edges=edges,
                      device="cpu")
    fc_cut = FastCl(tg, np.arange(2, lmax + 1), dense[2:], bin_edges=edges,
                    device="cpu")
    np.testing.assert_allclose(fc_cut._covsqrt_pp.numpy(),
                               fc_dense._covsqrt_pp.numpy(), atol=1e-7)


def test_constructor_and_call_errors(ref):
    _, tg = _geoms()
    with pytest.raises(ValueError, match="bin_edges"):
        FastCl(tg, device="cpu")
    for shape in ((256, 384), (192, 192), (128, 128)):
        g = tp.rect_geometry(width_arcmin=shape[1] * 2.0,
                             height_arcmin=shape[0] * 2.0,
                             px_res_arcmin=2.0)
        with pytest.raises(ValueError, match="square n = 128"):
            FastCl(g, bin_edges=EDGES, device="cpu")
    with pytest.raises(ValueError, match="length mismatch"):
        FastCl(tg, np.arange(10), np.ones(9), bin_edges=EDGES, device="cpu")
    maps_only = FastCl(tg, bin_edges=EDGES, device="cpu")
    with pytest.raises(ValueError, match="ells, cl1d"):
        maps_only.sim_bandpowers(1, 2)
    fc = FastCl(tg, ref["ells"], ref["cltt"], bin_edges=EDGES, device="cpu")
    with pytest.raises(ValueError, match="batch must be even"):
        fc.sim_bandpowers(1, 3)
    with pytest.raises(ValueError, match="map sets must match"):
        fc.cross_bandpowers(ref["maps"][:2], ref["maps"][1:2])

