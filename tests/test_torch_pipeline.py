"""Parity of the port's end-to-end forms with the JAX package:

  * ``LensedQEPipeline.core`` against the JAX half-plane step
    (``impl="xla"``, Pallas lens kernel in interpret mode) on the same
    Hermitian draws, at lens orders 3 and 5, once with the port's own
    planes and once with the JAX planes loaded through
    ``convert.load_pipeline_planes``;
  * the full-plane ``LensedQEPipeline._pp_core`` against the JAX
    ``_pp_core(interpret=True)`` at 256^2 on the same injected noise
    planes, with the port's own planes and with the JAX planes through
    ``convert.load_pipeline_pp_planes``; and the ``impl`` selection;
  * the flagship ``step_from_noise`` against
    ``__graft_entry__._build_qe_pipeline``'s step on the same draws.

Bounds: 2e-4 of each spectrum's max for the half-plane forms, the bound
tests/test_lensing.py holds the fused JAX pipeline to against its unfused
pieces; 5e-4 for the full-plane form, the bound tests/test_qe_pallas.py
holds the JAX full-plane path to.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import __graft_entry__ as graft
from orphics_tpu import geometry as jgeo
from orphics_tpu.models import grf as jgrf, lenspipe as jpipe, theory as jtheory

import orphics_tpu_torch as tp
from orphics_tpu_torch import convert, entry
from orphics_tpu_torch.models import lenspipe as tpipe, theory as ttheory

torch.set_num_threads(1)

ATOL_SPEC = 2e-4
PIPE_KW = dict(beam_arcmin=2.0, noise_uk_arcmin=5.0, xlmax=3000, klmax=2000)


def _assert_spectra_close(got, ref, skip=()):
    """(B, 3, nbins) spectra within ATOL_SPEC of each spectrum's max."""
    assert got.shape == ref.shape
    scale = np.abs(ref).max(axis=(0, 2), keepdims=True)
    keep = [i for i in range(ref.shape[1]) if i not in skip]
    np.testing.assert_allclose(got[:, keep] / scale[:, keep],
                               ref[:, keep] / scale[:, keep], atol=ATOL_SPEC)


@pytest.fixture(scope="module")
def geoms():
    return (jgeo.rect_geometry(width_arcmin=64 * 3.0, px_res_arcmin=3.0),
            tp.rect_geometry(width_arcmin=64 * 3.0, px_res_arcmin=3.0))


@pytest.fixture(scope="module")
def theories():
    return jtheory.default_theory(), ttheory.default_theory()


def _jax_etas(key, geom, batch):
    """The three Hermitian noise sets of the JAX half-plane step."""
    keys = jax.random.split(key, 3 * batch).reshape(batch, 3, 2)
    return [np.array(jax.vmap(lambda k: jgrf.rand_hermitian_half(k, geom))(
        keys[:, i])) for i in range(3)]


def _jax_planes(jp):
    planes = {name: np.asarray(getattr(jp, name))
              for name in tpipe.PLANE_NAMES}
    planes["ncov_h"] = jp.ncov_h
    planes["norm"] = jp.norm
    plans = jp.qe._tt_half_plans()
    for name, arr in zip(convert.TT_HALF_NAMES, plans[:6]):
        planes["tt_half." + name] = None if arr is None else np.asarray(arr)
    return planes


@pytest.mark.parametrize("order", [3, 5])
def test_pipeline_core_matches_jax_step(geoms, theories, order):
    jg, tg = geoms
    jth, tth = theories
    jp = jpipe.LensedQEPipeline(jg, jth, lens_order=order, impl="xla",
                                interpret=True, **PIPE_KW)
    tpp = tpipe.LensedQEPipeline(tg, tth, lens_order=order, impl="xla",
                                 device="cpu", **PIPE_KW)
    batch = 2
    key = jax.random.PRNGKey(21 + order)
    ref = np.asarray(jp.step(key, batch))
    etas = [torch.as_tensor(e) for e in _jax_etas(key, jg, batch)]

    # the port's own planes
    got = tpp.core(*etas).numpy()
    _assert_spectra_close(got, ref, skip=(2,))
    # auto_rec - N0: the JAX N0 plane is flushed to zero at high L (fp32
    # underflow of A_L^2, see test_torch_qe), so compare the reconstructed
    # auto power with each side's own N0 added back
    _, n0_t = tpp.binner.bin(tpp.n0_h)
    n0_j = np.asarray(jp.binner.bin(jp.n0_h)[1])
    raw_t = got[:, 2] + n0_t.numpy()
    raw_j = ref[:, 2] + n0_j
    np.testing.assert_allclose(raw_t / np.abs(raw_j).max(),
                               raw_j / np.abs(raw_j).max(), atol=ATOL_SPEC)

    # the JAX planes carried across: core alone, all three spectra
    convert.load_pipeline_planes(tpp, _jax_planes(jp))
    got2 = tpp.core(*etas).numpy()
    _assert_spectra_close(got2, ref)


def test_pipeline_planes_and_api(geoms, theories):
    jg, tg = geoms
    jth, tth = theories
    jp = jpipe.LensedQEPipeline(jg, jth, lens_order=5, impl="xla",
                                interpret=True, **PIPE_KW)
    tpp = tpipe.LensedQEPipeline(tg, tth, lens_order=5, device="cpu",
                                 **PIPE_KW)
    # fp32 planes from the same float64 tables: 1e-5 of each plane's max
    for name in ("csq_coeff", "csq_kk", "alpha_filt", "kbeam_h",
                 "inv_beam_h"):
        a = getattr(tpp, name).numpy()
        b = np.asarray(getattr(jp, name))
        assert a.shape == b.shape, name
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), name
    assert tpp.ncov_h == jp.ncov_h and tpp.norm == jp.norm
    np.testing.assert_array_equal(tpp.binner.counts, jp.binner.counts)
    np.testing.assert_array_equal(tpp.centers(), jp.centers())
    # 64^2 has no full-plane path: the JAX package's ValueError
    with pytest.raises(ValueError, match="requires a square grid"):
        tpipe.LensedQEPipeline(tg, tth, impl="pallas", device="cpu",
                               **PIPE_KW)
    gen = torch.Generator().manual_seed(0)
    out = tpp.step(3, gen)
    assert out.shape == (3, 3, tpp.binner.nbins)
    assert torch.isfinite(out).all()


def test_flagship_step_matches_graft_entry(theories):
    """The 64^2, 8' geometry of __graft_entry__'s own dry run."""
    jth, tth = theories
    jg = jgeo.rect_geometry(width_arcmin=64 * 8.0, px_res_arcmin=8.0)
    tg = tp.rect_geometry(width_arcmin=64 * 8.0, px_res_arcmin=8.0)
    jstep = graft._build_qe_pipeline(jg, jth, beam=8.0, noise=10.0)
    tstep = entry.build_qe_pipeline(tg, tth, beam=8.0, noise=10.0,
                                    device="cpu")
    key = jax.random.PRNGKey(4)
    ref = np.asarray(jax.jit(jstep)(key))
    etas = [torch.as_tensor(np.array(jgrf.rand_kmap(k, jg, 1,
                                                      dtype=jnp.float32)))
            for k in jax.random.split(key, 3)]
    got = tstep.step_from_noise(*etas).numpy()
    assert got.shape == ref.shape == (3, 15)
    _assert_spectra_close(got[None], ref[None])
    gen = torch.Generator().manual_seed(0)
    out = tstep.step(gen)
    assert out.shape == (3, 15) and torch.isfinite(out).all()


# ---- the full-plane path (impl="pallas") --------------------------------

ATOL_PP = 5e-4


@pytest.fixture(scope="module")
def pp_pipes(theories):
    """256^2, 2', order 3, batch 2 (tests/test_qe_pallas.py's setup): the
    JAX and port full-plane pipelines, injected noise planes from a numpy
    seed scaled by the JAX planes, and the JAX ``_pp_core`` output."""
    jth, tth = theories
    n = 256
    jg = jgeo.rect_geometry(width_arcmin=n * 2.0, px_res_arcmin=2.0)
    tg = tp.rect_geometry(width_arcmin=n * 2.0, px_res_arcmin=2.0)
    jp = jpipe.LensedQEPipeline(jg, jth, lens_order=3, impl="pallas",
                                interpret=True)
    tpp = tpipe.LensedQEPipeline(tg, tth, lens_order=3, impl="pallas",
                                 device="cpu")
    assert jp.impl == tpp.impl == "pallas"
    rng = np.random.default_rng(0)
    P = 1

    def drawn(scale_pp):
        sc = np.asarray(scale_pp)[None]
        return tuple((rng.standard_normal((P, n, n)) * sc).astype(np.float32)
                     for _ in range(2))

    planes = [drawn(jp.csq_kk_pp), drawn(jp.csq_coeff_pp),
              drawn(jp.nscale_pp)]
    ref = np.asarray(jp._pp_core(*[tuple(jnp.asarray(a) for a in z)
                                   for z in planes], 2, interpret=True))
    return jp, tpp, planes, ref


def _jax_pp_planes(jp):
    planes = {name: np.asarray(getattr(jp, name))
              for name in tpipe.PP_PLANE_NAMES}
    planes.update(idc=np.asarray(jp._idc), icnt=np.asarray(jp._icnt),
                  nseg=jp._nseg, norm=jp.norm)
    for name, arr in zip(convert.TT_PP_NAMES, jp.qe._tt_pp_plans()):
        planes["tt_pp." + name] = np.asarray(arr)
    return planes


def _torch_planes(planes):
    return [tuple(torch.as_tensor(a) for a in z) for z in planes]


def _binned_n0(idc, icnt, nseg, n0_pp):
    sums = np.bincount(np.asarray(idc), weights=np.asarray(
        n0_pp, np.float64).ravel(), minlength=nseg)
    return sums[1:] * np.asarray(icnt)


def test_pp_planes_match_jax(pp_pipes):
    jp, tpp, _, _ = pp_pipes
    # fp32 planes from the same float64 recipes: 1e-5 of each plane's max
    for name in tpipe.PP_PLANE_NAMES[:-1]:
        # the kernels take contiguous planes only
        assert getattr(tpp, name).is_contiguous(), name
        a = getattr(tpp, name).numpy()
        b = np.asarray(getattr(jp, name))
        assert a.shape == b.shape, name
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), name
    np.testing.assert_array_equal(tpp._perm, jp._perm)
    np.testing.assert_array_equal(tpp._idc.numpy(), np.asarray(jp._idc))
    np.testing.assert_array_equal(tpp._icnt.numpy(), np.asarray(jp._icnt))
    assert tpp._nseg == jp._nseg and tpp.norm == jp.norm
    # N0: the JAX plane is flushed to zero where A_L^2 underflows in fp32
    # (ROADMAP C); the port's is held to the JAX plane where it is normal,
    # to the 2e-4 that A_L itself agrees to at 256^2 (test_torch_qe)
    n0_t, n0_j = tpp.n0_pp.numpy(), np.asarray(jp.n0_pp)
    normal = n0_j != 0
    assert normal.sum() > 1000
    assert (np.abs(n0_t - n0_j)[normal].max()
            <= 2e-4 * np.abs(n0_j[normal]).max())


def test_pp_core_matches_jax_own_planes(pp_pipes):
    jp, tpp, planes, ref = pp_pipes
    got = tpp._pp_core(*_torch_planes(planes), 2).numpy()
    assert got.shape == ref.shape == (2, 3, len(tpp.centers()))
    scale = np.abs(ref).max(axis=(0, 2), keepdims=True)
    np.testing.assert_allclose(got[:, :2] / scale[:, :2],
                               ref[:, :2] / scale[:, :2], atol=ATOL_PP)
    # auto_rec - N0: compare with each side's own binned N0 added back
    raw_t = got[:, 2] + _binned_n0(tpp._idc, tpp._icnt, tpp._nseg,
                                   tpp.n0_pp)
    raw_j = ref[:, 2] + _binned_n0(jp._idc, jp._icnt, jp._nseg, jp.n0_pp)
    np.testing.assert_allclose(raw_t / np.abs(raw_j).max(),
                               raw_j / np.abs(raw_j).max(), atol=ATOL_PP)


def test_pp_core_matches_jax_planes_via_convert(pp_pipes, theories):
    jp, _, planes, ref = pp_pipes
    tg = tp.rect_geometry(width_arcmin=256 * 2.0, px_res_arcmin=2.0)
    tpp = tpipe.LensedQEPipeline(tg, theories[1], lens_order=3,
                                 device="cpu")
    convert.load_pipeline_pp_planes(tpp, _jax_pp_planes(jp))
    got = tpp._pp_core(*_torch_planes(planes), 2).numpy()
    _assert_spectra_close(got, ref)
    with pytest.raises(ValueError, match="full-plane"):
        convert.load_pipeline_pp_planes(
            tpipe.LensedQEPipeline(tg, theories[1], impl="xla",
                                   device="cpu"),
            _jax_pp_planes(jp))


def test_pp_step(pp_pipes):
    _, tpp, _, _ = pp_pipes
    gen = torch.Generator().manual_seed(3)
    out = tpp.step(4, gen)
    assert out.shape == (4, 3, len(tpp.centers()))
    assert torch.isfinite(out).all()
    again = tpp.step(4, torch.Generator().manual_seed(3))
    assert torch.equal(out, again)
    with pytest.raises(ValueError, match="even"):
        tpp.step(3, gen)


@pytest.mark.parametrize("shape,impl,want", [
    ((64, 64), "auto", "xla"),
    ((256, 256), "auto", "pallas"),
    ((256, 256), "xla", "xla"),
    ((256, 256), "pallas", "pallas"),
    ((384, 384), "auto", "pallas"),
    ((256, 384), "auto", "xla"),
    ((192, 192), "auto", "xla"),
    ((128, 128), "pallas", ValueError),
    ((256, 384), "pallas", ValueError),
])
def test_impl_selection_matches_jax(theories, shape, impl, want):
    """``impl`` picks the path exactly where the JAX package does."""
    jth, tth = theories
    ny, nx = shape
    kw = dict(width_arcmin=nx * 3.0, height_arcmin=ny * 3.0,
              px_res_arcmin=3.0)
    jg, tg = jgeo.rect_geometry(**kw), tp.rect_geometry(**kw)
    if want is ValueError:
        for make, g, th, dev in ((jpipe.LensedQEPipeline, jg, jth, {}),
                                 (tpipe.LensedQEPipeline, tg, tth,
                                  dict(device="cpu"))):
            with pytest.raises(ValueError, match="requires a square grid"):
                make(g, th, impl=impl, **dev, **PIPE_KW)
        return
    tpp = tpipe.LensedQEPipeline(tg, tth, impl=impl, device="cpu",
                                 **PIPE_KW)
    assert tpp.impl == want
    assert jpipe.LensedQEPipeline(jg, jth, impl=impl, interpret=True,
                                  **PIPE_KW).impl == want
