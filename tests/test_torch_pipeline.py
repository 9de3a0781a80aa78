"""Parity of the port's two end-to-end forms with the JAX package:

  * ``LensedQEPipeline.core`` against the JAX half-plane step
    (``impl="xla"``, Pallas lens kernel in interpret mode) on the same
    Hermitian draws, at lens orders 3 and 5, once with the port's own
    planes and once with the JAX planes loaded through
    ``convert.load_pipeline_planes``;
  * the flagship ``step_from_noise`` against
    ``__graft_entry__._build_qe_pipeline``'s step on the same draws.

Bound: 2e-4 of each spectrum's max, the bound tests/test_lensing.py holds
the fused JAX pipeline to against its unfused pieces.
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
                                 **PIPE_KW)
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
    tpp = tpipe.LensedQEPipeline(tg, tth, lens_order=5, **PIPE_KW)
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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpipe.LensedQEPipeline(tg, tth, impl="pallas", **PIPE_KW)
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
    tstep = entry.build_qe_pipeline(tg, tth, beam=8.0, noise=10.0)
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
