"""Parity of the PyTorch port's core modules with the JAX package:
geometry, theory tables, Fourier calculus, Gaussian random fields, and
the port's freedom from jax.

Inputs are made from seeded numpy (or JAX keys for the draws) and go
through both packages; tolerances are stated with each comparison.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from orphics_tpu import geometry as jgeo
from orphics_tpu.ops import fourier as JF
from orphics_tpu.models import grf as jgrf, theory as jtheory

import orphics_tpu_torch as tp
from orphics_tpu_torch import convert
from orphics_tpu_torch.ops import fourier as TF
from orphics_tpu_torch.ops.interp import interp
from orphics_tpu_torch.models import grf as tgrf, theory as ttheory

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# fp32 grids built by both packages from the same float64 axes: they agree
# to a few ulp (1e-6 relative).
RTOL_F32 = 1e-6


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


@pytest.fixture(scope="module")
def geoms():
    """An even square grid and an odd-nx rectangle, both packages."""
    out = []
    for (w, h, res) in ((64 * 3.0, None, 3.0), (37 * 2.0, 48 * 2.0, 2.0)):
        out.append((jgeo.rect_geometry(width_arcmin=w, height_arcmin=h,
                                       px_res_arcmin=res),
                    tp.rect_geometry(width_arcmin=w, height_arcmin=h,
                                     px_res_arcmin=res)))
    return out


@pytest.fixture(scope="module")
def theories():
    return jtheory.default_theory(), ttheory.default_theory()


def test_geometry_scalars_and_grids(geoms):
    assert tp.arcmin == jgeo.arcmin
    for jg, tg in geoms:
        assert (tg.ny, tg.nx, tg.dy, tg.dx, tg.y0) == (jg.ny, jg.nx, jg.dy,
                                                        jg.dx, jg.y0)
        assert tg.shape == jg.shape and tg.npix == jg.npix
        assert tg.pixsize == jg.pixsize and tg.area == jg.area
        assert tg.lmax() == jg.lmax() and tg.ellmax_safe() == jg.ellmax_safe()
        # host float64 twins: the same numpy arithmetic, bit-equal
        for name in ("modlmap_np", "modlmap_r_np"):
            np.testing.assert_array_equal(getattr(tg, name)(),
                                          getattr(jg, name)())
        for a, b in zip(tg.laxes_np(), jg.laxes_np()):
            np.testing.assert_array_equal(a, b)
        for name in ("modlmap", "modlmap_r", "lmap"):
            t = getattr(tg, name)(torch.float32).numpy()
            j = np.asarray(getattr(jg, name)(jnp.float32))
            assert t.shape == j.shape and t.dtype == j.dtype
            assert _rel(t, j) <= RTOL_F32, name


def test_theory_tables_match(theories):
    jth, tth = theories
    assert sorted(tth.tables) == sorted(jth.tables)
    for k in jth.tables:
        # both built by np.interp in float64 from the same files: equal
        np.testing.assert_array_equal(tth.tables[k],
                                      np.asarray(jth.tables[k]))
    ells = np.linspace(0.5, 9500.0, 777)
    for spec in ("TT", "EE", "TE"):
        np.testing.assert_allclose(tth.lCl(spec, ells),
                                   np.asarray(jth.lCl(spec, ells)),
                                   rtol=1e-12, atol=0)
        np.testing.assert_allclose(tth.uCl(spec, ells),
                                   np.asarray(jth.uCl(spec, ells)),
                                   rtol=1e-12, atol=0)
    np.testing.assert_allclose(tth.gCl("kk", ells),
                               np.asarray(jth.gCl("kk", ells)), rtol=1e-12)
    # state carried across as numpy
    conv = convert.theory_from_numpy(
        {k: np.asarray(v) for k, v in jth.tables.items()}, jth.lpad,
        jth.dimensionless)
    np.testing.assert_array_equal(conv.gCl("kk", ells), tth.gCl("kk", ells))


def test_interp_matches_jnp_interp():
    rng = np.random.default_rng(0)
    xp = np.sort(rng.uniform(0, 100, 50))
    fp = rng.standard_normal(50)
    x = rng.uniform(-10, 110, (17, 9))
    for dt, jdt, tol in ((torch.float32, jnp.float32, 1e-6),
                         (torch.float64, jnp.float64, 1e-13)):
        t = interp(torch.as_tensor(x, dtype=dt), xp, fp).numpy()
        j = np.asarray(jnp.interp(jnp.asarray(x, jdt), jnp.asarray(xp, jdt),
                                  jnp.asarray(fp, jdt), left=0.0, right=0.0))
        assert _rel(t, j) <= tol


@pytest.mark.parametrize("norm", ["raw", "ortho", "phys"])
def test_fft_normalizations(geoms, norm):
    rng = np.random.default_rng(1)
    for jg, tg in geoms:
        x = rng.standard_normal((2,) + jg.shape).astype(np.float32)
        xt = torch.as_tensor(x)
        # pocketfft/ducc vs PyTorch's CPU FFT in fp32: 1e-6 of the max
        k_t = TF.fft2(xt, tg, norm)
        k_j = JF.fft2(jnp.asarray(x), jg, norm)
        assert _rel(k_t.numpy(), k_j) <= RTOL_F32
        assert _rel(TF.ifft2(k_t, tg, norm).numpy(),
                    JF.ifft2(k_j, jg, norm)) <= RTOL_F32
        r_t = TF.rfft2(xt, tg, norm)
        r_j = JF.rfft2(jnp.asarray(x), jg, norm)
        assert _rel(r_t.numpy(), r_j) <= RTOL_F32
        back = TF.irfft2(r_t, tg, norm).numpy()
        assert back.shape == x.shape          # odd nx survives the roundtrip
        assert _rel(back, JF.irfft2(r_j, jg, norm)) <= RTOL_F32


def test_masks_filters_beams(geoms):
    rng = np.random.default_rng(2)
    for jg, tg in geoms:
        for kw in (dict(lmin=100, lmax=3000), dict(lmin=0),
                   dict(lxcut=200, lycut=150, lmax=5000)):
            np.testing.assert_array_equal(
                TF.mask_kspace(tg, **kw).numpy(),
                np.asarray(JF.mask_kspace(jg, **kw)))
        ml_t = tg.modlmap(torch.float32)
        ml_j = jg.modlmap(jnp.float32)
        assert _rel(TF.gauss_beam(ml_t, 1.4).numpy(),
                    JF.gauss_beam(ml_j, 1.4)) <= RTOL_F32
        filt = np.array(JF.gauss_beam(ml_j, 3.0))
        x = rng.standard_normal(jg.shape).astype(np.float32)
        assert _rel(TF.kfilter(torch.as_tensor(x), torch.as_tensor(filt),
                               tg).numpy(),
                    JF.kfilter(jnp.asarray(x), jnp.asarray(filt), jg)) \
            <= 1e-5                          # two fp32 FFTs: 1e-5 of the max
        ells = np.arange(6000.0)
        cls = 1.0 / (1.0 + ells) ** 2
        assert _rel(TF.interp1d_to_2d(ells, cls, tg).numpy(),
                    JF.interp1d_to_2d(ells, cls, jg)) <= RTOL_F32


def test_grf_synthesis(geoms, theories):
    jth, tth = theories
    jg, tg = geoms[0]
    ells = np.arange(int(jg.lmax()) + 2)
    ps = np.array(jth.uCl("TT", ells))
    # covsqrt in map_mul units, through eig_pow (1e-6 of the max)
    cs_t = tgrf.spec2flat(tg, ps, exp=0.5)
    cs_j = jgrf.spec2flat(jg, ps, exp=0.5)
    assert cs_t.shape == tuple(cs_j.shape)
    assert _rel(cs_t.numpy(), cs_j) <= RTOL_F32
    mat = np.random.default_rng(3).standard_normal((5, 3, 3))
    mat = mat @ np.swapaxes(mat, -1, -2)
    np.testing.assert_allclose(tgrf.eig_pow(torch.as_tensor(mat), 0.5).numpy(),
                               np.asarray(jgrf.eig_pow(jnp.asarray(mat), 0.5)),
                               rtol=1e-10, atol=1e-12)
    # the same white noise through both synthesis routes
    key = jax.random.PRNGKey(5)
    eta = np.array(jgrf.rand_kmap(key, jg, 1, dtype=jnp.float32))
    m_j = jgrf.rand_map(key, jg, cs_j)
    m_t = tgrf.rand_map_from_noise(torch.as_tensor(eta), tg, cs_t)
    assert m_t.shape == tuple(m_j.shape)
    assert _rel(m_t.numpy(), m_j) <= 1e-5        # fp32 FFT of a GRF
    mg = tgrf.MapGen(tg, ps[None, None])
    assert _rel(mg.get_map_from_noise(torch.as_tensor(eta)).numpy(),
                m_j) <= 1e-5
    # half-plane route: Hermitian noise from the same normals
    kr, ki = jax.random.split(key)
    shape = (jg.ny, jg.nx // 2 + 1)
    zr = np.array(jax.random.normal(kr, shape, jnp.float32))
    zi = np.array(jax.random.normal(ki, shape, jnp.float32))
    h_t = tgrf.hermitian_half_from_noise(torch.as_tensor(zr),
                                         torch.as_tensor(zi), tg)
    h_j = np.asarray(jgrf.rand_hermitian_half(key, jg))
    np.testing.assert_allclose(h_t.numpy(), h_j, rtol=0, atol=1e-6)
    ch_t = tgrf.covsqrt_half(tg, ells, ps)
    ch_j = jgrf.covsqrt_half(jg, ells, ps)
    assert _rel(ch_t.numpy(), ch_j) <= RTOL_F32
    assert _rel(tgrf.rand_map_r_from_noise(h_t, tg, ch_t).numpy(),
                jgrf.rand_map_r(key, jg, ch_j)) <= 1e-5
    # generator draws: right shapes, Hermitian columns, unit variance
    gen = torch.Generator().manual_seed(0)
    h = tgrf.rand_hermitian_half(tg, gen, batch=(4,))
    assert h.shape == (4,) + shape and h.dtype == torch.complex64
    col = h[..., 0]
    np.testing.assert_allclose(col.numpy(),
                               torch.roll(torch.flip(col, (-1,)), 1, -1)
                               .conj().resolve_conj().numpy(), atol=1e-6)
    assert abs(float((h.abs() ** 2).mean()) - 1.0) < 0.05
    m = tgrf.rand_map(tg, cs_t, gen, batch=(2,))
    assert m.shape == (2,) + tg.shape and torch.isfinite(m).all()


def test_port_imports_no_jax():
    """The port runs without jax: importing its modules loads none."""
    code = ("import sys\n"
            "import orphics_tpu_torch, orphics_tpu_torch.models.lenspipe, "
            "orphics_tpu_torch.models.qe, orphics_tpu_torch.ops.dft, "
            "orphics_tpu_torch.ops.mirror, orphics_tpu_torch.ops.noise_planes, "
            "orphics_tpu_torch.ops.rowpower, orphics_tpu_torch.models.fastcl, "
            "orphics_tpu_torch.entry, orphics_tpu_torch.convert\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'orphics_tpu.')) or "
            "m == 'orphics_tpu')\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
