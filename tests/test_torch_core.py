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
from orphics_tpu_torch import entry as tentry
from orphics_tpu_torch._device import resolve
from orphics_tpu_torch.models import grf as tgrf, theory as ttheory
from orphics_tpu_torch.models import fastcl as tfastcl, lenspipe as tpipe
from orphics_tpu_torch.ops import binning as tbinning, windows as twindows
from orphics_tpu_torch.ops import alm as talm, sht as tsht
from orphics_tpu_torch.models import curved as tcurved, noise as tnoise
from orphics_tpu_torch.models import lensing as tlensing, qe as tqe
from orphics_tpu_torch.ops import algorithms as talgorithms
from orphics_tpu_torch.ops import distance as tdistance
from orphics_tpu_torch.models import cosmology as tcosmology
from orphics_tpu_torch.models import nfwfit as tnfwfit, pixcov as tpixcov
from orphics_tpu_torch.models import rsd as trsd, splits as tsplits
from orphics_tpu_torch.models import mapstools as tmapstools
from orphics_tpu_torch.utils import healpix as thealpix
from orphics_tpu_torch.utils import fitting as tfitting
import orphics_tpu_torch.parallel as tparallel
from orphics_tpu_torch.models import catalogs as tcatalogs

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
            t = getattr(tg, name)(torch.float32, "cpu").numpy()
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
                TF.mask_kspace(tg, **kw, device="cpu").numpy(),
                np.asarray(JF.mask_kspace(jg, **kw)))
        ml_t = tg.modlmap(torch.float32, "cpu")
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
        assert _rel(TF.interp1d_to_2d(ells, cls, tg, device="cpu").numpy(),
                    JF.interp1d_to_2d(ells, cls, jg)) <= RTOL_F32


def test_grf_synthesis(geoms, theories):
    jth, tth = theories
    jg, tg = geoms[0]
    ells = np.arange(int(jg.lmax()) + 2)
    ps = np.array(jth.uCl("TT", ells))
    # covsqrt in map_mul units, through eig_pow (1e-6 of the max)
    cs_t = tgrf.spec2flat(tg, ps, exp=0.5, device="cpu")
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
    mg = tgrf.MapGen(tg, ps[None, None], device="cpu")
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
    ch_t = tgrf.covsqrt_half(tg, ells, ps, device="cpu")
    ch_j = jgrf.covsqrt_half(jg, ells, ps)
    assert _rel(ch_t.numpy(), ch_j) <= RTOL_F32
    assert _rel(tgrf.rand_map_r_from_noise(h_t, tg, ch_t).numpy(),
                jgrf.rand_map_r(key, jg, ch_j)) <= 1e-5
    # generator draws: right shapes, Hermitian columns, unit variance
    gen = torch.Generator().manual_seed(0)
    h = tgrf.rand_hermitian_half(tg, gen, batch=(4,), device="cpu")
    assert h.shape == (4,) + shape and h.dtype == torch.complex64
    col = h[..., 0]
    np.testing.assert_allclose(col.numpy(),
                               torch.roll(torch.flip(col, (-1,)), 1, -1)
                               .conj().resolve_conj().numpy(), atol=1e-6)
    assert abs(float((h.abs() ** 2).mean()) - 1.0) < 0.05
    m = tgrf.rand_map(tg, cs_t, gen, batch=(2,))
    assert m.shape == (2,) + tg.shape and torch.isfinite(m).all()


# the modules of the first slices (the main path, the SHT and the rest of
# the flat-sky lensing chain)
_CORE_MODULES = ("geometry", "models.theory", "models.grf", "models.fastcl",
                 "models.noise", "models.lensing", "models.qe",
                 "models.lenspipe", "models.ilc", "models.foregrounds",
                 "models.curved", "ops.fourier", "ops.binning",
                 "ops.windows", "ops.alm", "ops.sht")
# the modules of the flat-sky stacking slice, the distributed layer and the
# galaxy-catalog slice with its host modules, by their path in both
# packages
_SLICE_MODULES = ("ops.distance", "ops.matfft", "ops.algorithms",
                  "models.lensed_cls", "models.cosmology", "models.rsd",
                  "models.szhalo", "models.nfwfit", "models.pixcov",
                  "models.splits", "models.splitlens",
                  "parallel.statistics", "parallel.runtime",
                  "parallel.fourier", "parallel.sht", "utils.fitting",
                  "utils.profiling", "models.catalogs", "utils.plot",
                  "utils.io", "utils.fitsio", "models.curved_qe")


@pytest.mark.parametrize("path", _CORE_MODULES + _SLICE_MODULES)
def test_slice_names_resolve(path):
    """Every name in the ``__all__`` of the JAX module resolves in the
    port's module of the same path, and every public function or class of
    the JAX module does too, and every public constant (an upper-case
    module attribute that is a tuple, str, int or float) with its value."""
    import importlib
    import inspect
    jmod = importlib.import_module("orphics_tpu." + path)
    tmod = importlib.import_module("orphics_tpu_torch." + path)
    public = {n for n, v in vars(jmod).items()
              if not n.startswith("_") and (inspect.isfunction(v)
                                            or inspect.isclass(v))
              and getattr(v, "__module__", "") == jmod.__name__}
    consts = {n for n, v in vars(jmod).items()
              if n.isupper() and not n.startswith("_")
              and isinstance(v, (tuple, str, int, float))}
    missing = sorted(n for n in set(getattr(jmod, "__all__", ())) | public
                     | consts if not hasattr(tmod, n))
    assert not missing, missing
    assert set(getattr(tmod, "__all__", ())) >= set(getattr(jmod, "__all__",
                                                             ()))
    for n in consts:
        jv, tv = getattr(jmod, n), getattr(tmod, n)
        if n == "DATA_DIR":
            # a path: the port reads the JAX package's data directory
            assert os.path.samefile(tv, jv), n
        else:
            assert tv == jv, n


# the JAX modules that define a class the port also has, by their path in
# both packages (test_class_method_modules_are_listed keeps this whole)
_CLASS_MODULES = ("geometry", "interfaces", "maps", "models.catalogs",
                  "models.cosmology", "models.curved", "models.curved_qe",
                  "models.fastcl",
                  "models.grf", "models.lensing", "models.lenspipe",
                  "models.mapstools", "models.qe", "models.shear",
                  "models.splitlens", "models.szhalo", "models.theory",
                  "mpi", "ops.binning", "ops.sht", "parallel.statistics",
                  "utils.fitting", "utils.io", "utils.plot")
# JAX pytree plumbing, which the port has no use for
_UNPORTED_METHODS = {"tree_flatten", "tree_unflatten"}


def _ported_classes(path):
    """``(name, JAX class, port class)`` for every public class that the
    JAX module ``path`` defines and the port's module of that path has."""
    import importlib
    import inspect
    jmod = importlib.import_module("orphics_tpu." + path)
    try:
        tmod = importlib.import_module("orphics_tpu_torch." + path)
    except ImportError:
        return []
    return [(n, c, getattr(tmod, n)) for n, c in vars(jmod).items()
            if not n.startswith("_") and inspect.isclass(c)
            and c.__module__ == jmod.__name__
            and inspect.isclass(getattr(tmod, n, None))]


@pytest.mark.parametrize("path", _CLASS_MODULES)
def test_class_methods_resolve(path):
    """Every public method of a JAX class with a port counterpart resolves
    on the port's class, less the pytree plumbing."""
    classes = _ported_classes(path)
    assert classes, path
    missing = sorted(f"{n}.{m}" for n, jc, tc in classes for m in dir(jc)
                     if not m.startswith("_") and m not in _UNPORTED_METHODS
                     and callable(getattr(jc, m, None))
                     and not hasattr(tc, m))
    assert not missing, missing


def test_class_method_modules_are_listed():
    """``_CLASS_MODULES`` names every JAX module (but the Pallas kernels')
    that defines a class the port has."""
    import pkgutil
    import orphics_tpu
    found = set()
    for m in pkgutil.walk_packages(orphics_tpu.__path__, "orphics_tpu."):
        leaf = m.name.rsplit(".", 1)[-1]
        if leaf.startswith("pallas_"):
            continue
        path = m.name[len("orphics_tpu."):]
        if _ported_classes(path):
            found.add(path)
    assert found == set(_CLASS_MODULES), sorted(found ^ set(_CLASS_MODULES))


def test_eig_pow_symmetrizes_as_jax():
    """``eig_pow`` of a matrix that is not quite symmetric (an ILC
    covariance whose foregrounds take per-band flux limits) equals the JAX
    function's, which symmetrizes it in ``jnp.linalg.eigh``: 1e-10 of the
    max in float64; a symmetric input is unchanged by the symmetrization,
    bit for bit."""
    rng = np.random.default_rng(7)
    a = rng.standard_normal((4, 5, 5))
    sym = a @ np.swapaxes(a, -1, -2) + np.eye(5)
    skew = sym + 0.05 * rng.standard_normal((4, 5, 5))
    for exp in (-1.0, 0.5):                 # the conftest sets x64
        want = np.asarray(jgrf.eig_pow(jnp.asarray(skew), exp))
        assert want.dtype == np.float64
        got = tgrf.eig_pow(torch.as_tensor(skew), exp).numpy()
        assert _rel(got, want) <= 1e-10, exp
    s_t = torch.as_tensor(sym)
    assert torch.equal((s_t + s_t.transpose(-2, -1)) / 2, s_t)


def test_mapgen_get_maps_matches_jax(geoms, theories):
    """``MapGen.get_maps``: the JAX method's maps from its keys' own white
    noise through the port's ``get_map_from_noise`` (1e-5 of the max, fp32
    FFTs of a GRF), and the port's method equals its ``get_map``
    composition for equally seeded generators (exactly)."""
    jth, _ = theories
    jg, tg = geoms[0]
    ells = np.arange(int(jg.lmax()) + 2)
    ps = np.array(jth.uCl("TT", ells))[None, None]
    jm = jgrf.MapGen(jg, ps)
    tm = tgrf.MapGen(tg, ps, device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(11), 3)
    want = np.asarray(jm.get_maps(keys))
    eta = torch.stack([torch.as_tensor(np.array(
        jgrf.rand_kmap(k, jg, 1, dtype=jnp.float32))) for k in keys])
    got = tm.get_map_from_noise(eta)
    assert got.shape == want.shape
    assert _rel(got.numpy(), want) <= 1e-5
    gens = lambda: [torch.Generator().manual_seed(s) for s in (3, 4, 5)]
    maps = tm.get_maps(gens())
    assert maps.shape == (3,) + tg.shape
    assert torch.equal(maps, torch.stack([tm.get_map(g) for g in gens()]))
    eta2 = torch.stack([tgrf.rand_kmap(tg, g, 1, device="cpu")
                        for g in gens()])
    assert torch.equal(maps, tm.get_map_from_noise(eta2))
    k = tm.get_maps(gens(), harm=True)
    assert k.shape == (3, 1) + tg.shape and k.is_complex()


def test_slice_gated_functions_raise(tmp_path):
    """No function of the slice is gated any more: mass_estimate, gated on
    item 13b until the map-tools slice, runs, and the plot_file of
    fk_comparison, pk_comparison and eig_analyze, gated on utils/plot
    (item 21) until the galaxy-catalog slice, writes its plot."""
    from orphics_tpu_torch.models import cosmology as tcos, nfwfit as tnfw
    from orphics_tpu_torch.utils import fitting as tfit
    g = tp.rect_geometry(width_arcmin=16 * 2.0, px_res_arcmin=2.0)
    kap = tnfw.nfw_kappa(2e14, g.modrmap_np(), tcos.Cosmology(),
                         device="cpu")
    m, v = tnfw.mass_estimate(kap, np.ones(g.shape), g, 2e14, 3.2, 0.7,
                              niter=1)
    assert m == pytest.approx(2e14, rel=1e-6) and v > 0
    for name in ("fk_comparison", "pk_comparison"):
        out = tmp_path / f"{name}.png"
        ks, ratio = getattr(tcos, name)("H0", 0.5, 67.0, 70.0,
                                        ks=np.array([0.01, 0.1]),
                                        plot_file=str(out))
        assert ratio.shape == (2,) and out.stat().st_size > 0
    es = tfit.eig_analyze(np.eye(2)[:, :, None, None] * np.ones((2, 2, 3, 3)))
    assert es.shape == (3, 3, 2)
    out = tmp_path / "eig.png"
    tfit.eig_analyze(np.eye(2)[:, :, None, None] * np.ones((2, 2, 3, 3)),
                     plot_file=str(out))
    assert out.stat().st_size > 0


def test_port_imports_no_jax():
    """The port runs without jax: importing its modules loads none."""
    code = ("import sys\n"
            "import orphics_tpu_torch, orphics_tpu_torch.models.lenspipe, "
            "orphics_tpu_torch.models.qe, orphics_tpu_torch.ops.dft, "
            "orphics_tpu_torch.ops.mirror, orphics_tpu_torch.ops.noise_planes, "
            "orphics_tpu_torch.ops.rowpower, orphics_tpu_torch.models.fastcl, "
            "orphics_tpu_torch.ops.rowcombine, orphics_tpu_torch.ops.windows, "
            "orphics_tpu_torch.models.ilc, "
            "orphics_tpu_torch.models.foregrounds, "
            "orphics_tpu_torch.ops.alm, orphics_tpu_torch.ops.sht, "
            "orphics_tpu_torch.ops.legendre, orphics_tpu_torch.models.noise, "
            "orphics_tpu_torch.models.curved, "
            "orphics_tpu_torch.models.mapstools, "
            "orphics_tpu_torch.models.shear, "
            "orphics_tpu_torch.utils.healpix, orphics_tpu_torch.maps, "
            "orphics_tpu_torch.lensing, orphics_tpu_torch.pixcov, "
            "orphics_tpu_torch.foregrounds, orphics_tpu_torch.algorithms, "
            "orphics_tpu_torch.cosmology, "
            "orphics_tpu_torch.entry, orphics_tpu_torch.convert, "
            + ", ".join("orphics_tpu_torch." + m
                        for m in _CORE_MODULES + _SLICE_MODULES)
            + ", orphics_tpu_torch.parallel, orphics_tpu_torch.mpi, "
            "orphics_tpu_torch.ops, orphics_tpu_torch.models, "
            "orphics_tpu_torch.utils, orphics_tpu_torch.stats, "
            "orphics_tpu_torch.io, orphics_tpu_torch.catalogs, "
            "orphics_tpu_torch.time, orphics_tpu_torch.time_utils, "
            "orphics_tpu_torch.ephem, orphics_tpu_torch.interfaces\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'orphics_tpu.')) or "
            "m == 'orphics_tpu')\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


_EDGES = np.arange(100, 2000, 200.0)
_NO_DEVICE = {
    "FastCl": lambda g, th: tfastcl.FastCl(g, bin_edges=_EDGES),
    "LensedQEPipeline": lambda g, th: tpipe.LensedQEPipeline(g, th),
    "QEPipelineStep": lambda g, th: tentry.build_qe_pipeline(g, th),
    "entry": lambda g, th: tentry.entry(),
    "MapGen": lambda g, th: tgrf.MapGen(g, np.ones(100)[None, None]),
    "Bin2D": lambda g, th: tbinning.Bin2D(g.modlmap_np(), _EDGES),
    "spec2flat": lambda g, th: tgrf.spec2flat(g, np.ones(100)),
    "mask_kspace": lambda g, th: TF.mask_kspace(g, lmin=100),
    "get_taper": lambda g, th: twindows.get_taper(g),
    "modlmap": lambda g, th: g.modlmap(),
    "pixsizemap": lambda g, th: g.pixsizemap(),
    "synalm": lambda g, th: talm.synalm(torch.Generator(), np.ones(9)),
    "curved.rand_map": lambda g, th: tcurved.rand_map(
        torch.Generator(), tsht.gauss_legendre_rings(8), np.ones(9), 8),
    "curved.galactic_mask_rings": lambda g, th: tcurved.galactic_mask_rings(
        tsht.gauss_legendre_rings(8), 1.0, 2.0),
    "noise.ivar": lambda g, th: tnoise.ivar(g, 10.0),
    "noise.atm_factor": lambda g, th: tnoise.atm_factor(np.arange(9), 100.0,
                                                        -3.0),
    "noise.rednoise": lambda g, th: tnoise.rednoise(np.arange(9), 10.0),
    "noise.noise_func": lambda g, th: tnoise.noise_func(np.arange(9), 1.4,
                                                        10.0),
    "noise.white_noise_with_atm_func": lambda g, th:
        tnoise.white_noise_with_atm_func(np.arange(9), 6.0, 100.0, -3.0),
    "curved.cosine_taper_ells": lambda g, th: tcurved.cosine_taper_ells(
        np.arange(9), 4, 2),
    "posmap": lambda g, th: g.posmap(),
    "modrmap": lambda g, th: g.modrmap(),
    "pixmap": lambda g, th: g.pixmap(),
    "yaxis": lambda g, th: g.yaxis(),
    "queb_rotmat": lambda g, th: TF.queb_rotmat(g),
    "cl2flat": lambda g, th: tgrf.cl2flat(g, np.arange(9), np.ones(9)),
    "white_noise": lambda g, th: tgrf.white_noise(g, 6.0, torch.Generator()),
    "FlatLensingSims": lambda g, th: tlensing.FlatLensingSims(g, th, 1.4, 6.0,
                                                              pol=True),
    "FixedLens": lambda g, th: tlensing.FixedLens(g, th, np.zeros(g.shape)),
    "NlGenerator": lambda g, th: tqe.NlGenerator(g, th, _EDGES),
    "gnfw": lambda g, th: tlensing.gnfw(np.linspace(0.1, 3.0, 9)),
    "proj_rho_nfw": lambda g, th: tlensing.proj_rho_nfw(
        np.linspace(1e-4, 1e-3, 9), 1500.0, 2e14, 3.2, 1.5),
    "projected_rho": lambda g, th: tlensing.projected_rho(
        np.linspace(1e-4, 1e-3, 9), 1500.0, tlensing.rho_nfw(2e14, 3.2, 1.5),
        nps=401),
    "kappa_nfw_generic": lambda g, th: tlensing.kappa_nfw_generic(
        np.linspace(1e-4, 1e-3, 9), 0.7, 1500.0, 2e14, 3.2, 1.5, 0.4),
    "kappa_generic": lambda g, th: tlensing.kappa_generic(
        1e-4, 0.7, 1500.0, tlensing.rho_nfw(2e14, 3.2, 1.5), 0.4, nps=401),
    "nfw_kappa_profile": lambda g, th: tlensing.nfw_kappa_profile(
        g.modrmap_np(), 2e14, 1200.0, 0.35, 0.6, rdel_mpc_overh=1.2),
    "distance_transform": lambda g, th: tdistance.distance_transform(
        np.eye(4, dtype=bool)),
    "grow_mask": lambda g, th: tdistance.grow_mask(np.ones(g.shape), g, 1e-3),
    "mask_srcs": lambda g, th: tdistance.mask_srcs(g, [[1, 1]], 1e-3),
    "vectorized_bisection_search": lambda g, th:
        talgorithms.vectorized_bisection_search(
            np.ones(3), lambda y: y, (0.0, 2.0), "increasing"),
    "LimberCosmology": lambda g, th: tcosmology.LimberCosmology(numz=20),
    "get_lensed_cls": lambda g, th: tcosmology.get_lensed_cls(
        np.arange(100.0), np.ones(100), np.ones(100), npix=64),
    "Pgg_Pvv_Pgv": lambda g, th: trsd.Pgg_Pvv_Pgv(
        np.array([0.1]), np.array([0.5]), 0.5),
    "nfw_kappa": lambda g, th: tnfwfit.nfw_kappa(
        2e14, g.modrmap_np(), tcosmology.Cosmology()),
    "binned_nfw": lambda g, th: tnfwfit.binned_nfw(
        2e14, 0.5, 3.2, tcosmology.Cosmology(), g, np.arange(0, 8.0)),
    "kappa_nfw_profiley": lambda g, th: tnfwfit.kappa_nfw_profiley(g),
    "get_mesh": lambda g, th: tparallel.get_mesh(),
    "SuffStats.zeros": lambda g, th: tparallel.SuffStats.zeros(3),
    "Statistics.add": lambda g, th: tparallel.Statistics().add(
        "x", np.ones((2, 3))),
    "ensemble_stats": lambda g, th: tparallel.ensemble_stats(
        lambda gen: {"x": torch.ones(2)}, 4),
    "task_generator": lambda g, th: tparallel.runtime.task_generator(0, 1),
    "InverseTransformSampling": lambda g, th:
        tfitting.InverseTransformSampling(np.arange(4.0), np.ones(4)),
    "lens_cov": lambda g, th: tnfwfit.lens_cov(
        np.eye(16), np.zeros((2, 4, 4)), tp.rect_geometry(
            width_arcmin=8.0, px_res_arcmin=2.0)),
    "scov_from_theory": lambda g, th: tpixcov.scov_from_theory(
        tp.Geometry(4, 4, 1e-3, 1e-3), th, ncomp=1),
    "extract_stamps": lambda g, th: tpixcov.extract_stamps(
        np.zeros((16, 16)), [[8, 8]], 4),
    "noise_from_splits": lambda g, th: tsplits.noise_from_splits(
        np.zeros((2, 1) + g.shape), g),
    "Purify": lambda g, th: tmapstools.Purify(g, np.ones(g.shape)),
    "MatchedFilter": lambda g, th: tmapstools.MatchedFilter(
        g, np.ones(g.shape)),
    "FourierStack": lambda g, th: tmapstools.FourierStack(g, _EDGES),
    "mapstools.MapRotator": lambda g, th: tmapstools.MapRotator(g, g),
    "curved.MapRotator": lambda g, th: tcurved.MapRotator(g, g),
    "MapRotatorEquator": lambda g, th: tcurved.MapRotatorEquator(
        g, (0.0, 0.0), 1.0, 1.0),
    "mapstools.galactic_mask": lambda g, th: tmapstools.galactic_mask(
        g, 8, 1.0, 2.0),
    "healpix.map2alm": lambda g, th: thealpix.map2alm(np.zeros(12 * 16), 8),
    "inpaint_cg": lambda g, th: tmapstools.inpaint_cg(
        np.zeros(g.shape), np.zeros(g.shape), np.ones(g.shape),
        np.ones(g.shape), g),
    "get_normalized_center": lambda g, th: tmapstools.get_normalized_center(
        g),
    "gauss_kern": lambda g, th: tmapstools.gauss_kern(1.0, 1.0),
    "ncov": lambda g, th: tmapstools.ncov(tp.Geometry(4, 4, 1e-3, 1e-3),
                                          10.0),
    "get_rotated_pixels": lambda g, th: tcurved.get_rotated_pixels(g, g),
    "binned_map": lambda g, th: tcatalogs.binned_map(np.zeros(3),
                                                     np.zeros(3), g),
    "healpix_binned_map": lambda g, th: tcatalogs.healpix_binned_map(
        np.zeros(3), np.zeros(3), 4),
    "CatMapper": lambda g, th: tcatalogs.CatMapper(np.zeros(3), np.zeros(3),
                                                   geom=g),
    "get_delta": lambda g, th: tcatalogs.get_delta(np.ones(g.shape)),
    "random_catalog_flat": lambda g, th: tcatalogs.random_catalog_flat(
        torch.Generator(), g, 10),
    "get_random_catalog": lambda g, th: tcatalogs.get_random_catalog(
        torch.Generator(), 10),
    "Pow2Cat": lambda g, th: tcatalogs.Pow2Cat(
        g, np.arange(100), np.ones(100), np.ones(100), np.ones(100), 1.0),
    "reconstruct_velocities": lambda g, th: tcatalogs.reconstruct_velocities(
        np.zeros(4), np.zeros(4), np.full(4, 0.5), np.zeros(4), np.zeros(4),
        np.full(4, 0.5), nmesh=4),
}


@pytest.mark.parametrize("name", sorted(_NO_DEVICE))
def test_entry_points_default_to_the_card(name, theories):
    """Called with no ``device``, a constructor or factory puts its tensors
    on the card; where CUDA is not available it raises and names
    ``device="cpu"`` instead of running on the CPU."""
    g = tp.rect_geometry(width_arcmin=256 * 2.0, px_res_arcmin=2.0)
    assert resolve("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve(None) == torch.device("cuda")
        return
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _NO_DEVICE[name](g, theories[1])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        resolve("cuda:0")
