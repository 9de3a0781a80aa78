"""Parity of the port's ``models/pixcov`` with the JAX package: stamp
covariances, the inpainting geometry, the batched fill (shared and
per-stamp geometries), the cutout plumbing, the end-to-end inpaint, the
saved-geometry format and the reference-surface tail; bench config 5's
step body (stamps -> shared-geometry fill -> Bin2D profiles -> chi^2
over NFW templates -> argmin) on 16 stamps of 32^2 against the JAX step on
the same injected noise and geometry; and the conditional-variance
identity of ``tests/test_pixcov.py`` on the port's own draws.

Tolerances: float64 covariances and geometries through LAPACK on both
sides (inversions of matrices with condition numbers ~1e6): 1e-8
relative, except where the polarized covariances carry the TEB -> IQU
rotation, which each side forms in float32 from its own float32 l-plane
and angles (they differ by ulps): 1e-6 there; float32 stamps and fills:
1e-5 of the max (the float32 map path); chi^2: 1e-4 relative; the identity: the mean ratio within 0.05 of
1, as in the JAX test.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from orphics_tpu import geometry as jgeo
from orphics_tpu.geometry import arcmin
from orphics_tpu.ops import fourier as JF
from orphics_tpu.ops.binning import Bin2D as JBin2D
from orphics_tpu.models import cosmology as JC, grf as JG, nfwfit as JNF
from orphics_tpu.models import pixcov as JP, theory as JT

import orphics_tpu_torch as tp
from orphics_tpu_torch import convert
from orphics_tpu_torch.ops.binning import Bin2D as TBin2D
from orphics_tpu_torch.models import cosmology as TC, grf as TG
from orphics_tpu_torch.models import nfwfit as TNF, pixcov as TP
from orphics_tpu_torch.models import theory as TT

torch.set_num_threads(1)

RTOL_F64 = 1e-8
RTOL_ROT = 1e-6
RTOL_F32 = 1e-5
RTOL_CHI2 = 1e-4


def _rel(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


def beam_fn(ell):
    return JF.gauss_beam(ell, 1.4)


@pytest.fixture(scope="module")
def theories():
    return JT.default_theory(), TT.default_theory()


@pytest.fixture(scope="module")
def stamp16(theories):
    """16^2 stamps at 2': the signal covariances (1 and 3 components),
    a 5' hole, the noisy pixel covariance and its geometry, both sides."""
    jth, tth = theories
    n, res = 16, 2.0
    jg = jgeo.Geometry(n, n, res * arcmin, res * arcmin)
    tg = tp.Geometry(n, n, res * arcmin, res * arcmin)
    s1 = (JP.scov_from_theory(jg, jth, beam_fn, ncomp=1),
          TP.scov_from_theory(tg, tth, beam_fn, ncomp=1, device="cpu"))
    s3 = (JP.scov_from_theory(jg, jth, beam_fn, ncomp=3),
          TP.scov_from_theory(tg, tth, beam_fn, ncomp=3, device="cpu"))
    m1, m2 = JP.get_geometry_regions(1, n, res * arcmin, 5 * arcmin)
    nvar = (10 * arcmin) ** 2 / (jg.dy * jg.dx)
    pj = jnp.asarray(s1[0]) + nvar * jnp.eye(n * n)
    pt = s1[1] + nvar * torch.eye(n * n, dtype=torch.float64)
    return dict(jg=jg, tg=tg, s1=s1, s3=s3, m1=m1, m2=m2, nvar=nvar,
                pcov=(pj, pt))


def test_stamp_covariances(stamp16):
    s1, s3 = stamp16["s1"], stamp16["s3"]
    assert s1[1].dtype == torch.float64 and tuple(s1[1].shape) == (256, 256)
    assert _rel(s1[1], s1[0]) <= RTOL_F64
    # the TEB -> IQU rotation is formed in float32 on both sides
    assert _rel(s3[1], s3[0]) <= RTOL_ROT
    jg, tg = stamp16["jg"], stamp16["tg"]
    p2 = np.abs(np.random.default_rng(0).standard_normal((3, 3, 16, 16)))
    p2 = p2 + np.swapaxes(p2, 0, 1)
    a = TP.stamp_pixcov_from_theory(tg, torch.as_tensor(p2), n2d_IQU=0.1,
                                    beam2d=np.ones((16, 16)) * 0.9)
    b = JP.stamp_pixcov_from_theory(jg, p2, n2d_IQU=0.1,
                                    beam2d=np.ones((16, 16)) * 0.9)
    assert _rel(a, b) <= RTOL_ROT
    assert _rel(TP.ps2d_to_mat(p2[0, 0], tg, device="cpu"),
                JP.ps2d_to_mat(p2[0, 0], jg)) <= RTOL_F64


@pytest.mark.parametrize("deproject", [True, False])
def test_make_geometry(stamp16, deproject):
    pj, pt = stamp16["pcov"]
    m1, m2 = stamp16["m1"], stamp16["m2"]
    cj, mj = JP.make_geometry(pj, jnp.asarray(m1), jnp.asarray(m2),
                              deproject=deproject, ncomp=1)
    ct, mt = TP.make_geometry(pt, m1, m2, deproject=deproject, ncomp=1)
    assert tuple(mt.shape) == (len(m1), len(m2)) and mt.dtype == torch.float64
    assert _rel(ct, cj) <= RTOL_F64 and _rel(mt, mj) <= RTOL_F64


def test_make_geometries_batched(stamp16):
    s3 = stamp16["s3"]
    m1, m2 = JP.get_geometry_regions(3, 16, 2 * arcmin, 5 * arcmin)
    iv = np.random.default_rng(1).uniform(0.5, 2.0, (3, 16, 16)) \
        / stamp16["nvar"]
    iv[1, 0, :4] = 0.0
    cj, mj = JP.make_geometries_batched(jnp.asarray(s3[0]), jnp.asarray(iv),
                                        m1, m2)
    ct, mt = TP.make_geometries_batched(s3[1], torch.as_tensor(iv), m1, m2)
    assert tuple(ct.shape) == (3, len(m1), len(m1))
    assert _rel(ct, cj) <= RTOL_ROT and _rel(mt, mj) <= RTOL_ROT
    assert _rel(TP.ncov_ivar_diag(torch.as_tensor(iv[1])),
                JP.ncov_ivar_diag(iv[1])) <= 1e-15


@pytest.mark.parametrize("layout", ["shared", "expanded", "per-stamp"])
def test_inpaint_stamps_batched(stamp16, layout):
    pj, pt = stamp16["pcov"]
    m1, m2 = stamp16["m1"], stamp16["m2"]
    cj, mj = JP.make_geometry(pj, jnp.asarray(m1), jnp.asarray(m2), ncomp=1)
    ct, mt = TP.make_geometry(pt, m1, m2, ncomp=1)
    B = 5
    st = np.random.default_rng(2).standard_normal((B, 1, 16, 16)) \
        .astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    r = np.stack([np.asarray(jax.random.normal(k, (len(m1),), jnp.float32))
                  for k in keys])
    bc = lambda a: jnp.broadcast_to(a, (B,) + a.shape)
    if layout == "shared":
        c, m = ct, mt
    elif layout == "expanded":
        c, m = ct.expand((B,) + ct.shape), mt.expand((B,) + mt.shape)
    else:
        c, m = ct[None].repeat(B, 1, 1), mt[None].repeat(B, 1, 1)
    for noise, jkeys in ((None, None), (r, keys)):
        want = JP.inpaint_stamps_batched(jnp.asarray(st), bc(cj), bc(mj),
                                         m1, m2, jkeys)
        got = TP.inpaint_stamps_batched(
            torch.as_tensor(st), c, m, m1, m2,
            noise=None if noise is None else torch.as_tensor(noise))
        assert got.dtype == torch.float32 and _rel(got, want) <= RTOL_F32
    one = TP.inpaint_stamp(torch.as_tensor(st[0]), ct, mt, m1, m2,
                           noise=torch.as_tensor(r[0]))
    assert _rel(one, JP.inpaint_stamp(jnp.asarray(st[0]), cj, mj, m1, m2,
                                      keys[0])) <= RTOL_F32
    # generator draws: the right law (unit normals through covsqrt)
    g = torch.Generator().manual_seed(3)
    d = TP.inpaint_stamps_batched(torch.as_tensor(st), ct, mt, m1, m2,
                                  generator=g)
    flat = d.reshape(B, -1)[:, torch.as_tensor(m1)]
    assert torch.isfinite(flat).all()


class _LargestOutput(TorchDispatchMode):
    """Records the element count of the largest tensor any op creates."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.largest = max(self.largest, t.numel())
        return out


def test_shared_meanmul_is_never_copied(stamp16):
    """A meanmul broadcast to (B, nh, nc) with stride 0 is read as the one
    shared (nh, nc) matrix: no op creates a tensor of B * nh * nc
    elements (bench config 5 would need 47.8 GB for it)."""
    pt = stamp16["pcov"][1]
    m1, m2 = stamp16["m1"], stamp16["m2"]
    ct, mt = TP.make_geometry(pt, m1, m2, ncomp=1)
    B = 64
    st = torch.randn((B, 1, 16, 16), generator=torch.Generator()
                     .manual_seed(4))
    mm = mt.to(torch.float32).expand((B,) + mt.shape)
    cs = ct.to(torch.float32).expand((B,) + ct.shape)
    assert mm.stride(0) == 0
    with _LargestOutput() as rec:
        out = TP.inpaint_stamps_batched(st, cs, mm, m1, m2,
                                        noise=torch.zeros(B, len(m1)))
    assert rec.largest < B * len(m1) * len(m2)
    assert rec.largest <= max(st.numel(), len(m1) * len(m2))
    assert torch.equal(out, TP.inpaint_stamps_batched(
        st, cs[0], mm[0], m1, m2, noise=torch.zeros(B, len(m1))))


def test_stamps_extract_insert_inpaint(theories):
    jth, tth = theories
    rng = np.random.default_rng(5)
    big = rng.standard_normal((2, 64, 64))
    pix = np.array([[10, 12], [60, 30], [1, 1]])
    ej = JP.extract_stamps(big, pix, 8)
    et = TP.extract_stamps(torch.as_tensor(big), pix, 8)
    assert tuple(et.shape) == (3, 2, 8, 8)
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
    np.testing.assert_array_equal(
        TP.insert_stamps(torch.as_tensor(big), et * 2, pix, 8).numpy(),
        np.asarray(JP.insert_stamps(big, np.asarray(ej) * 2, pix, 8)))
    kw = dict(width_arcmin=96 * 2.0, px_res_arcmin=2.0)
    G, Gt = jgeo.rect_geometry(**kw), tp.rect_geometry(**kw)
    mp = rng.standard_normal((96, 96))
    coords = np.array([[30, 30], [50, 60], [5, 5]])
    with pytest.warns(UserWarning, match="skipping 1/3"):
        want = JP.inpaint(mp, coords, G, jth, beam_fn, noise_uk_arcmin=10.0,
                          hole_radius_arcmin=4.0, npix_context=16)
    with pytest.warns(UserWarning, match="skipping 1/3"):
        got = TP.inpaint(torch.as_tensor(mp), coords, Gt, tth, beam_fn,
                         noise_uk_arcmin=10.0, hole_radius_arcmin=4.0,
                         npix_context=16)
    assert _rel(got, want) <= RTOL_F64
    assert not np.array_equal(got.numpy(), mp)


def test_geometry_files_and_convert(stamp16, tmp_path):
    s3 = stamp16["s3"]
    m1, m2 = JP.get_geometry_regions(3, 16, 2 * arcmin, 5 * arcmin)
    iv = np.full((2, 16, 16), 1.0 / stamp16["nvar"])
    cj, mj = JP.make_geometries_batched(jnp.asarray(s3[0]), jnp.asarray(iv),
                                        m1, m2)
    fn = str(tmp_path / "geo.npz")
    JP.save_geometries(fn, cj, mj, m1, m2)
    c, m, a, b = TP.load_geometries(fn, device="cpu")
    np.testing.assert_array_equal(c.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(m.numpy(), np.asarray(mj))
    np.testing.assert_array_equal(a, m1)
    pre = TP.preload_geometries([fn, fn], device="cpu")
    assert sorted(pre) == [0, 1]
    # the port's file is the JAX package's format
    fn2 = str(tmp_path / "geo2.npz")
    TP.save_geometries(fn2, c, m, a, b)
    c2, m2_, a2, b2 = JP.load_geometries(fn2)
    np.testing.assert_array_equal(np.asarray(c2), np.asarray(cj))
    # convert: a file, a dict and a tuple of the JAX arrays
    for src in (fn, dict(covsqrt=np.asarray(cj), meanmul=np.asarray(mj),
                         m1=m1, m2=m2),
                (np.asarray(cj[0]), np.asarray(mj[0]), m1, m2)):
        c3, m3, a3, b3 = convert.load_pixcov_geometry(src, device="cpu")
        assert c3.dtype == torch.float64 and a3.dtype == np.int64
        np.testing.assert_array_equal(
            m3.numpy(), np.asarray(mj)[(0,) * (3 - m3.ndim)])
    with pytest.raises(ValueError):
        convert.load_pixcov_geometry((np.asarray(cj), np.asarray(mj), m2,
                                      m1), device="cpu")


def test_reference_tail(stamp16, theories):
    jth, _ = theories
    jg, tg = stamp16["jg"], stamp16["tg"]
    rng = np.random.default_rng(6)
    x = rng.standard_normal((20, 20))
    G = jgeo.rect_geometry(width_arcmin=20 * 2.0, px_res_arcmin=2.0)
    assert _rel(TP.map_ifft(torch.as_tensor(x)), JP.map_ifft(x)) <= 1e-14
    assert _rel(TP.corrfun_thumb(torch.as_tensor(x), 4, 3),
                JP.corrfun_thumb(x, 4, 3)) == 0
    assert _rel(TP.corr_to_mat(torch.as_tensor(x[:8, :6]), 4, 3),
                JP.corr_to_mat(x[:8, :6], 4, 3)) == 0
    p2 = rng.standard_normal((2, 2, 20, 20))
    assert _rel(TP.fcov_to_rcorr(G, torch.as_tensor(p2), 5, 4),
                JP.fcov_to_rcorr(G, p2, 5, 4)) <= 1e-14
    ivm = rng.uniform(0.0, 2.0, (6, 6))
    ivm[0, 0] = 0.0
    np.testing.assert_array_equal(
        TP.ncov_from_ivar(torch.as_tensor(ivm)).numpy(),
        np.asarray(JP.ncov_from_ivar(ivm)))
    assert TP.resolution(tg) == JP.resolution(jg)
    for a, b in zip(TP.get_regions(3, tg.modrmap_np(), 4 * arcmin),
                    JP.get_regions(3, jg.modrmap_np(), 4 * arcmin)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        TP.paste(torch.as_tensor(x[:4, :4]), [1, 5], [7.0, 8.0]).numpy(),
        np.asarray(JP.paste(x[:4, :4], [1, 5], [7.0, 8.0])))
    tf = lambda s, l: np.interp(l, np.arange(9001.0),
                                jth.lCl(s, np.arange(9001.0)))
    g6 = (jgeo.Geometry(6, 6, arcmin, arcmin), tp.Geometry(6, 6, arcmin,
                                                           arcmin))
    assert _rel(TP.pcov_from_ivar(6, ivm + 0.5, tf, beam_fn, g6[1],
                                  device="cpu"),
                JP.pcov_from_ivar(6, ivm + 0.5, tf, beam_fn, g6[0])) \
        <= RTOL_F64
    assert _rel(TP.tpcov_from_ivar(6, ivm + 0.5, tf, beam_fn, g6[1],
                                   device="cpu"),
                JP.tpcov_from_ivar(6, ivm + 0.5, tf, beam_fn, g6[0])) \
        <= RTOL_F64
    mask = np.zeros((16, 16), bool)
    mask[6:9, 6:9] = True
    cl = np.asarray(jth.lCl("TT", np.arange(9001.0))) + 1e-5
    st = rng.standard_normal((16, 16))
    got = TP.cinv_inpaint(torch.as_tensor(st), tg, mask=mask,
                          lpower_total=cl, add_noise=False)
    want = JP.cinv_inpaint(jnp.asarray(st), jg, mask=mask, lpower_total=cl,
                           add_noise=False)
    assert _rel(got, want) <= RTOL_F64


def _config5(n, nstamp):
    """Bench config 5's settings at an n^2 stamp (bench.py:594-624): 0.5'
    pixels, beam 1.4', 10 uK' white noise in pcov, a 5' hole, 16 NFW
    templates on profile edges arange(0, 10, 1)', cinv = 1e4 I."""
    res = 0.5
    jg = jgeo.Geometry(n, n, res * arcmin, res * arcmin)
    tg = tp.Geometry(n, n, res * arcmin, res * arcmin)
    jth, tth = JT.default_theory(), TT.default_theory()
    m1, m2 = JP.get_geometry_regions(1, n, res * arcmin, 5.0 * arcmin)
    nvar = (10.0 * arcmin) ** 2 / (jg.dy * jg.dx)
    scov_j = JP.scov_from_theory(jg, jth, beam_fn, ncomp=1)
    cs_j, mm_j = JP.make_geometry(jnp.asarray(scov_j)
                                  + nvar * jnp.eye(n * n),
                                  jnp.asarray(m1), jnp.asarray(m2), ncomp=1)
    scov_t = TP.scov_from_theory(tg, tth, beam_fn, ncomp=1, device="cpu")
    cs_t, mm_t = TP.make_geometry(
        scov_t + nvar * torch.eye(n * n, dtype=torch.float64), m1, m2,
        ncomp=1)
    masses = np.geomspace(5e13, 8e14, 16)
    redges = np.arange(0.0, 10.0, 1.0) * arcmin
    modr = jg.modrmap_np()
    jc, tc = JC.Cosmology(), TC.Cosmology()
    jbin, tbin = JBin2D(modr, redges), TBin2D(modr, redges, device="cpu")
    temps_j = jnp.asarray(np.asarray(
        [np.asarray(jbin.bin(JNF.nfw_kappa(m, jnp.asarray(modr), jc))[1])
         for m in masses]), jnp.float32)
    temps_t = torch.stack([tbin.bin(TNF.nfw_kappa(m, modr, tc, device="cpu")
                                    .to(torch.float32))[1] for m in masses])
    ells = np.arange(jth.lpad + 1)
    mgen_j = JG.MapGen(jg, np.asarray(jth.lCl("TT", ells))[None, None])
    mgen_t = TG.MapGen(tg, np.asarray(tth.lCl("TT", ells))[None, None],
                       device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(0), nstamp)
    eta = np.array(jax.vmap(lambda k: JG.rand_kmap(k, jg, 1))(keys))
    return dict(jg=jg, tg=tg, m1=m1, m2=m2, geo_j=(cs_j, mm_j),
                geo_t=(cs_t, mm_t), temps=(temps_j, temps_t),
                bins=(jbin, tbin), mgen=(mgen_j, mgen_t), keys=keys,
                eta=eta, nb=len(redges) - 1)


def test_config5_step_matches_jax():
    """Config 5's step body (bench.py:629-641) on 16 stamps of 32^2: the
    JAX step (its own draws) against the port's on the same noise."""
    c = _config5(32, 16)
    cs_j, mm_j = c["geo_j"]
    cs_t, mm_t = c["geo_t"]
    assert _rel(mm_t, mm_j) <= RTOL_F64 and _rel(cs_t, cs_j) <= RTOL_F64
    temps_j, temps_t = c["temps"]
    assert _rel(temps_t, temps_j) <= 1e-6
    nb = c["nb"]
    cinv_j = jnp.eye(nb, dtype=jnp.float32) * 1e4
    cinv_t = torch.eye(nb) * 1e4
    m1, m2 = c["m1"], c["m2"]

    # the JAX step of bench.py, keys -> argmin (with its intermediates)
    stamps_j = jax.vmap(c["mgen"][0].get_map)(c["keys"])[:, None]
    B = stamps_j.shape[0]
    filled_j = JP.inpaint_stamps_batched(
        stamps_j, jnp.broadcast_to(cs_j, (B,) + cs_j.shape),
        jnp.broadcast_to(mm_j, (B,) + mm_j.shape), jnp.asarray(m1),
        jnp.asarray(m2))
    _, prof_j = c["bins"][0].bin(filled_j[:, 0])
    diff = prof_j[:, None, :] - temps_j[None, :, :]
    chi2_j = jnp.einsum("bmi,ij,bmj->bm", diff, cinv_j, diff)
    best_j = np.asarray(jnp.argmin(chi2_j, axis=1))

    # the port's step on the same noise: a shared 2-D geometry
    stamps_t = c["mgen"][1].get_map_from_noise(
        torch.as_tensor(c["eta"]))[:, None]
    assert tuple(stamps_t.shape) == (16, 1, 32, 32)
    assert _rel(stamps_t, stamps_j) <= RTOL_F32
    filled_t = TP.inpaint_stamps_batched(stamps_t, cs_t, mm_t, m1, m2)
    _, prof_t = c["bins"][1].bin(filled_t[:, 0])
    d = prof_t[:, None, :] - temps_t[None, :, :]
    chi2_t = torch.einsum("bmi,ij,bmj->bm", d, cinv_t, d)
    best_t = chi2_t.argmin(dim=1).numpy()

    assert _rel(filled_t, filled_j) <= RTOL_F32
    assert _rel(prof_t, prof_j) <= RTOL_F32
    chi2_j = np.asarray(chi2_j)
    assert np.max(np.abs(chi2_t.numpy() - chi2_j) / chi2_j) <= RTOL_CHI2
    # argmin equal wherever the two smallest chi^2 are apart
    two = np.sort(chi2_j, axis=1)[:, :2]
    clear = (two[:, 1] - two[:, 0]) / two[:, 0] > 1e-3
    assert clear.sum() >= 4
    np.testing.assert_array_equal(best_t[clear], best_j[clear])


def test_conditional_variance_identity(theories):
    """The residual variance of the mean infill of the port's own draws
    (GRF + white noise, 3000 stamps of 16^2) equals
    diag(covsqrt covsqrt^T): the identity of tests/test_pixcov.py."""
    _, tth = theories
    n = 16
    tg = tp.Geometry(n, n, 2 * arcmin, 2 * arcmin)
    ells = np.arange(tth.lpad + 1)
    scov = TP.scov_from_theory(tg, tth, ncomp=1, device="cpu")
    noise_var = (10.0 * arcmin) ** 2 / tg.pixsize
    pcov = scov + noise_var * torch.eye(n * n, dtype=torch.float64)
    m1, m2 = TP.get_geometry_regions(1, n, 2 * arcmin, 6 * arcmin)
    covsqrt, meanmul = TP.make_geometry(pcov, m1, m2, deproject=False,
                                        ncomp=1)
    pred = torch.diagonal(covsqrt @ covsqrt.T).numpy()
    mgen = TG.MapGen(tg, np.asarray(tth.lCl("TT", ells))[None, None],
                     dtype=torch.float64, device="cpu")
    gen = torch.Generator().manual_seed(7)
    nsims = 3000
    m = mgen.get_map(gen, batch=(nsims,)) + torch.randn(
        (nsims, n, n), generator=gen, dtype=torch.float64) \
        * np.sqrt(noise_var)
    flat = m.reshape(nsims, -1)
    res = (flat[:, m1] - flat[:, m2] @ meanmul.T).numpy()
    ratio = res.var(axis=0, ddof=1) / pred
    assert abs(ratio.mean() - 1) < 0.05, ratio
    assert np.all(np.abs(ratio - 1) < 0.25), ratio
    err = res.std(axis=0) / np.sqrt(nsims)
    assert np.all(np.abs(res.mean(axis=0)) < 5 * err)
