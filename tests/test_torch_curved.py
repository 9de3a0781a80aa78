"""models/curved of the port against the JAX package on shared normals.

The JAX draws are reproduced from their own keys' normals and handed to
the port's ``*_from_noise`` twins. Bounds: 1e-12 of max|ref| in float64
(the same SHT sums in another order), 1e-6 in float32 (the JAX scan's
double-single float32 against the port's float64 loop on float32 data);
masks, which are 0/1, equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orphics_tpu import geometry as jgeo
from orphics_tpu.models import curved as JC
from orphics_tpu.models import grf as JG
from orphics_tpu.models.theory import default_theory
from orphics_tpu.ops import sht as jsht

import orphics_tpu_torch as tp
from orphics_tpu_torch.models import curved as TC
from orphics_tpu_torch.models import grf as TG
from orphics_tpu_torch.ops import alm as talm
from orphics_tpu_torch.ops import sht as tsht

torch.set_num_threads(1)

LMAX = 23
TOL64 = 1e-12
TOL32 = 1e-6


def _rel(got, ref):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def _unit_normals(key, shape_lead, n):
    """The normals JAX's ``synalm(key, ...)`` draws, for each key of
    ``jax.random.split(key, prod(shape_lead))``: (re, im) each
    ``shape_lead + (n,)``."""
    count = int(np.prod(shape_lead)) if shape_lead else 1
    keys = jax.random.split(key, count) if shape_lead else [key]
    re, im = [], []
    for k in keys:
        kr, ki = jax.random.split(k)
        re.append(np.asarray(jax.random.normal(kr, (n,))))
        im.append(np.asarray(jax.random.normal(ki, (n,))))
    shape = tuple(shape_lead) + (n,)
    return (torch.as_tensor(np.reshape(re, shape)),
            torch.as_tensor(np.reshape(im, shape)))


@pytest.fixture(scope="module")
def setup():
    th = default_theory()
    ps3 = JG.cmb_ps(th, lmax=LMAX)
    return dict(jr=jsht.gauss_legendre_rings(LMAX),
                tr=tsht.gauss_legendre_rings(LMAX), ps3=ps3, th=th,
                cl=np.asarray(th.lCl("TT", np.arange(LMAX + 1))))


def test_cmb_ps(setup):
    from orphics_tpu_torch.models.theory import default_theory as tdt
    np.testing.assert_allclose(TG.cmb_ps(tdt(), lmax=LMAX), setup["ps3"],
                               rtol=1e-12, atol=0)


def test_synalm_matrix_and_rand_map(setup):
    key = jax.random.PRNGKey(4)
    n = talm.nalm(LMAX)
    ps3 = setup["ps3"]
    re, im = _unit_normals(key, (3,), n)
    ref = JC.synalm_matrix(key, jnp.asarray(ps3), LMAX)
    got = TC.synalm_matrix_from_noise(re, im, ps3, LMAX)
    assert _rel(got, ref) <= TOL64
    # polarized map: T, Q, U from the same alms
    ref = JC.rand_map(key, setup["jr"], jnp.asarray(ps3), LMAX)
    got = TC.rand_map_from_noise(re, im, setup["tr"], ps3, LMAX)
    assert got.shape == (3,) + setup["tr"].shape and _rel(got, ref) <= TOL64
    # spin-0 ensemble: nsims keys, one synalm each
    cl = setup["cl"]
    ref = JC.rand_map(key, setup["jr"], jnp.asarray(cl), LMAX, nsims=2)
    re, im = _unit_normals(key, (2,), n)
    got = TC.rand_map_from_noise(re, im, setup["tr"], cl, LMAX)
    assert got.shape == (2,) + setup["tr"].shape and _rel(got, ref) <= TOL64
    with pytest.raises(ValueError):
        TC.rand_map(torch.Generator(), setup["tr"], cl, LMAX, pol=True,
                    device="cpu")


def test_generator_draws(setup):
    gen = torch.Generator().manual_seed(1)
    m = TC.rand_cmb_sim(gen, setup["tr"], LMAX, theory=setup["th"],
                        device="cpu")
    assert m.shape == (3,) + setup["tr"].shape and m.dtype == torch.float32
    assert torch.isfinite(m).all()
    ivar = torch.full(setup["tr"].shape, 4.0, dtype=torch.float64)
    gen = torch.Generator().manual_seed(2)
    got = TC.modulated_noise_map(gen, ivar, setup["tr"], lknee=100.0,
                                 alpha=-3.0, lmax=LMAX)
    gen = torch.Generator().manual_seed(2)
    nl = np.nan_to_num(1.0 * (100.0 / np.maximum(np.arange(LMAX + 1), 1e-30))
                       ** 3.0)
    nl[0] = 0.0
    want = TC.rand_map(gen, setup["tr"], nl + 1.0, LMAX,
                       dtype=torch.float64, device="cpu") * 0.5
    assert _rel(got, want) <= TOL64


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_smoothing(setup, dtype):
    m = np.random.default_rng(3).standard_normal(setup["jr"].shape) \
        .astype(dtype)
    ref = JC.smoothing(jnp.asarray(m), setup["jr"], 30.0, LMAX)
    got = TC.smoothing(torch.as_tensor(m), setup["tr"], 30.0, LMAX)
    assert _rel(got, ref) <= (TOL64 if dtype == "float64" else TOL32)


def test_masks_and_wfactor(setup):
    jr, tr = setup["jr"], setup["tr"]
    t1, t2 = np.deg2rad(76.0), np.deg2rad(104.0)
    ref = JC.galactic_mask_rings(jr, t1, t2, "equ")
    got = TC.galactic_mask_rings(tr, t1, t2, "equ", device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0 < got.sum() < got.numel()
    np.testing.assert_array_equal(
        TC.galactic_mask_rings(tr, t1, t2, "gal", device="cpu").numpy(),
        np.asarray(JC.galactic_mask_rings(jr, t1, t2, "gal")))
    jg = jgeo.rect_geometry(width_deg=20.0, px_res_arcmin=30.0, y0_deg=-30)
    tg = tp.rect_geometry(width_deg=20.0, px_res_arcmin=30.0, y0_deg=-30)
    for jf, tf, args in ((JC.galactic_mask, TC.galactic_mask, (1.0, 2.5)),
                         (JC.galactic_mask_equ, TC.galactic_mask_equ,
                          (0.3, -0.4)),
                         (JC.north_galactic_mask, TC.north_galactic_mask, ()),
                         (JC.south_galactic_mask, TC.south_galactic_mask,
                          ())):
        np.testing.assert_array_equal(tf(tg, *args, device="cpu").numpy(),
                                      np.asarray(jf(jg, *args)))
    np.testing.assert_array_equal(TC.gal2equ_rotation(),
                                  JC.gal2equ_rotation())
    np.testing.assert_allclose(TC.pointing_rotation((0.1, 0.2), (0.3, 0.4)),
                               JC.pointing_rotation((0.1, 0.2), (0.3, 0.4)),
                               rtol=0, atol=1e-15)
    for n in (1, 2):
        for norm in (True, False):
            assert abs(float(TC.wfactor(n, got, tr, norm))
                       / float(JC.wfactor(n, ref, jr, norm)) - 1) <= TOL64
    assert abs(float(TC.wfactor(2, got)) / float(JC.wfactor(2, ref))
               - 1) <= TOL64
    assert _rel(TC.pixsize_map(tr, device="cpu"), JC.pixsize_map(jr)) <= TOL64


def test_stitch_and_coadd(setup):
    jr, tr = setup["jr"], setup["tr"]
    rng = np.random.default_rng(5)
    n = talm.nalm(LMAX)
    alms = rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))
    m2 = rng.standard_normal(jr.shape)
    ls = np.arange(LMAX + 1)
    assert _rel(TC.cosine_taper_ells(ls, 10, 5, device="cpu"),
                JC.cosine_taper_ells(ls, 10, 5)) <= TOL64
    assert _rel(TC.cosine_taper_ells(torch.as_tensor(ls), 10, 5),
                JC.cosine_taper_ells(ls, 10, 5)) <= TOL64
    ref = JC.cosine_stitch(alms[0], m2, jr, 12, 6, LMAX)
    got = TC.cosine_stitch(torch.as_tensor(alms[0]), torch.as_tensor(m2), tr,
                           12, 6, LMAX)
    assert _rel(got, ref) <= TOL64
    lb = np.stack([np.exp(-ls / 30.0), np.exp(-ls / 20.0)])
    nls = np.stack([1.0 + ls, 2.0 + 0.5 * ls])
    ref = JC.kspace_coadd_alms(alms, lb, nls)
    got = TC.kspace_coadd_alms(torch.as_tensor(alms), lb, nls)
    assert _rel(got, ref) <= TOL64
    assert _rel(TC.masked_cls(torch.as_tensor(alms[0]), 0.7),
                JC.masked_cls(jnp.asarray(alms[0]), 0.7)) <= TOL64
    # stitched noise: cosine_stitch of the same white map, masked
    mask = TC.galactic_mask_rings(tr, 1.2, 1.9, device="cpu")
    gen = torch.Generator().manual_seed(9)
    got = TC.stitched_noise(gen, tr, torch.as_tensor(alms[0]), mask,
                            rms_uk_arcmin=10.0, lstitch=12, lcosine=6,
                            mlmax=LMAX)
    gen = torch.Generator().manual_seed(9)
    white = TC.white_noise(gen, tr, 10.0, device="cpu") * (mask > 0.5)
    want = TC.cosine_stitch(torch.as_tensor(alms[0]), white, tr, 12, 6,
                            LMAX) * (mask > 0.5)
    assert _rel(got, want) <= TOL64
    # white noise: the per-pixel sigma of the JAX function
    key = jax.random.PRNGKey(1)
    sig_j = np.asarray(JC.white_noise(key, jr, 10.0)) \
        / np.asarray(jax.random.normal(key, jr.shape, jnp.float64))
    gen = torch.Generator().manual_seed(1)
    sig_t = TC.white_noise(gen, tr, 10.0, device="cpu") \
        / torch.randn(tr.shape, generator=torch.Generator().manual_seed(1),
                      dtype=torch.float64)
    assert _rel(sig_t, sig_j) <= TOL64


def test_unported_names_raise(setup):
    """The rotations and ``cutout_gnomonic`` (ROADMAP queue A, item 18b;
    gated until the map-tools slice) are ported: each name is callable
    and runs (the parity tests below hold them to the JAX functions)."""
    for fn in (TC.rotate_map, TC.get_rotated_pixels, TC.cutout_gnomonic,
               TC.MapRotator, TC.MapRotatorEquator):
        assert callable(fn) and "not ported" not in fn.__doc__
    assert TC.cutout_gnomonic(np.arange(12.0), xsize=4).shape == (4, 4)
    g = tp.rect_geometry(width_arcmin=8 * 2.0, px_res_arcmin=2.0)
    assert TC.MapRotator(g, g, device="cpu").rotate(
        torch.ones(g.shape)).shape == g.shape


@pytest.fixture(scope="module")
def patches():
    """A 48^2 2' source patch at dec -30 deg and a 40 x 36 target patch at
    dec -29 deg, both packages."""
    src = dict(width_arcmin=48 * 2.0, px_res_arcmin=2.0, y0_deg=-30.0)
    tgt = dict(width_arcmin=36 * 2.0, height_arcmin=40 * 2.0,
               px_res_arcmin=2.0, y0_deg=-29.0)
    return (jgeo.rect_geometry(**src), tp.rect_geometry(**src),
            jgeo.rect_geometry(**tgt), tp.rect_geometry(**tgt))


def test_rotated_pixels(patches):
    js, ts, jt, tt = patches
    for kw in (dict(), dict(inverse=True), dict(source_ra0=0.01),
               dict(center_source=(-0.52, 0.02),
                    center_target=(-0.5, 0.0))):
        want = np.asarray(JC.get_rotated_pixels(js, jt, **kw))
        got = TC.get_rotated_pixels(ts, tt, device="cpu", **kw)
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-9)
    # a tensor rot: float64 on its device, the same positions
    rot = JC.pointing_rotation((-0.5, 0.1), (-0.51, 0.0))
    want = np.asarray(JC.get_rotated_pixels(js, jt, rot=rot,
                                            source_ra0=0.1))
    got = TC.get_rotated_pixels(ts, tt, rot=torch.as_tensor(rot),
                                source_ra0=0.1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-9)


@pytest.mark.parametrize("order", [0, 1])
def test_rotate_map_and_rotators(patches, order):
    js, ts, jt, tt = patches
    rng = np.random.default_rng(order)
    imap = rng.standard_normal((2,) + js.shape)
    want = JC.rotate_map(jnp.asarray(imap), js, jt, order=order)
    got = TC.rotate_map(torch.as_tensor(imap), ts, tt, order=order)
    assert np.abs(np.asarray(want)).max() > 0 and _rel(got, want) <= TOL64
    got32 = TC.rotate_map(imap.astype(np.float32), ts, tt, order=order,
                          device="cpu")
    assert got32.dtype == torch.float32 and _rel(got32, want) <= TOL32
    with pytest.raises(NotImplementedError):
        TC.rotate_map(torch.as_tensor(imap), ts, tt, order=3)
    rot = JC.pointing_rotation((js.y0 + 0.003, 0.1), (jt.y0, 0.0))
    want = JC.MapRotator(js, jt, rot=rot, source_ra0=0.1).rotate(imap[0])
    got = TC.MapRotator(ts, tt, rot=rot, source_ra0=0.1,
                        device="cpu").rotate(imap[0])
    assert _rel(got, want) <= TOL64


@pytest.mark.parametrize("down", [None, 3.0])
def test_map_rotator_equator(patches, down):
    js, ts, _, _ = patches
    rng = np.random.default_rng(5)
    imap = rng.standard_normal(js.shape)
    kw = dict(center_source=(js.y0, 0.3), patch_width_deg=1.0,
              patch_height_deg=0.8, downsample_pix_arcmin=down)
    jr = JC.MapRotatorEquator(js, **kw)
    tr = TC.MapRotatorEquator(ts, device="cpu", **kw)
    assert tr.geom_target == tp.Geometry(*dataclasses.astuple(
        jr.geom_target))
    assert _rel(tr.rotate(imap), jr.rotate(imap)) <= TOL64


@pytest.mark.parametrize("kw", [
    dict(),
    dict(rot=(40.0, -30.0, 20.0), xsize=30, ysize=20, reso=20.0),
    dict(rot=(250.0, 60.0), coord=("G", "C"), reso=30.0, flip="geo"),
    dict(rot=(10.0, 5.0), coord=["C", "G"], nest=True, remove_dip=True,
         gal_cut=10.0),
    dict(rot=(120.0, -10.0), remove_mono=True)])
def test_cutout_gnomonic(kw):
    nside = 16
    rng = np.random.default_rng(21)
    hmap = rng.standard_normal(12 * nside * nside) + 3.0
    hmap[5] = -1.6375e30                    # healpy's UNSEEN passes through
    np.testing.assert_array_equal(TC.cutout_gnomonic(hmap, **kw),
                                  JC.cutout_gnomonic(hmap, **kw))
