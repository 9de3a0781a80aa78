"""The port's models/catalogs (and the float64 binning it needs) against the
JAX module, on the CPU.

The same positions, noise and files go through both packages (the JAX side
under x64, as the conftest sets it). Tolerances:
- counts of ``binned_map`` / ``healpix_binned_map`` / ``CatMapper`` equal
  exactly (the same float64 pixel arithmetic, rounded half to even by
  both, sources exactly on half-pixels included); weighted maps and the
  overdensities 1e-12 of max (float64 sums in another order);
- ``Pow2Cat.get_maps_from_noise`` against JAX's ``MapGen`` on the same
  white noise 1e-10 of max (float64 FFTs by another library);
- ``reconstruct_velocities`` 1e-10 of max |v| at nmesh 32 (float64 CIC
  sums in another order, torch's FFT against numpy's);
- ``Bin2D`` / ``RfftBin2D`` / ``bin1d`` float64 means 1e-12 relative to the
  JAX binners (x64), and float32 means unchanged by the float64 route;
- Poisson counts and random catalogues by statistics: each mean and
  variance within 5 sigma of what their law gives;
- the host table functions (splits, selections, files) equal exactly.
"""
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orphics_tpu import geometry as jgeo
from orphics_tpu.models import catalogs as JC
from orphics_tpu.models import grf as jgrf
from orphics_tpu.ops import binning as jbin
from orphics_tpu.utils import fitsio as jfitsio

import orphics_tpu_torch as tp
from orphics_tpu_torch.models import catalogs as TC
from orphics_tpu_torch.ops import binning as tbin
from orphics_tpu_torch.ops.bin_reduce import bin_reduce, bin_reduce_ref
from orphics_tpu_torch.utils import fitsio as tfitsio

torch.set_num_threads(1)

TOL_W = 1e-12
TOL_MAPS = 1e-10
TOL_V = 1e-10
TOL_BIN64 = 1e-12
NSIGMA = 5.0


def _rel(got, ref):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) \
        else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)),
                                                  1e-300))


# a 32^2 grid of 2^-10 rad pixels: positions on half-pixels are exact
_HALF = dict(ny=32, nx=32, dy=2.0 ** -10, dx=2.0 ** -10)


def _positions(rng, geom, n):
    """Random (dec, ra) over and beyond the patch, then one source on every
    half-pixel of a row and a column."""
    h, w = geom.extent
    decs = rng.uniform(-0.6, 0.6, n) * h + geom.y0
    ras = rng.uniform(-0.6, 0.6, n) * w
    k = np.arange(geom.ny)
    half_d = (k + 0.5 - (geom.ny - 1) / 2.0) * geom.dy + geom.y0
    half_r = (k + 0.5 - (geom.nx - 1) / 2.0) * geom.dx
    decs = np.concatenate([decs, half_d, np.full(geom.ny, geom.y0)])
    ras = np.concatenate([ras, np.zeros(geom.ny), half_r])
    return decs, ras


@pytest.fixture(scope="module")
def maps_ref():
    """The JAX binned maps, CatMappers and overdensities, once."""
    rng = np.random.default_rng(16)
    jg = jgeo.Geometry(**_HALF)
    tg = tp.Geometry(**_HALF)
    decs, ras = _positions(rng, jg, 4000)
    w = rng.uniform(0.5, 2.0, decs.size)
    mask = (rng.uniform(size=jg.shape) > 0.2).astype(np.float64)
    out = dict(jg=jg, tg=tg, decs=decs, ras=ras, w=w, mask=mask)
    out["counts"] = np.asarray(JC.binned_map(decs, ras, jg))
    out["wmap"] = np.asarray(JC.binned_map(decs, ras, jg, w))
    out["delta"], out["nmean"] = (np.asarray(a) for a in JC.get_delta(
        out["counts"], mask))
    ras_deg, decs_deg = np.degrees(ras) + 10.0, np.degrees(decs) * 30.0
    out["hp_deg"] = (ras_deg, decs_deg)
    cm = JC.CatMapper(ras_deg, decs_deg, nside=8, weights=w)
    out["hp_counts"] = np.asarray(cm.counts)
    out["hp_delta"] = tuple(np.asarray(a) for a in cm.get_delta())
    return out


def test_binned_map_matches_jax(maps_ref):
    r = maps_ref
    jg, tg = r["jg"], r["tg"]
    # the half-pixel sources land where the JAX package puts them
    pix = tg.sky2pix(torch.as_tensor(np.stack([r["decs"], r["ras"]])))
    assert bool((pix.frac().abs() == 0.5).any())
    got = TC.binned_map(r["decs"], r["ras"], tg, device="cpu")
    assert got.dtype == torch.float64 and got.shape == jg.shape
    np.testing.assert_array_equal(got.numpy(), r["counts"])
    # tensors keep their device; float32 weights are summed in float64
    got_t = TC.binned_map(torch.as_tensor(r["decs"]),
                          torch.as_tensor(r["ras"]), tg)
    np.testing.assert_array_equal(got_t.numpy(), r["counts"])
    wgot = TC.binned_map(r["decs"], r["ras"], tg, r["w"], device="cpu")
    assert _rel(wgot, r["wmap"]) <= TOL_W
    assert float(got.sum()) < r["decs"].size        # some fall outside


def test_get_delta_and_catmapper_match_jax(maps_ref):
    r = maps_ref
    delta, nmean = TC.get_delta(torch.as_tensor(np.array(r["counts"])),
                                torch.as_tensor(r["mask"]))
    assert _rel(delta, r["delta"]) <= TOL_W
    assert float(nmean) == pytest.approx(float(r["nmean"]), rel=TOL_W)
    assert TC.get_delta_healpix is TC.get_delta
    # CatMapper on HEALPix: ang2pix on the host, counts on the device
    ras_deg, decs_deg = r["hp_deg"]
    cm = TC.CatMapper(ras_deg, decs_deg, nside=8, weights=r["w"],
                      device="cpu")
    assert cm.counts.shape == (12 * 64,)
    assert _rel(cm.get_map(), r["hp_counts"]) <= TOL_W
    d, n = cm.get_delta()
    assert _rel(d, r["hp_delta"][0]) <= TOL_W
    assert float(n) == pytest.approx(float(r["hp_delta"][1]), rel=TOL_W)
    unweighted = TC.healpix_binned_map(np.radians(decs_deg),
                                       np.radians(ras_deg), 8, device="cpu")
    np.testing.assert_array_equal(unweighted.numpy(), JC.healpix_binned_map(
        np.radians(decs_deg), np.radians(ras_deg), 8))
    # flat CatMapper from degrees
    jg, tg = r["jg"], r["tg"]
    cf = TC.CatMapper(np.degrees(r["ras"]), np.degrees(r["decs"]), geom=tg,
                      device="cpu")
    jf = JC.CatMapper(np.degrees(r["ras"]), np.degrees(r["decs"]), geom=jg)
    np.testing.assert_array_equal(cf.counts.numpy(), np.asarray(jf.counts))


def _spectra(ells):
    clgg = 1e-6 * np.exp(-(ells / 800.0) ** 2) + 1e-8
    clkk = 1e-7 * np.exp(-(ells / 800.0) ** 2) + 1e-9
    return clgg, 0.8 * np.sqrt(clgg * clkk), clkk


@pytest.mark.parametrize("ell_min", [0, 2])
def test_pow2cat_maps_from_noise_match_jax(ell_min):
    """The same white noise through JAX's Pow2Cat (its MapGen at float64)
    and the port's; ell_min 2 takes the dense re-grid."""
    kw = dict(width_arcmin=64 * 2.0, px_res_arcmin=2.0)
    jg, tg = jgeo.rect_geometry(**kw), tp.rect_geometry(**kw)
    ells = np.arange(ell_min, 3000)
    clgg, clkg, clkk = _spectra(ells)
    pj = JC.Pow2Cat(jg, ells, clgg, clkg, clkk, ngal_per_arcmin2=10.0)
    pt = TC.Pow2Cat(tg, ells, clgg, clkg, clkk, ngal_per_arcmin2=10.0,
                    device="cpu")
    assert pt.nbar == pytest.approx(pj.nbar, rel=1e-15)
    key = jax.random.PRNGKey(ell_min + 3)
    eta = np.array(jgrf.rand_kmap(key, jg, 2, dtype=jnp.float64))
    dj, kj = pj.get_maps(key)
    dt, kt = pt.get_maps_from_noise(torch.as_tensor(eta))
    assert dt.dtype == torch.float64
    assert _rel(dt, dj) <= TOL_MAPS and _rel(kt, kj) <= TOL_MAPS
    # a batch of noise gives the batch of maps
    db, _ = pt.get_maps_from_noise(torch.as_tensor(np.stack([eta, eta])))
    assert db.shape == (2,) + tg.shape
    assert _rel(db[1], dj) <= TOL_MAPS


def test_pow2cat_poisson_and_recovery():
    """Counts - lambda over the pixels: mean 0 and variance <lambda>
    within 5 sigma; the binned <delta_g kappa> of 16 mocks drawn in one
    batched call against Bin2D of clkg painted on the l-plane (the
    recovery check of tests/test_facade.py, at 5 sigma of the mocks'
    scatter)."""
    tg = tp.rect_geometry(width_arcmin=128 * 2.0, px_res_arcmin=2.0)
    ells = np.arange(3000)
    clgg, clkg, clkk = _spectra(ells)
    p2c = TC.Pow2Cat(tg, ells, clgg, clkg, clkk, ngal_per_arcmin2=3.0,
                     device="cpu")
    gen = torch.Generator().manual_seed(18)
    nsim = 16
    delta, kappa = p2c.get_maps(gen, batch=(nsim,))
    counts = p2c.counts_from_delta(delta, gen)
    assert counts.shape == (nsim,) + tg.shape
    lam = torch.clamp(p2c.nbar * (1.0 + delta), min=0.0)
    res = (counts - lam).reshape(-1)
    n = res.numel()
    lbar = float(lam.mean())
    assert abs(float(res.mean())) <= NSIGMA * np.sqrt(lbar / n)
    # var(N - lambda) = <lambda>; its sampling sd is about
    # sqrt((<lam> + 2 <lam^2>) / n)
    var_sd = np.sqrt((lbar + 2 * float((lam ** 2).mean())) / n)
    assert abs(float(res.var()) - lbar) <= NSIGMA * var_sd
    assert bool((counts == torch.round(counts)).all() and (counts >= 0).all())
    # get_cat draws the same law
    c2, k2 = p2c.get_cat(gen, batch=(2,))
    assert c2.shape == k2.shape == (2,) + tg.shape
    # recovery of the cross spectrum
    dg = counts / counts.mean(dim=(-2, -1), keepdim=True) - 1.0
    norm = tg.area / tg.npix ** 2
    cross = (torch.fft.fft2(dg).conj() * torch.fft.fft2(kappa)).real * norm
    edges = np.arange(200, 1200, 200.0)
    binner = tbin.Bin2D(tg.modlmap_np(), edges, device="cpu")
    cb = binner.bin(cross)[1].numpy()
    from orphics_tpu_torch.models.grf import cl2flat
    th = binner.bin(cl2flat(tg, ells, clkg, dtype=torch.float64,
                            device="cpu"))[1].numpy()
    sigma = cb.std(axis=0, ddof=1) / np.sqrt(nsim)
    assert np.all(np.abs(cb.mean(axis=0) - th) <= NSIGMA * sigma), \
        (cb.mean(axis=0), th, sigma)


def test_random_catalogs_statistics_and_twins():
    tg = tp.rect_geometry(width_arcmin=64 * 2.0, px_res_arcmin=2.0,
                          y0_deg=-10.0)
    gen = torch.Generator().manual_seed(5)
    n = 20000
    decs, ras = TC.random_catalog_flat(gen, tg, n, device="cpu")
    h, w = tg.extent
    assert decs.dtype == torch.float64 and decs.shape == (n,)
    for x, c, half in ((decs, tg.y0, h / 2), (ras, 0.0, w / 2)):
        assert float(x.min()) >= c - half and float(x.max()) < c + half
        # uniform: mean c, variance (2 half)^2 / 12
        assert abs(float(x.mean()) - c) <= NSIGMA * 2 * half / np.sqrt(12 * n)
    cmap = TC.binned_map(decs, ras, tg)
    assert float(cmap.sum()) == pytest.approx(n, abs=20)
    rs, ds = TC.get_random_catalog(gen, n, device="cpu")
    z = torch.sin(torch.deg2rad(ds))
    assert abs(float(z.mean())) <= NSIGMA / np.sqrt(3 * n)
    assert float(rs.min()) >= 0.0 and float(rs.max()) < 360.0
    # the twins' arithmetic is the JAX draw's, given its uniforms
    u = torch.as_tensor(np.random.default_rng(1).uniform(size=(2, 50)))
    dy, dx = TC.random_catalog_flat_from_noise(u[0], u[1], tg)
    np.testing.assert_array_equal(dy.numpy(),
                                  (u[0].numpy() - 0.5) * h + tg.y0)
    np.testing.assert_array_equal(dx.numpy(), (u[1].numpy() - 0.5) * w)
    ra2, dec2 = TC.get_random_catalog_from_noise(u[0], u[1])
    np.testing.assert_allclose(dec2.numpy(),
                               np.degrees(np.arcsin(u[0].numpy() * 2 - 1)),
                               rtol=1e-15, atol=1e-13)
    np.testing.assert_allclose(ra2.numpy(), np.degrees(u[1].numpy() * 2
                                                       * np.pi), rtol=1e-15)


def _velocity_catalogue(rng, nr=20000, ng_u=4000, ng_c=2000):
    ras_r = rng.uniform(-10, 10, nr)
    decs_r = rng.uniform(-10, 10, nr)
    zs_r = rng.uniform(0.4, 0.7, nr)
    ras = np.concatenate([rng.uniform(-10, 10, ng_u),
                          rng.normal(0, 0.7, ng_c)])
    decs = np.concatenate([rng.uniform(-10, 10, ng_u),
                           rng.normal(0, 0.7, ng_c)])
    zs = np.clip(np.concatenate([rng.uniform(0.4, 0.7, ng_u),
                                 rng.normal(0.55, 0.012, ng_c)]), 0.4, 0.7)
    return ras, decs, zs, ras_r, decs_r, zs_r


def test_reconstruct_velocities_matches_jax():
    rng = np.random.default_rng(32)
    cat = _velocity_catalogue(rng)
    w = rng.uniform(0.5, 1.5, cat[0].size)
    kw = dict(zeff=0.55, nmesh=32, smoothing_radius=15.0, fkp_weights=w)
    vj = JC.reconstruct_velocities(*cat, **kw)
    vt = TC.reconstruct_velocities(*cat, device="cpu", **kw)
    assert vt.dtype == torch.float64
    assert _rel(vt, vj) <= TOL_V
    # tensors keep their device
    vt2 = TC.reconstruct_velocities(*(torch.as_tensor(a) for a in cat),
                                    **kw)
    assert _rel(vt2, vj) <= TOL_V
    with pytest.raises(ValueError):
        TC.reconstruct_velocities(cat[0], cat[1], -cat[2], *cat[3:],
                                  device="cpu")


def test_reconstruct_velocities_infall_sign():
    """tests/test_surveys.py's infall check on the port: positive LOS
    velocity in front of the clump, negative behind."""
    rng = np.random.default_rng(3)
    ras, decs, zs, ras_r, decs_r, zs_r = _velocity_catalogue(
        rng, nr=40000, ng_u=8000, ng_c=4000)
    v = TC.reconstruct_velocities(ras, decs, zs, ras_r, decs_r, zs_r,
                                  zeff=0.55, nmesh=64, smoothing_radius=15.0,
                                  device="cpu").numpy()
    assert np.all(np.isfinite(v))
    vc, zc = v[8000:], zs[8000:]
    assert vc[(zc > 0.52) & (zc < 0.545)].mean() > 10.0
    assert vc[(zc > 0.555) & (zc < 0.58)].mean() < -10.0


def test_splits_selections_and_merges_match_jax():
    rng = np.random.default_rng(7)
    x = rng.lognormal(0.0, 0.7, 3000)
    edges = np.array([0.2, 0.8, 1.5, 3.0, 9.0])
    for a, b in zip(TC.split_samples(torch.as_tensor(x), edges),
                    JC.split_samples(x, edges)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(TC.split_sample_indices(x, edges[1:-1]),
                    JC.split_sample_indices(x, edges[1:-1])):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(TC.optimize_splits(x, edges),
                                  JC.optimize_splits(x, edges))
    ras = rng.uniform(-200, 400, 500)
    decs = rng.uniform(-60, 60, 500)
    other = [rng.standard_normal(500), np.arange(500)]
    for a, b in zip(TC.select_region(ras, decs, other, -30, 50, -20, 40),
                    JC.select_region(ras, decs, other, -30, 50, -20, 40)):
        for u, v in zip(a if isinstance(a, list) else [a],
                        b if isinstance(b, list) else [b]):
            np.testing.assert_array_equal(u, v)
    ra = np.concatenate([rng.uniform(0, 5, 200), [1.0, 1.0 + 0.3 / 60]])
    dec = np.concatenate([rng.uniform(-2, 2, 200), [0.5, 0.5]])
    for a, b in zip(TC.merge_duplicates(ra, dec, 1.0),
                    JC.merge_duplicates(ra, dec, 1.0)):
        np.testing.assert_array_equal(a, b)
    # masks: flat and HEALPix
    jg = jgeo.rect_geometry(width_arcmin=40 * 6.0, px_res_arcmin=6.0)
    tg = tp.rect_geometry(width_arcmin=40 * 6.0, px_res_arcmin=6.0)
    mask = rng.uniform(size=jg.shape)
    r2, d2 = rng.uniform(-2.5, 2.5, 400), rng.uniform(-2.5, 2.5, 400)
    np.testing.assert_array_equal(
        TC.select_based_on_mask(r2, d2, torch.as_tensor(mask), geom=tg),
        JC.select_based_on_mask(r2, d2, mask, geom=jg))
    hmask = rng.uniform(size=12 * 16 * 16)
    np.testing.assert_array_equal(
        TC.select_based_on_mask(r2 + 30, d2, hmask, nside=16),
        JC.select_based_on_mask(r2 + 30, d2, hmask, nside=16))
    z = np.linspace(0.0, 3.0, 50)
    np.testing.assert_allclose(TC.dndz(z), np.asarray(JC.dndz(z)),
                               rtol=1e-15)
    np.testing.assert_allclose(TC.dndz(torch.as_tensor(z)).numpy(),
                               np.asarray(JC.dndz(z)), rtol=1e-15)


def _boss_file(path, n, seed):
    rng = np.random.default_rng(seed)
    tfitsio.write_bintable(str(path), {
        "RA": rng.uniform(0, 30, n), "DEC": rng.uniform(-5, 5, n),
        "Z": rng.uniform(0.2, 0.8, n),
        "WEIGHT_SYSTOT": rng.uniform(0.9, 1.1, n),
        "WEIGHT_NOZ": np.ones(n), "WEIGHT_CP": rng.integers(1, 3, n) * 1.0})
    return str(path)


def test_boss_hsc_mappers_match_jax(tmp_path):
    f = _boss_file(tmp_path / "boss.fits", 2000, 0)
    fr = _boss_file(tmp_path / "rand.fits", 20000, 1)
    for a, b in zip(TC.load_boss([f], 0.3, 0.7), JC.load_boss([f], 0.3,
                                                               0.7)):
        np.testing.assert_array_equal(a, b)
    kw = dict(width_arcmin=33 * 60, height_arcmin=11 * 60, px_res_arcmin=30.0)
    jg, tg = jgeo.rect_geometry(**kw), tp.rect_geometry(**kw)
    bj = JC.BOSSMapper([f], random_files=[fr], zmin=0.2, zmax=0.8, geom=jg)
    bt = TC.BOSSMapper([f], random_files=[fr], zmin=0.2, zmax=0.8, geom=tg,
                       device="cpu")
    assert _rel(bt.counts, bj.counts) <= TOL_W
    np.testing.assert_array_equal(bt.rand_map, bj.rand_map)
    np.testing.assert_array_equal(bt.mask, bj.mask)
    assert bt.mask.mean() > 0.3
    hj = JC.BOSSMapper([f], random_files=[fr], nside=16)
    ht = TC.BOSSMapper([f], random_files=[fr], nside=16, device="cpu")
    assert _rel(ht.counts, hj.counts) <= TOL_W
    np.testing.assert_array_equal(ht.mask, hj.mask)
    # HSC from a table
    rng = np.random.default_rng(2)
    n = 5000
    table = {
        "ira": rng.uniform(0, 5, n), "idec": rng.uniform(-2, 2, n),
        "ishape_hsm_regauss_derived_weight": rng.uniform(5, 15, n),
        "ishape_hsm_regauss_derived_rms_e": np.full(n, 0.4),
        "ishape_hsm_regauss_derived_bias_m": rng.uniform(-0.05, 0.05, n),
        "ishape_hsm_regauss_e1": rng.normal(0.2, 0.1, n),
        "ishape_hsm_regauss_e2": rng.normal(-0.07, 0.1, n),
        "ishape_hsm_regauss_derived_bias_c1": rng.normal(0, 1e-3, n),
        "ishape_hsm_regauss_derived_bias_c2": rng.normal(0, 1e-3, n)}
    kw = dict(width_arcmin=6 * 60, height_arcmin=5 * 60, px_res_arcmin=30.0)
    jg, tg = jgeo.rect_geometry(**kw), tp.rect_geometry(**kw)
    hmj = JC.HSCMapper(table=table, geom=jg, mask_threshold=4.0)
    hmt = TC.HSCMapper(table=table, geom=tg, mask_threshold=4.0,
                       device="cpu")
    np.testing.assert_array_equal(hmt.mask, hmj.mask)
    occ = np.asarray(hmj.counts) > 3
    for a, b in zip(hmt.get_shear(), hmj.get_shear()):
        np.testing.assert_allclose(a[occ], b[occ], rtol=1e-10)


def test_mangle_and_fits_helpers_match_jax(tmp_path, monkeypatch):
    ply = ("2 polygons\npolygon 0 ( 1 caps, 0.75 weight, 0 pixel, 0 str):\n"
           f" 0.0 0.0 1.0 {1 - np.cos(0.5)}\n"
           "polygon 1 ( 2 caps, 0.5 weight, 0 pixel, 0 str):\n"
           " 1.0 0.0 0.0 0.3\n 0.0 1.0 0.0 -0.8\n")
    veto = ("1 polygons\npolygon 0 ( 1 caps, 1 weight, 0 pixel, 0 str):\n"
            " 0 0 1 0.05\n")
    fw, fv = tmp_path / "w.ply", tmp_path / "v.ply"
    fw.write_text(ply)
    fv.write_text(veto)
    assert len(TC.read_mangle_ply(str(fw))) == 2
    np.testing.assert_array_equal(
        TC.hp_from_mangle([str(fw)], 16, veto_ply_files=[str(fv)]),
        JC.hp_from_mangle([str(fw)], 16, veto_ply_files=[str(fv)]))
    rng = np.random.default_rng(9)
    cols = {"RADeg": rng.uniform(0, 5, 60), "decDeg": rng.uniform(-2, 2, 60),
            "SNR": rng.uniform(3, 9, 60),
            "NAME": np.array([f"cl{i}" for i in range(60)])}
    path = str(tmp_path / "cl.fits")
    tfitsio.write_bintable(path, cols)
    back_j = jfitsio.read_bintable(path)
    for k, v in tfitsio.read_bintable(path).items():
        np.testing.assert_array_equal(v, back_j[k])
    lt = TC.load_fits(path, ["RADeg", "SNR"], Nmax=20)
    lj = JC.load_fits(path, ["RADeg", "SNR"], Nmax=20)
    for k in lj:
        np.testing.assert_array_equal(lt[k], lj[k])
    ft = TC.filter_fits(path, "(SNR > 5)", verbose=False,
                        outfile=str(tmp_path / "f.fits"))
    fj = JC.filter_fits(path, "(SNR > 5)", verbose=False)
    for k in fj:
        np.testing.assert_array_equal(ft[k], fj[k])
    js = TC.fits_catalog_to_json(path, "RADeg", "decDeg", name_col="NAME",
                                 extra_cols=["SNR"],
                                 output_file=str(tmp_path / "c.json"))
    assert js == JC.fits_catalog_to_json(path, "RADeg", "decDeg",
                                         name_col="NAME", extra_cols=["SNR"])
    assert json.loads((tmp_path / "c.json").read_text()) == js
    for mod, name in ((TC, "t.txt"), (JC, "j.txt")):
        mod.convert_hilton_catalog_to_enplot_annotate_file(
            path, str(tmp_path / name))
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    # neither astropy nor fitsio importable (another test module may put
    # an astropy shim on the path): ImportError, as the JAX function
    for name in ("astropy", "astropy.io", "fitsio"):
        monkeypatch.setitem(sys.modules, name, None)
    for mod in (TC, JC):
        with pytest.raises(ImportError):
            mod.df_from_fits(path)


def _bin_data(rng, shape):
    return rng.standard_normal(shape) ** 2 + 0.1


@pytest.fixture(scope="module")
def bin_geoms():
    kw = dict(width_arcmin=96 * 3.0, px_res_arcmin=3.0)
    return jgeo.rect_geometry(**kw), tp.rect_geometry(**kw)


def test_bin2d_float64_matches_jax(bin_geoms):
    """float64 data through Bin2D: float64 means within 1e-12 of the JAX
    binner under x64 (rowcum: float64 cumulative sums); the float32 route
    is unchanged (float32 out, the float64 sums rounded once)."""
    jg, tg = bin_geoms
    edges = np.arange(200, 3001, 200.0)
    rng = np.random.default_rng(64)
    data = _bin_data(rng, (3,) + jg.shape)
    jb = jbin.Bin2D(jg.modlmap_np(), edges, strategy="rowcum")
    tb = tbin.Bin2D(tg.modlmap_np(), edges, device="cpu")
    _, mt = tb.bin(torch.as_tensor(data))
    _, mj = jb.bin(jnp.asarray(data))
    assert mt.dtype == torch.float64 and np.asarray(mj).dtype == np.float64
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=TOL_BIN64)
    wt = rng.uniform(0.5, 2.0, jg.shape)
    np.testing.assert_allclose(
        tb.bin(torch.as_tensor(data), weights=wt)[1].numpy(),
        np.asarray(jb.bin(jnp.asarray(data), weights=jnp.asarray(wt))[1]),
        rtol=TOL_BIN64)
    _, m1, e1 = tb.bin_err(torch.as_tensor(data[0]))
    _, m2, e2 = jb.bin_err(jnp.asarray(data[0]))
    assert e1.dtype == torch.float64
    np.testing.assert_allclose(m1.numpy(), np.asarray(m2), rtol=TOL_BIN64)
    np.testing.assert_allclose(e1.numpy(), np.asarray(e2), rtol=1e-9)
    # float32 data: float32 means, the float64 sums of bin_reduce_ref
    # rounded to float32 then scaled, as before the float64 route
    d32 = torch.as_tensor(data.astype(np.float32))
    _, m32 = tb.bin(d32)
    assert m32.dtype == torch.float32
    flat = d32.reshape(3, -1)
    want = (bin_reduce_ref(flat, tb._ids, tb._nseg)[:, 1:-1]
            * tb._inv_counts)
    assert torch.equal(m32, want)


def test_rfft_bin2d_and_bin1d_float64_match_jax(bin_geoms):
    jg, tg = bin_geoms
    edges = np.arange(200, 3001, 200.0)
    rng = np.random.default_rng(65)
    m = rng.standard_normal((2,) + jg.shape)
    half = np.abs(np.fft.rfft2(m)) ** 2
    jb = jbin.RfftBin2D(jg, edges, strategy="rowcum")
    tb = tbin.RfftBin2D(tg, edges, device="cpu")
    _, mt = tb.bin(torch.as_tensor(half))
    _, mj = jb.bin(jnp.asarray(half))
    assert mt.dtype == torch.float64
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=TOL_BIN64)
    _, m32 = tb.bin(torch.as_tensor(half.astype(np.float32)))
    assert m32.dtype == torch.float32
    x = rng.uniform(0, 3000, 5000)
    y = rng.standard_normal(5000)
    ct, bt = tbin.bin1d(x, y, edges)
    cj, bj = jbin.bin1d(x, y, edges)
    np.testing.assert_array_equal(ct, cj)
    assert bt.dtype == np.float64
    np.testing.assert_allclose(bt, np.asarray(bj), rtol=TOL_BIN64)


def test_bin_reduce_float64_plain_version():
    """B1's plain version in float64: float64 sums equal to a numpy
    bincount to 1e-12, ids outside [0, nseg) dropped, float64 weights."""
    rng = np.random.default_rng(66)
    n, nseg = 5000, 9
    data = rng.standard_normal((3, n))
    ids = rng.integers(-1, nseg + 1, n).astype(np.int32)
    w = rng.uniform(0.5, 2.0, n)
    got = bin_reduce(torch.as_tensor(data), torch.as_tensor(ids), nseg,
                     torch.as_tensor(w))
    assert got.dtype == torch.float64
    keep = (ids >= 0) & (ids < nseg)
    want = np.stack([np.bincount(ids[keep], weights=(d * w)[keep],
                                 minlength=nseg) for d in data])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
