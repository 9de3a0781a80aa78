"""The port's interfaces, time_utils / ephem and the time facade against
the JAX package.

time_utils and ephem are copies (zoneinfo and numpy), so every output is
equal exactly. interfaces is host numpy on the port's cosmology, FITS
reader and data directory: its loaders read the same files written here
into ``tmp_path`` and return equal arrays (the redshifts of
``websky_halos`` come from the background cosmology's interpolation, the
same numpy code in both packages). ``CAMBInterface`` is driven up to the
subprocess it would start (no CAMB binary is installed): the ini rewrite
and the parse of a written output table.
"""
import datetime

import numpy as np
import pytest

from orphics_tpu import ephem as JE
from orphics_tpu import interfaces as JI
from orphics_tpu import time as JT
from orphics_tpu import time_utils as JTU

from orphics_tpu_torch import ephem as TE
from orphics_tpu_torch import interfaces as TI
from orphics_tpu_torch import time as TT
from orphics_tpu_torch import time_utils as TTU
from orphics_tpu_torch.utils import fitsio as TFITS


@pytest.mark.parametrize("site", [(None, None), (-89.9, 10.0),
                                  (19.8, -155.5), (45.0, 100.0),
                                  (10.0, -2.0)])
def test_time_conversions_match_jax(site):
    lat, lng = site
    assert TTU.timezone_at(lat, lng) == JTU.timezone_at(lat, lng)
    for ct in (0.0, 1.4e9, 1.7e9 + 12345.0):
        h = TT.htime(ct, lat, lng)
        assert h == JT.htime(ct, lat, lng)
        assert TT.ctime(h, lat, lng) == JT.ctime(h, lat, lng) == ct


def test_ephemeris_matches_jax():
    ts = np.linspace(1.3e9, 1.42e9, 300)
    assert TE.BODIES == JE.BODIES
    for body in TE.BODIES:
        a, b = TE.eval_body(body, ts), JE.eval_body(body, ts)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(TE.sun_radec(ts), JE.sun_radec(ts))
    np.testing.assert_array_equal(TE.moon_radec(ts), JE.moon_radec(ts))
    # the equinox check of tests/test_surveys.py on the port
    ct = datetime.datetime(2000, 3, 20, 7, 35,
                           tzinfo=datetime.timezone.utc).timestamp()
    radec, r = TE.eval_body("Sun", ct)
    assert abs(np.degrees(radec[0, 1])) < 0.05 and abs(r[0] - 1.0) < 0.02
    ann_t = TT.body_circle_annotations(1.4e9, 1.4e9 + 86400 * 30)
    ann_j = JT.body_circle_annotations(1.4e9, 1.4e9 + 86400 * 30)
    assert ann_t == ann_j and {a[0] for a in ann_t} == {"circle", "text"}
    obs = [{"a": 1, "b": 2.0}, {"a": 3, "b": 4.0}]
    for k, v in TT.get_columns(obs, ["a", "b"]).items():
        np.testing.assert_array_equal(v, JT.get_columns(obs, ["a", "b"])[k])
    assert TT.BODY_PERIOD == JT.BODY_PERIOD
    assert TT.DEFAULT_SITE_LAT == JT.DEFAULT_SITE_LAT
    assert set(TT.__all__) == set(JT.__all__)


def _eq(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_halo_loaders_match_jax(tmp_path):
    rng = np.random.default_rng(11)
    n = 300
    tab = np.stack([rng.uniform(0, 360, n), rng.uniform(-60, 60, n),
                    rng.uniform(0.01, 4.0, n), 10 ** rng.uniform(12, 15, n)],
                   1)
    np.savez(tmp_path / "agora.npz", data=tab)
    np.save(tmp_path / "agora.npy", tab)
    np.savetxt(tmp_path / "agora.txt", tab)
    for name in ("agora.npz", "agora.npy", "agora.txt"):
        p = str(tmp_path / name)
        _eq(TI.get_agora_halos(p, mmin=1e13, zmax=3.0),
            JI.get_agora_halos(p, mmin=1e13, zmax=3.0))
    # WebSky pksc: a 3-word header, then 10 float32 per halo
    cat = rng.uniform(-2000, 2000, (n, 10)).astype(np.float32)
    cat[:, 6] = rng.uniform(1.0, 4.0, n)
    with open(tmp_path / "halos.pksc", "wb") as f:
        np.array([n, 0, 0], np.uint32).tofile(f)
        cat.tofile(f)
    p = str(tmp_path / "halos.pksc")
    _eq(TI.websky_halos(p, mmin=1e13), JI.websky_halos(p, mmin=1e13))
    (tmp_path / "sehgal.csv").write_text("a,b\n1,2\n3,4\n")
    assert TI.sehgal_halos(str(tmp_path / "sehgal.csv")).equals(
        JI.sehgal_halos(str(tmp_path / "sehgal.csv")))
    (tmp_path / "shells").mkdir()
    np.save(tmp_path / "shells" / "shell_0.50.npy", np.arange(4.0))
    np.testing.assert_array_equal(
        TI.WebSkySlicer(str(tmp_path / "shells"), [0.5]).get_shell(0),
        np.arange(4.0))
    with pytest.raises(FileNotFoundError):
        TI.get_agora_halos(str(tmp_path / "missing.npy"))
    assert TI.agora_redshift_to_halocat_files(0.2, 0.9) == \
        JI.agora_redshift_to_halocat_files(0.2, 0.9)
    assert TI.agora_redshift_to_halocat_files(0.2, 0.9, lensed=True) == \
        JI.agora_redshift_to_halocat_files(0.2, 0.9, lensed=True)


def test_planck_and_redmapper_loaders_match_jax(tmp_path):
    _eq(TI.PlanckLensing().get_nlkk(), JI.PlanckLensing().get_nlkk())
    # a healpy-style alm bintable: index = l^2 + l + m + 1
    lmax = 12
    ls, ms = np.meshgrid(np.arange(lmax + 1), np.arange(lmax + 1),
                         indexing="ij")
    keep = ms <= ls
    ls, ms = ls[keep], ms[keep]
    rng = np.random.default_rng(5)
    (tmp_path / "MV").mkdir()
    TFITS.write_bintable(str(tmp_path / "MV" / "dat_klm.fits"), {
        "INDEX": ls ** 2 + ls + ms + 1,
        "REAL": rng.standard_normal(ls.size),
        "IMAG": rng.standard_normal(ls.size)})
    for kw in (dict(lmin=2, lmax=8), dict(lmin=0, lmax=40)):
        np.testing.assert_array_equal(
            TI.PlanckLensing(str(tmp_path)).load_mv_alms(**kw),
            JI.PlanckLensing(str(tmp_path)).load_mv_alms(**kw))
    TFITS.write_bintable(
        str(tmp_path / "redmapper_dr8_public_v6.3_catalog.fits"),
        {"RA": rng.uniform(0, 360, 50), "DEC": rng.uniform(-10, 60, 50),
         "LAMBDA": rng.uniform(20, 100, 50), "Z_LAMBDA": rng.uniform(
             0.1, 0.5, 50)})
    rt = TI.load_sdss_redmapper(str(tmp_path))
    rj = JI.load_sdss_redmapper(str(tmp_path))
    assert list(rt) == list(rj)
    for k in rt:
        np.testing.assert_array_equal(rt[k], rj[k])


def test_camb_interface_ini_and_output(tmp_path):
    tmpl = tmp_path / "params.ini"
    tmpl.write_text("output_root = x\nombh2 = 0.022\n"
                    "transfer_redshift(1) = 0\n")
    texts = []
    for mod in (TI, JI):
        ci = mod.CAMBInterface(str(tmpl), str(tmp_path))
        ci.set_param("ombh2", 0.0224)
        ci.set_param("omch2", 0.12)
        ci.set_param("transfer_redshift(2)", 1.0)
        texts.append(open(ci.ifile).read())
        # a CAMB Sources output table: ell, then N^2 columns (N = 2)
        ells = np.arange(2, 12)
        np.savetxt(tmp_path / (ci.out_name + "_scalCovCls.dat"),
                   np.column_stack([ells] + [ells * (k + 1.0)
                                             for k in range(4)]))
        e, cls = ci.get_cls()
        texts.append((e.tolist(), cls.tolist()))
        del ci
    assert texts[0] == texts[2] and texts[1] == texts[3]
    assert "ombh2=0.0224" in texts[0] and "omch2=0.12" in texts[0]
    assert np.asarray(texts[1][1]).shape == (2, 2, 10)
