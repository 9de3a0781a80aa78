"""The port's host utilities against the JAX package: utils/plot (through
the Agg backend), the stats facade, utils/io with the io facade, and
utils/fitsio.

Each plotter is driven by both packages on the same inputs, the port's
with tensors: both write their file, and what they return (the line
data, the projected or downsampled image, the figure's axes) is equal
exactly, since the port only moves the tensors to the host before the
same numpy and matplotlib calls. The io and fitsio functions return equal
values and write equal bytes. The three functions whose ``plot_file``
used to raise (``cosmology.fk_comparison`` / ``pk_comparison``,
``fitting.eig_analyze``) write their plot.
"""
import os

import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")

from orphics_tpu import io as JIO
from orphics_tpu import stats as JSTATS
from orphics_tpu.utils import fitsio as JFITS
from orphics_tpu.utils import io as JUIO
from orphics_tpu.utils import plot as JP

from orphics_tpu_torch import io as TIO
from orphics_tpu_torch import stats as TSTATS
from orphics_tpu_torch.utils import fitsio as TFITS
from orphics_tpu_torch.utils import io as TUIO
from orphics_tpu_torch.utils import plot as TP

torch.set_num_threads(1)

PNG = b"\x89PNG\r\n\x1a\n"


def _png(path):
    path = str(path)
    assert os.path.getsize(path) > 500
    with open(path, "rb") as f:
        assert f.read(8) == PNG


@pytest.mark.parametrize("scheme", ["Dell", "Cl", "LCL", "rCL"])
def test_plotter_lines_match_jax(tmp_path, scheme):
    ells = np.arange(2.0, 200.0)
    cl = 1.0 / ells ** 2
    lines = []
    for mod, x, y, tag in ((JP, ells, cl, "j"),
                           (TP, torch.as_tensor(ells), torch.as_tensor(cl),
                            "t")):
        p = mod.Plotter(scheme=scheme)
        p.add(x, y, label="theory")
        p.add_err(x[::20], y[::20], yerr=y[::20] * 0.1, label="pts")
        p.hline(y=1.0)
        ax = p._ax
        lines.append([(l.get_xdata(), l.get_ydata()) for l in ax.get_lines()]
                     + [(ax.get_xlabel(), ax.get_ylabel(), ax.get_xscale(),
                         ax.get_yscale())])
        p.done(str(tmp_path / f"{tag}.png"))
        _png(tmp_path / f"{tag}.png")
    (*lj, lab_j), (*lt, lab_t) = lines
    assert lab_t == lab_j
    assert len(lt) == len(lj)
    for (xt, yt), (xj, yj) in zip(lt, lj):
        np.testing.assert_array_equal(np.asarray(xt), np.asarray(xj))
        np.testing.assert_array_equal(np.asarray(yt), np.asarray(yj))


def test_image_plotters_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    arr = rng.standard_normal((32, 32))
    pos = np.abs(arr) + 0.1
    t_arr, t_pos = torch.as_tensor(arr), torch.as_tensor(pos)
    for mod, a, p, tag in ((JP, arr, pos, "j"), (TP, t_arr, t_pos, "t")):
        mod.plot_img(a, str(tmp_path / f"img{tag}.png"), lim=2.0)
        mod.hist(a.reshape(-1), bins=10, filename=str(tmp_path /
                                                      f"hist{tag}.png"))
        mod.fplot(p, str(tmp_path / f"f{tag}.png"))
        mod.power_crop(p, 16, str(tmp_path / f"pc{tag}.png"))
        mod.high_res_plot_img(a, str(tmp_path / f"h{tag}.png"), down=2,
                              verbose=False)
        mod.hplot(a, str(tmp_path / f"hp{tag}.png"), verbose=False)
        fig = mod.layered_contour(a, a, [0.0], "k",
                                  filename=str(tmp_path / f"c{tag}.png"))
        assert len(fig.axes) == 2
        for name in ("img", "hist", "f", "pc", "h", "hp", "c"):
            _png(tmp_path / f"{name}{tag}.png")
    # mplot: the JAX function hands verbose to the figure, which refuses it
    with pytest.raises(AttributeError, match="verbose"):
        JP.mplot(pos, str(tmp_path / "mj.png"))
    TP.mplot(t_pos, str(tmp_path / "mt.png"), verbose=False)
    _png(tmp_path / "mt.png")
    # what the image functions return
    np.testing.assert_array_equal(TP.high_res_plot_img(t_arr, down=4),
                                  JP.high_res_plot_img(arr, down=4))
    np.testing.assert_array_equal(TP.hplot(t_arr, down=2),
                                  JP.hplot(arr, down=2))


def test_mollview_and_galleries_match_jax(tmp_path):
    m = np.arange(12 * 8 * 8, dtype=float)
    img_j = JP.mollview(m, filename=str(tmp_path / "mj.png"), verbose=False,
                        return_projected_map=True, xsize=240)
    img_t = TP.mollview(torch.as_tensor(m), filename=str(tmp_path / "mt.png"),
                        verbose=False, return_projected_map=True, xsize=240)
    np.testing.assert_array_equal(img_t, img_j)
    _png(tmp_path / "mt.png")
    files = [str(tmp_path / "mj.png"), str(tmp_path / "mt.png")]
    assert TP.generate_gallery_html(files, titles=["a", "b"]) == \
        JP.generate_gallery_html(files, titles=["a", "b"])
    for mod, tag in ((JP, "j"), (TP, "t")):
        mod.write_gallery_html(files, str(tmp_path / f"g{tag}.html"))
        mod.html_gallery(files, outfile=str(tmp_path / f"h{tag}.html"))
    for name in ("g", "h"):
        assert (tmp_path / f"{name}t.html").read_text() == \
            (tmp_path / f"{name}j.html").read_text()


def test_fisher_plotters_match_jax(tmp_path):
    F1 = np.array([[4e4, 1e4], [1e4, 9e4]])
    fids = {"om": 0.3, "s8": 0.8}
    out = {}
    for mod, F, tag in ((JP, F1, "j"), (TP, torch.as_tensor(F1), "t")):
        fig, ax = mod.fisher_plot([np.linalg.inv(F1)], 0.3, 0.8, "om", "s8",
                                  labels=["a"],
                                  save_file=str(tmp_path / f"fp{tag}.png"))
        out[tag] = [l.get_xydata() for l in ax.get_lines()]
        fig = mod.corner_plot([F, F * 4], ["a", "b"], ["om", "s8"],
                              fid_dict=fids,
                              save_file=str(tmp_path / f"cp{tag}.png"))
        out[tag] += [l.get_xydata() for a in fig.axes for l in a.get_lines()]
        fp = mod.FisherPlots()
        fp.addSection("lcdm", ["om", "s8"], ["\\Omega_m", "\\sigma_8"], fids)
        fp.addFisher("lcdm", "x", F)
        fp.plotPair("lcdm", ("om", "s8"), ["x"],
                    saveFile=str(tmp_path / f"pair{tag}.png"))
        fp.plot1d("lcdm", "om", np.linspace(0.25, 0.35, 51), ["x"],
                  saveFile=str(tmp_path / f"one{tag}.png"))
        w = mod.WhiskerPlot([0.8, 0.76], [0.02, 0.03], ["A", "B"], vline=0.8)
        w.save(str(tmp_path / f"w{tag}.png"))
        for name in ("fp", "cp", "pair", "one", "w"):
            _png(tmp_path / f"{name}{tag}.png")
    assert len(out["t"]) == len(out["j"])
    for a, b in zip(out["t"], out["j"]):
        np.testing.assert_array_equal(a, b)


def test_lifted_plot_files_are_written(tmp_path):
    """fk_comparison / pk_comparison / eig_analyze with plot_file: the
    numbers are those without it, and the plot is written."""
    from orphics_tpu_torch.models import cosmology as tcos
    from orphics_tpu_torch.utils import fitting as tfit
    ks = np.logspace(-3, -1, 20)
    for name in ("fk_comparison", "pk_comparison"):
        f = tmp_path / f"{name}.png"
        k1, r1 = getattr(tcos, name)("H0", 0.5, 67.0, 70.0, ks=ks,
                                     plot_file=str(f))
        k2, r2 = getattr(tcos, name)("H0", 0.5, 67.0, 70.0, ks=ks)
        np.testing.assert_array_equal(r1, r2)
        _png(f)
    f = tmp_path / "eig.png"
    m = np.eye(2)[:, :, None, None] * np.ones((2, 2, 3, 3)) + 0.1
    es = tfit.eig_analyze(m, plot_file=str(f))
    np.testing.assert_array_equal(es, tfit.eig_analyze(m))
    _png(f)


def test_stats_facade_matches_jax(tmp_path):
    mat = np.random.default_rng(3).standard_normal((4, 3, 3))
    mat = mat @ np.swapaxes(mat, -1, -2)
    np.testing.assert_allclose(
        TSTATS.eig_pow(torch.as_tensor(mat), 0.5).numpy(),
        np.asarray(JSTATS.eig_pow(mat, 0.5)), rtol=1e-10, atol=1e-12)
    assert TSTATS.bin2D is TSTATS.Bin2D
    assert TSTATS.alpha_from_confidence(0.95) == \
        JSTATS.alpha_from_confidence(0.95)
    fig = TSTATS.corner_plot([np.diag([1e4, 4e4, 9e4])], ["a"],
                             ["x", "y", "z"],
                             save_file=str(tmp_path / "c.png"))
    assert len(fig.axes) == 9
    _png(tmp_path / "c.png")


def test_io_functions_match_jax(tmp_path, capsys):
    d = {"a": np.arange(6.0).reshape(2, 3), "b": np.array([1, 2, 3])}
    TUIO.save_dict(str(tmp_path / "t.h5"),
                   {k: torch.as_tensor(v) for k, v in d.items()})
    back = JUIO.load_dict(str(tmp_path / "t.h5"))
    back_t = TUIO.load_dict(str(tmp_path / "t.h5"))
    for k in d:
        np.testing.assert_array_equal(back[k], d[k])
        np.testing.assert_array_equal(back_t[k], d[k])
    TUIO.save_pickle(str(tmp_path / "p.pkl"), d)
    assert JUIO.load_pickle(str(tmp_path / "p.pkl"))["a"].shape == (2, 3)
    assert TUIO.get_hash(torch.as_tensor(d["a"])) == JUIO.get_hash(d["a"])
    assert TUIO.get_hash(str(tmp_path / "p.pkl")) == \
        JUIO.get_hash(str(tmp_path / "p.pkl"))
    cfg = {"x": 1, "y": [1.5, "s"], "z": {"q": None}}
    assert TUIO.hash_dict(cfg) == JUIO.hash_dict(cfg)
    for mod, tag in ((JUIO, "j"), (TUIO, "t")):
        mod.save_cols(str(tmp_path / f"c{tag}.txt"),
                      [torch.arange(4.0), np.arange(4.0) ** 2]
                      if tag == "t" else [np.arange(4.0), np.arange(4.0) ** 2])
    assert (tmp_path / "ct.txt").read_text() == (tmp_path / "cj.txt") \
        .read_text()
    np.testing.assert_array_equal(TUIO.load_cols(str(tmp_path / "ct.txt")),
                                  JUIO.load_cols(str(tmp_path / "cj.txt")))
    (tmp_path / "c.yml").write_text("a: 1\nb: [2, 3]\n")
    assert TUIO.config_from_yaml(str(tmp_path / "c.yml")) == \
        JUIO.config_from_yaml(str(tmp_path / "c.yml"))
    ini = tmp_path / "c.ini"
    ini.write_text("[bins]\nleft_edge = 10\nright_edge = 1000\nnum_bins = 8\n"
                   "spacing = log\n[arange]\nbin_edges_low = 0\n"
                   "bin_edges_high = 100\nbin_edges_width = 20\n"
                   "[vals]\nx = 1.5,2\nname = abc\n")
    ct, cj = TUIO.config_from_file(str(ini)), JUIO.config_from_file(str(ini))
    for sec in ("bins", "arange"):
        np.testing.assert_array_equal(TUIO.bin_edges_from_config(ct, sec),
                                      JUIO.bin_edges_from_config(cj, sec))
    assert TUIO.dict_from_section(ct, "vals") == \
        JUIO.dict_from_section(cj, "vals")
    assert TUIO.list_from_config(ct, "vals", "x") == [1.5, 2.0]
    assert TUIO.list_strings_from_config(ct, "vals", "x") == ["1.5", "2"]
    assert list(TUIO.load_path_config(str(ini))["vals"]) == ["x", "name"]
    TUIO.cprint("hello", color="g", bold=True)
    assert "hello" in capsys.readouterr().out
    with TUIO.nostdout():
        print("hidden")
    assert capsys.readouterr().out == ""
    log = TUIO.get_logger(str(tmp_path / "log.txt"))
    log.info("logged line")
    for h in log.handlers:
        h.flush()
    assert "logged line" in (tmp_path / "log.txt").read_text()
    for h in list(log.handlers):
        h.close()
        log.removeHandler(h)
    assert TUIO.datify([0, 86400]) == JUIO.datify([0, 86400])
    assert TUIO.join_nums([1, 2.5]) == JUIO.join_nums([1, 2.5])
    assert TUIO.but_her_emails("x a@b.org y") == ["a@b.org"]
    assert TUIO.latex.ell == JUIO.latex.ell
    # PIL's blend of two images
    from PIL import Image
    for i in range(2):
        Image.new("RGB", (8, 8), (40 * i, 10, 200)).save(
            str(tmp_path / f"i{i}.png"))
    bt = TUIO.blend(str(tmp_path / "i0.png"), str(tmp_path / "i1.png"), 0.3,
                    save_file=str(tmp_path / "b.png"), verbose=False)
    bj = JUIO.blend(str(tmp_path / "i0.png"), str(tmp_path / "i1.png"), 0.3)
    np.testing.assert_array_equal(np.asarray(bt), np.asarray(bj))
    # the io facade re-exports the same names, plot's included
    for name in dir(JIO):
        if not name.startswith("_") and name != "annotations":
            assert hasattr(TIO, name), name


def test_fitsio_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    cols = {"RA": rng.uniform(0, 360, 100), "DEC": rng.uniform(-20, 20, 100),
            "Z": rng.uniform(size=100).astype(np.float32),
            "ID": np.arange(100),
            "NAME": np.array([f"obj{i}" for i in range(100)])}
    TFITS.write_bintable(str(tmp_path / "t.fits"), cols)
    JFITS.write_bintable(str(tmp_path / "j.fits"), cols)
    assert (tmp_path / "t.fits").read_bytes() == \
        (tmp_path / "j.fits").read_bytes()
    bt = TFITS.read_bintable(str(tmp_path / "j.fits"))
    bj = JFITS.read_bintable(str(tmp_path / "t.fits"))
    assert list(bt) == list(bj)
    for k in bt:
        np.testing.assert_array_equal(bt[k], bj[k])
    np.testing.assert_allclose(bt["RA"], cols["RA"])
    assert bt["NAME"][3].decode() == "obj3"
