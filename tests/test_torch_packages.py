"""The port's package re-exports and its native HEALPix library.

- ``orphics_tpu_torch`` and its ``ops``, ``models``, ``utils`` and
  ``parallel`` packages re-export every name their JAX counterparts do,
  less the Pallas modules and ``models/curved_qe`` (not ported), and the
  same submodule or object kind stands behind each name.
- Importing the packages and the new facades loads neither jax nor the JAX
  package, nor matplotlib, h5py, yaml, PIL or pandas (a subprocess).
- ``csrc/healpix.cpp`` builds with g++ (``have_native()`` is True);
  its ``ang2pix`` / ``pix2ang`` equal the numpy code exactly, pixels and
  angles (the cosine and arccos are numpy's on both paths), and the
  HEALPix maps of ``models/catalogs`` equal the JAX package's.
"""
import importlib
import inspect
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from orphics_tpu.models import catalogs as JC
from orphics_tpu.utils import healpix as JH

from orphics_tpu_torch import _build
from orphics_tpu_torch.models import catalogs as TC
from orphics_tpu_torch.utils import healpix as TH

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PALLAS = {"pallas_fft", "pallas_kernels", "pallas_lens", "pallas_sht"}


@pytest.mark.parametrize("pkg", ["", "ops", "models", "utils", "parallel"])
def test_package_reexports_resolve(pkg):
    """The root package too: its names, and every submodule the JAX
    package has loaded so far, which the port's import must find."""
    jmod = importlib.import_module("orphics_tpu" + (pkg and "." + pkg))
    tmod = importlib.import_module("orphics_tpu_torch" + (pkg and "." + pkg))
    names = [n for n in vars(jmod) if not n.startswith("_")
             and n not in PALLAS and n != "annotations"]
    assert names
    for n in names:
        if isinstance(getattr(jmod, n), types.ModuleType) \
                and not hasattr(tmod, n):
            importlib.import_module(tmod.__name__ + "." + n)
    missing = [n for n in names if not hasattr(tmod, n)]
    assert not missing, missing
    assert getattr(tmod, "__version__", None) == getattr(jmod, "__version__",
                                                         None)
    for n in names:
        jv, tv = getattr(jmod, n), getattr(tmod, n)
        if isinstance(jv, types.ModuleType):
            assert isinstance(tv, types.ModuleType), n
            assert tv.__name__ == "orphics_tpu_torch" + jv.__name__[
                len("orphics_tpu"):], n
        else:
            assert inspect.isclass(tv) == inspect.isclass(jv), n
            assert callable(tv) == callable(jv), n
            assert tv.__module__.startswith("orphics_tpu_torch."), n


def test_examples_import_form():
    """``from orphics_tpu.models import theory, grf`` is how the examples
    import; the same line works on the port."""
    from orphics_tpu_torch.models import theory, grf
    from orphics_tpu_torch.ops import Bin2D, power2d
    from orphics_tpu_torch.utils import io, plot, fitting, healpix
    assert theory.default_theory and grf.MapGen and Bin2D and power2d
    assert io.save_dict and plot.Plotter and fitting.npspace
    assert healpix.ang2pix


_IMPORTS = ("orphics_tpu_torch.ops, orphics_tpu_torch.models, "
            "orphics_tpu_torch.utils, orphics_tpu_torch.catalogs, "
            "orphics_tpu_torch.io, orphics_tpu_torch.stats, "
            "orphics_tpu_torch.time, orphics_tpu_torch.interfaces, "
            "orphics_tpu_torch.ephem, orphics_tpu_torch.time_utils, "
            "orphics_tpu_torch.models.catalogs, orphics_tpu_torch.utils.plot, "
            "orphics_tpu_torch.utils.io, orphics_tpu_torch.utils.fitsio")


def test_packages_import_no_jax_and_no_optional_packages():
    """The card's machine has no jax, matplotlib, h5py, yaml, PIL or
    pandas: importing the port's packages and facades loads none."""
    code = ("import sys\n"
            f"import {_IMPORTS}\n"
            "roots = ('jax', 'jaxlib', 'orphics_tpu', 'matplotlib', 'h5py', "
            "'yaml', 'PIL', 'pandas')\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "roots)\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_native_healpix_builds_and_loads():
    assert TH.have_native() is True, _build.healpix_build_log()
    assert _build.healpix_build_log() == ""
    lib = _build.healpix_library()
    assert lib is _build.healpix_library()          # built once a process
    so = [p.name for p in _build.BUILD_DIR.glob("liborphics_healpix_*.so")]
    assert so, "no digest-named library in _build/"


@pytest.mark.parametrize("nside", [1, 2, 16, 256, 4096])
def test_native_pixels_equal_numpy(nside):
    rng = np.random.default_rng(nside)
    n = 200_000
    theta = np.arccos(rng.uniform(-1, 1, n))
    phi = rng.uniform(-2 * np.pi, 4 * np.pi, n)
    # the ring boundaries z = +-2/3 and the poles
    theta = np.concatenate([theta, np.arccos([2 / 3, -2 / 3, 1.0, -1.0])])
    phi = np.concatenate([phi, [0.0, np.pi, 0.3, 6.0]])
    np.testing.assert_array_equal(TH.ang2pix(nside, theta, phi),
                                  TH._ang2pix_np(nside, theta, phi))
    npix = 12 * nside * nside
    pix = (np.arange(npix) if npix <= 200_000
           else rng.integers(0, npix, 200_000))
    for a, b in zip(TH.pix2ang(nside, pix), TH._pix2ang_np(nside, pix)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(TH.pix2ang(nside, pix, lonlat=True),
                    JH.pix2ang(nside, pix, lonlat=True)):
        np.testing.assert_array_equal(a, b)
    # pixel centres map back to their pixels
    np.testing.assert_array_equal(TH.ang2pix(nside, *TH.pix2ang(nside, pix)),
                                  pix)


def test_healpix_catalog_maps_match_jax():
    rng = np.random.default_rng(8)
    n = 100_000
    decs = np.arcsin(rng.uniform(-1, 1, n))
    ras = rng.uniform(0, 2 * np.pi, n)
    w = rng.uniform(0.5, 2.0, n)
    for nside in (16, 128):
        got = TC.healpix_binned_map(decs, ras, nside, device="cpu")
        np.testing.assert_array_equal(
            got.numpy(), JC.healpix_binned_map(decs, ras, nside))
        gw = TC.healpix_binned_map(torch.as_tensor(decs),
                                   torch.as_tensor(ras), nside, w)
        ref = JC.healpix_binned_map(decs, ras, nside, w)
        assert float(np.abs(gw.numpy() - ref).max()) <= 1e-12 * ref.max()
