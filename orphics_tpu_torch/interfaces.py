"""Loaders for external simulation suites and data products (port of
``orphics_tpu.interfaces``: host numpy, on the port's ``cosmology``,
``catalogs.load_fits``, ``utils/fitsio`` and ``theory.DATA_DIR``).

Facade mirroring reference ``orphics.interfaces`` (``interfaces.py``):
Agora/WebSky/Sehgal halo catalogs, Planck lensing products, and a
file-driven CAMB subprocess runner. All loaders are path-driven and gate
cleanly when the products are not present on disk.
"""
from __future__ import annotations

import os
import subprocess

import numpy as np

__all__ = ["get_agora_halos", "websky_halos", "sehgal_halos",
           "WebSkySlicer", "PlanckLensing", "CAMBInterface"]


def _require(path):
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"external data product not found: {path}. These loaders need "
            "the corresponding simulation suite on disk (reference "
            "orphics/interfaces.py behaves the same way).")
    return path


def get_agora_halos(path, mmin=1e13, zmax=3.0):
    """Agora halo catalog -> (ra_deg, dec_deg, z, mass) arrays (reference
    ``interfaces.py:42``). Expects a numpy/csv table with columns
    ra, dec, z, M."""
    _require(path)
    if path.endswith(".npz"):
        # the filenames agora_redshift_to_halocat_files generates:
        # take the first array in the archive (or 'data' if present)
        with np.load(path) as z_:
            key = "data" if "data" in z_.files else z_.files[0]
            data = np.asarray(z_[key])
    elif path.endswith(".npy"):
        data = np.load(path)
    else:
        data = np.loadtxt(path)
    ra, dec, z, m = data[:, 0], data[:, 1], data[:, 2], data[:, 3]
    sel = (m > mmin) & (z < zmax)
    return ra[sel], dec[sel], z[sel], m[sel]


def websky_halos(path, mmin=1e13, zmax=4.0):
    """WebSky halo catalog (binary float32 pksc format) -> ra, dec, z, M200m
    (reference ``interfaces.py:188``)."""
    _require(path)
    with open(path, "rb") as f:
        n = np.fromfile(f, count=3, dtype=np.uint32)[0]
        catalog = np.fromfile(f, count=int(n) * 10, dtype=np.float32)
    catalog = catalog.reshape((int(n), 10))
    x, y, z_, R = catalog[:, 0], catalog[:, 1], catalog[:, 2], catalog[:, 6]
    # mass from R assuming rho_m(z=0) (WebSky convention)
    rho = 2.775e11 * 0.31 * 0.68 ** 2  # Msun/Mpc^3
    M = 4.0 / 3 * np.pi * R ** 3 * rho
    chi = np.sqrt(x ** 2 + y ** 2 + z_ ** 2)
    theta = np.arccos(np.clip(z_ / np.maximum(chi, 1e-10), -1, 1))
    phi = np.arctan2(y, x)
    ra = np.degrees(phi) % 360
    dec = 90.0 - np.degrees(theta)
    # crude chi -> z inversion via our background cosmology
    from .models.cosmology import Cosmology
    cc = Cosmology()
    zs = cc.redshift_at_comoving_radial_distance(chi)
    sel = (M > mmin) & (zs < zmax)
    return ra[sel], dec[sel], zs[sel], M[sel]


def sehgal_halos(path, mmin=1e13):
    """Sehgal et al. halo catalog loader (reference ``interfaces.py:228``)."""
    _require(path)
    import pandas as pd
    df = pd.read_csv(path, sep=None, engine="python")
    return df


class WebSkySlicer:
    """Redshift-shell access to WebSky fields (reference
    ``interfaces.py:108``)."""

    def __init__(self, path, zbins):
        self.path = _require(path)
        self.zbins = list(zbins)

    def get_shell(self, i):
        return np.load(os.path.join(
            self.path, f"shell_{self.zbins[i]:.2f}.npy"))


class PlanckLensing:
    """Planck lensing product paths + MV kappa noise (reference
    ``interfaces.py:278``); the shipped N_L^kk table works without the
    full product tree."""

    def __init__(self, root=None):
        self.root = root

    def get_nlkk(self):
        from .models.theory import DATA_DIR
        ells, nlkk = np.loadtxt(os.path.join(DATA_DIR,
                                             "planck_2018_mv_nlkk.dat"),
                                unpack=True, usecols=[0, 1])
        return ells, nlkk

    def load_mv_alms(self, est="MV", lmin=8, lmax=2048):
        """Read the PR3 convergence alms (``<root>/<est>/dat_klm.fits``)
        into healpy triangular ordering, band-limited to [lmin, lmax] —
        the role of ``hp.read_alm`` + ``filter_alms`` in reference
        ``interfaces.py:286-291`` ``_get_real``, via the native FITS
        binary-table reader (a healpy alm file IS a bintable with
        index/real/imag columns, index = l^2 + l + m + 1)."""
        from .utils.fitsio import read_bintable
        path = _require(os.path.join(self.root or "", est, "dat_klm.fits"))
        cols = read_bintable(path)
        get = {k.lower(): v for k, v in cols.items()}
        idx = np.asarray(get["index"], dtype=np.int64).ravel()
        re_ = np.asarray(get["real"], dtype=np.float64).ravel()
        im_ = np.asarray(get["imag"], dtype=np.float64).ravel()
        ls = np.floor(np.sqrt(idx - 1)).astype(np.int64)
        ms = idx - 1 - ls * ls - ls
        file_lmax = int(ls.max())
        out_lmax = min(lmax, file_lmax)
        nalm = (out_lmax + 1) * (out_lmax + 2) // 2
        alm = np.zeros(nalm, dtype=np.complex128)
        keep = (ls >= lmin) & (ls <= out_lmax) & (ms <= ls)
        tri = (ms[keep] * (2 * out_lmax + 1 - ms[keep])) // 2 + ls[keep]
        alm[tri] = re_[keep] + 1j * im_[keep]
        return alm


class CAMBInterface:
    """Ini-rewriting subprocess driver for a Fortran CAMB (Sources)
    executable, drop-in for the reference ``interfaces.py:323-423``:
    copies the template to ``<template>_itemp_<uid>.ini``, sets
    ``output_root``, rewrites ``param=value`` lines with a whitespace-
    insensitive prefix match (appending missing keys; the
    ``transfer_redshift`` quirk appends without a separating blank
    line), runs ``<camb_loc>/camb <ini>`` with cwd=camb_loc, and parses
    ``<root>_scalCovCls.dat`` into an (N, N, nell) L(L+1)C/2pi cube.
    Only useful when a ``camb`` binary is installed; the framework's
    default theory path uses shipped tables instead."""

    def __init__(self, ini_template, camb_loc):
        self.ifile = (ini_template.strip()[:-4]
                      + "_itemp_" + str(os.geteuid()) + ".ini")
        _require(ini_template)
        with open(ini_template) as src, open(self.ifile, "w") as dst:
            dst.write(src.read())
        self.out_name = "itemp_" + str(os.geteuid())
        self.set_param("output_root", self.out_name)
        self.camb_loc = camb_loc

    def set_param(self, param, value):
        """Rewrite (or append) ``param=value`` in the working ini."""
        self._replace(self.ifile, param, subst=param + "=" + str(value))

    def call(self, suppress=True):
        """Run CAMB on the working ini."""
        cmd = [os.path.join(self.camb_loc, "camb"), self.ifile]
        if suppress:
            subprocess.call(cmd, stdout=subprocess.DEVNULL,
                            cwd=self.camb_loc)
        else:
            subprocess.call(cmd, cwd=self.camb_loc)

    def get_cls(self):
        """(ells, cls[(N+3), (N+3), nell]) from the CAMB Sources
        ``_scalCovCls.dat`` output; components are CMB T, CMB E,
        CMB phi, then the redshift windows."""
        filename = os.path.join(self.camb_loc,
                                self.out_name + "_scalCovCls.dat")
        clarr = np.loadtxt(filename)
        ells = clarr[:, 0]
        ncomps = int(np.sqrt(clarr.shape[1] - 1))
        if ncomps ** 2 != clarr.shape[1] - 1:
            raise ValueError("malformed scalCovCls table")
        cls = np.swapaxes(clarr[:, 1:], 0, 1)
        return ells, cls.reshape((ncomps, ncomps, ells.size))

    @staticmethod
    def _replace(file_path, pattern, subst):
        # whitespace-insensitive "pattern=" prefix match, line by line;
        # missing keys append at EOF (transfer_redshift without the
        # separating blank line) — reference interfaces.py:397-420
        lines = []
        flag = False
        with open(file_path) as old:
            for line in old:
                if "".join(line.split())[:len(pattern) + 1] == pattern + "=":
                    line = subst + "\n"
                    flag = True
                lines.append(line)
        if not flag and "transfer_redshift" in pattern:
            lines.append(subst + "\n")
            flag = True
        if not flag:
            lines.append("\n" + subst + "\n")
        tmp = file_path + ".tmp"
        with open(tmp, "w") as new:
            new.writelines(lines)
        os.replace(tmp, file_path)

    def __del__(self):
        try:
            os.remove(self.ifile)
        except (OSError, AttributeError):
            pass


def load_sdss_redmapper(path, lams=True, zs=True):
    """Columns from the SDSS redMaPPer DR8 v6.3 cluster catalog
    (reference ``interfaces.py`` ``load_sdss_redmapper``)."""
    from .models.catalogs import load_fits
    extra = []
    if lams:
        extra += ["LAMBDA"]
    if zs:
        extra += ["Z_LAMBDA"]
    return load_fits(f"{path}/redmapper_dr8_public_v6.3_catalog.fits",
                     column_names=["RA", "DEC"] + extra)


def agora_redshift_to_halocat_files(z_min, z_max, lensed=False):
    """Agora lightcone slice filenames covering [z_min, z_max]
    (reference ``interfaces.py`` ``agora_redshift_to_halocat_files``;
    comoving distances from the native background cosmology at the
    Agora parameters instead of astropy)."""
    from .models.cosmology import Cosmology
    if lensed:
        base = ("agora_halos_lenra_lendec_mag_rotreal_rotimag_"
                "deflectnside16384_{}.npy")
    else:
        base = "agora_halolc_rot_{}_v050223.npz"
    cc = Cosmology(dict(H0=67.77, omch2=(0.307 - 0.048) * 0.6777 ** 2,
                        ombh2=0.048 * 0.6777 ** 2))
    d_min = cc.comoving_radial_distance(z_min) * cc.h
    d_max = cc.comoving_radial_distance(z_max) * cc.h
    slice_start = max(int(d_min // 25) - 1, 4)
    slice_end = min(int(d_max // 25) + 1, 200)
    return [base.format(i) for i in range(slice_start, slice_end + 1)]


def test():
    """Demo of the CAMBInterface driver (reference ``interfaces.py:426``):
    adds a third lensing source window to a template ini, runs the camb
    binary and loads the resulting theory. Needs a ``params_test.ini``
    template and a ``camb`` binary on PATH."""
    citest = CAMBInterface("params_test.ini")
    citest.set_param("num_redshiftwindows", "3", add=True)
    citest.set_param("redshift(3)", "2", add=True)
    citest.set_param("redshift_kind(3)", "lensing", add=True)
    citest.set_param("redshift_sigma(3)", "0.03", add=True)
    citest.call()
    import re
    m = re.search(r"(?m)^output_root\s*=\s*(\S+)", citest._ini)
    theory = citest.get_cls(m.group(1) if m else "test")
    print(theory)
