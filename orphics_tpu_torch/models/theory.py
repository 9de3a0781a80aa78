"""Theory power spectra as dense per-ell tables (port of
``orphics_tpu.models.theory``).

The CAMB tables shipped in ``orphics_tpu/data`` are read by file path and
kept as float64 numpy arrays on the host, indexed by integer ell from 0 to
``lpad``. Evaluation is host-side linear interpolation with zero fill
outside the table; the device planes are painted from it by the callers.

All spectra have the ``l(l+1)/2pi`` (and ``TCMB^2`` if dimensionless)
factors stripped, like the JAX package.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict

import numpy as np

__all__ = ["TheorySpectra", "load_theory_from_camb", "default_theory",
           "DATA_DIR"]

DATA_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "orphics_tpu", "data")


@dataclasses.dataclass
class TheorySpectra:
    """Dense per-ell theory tables: ``lCl_TT`` etc. (lensed), ``uCl_TT``
    (unlensed) and generic keys such as ``kk``."""

    tables: Dict[str, np.ndarray]
    lpad: int = 9000
    dimensionless: bool = False

    def _eval(self, key, ells):
        tab = self.tables[key]
        grid = np.arange(tab.shape[0], dtype=np.float64)
        return np.interp(np.asarray(ells, dtype=np.float64), grid, tab,
                         left=0.0, right=0.0)

    def lCl(self, spec: str, ells):
        """Lensed CMB Cl."""
        return self._eval("lCl_" + spec.upper(), ells)

    def uCl(self, spec: str, ells):
        """Unlensed CMB Cl."""
        return self._eval("uCl_" + spec.upper(), ells)

    def gCl(self, spec: str, ells):
        """Generic Cl (e.g. 'kk'); 'gk' falls back to 'kg' and CMB pol
        pairs fall back to the lensed tables, as in the JAX package."""
        if spec not in self.tables:
            if spec[::-1] in self.tables:
                spec = spec[::-1]
            elif ("lCl_" + spec.upper()) in self.tables:
                spec = "lCl_" + spec.upper()
        return self._eval(spec, ells)

    def loadCls(self, ells, cls, pol, lensed=True, lpad=None, fill_zero=True):
        """Ingest a 1D spectrum onto the dense integer-ell table."""
        lpad = lpad or self.lpad
        key = ("lCl_" if lensed else "uCl_") + pol.upper()
        self.tables[key] = _to_table(ells, cls, lpad, fill_zero)

    def loadGenericCls(self, ells, cls, key, lpad=None, fill_zero=True):
        lpad = lpad or self.lpad
        self.tables[key] = _to_table(ells, cls, lpad, fill_zero)


def _to_table(ells, cls, lpad, fill_zero=True):
    ells = np.asarray(ells, dtype=np.float64)
    cls = np.asarray(cls, dtype=np.float64)
    grid = np.arange(lpad + 1, dtype=np.float64)
    if fill_zero:
        tab = np.interp(grid, ells, cls, left=0.0, right=0.0)
        tab[grid < ells.min()] = 0.0
        tab[grid > ells.max()] = 0.0
    else:
        tab = np.interp(grid, ells, cls)
    return tab


def load_theory_from_camb(camb_root: str, TCMB: float = 2.7255e6,
                          lpad: int = 9000, get_dimensionless: bool = True,
                          unlensed_equals_lensed: bool = False) -> TheorySpectra:
    """Load CAMB ``*_lensedCls.dat`` / ``*_scalCls.dat`` /
    ``*_lenspotentialCls.dat`` outputs (same conventions as the JAX
    loader: column 5 of lenspotential is ``[l(l+1)]^2 C_phi / 2pi``)."""
    if not get_dimensionless:
        TCMB = 1.0
    th = TheorySpectra({}, lpad=lpad, dimensionless=get_dimensionless)

    ell, ltt, lee, lbb, lte = np.loadtxt(camb_root + "_lensedCls.dat",
                                         unpack=True, usecols=[0, 1, 2, 3, 4])
    mult = 2.0 * np.pi / ell / (ell + 1.0) / TCMB ** 2
    for pol, c in (("TT", ltt), ("EE", lee), ("BB", lbb), ("TE", lte)):
        th.loadCls(ell, c * mult, pol, lensed=True, lpad=lpad)

    try:
        elldd, cldd = np.loadtxt(camb_root + "_lenspotentialCls.dat",
                                 unpack=True, usecols=[0, 5])
        clkk = 2.0 * np.pi * cldd / 4.0
    except OSError:
        elldd, cldd = np.loadtxt(camb_root + "_scalCls.dat", unpack=True,
                                 usecols=[0, 4])
        clkk = cldd * (elldd + 1.0) ** 2 / elldd ** 2 / 4.0 / TCMB ** 2
    th.loadGenericCls(elldd, clkk, "kk", lpad=lpad)

    if unlensed_equals_lensed:
        for pol, c in (("TT", ltt), ("EE", lee), ("BB", lbb), ("TE", lte)):
            th.loadCls(ell, c * mult, pol, lensed=False, lpad=lpad)
    else:
        uell, utt, uee, ute = np.loadtxt(camb_root + "_scalCls.dat",
                                         unpack=True, usecols=[0, 1, 2, 3])
        umult = 2.0 * np.pi / uell / (uell + 1.0) / TCMB ** 2
        th.loadCls(uell, utt * umult, "TT", lensed=False, lpad=lpad)
        th.loadCls(uell, uee * umult, "EE", lensed=False, lpad=lpad)
        th.loadCls(uell, ute * umult, "TE", lensed=False, lpad=lpad)
        th.loadCls(uell, uee * 0.0, "BB", lensed=False, lpad=lpad)
    return th


def default_theory(lpad: int = 9000,
                   root: str = "cosmo2017_10K_acc3") -> TheorySpectra:
    """High-accuracy 2017 LCDM theory (the JAX package's default)."""
    return load_theory_from_camb(os.path.join(DATA_DIR, root), lpad=lpad,
                                 get_dimensionless=False)
