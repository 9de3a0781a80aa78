"""Theory spectra for the benchmark, read with numpy by path.

The configurations name a CAMB output root (the tables shipped in the
repository's data directory). The benchmark reads them itself and hands
the same per-integer-ell tables to the program and to the references:
``lCl_XY`` lensed and ``uCl_XY`` unlensed CMB spectra without the
``l (l + 1) / 2 pi`` factor, in uK^2, and ``kk`` the lensing convergence
spectrum ``(l (l + 1))^2 C_phi / 4`` from the lensing-potential column.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

__all__ = ["load_tables", "REPO"]

REPO = Path(__file__).resolve().parent.parent


def _table(ells, cls, lpad):
    grid = np.arange(lpad + 1, dtype=np.float64)
    tab = np.interp(grid, ells, cls, left=0.0, right=0.0)
    tab[(grid < ells.min()) | (grid > ells.max())] = 0.0
    return tab


def load_tables(root: str, lpad: int):
    """``{key: (lpad + 1,) float64}`` from ``<root>_lensedCls.dat``,
    ``<root>_scalCls.dat`` and ``<root>_lenspotentialCls.dat`` (``root``
    relative to the checkout)."""
    base = str(REPO / root)
    ell, tt, ee, bb, te = np.loadtxt(base + "_lensedCls.dat", unpack=True,
                                     usecols=[0, 1, 2, 3, 4])
    mult = 2.0 * np.pi / ell / (ell + 1.0)
    out = {}
    for key, c in (("TT", tt), ("EE", ee), ("BB", bb), ("TE", te)):
        out["lCl_" + key] = _table(ell, c * mult, lpad)
    ul, utt, uee, ute = np.loadtxt(base + "_scalCls.dat", unpack=True,
                                   usecols=[0, 1, 2, 3])
    umult = 2.0 * np.pi / ul / (ul + 1.0)
    for key, c in (("TT", utt), ("EE", uee), ("TE", ute), ("BB", 0.0 * uee)):
        out["uCl_" + key] = _table(ul, c * umult, lpad)
    ld, cdd = np.loadtxt(base + "_lenspotentialCls.dat", unpack=True,
                         usecols=[0, 5])
    out["kk"] = _table(ld, 2.0 * np.pi * cdd / 4.0, lpad)
    return out
