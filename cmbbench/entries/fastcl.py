"""What the two FastCl entries share: the engine built from the
configuration, its reference grid and binner, and the layout-free count of
the modes its bins keep."""
from __future__ import annotations

import functools

import numpy as np

from .. import work as W
from ..reference.flat import Binner, Grid

__all__ = ["build_fastcl", "edges_of", "half_rows", "binning_work"]


def edges_of(cfg):
    e = cfg["bin_edges"]
    return np.arange(e["start"], e["stop"], float(e["step"]))


def build_fastcl(cfg, tables, device):
    """The program's ``FastCl`` on the configuration's grid, spectrum and
    bins."""
    from orphics_tpu_torch.geometry import rect_geometry
    from orphics_tpu_torch.models.fastcl import FastCl
    n, px = cfg["n"], cfg["px_arcmin"]
    geom = rect_geometry(width_arcmin=n * px, px_res_arcmin=px)
    cl = tables["lCl_TT"]
    return FastCl(geom, np.arange(len(cl)), cl, bin_edges=edges_of(cfg),
                  device=device)


def reference_grid(cfg, device):
    """The reference's grid and binner (built once per device)."""
    return _grid(cfg["n"], cfg["px_arcmin"], tuple(edges_of(cfg)),
                 str(device))


@functools.lru_cache(maxsize=4)
def _grid(n, px, edges, device):
    grid = Grid(n, px)
    return grid, Binner(grid.ml, np.asarray(edges), device)


def half_rows(n):
    """The natural rows ``ky`` in ``[0, n/2)``: a Hermitian half plane."""
    return np.arange(n) < n // 2


def binning_work(cfg, grid, fields, planes):
    """A segment sum of ``fields`` half-plane fields of ``planes`` rows
    each: the kept modes' data and ids read once, the bins written once."""
    edges = edges_of(cfg)
    kept = W.kept_modes(grid.ml, edges, half_rows(grid.n))
    nb = len(edges) - 1
    return (4.0 * (fields * planes + 1) * kept + 4.0 * fields * planes * nb,
            1.0 * fields * planes * kept)
