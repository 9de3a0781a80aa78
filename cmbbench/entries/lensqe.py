"""What the two lensing entries share: the program's ``LensedQEPipeline``
built from the configuration, and the reference's."""
from __future__ import annotations

from .. import work as W
from ..reference.flat import Grid
from ..reference.lensqe import LensQE, pipeline_edges

__all__ = ["build_pipeline", "References", "kept_modes"]


def kept_modes(cfg):
    """How many modes of the full plane the pipeline's bins keep."""
    return W.kept_modes(Grid(cfg["n"], cfg["px_arcmin"]).ml,
                        pipeline_edges(cfg))


def build_pipeline(cfg, tables, device):
    """The program's pipeline on the configuration's grid, instrument,
    filters, spline and path, fed the benchmark's theory tables."""
    import torch
    from orphics_tpu_torch.geometry import rect_geometry
    from orphics_tpu_torch.models.lenspipe import LensedQEPipeline
    from orphics_tpu_torch.models.theory import TheorySpectra
    n, px = cfg["n"], cfg["px_arcmin"]
    geom = rect_geometry(width_arcmin=n * px, px_res_arcmin=px)
    theory = TheorySpectra({k: v.copy() for k, v in tables.items()},
                           lpad=cfg["theory"]["lpad"])
    dtype = getattr(torch, cfg["dtype"])
    return LensedQEPipeline(
        geom, theory, beam_arcmin=cfg["beam_arcmin"],
        noise_uk_arcmin=cfg["noise_uk_arcmin"], xlmin=cfg["xlmin"],
        xlmax=cfg["xlmax"], klmin=cfg["klmin"], klmax=cfg["klmax"],
        lens_order=cfg["lens_order"], maxdisp_px=cfg["maxdisp_px"],
        dtype=dtype, device=device, impl=cfg["impl"])


class References:
    """The configuration's reference :class:`LensQE`, built once per
    precision."""

    def __init__(self, cfg, tables, device):
        self.args = cfg, tables, device
        self.built = {}

    def __call__(self, prec):
        if prec.name not in self.built:
            self.built[prec.name] = LensQE(*self.args, prec)
        return self.built[prec.name]
