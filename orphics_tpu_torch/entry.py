"""The flagship step of the port (counterpart of ``__graft_entry__.py``'s
``_build_qe_pipeline`` / ``entry``): lensed CMB simulation -> beam ->
noise -> TT quadratic-estimator kappa reconstruction -> binned
cross / auto spectra, through the port's production modules.

The multi-chip dry run waits for the port of ``orphics_tpu.parallel``.
"""
from __future__ import annotations

import numpy as np
import torch

from .geometry import Geometry, rect_geometry
from .models import lensing, qe
from .models.theory import default_theory
from .ops import fourier as F
from .ops.binning import Bin2D

__all__ = ["QEPipelineStep", "build_qe_pipeline", "entry"]


class QEPipelineStep:
    """One flagship step. ``step(generator)`` draws the three white-noise
    planes; ``step_from_noise(eta_c, eta_k, eta_n)`` takes them (each
    ``(1, ny, nx)`` complex). Both return ``(3, nbins)`` float32:
    cross, auto_in and auto_rec."""

    def __init__(self, geom: Geometry, th, beam=1.5, noise=7.0,
                 dtype=torch.float32, device=None):
        self.geom = geom
        self.fls = lensing.FlatLensingSims(geom, th, beam_arcmin=beam,
                                           noise_uk_arcmin=noise, lens_order=3,
                                           dtype=dtype, device=device)
        ctot = qe.lensing_noise_2d(geom, th, beam, noise, dtype=dtype,
                                   device=device)
        lmax_grid = geom.ellmax_safe()
        self.qe = qe.QE(
            geom, th, ctot,
            xmask=F.mask_kspace(geom, lmin=100, lmax=min(3000, lmax_grid),
                                dtype=dtype, device=device),
            kmask=F.mask_kspace(geom, lmin=40, lmax=min(1000, lmax_grid * 0.8),
                                dtype=dtype, device=device),
            dtype=dtype, device=device)
        self.qe.A_L("TT")
        edges = np.arange(40, min(1000, int(lmax_grid * 0.8)), 60.0)
        self.binner = Bin2D(geom.modlmap_np(), edges, device=device)
        self.norm = geom.area / geom.npix ** 2
        self.kbeam_floor = torch.clamp(self.fls.kbeam, min=1e-8)

    def step_from_noise(self, eta_c, eta_k, eta_n):
        observed, extras = self.fls.get_sim_from_noise(
            eta_c, eta_k, eta_n, return_intermediate=True)
        kobs = torch.fft.fft2(observed) / self.kbeam_floor
        fkrec = self.qe.kappa_from_map("TT", kobs)
        fkin = torch.fft.fft2(extras["kappa"])
        _, cross = self.binner.bin((fkrec.conj() * fkin).real * self.norm)
        _, auto_in = self.binner.bin((fkin.conj() * fkin).real * self.norm)
        _, auto_rec = self.binner.bin((fkrec.conj() * fkrec).real * self.norm)
        return torch.stack([cross, auto_in, auto_rec]).to(torch.float32)

    def step(self, generator: torch.Generator):
        return self.step_from_noise(*self.fls.draw_noise(generator))


def build_qe_pipeline(geom: Geometry, th, beam=1.5, noise=7.0, device=None,
                      dtype=torch.float32) -> QEPipelineStep:
    """Build the flagship step for a geometry and theory."""
    return QEPipelineStep(geom, th, beam=beam, noise=noise, dtype=dtype,
                          device=device)


def entry(device=None):
    """``(fn, example_args)``: one flagship step at 512^2 and 2' on
    ``device`` (the card when there is one), with a seeded generator."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    # nothing in the slice is worth TF32's three digits: keep fp32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    geom =rect_geometry(width_arcmin=512 * 2.0, px_res_arcmin=2.0)
    pipe = build_qe_pipeline(geom, default_theory(), device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return pipe.step, (gen,)
