"""Batched lensed-sim -> observation -> TT-QE reconstruction (port of
``orphics_tpu.models.lenspipe``, the half-plane path).

Per simulation:
  1. the unlensed CMB synthesized directly as B-spline coefficients (the
     spline prefilter rides the half-plane synthesis filter),
  2. a kappa GRF -> deflection (half-plane multipliers + irfft2),
  3. spline displacement on the B8 kernel
     (:func:`orphics_tpu_torch.ops.lens.lens_map_kernel`),
  4. beam and white noise applied on the half-plane,
  5. beam deconvolution + fused half-plane TT estimator
     (:meth:`orphics_tpu_torch.models.qe.QE.kappa_tt_rfft`),
  6. N_L^0-debiased binned cross / auto spectra on the B1 kernel
     (:class:`orphics_tpu_torch.ops.binning.RfftBin2D`).

The JAX package's full-plane ``impl="pallas"`` path (column/row DFT,
in-kernel noise and mirror kernels) is not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from ..geometry import Geometry, arcmin
from ..ops import fourier as F
from ..ops.binning import RfftBin2D
from ..ops.lens import _bspline_freq_response, lens_map_kernel
from . import grf as _grf
from . import qe as _qe

__all__ = ["LensedQEPipeline", "PLANE_NAMES"]

# the precomputed planes of a pipeline (see convert.load_pipeline_planes)
PLANE_NAMES = ("csq_coeff", "csq_kk", "alpha_filt", "kbeam_h", "inv_beam_h",
               "n0_h")


def _fphi(modl):
    """kappa -> phi multiplier 2/(l(l+1)) with the l < 2 modes cut."""
    denom = modl * (modl + 1.0)
    fphi = np.where(denom > 0, 2.0 / np.where(denom > 0, denom, 1.0), 0.0)
    return np.where(modl < 2.0, 0.0, fphi)


class LensedQEPipeline:
    """Batched lensed-sim + TT-QE reconstruction. ``step(batch, generator)``
    returns the binned ``(cross, auto_in, auto_rec - N0)`` spectra,
    ``(batch, 3, nbins)``; ``core(eta_c, eta_k, eta_n)`` is the
    deterministic body given the three Hermitian half-plane noise sets.

    ``impl``: "auto" or "xla" select this half-plane path; "pallas" (the
    JAX package's full-plane path) raises NotImplementedError.
    """

    def __init__(self, geom: Geometry, theory, beam_arcmin=1.4,
                 noise_uk_arcmin=6.0, xlmin=100, xlmax=3000, klmin=40,
                 klmax=3000, edges=None, lens_order: int = 5,
                 maxdisp_px: int = 8, dtype=torch.float32, device=None,
                 impl: str = "auto"):
        if impl == "pallas":
            raise NotImplementedError(
                "impl='pallas' (the full-plane path with the DFT, noise and "
                "mirror kernels B3/B4/B5n/B7) is not ported yet: ROADMAP.md "
                "queue A, item 6")
        if impl not in ("auto", "xla"):
            raise ValueError(f"unknown impl {impl!r}")
        self.impl = "xla"
        self.geom = geom
        self.device = torch.device(device) if device is not None \
            else torch.device("cpu")
        self.dtype = dtype
        self.lens_order = lens_order
        self.maxdisp_px = maxdisp_px
        ny, nx = geom.shape
        nxr = nx // 2 + 1
        lmax_grid = geom.ellmax_safe()
        ells = np.arange(theory.lpad + 1)
        dev = self.device

        # synthesis filters on the rfft half-plane; the exact B-spline
        # prefilter is folded into the CMB filter
        cl_uu = np.asarray(theory.uCl("TT", ells))
        cl_kk = np.asarray(theory.gCl("kk", ells))
        csq_tt = _grf.covsqrt_half(geom, ells, cl_uu, dtype=dtype, device=dev)
        self.csq_kk = _grf.covsqrt_half(geom, ells, cl_kk, dtype=dtype,
                                        device=dev)
        ry = _bspline_freq_response(ny, lens_order)
        rx = _bspline_freq_response(nx, lens_order)[:nxr]
        resp = torch.as_tensor(ry[:, None] * rx[None, :], dtype=dtype,
                               device=dev)
        self.csq_coeff = csq_tt / resp

        # kappa -> deflection multipliers i l_i 2/(l(l+1)), host float64
        modl_h = geom.modlmap_r(torch.float32).to(torch.float64).numpy()
        lmap = geom.lmap(torch.float32).to(torch.float64).numpy()
        ly_h = lmap[0][:, :nxr]
        lx_h = lmap[1][:, :nxr]
        fphi = _fphi(modl_h)
        self.alpha_filt = torch.as_tensor(
            np.stack([1j * ly_h * fphi, 1j * lx_h * fphi]).astype(np.complex64),
            device=dev)

        # observation model: beam + white noise on the half-plane
        kbeam_np = np.exp(-((beam_arcmin * arcmin) ** 2) * modl_h ** 2
                          / (16.0 * np.log(2.0)))
        self.kbeam_h = torch.as_tensor(kbeam_np.astype(np.float32), device=dev)
        self.inv_beam_h = torch.as_tensor(
            (1.0 / np.maximum(kbeam_np, 1e-8)).astype(np.float32), device=dev)
        self.ncov_h = float((noise_uk_arcmin * arcmin)
                            * (float(geom.npix) / float(geom.area) ** 0.5))

        # estimator + binning
        ctot = _qe.lensing_noise_2d(geom, theory, beam_arcmin,
                                    noise_uk_arcmin, dtype=dtype, device=dev)
        self.qe = _qe.QE(
            geom, theory, ctot,
            xmask=F.mask_kspace(geom, lmin=xlmin,
                                lmax=min(xlmax, lmax_grid - 1), dtype=dtype,
                                device=dev),
            kmask=F.mask_kspace(geom, lmin=klmin,
                                lmax=min(klmax, lmax_grid * 0.8), dtype=dtype,
                                device=dev),
            dtype=dtype, device=dev)
        self.n0_h = self.qe.N_L_kk("TT")[:, :nxr].contiguous()
        self.qe._tt_half_plans()        # built here, not in the first step
        if edges is None:
            edges = np.arange(klmin, min(klmax, int(lmax_grid * 0.8)), 80.0)
        self.binner = RfftBin2D(geom, edges, device=dev)
        self.norm = float(geom.area) / float(geom.npix) ** 2

    def core(self, eta_c, eta_k, eta_n):
        """Deterministic pipeline body from three ``(B, ny, nx//2+1)``
        complex Hermitian noise sets (CMB coefficients, kappa, instrument
        noise) -> ``(B, 3, nbins)`` binned spectra."""
        geom = self.geom
        coeffs = F.irfft2(self.csq_coeff * eta_c, geom)      # spline coeffs
        kin_h = self.csq_kk * eta_k                           # input kappa
        alpha = F.irfft2(self.alpha_filt[None] * kin_h[:, None], geom)
        lensed = lens_map_kernel(coeffs[:, None].contiguous(),
                                 alpha.contiguous(), geom,
                                 order=self.lens_order,
                                 maxdisp_px=self.maxdisp_px,
                                 prefiltered=True)[:, 0]
        kobs_h = self.kbeam_h * F.rfft2(lensed, geom) + self.ncov_h * eta_n
        fk = self.qe.kappa_tt_rfft(kobs_h * self.inv_beam_h)
        cross = (fk.conj() * kin_h).real * self.norm
        auto_in = (kin_h.conj() * kin_h).real * self.norm
        auto_rec = (fk.conj() * fk).real * self.norm - self.n0_h[None]
        _, binned = self.binner.bin(torch.stack([cross, auto_in, auto_rec],
                                                dim=1))
        return binned

    def draw_noise(self, batch: int, generator: torch.Generator):
        """The three Hermitian half-plane noise sets :meth:`core` takes."""
        return tuple(_grf.rand_hermitian_half(self.geom, generator, (batch,),
                                              self.dtype, self.device)
                     for _ in range(3))

    def step(self, batch: int, generator: torch.Generator):
        """Run ``batch`` independent sim + reconstruction pipelines."""
        return self.core(*self.draw_noise(batch, generator))

    def centers(self):
        return self.binner.centers
