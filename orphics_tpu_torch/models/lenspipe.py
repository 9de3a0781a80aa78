"""Batched lensed-sim -> observation -> TT-QE reconstruction (port of
``orphics_tpu.models.lenspipe``).

Per simulation:
  1. the unlensed CMB synthesized directly as B-spline coefficients (the
     spline prefilter rides the synthesis filter),
  2. a kappa GRF -> deflection,
  3. spline displacement on the B8 kernel
     (:func:`orphics_tpu_torch.ops.lens.lens_map_kernel`),
  4. beam and white noise applied in Fourier space,
  5. beam deconvolution + fused TT estimator,
  6. N_L^0-debiased binned cross / auto spectra on the B1 kernel.

Two paths, chosen by ``impl`` exactly as the JAX package chooses:

* the full-plane path (``impl="pallas"``, and ``"auto"`` on square
  grids with ``n % 128 == 0`` and ``n >= 256``): every plane in the
  doubly-permuted layout of :mod:`orphics_tpu_torch.ops.dft`, the noise
  drawn by the B5n kernel, maps packed in pairs through the B3/B4 DFTs,
  Hermitian splits with the B7 mirror, the estimator
  :meth:`~orphics_tpu_torch.models.qe.QE.kappa_tt_pallas`, binning on
  permuted tables;
* the half-plane path (``impl="xla"``, and ``"auto"`` elsewhere):
  cuFFT on the rfft half-plane,
  :meth:`~orphics_tpu_torch.models.qe.QE.kappa_tt_rfft` and
  :class:`~orphics_tpu_torch.ops.binning.RfftBin2D`.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve
from ..geometry import Geometry, arcmin
from ..ops import dft as D
from ..ops import fourier as F
from ..ops.bin_reduce import bin_reduce
from ..ops.binning import RfftBin2D
from ..ops.lens import _bspline_freq_response, lens_map_kernel, supported
from ..ops.mirror import mirror_pp
from ..ops.noise_planes import noise_planes
from . import grf as _grf
from . import qe as _qe

__all__ = ["LensedQEPipeline", "PLANE_NAMES", "PP_PLANE_NAMES"]

# the precomputed planes of a pipeline (see convert.load_pipeline_planes)
PLANE_NAMES = ("csq_coeff", "csq_kk", "alpha_filt", "kbeam_h", "inv_beam_h",
               "n0_h")
# the doubly-permuted planes of the full-plane path
# (see convert.load_pipeline_pp_planes)
PP_PLANE_NAMES = ("csq_coeff_pp", "csq_kk_pp", "cy_pp", "cx_pp", "nscale_pp",
                  "n0_pp")


def _fphi(modl):
    """kappa -> phi multiplier 2/(l(l+1)) with the l < 2 modes cut."""
    denom = modl * (modl + 1.0)
    fphi = np.where(denom > 0, 2.0 / np.where(denom > 0, denom, 1.0), 0.0)
    return np.where(modl < 2.0, 0.0, fphi)


class LensedQEPipeline:
    """Batched lensed-sim + TT-QE reconstruction. ``step(batch, generator)``
    returns the binned ``(cross, auto_in, auto_rec - N0)`` spectra,
    ``(batch, 3, nbins)``, on the path ``self.impl`` names. The
    deterministic bodies: ``core(eta_c, eta_k, eta_n)`` (half-plane, the
    three Hermitian half-plane noise sets) and ``_pp_core(zk, zc, w,
    batch)`` (full-plane, the three pair-level noise plane sets).

    ``impl``: "auto" takes the full-plane path where the grid is square,
    ``n % 128 == 0`` and ``n >= 256``, else the half-plane path; "pallas"
    demands the full-plane path (ValueError where the grid does not
    qualify); "xla" the half-plane path. ``generator`` must live on
    ``device``.
    """

    def __init__(self, geom: Geometry, theory, beam_arcmin=1.4,
                 noise_uk_arcmin=6.0, xlmin=100, xlmax=3000, klmin=40,
                 klmax=3000, edges=None, lens_order: int = 5,
                 maxdisp_px: int = 8, dtype=torch.float32, device=None,
                 impl: str = "auto"):
        if impl not in ("auto", "xla", "pallas"):
            raise ValueError(f"unknown impl {impl!r}")
        self.geom = geom
        self.device = resolve(device)
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
        host = lambda t: t.to(torch.float64).numpy()
        modl_h = host(geom.modlmap_r(torch.float32, "cpu"))
        lmap = host(geom.lmap(torch.float32, "cpu"))
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

        pallas_ok = (ny == nx and nx % 128 == 0 and nx >= 256
                     and supported(geom))
        if impl == "pallas" and not pallas_ok:
            raise ValueError(
                f"impl='pallas' requires a square grid with n % 128 == "
                f"0, n >= 256 and a valid lens-kernel tiling; got "
                f"{geom.shape}. Use impl='auto' for silent fallback to "
                "the XLA path.")
        self.impl = "pallas" if (impl in ("auto", "pallas")
                                 and pallas_ok) else "xla"
        if self.impl == "pallas":
            self._pp_planes(theory, cl_uu, cl_kk, beam_arcmin, edges)

    def _pp_planes(self, theory, cl_uu, cl_kk, beam_arcmin, edges):
        """The full-plane path's static planes, doubly permuted, built in
        float64 on the host (``lenspipe.py`` of the JAX package)."""
        geom, dev = self.geom, self.device
        n = geom.nx
        perm, _ = D.row_perm(n)
        self._perm = perm
        pp = lambda A: torch.as_tensor(np.ascontiguousarray(
            np.asarray(A, np.float64)[perm][:, perm], np.float32),
            device=dev)
        ml = geom.modlmap(torch.float32, "cpu").to(torch.float64).numpy()
        ells_f = np.arange(theory.lpad + 1)
        # full-plane synthesis scales, the normalization of covsqrt_half:
        # sqrt(C) npix / sqrt(area)
        sig = geom.npix / float(geom.area) ** 0.5
        ctt2d = np.interp(ml, ells_f, np.asarray(cl_uu), left=0, right=0)
        ckk2d = np.interp(ml, ells_f, np.asarray(cl_kk), left=0, right=0)
        ry = np.asarray(_bspline_freq_response(n, self.lens_order),
                        np.float64)
        resp = ry[:, None] * ry[None, :]
        self.csq_coeff_pp = pp(np.sqrt(np.maximum(ctt2d, 0.0)) * sig / resp)
        self.csq_kk_pp = pp(np.sqrt(np.maximum(ckk2d, 0.0)) * sig)
        # kappa -> deflection multipliers c_i = l_i 2/(l(l+1))
        lmap = geom.lmap(torch.float32, "cpu").to(torch.float64).numpy()
        fphi = _fphi(ml)
        self.cy_pp = pp(lmap[0] * fphi)
        self.cx_pp = pp(lmap[1] * fphi)
        kbeam = np.exp(-((beam_arcmin * arcmin) ** 2) * ml ** 2
                       / (16.0 * np.log(2.0)))
        self.nscale_pp = pp(self.ncov_h / np.maximum(kbeam, 1e-8))
        self.n0_pp = pp(self.qe.N_L_kk("TT").to(torch.float64).cpu().numpy())
        self._idc, self._icnt, self._nseg = D.permuted_bin_tables(
            ml, perm, edges, device=dev)
        self.qe._tt_pp_plans()          # built here, not in the first step

    @staticmethod
    def _interleave(a, b):
        """(P, n, n) x 2 -> (2P, n, n), pairs adjacent."""
        return torch.stack([a, b], dim=1).reshape((2 * a.shape[0],)
                                                  + tuple(a.shape[1:]))

    def _pp_core(self, zk, zc, w, batch: int):
        """Full-plane pipeline body from the three pair-level complex noise
        plane sets, each a ``(P, n, n)`` (re, im) pair in the ``fft2pp``
        layout with ``P = batch // 2``: kappa spectra ``zk`` (scale
        ``csq_kk_pp``), CMB spline-coefficient spectra ``zc`` (scale
        ``csq_coeff_pp``) and observation noise ``w`` (scale
        ``nscale_pp``). Returns ``(batch, 3, nbins)``.

        Per map: 0.5 mirror (kappa split), 0.5 inverse (coefficient pair),
        1 inverse (both deflection components as Re/Im: the i of the
        packing rides the i l_i multiplier), the B8 displacement, 0.5
        forward + 0.5 mirror (observed pair), the full-plane estimator
        and the B1 bin reduce.
        """
        (zkr, zki), (zcr, zci), (wr, wi) = zk, zc, w
        # Hermitian split of the kappa pair -> per-map input kappa
        zmr, zmi = mirror_pp(zkr, zki)
        Zkr = self._interleave(0.5 * (zkr + zmr), 0.5 * (zki + zmi))
        Zki = self._interleave(0.5 * (zki - zmi), 0.5 * (zmr - zkr))
        del zmr, zmi
        # CMB spline coefficients: two real maps per inverse
        c1, c2 = D.ifft2pp(zcr, zci)
        coeffs = self._interleave(c1, c2)
        del c1, c2
        # deflection: A = (i cy + i * i cx) Zk -> one inverse gives
        # (alpha_y, alpha_x) as Re/Im of one complex map per map
        ar = -self.cy_pp * Zki - self.cx_pp * Zkr
        ai = self.cy_pp * Zkr - self.cx_pp * Zki
        ay, ax = D.ifft2pp(ar, ai)
        del ar, ai
        alpha = torch.stack([ay, ax], dim=1)              # (B, 2, n, n)
        del ay, ax
        lensed = lens_map_kernel(coeffs[:, None], alpha, self.geom,
                                 order=self.lens_order,
                                 maxdisp_px=self.maxdisp_px,
                                 prefiltered=True)[:, 0]
        del coeffs, alpha
        # observed spectra: pair-packed forward + spectral noise add
        Zor, Zoi = D.fft2pp(lensed[0::2].contiguous(),
                            lensed[1::2].contiguous())
        del lensed
        Zor = Zor + wr
        Zoi = Zoi + wi
        omr, omi = mirror_pp(Zor, Zoi)
        Xr = self._interleave(0.5 * (Zor + omr), 0.5 * (Zoi + omi))
        Xi = self._interleave(0.5 * (Zoi - omi), 0.5 * (omr - Zor))
        del Zor, Zoi, omr, omi
        fkr, fki = self.qe.kappa_tt_pallas(Xr, Xi)
        del Xr, Xi
        norm = self.norm
        cross = (fkr * Zkr + fki * Zki) * norm
        auto_in = (Zkr * Zkr + Zki * Zki) * norm
        auto_rec = (fkr * fkr + fki * fki) * norm - self.n0_pp[None]
        stacked = torch.stack([cross, auto_in, auto_rec], dim=1) \
            .reshape(3 * batch, -1)
        sums = bin_reduce(stacked, self._idc, self._nseg)
        out = sums[:, 1:] * self._icnt
        return out.reshape(batch, 3, out.shape[-1])

    def draw_noise_pp(self, batch: int, generator: torch.Generator):
        """The three pair-level noise plane sets of :meth:`_pp_core`, drawn
        by the B5n kernel (plain ``torch.randn`` on the CPU); the seed
        words come from ``generator`` on the pipeline's device, so the
        step needs no host round trip."""
        if batch % 2:
            raise ValueError("the full-plane path packs map pairs: the batch "
                             f"must be even, got {batch}")
        words = torch.randint(-2 ** 31, 2 ** 31, (3, 2), generator=generator,
                              dtype=torch.int64, device=self.device) \
            .to(torch.int32)
        P = batch // 2
        return tuple(noise_planes(scale, words[i], P)
                     for i, scale in enumerate((self.csq_kk_pp,
                                                self.csq_coeff_pp,
                                                self.nscale_pp)))

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
        """Run ``batch`` independent sim + reconstruction pipelines on the
        path of ``self.impl`` (the full-plane path needs an even batch)."""
        if self.impl == "pallas":
            return self._pp_core(*self.draw_noise_pp(batch, generator),
                                 batch)
        return self.core(*self.draw_noise(batch, generator))

    def centers(self):
        return self.binner.centers
