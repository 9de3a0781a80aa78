"""Plain references of the flat-sky lensing Monte Carlo and the TT quadratic
estimator, in float64 PyTorch (or the control's lower precision), written
from the definitions and not from the program.

* Lensing: a map held as periodic quintic B-spline coefficients ``c`` is
  evaluated at ``x + alpha / d``, the deflection in pixels clipped to
  ``[-maxdisp, maxdisp]`` per axis: ``sum_jk c[j, k] b5(y - j) b5(x - k)``
  over the 6 x 6 nearest knots, with ``b5`` the centred quintic B-spline.
  The coefficients of a GRF come straight from its Fourier modes divided by
  the spline's sampling response ``sum_j b5(j) exp(-i w j)`` per axis.
* Deflection from convergence: ``phi = 2 kappa / (L (L + 1))`` (0 below
  L = 2), ``alpha_i = ifft2(i l_i phi)``.
* TT estimator (Hu & Okamoto 2002) with one binary leg mask ``m`` and the
  output mask ``k``: response ``f = (L.l1) C(l1) + (L.l2) C(l2)`` with the
  lensed ``C``, filter ``F = f m1 m2 / (2 Ct1 Ct2)``, ``A_L = 1 / int f F``,
  ``phi_hat = A_L k int F X Y`` with legs in physical units ``X = fft
  sqrt(area) / npix``, every integral ``int d^2 l1 / (2 pi)^2`` a circular
  convolution ``(npix / area) fft2(ifft2(A) ifft2(B))``; ``kappa_hat = L^2
  phi_hat / 2`` returned as a raw fft. For this filter the Gaussian noise
  ``N0`` of ``phi_hat`` equals ``A_L`` (within the output mask), so
  ``N0_kappa = L^4 A_L k / 4``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import streams
from .flat import ARCMIN, Binner, Grid, Prec, grf_scale

__all__ = ["b5", "sampling_response", "lens", "LensQE", "pipeline_edges"]


def b5(x):
    """The centred quintic B-spline, ``sum_k (-1)^k C(6, k) (x + 3 - k)_+^5
    / 120``."""
    out = torch.zeros_like(x)
    for k in range(7):
        out = out + ((-1) ** k * math.comb(6, k)
                     * torch.clamp(x + 3.0 - k, min=0.0) ** 5)
    return out / 120.0


def sampling_response(n: int):
    """``sum_j b5(j) exp(-i w_k j)`` on the ``n`` DFT frequencies (real:
    the spline is even), float64 numpy."""
    j = torch.arange(-2, 3, dtype=torch.float64)
    taps = b5(j).numpy()
    w = 2.0 * np.pi * np.fft.fftfreq(n)
    return sum(t * np.cos(w * jj) for t, jj in zip(taps, range(-2, 3)))


def lens(coeffs, alpha_y, alpha_x, d: float, maxdisp: float, prec: Prec):
    """Spline coefficients ``(B, n, n)`` evaluated at the displaced pixel
    centres, the deflections in radians."""
    B, n, _ = coeffs.shape
    dev = coeffs.device
    c = prec.q(coeffs)
    py = prec.q(torch.clamp(alpha_y / d, -maxdisp, maxdisp))
    px = prec.q(torch.clamp(alpha_x / d, -maxdisp, maxdisp))
    iy = torch.arange(n, device=dev, dtype=torch.float64)[:, None]
    ix = torch.arange(n, device=dev, dtype=torch.float64)[None, :]
    y = iy + py.to(torch.float64)
    x = ix + px.to(torch.float64)
    fy = torch.floor(y)
    fx = torch.floor(x)
    out = torch.zeros_like(c)
    flat = c.reshape(B, -1)
    for a in range(-2, 4):
        ky = fy + a
        wy = prec.q(b5(y - ky))
        ry = torch.remainder(ky, n).to(torch.long)
        for b in range(-2, 4):
            kx = fx + b
            wx = prec.q(b5(x - kx))
            idx = (ry * n + torch.remainder(kx, n).to(torch.long))
            tap = torch.gather(flat, 1, idx.reshape(B, -1)).reshape(B, n, n)
            out = prec.q(out + prec.q(wy * wx) * tap)
    return out


def pipeline_edges(cfg):
    """The pipeline's own bins: ``arange(klmin, min(klmax, int(0.8 *
    Nyquist)), step)``."""
    nyq = np.pi / (cfg["px_arcmin"] * ARCMIN)
    return np.arange(cfg["klmin"], min(cfg["klmax"], int(nyq * 0.8)),
                     float(cfg["bin_step"]))


class LensQE:
    """The configuration's sims and TT estimator on its grid, in ``prec``,
    on ``device``. ``tables``: per-integer-ell ``lCl_TT``, ``uCl_TT`` and
    ``kk`` (float64)."""

    def __init__(self, cfg, tables, device, prec: Prec = None):
        self.cfg = cfg
        self.prec = prec = prec or Prec()
        self.dev = device
        g = self.grid = Grid(cfg["n"], cfg["px_arcmin"])
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
        ml = g.ml
        self.norm = g.area / g.npix ** 2
        self.phys = math.sqrt(g.area) / g.npix
        self.conv_fac = g.npix / g.area
        beam = np.exp(-(cfg["beam_arcmin"] * ARCMIN) ** 2 * ml ** 2
                      / (16.0 * np.log(2.0)))
        noise = (cfg["noise_uk_arcmin"] * ARCMIN) ** 2
        cl = g.interp(tables["lCl_TT"])
        ctot = cl + noise / np.maximum(beam ** 2, 1e-30)
        xmask = (ml > cfg["xlmin"]) & (ml < min(cfg["xlmax"],
                                                 g.nyquist - 1))
        self.kmask = (ml > cfg["klmin"]) & (ml < min(cfg["klmax"],
                                                      g.nyquist * 0.8))
        self.ctot = ctot
        # sims: GRF amplitudes, the spline's response, kappa -> deflection
        resp = sampling_response(g.n)
        self.s_cc = t(grf_scale(g, tables["uCl_TT"])
                      / (resp[:, None] * resp[None, :]))
        self.s_kk = t(grf_scale(g, tables["kk"]))
        with np.errstate(divide="ignore"):
            fphi = np.where(ml >= 2.0, 2.0 / (ml * (ml + 1.0)), 0.0)
        self.iphi_y = t(1j * g.ly * fphi)
        self.iphi_x = t(1j * g.lx * fphi)
        ncov = cfg["noise_uk_arcmin"] * ARCMIN * g.npix / math.sqrt(g.area)
        self.s_ww = t(ncov / np.maximum(beam, 1e-8))
        # estimator filters
        self.a = t(xmask / (2.0 * ctot))           # m / (2 Ct)
        self.b = t(xmask / ctot)                   # m / Ct
        self.C = t(cl)
        self.L = (t(g.ly), t(g.lx))
        self.ml2 = t(ml ** 2)
        self.kmask_t = t(self.kmask.astype(np.float64))
        self.A_L = self._norm()
        self.n0_kk = prec.q(self.ml2 ** 2 / 4.0 * self.A_L * self.kmask_t)
        self.binner = Binner(ml, pipeline_edges(cfg), device)

    def _conv(self, A, B):
        p = self.prec
        return p.q(p.fft2(p.q(p.ifft2(A) * p.ifft2(B))) * self.conv_fac)

    def _norm(self):
        """``A_L = 1 / int f F`` (0 where the integral vanishes)."""
        p, a, b, C, L = self.prec, self.a, self.b, self.C, self.L
        inv = 0.0
        for i in range(2):
            for j in range(2):
                lij = L[i] * L[j]
                term = (self._conv(p.q(lij * C * C * a), b)
                        + 2.0 * self._conv(p.q(L[i] * C * a),
                                           p.q(L[j] * C * b))
                        + self._conv(a, p.q(lij * C * C * b)))
                inv = inv + p.q(lij * term)
        inv = inv.real
        safe = torch.where(inv.abs() > 1e-30, inv, torch.ones_like(inv))
        return p.q(torch.where(inv.abs() > 1e-30, 1.0 / safe,
                               torch.zeros_like(inv)))

    def kappa(self, k):
        """Raw-fft kappa estimate from raw-fft beam-deconvolved k-maps
        ``(B, n, n)`` (both legs the same map)."""
        p, a, b, C, L = self.prec, self.a, self.b, self.C, self.L
        X = p.q(p.q(k) * self.phys)
        aX = p.q(a * X)
        bX = p.q(b * X)
        uphi = 0.0
        for i in range(2):
            uphi = uphi + p.q(L[i] * (self._conv(p.q(L[i] * C * aX), bX)
                                      + self._conv(aX, p.q(L[i] * C * bX))))
        phi = p.q(self.A_L * p.q(uphi) * self.kmask_t
                  * math.sqrt(self.grid.area))
        return p.q(0.5 * self.ml2 * phi / self.phys)

    def spectra(self, fk, K=None):
        """Binned ``(raw auto, auto - N0[, cross, input auto])`` of a kappa
        estimate ``fk`` (and the input kappa's raw fft ``K``), float64."""
        p = self.prec
        raw = p.q(p.q(fk.real ** 2 + fk.imag ** 2) * self.norm)
        out = [self.binner.mean(raw), self.binner.mean(p.q(raw - self.n0_kk))]
        if K is not None:
            cross = p.q(p.q(fk.real * K.real + fk.imag * K.imag) * self.norm)
            auto_in = p.q(p.q(K.real ** 2 + K.imag ** 2) * self.norm)
            out += [self.binner.mean(cross), self.binner.mean(auto_in)]
        return out

    def _pair_maps(self, words, pair, scale):
        """The two real maps of pair ``pair`` of a drawn noise set: real and
        imaginary parts of ``ifft2(scale eta)``, stacked ``(2, n, n)``."""
        p = self.prec
        eta = torch.as_tensor(streams.natural_plane(words, pair,
                                                    self.grid.n),
                              device=self.dev)
        z = p.ifft2(p.q(scale * p.q(eta)))
        return torch.stack([z.real, z.imag])

    def sims(self, words3, pair):
        """Both sims of pair ``pair`` of a step whose three noise sets were
        drawn from ``words3`` (kappa, CMB coefficients, instrument noise):
        ``(cross, auto_in, auto - N0)`` binned ``(2, 3, nbins)`` and the
        raw auto ``(2, nbins)``, float64."""
        p, g, cfg = self.prec, self.grid, self.cfg
        kap = self._pair_maps(words3[0], pair, self.s_kk)
        K = p.fft2(kap)
        coeffs = self._pair_maps(words3[1], pair, self.s_cc)
        ay = p.ifft2(p.q(self.iphi_y * K)).real
        ax = p.ifft2(p.q(self.iphi_x * K)).real
        lensed = lens(coeffs, ay, ax, g.d, float(cfg["maxdisp_px"]), p)
        noise = self._pair_maps(words3[2], pair, self.s_ww)
        X = p.fft2(p.q(lensed + noise))
        fk = self.kappa(X)
        raw, debiased, cross, auto_in = self.spectra(fk, K)
        return torch.stack([cross, auto_in, debiased], dim=1), raw
