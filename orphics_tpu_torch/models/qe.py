"""Flat-sky quadratic lensing estimators (port of ``orphics_tpu.models.qe``):
the ``QE`` engine with its separable-term algebra, the normalization
``A_L``, the Gaussian noise ``N_L_kk``/``N_L_kk_cross``, the generic
reconstruction ``kappa_from_map``, the fused rfft half-plane TT path
``kappa_tt_rfft`` and the full-plane doubly-permuted TT path
``kappa_tt_pallas`` (on the port's DFT and mirror kernels, B3/B4/B7);
plus ``lensing_noise_2d``.

Conventions are the JAX package's (Hu & Okamoto 2002 couplings, "phys"
Fourier units ``T_phys = fft_raw * sqrt(area)/npix``, the mode-coupling
integral ``(npix/area) * fft[ifft(A) ifft(B)]``); see that module's
docstring. Every plane lives on the engine's ``device``; the cached
normalizations are computed eagerly there on first request.

``NlGenerator``, ``rdn0``, ``mcn0`` and ``n1_tt`` are not ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .._device import resolve
from ..geometry import Geometry, arcmin
from ..ops import dft as D
from ..ops import fourier as F
from ..ops.mirror import mirror_pp

__all__ = ["QE", "lensing_noise_2d"]

LEG_FIELDS = {"TT": ("T", "T"), "TE": ("T", "E"), "EE": ("E", "E"),
              "EB": ("E", "B"), "TB": ("T", "B")}


def _ifft(a):
    return torch.fft.ifft2(a, dim=(-2, -1))


def _fft(a):
    return torch.fft.fft2(a, dim=(-2, -1))


class QE:
    """Quadratic estimator engine for one (geometry, theory, noise) config.

    ``ctot2d`` maps 'TT'/'EE'/'BB' to total (signal + noise) 2D spectra of
    the beam-deconvolved maps (see :func:`lensing_noise_2d`); ``xmask``,
    ``ymask`` are leg masks, ``kmask`` the output-L mask, ``field_masks``
    optional per-field leg masks (exclusive with xmask/ymask/grad_cut).
    """

    def __init__(self, geom: Geometry, theory, ctot2d: Dict[str, object],
                 xmask=None, ymask=None, kmask=None, dtype=torch.float32,
                 device=None, grad_cut: Optional[float] = None,
                 te_filter: str = "hu_ok", te_series_order: int = 4,
                 field_masks=None):
        self.geom = geom
        self.dtype = dtype
        self.device = resolve(device)
        self.te_filter = te_filter
        self.te_series_order = int(te_series_order)
        if field_masks is not None and (
                xmask is not None or ymask is not None
                or grad_cut is not None):
            raise ValueError(
                "field_masks replaces xmask/ymask/grad_cut entirely — "
                "pass one or the other, not both")
        as_t = lambda v: torch.as_tensor(v, dtype=dtype, device=self.device)
        self.field_masks = None if field_masks is None else {
            k: as_t(v) for k, v in field_masks.items()}
        modlmap_np = geom.modlmap_np()
        ells = np.arange(theory.lpad + 1)
        self.cl2d = {}
        for spec in ("TT", "EE", "BB", "TE"):
            cl = np.asarray(theory.lCl(spec, ells), dtype=np.float64)
            self.cl2d[spec] = as_t(np.interp(modlmap_np, ells, cl, left=0,
                                             right=0))
        one = torch.ones(geom.shape, dtype=dtype, device=self.device)
        self.xmask = one if xmask is None else as_t(xmask)
        self.ymask = self.xmask if ymask is None else as_t(ymask)
        self.kmask = one if kmask is None else as_t(kmask)
        ml = geom.modlmap(dtype, self.device)
        if grad_cut is not None:
            self.gmask = self.xmask * (ml <= grad_cut)
        else:
            self.gmask = self.xmask
        self.ctot = {k: as_t(v) for k, v in ctot2d.items()}
        lmap = geom.lmap(dtype, self.device)
        self.ly, self.lx = lmap[0], lmap[1]
        self.modlmap = ml
        safe = torch.where(ml > 0, ml, 1.0)
        zero = torch.zeros((), dtype=dtype, device=self.device)
        self.cos2phi = torch.where(ml > 0, (self.lx ** 2 - self.ly ** 2)
                                   / safe ** 2, zero)
        self.sin2phi = torch.where(ml > 0, 2.0 * self.lx * self.ly
                                   / safe ** 2, zero)
        self._phys = float(geom.area) ** 0.5 / geom.npix
        self._conv_fac = geom.npix / float(geom.area)
        self._cache = {}

    # -- mode-coupling integral ---------------------------------------
    def _conv(self, A, B):
        """integral d^2l1/(2pi)^2 A(l1) B(L - l1) on the grid."""
        return _fft(_ifft(A) * _ifft(B)) * self._conv_fac

    # -- normalization -------------------------------------------------
    def A_L(self, est: str):
        """2D phi normalization ``A_L = [integral f F]^(-1)`` (cached)."""
        est = est.upper()
        if est not in self._cache:
            inv = self._fF_integral(est)
            zero = torch.zeros((), dtype=inv.dtype, device=self.device)
            al = torch.where(inv.abs() > 1e-30, 1.0 / inv, zero).real
            self._cache[est] = al.to(self.dtype)
        return self._cache[est]

    def N_L_kk(self, est: str):
        """2D Gaussian reconstruction noise N_L^0 for kappa."""
        return self.N_L_kk_cross(est, est)

    # -- separable-term algebra ------------------------------------------
    # Every coupling f and filter F is a sum of terms (dot_leg, ang, w1,
    # w2): (L . l_{dot_leg}) * ang(dphi) * w1(l1) * w2(l2), with ang in
    # {'1','c','s'} = {1, cos 2(phi1-phi2), sin 2(phi1-phi2)}.

    def _one(self):
        return torch.ones((), dtype=self.dtype, device=self.device)

    def _f_terms(self, est):
        """Lensing response coupling f (Hu & Okamoto 2002 Table 1)."""
        C = self.cl2d
        one = self._one()
        if est == "TT":
            return [(1, "1", C["TT"], one), (2, "1", one, C["TT"])]
        if est == "TE":
            return [(1, "c", C["TE"], one), (2, "1", one, C["TE"])]
        if est == "TB":
            return [(1, "s", C["TE"], one)]
        if est == "EE":
            return [(1, "c", C["EE"], one), (2, "c", one, C["EE"])]
        if est == "EB":
            return [(1, "s", C["EE"], one), (2, "s", one, -C["BB"])]
        raise ValueError(f"unknown estimator {est}")

    @staticmethod
    def _swap_terms(terms):
        """Terms of F(l2, l1) from those of F(l1, l2)."""
        out = []
        for (d, a, w1, w2) in terms:
            w1n, w2n = w2, w1
            if a == "s":
                w1n = -w1n
            out.append((3 - d, a, w1n, w2n))
        return out

    @staticmethod
    def _scale_terms(terms, s1, s2):
        return [(d, a, w1 * s1, w2 * s2) for (d, a, w1, w2) in terms]

    def _filter_terms(self, est):
        """Estimator weights F as a term list: f / (2 C1tot C2tot) for TT
        and EE, f / (C1tot C2tot) for TB/EB, the full Hu-Okamoto TE series
        (or f/(Ctt1 Cee2) with ``te_filter='hdv'``); leg masks folded in."""
        est = est.upper()
        f1, f2 = LEG_FIELDS[est]
        if self.field_masks is not None:
            m1 = self.field_masks[f1]
            m2 = self.field_masks[f2]
        else:
            m1, m2 = self.gmask, self.ymask
        zero = torch.zeros((), dtype=self.dtype, device=self.device)

        def _inv(ct):
            return torch.where(ct > 0, 1.0 / torch.where(ct > 0, ct, 1.0), zero)
        ct1 = self.ctot[f1 + f1]
        ct2 = self.ctot[f2 + f2]
        norm = 2.0 if est in ("TT", "EE") else 1.0
        if est != "TE" or self.te_filter == "hdv":
            return self._scale_terms(self._f_terms(est), m1 * _inv(norm * ct1),
                                     m2 * _inv(ct2))
        ctt, cee, cte = self.ctot["TT"], self.ctot["EE"], self.cl2d["TE"]
        ictt, icee = _inv(ctt), _inv(cee)
        r2 = cte ** 2 * ictt * icee
        fterms = self._f_terms(est)
        fswap = self._swap_terms(fterms)
        out = []
        for k in range(self.te_series_order + 1):
            xk = r2 ** k
            out += self._scale_terms(fterms, xk * m1 * ictt, xk * m2 * icee)
            out += self._scale_terms(fswap, -xk * cte * ictt * icee * m1,
                                     xk * cte * ictt * icee * m2)
        return out

    def _angle_pairs(self, a):
        """Separable (u1, u2, coef) expansion of the angle factor."""
        c, s = self.cos2phi, self.sin2phi
        one = self._one()
        if a == "1":
            return [(one, one, 1.0)]
        if a == "c":
            return [(c, c, 1.0), (s, s, 1.0)]
        if a == "s":
            return [(s, c, 1.0), (c, s, -1.0)]
        raise ValueError(a)

    @staticmethod
    def _is_zero(w):
        return bool((w == 0).all())

    def _pair_integral(self, termsA, termsB):
        """integral d^2 l1/(2pi)^2 [termsA](l1, L-l1) [termsB](l1, L-l1)."""
        Li = (self.ly, self.lx)
        out = 0.0
        for (dA, aA, w1A, w2A) in termsA:
            if self._is_zero(w1A) or self._is_zero(w2A):
                continue
            for (dB, aB, w1B, w2B) in termsB:
                if self._is_zero(w1B) or self._is_zero(w2B):
                    continue
                for (u1a, u2a, ca) in self._angle_pairs(aA):
                    for (u1b, u2b, cb) in self._angle_pairs(aB):
                        W1 = w1A * w1B * u1a * u1b
                        W2 = w2A * w2B * u2a * u2b
                        coef = ca * cb
                        # each leg carries at most one Li factor per side:
                        # transform the three variants per leg once
                        i1, i2 = {}, {}
                        if dA == 2 and dB == 2:
                            i1[()] = _ifft(W1)
                        if dA == 1 and dB == 1:
                            i2[()] = _ifft(W2)
                        if dA != dB:
                            for i in range(2):
                                i1[(i,)] = _ifft(W1 * Li[i])
                                i2[(i,)] = _ifft(W2 * Li[i])
                        if dA == 1 and dB == 1:
                            for i in range(2):
                                for j in range(i, 2):
                                    sym = 1.0 if i == j else 2.0
                                    x1 = _ifft(W1 * Li[i] * Li[j])
                                    out = out + (sym * coef * Li[i] * Li[j]
                                                 * self._conv_fac) \
                                        * _fft(x1 * i2[()])
                        elif dA == 2 and dB == 2:
                            for i in range(2):
                                for j in range(i, 2):
                                    sym = 1.0 if i == j else 2.0
                                    x2 = _ifft(W2 * Li[i] * Li[j])
                                    out = out + (sym * coef * Li[i] * Li[j]
                                                 * self._conv_fac) \
                                        * _fft(i1[()] * x2)
                        else:
                            for i in range(2):
                                for j in range(2):
                                    a1 = i1[(i,)] if dA == 1 else i1[(j,)]
                                    a2 = i2[(i,)] if dA == 2 else i2[(j,)]
                                    out = out + (coef * Li[i] * Li[j]
                                                 * self._conv_fac) \
                                        * _fft(a1 * a2)
        return out

    def _fF_integral(self, est):
        """integral d^2 l1/(2pi)^2 f F (the inverse normalization)."""
        return self._pair_integral(self._f_terms(est), self._filter_terms(est))

    def _ctot_cross(self, fa, fb):
        """Total cross-spectrum of two fields (TB and EB vanish)."""
        if fa == fb:
            return self.ctot[fa + fb]
        if "".join(sorted(fa + fb)) == "ET":
            return self.cl2d["TE"]
        return None

    def N0_phi_cross(self, estA, estB):
        """Gaussian reconstruction-noise cross-spectrum N_L^{phi,AB}
        (Hu-Okamoto 2002 eq. 17 generalized); cached, symmetric in A, B."""
        estA, estB = estA.upper(), estB.upper()
        key = ("n0",) + tuple(sorted((estA, estB)))
        if key not in self._cache:
            FA = self._filter_terms(estA)
            FB = self._filter_terms(estB)
            fa, fb = LEG_FIELDS[estA], LEG_FIELDS[estB]
            total = 0.0
            c11 = self._ctot_cross(fa[0], fb[0])
            c22 = self._ctot_cross(fa[1], fb[1])
            if c11 is not None and c22 is not None:
                total = total + self._pair_integral(
                    FA, self._scale_terms(FB, c11, c22))
            c12 = self._ctot_cross(fa[0], fb[1])
            c21 = self._ctot_cross(fa[1], fb[0])
            if c12 is not None and c21 is not None:
                total = total + self._pair_integral(
                    FA, self._scale_terms(self._swap_terms(FB), c12, c21))
            if isinstance(total, float):
                n0 = torch.zeros(self.geom.shape, dtype=self.dtype,
                                 device=self.device)
            else:
                # A_B * total ~ 1 first: A_A * A_B alone falls below the
                # fp32 normal range at high L (A_L ~ 1e-20), where a
                # flush-to-zero backend (XLA on CPU and TPU) zeroes N0
                n0 = (self.A_L(estA) * (self.A_L(estB) * total.real)).to(
                    self.dtype)
            self._cache[key] = n0 * self.kmask
        return self._cache[key]

    def N_L_kk_cross(self, estA, estB):
        """kappa-convention cross N0: (L^2/2)^2 N^{phi,AB}."""
        return (self.modlmap ** 4 / 4.0) * self.N0_phi_cross(estA, estB)

    # -- reconstruction --------------------------------------------------
    def unnormalized_phi(self, est, kx, ky):
        """integral F X Y as FFT products; ``kx, ky`` are raw-fft k-maps of
        the beam-deconvolved legs. Linear appearances of sin 2(phi1-phi2)
        carry an extra -1 (the JAX package's angle convention)."""
        est = est.upper()
        key = ("F", est)
        if key not in self._cache:
            # the non-zero filter terms, found once: testing a plane for
            # zero reads it back to the host
            self._cache[key] = [t for t in self._filter_terms(est)
                                if not (self._is_zero(t[2])
                                        or self._is_zero(t[3]))]
        X = kx * self._phys
        Y = ky * self._phys
        Li = (self.ly, self.lx)
        out = 0.0
        for (d, a, w1, w2) in self._cache[key]:
            for (u1, u2, c) in self._angle_pairs(a):
                if a == "s":
                    c = -c
                A1 = u1 * w1 * X
                A2 = u2 * w2 * Y
                for i in range(2):
                    B1, B2 = A1, A2
                    if d == 1:
                        B1 = B1 * Li[i]
                    else:
                        B2 = B2 * Li[i]
                    out = out + (c * Li[i]) * self._conv(B1, B2)
        return out

    def kappa_from_map(self, est, kx, ky=None, return_ft: bool = True):
        """Reconstruct kappa from raw-fft k-map legs; returns the raw-fft
        kappa (or the real map with ``return_ft=False``)."""
        if ky is None:
            ky = kx
        uphi = self.unnormalized_phi(est, kx, ky)
        phi = self.A_L(est) * uphi * self.kmask * (float(self.geom.area) ** 0.5)
        fkappa_raw = 0.5 * self.modlmap ** 2 * phi / self._phys
        if return_ft:
            return fkappa_raw
        return _ifft(fkappa_raw).real

    # -- fused half-plane TT path ----------------------------------------
    def _tt_half_plans(self):
        """The rfft half-plane filter planes of the fused TT
        reconstruction (cached): ``(wa0, wag, wb0, wbg, post, Lh, sym)``.

        For a real observed map every real-space leg is real, so the
        estimator runs on the half-plane. The gradient legs
        ifft(l_i C w X) are purely imaginary; :meth:`kappa_tt_rfft` folds
        a ``-1j`` into the input to make them real. On the Nyquist row and
        column that leg is self-conjugate and the fold has no valid
        decomposition, so the gradient filter is zeroed there.
        """
        if "_tt_half" in self._cache:
            return self._cache["_tt_half"]
        nxr = self.geom.nx // 2 + 1
        half = lambda A: A[..., :nxr].contiguous()
        C = self.cl2d["TT"]
        ct = self.ctot["TT"]
        if self.field_masks is not None:
            m1 = m2 = self.field_masks["T"]
        else:
            m1, m2 = self.gmask, self.ymask
        sym = bool(torch.equal(m1, m2))
        phys = self._phys
        zero = torch.zeros((), dtype=self.dtype, device=self.device)
        w1 = torch.where(ct > 0, m1 / (2.0 * torch.where(ct > 0, ct, 1.0)), zero)
        w2 = torch.where(ct > 0, m2 / torch.where(ct > 0, ct, 1.0), zero)
        nyq = torch.ones(self.geom.shape, dtype=self.dtype, device=self.device)
        nyq[self.geom.ny // 2, :] = 0.0
        nyq[:, self.geom.nx // 2] = 0.0
        wa0 = half(w1 * phys)
        wag = torch.stack([half(self.ly * C * w1 * nyq * phys),
                           half(self.lx * C * w1 * nyq * phys)])
        if sym:
            wb0 = wbg = None
        else:
            wb0 = half(w2 * phys)
            wbg = torch.stack([half(self.ly * C * w2 * nyq * phys),
                               half(self.lx * C * w2 * nyq * phys)])
        post = half(self.A_L("TT") * self.kmask * 0.5 * self.modlmap ** 2
                    * (float(self.geom.area) ** 0.5 / self._phys)
                    * self._conv_fac)
        Lh = torch.stack([half(self.ly), half(self.lx)])
        plans = (wa0, wag, wb0, wbg, post.to(self.dtype), Lh, sym)
        self._cache["_tt_half"] = plans
        return plans

    def kappa_tt_rfft(self, xh, yh=None):
        """Fused TT kappa reconstruction on the rfft half-plane.

        ``xh`` (and optional second leg ``yh``): raw ``rfft2`` k-maps of
        the real beam-deconvolved observed map(s), ``(..., ny, nx//2+1)``.
        Returns the raw-fft half-plane kappa, equal to
        ``kappa_from_map("TT", fft2(map))[..., :nx//2+1]`` wherever the leg
        masks exclude the Nyquist modes.
        """
        geom = self.geom
        wa0, wag, wb0, wbg, post, Lh, sym = self._tt_half_plans()
        same = yh is None or yh is xh
        if yh is None:
            yh = xh
        xg = -1j * xh
        a = F.irfft2(wa0 * xh, geom)
        alpha = F.irfft2(wag * xg[..., None, :, :], geom)     # (..., 2, ny, nx)
        if sym and same:
            S = 4.0 * a[..., None, :, :] * alpha
        else:
            yg = -1j * yh
            if sym:
                b = 2.0 * F.irfft2(wa0 * yh, geom)
                beta = 2.0 * F.irfft2(wag * yg[..., None, :, :], geom)
            else:
                b = F.irfft2(wb0 * yh, geom)
                beta = F.irfft2(wbg * yg[..., None, :, :], geom)
            S = alpha * b[..., None, :, :] + a[..., None, :, :] * beta
        Sk = F.rfft2(S, geom)
        uphi = 1j * (Lh[0] * Sk[..., 0, :, :] + Lh[1] * Sk[..., 1, :, :])
        return post * uphi

    # -- full-plane doubly-permuted TT path -------------------------------
    def _tt_pp_plans(self):
        """The doubly-permuted full-plane filter planes of
        :meth:`kappa_tt_pallas` (cached): ``(wA, wX, Ly, Lx, post)``.

        The spectrum of the packed ``(a + i alpha_y)`` leg pair is
        ``(wa0 + i wag_y)(-i fold) Z = (wa0 + wag_y) Z``: the ``-1j``
        Hermitian fold and the ``i`` of the packing cancel, so one real
        plane ``wA`` filters both legs. The gradient leg is zeroed on the
        Nyquist row and column (see :meth:`_tt_half_plans`).
        """
        if "_tt_pp" in self._cache:
            return self._cache["_tt_pp"]
        n = self.geom.nx
        if not (self.geom.ny == n and n % 128 == 0 and n >= 256):
            raise ValueError("the full-plane TT path requires a square "
                             f"128*B grid (B >= 2); got {self.geom.shape}")
        if self.field_masks is not None:
            m1 = m2 = self.field_masks["T"]
        else:
            m1, m2 = self.gmask, self.ymask
        if not torch.equal(m1, m2):
            raise ValueError("the full-plane TT path implements the "
                             "symmetric-mask estimator")
        C = self.cl2d["TT"]
        ct = self.ctot["TT"]
        phys = self._phys
        zero = torch.zeros((), dtype=self.dtype, device=self.device)
        w1 = torch.where(ct > 0, m1 / (2.0 * torch.where(ct > 0, ct, 1.0)),
                         zero)
        host = lambda A: A.to(torch.float64).cpu().numpy()
        wa0 = host(w1 * phys)
        wagy = host(self.ly * C * w1 * phys)
        wagx = host(self.lx * C * w1 * phys)
        for w in (wagy, wagx):
            w[n // 2, :] = 0.0
            w[:, n // 2] = 0.0
        postf = host(self.A_L("TT") * self.kmask * 0.5 * self.modlmap ** 2
                     * (float(self.geom.area) ** 0.5 / self._phys)
                     * self._conv_fac)
        perm, _ = D.row_perm(n)
        pp = lambda A: torch.as_tensor(np.ascontiguousarray(
            np.asarray(A)[perm][:, perm], np.float32), device=self.device)
        plans = (pp(wa0 + wagy), pp(wagx), pp(host(self.ly)),
                 pp(host(self.lx)), pp(postf))
        self._cache["_tt_pp"] = plans
        return plans

    def kappa_tt_pallas(self, zr, zi):
        """Fused TT reconstruction in the doubly-permuted layout, on the
        port's DFT (B3/B4) and mirror (B7) kernels.

        ``zr, zi``: ``(B, n, n)`` float32 re/im planes of the raw
        full-plane fft2 of real beam-deconvolved observed maps in the
        ``fft2pp`` layout, Hermitian per map, ``B`` even. Returns the
        kappa planes ``(B, n, n)`` re/im in the same layout:
        ``natural(out) == kappa_from_map("TT", fft2(map))`` to fp32
        accuracy. Per map: 1.5 inverse and 1 forward complex 2D
        transforms and one mirror:

        * one ``ifft2pp`` gives the ``a`` and ``alpha_y`` legs as Re/Im
          of one complex map (filter ``wa0 + wag_y``);
        * the ``alpha_x`` legs of consecutive maps pack pairwise into one
          ``ifft2pp`` (spectrum ``wag_x (-i Z1 + Z2)``);
        * the source planes ``S_y, S_x`` go through one ``fft2pp`` as
          Re/Im and are split with ``mirror_pp``.
        """
        wA, wX, Ly, Lx, post = self._tt_pp_plans()
        B = zr.shape[0]
        if B % 2:
            raise ValueError("kappa_tt_pallas packs maps in pairs: the batch "
                             f"must be even, got {B}")
        # (a + i alpha_y) per map: one real filter, one inverse
        m_r, m_i = D.ifft2pp(wA * zr, wA * zi)
        # alpha_x legs packed across consecutive maps
        xr = wX * zr
        xi = wX * zi
        pr = xi[0::2] + xr[1::2]
        pi = xi[1::2] - xr[0::2]
        del xr, xi
        ax_r, ax_i = D.ifft2pp(pr, pi)
        del pr, pi
        ax = torch.stack([ax_r, ax_i], dim=1).reshape(zr.shape)
        del ax_r, ax_i
        Sy = 4.0 * m_r * m_i
        Sx = 4.0 * m_r * ax
        del m_r, m_i, ax
        Nr, Ni = D.fft2pp(Sy, Sx)
        del Sy, Sx
        Nmr, Nmi = mirror_pp(Nr, Ni)
        g1r = 0.5 * (Nr + Nmr)
        g1i = 0.5 * (Ni - Nmi)
        g2r = 0.5 * (Ni + Nmi)
        g2i = 0.5 * (Nmr - Nr)
        ur = -(Ly * g1i + Lx * g2i)
        ui = Ly * g1r + Lx * g2r
        return post * ur, post * ui


def lensing_noise_2d(geom: Geometry, theory, beam_arcmin, noise_t_uk_arcmin,
                     noise_p_uk_arcmin=None, dtype=torch.float32, device=None):
    """Total 2D spectra of beam-deconvolved maps, ``C_l + N_l / b_l^2``,
    built in float64 on the host and returned on ``device``."""
    if noise_p_uk_arcmin is None:
        noise_p_uk_arcmin = np.sqrt(2.0) * noise_t_uk_arcmin
    modlmap = geom.modlmap_np()
    ells = np.arange(theory.lpad + 1)
    b2 = F.gauss_beam(modlmap, beam_arcmin) ** 2
    out = {}
    for spec, noise in (("TT", noise_t_uk_arcmin), ("EE", noise_p_uk_arcmin),
                        ("BB", noise_p_uk_arcmin)):
        cl = np.interp(modlmap, ells, np.asarray(theory.lCl(spec, ells)),
                       left=0, right=0)
        n2d = (noise * arcmin) ** 2 / np.maximum(b2, 1e-30)
        out[spec] = torch.as_tensor(cl + n2d, dtype=dtype,
                                    device=resolve(device))
    return out
