"""Flat-sky quadratic lensing estimators (port of ``orphics_tpu.models.qe``):
the ``QE`` engine with its separable-term algebra, the normalization
``A_L``, the Gaussian noise ``N_L_kk``/``N_L_kk_cross``, the generic
reconstruction ``kappa_from_map``, the fused rfft half-plane TT path
``kappa_tt_rfft`` and the full-plane doubly-permuted TT path
``kappa_tt_pallas`` (on the port's DFT and mirror kernels, B3/B4/B7);
plus ``lensing_noise_2d``, the binned N0 curves of ``NlGenerator``, the
realization-dependent and Monte-Carlo N0 (``rdn0``, ``mcn0``) and the N1
bias of the TT estimator (``n1_tt``).

Conventions are the JAX package's (Hu & Okamoto 2002 couplings, "phys"
Fourier units ``T_phys = fft_raw * sqrt(area)/npix``, the mode-coupling
integral ``(npix/area) * fft[ifft(A) ifft(B)]``); see that module's
docstring. Every plane lives on the engine's ``device``; the cached
normalizations are computed eagerly there on first request.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .._device import resolve
from ..geometry import Geometry, arcmin
from ..ops import dft as D
from ..ops import fourier as F
from ..ops.binning import Bin2D
from ..ops.mirror import mirror_pp

__all__ = ["QE", "lensing_noise_2d", "NlGenerator", "rdn0", "mcn0", "n1_tt"]

ESTIMATORS = ("TT", "TE", "EE", "EB", "TB")
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


def _host(t):
    return t.detach().cpu().numpy()


class NlGenerator:
    """Binned N_L^0 curves for instrument configs
    (``NlGenerator(geom, theory, bin_edges).update_noise(...).get_nl()``)."""

    def __init__(self, geom: Geometry, theory, bin_edges, dtype=torch.float32,
                 device=None):
        self.geom = geom
        self.theory = theory
        self.device = resolve(device)
        self.binner = Bin2D(geom.modlmap_np(), bin_edges, device=self.device)
        self.dtype = dtype
        self._qe = None

    def update_noise(self, beam_arcmin, noise_t_uk_arcmin,
                     noise_p_uk_arcmin=None, tellmin=30, tellmax=3000,
                     pellmin=30, pellmax=5000, kmin=10, kmax=None):
        ctot = lensing_noise_2d(self.geom, self.theory, beam_arcmin,
                                noise_t_uk_arcmin, noise_p_uk_arcmin,
                                self.dtype, self.device)
        mask = lambda lo, hi: F.mask_kspace(self.geom, lmin=lo, lmax=hi,
                                            device=self.device)
        xt = mask(tellmin, tellmax)
        xp = mask(pellmin, pellmax)
        # one engine with per-field multipole masks: cross-N0 between a
        # T-leg and a P-leg estimator then carries each field's own cuts
        self._qe = QE(self.geom, self.theory, ctot, kmask=mask(kmin, kmax),
                      dtype=self.dtype, device=self.device,
                      field_masks={"T": xt, "E": xp, "B": xp})
        return self

    updateNoise = update_noise

    def _engine(self):
        if self._qe is None:
            raise RuntimeError("call update_noise(...) before querying "
                               "NlGenerator noise curves")
        return self._qe

    def _bin(self, n2d):
        """Binned curve of a 2D plane as host numpy (the binner's kernel
        takes float32 and sums in float64)."""
        cents, n1d = self.binner.bin(n2d.to(torch.float32))
        return cents, _host(n1d)

    def get_nl(self, est="TT"):
        return self._bin(self._engine().N_L_kk(est.upper()))

    getNl = get_nl

    def get_nl_cross(self, estA, estB):
        """Binned cross-N0 between two estimators (kappa convention)."""
        return self._bin(self._engine().N_L_kk_cross(estA.upper(),
                                                     estB.upper()))

    def get_nl_matrix(self, ests=("TT", "TE", "EE", "EB", "TB")):
        """Binned N0 covariance matrix between estimators, shape
        (nest, nest, nbins). Off-diagonals vanish for pairs that share
        no total cross-spectrum (e.g. TTxEB)."""
        ests = [e.upper() for e in ests]
        n = len(ests)
        mat = np.zeros((n, n, self.binner.nbins))
        for i in range(n):
            for j in range(i, n):
                mat[i, j] = mat[j, i] = self.get_nl_cross(ests[i], ests[j])[1]
        return np.asarray(self.binner.centers), mat

    def get_nl_mv(self, ests=("TT", "TE", "EE", "EB", "TB"),
                  naive=False):
        """Minimum-variance N_L^kk over estimators: ``N_mv(L) = 1 / sum_ij
        [N^-1(L)]_ij`` with N the per-bin estimator covariance including
        the cross-N0 terms; ``naive=True`` keeps ``1/N = sum 1/N_i``."""
        if naive:
            invs = []
            for est in ests:
                n2d = _host(self._engine().N_L_kk(est)).astype(np.float64)
                invs.append(1.0 / np.where(n2d > 0, n2d, np.inf))
            tot = np.sum(invs, axis=0)
            n_mv = 1.0 / np.where(tot > 0, tot, np.inf)
            return self._bin(torch.as_tensor(n_mv, device=self.device))
        cents, mat = self.get_nl_matrix(ests)
        nb = mat.shape[-1]
        # unusable bins are INFINITE noise (matching the naive branch);
        # 0 would read as infinite signal-to-noise downstream
        out = np.full(nb, np.inf)
        for b in range(nb):
            N = mat[:, :, b]
            good = np.diag(N) > 0
            if not np.any(good):
                continue
            Ng = N[np.ix_(good, good)]
            try:
                inv = np.linalg.inv(Ng)
            except np.linalg.LinAlgError:
                inv = np.linalg.pinv(Ng)
            tot = inv.sum()
            out[b] = 1.0 / tot if tot > 0 else np.inf
        return cents, out


# ---------------------------------------------------------------------
# Realization-dependent N0 (RDN0) and Monte-Carlo N0 (MCN0)
# ---------------------------------------------------------------------

def _kk_cl_fn(qe: "QE", bin_edges):
    """Binned kappa cross-power of two (batches of) raw-fft kappa maps."""
    binner = Bin2D(qe.geom.modlmap_np(), np.asarray(bin_edges, float),
                   device=qe.device)
    norm = float(qe.geom.area) / float(qe.geom.npix) ** 2

    def cl(A, B):
        return binner.bin(((A.conj() * B).real * norm).to(torch.float32))[1]

    return binner, cl


def _sim_chunks(sims, shift, chunk):
    """``(s, s')`` chunks of at most ``chunk`` sims with the cyclic pairing
    ``s'_i = s_{i + shift}``."""
    sims2 = torch.roll(sims, -shift, dims=0)
    return zip(sims.split(chunk), sims2.split(chunk))


def rdn0(qe: "QE", est: str, kdata, sim_kmaps, bin_edges,
         pair_shift: int = 1, chunk: int = 16):
    """Realization-dependent N0 debias for the quadratic estimator, the
    data-anchored Gaussian-noise estimate of Planck 2015 XV eq. 16, in
    kappa convention:

      RDN0(L) = < Cl(Q[d,s], Q[d,s]) + Cl(Q[d,s], Q[s,d])
                 + Cl(Q[s,d], Q[d,s]) + Cl(Q[s,d], Q[s,d])
                 - Cl(Q[s,s'], Q[s,s']) - Cl(Q[s,s'], Q[s',s]) >_s

    with d the (beam-deconvolved, raw-fft) data leg, s/s' independent
    Gaussian sims of the data covariance, and Q[a,b] the normalized
    two-leg kappa estimator. Sims are paired cyclically
    (``s'_i = s_{i+pair_shift}``) and taken ``chunk`` at a time: each chunk
    is four batched two-leg reconstructions.

    ``kdata``: (ny, nx) complex raw-fft data leg; ``sim_kmaps``: (nsims,
    ny, nx) complex raw-fft sim legs drawn from the data's total
    covariance, both on the engine's device. Returns ``(centers, rdn0_kk,
    mcn0_kk)`` as numpy; ``mcn0_kk`` is the pure sim-pair Monte-Carlo N0.
    """
    est = est.upper()
    nsims = sim_kmaps.shape[0]
    if nsims < 2:
        raise ValueError("rdn0 needs >= 2 sims for the s-s' pairs")
    binner, cl = _kk_cl_fn(qe, bin_edges)
    kd = kdata[None]
    t_data = t_mc = 0.0
    for s, s2 in _sim_chunks(sim_kmaps, int(pair_shift) % nsims, chunk):
        qds = qe.kappa_from_map(est, kd, s)
        qsd = qe.kappa_from_map(est, s, kd)
        qss = qe.kappa_from_map(est, s, s2)
        qs2s = qe.kappa_from_map(est, s2, s)
        t_data = t_data + (cl(qds, qds) + cl(qds, qsd) + cl(qsd, qds)
                           + cl(qsd, qsd)).sum(0)
        t_mc = t_mc + (cl(qss, qss) + cl(qss, qs2s)).sum(0)
    t_data, t_mc = _host(t_data) / nsims, _host(t_mc) / nsims
    return binner.centers, t_data - t_mc, t_mc


def mcn0(qe: "QE", est: str, sim_kmaps, bin_edges, pair_shift: int = 1,
         chunk: int = 16):
    """Monte-Carlo N0 from independent sim pairs alone (the
    ``- <Cl(Q[s,s'],...)>`` terms of :func:`rdn0` with a + sign):
    converges to the analytic ``QE.N_L_kk`` for matched spectra."""
    est = est.upper()
    nsims = sim_kmaps.shape[0]
    if nsims < 2:
        raise ValueError("mcn0 needs >= 2 sims")
    binner, cl = _kk_cl_fn(qe, bin_edges)
    t_mc = 0.0
    for s, s2 in _sim_chunks(sim_kmaps, int(pair_shift) % nsims, chunk):
        qss = qe.kappa_from_map(est, s, s2)
        qs2s = qe.kappa_from_map(est, s2, s)
        t_mc = t_mc + (cl(qss, qss) + cl(qss, qs2s)).sum(0)
    return binner.centers, _host(t_mc) / nsims


# ---------------------------------------------------------------------
# N1 bias of the TT estimator
# ---------------------------------------------------------------------

def _iso_profile(geom, grid2d):
    """(l, value) samples of an isotropic 2D Fourier grid, taken along
    its ly=0 row: exact whenever the grid is a function of modlmap
    (interpolated 1D spectra, annulus masks). Sorted and deduped for
    ``np.interp``."""
    ml = geom.modlmap_np()[0]
    vals = _host(grid2d)[0] if isinstance(grid2d, torch.Tensor) \
        else np.asarray(grid2d)[0]
    order = np.argsort(ml, kind="stable")
    lu, idx = np.unique(ml[order], return_index=True)
    return lu, vals[order][idx]


def _embed_pad(P, pad):
    """Zero-embed FFT-ordered l-lattice grids into a ``pad``-times finer
    Brillouin zone (same dl, pad*Nyquist): fftshift -> symmetric zero
    pad -> ifftshift. Every original lattice point keeps its frequency,
    so transforms on the embedded lattice are exact continuations."""
    if pad == 1:
        return P
    ny, nx = P.shape[-2:]
    wy = (ny * (pad - 1)) // 2
    wx = (nx * (pad - 1)) // 2
    Pc = torch.fft.fftshift(P, dim=(-2, -1))
    Pc = torch.nn.functional.pad(Pc, (wx, wx, wy, wy))
    return torch.fft.ifftshift(Pc, dim=(-2, -1))


def n1_tt(qe: "QE", Ls, clkk, ells=None, pad: int = 2):
    """Flat-sky N1 lensing bias of the TT estimator, kappa convention: the
    O(C^phiphi) connected-trispectrum bias of Kesden, Cooray &
    Kamionkowski 2003 (eq. 12),

      N1(L) = 2 A(L)^2 int d^2l1/(2pi)^2 d^2l3/(2pi)^2
              F(l1,l2) F(l3,l4) C^pp(|l1+l3|) f(l1,l3) f(l2,l4)

    with l2 = L - l1, l4 = -L - l3, f the TT lensing response and F the
    estimator's own filtered weights (leg masks and total spectra taken
    from the engine). Evaluated exactly on the estimator's Fourier
    lattice: f(l1,l3) and f(l2,l4) split into 6 separable components
    each, the C^pp coupling is opened with its transform C~(x), and every
    l-integral collapses to a 2D FFT: 6 batched-(6) FFT pairs per L. The
    x-space sum implements the lattice Kronecker delta, so ``pad=2``
    doubles the Brillouin zone (same dl) to keep l1+l3 un-aliased; with it
    the result equals the direct 4D lattice sum.

    L is taken along the x axis and the engine's leg masks / total spectra
    are radialized from their ly=0 row: exact for annulus masks and
    1D-interpolated spectra. The grids are built on the host in float64;
    the FFT pairs run on the engine's device in its dtype.

    ``Ls``: output multipoles (within the lattice band); ``clkk``: C_L^kk
    over ``ells`` (default ``arange(len(clkk))``). Returns ``(Ls, n1_kk)``
    as numpy.
    """
    geom = qe.geom
    clkk = np.asarray(clkk, np.float64)
    ells = (np.arange(clkk.size, dtype=np.float64) if ells is None
            else np.asarray(ells, np.float64))
    lsafe = np.where(ells > 0, ells, 1.0)
    clpp = np.where(ells > 0, 4.0 * clkk / lsafe ** 4, 0.0)

    # 1D profiles of the engine's own weights (see the isotropy note)
    lt_c, cltt_t = _iso_profile(geom, qe.cl2d["TT"])
    _, ct_v = _iso_profile(geom, qe.ctot["TT"])
    if qe.field_masks is not None:
        m1_l, m1_v = _iso_profile(geom, qe.field_masks["T"])
        m2_l, m2_v = m1_l, m1_v
    else:
        m1_l, m1_v = _iso_profile(geom, qe.gmask)
        m2_l, m2_v = _iso_profile(geom, qe.ymask)
    ct_safe = np.where(ct_v > 0, ct_v, 1.0)
    w1_t = np.where(ct_v > 0, m1_v / ct_safe, 0.0)
    w2_t = np.where(ct_v > 0, m2_v / ct_safe, 0.0)
    _cl = lambda m: np.interp(m, lt_c, cltt_t, left=0.0, right=0.0)
    _w1 = lambda m: np.interp(m, m1_l, w1_t, left=0.0, right=0.0)
    _w2 = lambda m: np.interp(m, m2_l, w2_t, left=0.0, right=0.0)

    ny, nx = geom.shape
    ml_np = geom.modlmap_np()
    dly, dlx = float(ml_np[1, 0]), float(ml_np[0, 1])
    iy = np.fft.fftfreq(ny) * ny
    ix = np.fft.fftfreq(nx) * nx
    ly_np = (dly * iy)[:, None] + 0.0 * ix[None, :]
    lx_np = 0.0 * iy[:, None] + (dlx * ix)[None, :]
    # C^pp on the pad-times Brillouin zone (same dl): this is where
    # |l1+l3| lands, un-aliased for pad >= 2
    fy = np.fft.fftfreq(pad * ny) * pad * ny * dly
    fx = np.fft.fftfreq(pad * nx) * pad * nx * dlx
    cpp_pad = np.interp(np.hypot(fy[:, None], fx[None, :]), ells, clpp,
                        left=0.0, right=0.0)
    pref = 2.0 * (pad * pad * geom.npix / float(geom.area)) ** 2

    # L-independent l1/l3-side factors of the separable split
    # f(la, lb) = C(la)(|la|^2 + la.lb) + C(lb)(|lb|^2 + la.lb)
    # = sum_a u_a(la) v_a(lb) with the component pairing below
    C1 = _cl(ml_np)
    W1g = _w1(ml_np)
    one = np.ones_like(ml_np)
    U = np.stack([C1 * ml_np ** 2, C1 * lx_np, C1 * ly_np,
                  lx_np, ly_np, one])
    V = np.stack([one, lx_np, ly_np, C1 * lx_np, C1 * ly_np,
                  C1 * ml_np ** 2])
    put = lambda x: torch.as_tensor(x, dtype=qe.dtype, device=qe.device)
    Ug, Vg = put(U), put(V)
    cph = torch.fft.ifft2(put(cpp_pad))

    def core(grids):
        """6 batched-(6) FFT pairs + the C~(x)-weighted x-sum."""
        F12, F34 = grids[0], grids[1]
        U2, V2 = grids[2:8], grids[8:14]
        acc = 0.0
        for a in range(6):
            Ia = torch.fft.ifft2(_embed_pad(F12 * Ug[a] * U2, pad))
            Ja = torch.fft.ifft2(_embed_pad(F34 * Vg[a] * V2, pad))
            acc = acc + (cph * (Ia * Ja).sum(0)).sum().real
        return pref * acc

    Ls = np.asarray(Ls, np.float64)
    aL = np.empty(Ls.size)
    n1_phi = np.empty(Ls.size)
    for i, Lx in enumerate(Ls):
        l2x = Lx - lx_np
        l4x = -Lx - lx_np
        ml2 = np.hypot(l2x, ly_np)
        ml4 = np.hypot(l4x, ly_np)
        C2, C4 = _cl(ml2), _cl(ml4)
        f12 = C1 * (Lx * lx_np) + C2 * (Lx * l2x)
        F12 = 0.5 * f12 * W1g * _w2(ml2)
        F34 = 0.5 * (C1 * (-Lx * lx_np) + C4 * (-Lx * l4x)) \
            * W1g * _w2(ml4)
        # A_L on the host from the same radialized tables, evaluated
        # exactly at this L instead of a row interpolation of qe.A_L
        invA = (f12 * F12).sum() / float(geom.area)
        aL[i] = 1.0 / invA if invA != 0 else 0.0
        grids = np.stack(
            [F12, F34,
             C2 * ml2 ** 2, C2 * l2x, C2 * (-ly_np), l2x, -ly_np, one,
             one, l4x, -ly_np, C4 * l4x, C4 * (-ly_np), C4 * ml4 ** 2])
        n1_phi[i] = float(core(put(grids)))
    return Ls, (Ls ** 4 / 4.0) * aL ** 2 * n1_phi
