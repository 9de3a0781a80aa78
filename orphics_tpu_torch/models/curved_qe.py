"""Curved-sky (full-sky) TT quadratic lensing estimator (port of
``orphics_tpu.models.curved_qe``).

The Okamoto-Hu 2003 TT estimator on the full sphere, built from scalar
(spin-0) spherical-harmonic transforms only, through the identity

    grad(Tbar) . grad(W) = [ Lap(Tbar W) - Tbar Lap(W) - W Lap(Tbar) ] / 2

(exact on S^2). One reconstruction is one stacked synthesis of four maps
(B10s) and one analysis of three product maps (B10a), both folded on
Gauss-Legendre rings.

Estimator (phi convention):

    gbar_LM = - int dOmega Y_LM* div(Tbar grad W)
            = [ L(L+1) (Tbar W)_LM - (Tbar LapW)_LM + (W LapTbar)_LM ] / 2

with Tbar = F_l T_lm (inverse-variance leg, F = 1/Ctot) and W = W_l T_lm
(Wiener gradient leg, W_l = C_l/Ctot_l). Its exact full-sky response
<gbar_LM> = R_L phi_LM is a closed double-l sum

    R_L = (1/4pi) sum_{l1 l2} (2l1+1)(2l2+1) w3j(l1,l2,L)^2
          K(l1,l2) F_{l1} W_{l2} [ K(l1,l2) C_{l2} + K(l2,l1) C_{l1} ]

with K(l1,l2) = [L(L+1) + l2(l2+1) - l1(l1+1)]/2 and w3j the (l1 l2 L; 0 0
0) Wigner 3j in closed log-factorial form. The Gaussian reconstruction
noise of the normalized estimator is

    N0_L = (1/4pi R_L^2) sum (2l1+1)(2l2+1) w3j^2 K(l1,l2)
           [ K(l1,l2) Pbar_{l1} Pw_{l2} + K(l2,l1) X_{l1} X_{l2} ]

with Pbar = F^2 Ctot, Pw = W^2 Ctot, X = F W Ctot.

The sign of the last two terms of gbar differs from the JAX function's
(``orphics_tpu/models/curved_qe.py:204`` returns ``0.5 (L(L+1) p0 + p1 -
p2)``). Integrating by parts, -div(Tbar grad W) = -Tbar LapW - grad(Tbar) .
grad(W), and the identity above turns that into the line given; with the
JAX sign the estimator couples t_l1 w_l2 through K(l2, l1), not the
K(l1, l2) of ``R_L``, and ``qtt`` / ``CurvedQE`` are misnormalized by an
L-dependent factor (ROADMAP queue C). The sums, ``response_tt``,
``n0_tt`` and ``grad_dot`` equal the JAX functions.

Quadrature: ``qtt_bar`` and ``grad_dot`` analyse products of band-lmax
maps, whose degree is up to 3 lmax. The rings must integrate that exactly,
``sht.gauss_legendre_rings(ceil(3 lmax / 2))`` (nphi >= 3 lmax + 1) or
finer; on ``gauss_legendre_rings(lmax)`` the product aliases (ROADMAP
queue C). The functions take the caller's rings, as the JAX ones do.

The sums run as float64 tensor code on a device (the card unless
``device`` names another, ``_device.resolve``) and return numpy, as the
JAX module's host sums do; the estimator's tensors follow ``talm``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .._device import as_tensor, resolve
from ..ops import alm as almops
from ..ops import sht
from ..utils.profiling import span, spanned

__all__ = ["qtt_bar", "qtt", "response_tt", "n0_tt", "CurvedQE",
           "grad_dot"]


# ---------------------------------------------------------------------------
# Exact response / N0: closed-form squared 3j sums (float64 on a device)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=4)
def _lgfact(nmax: int, device: str):
    """log(n!) table, n = 0..nmax, float64 on ``device``: scipy's
    ``gammaln`` on the host (the JAX module's table), copied, so that every
    device sums the same table. The exponent of a 3j symbol is a sum of
    such terms of up to ~10^4 whose result is O(10), so an ulp of a term
    is ~1e-12 of the symbol; ``torch.lgamma`` is not scipy's to the ulp
    (``python tests/test_torch_curved_qe.py`` prints the difference)."""
    from scipy.special import gammaln
    lg = gammaln(np.arange(nmax + 1, dtype=np.float64) + 1.0)
    return torch.as_tensor(lg, dtype=torch.float64, device=device)


def _w3j000_sq(l1, l2, L, lg):
    """(l1 l2 L; 0 0 0)^2 in closed form (Edmonds): zero unless the
    triangle holds and J = l1+l2+L is even; else
      w^2 = exp( lg[J-2l1] + lg[J-2l2] + lg[J-2L] - lg[J+1]
                 + 2(lg[J/2] - lg[J/2-l1] - lg[J/2-l2] - lg[J/2-L]) ).
    Broadcast over int64 tensors ``l1``, ``l2`` on ``lg``'s device."""
    J = l1 + l2 + L
    ok = ((J % 2 == 0) & (l1 + l2 >= L) & (l1 + L >= l2)
          & (l2 + L >= l1))
    Js = torch.where(ok, J, 0)
    h = Js // 2
    a1 = torch.where(ok, Js - 2 * l1, 0)
    a2 = torch.where(ok, Js - 2 * l2, 0)
    a3 = torch.where(ok, Js - 2 * L, 0)
    b1 = torch.where(ok, h - l1, 0)
    b2 = torch.where(ok, h - l2, 0)
    b3 = torch.where(ok, h - L, 0)
    t = lg.take
    expo = (t(a1) + t(a2) + t(a3) - t(Js + 1)
            + 2.0 * (t(h) - t(b1) - t(b2) - t(b3)))
    return torch.where(ok, torch.exp(expo), 0.0)


def _filters(cl, ctot, lmax, lmin):
    """(cl, ctot, F, W) float64 numpy: the spectra cut to lmax, the
    inverse-variance filter F = 1/ctot (0 below lmin or where ctot <= 0)
    and the Wiener filter W = cl F."""
    cl = np.asarray(cl, np.float64)[: lmax + 1]
    ctot = np.asarray(ctot, np.float64)[: lmax + 1]
    ls = np.arange(lmax + 1)
    F = np.zeros(lmax + 1)
    sel = (ls >= lmin) & (ctot > 0)
    F[sel] = 1.0 / ctot[sel]
    return cl, ctot, F, cl * F


def _qtt_sums(cl, ctot, lmax, Ls, lmin=2, chunk=256, device=None):
    """The (R_L, N0num_L) double-l sums for the TT divergence estimator.
    ``cl``: lensed TT used in the Wiener leg and the response coupling;
    ``ctot``: total (beam-deconvolved signal + noise) spectrum filtering
    both legs. Float64 on ``device`` in chunks of ``chunk`` l1 rows (one L
    at a time); returns numpy."""
    dev = resolve(device)
    cl, ctot, F, Wl = _filters(cl, ctot, lmax, lmin)
    Ls = np.asarray(Ls, np.int64)
    lg = _lgfact(3 * lmax + int(Ls.max()) + 2, str(dev))
    f64 = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)
    ls = torch.arange(lmax + 1, dtype=torch.int64, device=dev)
    llp1 = f64(np.arange(lmax + 1) * (np.arange(lmax + 1) + 1.0))
    cl_t, F_t, W_t = f64(cl), f64(F), f64(Wl)
    Pbar = f64(F * F * ctot)         # <|Tbar|^2>
    Pw = f64(Wl * Wl * ctot)         # <|W|^2>
    X = f64(F * Wl * ctot)           # <Tbar W*>
    w1 = 2.0 * ls.to(torch.float64) + 1.0
    R, N0num = [], []
    for L in Ls.tolist():
        LL = float(L * (L + 1))
        r = n = torch.zeros((), dtype=torch.float64, device=dev)
        for s in range(0, lmax + 1, chunk):
            e = min(s + chunk, lmax + 1)
            w2 = _w3j000_sq(ls[s:e, None], ls[None, :], L, lg)
            pref = w1[s:e, None] * w1[None, :] * w2 / (4.0 * np.pi)
            K12 = 0.5 * (LL + llp1[None, :] - llp1[s:e, None])
            K21 = 0.5 * (LL + llp1[s:e, None] - llp1[None, :])
            g = pref * K12 * F_t[s:e, None] * W_t[None, :]
            r = r + torch.sum(g * (K12 * cl_t[None, :]
                                   + K21 * cl_t[s:e, None]))
            n = n + torch.sum(pref * K12 * (K12 * Pbar[s:e, None]
                                            * Pw[None, :]
                                            + K21 * X[s:e, None]
                                            * X[None, :]))
        R.append(r)
        N0num.append(n)
    return (torch.stack(R).cpu().numpy(), torch.stack(N0num).cpu().numpy())


def _default_Ls(lmax):
    """Sampled L grid for the exact sums (interpolated in between):
    dense at low L where R_L curves, log-spaced above."""
    lo = np.arange(1, min(64, lmax) + 1)
    if lmax <= 64:
        return lo
    hi = np.unique(np.geomspace(65, lmax, 48).astype(np.int64))
    return np.concatenate([lo, hi])


def _n0_from(R, N0num):
    """N0num / R^2 where R != 0, else 0."""
    good = R != 0
    out = np.zeros(R.size)
    out[good] = N0num[good] / R[good] ** 2
    return out


def response_tt(cl, ctot, lmax, Ls=None, lmin=2, device=None):
    """Exact full-sky response R_L of :func:`qtt_bar`:
    <gbar_LM> = R_L phi_LM. Returns (Ls, R), numpy; the sums run on
    ``device`` (the card unless it names another)."""
    Ls = _default_Ls(lmax) if Ls is None else np.asarray(Ls, np.int64)
    R, _ = _qtt_sums(cl, ctot, lmax, Ls, lmin=lmin, device=device)
    return Ls, R


def n0_tt(cl, ctot, lmax, Ls=None, lmin=2, device=None):
    """Exact disconnected (Gaussian) noise bias N0_L of the NORMALIZED
    estimator :func:`qtt` in phi convention. Returns (Ls, N0), numpy; the
    sums run on ``device``."""
    Ls = _default_Ls(lmax) if Ls is None else np.asarray(Ls, np.int64)
    R, N0num = _qtt_sums(cl, ctot, lmax, Ls, lmin=lmin, device=device)
    return Ls, _n0_from(R, N0num)


# ---------------------------------------------------------------------------
# The estimator itself (scalar SHTs only)
# ---------------------------------------------------------------------------

def _interp_fl(Ls, vals, lmax):
    """1D tables sampled at Ls -> dense (lmax+1) filter, linear in L
    between the samples (host float64, numpy)."""
    ls = np.arange(lmax + 1, dtype=np.float64)
    out = np.interp(ls, np.asarray(Ls, np.float64), vals)
    out[: int(Ls[0])] = vals[0] if Ls[0] <= 1 else 0.0
    return out


def _rinv_dense(Ls, R, lmax):
    """1/R (0 where R = 0) from the sampled Ls to every l <= lmax."""
    rinv = np.zeros(R.size)
    rinv[R != 0] = 1.0 / R[R != 0]
    return _interp_fl(Ls, rinv, lmax)


@functools.lru_cache(maxsize=16)
def _llp1(lmax, dtype, device: str):
    """l(l+1), l = 0..lmax, in ``dtype`` on ``device`` (cached: a host copy
    per call would stall the stream)."""
    ls = np.arange(lmax + 1, dtype=np.float64)
    return torch.as_tensor(ls * (ls + 1.0), dtype=dtype, device=device)


def _leg(fl, like):
    """A per-l filter in ``like``'s real dtype on its device: a tensor is
    cast, a host array goes through float64 as the JAX function's does."""
    if not torch.is_tensor(fl):
        fl = torch.as_tensor(np.asarray(fl, np.float64))
    return fl.to(device=like.device, dtype=like.real.dtype)


def _stack(a_alm, b_alm, lmax):
    """(the 4 B stacked alms [a, b, -l(l+1) a, -l(l+1) b], l(l+1)): the
    legs whose maps :func:`_products` multiplies."""
    llp1 = _llp1(lmax, a_alm.real.dtype, str(a_alm.device))
    return torch.stack([a_alm, b_alm, almops.almxfl(a_alm, -llp1),
                        almops.almxfl(b_alm, -llp1)]), llp1


def _products(alms, rings, lmax, fast):
    """The three analyses both estimators share: with A, B the maps of the
    first two of :func:`_stack`'s legs and LapX the map of -l(l+1) X_lm,
    the alms of (A B, A LapB, B LapA). One synthesis of the 4 B stacked
    alms, one analysis of the 3 B products (B = the leading batch size)."""
    with span("orphics.curved_qe.synth"):
        m = sht.alm2map(alms, rings, lmax, fast=fast)
    with span("orphics.curved_qe.products"):
        prods = torch.stack([m[0] * m[1], m[0] * m[3], m[1] * m[2]])
    with span("orphics.curved_qe.analysis"):
        return sht.map2alm(prods, rings, lmax, fast=fast)


def _qtt_bar(talm, rings, lmax, fl, wl, fast, post=()):
    """:func:`qtt_bar` of a tensor ``talm`` with the filters already in its
    real dtype on its device, then the per-l factors ``post`` applied in
    turn (the normalization, the kappa factor), in the estimator's stage
    spans."""
    with span("orphics.curved_qe.legs"):
        alms, llp1 = _stack(almops.almxfl(talm, fl),
                            almops.almxfl(talm, wl), lmax)
    p = _products(alms, rings, lmax, fast)
    with span("orphics.curved_qe.combine"):
        out = 0.5 * (almops.almxfl(p[0], llp1) - p[1] + p[2])
        for fl_post in post:
            out = almops.almxfl(out, fl_post)
        return out


def qtt_bar(talm, rings, lmax, fl, wl, fast=False):
    """UNNORMALIZED TT estimator gbar_LM (phi convention, see the module
    docstring; the sign of the JAX function's last two terms repaired).
    ``talm`` (..., nalm) healpy-packed; ``fl``/``wl`` are the (lmax+1) leg
    filters (typically 1/Ctot and Cl/Ctot; zeros where excluded). The rings
    must be exact to degree 3 lmax (module docstring). Scalar SHTs only:
    one B10s launch of the 4 B stacked maps and one B10a launch of the
    3 B products, up to 16 maps a launch."""
    talm = torch.as_tensor(talm)
    return _qtt_bar(talm, rings, lmax, _leg(fl, talm), _leg(wl, talm), fast)


def qtt(talm, rings, lmax, cl, ctot, lmin=2, Ls=None, norm="phi",
        fast=False, device=None):
    """Normalized full-sky TT lensing reconstruction.

    Parameters
    ----------
    talm : observed (beam-deconvolved) T alms, healpy packing.
    cl, ctot : lensed TT theory and total (signal+noise) spectra.
    norm : 'phi' or 'kappa' output convention.
    device : where the sums run (and a host array ``talm`` goes); by
        default ``talm``'s device, for a host array the card.

    Returns (phi_or_kappa_alm, (Ls, N0)) with N0 in the SAME
    convention, exact (no flat approximation).
    """
    talm = as_tensor(talm, device)
    _, _, F, wl = _filters(cl, ctot, lmax, lmin)
    Ls = _default_Ls(lmax) if Ls is None else np.asarray(Ls, np.int64)
    R, N0num = _qtt_sums(cl, ctot, lmax, Ls, lmin=lmin,
                         device=talm.device if device is None else device)
    n0 = _n0_from(R, N0num)
    gbar = qtt_bar(talm, rings, lmax, F, wl, fast=fast)
    phi = almops.almxfl(gbar, _leg(_rinv_dense(Ls, R, lmax), gbar))
    if norm == "kappa":
        phi = almops.almxfl(phi, 0.5 * _llp1(lmax, phi.real.dtype,
                                             str(phi.device)))
        Lsf = Ls.astype(np.float64)
        n0 = (Lsf * (Lsf + 1.0) / 2.0) ** 2 * n0
    return phi, (Ls, n0)


def grad_dot(a_alm, b_alm, rings, lmax, fast=False):
    """grad(a) . grad(b) of two scalar fields as alms, via the same
    scalar identity the estimator uses: (Lap(ab) - a Lap b - b Lap a)/2.
    It is also the exact first-order lensing delta: deltaT =
    grad(phi) . grad(T). The rings must be exact to degree 3 lmax."""
    alms, llp1 = _stack(torch.as_tensor(a_alm), torch.as_tensor(b_alm),
                        lmax)
    p = _products(alms, rings, lmax, fast)
    return 0.5 * (almops.almxfl(p[0], -llp1) - p[1] - p[2])


class CurvedQE:
    """Precomputed curved-sky TT reconstruction engine: build once (exact
    R_L / N0_L tables, numpy float64, the sums on ``device``: the card
    unless it names another), reconstruct many (the tensors follow
    ``talm``). The curved analog of ``models/qe.QE`` for TT."""

    def __init__(self, rings, lmax, cl, ctot, lmin=2, Ls=None, device=None):
        self.rings, self.lmax, self.lmin = rings, int(lmax), int(lmin)
        self.device = resolve(device)
        self.cl, self.ctot, self.fl, self.wl = _filters(cl, ctot, lmax, lmin)
        self.Ls = (_default_Ls(lmax) if Ls is None
                   else np.asarray(Ls, np.int64))
        self.R, self.N0num = _qtt_sums(self.cl, self.ctot, lmax, self.Ls,
                                       lmin=lmin, device=self.device)
        self.n0_phi = _n0_from(self.R, self.N0num)
        self._rinv_dense = _rinv_dense(self.Ls, self.R, lmax)
        self._legs = {}

    def _filters_on(self, like):
        """(fl, wl, 1/R) in ``like``'s real dtype on its device, cached."""
        key = (str(like.device), like.real.dtype)
        if key not in self._legs:
            self._legs[key] = tuple(_leg(f, like) for f in (
                self.fl, self.wl, self._rinv_dense))
        return self._legs[key]

    def _estimate(self, talm, fast, kappa):
        """phi_LM, or kappa_LM = L(L+1)/2 phi_LM, in the span
        ``orphics.curved_qe.phi_from_alm`` (the kappa factor applied last,
        in the combine stage)."""
        with span("orphics.curved_qe.phi_from_alm"):
            talm = as_tensor(talm, self.device)
            fl, wl, rinv = self._filters_on(talm)
            post = (rinv,)
            if kappa:
                post += (0.5 * _llp1(self.lmax, talm.real.dtype,
                                     str(talm.device)),)
            return _qtt_bar(talm, self.rings, self.lmax, fl, wl, fast, post)

    def phi_from_alm(self, talm, fast=False):
        return self._estimate(talm, fast, kappa=False)

    @spanned("orphics.curved_qe.kappa_from_alm")
    def kappa_from_alm(self, talm, fast=False):
        return self._estimate(talm, fast, kappa=True)

    def n0(self, norm="phi"):
        if norm == "phi":
            return self.Ls, self.n0_phi
        Lsf = self.Ls.astype(np.float64)
        return self.Ls, (Lsf * (Lsf + 1.0) / 2.0) ** 2 * self.n0_phi
