"""Plain full-sky reference of the curved-sky TT lensing reconstruction, in
float64 PyTorch and numpy (or the control's lower precision), written from
the definitions and not from the program.

* Rings: the ``n``-point Gauss-Legendre rule (the roots of ``P_n`` by
  Newton's method on the three-term recurrence, ``w = 2 / ((1 - x^2)
  P_n'(x)^2)``), ``n`` even and mirrored about the equator, ``nphi``
  equispaced longitudes from 0.
* Legendre functions: ``lambda_lm(theta) = sqrt((2l+1)/4pi (l-m)!/(l+m)!)
  P_lm(cos theta)`` with the Condon-Shortley phase, from ``lambda_mm =
  (-1)^m sqrt((2m+1)!!/(4pi (2m)!!)) sin^m theta`` and ``lambda_lm = a_lm
  (x lambda_{l-1,m} - lambda_{l-2,m} / a_{l-1,m})``, ``a_lm = sqrt((4l^2 -
  1)/(l^2 - m^2))``. Each (m, ring) lane is carried as ``mu 2^k`` (``k <=
  0`` a multiple of 256) from a seed scaled the same way, so nothing
  underflows before the lane's first value at or above :data:`TAU`, the
  underflow threshold: values before that l are zero, every value from it
  on is kept (:func:`live_starts` gives that l per lane).
* Transforms, folded on the northern rings with ``lambda_lm(pi - theta) =
  (-1)^(l+m) lambda_lm(theta)`` and blocked over m (the blocks' tables
  built once): synthesis ``T(theta, phi) = sum_lm a_lm lambda_lm e^{i m
  phi}`` (ring inverse FFTs), analysis ``a_lm = sum_t w_t (2 pi / nphi)
  lambda_lm(theta_t) sum_j T(theta_t, phi_j) e^{-i m phi_j}`` (ring FFTs).
* Estimator (the program's docstring, with the sign of its last two terms
  as repaired there): ``Tbar = F T``, ``W = C F T`` with ``F = 1/Ctot`` for
  ``lmin <= l <= lmax``; ``gbar_LM = [L(L+1) (Tbar W)_LM - (Tbar
  Lap W)_LM + (W Lap Tbar)_LM] / 2``, ``Lap X`` the map of ``-l(l+1)
  X_lm``; ``phi = gbar / R`` and ``kappa = L(L+1) phi / 2``, with ``1/R``
  and ``N0`` computed at the sampled Ls by the closed-form (l1 l2 L; 0 0
  0)^2 sums and interpolated linearly in L between them.
* Spectra: ``C_L = sum_m |a_Lm|^2 (m > 0 twice) / (2L + 1)``; bins ``e_i
  < L <= e_(i+1)``, each a (2L+1)-weighted mean (the mean over its modes).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .flat import ARCMIN, Prec

__all__ = ["TAU", "gl_rule", "lambda_tables", "live_starts", "Legendre",
           "sampled_Ls", "qe_sums", "bin_matrix", "total_spectrum",
           "CurvedQERef"]

TAU = 2.0 ** -40          # the underflow threshold of |lambda_lm|
_SCALE = 256              # the exponent step of the scaled lanes
_BIG = 2.0 ** _SCALE
_MBLOCK = 64              # m per block of the cached tables
_DROP = 32                # steps between drops of the started lanes


# ---- rings ----------------------------------------------------------------

def gl_rule(n: int):
    """``(x, w)`` of the ``n``-point Gauss-Legendre rule (``n`` even),
    ``x`` descending from the north pole, float64 numpy; the southern half
    is the mirror of the northern."""
    if n % 2:
        raise ValueError("the folded rings need an even count")
    h = n // 2
    x = np.cos(np.pi * (np.arange(1, h + 1) - 0.25) / (n + 0.5))
    for _ in range(100):
        p0, p1 = np.ones_like(x), x.copy()
        for k in range(2, n + 1):
            p0, p1 = p1, ((2 * k - 1) * x * p1 - (k - 1) * p0) / k
        dp = n * (x * p1 - p0) / (x * x - 1.0)
        dx = p1 / dp
        x = x - dx
        if np.max(np.abs(dx)) < 1e-15:
            break
    p0, p1 = np.ones_like(x), x.copy()
    for k in range(2, n + 1):
        p0, p1 = p1, ((2 * k - 1) * x * p1 - (k - 1) * p0) / k
    dp = n * (x * p1 - p0) / (x * x - 1.0)
    w = 2.0 / ((1.0 - x * x) * dp * dp)
    return np.concatenate([x, -x[::-1]]), np.concatenate([w, w[::-1]])


# ---- the scaled recurrence ----------------------------------------------------

def _seeds(lmax: int, x):
    """``(mu, k)``: ``lambda_mm(theta) = mu 2^k`` per (m, ring), float64 and
    int64 numpy ``(lmax + 1, len(x))``, ``2^-256 <= |mu| < 1`` where ``k <
    0``."""
    s = np.sqrt((1.0 - x) * (1.0 + x))
    mu = np.empty((lmax + 1, len(x)))
    k = np.zeros((lmax + 1, len(x)), dtype=np.int64)
    mu[0] = math.sqrt(1.0 / (4.0 * math.pi))
    for m in range(1, lmax + 1):
        v = mu[m - 1] * (-math.sqrt((2.0 * m + 1.0) / (2.0 * m)) * s)
        small = np.abs(v) < 1.0 / _BIG
        mu[m] = np.where(small, v * _BIG, v)
        k[m] = k[m - 1] - _SCALE * small
    return mu, k


@functools.lru_cache(maxsize=2)
def _coeffs(lmax: int, device: str):
    """``(a, c)`` ``(lmax + 1, lmax + 1)`` float64 on ``device``, indexed
    ``[l, m]``: ``a_lm`` and ``a_lm / a_{l-1,m}`` (0 at ``l = m + 1``),
    both 0 where ``l <= m``."""
    f64 = dict(dtype=torch.float64, device=device)
    l = torch.arange(lmax + 1, **f64)[:, None]
    m = torch.arange(lmax + 1, **f64)[None, :]
    live = l > m
    a = torch.where(live, torch.sqrt((4.0 * l * l - 1.0)
                                     / torch.where(live, l * l - m * m,
                                                   1.0)), 0.0)
    prev = torch.cat([torch.zeros_like(a[:1]), a[:-1]])
    two = l > m + 1
    c = torch.where(two, a / torch.where(two, prev, 1.0), 0.0)
    return a, c


def _advance(a, c, x, mu_p, mu_c, k):
    """One l-step of lanes with coefficients ``a``, ``c``: ``mu_n = a x
    mu_c - c mu_p``, both carries scaled by ``2^-256`` where ``mu_n`` grew
    past ``2^256`` (only lanes with ``k < 0`` can: ``|lambda_lm| <
    13``). Returns the new ``(mu_p, mu_c, k)``."""
    mu_p, mu_c = mu_c, (a * x) * mu_c - c * mu_p
    big = mu_c.abs() >= _BIG
    if bool(big.any()):
        f = torch.ones_like(mu_c).masked_fill_(big, 1.0 / _BIG)
        return mu_p * f, mu_c * f, k + _SCALE * big
    return mu_p, mu_c, k


def _value(mu, k):
    """``mu 2^k``, exact wherever it can reach :data:`TAU`."""
    return mu * torch.pow(2.0, k.to(mu.dtype))


def _threshold(k):
    """The ``|mu|`` at which a lane ``mu 2^k`` reaches :data:`TAU` (none
    below ``k = -256``: ``|mu| < 2^256``)."""
    f = lambda v: torch.tensor(v, dtype=torch.float64, device=k.device)
    return torch.where(k == 0, f(TAU), torch.where(k == -_SCALE,
                                                   f(TAU * _BIG), f(math.inf)))


def lambda_tables(lmax: int, x, device):
    """The tables of ``lambda_lm`` on the rings ``x`` (float64 numpy):
    ``(blocks, starts)``, ``blocks[b]`` ``(mb, lmax + 1 - m0, len(x))``
    float64 on ``device`` for the m in ``[m0, m0 + mb)``, ``m0 = 64 b``,
    and l from ``m0`` (zero where ``l < m`` or before the lane's start);
    ``starts`` ``(lmax + 1, len(x))`` the first l of each lane's values."""
    M1, nx = lmax + 1, len(x)
    f64 = dict(dtype=torch.float64, device=device)
    a, c = _coeffs(lmax, str(device))
    smu, sk = _seeds(lmax, np.asarray(x, np.float64))
    smu = torch.as_tensor(smu, **f64)
    sk = torch.as_tensor(sk, device=device)
    xt = torch.as_tensor(np.asarray(x, np.float64), **f64)
    mu_p = torch.zeros((M1, nx), **f64)
    mu_c = torch.zeros_like(mu_p)
    k = torch.zeros((M1, nx), dtype=torch.int64, device=device)
    started = torch.zeros((M1, nx), dtype=torch.bool, device=device)
    starts = torch.full((M1, nx), M1, dtype=torch.int64, device=device)
    blocks = [torch.zeros((min(_MBLOCK, M1 - m0), M1 - m0, nx), **f64)
              for m0 in range(0, M1, _MBLOCK)]
    for l in range(M1):
        if l:
            mu_p[:l], mu_c[:l], k[:l] = _advance(
                a[l, :l, None], c[l, :l, None], xt, mu_p[:l], mu_c[:l],
                k[:l])
        mu_p[l], mu_c[l], k[l] = 0.0, smu[l], sk[l]
        now = ~started[:l + 1] & (mu_c[:l + 1].abs()
                                  >= _threshold(k[:l + 1]))
        starts[:l + 1] = torch.where(now, l, starts[:l + 1])
        started[:l + 1] |= now
        row = torch.where(started[:l + 1], _value(mu_c[:l + 1], k[:l + 1]),
                          0.0)
        for b, m0 in enumerate(range(0, l + 1, _MBLOCK)):
            m1 = min(m0 + _MBLOCK, l + 1)
            blocks[b][:m1 - m0, l - m0] = row[m0:m1]
    return blocks, starts


def live_starts(lmax: int, x, device):
    """The first l at which ``|lambda_lm(theta)| >= TAU`` per (m, ring),
    ``(lmax + 1, len(x))`` int64 (``lmax + 1`` where no l <= lmax reaches
    it), by the same steps as :func:`lambda_tables` (:func:`_advance`), each
    lane stepped from its own seed until it starts; the lanes that started
    are dropped every :data:`_DROP` steps. Stepping only the lanes that
    have not started, it takes about a third of the tables' steps at lmax
    2047 on 1536 northern rings, where the work count needs it."""
    M1, nx = lmax + 1, len(x)
    f64 = dict(dtype=torch.float64, device=device)
    a, c = _coeffs(lmax, str(device))
    # by offset: [d, m] holds [m + d, m] (0 past lmax), a step's one row
    ms = torch.arange(M1, device=device)
    ls = ms[:, None] + ms[None, :]
    a, c = (torch.where(ls <= lmax, t[ls.clamp(max=lmax), ms], 0.0)
            for t in (a, c))
    smu, sk = _seeds(lmax, np.asarray(x, np.float64))
    xt = torch.as_tensor(np.asarray(x, np.float64), **f64)
    lane = torch.arange(M1 * nx, device=device)
    m = lane // nx
    mu_c = torch.as_tensor(smu, **f64).reshape(-1)
    k = torch.as_tensor(sk, device=device).reshape(-1)
    starts = torch.where(mu_c.abs() >= _threshold(k), m, M1)
    keep = (starts > lmax) & (m < lmax)
    lane, m, mu_c, k = (t[keep] for t in (lane, m, mu_c, k))
    first = torch.full_like(m, M1)      # the offset d of each lane's start
    xl = xt[lane % nx]
    mu_p = torch.zeros_like(mu_c)
    thr = _threshold(k)
    for d in range(1, M1):
        mu_p, mu_c, k1 = _advance(a[d][m], c[d][m], xl, mu_p, mu_c, k)
        if k1 is not k:
            k, thr = k1, _threshold(k1)
        first = torch.minimum(first, torch.where(mu_c.abs() >= thr, d, M1))
        if d % _DROP == 0 or d == M1 - 1:
            out = (m + first <= lmax) | (m + d >= lmax)
            starts[lane[out]] = torch.clamp_max(m[out] + first[out], M1)
            keep = ~out
            if not bool(keep.any()):
                break
            lane, m, xl, mu_p, mu_c, k, thr, first = (
                t[keep] for t in (lane, m, xl, mu_p, mu_c, k, thr, first))
    return starts.reshape(M1, nx)


# ---- the folded transforms ----------------------------------------------------

class Legendre:
    """Folded Legendre synthesis and analysis at ``lmax`` on the
    Gauss-Legendre rings ``x`` (all of them, north first), the northern
    rings' tables built once, blocked over m."""

    def __init__(self, lmax: int, x, device):
        self.lmax = lmax
        self.T = len(x)
        self.Th = self.T // 2
        self.device = device
        self.blocks, _ = lambda_tables(lmax, x[:self.Th], device)
        M1 = lmax + 1
        self.nalm = M1 * (M1 + 1) // 2
        self.idx, self.valid, self.even = [], [], []
        for b, m0 in enumerate(range(0, M1, _MBLOCK)):
            mb = self.blocks[b].shape[0]
            m = np.arange(m0, m0 + mb)[:, None]
            l = np.arange(m0, M1)[None, :]
            ok = l >= m
            packed = m * (2 * lmax + 1 - m) // 2 + l
            self.idx.append(torch.as_tensor(np.where(ok, packed, self.nalm),
                                            device=device))
            self.valid.append(torch.as_tensor(ok, device=device))
            self.even.append(torch.as_tensor((l + m) % 2 == 0,
                                             device=device))

    def synth(self, alm, prec: Prec):
        """``F[b, t, m] = sum_l lambda_lm(theta_t) a_lm`` of packed alms
        ``(B, nalm)`` on every ring, ``(B, T, lmax + 1)`` complex."""
        B = alm.shape[0]
        ext = torch.cat([alm.to(prec.complex),
                         torch.zeros((B, 1), dtype=prec.complex,
                                     device=alm.device)], dim=1)
        F = torch.zeros((B, self.T, self.lmax + 1), dtype=prec.complex,
                        device=alm.device)
        for b, tab in enumerate(self.blocks):
            m0, mb = b * _MBLOCK, tab.shape[0]
            A = ext[:, self.idx[b]]                          # (B, mb, Lb)
            ev = self.even[b]
            cols = torch.stack([torch.where(ev, A.real, 0.0),
                                torch.where(ev, A.imag, 0.0),
                                torch.where(ev, 0.0, A.real),
                                torch.where(ev, 0.0, A.imag)])
            cols = cols.permute(2, 3, 0, 1).reshape(mb, -1, 4 * B)
            out = torch.bmm(tab.to(prec.real).transpose(1, 2), cols)
            out = out.reshape(mb, self.Th, 4, B)
            E = torch.complex(out[:, :, 0], out[:, :, 1])   # (mb, Th, B)
            O = torch.complex(out[:, :, 2], out[:, :, 3])
            F[:, :self.Th, m0:m0 + mb] = (E + O).permute(2, 1, 0)
            F[:, self.Th:, m0:m0 + mb] = torch.flip(
                (E - O).permute(2, 1, 0), dims=(1,))
        return prec.q(F)

    def anal(self, G, prec: Prec):
        """``a_lm = sum_t lambda_lm(theta_t) G[b, t, m]`` of ``G`` ``(B, T,
        lmax + 1)`` complex (the weights already applied), packed ``(B,
        nalm)``."""
        B = G.shape[0]
        G = G.to(prec.complex)
        north = G[:, :self.Th]
        south = torch.flip(G[:, self.Th:], dims=(1,))
        S, D = north + south, north - south
        out = torch.zeros((B, self.nalm + 1), dtype=prec.complex,
                          device=G.device)
        for b, tab in enumerate(self.blocks):
            m0, mb = b * _MBLOCK, tab.shape[0]
            sl = slice(m0, m0 + mb)
            cols = torch.stack([S[:, :, sl].real, S[:, :, sl].imag,
                                D[:, :, sl].real, D[:, :, sl].imag])
            cols = cols.permute(3, 2, 0, 1).reshape(mb, self.Th, 4 * B)
            res = torch.bmm(tab.to(prec.real), cols)       # (mb, Lb, 4 B)
            res = res.reshape(mb, -1, 4, B)
            ev = self.even[b][:, :, None]
            val = torch.where(ev, torch.complex(res[:, :, 0], res[:, :, 1]),
                              torch.complex(res[:, :, 2], res[:, :, 3]))
            ok = self.valid[b]
            out[:, self.idx[b][ok]] = val[ok].T
        return prec.q(out[:, :self.nalm])


class Sphere:
    """Synthesis and analysis of real maps ``(B, T, nphi)`` on the
    Gauss-Legendre rings of ``ntheta`` rings and ``nphi`` longitudes."""

    def __init__(self, lmax: int, ntheta: int, nphi: int, device):
        if nphi < 2 * lmax + 1:
            raise ValueError("nphi must exceed 2 lmax")
        x, w = gl_rule(ntheta)
        self.lmax, self.nphi = lmax, nphi
        self.leg = Legendre(lmax, x, device)
        self.w = torch.as_tensor(w * (2.0 * math.pi / nphi),
                                 dtype=torch.float64, device=device)

    def alm2map(self, alm, prec: Prec):
        F = self.leg.synth(alm, prec)
        pad = self.nphi // 2 + 1 - F.shape[-1]
        F = torch.nn.functional.pad(F, (0, pad))
        return prec.q(torch.fft.irfft(F, n=self.nphi, dim=-1) * self.nphi)

    def map2alm(self, maps, prec: Prec):
        G = torch.fft.rfft(prec.q(maps), dim=-1)[..., :self.lmax + 1]
        G = prec.q(G * self.w.to(prec.real)[:, None])
        return self.leg.anal(G, prec)


# ---- the estimator's normalization ----------------------------------------------

def sampled_Ls(lmax: int):
    """The Ls at which the response and N0 are summed: every L to 64, then
    48 log-spaced from 65 to lmax (rounded down, distinct)."""
    lo = np.arange(1, min(64, lmax) + 1)
    if lmax <= 64:
        return lo
    hi = np.unique(np.geomspace(65, lmax, 48).astype(np.int64))
    return np.concatenate([lo, hi])


def _log_factorials(n: int):
    return np.array([math.lgamma(i + 1.0) for i in range(n + 1)])


def _w3j000_sq(l1, l2, L, lg):
    """``(l1 l2 L; 0 0 0)^2`` (Edmonds' closed form), zero off the
    triangle or for odd ``l1 + l2 + L``; int64 tensors, ``lg`` the log
    factorials."""
    J = l1 + l2 + L
    ok = (J % 2 == 0) & (l1 + l2 >= L) & (l1 + L >= l2) & (l2 + L >= l1)
    J = torch.where(ok, J, 0)
    g = J // 2
    z = lambda t: lg[torch.where(ok, t, 0)]
    expo = (z(J - 2 * l1) + z(J - 2 * l2) + z(J - 2 * L) - z(J + 1)
            + 2.0 * (z(g) - z(g - l1) - z(g - l2) - z(g - L)))
    return torch.where(ok, torch.exp(expo), 0.0)


def qe_sums(cl, ctot, lmax: int, lmin: int, Ls, device):
    """``(R_L, N0num_L)`` at ``Ls``, float64 numpy: with ``F = 1/Ctot``
    (``lmin <= l <= lmax``), ``W = C F``, ``K12 = [L(L+1) + l2(l2+1) -
    l1(l1+1)] / 2``, ``P = (2l1+1)(2l2+1) (l1 l2 L; 0 0 0)^2 / 4pi``:
    ``R = sum P K12 F1 W2 (K12 C2 + K21 C1)``, ``N0num = sum P K12 (K12 F1^2
    Ct1 W2^2 Ct2 + K21 F1 W1 Ct1 F2 W2 Ct2)``."""
    f64 = dict(dtype=torch.float64, device=device)
    ls = np.arange(lmax + 1)
    cl = np.asarray(cl, np.float64)[:lmax + 1]
    ct = np.asarray(ctot, np.float64)[:lmax + 1]
    F = np.where((ls >= lmin) & (ct > 0), 1.0 / np.where(ct > 0, ct, 1.0),
                 0.0)
    W = cl * F
    lg = torch.as_tensor(_log_factorials(3 * lmax + int(max(Ls)) + 2), **f64)
    li = torch.arange(lmax + 1, device=device)
    l1, l2 = li[:, None], li[None, :]
    t = lambda a: torch.as_tensor(a, **f64)
    ll = t(ls * (ls + 1.0))
    C, Ct, Fq, Wq = t(cl), t(ct), t(F), t(W)
    odd = t(2.0 * ls + 1.0)
    R, N = [], []
    for L in (int(v) for v in Ls):
        P = odd[:, None] * odd[None, :] * _w3j000_sq(l1, l2, L, lg) / (
            4.0 * math.pi)
        K12 = 0.5 * (L * (L + 1.0) + ll[None, :] - ll[:, None])
        K21 = 0.5 * (L * (L + 1.0) + ll[:, None] - ll[None, :])
        R.append(torch.sum(P * K12 * Fq[:, None] * Wq[None, :]
                           * (K12 * C[None, :] + K21 * C[:, None])))
        X = Fq * Wq * Ct
        N.append(torch.sum(P * K12 * (
            K12 * (Fq * Fq * Ct)[:, None] * (Wq * Wq * Ct)[None, :]
            + K21 * X[:, None] * X[None, :])))
    return torch.stack(R).cpu().numpy(), torch.stack(N).cpu().numpy()


def bin_matrix(edges, lmax: int):
    """``(nbins, lmax + 1)`` float64 numpy: row ``i`` the (2L+1)-weighted
    mean over ``edges[i] < L <= edges[i+1]``."""
    edges = np.asarray(edges, np.float64)
    L = np.arange(lmax + 1)
    inb = (L[None, :] > edges[:-1, None]) & (L[None, :] <= edges[1:, None])
    w = np.where(inb, 2.0 * L + 1.0, 0.0)
    return w / np.maximum(w.sum(1, keepdims=True), 1e-300)


def total_spectrum(cfg, cl):
    """``C + N / B^2`` per l: white noise of ``noise_uk_arcmin`` over a
    Gaussian beam of ``beam_arcmin`` FWHM, ``B_l = exp(-l(l+1) sigma^2 /
    2)``."""
    l = np.arange(len(cl), dtype=np.float64)
    sigma = cfg["beam_arcmin"] * ARCMIN / math.sqrt(8.0 * math.log(2.0))
    beam2 = np.exp(-l * (l + 1.0) * sigma * sigma)
    return np.asarray(cl, np.float64) + (
        cfg["noise_uk_arcmin"] * ARCMIN) ** 2 / beam2


class CurvedQERef:
    """The configuration's curved-sky TT estimator, debias and bins on
    ``device``; the transforms' tables are built at the first
    reconstruction and kept."""

    def __init__(self, cfg, tables, device):
        lmax, lmin = cfg["lmax"], cfg["lmin"]
        self.cfg, self.lmax, self.device = cfg, lmax, device
        cl = np.asarray(tables["lCl_TT"], np.float64)[:lmax + 1]
        ctot = total_spectrum(cfg, cl)
        ls = np.arange(lmax + 1, dtype=np.float64)
        sel = (ls >= lmin) & (ctot > 0)
        F = np.where(sel, 1.0 / np.where(ctot > 0, ctot, 1.0), 0.0)
        Ls = sampled_Ls(lmax)
        R, N0num = qe_sums(cl, ctot, lmax, lmin, Ls, device)
        rinv = np.where(R != 0, 1.0 / np.where(R != 0, R, 1.0), 0.0)
        n0phi = np.where(R != 0, N0num * rinv * rinv, 0.0)
        Lf = Ls.astype(np.float64)
        t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)
        self.F, self.W = t(F), t(cl * F)
        self.llp1 = t(ls * (ls + 1.0))
        self.rinv = t(np.interp(ls, Lf, rinv))
        self.n0 = t(np.interp(ls, Lf, (Lf * (Lf + 1.0) / 2.0) ** 2 * n0phi))
        b = cfg["bins"]
        self.bins = t(bin_matrix(np.arange(b["start"], b["stop"],
                                           float(b["step"])), lmax))
        ms = np.concatenate([np.full(lmax + 1 - m, m)
                             for m in range(lmax + 1)])
        self.l_of = torch.as_tensor(
            np.concatenate([np.arange(m, lmax + 1) for m in range(lmax + 1)]),
            device=device)
        self.mult = t(np.where(ms == 0, 1.0, 2.0))
        self.sphere = None

    def _xfl(self, alm, fl, prec):
        return prec.q(alm * prec.q(fl)[self.l_of])

    def kappa(self, talm, prec: Prec):
        """Packed kappa alms ``(B, nalm)`` of packed T alms ``(B, nalm)``."""
        if self.sphere is None:
            r = self.cfg["rings"]
            self.sphere = Sphere(self.lmax, r["ntheta"], r["nphi"],
                                 self.device)
        s, q = self.sphere, prec.q
        t = q(talm.to(self.device))
        tbar, w = self._xfl(t, self.F, prec), self._xfl(t, self.W, prec)
        lap = lambda a: self._xfl(a, -self.llp1, prec)
        maps = s.alm2map(torch.cat([tbar, w, lap(tbar), lap(w)]), prec)
        B = t.shape[0]
        mt, mw, lt, lw = (maps[i * B:(i + 1) * B] for i in range(4))
        p = s.map2alm(torch.cat([q(mt * mw), q(mt * lw), q(mw * lt)]), prec)
        p0, p1, p2 = (p[i * B:(i + 1) * B] for i in range(3))
        g = q(0.5 * q(self._xfl(p0, self.llp1, prec) - p1 + p2))
        phi = self._xfl(g, self.rinv, prec)
        return self._xfl(phi, 0.5 * self.llp1, prec)

    def spectra(self, talm, prec: Prec):
        """``(raw, debiased)``: the binned auto spectrum of each sim's kappa
        estimate and the same less the interpolated N0, ``(B, nbins)``
        float64."""
        q = prec.q
        k = self.kappa(talm, prec)
        pw = q(k.real * k.real + k.imag * k.imag) * q(self.mult)
        cl = torch.zeros((k.shape[0], self.lmax + 1), dtype=prec.real,
                         device=k.device)
        cl.index_add_(1, self.l_of, q(pw))
        cl = q(cl / q(2.0 * torch.arange(self.lmax + 1, device=k.device,
                                         dtype=prec.real) + 1.0))
        bins = q(self.bins)
        raw = q(cl @ bins.T).to(torch.float64)
        debiased = q(q(cl - q(self.n0)) @ bins.T).to(torch.float64)
        return raw, debiased
