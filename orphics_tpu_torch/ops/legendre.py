"""The Legendre step of the SHT: kernels B10a (analysis) and B10s
(synthesis), their plain versions and their tables (counterpart of
``orphics_tpu/ops/pallas_sht.py``, with the recurrence's host tables of
``orphics_tpu/ops/sht.py``). The transforms that use them are in
:mod:`.sht`.

* :func:`legendre_ana` / :func:`legendre_syn` (``csrc/legendre.cu``):
  ``out[b, l, m] = sum_t Lambda_lm(theta_t) G[b, t, m]`` and ``acc[b, t, m]
  = sum_l Lambda_lm(theta_t) a[b, l, m]``. The kernels run the three-term
  recurrence in float64 (``fast``: float32 with the extended exponent, its
  factor ``a x + b`` rounded once from float64 ``a`` and ``x``), from
  per-(ring, m) seeds captured at ``l_s`` (the first l whose value the
  weighting keeps), over per-(m, 32-ring group) loop bounds with the
  dead-group skip, and on north-south symmetric grids over the northern
  rings only; the contractions run on the fp64 tensor cores. B10a takes
  one of two forms by the grid (:func:`_ana_plan`): on folded grids of
  1025-2048 kernel rings a cluster of blocks sums every ring of an m on
  chip in one pass, elsewhere blocks of ring groups whose float64 partial
  planes the wrapper sums.
* :func:`legendre_ana_ref` / :func:`legendre_syn_ref`: the plain float64
  loop over l from the closed-form seeds at ``l0 = max(m, |n|)`` with the
  extended-exponent counter, over every ring, with no captured seeds and no
  group bounds. So holding a kernel to its plain version also holds the
  capture pass and the skip tables. With ``fast=True`` (float32 inputs)
  they are the fast mode's plain version instead: the kernels' algorithm
  (captured seeds, loop bounds, fold) with their float32 recurrence, each
  fused multiply-add rounded once as the kernel's is, and float64 sums
  (:func:`_kernel_ana`, :func:`_kernel_syn`).

For CPU tensors the wrappers run the plain versions; for CUDA tensors they
launch the kernel or raise. There is no fallback from one to the other.

Layouts. By default both transforms take and give (B, rows, M1) ring
matrices and (B, L1, M1) alm matrices. The scalar SHT
(:func:`~orphics_tpu_torch.ops.sht.map2alm` /
:func:`~orphics_tpu_torch.ops.sht.alm2map` on the card) passes its
neighbours' layouts instead, so that no pass sits between an alm, a kernel
and cuFFT: B10a reads the ring FFT's half spectrum in place (its first M1
columns), with the ring phase ``exp(-i m phi0)`` and the quadrature weights
applied on load (each ring weighted before the north-south fold), and
writes healpy-packed alms; B10s reads packed alms and writes the half
spectrum that the inverse ring FFT reads, ``exp(i m phi0)`` applied on
store and the columns past M1 zero. ``ring_io`` counts those launches.

Table layouts (:func:`tables`): ``"full"`` (every ring; asymmetric grids),
``"fold"`` (spin 0 on a symmetric grid: the kernel runs the northern rings
and contracts the even/odd north-south combinations, the plain version runs
every ring) and ``"half"`` (the northern rings only; the spin fold, whose
reflection couples n to -n, pairs two such transforms in
:func:`~orphics_tpu_torch.ops.sht.map2alm_spin` /
:func:`~orphics_tpu_torch.ops.sht.alm2map_spin`).
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..utils.profiling import spanned
from . import alm as almops

__all__ = ["tables", "kernel_tables", "clear_tables", "legendre_ana",
           "legendre_ana_ref", "legendre_syn", "legendre_syn_ref"]

# Extended-exponent parameters: true value = mantissa * 2**(-30 * e).
_RESCALE_BITS = 30
_INV = float(2.0 ** -_RESCALE_BITS)
_TH = float(2.0 ** (_RESCALE_BITS // 2))
_TG = 32       # rings per group of the loop bounds, csrc/legendre.cu TG
_LC = 16       # l-steps per chunk, csrc/legendre.cu LC
_MAXB = 16     # maps per launch
_ANA_RINGS = 512     # rings per B10a block and slot (16 warps of 32)
_ANA1_RINGS = 256    # rings per block of the one-pass B10a (8 warps of 32)
_ANA_CLUSTER = 8     # blocks per cluster of the one-pass B10a, at most


# ---------------------------------------------------------------------------
# Wigner-d seeds and recurrence coefficients (host, float64)
# ---------------------------------------------------------------------------

def _seed_log_coeff(m: np.ndarray, n: int):
    """Per-m seed of the l-recursion at ``l0 = max(m, |n|)``, where the
    Wigner sum collapses to one term: ``s exp(logC) cos(t/2)^pc
    sin(t/2)^ps``. Returns (sign, logC, pc, ps, l0) over m."""
    from scipy.special import gammaln

    m = np.asarray(m, np.int64)
    l0 = np.maximum(m, abs(n))
    k0 = np.maximum(0, n - m)
    lf = lambda v: gammaln(np.asarray(v, np.float64) + 1.0)
    logC = 0.5 * (lf(l0 + m) + lf(l0 - m) + lf(l0 + n) + lf(l0 - n)) \
        - lf(l0 + n - k0) - lf(k0) - lf(m - n + k0) - lf(l0 - m - k0)
    sign = np.where((m - n + k0) % 2 == 0, 1.0, -1.0)
    pc = 2 * l0 + n - m - 2 * k0
    ps = m - n + 2 * k0
    logC = logC + 0.5 * np.log((2 * l0 + 1) / (4.0 * np.pi))
    return sign, logC, pc.astype(np.int64), ps.astype(np.int64), l0


def _recur_coeffs(l: np.ndarray, m: np.ndarray, n: int):
    """Coefficients of ``Lambda_l = (A x + B) Lambda_{l-1} + C
    Lambda_{l-2}`` (Varshalovich 4.8.28 with the sqrt((2l+1)/4pi)
    normalization), zero for l <= l0 (the seed is injected there), with
    the singular cell (l=1, m=0, n=0) set to ``Lambda_1 = sqrt(3) x
    Lambda_0``."""
    l = np.asarray(l, np.float64)[:, None]
    m = np.asarray(m, np.float64)[None, :]
    nn = float(n)
    with np.errstate(divide="ignore", invalid="ignore"):
        u_l = np.sqrt((l * l - m * m) * (l * l - nn * nn))
        u_lm1 = np.sqrt(((l - 1) ** 2 - m * m) * ((l - 1) ** 2 - nn * nn))
        denom = (l - 1) * u_l
        A = (2 * l - 1) * (l - 1) * l / denom
        B = -(2 * l - 1) * m * nn / denom
        C = -l * u_lm1 / denom
        r1 = np.sqrt((2 * l + 1) / (2 * l - 1))
        r2 = np.sqrt((2 * l + 1) / np.maximum(2 * l - 3, 1e-300))
        A = A * r1
        B = B * r1
        C = C * r2
        if n == 0:
            sing = (l == 1) & (m == 0)
            A = np.where(sing, np.sqrt(3.0), A)
            B = np.where(sing, 0.0, B)
            C = np.where(sing, 0.0, C)
        inactive = l <= np.maximum(np.abs(m), abs(nn))
        A = np.where(inactive, 0.0, A)
        B = np.where(inactive, 0.0, B)
        C = np.where(inactive, 0.0, C)
    A = np.nan_to_num(A, nan=0.0, posinf=0.0, neginf=0.0)
    B = np.nan_to_num(B, nan=0.0, posinf=0.0, neginf=0.0)
    C = np.nan_to_num(C, nan=0.0, posinf=0.0, neginf=0.0)
    return A, B, C


@functools.lru_cache(maxsize=32)
def _wigner_tables_np(lmax: int, ns: tuple):
    """Recurrence tables for the n-values in ``ns``: A, B, C ``(len(ns),
    lmax+1, lmax+1)`` over (l, m); seed_sign, seed_logC, seed_pc, seed_ps,
    l0 ``(len(ns), lmax+1)`` over m."""
    m = np.arange(lmax + 1)
    A = []; B = []; C = []; sg = []; lc = []; pc = []; ps = []; l0s = []
    for n in ns:
        a, b, c = _recur_coeffs(m, m, n)
        s, logc, p_c, p_s, l0 = _seed_log_coeff(m, n)
        A.append(a); B.append(b); C.append(c)
        sg.append(s); lc.append(logc); pc.append(p_c); ps.append(p_s)
        l0s.append(l0)
    return dict(A=np.stack(A), B=np.stack(B), C=np.stack(C),
                seed_sign=np.stack(sg), seed_logC=np.stack(lc),
                seed_pc=np.stack(pc), seed_ps=np.stack(ps),
                l0=np.stack(l0s))


def _seed_mantissa_exp(tab, theta, dtype):
    """Seed values at l = l0(m) for every (n, m, ring) in extended-exponent
    form, value = mant * 2**(-30 e)."""
    ct2 = np.log(np.maximum(np.abs(np.cos(theta / 2.0)), 1e-300))
    st2 = np.log(np.maximum(np.abs(np.sin(theta / 2.0)), 1e-300))
    logv = (tab["seed_logC"][:, :, None]
            + tab["seed_pc"][:, :, None] * ct2[None, None, :]
            + tab["seed_ps"][:, :, None] * st2[None, None, :])
    log2v = logv / math.log(2.0)
    e = np.maximum(0, np.ceil((-log2v - 8.0) / _RESCALE_BITS)).astype(np.int32)
    mant = tab["seed_sign"][:, :, None] * np.exp(
        logv + e * (_RESCALE_BITS * math.log(2.0)))
    return mant.astype(dtype), e


# ---------------------------------------------------------------------------
# Host preparation (copied from pallas_sht.py)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _prep_raw(lmax, rings, ns):
    """Recurrence tables and l0 seed mantissa/exponent for all ``ns``."""
    tab = _wigner_tables_np(lmax, ns)
    theta = np.asarray(rings.theta_array(), np.float64)
    mant, e_np = _seed_mantissa_exp(tab, theta, np.float64)
    return tab, theta, mant, e_np


@functools.lru_cache(maxsize=8)
def _rings_symmetric(rings):
    """True when ``theta[T-1-i] == pi - theta[i]`` (Gauss-Legendre and
    Clenshaw-Curtis grids are)."""
    th = np.asarray(rings.theta_array(), np.float64)
    return bool(np.allclose(th + th[::-1], np.pi, rtol=0, atol=1e-12))


def _lend_table(lmax, theta, mtile, ttile, Lp, Tp, lc=_LC):
    """(n_im, n_jt) chunk-count table for the dead-tile skip: 0 where the
    tile's smallest m exceeds ``lmax * max(sin theta) * 1.02 + 256`` (its
    Lambda is negligible, below the turning point), else all chunks of
    ``lc`` l-steps."""
    th = np.asarray(theta, np.float64)
    n_im = -(-(lmax + 1) // mtile)
    n_jt = Tp // ttile
    nch = Lp // lc
    out = np.full((n_im, n_jt), nch, np.int32)
    for jt in range(n_jt):
        rows = th[jt * ttile: min((jt + 1) * ttile, len(th))]
        if len(rows) == 0:
            out[:, jt] = 0
            continue
        sinmax = float(np.max(np.sin(rows)))
        for im in range(n_im):
            if im * mtile > lmax * sinmax * 1.02 + 256:
                out[im, jt] = 0
    return out


def _bounds_table(capL, lmax, theta, mtile, ttile, Lp, Tp, Mp, lc=_LC):
    """(3 n_im, n_jt) int32 loop bounds from the captured ``l_s`` grid
    ``capL`` (T, M1): per (m tile, ring tile) the first live chunk of ``lc``
    l-steps (min l_s), one past the last (:func:`_lend_table`), and the
    first chunk past every seed; tiles with no live lane run no chunk."""
    T, M1 = capL.shape
    n_im = Mp // mtile
    n_jt = Tp // ttile
    nch = Lp // lc
    lend = _lend_table(lmax, theta, mtile, ttile, Lp, Tp, lc)
    pad = np.full((Tp, Mp), -1, np.int32)
    pad[:T, :M1] = capL
    tiles = pad.reshape(n_jt, ttile, n_im, mtile)
    live = tiles >= 0
    any_live = live.any(axis=(1, 3))
    big = np.where(live, tiles, np.int32(2 ** 30))
    lsmin = big.min(axis=(1, 3))
    lsmax = np.where(live, tiles, -1).max(axis=(1, 3))
    lstart = np.where(any_live, lsmin // lc, 2 ** 30).T.astype(np.int64)
    shi = np.where(any_live, lsmax // lc + 1, 2 ** 30).T.astype(np.int64)
    lend = np.minimum(lend, nch)
    lstart = np.minimum(lstart, lend).astype(np.int32)
    shi = np.minimum(shi, lend).astype(np.int32)
    return np.concatenate([lstart, lend, shi], axis=0)


def _fold_G(G, Tfull):
    """(..., T, M) -> (S0, S1) on the northern half (equator kept for odd
    T): the even/odd north-south combinations, selected by m parity, that
    even and odd l contract."""
    Th = (Tfull + 1) // 2
    half = Tfull // 2
    Gn = G[..., :Th, :]
    Gs = torch.flip(G[..., Th:, :], dims=(-2,))
    Ge = torch.cat([Gn[..., :half, :] + Gs, Gn[..., half:, :]], dim=-2)
    Go = torch.cat([Gn[..., :half, :] - Gs,
                    torch.zeros_like(Gn[..., half:, :])], dim=-2)
    m_even = torch.arange(G.shape[-1], device=G.device) % 2 == 0
    return torch.where(m_even, Ge, Go), torch.where(m_even, Go, Ge)


def _unfold_acc(accN, accS, Tfull):
    """Northern accumulators -> the full (..., T, M) ring block: ring
    T-1-i is the southern accumulator at northern row i."""
    half = Tfull // 2
    south = torch.flip(accS[..., :half, :], dims=(-2,))
    return torch.cat([accN, south], dim=-2)


def _north_south(G, T):
    """(B, T, M) -> northern rows and flipped southern rows, both of
    ``ceil(T/2)`` rows (the equator's southern partner is a zero row)."""
    Th = (T + 1) // 2
    half = T // 2
    Gn = G[:, :Th, :]
    Gs = torch.flip(G[:, Th:, :], dims=(1,))
    if Th != half:
        Gs = torch.cat([Gs, torch.zeros_like(G[:, : Th - half, :])], dim=1)
    return Gn, Gs


@functools.lru_cache(maxsize=4)
def _parity_grid_np(lmax):
    s = (-1.0) ** np.arange(lmax + 1)
    return np.outer(s, s)                       # (-1)^(l+m)


@functools.lru_cache(maxsize=8)
def _parity_grid(lmax, dtype, device: str):
    """:func:`_parity_grid_np` on ``device`` (cached)."""
    return torch.as_tensor(_parity_grid_np(lmax), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _tables(lmax, rings, ns, ni, layout, device):
    tab, theta, mant, e_np = _prep_raw(lmax, rings, ns)
    T = rings.ntheta
    Th = (T + 1) // 2
    Tr = Th if layout == "half" else T            # rings of the function
    dev = torch.device(device)
    f64 = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                    dtype=torch.float64, device=dev)
    return dict(
        lmax=lmax, ns=ns, ni=ni, layout=layout, T=T, Tr=Tr,
        Tk=Th if layout != "full" else T, theta=theta,
        A=f64(tab["A"][ni]), B=f64(tab["B"][ni]), C=f64(tab["C"][ni]),
        x=f64(np.cos(theta[:Tr])), seed_m=f64(mant[ni][:, :Tr]),
        seed_e=torch.as_tensor(e_np[ni][:, :Tr], dtype=torch.int32,
                               device=dev),
        l0=torch.as_tensor(tab["l0"][ni], dtype=torch.int64, device=dev),
        key=(lmax, rings, ns, ni, layout, device))


def tables(lmax, rings, ns=(0,), ni=0, layout="full", device="cpu"):
    """The tables of one Legendre transform (Wigner column ``ns[ni]``) on
    ``device``, cached: the plain version's float64 recurrence tables, ring
    cosines and l0 seeds over the function's rings. The kernel's captured
    seeds and loop bounds are :func:`kernel_tables`'."""
    if layout not in ("full", "fold", "half"):
        raise ValueError(f"unknown layout {layout!r}")
    return _tables(lmax, rings, tuple(ns), ni, layout, str(device))


def _step(A, B, C, x, lam_p, lam_c, e, sm, se, seed):
    """One l-step of the float64 recurrence on lanes (m, ring) with l0
    seed injection and the extended-exponent unwinding; returns the new
    carry."""
    lam_n = (A[:, None] * x + B[:, None]) * lam_c + C[:, None] * lam_p
    lam_n = torch.where(seed, sm, lam_n)
    lam_pn = torch.where(seed, torch.zeros_like(lam_c), lam_c)
    e = torch.where(seed, se, e)
    big = (lam_n.abs() > _TH) & (e > 0)
    lam_n = torch.where(big, lam_n * _INV, lam_n)
    lam_pn = torch.where(big, lam_pn * _INV, lam_pn)
    return lam_pn, lam_n, e - big.to(e.dtype)


def _capture(tab, x, sm, se):
    """The seed-capture pass, float64 on the tables' device: run the
    recurrence over ``x`` (the kernel's rings) from the l0 seeds ``sm, se``
    (M1, Tk) and keep, per lane, the carry at the first l where the
    exponent has unwound to e <= 1 (the first l whose weight is nonzero).
    Returns (capP, capC, capE, capL) (M1, Tk); capL = -1 where the lane
    never emerges."""
    L1 = tab["lmax"] + 1
    M1, Tk = sm.shape
    z = torch.zeros((M1, Tk), dtype=torch.float64, device=sm.device)
    zi = torch.zeros((M1, Tk), dtype=torch.int32, device=sm.device)
    lam_p, lam_c, e = z.clone(), z.clone(), zi.clone()
    capP, capC, capE = z.clone(), z.clone(), zi.clone()
    capL = torch.full((M1, Tk), -1, dtype=torch.int32, device=sm.device)
    done = torch.zeros((M1, Tk), dtype=torch.bool, device=sm.device)
    l0 = tab["l0"]
    for l in range(L1):
        k = min(l + 1, M1)                      # lanes with m <= l
        seed = (l0[:k] == l)[:, None]
        p, c, ee = _step(tab["A"][l, :k], tab["B"][l, :k], tab["C"][l, :k],
                         x, lam_p[:k], lam_c[:k], e[:k], sm[:k], se[:k],
                         seed)
        fire = ~done[:k] & (ee <= 1) & (l0[:k, None] <= l)
        capP[:k] = torch.where(fire, p, capP[:k])
        capC[:k] = torch.where(fire, c, capC[:k])
        capE[:k] = torch.where(fire, ee, capE[:k])
        capL[:k] = torch.where(fire, torch.full_like(capL[:k], l), capL[:k])
        done[:k] |= fire
        lam_p[:k], lam_c[:k], e[:k] = p, c, ee
    return capP, capC, capE, capL


def _kernel_tables_from(lmax, theta, A, B, C, capP, capC, capE, capL):
    """The kernel's table set: float64 recurrence tables ``A, B, C`` m-major
    (M1, Lp), padded to whole chunks, the rings' cosines, the captured seeds
    (M1, Tk) as float64 true values (default mode) and float32 mantissas
    with their exponent (``fast``), and the (3 M1, ng) loop bounds for
    one-m, ``_TG``-ring groups."""
    L1 = lmax + 1
    Lp = -(-L1 // _LC) * _LC
    M1, Tk = capC.shape
    Tp = -(-Tk // _TG) * _TG
    dev = capC.device
    scale = torch.pow(2.0, -30.0 * capE.to(torch.float64))
    mmajor = lambda a: torch.nn.functional.pad(a.T, (0, Lp - L1)).contiguous()
    bounds = _bounds_table(capL.cpu().numpy().T, lmax, theta[:Tk], 1, _TG,
                           Lp, Tp, M1)
    k = dict(Lp=Lp, Tk=Tk, ng=Tp // _TG,
             A=mmajor(A), B=mmajor(B), C=mmajor(C),
             x=torch.as_tensor(np.cos(theta[:Tk]), dtype=torch.float64,
                               device=dev),
             s1=(capC * scale).contiguous(), s0=(capP * scale).contiguous(),
             se=capE.to(torch.int32).contiguous(),
             ls=capL.to(torch.int32).contiguous(),
             bounds=torch.as_tensor(bounds, device=dev).contiguous())
    for name in ("A", "B", "C", "x"):
        k[name + "32"] = k[name].to(torch.float32)
    # the fast recurrence's factor 2 x + (2 x_lo + (A - 2) x + B) rounds
    # once from float64 A and x (_fast_factor)
    k["A32"] = (k["A"] - 2.0).to(torch.float32)
    k["xlo32"] = (k["x"] - k["x32"].double()).to(torch.float32)
    k["s1_32"] = capC.to(torch.float32).contiguous()
    k["s0_32"] = capP.to(torch.float32).contiguous()
    return k


@functools.lru_cache(maxsize=16)
def _kernel_tables(key):
    tab = _tables(*key)
    # the kernel's rings are the first Tk of the function's rings
    Tk = tab["Tk"]
    capt = _capture(tab, tab["x"][:Tk], tab["seed_m"][:, :Tk],
                    tab["seed_e"][:, :Tk])
    return _kernel_tables_from(tab["lmax"], tab["theta"], tab["A"], tab["B"],
                               tab["C"], *capt)


def kernel_tables(tab):
    """The kernel's tables of ``tab``: its ``"kernel"`` entry where it has
    one (``convert.load_sht_tables``), else the port's own, built once per
    :func:`tables` key (the capture pass on the kernel's rings, then the
    loop bounds)."""
    if "kernel" in tab:
        return tab["kernel"]
    return _kernel_tables(tab["key"])


def clear_tables():
    """Drop every cached table set (:func:`tables`, :func:`kernel_tables`)
    and with it its device memory; the next transform builds its own
    again."""
    _tables.cache_clear()
    _kernel_tables.cache_clear()


# ---------------------------------------------------------------------------
# Packing: (l, m) matrix <-> healpy triangular order
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def _pack_tensor(lmax, device: str):
    """The matrix index ``l (lmax + 1) + m`` of each healpy-packed alm, on
    ``device`` (cached: a host copy per call would stall the stream)."""
    ls, ms = almops.lm_indices(lmax)
    idx = ls.astype(np.int64) * (lmax + 1) + ms.astype(np.int64)
    return torch.as_tensor(idx, device=device)


def _mat2alm(mat, lmax):
    """(..., L+1, M+1) -> healpy-packed (..., nalm)."""
    flat = mat.reshape(mat.shape[:-2] + (-1,))
    return flat.index_select(-1, _pack_tensor(lmax, str(mat.device)))


def _alm2mat(alm, lmax):
    """healpy-packed (..., nalm) -> (..., L+1, M+1) with zeros elsewhere."""
    n = (lmax + 1) * (lmax + 1)
    flat = torch.zeros(alm.shape[:-1] + (n,), dtype=alm.dtype,
                       device=alm.device)
    flat[..., _pack_tensor(lmax, str(alm.device))] = alm
    return flat.reshape(alm.shape[:-1] + (lmax + 1, lmax + 1))


# ---------------------------------------------------------------------------
# Plain versions (float64 loop over l, every ring, l0 seeds)
# ---------------------------------------------------------------------------

def _lambda_rows(tab, device):
    """Yield ``(l, k, Lambda_l[:k])``: the weighted Lambda row (k, Tr) of
    the lanes m < k = min(l + 1, M1), float64, from the l0 seeds."""
    t = {k: tab[k].to(device) for k in ("A", "B", "C", "x", "seed_m",
                                         "seed_e", "l0")}
    M1, Tr = t["seed_m"].shape
    lam_p = torch.zeros((M1, Tr), dtype=torch.float64, device=device)
    lam_c = torch.zeros_like(lam_p)
    e = torch.zeros((M1, Tr), dtype=torch.int32, device=device)
    for l in range(tab["lmax"] + 1):
        k = min(l + 1, M1)
        seed = (t["l0"][:k] == l)[:, None]
        p, c, ee = _step(t["A"][l, :k], t["B"][l, :k], t["C"][l, :k],
                         t["x"], lam_p[:k], lam_c[:k], e[:k],
                         t["seed_m"][:k], t["seed_e"][:k], seed)
        lam_p[:k], lam_c[:k], e[:k] = p, c, ee
        # e == 0 exact, e == 1 one suppression, e >= 2 negligible
        w = torch.where(ee == 0, 1.0, torch.where(ee == 1, _INV, 0.0))
        yield l, k, c * w


def _fmaf(a, b, c):
    """``fmaf(a, b, c)`` of float32 tensors: ``a b + c`` rounded once to
    float32. The product is exact in float64; the float64 sum is made
    round-to-odd from its exact error (two-sum), so rounding it to float32
    is the single correct rounding."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    si = s.view(torch.int64)
    step = torch.where((err > 0) == (s > 0), 1, -1)    # away from or to 0
    si = torch.where((err != 0) & (si % 2 == 0), si + step, si)
    return si.view(torch.float64).to(torch.float32)


def _fast_factor(A, B, x, xlo):
    """The fast recurrence's factor ``a x + b`` on (M1, Tk) lanes,
    ``fmaf(2, x, fmaf(2, x_lo, fmaf(A - 2, x, B)))`` (``A`` holds A - 2,
    ``xlo`` the low part of x): near 2 on the low-m lanes, it rounds once
    from float64 A and x (``legendre.cu:factor``)."""
    shape = (A.shape[0], x.shape[0])
    two = torch.full(shape, 2.0, dtype=torch.float32, device=x.device)
    xs, xl = x.expand(shape), xlo.expand(shape)
    t = _fmaf(A[:, None].expand(shape), xs, B[:, None].expand(shape))
    return _fmaf(two, xs, _fmaf(two, xl, t))


def _fast_rows(lp, lc, e, A, B, C, x, xlo, seed, s1, s0, se):
    """One l-step of the fast kernel's float32 recurrence on (M1, Tk) lanes,
    ``fmaf(t, c, C p)`` with the factor ``t`` of :func:`_fast_factor` and
    each fused multiply-add rounded once (:func:`_fmaf`); then the seed
    injection, the 2^-30 rescale and the (1, 2^-30, 0) weighting. Returns
    (p, c, e, weighted)."""
    t = _fast_factor(A, B, x, xlo)
    ln = _fmaf(t, lc, C[:, None] * lp)
    ln = torch.where(seed, s1, ln)
    pn = torch.where(seed, s0, lc)
    e = torch.where(seed, se, e)
    big = (ln.abs() > _TH) & (e > 0)
    ln = torch.where(big, ln * _INV, ln)
    pn = torch.where(big, pn * _INV, pn)
    e = e - big.to(e.dtype)
    w = torch.where(e == 0, ln, torch.where(e == 1, ln * _INV,
                                            torch.zeros_like(ln)))
    return pn, ln, e, w


def _kernel_lambda(tab, fast):
    """Yield (l, Lambda_l (M1, Tk) float64) as the kernels compute them, on
    the tables' device: captured seeds injected at l_s, float64 (or the fast
    float32 recurrence with its exponent), zero outside each (m, 32-ring
    group)'s chunk bounds."""
    k = kernel_tables(tab)
    M1, Tk = tab["lmax"] + 1, k["Tk"]
    dt = torch.float32 if fast else torch.float64
    sfx = "32" if fast else ""
    A, B, C = (k[n + sfx] for n in "ABC")
    x = k["x" + sfx]
    s1 = k["s1_32" if fast else "s1"]
    s0 = k["s0_32" if fast else "s0"]
    dev = s1.device
    b = k["bounds"].long()
    grp = torch.arange(Tk, device=dev) // _TG
    lo = b[:M1][:, grp]
    hi = b[M1:2 * M1][:, grp]
    lp = torch.zeros((M1, Tk), dtype=dt, device=dev)
    lc = torch.zeros_like(lp)
    e = torch.zeros((M1, Tk), dtype=torch.int32, device=dev)
    for l in range(k["Lp"]):
        seed = k["ls"] == l
        if fast:
            lp, lc, e, w = _fast_rows(lp, lc, e, A[:, l], B[:, l],
                                      C[:, l], x, k["xlo32"], seed, s1, s0,
                                      k["se"])
        else:
            ln = (A[:, l, None] * x + B[:, l, None]) * lc \
                + C[:, l, None] * lp
            ln = torch.where(seed, s1, ln)
            lp = torch.where(seed, s0, lc)
            lc = w = ln
        ch = l // _LC
        yield l, torch.where((ch >= lo) & (ch < hi), w.double(), 0.0)


def _kernel_ana(G, tab, fast=False, dtype=None):
    """The analysis as the kernel computes it (:func:`_kernel_lambda`),
    summed in float64: ``G`` (B, Tr, M1) complex -> (B, L1, M1) of
    ``dtype`` (default ``G``'s), the kernel's input (its fold's sums)
    rounded to ``dtype`` first, as the kernel rounds the weighted rings of
    a complex128 ``G``."""
    L1 = tab["lmax"] + 1
    dtype = dtype or G.dtype
    parts = _fold_G(G, tab["T"]) if tab["layout"] == "fold" else (G, G)
    parts = [p.to(dtype).to(torch.complex128) for p in parts]
    out = torch.zeros((G.shape[0], L1, L1), dtype=torch.complex128,
                      device=G.device)
    for l, lam in _kernel_lambda(tab, fast):
        if l < L1:
            out[:, l] = torch.einsum("mt,btm->bm", lam.to(out.dtype),
                                     parts[l % 2])
    return out.to(dtype)


def _kernel_syn(a, tab, fast=False, phase=None):
    """The synthesis as the kernel computes it (:func:`_kernel_lambda`),
    summed in float64: ``a`` (B, L1, M1) complex -> (B, Tr, M1) of its
    dtype, times ``phase`` (M1,) in complex128 before the rounding where
    given."""
    L1 = tab["lmax"] + 1
    Tk = kernel_tables(tab)["Tk"]
    acc = torch.zeros((2, a.shape[0], Tk, L1), dtype=torch.complex128,
                      device=a.device)
    a2 = a.to(torch.complex128)
    fold = tab["layout"] == "fold"
    for l, lam in _kernel_lambda(tab, fast):
        if l < L1:
            acc[l % 2 if fold else 0] += lam.T[None] * a2[:, l, None, :]
    if fold:
        sg = torch.where(torch.arange(L1, device=a.device) % 2 == 0, 1.0,
                         -1.0)
        out = _unfold_acc(acc[0] + acc[1], sg * (acc[0] - acc[1]), tab["T"])
    else:
        out = acc[0]
    return _rotated(out, phase).to(a.dtype)


def _plain_fast(x, fast):
    """True where the fast mode's plain version applies: ``fast`` asked for
    on float32 inputs (float64 inputs take the float64 loop, as the
    kernels' float64 instance does)."""
    return bool(fast) and x.real.dtype != torch.float64


def _rotated(x, phase):
    """``x`` complex128 times ``phase`` (M1,) along its last axis, or ``x``
    where ``phase`` is None."""
    return x if phase is None else x * phase.to(x.device, torch.complex128)


def _rings_in(G, M1, weights, phase):
    """The Legendre analysis's input of the ring side: the first ``M1``
    columns of ``G``, and where ``weights`` or ``phase`` is given, ``G``
    times the phase, then times each ring's weight, in complex128."""
    G = G[..., :M1]
    if weights is None and phase is None:
        return G
    G = _rotated(G.to(torch.complex128), phase)
    if weights is not None:
        G = G * weights.to(G.device, torch.float64)[:, None]
    return G


def legendre_ana_ref(G, tab, fast: bool = False, weights=None, phase=None,
                     packed: bool = False):
    """Plain version of :func:`legendre_ana`: ``G`` (B, Tr, >= M1) complex
    (the first M1 columns read; ``weights``, ``phase``: see there) ->
    (B, L1, M1), or with ``packed`` the healpy-packed (B, nalm), of ``G``'s
    dtype, computed in float64 (``fast``, float32 inputs: the fast kernel's
    float32 recurrence, :func:`_kernel_ana`)."""
    dtype = G.dtype
    lmax = tab["lmax"]
    fast = _plain_fast(G, fast)
    G = _rings_in(G, lmax + 1, weights, phase)
    out = _kernel_ana(G, tab, True, dtype) if fast else _ana_loop(G, tab)
    out = out.to(dtype)
    return _mat2alm(out, lmax) if packed else out


def _ana_loop(G, tab):
    """The plain analysis's float64 loop: (B, L1, M1) complex128."""
    L1 = tab["lmax"] + 1
    gr = G.real.to(torch.float64)
    gi = G.imag.to(torch.float64)
    out_r = torch.zeros((G.shape[0], L1, G.shape[-1]), dtype=torch.float64,
                        device=G.device)
    out_i = torch.zeros_like(out_r)
    for l, k, lam in _lambda_rows(tab, G.device):
        out_r[:, l, :k] = torch.einsum("mt,btm->bm", lam, gr[:, :, :k])
        out_i[:, l, :k] = torch.einsum("mt,btm->bm", lam, gi[:, :, :k])
    return torch.complex(out_r, out_i)


def legendre_syn_ref(a, tab, fast: bool = False, phase=None,
                     packed: bool = False, ncols=None):
    """Plain version of :func:`legendre_syn`: ``a`` (B, L1, M1) complex, or
    with ``packed`` healpy-packed (B, nalm) -> (B, Tr, M1) of ``a``'s dtype
    (``phase``, ``ncols``: see there), computed in float64 (``fast``,
    float32 inputs: the fast kernel's float32 recurrence,
    :func:`_kernel_syn`)."""
    if packed:
        a = _alm2mat(a, tab["lmax"])
    if _plain_fast(a, fast):
        out = _kernel_syn(a, tab, True, phase)
    else:
        out = _rotated(_syn_loop(a, tab), phase).to(a.dtype)
    if ncols is not None and ncols > out.shape[-1]:
        out = torch.nn.functional.pad(out, (0, ncols - out.shape[-1]))
    return out


def _syn_loop(a, tab):
    """The plain synthesis's float64 loop: (B, Tr, M1) complex128."""
    ar = a.real.to(torch.float64)
    ai = a.imag.to(torch.float64)
    shape = (a.shape[0], tab["Tr"], a.shape[-1])
    acc_r = torch.zeros(shape, dtype=torch.float64, device=a.device)
    acc_i = torch.zeros_like(acc_r)
    for l, k, lam in _lambda_rows(tab, a.device):
        lt = lam.T[None]                                  # (1, Tr, k)
        acc_r[:, :, :k] += lt * ar[:, l, None, :k]
        acc_i[:, :, :k] += lt * ai[:, l, None, :k]
    return torch.complex(acc_r, acc_i)


# ---------------------------------------------------------------------------
# Kernel wrappers (B10a, B10s)
# ---------------------------------------------------------------------------

def _kernel_args(tab, real_dtype, fast):
    """(kernel tables, precision flags) for a launch: float64 I/O runs the
    float64 recurrence whatever ``fast`` says."""
    k = kernel_tables(tab)
    f64 = real_dtype == torch.float64
    fast = bool(fast) and not f64
    sfx = "32" if fast else ""
    ptrs = [k["A" + sfx].data_ptr(), k["B" + sfx].data_ptr(),
            k["C" + sfx].data_ptr(), k["x" + sfx].data_ptr(),
            k["xlo32"].data_ptr(), k["s1_32" if fast else "s1"].data_ptr(),
            k["s0_32" if fast else "s0"].data_ptr(), k["se"].data_ptr(),
            k["ls"].data_ptr(), k["bounds"].data_ptr()]
    return k, ptrs, int(fast), int(f64)


def _check_in(x, tab, rows, what, packed=False, wide=False):
    """``x`` is (B, rows, M1) complex, (B, rows, >= M1) where ``wide``, or
    healpy-packed (B, nalm) where ``packed``."""
    M1 = tab["lmax"] + 1
    if packed:
        n = almops.nalm(tab["lmax"])
        if not x.is_complex() or x.ndim != 2 or x.shape[1] != n:
            raise ValueError(f"{what}: expects (B, {n}) complex packed alms, "
                             f"got {tuple(x.shape)} {x.dtype}")
        return
    if not x.is_complex() or x.ndim != 3:
        raise ValueError(f"{what}: expects a (B, {rows}, M1) complex tensor")
    if x.shape[1] != rows or (x.shape[2] < M1 if wide else
                              x.shape[2] != M1):
        raise ValueError(f"{what}: shape {tuple(x.shape)}, expected "
                         f"(B, {rows}, {M1}{' or more' if wide else ''})")


def _io_tables(x, rows, M1, weights, phase):
    """The ring side's tables on ``x``'s device as the kernels read them:
    float64 weights (rows,) and the phase as (M1, 2) float64, each None
    where not given."""
    if weights is not None:
        weights = weights.to(x.device, torch.float64).contiguous()
        if tuple(weights.shape) != (rows,):
            raise ValueError(f"weights: shape {tuple(weights.shape)}, "
                             f"expected ({rows},)")
    if phase is not None:
        phase = torch.view_as_real(
            phase.to(x.device, torch.complex128).resolve_conj().contiguous())
        if tuple(phase.shape) != (M1, 2):
            raise ValueError(f"phase: shape {tuple(phase.shape[:1])}, "
                             f"expected ({M1},)")
    return weights, phase


def _ptr(t):
    return None if t is None else t.data_ptr()


class _AnaPlan(NamedTuple):
    """How B10a runs one launch (:func:`_ana_plan`)."""
    form: str            # "one_pass" (folded) or "groups"
    blocks: int          # blocks per m: the cluster, or the ring groups
    rr: int              # rings a lane ("groups")
    tiles: int           # column tiles of 8: of a parity ("one_pass"), of
                         # a map group's S0 and S1 ("groups")
    partial_planes: int  # float64 planes the wrapper sums (0: none)


def _ana_plan(Tk, nmaps, layout):
    """The launch of B10a over ``Tk`` kernel rings and ``nmaps`` maps (at
    most 16) in ``layout``. On a folded grid of 1025-2048 kernel rings,
    where the ring-group form writes partial planes whatever the map count,
    the one-pass form: a cluster of ``ceil(Tk / 256)`` blocks sums every
    ring of an m on chip, each l parity against its own fold's columns
    (``2 nmaps`` a parity, in tiles of 8). Elsewhere the ring-group form:
    one block of 512 rings each (1024, two a lane, where one column tile
    holds the maps), whose float64 partial planes the wrapper sums in ring
    order; folded, more than 8 maps as two grid layers. The one-pass form
    is slower where a launch holds few maps and the ring-group form needs
    no planes (one map at 1024 folded rings: 3.45 against 2.14 ms on the
    H100), and on the unfolded layouts tried (16 maps "half" at 512 rings,
    one map "full" at 2048). The form, and so every sum's order, depends on
    ``Tk`` and ``layout`` alone: a map gives the same bits alone as in a
    packed launch."""
    blocks = -(-Tk // _ANA1_RINGS)
    if layout == "fold" and 2 * _ANA_RINGS < Tk and blocks <= _ANA_CLUSTER:
        return _AnaPlan("one_pass", blocks, 1, -(-2 * nmaps // 8), 0)
    fold = layout == "fold"
    gmaps = -(-nmaps // -(-nmaps // 8)) if fold else nmaps
    tiles = -(-(2 if fold else 1) * 2 * gmaps // 8)
    rr = 2 if tiles == 1 and _ANA_RINGS < Tk <= 2 * _ANA_RINGS else 1
    nsg = -(-Tk // (_ANA_RINGS * rr))
    return _AnaPlan("groups", nsg, rr, tiles, nsg if nsg > 1 else 0)


@spanned("orphics.transforms.legendre_ana")
def legendre_ana(G, tab, fast: bool = False, weights=None, phase=None,
                 packed: bool = False):
    """Legendre analysis ``out[b, l, m] = sum_t Lambda_lm(theta_t) G[b, t,
    m]`` of ``G`` (B, Tr, >= M1) complex over the rings of ``tab`` (B10a;
    ``fast``: the float32 recurrence, float32 inputs only). The first M1
    columns of each ring are read in place, through ``G``'s strides (the
    ring FFT's half spectrum as it is); ``phase`` (M1,) complex and then
    ``weights`` (Tr,) real multiply each ring in float64 before the
    contraction (None: none). Returns (B, L1, M1), or with ``packed`` the
    healpy-packed (B, nalm), of ``G``'s dtype."""
    _check_in(G, tab, tab["Tr"], "legendre_ana", wide=True)
    if not G.is_cuda:
        return legendre_ana_ref(G, tab, fast, weights, phase, packed)
    rdt = G.real.dtype
    k, ptrs, fast_i, f64 = _kernel_args(tab, rdt, fast)
    lib = _build.library()
    fold = tab["layout"] == "fold"
    lmax = tab["lmax"]
    L1 = M1 = lmax + 1
    G = G.resolve_conj()
    if G.stride(-1) != 1:
        G = G.contiguous()
    nb, Tr, _ = G.shape
    Tk = k["Tk"]
    w, ph = _io_tables(G, Tr, M1, weights, phase)
    g_ring = G.stride(1)
    g_map = G.stride(0) if nb > 1 else Tr * g_ring
    out = torch.empty((nb, almops.nalm(lmax), 2) if packed
                      else (nb, L1, M1, 2), dtype=rdt, device=G.device)
    stream = torch.cuda.current_stream(G.device).cuda_stream
    for b0 in range(0, nb, _MAXB):
        n = min(_MAXB, nb - b0)
        plan = _ana_plan(Tk, n, tab["layout"])
        src, dst = G[b0:b0 + n].data_ptr(), out[b0:b0 + n]
        # partial planes stay (L1, M1) matrices: packed after their sum
        io = (g_map, g_ring, int(packed and not plan.partial_planes),
              _ptr(ph), _ptr(w))
        if plan.form == "one_pass":
            err = lib.legendre_ana1_launch(
                *ptrs, src, dst.data_ptr(), M1, k["Lp"], L1, Tk, tab["T"],
                k["ng"], n, plan.blocks, fast_i, f64, *io, stream)
        else:
            part = dst if not plan.partial_planes else torch.empty(
                (plan.blocks, n, L1, M1, 2), dtype=torch.float64,
                device=G.device)
            err = lib.legendre_ana_launch(
                *ptrs, src, part.data_ptr(), M1, k["Lp"], L1, Tk, Tr,
                tab["T"], k["ng"], n, plan.rr, int(not plan.partial_planes),
                int(fold), fast_i, f64, *io, stream)
        _build.check(err, "legendre_ana")
        legendre_ana.launches += 1
        legendre_ana.one_pass += plan.form == "one_pass"
        legendre_ana.ring_io += bool(packed)
        if plan.partial_planes:
            _sum_partials(part, dst, lmax if packed else None)
    return torch.view_as_complex(out)


legendre_ana.launches = 0
legendre_ana.partial_planes = 0
legendre_ana.one_pass = 0
legendre_ana.ring_io = 0


@spanned("orphics.transforms.legendre_ana.partials")
def _sum_partials(part, dst, lmax=None):
    """B10a's cross-group sum: the fp64 partial planes ``part`` (nsg, ...)
    of one launch added in ring order into ``dst``, packed where ``lmax``
    is given, counted in ``legendre_ana.partial_planes``."""
    acc = part[0]
    for i in range(1, part.shape[0]):
        acc = acc + part[i]
    if lmax is not None:
        acc = torch.view_as_real(_mat2alm(torch.view_as_complex(acc), lmax))
    dst.copy_(acc)
    legendre_ana.partial_planes += part.shape[0]


@spanned("orphics.transforms.legendre_syn")
def legendre_syn(a, tab, fast: bool = False, phase=None, packed: bool = False,
                 ncols=None):
    """Legendre synthesis ``acc[b, t, m] = sum_l Lambda_lm(theta_t) a[b, l,
    m]`` of ``a`` (B, L1, M1) complex, or with ``packed`` the healpy-packed
    (B, nalm), onto the rings of ``tab`` (B10s; ``fast`` as in
    :func:`legendre_ana`). Returns (B, Tr, M1) of ``a``'s dtype, each ring
    times ``phase`` (M1,) complex in float64 before the rounding (None:
    none); with ``ncols`` (>= M1) (B, Tr, ncols), zero in the columns past
    M1: the half spectrum that ``torch.fft.irfft`` reads."""
    lmax = tab["lmax"]
    L1 = M1 = lmax + 1
    _check_in(a, tab, L1, "legendre_syn", packed=packed)
    width = M1 if ncols is None else int(ncols)
    if width < M1:
        raise ValueError(f"legendre_syn: ncols {ncols} < M1 {M1}")
    if not a.is_cuda:
        return legendre_syn_ref(a, tab, fast, phase, packed, ncols)
    rdt = a.real.dtype
    k, ptrs, fast_i, f64 = _kernel_args(tab, rdt, fast)
    lib = _build.library()
    fold = tab["layout"] == "fold"
    nb = a.shape[0]
    # the kernel reads each m's column, contiguous when packed
    ak = a.resolve_conj().contiguous()
    rows = tab["Tr"]
    _, ph = _io_tables(a, rows, M1, None, phase)
    out = torch.empty((nb, rows, width), dtype=a.dtype, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    for b0 in range(0, nb, _MAXB):
        n = min(_MAXB, nb - b0)
        err = lib.legendre_syn_launch(
            *ptrs, ak[b0:b0 + n].data_ptr(), out[b0:b0 + n].data_ptr(), M1,
            k["Lp"], L1, k["Tk"], tab["T"], k["ng"], n, int(fold), fast_i,
            f64, int(packed), rows * width, width, width, _ptr(ph), stream)
        _build.check(err, "legendre_syn")
        legendre_syn.launches += 1
        legendre_syn.ring_io += bool(packed)
    return out


legendre_syn.launches = 0
legendre_syn.ring_io = 0
