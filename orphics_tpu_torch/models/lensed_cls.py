"""Exact lensed CMB spectra via the curved-sky correlation-function method
(port of ``orphics_tpu.models.lensed_cls``: host float64 numpy, as there).

Replaces the role of ``camb.correlations.lensed_cls`` in the reference
(``orphics/cosmology.py:1206`` ``get_lensed_cls``) with an original
implementation of the Seljak / Challinor-Lewis resummation:

1. Build the deflection-field correlation functions on a Gauss-Legendre
   grid of separation angles beta:
       Cgl(b)  = sum_l (2l+1)/(4pi) l(l+1) C_l^phiphi d^l_{1,1}(b)
       Cgl2(b) = sum_l (2l+1)/(4pi) l(l+1) C_l^phiphi d^l_{1,-1}(b)
       sigma^2(b) = Cgl(0) - Cgl(b)
2. Build the *lensed* real-space correlation functions. Gaussian
   deflections damp each multipole by exp(-[l(l+1) - (s1^2+s2^2)/2]
   sigma^2(b)/2) and couple in the anisotropic part Cgl2 through a
   series of index-shifted Wigner d functions: the unlensed kernel
   d^l_{a,b} acquires companions d^l_{a+n,b-n} with weight the
   modified-Bessel coefficient I_n(z), z = l(l+1) Cgl2(b)/2, expanded
   here to second order in z (the same truncation CAMB uses; accurate
   to ~0.1% for l < 4000):
       I_0 ~ 1 + z^2/4,  I_1 ~ z/2 (+ z^3/16),  I_2 ~ z^2/8.
   Correlations and their kernels:
       xi    (TT)      base (a,b) = (0, 0)
       xi_+  (EE+BB)   base (a,b) = (2, 2)
       xi_-  (EE-BB)   base (a,b) = (2,-2)
       xi_X  (TE)      base (a,b) = (0, 2)   (no +/-n fold symmetry)
   In the flat limit d^l_{a+n,b-n} -> J_{a-b+2n}(l beta), recovering the
   classic Seljak (1996) flat-sky resummation.
3. Project back with the exact Gauss-Legendre quadrature:
       Cl~ = 2pi sum_j w_j xi~(b_j) d^l_{a,b}(b_j).

Everything runs in float64 numpy on the host (theory setup, not a hot
path); the Wigner d columns are generated with the same normalized
three-term l-recurrence as ``ops/legendre.py`` (shared coefficient code).
"""
from __future__ import annotations

import numpy as np

from ..ops import legendre as _sht

__all__ = ["lensed_cls", "lensed_correlations"]


def _dl_scan_pairs(pairs, lmax, beta, accum=None, block_accum=None,
                   block=64):
    """Iterate the normalized Wigner recurrence over l for a set of
    (m, n) pairs simultaneously.

    Either call ``accum(l, lam)`` per l with ``lam`` (npairs, nbeta)
    holding sqrt((2l+1)/4pi) d^l_{mn}(beta), or — much faster —
    ``block_accum(l0, lam_block)`` per block of ``block`` l values with
    ``lam_block`` of shape (npairs, nl_block, nbeta).

    numpy implementation of the same recurrence as the JAX package's
    ``ops/sht._lambda_scan`` (host float64: no underflow handling needed
    for the small |m|,|n| <= 5 used here).
    """
    npairs = len(pairs)
    nb = beta.shape[0]
    x = np.cos(beta)
    ls = np.arange(lmax + 1)
    A = np.empty((npairs, lmax + 1))
    B = np.empty((npairs, lmax + 1))
    C = np.empty((npairs, lmax + 1))
    seeds = np.empty((npairs, nb))
    l0s = np.empty(npairs, np.int64)
    for i, (m, n) in enumerate(pairs):
        a, b, c = _sht._recur_coeffs(ls, np.array([m]), n)
        A[i], B[i], C[i] = a[:, 0], b[:, 0], c[:, 0]
        sign, logC, pc, ps, l0 = _sht._seed_log_coeff(np.array([m]), n)
        lc2 = np.log(np.maximum(np.abs(np.cos(beta / 2)), 1e-300))
        ls2 = np.log(np.maximum(np.abs(np.sin(beta / 2)), 1e-300))
        seeds[i] = sign[0] * np.exp(logC[0] + pc[0] * lc2 + ps[0] * ls2)
        l0s[i] = l0[0]
    lam_p = np.zeros((npairs, nb))
    lam_c = np.zeros((npairs, nb))
    if block_accum is not None:
        buf = np.empty((npairs, block, nb))
    bstart = 0
    bcount = 0
    for l in range(lmax + 1):
        lam_n = (A[:, l, None] * x[None, :] + B[:, l, None]) * lam_c \
            + C[:, l, None] * lam_p
        is_seed = (l0s == l)
        if np.any(is_seed):
            lam_p_new = np.where(is_seed[:, None], 0.0, lam_c)
            lam_n = np.where(is_seed[:, None], seeds, lam_n)
            lam_p = lam_p_new
        else:
            lam_p = lam_c
        lam_c = lam_n
        if block_accum is not None:
            buf[:, bcount] = lam_c
            bcount += 1
            if bcount == block:
                block_accum(bstart, buf)
                bstart += block
                bcount = 0
        else:
            accum(l, lam_c)
    if block_accum is not None and bcount:
        block_accum(bstart, buf[:, :bcount])
    return None


# (a, b) bases for (xi_TT, xi_plus, xi_minus, xi_X)
_BASES = [(0, 0), (2, 2), (2, -2), (0, 2)]
# index shifts: n in {-2..2} for TE (no fold); n in {0,1,2} folded x2 for
# the symmetric bases.
_NMAX = 2


def _series_pairs():
    """All (m, n) Wigner pairs needed, deduplicated, plus bookkeeping of
    (base index, shift n) -> pair index."""
    pairs = [(1, 1), (1, -1)]          # for Cgl, Cgl2
    index = {(1, 1): 0, (1, -1): 1}
    terms = []                          # (ibase, shift, ipair, weight)
    for ib, (a, b) in enumerate(_BASES):
        # the n -> -n companion d_{a-n,b+n} equals d_{a+n,b-n} only when
        # a == b (e.g. for xi_- the n=+1 and n=-1 terms are the distinct
        # d_{3,-3} and d_{1,-1}), in which case the two are folded into
        # one term of weight 2
        fold = (a == b)
        shifts = range(0, _NMAX + 1) if fold else range(-_NMAX, _NMAX + 1)
        for n in shifts:
            m1, m2 = a + n, b - n
            # canonicalize with d_{m,n} = d_{-n,-m}
            key = (m1, m2)
            alt = (-m2, -m1)
            if key not in index and alt in index:
                key = alt
            if key not in index:
                index[key] = len(pairs)
                pairs.append(key)
            weight = 2.0 if (fold and n > 0) else 1.0
            terms.append((ib, n, index[key], weight))
    return pairs, terms


def lensed_correlations(cl_tt, cl_ee, cl_bb, cl_te, cl_pp, lmax=None,
                        sampling_factor=1.5):
    """Lensed correlation functions (xi, xi+, xi-, xiX) on a GL beta grid.

    ``cl_pp`` is C_l^{phi phi} (not the [l(l+1)]^2/2pi-scaled table
    column). Returns (beta, weights, xi array (4, nbeta)).
    """
    lmax = lmax or (len(cl_tt) - 1)
    nb = int(sampling_factor * lmax) + 1
    from scipy.special import roots_legendre
    xgl, wgl = roots_legendre(nb)
    beta = np.arccos(xgl[::-1])
    w = wgl[::-1]

    ll = np.arange(lmax + 1, dtype=np.float64)
    llp1 = ll * (ll + 1)
    norm = (2 * ll + 1) / (4 * np.pi)     # with sqrt((2l+1)/4pi) folded below
    # our recurrence returns Lambda = sqrt((2l+1)/4pi) d; so the sums
    # sum_l (2l+1)/(4pi) X d^l = sum_l sqrt((2l+1)/(4pi)) X Lambda_l
    lam_norm = np.sqrt(norm)

    pairs, terms = _series_pairs()
    cl_pp = np.asarray(cl_pp, np.float64)[: lmax + 1]
    cgl_coef = lam_norm * llp1 * cl_pp

    # pass 1a: deflection correlations
    cgl = np.zeros(nb)
    cgl2 = np.zeros(nb)

    def acc_defl(l0, lam):
        nl = lam.shape[1]
        cgl[:] += cgl_coef[l0: l0 + nl] @ lam[0]
        cgl2[:] += cgl_coef[l0: l0 + nl] @ lam[1]

    _dl_scan_pairs(pairs[:2], lmax, beta, block_accum=acc_defl)
    sigma0 = np.sum(((2 * ll + 1) / (4 * np.pi)) * llp1 * cl_pp)  # Cgl(0)
    sigma2 = sigma0 - cgl

    # pass 1b: lensed correlation functions
    cls_base = [np.asarray(c, np.float64)[: lmax + 1] for c in
                (cl_tt,
                 np.asarray(cl_ee)[: lmax + 1] + np.asarray(cl_bb)[: lmax + 1],
                 np.asarray(cl_ee)[: lmax + 1] - np.asarray(cl_bb)[: lmax + 1],
                 cl_te)]
    spin_corr = np.array([0.0, 4.0, 4.0, 2.0])  # (s1^2+s2^2)/2 per base
    xi = np.zeros((4, nb))

    def bessel_coef(n, z):
        """I_n(z) expanded to second order in z (third for n=1)."""
        an = abs(n)
        if an == 0:
            return 1.0 + z * z / 4.0
        if an == 1:
            return z / 2.0 + z ** 3 / 16.0
        if an == 2:
            return z * z / 8.0
        return np.zeros_like(z)

    def acc_lensed(l0, lam):
        nl = lam.shape[1]
        sl = slice(l0, l0 + nl)
        lp = llp1[sl][:, None]                       # (nl, 1)
        z = lp * cgl2[None, :] / 2.0                 # (nl, nb)
        base_damp = np.exp(-lp * sigma2[None, :] / 2.0)
        for ib in range(4):
            coefs = cls_base[ib][sl] * lam_norm[sl]  # (nl,)
            if not np.any(coefs):
                continue
            if spin_corr[ib]:
                damp = base_damp * np.exp(
                    spin_corr[ib] * sigma2[None, :] / 2.0)
            else:
                damp = base_damp
            series = np.zeros((nl, nb))
            for (jb, n, ip, weight) in terms:
                if jb != ib:
                    continue
                series += weight * bessel_coef(n, z) * lam[ip]
            xi[ib] += coefs @ (damp * series)

    _dl_scan_pairs(pairs, lmax, beta, block_accum=acc_lensed)
    return beta, w, xi


def lensed_cls(cl_tt, cl_ee, cl_bb, cl_te, cl_pp, lmax=None,
               sampling_factor=1.5, lmax_out=None):
    """Lensed TT, EE, BB, TE spectra (the ``camb.correlations.lensed_cls``
    role at reference ``orphics/cosmology.py:1206``).

    Inputs are unlensed spectra and the lensing-potential spectrum
    C_l^{phi phi}, all from l = 0. Returns dict with lensed 'TT','EE',
    'BB','TE' arrays up to ``lmax_out`` (default ``lmax``).
    """
    lmax = lmax or (len(np.asarray(cl_tt)) - 1)
    lmax_out = lmax_out or lmax
    beta, w, xi = lensed_correlations(cl_tt, cl_ee, cl_bb, cl_te, cl_pp,
                                      lmax=lmax,
                                      sampling_factor=sampling_factor)
    ll = np.arange(lmax_out + 1, dtype=np.float64)
    lam_norm = np.sqrt((2 * ll + 1) / (4 * np.pi))
    # project: Cl = 2pi int xi(b) d^l_{ab}(b) sin(b) db
    #             = 2pi sum_j w_j xi_j Lambda^l_{ab}(b_j)/sqrt((2l+1)/4pi)
    wxi = w[None, :] * xi
    out = {k: np.zeros(lmax_out + 1) for k in ("TT", "pp_sum", "mm_sum",
                                               "TE")}

    def acc_proj(l0, lam):
        nl = lam.shape[1]
        sl = slice(l0, l0 + nl)
        f = 2 * np.pi / lam_norm[sl]
        out["TT"][sl] = f * (lam[0] @ wxi[0])
        out["pp_sum"][sl] = f * (lam[1] @ wxi[1])
        out["mm_sum"][sl] = f * (lam[2] @ wxi[2])
        out["TE"][sl] = f * (lam[3] @ wxi[3])

    _dl_scan_pairs(_BASES, lmax_out, beta, block_accum=acc_proj)
    ee = 0.5 * (out["pp_sum"] + out["mm_sum"])
    bb = 0.5 * (out["pp_sum"] - out["mm_sum"])
    return {"TT": out["TT"], "EE": ee, "BB": bb, "TE": out["TE"]}
