"""Internal linear combination (ILC): Fourier-space, spectral, harmonic
(port of ``orphics_tpu.models.ilc``; reference ``orphics/maps.py:1952-2180``
and ``:371-470``).

Every function is batched linear algebra per Fourier pixel or per ell, as
einsums over the band axis, on the device of its inputs. Conventions follow
Delabrouille et al. / arXiv:1006.5599 as in the reference: ``silc`` Eq 4,
``cilc`` Eq 18.

The fused coadds (:func:`linear_coadd_fused` and its ``cilc_`` / ``silc_``
/ ``kspace_`` wrappers) run B3 ``colfft`` of packed band pairs, B9
``rowcombine_pp`` (the weighted band sum without per-band Fourier planes)
and B3/B4 ``ifft2pp`` of packed coadd pairs; :func:`coadd_from_y` starts
after the column pass, from a synthesis's pre-column ``Y'`` (the JAX
package's ``bench.py`` config 4 step). ``harmonic_coaddition`` and
``apply_harmonic_coadd_weights`` weight alms per ell (``ops/alm``).
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve
from ..ops import alm as almops
from ..ops import dft as D
from ..ops.interp import interp
from ..ops.rowcombine import rowcombine_pp
from .grf import eig_pow

__all__ = ["silc", "cilc", "silc_weights", "cilc_weights",
           "silc_noise", "cilc_noise", "ilc_cov", "ilc_cinv",
           "ilc_empirical_cov", "calculate_harmonic_coadd_weights",
           "harmonic_coaddition", "kspace_coadd", "ilc_map_term",
           "ilc_comb_a_b", "linear_coadd_fused", "cilc_coadd_fused",
           "silc_coadd_fused", "kspace_coadd_fused", "coadd_weights_pp",
           "coadd_from_y", "apply_harmonic_coadd_weights",
           "ilc_def_response", "ilc_index"]


def _as(x, like):
    """``x`` as a tensor of ``like``'s dtype and device."""
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def _def_response(response, cinv):
    if response is None:
        return torch.ones((cinv.shape[0],), dtype=cinv.dtype,
                          device=cinv.device)
    return _as(response, cinv)


def _safe_div(num, den):
    """``num / den`` where ``den != 0``, else 0."""
    ok = den.abs() > 0
    return torch.where(ok, num / torch.where(den == 0, 1.0, den), 0.0)


def ilc_map_term(kmaps, cinv, response):
    """``response^T . Cinv . kmaps`` (reference ``orphics/maps.py:2043``);
    complex k-maps are contracted as separate real and imaginary parts."""
    kmaps = torch.as_tensor(kmaps, device=cinv.device)
    response = _as(response, cinv)
    term = lambda x: torch.einsum("k,kl...,l...->...", response, cinv,
                                  x.to(cinv.dtype))
    if kmaps.is_complex():
        return torch.complex(term(kmaps.real), term(kmaps.imag))
    return term(kmaps)


def ilc_comb_a_b(response_a, response_b, cinv):
    """``a^T Cinv b`` per pixel or ell (reference ``maps.py:2047``)."""
    return torch.einsum("k,kl...,l->...", _as(response_a, cinv), cinv,
                        _as(response_b, cinv))


def silc(kmaps, cinv, response=None):
    """Standard ILC of ``(nfreq, ...)`` k-maps with ``(nfreq, nfreq, ...)``
    Cinv (reference ``maps.py:1952``)."""
    response = _def_response(response, cinv)
    return ilc_map_term(kmaps, cinv, response) * silc_noise(cinv, response)


def silc_noise(cinv, response=None):
    """ILC noise power ``1 / (a^T Cinv a)`` (reference ``maps.py:2025``)."""
    response = _def_response(response, cinv)
    d = ilc_comb_a_b(response, response, cinv)
    return _safe_div(torch.ones_like(d), d)


def cilc(kmaps, cinv, response_a, response_b):
    """Constrained ILC deprojecting component b (reference
    ``maps.py:1975``)."""
    brb = ilc_comb_a_b(response_b, response_b, cinv)
    arb = ilc_comb_a_b(response_a, response_b, cinv)
    arM = ilc_map_term(kmaps, cinv, response_a)
    brM = ilc_map_term(kmaps, cinv, response_b)
    ara = ilc_comb_a_b(response_a, response_a, cinv)
    return _safe_div(brb * arM - arb * brM, ara * brb - arb ** 2)


def silc_weights(cinv, response=None):
    """Per-band standard-ILC weights ``w`` with ``silc(kmaps) = sum_b w_b
    kmap_b`` (the ILC is linear in the maps)."""
    response = _def_response(response, cinv)
    cia = torch.einsum("kl...,l->k...", cinv, response)
    return cia * silc_noise(cinv, response)[None]


def cilc_weights(cinv, response_a, response_b):
    """Per-band constrained-ILC weights ``w`` with ``cilc(kmaps) = sum_b
    w_b kmap_b`` (deprojects ``response_b``)."""
    response_a = _as(response_a, cinv)
    response_b = _as(response_b, cinv)
    cia = torch.einsum("kl...,l->k...", cinv, response_a)
    cib = torch.einsum("kl...,l->k...", cinv, response_b)
    brb = ilc_comb_a_b(response_b, response_b, cinv)
    arb = ilc_comb_a_b(response_a, response_b, cinv)
    ara = ilc_comb_a_b(response_a, response_a, cinv)
    numer = brb[None] * cia - arb[None] * cib
    return _safe_div(numer, (ara * brb - arb ** 2)[None])


def cilc_noise(cinv, response_a, response_b):
    """Constrained-ILC noise power (reference ``maps.py:2030``)."""
    brb = ilc_comb_a_b(response_b, response_b, cinv)
    ara = ilc_comb_a_b(response_a, response_a, cinv)
    arb = ilc_comb_a_b(response_a, response_b, cinv)
    numer = brb ** 2 * ara + arb ** 2 * brb - brb * arb * arb - arb * brb * arb
    return _safe_div(numer, (ara * brb - arb ** 2) ** 2)


def ilc_cov(ells, cmb_ps, kbeams, freqs, noises, components=(), fdict=None,
            narray=None, analysis_beam=1.0, lmins=None, lmaxs=None,
            noise_only=False, inf=1e30):
    """The beam-deconvolved ``(nfreq, nfreq, ...)`` multi-frequency
    covariance in host float64 (reference ``orphics/maps.py:2082``): CMB +
    instrument noise (beam-deconvolved) + foreground components from
    ``fdict[comp](ells, f1, f2)`` callables."""
    ells = np.asarray(ells)
    nfreq = len(freqs)
    base = np.zeros((nfreq, nfreq) + ells.shape)
    cov = base + (0.0 if noise_only else np.asarray(cmb_ps)
                  * analysis_beam ** 2)
    if noise_only:
        components = ()
    for i in range(nfreq):
        for j in range(nfreq):
            if narray is not None:
                cov[i, j] += narray[i, j]
            elif i == j:
                with np.errstate(divide="ignore", invalid="ignore",
                                 over="ignore"):
                    instnoise = np.nan_to_num(
                        np.asarray(noises[i]) * analysis_beam ** 2
                        / np.asarray(kbeams[i]) ** 2)
                cov[i, j] = cov[i, j] + instnoise
            for comp in components:
                fg = np.nan_to_num(fdict[comp](ells, freqs[i], freqs[j]))
                fg[np.abs(fg) > 1e90] = 0
                cov[i, j] = cov[i, j] + fg * analysis_beam ** 2
            if i == j:
                if lmins is not None:
                    cov[i, j][ells < lmins[i]] = inf
                if lmaxs is not None:
                    cov[i, j][ells > lmaxs[i]] = inf
    return cov


def ilc_cinv(ells, cmb_ps, kbeams, freqs, noises, components=(), fdict=None,
             narray=None, eigpow=True, device=None, **kw):
    """``(cinv, cov)``: the inverse multi-frequency covariance as a float64
    tensor on ``device`` (the card unless it names another), inverted in
    float64 on the host, and the host covariance (reference
    ``maps.py:2146``)."""
    cov = np.nan_to_num(ilc_cov(ells, cmb_ps, kbeams, freqs, noises,
                                components, fdict=fdict, narray=narray, **kw))
    stack = torch.as_tensor(np.moveaxis(cov, (0, 1), (-2, -1)))
    cinv = eig_pow(stack, -1.0) if eigpow else torch.linalg.inv(stack)
    return torch.movedim(cinv, (-2, -1), (0, 1)).to(resolve(device)), cov


def ilc_empirical_cov(kmaps, binner=None, modlmap=None):
    """Isotropic empirical covariance from k-maps: bin ``|k_i k_j*|``
    radially with ``binner`` (a port ``Bin2D``) and re-paint it on the 2D
    ``modlmap`` (reference ``maps.py:2053``)."""
    p = (kmaps[:, None] * kmaps[None, :].conj()).real
    if binner is None:
        return p
    cents, p1d = binner.bin(p)
    modlmap = torch.as_tensor(modlmap, dtype=p.dtype, device=p.device)
    flat = p1d.reshape(-1, p1d.shape[-1])
    out = torch.stack([interp(modlmap.reshape(-1), np.asarray(cents), v,
                              left=float(v[0]), right=float(v[-1]))
                       for v in flat])
    return out.reshape(p.shape[:-2] + modlmap.shape)


def kspace_coadd(kmaps, kbeams, kncovs, fkbeam=1.0):
    """Noise-weighted coadd of non-deconvolved k-maps (reference
    ``orphics/maps.py:1098``): ``sum(k b f / N) / sum(b^2 / N)``."""
    kmaps = torch.as_tensor(kmaps)
    kbeams = torch.as_tensor(kbeams, device=kmaps.device)
    kncovs = torch.as_tensor(kncovs, device=kmaps.device)
    clean = lambda x: torch.nan_to_num(x, posinf=0.0, neginf=0.0)
    numer = clean(torch.sum(kmaps * kbeams * fkbeam / kncovs, dim=0))
    denom = torch.sum(kbeams ** 2 / kncovs, dim=0)
    return clean(numer / denom)


def calculate_harmonic_coadd_weights(lmax, cl_model, resp_factors, beams):
    """Per-ell ILC/coadd weights, host float64 (reference
    ``orphics/maps.py:371``): ``w_l = Cinv_l a_l / (a_l^T Cinv_l a_l)``
    with ``a_l = resp * B_l``. ``cl_model``: dict ``[(i, j)] -> C_l`` of
    the observed (beam-convolved) sky. Returns ``(lmax+1, nfreq)``."""
    nfreq = len(beams)
    for b in beams:
        if np.asarray(b).size < lmax + 1:
            raise ValueError("beam transfer does not cover multipole range")
    cov = np.zeros((lmax + 1, nfreq, nfreq))
    for i in range(nfreq):
        for j in range(i, nfreq):
            spec = np.asarray(cl_model[(i, j)])[: lmax + 1]
            cov[:, i, j] = cov[:, j, i] = spec
    if not np.all(np.isfinite(cov)):
        raise ValueError("non-finite covariance model")
    resp = np.ones(nfreq) if resp_factors is None else np.asarray(resp_factors)
    beams_mat = np.vstack([np.asarray(b)[: lmax + 1] for b in beams])
    a_mat = (resp[:, None] * beams_mat).T                     # (lmax+1, nfreq)
    cinv = np.zeros_like(cov)
    cinv[2:] = np.linalg.inv(cov[2:])
    num = np.einsum("lij,lj->li", cinv, a_mat)
    den = np.einsum("li,li->l", a_mat, num)
    w = np.zeros_like(num)
    w[2:] = num[2:] / den[2:, None]
    if not np.all(np.isfinite(w)):
        raise ValueError("non-finite weights")
    return w


def harmonic_coaddition(alms, beams, cl_model, target_beam, resp_factors=None,
                        return_weights=True):
    """Harmonic coaddition without explicit deconvolution (reference
    ``orphics/maps.py:442``): ``alm_out = sum_i almxfl(alm_i, w_li
    B_target)`` on the alms' device; the weights are host float64."""
    lmax = almops.getlmax(alms[0].shape[-1])
    w = calculate_harmonic_coadd_weights(lmax, cl_model, resp_factors, beams)
    tb = np.asarray(target_beam)[: lmax + 1]
    out = 0.0
    for i, alm in enumerate(alms):
        out = out + almops.almxfl(alm, w[:, i] * tb)
    return (out, w) if return_weights else out


def apply_harmonic_coadd_weights(alms, weights, target_beam):
    """Apply precomputed (lmax + 1, nfreq) per-ell coadd weights to a list
    of alms and convolve with the target beam (reference
    ``maps.py:339``)."""
    lmax = almops.getlmax(alms[0].shape[-1])
    w = np.asarray(weights)
    out = torch.zeros_like(alms[0])
    for k, a in enumerate(alms):
        out = out + almops.almxfl(a, w[: lmax + 1, k])
    return almops.almxfl(out, np.asarray(target_beam)[: lmax + 1])


def ilc_def_response(response, cinv):
    """Default CMB response, a vector of ones (reference
    ``maps.py:2006``)."""
    return _def_response(response, torch.as_tensor(cinv))


def ilc_index(ndim):
    """Einsum spectral-index string for a cinv of this ndim (reference
    ``maps.py:2014``): 'p' for 1D-power matrices, 'pq' for 2D k-space
    matrices."""
    if ndim == 3:
        return "p"
    if ndim == 4:
        return "pq"
    raise ValueError(ndim)


def coadd_weights_pp(w2d):
    """The B9 weight planes ``(alr, ali, ber, bei)`` of static per-band
    real weights ``w2d`` ``(nfreq, n, n)`` (a tensor in natural layout,
    ``nfreq`` even): ``alpha = (w_2q - i w_2q+1) / 2``, ``beta = (w_2q +
    i w_2q+1) / 2`` in the doubly-permuted layout, each ``(nfreq / 2, n,
    n)`` float32 and contiguous (the kernels refuse strided planes), on
    ``w2d``'s device."""
    w = w2d.to(torch.float32)
    if w.ndim != 3 or w.shape[0] % 2:
        raise ValueError("nfreq must be even (band-pair packing)")
    perm = torch.as_tensor(D.row_perm(w.shape[-1])[0], dtype=torch.long,
                           device=w.device)
    w_pp = w.index_select(1, perm).index_select(2, perm)
    wa, wb = w_pp[0::2], w_pp[1::2]
    return tuple(x.contiguous() for x in (0.5 * wa, -0.5 * wb, 0.5 * wa,
                                          0.5 * wb))


def coadd_from_y(yr, yi, weights):
    """Coadd maps ``(ncoadds, n, n)`` from the column-DFT intermediates
    ``(ncoadds nq, n, n)`` of packed band pairs (pair ``coadd nq + q``
    holds bands ``2q`` and ``2q + 1``) and :func:`coadd_weights_pp`'s
    planes: B9 ``rowcombine_pp``, then B3/B4 ``ifft2pp`` of coadd pairs
    packed as ``C1 + i C2`` (for Hermitian coadds, ``ifft2`` of the pair is
    ``map1 + i map2``). A synthesis passes its pre-column ``Y'``
    directly, since ``colfft(colifft(Y')) == Y'``."""
    nq = weights[0].shape[0]
    cr, ci = rowcombine_pp(yr, yi, *weights, nq)
    nco, n, _ = cr.shape
    if nco % 2 == 0:
        pr = (cr[0::2] - ci[1::2]).contiguous()
        pi = (ci[0::2] + cr[1::2]).contiguous()
        del cr, ci
        o1, o2 = D.ifft2pp(pr, pi)
        return torch.stack([o1, o2], dim=1).reshape(nco, n, n)
    return D.ifft2pp(cr, ci)[0]


def linear_coadd_fused(maps, w2d, device=None):
    """Coadd maps of per-band real maps under static per-band 2D weight
    planes, on the fused kernels (no per-band Fourier plane reaches device
    memory): ``out_j = ifft2(sum_b w_b o fft2(maps[j, b])).real``.

    ``maps``: ``(ncoadds, nfreq, n, n)`` real, ``nfreq`` even, on its own
    device if a tensor, else on ``device`` (the card unless it names
    another); ``w2d``: ``(nfreq, n, n)`` real weights in natural layout,
    mirror-symmetric (``w(-k) = w(k)``, true of any isotropic weights: the
    Hermitian packing of the coadd pairs relies on it). ``n = 128 B``.
    B3 ``colfft`` of the band pairs, then :func:`coadd_from_y`.
    """
    dev = _maps_device(maps, device)
    maps = torch.as_tensor(maps, dtype=torch.float32, device=dev)
    nco, nf, n, _ = maps.shape
    if nf % 2:
        raise ValueError("nfreq must be even (band-pair packing)")
    weights = coadd_weights_pp(torch.as_tensor(w2d, device=dev))
    m1 = maps[:, 0::2].reshape(nco * (nf // 2), n, n).contiguous()
    m2 = maps[:, 1::2].reshape(nco * (nf // 2), n, n).contiguous()
    return coadd_from_y(*D.colfft(m1, m2), weights)


def _maps_device(maps, device):
    return maps.device if isinstance(maps, torch.Tensor) else resolve(device)


def cilc_coadd_fused(maps, cinv, response_a, response_b, device=None):
    """Constrained-ILC coadd maps on the fused kernels, equal to
    ``ifft2(cilc(fft2(maps), cinv, a, b)).real`` for a mirror-symmetric
    (isotropic) ``cinv``; see :func:`linear_coadd_fused`."""
    dev = _maps_device(maps, device)
    cinv = torch.as_tensor(cinv, device=dev)
    return linear_coadd_fused(maps, cilc_weights(cinv, response_a,
                                                 response_b), dev)


def silc_coadd_fused(maps, cinv, response=None, device=None):
    """Standard-ILC coadd maps on the fused kernels (the ``silc``
    counterpart of :func:`cilc_coadd_fused`)."""
    dev = _maps_device(maps, device)
    cinv = torch.as_tensor(cinv, device=dev)
    return linear_coadd_fused(maps, silc_weights(cinv, response), dev)


def kspace_coadd_fused(maps, kbeams2d, kncovs2d, fkbeam=1.0, device=None):
    """Noise-weighted k-space coadd of non-deconvolved maps on the fused
    kernels (reference ``kspace_coadd`` semantics, ``maps.py:1098``:
    ``sum(k b f / N) / sum(b^2 / N)``, a static per-band linear filter)."""
    kbeams2d = np.asarray(kbeams2d, np.float64)
    kncovs2d = np.asarray(kncovs2d, np.float64)
    # zero-noise pixels give inf/inf = NaN weights that one transform
    # spreads to every output pixel: sanitize as kspace_coadd does
    with np.errstate(divide="ignore", invalid="ignore"):
        ib2 = np.nan_to_num(kbeams2d ** 2 / kncovs2d, posinf=0.0, neginf=0.0)
        denom = ib2.sum(axis=0)
        w2d = np.nan_to_num(
            kbeams2d * np.asarray(fkbeam) / kncovs2d
            / np.where(denom == 0, 1.0, denom),
            posinf=0.0, neginf=0.0)
    return linear_coadd_fused(maps, w2d.astype(np.float32),
                              _maps_device(maps, device))
