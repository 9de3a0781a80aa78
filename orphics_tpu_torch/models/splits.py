"""Split-based spectra: signal from crosses, noise from auto-minus-cross,
coadds, and Knox-style errors (port of ``orphics_tpu.models.splits``).

Reference: ``orphics/maps.py`` — ``split_calc`` (:2296),
``noise_from_splits`` (:2337), ``cross_split_spectrum`` (:97),
``error_fsky``/``crossband_errors`` (:160,:165). Batched tensor math on
the inputs' device; a host array goes to ``device`` (``None``: the card).
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import as_tensor as _t

from ..geometry import Geometry, arcmin
from ..ops import fourier as F

__all__ = ["split_calc", "noise_from_splits", "cross_split_spectrum",
           "cross_split_spectrum_alms", "error_fsky", "crossband_errors"]


def split_calc(iksplits, jksplits, ikcoadd, jkcoadd, geom: Geometry,
               alt: bool = True):
    """(total, signal-crosses, noise) 2D power estimates from split k-maps
    (reference ``orphics/maps.py:2296``).

    ``iksplits``: (nsplits, ny, nx) raw ffts of windowed maps.
    """
    total = F.f2power(ikcoadd, jkcoadd, geom)
    n = iksplits.shape[0]
    if alt:
        d1 = iksplits - ikcoadd[None]
        d2 = jksplits - jkcoadd[None]
        noise = F.f2power(d1, d2, geom).sum(dim=0)
        noise = noise / ((1.0 - 1.0 / n) * n ** 2)
        crosses = total - noise
    else:
        pij = F.f2power(iksplits[:, None], jksplits[None, :], geom)
        mask = 1.0 - torch.eye(n, dtype=pij.dtype, device=pij.device)
        crosses = torch.einsum("ij,ij...->...", mask, pij) / (n * (n - 1))
        noise = total - crosses
    return total, crosses, noise


def noise_from_splits(splits, geom: Geometry, do_cross: bool = True,
                      iau: bool = False, device=None):
    """Noise power (auto - cross)/nsplits and TEB cross power from split
    maps (reference ``orphics/maps.py:2337``).

    ``splits``: (nsplits, ncomp, ny, nx) real maps (ncomp 1 or 3).
    Returns (noise_iqu, cross_teb).
    """
    splits = _t(splits, device)
    if splits.ndim == 3:
        splits = splits[:, None]
    nsplits, ncomp = splits.shape[:2]
    ksplits = F.fft2(splits, geom, "raw")  # I,Q,U (un-rotated)
    if do_cross and ncomp == 3:
        kteb = F.iqu2teb(ksplits, geom, iau=iau)
    else:
        kteb = ksplits

    def pmat(k1, k2):
        return F.f2power(k1[..., :, None, :, :], k2[..., None, :, :, :], geom)

    auto = sum(pmat(ksplits[i], ksplits[i]) for i in range(nsplits)) / nsplits
    ncross = nsplits * (nsplits - 1) / 2
    cross = sum(pmat(ksplits[i], ksplits[j])
                for i in range(nsplits) for j in range(i + 1, nsplits)) / ncross
    noise = (auto - cross) / nsplits
    cross_teb = None
    if do_cross:
        cross_teb = sum(pmat(kteb[i], kteb[j])
                        for i in range(nsplits)
                        for j in range(i + 1, nsplits)) / ncross
    return noise, cross_teb


def cross_split_spectrum(kmaps1, kmaps2=None, geom: Geometry = None,
                         binner=None, device=None):
    """Mean cross 2D power over all split pairs i != j from k-maps —
    flat-sky analog of reference ``orphics/maps.py:97``."""
    kmaps1 = _t(kmaps1, device)
    kmaps2 = kmaps1 if kmaps2 is None else _t(kmaps2, kmaps1.device)
    n = kmaps1.shape[0]
    if n < 2:
        raise ValueError("need at least two splits")
    p = F.f2power(kmaps1[:, None], kmaps2[None, :], geom)
    mask = (1.0 - torch.eye(n, dtype=p.dtype, device=p.device)).reshape(
        (n, n) + (1,) * (p.ndim - 2))
    spec = (p * mask).sum(dim=(0, 1)) / (n * (n - 1))
    if binner is not None:
        # the port's Bin2D sums float32 planes (in float64)
        return binner.bin(spec.to(torch.float32).contiguous())
    return spec


def cross_split_spectrum_alms(alms1, alms2=None, device=None):
    """Curved-sky version from alms (reference ``orphics/maps.py:97``)."""
    from ..ops.alm import alm2cl
    alms1 = _t(alms1, device)
    alms2 = alms1 if alms2 is None else _t(alms2, alms1.device)
    if alms1.ndim != 2 or alms2.ndim != 2:
        raise ValueError("alms must be (nsplits, nalm)")
    n = alms1.shape[0]
    if alms2.shape[0] != n:
        raise ValueError("number of splits should match")
    spec = 0.0
    count = 0
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            spec = spec + alm2cl(alms1[i], alms2[j])
            count += 1
    if count == 0:
        raise ValueError("need at least two splits")
    return spec / count


def error_fsky(mask):
    """Effective sky fraction <W^2>^2/<W^4> (reference ``maps.py:160``);
    a tensor or a host array."""
    m = mask.double() if isinstance(mask, torch.Tensor) \
        else np.asarray(mask, dtype=np.float64)
    m2 = (m ** 2).mean()
    m4 = (m ** 4).mean()
    return float(m2 ** 2 / m4)


def crossband_errors(cltt, ell_bin_edges, rmsA_ukarcmin, rmsB_ukarcmin,
                     beamA_ell, beamB_ell, n_splits=1, mask=None,
                     f_sky_eff=None):
    """Knox-style 1-sigma errors on beam-deconvolved TT cross bandpowers
    (reference ``orphics/maps.py:165``). Host-side numpy (forecasting)."""
    cltt = np.asarray(cltt, float)
    if np.max(ell_bin_edges) >= cltt.size:
        raise ValueError(
            f"ell_bin_edges reach {int(np.max(ell_bin_edges))} but the "
            f"theory table only extends to l={cltt.size - 1}")
    beamA = np.asarray(beamA_ell, float)
    beamB = np.asarray(beamB_ell, float)
    if f_sky_eff is None:
        f_sky_eff = error_fsky(mask)
    elif mask is not None:
        raise ValueError("give mask or f_sky_eff, not both")
    n_splits = int(n_splits)
    sigA = rmsA_ukarcmin * arcmin
    sigB = rmsB_ukarcmin * arcmin
    N_A = n_splits * sigA ** 2
    N_B = n_splits * sigB ** 2
    with np.errstate(divide="ignore", invalid="ignore"):
        NAd = np.where(beamA > 0, N_A / beamA ** 2, np.inf)
        NBd = np.where(beamB > 0, N_B / beamB ** 2, np.inf)
    C = cltt
    S_l = C * C + (C + NAd) * (C + NBd)
    M = n_splits ** 2
    edges = np.asarray(ell_bin_edges, int)
    L = cltt.size
    ells = np.arange(L)
    w21 = 2 * ells + 1
    valid = (beamA > 0) & (beamB > 0)
    nb = len(edges) - 1
    cents = 0.5 * (edges[:-1] + edges[1:])
    sigma = np.zeros(nb)
    for b in range(nb):
        idx = np.arange(edges[b], edges[b + 1])
        idx = idx[valid[edges[b]:edges[b + 1]]]
        if idx.size == 0:
            sigma[b] = np.nan
            continue
        W = w21[idx].sum()
        S_bar = np.sum(w21[idx] * S_l[idx]) / W
        sigma[b] = np.sqrt(S_bar / (W * f_sky_eff * M))
    return cents, sigma
