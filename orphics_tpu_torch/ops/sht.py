"""Spherical-harmonic transforms on iso-latitude rings (port of
``orphics_tpu.ops.sht``).

Replaces the reference's ``pixell.curvedsky`` / ``healpy.sphtfunc`` use
(reference ``orphics/maps.py:2,744,1009``). The sphere is sampled on
iso-latitude rings (:class:`RingGeom`: Gauss-Legendre or Clenshaw-Curtis,
both exact quadratures for band-limited fields); maps are dense ``(...,
ntheta, nphi)`` tensors. Longitude is handled by ring FFTs (``torch.fft``),
latitude by the normalized Wigner-d functions ``Lambda_l^{m,n}(theta) =
sqrt((2l+1)/4pi) d^l_{mn}(theta)`` from the three-term recurrence in l,
whose tables and transforms live in :mod:`.legendre` (kernels B10a/B10s on
the card, the plain float64 loop on the CPU).

Conventions match healpy: Condon-Shortley phase, alm packed in m-major
triangular order (:mod:`.alm`), ``a_{+-2,lm} = -(E_lm +- i B_lm)``.
Float32 inputs give complex64 / float32 outputs, float64 inputs 128 / 64.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache, partial

import numpy as np
import torch

from ..utils.profiling import spanned
from . import alm as almops
from . import legendre as leg
# packing, (l, m) matrix <-> healpy triangular order
from .legendre import _alm2mat, _mat2alm  # noqa: F401

__all__ = ["RingGeom", "gauss_legendre_rings", "clenshaw_curtis_rings",
           "map2alm", "alm2map", "map2alm_spin", "alm2map_spin",
           "map2alm_pol", "alm2map_pol"]


# ---------------------------------------------------------------------------
# Ring geometries
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RingGeom:
    """Iso-latitude ring sampling of the full sphere: colatitudes
    ``theta`` (ascending from the north pole), quadrature weights (with the
    ``sin(theta) dtheta`` measure), ``nphi`` equispaced samples per ring
    starting at longitude ``phi0``."""

    theta: tuple
    weights: tuple
    nphi: int
    phi0: float = 0.0

    @property
    def ntheta(self) -> int:
        return len(self.theta)

    @property
    def shape(self):
        return (self.ntheta, self.nphi)

    def theta_array(self):
        return np.asarray(self.theta, np.float64)

    def weights_array(self):
        return np.asarray(self.weights, np.float64)


def _fast_fft_len(n: int) -> int:
    """Smallest 5-smooth integer >= n (friendly FFT length)."""
    m = n
    while True:
        k = m
        for p in (2, 3, 5):
            while k % p == 0:
                k //= p
        if k == 1:
            return m
        m += 1


@lru_cache(maxsize=16)
def gauss_legendre_rings(lmax: int, nphi: int = None, phi0: float = 0.0):
    """Gauss-Legendre ring grid: exact analysis quadrature for band limit
    ``lmax`` with the minimal ``lmax + 1`` rings."""
    ntheta = lmax + 1
    try:
        from scipy.special import roots_legendre
        x, w = roots_legendre(ntheta)
    except ImportError:
        x, w = np.polynomial.legendre.leggauss(ntheta)
    theta = np.arccos(x)[::-1]
    w = w[::-1]
    if nphi is None:
        nphi = _fast_fft_len(2 * lmax + 1)
    return RingGeom(tuple(theta), tuple(w), int(nphi), float(phi0))


@lru_cache(maxsize=16)
def clenshaw_curtis_rings(ntheta: int, nphi: int = None, phi0: float = 0.0):
    """Equiangular grid with poles included, ``theta_j = j pi / (ntheta -
    1)``; the weights solve the cosine moment conditions (a DCT-I), so
    analysis is exact for ``2 lmax + 1 <= ntheta``."""
    if ntheta < 2:
        raise ValueError("need at least 2 rings")
    M = ntheta - 1
    theta = np.arange(ntheta) * (np.pi / M)
    k = np.arange(ntheta)
    with np.errstate(divide="ignore", invalid="ignore"):
        I = (1.0 + np.cos(np.pi * k)) / (1.0 - k.astype(np.float64) ** 2)
    I[1] = 0.0
    ext = np.concatenate([I, I[-2:0:-1]])
    w = np.fft.rfft(ext).real / M
    w[0] *= 0.5
    w[-1] *= 0.5
    chk = np.cos(np.outer(k[: min(8, ntheta)], theta)) @ w
    if not np.allclose(chk, I[: min(8, ntheta)], atol=1e-10):
        raise AssertionError("CC quadrature weights failed moment check")
    if nphi is None:
        nphi = _fast_fft_len(2 * ntheta - 1)
    return RingGeom(tuple(theta), tuple(w), int(nphi), float(phi0))


# ---------------------------------------------------------------------------
# Ring FFTs
# ---------------------------------------------------------------------------

@lru_cache(maxsize=32)
def _phase_tensor(mmax, phi0, sign, dtype, device: str):
    """:func:`_phase` on ``device`` (cached, as are the other small tables
    below: a host copy per call would stall the stream)."""
    m = np.arange(mmax + 1)
    return torch.as_tensor(np.exp(sign * 1j * m * phi0), dtype=dtype,
                           device=device)


def _phase(mmax, phi0, sign, dtype, device):
    """``exp(sign i m phi0)`` for m = 0..mmax."""
    return _phase_tensor(mmax, phi0, sign, dtype, str(device))


def _ring_phase(rings: RingGeom, mmax: int, sign: int, device):
    """``exp(sign i m phi0)`` (m = 0..mmax) in complex128 for the kernels'
    ring side, or None where ``phi0 = 0`` (a multiply by 1)."""
    if rings.phi0 == 0.0:
        return None
    return _phase(mmax, rings.phi0, sign, torch.complex128, device)


def _rfft_rings(maps, rings: RingGeom, mmax: int):
    """``rfft`` of each ring, all ``nphi // 2 + 1`` frequencies."""
    nphi = rings.nphi
    if nphi < 2 * mmax + 1:
        raise ValueError(
            f"nphi={nphi} < 2*mmax+1={2*mmax+1}: ring FFT would alias")
    if maps.shape[-1] != nphi:
        raise ValueError(
            f"map phi axis {maps.shape[-1]} != rings.nphi {nphi}: the "
            "quadrature normalization and sample phases would be wrong")
    return torch.fft.rfft(maps, dim=-1)


@spanned("orphics.transforms.ring_fft")
def _ring_fft(maps, rings: RingGeom, mmax: int):
    """:func:`_rfft_rings` in the ring FFT's span (the half spectrum that
    B10a reads in place)."""
    return _rfft_rings(maps, rings, mmax)


@spanned("orphics.transforms.ring_fft")
def _ring_analysis(maps, rings: RingGeom, mmax: int):
    """FFT each ring: ``F[..., T, M+1] = sum_j f e^{-i m phi_j}``."""
    F = _rfft_rings(maps, rings, mmax)[..., : mmax + 1]
    return F * _phase(mmax, rings.phi0, -1, F.dtype, F.device)


def _check_synthesis(rings: RingGeom, mmax: int):
    if rings.nphi < 2 * mmax + 1:
        raise ValueError("nphi too small for mmax (synthesis would "
                         "alias the top m onto the Nyquist bin)")


@spanned("orphics.transforms.ring_ifft")
def _ring_synthesis(Fm, rings: RingGeom):
    """Inverse of :func:`_ring_analysis` for a real field:
    ``Fm[..., T, M+1] -> maps[..., T, nphi]``."""
    nphi = rings.nphi
    mmax = Fm.shape[-1] - 1
    _check_synthesis(rings, mmax)
    X = Fm * _phase(mmax, rings.phi0, 1, Fm.dtype, Fm.device)
    X = torch.nn.functional.pad(X, (0, nphi // 2 + 1 - (mmax + 1)))
    return torch.fft.irfft(X, n=nphi, dim=-1) * nphi


@spanned("orphics.transforms.ring_ifft")
def _ring_ifft(X, rings: RingGeom):
    """The rings of the half spectrum ``X[..., T, nphi // 2 + 1]`` (its
    phase applied): ``irfft`` unnormalized, ``sum_m X e^{i m phi_j}``."""
    return torch.fft.irfft(X, n=rings.nphi, dim=-1, norm="forward")


@lru_cache(maxsize=32)
def _weights_tensor(rings: RingGeom, dtype, device: str):
    w = rings.weights_array() * (2.0 * np.pi / rings.nphi)
    return torch.as_tensor(w, dtype=dtype, device=device)


def _weights(rings: RingGeom, dtype, device):
    """Quadrature weights times 2 pi / nphi, in ``dtype``."""
    return _weights_tensor(rings, dtype, str(device))


@lru_cache(maxsize=32)
def _neg_index(lmax, nphi, device: str):
    """The FFT bins of the frequencies -m, m = 0..lmax."""
    return torch.as_tensor((-np.arange(lmax + 1)) % nphi, device=device)


def _spin_ring_analysis(qmap, umap, rings: RingGeom, lmax: int):
    """``F+- = FFT(Q +- iU)`` at the +m frequencies with the phi0 phase,
    and the quadrature weights. One complex FFT serves both:
    ``fft(Q - iU)[m] = conj(fft(Q + iU)[-m])``. Returns (Fp, Fm, w)."""
    if rings.nphi < 2 * lmax + 1:
        raise ValueError("nphi too small for requested lmax")
    w = _weights(rings, qmap.dtype, qmap.device)
    F = torch.fft.fft(torch.complex(qmap, umap), dim=-1)
    phase = _phase(lmax, rings.phi0, -1, F.dtype, F.device)
    neg = _neg_index(lmax, rings.nphi, str(F.device))
    Fp = F[..., : lmax + 1] * phase
    Fm = F.index_select(-1, neg).conj() * phase
    return Fp, Fm, w


# ---------------------------------------------------------------------------
# Public transforms (the Legendre step is ops/legendre.py)
# ---------------------------------------------------------------------------

def _check_even_spin(spin):
    if spin % 2:
        raise NotImplementedError(
            "odd spins: the real-pair convention (Q -+ iU Hermitian "
            "reconstruction) is only valid for even spin")


def _real_input(x, what):
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what} must be float32 or float64, got {x.dtype}")
    return x


def _flat(x, core):
    """(batch shape, x reshaped to (B,) + core shape)."""
    bshape = tuple(x.shape[: x.ndim - core])
    return bshape, x.reshape((-1,) + tuple(x.shape[x.ndim - core:]))


def _layout(rings):
    return "fold" if leg._rings_symmetric(rings) else "full"


def map2alm(maps, rings: RingGeom, lmax: int, fast: bool = False, *,
            ana=None):
    """Analysis: ``(..., ntheta, nphi)`` real map(s) -> healpy-packed alm:
    ring FFTs, the quadrature weights, then the Legendre analysis (folded
    on north-south symmetric grids). ``fast=True`` runs the kernel's
    plain-fp32 recurrence on float32 CUDA tensors (a speed-for-accuracy
    option); float64 inputs and the CPU's plain version ignore it. ``ana(G,
    tab)`` replaces the Legendre analysis (default
    :func:`.legendre.legendre_ana`; ``legendre.legendre_ana_ref`` runs the
    plain version on any device). On the card with the default, B10a reads
    the ``rfft`` output in place, phase and weights applied on load, and
    writes the packed alms (:func:`_analysis_rings`)."""
    maps = _real_input(torch.as_tensor(maps), "maps")
    bshape, m = _flat(maps, 2)
    tab = leg.tables(lmax, rings, (0,), 0, _layout(rings), m.device)
    if ana is None and m.is_cuda:
        alm = _analysis_rings(m, rings, lmax, tab, fast)
    else:
        ana = ana or partial(leg.legendre_ana, fast=fast)
        w = _weights(rings, m.dtype, m.device)
        G = _ring_analysis(m, rings, lmax) * w[:, None]
        alm = _mat2alm(ana(G, tab), lmax)
    return alm.reshape(bshape + (-1,))


def _analysis_rings(m, rings: RingGeom, lmax: int, tab, fast: bool):
    """The analysis on the kernel's layouts: ``rfft`` of (B, T, nphi) maps
    -> :func:`.legendre.legendre_ana` on the half spectrum as it is, with
    ``exp(-i m phi0)`` and the float64 weights -> packed (B, nalm)."""
    F = _ring_fft(m, rings, lmax)
    return leg.legendre_ana(F, tab, fast,
                            _weights(rings, torch.float64, m.device),
                            _ring_phase(rings, lmax, -1, m.device), True)


def alm2map(alm, rings: RingGeom, lmax: int = None, fast: bool = False, *,
            syn=None):
    """Synthesis: healpy-packed alm ``(..., nalm)`` -> real map(s)
    ``(..., ntheta, nphi)``: the Legendre synthesis (folded on symmetric
    grids), then ring FFTs. ``fast``: see :func:`map2alm`; ``syn(a, tab)``
    replaces the Legendre synthesis (default
    :func:`.legendre.legendre_syn`). On the card with the default, B10s
    reads the packed alms and writes the half spectrum that ``irfft`` reads
    (:func:`_synthesis_rings`)."""
    alm = torch.as_tensor(alm)
    if lmax is None:
        lmax = almops.getlmax(alm.shape[-1])
    bshape, a = _flat(alm, 1)
    tab = leg.tables(lmax, rings, (0,), 0, _layout(rings), a.device)
    if syn is None and a.is_cuda:
        out = _synthesis_rings(a, rings, lmax, tab, fast)
    else:
        syn = syn or partial(leg.legendre_syn, fast=fast)
        out = _ring_synthesis(syn(_alm2mat(a, lmax), tab), rings)
    return out.reshape(bshape + tuple(rings.shape))


def _synthesis_rings(a, rings: RingGeom, lmax: int, tab, fast: bool):
    """The synthesis on the kernel's layouts: packed (B, nalm) ->
    :func:`.legendre.legendre_syn` into the (B, T, nphi // 2 + 1) half
    spectrum, ``exp(i m phi0)`` applied and zero past lmax -> unnormalized
    ``irfft``."""
    _check_synthesis(rings, lmax)
    X = leg.legendre_syn(a, tab, fast, _ring_phase(rings, lmax, 1, a.device),
                         True, rings.nphi // 2 + 1)
    return _ring_ifft(X, rings)


def map2alm_spin(qmap, umap, rings: RingGeom, lmax: int, spin: int = 2,
                 fast: bool = False, *, ana=None):
    """Analysis of a spin-``s`` field: (Q, U) maps -> (E, B) alms. Two
    Legendre transforms, n = -s of F(Q + iU) and n = +s of F(Q - iU); on a
    symmetric grid each runs the northern rings and contracts [own north,
    other's flipped south], and the reflection ``d(pi - t) = (-1)^(l+m)
    d_{n -> -n}(t)`` assembles both (``pallas_sht.py:1594-1615``).
    ``fast``, ``ana``: see :func:`map2alm`."""
    _check_even_spin(spin)
    ana = ana or partial(leg.legendre_ana, fast=fast)
    qmap = _real_input(torch.as_tensor(qmap), "qmap")
    bshape, q = _flat(qmap, 2)
    _, u = _flat(torch.as_tensor(umap), 2)
    ns = (-spin, spin)
    Fp, Fm, w = _spin_ring_analysis(q, u, rings, lmax)
    Gp = Fp * w[:, None]
    Gm = Fm * w[:, None]
    dev = q.device
    if leg._rings_symmetric(rings):
        nb, T = q.shape[0], rings.ntheta
        tab0 = leg.tables(lmax, rings, ns, 0, "half", dev)
        tab1 = leg.tables(lmax, rings, ns, 1, "half", dev)
        par = leg._parity_grid(lmax, Gp.real.dtype, str(dev))
        Gpn, Gps = leg._north_south(Gp, T)
        Gmn, Gms = leg._north_south(Gm, T)
        out0 = ana(torch.cat([Gpn, Gms]), tab0)
        out1 = ana(torch.cat([Gmn, Gps]), tab1)
        ap = out0[:nb] + par * out1[nb:]
        am = out1[:nb] + par * out0[nb:]
    else:
        ap = ana(Gp, leg.tables(lmax, rings, ns, 0, "full", dev))
        am = ana(Gm, leg.tables(lmax, rings, ns, 1, "full", dev))
    e = _mat2alm(-0.5 * (ap + am), lmax)
    b = _mat2alm(0.5j * (ap - am), lmax)
    return e.reshape(bshape + (-1,)), b.reshape(bshape + (-1,))


def alm2map_spin(ealm, balm, rings: RingGeom, lmax: int = None,
                 spin: int = 2, fast: bool = False, *, syn=None):
    """Synthesis of a spin-``s`` field: (E, B) alms -> (Q, U) maps, with
    ``a_{+-s} = -(E +- iB)`` (healpy / Zaldarriaga-Seljak for s = 2)
    through the n = -s / +s transforms, ``q_m = (Sp + Sm)/2``, ``u_m = -i
    (Sp - Sm)/2``; on a symmetric grid the southern rows of each come from
    the other n's northern synthesis of the parity-signed a-matrix
    (``pallas_sht.py:1620-1645``). ``fast``, ``syn``: see
    :func:`alm2map`."""
    _check_even_spin(spin)
    syn = syn or partial(leg.legendre_syn, fast=fast)
    ealm = torch.as_tensor(ealm)
    if lmax is None:
        lmax = almops.getlmax(ealm.shape[-1])
    bshape, e = _flat(ealm, 1)
    _, b = _flat(torch.as_tensor(balm), 1)
    ns = (-spin, spin)
    emat = _alm2mat(e, lmax)
    bmat = _alm2mat(b, lmax)
    ap = -(emat + 1j * bmat)
    am = -(emat - 1j * bmat)
    dev = e.device
    if leg._rings_symmetric(rings):
        nb, half = e.shape[0], rings.ntheta // 2
        tab0 = leg.tables(lmax, rings, ns, 0, "half", dev)
        tab1 = leg.tables(lmax, rings, ns, 1, "half", dev)
        par = leg._parity_grid(lmax, e.real.dtype, str(dev))
        out0 = syn(torch.cat([ap, par * am]), tab0)
        out1 = syn(torch.cat([am, par * ap]), tab1)
        Sp = torch.cat([out0[:nb], torch.flip(out1[nb:, :half], dims=(1,))],
                       dim=1)
        Sm = torch.cat([out1[:nb], torch.flip(out0[nb:, :half], dims=(1,))],
                       dim=1)
    else:
        Sp = syn(ap, leg.tables(lmax, rings, ns, 0, "full", dev))
        Sm = syn(am, leg.tables(lmax, rings, ns, 1, "full", dev))
    q = _ring_synthesis(0.5 * (Sp + Sm), rings)
    u = _ring_synthesis(-0.5j * (Sp - Sm), rings)
    shape = bshape + tuple(rings.shape)
    return q.reshape(shape), u.reshape(shape)


def map2alm_pol(tqu, rings: RingGeom, lmax: int, fast: bool = False):
    """``(..., 3, ntheta, nphi)`` T, Q, U maps -> ``(..., 3, nalm)`` T, E,
    B alms."""
    t = map2alm(tqu[..., 0, :, :], rings, lmax, fast=fast)
    e, b = map2alm_spin(tqu[..., 1, :, :], tqu[..., 2, :, :], rings, lmax,
                        fast=fast)
    return torch.stack([t, e, b], dim=-2)


def alm2map_pol(teb, rings: RingGeom, lmax: int = None, fast: bool = False):
    """``(..., 3, nalm)`` T, E, B alms -> ``(..., 3, ntheta, nphi)`` T, Q,
    U maps."""
    t = alm2map(teb[..., 0, :], rings, lmax, fast=fast)
    q, u = alm2map_spin(teb[..., 1, :], teb[..., 2, :], rings, lmax,
                        fast=fast)
    return torch.stack([t, q, u], dim=-3)
