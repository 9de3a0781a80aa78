"""Ring-distributed spherical-harmonic transforms over a process mesh (port
of ``orphics_tpu.parallel.sht``).

The iso-latitude SHT decomposes over *rings*, as libsharp does over MPI
ranks. Each rank takes an equal block of the rings (the grid padded at the
south end with zero-weight rings, :func:`pad_rings`), as a
:class:`..ops.sht.RingGeom` of its own, and runs the port's Legendre
kernels on it in the unfolded layout ``"full"`` (a block is not
north-south symmetric):

* **Analysis** (:func:`map2alm_dist`, :func:`map2alm_spin_dist`): ring
  FFTs and B10a (``ops/legendre.legendre_ana``) over the rank's rings give
  a partial (l, m) matrix; one all-reduce over the ring axis completes it.
* **Synthesis** (:func:`alm2map_dist`): each rank runs B10s on its rings
  and the ring FFTs; one all-gather assembles the map.

The JAX functions run a plain XLA recursion here (``sht.py:293-308``); the
port's kernels take any ring set, so the ranks run them. Inputs are the
global arrays, each rank reading its rings; outputs are replicated.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import legendre as leg
from ..ops import sht
from .fourier import _on_mesh

__all__ = ["map2alm_dist", "alm2map_dist", "map2alm_spin_dist", "pad_rings"]


def pad_rings(rings: sht.RingGeom, ndev: int):
    """Pad a ring geometry to a ring count divisible by ``ndev``:
    returns (theta, weights, npad) arrays with zero-weight rings at the
    south end (zero quadrature weight => exact no-ops in analysis)."""
    T = rings.ntheta
    Tpad = -(-T // ndev) * ndev
    theta = np.concatenate([rings.theta_array(),
                            np.full(Tpad - T, np.pi / 2)])
    w = np.concatenate([rings.weights_array(), np.zeros(Tpad - T)])
    return theta, w, Tpad - T


def _ring_block(rings: sht.RingGeom, ax):
    """(the rank's rings as a RingGeom, their first row, their count) for
    the padded grid split over ``ax``."""
    theta, w, _ = pad_rings(rings, ax.size)
    Tl = len(theta) // ax.size
    r0 = ax.index * Tl
    sub = sht.RingGeom(tuple(theta[r0: r0 + Tl]), tuple(w[r0: r0 + Tl]),
                       rings.nphi, rings.phi0)
    return sub, r0, Tl


def _rows(maps, r0, Tl):
    """Rows [r0, r0 + Tl) of (B, T, nphi) maps, zero rows past T."""
    out = maps[:, r0: r0 + Tl]
    if out.shape[1] < Tl:
        pad = out.new_zeros((out.shape[0], Tl - out.shape[1], out.shape[2]))
        out = torch.cat([out, pad], dim=1)
    return out


def _map2alm_local(m_l, sub, lmax):
    """Per-rank body of the analysis: (B, Tl, nphi) maps on the rank's
    rings ``sub`` -> their partial (B, L1, M1) matrix (B10a, layout
    ``"full"``)."""
    G = sht._ring_analysis(m_l, sub, lmax) \
        * sht._weights(sub, m_l.dtype, m_l.device)[:, None]
    tab = leg.tables(lmax, sub, (0,), 0, "full", m_l.device)
    return leg.legendre_ana(G, tab)


def map2alm_dist(maps, rings: sht.RingGeom, lmax: int, mesh,
                 axis: str = "sims"):
    """Ring-distributed analysis: healpy-packed alm from (..., ntheta,
    nphi) maps, the rings split over mesh axis ``axis``. Each rank runs the
    ring FFTs and B10a over its rings; one all-reduce of the partial (l, m)
    matrices completes the alm on every rank."""
    ax = mesh.axis(axis)
    maps = sht._real_input(_on_mesh(maps, mesh), "maps")
    bshape, m = sht._flat(maps, 2)
    sub, r0, Tl = _ring_block(rings, ax)
    mat = ax.all_reduce(_map2alm_local(_rows(m, r0, Tl), sub, lmax))
    return sht._mat2alm(mat, lmax).reshape(bshape + (-1,))


def _alm2map_local(a, sub, lmax):
    """Per-rank body of the synthesis: (B, nalm) alm -> the (B, Tl, nphi)
    maps on the rank's rings ``sub`` (B10s, layout ``"full"``)."""
    tab = leg.tables(lmax, sub, (0,), 0, "full", a.device)
    return sht._ring_synthesis(leg.legendre_syn(sht._alm2mat(a, lmax), tab),
                               sub)


def alm2map_dist(alm, rings: sht.RingGeom, lmax: int, mesh,
                 axis: str = "sims"):
    """Ring-distributed synthesis: healpy-packed alm (..., nalm) -> real
    maps (..., ntheta, nphi). Each rank synthesizes its rings (B10s and the
    ring FFTs); one all-gather over ``axis`` returns the full map on every
    rank."""
    ax = mesh.axis(axis)
    bshape, a = sht._flat(_on_mesh(alm, mesh), 1)
    sub, _, _ = _ring_block(rings, ax)
    full = ax.all_gather(_alm2map_local(a, sub, lmax), 1)
    return full[:, : rings.ntheta].reshape(bshape + tuple(rings.shape))


def _map2alm_spin_local(q_l, u_l, sub, lmax, spin):
    """Per-rank body of the spin analysis: the rank's (Q, U) rings -> the
    partial (2, B, L1, M1) matrices of the n = -s and n = +s transforms
    (two B10a calls, layout ``"full"``)."""
    Fp, Fm, w = sht._spin_ring_analysis(q_l, u_l, sub, lmax)
    ns = (-spin, spin)
    ap = leg.legendre_ana(Fp * w[:, None],
                          leg.tables(lmax, sub, ns, 0, "full", q_l.device))
    am = leg.legendre_ana(Fm * w[:, None],
                          leg.tables(lmax, sub, ns, 1, "full", q_l.device))
    return torch.stack([ap, am])


def map2alm_spin_dist(qmap, umap, rings: sht.RingGeom, lmax: int, mesh,
                      axis: str = "sims", spin: int = 2):
    """Ring-distributed spin-s analysis: (Q, U) maps with their rings split
    over ``axis`` -> (E, B) alms, by per-rank B10a calls over the rank's
    rings and one all-reduce."""
    sht._check_even_spin(spin)
    ax = mesh.axis(axis)
    qmap = sht._real_input(_on_mesh(qmap, mesh), "qmap")
    bshape, q = sht._flat(qmap, 2)
    _, u = sht._flat(_on_mesh(umap, mesh), 2)
    sub, r0, Tl = _ring_block(rings, ax)
    ap, am = ax.all_reduce(_map2alm_spin_local(
        _rows(q, r0, Tl), _rows(u, r0, Tl), sub, lmax, int(spin)))
    e = sht._mat2alm(-0.5 * (ap + am), lmax)
    b = sht._mat2alm(0.5j * (ap - am), lmax)
    return e.reshape(bshape + (-1,)), b.reshape(bshape + (-1,))
