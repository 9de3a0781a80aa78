"""Gaussian random field synthesis from theory spectra (port of
``orphics_tpu.models.grf``).

Conventions, as in the JAX package:
  * covsqrt in "map_mul units": ``sqrt(C2d * npix / area)``;
  * white noise eta = N(0,1) + i N(0,1) per Fourier pixel; the real part
    of the unitary inverse FFT of ``covsqrt * eta`` is the map.

Every draw comes in two forms: one takes an explicit ``torch.Generator``
(on the device of the output), and a ``*_from_noise`` twin takes the
white noise itself, so that tests can feed both packages the same draws.
"""
from __future__ import annotations

import numpy as np
import torch

from ..geometry import Geometry
from ..ops import fourier as F

__all__ = ["eig_pow", "spec2flat", "rand_kmap", "harm2map", "rand_map",
           "rand_map_from_noise", "covsqrt_half", "rand_hermitian_half",
           "hermitian_half_from_noise", "rand_map_r", "rand_map_r_from_noise",
           "MapGen"]


def eig_pow(mat, exp, lim=1e-30):
    """Matrix power of symmetric ``(..., n, n)`` via eigendecomposition;
    eigenvalues below ``lim`` relative to the max are zeroed."""
    mat = torch.as_tensor(mat)
    w, v = torch.linalg.eigh(mat)
    wmax = w.abs().amax(dim=-1, keepdim=True)
    good = w > wmax * lim
    wexp = torch.where(good, w.abs() ** exp * torch.sign(w),
                       torch.zeros((), dtype=w.dtype))
    return torch.einsum("...ab,...b,...cb->...ac", v, wexp, v)


def spec2flat(geom: Geometry, ps, exp: float = 1.0, dtype=torch.float32,
              device=None):
    """1D ``(ncomp, ncomp, L)`` spectra (or ``(L,)``) -> ``(ncomp, ncomp,
    ny, nx)`` ``(interp(ps)(modlmap) * npix/area) ** exp``. The matrix
    power is taken on the 1D tables in float64 on the host."""
    ps = np.array(ps, dtype=np.float64)        # a writable host copy
    if ps.ndim == 1:
        ps = ps[None, None]
    ncomp, L = ps.shape[0], ps.shape[-1]
    if exp != 1.0:
        stack = torch.as_tensor(np.moveaxis(ps, -1, 0))
        ps_p = np.moveaxis(eig_pow(stack, exp).numpy(), 0, -1)
    else:
        ps_p = ps
    ells = np.arange(L, dtype=np.float64)
    modlmap = geom.modlmap(dtype, device)
    flat = torch.stack([
        torch.stack([F.interp1d_to_2d(ells, ps_p[i, j], modlmap=modlmap)
                     for j in range(ncomp)])
        for i in range(ncomp)])
    return flat * ((geom.npix / geom.area) ** exp)


def rand_kmap(geom: Geometry, generator: torch.Generator, ncomp: int = None,
              batch=(), dtype=torch.float32, device=None):
    """Complex white noise on the Fourier plane: independent unit-variance
    real and imaginary parts, shape ``batch + ([ncomp,] ny, nx)``."""
    shape = tuple(batch) + ((geom.ny, geom.nx) if ncomp is None
                            else (ncomp, geom.ny, geom.nx))
    re = torch.randn(shape, generator=generator, dtype=dtype, device=device)
    im = torch.randn(shape, generator=generator, dtype=dtype, device=device)
    return torch.complex(re, im)


def harm2map(kmap, geom: Geometry):
    """Unitary inverse FFT of scalar k-maps to real maps (the spin-2
    (E,B)->(Q,U) rotation of the JAX package is not ported yet)."""
    if kmap.ndim >= 3 and kmap.shape[-3] == 3:
        raise NotImplementedError("polarized harm2map is not ported yet")
    return F.ifft2(kmap, geom, "ortho").real


def rand_map_from_noise(eta, geom: Geometry, covsqrt):
    """GRF realization from white noise ``eta`` (``(..., ncomp, ny, nx)``
    complex) and a covsqrt ``(ncomp, ncomp, ny, nx)``; a single component
    is returned without its component axis."""
    kmap = torch.einsum("abyx,...byx->...ayx", covsqrt.to(eta.dtype), eta)
    out = harm2map(kmap, geom)
    return out[..., 0, :, :] if covsqrt.shape[0] == 1 else out


def rand_map(geom: Geometry, covsqrt, generator: torch.Generator, batch=()):
    """Draw GRF realization(s) with the given covsqrt."""
    eta = rand_kmap(geom, generator, covsqrt.shape[0], batch=batch,
                    dtype=covsqrt.dtype, device=covsqrt.device)
    return rand_map_from_noise(eta, geom, covsqrt)


def covsqrt_half(geom: Geometry, ells, cls, dtype=torch.float32, device=None):
    """``sqrt(C) * npix / sqrt(area)`` painted on the rfft half-plane: the
    synthesis filter for :func:`rand_map_r`."""
    modl = geom.modlmap_r(dtype, device)
    c2d = F.interp1d_to_2d(ells, cls, modlmap=modl)
    return torch.sqrt(torch.clamp(c2d, min=0.0)) * (geom.npix / geom.area ** 0.5)


def hermitian_half_from_noise(zr, zi, geom: Geometry):
    """Unit-variance Hermitian half-plane noise from two standard-normal
    planes ``(..., ny, nx//2+1)``: ``a = (zr + i zi)/sqrt(2)``, then the
    self-conjugate columns (lx=0 and, for even nx, Nyquist) become
    ``(a + conj(a[-y])) / sqrt(2)``."""
    s = np.float32(2 ** -0.5)
    a = torch.complex(zr, zi) * s
    nxr = a.shape[-1]
    cols = [0] + ([nxr - 1] if geom.nx % 2 == 0 else [])
    idx = torch.as_tensor(cols, device=a.device)
    sc = a.index_select(-1, idx)
    mirrored = torch.roll(torch.flip(sc, dims=(-2,)), 1, dims=-2)
    herm = (sc + mirrored.conj()) * s
    out = a.clone()
    out[..., :, cols] = herm
    return out


def rand_hermitian_half(geom: Geometry, generator: torch.Generator, batch=(),
                        dtype=torch.float32, device=None):
    """Hermitian half-plane white noise, shape ``batch + (ny, nx//2+1)``."""
    shape = tuple(batch) + (geom.ny, geom.nx // 2 + 1)
    zr = torch.randn(shape, generator=generator, dtype=dtype, device=device)
    zi = torch.randn(shape, generator=generator, dtype=dtype, device=device)
    return hermitian_half_from_noise(zr, zi, geom)


def rand_map_r_from_noise(eta, geom: Geometry, covsqrt_h):
    """Scalar GRF via the half-plane irfft route from Hermitian noise."""
    return F.irfft2(covsqrt_h * eta, geom, "raw")


def rand_map_r(geom: Geometry, covsqrt_h, generator: torch.Generator,
               batch=()):
    eta = rand_hermitian_half(geom, generator, batch, covsqrt_h.dtype,
                              covsqrt_h.device)
    return rand_map_r_from_noise(eta, geom, covsqrt_h)


class MapGen:
    """Precompute covsqrt once, then draw maps:

    >>> mgen = MapGen(geom, ps, device="cuda")
    >>> imap = mgen.get_map(generator)
    """

    def __init__(self, geom: Geometry, ps=None, covsqrt=None,
                 dtype=torch.float32, device=None):
        self.geom = geom
        self.dtype = dtype
        if covsqrt is not None:
            self.covsqrt = torch.as_tensor(covsqrt, dtype=dtype, device=device)
        else:
            self.covsqrt = spec2flat(geom, ps, exp=0.5, dtype=dtype,
                                     device=device)
        self.ncomp = self.covsqrt.shape[0]

    def get_map(self, generator: torch.Generator, batch=()):
        return rand_map(self.geom, self.covsqrt, generator, batch)

    def get_map_from_noise(self, eta):
        return rand_map_from_noise(eta, self.geom, self.covsqrt)
