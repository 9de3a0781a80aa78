"""Gaussian random field synthesis from theory spectra (port of
``orphics_tpu.models.grf``).

Conventions, as in the JAX package:
  * covsqrt in "map_mul units": ``sqrt(C2d * npix / area)``;
  * white noise eta = N(0,1) + i N(0,1) per Fourier pixel; the real part
    of the unitary inverse FFT of ``covsqrt * eta`` is the map.

Every draw comes in two forms: one takes an explicit ``torch.Generator``
(on the device of the output; the factories' ``device=None`` is the
card), and a ``*_from_noise`` twin takes the
white noise itself, so that tests can feed both packages the same draws.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve
from ..geometry import Geometry, arcmin
from ..ops import fourier as F

__all__ = ["eig_pow", "spec2flat", "cl2flat", "rand_kmap", "harm2map",
           "map2harm", "rand_map", "white_noise", "white_noise_from_noise",
           "rand_map_from_noise", "covsqrt_half", "rand_hermitian_half",
           "hermitian_half_from_noise", "rand_map_r", "rand_map_r_from_noise",
           "MapGen", "cmb_ps"]


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


def cl2flat(geom: Geometry, ells, cls, dtype=torch.float32, device=None):
    """Paint a single 1D spectrum onto the 2D l-plane (no unit scaling)."""
    return F.interp1d_to_2d(ells, cls, geom, dtype=dtype, device=device)


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
    modlmap = geom.modlmap(dtype, resolve(device))
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
    device = resolve(device)
    re = torch.randn(shape, generator=generator, dtype=dtype, device=device)
    im = torch.randn(shape, generator=generator, dtype=dtype, device=device)
    return torch.complex(re, im)


def harm2map(kmap, geom: Geometry, iau: bool = False):
    """Unitary inverse FFT of (T[, E, B]) k-maps to (I[, Q, U]) real maps.
    Only full (T, E, B) stacks are rotated: two components are a correlated
    scalar pair, not spin-2 polarization."""
    if kmap.ndim >= 3 and kmap.shape[-3] == 3:
        kmap = F.teb2iqu(kmap, geom, iau=iau)
    return F.ifft2(kmap, geom, "ortho").real


def map2harm(imap, geom: Geometry, iau: bool = False):
    """Unitary forward FFT of (I[, Q, U]) maps to (T[, E, B]) k-maps."""
    k = F.fft2(imap, geom, "ortho")
    if k.ndim >= 3 and k.shape[-3] == 3:
        k = F.iqu2teb(k, geom, iau=iau)
    return k


def rand_map_from_noise(eta, geom: Geometry, covsqrt, iau: bool = False,
                        harm: bool = False):
    """GRF realization from white noise ``eta`` (``(..., ncomp, ny, nx)``
    complex) and a covsqrt ``(ncomp, ncomp, ny, nx)``; a single component
    is returned without its component axis. ``harm`` returns the TEB
    k-maps instead of the real maps."""
    kmap = torch.einsum("abyx,...byx->...ayx", covsqrt.to(eta.dtype), eta)
    if harm:
        return kmap
    out = harm2map(kmap, geom, iau=iau)
    return out[..., 0, :, :] if covsqrt.shape[0] == 1 else out


def rand_map(geom: Geometry, covsqrt, generator: torch.Generator, batch=(),
             iau: bool = False, harm: bool = False):
    """Draw GRF realization(s) with the given covsqrt."""
    eta = rand_kmap(geom, generator, covsqrt.shape[0], batch=batch,
                    dtype=covsqrt.dtype, device=covsqrt.device)
    return rand_map_from_noise(eta, geom, covsqrt, iau=iau, harm=harm)


def covsqrt_half(geom: Geometry, ells, cls, dtype=torch.float32, device=None):
    """``sqrt(C) * npix / sqrt(area)`` painted on the rfft half-plane: the
    synthesis filter for :func:`rand_map_r`."""
    modl = geom.modlmap_r(dtype, resolve(device))
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
    device = resolve(device)
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
        device = resolve(device)
        if covsqrt is not None:
            self.covsqrt = torch.as_tensor(covsqrt, dtype=dtype, device=device)
        else:
            self.covsqrt = spec2flat(geom, ps, exp=0.5, dtype=dtype,
                                     device=device)
        self.ncomp = self.covsqrt.shape[0]

    def get_map(self, generator: torch.Generator, batch=(),
                iau: bool = False, harm: bool = False):
        return rand_map(self.geom, self.covsqrt, generator, batch, iau=iau,
                        harm=harm)

    def get_map_from_noise(self, eta, iau: bool = False, harm: bool = False):
        return rand_map_from_noise(eta, self.geom, self.covsqrt, iau=iau,
                                   harm=harm)


def cmb_ps(theory, lmax: int = None, pols=("TT", "EE", "BB", "TE"),
           lensed: bool = True):
    """The (3, 3, lmax + 1) T, E, B power matrix of a ``TheorySpectra`` as
    float64 numpy (reference ``orphics/maps.py:1038``)."""
    lmax = lmax or theory.lpad
    ells = np.arange(lmax + 1)
    get = theory.lCl if lensed else theory.uCl
    ps = np.zeros((3, 3, lmax + 1))
    ps[0, 0] = np.asarray(get("TT", ells))
    ps[1, 1] = np.asarray(get("EE", ells))
    ps[2, 2] = np.asarray(get("BB", ells))
    te = np.asarray(get("TE", ells))
    ps[0, 1] = te
    ps[1, 0] = te
    return ps


def white_noise_from_noise(z, geom: Geometry, noise_muK_arcmin,
                           ipsizemap=None):
    """White noise map of the given sensitivity (muK-arcmin) from standard
    normals ``z`` (``(..., ny, nx)``): variance per pixel is
    ``(noise * arcmin)^2 / pixsize``, with the per-pixel solid angle
    (cos(dec) factor included) unless ``ipsizemap`` is given."""
    if ipsizemap is None:
        ipsizemap = geom.pixsizemap(z.dtype, z.device)
    return z * ((noise_muK_arcmin * arcmin) / torch.sqrt(ipsizemap))


def white_noise(geom: Geometry, noise_muK_arcmin,
                generator: torch.Generator, ipsizemap=None, shape=None,
                dtype=torch.float32, device=None):
    """Draw :func:`white_noise_from_noise` with ``generator``; ``shape``
    defaults to ``(ny, nx)``."""
    shape = tuple(shape) if shape is not None else (geom.ny, geom.nx)
    z = torch.randn(shape, generator=generator, dtype=dtype,
                    device=resolve(device))
    return white_noise_from_noise(z, geom, noise_muK_arcmin, ipsizemap)
