"""Column and row DFTs in the doubly-permuted layout (kernels B3 and B4;
counterpart of the DFT half of ``orphics_tpu/ops/pallas_fft.py``).

A transform of length ``n = 128 * Bk`` (``Bk >= 2``) splits as
``n = a + 128 b``, ``k = k2 + Bk k1``; the forward transforms store
frequency ``k`` at position ``p = 128 k2 + k1`` (:func:`row_perm`), and
the inverse transforms take that order and give natural order, with the
1/n factor. So ``colifft(colfft(x)) == x`` with no gather, and the static
planes of a pipeline absorb the permutation once. The layout helpers are
bit-identical to the JAX package's.

* B3 :func:`colfft` / :func:`colifft`: axis -2 of ``(batch, n, C)``
  re/im fp32 planes (``pallas_fft.colfft`` / ``colifft``);
* B4 :func:`rowfft` / :func:`rowifft` / :func:`rowifft_scaled_y`: axis
  -1 of ``(batch, R, n)`` planes (``pallas_fft.rowfft`` / ``rowifft`` /
  ``rowifft_scaled_y``);
* B4b :func:`rowfft_blk0`: the permuted columns ``[0, 128)`` of
  :func:`rowfft` (``pallas_fft.rowfft_blk0``; kernel in
  ``csrc/rowpower.cu``);
* B5 :func:`rowifft_noise_y`: :func:`rowifft` of ``scale * eta`` with the
  white noise drawn in the kernel (``pallas_fft.rowifft_noise_y``);
* the compositions :func:`fft2pp`, :func:`ifft2pp`, :func:`ifft2pp_scaled`,
  :func:`ifft2pp_noise`, :func:`ifft2pp_noise_y` (both axes permuted) and
  :func:`pfft2`, :func:`pifft2` (natural order).

For CUDA tensors the wrappers launch ``csrc/dft.cu``; for CPU tensors
they run the plain versions (``torch.fft`` plus an ``index_select``).
There is no fallback from one to the other. The JAX functions' tiling
arguments (``ctile``, ``rtile``, ``interpret``) have no counterpart: the
kernel picks its own tile.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _build
from .noise_planes import noise_planes_ref, seed_words

__all__ = [
    "row_perm", "natural_rows", "full_perm", "half_rows",
    "permuted_bin_tables",
    "colfft", "colifft", "rowfft", "rowifft", "rowifft_scaled_y",
    "rowfft_blk0", "rowifft_noise_y",
    "colfft_ref", "colifft_ref", "rowfft_ref", "rowifft_ref",
    "rowifft_scaled_y_ref", "rowfft_blk0_ref", "rowifft_noise_y_ref",
    "fft2pp", "ifft2pp", "ifft2pp_scaled", "ifft2pp_noise",
    "ifft2pp_noise_y", "pfft2", "pifft2",
]

_A = 128


@functools.lru_cache(maxsize=8)
def _plan(n, inverse):
    """``(A, B, FBre, FBim, FAre, FAim, TWre, TWim)``: the split's DFT
    matrices and twiddles, built in float64 and rounded to fp32
    (``pallas_fft._plan``)."""
    A, B = _A, n // _A
    if A * B != n or B < 2:
        raise ValueError(f"n={n} must be 128*B with B >= 2")
    sgn = 2j * np.pi / n if inverse else -2j * np.pi / n
    ja = np.arange(A)
    jb = np.arange(B)
    FB = np.exp(sgn * np.outer(jb, jb) * A)           # omega_B^(k2 b)
    FA = np.exp(sgn * np.outer(ja, ja) * B)           # omega_A^(k1 a)
    TW = np.exp(sgn * np.outer(jb, ja))               # omega_N^(k2 a)
    return (A, B,
            FB.real.astype(np.float32), FB.imag.astype(np.float32),
            FA.real.astype(np.float32), FA.imag.astype(np.float32),
            TW.real.astype(np.float32), TW.imag.astype(np.float32))


def row_perm(n: int):
    """``(perm, inv)``: ``permuted = natural[perm]`` and
    ``natural = permuted[inv]``; position ``p = 128 k2 + k1`` holds
    frequency ``k = k2 + B k1`` (``B = n // 128``)."""
    A, B = _A, n // _A
    ks = np.arange(n)
    p_of_k = A * (ks % B) + ks // B
    inv = np.empty(n, dtype=np.int32)
    inv[ks] = p_of_k
    perm = np.argsort(inv).astype(np.int32)
    return perm, inv


def full_perm(n: int):
    """``(perm, inv)`` of the doubly-permuted layout (rows and columns
    both in :func:`row_perm` order)."""
    return row_perm(n)


def half_rows(n: int):
    """Static tables of the Hermitian half plane in :func:`row_perm` order:
    the rows with natural ky in ``[0, n/2)`` are those with
    ``a = p mod 128 < 64`` (``ky = B a + b``). Returns ``p_of_h`` (compact
    index h -> permuted row p, h in ``[0, n//2)``) and ``p_nyq`` (the
    ky = n/2 row, p = 64), as ``pallas_fft.half_rows``."""
    h = np.arange(n // 2)
    p_of_h = (128 * (h // 64) + h % 64).astype(np.int32)
    return p_of_h, 64


def natural_rows(x, n=None):
    """Reorder permuted rows (axis -2) to natural frequency order."""
    n = n or x.shape[-2]
    _, inv = row_perm(n)
    return x.index_select(-2, torch.as_tensor(inv, dtype=torch.long,
                                              device=x.device))


def permuted_bin_tables(modlmap, perm, edges, device=None):
    """Radial-binning tables for doubly-permuted full planes:
    ``digitize(|l|, edges, right=True)`` in the ``[perm][:, perm]``
    layout, the overflow segment ``len(edges)`` folded into segment 0.
    Returns ``(idc, icnt, nseg)``: flat int32 segment ids, the per-bin
    inverse counts (segment 0 skipped) as float32, and the segment count
    (``pallas_fft.permuted_bin_tables``)."""
    dig = np.digitize(np.asarray(modlmap, np.float64)[perm][:, perm],
                      np.asarray(edges), right=True).astype(np.int32)
    dig[dig == len(edges)] = 0
    nseg = len(edges)
    idc = torch.as_tensor(dig.ravel(), device=device)
    icnt = torch.as_tensor(
        (1.0 / np.maximum(np.bincount(dig.ravel(), minlength=nseg),
                          1))[1:].astype(np.float32), device=device)
    return idc, icnt, nseg


@functools.lru_cache(maxsize=16)
def _tables(n, inverse, device):
    """The kernel's twiddle tables on ``device``, complex interleaved:
    ``w_128^j`` (j < 64), ``w_B^j`` (j < B), ``w_N^(k2 a)`` (B x 128),
    conjugated for the inverse; the fp32 roundings of :func:`_plan`."""
    _, _, FBre, FBim, FAre, FAim, TWre, TWim = _plan(n, inverse)
    re = np.concatenate([FAre[1, :64], FBre[1], TWre.ravel()])
    im = np.concatenate([FAim[1, :64], FBim[1], TWim.ravel()])
    return torch.as_tensor(np.stack([re, im], axis=-1).ravel(),
                           dtype=torch.float32, device=device)


def _perm_index(n, device, inverse):
    perm, inv = row_perm(n)
    return torch.as_tensor(inv if inverse else perm, dtype=torch.long,
                           device=device)


# ---- plain versions -----------------------------------------------------

def colfft_ref(xre, xim):
    """Plain version of :func:`colfft`: ``torch.fft.fft`` along axis -2,
    then the rows taken in :func:`row_perm` order."""
    z = torch.fft.fft(torch.complex(xre, xim), dim=-2)
    z = z.index_select(-2, _perm_index(xre.shape[-2], xre.device, False))
    return z.real.contiguous(), z.imag.contiguous()


def colifft_ref(xre, xim):
    """Plain version of :func:`colifft`: permuted rows to natural order,
    then ``torch.fft.ifft`` along axis -2 (1/n included)."""
    z = torch.complex(xre, xim).index_select(
        -2, _perm_index(xre.shape[-2], xre.device, True))
    z = torch.fft.ifft(z, dim=-2)
    return z.real.contiguous(), z.imag.contiguous()


def rowfft_ref(xre, xim):
    """Plain version of :func:`rowfft` (axis -1)."""
    z = torch.fft.fft(torch.complex(xre, xim), dim=-1)
    z = z.index_select(-1, _perm_index(xre.shape[-1], xre.device, False))
    return z.real.contiguous(), z.imag.contiguous()


def rowifft_ref(xre, xim):
    """Plain version of :func:`rowifft` (axis -1)."""
    z = torch.complex(xre, xim).index_select(
        -1, _perm_index(xre.shape[-1], xre.device, True))
    z = torch.fft.ifft(z, dim=-1)
    return z.real.contiguous(), z.imag.contiguous()


def rowifft_scaled_y_ref(kre, kim, scale):
    """Plain version of :func:`rowifft_scaled_y`."""
    return rowifft_ref(kre * scale, kim * scale)


def rowfft_blk0_ref(yre, yim):
    """Plain version of :func:`rowfft_blk0`: :func:`rowfft_ref`'s first
    128 columns."""
    zr, zi = rowfft_ref(yre, yim)
    return zr[..., :_A].contiguous(), zi[..., :_A].contiguous()


def rowifft_noise_y_ref(scale, seed, batch: int):
    """Plain version of :func:`rowifft_noise_y`: :func:`rowifft_ref` of
    :func:`~orphics_tpu_torch.ops.noise_planes.noise_planes_ref`, the JAX
    interpret fallback's design (another stream than the kernel's, with
    the same law)."""
    return rowifft_ref(*noise_planes_ref(scale, seed, batch))


# ---- kernel wrappers ----------------------------------------------------

def _check(xre, xim, axis, what):
    if xre.dtype != torch.float32 or xim.dtype != torch.float32:
        raise ValueError(f"{what} takes float32 re/im planes")
    if xre.ndim != 3 or xre.shape != xim.shape:
        raise ValueError(f"{what} takes two (batch, rows, cols) planes of one "
                         f"shape, got {tuple(xre.shape)}, {tuple(xim.shape)}")
    if xre.device != xim.device:
        raise ValueError(f"{what}: re and im must share one device")
    n = xre.shape[axis]
    if n % _A or n < 2 * _A:
        raise ValueError(f"{what}: transform length {n} must be 128*B with "
                         "B >= 2")
    if xre.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what}: unsupported device {xre.device}")


def _launch(xre, xim, row, inverse, scale, what):
    if not (xre.is_contiguous() and xim.is_contiguous()
            and (scale is None or scale.is_contiguous())):
        raise ValueError(f"{what} needs contiguous tensors")
    lib = _build.library()
    batch, d1, d2 = xre.shape
    n, other = (d2, d1) if row else (d1, d2)
    if n > lib.dft_max_n():
        raise ValueError(f"{what}: n={n} exceeds the kernel's "
                         f"{lib.dft_max_n()}")
    ore = torch.empty_like(xre)
    oim = torch.empty_like(xim)
    tab = _tables(n, bool(inverse), xre.device)
    stream = torch.cuda.current_stream(xre.device).cuda_stream
    err = lib.dft_launch(xre.data_ptr(), xim.data_ptr(), ore.data_ptr(),
                         oim.data_ptr(), tab.data_ptr(),
                         None if scale is None else scale.data_ptr(),
                         int(row), int(inverse), batch, n, other, stream)
    _build.check(err, what)
    return ore, oim


def colfft(xre, xim):
    """DFT along axis -2 of ``(batch, n, C)`` re/im float32 planes; output
    rows in :func:`row_perm` order (B3)."""
    _check(xre, xim, -2, "colfft")
    if xre.is_cuda:
        out = _launch(xre, xim, False, False, None, "colfft")
        colfft.launches += 1
        return out
    return colfft_ref(xre, xim)


def colifft(xre, xim):
    """Inverse DFT along axis -2: :func:`row_perm`-ordered rows in,
    natural rows out, 1/n included (B3)."""
    _check(xre, xim, -2, "colifft")
    if xre.is_cuda:
        out = _launch(xre, xim, False, True, None, "colifft")
        colifft.launches += 1
        return out
    return colifft_ref(xre, xim)


def rowfft(xre, xim):
    """DFT along axis -1 of ``(batch, R, n)`` planes; output columns in
    :func:`row_perm` order (B4)."""
    _check(xre, xim, -1, "rowfft")
    if xre.is_cuda:
        out = _launch(xre, xim, True, False, None, "rowfft")
        rowfft.launches += 1
        return out
    return rowfft_ref(xre, xim)


def rowifft(xre, xim):
    """Inverse DFT along axis -1: permuted columns in, natural out, 1/n
    included (B4)."""
    _check(xre, xim, -1, "rowifft")
    if xre.is_cuda:
        out = _launch(xre, xim, True, True, None, "rowifft")
        rowifft.launches += 1
        return out
    return rowifft_ref(xre, xim)


def rowifft_scaled_y(kre, kim, scale):
    """``rowifft(scale * kre, scale * kim)`` with the product taken on the
    kernel's load; ``scale``: ``(R, n)`` float32 in the planes' layout
    (B4)."""
    _check(kre, kim, -1, "rowifft_scaled_y")
    if scale.dtype != torch.float32 or tuple(scale.shape) != tuple(
            kre.shape[1:]) or scale.device != kre.device:
        raise ValueError(f"scale must be {tuple(kre.shape[1:])} float32 on "
                         f"{kre.device}")
    if kre.is_cuda:
        out = _launch(kre, kim, True, True, scale, "rowifft_scaled_y")
        rowifft_scaled_y.launches += 1
        return out
    return rowifft_scaled_y_ref(kre, kim, scale)


def rowfft_blk0(yre, yim):
    """Lane chunk 0 (permuted columns ``[0, 128)``, k2 = 0) of the forward
    row DFT of every row: ``(b, rows, n)`` -> ``(b, rows, 128)`` re/im
    (B4b)."""
    _check(yre, yim, -1, "rowfft_blk0")
    if not yre.is_cuda:
        return rowfft_blk0_ref(yre, yim)
    if not (yre.is_contiguous() and yim.is_contiguous()):
        raise ValueError("rowfft_blk0 needs contiguous tensors")
    b, rows, n = yre.shape
    ore = torch.empty((b, rows, _A), dtype=torch.float32, device=yre.device)
    oim = torch.empty_like(ore)
    err = _build.library().rowfft_blk0_launch(
        yre.data_ptr(), yim.data_ptr(), _tables(n, False, yre.device)
        .data_ptr(), ore.data_ptr(), oim.data_ptr(), b * rows, n,
        torch.cuda.current_stream(yre.device).cuda_stream)
    _build.check(err, "rowfft_blk0")
    rowfft_blk0.launches += 1
    return ore, oim


def rowifft_noise_y(scale, seed, batch: int):
    """``Y' = rowifft(scale * eta)``, ``(batch,) + scale.shape`` re/im,
    with eta standard complex white noise drawn in the kernel: the
    pre-column synthesis intermediate of a GRF (B5). ``scale``: ``(R, n)``
    float32 in the planes' (doubly-permuted) layout; ``seed``: a scalar
    stream id or ``(2,)`` int32 words, a Python value or a device tensor
    (:func:`~orphics_tpu_torch.ops.noise_planes.seed_words`). The kernel
    draws element ``e`` of the planes as B5n's ``noise_planes`` does, so
    ``rowifft_noise_y(s, w, b)`` equals ``rowifft(*noise_planes(s, w, b))``
    on the card."""
    if scale.dtype != torch.float32 or scale.ndim != 2:
        raise ValueError("scale must be a 2D float32 plane")
    if batch < 1:
        raise ValueError("batch must be positive")
    _check(scale[None], scale[None], -1, "rowifft_noise_y")
    if not scale.is_cuda:
        return rowifft_noise_y_ref(scale, seed, batch)
    if not scale.is_contiguous():
        raise ValueError("rowifft_noise_y needs a contiguous scale")
    lib = _build.library()
    rows, n = scale.shape
    if n > lib.dft_max_n():
        raise ValueError(f"rowifft_noise_y: n={n} exceeds the kernel's "
                         f"{lib.dft_max_n()}")
    words = seed_words(seed, scale.device)
    ore = torch.empty((batch, rows, n), dtype=torch.float32,
                      device=scale.device)
    oim = torch.empty_like(ore)
    err = lib.dft_noise_launch(
        scale.data_ptr(), words.data_ptr(), ore.data_ptr(), oim.data_ptr(),
        _tables(n, True, scale.device).data_ptr(), batch, n, rows,
        torch.cuda.current_stream(scale.device).cuda_stream)
    _build.check(err, "rowifft_noise_y")
    rowifft_noise_y.launches += 1
    return ore, oim


colfft.launches = 0
colifft.launches = 0
rowfft.launches = 0
rowifft.launches = 0
rowifft_scaled_y.launches = 0
rowfft_blk0.launches = 0
rowifft_noise_y.launches = 0


# ---- compositions -------------------------------------------------------

def fft2pp(zre, zim):
    """Full 2D DFT, rows AND columns left in :func:`row_perm` order."""
    return rowfft(*colfft(zre, zim))


def ifft2pp(kre, kim):
    """Inverse of :func:`fft2pp`: doubly-permuted input, natural output."""
    return colifft(*rowifft(kre, kim))


def ifft2pp_scaled(kre, kim, scale):
    """``ifft2pp(scale * kre, scale * kim)``, the product on the first
    (row) pass's load; ``scale`` ``(n, n)`` doubly-permuted."""
    return colifft(*rowifft_scaled_y(kre, kim, scale))


def ifft2pp_noise(scale, seed, batch: int):
    """GRF synthesis with the white noise drawn in the kernel: the two real
    maps ``(batch, n, n)`` of ``ifft2pp(scale * eta)`` (B5, then B3)."""
    return colifft(*rowifft_noise_y(scale, seed, batch))


def ifft2pp_noise_y(scale, seed, batch: int):
    """:func:`ifft2pp_noise` that also returns the pre-column intermediate
    ``Y'``: since ``colfft(colifft(Y')) == Y'``, an analysis
    (``rowpower.rowqc_pp``) can take ``Y'`` directly. Returns
    ``(m1, m2, yre, yim)``."""
    yre, yim = rowifft_noise_y(scale, seed, batch)
    m1, m2 = colifft(yre, yim)
    return m1, m2, yre, yim


def pfft2(z):
    """Natural-order 2D DFT of a real or complex ``(ny, nx)`` or
    ``(batch, ny, nx)`` tensor on 128*B-sized axes: :func:`fft2pp` and
    one un-permuting gather per axis, each with its own length's
    permutation."""
    zre = (z.real if z.is_complex() else z).to(torch.float32)
    zim = (z.imag.to(torch.float32) if z.is_complex()
           else torch.zeros_like(zre))
    squeeze = zre.ndim == 2
    if squeeze:
        zre, zim = zre[None], zim[None]
    yr, yi = fft2pp(zre.contiguous(), zim.contiguous())
    iy = _perm_index(zre.shape[-2], zre.device, True)
    ix = _perm_index(zre.shape[-1], zre.device, True)
    out = torch.complex(yr, yi).index_select(-2, iy).index_select(-1, ix)
    return out[0] if squeeze else out


def pifft2(k):
    """Natural-order inverse of :func:`pfft2` (complex output)."""
    kre = (k.real if k.is_complex() else k).to(torch.float32)
    kim = (k.imag.to(torch.float32) if k.is_complex()
           else torch.zeros_like(kre))
    squeeze = kre.ndim == 2
    if squeeze:
        kre, kim = kre[None], kim[None]
    py = _perm_index(kre.shape[-2], kre.device, False)
    px = _perm_index(kre.shape[-1], kre.device, False)
    kre = kre.index_select(-2, py).index_select(-1, px)
    kim = kim.index_select(-2, py).index_select(-1, px)
    zr, zi = ifft2pp(kre.contiguous(), kim.contiguous())
    out = torch.complex(zr, zi)
    return out[0] if squeeze else out
