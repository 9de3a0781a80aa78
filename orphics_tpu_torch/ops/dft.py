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
* B3s :func:`colfft_scaled`: :func:`colfft` of ``scale * x`` with an
  ``(n, C)`` window shared by the batch, the product taken on the load
  (``pallas_fft.colfft_scaled``);
* B4 :func:`rowfft` / :func:`rowifft` / :func:`rowifft_scaled_y`: axis
  -1 of ``(batch, R, n)`` planes (``pallas_fft.rowfft`` / ``rowifft`` /
  ``rowifft_scaled_y``);
* B4b :func:`rowfft_blk0`: the permuted columns ``[0, 128)`` of
  :func:`rowfft` (``pallas_fft.rowfft_blk0``; kernel in
  ``csrc/rowpower.cu``);
* B5 :func:`rowifft_noise_y`: :func:`rowifft` of ``scale * eta`` with the
  white noise drawn in the kernel (``pallas_fft.rowifft_noise_y``);
* the compositions :func:`fft2pp`, :func:`ifft2pp`, :func:`ifft2pp_scaled`,
  :func:`ifft2pp_noise`, :func:`ifft2pp_noise_y` (both axes permuted),
  :func:`fft2p`, :func:`ifft2p` (B3 on the columns, the library FFT on the
  rows: only the rows' order is permuted) and :func:`pfft2`, :func:`pifft2`
  (natural order).

For CUDA tensors the wrappers launch ``csrc/dft.cu``: at
``n = 128 * 2**k`` B3 and B3s run ``csrc/colfft.cu``'s register-resident
column kernel and B4 and B5 ``csrc/rowfft.cu``'s row kernels, whose
arithmetic :func:`colfft_split_emul`, :func:`colifft_split_emul`,
:func:`rowfft_split_emul` and :func:`rowifft_split_emul` write out in plain
PyTorch for the CPU tests; other ``n`` take ``dft.cu``'s radix-2 kernel. For
CPU tensors the wrappers run the plain versions (``torch.fft`` plus an
``index_select``).
There is no fallback from one to the other. The JAX functions' tiling
arguments (``ctile``, ``rtile``, ``interpret``) have no counterpart: the
kernel picks its own tile.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _build
from .._device import resolve
from ..utils.profiling import spanned
from .noise_planes import noise_planes_ref, seed_words

__all__ = [
    "row_perm", "natural_rows", "full_perm", "half_rows",
    "permuted_bin_tables",
    "colfft", "colfft_scaled", "colifft", "rowfft", "rowifft",
    "rowifft_scaled_y", "rowfft_blk0", "rowifft_noise_y",
    "colfft_ref", "colfft_scaled_ref", "colifft_ref", "rowfft_ref",
    "rowifft_ref",
    "rowifft_scaled_y_ref", "rowfft_blk0_ref", "rowifft_noise_y_ref",
    "rowfft_split_emul", "rowifft_split_emul", "rowfft_blk0_split_emul",
    "colfft_split_emul", "colifft_split_emul",
    "fft2p", "ifft2p", "fft2pp", "ifft2pp", "ifft2pp_scaled", "ifft2pp_noise",
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
    device = resolve(device)
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


def colfft_scaled_ref(xre, xim, scale):
    """Plain version of :func:`colfft_scaled`."""
    return colfft_ref(xre * scale, xim * scale)


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


# ---- the register-resident core's algorithm, in plain PyTorch ------------

def _roots32():
    """``w_32^t`` for ``t < 16`` as complex64, from the kernel's nine
    constants ``cos(2 pi t / 32)``, ``t = 0 .. 8``, rounded from float64
    (``csrc/dft_core.cuh:cos32``, ``mul_root32``)."""
    c = np.cos(2 * np.pi * np.arange(9) / 32).astype(np.float32)
    c[8] = 0.0
    re = [c[t] if t <= 8 else -c[16 - t] for t in range(16)]
    im = [-(c[8 - t] if t <= 8 else c[t - 8]) for t in range(16)]
    return torch.as_tensor(np.asarray(re) + 1j * np.asarray(im),
                           dtype=torch.complex64)


def _bitrev(m):
    bits = m.bit_length() - 1
    return [int(format(k, f"0{bits}b")[::-1], 2) if bits else 0
            for k in range(m)]


def _fft_regs_emul(v, inverse=False):
    """``csrc/dft_core.cuh:fft_regs`` on the leading axis of complex64
    ``v`` (``M = v.shape[0]``, a power of two up to 32): the radix-2
    decimation-in-frequency butterflies in float32 with the constant
    roots (conjugated for the inverse, ``fft_regs<M, true>``),
    un-bit-reversed on return (``out[k] = X[k]``)."""
    m = v.shape[0]
    if m < 2 or m > 32 or m & (m - 1):
        raise ValueError(f"fft_regs takes 2, 4, 8, 16 or 32 values, got {m}")
    roots = _roots32().to(v.device)
    if inverse:
        roots = roots.conj()
    v = list(v.unbind(0))
    span = m // 2
    while span >= 1:
        for i in range(m // 2):
            pos = i & (span - 1)
            i0 = 2 * (i - pos) + pos
            u, w = v[i0], v[i0 + span]
            v[i0] = u + w
            t = pos * (16 // span)
            v[i0 + span] = (u - w) if t == 0 else (u - w) * roots[t]
        span //= 2
    return torch.stack([v[k] for k in _bitrev(m)])


def _fft128_emul(h, n, inverse):
    """``csrc/dft_core.cuh:fft128_seg`` on the last axis (128) of complex64
    ``h``: ``j = 8 d + c`` in, ``k = e + 16 f`` out, natural order both;
    the 16-point FFT over ``d``, the ``w_128^(c e)`` twiddle from the
    table's ``w_128^j`` (``j < 64``, negated beyond; :func:`_plan` of
    ``n``, conjugate for the inverse), the 8-point FFT over ``c``."""
    _, _, _, _, fare, faim, _, _ = _plan(n, inverse)
    u = _fft_regs_emul(h.reshape(h.shape[:-1] + (16, 8)).movedim(-2, 0),
                       inverse)                            # (e, ..., c)
    j = np.outer(np.arange(16), np.arange(8))             # (e, c) -> c e
    w128 = (fare[1, :64] + 1j * faim[1, :64]).astype(np.complex64)
    tws = torch.as_tensor(np.where(j < 64, w128[j & 63], -w128[j & 63]),
                          device=h.device)
    u = torch.cat([u[:1], u[1:] * tws[1:].reshape(
        (15,) + (1,) * (u.ndim - 2) + (8,))])
    z = _fft_regs_emul(u.movedim(-1, 0), inverse)          # (f, e, ...)
    return z.movedim((0, 1), (-2, -1)).reshape(h.shape)


def _twiddles(n, inverse, device):
    """``w_n^(+-a k2)`` as complex64 ``(Bk, 128)``, from :func:`_plan`."""
    _, _, _, _, _, _, twre, twim = _plan(n, inverse)
    return torch.as_tensor((twre + 1j * twim).astype(np.complex64),
                           device=device)


def _split_fwd_emul(x):
    """The register-resident forward transform of the last axis of complex64
    ``x``: the ``Bk``-point FFT over ``b`` (``n = a + 128 b``), the
    ``w_n^(a k2)`` twiddle, the 128-point stage; output at
    ``p = 128 k2 + k1``."""
    n = x.shape[-1]
    bk = n // _A
    lead = x.shape[:-1]
    g = _fft_regs_emul(x.reshape(lead + (bk, _A)).movedim(-2, 0))  # (k2,..,a)
    tw = _twiddles(n, False, x.device).reshape(
        (bk,) + (1,) * len(lead) + (_A,))
    h = torch.cat([g[:1], g[1:] * tw[1:]]).movedim(0, -2)  # (..., k2, a)
    return _fft128_emul(h, n, False).reshape(lead + (n,))


def _split_inv_emul(x):
    """The register-resident inverse of the last axis of complex64 ``x`` in
    :func:`row_perm` order: the inverse 128-point stage over ``k1`` of each
    ``k2`` block (``fft128_seg<true>``), the conjugate twiddle
    ``w_n^(-a k2)``, the inverse ``Bk``-point FFT over ``k2``
    (``fft_regs<Bk, true>``), 1/n; natural order out."""
    n = x.shape[-1]
    bk = n // _A
    lead = x.shape[:-1]
    h = _fft128_emul(x.reshape(lead + (bk, _A)), n, True)  # (..., k2, a)
    tw = _twiddles(n, True, x.device)
    h = torch.cat([h[..., :1, :], h[..., 1:, :] * tw[1:]], dim=-2)
    v = _fft_regs_emul(h.movedim(-2, 0), True)             # (b, ..., a)
    v = v * torch.tensor(1.0 / n, dtype=torch.float32)
    return v.movedim(0, -2).reshape(lead + (n,))


def _emul_along(fn, xre, xim, axis):
    z = fn(torch.complex(xre, xim).movedim(axis, -1)).movedim(-1, axis)
    return z.real.contiguous(), z.imag.contiguous()


def rowfft_split_emul(xre, xim):
    """:func:`rowfft` by the register-resident kernels' decomposition
    (``csrc/dft_core.cuh``: ``fft_regs``, ``fft128_seg``), in float32 plain
    PyTorch with the kernels' tables and constants. ``n = a + 128 b``,
    ``k = k2 + Bk k1``, ``Bk`` a power of two: the radix-2 ``Bk``-point FFT
    over ``b``; the ``w_n^(a k2)`` twiddle from :func:`_plan`; the 128-point
    stage as 16 x 8 (``a = 8 d + c``, ``k1 = e + 16 f``): the 16-point FFT
    over ``d``, the ``w_128^(c e)`` twiddle from the table's ``w_128^j``
    (``j < 64``, negated beyond), the 8-point FFT over ``c``; output at
    ``p = 128 k2 + k1``. Not a kernel's plain version (that is
    :func:`rowfft_ref`): the tests hold the decomposition, its digit orders
    and its tables to the plain versions with it."""
    return _emul_along(_split_fwd_emul, xre, xim, -1)


def rowifft_split_emul(xre, xim):
    """:func:`rowifft` by the row kernels' inverse decomposition
    (``csrc/rowfft.cu``; B5 and ``rowifft_scaled_y`` run it on their drawn
    or scaled input): :func:`colifft_split_emul`'s arithmetic along axis
    -1. Not a plain version (that is :func:`rowifft_ref`)."""
    return _emul_along(_split_inv_emul, xre, xim, -1)


def rowfft_blk0_split_emul(yre, yim):
    """:func:`rowfft_blk0` by its register-resident kernel's decomposition
    (``csrc/rowpower.cu``): the sum of the ``Bk`` blocks of each row as
    ``fft_regs``' radix-2 tree gives ``X[0]``, then the 128-point stage
    (``fft128_seg``); :func:`rowfft_split_emul`'s columns ``[0, 128)``, bit
    for bit. Not a plain version (that is :func:`rowfft_blk0_ref`)."""
    x = torch.complex(yre, yim)
    lead = x.shape[:-1]
    g = _fft_regs_emul(x.reshape(lead + (x.shape[-1] // _A, _A))
                       .movedim(-2, 0))
    z = _fft128_emul(g[0], x.shape[-1], False)
    return z.real.contiguous(), z.imag.contiguous()


def colfft_split_emul(xre, xim):
    """:func:`colfft` by the column kernel's decomposition
    (``csrc/colfft.cu``): :func:`rowfft_split_emul`'s arithmetic along
    axis -2. Not a plain version (that is :func:`colfft_ref`)."""
    return _emul_along(_split_fwd_emul, xre, xim, -2)


def colifft_split_emul(xre, xim):
    """:func:`colifft` by the column kernel's inverse decomposition
    (``csrc/colfft.cu``): for each ``k2`` block of the permuted rows the
    inverse 128-point stage as 16 x 8 (``k1 = 8 d + c`` in, ``a = e + 16 f``
    out), the conjugate twiddle ``w_n^(-a k2)``, the inverse radix-2
    ``Bk``-point FFT over ``k2`` and 1/n: rows ``a + 128 b`` in natural
    order. Not a plain version (that is :func:`colifft_ref`)."""
    return _emul_along(_split_inv_emul, xre, xim, -2)


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


@spanned("orphics.transforms.colfft")
def colfft(xre, xim):
    """DFT along axis -2 of ``(batch, n, C)`` re/im float32 planes; output
    rows in :func:`row_perm` order (B3)."""
    _check(xre, xim, -2, "colfft")
    if xre.is_cuda:
        out = _launch(xre, xim, False, False, None, "colfft")
        colfft.launches += 1
        return out
    return colfft_ref(xre, xim)


@spanned("orphics.transforms.colfft_scaled")
def colfft_scaled(xre, xim, scale):
    """``colfft(scale * xre, scale * xim)`` with the product taken on the
    kernel's load, so the scaled maps never reach device memory; ``scale``:
    ``(n, C)`` float32 in natural map layout, shared by every batch entry
    (B3s)."""
    _check(xre, xim, -2, "colfft_scaled")
    if scale.dtype != torch.float32 or tuple(scale.shape) != tuple(
            xre.shape[1:]) or scale.device != xre.device:
        raise ValueError(f"scale must be {tuple(xre.shape[1:])} float32 on "
                         f"{xre.device}")
    if xre.is_cuda:
        out = _launch(xre, xim, False, False, scale, "colfft_scaled")
        colfft_scaled.launches += 1
        return out
    return colfft_scaled_ref(xre, xim, scale)


@spanned("orphics.transforms.colifft")
def colifft(xre, xim):
    """Inverse DFT along axis -2: :func:`row_perm`-ordered rows in,
    natural rows out, 1/n included (B3)."""
    _check(xre, xim, -2, "colifft")
    if xre.is_cuda:
        out = _launch(xre, xim, False, True, None, "colifft")
        colifft.launches += 1
        return out
    return colifft_ref(xre, xim)


@spanned("orphics.transforms.rowfft")
def rowfft(xre, xim):
    """DFT along axis -1 of ``(batch, R, n)`` planes; output columns in
    :func:`row_perm` order (B4)."""
    _check(xre, xim, -1, "rowfft")
    if xre.is_cuda:
        out = _launch(xre, xim, True, False, None, "rowfft")
        rowfft.launches += 1
        return out
    return rowfft_ref(xre, xim)


@spanned("orphics.transforms.rowifft")
def rowifft(xre, xim):
    """Inverse DFT along axis -1: permuted columns in, natural out, 1/n
    included (B4)."""
    _check(xre, xim, -1, "rowifft")
    if xre.is_cuda:
        out = _launch(xre, xim, True, True, None, "rowifft")
        rowifft.launches += 1
        return out
    return rowifft_ref(xre, xim)


@spanned("orphics.transforms.rowifft_scaled_y")
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


@spanned("orphics.transforms.rowfft_blk0")
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


@spanned("orphics.transforms.rowifft_noise_y")
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
colfft_scaled.launches = 0
colifft.launches = 0
rowfft.launches = 0
rowifft.launches = 0
rowifft_scaled_y.launches = 0
rowfft_blk0.launches = 0
rowifft_noise_y.launches = 0


# ---- compositions -------------------------------------------------------

@spanned("orphics.transforms.fft2p")
def fft2p(zre, zim):
    """Full 2D DFT with axis -2 by B3 :func:`colfft` (rows left in
    :func:`row_perm` order) and axis -1 by ``torch.fft.fft`` (natural
    column order): ``(re, im)`` of ``fft2(z)`` with permuted rows; reorder
    with :func:`natural_rows` or use row-permuted grids downstream
    (``pallas_fft.fft2p``)."""
    yre, yim = colfft(zre, zim)
    k = torch.fft.fft(torch.complex(yre, yim), dim=-1)
    return k.real.contiguous(), k.imag.contiguous()


@spanned("orphics.transforms.ifft2p")
def ifft2p(kre, kim):
    """Inverse of :func:`fft2p`: rows in permuted order in, natural order
    out (``pallas_fft.ifft2p``)."""
    z = torch.fft.ifft(torch.complex(kre, kim), dim=-1)
    return colifft(z.real.contiguous(), z.imag.contiguous())


@spanned("orphics.transforms.fft2pp")
def fft2pp(zre, zim):
    """Full 2D DFT, rows AND columns left in :func:`row_perm` order."""
    return rowfft(*colfft(zre, zim))


@spanned("orphics.transforms.ifft2pp")
def ifft2pp(kre, kim):
    """Inverse of :func:`fft2pp`: doubly-permuted input, natural output."""
    return colifft(*rowifft(kre, kim))


@spanned("orphics.transforms.ifft2pp_scaled")
def ifft2pp_scaled(kre, kim, scale):
    """``ifft2pp(scale * kre, scale * kim)``, the product on the first
    (row) pass's load; ``scale`` ``(n, n)`` doubly-permuted."""
    return colifft(*rowifft_scaled_y(kre, kim, scale))


@spanned("orphics.transforms.ifft2pp_noise")
def ifft2pp_noise(scale, seed, batch: int):
    """GRF synthesis with the white noise drawn in the kernel: the two real
    maps ``(batch, n, n)`` of ``ifft2pp(scale * eta)`` (B5, then B3)."""
    return colifft(*rowifft_noise_y(scale, seed, batch))


@spanned("orphics.transforms.ifft2pp_noise_y")
def ifft2pp_noise_y(scale, seed, batch: int):
    """:func:`ifft2pp_noise` that also returns the pre-column intermediate
    ``Y'``: since ``colfft(colifft(Y')) == Y'``, an analysis
    (``rowpower.rowqc_pp``) can take ``Y'`` directly. Returns
    ``(m1, m2, yre, yim)``."""
    yre, yim = rowifft_noise_y(scale, seed, batch)
    m1, m2 = colifft(yre, yim)
    return m1, m2, yre, yim


@spanned("orphics.transforms.pfft2")
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


@spanned("orphics.transforms.pifft2")
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
