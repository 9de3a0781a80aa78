"""Fused row DFT and Hermitian weighted band combine (kernel B9;
counterpart of ``orphics_tpu/ops/pallas_fft.py``'s ``rowcombine_pp``).

For packed band pairs ``Z_j = fft2(m_2q + i m_2q+1)`` of coadd ``c`` (pair
``j = c nq + q``) in the doubly-permuted layout and ``Zm_j = Z_j(-k)``,

    C_c = sum_q alpha_q o Z_j + beta_q o conj(Zm_j)

with static complex weight planes ``alpha = (w_2q - i w_2q+1) / 2`` and
``beta = (w_2q + i w_2q+1) / 2`` is ``sum_b w_b o F_b``, the linear coadd
of the per-band Fourier planes, without the Hermitian split.

* :func:`rowcombine_pp` (B9, ``csrc/rowcombine.cu``): takes the column-DFT
  intermediates ``Y``; one block transforms a row and its mirror row of
  every pair of a coadd, in a fixed band order, and writes the coadd rows
  once. Its mirror is exact on every row and column, so the port needs
  none of the JAX function's wrap-strip patches (B4 ``zrow``, B4b): B9
  alone is the function.
* :func:`rowcombine_pp_ref`: the plain version, ``rowfft_ref``,
  ``mirror_pp_ref`` and the weighted sum over ``q``.

For CPU tensors the wrapper runs the plain version; for CUDA tensors it
launches the kernel. There is no fallback from one to the other.
"""
from __future__ import annotations

import torch

from .. import _build
from .dft import _check, _tables, rowfft_ref
from .mirror import mirror_pp_ref

__all__ = ["rowcombine_pp", "rowcombine_pp_ref"]


def rowcombine_pp_ref(yr, yi, alr, ali, ber, bei, nq: int):
    """Plain version of :func:`rowcombine_pp`."""
    zr, zi = rowfft_ref(yr, yi)
    mr, mi = mirror_pp_ref(zr, zi)
    npt, n, _ = yr.shape
    sh = (npt // nq, nq, n, n)
    zr, zi, mr, mi = (a.reshape(sh) for a in (zr, zi, mr, mi))
    cre = (alr * zr - ali * zi + ber * mr + bei * mi).sum(1)
    cim = (alr * zi + ali * zr + bei * mr - ber * mi).sum(1)
    return cre, cim


def rowcombine_pp(yr, yi, alr, ali, ber, bei, nq: int):
    """``(Cr, Ci)``, each ``(ncoadds, n, n)`` float32 in the
    doubly-permuted layout, from ``(ncoadds nq, n, n)`` column-DFT
    intermediates ``yr, yi`` (pair ``coadd nq + q``) and the ``(nq, n, n)``
    float32 weight planes ``alr, ali`` (alpha) and ``ber, bei`` (beta) in
    the same layout (B9). Feed ``dft.ifft2pp``, optionally packing coadd
    pairs."""
    _check(yr, yi, -1, "rowcombine_pp")
    npt, n, n2 = yr.shape
    if n != n2:
        raise ValueError(f"rowcombine_pp takes (pairs, n, n) planes, got "
                         f"{tuple(yr.shape)}")
    if nq < 1 or npt % nq:
        raise ValueError(f"rowcombine_pp: {npt} pairs are not a multiple of "
                         f"nq={nq}")
    for w in (alr, ali, ber, bei):
        if (w.dtype != torch.float32 or tuple(w.shape) != (nq, n, n)
                or w.device != yr.device):
            raise ValueError(f"rowcombine_pp: weight planes must be "
                             f"({nq}, {n}, {n}) float32 on {yr.device}")
    if not yr.is_cuda:
        return rowcombine_pp_ref(yr, yi, alr, ali, ber, bei, nq)
    if not all(t.is_contiguous() for t in (yr, yi, alr, ali, ber, bei)):
        raise ValueError("rowcombine_pp needs contiguous tensors")
    lib = _build.library()
    if n > lib.dft_max_n():
        raise ValueError(f"rowcombine_pp: n={n} exceeds the kernel's "
                         f"{lib.dft_max_n()}")
    nco = npt // nq
    cre = torch.empty((nco, n, n), dtype=torch.float32, device=yr.device)
    cim = torch.empty_like(cre)
    err = lib.rowcombine_launch(
        yr.data_ptr(), yi.data_ptr(), alr.data_ptr(), ali.data_ptr(),
        ber.data_ptr(), bei.data_ptr(),
        _tables(n, False, yr.device).data_ptr(), cre.data_ptr(),
        cim.data_ptr(), nco, n, nq,
        torch.cuda.current_stream(yr.device).cuda_stream)
    _build.check(err, "rowcombine_pp")
    rowcombine_pp.launches += 1
    return cre, cim


rowcombine_pp.launches = 0
