"""Fused row DFT and Hermitian weighted band combine (kernel B9;
counterpart of ``orphics_tpu/ops/pallas_fft.py``'s ``rowcombine_pp``).

For packed band pairs ``Z_j = fft2(m_2q + i m_2q+1)`` of coadd ``c`` (pair
``j = c nq + q``) in the doubly-permuted layout and ``Zm_j = Z_j(-k)``,

    C_c = sum_q alpha_q o Z_j + beta_q o conj(Zm_j)

with static complex weight planes ``alpha = (w_2q - i w_2q+1) / 2`` and
``beta = (w_2q + i w_2q+1) / 2`` is ``sum_b w_b o F_b``, the linear coadd
of the per-band Fourier planes, without the Hermitian split.

* :func:`rowcombine_pp` (B9, ``csrc/rowcombine.cu``): takes the column-DFT
  intermediates ``Y``. At ``n = 128 Bk`` with ``Bk`` a power of two a
  block of the register-resident kernel owns a row pair ``(p,
  mirror_pos(p))`` for :func:`coadds_per_block` coadds: for each band pair
  ``q`` in a fixed order it transforms the pair's rows of its coadds,
  loads ``alpha_q`` and ``beta_q`` of the two rows once and applies them to
  all its coadds, and it writes the coadd rows once after the last ``q``
  (:func:`rowcombine_split_emul` is the same algorithm in plain PyTorch).
  Any other ``Bk`` (``n = 384``) takes the radix-2 kernel, one block per
  coadd and row pair. The mirror is exact on every row and column, so the
  port needs none of the JAX function's wrap-strip patches (B4 ``zrow``,
  B4b): B9 alone is the function.
* :func:`rowcombine_pp_ref`: the plain version, ``rowfft_ref``,
  ``mirror_pp_ref`` and the weighted sum over ``q``.

For CPU tensors the wrapper runs the plain version; for CUDA tensors it
launches the kernel. There is no fallback from one to the other.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import _build
from .dft import _check, _tables, half_rows, rowfft_ref, rowfft_split_emul
from .mirror import mirror_pp_ref
from .rowpower import mirror_pos

__all__ = ["rowcombine_pp", "rowcombine_pp_ref", "rowcombine_split_emul",
           "coadds_per_block", "row_pairs"]


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


def coadds_per_block(n: int) -> int:
    """``G``, the coadds a block of the register-resident B9 kernel takes
    at ``n = 128 Bk``: its ``32 / Bk`` rows (2 at ``Bk >= 16``) are one row
    pair of ``G`` coadds (``csrc/rowcombine.cu:cb_rows``)."""
    bk = n // 128
    return 1 if bk >= 16 else 16 // bk


def row_pairs(n: int):
    """``(p, pm, self_mirror)`` of the register-resident B9 kernel's
    ``n / 2`` blocks: block 0 takes rows 0 and 64 (ky = 0 and N/2), each its
    own mirror (``self_mirror`` True); block ``x`` the half row ``x``
    (:func:`~orphics_tpu_torch.ops.dft.half_rows`) and its mirror row. The
    blocks cover every row once."""
    p = half_rows(n)[0].copy()
    pm = mirror_pos(p, n // 128)
    p[0], pm[0] = 0, 64
    self_mirror = np.arange(n // 2) == 0
    return p, pm, self_mirror


def rowcombine_split_emul(yr, yi, alr, ali, ber, bei, nq: int):
    """:func:`rowcombine_pp` by the register-resident kernel's algorithm in
    float32 plain PyTorch (``Bk`` a power of two): the blocks of
    :func:`row_pairs`, each for ``g`` = :func:`coadds_per_block` coadds
    (coadds past the last are zeros and are not stored); for ``q = 0 .. nq-1`` in that order the pair's rows of the
    block's coadds through
    :func:`~orphics_tpu_torch.ops.dft.rowfft_split_emul`, each column paired
    with the partner row (the row itself in block 0) at ``mirror_pos``, and
    ``alpha_q``, ``beta_q`` of the two rows, taken once, applied to all
    ``g`` coadds; the sums over ``q`` in the kernel's expression. Not a
    plain version (that is :func:`rowcombine_pp_ref`)."""
    npt, n, _ = yr.shape
    nco = npt // nq
    g = coadds_per_block(n)
    groups = -(-nco // g)
    p, pm, self_mirror = row_pairs(n)
    as_long = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.long,
                                        device=yr.device)
    rows = as_long(np.stack([p, pm], 1).reshape(-1))       # (block, m)
    partner = as_long(np.where(self_mirror[:, None], [[0, 1]], [[1, 0]])
                      + 2 * np.arange(n // 2)[:, None]).reshape(-1)
    qm = as_long(mirror_pos(np.arange(n), n // 128))
    pad = lambda a: torch.cat([a.reshape(nco, nq, n, n), a.new_zeros(
        (groups * g - nco, nq, n, n))]).reshape(groups, g, nq, n, n)
    ypr, ypi = pad(yr), pad(yi)
    cr = torch.zeros((groups, g, n, n), dtype=torch.float32,
                     device=yr.device)
    ci = torch.zeros_like(cr)
    for q in range(nq):
        zr, zi = rowfft_split_emul(ypr[:, :, q].index_select(2, rows),
                                   ypi[:, :, q].index_select(2, rows))
        mr, mi = (a.index_select(2, partner).index_select(3, qm)
                  for a in (zr, zi))
        # one load of the weights of the block's two rows for its g coadds
        ar, ai, br, bi = (w[q].index_select(0, rows) for w in
                          (alr, ali, ber, bei))
        cr = cr + (ar * zr - ai * zi + br * mr + bi * mi)
        ci = ci + (ar * zi + ai * zr + bi * mr - br * mi)
    out = lambda c: torch.empty_like(c).index_copy_(2, rows, c).reshape(
        groups * g, n, n)[:nco].contiguous()
    return out(cr), out(ci)


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
    if any(t.data_ptr() % 8 for t in (yr, yi, alr, ali, ber, bei)):
        raise ValueError("rowcombine_pp needs 8-byte aligned tensors")
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
