"""Fused row DFT and half-plane power fields (kernel B6; counterpart of
the fused row passes of ``orphics_tpu/ops/pallas_fft.py``, its
``rowqc_pp`` / ``fft2pp_qc`` section).

For ``Z = fft2(m1 + i m2)`` of a packed pair of real maps in the
doubly-permuted layout and ``Zm(k) = Z(-k)``, the mirror-even fields

    qs = (|Z|^2 + |Zm|^2) / 2        c = Re(Z Zm)

carry both maps' power, ``|F1|^2 = (qs + c) / 2`` and
``|F2|^2 = (qs - c) / 2`` pointwise, and their full-plane bin sums follow
from the half plane (rows ``half_rows(n)[0]``) as
``2 bin(half) - bin(row ky=0) + bin(row ky=n/2)``.

* :func:`rowqc_half` (B6, ``csrc/rowpower.cu``): the row DFT of the
  column-DFT intermediate ``Y`` and the two fields over the half plane in
  one pass; the Fourier plane never reaches device memory.
* :func:`rowqc_pp`: the JAX function's composition. B6 fills the half
  plane, B4 ``rowfft`` of ``Y``'s rows ``[0, 128)`` gives ``zrow`` (the
  boundary rows' source), B4b ``rowfft_blk0`` gives lane chunk 0, and the
  two wrap strips are patched from those as ``pallas_fft.rowqc_pp`` does.
  (The TPU kernel's in-register mirror is wrong on those strips; B6's is
  exact there too, so the patch rewrites them with values equal to
  rounding.)
* :func:`fft2pp_qc`: ``rowqc_pp(*colfft(m1, m2))``.

For CPU tensors the B6 wrapper runs the plain version
:func:`rowqc_pp_ref`; for CUDA tensors it launches the kernel. There is no
fallback from one to the other.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _build
from .dft import (_check, _tables, colfft, half_rows, rowfft, rowfft_blk0,
                  rowfft_ref)
from .mirror import _mirror_tables, mirror_pp_ref

__all__ = ["qc_fields", "rowqc_half", "rowqc_pp", "rowqc_pp_ref",
           "fft2pp_qc"]


@functools.lru_cache(maxsize=16)
def _strip_tables(n, device):
    """``(mrow, rsrc, csrc, p_of_h)`` as long tensors: the mirror map, the
    mirror rows of Z rows ``[0, 64)`` inside ``zrow``, and the mirror rows
    of the half rows ``h >= 64`` (``pallas_fft.rowqc_pp``'s patch)."""
    mrow = _mirror_tables(n)
    p_of_h, _ = half_rows(n)
    as_long = lambda a: torch.as_tensor(a, dtype=torch.long, device=device)
    return (as_long(mrow), as_long((128 - np.arange(64)) % 128),
            as_long(mrow[p_of_h[64:]]), as_long(p_of_h))


def qc_fields(zr, zi, mr, mi):
    """``(qs, c)`` from ``Z`` and its mirror ``Zm``, elementwise."""
    return 0.5 * (zr * zr + zi * zi + mr * mr + mi * mi), zr * mr - zi * mi


def rowqc_pp_ref(yr, yi):
    """Plain version of :func:`rowqc_pp`: ``Z`` = :func:`rowfft_ref` of
    every row, ``Zm`` = ``mirror_pp_ref(Z)``, the two fields on the rows
    ``half_rows(n)[0]``, and ``zrow`` = ``Z``'s rows ``[0, 128)``."""
    zr, zi = rowfft_ref(yr, yi)
    mr, mi = mirror_pp_ref(zr, zi)
    p = _strip_tables(zr.shape[-1], zr.device)[3]
    qs, c = qc_fields(*(a.index_select(1, p) for a in (zr, zi, mr, mi)))
    return (qs, c, zr[:, :128].contiguous(), zi[:, :128].contiguous())


def rowqc_half(yr, yi):
    """``(qs, c)``, each ``(b, n/2, n)`` float32 over the half plane in
    :func:`half_rows` order, of ``Z = rowfft(Y)`` for ``(b, n, n)``
    float32 ``yr, yi`` with rows in ``row_perm`` order (B6)."""
    _check(yr, yi, -1, "rowqc_half")
    b, n, n2 = yr.shape
    if n != n2:
        raise ValueError(f"rowqc_half takes (batch, n, n) planes, got "
                         f"{tuple(yr.shape)}")
    if not yr.is_cuda:
        return rowqc_pp_ref(yr, yi)[:2]
    if not (yr.is_contiguous() and yi.is_contiguous()):
        raise ValueError("rowqc_half needs contiguous tensors")
    lib = _build.library()
    if n > lib.dft_max_n():
        raise ValueError(f"rowqc_half: n={n} exceeds the kernel's "
                         f"{lib.dft_max_n()}")
    qs = torch.empty((b, n // 2, n), dtype=torch.float32, device=yr.device)
    c = torch.empty_like(qs)
    err = lib.rowqc_half_launch(
        yr.data_ptr(), yi.data_ptr(),
        _tables(n, False, yr.device).data_ptr(), qs.data_ptr(),
        c.data_ptr(), b, n, torch.cuda.current_stream(yr.device).cuda_stream)
    _build.check(err, "rowqc_half")
    rowqc_half.launches += 1
    return qs, c


rowqc_half.launches = 0


def rowqc_pp(yr, yi):
    """``(qs, c, zrow_r, zrow_i)`` from the column-DFT intermediate ``Y``
    (``(b, n, n)`` float32): the half-plane fields of ``Z = rowfft(Y)``
    and ``Z``'s rows ``[0, 128)`` for the boundary-row bins
    (``pallas_fft.rowqc_pp``)."""
    qs, c = rowqc_half(yr, yi)
    b, n, _ = yr.shape
    ncc, nh = n // 128, n // 2
    mrow, rsrc, csrc, _ = _strip_tables(n, yr.device)
    zrow_r, zrow_i = rowfft(yr[:, :128].contiguous(),
                            yi[:, :128].contiguous())
    zcol_r, zcol_i = rowfft_blk0(yr, yi)

    # rows h < 64 (b == 0): the mirror rows are (128 - a) % 128 of zrow
    zm_rows = lambda z: z.index_select(1, rsrc).index_select(2, mrow)
    qs[:, :64], c[:, :64] = qc_fields(zrow_r[:, :64], zrow_i[:, :64],
                                      zm_rows(zrow_r), zm_rows(zrow_i))
    # columns [0, 128) of rows h >= 64: lane chunk 0 mirrors into itself
    zm_cols = lambda z: z.index_select(2, mrow[:128]).index_select(1, csrc)
    z_strip = lambda z: z.reshape(b, ncc, 128, 128)[:, :, :64] \
        .reshape(b, nh, 128)[:, 64:]
    qs[:, 64:, :128], c[:, 64:, :128] = qc_fields(
        z_strip(zcol_r), z_strip(zcol_i), zm_cols(zcol_r), zm_cols(zcol_i))
    return qs, c, zrow_r, zrow_i


def fft2pp_qc(m1, m2):
    """Half-plane fields of ``fft2(m1 + i m2)`` without the Fourier plane:
    ``rowqc_pp(*colfft(m1, m2))`` (``pallas_fft.fft2pp_qc``)."""
    return rowqc_pp(*colfft(m1, m2))
