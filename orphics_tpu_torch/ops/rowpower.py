"""Fused row DFT and half-plane power fields (kernels B6 and B6s;
counterpart of the fused row passes of ``orphics_tpu/ops/pallas_fft.py``,
its ``rowqc_pp`` / ``fft2pp_qc`` and ``rows_pp`` / ``fft2pp_s``
sections).

For ``Z = fft2(m1 + i m2)`` of a packed pair of real maps in the
doubly-permuted layout and ``Zm(k) = Z(-k)``, the mirror-even fields

    qs = (|Z|^2 + |Zm|^2) / 2        c = Re(Z Zm)

carry both maps' power, ``|F1|^2 = (qs + c) / 2`` and
``|F2|^2 = (qs - c) / 2`` pointwise, and their full-plane bin sums follow
from the half plane (rows ``half_rows(n)[0]``) as
``2 bin(half) - bin(row ky=0) + bin(row ky=n/2)``. The cross field

    s = Im(Z Zm) = zr zmi + zi zmr

is mirror-even too, and ``s / 2 = Re(F1 conj(F2))`` is the two maps' cross
power.

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
* :func:`rows_half` (B6s, the B6 kernel templated on its field),
  :func:`rows_pp` and :func:`fft2pp_s`: the same for ``s``. ``rowqc_pp``
  and ``rows_pp`` are one composition with a field selector
  (:func:`qc_fields` or :func:`s_field`).

For CPU tensors the wrappers run the plain versions :func:`rowqc_pp_ref`
and :func:`rows_pp_ref`; for CUDA tensors they launch the kernels. There
is no fallback from one to the other.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _build
from .dft import (_check, _tables, colfft, half_rows, rowfft, rowfft_blk0,
                  rowfft_ref)
from .mirror import _mirror_tables, mirror_pp_ref

__all__ = ["qc_fields", "s_field", "rowqc_half", "rowqc_pp", "rowqc_pp_ref",
           "fft2pp_qc", "rows_half", "rows_pp", "rows_pp_ref", "fft2pp_s"]


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


def s_field(zr, zi, mr, mi):
    """``(s,)``, ``s = Im(Z Zm)``, from ``Z`` and its mirror, elementwise."""
    return (zr * mi + zi * mr,)


def _fields_ref(yr, yi, field):
    """Plain half-plane ``field`` of ``Z`` = :func:`rowfft_ref` of every
    row, with ``Zm`` = ``mirror_pp_ref(Z)``, on the rows ``half_rows(n)[0]``;
    then ``zrow`` = ``Z``'s rows ``[0, 128)``."""
    zr, zi = rowfft_ref(yr, yi)
    mr, mi = mirror_pp_ref(zr, zi)
    p = _strip_tables(zr.shape[-1], zr.device)[3]
    out = field(*(a.index_select(1, p) for a in (zr, zi, mr, mi)))
    return out + (zr[:, :128].contiguous(), zi[:, :128].contiguous())


def rowqc_pp_ref(yr, yi):
    """Plain version of :func:`rowqc_pp`: ``(qs, c, zrow_r, zrow_i)``."""
    return _fields_ref(yr, yi, qc_fields)


def rows_pp_ref(yr, yi):
    """Plain version of :func:`rows_pp`: ``(s, zrow_r, zrow_i)``."""
    return _fields_ref(yr, yi, s_field)


def _half(yr, yi, s_only, what):
    """Launch B6 (``(qs, c)``) or B6s (``(s,)``) on ``(b, n, n)`` CUDA
    planes."""
    b, n, _ = yr.shape
    if not (yr.is_contiguous() and yi.is_contiguous()):
        raise ValueError(f"{what} needs contiguous tensors")
    lib = _build.library()
    if n > lib.dft_max_n():
        raise ValueError(f"{what}: n={n} exceeds the kernel's "
                         f"{lib.dft_max_n()}")
    outs = tuple(torch.empty((b, n // 2, n), dtype=torch.float32,
                             device=yr.device)
                 for _ in range(1 if s_only else 2))
    tab = _tables(n, False, yr.device).data_ptr()
    stream = torch.cuda.current_stream(yr.device).cuda_stream
    if s_only:
        err = lib.rows_half_launch(yr.data_ptr(), yi.data_ptr(), tab,
                                   outs[0].data_ptr(), b, n, stream)
    else:
        err = lib.rowqc_half_launch(yr.data_ptr(), yi.data_ptr(), tab,
                                    outs[0].data_ptr(), outs[1].data_ptr(),
                                    b, n, stream)
    _build.check(err, what)
    return outs


def _check_square(yr, yi, what):
    _check(yr, yi, -1, what)
    if yr.shape[1] != yr.shape[2]:
        raise ValueError(f"{what} takes (batch, n, n) planes, got "
                         f"{tuple(yr.shape)}")


def rowqc_half(yr, yi):
    """``(qs, c)``, each ``(b, n/2, n)`` float32 over the half plane in
    :func:`half_rows` order, of ``Z = rowfft(Y)`` for ``(b, n, n)``
    float32 ``yr, yi`` with rows in ``row_perm`` order (B6)."""
    _check_square(yr, yi, "rowqc_half")
    if not yr.is_cuda:
        return rowqc_pp_ref(yr, yi)[:2]
    out = _half(yr, yi, False, "rowqc_half")
    rowqc_half.launches += 1
    return out


def rows_half(yr, yi):
    """``s``, ``(b, n/2, n)`` float32 over the half plane, of ``Z =
    rowfft(Y)`` (B6s; :func:`rowqc_half` with the cross field)."""
    _check_square(yr, yi, "rows_half")
    if not yr.is_cuda:
        return rows_pp_ref(yr, yi)[0]
    out = _half(yr, yi, True, "rows_half")[0]
    rows_half.launches += 1
    return out


rowqc_half.launches = 0
rows_half.launches = 0


def _fields_pp(yr, yi, field, half):
    """The half-plane ``field`` planes from the kernel ``half``, the two
    wrap strips patched from B4 ``zrow`` and B4b as
    ``pallas_fft.rowqc_pp`` / ``rows_pp`` do; then ``zrow_r, zrow_i``."""
    out = half(yr, yi)
    b, n, _ = yr.shape
    ncc, nh = n // 128, n // 2
    mrow, rsrc, csrc, _ = _strip_tables(n, yr.device)
    zrow_r, zrow_i = rowfft(yr[:, :128].contiguous(),
                            yi[:, :128].contiguous())
    zcol_r, zcol_i = rowfft_blk0(yr, yi)

    # rows h < 64 (b == 0): the mirror rows are (128 - a) % 128 of zrow
    zm_rows = lambda z: z.index_select(1, rsrc).index_select(2, mrow)
    for f, v in zip(out, field(zrow_r[:, :64], zrow_i[:, :64],
                               zm_rows(zrow_r), zm_rows(zrow_i))):
        f[:, :64] = v
    # columns [0, 128) of rows h >= 64: lane chunk 0 mirrors into itself
    zm_cols = lambda z: z.index_select(2, mrow[:128]).index_select(1, csrc)
    z_strip = lambda z: z.reshape(b, ncc, 128, 128)[:, :, :64] \
        .reshape(b, nh, 128)[:, 64:]
    for f, v in zip(out, field(z_strip(zcol_r), z_strip(zcol_i),
                               zm_cols(zcol_r), zm_cols(zcol_i))):
        f[:, 64:, :128] = v
    return tuple(out) + (zrow_r, zrow_i)


def rowqc_pp(yr, yi):
    """``(qs, c, zrow_r, zrow_i)`` from the column-DFT intermediate ``Y``
    (``(b, n, n)`` float32): the half-plane fields of ``Z = rowfft(Y)``
    and ``Z``'s rows ``[0, 128)`` for the boundary-row bins
    (``pallas_fft.rowqc_pp``)."""
    return _fields_pp(yr, yi, qc_fields, rowqc_half)


def rows_pp(yr, yi):
    """``(s, zrow_r, zrow_i)``: the half-plane cross field of ``Z =
    rowfft(Y)`` and ``Z``'s rows ``[0, 128)`` (``pallas_fft.rows_pp``)."""
    return _fields_pp(yr, yi, s_field, lambda a, b: (rows_half(a, b),))


def fft2pp_qc(m1, m2):
    """Half-plane fields of ``fft2(m1 + i m2)`` without the Fourier plane:
    ``rowqc_pp(*colfft(m1, m2))`` (``pallas_fft.fft2pp_qc``)."""
    return rowqc_pp(*colfft(m1, m2))


def fft2pp_s(m1, m2):
    """Half-plane cross field of ``fft2(m1 + i m2)`` without the Fourier
    plane: ``rows_pp(*colfft(m1, m2))`` (``pallas_fft.fft2pp_s``)."""
    return rows_pp(*colfft(m1, m2))
