"""Half-plane power fields, fused with the row DFT or from a stored
Fourier plane (kernels B6, B6s, B6h and B6h'; counterpart of
``orphics_tpu/ops/pallas_fft.py``'s ``rowqc_pp`` / ``fft2pp_qc``,
``rows_pp`` / ``fft2pp_s``, ``qc_pp_half`` and ``s_pp_half`` sections).

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
* :func:`qc_pp_half` (B6h) and :func:`s_pp_half` (B6h', the same kernel
  templated on its field): the fields over the half plane of a ``Z`` that
  is already in device memory, each element read through the exact mirror
  map, so there is no strip to patch.

For CPU tensors the wrappers run the plain versions :func:`rowqc_pp_ref`,
:func:`rows_pp_ref`, :func:`qc_pp_half_ref` and :func:`s_pp_half_ref`; for
CUDA tensors they launch the kernels. There
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
           "fft2pp_qc", "rows_half", "rows_pp", "rows_pp_ref", "fft2pp_s",
           "qc_pp_half", "qc_pp_half_ref", "s_pp_half", "s_pp_half_ref"]


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


def _half_ref(zr, zi, field):
    """Plain half-plane ``field`` of a stored ``Z``, with ``Zm`` =
    ``mirror_pp_ref(Z)``, on the rows ``half_rows(n)[0]``."""
    mr, mi = mirror_pp_ref(zr, zi)
    p = _strip_tables(zr.shape[-1], zr.device)[3]
    return field(*(a.index_select(1, p) for a in (zr, zi, mr, mi)))


def qc_pp_half_ref(zr, zi):
    """Plain version of :func:`qc_pp_half`: ``(qs, c)``."""
    return _half_ref(zr, zi, qc_fields)


def s_pp_half_ref(zr, zi):
    """Plain version of :func:`s_pp_half`: ``s``."""
    return _half_ref(zr, zi, s_field)[0]


def _fields_ref(yr, yi, field):
    """Plain half-plane ``field`` of ``Z`` = :func:`rowfft_ref` of every
    row (:func:`_half_ref`); then ``zrow`` = ``Z``'s rows ``[0, 128)``."""
    zr, zi = rowfft_ref(yr, yi)
    return _half_ref(zr, zi, field) + (zr[:, :128].contiguous(),
                                       zi[:, :128].contiguous())


def rowqc_pp_ref(yr, yi):
    """Plain version of :func:`rowqc_pp`: ``(qs, c, zrow_r, zrow_i)``."""
    return _fields_ref(yr, yi, qc_fields)


def rows_pp_ref(yr, yi):
    """Plain version of :func:`rows_pp`: ``(s, zrow_r, zrow_i)``."""
    return _fields_ref(yr, yi, s_field)


def _half(yr, yi, s_only, what, fused=True):
    """Launch B6 (``(qs, c)``) or B6s (``(s,)``) on ``(b, n, n)`` CUDA
    planes ``Y``; with ``fused=False`` B6h or B6h' on planes ``Z``."""
    b, n, _ = yr.shape
    if not (yr.is_contiguous() and yi.is_contiguous()):
        raise ValueError(f"{what} needs contiguous tensors")
    lib = _build.library()
    if fused and n > lib.dft_max_n():
        raise ValueError(f"{what}: n={n} exceeds the kernel's "
                         f"{lib.dft_max_n()}")
    outs = tuple(torch.empty((b, n // 2, n), dtype=torch.float32,
                             device=yr.device)
                 for _ in range(1 if s_only else 2))
    # B6 and B6s transform the rows first and take the DFT tables
    ins = (yr.data_ptr(), yi.data_ptr()) + (
        (_tables(n, False, yr.device).data_ptr(),) if fused else ())
    launch = {(True, True): lib.rows_half_launch,
              (True, False): lib.rowqc_half_launch,
              (False, True): lib.s_pp_half_launch,
              (False, False): lib.qc_pp_half_launch}[fused, s_only]
    err = launch(*ins, *(o.data_ptr() for o in outs), b, n,
                 torch.cuda.current_stream(yr.device).cuda_stream)
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


def qc_pp_half(zr, zi):
    """``(qs, c)``, each ``(b, n/2, n)`` float32 over the half plane (rows
    ``half_rows(n)[0]``), of a transformed ``(b, n, n)`` float32 ``Z`` in
    the doubly-permuted layout of ``fft2pp`` (B6h): ``qs = (|Z(k)|^2 +
    |Z(-k)|^2) / 2``, ``c = Re(Z(k) Z(-k))``. Full-plane bin sums are
    ``2 bin(half) - bin(row ky=0) + bin(row ky=n/2)``."""
    _check_square(zr, zi, "qc_pp_half")
    if not zr.is_cuda:
        return qc_pp_half_ref(zr, zi)
    out = _half(zr, zi, False, "qc_pp_half", fused=False)
    qc_pp_half.launches += 1
    return out


def s_pp_half(zr, zi):
    """``s = Im(Z(k) Z(-k)) = zr zmi + zi zmr``, ``(b, n/2, n)`` float32 over
    the half plane of a transformed ``Z`` (B6h'; :func:`qc_pp_half` with the
    cross field)."""
    _check_square(zr, zi, "s_pp_half")
    if not zr.is_cuda:
        return s_pp_half_ref(zr, zi)
    out = _half(zr, zi, True, "s_pp_half", fused=False)[0]
    s_pp_half.launches += 1
    return out


rowqc_half.launches = 0
rows_half.launches = 0
qc_pp_half.launches = 0
s_pp_half.launches = 0


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
