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
  one pass; the Fourier plane never reaches device memory. For ``n = 128
  Bk`` with ``Bk`` in {2, 4, 8, 16, 32} the kernel is the register-resident
  instantiation (radix-2 stage 1 in registers, the 128-point stage as
  16 x 8, the pairing read in output order; :func:`half_fields_emul` is the
  same algorithm in plain PyTorch); any other ``Bk`` (``n = 384``) takes the
  instantiation on the shared-memory radix-2 core. Both are hand-written
  kernels of one family; a shape neither takes raises.
* :func:`rowqc_pp`: the same launch also writes ``zrow``, ``Z``'s rows
  ``[0, 128)`` (the boundary rows' source): the blocks of the half rows
  ``h < 64`` hold rows 0-63 and 65-127, and one block more per batch entry
  transforms row 64. The JAX function composes B6 with B4 for ``zrow`` and
  rewrites two wrap strips from B4 and B4b, because the TPU kernel's
  in-register mirror is wrong there; B6 pairs every element through the
  exact mirror map, so nothing is patched here.
* :func:`fft2pp_qc`: ``rowqc_pp(*colfft(m1, m2))``.
* :func:`rows_half` (B6s, the B6 kernel templated on its field),
  :func:`rows_pp` and :func:`fft2pp_s`: the same for ``s``.
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
from .dft import (_check, _tables, colfft, half_rows, rowfft_ref,
                  rowfft_split_emul)
from .mirror import mirror_pp_ref

__all__ = ["qc_fields", "s_field", "rowqc_half", "rowqc_pp", "rowqc_pp_ref",
           "fft2pp_qc", "rows_half", "rows_pp", "rows_pp_ref", "fft2pp_s",
           "qc_pp_half", "qc_pp_half_ref", "s_pp_half", "s_pp_half_ref",
           "mirror_pos", "half_fields_emul"]


@functools.lru_cache(maxsize=16)
def _half_row_index(n, device):
    """``half_rows(n)[0]`` as a long tensor on ``device``."""
    return torch.as_tensor(half_rows(n)[0], dtype=torch.long, device=device)


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
    p = _half_row_index(zr.shape[-1], zr.device)
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


def mirror_pos(p, bk):
    """The permuted position of frequency ``-k(p)``, as the kernels compute
    it (``csrc/dft_core.cuh:mirror_pos``): ``k = k2 + bk k1`` sits at
    ``p = 128 k2 + k1``, and ``-k`` at ``(0, (128 - k1) % 128)`` for
    ``k2 = 0`` and at ``(bk - k2, 127 - k1)`` otherwise."""
    p = np.asarray(p)
    k2, k1 = p // 128, p % 128
    return np.where(k2 == 0, (128 - k1) % 128,
                    128 * (bk - k2) + 127 - k1)


def half_fields_emul(yr, yi, field, rows=None):
    """The register-resident B6 / B6s kernel's algorithm in plain PyTorch:
    for each half row ``h`` (all of them, or the compact indices ``rows``)
    row ``p`` and row ``mirror_pos(p)`` of ``Y`` go through
    :func:`~orphics_tpu_torch.ops.dft.rowfft_split_emul`, and column ``q``
    of the first is paired with column ``mirror_pos(q)`` of the second in
    ``field`` (:func:`qc_fields` or :func:`s_field`), in float32. Returns
    the field planes, ``(b, len(rows), n)`` each. ``n = 128 Bk`` with
    ``Bk`` a power of two."""
    n = yr.shape[-1]
    bk = n // 128
    p = half_rows(n)[0] if rows is None else half_rows(n)[0][np.asarray(rows)]
    as_long = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.long,
                                        device=yr.device)
    pm = as_long(mirror_pos(p, bk))
    qm = as_long(mirror_pos(np.arange(n), bk))
    p = as_long(p)
    zr, zi = rowfft_split_emul(yr.index_select(1, p), yi.index_select(1, p))
    mr, mi = rowfft_split_emul(yr.index_select(1, pm), yi.index_select(1, pm))
    return field(zr, zi, mr.index_select(2, qm), mi.index_select(2, qm))


def _half(yr, yi, s_only, what, fused=True, zrow=False):
    """Launch B6 (``(qs, c)``) or B6s (``(s,)``) on ``(b, n, n)`` CUDA
    planes ``Y``; with ``fused=False`` B6h or B6h' on planes ``Z``. With
    ``zrow`` B6 / B6s also write ``Z``'s rows ``[0, 128)``, returned after
    the fields as ``(b, 128, n)`` re and im."""
    b, n, _ = yr.shape
    if not (yr.is_contiguous() and yi.is_contiguous()):
        raise ValueError(f"{what} needs contiguous tensors")
    lib = _build.library()
    if fused and n > lib.dft_max_n():
        raise ValueError(f"{what}: n={n} exceeds the kernel's "
                         f"{lib.dft_max_n()}")
    new = lambda rows: torch.empty((b, rows, n), dtype=torch.float32,
                                   device=yr.device)
    outs = tuple(new(n // 2) for _ in range(1 if s_only else 2))
    rows = tuple(new(128) for _ in range(2)) if zrow else ()
    args = [yr.data_ptr(), yi.data_ptr()]
    if fused:
        # B6 and B6s transform the rows first and take the DFT tables
        args.append(_tables(n, False, yr.device).data_ptr())
    args += [o.data_ptr() for o in outs]
    if fused:
        args += [r.data_ptr() for r in rows] or [None, None]
    args += [b, n]
    launch = {(True, True): lib.rows_half_launch,
              (True, False): lib.rowqc_half_launch,
              (False, True): lib.s_pp_half_launch,
              (False, False): lib.qc_pp_half_launch}[fused, s_only]
    err = launch(*args, torch.cuda.current_stream(yr.device).cuda_stream)
    _build.check(err, what)
    return outs + rows


def _check_square(yr, yi, what):
    _check(yr, yi, -1, what)
    if yr.shape[1] != yr.shape[2]:
        raise ValueError(f"{what} takes (batch, n, n) planes, got "
                         f"{tuple(yr.shape)}")


def rowqc_half(yr, yi):
    """``(qs, c)``, each ``(b, n/2, n)`` float32 over the half plane in
    :func:`half_rows` order, of ``Z = rowfft(Y)`` for ``(b, n, n)``
    float32 ``yr, yi`` with rows in ``row_perm`` order (B6). On the card
    ``n = 128 Bk`` with ``Bk`` in {2, 4, 8, 16, 32} launches the
    register-resident kernel, any other ``Bk`` up to 32 the one on the
    shared-memory radix-2 core."""
    _check_square(yr, yi, "rowqc_half")
    if not yr.is_cuda:
        return rowqc_pp_ref(yr, yi)[:2]
    out = _half(yr, yi, False, "rowqc_half")
    rowqc_half.launches += 1
    return out


def rows_half(yr, yi):
    """``s``, ``(b, n/2, n)`` float32 over the half plane, of ``Z =
    rowfft(Y)`` (B6s; :func:`rowqc_half` with the cross field, the same
    instantiation by ``Bk``)."""
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


def rowqc_pp(yr, yi):
    """``(qs, c, zrow_r, zrow_i)`` from the column-DFT intermediate ``Y``
    (``(b, n, n)`` float32): the half-plane fields of ``Z = rowfft(Y)``
    and ``Z``'s rows ``[0, 128)`` for the boundary-row bins
    (``pallas_fft.rowqc_pp``), all from one B6 launch: the blocks of the
    half rows ``h < 64`` hold rows 0-63 and 65-127 of ``Z`` and write them,
    and one block more per batch entry transforms row 64."""
    _check_square(yr, yi, "rowqc_pp")
    if not yr.is_cuda:
        return rowqc_pp_ref(yr, yi)
    out = _half(yr, yi, False, "rowqc_pp", zrow=True)
    rowqc_half.launches += 1
    return out


def rows_pp(yr, yi):
    """``(s, zrow_r, zrow_i)``: the half-plane cross field of ``Z =
    rowfft(Y)`` and ``Z``'s rows ``[0, 128)`` (``pallas_fft.rows_pp``), from
    one B6s launch as :func:`rowqc_pp`'s from B6."""
    _check_square(yr, yi, "rows_pp")
    if not yr.is_cuda:
        return rows_pp_ref(yr, yi)
    out = _half(yr, yi, True, "rows_pp", zrow=True)
    rows_half.launches += 1
    return out


def fft2pp_qc(m1, m2):
    """Half-plane fields of ``fft2(m1 + i m2)`` without the Fourier plane:
    ``rowqc_pp(*colfft(m1, m2))`` (``pallas_fft.fft2pp_qc``)."""
    return rowqc_pp(*colfft(m1, m2))


def fft2pp_s(m1, m2):
    """Half-plane cross field of ``fft2(m1 + i m2)`` without the Fourier
    plane: ``rows_pp(*colfft(m1, m2))`` (``pallas_fft.fft2pp_s``)."""
    return rows_pp(*colfft(m1, m2))
