"""Minimal native FITS binary-table I/O (a copy of
``orphics_tpu.utils.fitsio``: numpy only).

The reference reads survey catalogs with ``astropy.io.fits``
(``orphics/catalogs.py:587`` ``load_boss``, ``:706`` ``HSCMapper``).
This is a dependency-free reader/writer for the subset of FITS needed
for those catalogs: the primary HDU plus BINTABLE extensions with
numeric and string columns (TFORM codes L, B, I, J, K, E, D, A and
repeat counts). Big-endian on disk per the standard.
"""
from __future__ import annotations

import re
import numpy as np

__all__ = ["read_bintable", "write_bintable"]

_BLOCK = 2880

_TFORM_DTYPES = {
    "L": ("u1", 1), "B": ("u1", 1), "I": (">i2", 2), "J": (">i4", 4),
    "K": (">i8", 8), "E": (">f4", 4), "D": (">f8", 8), "A": ("S", 1),
}


def _read_header(f):
    cards = {}
    order = []
    while True:
        block = f.read(_BLOCK)
        if len(block) < _BLOCK:
            raise ValueError("truncated FITS header")
        done = False
        for i in range(0, _BLOCK, 80):
            card = block[i:i + 80].decode("ascii", "replace")
            key = card[:8].strip()
            if key == "END":
                done = True
                break
            if not key or "=" not in card[:10]:
                continue
            val = card[10:].split("/")[0].strip()
            if val.startswith("'"):
                val = val[1:val.rindex("'")].strip()
            elif val in ("T", "F"):
                val = (val == "T")
            else:
                try:
                    val = int(val)
                except ValueError:
                    try:
                        val = float(val)
                    except ValueError:
                        pass
            cards[key] = val
            order.append(key)
        if done:
            return cards


def _skip_data(f, header):
    bitpix = abs(int(header.get("BITPIX", 8)))
    naxis = int(header.get("NAXIS", 0))
    size = 1 if naxis > 0 else 0
    for i in range(1, naxis + 1):
        size *= int(header[f"NAXIS{i}"])
    nbytes = size * (bitpix // 8)
    nbytes += int(header.get("PCOUNT", 0))
    f.seek((nbytes + _BLOCK - 1) // _BLOCK * _BLOCK, 1)


def read_bintable(path, hdu: int = 1):
    """Read a BINTABLE extension into a dict of numpy column arrays."""
    with open(path, "rb") as f:
        header = _read_header(f)          # primary
        _skip_data(f, header)
        for _ in range(hdu - 1):
            header = _read_header(f)
            _skip_data(f, header)
        header = _read_header(f)
        if header.get("XTENSION", "").strip() != "BINTABLE":
            raise ValueError(f"HDU {hdu} is not a BINTABLE")
        nrows = int(header["NAXIS2"])
        rowbytes = int(header["NAXIS1"])
        ncols = int(header["TFIELDS"])
        names, dtypes = [], []
        for i in range(1, ncols + 1):
            name = str(header.get(f"TTYPE{i}", f"col{i}")).strip()
            tform = str(header[f"TFORM{i}"]).strip()
            m = re.match(r"(\d*)([LBIJKEDA])", tform)
            if not m:
                raise ValueError(f"unsupported TFORM {tform!r}")
            rep = int(m.group(1) or 1)
            code = m.group(2)
            base, _ = _TFORM_DTYPES[code]
            if code == "A":
                dt = (name, f"S{rep}")
            elif rep == 1:
                dt = (name, base)
            else:
                dt = (name, base, (rep,))
            names.append(name)
            dtypes.append(dt)
        rec = np.dtype(dtypes)
        if rec.itemsize != rowbytes:
            raise ValueError(
                f"row size mismatch: dtype {rec.itemsize} vs NAXIS1 "
                f"{rowbytes} (unsupported column type present?)")
        raw = f.read(nrows * rowbytes)
        table = np.frombuffer(raw, dtype=rec, count=nrows)
        # per-column TFORM codes + scaling keywords
        codes = {}
        scales = {}
        for i in range(1, ncols + 1):
            nm = str(header.get(f"TTYPE{i}", f"col{i}")).strip()
            codes[nm] = re.match(
                r"(\d*)([LBIJKEDA])",
                str(header[f"TFORM{i}"]).strip()).group(2)
            tscal = header.get(f"TSCAL{i}")
            tzero = header.get(f"TZERO{i}")
            if tscal is not None or tzero is not None:
                scales[nm] = (float(tscal) if tscal is not None else 1.0,
                              float(tzero) if tzero is not None else 0.0)
        out = {}
        for name in names:
            col = table[name]
            if col.dtype.kind in "iuf":
                col = col.astype(col.dtype.newbyteorder("="))
            col = np.array(col)
            if codes.get(name) == "L":
                # FITS logical columns store ASCII 'T'/'F' bytes —
                # raw uint8 84/70 would make False truthy
                col = col == ord("T")
            elif name in scales:
                # TSCAL/TZERO (e.g. astropy's unsigned ints stored as
                # signed with TZERO = 2^31): physical = scal*raw + zero
                tscal, tzero = scales[name]
                phys = col.astype(np.float64) * tscal + tzero
                if tscal == 1.0 and float(tzero).is_integer():
                    # pure offset of integers: keep EXACT integer
                    # typing (float64 would corrupt large u8 ids).
                    # wraparound uint64 arithmetic maps signed raw +
                    # 2^63 to the true unsigned value.
                    iz = int(tzero)
                    if iz == 2 ** 63:
                        col = (col.astype(np.int64).view(np.uint64)
                               + np.uint64(iz))
                    else:
                        col = col.astype(np.int64) + iz
                else:
                    col = phys
            out[name] = col
        return out


def _card(key, val, comment=""):
    if isinstance(val, bool):
        sval = "T" if val else "F"
        body = f"{key:<8}= {sval:>20}"
    elif isinstance(val, (int, np.integer)):
        body = f"{key:<8}= {val:>20d}"
    elif isinstance(val, float):
        body = f"{key:<8}= {val:>20.10G}"
    else:
        body = f"{key:<8}= '{val}'"
    if comment:
        body += f" / {comment}"
    return body[:80].ljust(80).encode("ascii")


def _pad_block(b):
    pad = (-len(b)) % _BLOCK
    return b + b" " * pad


def write_bintable(path, columns: dict, hdu_name="CATALOG"):
    """Write a dict of 1D numpy arrays as a FITS file with one BINTABLE
    extension (enough for round-trip tests and interchange)."""
    names = list(columns.keys())
    cols = []
    forms = []
    for name in names:
        a = np.asarray(columns[name])
        if a.dtype.kind == "f":
            a = a.astype(">f8")
            forms.append("D")
        elif a.dtype.kind in "iu":
            a = a.astype(">i8")
            forms.append("K")
        elif a.dtype.kind in "SU":
            a = np.char.encode(a.astype("U"), "ascii") \
                if a.dtype.kind == "U" else a
            w = a.dtype.itemsize
            a = a.astype(f"S{w}")
            forms.append(f"{w}A")
        else:
            raise ValueError(f"unsupported column dtype {a.dtype}")
        cols.append(a)
    nrows = len(cols[0]) if cols else 0
    rec = np.dtype([(n, c.dtype) if c.dtype.kind == "S"
                    else (n, c.dtype.str) for n, c in zip(names, cols)])
    table = np.empty(nrows, rec)
    for n, c in zip(names, cols):
        table[n] = c
    # primary HDU
    hdr = b"".join([
        _card("SIMPLE", True), _card("BITPIX", 8), _card("NAXIS", 0),
        _card("EXTEND", True), b"END".ljust(80)])
    out = _pad_block(hdr)
    # bintable header
    cards = [_card("XTENSION", "BINTABLE"), _card("BITPIX", 8),
             _card("NAXIS", 2), _card("NAXIS1", rec.itemsize),
             _card("NAXIS2", nrows), _card("PCOUNT", 0),
             _card("GCOUNT", 1), _card("TFIELDS", len(names)),
             _card("EXTNAME", hdu_name)]
    for i, (n, f2) in enumerate(zip(names, forms), start=1):
        cards.append(_card(f"TTYPE{i}", n))
        cards.append(_card(f"TFORM{i}", f2))
    cards.append(b"END".ljust(80))
    out += _pad_block(b"".join(cards))
    out += _pad_block(table.tobytes())
    with open(path, "wb") as f:
        f.write(out)
