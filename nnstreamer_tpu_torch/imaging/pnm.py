"""Netpbm decoder in numpy (PBM, PGM, PPM, plain and raw, and PIL's PFM
and test extensions): what PIL's ``PpmImagePlugin`` opens, decoded as
``Image.open(...).convert("RGB")`` gives it.

The header is read a byte at a time as PIL reads it: the magic number
runs to the first whitespace (at most six bytes), each token skips the
whitespace before it and ends at the first after it (which is
consumed), a ``#`` skips to the end of its line without ending the
token it interrupts, and a token of more than ten bytes fails.

* ``P1``/``P4`` (mode ``1``): ``1`` is black. ``P2``/``P5`` (``L``) and
  ``P3``/``P6`` (``RGB``), and PIL's ``PyRGBA``, ``PyCMYK``, ``P0CMYK``
  and ``PyP`` (a palette image without a palette: black): any maxval
  1-65535; a grey file with a maxval over 255 opens as mode ``I``.
* Samples are scaled as PIL's decoders scale them:
  ``round(v / maxval * out)`` (Python's round, half to even) with
  ``out`` 65535 for mode ``I`` and 255 otherwise; raw files clip the
  result at ``out``, plain files refuse a sample over maxval. Raw files
  at maxval 255 are read as they are, raw grey files at 65535 as
  big-endian 16-bit ``I``.
* ``Pf`` (PFM grey, mode ``F``): 32-bit floats, little-endian for a
  negative scale, rows bottom-up; the scale does not scale. PIL does not
  open colour ``PF`` files.

A raw file that ends early fails as PIL's load fails on it, and so does
a plain file with too few samples or a bad token.
"""
from __future__ import annotations

import math

import numpy as np

from .base import NotThisFormat, Opened, raw_rows, unpack_bits
from .modes import to_rgb

WHITESPACE = b" \t\n\x0b\x0c\r"
MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L",
         b"P6": "RGB", b"P0CMYK": "CMYK", b"Pf": "F", b"PyP": "P",
         b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}
_BANDS = {"1": 1, "L": 1, "I": 1, "P": 1, "F": 1, "RGB": 3, "RGBA": 4,
          "CMYK": 4}


class _Header:
    def __init__(self, data):
        self.data, self.pos = data, 0

    def _getc(self) -> bytes:
        c = bytes(self.data[self.pos:self.pos + 1])
        self.pos += len(c)
        return c

    def magic(self) -> bytes:
        m = b""
        for _ in range(6):
            c = self._getc()
            if not c or c in WHITESPACE:
                break
            m += c
        return m

    def token(self) -> bytes:
        tok = b""
        while len(tok) <= 10:
            c = self._getc()
            if not c:
                break
            if c in WHITESPACE:
                if not tok:
                    continue
                break
            if c == b"#":
                while self._getc() not in b"\r\n":
                    pass
                continue
            tok += c
        if not tok:
            raise ValueError("PPM: reached EOF while reading header")
        if len(tok) > 10:
            raise ValueError(f"PPM: token too long in file header: {tok!r}")
        return tok


def _strip_comments(block: bytes) -> bytes:
    """PpmPlainDecoder._ignore_comments over one block: each ``#`` to the
    first CR or LF after it, both included."""
    while True:
        start = block.find(b"#")
        if start == -1:
            return block
        ends = [e for e in (block.find(b"\n", start), block.find(b"\r", start))
                if e != -1]
        if not ends:
            return block[:start]
        block = block[:start] + block[min(ends) + 1:]


def _plain(data, pos: int, mode: str, n: int, maxval: int) -> np.ndarray:
    block = _strip_comments(bytes(data[pos:]))
    if mode == "1":
        toks = b"".join(block.split())
        bad = toks.translate(None, b"01")
        if bad:
            raise ValueError(f"PPM: invalid token for this mode: "
                             f"{bad[:1]!r}")
        if len(toks) < n:
            raise ValueError("PPM: not enough image data")
        return np.frombuffer(toks[:n], np.uint8) == ord("0")
    out_max = 65535 if mode == "I" else 255
    vals = []
    for tok in block.split():
        if len(tok) > 10:
            raise ValueError(f"PPM: token too long found in data: "
                             f"{tok[:11]!r}")
        v = int(tok)
        if v < 0:
            raise ValueError(f"PPM: channel value is negative: {v}")
        if v > maxval:
            raise ValueError(f"PPM: channel value too large for this "
                             f"mode: {v}")
        vals.append(v)
        if len(vals) == n:
            break
    if len(vals) < n:
        raise ValueError("PPM: not enough image data")
    return np.rint(np.array(vals, np.float64) / maxval * out_max).astype(
        np.int64)


def _scaled(data, pos: int, mode: str, n: int, maxval: int) -> np.ndarray:
    """PpmDecoder: raw samples at a maxval other than 255 (and 65535 for
    grey)."""
    size = 1 if maxval < 256 else 2
    bands = _BANDS[mode]
    have = (len(data) - pos) // (size * bands) * bands
    if have < n:
        raise ValueError("PPM: not enough image data")
    v = np.frombuffer(data, np.uint8 if size == 1 else ">u2", n, pos)
    out_max = 65535 if mode == "I" else 255
    return np.minimum(out_max, np.rint(v.astype(np.float64) / maxval
                                       * out_max)).astype(np.int64)


def open_pnm(data) -> Opened:
    hd = _Header(data)
    magic = hd.magic()
    if magic not in MODES:
        raise NotThisFormat("not a PPM file")
    mode = MODES[magic]
    width, height = int(hd.token()), int(hd.token())
    plain = magic in (b"P1", b"P2", b"P3")
    maxval = 255
    if mode == "F":
        scale = float(hd.token())
        if scale == 0.0 or not math.isfinite(scale):
            raise ValueError("PPM: scale must be finite and non-zero")
        big = scale > 0
    elif mode != "1":
        maxval = int(hd.token())
        if not 0 < maxval < 65536:
            raise ValueError("PPM: maxval must be greater than 0 and less "
                             "than 65536")
        if maxval > 255 and mode == "L":
            mode = "I"
    pos = hd.pos

    def decode():
        bands = _BANDS[mode]
        n = width * height * bands
        shape = (height, width, bands) if bands > 1 else (height, width)
        if mode == "F":
            rows = raw_rows(data, pos, height, 4 * width, 4 * width, "PFM")
            s = rows.copy().view(">f4" if big else "<f4").reshape(
                height, width)[::-1]
        elif mode == "1":
            if plain:
                s = _plain(data, pos, mode, n, maxval).reshape(shape)
            else:
                rows = raw_rows(data, pos, height, -(-width // 8),
                                -(-width // 8), "PBM")
                s = unpack_bits(rows, width, 1) == 0
        elif plain:
            s = _plain(data, pos, mode, n, maxval).reshape(shape)
        elif maxval == 255:
            rows = raw_rows(data, pos, height, width * bands, width * bands,
                            "PPM")
            s = rows.reshape(shape)
        elif maxval == 65535 and mode == "I":
            rows = raw_rows(data, pos, height, 2 * width, 2 * width, "PGM")
            s = rows.copy().view(">u2").reshape(shape)
        else:
            s = _scaled(data, pos, mode, n, maxval).reshape(shape)
        if mode == "1":
            s = np.asarray(s, np.uint8)
        elif mode not in ("I", "F"):
            s = s.astype(np.uint8)
        return to_rgb(mode, s, np.zeros((0, 3), np.uint8))

    return Opened("PPM", decode, (width, height))
