"""TGA decoder in numpy: what PIL's ``TgaImagePlugin`` opens, decoded as
``Image.open(...).convert("RGB")`` gives it.

TGA has no magic number: PIL tries it after every plugin before it has
passed the bytes on, and takes them when the header's colour-map type
is 0 or 1, the size is positive and the depth is 1, 8, 16, 24 or 32.

* Image types 1 and 9 (colour-mapped; mode ``P``, or ``L`` without a
  map), 2 and 10 (true colour: 16-bit 5-5-5 scaled ``x * 255 // 31``,
  24-bit BGR, 32-bit BGRA), 3 and 11 (grey: 1-bit ``1``, 8-bit ``L``,
  16-bit grey+alpha ``LA``); 9-11 run-length coded, a raw packet free to
  cross a row's end, a run packet not (Pillow's decoder overruns).
* The colour map at 16 (5-5-5) or 24 bits, its entries before the first
  index black, indices past its end black; a 32-bit map fails at load,
  as in PIL (it has no raw palette mode BGRA).
* The origin bits: bottom-up unless bit 5 is set, mirrored when bit 4 is.

A depth or map depth PIL does not know passes the bytes on (15 among
them); a mode PIL opens but cannot unpack (an 8-bit true-colour file, a
colour map without one ...) fails, as PIL's load fails, and so does a
file that ends before its pixels.
"""
from __future__ import annotations

import numpy as np

from .base import (NotThisFormat, Opened, raw_rows, rgb555, u16le,
                   unpack_bits)
from .modes import to_rgb

_RAWMODES = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA",
             (2, 16): "BGRA;15Z", (2, 24): "BGR", (2, 32): "BGRA"}


def _rle(data, pos: int, npix: int, size: int, width: int) -> bytes:
    """TGA run-length packets -> ``npix`` pixels of ``size`` bytes. A raw
    packet may cross a row's end; a run packet that would fails, as
    Pillow's decoder fails on it (a buffer overrun)."""
    out = bytearray()
    need, n, row = npix * size, len(data), width * size
    while len(out) < need:
        if pos >= n:
            raise ValueError("TGA: image file is truncated (the RLE packets "
                             f"end after {len(out) // size} of {npix} "
                             "pixels)")
        head = data[pos]
        pos += 1
        count = (head & 0x7F) + 1
        if head & 0x80:
            if len(out) % row + count * size > row:
                raise ValueError("TGA: a run packet crosses the end of a "
                                 "row (PIL: buffer overrun)")
            px = bytes(data[pos:pos + size])
            pos += size
            if len(px) < size:
                continue
            out += px * count
        else:
            chunk = bytes(data[pos:pos + count * size])
            pos += len(chunk)
            out += chunk
    return bytes(out[:need])


def open_tga(data) -> Opened:
    s = bytes(data[:18])
    id_len, cmtype, itype, depth, flags = s[0], s[1], s[2], s[16], s[17]
    width, height = u16le(s, 12), u16le(s, 14)
    if cmtype not in (0, 1) or width <= 0 or height <= 0 or \
            depth not in (1, 8, 16, 24, 32):
        raise NotThisFormat("not a TGA file")
    if itype in (3, 11):
        mode = {1: "1", 16: "LA"}.get(depth, "L")
    elif itype in (1, 9):
        mode = "P" if cmtype else "L"
    elif itype in (2, 10):
        mode = "RGB" if depth == 24 else "RGBA"
    else:
        raise NotThisFormat("unknown TGA mode")
    orient = flags & 0x30
    pos = 18 + id_len
    palette = None
    if cmtype:
        start, size, mapdepth = u16le(s, 3), u16le(s, 5), s[7]
        k = {16: 2, 24: 3, 32: 4}.get(mapdepth)
        if k is None:
            raise NotThisFormat("unknown TGA map depth")
        raw = bytes(data[pos:pos + k * size])
        pos += len(raw)
        ent = np.frombuffer(raw, np.uint8, len(raw) // k * k).reshape(-1, k)
        if k == 2:
            pal = rgb555(ent.copy().view("<u2")[:, 0])
        elif k == 4:
            pal = None      # Pillow has no raw palette mode BGRA
        else:
            pal = ent[:, 2::-1]
        palette = pal if pal is None else np.concatenate(
            [np.zeros((start, 3), np.uint8), pal])
    rawmode = _RAWMODES.get((itype & 7, depth))

    def decode():
        if cmtype and palette is None:
            raise ValueError("TGA: PIL cannot read a 32-bit colour map "
                             "(no raw palette mode BGRA)")
        if rawmode is None or (rawmode == "P" and mode == "L"):
            raise ValueError(f"TGA: PIL cannot unpack image type {itype} at "
                             f"{depth} bits (mode {mode})")
        if depth == 1:
            row = -(-width // 8)
            if itype & 8:
                raise ValueError("TGA: PIL cannot decode a 1-bit RLE file")
            px = unpack_bits(raw_rows(data, pos, height, row, row, "TGA"),
                             width, 1) * np.uint8(255)
        else:
            size = depth // 8
            npix = width * height
            if itype & 8:
                buf = _rle(data, pos, npix, size, width)
            else:
                buf = bytes(data[pos:pos + npix * size])
                if len(buf) < npix * size:
                    raise ValueError("TGA: image file is truncated")
            px = np.frombuffer(buf, np.uint8).reshape(height, width, size)
            if rawmode == "BGRA;15Z":
                px = rgb555(px.copy().view("<u2")[..., 0])
            elif rawmode in ("BGR", "BGRA"):
                px = px[..., 2::-1]
            elif size == 1:
                px = px[..., 0]
        if orient in (0, 0x10):
            px = px[::-1]
        if orient in (0x10, 0x30):
            px = px[:, ::-1]
        m = "RGB" if rawmode in ("BGRA;15Z", "BGRA") else mode
        return to_rgb(m, px, palette)

    return Opened("TGA", decode)
