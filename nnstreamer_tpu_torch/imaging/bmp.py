"""BMP and DIB decoder in numpy: what PIL's ``BmpImagePlugin`` opens,
decoded as ``Image.open(...).convert("RGB")`` gives it.

* Headers: OS/2 core (12 bytes, 3-byte palette entries), INFO (40) and
  V2/V3/OS/2 v2/V4/V5 (52, 56, 64, 108, 124); a negative height is a
  top-down file.
* 1-, 4- and 8-bit palettes: PIL opens mode ``1`` for a 2-entry
  black/white palette, ``L`` for a palette whose every entry is its own
  grey index, ``P`` otherwise; a short palette reads black past its end.
  A 4-bit file with such a grey palette fails, as Pillow's raw decoder
  fails on it (its rows are read as one byte a pixel, longer than their
  stride).
* 16-bit 5-5-5 and ``BI_BITFIELDS`` 5-6-5 (each field scaled as
  ``x * 255 // max``), 24-bit, 32-bit ``BI_RGB`` (BGRX) and the
  bitfield layouts PIL knows, alpha among them; any other layout fails.
* RLE8 and RLE4 as ``BmpRleDecoder`` reads them, its particulars kept:
  an encoded run is cut at the row's end, an end-of-line pads the row
  with index 0, the delta escape skips two bytes and reads its offsets
  from the two after them, an odd RLE4 literal run loses its last pixel,
  literal runs realign to even positions of the whole file, and a stream
  that ends before the image is full fails, and so does an RLE file
  whose 2-entry palette is black and white (PIL opens it as mode ``1``,
  which its RLE decoder's raw mode ``P`` cannot fill).
* The pixel data's offset as PIL takes it: the header's, plus the
  palette's size where the header's offset is the end of the header.

``open_bitmap`` reads a DIB header at any position without a file
header, for ICO and CUR payloads; ``bitmap_samples``' ``height`` cuts
the decoded height (an icon's DIB holds twice its height).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .base import (NotThisFormat, Opened, raw_rows, rgb555, u16le, u32le,
                   unpack_bits)
from .modes import to_rgb

HEADER_SIZES = (12, 40, 52, 56, 64, 108, 124)
_BIT2MODE = {1: ("P", "P;1"), 4: ("P", "P;4"), 8: ("P", "P"),
             16: ("RGB", "BGR;15"), 24: ("RGB", "BGR"), 32: ("RGB", "BGRX")}
_MASK_MODES = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}
RAW, RLE8, RLE4, BITFIELDS = 0, 1, 2, 3


class Bitmap:
    """A parsed DIB header: what PIL's ``_bitmap`` sets on the image."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def open_bitmap(data, header: int, offset: int = 0) -> Bitmap:
    """PIL's ``BmpImageFile._bitmap(header, offset)`` over ``data``: the
    DIB header at ``header``; ``offset`` the file header's pixel offset
    (0: the pixels follow the header and palette)."""
    size = u32le(data, header)
    pos = header + 4
    if size - 4 > 0 and pos + size - 4 > len(data):
        raise ValueError("BMP: truncated file read of the header")
    hd = bytes(data[pos:pos + max(size - 4, 0)])
    pos += max(size - 4, 0)
    direction = -1
    masks = None
    if size == 12:
        width, height = u16le(hd, 0), u16le(hd, 2)
        bits, compression, padding, colors = u16le(hd, 6), RAW, 3, 0
    elif size in HEADER_SIZES:
        if hd[7] == 0xFF:
            direction = 1
            height = 2 ** 32 - u32le(hd, 4)
        else:
            height = u32le(hd, 4)
        width = u32le(hd, 0)
        bits, compression = u16le(hd, 10), u32le(hd, 12)
        colors, padding = u32le(hd, 28), 4
        if compression == BITFIELDS:
            if len(hd) >= 48:
                n = 4 if len(hd) >= 52 else 3
                masks = [u32le(hd, 36 + 4 * i) for i in range(n)]
                masks += [0] * (4 - n)
            else:
                masks = [u32le(data, pos + 4 * i) for i in range(3)] + [0]
                pos += 12
    else:
        raise ValueError(f"Unsupported BMP header type ({size})")
    colors = colors or (1 << bits)
    if offset == 14 + size and bits <= 8:
        offset += 4 * colors
    if bits not in _BIT2MODE:
        raise ValueError(f"Unsupported BMP pixel depth ({bits})")
    mode, rawmode = _BIT2MODE[bits]
    if compression == BITFIELDS:
        rgba = tuple(masks)
        if bits == 32 and (32, rgba) in _MASK_MODES:
            rawmode = _MASK_MODES[(32, rgba)]
            mode = "RGBA" if "A" in rawmode else mode
        elif bits in (24, 16) and (bits, rgba[:3]) in _MASK_MODES:
            rawmode = _MASK_MODES[(bits, rgba[:3])]
        else:
            raise ValueError("Unsupported BMP bitfields layout")
    elif compression == RAW:
        if bits == 32 and header == 22:     # PIL: a 32-bit .cur offset
            rawmode, mode = "BGRA", "RGBA"
    elif compression not in (RLE8, RLE4):
        raise ValueError(f"Unsupported BMP compression ({compression})")
    palette = None
    if mode == "P":
        if not 0 < colors <= 65536:
            raise ValueError(f"Unsupported BMP Palette size ({colors})")
        pal = bytes(data[pos:pos + padding * colors])
        pos += len(pal)
        indices = (0, 255) if colors == 2 else range(colors)
        grey = True
        for ind, val in enumerate(indices):
            if val > 255:   # PIL's o8(val) raises struct.error: passed on
                raise NotThisFormat("BMP: palette of more than 256 greys")
            if pal[ind * padding:ind * padding + 3] != bytes([val]) * 3:
                grey = False
        if grey:
            mode = rawmode = "1" if colors == 2 else "L"
        else:
            n = len(pal) // padding
            palette = np.frombuffer(pal, np.uint8, n * padding).reshape(
                n, padding)[:, 2::-1]
    stride = ((width * bits + 31) >> 3) & ~3
    return Bitmap(mode=mode, rawmode=rawmode, width=width, height=height,
                  bits=bits, direction=direction, compression=compression,
                  stride=stride, offset=offset or pos, palette=palette)


def _unpack(rows: np.ndarray, rawmode: str, width: int) -> np.ndarray:
    """Pillow's unpacker ``rawmode`` over (H, row bytes) -> samples."""
    if rawmode in ("P;1", "1"):
        v = unpack_bits(rows, width, 1)
        return v * np.uint8(255) if rawmode == "1" else v
    if rawmode == "P;4":
        return unpack_bits(rows, width, 4)
    if rawmode in ("P", "L"):
        return rows[:, :width]
    if rawmode in ("BGR;15", "BGR;16"):
        return rgb555(rows[:, :2 * width].copy().view("<u2"),
                      5 if rawmode == "BGR;15" else 6)
    n = len(rawmode)
    px = rows[:, :n * width].reshape(rows.shape[0], width, n)
    order = {c: i for i, c in enumerate(rawmode)}
    chans = [px[..., order[c]] for c in "RGB"]
    if "A" in order:
        chans.append(px[..., order["A"]])
    return np.stack(chans, -1)


def _rle(data, pos: int, width: int, height: int, rle4: bool) -> np.ndarray:
    """BmpRleDecoder: the indices, in file row order."""
    out = bytearray()
    x, n = 0, len(data)
    dest = width * height
    while len(out) < dest:
        if pos + 2 > n:
            break
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:
            if x + count > width:
                count = max(0, width - x)
            if rle4:
                pair = bytes([byte >> 4, byte & 15])
                out += (pair * ((count + 1) // 2))[:count]
            else:
                out += bytes([byte]) * count
            x += count
        elif byte == 0:
            if len(out) % width:
                out += bytes(width - len(out) % width)
            x = 0
        elif byte == 1:
            break
        elif byte == 2:
            if pos + 2 > n:
                break
            pos += 2        # PIL reads the delta's two bytes and drops them
            if pos + 2 > n:
                raise ValueError("BMP RLE: a delta escape past the end")
            right, up = data[pos], data[pos + 1]
            pos += 2
            out += bytes(right + up * width)
            x = len(out) % width
        else:
            if rle4:
                lit = bytes(data[pos:pos + byte // 2])
                pos += len(lit)
                for b in lit:
                    out += bytes([b >> 4, b & 15])
                if len(lit) < byte // 2:
                    break
            else:
                lit = bytes(data[pos:pos + byte])
                pos += len(lit)
                out += lit
                if len(lit) < byte:
                    break
            x += byte
            pos += pos % 2
    if len(out) < dest:
        raise ValueError(f"BMP RLE: not enough image data ({len(out)} of "
                         f"{dest} pixels)")
    return np.frombuffer(bytes(out[:dest]), np.uint8).reshape(height, width)


def bitmap_samples(bm: Bitmap, data,
                   height: Optional[int] = None) -> Tuple[str, np.ndarray]:
    """(mode, samples) of a parsed bitmap, ``height`` rows of it (an
    icon's DIB: the first half of its rows in file order)."""
    h = bm.height if height is None else height
    w = bm.width
    if bm.compression in (RLE8, RLE4):
        if bm.mode == "1":
            raise ValueError("BMP RLE: PIL has no raw mode P for a "
                             "black-and-white (mode 1) bitmap")
        s = _rle(data, bm.offset, w, h, bm.compression == RLE4)
    else:
        row_bytes = (bm.bits * w + 7) // 8
        if bm.rawmode == "L" and bm.bits == 4:
            raise ValueError("BMP: Pillow's raw decoder refuses a 4-bit "
                             "file with a grey palette (its rows outrun "
                             "their stride)")
        rows = raw_rows(data, bm.offset, h, row_bytes, bm.stride, "BMP")
        s = _unpack(rows, bm.rawmode, w)
    if bm.direction == -1:
        s = s[::-1]
    return bm.mode, s


def bitmap_rgb(bm: Bitmap, data, height: Optional[int] = None) -> np.ndarray:
    mode, s = bitmap_samples(bm, data, height)
    return to_rgb(mode, s, bm.palette)


def open_bmp(data) -> Opened:
    if bytes(data[:2]) != b"BM":
        raise NotThisFormat("not a BMP file")
    offset = u32le(data, 10)
    bm = open_bitmap(data, 14, offset)
    return Opened("BMP", lambda: bitmap_rgb(bm, data), (bm.width, bm.height))


def open_dib(data) -> Opened:
    """PIL's DIB: a bitmap header at byte 0, no file header."""
    bm = open_bitmap(data, 0)
    return Opened("DIB", lambda: bitmap_rgb(bm, data), (bm.width, bm.height))
