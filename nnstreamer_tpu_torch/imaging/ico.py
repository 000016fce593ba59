"""ICO and CUR decoders: what PIL's ``IcoImagePlugin`` and
``CurImagePlugin`` open, decoded as ``Image.open(...).convert("RGB")``
gives it.

* ICO: the entry PIL loads is the first after sorting the directory by
  colour depth (the entry's bit count, else ``ceil(log2(colours))``,
  else 256), then, stably, by area, largest first: the largest icon, at
  its lowest depth among those of that size (a width or height byte of 0
  is 256). A PNG payload decodes as a PNG; any other is a DIB without a
  file header whose height counts the AND mask too, so its first half of
  rows (bottom-up) is the image. PIL then reads the alpha from every
  fourth byte of a 32-bit entry, or the AND mask from the end of the
  entry's bytes; RGB keeps neither, but PIL fails where they run past the
  file, and so does this decoder.
* CUR: the first directory entry, replaced by each later one that is
  both wider and taller (the raw size bytes: 0 stays 0); the DIB is read
  as PIL's BMP plugin reads it (a 32-bit ``BI_RGB`` DIB at byte 22, the
  first entry's usual place, is BGRA) and its height halved. A PNG
  payload fails, as PIL fails on it.
"""
from __future__ import annotations

import math

import numpy as np

from .base import NotThisFormat, Opened, u16le, u32le
from .bmp import bitmap_rgb, open_bitmap
from .png import SIGNATURE as PNG_SIGNATURE
from .png import decode_png


def _entries(data):
    count = u16le(data, 4)
    out = []
    for i in range(count):
        s = bytes(data[6 + 16 * i:22 + 16 * i])
        width, height = s[0] or 256, s[1] or 256
        ncol, bpp = s[2], u16le(s, 6)
        depth = bpp or (ncol != 0 and math.ceil(math.log(ncol, 2))) or 256
        out.append(dict(width=width, height=height, bpp=bpp,
                        size=u32le(s, 8), offset=u32le(s, 12),
                        square=width * height, depth=depth))
    out.sort(key=lambda e: e["depth"])
    out.sort(key=lambda e: e["square"], reverse=True)
    return out


def _ico_entry_rgb(data, e) -> np.ndarray:
    off = e["offset"]
    if bytes(data[off:off + 8]) == PNG_SIGNATURE:
        return decode_png(bytes(data[off:]))
    bm = open_bitmap(data, off)
    h = int(bm.height / 2)
    w = bm.width
    if e["bpp"] == 32:
        if len(data) - bm.offset < w * h * 4:
            raise ValueError("ICO: not enough image data for the 32-bit "
                             "entry's alpha")
    else:
        wpad = w + (32 - w % 32) % 32
        total = int(wpad * h / 8)
        start = off + e["size"] - total
        if start < 0:
            raise ValueError("ICO: the AND mask starts before the file")
        if len(data) - start < (h - 1) * (wpad // 8) + -(-w // 8) and h:
            raise ValueError("ICO: not enough image data for the AND mask")
    return bitmap_rgb(bm, data, h)


def open_ico(data) -> Opened:
    if bytes(data[:4]) != b"\0\0\1\0":
        raise NotThisFormat("not an ICO file")
    entries = _entries(data)
    first = entries[0]
    return Opened("ICO", lambda: _ico_entry_rgb(data, first))


def open_cur(data) -> Opened:
    if bytes(data[:4]) != b"\0\0\2\0":
        raise NotThisFormat("not a CUR file")
    m = None
    for i in range(u16le(data, 4)):
        s = bytes(data[6 + 16 * i:22 + 16 * i])
        if m is None:
            m = s
        elif s[0] > m[0] and s[1] > m[1]:
            m = s
    if m is None:
        raise NotThisFormat("CUR: no cursors were found")
    bm = open_bitmap(data, u32le(m, 12))
    if bm.height // 2 <= 0 or bm.width <= 0:
        raise NotThisFormat("CUR: not identified by this driver")
    return Opened("CUR", lambda: bitmap_rgb(bm, data, bm.height // 2))
