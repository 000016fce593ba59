"""PNG decoder on the standard library's ``zlib`` and numpy.

Gives what PIL's ``Image.open(...).convert("RGB")`` gives for the same
file, for every colour type and bit depth of the PNG specification
(grey 1-16 bits, RGB and RGBA 8 and 16, grey+alpha 8 and 16, palette
1-8 bits with or without ``tRNS``), Adam7 interlacing and all five
filter types. Where PIL's conversion to RGB is particular, this module
does the same:

* 16-bit grey opens as PIL mode ``I;16``, whose conversion to RGB clips
  each sample to 255 (it does not scale); 16-bit RGB, RGBA and
  grey+alpha keep each sample's high byte;
* 1-, 2- and 4-bit grey stretch to 0-255 (x255, x85, x17);
* alpha is dropped, never composited; a palette's ``tRNS`` alphas and a
  grey or RGB colour key change nothing in RGB.

Every chunk's CRC is checked: a corrupt or truncated file raises
``ValueError`` naming the chunk. Unfiltering is the sequential part of
PNG (Sub, Average and Paeth read the byte to the left). A file whose rows
use only None, Sub and Up is undone a row at a time (Sub as a cumulative
sum mod 256); otherwise all rows run along a wavefront of anti-diagonals:
every filter unit on one anti-diagonal depends only on the two before
it, so each step is one vectorised update over the diagonal, stored
skewed so that its neighbours are contiguous slices.
"""
from __future__ import annotations

import struct
import zlib
from typing import List

import numpy as np

from .base import unpack_bits
from .modes import to_rgb

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_GRAY_STRETCH = {1: 255, 2: 85, 4: 17, 8: 1}


def _chunks(data: bytes):
    """(type, body) of each chunk through IEND, every CRC checked."""
    if bytes(data[:8]) != SIGNATURE:
        raise ValueError("not a PNG stream (bad signature)")
    pos, n = 8, len(data)
    while True:
        if pos + 8 > n:
            raise ValueError(f"truncated PNG: no chunk header at byte {pos}")
        length, kind = struct.unpack_from(">I4s", data, pos)
        end = pos + 12 + length
        if end > n:
            raise ValueError(f"truncated PNG: chunk {kind!r} at byte {pos} "
                             f"runs past the end")
        body = bytes(data[pos + 8:pos + 8 + length])
        (crc,) = struct.unpack_from(">I", data, pos + 8 + length)
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"corrupt PNG: chunk {kind!r} at byte {pos} "
                             f"fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos = end


def _unfilter_rows(f: np.ndarray, types: np.ndarray, bpp: int) -> np.ndarray:
    """None, Sub and Up only: a row at a time."""
    out = np.empty_like(f)
    prior = np.zeros(f.shape[1], np.uint8)
    for r in range(f.shape[0]):
        t = types[r]
        if t == 0:
            out[r] = f[r]
        elif t == 1:
            out[r] = f[r].reshape(-1, bpp).cumsum(0, dtype=np.uint8).ravel()
        else:
            out[r] = f[r] + prior
        prior = out[r]
    return out


def _unfilter_wavefront(f: np.ndarray, types: np.ndarray,
                        bpp: int) -> np.ndarray:
    """Any mix of the five filters, along anti-diagonals of filter units
    (``bpp`` bytes). Unit (r, u) sits on diagonal r + u; it needs its
    left (r, u-1) and upper-left (r-1, u-1) neighbours and the unit above
    (r-1, u), all on the two diagonals before. ``s[d + 2, r + 1]`` holds
    unit (r, d - r), so each of those is a contiguous slice; a slot
    outside the image is never written and reads 0, as PNG's edges do."""
    h, row_bytes = f.shape
    units = row_bytes // bpp
    ndiag = h + units - 1
    f3 = f.reshape(h, units, bpp).astype(np.int16)
    skew = np.zeros((h, ndiag, bpp), np.int16)
    for r in range(h):
        skew[r, r:r + units] = f3[r]
    fs = np.ascontiguousarray(skew.transpose(1, 0, 2))
    ts = np.asarray(types, np.int16)[:, None]
    s = np.zeros((ndiag + 2, h + 1, bpp), np.int16)
    for d in range(ndiag):
        r0, r1 = max(0, d - units + 1), min(h, d + 1)
        a = s[d + 1, r0 + 1:r1 + 1]
        b = s[d + 1, r0:r1]
        c = s[d, r0:r1]
        t = ts[r0:r1]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.where(t == 4, paeth, np.where(
            t == 3, (a + b) >> 1, np.where(t == 2, b, np.where(t == 1, a, 0))))
        s[d + 2, r0 + 1:r1 + 1] = (fs[d, r0:r1] + pred) & 255
    rows = np.arange(h)[:, None]
    cols = rows + np.arange(units)[None, :] + 2
    return s[cols, rows + 1].astype(np.uint8).reshape(h, row_bytes)


def _unfilter(raw: bytes, pos: int, height: int, row_bytes: int, bpp: int):
    """The unfiltered (height, row_bytes) image at ``raw[pos:]``, and the
    position after it."""
    n = height * (row_bytes + 1)
    if pos + n > len(raw):
        raise ValueError("corrupt PNG: the image data is shorter than its "
                         "header says")
    rows = np.frombuffer(raw, np.uint8, n, pos).reshape(height, row_bytes + 1)
    types, f = rows[:, 0], rows[:, 1:]
    if types.max(initial=0) > 4:
        raise ValueError(f"corrupt PNG: filter type {int(types.max())}")
    if (types >= 3).any():
        return _unfilter_wavefront(f, types, bpp), pos + n
    return _unfilter_rows(f, types, bpp), pos + n


def _samples(rows: np.ndarray, width: int, channels: int,
             depth: int) -> np.ndarray:
    """(H, row bytes) -> (H, W, C) integer samples."""
    h = rows.shape[0]
    if depth == 8:
        return rows[:, :width * channels].reshape(h, width, channels)
    if depth == 16:
        return rows[:, :width * channels * 2].copy().view(">u2").astype(
            np.uint16).reshape(h, width, channels)
    return unpack_bits(rows, width * channels, depth).reshape(h, width,
                                                              channels)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8 RGB, as PIL's
    ``Image.open(...).convert("RGB")``."""
    header = None
    palette = None
    idat: List[bytes] = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            if len(body) != 13:
                raise ValueError("corrupt PNG: IHDR is not 13 bytes")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            if len(body) % 3 or not body:
                raise ValueError("corrupt PNG: PLTE length is not 3N")
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind != b"IEND" and kind[:1].isupper() and kind != b"tRNS":
            raise ValueError(f"PNG: unknown critical chunk {kind!r}")
    if header is None or not idat:
        raise ValueError("corrupt PNG: no IHDR or no IDAT")
    width, height, depth, ctype, comp, filt, interlace = header
    if ctype not in _DEPTHS or depth not in _DEPTHS[ctype]:
        raise ValueError(f"PNG: bad colour type {ctype} / depth {depth}")
    if comp or filt or interlace > 1 or not width or not height:
        raise ValueError(f"PNG: bad IHDR {header}")
    if ctype == 3 and palette is None:
        raise ValueError("corrupt PNG: palette image without PLTE")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"corrupt PNG: IDAT does not inflate: {e}") from e
    channels = _CHANNELS[ctype]
    bpp = max(1, channels * depth // 8)
    if interlace:
        samples = np.zeros((height, width, channels),
                           np.uint16 if depth == 16 else np.uint8)
        pos = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = -(-(width - x0) // dx), -(-(height - y0) // dy)
            if pw <= 0 or ph <= 0:
                continue
            rows, pos = _unfilter(raw, pos, ph, -(-pw * channels * depth // 8),
                                  bpp)
            samples[y0::dy, x0::dx] = _samples(rows, pw, channels, depth)
    else:
        rows, _ = _unfilter(raw, 0, height, -(-width * channels * depth // 8),
                            bpp)
        samples = _samples(rows, width, channels, depth)
    return _to_rgb(samples, ctype, depth, palette)


def _to_rgb(samples: np.ndarray, ctype: int, depth: int,
            palette) -> np.ndarray:
    if ctype == 3:
        idx = samples[..., 0]
        if idx.max(initial=0) >= len(palette):
            raise ValueError(f"corrupt PNG: palette index {int(idx.max())} "
                             f"past a {len(palette)}-entry PLTE")
        return to_rgb("P", idx, palette)
    if ctype == 0:
        if depth == 16:     # I;16: clipped, not scaled
            return to_rgb("I;16", samples[..., 0])
        return to_rgb("L", samples[..., 0] * np.uint8(_GRAY_STRETCH[depth]))
    # RGB;16B, RGBA;16B and LA;16B keep each sample's high byte
    s8 = (samples >> 8).astype(np.uint8) if depth == 16 else samples
    return to_rgb({2: "RGB", 4: "LA", 6: "RGBA"}[ctype], s8)
