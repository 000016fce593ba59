"""TIFF decoder in numpy and ``zlib``: the first image of what PIL's
``TiffImagePlugin`` opens, decoded as ``Image.open(...).convert("RGB")``
gives it.

* Containers: ``II``/``MM``, classic and BigTIFF, the first IFD only,
  strips or tiles, ``PlanarConfiguration`` 1 and 2, an IFD that ends
  early read as far as it goes (as PIL reads it).
* Modes by PIL's ``OPEN_INFO`` table, keyed on byte order, photometric,
  sample format, fill order, bits per sample and extra samples: bilevel,
  grey 2/4/8/16/32-bit and float, MinIsWhite, grey+alpha, RGB 8/16 with
  extra samples (unassociated alpha, or associated alpha unpremultiplied
  as Pillow's ``RGBa`` unpacker does), palette 1-8 bits, CMYK 8/16. A key
  PIL does not know passes the bytes on.
* Uncompressed files go through Pillow's raw decoder as PIL sets its
  tiles up: ``FillOrder`` 2 reverses the bits of each byte, a tile that
  reaches past the right edge is read at its full width, a predictor is
  ignored, and planar layers are unpacked with the single letter of the
  raw mode (R, G, B, A, C, M, Y, K: eight bits a sample, whatever the
  file's depth).
* Compressed files go through libtiff as Pillow's decoder drives it:
  PackBits, LZW (most significant bit first, early change) and Deflate
  (8 and 32946) through ``zlib``, a strip or tile at a time; for LZW and
  Deflate, predictor 2 (horizontal differencing at 8, 16 or 32 bits) and
  3 (floating point: bytes summed across the row, then gathered from
  their planes), PackBits taking no predictor;
  samples of 16 bits and more come out in the host's (little-endian)
  order, and are then read with PIL's raw mode, whose byte order may not
  be the host's (PIL's own result for big-endian 32-bit files); planar
  layers of 8 or 16 bits are copied band by band (16: the high byte),
  associated alpha left as it is; ``FillOrder`` 2 reverses the bits of
  the compressed bytes.
* The ``Orientation`` tag transposes the image (PIL's ``exif_transpose``).

Refused with :class:`NotPortedError`, naming the tag value: the
compressions CCITT (2, 3, 4), JPEG (6, 7), ThunderScan, SGILog, LZMA,
ZSTD and WebP, old-style (LSB-first) LZW, and the photometric
interpretations YCbCr (6) and CIELab (8), and 12-bit grey. Data that
ends early or does not decompress fails with ``ValueError``.
"""
from __future__ import annotations

import struct
import zlib
from typing import Dict, Tuple

import numpy as np

from ..pipeline.element import NotPortedError
from .base import NotThisFormat, Opened, raw_rows, unpack_bits
from .modes import to_rgb

PREFIXES = (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a",
            b"MM\x00\x2b", b"II\x2b\x00")
COMPRESSIONS = {1: "raw", 2: "tiff_ccitt", 3: "group3", 4: "group4",
                5: "tiff_lzw", 6: "tiff_jpeg", 7: "jpeg",
                8: "tiff_adobe_deflate", 32771: "tiff_raw_16",
                32773: "packbits", 32809: "tiff_thunderscan",
                32946: "tiff_deflate", 34676: "tiff_sgilog",
                34677: "tiff_sgilog24", 34925: "lzma", 50000: "zstd",
                50001: "webp"}
_PORTED = {1, 5, 8, 32773, 32946}
# tag -> (unit size, struct code) of each TIFF field type
_TYPES = {1: (1, "B"), 2: (1, "B"), 3: (2, "H"), 4: (4, "I"), 5: (8, "II"),
          6: (1, "b"), 7: (1, "B"), 8: (2, "h"), 9: (4, "i"), 10: (8, "ii"),
          11: (4, "f"), 12: (8, "d"), 13: (4, "I"), 16: (8, "Q"),
          17: (8, "q"), 18: (8, "Q")}
_SCALAR = {256, 257, 259, 262, 266, 274, 277, 278, 284, 317, 322, 323}
WIDTH, LENGTH, BPS, COMPRESSION, PHOTOMETRIC, FILLORDER = \
    256, 257, 258, 259, 262, 266
STRIPOFFSETS, ORIENTATION, SPP, ROWSPERSTRIP, STRIPBYTECOUNTS = \
    273, 274, 277, 278, 279
PLANAR, PREDICTOR, COLORMAP, TILEWIDTH, TILELENGTH = 284, 317, 320, 322, 323
TILEOFFSETS, TILEBYTECOUNTS, EXTRASAMPLES, SAMPLEFORMAT = 324, 325, 338, 339


def _open_info() -> Dict[tuple, Tuple[str, str]]:
    """PIL's ``TiffImagePlugin.OPEN_INFO``, both byte orders."""
    rows = [
        (0, (1,), 1, (1,),
        (), "1", "1;I"), (0, (1,), 2, (1,), (), "1", "1;IR"),
        (1, (1,), 1, (1,), (), "1", "1"), (1, (1,), 2, (1,), (), "1", "1;R"),
        (0, (1,), 1, (2,), (), "L", "L;2I"),
        (0, (1,), 2, (2,), (), "L", "L;2IR"),
        (1, (1,), 1, (2,),
        (), "L", "L;2"), (1, (1,), 2, (2,), (), "L", "L;2R"),
        (0, (1,), 1, (4,), (), "L", "L;4I"),
        (0, (1,), 2, (4,), (), "L", "L;4IR"),
        (1, (1,), 1, (4,),
        (), "L", "L;4"), (1, (1,), 2, (4,), (), "L", "L;4R"),
        (0, (1,), 1, (8,),
        (), "L", "L;I"), (0, (1,), 2, (8,), (), "L", "L;IR"),
        (1, (1,), 1, (8,), (), "L", "L"), (1, (2,), 1, (8,), (), "L", "L"),
        (1, (1,), 2, (8,), (), "L", "L;R"),
        (0, (3,), 1, (32,), (), "F", "F;32F"),
        (1, (3,), 1, (32,), (), "F", "F;32F"),
        (1, (1,), 1, (8, 8), (2,), "LA", "LA"),
        (2, (1,), 1, (8, 8, 8), (), "RGB", "RGB"),
        (2, (1,), 2, (8, 8, 8), (), "RGB", "RGB;R"),
        (2, (1,), 1, (8, 8, 8, 8), (), "RGBA", "RGBA"),
        (2, (1,), 1, (8, 8, 8, 8), (0,), "RGB", "RGBX"),
        (2, (1,), 1, (8, 8, 8, 8, 8), (0, 0), "RGB", "RGBXX"),
        (2, (1,), 1, (8, 8, 8, 8, 8, 8), (0, 0, 0), "RGB", "RGBXXX"),
        (2, (1,), 1, (8, 8, 8, 8), (1,), "RGBA", "RGBa"),
        (2, (1,), 1, (8, 8, 8, 8, 8), (1, 0), "RGBA", "RGBaX"),
        (2, (1,), 1, (8, 8, 8, 8, 8, 8), (1, 0, 0), "RGBA", "RGBaXX"),
        (2, (1,), 1, (8, 8, 8, 8), (2,), "RGBA", "RGBA"),
        (2, (1,), 1, (8, 8, 8, 8, 8), (2, 0), "RGBA", "RGBAX"),
        (2, (1,), 1, (8, 8, 8, 8, 8, 8), (2, 0, 0), "RGBA", "RGBAXX"),
        (2, (1,), 1, (8, 8, 8, 8), (999,), "RGBA", "RGBA"),
        (3, (1,), 1, (1,),
        (), "P", "P;1"), (3, (1,), 2, (1,), (), "P", "P;1R"),
        (3, (1,), 1, (2,),
        (), "P", "P;2"), (3, (1,), 2, (2,), (), "P", "P;2R"),
        (3, (1,), 1, (4,),
        (), "P", "P;4"), (3, (1,), 2, (4,), (), "P", "P;4R"),
        (3, (1,), 1, (8,),
        (), "P", "P"), (3, (1,), 1, (8, 8), (0,), "P", "PX"),
        (3, (1,), 1, (8, 8), (2,), "PA", "PA"),
        (3, (1,), 2, (8,), (), "P", "P;R"),
        (5, (1,), 1, (8, 8, 8, 8), (), "CMYK", "CMYK"),
        (5, (1,), 1, (8, 8, 8, 8, 8), (0,), "CMYK", "CMYKX"),
        (5, (1,), 1, (8, 8, 8, 8, 8, 8), (0, 0), "CMYK", "CMYKXX"),
        (6, (1,), 1, (8,), (), "L", "L"),
        (6, (1,), 1, (8, 8, 8), (), "RGB", "RGBX"),
        (8, (1,), 1, (8, 8, 8), (), "LAB", "LAB"),
    ]
    table = {}
    for prefix in (b"II", b"MM"):
        for photo, fmt, fill, bps, extra, mode, raw in rows:
            table[(prefix, photo, fmt, fill, bps, extra)] = (mode, raw)
    for prefix, e in ((b"II", "L"), (b"MM", "B")):
        for extra, mode, raw in (((), "RGB", "RGB"), ((), "RGBA", "RGBA"),
                                 ((0,), "RGB", "RGBX"), ((1,), "RGBA", "RGBa"),
                                 ((2,), "RGBA", "RGBA")):
            n = 3 + len(extra) + (mode == "RGBA" and not extra)
            table[(prefix, 2, (1,), 1, (16,) * n, extra)] = (mode,
                                                            f"{raw};16{e}")
        table[(prefix, 5, (1,), 1, (16,) * 4, ())] = ("CMYK", f"CMYK;16{e}")
        table[(prefix, 0, (3,), 1, (32,), ())] = ("F", "F;32F" if e == "L"
                                                  else "F;32BF")
        table[(prefix, 1, (3,), 1, (32,), ())] = ("F", "F;32F" if e == "L"
                                                  else "F;32BF")
        table[(prefix, 1, (2,), 1, (16,), ())] = ("I", "I;16S" if e == "L"
                                                  else "I;16BS")
        table[(prefix, 1, (2,), 1, (32,), ())] = ("I", "I;32S" if e == "L"
                                                  else "I;32BS")
    ii = b"II"
    table[(ii, 1, (1,), 1, (12,), ())] = ("I;16", "I;12")
    table[(ii, 0, (1,), 1, (16,), ())] = ("I;16", "I;16")
    table[(ii, 1, (1,), 1, (16,), ())] = ("I;16", "I;16")
    table[(b"MM", 1, (1,), 1, (16,), ())] = ("I;16B", "I;16B")
    table[(ii, 1, (1,), 2, (16,), ())] = ("I;16", "I;16R")
    table[(ii, 1, (1,), 1, (32,), ())] = ("I", "I;32N")
    return table


OPEN_INFO = _open_info()
_REVERSE = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _bits_of(rawmode: str) -> int:
    """Bits a pixel of Pillow's unpacker ``rawmode``."""
    base = rawmode.split(";")[0]
    if rawmode in ("1", "1;I", "1;R", "1;IR", "P;1", "P;1R"):
        return 1
    for tag, bits in ((";2", 2), (";4", 4)):
        if rawmode.endswith((tag, tag + "I", tag + "R", tag + "IR")) and \
                rawmode.startswith(("L", "P")):
            return bits
    if ";16" in rawmode or rawmode.startswith("I;16"):
        return 16 * (len(base) if base not in ("I",) else 1)
    if rawmode.startswith(("I;32", "F;32")):
        return 32
    if rawmode == "I;12":
        return 12
    return 8 * len(base)


def unpack(rawmode: str, rows: np.ndarray, width: int):
    """Pillow's unpacker ``rawmode`` over (H, row bytes) uint8 rows ->
    (mode, samples) as ``modes.to_rgb`` takes them."""
    h = rows.shape[0]
    base, _, tail = rawmode.partition(";")
    if tail.endswith("R") and tail not in ("16R",) or rawmode in ("1;R",
                                                                 "1;IR"):
        if rawmode in ("P;1R", "P;2R", "P;4R"):
            raise ValueError(f"TIFF: unknown raw mode {rawmode} (PIL has "
                             "no such unpacker)")
        rows = _REVERSE[rows]
        tail = tail[:-1]
    if rawmode == "I;16R":
        rows, tail = _REVERSE[rows], "16"
    inv = tail.endswith("I") or tail == "I"
    if base in ("1", "L", "P") and tail.rstrip("I") in ("", "1", "2", "4"):
        bits = int(tail.rstrip("I") or (1 if base == "1" else 8))
        v = rows[:, :width] if bits == 8 else unpack_bits(rows, width, bits)
        if base == "1":
            v = np.where(v != 0, 255, 0).astype(np.uint8)
            return "1", (255 - v) if inv else v
        if base == "L":
            v = v * np.uint8({1: 255, 2: 85, 4: 17, 8: 1}[bits])
            return "L", (255 - v) if inv else v
        return "P", v
    if base == "I" or base == "F":
        dt = {"16": "<u2", "16N": "<u2", "16B": ">u2", "16S": "<i2",
              "16BS": ">i2", "32N": "<i4", "32S": "<i4", "32BS": ">i4",
              "32F": "<f4", "32BF": ">f4"}.get(tail)
        if tail == "12":
            raise NotPortedError("TIFF 12-bit grey (raw mode I;12) is not "
                                 "ported")
        if dt is None:
            raise ValueError(f"TIFF: unknown raw mode {rawmode}")
        n = int(dt[2:]) * width
        v = rows[:, :n].copy().view(dt).reshape(h, width)
        return ("F" if base == "F" else "I"), v
    wide = tail.startswith("16")
    chans = base
    size = 2 if wide else 1
    px = rows[:, :len(chans) * size * width].reshape(h, width,
                                                     len(chans) * size)
    if wide:
        hi = 0 if tail == "16B" else 1
        px = px[..., hi::2]
    keep = [i for i, c in enumerate(chans) if c != "X"]
    px = px[..., keep]
    kept = "".join(c for c in chans if c != "X")
    if kept == "RGBa":
        c = px[..., :3].astype(np.int64)
        a = px[..., 3:].astype(np.int64)
        rgb = np.where(a == 0, 0, np.minimum(255, c * 255 // np.maximum(a,
                                                                       1)))
        return "RGB", rgb.astype(np.uint8)
    mode = {"RGB": "RGB", "RGBA": "RGBA", "LA": "LA", "P": "P", "PA": "PA",
            "CMYK": "CMYK"}.get(kept)
    if mode is None:
        raise ValueError(f"TIFF: unknown raw mode {rawmode}")
    return mode, (px[..., 0] if mode == "P" else px)


class _Ifd:
    """ImageFileDirectory_v2.load over the first IFD."""

    def __init__(self, data, big: bool, endian: str, pos: int):
        self.tags: Dict[int, tuple] = {}
        e, n = endian, len(data)
        try:
            if big:
                if pos + 8 > n:
                    raise EOFError
                (count,) = struct.unpack_from(e + "Q", data, pos)
                pos += 8
            else:
                if pos + 2 > n:
                    raise EOFError
                (count,) = struct.unpack_from(e + "H", data, pos)
                pos += 2
            entry = 20 if big else 12
            inline = 8 if big else 4
            for _ in range(count):
                if pos + entry > n:
                    raise EOFError
                if big:
                    tag, typ, cnt = struct.unpack_from(e + "HHQ", data, pos)
                    raw = bytes(data[pos + 12:pos + 20])
                else:
                    tag, typ, cnt = struct.unpack_from(e + "HHI", data, pos)
                    raw = bytes(data[pos + 8:pos + 12])
                pos += entry
                if typ not in _TYPES:
                    continue
                unit, code = _TYPES[typ]
                size = cnt * unit
                if size > inline:
                    (off,) = struct.unpack_from(e + ("Q" if big else "I"),
                                                raw, 0)
                    if off + size > n:
                        raise EOFError
                    raw = bytes(data[off:off + size])
                else:
                    raw = raw[:size]
                if not raw:
                    continue
                vals = struct.unpack(e + code * cnt, raw)
                if typ in (5, 10):
                    vals = tuple(a / b if b else float("nan")
                                 for a, b in zip(vals[::2], vals[1::2]))
                self.tags[tag] = vals
        except EOFError:
            pass

    def get(self, tag, default=None):
        v = self.tags.get(tag)
        if v is None:
            return default
        return v[0] if tag in _SCALAR else v


def _lzw(src: bytes, need: int) -> bytes:
    """libtiff LZWDecode: codes most significant bit first, 9 to 12 bits,
    the width growing one code early; clear 256, end 257."""
    if len(src) >= 2 and src[0] == 0 and src[1] & 1:
        raise NotPortedError("TIFF: old-style (LSB-first) LZW is not ported")
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    out = bytearray()
    size, nxt, prev = 9, 258, None
    buf = src + b"\0\0\0"
    total = len(src) * 8
    p = 0
    while len(out) < need:
        if p + size > total:
            break
        q = p >> 3
        code = ((buf[q] << 16 | buf[q + 1] << 8 | buf[q + 2]) >>
                (24 - size - (p & 7))) & ((1 << size) - 1)
        p += size
        if code == 256:
            del table[258:]
            size, nxt, prev = 9, 258, None
            continue
        if code == 257:
            break
        if prev is None:
            if code > 255:
                raise ValueError("TIFF LZW: corrupted table (a code past a "
                                 "clear)")
            entry = table[code]
        elif code < nxt:
            entry = table[code]
            table.append(prev + entry[:1])
            nxt += 1
        elif code == nxt:
            entry = prev + prev[:1]
            table.append(entry)
            nxt += 1
        else:
            raise ValueError(f"TIFF LZW: corrupted table (code {code} past "
                             f"{nxt} entries)")
        if nxt >= 4096:
            raise ValueError("TIFF LZW: the table overflows without a clear")
        if nxt == (1 << size) - 1 and size < 12:
            size += 1
        out += entry
        prev = entry
    if len(out) < need:
        raise ValueError(f"TIFF LZW: not enough data ({len(out)} of {need} "
                         "bytes)")
    return bytes(out[:need])


def _packbits(src: bytes, need: int) -> bytes:
    out = bytearray()
    i, n = 0, len(src)
    while len(out) < need and i < n:
        c = src[i]
        i += 1
        if c < 128:
            out += src[i:i + c + 1]
            i += c + 1
        elif c > 128:
            if i >= n:
                break
            out += bytes([src[i]]) * (257 - c)
            i += 1
    if len(out) < need:
        raise ValueError(f"TIFF PackBits: not enough data ({len(out)} of "
                         f"{need} bytes)")
    return bytes(out[:need])


def _inflate(src: bytes, need: int) -> bytes:
    try:
        out = zlib.decompressobj().decompress(src)
    except zlib.error as e:
        raise ValueError(f"TIFF Deflate: {e}") from e
    if len(out) < need:
        raise ValueError(f"TIFF Deflate: not enough data ({len(out)} of "
                         f"{need} bytes)")
    return out[:need]


def _native(block: np.ndarray, bps: int, big: bool) -> np.ndarray:
    """libtiff's post-decode swab: multi-byte samples to the host's
    (little-endian) order."""
    if not big or bps not in (16, 32, 64):
        return block
    k = bps // 8
    return block.reshape(block.shape[0], -1, k)[..., ::-1].reshape(
        block.shape)


def _predict(block: np.ndarray, predictor: int, bps: int, spp: int,
             fmt: int) -> np.ndarray:
    """libtiff's predictor decode over native-order rows (H, row bytes)."""
    if predictor == 2:
        if bps not in (8, 16, 32):
            raise ValueError(f"TIFF: horizontal differencing of {bps}-bit "
                             "samples (libtiff refuses it)")
        dt = {8: np.uint8, 16: "<u2", 32: "<u4"}[bps]
        v = block.copy().view(dt).reshape(block.shape[0], -1, spp)
        v = np.cumsum(v, axis=1, dtype=v.dtype)
        return v.reshape(block.shape[0], -1).view(np.uint8)
    if predictor == 3:
        if fmt != 3 or bps not in (16, 24, 32, 64):
            raise ValueError("TIFF: the floating-point predictor on "
                             "non-float samples")
        h, n = block.shape
        k = bps // 8
        acc = block.reshape(h, -1, spp).cumsum(axis=1, dtype=np.uint8)
        acc = acc.reshape(h, k, n // k)
        return np.ascontiguousarray(acc.transpose(0, 2, 1)[..., ::-1]) \
            .reshape(h, n)
    return block


def _transpose(img: np.ndarray, orientation) -> np.ndarray:
    return {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1],
            4: lambda a: a[::-1], 5: lambda a: a.swapaxes(0, 1),
            6: lambda a: np.rot90(a, -1), 7: lambda a: np.rot90(a, -1)[::-1],
            8: lambda a: np.rot90(a, 1)}.get(orientation, lambda a: a)(img)


def open_tiff(data) -> Opened:
    head = bytes(data[:16])
    if not head.startswith(PREFIXES):
        raise NotThisFormat("not a TIFF file")
    endian = "<" if head.startswith(b"II") else ">"
    big = head[2] == 43
    (first,) = struct.unpack_from(endian + ("Q" if big else "I"), head,
                                  8 if big else 4)
    ifd = _Ifd(data, big, endian, first)
    if 0xBC01 in ifd.tags:
        raise ValueError("TIFF: Windows Media Photo files not yet supported")
    comp_tag = ifd.get(COMPRESSION, 1)
    if comp_tag not in COMPRESSIONS:
        raise NotThisFormat(f"TIFF: unknown compression {comp_tag} (PIL's "
                            "KeyError passes the bytes on)")
    planar = ifd.get(PLANAR, 1)
    photo = ifd.get(PHOTOMETRIC, 0)
    if comp_tag == 6:
        photo = 6
    fill = ifd.get(FILLORDER, 1)
    xsize, ysize = ifd.get(WIDTH), ifd.get(LENGTH)
    if xsize is None or ysize is None:
        raise NotThisFormat("TIFF: missing dimensions")
    if not isinstance(xsize, int) or not isinstance(ysize, int):
        raise ValueError("TIFF: invalid dimensions")
    fmt = ifd.get(SAMPLEFORMAT, (1,))
    if len(fmt) > 1 and max(fmt) == min(fmt) == 1:
        fmt = (1,)
    bps = ifd.get(BPS, (1,))
    extra = ifd.get(EXTRASAMPLES, ())
    bps_count = (3 if photo in (2, 6, 8) else 4 if photo == 5 else 1) + \
        len(extra)
    spp = ifd.get(SPP, 3 if comp_tag == 6 and photo in (2, 6) else 1)
    if spp > 6:
        raise NotThisFormat("TIFF: invalid value for samples per pixel")
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) and len(bps) == 1:
        bps = bps * spp
    if len(bps) != spp:
        raise NotThisFormat("TIFF: unknown data organization")
    prefix = head[:2]
    key = (prefix, photo, tuple(fmt), fill, tuple(bps), tuple(extra))
    if key not in OPEN_INFO:
        raise NotThisFormat(f"TIFF: unknown pixel mode {key[1:]}")
    mode, rawmode = OPEN_INFO[key]
    compressed = comp_tag != 1
    if compressed and fill == 2:
        mode, rawmode = OPEN_INFO[key[:3] + (1,) + key[4:]]
    if compressed:
        if rawmode == "I;16" or rawmode.endswith((";16B", ";16L")):
            rawmode = rawmode[:-1] + "N" if rawmode != "I;16" else "I;16N"
    elif STRIPOFFSETS not in ifd.tags and TILEOFFSETS not in ifd.tags:
        raise NotThisFormat("TIFF: unknown data organization")
    tiled = TILEOFFSETS in ifd.tags
    if not compressed and tiled:
        tw, th = ifd.get(TILEWIDTH), ifd.get(TILELENGTH)
        if not isinstance(tw, int) or not isinstance(th, int):
            raise ValueError("TIFF: invalid tile dimensions")
    palette = None
    if mode in ("P", "PA"):
        cmap = ifd.get(COLORMAP)
        if cmap is None:
            raise ValueError("TIFF: a palette image without a ColorMap")
        c = np.array(cmap, np.int64) // 256
        n3 = len(c) // 3
        palette = np.stack([c[:n3], c[n3:2 * n3], c[2 * n3:3 * n3]],
                           -1).astype(np.uint8)
    ctx = dict(data=data, ifd=ifd, mode=mode, rawmode=rawmode, comp=comp_tag,
               planar=planar, photo=photo, xsize=xsize, ysize=ysize,
               bps=tuple(bps), spp=spp, fmt=tuple(fmt), fill=fill, big=big,
               endian=endian, bps_count=bps_count, tiled=tiled)

    def decode():
        if comp_tag not in _PORTED:
            raise NotPortedError(f"TIFF compression {comp_tag} "
                                 f"({COMPRESSIONS[comp_tag]}) is not ported")
        if photo in (6, 8):
            raise NotPortedError(f"TIFF photometric interpretation {photo} "
                                 f"({'YCbCr' if photo == 6 else 'CIELab'}) "
                                 "is not ported")
        m, s = (_libtiff if compressed else _raw)(ctx)
        s = _transpose(s, ifd.get(ORIENTATION))
        return to_rgb(m, s, palette)

    size = (ysize, xsize) if ifd.get(ORIENTATION) in (5, 6, 7, 8) \
        else (xsize, ysize)
    return Opened("TIFF", decode, size)


def _raw(c):
    """Pillow's raw decoder over the tiles ``_setup`` lays out."""
    ifd, data = c["ifd"], c["data"]
    xs, ys = c["xsize"], c["ysize"]
    if STRIPOFFSETS in ifd.tags:
        offsets = ifd.get(STRIPOFFSETS)
        w, h = xs, ifd.get(ROWSPERSTRIP, ys)
    else:
        offsets = ifd.get(TILEOFFSETS)
        w, h = ifd.get(TILEWIDTH), ifd.get(TILELENGTH)
    if w == xs and h == ys and c["planar"] != 2:
        offsets = offsets[-1:]
    mode_out, canvas = None, None
    x = y = layer = 0
    for off in offsets:
        stride = w * sum(c["bps"]) / 8 if x + w > xs else 0
        raw = c["rawmode"]
        if c["planar"] == 2:
            if layer >= len(raw):
                raise ValueError("TIFF: more planar layers than raw mode "
                                 "letters")
            raw = raw[layer]
            stride /= c["bps_count"]
        x1, y1 = min(x + w, xs), min(y + h, ys)
        tw, th = x1 - x, y1 - y
        row_bytes = (_bits_of(raw) * tw + 7) // 8
        if c["planar"] == 2 and c["mode"] != "P" and len(c["mode"]) > 1:
            band = _band(c["mode"], raw)
            rows = raw_rows(data, off, th, row_bytes, int(stride) or
                            row_bytes, "TIFF")
            if canvas is None:
                canvas = np.zeros((ys, xs, _nbands(c["mode"])), np.uint8)
            canvas[y:y1, x:x1, band] = rows[:, :tw]
            mode_out = c["mode"]
        else:
            rows = raw_rows(data, off, th, row_bytes, int(stride) or
                            row_bytes, "TIFF")
            m, s = unpack(raw, rows, tw)
            if canvas is None:
                canvas = np.zeros((ys, xs) + s.shape[2:], s.dtype)
            canvas[y:y1, x:x1] = s
            mode_out = m
        x += w
        if x >= xs:
            x, y = 0, y + h
            if y >= ys:
                y, layer = 0, layer + 1
    if canvas is None:
        raise ValueError("TIFF: no strips or tiles")
    return mode_out, canvas


def _nbands(mode: str) -> int:
    return {"RGB": 3, "RGBA": 4, "CMYK": 4, "LA": 2, "PA": 2}[mode]


def _band(mode: str, letter: str) -> int:
    bands = {"RGB": "RGB", "RGBA": "RGBA", "CMYK": "CMYK"}.get(mode, "")
    if letter not in bands:
        raise ValueError(f"TIFF: unknown raw mode {letter} for mode {mode}")
    return bands.index(letter)


def _chunks(c, count_tag, offset_tag):
    ifd = c["ifd"]
    offs, counts = ifd.get(offset_tag), ifd.get(count_tag)
    if offs is None or counts is None:
        raise ValueError("TIFF: no strip or tile byte counts for libtiff")
    return offs, counts


def _decompress(c, src: bytes, need: int) -> bytes:
    if c["fill"] == 2:
        src = _REVERSE[np.frombuffer(src, np.uint8)].tobytes()
    comp = c["comp"]
    if comp == 5:
        return _lzw(src, need)
    if comp in (8, 32946):
        return _inflate(src, need)
    if comp == 32773:
        return _packbits(src, need)
    return src


def _libtiff(c):
    """libtiff's strip and tile reads, then Pillow's unpackers."""
    data, ifd = c["data"], c["ifd"]
    xs, ys, bps, spp = c["xsize"], c["ysize"], c["bps"][0], c["spp"]
    planar2 = c["planar"] == 2 and spp > 1
    per = 1 if planar2 else spp
    if c["tiled"]:
        tw, th = ifd.get(TILEWIDTH), ifd.get(TILELENGTH)
        offs, counts = _chunks(c, TILEBYTECOUNTS, TILEOFFSETS)
    else:
        tw, th = xs, min(ifd.get(ROWSPERSTRIP, ys), ys) or ys
        offs, counts = _chunks(c, STRIPBYTECOUNTS, STRIPOFFSETS)
    row = (tw * per * bps + 7) // 8
    across, down = -(-xs // tw), -(-ys // th)
    planes = spp if planar2 else 1

    def plane(p):
        out = np.zeros((down * th, across * row), np.uint8)
        for j in range(down):
            for i in range(across):
                k = p * across * down + j * across + i
                if k >= len(offs):
                    raise ValueError("TIFF: fewer strips or tiles than the "
                                     "image needs")
                rows = th if c["tiled"] else min(th, ys - j * th)
                src = bytes(data[offs[k]:offs[k] + counts[k]])
                blk = np.frombuffer(_decompress(c, src, rows * row),
                                    np.uint8).reshape(rows, row)
                # libtiff's PackBits codec knows no predictor
                pred = ifd.get(PREDICTOR, 1) if c["comp"] != 32773 else 1
                if pred != 3:   # the float predictor leaves host order
                    blk = _native(blk, bps, c["endian"] == ">")
                blk = _predict(blk, pred, bps, per, c["fmt"][0])
                out[j * th:j * th + rows, i * row:(i + 1) * row] = blk
        if c["tiled"]:      # tiles side by side -> rows of the image
            out = out.reshape(down * th, across, row)
        return out

    if planar2:
        if bps not in (8, 16):
            raise ValueError(f"TIFF: {bps}-bit planar samples (Pillow's "
                             "decoder refuses them)")
        nb = _nbands(c["mode"]) if len(c["mode"]) > 1 else 1
        bands = []
        for p in range(nb):
            pl = plane(p).reshape(down * th, -1)
            if bps == 16:
                pl = pl[:, 1::2]
            bands.append(pl[:ys, :xs])
        s = np.stack(bands, -1)
        m = c["mode"]
        if m in ("LA", "PA"):
            m, s = ("L" if m == "LA" else "P"), s[..., 0]
        return m, s
    img = plane(0)
    if c["tiled"]:
        # each tile row holds ``row`` bytes of ``tw`` pixels: unpack per tile
        tiles = [unpack(c["rawmode"], img[:, i, :], tw) for i in range(across)]
        m = tiles[0][0]
        s = np.concatenate([t[1] for t in tiles], axis=1)[:ys, :xs]
        return m, s
    m, s = unpack(c["rawmode"], img[:ys], xs)
    return m, s
