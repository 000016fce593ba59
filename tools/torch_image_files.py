"""Image files for the media elements' tests, written in-process.

Neither package ships a PNG or JPEG fixture, so this module writes them:
PNGs in every colour type, bit depth, filter strategy and interlace
mode of the PNG specification, and JPEGs (integer forward DCT, the
standard quantization tables scaled by a quality): baseline with the
standard Huffman tables, or progressive (libjpeg's simple progression
or any scan script of DC first/refine and AC first/refine scans, each
scan with its own optimal Huffman tables), either of them
arithmetic-coded instead (the QM coder of jcarith.c), or lossless
(predictors 1-7, a point transform); grey, YCbCr, RGB-stored,
CMYK or YCCK, with or without the JFIF and Adobe APP14 markers; any
integral sampling factors (4:4:4, 4:2:2, 4:2:0, 4:4:0 i.e. h1v2, 4:1:1
i.e. h4v1, or per component); optional restart intervals; and a
progressive file cut after its first scans (``jpeg_prefix``). It uses
the standard library (``zlib``, ``struct``) and numpy only and imports
neither ``nnstreamer_tpu`` nor ``nnstreamer_tpu_torch``, so the
packages' decoders are checked against an independent writer.

Pictures come from ``np.random.default_rng(seed)`` as smooth fields plus
noise: a coarse grid of random levels interpolated across the frame,
with a few levels of noise on every sample. Every step is integer
arithmetic over the generator's raw bytes, so a seed gives the same file
on every machine and numpy version that keeps the PCG64 bit stream.

Use::

    python3 tools/torch_image_files.py OUT_DIR [--count 16] [--width 320]
        [--height 240] [--format png|jpeg] [--seed 0]

or ``write_png_series``/``write_jpeg_series``, ``png_bytes``,
``jpeg_bytes``, ``jpeg_prefix`` and ``smooth_image`` after loading this
file by path
(``importlib.util.spec_from_file_location``).
"""
from __future__ import annotations

import argparse
import os
import re
import struct
import zlib
from typing import List, Optional, Sequence

import numpy as np

# ---------------------------------------------------------------------------
# pictures
# ---------------------------------------------------------------------------


def _raw(rng, *shape) -> np.ndarray:
    n = int(np.prod(shape))
    return np.frombuffer(rng.bytes(n), np.uint8).reshape(shape).astype(
        np.int64)


def smooth_image(seed: int, height: int, width: int, channels: int = 3,
                 depth: int = 8, grid: int = 5, noise: int = 12) -> np.ndarray:
    """(H, W, C) int64 samples in [0, 2**depth): a ``grid`` x ``grid``
    field of random levels, interpolated bilinearly in 8.8 fixed point,
    plus uniform noise of +-``noise`` levels (at 8 bits)."""
    rng = np.random.default_rng(seed)
    g = _raw(rng, grid, grid, channels)
    ys = np.arange(height) * (grid - 1) * 256 // max(height - 1, 1)
    xs = np.arange(width) * (grid - 1) * 256 // max(width - 1, 1)
    y0, fy = ys >> 8, (ys & 255)[:, None, None]
    x0, fx = xs >> 8, (xs & 255)[None, :, None]
    y1, x1 = np.minimum(y0 + 1, grid - 1), np.minimum(x0 + 1, grid - 1)
    top = g[y0][:, x0] * (256 - fx) + g[y0][:, x1] * fx
    bot = g[y1][:, x0] * (256 - fx) + g[y1][:, x1] * fx
    field = (top * (256 - fy) + bot * fy) >> 16
    jitter = _raw(rng, height, width, channels) % (2 * noise + 1) - noise
    img = np.clip(field + jitter, 0, 255)
    if depth == 8:
        return img
    if depth == 16:
        return img * 256 + _raw(rng, height, width, channels)
    return img >> (8 - depth)


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
FILTERS = ("none", "sub", "up", "average", "paeth", "mixed")
# Adam7: (x start, y start, x step, y step) of each pass
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def png_cases():
    """Every (colour type, bit depth) the PNG specification allows."""
    return [(ct, d) for ct, ds in _DEPTHS.items() for d in ds]


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _pack_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """(H, W, C) samples -> (H, row bytes) uint8, big-endian, rows
    padded to a byte."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1)
    if depth == 16:
        return flat.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return flat.astype(np.uint8)
    per = 8 // depth
    n = flat.shape[1]
    padded = np.zeros((h, -(-n // per) * per), np.int64)
    padded[:, :n] = flat
    groups = padded.reshape(h, -1, per)
    shifts = (8 - depth * (np.arange(per) + 1))
    return (groups << shifts).sum(-1).astype(np.uint8)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_rows(rows: np.ndarray, bpp: int, strategy: str) -> bytes:
    """Filter each row (a leading filter-type byte, then the bytes)."""
    out = bytearray()
    prior = np.zeros(rows.shape[1], np.int64)
    for r, row in enumerate(rows.astype(np.int64)):
        kind = (FILTERS.index(strategy) if strategy != "mixed"
                else (r * 3 + 1) % 5)
        a = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]]) \
            if len(row) > bpp else np.zeros(len(row), np.int64)
        c = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]]) \
            if len(row) > bpp else np.zeros(len(row), np.int64)
        pred = (0, a, prior, (a + prior) >> 1, _paeth(a, prior, c))[kind]
        out.append(kind)
        out += ((row - pred) & 255).astype(np.uint8).tobytes()
        prior = row
    return bytes(out)


def png_bytes(samples: np.ndarray, color_type: int, depth: int,
              palette: Optional[np.ndarray] = None,
              trns: Optional[Sequence[int]] = None, interlace: bool = False,
              strategy: str = "paeth", idat_chunks: int = 1,
              level: int = 6) -> bytes:
    """A PNG of ``samples`` ((H, W) or (H, W, C) integers in the depth's
    range; palette images: indices) with the colour type and depth
    given; ``palette`` (N, 3) for colour type 3; ``trns`` the raw tRNS
    values (a palette's alphas, or a grey or RGB colour key)."""
    if depth not in _DEPTHS[color_type]:
        raise ValueError(f"depth {depth} is not allowed for colour type "
                         f"{color_type}")
    samples = np.asarray(samples, np.int64)
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w, c = samples.shape
    if c != _CHANNELS[color_type]:
        raise ValueError(f"colour type {color_type} has "
                         f"{_CHANNELS[color_type]} channels, got {c}")
    bpp = max(1, c * depth // 8)
    if interlace:
        raw = b""
        for x0, y0, dx, dy in _ADAM7:
            sub = samples[y0::dy, x0::dx]
            if sub.size:
                raw += _filter_rows(_pack_rows(sub, depth), bpp, strategy)
    else:
        raw = _filter_rows(_pack_rows(samples, depth), bpp, strategy)
    out = [b"\x89PNG\r\n\x1a\n",
           _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color_type,
                                       0, 0, int(interlace)))]
    if color_type == 3:
        out.append(_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes()))
    if trns is not None:
        if color_type == 3:
            data = bytes(int(v) for v in trns)
        else:
            data = b"".join(struct.pack(">H", int(v)) for v in trns)
        out.append(_chunk(b"tRNS", data))
    z = zlib.compress(raw, level)
    step = -(-len(z) // idat_chunks)
    for i in range(0, len(z), step):
        out.append(_chunk(b"IDAT", z[i:i + step]))
    out.append(_chunk(b"IEND", b""))
    return b"".join(out)


def png_case(color_type: int, depth: int, seed: int = 0, height: int = 23,
             width: int = 37, **kw) -> bytes:
    """A seeded picture in the colour type and depth given (palette
    images: a seeded palette of 2**depth colours, tRNS optional through
    ``kw``)."""
    channels = _CHANNELS[color_type]
    if color_type == 3:
        rng = np.random.default_rng(seed + 1)
        palette = _raw(rng, 1 << depth, 3)
        idx = smooth_image(seed, height, width, 1, depth)
        return png_bytes(idx, 3, depth, palette=palette, **kw)
    img = smooth_image(seed, height, width, channels, depth)
    return png_bytes(img, color_type, depth, **kw)


# ---------------------------------------------------------------------------
# JPEG
# ---------------------------------------------------------------------------

# ITU T.81 Annex K: the example quantization tables (natural order) and
# the standard Huffman tables (counts of 1..16-bit codes, then symbols)
_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_Q_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32)
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa"))
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77],
              bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352"
    "f0156272d10a162434e125f11718191a262728292a35363738393a4344454647"
    "48494a535455565758595a636465666768696a737475767778797a8283848586"
    "8788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2"
    "c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7"
    "f8f9fa"))
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
# round(4096 * cos(k * pi / 16)), k = 0..8: integers, so the DCT below is
# exact integer arithmetic on every machine
_COS = [4096, 4017, 3784, 3406, 2896, 2276, 1567, 799, 0]
SUBSAMPLING = {"444": (1, 1), "422": (2, 1), "420": (2, 2), "440": (1, 2),
               "411": (4, 1)}


def _cos_matrix() -> np.ndarray:
    m = np.zeros((8, 8), np.int64)
    for u in range(8):
        for x in range(8):
            k = ((2 * x + 1) * u) % 32
            sign = 1
            if k > 16:
                k = 32 - k
            if k > 8:
                k, sign = 16 - k, -1
            m[u, x] = sign * _COS[k]
    return m


def quant_tables(quality: int):
    """The IJG scaling of the Annex K tables to ``quality`` (1-100)."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return [np.clip((t * scale + 50) // 100, 1, 255)
            for t in (_Q_LUMA, _Q_CHROMA)]


def _fdct_quant(blocks: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """(N, 8, 8) level-shifted samples -> (N, 64) quantized coefficients
    in zigzag order."""
    m = _cos_matrix()
    s = np.einsum("ux,nyx,vy->nvu", m, blocks, m)     # scale 2**24
    w = np.full((8, 8), 4096, np.int64)
    w[0, :] = 2896
    w[:, 0] = 2896
    w[0, 0] = 2048
    f = s * w                                         # scale 2**36 * 4
    f = np.where(f >= 0, (f + (1 << 37)) >> 38, -((-f + (1 << 37)) >> 38))
    q = qt.reshape(8, 8)
    coef = np.where(f >= 0, (f + q // 2) // q, -((-f + q // 2) // q))
    return coef.reshape(-1, 64)[:, ZIGZAG]


def _huff_codes(spec):
    counts, symbols = spec
    codes, code, k = {}, 0, 0
    for length, n in enumerate(counts, 1):
        for _ in range(n):
            codes[symbols[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, code: int, length: int) -> None:
        self.acc = (self.acc << length) | code
        self.n += length
        while self.n >= 8:
            self.n -= 8
            b = (self.acc >> self.n) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def flush(self) -> None:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _magnitude(v: int):
    size = int(abs(v)).bit_length()
    return size, (v if v >= 0 else v + (1 << size) - 1)


def _encode_block(bw, coef, pred, dc, ac) -> int:
    diff = int(coef[0]) - pred
    size, bits = _magnitude(diff)
    bw.put(*dc[size])
    if size:
        bw.put(bits, size)
    run = 0
    last = int(np.flatnonzero(coef)[-1]) if np.any(coef[1:]) else 0
    for k in range(1, last + 1):
        v = int(coef[k])
        if v == 0:
            run += 1
            continue
        while run > 15:
            bw.put(*ac[0xF0])
            run -= 16
        size, bits = _magnitude(v)
        bw.put(*ac[(run << 4) | size])
        bw.put(bits, size)
        run = 0
    if last < 63:
        bw.put(*ac[0x00])
    return int(coef[0])


def _to_ycbcr(rgb: np.ndarray) -> np.ndarray:
    """JFIF's RGB -> YCbCr in 16.16 fixed point."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    y = (19595 * r + 38470 * g + 7471 * b + 32768) >> 16
    cb = ((-11059 * r - 21709 * g + 32768 * b + 32767) >> 16) + 128
    cr = ((32768 * r - 27439 * g - 5329 * b + 32767) >> 16) + 128
    return np.clip(np.stack([y, cb, cr], -1), 0, 255)


def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(payload) + 2) + payload


# colour -> (channels of the input, components coded with table 1)
COLORS = {"gray": (1, ()), "ycbcr": (3, (1, 2)), "rgb": (3, ()),
          "cmyk": (4, ()), "ycck": (4, (1, 2))}


def _planes(image: np.ndarray, color: str) -> np.ndarray:
    """(H, W, C) input -> the (H, W, N) component samples to code: YCbCr
    from RGB; YCCK from CMYK as libjpeg's cmyk_ycck_convert makes it
    (YCbCr of 255 - C, 255 - M, 255 - Y; K as it is); the rest as
    given."""
    image = image.reshape(image.shape[:2] + (-1,)).astype(np.int64)
    if image.shape[-1] != COLORS[color][0]:
        raise ValueError(f"colour {color} takes {COLORS[color][0]} "
                         f"channels, got {image.shape[-1]}")
    if color == "ycbcr":
        return _to_ycbcr(image)
    if color == "ycck":
        return np.concatenate([_to_ycbcr(255 - image[..., :3]),
                               image[..., 3:]], -1)
    return image


def simple_progression(ncomp: int, color: str = "ycbcr"):
    """libjpeg's jpeg_simple_progression scan script: (components, Ss,
    Se, Ah, Al) a scan. YCbCr gets its own 10-scan script, every other
    colour space the all-purpose one."""
    comps = tuple(range(ncomp))
    if ncomp == 3 and color == "ycbcr":
        return [(comps, 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1),
                ((1,), 1, 63, 0, 1), ((0,), 6, 63, 0, 2),
                ((0,), 1, 63, 2, 1), (comps, 0, 0, 1, 0),
                ((2,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0),
                ((0,), 1, 63, 1, 0)]
    dc = [(comps, 0, 0, 0, 1)] if ncomp <= 4 else \
        [((c,), 0, 0, 0, 1) for c in comps]
    dc_refine = [(comps, 0, 0, 1, 0)] if ncomp <= 4 else \
        [((c,), 0, 0, 1, 0) for c in comps]
    return (dc + [((c,), 1, 5, 0, 2) for c in comps]
            + [((c,), 6, 63, 0, 2) for c in comps]
            + [((c,), 1, 63, 2, 1) for c in comps] + dc_refine
            + [((c,), 1, 63, 1, 0) for c in comps])


def _optimal_code_lengths(freq) -> tuple:
    """jchuff.c jpeg_gen_optimal_table: (counts of 1..16-bit codes,
    symbols in code order) for a {symbol: count} table, one code point
    reserved so that no code is all ones."""
    f = [0] * 257
    for sym, n in freq.items():
        f[sym] = n
    f[256] = 1
    size, others = [0] * 257, [-1] * 257
    while True:
        live = [i for i in range(257) if f[i]]
        if len(live) < 2:
            break
        live.sort(key=lambda i: (f[i], -i))
        c1, c2 = live[0], live[1]
        f[c1] += f[c2]
        f[c2] = 0
        for c in (c1, c2):
            size[c] += 1
            while others[c] >= 0:
                c = others[c]
                size[c] += 1
        c = c1
        while others[c] >= 0:
            c = others[c]
        others[c] = c2
    bits = [0] * 33
    for i in range(257):
        if size[i]:
            bits[size[i]] += 1
    for i in range(32, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1
    order = sorted((s for s in range(256) if size[s]),
                   key=lambda s: (size[s], s))
    return bits[1:17], bytes(order)


class _Tokens:
    """A scan as Huffman symbols (table key, symbol), raw bits and
    restart markers, kept until the scan's optimal tables are known."""

    def __init__(self):
        self.items = []
        self.freq = {}

    def sym(self, key, symbol: int) -> None:
        self.items.append((0, key, symbol))
        f = self.freq.setdefault(key, {})
        f[symbol] = f.get(symbol, 0) + 1

    def bits(self, value: int, length: int) -> None:
        if length:
            self.items.append((1, value, length))

    def restart(self, n: int) -> None:
        self.items.append((2, n, 0))

    def emit(self, codes) -> bytes:
        bw = _BitWriter()
        for kind, a, b in self.items:
            if kind == 0:
                bw.put(*codes[a][b])
            elif kind == 1:
                bw.put(a, b)
            else:
                bw.flush()
                bw.out += bytes([0xFF, 0xD0 + a % 8])
        bw.flush()
        return bytes(bw.out)


def _scan_units(members, comps, mcux, mcuy):
    """(component, block row, block column) of each block of a scan, a
    list an MCU: one component's real block grid, or whole interleaved
    MCUs."""
    if len(members) == 1:
        c = comps[members[0]]
        return [[(members[0], by, bx)] for by in range(c["gh"])
                for bx in range(c["gw"])]
    return [[(ci, my * comps[ci]["v"] + by, mx * comps[ci]["h"] + bx)
             for ci in members for by in range(comps[ci]["v"])
             for bx in range(comps[ci]["h"])]
            for my in range(mcuy) for mx in range(mcux)]


def _progressive_scan(tok: _Tokens, scan, comps, mcux, mcuy,
                      restart_interval: int) -> None:
    """One scan of a progressive file as tokens, as jcphuff.c codes it:
    DC first (the DC shifted down by Al, differences coded) and refine
    (one bit a block), AC first (magnitudes shifted down by Al, runs of
    empty bands as EOBn symbols) and AC refine (newly non-zero
    coefficients as run/1 symbols, one correction bit for every
    coefficient already non-zero, held until the next symbol)."""
    members, ss, se, ah, al = scan
    units = _scan_units(members, comps, mcux, mcuy)
    state = {"eobrun": 0, "be": [], "preds": {ci: 0 for ci in members}}

    def eob(key):
        run = state["eobrun"]
        if run:
            n = run.bit_length() - 1
            tok.sym(key, n << 4)
            tok.bits(run & ((1 << n) - 1), n)
            state["eobrun"] = 0
            for bit in state["be"]:
                tok.bits(bit, 1)
            state["be"] = []

    key_ac = ("ac", comps[members[0]]["t"])
    for u, unit in enumerate(units):
        if restart_interval and u and u % restart_interval == 0:
            if ss:
                eob(key_ac)
            tok.restart(u // restart_interval - 1)
            state.update(eobrun=0, be=[], preds={ci: 0 for ci in members})
        for ci, by, bx in unit:
            coef = comps[ci]["coef"][by, bx]
            if ss == 0 and ah == 0:
                v = int(coef[0]) >> al
                size, bits = _magnitude(v - state["preds"][ci])
                state["preds"][ci] = v
                tok.sym(("dc", comps[ci]["t"]), size)
                tok.bits(bits, size)
            elif ss == 0:
                tok.bits((int(coef[0]) >> al) & 1, 1)
            elif ah == 0:
                _ac_first(tok, key_ac, coef, ss, se, al, state, eob)
            else:
                _ac_refine(tok, key_ac, coef, ss, se, al, state, eob)
    if ss:
        eob(key_ac)


def _ac_first(tok, key, coef, ss, se, al, state, eob) -> None:
    band = coef[ss:se + 1]
    mag = np.abs(band) >> al
    nz = np.flatnonzero(mag)
    if not len(nz):
        state["eobrun"] += 1
        if state["eobrun"] == 0x7FFF:
            eob(key)
        return
    eob(key)
    prev = -1
    for k in nz.tolist():
        run = k - prev - 1
        while run > 15:
            tok.sym(key, 0xF0)
            run -= 16
        m = int(mag[k])
        size, bits = _magnitude(m if band[k] >= 0 else -m)
        tok.sym(key, (run << 4) | size)
        tok.bits(bits, size)
        prev = k
    if prev < se - ss:
        state["eobrun"] += 1
        if state["eobrun"] == 0x7FFF:
            eob(key)


def _ac_refine(tok, key, coef, ss, se, al, state, eob) -> None:
    band = coef[ss:se + 1]
    mag = (np.abs(band) >> al).tolist()
    ones = [k for k, m in enumerate(mag) if m == 1]
    last_new = ones[-1] if ones else -1
    r, br = 0, []
    for k, m in enumerate(mag):
        if m == 0:
            r += 1
            continue
        while r > 15 and k <= last_new:
            eob(key)
            tok.sym(key, 0xF0)
            r -= 16
            for bit in br:
                tok.bits(bit, 1)
            br = []
        if m > 1:
            br.append(m & 1)
            continue
        eob(key)
        tok.sym(key, (r << 4) | 1)
        tok.bits(1 if band[k] >= 0 else 0, 1)
        for bit in br:
            tok.bits(bit, 1)
        br, r = [], 0
    if r > 0 or br:
        state["eobrun"] += 1
        state["be"] += br
        # jcphuff.c's MAX_CORR_BITS (1000) less a block's worth
        if state["eobrun"] == 0x7FFF or len(state["be"]) > 1000 - 64 + 1:
            eob(key)


def jpeg_bytes(image: np.ndarray, quality: int = 75, subsampling: str = "420",
               restart_interval: int = 0, *, color: Optional[str] = None,
               factors: Optional[Sequence[tuple]] = None,
               adobe: Optional[int] = None, jfif: Optional[bool] = None,
               ids: Optional[Sequence[int]] = None,
               progressive=False,
               lossless: Optional[tuple] = None, arithmetic=False) -> bytes:
    """A JPEG of an (H, W) grey, (H, W, 3) RGB or (H, W, 4) CMYK uint8
    image: the Annex K tables scaled to ``quality``, each component
    averaged over the cells of its sampling ratio to the largest
    factors, a restart marker every ``restart_interval`` MCUs (0: none).

    ``color``: ``gray``, ``ycbcr`` (the default for 3 channels), ``rgb``
    (coded as it is), ``cmyk`` (the default for 4 channels, coded as it
    is) or ``ycck``. ``factors``: each component's (h, v) sampling
    factors; by default the first component (and K of YCCK) takes
    ``subsampling`` (``SUBSAMPLING``) and the others 1x1, while RGB and
    CMYK are 1x1 throughout. ``adobe``: the APP14 transform to write
    (None: none; by default 0 for RGB and CMYK, 2 for YCCK); ``jfif``:
    write the JFIF APP0 marker (by default for grey and YCbCr);
    ``ids``: the component ids (1, 2, ...).

    ``progressive``: False for one interleaved baseline scan with the
    standard Huffman tables; True for libjpeg's
    ``simple_progression`` script, or a script of (component indices,
    Ss, Se, Ah, Al) scans, each coded with its own optimal Huffman
    tables. ``arithmetic``: code the scans with the QM arithmetic coder
    in place of Huffman (SOF9, or SOF10 when progressive), True for the
    default conditioning or {"dc": (L, U), "ac": K} for a DAC marker's
    own. ``lossless``: (predictor 1-7, point transform) for a
    lossless (SOF3) file in place of the DCT, one interleaved scan with
    optimal tables; ``restart_interval`` must then be whole MCU rows."""
    image = np.asarray(image)
    channels = 1 if image.ndim == 2 else image.shape[-1]
    if color is None:
        color = {1: "gray", 3: "ycbcr", 4: "cmyk"}[channels]
    planes = _planes(image, color)
    n = planes.shape[-1]
    h, w = image.shape[:2]
    if factors is None:
        hs, vs = SUBSAMPLING[subsampling]
        if color in ("gray", "rgb", "cmyk"):
            factors = [(1, 1)] * n
        else:
            factors = [(hs, vs) if ci in (0, 3) else (1, 1)
                       for ci in range(n)]
    factors = [tuple(f) for f in factors]
    if len(factors) != n:
        raise ValueError(f"{n} components, {len(factors)} sampling factors")
    hmax = max(f[0] for f in factors)
    vmax = max(f[1] for f in factors)
    if adobe is None and color in ("rgb", "cmyk", "ycck"):
        adobe = 2 if color == "ycck" else 0
    if jfif is None:
        jfif = color in ("gray", "ycbcr")
    ids = list(ids) if ids is not None else list(range(1, n + 1))
    if lossless:
        return _lossless_bytes(planes, factors, lossless, restart_interval,
                               color, adobe, jfif, ids, w, h)
    mw, mh = 8 * hmax, 8 * vmax
    mcux, mcuy = -(-w // mw), -(-h // mh)
    pad = np.pad(planes.astype(np.int64),
                 ((0, mcuy * mh - h), (0, mcux * mw - w), (0, 0)), mode="edge")
    qts = quant_tables(quality)
    chroma = COLORS[color][1]
    comps = []
    for ci in range(n):
        fh, fv = factors[ci]
        rh, rv = hmax // fh, vmax // fv
        if hmax % fh or vmax % fv:
            raise ValueError(f"sampling {fh}x{fv} is not an integral "
                             f"fraction of {hmax}x{vmax}")
        plane = pad[..., ci]
        if (rh, rv) != (1, 1):
            plane = plane.reshape(plane.shape[0] // rv, rv,
                                  plane.shape[1] // rh, rh)
            plane = (plane.sum((1, 3)) + rh * rv // 2) // (rh * rv)
        gy, gx = plane.shape[0] // 8, plane.shape[1] // 8
        blocks = plane.reshape(gy, 8, gx, 8).transpose(0, 2, 1, 3)
        t = 1 if ci in chroma else 0
        coef = _fdct_quant(blocks.reshape(-1, 8, 8) - 128, qts[t])
        dw, dh = -(-w * fh // hmax), -(-h * fv // vmax)
        comps.append({"coef": coef.reshape(gy, gx, 64), "h": fh, "v": fv,
                      "t": t, "gw": -(-dw // 8), "gh": -(-dh // 8)})
    tables = sorted({c["t"] for c in comps})
    out = [b"\xff\xd8"]
    if jfif:
        out.append(_segment(0xE0,
                            b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"))
    if adobe is not None:
        out.append(_segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00"
                            + bytes([adobe])))
    for t in tables:
        out.append(_segment(0xDB, bytes([t]) + bytes(
            qts[t][ZIGZAG].astype(np.uint8))))
    sof = struct.pack(">BHHB", 8, h, w, n)
    for ci, c in enumerate(comps):
        sof += bytes([ids[ci], (c["h"] << 4) | c["v"], c["t"]])
    out.append(_segment((0xCA if progressive else 0xC9) if arithmetic
                        else 0xC2 if progressive else 0xC0, sof))
    if arithmetic:
        cond = {"dc": (0, 1), "ac": 5}
        if isinstance(arithmetic, dict):
            cond.update(arithmetic)
        if progressive:
            script = simple_progression(n, color) if progressive is True \
                else list(progressive)
            script = [tuple(sc) + (False,) for sc in script]
        else:
            script = [(tuple(range(n)), 0, 63, 0, 0, True)]
        if restart_interval:
            out.append(_segment(0xDD, struct.pack(">H", restart_interval)))
        for scan in script:
            members, ss, se, ah, al, seq = scan
            used = sorted({comps[ci]["t"] for ci in members})
            dac = b""
            for t in used:
                if seq or (ss == 0 and ah == 0):
                    dac += bytes([t, cond["dc"][0] | cond["dc"][1] << 4])
                if seq or se:
                    dac += bytes([t | 0x10, cond["ac"]])
            if dac:
                out.append(_segment(0xCC, dac))
            sos = bytes([len(members)])
            for ci in members:
                t = comps[ci]["t"]
                sos += bytes([ids[ci], (t << 4) | t])
            out.append(_segment(0xDA, sos + bytes([ss, se, (ah << 4) | al])))
            parts = []
            _arith_scan(parts, scan, comps, mcux, mcuy, restart_interval,
                        cond)
            out += parts
        out.append(b"\xff\xd9")
        return b"".join(out)
    if progressive:
        script = simple_progression(n, color) if progressive is True \
            else list(progressive)
        if restart_interval:
            out.append(_segment(0xDD, struct.pack(">H", restart_interval)))
        for scan in script:
            tok = _Tokens()
            _progressive_scan(tok, scan, comps, mcux, mcuy, restart_interval)
            codes = {}
            for (cls, t), freq in sorted(tok.freq.items()):
                counts, symbols = _optimal_code_lengths(freq)
                codes[(cls, t)] = _huff_codes((counts, symbols))
                out.append(_segment(0xC4, bytes([(cls == "ac") << 4 | t])
                                    + bytes(counts) + symbols))
            members, ss, se, ah, al = scan
            sos = bytes([len(members)])
            for ci in members:
                t = comps[ci]["t"]
                sos += bytes([ids[ci], (t << 4) | t])
            out.append(_segment(0xDA, sos + bytes([ss, se, (ah << 4) | al])))
            out.append(tok.emit(codes))
        out.append(b"\xff\xd9")
        return b"".join(out)
    dc = [_huff_codes(_DC_LUMA), _huff_codes(_DC_CHROMA)]
    ac = [_huff_codes(_AC_LUMA), _huff_codes(_AC_CHROMA)]
    bw = _BitWriter()
    preds = [0] * n
    n_mcu = mcux * mcuy
    for m in range(n_mcu):
        if restart_interval and m and m % restart_interval == 0:
            bw.flush()
            bw.out += bytes([0xFF, 0xD0 + (m // restart_interval - 1) % 8])
            preds = [0] * n
        my, mx = divmod(m, mcux)
        for ci, c in enumerate(comps):
            fh, fv = c["h"], c["v"]
            for by in range(fv):
                for bx in range(fh):
                    preds[ci] = _encode_block(
                        bw, c["coef"][my * fv + by, mx * fh + bx], preds[ci],
                        dc[c["t"]], ac[c["t"]])
    bw.flush()
    for cls, specs in ((0, (_DC_LUMA, _DC_CHROMA)), (1, (_AC_LUMA, _AC_CHROMA))):
        for t in tables:
            counts, symbols = specs[t]
            out.append(_segment(0xC4, bytes([(cls << 4) | t]) + bytes(counts)
                                + bytes(symbols)))
    if restart_interval:
        out.append(_segment(0xDD, struct.pack(">H", restart_interval)))
    sos = bytes([n])
    for ci, c in enumerate(comps):
        sos += bytes([ids[ci], (c["t"] << 4) | c["t"]])
    out.append(_segment(0xDA, sos + b"\x00\x3f\x00"))
    out.append(bytes(bw.out))
    out.append(b"\xff\xd9")
    return b"".join(out)


def _lossless_diffs(x: np.ndarray, predictor: int, pt: int,
                    first_rows) -> np.ndarray:
    """T.81 Annex H differences of a component's padded plane: the
    first row of the scan and of each restart interval predicted from
    its left neighbour (its first sample from 2**(7 - pt)), the first
    column from above, the rest by ``predictor``; modulo 2**16, as
    signed values."""
    pred = np.zeros_like(x)
    ra = np.concatenate([x[:, :1] * 0, x[:, :-1]], 1)
    rb = np.concatenate([x[:1] * 0, x[:-1]], 0)
    rc = np.concatenate([rb[:, :1] * 0, rb[:, :-1]], 1)
    pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
            6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[predictor].copy()
    pred[:, 0] = rb[:, 0]
    for r in first_rows:
        pred[r, 1:] = x[r, :-1]
        pred[r, 0] = 1 << (7 - pt)
    d = (x - pred) & 0xFFFF
    return np.where(d >= 32768, d - 65536, d)


def _lossless_bytes(planes, factors, lossless, restart_interval, color,
                    adobe, jfif, ids, w, h) -> bytes:
    predictor, pt = lossless
    n = planes.shape[-1]
    hmax = max(f[0] for f in factors)
    vmax = max(f[1] for f in factors)
    mcux, mcuy = -(-w // hmax), -(-h // vmax)
    if restart_interval % mcux:
        raise ValueError("a lossless restart interval is whole MCU rows "
                         f"({mcux} MCUs)")
    pad = np.pad(planes.astype(np.int64),
                 ((0, mcuy * vmax - h), (0, mcux * hmax - w), (0, 0)),
                 mode="edge")
    rows_per = restart_interval // mcux if restart_interval else mcuy
    chroma = COLORS[color][1]
    comps = []
    for ci in range(n):
        fh, fv = factors[ci]
        rh, rv = hmax // fh, vmax // fv
        plane = pad[..., ci]
        if (rh, rv) != (1, 1):
            plane = plane.reshape(plane.shape[0] // rv, rv,
                                  plane.shape[1] // rh, rh)
            plane = (plane.sum((1, 3)) + rh * rv // 2) // (rh * rv)
        plane = plane >> pt
        first = range(0, mcuy * fv, rows_per * fv)
        comps.append({"d": _lossless_diffs(plane, predictor, pt, first),
                      "h": fh, "v": fv, "t": 1 if ci in chroma else 0})
    tok = _Tokens()
    for m in range(mcux * mcuy):
        if restart_interval and m and m % restart_interval == 0:
            tok.restart(m // restart_interval - 1)
        my, mx = divmod(m, mcux)
        for c in comps:
            for by in range(c["v"]):
                for bx in range(c["h"]):
                    v = int(c["d"][my * c["v"] + by, mx * c["h"] + bx])
                    if v == 32768 or v == -32768:
                        tok.sym(("dc", c["t"]), 16)
                        continue
                    size, bits = _magnitude(v)
                    tok.sym(("dc", c["t"]), size)
                    tok.bits(bits, size)
    out = [b"\xff\xd8"]
    if jfif:
        out.append(_segment(0xE0,
                            b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"))
    if adobe is not None:
        out.append(_segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00"
                            + bytes([adobe])))
    sof = struct.pack(">BHHB", 8, h, w, n)
    for ci, c in enumerate(comps):
        sof += bytes([ids[ci], (c["h"] << 4) | c["v"], 0])
    out.append(_segment(0xC3, sof))
    codes = {}
    for (cls, t), freq in sorted(tok.freq.items()):
        counts, symbols = _optimal_code_lengths(freq)
        codes[(cls, t)] = _huff_codes((counts, symbols))
        out.append(_segment(0xC4, bytes([t]) + bytes(counts) + symbols))
    if restart_interval:
        out.append(_segment(0xDD, struct.pack(">H", restart_interval)))
    sos = bytes([n])
    for ci, c in enumerate(comps):
        sos += bytes([ids[ci], c["t"] << 4])
    out.append(_segment(0xDA, sos + bytes([predictor, 0, pt])))
    out.append(tok.emit(codes))
    out.append(b"\xff\xd9")
    return b"".join(out)


# ITU T.81 Table D.3, the QM coder's probability estimation: (Qe,
# Next_Index_LPS, Next_Index_MPS, Switch_MPS) a state, and state 113 the
# fixed probability 0.5. Packed as libjpeg packs it: Qe << 16 |
# Next_Index_MPS << 8 | Switch_MPS << 7 | Next_Index_LPS
QE_TABLE = [
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0),
    (0x080b, 18, 4, 0), (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0),
    (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0), (0x0036, 30, 9, 0),
    (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1),
    (0x3f25, 36, 16, 0), (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0),
    (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0), (0x0cef, 43, 21, 0),
    (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0),
    (0x01b1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0),
    (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0), (0x0068, 62, 33, 0),
    (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0),
    (0x2ef1, 67, 40, 0), (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0),
    (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
    (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0),
    (0x04de, 50, 52, 0), (0x040f, 50, 53, 0), (0x0363, 51, 54, 0),
    (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0), (0x01f8, 54, 57, 0),
    (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0),
    (0x008f, 61, 32, 0), (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0),
    (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0), (0x2fe8, 83, 69, 0),
    (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0),
    (0x119c, 74, 76, 0), (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0),
    (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0), (0x5832, 80, 81, 1),
    (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0),
    (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0),
    (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0), (0x3824, 99, 93, 0),
    (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0),
    (0x3c3d, 104, 100, 0), (0x375e, 99, 93, 0), (0x5231, 105, 102, 0),
    (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0), (0x415e, 103, 99, 0),
    (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1),
    (0x5522, 112, 109, 0), (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0)]
_QE = [(q << 16) | (nm << 8) | (sw << 7) | nl for q, nl, nm, sw in QE_TABLE]


class _ArithEncoder:
    """jcarith.c's QM coder: arith_encode (Annex D.1 with libjpeg's
    carry handling through stacked 0xFF and 0x00 bytes) and its
    termination (finish_pass)."""

    def __init__(self):
        self.out = bytearray()
        self.c, self.a, self.ct = 0, 0x10000, 11
        self.sc = self.zc = 0
        self.buffer = -1

    def _byte(self, b: int) -> None:
        self.out.append(b)

    def _flush_zeros(self) -> None:
        self.out += b"\x00" * self.zc
        self.zc = 0

    def encode(self, st, i: int, val: int) -> None:
        sv = st[i]
        qe = _QE[sv & 0x7F]
        nl, nm, qe = qe & 0xFF, (qe >> 8) & 0xFF, qe >> 16
        self.a -= qe
        if val != sv >> 7:
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._flush_zeros()
                        self._byte(self.buffer + 1)
                        if self.buffer + 1 == 0xFF:
                            self._byte(0)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    self._release()
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def _release(self) -> None:
        """Output the buffered byte and the stacked 0xFF bytes: they can
        no longer take a carry."""
        if self.buffer == 0:
            self.zc += 1
        elif self.buffer >= 0:
            self._flush_zeros()
            self._byte(self.buffer)
        if self.sc:
            self._flush_zeros()
            self.out += b"\xff\x00" * self.sc
            self.sc = 0

    def finish(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._flush_zeros()
                self._byte(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._byte(0)
            self.zc += self.sc
            self.sc = 0
        else:
            self._release()
        if self.c & 0x7FFF800:
            self._flush_zeros()
            for shift, mask in ((19, 0x7FFF800), (11, 0x7F800)):
                if not self.c & mask:
                    break
                b = (self.c >> shift) & 0xFF
                self._byte(b)
                if b == 0xFF:
                    self._byte(0)
        return bytes(self.out)


def _arith_magnitude(enc, st, i, v, x1, k=None, kx=None) -> None:
    """Figures F.8 and F.9: the magnitude category of v - 1 (v >= 1)
    from bin ``i``, its first further bins at ``x1`` (AC: 189 or 217 by
    the conditioning K), then its bits."""
    m = 0
    v -= 1
    if v:
        enc.encode(st, i, 1)
        m = 1
        v2 = v
        if x1 is None:            # DC: every further bit from X1 = 20
            i = 20
            while v2 >> 1:
                v2 >>= 1
                enc.encode(st, i, 1)
                m <<= 1
                i += 1
        else:
            v2 >>= 1
            if v2:
                enc.encode(st, i, 1)
                m <<= 1
                i = x1
                while v2 >> 1:
                    v2 >>= 1
                    enc.encode(st, i, 1)
                    m <<= 1
                    i += 1
    enc.encode(st, i, 0)
    i += 14
    m >>= 1
    while m:
        enc.encode(st, i, 1 if m & v else 0)
        m >>= 1
    return None


def _arith_dc(enc, st, ctx, v, cond) -> int:
    """Figure F.4 with F.1.4.4.1's conditioning: one DC difference from
    statistics area ``st`` in context ``ctx``; returns the next
    context."""
    lo, hi = cond
    if v == 0:
        enc.encode(st, ctx, 0)
        return 0
    enc.encode(st, ctx, 1)
    sign = v < 0
    enc.encode(st, ctx + 1, int(sign))
    v = abs(v)
    nxt = 8 if sign else 4
    m = (v - 1).bit_length() and 1 << ((v - 1).bit_length() - 1)
    if m < (1 << lo) >> 1:
        nxt = 0
    elif m > (1 << hi) >> 1:
        nxt += 8
    _arith_magnitude(enc, st, ctx + 2 + sign, v, None)
    return nxt


def _arith_scan(enc_parts, scan, comps, mcux, mcuy, restart_interval, cond):
    """One scan of an arithmetic-coded file (jcarith.c): sequential when
    ``scan`` covers 0..63 with Ah = Al = 0 in a sequential frame, else
    its progressive kind. Appends the entropy-coded segments, RST
    markers between them, to ``enc_parts``."""
    members, ss, se, ah, al, sequential = scan
    units = _scan_units(members, comps, mcux, mcuy)
    fixed = [113]

    def fresh():
        return (_ArithEncoder(), {t: [0] * 64 for t in range(4)},
                {t: [0] * 256 for t in range(4)},
                {ci: 0 for ci in members}, {ci: 0 for ci in members})

    enc, dc_st, ac_st, last, ctx = fresh()
    for u, unit in enumerate(units):
        if restart_interval and u and u % restart_interval == 0:
            enc_parts.append(enc.finish())
            enc_parts.append(bytes([0xFF, 0xD0 + (u // restart_interval - 1)
                                    % 8]))
            enc, dc_st, ac_st, last, ctx = fresh()
        for ci, by, bx in unit:
            c = comps[ci]
            coef = [int(x) for x in c["coef"][by, bx]]   # zigzag order
            t = c["t"]
            if ss == 0 and ah == 0:
                dc = coef[0] >> al
                ctx[ci] = _arith_dc(enc, dc_st[t], ctx[ci], dc - last[ci],
                                    cond["dc"])
                last[ci] = dc
            elif ss == 0:
                enc.encode(fixed, 0, (coef[0] >> al) & 1)
            if sequential:
                _arith_ac(enc, ac_st[t], coef, 1, 63, 0, cond["ac"], fixed)
            elif ss and ah == 0:
                _arith_ac(enc, ac_st[t], coef, ss, se, al, cond["ac"], fixed)
            elif ss:
                _arith_ac_refine(enc, ac_st[t], coef, ss, se, ah, al, fixed)
    enc_parts.append(enc.finish())


def _shifted(v: int, al: int) -> int:
    """The point transform of an AC coefficient: |v| >> al, signed."""
    return (abs(v) >> al) * (1 if v >= 0 else -1)


def _arith_ac(enc, st, coef, ss, se, al, kx, fixed) -> None:
    """Figure F.5 over the band ``ss..se`` of one block (``coef`` in
    zigzag order), the values shifted by ``al``."""
    vals = [_shifted(coef[k], al) for k in range(64)]
    ke = se
    while ke > 0 and not vals[ke]:
        ke -= 1
    k = ss
    while k <= ke:
        i = 3 * (k - 1)
        enc.encode(st, i, 0)
        while not vals[k]:
            enc.encode(st, i + 1, 0)
            i += 3
            k += 1
        enc.encode(st, i + 1, 1)
        v = vals[k]
        enc.encode(fixed, 0, int(v < 0))
        _arith_magnitude(enc, st, i + 2, abs(v), 189 if k <= kx else 217)
        k += 1
    if k <= se:
        enc.encode(st, 3 * (k - 1), 1)


def _arith_ac_refine(enc, st, coef, ss, se, ah, al, fixed) -> None:
    """Figure G.10: one bit more of every coefficient of the band; the
    end-of-band decision only past the last one known before."""
    mags = [abs(coef[k]) >> al for k in range(64)]
    ke = se
    while ke > 0 and not mags[ke]:
        ke -= 1
    kex = ke
    while kex > 0 and not abs(coef[kex]) >> ah:
        kex -= 1
    k = ss
    while k <= ke:
        i = 3 * (k - 1)
        if k > kex:
            enc.encode(st, i, 0)
        while True:
            m = mags[k]
            if m:
                if m >> 1:
                    enc.encode(st, i + 2, m & 1)
                else:
                    enc.encode(st, i + 1, 1)
                    enc.encode(fixed, 0, int(coef[k] < 0))
                break
            enc.encode(st, i + 1, 0)
            i += 3
            k += 1
        k += 1
    if k <= se:
        enc.encode(st, 3 * (k - 1), 1)


_SCAN_END = re.compile(rb"\xff+[^\x00\xd0-\xd7\xff]")


def jpeg_prefix(data: bytes, scans: int) -> bytes:
    """``data`` cut after its first ``scans`` scans, an EOI appended: the
    file a decoder sees when a progressive download stops there."""
    pos, seen = 2, 0
    while True:
        marker = data[pos + 1]
        if marker == 0xD9:
            return data
        length = struct.unpack_from(">H", data, pos + 2)[0]
        if marker == 0xDA:
            if seen == scans:
                return data[:pos] + b"\xff\xd9"
            seen += 1
            pos = _SCAN_END.search(data, pos + 2 + length).end() - 2
        else:
            pos += 2 + length


# ---------------------------------------------------------------------------
# the other formats PIL opens: BMP/DIB, PNM, QOI, TGA, GIF, TIFF, ICO/CUR
# ---------------------------------------------------------------------------


def indexed_image(seed: int, height: int, width: int,
                  colors: int = 256) -> np.ndarray:
    """(H, W) uint8 palette indices in [0, colors): a smooth grey field
    scaled down to the palette."""
    g = smooth_image(seed, height, width, 1)[..., 0]
    return (g * colors // 256).astype(np.uint8)


def random_palette(seed: int, colors: int) -> np.ndarray:
    """(colors, 3) uint8 random colours."""
    return np.frombuffer(np.random.default_rng(seed).bytes(3 * colors),
                         np.uint8).reshape(colors, 3).copy()


def _pack_indices(idx: np.ndarray, bits: int) -> np.ndarray:
    """(H, W) samples of ``bits`` (1, 2, 4, 8) -> (H, ceil(W*bits/8))
    bytes, most significant first."""
    if bits == 8:
        return idx.astype(np.uint8)
    h, w = idx.shape
    per = 8 // bits
    pad = (-w) % per
    v = np.pad(idx.astype(np.uint8), ((0, 0), (0, pad)))
    v = v.reshape(h, -1, per).astype(np.uint16)
    shifts = np.arange(per - 1, -1, -1) * bits
    return (v << shifts).sum(-1).astype(np.uint8)


def _rle_bmp_row(row: np.ndarray, rle4: bool) -> bytes:
    """One row of BMP RLE8/RLE4: runs of two or more as encoded runs,
    the rest as literal runs (RLE4: even lengths, as PIL reads only whole
    bytes of a literal) padded to 16 bits, short leftovers as runs of
    one; then end-of-line."""
    out = bytearray()
    v = [int(x) for x in row]
    n, i = len(v), 0
    while i < n:
        j = i + 1
        while j < n and v[j] == v[i] and j - i < 255:
            j += 1
        if j - i >= 2:
            b = (v[i] << 4 | v[i]) if rle4 else v[i]
            out += bytes([j - i, b])
            i = j
            continue
        j = i + 1
        while j < n and j - i < 254 and (j + 1 >= n or v[j] != v[j + 1]):
            j += 1
        lit = j - i
        if rle4:
            lit -= lit % 2
        if lit < 3:
            b = (v[i] << 4) if rle4 else v[i]
            out += bytes([1, b])
            i += 1
            continue
        if rle4:
            body = bytes(v[k] << 4 | v[k + 1] for k in range(i, i + lit, 2))
        else:
            body = bytes(v[i:i + lit])
        out += bytes([0, lit]) + body + bytes(len(body) % 2)
        i += lit
    return bytes(out) + b"\x00\x00"


def bmp_bytes(pixels: np.ndarray, bits: int = 24, compression: str = "rgb",
              header: int = 40, top_down: bool = False, palette=None,
              colors: Optional[int] = None, alpha: bool = False,
              file_header: bool = True) -> bytes:
    """A BMP (or, without ``file_header``, a bare DIB): ``pixels`` (H, W)
    palette indices for ``bits`` 1/4/8 with ``palette`` ((N, 3) RGB;
    ``colors`` entries written, a short palette allowed), else (H, W, 3)
    RGB or (H, W, 4) RGBA. ``compression``: ``rgb`` (16-bit: 5-5-5),
    ``rle8``, ``rle4``, ``bitfields`` (16-bit: 5-6-5; 32-bit: BGRX, or
    BGRA with ``alpha`` and a header of 56 bytes or more). ``header`` 12
    is the OS/2 core header (3-byte palette entries)."""
    h, w = pixels.shape[:2]
    comp = {"rgb": 0, "rle8": 1, "rle4": 2, "bitfields": 3}[compression]
    if bits <= 8:
        pal = np.asarray(palette, np.uint8).reshape(-1, 3)
        ncol = len(pal) if colors is None else colors
        entry = 3 if header == 12 else 4
        pal_bytes = b"".join(bytes([b, g, r]) + bytes(entry - 3)
                             for r, g, b in pal[:ncol])
    else:
        pal_bytes, ncol = b"", 0
    rows = pixels if top_down else pixels[::-1]
    if comp in (1, 2):
        body = b"".join(_rle_bmp_row(r, comp == 2) for r in rows) + \
            b"\x00\x01"
    else:
        if bits <= 8:
            packed = _pack_indices(rows, bits)
        elif bits == 16:
            p = rows.astype(np.uint16)
            if comp == 3:
                v = (p[..., 0] >> 3) << 11 | (p[..., 1] >> 2) << 5 | \
                    p[..., 2] >> 3
            else:
                v = (p[..., 0] >> 3) << 10 | (p[..., 1] >> 3) << 5 | \
                    p[..., 2] >> 3
            packed = v.astype("<u2").view(np.uint8).reshape(h, -1)
        elif bits == 24:
            packed = rows[..., 2::-1].reshape(h, -1)
        else:
            a = rows[..., 3] if rows.shape[-1] == 4 else \
                np.zeros((h, w), np.uint8)
            packed = np.stack([rows[..., 2], rows[..., 1], rows[..., 0], a],
                              -1).reshape(h, -1)
        stride = ((w * bits + 31) >> 3) & ~3
        body = np.pad(packed.astype(np.uint8),
                      ((0, 0), (0, stride - packed.shape[1]))).tobytes()
    masks = b""
    if comp == 3:
        if bits == 16:
            m = (0xF800, 0x7E0, 0x1F, 0)
        else:
            m = (0xFF0000, 0xFF00, 0xFF, 0xFF000000 if alpha else 0)
        masks = struct.pack("<4I", *m)
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        height = -h if top_down else h
        info = struct.pack("<IiiHHIIiiII", header, w, height, 1, bits, comp,
                           len(body), 2835, 2835, ncol if bits <= 8 else 0,
                           0)
        if header == 40:    # the masks follow a 40-byte header
            info += masks[:12]
        else:
            info = (info + masks.ljust(16, b"\0")).ljust(header,
                                                         b"\0")[:header]
    dib = info + pal_bytes + body
    if not file_header:
        return dib
    off = 14 + len(info) + len(pal_bytes)
    return b"BM" + struct.pack("<IHHI", off + len(body), 0, 0, off) + dib


def pnm_bytes(samples: np.ndarray, magic: str = "P6", maxval: int = 255,
              comment: Optional[str] = None, scale: float = -1.0,
              line: int = 17) -> bytes:
    """A Netpbm file: ``P1``/``P4`` (``samples`` (H, W), 1 = black),
    ``P2``/``P5`` ((H, W) at most ``maxval``), ``P3``/``P6`` ((H, W, 3)),
    ``Pf`` ((H, W) float32, rows written bottom-up, little-endian for a
    negative ``scale``). Raw samples over 255 are big-endian 16-bit.
    ``comment`` goes after the magic and inside the plain data;
    ``line`` samples a line of plain data."""
    h, w = samples.shape[:2]
    c = f"# {comment}\n" if comment is not None else ""
    head = f"{magic}\n{c}{w} {h}\n"
    if magic not in ("P1", "P4"):
        head += f"{scale}\n" if magic == "Pf" else f"{maxval}\n"
    if magic == "Pf":
        body = samples[::-1].astype("<f4" if scale < 0 else ">f4").tobytes()
    elif magic == "P4":
        body = _pack_indices(samples.astype(np.uint8), 1).tobytes()
    elif magic in ("P5", "P6"):
        dt = np.uint8 if maxval < 256 else ">u2"
        body = samples.astype(dt).tobytes()
    else:
        flat = [str(int(v)) for v in samples.reshape(-1)]
        sep = "" if magic == "P1" else " "
        lines = [sep.join(flat[i:i + line]) for i in range(0, len(flat), line)]
        if c:
            lines.insert(len(lines) // 2, c.strip())
        body = ("\n".join(lines) + "\n").encode()
    return head.encode() + body


def qoi_bytes(pixels: np.ndarray) -> bytes:
    """A QOI file of (H, W, 3) RGB or (H, W, 4) RGBA ``pixels``: the
    reference encoder's choice among its six ops."""
    h, w, c = pixels.shape
    flat = pixels.reshape(-1, c).astype(np.int64)
    if c == 3:
        flat = np.concatenate([flat, np.full((len(flat), 1), 255)], 1)
    out = bytearray(b"qoif" + struct.pack(">IIBB", w, h, c, 0))
    seen = [None] * 64
    prev = (0, 0, 0, 255)
    run = 0
    for i, p in enumerate(map(tuple, flat.tolist())):
        if p == prev:
            run += 1
            if run == 62 or i == len(flat) - 1:
                out.append(0xC0 | (run - 1))
                run = 0
            continue
        if run:
            out.append(0xC0 | (run - 1))
            run = 0
        r, g, b, a = p
        k = (r * 3 + g * 5 + b * 7 + a * 11) % 64
        if seen[k] == p:
            out.append(k)
        else:
            seen[k] = p
            if a == prev[3]:
                dr = (r - prev[0] + 128) % 256 - 128
                dg = (g - prev[1] + 128) % 256 - 128
                db = (b - prev[2] + 128) % 256 - 128
                if -2 <= dr <= 1 and -2 <= dg <= 1 and -2 <= db <= 1:
                    out.append(0x40 | (dr + 2) << 4 | (dg + 2) << 2 | (db + 2))
                elif -32 <= dg <= 31 and -8 <= dr - dg <= 7 and \
                        -8 <= db - dg <= 7:
                    out += bytes([0x80 | (dg + 32),
                                  (dr - dg + 8) << 4 | (db - dg + 8)])
                else:
                    out += bytes([0xFE, r, g, b])
            else:
                out += bytes([0xFF, r, g, b, a])
        prev = p
    return bytes(out) + b"\x00" * 7 + b"\x01"


def _tga_rle(px: np.ndarray) -> bytes:
    """TGA RLE packets over (N, bytes a pixel) pixels of one row: repeats
    of two or more as run packets, the rest as raw packets, 128 at
    most."""
    rows = [bytes(r) for r in px]
    out = bytearray()
    i, n = 0, len(rows)
    while i < n:
        j = i + 1
        while j < n and rows[j] == rows[i] and j - i < 128:
            j += 1
        if j - i >= 2:
            out.append(0x80 | (j - i - 1))
            out += rows[i]
            i = j
            continue
        j = i + 1
        while j < n and j - i < 128 and (j + 1 >= n or rows[j] != rows[j + 1]):
            j += 1
        out.append(j - i - 1)
        out += b"".join(rows[i:j])
        i = j
    return bytes(out)


def tga_bytes(pixels: np.ndarray, image_type: int = 2, depth: int = 24,
              origin: str = "bottom-left", palette=None, map_start: int = 0,
              map_depth: int = 24, ident: bytes = b"") -> bytes:
    """A TGA file. ``image_type`` 1/9 (colour-mapped: (H, W) indices into
    ``palette`` (N, 3), written from entry ``map_start`` on at
    ``map_depth`` 15/16, 24 or 32 bits), 2/10 (true colour: (H, W, 3) at
    ``depth`` 16 (5-5-5 with the top bit set) or 24, (H, W, 4) at 32),
    3/11 (grey: (H, W) at 8, or (H, W, 2) grey+alpha at 16); 9, 10 and
    11 are RLE. ``origin``: bottom-left, top-left, bottom-right or
    top-right."""
    h, w = pixels.shape[:2]
    flags = {"bottom-left": 0, "bottom-right": 0x10, "top-left": 0x20,
             "top-right": 0x30}[origin]
    if depth == 32 or (depth == 16 and image_type in (3, 11)):
        flags |= 8
    rows = pixels if flags & 0x20 else pixels[::-1]
    if flags & 0x10:
        rows = rows[:, ::-1]
    base = image_type & 7
    cmap = b""
    if base == 1:
        pal = np.asarray(palette, np.uint8).reshape(-1, 3)[map_start:]
        if map_depth in (15, 16):
            p = pal.astype(np.uint16)
            v = (p[:, 0] >> 3) << 10 | (p[:, 1] >> 3) << 5 | p[:, 2] >> 3
            cmap = v.astype("<u2").tobytes()
        elif map_depth == 24:
            cmap = pal[:, ::-1].tobytes()
        else:
            cmap = np.concatenate([pal[:, ::-1], np.full((len(pal), 1), 255,
                                                         np.uint8)],
                                  1).tobytes()
        px = rows.reshape(-1, 1).astype(np.uint8)
    elif base == 2:
        if depth == 16:
            p = rows.astype(np.uint16)
            v = 0x8000 | (p[..., 0] >> 3) << 10 | (p[..., 1] >> 3) << 5 | \
                p[..., 2] >> 3
            px = v.astype("<u2").view(np.uint8).reshape(-1, 2)
        else:
            order = [2, 1, 0, 3][:rows.shape[-1]]
            px = rows[..., order].reshape(-1, rows.shape[-1]).astype(np.uint8)
    else:
        px = rows.reshape(h * w, -1).astype(np.uint8)
    ncmap = len(pal) if base == 1 else 0
    header = struct.pack("<BBBHHBHHHHBB", len(ident), 1 if base == 1 else 0,
                         image_type, map_start if ncmap else 0, ncmap,
                         map_depth if ncmap else 0, 0, 0, w, h, depth, flags)
    if image_type & 8:
        body = b"".join(_tga_rle(r) for r in np.split(px, h))
    else:
        body = px.tobytes()
    return header + ident + cmap + body


def lzw_gif(indices: bytes, min_size: int, defer_clear: bool = False,
            clear_first: bool = True) -> bytes:
    """GIF's LZW over ``indices``: codes from ``min_size + 1`` bits up to
    12, least significant bit first, a clear code first and the end code
    last. When the table is full it emits a clear code, or with
    ``defer_clear`` goes on at 12 bits adding nothing (a deferred
    clear)."""
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    out = bytearray()
    acc = nbits = 0
    size = min_size + 1

    def emit(code):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8

    def reset():
        nonlocal size
        size = min_size + 1
        return {bytes([i]): i for i in range(clear)}, clear + 2

    table, nxt = reset()
    if clear_first:
        emit(clear)
    w = b""
    for c in indices:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        emit(table[w])
        if nxt < 4096:
            table[wc] = nxt
            nxt += 1
            if nxt > 1 << size and size < 12:
                size += 1
        elif not defer_clear:
            emit(clear)
            table, nxt = reset()
        w = bytes([c])
    if w:
        emit(table[w])
        if nxt < 4096:
            nxt += 1
            if nxt > 1 << size and size < 12:
                size += 1
    emit(eoi)
    if nbits:
        out.append(acc & 255)
    return bytes(out)


def _gif_table(palette, bits: int) -> bytes:
    pal = np.zeros((1 << bits, 3), np.uint8)
    p = np.asarray(palette, np.uint8).reshape(-1, 3)[:1 << bits]
    pal[:len(p)] = p
    return pal.tobytes()


def gif_bytes(indices: np.ndarray, palette, screen=None, offset=(0, 0),
              interlace: bool = False, local: bool = False,
              transparency: Optional[int] = None, min_size: int = 8,
              defer_clear: bool = False, comment: Optional[bytes] = None,
              frames: int = 1) -> bytes:
    """A GIF89a of (H, W) ``indices`` into ``palette`` ((N, 3), written
    as the global table, or with ``local`` as the frame's own table,
    the global one then a reversed copy), placed at ``offset`` on a
    ``screen`` (W, H) that defaults to the frame's size; ``interlace``
    writes GIF's four passes; ``transparency`` adds a graphic control
    extension; ``frames`` > 1 repeats the frame (PIL reads the first)."""
    h, w = indices.shape
    sw, sh = screen or (w, h)
    bits = max(1, int(np.ceil(np.log2(max(len(np.asarray(palette)) // 1
                                          if np.ndim(palette) == 2 else
                                          len(palette) // 3, 2)))))
    pal = np.asarray(palette, np.uint8).reshape(-1, 3)
    gpal = pal[::-1] if local else pal
    out = bytearray(b"GIF89a" + struct.pack("<HHBBB", sw, sh,
                                            0x80 | (bits - 1), 0, 0))
    out += _gif_table(gpal, bits)
    if comment is not None:
        out += b"\x21\xfe" + bytes([len(comment)]) + comment + b"\0"
    rows = indices
    if interlace:
        order = np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8),
                                np.arange(2, h, 4), np.arange(1, h, 2)])
        rows = indices[order]
    data = lzw_gif(rows.astype(np.uint8).tobytes(), min_size, defer_clear)
    for _ in range(frames):
        if transparency is not None:
            out += b"\x21\xf9\x04" + struct.pack("<BHB", 1, 10,
                                                 transparency) + b"\0"
        flags = (0x40 if interlace else 0) | ((0x80 | (bits - 1))
                                              if local else 0)
        out += b"\x2c" + struct.pack("<HHHHB", offset[0], offset[1], w, h,
                                     flags)
        if local:
            out += _gif_table(pal, bits)
        out.append(min_size)
        for i in range(0, len(data), 255):
            out += bytes([len(data[i:i + 255])]) + data[i:i + 255]
        out += b"\0"
    return bytes(out) + b"\x3b"


def packbits(data: bytes) -> bytes:
    """PackBits: runs of 3 to 128 repeats, literals of up to 128."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        j = i + 1
        while j < n and data[j] == data[i] and j - i < 128:
            j += 1
        if j - i >= 3:
            out += bytes([257 - (j - i), data[i]])
            i = j
            continue
        j = i
        while j < n and j - i < 128 and not (
                j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def lzw_tiff(data: bytes) -> bytes:
    """TIFF's LZW: codes most significant bit first, 9 to 12 bits, the
    width growing one code early, a clear code first, another before the
    table would pass 4094 entries, the end code last."""
    out = bytearray()
    acc = nbits = 0
    size = 9

    def emit(code):
        nonlocal acc, nbits
        acc = acc << size | code
        nbits += size
        while nbits >= 8:
            out.append(acc >> (nbits - 8) & 255)
            nbits -= 8
        acc &= (1 << nbits) - 1

    def reset():
        nonlocal size
        size = 9
        return {bytes([i]): i for i in range(256)}, 258

    emit(256)
    table, nxt = reset()
    w = b""
    for c in data:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        emit(table[w])
        table[wc] = nxt
        nxt += 1
        if nxt == (1 << size) - 1 + 1 and size < 12:
            size += 1
        if nxt >= 4094:
            emit(256)
            table, nxt = reset()
        w = bytes([c])
    if w:
        emit(table[w])
        nxt += 1
        if nxt == (1 << size) and size < 12:
            size += 1
    emit(257)
    if nbits:
        out.append(acc << (8 - nbits) & 255)
    return bytes(out)


def _tiff_predict(block: np.ndarray, predictor: int, spp: int) -> np.ndarray:
    """Predictor 2 (differences along each row, per sample) or 3 (float:
    each row's sample bytes split into planes, most significant first,
    then byte differences) over (rows, width, spp) samples; predictor 3
    returns bytes, the others samples."""
    if predictor == 2:
        d = block.copy()
        d[:, 1:] = block[:, 1:] - block[:, :-1]
        return d
    if predictor == 3:
        h = block.shape[0]
        k = block.dtype.itemsize
        b = block.astype(block.dtype.newbyteorder(">")).view(np.uint8)
        planes = b.reshape(h, -1, k).transpose(0, 2, 1).reshape(h, -1)
        out = planes.copy()
        out[:, spp:] = planes[:, spp:] - planes[:, :-spp]
        return out
    return block


def tiff_bytes(samples: np.ndarray, photometric: int = 2, bits: int = 8,
               compression: int = 1, predictor: int = 1,
               rows_per_strip: Optional[int] = None, tile=None,
               planar: int = 1, byteorder: str = "<", bigtiff: bool = False,
               extra: Sequence[int] = (), sample_format: int = 1,
               colormap=None, fill_order: int = 1,
               orientation: Optional[int] = None) -> bytes:
    """A TIFF of ``samples`` ((H, W) or (H, W, spp): uint8/uint16/int16/
    int32/float32 as ``bits`` and ``sample_format`` say; 1-, 2- and 4-bit
    values packed). ``compression`` 1 (none), 5 (LZW), 8 or 32946
    (Deflate), 32773 (PackBits); ``predictor`` 2 or 3; strips of
    ``rows_per_strip`` rows, or tiles of ``tile`` (w, h) (multiples of
    16); ``planar`` 2 stores each sample in its own plane; ``byteorder``
    ``<`` (II) or ``>`` (MM); ``bigtiff``; ``extra`` the ExtraSamples
    values; ``colormap`` (N, 3) RGB for photometric 3 (stored 16-bit);
    ``fill_order`` 2 reverses every stored byte's bits."""
    s = samples if samples.ndim == 3 else samples[..., None]
    h, w, spp = s.shape
    e = byteorder
    dt = {(8, 1): np.uint8, (16, 1): np.uint16, (16, 2): np.int16,
          (32, 1): np.uint32, (32, 2): np.int32, (32, 3): np.float32}
    pred_dt = dt.get((bits, sample_format), np.uint8)
    rev = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)

    def encode(block: np.ndarray) -> bytes:
        """(rows, cols, n) samples -> stored bytes of one strip/tile."""
        n = block.shape[2]
        if bits < 8:
            raw = _pack_indices(block.reshape(block.shape[0], -1),
                                bits).tobytes()
        else:
            v = block.astype(pred_dt)
            v = _tiff_predict(v, predictor, n) if compression != 1 else v
            if predictor == 3 and compression != 1:
                raw = v.tobytes()
            else:
                raw = v.astype(np.dtype(pred_dt).newbyteorder(e)).tobytes()
        if compression == 5:
            raw = lzw_tiff(raw)
        elif compression in (8, 32946):
            raw = zlib.compress(raw, 6)
        elif compression == 32773:
            rb = -(-block.shape[1] * n * bits // 8)
            raw = b"".join(packbits(raw[i:i + rb])
                           for i in range(0, len(raw), rb))
        if fill_order == 2:
            raw = rev[np.frombuffer(raw, np.uint8)].tobytes()
        return raw

    planes = [s[..., i:i + 1] for i in range(spp)] if planar == 2 else [s]
    chunks = []
    if tile:
        tw, th = tile
        for pl in planes:
            pad = np.zeros((-(-h // th) * th, -(-w // tw) * tw,
                            pl.shape[2]), pl.dtype)
            pad[:h, :w] = pl
            for y in range(0, pad.shape[0], th):
                for x in range(0, pad.shape[1], tw):
                    chunks.append(encode(pad[y:y + th, x:x + tw]))
    else:
        rps = rows_per_strip or h
        for pl in planes:
            for y in range(0, h, rps):
                chunks.append(encode(pl[y:y + rps]))
    head_len = 16 if bigtiff else 8
    body = bytearray()
    offsets = []
    for ch in chunks:
        offsets.append(head_len + len(body))
        body += ch + bytes(len(ch) % 2)
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp),
            259: (3, [compression]), 262: (3, [photometric]),
            277: (3, [spp]), 284: (3, [planar])}
    off_type = 16 if bigtiff else 4
    if tile:
        tags.update({322: (3, [tile[0]]), 323: (3, [tile[1]]),
                     324: (off_type, offsets),
                     325: (off_type, [len(c) for c in chunks])})
    else:
        tags.update({273: (off_type, offsets), 278: (4, [rows_per_strip
                                                         or h]),
                     279: (off_type, [len(c) for c in chunks])})
    if predictor != 1:
        tags[317] = (3, [predictor])
    if fill_order != 1:
        tags[266] = (3, [fill_order])
    if orientation:
        tags[274] = (3, [orientation])
    if extra:
        tags[338] = (3, list(extra))
    if sample_format != 1:
        tags[339] = (3, [sample_format] * spp)
    if colormap is not None:
        cm = np.zeros((1 << bits, 3), np.int64)
        c = np.asarray(colormap, np.int64).reshape(-1, 3)[:1 << bits]
        cm[:len(c)] = c
        tags[320] = (3, list((cm * 257).T.reshape(-1)))
    codes = {3: "H", 4: "I", 16: "Q"}
    inline = 8 if bigtiff else 4
    ifd_pos = head_len + len(body)
    n = len(tags)
    ifd_len = (8 + 20 * n + 8) if bigtiff else (2 + 12 * n + 4)
    extra_pos = ifd_pos + ifd_len
    entries, blobs = bytearray(), bytearray()
    for tag in sorted(tags):
        typ, vals = tags[tag]
        data = struct.pack(e + codes[typ] * len(vals), *vals)
        if len(data) <= inline:
            val = data.ljust(inline, b"\0")
        else:
            val = struct.pack(e + ("Q" if bigtiff else "I"),
                              extra_pos + len(blobs))
            blobs += data + bytes(len(data) % 2)
        if bigtiff:
            entries += struct.pack(e + "HHQ", tag, typ, len(vals)) + val
        else:
            entries += struct.pack(e + "HHI", tag, typ, len(vals)) + val
    if bigtiff:
        ifd = struct.pack(e + "Q", n) + entries + struct.pack(e + "Q", 0)
        head = (b"II" if e == "<" else b"MM") + struct.pack(e + "HHHQ", 43,
                                                             8, 0, ifd_pos)
    else:
        ifd = struct.pack(e + "H", n) + entries + struct.pack(e + "I", 0)
        head = (b"II" if e == "<" else b"MM") + struct.pack(e + "HI", 42,
                                                             ifd_pos)
    return head + bytes(body) + ifd + bytes(blobs)


def ico_bytes(entries, cursor: bool = False) -> bytes:
    """An ICO (or, with ``cursor``, a CUR) of ``entries``: each a PNG
    file's bytes, or (pixels, bits, palette) for a DIB entry (pixels as
    ``bmp_bytes`` takes them; its AND mask all opaque)."""
    payloads, dims = [], []
    for e in entries:
        if isinstance(e, bytes):
            w, h = struct.unpack(">II", e[16:24])
            payloads.append(e)
            dims.append((w, h, 32, 0))
            continue
        pixels, bits, palette = e
        h, w = pixels.shape[:2]
        dib = bmp_bytes(pixels, bits, palette=palette, file_header=False)
        dib = dib[:8] + struct.pack("<i", 2 * h) + dib[12:]
        mask_row = ((w + 31) // 32) * 4
        payloads.append(dib + bytes(mask_row * h))
        ncol = 0 if bits > 8 else min(len(np.asarray(palette).reshape(-1, 3)),
                                      255)
        dims.append((w, h, bits, ncol))
    out = bytearray(struct.pack("<HHH", 0, 2 if cursor else 1, len(entries)))
    off = 6 + 16 * len(entries)
    for (w, h, bits, ncol), pay in zip(dims, payloads):
        out += struct.pack("<BBBBHHII", w & 255, h & 255, ncol, 0, 1, bits,
                           len(pay), off)
        off += len(pay)
    return bytes(out) + b"".join(payloads)


def _palette_332() -> np.ndarray:
    i = np.arange(256)
    return np.stack([(i >> 5) * 255 // 7, ((i >> 2) & 7) * 255 // 7,
                     (i & 3) * 255 // 3], -1).astype(np.uint8)


def _to_332(rgb: np.ndarray) -> np.ndarray:
    r, g, b = (rgb[..., k].astype(np.int64) for k in range(3))
    return ((r >> 5) << 5 | (g >> 5) << 2 | b >> 6).astype(np.uint8)


def format_variants():
    """{name: writer}: each writer takes one (H, W, 3) uint8 RGB frame
    and returns a file of one format variant that holds it as a true-
    colour frame (BMP and TGA 16 bits and GIF, a 3-3-2 palette, at less
    depth). The first 16 cover every format, so a series of 16 files
    in turn does."""
    def bmp(**kw):
        return lambda img: bmp_bytes(img, **kw)

    def tif(**kw):
        return lambda img: tiff_bytes(img, 2, 8, **kw)

    def rgba(img):
        return np.concatenate([img, np.full(img.shape[:2] + (1,), 255,
                                            np.uint8)], -1)
    return {
        "bmp_24": bmp(bits=24),
        "ppm_raw": lambda img: pnm_bytes(img, "P6"),
        "qoi_rgb": qoi_bytes,
        "tga_24_rle": lambda img: tga_bytes(img, 10, 24),
        "gif_332": lambda img: gif_bytes(_to_332(img), _palette_332()),
        "tiff_lzw_predictor": tif(compression=5, predictor=2,
                                  rows_per_strip=32),
        "ico_png": lambda img: ico_bytes([png_bytes(img, 2, 8)]),
        "tiff_deflate": tif(compression=8),
        "bmp_16_565": bmp(bits=16, compression="bitfields"),
        "ppm_plain": lambda img: pnm_bytes(img, "P3", comment="plain"),
        "tga_32_rle_top_left": lambda img: tga_bytes(rgba(img), 10, 32,
                                                     "top-left"),
        "gif_332_interlaced": lambda img: gif_bytes(
            _to_332(img), _palette_332(), interlace=True),
        "tiff_packbits": tif(compression=32773, rows_per_strip=32),
        "cur_bmp_24": lambda img: ico_bytes([(img, 24, None)], cursor=True),
        "dib_24": bmp(bits=24, file_header=False),
        "bigtiff_deflate": tif(compression=8, bigtiff=True),
        "bmp_24_top_down": bmp(bits=24, top_down=True),
        "bmp_24_os2": bmp(bits=24, header=12),
        "bmp_32": bmp(bits=32),
        "bmp_32_bitfields_v5": lambda img: bmp_bytes(
            rgba(img), 32, "bitfields", header=124, alpha=True),
        "bmp_16_555": bmp(bits=16),
        "ppm_raw_16": lambda img: pnm_bytes(img.astype(np.int64) * 257,
                                            "P6", 65535),
        "qoi_rgba": lambda img: qoi_bytes(rgba(img)),
        "tga_24": lambda img: tga_bytes(img, 2, 24),
        "tga_16": lambda img: tga_bytes(img, 2, 16),
        "tiff_none": tif(rows_per_strip=16),
        "tiff_none_mm": tif(byteorder=">"),
        "tiff_lzw": tif(compression=5, rows_per_strip=32),
        "tiff_deflate_predictor_mm": tif(compression=32946, predictor=2,
                                         byteorder=">"),
        "tiff_lzw_tiles": tif(compression=5, tile=(64, 64)),
        "tiff_deflate_planar": tif(compression=8, planar=2,
                                   rows_per_strip=64),
        "ico_bmp_32": lambda img: ico_bytes([(rgba(img), 32, None)]),
    }


# ---------------------------------------------------------------------------
# series and the command line
# ---------------------------------------------------------------------------


def write_png_series(out_dir: str, count: int, width: int, height: int,
                     seed: int = 0, strategy: str = "paeth") -> List[str]:
    """``count`` RGB PNGs ``frame.%03d.png`` (seeds ``seed``,
    ``seed + 1``, ...)."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i in range(count):
        path = os.path.join(out_dir, f"frame.{i:03d}.png")
        with open(path, "wb") as f:
            f.write(png_bytes(smooth_image(seed + i, height, width), 2, 8,
                              strategy=strategy))
        paths.append(path)
    return paths


def write_jpeg_series(out_dir: str, count: int, width: int, height: int,
                      seed: int = 0, quality: int = 75,
                      subsampling: str = "420",
                      restart_interval: int = 0, **kw) -> List[str]:
    """``count`` RGB JPEGs ``frame.%03d.jpg`` (seeds ``seed``,
    ``seed + 1``, ...): baseline, or what ``kw`` asks of ``jpeg_bytes``
    (``progressive=True``, ``factors=...``, ...)."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i in range(count):
        path = os.path.join(out_dir, f"frame.{i:03d}.jpg")
        img = smooth_image(seed + i, height, width).astype(np.uint8)
        with open(path, "wb") as f:
            f.write(jpeg_bytes(img, quality, subsampling, restart_interval,
                               **kw))
        paths.append(path)
    return paths


def write_format_series(out_dir: str, count: int, width: int, height: int,
                        seed: int = 0) -> List[str]:
    """``count`` RGB frames ``frame.%03d.img`` (seeds ``seed``,
    ``seed + 1``, ...), file ``i`` in the ``i % k``-th of the ``k``
    variants of ``format_variants``, in its order."""
    os.makedirs(out_dir, exist_ok=True)
    writers = list(format_variants().values())
    paths = []
    for i in range(count):
        path = os.path.join(out_dir, f"frame.{i:03d}.img")
        img = smooth_image(seed + i, height, width).astype(np.uint8)
        with open(path, "wb") as f:
            f.write(writers[i % len(writers)](img))
        paths.append(path)
    return paths


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out_dir")
    ap.add_argument("--count", type=int, default=16)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--format", choices=("png", "jpeg", "mixed"),
                    default="png")
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    write = {"png": write_png_series, "jpeg": write_jpeg_series,
             "mixed": write_format_series}[a.format]
    for p in write(a.out_dir, a.count, a.width, a.height, a.seed):
        print(p, os.path.getsize(p))


if __name__ == "__main__":
    main()
