"""Image files for the media elements' tests, written in-process.

Neither package ships a PNG or JPEG fixture, so this module writes them:
PNGs in every colour type, bit depth, filter strategy and interlace
mode of the PNG specification, and baseline JPEGs (integer forward
DCT, the standard quantization tables scaled by a quality, the standard
Huffman tables) at 4:4:4, 4:2:2 and 4:2:0, grey or YCbCr, with optional
restart intervals. It uses the standard library (``zlib``, ``struct``)
and numpy only and imports neither ``nnstreamer_tpu`` nor
``nnstreamer_tpu_torch``, so the packages' decoders are checked against
an independent writer.

Pictures come from ``np.random.default_rng(seed)`` as smooth fields plus
noise: a coarse grid of random levels interpolated across the frame,
with a few levels of noise on every sample. Every step is integer
arithmetic over the generator's raw bytes, so a seed gives the same file
on every machine and numpy version that keeps the PCG64 bit stream.

Use::

    python3 tools/torch_image_files.py OUT_DIR [--count 16] [--width 320]
        [--height 240] [--format png|jpeg] [--seed 0]

or ``write_png_series``/``write_jpeg_series``, ``png_bytes``,
``jpeg_bytes`` and ``smooth_image`` after loading this file by path
(``importlib.util.spec_from_file_location``).
"""
from __future__ import annotations

import argparse
import os
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
# baseline JPEG
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
SUBSAMPLING = {"444": (1, 1), "422": (2, 1), "420": (2, 2)}


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


def jpeg_bytes(image: np.ndarray, quality: int = 75, subsampling: str = "420",
               restart_interval: int = 0) -> bytes:
    """A baseline JPEG of an (H, W) grey or (H, W, 3) RGB uint8 image:
    one interleaved scan, JFIF, the Annex K tables scaled to
    ``quality``, chroma averaged over each ``subsampling`` cell, a
    restart marker every ``restart_interval`` MCUs (0: none)."""
    image = np.asarray(image)
    gray = image.ndim == 2 or image.shape[-1] == 1
    planes = image.reshape(image.shape[:2] + (1,)) if gray \
        else _to_ycbcr(image)
    h, w = image.shape[:2]
    hs, vs = (1, 1) if gray else SUBSAMPLING[subsampling]
    mw, mh = 8 * hs, 8 * vs
    mcux, mcuy = -(-w // mw), -(-h // mh)
    pad = np.pad(planes.astype(np.int64),
                 ((0, mcuy * mh - h), (0, mcux * mw - w), (0, 0)), mode="edge")
    qts = quant_tables(quality)
    comps = []          # (quantized blocks on the component's grid, h, v, t)
    for ci in range(pad.shape[-1]):
        plane = pad[..., ci]
        fh, fv = (hs, vs) if ci == 0 else (1, 1)
        if ci:
            plane = plane.reshape(plane.shape[0] // vs, vs,
                                  plane.shape[1] // hs, hs)
            plane = (plane.sum((1, 3)) + hs * vs // 2) // (hs * vs)
        gy, gx = plane.shape[0] // 8, plane.shape[1] // 8
        blocks = plane.reshape(gy, 8, gx, 8).transpose(0, 2, 1, 3)
        coef = _fdct_quant(blocks.reshape(-1, 8, 8) - 128, qts[min(ci, 1)])
        comps.append((coef.reshape(gy, gx, 64), fh, fv, min(ci, 1)))
    dc = [_huff_codes(_DC_LUMA), _huff_codes(_DC_CHROMA)]
    ac = [_huff_codes(_AC_LUMA), _huff_codes(_AC_CHROMA)]
    bw = _BitWriter()
    preds = [0] * len(comps)
    n_mcu = mcux * mcuy
    for m in range(n_mcu):
        if restart_interval and m and m % restart_interval == 0:
            bw.flush()
            bw.out += bytes([0xFF, 0xD0 + (m // restart_interval - 1) % 8])
            preds = [0] * len(comps)
        my, mx = divmod(m, mcux)
        for ci, (coef, fh, fv, t) in enumerate(comps):
            for by in range(fv):
                for bx in range(fh):
                    preds[ci] = _encode_block(
                        bw, coef[my * fv + by, mx * fh + bx], preds[ci],
                        dc[t], ac[t])
    bw.flush()
    out = [b"\xff\xd8",
           _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for t, qt in enumerate(qts[:1 if gray else 2]):
        out.append(_segment(0xDB, bytes([t]) + bytes(
            qt[ZIGZAG].astype(np.uint8))))
    sof = struct.pack(">BHHB", 8, h, w, len(comps))
    for ci, (_, fh, fv, t) in enumerate(comps):
        sof += bytes([ci + 1, (fh << 4) | fv, t])
    out.append(_segment(0xC0, sof))
    for cls, specs in ((0, (_DC_LUMA, _DC_CHROMA)), (1, (_AC_LUMA, _AC_CHROMA))):
        for t, (counts, symbols) in enumerate(specs[:1 if gray else 2]):
            out.append(_segment(0xC4, bytes([(cls << 4) | t]) + bytes(counts)
                                + bytes(symbols)))
    if restart_interval:
        out.append(_segment(0xDD, struct.pack(">H", restart_interval)))
    sos = bytes([len(comps)])
    for ci, (_, _, _, t) in enumerate(comps):
        sos += bytes([ci + 1, (t << 4) | t])
    out.append(_segment(0xDA, sos + b"\x00\x3f\x00"))
    out.append(bytes(bw.out))
    out.append(b"\xff\xd9")
    return b"".join(out)


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
                      restart_interval: int = 0) -> List[str]:
    """``count`` baseline JPEGs ``frame.%03d.jpg`` (seeds ``seed``,
    ``seed + 1``, ...)."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i in range(count):
        path = os.path.join(out_dir, f"frame.{i:03d}.jpg")
        img = smooth_image(seed + i, height, width).astype(np.uint8)
        with open(path, "wb") as f:
            f.write(jpeg_bytes(img, quality, subsampling, restart_interval))
        paths.append(path)
    return paths


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out_dir")
    ap.add_argument("--count", type=int, default=16)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--format", choices=("png", "jpeg"), default="png")
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    write = write_png_series if a.format == "png" else write_jpeg_series
    for p in write(a.out_dir, a.count, a.width, a.height, a.seed):
        print(p, os.path.getsize(p))


if __name__ == "__main__":
    main()
