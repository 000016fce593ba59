"""Baseline JPEG decoder in numpy, bit for bit what PIL gives through
libjpeg-turbo with the defaults PIL leaves as they are.

Decodes baseline and extended sequential, 8-bit, Huffman-coded files:
grey and YCbCr, at 4:4:4, 4:2:2 and 4:2:0, interleaved or one scan a
component, with or without restart markers. It follows libjpeg's
defaults step by step:

* the integer ``JDCT_ISLOW`` IDCT of ``jidctint.c`` (13-bit constants,
  two extra bits after the column pass, its output range-limited through
  libjpeg's 1024-entry post-IDCT table), run on every block at once;
* "fancy" upsampling for h2v1 and h2v2 chroma (``jdsample.c``): a
  triangle filter whose rounding bias alternates between the two output
  samples (+1/+2, +8/+7), the top and bottom rows replicated as context,
  and plain replication where a chroma plane is two samples wide or
  less, as libjpeg picks;
* the fixed-point YCbCr -> RGB tables of ``jdcolor.c`` (16 fraction
  bits, half added in the green term's table).

The Huffman decode is a Python loop over symbols with one 16-bit table
lookup a code over 32-bit windows of the entropy-coded bytes; the
coefficients are scattered into one array and everything after it is
vectorised.

Progressive, lossless, hierarchical, arithmetic-coded, 12-bit, CMYK/YCCK
(4 components) and Adobe-transform (RGB-stored) files, and sampling
other than the three above, raise :class:`NotPortedError` naming the
mode: nothing is decoded wrongly in silence.
"""
from __future__ import annotations

import re
import struct
from typing import Dict, List, Optional

import numpy as np

from ..pipeline.element import NotPortedError

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_ZZ = ZIGZAG.tolist()

# jidctint.c: CONST_BITS 13, PASS1_BITS 2, FIX(x) = round(x * 2**13)
CONST_BITS, PASS1_BITS = 13, 2
FIX_0_298631336, FIX_0_390180644, FIX_0_541196100 = 2446, 3196, 4433
FIX_0_765366865, FIX_0_899976223, FIX_1_175875602 = 6270, 7373, 9633
FIX_1_501321110, FIX_1_847759065, FIX_1_961570560 = 12299, 15137, 16069
FIX_2_053119869, FIX_2_562915447, FIX_3_072711026 = 16819, 20995, 25172


def _post_idct_table() -> np.ndarray:
    """jdmaster.c's range-limit table seen from the IDCT: an output v
    reads entry ``v & 1023``: v + 128 for v in [-128, 127], 255 above,
    0 below (values past +-512 wrap, as in libjpeg)."""
    j = np.arange(1024)
    return np.select([j < 128, j < 512, j < 896], [j + 128, 255, 0],
                     j - 896).astype(np.uint8)


_RANGE = _post_idct_table()

_SOF_REFUSED = {
    0xC2: "progressive", 0xC3: "lossless", 0xC5: "hierarchical",
    0xC6: "hierarchical progressive", 0xC7: "hierarchical lossless",
    0xC9: "arithmetic-coded", 0xCA: "arithmetic-coded progressive",
    0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-coded hierarchical",
    0xCE: "arithmetic-coded hierarchical progressive",
    0xCF: "arithmetic-coded hierarchical lossless",
    0xCC: "arithmetic-coded (DAC)"}
_SCAN_END = re.compile(rb"\xff+[^\x00\xd0-\xd7\xff]")
_RST = re.compile(rb"\xff+[\xd0-\xd7]")


class _Component:
    __slots__ = ("cid", "h", "v", "tq", "qt", "dw", "dh", "bw", "bh",
                 "coef")

    def __init__(self, cid, h, v, tq):
        self.cid, self.h, self.v, self.tq = cid, h, v, tq
        self.qt = None


def _huffman_lut(counts: List[int], symbols: bytes) -> List[int]:
    """16-bit lookup: entry ``(code length << 8) | symbol`` for every
    16-bit window that starts with a code; 0 where none does."""
    lut = np.zeros(1 << 16, np.int32)
    code, k = 0, 0
    for length, n in enumerate(counts, 1):
        for _ in range(n):
            if code >= (1 << length):
                raise ValueError("corrupt JPEG: bad Huffman table")
            start = code << (16 - length)
            lut[start:start + (1 << (16 - length))] = \
                (length << 8) | symbols[k]
            code += 1
            k += 1
        code <<= 1
    return lut.tolist()


def _windows(buf: bytes) -> List[int]:
    """Big-endian 32-bit word starting at every byte (zero past the
    end)."""
    b = np.frombuffer(buf + b"\x00" * 4, np.uint8).astype(np.uint32)
    n = len(buf) + 1
    w = (b[:n] << 24) | (b[1:n + 1] << 16) | (b[2:n + 2] << 8) | b[3:n + 3]
    return w.tolist()


def _decode_segment(buf: bytes, plan, ncomp, dc_luts, ac_luts, idxs, vals):
    """Huffman-decode the blocks of one restart interval. ``plan``:
    (component slot, flat block index) of each block in order; every
    non-zero coefficient lands in ``idxs``/``vals`` (flat index into
    the component's (blocks, 64) array, natural order)."""
    win = _windows(buf)
    pos = 0
    preds = [0] * ncomp
    zz = _ZZ
    for slot, block in plan:
        dlut, alut = dc_luts[slot], ac_luts[slot]
        ix, vx = idxs[slot], vals[slot]
        base = block * 64
        e = dlut[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
        if not e:
            raise ValueError("corrupt JPEG: bad DC code")
        pos += e >> 8
        s = e & 255
        if s:
            v = (win[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
            pos += s
            if v < (1 << (s - 1)):
                v -= (1 << s) - 1
            preds[slot] += v
        if preds[slot]:
            ix.append(base)
            vx.append(preds[slot])
        k = 1
        while k < 64:
            e = alut[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
            if not e:
                raise ValueError("corrupt JPEG: bad AC code")
            pos += e >> 8
            rs = e & 255
            s = rs & 15
            if s:
                k += rs >> 4
                if k > 63:
                    raise ValueError("corrupt JPEG: AC run past 63")
                v = (win[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
                pos += s
                if v < (1 << (s - 1)):
                    v -= (1 << s) - 1
                ix.append(base + zz[k])
                vx.append(v)
                k += 1
            elif rs == 0xF0:
                k += 16
            else:
                break
    if pos > len(buf) * 8:
        raise ValueError("corrupt JPEG: entropy-coded data is truncated")


def _idct_1d(x0, x1, x2, x3, x4, x5, x6, x7):
    """jidctint.c's 8-point butterfly on whole arrays: the 8 outputs
    before the descale."""
    z1 = (x2 + x6) * FIX_0_541196100
    tmp2 = z1 + x6 * -FIX_1_847759065
    tmp3 = z1 + x2 * FIX_0_765366865
    tmp0 = (x0 + x4) << CONST_BITS
    tmp1 = (x0 - x4) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x7, x5, x3, x1
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * FIX_1_175875602
    t0 = t0 * FIX_0_298631336
    t1 = t1 * FIX_2_053119869
    t2 = t2 * FIX_3_072711026
    t3 = t3 * FIX_1_501321110
    z1 = z1 * -FIX_0_899976223
    z2 = z2 * -FIX_2_562915447
    z3 = z3 * -FIX_1_961570560 + z5
    z4 = z4 * -FIX_0_390180644 + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    return (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)


def idct_islow(coef: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """(N, 64) quantized coefficients (natural order) and the (64,)
    quantization table -> (N, 8, 8) uint8 samples, as
    ``jpeg_idct_islow``. Its shortcuts for all-zero AC columns and rows
    give the same numbers as the full butterfly, so there are none
    here."""
    x = (coef.astype(np.int64) * qt.astype(np.int64)).reshape(-1, 8, 8)
    n1 = CONST_BITS - PASS1_BITS
    ws = np.stack(_idct_1d(*(x[:, k, :] for k in range(8))), axis=1)
    ws = (ws + (1 << (n1 - 1))) >> n1
    n2 = CONST_BITS + PASS1_BITS + 3
    out = np.stack(_idct_1d(*(ws[:, :, k] for k in range(8))), axis=2)
    out = (out + (1 << (n2 - 1))) >> n2
    return _RANGE[out & 1023]


def _fancy_h2v1(p: np.ndarray) -> np.ndarray:
    """jdsample.c h2v1_fancy_upsample over (rows, w) samples, w > 2."""
    x = p.astype(np.int32)
    out = np.empty((x.shape[0], 2 * x.shape[1]), np.int32)
    out[:, 0] = x[:, 0]
    out[:, 2::2] = (3 * x[:, 1:] + x[:, :-1] + 1) >> 2
    out[:, 1:-1:2] = (3 * x[:, :-1] + x[:, 1:] + 2) >> 2
    out[:, -1] = x[:, -1]
    return out.astype(np.uint8)


def _fancy_h2v2(p: np.ndarray) -> np.ndarray:
    """jdsample.c h2v2_fancy_upsample over (h, w) samples, w > 2: each
    output row mixes its nearer input row 3:1 with the next nearer (the
    edge rows replicated), then columns as h2v1 with biases 8 and 7."""
    x = p.astype(np.int32)
    above = np.concatenate([x[:1], x[:-1]])
    below = np.concatenate([x[1:], x[-1:]])
    cs = np.empty((2 * x.shape[0], x.shape[1]), np.int32)
    cs[0::2] = 3 * x + above
    cs[1::2] = 3 * x + below
    out = np.empty((cs.shape[0], 2 * cs.shape[1]), np.int32)
    out[:, 0] = (cs[:, 0] * 4 + 8) >> 4
    out[:, 2::2] = (3 * cs[:, 1:] + cs[:, :-1] + 8) >> 4
    out[:, 1:-1:2] = (3 * cs[:, :-1] + cs[:, 1:] + 7) >> 4
    out[:, -1] = (cs[:, -1] * 4 + 7) >> 4
    return out.astype(np.uint8)


def _upsample(p: np.ndarray, fh: int, fv: int) -> np.ndarray:
    if (fh, fv) == (1, 1):
        return p
    if (fh, fv) not in ((2, 1), (2, 2)):
        raise NotPortedError(f"JPEG chroma upsampling {fh}x{fv} is not "
                             "ported (only 4:4:4, 4:2:2 and 4:2:0)")
    if p.shape[1] <= 2:       # libjpeg falls back to replication here
        return np.repeat(np.repeat(p, fh, axis=1), fv, axis=0)
    return _fancy_h2v1(p) if fv == 1 else _fancy_h2v2(p)


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """jdcolor.c ycc_rgb_convert with its build_ycc_rgb_table tables."""
    x = np.arange(256, dtype=np.int64) - 128
    half = 1 << 15

    def fix(v):
        return int(v * 65536 + 0.5)

    cr_r = (fix(1.40200) * x + half) >> 16
    cb_b = (fix(1.77200) * x + half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + half
    y = y.astype(np.int64)
    r = y + cr_r[cr]
    g = y + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = y + cb_b[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def decode_jpeg(data: bytes) -> np.ndarray:
    """Baseline JPEG bytes -> (H, W, 3) uint8 RGB, as PIL's
    ``Image.open(...).convert("RGB")`` gives it through libjpeg-turbo."""
    data = bytes(data)
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG stream (no SOI)")
    qts: Dict[int, np.ndarray] = {}
    dc_tabs: Dict[int, List[int]] = {}
    ac_tabs: Dict[int, List[int]] = {}
    comps: List[_Component] = []
    frame = None
    restart = 0
    adobe: Optional[int] = None
    pos = 2
    while True:
        if pos >= len(data) or data[pos] != 0xFF:
            raise ValueError(f"corrupt JPEG: no marker at byte {pos}")
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data):
            raise ValueError("truncated JPEG: no EOI")
        marker = data[pos]
        pos += 1
        if marker == 0xD9:
            break
        if marker == 0xD8 or 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        if pos + 2 > len(data):
            raise ValueError("truncated JPEG segment")
        (length,) = struct.unpack_from(">H", data, pos)
        seg = data[pos + 2:pos + length]
        if len(seg) != length - 2:
            raise ValueError(f"truncated JPEG segment 0x{marker:02X}")
        pos += length
        if marker in _SOF_REFUSED:
            raise NotPortedError(f"{_SOF_REFUSED[marker]} JPEG is not "
                                 "ported (baseline sequential Huffman only)")
        if marker == 0xDB:
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                n = 128 if pq else 64
                raw = np.frombuffer(seg, ">u2" if pq else np.uint8, 64, i + 1)
                table = np.zeros(64, np.int64)
                table[ZIGZAG] = raw
                qts[tq] = table
                i += 1 + n
        elif marker == 0xC4:
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                counts = list(seg[i + 1:i + 17])
                symbols = seg[i + 17:i + 17 + sum(counts)]
                (ac_tabs if tc else dc_tabs)[th] = _huffman_lut(counts,
                                                                symbols)
                i += 17 + sum(counts)
        elif marker in (0xC0, 0xC1):
            precision, height, width, nf = struct.unpack_from(">BHHB", seg)
            if precision != 8:
                raise NotPortedError(f"{precision}-bit JPEG is not ported "
                                     "(8-bit only)")
            if nf == 4:
                raise NotPortedError("CMYK/YCCK (4-component) JPEG is not "
                                     "ported")
            if nf not in (1, 3):
                raise NotPortedError(f"{nf}-component JPEG is not ported")
            if not height or not width:
                raise NotPortedError("JPEG with a DNL-defined height is not "
                                     "ported")
            comps = [_Component(seg[6 + 3 * k], seg[7 + 3 * k] >> 4,
                                seg[7 + 3 * k] & 15, seg[8 + 3 * k])
                     for k in range(nf)]
            frame = (height, width)
            _layout(comps, height, width)
        elif marker == 0xDD:
            (restart,) = struct.unpack_from(">H", seg)
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe = seg[11]
        elif marker == 0xDA:
            if frame is None:
                raise ValueError("corrupt JPEG: SOS before SOF")
            end = _SCAN_END.search(data, pos)
            if end is None:
                raise ValueError("truncated JPEG: scan has no end marker")
            _decode_scan(seg, data[pos:end.start()], comps, qts, dc_tabs,
                         ac_tabs, restart, frame)
            pos = end.end() - 2
    if frame is None:
        raise ValueError("corrupt JPEG: no frame")
    height, width = frame
    if len(comps) == 3:
        ids = tuple(c.cid for c in comps)
        if (adobe is not None and adobe != 1) or ids == (82, 71, 66):
            raise NotPortedError("Adobe-transform (RGB-stored) JPEG is not "
                                 "ported")
    planes = []
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    for c in comps:
        if c.coef is None or c.qt is None:
            raise ValueError(f"corrupt JPEG: component {c.cid} has no scan")
        blocks = idct_islow(c.coef, c.qt)
        plane = blocks.reshape(c.bh, c.bw, 8, 8).transpose(0, 2, 1, 3)
        plane = plane.reshape(c.bh * 8, c.bw * 8)[:c.dh, :c.dw]
        if len(comps) == 3:
            if hmax % c.h or vmax % c.v:
                raise NotPortedError("JPEG sampling factors that do not "
                                     "divide the largest are not ported")
            plane = _upsample(plane, hmax // c.h, vmax // c.v)
        planes.append(plane[:height, :width])
    if len(comps) == 1:
        return np.repeat(planes[0][..., None], 3, axis=-1)
    return _ycc_to_rgb(*planes)


def _layout(comps: List[_Component], height: int, width: int) -> None:
    """Each component's real size and its block grid (padded to whole
    MCUs of an interleaved scan)."""
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    if len(comps) == 1:
        comps[0].h = comps[0].v = hmax = vmax = 1
    mcux = -(-width // (8 * hmax))
    mcuy = -(-height // (8 * vmax))
    for c in comps:
        if not (1 <= c.h <= 4 and 1 <= c.v <= 4):
            raise ValueError(f"corrupt JPEG: sampling {c.h}x{c.v}")
        c.dw = -(-width * c.h // hmax)
        c.dh = -(-height * c.v // vmax)
        c.bw, c.bh = mcux * c.h, mcuy * c.v
        c.coef = None


def _decode_scan(sos: bytes, scan: bytes, comps: List[_Component], qts,
                 dc_tabs, ac_tabs, restart: int, frame) -> None:
    ns = sos[0]
    by_id = {c.cid: c for c in comps}
    members = []
    dc_luts, ac_luts = [], []
    for k in range(ns):
        cid, tables = sos[1 + 2 * k], sos[2 + 2 * k]
        if cid not in by_id:
            raise ValueError(f"corrupt JPEG: scan names component {cid}")
        c = by_id[cid]
        td, ta = tables >> 4, tables & 15
        if td not in dc_tabs or ta not in ac_tabs:
            raise ValueError("corrupt JPEG: scan uses an undefined Huffman "
                             "table")
        if c.tq not in qts:
            raise ValueError("corrupt JPEG: component uses an undefined "
                             "quantization table")
        if c.qt is None:
            c.qt = qts[c.tq]
        members.append(c)
        dc_luts.append(dc_tabs[td])
        ac_luts.append(ac_tabs[ta])
    ss, se, a = sos[1 + 2 * ns], sos[2 + 2 * ns], sos[3 + 2 * ns]
    if (ss, se, a) != (0, 63, 0):
        raise NotPortedError("JPEG spectral selection or successive "
                             "approximation (progressive) is not ported")
    # (slot, flat block index) of every block, in coding order, a list a
    # restart interval
    if ns == 1:
        c = members[0]
        gy, gx = -(-c.dh // 8), -(-c.dw // 8)
        order = [(0, (r * c.bw + x)) for r in range(gy) for x in range(gx)]
        per_mcu = 1
    else:
        height, width = frame
        hmax = max(c.h for c in comps)
        vmax = max(c.v for c in comps)
        mcux = -(-width // (8 * hmax))
        mcuy = -(-height // (8 * vmax))
        mcu = [(slot, by * c.bw + bx)
               for slot, c in enumerate(members)
               for by in range(c.v) for bx in range(c.h)]
        per_mcu = len(mcu)
        order = []
        for my in range(mcuy):
            for mx in range(mcux):
                order += [(slot, (my * members[slot].v * members[slot].bw
                                  + mx * members[slot].h) + off)
                          for slot, off in mcu]
    segments = _RST.split(scan) if restart else [scan]
    step = restart * per_mcu if restart else len(order)
    plans = [order[i:i + step] for i in range(0, len(order), step)]
    if len(segments) < len(plans):
        raise ValueError("corrupt JPEG: fewer restart intervals than MCUs "
                         "need")
    idxs = [[] for _ in members]
    vals = [[] for _ in members]
    for plan, seg in zip(plans, segments):
        _decode_segment(seg.replace(b"\xff\x00", b"\xff"), plan, ns,
                        dc_luts, ac_luts, idxs, vals)
    for slot, c in enumerate(members):
        coef = np.zeros(c.bh * c.bw * 64, np.int32)
        coef[np.asarray(idxs[slot], np.int64)] = vals[slot]
        c.coef = coef.reshape(-1, 64)
