"""JPEG decoder in numpy, bit for bit what PIL gives through
libjpeg-turbo with the defaults PIL leaves as they are.

Decodes 8-bit files, baseline, extended sequential, progressive and
lossless, Huffman-coded (SOF0-3) or arithmetic-coded (SOF9, SOF10, with
the DAC marker's conditioning), with or without restart markers:

* one component (grey), three (YCbCr, or RGB-stored: an Adobe APP14
  marker with transform 0, or component ids ``R``, ``G``, ``B`` and no
  JFIF marker) and four (CMYK, or YCCK under Adobe transform 2), the
  colour space picked as ``jdapimin.c`` ``default_decompress_parms``
  picks it (a JFIF marker means YCbCr whatever else the file says);
* any integral sampling factors (``jdsample.c``, a component at a time,
  its ratio taken to the largest factors): "fancy" h2v1, h1v2 and h2v2
  triangle filters whose rounding bias alternates between the two
  output samples (+1/+2, +8/+7), the edge rows replicated as context,
  plain replication where an h2 plane is two samples wide or less, and
  plain replication (``int_upsample``) for every other ratio (h4v1,
  h1v4, 3x1, ...);
* progressive scans as ``jdphuff.c`` decodes them: DC first and DC
  refinement (interleaved or not), AC first over a band with EOB runs,
  and AC refinement with its correction bits, those inside an EOB run
  included; coefficients build up across scans and everything after
  the entropy decode runs once, after EOI;
* arithmetic-coded scans as ``jdarith.c`` decodes them: the QM coder of
  T.81 Annex D (Table D.3's probability states, libjpeg's floating
  cut-point C register, zeros past a segment's end), the DC statistics
  conditioned on the last difference (the DAC's L and U), the AC ones
  on the position (K), a sign at fixed probability, sequential and all
  four progressive scan kinds, statistics reset at each restart;
* lossless scans as ``jdlhuff.c`` and ``jdlossls.c`` decode them:
  predictors 1-7 over each component's samples, the first row of the
  scan and of each restart interval predicted from the left (its first
  sample from 2**(7 - Pt)), the first column from above, modulo 2**16,
  then the point transform's shift; no colour conversion (a lossless
  file is grey, RGB or CMYK: with neither marker three components mean
  RGB, and YCbCr or YCCK fails as libjpeg-turbo fails on it) and plain
  replication for every sampling ratio;
* ``jdcoefct.c``'s block smoothing, on by default: where, at EOI, some
  of the first nine AC coefficients of a component are still known only
  in part (a truncated or custom-scripted progressive file), each such
  coefficient that is still zero is estimated from the DC values of the
  block's 5x5 neighbourhood, clamped to the bits still unknown; where no
  AC coefficient is known at all the DC value is smoothed too;
* the integer ``JDCT_ISLOW`` IDCT of ``jidctint.c`` (13-bit constants,
  two extra bits after the column pass, its output range-limited through
  libjpeg's 1024-entry post-IDCT table), run on every block at once;
* the fixed-point YCbCr -> RGB tables of ``jdcolor.c`` (16 fraction
  bits, half added in the green term's table), its YCCK -> CMYK, then
  what PIL does with CMYK: it reads the four channels inverted
  ("CMYK;I", whatever the Adobe marker says) and ``convert("RGB")``
  applies Pillow's ``cmyk2rgb``.

The Huffman decode is a Python loop over symbols with one 16-bit table
lookup a code over 32-bit windows of the entropy-coded bytes; everything
after it is vectorised.

Still refused with :class:`NotPortedError`, by name: 12-bit samples
(PIL cannot open such a file either), a DNL-defined height (PIL fails
on it too), hierarchical files (SOF5-7, SOF13-15: libjpeg has no
decoder for them), arithmetic-coded lossless files (SOF11), a lossless
restart interval that is not whole MCU rows, and component counts
other than 1, 3 and 4.
Sampling factors whose ratio to the largest is not integral raise
``ValueError``, as libjpeg-turbo refuses them
(``JERR_FRACT_SAMPLE_NOTIMPL``), and so do an MCU of more than 10 blocks
and a lossless file whose colour would need converting. Nothing is
decoded wrongly in silence.
"""
from __future__ import annotations

import re
import struct
from typing import Dict, List, Optional

import numpy as np

from ..pipeline.element import NotPortedError
from .modes import cmyk_to_rgb

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

# SOFn -> (process, arithmetic-coded)
_SOF_DECODED = {0xC0: ("sequential", False), 0xC1: ("sequential", False),
                0xC2: ("progressive", False), 0xC3: ("lossless", False),
                0xC9: ("sequential", True), 0xCA: ("progressive", True)}
_SOF_REFUSED = {
    0xC5: "hierarchical",
    0xC6: "hierarchical progressive", 0xC7: "hierarchical lossless",
    0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-coded hierarchical",
    0xCE: "arithmetic-coded hierarchical progressive",
    0xCF: "arithmetic-coded hierarchical lossless"}
_SCAN_END = re.compile(rb"\xff+[^\x00\xd0-\xd7\xff]")
_RST = re.compile(rb"\xff+[\xd0-\xd7]")


# ITU T.81 Table D.3, the QM coder's probability estimation: (Qe,
# Next_Index_LPS, Next_Index_MPS, Switch_MPS) a state, and state 113 the
# fixed probability 0.5. Packed as libjpeg packs it: Qe << 16 |
# Next_Index_MPS << 8 | Switch_MPS << 7 | Next_Index_LPS
_QE_TABLE = [
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
_QE = [(q << 16) | (nm << 8) | (sw << 7) | nl for q, nl, nm, sw in _QE_TABLE]


class _Component:
    __slots__ = ("cid", "h", "v", "tq", "qt", "dw", "dh", "bw", "bh",
                 "coef", "bits", "predictor", "pt", "first_rows")

    def __init__(self, cid, h, v, tq):
        self.cid, self.h, self.v, self.tq = cid, h, v, tq
        self.qt = None


class _Frame:
    __slots__ = ("height", "width", "comps", "mode", "arith", "mcux",
                 "mcuy", "jfif", "adobe")


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
    """Huffman-decode the blocks of one restart interval of a sequential
    scan. ``plan``: (component slot, flat block index) of each block in
    order; every non-zero coefficient lands in ``idxs``/``vals`` (flat
    index into the component's (blocks, 64) array, natural order)."""
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


def _decode_dc_pass(buf: bytes, plan, ncomp, dc_luts, coefs, ah, al):
    """One restart interval of a progressive DC scan (jdphuff.c
    decode_mcu_DC_first / decode_mcu_DC_refine) into the components'
    flat coefficient lists ``coefs``."""
    win = _windows(buf)
    pos = 0
    if ah:
        p1 = 1 << al
        for slot, block in plan:
            if (win[pos >> 3] >> (31 - (pos & 7))) & 1:
                coefs[slot][block * 64] |= p1
            pos += 1
    else:
        preds = [0] * ncomp
        for slot, block in plan:
            e = dc_luts[slot][(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
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
            coefs[slot][block * 64] = preds[slot] << al
    if pos > len(buf) * 8:
        raise ValueError("corrupt JPEG: entropy-coded data is truncated")


def _decode_ac_first(buf: bytes, plan, lut, co, ss, se, al):
    """One restart interval of a progressive AC first scan (jdphuff.c
    decode_mcu_AC_first): the band ``ss..se`` of each block, shifted up
    by ``al``, with end-of-band runs."""
    win = _windows(buf)
    pos = 0
    zz = _ZZ
    eobrun = 0
    for _, block in plan:
        if eobrun:
            eobrun -= 1
            continue
        base = block * 64
        k = ss
        while k <= se:
            e = lut[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
            if not e:
                raise ValueError("corrupt JPEG: bad AC code")
            pos += e >> 8
            r = (e >> 4) & 15
            s = e & 15
            if s:
                k += r
                if k > se:
                    raise ValueError("corrupt JPEG: AC run past the band")
                v = (win[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
                pos += s
                if v < (1 << (s - 1)):
                    v -= (1 << s) - 1
                co[base + zz[k]] = v << al
                k += 1
            elif r == 15:
                k += 16
            else:
                eobrun = 1 << r
                if r:
                    eobrun += (win[pos >> 3] >> (32 - (pos & 7) - r)) \
                        & ((1 << r) - 1)
                    pos += r
                eobrun -= 1
                break
    if pos > len(buf) * 8:
        raise ValueError("corrupt JPEG: entropy-coded data is truncated")


def _decode_ac_refine(buf: bytes, plan, lut, co, ss, se, al):
    """One restart interval of a progressive AC refinement scan
    (jdphuff.c decode_mcu_AC_refine): a new coefficient of magnitude
    ``1 << al`` a symbol, and one correction bit for every coefficient
    already non-zero that the symbol's zero run passes over, or that an
    end-of-band run covers."""
    win = _windows(buf)
    pos = 0
    zz = _ZZ
    p1 = 1 << al
    eobrun = 0
    for _, block in plan:
        base = block * 64
        k = ss
        if not eobrun:
            while k <= se:
                e = lut[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                if not e:
                    raise ValueError("corrupt JPEG: bad AC code")
                pos += e >> 8
                r = (e >> 4) & 15
                s = e & 15
                if s:
                    s = p1 if (win[pos >> 3] >> (31 - (pos & 7))) & 1 else -p1
                    pos += 1
                elif r != 15:
                    eobrun = 1 << r
                    if r:
                        eobrun += (win[pos >> 3] >> (32 - (pos & 7) - r)) \
                            & ((1 << r) - 1)
                        pos += r
                    break
                while k <= se:
                    i = base + zz[k]
                    c = co[i]
                    if c:
                        if (win[pos >> 3] >> (31 - (pos & 7))) & 1 \
                                and not c & p1:
                            co[i] = c + p1 if c >= 0 else c - p1
                        pos += 1
                    else:
                        r -= 1
                        if r < 0:
                            break
                    k += 1
                if s:
                    if k > se:
                        raise ValueError("corrupt JPEG: AC run past the "
                                         "band")
                    co[base + zz[k]] = s
                k += 1
        if eobrun:
            while k <= se:
                i = base + zz[k]
                c = co[i]
                if c:
                    if (win[pos >> 3] >> (31 - (pos & 7))) & 1 \
                            and not c & p1:
                        co[i] = c + p1 if c >= 0 else c - p1
                    pos += 1
                k += 1
            eobrun -= 1
    if pos > len(buf) * 8:
        raise ValueError("corrupt JPEG: entropy-coded data is truncated")


class _ArithDecoder:
    """jdarith.c's QM decoder (Annex D.2 with libjpeg's floating
    cut-point C register) over one restart interval's bytes, zeros past
    their end as at a marker."""
    __slots__ = ("buf", "pos", "c", "a", "ct")

    def __init__(self, buf: bytes):
        self.buf, self.pos = buf, 0
        self.c, self.a, self.ct = 0, 0, -16

    def decode(self, st: List[int], i: int) -> int:
        """One binary decision with the statistics bin ``st[i]``."""
        a, c, ct = self.a, self.c, self.ct
        while a < 0x8000:
            ct -= 1
            if ct < 0:
                if self.pos < len(self.buf):
                    data = self.buf[self.pos]
                    self.pos += 1
                else:
                    data = 0
                c = (c << 8) | data
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:
                        a = 0x8000
            a <<= 1
        sv = st[i]
        qe = _QE[sv & 0x7F]
        nl, nm, qe = qe & 0xFF, (qe >> 8) & 0xFF, qe >> 16
        a -= qe
        temp = a << ct
        if c >= temp:
            c -= temp
            if a < qe:
                st[i] = (sv & 0x80) ^ nm
            else:
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            a = qe
        elif a < 0x8000:
            if a < qe:
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            else:
                st[i] = (sv & 0x80) ^ nm
        self.a, self.c, self.ct = a, c, ct
        return sv >> 7


def _arith_dc(dec, st, ctx, cond):
    """Figure F.19 with F.1.4.4.1's conditioning: (DC difference, the
    next block's context) from statistics area ``st``."""
    if not dec.decode(st, ctx):
        return 0, 0
    sign = dec.decode(st, ctx + 1)
    i = ctx + 2 + sign
    m = dec.decode(st, i)
    if m:
        i = 20
        while dec.decode(st, i):
            m <<= 1
            if m == 0x8000:
                raise ValueError("corrupt JPEG: arithmetic magnitude "
                                 "overflow")
            i += 1
    lo, hi = cond
    if m < (1 << lo) >> 1:
        nxt = 0
    elif m > (1 << hi) >> 1:
        nxt = 12 + 4 * sign
    else:
        nxt = 4 + 4 * sign
    v = m
    i += 14
    m >>= 1
    while m:
        if dec.decode(st, i):
            v |= m
        m >>= 1
    v += 1
    return (-v if sign else v), nxt


def _arith_ac_value(dec, st, i, k, kx, fixed):
    """Figures F.21-F.24 for the AC coefficient at ``k``: its sign (fixed
    probability), magnitude category and bits."""
    sign = dec.decode(fixed, 0)
    i += 2
    m = dec.decode(st, i)
    if m and dec.decode(st, i):
        m <<= 1
        i = 189 if k <= kx else 217
        while dec.decode(st, i):
            m <<= 1
            if m == 0x8000:
                raise ValueError("corrupt JPEG: arithmetic magnitude "
                                 "overflow")
            i += 1
    v = m
    i += 14
    m >>= 1
    while m:
        if dec.decode(st, i):
            v |= m
        m >>= 1
    v += 1
    return -v if sign else v


def _decode_arith_segment(buf, plan, members, ss, se, ah, al, sequential,
                          dc_cond, ac_cond, coefs, idxs, vals):
    """One restart interval of an arithmetic-coded scan (jdarith.c),
    statistics and predictions fresh: sequential blocks into
    ``idxs``/``vals`` as _decode_segment does, progressive ones into the
    flat coefficient lists ``coefs``."""
    dec = _ArithDecoder(buf)
    zz = _ZZ
    fixed = [113]
    dc_st = {t: [0] * 64 for t in dc_cond}
    ac_st = {t: [0] * 256 for t in ac_cond}
    last = [0] * len(members)
    ctx = [0] * len(members)
    p1 = 1 << al
    for slot, block in plan:
        td, ta = members[slot]
        base = block * 64
        if sequential or (ss == 0 and ah == 0):
            diff, ctx[slot] = _arith_dc(dec, dc_st[td], ctx[slot],
                                        dc_cond[td])
            if sequential:
                last[slot] = (last[slot] + diff) & 0xFFFF
                dc = last[slot] - 65536 if last[slot] >= 32768 else last[slot]
                if dc:
                    idxs[slot].append(base)
                    vals[slot].append(dc)
            else:
                last[slot] += diff
                coefs[slot][base] = last[slot] << al
        elif ss == 0:
            if dec.decode(fixed, 0):
                coefs[slot][base] |= p1
        if sequential:
            k, st, kx = 1, ac_st[ta], ac_cond[ta]
            while k <= 63:
                i = 3 * (k - 1)
                if dec.decode(st, i):
                    break
                while not dec.decode(st, i + 1):
                    i += 3
                    k += 1
                    if k > 63:
                        raise ValueError("corrupt JPEG: arithmetic AC run "
                                         "past 63")
                idxs[slot].append(base + zz[k])
                vals[slot].append(_arith_ac_value(dec, st, i, k, kx, fixed))
                k += 1
        elif ss and ah == 0:
            k, st, kx, co = ss, ac_st[ta], ac_cond[ta], coefs[slot]
            while k <= se:
                i = 3 * (k - 1)
                if dec.decode(st, i):
                    break
                while not dec.decode(st, i + 1):
                    i += 3
                    k += 1
                    if k > se:
                        raise ValueError("corrupt JPEG: arithmetic AC run "
                                         "past the band")
                co[base + zz[k]] = _arith_ac_value(dec, st, i, k, kx,
                                                   fixed) * p1
                k += 1
        elif ss:
            st, co = ac_st[ta], coefs[slot]
            kex = se
            while kex > 0 and not co[base + zz[kex]]:
                kex -= 1
            k = ss
            while k <= se:
                i = 3 * (k - 1)
                if k > kex and dec.decode(st, i):
                    break
                while True:
                    at = base + zz[k]
                    c = co[at]
                    if c:
                        if dec.decode(st, i + 2):
                            co[at] = c - p1 if c < 0 else c + p1
                        break
                    if dec.decode(st, i + 1):
                        co[at] = -p1 if dec.decode(fixed, 0) else p1
                        break
                    i += 3
                    k += 1
                    if k > se:
                        raise ValueError("corrupt JPEG: arithmetic AC run "
                                         "past the band")
                k += 1


def _decode_lossless_segment(buf: bytes, plan, dc_luts, diffs):
    """One restart interval of a lossless scan (jdlhuff.c): each sample's
    difference coded as a DC difference is, category 16 meaning 32768
    with no extra bits, into the components' flat ``diffs`` lists."""
    win = _windows(buf)
    pos = 0
    for slot, at in plan:
        e = dc_luts[slot][(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
        if not e:
            raise ValueError("corrupt JPEG: bad lossless difference code")
        pos += e >> 8
        s = e & 255
        if s == 16:
            v = 32768
        elif s:
            v = (win[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
            pos += s
            if v < (1 << (s - 1)):
                v -= (1 << s) - 1
        else:
            v = 0
        diffs[slot][at] = v
    if pos > len(buf) * 8:
        raise ValueError("corrupt JPEG: entropy-coded data is truncated")


def _undifference(d: np.ndarray, predictor: int, pt: int,
                  first_rows) -> np.ndarray:
    """jdlossls.c: (h, w) differences -> samples, each modulo 2**16 over
    its prediction: a first row (of the scan or of a restart interval)
    from its left neighbour, its first sample from 2**(7 - pt); a first
    column from above; the rest by ``predictor`` from the left (Ra), the
    one above (Rb) and the one above-left (Rc). Predictors 1-5 are
    linear in Ra, so a row is a running sum; 6 and 7 go a sample at a
    time. Then the point transform's shift and the cast to 8 bits."""
    h, w = d.shape
    d = d.astype(np.int64)
    x = np.empty((h, w), np.int64)
    firsts = set(first_rows)
    for r in range(h):
        if r in firsts:
            x[r] = ((1 << (7 - pt)) + np.cumsum(d[r])) & 0xFFFF
            continue
        rb = x[r - 1]
        x0 = (d[r, 0] + rb[0]) & 0xFFFF
        if predictor == 2:
            x[r, 1:] = (rb[1:] + d[r, 1:]) & 0xFFFF
        elif predictor == 3:
            x[r, 1:] = (rb[:-1] + d[r, 1:]) & 0xFFFF
        elif predictor in (1, 4, 5):
            step = d[r, 1:]
            if predictor == 4:
                step = step + rb[1:] - rb[:-1]
            elif predictor == 5:
                step = step + ((rb[1:] - rb[:-1]) >> 1)
            x[r, 1:] = (x0 + np.cumsum(step)) & 0xFFFF
        else:
            row, ra = d[r].tolist(), x0
            above = rb.tolist()
            for i in range(1, w):
                b, c = above[i], above[i - 1]
                p = b + ((ra - c) >> 1) if predictor == 6 else (ra + b) >> 1
                ra = (row[i] + p) & 0xFFFF
                row[i] = ra
            x[r] = row
        x[r, 0] = x0
    return ((x << pt) & 0xFF).astype(np.uint8)


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


# -- block smoothing (jdcoefct.c decompress_smooth_data) ----------------------

def _weights(spec: Dict[int, int]) -> np.ndarray:
    """5x5 weights over the DC values DC01..DC25 of jdcoefct.c: rows two
    above .. two below the block, columns two left .. two right."""
    w = np.zeros(25, np.int64)
    for k, v in spec.items():
        w[k - 1] = v
    return w.reshape(5, 5)


# (natural position, zigzag index, weights with some AC known, weights
# with none known); the last five are estimated only when none is known
_SMOOTH_AC = [
    (1, 1, {11: -7, 12: 50, 14: -50, 15: 7},
     {1: -1, 2: -1, 4: 1, 5: 1, 6: -3, 7: 13, 9: -13, 10: 3, 11: -3, 12: 38,
      14: -38, 15: 3, 16: -3, 17: 13, 19: -13, 20: 3, 21: -1, 22: -1, 24: 1,
      25: 1}),
    (8, 2, {3: -7, 8: 50, 18: -50, 23: 7},
     {1: -1, 2: -3, 3: -3, 4: -3, 5: -1, 6: -1, 7: 13, 8: 38, 9: 13, 10: -1,
      16: 1, 17: -13, 18: -38, 19: -13, 20: 1, 21: 1, 22: 3, 23: 3, 24: 3,
      25: 1}),
    (16, 3, {3: -1, 8: 13, 13: -24, 18: 13, 23: -1},
     {3: 1, 7: 2, 8: 7, 9: 2, 12: -5, 13: -14, 14: -5, 17: 2, 18: 7, 19: 2,
      23: 1}),
    (9, 4, {2: -1, 4: 1, 6: -1, 7: 10, 9: -10, 10: 1, 16: 1, 17: -10, 19: 10,
            20: -1, 22: 1, 24: -1},
     {1: -1, 5: 1, 7: 9, 9: -9, 17: -9, 19: 9, 21: 1, 25: -1}),
    (2, 5, {11: -1, 12: 13, 13: -24, 14: 13, 15: -1},
     {7: 2, 8: -5, 9: 2, 11: 1, 12: 7, 13: -14, 14: 7, 15: 1, 17: 2, 18: -5,
      19: 2}),
    (3, 6, None, {7: 1, 9: -1, 12: 2, 14: -2, 17: 1, 19: -1}),
    (10, 7, None, {7: 1, 8: -3, 9: 1, 17: -1, 18: 3, 19: -1}),
    (17, 8, None, {7: 1, 9: -1, 12: -3, 14: 3, 17: 1, 19: -1}),
    (24, 9, None, {7: 1, 8: 2, 9: 1, 17: -1, 18: -2, 19: -1})]
_SMOOTH_AC = [(pos, zi, None if a is None else _weights(a), _weights(b))
              for pos, zi, a, b in _SMOOTH_AC]
_SMOOTH_DC = _weights({
    1: -2, 2: -6, 3: -8, 4: -6, 5: -2, 6: -6, 7: 6, 8: 42, 9: 6, 10: -6,
    11: -8, 12: 42, 13: 152, 14: 42, 15: -8, 16: -6, 17: 6, 18: 42, 19: 6,
    20: -6, 21: -2, 22: -6, 23: -8, 24: -6, 25: -2})
_SMOOTH_Q = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24)


def _smooth_rows(hb: int, v: int, total: int) -> np.ndarray:
    """(hb, 5) block rows read for the rows two above .. two below each
    real block row, as decompress_smooth_data picks them an iMCU row at
    a time. It numbers a row as (iMCU row) x (rows this iMCU row) + row
    and the image's rows as (rows this iMCU row) x (iMCU rows), so in a
    last iMCU row shorter than the others a row near the top can see
    no row two above and repeats the one above (the oracle agrees)."""
    out = np.empty((hb, 5), np.int64)
    last = hb % v or v
    for r in range(hb):
        i, b = divmod(r, v)
        rows = v if i < total - 1 else last
        at, n = i * rows + b, rows * total
        prev = r - 1 if at > 0 else r
        pprev = r - 2 if at > 1 else prev
        nxt = r + 1 if at < n - 1 else r
        nnxt = r + 2 if at < n - 2 else nxt
        out[r] = (pprev, prev, r, nxt, nnxt)
    return out


def _smooth_cols(wb: int) -> np.ndarray:
    """(wb, 5) block columns read for the columns two left .. two right
    of each block: decompress_smooth_data's sliding registers repeat
    the edge columns."""
    return np.clip(np.arange(wb)[:, None] + np.arange(-2, 3), 0, wb - 1)


def _smoothing_on(comps: List[_Component]) -> bool:
    """jdcoefct.c smoothing_ok: every component has a quantization table
    (with its first ten entries non-zero) and some DC bits, and some
    component still lacks bits of one of its first nine AC
    coefficients."""
    useful = False
    for c in comps:
        if c.qt is None or not c.qt[list(_SMOOTH_Q)].all() or c.bits[0] < 0:
            return False
        useful = useful or any(c.bits[1:10])
    return useful


def _smooth(coef: np.ndarray, c: _Component, total: int) -> np.ndarray:
    """The coefficients decompress_smooth_data hands the IDCT for the
    real blocks of ``c`` ((bh, bw, 64) in, (hb, wb, 64) out)."""
    hb, wb = -(-c.dh // 8), -(-c.dw // 8)
    rows, cols = _smooth_rows(hb, c.v, total), _smooth_cols(wb)
    dc = coef[..., 0]
    # (5, 5, hb, wb): DC01..DC25 around every real block
    grid = dc[rows.T[:, None, :, None], cols.T[None, :, None, :]]
    bits = c.bits
    change_dc = all(b == -1 for b in bits[1:10])
    q = c.qt
    out = coef[:hb, :wb].copy()
    for pos, zi, some, none in _SMOOTH_AC:
        al = bits[zi]
        if some is None and not change_dc or al == 0:
            continue
        w = none if change_dc else some
        num = q[0] * np.einsum("ab,abij->ij", w, grid)
        qq = int(q[pos])
        pred = ((qq << 7) + np.abs(num)) // (qq << 8)
        if al > 0:
            pred = np.minimum(pred, (1 << al) - 1)
        pred = np.where(num >= 0, pred, -pred)
        at = out[..., pos]
        out[..., pos] = np.where(at == 0, pred, at)
    if change_dc:
        num = q[0] * np.einsum("ab,abij->ij", _SMOOTH_DC, grid)
        qq = int(q[0])
        pred = ((qq << 7) + np.abs(num)) // (qq << 8)
        out[..., 0] = np.where(num >= 0, pred, -pred)
    return out


# -- upsampling and colour ----------------------------------------------------

def _fancy_h2v1(p: np.ndarray) -> np.ndarray:
    """jdsample.c h2v1_fancy_upsample over (rows, w) samples, w > 2."""
    x = p.astype(np.int32)
    out = np.empty((x.shape[0], 2 * x.shape[1]), np.int32)
    out[:, 0] = x[:, 0]
    out[:, 2::2] = (3 * x[:, 1:] + x[:, :-1] + 1) >> 2
    out[:, 1:-1:2] = (3 * x[:, :-1] + x[:, 1:] + 2) >> 2
    out[:, -1] = x[:, -1]
    return out.astype(np.uint8)


def _fancy_h1v2(p: np.ndarray) -> np.ndarray:
    """jdsample.c h1v2_fancy_upsample over (h, w) samples: each output
    row mixes its nearer input row 3:1 with the next nearer (the edge
    rows replicated), biases 1 and 2."""
    x = p.astype(np.int32)
    above = np.concatenate([x[:1], x[:-1]])
    below = np.concatenate([x[1:], x[-1:]])
    out = np.empty((2 * x.shape[0], x.shape[1]), np.int32)
    out[0::2] = (3 * x + above + 1) >> 2
    out[1::2] = (3 * x + below + 2) >> 2
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
    """jinit_upsampler's choice for a component ``fh`` x ``fv`` times
    smaller than the largest factors: fancy h2v1, h1v2 and h2v2 (the h2
    filters only on planes wider than two samples), else replication."""
    if (fh, fv) == (1, 1):
        return p
    if (fh, fv) == (1, 2):
        return _fancy_h1v2(p)
    if fh == 2 and fv in (1, 2) and p.shape[1] > 2:
        return _fancy_h2v1(p) if fv == 1 else _fancy_h2v2(p)
    return np.repeat(np.repeat(p, fh, axis=1), fv, axis=0)


def _ycc_tables():
    """jdcolor.c build_ycc_rgb_table: Cr->R, Cb->B, and the two green
    terms (the Cb one with the rounding half) at 16 fraction bits."""
    x = np.arange(256, dtype=np.int64) - 128
    half = 1 << 15

    def fix(v):
        return int(v * 65536 + 0.5)

    return ((fix(1.40200) * x + half) >> 16, (fix(1.77200) * x + half) >> 16,
            -fix(0.71414) * x, -fix(0.34414) * x + half)


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """jdcolor.c ycc_rgb_convert: (R, G, B) as int64, not yet
    range-limited."""
    cr_r, cb_b, cr_g, cb_g = _ycc_tables()
    y = y.astype(np.int64)
    return np.stack([y + cr_r[cr], y + ((cb_g[cb] + cr_g[cr]) >> 16),
                     y + cb_b[cb]], -1)


def _cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """What PIL makes of libjpeg's (H, W, 4) CMYK output: it reads it
    inverted ("CMYK;I"), then ``convert("RGB")`` is Pillow's cmyk2rgb."""
    return cmyk_to_rgb(255 - cmyk.astype(np.int64))


def _color_space(nf: int, jfif: bool, adobe: Optional[int], ids,
                 lossless: bool = False) -> str:
    """jdapimin.c default_decompress_parms: the colour space a 3- or
    4-component file is taken to hold (three components with neither
    marker: RGB for ids R, G, B, or for any ids in a lossless file)."""
    if nf == 3:
        if jfif:
            return "YCbCr"
        if adobe is not None:
            return "RGB" if adobe == 0 else "YCbCr"
        return "RGB" if tuple(ids) == (82, 71, 66) or lossless else "YCbCr"
    if nf == 4:
        return "CMYK" if adobe is None or adobe == 0 else "YCCK"
    return "grey"


# -- the file -----------------------------------------------------------------

def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> (H, W, 3) uint8 RGB, as PIL's
    ``Image.open(...).convert("RGB")`` gives it through libjpeg-turbo."""
    frame = _read(data)
    return _output(frame, _color_space(len(frame.comps), frame.jfif,
                                       frame.adobe,
                                       [c.cid for c in frame.comps],
                                       frame.mode == "lossless"))


def _read(data: bytes) -> _Frame:
    """Every marker segment and scan up to EOI: the frame with its
    components' coefficients and the markers that pick the colour
    space."""
    data = bytes(data)
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG stream (no SOI)")
    qts: Dict[int, np.ndarray] = {}
    dc_tabs: Dict[int, List[int]] = {}
    ac_tabs: Dict[int, List[int]] = {}
    frame: Optional[_Frame] = None
    restart = 0
    # arithmetic conditioning a table (DAC): DC (L, U), AC K
    dc_cond = {t: (0, 1) for t in range(4)}
    ac_cond = {t: 5 for t in range(4)}
    adobe: Optional[int] = None
    jfif = False
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
                                 "ported (8-bit sequential and "
                                 "progressive, Huffman or arithmetic, and "
                                 "Huffman lossless only)")
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
        elif marker in _SOF_DECODED:
            frame = _start_frame(seg, *_SOF_DECODED[marker])
        elif marker == 0xCC:
            for i in range(0, len(seg) - 1, 2):
                tc, tb, val = seg[i] >> 4, seg[i] & 15, seg[i + 1]
                if tb > 3 or tc > 1 or (not tc and (val & 15) > val >> 4):
                    raise ValueError(f"corrupt JPEG: DAC {seg[i]:02X} "
                                     f"{val:02X}")
                if tc:
                    ac_cond[tb] = val
                else:
                    dc_cond[tb] = (val & 15, val >> 4)
        elif marker == 0xDD:
            (restart,) = struct.unpack_from(">H", seg)
        elif marker == 0xE0 and seg[:5] == b"JFIF\x00" and len(seg) >= 14:
            jfif = True
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe = seg[11]
        elif marker == 0xDA:
            if frame is None:
                raise ValueError("corrupt JPEG: SOS before SOF")
            end = _SCAN_END.search(data, pos)
            if end is None:
                raise ValueError("truncated JPEG: scan has no end marker")
            _decode_scan(seg, data[pos:end.start()], frame, qts,
                         (dc_cond, ac_cond) if frame.arith else
                         (dc_tabs, ac_tabs), restart)
            pos = end.end() - 2
    if frame is None:
        raise ValueError("corrupt JPEG: no frame")
    frame.jfif, frame.adobe = jfif, adobe
    return frame


def _start_frame(seg: bytes, mode: str, arith: bool) -> _Frame:
    """The SOF segment: each component's real size and its block grid
    (padded to whole MCUs of an interleaved scan)."""
    precision, height, width, nf = struct.unpack_from(">BHHB", seg)
    if precision != 8:
        raise NotPortedError(f"{precision}-bit JPEG is not ported (8-bit "
                             "only; PIL cannot open it either)")
    if nf not in (1, 3, 4):
        raise NotPortedError(f"{nf}-component JPEG is not ported")
    if not height or not width:
        raise NotPortedError("JPEG with a DNL-defined height is not ported "
                             "(PIL cannot decode it either)")
    comps = [_Component(seg[6 + 3 * k], seg[7 + 3 * k] >> 4,
                        seg[7 + 3 * k] & 15, seg[8 + 3 * k])
             for k in range(nf)]
    for c in comps:
        if not (1 <= c.h <= 4 and 1 <= c.v <= 4):
            raise ValueError(f"corrupt JPEG: sampling {c.h}x{c.v}")
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    for c in comps:
        if hmax % c.h or vmax % c.v:
            raise ValueError(
                f"JPEG sampling {c.h}x{c.v} of component {c.cid} is not an "
                f"integral fraction of the largest factors {hmax}x{vmax}: "
                "libjpeg-turbo refuses it (JERR_FRACT_SAMPLE_NOTIMPL)")
    f = _Frame()
    f.height, f.width, f.comps, f.mode = height, width, comps, mode
    f.arith = arith
    # a lossless "block" is one sample
    unit = 1 if mode == "lossless" else 8
    f.mcux = -(-width // (unit * hmax))
    f.mcuy = -(-height // (unit * vmax))
    for c in comps:
        c.dw = -(-width * c.h // hmax)
        c.dh = -(-height * c.v // vmax)
        c.bw, c.bh = f.mcux * c.h, f.mcuy * c.v
        c.coef = None
        if mode == "progressive":
            c.coef = [0] * (c.bw * c.bh * 64)
        c.bits = [-1] * 64
    return f


def _decode_scan(sos: bytes, scan: bytes, frame: _Frame, qts, tables,
                 restart: int) -> None:
    """One scan's coefficients (or lossless differences) into its
    components. ``tables``: the Huffman lookups (DC, AC) a table id, or
    for an arithmetic-coded frame the DAC conditioning (DC, AC)."""
    dc_tabs, ac_tabs = tables
    ns = sos[0]
    by_id = {c.cid: c for c in frame.comps}
    ss, se, a = sos[1 + 2 * ns], sos[2 + 2 * ns], sos[3 + 2 * ns]
    ah, al = a >> 4, a & 15
    prog = frame.mode == "progressive"
    lossless = frame.mode == "lossless"
    if lossless and not (1 <= ss <= 7 and al < 8):
        raise ValueError(f"corrupt JPEG: lossless predictor {ss}, point "
                         f"transform {al}")
    if prog and (ss > se or se > 63 or (ss == 0) != (se == 0)
                 or (ss and ns != 1) or (ah and al != ah - 1) or al > 13):
        raise ValueError(f"corrupt JPEG: bad progression (Ss {ss}, Se "
                         f"{se}, Ah {ah}, Al {al}, {ns} components)")
    # the tables this scan reads: DC for a sequential scan or a first DC
    # scan, AC for a sequential scan or any AC scan
    need_dc = not prog or (ss == 0 and ah == 0)
    need_ac = (not prog and not lossless) or (prog and ss > 0)
    members, dc_luts, ac_luts = [], [], []
    for k in range(ns):
        cid, tables = sos[1 + 2 * k], sos[2 + 2 * k]
        if cid not in by_id:
            raise ValueError(f"corrupt JPEG: scan names component {cid}")
        c = by_id[cid]
        td, ta = tables >> 4, tables & 15
        if (need_dc and td not in dc_tabs) or (need_ac and ta not in ac_tabs):
            raise ValueError("corrupt JPEG: scan uses an undefined "
                             "entropy-coding table")
        if lossless:
            pass
        elif c.tq not in qts:
            raise ValueError("corrupt JPEG: component uses an undefined "
                             "quantization table")
        elif c.qt is None:
            c.qt = qts[c.tq]
        members.append(c)
        dc_luts.append(td if frame.arith else dc_tabs.get(td))
        ac_luts.append(ta if frame.arith else ac_tabs.get(ta))
    # (slot, flat block index) of every block, in coding order: a
    # one-component scan covers the component's real block grid, an
    # interleaved one whole MCUs
    unit = 1 if lossless else 8
    if ns == 1:
        c = members[0]
        gy, gx = -(-c.dh // unit), -(-c.dw // unit)
        order = [(0, (r * c.bw + x)) for r in range(gy) for x in range(gx)]
        per_mcu = 1
    else:
        mcu = [(slot, by * c.bw + bx)
               for slot, c in enumerate(members)
               for by in range(c.v) for bx in range(c.h)]
        per_mcu = len(mcu)
        if per_mcu > 10:
            raise ValueError(f"corrupt JPEG: {per_mcu} blocks in an MCU "
                             "(at most 10)")
        order = []
        for my in range(frame.mcuy):
            for mx in range(frame.mcux):
                order += [(slot, (my * members[slot].v * members[slot].bw
                                  + mx * members[slot].h) + off)
                          for slot, off in mcu]
    segments = _RST.split(scan) if restart else [scan]
    step = restart * per_mcu if restart else len(order)
    plans = [order[i:i + step] for i in range(0, len(order), step)]
    if len(segments) < len(plans):
        raise ValueError("corrupt JPEG: fewer restart intervals than MCUs "
                         "need")
    segments = [seg.replace(b"\xff\x00", b"\xff") for seg in segments]
    if lossless:
        _lossless_scan(members, plans, segments, dc_luts, ss, al, restart,
                       gx if ns == 1 else frame.mcux)
        return
    idxs = [[] for _ in members]
    vals = [[] for _ in members]
    coefs = [c.coef for c in members]
    for plan, seg in zip(plans, segments):
        if frame.arith:
            _decode_arith_segment(seg, plan, list(zip(dc_luts, ac_luts)), ss,
                                  se, ah, al, not prog, dc_tabs, ac_tabs,
                                  coefs, idxs, vals)
        elif not prog:
            _decode_segment(seg, plan, ns, dc_luts, ac_luts, idxs, vals)
        elif ss == 0:
            _decode_dc_pass(seg, plan, ns, dc_luts, coefs, ah, al)
        elif ah == 0:
            _decode_ac_first(seg, plan, ac_luts[0], coefs[0], ss, se, al)
        else:
            _decode_ac_refine(seg, plan, ac_luts[0], coefs[0], ss, se, al)
    if prog:
        for c in members:
            c.bits[ss:se + 1] = [al] * (se + 1 - ss)
        return
    for slot, c in enumerate(members):
        coef = np.zeros(c.bh * c.bw * 64, np.int32)
        coef[np.asarray(idxs[slot], np.int64)] = vals[slot]
        c.coef = coef.reshape(-1, 64)
        c.bits = [0] * 64


def _lossless_scan(members, plans, segments, dc_luts, predictor, pt,
                   restart, mcus_a_row) -> None:
    """A lossless scan's differences into each member's plane, and what
    undoing them needs: the predictor, the point transform and the rows
    that restart prediction (the first of the scan and of each restart
    interval, which holds whole MCU rows)."""
    if restart and restart % mcus_a_row:
        raise NotPortedError("lossless JPEG with a restart interval that "
                             "is not whole MCU rows is not ported")
    diffs = [[0] * (c.bw * c.bh) for c in members]
    for plan, seg in zip(plans, segments):
        _decode_lossless_segment(seg, plan, dc_luts, diffs)
    rows = restart // mcus_a_row if restart else 1 << 30
    for c, d in zip(members, diffs):
        c.coef = np.asarray(d, np.int64).reshape(c.bh, c.bw)
        v = c.v if len(members) > 1 else 1
        c.predictor, c.pt = predictor, pt
        c.first_rows = range(0, c.bh, rows * v)


def _output(frame: _Frame, space: str) -> np.ndarray:
    """IDCT (with block smoothing where it applies), upsampling and
    colour conversion of the decoded coefficients."""
    comps = frame.comps
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    lossless = frame.mode == "lossless"
    if lossless and space in ("YCbCr", "YCCK"):
        raise ValueError(f"lossless JPEG in {space}: libjpeg-turbo "
                         "converts no colour in lossless mode "
                         "(JERR_CONVERSION_NOTIMPL), so PIL cannot decode "
                         "it to RGB either")
    smooth = frame.mode == "progressive" and _smoothing_on(comps)
    planes = []
    for c in comps:
        if c.coef is None:
            raise ValueError(f"corrupt JPEG: component {c.cid} has no scan")
        if lossless:
            # no DCT, so no fancy upsampling: every ratio replicates
            plane = _undifference(c.coef[:c.dh, :c.dw], c.predictor, c.pt,
                                  c.first_rows)
            plane = np.repeat(np.repeat(plane, hmax // c.h, axis=1),
                              vmax // c.v, axis=0)
            planes.append(plane[:frame.height, :frame.width])
            continue
        coef = np.asarray(c.coef, np.int64).reshape(c.bh, c.bw, 64)
        if smooth:
            coef = coef.copy()
            coef[:-(-c.dh // 8), :-(-c.dw // 8)] = _smooth(coef, c,
                                                          frame.mcuy)
        # a component no scan named has no table latched: libjpeg's
        # dequantization table stays zero, so it decodes to mid-grey
        qt = c.qt if c.qt is not None else np.zeros(64, np.int64)
        blocks = idct_islow(coef.reshape(-1, 64), qt)
        plane = blocks.reshape(c.bh, c.bw, 8, 8).transpose(0, 2, 1, 3)
        plane = plane.reshape(c.bh * 8, c.bw * 8)[:c.dh, :c.dw]
        plane = _upsample(plane, hmax // c.h, vmax // c.v)
        planes.append(plane[:frame.height, :frame.width])
    if space == "grey":
        return np.repeat(planes[0][..., None], 3, axis=-1)
    if space == "RGB":
        return np.stack(planes, -1)
    if space == "YCbCr":
        return np.clip(_ycc_to_rgb(*planes), 0, 255).astype(np.uint8)
    if space == "YCCK":
        cmy = 255 - np.clip(_ycc_to_rgb(*planes[:3]), 0, 255)
        planes = [cmy[..., 0], cmy[..., 1], cmy[..., 2], planes[3]]
    return _cmyk_to_rgb(np.stack(planes, -1))
