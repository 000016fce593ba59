"""QOI decoder: what PIL's ``QoiImagePlugin`` opens, decoded as
``Image.open(...).convert("RGB")`` gives it.

All six ops (RGB, RGBA, INDEX, DIFF, LUMA, RUN) as PIL's Python decoder
runs them: the previous pixel starts at opaque black, the index of 64
seen pixels starts empty (an INDEX into an unset slot reads
transparent black), a run does not touch the index, and a run may
overshoot the image (the extra pixels are dropped). A header channel
count other than 3 opens as RGBA. A stream that ends before the image
is full fails, as PIL's decoder does.

QOI is a chain of ops, each pixel depending on the one before it and
on the index, so the decode is a Python loop over ops; a run is
appended in one step.
"""
from __future__ import annotations

import numpy as np

from .base import NotThisFormat, Opened, u32be
from .modes import to_rgb


def _decode(data, pos: int, width: int, height: int, bands: int):
    n = len(data)
    dest = width * height
    out = bytearray()
    seen = [None] * 64
    px = (0, 0, 0, 255)
    count = 0
    try:
        while count < dest:
            b = data[pos]
            pos += 1
            if b == 0xFE:
                if pos + 3 > n:
                    raise IndexError
                px = (data[pos], data[pos + 1], data[pos + 2], px[3])
                pos += 3
            elif b == 0xFF:
                if pos + 4 > n:
                    raise IndexError
                px = (data[pos], data[pos + 1], data[pos + 2], data[pos + 3])
                pos += 4
            else:
                op = b >> 6
                if op == 0:
                    px = seen[b & 63] or (0, 0, 0, 0)
                elif op == 1:
                    r, g, bl, a = px
                    px = ((r + ((b >> 4) & 3) - 2) & 255,
                          (g + ((b >> 2) & 3) - 2) & 255,
                          (bl + (b & 3) - 2) & 255, a)
                elif op == 2:
                    b2 = data[pos]
                    pos += 1
                    dg = (b & 63) - 32
                    dr, db = (b2 >> 4) - 8, (b2 & 15) - 8
                    r, g, bl, a = px
                    px = ((r + dg + dr) & 255, (g + dg) & 255,
                          (bl + dg + db) & 255, a)
                else:
                    run = (b & 63) + 1
                    out += bytes(px[:bands]) * run
                    count += run
                    continue
            r, g, bl, a = px
            seen[(r * 3 + g * 5 + bl * 7 + a * 11) % 64] = px
            out += bytes(px[:bands])
            count += 1
    except IndexError:
        raise ValueError(f"QOI: the stream ends after {count} of {dest} "
                         "pixels") from None
    return np.frombuffer(bytes(out[:dest * bands]), np.uint8).reshape(
        height, width, bands)


def open_qoi(data) -> Opened:
    if bytes(data[:4]) != b"qoif":
        raise NotThisFormat("not a QOI file")
    width, height = u32be(data, 4), u32be(data, 8)
    bands = 3 if data[12] == 3 else 4
    return Opened("QOI", lambda: to_rgb(
        "RGB" if bands == 3 else "RGBA", _decode(data, 14, width, height,
                                                 bands)), (width, height))
