"""GIF decoder: the first frame of what PIL's ``GifImagePlugin`` opens,
decoded as ``Image.open(...).convert("RGB")`` gives it.

* The logical screen, its global colour table and the blocks before the
  first image descriptor (extensions are read through; a graphic control
  extension's transparent index is kept).
* The first frame's local colour table, if any, else the global one. A
  table whose every entry is its own grey index is no palette to PIL:
  such a frame opens as mode ``L`` (its indices are its greys), and so
  does a frame with no table at all. Indices past a short table read
  black.
* The frame placed on the screen at its offset; a frame reaching past
  the screen grows the image to hold it (as PIL does for the first
  frame); pixels outside the frame hold index 0, or the transparent
  index when the frame has one (``load_prepare``).
* Variable-length LZW codes, least significant bit first, from the
  initial code size (2-12; PIL fails on the others) up to 12 bits, with
  a clear code and the end code; when the table is full the code size
  stays at 12 and no entry is added until a clear (a deferred clear). A
  code past the table fails, and so does data that ends before the frame
  is full (PIL's load reports a truncated file); an end code before the
  frame is full leaves the rest as it was filled.
* Interlaced frames in GIF's four passes (rows 0, 8, ...; 4, 12, ...;
  2, 6, ...; 1, 3, ...).

The LZW decode is a Python loop over codes, each string appended whole.
Animation past the first frame is not read: ``convert("RGB")`` of a
just-opened image is its first frame.
"""
from __future__ import annotations

import numpy as np

from .base import NotThisFormat, Opened, u16le
from .modes import to_rgb


def _palette_needed(p: bytes) -> bool:
    """GifImageFile._is_palette_needed (a table cut short raises
    IndexError, which passes the bytes on)."""
    for i in range(0, len(p), 3):
        if not (i // 3 == p[i] == p[i + 1] == p[i + 2]):
            return True
    return False


def _sub_blocks(data, pos: int) -> bytes:
    """The bytes of the data sub-blocks at ``pos``, up to a zero-length
    block or the end of the file."""
    out = bytearray()
    n = len(data)
    while pos < n:
        size = data[pos]
        pos += 1
        if not size:
            break
        out += data[pos:pos + size]
        pos += size
    return bytes(out)


def lzw_decode(stream: bytes, bits: int, npix: int):
    """GIF LZW: up to ``npix`` indices from ``stream``; returns them and
    whether the stream ran out before an end code or ``npix`` indices."""
    clear, eoi = 1 << bits, (1 << bits) + 1
    table = [bytes([i]) for i in range(clear)] + [b"", b""]
    size = bits + 1
    nxt = clear + 2
    prev = None
    out = bytearray()
    buf = stream + b"\0\0\0"
    total = len(stream) * 8
    p = 0
    while len(out) < npix:
        if p + size > total:
            return bytes(out), True
        q = p >> 3
        code = ((buf[q] | buf[q + 1] << 8 | buf[q + 2] << 16) >> (p & 7)) \
            & ((1 << size) - 1)
        p += size
        if code == clear:
            del table[clear + 2:]
            size, nxt, prev = bits + 1, clear + 2, None
            continue
        if code == eoi:
            return bytes(out), False
        if prev is None:
            if code >= clear:
                raise ValueError(f"GIF: broken LZW stream (code {code} "
                                 "after a clear)")
            entry = table[code]
        elif code < nxt:
            entry = table[code]
            if nxt < 4096:
                table.append(prev + entry[:1])
                nxt += 1
        elif code == nxt and nxt < 4096:
            entry = prev + prev[:1]
            table.append(entry)
            nxt += 1
        else:
            raise ValueError(f"GIF: broken LZW stream (code {code} past "
                             f"the table's {nxt} entries)")
        if nxt == 1 << size and size < 12:
            size += 1
        out += entry
        prev = entry
    return bytes(out), False


def _interlaced_rows(h: int) -> np.ndarray:
    return np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8),
                           np.arange(2, h, 4), np.arange(1, h, 2)])


def open_gif(data) -> Opened:
    if bytes(data[:6]) not in (b"GIF87a", b"GIF89a"):
        raise NotThisFormat("not a GIF file")
    sw, sh = u16le(data, 6), u16le(data, 8)
    flags = data[10]
    pos = 13
    global_pal = None
    if flags & 128:
        p = bytes(data[pos:pos + (3 << ((flags & 7) + 1))])
        pos += 3 << ((flags & 7) + 1)
        if _palette_needed(p):
            global_pal = p
    transparency = None
    n = len(data)

    def block():
        """GifImageFile.data: the next sub-block, None at a zero size."""
        nonlocal pos
        if pos >= n:
            return None
        size = data[pos]
        pos += 1
        if not size:
            return None
        pos += size
        return bytes(data[pos - size:pos])

    while True:
        if pos >= n or data[pos] == 0x3B:
            raise NotThisFormat("GIF: no image in the file (PIL's "
                                "EOFError passes the bytes on)")
        c = data[pos]
        pos += 1
        if c == 0x21:
            label = data[pos]
            pos += 1
            b = block()
            if label == 0xF9 and b is not None:
                u16le(b, 1)     # the delay: struct.error passes the bytes on
                if b[0] & 1:
                    transparency = b[3]
            elif label == 0xFE:
                while b:
                    b = block()
                continue
            elif label == 0xFF and b is not None and \
                    b.startswith(b"NETSCAPE2.0"):
                block()
            while block():
                pass
        elif c == 0x2C:
            d = bytes(data[pos:pos + 9])
            x0, y0 = u16le(d, 0), u16le(d, 2)
            x1, y1 = x0 + u16le(d, 4), y0 + u16le(d, 6)
            fl = d[8]
            pos += 9
            interlace = bool(fl & 64)
            palette = None
            if fl & 128:
                p = bytes(data[pos:pos + (3 << ((fl & 7) + 1))])
                pos += 3 << ((fl & 7) + 1)
                palette = p if _palette_needed(p) else False
            bits = data[pos]
            pos += 1
            break
    w, h = max(x1, sw), max(y1, sh)
    pal = palette if palette is not None else global_pal

    def decode():
        if not 2 <= bits <= 12:
            # PIL refuses more than 12; below 2 the table starts full at
            # its code size and PIL's decoder reads past the stream
            raise ValueError(f"GIF: LZW minimum code size {bits}, not "
                             "2-12")
        stream = _sub_blocks(data, pos)
        fw, fh = x1 - x0, y1 - y0
        idx, short = lzw_decode(stream, bits, fw * fh) \
            if fw * fh else (b"", False)
        if short and len(idx) < fw * fh:
            raise ValueError(f"GIF: image file is truncated ({len(idx)} of "
                             f"{fw * fh} pixels)")
        img = np.full((h, w), transparency or 0, np.uint8)
        if fw * fh:
            frame = np.full(fw * fh, transparency or 0, np.uint8)
            frame[:len(idx)] = np.frombuffer(idx, np.uint8)
            frame = frame.reshape(fh, fw)
            if interlace:
                rows = np.empty_like(frame)
                rows[_interlaced_rows(fh)] = frame
                frame = rows
            img[y0:y1, x0:x1] = frame
        if pal:
            return to_rgb("P", img, np.frombuffer(
                pal, np.uint8, len(pal) // 3 * 3).reshape(-1, 3))
        return to_rgb("L", img)

    return Opened("GIF", decode, (w, h))
