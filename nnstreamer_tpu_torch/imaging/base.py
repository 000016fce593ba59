"""What the decoders of ``imaging/`` share: the signal that a plugin
passes the bytes on, and the parsed-but-not-decoded image.

PIL's ``Image.open`` tries its plugins in order; one whose ``_open``
raises ``SyntaxError``, ``IndexError``, ``TypeError`` or
``struct.error`` passes the bytes to the next, any other error ends the
open. A decoder's ``open_*`` raises :class:`NotThisFormat` (or lets
``struct.error``/``IndexError`` out) exactly where the plugin's
``_open`` would pass, and ``ValueError`` where it would fail; pixels are
decoded only after a plugin has taken the bytes, by ``Opened.rgb``.
"""
from __future__ import annotations

import struct
from typing import Callable, Optional, Tuple

import numpy as np

PASS_ON = (struct.error, IndexError)


class NotThisFormat(Exception):
    """The bytes are not this plugin's: PIL tries the next one."""


class Opened:
    """A file a plugin has taken: its PIL format name, its size (W, H)
    where the header gives it (PIL passes a size with a zero on to the
    next plugin) and a function that decodes it to (H, W, 3) uint8
    RGB."""

    def __init__(self, fmt: str, decode: Callable[[], np.ndarray],
                 size: Optional[Tuple[int, int]] = None):
        self.format = fmt
        self.size = size
        self._decode = decode

    def rgb(self) -> np.ndarray:
        return self._decode()


def _unpack(fmt: str, data, pos: int, default: Optional[int]) -> int:
    """One integer at ``pos``; past the end, ``default`` where one is
    given (a plugin's accept test over a short prefix), else
    ``struct.error`` (the plugin passes the bytes on)."""
    if default is not None and pos + struct.calcsize(fmt) > len(data):
        return default
    return struct.unpack_from(fmt, data, pos)[0]


def u16le(data, pos: int = 0, default: Optional[int] = None) -> int:
    return _unpack("<H", data, pos, default)


def u32le(data, pos: int = 0, default: Optional[int] = None) -> int:
    return _unpack("<I", data, pos, default)


def u32be(data, pos: int = 0, default: Optional[int] = None) -> int:
    return _unpack(">I", data, pos, default)


def rgb555(v: np.ndarray, green_bits: int = 5) -> np.ndarray:
    """16-bit little-endian pixels, 5-5-5 (or 5-6-5 with ``green_bits``
    6) from the top bit down, to 8-bit RGB as Pillow's ``BGR;15``,
    ``BGR;16`` and ``BGRA;15Z`` unpackers scale them: ``x * 255 //
    max``."""
    v = v.astype(np.int64)
    gmax = (1 << green_bits) - 1
    return np.stack([((v >> (5 + green_bits)) & 31) * 255 // 31,
                     ((v >> 5) & gmax) * 255 // gmax, (v & 31) * 255 // 31],
                    -1).astype(np.uint8)


def unpack_bits(rows: np.ndarray, width: int, depth: int) -> np.ndarray:
    """(H, row bytes) uint8 -> (H, width) samples of ``depth`` bits (1, 2
    or 4), most significant first."""
    h = rows.shape[0]
    bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(-1, dtype=np.uint8)[:, :width]


def raw_rows(data, pos: int, height: int, row_bytes: int, stride: int,
             what: str) -> np.ndarray:
    """(height, row_bytes) of the bytes at ``pos``, rows ``stride`` apart,
    as Pillow's raw decoder reads them; a file that ends early raises, as
    PIL's load of a truncated file does."""
    need = (height - 1) * stride + row_bytes if height else 0
    if pos < 0 or pos + need > len(data):
        raise ValueError(f"{what}: image file is truncated ({len(data)} "
                         f"bytes, the pixels need {pos + need})")
    buf = np.frombuffer(data, np.uint8, need, pos) if need else \
        np.zeros(0, np.uint8)
    if stride == row_bytes:
        return buf.reshape(height, row_bytes)
    return np.lib.stride_tricks.as_strided(
        buf, (height, row_bytes), (stride, 1))
