"""PIL's ``convert("RGB")`` from each image mode the port's decoders
produce, in numpy.

A decoder here gives what PIL's plugin would hold after ``Image.open``:
a mode name and its samples (``(H, W)`` for one band, ``(H, W, C)`` for
more), and a palette for ``P``/``PA``. ``to_rgb`` then does what
Pillow's ``Convert.c`` does on the way to RGB:

* ``1``: any nonzero sample is white;
* ``L``, ``LA``: the grey value in all three channels, alpha dropped;
* ``P``, ``PA``: the palette's colour, a palette shorter than 256
  entries reading black past its end; transparency and alpha dropped;
* ``RGB``, ``RGBA``, ``RGBX``: the first three channels;
* ``RGBa`` (premultiplied): ``c * 255 // a`` clipped to 255, and ``c``
  as it is where ``a`` is 0;
* ``CMYK``: Pillow's ``cmyk2rgb``, ``nk - nk * c / 255`` with
  ``nk = 255 - k``, rounded as ``MULDIV255``;
* ``I`` (32-bit signed), ``I;16``, ``I;16B``: clipped to 0-255 (not
  scaled);
* ``F``: clipped to 0-255 and truncated toward zero; NaN is 0.

16-bit samples of multi-band modes are no PIL mode: the decoders keep
their high byte, as Pillow's ``;16`` unpackers do, before they get here.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

MODES = ("1", "L", "LA", "P", "PA", "RGB", "RGBA", "RGBX", "RGBa", "CMYK",
         "I", "I;16", "I;16B", "F")


def palette_rgb(palette, index: np.ndarray) -> np.ndarray:
    """``palette`` ((N, 3) uint8) at ``index``: black past its end, as
    PIL's P -> RGB reads a short palette."""
    table = np.zeros((256, 3), np.uint8)
    pal = np.asarray(palette, np.uint8).reshape(-1, 3)[:256]
    table[:len(pal)] = pal
    return table[index]


def cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """Pillow's cmyk2rgb on (H, W, 4) CMYK samples."""
    c = cmyk.astype(np.int64)
    nk = 255 - c[..., 3:]
    t = c[..., :3] * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


def unpremultiply(rgba: np.ndarray) -> np.ndarray:
    """Pillow's RGBa -> RGB on (H, W, 4) premultiplied samples."""
    c = rgba[..., :3].astype(np.int64)
    a = rgba[..., 3:].astype(np.int64)
    out = np.minimum(255, c * 255 // np.maximum(a, 1))
    return np.where(a == 0, c, out).astype(np.uint8)


def _grey(v: np.ndarray) -> np.ndarray:
    return np.repeat(np.asarray(v, np.uint8)[..., None], 3, axis=-1)


def to_rgb(mode: str, samples: np.ndarray,
           palette: Optional[np.ndarray] = None) -> np.ndarray:
    """(H, W, 3) uint8: PIL's ``convert("RGB")`` of an image of ``mode``
    holding ``samples`` (and ``palette`` for P and PA)."""
    s = np.asarray(samples)
    if mode == "1":
        return _grey(np.where(s != 0, 255, 0))
    if mode == "L":
        return _grey(s)
    if mode == "LA":
        return _grey(s[..., 0])
    if mode in ("P", "PA"):
        idx = s[..., 0] if mode == "PA" else s
        return palette_rgb(palette if palette is not None
                           else np.zeros((0, 3), np.uint8), idx)
    if mode in ("RGB", "RGBA", "RGBX"):
        return np.ascontiguousarray(s[..., :3], np.uint8)
    if mode == "RGBa":
        return unpremultiply(s)
    if mode == "CMYK":
        return cmyk_to_rgb(s)
    if mode in ("I", "I;16", "I;16B"):
        return _grey(np.clip(s.astype(np.int64), 0, 255))
    if mode == "F":
        f = np.nan_to_num(s.astype(np.float32), nan=0.0, posinf=255.0,
                          neginf=0.0)
        return _grey(np.clip(f, 0, 255).astype(np.uint8))
    raise ValueError(f"no conversion to RGB from mode {mode!r}")
