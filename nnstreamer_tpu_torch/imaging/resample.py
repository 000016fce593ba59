"""Pillow's ``Image.resize(size, Image.BILINEAR)`` for uint8 frames, in
numpy, bit for bit.

≙ Pillow's libImaging/Resample.c (``precompute_coeffs``,
``normalize_coeffs_8bpc``, ``ImagingResampleHorizontal_8bpc``/
``Vertical_8bpc``) and the RGBA handling of ``Image.resize``:

* the triangle filter's support widens by the scale factor when the
  image shrinks, so a downscale averages (antialiases) instead of
  sampling two neighbours;
* each output pixel's coefficients are normalised to sum 1 in float64,
  then rounded to fixed point with ``PRECISION_BITS = 32 - 8 - 2``; a
  pixel accumulates from a half bias and clips to 8 bits;
* the horizontal pass runs first and its result is stored as uint8
  before the vertical pass, so the rounding between the passes is part
  of the result; a pass whose size does not change is skipped;
* a 4-channel frame is RGBA to PIL: it is premultiplied by its alpha
  (``RGBa``), resized, and divided back, with Pillow's integer rounding
  in both conversions. A ``BGRx`` frame's pad byte therefore acts as
  alpha, as it does in the JAX package's element.

Both passes are vectorised over rows and channels; the only loop runs
over a filter's taps (7 for 640 -> 224).
"""
from __future__ import annotations

import math

import numpy as np

PRECISION_BITS = 32 - 8 - 2


def _coeffs(in_size: int, out_size: int):
    """(first input index, fixed-point taps) of each output pixel:
    shapes (out_size,) and (out_size, ksize); a tap past the pixel's
    window is 0."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale            # the triangle filter's support is 1
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5),
                      in_size).astype(np.int64) - xmin
    taps = np.arange(ksize)
    x = ((taps[None, :] + xmin[:, None]).astype(np.float64)
         - center[:, None]) + 0.5
    w = np.maximum(1.0 - np.abs(x * (1.0 / filterscale)), 0.0)
    w = np.where(taps[None, :] < xmax[:, None], w, 0.0)
    ww = np.zeros(out_size)
    for j in range(ksize):                 # Pillow's summation order
        ww = ww + w[:, j]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None],
                 w)
    one = float(1 << PRECISION_BITS)
    k = np.where(w < 0, np.trunc(-0.5 + w * one), np.trunc(0.5 + w * one))
    return xmin, k.astype(np.int32)


def _pass(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One 8-bit pass of the resize along ``axis`` (0 rows, 1 columns)."""
    in_size = img.shape[axis]
    xmin, k = _coeffs(in_size, out_size)
    src = img.astype(np.int32)
    acc = np.full(img.shape[:axis] + (out_size,) + img.shape[axis + 1:],
                  1 << (PRECISION_BITS - 1), np.int32)
    bshape = [1] * img.ndim
    bshape[axis] = out_size
    for j in range(k.shape[1]):
        idx = np.minimum(xmin + j, in_size - 1)
        acc += np.take(src, idx, axis=axis) * k[:, j].reshape(bshape)
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def _premultiply(frame: np.ndarray) -> np.ndarray:
    """RGBA -> RGBa: Pillow's ``MULDIV255`` on the colour channels."""
    a = frame[..., 3:].astype(np.uint32)
    t = frame[..., :3].astype(np.uint32) * a + 128
    out = frame.copy()
    out[..., :3] = ((t >> 8) + t) >> 8
    return out


def _unpremultiply(frame: np.ndarray) -> np.ndarray:
    """RGBa -> RGBA: ``255 * c // a`` clipped to 255; alpha 0 and 255
    keep the colour as it is."""
    a = frame[..., 3:].astype(np.int32)
    c = frame[..., :3].astype(np.int32)
    div = np.minimum(255 * c // np.maximum(a, 1), 255)
    out = frame.copy()
    out[..., :3] = np.where((a == 0) | (a == 255), c, div)
    return out


def resize_bilinear(frame: np.ndarray, width: int, height: int) -> np.ndarray:
    """Resize an (H, W) or (H, W, C) uint8 frame to ``width`` x
    ``height`` as ``PIL.Image.fromarray(frame).resize((width, height),
    Image.BILINEAR)`` does. C is 1 (mode L), 3 (RGB) or 4 (RGBA: the
    last channel is alpha)."""
    if frame.dtype != np.uint8:
        raise TypeError(f"resize_bilinear wants uint8, got {frame.dtype}")
    if width <= 0 or height <= 0:
        raise ValueError(f"bad target size {width}x{height}")
    chans = frame.shape[2] if frame.ndim == 3 else 1
    if frame.ndim not in (2, 3) or chans not in (1, 3, 4):
        raise ValueError(f"resize_bilinear wants (H, W[, 1|3|4]), got "
                         f"{frame.shape}")
    if frame.shape[:2] == (height, width):
        return frame.copy()
    img = _premultiply(frame) if chans == 4 else frame
    if img.shape[1] != width:
        img = _pass(img, width, 1)
    if img.shape[0] != height:
        img = _pass(img, height, 0)
    return _unpremultiply(img) if chans == 4 else img
