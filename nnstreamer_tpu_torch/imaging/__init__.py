"""Host image codecs in numpy: Pillow's BILINEAR resize (``resample``),
a PNG decoder (``png``) and a baseline JPEG decoder (``jpeg``).

The JAX package's ``pngdec``, ``jpegdec`` and ``videoscale`` call PIL;
these modules give the same bytes without it, so the port's media
elements run where PIL is not installed.
"""
from .jpeg import decode_jpeg
from .png import decode_png
from .resample import resize_bilinear

__all__ = ["decode_jpeg", "decode_png", "resize_bilinear", "decode_image"]


def decode_image(data: bytes):
    """PNG or JPEG bytes -> (H, W, 3) uint8 RGB, as PIL's
    ``Image.open(...).convert("RGB")`` gives it; the format is sniffed
    from the magic bytes."""
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        return decode_png(data)
    if data[:2] == b"\xff\xd8":
        return decode_jpeg(data)
    raise ValueError(f"not a PNG or JPEG stream (starts {bytes(data[:8])!r})")
