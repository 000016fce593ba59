"""Host image codecs in numpy: Pillow's BILINEAR resize (``resample``),
a PNG decoder (``png``) and a JPEG decoder (``jpeg``: sequential and
progressive, grey, YCbCr, RGB, CMYK and YCCK).

The JAX package's ``pngdec``, ``jpegdec`` and ``videoscale`` call PIL;
these modules give the same bytes without it, so the port's media
elements run where PIL is not installed.
"""
from .jpeg import decode_jpeg
from .png import decode_png
from .resample import resize_bilinear

__all__ = ["decode_jpeg", "decode_png", "resize_bilinear", "decode_image"]


# magic bytes of the other formats PIL opens, named in the refusal
_OTHER_FORMATS = ((b"BM", "BMP"), (b"GIF8", "GIF"), (b"II*\x00", "TIFF"),
                  (b"MM\x00*", "TIFF"), (b"RIFF", "WebP"), (b"P1", "PBM"),
                  (b"P2", "PGM"), (b"P3", "PPM"), (b"P4", "PBM"),
                  (b"P5", "PGM"), (b"P6", "PPM"), (b"\x00\x00\x01\x00", "ICO"))


def decode_image(data: bytes):
    """PNG or JPEG bytes -> (H, W, 3) uint8 RGB, as PIL's
    ``Image.open(...).convert("RGB")`` gives it; the format is sniffed
    from the magic bytes. The JAX package's ``pngdec``/``jpegdec`` open
    whatever PIL opens; another format PIL knows raises here, named."""
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        return decode_png(data)
    if data[:2] == b"\xff\xd8":
        return decode_jpeg(data)
    head = bytes(data[:8])
    named = next((name for magic, name in _OTHER_FORMATS
                  if head.startswith(magic)), None)
    if named:
        raise ValueError(f"not a PNG or JPEG stream: a {named} image "
                         f"(starts {head!r}); the port decodes PNG and "
                         "JPEG only")
    raise ValueError(f"not a PNG or JPEG stream (starts {head!r})")
