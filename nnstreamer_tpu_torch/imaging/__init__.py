"""Host image codecs in numpy: Pillow's BILINEAR resize (``resample``)
and decoders for the formats PIL's ``Image.open`` knows best: PNG
(``png``), JPEG (``jpeg``), BMP/DIB (``bmp``), PBM/PGM/PPM/PFM
(``pnm``), GIF (``gif``), TIFF (``tiff``), ICO/CUR (``ico``), TGA
(``tga``) and QOI (``qoi``), each converted to RGB as PIL's
``convert("RGB")`` converts its mode (``modes``).

The JAX package's ``pngdec``, ``jpegdec`` and ``videoscale`` call PIL;
these modules give the same bytes without it, so the port's media
elements run where PIL is not installed.
"""
import re
import struct

from ..pipeline.element import NotPortedError
from .base import PASS_ON, NotThisFormat, Opened, u16le, u32be, u32le
from .bmp import open_bmp, open_dib
from .gif import open_gif
from .ico import open_cur, open_ico
from .jpeg import decode_jpeg
from .png import SIGNATURE as PNG_SIGNATURE
from .png import decode_png
from .pnm import open_pnm
from .qoi import open_qoi
from .resample import resize_bilinear
from .tga import open_tga
from .tiff import PREFIXES as TIFF_PREFIXES
from .tiff import open_tiff

__all__ = ["decode_jpeg", "decode_png", "resize_bilinear", "decode_image",
           "sniff"]


def _refused(fmt, check=None):
    """An opener for a format PIL opens that the port does not decode:
    ``check`` first, then a refusal naming the format. A check walks the
    plugin's ``_open``: it raises NotThisFormat where PIL passes the
    bytes on, ValueError where PIL's open fails, and returns the size
    (W, H) where it covers the whole ``_open`` (a size with a zero passes
    the bytes on, as in PIL)."""
    def opener(data):
        size = check(data) if check is not None else None

        def refuse():
            raise NotPortedError(f"the port does not decode {fmt} images "
                                 "(PIL opens this file as format "
                                 f"{fmt!r}); it decodes PNG, JPEG, BMP/DIB, "
                                 "PBM/PGM/PPM/PFM, GIF, TIFF, ICO/CUR, TGA "
                                 "and QOI")
        return Opened(fmt, refuse, size)
    return opener


def _pcx_check(data):
    p = bytes(data[:68])
    if len(p) < 12 or u16le(p, 8) + 1 <= u16le(p, 4) or \
            u16le(p, 10) + 1 <= u16le(p, 6):
        raise NotThisFormat("bad PCX image size")


_IM_SPLIT = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
_IM_TAGS = (b"Comment", b"Date", b"Digitalization equipment",
            b"File size (no of images)", b"Lut", b"Name", b"Scale (x,y)",
            b"Image size (x*y)", b"Image type")


def _im_check(data):
    """ImImageFile._open's header: text lines of ``key: value`` up to a
    NUL or ^Z, at least one of them a known key."""
    if b"\n" not in bytes(data[:100]):
        raise NotThisFormat("not an IM file")
    pos, n, known = 0, len(data), 0
    while pos < n:
        c = data[pos:pos + 1]
        pos += 1
        if c == b"\r":
            continue
        if c in (b"\0", b"\x1a"):
            break
        end = data.find(b"\n", pos)
        end = n if end < 0 else end + 1
        line = bytes(c + data[pos:end])
        pos = end
        if len(line) > 100:
            raise NotThisFormat("not an IM file")
        line = line[:-2] if line.endswith(b"\r\n") else \
            line[:-1] if line.endswith(b"\n") else line
        m = _IM_SPLIT.match(line)
        if not m:
            raise NotThisFormat("syntax error in IM header")
        known += m.group(1) in _IM_TAGS
    if not known:
        raise NotThisFormat("not an IM file")


_IMT_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


def _imt_check(data):
    """ImtImageFile._open: a text header that names ``pixel n8`` and a
    positive width and height before a form feed."""
    buf = bytes(data[:100])
    if b"\n" not in buf:
        raise NotThisFormat("not an IMT file")
    rest = bytes(data[100:])
    mode, w, h = None, 0, 0
    while True:
        if buf:
            s, buf = buf[:1], buf[1:]
        else:
            s, rest = rest[:1], rest[1:]
        if not s or s == b"\x0c":
            break
        if b"\n" not in buf:
            buf += rest[:100]
            rest = rest[100:]
        lines = buf.split(b"\n")
        s += lines.pop(0)
        buf = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord("*"):
            continue
        m = _IMT_FIELD.match(s)
        if not m:
            break
        k, v = m.group(1, 2)
        if k == b"width":
            w = int(v)
        elif k == b"height":
            h = int(v)
        elif k == b"pixel" and v == b"n8":
            mode = "L"
    if mode is None or w <= 0 or h <= 0:
        raise NotThisFormat("not identified by the IMT driver")


def _iptc_int(v) -> int:
    if not isinstance(v, bytes):    # a field with no data, or repeated
        raise NotThisFormat("IPTC: not an integer field (TypeError in PIL)")
    return struct.unpack(">I", (b"\0\0\0\0" + v)[-4:])[0]


def _iptc_check(data):
    """IptcImageFile._open: 5-byte field headers (0x1C, record, dataset,
    a size that may be extended) up to the image's (8, 10), then a mode
    from (3, 60), a size from (3, 20)/(3, 30) and a compression from
    (3, 120)."""
    info, pos = {}, 0
    while True:
        s = bytes(data[pos:pos + 5])
        pos += 5
        if not s.strip(b"\0"):
            break
        if len(s) < 3:
            raise NotThisFormat("IPTC: short field header (IndexError)")
        tag = s[1], s[2]
        if s[0] != 0x1C or tag[0] not in (1, 2, 3, 4, 5, 6, 7, 8, 9, 240):
            raise NotThisFormat("invalid IPTC/NAA file")
        if len(s) < 4:
            raise NotThisFormat("IPTC: short field header (IndexError)")
        size = s[3]
        if size > 132:
            raise ValueError("illegal field length in IPTC/NAA file")
        if size == 128:
            size = 0
        elif size > 128:
            size = _iptc_int(bytes(data[pos:pos + size - 128]))
            pos += s[3] - 128
        else:
            size = struct.unpack_from(">H", s, 3)[0]
        if tag == (8, 10):
            break
        value = bytes(data[pos:pos + size]) if size else None
        pos += size
        if tag in info:
            old = info[tag]
            info[tag] = old + [value] if isinstance(old, list) else \
                [old, value]
        else:
            info[tag] = value
    try:
        layers, component = info[(3, 60)][0], info[(3, 60)][1]
        mode = None
        if layers == 1 and not component:
            mode = "L"
        else:
            if layers == 3 and component:
                mode = "RGB"
            elif layers == 4 and component:
                mode = "CMYK"
            if (3, 65) in info:
                info[(3, 65)][0] - 1
        size = _iptc_int(info[(3, 20)]), _iptc_int(info[(3, 30)])
    except (KeyError, TypeError, IndexError) as e:
        raise NotThisFormat(f"IPTC: {e!r}") from e
    if (3, 120) not in info or _iptc_int(info[(3, 120)]) not in (1, 5):
        raise ValueError("Unknown IPTC image compression")
    if mode is None:
        raise NotThisFormat("IPTC: no mode for these layers")
    return size


def _wmf_check(data):
    """WmfImageFile._open: a placeable metafile with the standard header
    at 22, or an enhanced one with " EMF" at 40."""
    s = bytes(data[:44])
    if s.startswith(b"\xd7\xcd\xc6\x9a\0\0"):
        inch = u16le(s, 14)
        if inch == 0:
            raise ValueError("WMF: invalid inch")
        x0, y0, x1, y1 = struct.unpack_from("<4h", s, 6)
        if s[22:26] != b"\x01\x00\t\x00":
            raise NotThisFormat("unsupported WMF file format")
        return (x1 - x0) * 72 // inch, (y1 - y0) * 72 // inch
    if s.startswith(b"\1\0\0\0") and s[40:44] == b" EMF":
        x0, y0, x1, y1, f0, f1, f2, f3 = struct.unpack_from("<8i", s, 8)
        if f2 == f0 or f3 == f1:
            raise ValueError("EMF: empty frame (ZeroDivisionError in PIL)")
        return x1 - x0, y1 - y0
    raise NotThisFormat("unsupported WMF file format")


def _mpeg_check(data):
    s = bytes(data[4:7])
    if len(s) < 3:
        raise NotThisFormat("MPEG: short sequence header (IndexError)")
    return s[0] << 4 | s[1] >> 4, (s[1] & 15) << 8 | s[2]


def _pixar_check(data):
    s = bytes(data[:512])
    size = u16le(s, 418), u16le(s, 416)
    if (u16le(s, 424), u16le(s, 426)) != (14, 2):
        raise NotThisFormat("PIXAR: no mode for these channels")
    return size


def _mcidas_check(data):
    s = bytes(data[:256])
    if len(s) != 256:
        raise NotThisFormat("not an McIdas area file")
    w = (0,) + struct.unpack("!64i", s)
    if w[11] not in (1, 2, 4):
        raise NotThisFormat("unsupported McIdas format")
    return w[10], w[9]


def _msp_check(data):
    s = bytes(data[:32])
    check = 0
    for i in range(0, 32, 2):
        check ^= u16le(s, i)
    if check:
        raise NotThisFormat("bad MSP checksum")
    return u16le(s, 4), u16le(s, 6)


def _psd_check(data):
    """PsdImageFile._open's header, up to its colour-mode data length."""
    version, channels, bits, mode = (struct.unpack_from(">H", data, at)[0]
                                     for at in (4, 12, 22, 24))
    if version != 1:
        raise NotThisFormat("not a PSD file")
    need = {(0, 1): 1, (0, 8): 1, (1, 8): 1, (2, 8): 1, (3, 8): 3,
            (4, 8): 4, (7, 8): 1, (8, 8): 1, (9, 8): 3}.get((mode, bits))
    if need is None:
        raise NotThisFormat("PSD: unknown mode (KeyError in PIL)")
    if need > channels:
        raise ValueError("PSD: not enough channels")
    u32be(data, 26)


def _sun_check(data):
    s = bytes(data[:32])
    size = u32be(s, 4), u32be(s, 8)
    depth, ftype, ptype, plen = u32be(s, 12), u32be(s, 20), u32be(s, 24), \
        u32be(s, 28)
    if depth not in (1, 4, 8, 24, 32):
        raise NotThisFormat("unsupported Sun raster mode")
    if plen and (plen > 1024 or ptype != 1):
        raise NotThisFormat("unsupported Sun raster palette")
    if ftype not in (0, 1, 2, 3, 4, 5):
        raise NotThisFormat("unsupported Sun raster file type")
    return size


def _fli_check(data):
    """FliImageFile._open's header checks."""
    s = bytes(data[:128])
    if s[20:22] != b"\0\0" or s[42:80] != bytes(38) or s[88:] != bytes(40):
        raise NotThisFormat("not an FLI/FLC file")


def _gbr_check(data):
    head, version, width, height, depth = struct.unpack_from(">5I", data)
    if head < 20 or version not in (1, 2) or not width or not height or \
            depth not in (1, 4):
        raise NotThisFormat("not a GIMP brush")
    if version == 2 and bytes(data[20:24]) != b"GIMP":
        raise NotThisFormat("not a GIMP brush, bad magic number")
    return width, height


def _xvthumb_check(data):
    """XVThumbImageFile._open: after the magic's line and any ``#``
    comments, a line that starts with the width and the height."""
    def line(pos):
        end = data.find(b"\n", pos)
        return len(data) if end < 0 else end + 1
    pos = line(6)
    while True:
        if pos >= len(data):
            raise NotThisFormat("unexpected EOF reading XV thumbnail file")
        end = line(pos)
        s, pos = bytes(data[pos:end]), end
        if s[0] != 35:
            break
    fields = s.strip().split(maxsplit=2)[:2]
    try:
        w, h = fields
        return int(w), int(h)
    except ValueError as e:     # PIL's open fails with it
        raise ValueError(f"XV thumbnail size: {e}") from e


_XBM_HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    b"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    b"(?P<hotspot>"
    b"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    b"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    b")?"
    rb"[\000-\377]*_bits\[]")


def _xbm_check(data):
    m = _XBM_HEAD.match(bytes(data[:512]))
    if not m:
        raise NotThisFormat("not a XBM file")
    return int(m.group("width")), int(m.group("height"))


def _pcd_check(data):
    if not bytes(data[2048:2052]) == b"PCD_":
        raise NotThisFormat("not a PCD file")


def _spider_header(t) -> int:
    h = (99,) + t

    def is_int(f):
        try:
            return f - int(f) == 0
        except (ValueError, OverflowError):
            return False
    if not all(is_int(h[i]) for i in (1, 2, 5, 12, 13, 22, 23)):
        return 0
    if int(h[5]) not in (1, 3, -11, -12, -21, -22):
        return 0
    labrec, labbyt, lenbyt = int(h[13]), int(h[22]), int(h[23])
    return labbyt if labbyt == labrec * lenbyt else 0


def _spider_check(data):
    f = bytes(data[:108])
    if len(f) < 108:
        raise NotThisFormat("not a valid Spider file")
    for e in (">", "<"):
        t = struct.unpack(e + "27f", f)
        if _spider_header(t):
            if int(t[4]) != 1:
                raise NotThisFormat("not a Spider 2D image")
            return
    raise NotThisFormat("not a valid Spider file")


def _open_jpeg(data):
    return Opened("JPEG", lambda: decode_jpeg(data))


def _open_png(data):
    return Opened("PNG", lambda: decode_png(data))


def _avif(p):
    return p[4:8] == b"ftyp" and p[8:12] in (b"avif", b"avis", b"mif1",
                                             b"msf1")


def _webp(p):
    return p.startswith(b"RIFF") and p[8:12] == b"WEBP" and \
        p[12:16] in (b"VP8 ", b"VP8X", b"VP8L")


# PIL's Image.ID after init(), in order: (ID, accept over the first 16
# bytes or None, opener); the refused formats' accept tests and, where a
# check is given, their ``_open`` as PIL 12.1 has them (the others are
# refused on their accept test alone)
FORMATS = (
    ("BMP", lambda p: p.startswith(b"BM"), open_bmp),
    ("DIB", lambda p: u32le(p, 0, -1) in (12, 40, 52, 56, 64, 108, 124),
     open_dib),
    ("GIF", lambda p: p.startswith((b"GIF87a", b"GIF89a")), open_gif),
    ("JPEG", lambda p: p.startswith(b"\xff\xd8\xff"), _open_jpeg),
    ("PPM", lambda p: len(p) >= 2 and p[:1] == b"P" and p[1] in
     b"0123456fy", open_pnm),
    ("PNG", lambda p: p.startswith(PNG_SIGNATURE), _open_png),
    ("AVIF", _avif, _refused("AVIF")),
    ("BLP", lambda p: p.startswith((b"BLP1", b"BLP2")), _refused("BLP")),
    ("BUFR", lambda p: p.startswith((b"BUFR", b"ZCZC")), _refused("BUFR")),
    ("CUR", lambda p: p.startswith(b"\0\0\2\0"), open_cur),
    ("PCX", lambda p: len(p) >= 2 and p[0] == 10 and p[1] in (0, 2, 3, 5),
     _refused("PCX", _pcx_check)),
    ("DCX", lambda p: u32le(p, 0, -1) == 987654321, _refused("DCX")),
    ("DDS", lambda p: p.startswith(b"DDS "), _refused("DDS")),
    ("EPS", lambda p: p.startswith(b"%!PS") or u32le(p, 0, -1) == 0xC6D3D0C5,
     _refused("EPS")),
    ("FITS", lambda p: p.startswith(b"SIMPLE"), _refused("FITS")),
    ("FLI", lambda p: len(p) >= 16 and u16le(p, 4) in (0xAF11, 0xAF12)
     and u16le(p, 14) in (0, 3), _refused("FLI", _fli_check)),
    ("FTEX", lambda p: p.startswith(b"FTEX"), _refused("FTEX")),
    ("GBR", lambda p: len(p) >= 8 and u32be(p) >= 20 and
     u32be(p, 4) in (1, 2), _refused("GBR", _gbr_check)),
    ("GRIB", lambda p: len(p) >= 8 and p.startswith(b"GRIB") and p[7] == 1,
     _refused("GRIB")),
    ("HDF5", lambda p: p.startswith(b"\x89HDF\r\n\x1a\n"), _refused("HDF5")),
    ("JPEG2000", lambda p: p.startswith(
        (b"\xff\x4f\xff\x51", b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a")),
     _refused("JPEG2000")),
    ("ICNS", lambda p: p.startswith(b"icns"), _refused("ICNS")),
    ("ICO", lambda p: p.startswith(b"\0\0\1\0"), open_ico),
    ("IM", None, _refused("IM", _im_check)),
    ("IMT", None, _refused("IMT", _imt_check)),
    ("IPTC", None, _refused("IPTC", _iptc_check)),
    ("MCIDAS", lambda p: p.startswith(b"\0\0\0\0\0\0\0\4"),
     _refused("MCIDAS", _mcidas_check)),
    ("MPEG", lambda p: p.startswith(b"\0\0\1\xb3"),
     _refused("MPEG", _mpeg_check)),
    ("TIFF", lambda p: p.startswith(TIFF_PREFIXES), open_tiff),
    ("MSP", lambda p: p.startswith((b"DanM", b"LinS")),
     _refused("MSP", _msp_check)),
    ("PCD", None, _refused("PCD", _pcd_check)),
    ("PIXAR", lambda p: p.startswith(b"\x80\xe8\0\0"),
     _refused("PIXAR", _pixar_check)),
    ("PSD", lambda p: p.startswith(b"8BPS"), _refused("PSD", _psd_check)),
    ("QOI", lambda p: p.startswith(b"qoif"), open_qoi),
    ("SGI", lambda p: len(p) >= 2 and struct.unpack_from(">H", p)[0] == 474,
     _refused("SGI")),
    ("SPIDER", None, _refused("SPIDER", _spider_check)),
    ("SUN", lambda p: u32be(p, 0, -1) == 0x59A66A95,
     _refused("SUN", _sun_check)),
    ("TGA", None, open_tga),
    ("WEBP", _webp, _refused("WEBP")),
    ("WMF", lambda p: p.startswith((b"\xd7\xcd\xc6\x9a\0\0", b"\1\0\0\0")),
     _refused("WMF", _wmf_check)),
    ("XBM", lambda p: p.lstrip().startswith(b"#define"),
     _refused("XBM", _xbm_check)),
    ("XPM", lambda p: p.startswith(b"/* XPM */"), _refused("XPM")),
    ("XVTHUMB", lambda p: p.startswith(b"P7 332"),
     _refused("XVThumb", _xvthumb_check)),
)
# what ImageFile and Image.open turn into "try the next plugin"
_PASS_ON = PASS_ON + (NotThisFormat, TypeError, KeyError, EOFError)


def sniff(data: bytes) -> Opened:
    """The plugin PIL's ``Image.open`` would open ``data`` with, tried in
    PIL's order: its format name and a decoder (``Opened.rgb``). Bytes no
    plugin takes raise ``ValueError``, as PIL's ``UnidentifiedImageError``
    does."""
    prefix = bytes(data[:16])
    for fmt, accept, opener in FORMATS:
        if accept is not None and not accept(prefix):
            continue
        try:
            opened = opener(data)
        except _PASS_ON:
            continue
        if opened.size is not None and min(opened.size) <= 0:
            continue
        return opened
    raise ValueError(f"cannot identify image file (starts {prefix[:8]!r}): "
                     "no format PIL opens takes these bytes")


def decode_image(data: bytes):
    """Image bytes -> (H, W, 3) uint8 RGB, as PIL's
    ``Image.open(...).convert("RGB")`` gives it; the format is found as
    PIL finds it (``sniff``). A format PIL opens that the port does not
    decode raises :class:`NotPortedError` naming PIL's format."""
    return sniff(data).rgb()

