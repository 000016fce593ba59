"""The formats the JAX package's ``pngdec``/``jpegdec`` open through PIL
beside PNG and JPEG, decoded by the port in numpy
(``nnstreamer_tpu_torch/imaging/{bmp,pnm,qoi,tga,gif,tiff,ico,modes}.py``)
and found as PIL's ``Image.open`` finds them (``imaging.sniff``), on the
CPU, PIL the oracle:

* every variant tools/torch_image_files.py writes (BMP/DIB at each depth,
  header and compression, PNM plain and raw at many maxvals and PFM,
  QOI, TGA of each image type, depth and origin, GIF with local and
  global tables, interlace, a frame off the screen and deferred clears,
  TIFF at each compression and predictor, strips and tiles, planar 2,
  both byte orders, BigTIFF, each photometric and extra-sample layout,
  fill order 2 and each orientation, ICO and CUR) and files PIL itself
  saved: the port's decode byte-equal to ``Image.open(...).convert(
  "RGB")`` (tolerance 0) and the format the port finds PIL's;
* PIL's mode conversions to RGB over every sample value;
* the formats PIL opens that the port does not decode raise
  ``NotPortedError`` naming PIL's format; corrupt files fail where PIL
  fails;
* the sniffer's plugin order and the TIFF mode table are PIL's;
* chip_smoke.py's ``MEDIA_FORMAT_SHA256`` are PIL's decodes.

The element lines over these formats (both element names against the
JAX ``jpegdec``, the golden ViT line over a mixed series) are in
tests/test_torch_media.py.
"""
import hashlib
import importlib.util
import io
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
from PIL import Image, TiffImagePlugin

import chip_smoke
import nnstreamer_tpu_torch as pt
from nnstreamer_tpu_torch.imaging import FORMATS, decode_image, sniff
from nnstreamer_tpu_torch.imaging import modes as port_modes
from nnstreamer_tpu_torch.imaging import tiff as port_tiff

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
spec = importlib.util.spec_from_file_location(
    "torch_image_files", os.path.join(ROOT, "tools", "torch_image_files.py"))
imf = importlib.util.module_from_spec(spec)
spec.loader.exec_module(imf)

H, W = 23, 37
RGB = imf.smooth_image(1, H, W).astype(np.uint8)
RGBA = imf.smooth_image(2, H, W, 4).astype(np.uint8)
PAL = imf.random_palette(4, 256)
GREY_PAL = np.stack([np.arange(256)] * 3, -1).astype(np.uint8)
BW_PAL = np.array([[0, 0, 0], [255, 255, 255]], np.uint8)


def _idx(colors, seed=3, h=H, w=W):
    return imf.indexed_image(seed, h, w, colors)


def _bmp_cases():
    c = {}
    for bits, ncol in ((1, 2), (4, 16), (4, 9), (8, 256), (8, 100)):
        idx = _idx(min(ncol, 1 << bits))
        pal = PAL[:ncol]
        c[f"p{bits}_{ncol}"] = imf.bmp_bytes(idx, bits, palette=pal)
        c[f"p{bits}_{ncol}_top_down"] = imf.bmp_bytes(idx, bits, palette=pal,
                                                      top_down=True)
        c[f"p{bits}_{ncol}_os2"] = imf.bmp_bytes(idx, bits, palette=pal,
                                                 header=12)
        c[f"p{bits}_{ncol}_v5"] = imf.bmp_bytes(idx, bits, palette=pal,
                                                header=124)
        if bits == 8:
            c[f"rle8_{ncol}"] = imf.bmp_bytes(idx, 8, "rle8", palette=pal)
            c[f"rle8_{ncol}_top_down"] = imf.bmp_bytes(
                idx, 8, "rle8", palette=pal, top_down=True)
        if bits == 4:
            c[f"rle4_{ncol}"] = imf.bmp_bytes(idx, 4, "rle4", palette=pal)
    c["short_palette"] = imf.bmp_bytes(_idx(256), 8, palette=PAL, colors=50)
    c["grey_palette"] = imf.bmp_bytes(_idx(256), 8, palette=GREY_PAL)
    c["grey_palette_rle8"] = imf.bmp_bytes(_idx(256), 8, "rle8",
                                           palette=GREY_PAL)
    c["black_white"] = imf.bmp_bytes(_idx(2), 1, palette=BW_PAL)
    for bits, comp in ((16, "rgb"), (16, "bitfields"), (24, "rgb"),
                       (32, "rgb"), (32, "bitfields")):
        c[f"{bits}_{comp}"] = imf.bmp_bytes(RGB, bits, comp)
        c[f"{bits}_{comp}_top_down"] = imf.bmp_bytes(RGB, bits, comp,
                                                     top_down=True)
        for hd in (52, 56, 108, 124):
            c[f"{bits}_{comp}_{hd}"] = imf.bmp_bytes(RGB, bits, comp,
                                                     header=hd)
    c["32_alpha_v4"] = imf.bmp_bytes(RGBA, 32, "bitfields", header=108,
                                     alpha=True)
    c["24_os2"] = imf.bmp_bytes(RGB, 24, header=12)
    c["dib_24"] = imf.bmp_bytes(RGB, 24, file_header=False)
    c["dib_p8"] = imf.bmp_bytes(_idx(256), 8, palette=PAL, file_header=False)
    return c


def _pnm_cases():
    c = {}
    g = RGB[..., 0].astype(np.int64)
    bw = _idx(2)
    for m in ("P1", "P4"):
        c[m] = imf.pnm_bytes(bw, m)
        c[m + "_comment"] = imf.pnm_bytes(bw, m, comment="a comment")
    for mv in (1, 7, 100, 255, 256, 1000, 65535):
        for m, x in (("P2", g * mv // 255), ("P5", g * mv // 255),
                     ("P3", RGB.astype(np.int64) * mv // 255),
                     ("P6", RGB.astype(np.int64) * mv // 255)):
            c[f"{m}_{mv}"] = imf.pnm_bytes(x, m, mv,
                                           comment="c" if mv == 7 else None)
    f = ((imf.smooth_image(3, H, W, 1)[..., 0] - 20) * 1.37).astype(
        np.float32)
    f[0, :3] = (np.nan, 1e9, -np.inf)
    c["pfm_le"] = imf.pnm_bytes(f, "Pf", scale=-1.0)
    c["pfm_be"] = imf.pnm_bytes(f, "Pf", scale=2.5)
    return c


def _qoi_cases():
    runs = RGB.copy()
    runs[3:6, :20] = 7
    alpha = RGBA.copy()
    alpha[..., 3] = np.where(alpha[..., 3] > 128, 255, alpha[..., 3])
    return {"rgb": imf.qoi_bytes(runs), "rgba": imf.qoi_bytes(alpha)}


def _tga_cases():
    c = {}
    la = imf.smooth_image(5, H, W, 2).astype(np.uint8)
    for o in ("bottom-left", "top-left", "bottom-right", "top-right"):
        for t in (2, 10):
            c[f"rgb24_{t}_{o}"] = imf.tga_bytes(RGB, t, 24, o)
            c[f"rgba32_{t}_{o}"] = imf.tga_bytes(RGBA, t, 32, o)
            c[f"rgb16_{t}_{o}"] = imf.tga_bytes(RGB, t, 16, o)
        for t in (1, 9):
            for md in (16, 24):
                c[f"map{md}_{t}_{o}"] = imf.tga_bytes(_idx(200), t, 8, o, PAL,
                                                      map_depth=md)
            c[f"map_first_20_{t}_{o}"] = imf.tga_bytes(
                _idx(200), t, 8, o, PAL[:150], map_start=20, ident=b"hello")
        for t in (3, 11):
            c[f"grey8_{t}_{o}"] = imf.tga_bytes(RGB[..., 0], t, 8, o)
            c[f"grey_alpha16_{t}_{o}"] = imf.tga_bytes(la, t, 16, o)
    # a 28-byte ID makes the header start 1C 01 01 00 00, an IPTC field
    # header: PIL's IPTC plugin parses it and passes the bytes on to TGA
    c["map24_1_id28_iptc_prefix"] = imf.tga_bytes(_idx(200), 1, 8,
                                                  palette=PAL,
                                                  ident=bytes(28))
    return c


def _gif_cases():
    c = {}
    idx = _idx(256)
    # 80 x 96 random indices fill the 4096-entry table: clears, deferred
    noise = np.frombuffer(np.random.default_rng(0).bytes(80 * 96),
                          np.uint8).reshape(80, 96)
    c["global"] = imf.gif_bytes(idx, PAL)
    c["local"] = imf.gif_bytes(idx, PAL, local=True)
    c["interlaced"] = imf.gif_bytes(idx, PAL, interlace=True)
    c["noise_clear"] = imf.gif_bytes(noise, PAL)
    c["noise_deferred_clear"] = imf.gif_bytes(noise, PAL, defer_clear=True)
    c["offset"] = imf.gif_bytes(idx, PAL, screen=(50, 40), offset=(9, 7))
    c["offset_transparent"] = imf.gif_bytes(idx, PAL, screen=(50, 40),
                                            offset=(9, 7), transparency=5)
    c["past_the_screen"] = imf.gif_bytes(idx, PAL, screen=(30, 20),
                                         offset=(9, 7))
    c["short_palette"] = imf.gif_bytes(_idx(16), PAL[:5])
    c["grey_palette"] = imf.gif_bytes(idx, GREY_PAL)
    for ms in (2, 4, 8):
        c[f"min_code_size_{ms}"] = imf.gif_bytes(_idx(1 << ms, 5),
                                                 PAL[:1 << ms], min_size=ms)
    c["comment_two_frames"] = imf.gif_bytes(idx, PAL, comment=b"hello",
                                            frames=2)
    return c


def _tiff_cases():
    c = {}
    rgb16 = imf.smooth_image(3, H, W, 3, 16).astype(np.uint16)
    g = RGB[..., 0]
    g16 = imf.smooth_image(4, H, W, 1, 16)[..., 0].astype(np.uint16)
    f32 = ((imf.smooth_image(5, H, W, 1)[..., 0] - 30) * 1.37).astype(
        np.float32)
    i16 = (imf.smooth_image(6, H, W, 1, 16)[..., 0] - 20000).astype(np.int16)
    for comp in (1, 5, 8, 32946, 32773):
        for e, bo in (("<", "II"), (">", "MM")):
            for pr in ((1, 2) if comp != 1 else (1,)):
                t = f"c{comp}_{bo}_p{pr}"
                kw = dict(compression=comp, predictor=pr, byteorder=e)
                c["rgb_" + t] = imf.tiff_bytes(RGB, 2, 8, rows_per_strip=8,
                                               **kw)
                c["rgba_" + t] = imf.tiff_bytes(RGBA, 2, 8, extra=(2,), **kw)
                c["rgb_assoc_alpha_" + t] = imf.tiff_bytes(RGBA, 2, 8,
                                                           extra=(1,), **kw)
                c["rgbx_" + t] = imf.tiff_bytes(RGBA, 2, 8, extra=(0,), **kw)
                c["rgb16_" + t] = imf.tiff_bytes(rgb16, 2, 16,
                                                 rows_per_strip=10, **kw)
                c["grey8_" + t] = imf.tiff_bytes(g, 1, 8, **kw)
                c["grey8_min_is_white_" + t] = imf.tiff_bytes(g, 0, 8, **kw)
                c["grey16_" + t] = imf.tiff_bytes(g16, 1, 16, **kw)
                c["int16_" + t] = imf.tiff_bytes(i16, 1, 16, sample_format=2,
                                                 **kw)
                c["float32_" + t] = imf.tiff_bytes(f32, 1, 32,
                                                   sample_format=3, **kw)
                c["cmyk_" + t] = imf.tiff_bytes(RGBA, 5, 8, **kw)
                c["tiles_" + t] = imf.tiff_bytes(RGB, 2, 8, tile=(16, 16),
                                                 **kw)
                c["planar_" + t] = imf.tiff_bytes(RGB, 2, 8, planar=2,
                                                  rows_per_strip=16, **kw)
                c["planar16_" + t] = imf.tiff_bytes(rgb16, 2, 16, planar=2,
                                                    **kw)
                if e == "<":
                    c["bigtiff_" + t] = imf.tiff_bytes(RGB, 2, 8, bigtiff=True,
                                                       rows_per_strip=7, **kw)
            kw = dict(compression=comp, byteorder=e)
            if comp in (5, 8, 32946):
                c[f"float32_predictor3_c{comp}_{bo}"] = imf.tiff_bytes(
                    f32, 1, 32, predictor=3, sample_format=3, **kw)
            for b in (1, 2, 4):
                v = _idx(1 << b, 6)
                c[f"grey{b}_c{comp}_{bo}"] = imf.tiff_bytes(v, 1, b, **kw)
                c[f"grey{b}_min_is_white_c{comp}_{bo}"] = imf.tiff_bytes(
                    v, 0, b, **kw)
                c[f"palette{b}_c{comp}_{bo}"] = imf.tiff_bytes(
                    v, 3, b, colormap=PAL[:1 << b], **kw)
            c[f"palette8_c{comp}_{bo}"] = imf.tiff_bytes(
                _idx(256, 6), 3, 8, colormap=PAL, **kw)
            c[f"fill_order2_rgb_c{comp}_{bo}"] = imf.tiff_bytes(
                RGB, 2, 8, fill_order=2, **kw)
            c[f"fill_order2_bilevel_c{comp}_{bo}"] = imf.tiff_bytes(
                _idx(2, 6), 1, 1, fill_order=2, **kw)
            for o in range(2, 9):
                c[f"orientation{o}_c{comp}_{bo}"] = imf.tiff_bytes(
                    RGB, 2, 8, orientation=o, **kw)
    return c


def _ico_cases():
    big = imf.smooth_image(8, 32, 32).astype(np.uint8)
    small = imf.smooth_image(9, 16, 16).astype(np.uint8)
    big_rgba = np.concatenate([big, np.full((32, 32, 1), 200, np.uint8)], -1)
    return {
        "png": imf.ico_bytes([imf.png_bytes(RGB, 2, 8)]),
        "bmp_24": imf.ico_bytes([(RGB, 24, None)]),
        "bmp_32": imf.ico_bytes([(big_rgba, 32, None)]),
        "bmp_p8": imf.ico_bytes([(_idx(256, 7, 16, 16), 8, PAL)]),
        "bmp_p4": imf.ico_bytes([(_idx(16, 7, 16, 16), 4, PAL[:16])]),
        "bmp_p1": imf.ico_bytes([(_idx(2, 7, 16, 16), 1, PAL[:2])]),
        "largest_of_three": imf.ico_bytes([(small, 24, None),
                                           (big, 24, None),
                                           imf.png_bytes(small, 2, 8)]),
        "lowest_depth_of_the_largest": imf.ico_bytes([
            (big_rgba, 32, None), (_idx(256, 7, 32, 32), 8, PAL),
            (big, 24, None)]),
        "cur_24": imf.ico_bytes([(RGB, 24, None)], cursor=True),
        "cur_two": imf.ico_bytes([(small, 24, None), (big, 24, None)],
                                 cursor=True),
        "cur_p8": imf.ico_bytes([(_idx(256, 7, 16, 16), 8, PAL)],
                                cursor=True),
    }


WRITTEN = {}
for _fmt, _cases in (("BMP", _bmp_cases), ("PNM", _pnm_cases),
                     ("QOI", _qoi_cases), ("TGA", _tga_cases),
                     ("GIF", _gif_cases), ("TIFF", _tiff_cases),
                     ("ICO", _ico_cases)):
    for _name, _data in _cases().items():
        WRITTEN[f"{_fmt}-{_name}"] = _data


def _pil(data: bytes) -> Image.Image:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        im = Image.open(io.BytesIO(data))
        im.load()
    return im


def _pil_rgb(data: bytes) -> np.ndarray:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return np.asarray(_pil(data).convert("RGB"))


def _check_equal(data: bytes):
    want_fmt = _pil(data).format
    want = _pil_rgb(data)
    opened = sniff(data)
    assert opened.format == want_fmt
    got = opened.rgb()
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", sorted(WRITTEN))
def test_written_file_equals_pil(case):
    """The writer's file: the format PIL finds and its RGB, bitwise."""
    _check_equal(WRITTEN[case])


def _pil_saved():
    base = Image.fromarray(RGBA)
    g16 = imf.smooth_image(4, H, W, 1, 16)[..., 0].astype(np.uint16)
    out = {}

    def save(name, im, fmt, **kw):
        b = io.BytesIO()
        im.save(b, fmt, **kw)
        out[name] = b.getvalue()
    for m in ("1", "L", "P", "RGB", "RGBA"):
        save(f"BMP-{m}", base.convert(m), "BMP")
    save("DIB-RGB", base.convert("RGB"), "DIB")
    for m in ("1", "L", "RGB"):
        save(f"PPM-{m}", base.convert(m), "PPM")
    save("PPM-I;16", Image.fromarray(g16), "PPM")
    for m in ("1", "L", "P", "RGB"):
        save(f"GIF-{m}", base.convert(m), "GIF")
    save("GIF-interlaced-transparency", base.convert("P"), "GIF",
         interlace=True, transparency=3)
    for c in ("raw", "tiff_lzw", "tiff_deflate", "tiff_adobe_deflate",
              "packbits"):
        for m in ("1", "L", "P", "RGB", "RGBA", "CMYK", "LA"):
            save(f"TIFF-{m}-{c}", base.convert(m), "TIFF", compression=c)
        save(f"TIFF-I;16-{c}", Image.fromarray(g16), "TIFF", compression=c)
        save(f"TIFF-F-{c}", Image.fromarray(g16.astype(np.float32) / 7),
             "TIFF", compression=c)
    for m in ("1", "L", "LA", "P", "RGB", "RGBA"):
        for rle in (False, True) if m != "1" else (False,):
            save(f"TGA-{m}-{'rle' if rle else 'raw'}", base.convert(m), "TGA",
                 rle=rle)
    for m in ("RGB", "RGBA"):
        save(f"QOI-{m}", base.convert(m), "QOI")
    icon = Image.fromarray(imf.smooth_image(9, 48, 48, 4).astype(np.uint8))
    save("ICO-png", icon, "ICO", sizes=[(16, 16), (32, 32), (48, 48)])
    save("ICO-bmp", icon, "ICO", sizes=[(16, 16), (32, 32)],
         bitmap_format="bmp")
    save("ICO-bmp-P", icon.convert("P"), "ICO", sizes=[(32, 32)],
         bitmap_format="bmp")
    return out


PIL_SAVED = _pil_saved()


@pytest.mark.parametrize("case", sorted(PIL_SAVED))
def test_pil_saved_file_equals_pil(case):
    """Files PIL itself saved: the format PIL finds and its RGB."""
    _check_equal(PIL_SAVED[case])


# -- PIL's mode conversions ---------------------------------------------------

def _mode_image(mode):
    rng = np.random.default_rng(11)
    if mode in ("I;16", "I;16B"):
        v = rng.integers(0, 65536, (64, 64))
        v[0, :8] = (0, 1, 254, 255, 256, 300, 65535, 1000)
        dt = "<u2" if mode == "I;16" else ">u2"
        return Image.frombytes(mode, (64, 64), v.astype(dt).tobytes()), \
            v.astype(np.int64)
    if mode == "I":
        v = rng.integers(-70000, 70000, (64, 64)).astype(np.int32)
        return Image.frombytes("I", (64, 64), v.tobytes()), v
    if mode == "F":
        v = rng.uniform(-50, 300, (64, 64)).astype(np.float32)
        v[0, :8] = (np.nan, np.inf, -np.inf, 0.5, 254.9, 255.0, 1e10, -0.5)
        return Image.frombytes("F", (64, 64), v.tobytes()), v
    bands = {"1": 1, "L": 1, "P": 1, "LA": 2, "PA": 2, "RGB": 3, "RGBA": 4,
             "RGBX": 4, "RGBa": 4, "CMYK": 4}[mode]
    # every byte value in every band, over 256 x 256 pixels
    a = np.arange(256)
    grid = np.stack(np.meshgrid(a, a, indexing="ij"), -1).reshape(-1, 2)
    v = np.concatenate([grid, grid[:, ::-1]], 1)[:, :bands].astype(np.uint8)
    v = v.reshape(256, 256, bands)
    if mode == "1":
        im = Image.frombytes("L", (256, 256), v.tobytes()).convert("1")
        return im, np.asarray(im.convert("L"))
    if bands == 1:
        v = v[..., 0]
    im = Image.frombytes(mode, (256, 256), v.tobytes())
    if mode in ("P", "PA"):
        im.putpalette(PAL[:100].tobytes())
    return im, v


@pytest.mark.parametrize("mode", list(port_modes.MODES))
def test_mode_to_rgb_equals_pil(mode):
    """modes.to_rgb against PIL's convert("RGB") over every byte value in
    every band (I, I;16, I;16B and F over seeded values and the edges)."""
    im, samples = _mode_image(mode)
    want = np.asarray(im.convert("RGB"))
    got = port_modes.to_rgb(mode, samples, PAL[:100])
    np.testing.assert_array_equal(got, want)


# -- formats the port does not decode, corrupt files --------------------------

REFUSED = {"WEBP": "RGB", "PCX": "RGB", "SGI": "RGB", "SPIDER": "F",
           "IM": "RGB", "JPEG2000": "RGB", "AVIF": "RGB", "DDS": "RGB",
           "ICNS": "RGB", "MSP": "1", "XBM": "1", "EPS": "RGB"}


@pytest.mark.parametrize("fmt", sorted(REFUSED))
def test_refused_format_names_pils_format(fmt):
    """A format PIL opens (and saves here) that the port does not decode
    raises NotPortedError naming PIL's format."""
    size = (16, 16) if fmt == "ICNS" else (W, H)
    im = Image.fromarray(imf.smooth_image(3, size[1], size[0]).astype(
        np.uint8)).convert(REFUSED[fmt])
    b = io.BytesIO()
    try:
        im.save(b, fmt)
    except OSError as e:   # EPS needs Ghostscript only to open, not save
        pytest.fail(f"PIL cannot save {fmt} here: {e}")
    data = b.getvalue()
    assert Image.open(io.BytesIO(data)).format == fmt
    assert sniff(data).format == fmt
    with pytest.raises(pt.NotPortedError, match=repr(fmt)):
        decode_image(data)


def _corrupt():
    c = {}
    gif = WRITTEN["GIF-noise_clear"]
    c["gif_truncated_lzw"] = gif[:len(gif) // 2]
    bad = bytearray(gif)
    bad[900] ^= 0xFF
    c["gif_broken_code"] = bytes(bad)
    tif = bytearray(WRITTEN["TIFF-rgb_c1_II_p1"])
    tif[4:8] = (10 ** 6).to_bytes(4, "little")
    c["tiff_bad_ifd_offset"] = bytes(tif)
    lzw = imf.tiff_bytes(RGB, 2, 8, 5)
    ifd = int.from_bytes(lzw[4:8], "little")
    c["tiff_truncated_lzw_strip"] = lzw[:40] + bytes(ifd - 40) + lzw[ifd:]
    c["tiff_corrupt_deflate"] = imf.tiff_bytes(RGB, 2, 8, 8)[:8] + \
        b"\x00" * 64 + imf.tiff_bytes(RGB, 2, 8, 8)[72:]
    c["bmp_truncated"] = WRITTEN["BMP-24_rgb"][:-100]
    rle = WRITTEN["BMP-rle8_256"]
    c["bmp_rle_ends_early"] = rle[:len(rle) // 2]
    c["tga_run_past_the_row"] = b"\0\0\x0b" + bytes(9) + \
        (3).to_bytes(2, "little") + (2).to_bytes(2, "little") + \
        b"\x08\x20" + bytes([0x84, 9])
    c["tga_truncated"] = WRITTEN["TGA-rgb24_2_top-left"][:-50]
    c["ppm_truncated"] = WRITTEN["PNM-P6_255"][:-10]
    c["ppm_plain_short"] = WRITTEN["PNM-P3_255"][:-40]
    c["ppm_plain_over_maxval"] = b"P2\n2 1\n10\n5 11\n"
    c["qoi_truncated"] = WRITTEN["QOI-rgb"][:-60]
    c["bmp_grey_4bit"] = imf.bmp_bytes(_idx(16), 4, palette=GREY_PAL[:16])
    c["bmp_black_white_rle8"] = imf.bmp_bytes(_idx(2), 8, "rle8",
                                              palette=BW_PAL)
    c["tga_32bit_map"] = imf.tga_bytes(_idx(200), 1, 8, palette=PAL,
                                       map_depth=32)
    b = io.BytesIO()    # PIL writes a 1-bit RLE TGA it cannot read back
    Image.fromarray(RGB).convert("1").save(b, "TGA", rle=True)
    c["tga_1bit_rle_pil_saved"] = b.getvalue()
    return c


CORRUPT = _corrupt()


@pytest.mark.parametrize("case", sorted(CORRUPT))
def test_corrupt_file_fails_where_pil_fails(case):
    """A truncated LZW stream, a code past the table, a bad IFD offset, a
    short strip, an RLE stream that ends early, a run packet past the
    row, ... : PIL fails to open or to decode, and so does the port,
    loudly (ValueError, never a frame)."""
    data = CORRUPT[case]
    with pytest.raises(Exception):
        _pil_rgb(data)
    with pytest.raises(ValueError):
        decode_image(data)


def test_rle_escapes_as_pil_reads_them():
    """BMP RLE as PIL reads it, not as the format describes it: an encoded
    run past the row's end is cut, an odd RLE4 literal loses its last
    pixel, and the delta escape skips its own two bytes and takes the two
    after them as its offsets."""
    pal = PAL[:16]
    for rle4, body in (
            (False, bytes([9, 5, 0, 0, 3, 6, 0, 1])),        # run of 9 in 4
            (True, bytes([0, 3, 0x12, 0x30, 0, 0, 2, 7, 0, 1])),
            (False, bytes([2, 1, 0, 2, 1, 1, 1, 0, 2, 3, 0, 1]))):
        idx = np.zeros((3, 4), np.uint8)
        data = bytearray(imf.bmp_bytes(idx, 4 if rle4 else 8,
                                       "rle4" if rle4 else "rle8",
                                       palette=pal))
        off = int.from_bytes(data[10:14], "little")
        data = bytes(data[:off]) + body + bytes(40)
        try:
            want = _pil_rgb(data)
        except Exception:
            with pytest.raises(ValueError):
                decode_image(data)
            continue
        np.testing.assert_array_equal(decode_image(data), want)


# -- the tables ---------------------------------------------------------------

def test_sniff_order_is_pils():
    """FORMATS lists PIL's plugins in the order a fresh process's
    Image.open tries them (preinit's five, then init's)."""
    out = subprocess.run(
        [sys.executable, "-c", "from PIL import Image; Image.preinit(); "
         "Image.init(); print(' '.join(Image.ID))"],
        capture_output=True, text=True, check=True)
    assert [f for f, _, _ in FORMATS] == out.stdout.split()


def test_tiff_open_info_is_pils():
    assert port_tiff.OPEN_INFO == TiffImagePlugin.OPEN_INFO


def _iptc(*fields):
    return b"".join(b"\x1c" + bytes(tag) + len(v).to_bytes(2, "big") + v
                    for tag, v in fields)


_IPTC_L = ((3, 60), b"\1\0"), ((3, 20), b"\5"), ((3, 30), b"\3")
# bytes a refused plugin's accept test takes, each where PIL's _open opens
# them, passes them on or fails
SNIFF_EDGES = {
    "wmf_no_emf_signature": b"\1\0\0\0" + bytes(60),
    "wmf_placeable_zero_inch": b"\xd7\xcd\xc6\x9a\0\0" + bytes(60),
    "wmf_placeable": b"\xd7\xcd\xc6\x9a\0\0" + bytes(4) +
    (40).to_bytes(2, "little") + (30).to_bytes(2, "little") +
    (72).to_bytes(2, "little") + bytes(6) + b"\x01\x00\t\x00" + bytes(30),
    "emf": b"\1\0\0\0" + bytes(4) + np.array(
        [0, 0, 40, 30, 0, 0, 1000, 800], "<i4").tobytes() + b" EMF" +
    bytes(20),
    "mpeg_short": b"\0\0\1\xb3\x01",
    "mpeg": b"\0\0\1\xb3\x01\x40\xf0" + bytes(10),
    "pixar_no_mode": b"\x80\xe8\0\0" + bytes(600),
    "mcidas_unsupported": b"\0" * 7 + b"\4" + bytes(300),
    "xvthumb": b"P7 332\n#comment\n12 13 255\n" + bytes(156),
    "xvthumb_bad_size": b"P7 332\n#comment\nab\n",
    "xvthumb_no_size": b"P7 332\n#comment\n",
    "msp_bad_checksum": b"DanM" + bytes(40),
    "psd_version_0": b"8BPS" + bytes(30),
    "sun_depth_0": b"\x59\xa6\x6a\x95" + bytes(40),
    "gbr_v2": np.array([28, 2, 4, 4, 1], ">u4").tobytes() + b"GIMP" +
    bytes(40),
    "gbr_zero_width": np.array([20, 1, 0, 4, 1], ">u4").tobytes() + bytes(40),
    "xbm": b"#define a_width 4\n#define a_height 2\n"
           b"static char a_bits[] = {0,0};\n",
    "xbm_no_bits": b"#define foo 1\n",
    "iptc_grey": _iptc(*_IPTC_L, ((3, 120), b"\1")) + b"\x1c\x08\x0a\x80" +
    bytes(15),
    "iptc_no_compression": _iptc(*_IPTC_L) + b"\x1c\x08\x0a\x80" + bytes(15),
    "iptc_field_too_long": b"\x1c\x03\x3c\x90" + bytes(20),
    "iptc_no_mode": _iptc(((3, 20), b"\5"), ((3, 120), b"\1")) + bytes(5),
}


@pytest.mark.parametrize("case", sorted(SNIFF_EDGES))
def test_sniff_edge_bytes_as_pil(case):
    """Bytes a refused plugin's accept test takes: where PIL's ``_open``
    passes them on the port does too (to a later plugin, or to
    ``ValueError`` when none takes them), where it fails the port
    raises ValueError, and where PIL opens them the port names the
    same format."""
    data = SNIFF_EDGES[case]
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            fmt = Image.open(io.BytesIO(data)).format
    except Exception:
        fmt = None
    if fmt is None:
        with pytest.raises(ValueError):
            sniff(data)
        return
    assert sniff(data).format == fmt
    with pytest.raises(pt.NotPortedError, match=repr(fmt)):
        decode_image(data)


def test_unidentified_bytes_fail_as_in_pil():
    for data in (b"GIF89a....", b"not an image at all", bytes(64)):
        with pytest.raises(Exception):
            _pil_rgb(data)
        with pytest.raises(ValueError, match="cannot identify"):
            decode_image(data)


# -- chip_smoke.py's digests --------------------------------------------------

def test_chip_smoke_format_digests_are_pil_decodes():
    """chip_smoke.py holds the card machine's decodes (no PIL there) to
    SHA-256 constants; they are PIL's decodes of the same seeded files,
    one a variant, and the port gives them here too."""
    files = chip_smoke.media_format_files(imf)
    assert sorted(files) == sorted(chip_smoke.MEDIA_FORMAT_SHA256)
    assert sorted(files) == sorted(imf.format_variants())
    for name, data in files.items():
        want = chip_smoke.MEDIA_FORMAT_SHA256[name]
        assert hashlib.sha256(_pil_rgb(data).tobytes()).hexdigest() == \
            want, name
        assert hashlib.sha256(decode_image(data).tobytes()).hexdigest() == \
            want, name


def test_mixed_series_spans_every_format():
    """The first MEDIA_FRAMES variants (phase 48's mixed line) hold every
    format the port decodes beside PNG and JPEG."""
    img = imf.smooth_image(0, 24, 32).astype(np.uint8)
    first = list(imf.format_variants().items())[:chip_smoke.MEDIA_FRAMES]
    found = {sniff(w(img)).format for _, w in first}
    assert found == {"BMP", "DIB", "PPM", "QOI", "TGA", "GIF", "TIFF",
                     "ICO", "CUR"}
