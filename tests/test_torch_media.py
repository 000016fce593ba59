"""The port's media elements (elements/media.py ``pngdec``, ``jpegdec``,
``videoscale``; imaging/{png,jpeg,resample}.py) and the ``direct_video``
and ``python3`` decoders against PIL and the JAX package, on the CPU.

The JAX package's ``pngdec``/``jpegdec`` and ``videoscale`` call PIL;
the port decodes and resizes in numpy. Here PIL is the oracle:

* ``videoscale``: both packages' elements on the same seeded frames, in
  RGB, BGR, RGBA (random alpha), BGRx and GRAY8, up-, down- and mixed
  scales, 1xN and Nx1 targets and 640x480 -> 224x224;
* PNG: every colour type, depth, filter strategy and interlace mode of
  tools/torch_image_files.py, palettes with and without ``tRNS``, and
  PNGs that PIL saved, against ``Image.open(...).convert("RGB")``; a
  corrupt CRC raises;
* JPEG: the writer's files and PIL-saved ones against PIL's decode
  through libjpeg-turbo: baseline and progressive (quality 50/75/95,
  ``subsampling`` 0/1/2, with and without restart markers, grey, CMYK),
  every progressive file cut after 1..9 scans (block smoothing), the
  writer's scan scripts, CMYK/YCCK and RGB-stored files, the JFIF/Adobe
  precedence, h1v2, h4v1 and other integral sampling; non-integral
  sampling and MCUs of more than 10 blocks fail as they fail in PIL;
  the writer's lossless files (every predictor) too, YCbCr lossless
  failing in both; its arithmetic-coded files (sequential, progressive,
  DAC conditioning); 12-bit, hierarchical, arithmetic-coded lossless and
  DNL files raise ``NotPortedError``;
* chip_smoke.py's JPEG digests are PIL's decode of its seeded files;
* the other formats PIL opens (tests/test_torch_formats.py holds each
  decoder to PIL): both element names over BMP, PPM, QOI, TGA, GIF,
  TIFF, ICO and mixed series against the JAX ``jpegdec``; a divergence
  kept: WebP, PCX, SGI and JPEG 2000 decode in the JAX package's
  ``jpegdec`` (PIL) and raise ``NotPortedError``, named, in the port's;
* the golden line shape ``filesrc ! pngdec ! videoscale ! videoconvert !
  tensor_converter ! tensor_filter`` in both packages, through a small
  u8 ``.tflite`` (within 1 LSB, argmax equal) and through a small ViT
  (tests/test_torch_pipeline.py's bf16 tolerance, 3e-2 absolute, argmax
  equal), the ViT line again over a mixed-format series (``jpegdec``);
* ``direct_video`` and ``python3``: equal frames and caps in both
  packages;
* chip_smoke.py's device-time arithmetic with fake profiler events (a
  full count gives the mean, a short one none; a time under the bound
  fails the phase).

Tolerance where not stated: none; the comparison is bitwise.
"""
import hashlib
import importlib.util
import io
import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as pt
from nnstreamer_tpu.models import zoo as jax_zoo
from nnstreamer_tpu_torch.imaging import (decode_image, decode_jpeg,
                                          decode_png, resize_bilinear)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT,
                                                                     rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


imf = _load("torch_image_files", "tools/torch_image_files.py")
mf = _load("torch_model_files", "tools/torch_model_files.py")
PKGS = {"jax": nt, "port": pt}
BF16_ATOL = 3e-2


@pytest.fixture(autouse=True)
def _keep_element_name_counters():
    """Each package names an unnamed element from a process-wide counter;
    this file's lines (often in one package only) leave both counters as
    they found them, so a later file in the same process that compares
    the two packages' generated names sees what it would without this
    one."""
    from nnstreamer_tpu.pipeline.element import Element as NtElement
    from nnstreamer_tpu_torch.pipeline.element import Element
    saved = Element._anon_counter[0], NtElement._anon_counter[0]
    yield
    Element._anon_counter[0], NtElement._anon_counter[0] = saved


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two torch threads: tier-1 runs six test workers on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


# -- videoscale ----------------------------------------------------------------

CHANNELS = {"RGB": 3, "BGR": 3, "RGBA": 4, "BGRx": 4, "GRAY8": 1}
SCALES = {"down": ((48, 64), (30, 40)), "up": ((20, 30), (45, 71)),
          "mixed": ((40, 30), (25, 61)), "1xN": ((17, 23), (1, 9)),
          "Nx1": ((17, 23), (9, 1)), "vga_to_224": ((480, 640), (224, 224))}


def _video_frames(fmt, h, w, n=2, seed=0):
    rng = np.random.default_rng(seed)
    frames = []
    for _ in range(n):
        f = rng.integers(0, 256, (h, w, CHANNELS[fmt]), np.uint8)
        if fmt == "RGBA":   # some fully clear and fully opaque pixels too
            f[..., 3] = rng.choice([0, 1, 77, 128, 254, 255], size=(h, w))
        frames.append(f)
    return frames


def _videoscale(pkg, fmt, frames, oh, ow):
    h, w = frames[0].shape[:2]
    caps = f"video/x-raw,format={fmt},width={w},height={h},framerate=0/1"
    p = PKGS[pkg].parse_launch(
        f'appsrc name=in caps="{caps}" ! videoscale width={ow} height={oh} '
        "! appsink name=out")
    p.start()
    try:
        for f in frames:
            p["in"].push_buffer(PKGS[pkg].Buffer.from_arrays([f]))
        p["in"].end_stream()
        assert p.wait_eos(60)
    finally:
        p.stop()
    return ([np.asarray(b.chunks[0].host()) for b in p["out"].buffers],
            str(p["out"].sinkpad.caps))


@pytest.mark.parametrize("scale", sorted(SCALES))
@pytest.mark.parametrize("fmt", sorted(CHANNELS))
def test_videoscale_equals_jax_pil(fmt, scale):
    (h, w), (oh, ow) = SCALES[scale]
    frames = _video_frames(fmt, h, w, seed=h * w + oh)
    got, got_caps = _videoscale("port", fmt, frames, oh, ow)
    want, want_caps = _videoscale("jax", fmt, frames, oh, ow)
    assert got_caps == want_caps
    assert [g.shape for g in got] == [w_.shape for w_ in want] == \
        [(oh, ow, CHANNELS[fmt])] * len(frames)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g, w_)


@pytest.mark.parametrize("pad", [0, 255])
def test_videoscale_bgrx_pad_byte_acts_as_alpha(pad):
    """Reference behaviour, kept (ROADMAP.md C): the JAX element hands a
    BGRx frame to PIL as RGBA, so its pad byte is alpha. With pad 0 the
    premultiplied colours are 0 and stay 0; with pad 255 the colours
    resize as an RGB frame's do. Both packages agree."""
    frames = _video_frames("BGRx", 24, 32, seed=pad)
    for f in frames:
        f[..., 3] = pad
    got, _ = _videoscale("port", "BGRx", frames, 12, 20)
    want, _ = _videoscale("jax", "BGRx", frames, 12, 20)
    for g, w_, f in zip(got, want, frames):
        np.testing.assert_array_equal(g, w_)
        if pad == 0:
            assert not g[..., :3].any()
        else:
            np.testing.assert_array_equal(
                g[..., :3], resize_bilinear(np.ascontiguousarray(
                    f[..., :3]), 20, 12))


def test_videoscale_same_size_passes_the_buffer_through():
    frames = _video_frames("RGB", 12, 16)
    got, _ = _videoscale("port", "RGB", frames, 12, 16)
    for g, f in zip(got, frames):
        np.testing.assert_array_equal(g, f)


@pytest.mark.parametrize("box", [(3, 5, 4), (7, 2, 1), (64, 1, 3),
                                 (1, 64, 4), (33, 47, 1)])
def test_resize_bilinear_equals_pil_over_many_sizes(box):
    """The resampler alone on every target size 1..12 x 1..12 of one
    source."""
    h, w, c = box
    rng = np.random.default_rng(h * 100 + w)
    f = rng.integers(0, 256, (h, w, c), np.uint8)
    src = f[..., 0] if c == 1 else f
    for oh in range(1, 13):
        for ow in range(1, 13):
            want = np.asarray(Image.fromarray(src).resize((ow, oh),
                                                          Image.BILINEAR))
            np.testing.assert_array_equal(resize_bilinear(src, ow, oh), want)


# -- PNG -----------------------------------------------------------------------

PNG_CASES = [(ct, d, il) for ct, d in imf.png_cases() for il in (False, True)]


@pytest.mark.parametrize("ct,depth,interlace", PNG_CASES,
                         ids=[f"ct{c}-d{d}-{'adam7' if i else 'plain'}"
                              for c, d, i in PNG_CASES])
def test_png_writer_cases_equal_pil(ct, depth, interlace):
    """Every filter strategy, three sizes (one 1x1), palettes with and
    without tRNS, grey and RGB colour keys."""
    for strategy in imf.FILTERS:
        for h, w in ((23, 37), (1, 1), (9, 2)):
            kws = [{}]
            if ct == 3:
                kws.append({"trns": [0, 128, 255][:1 << depth]})
            if ct in (0, 2) and depth == 8:
                kws.append({"trns": [5] if ct == 0 else [5, 6, 7]})
            for kw in kws:
                data = imf.png_case(ct, depth, seed=h + w, height=h, width=w,
                                    interlace=interlace, strategy=strategy,
                                    idat_chunks=3, **kw)
                np.testing.assert_array_equal(decode_png(data),
                                              _pil_rgb(data))


PIL_MODES = ("RGB", "RGBA", "L", "LA", "P", "1", "I;16")


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("mode", PIL_MODES)
def test_png_saved_by_pil_equals_pil(mode, optimize):
    if mode == "I;16":
        im = Image.fromarray(imf.smooth_image(2, 40, 50, 1, 16)[..., 0]
                             .astype(np.uint16))
    else:
        im = Image.fromarray(imf.smooth_image(2, 40, 50).astype(np.uint8))
        im = im.convert(mode)
    buf = io.BytesIO()
    im.save(buf, "PNG", optimize=optimize)
    data = buf.getvalue()
    np.testing.assert_array_equal(decode_png(data), _pil_rgb(data))


def test_png_corrupt_crc_fails_loud():
    data = bytearray(imf.png_case(2, 8))
    # flip one byte inside the IDAT body
    idat = data.index(b"IDAT")
    data[idat + 10] ^= 0x55
    with pytest.raises(ValueError, match="CRC"):
        decode_png(bytes(data))
    with pytest.raises(ValueError, match="truncated"):
        decode_png(bytes(data[:idat + 20]))


def test_png_wavefront_equals_row_by_row():
    """The anti-diagonal unfilter against a plain per-byte loop of the
    PNG specification's filters."""
    from nnstreamer_tpu_torch.imaging import png as png_mod
    rng = np.random.default_rng(3)
    for bpp, h, units in ((3, 5, 7), (1, 9, 4), (8, 2, 3), (4, 1, 1)):
        f = rng.integers(0, 256, (h, units * bpp), np.uint8)
        types = rng.integers(0, 5, h).astype(np.uint8)
        want = np.zeros((h, units * bpp), np.int64)
        for r in range(h):
            for i in range(units * bpp):
                a = want[r, i - bpp] if i >= bpp else 0
                b = want[r - 1, i] if r else 0
                c = want[r - 1, i - bpp] if r and i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                paeth = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                pred = (0, a, b, (a + b) // 2, paeth)[types[r]]
                want[r, i] = (int(f[r, i]) + pred) % 256
        got = png_mod._unfilter_wavefront(f, types, bpp)
        np.testing.assert_array_equal(got, want)


# -- JPEG ----------------------------------------------------------------------

JPEG_SIZES = ((240, 320), (17, 23), (9, 31), (2, 3), (1, 1))


@pytest.mark.parametrize("restart", [0, 1, 5])
@pytest.mark.parametrize("subsampling", ["444", "422", "420"])
def test_jpeg_writer_files_equal_pil(subsampling, restart):
    for h, w in JPEG_SIZES:
        for quality in (50, 75, 95):
            img = imf.smooth_image(h * w + quality, h, w).astype(np.uint8)
            data = imf.jpeg_bytes(img, quality, subsampling, restart)
            np.testing.assert_array_equal(decode_jpeg(data), _pil_rgb(data))


@pytest.mark.parametrize("restart", [0, 2])
@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("quality", [50, 75, 95])
def test_jpeg_saved_by_pil_equals_pil(quality, subsampling, restart):
    for h, w in JPEG_SIZES:
        img = imf.smooth_image(h + w + quality, h, w).astype(np.uint8)
        buf = io.BytesIO()
        kw = {"restart_marker_blocks": restart} if restart else {}
        Image.fromarray(img).save(buf, "JPEG", quality=quality,
                                  subsampling=subsampling, **kw)
        data = buf.getvalue()
        if restart:
            assert b"\xff\xdd" in data
        np.testing.assert_array_equal(decode_jpeg(data), _pil_rgb(data))


@pytest.mark.parametrize("source", ["writer", "pil"])
def test_jpeg_gray_equals_pil(source):
    for h, w in JPEG_SIZES:
        g = imf.smooth_image(h + 2 * w, h, w, 1).astype(np.uint8)[..., 0]
        if source == "writer":
            data = imf.jpeg_bytes(g, 80)
        else:
            buf = io.BytesIO()
            Image.fromarray(g).save(buf, "JPEG", quality=60)
            data = buf.getvalue()
        np.testing.assert_array_equal(decode_jpeg(data), _pil_rgb(data))


def _pil_jpeg(img, **kw):
    buf = io.BytesIO()
    img.save(buf, "JPEG", **kw)
    return buf.getvalue()


def _pil_progressive(img, quality=75, subsampling=2, restart=0):
    kw = {"restart_marker_blocks": restart} if restart else {}
    return _pil_jpeg(img, quality=quality, subsampling=subsampling,
                     progressive=True, **kw)


@pytest.mark.parametrize("restart", [0, 2])
@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("quality", [50, 75, 95])
def test_jpeg_progressive_saved_by_pil_equals_pil(quality, subsampling,
                                                  restart):
    """libjpeg's simple progression (10 scans: DC first and refine, AC
    first with EOB runs, AC refine with correction bits)."""
    for h, w in JPEG_SIZES:
        img = Image.fromarray(imf.smooth_image(h + w + quality, h, w)
                              .astype(np.uint8))
        data = _pil_progressive(img, quality, subsampling, restart)
        assert b"\xff\xc2" in data
        if restart:
            assert b"\xff\xdd" in data
        np.testing.assert_array_equal(decode_jpeg(data), _pil_rgb(data))


@pytest.mark.parametrize("mode", ["L", "CMYK"])
def test_jpeg_progressive_gray_and_cmyk_saved_by_pil_equal_pil(mode):
    """The all-purpose script of other colour spaces (6 scans grey, 18
    CMYK)."""
    channels = 4 if mode == "CMYK" else 1
    for h, w in JPEG_SIZES:
        px = imf.smooth_image(2 * h + w, h, w, channels).astype(np.uint8)
        img = Image.fromarray(px if channels == 4 else px[..., 0], mode)
        data = _pil_progressive(img)
        np.testing.assert_array_equal(decode_jpeg(data), _pil_rgb(data))


# sizes whose block grids reach every edge case of the smoothing
# neighbourhood: one or two blocks across, an iMCU row with one block row
# left, narrow chroma
SMOOTH_SIZES = ((240, 320), (17, 23), (33, 50), (40, 17), (16, 16), (25, 9),
                (8, 16), (9, 31), (2, 3))


@pytest.mark.parametrize("scans", range(1, 10))
def test_jpeg_progressive_prefix_smoothing_equals_pil(scans):
    """A PIL progressive file cut after ``scans`` scans, EOI appended:
    some low coefficients are still unknown at EOI, so libjpeg-turbo's
    block smoothing estimates them from the 5x5 neighbourhood of DC
    values (only the DC is smoothed after the first scan)."""
    from nnstreamer_tpu_torch.imaging import jpeg as jpeg_mod
    for h, w in SMOOTH_SIZES:
        for mode, sub in (("RGB", 2), ("RGB", 0), ("L", 0)):
            if mode == "L" and scans >= 6:
                continue     # grey has 6 scans: nothing is cut
            img = Image.fromarray(imf.smooth_image(3 * h + w, h, w)
                                  .astype(np.uint8)).convert(mode)
            data = imf.jpeg_prefix(_pil_progressive(img, 75, sub), scans)
            # every cut leaves some low coefficient unknown
            assert jpeg_mod._smoothing_on(jpeg_mod._read(data).comps)
            np.testing.assert_array_equal(decode_jpeg(data), _pil_rgb(data))


JPEG_SCRIPTS = {
    "simple": True,
    # spectral selection only: every coefficient in one pass
    "spectral": [((0, 1, 2), 0, 0, 0, 0), ((0,), 1, 9, 0, 0),
                 ((0,), 10, 63, 0, 0), ((1,), 1, 63, 0, 0),
                 ((2,), 1, 63, 0, 0)],
    # never refined to Al 0: a complete file that block smoothing fills
    # in, its estimates clamped to the bits still unknown
    "unrefined": [((0, 1, 2), 0, 0, 0, 2), ((0,), 1, 63, 0, 3),
                  ((1,), 1, 63, 0, 1), ((2,), 1, 63, 0, 2)],
    # DC of one component alone, then of two interleaved; three
    # refinements of DC and AC
    "deep": [((0,), 0, 0, 0, 3), ((1, 2), 0, 0, 0, 3),
             ((0, 1, 2), 0, 0, 3, 2), ((0,), 1, 2, 0, 4),
             ((0,), 3, 63, 0, 4), ((0,), 1, 63, 4, 3), ((0,), 1, 63, 3, 2),
             ((1,), 1, 63, 0, 1), ((2,), 1, 63, 0, 1),
             ((0, 1, 2), 0, 0, 2, 1), ((0,), 1, 63, 2, 1),
             ((0, 1, 2), 0, 0, 1, 0), ((0,), 1, 63, 1, 0),
             ((1,), 1, 63, 1, 0)],
    # DC alone: the smoothing that also moves the DC
    "dc_only": [((0, 1, 2), 0, 0, 0, 0)],
    # a few AC known exactly, the rest estimated without a clamp
    "dc_and_two_ac": [((0, 1, 2), 0, 0, 0, 0), ((0,), 1, 1, 0, 0),
                      ((1,), 2, 2, 0, 0)]}


@pytest.mark.parametrize("restart", [0, 1, 4])
@pytest.mark.parametrize("script", sorted(JPEG_SCRIPTS))
def test_jpeg_writer_progressive_equals_pil(script, restart):
    """tools/torch_image_files.py's progressive encoder (jcphuff.c's four
    scan kinds, optimal tables a scan) under each scan script, with and
    without restart intervals (EOB runs and correction bits end at each
    marker)."""
    for h, w in ((48, 64), (17, 23), (9, 31), (1, 1), (16, 16)):
        for quality, sub in ((30, "420"), (75, "444"), (97, "422")):
            img = imf.smooth_image(h + 3 * w + quality, h, w).astype(
                np.uint8)
            data = imf.jpeg_bytes(img, quality, sub, restart,
                                  progressive=JPEG_SCRIPTS[script])
            np.testing.assert_array_equal(decode_jpeg(data), _pil_rgb(data))


@pytest.mark.parametrize("scans", range(1, 11))
def test_jpeg_writer_progressive_prefix_equals_pil(scans):
    for h, w in ((48, 64), (17, 23), (40, 17)):
        img = imf.smooth_image(h + w, h, w).astype(np.uint8)
        data = imf.jpeg_prefix(imf.jpeg_bytes(img, 75, "420", 2,
                                              progressive=True), scans)
        np.testing.assert_array_equal(decode_jpeg(data), _pil_rgb(data))


COLOR_CASES = {
    "cmyk_adobe": dict(color="cmyk"),
    "cmyk_no_marker": dict(color="cmyk", adobe=None),
    "cmyk_progressive": dict(color="cmyk", progressive=True),
    "ycck": dict(color="ycck"),
    "ycck_progressive": dict(color="ycck", progressive=True),
    "ycck_subsampled": dict(color="ycck", subsampling="420"),
    "adobe_rgb": dict(color="rgb"),
    "adobe_rgb_progressive": dict(color="rgb", progressive=True),
    "rgb_ids": dict(color="rgb", adobe=None, ids=b"RGB")}


@pytest.mark.parametrize("case", sorted(COLOR_CASES))
def test_jpeg_writer_colour_modes_equal_pil(case):
    """CMYK (PIL reads it inverted, then cmyk2rgb), YCCK (libjpeg's
    ycck_cmyk_convert first) and RGB-stored files (no colour
    transform)."""
    kw = dict(COLOR_CASES[case])
    channels = 4 if kw["color"] in ("cmyk", "ycck") else 3
    for h, w in JPEG_SIZES:
        img = imf.smooth_image(h + 5 * w, h, w, channels).astype(np.uint8)
        data = imf.jpeg_bytes(img, 80, **kw)
        np.testing.assert_array_equal(decode_jpeg(data), _pil_rgb(data))


SAMPLING_CASES = {
    "h1v2": dict(subsampling="440"),
    "h4v1": dict(subsampling="411"),
    "h1v2_progressive": dict(subsampling="440", progressive=True),
    "h4v1_progressive": dict(subsampling="411", progressive=True),
    "luma_h1v1_chroma_h2v2": dict(factors=[(1, 1), (2, 2), (2, 2)]),
    "h1v4": dict(factors=[(1, 4), (1, 1), (1, 1)]),
    "h3v1": dict(factors=[(3, 1), (1, 1), (1, 1)]),
    "h2v2_h2v1_h1v1": dict(factors=[(2, 2), (2, 1), (1, 1)]),
    "h4v1_h2v1_h1v1": dict(factors=[(4, 1), (2, 1), (1, 1)])}


@pytest.mark.parametrize("case", sorted(SAMPLING_CASES))
def test_jpeg_writer_sampling_equals_pil(case):
    """jdsample.c's choice a component at a time, by its ratio to the
    largest factors: fancy h1v2, h2v1 and h2v2, replication for every
    other integral ratio."""
    for h, w in JPEG_SIZES:
        img = imf.smooth_image(h + 7 * w, h, w).astype(np.uint8)
        data = imf.jpeg_bytes(img, 85, **SAMPLING_CASES[case])
        np.testing.assert_array_equal(decode_jpeg(data), _pil_rgb(data))


@pytest.mark.parametrize("factors", [(2, 2), (1, 2), (3, 1)])
def test_jpeg_gray_with_declared_sampling_equals_pil(factors):
    """One component whose SOF declares sampling factors other than 1x1:
    its block grid pads to whole MCUs of that size, and block smoothing
    counts its iMCU rows by it."""
    for h, w in ((17, 23), (33, 50), (1, 1)):
        g = imf.smooth_image(h + w, h, w, 1).astype(np.uint8)[..., 0]
        for kw in ({}, {"progressive": True}):
            data = imf.jpeg_bytes(g, 70, factors=[factors], **kw)
            cuts = [imf.jpeg_prefix(data, k) for k in (1, 3)] if kw else []
            for d in [data] + cuts:
                np.testing.assert_array_equal(decode_jpeg(d), _pil_rgb(d))


def _splice_adobe(data: bytes, transform: int) -> bytes:
    """``data`` with an Adobe APP14 segment after its APP0."""
    app0 = data.index(b"\xff\xe0")
    end = app0 + 2 + int.from_bytes(data[app0 + 2:app0 + 4], "big")
    return (data[:end] + b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00"
            + bytes([transform]) + data[end:])


# (writer arguments, the colour space libjpeg-turbo takes): a JFIF marker
# means YCbCr whatever the Adobe marker or the ids say; without one the
# Adobe transform decides; without either, the ids R, G, B mean RGB
PRECEDENCE = {
    "jfif_and_adobe0": (dict(color="rgb", jfif=True), "YCbCr"),
    "jfif_and_rgb_ids": (dict(color="rgb", adobe=None, jfif=True,
                              ids=b"RGB"), "YCbCr"),
    "adobe0": (dict(color="rgb"), "RGB"),
    "adobe1_and_rgb_ids": (dict(color="rgb", adobe=1, ids=b"RGB"), "YCbCr"),
    "adobe0_ycbcr_ids": (dict(color="rgb", ids=[1, 2, 3]), "RGB"),
    "rgb_ids": (dict(color="rgb", adobe=None, ids=b"RGB"), "RGB"),
    "other_ids": (dict(jfif=False, ids=[5, 6, 7]), "YCbCr"),
    "adobe2_three_components": (dict(adobe=2, jfif=False), "YCbCr")}


@pytest.mark.parametrize("case", sorted(PRECEDENCE))
def test_jpeg_colour_space_precedence_equals_pil(case):
    """jdapimin.c default_decompress_parms, settled by the oracle on
    files with both markers: the port picks the space named here and
    decodes as PIL does."""
    from nnstreamer_tpu_torch.imaging import jpeg as jpeg_mod
    kw, space = PRECEDENCE[case]
    img = imf.smooth_image(13, 24, 40).astype(np.uint8)
    data = imf.jpeg_bytes(img, 90, **kw)
    f = jpeg_mod._read(data)
    assert jpeg_mod._color_space(len(f.comps), f.jfif, f.adobe,
                                 [c.cid for c in f.comps]) == space
    np.testing.assert_array_equal(decode_jpeg(data), _pil_rgb(data))


@pytest.mark.parametrize("transform", [0, 1, 2])
def test_jpeg_pil_file_with_adobe_spliced_in_equals_pil(transform):
    """A PIL-saved JFIF file with an Adobe marker spliced in after its
    APP0: JFIF wins, so the transform changes nothing."""
    img = Image.fromarray(imf.smooth_image(14, 30, 44).astype(np.uint8))
    base = _pil_jpeg(img, quality=85)
    data = _splice_adobe(base, transform)
    np.testing.assert_array_equal(decode_jpeg(data), _pil_rgb(data))
    np.testing.assert_array_equal(decode_jpeg(data), decode_jpeg(base))


def _non_integral_sampling_file() -> bytes:
    """A 4:4:4 file whose SOF says luma 3x1 and Cb 2x1: 3/2 is not an
    integral ratio."""
    data = bytearray(imf.jpeg_bytes(imf.smooth_image(1, 24, 32).astype(
        np.uint8), 75, "444"))
    sof = data.index(b"\xff\xc0")
    data[sof + 11], data[sof + 14] = 0x31, 0x21
    return bytes(data)


def test_jpeg_mcu_of_more_than_ten_blocks_fails_like_pil():
    """4x2 + 2x2 + 1x1 = 13 blocks in an interleaved MCU: past the
    standard's 10, which libjpeg-turbo refuses and the port too."""
    img = imf.smooth_image(2, 32, 48).astype(np.uint8)
    data = imf.jpeg_bytes(img, 75, factors=[(4, 2), (2, 2), (1, 1)])
    with pytest.raises(OSError):
        _pil_rgb(data)
    with pytest.raises(ValueError, match="13 blocks in an MCU"):
        decode_jpeg(data)


def test_jpeg_non_integral_sampling_fails_in_both_jpegdec(tmp_path):
    """libjpeg-turbo refuses such a file (JERR_FRACT_SAMPLE_NOTIMPL), so
    the JAX package's jpegdec fails through PIL; the port's fails with a
    ValueError that names the sampling."""
    (tmp_path / "frame.000.jpg").write_bytes(_non_integral_sampling_file())
    line = (f"multifilesrc location={tmp_path}/frame.%03d.jpg ! jpegdec "
            "! appsink name=out")
    with pytest.raises(OSError):
        nt.parse_launch(line).run(60)
    with pytest.raises(ValueError, match="integral fraction"):
        pt.parse_launch(line).run(60)
    with pytest.raises(ValueError, match="JERR_FRACT_SAMPLE_NOTIMPL"):
        decode_jpeg(_non_integral_sampling_file())


ARITH_CASES = {
    "sequential": dict(),
    "sequential_restart": dict(restart_interval=2),
    "sequential_444": dict(subsampling="444"),
    "conditioning": dict(arithmetic={"dc": (2, 5), "ac": 10}),
    "conditioning_zero": dict(arithmetic={"dc": (0, 0), "ac": 1}),
    "progressive": dict(progressive=True),
    "progressive_restart": dict(progressive=True, restart_interval=3),
    "progressive_unrefined": dict(progressive=JPEG_SCRIPTS["unrefined"]),
    "cmyk": dict(color="cmyk"),
    "ycck_progressive": dict(color="ycck", progressive=True),
    "gray_progressive": dict(color="gray", progressive=True)}


@pytest.mark.parametrize("case", sorted(ARITH_CASES))
def test_jpeg_writer_arithmetic_equals_pil(case):
    """Arithmetic-coded files (SOF9, SOF10, DAC): the writer's QM
    encoder against libjpeg-turbo's decoder through PIL, and the port's
    decoder against both: the same coefficients as the Huffman file, so
    the same pixels."""
    kw = dict(ARITH_CASES[case])
    arith = kw.pop("arithmetic", True)
    channels = {"cmyk": 4, "ycck": 4, "gray": 1}.get(kw.get("color"), 3)
    for h, w in ((48, 64), (17, 23), (9, 31), (1, 1)):
        img = imf.smooth_image(h + 9 * w, h, w, channels).astype(np.uint8)
        img = img[..., 0] if channels == 1 else img
        data = imf.jpeg_bytes(img, 80, arithmetic=arith, **kw)
        got = decode_jpeg(data)
        np.testing.assert_array_equal(got, _pil_rgb(data))
        np.testing.assert_array_equal(
            got, decode_jpeg(imf.jpeg_bytes(img, 80, **kw)))


@pytest.mark.parametrize("scans", [1, 2, 5, 9])
def test_jpeg_arithmetic_progressive_prefix_equals_pil(scans):
    """Block smoothing after an arithmetic-coded progressive file's
    first scans."""
    for h, w in ((48, 64), (17, 23)):
        img = imf.smooth_image(h + w, h, w).astype(np.uint8)
        data = imf.jpeg_prefix(imf.jpeg_bytes(img, 75, progressive=True,
                                              arithmetic=True), scans)
        np.testing.assert_array_equal(decode_jpeg(data), _pil_rgb(data))


LOSSLESS_CASES = {
    "gray": dict(), "rgb": dict(color="rgb"), "cmyk": dict(color="cmyk"),
    "rgb_ids": dict(color="rgb", adobe=None, ids=b"RGB"),
    "no_marker": dict(jfif=False),
    "rgb_h2v2": dict(color="rgb", factors=[(2, 2), (1, 1), (1, 1)]),
    "rgb_h1v2": dict(color="rgb", factors=[(1, 2), (1, 1), (1, 1)]),
    "rgb_h4v1": dict(color="rgb", factors=[(4, 1), (2, 1), (1, 1)]),
    "rgb_restart": dict(color="rgb", restart_interval=-1)}


@pytest.mark.parametrize("case", sorted(LOSSLESS_CASES))
def test_jpeg_writer_lossless_equals_pil(case):
    """Lossless (SOF3) files, every predictor 1-7 at point transforms 0
    and 3: libjpeg-turbo's undifferencing, its colour space without
    markers (RGB) and plain replication of subsampled components."""
    channels = {"gray": 1, "cmyk": 4}.get(case, 3)
    for h, w in ((17, 23), (9, 31), (1, 1), (2, 3)):
        kw = dict(LOSSLESS_CASES[case])
        img = imf.smooth_image(h + 3 * w, h, w, channels).astype(np.uint8)
        img = img[..., 0] if channels == 1 else img
        if kw.get("restart_interval") == -1:   # two MCU rows
            kw["restart_interval"] = 2 * w
        for predictor in range(1, 8):
            for pt in (0, 3):
                data = imf.jpeg_bytes(img, lossless=(predictor, pt), **kw)
                got = decode_jpeg(data)
                np.testing.assert_array_equal(got, _pil_rgb(data))
                if pt == 0 and case in ("rgb", "gray"):   # it is lossless
                    want = img if channels == 3 else img[..., None]
                    np.testing.assert_array_equal(got, np.broadcast_to(
                        want, got.shape))


@pytest.mark.parametrize("kw", [dict(), dict(adobe=1, jfif=False),
                                dict(color="ycck")],
                         ids=["jfif", "adobe1", "ycck"])
def test_jpeg_lossless_colour_conversion_fails_like_pil(kw):
    """libjpeg-turbo converts no colour in lossless mode, so a YCbCr or
    YCCK lossless file fails in PIL and in the port."""
    channels = 4 if kw.get("color") == "ycck" else 3
    img = imf.smooth_image(6, 9, 12, channels).astype(np.uint8)
    data = imf.jpeg_bytes(img, lossless=(1, 0), **kw)
    with pytest.raises(OSError):
        _pil_rgb(data)
    with pytest.raises(ValueError, match="JERR_CONVERSION_NOTIMPL"):
        decode_jpeg(data)


def _refused_files():
    rgb = Image.fromarray(imf.smooth_image(4, 24, 32).astype(np.uint8))
    base = _pil_jpeg(rgb, quality=75)
    sof = base.index(b"\xff\xc0")

    def sof_marker(m):
        return base[:sof + 1] + bytes([m]) + base[sof + 2:]

    twelve = base[:sof + 4] + b"\x0c" + base[sof + 5:]
    dnl = base[:sof + 5] + b"\x00\x00" + base[sof + 7:]
    dnl = dnl[:-2] + b"\xff\xdc\x00\x04\x00\x18\xff\xd9"
    return {"12-bit": twelve, "hierarchical": sof_marker(0xC5),
            "arithmetic-coded lossless": sof_marker(0xCB),
            "arithmetic-coded hierarchical": sof_marker(0xCD), "DNL": dnl}


@pytest.mark.parametrize("mode", ["12-bit", "hierarchical",
                                  "arithmetic-coded lossless",
                                  "arithmetic-coded hierarchical", "DNL"])
def test_jpeg_unported_modes_raise(mode):
    with pytest.raises(pt.NotPortedError, match=mode):
        decode_jpeg(_refused_files()[mode])


@pytest.mark.parametrize("mode", ["12-bit", "DNL"])
def test_jpeg_refusals_pil_shares(mode):
    """PIL cannot open a 12-bit file or one whose height a DNL marker
    sets, so those refusals are parity with the JAX package."""
    with pytest.raises(OSError):
        _pil_rgb(_refused_files()[mode])


def _file_digest(data: bytes, decode) -> str:
    return hashlib.sha256(decode(data).tobytes()).hexdigest()


def test_chip_smoke_jpeg_digests_are_pil_decodes(tmp_path):
    """chip_smoke.py holds the card machine's decodes (no PIL there) to
    SHA-256 constants; they are PIL's decodes of the same seeded files
    (baseline and progressive series, one file a further mode), and
    the port's decoder gives them here too."""
    for series, kw, want in (
            ("baseline", {}, chip_smoke.MEDIA_JPEG_SHA256),
            ("progressive", {"progressive": True},
             chip_smoke.MEDIA_JPEG_PROGRESSIVE_SHA256)):
        paths = imf.write_jpeg_series(
            str(tmp_path / series), chip_smoke.MEDIA_FRAMES,
            chip_smoke.MEDIA_WIDTH, chip_smoke.MEDIA_HEIGHT,
            chip_smoke.MEDIA_SEED, chip_smoke.MEDIA_JPEG_QUALITY, "420",
            **kw)
        pil, port = [], []
        for p in paths:
            with open(p, "rb") as f:
                data = f.read()
            pil.append(_file_digest(data, _pil_rgb))
            port.append(_file_digest(data, decode_image))
        assert tuple(pil) == want, series
        assert port == pil, series
    files = chip_smoke.media_mode_files(imf)
    assert sorted(files) == sorted(chip_smoke.MEDIA_JPEG_MODE_SHA256)
    for mode, data in files.items():
        assert _file_digest(data, _pil_rgb) == \
            chip_smoke.MEDIA_JPEG_MODE_SHA256[mode], mode
        assert _file_digest(data, decode_image) == \
            chip_smoke.MEDIA_JPEG_MODE_SHA256[mode], mode


def test_chip_smoke_cut_progressive_file_is_smoothed():
    """The card's cut progressive file does reach block smoothing: its
    decode differs from the same coefficients without it."""
    from nnstreamer_tpu_torch.imaging import jpeg as jpeg_mod
    data = chip_smoke.media_mode_files(imf)["progressive_cut3"]
    f = jpeg_mod._read(data)
    assert jpeg_mod._smoothing_on(f.comps)


def test_decode_image_sniffs_the_format():
    """PNG, JPEG and the other formats PIL opens decode as PIL decodes
    them; bytes PIL cannot identify (a GIF header cut short among them)
    raise ValueError."""
    img = imf.smooth_image(9, 16, 24).astype(np.uint8)
    png = imf.png_bytes(img, 2, 8)
    jpg = imf.jpeg_bytes(img, 90, "444")
    np.testing.assert_array_equal(decode_image(png), img)
    np.testing.assert_array_equal(decode_image(jpg), _pil_rgb(jpg))
    for write in imf.format_variants().values():
        data = write(img)
        np.testing.assert_array_equal(decode_image(data), _pil_rgb(data))
    with pytest.raises(ValueError, match="cannot identify"):
        decode_image(b"GIF89a....")


def _write_cmyk_series(out_dir, count, width, height, seed):
    for i in range(count):
        img = imf.smooth_image(seed + i, height, width, 4).astype(np.uint8)
        with open(os.path.join(out_dir, f"frame.{i:03d}.jpg"), "wb") as f:
            f.write(imf.jpeg_bytes(img, 75, progressive=i % 2 == 1))


def _variant_series(*names):
    """A series writer: file i in the i-th of ``names`` (cycled), as
    ``frame.%03d.img``."""
    def write(out_dir, count, width, height, seed=0):
        variants = imf.format_variants()
        for i in range(count):
            img = imf.smooth_image(seed + i, height, width).astype(np.uint8)
            with open(os.path.join(out_dir, f"frame.{i:03d}.img"), "wb") as f:
                f.write(variants[names[i % len(names)]](img))
    return write


WRITE_SERIES = {
    "png": imf.write_png_series, "jpeg": imf.write_jpeg_series,
    "jpeg_progressive": lambda *a, **k: imf.write_jpeg_series(
        *a, progressive=True, **k),
    "jpeg_cmyk": _write_cmyk_series,
    "bmp": _variant_series("bmp_24", "bmp_16_565", "dib_24"),
    "ppm": _variant_series("ppm_raw", "ppm_plain", "ppm_raw_16"),
    "qoi": _variant_series("qoi_rgb", "qoi_rgba"),
    "tga": _variant_series("tga_24_rle", "tga_32_rle_top_left", "tga_16"),
    "gif": _variant_series("gif_332", "gif_332_interlaced"),
    "tiff": _variant_series("tiff_lzw_predictor", "tiff_deflate_planar",
                            "tiff_packbits"),
    "ico": _variant_series("ico_png", "ico_bmp_32", "cur_bmp_24"),
    "mixed": imf.write_format_series}
SERIES_EXT = {"png": "png", "jpeg": "jpg", "jpeg_progressive": "jpg",
              "jpeg_cmyk": "jpg"}


@pytest.mark.parametrize("element", ["pngdec", "jpegdec"])
@pytest.mark.parametrize("kind", ["png", "jpeg", "jpeg_progressive",
                                  "jpeg_cmyk", "bmp", "ppm", "qoi", "tga",
                                  "gif", "tiff", "ico", "mixed"])
def test_decoder_elements_equal_jax(element, kind, tmp_path):
    """Both element names sniff the format, as PIL does for the JAX
    package's element: frames and caps equal across packages (the JAX
    one decodes through PIL): PNG, baseline and progressive JPEG, CMYK
    JPEG (baseline and progressive frames in turn), and a series of each
    other format the port decodes (three variants in turn; ``ico``: ICO
    with PNG and BMP entries and CUR) and of the first three variants of
    the mixed series. Caps come from the first frame, as in the JAX
    element."""
    WRITE_SERIES[kind](str(tmp_path), 3, 40, 30, seed=11)
    ext = SERIES_EXT.get(kind, "img")
    line = (f"multifilesrc location={tmp_path}/frame.%03d.{ext} "
            f"! {element} ! appsink name=out")
    out = {}
    for pkg in ("jax", "port"):
        p = PKGS[pkg].parse_launch(line)
        p.run(60)
        out[pkg] = ([np.asarray(b.chunks[0].host()) for b in p["out"].buffers],
                    str(p["out"].sinkpad.caps))
    assert out["port"][1] == out["jax"][1]
    assert len(out["port"][0]) == 3
    for g, w in zip(*(out[k][0] for k in ("port", "jax"))):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("fmt", ["WEBP", "PCX", "SGI", "JPEG2000"])
def test_other_pil_formats_decode_in_jax_jpegdec_only(fmt, tmp_path):
    """A divergence kept (ROADMAP.md C): the JAX package's jpegdec opens
    whatever PIL opens; the port's decodes PNG, JPEG, BMP/DIB, PNM, GIF,
    TIFF, ICO/CUR, TGA and QOI and raises NotPortedError on another
    format PIL opens, naming PIL's format."""
    img = imf.smooth_image(5, 12, 16).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "frame.000.img", fmt)
    line = (f"multifilesrc location={tmp_path}/frame.%03d.img ! jpegdec "
            "! appsink name=out")
    p = nt.parse_launch(line)
    p.run(60)
    got = [np.asarray(b.chunks[0].host()) for b in p["out"].buffers]
    assert len(got) == 1 and got[0].shape == (12, 16, 3)
    with pytest.raises(pt.NotPortedError, match=repr(fmt)):
        pt.parse_launch(line).run(60)


# -- the golden line shape -----------------------------------------------------

def _golden_pngs(tmp_path, n=3, w=80, h=60):
    imf.write_png_series(str(tmp_path), n, w, h, seed=21)
    return f"multifilesrc location={tmp_path}/frame.%03d.png"


def test_golden_line_tflite_u8_within_one_lsb(tmp_path):
    """``pngdec ! videoscale ! videoconvert ! tensor_converter !
    tensor_filter framework=tensorflow-lite`` over a u8 MobileNet-v2 file
    (width 0.35, 96x96): the port within 1 LSB of the JAX package, the
    argmax equal."""
    path = mf.write_mobilenet_v2(str(tmp_path / "m"), 0.35, 96, 0,
                                 forms=("tflite_u8",))["tflite_u8"]
    line = (f"{_golden_pngs(tmp_path)} ! pngdec ! videoscale width=96 "
            "height=96 ! videoconvert format=RGB ! tensor_converter "
            f"! tensor_filter framework=tensorflow-lite model={path} "
            "accelerator=true:cpu ! appsink name=out")
    out = {}
    for pkg in ("jax", "port"):
        p = PKGS[pkg].parse_launch(line)
        p.run(120)
        out[pkg] = [np.asarray(b.chunks[0].host()) for b in p["out"].buffers]
    assert len(out["port"]) == len(out["jax"]) == 3
    for g, w in zip(out["port"], out["jax"]):
        assert g.dtype == w.dtype == np.uint8
        assert np.abs(g.astype(np.int64) - w.astype(np.int64)).max() <= 1
        assert np.argmax(g) == np.argmax(w)


VIT = dict(size="64", d_model="64", layers="2", heads="4", classes="10",
           attn="pallas")
MODEL_PY = '''
import numpy as np
from nnstreamer_tpu_torch.models.convert import vit_params_from_jax
from nnstreamer_tpu_torch.models.vit import ViT, apply_vit
from nnstreamer_tpu_torch.tensors.info import TensorsInfo


def get_model():
    flat = np.load({npz!r})
    tree = {{}}
    for key in flat.files:
        *path, leaf = key.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {{}})
        node[leaf] = flat[key]
    model = ViT(size=64, patch=16, d_model=64, layers=2, heads=4,
                classes=10, fused=True)
    model.load_state_dict(vit_params_from_jax(tree))
    return (apply_vit, model, TensorsInfo.make("uint8", "3:64:64"),
            TensorsInfo.make("float32", "10"))
'''


def test_golden_line_vit_equals_jax(tmp_path):
    """The same line into a small ViT (the JAX zoo model's weights in
    both packages): logits within 3e-2 absolute, argmax equal."""
    _golden_vit(tmp_path, _golden_pngs(tmp_path), "pngdec", 3)


def test_golden_line_vit_mixed_formats_equals_jax(tmp_path):
    """The golden ViT line over phase 48's mixed series (one file in
    each of the first six format variants: BMP, PPM, QOI, TGA RLE, GIF,
    TIFF LZW with predictor) through jpegdec, at the same reduced width
    and tolerance: logits within 3e-2 absolute, argmax equal."""
    imf.write_format_series(str(tmp_path), 6, 80, 60, seed=21)
    _golden_vit(tmp_path, f"multifilesrc location={tmp_path}/frame.%03d.img",
                "jpegdec", 6)


def _golden_vit(tmp_path, src, dec, n):
    _, params, _, _ = jax_zoo.build("vit", **VIT)
    flat = {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                jax.device_get(params))[0]}
    npz = tmp_path / "vit.npz"
    np.savez(npz, **flat)
    model = tmp_path / "model.py"
    model.write_text(MODEL_PY.format(npz=str(npz)))
    head = (f"{src} ! {dec} ! videoscale width=64 "
            "height=64 ! videoconvert format=RGB ! tensor_converter ")
    jax_model = "zoo://vit?" + "&".join(f"{k}={v}" for k, v in VIT.items())
    lines = {"jax": f'{head} ! tensor_filter framework=jax model="{jax_model}" '
                    "! appsink name=out",
             "port": f"{head} ! tensor_filter framework=torch-cuda "
                     f"accelerator=true:cpu model={model} ! appsink name=out"}
    out = {}
    for pkg, line in lines.items():
        p = PKGS[pkg].parse_launch(line)
        p.run(300)
        out[pkg] = [np.asarray(b.chunks[0].host(), np.float32)
                    for b in p["out"].buffers]
    assert len(out["port"]) == len(out["jax"]) == n
    for g, w in zip(out["port"], out["jax"]):
        assert np.abs(g - w).max() <= BF16_ATOL
        assert np.argmax(g) == np.argmax(w)


# -- direct_video and python3 --------------------------------------------------

def _decode_line(pkg, dtype, chans, tail, arrays):
    caps = ("other/tensors,format=static,num_tensors=1,"
            f"types=(string){dtype},dimensions=(string){chans}:5:4,"
            "framerate=(fraction)30/1")
    p = PKGS[pkg].parse_launch(f'appsrc name=in caps="{caps}" '
                               f"! tensor_decoder {tail} ! appsink name=out")
    p.start()
    try:
        for a in arrays:
            p["in"].push_buffer(PKGS[pkg].Buffer.from_arrays([a]))
        p["in"].end_stream()
        assert p.wait_eos(30)
    finally:
        p.stop()
    return ([np.asarray(b.chunks[0].host()) for b in p["out"].buffers],
            str(p["out"].sinkpad.caps))


@pytest.mark.parametrize("dtype,chans,option", [
    ("uint8", 1, ""), ("uint8", 3, ""), ("uint8", 4, ""),
    ("uint8", 3, "option1=BGR"), ("float32", 3, ""), ("float32", 1, "")])
def test_direct_video_equals_jax(dtype, chans, option):
    rng = np.random.default_rng(chans)
    if dtype == "uint8":
        arrays = [rng.integers(0, 256, (4, 5, chans), np.uint8)
                  for _ in range(2)]
    else:   # out of range on both sides: clipped, then cast
        arrays = [rng.uniform(-40, 300, (4, 5, chans)).astype(np.float32)
                  for _ in range(2)]
    tail = f"mode=direct_video {option}"
    got, got_caps = _decode_line("port", dtype, chans, tail, arrays)
    want, want_caps = _decode_line("jax", dtype, chans, tail, arrays)
    assert got_caps == want_caps
    assert len(got) == 2
    for g, w in zip(got, want):
        assert g.dtype == np.uint8
        np.testing.assert_array_equal(g, w)


SCRIPTS = {
    "identity": ("def get_out_caps(config):\n"
                 "    return 'video/x-raw,format=RGB,width=5,height=4,"
                 "framerate=0/1'\n"
                 "def decode(buf):\n"
                 "    return buf\n"),
    "gray": ("def get_out_caps(config):\n"
             "    return 'video/x-raw,format=GRAY8,width=5,height=4,"
             "framerate=0/1'\n"
             "def decode(buf):\n"
             "    import numpy as np\n"
             "    a = buf.chunks[0].host()\n"
             "    assert isinstance(a, np.ndarray)\n"
             "    out = (a.astype(np.uint16).sum(-1, keepdims=True) // 3)\n"
             "    return type(buf).from_arrays([out.astype(np.uint8)])\n"),
}


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_python3_decoder_without_caps_fails_alike(pkg, tmp_path):
    """A script with decode() only gives ANY caps, which neither package
    can set on a pad: both refuse the stream with the same error."""
    path = tmp_path / "bare.py"
    path.write_text("def decode(buf):\n    return buf\n")
    with pytest.raises(ValueError, match="pad caps must be fixed"):
        _decode_line(pkg, "uint8", 3, f"mode=python3 option1={path}",
                     [np.zeros((4, 5, 3), np.uint8)])


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_python3_decoder_equals_jax(script, tmp_path):
    path = tmp_path / f"{script}.py"
    path.write_text(SCRIPTS[script])
    rng = np.random.default_rng(7)
    arrays = [rng.integers(0, 256, (4, 5, 3), np.uint8) for _ in range(2)]
    tail = f"mode=python3 option1={path}"
    got, got_caps = _decode_line("port", "uint8", 3, tail, arrays)
    want, want_caps = _decode_line("jax", "uint8", 3, tail, arrays)
    assert got_caps == want_caps
    assert len(got) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# -- chip_smoke.py's device-time arithmetic -----------------------------------
# Fake torch.profiler events: device_mean_ms counts the calls the profiler
# saw and gives no time when it lost a launch; check_device_bound fails a
# phase whose device time reads under its bound. Exact sums, no tolerance.

def _events(*pairs):
    """(count, total device us) of each averaged kernel event."""
    return [SimpleNamespace(count=n, self_device_time_total=us)
            for n, us in pairs]


@pytest.mark.parametrize("iters,per_call,pairs,want", [
    (20, 1, [(20, 200.0)], 0.01),
    (5, 12, [(60, 3000.0)], 0.6),
    # two instantiations of one kernel name, each a part of the calls
    (4, 2, [(4, 40.0), (4, 80.0)], 0.03)])
def test_device_mean_ms_of_a_full_count(iters, per_call, pairs, want):
    assert chip_smoke.device_mean_ms(_events(*pairs), iters, per_call) == \
        pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("iters,per_call,pairs", [
    (20, 1, [(10, 100.0)]),        # half the calls lost: would read 0.005
    (5, 12, [(59, 2950.0)]),       # one launch of one replay lost
    (20, 1, [(21, 210.0)]),        # a launch that was not the calls'
    (20, 1, [])])                  # nothing recorded
def test_device_mean_ms_of_a_short_count_is_none(iters, per_call, pairs,
                                                 capsys):
    assert chip_smoke.device_mean_ms(_events(*pairs), iters, per_call) is None
    seen = sum(n for n, _ in pairs)
    assert f"kept {seen} kernel events of {iters * per_call}" in \
        capsys.readouterr().out


def test_a_device_time_under_the_bound_fails_the_phase():
    """A normalize batch read of 0.00268 ms device against the 0.00431 ms
    bytes bound (PERF.md section 6): not a possible time."""
    row = {"device_ms": 0.00268, "bound_ms": 0.00431, "bound_by": "bytes"}
    with pytest.raises(SystemExit, match="under the 0.00431 ms bytes bound"):
        chip_smoke.check_device_bound(row, "normalize (32, 224, 224, 3)")


@pytest.mark.parametrize("device_ms", [0.00431, 0.00595, None])
def test_a_device_time_at_or_over_the_bound_passes(device_ms):
    row = {"device_ms": device_ms, "bound_ms": 0.00431, "bound_by": "bytes"}
    chip_smoke.check_device_bound(row, "normalize (32, 224, 224, 3)")


def test_a_lost_event_reads_none_not_under_the_bound():
    """The short count that read under the bound becomes no time, which
    the bound check lets pass: the phase logs it instead."""
    half = _events((10, 10 * 2.68))
    row = {"device_ms": chip_smoke.device_mean_ms(half, 20, 1),
           "bound_ms": 0.00431, "bound_by": "bytes"}
    assert row["device_ms"] is None
    chip_smoke.check_device_bound(row, "normalize")
