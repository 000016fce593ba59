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
* JPEG: the writer's baseline files and PIL-saved ones (quality
  50/75/95, ``subsampling`` 0/1/2, with and without restart markers,
  grey) against PIL's decode through libjpeg-turbo; progressive,
  arithmetic-coded, 12-bit and CMYK files raise ``NotPortedError``;
* chip_smoke.py's JPEG digests are PIL's decode of its seeded files;
* the golden line shape ``filesrc ! pngdec ! videoscale ! videoconvert !
  tensor_converter ! tensor_filter`` in both packages, through a small
  u8 ``.tflite`` (within 1 LSB, argmax equal) and through a small ViT
  (tests/test_torch_pipeline.py's bf16 tolerance, 3e-2 absolute, argmax
  equal);
* ``direct_video`` and ``python3``: equal frames and caps in both
  packages.

Tolerance where not stated: none; the comparison is bitwise.
"""
import hashlib
import importlib.util
import io
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

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


def _refused_files():
    rgb = Image.fromarray(imf.smooth_image(4, 24, 32).astype(np.uint8))
    base = _pil_jpeg(rgb, quality=75)
    sof = base.index(b"\xff\xc0")
    arith = base[:sof + 1] + b"\xc9" + base[sof + 2:]
    twelve = base[:sof + 4] + b"\x0c" + base[sof + 5:]
    return {"progressive": _pil_jpeg(rgb, progressive=True),
            "arithmetic": arith, "12-bit": twelve,
            "CMYK": _pil_jpeg(rgb.convert("CMYK"))}


@pytest.mark.parametrize("mode", ["progressive", "arithmetic", "12-bit",
                                  "CMYK"])
def test_jpeg_unported_modes_raise(mode):
    with pytest.raises(pt.NotPortedError, match=mode):
        decode_jpeg(_refused_files()[mode])


def test_chip_smoke_jpeg_digests_are_pil_decodes(tmp_path):
    """chip_smoke.py holds the card machine's decodes (no PIL there) to
    SHA-256 constants; they are PIL's decodes of the same seeded files,
    and the port's decoder gives them here too."""
    import chip_smoke as cs
    paths = imf.write_jpeg_series(
        str(tmp_path), cs.MEDIA_FRAMES, cs.MEDIA_WIDTH, cs.MEDIA_HEIGHT,
        cs.MEDIA_SEED, cs.MEDIA_JPEG_QUALITY, "420")
    pil, port = [], []
    for p in paths:
        with open(p, "rb") as f:
            data = f.read()
        pil.append(hashlib.sha256(_pil_rgb(data).tobytes()).hexdigest())
        port.append(hashlib.sha256(decode_image(data).tobytes()).hexdigest())
    assert tuple(pil) == cs.MEDIA_JPEG_SHA256
    assert port == pil


def test_decode_image_sniffs_the_format():
    img = imf.smooth_image(9, 16, 24).astype(np.uint8)
    png = imf.png_bytes(img, 2, 8)
    jpg = imf.jpeg_bytes(img, 90, "444")
    np.testing.assert_array_equal(decode_image(png), img)
    np.testing.assert_array_equal(decode_image(jpg), _pil_rgb(jpg))
    with pytest.raises(ValueError, match="not a PNG or JPEG"):
        decode_image(b"GIF89a....")


@pytest.mark.parametrize("element", ["pngdec", "jpegdec"])
@pytest.mark.parametrize("kind", ["png", "jpeg"])
def test_decoder_elements_equal_jax(element, kind, tmp_path):
    """Both element names sniff the format, as PIL does for the JAX
    package's element: frames and caps equal across packages."""
    write = imf.write_png_series if kind == "png" else imf.write_jpeg_series
    write(str(tmp_path), 3, 40, 30, seed=11)
    ext = "png" if kind == "png" else "jpg"
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
    _, params, _, _ = jax_zoo.build("vit", **VIT)
    flat = {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                jax.device_get(params))[0]}
    npz = tmp_path / "vit.npz"
    np.savez(npz, **flat)
    model = tmp_path / "model.py"
    model.write_text(MODEL_PY.format(npz=str(npz)))
    head = (f"{_golden_pngs(tmp_path)} ! pngdec ! videoscale width=64 "
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
    assert len(out["port"]) == len(out["jax"]) == 3
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
