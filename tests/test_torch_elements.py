"""The port's video front end and tensor elements against the JAX
package's: tensor_converter, tensor_transform, the media elements
(videotestsrc, audiotestsrc, videoconvert, file IO), tensor_sink and
tensor_debug, and the converter registry's custom hooks.

It mirrors the converter and transform tests of tests/test_elements.py,
running each launch line in both packages and requiring the same
buffers (bytes, shapes, dtypes, pts) and caps. tensor_transform's device
path is held to the JAX element's ``_device_op`` (a ``jax.jit`` of jnp
ops, on the CPU here) on u8, i32 and f32 inputs: the same dtype in every
mode, and the same values except where XLA's CPU backend rounds
otherwise (``div``: it multiplies by the reciprocal, within one f32 ulp
of the correctly rounded quotient the port and numpy compute; ``stand``:
reductions in another order, within 8 f32 ulps of the largest
magnitude).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as pt
from nnstreamer_tpu.pipeline.registry import make_element as jax_make
from nnstreamer_tpu_torch.converters.registry import (register_converter,
                                                      unregister_converter)
from nnstreamer_tpu_torch.elements.transform import NUMPY, TORCH
from nnstreamer_tpu_torch.pipeline.registry import make_element

EPS32 = float(np.finfo(np.float32).eps)


def _run(pkg, desc, timeout=60):
    pipe = pkg.parse_launch(desc)
    pipe.run(timeout=timeout)
    return pipe


def _both(desc):
    """Run ``desc`` in both packages; returns (JAX buffers, port buffers,
    JAX sink caps, port sink caps)."""
    jp, pp = _run(nt, desc), _run(pt, desc)
    return (jp["out"].buffers, pp["out"].buffers,
            str(jp["out"].sinkpad.caps), str(pp["out"].sinkpad.caps))


def _assert_same_stream(desc, n):
    want, got, wcaps, gcaps = _both(desc)
    assert gcaps == wcaps
    assert len(got) == len(want) == n
    for w, g in zip(want, got):
        assert (g.pts, g.duration) == (w.pts, w.duration)
        assert len(g.chunks) == len(w.chunks)
        for wc, gc in zip(w.chunks, g.chunks):
            wa, ga = wc.host(), gc.host()
            assert ga.dtype == wa.dtype and ga.shape == wa.shape
            assert ga.tobytes() == wa.tobytes()
    return got


# -- sources and tensor_converter ------------------------------------------

@pytest.mark.parametrize("pattern,fmt", [
    (p, f) for p in ("smpte", "ball", "counter", "random")
    for f in ("RGB", "RGBA", "GRAY8") if (p, f) != ("smpte", "RGBA")])
def test_videotestsrc_patterns_match_jax(pattern, fmt):
    _assert_same_stream(
        f"videotestsrc pattern={pattern} seed=3 num-buffers=3 "
        f'caps="video/x-raw,format={fmt},width=20,height=12,framerate=30/1" '
        "! appsink name=out", 3)


@pytest.mark.parametrize("fmt", ["RGBA", "BGRx"])
def test_smpte_bars_fail_on_four_channels_in_both(fmt):
    """The JAX videotestsrc draws its smpte bars from 3-channel colours
    and cannot fill a 4-channel frame (nnstreamer_tpu/elements/media.py
    :74-78); the port keeps that behaviour, a fault of the reference
    recorded in ROADMAP.md."""
    for pkg in (nt, pt):
        with pytest.raises(ValueError, match="broadcast"):
            _run(pkg, "videotestsrc pattern=smpte num-buffers=1 "
                      f'caps="video/x-raw,format={fmt},width=4,height=2" '
                      "! appsink name=out")


def test_video_to_tensor():
    got = _assert_same_stream(
        "videotestsrc pattern=counter num-buffers=3 "
        'caps="video/x-raw,format=RGB,width=8,height=6,framerate=30/1" '
        "! tensor_converter ! appsink name=out", 3)
    assert got[0].chunks[0].shape == (6, 8, 3)
    assert got[1].pts - got[0].pts == pytest.approx(1e9 / 30, rel=1e-3)


def test_audio_to_tensor():
    got = _assert_same_stream(
        "audiotestsrc samplesperbuffer=160 num-buffers=2 "
        'caps="audio/x-raw,format=S16LE,channels=2,rate=16000" '
        "! tensor_converter ! appsink name=out", 2)
    assert got[0].chunks[0].shape == (160, 2)
    assert got[0].chunks[0].dtype == np.int16


@pytest.mark.parametrize("fmt", ["U8", "F32LE"])
def test_audio_formats_match_jax(fmt):
    _assert_same_stream(
        # pipelint: skip (a template: the audio format is parametrised)
        "audiotestsrc samplesperbuffer=64 num-buffers=2 freq=1000 "
        f'caps="audio/x-raw,format={fmt},channels=1,rate=8000" '
        "! tensor_converter ! appsink name=out", 2)


def test_frames_per_tensor_batches():
    got = _assert_same_stream(
        "videotestsrc pattern=counter num-buffers=4 "
        'caps="video/x-raw,format=GRAY8,width=4,height=4,framerate=20/1" '
        "! tensor_converter frames-per-tensor=2 ! appsink name=out", 2)
    assert got[0].chunks[0].shape == (2, 4, 4, 1)
    np.testing.assert_array_equal(got[0].chunks[0].host()[:, 0, 0, 0],
                                  [0, 1])


def test_octet_to_tensor_requires_dims(tmp_path):
    path = tmp_path / "blob.bin"
    path.write_bytes(bytes(range(24)))
    with pytest.raises(ValueError, match="input-dim"):
        _run(pt, f"filesrc location={path} ! tensor_converter "
                 "! appsink name=out")


@pytest.mark.parametrize("blocksize", [-1, 8])
def test_octet_stream_with_dims(tmp_path, blocksize):
    path = tmp_path / "blob.bin"
    path.write_bytes(bytes(range(48)))
    _assert_same_stream(
        f"filesrc location={path} blocksize={blocksize} ! tensor_converter "
        "input-dim=4:2 input-type=uint8 ! appsink name=out",
        1 if blocksize < 0 else 6)


def test_text_is_padded_to_the_input_dims(tmp_path):
    path = tmp_path / "t.txt"
    path.write_bytes(b"hello")
    got = _assert_same_stream(
        f'filesrc location={path} caps="text/x-raw,format=utf8" '
        "! tensor_converter input-dim=16 input-type=uint8 "
        "! appsink name=out", 1)
    assert bytes(got[0].chunks[0].host()) == b"hello" + b"\0" * 11


def test_multifilesrc_and_multifilesink_round_trip(tmp_path):
    for i in range(3):
        (tmp_path / f"in.{i:03d}.raw").write_bytes(bytes([i] * 12))
    for name, pkg in (("jax", nt), ("port", pt)):
        _run(pkg, f"multifilesrc location={tmp_path}/in.%03d.raw "
                  "! tensor_converter input-dim=3:4 input-type=uint8 "
                  f"! multifilesink location={tmp_path}/{name}.%03d.raw")
    for i in range(3):
        assert (tmp_path / f"port.{i:03d}.raw").read_bytes() == \
            (tmp_path / f"jax.{i:03d}.raw").read_bytes() == bytes([i] * 12)


def test_filesink_writes_every_chunk(tmp_path):
    for name, pkg in (("jax", nt), ("port", pt)):
        _run(pkg, "videotestsrc pattern=random seed=1 num-buffers=2 "
                  'caps="video/x-raw,format=RGB,width=4,height=2" '
                  f"! tensor_converter ! filesink location={tmp_path}/{name}")
    assert (tmp_path / "port").read_bytes() == (tmp_path / "jax").read_bytes()
    assert len((tmp_path / "port").read_bytes()) == 2 * 24


@pytest.mark.parametrize("src,dst", [("RGB", "BGR"), ("RGB", "RGBA"),
                                     ("RGBA", "BGRx"), ("BGR", "GRAY8"),
                                     ("GRAY8", "RGB"), ("RGB", "RGB")])
def test_videoconvert_matches_jax(src, dst):
    _assert_same_stream(
        # pipelint: skip (a template: both video formats are parametrised)
        f"videotestsrc pattern=random seed=2 num-buffers=2 "
        f'caps="video/x-raw,format={src},width=6,height=4,framerate=30/1" '
        f"! videoconvert format={dst} ! tensor_converter ! appsink name=out",
        2)


def test_flexible_tensors_to_static():
    caps = ("other/tensors,format=flexible,num_tensors=1,"
            "framerate=(fraction)0/1")
    for pkg in (nt, pt):
        pipe = pkg.parse_launch(f'appsrc name=in caps="{caps}" '
                                "! tensor_converter ! appsink name=out")
        pipe.start()
        for i in range(2):
            pipe["in"].push_buffer(pkg.Buffer.from_arrays(
                [np.full((2, 3), i, np.float32)]))
        pipe["in"].end_stream()
        assert pipe.wait_eos(30)
        pipe.stop()
        out = pipe["out"]
        assert [b.chunks[0].shape for b in out.buffers] == [(2, 3)] * 2
        assert out.sinkpad.caps.to_config().info[0].shape == (2, 3)


def test_custom_code_converter():
    def convert(buf):
        arr = buf.chunks[0].host()
        return buf.with_chunks([pt.Chunk(arr.astype(np.float32) / 255.0)])

    cfg = pt.TensorsConfig(pt.TensorsInfo.make("float32", "3:4:2"),
                           pt.TensorFormat.STATIC, 30, 1)
    register_converter("scale01", convert, out_config=cfg)
    try:
        pipe = _run(pt, "videotestsrc pattern=counter num-buffers=2 "
                        'caps="video/x-raw,format=RGB,width=4,height=2,'
                        'framerate=30/1" ! tensor_converter '
                        "mode=custom-code:scale01 ! appsink name=out")
    finally:
        unregister_converter("scale01")
    got = pipe["out"].buffers[1].chunks[0].host()
    np.testing.assert_array_equal(got, np.full((2, 4, 3), 1 / 255,
                                               np.float32))


def test_custom_script_converter(tmp_path):
    script = tmp_path / "conv.py"
    script.write_text(
        "import numpy as np\n"
        "from nnstreamer_tpu_torch.tensors.info import (TensorsConfig,\n"
        "                                               TensorsInfo)\n"
        "def get_out_config(caps):\n"
        "    return TensorsConfig(TensorsInfo.make('int32', '2'))\n"
        "def convert(buf):\n"
        "    return buf.with_chunks([type(buf.chunks[0])(\n"
        "        np.array([buf.chunks[0].host().sum(), 7], np.int32))])\n")
    pipe = _run(pt, "videotestsrc pattern=counter num-buffers=3 "
                    'caps="video/x-raw,format=GRAY8,width=2,height=2" '
                    f"! tensor_converter mode=custom-script:{script} "
                    "! appsink name=out")
    assert [b.chunks[0].host().tolist() for b in pipe["out"].buffers] == \
        [[0, 7], [4, 7], [8, 7]]


@pytest.mark.parametrize("media", ["other/flexbuf", "other/protobuf-tensor",
                                   "other/flatbuf-tensor"])
def test_codec_media_is_refused(media):
    """The codec media were refused until the codec converters were
    ported (converters/codecs.py); now ``tensor_converter`` dispatches
    them: a frame the JAX package packed comes out as the same arrays,
    as a flexible stream."""
    from nnstreamer_tpu.interop import tensor_codec as jtc
    pack = {"other/flexbuf": jtc.pack_flexbuf,
            "other/protobuf-tensor": jtc.pack_protobuf,
            "other/flatbuf-tensor": jtc.pack_flatbuf}[media]
    arrays = [np.arange(6, dtype=np.float32).reshape(2, 3),
              np.array([7, 8, 9], np.uint8)]
    data = pack(jtc.Frame(arrays, ["a", "b"], 10, 1))
    pipe = pt.parse_launch(f'appsrc caps="{media},framerate=10/1" name=in '
                           "! tensor_converter ! appsink name=out")
    pipe.start()
    try:
        pipe["in"].push_buffer(pt.Buffer.from_arrays(
            [np.frombuffer(data, np.uint8)], pts=0))
        pipe["in"].end_stream()
        assert pipe.wait_eos(30)
    finally:
        pipe.stop()
    (buf,) = pipe["out"].buffers
    assert [c.host().tobytes() for c in buf.chunks] == \
        [a.tobytes() for a in arrays]
    assert [c.host().dtype for c in buf.chunks] == [a.dtype for a in arrays]
    assert "flexible" in str(pipe["out"].sinkpad.caps)


# -- tensor_transform: the host path, byte for byte ------------------------

TRANSFORMS = [
    ("arithmetic", "typecast:float32,add:-127.5,div:127.5"),
    ("arithmetic", "add:2.5"), ("arithmetic", "mul:0.3"),
    ("arithmetic", "div:3"), ("arithmetic", "add:1:2:3:4"),
    ("arithmetic", "mul:0.5:2:3:-1,add:0.25"),
    ("arithmetic", "typecast:int32,mul:3"),
    ("arithmetic", "typecast:float16,add:0.1"),
    ("typecast", "float32"), ("typecast", "int16"), ("typecast", "uint8"),
    ("transpose", "1:0:2:3"), ("transpose", "2:0:1"), ("dimchg", "0:2"),
    ("clamp", "0:1"), ("clamp", "-2.5:100"),
    ("stand", "default"), ("stand", "dc-average"),
    ("stand", "default:float32"),
    ("padding", "1,1,0"), ("padding", "1,2,0,0,3,2"),
]


def _inputs():
    rng = np.random.default_rng(0)
    return {"u8": rng.integers(0, 255, (2, 3, 4), np.uint8, endpoint=True),
            "i32": rng.integers(-1000, 1000, (2, 3, 4)).astype(np.int32),
            "f32": rng.normal(0, 30, (2, 3, 4)).astype(np.float32)}


def _push_one(pkg, desc, arr):
    """Run arr through a transform-only pipeline via appsrc."""
    info = pkg.TensorsInfo(pkg.Buffer.from_arrays([arr]).to_infos())
    caps = pkg.Caps.from_config(pkg.TensorsConfig(info))
    pipe = pkg.parse_launch(f'appsrc name=in caps="{caps}" ! {desc} '
                            "! appsink name=out")
    pipe.start()
    pipe["in"].push_buffer(pkg.Buffer.from_arrays([arr]))
    pipe["in"].end_stream()
    assert pipe.wait_eos(timeout=30)
    pipe.stop()
    out = pipe["out"].buffers
    assert len(out) == 1
    return out[0].chunks[0].host(), str(pipe["out"].sinkpad.caps)


@pytest.mark.parametrize("mode,option", TRANSFORMS)
def test_transform_host_path_is_byte_equal(mode, option):
    for name, arr in _inputs().items():
        desc = f"tensor_transform mode={mode} option={option}"
        want, wcaps = _push_one(nt, desc, arr)
        got, gcaps = _push_one(pt, desc, arr)
        assert gcaps == wcaps, name
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert got.tobytes() == want.tobytes(), name


def test_transform_examples_of_the_jax_tests():
    arr = np.array([[0, 128, 255]], np.uint8)
    out, caps = _push_one(pt, "tensor_transform mode=arithmetic "
                              "option=typecast:float32,add:-127.5,div:127.5",
                          arr)
    assert out.dtype == np.float32 and "float32" in caps
    np.testing.assert_allclose(out, [[-1.0, 0.00392157, 1.0]], atol=1e-5)
    arr = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    out, _ = _push_one(pt, "tensor_transform mode=transpose option=1:0:2",
                       arr)
    np.testing.assert_array_equal(out, arr.transpose(0, 2, 1))
    out, _ = _push_one(pt, "tensor_transform mode=dimchg option=0:2",
                       np.zeros((4, 6, 3), np.float32))
    assert out.shape == (3, 4, 6)
    out, _ = _push_one(pt, "tensor_transform mode=stand option=dc-average",
                       np.array([1.0, 2.0, 3.0], np.float32))
    np.testing.assert_allclose(out, [-1.0, 0.0, 1.0], atol=1e-6)
    out, caps = _push_one(pt, "tensor_transform mode=padding option=1,1,0",
                          np.ones((2, 2), np.float32))
    assert out.shape == (2, 4) and "4:2" in caps


# -- tensor_transform: the device op against jnp ---------------------------

def _ulps(a):
    return EPS32 * np.maximum(np.abs(a), np.finfo(np.float32).tiny)


@pytest.mark.parametrize("mode,option", TRANSFORMS)
@pytest.mark.parametrize("name", ["u8", "i32", "f32"])
def test_transform_device_op_matches_jnp(mode, option, name):
    arr = _inputs()[name]
    jel = jax_make("tensor_transform", mode=mode, option=option)
    pel = make_element("tensor_transform", mode=mode, option=option)
    jel.start()
    pel.start()
    want = np.asarray(jel._device_op(jnp.asarray(arr)))
    got = pel._op(torch.from_numpy(arr), TORCH)
    assert isinstance(got, torch.Tensor)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    if mode == "stand":
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=8 * EPS32 * scale)
    elif "div" in option:
        # XLA:CPU divides by a constant as a product with its reciprocal
        assert (np.abs(got - want) <= _ulps(want)).all()
        exact = pel._op(arr, NUMPY)
        np.testing.assert_array_equal(got, exact.astype(got.dtype))
    else:
        np.testing.assert_array_equal(got, want)


def test_float_to_int_typecast_saturates_as_xla_does():
    """The device path's float -> int cast saturates and maps NaN to 0,
    as the jnp cast does; the host path wraps, as numpy (and the JAX
    package's host path) does."""
    x = np.array([-300.7, -1.3, 0.7, 254.6, 300.2, 7e4, np.nan, 3e9],
                 np.float32)
    for ttype in ("uint8", "int8", "int16", "uint16", "int32", "uint32"):
        jel = jax_make("tensor_transform", mode="typecast", option=ttype)
        pel = make_element("tensor_transform", mode="typecast", option=ttype)
        jel.start()
        pel.start()
        want = np.asarray(jel._device_op(jnp.asarray(x)))
        got = pel._op(torch.from_numpy(x), TORCH).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_float64_target_follows_the_caps():
    """jnp without x64 computes a float64 target in float32, so the JAX
    device path emits float32 under float64 caps; the port's device path
    emits the float64 the caps (and both host paths) say."""
    arr = _inputs()["u8"]
    pel = make_element("tensor_transform", mode="stand",
                       option="dc-average:float64")
    pel.start()
    got = pel._op(torch.from_numpy(arr), TORCH)
    host = pel._op(arr, NUMPY)
    assert got.dtype == torch.float64 and host.dtype == np.float64
    np.testing.assert_allclose(got.numpy(), host, rtol=0, atol=1e-12)
    want = np.asarray(jax_make("tensor_transform", mode="stand",
                               option="dc-average:float64")._device_op(
        jnp.asarray(arr)))
    assert want.dtype == np.float32


def test_transform_device_chunk_takes_the_torch_path(monkeypatch):
    """A chunk on the card goes through the torch op and stays a tensor;
    the CPU stand-in: a chunk reported as device-resident."""
    from nnstreamer_tpu_torch.elements import transform as T
    from nnstreamer_tpu_torch.tensors import buffer as B
    for mod in (B, T):
        monkeypatch.setattr(mod, "is_device_tensor",
                            lambda x: isinstance(x, torch.Tensor))
    el = make_element("tensor_transform", mode="arithmetic",
                      option="typecast:float32,mul:2")
    el.start()
    out = el.transform(pt.Buffer([pt.Chunk(torch.arange(6,
                                                        dtype=torch.uint8))]))
    raw = out.chunks[0].raw
    assert isinstance(raw, torch.Tensor) and raw.dtype == torch.float32
    np.testing.assert_array_equal(raw.numpy(), np.arange(6) * 2.0)
    el = make_element("tensor_transform", mode="arithmetic",
                      option="mul:2", acceleration=False)
    el.start()
    out = el.transform(pt.Buffer([pt.Chunk(torch.arange(3.0))]))
    assert isinstance(out.chunks[0].raw, np.ndarray)


class _LandingTicket:
    """A fetch ticket that is in flight when first asked and has landed
    from then on (``landed=True``: landed from the start)."""

    def __init__(self, host, landed):
        self.host, self.asked = host, landed

    @property
    def done(self):
        was, self.asked = self.asked, True
        return was

    def wait(self):
        return [self.host]


@pytest.mark.parametrize("landed", [True, False],
                         ids=["resolved", "lands-between-reads"])
def test_transform_pending_host_chunk(monkeypatch, landed):
    """A prefetched filter output (a PendingHost) whose host copy has
    landed, or lands while the element looks at the chunk, goes through
    one path on one array: the host path on the landed copy, or the
    torch path on the still-reachable tensor."""
    from nnstreamer_tpu_torch.elements import transform as T
    from nnstreamer_tpu_torch.tensors import buffer as B
    from nnstreamer_tpu_torch.tensors.transfer import PendingHost
    for mod in (B, T):
        monkeypatch.setattr(mod, "is_device_tensor",
                            lambda x: isinstance(x, torch.Tensor))
    dev = torch.arange(6, dtype=torch.uint8)
    pending = PendingHost(_LandingTicket(dev.numpy(), landed), 0, dev)
    el = make_element("tensor_transform", mode="arithmetic",
                      option="typecast:float32,mul:2")
    el.start()
    out = el.transform(pt.Buffer([pt.Chunk(pending)])).chunks[0].raw
    assert isinstance(out, np.ndarray if landed else torch.Tensor)
    assert out.dtype in (np.float32, torch.float32)
    np.testing.assert_array_equal(np.asarray(out), np.arange(6) * 2.0)


# -- tensor_sink / tensor_debug --------------------------------------------

def test_tensor_sink_signals_and_rate():
    seen, eos = [], []
    pipe = pt.parse_launch(
        "videotestsrc pattern=counter num-buffers=6 "
        'caps="video/x-raw,format=GRAY8,width=2,height=2" '
        "! tensor_converter ! tensor_debug output-type=console "
        "! tensor_sink name=out signal-rate=2 max-buffers=4")
    pipe["out"].connect_signal("new-data", seen.append)
    pipe["out"].connect_signal("eos", lambda: eos.append(True))
    pipe.run(timeout=30)
    assert [int(b.chunks[0].host()[0, 0, 0]) for b in seen] == [1, 3, 5]
    assert len(pipe["out"].buffers) == 4 and eos == [True]


# -- the slice's modules import nothing of JAX -------------------------------

def test_new_port_modules_import_no_jax():
    """The modules this slice adds (the detection models, the decoders,
    the video front end), chip_smoke.py and tools/torch_profile.py pull
    in nothing of JAX or of the JAX package, checked in a fresh
    interpreter; the scripts' function-level imports are read from
    their source."""
    import ast
    import os
    import subprocess
    import sys
    modules = ["models.detection", "models.convert", "decoders.font",
               "decoders.bounding_box", "decoders.pose", "decoders.segment",
               "elements.media", "elements.converter", "elements.transform",
               "elements.sinks", "converters.registry", "pipeline.registry"]
    code = ("import sys, chip_smoke, "
            + ", ".join(f"nnstreamer_tpu_torch.{m}" for m in modules)
            + "; bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'ml_dtypes', 'nnstreamer_tpu')]; "
            "assert not bad, bad")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root)
    for script in ("chip_smoke.py", os.path.join("tools", "torch_profile.py")):
        with open(os.path.join(root, script)) as f:
            tree = ast.parse(f.read())
        roots = {a.name.split(".")[0] for n in ast.walk(tree)
                 if isinstance(n, ast.Import) for a in n.names}
        roots |= {n.module.split(".")[0] for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.module}
        assert "nnstreamer_tpu_torch" in roots, script
        assert not roots & {"jax", "jaxlib", "flax", "ml_dtypes",
                            "nnstreamer_tpu"}, script
