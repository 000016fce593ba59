"""The port's wire codecs against the JAX package's: flatbuf, flexbuf,
protobuf and octet (interop/tensor_codec.py), the codec decoders
(``tensor_decoder mode=flatbuf|flexbuf|protobuf|octet_stream``) and the
codec converters (``tensor_converter`` on other/flatbuf-tensor,
other/flexbuf, other/protobuf-tensor).

Codecs are byte formats, so the tolerance everywhere is equality: the
same frame packs to the same bytes in both packages, and each package
unpacks the other's bytes to the same arrays (dtype, shape and bytes)
and names. The round-trip pipelines of tests/test_codecs.py run in both
packages and must hand their sinks the same buffers.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as pt
from nnstreamer_tpu.interop import flexbuf as jflexbuf
from nnstreamer_tpu.interop import tensor_codec as jtc
from nnstreamer_tpu_torch.interop import flexbuf as pflexbuf
from nnstreamer_tpu_torch.interop import tensor_codec as ptc

CODECS = ["flatbuf", "flexbuf", "protobuf"]
CAPS = ('other/tensors,format=static,num_tensors=2,'
        'types=(string)"float32,uint8",dimensions=(string)"4:2,3",'
        'framerate=10/1')
DTYPES = [np.float32, np.uint8, np.float64, np.int16, np.int64, np.float16,
          np.int8, np.uint32]


def _frame(seed: int):
    """A seeded frame with one tensor of each numpy dtype the codecs
    carry, of ranks 0-4, and names (one empty)."""
    rng = np.random.default_rng(seed)
    arrays = []
    for i, dt in enumerate(DTYPES):
        shape = [(), (5,), (2, 3), (3, 1, 2), (1, 2, 2, 2)][i % 5]
        x = rng.standard_normal(shape) * 50
        arrays.append(np.asarray(x).astype(dt))
    names = [f"t{i}" if i != 3 else "" for i in range(len(arrays))]
    return arrays, names


def _same_arrays(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("codec", CODECS + ["octet"])
@pytest.mark.parametrize("seed", [0, 1])
def test_frame_packs_to_the_same_bytes(codec, seed):
    arrays, names = _frame(seed)
    jb = getattr(jtc, f"pack_{codec}")(jtc.Frame(arrays, names, 30, 1, 0))
    pb = getattr(ptc, f"pack_{codec}")(ptc.Frame(arrays, names, 30, 1, 0))
    assert pb == jb


@pytest.mark.parametrize("codec", CODECS)
def test_each_package_unpacks_the_others_bytes(codec):
    arrays, names = _frame(7)
    jb = getattr(jtc, f"pack_{codec}")(jtc.Frame(arrays, names, 15, 2, 1))
    pb = getattr(ptc, f"pack_{codec}")(ptc.Frame(arrays, names, 15, 2, 1))
    from_jax = getattr(ptc, f"unpack_{codec}")(jb)
    from_port = getattr(jtc, f"unpack_{codec}")(pb)
    for out in (from_jax, from_port):
        _same_arrays(out.arrays, [a if a.ndim else a.reshape(1)
                                  for a in arrays])
        assert out.names == names
        assert (out.rate_n, out.rate_d, out.fmt) == (15, 2, 1)


@pytest.mark.parametrize("codec", CODECS + ["octet"])
def test_bfloat16_rides_as_its_bits(codec):
    """numpy has no bf16: the port packs a CPU torch.bfloat16 tensor from
    its uint16 bits, the bytes the JAX package packs from an ml_dtypes
    array, and unpacks them to a torch.bfloat16 tensor."""
    x = np.random.default_rng(3).standard_normal((2, 5)).astype(
        ml_dtypes.bfloat16)
    t = torch.from_numpy(x.view(np.uint16).copy()).view(torch.bfloat16)
    jb = getattr(jtc, f"pack_{codec}")(jtc.Frame([x], ["b"], 0, 1))
    pb = getattr(ptc, f"pack_{codec}")(ptc.Frame([t], ["b"], 0, 1))
    assert pb == jb
    if codec == "octet":
        return
    (got,) = getattr(ptc, f"unpack_{codec}")(jb).arrays
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, 5)
    assert torch.equal(got.view(torch.uint16),
                       torch.from_numpy(x.view(np.uint16)))
    (back,) = getattr(jtc, f"unpack_{codec}")(pb).arrays
    assert back.tobytes() == x.tobytes()


@pytest.mark.parametrize("flexbuf", [jflexbuf, pflexbuf], ids=["jax", "torch"])
def test_flexbuf_reads_minimal_width_buffer(flexbuf):
    """A hand-laid-out flexbuffer for {"a": 5} using 1-byte widths (the
    shape a minimal-width writer produces) parses in both packages
    (tests/test_codecs.py's reader case)."""
    buf = bytes([
        ord("a"), 0,    # key "a\0"            @0
        1,              # keys-vector length    @2
        3,              # key offset (3-3=0)    @3
        1,              # map: keys offset      @4 (4-1=3)
        1,              # map: keys byte width  @5
        1,              # map: length           @6
        5,              # value slot (int 5)    @7
        (flexbuf.INT << 2) | 0,   # packed type @8
        2,              # root offset (9-2=7)   @9
        (flexbuf.MAP << 2) | 0,   # root type
        1,              # root byte width
    ])
    m = flexbuf.root(buf).as_map()
    assert list(m) == ["a"]
    assert m["a"].as_int() == 5


def test_flexbuf_keys_and_flatbuf_fields_are_the_references():
    """The reference's map keys "tensor_%d" and the Tensors schema's
    field ids, read by the independent readers."""
    from nnstreamer_tpu_torch.interop.flatbuf import FlatBuf
    frame = ptc.Frame([np.ones(5, np.float32), np.zeros(3, np.uint8)],
                      ["t0", "t1"], 15, 1)
    fx = ptc.pack_flexbuf(frame)
    assert {"tensor_0", "tensor_1", "num_tensors", "rate_n", "rate_d",
            "format"} <= set(pflexbuf.root(fx).as_map())
    assert b"tensor_0\x00" in fx and b"tensor_#0" not in fx
    fb = FlatBuf(ptc.pack_flatbuf(frame))
    root = fb.root()
    assert fb.field_scalar(root, 0, "i32") == 2           # num_tensor
    t = next(fb.vector_tables(fb.field_vector(root, 2)))
    assert fb.field_string(t, 0) == "t0"
    assert fb.field_scalar(t, 1, "i32", 11) == 7          # NNS_FLOAT32


# -- the decoder and converter lines, in both packages ----------------------------

def _run(pkg, desc):
    pipe = pkg.parse_launch(desc)
    pipe.run(30)
    return pipe


def _host(chunk):
    return np.asarray(chunk.host())


def _assert_same_sinks(desc, sinks, n):
    jp, pp = _run(nt, desc), _run(pt, desc)
    for sink in sinks:
        want, got = jp[sink].buffers, pp[sink].buffers
        assert len(got) == len(want) == n
        for w, g in zip(want, got):
            assert g.pts == w.pts
            _same_arrays([_host(c) for c in g.chunks],
                         [_host(c) for c in w.chunks])
        assert str(pp[sink].sinkpad.caps) == str(jp[sink].sinkpad.caps)
    return jp, pp


@pytest.mark.parametrize("mode", CODECS)
def test_decoder_converter_round_trip_equals_the_jax_line(mode):
    """tensors -> codec bytes -> tensors (tests/test_codecs.py's round
    trip): the port's line hands its sinks the JAX line's buffers, and
    the round trip gives back the straight leg's arrays."""
    # pipelint: skip (a template: the codec mode is parametrised)
    desc = (f'tensortestsrc caps="{CAPS}" num-buffers=3 pattern=random '
            f"seed=7 ! tee name=t "
            f"t. ! queue ! appsink name=ref "
            f"t. ! queue ! tensor_decoder mode={mode} ! tensor_converter ! "
            "appsink name=out")
    _, pp = _assert_same_sinks(desc, ["ref", "out"], 3)
    for rb, ob in zip(pp["ref"].buffers, pp["out"].buffers):
        _same_arrays([_host(c) for c in ob.chunks],
                     [_host(c) for c in rb.chunks])


@pytest.mark.parametrize("mode,mime", [
    ("flatbuf", "other/flatbuf-tensor"), ("flexbuf", "other/flexbuf"),
    ("protobuf", "other/protobuf-tensor"),
    ("octet_stream", "application/octet-stream")])
def test_decoder_bytes_and_mimetype_equal_the_jax_line(mode, mime):
    # pipelint: skip (a template: the codec mode is parametrised)
    desc = (f'tensortestsrc caps="{CAPS}" num-buffers=2 pattern=random '
            f"seed=5 ! tensor_decoder mode={mode} ! appsink name=out")
    _, pp = _assert_same_sinks(desc, ["out"], 2)
    assert pp["out"].sinkpad.caps.structures[0].name == mime
    if mode == "octet_stream":
        # 2x4 float32 + 3 uint8 = 35 bytes of raw payload
        assert _host(pp["out"].buffers[0].chunks[0]).nbytes == 35


def test_octet_round_trip_via_converter_equals_the_jax_line():
    """octet bytes back to tensors with explicit input-dim/input-type
    (≙ gsttensor_converter.c octet mode)."""
    caps1 = ('other/tensors,format=static,num_tensors=1,'
             'types=(string)float32,dimensions=(string)4,framerate=10/1')
    desc = (f'tensortestsrc caps="{caps1}" num-buffers=2 pattern=counter ! '
            "tensor_decoder mode=octet_stream ! "
            "tensor_converter input-dim=4 input-type=float32 ! "
            "appsink name=out")
    _, pp = _assert_same_sinks(desc, ["out"], 2)
    np.testing.assert_array_equal(_host(pp["out"].buffers[1].chunks[0]),
                                  np.ones(4, np.float32))


@pytest.mark.parametrize("mode", CODECS)
def test_jax_bytes_convert_in_the_port(mode):
    """The JAX package's decoder output fed to the port's converter (and
    the port's to the JAX converter) comes out as the frame it packed."""
    # pipelint: skip (a template: the codec mode is parametrised)
    desc = (f'tensortestsrc caps="{CAPS}" num-buffers=2 pattern=random '
            f"seed=9 ! tee name=t t. ! queue ! appsink name=ref "
            f"t. ! queue ! tensor_decoder mode={mode} ! appsink name=out")
    mime = {"flatbuf": "other/flatbuf-tensor", "flexbuf": "other/flexbuf",
            "protobuf": "other/protobuf-tensor"}[mode]
    src = {nt: _run(nt, desc), pt: _run(pt, desc)}
    for producer, consumer in ((nt, pt), (pt, nt)):
        pipe = consumer.parse_launch(
            f'appsrc name=in caps="{mime},framerate=10/1" '
            "! tensor_converter ! appsink name=back")
        pipe.start()
        try:
            for b in src[producer]["out"].buffers:
                pipe["in"].push_buffer(consumer.Buffer.from_arrays(
                    [_host(b.chunks[0])], pts=b.pts))
            pipe["in"].end_stream()
            assert pipe.wait_eos(30)
        finally:
            pipe.stop()
        got = pipe["back"].buffers
        want = src[producer]["ref"].buffers
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            _same_arrays([_host(c) for c in g.chunks],
                         [_host(c) for c in w.chunks])
