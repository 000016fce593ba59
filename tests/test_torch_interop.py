"""The port's imported-model backends against the JAX package's:
tensorflow-lite (interop/tflite.py), onnxruntime (interop/onnx.py) and
tensorflow (interop/tf_graphdef.py), with their filters
(filters/{tflite,onnx,tf}_backend.py over filters/interop_base.py).

The model files come from tools/torch_model_files.py, a writer with its
own FlatBuffers and protobuf encoders that imports neither package; it
is loaded by path. Each file goes through the JAX importer's ``fn`` and
the port's module, both on the CPU, and the outputs are compared:

* f32: |port - jax| <= 1e-5 * |jax| + 1e-5 * max|jax| per element
  (rtol 1e-5, with the same relative bound on the output's scale for
  elements near zero);
* integer outputs (u8 requantized logits, argmax, casts, shapes): at most
  1 LSB (1 unit) on any element.

Where the JAX importer departs from the formats' own semantics, the
case holds the port to a numpy oracle of the format and pins the JAX
importer's departure (ROADMAP.md queue C): TRANSPOSE_CONV and
RESIZE_NEAREST_NEIGHBOR without half-pixel centers.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as pt
from nnstreamer_tpu.filters import (FilterProperties as NtProps,
                                    detect_framework as nt_detect,
                                    find_filter as nt_find)
from nnstreamer_tpu.interop import onnx as jonnx
from nnstreamer_tpu.interop import tf_graphdef as jgraphdef
from nnstreamer_tpu.interop import tflite as jtflite
from nnstreamer_tpu_torch.filters import (Accelerator, FilterEvent,
                                          FilterProperties, detect_framework,
                                          find_filter)
from nnstreamer_tpu_torch.interop import onnx as ponnx
from nnstreamer_tpu_torch.interop import tf_graphdef as pgraphdef
from nnstreamer_tpu_torch.interop import tflite as ptflite

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "torch_model_files", os.path.join(ROOT, "tools", "torch_model_files.py"))
mf = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mf)

JAX = {"tflite": jtflite, "onnx": jonnx, "pb": jgraphdef}
PORT = {"tflite": ptflite, "onnx": ponnx, "pb": pgraphdef}
FRAMEWORK = {"tflite": "tensorflow-lite", "onnx": "onnxruntime",
             "pb": "tensorflow"}
FORM_FMT = {"tflite": "tflite", "tflite_u8": "tflite", "onnx": "onnx",
            "onnx_qlinear": "onnx", "pb": "pb"}
CPU = (Accelerator.CPU,)


def _port_run(model, xs):
    with torch.inference_mode():
        outs = model.module(*[torch.from_numpy(np.ascontiguousarray(x))
                              for x in xs])
    return [o.numpy() for o in outs]


def _jax_run(model, xs):
    return [np.asarray(o) for o in model.fn(*xs)]


def assert_close(got, want):
    """The module docstring's tolerance for one output."""
    assert got.shape == want.shape and got.dtype == want.dtype
    if want.dtype.kind == "f":
        bound = 1e-5 * np.abs(want) + 1e-5 * np.abs(want).max()
        err = np.abs(got.astype(np.float64) - want)
        assert (err <= bound).all(), float((err - bound).max())
    else:
        d = np.abs(got.astype(np.int64) - want.astype(np.int64))
        assert d.max(initial=0) <= 1


# -- numpy oracles of the formats, where the JAX importer departs ------------------

def _tfl_transpose_conv(x, w, b, out_shape, stride):
    """TFLite TRANSPOSE_CONV, SAME padding: every input pixel scatters
    its kernel; the output window starts at the SAME offset of the output
    shape (tensorflow/lite/kernels/transpose_conv.cc)."""
    n, ih, iw, _ = x.shape
    co, kh, kw, _ = w.shape
    oh, ow = out_shape[1], out_shape[2]

    def begin(o, k):
        tot = max((-(-o // stride) - 1) * stride + k - o, 0)
        return tot // 2
    pt_, pl = begin(oh, kh), begin(ow, kw)
    out = np.zeros((n, oh, ow, co), np.float64)
    for iy in range(ih):
        for ix in range(iw):
            for ky in range(kh):
                for kx in range(kw):
                    y, xx = iy * stride + ky - pt_, ix * stride + kx - pl
                    if 0 <= y < oh and 0 <= xx < ow:
                        out[:, y, xx, :] += x[:, iy, ix, :] @ \
                            w[:, ky, kx, :].T.astype(np.float64)
    return (out + b).astype(np.float32)


def _tfl_nearest(x, out_hw, align, half):
    """TFLite ResizeNearestNeighbor (reference_ops.h GetNearestNeighbor)."""
    def index(out, inp):
        scale = np.float32((inp - 1) / (out - 1) if align and out > 1
                           else inp / out)
        pos = (np.arange(out, dtype=np.float32)
               + np.float32(0.5 if half else 0.0)) * scale
        i = np.round(pos) if align else np.floor(pos)
        i = np.minimum(i.astype(np.int64), inp - 1)
        return np.maximum(i, 0) if half else i
    return x[:, index(out_hw[0], x.shape[1])][:, :, index(out_hw[1],
                                                          x.shape[2])]


def _transpose_conv_consts(path):
    tensors, ops, _, _ = jtflite.parse(path)
    (op,) = ops
    out_shape, w, _, b = (tensors[i].const for i in op.inputs)
    return out_shape, w, b


# -- one case per op code -----------------------------------------------------------

def _cases(fmt):
    return [(fmt, name) for name in mf.CASES[fmt]]


ALL_CASES = _cases("tflite") + _cases("onnx") + _cases("pb")


def test_every_lowered_op_code_has_a_case():
    """The writer's op table covers each op code the JAX importers lower:
    the TFLite BuiltinOperator constants, the ONNX ``_eval_node`` ops and
    the GraphDef ``lower`` ops (read from their sources)."""
    import inspect
    import re
    tfl = {k for k, v in vars(jtflite).items()
           if isinstance(v, int) and k.isupper()}
    assert tfl == set(mf.CASES["tflite"])
    onnx_src = inspect.getsource(jonnx._eval_node)
    onnx_ops = set(re.findall(r'op == "(\w+)"', onnx_src))
    for group in re.findall(r"op in \(([^)]*)\)", onnx_src):
        onnx_ops |= set(re.findall(r'"(\w+)"', group))
    assert onnx_ops == set(mf.CASES["onnx"])
    tf_src = inspect.getsource(jgraphdef._Lowerer.lower)
    tf_ops = set(re.findall(r'op == "(\w+)"', tf_src))
    for group in re.findall(r"op in \(([^)]*)\)", tf_src):
        tf_ops |= set(re.findall(r'"(\w+)"', group))
    assert tf_ops == set(mf.CASES["pb"])


@pytest.mark.parametrize("fmt,name", ALL_CASES,
                         ids=[f"{f}-{n}" for f, n in ALL_CASES])
def test_op_case_equals_the_jax_importer(fmt, name, tmp_path):
    path, xs = mf.write_op_case(fmt, name, str(tmp_path), seed=11)
    model = PORT[fmt].load(path)
    got = _port_run(model, xs)
    assert [tuple(o.shape) for o in got] == \
        [tuple(i.shape) for i in model.output_info]
    if (fmt, name) == ("tflite", "TRANSPOSE_CONV"):
        # the JAX importer raises on this layer (see the pinned test)
        out_shape, w, b = _transpose_conv_consts(path)
        np.testing.assert_allclose(
            got[0], _tfl_transpose_conv(xs[0], w, b, out_shape, 2),
            rtol=1e-5, atol=1e-5)
        return
    want = _jax_run(JAX[fmt].load(path), xs)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_close(g, w)


def test_transpose_conv_fault_of_the_jax_importer(tmp_path):
    """Pinned JAX-importer fault: it passes the OHWI weight to
    ``lax.conv_transpose(transpose_kernel=True)`` as HWIO, swapping the
    channel axes (nnstreamer_tpu/interop/tflite.py:563-575). A layer with
    2 -> 3 channels raises; with 2 -> 2 it computes the wrong values. The
    port computes TFLite's transposed convolution in both."""
    path3, xs3 = mf.write_op_case("tflite", "TRANSPOSE_CONV",
                                  str(tmp_path), seed=11)
    with pytest.raises(ValueError, match="feature dimension"):
        _jax_run(jtflite.load(path3), xs3)
    path2, xs2 = mf.write_op_case("tflite", "TRANSPOSE_CONV_square",
                                  str(tmp_path), seed=11)
    out_shape, w, b = _transpose_conv_consts(path2)
    oracle = _tfl_transpose_conv(xs2[0], w, b, out_shape, 2)
    got = _port_run(ptflite.load(path2), xs2)[0]
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-5)
    jax_out = _jax_run(jtflite.load(path2), xs2)[0]
    assert np.abs(jax_out - oracle).max() > 0.1


def test_resize_nearest_fault_of_the_jax_importer(tmp_path):
    """Pinned JAX-importer fault: RESIZE_NEAREST_NEIGHBOR reads
    align_corners/half_pixel_centers at the bilinear options' field ids
    and then ignores them, resizing with ``jax.image.resize``, which
    samples at half-pixel centers (nnstreamer_tpu/interop/tflite.py:
    437-447). Without half-pixel centers TFLite samples at
    floor(i * in / out): a 4 -> 2 downscale takes rows 0 and 2, JAX
    rows 1 and 3. The port samples as TFLite does (the op case above
    holds it to JAX where both sample at half-pixel centers)."""
    path, xs = mf.write_op_case("tflite", "RESIZE_NEAREST_NEIGHBOR_default",
                                str(tmp_path), seed=11)
    oracle = _tfl_nearest(xs[0], (2, 6), False, False)
    np.testing.assert_array_equal(_port_run(ptflite.load(path), xs)[0],
                                  oracle)
    jax_out = _jax_run(jtflite.load(path), xs)[0]
    np.testing.assert_array_equal(jax_out,
                                  _tfl_nearest(xs[0], (2, 6), False, True))
    assert not np.array_equal(jax_out, oracle)


def test_strided_slice_with_negative_strides_equals_the_jax_importer(
        tmp_path):
    """Backward strides on two axes (3 -> 0 by -1; -1 to the start by -2,
    end_mask on that axis): torch slices forward only, so the port
    gathers such an axis by its indices."""
    path, xs = mf.write_op_case("tflite", "STRIDED_SLICE_backward",
                                str(tmp_path), seed=11)
    (got,) = _port_run(ptflite.load(path), xs)
    (want,) = _jax_run(jtflite.load(path), xs)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, xs[0][3:0:-1, -1::-2, 0:2])


# -- MobileNet-v2 in its five forms, small -----------------------------------------

@pytest.fixture(scope="module")
def mobilenet(tmp_path_factory):
    out = tmp_path_factory.mktemp("mobilenet")
    return mf.write_mobilenet_v2(str(out), width=0.35, size=96, seed=0)


def _frames(info, n, seed):
    rng = np.random.default_rng(seed)
    if info.type.np_dtype == np.uint8:
        return [rng.integers(0, 256, info.shape, dtype=np.uint8)
                for _ in range(n)]
    return [rng.uniform(-1, 1, info.shape).astype(np.float32)
            for _ in range(n)]


@pytest.mark.parametrize("form", list(mf.MOBILENET_FILES))
def test_mobilenet_v2_equals_the_jax_importer(form, mobilenet):
    fmt = FORM_FMT[form]
    port = PORT[fmt].load(mobilenet[form])
    ref = JAX[fmt].load(mobilenet[form])
    for mine, theirs in ((port.input_info, ref.input_info),
                         (port.output_info, ref.output_info)):
        assert [(str(i.type), tuple(i.shape)) for i in mine] == \
            [(str(i.type), tuple(i.shape)) for i in theirs]
    for x in _frames(port.input_info[0], 3, seed=21):
        (got,), (want,) = _port_run(port, [x]), _jax_run(ref, [x])
        assert_close(got, want)
        assert np.argmax(got) == np.argmax(want)


def _caps_of(info):
    dims = ":".join(str(d) for d in reversed(info.shape))
    return (f"other/tensors,format=static,num_tensors=1,"
            f"types=(string){info.type},dimensions=(string){dims},"
            "framerate=(fraction)0/1")


@pytest.mark.parametrize("form", list(mf.MOBILENET_FILES))
def test_mobilenet_v2_line_equals_the_jax_line(form, mobilenet):
    """``tensortestsrc ! tensor_filter framework=<fw> model=<file> !
    appsink`` in both packages, on the CPU."""
    fmt = FORM_FMT[form]
    info = PORT[fmt].load(mobilenet[form]).input_info[0]
    line = (f'tensortestsrc caps="{_caps_of(info)}" num-buffers=3 '
            "pattern=random seed=4 ! tensor_filter name=f "
            f"framework={FRAMEWORK[fmt]} model={mobilenet[form]} "
            "accelerator=true:cpu ! appsink name=out")
    jp, pp = nt.parse_launch(line), pt.parse_launch(line)
    jp.run(60)
    pp.run(60)
    want, got = jp["out"].buffers, pp["out"].buffers
    assert len(got) == len(want) == 3
    for w, g in zip(want, got):
        assert g.pts == w.pts
        assert_close(np.asarray(g.chunks[0].host()),
                     np.asarray(w.chunks[0].host()))


# -- the backends --------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_files(tmp_path_factory):
    """One file of each format, and a second TFLite file (another seed)
    for RELOAD_MODEL."""
    out = str(tmp_path_factory.mktemp("small"))
    files = {fmt: mf.write_op_case(fmt, {"tflite": "CONV_2D",
                                         "onnx": "Conv",
                                         "pb": "Conv2D"}[fmt], out, seed=5)
             for fmt in ("tflite", "onnx", "pb")}
    other = os.path.join(out, "other")
    files["tflite_other"] = mf.write_op_case("tflite", "CONV_2D", other,
                                             seed=6)
    return files


def test_detection_and_aliases_equal_the_jax_package(small_files):
    for fmt in ("tflite", "onnx", "pb"):
        path = small_files[fmt][0]
        assert detect_framework((path,)) == nt_detect((path,)) == \
            FRAMEWORK[fmt]
    for alias in ("tensorflow-lite", "tensorflow2-lite", "tflite",
                  "onnxruntime", "onnx", "tensorflow"):
        assert find_filter(alias).NAME == nt_find(alias).NAME


@pytest.mark.parametrize("fmt", ["tflite", "onnx", "pb"])
def test_model_info_and_invoke_equal_the_jax_backend(fmt, small_files):
    path, xs = small_files[fmt]
    fw = find_filter(FRAMEWORK[fmt])()
    fw.open(FilterProperties(framework=FRAMEWORK[fmt], model_files=(path,),
                             accelerators=CPU))
    ref = nt_find(FRAMEWORK[fmt])()
    ref.open(NtProps(framework=FRAMEWORK[fmt], model_files=(path,)))
    try:
        (pin, pout), (jin, jout) = fw.get_model_info(), ref.get_model_info()
        assert [(str(i.type), tuple(i.shape)) for i in pin] == \
            [(str(i.type), tuple(i.shape)) for i in jin]
        assert [(str(i.type), tuple(i.shape)) for i in pout] == \
            [(str(i.type), tuple(i.shape)) for i in jout]
        # a pipeline buffer without the size-1 batch dim
        x = xs[0].reshape(xs[0].shape[1:])
        got = fw.invoke([x])[0].numpy()
        assert_close(got, np.asarray(ref.invoke([x])[0]))
    finally:
        fw.close()
        ref.close()


def test_events_leave_the_next_frame_equal(small_files):
    path, xs = small_files["tflite"]
    fw = find_filter("tflite")()
    fw.open(FilterProperties(framework="tensorflow-lite", model_files=(path,),
                             accelerators=CPU))
    try:
        first = fw.invoke(xs)[0].numpy()
        assert fw.handle_event(FilterEvent.SUSPEND)
        assert fw._module is None  # the weights wait on the host
        assert np.array_equal(fw.invoke(xs)[0].numpy(), first)
        assert fw.handle_event(FilterEvent.SUSPEND)
        assert fw.handle_event(FilterEvent.RESUME)
        assert fw._module is not None
        assert np.array_equal(fw.invoke(xs)[0].numpy(), first)
        other, _ = small_files["tflite_other"]
        assert fw.handle_event(FilterEvent.RELOAD_MODEL,
                               {"model_files": (other,)})
        want = _jax_run(jtflite.load(other), xs)[0]
        assert_close(fw.invoke(xs)[0].numpy(), want)
    finally:
        fw.close()


def _run_keeping_fw(pkg, line):
    """Run ``line`` to EOS; ``fw_name`` is filter f's backend, read
    before ``stop`` closes it."""
    pipe = pkg.parse_launch(line)
    pipe.start()
    try:
        assert pipe.wait_eos(60)
        pipe.fw_name = type(pipe["f"].fw).NAME
    finally:
        pipe.stop()
    return pipe


@pytest.mark.parametrize("fmt", ["tflite", "onnx", "pb"])
def test_auto_framework_line_equals_the_jax_line(fmt, small_files):
    """``tensor_filter model=<file>`` without ``framework`` picks the same
    backend in both packages and gives the same frames."""
    path, xs = small_files[fmt]
    info = PORT[fmt].load(path).input_info[0]
    line = (f'tensortestsrc caps="{_caps_of(info)}" num-buffers=2 '
            f"pattern=random seed=3 ! tensor_filter name=f model={path} "
            "accelerator=true:cpu ! appsink name=out")
    jp, pp = _run_keeping_fw(nt, line), _run_keeping_fw(pt, line)
    assert pp.fw_name == jp.fw_name == FRAMEWORK[fmt]
    for w, g in zip(jp["out"].buffers, pp["out"].buffers):
        assert_close(np.asarray(g.chunks[0].host()),
                     np.asarray(w.chunks[0].host()))


@pytest.mark.parametrize("alias", ["tensorflow-lite", "tensorflow2-lite",
                                   "tflite", "onnxruntime", "onnx",
                                   "tensorflow"])
def test_every_framework_name_opens_in_a_line(alias, small_files):
    fmt = {"onnxruntime": "onnx", "onnx": "onnx",
           "tensorflow": "pb"}.get(alias, "tflite")
    path, _ = small_files[fmt]
    info = PORT[fmt].load(path).input_info[0]
    pipe = _run_keeping_fw(pt, (
        f'tensortestsrc caps="{_caps_of(info)}" num-buffers=1 ! '
        f"tensor_filter name=f framework={alias} model={path} "
        "accelerator=true:cpu ! appsink name=out"))
    assert len(pipe["out"].buffers) == 1
    assert pipe.fw_name == FRAMEWORK[fmt]


def test_without_cuda_the_backend_raises_rather_than_run_on_the_cpu(
        small_files, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fmt in ("tflite", "onnx", "pb"):
        fw = find_filter(FRAMEWORK[fmt])()
        with pytest.raises(RuntimeError, match="CUDA"):
            fw.open(FilterProperties(framework=FRAMEWORK[fmt],
                                     model_files=(small_files[fmt][0],)))


def _unsupported(fmt, path, monkeypatch):
    if fmt == "tflite":
        monkeypatch.setitem(mf.TFL_OPS, "BUCKETIZE", 147)
        g = mf.TFLiteGraph()
        g.inputs = [g.tensor((2,))]
        g.outputs = [g.tensor((2,))]
        g.op("BUCKETIZE", g.inputs, g.outputs)
        data = g.to_bytes()
    elif fmt == "onnx":
        g = mf.OnnxGraph()
        g.input("x0", np.float32, (2,))
        g.node("Det", ["x0"], outputs=["y"])
        g.output("y", np.float32, (2,))
        data = g.to_bytes()
    else:
        g = mf.TfGraph()
        g.node("FFT", [g.placeholder((2,), "x0")], name="y")
        data = g.to_bytes()
    with open(path, "wb") as f:
        f.write(data)
    return path


@pytest.mark.parametrize("fmt", ["tflite", "onnx", "pb"])
def test_unsupported_op_fails_loud(fmt, tmp_path, monkeypatch):
    """An op no importer lowers raises NotImplementedError naming it: the
    port at load for every format; the JAX package at load for GraphDef
    (its ``eval_shape``) and at the first call for TFLite and ONNX, whose
    ``load`` does not trace."""
    path = _unsupported(fmt, str(tmp_path / f"bad.{fmt}"), monkeypatch)
    with pytest.raises(NotImplementedError):
        PORT[fmt].load(path)
    x = np.zeros(2, np.float32)
    with pytest.raises(NotImplementedError):
        JAX[fmt].load(path).fn(x)
