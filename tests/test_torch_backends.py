"""The port's plain filter backends and SingleShot against the JAX
package's, on the CPU.

``custom-easy``, ``python3``, ``custom`` (a C .so built here with g++
from csrc/custom_scaler.cc) and ``pytorch`` (one TorchScript file traced
here) run the same user code in both packages, so their outputs are
compared bitwise. SingleShot runs the JAX zoo's mlp weights in both,
within the mlp tolerance of tests/test_torch_pipeline.py. Framework
auto-detection picks for ``.so``/``.pt``/``.pth``/``.py`` what the JAX
package picks, with the port's ``torch-cuda`` in place of ``jax``.
"""
import os
import shutil
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as pt
from nnstreamer_tpu.filters import detect_framework as jax_detect
from nnstreamer_tpu.filters import find_filter as jax_find
from nnstreamer_tpu.filters import register_custom_easy as jax_register
from nnstreamer_tpu.filters import unregister_custom_easy as jax_unregister
from nnstreamer_tpu.models import zoo as jax_zoo
from nnstreamer_tpu_torch.filters import (detect_framework, find_filter,
                                          register_custom_easy,
                                          unregister_custom_easy)
from nnstreamer_tpu_torch.filters.base import Accelerator

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "accelerator=true:cpu"
F32_CAPS = ("other/tensors,format=static,num_tensors=1,types=(string)float32,"
            "dimensions=(string)3:4:4,framerate=(fraction)0/1")
U8_CAPS = ("other/tensors,format=static,num_tensors=1,types=(string)uint8,"
           "dimensions=(string)3:8:8,framerate=(fraction)0/1")
MLP_ATOL = 2.0 ** -7  # tests/test_torch_pipeline.py's mlp tolerance


def _run(pkg, line):
    pipe = pkg.parse_launch(line)
    pipe.run(timeout=120)
    return pipe


def _outs(pipe):
    return [[np.asarray(c.host()) for c in b.chunks]
            for b in pipe["out"].buffers]


def _same_bytes(got, want, n):
    assert len(got) == len(want) == n
    for g, w in zip(got, want):
        assert [(a.dtype, a.shape, a.tobytes()) for a in g] == \
            [(a.dtype, a.shape, a.tobytes()) for a in w]


# -- custom-easy and python3 ---------------------------------------------------

def _scale_shift(x):
    x = np.asarray(x)
    return [x * np.float32(1.5) - np.float32(0.25), x.sum(axis=0)]


def test_custom_easy_matches_jax_bitwise():
    register_custom_easy("scale_shift", _scale_shift)
    jax_register("scale_shift", _scale_shift)
    line = (f"tensortestsrc caps={F32_CAPS} num-buffers=3 pattern=random "
            "seed=1 ! tensor_filter framework=custom-easy model=scale_shift "
            "! appsink name=out")
    try:
        got, want = _run(pt, line), _run(nt, line)
    finally:
        unregister_custom_easy("scale_shift")
        jax_unregister("scale_shift")
    _same_bytes(_outs(got), _outs(want), 3)
    assert not unregister_custom_easy("scale_shift")


def test_custom_easy_unknown_name_raises():
    pipe = pt.parse_launch(
        f"tensortestsrc caps={F32_CAPS} num-buffers=1 ! tensor_filter "
        "framework=custom-easy model=nobody ! appsink")
    with pytest.raises(ValueError, match="not registered"):
        pipe.start()
    pipe.stop()


PY3_SCRIPT = '''
import numpy as np

SCALE = float(custom_properties or "1")


def invoke(inputs):
    x = np.asarray(inputs[0]).astype(np.float32)
    return [np.cumsum(x * np.float32(SCALE), axis=-1, dtype=np.float32)]
'''


def test_python3_script_matches_jax_bitwise(tmp_path):
    """One script through both packages' python3 backend (it defines no
    info functions, so the out caps are FLEXIBLE in both); it sees the
    filter's custom string."""
    script = tmp_path / "cumsum.py"
    script.write_text(PY3_SCRIPT)
    line = (f"tensortestsrc caps={U8_CAPS} num-buffers=3 pattern=random "
            f"seed=2 ! tensor_filter framework=python3 model={script} "
            "custom=0.5 ! appsink name=out")
    got, want = _run(pt, line), _run(nt, line)
    _same_bytes(_outs(got), _outs(want), 3)
    assert str(got["out"].sinkpad.caps) == str(want["out"].sinkpad.caps)
    frame = np.random.default_rng(2).integers(0, 255, (8, 8, 3), np.uint8,
                                              endpoint=True)
    np.testing.assert_array_equal(
        _outs(got)[0][0], np.cumsum(frame.astype(np.float32) * 0.5, axis=-1,
                                    dtype=np.float32))


# -- custom: a C .so over csrc/nns_custom.h ----------------------------------

# drops every second frame: invoke returns 1 (≙ invoke result > 0)
DROPPER_CC = r"""
#include <string.h>
#include "nns_custom.h"

static int calls;

static void *init(const char *props) { calls = 0; return (void *)1; }
static void fini(void *priv) {}
static int set_input_dim(void *priv, const nns_tensors_info *in,
                         nns_tensors_info *out) { *out = *in; return 0; }
static int invoke(void *priv, const nns_tensors_info *in_info,
                  const void *const *in, const nns_tensors_info *out_info,
                  void *const *out) {
  if (calls++ % 2) return 1;
  size_t n = sizeof(float);
  for (uint32_t d = 0; d < in_info->info[0].rank; d++)
    n *= in_info->info[0].dims[d];
  memcpy(out[0], in[0], n);
  return 0;
}

static const nns_custom_filter filter = {init, fini, NULL, NULL,
                                         set_input_dim, invoke};
extern "C" const nns_custom_filter *nns_custom_get(void) { return &filter; }
"""


def _build_so(tmp, src, name):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler (g++/c++) to build the example .so")
    out = tmp / name
    subprocess.run([cxx, "-shared", "-fPIC", "-O2",
                    "-I", os.path.join(ROOT, "csrc"), src,
                    "-o", str(out)], check=True, timeout=120)
    return str(out)


@pytest.fixture(scope="module")
def scaler_so(tmp_path_factory):
    return _build_so(tmp_path_factory.mktemp("so"),
                     os.path.join(ROOT, "csrc", "custom_scaler.cc"),
                     "libcustom_scaler.so")


def test_custom_so_matches_jax_and_numpy_bitwise(scaler_so):
    line = (f"tensortestsrc caps={F32_CAPS} num-buffers=3 pattern=random "
            f"seed=3 ! tensor_filter framework=custom model={scaler_so} "
            "custom=2.5 ! appsink name=out")
    got, want = _run(pt, line), _run(nt, line)
    _same_bytes(_outs(got), _outs(want), 3)
    rng = np.random.default_rng(3)
    for (g,) in _outs(got):
        x = rng.random((4, 4, 3)).astype(np.float32)
        np.testing.assert_array_equal(g, x * np.float32(2.5))


def test_custom_so_auto_detected_and_bad_path_raises(scaler_so, tmp_path):
    assert detect_framework((scaler_so,)) == "custom"
    pipe = pt.parse_launch(
        f"tensortestsrc caps={F32_CAPS} num-buffers=1 ! tensor_filter "
        f"model={tmp_path / 'missing.so'} ! appsink")
    with pytest.raises(OSError):
        pipe.start()
    pipe.stop()


def test_custom_so_takes_device_chunks_on_the_host(scaler_so):
    """The .so gets host pointers: a chunk that is a tensor (a CUDA one
    on the card) reaches it as a host array."""
    fw = find_filter("custom")()
    from nnstreamer_tpu_torch.filters.base import FilterProperties
    fw.open(FilterProperties(framework="custom", model_files=(scaler_so,),
                             custom_properties="3"))
    assert fw.HOST_INPUTS
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    (out,) = fw.invoke([x])
    np.testing.assert_array_equal(out, x * np.float32(3))
    fw.close()


@pytest.mark.parametrize("combi", ["", "output-combination=o0"])
def test_custom_so_positive_return_drops_the_frame(tmp_path, combi):
    """An invoke that returns > 0 drops that frame and keeps the
    pipeline: the filter counts it in frames_dropped and pushes nothing
    for it, with or without output-combination."""
    src = tmp_path / "dropper.cc"
    src.write_text(DROPPER_CC)
    so = _build_so(tmp_path, str(src), "libdropper.so")
    pipe = _run(pt, f"tensortestsrc caps={F32_CAPS} num-buffers=4 "
                    "pattern=random seed=3 ! tensor_filter name=f "
                    f"framework=custom model={so} {combi} ! appsink name=out")
    rng = np.random.default_rng(3)
    frames = [rng.random((4, 4, 3)).astype(np.float32) for _ in range(4)]
    got = _outs(pipe)
    assert pipe["f"].stats["frames_dropped"] == 2
    assert [g[0].tobytes() for g in got] == \
        [frames[0].tobytes(), frames[2].tobytes()]


# -- pytorch: TorchScript ------------------------------------------------------

class _Net(torch.nn.Module):
    """u8 [8, 8, 3] frame -> f32 [4] and [4, 6, 6]: a conv, relu, mean."""

    def __init__(self):
        super().__init__()
        gen = torch.Generator().manual_seed(11)
        self.conv = torch.nn.Conv2d(3, 4, 3)
        with torch.no_grad():
            for p in self.conv.parameters():
                p.copy_(torch.randn(p.shape, generator=gen))

    def forward(self, x):
        y = torch.relu(self.conv(x.float().permute(2, 0, 1)[None] / 255.0))
        return y.mean((2, 3))[0], y[0]


@pytest.fixture(scope="module")
def traced_pt(tmp_path_factory):
    path = tmp_path_factory.mktemp("pt") / "net.pt"
    net = _Net().eval()
    torch.jit.trace(net, torch.zeros(8, 8, 3, dtype=torch.uint8)).save(
        str(path))
    return str(path)


def test_pytorch_backend_matches_jax_bitwise(traced_pt):
    """The same .pt through both packages (framework auto-detected from
    the extension): the output info probed with one zero forward, the
    outputs bitwise equal."""
    line = (f"tensortestsrc caps={U8_CAPS} num-buffers=3 pattern=random "
            f"seed=4 ! tensor_filter name=f model={traced_pt} {{acc}}"
            "input=3:8:8 inputtype=uint8 ! appsink name=out")
    names = []
    for pkg, acc in ((pt, f"{CPU} "), (nt, "")):
        pipe = pkg.parse_launch(line.format(acc=acc))
        pipe.start()
        try:
            assert pipe.wait_eos(120)
            names.append(pipe["f"].fw.NAME)
        finally:
            pipe.stop()
        if pkg is pt:
            got = pipe
    want = pipe
    assert names == ["pytorch", "pytorch"]
    _same_bytes(_outs(got), _outs(want), 3)
    assert str(got["out"].sinkpad.caps) == str(want["out"].sinkpad.caps)


def test_pytorch_backend_reload_and_alias(traced_pt, tmp_path):
    """``torch`` is an alias of ``pytorch``; RELOAD_MODEL swaps the
    module in both packages alike."""
    from nnstreamer_tpu.filters.base import FilterEvent as JaxEvent
    from nnstreamer_tpu.filters.base import FilterProperties as JaxProps
    from nnstreamer_tpu_torch.filters.base import (FilterEvent,
                                                   FilterProperties)
    assert find_filter("torch").NAME == jax_find("torch").NAME == "pytorch"
    other = tmp_path / "other.pt"
    torch.jit.script(torch.nn.Identity()).save(str(other))
    x = np.random.default_rng(5).integers(0, 255, (8, 8, 3), np.uint8)
    ours = find_filter("torch")()
    ours.open(FilterProperties(model_files=(traced_pt,),
                               accelerators=(Accelerator.CPU,)))
    theirs = jax_find("torch")()
    theirs.open(JaxProps(model_files=(traced_pt,)))
    assert np.array_equal(ours.invoke([x])[0].numpy(), theirs.invoke([x])[0])
    assert ours.handle_event(FilterEvent.RELOAD_MODEL,
                             {"model_files": (str(other),)})
    assert theirs.handle_event(JaxEvent.RELOAD_MODEL,
                               {"model_files": (str(other),)})
    assert np.array_equal(ours.invoke([x])[0].numpy(), x)
    assert np.array_equal(theirs.invoke([x])[0], x)
    assert not ours.handle_event(FilterEvent.SUSPEND)


def test_pytorch_without_cuda_raises(traced_pt, monkeypatch):
    """The default accelerator is the card: without CUDA the open raises
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from nnstreamer_tpu_torch.filters.base import FilterProperties
    fw = find_filter("pytorch")()
    with pytest.raises(RuntimeError, match="CUDA"):
        fw.open(FilterProperties(model_files=(traced_pt,)))


@pytest.mark.parametrize("framework", ["pytorch", "torch-cuda"])
def test_both_card_backends_set_full_f32_at_open(traced_pt, framework,
                                                 monkeypatch):
    """Each backend that runs a module on the card sets the process-wide
    numerics flags at its own open (no TF32 in f32 products, no cuDNN
    autotuning), so the result of one never depends on whether the
    other opened first. The flags are restored after the test."""
    from nnstreamer_tpu_torch.filters.base import FilterProperties
    for flag in (torch.backends.cuda.matmul, torch.backends.cudnn):
        monkeypatch.setattr(flag, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", True)
    model = (traced_pt if framework == "pytorch" else
             "zoo://mobilenet_v2?width=0.35&size=32")
    fw = find_filter(framework)()
    fw.open(FilterProperties(model_files=(model,),
                             accelerators=(Accelerator.CPU,)))
    fw.close()
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cudnn.benchmark


@pytest.mark.parametrize("framework", ["torch-cuda", "pytorch", "llm"])
def test_every_card_backend_turns_off_bf16_reduction_at_open(
        traced_pt, framework, monkeypatch):
    """Each card backend's open turns off cuBLAS's bf16 reduction of
    split-K partial sums (process-wide, restored after the test), so no
    bf16 product depends on which filter opened first."""
    from nnstreamer_tpu_torch.filters.base import FilterProperties
    monkeypatch.setattr(torch.backends.cuda.matmul,
                        "allow_bf16_reduced_precision_reduction", True)
    model = {"pytorch": traced_pt,
             "torch-cuda": "zoo://mobilenet_v2?width=0.35&size=32",
             "llm": "zoo://gpt?vocab=64&d_model=32&n_heads=4&n_layers=2"
             }[framework]
    fw = find_filter(framework)()
    fw.open(FilterProperties(model_files=(model,),
                             accelerators=(Accelerator.CPU,)))
    fw.close()
    assert not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction


def test_pytorch_backend_clears_the_traced_tf32_flag(tmp_path, monkeypatch):
    """torch.jit.trace freezes the tracing process's cuDNN flags into each
    aten::_convolution (allow_tf32 on by default); the pytorch backend
    rewrites them to full f32 with no autotuning at load, so the runtime
    flags' full f32 reaches a traced conv on the card too."""
    from nnstreamer_tpu_torch.filters.base import FilterProperties
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", True)
    path = str(tmp_path / "conv.pt")
    torch.jit.trace(_Net().eval(),
                    torch.zeros(8, 8, 3, dtype=torch.uint8)).save(path)

    def flags(module):
        return [[i.toIValue() for i in list(n.inputs())[9:13:3]]
                for m in module.modules() for n in m.graph.nodes()
                if n.kind() == "aten::_convolution"]

    assert flags(torch.jit.load(path)) == [[True, True]]
    fw = find_filter("pytorch")()
    fw.open(FilterProperties(model_files=(path,),
                             accelerators=(Accelerator.CPU,)))
    assert flags(fw._module) == [[False, False]]
    x = np.random.default_rng(2).integers(0, 255, (8, 8, 3), np.uint8)
    want = torch.jit.load(path)(torch.from_numpy(x))
    got = fw.invoke([x])
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    fw.close()


# -- auto-detection --------------------------------------------------------------

@pytest.mark.parametrize("name", ["m.so", "m.pt", "m.pth", "m.py"])
def test_detect_framework_picks_what_jax_picks(name):
    want = jax_detect((name,))
    assert detect_framework((name,)) == \
        {"jax": "torch-cuda"}.get(want, want)


# -- SingleShot --------------------------------------------------------------------

MLP_PY = '''
import numpy as np
from nnstreamer_tpu_torch.models import convert, zoo


def get_model():
    apply_fn, module, in_info, out_info = zoo.build("mlp")
    flat = np.load({npz!r})
    module.load_state_dict(convert.mlp_params_from_jax(
        {{k: flat[k] for k in flat.files}}))
    return apply_fn, module, in_info, out_info
'''


@pytest.fixture(scope="module")
def mlp_py(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("single")
    _, params, _, _ = jax_zoo.build("mlp")
    npz = tmp / "mlp.npz"
    np.savez(npz, **{k: np.asarray(v, dtype=np.float32)
                     for k, v in params.items()})
    path = tmp / "mlp.py"
    path.write_text(MLP_PY.format(npz=str(npz)))
    return str(path)


def test_single_shot_matches_jax(mlp_py):
    """SingleShot on the JAX zoo's mlp weights in both packages: start,
    invoke, get_model_info, the context manager and stop."""
    xs = [np.random.default_rng(i).random(64).astype(np.float32)
          for i in range(3)]
    with pt.SingleShot(mlp_py, accelerator="true:cpu") as ours, \
            nt.SingleShot("zoo://mlp", framework="jax") as theirs:
        assert ours.fw.NAME == "torch-cuda"
        assert [str(i) for i in ours.get_model_info()] == \
            [str(i) for i in theirs.get_model_info()]
        for x in xs:
            (g,) = ours.invoke([x])
            (w,) = theirs.invoke([x])
            assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=MLP_ATOL)
        assert ours.fw.compile_count == 1
    assert not ours._opened and ours.fw._module is None


def test_single_shot_invokes_lazily_and_refuses_async(mlp_py):
    """The async path is ported with the llm backend
    (tests/test_torch_llm.py); a backend without it refuses
    invoke_async, as the JAX package's base class does."""
    shot = pt.SingleShot(mlp_py, accelerator="true:cpu")
    (out,) = shot.invoke([np.zeros(64, np.float32)])
    assert out.shape == (10,) and shot._opened
    shot.set_async_callback(lambda outs: None)
    with pytest.raises(NotImplementedError, match="async"):
        shot.invoke_async([np.zeros(64, np.float32)])
    shot.stop()


def test_single_shot_async_equals_sync_on_llamacpp():
    """SingleShot(framework=llamacpp): invoke_async with a callback gives
    the tokens of a sync invoke, on the JAX package's SingleShot too."""
    model = "zoo://gpt?vocab=64&d_model=32&n_heads=4&n_layers=2"
    prompt = np.array([3, 1, 4], np.int32)
    for pkg, acc in ((pt, "true:cpu"), (nt, "")):
        shot = pkg.SingleShot(model, framework="llamacpp", accelerator=acc,
                              custom="max_tokens:6,max_len:16")
        (want,) = shot.invoke([prompt])
        got, done = [], threading.Event()

        def cb(outs):
            got.append(int(np.asarray(outs[0]).ravel()[0]))
            if len(got) == 6:
                done.set()

        shot.set_async_callback(cb)
        shot.invoke_async([prompt])
        assert done.wait(60)
        shot.stop()
        assert got == want.tolist()


def test_single_shot_runs_on_the_card_by_default(mlp_py, monkeypatch):
    """Port choice: an empty accelerator means the card, as
    tensor_filter's does; without CUDA, start raises. The JAX SingleShot
    parses an empty accelerator as NONE (Accelerator.parse("")), so it
    runs on the host CPU."""
    assert pt.SingleShot(mlp_py).props.accelerators == (Accelerator.DEFAULT,)
    jax_props = nt.SingleShot("zoo://mlp", framework="jax").props
    assert [a.value for a in jax_props.accelerators] == ["none"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.SingleShot(mlp_py).start()


# -- the port imports no JAX ---------------------------------------------------------

def test_new_modules_import_no_jax():
    """The backends, SingleShot, the watchdog, the sparse and delta ops
    and elements, the delta wire codec, the broker, the native ring and
    the serving stack (and chip_smoke.py, read as text) import nothing of
    JAX or of the JAX package; the modules are imported in a fresh
    interpreter."""
    code = ("import sys; import nnstreamer_tpu_torch.filters.custom, "
            "nnstreamer_tpu_torch.filters.custom_c, "
            "nnstreamer_tpu_torch.filters.torch_backend, "
            "nnstreamer_tpu_torch.single, "
            "nnstreamer_tpu_torch.utils.watchdog, "
            "nnstreamer_tpu_torch.ops.sparse, "
            "nnstreamer_tpu_torch.ops.delta, "
            "nnstreamer_tpu_torch.elements.sparse, "
            "nnstreamer_tpu_torch.elements.delta, "
            "nnstreamer_tpu_torch.edge.wire, "
            "nnstreamer_tpu_torch.edge.broker, "
            "nnstreamer_tpu_torch.native.lib, "
            "nnstreamer_tpu_torch.pipeline.basic, "
            "nnstreamer_tpu_torch.serve.batcher, "
            "nnstreamer_tpu_torch.serve.scheduler, "
            "nnstreamer_tpu_torch.serve.elements, "
            "nnstreamer_tpu_torch.serve.router; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'ml_dtypes', "
            "'nnstreamer_tpu')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)
    import re
    pattern = re.compile(r"^\s*(from|import)\s+(jax|flax|optax|"
                         r"nnstreamer_tpu)(\.|\s|$)", re.M)
    sources = [os.path.join(ROOT, "chip_smoke.py")] + [
        os.path.join(d, f) for d, _, files in os.walk(
            os.path.join(ROOT, "nnstreamer_tpu_torch"))
        for f in files if f.endswith(".py")]
    bad = [p for p in sources if pattern.search(open(p).read())]
    assert not bad, bad
