"""The port's ViT labeling pipeline end to end against the JAX package's.

Both packages run the same launch line,

    tensortestsrc caps=<uint8 3:64:64> pattern=random seed=S num-buffers=4
      ! tensor_filter ... ! tensor_decoder mode=image_labeling ! appsink

with ``framework=jax model=zoo://vit?...`` on the JAX side and
``framework=torch-cuda accelerator=true:cpu model=<tmp>/model.py`` on the
port's. The port's model file loads the JAX model's own weights from an
``.npz`` the test writes, through models/convert.py.

Checks: frames byte-identical, labels identical per frame, logits within
the bf16 tolerance of tests/test_torch_vit.py (3e-2 absolute, argmax
equal) from a run without the decoder, and caps/TensorsInfo strings
printed identically.
"""
import jax
import numpy as np
import pytest
import torch

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as pt
from nnstreamer_tpu.models import zoo as jax_zoo
from nnstreamer_tpu_torch.ops import attention

CAPS = ("other/tensors,format=static,num_tensors=1,types=(string)uint8,"
        "dimensions=(string)3:64:64,framerate=(fraction)0/1")
VIT = dict(size="64", d_model="64", layers="2", heads="4", classes="10",
           attn="pallas")
JAX_MODEL = "zoo://vit?" + "&".join(f"{k}={v}" for k, v in VIT.items())
SEED = 5
BF16_ATOL = 3e-2


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two torch threads: tier-1 runs six test workers on shared cores,
    and timing-sensitive tests in the other workers must not starve."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

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


@pytest.fixture(scope="module")
def port_model(tmp_path_factory):
    """<tmp>/model.py serving the JAX zoo model's weights to the port."""
    tmp = tmp_path_factory.mktemp("vit")
    _, params, _, _ = jax_zoo.build("vit", **VIT)
    flat = {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                jax.device_get(params))[0]}
    npz = tmp / "vit.npz"
    np.savez(npz, **flat)
    model = tmp / "model.py"
    model.write_text(MODEL_PY.format(npz=str(npz)))
    labels = tmp / "labels.txt"
    labels.write_text("\n".join(f"class{i}" for i in range(10)))
    return str(model), str(labels)


def _run(pkg, line):
    pipe = pkg.parse_launch(line)
    pipe.run(timeout=300)
    return pipe


def _lines(port_model, tail):
    model, _ = port_model
    src = (f"tensortestsrc caps={CAPS} pattern=random seed={SEED} "
           "num-buffers=4")
    jax_line = (f'{src} ! tensor_filter name=f framework=jax '
                f'model="{JAX_MODEL}" {tail}')
    port_line = (f"{src} ! tensor_filter name=f framework=torch-cuda "
                 f"accelerator=true:cpu model={model} {tail}")
    return jax_line, port_line


def test_frames_are_byte_identical():
    line = (f"tensortestsrc caps={CAPS} pattern=random seed={SEED} "
            "num-buffers=4 ! appsink name=out")
    want = [b.chunks[0].host() for b in _run(nt, line)["out"].buffers]
    got = [b.chunks[0].host() for b in _run(pt, line)["out"].buffers]
    assert len(got) == len(want) == 4
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and g.shape == w.shape == (64, 64, 3)
        assert g.tobytes() == w.tobytes()


def test_labels_match_jax_pipeline(port_model):
    _, labels = port_model
    tail = (f"! tensor_decoder mode=image_labeling option1={labels} "
            "! appsink name=out")
    jax_line, port_line = _lines(port_model, tail)
    want = _run(nt, jax_line)["out"].buffers
    got = _run(pt, port_line)["out"].buffers
    assert len(got) == len(want) == 4
    assert [b.extras["label"] for b in got] == \
        [b.extras["label"] for b in want]
    assert [b.pts for b in got] == [b.pts for b in want]
    assert all(b.extras["label"].startswith("class") for b in got)


def test_logits_match_jax_pipeline(port_model):
    jax_line, port_line = _lines(port_model, "! appsink name=out")
    jpipe = _run(nt, jax_line)
    attention.launches = 0
    ppipe = _run(pt, port_line)
    assert attention.launches == 0  # the CPU run takes the plain version
    want = np.stack([b.chunks[0].host() for b in jpipe["out"].buffers])
    got = np.stack([b.chunks[0].host() for b in ppipe["out"].buffers])
    assert got.shape == want.shape == (4, 10) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ATOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    # the negotiated caps print identically in both packages
    assert str(ppipe["f"].srcpad.caps) == str(jpipe["f"].srcpad.caps)
    assert str(ppipe["out"].sinkpad.caps) == str(jpipe["out"].sinkpad.caps)
    assert ppipe["f"].stats["buffers"] == 4


@pytest.mark.parametrize("caps", [
    CAPS,
    "other/tensors,format=static,num_tensors=2,types=(string)\"float32,"
    "bfloat16\",dimensions=(string)\"10:1,3:224:224:1\",framerate=30/1",
    "other/tensors,format=flexible,framerate=(fraction)[ 0/1, 2147483647/1 ]",
    "text/x-raw,format=utf8",
])
def test_caps_strings_print_identically(caps):
    assert str(pt.Caps(caps)) == str(nt.Caps(caps))
    if caps.startswith("other/tensors,format=static"):
        want = nt.Caps(caps).to_config()
        got = pt.Caps(caps).to_config()
        assert str(got.info) == str(want.info)
        assert repr(got.info) == repr(want.info)


@pytest.mark.parametrize("types,dims", [
    ("uint8", "3:224:224"), ("float32,int16", "10:1,4:4:2"),
    ("bfloat16", "64:196:1:1"),
])
def test_tensors_info_strings_print_identically(types, dims):
    want = nt.TensorsInfo.make(types, dims)
    got = pt.TensorsInfo.make(types, dims)
    assert str(got) == str(want) and repr(got) == repr(want)
    assert [i.shape for i in got] == [i.shape for i in want]
    assert [i.size_bytes for i in got] == [i.size_bytes for i in want]


def test_card_requested_without_cuda_raises(port_model, monkeypatch):
    """The default accelerator is the card; without CUDA the filter raises
    at start instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model, _ = port_model
    pipe = pt.parse_launch(
        f"tensortestsrc caps={CAPS} num-buffers=1 ! tensor_filter "
        f"framework=torch-cuda model={model} ! appsink")
    with pytest.raises(RuntimeError, match="CUDA"):
        pipe.start()
    pipe.stop()


def test_auto_framework_resolves_zoo_to_torch_cuda():
    pipe = pt.parse_launch(
        f"tensortestsrc caps={CAPS} num-buffers=2 ! tensor_filter name=f "
        'accelerator=true:cpu model="zoo://vit?size=64&d_model=64&layers=1'
        '&heads=4&classes=10&attn=pallas" ! appsink name=out')
    pipe.start()
    try:
        assert pipe.wait_eos(120)
        assert pipe["f"].fw.NAME == "torch-cuda"
    finally:
        pipe.stop()
    assert len(pipe["out"].buffers) == 2
    out = pipe["out"].buffers[0].chunks[0]
    assert out.shape == (10,) and str(out.type) == "float32"


@pytest.mark.parametrize("prop", [
    "in-flight=2", "prefetch-host=true", "breaker-threshold=3",
    "warmup=true", "invoke-async=true", "on-error=skip",
    "custom=mesh:2x1x1"])
def test_unported_filter_properties_raise_at_start(prop):
    pipe = pt.parse_launch(
        f"tensortestsrc caps={CAPS} num-buffers=1 ! tensor_filter "
        f"framework=torch-cuda accelerator=true:cpu model=zoo://vit {prop} "
        "! appsink")
    with pytest.raises(pt.NotPortedError, match=prop.split("=")[0]):
        pipe.start()


def test_fusion_request_is_refused_and_opt_out_accepted():
    with pytest.raises(ValueError, match="fusion"):
        pt.parse_launch(f"fuse=true tensortestsrc caps={CAPS} ! fakesink")
    pipe = pt.parse_launch(
        f"fuse=false tensortestsrc caps={CAPS} num-buffers=2 ! queue "
        "! appsink name=out")
    pipe.run(timeout=30)
    assert len(pipe["out"].buffers) == 2
