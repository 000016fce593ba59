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
    "invoke-dynamic=true", "donate-input=true", "breaker-threshold=3",
    "suspend=100", "invoke-async=true", "on-error=skip",
    "custom=mesh:2x1x1"])
def test_unported_filter_properties_raise_at_start(prop):
    pipe = pt.parse_launch(
        f"tensortestsrc caps={CAPS} num-buffers=1 ! tensor_filter "
        f"framework=torch-cuda accelerator=true:cpu model=zoo://vit {prop} "
        "! appsink")
    with pytest.raises(pt.NotPortedError, match=prop.split("=")[0]):
        pipe.start()


def test_fusion_request_is_refused_and_opt_out_accepted():
    """Fusion is ported: a leading ``fuse=true`` is accepted as the
    default it is, and ``fuse=false`` is the opt-out, as in the JAX
    package's parser."""
    pipe = pt.parse_launch(f"fuse=true tensortestsrc caps={CAPS} ! fakesink")
    assert pipe.fuse is True and nt.parse_launch(
        f"fuse=true tensortestsrc caps={CAPS} ! fakesink").fuse is True
    pipe = pt.parse_launch(
        f"fuse=false tensortestsrc caps={CAPS} num-buffers=2 ! queue "
        "! appsink name=out")
    assert pipe.fuse is False
    pipe.run(timeout=30)
    assert len(pipe["out"].buffers) == 2
    assert pipe._fusion_plan is None


# -- the MobileNet-v2 headline line (bench.py's bench_mobilenet) -----------

MN_CAPS = ("other/tensors,format=static,num_tensors=1,types=(string)uint8,"
           "dimensions=(string)3:96:96,framerate=(fraction)0/1")
MN_FRAMES = 6

MN_JAX_PY = '''
import numpy as np
from nnstreamer_tpu.models import zoo


def get_model():
    apply_fn, _, in_info, out_info = zoo.build(
        "mobilenet_v2", width="0.35", size="96")
    flat = np.load({npz!r})
    tree = {{}}
    for key in flat.files:
        *path, leaf = key.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {{}})
        node[leaf] = flat[key]
    return apply_fn, tree, in_info, out_info
'''

MN_PORT_PY = '''
import numpy as np
from nnstreamer_tpu_torch.models.convert import mobilenet_params_from_jax
from nnstreamer_tpu_torch.models.mobilenet import MobileNetV2, make_apply
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
    model = MobileNetV2(num_classes=1001, width=0.35)
    model.load_state_dict(mobilenet_params_from_jax(tree))
    return (make_apply(False), model, TensorsInfo.make("uint8", "3:96:96"),
            TensorsInfo.make("float32", "1001"))
'''


@pytest.fixture(scope="module")
def mobilenet_models(tmp_path_factory):
    """One set of MobileNet-v2 variables (width 0.35, 96x96, BatchNorm
    statistics drawn from a numpy seed) served to both packages through
    model files; and a 1001-line labels file."""
    tmp = tmp_path_factory.mktemp("mobilenet")
    _, variables, _, _ = jax_zoo.build("mobilenet_v2", width="0.35",
                                       size="96")
    rng = np.random.default_rng(21)
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            jax.device_get(variables))[0]:
        key = "/".join(str(k.key) for k in path)
        leaf = np.asarray(leaf)
        if key.endswith("/mean"):
            leaf = rng.normal(0.0, 0.5, leaf.shape).astype(np.float32)
        elif key.endswith("/var"):
            leaf = rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)
        flat[key] = leaf
    npz = tmp / "mobilenet.npz"
    np.savez(npz, **flat)
    jax_py, port_py = tmp / "mobilenet_jax.py", tmp / "mobilenet_port.py"
    jax_py.write_text(MN_JAX_PY.format(npz=str(npz)))
    port_py.write_text(MN_PORT_PY.format(npz=str(npz)))
    labels = tmp / "labels1001.txt"
    labels.write_text("\n".join(f"class{i}" for i in range(1001)))
    return str(jax_py), str(port_py), str(labels)


def _mobilenet_lines(models, tail):
    """bench.py's headline line, at width 0.35 and 96x96, in both
    packages: prefetch-host=true, queues of 8 and 32."""
    jax_py, port_py, _ = models
    src = (f"tensortestsrc caps={MN_CAPS} pattern=random seed={SEED} "
           f"num-buffers={MN_FRAMES} ! queue max-size-buffers=8")
    filt = "latency=1 prefetch-host=true ! queue max-size-buffers=32"
    return (f"{src} ! tensor_filter name=f framework=jax model={jax_py} "
            f"{filt} {tail}",
            f"{src} ! tensor_filter name=f framework=torch-cuda "
            f"accelerator=true:cpu model={port_py} {filt} {tail}")


def test_mobilenet_headline_line_matches_jax(mobilenet_models):
    jax_line, port_line = _mobilenet_lines(mobilenet_models,
                                           "! appsink name=out")
    jpipe, ppipe = _run(nt, jax_line), _run(pt, port_line)
    want = np.stack([b.chunks[0].host() for b in jpipe["out"].buffers])
    got = np.stack([b.chunks[0].host() for b in ppipe["out"].buffers])
    assert got.shape == want.shape == (MN_FRAMES, 1001)
    assert got.dtype == np.float32
    # bf16 bound of tests/test_torch_mobilenet.py
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert str(ppipe["f"].srcpad.caps) == str(jpipe["f"].srcpad.caps)
    assert ppipe["f"].latency_us > 0


def test_mobilenet_golden_labels_match_jax(mobilenet_models):
    labels = mobilenet_models[2]
    jax_line, port_line = _mobilenet_lines(
        mobilenet_models, f"! tensor_decoder mode=image_labeling "
        f"option1={labels} ! appsink name=out")
    want = _run(nt, jax_line)["out"].buffers
    got = _run(pt, port_line)["out"].buffers
    assert len(got) == len(want) == MN_FRAMES
    assert [b.extras["label"] for b in got] == \
        [b.extras["label"] for b in want]
    assert [b.pts for b in got] == [b.pts for b in want]


def test_mobilenet_batched_top1_line_on_cpu():
    """The batched sibling (4 frames a buffer) with top1=1: [4, 1] int32
    ids a buffer, equal to the argmax of the logits line's output."""
    caps = MN_CAPS.replace("3:96:96", "3:96:96:4")
    line = (f"tensortestsrc caps={caps} pattern=random seed={SEED} "
            "num-buffers=2 ! queue max-size-buffers=4 ! tensor_filter "
            "framework=torch-cuda accelerator=true:cpu "
            'model="zoo://mobilenet_v2?width=0.35&size=96{}" '
            "prefetch-host=true ! queue max-size-buffers=8 "
            "! appsink name=out")
    logits = _run(pt, line.format(""))["out"].buffers
    top1 = _run(pt, line.format("&top1=1"))["out"].buffers
    for lg, t1 in zip(logits, top1):
        ids = t1.chunks[0].host()
        assert ids.shape == (4, 1) and ids.dtype == np.int32
        np.testing.assert_array_equal(ids[:, 0],
                                      lg.chunks[0].host().argmax(-1))


# -- the SSD, PoseNet and DeepLab lines (bench.py's bench_ssd,
# bench_posenet, bench_deeplab) and the video front end ------------------
#
# Width 0.35 at small sizes, one set of JAX variables (BatchNorm
# statistics drawn from a numpy seed) served to both packages through
# model files, as for MobileNet above. The tolerances are those of
# tests/test_torch_detection.py and are stated there.

DET_FRAMES = 4
SCORE_ATOL = 2.0 ** -7
BOX_ATOL = 2.0 ** -5
BF16_ATOL = 2e-2

DET_JAX_PY = '''
import numpy as np
from nnstreamer_tpu.models import zoo


def get_model():
    apply_fn, _, in_info, out_info = zoo.build({name!r}, **{kw!r})
    flat = np.load({npz!r})
    tree = {{}}
    for key in flat.files:
        *path, leaf = key.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {{}})
        node[leaf] = flat[key]
    return apply_fn, tree, in_info, out_info
'''

DET_PORT_PY = '''
import numpy as np
from nnstreamer_tpu_torch.models import convert, zoo


def get_model():
    apply_fn, module, in_info, out_info = zoo.build({name!r}, **{kw!r})
    flat = np.load({npz!r})
    tree = {{}}
    for key in flat.files:
        *path, leaf = key.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {{}})
        node[leaf] = flat[key]
    module.load_state_dict(getattr(convert, {conv!r})(tree))
    return apply_fn, module, in_info, out_info
'''


def _det_variables(name, kw, seed):
    """The JAX zoo model's variables, flattened to ``a/b/c`` keys, with
    BatchNorm statistics and biases drawn from a numpy seed."""
    _, variables, _, _ = jax_zoo.build(name, **kw)
    rng = np.random.default_rng(seed)
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            jax.device_get(variables))[0]:
        key = "/".join(str(k.key) for k in path)
        leaf = np.asarray(leaf)
        if key.endswith("/mean"):
            leaf = rng.normal(0.0, 0.5, leaf.shape).astype(np.float32)
        elif key.endswith("/var"):
            leaf = rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)
        elif key.endswith("/bias"):
            leaf = rng.normal(0.0, 0.1, leaf.shape).astype(np.float32)
        flat[key] = leaf
    return flat


def _det_models(tmp, name, kw, conv, seed):
    """(JAX model file, port model file, the variables) for ``name``."""
    flat = _det_variables(name, kw, seed)
    npz = tmp / f"{name}.npz"
    np.savez(npz, **flat)
    files = []
    for side, text in (("jax", DET_JAX_PY), ("port", DET_PORT_PY)):
        path = tmp / f"{name}_{side}.py"
        path.write_text(text.format(name=name, kw=kw, npz=str(npz),
                                    conv=conv))
        files.append(str(path))
    tree = {}
    for key, leaf in flat.items():
        *path, last = key.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[last] = leaf
    return files[0], files[1], tree


def _bench_lines(jax_py, port_py, size, filter_opts, tail, src=None):
    """A bench.py detection line in both packages: queues of 8 and 32
    around the filter, prefetch-host=true."""
    src = src or (f"tensortestsrc caps={MN_CAPS.replace('96:96', f'{size}:{size}')} "
                  f"pattern=random seed={SEED} num-buffers={DET_FRAMES}")
    filt = f"{filter_opts} prefetch-host=true ! queue max-size-buffers=32"
    return (f"{src} ! queue max-size-buffers=8 ! tensor_filter name=f "
            f"framework=jax model={jax_py} {filt} {tail}",
            f"{src} ! queue max-size-buffers=8 ! tensor_filter name=f "
            f"framework=torch-cuda accelerator=true:cpu model={port_py} "
            f"{filt} {tail}")


def _testsrc_frames(size, n=DET_FRAMES):
    rng = np.random.default_rng(SEED)
    return np.stack([rng.integers(0, 255, (size, size, 3), np.uint8,
                                  endpoint=True) for _ in range(n)])


def _quad_of(boxes):
    """A bounding_boxes decoder's ``boxes`` extras -> (boxes as ymin,
    xmin, ymax, xmax; classes; scores), in rank order."""
    return (np.array([[b["y"], b["x"], b["y"] + b["h"], b["x"] + b["w"]]
                      for b in boxes], np.float32).reshape(-1, 4),
            np.array([b["class"] for b in boxes]),
            np.array([b["score"] for b in boxes], np.float32))


def test_ssd_line_matches_jax(tmp_path):
    """bench_ssd's line (packed=1, the mobilenet-ssd-postprocess
    decoder) at width 0.35, 96x96, topk 10: scores rank by rank within
    2**-7, and each detection of the port matched by a JAX detection of
    the same class and box whose score lies within 2**-7 of its own."""
    kw = dict(width="0.35", size="96", topk="10", packed="1")
    jax_py, port_py, _ = _det_models(tmp_path, "ssd_mobilenet_v2", kw,
                                     "ssd_params_from_jax", 61)
    jax_line, port_line = _bench_lines(
        jax_py, port_py, 96, "latency=1",
        "! tensor_decoder mode=bounding_boxes "
        "option1=mobilenet-ssd-postprocess option4=96:96 option5=96:96 "
        "! appsink name=out")
    jpipe, ppipe = _run(nt, jax_line), _run(pt, port_line)
    want, got = jpipe["out"].buffers, ppipe["out"].buffers
    assert len(got) == len(want) == DET_FRAMES
    matched = 0
    for g, w in zip(got, want):
        assert g.chunks[0].shape == w.chunks[0].shape == (96, 96, 4)
        gb, gc, gs = _quad_of(g.extras["boxes"])
        wb, wc, ws = _quad_of(w.extras["boxes"])
        assert len(gs) == len(ws) == 10
        np.testing.assert_allclose(gs, ws, rtol=0, atol=SCORE_ATOL)
        for i in np.nonzero(gs > ws[-1] + SCORE_ATOL)[0]:
            near = np.abs(ws - gs[i]) <= SCORE_ATOL
            same = near & (wc == gc[i]) & (
                np.abs(wb - gb[i]).max(axis=1) <= BOX_ATOL)
            assert same.any(), (i, g.extras["boxes"][i])
            matched += 1
    assert matched >= DET_FRAMES * 5
    assert str(ppipe["f"].srcpad.caps) == str(jpipe["f"].srcpad.caps)


def test_posenet_line_matches_jax(tmp_path):
    """bench_posenet's line (decode=device, pose_estimation) at width
    0.35, 129x129: keypoint scores within 2e-2; positions equal for
    every keypoint whose top-2 JAX heatmap gap exceeds 2e-2, and every
    position the port picks within 2 x 2e-2 of the JAX heatmap's
    maximum (both heatmaps agree within 2e-2)."""
    from nnstreamer_tpu.models.detection import PoseNet as JaxPoseNet
    kw = dict(width="0.35", size="129", decode="device")
    jax_py, port_py, tree = _det_models(tmp_path, "posenet", kw,
                                        "posenet_params_from_jax", 62)
    jax_line, port_line = _bench_lines(
        jax_py, port_py, 129, "",
        "! tensor_decoder mode=pose_estimation option1=129:129 "
        "option2=129:129 ! appsink name=out")
    want = _run(nt, jax_line)["out"].buffers
    got = _run(pt, port_line)["out"].buffers
    assert len(got) == len(want) == DET_FRAMES
    frames = _testsrc_frames(129)
    hm = np.asarray(JaxPoseNet(keypoints=17, width=0.35).apply(
        tree, jax.numpy.asarray(frames).astype(jax.numpy.bfloat16)
        / 127.5 - 1.0)).reshape(DET_FRAMES, -1, 17)
    top2 = np.sort(hm, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > BF16_ATOL
    assert clear.any()
    for i, (g, w) in enumerate(zip(got, want)):
        gk, wk = np.array(g.extras["keypoints"]), np.array(w.extras["keypoints"])
        assert gk.shape == wk.shape == (17, 3)
        np.testing.assert_allclose(gk[:, 2], wk[:, 2], rtol=0, atol=BF16_ATOL)
        np.testing.assert_array_equal(gk[clear[i], :2], wk[clear[i], :2])
        cell = np.rint(gk[:, 1] * 8).astype(int) * 9 + np.rint(
            gk[:, 0] * 8).astype(int)  # the 9x9 heatmap's row-major cell
        picked = hm[i][cell, np.arange(17)]
        assert (picked >= hm[i].max(axis=0) - 2 * BF16_ATOL).all()
        assert g.chunks[0].shape == (129, 129, 4)


def test_video_deeplab_segment_line_matches_jax(tmp_path):
    """videotestsrc ! tensor_converter ! tensor_filter (deeplab_v3,
    argmax=u8) ! tensor_decoder mode=image_segment ! appsink, at width
    0.35 and 65x65: class maps equal on >= 99 % of pixels and on every
    pixel whose top-2 JAX logit gap exceeds 2e-2."""
    from nnstreamer_tpu.models.detection import DeepLabV3 as JaxDeepLab
    kw = dict(width="0.35", size="65", argmax="u8")
    jax_py, port_py, tree = _det_models(tmp_path, "deeplab_v3", kw,
                                        "deeplab_params_from_jax", 63)
    src = ("videotestsrc pattern=random seed=4 num-buffers=3 "
           'caps="video/x-raw,format=RGB,width=65,height=65,'
           'framerate=30/1" ! tensor_converter')
    tail = ("! tensor_decoder mode=image_segment option1=tflite-deeplab "
            "! appsink name=out")
    # unfused in both packages: the fused decode leaves out the class map
    jpipe = _run(nt, f"fuse=false {src} ! tensor_filter framework=jax "
                     f"model={jax_py} {tail}")
    want = jpipe["out"].buffers
    ppipe = _run(pt, f"fuse=false {src} ! tensor_filter "
                     f"framework=torch-cuda accelerator=true:cpu "
                     f"model={port_py} {tail}")
    got = ppipe["out"].buffers
    assert len(got) == len(want) == 3
    rng = np.random.default_rng(4)  # videotestsrc's frames
    frames = np.stack([rng.integers(0, 256, (65, 65, 3), np.uint8)
                       for _ in range(3)])
    logits = np.asarray(JaxDeepLab(num_classes=21, width=0.35,
                                   out_size=65).apply(
        tree, jax.numpy.asarray(frames).astype(jax.numpy.bfloat16)
        / 127.5 - 1.0))
    top2 = np.sort(logits, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > BF16_ATOL
    for i, (g, w) in enumerate(zip(got, want)):
        gm, wm = g.extras["class_map"], w.extras["class_map"]
        # the frames re-made right: the JAX line's map is these logits'
        assert (wm == logits[i].argmax(-1)).mean() >= 0.99
        assert gm.shape == (65, 65) and (gm == wm).mean() >= 0.99
        np.testing.assert_array_equal(gm[clear[i]], wm[clear[i]])
        assert g.chunks[0].shape == w.chunks[0].shape == (65, 65, 4)
        assert (g.pts, g.duration) == (w.pts, w.duration)
    assert str(ppipe["out"].sinkpad.caps) == str(jpipe["out"].sinkpad.caps)


# -- slice 5: the filter's compiled execution (tests/test_filter.py's
# jax-backend cases, and the ViT line with an in-flight window) -----------

MLP_CAPS = ("other/tensors,format=static,num_tensors=1,types=(string)float32,"
            "dimensions=(string)64,framerate=(fraction)0/1")
# one bf16 ulp of an output in [1, 2): the two packages round the bf16
# products and sums at other points (observed at most 4e-4)
MLP_ATOL = 2.0 ** -7

MLP_PORT_PY = '''
import numpy as np
from nnstreamer_tpu_torch.models import convert, zoo


def get_model():
    apply_fn, module, in_info, out_info = zoo.build("mlp")
    flat = np.load({npz!r})
    module.load_state_dict(convert.mlp_params_from_jax(
        {{k: flat[k].astype(np.float32) for k in flat.files}}))
    return apply_fn, module, in_info, out_info
'''


@pytest.fixture(scope="module")
def mlp_model(tmp_path_factory):
    """A port model file serving the JAX zoo's mlp weights (bf16, stored
    as float32: exact)."""
    tmp = tmp_path_factory.mktemp("mlp")
    _, params, _, _ = jax_zoo.build("mlp")
    npz = tmp / "mlp.npz"
    np.savez(npz, **{k: np.asarray(v, dtype=np.float32)
                     for k, v in params.items()})
    path = tmp / "mlp.py"
    path.write_text(MLP_PORT_PY.format(npz=str(npz)))
    return str(path)


def test_zoo_mlp_line_matches_jax(mlp_model):
    """tensortestsrc ! tensor_filter (mlp) ! appsink: [10] float32 a
    frame, within bf16 rounding of the JAX line on the same weights."""
    src = (f"tensortestsrc caps={MLP_CAPS} num-buffers=3 pattern=random "
           f"seed={SEED}")
    want = _run(nt, f"{src} ! tensor_filter framework=jax model=zoo://mlp "
                    "! appsink name=out")["out"].buffers
    got = _run(pt, f"{src} ! tensor_filter framework=torch-cuda "
                   f"accelerator=true:cpu model={mlp_model} "
                   "! appsink name=out")["out"].buffers
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.chunks[0].shape == (10,)
        np.testing.assert_allclose(g.chunks[0].host(), w.chunks[0].host(),
                                   rtol=0, atol=MLP_ATOL)


def test_executable_cache_reused_as_jax():
    """One executable per input signature, counted as the JAX backend
    counts its jit cache: a second frame of the same signature reuses
    it, a batched one makes another."""
    from nnstreamer_tpu.filters.base import FilterProperties as JaxProps
    from nnstreamer_tpu.filters.jax_backend import JaxFilter
    from nnstreamer_tpu_torch.filters.base import FilterProperties
    from nnstreamer_tpu_torch.filters.base import Accelerator
    from nnstreamer_tpu_torch.filters.torch_cuda_backend import \
        TorchCudaFilter
    ours = TorchCudaFilter()
    ours.open(FilterProperties(framework="torch-cuda",
                               model_files=("zoo://mlp",),
                               accelerators=(Accelerator.CPU,)))
    theirs = JaxFilter()
    theirs.open(JaxProps(framework="jax", model_files=("zoo://mlp",)))
    x = np.random.default_rng(0).random(64).astype(np.float32)
    counts = []
    for inputs in ([x], [x * 2], [np.stack([x, x])]):
        ours.invoke(inputs)
        theirs.invoke(inputs)
        counts.append((ours.compile_count, len(ours._executables),
                       theirs.compile_count, len(theirs._jit_cache)))
    assert counts == [(1, 1, 1, 1), (1, 1, 1, 1), (2, 2, 2, 2)]
    ours.close()
    theirs.close()


def test_warmup_compiles_before_first_frame():
    """warmup=true: the negotiated signature is invoked once with zeros
    at caps time, so the first streamed frame reuses the executable and
    no frame counts a recompile."""
    import threading
    import time

    capsq = f'"{MLP_CAPS}"'
    pipe = pt.parse_launch(
        f"appsrc name=in caps={capsq} ! tensor_filter name=f "
        "framework=torch-cuda accelerator=true:cpu model=zoo://mlp "
        "warmup=true ! appsink name=out")
    got, done = [], threading.Event()
    pipe["out"].connect(lambda b: (got.append(b), done.set()))
    pipe.start()
    f = pipe["f"]
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        if f.fw is not None and f.fw.compile_count == 1:
            break
        time.sleep(0.02)
    assert f.fw.compile_count == 1
    pipe["in"].push_buffer(pt.Buffer.from_arrays([np.zeros(64, np.float32)]))
    assert done.wait(30)
    compiled = f.fw.compile_count
    pipe["in"].end_stream()
    pipe.stop()
    assert len(got) == 1 and compiled == 1
    assert f.stats.get("jit_recompiles", 0) == 0


def test_vit_in_flight_labels_match_jax(port_model):
    """The reduced ViT line behind a queue with in-flight=4 in both
    packages: identical labels, in PTS order."""
    model, labels = port_model
    src = (f"tensortestsrc caps={CAPS} pattern=random seed={SEED} "
           "num-buffers=8 ! queue max-size-buffers=4")
    tail = (f"in-flight=4 ! tensor_decoder mode=image_labeling "
            f"option1={labels} ! appsink name=out")
    want = _run(nt, f'{src} ! tensor_filter name=f framework=jax '
                    f'model="{JAX_MODEL}" {tail}')
    got = _run(pt, f"{src} ! tensor_filter name=f framework=torch-cuda "
                   f"accelerator=true:cpu model={model} {tail}")
    wb, gb = want["out"].buffers, got["out"].buffers
    assert len(gb) == len(wb) == 8
    assert [b.extras["label"] for b in gb] == [b.extras["label"] for b in wb]
    assert [b.pts for b in gb] == [b.pts for b in wb] == sorted(
        b.pts for b in gb)
    rep = got["f"].transfer_report()
    assert rep["window"] == 4 and rep["completed"] == 8


# -- tee and identity (slice 6) ------------------------------------------

CAPS_U8_4 = ("other/tensors,format=static,num_tensors=1,types=uint8,"
             "dimensions=4:4,framerate=0/1")


def _host_frames(sink):
    return [(b.pts, np.ascontiguousarray(b.chunks[0].host()).tobytes())
            for b in sink.buffers]


def test_tee_fanout():
    """tests/test_pipeline.py's tee case in both packages: every frame on
    both branches, bytes and PTS equal to the JAX line's; the port's
    branches share one buffer's chunks (no copy)."""
    line = (f"tensortestsrc caps={CAPS_U8_4} num-buffers=4 pattern=random "
            "! tee name=t t. ! queue ! appsink name=a "
            "t. ! queue ! identity ! appsink name=b")
    want, got = _run(nt, line), _run(pt, line)
    for sink in ("a", "b"):
        assert len(got[sink].buffers) == 4
        assert _host_frames(got[sink]) == _host_frames(want[sink])
    assert all(x.chunks[0] is y.chunks[0] for x, y in
               zip(got["a"].buffers, got["b"].buffers))


def test_tee_rereference_adds_branch():
    """``t.`` re-references the tee: each branch takes the next request
    pad, in both packages."""
    line = (f"tensortestsrc caps={CAPS_U8_4} num-buffers=1 ! tee name=t "
            "! queue name=q1 ! fakesink t. ! queue name=q2 ! fakesink")
    for pkg in (nt, pt):
        t = pkg.parse_launch(line)["t"]
        assert set(t.src_pads) == {"src_0", "src_1"}
        assert t.src_pads["src_0"].peer.element.name == "q1"
        assert t.src_pads["src_1"].peer.element.name == "q2"


def test_named_pad_targets_specific_leg():
    for pkg in (nt, pt):
        p = pkg.parse_launch(
            "tensor_mux name=m ! appsink name=out "
            f"tensortestsrc name=s1 caps={CAPS_U8_4} ! m.sink_1")
        assert p["m"].sink_pads["sink_1"].peer.element.name == "s1"
