"""nnstreamer_tpu_torch/models/detection.py against the JAX package's
SSD-MobileNet-v2, PoseNet and DeepLab-v3, with the JAX models' variables
carried over by models/convert.py.

Width 0.35; SSD at 96x96 (topk 10), PoseNet at 129x129, DeepLab at
65x65. As in tests/test_torch_mobilenet.py, the JAX variables' BatchNorm
statistics, scales and biases (conv biases included) are redrawn from a
numpy seed before converting, so a swapped or dropped leaf shows.

Tolerances:
  * bf16 conv outputs (the SSD head's ``Conv_0``/``Conv_1``): 2**-5
    absolute plus 2**-7 relative. Both sides round every conv and
    BatchNorm output to bf16. A rounding on the other side of a tie
    moves a feature the head convolves by one bf16 ulp, 2**-5 for a
    relu6 feature in [4, 6], and moves the head's own output by one ulp,
    2**-7 of its magnitude at most (observed: 0.017 on an output of
    0.04, 2**-5 on outputs in [4, 8)).
  * SSD scores: sigmoid of those conv outputs, so 2**-7 (sigmoid's slope
    is at most 1/4, and under 0.02 where the relative term is large).
    End to end, the sorted top-k scores are compared within it, and
    boxes (2**-5: tanh's slope is at most 1, times e·2/h for the box
    size) and classes (exactly) at every rank whose score is more than
    2**-7 from both neighbours: closer ranks may swap between two bf16
    roundings.
  * SSD postprocess fed the JAX head's own conv outputs: the same
    indices and classes, boxes and scores within 1e-6 (f32 transcendental
    functions of two libraries).
  * PoseNet heatmaps and DeepLab logits: 2e-2 absolute, the bf16 bound of
    tests/test_torch_mobilenet.py (observed ~1e-2 after 50 bf16 layers).
  * DeepLab class maps: equal on >= 99 % of pixels, and on every pixel
    whose top-2 JAX logit gap exceeds 2e-2.
  * the bilinear resize alone: 1e-6 (f32, other summation order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnstreamer_tpu.decoders.registry import find_decoder as jax_find_decoder
from nnstreamer_tpu.models import detection as jdet
from nnstreamer_tpu.models import zoo as jax_zoo
from nnstreamer_tpu.tensors.buffer import Buffer as JBuffer, Chunk as JChunk
from nnstreamer_tpu_torch.decoders.registry import find_decoder
from nnstreamer_tpu_torch.models import detection as D
from nnstreamer_tpu_torch.models import zoo
from nnstreamer_tpu_torch.models.convert import (deeplab_params_from_jax,
                                                 posenet_params_from_jax,
                                                 ssd_params_from_jax)
from nnstreamer_tpu_torch.tensors.buffer import Buffer, Chunk

WIDTH = 0.35
CONV_ATOL = 2.0 ** -5
CONV_RTOL = 2.0 ** -7
SCORE_ATOL = 2.0 ** -7
BOX_ATOL = 2.0 ** -5
POST_ATOL = 1e-6
BF16_ATOL = 2e-2
SSD = dict(size=96, topk=10, classes=91)
POSE_SIZE = 129
SEG_SIZE = 65


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two torch threads: tier-1 runs six test workers on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _perturb(tree, rng):
    out = {}
    for key, leaf in tree.items():
        if isinstance(leaf, dict):
            out[key] = _perturb(leaf, rng)
            continue
        shape = np.shape(leaf)
        if key == "mean":
            leaf = rng.normal(0.0, 0.5, shape)
        elif key == "var":
            leaf = rng.uniform(0.5, 2.0, shape)
        elif key == "scale":
            leaf = rng.uniform(0.5, 1.5, shape)
        elif key == "bias":
            leaf = rng.normal(0.0, 0.1, shape)
        out[key] = np.asarray(leaf, np.float32)
    return out


def _variables(name, seed, **kw):
    _, variables, _, _ = jax_zoo.build(name, width=str(WIDTH),
                                       **{k: str(v) for k, v in kw.items()})
    tree = jax.tree.map(np.asarray, jax.device_get(variables))
    return _perturb(tree, np.random.default_rng(seed))


def _frames(n, size, seed):
    return np.random.default_rng(seed).integers(
        0, 255, (n, size, size, 3), np.uint8, endpoint=True)


def _jax_input(frames):
    return jnp.asarray(frames).astype(jnp.bfloat16) / 127.5 - 1.0


def _port(module, sd):
    module.load_state_dict(sd)  # strict: every key maps
    return module.eval()


# -- SSD-MobileNet-v2 -----------------------------------------------------

@pytest.fixture(scope="module")
def ssd():
    variables = _variables("ssd_mobilenet_v2", 31, size=SSD["size"],
                           topk=SSD["topk"])
    model = _port(D.SSDMobileNetV2(SSD["classes"], WIDTH),
                  ssd_params_from_jax(variables))
    jmodel = jdet.SSDMobileNetV2(num_classes=SSD["classes"], width=WIDTH,
                                 topk=SSD["topk"])
    frames = _frames(3, SSD["size"], 32)
    quads, heads = [], []
    for f in frames:  # the JAX head flattens its batch: one frame a call
        quad, state = jmodel.apply(variables, _jax_input(f[None]),
                                   capture_intermediates=True,
                                   mutable=["intermediates"])
        inter = state["intermediates"]["SSDHead_0"]
        heads.append([np.asarray(inter[c]["__call__"][0].astype(jnp.float32))
                      for c in ("Conv_0", "Conv_1")])
        quads.append([np.asarray(q) for q in quad])
    return variables, model, frames, quads, heads


def _nchw_bf16(a):
    """A JAX NHWC head output -> the port's NCHW bf16 tensor (exact)."""
    return torch.tensor(a).permute(0, 3, 1, 2).to(torch.bfloat16)


def test_ssd_head_convs_match_jax(ssd):
    _, model, frames, _, heads = ssd
    with torch.inference_mode():
        x = torch.from_numpy(frames).to(torch.bfloat16) / 127.5 - 1.0
        cls, box = model(x)
    for i, (jcls, jbox) in enumerate(heads):
        for got, want in ((cls[i:i + 1], jcls), (box[i:i + 1], jbox)):
            assert got.dtype == torch.bfloat16
            got = got.float().permute(0, 2, 3, 1).numpy()
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=CONV_RTOL,
                                       atol=CONV_ATOL)


def test_ssd_postprocess_on_jax_head_outputs_matches_jax(ssd):
    """The port's postprocess on the JAX head's own conv outputs gives
    the JAX quad: the same cells (lax.top_k's order) and classes."""
    _, _, _, quads, heads = ssd
    for (jcls, jbox), want in zip(heads, quads):
        cls, box = _nchw_bf16(jcls), _nchw_bf16(jbox)
        boxes, classes, scores, count = (
            o[0].numpy() for o in D.ssd_postprocess(cls, box, SSD["topk"]))
        best = jax.nn.sigmoid(jnp.asarray(jcls)).reshape(-1, SSD["classes"])
        _, jidx = jax.lax.top_k(jnp.max(best, axis=1), SSD["topk"])
        got_idx = D.rank_cells(
            torch.sigmoid(cls.float()).permute(0, 2, 3, 1)
            .reshape(1, -1, SSD["classes"]).amax(-1), SSD["topk"])[0]
        np.testing.assert_array_equal(got_idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(classes, want[1])
        np.testing.assert_allclose(boxes, want[0], rtol=0, atol=POST_ATOL)
        np.testing.assert_allclose(scores, want[2], rtol=0, atol=POST_ATOL)
        np.testing.assert_array_equal(count, want[3])


@pytest.mark.parametrize("scores,want", [
    ([1.0, 5.0, 5.0, 2.0, 5.0], [1, 2, 4]),
    ([3.0, 3.0, 3.0, 3.0, 3.0], [0, 1, 2]),
    ([0.5, 0.25, 0.5, 0.25, 0.75], [4, 0, 2]),
])
def test_ssd_rank_takes_the_lower_index_on_ties(scores, want):
    """Built ties: the port's rank is lax.top_k's, lower index first
    (torch.topk makes no such promise)."""
    _, jidx = jax.lax.top_k(jnp.asarray(scores, jnp.float32), 3)
    assert np.asarray(jidx).tolist() == want
    got = D.rank_cells(torch.tensor([scores]), 3)[0]
    assert got.tolist() == want


def test_ssd_tied_cells_through_the_postprocess():
    """A head output whose best scores tie across cells (whole rows of
    equal bf16 values): boxes and classes in lax.top_k's cell order."""
    rng = np.random.default_rng(7)
    cls = np.round(rng.normal(0, 1, (1, 6, 6, 5)) * 2) / 2  # many ties
    box = rng.normal(0, 0.5, (1, 6, 6, 4))
    scores = jax.nn.sigmoid(jnp.asarray(cls, jnp.float32)).reshape(-1, 5)
    _, jidx = jax.lax.top_k(jnp.max(scores, axis=1), 8)
    _, classes, _, _ = D.ssd_postprocess(
        _nchw_bf16(cls.astype(np.float32)), _nchw_bf16(box.astype(np.float32)),
        8)
    want = np.asarray(jnp.argmax(scores, axis=1))[np.asarray(jidx)]
    np.testing.assert_array_equal(classes[0].numpy(), want)


def assert_quads_agree(got, want):
    """End-to-end SSD outputs. Scores: sorted, within SCORE_ATOL rank by
    rank. Cells: ranks whose scores lie within SCORE_ATOL may swap, so
    each of the port's detections must match, in class exactly and in
    box within BOX_ATOL, one of the JAX detections whose score is within
    SCORE_ATOL of its own; a detection within SCORE_ATOL of the JAX
    list's last score may come from a cell past the JAX top-k, and is
    left out. Returns how many detections were matched."""
    boxes, classes, scores, count = got
    np.testing.assert_allclose(scores, want[2], rtol=0, atol=SCORE_ATOL)
    np.testing.assert_array_equal(count, want[3])
    matched = 0
    for i in np.nonzero(scores > want[2][-1] + SCORE_ATOL)[0]:
        near = np.abs(want[2] - scores[i]) <= SCORE_ATOL
        same = near & (want[1] == classes[i]) & (
            np.abs(want[0] - boxes[i]).max(axis=1) <= BOX_ATOL)
        assert same.any(), (i, boxes[i], classes[i], scores[i])
        matched += 1
    return matched


def test_ssd_end_to_end_matches_jax(ssd):
    _, model, frames, quads, _ = ssd
    apply_fn = D.make_ssd_apply(SSD["topk"], packed=False)
    with torch.inference_mode():
        for f, want in zip(frames, quads):
            got = [o.numpy() for o in apply_fn(model, torch.from_numpy(f))]
            assert [g.shape for g in got] == [(10, 4), (10,), (10,), (1,)]
            assert all(g.dtype == np.float32 for g in got)
            assert assert_quads_agree(got, want) >= SSD["topk"] // 2


def test_ssd_packed_is_the_flattened_quad(ssd):
    _, model, frames, _, _ = ssd
    quad_fn = D.make_ssd_apply(SSD["topk"], packed=False)
    packed_fn = D.make_ssd_apply(SSD["topk"], packed=True)
    with torch.inference_mode():
        quad = [o.numpy() for o in quad_fn(model, torch.from_numpy(frames[0]))]
        flat = packed_fn(model, torch.from_numpy(frames[0])).numpy()
        batch = packed_fn(model, torch.from_numpy(frames)).numpy()
    assert flat.shape == (6 * SSD["topk"] + 1,)
    np.testing.assert_array_equal(
        flat, np.concatenate([quad[0].reshape(-1), quad[1], quad[2], quad[3]]))
    assert batch.shape == (3, 6 * SSD["topk"] + 1)
    # the port's decoder reads either form identically
    dec = find_decoder("bounding_boxes")()
    dec.set_options(["mobilenet-ssd-postprocess", "", "", "96:96", "96:96"])
    from_quad = dec._boxes_ssd_pp(Buffer([Chunk(q) for q in quad]))
    from_flat = dec._boxes_ssd_pp(Buffer([Chunk(flat)]))
    assert [vars(b) for b in from_flat] == [vars(b) for b in from_quad]


def test_ssd_batch_of_two_equals_two_frames(ssd):
    _, model, frames, _, _ = ssd
    apply_fn = D.make_ssd_apply(SSD["topk"], packed=False)
    with torch.inference_mode():
        batch = apply_fn(model, torch.from_numpy(frames[:2]))
        singles = [apply_fn(model, torch.from_numpy(f)) for f in frames[:2]]
    assert [tuple(o.shape) for o in batch] == [(2, 10, 4), (2, 10), (2, 10),
                                               (2, 1)]
    for i, single in enumerate(singles):
        for b, s in zip(batch, single):
            np.testing.assert_array_equal(b[i].numpy(), s.numpy())


# -- PoseNet --------------------------------------------------------------

@pytest.fixture(scope="module")
def posenet():
    variables = _variables("posenet", 41, size=POSE_SIZE)
    model = _port(D.PoseNet(17, WIDTH), posenet_params_from_jax(variables))
    frames = _frames(2, POSE_SIZE, 42)
    want = np.asarray(jdet.PoseNet(keypoints=17, width=WIDTH).apply(
        variables, _jax_input(frames)))
    return model, frames, want


def test_posenet_heatmap_matches_jax(posenet):
    model, frames, want = posenet
    with torch.inference_mode():
        got = D.make_posenet_apply(False)(model, torch.from_numpy(frames))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 9, 9, 17)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=BF16_ATOL)


def test_posenet_device_decode_matches_heatmap_positions(posenet):
    """As tests/test_models.py checks the JAX model: decode=device
    keypoints are the heatmap's argmax positions and values, on the pose
    decoder's score scale; and they match the JAX heatmap's argmax for
    every keypoint whose top-2 heatmap gap exceeds the tolerance."""
    model, frames, want_hm = posenet
    with torch.inference_mode():
        hm = D.make_posenet_apply(False)(model, torch.from_numpy(frames[0]))
        kps = D.make_posenet_apply(True)(model, torch.from_numpy(frames[0]))
    hm, kps = hm.numpy(), kps.numpy()
    assert kps.shape == (17, 3) and kps.dtype == np.float32
    hp, wp, k = hm.shape
    flat = hm.reshape(-1, k)
    idx = np.argmax(flat, axis=0)
    np.testing.assert_allclose(kps[:, 0], (idx % wp) / (wp - 1), atol=1e-6)
    np.testing.assert_allclose(kps[:, 1], (idx // wp) / (hp - 1), atol=1e-6)
    np.testing.assert_array_equal(kps[:, 2], flat[idx, np.arange(k)])
    dec = find_decoder("pose_estimation")()
    dec.set_options(["129:129", "129:129", "", "", "", "", "", "", ""])
    host = np.array(dec._keypoints(Buffer([Chunk(hm)])))
    np.testing.assert_allclose(host, kps, rtol=0, atol=1e-6)
    jflat = want_hm[0].reshape(-1, k)
    top2 = np.sort(jflat, axis=0)[-2:]
    clear = top2[1] - top2[0] > BF16_ATOL
    np.testing.assert_array_equal(idx[clear], np.argmax(jflat, 0)[clear])


def test_keypoints_take_the_first_maximum():
    hm = torch.zeros(1, 2, 3, 3)
    hm[0, 0, 1, 2] = hm[0, 0, 2, 0] = 1.0  # a tie: the first in row order
    hm[0, 1] = 0.5  # all equal: cell 0
    kps = D.keypoints_of(hm)[0]
    assert kps[0].tolist() == [1.0, 0.5, 1.0]
    assert kps[1].tolist() == [0.0, 0.0, 0.5]
    want = np.asarray(jnp.argmax(jnp.asarray(hm[0].reshape(2, 9).T.numpy()),
                                 axis=0))
    assert want.tolist() == [5, 0]


# -- DeepLab-v3 -----------------------------------------------------------

@pytest.fixture(scope="module")
def deeplab():
    variables = _variables("deeplab_v3", 51, size=SEG_SIZE)
    model = _port(D.DeepLabV3(21, WIDTH, SEG_SIZE),
                  deeplab_params_from_jax(variables))
    frames = _frames(2, SEG_SIZE, 52)
    want = np.asarray(jdet.DeepLabV3(num_classes=21, width=WIDTH,
                                     out_size=SEG_SIZE).apply(
        variables, _jax_input(frames)))
    return model, frames, want


def test_deeplab_logits_match_jax(deeplab):
    model, frames, want = deeplab
    with torch.inference_mode():
        got = D.make_deeplab_apply("0")(model, torch.from_numpy(frames))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 65, 65, 21)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=BF16_ATOL)


@pytest.mark.parametrize("argmax,dtype", [("1", np.int32), ("u8", np.uint8)])
def test_deeplab_class_map_matches_jax(deeplab, argmax, dtype):
    model, frames, want = deeplab
    with torch.inference_mode():
        got = D.make_deeplab_apply(argmax)(model, torch.from_numpy(frames))
        one = D.make_deeplab_apply(argmax)(model, torch.from_numpy(frames[0]))
    got = got.numpy()
    assert got.dtype == dtype and got.shape == (2, 65, 65)
    np.testing.assert_array_equal(one.numpy(), got[0])
    jmap = want.argmax(-1)
    assert (got == jmap).mean() >= 0.99
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > BF16_ATOL
    np.testing.assert_array_equal(got[clear], jmap[clear])


def test_bilinear_resize_matches_jax_image_resize():
    x = np.random.default_rng(3).normal(0, 1, (2, 17, 17, 21)).astype(
        np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 257, 257, 21),
                                       method="bilinear"))
    got = D.resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), 257)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=1e-6)


def test_deeplab_u8_refuses_more_than_255_classes():
    with pytest.raises(ValueError, match="u8"):
        zoo.build("deeplab_v3", width="0.35", size="33", num_classes="256",
                  argmax="u8")


# -- builders, parameter counts, the backbone's strides --------------------

@pytest.mark.parametrize("name,kw", [
    ("ssd_mobilenet_v2", dict(size="96", topk="10")),
    ("ssd_mobilenet_v2", dict(size="96", topk="10", packed="1")),
    ("posenet", dict(size="129")),
    ("posenet", dict(size="129", decode="device")),
    ("deeplab_v3", dict(size="65")),
    ("deeplab_v3", dict(size="65", argmax="1")),
    ("deeplab_v3", dict(size="65", argmax="u8")),
])
def test_zoo_build_contract_matches_jax(name, kw, monkeypatch):
    """The same input and output TensorsInfo as the JAX builder. The JAX
    builder's init is stubbed out: the contract does not depend on the
    weights, and an init would compile the model."""
    monkeypatch.setattr(jdet, "jit_init", lambda *a: None)
    _, _, jin, jout = jax_zoo.build(name, width="0.35", **kw)
    _, module, pin, pout = zoo.build(name, width="0.35", **kw)
    assert str(pin) == str(jin) and str(pout) == str(jout)
    assert isinstance(module, torch.nn.Module)


@pytest.mark.parametrize("name,module,size", [
    ("ssd", lambda: jdet.SSDMobileNetV2(num_classes=91, width=1.0), 300),
    ("posenet", lambda: jdet.PoseNet(keypoints=17, width=1.0), 257),
    ("deeplab", lambda: jdet.DeepLabV3(num_classes=21, width=1.0,
                                       out_size=257), 257),
])
def test_full_width_parameter_count_matches_jax(name, module, size):
    """Width 1.0 at the published sizes: the torch module holds as many
    parameters and BatchNorm statistics as the JAX variables (shapes
    only, no forward)."""
    shapes = jax.eval_shape(lambda: module().init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3), jnp.bfloat16)))
    count = {c: sum(int(np.prod(leaf.shape))
                    for leaf in jax.tree.leaves(shapes[c]))
             for c in ("params", "batch_stats")}
    port = {"ssd": lambda: D.SSDMobileNetV2(91, 1.0),
            "posenet": lambda: D.PoseNet(17, 1.0),
            "deeplab": lambda: D.DeepLabV3(21, 1.0, 257)}[name]()
    assert sum(p.numel() for p in port.parameters()) == count["params"]
    assert sum(b.numel() for b in port.buffers()) == count["batch_stats"]


@pytest.mark.parametrize("size,cells", [(300, 19), (257, 17), (96, 6)])
def test_backbone_output_stride_is_16(size, cells):
    """The JAX loop demotes the 160-channel stage's stride-2 block to
    stride 1 at max_stride 16, and that block has no residual."""
    bb = D.Backbone(width=0.35, max_stride=16,
                    gen=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        out = bb(torch.zeros(1, 3, size, size))
    assert tuple(out.shape[2:]) == (cells, cells)
    strides = [b.layers[-2].stride for b in bb.blocks]
    assert strides == [1, 2, 1, 2, 1, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1]
    assert [b.residual for b in bb.blocks][13] is False


def test_converter_rejects_a_tree_with_a_leaf_left_over(ssd):
    variables = ssd[0]
    extra = {"params": dict(variables["params"], Extra_0={"kernel": np.ones(1)}),
             "batch_stats": variables["batch_stats"]}
    with pytest.raises(ValueError, match="Extra_0"):
        ssd_params_from_jax(extra)


def test_jax_decoder_reads_the_port_quad(ssd):
    """The port's SSD quad is a valid input of the JAX package's own
    bounding_boxes decoder, which reads it as the port's does."""
    _, model, frames, _, _ = ssd
    with torch.inference_mode():
        quad = [o.numpy() for o in D.make_ssd_apply(10, False)(
            model, torch.from_numpy(frames[0]))]
    opts = ["mobilenet-ssd-postprocess", "", "", "96:96", "96:96"]
    jdec, pdec = jax_find_decoder("bounding_boxes")(), \
        find_decoder("bounding_boxes")()
    jdec.set_options(opts)
    pdec.set_options(opts)
    want = jdec._boxes_ssd_pp(JBuffer([JChunk(q) for q in quad]))
    got = pdec._boxes_ssd_pp(Buffer([Chunk(q) for q in quad]))
    assert [vars(b) for b in got] == [vars(b) for b in want] and got
