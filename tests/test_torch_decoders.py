"""The port's decoders (nnstreamer_tpu_torch/decoders/) against the JAX
package's on the same arrays: bounding_boxes in every mode, with and
without labels, pose_estimation in both input forms, image_segment on
logits and on class maps, and the bitmap font. All of them are host
numpy on both sides, so frames and extras must be equal, bit for bit.

The arrays are drawn from numpy seeds, with enough boxes above the
thresholds that NMS suppresses some and labels are drawn.
"""
import numpy as np
import pytest

from nnstreamer_tpu.decoders import font as jax_font
from nnstreamer_tpu.decoders.bounding_box import (DetectedBox as JBox,
                                                  nms as jax_nms)
from nnstreamer_tpu.decoders.registry import find_decoder as jax_find
from nnstreamer_tpu.tensors.buffer import Buffer as JBuffer, Chunk as JChunk
from nnstreamer_tpu.tensors.info import (TensorsConfig as JConfig,
                                         TensorsInfo as JInfo)
from nnstreamer_tpu_torch.decoders import font
from nnstreamer_tpu_torch.decoders.bounding_box import DetectedBox, nms
from nnstreamer_tpu_torch.decoders.registry import find_decoder
from nnstreamer_tpu_torch.tensors.buffer import Buffer, Chunk
from nnstreamer_tpu_torch.tensors.info import TensorsConfig, TensorsInfo


def _decode_both(mode, options, arrays, types=None, dims=None):
    """Run ``mode`` of both packages on ``arrays``; returns the two
    output buffers and the two output caps strings."""
    outs = []
    for find, buf, chunk, cfg, info in (
            (jax_find, JBuffer, JChunk, JConfig, JInfo),
            (find_decoder, Buffer, Chunk, TensorsConfig, TensorsInfo)):
        dec = find(mode)()
        dec.set_options(list(options) + [""] * (9 - len(options)))
        caps = dec.get_out_caps(cfg(info.make(types or "float32",
                                              dims or "1")))
        outs.append((dec.decode(buf([chunk(a) for a in arrays])), str(caps)))
    return outs


def _assert_same(outs):
    (want, want_caps), (got, got_caps) = outs
    assert got_caps == want_caps
    assert len(got.chunks) == len(want.chunks) == 1
    g, w = got.chunks[0].host(), want.chunks[0].host()
    assert g.dtype == w.dtype and g.shape == w.shape
    assert g.tobytes() == w.tobytes()
    assert got.extras.keys() == want.extras.keys()
    for key, value in want.extras.items():
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(got.extras[key], value)
        else:
            assert got.extras[key] == value, key
    return got


@pytest.fixture(scope="module")
def labels(tmp_path_factory):
    path = tmp_path_factory.mktemp("labels") / "labels.txt"
    path.write_text("\n".join(f"obj{i}" for i in range(91)))
    return str(path)


def _yolo_pred(rng, n, nc, extra):
    pred = rng.uniform(0, 1, (n, extra + nc)).astype(np.float32)
    pred[:, :2] = rng.uniform(0.2, 0.8, (n, 2))
    pred[:, 2:4] = rng.uniform(0.05, 0.3, (n, 2))
    return pred


@pytest.mark.parametrize("opt3,scale", [("", 1.0), ("0:0.3:0.5", 1.0),
                                        ("1:0.4:0.45", 64.0)])
@pytest.mark.parametrize("with_labels", [False, True])
def test_bounding_boxes_yolov5(opt3, scale, with_labels, labels):
    pred = _yolo_pred(np.random.default_rng(1), 40, 6, 5)
    pred[:, :4] *= scale
    opts = ["yolov5", labels if with_labels else "", opt3, "64:64", "64:64"]
    got = _assert_same(_decode_both("bounding_boxes", opts, [pred],
                                    dims="11:40"))
    assert got.extras["boxes"]


@pytest.mark.parametrize("transposed", [False, True])
def test_bounding_boxes_yolov8(transposed, labels):
    pred = _yolo_pred(np.random.default_rng(2), 30, 5, 4)
    if transposed:
        pred = np.ascontiguousarray(pred.T)[None]  # [1, 4+nc, N]
    got = _assert_same(_decode_both(
        "bounding_boxes", ["yolov8", labels, "0:0.5:0.5", "80:60", "80:60"],
        [pred], dims="9:30"))
    assert got.extras["boxes"]


def _ssd_quad(rng, k=12):
    ymin, xmin = rng.uniform(0, 0.6, (2, k))
    boxes = np.stack([ymin, xmin, ymin + rng.uniform(0.05, 0.4, k),
                      xmin + rng.uniform(0.05, 0.4, k)], 1).astype(np.float32)
    classes = rng.integers(0, 91, k).astype(np.float32)
    scores = np.sort(rng.uniform(0, 1, k)).astype(np.float32)[::-1].copy()
    return [boxes, classes, scores, np.array([k - 2], np.float32)]


@pytest.mark.parametrize("form", ["quad", "packed", "reordered"])
def test_bounding_boxes_ssd_postprocess(form, labels):
    quad = _ssd_quad(np.random.default_rng(3))
    opt3, arrays = "", quad
    if form == "packed":
        arrays = [np.concatenate([quad[0].reshape(-1)] + quad[1:])]
    elif form == "reordered":
        opt3, arrays = "3:1:2:0", [quad[3], quad[1], quad[2], quad[0]]
    got = _assert_same(_decode_both(
        "bounding_boxes", ["mobilenet-ssd-postprocess", labels, opt3,
                           "300:300", "300:300"], arrays))
    assert got.extras["boxes"]


def test_bounding_boxes_packed_length_is_checked():
    for find, buf, chunk in ((jax_find, JBuffer, JChunk),
                             (find_decoder, Buffer, Chunk)):
        dec = find("bounding_boxes")()
        dec.set_options(["mobilenet-ssd-postprocess", "", "", "32:32"])
        with pytest.raises(ValueError, match="packed"):
            dec.decode(buf([chunk(np.zeros(8, np.float32))]))


def test_bounding_boxes_mobilenet_ssd_with_priors(tmp_path, labels):
    rng = np.random.default_rng(4)
    n = 50
    priors = np.stack([rng.uniform(0.1, 0.9, n), rng.uniform(0.1, 0.9, n),
                       rng.uniform(0.05, 0.3, n), rng.uniform(0.05, 0.3, n)])
    path = tmp_path / "priors.txt"
    path.write_text("\n".join(" ".join(f"{v:.6f}" for v in row)
                              for row in priors))
    deltas = rng.normal(0, 1, (n, 4)).astype(np.float32)
    logits = rng.normal(0, 2, (n, 8)).astype(np.float32)
    got = _assert_same(_decode_both(
        "bounding_boxes", ["mobilenet-ssd", labels, f"{path}:0.6",
                           "100:100", "100:100"], [deltas, logits]))
    assert got.extras["boxes"]


def test_bounding_boxes_ov_person_detection():
    rng = np.random.default_rng(5)
    rows = np.zeros((200, 7), np.float32)
    rows[:, 2] = rng.uniform(0.5, 1, 200)
    rows[:, 3:5] = rng.uniform(0, 0.5, (200, 2))
    rows[:, 5:7] = rows[:, 3:5] + rng.uniform(0.05, 0.4, (200, 2))
    rows[30, 0] = -1  # the scan stops here
    rows[10, 0] = -0.5  # int-truncates to 0: does not stop it
    got = _assert_same(_decode_both(
        "bounding_boxes", ["ov-person-detection", "", "", "64:48"], [rows]))
    assert 0 < len(got.extras["boxes"]) < 30


@pytest.mark.parametrize("opt3", ["", "0.4:2:1.0:1.0:0.5:0.5:8:16"])
def test_bounding_boxes_mp_palm_detection(opt3):
    rng = np.random.default_rng(6)
    n = 2016 if not opt3 else 12 * 12 * 2 + 6 * 6 * 2
    boxes = rng.normal(0, 10, (n, 18)).astype(np.float32)
    boxes[:, 2:4] = rng.uniform(10, 40, (n, 2))
    scores = rng.normal(-3, 2, n).astype(np.float32)
    got = _assert_same(_decode_both(
        "bounding_boxes", ["mp-palm-detection", "", opt3, "192:192"],
        [boxes, scores]))
    assert got.extras["boxes"]


def test_bounding_boxes_unknown_mode_raises():
    for find, buf, chunk in ((jax_find, JBuffer, JChunk),
                             (find_decoder, Buffer, Chunk)):
        dec = find("bounding_boxes")()
        dec.set_options(["nope"])
        with pytest.raises(ValueError, match="unknown mode"):
            dec.decode(buf([chunk(np.zeros(7, np.float32))]))


def test_nms_and_text_drawing_match():
    rng = np.random.default_rng(8)
    raw = [(*rng.uniform(0, 0.7, 2), *rng.uniform(0.1, 0.3, 2),
            int(rng.integers(0, 3)), float(rng.uniform()))
           for _ in range(40)]
    want = jax_nms([JBox(*r) for r in raw], 0.3)
    got = nms([DetectedBox(*r) for r in raw], 0.3)
    assert [vars(b) for b in got] == [vars(b) for b in want]
    for text, x, y in (("AB 9:%-q", 1, 1), ("XYZ", 55, 18), ("Q", -3, -3)):
        a = np.zeros((20, 60, 4), np.uint8)
        b = np.zeros((20, 60, 4), np.uint8)
        jax_font.draw_text(a, x, y, text, (255, 0, 0, 255), scale=2)
        font.draw_text(b, x, y, text, (255, 0, 0, 255), scale=2)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("form", ["heatmap", "keypoints2", "keypoints3"])
def test_pose_estimation_matches_jax(form):
    rng = np.random.default_rng(9)
    if form == "heatmap":
        arr = rng.uniform(0, 1, (9, 9, 17)).astype(np.float32)
        arr[4, 4, 3] = arr[2, 6, 3] = 2.0  # a tie: the first in row order
        dims = "17:9:9"
    else:
        arr = rng.uniform(0, 1, (17, 2 if form == "keypoints2" else 3))
        arr = arr.astype(np.float32)
        dims = f"{arr.shape[1]}:17"
    got = _assert_same(_decode_both(
        "pose_estimation", ["64:48", "129:129", "", "0.4"], [arr], dims=dims))
    assert len(got.extras["keypoints"]) == 17


@pytest.mark.parametrize("dtype,dims", [
    (np.float32, "5:16:12"), (np.uint8, "16:12"), (np.int32, "16:12")])
def test_image_segment_matches_jax(dtype, dims):
    rng = np.random.default_rng(10)
    if dtype == np.float32:
        arr = rng.normal(0, 1, (12, 16, 5)).astype(dtype)
        arr[0, 0] = 1.0  # all classes tie: class 0
    else:
        arr = rng.integers(0, 30, (12, 16)).astype(dtype)
    types = {np.float32: "float32", np.uint8: "uint8", np.int32: "int32"}
    got = _assert_same(_decode_both(
        "image_segment", ["tflite-deeplab", "0.5"], [arr],
        types=types[dtype], dims=dims))
    assert got.chunks[0].shape == (12, 16, 4)


def test_decoder_tensor_region():
    """The reference's case: one box of the ssd-postprocess quad at
    (0.25, 0.25)-(0.75, 0.75) on a 64x64 image is the region (16, 16,
    32, 32); the second of N=2 rows stays zero. Equal bytes, equal
    ``regions`` extra."""
    boxes = np.array([[0.25, 0.25, 0.75, 0.75]], np.float32)
    got = _assert_same(_decode_both(
        "tensor_region", ["2", "", "64:64"],
        [boxes, np.array([1], np.float32), np.array([0.8], np.float32),
         np.array([1], np.float32)], types="float32", dims="4:1"))
    regions = got.extras["regions"]
    assert regions.shape == (2, 4) and regions.dtype == np.uint32
    assert tuple(regions[0]) == (16, 16, 32, 32)
    assert tuple(regions[1]) == (0, 0, 0, 0)


@pytest.mark.parametrize("form", ["quad", "packed"])
def test_tensor_region_top_n_by_score(form):
    """The packed [6K+1] layout and the quad give the same regions: the
    N highest scores above the 0.25 threshold, in pixels of option3."""
    quad = _ssd_quad(np.random.default_rng(8))
    arrays = quad if form == "quad" else \
        [np.concatenate([quad[0].reshape(-1)] + quad[1:])]
    got = _assert_same(_decode_both("tensor_region", ["4", "", "300:300"],
                                    arrays))
    regions = got.extras["regions"]
    assert regions.shape == (4, 4) and (regions[:, 2:] > 0).all()
    boxes, _, scores, count = quad
    keep = [i for i in np.argsort(-scores[:int(count[0])], kind="stable")
            if scores[i] >= 0.25][:4]
    want = [(int(boxes[i, 1] * 300), int(boxes[i, 0] * 300),
             int((boxes[i, 3] - boxes[i, 1]) * 300),
             int((boxes[i, 2] - boxes[i, 0]) * 300)) for i in keep]
    assert [tuple(r) for r in regions] == want
