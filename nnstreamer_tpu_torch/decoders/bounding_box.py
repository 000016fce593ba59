"""bounding_boxes decoder: detection tensors -> RGBA overlay video.

Port of ``nnstreamer_tpu/decoders/bounding_box.py``, every mode; all of
it runs on the host in numpy, as in the JAX package.

≙ ext/nnstreamer/tensor_decoder/tensordec-boundingbox.cc with its
pluggable BoxProperties classes (tensordec-boundingbox.h:236-305):
yolov5/yolov8 (box_properties/yolo.cc), mobilenet-ssd (mobilenetssd.cc),
mobilenet-ssd-postprocess (mobilenetssdpp.cc).

Options (reference-compatible):
  option1 = mode: yolov5 | yolov8 | mobilenet-ssd-postprocess | custom
  option2 = labels file
  option3 = mode-specific (yolo: "scale:conf:iou"; ssd-pp: tensor order)
  option4 = output video size "W:H"
  option5 = model input size "W:H"
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..tensors.buffer import Buffer, Chunk
from ..tensors.caps import Caps
from ..tensors.info import TensorsConfig
from .image_label import load_labels
from .registry import DecoderPlugin, register_decoder

_PALETTE = np.array([
    [255, 64, 64, 255], [64, 255, 64, 255], [64, 64, 255, 255],
    [255, 255, 64, 255], [255, 64, 255, 255], [64, 255, 255, 255],
    [255, 160, 64, 255], [160, 64, 255, 255]], np.uint8)


@dataclasses.dataclass
class DetectedBox:
    x: float       # normalized [0,1] left
    y: float       # top
    w: float
    h: float
    cls: int
    score: float


def iou(a: DetectedBox, b: DetectedBox) -> float:
    x1, y1 = max(a.x, b.x), max(a.y, b.y)
    x2 = min(a.x + a.w, b.x + b.w)
    y2 = min(a.y + a.h, b.y + b.h)
    inter = max(0.0, x2 - x1) * max(0.0, y2 - y1)
    union = a.w * a.h + b.w * b.h - inter
    return inter / union if union > 0 else 0.0


def nms(boxes: List[DetectedBox], threshold: float = 0.5) -> List[DetectedBox]:
    """Greedy per-class non-max suppression (≙ reference nms in
    tensordec-boundingbox.cc)."""
    out: List[DetectedBox] = []
    for b in sorted(boxes, key=lambda b: -b.score):
        if all(o.cls != b.cls or iou(o, b) < threshold for o in out):
            out.append(b)
    return out


def draw_boxes(boxes: List[DetectedBox], width: int, height: int,
               thickness: int = 2,
               labels: Optional[List[str]] = None) -> np.ndarray:
    """Rasterize box outlines onto a transparent RGBA canvas; with
    ``labels``, print each box's class name above it (≙ the reference's
    bounding-box decoder + tensordec-font.c raster overlay)."""
    from .font import GLYPH_H, draw_text
    canvas = np.zeros((height, width, 4), np.uint8)
    for b in boxes:
        color = _PALETTE[b.cls % len(_PALETTE)]
        x0 = int(np.clip(b.x * width, 0, width - 1))
        y0 = int(np.clip(b.y * height, 0, height - 1))
        x1 = int(np.clip((b.x + b.w) * width, 0, width - 1))
        y1 = int(np.clip((b.y + b.h) * height, 0, height - 1))
        t = thickness
        canvas[y0:y0 + t, x0:x1 + 1] = color
        canvas[max(0, y1 - t + 1):y1 + 1, x0:x1 + 1] = color
        canvas[y0:y1 + 1, x0:x0 + t] = color
        canvas[y0:y1 + 1, max(0, x1 - t + 1):x1 + 1] = color
        if labels and 0 <= b.cls < len(labels):
            ty = y0 - GLYPH_H - 2
            draw_text(canvas, x0, ty if ty >= 0 else y0 + t + 1,
                      labels[b.cls], color)
    return canvas


@register_decoder
class BoundingBoxes(DecoderPlugin):
    NAME = "bounding_boxes"

    def set_options(self, options) -> None:
        super().set_options(options)
        self.mode = self.option(1) or "yolov5"
        self._labels = load_labels(self.option(2)) if self.option(2) else None
        self.out_w, self.out_h = self._parse_wh(self.option(4), (640, 480))
        self.in_w, self.in_h = self._parse_wh(self.option(5),
                                              (self.out_w, self.out_h))
        opt3 = self.option(3)
        self.conf_threshold, self.iou_threshold, self.scaled = 0.25, 0.45, False
        if self.mode in ("yolov5", "yolov8") and opt3:
            parts = opt3.split(":")
            if parts and parts[0]:
                self.scaled = parts[0] not in ("0", "false")
            if len(parts) > 1 and parts[1]:
                self.conf_threshold = float(parts[1])
            if len(parts) > 2 and parts[2]:
                self.iou_threshold = float(parts[2])
        elif self.mode in ("mobilenet-ssd", "mobilenetssd", "tflite-ssd"):
            self._parse_ssd_options(opt3)
        elif self.mode == "mp-palm-detection":
            self._parse_palm_options(opt3)

    def _parse_ssd_options(self, opt3: str) -> None:
        """option3 = <prior file>[:threshold:y_scale:x_scale:h_scale:
        w_scale:iou] (≙ mobilenetssd.cc setOptionInternal; defaults
        0.5/10/10/5/5/0.5)."""
        parts = (opt3 or "").split(":")
        if not parts or not parts[0]:
            raise ValueError(
                "mobilenet-ssd mode needs option3=<box-priors file>")
        self._priors = self._load_box_priors(parts[0])
        defaults = [0.5, 10.0, 10.0, 5.0, 5.0, 0.5]
        for i in range(6):
            if len(parts) > i + 1 and parts[i + 1]:
                defaults[i] = float(parts[i + 1])
        (self.conf_threshold, self._y_scale, self._x_scale,
         self._h_scale, self._w_scale, self.iou_threshold) = defaults

    @staticmethod
    def _load_box_priors(path: str) -> np.ndarray:
        """4 rows x N anchors (≙ mobilenet_ssd_loadBoxPrior)."""
        rows = []
        with open(path) as f:
            for line in f:
                vals = [float(v) for v in line.split()]
                if vals:
                    rows.append(vals)
        if len(rows) < 4:
            raise ValueError(
                f"{path}: box-priors file needs 4 rows, got {len(rows)}")
        return np.asarray(rows[:4], np.float32)

    def _parse_palm_options(self, opt3: str) -> None:
        """option3 = [min_score:num_layers:min_scale:max_scale:offset_x:
        offset_y:stride0:...] (≙ mppalmdetection.cc setOptionInternal)."""
        parts = [p for p in (opt3 or "").split(":")]
        def _get(i, cast, default):
            return cast(parts[i]) if len(parts) > i and parts[i] else default
        self.conf_threshold = _get(0, float, 0.5)
        num_layers = _get(1, int, 4)
        min_scale = _get(2, float, 1.0)
        max_scale = _get(3, float, 1.0)
        offset_x = _get(4, float, 0.5)
        offset_y = _get(5, float, 0.5)
        defaults = [8, 16, 16, 16]
        strides = [_get(6 + i, int,
                        defaults[i] if i < len(defaults) else defaults[-1])
                   for i in range(num_layers)]
        if not self.option(5):
            # anchors are generated for the 192x192 palm model; offsets
            # must be scaled by the same input size, not the 640x480
            # video default
            self.in_w = self.in_h = 192
        self._anchors = self._palm_anchors(num_layers, min_scale, max_scale,
                                           offset_x, offset_y, strides)
        self.iou_threshold = 0.05  # (≙ nms(results, 0.05f, ...) :367)

    @staticmethod
    def _palm_anchors(num_layers, min_scale, max_scale, offset_x, offset_y,
                      strides) -> np.ndarray:
        """SSD-style anchor grid for the 192x192 mediapipe palm model
        (≙ mp_palm_detection_generate_anchors). Rows: (x_c, y_c, w, h)."""
        def scale_for(idx):
            # NB: for the second anchor of the last layer this evaluates
            # at idx == num_layers, extrapolating past max_scale — that
            # mirrors the reference exactly (mppalmdetection.cc:173-175
            # calls _calculate_scale(last_same_stride_layer + 1, ...)),
            # which itself diverges from upstream mediapipe's
            # interpolated-scale variant. Parity wins here.
            if num_layers == 1:
                return (min_scale + max_scale) * 0.5
            return min_scale + (max_scale - min_scale) * idx / (num_layers - 1)

        anchors = []
        layer = 0
        while layer < num_layers:
            dims = []  # (w, h) per anchor at one cell
            last = layer
            while last < num_layers and strides[last] == strides[layer]:
                for s_idx in (last, last + 1):
                    sc = scale_for(s_idx)
                    dims.append((sc, sc))  # aspect ratio 1 -> w = h = scale
                last += 1
            stride = strides[layer]
            fm = int(np.ceil(192 / stride))
            for y in range(fm):
                for x in range(fm):
                    for w, h in dims:
                        anchors.append(((x + offset_x) / fm,
                                        (y + offset_y) / fm, w, h))
            layer = last
        return np.asarray(anchors, np.float32)

    @staticmethod
    def _parse_wh(opt: str, default):
        if not opt:
            return default
        w, h = opt.split(":")
        return int(w), int(h)

    def get_out_caps(self, config: TensorsConfig) -> Caps:
        rate = f"{config.rate_n}/{config.rate_d}"
        return Caps(f"video/x-raw,format=RGBA,width={self.out_w},"
                    f"height={self.out_h},framerate=(fraction){rate}")

    # -- per-mode tensor parsing (the BoxProperties analog) ---------------
    def _boxes_yolov5(self, buf: Buffer) -> List[DetectedBox]:
        """pred [N, 5+nc]: cx,cy,w,h,obj,cls... (pixel scale when
        option3 scaled=1, else normalized)."""
        pred = buf.chunks[0].host()
        pred = pred.reshape(-1, pred.shape[-1])
        scale_w = self.in_w if self.scaled else 1.0
        scale_h = self.in_h if self.scaled else 1.0
        obj = pred[:, 4]
        cls_scores = pred[:, 5:] * obj[:, None]
        cls = np.argmax(cls_scores, axis=1)
        score = cls_scores[np.arange(len(cls)), cls]
        keep = score >= self.conf_threshold
        out = []
        for p, c, s in zip(pred[keep], cls[keep], score[keep]):
            cx, cy, w, h = (p[0] / scale_w, p[1] / scale_h,
                            p[2] / scale_w, p[3] / scale_h)
            out.append(DetectedBox(cx - w / 2, cy - h / 2, w, h,
                                   int(c), float(s)))
        return nms(out, self.iou_threshold)

    def _boxes_yolov8(self, buf: Buffer) -> List[DetectedBox]:
        """pred [4+nc, N] (or [N, 4+nc]): cx,cy,w,h,cls... (no objectness)."""
        pred = buf.chunks[0].host()
        pred = pred.reshape(pred.shape[-2], pred.shape[-1]) \
            if pred.ndim > 2 else pred
        if pred.shape[0] < pred.shape[1]:
            pred = pred.T  # -> [N, 4+nc]
        scale_w = self.in_w if self.scaled else 1.0
        scale_h = self.in_h if self.scaled else 1.0
        cls_scores = pred[:, 4:]
        cls = np.argmax(cls_scores, axis=1)
        score = cls_scores[np.arange(len(cls)), cls]
        keep = score >= self.conf_threshold
        out = []
        for p, c, s in zip(pred[keep], cls[keep], score[keep]):
            cx, cy, w, h = (p[0] / scale_w, p[1] / scale_h,
                            p[2] / scale_w, p[3] / scale_h)
            out.append(DetectedBox(cx - w / 2, cy - h / 2, w, h,
                                   int(c), float(s)))
        return nms(out, self.iou_threshold)

    def _boxes_ssd_pp(self, buf: Buffer) -> List[DetectedBox]:
        """TFLite detection-postprocess convention: boxes [N,4]
        (ymin,xmin,ymax,xmax normalized), classes [N], scores [N],
        count [1] (≙ mobilenetssdpp.cc tensor order, option3 reorders).

        A SINGLE flat chunk of 6K+1 floats is the packed variant
        (zoo://ssd_mobilenet_v2?packed=1): [4K boxes][K classes]
        [K scores][1 count] — one D2H instead of four."""
        if len(buf.chunks) == 1:
            flat = buf.chunks[0].host().reshape(-1)
            if (flat.size - 1) % 6:
                raise ValueError(
                    "bounding_boxes: single-chunk ssd-postprocess input "
                    f"of {flat.size} floats is not the packed [6K+1] "
                    "layout (boxes/classes/scores/count)")
            k = (flat.size - 1) // 6
            boxes = flat[:4 * k]
            classes = flat[4 * k:5 * k]
            scores = flat[5 * k:6 * k]
            count = flat[6 * k:]
        else:
            order = [int(i) for i in self.option(3).split(":")] \
                if self.option(3) else [0, 1, 2, 3]
            chunks = [buf.chunks[i].host() for i in order]
            boxes, classes, scores, count = chunks
        n = int(count.reshape(-1)[0])
        boxes = boxes.reshape(-1, 4)
        scores = scores.reshape(-1)
        classes = classes.reshape(-1)
        n = min(n, len(boxes))
        keep = np.nonzero(scores[:n] >= self.conf_threshold)[0]
        return [DetectedBox(float(boxes[i, 1]), float(boxes[i, 0]),
                            float(boxes[i, 3] - boxes[i, 1]),
                            float(boxes[i, 2] - boxes[i, 0]),
                            int(classes[i]), float(scores[i]))
                for i in keep]

    def _boxes_mobilenet_ssd(self, buf: Buffer) -> List[DetectedBox]:
        """Raw SSD head + box-prior anchors: tensor0 = box deltas
        [N, 4], tensor1 = class logits [N, labels]
        (≙ mobilenetssd.cc _get_objects_mobilenet_ssd: per-anchor best
        class >= threshold, prior-decoded center/size, then NMS)."""
        deltas = buf.chunks[0].host().reshape(-1, 4).astype(np.float32)
        logits = buf.chunks[1].host()
        logits = logits.reshape(-1, logits.shape[-1]).astype(np.float32)
        n = min(len(deltas), len(logits), self._priors.shape[1])
        deltas, logits = deltas[:n], logits[:n]
        pr = self._priors[:, :n]  # rows: [0]=yc [1]=xc [2]=h [3]=w
        # best non-background class per anchor (class 0 is background)
        cls = np.argmax(logits[:, 1:], axis=1) + 1
        logit_best = logits[np.arange(n), cls]
        score = 1.0 / (1.0 + np.exp(-np.clip(logit_best, -100, 100)))
        keep = score >= self.conf_threshold
        yc = deltas[:, 0] / self._y_scale * pr[2] + pr[0]
        xc = deltas[:, 1] / self._x_scale * pr[3] + pr[1]
        h = np.exp(deltas[:, 2] / self._h_scale) * pr[2]
        w = np.exp(deltas[:, 3] / self._w_scale) * pr[3]
        out = [DetectedBox(float(xc[i] - w[i] / 2), float(yc[i] - h[i] / 2),
                           float(w[i]), float(h[i]), int(cls[i]),
                           float(score[i]))
               for i in np.nonzero(keep)[0]]
        return nms(out, self.iou_threshold)

    def _boxes_ov_person(self, buf: Buffer) -> List[DetectedBox]:
        """OpenVINO person-detection: one tensor of up to 200 rows of 7
        values [image_id, label, conf, x_min, y_min, x_max, y_max]
        (normalized corners). Scanning stops at the first image_id < 0;
        rows below the fixed 0.8 confidence are skipped, and kept boxes
        report class_id -1 / prob 1 — mirroring the reference exactly
        (≙ ovdetection.cc _get_persons_ov, conf threshold :19)."""
        rows = buf.chunks[0].host().reshape(-1, 7).astype(np.float32)
        out: List[DetectedBox] = []
        for r in rows[:200]:
            # int-truncating sentinel compare, like the reference's
            # `(int) desc.image_id < 0` (so -0.5 does NOT stop the scan)
            if int(r[0]) < 0:
                break
            if r[2] < 0.8:
                continue
            out.append(DetectedBox(float(r[3]), float(r[4]),
                                   float(r[5] - r[3]), float(r[6] - r[4]),
                                   -1, 1.0))
        return out

    def _boxes_mp_palm(self, buf: Buffer) -> List[DetectedBox]:
        """MediaPipe palm detection: tensor0 = boxes [N, >=4] (pixel
        offsets vs 192-input anchors), tensor1 = score logits [N]
        (≙ mppalmdetection.cc _get_objects_mp_palm_detection)."""
        boxes = buf.chunks[0].host()
        boxes = boxes.reshape(-1, boxes.shape[-1]).astype(np.float32)
        scores = buf.chunks[1].host().reshape(-1).astype(np.float32)
        n = min(len(boxes), len(scores), len(self._anchors))
        a = self._anchors[:n]  # columns: x_c, y_c, w, h
        score = 1.0 / (1.0 + np.exp(-np.clip(scores[:n], -100, 100)))
        keep = score >= self.conf_threshold
        yc = boxes[:n, 0] / self.in_h * a[:, 3] + a[:, 1]
        xc = boxes[:n, 1] / self.in_w * a[:, 2] + a[:, 0]
        h = boxes[:n, 2] / self.in_h * a[:, 3]
        w = boxes[:n, 3] / self.in_w * a[:, 2]
        out = [DetectedBox(float(xc[i] - w[i] / 2), float(yc[i] - h[i] / 2),
                           float(w[i]), float(h[i]), 0, float(score[i]))
               for i in np.nonzero(keep)[0]]
        return nms(out, self.iou_threshold)

    def decode(self, buf: Buffer) -> Optional[Buffer]:
        if self.mode == "yolov5":
            boxes = self._boxes_yolov5(buf)
        elif self.mode == "yolov8":
            boxes = self._boxes_yolov8(buf)
        elif self.mode in ("mobilenet-ssd-postprocess", "mobilenetssd-pp",
                           "tflite-ssd-postprocess"):
            boxes = self._boxes_ssd_pp(buf)
        elif self.mode in ("mobilenet-ssd", "mobilenetssd", "tflite-ssd"):
            boxes = self._boxes_mobilenet_ssd(buf)
        elif self.mode == "mp-palm-detection":
            boxes = self._boxes_mp_palm(buf)
        elif self.mode == "ov-person-detection":
            boxes = self._boxes_ov_person(buf)
        else:
            raise ValueError(f"bounding_boxes: unknown mode {self.mode!r}")
        frame = draw_boxes(boxes, self.out_w, self.out_h,
                           labels=self._labels)
        out = Buffer([Chunk(frame)])
        out.extras["boxes"] = [
            {"x": b.x, "y": b.y, "w": b.w, "h": b.h, "class": b.cls,
             "label": (self._labels[b.cls] if self._labels and
                       0 <= b.cls < len(self._labels) else str(b.cls)),
             "score": b.score}
            for b in boxes]
        return out
