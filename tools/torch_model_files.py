"""Model files for the imported-model backends, written in-process.

Neither package ships a ``.tflite``, ``.onnx`` or ``.pb`` file and none
is downloaded, so this module writes them: MobileNet-v2 (BatchNorm
folded into the convolutions, except in the GraphDef form) for a width
multiplier and a resolution, with weights drawn from
``np.random.default_rng(seed)``, and one small graph for each op code
the importers lower. It uses the standard library and numpy only and
imports neither ``nnstreamer_tpu`` nor ``nnstreamer_tpu_torch``: its
FlatBuffers and protobuf encoders are written here from the formats'
published rules, so the packages' readers are checked against an
independent writer.

The five MobileNet-v2 forms:

* ``mobilenet_v2_float.tflite``: f32 ``[1,S,S,3]`` -> ``[1,1001]``
  (CONV_2D with fused RELU6, DEPTHWISE_CONV_2D, ADD, AVERAGE_POOL_2D,
  RESHAPE, FULLY_CONNECTED, SOFTMAX);
* ``mobilenet_v2_quant.tflite``: the reference file's signature, u8
  ``[1,S,S,3]`` -> u8 ``[1,1001]``, int8 per-axis weights, int32
  biases, u8 activations whose ranges come from a float calibration run;
* ``mobilenet_v2_float.onnx``: f32 ``[1,3,S,S]`` -> ``[1,1000]`` (Conv,
  Clip, Add, GlobalAveragePool, Flatten, Gemm);
* ``mobilenet_v2_qlinear.onnx``: the same through QuantizeLinear,
  QLinearConv, QLinearAdd, QLinearGlobalAveragePool, QLinearMatMul and
  DequantizeLinear;
* ``mobilenet_v2.pb``: a frozen GraphDef, NHWC, with Conv2D,
  DepthwiseConv2dNative, FusedBatchNormV3 (kept unfolded), Relu6, AddV2,
  Mean, MatMul and BiasAdd.

Use::

    python3 tools/torch_model_files.py OUT_DIR [--width 1.0] [--size 224]

or ``write_mobilenet_v2(out_dir, width, size, seed)`` and
``write_op_case(fmt, name, out_dir, seed)`` after loading this file by
path (``importlib.util.spec_from_file_location``).
"""
from __future__ import annotations

import argparse
import os
import struct
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# FlatBuffers, written front to back
# ---------------------------------------------------------------------------
# A table is written as its vtable, then the table (a signed offset back
# to the vtable and the inline fields), then the objects its offset
# fields point at, so every unsigned offset points forward, as the format
# requires. Vectors carry a u32 length before their elements; strings a
# u32 length and a NUL after the bytes.

_SCALAR = {"u8": "<B", "i8": "<b", "bool": "<B", "u16": "<H", "i16": "<h",
           "i32": "<i", "u32": "<I", "i64": "<q", "f32": "<f"}


class FbTable:
    """``fields``: (field id, kind, value); kind is a scalar kind of
    ``_SCALAR``, or "str", "table", "tables" or "vec:<numpy dtype>"."""

    def __init__(self, fields: Sequence[Tuple[int, str, object]]):
        self.fields = [f for f in fields if f[2] is not None]


class _FbWriter:
    def __init__(self):
        self.out = bytearray()

    def _pad_to(self, align: int, extra: int = 0) -> None:
        while (len(self.out) + extra) % align:
            self.out.append(0)

    def _patch(self, slot: int, target: int) -> None:
        struct.pack_into("<I", self.out, slot, target - slot)

    def put(self, kind: str, value) -> int:
        if kind == "table":
            return self._table(value)
        if kind == "str":
            self._pad_to(4)
            pos = len(self.out)
            data = value.encode("utf-8")
            self.out += struct.pack("<I", len(data)) + data + b"\0"
            return pos
        if kind == "tables":
            self._pad_to(4)
            pos = len(self.out)
            self.out += struct.pack("<I", len(value))
            slots = []
            for _ in value:
                slots.append(len(self.out))
                self.out += b"\0\0\0\0"
            for slot, t in zip(slots, value):
                self._patch(slot, self._table(t))
            return pos
        if kind.startswith("vec:"):
            arr = np.ascontiguousarray(value, dtype=np.dtype(kind[4:])
                                       .newbyteorder("<"))
            # elements 16-aligned: weight buffers can be mapped as is
            self._pad_to(16, extra=4)
            pos = len(self.out)
            self.out += struct.pack("<I", arr.size) + arr.tobytes()
            return pos
        raise ValueError(kind)

    def _table(self, t: FbTable) -> int:
        inline = [(fid, kind, v) for fid, kind, v in t.fields
                  if kind in _SCALAR]
        refs = [(fid, kind, v) for fid, kind, v in t.fields
                if kind not in _SCALAR]
        sized = [(fid, struct.calcsize(_SCALAR[k]), k, v)
                 for fid, k, v in inline] + \
            [(fid, 4, k, v) for fid, k, v in refs]
        sized.sort(key=lambda f: -f[1])
        # field offsets from the table start; the table start sits at
        # 4 mod 8, so the fields after its soffset are 8-aligned
        offsets, cursor = {}, 4
        for fid, size, _, _ in sized:
            while cursor % size != (4 % size if size == 8 else 0):
                cursor += 1
            offsets[fid] = cursor
            cursor += size
        tsize = cursor
        nfields = max((f[0] for f in t.fields), default=-1) + 1
        vt = [4 + 2 * nfields, tsize] + [offsets.get(i, 0)
                                         for i in range(nfields)]
        self._pad_to(2)
        vt_pos = len(self.out)
        self.out += struct.pack(f"<{len(vt)}H", *vt)
        self._pad_to(8, extra=4)
        tpos = len(self.out)
        self.out += bytes(tsize)
        struct.pack_into("<i", self.out, tpos, tpos - vt_pos)
        slots = []
        for fid, size, kind, v in sized:
            at = tpos + offsets[fid]
            if kind in _SCALAR:
                struct.pack_into(_SCALAR[kind], self.out, at, v)
            else:
                slots.append((at, kind, v))
        for at, kind, v in slots:
            self._patch(at, self.put(kind, v))
        return tpos


def flatbuffer(root: FbTable, ident: bytes = b"") -> bytes:
    w = _FbWriter()
    w.out += bytes(4) + ident
    struct.pack_into("<I", w.out, 0, w.put("table", root))
    return bytes(w.out)


# ---------------------------------------------------------------------------
# TFLite (tensorflow/lite/schema/schema.fbs)
# ---------------------------------------------------------------------------

TFL_TYPE = {np.dtype(np.float32): 0, np.dtype(np.float16): 1,
            np.dtype(np.int32): 2, np.dtype(np.uint8): 3,
            np.dtype(np.int64): 4, np.dtype(np.bool_): 6,
            np.dtype(np.int16): 7, np.dtype(np.int8): 9,
            np.dtype(np.float64): 10}

TFL_OPS = {
    "ADD": 0, "AVERAGE_POOL_2D": 1, "CONCATENATION": 2, "CONV_2D": 3,
    "DEPTHWISE_CONV_2D": 4, "DEQUANTIZE": 6, "FULLY_CONNECTED": 9,
    "LOGISTIC": 14, "MAX_POOL_2D": 17, "MUL": 18, "RELU": 19, "RELU6": 21,
    "RESHAPE": 22, "RESIZE_BILINEAR": 23, "SOFTMAX": 25, "TANH": 28,
    "PAD": 34, "TRANSPOSE": 39, "MEAN": 40, "SUB": 41, "DIV": 42,
    "SQUEEZE": 43, "STRIDED_SLICE": 45, "EXP": 47, "LOG_SOFTMAX": 50,
    "CAST": 53, "PRELU": 54, "MAXIMUM": 55, "ARG_MAX": 56, "MINIMUM": 57,
    "SLICE": 65, "TRANSPOSE_CONV": 67, "EXPAND_DIMS": 70, "SUM": 74,
    "SHAPE": 77, "POW": 78, "PACK": 83, "RESIZE_NEAREST_NEIGHBOR": 97,
    "LEAKY_RELU": 98, "SQUARED_DIFFERENCE": 99, "ABS": 101,
    "QUANTIZE": 114, "HARD_SWISH": 117, "BATCH_MATMUL": 126,
    "BROADCAST_TO": 130, "BROADCAST_ARGS": 145,
}

# BuiltinOptions union members used below
_OPT_TYPE = {"CONV_2D": 1, "DEPTHWISE_CONV_2D": 2, "AVERAGE_POOL_2D": 5,
             "MAX_POOL_2D": 5, "FULLY_CONNECTED": 8, "SOFTMAX": 9,
             "CONCATENATION": 10, "ADD": 11, "RESIZE_BILINEAR": 15,
             "RESHAPE": 17, "MUL": 21, "MEAN": 27, "SUM": 27, "SUB": 28,
             "DIV": 29, "SQUEEZE": 30, "STRIDED_SLICE": 32,
             "TRANSPOSE_CONV": 49, "PACK": 59,
             "RESIZE_NEAREST_NEIGHBOR": 74, "LEAKY_RELU": 75,
             "BATCH_MATMUL": 101}

ACT_NONE, ACT_RELU, ACT_RELU6 = 0, 1, 3
SAME, VALID = 0, 1


class TFLiteGraph:
    """One subgraph; ``to_bytes`` writes the model."""

    def __init__(self):
        self.tensors: List[FbTable] = []
        self.buffers: List[Optional[np.ndarray]] = [None]
        self.codes: List[int] = []
        self.ops: List[FbTable] = []
        self.inputs: List[int] = []
        self.outputs: List[int] = []

    def tensor(self, shape, dtype=np.float32, data=None, name="",
               quant: Optional[dict] = None) -> int:
        buf = 0
        if data is not None:
            self.buffers.append(np.ascontiguousarray(
                np.asarray(data, dtype)).view(np.uint8).reshape(-1))
            buf = len(self.buffers) - 1
        q = None
        if quant is not None:
            q = FbTable([
                (2, "vec:float32", np.atleast_1d(quant["scale"])),
                (3, "vec:int64", np.atleast_1d(quant["zero_point"])),
                (6, "i32", int(quant.get("axis", 0)) or None)])
        self.tensors.append(FbTable([
            (0, "vec:int32", np.asarray(shape, np.int32)),
            (1, "u8", TFL_TYPE[np.dtype(dtype)] or None),
            (2, "u32", buf or None),
            (3, "str", name or f"t{len(self.tensors)}"),
            (4, "table", q)]))
        return len(self.tensors) - 1

    def const(self, data, dtype=None, quant=None) -> int:
        arr = np.asarray(data, dtype)
        return self.tensor(arr.shape, arr.dtype, arr, quant=quant)

    def op(self, name: str, inputs, outputs, options=()) -> None:
        code = TFL_OPS[name]
        if code not in self.codes:
            self.codes.append(code)
        self.ops.append(FbTable([
            (0, "u32", self.codes.index(code) or None),
            (1, "vec:int32", np.asarray(inputs, np.int32)),
            (2, "vec:int32", np.asarray(outputs, np.int32)),
            (3, "u8", _OPT_TYPE.get(name) if options else None),
            (4, "table", FbTable(options) if options else None)]))

    def to_bytes(self) -> bytes:
        codes = [FbTable([(0, "i8", min(c, 127)), (2, "i32", 1),
                          (3, "i32", c)]) for c in self.codes]
        sub = FbTable([
            (0, "tables", self.tensors),
            (1, "vec:int32", np.asarray(self.inputs, np.int32)),
            (2, "vec:int32", np.asarray(self.outputs, np.int32)),
            (3, "tables", self.ops),
            (4, "str", "main")])
        bufs = [FbTable([(0, "vec:uint8", b)]) if b is not None
                else FbTable([]) for b in self.buffers]
        model = FbTable([(0, "u32", 3), (1, "tables", codes),
                         (2, "tables", [sub]),
                         (3, "str", "written by tools/torch_model_files.py"),
                         (4, "tables", bufs)])
        return flatbuffer(model, b"TFL3")


# ---------------------------------------------------------------------------
# protobuf (ONNX, GraphDef)
# ---------------------------------------------------------------------------

def _varint(v: int) -> bytes:
    v &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def pb_int(field: int, v: int) -> bytes:
    return _varint(field << 3) + _varint(int(v))


def pb_bytes(field: int, data: bytes) -> bytes:
    return _varint((field << 3) | 2) + _varint(len(data)) + bytes(data)


def pb_str(field: int, s: str) -> bytes:
    return pb_bytes(field, s.encode("utf-8"))


def pb_f32(field: int, v: float) -> bytes:
    return _varint((field << 3) | 5) + struct.pack("<f", v)


# -- ONNX (onnx/onnx.proto) ----------------------------------------------------

ONNX_TYPE = {np.dtype(np.float32): 1, np.dtype(np.uint8): 2,
             np.dtype(np.int8): 3, np.dtype(np.int16): 5,
             np.dtype(np.int32): 6, np.dtype(np.int64): 7,
             np.dtype(np.bool_): 9, np.dtype(np.float16): 10,
             np.dtype(np.float64): 11}


def onnx_tensor(name: str, arr) -> bytes:
    arr = np.asarray(arr)
    msg = b"".join(pb_int(1, d) for d in arr.shape)
    msg += pb_int(2, ONNX_TYPE[arr.dtype]) + pb_str(8, name)
    return msg + pb_bytes(9, np.ascontiguousarray(arr).tobytes())


def onnx_attr(name: str, v) -> bytes:
    msg = pb_str(1, name)
    if isinstance(v, float):
        return msg + pb_f32(2, v) + pb_int(20, 1)
    if isinstance(v, (bool, int, np.integer)):
        return msg + pb_int(3, int(v)) + pb_int(20, 2)
    if isinstance(v, str):
        return msg + pb_bytes(4, v.encode()) + pb_int(20, 3)
    if isinstance(v, np.ndarray):
        return msg + pb_bytes(5, onnx_tensor("", v)) + pb_int(20, 4)
    if v and isinstance(v[0], float):
        return msg + b"".join(pb_f32(7, x) for x in v) + pb_int(20, 6)
    return msg + b"".join(pb_int(8, x) for x in v) + pb_int(20, 7)


def onnx_value_info(name: str, dtype, shape) -> bytes:
    dims = b"".join(pb_bytes(1, pb_int(1, d)) for d in shape)
    tt = pb_int(1, ONNX_TYPE[np.dtype(dtype)]) + pb_bytes(2, dims)
    return pb_str(1, name) + pb_bytes(2, pb_bytes(1, tt))


class OnnxGraph:
    def __init__(self):
        self.nodes: List[bytes] = []
        self.inits: List[bytes] = []
        self.inputs: List[bytes] = []
        self.outputs: List[bytes] = []
        self._n = 0

    def input(self, name, dtype, shape) -> str:
        self.inputs.append(onnx_value_info(name, dtype, shape))
        return name

    def output(self, name, dtype, shape) -> str:
        self.outputs.append(onnx_value_info(name, dtype, shape))
        return name

    def init(self, arr, name: str = "") -> str:
        name = name or f"c{len(self.inits)}"
        self.inits.append(onnx_tensor(name, arr))
        return name

    def node(self, op: str, inputs, outputs=None, domain: str = "",
             **attrs) -> str:
        self._n += 1
        outputs = outputs or [f"{op.lower()}_{self._n}"]
        msg = b"".join(pb_str(1, i) for i in inputs)
        msg += b"".join(pb_str(2, o) for o in outputs)
        msg += pb_str(3, f"n{self._n}") + pb_str(4, op)
        msg += b"".join(pb_bytes(5, onnx_attr(k, v))
                        for k, v in attrs.items())
        if domain:
            msg += pb_str(7, domain)
        self.nodes.append(msg)
        return outputs[0]

    def to_bytes(self) -> bytes:
        g = b"".join(pb_bytes(1, n) for n in self.nodes) + pb_str(2, "main")
        g += b"".join(pb_bytes(5, t) for t in self.inits)
        g += b"".join(pb_bytes(11, v) for v in self.inputs)
        g += b"".join(pb_bytes(12, v) for v in self.outputs)
        opsets = pb_bytes(8, pb_str(1, "") + pb_int(2, 13)) + \
            pb_bytes(8, pb_str(1, "com.microsoft") + pb_int(2, 1))
        return pb_int(1, 8) + pb_str(2, "tools/torch_model_files.py") + \
            pb_bytes(7, g) + opsets


# -- GraphDef (tensorflow/core/framework/graph.proto) ----------------------------

TF_TYPE = {np.dtype(np.float32): 1, np.dtype(np.int32): 3,
           np.dtype(np.int64): 9}


def tf_attr(v) -> bytes:
    """An AttrValue: type (a numpy dtype), shape ("shape", dims), tensor
    (ndarray), bool, int, float, string or a list of ints."""
    if isinstance(v, np.dtype):
        return pb_int(6, TF_TYPE[v])
    if isinstance(v, tuple) and v and v[0] == "shape":
        return pb_bytes(7, b"".join(pb_bytes(2, pb_int(1, d))
                                    for d in v[1]))
    if isinstance(v, np.ndarray):
        shp = b"".join(pb_bytes(2, pb_int(1, d)) for d in v.shape)
        tp = pb_int(1, TF_TYPE[v.dtype]) + pb_bytes(2, shp) + \
            pb_bytes(4, np.ascontiguousarray(v).tobytes())
        return pb_bytes(8, tp)
    if isinstance(v, bool):
        return pb_int(5, int(v))
    if isinstance(v, int):
        return pb_int(3, v)
    if isinstance(v, float):
        return pb_f32(4, v)
    if isinstance(v, str):
        return pb_str(2, v)
    return pb_bytes(1, b"".join(pb_int(3, x) for x in v))


class TfGraph:
    def __init__(self):
        self.nodes: List[bytes] = []
        self._n = 0

    def node(self, op: str, inputs=(), name: str = "", **attrs) -> str:
        self._n += 1
        name = name or f"{op.lower()}_{self._n}"
        msg = pb_str(1, name) + pb_str(2, op)
        msg += b"".join(pb_str(3, i) for i in inputs)
        msg += b"".join(pb_bytes(5, pb_str(1, k) + pb_bytes(2, tf_attr(v)))
                        for k, v in attrs.items())
        self.nodes.append(pb_bytes(1, msg))
        return name

    def placeholder(self, shape, name="input") -> str:
        return self.node("Placeholder", name=name,
                         dtype=np.dtype(np.float32), shape=("shape", shape))

    def const(self, arr, name: str = "") -> str:
        arr = np.asarray(arr)
        return self.node("Const", name=name, value=arr, dtype=arr.dtype)

    def to_bytes(self) -> bytes:
        return b"".join(self.nodes)


# ---------------------------------------------------------------------------
# MobileNet-v2
# ---------------------------------------------------------------------------

# (expansion t, channels c, repeats n, first stride s)
_BLOCKS = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
           (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))


def _divisible(v: float, d: int = 8) -> int:
    new = max(d, int(v + d / 2) // d * d)
    return new + d if new < 0.9 * v else new


def mobilenet_v2_spec(width: float) -> List[dict]:
    """The layers, in order: {"kind": conv|dw|add_from|pool|fc, ...}."""
    layers = [dict(kind="conv", k=3, s=2, cin=3,
                   cout=_divisible(32 * width), relu6=True)]
    cin = layers[0]["cout"]
    for t, c, n, s in _BLOCKS:
        cout = _divisible(c * width)
        for i in range(n):
            stride = s if i == 0 else 1
            start = len(layers)
            hidden = cin * t
            if t != 1:
                layers.append(dict(kind="conv", k=1, s=1, cin=cin,
                                   cout=hidden, relu6=True))
            layers.append(dict(kind="dw", k=3, s=stride, cin=hidden,
                               cout=hidden, relu6=True))
            layers.append(dict(kind="conv", k=1, s=1, cin=hidden,
                               cout=cout, relu6=False))
            if stride == 1 and cin == cout:
                layers.append(dict(kind="add_from", at=start))
            cin = cout
    last = _divisible(1280 * width) if width > 1.0 else 1280
    layers.append(dict(kind="conv", k=1, s=1, cin=cin, cout=last,
                       relu6=True))
    layers.append(dict(kind="pool"))
    layers.append(dict(kind="fc", cin=last))
    return layers


def mobilenet_v2_weights(width: float, classes: int, seed: int):
    """Folded conv weights (HWIO for conv, HW-C for depthwise) and biases,
    with the BatchNorm each folds kept beside it (the GraphDef form keeps
    it unfolded), and the classifier."""
    rng = np.random.default_rng(seed)
    spec = mobilenet_v2_spec(width)
    params = []
    for layer in spec:
        if layer["kind"] in ("conv", "dw"):
            k, cin, cout = layer["k"], layer["cin"], layer["cout"]
            fan_in = k * k * (1 if layer["kind"] == "dw" else cin)
            shape = (k, k, cout) if layer["kind"] == "dw" else (k, k, cin,
                                                                  cout)
            w = rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)
            gamma = rng.uniform(0.5, 1.0, cout)
            beta = rng.uniform(-0.1, 0.1, cout)
            mean = rng.uniform(-0.1, 0.1, cout)
            var = rng.uniform(0.5, 1.5, cout)
            eps = 1e-3
            inv = gamma / np.sqrt(var + eps)
            params.append(dict(
                w=w.astype(np.float32), bn=(gamma, beta, mean, var, eps),
                wf=(w * inv).astype(np.float32),
                bf=(beta - mean * inv).astype(np.float32)))
        elif layer["kind"] == "fc":
            cin = layer["cin"]
            params.append(dict(
                w=(rng.standard_normal((cin, classes)) / np.sqrt(cin))
                .astype(np.float32),
                b=rng.uniform(-0.1, 0.1, classes).astype(np.float32)))
        else:
            params.append(None)
    return spec, params


# -- a float forward in numpy: calibrates the quantized forms --------------------

def _same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    out = -(-n // s)
    need = max(0, (out - 1) * s + k - n)
    return need // 2, need - need // 2


def np_conv_nhwc(x, w_hwio, b, s, depthwise=False):
    k = w_hwio.shape[0]
    (pt, pb), (pl, pr) = _same_pads(x.shape[1], k, s), \
        _same_pads(x.shape[2], k, s)
    xp = np.pad(x, ((0, 0), (pt, pb), (pl, pr), (0, 0)))
    oh = (xp.shape[1] - k) // s + 1
    ow = (xp.shape[2] - k) // s + 1
    acc = 0.0
    for dy in range(k):
        for dx in range(k):
            patch = xp[:, dy:dy + (oh - 1) * s + 1:s,
                       dx:dx + (ow - 1) * s + 1:s, :]
            acc = acc + (patch * w_hwio[dy, dx] if depthwise
                         else patch @ w_hwio[dy, dx])
    return acc + b


def np_mobilenet_v2(x, spec, params, record=None):
    """x: f32 NHWC. ``record`` (a list) gets every layer's output."""
    outs = []
    for layer, p in zip(spec, params):
        kind = layer["kind"]
        if kind in ("conv", "dw"):
            w = p["wf"]
            y = np_conv_nhwc(x, w, p["bf"], layer["s"], kind == "dw")
            if layer["relu6"]:
                y = np.clip(y, 0.0, 6.0)
        elif kind == "add_from":
            y = x + outs[layer["at"] - 1]
        elif kind == "pool":
            y = x.mean(axis=(1, 2))
        else:
            y = x @ p["w"] + p["b"]
        outs.append(y)
        x = y
    if record is not None:
        record.extend(outs)
    return x


def _spread_logits(spec, params, size, rng) -> None:
    """Scale the classifier so the logits spread (std 4) on random
    frames: a softmax over 1001 random-weight logits is otherwise flat,
    and its u8 quantization all zero."""
    x = rng.uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    logits = np_mobilenet_v2(x, spec, params)
    f = 4.0 / max(float(logits.std()), 1e-6)
    params[-1]["w"] = (params[-1]["w"] * f).astype(np.float32)
    params[-1]["b"] = (params[-1]["b"] * f).astype(np.float32)


def _u8_range(lo: float, hi: float) -> Tuple[float, int]:
    """(scale, zero point) of an asymmetric u8 range holding [lo, hi]."""
    lo, hi = min(lo, 0.0), max(hi, 0.0)
    scale = max(hi - lo, 1e-6) / 255.0
    return float(np.float32(scale)), int(np.clip(round(-lo / scale), 0, 255))


def _i8_axis(w: np.ndarray, axis: int):
    """Symmetric int8 per-axis quantization: (q, scales)."""
    red = tuple(i for i in range(w.ndim) if i != axis)
    scale = np.maximum(np.abs(w).max(axis=red), 1e-8) / 127.0
    shape = [1] * w.ndim
    shape[axis] = -1
    q = np.clip(np.round(w / scale.reshape(shape)), -127, 127)
    return q.astype(np.int8), scale.astype(np.float32)


def _calibrate(spec, params, size, rng):
    """Each layer's output range on a few uniform frames in [-1, 1]."""
    x = rng.uniform(-1, 1, (4, size, size, 3)).astype(np.float32)
    rec: List[np.ndarray] = []
    np_mobilenet_v2(x, spec, params, rec)
    return [(float(r.min()), float(r.max())) for r in rec]


def _tflite_mobilenet(spec, params, size, classes, quant, ranges) -> bytes:
    g = TFLiteGraph()
    in_q = None
    if quant:
        in_q = dict(scale=np.float32(1 / 127.5), zero_point=128)
    g.inputs = [g.tensor((1, size, size, 3),
                         np.uint8 if quant else np.float32,
                         name="input", quant=in_q)]
    x, hw, prev = g.inputs[0], size, []
    in_scale = in_q["scale"] if quant else None
    for i, (layer, p) in enumerate(zip(spec, params)):
        kind = layer["kind"]
        q = None
        if quant and kind != "fc":
            lo, hi = ranges[i]
            if kind in ("conv", "dw") and layer["relu6"]:
                lo, hi = 0.0, min(hi, 6.0)
            s, zp = _u8_range(lo, hi)
            q = dict(scale=np.float32(s), zero_point=zp)
        if kind in ("conv", "dw"):
            hw = -(-hw // layer["s"])
            c = layer["cout"]
            if kind == "conv":
                w = np.transpose(p["wf"], (3, 0, 1, 2))  # OHWI
                axis = 0
            else:
                w = p["wf"][None]                         # 1,H,W,C
                axis = 3
            if quant:
                wq, ws = _i8_axis(w, axis)
                wt = g.const(wq, quant=dict(scale=ws, zero_point=np.zeros(
                    c, np.int64), axis=axis))
                bscale = (in_scale * ws).astype(np.float32)
                bt = g.const(np.round(p["bf"] / bscale).astype(np.int32),
                             quant=dict(scale=bscale, zero_point=np.zeros(
                                 c, np.int64)))
            else:
                wt, bt = g.const(w), g.const(p["bf"])
            y = g.tensor((1, hw, hw, c), np.uint8 if quant else np.float32,
                         quant=q)
            act = ACT_RELU6 if layer["relu6"] else ACT_NONE
            if kind == "conv":
                g.op("CONV_2D", [x, wt, bt], [y], [
                    (0, "i8", SAME), (1, "i32", layer["s"]),
                    (2, "i32", layer["s"]), (3, "i8", act)])
            else:
                g.op("DEPTHWISE_CONV_2D", [x, wt, bt], [y], [
                    (0, "i8", SAME), (1, "i32", layer["s"]),
                    (2, "i32", layer["s"]), (3, "i32", 1), (4, "i8", act)])
        elif kind == "add_from":
            other = prev[layer["at"] - 1]
            c = spec[i - 1]["cout"]
            y = g.tensor((1, hw, hw, c), np.uint8 if quant else np.float32,
                         quant=q)
            g.op("ADD", [other, x], [y], [(0, "i8", ACT_NONE)])
        elif kind == "pool":
            c = spec[i - 1]["cout"]
            pooled = g.tensor((1, 1, 1, c),
                              np.uint8 if quant else np.float32, quant=q)
            g.op("AVERAGE_POOL_2D", [x], [pooled], [
                (0, "i8", VALID), (1, "i32", 1), (2, "i32", 1),
                (3, "i32", hw), (4, "i32", hw), (5, "i8", ACT_NONE)])
            y = g.tensor((1, c), np.uint8 if quant else np.float32, quant=q)
            g.op("RESHAPE", [pooled, g.const(np.array([1, c], np.int32))],
                 [y], [(0, "vec:int32", np.array([1, c], np.int32))])
        else:  # classifier + softmax
            w = np.ascontiguousarray(p["w"].T)               # [out, in]
            logits_q = prob_q = None
            if quant:
                wq, ws = _i8_axis(w, 0)
                wt = g.const(wq, quant=dict(scale=ws, zero_point=np.zeros(
                    classes, np.int64)))
                bscale = (in_scale * ws).astype(np.float32)
                bt = g.const(np.round(p["b"] / bscale).astype(np.int32),
                             quant=dict(scale=bscale, zero_point=np.zeros(
                                 classes, np.int64)))
                s, zp = _u8_range(*ranges[i])
                logits_q = dict(scale=np.float32(s), zero_point=zp)
                prob_q = dict(scale=np.float32(1 / 256),
                                      zero_point=0)
            else:
                wt, bt = g.const(w), g.const(p["b"])
            dt = np.uint8 if quant else np.float32
            logits = g.tensor((1, classes), dt, quant=logits_q)
            g.op("FULLY_CONNECTED", [x, wt, bt], [logits],
                 [(0, "i8", ACT_NONE)])
            y = g.tensor((1, classes), dt, name="output", quant=prob_q)
            g.op("SOFTMAX", [logits], [y], [(0, "f32", 1.0)])
        if q is not None:
            in_scale = np.float32(q["scale"])
        prev.append(y)
        x = y
    g.outputs = [x]
    return g.to_bytes()


def _onnx_mobilenet(spec, params, size, classes, qlinear, ranges) -> bytes:
    """NCHW. The classifier drops the TFLite form's background class
    (1000 outputs) and its softmax, as ONNX model-zoo files do."""
    g = OnnxGraph()
    g.input("input", np.float32, (1, 3, size, size))
    x = "input"
    lo6, hi6 = g.init(np.float32(0.0), "zero"), g.init(np.float32(6.0),
                                                         "six")
    if qlinear:
        xs, xz = g.init(np.float32(1 / 127.5), "in_scale"), \
            g.init(np.uint8(128), "in_zp")
        x = g.node("QuantizeLinear", [x, xs, xz])
        qparams = (xs, xz, 1 / 127.5)
    outs = []
    for i, (layer, p) in enumerate(zip(spec, params)):
        kind = layer["kind"]
        if qlinear and kind != "fc":
            lo, hi = ranges[i]
            if kind in ("conv", "dw") and layer["relu6"]:
                lo, hi = 0.0, min(hi, 6.0)
            s, zp = _u8_range(lo, hi)
            ys, yz = g.init(np.float32(s)), g.init(np.uint8(zp))
        if kind in ("conv", "dw"):
            c = layer["cout"]
            if kind == "conv":
                w = np.transpose(p["wf"], (3, 2, 0, 1))      # OIHW
                group = 1
            else:
                w = np.transpose(p["wf"], (2, 0, 1))[:, None]  # C,1,H,W
                group = c
            k, st = layer["k"], layer["s"]
            attrs = dict(kernel_shape=[k, k], strides=[st, st],
                         group=group, auto_pad="SAME_UPPER")
            if qlinear:
                wq, ws = _i8_axis(w, 0)
                xs_, xz_, x_scale = qparams
                bias = np.round(p["bf"] / (x_scale * ws)).astype(np.int32)
                x = g.node("QLinearConv", [
                    x, xs_, xz_, g.init(wq), g.init(ws),
                    g.init(np.zeros(c, np.int8)), ys, yz, g.init(bias)],
                    **attrs)
                qparams = (ys, yz, s)
            else:
                x = g.node("Conv", [x, g.init(w), g.init(p["bf"])], **attrs)
                if layer["relu6"]:
                    x = g.node("Clip", [x, lo6, hi6])
        elif kind == "add_from":
            other, oq = outs[layer["at"] - 1]
            if qlinear:
                x = g.node("QLinearAdd", [other, oq[0], oq[1], x,
                                          qparams[0], qparams[1], ys, yz],
                           domain="com.microsoft")
                qparams = (ys, yz, s)
            else:
                x = g.node("Add", [other, x])
        elif kind == "pool":
            if qlinear:
                x = g.node("QLinearGlobalAveragePool", [
                    x, qparams[0], qparams[1], ys, yz],
                    domain="com.microsoft", channels_last=0)
                qparams = (ys, yz, s)
            else:
                x = g.node("GlobalAveragePool", [x])
            x = g.node("Flatten", [x], axis=1)
        else:
            w = p["w"][:, 1:]                      # [in, 1000]
            b = p["b"][1:]
            if qlinear:
                # per-tensor weight scale for QLinearMatMul
                ws = np.float32(np.abs(w).max() / 127.0)
                wq = np.clip(np.round(w / ws), -127, 127).astype(np.int8)
                s, zp = _u8_range(*ranges[i])
                ms, mz = g.init(np.float32(s)), g.init(np.uint8(zp))
                x = g.node("QLinearMatMul", [
                    x, qparams[0], qparams[1], g.init(wq), g.init(ws),
                    g.init(np.int8(0)), ms, mz])
                bs = np.float32(max(np.abs(b).max(), 1e-6) / 127.0)
                bq = np.clip(np.round(b / bs) + 128, 0, 255).astype(np.uint8)
                x = g.node("QLinearAdd", [
                    x, ms, mz, g.init(bq), g.init(bs), g.init(np.uint8(128)),
                    ms, mz], domain="com.microsoft")
                x = g.node("DequantizeLinear", [x, ms, mz],
                           outputs=["output"])
            else:
                x = g.node("Gemm", [x, g.init(w), g.init(b)],
                           outputs=["output"])
        outs.append((x, qparams if qlinear else None))
    g.output("output", np.float32, (1, classes - 1))
    return g.to_bytes()


def _graphdef_mobilenet(spec, params, size, classes) -> bytes:
    g = TfGraph()
    x = g.placeholder((1, size, size, 3))
    outs = []
    for layer, p in zip(spec, params):
        kind = layer["kind"]
        if kind in ("conv", "dw"):
            st = layer["s"]
            if kind == "conv":
                x = g.node("Conv2D", [x, g.const(p["w"])],
                           strides=[1, st, st, 1], padding="SAME",
                           data_format="NHWC", T=np.dtype(np.float32))
            else:
                x = g.node("DepthwiseConv2dNative",
                           [x, g.const(p["w"][:, :, :, None])],
                           strides=[1, st, st, 1], padding="SAME",
                           T=np.dtype(np.float32))
            gamma, beta, mean, var, eps = (np.float32(v) if np.isscalar(v)
                                           else v.astype(np.float32)
                                           for v in p["bn"])
            x = g.node("FusedBatchNormV3", [
                x, g.const(gamma), g.const(beta), g.const(mean),
                g.const(var)], epsilon=float(eps), is_training=False)
            if layer["relu6"]:
                x = g.node("Relu6", [x + ":0"])
        elif kind == "add_from":
            x = g.node("AddV2", [outs[layer["at"] - 1], x])
        elif kind == "pool":
            x = g.node("Mean", [x, g.const(np.array([1, 2], np.int32))],
                       keep_dims=False)
        else:
            x = g.node("MatMul", [x, g.const(p["w"])])
            x = g.node("BiasAdd", [x, g.const(p["b"])], name="logits")
        outs.append(x)
    return g.to_bytes()


MOBILENET_FILES = {
    "tflite": "mobilenet_v2_float.tflite",
    "tflite_u8": "mobilenet_v2_quant.tflite",
    "onnx": "mobilenet_v2_float.onnx",
    "onnx_qlinear": "mobilenet_v2_qlinear.onnx",
    "pb": "mobilenet_v2.pb",
}


def write_mobilenet_v2(out_dir: str, width: float = 1.0, size: int = 224,
                       seed: int = 0,
                       forms: Sequence[str] = tuple(MOBILENET_FILES)
                       ) -> Dict[str, str]:
    """Write the MobileNet-v2 forms into ``out_dir``; returns form ->
    path. 1001 classes (class 0 is the background class), as the
    reference's TFLite files."""
    classes = 1001
    spec, params = mobilenet_v2_weights(width, classes, seed)
    rng = np.random.default_rng(seed + 1)
    _spread_logits(spec, params, size, rng)
    ranges = None
    if any(f in forms for f in ("tflite_u8", "onnx_qlinear")):
        ranges = _calibrate(spec, params, size, rng)
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for form in forms:
        if form in ("tflite", "tflite_u8"):
            data = _tflite_mobilenet(spec, params, size, classes,
                                     form == "tflite_u8", ranges)
        elif form in ("onnx", "onnx_qlinear"):
            data = _onnx_mobilenet(spec, params, size, classes,
                                   form == "onnx_qlinear", ranges)
        else:
            data = _graphdef_mobilenet(spec, params, size, classes)
        paths[form] = os.path.join(out_dir, MOBILENET_FILES[form])
        with open(paths[form], "wb") as f:
            f.write(data)
    return paths


# ---------------------------------------------------------------------------
# one small graph for each op code the importers lower
# ---------------------------------------------------------------------------
# A case returns (file bytes, inputs). Inputs are drawn from the rng the
# caller seeds; constants too.

def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _tfl_unary(name, options=(), scale=2.0, positive=False):
    def case(rng):
        g = TFLiteGraph()
        x = _f32(rng, 2, 3, 4, scale=scale)
        if positive:
            x = np.abs(x) + 0.5
        g.inputs = [g.tensor(x.shape)]
        g.outputs = [g.tensor(x.shape)]
        g.op(name, g.inputs, g.outputs, options)
        return g.to_bytes(), [x]
    return case


def _tfl_binary(name, act=None, positive_b=False, const_b=False):
    def case(rng):
        g = TFLiteGraph()
        a = _f32(rng, 1, 4, 4, 3)
        b = _f32(rng, 1, 4, 4, 3) if not const_b else _f32(rng, 3)
        if positive_b:
            a = np.abs(a) + 0.5
            b = np.abs(b) * 0.5 + 0.5
        g.inputs = [g.tensor(a.shape)]
        bt = g.const(b) if const_b else g.tensor(b.shape)
        if not const_b:
            g.inputs.append(bt)
        g.outputs = [g.tensor(a.shape)]
        opts = [(0, "i8", act)] if act is not None else ()
        g.op(name, [g.inputs[0], bt], g.outputs, opts)
        return g.to_bytes(), [a] if const_b else [a, b]
    return case


def _tfl_conv(rng):
    g = TFLiteGraph()
    x = _f32(rng, 1, 7, 7, 3)
    g.inputs = [g.tensor(x.shape)]
    w, b = g.const(_f32(rng, 5, 3, 3, 3)), g.const(_f32(rng, 5))
    g.outputs = [g.tensor((1, 4, 4, 5))]
    g.op("CONV_2D", [g.inputs[0], w, b], g.outputs,
         [(0, "i8", SAME), (1, "i32", 2), (2, "i32", 2),
          (3, "i8", ACT_RELU)])
    return g.to_bytes(), [x]


def _tfl_dwconv(rng):
    g = TFLiteGraph()
    x = _f32(rng, 1, 7, 7, 4)
    g.inputs = [g.tensor(x.shape)]
    w, b = g.const(_f32(rng, 1, 3, 3, 8)), g.const(_f32(rng, 8))
    g.outputs = [g.tensor((1, 4, 4, 8))]
    g.op("DEPTHWISE_CONV_2D", [g.inputs[0], w, b], g.outputs,
         [(0, "i8", SAME), (1, "i32", 2), (2, "i32", 2), (3, "i32", 2),
          (4, "i8", ACT_RELU6)])
    return g.to_bytes(), [x]


def _tfl_fc(rng):
    g = TFLiteGraph()
    x = _f32(rng, 2, 3, 4)
    g.inputs = [g.tensor(x.shape)]
    w, b = g.const(_f32(rng, 5, 4)), g.const(_f32(rng, 5))
    g.outputs = [g.tensor((6, 5))]
    g.op("FULLY_CONNECTED", [g.inputs[0], w, b], g.outputs,
         [(0, "i8", ACT_NONE)])
    return g.to_bytes(), [x]


def _tfl_pool(name):
    def case(rng):
        g = TFLiteGraph()
        x = _f32(rng, 1, 7, 7, 3)
        g.inputs = [g.tensor(x.shape)]
        g.outputs = [g.tensor((1, 4, 4, 3))]
        g.op(name, g.inputs, g.outputs,
             [(0, "i8", SAME), (1, "i32", 2), (2, "i32", 2),
              (3, "i32", 3), (4, "i32", 3), (5, "i8", ACT_NONE)])
        return g.to_bytes(), [x]
    return case


def _tfl_with_consts(name, x_shape, consts, out_shape, options=(),
                     out_dtype=np.float32, x_dtype=np.float32, scale=1.0):
    """One op over a runtime input and constant operands."""
    def case(rng):
        g = TFLiteGraph()
        x = _f32(rng, *x_shape, scale=scale).astype(x_dtype)
        g.inputs = [g.tensor(x.shape, x_dtype)]
        ins = [g.inputs[0]] + [g.const(c) for c in consts]
        g.outputs = [g.tensor(out_shape, out_dtype)]
        g.op(name, ins, g.outputs, options)
        return g.to_bytes(), [x]
    return case


def _tfl_two_inputs(name, shapes, out_shape, options=()):
    def case(rng):
        g = TFLiteGraph()
        xs = [_f32(rng, *s) for s in shapes]
        g.inputs = [g.tensor(x.shape) for x in xs]
        g.outputs = [g.tensor(out_shape)]
        g.op(name, g.inputs, g.outputs, options)
        return g.to_bytes(), xs
    return case


def _tfl_dequantize(rng):
    g = TFLiteGraph()
    x = rng.integers(0, 256, (2, 5), dtype=np.uint8)
    g.inputs = [g.tensor(x.shape, np.uint8,
                         quant=dict(scale=np.float32(0.05), zero_point=100))]
    g.outputs = [g.tensor(x.shape)]
    g.op("DEQUANTIZE", g.inputs, g.outputs)
    return g.to_bytes(), [x]


def _tfl_quantize(rng):
    g = TFLiteGraph()
    x = _f32(rng, 2, 5, scale=3.0)
    g.inputs = [g.tensor(x.shape)]
    g.outputs = [g.tensor(x.shape, np.uint8,
                          quant=dict(scale=np.float32(0.02), zero_point=128))]
    g.op("QUANTIZE", g.inputs, g.outputs)
    return g.to_bytes(), [x]


def _tfl_shape(rng):
    g = TFLiteGraph()
    x = _f32(rng, 2, 3, 4)
    g.inputs = [g.tensor(x.shape)]
    g.outputs = [g.tensor((3,), np.int32)]
    g.op("SHAPE", g.inputs, g.outputs)
    return g.to_bytes(), [x]


def _tfl_broadcast_args(rng):
    g = TFLiteGraph()
    x = _f32(rng, 1, 3)
    g.inputs = [g.tensor(x.shape)]
    shape = g.tensor((3,), np.int32)
    g.op("BROADCAST_ARGS", [g.const(np.array([2, 1, 3], np.int32)),
                            g.const(np.array([1, 3], np.int32))], [shape])
    g.outputs = [g.tensor((2, 1, 3))]
    g.op("BROADCAST_TO", [g.inputs[0], shape], g.outputs)
    return g.to_bytes(), [x]


def _tfl_transpose_conv(cin, cout):
    def case(rng):
        g = TFLiteGraph()
        x = _f32(rng, 1, 3, 3, cin)
        g.inputs = [g.tensor(x.shape)]
        ins = [g.const(np.array([1, 6, 6, cout], np.int32)),
               g.const(_f32(rng, cout, 3, 3, cin)), g.inputs[0],
               g.const(_f32(rng, cout))]
        g.outputs = [g.tensor((1, 6, 6, cout))]
        g.op("TRANSPOSE_CONV", ins, g.outputs,
             [(0, "i8", SAME), (1, "i32", 2), (2, "i32", 2)])
        return g.to_bytes(), [x]
    return case


def _tfl_resize(name, align, half, out_hw=(5, 7), in_hw=(3, 4)):
    fa, fh = (2, 3) if name == "RESIZE_BILINEAR" else (0, 1)

    def case(rng):
        return _tfl_with_consts(
            name, (1, *in_hw, 2), [np.array(out_hw, np.int32)],
            (1, *out_hw, 2),
            [(fa, "bool", int(align) or None),
             (fh, "bool", int(half) or None)])(rng)
    return case


TFLITE_CASES: Dict[str, Callable] = {
    "CONV_2D": _tfl_conv,
    "DEPTHWISE_CONV_2D": _tfl_dwconv,
    "FULLY_CONNECTED": _tfl_fc,
    "ADD": _tfl_binary("ADD", act=ACT_RELU, const_b=True),
    "SUB": _tfl_binary("SUB", act=ACT_NONE),
    "MUL": _tfl_binary("MUL", act=ACT_RELU6),
    "DIV": _tfl_binary("DIV", act=ACT_NONE, positive_b=True),
    "MAXIMUM": _tfl_binary("MAXIMUM"),
    "MINIMUM": _tfl_binary("MINIMUM"),
    "POW": _tfl_binary("POW", positive_b=True),
    "SQUARED_DIFFERENCE": _tfl_binary("SQUARED_DIFFERENCE"),
    "AVERAGE_POOL_2D": _tfl_pool("AVERAGE_POOL_2D"),
    "MAX_POOL_2D": _tfl_pool("MAX_POOL_2D"),
    "RESHAPE": _tfl_with_consts(
        "RESHAPE", (1, 2, 3, 4), [np.array([2, -1], np.int32)], (2, 12)),
    "SQUEEZE": _tfl_with_consts(
        "SQUEEZE", (1, 3, 1, 4), [], (1, 3, 4),
        [(0, "vec:int32", np.array([2], np.int32))]),
    "EXPAND_DIMS": _tfl_with_consts(
        "EXPAND_DIMS", (3, 4), [np.array(1, np.int32)], (3, 1, 4)),
    "SOFTMAX": _tfl_unary("SOFTMAX", [(0, "f32", 0.5)]),
    "LOG_SOFTMAX": _tfl_unary("LOG_SOFTMAX"),
    "CONCATENATION": _tfl_two_inputs(
        "CONCATENATION", [(1, 2, 2, 3), (1, 2, 2, 2)], (1, 2, 2, 5),
        [(0, "i32", 3), (1, "i8", ACT_RELU)]),
    "RESIZE_BILINEAR": _tfl_resize("RESIZE_BILINEAR", False, True),
    "RESIZE_NEAREST_NEIGHBOR": _tfl_resize(
        "RESIZE_NEAREST_NEIGHBOR", False, True),
    "PAD": _tfl_with_consts(
        "PAD", (1, 3, 3, 2),
        [np.array([[0, 0], [1, 2], [2, 1], [0, 0]], np.int32)],
        (1, 6, 6, 2)),
    "MEAN": _tfl_with_consts(
        "MEAN", (1, 4, 4, 3), [np.array([1, 2], np.int32)], (1, 1, 1, 3),
        [(0, "bool", 1)]),
    "SUM": _tfl_with_consts(
        "SUM", (1, 4, 4, 3), [np.array([2], np.int32)], (1, 4, 3)),
    "TRANSPOSE": _tfl_with_consts(
        "TRANSPOSE", (2, 3, 4), [np.array([2, 0, 1], np.int32)], (4, 2, 3)),
    "RELU": _tfl_unary("RELU"),
    "RELU6": _tfl_unary("RELU6", scale=5.0),
    "LOGISTIC": _tfl_unary("LOGISTIC"),
    "TANH": _tfl_unary("TANH"),
    "HARD_SWISH": _tfl_unary("HARD_SWISH", scale=3.0),
    "LEAKY_RELU": _tfl_unary("LEAKY_RELU", [(0, "f32", 0.2)]),
    "PRELU": _tfl_with_consts(
        "PRELU", (1, 3, 3, 2), [np.array([0.1, 0.3], np.float32)],
        (1, 3, 3, 2)),
    "ABS": _tfl_unary("ABS"),
    "EXP": _tfl_unary("EXP", scale=1.0),
    "ARG_MAX": _tfl_with_consts(
        "ARG_MAX", (2, 5), [np.array(1, np.int32)], (2,),
        out_dtype=np.int32),
    "CAST": _tfl_with_consts("CAST", (2, 3), [], (2, 3),
                             out_dtype=np.int32, scale=10.0),
    "DEQUANTIZE": _tfl_dequantize,
    "QUANTIZE": _tfl_quantize,
    "SHAPE": _tfl_shape,
    "BROADCAST_ARGS": _tfl_broadcast_args,
    "BROADCAST_TO": _tfl_with_consts(
        "BROADCAST_TO", (1, 3), [np.array([2, 4, 3], np.int32)], (2, 4, 3)),
    "PACK": _tfl_two_inputs("PACK", [(2, 3), (2, 3)], (2, 2, 3),
                            [(0, "i32", 2), (1, "i32", 1)]),
    "SLICE": _tfl_with_consts(
        "SLICE", (3, 4, 5), [np.array([1, 0, 2], np.int32),
                             np.array([2, -1, 2], np.int32)], (2, 4, 2)),
    "STRIDED_SLICE": _tfl_with_consts(
        "STRIDED_SLICE", (4, 6, 3), [np.array([1, 0, 1], np.int32),
                                     np.array([4, 5, 2], np.int32),
                                     np.array([2, 2, 1], np.int32)],
        (2, 3), [(1, "i32", 2), (4, "i32", 4)]),
    "BATCH_MATMUL": _tfl_two_inputs(
        "BATCH_MATMUL", [(2, 3, 4), (2, 5, 4)], (2, 3, 5),
        [(1, "bool", 1)]),
    "TRANSPOSE_CONV": _tfl_transpose_conv(2, 3),
}

# cases kept apart from the op table: where the JAX importer departs
# from TFLite, and a second STRIDED_SLICE (see tests/test_torch_interop.py)
TFLITE_EXTRA_CASES: Dict[str, Callable] = {
    "TRANSPOSE_CONV_square": _tfl_transpose_conv(2, 2),
    "RESIZE_NEAREST_NEIGHBOR_default": _tfl_resize(
        "RESIZE_NEAREST_NEIGHBOR", False, False, out_hw=(2, 6),
        in_hw=(4, 4)),
    "STRIDED_SLICE_backward": _tfl_with_consts(
        "STRIDED_SLICE", (4, 6, 3), [np.array([3, -1, 0], np.int32),
                                     np.array([0, 0, 2], np.int32),
                                     np.array([-1, -2, 1], np.int32)],
        (3, 3, 2), [(1, "i32", 2)]),    # end_mask on axis 1
}


# -- ONNX op cases ---------------------------------------------------------------

def _ox_single(op, x_shapes, out_shape, consts=(), attrs=None, domain="",
               positive=False, scale=1.0, out_dtype=np.float32,
               x_dtype=np.float32):
    def case(rng):
        g = OnnxGraph()
        xs = []
        names = []
        for i, s in enumerate(x_shapes):
            x = _f32(rng, *s, scale=scale)
            if positive:
                x = np.abs(x) + 0.5
            x = x.astype(x_dtype)
            xs.append(x)
            names.append(g.input(f"x{i}", x_dtype, s))
        names += [g.init(c) if c is not None else "" for c in consts]
        g.node(op, names, outputs=["y"], domain=domain, **(attrs or {}))
        g.output("y", out_dtype, out_shape)
        return g.to_bytes(), xs
    return case


def _ox_qlinear(op, rng_shapes, make):
    """f32 -> QuantizeLinear -> <op> -> DequantizeLinear -> f32."""
    def case(rng):
        g = OnnxGraph()
        xs, qs = [], []
        for i, s in enumerate(rng_shapes):
            xs.append(_f32(rng, *s))
            xq = g.node("QuantizeLinear", [
                g.input(f"x{i}", np.float32, s),
                g.init(np.float32(0.02)), g.init(np.uint8(128))])
            qs.append(xq)
        ys, yz = g.init(np.float32(0.03)), g.init(np.uint8(120))
        y, out_shape = make(g, rng, qs, ys, yz)
        g.node("DequantizeLinear", [y, ys, yz], outputs=["y"])
        g.output("y", np.float32, out_shape)
        return g.to_bytes(), xs
    return case


def _qconv(g, rng, qs, ys, yz):
    w = rng.integers(-127, 128, (4, 3, 3, 3), dtype=np.int8)
    ws = (rng.uniform(0.005, 0.02, 4)).astype(np.float32)
    bias = rng.integers(-500, 500, 4, dtype=np.int32)
    y = g.node("QLinearConv", [
        qs[0], g.init(np.float32(0.02)), g.init(np.uint8(128)), g.init(w),
        g.init(ws), g.init(np.zeros(4, np.int8)), ys, yz, g.init(bias)],
        kernel_shape=[3, 3], strides=[2, 2], pads=[1, 0, 1, 1])
    return y, (1, 4, 4, 3)


def _qadd(g, rng, qs, ys, yz):
    s, z = g.init(np.float32(0.02)), g.init(np.uint8(128))
    return g.node("QLinearAdd", [qs[0], s, z, qs[1], s, z, ys, yz],
                  domain="com.microsoft"), (1, 3, 4, 4)


def _qmul(g, rng, qs, ys, yz):
    s, z = g.init(np.float32(0.02)), g.init(np.uint8(128))
    bq = rng.integers(0, 256, (1, 3, 4, 4), dtype=np.uint8)
    return g.node("QLinearMul", [qs[0], s, z, g.init(bq),
                                 g.init(np.float32(0.01)),
                                 g.init(np.uint8(100)), ys, yz],
                  domain="com.microsoft"), (1, 3, 4, 4)


def _qgap(g, rng, qs, ys, yz):
    return g.node("QLinearGlobalAveragePool", [
        qs[0], g.init(np.float32(0.02)), g.init(np.uint8(128)), ys, yz],
        domain="com.microsoft", channels_last=0), (1, 3, 1, 1)


def _qmatmul(g, rng, qs, ys, yz):
    w = rng.integers(-127, 128, (6, 4), dtype=np.int8)
    return g.node("QLinearMatMul", [
        qs[0], g.init(np.float32(0.02)), g.init(np.uint8(128)), g.init(w),
        g.init(np.float32(0.01)), g.init(np.int8(0)), ys, yz]), (2, 4)


def _ox_dequant_const(rng):
    g = OnnxGraph()
    x = _f32(rng, 2, 3)
    g.input("x0", np.float32, (2, 3))
    c = g.node("DequantizeLinear", [
        g.init(rng.integers(0, 256, (2, 3), dtype=np.uint8)),
        g.init(np.float32(0.1)), g.init(np.uint8(128))])
    g.node("Add", ["x0", c], outputs=["y"])
    g.output("y", np.float32, (2, 3))
    return g.to_bytes(), [x]


def _ox_u8_boundary(rng):
    """A u8 graph input through DequantizeLinear, a u8 output through
    QuantizeLinear: both quantized boundaries."""
    g = OnnxGraph()
    x = rng.integers(0, 256, (2, 6), dtype=np.uint8)
    g.input("x0", np.uint8, (2, 6))
    s, z = g.init(np.float32(0.05), "s"), g.init(np.uint8(100), "z")
    d = g.node("DequantizeLinear", ["x0", s, z])
    r = g.node("Relu", [g.node("Mul", [d, g.init(np.float32(1.7))])])
    g.node("QuantizeLinear", [r, g.init(np.float32(0.04)),
                              g.init(np.uint8(3))], outputs=["y"])
    g.output("y", np.uint8, (2, 6))
    return g.to_bytes(), [x]


def _ox_shape_gather(rng):
    g = OnnxGraph()
    x = _f32(rng, 2, 3, 4)
    g.input("x0", np.float32, (2, 3, 4))
    sh = g.node("Shape", ["x0"])
    g.node("Reshape", ["x0", sh], outputs=["y"])
    g.output("y", np.float32, (2, 3, 4))
    return g.to_bytes(), [x]


def _ox_constant(rng):
    g = OnnxGraph()
    x = _f32(rng, 2, 3)
    g.input("x0", np.float32, (2, 3))
    c = g.node("Constant", [], value=_f32(rng, 2, 3))
    g.node("Mul", ["x0", c], outputs=["y"])
    g.output("y", np.float32, (2, 3))
    return g.to_bytes(), [x]


def _ox_bn(rng):
    g = OnnxGraph()
    x = _f32(rng, 1, 3, 4, 4)
    g.input("x0", np.float32, x.shape)
    ins = ["x0"] + [g.init(v.astype(np.float32)) for v in (
        rng.uniform(0.5, 1.5, 3), rng.uniform(-1, 1, 3),
        rng.uniform(-1, 1, 3), rng.uniform(0.5, 1.5, 3))]
    g.node("BatchNormalization", ins, outputs=["y"], epsilon=1e-3)
    g.output("y", np.float32, x.shape)
    return g.to_bytes(), [x]


ONNX_CASES: Dict[str, Callable] = {
    "Conv": lambda rng: _ox_single(
        "Conv", [(1, 3, 7, 7)], (1, 4, 4, 3),
        [_f32(rng, 4, 3, 3, 3), _f32(rng, 4)],
        dict(kernel_shape=[3, 3], strides=[2, 2], pads=[1, 0, 1, 1]))(rng),
    "QLinearConv": _ox_qlinear("QLinearConv", [(1, 3, 7, 7)], _qconv),
    "QuantizeLinear": _ox_u8_boundary,
    "DequantizeLinear": _ox_dequant_const,
    "QLinearAdd": _ox_qlinear("QLinearAdd", [(1, 3, 4, 4)] * 2, _qadd),
    "QLinearMul": _ox_qlinear("QLinearMul", [(1, 3, 4, 4)], _qmul),
    "QLinearGlobalAveragePool": _ox_qlinear(
        "QLinearGlobalAveragePool", [(1, 3, 4, 4)], _qgap),
    "QLinearMatMul": _ox_qlinear("QLinearMatMul", [(2, 6)], _qmatmul),
    "Add": _ox_single("Add", [(2, 3, 4), (4,)], (2, 3, 4)),
    "Sub": _ox_single("Sub", [(2, 3, 4), (2, 3, 4)], (2, 3, 4)),
    "Mul": _ox_single("Mul", [(2, 3, 4), (3, 1)], (2, 3, 4)),
    "Div": _ox_single("Div", [(2, 3), (2, 3)], (2, 3), positive=True),
    "Relu": _ox_single("Relu", [(2, 3, 4)], (2, 3, 4)),
    "Sigmoid": _ox_single("Sigmoid", [(2, 3, 4)], (2, 3, 4), scale=3.0),
    "Tanh": _ox_single("Tanh", [(2, 3, 4)], (2, 3, 4)),
    "Clip": lambda rng: _ox_single(
        "Clip", [(2, 3, 4)], (2, 3, 4),
        [np.float32(-0.5), np.float32(1.0)], scale=2.0)(rng),
    "LeakyRelu": _ox_single("LeakyRelu", [(2, 3, 4)], (2, 3, 4),
                            attrs=dict(alpha=0.3)),
    "HardSwish": _ox_single("HardSwish", [(2, 3, 4)], (2, 3, 4), scale=4.0),
    "HardSigmoid": _ox_single("HardSigmoid", [(2, 3, 4)], (2, 3, 4),
                              attrs=dict(alpha=0.25, beta=0.4), scale=3.0),
    "Erf": _ox_single("Erf", [(2, 3, 4)], (2, 3, 4)),
    "Exp": _ox_single("Exp", [(2, 3, 4)], (2, 3, 4)),
    "Sqrt": _ox_single("Sqrt", [(2, 3, 4)], (2, 3, 4), positive=True),
    "Pow": _ox_single("Pow", [(2, 3), (2, 3)], (2, 3), positive=True),
    "GlobalAveragePool": _ox_single("GlobalAveragePool", [(1, 3, 5, 4)],
                                    (1, 3, 1, 1)),
    "MaxPool": _ox_single("MaxPool", [(1, 2, 7, 7)], (1, 2, 4, 4),
                          attrs=dict(kernel_shape=[3, 3], strides=[2, 2],
                                     pads=[1, 1, 1, 1])),
    "AveragePool": _ox_single("AveragePool", [(1, 2, 7, 7)], (1, 2, 4, 4),
                              attrs=dict(kernel_shape=[3, 3], strides=[2, 2],
                                         pads=[1, 1, 1, 1])),
    "Gemm": lambda rng: _ox_single(
        "Gemm", [(2, 4)], (2, 3), [_f32(rng, 3, 4), _f32(rng, 3)],
        dict(transB=1, alpha=0.5, beta=2.0))(rng),
    "MatMul": _ox_single("MatMul", [(2, 3, 4), (4, 5)], (2, 3, 5)),
    "Reshape": _ox_single("Reshape", [(2, 3, 4)], (4, 6),
                          [np.array([4, -1], np.int64)]),
    "Flatten": _ox_single("Flatten", [(2, 3, 4, 5)], (6, 20),
                          attrs=dict(axis=2)),
    "Transpose": _ox_single("Transpose", [(2, 3, 4)], (4, 2, 3),
                            attrs=dict(perm=[2, 0, 1])),
    "Concat": _ox_single("Concat", [(2, 3), (2, 5)], (2, 8),
                         attrs=dict(axis=1)),
    "Squeeze": _ox_single("Squeeze", [(2, 1, 3, 1)], (2, 3),
                          [np.array([1, 3], np.int64)]),
    "Unsqueeze": _ox_single("Unsqueeze", [(2, 3)], (1, 2, 1, 3),
                            [np.array([0, 2], np.int64)]),
    "Softmax": _ox_single("Softmax", [(2, 3, 5)], (2, 3, 5),
                          attrs=dict(axis=1)),
    "ReduceMean": _ox_single("ReduceMean", [(2, 3, 4)], (2, 1, 4),
                             attrs=dict(axes=[1], keepdims=1)),
    "Shape": _ox_shape_gather,
    "Gather": _ox_single("Gather", [(4, 3)], (2, 2, 3),
                         [np.array([[0, 3], [-1, 1]], np.int64)],
                         attrs=dict(axis=0)),
    "Constant": _ox_constant,
    "Identity": _ox_single("Identity", [(2, 3)], (2, 3)),
    "Cast": _ox_single("Cast", [(2, 3)], (2, 3), attrs=dict(to=6),
                       scale=10.0, out_dtype=np.int32),
    "Pad": _ox_single("Pad", [(1, 2, 3, 3)], (1, 2, 5, 6),
                      [np.array([0, 0, 1, 2, 0, 0, 1, 1], np.int64)],
                      attrs=dict(mode="reflect")),
    "BatchNormalization": _ox_bn,
}


# -- GraphDef op cases -----------------------------------------------------------

def _tf_case(op, x_shapes, consts=(), positive=False, scale=1.0,
             **attrs):
    def case(rng):
        g = TfGraph()
        xs, names = [], []
        for i, s in enumerate(x_shapes):
            x = _f32(rng, *s, scale=scale)
            if positive:
                x = np.abs(x) + 0.5
            xs.append(x)
            names.append(g.placeholder(s, name=f"x{i}"))
        made = [c(rng) if callable(c) else c for c in consts]
        names += [g.const(c) for c in made]
        g.node(op, [n + (":0" if i == 0 else "")
                    for i, n in enumerate(names)], name="y", **attrs)
        return g.to_bytes(), xs
    return case


def _tf_bn(op):
    def case(rng):
        g = TfGraph()
        x = _f32(rng, 1, 4, 4, 3)
        ins = [g.placeholder(x.shape, "x0")] + [
            g.const(v.astype(np.float32)) for v in (
                rng.uniform(0.5, 1.5, 3), rng.uniform(-1, 1, 3),
                rng.uniform(-1, 1, 3), rng.uniform(0.5, 1.5, 3))]
        g.node(op, ins, name="y", epsilon=0.01, is_training=False)
        return g.to_bytes(), [x]
    return case


def _tf_concat(rng):
    g = TfGraph()
    a, b = _f32(rng, 2, 3), _f32(rng, 2, 2)
    g.node("Concat", [g.const(np.array(1, np.int32)),
                      g.placeholder(a.shape, "x0"),
                      g.placeholder(b.shape, "x1")], name="y")
    return g.to_bytes(), [a, b]


def _tf_ident(op):
    return _tf_case(op, [(2, 3)])


_W33 = lambda rng: _f32(rng, 3, 3, 3, 4)  # noqa: E731
_DW33 = lambda rng: _f32(rng, 3, 3, 3, 2)  # noqa: E731

GRAPHDEF_CASES: Dict[str, Callable] = {
    "Identity": _tf_ident("Identity"),
    "StopGradient": _tf_ident("StopGradient"),
    "PreventGradient": _tf_ident("PreventGradient"),
    "CheckNumerics": _tf_ident("CheckNumerics"),
    "Add": _tf_case("Add", [(2, 3), (3,)]),
    "AddV2": _tf_case("AddV2", [(2, 3), (2, 3)]),
    "Sub": _tf_case("Sub", [(2, 3), (2, 3)]),
    "Mul": _tf_case("Mul", [(2, 3), (2, 1)]),
    "RealDiv": _tf_case("RealDiv", [(2, 3), (2, 3)], positive=True),
    "Div": _tf_case("Div", [(2, 3), (2, 3)], positive=True),
    "Maximum": _tf_case("Maximum", [(2, 3), (2, 3)]),
    "Minimum": _tf_case("Minimum", [(2, 3), (2, 3)]),
    "MatMul": _tf_case("MatMul", [(3, 4), (5, 4)], transpose_b=True),
    "BiasAdd": _tf_case("BiasAdd", [(2, 3)], [lambda r: _f32(r, 3)]),
    "Relu": _tf_case("Relu", [(2, 3)]),
    "Relu6": _tf_case("Relu6", [(2, 3)], scale=5.0),
    "Softmax": _tf_case("Softmax", [(2, 5)]),
    "Sigmoid": _tf_case("Sigmoid", [(2, 3)], scale=3.0),
    "Tanh": _tf_case("Tanh", [(2, 3)]),
    "Sqrt": _tf_case("Sqrt", [(2, 3)], positive=True),
    "Rsqrt": _tf_case("Rsqrt", [(2, 3)], positive=True),
    "Exp": _tf_case("Exp", [(2, 3)]),
    "Neg": _tf_case("Neg", [(2, 3)]),
    "Square": _tf_case("Square", [(2, 3)]),
    "Reshape": _tf_case("Reshape", [(2, 6)], [np.array([3, -1], np.int32)]),
    "Squeeze": _tf_case("Squeeze", [(1, 3, 1, 2)], squeeze_dims=[0, 2]),
    "ExpandDims": _tf_case("ExpandDims", [(2, 3)], [np.array(1, np.int32)]),
    "ConcatV2": _tf_case("ConcatV2", [(2, 3), (2, 2)],
                         [np.array(1, np.int32)]),
    "Concat": _tf_concat,
    "Pad": _tf_case("Pad", [(1, 3, 3, 2)],
                    [np.array([[0, 0], [1, 2], [0, 1], [0, 0]], np.int32)]),
    "Mean": _tf_case("Mean", [(1, 4, 4, 3)], [np.array([1, 2], np.int32)],
                     keep_dims=True),
    "Conv2D": _tf_case("Conv2D", [(1, 7, 7, 3)], [_W33],
                       strides=[1, 2, 2, 1], padding="SAME"),
    "DepthwiseConv2dNative": _tf_case(
        "DepthwiseConv2dNative", [(1, 7, 7, 3)], [_DW33],
        strides=[1, 2, 2, 1], padding="SAME"),
    "MaxPool": _tf_case("MaxPool", [(1, 7, 7, 2)], ksize=[1, 3, 3, 1],
                        strides=[1, 2, 2, 1], padding="SAME"),
    "AvgPool": _tf_case("AvgPool", [(1, 7, 7, 2)], ksize=[1, 3, 3, 1],
                        strides=[1, 2, 2, 1], padding="SAME"),
    "FusedBatchNorm": _tf_bn("FusedBatchNorm"),
    "FusedBatchNormV3": _tf_bn("FusedBatchNormV3"),
}

CASES = {"tflite": TFLITE_CASES, "onnx": ONNX_CASES, "pb": GRAPHDEF_CASES}
EXTRA_CASES = {"tflite": TFLITE_EXTRA_CASES}


def write_op_case(fmt: str, name: str, out_dir: str, seed: int = 0
                  ) -> Tuple[str, List[np.ndarray]]:
    """Write op case ``name`` of format ``fmt`` (tflite | onnx | pb);
    returns (path, inputs)."""
    cases = dict(CASES[fmt], **EXTRA_CASES.get(fmt, {}))
    data, inputs = cases[name](np.random.default_rng(seed))
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.{fmt}")
    with open(path, "wb") as f:
        f.write(data)
    return path, inputs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir")
    ap.add_argument("--width", type=float, default=1.0)
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    for form, path in write_mobilenet_v2(args.out_dir, args.width,
                                         args.size, args.seed).items():
        print(f"{form}: {path} ({os.path.getsize(path)} bytes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
