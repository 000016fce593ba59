"""TFLite model importer: .tflite flatbuffer -> one torch module.

Port of ``nnstreamer_tpu/interop/tflite.py``. The reference runs .tflite
models through the TensorFlow Lite interpreter
(ext/nnstreamer/tensor_filter/tensor_filter_tensorflow_lite.cc:1-1825).
Here the flatbuffer is parsed once at open (the JAX importer's parser,
copied), constants dequantize in float64 on the host, and the op graph
becomes a :class:`~.graph.GraphModule` whose ``forward`` walks the op
list with torch ops: cuDNN and cuBLAS run its convolutions and products
on the card, and the filter captures one CUDA graph per input signature
as it does for zoo models.

Quantized models run in float simulation, as in the JAX importer:
uint8/int8 weights dequantize at import ((q - zero_point) * scale,
per-tensor or per-axis), activations stay float and clip to each
quantized tensor's representable range, and graph inputs/outputs
(de)quantize at the boundary so the wire dtypes match the model's
declared signature (``torch.round`` rounds half to even, as
``jnp.round`` does).

Tensors flow NHWC, as in the file (see interop/graph.py for the layout
of the convolutions). Static shapes only.

Where this differs from the JAX importer, it follows TFLite (each pinned
by ``tests/test_torch_interop.py``, listed in ROADMAP.md queue C):

* TRANSPOSE_CONV: the JAX importer hands ``lax.conv_transpose`` the
  weight with its channel axes swapped, so a layer with as many input as
  output channels mixes them transposed and any other raises. The port
  computes TFLite's transposed convolution.
* RESIZE_NEAREST_NEIGHBOR: the JAX importer reads the options at the
  bilinear op's field ids and resizes with ``jax.image.resize``, which
  always samples at half-pixel centers. The port reads
  ``align_corners``/``half_pixel_centers`` and samples as TFLite does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..tensors.info import TensorInfo, TensorsInfo
from ..tensors.types import TensorType
from .flatbuf import FlatBuf
from .graph import (GraphModule, Static, conv2d_nhwc, pad_widths,
                    pool_nhwc, same_pads, softmax, torch_dtype)

# -- schema enums (tensorflow/lite/schema/schema.fbs) ----------------------

_TENSOR_NP = {0: np.float32, 1: np.float16, 2: np.int32, 3: np.uint8,
              4: np.int64, 6: np.bool_, 7: np.int16, 9: np.int8,
              10: np.float64}

# BuiltinOperator values used below
ADD, AVERAGE_POOL_2D, CONCATENATION, CONV_2D, DEPTHWISE_CONV_2D = 0, 1, 2, 3, 4
DEQUANTIZE, FULLY_CONNECTED, LOGISTIC, MAX_POOL_2D, MUL = 6, 9, 14, 17, 18
RELU, RELU6, RESHAPE, RESIZE_BILINEAR, SOFTMAX, TANH = 19, 21, 22, 23, 25, 28
PAD, TRANSPOSE, MEAN, SUB, DIV, SQUEEZE, STRIDED_SLICE = 34, 39, 40, 41, 42, 43, 45
EXP, LOG_SOFTMAX, CAST, PRELU, MAXIMUM, ARG_MAX, MINIMUM = 47, 50, 53, 54, 55, 56, 57
SLICE, TRANSPOSE_CONV, EXPAND_DIMS, SUM, SHAPE, POW = 65, 67, 70, 74, 77, 78
PACK, LEAKY_RELU, SQUARED_DIFFERENCE, ABS = 83, 98, 99, 101
RESIZE_NEAREST_NEIGHBOR = 97
QUANTIZE, HARD_SWISH = 114, 117
BATCH_MATMUL = 126
BROADCAST_TO, BROADCAST_ARGS = 130, 145

_OP_NAMES = {v: k for k, v in list(globals().items())
             if isinstance(v, int) and k.isupper()}


@dataclasses.dataclass
class _Tensor:
    index: int
    name: str
    shape: Tuple[int, ...]
    dtype: Any                       # numpy dtype class
    scale: Optional[np.ndarray]      # quant scale(s) or None
    zero_point: Optional[np.ndarray]
    quant_axis: int
    const: Optional[np.ndarray]      # raw constant data (un-dequantized)

    @property
    def quantized(self) -> bool:
        return self.scale is not None and self.scale.size > 0 and \
            self.dtype in (np.uint8, np.int8, np.int32, np.int16)


@dataclasses.dataclass
class _Op:
    code: int
    inputs: List[int]
    outputs: List[int]
    options: Optional[int]           # table position in the flatbuffer
    fb: FlatBuf


@dataclasses.dataclass
class TFLiteModel:
    """Parsed model: ``module(*inputs) -> list[outputs]`` plus the
    tensor signature in framework terms."""

    module: "TFLiteModule"
    input_info: TensorsInfo
    output_info: TensorsInfo
    path: str


# -- parsing ---------------------------------------------------------------

def _parse_tensor(fb: FlatBuf, pos: int, index: int,
                  buffers: List[Optional[np.ndarray]]) -> _Tensor:
    shape = fb.field_np(pos, 0, np.int32)
    shape = () if shape is None else tuple(int(d) for d in shape)
    ttype = fb.field_scalar(pos, 1, "u8")
    if ttype not in _TENSOR_NP:
        raise NotImplementedError(f"tflite tensor type {ttype} unsupported")
    dtype = _TENSOR_NP[ttype]
    buf_idx = fb.field_scalar(pos, 2, "u32")
    name = fb.field_string(pos, 3)
    scale = zero = None
    qaxis = 0
    q = fb.field_table(pos, 4)
    if q is not None:
        scale = fb.field_np(q, 2, np.float32)
        zero = fb.field_np(q, 3, np.int64)
        qaxis = fb.field_scalar(q, 6, "i32", default=0)
    raw = buffers[buf_idx] if buf_idx < len(buffers) else None
    const = None
    if raw is not None and raw.size:
        const = raw.view(dtype)[:int(np.prod(shape, dtype=np.int64))] \
            .reshape(shape)
    return _Tensor(index, name, shape, dtype, scale, zero, qaxis, const)


def parse(path: str) -> Tuple[List[_Tensor], List[_Op],
                              List[int], List[int]]:
    """Parse subgraph 0 into tensors / ops / input / output index lists."""
    with open(path, "rb") as f:
        data = f.read()
    fb = FlatBuf(data)
    root = fb.root()
    # buffers (Model field 4): raw little-endian bytes per buffer
    buffers: List[Optional[np.ndarray]] = []
    bvec = fb.field_vector(root, 4)
    if bvec is not None:
        for bpos in fb.vector_tables(bvec):
            buffers.append(fb.field_np(bpos, 0, np.uint8))
    # operator codes (Model field 1); builtin_code (3) supersedes the
    # deprecated int8 field 0 for codes > 127
    codes: List[int] = []
    for cpos in fb.vector_tables(fb.field_vector(root, 1)):
        dep = fb.field_scalar(cpos, 0, "i8")
        builtin = fb.field_scalar(cpos, 3, "i32", default=0)
        codes.append(builtin if builtin != 0 else dep)
    sg = next(fb.vector_tables(fb.field_vector(root, 2)))
    tensors = [
        _parse_tensor(fb, tpos, i, buffers)
        for i, tpos in enumerate(fb.vector_tables(fb.field_vector(sg, 0)))]
    inputs = [int(i) for i in fb.field_np(sg, 1, np.int32)]
    outputs = [int(i) for i in fb.field_np(sg, 2, np.int32)]
    ops: List[_Op] = []
    for opos in fb.vector_tables(fb.field_vector(sg, 3)):
        idx = fb.field_scalar(opos, 0, "u32")
        op_inputs = [int(i) for i in fb.field_np(opos, 1, np.int32)]
        op_outputs = [int(i) for i in fb.field_np(opos, 2, np.int32)]
        options = fb.field_table(opos, 4)
        ops.append(_Op(codes[idx], op_inputs, op_outputs, options, fb))
    return tensors, ops, inputs, outputs


# -- dequantization --------------------------------------------------------

def _dequantize_const(t: _Tensor) -> np.ndarray:
    """Constant to float32, applying (q - zp) * scale (per-axis aware)."""
    data = t.const
    assert data is not None
    if t.dtype in (np.float32, np.float64, np.float16):
        return data.astype(np.float32)
    if not t.quantized:
        return data  # int32 shape/axis constants stay integer
    scale = t.scale.astype(np.float64)
    zp = (t.zero_point if t.zero_point is not None
          else np.zeros_like(scale)).astype(np.float64)
    if scale.size == 1:
        return ((data.astype(np.float64) - zp[0]) * scale[0]) \
            .astype(np.float32)
    bshape = [1] * data.ndim
    bshape[t.quant_axis] = scale.size
    return ((data.astype(np.float64) - zp.reshape(bshape))
            * scale.reshape(bshape)).astype(np.float32)


# -- lowering --------------------------------------------------------------

_ACT = {0: None, 1: "relu", 2: "relu_n1_to_1", 3: "relu6", 4: "tanh"}


def _apply_act(x: torch.Tensor, act_code: int) -> torch.Tensor:
    act = _ACT.get(act_code)
    if act is None:
        return x
    if act == "relu":
        return torch.clamp(x, min=0.0)
    if act == "relu6":
        return torch.clamp(x, 0.0, 6.0)
    if act == "relu_n1_to_1":
        return torch.clamp(x, -1.0, 1.0)
    return torch.tanh(x)


def _bilinear(x: torch.Tensor, out_h: int, out_w: int, align_corners: bool,
              half_pixel: bool) -> torch.Tensor:
    """The JAX importer's coordinate formula (``tflite.py`` ``_bilinear``)
    over NHWC."""
    _, in_h, in_w, _ = x.shape

    def coords(out, inp):
        idx = torch.arange(out, dtype=torch.float32, device=x.device)
        if align_corners and out > 1:
            return idx * ((inp - 1) / (out - 1))
        if half_pixel:
            return torch.clamp((idx + 0.5) * (inp / out) - 0.5, min=0.0)
        return idx * (inp / out)

    ys, xs = coords(out_h, in_h), coords(out_w, in_w)
    y0 = torch.clamp(torch.floor(ys).to(torch.int64), 0, in_h - 1)
    y1 = torch.clamp(y0 + 1, 0, in_h - 1)
    x0 = torch.clamp(torch.floor(xs).to(torch.int64), 0, in_w - 1)
    x1 = torch.clamp(x0 + 1, 0, in_w - 1)
    wy = (ys - y0)[None, :, None, None]
    wx = (xs - x0)[None, None, :, None]
    top = x.index_select(1, y0)
    bot = x.index_select(1, y1)
    tl, tr = top.index_select(2, x0), top.index_select(2, x1)
    bl, br = bot.index_select(2, x0), bot.index_select(2, x1)
    t = tl + (tr - tl) * wx
    b = bl + (br - bl) * wx
    return t + (b - t) * wy


def _nearest_index(out: int, inp: int, align_corners: bool,
                   half_pixel: bool) -> np.ndarray:
    """TFLite's ResizeNearestNeighbor source index of each output row
    (reference_ops.h ``GetNearestNeighbor``), in float32 as there."""
    scale = np.float32((inp - 1) / (out - 1) if align_corners and out > 1
                       else inp / out)
    pos = (np.arange(out, dtype=np.float32)
           + np.float32(0.5 if half_pixel else 0.0)) * scale
    idx = np.round(pos) if align_corners else np.floor(pos)
    idx = np.minimum(idx.astype(np.int64), inp - 1)
    return np.maximum(idx, 0) if half_pixel else idx


def _transpose_conv(x: torch.Tensor, w: torch.Tensor, out_shape: List[int],
                    strides: Tuple[int, int], padding: str) -> torch.Tensor:
    """TFLite's TRANSPOSE_CONV over NHWC: ``w`` is [in, out, kh, kw]; the
    full transposed convolution is cropped at the SAME (or VALID) offset
    the output shape implies."""
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, None, strides)
    oh, ow = out_shape[1], out_shape[2]
    pt = pl = 0
    if padding == "SAME":
        pt = same_pads(oh, w.shape[2], strides[0])[0]
        pl = same_pads(ow, w.shape[3], strides[1])[0]
    need_h, need_w = pt + oh - y.shape[2], pl + ow - y.shape[3]
    if need_h > 0 or need_w > 0:
        y = F.pad(y, (0, max(need_w, 0), 0, max(need_h, 0)))
    return y[:, :, pt:pt + oh, pl:pl + ow].permute(0, 2, 3, 1)


class TFLiteModule(GraphModule):
    """The op list of subgraph 0 as a module (see interop/graph.py)."""

    def __init__(self, tensors: List[_Tensor], ops: List[_Op],
                 graph_in: List[int], graph_out: List[int]):
        super().__init__()
        # host copies of the constants: compile-time values and the
        # source of the buffers; the raw quantized views are not kept
        consts = {t.index: _dequantize_const(t) for t in tensors
                  if t.const is not None}
        for t in tensors:
            t.const = None
        self._g = Static(tensors=tensors, ops=ops, inputs=graph_in,
                         outputs=graph_out, consts=consts)

    def walk(self, *args):
        g = self._g
        tensors = g.tensors
        env: Dict[int, Any] = {}
        for i, gi in enumerate(g.inputs):
            t = tensors[gi]
            x = args[i]
            if t.quantized and t.dtype in (np.uint8, np.int8):
                # boundary dequantize: wire dtype -> float simulation
                x = (x.to(torch.float32) - float(t.zero_point[0])) \
                    * float(t.scale[0])
            elif x.dtype != torch.float32 and t.dtype == np.float32:
                x = x.to(torch.float32)
            env[gi] = x
        for n, op in enumerate(g.ops):
            y = self._eval_op(n, op, env)
            t = tensors[op.outputs[0]]
            if t.quantized and t.dtype in (np.uint8, np.int8) and \
                    t.scale.size == 1:
                # quantized storage saturates activations to the tensor's
                # representable range; the float simulation must too
                info = np.iinfo(t.dtype)
                zp = float(t.zero_point[0]) if t.zero_point is not None \
                    else 0.0
                s = float(t.scale[0])
                y = torch.clamp(self._tensor(y, op.outputs[0]),
                                (info.min - zp) * s, (info.max - zp) * s)
            env[op.outputs[0]] = y
        outs = []
        for go in g.outputs:
            y = self._val(env, go)
            t = tensors[go]
            if t.quantized and t.dtype in (np.uint8, np.int8):
                # boundary requantize back to the declared wire dtype
                info = np.iinfo(t.dtype)
                q = torch.round(y / float(t.scale[0])) \
                    + float(t.zero_point[0])
                y = torch.clamp(q, info.min, info.max).to(
                    torch_dtype(t.dtype))
            outs.append(y)
        return outs

    # -- values -----------------------------------------------------------
    def _tensor(self, v, idx: int) -> torch.Tensor:
        """``v`` as a tensor; a host value (a constant, or a value the
        walk computed from static shapes) becomes a buffer."""
        if isinstance(v, torch.Tensor):
            return v
        return self.const(("v", idx), lambda: np.asarray(v))

    def _val(self, env: Dict[int, Any], idx: int) -> torch.Tensor:
        if idx in env:
            return self._tensor(env[idx], idx)
        if idx in self._g.consts:
            return self._tensor(self._g.consts[idx], idx)
        raise KeyError(f"tensor {idx} used before produced "
                       f"({self._g.tensors[idx].name!r})")

    def _const_val(self, env: Dict[int, Any], idx: int) -> np.ndarray:
        if idx in self._g.consts:
            return self._g.consts[idx]
        v = env.get(idx)
        if isinstance(v, np.ndarray):
            return v
        raise NotImplementedError(
            f"op needs compile-time constant for tensor {idx} "
            f"({self._g.tensors[idx].name!r})")

    # -- ops --------------------------------------------------------------
    def _eval_op(self, n: int, op: _Op, env: Dict[int, Any]):
        fb, opt = op.fb, op.options
        code = op.code
        tensors = self._g.tensors

        def val(idx):
            return self._val(env, idx)

        def const_val(idx):
            return self._const_val(env, idx)

        def scalar(fid, kind, default=0):
            if opt is None:
                return default
            return fb.field_scalar(opt, fid, kind, default=default)

        def bias(pos: int):
            if len(op.inputs) > pos and op.inputs[pos] >= 0:
                return self._tensor(const_val(op.inputs[pos]),
                                    op.inputs[pos])
            return None

        def padding():
            return "SAME" if scalar(0, "i8") == 0 else "VALID"

        if code == CONV_2D:
            x = val(op.inputs[0])
            # OHWI data as a channels_last OIHW view
            w = self.const(("w", n), lambda: torch.from_numpy(
                np.ascontiguousarray(const_val(op.inputs[1])))
                .permute(0, 3, 1, 2))
            strides = (scalar(2, "i32", 1), scalar(1, "i32", 1))  # (h, w)
            dil = (scalar(5, "i32", 1) or 1, scalar(4, "i32", 1) or 1)
            y = conv2d_nhwc(x, w, bias(2), strides, padding(), dil)
            return _apply_act(y, scalar(3, "i8"))

        if code == DEPTHWISE_CONV_2D:
            x = val(op.inputs[0])
            # [1, kh, kw, in*mult] -> [in*mult, 1, kh, kw]
            w = self.const(("w", n), lambda: np.ascontiguousarray(
                np.transpose(const_val(op.inputs[1]), (3, 0, 1, 2))))
            strides = (scalar(2, "i32", 1), scalar(1, "i32", 1))
            dil = (scalar(6, "i32", 1) or 1, scalar(5, "i32", 1) or 1)
            y = conv2d_nhwc(x, w, bias(2), strides, padding(), dil,
                            groups=x.shape[-1])
            return _apply_act(y, scalar(4, "i8"))

        if code == FULLY_CONNECTED:
            x = val(op.inputs[0])
            w = const_val(op.inputs[1])           # [out, in]
            if x.ndim > 2 and not scalar(2, "i8"):
                x = x.reshape(-1, w.shape[1])
            wt = self.const(("w", n), lambda: np.ascontiguousarray(w.T))
            y = x @ wt
            b = bias(2)
            if b is not None:
                y = y + b
            return _apply_act(y, scalar(0, "i8"))

        if code in (ADD, SUB, MUL, DIV, MAXIMUM, MINIMUM, POW,
                    SQUARED_DIFFERENCE):
            a, b = val(op.inputs[0]), val(op.inputs[1])
            if code == ADD:
                y = a + b
            elif code == SUB:
                y = a - b
            elif code == MUL:
                y = a * b
            elif code == DIV:
                y = a / b
            elif code == MAXIMUM:
                y = torch.maximum(a, b)
            elif code == MINIMUM:
                y = torch.minimum(a, b)
            elif code == POW:
                y = a ** b
            else:
                y = (a - b) ** 2
            # ADD/SUB/MUL/DIV carry a fused activation at options field 0
            if code in (ADD, SUB, MUL, DIV):
                y = _apply_act(y, scalar(0, "i8"))
            return y

        if code in (AVERAGE_POOL_2D, MAX_POOL_2D):
            x = val(op.inputs[0])
            strides = (scalar(2, "i32", 1), scalar(1, "i32", 1))
            ksize = (scalar(4, "i32", 1), scalar(3, "i32", 1))
            y = pool_nhwc(self, n, x, ksize, strides, padding(),
                          "avg" if code == AVERAGE_POOL_2D else "max")
            return _apply_act(y, scalar(5, "i8"))

        if code == RESHAPE:
            x = val(op.inputs[0])
            if opt is not None and fb.field_vector(opt, 0) is not None:
                shape = [int(d) for d in fb.field_np(opt, 0, np.int32)]
            else:
                shape = [int(d) for d in const_val(op.inputs[1])]
            return x.reshape(shape)

        if code == SQUEEZE:
            x = val(op.inputs[0])
            dims = (fb.field_np(opt, 0, np.int32)
                    if opt is not None else None)
            if dims is None or len(dims) == 0:
                return torch.squeeze(x)
            return torch.squeeze(x, tuple(int(d) for d in dims))

        if code == EXPAND_DIMS:
            return torch.unsqueeze(val(op.inputs[0]),
                                   int(const_val(op.inputs[1])))

        if code == SOFTMAX:
            beta = scalar(0, "f32", 1.0) or 1.0
            return softmax(val(op.inputs[0]) * beta)

        if code == LOG_SOFTMAX:
            x = val(op.inputs[0])
            m = x.amax(-1, keepdim=True)
            return x - torch.log(torch.sum(torch.exp(x - m), -1,
                                           keepdim=True)) - m

        if code == CONCATENATION:
            axis = scalar(0, "i32")
            parts = [val(i) for i in op.inputs]
            return _apply_act(torch.cat(parts, dim=axis), scalar(1, "i8"))

        if code == RESIZE_BILINEAR:
            x = val(op.inputs[0])
            out_h, out_w = (int(d) for d in const_val(op.inputs[1]))
            return _bilinear(x, out_h, out_w, bool(scalar(2, "u8")),
                             bool(scalar(3, "u8")))

        if code == RESIZE_NEAREST_NEIGHBOR:
            x = val(op.inputs[0])
            out_h, out_w = (int(d) for d in const_val(op.inputs[1]))
            align, half = bool(scalar(0, "u8")), bool(scalar(1, "u8"))
            iy = self.const(("iy", n), lambda: _nearest_index(
                out_h, x.shape[1], align, half))
            ix = self.const(("ix", n), lambda: _nearest_index(
                out_w, x.shape[2], align, half))
            return x.index_select(1, iy).index_select(2, ix)

        if code == PAD:
            x = val(op.inputs[0])
            pads = const_val(op.inputs[1]).astype(int)
            return pad_widths(x, [(int(a), int(b)) for a, b in pads])

        if code in (MEAN, SUM):
            x = val(op.inputs[0])
            axes = tuple(int(a) for a in
                         np.atleast_1d(const_val(op.inputs[1])))
            keep = bool(scalar(0, "u8"))
            red = torch.mean if code == MEAN else torch.sum
            return red(x, dim=axes, keepdim=keep)

        if code == TRANSPOSE:
            perm = [int(p) for p in const_val(op.inputs[1])]
            return val(op.inputs[0]).permute(perm)

        if code == RELU:
            return torch.clamp(val(op.inputs[0]), min=0.0)
        if code == RELU6:
            return torch.clamp(val(op.inputs[0]), 0.0, 6.0)
        if code == LOGISTIC:
            return 1.0 / (1.0 + torch.exp(-val(op.inputs[0])))
        if code == TANH:
            return torch.tanh(val(op.inputs[0]))
        if code == HARD_SWISH:
            x = val(op.inputs[0])
            return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0
        if code == LEAKY_RELU:
            alpha = scalar(0, "f32", 0.01)
            x = val(op.inputs[0])
            return torch.where(x >= 0, x, alpha * x)
        if code == PRELU:
            x, a = val(op.inputs[0]), val(op.inputs[1])
            return torch.where(x >= 0, x, a * x)
        if code == ABS:
            return torch.abs(val(op.inputs[0]))
        if code == EXP:
            return torch.exp(val(op.inputs[0]))

        if code == ARG_MAX:
            axis = int(const_val(op.inputs[1]))
            out_t = tensors[op.outputs[0]].dtype
            return torch.argmax(val(op.inputs[0]), dim=axis).to(
                torch_dtype(out_t))

        if code == CAST:
            return val(op.inputs[0]).to(
                torch_dtype(tensors[op.outputs[0]].dtype))

        if code in (DEQUANTIZE, QUANTIZE):
            # float simulation: activations are already float end-to-end
            return val(op.inputs[0])

        if code == SHAPE:
            src = tensors[op.inputs[0]]
            shape = src.shape if src.shape else \
                tuple(val(op.inputs[0]).shape)
            return np.asarray(shape, tensors[op.outputs[0]].dtype)

        if code == BROADCAST_ARGS:
            a = const_val(op.inputs[0])
            b = const_val(op.inputs[1])
            return np.asarray(
                np.broadcast_shapes(tuple(int(x) for x in a),
                                    tuple(int(x) for x in b)),
                tensors[op.outputs[0]].dtype)

        if code == BROADCAST_TO:
            shape = [int(d) for d in const_val(op.inputs[1])]
            return torch.broadcast_to(val(op.inputs[0]), shape)

        if code == PACK:
            axis = scalar(1, "i32")
            return torch.stack([val(i) for i in op.inputs], dim=axis)

        if code == SLICE:
            x = val(op.inputs[0])
            begin = [int(b) for b in const_val(op.inputs[1])]
            size = [int(s) for s in const_val(op.inputs[2])]
            idx = tuple(slice(b, x.shape[d] if s == -1 else b + s)
                        for d, (b, s) in enumerate(zip(begin, size)))
            return x[idx]

        if code == STRIDED_SLICE:
            x = val(op.inputs[0])
            begin = [int(b) for b in const_val(op.inputs[1])]
            end = [int(e) for e in const_val(op.inputs[2])]
            strides = [int(s) for s in const_val(op.inputs[3])]
            bm = scalar(0, "i32")
            em = scalar(1, "i32")
            ellipsis = scalar(2, "i32")
            new_axis = scalar(3, "i32")
            shrink = scalar(4, "i32")
            if ellipsis or new_axis:
                raise NotImplementedError(
                    "STRIDED_SLICE ellipsis_mask/new_axis_mask unsupported")
            # torch slices take positive steps only: an axis with a
            # negative stride is gathered by its numpy slice's indices
            idx, backward, kept = [], [], 0
            for d in range(len(begin)):
                if shrink & (1 << d):
                    idx.append(begin[d])
                    continue
                b = None if bm & (1 << d) else begin[d]
                e = None if em & (1 << d) else end[d]
                if strides[d] < 0:
                    idx.append(slice(None))
                    backward.append((kept, d, slice(b, e, strides[d])))
                else:
                    idx.append(slice(b, e, strides[d]))
                kept += 1
            y = x[tuple(idx)]
            for axis, d, sl in backward:
                y = y.index_select(axis, self.const(
                    ("slice", n, d),
                    lambda m=x.shape[d], sl=sl: np.arange(m)[sl]))
            return y

        if code == BATCH_MATMUL:
            a, b = val(op.inputs[0]), val(op.inputs[1])
            if bool(scalar(0, "u8")):
                a = a.transpose(-1, -2)
            if bool(scalar(1, "u8")):
                b = b.transpose(-1, -2)
            return torch.matmul(a, b)

        if code == TRANSPOSE_CONV:
            out_shape = [int(d) for d in const_val(op.inputs[0])]
            # OHWI -> [in, out, kh, kw]
            w = self.const(("w", n), lambda: np.ascontiguousarray(
                np.transpose(const_val(op.inputs[1]), (3, 0, 1, 2))))
            x = val(op.inputs[2])
            strides = (scalar(2, "i32", 1), scalar(1, "i32", 1))
            y = _transpose_conv(x, w, out_shape, strides, padding())
            b = bias(3)
            return y if b is None else y + b

        raise NotImplementedError(
            f"tflite op {_OP_NAMES.get(code, code)} ({code}) not supported")


# -- public API ------------------------------------------------------------

def _info_of(tensors: List[_Tensor], indices: List[int]) -> TensorsInfo:
    infos = TensorsInfo()
    for i in indices:
        t = tensors[i]
        infos.append(TensorInfo(
            name=t.name or None,
            type=TensorType.from_dtype(np.dtype(t.dtype)),
            shape=tuple(t.shape)))
    return infos


def load(path: str) -> TFLiteModel:
    """Parse a .tflite file and build its module on the CPU; an op the
    importer does not lower raises here, at load."""
    tensors, ops, graph_in, graph_out = parse(path)
    in_info = _info_of(tensors, graph_in)
    module = TFLiteModule(tensors, ops, graph_in, graph_out)
    module.record([np.zeros(i.shape, i.type.np_dtype) for i in in_info])
    return TFLiteModel(module=module.eval(), input_info=in_info,
                       output_info=_info_of(tensors, graph_out), path=path)
