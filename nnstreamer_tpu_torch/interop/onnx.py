"""ONNX model importer: .onnx protobuf -> one torch module.

Port of ``nnstreamer_tpu/interop/onnx.py`` (≙ ext/nnstreamer/
tensor_filter/tensor_filter_onnxruntime.cc, which wraps the onnxruntime
C++ session). The graph is parsed with the schema-less protobuf reader
(interop/protowire.py; the JAX importer's parser, copied) and becomes a
:class:`~.graph.GraphModule` whose ``forward`` walks the nodes with
torch ops. Supports the float op set plus the QOperator quantized ops
(QLinearConv/QLinearAdd/QLinearMul/QLinearGlobalAveragePool/
QLinearMatMul) in float simulation: weights dequantize at import,
activations stay float and are clamped to each quantized tensor's
representable range (see interop/tflite.py for the same technique).

Layout stays NCHW as ONNX declares it; convolutions go to cuDNN as they
are.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..tensors.info import TensorInfo, TensorsInfo
from ..tensors.types import TensorType
from . import protowire as pw
from .graph import (GraphModule, Static, conv2d_nchw, pad_widths, pool_nchw,
                    reduce_dims, softmax, torch_dtype)

# TensorProto.DataType
_ELEM_NP = {1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16,
            5: np.int16, 6: np.int32, 7: np.int64, 9: np.bool_,
            10: np.float16, 11: np.float64, 12: np.uint32, 13: np.uint64}


@dataclasses.dataclass
class _Node:
    op: str
    inputs: List[str]
    outputs: List[str]
    attrs: Dict[str, Any]


@dataclasses.dataclass
class ONNXModel:
    module: "ONNXModule"
    input_info: TensorsInfo
    output_info: TensorsInfo
    path: str


# -- protobuf walking ------------------------------------------------------

def _parse_tensor_proto(data: bytes) -> Tuple[str, np.ndarray]:
    """TensorProto -> (name, ndarray)."""
    msg = pw.decode(data)
    dims = [pw.as_sint(d) for d in msg.get(1, [])]
    dtype = _ELEM_NP[msg.get(2, [1])[0]]
    name = msg.get(8, [b""])[0].decode()
    if 9 in msg:  # raw_data
        arr = np.frombuffer(msg[9][0], dtype=dtype)
    elif 4 in msg and dtype == np.float32:  # packed float_data
        raw = msg[4][0] if isinstance(msg[4][0], bytes) else None
        if raw is not None:
            arr = np.frombuffer(raw, np.float32)
        else:
            arr = np.array([pw.as_f32(v) for v in msg[4]], np.float32)
    elif 7 in msg:  # int64_data
        raw = msg[7][0] if isinstance(msg[7][0], bytes) else None
        vals = pw.packed_varints(raw) if raw is not None else msg[7]
        arr = np.array([pw.as_sint(v) for v in vals], np.int64)
    elif 5 in msg:  # int32_data (also holds u8/i8 payloads)
        raw = msg[5][0] if isinstance(msg[5][0], bytes) else None
        vals = pw.packed_varints(raw) if raw is not None else msg[5]
        arr = np.array([pw.as_sint(v) for v in vals]).astype(dtype)
    else:
        arr = np.zeros(0, dtype)
    return name, arr.reshape(dims) if dims else arr.reshape(())


def _parse_attr(data: bytes) -> Tuple[str, Any]:
    msg = pw.decode(data)
    name = msg[1][0].decode()
    atype = msg.get(20, [0])[0]
    if atype == 1:   # FLOAT
        return name, pw.as_f32(msg[2][0])
    if atype == 2:   # INT
        return name, pw.as_sint(msg[3][0])
    if atype == 3:   # STRING
        return name, msg[4][0].decode()
    if atype == 4:   # TENSOR
        return name, _parse_tensor_proto(msg[5][0])[1]
    if atype == 6:   # FLOATS
        vals = msg.get(7, [])
        if vals and isinstance(vals[0], bytes):
            return name, np.frombuffer(vals[0], "<f4").tolist()
        return name, [pw.as_f32(v) for v in vals]
    if atype == 7:   # INTS
        vals = msg.get(8, [])
        if vals and isinstance(vals[0], bytes):
            return name, [pw.as_sint(v) for v in pw.packed_varints(vals[0])]
        return name, [pw.as_sint(v) for v in vals]
    return name, None


def _parse_value_info(data: bytes) -> Tuple[str, Any, Tuple[int, ...]]:
    vi = pw.decode(data)
    name = vi[1][0].decode()
    dtype, shape = np.float32, ()
    if 2 in vi:
        t = pw.decode(vi[2][0])
        if 1 in t:  # tensor_type
            tt = pw.decode(t[1][0])
            dtype = _ELEM_NP.get(tt.get(1, [1])[0], np.float32)
            dims = []
            if 2 in tt:
                for db in pw.decode(tt[2][0]).get(1, []):
                    d = pw.decode(db)
                    dims.append(int(pw.as_sint(d[1][0])) if 1 in d else 1)
            shape = tuple(dims)
    return name, dtype, shape


def parse(path: str):
    with open(path, "rb") as f:
        model = pw.decode(f.read())
    graph = pw.decode(model[7][0])
    inits: Dict[str, np.ndarray] = {}
    for tb in graph.get(5, []):
        name, arr = _parse_tensor_proto(tb)
        inits[name] = arr
    nodes: List[_Node] = []
    for nb in graph.get(1, []):
        n = pw.decode(nb)
        nodes.append(_Node(
            op=n[4][0].decode(),
            inputs=[v.decode() for v in n.get(1, [])],
            outputs=[v.decode() for v in n.get(2, [])],
            attrs=dict(_parse_attr(ab) for ab in n.get(5, []))))
    g_in = [_parse_value_info(vb) for vb in graph.get(11, [])
            if pw.decode(vb)[1][0].decode() not in inits]
    g_out = [_parse_value_info(vb) for vb in graph.get(12, [])]
    return nodes, inits, g_in, g_out


# -- lowering --------------------------------------------------------------

def _conv_padding(attrs):
    if attrs.get("auto_pad", "NOTSET") in ("SAME_UPPER", "SAME_LOWER"):
        return "SAME"
    pads = attrs.get("pads")
    if pads:
        n = len(pads) // 2
        return [(int(pads[i]), int(pads[i + n])) for i in range(n)]
    return "VALID"


def _dequant_w(w: np.ndarray, scale: np.ndarray,
               zp: np.ndarray) -> np.ndarray:
    """Weights to float; per-output-channel scale broadcasts on axis 0."""
    s = np.asarray(scale, np.float64)
    z = np.asarray(zp, np.float64)
    if s.ndim == 0 or s.size == 1:
        return ((w.astype(np.float64) - z.reshape(()) if z.size == 1
                 else w.astype(np.float64) - z) * s.reshape(())) \
            .astype(np.float32)
    bshape = [1] * w.ndim
    bshape[0] = s.size
    return ((w.astype(np.float64) - z.reshape(bshape))
            * s.reshape(bshape)).astype(np.float32)


def _qrange_clip(y: torch.Tensor, scale, zp, dtype) -> torch.Tensor:
    info = np.iinfo(dtype)
    s = float(np.asarray(scale).reshape(-1)[0])
    z = float(np.asarray(zp).reshape(-1)[0])
    return torch.clamp(y, (info.min - z) * s, (info.max - z) * s)


def _boundaries(nodes: List[_Node], inits: Dict[str, np.ndarray],
                g_in, g_out):
    """Quantized graph boundaries, as the JAX importer finds them: a
    u8/i8 graph input consumed by a DequantizeLinear dequantizes with that
    node's scale/zp at the boundary; a u8/i8 graph output produced by a
    QuantizeLinear requantizes there."""
    in_q: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    out_q: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    quant_names = {name for name, dtype, _ in g_in + g_out
                   if np.dtype(dtype) in (np.dtype(np.uint8),
                                          np.dtype(np.int8))}
    # exporters sometimes emit scale/zero_point as Constant nodes rather
    # than initializers
    bound = dict(inits)
    for node in nodes:
        if node.op == "Constant" and node.outputs:
            v = node.attrs.get("value")
            if v is not None:
                bound.setdefault(node.outputs[0], np.asarray(v))

    def _qparams(node, default_zp_dtype):
        if node.inputs[1] not in bound:
            raise NotImplementedError(
                f"{node.op} at a quantized graph boundary needs a "
                f"compile-time scale; {node.inputs[1]!r} is not an "
                "initializer or Constant")
        scale = bound[node.inputs[1]]
        zp = bound.get(node.inputs[2]) if len(node.inputs) > 2 \
            and node.inputs[2] else None
        return scale, (zp if zp is not None
                       else np.zeros(1, default_zp_dtype))

    for node in nodes:
        if node.op == "DequantizeLinear" and node.inputs[0] in quant_names:
            in_q[node.inputs[0]] = _qparams(node, np.int64)
        if node.op == "QuantizeLinear" and node.outputs[0] in quant_names:
            out_q[node.outputs[0]] = _qparams(node, np.uint8)
    return in_q, out_q


class ONNXModule(GraphModule):
    """The graph's nodes as a module (see interop/graph.py)."""

    def __init__(self, nodes: List[_Node], inits: Dict[str, np.ndarray],
                 g_in, g_out):
        super().__init__()
        in_q, out_q = _boundaries(nodes, inits, g_in, g_out)
        self._g = Static(nodes=nodes, inits=dict(inits), g_in=g_in,
                         g_out=g_out, in_q=in_q, out_q=out_q)

    def walk(self, *args):
        g = self._g
        env: Dict[str, Any] = {}
        for (name, dtype, shape), x in zip(g.g_in, args):
            if tuple(x.shape) != shape and int(np.prod(shape)) == x.numel():
                x = x.reshape(shape)
            if name in g.in_q:
                scale, zp = g.in_q[name]
                x = (x.to(torch.float32)
                     - float(np.asarray(zp).reshape(-1)[0])) \
                    * float(np.asarray(scale).reshape(-1)[0])
            env[name] = x
        for n, node in enumerate(g.nodes):
            outs = self._eval_node(n, node, env)
            for oname, oval in zip(node.outputs, outs):
                env[oname] = oval
        results = []
        for name, dtype, _ in g.g_out:
            y = self._val(env, name)
            if name in g.out_q:
                scale, zp = g.out_q[name]
                info = np.iinfo(dtype)
                q = torch.round(y / float(np.asarray(scale).reshape(-1)[0])) \
                    + float(np.asarray(zp).reshape(-1)[0])
                y = torch.clamp(q, info.min, info.max).to(torch_dtype(dtype))
            results.append(y)
        return results

    # -- values -----------------------------------------------------------
    def _raw(self, env: Dict[str, Any], name: str):
        if name in env:
            return env[name]
        if name in self._g.inits:
            return self._g.inits[name]
        raise KeyError(f"onnx tensor {name!r} not materialized")

    def _val(self, env: Dict[str, Any], name: str) -> torch.Tensor:
        """A value as a tensor; host values (initializers, Constant and
        Shape outputs) become buffers."""
        v = self._raw(env, name)
        if isinstance(v, torch.Tensor):
            return v
        return self.const(("v", name), lambda: np.asarray(v))

    def _npval(self, env: Dict[str, Any], name: str) -> np.ndarray:
        v = self._raw(env, name)
        if isinstance(v, np.ndarray):
            return v
        raise NotImplementedError(
            f"onnx: need compile-time constant {name!r}")

    # -- ops --------------------------------------------------------------
    def _eval_node(self, n: int, node: _Node, env: Dict[str, Any]
                   ) -> List[Any]:
        op, a = node.op, node.attrs
        i = node.inputs

        def val(name):
            return self._val(env, name)

        def npval(name):
            return self._npval(env, name)

        def host(key, make):
            return self.const((key, n), make)

        def qval(x_idx: int, scale_idx: int, zp_idx: int):
            """A QLinear op's activation operand: runtime values are
            already float (simulation), but quantized CONSTANTS (a bias
            fed as a u8 initializer) dequantize with their scale/zp."""
            v = self._raw(env, i[x_idx])
            if isinstance(v, np.ndarray) and v.dtype in (np.uint8, np.int8):
                return host(("q", x_idx), lambda: _dequant_w(
                    v, npval(i[scale_idx]), npval(i[zp_idx])))
            return val(i[x_idx])

        def conv(x, w_key, make_w, b_make):
            w = host(w_key, make_w)
            b = None if b_make is None else host(
                "b", lambda: b_make().reshape(1, -1, 1, 1))
            return conv2d_nchw(x, w, b, tuple(a.get("strides", [1, 1])),
                               _conv_padding(a),
                               tuple(a.get("dilations", [1, 1])),
                               int(a.get("group", 1)))

        if op == "Conv":
            return [conv(val(i[0]), "w",
                         lambda: np.asarray(npval(i[1]), np.float32),
                         (lambda: np.asarray(npval(i[2]), np.float32))
                         if len(i) > 2 else None)]

        if op == "QLinearConv":
            def bias():
                # int32 bias, scale = x_scale * w_scale (per channel)
                bs = np.asarray(npval(i[1]), np.float64) * \
                    np.asarray(npval(i[4]), np.float64).reshape(-1)
                return (npval(i[8]).astype(np.float64) * bs) \
                    .astype(np.float32)
            y = conv(val(i[0]), "w",
                     lambda: _dequant_w(npval(i[3]), npval(i[4]),
                                        npval(i[5])),
                     bias if len(i) > 8 else None)
            return [_qrange_clip(y, npval(i[6]), npval(i[7]),
                                 npval(i[7]).dtype)]

        if op in ("QuantizeLinear", "DequantizeLinear"):
            x = self._raw(env, i[0])
            if isinstance(x, np.ndarray) and x.dtype in (np.uint8, np.int8):
                # dequantizing a quantized constant
                return [host("dq", lambda: _dequant_w(
                    x, npval(i[1]), npval(i[2]) if len(i) > 2 else
                    np.zeros(1, np.int64)))]
            x = val(i[0])
            if op == "QuantizeLinear":
                zp = npval(i[2]) if len(i) > 2 else np.zeros(1, np.uint8)
                return [_qrange_clip(x, npval(i[1]), zp, zp.dtype)]
            return [x]  # float simulation: already float

        if op == "QLinearAdd":  # com.microsoft
            y = qval(0, 1, 2) + qval(3, 4, 5)
            return [_qrange_clip(y, npval(i[6]), npval(i[7]),
                                 npval(i[7]).dtype)]

        if op == "QLinearMul":
            y = qval(0, 1, 2) * qval(3, 4, 5)
            return [_qrange_clip(y, npval(i[6]), npval(i[7]),
                                 npval(i[7]).dtype)]

        if op == "QLinearGlobalAveragePool":
            y = torch.mean(qval(0, 1, 2), dim=(2, 3), keepdim=True)
            return [_qrange_clip(y, npval(i[3]), npval(i[4]),
                                 npval(i[4]).dtype)]

        if op == "QLinearMatMul":
            w = host("w", lambda: _dequant_w(npval(i[3]), npval(i[4]),
                                             npval(i[5])))
            y = torch.matmul(val(i[0]), w)
            return [_qrange_clip(y, npval(i[6]), npval(i[7]),
                                 npval(i[7]).dtype)]

        if op == "Add":
            return [val(i[0]) + val(i[1])]
        if op == "Sub":
            return [val(i[0]) - val(i[1])]
        if op == "Mul":
            return [val(i[0]) * val(i[1])]
        if op == "Div":
            return [val(i[0]) / val(i[1])]
        if op == "Relu":
            return [torch.clamp(val(i[0]), min=0.0)]
        if op == "Sigmoid":
            return [1.0 / (1.0 + torch.exp(-val(i[0])))]
        if op == "Tanh":
            return [torch.tanh(val(i[0]))]
        if op == "Clip":
            lo = float(npval(i[1])) if len(i) > 1 and i[1] else \
                a.get("min", -np.inf)
            hi = float(npval(i[2])) if len(i) > 2 and i[2] else \
                a.get("max", np.inf)
            return [torch.clamp(val(i[0]), lo, hi)]
        if op == "LeakyRelu":
            alpha = a.get("alpha", 0.01)
            x = val(i[0])
            return [torch.where(x >= 0, x, alpha * x)]
        if op == "HardSwish":
            x = val(i[0])
            return [x * torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)]
        if op == "HardSigmoid":
            return [torch.clamp(val(i[0]) * a.get("alpha", 0.2)
                                + a.get("beta", 0.5), 0.0, 1.0)]
        if op == "Erf":
            return [torch.erf(val(i[0]))]
        if op == "Exp":
            return [torch.exp(val(i[0]))]
        if op == "Sqrt":
            return [torch.sqrt(val(i[0]))]
        if op == "Pow":
            return [val(i[0]) ** val(i[1])]

        if op == "GlobalAveragePool":
            return [torch.mean(val(i[0]), dim=(2, 3), keepdim=True)]

        if op in ("MaxPool", "AveragePool"):
            k = tuple(a["kernel_shape"])
            strides = tuple(a.get("strides", [1] * len(k)))
            pads = a.get("pads")
            if pads and any(pads):
                nsp = len(pads) // 2
                pad = [(int(pads[d]), int(pads[d + nsp])) for d in range(nsp)]
            else:
                pad = "VALID"
            return [pool_nchw(self, n, val(i[0]), k, strides, pad,
                              "max" if op == "MaxPool" else "avg")]

        if op == "Gemm":
            w = host("w", lambda: np.ascontiguousarray(
                np.asarray(npval(i[1]), np.float32).T
                if a.get("transB", 0) else
                np.asarray(npval(i[1]), np.float32)))
            x = val(i[0])
            y = (x if not a.get("transA", 0) else x.T) @ w \
                * a.get("alpha", 1.0)
            if len(i) > 2:
                y = y + host("c", lambda: np.asarray(npval(i[2]), np.float32)
                             * a.get("beta", 1.0))
            return [y]

        if op == "MatMul":
            return [torch.matmul(val(i[0]), val(i[1]))]

        if op == "Reshape":
            shape = [int(d) for d in npval(i[1])]
            return [val(i[0]).reshape(shape)]
        if op == "Flatten":
            x = val(i[0])
            axis = a.get("axis", 1)
            lead = int(np.prod(x.shape[:axis])) if axis else 1
            return [x.reshape(lead, -1)]
        if op == "Transpose":
            x = val(i[0])
            perm = a.get("perm")
            return [x.permute(list(perm) if perm is not None
                              else list(reversed(range(x.ndim))))]
        if op == "Concat":
            return [torch.cat([val(m) for m in i], dim=a["axis"])]
        if op == "Squeeze":
            axes = a.get("axes") or ([int(d) for d in npval(i[1])]
                                     if len(i) > 1 else None)
            x = val(i[0])
            return [torch.squeeze(x) if axes is None
                    else torch.squeeze(x, tuple(axes))]
        if op == "Unsqueeze":
            axes = a.get("axes") or [int(d) for d in npval(i[1])]
            x = val(i[0])
            for ax in sorted(axes):
                x = torch.unsqueeze(x, ax)
            return [x]
        if op == "Softmax":
            return [softmax(val(i[0]), a.get("axis", -1))]
        if op == "ReduceMean":
            axes = a.get("axes") or ([int(d) for d in npval(i[1])]
                                     if len(i) > 1 else None)
            x = val(i[0])
            return [torch.mean(x, dim=reduce_dims(x, axes or None),
                               keepdim=bool(a.get("keepdims", 1)))]
        if op == "Shape":
            return [np.asarray(val(i[0]).shape, np.int64)]
        if op == "Gather":
            x, axis = val(i[0]), a.get("axis", 0)
            idx = val(i[1]).to(torch.int64)
            idx = torch.where(idx < 0, idx + x.shape[axis], idx)
            y = x.index_select(axis, idx.reshape(-1))
            return [y.reshape(*x.shape[:axis], *idx.shape,
                              *x.shape[axis + 1:])]
        if op == "Constant":
            return [a.get("value")]
        if op == "Identity":
            return [val(i[0])]
        if op == "Cast":
            return [val(i[0]).to(torch_dtype(_ELEM_NP[a["to"]]))]
        if op == "Pad":
            x = val(i[0])
            pads = a.get("pads") or [int(p) for p in npval(i[1])]
            nax = len(pads) // 2
            if len(i) > 3 and i[3]:  # opset-18 optional axes input
                axes = [int(ax) % x.ndim for ax in npval(i[3])]
                widths = [(0, 0)] * x.ndim
                for k, ax in enumerate(axes):
                    widths[ax] = (pads[k], pads[k + nax])
            else:
                widths = [(pads[d], pads[d + nax]) for d in range(nax)]
            mode = a.get("mode", "constant")
            if isinstance(mode, bytes):
                mode = mode.decode()
            if mode == "constant":
                cval = a.get("value", 0.0)
                if len(i) > 2 and i[2]:
                    cval = float(np.asarray(npval(i[2])).reshape(-1)[0])
                return [pad_widths(x, widths, value=cval)]
            if mode in ("reflect", "edge"):
                return [pad_widths(x, widths, mode=mode)]
            raise NotImplementedError(f"Pad mode {mode!r} unsupported")
        if op == "BatchNormalization":
            x = val(i[0])
            shape = [1, -1] + [1] * (x.ndim - 2)

            def param(k, f):
                return host(("bn", k), lambda: f(
                    *(np.asarray(npval(i[j]), np.float32)
                      for j in (1, 2, 3, 4))).reshape(shape))
            eps = a.get("epsilon", 1e-5)
            mean = param("mean", lambda s, b, m, v: m)
            sd = param("sd", lambda s, b, m, v: np.sqrt(v + eps))
            scale = param("scale", lambda s, b, m, v: s)
            bias = param("bias", lambda s, b, m, v: b)
            return [(x - mean) / sd * scale + bias]

        raise NotImplementedError(f"onnx op {op!r} not supported")


# -- public API ------------------------------------------------------------

def _info(entries) -> TensorsInfo:
    infos = TensorsInfo()
    for name, dtype, shape in entries:
        infos.append(TensorInfo(
            name=name or None,
            type=TensorType.from_dtype(np.dtype(dtype)),
            shape=tuple(int(d) for d in shape)))
    return infos


def load(path: str) -> ONNXModel:
    """Parse a .onnx file and build its module on the CPU; an op the
    importer does not lower raises here, at load."""
    nodes, inits, g_in, g_out = parse(path)
    in_info = _info(g_in)
    module = ONNXModule(nodes, inits, g_in, g_out)
    module.record([np.zeros(i.shape, i.type.np_dtype) for i in in_info])
    return ONNXModel(module=module.eval(), input_info=in_info,
                     output_info=_info(g_out), path=path)
