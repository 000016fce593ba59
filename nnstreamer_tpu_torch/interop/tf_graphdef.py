"""TensorFlow GraphDef (.pb) importer: frozen graphs -> one torch module.

Port of ``nnstreamer_tpu/interop/tf_graphdef.py`` (≙ ext/nnstreamer/
tensor_filter/tensor_filter_tensorflow.cc, which feeds the .pb to the TF
C API). The GraphDef protobuf is walked with the schema-less wire codec
(interop/protowire.py; the JAX importer's parser, copied), and the nodes
become a :class:`~.graph.GraphModule` whose ``forward`` lowers each one
to torch ops: no tensorflow dependency.

Supported op set mirrors the JAX importer: common inference ops lower;
anything else raises NotImplementedError naming the op, at load (fail
loud, never silently wrong). Tensors flow NHWC, as in the graph.

GraphDef wire schema (tensorflow/core/framework/graph.proto):
  GraphDef.node = 1 (NodeDef)
  NodeDef: name=1, op=2, input=3 (repeated), device=4, attr=5 (map)
  map entry: key=1, value=2 (AttrValue)
  AttrValue: s=2, i=3, f=4, b=5, type=6, shape=7, tensor=8, list=1
  AttrValue.ListValue: s=2, i=3, f=4, b=5, type=6, shape=7, tensor=8
  TensorProto: dtype=1, tensor_shape=2, tensor_content=4, float_val=5,
               int_val=7, int64_val=10 (content preferred; *_val fallback)
  TensorShapeProto: dim=2 -> Dim: size=1, name=2
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..tensors.info import TensorInfo, TensorsInfo
from ..tensors.types import TensorType
from .graph import (GraphModule, Static, conv2d_nhwc, pad_widths, pool_nhwc,
                    softmax)
from .protowire import as_f32, as_sint, decode, packed_varints

# tensorflow DataType enum -> numpy dtype (types.proto)
_TF_DTYPES = {
    1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8, 5: np.int16,
    6: np.int8, 9: np.int64, 10: np.bool_, 17: np.uint16, 22: np.uint32,
    23: np.uint64, 19: np.float16,
}


@dataclasses.dataclass
class _Node:
    name: str
    op: str
    inputs: List[str]
    attrs: Dict[str, Dict[int, list]]  # attr name -> decoded AttrValue


@dataclasses.dataclass
class TFModel:
    module: "TFGraphModule"
    input_info: TensorsInfo
    output_info: TensorsInfo
    path: str


# -- proto walking -------------------------------------------------------------

def _attr_shape(av: Dict[int, list]) -> Tuple[int, ...]:
    shp = decode(av[7][0]) if 7 in av else {}
    dims = []
    for d in shp.get(2, []):
        dd = decode(d)
        size = int(dd.get(1, [0])[0])
        # int64 may arrive as unsigned varint; -1 (unknown) wraps huge
        if size > (1 << 62):
            size = size - (1 << 64)
        dims.append(size)
    return tuple(dims)


def _attr_tensor(av: Dict[int, list]) -> np.ndarray:
    tp = decode(av[8][0])
    dtype = _TF_DTYPES.get(int(tp.get(1, [1])[0]), np.float32)
    dims: List[int] = []
    if 2 in tp:
        shp = decode(tp[2][0])
        for d in shp.get(2, []):
            dims.append(int(decode(d).get(1, [0])[0]))
    if 4 in tp and tp[4][0]:
        arr = np.frombuffer(tp[4][0], dtype=np.dtype(dtype).newbyteorder("<"))
    elif 5 in tp:      # float_val (packed or repeated)
        raw = tp[5][0] if isinstance(tp[5][0], bytes) else None
        if raw is not None:
            arr = np.frombuffer(raw, "<f4")
        else:
            arr = np.asarray([as_f32(v) for v in tp[5]], np.float32)
    elif 7 in tp:      # int_val (field 7; 8 is string_val)
        vals = (packed_varints(tp[7][0]) if isinstance(tp[7][0], bytes)
                else [int(v) for v in tp[7]])
        arr = np.asarray([as_sint(v) for v in vals], np.int64) \
            .astype(np.int32)
    elif 10 in tp:     # int64_val
        vals = (packed_varints(tp[10][0]) if isinstance(tp[10][0], bytes)
                else [int(v) for v in tp[10]])
        arr = np.asarray([as_sint(v) for v in vals], np.int64)
    else:
        arr = np.zeros(0, dtype)
    arr = arr.astype(dtype)
    if dims:
        if arr.size == 1 and int(np.prod(dims)) > 1:
            arr = np.full(dims, arr.reshape(-1)[0])  # splat scalar
        arr = arr.reshape(dims)
    return arr


def _parse(data: bytes) -> List[_Node]:
    g = decode(data)
    nodes = []
    for nb in g.get(1, []):
        nd = decode(nb)
        attrs: Dict[str, Dict[int, list]] = {}
        for ab in nd.get(5, []):
            entry = decode(ab)
            key = entry.get(1, [b""])[0].decode()
            attrs[key] = decode(entry.get(2, [b""])[0])
        nodes.append(_Node(
            name=nd.get(1, [b""])[0].decode(),
            op=nd.get(2, [b""])[0].decode(),
            inputs=[i.decode() for i in nd.get(3, [])],
            attrs=attrs))
    return nodes


def _canon(ref: str) -> str:
    """'node:0' -> 'node'; control deps '^node' handled by the caller."""
    return ref.split(":", 1)[0]


# -- attributes ------------------------------------------------------------------

def attr_i(n: _Node, key: str, default: int = 0) -> int:
    av = n.attrs.get(key)
    return int(av[3][0]) if av and 3 in av else default


def attr_b(n: _Node, key: str, default: bool = False) -> bool:
    av = n.attrs.get(key)
    return bool(av[5][0]) if av and 5 in av else default


def attr_f(n: _Node, key: str, default: float = 0.0) -> float:
    av = n.attrs.get(key)
    return as_f32(av[4][0]) if av and 4 in av else default


def attr_s(n: _Node, key: str, default: str = "") -> str:
    av = n.attrs.get(key)
    return av[2][0].decode() if av and 2 in av else default


def attr_ilist(n: _Node, key: str) -> List[int]:
    av = n.attrs.get(key)
    if not av or 1 not in av:
        return []
    lst = decode(av[1][0])
    raw = lst.get(3, [])
    if len(raw) == 1 and isinstance(raw[0], bytes):
        return [v for v in packed_varints(raw[0])]
    return [int(v) for v in raw]


# -- lowering ------------------------------------------------------------------

_SKIP = ("Const", "Placeholder", "NoOp")


class TFGraphModule(GraphModule):
    """The graph's nodes as a module (see interop/graph.py)."""

    def __init__(self, nodes: List[_Node], consts: Dict[str, np.ndarray],
                 placeholders: List[_Node], outputs: List[str]):
        super().__init__()
        self._g = Static(nodes=nodes, consts=consts,
                         placeholders=placeholders, outputs=outputs)

    def walk(self, *inputs):
        g = self._g
        env: Dict[str, Any] = dict(g.consts)
        for ph, x in zip(g.placeholders, inputs):
            env[ph.name] = x
        for k, n in enumerate(g.nodes):
            if n.op in _SKIP:
                continue
            env[n.name] = self._lower(k, n, env)
        return [self._tensor(env[o], o) for o in g.outputs]

    def _tensor(self, v, name: str) -> torch.Tensor:
        if isinstance(v, torch.Tensor):
            return v
        return self.const(("v", name), lambda: np.asarray(v))

    def _lower(self, k: int, n: _Node, env: Dict[str, Any]):
        refs = [_canon(i) for i in n.inputs if not i.startswith("^")]
        raw = [env[r] for r in refs]

        def t(j: int) -> torch.Tensor:
            return self._tensor(raw[j], refs[j])

        def host(key, make):
            return self.const((key, k), make)

        op = n.op
        if op in ("Identity", "StopGradient", "PreventGradient",
                  "CheckNumerics"):
            return raw[0]
        if op in ("Add", "AddV2", "BiasAdd"):
            return t(0) + t(1)
        if op == "Sub":
            return t(0) - t(1)
        if op == "Mul":
            return t(0) * t(1)
        if op in ("RealDiv", "Div"):
            return t(0) / t(1)
        if op == "Maximum":
            return torch.maximum(t(0), t(1))
        if op == "Minimum":
            return torch.minimum(t(0), t(1))
        if op == "MatMul":
            a, b = t(0), t(1)
            if attr_b(n, "transpose_a"):
                a = a.T
            if attr_b(n, "transpose_b"):
                b = b.T
            return a @ b
        if op == "Relu":
            return torch.clamp(t(0), min=0.0)
        if op == "Relu6":
            return torch.clamp(t(0), 0.0, 6.0)
        if op == "Softmax":
            return softmax(t(0), -1)
        if op == "Sigmoid":
            return torch.sigmoid(t(0))
        if op == "Tanh":
            return torch.tanh(t(0))
        if op == "Sqrt":
            return torch.sqrt(t(0))
        if op == "Rsqrt":
            return torch.rsqrt(t(0))
        if op == "Exp":
            return torch.exp(t(0))
        if op == "Neg":
            return -t(0)
        if op == "Square":
            x = t(0)
            return x * x
        if op == "Reshape":
            return t(0).reshape([int(d) for d in
                                 np.asarray(raw[1]).reshape(-1)])
        if op == "Squeeze":
            dims = attr_ilist(n, "squeeze_dims") or None
            x = t(0)
            return torch.squeeze(x) if dims is None else \
                torch.squeeze(x, tuple(dims))
        if op == "ExpandDims":
            return torch.unsqueeze(t(0),
                                   int(np.asarray(raw[1]).reshape(-1)[0]))
        if op in ("ConcatV2", "Concat"):
            if op == "ConcatV2":
                axis = int(np.asarray(raw[-1]).reshape(-1)[0])
                parts = range(len(raw) - 1)
            else:
                axis = int(np.asarray(raw[0]).reshape(-1)[0])
                parts = range(1, len(raw))
            return torch.cat([t(j) for j in parts], dim=axis)
        if op == "Pad":
            pads = np.asarray(raw[1]).astype(int)
            return pad_widths(t(0), [(int(a), int(b)) for a, b in pads])
        if op == "Mean":
            axes = tuple(int(a) for a in np.asarray(raw[1]).reshape(-1))
            return torch.mean(t(0), dim=axes,
                              keepdim=attr_b(n, "keep_dims"))
        if op in ("Conv2D", "DepthwiseConv2dNative"):
            strides = attr_ilist(n, "strides") or [1, 1, 1, 1]
            padding = attr_s(n, "padding", "SAME")
            if attr_s(n, "data_format", "NHWC") != "NHWC":
                raise NotImplementedError("tf import: only NHWC conv")
            dil = attr_ilist(n, "dilations")
            if dil and dil != [1, 1, 1, 1]:
                # fail loud rather than silently computing the
                # non-atrous variant (importer policy)
                raise NotImplementedError(
                    f"tf import: dilated conv not supported "
                    f"(dilations={dil}, node {n.name!r})")
            w = np.asarray(raw[1])
            groups = 1
            if op == "DepthwiseConv2dNative":
                # HWIM -> [in*mult, 1, H, W], groups = in_channels
                h, wd, cin, mult = w.shape
                groups = cin
                weight = host("w", lambda: np.ascontiguousarray(
                    w.reshape(h, wd, cin * mult).transpose(2, 0, 1)[:, None]))
            else:
                # HWIO data as a channels_last OIHW view
                weight = host("w", lambda: torch.from_numpy(
                    np.ascontiguousarray(w.transpose(3, 0, 1, 2)))
                    .permute(0, 3, 1, 2))
            return conv2d_nhwc(t(0), weight, None, tuple(strides[1:3]),
                               padding, groups=groups)
        if op in ("MaxPool", "AvgPool"):
            ksize = attr_ilist(n, "ksize") or [1, 1, 1, 1]
            strides = attr_ilist(n, "strides") or [1, 1, 1, 1]
            if ksize[0] != 1 or ksize[3] != 1 or strides[0] != 1 \
                    or strides[3] != 1:
                raise NotImplementedError(
                    f"tf import: {op} over the batch or channel axis "
                    f"(node {n.name!r})")
            return pool_nhwc(self, k, t(0), ksize[1:3], strides[1:3],
                             attr_s(n, "padding", "VALID"),
                             "max" if op == "MaxPool" else "avg")
        if op in ("FusedBatchNorm", "FusedBatchNormV3"):
            eps = attr_f(n, "epsilon", 1e-3)

            def folded():
                scale, offset, mean, var = (
                    torch.from_numpy(np.asarray(v, np.float32))
                    for v in raw[1:5])
                inv = scale * torch.rsqrt(var + eps)
                return torch.stack([inv, offset - mean * inv])
            inv, shift = host("bn", folded)
            return t(0) * inv + shift
        raise NotImplementedError(
            f"tf import: unsupported GraphDef op {op!r} (node {n.name!r})")


def load(path: str) -> TFModel:
    with open(path, "rb") as f:
        nodes = _parse(f.read())
    if not nodes:
        raise ValueError(f"{path}: empty or unparsable GraphDef")
    consts: Dict[str, np.ndarray] = {}
    placeholders: List[_Node] = []
    for n in nodes:
        if n.op == "Const":
            consts[n.name] = _attr_tensor(n.attrs["value"])
        elif n.op == "Placeholder":
            placeholders.append(n)
    consumed = {_canon(i) for n in nodes for i in n.inputs
                if not i.startswith("^")}
    outputs = [n.name for n in nodes
               if n.name not in consumed and n.op not in _SKIP]
    if not outputs:
        raise ValueError(f"{path}: no output nodes found")

    def _ph_info(ph: _Node) -> TensorInfo:
        dt = _TF_DTYPES.get(int(ph.attrs.get("dtype", {}).get(6, [1])[0]),
                            np.float32)
        shape = tuple(1 if d < 0 else d
                      for d in _attr_shape(ph.attrs.get("shape", {})))
        return TensorInfo(ph.name, TensorType.from_dtype(np.dtype(dt)),
                          shape or (1,))

    in_info = TensorsInfo(_ph_info(p) for p in placeholders)
    module = TFGraphModule(nodes, consts, placeholders, outputs)
    # one walk over zeros records the constants and gives the output
    # shapes and dtypes without running on the device
    outs = module.record([np.zeros(i.shape, i.type.np_dtype)
                          for i in in_info])
    out_info = TensorsInfo(
        TensorInfo(name, TensorType.from_dtype(o.dtype), tuple(o.shape))
        for name, o in zip(outputs, outs))
    return TFModel(module=module.eval(), input_info=in_info,
                   output_info=out_info, path=path)
