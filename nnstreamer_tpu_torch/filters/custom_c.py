"""framework=custom — native .so custom filters over the C ABI.

Port of ``nnstreamer_tpu/filters/custom_c.py`` (≙ gst/nnstreamer/
tensor_filter/tensor_filter_custom.c loading NNStreamer_custom_class from
a user .so). The ABI is ``csrc/nns_custom.h``: the .so exports
``nns_custom_get()``; ``model=`` is the path of the .so. The port keeps
its own ctypes mirror of the header's structs and needs no library of
its own.

The filter runs on the host: it declares ``HOST_INPUTS``, so the element
hands it host arrays, and it passes the .so host pointers into numpy
arrays it allocates for the outputs. A library that fails to load, or
whose ``init`` returns NULL, raises at open; an ``invoke`` that returns
a positive code drops the frame (:class:`InvokeDrop`).
"""
from __future__ import annotations

import ctypes
from typing import Any, List, Optional, Sequence

import numpy as np

from ..tensors.info import TensorInfo, TensorsInfo
from ..tensors.types import TensorType
from .base import FilterFramework, FilterProperties, InvokeDrop
from .registry import register_filter

# NNS_RANK_LIMIT / NNS_TENSOR_LIMIT of csrc/nns_custom.h
RANK_LIMIT = 16
TENSOR_LIMIT = 16


class NnsTensorInfo(ctypes.Structure):
    _fields_ = [("rank", ctypes.c_uint32),
                ("dims", ctypes.c_uint32 * RANK_LIMIT),
                ("type", ctypes.c_int32)]


class NnsTensorsInfo(ctypes.Structure):
    _fields_ = [("num", ctypes.c_uint32),
                ("info", NnsTensorInfo * TENSOR_LIMIT)]


# ctypes mirror of nns_custom_filter (csrc/nns_custom.h)
_INIT = ctypes.CFUNCTYPE(ctypes.c_void_p, ctypes.c_char_p)
_EXIT = ctypes.CFUNCTYPE(None, ctypes.c_void_p)
_GETDIM = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p,
                           ctypes.POINTER(NnsTensorsInfo))
_SETDIM = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p,
                           ctypes.POINTER(NnsTensorsInfo),
                           ctypes.POINTER(NnsTensorsInfo))
_INVOKE = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p,
                           ctypes.POINTER(NnsTensorsInfo),
                           ctypes.POINTER(ctypes.c_void_p),
                           ctypes.POINTER(NnsTensorsInfo),
                           ctypes.POINTER(ctypes.c_void_p))


class _CustomFilterStruct(ctypes.Structure):
    _fields_ = [("init", _INIT), ("exit", _EXIT),
                ("get_input_dim", _GETDIM), ("get_output_dim", _GETDIM),
                ("set_input_dim", _SETDIM), ("invoke", _INVOKE)]


# ordinals of csrc/nns_custom.h nns_tensor_type (no bfloat16 there)
_TYPE_ORDER = [TensorType.INT32, TensorType.UINT32, TensorType.INT16,
               TensorType.UINT16, TensorType.INT8, TensorType.UINT8,
               TensorType.FLOAT64, TensorType.FLOAT32, TensorType.INT64,
               TensorType.UINT64, TensorType.FLOAT16]


def _to_c_infos(infos: TensorsInfo) -> NnsTensorsInfo:
    if len(infos) > TENSOR_LIMIT:
        raise ValueError(
            f"custom-C ABI supports at most {TENSOR_LIMIT} tensors, "
            f"got {len(infos)} (nns_custom.h NNS_TENSOR_LIMIT)")
    out = NnsTensorsInfo()
    out.num = len(infos)
    for i, info in enumerate(infos):
        ci = out.info[i]
        dims = list(reversed(info.shape))  # innermost-first
        if len(dims) > RANK_LIMIT:
            raise ValueError(
                f"custom-C ABI supports rank <= {RANK_LIMIT}, got "
                f"{len(dims)} (nns_custom.h NNS_RANK_LIMIT)")
        ci.rank = len(dims)
        for d in range(RANK_LIMIT):
            ci.dims[d] = dims[d] if d < len(dims) else 1
        ci.type = _TYPE_ORDER.index(info.type)
    return out


def _from_c_infos(c: NnsTensorsInfo) -> TensorsInfo:
    infos = TensorsInfo()
    for i in range(c.num):
        ci = c.info[i]
        shape = tuple(reversed([ci.dims[d] for d in range(ci.rank)]))
        infos.append(TensorInfo(type=_TYPE_ORDER[ci.type], shape=shape))
    return infos


@register_filter
class CustomCFilter(FilterFramework):
    NAME = "custom"
    EXTENSIONS = (".so",)
    HOST_INPUTS = True

    def __init__(self):
        self._dll = None
        self._ops: Optional[_CustomFilterStruct] = None
        self._priv = None
        self._in_info: Optional[TensorsInfo] = None
        self._out_info: Optional[TensorsInfo] = None

    def open(self, props: FilterProperties) -> None:
        path = props.model_files[0]
        self._dll = ctypes.CDLL(path)
        get = self._dll.nns_custom_get
        get.argtypes = []
        get.restype = ctypes.POINTER(_CustomFilterStruct)
        self._ops = get().contents
        self._priv = self._ops.init(
            (props.custom_properties or "").encode())
        if not self._priv:
            raise RuntimeError(f"custom filter {path}: init failed")
        if self._ops.get_input_dim:
            cin, cout = NnsTensorsInfo(), NnsTensorsInfo()
            if self._ops.get_input_dim(self._priv, ctypes.byref(cin)) == 0 \
                    and cin.num:
                self._in_info = _from_c_infos(cin)
            if self._ops.get_output_dim and \
                    self._ops.get_output_dim(self._priv,
                                             ctypes.byref(cout)) == 0 \
                    and cout.num:
                self._out_info = _from_c_infos(cout)
        if props.input_info is not None and self._out_info is None:
            self.set_input_info(props.input_info)

    def close(self) -> None:
        if self._ops is not None and self._priv:
            self._ops.exit(self._priv)
            self._priv = None
        self._ops = None
        self._dll = None

    def get_model_info(self):
        return self._in_info, self._out_info

    def set_input_info(self, info: TensorsInfo) -> Optional[TensorsInfo]:
        if not self._ops.set_input_dim:
            return None
        cin = _to_c_infos(info)
        cout = NnsTensorsInfo()
        if self._ops.set_input_dim(self._priv, ctypes.byref(cin),
                                   ctypes.byref(cout)) != 0:
            raise RuntimeError("custom filter: set_input_dim failed")
        self._in_info = info.copy()
        self._out_info = _from_c_infos(cout)
        return self._out_info

    def invoke(self, inputs: Sequence[Any]) -> List[Any]:
        arrays = [np.ascontiguousarray(np.asarray(x)) for x in inputs]
        in_infos = TensorsInfo(
            TensorInfo(type=TensorType.from_dtype(a.dtype), shape=a.shape)
            for a in arrays)
        if self._out_info is None:
            self.set_input_info(in_infos)
        cin = _to_c_infos(in_infos)
        cout = _to_c_infos(self._out_info)
        outs = [np.empty(i.shape, i.type.np_dtype) for i in self._out_info]
        in_ptrs = (ctypes.c_void_p * len(arrays))(
            *[a.ctypes.data_as(ctypes.c_void_p).value for a in arrays])
        out_ptrs = (ctypes.c_void_p * len(outs))(
            *[o.ctypes.data_as(ctypes.c_void_p).value for o in outs])
        rc = self._ops.invoke(self._priv, ctypes.byref(cin), in_ptrs,
                              ctypes.byref(cout), out_ptrs)
        if rc > 0:
            # drop the frame, keep the pipeline (≙ invoke result > 0)
            raise InvokeDrop(f"custom filter dropped the frame ({rc})")
        if rc < 0:
            raise RuntimeError(f"custom filter invoke failed ({rc})")
        return list(outs)
