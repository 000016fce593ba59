"""tensor_transform — element-wise ops on tensor streams.

Port of ``nnstreamer_tpu/elements/transform.py`` (≙ gst/nnstreamer/
elements/gsttensor_transform.c): modes typecast / arithmetic / transpose
/ dimchg / stand / clamp / padding with the reference's option-string
grammar (e.g. ``mode=arithmetic option=typecast:float32,add:-127.5,
div:127.5``).

One ``_op`` serves both paths through a small array namespace:

* host chunks go through :data:`NUMPY`, the same numpy calls as the JAX
  package's host path, so the bytes are equal;
* a chunk that is a CUDA tensor, with ``acceleration=true``, goes
  through :data:`TORCH` and stays on the card. It computes what the JAX
  element's ``jax.jit`` of ``jnp`` ops computes, dtypes included: a
  per-channel operand is float32, as jnp makes a float64 numpy array
  without x64 (torch would promote a uint8 tensor to float64 with it);
  ``std`` has no Bessel correction (``jnp.std``'s ddof 0); ``clip``'s
  float bounds promote an integer tensor to float32, as jnp's weak
  floats do.

The fusion hooks (``device_veto``, ``device_fn``, ``_dtype_stable``)
wrap the same :data:`TORCH` path: a fused segment runs the mode's torch
ops inside its program, and only configurations whose every step has
the same dtype on the host (numpy) and in the reference's fused program
fuse, so fused and unfused runs stay byte-identical.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..pipeline.element import TransformElement
from ..pipeline.registry import register_element
from ..tensors.buffer import Buffer, Chunk
from ..tensors.caps import Caps
from ..tensors.info import TensorInfo, TensorsConfig, TensorsInfo
from ..tensors.transfer import is_device_tensor
from ..tensors.types import TensorType

_ARITH_OPS = ("typecast", "add", "mul", "div")


def _parse_arith(option: str) -> List[Tuple[str, Any]]:
    """"typecast:float32,add:-127.5,div:127.5,add:1:2:3" ->
    [(op, scalar-or-vector)] applied in order. Multi-value operands are
    per-channel (innermost dim), ref per-channel option strings."""
    ops: List[Tuple[str, Any]] = []
    for part in option.split(","):
        part = part.strip()
        if not part:
            continue
        op, _, operand = part.partition(":")
        op = op.strip().lower()
        if op not in _ARITH_OPS:
            raise ValueError(f"unknown arithmetic op {op!r}")
        if op == "typecast":
            ops.append((op, TensorType.from_string(operand.strip())))
        else:
            vals = [float(v) for v in operand.split(":")]
            ops.append((op, vals[0] if len(vals) == 1 else np.array(vals)))
    return ops


class _Numpy:
    """The host path's namespace: the JAX package's numpy calls."""

    @staticmethod
    def astype(arr, ttype: TensorType):
        return arr.astype(ttype.np_dtype)

    @staticmethod
    def operand(arr, value):
        return value

    @staticmethod
    def is_float(arr) -> bool:
        return arr.dtype in (np.float32, np.float64)

    transpose = staticmethod(np.transpose)
    moveaxis = staticmethod(np.moveaxis)
    clip = staticmethod(np.clip)
    mean = staticmethod(np.mean)
    std = staticmethod(np.std)
    pad = staticmethod(np.pad)


class _Torch:
    """The device path's namespace: torch ops with jnp's dtypes."""

    @staticmethod
    def astype(arr, ttype: TensorType):
        dt = ttype.torch_dtype
        out = arr.to(dt)
        if arr.is_floating_point() and not out.is_floating_point():
            # XLA's float -> int convert saturates and maps NaN to 0,
            # where a plain cast wraps (as numpy's does)
            info = torch.iinfo(dt)
            out = torch.where(arr >= info.max, info.max, out)
            out = torch.where(arr <= info.min, info.min, out)
            out = torch.where(arr.isnan(), 0, out)
        return out

    @staticmethod
    def operand(arr, value):
        if isinstance(value, np.ndarray):  # jnp: float32 without x64
            return torch.as_tensor(value, dtype=torch.float32,
                                   device=arr.device)
        return value

    @staticmethod
    def is_float(arr) -> bool:
        return arr.dtype in (torch.float32, torch.float64)

    @staticmethod
    def transpose(arr, axes: Sequence[int]):
        return arr.permute(*axes).contiguous()

    @staticmethod
    def moveaxis(arr, src: int, dst: int):
        return arr.movedim(src, dst).contiguous()

    @staticmethod
    def clip(arr, lo: float, hi: float):
        if not arr.is_floating_point():  # jnp: int with weak float -> f32
            arr = arr.to(torch.float32)
        return arr.clamp(lo, hi)

    @staticmethod
    def mean(arr):
        return arr.mean()

    @staticmethod
    def std(arr):
        return arr.std(correction=0)

    @staticmethod
    def pad(arr, pads: Sequence[Tuple[int, int]]):
        flat = [w for lo_hi in reversed(pads) for w in lo_hi]
        return F.pad(arr, flat)


NUMPY, TORCH = _Numpy(), _Torch()


def _apply_arith(arr, ops, xp):
    for op, operand in ops:
        if op == "typecast":
            arr = xp.astype(arr, operand)
        elif op == "add":
            arr = arr + xp.operand(arr, operand)
        elif op == "mul":
            arr = arr * xp.operand(arr, operand)
        elif op == "div":
            arr = arr / xp.operand(arr, operand)
    return arr


def _ref_axes_to_np(axes_str: str, ndim: int) -> Tuple[int, ...]:
    """Reference transpose option is innermost-first dim indices
    ("1:0:2:3" swaps the two innermost). Convert to NumPy-order axes."""
    ref_axes = [int(a) for a in axes_str.split(":")]
    if len(ref_axes) < ndim:
        ref_axes += list(range(len(ref_axes), ndim))
    ref_axes = ref_axes[:ndim]
    # ref index i = numpy axis (ndim-1-i)
    np_axes = [0] * ndim
    for out_ref, in_ref in enumerate(ref_axes):
        np_axes[ndim - 1 - out_ref] = ndim - 1 - in_ref
    return tuple(np_axes)


@register_element("tensor_transform")
class TensorTransform(TransformElement):
    SINK_TEMPLATES = {"sink": "other/tensors"}
    SRC_TEMPLATES = {"src": "other/tensors"}
    PROPS = {"mode": "", "option": "", "acceleration": True,
             "transpose-rank-limit": 4}

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._arith = None

    def start(self) -> None:
        super().start()
        if self.mode == "arithmetic":
            self._arith = _parse_arith(self.option)
        elif self.mode == "typecast":
            self._arith = [("typecast", TensorType.from_string(self.option))]

    # -- negotiation ------------------------------------------------------
    def transform_caps(self, incaps: Caps) -> Optional[Caps]:
        cfg = incaps.to_config()
        if not len(cfg.info):
            return incaps
        out = TensorsInfo()
        for info in cfg.info:
            out.append(self._transform_info(info))
        return Caps.from_config(TensorsConfig(out, cfg.format,
                                              cfg.rate_n, cfg.rate_d))

    def _transform_info(self, info: TensorInfo) -> TensorInfo:
        mode, opt = self.mode, self.option
        shape, ttype = tuple(info.shape), info.type
        if mode in ("typecast", "arithmetic"):
            ops = self._arith if self._arith is not None else (
                _parse_arith(opt) if mode == "arithmetic"
                else [("typecast", TensorType.from_string(opt))])
            for op, operand in ops:
                if op == "typecast":
                    ttype = operand
        elif mode == "transpose":
            axes = _ref_axes_to_np(opt, len(shape))
            shape = tuple(shape[a] for a in axes)
        elif mode == "dimchg":
            frm, to = (int(x) for x in opt.split(":"))
            nd = len(shape)
            np_from, np_to = nd - 1 - frm, nd - 1 - to
            dims = list(shape)
            d = dims.pop(np_from)
            dims.insert(np_to, d)
            shape = tuple(dims)
        elif mode == "clamp":
            pass
        elif mode == "stand":
            parts = opt.split(":")
            if len(parts) > 1:
                ttype = TensorType.from_string(parts[1])
            elif ttype not in (TensorType.FLOAT32, TensorType.FLOAT64):
                ttype = TensorType.FLOAT32
        elif mode == "padding":
            pads = self._parse_padding(opt, len(shape))
            shape = tuple(s + lo + hi for s, (lo, hi) in zip(shape, pads))
        elif mode == "":
            raise ValueError(f"{self.name}: 'mode' property is required")
        return TensorInfo(info.name, ttype, shape)

    @staticmethod
    def _parse_padding(opt: str, ndim: int) -> List[Tuple[int, int]]:
        """Option "left,right,dim[,left,right,dim...]" with reference
        innermost-first dim indices -> numpy pad widths."""
        toks = [int(t) for t in opt.replace(":", ",").split(",") if t != ""]
        pads = [(0, 0)] * ndim
        for i in range(0, len(toks), 3):
            left, right, ref_dim = toks[i:i + 3]
            pads[ndim - 1 - ref_dim] = (left, right)
        return pads

    # -- device placement (fusion compiler) --------------------------------
    DEVICE_FUSIBLE = ("typecast/arithmetic/transpose/dimchg/padding (dtype-"
                      "stable configs); clamp on float32; stand stays host")

    def device_veto(self) -> Optional[str]:
        if not self.mode:
            return "mode not set"
        if not self.acceleration:
            return "acceleration=false"
        if self.mode == "stand":
            return ("stand: float reductions (mean/std) are not byte-"
                    "stable between host numpy and the device")
        return None

    def device_fn(self, ctx=None):
        if self.device_veto() is not None:
            return None
        if self._arith is None and self.mode in ("arithmetic", "typecast"):
            # mirror start(): device_fn may run before the element starts
            if self.mode == "arithmetic":
                self._arith = _parse_arith(self.option)
            else:
                self._arith = [("typecast",
                                TensorType.from_string(self.option))]
        cfg = getattr(ctx, "in_config", None) if ctx is not None else None
        if not self._dtype_stable(cfg):
            return None
        op = self._op

        def fn(arrays):
            return [op(a, TORCH) for a in arrays]

        return fn

    def _dtype_stable(self, cfg) -> bool:
        """Byte-parity guard for the fused path: numpy promotes
        (int array, float scalar) to float64 where the device path stays
        float32, and float->int casts truncate differently on the host
        and the device — only fuse configs where every step computes at
        an exactly matching dtype on both."""
        if cfg is None:
            return False
        if self.mode in ("transpose", "dimchg", "padding"):
            return True  # dtype-preserving data movement, any dtype
        floats = (TensorType.FLOAT32, TensorType.FLOAT64,
                  TensorType.FLOAT16, TensorType.BFLOAT16)
        for i in range(len(cfg.info)):
            dt = cfg.info[i].type
            if self.mode == "clamp":
                if dt != TensorType.FLOAT32:
                    return False
                continue
            for op, operand in (self._arith or ()):
                if op == "typecast":
                    if dt in floats and operand not in floats:
                        return False  # float->int casts truncate differently
                    dt = operand
                    if dt in (TensorType.FLOAT64, TensorType.INT64,
                              TensorType.UINT64):
                        return False
                    continue
                if isinstance(operand, np.ndarray):
                    return False  # float64 vector operand promotes differently
                if dt != TensorType.FLOAT32:
                    return False
        return True

    # -- dataflow ---------------------------------------------------------
    def transform(self, buf: Buffer) -> Optional[Buffer]:
        chunks = []
        for c in buf.chunks:
            # one read: an in-flight fetch may land between two of them
            raw = c.raw
            if self.acceleration and is_device_tensor(raw):
                chunks.append(Chunk(self._op(raw, TORCH)))
            else:
                chunks.append(Chunk(self._op(c.host(), NUMPY)))
        return buf.with_chunks(chunks)

    def _op(self, arr, xp):
        """The mode on ``arr`` in namespace ``xp`` (:data:`NUMPY` for
        host arrays, :data:`TORCH` for tensors)."""
        mode, opt = self.mode, self.option
        if mode in ("typecast", "arithmetic"):
            ops = self._arith if self._arith is not None else _parse_arith(opt)
            return _apply_arith(arr, ops, xp)
        if mode == "transpose":
            return xp.transpose(arr, _ref_axes_to_np(opt, arr.ndim))
        if mode == "dimchg":
            frm, to = (int(x) for x in opt.split(":"))
            nd = arr.ndim
            return xp.moveaxis(arr, nd - 1 - frm, nd - 1 - to)
        if mode == "clamp":
            lo, hi = (float(x) for x in opt.split(":"))
            return xp.clip(arr, lo, hi)
        if mode == "stand":
            parts = opt.split(":")
            if len(parts) > 1:
                x = xp.astype(arr, TensorType.from_string(parts[1]))
            else:
                x = arr if xp.is_float(arr) \
                    else xp.astype(arr, TensorType.FLOAT32)
            if parts[0] == "dc-average":
                return x - xp.mean(x)
            std = xp.std(x)
            return (x - xp.mean(x)) / (std + 1e-10)
        if mode == "padding":
            pads = self._parse_padding(opt, arr.ndim)
            return xp.pad(arr, pads)
        raise ValueError(f"{self.name}: unknown mode {mode!r}")
