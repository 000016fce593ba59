"""The module an imported graph becomes, and the NHWC ops the importers
share.

The JAX importers return ``fn(*inputs)``, a closure that walks the parsed
op list over numpy constants, which ``jax.jit`` turns into device
constants. Here an importer returns a :class:`GraphModule`: its
``forward`` walks the same op list with torch ops, and every tensor it
derives from the file's constants (a dequantized weight in the layout
torch wants, a pool's divisor, a shape computed from static shapes) is a
buffer of the module, so it moves to the card once, with the module, and
not per frame.

Which constants the walk needs is found by walking once at import, on
the CPU, over zeros of the declared input shapes (:meth:`GraphModule.
record`): each :meth:`GraphModule.const` call then makes its tensor and
registers it as a buffer under its key; later walks, on any device, read
the buffer. The record run also gives the output shapes and dtypes (the
counterpart of ``jax.eval_shape``).

Layout: TFLite and GraphDef tensors flow as NHWC, as in the files. A
convolution or a pool sees ``x.permute(0, 3, 1, 2)``: an NCHW view of
NHWC memory, which is torch's ``channels_last`` layout, so no copy is
made on the way in or out (cuDNN runs such convolutions in NHWC), and
the weights are stored as ``channels_last`` OIHW views of the files'
OHWI data.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Hashable, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype."""
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


class Static:
    """The host-side graph a module walks (parsed ops, tensor metadata,
    the constants' host copies). Read-only after import, so a deep copy
    of the module (the backend moves copies between host and card)
    shares it instead of copying it."""

    def __init__(self, **fields):
        self.__dict__.update(fields)

    def __deepcopy__(self, memo):
        return self


class GraphModule(torch.nn.Module):
    """A walked graph whose derived constants are buffers (see the
    module's docstring). Subclasses implement ``walk(*inputs)``."""

    def __init__(self):
        super().__init__()
        self._const_names: Dict[Hashable, str] = {}
        self._recording = False

    def const(self, key: Hashable, make: Callable[[], Any]) -> torch.Tensor:
        """The buffer under ``key``; while recording, ``make()`` (a numpy
        array, or a tensor) makes it at the first call."""
        name = self._const_names.get(key)
        if name is not None:
            return getattr(self, name)
        if not self._recording:
            raise RuntimeError(f"constant {key!r} was not recorded at "
                               "import: the graph walked another path")
        value = make()
        t = value if isinstance(value, torch.Tensor) else \
            torch.from_numpy(np.array(value, copy=True))
        name = f"c{len(self._const_names)}"
        self.register_buffer(name, t, persistent=False)
        self._const_names[key] = name
        return t

    def record(self, inputs: Sequence[Any]) -> List[torch.Tensor]:
        """Walk once on ``inputs`` (host zeros of the declared shapes),
        registering every constant the walk asks for."""
        self._recording = True
        try:
            with torch.no_grad():
                return self(*[torch.from_numpy(np.ascontiguousarray(x))
                              for x in inputs])
        finally:
            self._recording = False

    def forward(self, *inputs):
        return self.walk(*inputs)

    def walk(self, *inputs):
        raise NotImplementedError


# -- NHWC convolutions and pools -------------------------------------------------

def same_pads(size: int, k: int, stride: int, dilation: int = 1
              ) -> Tuple[int, int]:
    """TensorFlow's SAME padding of one spatial axis (as
    ``lax.padtype_to_pads`` computes it): the extra row or column at the
    end."""
    out = -(-size // stride)
    need = max(0, (out - 1) * stride + (k - 1) * dilation + 1 - size)
    return need // 2, need - need // 2


def spatial_pads(x_hw: Sequence[int], k_hw: Sequence[int],
                 strides: Sequence[int], padding,
                 dilation: Sequence[int] = (1, 1)) -> List[Tuple[int, int]]:
    """(begin, end) per spatial axis for "SAME", "VALID" or explicit
    pairs."""
    if padding == "SAME":
        return [same_pads(n, k, s, d) for n, k, s, d in
                zip(x_hw, k_hw, strides, dilation)]
    if padding == "VALID":
        return [(0, 0)] * len(x_hw)
    return [(int(a), int(b)) for a, b in padding]


def _pad_nchw(x: torch.Tensor, pads: List[Tuple[int, int]],
              value: float = 0.0) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """Symmetric pads go to the op (returned); asymmetric ones are
    applied here with ``F.pad``."""
    if all(a == b for a, b in pads):
        return x, tuple(a for a, _ in pads)
    flat: List[int] = []
    for a, b in reversed(pads):
        flat += [a, b]
    return F.pad(x, flat, value=value), (0,) * len(pads)


def conv2d_nchw(x: torch.Tensor, w: torch.Tensor, bias, strides, padding,
                dilation=(1, 1), groups: int = 1) -> torch.Tensor:
    """``lax.conv_general_dilated`` over NCHW input and OIHW weight, with
    ``padding`` "SAME", "VALID" or explicit pairs; ``bias`` is added
    after the convolution, as the JAX importers add it."""
    pads = spatial_pads(x.shape[2:], w.shape[2:], strides, padding,
                        dilation)
    x, sym = _pad_nchw(x, pads)
    y = F.conv2d(x, w, None, tuple(strides), sym, tuple(dilation), groups)
    return y if bias is None else y + bias


def conv2d_nhwc(x: torch.Tensor, w: torch.Tensor, bias, strides, padding,
                dilation=(1, 1), groups: int = 1) -> torch.Tensor:
    """The same over NHWC input; ``w`` is OIHW (channels_last storage)."""
    y = conv2d_nchw(x.permute(0, 3, 1, 2), w, None, strides, padding,
                    dilation, groups).permute(0, 2, 3, 1)
    return y if bias is None else y + bias


def pool_nchw(module: GraphModule, key: Hashable, x: torch.Tensor, k, strides,
              padding, kind: str) -> torch.Tensor:
    """Max or average pool over the trailing spatial axes of an N, C,
    spatial... tensor. An average divides by the count of the window's
    elements inside the input (``reduce_window`` of ones, as the JAX
    importers do), recorded once as a constant."""
    nd = len(k)
    pads = spatial_pads(x.shape[2:], k, strides, padding)
    flat: List[int] = []
    for a, b in reversed(pads):
        flat += [a, b]
    if kind == "max":
        xp = F.pad(x, flat, value=-float("inf")) if any(flat) else x
        fn = (F.max_pool1d, F.max_pool2d, F.max_pool3d)[nd - 1]
        return fn(xp, tuple(k), tuple(strides))
    xp = F.pad(x, flat) if any(flat) else x
    if nd == 2:
        total = F.avg_pool2d(xp, tuple(k), tuple(strides), divisor_override=1)
    else:
        fn = (F.avg_pool1d, None, F.avg_pool3d)[nd - 1]
        total = fn(xp, tuple(k), tuple(strides)) * float(np.prod(k))

    def count():
        ones = torch.ones((1, 1, *x.shape[2:]), dtype=x.dtype)
        ones = F.pad(ones, flat) if any(flat) else ones
        if nd == 2:
            return F.avg_pool2d(ones, tuple(k), tuple(strides),
                                divisor_override=1)
        fn = (F.avg_pool1d, None, F.avg_pool3d)[nd - 1]
        return fn(ones, tuple(k), tuple(strides)) * float(np.prod(k))

    return total / module.const(("pool_count", key), count)


def pool_nhwc(module: GraphModule, key: Hashable, x: torch.Tensor, k,
              strides, padding, kind: str) -> torch.Tensor:
    return pool_nchw(module, key, x.permute(0, 3, 1, 2), k, strides,
                     padding, kind).permute(0, 2, 3, 1)


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``exp(x - max) / sum``, the JAX importers' formula."""
    e = torch.exp(x - x.amax(dim=dim, keepdim=True))
    return e / e.sum(dim=dim, keepdim=True)


def reduce_dims(x: torch.Tensor, axes) -> Tuple[int, ...]:
    return tuple(range(x.ndim)) if axes is None else tuple(
        int(a) for a in axes)


def pad_widths(x: torch.Tensor, widths: Sequence[Tuple[int, int]],
               mode: str = "constant", value: float = 0.0) -> torch.Tensor:
    """``jnp.pad`` with per-axis (before, after) widths; "reflect" and
    "edge" pad only trailing axes, as ``F.pad`` does."""
    flat: List[int] = []
    for a, b in reversed(list(widths)):
        flat += [int(a), int(b)]
    while len(flat) > 2 and flat[-1] == 0 and flat[-2] == 0:
        flat = flat[:-2]
    if mode == "constant":
        return F.pad(x, flat, value=value)
    torch_mode = {"reflect": "reflect", "edge": "replicate"}[mode]
    lead = x.ndim - len(flat) // 2
    if lead < 1:
        raise NotImplementedError(
            f"{mode} padding of every axis of a {x.ndim}-d tensor")
    shape = x.shape
    y = F.pad(x.reshape(1, -1, *shape[lead:]), flat, mode=torch_mode)
    return y.reshape(*shape[:lead], *y.shape[2:])
