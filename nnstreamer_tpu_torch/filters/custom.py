"""In-process custom filters: ``custom-easy`` and ``python3``.

Port of ``nnstreamer_tpu/filters/custom.py``. ``custom-easy``: register
a python callable + I/O info at runtime and use it as
``framework=custom-easy model=<name>`` (≙ NNS_custom_easy_register, ref:
gst/nnstreamer/tensor_filter/tensor_filter_custom_easy.c).
``python3``: a user script defining ``invoke(inputs) -> list``
(≙ tensor_filter_python3.cc).

Both run the user's code on the host, so both declare ``HOST_INPUTS``:
the element hands them numpy arrays (a bfloat16 tensor, which numpy
cannot hold, as a CPU ``torch.Tensor``), fetching a chunk that lives on
the card once. A function written for the JAX package, which hands it
``jax.Array``s that numpy reads, runs unchanged.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..tensors.info import TensorsInfo
from .base import FilterFramework, FilterProperties
from .registry import register_filter

_CUSTOM_EASY: Dict[str, Tuple[Callable, Optional[TensorsInfo],
                              Optional[TensorsInfo]]] = {}
_LOCK = threading.Lock()


def register_custom_easy(name: str, fn: Callable[..., Any],
                         in_info: Optional[TensorsInfo] = None,
                         out_info: Optional[TensorsInfo] = None) -> None:
    """fn(*input_arrays) -> array | list of arrays."""
    with _LOCK:
        _CUSTOM_EASY[name] = (fn, in_info, out_info)


def unregister_custom_easy(name: str) -> bool:
    with _LOCK:
        return _CUSTOM_EASY.pop(name, None) is not None


def _as_list(out: Any) -> List[Any]:
    return list(out) if isinstance(out, (list, tuple)) else [out]


@register_filter
class CustomEasyFilter(FilterFramework):
    NAME = "custom-easy"
    HOST_INPUTS = True

    def __init__(self):
        self._fn: Optional[Callable] = None
        self._in_info: Optional[TensorsInfo] = None
        self._out_info: Optional[TensorsInfo] = None

    def open(self, props: FilterProperties) -> None:
        name = props.model_files[0] if props.model_files else ""
        with _LOCK:
            if name not in _CUSTOM_EASY:
                raise ValueError(f"custom-easy model {name!r} not registered; "
                                 f"known: {sorted(_CUSTOM_EASY)}")
            self._fn, self._in_info, self._out_info = _CUSTOM_EASY[name]

    def invoke(self, inputs: Sequence[Any]) -> List[Any]:
        return _as_list(self._fn(*inputs))

    def get_model_info(self):
        return self._in_info, self._out_info


@register_filter
class Python3Filter(FilterFramework):
    """framework=python3 model=<script.py>: the user script defines
    ``invoke(inputs) -> list`` and optionally ``get_input_info`` /
    ``get_output_info`` / ``set_input_info``; it sees the filter's
    ``custom`` string as ``custom_properties``."""

    NAME = "python3"
    EXTENSIONS = (".py",)
    HOST_INPUTS = True

    def __init__(self):
        self._ns: Dict[str, Any] = {}

    def open(self, props: FilterProperties) -> None:
        path = props.model_files[0]
        with open(path) as f:
            code = f.read()
        ns: Dict[str, Any] = {"__file__": path,
                              "custom_properties": props.custom_properties}
        exec(compile(code, path, "exec"), ns)  # noqa: S102 - user script by design
        if "invoke" not in ns:
            raise ValueError(f"{path}: python3 filter must define invoke()")
        self._ns = ns

    def invoke(self, inputs: Sequence[Any]) -> List[Any]:
        return _as_list(self._ns["invoke"](list(inputs)))

    def get_model_info(self):
        gi = self._ns.get("get_input_info")
        go = self._ns.get("get_output_info")
        return (gi() if gi else None), (go() if go else None)

    def set_input_info(self, info: TensorsInfo) -> Optional[TensorsInfo]:
        si = self._ns.get("set_input_info")
        return si(info) if si else None
