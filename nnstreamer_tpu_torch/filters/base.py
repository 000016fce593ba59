"""FilterFramework: the filter-backend subplugin ABI.

Port of ``nnstreamer_tpu/filters/base.py`` (≙ GstTensorFilterFramework v1,
ref: gst/nnstreamer/include/nnstreamer_plugin_api_filter.h:399-475 —
open/close/invoke/getModelInfo).

Not ported yet: the event vocabulary (reload, suspend/resume), the
non-blocking ``dispatch``/``complete`` split behind the element's
in-flight window, the async generative output path, and custom
(``custom=``) properties.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, List, Optional, Sequence, Tuple

from ..tensors.info import TensorsInfo


class InvokeDrop(Exception):
    """Raised by a backend's ``invoke`` to signal "drop this frame, keep
    the pipeline" (≙ invoke result > 0, tensor_filter.c:961-963)."""


class Accelerator(enum.Enum):
    """(ref: accl_hw enum, nnstreamer_plugin_api_filter.h:80-102).
    In the port DEFAULT means the first CUDA device."""

    NONE = "none"
    DEFAULT = "default"
    CPU = "cpu"
    TPU = "tpu"
    GPU = "gpu"

    @classmethod
    def parse(cls, s: str) -> List["Accelerator"]:
        """Parse reference-style accelerator strings: "true:gpu.cpu"
        (ref: parse_accl_hw, nnstreamer_plugin_api_filter.h:529-550)."""
        s = (s or "").strip()
        if not s or s.lower() in ("false", "none"):
            return [cls.NONE]
        if ":" in s:
            _, rest = s.split(":", 1)
        elif s.lower() in ("true", "auto"):
            rest = "default"
        else:
            rest = s
        out = []
        for part in rest.replace(",", ".").split("."):
            part = part.strip().lower()
            if not part:
                continue
            try:
                out.append(cls(part))
            except ValueError:
                out.append(cls.DEFAULT)
        return out or [cls.DEFAULT]


@dataclasses.dataclass
class FilterProperties:
    """Per-instance filter configuration handed to the framework
    (ref: GstTensorFilterProperties, nnstreamer_plugin_api_filter.h:112-144)."""

    framework: str = ""
    model_files: Tuple[str, ...] = ()
    input_info: Optional[TensorsInfo] = None
    output_info: Optional[TensorsInfo] = None
    accelerators: Tuple[Accelerator, ...] = (Accelerator.DEFAULT,)


class FilterFramework:
    """Backend subplugin base class (≙ GstTensorFilterFramework v1).

    Lifecycle: ``open`` loads the model, ``invoke`` runs it, ``close``
    releases. ``invoke`` takes and returns a list of arrays (host
    ndarrays or tensors; CUDA backends keep outputs on the card).
    """

    NAME = ""
    # framework auto-detect: model-file extensions this backend claims
    # (ref: gst_tensor_filter_detect_framework, tensor_filter_common.c:1174)
    EXTENSIONS: Tuple[str, ...] = ()
    AVAILABLE = True
    # True when invoke() accepts inputs with one extra leading batch dim
    # (the element then negotiates aggregator-stacked streams)
    SUPPORTS_BATCH = False

    def open(self, props: FilterProperties) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def invoke(self, inputs: Sequence[Any]) -> List[Any]:
        raise NotImplementedError

    def get_model_info(self) -> Tuple[Optional[TensorsInfo], Optional[TensorsInfo]]:
        """(input_info, output_info); either may be None if the backend
        derives it from the negotiated caps (SET_INPUT_PROP path)."""
        return None, None

    def set_input_info(self, info: TensorsInfo) -> Optional[TensorsInfo]:
        """Negotiation push-path: given input info, return output info
        (≙ getModelInfo SET_INPUT_INFO, nnstreamer_plugin_api_filter.h:439)."""
        return None
