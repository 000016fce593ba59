"""FilterFramework: the filter-backend subplugin ABI.

Port of ``nnstreamer_tpu/filters/base.py`` (≙ GstTensorFilterFramework v1,
ref: gst/nnstreamer/include/nnstreamer_plugin_api_filter.h:399-475 —
open/close/invoke/getModelInfo).

The non-blocking ``dispatch``/``complete`` split behind the element's
in-flight window is ported, with ``custom=`` option strings, the
reference's RELOAD_MODEL, SUSPEND and RESUME events
(:class:`FilterEvent`) and the async generative output path
(``set_async_dispatcher``/``invoke_async``: 1 input, N output frames,
which only the LLM backend implements).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..tensors.info import TensorsInfo


def parse_custom_properties(s: str) -> Dict[str, str]:
    """``k:v,k:v`` custom option string (the reference's custom-prop
    grammar, e.g. ``custom=rtt:30,svc:2``); a bare key maps to
    ``"true"``."""
    out: Dict[str, str] = {}
    for part in (s or "").split(","):
        part = part.strip()
        if ":" in part:
            k, v = part.split(":", 1)
            out[k.strip()] = v.strip()
        elif part:
            out[part] = "true"
    return out


class InvokeDrop(Exception):
    """Raised by a backend's ``invoke`` to signal "drop this frame, keep
    the pipeline" (≙ invoke result > 0, tensor_filter.c:961-963)."""


class FilterEvent(enum.Enum):
    """The events the port sends (ref: event_ops enum,
    nnstreamer_plugin_api_filter.h:205-217; the JAX package lists the
    rest, which no port element sends yet)."""

    RELOAD_MODEL = "reload_model"
    CHECK_HW_AVAILABILITY = "check_hw_availability"
    SUSPEND = "suspend"
    RESUME = "resume"


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
    custom_properties: str = ""
    # shared-tensor-filter-key: instances with one key share one backend
    shared_key: Optional[str] = None
    # the element's GraphPool (filters/executable.py), kept across the
    # element's restarts: a backend that captures CUDA graphs captures
    # into it, and makes its own when opened without one
    graph_pool: Any = None


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
    # True when the backend can split invoke into a non-blocking
    # dispatch() and a blocking complete() — what the element's K-frame
    # in-flight window (in-flight property) is built on. Backends whose
    # invoke is inherently synchronous leave this False; the element
    # then ignores the window and stays synchronous.
    SUPPORTS_DISPATCH = False
    # True when invoke() must be handed host arrays that numpy can read:
    # the element then fetches chunks that live on the card once before
    # the invoke (a user's numpy function cannot read a CUDA tensor; the
    # JAX package hands such functions jax.Arrays, which numpy reads)
    HOST_INPUTS = False

    def open(self, props: FilterProperties) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def invoke(self, inputs: Sequence[Any]) -> List[Any]:
        raise NotImplementedError

    # overlapped execution -------------------------------------------------
    def dispatch(self, inputs: Sequence[Any], donate: bool = False
                 ) -> Any:
        """Enqueue one frame's device program WITHOUT waiting for the
        results; returns an opaque in-flight handle for
        :meth:`complete`. ``donate`` permits reusing the staging memory
        of inputs the backend itself staged (never an upstream tensor);
        a backend with nothing to reuse says so once and ignores it. The
        default
        degrades to a synchronous invoke — the handle IS the outputs — so
        a window of K over a non-async backend is merely useless, never
        wrong."""
        return self.invoke(inputs)

    def complete(self, handle: Any) -> List[Any]:
        """Block until a dispatched frame's outputs are ready to hand
        downstream; raises if the device program failed. Called from the
        element's completer thread — implementations must be safe to run
        concurrently with :meth:`dispatch`."""
        return handle

    def traceable_fn(self):
        """A pure ``fn(*inputs) -> outputs`` closure over the loaded
        model for the fusion compiler to compose into a fused segment's
        program (fusion/segment.py), or None when the backend has no
        such function."""
        return None

    def get_model_info(self) -> Tuple[Optional[TensorsInfo], Optional[TensorsInfo]]:
        """(input_info, output_info); either may be None if the backend
        derives it from the negotiated caps (SET_INPUT_PROP path)."""
        return None, None

    def set_input_info(self, info: TensorsInfo) -> Optional[TensorsInfo]:
        """Negotiation push-path: given input info, return output info
        (≙ getModelInfo SET_INPUT_INFO, nnstreamer_plugin_api_filter.h:439)."""
        return None

    def handle_event(self, event: FilterEvent,
                     data: Optional[dict] = None) -> bool:
        """Return True if handled. RELOAD_MODEL (``data`` may carry new
        ``model_files``), SUSPEND and RESUME arrive here; SUSPEND comes
        from the element's watchdog thread, so a backend that answers it
        serialises it against its own invokes."""
        return False

    # async generative path -----------------------------------------------
    def set_async_dispatcher(self, dispatch: Callable[..., None]) -> None:
        """The element installs a callback; an async backend calls it once
        per produced output frame (≙ nnstreamer_filter_dispatch_output_
        async) as ``dispatch(outputs, ctx)``, handing back the ``ctx`` it
        was given at :meth:`invoke_async` so the element stamps each
        frame from its own input: with several invokes in flight, a
        missing ctx would mis-stamp frames."""
        self._dispatch = dispatch

    def invoke_async(self, inputs: Sequence[Any], ctx: Any = None) -> None:
        """1-in/N-out invoke: the outputs flow through the dispatcher,
        each carrying ``ctx``. Backends without an async path raise."""
        raise NotImplementedError(
            f"framework {self.NAME!r} has no async output path")

    @classmethod
    def supports_async(cls) -> bool:
        """True when the backend implements :meth:`invoke_async`."""
        return cls.invoke_async is not FilterFramework.invoke_async
