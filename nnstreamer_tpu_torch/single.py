"""Pipeline-less single invoke (the ML "single-shot" API).

Port of ``nnstreamer_tpu/single.py`` (≙ gst/nnstreamer/tensor_filter/
tensor_filter_single.c, behind the C ML Single-shot API): open a model
once through the same backend classes as ``tensor_filter`` and invoke
it synchronously. It runs on the card unless ``accelerator`` asks for
the CPU (``true:cpu`` or ``false``), as the element does; outputs of a
card backend stay CUDA tensors. Without CUDA and without that request,
``start`` raises. ``invoke_async`` hands the backend's output frames to
the callback of ``set_async_callback`` (only the LLM backend has the
async path; the others raise ``NotImplementedError``).
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

from .filters.base import Accelerator, FilterProperties
from .filters.registry import detect_framework, find_filter
from .tensors.info import TensorsInfo


class SingleShot:
    """Open a model once, invoke synchronously (or async-callback)
    without building a pipeline."""

    def __init__(self, model: str, framework: str = "auto",
                 input_info: Optional[TensorsInfo] = None,
                 output_info: Optional[TensorsInfo] = None,
                 accelerator: str = "", custom: str = ""):
        models = tuple(model.split(","))
        if framework in ("auto", ""):
            framework = detect_framework(models)
        self.props = FilterProperties(
            framework=framework, model_files=models,
            input_info=input_info, output_info=output_info,
            # empty = the card, as tensor_filter's empty property
            accelerators=(tuple(Accelerator.parse(accelerator))
                          if accelerator else (Accelerator.DEFAULT,)),
            custom_properties=custom)
        self.fw = find_filter(framework)()
        self._opened = False

    def start(self) -> "SingleShot":
        if not self._opened:
            self.fw.open(self.props)
            self._opened = True
        return self

    def stop(self) -> None:
        if self._opened:
            self.fw.close()
            self._opened = False

    def __enter__(self) -> "SingleShot":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def invoke(self, inputs: Sequence[Any]) -> List[Any]:
        if not self._opened:
            self.start()
        return self.fw.invoke(list(inputs))

    def set_async_callback(self, cb: Callable[[List[Any]], None]) -> None:
        # user callbacks take just the outputs; the per-invoke ctx drops
        self.fw.set_async_dispatcher(lambda outputs, ctx=None: cb(outputs))

    def invoke_async(self, inputs: Sequence[Any], ctx: Any = None) -> None:
        if not self._opened:
            self.start()
        self.fw.invoke_async(list(inputs), ctx=ctx)

    def get_model_info(self):
        if not self._opened:
            self.start()
        return self.fw.get_model_info()
