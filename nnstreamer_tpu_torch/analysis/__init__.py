"""pipelint — static pipeline analysis (no element is ever started).

Port of ``nnstreamer_tpu/analysis/``: proves a parsed pipeline
well-typed before PLAYING by propagating caps/shape/dtype through every
element's declared transfer function (:meth:`Element.static_transfer`)
and running the graph lint rules whose elements the port has (dangling
pads, cycles, un-queued tee branches, signature blowup, error policies,
fusion breaks, ...). The same pass backs ``Pipeline.validate()``, the
default pre-PLAYING gate, and ``python -m nnstreamer_tpu_torch.analysis.cli``.
The fusion planner reads the inference pass too (fusion/planner.py).
"""
from .findings import (Finding, PipelineValidationError,  # noqa: F401
                       Report, Severity)
from .infer import (InferenceResult, config_of,  # noqa: F401
                    element_transfer, infer_caps)
from .rules import ALL_RULES, LintContext, Rule, analyze  # noqa: F401

__all__ = [
    "Severity", "Finding", "Report", "PipelineValidationError",
    "InferenceResult", "infer_caps", "element_transfer", "config_of",
    "Rule", "LintContext", "ALL_RULES", "analyze",
]
