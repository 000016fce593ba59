"""Static analysis of an unstarted pipeline: the caps inference the
fusion planner reads. Pipelint's rules (``nnstreamer_tpu/analysis/
rules.py``) are not ported; the port starts pipelines unvalidated."""
from .findings import Finding, Report, Severity
from .infer import InferenceResult, config_of, element_transfer, infer_caps

__all__ = ["Finding", "Report", "Severity", "InferenceResult",
           "config_of", "element_transfer", "infer_caps"]
