"""Framework logging.

Port of the logger of ``nnstreamer_tpu/utils/log.py``
(≙ ml_loge/logw/logi/logd, gst/nnstreamer/nnstreamer_log.c:35-64). The
level comes from the same ``NNS_TPU_LOG`` variable (default WARNING).
Not ported yet: the per-category ``NNS_TPU_DEBUG`` levels.
"""
from __future__ import annotations

import logging
import os

logger = logging.getLogger("nnstreamer_tpu_torch")

_level = os.environ.get("NNS_TPU_LOG", "WARNING").upper()
if not logger.handlers:
    handler = logging.StreamHandler()
    handler.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname).1s %(name)s %(message)s"))
    logger.addHandler(handler)
    logger.setLevel(getattr(logging, _level, logging.WARNING))
