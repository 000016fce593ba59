"""Coalescing device->host fetch service — compat façade.

Port of ``nnstreamer_tpu/tensors/fetch.py``. The one-way D2H fetcher
grew into the bidirectional transfer service in :mod:`.transfer`; this
module keeps the historical import surface — ``submit_fetch`` /
``resolve`` / ``PendingHost`` / ``fetch_stats`` — for callers of that
name; new code imports from ``tensors.transfer``.
"""
from __future__ import annotations

from .transfer import (  # noqa: F401 — re-exported compat surface
    _MAX_ARRAYS_PER_RPC,
    PendingHost,
    _Coalescer,
    _Downloader,
    _Ticket,
    _downloader,
    fetch_stats,
    resolve,
    submit_fetch,
)

# historical name for the download-side singleton (tests drive it
# directly to pin per-ticket error isolation)
_coalescer = _downloader
