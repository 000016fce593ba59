"""tensor_serve — the dynamic-batching serving stack.

Port of ``nnstreamer_tpu/serve/``. Sits between N concurrent client
streams and one ``tensor_filter``: per-stream admission control feeds a
bucketed batcher whose padded batches keep the filter's executables
bounded (at most one captured CUDA graph per bucket on the card), and a
demux routes each batch row's result back to the stream that asked, by
correlation id.

The per-request among-device path (tensor_query_*) sends one frame per
connection straight into the filter; this package turns that into a
serving stack: ``tensor_serve_src ! tensor_filter ! tensor_serve_sink``
speaks the same wire protocol as ``tensor_query_client``, plus SHED
replies (retry-after backpressure) when admission or deadlines drop a
request, and ``tensor_serve_router`` fronts N such replicas.

The three elements register with the rest of the port's elements
(elements/__init__.py), as the JAX package registers them.
"""
from .batcher import BucketBatcher, Request, stack_requests
from .router import FleetRouter, HashRing, parse_replicas
from .scheduler import SERVE_TABLE, ServeScheduler

__all__ = ["BucketBatcher", "Request", "ServeScheduler", "SERVE_TABLE",
           "stack_requests", "FleetRouter", "HashRing", "parse_replicas"]
