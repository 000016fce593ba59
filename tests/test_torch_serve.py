"""The port's serving stack (nnstreamer_tpu_torch/serve/, Pipeline.drain
and the drain hooks) against the JAX package's, on the CPU.

Mirrors tests/test_serve.py's ``TestBucketBatcher``,
``TestServeScheduler``, ``TestServeElements``, ``TestDrainSettlement``,
``TestRoiSettlement``, ``TestWatchdog`` and ``TestPercentiles`` on the
port's classes, and adds what only a two-package run can show:

* ``stack_requests`` and the batch sequence of one submit order are the
  reference's, bitwise, from one numpy seed;
* every settlement report passes the reference's flowcheck identities
  (``nnstreamer_tpu.analysis.flow.check_identities``, the oracle the
  JAX tests use; the port does not import it);
* a port ``tensor_query_client`` against a JAX ``tensor_serve_src`` and
  a JAX client against the port's, with SHED (``retry_after_ms``) and
  DRAIN on the wire;
* serving parity: the same frames through the port's serve line
  (``framework=torch-cuda accelerator=true:cpu``) and the JAX package's
  (``framework=jax``) over one set of MobileNet-v2 variables (width
  0.35, 96x96, BatchNorm statistics from a numpy seed, carried to both
  through model files as tests/test_torch_query.py does), at
  tests/test_torch_mobilenet.py's bf16 bound, ``BF16_ATOL`` = 2e-2 with
  equal top-1; and against the port's own local line at ``BATCH_ATOL`` =
  1e-5 (a bucket runs other convolution blockings than one frame: f32
  summation order only, tests/test_torch_mobilenet.py's batched bound);
* the ViT serve path (``attn=pallas``, d_model 64, 2 layers, 4 heads) on
  the CPU through ``attention_plain`` against the JAX line whose
  ``fused_attention`` runs the Pallas kernel in interpret mode, at
  tests/test_torch_vit.py's bf16 bound (3e-2 with equal argmax);
* the settlement of the filter's failure paths (an invoke error on the
  synchronous path, a breaker-open shed) and of ``Pipeline.drain`` with
  a ``suspend`` filter;
* ``mesh=`` with too few devices: the reference's degrade (buckets
  snapped, batches left on the host, logged once), and pipelint's
  ``unbounded-admission`` with the serve halves of ``jit-signatures``,
  ``shed-no-retry-after`` and ``async-window``, on the JAX rule tests'
  own lines (findings compared with the JAX package's).

Nothing here needs the card; tests/test_torch_cuda.py holds the card's
side (one graph a bucket, one copy a batch, padded rows).
"""
import functools
import socket
import threading
import time

import jax
import numpy as np
import pytest
import torch

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as pt
from nnstreamer_tpu.analysis import analyze as nt_analyze
from nnstreamer_tpu.analysis.flow import check_identities
from nnstreamer_tpu.filters import register_custom_easy as nt_register
from nnstreamer_tpu.models import zoo as jax_zoo
from nnstreamer_tpu.serve import batcher as nt_batcher
from nnstreamer_tpu.serve import elements as nt_serve_elements
from nnstreamer_tpu_torch.analysis import Severity, analyze
from nnstreamer_tpu_torch.filters import register_custom_easy
from nnstreamer_tpu_torch.serve import (BucketBatcher, Request,
                                        ServeScheduler, stack_requests)
from nnstreamer_tpu_torch.serve import batcher as pt_batcher
from nnstreamer_tpu_torch.serve import elements as serve_elements
from nnstreamer_tpu_torch.utils.trace import Reservoir, Tracer
from nnstreamer_tpu_torch.utils.watchdog import Watchdog

CAPS4 = ('other/tensors,format=static,num_tensors=1,'
         'types=(string)float32,dimensions=(string)4')
CAPS96 = ("other/tensors,format=static,num_tensors=1,types=(string)uint8,"
          "dimensions=(string)3:96:96,framerate=(fraction)0/1")
CAPS64 = ("other/tensors,format=static,num_tensors=1,types=(string)uint8,"
          "dimensions=(string)3:64:64,framerate=(fraction)0/1")
BF16_ATOL = 2e-2
BATCH_ATOL = 1e-5
VIT_ATOL = 3e-2


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two torch threads: tier-1 runs six test workers on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _serve_models():
    for register in (register_custom_easy, nt_register):
        register("serve_double", lambda x: x * 2)
        register("serve_slow", lambda x: (time.sleep(0.05), x)[1])
    yield


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _req(stream, value, dim=4, **kw):
    return Request(stream, [np.full(dim, float(value), np.float32)], **kw)


def _server(pkg, ident, mid, extra="", filt=None):
    """``tensor_serve_src name=src ... ! <filter> ! tensor_serve_sink``
    of ``pkg``, started; returns (pipeline, port)."""
    port = _free_port()
    filt = filt or f"tensor_filter name=f framework=custom-easy model={mid}"
    server = pkg.parse_launch(
        f"tensor_serve_src name=src port={port} id={ident} {extra} "
        f"! {filt} ! tensor_serve_sink id={ident}")
    server.start()
    return server, port


def _client(pkg, port, caps=CAPS4, max_request=8, name="qc"):
    c = pkg.parse_launch(
        f'appsrc name=in caps="{caps}" ! tensor_query_client name={name} '
        f"port={port} timeout=15 max-request={max_request} "
        "! appsink name=out")
    c.start()
    return c


def _push(pkg, client, values):
    for v in values:
        client["in"].push_buffer(pkg.Buffer.from_arrays(
            [np.full(4, float(v), np.float32)]))


def _settled(client):
    return len(client["out"].buffers) + client["qc"].stats["shed"]


def _wait(pred, timeout=30):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.02)
    return pred()


def _push_and_wait(pkg, client, values, want, timeout=30):
    _push(pkg, client, values)
    _wait(lambda: len(client["out"].buffers) >= want, timeout)
    return [float(b.chunks[0].host()[0]) for b in client["out"].buffers]


def _close(client):
    client["in"].end_stream()
    client.stop()


# ---------------------------------------------------------------- batcher

class TestBucketBatcher:
    def test_bucket_for(self):
        b = BucketBatcher(buckets=(1, 2, 4, 8), max_wait_s=0.0)
        assert [b.bucket_for(n) for n in (1, 2, 3, 4, 5, 8, 9)] == \
            [1, 2, 4, 4, 8, 8, 8]

    def test_full_bucket_flushes_without_waiting(self):
        b = BucketBatcher(buckets=(1, 2, 4), max_wait_s=10.0, max_queue=8)
        for i in range(4):
            assert b.submit(_req(0, i))
        t0 = time.monotonic()
        batch = b.next_batch()
        assert time.monotonic() - t0 < 1.0  # did NOT sit out max_wait
        assert [r.arrays[0][0] for r in batch] == [0.0, 1.0, 2.0, 3.0]
        assert b.depth() == 0

    def test_lone_request_flushes_at_max_wait(self):
        b = BucketBatcher(buckets=(1, 2, 4), max_wait_s=0.05)
        b.submit(_req(0, 7))
        t0 = time.monotonic()
        batch = b.next_batch()
        assert len(batch) == 1 and batch[0].arrays[0][0] == 7.0
        assert time.monotonic() - t0 < 2.0  # flushed on deadline
        assert b.bucket_for(len(batch)) == 1

    def test_admission_shed_at_max_queue(self):
        b = BucketBatcher(buckets=(4,), max_wait_s=10.0, max_queue=2)
        assert b.submit(_req(0, 0))
        assert b.submit(_req(0, 1))
        assert not b.submit(_req(0, 2))  # stream 0's budget exhausted
        assert b.submit(_req(1, 3))      # per-stream: stream 1 unaffected
        assert b.stats["shed_admission"] == 1

    def test_deadline_shed(self):
        b = BucketBatcher(buckets=(2,), max_wait_s=0.2)
        shed = []
        dead = _req(0, 0, deadline=time.monotonic() - 0.01,
                    on_shed=shed.append)
        b.submit(dead)
        b.submit(_req(1, 1))
        batch = b.next_batch()
        assert [r.arrays[0][0] for r in batch] == [1.0]
        assert shed == [dead]
        assert b.stats["shed_deadline"] == 1

    def test_cancel_stream_reclaims_slots(self):
        b = BucketBatcher(buckets=(8,), max_wait_s=10.0, max_queue=4)
        for i in range(3):
            b.submit(_req(0, i))
        b.submit(_req(1, 9))
        assert b.cancel_stream(0) == 3
        assert b.depth() == 1 and b.depth(0) == 0
        assert b.stats["cancelled"] == 3
        assert b.submit(_req(0, 10))  # the freed budget is usable again

    def test_signature_mismatch_opens_next_batch(self):
        b = BucketBatcher(buckets=(1, 2, 4), max_wait_s=0.0)
        b.submit(_req(0, 0, dim=4))
        b.submit(_req(1, 1, dim=4))
        b.submit(_req(2, 2, dim=8))  # different shape: not stackable
        first, second = b.next_batch(), b.next_batch()
        assert [r.arrays[0].shape for r in first] == [(4,), (4,)]
        assert [r.arrays[0].shape for r in second] == [(8,)]

    def test_stack_requests_pads_to_bucket(self):
        stacked = stack_requests([_req(0, 1), _req(1, 2)], 4)
        assert stacked[0].shape == (4, 4)
        # padding repeats the last real row
        np.testing.assert_array_equal(stacked[0][2], stacked[0][1])
        np.testing.assert_array_equal(stacked[0][3], stacked[0][1])

    @pytest.mark.parametrize("dtype", [np.uint8, np.float32, np.int64])
    @pytest.mark.parametrize("nreal,bucket", [(1, 1), (3, 4), (5, 8)])
    def test_stack_requests_is_the_reference_bitwise(self, dtype, nreal,
                                                     bucket):
        """Two tensors a request, drawn from one seed: the port's stack
        is the JAX package's byte for byte, padded rows included."""
        rng = np.random.default_rng(7)
        arrays = [[rng.integers(0, 200, (3, 5)).astype(dtype),
                   rng.standard_normal(6).astype(np.float32)]
                  for _ in range(nreal)]
        got = stack_requests([Request(i, a) for i, a in enumerate(arrays)],
                             bucket)
        want = nt_batcher.stack_requests(
            [nt_batcher.Request(i, a) for i, a in enumerate(arrays)],
            bucket)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert g.tobytes() == w.tobytes()

    def test_batch_sequence_is_the_reference(self):
        """One seeded submit order (three streams, two shapes, a budget
        of 3 a stream) gives the same admissions and the same batches,
        request for request, in both packages."""
        rng = np.random.default_rng(3)
        plan = [(int(rng.integers(0, 3)), int(rng.choice([4, 8])))
                for _ in range(40)]

        def run(batcher_mod):
            b = batcher_mod.BucketBatcher(buckets=(1, 2, 4), max_wait_s=0.0,
                                          max_queue=3)
            admitted, batches = [], []
            for i, (stream, dim) in enumerate(plan):
                admitted.append(b.submit(batcher_mod.Request(
                    stream, [np.full(dim, float(i), np.float32)], seq=i)))
                if i % 5 == 4:
                    while b.depth():
                        batches.append([r.seq for r in b.next_batch()])
            return admitted, batches, b.stats.snapshot()

        assert run(pt_batcher) == run(nt_batcher)

    def test_bf16_requests_stack_as_cpu_tensors(self):
        """bfloat16 arrives from the wire as a CPU tensor (numpy has no
        bf16): it stacks and demuxes as one, bitwise."""
        rows = [torch.randn(3, generator=torch.Generator().manual_seed(i))
                .to(torch.bfloat16) for i in range(3)]
        reqs = [Request(i, [r]) for i, r in enumerate(rows)]
        assert reqs[0].signature() == reqs[1].signature()
        stacked = stack_requests(reqs, 4)[0]
        assert stacked.dtype == torch.bfloat16 and stacked.shape == (4, 3)
        assert torch.equal(stacked[3], rows[2])


# -------------------------------------------------------------- scheduler

class TestServeScheduler:
    def test_demux_interleaved_streams(self):
        """Three streams submit interleaved; every stream gets exactly
        its own frames back, doubled, in order."""
        sched = ServeScheduler(buckets=(1, 2, 4), max_wait_s=0.002,
                               invoke_fn=lambda xs: [x * 2 for x in xs])
        got = {s: [] for s in range(3)}
        done = threading.Event()
        lock = threading.Lock()

        def on_result(req, row):
            with lock:
                got[req.stream_id].append(float(row[0][0]))
                if sum(len(v) for v in got.values()) == 30:
                    done.set()

        sched.start()
        try:
            for i in range(10):
                for s in range(3):
                    assert sched.submit(s, [np.full(4, 100 * s + i,
                                                    np.float32)],
                                        seq=i, on_result=on_result)
            assert done.wait(timeout=20)
        finally:
            sched.stop()
        for s in range(3):
            assert got[s] == [2.0 * (100 * s + i) for i in range(10)]
        rep = sched.report()
        assert rep["completed"] == 30
        assert rep["shed_admission"] == 0 and rep["shed_deadline"] == 0
        assert 0.0 < rep["occupancy_avg"] <= 1.0
        assert rep["queue_delay_us"]["p50"] >= 0.0
        assert rep["batch_latency_us"]["p99"] >= rep["batch_latency_us"]["p50"]
        check_identities({**rep, "pending": sched.pending()},
                         names=["serve-settlement"])

    def test_admission_shed_invokes_on_shed(self):
        sched = ServeScheduler(buckets=(4,), max_wait_s=10.0, max_queue=1)
        shed = []
        assert sched.submit(0, [np.zeros(4, np.float32)])
        assert not sched.submit(0, [np.zeros(4, np.float32)],
                                on_shed=shed.append)
        assert len(shed) == 1

    def test_invoke_failure_sheds_batch_keeps_serving(self):
        calls = {"n": 0}

        def flaky(xs):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("transient")
            return xs

        sched = ServeScheduler(buckets=(1,), max_wait_s=0.001,
                               invoke_fn=flaky)
        shed, ok = threading.Event(), threading.Event()
        sched.start()
        try:
            sched.submit(0, [np.zeros(4, np.float32)],
                         on_shed=lambda r: shed.set())
            assert shed.wait(timeout=10)
            sched.submit(0, [np.zeros(4, np.float32)],
                         on_result=lambda r, row: ok.set())
            assert ok.wait(timeout=10)  # the worker survived the failure
        finally:
            sched.stop()
        rep = sched.report()
        assert rep["invoke_errors"] == 1 and rep["shed_failed"] == 1
        check_identities({**rep, "pending": 0}, names=["serve-settlement"])

    def test_result_error_does_not_starve_batch(self):
        sched = ServeScheduler(buckets=(2,), max_wait_s=10.0)
        reqs = [Request(0, [np.zeros(4, np.float32)],
                        on_result=lambda r, row: 1 / 0),
                Request(1, [np.ones(4, np.float32)],
                        on_result=lambda r, row: None)]
        for r in reqs:
            sched.batcher.submit(r)
        batch, bucket, stacked = sched.next_batch()
        sched.complete(batch, stacked)
        rep = sched.report()
        assert rep["result_errors"] == 1
        assert rep["completed"] == 2

    def test_complete_demuxes_tensor_outputs_without_padded_rows(self):
        """Outputs handed back as CPU tensors (the torch-cuda backend's
        host outputs) demux to host rows like the reference's arrays; a
        padded row is never answered, and a bf16 output stays a bf16
        tensor row."""
        sched = ServeScheduler(buckets=(4,), max_wait_s=10.0)
        rows = []
        for i in range(3):
            sched.batcher.submit(Request(
                i, [np.full(2, float(i), np.float32)],
                on_result=lambda r, row: rows.append((r.stream_id, row))))
        batch, bucket, stacked = sched.next_batch()
        assert bucket == 4 and len(batch) == 3
        x = torch.from_numpy(stacked[0])
        sched.complete(batch, [x * 3, (x + 1).to(torch.bfloat16)])
        assert [s for s, _ in rows] == [0, 1, 2]
        for s, (a, b) in rows:
            assert isinstance(a, np.ndarray) and a.tolist() == [3.0 * s] * 2
            assert b.dtype == torch.bfloat16 and b.tolist() == [s + 1.0] * 2
        assert sched.report()["completed"] == 3


# ------------------------------------------------- elements (end-to-end)

class TestServeElements:
    def test_round_trip_two_clients(self):
        """serve_src ! filter ! serve_sink serves two concurrent query
        clients; each gets exactly its own frames back, doubled."""
        server, port = _server(pt, 40, "serve_double",
                               "buckets=1,2,4 max-wait-ms=2")
        results = {}

        def run_client(tag, base):
            c = _client(pt, port)
            results[tag] = _push_and_wait(pt, c, [base + i for i in range(6)],
                                          6)
            _close(c)

        threads = [threading.Thread(target=run_client, args=(t, 100 * t))
                   for t in (1, 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=40)
        rep = server["src"].scheduler.report()
        server.stop()
        for tag in (1, 2):
            assert results[tag] == [2.0 * (100 * tag + i) for i in range(6)]
        assert rep["completed"] == 12
        assert rep["batches"] >= 1
        assert rep["queue_delay_us"]["p95"] >= rep["queue_delay_us"]["p50"]

    def test_shed_emits_qos_and_accounts_every_frame(self):
        """A client outrunning the filter is shed with retry-after; the
        client books the shed, raises an upstream QosEvent, and every
        sent frame is accounted exactly once (result xor shed)."""
        from nnstreamer_tpu_torch.pipeline.events import QosEvent
        server, port = _server(pt, 41, "serve_slow",
                               "buckets=1 max-wait-ms=1 max-queue=2 "
                               "retry-after-ms=25")
        client = pt.parse_launch(
            f'appsrc name=in caps="{CAPS4}" ! tensor_query_client name=qc '
            f"port={port} timeout=15 max-request=64 ! appsink name=out")
        qos = []
        orig = client["in"].handle_upstream_event
        client["in"].handle_upstream_event = \
            lambda pad, ev: (qos.append(ev), orig(pad, ev))
        client.start()
        sent = 24
        _push(pt, client, range(sent))

        def done():
            with client["qc"]._plock:
                pending = len(client["qc"]._pending)
            return _settled(client) >= sent and not pending

        _wait(done)
        n_result, n_shed = len(client["out"].buffers), client["qc"].stats["shed"]
        rep = server["src"].scheduler.report()
        _close(client)
        server.stop()
        assert n_shed > 0, "max-queue=2 against a 50ms filter must shed"
        assert n_result + n_shed == sent
        assert rep["shed_admission"] == n_shed
        shed_events = [e for e in qos if isinstance(e, QosEvent)]
        assert shed_events and shed_events[0].period_ns == 25_000_000
        check_identities({**rep, "pending": 0}, names=["serve-settlement"])

    def test_client_disconnect_reclaims_and_recovers(self):
        """A client dying with requests queued must not wedge the
        batcher: its slots are reclaimed and later clients are served."""
        from nnstreamer_tpu_torch.edge.protocol import (MsgKind,
                                                        buffer_to_wire,
                                                        recv_msg, send_msg)
        server, port = _server(pt, 42, "serve_slow",
                               "buckets=1 max-wait-ms=1 max-queue=16")
        raw = socket.create_connection(("localhost", port), timeout=5)
        send_msg(raw, MsgKind.CAPS, {"caps": CAPS4})
        recv_msg(raw)
        meta, payloads = buffer_to_wire(
            pt.Buffer.from_arrays([np.zeros(4, np.float32)]))
        for _ in range(6):
            send_msg(raw, MsgKind.DATA, meta, payloads)
        raw.close()
        client = _client(pt, port)
        out = _push_and_wait(pt, client, [5.0], 1)
        rep = server["src"].scheduler.report()
        _close(client)
        server.stop()
        assert out == [5.0]
        assert rep["completed"] + rep["cancelled"] >= 6
        assert server["src"].scheduler.batcher.depth() == 0

    def test_mid_stream_death_batch_settles_for_survivors(self):
        """A client killed between submit and settle must not abort the
        batch: the survivor's frames all settle."""
        from nnstreamer_tpu_torch.edge.protocol import (MsgKind,
                                                        buffer_to_wire,
                                                        recv_msg, send_msg)
        server, port = _server(pt, 44, "serve_slow",
                               "buckets=1,2 max-wait-ms=20 max-queue=16")
        raw = socket.create_connection(("localhost", port), timeout=5)
        send_msg(raw, MsgKind.CAPS, {"caps": CAPS4})
        recv_msg(raw)
        meta, payloads = buffer_to_wire(
            pt.Buffer.from_arrays([np.full(4, 9.0, np.float32)]))
        client = _client(pt, port, max_request=16)
        for i in range(8):
            send_msg(raw, MsgKind.DATA, meta, payloads)
            client["in"].push_buffer(pt.Buffer.from_arrays(
                [np.full(4, float(i), np.float32)]))
        raw.close()
        out = _push_and_wait(pt, client, [], 8)
        rep = server["src"].scheduler.report()
        depth = server["src"].scheduler.batcher.depth()
        _close(client)
        server.stop()
        assert sorted(out) == [float(i) for i in range(8)]
        assert rep["completed"] + rep["cancelled"] + rep["shed_admission"] \
            >= 16
        assert depth == 0

    def test_signatures_bounded_by_buckets(self):
        """Across ragged concurrency the torch-cuda backend holds at most
        len(buckets) executables (on the card, captured graphs): every
        batch is padded up to a bucket."""
        server, port = _server(
            pt, 43, None, "buckets=1,2,4 max-wait-ms=4",
            filt="tensor_filter name=f framework=torch-cuda "
                 'accelerator=true:cpu model="zoo://mlp?in_dim=4&hidden=8'
                 '&out_dim=4"')
        got = []

        def run_client():
            c = _client(pt, port)
            got.append(len(_push_and_wait(pt, c, range(8), 8, timeout=60)))
            _close(c)

        threads = [threading.Thread(target=run_client) for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=90)
        fw = server["f"].fw
        n_sigs, compiles = len(fw._executables), fw.compile_count
        rep = server["src"].scheduler.report()
        server.stop()
        assert got == [8, 8, 8]
        assert rep["completed"] == 24
        assert 1 <= n_sigs == compiles <= 3

    def test_padded_rows_never_reach_a_client(self):
        """A lone request in bucket 4: the filter sees 4 rows (3 padded
        copies of it), the client gets one reply, and the sink's demux
        answered one row."""
        shapes = []

        def spy(x):
            shapes.append(x.shape)
            return x * 2

        register_custom_easy("serve_spy", spy)
        server, port = _server(pt, 46, "serve_spy",
                               "buckets=4 max-wait-ms=1")
        client = _client(pt, port)
        out = _push_and_wait(pt, client, [3.0], 1)
        time.sleep(0.1)
        rep = server["src"].scheduler.report()
        _close(client)
        server.stop()
        assert shapes == [(4, 4)]
        assert out == [6.0] and len(client["out"].buffers) == 1
        assert rep["completed"] == 1 and rep["occupancy_avg"] == 0.25

    def test_fetch_host_is_one_fetch_for_every_card_chunk(self, monkeypatch):
        """The sink's read: every chunk still on the card joins ONE
        submit_fetch (one copy batch on the copy stream), never one
        blocking copy a chunk; host chunks pass."""
        from nnstreamer_tpu_torch.tensors import transfer
        card = [torch.arange(3.0), torch.arange(4.0)]
        calls = []

        def fake_submit(outputs):
            dev = [o for o in outputs if any(o is c for c in card)]
            calls.append(len(dev))
            ticket = transfer._Ticket(dev)
            ticket._deliver([o.numpy() for o in dev])
            slot = {id(o): i for i, o in enumerate(dev)}
            return [transfer.PendingHost(ticket, slot[id(o)], o)
                    if id(o) in slot else o for o in outputs]

        monkeypatch.setattr(transfer, "submit_fetch", fake_submit)
        buf = pt.Buffer.from_arrays([card[0], np.ones(2), card[1]])
        hosts = buf.fetch_host()
        assert calls == [2]
        assert [h.tolist() for h in hosts] == [[0, 1, 2], [1, 1], [0, 1, 2, 3]]


# ------------------------------------------------ graceful drain

def _drain_run(pkg, ident, filt_extra="", sent=12):
    """The reference's drain case: 12 frames in flight through a 50 ms
    filter, ``drain`` mid-stream. Returns (ok, n_result, n_shed,
    pending, report, values, server)."""
    server, port = _server(
        pkg, ident, None, "buckets=1,2,4 max-wait-ms=2 retry-after-ms=10",
        filt="tensor_filter name=f framework=custom-easy model=serve_slow "
             + filt_extra)
    client = _client(pkg, port, max_request=32)
    _push(pkg, client, range(sent))

    def in_flight():
        # admitted by the server, not only sent by the client: a drain
        # that lands before the first frame arrives sheds all twelve
        stats = server["src"].scheduler.batcher.stats.snapshot()
        return stats["submitted"] > 0

    _wait(in_flight, 10)
    ok = server.drain(deadline=30)

    def settled():
        with client["qc"]._plock:
            pending = len(client["qc"]._pending)
        return _settled(client) >= sent and not pending

    _wait(settled, 10)
    with client["qc"]._plock:
        pending = len(client["qc"]._pending)
    n_result, n_shed = len(client["out"].buffers), client["qc"].stats["shed"]
    rep = server["src"].scheduler.report()
    vals = [float(b.chunks[0].host()[0]) for b in client["out"].buffers]
    _close(client)
    return ok, n_result, n_shed, pending, rep, vals, server


class TestDrainSettlement:
    def test_drain_settles_pending_correlations(self):
        """Pipeline.drain() on the serving side answers every admitted
        request — RESULT or SHED, never silence — before close."""
        ok, n_result, n_shed, pending, rep, vals, server = _drain_run(pt, 44)
        assert ok is True, "drain must flush inside the deadline"
        assert pending == 0, "drain left correlations unsettled"
        assert n_result + n_shed == 12
        assert n_result > 0, "everything shed: nothing was in flight"
        assert server["src"].scheduler.pending() == 0
        assert rep["completed"] == n_result
        check_identities({**rep, "pending": 0}, names=["serve-settlement"])
        assert vals == sorted(vals)  # per-stream order survives the drain
        assert set(vals) <= {float(i) for i in range(12)}

    def test_drain_idle_pipeline_is_clean(self):
        server, _ = _server(pt, 45, "serve_double", "buckets=1 max-wait-ms=1")
        assert server.drain(deadline=10) is True
        assert server.drain(deadline=1) is True  # idempotent
        assert server["src"].scheduler.pending() == 0

    def test_drain_quiesces_a_suspend_filter(self):
        """The filter's drain quiesces its suspend watchdog (so the model
        is not unloaded mid-flush) and every admitted request is still
        answered once."""
        ok, n_result, n_shed, pending, rep, _, server = _drain_run(
            pt, 47, "suspend=20")
        assert ok is True and pending == 0
        assert n_result + n_shed == 12 and n_result > 0
        assert server["f"]._watchdog is None  # stop() destroyed it
        check_identities({**rep, "pending": 0}, names=["serve-settlement"])

    def test_drain_hook_quiesces_the_watchdog(self):
        from nnstreamer_tpu_torch.elements.filter import TensorFilter
        f = TensorFilter("f")
        f._watchdog = Watchdog(10.0, lambda: None)
        try:
            f.drain()
            assert f._watchdog.quiesced
        finally:
            f._watchdog.destroy()

    def test_drain_settles_like_the_reference(self):
        """Both packages' serve lines drained the same way reach the same
        terminal state: drain returns True, nothing is owed, every frame
        is RESULT xor SHED and the identity holds."""
        for pkg, ident in ((pt, 48), (nt, 49)):
            ok, n_result, n_shed, pending, rep, _, _ = _drain_run(pkg, ident)
            assert (ok, pending, n_result + n_shed) == (True, 0, 12)
            check_identities({**rep, "pending": 0},
                             names=["serve-settlement"])

    def test_invoke_error_sheds_rows_on_the_sync_path(self):
        """A failing invoke on the synchronous filter answers each row of
        the batch with a SHED and books it as shed_failed, so the
        identity balances (the reference leaves them to the client's
        timeout on this path)."""
        register_custom_easy("serve_fail", lambda x: 1 / 0)
        server, port = _server(pt, 50, "serve_fail",
                               "buckets=1,2 max-wait-ms=1 retry-after-ms=5")
        client = _client(pt, port)
        _push(pt, client, range(5))
        _wait(lambda: _settled(client) >= 5, 20)
        rep = server["src"].scheduler.report()
        n_shed = client["qc"].stats["shed"]
        _close(client)
        server.stop()
        assert n_shed == 5 and not client["out"].buffers
        assert rep["shed_failed"] == 5 and rep["completed"] == 0
        check_identities({**rep, "pending": 0}, names=["serve-settlement"])

    def test_breaker_open_shed_answers_rows(self):
        """breaker-threshold=1: the first failure opens the breaker, the
        frames after it are shed without an invoke; every row is
        answered and booked."""
        register_custom_easy("serve_fail", lambda x: 1 / 0)
        server, port = _server(
            pt, 51, None, "buckets=1 max-wait-ms=1 retry-after-ms=5",
            filt="tensor_filter name=f framework=custom-easy "
                 "model=serve_fail breaker-threshold=1 "
                 "breaker-reset-ms=60000")
        client = _client(pt, port)
        _push(pt, client, range(6))
        _wait(lambda: _settled(client) >= 6, 20)
        rep = server["src"].scheduler.report()
        fst = server["f"].stats.snapshot()
        n_shed = client["qc"].stats["shed"]
        _close(client)
        server.stop()
        assert n_shed == 6
        assert fst["invoke_errors"] == 1 and fst["shed"] == 5
        assert rep["shed_failed"] == 6
        check_identities({**rep, "pending": 0}, names=["serve-settlement"])

    def test_shed_frame_answers_the_rows_of_any_element(self):
        """fault/breaker.py's shed_frame, shared by the filter and the
        fused segment: each serve row gets its SHED and the scheduler
        books them, whichever element sheds."""
        from nnstreamer_tpu_torch.fault.breaker import shed_frame
        from nnstreamer_tpu_torch.utils.atomic import Counters
        sched = ServeScheduler(buckets=(2,), max_wait_s=10.0)
        shed = []
        for i in range(2):
            sched.submit(i, [np.zeros(4, np.float32)], on_shed=shed.append)
        batch, _, stacked = sched.next_batch()
        buf = pt.Buffer.from_arrays(stacked)
        buf.extras.update(serve_rows=batch, serve_sched=sched)
        events = []

        class Segment:
            name = "seg"
            pipeline = None
            breaker_retry_after_ms = 20.0
            stats = Counters(shed=0, dropped=0)
            send_upstream_event = events.append

        shed_frame(Segment(), buf)
        assert shed == batch and len(events) == 1
        assert events[0].period_ns == 20_000_000
        check_identities({**sched.report(), "pending": 0},
                         names=["serve-settlement"])

    def test_query_serversrc_drain_answers_what_it_queued(self):
        """The query serversrc's drain: DRAIN to its clients, the queued
        frames flushed behind the EOS barrier, each answered once."""
        port = _free_port()
        server = pt.parse_launch(
            f"tensor_query_serversrc name=s port={port} id={port} "
            "! tensor_filter framework=custom-easy model=serve_slow "
            f"! tensor_query_serversink id={port}")
        server.start()
        client = _client(pt, port, max_request=16)
        _push(pt, client, range(8))
        _wait(lambda: client["qc"].stats["session_requests"] >= 8, 10)
        time.sleep(0.05)
        ok = server.drain(deadline=30)
        _wait(lambda: len(client["out"].buffers) >= 8, 5)
        got = [float(b.chunks[0].host()[0]) for b in client["out"].buffers]
        drains = client["qc"].stats.snapshot().get("server_drains", 0)
        _close(client)
        assert ok is True
        assert got == [float(i) for i in range(8)]
        assert drains == 1

    def test_edgesrc_drain_ends_the_stream_without_link_errors(self):
        """The subscriber's drain acks what it delivered and closes the
        link: the frames already received reach the sink, then EOS, and
        the close is no link error."""
        port = _free_port()
        pub = pt.parse_launch(
            f'appsrc name=in caps="{CAPS4}" ! edgesink name=e port={port}')
        pub.start()
        sub = pt.parse_launch(
            f"edgesrc name=s dest-port={port} ! appsink name=out")
        sub.start()

        def subscribed():
            with pub["e"]._subs_lock:
                return len(pub["e"]._subs) >= 1

        assert _wait(subscribed, 10)
        _push(pt, pub, range(4))
        _wait(lambda: len(sub["out"].buffers) >= 4, 10)
        ok = sub.drain(deadline=10)
        errors = sub["s"].stats["link_errors"]
        pub["in"].end_stream()
        pub.stop()
        assert ok is True
        assert [float(b.chunks[0].host()[0]) for b in sub["out"].buffers] \
            == [0.0, 1.0, 2.0, 3.0]
        assert errors == 0


# ------------------------------------------------- ROI frame settlement

class TestRoiSettlement:
    """The ROI gate's whole-frame settlement: one terminal per frame
    (RESULT xor SHED), and a shed frame's still-queued sibling crops
    are cancelled — the same sequence of replies as the reference."""

    @staticmethod
    def _element(mod, sched_mod, max_queue=16):
        el = mod.TensorServeSrc("roi-src")
        el.scheduler = sched_mod.ServeScheduler(buckets=(4,), max_wait_s=10.0,
                                                max_queue=max_queue)
        sent = []
        el._send = lambda cid, kind, meta, payloads=(): \
            sent.append((kind.name, meta, payloads))
        return el, sent

    @staticmethod
    def _crops(pkg, n=4):
        return pkg.Buffer.from_arrays(
            [np.arange(n * 8 * 8 * 3, dtype=np.float32)
             .reshape(n, 8, 8, 3)], pts=123)

    def _both(self, max_queue=16):
        from nnstreamer_tpu.serve import scheduler as nt_sched
        from nnstreamer_tpu_torch.serve import scheduler as pt_sched
        return [self._element(serve_elements, pt_sched, max_queue) + (pt,),
                self._element(nt_serve_elements, nt_sched, max_queue) + (nt,)]

    def test_admission_shed_cancels_sibling_crops(self):
        """Crop 3 of 4 sheds at admission: the frame settles as ONE SHED,
        the two already-queued siblings are reclaimed, and both
        identities balance, as in the reference."""
        runs = []
        for el, sent, pkg in self._both(max_queue=2):
            el._admit_roi(7, self._crops(pkg), seq=0, roi={"tile": 8})
            s = el.stats.snapshot()
            assert s["serve_roi_requests"] == 1 and s["serve_roi_crops"] == 4
            assert s["serve_roi_shed"] == 1 and s["serve_roi_results"] == 0
            assert el.scheduler.batcher.depth() == 0
            assert el.scheduler.batcher.stats["cancelled"] == 2
            check_identities({**el.scheduler.report(), "pending": 0},
                             names=["serve-settlement"])
            check_identities({**s, "serve_roi_pending": 0},
                             names=["roi-settlement"])
            runs.append([(k, m) for k, m, _ in sent])
        assert runs[0] == runs[1] and runs[0][0][0] == "SHED"
        assert runs[0][0][1]["retry_after_ms"] > 0

    def test_complete_frame_settles_as_one_result(self):
        payloads = []
        for el, sent, pkg in self._both():
            el._admit_roi(7, self._crops(pkg), seq=0, roi={"tile": 8})
            batch, _bucket, stacked = el.scheduler.next_batch()
            assert len(batch) == 4
            el.scheduler.complete(batch, stacked)
            s = el.stats.snapshot()
            assert s["serve_roi_results"] == 1 and s["serve_roi_shed"] == 0
            assert [k for k, _, _ in sent] == ["RESULT"]
            assert sent[0][1]["delta_roi"] == {"tile": 8}
            check_identities({**s, "serve_roi_pending": 0},
                             names=["roi-settlement"])
            payloads.append(b"".join(bytes(p) for p in sent[0][2]))
        assert payloads[0] == payloads[1]  # the stitched reply, bitwise


# ------------------------------------------------------ watchdog

class TestWatchdog:
    def test_single_persistent_thread(self):
        fired = threading.Event()
        wd = Watchdog(0.2, fired.set)
        try:
            before = threading.active_count()
            for _ in range(200):
                wd.feed()
            assert threading.active_count() <= before + 1
            assert len([t for t in threading.enumerate()
                        if t.name == "watchdog"]) >= 1
        finally:
            wd.destroy()

    def test_feed_postpones_and_fires_once(self):
        fires = []
        wd = Watchdog(0.15, lambda: fires.append(time.monotonic()))
        try:
            t0 = time.monotonic()
            wd.feed()
            time.sleep(0.08)
            wd.feed()
            time.sleep(0.3)
            assert len(fires) == 1
            assert fires[0] - t0 >= 0.15
            time.sleep(0.2)    # disarmed after firing: no re-fire
            assert len(fires) == 1
        finally:
            wd.destroy()

    def test_destroy_suppresses_pending_fire(self):
        fired = threading.Event()
        wd = Watchdog(0.1, fired.set)
        wd.feed()
        wd.destroy()
        time.sleep(0.25)
        assert not fired.is_set()

    def test_quiesce_suppresses_fire_resume_rearms_fresh(self):
        fires = []
        wd = Watchdog(0.1, lambda: fires.append(time.monotonic()))
        try:
            wd.feed()
            wd.quiesce()
            time.sleep(0.3)          # deadline lapses while quiesced
            assert fires == []
            t0 = time.monotonic()
            wd.resume()
            time.sleep(0.04)
            assert fires == []       # fresh timeout, not a retroactive bite
            assert _wait(lambda: fires, 5)
            assert len(fires) == 1 and fires[0] - t0 >= 0.1
        finally:
            wd.destroy()

    def test_quiesce_nests(self):
        fired = threading.Event()
        wd = Watchdog(0.08, fired.set)
        try:
            wd.feed()
            wd.quiesce()
            wd.quiesce()
            wd.resume()
            assert wd.quiesced       # one resume is not enough
            time.sleep(0.2)
            assert not fired.is_set()
            wd.resume()
            assert not wd.quiesced
            assert fired.wait(2.0)
        finally:
            wd.destroy()


# ------------------------------------------------------ percentiles

class TestPercentiles:
    def test_reservoir_exact_under_capacity(self):
        r = Reservoir(k=512)
        for v in range(101):
            r.add(float(v))
        p = r.percentiles()
        assert p["p50"] == 50.0 and p["p95"] == 95.0 and p["p99"] == 99.0

    def test_reservoir_bounded_memory(self):
        r = Reservoir(k=64)
        for v in range(10_000):
            r.add(float(v))
        assert len(r.samples) == 64 and r.n == 10_000
        assert 2_000 < r.percentiles()["p50"] < 8_000

    def test_reservoir_deterministic(self):
        a, b = Reservoir(k=8), Reservoir(k=8)
        for v in range(1000):
            a.add(float(v))
            b.add(float(v))
        assert a.samples == b.samples

    def test_window_reservoir_forgets_old_pressure(self):
        from nnstreamer_tpu_torch.utils.trace import WindowReservoir
        r = WindowReservoir(window_s=2.0)
        for i in range(50):
            r.add(300_000.0, now=10.0 + i * 0.01)
        assert r.percentiles(qs=(95,), now=10.5)["p95"] == 300_000.0
        for i in range(20):
            r.add(500.0, now=13.0 + i * 0.01)
        p = r.percentiles(qs=(50, 95), now=13.2)
        assert p["p95"] == 500.0 and p["p50"] == 500.0
        assert r.n == 70

    def test_window_reservoir_bounded_and_empty_window(self):
        from nnstreamer_tpu_torch.utils.trace import WindowReservoir
        r = WindowReservoir(window_s=60.0, k=16)
        for i in range(1000):
            r.add(float(i), now=100.0 + i * 1e-4)
        assert len(r._buf) <= 17
        r2 = WindowReservoir(window_s=1.0)
        r2.add(42.0, now=5.0)
        r2.add(43.0, now=99.0)
        assert r2.percentiles(qs=(95,), now=99.0)["p95"] == 43.0

    def test_tracer_report_has_percentile_columns(self):
        tr = Tracer()
        for v in (1, 2, 3, 4, 100):
            tr.observe("serve:queue_delay", v * 1e3)  # ns
        rep = tr.report()["serve:queue_delay"]
        assert rep["buffers"] == 5
        assert rep["interlatency_us_p50"] == pytest.approx(3.0)
        assert rep["interlatency_us_p99"] == pytest.approx(100.0)
        assert rep["interlatency_us_max"] == pytest.approx(100.0)


# --------------------------------------------- across the two packages

def _wire_run(server_pkg, client_pkg, ident, mid, extra, sent,
              drain_after=None):
    """A ``client_pkg`` client against a ``server_pkg`` serve line;
    returns (values, client stats, server report, drain result)."""
    server, port = _server(server_pkg, ident, mid, extra)
    client = _client(client_pkg, port, max_request=64)
    _push(client_pkg, client, range(sent))
    ok = None
    if drain_after is not None:
        _wait(lambda: len(client["out"].buffers) >= drain_after, 20)
        ok = server.drain(deadline=30)

    def settled():
        with client["qc"]._plock:
            return _settled(client) >= sent and not client["qc"]._pending

    _wait(settled, 30)
    vals = [float(b.chunks[0].host()[0]) for b in client["out"].buffers]
    stats = client["qc"].stats.snapshot()
    rep = server["src"].scheduler.report()
    _close(client)
    server.stop()
    return vals, stats, rep, ok


@pytest.mark.parametrize("server_pkg,client_pkg", [(nt, pt), (pt, nt)],
                         ids=["port-client-jax-server",
                              "jax-client-port-server"])
class TestWireAcrossPackages:
    def test_results_round_trip(self, server_pkg, client_pkg):
        vals, stats, rep, _ = _wire_run(server_pkg, client_pkg, 52,
                                        "serve_double",
                                        "buckets=1,2,4 max-wait-ms=2", 10)
        assert vals == [2.0 * i for i in range(10)]
        assert stats["shed"] == 0 and rep["completed"] == 10

    def test_shed_carries_retry_after(self, server_pkg, client_pkg):
        vals, stats, rep, _ = _wire_run(
            server_pkg, client_pkg, 53, "serve_slow",
            "buckets=1 max-wait-ms=1 max-queue=2 retry-after-ms=25", 16)
        assert stats["shed"] > 0
        assert len(vals) + stats["shed"] == 16
        assert rep["shed_admission"] == stats["shed"]
        check_identities({**rep, "pending": 0}, names=["serve-settlement"])

    def test_drain_reaches_the_client(self, server_pkg, client_pkg):
        vals, stats, rep, ok = _wire_run(
            server_pkg, client_pkg, 54, "serve_slow",
            "buckets=1,2,4 max-wait-ms=2 retry-after-ms=10", 12,
            drain_after=1)
        assert ok is True
        assert stats.get("server_drains", 0) == 1
        assert len(vals) + stats["shed"] == 12 and vals == sorted(vals)
        check_identities({**rep, "pending": 0}, names=["serve-settlement"])


_LOAD_NPZ = """
import numpy as np


def _tree(path):
    flat, tree = np.load(path), {{}}
    for key in flat.files:
        *parts, leaf = key.split("/")
        node = tree
        for part in parts:
            node = node.setdefault(part, {{}})
        node[leaf] = flat[key]
    return tree
"""
_JAX_MOBILENET_PY = _LOAD_NPZ + """
from nnstreamer_tpu.models import zoo


def get_model():
    apply_fn, _, in_info, out_info = zoo.build(
        "mobilenet_v2", width="0.35", size="96")
    return apply_fn, _tree({npz!r}), in_info, out_info
"""
_PORT_MOBILENET_PY = _LOAD_NPZ + """
from nnstreamer_tpu_torch.models.convert import mobilenet_params_from_jax
from nnstreamer_tpu_torch.models.mobilenet import MobileNetV2, make_apply
from nnstreamer_tpu_torch.tensors.info import TensorsInfo


def get_model():
    model = MobileNetV2(num_classes=1001, width=0.35)
    model.load_state_dict(mobilenet_params_from_jax(_tree({npz!r})))
    return (make_apply(False), model, TensorsInfo.make("uint8", "3:96:96"),
            TensorsInfo.make("float32", "1001"))
"""
_VIT_CFG = dict(size="64", d_model="64", layers="2", heads="4",
                classes="10", attn="pallas")
_JAX_VIT_PY = _LOAD_NPZ + """
from nnstreamer_tpu.models import zoo


def get_model():
    apply_fn, _, in_info, out_info = zoo.build("vit", **{cfg!r})
    return apply_fn, _tree({npz!r}), in_info, out_info
"""
_PORT_VIT_PY = _LOAD_NPZ + """
from nnstreamer_tpu_torch.models import zoo
from nnstreamer_tpu_torch.models.convert import vit_params_from_jax


def get_model():
    apply_fn, model, in_info, out_info = zoo.build("vit", **{cfg!r})
    model.load_state_dict(vit_params_from_jax(_tree({npz!r})))
    return apply_fn, model, in_info, out_info
"""


def _save_tree(path, variables, rng=None):
    """Flatten a JAX variable tree into ``path`` (npz); with ``rng`` the
    BatchNorm statistics are drawn from it (at init they are 0/1)."""
    flat = {}
    for kpath, leaf in jax.tree_util.tree_flatten_with_path(
            jax.device_get(variables))[0]:
        key = "/".join(str(k.key) for k in kpath)
        leaf = np.asarray(leaf)
        if rng is not None and key.endswith("/mean"):
            leaf = rng.normal(0.0, 0.5, leaf.shape).astype(np.float32)
        elif rng is not None and key.endswith("/var"):
            leaf = rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)
        flat[key] = leaf
    np.savez(path, **flat)


def _model_files(tmp, name, variables, texts, rng=None, **fmt):
    npz = tmp / f"{name}.npz"
    _save_tree(npz, variables, rng)
    files = {}
    for pkg, text in texts.items():
        files[pkg] = tmp / f"{name}_{pkg.__name__}.py"
        files[pkg].write_text(text.format(npz=str(npz), **fmt))
    return files


def _filter(pkg, model):
    if pkg is pt:
        return ("tensor_filter name=f framework=torch-cuda "
                f"accelerator=true:cpu model={model}")
    return f"tensor_filter name=f framework=jax model={model}"


def _serve_frames(pkg, model, frames, caps, ident, buckets="1,2,4"):
    """One client sends ``frames`` (pts 0..) through ``pkg``'s serve line
    over ``model``; returns ({pts: logits}, filter compile count)."""
    server, port = _server(pkg, ident, None,
                           f"buckets={buckets} max-wait-ms=20",
                           filt=_filter(pkg, model))
    client = _client(pkg, port, caps=caps, max_request=8)
    for i, f in enumerate(frames):
        client["in"].push_buffer(pkg.Buffer.from_arrays([f], pts=i))
    _wait(lambda: len(client["out"].buffers) >= len(frames), 120)
    got = {b.pts: np.asarray(b.chunks[0].host())
           for b in client["out"].buffers}
    compiles = getattr(server["f"].fw, "compile_count", None)
    rep = server["src"].scheduler.report()
    _close(client)
    server.stop()
    assert rep["completed"] == len(frames) and rep["batches"] < len(frames)
    return got, compiles


def _local(pkg, model, frames, caps):
    line = pkg.parse_launch(f"appsrc name=in caps={caps} ! "
                            f"{_filter(pkg, model)} ! appsink name=out")
    line.start()
    try:
        for i, f in enumerate(frames):
            line["in"].push_buffer(pkg.Buffer.from_arrays([f], pts=i))
        line["in"].end_stream()
        line.wait_eos(120)
    finally:
        line.stop()
    return [np.asarray(b.chunks[0].host()) for b in line["out"].buffers]


def test_serving_parity_mobilenet(tmp_path):
    """The port's serve line against the JAX package's on the same
    frames and variables: every frame answered once, under its own pts,
    within the bf16 bound and with equal top-1; and against the port's
    own local line within the batched f32 bound."""
    _, variables, _, _ = jax_zoo.build("mobilenet_v2", width="0.35",
                                       size="96")
    files = _model_files(tmp_path, "mobilenet", variables,
                         {nt: _JAX_MOBILENET_PY, pt: _PORT_MOBILENET_PY},
                         rng=np.random.default_rng(31))
    rng = np.random.default_rng(2024)
    frames = [rng.integers(0, 255, (96, 96, 3), np.uint8, endpoint=True)
              for _ in range(6)]
    got, compiles = _serve_frames(pt, str(files[pt]), frames, CAPS96, 55)
    want, _ = _serve_frames(nt, str(files[nt]), frames, CAPS96, 56)
    local = _local(pt, str(files[pt]), frames, CAPS96)
    assert sorted(got) == sorted(want) == list(range(6))
    assert compiles <= 3
    for i in range(6):
        g = got[i]
        assert g.dtype == np.float32 and g.shape == (1001,)
        np.testing.assert_allclose(g, want[i], rtol=0, atol=BF16_ATOL)
        assert int(g.argmax()) == int(want[i].argmax())
        np.testing.assert_allclose(g, local[i], rtol=0, atol=BATCH_ATOL)


def test_vit_serve_path_matches_jax_interpreted_kernel(tmp_path,
                                                       monkeypatch):
    """The ViT serve line (attn=pallas) on the CPU: the port's attention
    runs attention_plain (the kernel's plain version; nothing launches),
    the JAX line's fused_attention runs the Pallas kernel in interpret
    mode; replies agree within the ViT bf16 bound with equal argmax."""
    from nnstreamer_tpu.ops import attention as nt_attention
    from nnstreamer_tpu_torch.ops import attention as pt_attention
    monkeypatch.setattr(nt_attention, "fused_attention", functools.partial(
        nt_attention.fused_attention, interpret=True))
    plain_calls = []
    plain = pt_attention.attention_plain
    monkeypatch.setattr(pt_attention, "attention_plain",
                        lambda *a: (plain_calls.append(a[0].shape),
                                    plain(*a))[1])
    _, params, _, _ = jax_zoo.build("vit", **_VIT_CFG)
    files = _model_files(tmp_path, "vit", params,
                         {nt: _JAX_VIT_PY, pt: _PORT_VIT_PY}, cfg=_VIT_CFG)
    rng = np.random.default_rng(11)
    frames = [rng.integers(0, 255, (64, 64, 3), np.uint8, endpoint=True)
              for _ in range(4)]
    launches0 = pt_attention.launches
    got, _ = _serve_frames(pt, str(files[pt]), frames, CAPS64, 57,
                           buckets="1,2")
    want, _ = _serve_frames(nt, str(files[nt]), frames, CAPS64, 58,
                            buckets="1,2")
    assert pt_attention.launches == launches0
    assert plain_calls and all(s[0] in (1, 2) and s[2] == 4
                               for s in plain_calls)
    for i in range(4):
        np.testing.assert_allclose(got[i], want[i], rtol=0, atol=VIT_ATOL)
        assert int(got[i].argmax()) == int(want[i].argmax())


@pytest.mark.parametrize("prop", ["mesh=4x1x1"])
def test_refused_properties_raise_not_ported(prop):
    """``mesh=`` is ported. With fewer devices than the spec (no mesh
    world runs and this machine has no card, so the pool the spec wants
    is empty) the serve path keeps the JAX scheduler's degrade, not a
    device fallback: the buckets stay snapped to the data-parallel
    degree, the batches stay on the host (``place`` hands them back),
    and the failure is logged once; nothing starts a mesh world."""
    from nnstreamer_tpu_torch.parallel import world
    p = pt.parse_launch(
        f"tensor_serve_src name=src port=0 buckets=1,2,6 {prop} "
        "! tensor_filter framework=custom-easy model=serve_double "
        "! tensor_serve_sink")
    p.start()
    try:
        sched = p["src"].scheduler
        assert sched.batcher.buckets == [4, 8]
        stacked = [np.zeros((4, 3), np.float32)]
        assert sched.place(stacked) is stacked
        assert sched.place(stacked) is stacked  # degraded once, for good
        rep = sched.report()
        assert rep["mesh"] == "4x1x1" and rep["devices"] == 0
        assert rep["placed_batches"] == 0
        assert not world.started()
    finally:
        p.stop()


# ---------------------------------------------------------- pipelint

FILTER = "tensor_filter name=f framework=simlink"


def _findings(desc, rule):
    """The port's findings of ``rule`` for ``desc``, after checking that
    the JAX package finds the same (rule, element, pad, severity) set."""
    def keys(report):
        return {(f.rule, f.element, f.pad, f.severity)
                for f in report.findings if f.rule == rule}
    report = analyze(pt.parse_launch(desc))
    assert not report.crashed
    assert keys(report) == keys(nt_analyze(nt.parse_launch(desc)))
    return [f for f in report.findings if f.rule == rule]


class TestServeRules:
    def test_unbounded_admission(self):
        bad = (  # pipelint: skip — max-queue=0 turns off admission control
            f"tensor_serve_src name=s max-queue=0 ! {FILTER} ! "
            "tensor_serve_sink")
        got = _findings(bad, "unbounded-admission")
        assert [(f.element, f.severity) for f in got] == \
            [("s", Severity.WARNING)]
        assert "max-queue=0" in got[0].message

    def test_bounded_admission_is_clean(self):
        ok = (f"tensor_serve_src name=s buckets=1,2,4 max-queue=16 ! "
              f"{FILTER} ! tensor_serve_sink")
        assert _findings(ok, "unbounded-admission") == []

    def test_query_serversrc_admission_is_info_only(self):
        desc = (f"tensor_query_serversrc name=qs batch=4 ! {FILTER} ! "
                "tensor_query_serversink")
        got = _findings(desc, "unbounded-admission")
        assert [(f.element, f.severity) for f in got] == \
            [("qs", Severity.INFO)]
        assert analyze(pt.parse_launch(desc)).exit_code == 0

    def test_jit_signatures_bucket_budget(self):
        bad = (  # pipelint: skip — 9 buckets > the signature budget of 8
            f"tensor_serve_src name=s buckets=1,2,3,4,5,6,7,8,9 ! {FILTER} "
            "! tensor_serve_sink")
        got = _findings(bad, "jit-signatures")
        assert [(f.element, f.pad) for f in got] == [("f", "sink")]
        assert "9 batch buckets" in got[0].message

    def test_shed_no_retry_after_on_the_serve_src(self):
        bad = (  # pipelint: skip — retry-after-ms=0 sheds with no hint
            f"tensor_serve_src name=s retry-after-ms=0 ! {FILTER} ! "
            "tensor_serve_sink")
        got = _findings(bad, "shed-no-retry-after")
        assert [(f.element, f.severity) for f in got] == \
            [("s", Severity.WARNING)]
        ok = (f"tensor_serve_src name=s retry-after-ms=25 ! {FILTER} "
              "breaker-threshold=3 ! tensor_serve_sink")
        assert _findings(ok, "shed-no-retry-after") == []

    def test_async_window_exceeding_bucket_budget_is_error(self):
        bad = (  # pipelint: skip — window 16 > the signature budget of 8
            "tensor_serve_src name=s buckets=1,2,4 max-queue=16 ! "
            f"{FILTER} in-flight=16 ! tensor_serve_sink")
        got = _findings(bad, "async-window")
        assert [(f.element, f.severity) for f in got] == \
            [("f", Severity.ERROR)]
