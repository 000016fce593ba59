"""The port's telemetry plane (nnstreamer_tpu_torch/obs/) against the JAX
package's, on the CPU.

Mirrors tests/test_obs.py: the trace contexts, the span rings, the
per-element span trees of a pipeline (source root, queue wait, element
hops, in-flight dispatch and completion) settling the end-to-end
histogram, the flight recorder (events, dumps, the abort and preempt
triggers), the metrics plane (render/parse, every section, the serve
series mid-run), the scrape server (routes, broker registration, the
``top`` table) and the light arm of the cross-process span tree, with a
port replica as the child process. Beside the mirrors, the two packages
are held to each other:

* ``render()`` is byte-equal for the same synthetic state (histogram
  observations, element counters, serve, KV-pool and fleet gauges,
  event counts) — tolerance: none, the bytes;
* ``parse(render())`` reads hostile labels back the same in both;
* the JAX ``scrape`` reads a port ``MetricsServer`` and the reverse, and
  each parses to its local render's samples;
* the flight dump of the same line has the same event schema, field by
  field: each frame's spans as (name, cat) with the same keys and
  ``args`` keys, and the same metadata and instant-event keys.

Flight dumps go to a temporary ``NNS_TPU_FLIGHT_DIR`` in every test.
"""
import json
import os
import pickle
import socket
import subprocess
import sys
import threading
import time
import weakref
from pathlib import Path

import numpy as np
import pytest

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as pt
from nnstreamer_tpu.obs import events as nt_events
from nnstreamer_tpu.obs import metrics as nt_metrics
from nnstreamer_tpu.obs import server as nt_server
from nnstreamer_tpu.obs.recorder import RECORDER as NT_RECORDER
from nnstreamer_tpu_torch import Buffer
from nnstreamer_tpu_torch.edge import wire
from nnstreamer_tpu_torch.obs import context as obs_ctx
from nnstreamer_tpu_torch.obs import events as obs_events
from nnstreamer_tpu_torch.obs import metrics as obs_metrics
from nnstreamer_tpu_torch.obs import spans as obs_spans
from nnstreamer_tpu_torch.obs import top as obs_top
from nnstreamer_tpu_torch.obs.recorder import RECORDER
from nnstreamer_tpu_torch.obs.server import MetricsServer, scrape

REPO = str(Path(__file__).resolve().parent.parent)

CAPS4 = ('other/tensors,format=static,num_tensors=1,'
         'types=(string)float32,dimensions=(string)4,'
         'framerate=(fraction)0/1')
CAPS64 = ('other/tensors,format=static,num_tensors=1,'
          'types=(string)float32,dimensions=(string)64')
MLP = "zoo://mlp?dtype=float32"


@pytest.fixture(autouse=True)
def flight_dir(tmp_path, monkeypatch):
    """Every automatic dump of a test lands in its own directory."""
    d = tmp_path / "flight"
    monkeypatch.setenv("NNS_TPU_FLIGHT_DIR", str(d))
    yield d


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spans_by_trace(trace_ids, spans_mod=obs_spans):
    """Live-ring spans grouped by trace id (only the asked-for traces,
    so concurrent test history can't bleed in)."""
    want = set(trace_ids)
    out = {t: [] for t in want}
    for _tid, s in spans_mod.snapshot():
        if s[4] in want:
            out[s[4]].append(s)
    return out


def _assert_tree(spans):
    """One connected span tree: exactly one root, no orphan parents."""
    ids = {s[5] for s in spans}
    roots = [s for s in spans if s[6] == 0]
    assert len(roots) == 1, f"want one root, got {roots}"
    for s in spans:
        assert s[6] == 0 or s[6] in ids, f"orphan span {s}"


def _wait(pred, timeout=30):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


# ------------------------------------------------------------- context

class TestTraceContext:
    def test_stamp_attaches_and_sets_thread_inheritance(self):
        buf = Buffer.from_arrays([np.zeros(4, np.float32)])
        ctx = obs_ctx.stamp(buf)
        assert obs_ctx.ctx_of(buf) is ctx
        # a fresh (meta-stripped) buffer on the same thread inherits it
        fresh = Buffer.from_arrays([np.zeros(4, np.float32)])
        assert obs_ctx.ensure_ctx(fresh) is ctx
        assert obs_ctx.ctx_of(fresh) is ctx

    def test_ids_are_unique_and_nonzero(self):
        ids = {obs_ctx.next_id() for _ in range(1000)}
        assert len(ids) == 1000
        assert 0 not in ids

    def test_child_forks_accumulators_not_identity(self):
        ctx = obs_ctx.TraceContext(7, 9, 1000, q_ns=5, c_ns=6, w_ns=7)
        kid = ctx.child()
        assert (kid.trace_id, kid.span_id, kid.t0_ns) == (7, 9, 1000)
        assert (kid.q_ns, kid.c_ns, kid.w_ns) == (0, 0, 0)

    def test_pickle_round_trip(self):
        ctx = obs_ctx.TraceContext(7, 9, 1000, q_ns=5, c_ns=6, w_ns=8)
        back = pickle.loads(pickle.dumps(ctx))
        assert (back.trace_id, back.span_id, back.t0_ns,
                back.q_ns, back.c_ns, back.w_ns) == (7, 9, 1000, 5, 6, 8)

    def test_wire_round_trip_preserves_attribution(self):
        ctx = obs_ctx.TraceContext(0xabc, 0xdef, 1234,
                                   q_ns=10, c_ns=20, w_ns=30)
        field = obs_ctx.to_wire(ctx)
        back, t_send = obs_ctx.from_wire(field)
        assert (back.trace_id, back.span_id, back.t0_ns) == \
            (0xabc, 0xdef, 1234)
        assert (back.q_ns, back.c_ns, back.w_ns) == (10, 20, 30)
        assert t_send == field[2]

    @pytest.mark.parametrize("bad", [
        None, "junk", [], [1, 2], [1, 2, 3, 4, 5, 6, "x"],
        [0, 1, 2, 3, 4, 5, 6],                 # trace_id 0 = untraced
        {"trace": 1},
    ])
    def test_malformed_wire_field_is_dropped_not_fatal(self, bad):
        assert obs_ctx.from_wire(bad) is None


# --------------------------------------------------------------- spans

class TestSpanRings:
    def test_record_span_advances_context_chain(self):
        ctx = obs_ctx.TraceContext(obs_ctx.next_id(), 0, time.time_ns())
        a = obs_spans.record_span("a", "element", time.time_ns(), 10, ctx)
        b = obs_spans.record_span("b", "element", time.time_ns(), 10, ctx)
        assert ctx.span_id == b
        by_id = {s[5]: s for s in
                 _spans_by_trace([ctx.trace_id])[ctx.trace_id]}
        assert by_id[a][6] == 0                  # first parents the root
        assert by_id[b][6] == a                  # linear causality chain

    def test_record_root_then_children_never_dangle(self):
        buf = Buffer.from_arrays([np.zeros(4, np.float32)])
        ctx = obs_ctx.stamp(buf)
        obs_spans.record_root("src", ctx)
        obs_spans.record_span("hop", "element", time.time_ns(), 5, ctx)
        _assert_tree(_spans_by_trace([ctx.trace_id])[ctx.trace_id])

    def test_disabled_records_nothing_and_returns_zero(self):
        ctx = obs_ctx.TraceContext(obs_ctx.next_id(), 0, time.time_ns())
        obs_spans.set_enabled(False)
        try:
            assert obs_spans.record_span(
                "x", "element", time.time_ns(), 1, ctx) == 0
            assert obs_spans.record_root("x", ctx) == 0
        finally:
            obs_spans.set_enabled(True)
        assert _spans_by_trace([ctx.trace_id])[ctx.trace_id] == []

    def test_ring_is_bounded(self):
        ctx = obs_ctx.TraceContext(obs_ctx.next_id(), 0, time.time_ns())
        for _ in range(obs_spans.RING_SPANS + 100):
            obs_spans.record_span("x", "element", 0, 1, ctx)
        mine = _spans_by_trace([ctx.trace_id])[ctx.trace_id]
        assert len(mine) <= obs_spans.RING_SPANS

    def test_snapshot_names_threads(self):
        seen = {}

        def work():
            obs_spans.record_span("t", "element", time.time_ns(), 1)
            seen["tid"] = threading.get_ident()

        t = threading.Thread(target=work, name="obs-test-thread")
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        assert obs_spans.thread_names().get(seen["tid"]) \
            == "obs-test-thread"


class TestPipelineSpans:
    def test_frame_tree_is_connected_and_settles_e2e(self):
        obs_metrics.reset()
        p = pt.parse_launch(
            f'tensortestsrc name=src caps="{CAPS4}" num-buffers=6 '
            '! queue name=q max-size-buffers=4 '
            '! tensor_transform name=tr mode=arithmetic option=add:1 '
            '! appsink name=out')
        p.fuse = False
        p.run(timeout=60)
        bufs = p["out"].buffers
        assert len(bufs) == 6
        traces = [obs_ctx.ctx_of(b).trace_id for b in bufs]
        assert len(set(traces)) == 6             # one trace per frame
        grouped = _spans_by_trace(traces)
        for tid in traces:
            spans = grouped[tid]
            _assert_tree(spans)
            assert {"src", "q", "tr", "out"} <= {s[0] for s in spans}
            assert {"source", "queue", "element"} <= {s[1] for s in spans}
        # the terminal sink fed the e2e histogram with attribution
        samples = obs_metrics.parse(obs_metrics.render())
        count = sum(v for (n, lab), v in samples.items()
                    if n == "nns_e2e_latency_seconds_count"
                    and dict(lab).get("sink") == "out")
        assert count == 6
        qsum = sum(v for (n, lab), v in samples.items()
                   if n == "nns_e2e_queue_seconds_total"
                   and dict(lab).get("sink") == "out")
        assert qsum >= 0.0

    def test_strips_meta_element_inherits_chain_thread_context(self):
        # tensor_aggregator mints fresh output buffers (STRIPS_META):
        # its downstream spans must still join the frame tree via
        # same-thread inheritance instead of detaching
        p = pt.parse_launch(
            f'tensortestsrc name=src caps="{CAPS4}" num-buffers=4 '
            '! tensor_aggregator name=agg frames-out=2 '
            '! appsink name=out')
        p.fuse = False
        p.run(timeout=60)
        bufs = p["out"].buffers
        assert len(bufs) == 2
        for b in bufs:
            ctx = obs_ctx.ctx_of(b)
            assert ctx is not None
            spans = _spans_by_trace([ctx.trace_id])[ctx.trace_id]
            _assert_tree(spans)
            assert {"agg", "out"} <= {s[0] for s in spans}

    def test_in_flight_window_records_dispatch_and_complete(self):
        # the reference's overlap spans (elements/overlap.py): one
        # dispatch and one complete span per frame, in the frame's tree
        p = pt.parse_launch(
            f'tensortestsrc name=src caps="{CAPS4}" num-buffers=6 '
            '! queue name=q ! tensor_filter name=f framework=simlink '
            'custom=rtt:2,svc:1 in-flight=3 ! appsink name=out')
        p.fuse = False
        p.run(timeout=60)
        bufs = p["out"].buffers
        assert len(bufs) == 6
        traces = [obs_ctx.ctx_of(b).trace_id for b in bufs]
        grouped = _spans_by_trace(traces)
        for tid in traces:
            spans = grouped[tid]
            _assert_tree(spans)
            names = [s[0] for s in spans]
            assert names.count("f:dispatch") == 1
            assert names.count("f:complete") == 1
            assert {"dispatch", "complete"} <= {s[1] for s in spans}

    def test_disabled_spans_leave_no_context(self):
        obs_spans.set_enabled(False)
        try:
            p = pt.parse_launch(
                f'tensortestsrc caps="{CAPS4}" num-buffers=2 '
                '! queue ! appsink name=out')
            p.run(timeout=60)
        finally:
            obs_spans.set_enabled(True)
        for b in p["out"].buffers:
            assert obs_ctx.ctx_of(b) is None
            assert obs_ctx.QT_KEY not in b.extras


# ------------------------------------------------------ flight recorder

class TestFlightRecorder:
    def test_events_emit_counts_and_window(self):
        RECORDER.clear()
        obs_events.emit("breaker", source="f0", state="open")
        obs_events.emit("shed", source="srv", reason="deadline")
        obs_events.emit("shed", source="srv", reason="admission")
        assert RECORDER.event_counts() == {"breaker": 1, "shed": 2}
        evs = RECORDER.events(window_s=60)
        assert [(e[1], e[2]) for e in evs] == \
            [("breaker", "f0"), ("shed", "srv"), ("shed", "srv")]
        assert evs[0][3] == {"state": "open"}
        RECORDER.clear()
        assert RECORDER.event_counts() == {}

    def test_emit_can_post_bus_message(self):
        p = pt.parse_launch(
            f'tensortestsrc caps="{CAPS4}" num-buffers=1 '
            '! appsink name=out')
        p.run(timeout=30)
        p.bus.drain()
        obs_events.emit("drain", element=p["out"], bus="drain", left=3)
        msgs = [(m.kind, m.data) for m in p.bus.drain()]
        assert ("drain", {"source": "out", "left": 3}) in msgs

    def test_dump_is_valid_chrome_trace(self, tmp_path):
        RECORDER.clear()
        buf = Buffer.from_arrays([np.zeros(4, np.float32)])
        ctx = obs_ctx.stamp(buf)
        obs_spans.record_root("src", ctx)
        obs_spans.record_span("hop", "element", time.time_ns(), 7, ctx)
        obs_events.emit("preempt", source="pipe", grace_s=1.0)
        path = tmp_path / "flight.json"
        doc = RECORDER.dump(str(path))
        with open(path) as f:
            assert json.load(f) == doc           # file == returned doc
        evs = doc["traceEvents"]
        assert all(e["ph"] in ("M", "X", "i") for e in evs)
        assert any(e["ph"] == "M" and e["name"] == "process_name"
                   for e in evs)
        mine = [e for e in evs if e["ph"] == "X"
                and e["args"]["trace"] == f"{ctx.trace_id:x}"]
        assert {e["name"] for e in mine} == {"src", "hop"}
        ids = {e["args"]["span"] for e in mine}
        for e in mine:                           # re-linkable tree
            assert e["args"]["parent"] == "0" or \
                e["args"]["parent"] in ids
        inst = [e for e in evs if e["ph"] == "i"]
        assert any(e["name"] == "preempt" for e in inst)

    def test_abort_dump_is_rate_limited_but_preempt_forces(self):
        RECORDER._last_abort_dump = 0.0
        first = RECORDER.dump_abort("crash")
        assert first is not None and os.path.exists(first)
        assert RECORDER.dump_abort("crash") is None     # limited
        forced = RECORDER.dump_abort("preempt", force=True)
        assert forced is not None and forced != first
        RECORDER._last_abort_dump = 0.0

    def test_empty_flight_dir_disables_auto_dumps(self, monkeypatch):
        monkeypatch.setenv("NNS_TPU_FLIGHT_DIR", "")
        RECORDER._last_abort_dump = 0.0
        assert RECORDER.dump_abort("crash", force=True) is None

    def test_pipeline_abort_triggers_black_box_dump(self, flight_dir):
        RECORDER.clear()
        RECORDER._last_abort_dump = 0.0
        p = pt.parse_launch(
            f'tensortestsrc caps="{CAPS4}" num-buffers=4 '
            '! tensor_fault mode=raise every=2 ! appsink name=out')
        p.start()
        assert _wait(lambda: p._error is not None, timeout=15)
        p.stop()
        dumps = list(flight_dir.glob("flight-*-abort-*.json"))
        assert len(dumps) == 1
        assert RECORDER.event_counts().get("abort", 0) >= 1
        with open(dumps[0]) as f:
            assert "traceEvents" in json.load(f)
        RECORDER._last_abort_dump = 0.0

    def test_preempt_dumps_past_the_rate_limit(self, flight_dir, tmp_path):
        # an abort dump was just written: the preempt's dump is forced
        RECORDER._last_abort_dump = time.monotonic()
        p = pt.parse_launch(
            f'tensortestsrc caps="{CAPS4}" num-buffers=3 '
            '! queue ! appsink name=out')
        p.start()
        assert _wait(lambda: len(p["out"].buffers) == 3)
        report = p.preempt(1.0, str(tmp_path / "snap"))
        assert report["snapshot"]
        dumps = list(flight_dir.glob("flight-*-preempt-*.json"))
        assert len(dumps) == 1
        with open(dumps[0]) as f:
            doc = json.load(f)
        assert doc["otherData"]["reason"].endswith("-preempt")
        assert any(e["ph"] == "i" and e["name"] == "preempt"
                   for e in doc["traceEvents"])
        RECORDER._last_abort_dump = 0.0


# ------------------------------------------------------ metrics plane

class _Stats:
    def __init__(self, d):
        self._d = d

    def snapshot(self):
        return dict(self._d)


class _El:
    def __init__(self, name, pipeline, counters):
        self.name = name
        self.pipeline = pipeline
        self.stats = _Stats(counters)


class _Pipe:
    tracer = None

    def __init__(self, name):
        self.name = name
        self.elements = {}


class _Sched:
    name = "serve-src"

    def occupancy(self):
        return {"depth": 3, "streams": 2, "occupancy_avg": 1.5}

    def report(self):
        return {"queue_delay_us": {"p50": 120.5, "p95": 900.0},
                "batch_latency_us": {"p50": 2000.0, "p95": 4100.25}}


class _Pool:
    def stats_dict(self):
        return {"blocks_free": 10, "blocks_used": 5, "blocks_cached": 2,
                "prefix_hit_ratio": 0.25, "prefix_evictions": 7}


class _Auto:
    name = "auto"

    def replicas(self):
        return {"r1": "serving", "r2": "draining"}

    def lifecycle(self):
        return {"replicas_spawned": 3, "replicas_serving": 1,
                "replicas_draining": 1, "replicas_retired": 1,
                "replicas_resurrecting": 0}


HOSTILE = 'a"b\\c\nd'


def _synthetic_render(pkg_metrics, recorder, events, ctx_cls, scheduler,
                      kvpool, autoscaler, monkeypatch):
    """One package's render() over the same synthetic state: its own
    registries replaced by fresh ones holding fakes."""
    monkeypatch.setattr(pkg_metrics, "_e2e", {})
    monkeypatch.setattr(pkg_metrics, "_pipelines", weakref.WeakSet())
    monkeypatch.setattr(scheduler, "SERVE_TABLE", {91: _Sched()})
    pool = _Pool()
    monkeypatch.setattr(kvpool, "POOL_TABLE", {"llm": pool})
    auto = _Auto()
    monkeypatch.setattr(autoscaler, "_LIVE", weakref.WeakSet([auto]))
    monkeypatch.setattr(recorder, "_events",
                        type(recorder._events)(maxlen=16))
    pipe = _Pipe(HOSTILE)
    for name, counters in (
            ("src", {"buffers": 6, "bytes": 96, "proctime_ns": 1234}),
            ("f", {"buffers": 6, "jit_recompiles": 0, "flag": True,
                   "wire_delta_keyframes": 2, "note": "x"}),
            ("out", {"buffers": 6})):
        pipe.elements[name] = _El(name, pipe, counters)
    pkg_metrics.register_pipeline(pipe)
    sink = pipe.elements["out"]
    for i, lat_ns in enumerate((300_000, 2_000_000, 40_000_000,
                                7_000_000_000, 20_000_000_000)):
        ctx = ctx_cls(1, 0, 1_000_000_000, q_ns=1000 * i, c_ns=7 * i,
                      w_ns=3)
        pkg_metrics.observe_e2e(sink, ctx, 1_000_000_000 + lat_ns)
    for kind in ("shed", "shed", "breaker", "abort"):
        events.emit(kind, source="s", level=10)
    text = pkg_metrics.render()
    return text, (pipe, pool, auto)


class TestMetrics:
    def test_render_parse_round_trip_with_hostile_labels(self):
        text = ('nns_test_metric{pipeline="a\\"b\\\\c"} 4.5\n'
                'nns_other 2\n# a comment\nbroken line\n')
        samples = obs_metrics.parse(text)
        assert samples[("nns_test_metric",
                        (("pipeline", 'a"b\\c'),))] == 4.5
        assert samples[("nns_other", ())] == 2.0
        assert samples == nt_metrics.parse(text)

    def test_render_is_byte_equal_to_the_reference(self, monkeypatch):
        """Tolerance: none; the same synthetic state renders the same
        bytes in both packages, every section present."""
        from nnstreamer_tpu.filters import kvpool as nt_kvpool
        from nnstreamer_tpu.fleet import autoscaler as nt_auto
        from nnstreamer_tpu.obs import context as nt_ctx
        from nnstreamer_tpu.serve import scheduler as nt_sched
        from nnstreamer_tpu_torch.filters import kvpool as pt_kvpool
        from nnstreamer_tpu_torch.fleet import autoscaler as pt_auto
        from nnstreamer_tpu_torch.serve import scheduler as pt_sched
        ours, keep1 = _synthetic_render(
            obs_metrics, RECORDER, obs_events, obs_ctx.TraceContext,
            pt_sched, pt_kvpool, pt_auto, monkeypatch)
        theirs, keep2 = _synthetic_render(
            nt_metrics, NT_RECORDER, nt_events, nt_ctx.TraceContext,
            nt_sched, nt_kvpool, nt_auto, monkeypatch)
        assert ours == theirs
        names = {n for (n, _lab) in obs_metrics.parse(ours)}
        assert {"nns_e2e_latency_seconds_bucket",
                "nns_e2e_queue_seconds_total", "nns_element_counter_total",
                "nns_jit_recompiles_total", "nns_serve_depth",
                "nns_serve_queue_delay_us", "nns_kv_blocks_free",
                "nns_kv_prefix_hit_ratio", "nns_delta_keyframes",
                "nns_fleet_replicas", "nns_fleet_lifecycle_total",
                "nns_events_total"} <= names
        # parse(render()) reads the hostile pipeline label back, the
        # same way in both packages
        back = obs_metrics.parse(ours)
        assert back == nt_metrics.parse(theirs)
        labels = {dict(lab).get("pipeline") for (n, lab) in back
                  if n == "nns_element_counter_total"}
        assert labels == {HOSTILE.replace("\n", "\\n")}
        assert back[("nns_e2e_latency_seconds_count",
                     (("pipeline", HOSTILE.replace("\n", "\\n")),
                      ("sink", "out")))] == 5.0
        del keep1, keep2

    def test_render_covers_all_sections(self):
        obs_metrics.reset()
        RECORDER.clear()
        obs_events.emit("failover", source="rt")
        p = pt.parse_launch(
            f'tensortestsrc name=src caps="{CAPS4}" num-buffers=3 '
            '! appsink name=out')
        tracer = p.enable_tracing()
        p.fuse = False
        p.start()
        try:
            assert _wait(lambda: len(p["out"].buffers) >= 3)
            # scrape while the pipeline is still registered (stop()
            # unregisters it from the exposition)
            samples = obs_metrics.parse(obs_metrics.render())
            names = {n for (n, _lab) in samples}
            assert {"nns_e2e_latency_seconds_bucket",
                    "nns_e2e_latency_seconds_count",
                    "nns_e2e_queue_seconds_total",
                    "nns_e2e_compute_seconds_total",
                    "nns_e2e_wire_seconds_total",
                    "nns_element_counter_total",
                    "nns_events_total", "nns_trace"} <= names
            assert tracer is p.tracer
            got = sum(v for (n, lab), v in samples.items()
                      if n == "nns_element_counter_total"
                      and dict(lab).get("element") == "out"
                      and dict(lab).get("counter") == "buffers")
            assert got == 3
        finally:
            p.stop()
        after = obs_metrics.parse(obs_metrics.render())
        assert not any(n == "nns_element_counter_total"
                       and dict(lab).get("pipeline") == p.name
                       and dict(lab).get("element") == "out"
                       for (n, lab) in after)

    def test_serve_scheduler_series_scraped_mid_run(self):
        obs_metrics.reset()
        port = _free_port()
        server = pt.parse_launch(
            f'tensor_serve_src name=src port={port} id=91 buckets=1,2,4 '
            'max-wait-ms=2 '
            f'! tensor_filter framework=torch-cuda accelerator=true:cpu '
            f'model={MLP} ! tensor_serve_sink id=91')
        server.start()
        client = pt.parse_launch(
            f'appsrc name=in caps="{CAPS64}" '
            f'! tensor_query_client name=qc port={port} timeout=15 '
            'max-request=8 ! appsink name=out')
        client.start()
        try:
            for i in range(8):
                client["in"].push_buffer(Buffer.from_arrays(
                    [np.full(64, float(i), np.float32)]))
            assert _wait(lambda: len(client["out"].buffers)
                         + client["qc"].stats["shed"] >= 8)
            samples = obs_metrics.parse(obs_metrics.render())
            names = {n for (n, _l) in samples}
            assert {"nns_serve_depth", "nns_serve_streams",
                    "nns_serve_occupancy_avg"} <= names
            assert any(n == "nns_serve_queue_delay_us"
                       and dict(lab).get("quantile") == "p50"
                       for (n, lab) in samples)
        finally:
            client["in"].end_stream()
            client.stop()
            server.stop()

    def test_kv_pools_register_weakly(self):
        from nnstreamer_tpu_torch.filters.kvpool import (POOL_TABLE,
                                                         KVBlockPool)
        a = KVBlockPool(4, 2, name="obs-pool")
        b = KVBlockPool(4, 2, name="obs-pool")
        assert (a.name, b.name) == ("obs-pool", "obs-pool-2")
        text = obs_metrics.render()
        assert 'nns_kv_blocks_free{pool="obs-pool-2"} 4' in text
        del a, b
        assert "obs-pool" not in POOL_TABLE

    def test_edge_pipeline_attributes_wire_time(self):
        obs_metrics.reset()
        port = _free_port()
        pub = pt.parse_launch(
            f'appsrc name=in caps="{CAPS4}" '
            f'! edgesink name=p port={port} topic=t')
        pub.start()
        sub = pt.parse_launch(
            f'edgesrc name=s dest-port={port} topic=t timeout=15 '
            '! appsink name=out')
        sub.start()
        time.sleep(0.3)
        try:
            for i in range(4):
                pub["in"].push_buffer(Buffer.from_arrays(
                    [np.full(4, float(i), np.float32)]))
            assert _wait(lambda: len(sub["out"].buffers) >= 4, 15)
            pub["in"].end_stream()
            sub.wait_eos(timeout=15)
        finally:
            sub.stop()
            pub.stop()
        bufs = sub["out"].buffers
        traces = [obs_ctx.ctx_of(b).trace_id for b in bufs]
        assert len(set(traces)) == 4
        grouped = _spans_by_trace(traces)
        for tid in traces:
            _assert_tree(grouped[tid])
            assert any(s[1] == "wire" for s in grouped[tid])
        samples = obs_metrics.parse(obs_metrics.render())
        wsum = sum(v for (n, lab), v in samples.items()
                   if n == "nns_e2e_wire_seconds_total"
                   and dict(lab).get("sink") == "out")
        assert wsum > 0.0


class TestMetricsServer:
    def test_routes(self):
        srv = MetricsServer(port=0).start()
        try:
            body = scrape("localhost", srv.bound_port)
            assert obs_metrics.parse(body) is not None
            assert scrape("localhost", srv.bound_port,
                          path="/healthz") == "ok\n"
            doc = json.loads(scrape("localhost", srv.bound_port,
                                    path="/flight"))
            assert "traceEvents" in doc
            with pytest.raises(ConnectionError):
                scrape("localhost", srv.bound_port, path="/nope")
            assert srv.scrapes == 4
        finally:
            srv.stop()

    def test_stop_ends_the_scrape_thread(self):
        """``stop`` wakes the accept the scrape thread blocks in: the
        thread has ended when ``stop`` returns (the reference's bare
        close leaves it blocked and waits out a 5 s join)."""
        srv = MetricsServer(port=0).start()
        thread = srv._thread
        assert scrape("localhost", srv.bound_port, path="/healthz") == "ok\n"
        srv.stop()
        assert not thread.is_alive()

    @pytest.mark.parametrize("reader", ["jax_reads_port", "port_reads_jax"])
    def test_either_package_scrapes_the_other(self, reader):
        obs_metrics.reset()
        nt_metrics.reset()
        RECORDER.clear()
        NT_RECORDER.clear()
        if reader == "jax_reads_port":
            obs_events.emit("shed", source="x", level=10)
            srv, read = MetricsServer(port=0).start(), nt_server.scrape
            local = obs_metrics
        else:
            nt_events.emit("shed", source="x", level=10)
            srv, read = nt_server.MetricsServer(port=0).start(), scrape
            local = nt_metrics
        try:
            body = read("localhost", srv.bound_port)
            got = obs_metrics.parse(body)
            assert got == nt_metrics.parse(body)
            assert got[("nns_events_total", (("kind", "shed"),))] == 1.0
            # what came over the socket is what the endpoint renders
            want = local.parse(local.render())
            assert {k for k in got if k[0] == "nns_events_total"} == \
                {k for k in want if k[0] == "nns_events_total"}
            doc = json.loads(read("localhost", srv.bound_port,
                                  path="/flight"))
            assert "traceEvents" in doc
        finally:
            srv.stop()

    def test_broker_registration_discovers_endpoint(self):
        from nnstreamer_tpu_torch import obs
        from nnstreamer_tpu_torch.edge.broker import (DiscoveryBroker,
                                                      discover_meta)
        broker = DiscoveryBroker(port=0)
        broker.start()
        srv = None
        try:
            srv = obs.serve_metrics(
                broker=("localhost", broker.bound_port),
                labels={"zone": "z1"})
            eps = discover_meta("localhost", broker.bound_port, "obs")
            assert [(h, p, m.get("role"), m.get("zone"))
                    for (h, p), m in eps] == \
                [("127.0.0.1", srv.bound_port, "obs", "z1")]
        finally:
            if srv is not None:
                srv.stop()
            broker.stop()

    def test_top_renders_one_row_per_endpoint(self, capsys):
        srv = MetricsServer(port=0).start()
        jsrv = nt_server.MetricsServer(port=0).start()
        try:
            rc = obs_top.main(
                ["--targets", f"localhost:{srv.bound_port},"
                 f"localhost:{jsrv.bound_port}", "--json"])
            assert rc == 0
            rows = json.loads(capsys.readouterr().out)
            assert [r["endpoint"] for r in rows] == \
                [f"localhost:{srv.bound_port}",
                 f"localhost:{jsrv.bound_port}"]
            # unreachable targets degrade to a row, not a crash
            rc = obs_top.main(
                ["--targets", f"localhost:{_free_port()}", "--json"])
            assert rc == 0
            rows = json.loads(capsys.readouterr().out)
            assert "unreachable" in str(rows[0]["events"])
            assert obs_top.main(["--json"]) == 2     # no targets at all
        finally:
            srv.stop()
            jsrv.stop()

    def test_top_discovers_over_the_broker(self, capsys):
        from nnstreamer_tpu_torch import obs
        from nnstreamer_tpu_torch.edge.broker import DiscoveryBroker
        broker = DiscoveryBroker(port=0)
        broker.start()
        srv = None
        try:
            srv = obs.serve_metrics(broker=("localhost", broker.bound_port))
            rc = obs_top.main(["--broker", f"localhost:{broker.bound_port}",
                               "--json"])
            assert rc == 0
            rows = json.loads(capsys.readouterr().out)
            assert [r["endpoint"] for r in rows] == \
                [f"127.0.0.1:{srv.bound_port}"]
        finally:
            if srv is not None:
                srv.stop()
            broker.stop()

    def test_top_table_formats(self):
        rows = [{"endpoint": "a:1", "depth": 1.0, "fps": float("nan")}]
        table = obs_top.render_table(rows)
        lines = table.splitlines()
        assert lines[0].startswith("ENDPOINT")
        assert "a:1" in lines[1]
        from nnstreamer_tpu.obs import top as nt_top
        assert table == nt_top.render_table(rows)


# ------------------------------------------ the dump's schema, per field

def _dump_schema(pkg, recorder, events, line):
    """Run ``line`` unfused in ``pkg`` and dump its recorder: each sink
    frame's spans as sorted (name, cat, event keys, args keys), plus the
    keys of the metadata and instant events."""
    recorder.clear()
    events.emit("shed", source="srv", level=10, reason="deadline")
    p = pkg.parse_launch(line)
    p.fuse = False
    p.run(timeout=60)
    doc = recorder.dump(window_s=600)
    traces = {f"{b.extras['_obs_ctx'].trace_id:x}"
              for b in p["out"].buffers}
    frames = []
    for t in sorted(traces):
        frames.append(sorted(
            (e["name"], e["cat"], tuple(sorted(e)),
             tuple(sorted(e["args"])))
            for e in doc["traceEvents"]
            if e["ph"] == "X" and e["args"]["trace"] == t))
    meta = sorted({(e["name"], tuple(sorted(e)), tuple(sorted(e["args"])))
                   for e in doc["traceEvents"] if e["ph"] == "M"})
    inst = sorted((e["name"], e["cat"], tuple(sorted(e)),
                   tuple(sorted(e["args"].items())))
                  for e in doc["traceEvents"] if e["ph"] == "i")
    return sorted(frames), meta, inst, sorted(doc), sorted(doc["otherData"])


def test_dump_schema_equals_the_reference_field_by_field():
    """Tolerance: none on the schema; times, ids and tids differ."""
    from nnstreamer_tpu.obs import events as nt_ev
    line = (f'tensortestsrc name=src caps="{CAPS4}" num-buffers=4 '
            '! queue name=q ! tensor_transform name=tr mode=arithmetic '
            'option=add:1 ! appsink name=out')
    ours = _dump_schema(pt, RECORDER, obs_events, line)
    theirs = _dump_schema(nt, NT_RECORDER, nt_ev, line)
    assert len(ours[0]) == 4
    assert ours[0][0] == sorted(
        [("out", "element", ("args", "cat", "dur", "name", "ph", "pid",
                             "tid", "ts"), ("parent", "span", "trace")),
         ("q", "queue", ("args", "cat", "dur", "name", "ph", "pid", "tid",
                         "ts"), ("parent", "span", "trace")),
         ("src", "source", ("args", "cat", "dur", "name", "ph", "pid",
                            "tid", "ts"), ("parent", "span", "trace")),
         ("tr", "element", ("args", "cat", "dur", "name", "ph", "pid",
                            "tid", "ts"), ("parent", "span", "trace"))])
    assert ours == theirs


# -------------------------------------- cross-process span tree merge

_CHILD = r"""
import json, os, sys
from nnstreamer_tpu_torch import parse_launch
from nnstreamer_tpu_torch.obs.recorder import RECORDER

desc, dump_path = sys.argv[1], sys.argv[2]
p = parse_launch(desc)
p.start()
port = 0
for name in ("src", "rt"):
    el = p.elements.get(name)
    if el is not None and getattr(el, "bound_port", 0):
        port = el.bound_port
print(json.dumps({"ready": True, "port": port, "pid": os.getpid(),
                  "jax": "jax" in sys.modules}), flush=True)
sys.stdin.readline()                      # parent: dump and exit
p.stop()
RECORDER.dump(dump_path, window_s=600)
print("dumped", flush=True)
"""


def _spawn_child(desc, dump_path):
    env = dict(os.environ, PYTHONPATH=REPO, NNS_TPU_FLIGHT_DIR="")
    proc = subprocess.Popen(
        [sys.executable, "-c", _CHILD, desc, str(dump_path)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
    line = proc.stdout.readline()
    try:
        info = json.loads(line)
    except json.JSONDecodeError:
        proc.kill()
        raise AssertionError(
            f"child failed to start: {line!r}\n{proc.stderr.read()}")
    return proc, info


def _dump_child(proc):
    proc.stdin.write("dump\n")
    proc.stdin.flush()
    assert proc.stdout.readline().strip() == "dumped", proc.stderr.read()
    proc.wait(timeout=30)


def _assert_cross_process_tree(events, trace_hex, min_pids):
    mine = [e for e in events if e["ph"] == "X"
            and e.get("args", {}).get("trace") == trace_hex]
    assert mine, f"no spans for trace {trace_hex}"
    pids = {e["pid"] for e in mine}
    assert len(pids) >= min_pids, \
        f"trace {trace_hex} spans only pids {pids}"
    ids = {e["args"]["span"] for e in mine}
    roots = [e for e in mine if e["args"]["parent"] == "0"]
    assert len(roots) == 1, f"want one root, got {len(roots)}"
    for e in mine:
        assert e["args"]["parent"] == "0" or e["args"]["parent"] in ids, \
            f"orphan span {e}"
    return mine


class TestCrossProcessSpanTree:
    def test_client_to_replica_two_process_tree(self, tmp_path):
        """The light arm: a client frame served by a port replica child
        process comes back with a context whose merged span tree
        (parent dump + child dump) is one connected tree across two
        pids."""
        RECORDER.clear()
        dump = tmp_path / "replica.json"
        proc, info = _spawn_child(
            "tensor_serve_src name=src port=0 id=93 buckets=1,2,4 "
            "max-wait-ms=2 "
            "! tensor_filter framework=torch-cuda accelerator=true:cpu "
            f"model={MLP} ! tensor_serve_sink id=93", dump)
        assert info["jax"] is False
        client = None
        try:
            client = pt.parse_launch(
                f'appsrc name=in caps="{CAPS64}" '
                f'! tensor_query_client name=qc port={info["port"]} '
                'timeout=15 max-request=8 ! appsink name=out')
            client.start()
            for i in range(6):
                client["in"].push_buffer(Buffer.from_arrays(
                    [np.full(64, float(i), np.float32)]))
            assert _wait(lambda: len(client["out"].buffers) >= 6)
            ctxs = [obs_ctx.ctx_of(b) for b in client["out"].buffers]
            assert all(c is not None for c in ctxs)
            _dump_child(proc)
            client["in"].end_stream()
            client.stop()
            client = None
            with open(dump) as f:
                child_doc = json.load(f)
            events = RECORDER.dump(window_s=600)["traceEvents"] \
                + child_doc["traceEvents"]
            for ctx in ctxs:
                mine = _assert_cross_process_tree(
                    events, f"{ctx.trace_id:x}", min_pids=2)
                assert "wire" in {e["cat"] for e in mine}
                assert {e["cat"] for e in mine
                        if e["pid"] == info["pid"]}, \
                    "no spans recorded in the replica process"
        finally:
            if client is not None:
                client.stop()
            if proc.poll() is None:
                proc.kill()


def test_untraced_link_is_byte_identical():
    """The trace field rides only on links that negotiated it."""
    ctx = obs_ctx.TraceContext(obs_ctx.next_id(), 5, time.time_ns())
    buf = Buffer.from_arrays([np.full(4, 1.0, np.float32)])
    obs_ctx.attach(buf, ctx)
    meta, _payloads = wire.pack_buffer(buf, wire.WireConfig())
    assert "trace" not in meta
    meta, _payloads = wire.pack_buffer(buf, wire.WireConfig(trace=True))
    assert meta["trace"][0] == ctx.trace_id
