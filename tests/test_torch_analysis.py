"""The port's pipelint (nnstreamer_tpu_torch/analysis/) against the JAX
package's, on the CPU.

Mirrors the tests/test_analysis.py cases of the seventeen rules the port
has (``TestRules``), ``TestStartGate``, ``TestReport`` and
``TestTraceExportRule``, and tests/test_fusion.py's ``TestLintRules``.
Each description is parsed by both packages and analyzed without
starting anything; findings compare as sets of (rule id, element, pad,
severity), after the JAX report drops the ids of the rules the port
defers (``DEFERRED``, pinned below: the reference's ids minus exactly
that list are the port's; ROADMAP.md names the item that brings each). Where the reference tests use a
``framework=jax model=zoo://mlp`` filter, these use ``framework=simlink``,
which both packages carry; where the reference uses a serve src for an
unbounded upstream, a ``format=flexible`` source stands in (the serve
rules' own cases are in tests/test_torch_serve.py and
tests/test_torch_router.py).

Every intentionally defective description is tagged ``# pipelint: skip``
as in the reference tests.
"""
import json

import pytest

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as pt
from nnstreamer_tpu.analysis import ALL_RULES as NT_RULES
from nnstreamer_tpu.analysis import analyze as nt_analyze
from nnstreamer_tpu.pipeline.element import Element as NtElement
from nnstreamer_tpu.pipeline.element import \
    TransformElement as NtTransformElement
from nnstreamer_tpu.pipeline.pipeline import Pipeline as NtPipeline
from nnstreamer_tpu.tensors.caps import Caps as NtCaps
from nnstreamer_tpu_torch.analysis import (ALL_RULES,
                                           PipelineValidationError, Report,
                                           Rule, Severity, analyze)
from nnstreamer_tpu_torch.analysis import cli
from nnstreamer_tpu_torch.pipeline.element import Element, TransformElement
from nnstreamer_tpu_torch.pipeline.pipeline import Pipeline
from nnstreamer_tpu_torch.tensors.caps import Caps

CAPS_U8 = ("other/tensors,format=static,num_tensors=1,"
           "types=(string)uint8,dimensions=(string)3:4:4,"
           "framerate=(fraction)0/1")
CAPS_F32 = ("other/tensors,format=static,num_tensors=1,"
            "types=(string)float32,dimensions=(string)3:4:4,"
            "framerate=(fraction)0/1")
CAPS_FLEX = "other/tensors,format=flexible,framerate=(fraction)0/1"
FILTER = "tensor_filter name=f framework=simlink"

# every rule of the reference is ported: none is left out of the
# comparisons
DEFERRED: set = set()


def _keys(report):
    return {(f.rule, f.element, f.pad, f.severity)
            for f in report.findings if f.rule not in DEFERRED}


def findings_for(desc, rule=None):
    """The port's findings for ``desc``, after checking that the JAX
    package finds the same (rule, element, pad, severity) set. Each
    package names an unnamed element from its own process-wide counter,
    which the test files run before this one in the same process move
    unequally; both counters start from the same value here, so the
    same line gets the same names in both packages."""
    start = max(Element._anon_counter[0], NtElement._anon_counter[0])
    Element._anon_counter[0] = NtElement._anon_counter[0] = start
    report = analyze(pt.parse_launch(desc))
    assert not report.crashed
    NtElement._anon_counter[0] = start
    assert _keys(report) == _keys(nt_analyze(nt.parse_launch(desc)))
    if rule is None:
        return report.findings
    return [f for f in report.findings if f.rule == rule]


def test_rule_ids_are_the_reference_minus_the_deferred():
    assert {r.id for r in ALL_RULES} == {r.id for r in NT_RULES} - DEFERRED
    assert len(ALL_RULES) == 28


class TestCapsInference:
    def test_capsfilter_contradiction_located(self):
        bad = (  # pipelint: skip — u8 stream into a sparse-only filter
            f"tensortestsrc caps={CAPS_U8} ! "
            "other/tensors,format=sparse name=cf ! fakesink")
        got = findings_for(bad, "caps-inference")
        assert [(f.element, f.pad, f.severity) for f in got] == \
            [("cf", "sink", Severity.ERROR)]
        assert "do not satisfy" in got[0].message

    def test_missing_required_caps_prop(self):
        got = findings_for(  # pipelint: skip — testsrc without caps
            "tensortestsrc name=src ! fakesink", "caps-inference")
        assert [(f.element, f.severity) for f in got] == \
            [("src", Severity.ERROR)]

    def test_filter_model_mismatch_located(self):
        bad = (  # pipelint: skip — declared model wants dim 8, stream has 3:4:4
            f"tensortestsrc caps={CAPS_F32} ! "
            f"{FILTER} input=8 inputtype=float32 ! fakesink")
        got = findings_for(bad, "caps-inference")
        assert [(f.element, f.pad, f.severity) for f in got] == \
            [("f", "sink", Severity.ERROR)]


class TestRules:
    def test_dangling_crop_info_pad(self):
        bad = (  # pipelint: skip — crop's info pad left unlinked
            f"tensortestsrc caps={CAPS_U8} ! "
            "tensor_crop name=c ! fakesink")
        got = findings_for(bad, "dangling-pad")
        assert [(f.element, f.pad) for f in got] == [("c", "info")]
        assert got[0].severity is Severity.WARNING

    def test_isolated_element(self):
        bad = (  # pipelint: skip — mux is not linked to anything
            f"tensortestsrc caps={CAPS_U8} ! fakesink "
            "tensor_mux name=lonely")
        got = findings_for(bad, "dangling-pad")
        assert [(f.element, f.message) for f in got] == \
            [("lonely", "element is not linked to anything")]

    def test_cycle_detected_on_both_members(self):
        bad = (  # pipelint: skip — i1 -> i2 -> i1 dataflow loop
            "identity name=i1 ! identity name=i2 ! i1.")
        got = findings_for(bad, "cycle")
        assert sorted(f.element for f in got) == ["i1", "i2"]
        assert all(f.severity is Severity.ERROR for f in got)
        assert "i1 -> i2" in got[0].message

    def test_tee_branch_without_queue(self):
        bad = (  # pipelint: skip — first tee branch has no queue
            f"tensortestsrc caps={CAPS_U8} ! tee name=t ! fakesink "
            "t. ! queue ! fakesink")
        got = findings_for(bad, "tee-no-queue")
        assert [(f.element, f.pad) for f in got] == [("t", "src_0")]

    def test_jit_signatures_unbounded_upstream(self):
        bad = (  # pipelint: skip — flexible stream, no batch bound
            f"tensortestsrc caps={CAPS_FLEX} ! {FILTER} ! fakesink")
        got = findings_for(bad, "jit-signatures")
        assert [(f.element, f.pad, f.severity) for f in got] == \
            [("f", "sink", Severity.WARNING)]
        assert "unbounded" in got[0].message

    def test_jit_signatures_static_stream_is_clean(self):
        assert findings_for(f"tensortestsrc caps={CAPS_F32} ! {FILTER} ! "
                            "fakesink", "jit-signatures") == []

    def test_sinkless_pipeline_and_dead_end(self):
        bad = (  # pipelint: skip — no sink anywhere, converter dead-ends
            f"tensortestsrc caps={CAPS_U8} ! tensor_converter name=conv")
        got = findings_for(bad, "sinkless-branch")
        assert {f.element for f in got} == {None, "conv"}
        assert all(f.severity is Severity.WARNING for f in got)

    def test_combiner_dtype_mismatch_located(self):
        bad = (  # pipelint: skip — uint8 and float32 legs into one merge
            "tensor_merge name=m mode=linear option=0 ! fakesink "
            f"tensortestsrc caps={CAPS_U8} ! m.sink_0 "
            f"tensortestsrc caps={CAPS_F32} ! m.sink_1")
        got = findings_for(bad, "combiner-dtype")
        assert [(f.element, f.pad) for f in got] == [("m", "sink_1")]
        assert got[0].severity is Severity.ERROR

    def test_join_shape_mismatch_located(self):
        bad = (  # pipelint: skip — join legs of two shapes
            "join name=j ! fakesink "
            f"tensortestsrc caps={CAPS_F32} ! j.sink_0 "
            f"tensortestsrc caps={CAPS_F32.replace('3:4:4', '3:4:5')} "
            "! j.sink_1")
        got = findings_for(bad, "combiner-dtype")
        assert [(f.element, f.pad) for f in got] == [("j", "sink_1")]
        assert "join forwards one caps" in got[0].message

    def test_breaker_armed_without_retry_after(self):
        bad = (  # pipelint: skip — armed breaker, no shed pacing hint
            f"tensortestsrc caps={CAPS_F32} ! {FILTER} "
            "breaker-threshold=3 breaker-retry-after-ms=0 ! fakesink")
        got = findings_for(bad, "shed-no-retry-after")
        assert [(f.element, f.severity) for f in got] == \
            [("f", Severity.WARNING)]
        assert "breaker" in got[0].message

    def test_positive_retry_after_is_clean(self):
        desc = (f"tensortestsrc caps={CAPS_F32} ! {FILTER} "
                "breaker-threshold=3 ! fakesink")
        assert findings_for(desc, "shed-no-retry-after") == []

    def test_error_policy_bad_spec_is_error(self):
        bad = (  # pipelint: skip — typo'd on-error spec
            f"tensortestsrc caps={CAPS_U8} ! "
            "identity name=i on_error=explode ! appsink name=out")
        got = findings_for(bad, "error-policy")
        assert [(f.element, f.severity) for f in got] == \
            [("i", Severity.ERROR)]
        assert "explode" in got[0].message

    def test_error_policy_retry_on_sink_warns(self):
        bad = (  # pipelint: skip — retry on a sink re-runs side effects
            f"tensortestsrc caps={CAPS_U8} ! "
            "fakesink name=k on_error=retry(2)")
        got = findings_for(bad, "error-policy")
        assert [(f.element, f.severity) for f in got] == \
            [("k", Severity.WARNING)]
        assert "side effects" in got[0].message

    @pytest.mark.parametrize("stateful", [
        "tensor_aggregator name=agg frames-out=2",
        "tensor_rate name=agg framerate=10/1"])
    def test_error_policy_restart_on_stateful_is_error(self, stateful):
        bad = (  # pipelint: skip — restart discards the element's state
            f"tensortestsrc caps={CAPS_U8} ! {stateful} on_error=restart ! "
            "appsink name=out")
        got = findings_for(bad, "error-policy")
        assert [(f.element, f.severity) for f in got] == \
            [("agg", Severity.ERROR)]
        assert "restart-safe" in got[0].message

    def test_error_policy_valid_specs_are_clean(self):
        desc = (f"tensortestsrc caps={CAPS_U8} on_error=retry(3,0.1) ! "
                "identity on_error=skip ! tensor_fault mode=drop every=9 "
                "on_error=restart ! appsink name=out")
        assert findings_for(desc, "error-policy") == []

    def test_async_window_zero_is_error(self):
        bad = (  # pipelint: skip — a 0-frame window never admits a frame
            f"tensortestsrc caps={CAPS_F32} ! {FILTER} in-flight=0 ! "
            "fakesink")
        got = findings_for(bad, "async-window")
        assert [(f.element, f.severity) for f in got] == \
            [("f", Severity.ERROR)]
        assert "never admit" in got[0].message

    def test_async_window_wide_but_unbucketed_is_clean(self):
        ok = f"tensortestsrc caps={CAPS_F32} ! {FILTER} in-flight=16 ! fakesink"
        assert findings_for(ok, "async-window") == []

    def test_async_window_no_reorder_into_aggregator_warns(self):
        bad = (  # pipelint: skip — unordered completions into a stacker
            f"tensortestsrc caps={CAPS_F32} ! {FILTER} "
            "in-flight=4 reorder=false ! queue ! "
            "tensor_aggregator name=agg frames-out=2 ! fakesink")
        got = findings_for(bad, "async-window")
        assert [(f.element, f.severity) for f in got] == \
            [("f", Severity.WARNING)]
        assert "order-sensitive" in got[0].message and "agg" in got[0].message

    def test_async_window_with_reorder_into_aggregator_is_clean(self):
        ok = (f"tensortestsrc caps={CAPS_F32} ! {FILTER} in-flight=4 ! "
              "queue ! tensor_aggregator frames-out=2 ! fakesink")
        assert findings_for(ok, "async-window") == []


CAPS_U8_FRAME = ("other/tensors,format=static,num_tensors=1,"
                 "types=(string)uint8,dimensions=(string)3:224:224,"
                 "framerate=(fraction)0/1")
CAPS_BF16 = ("other/tensors,format=static,num_tensors=1,"
             "types=(string)bfloat16,dimensions=(string)64:64,"
             "framerate=(fraction)0/1")


class TestAmongDeviceRules:
    """link-resilience, wire-config, session-replay-budget and
    session-no-reconnect: the same findings in both packages (checked by
    ``findings_for``) on the reference's cases."""

    def test_link_resilience(self):
        bad = (  # pipelint: skip — no timeout, no reconnect
            "edgesrc name=e timeout=0 reconnect=false ! fakesink "
            f"tensortestsrc caps={CAPS_F32} ! tensor_query_client name=q "
            "timeout=0 ! fakesink")
        got = findings_for(bad, "link-resilience")
        assert sorted((f.element, f.severity) for f in got) == [
            ("e", Severity.INFO), ("e", Severity.WARNING),
            ("q", Severity.WARNING)]

    def test_wire_config_typos_and_coalescing(self):
        bad = (  # pipelint: skip — typo'd codec/precision, bad coalescing
            f"tensortestsrc caps={CAPS_F32} ! tee name=t "
            "t. ! queue ! tensor_query_client name=q wire-codec=lz4 "
            "wire-precision=fp8 ! fakesink "
            "t. ! queue ! edgesink name=z coalesce-frames=0 "
            "t. ! queue ! edgesink name=w coalesce-frames=4 coalesce-ms=0")
        got = findings_for(bad, "wire-config")
        assert sorted((f.element, f.severity) for f in got) == [
            ("q", Severity.ERROR), ("q", Severity.ERROR),
            ("w", Severity.WARNING), ("z", Severity.ERROR)]

    @pytest.mark.parametrize("k,want", [(0, True), (-1, True), (8, False),
                                        (None, False)])
    def test_delta_no_keyframe_interval(self, k, want):
        desc = (  # pipelint: skip — some lines never rekey on schedule
            f"tensortestsrc caps={CAPS_F32} ! edgesink name=z "
            "wire-codec=delta" + ("" if k is None else f" wire-delta-k={k}"))
        got = findings_for(desc, "delta-no-keyframe-interval")
        assert [(f.element, f.severity) for f in got] == \
            ([("z", Severity.ERROR)] if want else [])
        assert findings_for(
            f"tensortestsrc caps={CAPS_F32} ! edgesink wire-delta-k=0",
            "delta-no-keyframe-interval") == []

    def test_wire_config_accepts_the_reference_codec_names(self):
        ok = (f"tensortestsrc caps={CAPS_F32} ! edgesink "
              "wire-codec=delta wire-precision=bf16")
        assert findings_for(ok, "wire-config") == []

    @pytest.mark.parametrize("caps,ring_kb,frames,want", [
        (CAPS_U8_FRAME, 64, 4, True), (CAPS_U8_FRAME, 8192, 4, False),
        (CAPS_BF16, 16, 4, True), (CAPS_BF16, 32, 4, False),
        (CAPS_FLEX, 1, 4, False)],
        ids=["u8-small", "u8-default", "bf16-small", "bf16-fits", "flex"])
    def test_session_replay_budget(self, caps, ring_kb, frames, want):
        desc = (  # pipelint: skip — some rings are smaller than a batch
            f"tensortestsrc caps={caps} ! edgesink name=z session=true "
            f"session-ring-kb={ring_kb} coalesce-frames={frames}")
        got = findings_for(desc, "session-replay-budget")
        assert [(f.element, f.pad, f.severity) for f in got] == \
            ([("z", "sink", Severity.ERROR)] if want else [])

    def test_session_no_reconnect(self):
        bad = (  # pipelint: skip — a session nothing can resume
            "edgesrc name=e session=true reconnect=false ! fakesink "
            "edgesrc name=ok session=true ! fakesink")
        got = findings_for(bad, "session-no-reconnect")
        assert [(f.element, f.severity) for f in got] == \
            [("e", Severity.WARNING)]

    def test_query_server_batch_bounds_the_signatures(self):
        lines = {
            0: ("tensor_query_serversrc ! " + FILTER +
                " ! tensor_query_serversink"),
            4: ("tensor_query_serversrc batch=4 ! " + FILTER +
                " ! tensor_query_serversink")}
        assert [f.element for f in findings_for(
            lines[0], "jit-signatures")] == ["f"]
        assert findings_for(lines[4], "jit-signatures") == []


CLEAN_CORPUS = [
    # straight converter chain on fixed caps
    f"tensortestsrc caps={CAPS_U8} num-buffers=2 ! "
    "tensor_converter ! appsink name=out",
    # typecast + arithmetic transform chain
    f"tensortestsrc caps={CAPS_U8} ! "
    "tensor_transform mode=typecast option=float32 ! "
    "tensor_transform mode=arithmetic option=mul:2 ! appsink name=out",
    # tee with a queue on every branch
    f"tensortestsrc caps={CAPS_U8} ! tee name=t ! queue ! "
    "appsink name=a t. ! queue ! appsink name=b",
    # mux joining two equal-dtype legs via named pads
    "tensor_mux name=m ! appsink name=out "
    f"tensortestsrc caps={CAPS_U8} ! m.sink_0 "
    f"tensortestsrc caps={CAPS_U8} ! m.sink_1",
    # demux fan-out with per-branch queues
    f"tensortestsrc caps={CAPS_U8} ! tensor_demux name=d tensorpick=0 "
    "d.src_0 ! queue ! appsink name=out",
    # the fault layer's launch lines: policies, breaker, tensor_fault
    f"tensortestsrc caps={CAPS_F32} ! queue ! tensor_fault mode=transient "
    "every=5 on-error=retry(2,0.01) ! tensor_filter framework=simlink "
    "breaker-threshold=2 in-flight=4 on-error=skip ! queue ! "
    "appsink name=out",
    # the among-device lines: a micro-batching query server, a client,
    # and a session pub/sub pair
    "tensor_query_serversrc batch=4 ! tensor_filter framework=simlink ! "
    "queue ! tensor_query_serversink",
    f"tensortestsrc caps={CAPS_F32} ! tensor_query_client "
    "wire-codec=shuffle-zlib ! appsink name=out",
    f"tensortestsrc caps={CAPS_F32} ! edgesink session=true "
    "coalesce-frames=4 wire-codec=shuffle-zlib",
    "edgesrc session=true heartbeat-ms=50 ! appsink name=out",
]


@pytest.mark.parametrize("desc", CLEAN_CORPUS)
def test_clean_corpus_has_no_errors(desc):
    assert [f for f in findings_for(desc)
            if f.severity is Severity.ERROR] == []


REFUSED = {
    "caps": (  # pipelint: skip — intentional caps mismatch
        f"tensortestsrc caps={CAPS_U8} ! "
        "other/tensors,format=sparse name=cf ! fakesink"),
    "policy": (  # pipelint: skip — typo'd on-error spec
        f"tensortestsrc caps={CAPS_U8} ! identity name=i on_error=bogus ! "
        "fakesink"),
    "cycle": (  # pipelint: skip — dataflow loop
        "identity name=i1 ! identity name=i2 ! i1."),
    "window": (  # pipelint: skip — a window that never admits
        f"tensortestsrc caps={CAPS_F32} ! {FILTER} in-flight=0 ! fakesink"),
    "stateful-restart": (  # pipelint: skip — restart of an aggregator
        f"tensortestsrc caps={CAPS_U8} ! tensor_aggregator name=agg "
        "frames-out=2 on_error=restart ! fakesink"),
}


class TestStartGate:
    @pytest.mark.parametrize("case", sorted(REFUSED))
    def test_refuses_what_the_reference_refuses(self, case):
        ids = []
        for pkg in (nt, pt):
            p = pkg.parse_launch(REFUSED[case])
            with pytest.raises(ValueError) as info:
                p.start()
            assert type(info.value).__name__ == "PipelineValidationError"
            assert not p.running
            ids.append(sorted({(f.rule, f.element)
                               for f in info.value.report.errors}))
        assert ids[0] == ids[1]

    def test_start_raises_on_error_findings(self):
        p = pt.parse_launch(REFUSED["caps"])
        with pytest.raises(PipelineValidationError, match="do not satisfy"):
            p.start()
        assert not p.running

    def test_validation_error_names_escape_hatch(self):
        p = pt.parse_launch(REFUSED["caps"])
        with pytest.raises(ValueError, match="validate_on_start"):
            p.start()

    def test_refused_before_any_model_is_opened(self):
        p = pt.parse_launch(  # pipelint: skip — caps contradiction ahead of a model
            f"tensortestsrc caps={CAPS_U8} ! other/tensors,format=sparse ! "
            "tensor_filter name=f framework=torch-cuda accelerator=true:cpu "
            "model=zoo://mobilenet_v2?width=0.35&size=96 ! fakesink")
        with pytest.raises(PipelineValidationError):
            p.start()
        assert p["f"].fw is None and p._fusion_plan is None

    def test_escape_hatch_allows_start(self):
        p = pt.parse_launch(  # pipelint: skip — intentional caps mismatch
            f"tensortestsrc caps={CAPS_U8} num-buffers=1 ! "
            "other/tensors,format=sparse ! fakesink")
        p.validate_on_start = False
        p.start()  # static gate skipped; runtime will reject on its own
        p.stop()

    def test_warnings_do_not_block_start(self):
        p = pt.parse_launch(  # pipelint: skip — tee branch without queue
            f"tensortestsrc caps={CAPS_U8} num-buffers=1 ! tee name=t "
            "! fakesink t. ! queue ! fakesink")
        assert analyze(p).warnings
        p.start()
        p.wait_eos(10)
        p.stop()

    def test_validate_returns_report(self):
        p = pt.parse_launch(f"tensortestsrc caps={CAPS_U8} ! appsink name=o")
        report = p.validate()
        assert isinstance(report, Report)
        assert report.exit_code == 0 and report.crashed == []


class TestReport:
    def test_json_round_trip(self):
        p = pt.parse_launch(  # pipelint: skip — tee branch without queue
            f"tensortestsrc caps={CAPS_U8} ! tee name=t ! fakesink "
            "t. ! queue ! fakesink")
        data = json.loads(analyze(p).to_json())
        assert data["exit_code"] == 1
        assert "tee-no-queue" in {f["rule"] for f in data["findings"]}
        by_loc = {f["location"]: f for f in data["findings"]}
        assert by_loc["t.src_0"]["severity"] == "warning"

    def test_text_orders_errors_first(self):
        p = pt.parse_launch(  # pipelint: skip — cycle + missing queue
            f"tensortestsrc caps={CAPS_U8} ! tee name=t ! fakesink "
            "t. ! queue ! fakesink "
            "identity name=i1 ! identity name=i2 ! i1.")
        text = analyze(p).to_text()
        assert text.index("error") < text.index("warning")

    def test_rule_crash_does_not_block_but_is_recorded(self):
        class Broken(Rule):
            id = "broken"

            def check(self, ctx):
                raise RuntimeError("boom")

        p = pt.parse_launch(f"tensortestsrc caps={CAPS_U8} ! appsink name=o")
        report = analyze(p, rules=[Broken()])
        assert report.findings == []
        assert report.crashed == ["broken"]


class TestTraceExportRule:
    def test_stripper_downstream_of_export_warns_naming_it(self):
        got = findings_for(  # pipelint: skip — aggregator strips the ctx
            f"tensortestsrc name=src caps={CAPS_U8} trace-export=true ! "
            "tensor_aggregator name=agg ! fakesink",
            "trace-export-stripped")
        assert [(f.element, f.severity) for f in got] == \
            [("agg", Severity.WARNING)]
        assert "'src'" in got[0].message and "STRIPS_META" in got[0].message

    def test_only_first_stripper_per_path_is_reported(self):
        got = findings_for(  # pipelint: skip — two strippers in a row
            f"tensortestsrc caps={CAPS_U8} trace-export=true ! "
            "tensor_aggregator name=a1 ! tensor_aggregator name=a2 ! "
            "fakesink", "trace-export-stripped")
        assert [f.element for f in got] == ["a1"]

    @pytest.mark.parametrize("stripper", [
        "tensor_converter name=s", "tensor_decoder name=s mode=direct_video",
        "tensor_mux name=s"])
    def test_every_stripping_kind_is_named(self, stripper):
        got = findings_for(  # pipelint: skip — a stripping element
            f"videotestsrc trace-export=true ! {stripper} ! fakesink",
            "trace-export-stripped")
        assert [f.element for f in got] == ["s"]

    def test_no_export_no_finding(self):
        assert findings_for(f"tensortestsrc caps={CAPS_U8} ! "
                            "tensor_aggregator name=agg ! fakesink",
                            "trace-export-stripped") == []

    def test_export_with_meta_preserving_chain_is_clean(self):
        got = findings_for(
            f"tensortestsrc caps={CAPS_U8} trace-export=true ! queue ! "
            "tensor_transform mode=typecast option=float32 ! fakesink",
            "trace-export-stripped")
        assert got == []

    def test_trace_export_source_runs(self):
        p = pt.parse_launch(f"tensortestsrc caps={CAPS_U8} num-buffers=2 "
                            "trace-export=true ! appsink name=o")
        p.run(timeout=30)
        assert len(p["o"].buffers) == 2


def _lying(base, caps_cls):
    class LyingTransform(base):
        """Declares a device_fn but its static transfer contradicts the
        chain path's transform_caps — the fusion-transfer rule's target."""

        def transform(self, buf):
            return buf

        def transform_caps(self, incaps):
            return incaps

        def static_transfer(self, in_caps):
            return {"src": caps_cls(CAPS_U8).fixate()}

        def device_fn(self, ctx=None):
            return lambda arrays: arrays

    return LyingTransform


class TestLintRules:
    def test_fusion_break_warns_on_single_blocker(self):
        got = findings_for(  # pipelint: skip — deliberate fusion break
            f"tensortestsrc caps={CAPS_F32} ! "
            "tensor_transform name=a mode=arithmetic option=mul:2 ! "
            "identity name=i ! "
            "tensor_transform name=b mode=arithmetic option=add:1 ! "
            "appsink name=out", "fusion-break")
        assert [(f.element, f.severity) for f in got] == \
            [("i", Severity.WARNING)]
        assert "'a'" in got[0].message and "'b'" in got[0].message

    def test_fusible_chain_is_clean(self):
        got = findings_for(
            f"tensortestsrc caps={CAPS_F32} ! "
            "tensor_transform name=a mode=arithmetic option=mul:2 ! "
            "tensor_transform name=b mode=transpose option=1:0:2 ! "
            "appsink name=out")
        assert [f for f in got
                if f.rule in ("fusion-break", "fusion-transfer")] == []

    def test_fusion_transfer_mismatch_is_an_error(self):
        found = []
        for pkg, pipe_cls, base, caps_cls, run in (
                (nt, NtPipeline, NtTransformElement, NtCaps, nt_analyze),
                (pt, Pipeline, TransformElement, Caps, analyze)):
            p = pipe_cls()
            src = pkg.make_element("tensortestsrc", name="src")
            src.set_property("caps", CAPS_F32)
            liar = _lying(base, caps_cls)(name="liar")
            sink = pkg.make_element("appsink", name="out")
            p.add(src, liar, sink)
            p.link(src, liar, sink)
            found.append([(f.element, f.severity) for f in run(p).findings
                          if f.rule == "fusion-transfer"])
        assert found[0] == found[1] == [("liar", Severity.ERROR)]


class TestCli:
    @pytest.mark.parametrize("desc,code", [
        (f"tensortestsrc caps={CAPS_U8} ! appsink name=o", 0),
        (  # pipelint: skip — tee branch without queue
            f"tensortestsrc caps={CAPS_U8} ! tee name=t ! fakesink "
            "t. ! queue ! fakesink", 1),
        (REFUSED["policy"], 2),
        ("tensortestsrc ! no_such_element_xyz", 2)],
        ids=["clean", "warning", "error", "parse-failure"])
    def test_exit_codes(self, desc, code, capsys):
        assert cli.main([desc, "--quiet"]) == code
        assert capsys.readouterr().out == ""

    def test_json_output(self, capsys):
        assert cli.main([REFUSED["policy"], "--json"]) == 2
        data = json.loads(capsys.readouterr().out)
        assert data["exit_code"] == 2
        assert {f["rule"] for f in data["findings"]} == {"error-policy"}

    def test_text_output(self, capsys):
        assert cli.main([REFUSED["cycle"]]) == 2
        assert "pipelint: 2 error(s)" in capsys.readouterr().out


class TestDeltaLossyGateFeedsTrainerRule:
    """tests/test_analysis.py's cases of ``delta-lossy-gate-feeds-trainer``
    (a gated or roi stream into a tensor_trainer warns on the delta;
    mask mode, or no trainer, is clean), findings compared with the JAX
    package's by ``findings_for``."""

    def test_gated_stream_into_trainer_warns(self):
        bad = (  # pipelint: skip — ROI-skipped stream feeding a trainer
            f"tensortestsrc caps={CAPS_F32} ! "
            "tensor_delta name=d mode=gate ! "
            "tensor_trainer name=tr ! fakesink")
        got = findings_for(bad, "delta-lossy-gate-feeds-trainer")
        assert [(f.element, f.severity) for f in got] == \
            [("d", Severity.WARNING)]
        assert "motion-biased" in got[0].message

    def test_roi_mode_into_trainer_warns(self):
        bad = (  # pipelint: skip — roi crops feeding a trainer
            f"tensortestsrc caps={CAPS_F32} ! "
            "tensor_delta name=d mode=roi ! "
            "tensor_trainer name=tr ! fakesink")
        got = findings_for(bad, "delta-lossy-gate-feeds-trainer")
        assert [f.element for f in got] == ["d"]

    def test_trainer_behind_a_queue_still_warns(self):
        bad = (  # pipelint: skip — gated stream reaching a trainer
            f"tensortestsrc caps={CAPS_F32} ! "
            "tensor_delta name=d mode=gate ! queue ! "
            "tensor_trainer name=tr ! fakesink")
        got = findings_for(bad, "delta-lossy-gate-feeds-trainer")
        assert [f.element for f in got] == ["d"]

    def test_mask_mode_into_trainer_is_clean(self):
        ok = (f"tensortestsrc caps={CAPS_F32} ! "
              "tensor_delta name=d mode=mask ! "
              "tensor_trainer name=tr ! fakesink")
        assert findings_for(ok, "delta-lossy-gate-feeds-trainer") == []

    def test_gate_without_trainer_is_clean(self):
        ok = (f"tensortestsrc caps={CAPS_U8} ! "
              "tensor_delta name=d mode=gate ! fakesink")
        assert findings_for(ok, "delta-lossy-gate-feeds-trainer") == []


class TestStatefulNoCheckpointRule:
    """``stateful-no-checkpoint`` on every element the port registers:
    an element class declaring RESTART_SAFE=False without a
    snapshot_state hook warns, in the port as in the JAX package; none
    of the port's elements does, and each element's checkpointable-ness
    is the JAX element's."""

    def test_no_port_element_declares_state_it_cannot_snapshot(self):
        from nnstreamer_tpu.pipeline.element import Element as NtElement
        from nnstreamer_tpu.pipeline.registry import _ELEMENTS as NT_ELEMENTS
        from nnstreamer_tpu_torch.pipeline.element import Element
        from nnstreamer_tpu_torch.pipeline.registry import _ELEMENTS

        def hooked(cls, base):
            return cls.snapshot_state is not base.snapshot_state

        for name, cls in _ELEMENTS.items():
            if not cls.__module__.startswith("nnstreamer_tpu_torch."):
                continue  # a test module's element
            declares = "RESTART_SAFE" in cls.__dict__ \
                and cls.RESTART_SAFE is False
            assert not declares or hooked(cls, Element), name
            if name in NT_ELEMENTS:
                assert hooked(cls, Element) == \
                    hooked(NT_ELEMENTS[name], NtElement), name

    def test_trainer_and_aggregator_lines_are_clean(self):
        ok = (f"tensortestsrc caps={CAPS_F32} ! tensor_rate "
              "framerate=30/1 ! tensor_aggregator frames-out=2 "
              "! tensor_trainer name=tr ! fakesink")
        assert findings_for(ok, "stateful-no-checkpoint") == []


class TestAutoscalerConfigRule:
    """``autoscaler-config`` on the JAX tests' own lines (both packages
    find the same set, see ``findings_for``)."""

    def test_inverted_bounds_error(self):
        bad = (  # pipelint: skip — floor above the ceiling
            "tensor_autoscaler name=a router=rt "
            "min-replicas=5 max-replicas=2")
        got = findings_for(bad, "autoscaler-config")
        assert [(f.element, f.severity) for f in got] == \
            [("a", Severity.ERROR)]
        assert "min-replicas=5 > max-replicas=2" in got[0].message

    def test_nonpositive_drain_deadline_error(self):
        bad = (  # pipelint: skip — zero drain deadline orphans work
            "tensor_autoscaler name=a router=rt drain-deadline-ms=0")
        got = findings_for(bad, "autoscaler-config")
        assert [(f.element, f.severity) for f in got] == \
            [("a", Severity.ERROR)]
        assert "drain-deadline-ms" in got[0].message

    def test_no_metrics_source_warns(self):
        blind = (  # pipelint: skip — nothing feeds the control law
            "tensor_autoscaler name=a min-replicas=1 max-replicas=3")
        got = findings_for(blind, "autoscaler-config")
        assert [(f.element, f.severity) for f in got] == \
            [("a", Severity.WARNING)]
        assert "metrics source" in got[0].message

    def test_metrics_url_counts_as_source(self):
        ok = ("tensor_autoscaler name=a max-replicas=3 "
              "metrics-url=http://localhost:9090/metrics")
        assert findings_for(ok, "autoscaler-config") == []

    def test_routered_autoscaler_is_clean(self):
        ok = ("tensor_autoscaler name=a router=rt "
              "min-replicas=1 max-replicas=4 drain-deadline-ms=2000")
        assert findings_for(ok, "autoscaler-config") == []


CAPS_BATCH6 = ("other/tensors,format=static,num_tensors=1,"
               "types=(string)float32,dimensions=(string)4:6,"
               "framerate=(fraction)0/1")


class TestMeshRules:
    """The three mesh rules on tests/test_analysis.py's own lines (the
    framework swapped for simlink, which both packages have), each
    finding set compared with the JAX package's by ``findings_for``."""

    def test_sharding_divisibility_provable(self):
        bad = (  # pipelint: skip — batch 6 on a dp=4 mesh
            f"tensortestsrc caps={CAPS_BATCH6} ! {FILTER} "
            'input=4 inputtype=float32 custom="mesh:4x1x2" ! fakesink')
        got = findings_for(bad, "sharding-divisibility")
        assert [(f.element, f.pad) for f in got] == [("f", "sink")]
        assert got[0].severity is Severity.ERROR
        assert "batch 6 is not divisible" in got[0].message

    def test_sharding_divisible_is_clean(self):
        ok = (f"tensortestsrc caps={CAPS_BATCH6} ! {FILTER} "
              'input=4 inputtype=float32 custom="mesh:2x1x2" ! fakesink')
        assert findings_for(ok, "sharding-divisibility") == []

    def test_sharding_leading_dim_unprovable_warns(self):
        bad = (  # pipelint: skip — leading dim 6 on a dp=4 mesh
            f"tensortestsrc caps={CAPS_BATCH6} ! {FILTER} "
            'custom="mesh:4x1x1" ! fakesink')
        got = findings_for(bad, "sharding-divisibility")
        assert [(f.element, f.severity) for f in got] == \
            [("f", Severity.WARNING)]

    def test_serve_mesh_bucket_indivisible(self):
        bad = (  # pipelint: skip — bucket 6 on a dp=4 mesh filter
            f"tensor_serve_src name=s buckets=4,6,8 ! {FILTER} "
            'custom="mesh:4x1x1" ! tensor_serve_sink')
        got = findings_for(bad, "serve-mesh-divisibility")
        assert [(f.element, f.pad) for f in got] == [("f", "sink")]
        assert got[0].severity is Severity.ERROR
        assert "[6]" in got[0].message and "replicated" in got[0].message

    def test_serve_mesh_src_snapping_clears_it(self):
        ok = (f"tensor_serve_src name=s buckets=4,6,8 mesh=4x1x1 ! {FILTER} "
              'custom="mesh:4x1x1" ! tensor_serve_sink')
        assert findings_for(ok, "serve-mesh-divisibility") == []

    def test_serve_mesh_divisible_is_clean(self):
        ok = (f"tensor_serve_src name=s buckets=4,8 ! {FILTER} "
              'custom="mesh:4x1x1" ! tensor_serve_sink')
        assert findings_for(ok, "serve-mesh-divisibility") == []

    def test_mesh_colocation_mismatch_warns(self):
        bad = (  # pipelint: skip — trainer and filter declare different meshes
            f"tensortestsrc caps={CAPS_BATCH6} ! tee name=t "
            f"t. ! queue ! {FILTER} custom=\"mesh:2x1x2\" ! fakesink "
            "t. ! queue ! tensor_trainer name=tr mesh=4x1x1 ! fakesink")
        got = findings_for(bad, "mesh-colocation")
        assert [f.element for f in got] == ["tr"]
        assert got[0].severity is Severity.WARNING
        assert "share the mesh" in got[0].message

    def test_mesh_colocation_same_spec_is_clean(self):
        ok = (f"tensortestsrc caps={CAPS_BATCH6} ! tee name=t "
              f"t. ! queue ! {FILTER} custom=\"mesh:2x1x2\" ! fakesink "
              "t. ! queue ! tensor_trainer name=tr mesh=2x1x2 ! fakesink")
        assert findings_for(ok, "mesh-colocation") == []
