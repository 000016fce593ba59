"""The port's tracer (utils/trace.py, ``Pipeline.enable_tracing``) against
the JAX package's, on the CPU.

Mirrors tests/test_trace.py (all three cases), tests/test_fusion.py's
fusion block present and absent, and tests/test_async.py's
``TestTraceTransferBlock``. The JAX side's ``custom-easy`` sleepers are
replaced in both packages by ``framework=simlink custom=rtt:<ms>``,
whose synchronous invoke waits the given link time. Each line runs in
both packages; the port's report must have the reference's keys for
every element and block, and the reference's bounds must hold for both.
Times are host times and differ run to run, so they are held to the
reference test's bounds, not to each other; counts are equal.
"""
import numpy as np
import pytest

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as pt
from nnstreamer_tpu.tensors.transfer import \
    transfer_stats as jax_transfer_stats
from nnstreamer_tpu_torch.tensors.transfer import transfer_stats
from nnstreamer_tpu_torch.utils.trace import Reservoir, WindowReservoir

PKGS = (nt, pt)
CAPS = ("other/tensors,format=static,num_tensors=1,types=float32,"
        "dimensions=8,framerate=0/1")
CAPS_F32 = ("other/tensors,format=static,num_tensors=1,"
            "types=(string)float32,dimensions=(string)3:4:4,"
            "framerate=(fraction)0/1")
RUN2 = ("tensor_transform name=a mode=arithmetic option=mul:2 ! "
        "tensor_transform name=b mode=transpose option=1:0:2")


def _traced(desc, fuse=True):
    """Run ``desc`` traced in both packages (the coalescing transfer
    counters reset first: they are process-wide); returns the two
    (pipeline, report) pairs, JAX first."""
    out = []
    for pkg, reset in ((nt, jax_transfer_stats), (pt, transfer_stats)):
        reset(reset=True)
        p = pkg.parse_launch(desc)
        p.fuse = fuse
        tracer = p.enable_tracing()
        p.run(60)
        out.append((p, tracer.report(p)))
    return out


def _same_keys(want, got):
    """Every element and block of the reference's report is in the
    port's with the same keys, recursively for nested blocks."""
    assert set(got) == set(want)
    for name, entry in want.items():
        if isinstance(entry, dict):
            _same_keys(entry, got[name])


def test_tracer_reports_all_elements():
    (_, want), (_, rep) = _traced(
        f"tensortestsrc name=src caps={CAPS} num-buffers=5 ! "
        "queue name=q max-size-buffers=4 ! "
        "tensor_filter name=f framework=simlink custom=rtt:10 ! "
        "appsink name=out")
    _same_keys(want, rep)
    for r in (want, rep):
        assert {"q", "f", "out"} <= set(r)
        # interlatency grows downstream
        assert r["out"]["interlatency_us_avg"] >= \
            r["f"]["interlatency_us_avg"] >= r["q"]["interlatency_us_avg"]
        assert r["out"]["interlatency_us_avg"] >= 9000
        assert r["f"]["proctime_us_avg"] >= 9000
        assert r["out"]["buffers"] == 5
        assert r["out"]["framerate_fps"] > 0
        assert r["q"]["queue_level"] == 0


def test_tracing_off_by_default_no_overhead_keys():
    for pkg in PKGS:
        p = pkg.parse_launch(
            f"tensortestsrc caps={CAPS} num-buffers=2 ! appsink name=out")
        p.run(10)
        assert p.tracer is None
        assert not any(k.startswith("_trace") for k in
                       p["out"].buffers[0].extras)


def test_interlatency_survives_fresh_buffers():
    """tensor_converter builds fresh buffers; the sink's interlatency
    still covers the filter's 5 ms downstream of it."""
    (_, want), (_, rep) = _traced(
        'videotestsrc name=src num-buffers=4 pattern=smpte '
        'caps="video/x-raw,format=RGB,width=4,height=2,framerate=30/1" ! '
        "tensor_converter name=c ! tensor_transform name=t mode=typecast "
        "option=float32 ! "
        "tensor_filter name=f framework=simlink custom=rtt:5 ! "
        "appsink name=out")
    _same_keys(want, rep)
    for r in (want, rep):
        assert r["out"]["interlatency_us_avg"] >= 4500, r["out"]


def test_report_carries_fusion_block():
    (_, want), (_, rep) = _traced(
        f"tensortestsrc name=src caps={CAPS_F32} num-buffers=4 ! {RUN2} ! "
        "appsink name=out")
    _same_keys(want, rep)
    fb = rep["fusion"]
    assert fb["segments"] == 1 and fb["fused_elements"] == 2
    assert fb["jit_misses"] == 1 and fb["jit_hits"] == 3
    assert fb["devices"] == want["fusion"]["devices"] == 1
    (seg_entry,) = fb["per_segment"].values()
    assert seg_entry["members"] == ["a", "b"]
    assert seg_entry["dispatch_us_p50"] > 0
    assert not any(k.startswith("fusion/") for k in rep)


def test_unfused_report_has_no_fusion_block():
    (_, want), (_, rep) = _traced(
        f"tensortestsrc name=src caps={CAPS_F32} num-buffers=2 ! {RUN2} ! "
        "appsink name=out", fuse=False)
    _same_keys(want, rep)
    assert "fusion" not in rep


class TestTraceTransferBlock:
    def test_report_carries_window_and_coalesce_stats(self):
        (_, want), (_, rep) = _traced(
            f'tensortestsrc name=src caps="{CAPS}" num-buffers=8 '
            'pattern=counter ! queue name=q ! tensor_filter name=f '
            'framework=simlink '
            'custom=rtt:20,svc:1 in-flight=4 ! appsink name=out',
            fuse=False)
        _same_keys(want, rep)
        win = rep["transfer"]["windows"]["f"]
        assert win["window"] == 4
        assert win["completed"] == 8
        assert 0.0 < win["occupancy_avg"] <= 4.0
        assert rep["transfer"]["devices"] == 1


def test_ensemble_report_has_the_reference_keys():
    """A tee into two legs, recombined by tensor_mux and split again by
    tensor_demux: every element the port has reports the reference's
    keys, queue levels included; the mux's collection bypasses the
    per-buffer hooks in both packages, so its entry is empty."""
    (jp, want), (p, rep) = _traced(
        "tensor_mux name=m sync-mode=slowest ! tensor_demux name=d "
        "d.src_0 ! queue name=qa ! appsink name=a "
        "d.src_1 ! queue name=qb ! appsink name=b "
        f"tensortestsrc name=src caps={CAPS} num-buffers=6 ! tee name=t "
        "t. ! queue name=q0 ! tensor_filter name=f0 framework=simlink "
        "custom=rtt:2 ! m.sink_0 "
        "t. ! queue name=q1 ! tensor_filter name=f1 framework=simlink "
        "custom=rtt:1 ! m.sink_1")
    _same_keys(want, rep)
    for r, pipe in ((want, jp), (rep, p)):
        assert r["m"] == {}
        for q in ("q0", "q1", "qa", "qb"):
            assert r[q]["queue_level"] == 0 and r[q]["buffers"] == 6
        assert r["a"]["buffers"] == r["b"]["buffers"] == 6
        assert r["a"]["interlatency_us_avg"] >= 1500
        assert len(pipe["a"].buffers) == len(pipe["b"].buffers) == 6


def test_reservoirs_match_the_reference():
    """The bounded reservoirs give the reference's percentiles on the
    same stream (seeded), and the window forgets old samples."""
    from nnstreamer_tpu.utils.trace import Reservoir as JReservoir
    from nnstreamer_tpu.utils.trace import WindowReservoir as JWindow
    values = np.random.default_rng(2).exponential(1.0, 5000).tolist()
    ours, theirs = Reservoir(k=64), JReservoir(k=64)
    for v in values:
        ours.add(v)
        theirs.add(v)
    assert ours.percentiles() == theirs.percentiles()
    w, jw = WindowReservoir(window_s=1.0, k=8), JWindow(window_s=1.0, k=8)
    for i, v in enumerate(values[:20]):
        w.add(v, now=i * 0.25)
        jw.add(v, now=i * 0.25)
    assert w.samples(now=5.0) == jw.samples(now=5.0)
    assert w.percentiles(now=5.0) == jw.percentiles(now=5.0)
    assert len(w.samples(now=100.0)) == 0


@pytest.mark.parametrize("fuse", [True, False])
def test_tracer_counts_match_the_reference(fuse):
    """Buffers seen per element are equal in both packages."""
    (_, want), (_, rep) = _traced(
        f"tensortestsrc name=src caps={CAPS_F32} num-buffers=5 ! "
        "queue name=q ! "
        f"{RUN2} ! tensor_transform name=c mode=typecast option=uint8 "
        "! appsink name=out", fuse=fuse)
    _same_keys(want, rep)
    assert {k: v.get("buffers") for k, v in rep.items()
            if isinstance(v, dict)} == \
        {k: v.get("buffers") for k, v in want.items()
         if isinstance(v, dict)}
