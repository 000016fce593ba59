"""The port's K-frame in-flight window (elements/overlap.py over the
backends' dispatch/complete) against the JAX package's, on the CPU.

Mirrors tests/test_async.py: the reorder buffer and the in-flight
window's semantics, the overlap executor, the ``simlink`` pipeline at
in-flight 1 and K (same bytes as the JAX package's line, in order), the
PTS order under a straggler, the accounting of completion failures, the
split dispatch/completion latency, and upload coalescing. The breaker
fed from the completer thread is held against the JAX package in
tests/test_torch_fault.py (``TestAsyncBreaker``); the racecheck roles
have no module in the port yet (ROADMAP.md).
"""
import time

import numpy as np
import pytest

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as pt
from nnstreamer_tpu.elements import overlap as jax_overlap
from nnstreamer_tpu.tensors import transfer as jax_transfer
from nnstreamer_tpu_torch.elements.overlap import (OverlapExecutor,
                                                   ReorderBuffer)
from nnstreamer_tpu_torch.tensors import transfer as T

CAPS = ("other/tensors,format=static,num_tensors=1,"
        "types=(string)float32,dimensions=(string)8,"
        "framerate=(fraction)30/1")


class _Item:
    def __init__(self, pts):
        self.pts = pts


# ---------------------------------------------------------- reorder buffer

class TestReorderBuffer:
    def test_in_order_passthrough(self):
        rb = ReorderBuffer()
        a, b = _Item(0), _Item(1)
        assert rb.push(0, a) == [a]
        assert rb.push(1, b) == [b]
        assert rb.released == 2 and len(rb) == 0

    def test_out_of_order_restored(self):
        rb = ReorderBuffer()
        items = [_Item(i) for i in range(4)]
        assert rb.push(2, items[2]) == []
        assert rb.push(1, items[1]) == []
        assert rb.push(0, items[0]) == items[:3]
        assert rb.push(3, items[3]) == [items[3]]
        assert rb.released == 4 and rb.pts_regressions == 0

    def test_skip_advances_past_error_gap(self):
        rb = ReorderBuffer()
        late = _Item(2)
        assert rb.push(2, late) == []
        assert rb.push(0, _Item(0)) != []
        assert rb.skip(1) == [late]
        assert rb.skipped == 1 and rb.released == 2

    def test_stall_deadline_abandons_gap(self):
        rb = ReorderBuffer(deadline_s=1.0)
        held = _Item(5)
        rb.push(5, held, now=100.0)
        assert rb.poll(now=100.5) == []
        assert rb.poll(now=101.5) == [held]
        assert rb.stalls == 1 and rb.released == 1

    def test_flush_releases_everything_in_order(self):
        rb = ReorderBuffer()
        a, c = _Item(0), _Item(2)
        rb.push(2, c)
        rb.push(0, a)
        assert rb.flush() == [c]
        assert rb.released == 2 and len(rb) == 0

    def test_pts_regression_counted_not_hidden(self):
        rb = ReorderBuffer()
        first, second = _Item(100), _Item(50)
        out = rb.push(0, first) + rb.push(1, second)
        assert out == [first, second]
        assert rb.pts_regressions == 1

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_random_schedule_matches_jax(self, seed):
        """The same shuffled push/skip/poll schedule through both
        packages' buffers: the same releases, in the same order, and the
        same counters."""
        rng = np.random.default_rng(seed)
        order = rng.permutation(40)
        skips = set(rng.choice(40, 6, replace=False).tolist())
        ours, theirs = ReorderBuffer(0.5), jax_overlap.ReorderBuffer(0.5)
        got, want = [], []
        for step, seq in enumerate(order.tolist()):
            now = 10.0 + 0.1 * step
            for rb, out in ((ours, got), (theirs, want)):
                if seq in skips:
                    out += [i.pts for i in rb.skip(seq, now=now)]
                else:
                    out += [i.pts for i in rb.push(seq, _Item(seq), now=now)]
                out += [i.pts for i in rb.poll(now=now)]
        got += [i.pts for i in ours.flush()]
        want += [i.pts for i in theirs.flush()]
        assert got == want
        for name in ("released", "skipped", "stalls", "pts_regressions"):
            assert getattr(ours, name) == getattr(theirs, name), name


# ------------------------------------------------------- in-flight window

class TestInFlightWindow:
    @pytest.mark.parametrize("pkg", [T, jax_transfer], ids=["port", "jax"])
    def test_backpressure_and_report_agree(self, pkg):
        """Both packages' windows block at the limit and report the same
        keys and depths for the same sequence."""
        w = pkg.InFlightWindow(3)
        ts = [w.acquire() for _ in range(3)]
        assert w.acquire(timeout=0.05) is None
        time.sleep(0.02)
        for t in ts:
            w.release(t)
        rep = w.report()
        assert sorted(rep) == sorted(T.InFlightWindow(3).report())
        assert rep["window"] == 3 and rep["in_flight_peak"] == 3
        assert rep["in_flight"] == 0 and rep["overlap_ratio"] > 1.5


# ------------------------------------------------------- overlap executor

class TestOverlapExecutor:
    def _make(self, limit=4, complete=None, error=None, **kw):
        pushed = []
        ex = OverlapExecutor(
            limit,
            complete_cb=complete or (lambda e: e.buf),
            error_cb=error or (lambda e, exc: None),
            push_cb=pushed.append, **kw)
        return ex, pushed

    def test_frames_complete_and_push_in_order(self):
        ex, pushed = self._make()
        for i in range(8):
            ex.submit(_Item(i), None, ex.window.acquire())
        assert ex.flush()
        ex.stop()
        assert [b.pts for b in pushed] == list(range(8))
        rep = ex.report()
        assert rep["completed"] == 8 and rep["errors"] == 0
        assert rep["reorder"]["released"] == 8

    def test_error_frames_account_and_do_not_dam(self):
        errs = []

        def complete(entry):
            if entry.buf.pts == 1:
                raise RuntimeError("boom")
            return entry.buf

        ex, pushed = self._make(complete=complete,
                                error=lambda e, exc: errs.append(e.buf.pts))
        for i in range(4):
            ex.submit(_Item(i), None, ex.window.acquire())
        assert ex.flush()
        ex.stop()
        assert errs == [1]
        assert [b.pts for b in pushed] == [0, 2, 3]
        rep = ex.report()
        assert rep["errors"] == 1 and rep["completed"] == 3
        assert rep["reorder"]["skipped"] == 1

    def test_push_failure_releases_the_window_slot(self):
        ex = OverlapExecutor(
            2, complete_cb=lambda e: e.buf,
            error_cb=lambda e, exc: None,
            push_cb=lambda b: (_ for _ in ()).throw(RuntimeError("sink")))
        for i in range(4):
            ex.submit(_Item(i), None, ex.window.acquire())
        assert ex.flush()
        ex.stop()
        assert ex.report()["push_errors"] == 4

    def test_settle_crash_still_releases_the_slot(self):
        ex, _ = self._make(limit=1)

        class _BoomReorder:
            def __len__(self):
                return 0

            def push(self, seq, item, now=None):
                raise RuntimeError("reorder boom")

            def skip(self, seq, now=None):
                return []

            def poll(self, now=None):
                return []

        ex._reorder = _BoomReorder()
        ex.submit(_Item(0), None, ex.window.acquire())
        assert ex.window.wait_idle(10.0), \
            "settle crash leaked the window slot"
        assert ex.window.report()["in_flight"] == 0
        ex.stop()


# ------------------------------------------------------ pipeline (simlink)

def _simlink_line(n, custom, extra):
    return (f'tensortestsrc name=src caps="{CAPS}" num-buffers={n} '
            "pattern=counter ! queue max-size-buffers=4 "
            "! tensor_filter name=f framework=simlink "
            f"custom={custom} {extra} ! appsink name=out")


def _run_simlink(pkg=pt, n=12, custom="rtt:30,svc:2", extra="",
                 timeout=60):
    p = pkg.parse_launch(_simlink_line(n, custom, extra))
    p.fuse = False
    p.run(timeout=timeout)
    return p


def _bytes_of(p):
    return [tuple(np.ascontiguousarray(c.host()).tobytes()
                  for c in b.chunks) for b in p["out"].pop_all()]


class TestSimlinkPipeline:
    def test_async_matches_sync_bytes_and_is_faster(self):
        t0 = time.perf_counter()
        sync = _run_simlink(extra="in-flight=1")
        t_sync = time.perf_counter() - t0
        t0 = time.perf_counter()
        ovl = _run_simlink(extra="in-flight=8")
        t_async = time.perf_counter() - t0
        sb, ab = _bytes_of(sync), _bytes_of(ovl)
        assert len(ab) == 12
        assert ab == sb
        assert t_async < t_sync

    @pytest.mark.parametrize("k", [1, 4])
    def test_outputs_match_jax_line(self, k):
        """The same simlink line at in-flight K in both packages: the
        same bytes and PTS, in order."""
        port = _run_simlink(pt, custom="rtt:5,svc:1", extra=f"in-flight={k}")
        ref = _run_simlink(nt, custom="rtt:5,svc:1", extra=f"in-flight={k}")
        got, want = port["out"].buffers, ref["out"].buffers
        assert [b.pts for b in got] == [b.pts for b in want]
        assert len(got) == 12
        for g, w in zip(got, want):
            assert g.chunks[0].host().tobytes() == w.chunks[0].host().tobytes()
        assert sorted(port["f"].transfer_report()) == \
            sorted(ref["f"].transfer_report())

    def test_pts_monotonic_with_window_and_slow_frame(self):
        from nnstreamer_tpu_torch.filters.simlink import SimLinkFilter
        orig = SimLinkFilter.complete

        def slow_complete(self, handle):
            if handle[2] == 3:  # frame 3 straggles on the link
                time.sleep(0.2)
            return orig(self, handle)

        SimLinkFilter.complete = slow_complete
        try:
            p = _run_simlink(extra="in-flight=6")
        finally:
            SimLinkFilter.complete = orig
        bufs = p["out"].pop_all()
        assert len(bufs) == 12
        pts = [b.pts for b in bufs]
        assert pts == sorted(pts), f"PTS went backwards: {pts}"
        rep = p["f"].transfer_report()
        assert rep["reorder"]["pts_regressions"] == 0
        assert rep["completed"] == 12

    def test_zero_loss_accounting_with_completion_failures(self):
        """fail-every=5 raises INSIDE completion with frames in flight:
        every admitted frame settles exactly once — pushed or accounted
        dropped."""
        p = _run_simlink(n=20, custom="rtt:20,svc:1,fail-every:5",
                         extra="in-flight=8")
        got = p["out"].pop_all()
        st = p["f"].stats.snapshot()
        assert st["invoke_errors"] == 4
        assert len(got) + st["frames_dropped"] == 20
        assert len(got) == 16
        rep = p["f"].transfer_report()
        assert rep["errors"] == 4 and rep["completed"] == 16
        assert rep["reorder"]["skipped"] == 4

    def test_dispatch_vs_completion_latency_split(self):
        p = _run_simlink(custom="rtt:40,svc:1", extra="in-flight=8")
        f = p["f"]
        lat_us = f.latency_average_us()
        disp_us = f.dispatch_average_us()
        assert lat_us >= 40_000 * 0.9
        assert disp_us < lat_us / 4
        rep = f.transfer_report()
        assert rep["window"] == 8
        assert rep["in_flight_peak"] >= 2

    def test_sync_path_records_equal_latencies(self):
        p = _run_simlink(custom="rtt:20,svc:1", extra="in-flight=1")
        f = p["f"]
        assert f.dispatch_average_us() == pytest.approx(
            f.latency_average_us(), rel=0.01)
        assert f.transfer_report() == {}


# ---------------------------------------------------------- upload path

class TestUploadCoalescing:
    def test_uploads_coalesce_under_link_latency(self):
        T.transfer_stats(reset=True)
        T.set_simulated_rtt_ms(40.0)
        try:
            pending = [T.submit_upload([np.full(4, i, np.float32)], "cpu")
                       for i in range(6)]
            outs = [[T.resolve(x) for x in batch] for batch in pending]
        finally:
            T.set_simulated_rtt_ms(0.0)
        for i, batch in enumerate(outs):
            np.testing.assert_array_equal(batch[0].numpy(),
                                          np.full(4, i, np.float32))
        st = T.transfer_stats(reset=True)["upload"]
        assert st["rpcs"] >= 1
        assert st["frames_per_rpc_avg"] > 1.0
