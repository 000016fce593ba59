"""The port's fault layer (nnstreamer_tpu_torch/fault/) against the JAX
package's, on the CPU.

Mirrors tests/test_chaos.py's unit classes (classification, policy
parsing, backoff, restart budget, circuit breaker, tensor_fault) and its
pipeline classes (chain policies, source supervision, the filter's
breaker), tests/test_fusion.py's ``TestSegmentFaults`` and
tests/test_async.py's completion-failure cases (simlink ``fail-every``
under an in-flight window feeding the breaker from the completer
thread). Each case runs the same launch line, or the same seeded unit
calls, through both packages and compares exactly: delivered PTS, the
counters (``dropped``, ``retries``, ``restarts``, ``faults``, ``shed``,
``breaker_opened``, ``invoke_errors``) and the bus warnings. Where the
outcome depends on thread timing (frames in flight when the breaker
opens), both packages are held to the reference's invariants instead.

The MobileNet-v2 line runs one set of seeded variables (width 0.35,
96x96) in both packages with a ``tensor_fault mode=raise every=3
on-error=skip`` in front of the filter: the same frames are skipped, and
the delivered logits agree within tests/test_torch_mobilenet.py's bf16
bound (2e-2 absolute, equal top-1).
"""
import dataclasses
import socket
import threading
import time

import jax
import numpy as np
import pytest
import torch

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as pt
from nnstreamer_tpu import fault as nt_fault
from nnstreamer_tpu.filters import registry as nt_filter_registry
from nnstreamer_tpu.filters.simlink import SimLinkFilter as NtSimLink
from nnstreamer_tpu.fusion.segment import FusedSegment as NtSegment
from nnstreamer_tpu.models import zoo as jax_zoo
from nnstreamer_tpu.pipeline import element as nt_element
from nnstreamer_tpu.pipeline import registry as nt_registry
from nnstreamer_tpu.pipeline.pipeline import Pipeline as NtPipeline
from nnstreamer_tpu.tensors import buffer as nt_buffer
from nnstreamer_tpu.tensors.caps import Caps as NtCaps
from nnstreamer_tpu_torch import fault as pt_fault
from nnstreamer_tpu_torch.filters import registry as pt_filter_registry
from nnstreamer_tpu_torch.filters.simlink import SimLinkFilter as PtSimLink
from nnstreamer_tpu_torch.fusion.segment import FusedSegment as PtSegment
from nnstreamer_tpu_torch.pipeline import element as pt_element
from nnstreamer_tpu_torch.pipeline import registry as pt_registry
from nnstreamer_tpu_torch.pipeline.pipeline import Pipeline as PtPipeline
from nnstreamer_tpu_torch.tensors import buffer as pt_buffer
from nnstreamer_tpu_torch.tensors.caps import Caps as PtCaps

PKGS = (nt, pt)
FAULTS = (nt_fault, pt_fault)
CAPS_U8 = "other/tensors,format=static,num_tensors=1,types=uint8,dimensions=4"
CAPS_F32 = ("other/tensors,format=static,num_tensors=1,"
            "types=(string)float32,dimensions=(string)3:4:4,"
            "framerate=(fraction)0/1")
SEED = 3


def _both(fn):
    """fn(pkg) for the JAX package and the port."""
    return [fn(pkg) for pkg in PKGS]


# ------------------------------------------------------------- unit layer

class TestClassification:
    @pytest.mark.parametrize("make", [
        lambda f: f.TransientError("x"), lambda f: f.FaultInjected("x"),
        lambda f: socket.timeout(), lambda f: ConnectionResetError(),
        lambda f: TimeoutError(), lambda f: ValueError("x"),
        lambda f: RuntimeError("x"), lambda f: KeyError("x")],
        ids=["transient", "injected", "socket-timeout", "conn-reset",
             "timeout", "value", "runtime", "key"])
    def test_same_verdicts(self, make):
        nt_v, pt_v = (f.is_transient(make(f)) for f in FAULTS)
        assert nt_v == pt_v

    def test_registry_extension(self):
        from nnstreamer_tpu.fault import errors as nt_errors
        from nnstreamer_tpu_torch.fault import errors as pt_errors

        class MyFlaky(Exception):
            pass

        verdicts = []
        for f, mod in ((nt_fault, nt_errors), (pt_fault, pt_errors)):
            class MyFatal(f.TransientError):
                pass
            saved = mod._TRANSIENT_TYPES, mod._FATAL_TYPES
            try:
                f.register_transient(MyFlaky)
                f.register_fatal(MyFatal)
                verdicts.append((f.is_transient(MyFlaky()),
                                 f.is_transient(MyFatal())))
            finally:
                mod._TRANSIENT_TYPES, mod._FATAL_TYPES = saved
        assert verdicts == [(True, False)] * 2

    def test_cuda_oom_stays_fatal_when_runtime_errors_retry(self):
        """The port's one addition: a deployment that registers
        RuntimeError (every CUDA runtime error's base) as transient still
        gets a fatal verdict for a CUDA OOM."""
        from nnstreamer_tpu_torch.fault import errors as pt_errors
        saved = pt_errors._TRANSIENT_TYPES, pt_errors._FATAL_TYPES
        try:
            pt_fault.register_transient(RuntimeError)
            assert pt_fault.is_transient(RuntimeError("cuda"))
            assert not pt_fault.is_transient(
                torch.cuda.OutOfMemoryError("oom"))
        finally:
            pt_errors._TRANSIENT_TYPES, pt_errors._FATAL_TYPES = saved


class TestErrorPolicyParse:
    @pytest.mark.parametrize("spec", [
        "fail", "skip", "retry", "retry(2)", "retry(5,0.2,0.1)",
        "restart", "restart(7,12.5)", " retry( 2 , 0.1 ) ", ""])
    def test_same_policy(self, spec):
        nt_p, pt_p = (dataclasses.asdict(f.ErrorPolicy.parse(spec))
                      for f in FAULTS)
        assert nt_p == pt_p

    @pytest.mark.parametrize("bad", [
        "explode", "retry(", "retry(a)", "fail(1)", "skip(2)",
        "retry(1,2,3,4)", "restart(x)"])
    def test_bad_specs_raise(self, bad):
        for f in FAULTS:
            with pytest.raises(ValueError):
                f.ErrorPolicy.parse(bad)


class TestBackoff:
    def test_deterministic_ladder_without_jitter(self):
        ladders = [[b.next() for _ in range(5)] for b in
                   (f.Backoff(base=0.1, multiplier=2.0, max_s=1.0,
                              jitter=0.0) for f in FAULTS)]
        assert ladders[0] == ladders[1] == [0.1, 0.2, 0.4, 0.8, 1.0]

    def test_jitter_matches_the_reference_run_for_run(self):
        a, b = (f.Backoff(base=0.1, jitter=0.5, seed=7) for f in FAULTS)
        assert [a.next() for _ in range(8)] == [b.next() for _ in range(8)]

    def test_policy_backoff_matches(self):
        a, b = (f.ErrorPolicy.parse("retry(4,0.01,0.3)").make_backoff(seed=5)
                for f in FAULTS)
        assert [a.next() for _ in range(4)] == [b.next() for _ in range(4)]

    def test_sleep_interruptible(self):
        evt = threading.Event()
        evt.set()
        t0 = time.monotonic()
        pt_fault.Backoff(base=5.0, jitter=0.0).sleep(evt)
        assert time.monotonic() - t0 < 1.0


class TestRestartBudget:
    def test_exhausts_then_allows_after_window(self):
        budgets = [f.RestartBudget(limit=2, window_s=0.2) for f in FAULTS]
        first = [[b.allow() for _ in range(3)] for b in budgets]
        time.sleep(0.25)
        assert first == [[True, True, False]] * 2
        assert [b.allow() for b in budgets] == [True, True]


class TestCircuitBreaker:
    @staticmethod
    def _drive(f):
        seen = []
        cb = f.CircuitBreaker(threshold=2, reset_s=0.05,
                              on_transition=lambda o, n: seen.append((o, n)))
        steps = [cb.allow()]
        cb.record_failure()
        steps.append(cb.state)
        cb.record_success()
        cb.record_failure()
        cb.record_failure()
        steps += [cb.state, cb.allow(), cb.allow()]
        time.sleep(0.08)
        steps += [cb.state, cb.allow(), cb.allow()]
        cb.record_failure()          # the probe fails: back to OPEN
        steps.append(cb.state)
        time.sleep(0.08)
        steps.append(cb.allow())
        cb.record_success()          # the probe succeeds: CLOSED
        steps += [cb.state, cb.allow()]
        return steps, seen, cb.stats.snapshot()

    def test_same_state_machine(self):
        nt_run, pt_run = (self._drive(f) for f in FAULTS)
        assert nt_run == pt_run
        steps, seen, stats = pt_run
        assert steps[:6] == [True, "closed", "open", False, False,
                             "half-open"]
        assert seen[0] == (pt_fault.CLOSED, pt_fault.OPEN)
        assert seen[-1] == (pt_fault.HALF_OPEN, pt_fault.CLOSED)
        assert stats == {"opened": 2, "closed": 1, "rejected": 3}


class TestTensorFault:
    @staticmethod
    def _buf(pkg_buffer, v=1, dtype=np.uint8):
        return pkg_buffer.Buffer([pkg_buffer.Chunk(np.full(4, v, dtype))],
                                 pts=v)

    def _fire(self, registry, pkg_buffer, calls, **props):
        f = registry.make_element("tensor_fault", **props)
        f.start()
        out = []
        for i in range(calls):
            try:
                r = f.transform(self._buf(pkg_buffer, i))
                out.append("none" if r is None else "pass")
            except Exception as exc:  # noqa: BLE001 -- the verdict is compared
                out.append(type(exc).__name__)
        return out, f.stats.snapshot()

    @pytest.mark.parametrize("props", [
        {"mode": "transient", "every": 3},
        {"mode": "raise", "every": 2},
        {"mode": "transient", "probability": 0.5, "seed": 99},
        {"mode": "drop", "every": 2},
        {"mode": "drop", "every": 1, "max-faults": 2},
        {"mode": "delay", "every": 2, "delay-ms": 1.0},
        {"mode": "kill-link", "every": 2, "target": "nobody"}],
        ids=["every3", "raise", "probability", "drop", "max-faults",
             "delay", "kill-link-without-target"])
    def test_same_schedule_and_counters(self, props):
        nt_out, pt_out = (self._fire(r, b, 12, **props) for r, b in
                          ((nt_registry, nt_buffer), (pt_registry, pt_buffer)))
        assert nt_out[0] == pt_out[0]
        assert {k: nt_out[1][k] for k in ("faults", "passed", "dropped")} == \
            {k: pt_out[1][k] for k in ("faults", "passed", "dropped")}

    def test_start_resets_schedule(self):
        for registry, pkg_buffer, f_mod in (
                (nt_registry, nt_buffer, nt_fault),
                (pt_registry, pt_buffer, pt_fault)):
            f = registry.make_element("tensor_fault", mode="transient",
                                      every=2)
            f.start()
            f.transform(self._buf(pkg_buffer))
            with pytest.raises(f_mod.FaultInjected):
                f.transform(self._buf(pkg_buffer))
            f.stop()
            f.start()  # restart-safe: the schedule replays from call 1
            f.transform(self._buf(pkg_buffer))
            with pytest.raises(f_mod.FaultInjected):
                f.transform(self._buf(pkg_buffer))

    @pytest.mark.parametrize("dtype", [np.uint8, np.float32, np.int16])
    def test_corrupt_flips_the_same_bytes(self, dtype):
        outs = []
        for registry, pkg_buffer in ((nt_registry, nt_buffer),
                                     (pt_registry, pt_buffer)):
            f = registry.make_element("tensor_fault", mode="corrupt",
                                      every=1)
            f.start()
            out = f.transform(self._buf(pkg_buffer, 5, dtype))
            outs.append(np.asarray(out.chunks[0].host()))
        assert outs[0].dtype == outs[1].dtype == np.dtype(dtype)
        assert outs[0].tobytes() == outs[1].tobytes()
        want = np.full(4, 5, dtype).view(np.uint8) ^ 0xFF
        assert outs[1].view(np.uint8).tobytes() == want.tobytes()

    def test_corrupt_bfloat16_goes_through_the_host(self):
        src = torch.arange(4, dtype=torch.bfloat16)
        f = pt_registry.make_element("tensor_fault", mode="corrupt", every=1)
        f.start()
        out = f.transform(pt_buffer.Buffer([pt_buffer.Chunk(src)], pts=0))
        got = out.chunks[0].raw
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
        assert torch.equal(got.view(torch.uint8),
                           src.view(torch.uint8).bitwise_not())
        assert torch.equal(src, torch.arange(4, dtype=torch.bfloat16))


# ------------------------------------------------- pipeline-level policies

def _warnings(p, element):
    """The bus warnings an element posted, by their policy or breaker."""
    return [(m.data.get("policy"), m.data.get("breaker"))
            for m in p.bus.drain()
            if m.kind == "warning" and m.data.get("element") == element]


def _run(pkg, desc, timeout=30, fuse=True):
    p = pkg.parse_launch(desc)
    p.fuse = fuse
    return _run_started(p, timeout)


def _outcome(p, sink="s", element="f", keys=("dropped", "retries",
                                             "restarts", "faults")):
    st = p.stats()
    return ([b.pts for b in p[sink].buffers],
            {k: st[element][k] for k in keys}, _warnings(p, element))


CHAIN_LINES = {
    "skip": ("videotestsrc num-buffers=9 ! tensor_converter ! "
             "tensor_fault mode=raise every=3 on_error=skip name=f "
             "! tensor_sink name=s"),
    "retry": ("videotestsrc num-buffers=9 ! tensor_converter ! "
              "tensor_fault mode=transient every=3 "
              "on_error=retry(2,0.01) name=f ! tensor_sink name=s"),
    "restart": ("videotestsrc num-buffers=8 ! tensor_converter ! "
                "tensor_fault mode=transient every=3 "
                "on_error=restart(8,30) name=f ! tensor_sink name=s"),
    "probability-skip": (
        f"tensortestsrc caps={CAPS_F32} num-buffers=20 pattern=random "
        f"seed={SEED} ! tensor_fault mode=transient probability=0.3 "
        "seed=11 on_error=skip name=f ! tensor_sink name=s"),
    "drop": ("videotestsrc num-buffers=8 ! tensor_converter ! "
             "tensor_fault mode=drop every=3 name=f ! tensor_sink name=s"),
}


class TestChainPolicies:
    @pytest.mark.parametrize("case", sorted(CHAIN_LINES))
    def test_same_frames_counters_and_warnings(self, case):
        nt_out, pt_out = _both(lambda pkg: _outcome(
            _run(pkg, CHAIN_LINES[case])))
        assert nt_out == pt_out
        pts, counters, _ = pt_out
        if case == "retry":
            assert len(pts) == 9 and counters["retries"] == 4
        if case == "skip":
            assert len(pts) == 6 and counters["dropped"] == 3
        if case == "restart":
            assert len(pts) == 8 and counters["restarts"] >= 1

    @pytest.mark.parametrize("desc,exc", [
        ("videotestsrc num-buffers=9 ! tensor_converter ! "
         "tensor_fault mode=raise every=3 on_error=retry(5,0.01) ! "
         "tensor_sink", RuntimeError),
        ("videotestsrc num-buffers=4 ! tensor_converter ! "
         "tensor_fault mode=transient every=1 on_error=retry(2,0.01) ! "
         "tensor_sink", "FaultInjected"),
        ("videotestsrc num-buffers=9 ! tensor_converter ! "
         "tensor_fault mode=transient every=3 ! tensor_sink",
         "FaultInjected"),
        ("videotestsrc num-buffers=32 ! tensor_converter ! "
         "tensor_fault mode=transient every=2 on_error=restart(1,30) ! "
         "tensor_sink", "FaultInjected")],
        ids=["retry-on-fatal", "retry-exhausted", "fail", "restart-budget"])
    def test_escalations_abort_in_both(self, desc, exc):
        for pkg, f in zip(PKGS, FAULTS):
            want = getattr(f, exc) if isinstance(exc, str) else exc
            p = pkg.parse_launch(desc)
            p.start()
            with pytest.raises(want):
                p.wait_eos(timeout=30)
            p.stop()

    def test_bad_policy_spec_rejected_at_launch(self):
        for pkg in PKGS:
            p = pkg.parse_launch(  # pipelint: skip — intentionally typo'd policy
                "videotestsrc num-buffers=4 ! tensor_converter ! "
                "tensor_fault mode=transient every=2 "
                "on_error=explode ! tensor_sink")
            with pytest.raises(ValueError, match="on-error"):
                p.start()
            assert not p.running

    def test_bad_policy_spec_fails_at_first_fault_unvalidated(self):
        for pkg in PKGS:
            p = pkg.parse_launch(  # pipelint: skip — intentionally typo'd policy
                "videotestsrc num-buffers=4 ! tensor_converter ! "
                "tensor_fault mode=transient every=2 "
                "on_error=explode ! tensor_sink")
            p.validate_on_start = False
            p.start()
            with pytest.raises(ValueError, match="on-error"):
                p.wait_eos(timeout=30)
            p.stop()

    def test_tee_branch_fault_is_isolated_by_skip(self):
        line = ("videotestsrc num-buffers=8 ! tensor_converter ! tee name=t "
                "t. ! queue ! tensor_fault mode=raise every=4 on_error=skip "
                "name=f ! tensor_sink name=a "
                "t. ! queue ! tensor_sink name=b")
        outs = _both(lambda pkg: (
            lambda p: ([b.pts for b in p["a"].buffers],
                       [b.pts for b in p["b"].buffers],
                       p.stats()["f"]["dropped"]))(_run(pkg, line)))
        assert outs[0] == outs[1]
        assert len(outs[1][0]) == 6 and len(outs[1][1]) == 8

    def test_stats_and_trace_surface_fault_counters(self):
        p = pt.parse_launch("videotestsrc num-buffers=9 ! tensor_converter ! "
                            "tensor_fault mode=transient every=3 "
                            "on_error=retry(2,0.01) name=f ! tensor_sink")
        tracer = p.enable_tracing()
        p.start()
        p.wait_eos(timeout=30)
        rep = tracer.report(p)
        p.stop()
        assert p.stats()["f"]["retries"] == 4
        assert rep["f"]["buffers"] == p.stats()["f"]["buffers"] == 9


# --------------------------------------------------- supervised source

def _register_flaky_src(pkg_element, pkg_registry, pkg_buffer, caps_cls,
                        transient_cls):
    @pkg_registry.register_element("torch_parity_flaky_src")
    class FlakySrc(pkg_element.SrcElement):
        """Emits ``num-buffers`` frames; the first attempt at every
        ``every``-th frame raises TransientError. The cursor advances
        only on success, so a retried attempt yields the SAME frame."""

        PROPS = {"num-buffers": 6, "every": 3}

        def __init__(self, name=None, **props):
            super().__init__(name, **props)
            self._n = 0
            self._failed_once = set()

        def negotiate_src_caps(self):
            return caps_cls(CAPS_U8)

        def create(self):
            if self._n >= int(self.num_buffers):
                return None
            item = self._n
            if (item + 1) % int(self.every) == 0 \
                    and item not in self._failed_once:
                self._failed_once.add(item)
                raise transient_cls(f"{self.name}: flaky read at {item}")
            self._n += 1
            return pkg_buffer.Buffer(
                [pkg_buffer.Chunk(np.full(4, item, np.uint8))], pts=item)

    return FlakySrc


_register_flaky_src(nt_element, nt_registry, nt_buffer, NtCaps,
                    nt_fault.TransientError)
_register_flaky_src(pt_element, pt_registry, pt_buffer, PtCaps,
                    pt_fault.TransientError)


class TestSourceSupervision:
    @pytest.mark.parametrize("policy,counter,n", [
        ("retry(3,0.01)", "retries", 3), ("restart(5,30)", "restarts", 3),
        ("skip", "dropped", 3)])
    def test_same_recovery(self, policy, counter, n):
        # pipelint: skip (a template: the on-error policy is parametrised)
        line = (f"torch_parity_flaky_src num-buffers=9 every=3 "
                f"on_error={policy} name=src ! tensor_sink name=s")
        outs = _both(lambda pkg: _outcome(
            _run(pkg, line), element="src",
            keys=("dropped", "retries", "restarts")))
        assert outs[0] == outs[1]
        pts, counters, warnings = outs[1]
        assert counters[counter] == n
        assert pts == list(range(9))  # the failed read is replayed
        assert len(warnings) == n

    def test_fail_policy_aborts_the_stream(self):
        for pkg, f in zip(PKGS, FAULTS):
            p = pkg.parse_launch("torch_parity_flaky_src num-buffers=9 "
                                 "every=3 name=src ! tensor_sink")
            p.start()
            with pytest.raises(f.TransientError):
                p.wait_eos(timeout=30)
            p.stop()

    def test_warnings_carry_attempt_and_cause(self):
        p = _run(pt, "torch_parity_flaky_src num-buffers=9 every=3 "
                     "on_error=retry(3,0.01) name=src ! tensor_sink")
        msgs = [m for m in p.bus.drain()
                if m.kind == "warning" and m.data.get("element") == "src"]
        assert msgs and msgs[0].data.get("attempt") == 1
        assert "cause" in msgs[0].data

    def test_tensortestsrc_restart_replays_the_preamble(self):
        """A tensortestsrc whose read fails once under on-error=restart:
        the loop replays StreamStart/caps/segment and goes on from the
        same frame, keeping its frame state (on the card: its one pool
        of device frames, tests/test_torch_cuda.py)."""
        def run(pkg, f):
            p = pkg.parse_launch(
                f"tensortestsrc name=src caps={CAPS_F32} num-buffers=6 "
                "pattern=counter on-error=restart(3,30) ! "
                "tensor_sink name=s")
            src, failed = p["src"], []
            create = src.create

            def flaky():
                if src._count == 3 and not failed:
                    failed.append(True)
                    raise f.TransientError("flaky read")
                return create()

            src.create = flaky
            _run_started(p)
            return (_outcome(p, element="src",
                             keys=("dropped", "retries", "restarts")),
                    [float(b.chunks[0].host().flat[0])
                     for b in p["s"].buffers])
        nt_out, pt_out = (run(pkg, f) for pkg, f in zip(PKGS, FAULTS))
        assert nt_out == pt_out
        (pts, counters, warnings), values = pt_out
        assert counters["restarts"] == 1 and len(pts) == 6
        assert values == [0.0, 1.0, 2.0, 3.0, 4.0, 5.0]


def _run_started(p, timeout=30):
    p.start()
    try:
        p.wait_eos(timeout=timeout)
    finally:
        p.stop()
    return p


# ------------------------------------------------------ breaker (filter)

def _register_flaky_backend(simlink_cls, register):
    @register
    class FlakyBackend(simlink_cls):
        """simlink whose failure window the test scripts."""

        NAME = "torch_parity_flaky"
        broken = False
        calls = 0

        def invoke(self, inputs):
            type(self).calls += 1
            if type(self).broken:
                raise ConnectionError("backend down")
            return super().invoke(inputs)

    return FlakyBackend


FLAKY = {nt: _register_flaky_backend(NtSimLink,
                                     nt_filter_registry.register_filter),
         pt: _register_flaky_backend(PtSimLink,
                                     pt_filter_registry.register_filter)}


def _wait(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert cond()


class TestFilterBreaker:
    def _cycle(self, pkg):
        backend = FLAKY[pkg]
        backend.broken, backend.calls = False, 0
        p = pkg.parse_launch(
            f'appsrc name=in caps="{CAPS_U8}" ! '
            "tensor_filter name=f framework=torch_parity_flaky "
            "breaker-threshold=3 breaker-reset-ms=100 ! tensor_sink name=s")
        p.start()

        def push(v):
            p["in"].push_buffer(pkg.Buffer.from_arrays(
                [np.full(4, v, np.uint8)]))
        push(1)
        _wait(lambda: backend.calls >= 1)
        backend.broken = True
        for v in range(2, 7):  # 3 invoke failures open; 2 more are shed
            push(v)
        _wait(lambda: p["f"].stats["shed"] >= 2)
        mid = (p["f"].stats["invoke_errors"], p["f"].stats["shed"],
               p["f"].stats["breaker_opened"], p["f"]._breaker.state)
        backend.broken = False
        time.sleep(0.15)  # past breaker-reset-ms: half-open
        push(7)           # the probe: succeeds and closes the breaker
        _wait(lambda: p["f"]._breaker.state == "closed")
        push(8)
        p["in"].end_stream()
        p.wait_eos(timeout=30)
        st = p.stats()
        p.stop()
        return (mid, [int(b.chunks[0].host()[0]) for b in p["s"].buffers],
                {k: st["f"][k] for k in ("invoke_errors", "shed", "dropped",
                                         "breaker_opened", "frames_dropped")},
                _warnings(p, "f"))

    def test_open_shed_halfopen_close_cycle(self):
        nt_out, pt_out = _both(self._cycle)
        assert nt_out == pt_out
        mid, values, counters, _ = pt_out
        assert mid == (3, 2, 1, "open")
        # frames 1, 7, 8 delivered (y = 2x + 1)
        assert values == [3, 15, 17]

    def test_breaker_transition_posts_bus_warning(self):
        def run(pkg):
            backend = FLAKY[pkg]
            backend.broken = True
            p = pkg.parse_launch(
                f'appsrc name=in caps="{CAPS_U8}" ! '
                "tensor_filter name=f framework=torch_parity_flaky "
                "breaker-threshold=2 breaker-reset-ms=60000 ! tensor_sink")
            p.start()
            for v in range(3):
                p["in"].push_buffer(pkg.Buffer.from_arrays(
                    [np.full(4, v, np.uint8)]))
            _wait(lambda: p["f"].stats["shed"] >= 1)
            msgs = [m.data for m in p.bus.drain() if m.kind == "warning"
                    and m.data.get("breaker") == "open"]
            p["in"].end_stream()
            p.wait_eos(timeout=30)
            p.stop()
            backend.broken = False
            return [(d["breaker_from"], d["retry_after_ms"],
                     d["invoke_errors"]) for d in msgs]
        nt_msgs, pt_msgs = _both(run)
        assert nt_msgs == pt_msgs == [("closed", 50.0, 2)]


SIMLINK_CAPS = ("other/tensors,format=static,num_tensors=1,types=float32,"
                "dimensions=4,framerate=0/1")


def _simlink(pkg, n, custom, extra):
    return _run(pkg, f"tensortestsrc caps={SIMLINK_CAPS} num-buffers={n} "
                     "pattern=counter ! queue ! tensor_filter name=f "
                     f"framework=simlink custom={custom} {extra} ! "
                     "appsink name=out", timeout=60, fuse=False)


class TestAsyncBreaker:
    def test_restart_with_frames_in_flight_loses_nothing(self):
        """restart_element on a filter with an in-flight window, between
        frames: stop() settles and pushes every frame in flight before
        the backend closes, start() opens a new window, and every frame
        arrives once, in order, in both packages."""
        def run(pkg, fault_mod):
            p = PIPELINE[pkg]()
            filt = pkg.make_element("tensor_filter", name="f",
                                    framework="simlink", custom="rtt:5,svc:1",
                                    **{"in-flight": 4})
            sink = pkg.make_element("appsink", name="out")
            p.add(filt, sink)
            p.link(filt, sink)
            p.start()
            events = pkg.pipeline.events
            filt.chain(filt.sinkpad, events.CapsEvent(
                pkg.Caps(SIMLINK_CAPS)))
            for i in range(12):
                filt.chain(filt.sinkpad, pkg.Buffer.from_arrays(
                    [np.full(4, i, np.float32)], pts=i))
                if i in (3, 7):
                    fault_mod.restart_element(filt)
            filt.chain(filt.sinkpad, events.EosEvent())
            assert p.wait_eos(30)
            p.stop()
            return ([b.pts for b in sink.buffers],
                    [float(b.chunks[0].host()[0]) for b in sink.buffers],
                    filt.stats["invoke_errors"])
        nt_out, pt_out = (run(pkg, f) for pkg, f in zip(PKGS, FAULTS))
        assert nt_out == pt_out
        assert pt_out == (list(range(12)), [2.0 * i + 1 for i in range(12)],
                          0)

    def test_zero_loss_accounting_with_completion_failures(self):
        """fail-every=5 raises inside completion with frames in flight:
        every frame settles exactly once, the same in both packages."""
        def run(pkg):
            p = _simlink(pkg, 20, "rtt:20,svc:1,fail-every:5",
                         "in-flight=8 breaker-threshold=100")
            st = p["f"].stats.snapshot()
            rep = p["f"].transfer_report()
            return ([b.pts for b in p["out"].buffers],
                    {k: st[k] for k in ("invoke_errors", "frames_dropped",
                                        "shed", "breaker_opened")},
                    rep["errors"], rep["completed"], rep["reorder"]["skipped"])
        nt_out, pt_out = _both(run)
        assert nt_out == pt_out
        assert len(pt_out[0]) == 16 and pt_out[1]["invoke_errors"] == 4

    def test_breaker_opens_and_sheds_with_frames_in_flight(self):
        """Every completion fails: the breaker opens from the completer
        thread's accounting and sheds the backlog. When it opens against
        the frames in flight depends on thread timing, so both packages
        are held to the reference's invariants."""
        for pkg in PKGS:
            p = _simlink(pkg, 20, "rtt:5,svc:1,fail-every:1",
                         "in-flight=4 breaker-threshold=3")
            st = p["f"].stats.snapshot()
            assert p["out"].buffers == []
            assert st["breaker_opened"] >= 1
            assert st["frames_dropped"] + st["qos_dropped"] + st["shed"] \
                == 20
            assert st["shed"] >= 1
            assert st["invoke_errors"] == st["frames_dropped"]


# --------------------------------------------------- segment faults

def _device_elements(pkg_element, transient_cls):
    class BoomDevice(pkg_element.TransformElement):
        """Fuses, then its device program raises on every call (the JAX
        program: at every trace; the port's on the CPU: at every call),
        or with ``fail-first=k`` on its first k calls only, with a
        TransientError."""

        PROPS = {"breaker-threshold": 0, "breaker-reset-ms": 1000.0,
                 "breaker-retry-after-ms": 100.0, "fail-first": 0}

        def __init__(self, name=None, **props):
            super().__init__(name, **props)
            self.calls = 0

        def transform(self, buf):
            return buf

        def device_fn(self, ctx=None):
            def fn(arrays):
                self.calls += 1
                limit = int(self.fail_first)
                if limit <= 0:
                    raise RuntimeError("injected device fault")
                if self.calls <= limit:
                    raise transient_cls("injected device fault")
                return [a + 1 for a in arrays]
            return fn

    class PassDevice(pkg_element.TransformElement):
        def transform(self, buf):
            return buf

        def device_fn(self, ctx=None):
            return lambda arrays: arrays

    return BoomDevice, PassDevice


DEVICE = {nt: _device_elements(nt_element, nt_fault.TransientError),
          pt: _device_elements(pt_element, pt_fault.TransientError)}
PIPELINE = {nt: NtPipeline, pt: PtPipeline}
SEGMENT = {nt: NtSegment, pt: PtSegment}


def _boom_run(pkg, n=4, **boom_props):
    boom_cls, pass_cls = DEVICE[pkg]
    p = PIPELINE[pkg]()
    src = pkg.make_element("tensortestsrc", name="src")
    src.set_property("caps", CAPS_F32)
    src.set_property("num-buffers", n)
    sink = pkg.make_element("appsink", name="out")
    boom = boom_cls(name="boom", **boom_props)
    ok = pass_cls(name="ok", on_error=str(boom_props.get("on_error",
                                                         "fail")))
    p.add(src, boom, ok, sink)
    p.link(src, boom, ok, sink)
    p.start()
    try:
        p.wait_eos(timeout=30)
    finally:
        p.stop()
    segs = [e for e in p.elements.values() if isinstance(e, SEGMENT[pkg])]
    assert len(segs) == 1
    st = segs[0].stats.snapshot()
    return ([b.pts for b in p["out"].buffers],
            {k: st[k] for k in ("dropped", "shed", "breaker_opened",
                                "restarts", "retries")})


class TestSegmentFaults:
    def test_device_fault_escalates_under_default_policy(self):
        for pkg in PKGS:
            with pytest.raises(RuntimeError, match="injected device fault"):
                _boom_run(pkg)

    def test_skip_policy_drops_faulted_frames(self):
        nt_out, pt_out = _both(lambda pkg: _boom_run(pkg, on_error="skip"))
        assert nt_out == pt_out
        assert pt_out[0] == [] and pt_out[1]["dropped"] == 4

    def test_breaker_opens_and_sheds(self):
        nt_out, pt_out = _both(lambda pkg: _boom_run(
            pkg, n=8, on_error="skip", **{"breaker-threshold": 2}))
        assert nt_out == pt_out
        assert pt_out[1]["breaker_opened"] == 1
        assert pt_out[1]["shed"] == 6 and pt_out[1]["dropped"] == 8

    def test_restart_recaptures_with_zero_loss(self):
        """The program fails on its first run (JAX: the trace; the port:
        the call, which on the card is the capture); one restart of the
        segment re-runs the frame and every frame arrives."""
        nt_out, pt_out = _both(lambda pkg: _boom_run(
            pkg, n=6, on_error="restart(8,30)", **{"fail-first": 1}))
        assert nt_out == pt_out
        assert pt_out[0] == list(range(6)) and pt_out[1]["restarts"] == 1

    def test_restart_escalates_when_the_rerun_fails_too(self):
        """restart re-runs the failing frame once: a program that fails
        twice in a row escalates, in both packages."""
        for pkg, f in zip(PKGS, FAULTS):
            with pytest.raises(f.TransientError):
                _boom_run(pkg, n=6, on_error="restart(8,30)",
                          **{"fail-first": 2})

    def test_retry_after_failed_programs(self):
        nt_out, pt_out = _both(lambda pkg: _boom_run(
            pkg, n=5, on_error="retry(3,0.001)", **{"fail-first": 2}))
        assert nt_out == pt_out
        assert pt_out[0] == list(range(5)) and pt_out[1]["retries"] == 2


# ---------------------------------------------- graph pools across restarts

class TestGraphPoolLifetime:
    """The port's own rule, with no counterpart in the reference (XLA owns
    its buffers): the element owns its CUDA-graph pool across its
    restarts, and Pipeline.stop frees it once. On the CPU a pool is never
    made on a card, so the tests follow the objects and the release
    calls."""

    @pytest.fixture
    def releases(self, monkeypatch):
        from nnstreamer_tpu_torch.filters.executable import GraphPool
        seen = []
        release = GraphPool.release

        def spy(pool):
            seen.append(pool)
            release(pool)
        monkeypatch.setattr(GraphPool, "release", spy)
        return seen

    def test_filter_hands_one_pool_to_every_backend(self, releases):
        """Three backends, one pool: restarts release nothing, the
        element's teardown releases the pool."""
        p = pt.parse_launch(
            f"tensortestsrc caps={CAPS_U8} num-buffers=1 ! tensor_filter "
            "name=f framework=torch-cuda accelerator=true:cpu "
            'model="zoo://mobilenet_v2?width=0.35&size=96" ! fakesink')
        filt = p["f"]
        filt.start()
        pool, backends = filt._graph_pool, [filt.fw]
        for _ in range(2):
            pt_fault.restart_element(filt)
            backends.append(filt.fw)
        assert len({id(b) for b in backends}) == 3
        assert all(b is not None for b in backends)
        assert filt.fw._pool is pool and releases == []
        filt.stop()
        filt.teardown()
        assert releases == [pool]

    def test_pipeline_stop_releases_each_pool_once(self, releases):
        p = _run(pt, f"tensortestsrc caps={MN_CAPS} num-buffers=3 ! "
                     "tensor_filter name=f framework=torch-cuda "
                     "accelerator=true:cpu "
                     'model="zoo://mobilenet_v2?width=0.35&size=96" ! '
                     "fakesink", fuse=False)
        assert releases == [p["f"]._graph_pool]

    def test_segment_keeps_its_pool_across_restarts(self, releases):
        """A restart of the fused segment releases nothing; the stop
        releases the segment's one pool."""
        _boom_run(pt, n=6, on_error="restart(8,30)", **{"fail-first": 1})
        assert len(releases) == 1

    def test_backend_opened_alone_releases_its_own_pool(self, releases):
        from nnstreamer_tpu_torch.filters.base import (Accelerator,
                                                       FilterProperties)
        from nnstreamer_tpu_torch.filters.torch_cuda_backend import \
            TorchCudaFilter
        fw = TorchCudaFilter()
        fw.open(FilterProperties(
            framework="torch-cuda", accelerators=(Accelerator.CPU,),
            model_files=("zoo://mobilenet_v2?width=0.35&size=96",)))
        pool = fw._pool
        fw.close()
        fw.close()
        assert releases == [pool]


# --------------------------------------------------- the MobileNet-v2 line

MN_CAPS = ("other/tensors,format=static,num_tensors=1,types=(string)uint8,"
           "dimensions=(string)3:96:96,framerate=(fraction)0/1")
MN_FRAMES = 7
# tests/test_torch_mobilenet.py's bf16 bound: both round every conv and
# BatchNorm output to bf16 (observed ~1e-6 apart)
MN_ATOL = 2e-2

MN_JAX_PY = '''
import numpy as np
from nnstreamer_tpu.models import zoo


def get_model():
    apply_fn, _, in_info, out_info = zoo.build(
        "mobilenet_v2", width="0.35", size="96")
    flat = np.load({npz!r})
    tree = {{}}
    for key in flat.files:
        *path, leaf = key.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {{}})
        node[leaf] = flat[key]
    return apply_fn, tree, in_info, out_info
'''

MN_PORT_PY = '''
import numpy as np
from nnstreamer_tpu_torch.models.convert import mobilenet_params_from_jax
from nnstreamer_tpu_torch.models.mobilenet import MobileNetV2, make_apply
from nnstreamer_tpu_torch.tensors.info import TensorsInfo


def get_model():
    flat = np.load({npz!r})
    tree = {{}}
    for key in flat.files:
        *path, leaf = key.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {{}})
        node[leaf] = flat[key]
    model = MobileNetV2(num_classes=1001, width=0.35)
    model.load_state_dict(mobilenet_params_from_jax(tree))
    return (make_apply(False), model, TensorsInfo.make("uint8", "3:96:96"),
            TensorsInfo.make("float32", "1001"))
'''


@pytest.fixture(scope="module")
def mobilenet_models(tmp_path_factory):
    """One set of MobileNet-v2 variables (width 0.35, 96x96, BatchNorm
    statistics drawn from a numpy seed) served to both packages."""
    tmp = tmp_path_factory.mktemp("mobilenet_fault")
    _, variables, _, _ = jax_zoo.build("mobilenet_v2", width="0.35",
                                       size="96")
    rng = np.random.default_rng(21)
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            jax.device_get(variables))[0]:
        key = "/".join(str(k.key) for k in path)
        leaf = np.asarray(leaf)
        if key.endswith("/mean"):
            leaf = rng.normal(0.0, 0.5, leaf.shape).astype(np.float32)
        elif key.endswith("/var"):
            leaf = rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)
        flat[key] = leaf
    npz = tmp / "mobilenet.npz"
    np.savez(npz, **flat)
    jax_py, port_py = tmp / "mobilenet_jax.py", tmp / "mobilenet_port.py"
    jax_py.write_text(MN_JAX_PY.format(npz=str(npz)))
    port_py.write_text(MN_PORT_PY.format(npz=str(npz)))
    return str(jax_py), str(port_py)


def test_mobilenet_line_skips_the_same_frames(mobilenet_models):
    """bench.py's headline line shape at width 0.35 and 96x96, with a
    tensor_fault raising on every 3rd frame under on-error=skip between
    the source and the filter."""
    jax_py, port_py = mobilenet_models
    src = (f"tensortestsrc caps={MN_CAPS} pattern=random seed={SEED} "
           f"num-buffers={MN_FRAMES} ! queue max-size-buffers=8 ! "
           "tensor_fault name=flt mode=raise every=3 on-error=skip ! ")
    tail = "prefetch-host=true ! queue max-size-buffers=32 ! appsink name=out"
    jpipe = _run(nt, f"{src} tensor_filter name=f framework=jax "
                     f"model={jax_py} {tail}", timeout=120)
    ppipe = _run(pt, f"{src} tensor_filter name=f framework=torch-cuda "
                     f"accelerator=true:cpu model={port_py} {tail}",
                 timeout=120)
    assert [b.pts for b in ppipe["out"].buffers] == \
        [b.pts for b in jpipe["out"].buffers]
    assert len(ppipe["out"].buffers) == MN_FRAMES - MN_FRAMES // 3
    assert ppipe.stats()["flt"]["dropped"] == \
        jpipe.stats()["flt"]["dropped"] == MN_FRAMES // 3
    want = np.stack([b.chunks[0].host() for b in jpipe["out"].buffers])
    got = np.stack([b.chunks[0].host() for b in ppipe["out"].buffers])
    np.testing.assert_allclose(got, want, rtol=0, atol=MN_ATOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
