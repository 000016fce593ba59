"""The port's elastic fleet (nnstreamer_tpu_torch/fleet/) against the JAX
package's, on the CPU.

Mirrors tests/test_fleet.py:

* ``TestCompileCache`` — the signature registry's round trip, a torn
  registry starting cold, the ``NNS_COMPILE_CACHE`` inheritance, and
  the file format shared with the JAX package: a JAX-written registry
  read by the port and the reverse, dtypes spelled by their NumPy names;
* ``TestLifecycleIdentity`` — every scenario of the reference (spawn,
  retire, spawn failure, death and resurrection, scale up to the cap,
  drain-then-preempt scale-down, hold, floor repair, blue/green, stop)
  driven through ``Autoscaler.step()`` with the same fake replica
  processes and fake router in both packages: the lifecycle snapshots,
  replica states and scale decisions after every step are equal
  (tolerance: none, integer counters), and the
  ``fleet-replica-lifecycle`` identity holds in both;
* ``TestAutoscalerElement`` — the inert element, the declared identity,
  the reference's properties;
* real subprocess replicas of the port on the CPU (a tiny MLP): the
  child runs ``nnstreamer_tpu_torch.fleet.replica_main`` and imports no
  JAX; a warm replica captured its recorded signature at open and
  captured nothing on a frame (read from the backend's counters, not a
  clock), while a cold one captured on its first frame; and the reduced
  SIGTERM arm — 2 replicas behind a router, one SIGTERM mid-traffic,
  the victim snapshots and resurrects, every request answered exactly
  once, and both the router's and the fleet's identities hold.
"""
import json
import os
import random
import signal
import time

import numpy as np
import pytest
import torch

import nnstreamer_tpu_torch as pt
from nnstreamer_tpu.analysis.flow import \
    check_identities as nt_check_identities
from nnstreamer_tpu.fleet import autoscaler as nt_autoscaler
from nnstreamer_tpu.fleet import cache as nt_cache
from nnstreamer_tpu.fleet import BlueGreenRollout as NtBlueGreenRollout
from nnstreamer_tpu_torch import Buffer
from nnstreamer_tpu_torch.analysis.flow import check_identities
from nnstreamer_tpu_torch.checkpoint import SnapshotStore
from nnstreamer_tpu_torch.edge.broker import DiscoveryBroker
from nnstreamer_tpu_torch.fleet import (Autoscaler, AutoscalerConfig,
                                        BlueGreenRollout, CompileCache,
                                        ReplicaProcess, ReplicaSpec)
from nnstreamer_tpu_torch.fleet import autoscaler as pt_autoscaler
from nnstreamer_tpu_torch.fleet import cache as cache_mod
from nnstreamer_tpu_torch.fleet import replica as replica_mod
from nnstreamer_tpu_torch.fleet.autoscaler import (DRAINING, RESURRECTING,
                                                   SERVING)
from nnstreamer_tpu_torch.models import zoo

CAPS4 = ('other/tensors,format=static,num_tensors=1,'
         'types=(string)float32,dimensions=(string)4')
MLP4 = "zoo://mlp?in_dim=4&hidden=8&out_dim=4&dtype=float32"
MLP_ATOL = 1e-6   # the replica's f32 MLP against the same module here


def _wait_for(pred, timeout=30):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


@pytest.fixture(autouse=True)
def _no_inherited_cache(monkeypatch):
    """No test leaves a compile cache installed or exported."""
    monkeypatch.delenv(cache_mod.ENV_VAR, raising=False)
    cache_mod.deactivate()
    yield
    cache_mod.deactivate()
    os.environ.pop(cache_mod.ENV_VAR, None)


# ------------------------------------------------- compile cache registry

class TestCompileCache:
    SIG = (((1, 64), "float32"),)

    def test_record_dedup_and_reload(self, tmp_path):
        cc = CompileCache(str(tmp_path))
        assert cc.record("torch-cuda", "zoo://mlp", self.SIG) is True
        assert cc.record("torch-cuda", "zoo://mlp", self.SIG) is False
        # the same signature spelled by torch's dtype is the same entry
        assert cc.record("torch-cuda", "zoo://mlp",
                         (((1, 64), "torch.float32"),)) is False
        assert cc.record("torch-cuda", "zoo://mlp",
                         (((1, 64), torch.float32),)) is False
        assert cc.record("torch-cuda", "zoo://mlp", self.SIG,
                         donate=(1,)) is True
        cc2 = CompileCache(str(tmp_path))
        assert cc2.signatures("torch-cuda", "zoo://mlp") == \
            [(self.SIG, ()), (self.SIG, (1,))]
        assert cc2.signatures("fusion", "zoo://mlp") == []
        assert cc2.kinds() == ["torch-cuda"]
        assert cc2.entry_count() == 2

    def test_corrupt_registry_starts_cold(self, tmp_path):
        cc = CompileCache(str(tmp_path))
        cc.record("torch-cuda", "m", self.SIG)
        snap = SnapshotStore(str(tmp_path)).latest()
        with open(os.path.join(snap, "signatures.json"), "w") as f:
            f.write("not json {")
        # torn registry costs warmup, never correctness
        assert CompileCache(str(tmp_path)).signatures("torch-cuda",
                                                      "m") == []

    def test_install_active_env_inheritance(self, tmp_path):
        assert cache_mod.active() is None
        cc = cache_mod.install(str(tmp_path))
        assert os.environ[cache_mod.ENV_VAR] == str(tmp_path)
        assert cache_mod.active() is cc
        # a "child" process: nothing installed, env points the way
        cache_mod.deactivate()
        assert cache_mod.active() is not None
        assert cache_mod.active().root == str(tmp_path)

    @pytest.mark.parametrize("writer", ["jax", "torch"])
    def test_either_package_reads_the_others_registry(self, tmp_path,
                                                      writer):
        sigs = [(((8, 224, 224, 3), "uint8"),),
                (((1, 64), "float32"), ((1,), "int32")),
                (((2, 16), "bfloat16"),)]
        mods = {"jax": nt_cache, "torch": cache_mod}
        w = mods[writer].CompileCache(str(tmp_path))
        for s in sigs:
            w.record("jax", "zoo://mlp|mesh=", s)
            w.record("fusion", "f+d", s)
        reader = mods["torch" if writer == "jax" else "jax"]
        r = reader.CompileCache(str(tmp_path))
        assert r.signatures("jax", "zoo://mlp|mesh=") == \
            [(s, ()) for s in sigs]
        assert r.signatures("fusion", "f+d") == [(s, ()) for s in sigs]
        snap = SnapshotStore(str(tmp_path)).latest()
        SnapshotStore.verify(snap)
        with open(os.path.join(snap, "signatures.json")) as f:
            data = json.load(f)
        assert data["fusion:f+d"][2] == {"sig": [[[2, 16], "bfloat16"]],
                                         "donate": []}

    def test_canonical_dtype_spellings(self):
        for spelled in (torch.float32, "torch.float32", "<f4", np.float32,
                        "float32", "single"):
            assert cache_mod.canon_dtype(spelled) == "float32"
        assert cache_mod.canon_dtype(torch.bfloat16) == "bfloat16"
        assert cache_mod.canon_dtype(torch.uint8) == \
            nt_cache.canon_dtype(np.uint8) == "uint8"
        assert cache_mod.torch_dtype("bfloat16") is torch.bfloat16
        with pytest.raises(ValueError):
            cache_mod.torch_dtype("complex_thing")

    def test_backend_records_and_prewarms_its_signatures(self, tmp_path):
        """A signature captured in one life is captured at open in the
        next, before any frame: ``prewarmed`` 1 and ``compile_count`` 1
        at open, and the first frame of that signature makes nothing."""
        from nnstreamer_tpu_torch.filters import (Accelerator,
                                                  FilterProperties,
                                                  find_filter)
        props = FilterProperties(framework="torch-cuda",
                                 model_files=(MLP4,),
                                 accelerators=(Accelerator.CPU,))
        cache_mod.install(str(tmp_path))
        first = find_filter("torch-cuda")()
        first.open(props)
        assert (first.prewarmed, first.compile_count) == (0, 0)
        x = np.ones((2, 4), np.float32)
        want = first.invoke([x])[0]
        first.close()
        assert CompileCache(str(tmp_path)).signatures(
            "torch-cuda", MLP4) == [((((2, 4), "float32"),), ())]
        warm = find_filter("torch-cuda")()
        warm.open(props)
        assert (warm.prewarmed, warm.compile_count) == (1, 1)
        got = warm.invoke([x])[0]
        assert warm.compile_count == 1
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        warm.close()

    def test_prewarm_counts_what_it_warmed_and_skips_stale_entries(
            self, tmp_path):
        """``prewarm`` hands ``run`` zeros of each recorded signature,
        counts the ones it warmed, and a signature that fails costs only
        itself; without a cache (or a key) it runs nothing."""
        seen = []

        def run(xs):
            seen.append([(tuple(x.shape), x.dtype) for x in xs])
            assert all(not x.any() for x in xs)
            if xs[0].shape == (3,):
                raise RuntimeError("stale")
            return xs[0].shape != (2, 4)      # (2, 4) is already warm

        assert cache_mod.prewarm("torch-cuda", "m", run, "t") == 0
        cc = cache_mod.install(str(tmp_path))
        for sig in ((((2, 4), "float32"),), (((3,), "uint8"),),
                    (((1, 8), "bfloat16"), ((1,), "int32"))):
            cc.record("torch-cuda", "m", sig)
        assert cache_mod.prewarm("torch-cuda", "", run, "t") == 0
        assert seen == []
        assert cache_mod.prewarm("torch-cuda", "m", run, "t") == 1
        assert seen == [[((2, 4), torch.float32)], [((3,), torch.uint8)],
                        [((1, 8), torch.bfloat16), ((1,), torch.int32)]]
        assert cache_mod.prewarm("fusion", "m", run, "t") == 0

    def test_record_quietly_never_fails_the_caller(self, tmp_path,
                                                   monkeypatch):
        sig = (((1, 4), "float32"),)
        cache_mod.record_quietly("fusion", "a+b", sig, "t")   # no cache
        cc = cache_mod.install(str(tmp_path))
        cache_mod.record_quietly("fusion", "a+b", sig, "t")
        assert cc.signatures("fusion", "a+b") == [(sig, ())]

        def broken(*args, **kwargs):
            raise OSError("read-only")

        monkeypatch.setattr(cc, "record", broken)
        cache_mod.record_quietly("fusion", "a+b", sig, "t")


# ---------------------------------------- lifecycle identity (fake procs)

class _FakeProc:
    """Deterministic stand-in for ReplicaProcess: same constructor and
    surface, no subprocess. Class state is reset per package run."""

    instances = []
    fail_next_spawn = False
    _next_port = 9000

    def __init__(self, spec, ident, port=0, version=None, restore=False):
        self.spec = spec
        self.ident = ident
        if not port:
            _FakeProc._next_port += 1
            port = _FakeProc._next_port
        self.port = int(port)
        self.version = spec.version if version is None else str(version)
        self.restore = bool(restore)
        self.dead = False
        self.was_preempted = False
        self.preempt_report = None
        _FakeProc.instances.append(self)

    @property
    def ckpt_dir(self):
        return os.path.join(self.spec.ckpt_root, self.ident)

    def key(self, host="localhost"):
        return f"{host}:{self.port}"

    def spawn(self):
        if _FakeProc.fail_next_spawn:
            _FakeProc.fail_next_spawn = False
            raise RuntimeError("injected spawn failure")
        return self

    def wait_ready(self, timeout=None):
        return self.port

    def alive(self):
        return not self.dead

    def ready(self):
        return not self.dead

    def preempt(self, timeout=30.0):
        self.was_preempted = True
        self.dead = True
        self.preempt_report = {"drained": 0, "abandoned": 0}
        return self.preempt_report

    def kill(self):
        self.dead = True


class _FakeRouter:
    """report()/drain_replica() surface mirroring the autoscaler's
    replica set, with an injectable p95 signal."""

    def __init__(self):
        self.p95_us = 0.0
        self.depth = 0
        self.drained = []
        self.auto = None

    def report(self):
        out = {}
        if self.auto is not None:
            with self.auto._lock:
                reps = list(self.auto._replicas.values())
            for rp in reps:
                out[rp.key()] = {
                    "state": "healthy", "in_flight": 0,
                    "load": {"queue_delay_us_p95": self.p95_us,
                             "depth": self.depth}}
        return out

    def drain_replica(self, key):
        self.drained.append(key)
        return True


# package -> (autoscaler module, rollout class, identity check)
PACKAGES = {
    "jax": (nt_autoscaler, NtBlueGreenRollout, nt_check_identities),
    "torch": (pt_autoscaler, BlueGreenRollout, check_identities),
}


class _Fleet:
    """One package's autoscaler over the fakes, plus the trace of what
    it did: after each :meth:`mark`, the lifecycle counters, each
    replica's state, version and port, and the fakes' preemptions."""

    def __init__(self, pkg, tmp_path, monkeypatch):
        self.mod, self.rollout, self._check = PACKAGES[pkg]
        monkeypatch.setattr(self.mod, "ReplicaProcess", _FakeProc)
        _FakeProc.instances = []
        _FakeProc.fail_next_spawn = False
        _FakeProc._next_port = 9000
        self.spec = self.mod.ReplicaSpec(desc_template="unused",
                                         ckpt_root=str(tmp_path / pkg))
        self.trace = []
        self.auto = None

    def mk(self, router=None, **cfg_kw):
        self.auto = self.mod.Autoscaler(
            self.spec, router=router,
            config=self.mod.AutoscalerConfig(**cfg_kw), name="t")
        if isinstance(router, _FakeRouter):
            router.auto = self.auto
        return self.auto

    def check(self):
        self.auto.check()
        self._check(self.auto.lifecycle(),
                    names=["fleet-replica-lifecycle"])

    def mark(self):
        self.check()
        auto = self.auto
        reps = sorted((i, s, auto.handle(i).version, auto.handle(i).port)
                      for i, s in auto.replicas().items())
        self.trace.append((auto.lifecycle(), reps,
                           [(p.ident, p.was_preempted, p.dead, p.restore)
                            for p in _FakeProc.instances]))


def sc_spawn_then_retire_balances(f):
    auto = f.mk()
    ident = auto.spawn_replica()
    f.mark()
    assert auto.replicas() == {ident: SERVING}
    assert auto.retire_replica(ident, sync=True)
    f.mark()
    life = auto.lifecycle()
    assert (life["replicas_spawned"], life["replicas_retired"],
            life["replicas_serving"], life["replicas_draining"]) == \
        (1, 1, 0, 0)
    assert _FakeProc.instances[0].was_preempted  # SIGTERM, not kill


def sc_spawn_failure_books_retired(f):
    auto = f.mk()
    _FakeProc.fail_next_spawn = True
    with pytest.raises(RuntimeError):
        auto.spawn_replica()
    f.mark()
    assert auto.lifecycle()["replicas_retired"] == 1
    assert auto.replicas() == {}


def sc_unexpected_death_resurrects(f):
    auto = f.mk()
    ident = auto.spawn_replica()
    corpse = auto.handle(ident)
    corpse.dead = True
    auto.step()  # reap: the corpse retires, a restore-spawn begins
    f.mark()
    life = auto.lifecycle()
    assert (life["resurrections"], life["replicas_spawned"],
            life["replicas_retired"]) == (1, 2, 1)
    reborn = auto.handle(ident)
    assert reborn is not corpse and reborn.restore
    assert reborn.port == corpse.port  # same endpoint
    auto.step()
    f.mark()
    assert auto.replicas() == {ident: SERVING}


def sc_death_without_resurrect_stays_down(f):
    auto = f.mk(resurrect=False, min_replicas=0)
    ident = auto.spawn_replica()
    auto.handle(ident).dead = True
    auto.step()
    f.mark()
    assert auto.replicas() == {}
    assert auto.lifecycle()["replicas_retired"] == 1


def sc_scale_up_on_high_p95_until_max(f):
    rt = _FakeRouter()
    auto = f.mk(router=rt, max_replicas=3, target_delay_ms=50.0,
                scale_up_cooldown_s=0.0)
    auto.spawn_replica()
    rt.p95_us = 200_000.0  # 200ms >> 50ms target
    for _ in range(5):
        auto.step()
        f.mark()
    life = auto.lifecycle()
    assert life["replicas_serving"] == 3  # capped at max
    assert life["scale_ups"] == 2


def sc_scale_down_drains_then_preempts(f):
    rt = _FakeRouter()
    auto = f.mk(router=rt, min_replicas=1, max_replicas=4,
                scale_down_cooldown_s=0.0, drain_deadline_ms=200.0)
    for _ in range(2):
        auto.spawn_replica()
    rt.p95_us = 0.0  # idle: under low water
    auto.step()
    assert auto.lifecycle()["scale_downs"] == 1
    # the async drain worker preempts; the loop reaps the exit
    assert _wait_for(
        lambda: (auto.step() or True)
        and auto.lifecycle()["replicas_retired"] == 1, timeout=10)
    f.mark()
    assert len(rt.drained) == 1  # router settled BEFORE the SIGTERM
    assert auto.lifecycle()["replicas_serving"] == 1
    auto.step()  # at the floor: no further scale-down
    f.mark()
    assert auto.lifecycle()["scale_downs"] == 1


def sc_hold_scaling_suspends_control_law(f):
    rt = _FakeRouter()
    auto = f.mk(router=rt, min_replicas=1, max_replicas=4,
                scale_down_cooldown_s=0.0, scale_up_cooldown_s=0.0)
    for _ in range(2):
        auto.spawn_replica()
    with auto.hold_scaling():
        rt.p95_us = 0.0  # would scale down...
        auto.step()
        rt.p95_us = 500_000.0  # ...or up
        auto.step()
        f.mark()
        life = auto.lifecycle()
        assert life["scale_downs"] == 0 and life["scale_ups"] == 0
    auto.step()  # released: the control law acts again
    f.mark()
    assert auto.lifecycle()["scale_ups"] == 1


def sc_floor_repair(f):
    auto = f.mk(min_replicas=2)
    auto.spawn_replica()
    auto.step()  # serving < min: repair without a cooldown gate
    f.mark()
    assert auto.lifecycle()["replicas_serving"] == 2


def sc_blue_green_rollout_replaces_ring(f):
    rt = _FakeRouter()
    auto = f.mk(router=rt)
    for _ in range(2):
        auto.spawn_replica(version="blue")
    f.mark()
    res = f.rollout(auto, "green", routable_timeout_s=5.0).run()
    f.mark()
    assert res["replaced"] == 2 and len(res["spawned"]) == 2
    states = auto.replicas()
    assert sorted(states.values()) == [SERVING, SERVING]
    for ident in states:
        assert auto.handle(ident).version == "green"
    life = auto.lifecycle()
    assert life["rollouts"] == 1 and life["replicas_retired"] == 2
    assert len(rt.drained) == 2  # every blue drained before its SIGTERM


def sc_stop_retires_everything(f):
    auto = f.mk()
    for _ in range(3):
        auto.spawn_replica()
    auto.stop()
    f.mark()
    life = auto.lifecycle()
    assert (life["replicas_serving"], life["replicas_draining"],
            life["replicas_resurrecting"], life["replicas_retired"]) == \
        (0, 0, 0, 3)


SCENARIOS = [sc_spawn_then_retire_balances, sc_spawn_failure_books_retired,
             sc_unexpected_death_resurrects,
             sc_death_without_resurrect_stays_down,
             sc_scale_up_on_high_p95_until_max,
             sc_scale_down_drains_then_preempts,
             sc_hold_scaling_suspends_control_law, sc_floor_repair,
             sc_blue_green_rollout_replaces_ring, sc_stop_retires_everything]


class TestLifecycleIdentity:
    @pytest.mark.parametrize("scenario", SCENARIOS,
                             ids=[s.__name__[3:] for s in SCENARIOS])
    def test_same_lifecycle_as_the_reference(self, scenario, tmp_path,
                                             monkeypatch):
        traces = {}
        for pkg in ("jax", "torch"):
            f = _Fleet(pkg, tmp_path, monkeypatch)
            scenario(f)
            assert f.trace, "the scenario marked no step"
            traces[pkg] = f.trace
        assert traces["torch"] == traces["jax"]

    def test_states_are_the_reference_vocabulary(self):
        assert (SERVING, DRAINING, RESURRECTING) == \
            (nt_autoscaler.SERVING, nt_autoscaler.DRAINING,
             nt_autoscaler.RESURRECTING)
        assert AutoscalerConfig() == AutoscalerConfig(
            **vars(nt_autoscaler.AutoscalerConfig()))


class TestAutoscalerElement:
    def test_inert_without_desc_template(self):
        # lintable/launchable with no replica recipe: the control plane
        # only engages when desc-template is set
        p = pt.parse_launch("tensor_autoscaler name=a router=rt")
        p.start()
        try:
            assert p["a"].autoscaler is None
            assert p["a"].session_info() == {}
        finally:
            p.stop()

    def test_identity_is_declared(self):
        from nnstreamer_tpu_torch.analysis.flow.registry import \
            identities_by_name
        ident = identities_by_name()["fleet-replica-lifecycle"]
        assert ident.expression == (
            "replicas_spawned == replicas_serving + replicas_draining "
            "+ replicas_retired + replicas_resurrecting")

    def test_properties_are_the_references(self):
        assert pt_autoscaler.TensorAutoscaler.PROPS == \
            nt_autoscaler.TensorAutoscaler.PROPS
        assert pt_autoscaler.TensorAutoscaler.SETTLEMENT_IDENTITY == \
            ("fleet-replica-lifecycle",)

    def test_live_autoscalers_render_fleet_gauges(self, tmp_path):
        from nnstreamer_tpu_torch.obs import metrics as obs_metrics
        spec = ReplicaSpec(desc_template="unused",
                           ckpt_root=str(tmp_path))
        auto = Autoscaler(spec, name="gauge-test")
        assert auto in pt_autoscaler.live_autoscalers()
        text = obs_metrics.render()
        for st in ("serving", "draining", "resurrecting"):
            assert (f'nns_fleet_replicas{{autoscaler="gauge-test",'
                    f'state="{st}"}} 0') in text
        assert ('nns_fleet_lifecycle_total{autoscaler="gauge-test",'
                'counter="replicas_spawned"} 0') in text
        del auto


# ------------------------------------------- real subprocess replicas

def _serve_desc(ident, extra=""):
    return ("tensor_serve_src name=src port={port} id=%d "
            "buckets=1,2,4 max-wait-ms=2 %s"
            "! tensor_filter framework=torch-cuda accelerator=true:cpu "
            "model=%s ! tensor_serve_sink id=%d" % (ident, extra, MLP4,
                                                    ident))


# prints the backend's counters: at open (after the cache's captures)
# and whenever a frame makes a new executable
COUNTERS_PRELUDE = """
import nnstreamer_tpu_torch.filters.torch_cuda_backend as _b
_open, _invoke = _b.TorchCudaFilter.open, _b.TorchCudaFilter.invoke
def _opened(self, props):
    _open(self, props)
    self._serving = True
    print(f"backend-open prewarmed={self.prewarmed} "
          f"compiles={self.compile_count}", flush=True)
def _invoked(self, inputs):
    n = self.compile_count
    out = _invoke(self, inputs)
    if getattr(self, "_serving", False) and self.compile_count != n:
        print(f"backend-frame-capture compiles={self.compile_count}",
              flush=True)
    return out
_b.TorchCudaFilter.open, _b.TorchCudaFilter.invoke = _opened, _invoked
import atexit, os, sys
def _modules():
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "flax", "nnstreamer_tpu"))
    print("replica-modules " + ",".join(bad), flush=True)
atexit.register(_modules)
_exit = os._exit
def _exit_after_atexit(code):
    atexit._run_exitfuncs()
    _exit(code)
os._exit = _exit_after_atexit
"""


def _mk_client(port, max_request=8):
    c = pt.parse_launch(
        f'appsrc name=in caps="{CAPS4}" '
        f"! tensor_query_client name=qc port={port} timeout=15 "
        f"max-request={max_request} ! appsink name=out")
    c.start()
    return c


def _push4(client, values):
    for v in values:
        client["in"].push_buffer(Buffer.from_arrays(
            [np.full(4, float(v), np.float32)]))


def _settled(client):
    return len(client["out"].buffers) + client["qc"].stats["shed"]


def _mlp_outputs(values):
    apply_fn, module, _i, _o = zoo.build(
        "mlp", in_dim="4", hidden="8", out_dim="4", dtype="float32")
    x = torch.tensor([[float(v)] * 4 for v in values])
    with torch.inference_mode():
        return apply_fn(module.eval(), x).numpy()


def _lines(rp, prefix):
    return [ln for ln in rp.tail(400).splitlines() if ln.startswith(prefix)]


def test_replica_child_is_the_ports_module(tmp_path):
    """The child process runs the port's replica_main from the port's
    repository root and never imports JAX or the JAX package."""
    spec = ReplicaSpec(desc_template=_serve_desc(95),
                       ckpt_root=str(tmp_path), grace_s=1.0,
                       prelude=COUNTERS_PRELUDE)
    rp = ReplicaProcess(spec, "argv-1")
    rp.spawn()
    try:
        rp.wait_ready(timeout=60)
        args = rp.proc.args
        assert args[1:3] == ["-m", "nnstreamer_tpu_torch.fleet.replica_main"]
        assert not any("nnstreamer_tpu.fleet" in a for a in args)
        assert replica_mod._repo_root() == os.path.dirname(
            os.path.dirname(os.path.abspath(pt.__file__)))
        report = rp.preempt(timeout=30)
        assert report is not None and report.get("snapshot")
        assert _wait_for(lambda: _lines(rp, "replica-modules"), 10), \
            rp.tail()
        assert _lines(rp, "replica-modules") == ["replica-modules "]
    finally:
        rp.kill()


def test_warm_replica_captures_its_signatures_at_open(tmp_path):
    """The compile cache earns its keep, read from counters: a warm
    replica captured its recorded bucket signature at open and captures
    nothing on its frames, while a cold replica captures on its first
    frame. One replica life seeds the cache first."""
    desc = _serve_desc(96).replace("buckets=1,2,4", "buckets=1")

    def run_life(spec, ident, n=6):
        rp = ReplicaProcess(spec, ident)
        rp.spawn()
        try:
            port = rp.wait_ready(timeout=60)
            c = _mk_client(port, max_request=1)
            try:
                for i in range(n):
                    _push4(c, [i])
                    assert _wait_for(lambda i=i: _settled(c) > i, 30)
                assert len(c["out"].buffers) == n
            finally:
                c["in"].end_stream()
                c.stop()
            rp.preempt(timeout=30)
            return (_lines(rp, "backend-open"),
                    _lines(rp, "backend-frame-capture"))
        finally:
            rp.kill()

    cold = ReplicaSpec(desc_template=desc, ckpt_root=str(tmp_path / "c"),
                       prelude=COUNTERS_PRELUDE)
    warm = ReplicaSpec(desc_template=desc, ckpt_root=str(tmp_path / "w"),
                       compile_cache=str(tmp_path / "cc"),
                       prelude=COUNTERS_PRELUDE)
    opened, captured = run_life(cold, "cold-1")
    assert opened == ["backend-open prewarmed=0 compiles=0"]
    assert captured == ["backend-frame-capture compiles=1"]
    run_life(warm, "warm-0")                     # seeds the registry
    assert CompileCache(str(tmp_path / "cc")).signatures(
        "torch-cuda", MLP4) == [((((1, 4), "float32"),), ())]
    opened, captured = run_life(warm, "warm-1")  # fresh process
    assert opened == ["backend-open prewarmed=1 compiles=1"]
    assert captured == []


def test_chaos_sigterm_zero_loss(tmp_path):
    """The reduced SIGTERM arm: two port replicas of a tiny MLP behind a
    router, 4 clients x 12 frames, one SIGTERM mid-traffic: the killed
    replica snapshots and resurrects, every request is answered exactly
    once with its frame's output (tolerance MLP_ATOL), and the router's
    and the fleet's identities hold."""
    rng = random.Random(1809)
    n_clients, n_frames = 4, 12
    broker = DiscoveryBroker(port=0)
    broker.start()
    topic = "elastic-chaos-torch"
    rp_pipe = pt.parse_launch(
        f"tensor_serve_router name=rt port=0 topic={topic} "
        f"dest-port={broker.bound_port} requery-ms=100 "
        "heartbeat-ms=50 breaker-reset-ms=300")
    rp_pipe.start()
    rt = rp_pipe["rt"]
    spec = ReplicaSpec(
        desc_template=_serve_desc(
            90, f"connect-type=HYBRID topic={topic} "
                f"dest-port={broker.bound_port} "),
        ckpt_root=str(tmp_path / "ckpt"), grace_s=1.5,
        prelude=COUNTERS_PRELUDE)
    auto = Autoscaler(spec, router=rt, config=AutoscalerConfig(
        min_replicas=2, max_replicas=3, interval_s=0.1,
        # this arm tests failover, not the control law: park the target
        # high so the kill is the only fleet event
        target_delay_ms=1e6), name="chaos")
    clients = []
    values = {tag: [100 * tag + i for i in range(n_frames)]
              for tag in range(n_clients)}
    try:
        auto.start()
        assert _wait_for(lambda: len(rt.router.replica_keys()) >= 2, 60)
        clients = [_mk_client(rt.bound_port) for _ in range(n_clients)]
        half = n_frames // 2
        for tag, c in enumerate(clients):
            _push4(c, values[tag][:half])
        for c in clients:
            assert _wait_for(lambda c=c: _settled(c) >= half, 60)
        serving = [i for i, s in auto.replicas().items() if s == SERVING]
        corpse = auto.handle(rng.choice(serving))
        os.kill(corpse.pid, signal.SIGTERM)  # external preemption
        assert _wait_for(lambda: auto.lifecycle()["resurrections"] >= 1, 60)
        assert _wait_for(
            lambda: auto.lifecycle()["replicas_serving"] >= 2
            and auto.lifecycle()["replicas_resurrecting"] == 0, 120)
        for tag, c in enumerate(clients):
            _push4(c, values[tag][half:])
        for c in clients:
            assert _wait_for(lambda c=c: _settled(c) >= n_frames, 60)
        for tag, c in enumerate(clients):
            st = c["qc"].stats.snapshot()
            want = _mlp_outputs(values[tag])
            got = [b.chunks[0].host() for b in c["out"].buffers]
            assert len(got) + st["shed"] == n_frames, (tag, st)
            assert st["session_declared_lost"] == 0, (tag, st)
            matched = [int(np.argmin(np.abs(want - g).max(axis=1)))
                       for g in got]
            assert len(set(matched)) == len(matched)   # none twice
            for g, m in zip(got, matched):
                np.testing.assert_allclose(g, want[m], rtol=0,
                                           atol=MLP_ATOL)
        assert _wait_for(lambda: corpse.preempt_report is not None, 30), \
            corpse.tail()
        assert corpse.preempt_report.get("snapshot")
        assert isinstance(corpse.preempt_report.get("abandoned"), dict)
        check_identities(rt.stats.snapshot(), names=["router-settlement"])
        auto.check()
        assert auto.lifecycle()["resurrections"] == 1
        assert rt.stats.snapshot()["router_requests"] == \
            n_clients * n_frames
    finally:
        for c in clients:
            try:
                c["in"].end_stream()
                c.stop()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
        auto.stop()
        rp_pipe.stop()
        broker.stop()
    auto.check()  # stop() retired the fleet through the same ledger
