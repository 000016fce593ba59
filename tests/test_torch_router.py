"""The port's fleet router (nnstreamer_tpu_torch/serve/router.py) against
the JAX package's, on the CPU.

Mirrors tests/test_router.py's ``TestHashRing``, ``TestParseReplicas``,
``TestRouterE2E``, ``TestBrokerFleet`` and ``TestFailoverRaces`` on the
port's router and serve replicas (``tensor_serve_src ! tensor_filter
framework=custom-easy ! tensor_serve_sink``). What only a two-package
run can show:

* ``HashRing.lookup`` maps 1,000 session keys to the same replica in
  both packages (sha1, not the salted builtin hash), before and after a
  member leaves;
* the router's pick (``FleetRouter._pick``: ring affinity, the
  least-loaded tiebreak over in-flight counts and PONG load reports,
  and the phase-aware pick of disaggregated LLM fleets) and
  ``decode_home`` are the JAX router's for the same seeded replica
  states, llm roles included;
* a router of one package fronts replicas of the other, and every
  settlement report passes the reference's ``router-settlement``
  identity (``nnstreamer_tpu.analysis.flow.check_identities``; the port
  does not import it);
* pipelint's ``router-no-replicas`` and ``router-affinity-sessionless``
  on the JAX rule tests' own lines, findings compared with the JAX
  package's.

Waits are on the router's own state (its replica report, its counters),
not on fixed sleeps. The reference's slow ``TestFleetChaos`` and
``TestRejoinResurrect`` need ``fleet/`` (ROADMAP item 13) and are not
mirrored.
"""
import socket
import threading
import time

import numpy as np
import pytest

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as pt
from nnstreamer_tpu.analysis import analyze as nt_analyze
from nnstreamer_tpu.analysis.flow import check_identities
from nnstreamer_tpu.filters import register_custom_easy as nt_register
from nnstreamer_tpu.serve import router as nt_router
from nnstreamer_tpu_torch.analysis import Severity, analyze
from nnstreamer_tpu_torch.edge.broker import DiscoveryBroker, discover_meta
from nnstreamer_tpu_torch.filters import register_custom_easy
from nnstreamer_tpu_torch.serve import router as pt_router
from nnstreamer_tpu_torch.serve.router import HashRing, parse_replicas

CAPS4 = ('other/tensors,format=static,num_tensors=1,'
         'types=(string)float32,dimensions=(string)4')


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module", autouse=True)
def _fleet_models():
    register_custom_easy("fleet_double", lambda x: x * 2)
    nt_register("fleet_double", lambda x: x * 2)
    yield


def _serve_pipeline(ident, port=0, broker_port=0, topic="", pkg=pt):
    hybrid = (f"connect-type=HYBRID topic={topic} dest-port={broker_port} "
              if topic else "")
    return pkg.parse_launch(
        f"tensor_serve_src name=src port={port} id={ident} buckets=1,2,4 "
        f"max-wait-ms=2 {hybrid}"
        "! tensor_filter framework=custom-easy model=fleet_double "
        f"! tensor_serve_sink id={ident}")


def _client_pipeline(port, max_request=8, pkg=pt):
    return pkg.parse_launch(
        f'appsrc name=in caps="{CAPS4}" '
        f"! tensor_query_client name=qc port={port} timeout=15 "
        f"max-request={max_request} ! appsink name=out")


def _push(client, values, pkg=pt):
    for v in values:
        client["in"].push_buffer(pkg.Buffer.from_arrays(
            [np.full(4, float(v), np.float32)]))


def _settled(client):
    return len(client["out"].buffers) + client["qc"].stats["shed"]


def _wait_for(pred, timeout=15):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return bool(pred())


def _wait_settled(client, want, timeout=30):
    _wait_for(lambda: _settled(client) >= want, timeout)
    return sorted(float(b.chunks[0].host()[0])
                  for b in client["out"].buffers)


def _all_healthy(rt, n):
    rep = rt.router_report()
    return len(rep) == n and all(r["state"] == "healthy" and r["pongs"] >= 1
                                 for r in rep.values())


# ------------------------------------------------------------------ ring

class TestHashRing:
    def test_lookup_is_deterministic_and_covers_members(self):
        r = HashRing()
        r.rebuild(["a:1", "b:2", "c:3"])
        picks = [r.lookup(f"s{i}") for i in range(200)]
        assert picks == [r.lookup(f"s{i}") for i in range(200)]
        assert set(picks) == {"a:1", "b:2", "c:3"}

    def test_member_loss_only_moves_its_own_keys(self):
        r = HashRing()
        r.rebuild(["a:1", "b:2", "c:3"])
        before = {f"s{i}": r.lookup(f"s{i}") for i in range(200)}
        r.rebuild(["a:1", "c:3"])
        for key, owner in before.items():
            if owner != "b:2":
                assert r.lookup(key) == owner
            else:
                assert r.lookup(key) in {"a:1", "c:3"}

    def test_empty_ring_returns_none(self):
        r = HashRing()
        r.rebuild([])
        assert r.lookup("anything") is None

    def test_stable_across_instances(self):
        a, b = HashRing(), HashRing()
        a.rebuild(["x:1", "y:2"])
        b.rebuild(["x:1", "y:2"])
        assert [a.lookup(f"k{i}") for i in range(50)] == \
            [b.lookup(f"k{i}") for i in range(50)]

    def test_lookup_is_the_reference_for_1000_keys(self):
        """1,000 seeded session keys over a seeded membership land on the
        same replica in both packages, before and after a member
        leaves."""
        rng = np.random.default_rng(5)
        members = [f"10.0.0.{int(rng.integers(1, 255))}:"
                   f"{int(rng.integers(1024, 65535))}" for _ in range(5)]
        keys = [f"sid-{int(rng.integers(0, 2 ** 62)):x}" for _ in range(1000)]
        for ms in (members, members[:2] + members[3:]):
            ours, ref = HashRing(), nt_router.HashRing()
            ours.rebuild(ms)
            ref.rebuild(ms)
            assert [ours.lookup(k) for k in keys] == \
                [ref.lookup(k) for k in keys]


class TestParseReplicas:
    def test_formats(self):
        assert parse_replicas("h1:1, h2:2;h3:3") == \
            [("h1", 1), ("h2", 2), ("h3", 3)]
        assert parse_replicas("") == []
        assert parse_replicas("  ") == []

    def test_rejects_garbage(self):
        with pytest.raises(ValueError):
            parse_replicas("no-port")


# ------------------------------------------------------ the pick, both

def _fleet(mod, state):
    """A never-started router of ``mod`` holding ``state``'s replicas:
    (key, live, draining, depth, llm_role), plus in-flight entries."""
    r = mod.FleetRouter(port=0)
    for key, live, draining, depth, role in state["replicas"]:
        host, _, port = key.rpartition(":")
        rep = mod._Replica(key, host, int(port), "static", 0.25, 3, 3, 1.0)
        rep.sock = object() if live else None
        rep.slock = threading.Lock()
        rep.draining = draining
        rep.load = {"depth": depth, **({"llm_role": role} if role else {})}
        r._replicas[key] = rep
    with r._rlock:
        r._rebuild_ring_locked()
    for i, key in enumerate(state["inflight"]):
        r._pending[i + 1] = [0, i, None, key, 0, None]
    return r


def _states(n):
    rng = np.random.default_rng(17)
    roles = ["", "prefill", "decode", "both"]
    for _ in range(n):
        k = int(rng.integers(1, 6))
        keys = [f"r{j}:{7000 + j}" for j in range(k)]
        roled = bool(rng.integers(0, 2))
        yield {"replicas": [(key, bool(rng.random() < 0.85),
                             bool(rng.random() < 0.15),
                             int(rng.integers(0, 9)),
                             roles[int(rng.integers(0, 4))] if roled else "")
                            for key in keys],
               "inflight": [keys[int(rng.integers(0, k))]
                            for _ in range(int(rng.integers(0, 12)))],
               "skey": (f"s{int(rng.integers(0, 10 ** 6))}"
                        if rng.random() < 0.8 else None),
               "affinity": bool(rng.random() < 0.7),
               "exclude": {keys[0]} if rng.random() < 0.2 else set()}


@pytest.mark.parametrize("phase", [None, "prompt", "decode"])
def test_pick_is_the_reference_for_the_same_loads(phase):
    """200 seeded fleet states (liveness, drains, PONG depths, in-flight
    counts, llm roles): the port's pick and decode home are the JAX
    router's."""
    for state in _states(200):
        picks = []
        for mod in (pt_router, nt_router):
            r = _fleet(mod, state)
            r.affinity = state["affinity"]
            snap = (r._pick(state["skey"], set(state["exclude"]), phase)
                    if phase else r._pick(state["skey"],
                                          set(state["exclude"])))
            home = (r.decode_home(state["skey"]) if state["skey"] else None)
            picks.append((snap[0] if snap else None, home,
                          r.assignment(state["skey"] or "x")))
        assert picks[0] == picks[1], state


# ------------------------------------------------------------ end-to-end

class TestRouterE2E:
    def test_round_trip_and_health(self):
        reps = [_serve_pipeline(60 + i) for i in range(2)]
        for sp in reps:
            sp.start()
        ports = [sp["src"].bound_port for sp in reps]
        rp = pt.parse_launch(
            f"tensor_serve_router name=rt port=0 "
            f"replicas=localhost:{ports[0]},localhost:{ports[1]} "
            "heartbeat-ms=50")
        rp.start()
        rt = rp["rt"]
        c = _client_pipeline(rt.bound_port)
        c.start()
        try:
            _push(c, range(8))
            assert _wait_settled(c, 8) == [2.0 * i for i in range(8)]
            st = rt.stats.snapshot()
            assert st["router_requests"] == 8
            assert st["router_delivered"] == 8
            assert st["router_shed"] == 0 and st["router_orphaned"] == 0
            check_identities(st, names=["router-settlement"])
            # heartbeats flowed: both replicas healthy with load reports
            assert _wait_for(lambda: _all_healthy(rt, 2))
            rep = rt.router_report()
            assert set(rep) == {f"localhost:{p}" for p in ports}
            for r in rep.values():
                assert r["breaker"] == "closed"
                assert "depth" in r["load"]
            for rob in rt.router._replicas.values():
                assert rob.sock.gettimeout() == rt.router.timeout
        finally:
            c["in"].end_stream()
            c.stop()
            rp.stop()
            for sp in reps:
                sp.stop()

    def test_affinity_pins_stream_to_one_replica(self):
        reps = [_serve_pipeline(62 + i) for i in range(2)]
        for sp in reps:
            sp.start()
        ports = [sp["src"].bound_port for sp in reps]
        rp = pt.parse_launch(
            f"tensor_serve_router name=rt port=0 affinity=true "
            f"replicas=localhost:{ports[0]},localhost:{ports[1]}")
        rp.start()
        c = _client_pipeline(rp["rt"].bound_port)
        c.start()
        try:
            _push(c, range(10))
            assert len(_wait_settled(c, 10)) == 10
            completed = [sp["src"].scheduler.report()["completed"]
                         for sp in reps]
            assert sorted(completed) == [0, 10]
        finally:
            c["in"].end_stream()
            c.stop()
            rp.stop()
            for sp in reps:
                sp.stop()

    def test_least_loaded_spreads_without_affinity(self):
        reps = [_serve_pipeline(64 + i) for i in range(2)]
        for sp in reps:
            sp.start()
        ports = [sp["src"].bound_port for sp in reps]
        rp = pt.parse_launch(
            f"tensor_serve_router name=rt port=0 affinity=false "
            f"replicas=localhost:{ports[0]},localhost:{ports[1]}")
        rp.start()
        c = _client_pipeline(rp["rt"].bound_port, max_request=16)
        c.start()
        try:
            _push(c, range(16))
            assert len(_wait_settled(c, 16)) == 16
            completed = [sp["src"].scheduler.report()["completed"]
                         for sp in reps]
            assert sum(completed) == 16 and min(completed) > 0
        finally:
            c["in"].end_stream()
            c.stop()
            rp.stop()
            for sp in reps:
                sp.stop()

    def test_empty_fleet_sheds_with_retry_after(self):
        rp = pt.parse_launch(
            f"tensor_serve_router name=rt port=0 "
            f"replicas=localhost:{_free_port()} retry-after-ms=20")
        rp.start()
        c = _client_pipeline(rp["rt"].bound_port)
        c.start()
        try:
            _push(c, range(4))
            assert _wait_for(lambda: c["qc"].stats["shed"] >= 4)
            assert c["qc"].stats["shed"] == 4
            assert c["out"].buffers == []
            st = rp["rt"].stats.snapshot()
            assert st["router_shed"] == 4 and st["router_requests"] == 4
        finally:
            c["in"].end_stream()
            c.stop()
            rp.stop()

    def test_failover_mid_stream_zero_loss(self):
        reps = [_serve_pipeline(66 + i) for i in range(2)]
        for sp in reps:
            sp.start()
        ports = [sp["src"].bound_port for sp in reps]
        rp = pt.parse_launch(
            f"tensor_serve_router name=rt port=0 "
            f"replicas=localhost:{ports[0]},localhost:{ports[1]} "
            "heartbeat-ms=50 breaker-reset-ms=200")
        rp.start()
        rt = rp["rt"]
        c = _client_pipeline(rt.bound_port)
        c.start()
        try:
            _push(c, range(4))
            assert len(_wait_settled(c, 4)) == 4
            loads = [sp["src"].scheduler.report()["completed"]
                     for sp in reps]
            victim = loads.index(max(loads))
            reps[victim].stop()
            key = f"localhost:{ports[victim]}"
            assert _wait_for(lambda: rt.router_report()[key]["state"]
                             in ("down", "connecting"))
            _push(c, range(4, 12))
            got = _wait_settled(c, 12)
            n_shed = c["qc"].stats["shed"]
            assert len(got) + n_shed == 12
            assert c["qc"].stats["session_declared_lost"] == 0
            assert set(got) <= {2.0 * i for i in range(12)}
            st = rt.stats.snapshot()
            assert st["router_replica_deaths"] >= 1
            check_identities(st, names=["router-settlement"])
            assert st["router_orphaned"] == 0
        finally:
            c["in"].end_stream()
            c.stop()
            rp.stop()
            for sp in reps:
                sp.stop()

    def test_kill_links_redispatches_with_zero_loss(self):
        """The chaos hook severs every replica link while frames are in
        flight: their pending entries fail over (redispatched), the
        links come back, and every frame settles once."""
        reps = [_serve_pipeline(80 + i) for i in range(2)]
        for sp in reps:
            sp.start()
        ports = [sp["src"].bound_port for sp in reps]
        rp = pt.parse_launch(
            f"tensor_serve_router name=rt port=0 "
            f"replicas=localhost:{ports[0]},localhost:{ports[1]} "
            "heartbeat-ms=50 breaker-reset-ms=50")
        rp.start()
        rt = rp["rt"]
        c = _client_pipeline(rt.bound_port, max_request=32)
        c.start()
        try:
            _push(c, range(16))
            assert rt.kill_link() == 2
            _push(c, range(16, 24))
            got = _wait_settled(c, 24)
            st = rt.stats.snapshot()
            assert len(got) + c["qc"].stats["shed"] == 24
            assert set(got) <= {2.0 * i for i in range(24)}
            assert len(set(got)) == len(got)
            check_identities(st, names=["router-settlement"])
            assert st["router_replica_deaths"] >= 1
        finally:
            c["in"].end_stream()
            c.stop()
            rp.stop()
            for sp in reps:
                sp.stop()

    def test_drain_replica_steers_sessions_elsewhere(self):
        reps = [_serve_pipeline(68 + i) for i in range(2)]
        for sp in reps:
            sp.start()
        ports = [sp["src"].bound_port for sp in reps]
        rp = pt.parse_launch(
            f"tensor_serve_router name=rt port=0 "
            f"replicas=localhost:{ports[0]},localhost:{ports[1]}")
        rp.start()
        rt = rp["rt"]
        c = _client_pipeline(rt.bound_port)
        c.start()
        try:
            _push(c, range(6))
            assert len(_wait_settled(c, 6)) == 6
            loads = [sp["src"].scheduler.report()["completed"]
                     for sp in reps]
            pinned = loads.index(max(loads))
            assert rt.drain_replica(f"localhost:{ports[pinned]}")
            assert rt.router_report()[
                f"localhost:{ports[pinned]}"]["state"] == "draining"
            _push(c, range(6, 12))
            got = _wait_settled(c, 12)
            assert len(got) + c["qc"].stats["shed"] == 12
            after = [sp["src"].scheduler.report()["completed"]
                     for sp in reps]
            assert after[pinned] == loads[pinned]
            assert after[1 - pinned] > loads[1 - pinned]
            assert rt.stats.snapshot()["router_replica_drains"] == 1
        finally:
            c["in"].end_stream()
            c.stop()
            rp.stop()
            for sp in reps:
                sp.stop()

    def test_replica_pipeline_drain_marks_it_draining(self):
        """A replica's own Pipeline.drain sends DRAIN to the router,
        which steers new work to the survivor; every frame settles."""
        reps = [_serve_pipeline(82 + i) for i in range(2)]
        for sp in reps:
            sp.start()
        ports = [sp["src"].bound_port for sp in reps]
        rp = pt.parse_launch(
            f"tensor_serve_router name=rt port=0 "
            f"replicas=localhost:{ports[0]},localhost:{ports[1]}")
        rp.start()
        rt = rp["rt"]
        c = _client_pipeline(rt.bound_port)
        c.start()
        try:
            _push(c, range(4))
            assert len(_wait_settled(c, 4)) == 4
            loads = [sp["src"].scheduler.report()["completed"]
                     for sp in reps]
            pinned = loads.index(max(loads))
            assert reps[pinned].drain(deadline=10) is True
            assert _wait_for(lambda: rt.stats.snapshot()[
                "router_replica_drains"] == 1)
            _push(c, range(4, 10))
            got = _wait_settled(c, 10)
            assert got == [2.0 * i for i in range(10)]
            check_identities(rt.stats.snapshot(),
                             names=["router-settlement"])
        finally:
            c["in"].end_stream()
            c.stop()
            rp.stop()
            for sp in reps:
                sp.stop()

    def test_trace_report_surfaces_router_block(self):
        sp = _serve_pipeline(70)
        sp.start()
        port = sp["src"].bound_port
        rp = pt.parse_launch(
            f"tensor_serve_router name=rt port=0 replicas=localhost:{port}")
        tracer = rp.enable_tracing()
        rp.start()
        c = _client_pipeline(rp["rt"].bound_port)
        c.start()
        try:
            _push(c, range(3))
            assert len(_wait_settled(c, 3)) == 3
            rep = tracer.report(rp)
            assert rep["rt"]["router"][f"localhost:{port}"]["state"] == \
                "healthy"
        finally:
            c["in"].end_stream()
            c.stop()
            rp.stop()
            sp.stop()


@pytest.mark.parametrize("router_pkg,replica_pkg", [(pt, nt), (nt, pt)],
                         ids=["port-router-jax-replicas",
                              "jax-router-port-replicas"])
def test_router_fronts_the_other_package(router_pkg, replica_pkg):
    """Either package's router in front of the other's replicas, with
    the other's clients too: every frame once, doubled, the replicas'
    PONG load reports read, the router identity balanced."""
    reps = [_serve_pipeline(84 + i, pkg=replica_pkg) for i in range(2)]
    for sp in reps:
        sp.start()
    ports = [sp["src"].bound_port for sp in reps]
    rp = router_pkg.parse_launch(
        f"tensor_serve_router name=rt port=0 affinity=false "
        f"replicas=localhost:{ports[0]},localhost:{ports[1]} "
        "heartbeat-ms=50")
    rp.start()
    rt = rp["rt"]
    c = _client_pipeline(rt.bound_port, max_request=16, pkg=replica_pkg)
    c.start()
    try:
        _push(c, range(12), pkg=replica_pkg)
        assert _wait_settled(c, 12) == [2.0 * i for i in range(12)]
        assert _wait_for(lambda: _all_healthy(rt, 2))
        st = rt.stats.snapshot()
        assert st["router_delivered"] == 12
        check_identities(st, names=["router-settlement"])
    finally:
        c["in"].end_stream()
        c.stop()
        rp.stop()
        for sp in reps:
            sp.stop()


# -------------------------------------------------- broker-fed membership

class TestBrokerFleet:
    def test_register_query_counters(self):
        broker = DiscoveryBroker(port=0)
        broker.start()
        try:
            sp = _serve_pipeline(72, broker_port=broker.bound_port,
                                 topic="flt-a")
            sp.start()
            assert _wait_for(lambda: broker.entries("flt-a"))
            eps = discover_meta("localhost", broker.bound_port, "flt-a")
            assert len(eps) == 1
            (_, port), meta = eps[0]
            assert port == sp["src"].bound_port
            assert meta.get("role") == "serve" and "depth" in meta
            st = broker.stats.snapshot()
            assert st["broker_registers"] == 1
            assert st["broker_queries"] == 1
            assert st["broker_errors"] == 0
            sp.stop()
        finally:
            broker.stop()

    def test_dead_register_pruned_before_next_query(self):
        broker = DiscoveryBroker(port=0)
        broker.start()
        try:
            reps = [_serve_pipeline(74 + i, broker_port=broker.bound_port,
                                    topic="flt-b") for i in range(2)]
            for sp in reps:
                sp.start()
            assert _wait_for(lambda: len(broker.entries("flt-b")) == 2)
            reps[0]["src"]._broker_sock.close()
            assert _wait_for(lambda: len(discover_meta(
                "localhost", broker.bound_port, "flt-b")) == 1, 5)
            eps = discover_meta("localhost", broker.bound_port, "flt-b")
            assert [e for e, _ in eps] == \
                [("localhost", reps[1]["src"].bound_port)]
            for sp in reps:
                sp.stop()
        finally:
            broker.stop()

    def test_router_follows_broker_and_fails_over(self):
        broker = DiscoveryBroker(port=0)
        broker.start()
        reps = [_serve_pipeline(76 + i, broker_port=broker.bound_port,
                                topic="flt-c") for i in range(2)]
        for sp in reps:
            sp.start()
        assert _wait_for(lambda: len(broker.entries("flt-c")) == 2)
        rp = pt.parse_launch(
            f"tensor_serve_router name=rt port=0 topic=flt-c "
            f"dest-port={broker.bound_port} requery-ms=100 heartbeat-ms=50")
        rp.start()
        rt = rp["rt"]
        assert _wait_for(lambda: _all_healthy(rt, 2))
        c = _client_pipeline(rt.bound_port)
        c.start()
        try:
            _push(c, range(4))
            assert len(_wait_settled(c, 4)) == 4
            loads = [sp["src"].scheduler.report()["completed"]
                     for sp in reps]
            victim = loads.index(max(loads))
            reps[victim].stop()
            assert _wait_for(lambda: len(rt.router.replica_keys()) == 1)
            _push(c, range(4, 10))
            got = _wait_settled(c, 10)
            assert len(got) + c["qc"].stats["shed"] == 10
            assert c["qc"].stats["session_declared_lost"] == 0
            assert c["qc"].stats["reconnects"] == 0  # stream never broke
        finally:
            c["in"].end_stream()
            c.stop()
            rp.stop()
            for sp in reps:
                sp.stop()
            broker.stop()


# ------------------------------------------------- failover race regressions

class TestFailoverRaces:
    """Unit-level pins for the dispatch/failover/settle races: a never-
    started FleetRouter (no listener, no threads) driven directly."""

    def test_send_failure_pop_miss_cedes_retry_to_sweep(self):
        r = pt_router.FleetRouter(port=0)
        buf = pt.Buffer.from_arrays([np.zeros(4, np.float32)])

        class _RacedSock:
            def sendmsg(self, *a, **k):
                with r._plock:
                    r._pending.clear()
                raise BrokenPipeError("severed by _replica_down")

            def sendall(self, *a, **k):
                self.sendmsg()

        picks = []

        def fake_pick(skey, exclude):
            picks.append(set(exclude))
            return (("r:1", _RacedSock(), threading.Lock(), None)
                    if len(picks) == 1 else None)

        r._pick = fake_pick
        r._dispatch(0, buf, 1, None)
        st = r.stats.snapshot()
        assert len(picks) == 1  # no second dispatch attempt
        assert st["router_requests"] == 1
        assert st["router_shed"] == 0  # the sweep owns the settle now
        assert r.pending() == 0

    def test_late_answer_for_dead_client_is_orphan_not_dup(self):
        r = pt_router.FleetRouter(port=0)
        buf = pt.Buffer.from_arrays([np.zeros(4, np.float32)])
        with r._plock:
            r._rseq += 1
            rseq = r._rseq
            r._pending[rseq] = [7, 1, buf, "r:1", 0]
        r._drop_client(7)
        assert r.stats.snapshot()["router_orphaned"] == 1
        assert r._settle(rseq) is None
        st = r.stats.snapshot()
        assert st["router_orphan_drops"] == 1 and st["router_dup_drops"] == 0
        assert r._settle(999) is None
        st = r.stats.snapshot()
        assert st["router_dup_drops"] == 1 and st["router_orphan_drops"] == 1


# ---------------------------------------------------------- pipelint

def _findings(desc, rule):
    def keys(report):
        return {(f.rule, f.element, f.pad, f.severity)
                for f in report.findings if f.rule == rule}
    report = analyze(pt.parse_launch(desc))
    assert not report.crashed
    assert keys(report) == keys(nt_analyze(nt.parse_launch(desc)))
    return [f for f in report.findings if f.rule == rule]


class TestRouterRules:
    def test_router_without_membership_is_error(self):
        bad = (  # pipelint: skip — router with nothing to route to
            "tensor_serve_router name=rt port=0")
        got = _findings(bad, "router-no-replicas")
        assert [(f.element, f.severity) for f in got] == \
            [("rt", Severity.ERROR)]
        assert "shed" in got[0].message

    def test_router_with_static_replicas_is_clean(self):
        ok = "tensor_serve_router name=rt port=0 replicas=localhost:3001"
        assert _findings(ok, "router-no-replicas") == []

    def test_router_with_broker_topic_is_clean(self):
        ok = ("tensor_serve_router name=rt port=0 "
              "topic=fleet dest-port=3100")
        assert _findings(ok, "router-no-replicas") == []

    def test_router_affinity_without_session_warns(self):
        bad = (  # pipelint: skip — affinity keys need the session layer
            "tensor_serve_router name=rt port=0 "
            "replicas=localhost:3001 affinity=true session=false")
        got = _findings(bad, "router-affinity-sessionless")
        assert [(f.element, f.severity) for f in got] == \
            [("rt", Severity.WARNING)]
        assert "least-loaded" in got[0].message

    def test_router_affinity_with_session_is_clean(self):
        ok = ("tensor_serve_router name=rt port=0 "
              "replicas=localhost:3001 affinity=true session=true")
        assert _findings(ok, "router-affinity-sessionless") == []

    def test_router_no_affinity_sessionless_is_clean(self):
        ok = ("tensor_serve_router name=rt port=0 "
              "replicas=localhost:3001 affinity=false session=false")
        assert _findings(ok, "router-affinity-sessionless") == []

    def test_start_refuses_a_router_with_no_replicas(self):
        from nnstreamer_tpu_torch.analysis import PipelineValidationError
        p = pt.parse_launch(  # pipelint: skip — the gate's own case
            "tensor_serve_router name=rt port=0")
        with pytest.raises(PipelineValidationError):
            p.start()
        assert p["rt"].router is None
