"""The port's edgesink/edgesrc (nnstreamer_tpu_torch/elements/edge.py)
and discovery broker against the JAX package's, on the CPU.

Cross-package pub/sub: a JAX ``edgesink`` feeds a port ``edgesrc`` and
the reverse, with ``session=true``, ``coalesce-frames=4``,
``wire-codec=shuffle-zlib`` and one ``tensor_fault mode=kill-link``
(on the subscriber, or on the publisher): every frame arrives once and
in order, bytewise equal to what was pushed, with nothing declared lost.
``wire-codec=delta`` links run across packages in both directions, and
the port's own delta link is killed three times mid-stream (the mirror
of tests/test_chaos.py ``TestDeltaChaos``): every frame arrives once, in
order and bytewise equal, and each replay opens with a keyframe.
``wire-precision=bf16`` delivers exactly the frames downcast and upcast
on the host. No tolerance: every comparison is exact.

Behaviour: tests/test_wire.py's ``TestCoalescing``, ``TestSessionHandshake``
and ``TestBatchReplayAcrossReconnect`` run as one test each
parametrised over both packages. Where the reference sleeps before
publishing to a fresh subscriber, these wait until the publisher has
the subscriber in its broadcast set. The port also closes the gap the
reference leaves between a v1 subscriber's CAPS_ACK and its entry into
that set (``test_frame_published_right_after_the_ack_arrives``).

The tracer's ``wire``/``session`` blocks (and the delta codec's
``delta``/``delta_in``) have the JAX package's keys on the same lines,
the discovery broker serves either package's servers and clients, and
a live broker's counters form the tracer's ``broker`` block.
"""
import dataclasses
import socket
import time
from types import ModuleType

import ml_dtypes
import numpy as np
import pytest
import torch

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as pt
from nnstreamer_tpu.edge import broker as nt_broker
from nnstreamer_tpu.edge import protocol as nt_protocol
from nnstreamer_tpu.edge import session as nt_session
from nnstreamer_tpu.edge import wire as nt_wire
from nnstreamer_tpu_torch.edge import broker as pt_broker
from nnstreamer_tpu_torch.edge import protocol as pt_protocol
from nnstreamer_tpu_torch.edge import session as pt_session
from nnstreamer_tpu_torch.edge import wire as pt_wire


@dataclasses.dataclass(frozen=True)
class Pkg:
    top: ModuleType
    wire: ModuleType
    protocol: ModuleType
    session: ModuleType


NT = Pkg(nt, nt_wire, nt_protocol, nt_session)
PT = Pkg(pt, pt_wire, pt_protocol, pt_session)
BOTH = pytest.mark.parametrize("pkg", [NT, PT], ids=["jax", "torch"])

CAPS = ('other/tensors,format=static,num_tensors=1,'
        'types=(string)float32,dimensions=(string)4')
CAPS_512 = ('other/tensors,format=static,num_tensors=1,'
            'types=(string)float32,dimensions=(string)512')


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _wait(cond, timeout=15.0, what="condition"):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting: {what}"
        time.sleep(0.01)


def _subscribed(pub_el, n=1):
    """The publisher has ``n`` subscribers in its broadcast set."""
    with pub_el._subs_lock:
        return len(pub_el._subs) >= n


def _frames(n):
    """Seeded float32 frames that shuffle-zlib shrinks (small multiples
    of 0.25 plus a per-frame offset)."""
    base = (np.arange(512) % 32).astype(np.float32) * 0.25
    rng = np.random.default_rng(17)
    return [base + np.float32(i) + rng.integers(0, 4, 512)
            .astype(np.float32) for i in range(n)]


def _host_bytes(v):
    if isinstance(v, torch.Tensor):
        v = v.numpy()
    return str(np.asarray(v).dtype), np.ascontiguousarray(v).tobytes()


# -- cross-package pub/sub with a killed link ------------------------------


@pytest.mark.parametrize("kill", ["subscriber", "publisher"])
@pytest.mark.parametrize("pub_pkg,sub_pkg", [(NT, PT), (PT, NT)],
                         ids=["jax-to-torch", "torch-to-jax"])
def test_session_link_survives_one_kill(pub_pkg, sub_pkg, kill):
    port = _free_port()
    n = 40
    fault = "tensor_fault name=f mode=kill-link target={} every=15 " \
            "max-faults=1 ! "
    pub = pub_pkg.top.parse_launch(
        f'appsrc name=in caps="{CAPS_512}" '
        f'! {fault.format("p") if kill == "publisher" else ""}'
        f'edgesink name=p port={port} topic=t session=true '
        'coalesce-frames=4 coalesce-ms=10 wire-codec=shuffle-zlib')
    pub.start()
    sub = sub_pkg.top.parse_launch(
        f'edgesrc name=s dest-port={port} topic=t session=true '
        'ack-every=4 timeout=15 '
        f'! {fault.format("s") if kill == "subscriber" else ""}'
        'appsink name=out')
    frames = _frames(n)
    try:
        sub.start()
        _wait(lambda: pub["p"].session_info().get("sessions") == 1,
              what="session attach")
        for arr in frames:
            pub["in"].push_buffer(pub_pkg.top.Buffer.from_arrays([arr]))
            time.sleep(0.005)
        _wait(lambda: len(sub["out"].buffers) >= n, 30, "delivery")
        ps, ss = pub["p"].stats.snapshot(), sub["s"].stats.snapshot()
        kills = (pub if kill == "publisher" else sub)["f"].stats["faults"]
        got = [b.chunks[0].host() for b in sub["out"].buffers]
        errs = (pub._error, sub._error)
    finally:
        pub["in"].end_stream()
        pub.wait_eos(timeout=10)
        pub.stop()
        sub.stop()
    assert errs == (None, None)
    assert kills == 1
    assert [_host_bytes(g) for g in got] == [_host_bytes(f) for f in frames]
    assert ps["session_sent"] == n
    assert ss["session_delivered"] == n
    assert ss["session_declared_lost"] == 0
    assert ps["session_declared_lost"] == 0
    assert ss["reconnects"] == 1
    assert ps["session_resumes"] == 1
    # shuffle-zlib really shrank the stream
    assert ps["wire_enc_bytes_out"] < ps["wire_raw_bytes_out"]


def _delta_frames(n):
    """A one-element patch moving over a 512-float frame: consecutive
    frames differ in two elements, so diffs genuinely engage."""
    out = []
    for i in range(n):
        arr = np.zeros(512, np.float32)
        arr[i % 512] = float(i + 1)
        out.append(arr)
    return out


@pytest.mark.parametrize("pub_pkg,sub_pkg", [(NT, PT), (PT, NT)],
                         ids=["jax-to-torch", "torch-to-jax"])
def test_delta_link_across_packages(pub_pkg, sub_pkg):
    """A delta publisher of one package and a subscriber of the other,
    coalesced, with a session and one killed link: every frame once, in
    order, bytewise equal; diffs really shipped; the resumed link opens
    with a keyframe."""
    port = _free_port()
    n = 40
    pub = pub_pkg.top.parse_launch(
        f'appsrc name=in caps="{CAPS_512}" '
        f'! edgesink name=p port={port} topic=t session=true '
        'wire-codec=delta wire-delta-k=8 coalesce-frames=4 coalesce-ms=10')
    pub.start()
    sub = sub_pkg.top.parse_launch(
        f'edgesrc name=s dest-port={port} topic=t session=true '
        'ack-every=4 timeout=15 '
        '! tensor_fault name=f mode=kill-link target=s every=15 '
        'max-faults=1 ! appsink name=out')
    frames = _delta_frames(n)
    try:
        sub.start()
        _wait(lambda: pub["p"].session_info().get("sessions") == 1,
              what="session attach")
        assert sub["s"]._wire_cfg.codec == "delta"
        for arr in frames:
            pub["in"].push_buffer(pub_pkg.top.Buffer.from_arrays([arr]))
            time.sleep(0.005)
        _wait(lambda: len(sub["out"].buffers) >= n, 30, "delivery")
        _wait(lambda: pub["p"].stats.snapshot().get("session_resumes") == 1,
              what="resume counted")
        ps, ss = pub["p"].stats.snapshot(), sub["s"].stats.snapshot()
        got = [b.chunks[0].host() for b in sub["out"].buffers]
        errs = (pub._error, sub._error)
    finally:
        pub["in"].end_stream()
        pub.wait_eos(timeout=10)
        pub.stop()
        sub.stop()
    assert errs == (None, None)
    assert [_host_bytes(g) for g in got] == [_host_bytes(f) for f in frames]
    assert ss["session_delivered"] == n and ss["session_declared_lost"] == 0
    assert ss["reconnects"] == 1
    assert ps["wire_delta_diffs"] > 0 and ss["wire_delta_diffs_in"] > 0
    # one keyframe a connection at least: the first subscribe + the resume
    assert ps["wire_delta_keyframes"] >= 2
    assert ss["wire_delta_keyframes_in"] >= 2
    assert ss["link_errors"] == 1


def test_port_delta_link_kills_replay_from_keyframe():
    """tests/test_chaos.py ``TestDeltaChaos`` on the port: a session
    link with wire-codec=delta killed mid-stream three times. Each
    resumed connection mints fresh reference state on both ends, so each
    replay opens with a keyframe; a diff decoded against the pre-kill
    reference would corrupt frames, hence the byte-exact check."""
    port = _free_port()
    pub = pt.parse_launch(
        f'appsrc name=in caps="{CAPS_512}" '
        f'! edgesink name=p port={port} topic=t session=true '
        'wire-codec=delta wire-delta-k=8 coalesce-frames=4 coalesce-ms=10')
    pub.start()
    sub = pt.parse_launch(
        f'edgesrc name=s dest-port={port} topic=t session=true '
        'ack-every=4 timeout=15 '
        '! tensor_fault name=f mode=kill-link target=s every=12 '
        'max-faults=3 ! appsink name=out')
    n = 50
    frames = _delta_frames(n)
    try:
        sub.start()
        _wait(lambda: pub["p"].session_info().get("sessions") == 1,
              what="session attach")
        for arr in frames:
            pub["in"].push_buffer(pt.Buffer.from_arrays([arr]))
            time.sleep(0.01)
        _wait(lambda: len(sub["out"].buffers) >= n, 30, "delivery")
        kills = sub["f"].stats["faults"]
        _wait(lambda: pub["p"].stats.snapshot().get("session_resumes")
              == kills, what="every resume counted")
        ps, ss = pub["p"].stats.snapshot(), sub["s"].stats.snapshot()
        got = [b.chunks[0].host() for b in sub["out"].buffers]
        errs = (pub._error, sub._error)
    finally:
        pub["in"].end_stream()
        pub.wait_eos(timeout=10)
        pub.stop()
        sub.stop()
    assert errs == (None, None)
    assert kills == 3
    assert ps["session_sent"] == n
    assert ss["session_delivered"] == n
    assert ss["session_declared_lost"] == 0 == ps["session_declared_lost"]
    assert ss["reconnects"] == kills
    assert [_host_bytes(g) for g in got] == [_host_bytes(f) for f in frames]
    assert ps["wire_delta_diffs"] > 0 and ss["wire_delta_diffs_in"] > 0
    assert ps["wire_delta_keyframes"] >= kills + 1
    assert ss["wire_delta_keyframes_in"] >= kills + 1
    # each kill cost exactly one link error: no diff ever met a stale
    # reference (that would tear the link down a second time)
    assert ss["link_errors"] == kills


def test_delta_line_delivers_what_a_raw_line_delivers():
    """tools/delta_parity.py's live scenario on the port: the same
    stream over a live socket with wire-codec=delta and with raw."""
    frames = _delta_frames(16)

    def run(codec):
        port = _free_port()
        pub = pt.parse_launch(
            # pipelint: skip (a template: the wire codec is parametrised)
            f'appsrc name=in caps="{CAPS_512}" ! edgesink name=p '
            f'port={port} topic=t wire-codec={codec} wire-delta-k=4')
        pub.start()
        sub = pt.parse_launch(f'edgesrc name=s dest-port={port} topic=t '
                              'timeout=15 ! appsink name=out')
        try:
            sub.start()
            _wait(lambda: _subscribed(pub["p"]), what="subscribe")
            for f in frames:
                pub["in"].push_buffer(pt.Buffer.from_arrays([f.copy()]))
            _wait(lambda: len(sub["out"].buffers) >= len(frames),
                  what="delivery")
            got = [_host_bytes(b.chunks[0].host())
                   for b in sub["out"].buffers]
            ps = pub["p"].stats.snapshot()
        finally:
            pub["in"].end_stream()
            pub.wait_eos(timeout=10)
            pub.stop()
            sub.stop()
        return got, ps

    got_delta, ps = run("delta")
    got_raw, _ = run("raw")
    assert got_delta == got_raw == [_host_bytes(f) for f in frames]
    assert ps["wire_delta_diffs"] > 0
    assert ps["wire_enc_bytes_out"] < ps["wire_raw_bytes_out"] / 4


@pytest.mark.parametrize("pub_pkg,sub_pkg", [(NT, PT), (PT, NT)],
                         ids=["jax-to-torch", "torch-to-jax"])
def test_bf16_precision_delivers_the_host_downcast(pub_pkg, sub_pkg):
    port = _free_port()
    pub = pub_pkg.top.parse_launch(
        f'appsrc name=in caps="{CAPS_512}" ! edgesink name=p port={port} '
        'wire-precision=bf16 coalesce-frames=2 coalesce-ms=10')
    pub.start()
    sub = sub_pkg.top.parse_launch(f'edgesrc name=s dest-port={port} '
                                   'timeout=15 ! appsink name=out')
    rng = np.random.default_rng(3)
    frames = [rng.standard_normal(512).astype(np.float32) for _ in range(6)]
    try:
        sub.start()
        _wait(lambda: _subscribed(pub["p"]), what="subscribe")
        for arr in frames:
            pub["in"].push_buffer(pub_pkg.top.Buffer.from_arrays([arr]))
        _wait(lambda: len(sub["out"].buffers) >= 6, what="delivery")
        got = [np.asarray(b.chunks[0].host()) for b in sub["out"].buffers]
    finally:
        pub["in"].end_stream()
        pub.wait_eos(timeout=10)
        pub.stop()
        sub.stop()
    for g, f in zip(got, frames):
        want = f.astype(ml_dtypes.bfloat16).astype(np.float32)
        assert g.dtype == np.float32 and g.tobytes() == want.tobytes()


# -- mirrored behaviour: coalescing -----------------------------------------


class TestCoalescing:
    @staticmethod
    def _pubsub(pkg, sink_props):
        port = _free_port()
        pub = pkg.top.parse_launch(
            f'appsrc name=in caps="{CAPS}" '
            f'! edgesink name=p port={port} {sink_props}')
        pub.start()
        sub = pkg.top.parse_launch(
            f'edgesrc dest-port={port} timeout=15 ! appsink name=out')
        sub.start()
        _wait(lambda: _subscribed(pub["p"]), what="subscribe")
        return pub, sub

    @BOTH
    def test_flush_by_size_preserves_order(self, pkg):
        pub, sub = self._pubsub(pkg, "coalesce-frames=4 coalesce-ms=500")
        for i in range(8):  # exactly two full batches
            pub["in"].push_buffer(pkg.top.Buffer.from_arrays(
                [np.full(4, float(i), np.float32)], pts=i * 10))
        _wait(lambda: len(sub["out"].buffers) >= 8, what="8 frames")
        pub_stats = pub["p"].stats.snapshot()
        pub["in"].end_stream()
        sub.wait_eos(timeout=15)
        sub.stop()
        pub.stop()
        got = sub["out"].buffers
        assert [float(b.chunks[0].host()[0]) for b in got] == \
            [float(i) for i in range(8)]
        assert [b.pts for b in got] == [i * 10 for i in range(8)]
        assert pub_stats["wire_frames_out"] == 8
        assert pub_stats["wire_msgs_out"] <= 3

    @BOTH
    def test_flush_by_age(self, pkg):
        pub, sub = self._pubsub(pkg, "coalesce-frames=8 coalesce-ms=40")
        t0 = time.monotonic()
        for i in range(2):
            pub["in"].push_buffer(pkg.top.Buffer.from_arrays(
                [np.full(4, float(i), np.float32)]))
        _wait(lambda: len(sub["out"].buffers) >= 2, 10, "age flush")
        elapsed = time.monotonic() - t0
        pub["in"].end_stream()
        sub.wait_eos(timeout=15)
        sub.stop()
        pub.stop()
        assert len(sub["out"].buffers) == 2
        assert elapsed < 5.0

    @BOTH
    def test_eos_flushes_pending(self, pkg):
        pub, sub = self._pubsub(pkg, "coalesce-frames=16 "
                                     "coalesce-ms=60000")
        for i in range(3):
            pub["in"].push_buffer(pkg.top.Buffer.from_arrays(
                [np.full(4, float(i), np.float32)]))
        pub["in"].end_stream()
        sub.wait_eos(timeout=15)
        sub.stop()
        pub.stop()
        assert len(sub["out"].buffers) == 3


# -- mirrored behaviour: the session handshake over a raw socket -----------


def _session_subscribe(pkg, port, sid, topic="t", last=0, ack_every=4,
                       v2=False):
    p, s = pkg.protocol, pkg.session
    sub = socket.create_connection(("localhost", port), timeout=10)
    meta = {"topic": topic, "session": s.advertise(sid, ack_every)}
    if v2:
        meta["wire"] = pkg.wire.advertise()
    p.send_msg(sub, p.MsgKind.SUBSCRIBE, meta)
    kind, meta, _ = p.recv_msg(sub)
    assert kind == p.MsgKind.CAPS_ACK
    assert meta["session"]["sid"] == sid
    p.send_msg(sub, p.MsgKind.RESUME, {"sid": sid, "last": last})
    kind, rack, _ = p.recv_msg(sub)
    assert kind == p.MsgKind.RESUME_ACK
    sub.settimeout(10)
    return sub, rack


def _publisher(pkg, extra=""):
    port = _free_port()
    pub = pkg.top.parse_launch(f'appsrc name=in caps="{CAPS}" '
                               f'! edgesink name=p port={port} topic=t '
                               f'{extra}')
    pub.start()
    return pub, port


def _push(pkg, pub, values):
    for v in values:
        pub["in"].push_buffer(pkg.top.Buffer.from_arrays(
            [np.full(4, float(v), np.float32)]))


class TestSessionHandshake:
    @BOTH
    def test_fresh_attach_then_seq_stamped_frames(self, pkg):
        pub, port = _publisher(pkg)
        sub, rack = _session_subscribe(pkg, port, pkg.session
                                       .new_session_id())
        try:
            assert rack["resumed"] is False and rack["lost"] == 0
            _push(pkg, pub, range(3))
            seqs = []
            while len(seqs) < 3:
                kind, meta, _ = pkg.protocol.recv_msg(sub)
                assert kind == pkg.protocol.MsgKind.DATA
                seqs.append(meta["seq"])
            base = rack["base"]
            assert seqs == [base + 1, base + 2, base + 3]
        finally:
            sub.close()
            pub["in"].end_stream()
            pub.stop()

    @BOTH
    def test_v1_subscriber_sees_no_session_echo(self, pkg):
        """The reference's version sleeps and then publishes; this one
        publishes once the publisher lists the subscriber."""
        p = pkg.protocol
        pub, port = _publisher(pkg, "session=true")
        sub = socket.create_connection(("localhost", port), timeout=10)
        try:
            p.send_msg(sub, p.MsgKind.SUBSCRIBE, {"topic": "t"})
            kind, meta, _ = p.recv_msg(sub)
            assert kind == p.MsgKind.CAPS_ACK
            assert "session" not in meta
            _wait(lambda: _subscribed(pub["p"]), what="subscriber listed")
            _push(pkg, pub, [0])
            sub.settimeout(10)
            kind, meta, _ = p.recv_msg(sub)
            assert kind == p.MsgKind.DATA and "seq" not in meta
        finally:
            sub.close()
            pub["in"].end_stream()
            pub.stop()

    @BOTH
    def test_resume_replays_exactly_the_gap(self, pkg):
        p = pkg.protocol
        pub, port = _publisher(pkg)
        sid = pkg.session.new_session_id()
        sub, rack = _session_subscribe(pkg, port, sid)
        base = rack["base"]
        _push(pkg, pub, range(4))
        got = []
        while len(got) < 4:
            kind, meta, _ = p.recv_msg(sub)
            assert kind == p.MsgKind.DATA
            got.append(meta["seq"])
        sub.close()  # the outage
        _push(pkg, pub, range(4, 8))
        _wait(lambda: pub["p"].stats["session_sent"] >= 8,
              what="outage frames stamped")
        sub, rack = _session_subscribe(pkg, port, sid, last=base + 4)
        try:
            assert rack["resumed"] is True and rack["lost"] == 0
            replayed = []
            while len(replayed) < 4:
                kind, meta, payloads = p.recv_msg(sub)
                assert kind == p.MsgKind.DATA
                replayed.append((meta["seq"], float(
                    pkg.wire.unpack_buffer(meta, payloads).chunks[0]
                    .host()[0])))
            assert replayed == [(base + 5 + i, float(4 + i))
                                for i in range(4)]
            assert pub["p"].stats["session_replayed"] == 4
            assert pub["p"].stats["session_resumes"] == 1
        finally:
            sub.close()
            pub["in"].end_stream()
            pub.stop()

    @BOTH
    def test_ring_eviction_becomes_declared_loss(self, pkg):
        p = pkg.protocol
        pub, port = _publisher(pkg, "session-ring-kb=1")
        sid = pkg.session.new_session_id()
        sub, rack = _session_subscribe(pkg, port, sid)
        base = rack["base"]
        sub.close()  # vanish immediately: nothing ever ACKed
        n = 80
        _push(pkg, pub, range(n))
        _wait(lambda: pub["p"].stats["session_sent"] >= n,
              what="burst stamped")
        sub, rack = _session_subscribe(pkg, port, sid, last=base)
        try:
            assert rack["resumed"] is True
            lost = rack["lost"]
            assert lost > 0
            replayed = []
            while len(replayed) < n - lost:
                kind, meta, _ = p.recv_msg(sub)
                assert kind == p.MsgKind.DATA
                replayed.append(meta["seq"])
            assert replayed == list(range(base + lost + 1, base + n + 1))
            assert pub["p"].stats["session_declared_lost"] == lost
        finally:
            sub.close()
            pub["in"].end_stream()
            pub.stop()

    @BOTH
    def test_partial_batch_never_half_delivered(self, pkg):
        p = pkg.protocol
        pub, port = _publisher(pkg, "coalesce-frames=4 coalesce-ms=30")
        sid = pkg.session.new_session_id()
        sub, rack = _session_subscribe(pkg, port, sid, v2=True)
        base = rack["base"]
        n = 16
        _push(pkg, pub, range(n))
        kind, meta, payloads = p.recv_msg(sub)
        assert kind == p.MsgKind.DATA_BATCH
        first = pkg.wire.unpack_batch(meta, payloads)
        watermark = first[-1].extras["seq"]
        assert watermark == base + len(first)
        sub.close()
        _wait(lambda: pub["p"].stats["session_sent"] >= n,
              what="stream stamped")
        sub, rack = _session_subscribe(pkg, port, sid, last=watermark,
                                       v2=True)
        try:
            assert rack["resumed"] is True and rack["lost"] == 0
            seqs = []
            while len(seqs) < n - len(first):
                kind, meta, payloads = p.recv_msg(sub)
                if kind == p.MsgKind.DATA:
                    seqs.append(meta["seq"])
                else:
                    assert kind == p.MsgKind.DATA_BATCH
                    seqs.extend(b.extras["seq"] for b in
                                pkg.wire.unpack_batch(meta, payloads))
            assert seqs == list(range(watermark + 1, base + n + 1))
        finally:
            sub.close()
            pub["in"].end_stream()
            pub.stop()


def test_frame_published_right_after_the_ack_arrives():
    """No wait at all between a v1 subscriber's CAPS_ACK and the next
    frame: the port's publisher already lists the link when the ack
    leaves, so the frame is delivered, every time."""
    p = pt_protocol
    pub, port = _publisher(PT)
    socks = []
    try:
        for i in range(10):
            sub = socket.create_connection(("localhost", port), timeout=10)
            socks.append(sub)
            p.send_msg(sub, p.MsgKind.SUBSCRIBE, {"topic": "t"})
            kind, _, _ = p.recv_msg(sub)
            assert kind == p.MsgKind.CAPS_ACK
            _push(PT, pub, [i])
            for s in socks:   # the new link and every earlier one
                s.settimeout(10)
                kind, meta, payloads = p.recv_msg(s)
                assert kind == p.MsgKind.DATA
                assert float(pt_wire.unpack_buffer(meta, payloads)
                             .chunks[0].host()[0]) == float(i)
    finally:
        for s in socks:
            s.close()
        pub["in"].end_stream()
        pub.stop()


@BOTH
def test_heartbeat_pongs_on_an_idle_link(pkg):
    pub, port = _publisher(pkg, "session=true")
    sub = pkg.top.parse_launch(
        f'edgesrc name=s dest-port={port} topic=t session=true '
        'heartbeat-ms=20 timeout=15 ! appsink name=out')
    try:
        sub.start()
        _wait(lambda: pub["p"].session_info().get("sessions") == 1,
              what="session attach")
        _wait(lambda: sub["s"].stats.get("session_pongs", 0) >= 2,
              what="pongs on the idle link")
        st = sub["s"].stats.snapshot()
    finally:
        pub["in"].end_stream()
        sub.stop()
        pub.stop()
    assert st["session_pings"] >= st["session_pongs"] >= 2
    assert st["session_rtt_ns"] > 0


# -- the tracer's wire and session blocks -----------------------------------


def _traced_pubsub(pkg, n=8):
    port = _free_port()
    pub = pkg.top.parse_launch(
        f'appsrc name=in caps="{CAPS_512}" ! edgesink name=p port={port} '
        'topic=t session=true coalesce-frames=2 coalesce-ms=10 '
        'wire-codec=zlib')
    sub = pkg.top.parse_launch(
        f'edgesrc name=s dest-port={port} topic=t session=true '
        'ack-every=2 heartbeat-ms=20 timeout=15 ! appsink name=out')
    ptr, str_ = pub.enable_tracing(), sub.enable_tracing()
    pub.start()
    try:
        sub.start()
        _wait(lambda: pub["p"].session_info().get("sessions") == 1,
              what="session attach")
        for arr in _frames(n):
            pub["in"].push_buffer(pkg.top.Buffer.from_arrays([arr]))
        _wait(lambda: len(sub["out"].buffers) >= n, what="delivery")
        _wait(lambda: pub["p"].stats.get("session_acks_in", 0) >= 1
              and sub["s"].stats.get("session_pongs", 0) >= 1,
              what="acks and pongs")
        return ptr.report(pub), str_.report(sub)
    finally:
        pub["in"].end_stream()
        sub.stop()
        pub.stop()


def test_wire_and_session_blocks_have_the_reference_keys():
    nt_pub, nt_sub = _traced_pubsub(NT)
    pt_pub, pt_sub = _traced_pubsub(PT)
    for got, want, name in ((pt_pub, nt_pub, "p"), (pt_sub, nt_sub, "s")):
        for block in ("wire", "session"):
            assert set(got[name][block]) == set(want[name][block]), \
                (name, block)
    assert pt_sub["s"]["session"]["delivered"] == 8
    assert pt_pub["p"]["wire"]["frames_out"] == 8
    assert pt_pub["p"]["session"]["sessions"] == 1


def test_trace_summaries_match_the_reference_on_the_same_counters():
    from nnstreamer_tpu.utils import trace as nt_trace
    from nnstreamer_tpu_torch.utils import trace as pt_trace
    st = {"wire_bytes_out": 900, "wire_msgs_out": 3, "wire_frames_out": 6,
          "wire_raw_bytes_out": 1200, "wire_enc_bytes_out": 800,
          "wire_pack_ns": 6000, "wire_frames_in": 2, "wire_bytes_in": 40,
          "session_sent": 6, "session_pongs": 2, "session_rtt_ns": 3000,
          "session_declared_lost": 0, "session_replayed": 1}
    assert pt_trace._wire_summary(st) == nt_trace._wire_summary(st)
    assert pt_trace._session_summary(st) == nt_trace._session_summary(st)
    assert pt_trace._wire_summary({}) == {} == \
        pt_trace._session_summary({"buffers": 3})


# -- the discovery broker ----------------------------------------------------


MLP_CAPS = ("other/tensors,format=static,num_tensors=1,"
            "types=(string)float32,dimensions=(string)64,"
            "framerate=(fraction)0/1")


@pytest.mark.parametrize("broker_mod,server_pkg,client_pkg", [
    (pt_broker, PT, NT), (nt_broker, PT, PT), (pt_broker, PT, PT)],
    ids=["torch-broker-jax-client", "jax-broker-torch-both",
         "torch-broker-torch-both"])
def test_hybrid_discovery_across_packages(broker_mod, server_pkg,
                                          client_pkg):
    broker = broker_mod.DiscoveryBroker(port=0).start()
    sport = _free_port()
    server = server_pkg.top.parse_launch(
        f"tensor_query_serversrc port={sport} id={sport} "
        f"connect-type=HYBRID topic=mlp dest-port={broker.bound_port} "
        "! tensor_filter framework=torch-cuda accelerator=true:cpu "
        f"model=zoo://mlp ! queue ! tensor_query_serversink id={sport}")
    client = client_pkg.top.parse_launch(
        f"appsrc name=in caps={MLP_CAPS} ! tensor_query_client name=c "
        f"connect-type=HYBRID topic=mlp dest-port={broker.bound_port} "
        "timeout=30 ! appsink name=out")
    try:
        server.start()
        _wait(lambda: broker.endpoints("mlp"), what="registration")
        eps = pt_broker.discover("localhost", broker.bound_port, "mlp")
        assert eps == nt_broker.discover("localhost", broker.bound_port,
                                         "mlp") == [("localhost", sport)]
        client.start()
        x = np.arange(64, dtype=np.float32) / 64
        client["in"].push_buffer(client_pkg.top.Buffer.from_arrays([x]))
        client["in"].end_stream()
        client.wait_eos(60)
        got = [np.asarray(b.chunks[0].host()) for b in client["out"]
               .buffers]
    finally:
        client.stop()
        server.stop()
        broker.stop()
    assert len(got) == 1 and got[0].shape == (10,)
    # the server's own model on the same input
    from nnstreamer_tpu_torch.models import zoo
    apply_fn, module, _, _ = zoo.build("mlp")
    with torch.inference_mode():
        want = apply_fn(module, torch.from_numpy(x)).numpy()
    assert got[0].tobytes() == want.tobytes()


def test_live_broker_counters_form_the_tracer_broker_block():
    """A running broker's counters reach every tracer report (the
    reference's ``live_broker_stats`` hook); a stopped one leaves."""
    broker = pt_broker.DiscoveryBroker(port=0).start()
    pipe = pt.parse_launch(f'appsrc caps="{CAPS}" ! fakesink')
    tracer = pipe.enable_tracing()
    try:
        assert pt_broker.discover("localhost", broker.bound_port,
                                  "none") == []
        _wait(lambda: broker.stats["broker_queries"] >= 1, what="query")
        report = tracer.report(pipe)
        assert report["broker"]["broker_queries"] >= 1
        assert set(report["broker"]) <= {"broker_registers",
                                         "broker_queries", "broker_errors"}
        assert pt_broker.live_broker_stats() == report["broker"]
    finally:
        broker.stop()
    assert "broker" not in tracer.report(pipe)


def test_broker_drops_a_dead_server_at_the_next_query():
    broker = pt_broker.DiscoveryBroker(port=0).start()
    try:
        reg = socket.create_connection(("localhost", broker.bound_port))
        nt_protocol.send_msg(reg, nt_protocol.MsgKind.REGISTER,
                             {"topic": "t", "host": "h", "port": 9,
                              "meta": {"load": 1}})
        _wait(lambda: broker.endpoints("t"), what="registration")
        assert nt_broker.discover_meta("localhost", broker.bound_port,
                                       "t") == [(("h", 9), {"load": 1})]
        reg.close()
        _wait(lambda: not pt_broker.discover("localhost",
                                             broker.bound_port, "t"),
              what="dead server pruned")
        assert broker.stats["broker_registers"] == 1
    finally:
        broker.stop()
