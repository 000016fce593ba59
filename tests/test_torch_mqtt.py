"""The port's MQTT transport (edge/mqtt_wire.py, edge/mqtt.py, edge/ntp.py,
elements/mqtt.py) against the JAX package's, on the CPU.

Mirrors tests/test_mqtt.py on the port: the packet goldens (MQTT 3.1.1
and the reference's 1024-byte GstMQTTMessageHdr), pub/sub through the
in-process broker, two subscribers with a wildcard, base-time
re-timing, QoS 1 (retransmit with DUP, redelivery over a reconnect, a
large publish across an ack timeout, a broker outage), SNTP against a
fake server and the local-clock fallback. What only a two-package run
shows:

* both packages encode the same packets and payload headers;
* a JAX ``mqttsink`` feeds a port ``mqttsrc`` and the reverse, and each
  package's sink publishes the same payload bytes for the same buffers
  (the base-time and sent-time epochs aside, which are each sink's
  clock);
* bfloat16 chunks ride as their bit patterns and arrive as the port's
  CPU bf16 tensors.

Nothing here needs a network: brokers and the SNTP server bind
localhost port 0, and every wait has its own bound.
"""
import io
import socket
import struct
import threading
import time

import ml_dtypes
import numpy as np
import pytest
import torch

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as pt
from nnstreamer_tpu.edge import mqtt_wire as nt_mw
from nnstreamer_tpu_torch.edge import MqttBroker
from nnstreamer_tpu_torch.edge import mqtt_wire as mw

CAPS = ('other/tensors,format=static,num_tensors=1,'
        'types=(string)float32,dimensions=(string)4')
WAIT_S = 10.0
PKGS = {"jax": nt, "port": pt}


def _wait(pred, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return bool(pred())


def _sub(pkg, port, topic, extra=""):
    return PKGS[pkg].parse_launch(
        f"mqttsrc name=src port={port} sub-topic={topic} timeout=15 {extra} "
        "! appsink name=out")


def _pub(pkg, port, topic, extra="", caps=CAPS):
    return PKGS[pkg].parse_launch(
        f'appsrc name=in caps="{caps}" '
        f"! mqttsink name=snk pub-topic={topic} port={port} {extra}")


def _values(sub):
    return [float(np.asarray(b.chunks[0].host())[0])
            for b in sub["out"].buffers]


# -- pub/sub -------------------------------------------------------------------

@pytest.mark.parametrize("pub_pkg,sub_pkg,qos", [
    ("port", "port", 0), ("port", "port", 1), ("jax", "port", 0),
    ("port", "jax", 0), ("jax", "port", 1), ("port", "jax", 1)])
def test_pub_sub_round_trip(pub_pkg, sub_pkg, qos):
    """Three frames through the broker, in order and intact, with caps
    negotiated from the in-stream header; across packages too."""
    broker = MqttBroker(port=0).start()
    sub = _sub(sub_pkg, broker.bound_port, "edge/cam1", f"mqtt-qos={qos}")
    sub.start()
    time.sleep(0.2)
    pub = _pub(pub_pkg, broker.bound_port, "edge/cam1", f"mqtt-qos={qos}")
    pub.start()
    try:
        for i in range(3):
            pub["in"].push_buffer(PKGS[pub_pkg].Buffer.from_arrays(
                [np.full(4, float(i), np.float32)], pts=1000 * i))
        assert _wait(lambda: len(sub["out"].buffers) >= 3)
    finally:
        pub["in"].end_stream()
        pub.stop()
        sub.stop()
        broker.stop()
    assert _values(sub) == [0.0, 1.0, 2.0]
    assert sub["out"].sinkpad.caps.to_config().info[0].shape == (4,)


def test_two_subscribers_and_wildcard():
    broker = MqttBroker(port=0).start()
    s_exact = _sub("port", broker.bound_port, "edge/cam1")
    s_wild = _sub("port", broker.bound_port, "edge/#")
    s_other = _sub("port", broker.bound_port, "other")
    for s in (s_exact, s_wild, s_other):
        s.start()
    time.sleep(0.2)
    pub = _pub("port", broker.bound_port, "edge/cam1")
    pub.start()
    try:
        pub["in"].push_buffer(pt.Buffer.from_arrays(
            [np.ones(4, np.float32)]))
        assert _wait(lambda: s_exact["out"].buffers and
                     s_wild["out"].buffers)
    finally:
        pub["in"].end_stream()
        pub.stop()
        for s in (s_exact, s_wild, s_other):
            s.stop()
        broker.stop()
    assert len(s_exact["out"].buffers) == 1
    assert len(s_wild["out"].buffers) == 1     # '#' matched
    assert not s_other["out"].buffers          # topic isolation


def test_base_time_retiming():
    """new_pts = (pub_base_epoch + pts) - sub_base_epoch, from a foreign
    raw MQTT 3.1.1 publisher (hand-built packets and header)."""
    broker = MqttBroker(port=0).start()
    sub = _sub("port", broker.bound_port, "t")
    sub.start()
    try:
        time.sleep(0.2)
        sub_base = sub["src"]._base_epoch_ns
        with socket.create_connection(("localhost",
                                       broker.bound_port)) as s:
            s.sendall(mw.connect_packet("foreign-pub"))
            ptype, _, body = mw.read_packet(s)
            assert ptype == mw.CONNACK and body[1] == 0
            arr = np.ones(4, np.float32)
            hdr = mw.pack_msg_hdr([arr.nbytes], CAPS, sub_base + 5_000_000,
                                  sub_base + 5_000_000, None, None, 100)
            s.sendall(mw.publish_packet("t", hdr + arr.tobytes()))
            assert _wait(lambda: sub["out"].buffers)
    finally:
        sub.stop()
        broker.stop()
    assert sub["out"].buffers[0].pts == 5_000_100


def _published(pkg, frames, caps=CAPS):
    """The PUBLISH payloads a package's mqttsink sends for ``frames``
    (arrays, pts 1000*i), read by a raw client."""
    broker = MqttBroker(port=0).start()
    raw = mw.MqttClient("localhost", broker.bound_port, f"raw-{pkg}")
    raw.subscribe("bytes/t")
    raw.settimeout(WAIT_S)
    pub = _pub(pkg, broker.bound_port, "bytes/t", caps=caps)
    pub.start()
    try:
        for i, arrs in enumerate(frames):
            pub["in"].push_buffer(PKGS[pkg].Buffer.from_arrays(
                arrs, pts=1000 * i, duration=33))
        return [raw.recv_publish()[1] for _ in frames]
    finally:
        pub["in"].end_stream()
        pub.stop()
        raw.close()
        broker.stop()


def _masked(payload):
    """A payload with the two epochs (header bytes 136-152) zeroed: each
    sink stamps its own clock there."""
    return payload[:136] + b"\x00" * 16 + payload[152:]


def test_sinks_publish_the_same_bytes():
    caps = ('other/tensors,format=static,num_tensors=2,'
            'types=(string)"float32,uint8",'
            'dimensions=(string)"4,3:2"')
    rng = np.random.default_rng(3)
    frames = [[rng.standard_normal(4).astype(np.float32),
               rng.integers(0, 255, (2, 3), dtype=np.uint8)]
              for _ in range(3)]
    got = _published("port", frames, caps)
    want = _published("jax", frames, caps)
    assert [_masked(p) for p in got] == [_masked(p) for p in want]
    sizes, caps_str, base, sent, dur, dts, pts = mw.unpack_msg_hdr(got[1])
    assert sizes == [16, 6] and dur == 33 and pts == 1000 and sent >= base
    assert got[1][1024:] == frames[1][0].tobytes() + frames[1][1].tobytes()


@pytest.mark.parametrize("sub_pkg", ["port", "jax"])
def test_bf16_chunks_ride_as_bits(sub_pkg):
    """A port sink's bf16 chunk crosses as its uint16 bit patterns; a
    port source delivers a CPU bf16 tensor, a JAX one an ml_dtypes
    array with the same bits."""
    caps = ('other/tensors,format=static,num_tensors=1,'
            'types=(string)bfloat16,dimensions=(string)4')
    bits = np.array([0x3F80, 0xC000, 0x7FC0, 0x0001], np.uint16)
    broker = MqttBroker(port=0).start()
    sub = _sub(sub_pkg, broker.bound_port, "bf")
    sub.start()
    time.sleep(0.2)
    pub = _pub("port", broker.bound_port, "bf", caps=caps)
    pub.start()
    try:
        pub["in"].push_buffer(pt.Buffer.from_arrays(
            [torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)]))
        assert _wait(lambda: sub["out"].buffers)
    finally:
        pub["in"].end_stream()
        pub.stop()
        sub.stop()
        broker.stop()
    got = sub["out"].buffers[0].chunks[0].host()
    if sub_pkg == "port":
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
        got = got.view(torch.int16).numpy().view(np.uint16)
    else:
        assert got.dtype == ml_dtypes.bfloat16
        got = np.asarray(got).view(np.uint16)
    np.testing.assert_array_equal(got, bits)


def test_source_chunks_are_writable():
    broker = MqttBroker(port=0).start()
    sub = _sub("port", broker.bound_port, "w")
    sub.start()
    time.sleep(0.2)
    pub = _pub("port", broker.bound_port, "w")
    pub.start()
    try:
        pub["in"].push_buffer(pt.Buffer.from_arrays(
            [np.arange(4, dtype=np.float32)]))
        assert _wait(lambda: sub["out"].buffers)
    finally:
        pub["in"].end_stream()
        pub.stop()
        sub.stop()
        broker.stop()
    arr = sub["out"].buffers[0].chunks[0].host()
    assert arr.flags.writeable
    arr[0] = 9.0


def test_sink_reads_a_buffer_in_one_copy_batch(monkeypatch):
    """mqttsink reads every chunk of a buffer through one
    ``Buffer.fetch_host`` (one coalesced D2H fetch on the card)."""
    from nnstreamer_tpu_torch.tensors.buffer import Buffer
    calls = []
    real = Buffer.fetch_host

    def counting(self):
        calls.append(len(self.chunks))
        return real(self)

    monkeypatch.setattr(Buffer, "fetch_host", counting)
    caps = ('other/tensors,format=static,num_tensors=2,'
            'types=(string)"float32,float32",dimensions=(string)"4,4"')
    got = _published("port", [[np.zeros(4, np.float32)] * 2] * 2, caps)
    assert len(got) == 2 and calls == [2, 2]


# -- packet goldens ---------------------------------------------------------------

class TestMqttPacketGoldens:
    """MQTT 3.1.1 golden bytes (tests/test_mqtt.py's), on the port's
    codec, and the JAX codec's bytes for the same packets."""

    def test_connect_packet_bytes(self):
        pkt = mw.connect_packet("ab", keepalive=60)
        assert pkt == bytes.fromhex(
            "10" "0e" "00044d515454" "04" "02" "003c" "00026162")
        assert pkt == nt_mw.connect_packet("ab", keepalive=60)

    def test_subscribe_packet_bytes(self):
        pkt = mw.subscribe_packet(1, ["a/b"])
        assert pkt == bytes.fromhex("82" "08" "0001" "0003612f62" "00")
        assert pkt == nt_mw.subscribe_packet(1, ["a/b"])

    def test_publish_packet_bytes(self):
        pkt = mw.publish_packet("t", b"\x01\x02")
        assert pkt == bytes.fromhex("30" "05" "000174" "0102")

    def test_publish_qos1_packet_bytes(self):
        pkt = mw.publish_packet("t", b"\x01\x02", qos=1, packet_id=9)
        assert pkt == bytes.fromhex("32" "07" "000174" "0009" "0102")
        dup = mw.publish_packet("t", b"\x01\x02", qos=1, packet_id=9,
                                dup=True)
        assert dup == bytes.fromhex("3a" "07" "000174" "0009" "0102")
        assert dup == nt_mw.publish_packet("t", b"\x01\x02", qos=1,
                                           packet_id=9, dup=True)
        assert mw.parse_publish_full(dup[0] & 0x0F, dup[2:]) == (
            "t", b"\x01\x02", 1, 9, True)

    def test_puback_packet_bytes(self):
        assert mw.puback_packet(9) == bytes.fromhex("40" "02" "0009")

    def test_subscribe_qos1_packet_bytes(self):
        pkt = mw.subscribe_packet(2, ["a/b"], qos=1)
        assert pkt == bytes.fromhex("82" "08" "0002" "0003612f62" "01")
        assert mw.parse_subscribe(pkt[2:]) == (2, [("a/b", 1)])

    def test_varint_boundaries(self):
        for n, enc in ((0, b"\x00"), (127, b"\x7f"),
                       (128, b"\x80\x01"), (16383, b"\xff\x7f"),
                       (16384, b"\x80\x80\x01"),
                       (268_435_455, b"\xff\xff\xff\x7f")):
            assert mw.encode_varint(n) == enc == nt_mw.encode_varint(n)
            assert mw.decode_varint(io.BytesIO(enc).read) == n

    def test_topic_filter_semantics(self):
        for sub, topic, want in (("a/+/c", "a/b/c", True),
                                 ("a/+/c", "a/b/d", False),
                                 ("a/#", "a/b/c/d", True),
                                 ("a/#", "b", False),
                                 ("a/+", "a/b/c", False)):
            assert mw.topic_matches(sub, topic) is want
            assert nt_mw.topic_matches(sub, topic) is want

    def test_msg_hdr_layout(self):
        """The reference's 1024-byte GstMQTTMessageHdr
        (mqttcommon.h:49-63): num_mems@0, size_mems[16]@8, epochs@136,
        caps@176; the JAX package's bytes."""
        hdr = mw.pack_msg_hdr([7, 9], "caps-str", 111, 222, 5, None, 42)
        assert hdr == nt_mw.pack_msg_hdr([7, 9], "caps-str", 111, 222, 5,
                                         None, 42)
        assert len(hdr) == 1024
        assert struct.unpack_from("<I", hdr, 0)[0] == 2
        assert struct.unpack_from("<QQ", hdr, 8) == (7, 9)
        assert struct.unpack_from("<qq", hdr, 136) == (111, 222)
        assert struct.unpack_from("<QQQ", hdr, 152) == (
            5, mw.CLOCK_TIME_NONE, 42)
        assert hdr[176:176 + 9] == b"caps-str\x00"
        assert mw.unpack_msg_hdr(hdr) == (
            [7, 9], "caps-str", 111, 222, 5, None, 42)

    def test_msg_hdr_refuses_more_than_16_memories(self):
        with pytest.raises(ValueError, match="16"):
            mw.pack_msg_hdr([1] * 17, "", 0, 0, None, None, None)


# -- QoS 1 ------------------------------------------------------------------------

class _FlakyAckBroker:
    """One-client fake broker that withholds the first ``drop_first``
    PUBACKs (or closes instead), recording each PUBLISH's (id, DUP)."""

    def __init__(self, drop_first=1, close_instead=False):
        self.drop_first = drop_first
        self.close_instead = close_instead
        self.seen = []
        self.srv = socket.socket()
        self.srv.bind(("localhost", 0))
        self.srv.listen(4)
        self.port = self.srv.getsockname()[1]
        threading.Thread(target=self._serve, daemon=True).start()

    def _serve(self):
        while True:
            try:
                conn, _ = self.srv.accept()
            except OSError:
                return
            try:
                ptype, _, _ = mw.read_packet(conn)
                assert ptype == mw.CONNECT
                conn.sendall(mw.connack_packet())
                while True:
                    ptype, flags, body = mw.read_packet(conn)
                    if ptype != mw.PUBLISH:
                        continue
                    _t, _p, qos, pid, dup = mw.parse_publish_full(
                        flags, body)
                    self.seen.append((pid, dup))
                    if qos == 1 and self.drop_first > 0:
                        self.drop_first -= 1
                        if self.close_instead:
                            conn.close()
                            break
                        continue
                    if qos == 1:
                        conn.sendall(mw.puback_packet(pid))
            except (ConnectionError, OSError, AssertionError):
                pass

    def stop(self):
        try:
            self.srv.close()
        except OSError:
            pass


def test_qos1_retransmits_with_dup_on_ack_timeout():
    fake = _FlakyAckBroker(drop_first=1)
    c = mw.MqttClient("localhost", fake.port, "dup-test",
                      ack_timeout=0.3, max_retries=2)
    c.publish("t", b"payload", qos=1)
    c.close()
    fake.stop()
    assert fake.seen[0][1] is False
    assert (fake.seen[0][0], True) in fake.seen[1:]
    assert c.take_unacked() == []


def test_qos1_redelivery_over_reconnect():
    fake = _FlakyAckBroker(drop_first=1, close_instead=True)
    c1 = mw.MqttClient("localhost", fake.port, "re-test",
                       ack_timeout=0.3, max_retries=1)
    with pytest.raises(ConnectionError):
        c1.publish("edge/re", b"precious", qos=1)
    pending = c1.take_unacked()
    assert pending == [("edge/re", b"precious")]
    c1.close()
    fake.stop()
    broker = MqttBroker(port=0).start()
    try:
        sub = mw.MqttClient("localhost", broker.bound_port, "re-sub")
        sub.subscribe("edge/re", qos=1)
        c2 = mw.MqttClient("localhost", broker.bound_port, "re-test2")
        c2.redeliver(pending)
        sub.settimeout(5.0)
        assert sub.recv_publish() == ("edge/re", b"precious")
        sub.close()
        c2.close()
    finally:
        broker.stop()


def test_qos1_ack_timeout_mid_large_publish_keeps_stream_sync():
    """An ack wait that times out while a large interleaved PUBLISH is
    mid-body keeps the partial packet buffered: the retransmit goes out
    and both the large message and the ack arrive intact."""
    srv = socket.socket()
    srv.bind(("localhost", 0))
    srv.listen(1)
    port = srv.getsockname()[1]
    big = bytes(range(256)) * 4096  # 1 MiB
    seen = []

    def serve():
        conn, _ = srv.accept()
        ptype, _, _ = mw.read_packet(conn)
        assert ptype == mw.CONNECT
        conn.sendall(mw.connack_packet())
        ptype, flags, body = mw.read_packet(conn)
        _t, _p, _q, pid, dup = mw.parse_publish_full(flags, body)
        seen.append((pid, dup))
        pkt = mw.publish_packet("bulk", big)
        conn.sendall(pkt[:len(pkt) // 2])
        time.sleep(0.7)      # the client's 0.3 s ack wait runs out mid-body
        ptype, flags, body = mw.read_packet(conn)
        _t, _p, _q, pid2, dup2 = mw.parse_publish_full(flags, body)
        seen.append((pid2, dup2))
        conn.sendall(pkt[len(pkt) // 2:])
        conn.sendall(mw.puback_packet(pid))
        time.sleep(0.2)
        conn.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    c = mw.MqttClient("localhost", port, "sync-test",
                      ack_timeout=0.3, max_retries=3)
    c.settimeout(WAIT_S)
    c.publish("t", b"x", qos=1)
    topic, payload = c.recv_publish()
    c.close()
    srv.close()
    t.join(timeout=5)
    assert (topic, payload) == ("bulk", big)
    assert seen[0][1] is False and seen[1] == (seen[0][0], True)


def test_qos1_sink_survives_broker_outage():
    """mqtt-qos=1 against a broker that dies and comes back on the same
    port: frames published into the outage are held, then redelivered
    in order."""
    broker = MqttBroker(port=0).start()
    port = broker.bound_port
    pub = _pub("port", port, "edge/out", "mqtt-qos=1")
    pub.start()
    broker2 = sub = None
    try:
        pub["in"].push_buffer(pt.Buffer.from_arrays(
            [np.full(4, 0.0, np.float32)]))
        time.sleep(0.3)
        broker.stop()
        time.sleep(0.2)
        for v in (1.0, 2.0):
            pub["in"].push_buffer(pt.Buffer.from_arrays(
                [np.full(4, v, np.float32)]))
        assert _wait(lambda: len(pub["snk"]._q1_backlog) >= 1)
        broker2 = MqttBroker(port=port).start()
        sub = mw.MqttClient("localhost", port, "outage-sub")
        sub.subscribe("edge/out", qos=1)
        sub.settimeout(WAIT_S)
        time.sleep(1.2)   # past the sink's reconnect backoff
        pub["in"].push_buffer(pt.Buffer.from_arrays(
            [np.full(4, 3.0, np.float32)]))
        got = []
        for _ in range(3):
            _t, payload = sub.recv_publish()
            got.append(float(np.frombuffer(payload[1024:], np.float32)[0]))
    finally:
        pub["in"].end_stream()
        pub.stop()
        if sub is not None:
            sub.close()
        if broker2 is not None:
            broker2.stop()
    assert got == [1.0, 2.0, 3.0]


def test_qos1_backlog_drops_the_oldest_past_max_backlog():
    """With no broker, mqtt-qos=1 holds at most max-backlog frames and
    counts what it dropped."""
    broker = MqttBroker(port=0).start()
    port = broker.bound_port
    pub = _pub("port", port, "edge/cap", "mqtt-qos=1 max-backlog=2")
    pub.start()
    try:
        broker.stop()
        for v in range(5):
            pub["in"].push_buffer(pt.Buffer.from_arrays(
                [np.full(4, float(v), np.float32)]))
        assert _wait(lambda: pub["snk"].stats["backlog_dropped"] >= 1)
        assert len(pub["snk"]._q1_backlog) <= 2
    finally:
        pub["in"].end_stream()
        pub.stop()


def test_interop_with_real_broker_if_present():
    """Round trip through a system broker on localhost:1883 when one
    runs; skipped otherwise."""
    try:
        mw.MqttClient("localhost", 1883, "nns-probe", timeout=1.0).close()
    except OSError:
        pytest.skip("no MQTT broker on localhost:1883")
    sub = _sub("port", 1883, "nns/torch-test")
    sub.start()
    time.sleep(0.3)
    pub = _pub("port", 1883, "nns/torch-test")
    pub.start()
    try:
        pub["in"].push_buffer(pt.Buffer.from_arrays(
            [np.full(4, 8.0, np.float32)]))
        assert _wait(lambda: sub["out"].buffers)
    finally:
        pub["in"].end_stream()
        pub.stop()
        sub.stop()
    np.testing.assert_array_equal(sub["out"].buffers[0].chunks[0].host(),
                                  np.full(4, 8.0, np.float32))


# -- NTP --------------------------------------------------------------------------

def _fake_sntp(ahead_s):
    """A one-shot SNTP server whose clock runs ``ahead_s`` ahead."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    srv.bind(("localhost", 0))
    srv.settimeout(WAIT_S)

    def serve_once():
        try:
            _data, addr = srv.recvfrom(512)
        except OSError:
            return
        now = time.time() + ahead_s
        secs = int(now) + 2208988800
        frac = int((now % 1.0) * (1 << 32))
        reply = bytearray(48)
        reply[0] = (0 << 6) | (4 << 3) | 4
        reply[32:40] = struct.pack("!II", secs, frac)
        reply[40:48] = struct.pack("!II", secs, frac)
        srv.sendto(bytes(reply), addr)

    t = threading.Thread(target=serve_once, daemon=True)
    t.start()
    return srv, t


def test_sntp_query_against_fake_server():
    from nnstreamer_tpu_torch.edge.ntp import query_offset
    srv, t = _fake_sntp(10.0)
    try:
        off = query_offset("localhost", srv.getsockname()[1], timeout=5.0)
    finally:
        t.join(5)
        srv.close()
    assert abs(off - 10.0) < 0.5


def test_synced_epoch_uses_the_best_offset():
    from nnstreamer_tpu_torch.edge.ntp import synced_epoch_ns
    srv, t = _fake_sntp(-20.0)
    try:
        now = synced_epoch_ns(f"localhost:1,localhost:{srv.getsockname()[1]}",
                              timeout=2.0)
    finally:
        t.join(5)
        srv.close()
    assert abs(now - time.time_ns() + 20e9) < 0.5e9


def test_ntp_fallback_when_unreachable():
    from nnstreamer_tpu_torch.edge.ntp import best_offset, synced_epoch_ns
    assert best_offset("localhost:1", timeout=0.2) == 0.0
    assert abs(synced_epoch_ns(None) - time.time_ns()) < 0.5e9


def test_ntp_sync_source_falls_back_to_the_local_clock():
    """mqttsrc ntp-sync=true with no server answering stamps its base
    time from the local clock and still receives."""
    broker = MqttBroker(port=0).start()
    sub = _sub("port", broker.bound_port, "n",
               "ntp-sync=true ntp-srvs=localhost:1 ntp-timeout=0.2")
    sub.start()
    try:
        assert abs(sub["src"]._base_epoch_ns - time.time_ns()) < 5e9
    finally:
        sub.stop()
        broker.stop()
