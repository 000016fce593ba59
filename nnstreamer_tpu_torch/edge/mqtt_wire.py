"""MQTT 3.1.1 wire protocol — clean-room packet codec + minimal client.

Port of ``nnstreamer_tpu/edge/mqtt_wire.py``, which is framework
neutral: a copy, so the packets and the 1024-byte payload header are
the JAX package's byte for byte.

The reference's mqtt elements speak real MQTT through Eclipse Paho
against a standard broker (ref: gst/mqtt/mqttsink.c:29 MQTTAsync usage);
this module implements the needed subset of the MQTT 3.1.1 packet layer
(CONNECT/CONNACK, SUBSCRIBE/SUBACK, PUBLISH qos0 and qos1 with
PUBACK/DUP redelivery, PINGREQ/PINGRESP, DISCONNECT) from the public
spec, so mqttsrc/mqttsink interop with mosquitto/Paho peers, and the
in-process broker (edge/mqtt.py) accepts standard clients. qos0 remains
the default everywhere, matching the reference's mqttsink.

Also provides the reference's tensor-message payload header layout
(GstMQTTMessageHdr, ref: gst/mqtt/mqttcommon.h:49-63 — a 1024-byte
prefix carrying num_mems/size_mems[16]/base & sent epoch/duration/dts/
pts/caps-string) so payloads are byte-compatible with reference
publishers and subscribers.
"""
from __future__ import annotations

import socket
import struct
import threading
import time
from typing import List, Optional, Tuple

from ..utils.log import logger

# -- packet types (MQTT 3.1.1 §2.2.1) -----------------------------------------
CONNECT = 0x1
CONNACK = 0x2
PUBLISH = 0x3
PUBACK = 0x4
SUBSCRIBE = 0x8
SUBACK = 0x9
UNSUBSCRIBE = 0xA
UNSUBACK = 0xB
PINGREQ = 0xC
PINGRESP = 0xD
DISCONNECT = 0xE

CLOCK_TIME_NONE = 2 ** 64 - 1  # ≙ GST_CLOCK_TIME_NONE

# GstMQTTMessageHdr: guint num_mems (+4 pad), gsize size_mems[16],
# gint64 base/sent epoch (ns), GstClockTime duration/dts/pts,
# char caps[512]; the union pads the whole struct to 1024 bytes
# (ref: mqttcommon.h:29-63)
_HDR_FMT = "<I4x16QqqQQQ512s"
_HDR_LEN = 1024
_MAX_NUM_MEMS = 16


# -- primitives ---------------------------------------------------------------

def encode_varint(n: int) -> bytes:
    """Remaining-length encoding (§2.2.3): 7 bits per byte, MSB = more."""
    if n < 0 or n > 268_435_455:
        raise ValueError(f"mqtt remaining length out of range: {n}")
    out = bytearray()
    while True:
        n, digit = divmod(n, 128)
        out.append(digit | (0x80 if n else 0))
        if not n:
            return bytes(out)


def decode_varint(read) -> int:
    mult, value = 1, 0
    for _ in range(4):
        b = read(1)
        if not b:
            raise ConnectionError("mqtt: eof in remaining length")
        value += (b[0] & 0x7F) * mult
        if not b[0] & 0x80:
            return value
        mult *= 128
    raise ValueError("mqtt: malformed remaining length")


def _utf8(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack(">H", len(b)) + b


def _packet(ptype: int, flags: int, body: bytes) -> bytes:
    return bytes([(ptype << 4) | flags]) + encode_varint(len(body)) + body


# -- packet builders ----------------------------------------------------------

def connect_packet(client_id: str, keepalive: int = 60,
                   clean_session: bool = True) -> bytes:
    flags = 0x02 if clean_session else 0x00
    body = (_utf8("MQTT") + bytes([4, flags])
            + struct.pack(">H", keepalive) + _utf8(client_id))
    return _packet(CONNECT, 0, body)


def connack_packet(session_present: bool = False, rc: int = 0) -> bytes:
    return _packet(CONNACK, 0, bytes([1 if session_present else 0, rc]))


def subscribe_packet(packet_id: int, topics: List[str], qos: int = 0) -> bytes:
    body = struct.pack(">H", packet_id)
    for t in topics:
        body += _utf8(t) + bytes([qos])
    return _packet(SUBSCRIBE, 0x2, body)  # §3.8.1: reserved flags = 0b0010


def suback_packet(packet_id: int, rcs: List[int]) -> bytes:
    return _packet(SUBACK, 0, struct.pack(">H", packet_id) + bytes(rcs))


def publish_packet(topic: str, payload: bytes, qos: int = 0,
                   retain: bool = False, packet_id: Optional[int] = None,
                   dup: bool = False) -> bytes:
    """qos0 fire-and-forget or qos1 at-least-once (§3.3: packet id after
    the topic, DUP set on retransmission). qos2 exactly-once is not
    supported — the reference's mqttsink rides Paho with qos as a
    property and the tensor-stream use case is at-least-once at most."""
    if qos not in (0, 1):
        raise NotImplementedError("qos2 (exactly-once) not supported")
    flags = (0x8 if dup else 0) | (qos << 1) | (0x1 if retain else 0)
    body = _utf8(topic)
    if qos:
        if not packet_id:
            raise ValueError("qos1 publish requires a nonzero packet id")
        body += struct.pack(">H", packet_id)
    return _packet(PUBLISH, flags, body + payload)


def puback_packet(packet_id: int) -> bytes:
    """§3.4: the at-least-once acknowledgment for a qos1 PUBLISH."""
    return _packet(PUBACK, 0, struct.pack(">H", packet_id))


def pingreq_packet() -> bytes:
    return _packet(PINGREQ, 0, b"")


def pingresp_packet() -> bytes:
    return _packet(PINGRESP, 0, b"")


def disconnect_packet() -> bytes:
    return _packet(DISCONNECT, 0, b"")


# -- packet reader ------------------------------------------------------------

def read_packet(sock: socket.socket) -> Tuple[int, int, bytes]:
    """Read one packet: (type, flags, body). Raises ConnectionError on EOF."""
    def _read(n: int) -> bytes:
        data = b""
        while len(data) < n:
            chunk = sock.recv(n - len(data))
            if not chunk:
                raise ConnectionError("mqtt: connection closed")
            data += chunk
        return data

    first = _read(1)[0]
    length = decode_varint(_read)
    body = _read(length) if length else b""
    return first >> 4, first & 0x0F, body


def parse_publish_full(flags: int, body: bytes
                       ) -> Tuple[str, bytes, int, Optional[int], bool]:
    """(topic, payload, qos, packet_id, dup) from a PUBLISH packet."""
    tlen = struct.unpack(">H", body[:2])[0]
    topic = body[2:2 + tlen].decode("utf-8")
    off = 2 + tlen
    qos = (flags >> 1) & 0x3
    dup = bool(flags & 0x8)
    packet_id = None
    if qos:
        packet_id = struct.unpack(">H", body[off:off + 2])[0]
        off += 2  # packet id present only for qos 1/2
    return topic, body[off:], qos, packet_id, dup


def parse_publish(flags: int, body: bytes) -> Tuple[str, bytes]:
    """(topic, payload) from a PUBLISH body; skips the packet id for
    qos>0 senders so foreign publishers parse too."""
    topic, payload, _, _, _ = parse_publish_full(flags, body)
    return topic, payload


def parse_subscribe(body: bytes) -> Tuple[int, List[Tuple[str, int]]]:
    """(packet_id, [(topic filter, requested qos), ...]) — §3.8."""
    packet_id = struct.unpack(">H", body[:2])[0]
    topics, off = [], 2
    while off < len(body):
        tlen = struct.unpack(">H", body[off:off + 2])[0]
        topic = body[off + 2:off + 2 + tlen].decode("utf-8")
        topics.append((topic, body[off + 2 + tlen] & 0x3))
        off += 2 + tlen + 1
    return packet_id, topics


def topic_matches(sub: str, topic: str) -> bool:
    """MQTT topic filter match: '+' one level, '#' multi-level tail."""
    if sub == topic:
        return True
    sp, tp = sub.split("/"), topic.split("/")
    for i, s in enumerate(sp):
        if s == "#":
            return True
        if i >= len(tp) or (s != "+" and s != tp[i]):
            return False
    return len(sp) == len(tp)


# -- reference payload header (GstMQTTMessageHdr) -----------------------------

def pack_msg_hdr(sizes: List[int], caps: str, base_time_epoch_ns: int,
                 sent_time_epoch_ns: int, duration: Optional[int],
                 dts: Optional[int], pts: Optional[int]) -> bytes:
    if len(sizes) > _MAX_NUM_MEMS:
        raise ValueError(f"mqtt payload limited to {_MAX_NUM_MEMS} memories "
                         "(GST_MQTT_MAX_NUM_MEMS)")
    mems = list(sizes) + [0] * (_MAX_NUM_MEMS - len(sizes))
    raw = struct.pack(
        _HDR_FMT, len(sizes), *mems, base_time_epoch_ns, sent_time_epoch_ns,
        CLOCK_TIME_NONE if duration is None else duration,
        CLOCK_TIME_NONE if dts is None else dts,
        CLOCK_TIME_NONE if pts is None else pts,
        caps.encode("utf-8")[:511])
    return raw + b"\x00" * (_HDR_LEN - len(raw))


def unpack_msg_hdr(data: bytes):
    """-> (sizes, caps, base_epoch, sent_epoch, duration, dts, pts),
    payload offset is always 1024."""
    vals = struct.unpack_from(_HDR_FMT, data)
    num = vals[0]
    sizes = list(vals[1:1 + num])
    base_e, sent_e, duration, dts, pts = vals[17:22]
    caps = vals[22].split(b"\x00", 1)[0].decode("utf-8", "replace")

    def opt(v):
        return None if v == CLOCK_TIME_NONE else v

    return sizes, caps, base_e, sent_e, opt(duration), opt(dts), opt(pts)


# -- minimal blocking client --------------------------------------------------

class MqttClient:
    """A tiny synchronous MQTT 3.1.1 client (qos0/qos1), good enough for
    the tensor stream elements: connect, subscribe, publish (waiting for
    PUBACK and retransmitting with DUP at qos1), recv_publish (PUBACKing
    inbound qos1 deliveries). Single reader thread assumed — the
    elements use one client per role."""

    # keepalive=0 disables the broker's idle timeout (§3.1.2.10): the
    # tensor elements have no ping loop, and a sparse publisher must not
    # be disconnected by a real mosquitto after 1.5x keepalive
    def __init__(self, host: str, port: int, client_id: str,
                 timeout: float = 10.0, keepalive: int = 0,
                 ack_timeout: float = 5.0, max_retries: int = 2):
        self._sock = socket.create_connection((host, int(port)),
                                              timeout=timeout)
        self._send_lock = threading.Lock()
        self._packet_id = 0
        self._queued: List[Tuple[str, bytes]] = []
        self._ack_timeout = ack_timeout
        self._max_retries = max_retries
        # receive buffer: partial packets survive a socket timeout (a
        # multi-MB tensor PUBLISH interleaved with an ack wait must not
        # be torn mid-body, or the stream desyncs permanently)
        self._rxbuf = bytearray()
        # qos1 publishes awaiting PUBACK: pid -> (seq, topic, payload).
        # On a dead connection these survive for take_unacked()/
        # redeliver() on a fresh client — the at-least-once reconnect
        # story (≙ Paho MQTTAsync redelivery, which the reference's
        # mqttsink rides). seq is a monotonic send counter: packet ids
        # wrap at 16 bits, so sorting by pid would misorder a drain
        # that straddles the wrap
        self._unacked: dict = {}
        self._send_seq = 0
        try:
            self._sock.sendall(connect_packet(client_id, keepalive))
            ptype, _, body = self._read_packet()
            if ptype != CONNACK or len(body) < 2 or body[1] != 0:
                raise ConnectionError(
                    f"mqtt: connect refused (type={ptype}, body={body!r})")
        except Exception as exc:
            # the cause must reach the log even when a caller's retry
            # loop swallows the re-raise (satellite: no silent failures)
            logger.warning("mqtt: connect to %s:%s as %r failed: %r",
                           host, port, client_id, exc)
            self._sock.close()
            raise

    def settimeout(self, t: Optional[float]) -> None:
        self._sock.settimeout(t)

    # -- buffered packet reader (partial packets survive timeouts) --------
    def _try_parse(self) -> Optional[Tuple[int, int, bytes]]:
        buf = self._rxbuf
        if len(buf) < 2:
            return None
        mult, length, i = 1, 0, 1
        while True:
            if i >= len(buf):
                return None  # varint itself incomplete
            b = buf[i]
            length += (b & 0x7F) * mult
            i += 1
            if not b & 0x80:
                break
            mult *= 128
            if i > 4:
                raise ValueError("mqtt: malformed remaining length")
        total = i + length
        if len(buf) < total:
            return None
        first = buf[0]
        body = bytes(buf[i:total])
        del self._rxbuf[:total]  # buf aliases _rxbuf: extract first
        return first >> 4, first & 0x0F, body

    def _read_packet(self, timeout: Optional[float] = None
                     ) -> Tuple[int, int, bytes]:
        """Read one complete packet. ``timeout=None`` honors the
        socket's configured timeout per recv; an explicit timeout is a
        deadline for packet COMPLETION. Either way socket.timeout leaves
        already-received bytes buffered — the stream stays in sync."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            pkt = self._try_parse()
            if pkt is not None:
                return pkt
            if deadline is None:
                chunk = self._sock.recv(65536)
            else:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise socket.timeout("mqtt: packet wait timed out")
                prev = self._sock.gettimeout()
                self._sock.settimeout(remaining)
                try:
                    chunk = self._sock.recv(65536)
                finally:
                    try:
                        self._sock.settimeout(prev)
                    except OSError:
                        pass
            if not chunk:
                raise ConnectionError("mqtt: connection closed")
            self._rxbuf += chunk

    def subscribe(self, topic: str, qos: int = 0) -> None:
        self._packet_id = (self._packet_id % 0xFFFF) + 1
        with self._send_lock:
            self._sock.sendall(
                subscribe_packet(self._packet_id, [topic], qos=qos))
        # the broker may interleave PUBLISHes before SUBACK (it registers
        # the subscription first); queue them for recv_publish — tolerate
        # means deliver, not discard
        while True:
            ptype, flags, body = self._read_packet()
            if ptype == SUBACK:
                if body[2:] and body[2] >= 0x80:
                    raise ConnectionError(f"mqtt: subscribe refused {body!r}")
                return
            if ptype == PUBLISH:
                self._queued.append(self._accept_publish(flags, body))

    def _accept_publish(self, flags: int, body: bytes) -> Tuple[str, bytes]:
        """Parse an inbound PUBLISH, PUBACKing qos1 deliveries (§4.3.2:
        at-least-once — ack after taking ownership; a DUP redelivery is
        handed to the app, which is the qos1 contract)."""
        topic, payload, qos, pid, _dup = parse_publish_full(flags, body)
        if qos == 1 and pid:
            with self._send_lock:
                self._sock.sendall(puback_packet(pid))
        return topic, payload

    def recv_publish(self) -> Tuple[str, bytes]:
        """Block until the next PUBLISH; answers PINGREQ in passing."""
        if self._queued:
            return self._queued.pop(0)
        while True:
            ptype, flags, body = self._read_packet()
            if ptype == PUBLISH:
                return self._accept_publish(flags, body)
            if ptype == PINGREQ:
                with self._send_lock:
                    self._sock.sendall(pingresp_packet())

    def publish(self, topic: str, payload: bytes, qos: int = 0) -> None:
        """qos0: fire and forget. qos1: block until the broker PUBACKs,
        retransmitting with the DUP flag up to ``max_retries`` times on
        ack timeout; raises ConnectionError when the message could not
        be confirmed (it stays in :meth:`take_unacked` for redelivery
        on a reconnected client)."""
        if qos == 0:
            with self._send_lock:
                self._sock.sendall(publish_packet(topic, payload))
            return
        self._packet_id = (self._packet_id % 0xFFFF) + 1
        pid = self._packet_id
        self._send_seq += 1
        self._unacked[pid] = (self._send_seq, topic, payload)
        self._publish_qos1(pid, topic, payload, dup=False)

    def _publish_qos1(self, pid: int, topic: str, payload: bytes,
                      dup: bool) -> None:
        for attempt in range(self._max_retries + 1):
            with self._send_lock:
                self._sock.sendall(publish_packet(
                    topic, payload, qos=1, packet_id=pid,
                    dup=dup or attempt > 0))
            try:
                if self._wait_puback(pid, self._ack_timeout):
                    return
            except socket.timeout:
                continue  # retransmit with DUP; partial rx stays buffered
        raise ConnectionError(
            f"mqtt: no PUBACK for packet {pid} after "
            f"{self._max_retries + 1} attempts")

    def _wait_puback(self, pid: int, timeout: float) -> bool:
        """Read until the PUBACK for ``pid`` arrives; queue interleaved
        PUBLISHes, answer pings. socket.timeout propagates (with any
        half-read packet preserved in the rx buffer). The deadline is
        checked per packet, so a broker streaming complete PUBLISHes
        at high rate cannot stall the retransmit forever."""
        deadline = time.monotonic() + timeout
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise socket.timeout("mqtt: puback wait timed out")
            ptype, flags, body = self._read_packet(remaining)
            if ptype == PUBACK and len(body) >= 2:
                got = struct.unpack(">H", body[:2])[0]
                self._unacked.pop(got, None)
                if got == pid:
                    return True
            elif ptype == PUBLISH:
                self._queued.append(self._accept_publish(flags, body))
            elif ptype == PINGREQ:
                with self._send_lock:
                    self._sock.sendall(pingresp_packet())

    def take_unacked(self) -> List[Tuple[str, bytes]]:
        """Drain the qos1 messages this client could not confirm, in
        send order — feed them to :meth:`redeliver` on a fresh client
        after a reconnect. Ordered by the monotonic send sequence, NOT
        by packet id: pids wrap at 16 bits, and a drain straddling the
        wrap would otherwise replay new-before-old."""
        out = [(t, p) for _seq, t, p in
               sorted(self._unacked.values(), key=lambda v: v[0])]
        self._unacked.clear()
        return out

    def redeliver(self, messages: List[Tuple[str, bytes]]) -> None:
        """Republish messages taken from a dead client's
        :meth:`take_unacked`, DUP-flagged from the first transmission
        (the receiver may already own them — at-least-once). Fresh
        sequence numbers: redelivery order IS the new send order."""
        for topic, payload in messages:
            self._packet_id = (self._packet_id % 0xFFFF) + 1
            pid = self._packet_id
            self._send_seq += 1
            self._unacked[pid] = (self._send_seq, topic, payload)
            self._publish_qos1(pid, topic, payload, dup=True)

    def ping(self) -> None:
        with self._send_lock:
            self._sock.sendall(pingreq_packet())

    def close(self) -> None:
        try:
            with self._send_lock:
                self._sock.sendall(disconnect_packet())
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
