"""In-process MQTT 3.1.1 broker for tensor pub/sub.

Port of ``nnstreamer_tpu/edge/mqtt.py``, which is framework neutral: a
copy over the port's ``mqtt_wire`` and ``TcpListener``.

≙ the external MQTT broker (mosquitto) the reference's gst/mqtt elements
talk to (mqttsink.c:29). Speaks the real MQTT 3.1.1 packet layer
(edge/mqtt_wire.py) — CONNECT/CONNACK, SUBSCRIBE/SUBACK, PUBLISH qos0/
qos1 fan-out with PUBACK, PINGREQ/PINGRESP — so standard clients (Paho,
mosquitto_pub/sub) interop with it, and the mqttsrc/mqttsink elements
can equally be pointed at a real mosquitto instead.

Unlike the query DiscoveryBroker (control plane only), this broker is a
data plane: the tensor bytes flow through it, exactly like raw
GstBuffer-over-MQTT in the reference.
"""
from __future__ import annotations

import socket
import threading
from struct import error as struct_error
from typing import Dict, List, Tuple

from ..utils.log import logger
from . import mqtt_wire as mw
from .listener import TcpListener


class MqttBroker:
    """Minimal MQTT 3.1.1 topic fan-out broker (qos0 + qos1).

    qos1 semantics (clean-session, like mosquitto with persistence off):
    inbound qos1 PUBLISHes are PUBACKed; fan-out rides each
    subscription's granted qos (min(published, subscribed)), with a
    per-subscriber packet id and the subscriber's PUBACKs consumed.
    Outbound qos1 fan-out is send-once: the broker does not retransmit
    to a subscriber that never PUBACKs (publisher-side redelivery plus
    the subscriber's reconnect-and-resubscribe cover the at-least-once
    contract end to end)."""

    def __init__(self, host: str = "localhost", port: int = 0):
        self._listener = TcpListener(host, port, self._conn_loop,
                                     name="mqtt-broker", backlog=64)
        self._lock = threading.Lock()
        # subscriber conn -> ([(filter, granted qos)], send lock, state)
        self._subs: Dict[socket.socket,
                         Tuple[List[Tuple[str, int]], threading.Lock,
                               Dict[str, int]]] = {}
        # EVERY live conn (publishers too): stop() must close them all,
        # or publisher threads zombie in read_packet holding half-open
        # sockets that confuse reconnecting clients
        self._conns: set = set()

    @property
    def bound_port(self) -> int:
        return self._listener.bound_port

    def start(self) -> "MqttBroker":
        self._listener.start()
        return self

    def stop(self) -> None:
        self._listener.stop()
        with self._lock:
            conns = list(self._conns)
            self._conns.clear()
            self._subs.clear()
        for c in conns:
            try:
                c.close()
            except OSError:
                pass

    def _conn_loop(self, conn: socket.socket) -> None:
        send_lock = threading.Lock()  # also guards publisher PUBACKs
        with self._lock:
            self._conns.add(conn)
        try:
            ptype, _, _ = mw.read_packet(conn)
            if ptype != mw.CONNECT:
                return
            conn.sendall(mw.connack_packet())
            while not self._listener.stop_evt.is_set():
                ptype, flags, body = mw.read_packet(conn)
                if ptype == mw.SUBSCRIBE:
                    pid, topics = mw.parse_subscribe(body)
                    # grant at most qos1 per filter (§3.9: return codes
                    # echo the granted qos)
                    granted = [(t, min(q, 1)) for t, q in topics]
                    with self._lock:
                        subs, lock, state = self._subs.setdefault(
                            conn, ([], send_lock, {"pid": 0}))
                        subs.extend(granted)
                    with lock:
                        conn.sendall(mw.suback_packet(
                            pid, [q for _, q in granted]))
                elif ptype == mw.PUBLISH:
                    topic, payload, qos, pid, _dup = \
                        mw.parse_publish_full(flags, body)
                    if qos == 1 and pid:
                        # at-least-once inbound: ack BEFORE fan-out — on
                        # a clean-session broker, ownership transfers at
                        # receipt (mosquitto does the same)
                        with send_lock:
                            conn.sendall(mw.puback_packet(pid))
                    self._fan_out(topic, payload, qos)
                elif ptype == mw.PUBACK:
                    pass  # subscriber confirmed a qos1 delivery
                elif ptype == mw.PINGREQ:
                    with send_lock:
                        conn.sendall(mw.pingresp_packet())
                elif ptype == mw.DISCONNECT:
                    break
        except (ConnectionError, OSError, ValueError, struct_error):
            pass
        finally:
            with self._lock:
                self._subs.pop(conn, None)
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _fan_out(self, topic: str, payload: bytes, qos: int = 0) -> None:
        with self._lock:
            targets = []
            for c, (subs, lock, state) in self._subs.items():
                match_q = [q for s, q in subs if mw.topic_matches(s, topic)]
                if match_q:
                    # effective delivery qos = min(published, granted)
                    targets.append((c, lock, state, min(qos, max(match_q))))
        pkt0 = mw.publish_packet(topic, payload)
        for conn, lock, state, out_q in targets:
            try:
                with lock:  # serialize per subscriber, not globally
                    if out_q == 1:
                        state["pid"] = (state["pid"] % 0xFFFF) + 1
                        conn.sendall(mw.publish_packet(
                            topic, payload, qos=1,
                            packet_id=state["pid"]))
                    else:
                        conn.sendall(pkt0)
            except (ConnectionError, OSError):
                with self._lock:
                    self._subs.pop(conn, None)
                logger.info("mqtt broker: dropped dead subscriber")
