"""mqttsink / mqttsrc — tensor streams over a real MQTT 3.1.1 broker,
with cross-device base-time synchronization.

Port of ``nnstreamer_tpu/elements/mqtt.py``: the same properties, packets
and payloads, byte for byte, so a JAX ``mqttsink`` feeds a port
``mqttsrc`` and the reverse. The sink reads a buffer's chunks on the
host in one copy batch (``Buffer.fetch_host``: the chunks still on the
card join one coalesced D2H fetch, not one blocking copy each); bfloat16
rides as its uint16 bit patterns, as the reference's raw memories, and
the source delivers it as a CPU ``torch.bfloat16`` tensor. The source's
chunks are writable host arrays over one copy of each message.

≙ gst/mqtt/mqttsink.c + mqttsrc.c (GstBuffer over Paho MQTT): the
transport is the actual MQTT wire protocol (edge/mqtt_wire.py), so these
elements interop with mosquitto or any standard broker — the in-process
MqttBroker (edge/mqtt.py) is just a convenient one. Each PUBLISH payload
is the reference's GstMQTTMessageHdr layout (mqttcommon.h:49-63): a
1024-byte header carrying num_mems/size_mems/base & sent epoch (ns)/
duration/dts/pts/caps-string, followed by the raw tensor memories — so
payloads are byte-compatible with reference publishers/subscribers.

Re-timing (ref: Documentation/synchronization-in-mqtt-elements.md):

    buf.pts = hdr.pts + (hdr.base_time_epoch - sub.base_time_epoch)

With ``ntp-sync=true`` the base-time epoch comes from the configured NTP
servers (``ntp-srvs``, ≙ mqtt-ntp-sync/mqtt-ntp-srvs + ntputil.c)
instead of the local clock, so devices whose clocks drift still agree.
"""
from __future__ import annotations

import socket
import threading
import time
from typing import Optional

import numpy as np

from ..edge import mqtt_wire as mw
from ..edge.ntp import synced_epoch_ns
from ..edge.protocol import (as_payload_view, host_array, host_value,
                             resolve_dtype)
from ..pipeline.element import SinkElement, SrcElement
from ..pipeline.pad import Pad
from ..pipeline.registry import register_element
from ..tensors.buffer import Buffer, Chunk
from ..tensors.caps import Caps
from ..utils.log import logger


@register_element("mqttsink")
class MqttSink(SinkElement):
    # mqtt-qos: 0 (default, fire-and-forget — the reference mqttsink's
    # DEFAULT_MQTT_QOS) or 1 (at-least-once: each publish waits for the
    # broker's PUBACK and retransmits with DUP; unconfirmed frames are
    # redelivered over a fresh connection). Named "mqtt-qos" exactly as
    # the reference (mqttsink.c:314) because the base sink owns "qos"
    # (latency-based frame dropping) — two different knobs.
    # max-backlog bounds the qos1 hold queue during a broker outage:
    # when full, the OLDEST frame drops (counted in stats) — unbounded
    # retention would OOM the process on a long outage, losing
    # everything instead of the tail
    PROPS = {"host": "localhost", "port": 1883, "pub-topic": "",
             "client-id": "", "ntp-sync": False,
             "ntp-srvs": "pool.ntp.org:123", "ntp-timeout": 2.0,
             "mqtt-qos": 0, "max-backlog": 256, "debug": False}

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._client: Optional[mw.MqttClient] = None
        self._caps_str = ""
        self._base_epoch_ns = 0
        self._base_mono_ns = 0
        # qos1 frames not yet confirmed by any broker (send order);
        # survives reconnect failures — at-least-once means held, not
        # dropped, until a broker acks them (bounded by max-backlog)
        self._q1_backlog: list = []
        self._next_reconnect = 0.0
        # exponential reconnect spacing: a long outage must not pay a
        # 2 s connect stall on every render (reset on the first flush
        # that reaches the broker again)
        from ..fault.backoff import Backoff
        self._reconnect_backoff = Backoff(base=0.25, multiplier=2.0,
                                          max_s=5.0)
        self.stats["backlog_dropped"] = 0

    def _connect(self, timeout: float = 10.0) -> mw.MqttClient:
        """The one connect site: start() and the qos1 reconnect must
        never drift apart in connection options."""
        return mw.MqttClient(
            self.host, int(self.port),
            self.client_id or f"nns-tpu-sink-{id(self):x}",
            timeout=timeout)

    def start(self) -> None:
        super().start()
        if not self.pub_topic:
            raise ValueError(f"{self.name}: 'pub-topic' is required")
        # base-time: the universal-time instant this sink went live
        self._base_epoch_ns = synced_epoch_ns(
            self.ntp_srvs if self.ntp_sync else None, self.ntp_timeout)
        self._base_mono_ns = time.monotonic_ns()
        self._client = self._connect()

    def stop(self) -> None:
        if self._q1_backlog:
            # last best-effort flush: a backlog held through a broker
            # outage gets one final shot (skipping the backoff gate)
            # before the held frames are declared — a failure here must
            # still reach close(), never leak the client
            self._next_reconnect = 0.0
            try:
                self._flush_qos1()
            except Exception:  # noqa: BLE001 — stop() must complete
                logger.warning("%s: final qos1 flush failed",
                               self.name, exc_info=True)
        if self._q1_backlog:
            logger.warning("%s: stopping with %d unconfirmed qos1 "
                           "frame(s)", self.name, len(self._q1_backlog))
        if self._client is not None:
            self._client.close()
            self._client = None
        super().stop()

    def on_sink_caps(self, pad: Pad, caps: Caps) -> None:
        self._caps_str = str(caps)

    def handle_event(self, pad, event) -> None:
        from ..pipeline.events import CapsEvent
        if isinstance(event, CapsEvent):
            pad.set_caps(event.caps)
            self.on_sink_caps(pad, event.caps)
            return
        super().handle_event(pad, event)

    def render(self, buf: Buffer) -> None:
        client = self._client
        if client is None and int(self.mqtt_qos) < 1:
            # qos0 with no connection: fire-and-forget has nowhere to
            # fire. qos1 proceeds WITHOUT a client — _flush_qos1 owns
            # reconnection, and a frame rendered while the broker is
            # down must be HELD in the backlog, not silently dropped
            return
        # one copy batch for every chunk still on the card, then each
        # chunk's bytes as a view (bf16 as its bit patterns)
        mems = [as_payload_view(host_array(h)[0])
                for h in buf.fetch_host()]
        pts = buf.pts
        if pts is None:
            # no timestamp: synthesize the running time at publish
            pts = time.monotonic_ns() - self._base_mono_ns
        # sent-time derives from the start() epoch + monotonic delta: one
        # NTP exchange per element lifetime, none on the streaming path
        sent_epoch = self._base_epoch_ns + (
            time.monotonic_ns() - self._base_mono_ns)
        hdr = mw.pack_msg_hdr([len(m) for m in mems], self._caps_str,
                              self._base_epoch_ns, sent_epoch,
                              buf.duration, buf.dts, pts)
        payload = hdr + b"".join(mems)
        if int(self.mqtt_qos) >= 1:
            self._q1_backlog.append((self.pub_topic, payload))
            self._flush_qos1()
        else:
            client.publish(self.pub_topic, payload)
        if self.debug:
            logger.info("%s: published pts=%s to %s", self.name, pts,
                        self.pub_topic)

    def _flush_qos1(self) -> None:
        """Drain the at-least-once backlog, reconnecting on a dead
        broker link. Frames a dead client could not confirm are
        reclaimed (take_unacked) and kept in order; a failed reconnect
        HOLDS the backlog for the next render instead of dropping it,
        and leaves no closed client behind to poison later sends.

        Two stall guards keep the streaming thread live through an
        outage: reconnects use a short (2 s) connect timeout and back
        off exponentially (0.25 s doubling to 5 s) after failures
        (frames keep accumulating in the backlog meanwhile, they just
        don't each pay a connect attempt; the ladder resets once a
        flush succeeds), and the backlog is capped at max-backlog
        (oldest frame drops, counted — bounded memory beats a certain
        OOM that would lose every held frame anyway)."""
        cap = max(1, int(self.max_backlog))
        while len(self._q1_backlog) > cap:
            self._q1_backlog.pop(0)
            self.stats.inc("backlog_dropped")
        if self._client is None and time.monotonic() < self._next_reconnect:
            return  # back off: let frames queue without a connect stall
        for _attempt in range(2):
            try:
                if self._client is None:
                    self._client = self._connect(timeout=2.0)
                while self._q1_backlog:
                    topic, payload = self._q1_backlog.pop(0)
                    # on failure the message sits in client._unacked,
                    # reclaimed below — popped-then-lost cannot happen
                    self._client.publish(topic, payload, qos=1)
                self._reconnect_backoff.reset()
                return
            except (ConnectionError, OSError) as exc:
                dead, self._client = self._client, None
                if dead is not None:
                    self._q1_backlog = dead.take_unacked() \
                        + self._q1_backlog
                    dead.close()
                delay = self._reconnect_backoff.next()
                self._next_reconnect = time.monotonic() + delay
                logger.warning("%s: qos1 publish failed (%s); %d "
                               "frame(s) held for redelivery, next "
                               "reconnect in %.2fs", self.name, exc,
                               len(self._q1_backlog), delay)


@register_element("mqttsrc")
class MqttSrc(SrcElement):
    # is-live: accepted for launch-line compatibility (standard basesrc
    # prop on the reference's mqttsrc); this source is inherently live —
    # frames arrive from the broker in real time either way
    # mqtt-qos: requested subscription qos (granted = min(1, requested)
    # by the broker; qos1 deliveries are PUBACKed by the client layer).
    # Reference-parity name (mqttsrc.c:291) — "qos" belongs to base-sink
    # latency throttling, not to MQTT.
    # reconnect=true: a dropped broker link is re-dialed with
    # exponential backoff within the timeout budget instead of ending
    # the stream as EOS (false restores the old die-on-drop behavior)
    PROPS = {"host": "localhost", "port": 1883, "sub-topic": "",
             "client-id": "", "ntp-sync": False,
             "ntp-srvs": "pool.ntp.org:123", "ntp-timeout": 2.0,
             "timeout": 10.0, "is-live": True, "mqtt-qos": 0,
             "reconnect": True, "debug": False}

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._client: Optional[mw.MqttClient] = None
        self._base_epoch_ns = 0
        self._caps_sent = False
        self._caps_cache: tuple = ("", None, None)  # (str, Caps, infos)
        self.stats.update({"reconnects": 0, "link_errors": 0})

    def negotiate_src_caps(self) -> Optional[Caps]:
        # caps arrive with the first message; negotiated in-stream
        return None

    def _connect_subscribe(self) -> mw.MqttClient:
        """The one dial site (start() and every reconnect): connect,
        arm the per-op timeout, subscribe."""
        client = mw.MqttClient(
            self.host, int(self.port),
            self.client_id or f"nns-tpu-src-{id(self):x}",
            timeout=self.timeout)
        client.settimeout(self.timeout)
        client.subscribe(self.sub_topic, qos=int(self.mqtt_qos))
        return client

    def _reconnect(self) -> bool:
        """Re-dial after a dropped broker link; True when resubscribed.
        Bounded by the timeout budget so a permanently-gone broker
        still ends the stream instead of spinning forever."""
        from ..fault.backoff import Backoff
        client, self._client = self._client, None
        if client is not None:
            client.close()
        deadline = time.monotonic() + float(self.timeout)
        backoff = Backoff(base=0.1, multiplier=2.0, max_s=2.0)
        while time.monotonic() < deadline and not self._stop_evt.is_set():
            try:
                self._client = self._connect_subscribe()
            except (ConnectionError, OSError) as exc:
                logger.info("%s: reconnect attempt failed: %r",
                            self.name, exc)
                backoff.sleep(self._stop_evt)
                continue
            self.stats.inc("reconnects")
            self.post_message("warning",
                              reconnects=self.stats["reconnects"],
                              detail="broker link re-established")
            return True
        return False

    def start(self) -> None:
        if not self.sub_topic:
            raise ValueError(f"{self.name}: 'sub-topic' is required")
        self._base_epoch_ns = synced_epoch_ns(
            self.ntp_srvs if self.ntp_sync else None, self.ntp_timeout)
        self._client = self._connect_subscribe()
        self._caps_sent = False
        super().start()

    def stop(self) -> None:
        # order matters: flag the stop BEFORE closing the socket so a
        # create() racing us re-checks the event instead of touching a
        # nulled client
        self._stop_evt.set()
        client = self._client
        self._client = None
        if client is not None:
            client.close()
        super().stop()

    def create(self) -> Optional[Buffer]:
        while not self._stop_evt.is_set():
            client = self._client
            if client is None:
                return None
            try:
                _topic, payload = client.recv_publish()
            except socket.timeout:
                logger.warning("%s: no message within timeout", self.name)
                return None
            except (ConnectionError, OSError, ValueError) as exc:
                if self._stop_evt.is_set():
                    return None
                self.stats.inc("link_errors")
                logger.info("%s: broker link lost (%r)", self.name, exc)
                if self.reconnect and self._reconnect():
                    continue
                return None
            if len(payload) < 1024:
                logger.warning("%s: short mqtt payload dropped", self.name)
                continue
            sizes, caps_str, pub_base, _sent, duration, dts, pts = \
                mw.unpack_msg_hdr(payload)
            # the caps string repeats verbatim frame after frame: parse
            # once and reuse off the hot path
            if caps_str and caps_str == self._caps_cache[0]:
                caps, infos = self._caps_cache[1], self._caps_cache[2]
            elif caps_str:
                caps = Caps(caps_str)
                infos = caps.to_config().info
                self._caps_cache = (caps_str, caps, infos)
            else:
                caps, infos = None, None
            if not self._caps_sent and caps is not None:
                self.set_src_caps(caps)
                self._caps_sent = True
            # one writable copy of the message; each chunk a view of it
            body = bytearray(memoryview(payload)[1024:])
            chunks, off = [], 0
            for i, sz in enumerate(sizes):
                raw = memoryview(body)[off:off + sz]
                off += sz
                if infos is not None and i < len(infos):
                    name = str(infos[i].type)
                    arr = np.frombuffer(raw, dtype=resolve_dtype(name)) \
                        .reshape(infos[i].shape)
                    chunks.append(Chunk(host_value(arr, name)))
                else:
                    chunks.append(Chunk(np.frombuffer(raw, np.uint8)))
            buf = Buffer(chunks, pts=pts, dts=dts, duration=duration)
            # re-time into this pipeline's clock domain (see module doc)
            if buf.pts is not None and pub_base:
                buf.pts = max(0, buf.pts + (pub_base - self._base_epoch_ns))
            if self.debug:
                logger.info("%s: received pts=%s", self.name, buf.pts)
            return buf
        return None
