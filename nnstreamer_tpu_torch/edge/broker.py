"""Discovery broker: the MQTT-hybrid control plane slot.

A copy of ``nnstreamer_tpu/edge/broker.py``, which is framework
neutral, with its live-broker registry (``live_broker_stats``, which the
tracer's ``broker`` block reads).

≙ the reference's hybrid connect-type, where servers publish their
host:port under a topic to an MQTT broker and clients query the broker
to pick a server — re-discovering an alternative when one dies
(ref: gst/nnstreamer/tensor_query/README.md:76-80 "getting server info
from broker", :79-80 re-discovery; connect-type enum
tensor_query_common.c:30-40). Bulk tensor data never touches the broker;
it rides the direct TCP/DCN connection, exactly like the reference.

Liveness is connection-based (the reference gets this from MQTT's
last-will): a server's REGISTER connection stays open for its lifetime,
and the broker drops its advertisement the moment the connection closes.
Because that drop runs on the dead server's own connection thread, a
QUERY racing the death could otherwise still see the corpse — so the
QUERY path additionally probes each advertised connection with a
zero-consume ``MSG_PEEK`` and prunes ones the kernel already knows are
closed: a FIN'd server is gone from the very next QUERY_ACK, not just
from the eventual cleanup.

Registrations may carry a ``meta`` dict (occupancy and the like, for
the fleet router's least-loaded dispatch); QUERY_ACK returns it in
``endpoints_meta``, parallel to ``endpoints``, so pre-metadata clients
keep working unchanged.
"""
from __future__ import annotations

import socket
import threading
import weakref
from typing import Dict, List, Tuple

from ..utils.atomic import Counters
from ..utils.log import logger
from .listener import TcpListener
from .protocol import MsgKind, recv_msg, send_msg

# live in-process brokers, for trace.report()'s broker block (tests and
# single-host fleets run the broker in-process; a weak set never keeps a
# stopped broker alive)
_LIVE: "weakref.WeakSet[DiscoveryBroker]" = weakref.WeakSet()


def live_broker_stats() -> Dict[str, int]:
    """Aggregate counters of every live in-process broker (the
    trace.report() surfacing hook). {} when no broker is running."""
    out: Dict[str, int] = {}
    for b in list(_LIVE):
        for k, v in b.stats.snapshot().items():
            if v:
                out[k] = out.get(k, 0) + v
    return out


class DiscoveryBroker:
    """Topic -> [(host, port), ...] registry over the edge protocol.

    Servers connect and send REGISTER {topic, host, port[, meta]},
    holding the connection open; clients connect, send QUERY {topic},
    and get a QUERY_ACK {endpoints, endpoints_meta} in registration
    order."""

    def __init__(self, host: str = "localhost", port: int = 0):
        self._listener = TcpListener(host, port, self._conn_loop,
                                     name="broker-accept")
        self._lock = threading.Lock()
        # topic -> ordered list of (endpoint, owning socket, meta dict)
        self._topics: Dict[str, List[Tuple[Tuple[str, int],
                                           socket.socket, Dict]]] = {}
        self.stats = Counters(broker_registers=0, broker_queries=0,
                              broker_errors=0)

    @property
    def bound_port(self) -> int:
        return self._listener.bound_port

    def start(self) -> "DiscoveryBroker":
        self._listener.start()
        _LIVE.add(self)
        return self

    def stop(self) -> None:
        _LIVE.discard(self)
        self._listener.stop()

    def entries(self, topic: str) -> List[Tuple[Tuple[str, int], Dict]]:
        """Pruned, CONSISTENT snapshot: [((host, port), meta), ...]
        taken under one lock acquisition. The QUERY_ACK derives both
        parallel lists from this, so a REGISTER / disconnect cleanup /
        concurrent prune landing between two separate reads can never
        misalign an endpoint with another replica's metadata."""
        self._prune_dead(topic)
        with self._lock:
            return [(ep, dict(info))
                    for ep, _, info in self._topics.get(topic, [])]

    def endpoints(self, topic: str) -> List[Tuple[str, int]]:
        return [ep for ep, _ in self.entries(topic)]

    # -- internals ----------------------------------------------------------
    def _prune_dead(self, topic: str) -> None:
        """Drop advertisements whose owning connection the kernel
        already knows is closed, BEFORE answering a QUERY: a server
        death must never outlive the next QUERY_ACK just because its
        connection thread hasn't been scheduled into its cleanup yet.
        ``MSG_PEEK | MSG_DONTWAIT`` consumes nothing, so it is safe
        against the owning thread's concurrent blocking recv."""
        with self._lock:
            entries = list(self._topics.get(topic, []))
        dead = []
        for ep, conn, _info in entries:
            try:
                if conn.recv(1, socket.MSG_PEEK | socket.MSG_DONTWAIT) == b"":
                    dead.append((ep, conn))  # orderly FIN: peer is gone
            except (BlockingIOError, InterruptedError):
                continue  # alive, just idle
            except OSError:
                dead.append((ep, conn))  # reset/closed fd: gone too
        if not dead:
            return
        with self._lock:
            self._topics[topic] = [
                e for e in self._topics.get(topic, [])
                if not any(e[0] == ep and e[1] is conn for ep, conn in dead)]
        logger.info("broker: pruned %d dead advertisement(s) on query",
                    len(dead))

    def _conn_loop(self, conn: socket.socket) -> None:
        registered: List[Tuple[str, Tuple[str, int]]] = []
        try:
            while not self._listener.stop_evt.is_set():
                kind, meta, _ = recv_msg(conn)
                if kind == MsgKind.REGISTER:
                    topic = meta["topic"]
                    ep = (meta["host"], int(meta["port"]))
                    info = meta.get("meta")
                    info = dict(info) if isinstance(info, dict) else {}
                    with self._lock:
                        self._topics.setdefault(topic, []).append(
                            (ep, conn, info))
                    registered.append((topic, ep))
                    self.stats.inc("broker_registers")
                    logger.info("broker: %s registered for topic %r",
                                ep, topic)
                elif kind == MsgKind.QUERY:
                    self.stats.inc("broker_queries")
                    snap = self.entries(meta["topic"])
                    send_msg(conn, MsgKind.QUERY_ACK,
                             {"endpoints": [ep for ep, _ in snap],
                              "endpoints_meta": [info for _, info in snap]})
                else:
                    break
        except ValueError:
            # malformed traffic, never silent: the control plane must be
            # diagnosable from counters when a bad peer hammers it
            self.stats.inc("broker_errors")
        except (ConnectionError, OSError):
            pass  # routine: a one-shot QUERY client closing, a server's
            # last-will disconnect — liveness bookkeeping, not an error
        finally:
            # connection gone = server gone: drop its advertisements
            # (≙ MQTT last-will removing a dead hybrid server)
            if registered:
                with self._lock:
                    for topic, ep in registered:
                        self._topics[topic] = [
                            e for e in self._topics.get(topic, [])
                            if e[1] is not conn]
                logger.info("broker: dropped %d advertisement(s) on "
                            "disconnect", len(registered))
            try:
                conn.close()
            except OSError:
                pass


def discover(broker_host: str, broker_port: int, topic: str,
             timeout: float = 5.0) -> List[Tuple[str, int]]:
    """One-shot client-side discovery: ask the broker who serves a topic."""
    return [ep for ep, _ in discover_meta(broker_host, broker_port, topic,
                                          timeout=timeout)]


def discover_meta(broker_host: str, broker_port: int, topic: str,
                  timeout: float = 5.0
                  ) -> List[Tuple[Tuple[str, int], Dict]]:
    """Discovery with registration metadata: [((host, port), meta), ...].
    Meta is {} for servers that registered without any (or through a
    pre-metadata broker)."""
    with socket.create_connection((broker_host, broker_port),
                                  timeout=timeout) as s:
        send_msg(s, MsgKind.QUERY, {"topic": topic})
        kind, meta, _ = recv_msg(s)
        if kind != MsgKind.QUERY_ACK:
            raise ConnectionError(f"broker: unexpected reply {kind}")
        eps = [(h, int(p)) for h, p in meta.get("endpoints", [])]
        infos = meta.get("endpoints_meta") or []
        infos = [i if isinstance(i, dict) else {} for i in infos]
        infos += [{}] * (len(eps) - len(infos))
        return list(zip(eps, infos))
