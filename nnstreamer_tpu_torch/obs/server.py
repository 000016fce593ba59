"""The per-process telemetry pull endpoint.

A copy of ``nnstreamer_tpu/obs/server.py``: the same routes and the
same broker registration, so the JAX package's :func:`scrape` and
``top`` read a port endpoint and the reverse. ``stop`` shuts the
listener down before closing it, which wakes the scrape thread's
``accept`` (the reference's bare close leaves it blocked).

A deliberately tiny HTTP/1.0 server over a plain listener socket (no
``http.server`` thread-per-request fan-out — scrapes are short and
serial, and one accept thread keeps the concurrency model trivially
auditable: racecheck seeds the SCRAPER role for ``_serve_loop``).

Routes:

* ``GET /metrics``  -> Prometheus text exposition (`metrics.render`)
* ``GET /flight``   -> the flight recorder's Chrome trace_event JSON
* ``GET /healthz``  -> ``ok``

``broker=(host, port)`` registers the endpoint on the discovery broker
under ``topic`` (default ``"obs"``) with role metadata, which is how
``python -m nnstreamer_tpu_torch top`` finds a fleet's endpoints; the
registration connection stays open for the server's lifetime (the
broker's liveness-by-connection contract).
"""
from __future__ import annotations

import json
import socket
import threading
from typing import Dict, Optional, Tuple

from ..utils.log import logger
from . import metrics
from .recorder import RECORDER

_MAX_REQUEST = 8192
_HDR = ("HTTP/1.0 {code}\r\nContent-Type: {ctype}\r\n"
        "Content-Length: {length}\r\nConnection: close\r\n\r\n")


class MetricsServer:
    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 broker: Optional[Tuple[str, int]] = None,
                 topic: str = "obs", labels: Optional[Dict] = None,
                 timeout: float = 5.0):
        self.host = host
        self.port = int(port)
        self.broker = broker
        self.topic = topic
        self.labels = dict(labels or {})
        self.timeout = float(timeout)
        self._listener: Optional[socket.socket] = None
        self._thread: Optional[threading.Thread] = None
        self._broker_sock: Optional[socket.socket] = None
        self._stop_evt = threading.Event()
        self.scrapes = 0

    @property
    def bound_port(self) -> int:
        return self._listener.getsockname()[1] if self._listener \
            else self.port

    def start(self) -> "MetricsServer":
        self._stop_evt.clear()
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((self.host, self.port))
        self._listener.listen(16)
        if self.broker is not None:
            from ..edge.protocol import MsgKind, send_msg
            try:
                self._broker_sock = socket.create_connection(
                    self.broker, timeout=self.timeout)
                send_msg(self._broker_sock, MsgKind.REGISTER,
                         {"topic": self.topic, "host": self.host,
                          "port": self.bound_port,
                          "meta": dict(self.labels, role="obs")})
            except OSError as exc:
                logger.warning("obs: broker registration failed: %s", exc)
                self._broker_sock = None
        self._thread = threading.Thread(
            target=self._serve_loop,
            name=f"obs-scrape:{self.bound_port}", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        from ..edge.protocol import sever_socket
        self._stop_evt.set()
        # shutdown() before close(): a bare close() does not wake the
        # accept() the scrape thread blocks in, so the join would wait
        # out its timeout and leave the thread behind
        for s in (self._broker_sock, self._listener):
            sever_socket(s)
        self._broker_sock = None
        self._listener = None
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5.0)
        self._thread = None

    # -- the scrape loop (racecheck role: SCRAPER) ---------------------
    def _serve_loop(self) -> None:
        while not self._stop_evt.is_set():
            try:
                conn, _addr = self._listener.accept()
            except OSError:
                return  # listener closed: shutdown
            try:
                conn.settimeout(self.timeout)
                self._handle(conn)
            except (OSError, ValueError) as exc:
                logger.info("obs: scrape connection failed: %r", exc)
            finally:
                try:
                    conn.close()
                except OSError:
                    pass

    def _handle(self, conn: socket.socket) -> None:
        data = b""
        while b"\r\n\r\n" not in data and len(data) < _MAX_REQUEST:
            chunk = conn.recv(2048)
            if not chunk:
                return
            data += chunk
        line = data.split(b"\r\n", 1)[0].decode("latin-1", "replace")
        parts = line.split()
        path = parts[1] if len(parts) >= 2 else "/"
        path = path.split("?", 1)[0]
        if path in ("/metrics", "/"):
            body = metrics.render().encode()
            ctype = "text/plain; version=0.0.4"
            code = "200 OK"
        elif path in ("/flight", "/flight.json", "/trace"):
            body = json.dumps(RECORDER.dump(reason="scrape")).encode()
            ctype = "application/json"
            code = "200 OK"
        elif path == "/healthz":
            body, ctype, code = b"ok\n", "text/plain", "200 OK"
        else:
            body, ctype, code = b"not found\n", "text/plain", \
                "404 Not Found"
        self.scrapes += 1  # racecheck: ok(single accept thread is the only writer; readers are test/diagnostic polls tolerant of a stale int)
        conn.sendall(_HDR.format(code=code, ctype=ctype,
                                 length=len(body)).encode() + body)


def scrape(host: str, port: int, path: str = "/metrics",
           timeout: float = 5.0) -> str:
    """One HTTP GET against a telemetry endpoint -> response body."""
    with socket.create_connection((host, int(port)), timeout=timeout) as s:
        s.sendall(f"GET {path} HTTP/1.0\r\nHost: {host}\r\n\r\n".encode())
        data = b""
        while True:
            chunk = s.recv(65536)
            if not chunk:
                break
            data += chunk
    head, _, body = data.partition(b"\r\n\r\n")
    status = head.split(b"\r\n", 1)[0].decode("latin-1", "replace")
    if " 200 " not in status + " ":
        raise ConnectionError(f"scrape {host}:{port}{path}: {status}")
    return body.decode("utf-8", "replace")
