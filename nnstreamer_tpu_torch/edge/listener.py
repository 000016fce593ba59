"""Shared TCP listener scaffolding for the edge-layer servers.

A copy of ``nnstreamer_tpu/edge/listener.py``, which is framework
neutral. In the port it backs the discovery broker; the MQTT-style
broker and the gRPC bridge are not ported yet.

One implementation of the bind/SO_REUSEADDR/listen/accept-thread/close
pattern used by the discovery broker, the MQTT-style message broker,
and the gRPC bridge endpoints — so fixes to the accept/shutdown
behavior land everywhere at once.
"""
from __future__ import annotations

import socket
import threading
from typing import Callable, Optional


class TcpListener:
    """Owns a listening socket and an accept thread; calls ``on_conn``
    (from a fresh daemon thread per connection) for every client."""

    def __init__(self, host: str, port: int,
                 on_conn: Callable[[socket.socket], None],
                 name: str = "tcp-listener", backlog: int = 32,
                 spawn_thread: bool = True):
        self.host, self.port = host, int(port)
        self._on_conn = on_conn
        self._name = name
        self._backlog = backlog
        self._spawn = spawn_thread
        self._sock: Optional[socket.socket] = None
        self.stop_evt = threading.Event()

    @property
    def bound_port(self) -> int:
        return self._sock.getsockname()[1] if self._sock else self.port

    def start(self) -> "TcpListener":
        self.stop_evt.clear()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self.host, self.port))
        self._sock.listen(self._backlog)
        threading.Thread(target=self._accept_loop, name=self._name,
                         daemon=True).start()
        return self

    def stop(self) -> None:
        self.stop_evt.set()
        if self._sock is not None:
            try:
                # shutdown BEFORE close: closing an fd does NOT wake a
                # thread blocked in accept() on Linux — the thread would
                # zombie on the stale fd number, and when the kernel
                # recycles that fd for a new CLIENT socket the old
                # accept loop starts stealing from it (observed as
                # phantom half-open connections after a broker restart).
                # shutdown(SHUT_RDWR) wakes the blocked accept with an
                # error so the loop exits before the fd is reused.
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _accept_loop(self) -> None:
        while not self.stop_evt.is_set():
            sock = self._sock  # stop() may null the attribute concurrently
            if sock is None:
                return
            try:
                conn, _ = sock.accept()
            except OSError:
                return
            from .wire import tune_socket
            try:
                tune_socket(conn)
            except OSError:
                # peer died between accept and setsockopt: close the
                # fd instead of leaking it
                conn.close()
                continue
            if self._spawn:
                threading.Thread(target=self._on_conn, args=(conn,),
                                 name=f"{self._name}-conn",
                                 daemon=True).start()
            else:
                self._on_conn(conn)
