"""tensor_src_grpc / tensor_sink_grpc — real gRPC tensor bridge with
protobuf or flatbuf IDL.

Port of ``nnstreamer_tpu/elements/grpc.py``: the same services, methods
and payload bytes, so a JAX ``tensor_sink_grpc`` feeds a port
``tensor_src_grpc`` and the reverse. Both IDLs go through the port's
``interop/tensor_codec.py``. The sink reads a buffer's chunks on the
host in one copy batch (``Buffer.fetch_host``: the chunks still on the
card join one coalesced D2H fetch, not one blocking copy each) and packs
after it; bfloat16 rides as its uint16 bit patterns and arrives as a
CPU ``torch.bfloat16`` tensor. ``grpc`` is imported when an element
starts, never when this module is imported: without grpcio the elements
stay registered and ``start()`` raises an error that names grpcio.

≙ ext/nnstreamer/tensor_source/tensor_src_grpc.c +
tensor_sink/tensor_sink_grpc.c over the C++ core in
ext/nnstreamer/extra/nnstreamer_grpc*.cc. The transport is the actual
gRPC/HTTP2 stack (grpcio — the Python analog of the grpc++ library the
reference links), exposing the reference's TensorService verbatim:

    /nnstreamer.protobuf.TensorService/SendTensors   (client-streaming)
    /nnstreamer.protobuf.TensorService/RecvTensors   (server-streaming)

(and the ``nnstreamer.flatbuf`` service for ``idl=flatbuf``,
≙ nnstreamer.proto:44-50 / nnstreamer.fbs:60-66). Message payloads are
the byte-per-schema ``Tensors`` encodings from interop/tensor_codec.py,
registered as raw-bytes method handlers, so a stock gRPC client built
from the reference's .proto interoperates directly.

Either element can play either role (4 topologies): ``server=true``
hosts the service; ``server=false`` dials a remote TensorService.
"""
from __future__ import annotations

import queue as _pyqueue
import threading
import time
from typing import Any, List, Optional

from ..interop import tensor_codec as tc
from ..pipeline.element import SinkElement, SrcElement
from ..pipeline.pad import Pad
from ..pipeline.registry import register_element
from ..tensors.buffer import Buffer, Chunk
from ..tensors.caps import Caps
from ..tensors.info import TensorInfo, TensorsConfig, TensorsInfo
from ..tensors.types import TensorType
from ..utils.log import logger

_IDL = {
    "protobuf": (tc.pack_protobuf, tc.unpack_protobuf),
    "flatbuf": (tc.pack_flatbuf, tc.unpack_flatbuf),
}

_SENTINEL = object()

# a minimal valid FlatBuffers message holding an empty root table
# (root offset 4 -> table at 8 whose soffset points back to the 2-field
# vtable at 4): protobuf's Empty serializes to b"", flatbuf's does NOT —
# a stock client generated from nnstreamer.fbs reads a real root table
_FLATBUF_EMPTY = bytes([8, 0, 0, 0, 4, 0, 4, 0, 4, 0, 0, 0])


def _grpc():
    """The grpcio module, imported at start (see the module doc)."""
    try:
        import grpc
    except ImportError as e:
        raise ImportError("tensor_src_grpc/tensor_sink_grpc need the grpcio "
                          "package, which is not installed") from e
    return grpc


def _service_name(idl: str) -> str:
    return f"nnstreamer.{idl}.TensorService"


def _caps_for_frame(frame: tc.Frame) -> Caps:
    infos = TensorsInfo(
        TensorInfo(n or None, TensorType.from_dtype(a.dtype), a.shape)
        for n, a in zip(frame.names, frame.arrays))
    return Caps.from_config(TensorsConfig(
        infos, rate_n=frame.rate_n, rate_d=frame.rate_d))


class _Endpoint:
    """gRPC plumbing shared by both elements.

    Server role: hosts TensorService with raw-bytes handlers —
    SendTensors feeds ``on_frame``, RecvTensors streams per-subscriber
    queues filled by ``send``. Client role: dials the remote service;
    ``send`` feeds a client-streaming SendTensors call, ``on_frame``
    receives a server-streaming RecvTensors call.
    """

    def __init__(self, element, is_server: bool, host: str, port: int,
                 idl: str, on_frame=None):
        self.element = element
        self.is_server = is_server
        self.host, self.port = host, int(port)
        self.idl = idl
        self.on_frame = on_frame
        self.stop_evt = threading.Event()
        self.lock = threading.Lock()
        self.peers_changed = threading.Condition()
        self._server = None
        self._channel = None
        self._bound = int(port)
        self._subs: List[Any] = []        # per-subscriber queues (server)
        # client-streaming feed; None = not in that role OR stream dead
        self._sendq: Optional[_pyqueue.Queue] = None

    @property
    def bound_port(self) -> int:
        return self._bound

    def peer_count(self) -> int:
        with self.lock:
            n = len(self._subs)
        if not self.is_server:
            # sender liveness = the stream feed; receiver = the channel
            alive = (self._sendq is not None if self.on_frame is None
                     else self._channel is not None)
            n += 1 if alive else 0
        return n

    # -- server role ------------------------------------------------------
    def _serve(self) -> None:
        from concurrent import futures
        grpc = _grpc()

        ep = self

        def send_tensors(request_iterator, context):
            # client-streaming ingest (≙ SyncServiceImpl::SendTensors)
            with ep.lock:
                ep._subs.append(context)  # count the streamer as a peer
            with ep.peers_changed:
                ep.peers_changed.notify_all()
            try:
                for raw in request_iterator:
                    if ep.stop_evt.is_set():
                        break
                    if ep.on_frame is not None:
                        ep.on_frame(raw)
            finally:
                with ep.lock:
                    if context in ep._subs:
                        ep._subs.remove(context)
            return b"" if ep.idl == "protobuf" else _FLATBUF_EMPTY

        def recv_tensors(request, context):
            # server-streaming feed (≙ SyncServiceImpl::RecvTensors)
            import queue as _q
            sub: "_q.Queue" = _q.Queue(maxsize=64)
            with ep.lock:
                ep._subs.append(sub)
            with ep.peers_changed:
                ep.peers_changed.notify_all()
            try:
                while not ep.stop_evt.is_set() and context.is_active():
                    try:
                        item = sub.get(timeout=0.1)
                    except _q.Empty:
                        continue
                    if item is _SENTINEL:
                        return
                    yield item
            finally:
                with ep.lock:
                    if sub in ep._subs:
                        ep._subs.remove(sub)

        handlers = grpc.method_handlers_generic_handler(
            _service_name(self.idl), {
                "SendTensors": grpc.stream_unary_rpc_method_handler(
                    send_tensors),
                "RecvTensors": grpc.unary_stream_rpc_method_handler(
                    recv_tensors),
            })
        # each streaming handler parks a pool thread for its stream's
        # whole lifetime, so max_workers is the concurrent-peer ceiling
        self._server = grpc.server(
            futures.ThreadPoolExecutor(
                max_workers=32,
                thread_name_prefix=f"grpc:{self.element.name}"))
        self._server.add_generic_rpc_handlers((handlers,))
        self._bound = self._server.add_insecure_port(
            f"{self.host}:{self.port}")
        if not self._bound:
            raise ConnectionError(
                f"{self.element.name}: cannot bind {self.host}:{self.port}")
        self._server.start()

    # -- client role ------------------------------------------------------
    def _dial(self, receiving: bool, timeout: float) -> None:
        grpc = _grpc()
        self._channel = grpc.insecure_channel(f"{self.host}:{self.port}")
        try:
            # timeout<=0 means "wait forever for FRAMES" on the element,
            # not "hang start() forever on a down peer" — cap the
            # connect wait so startup always terminates
            grpc.channel_ready_future(self._channel).result(
                timeout=timeout if timeout > 0 else 10.0)
        except grpc.FutureTimeoutError as e:
            self._channel.close()
            self._channel = None
            raise ConnectionError(
                f"{self.element.name}: no gRPC server at "
                f"{self.host}:{self.port}") from e
        svc = _service_name(self.idl)
        if receiving:
            # the Empty request must be a VALID message of the IDL:
            # protobuf's Empty is zero bytes, flatbuf's is a real root
            # table a stock generated server deserializes
            empty = _FLATBUF_EMPTY if self.idl == "flatbuf" else b""
            call = self._channel.unary_stream(f"/{svc}/RecvTensors")(
                empty, wait_for_ready=True)

            def pump():
                try:
                    for raw in call:
                        if self.stop_evt.is_set():
                            break
                        if self.on_frame is not None:
                            self.on_frame(raw)
                except grpc.RpcError as e:
                    if not self.stop_evt.is_set():
                        logger.warning("%s: grpc stream ended: %s",
                                       self.element.name, e)
            self._call = call
        else:
            sendq: "_pyqueue.Queue" = _pyqueue.Queue(maxsize=64)
            self._sendq = sendq

            def feed():
                while True:
                    try:
                        item = sendq.get(timeout=0.1)
                    except _pyqueue.Empty:
                        if self.stop_evt.is_set():
                            return
                        continue
                    if item is _SENTINEL:
                        return
                    yield item

            def pump():
                try:
                    self._channel.stream_unary(f"/{svc}/SendTensors")(
                        feed(), wait_for_ready=True)
                except grpc.RpcError as e:
                    if not self.stop_evt.is_set():
                        logger.warning("%s: grpc send stream failed: %s",
                                       self.element.name, e)
                finally:
                    # stream over (peer died or shutdown): send() must
                    # stop claiming delivery and stop queueing payloads
                    self._sendq = None
                with self.peers_changed:
                    self.peers_changed.notify_all()
        threading.Thread(target=pump, daemon=True,
                         name=f"grpc-pump:{self.element.name}").start()

    def open(self, receiving: bool, timeout: float = 10.0) -> None:
        self.stop_evt.clear()
        if self.is_server:
            self._serve()
        else:
            self._dial(receiving, timeout)

    # -- data -------------------------------------------------------------
    def send(self, payload: bytes) -> int:
        """Hand one serialized frame to every live consumer; returns the
        number of consumers it reached."""
        sendq = self._sendq
        if sendq is not None:  # client-streaming feed (nulled when dead)
            try:
                sendq.put_nowait(payload)
                return 1
            except _pyqueue.Full:  # stream stalled: drop, report undeliverable
                return 0
        if not self.is_server:
            return 0  # client role with a dead stream
        with self.lock:
            subs = [s for s in self._subs if hasattr(s, "put")]
        for sub in subs:
            try:
                sub.put_nowait(payload)
            except Exception:  # noqa: BLE001 — slow subscriber: drop
                pass
        return len(subs)

    def close(self) -> None:
        self.stop_evt.set()
        sendq = self._sendq
        if sendq is not None:
            try:
                sendq.put_nowait(_SENTINEL)
            except _pyqueue.Full:
                pass  # feed() also exits via stop_evt
        with self.lock:
            subs = [s for s in self._subs if hasattr(s, "put")]
        for sub in subs:
            try:
                sub.put_nowait(_SENTINEL)
            except Exception:  # noqa: BLE001
                pass
        call = getattr(self, "_call", None)
        if call is not None:
            call.cancel()
        if self._server is not None:
            self._server.stop(grace=0.5)
            self._server = None
        if self._channel is not None:
            self._channel.close()
            self._channel = None
        with self.peers_changed:
            self.peers_changed.notify_all()


@register_element("tensor_sink_grpc")
class GrpcSink(SinkElement):
    """Outbound: serializes each tensors frame to the IDL and streams it
    over gRPC — SendTensors caller when client, RecvTensors feeder when
    server."""

    PROPS = {"host": "localhost", "port": 55115, "server": True,
             "blocking": True, "idl": "protobuf", "silent": True,
             "timeout": 10.0}  # seconds to wait for a peer; <=0 = forever

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._ep: Optional[_Endpoint] = None
        self._config: Optional[TensorsConfig] = None

    @property
    def bound_port(self) -> int:
        return self._ep.bound_port if self._ep else self.port

    def start(self) -> None:
        super().start()
        if self.idl not in _IDL:
            raise ValueError(f"{self.name}: unknown idl {self.idl!r} "
                             "(protobuf|flatbuf)")
        self._ep = _Endpoint(self, self.server, self.host, self.port,
                             self.idl)
        self._ep.open(receiving=False, timeout=float(self.timeout))

    def stop(self) -> None:
        if self._ep is not None:
            self._ep.close()
            self._ep = None
        super().stop()

    def on_sink_caps(self, pad: Pad, caps: Caps) -> None:
        self._config = caps.to_config()

    def handle_event(self, pad, event) -> None:
        from ..pipeline.events import CapsEvent
        if isinstance(event, CapsEvent):
            pad.set_caps(event.caps)
            self.on_sink_caps(pad, event.caps)
            return
        super().handle_event(pad, event)

    def render(self, buf: Buffer) -> None:
        cfg = self._config
        names = ([i.name or "" for i in cfg.info]
                 if cfg and len(cfg.info) else None)
        # one coalesced fetch for every chunk still on the card, then pack
        frame = tc.Frame(buf.fetch_host(), names,
                         cfg.rate_n if cfg else 0,
                         cfg.rate_d if cfg else 1)
        payload = _IDL[self.idl][0](frame)
        ep = self._ep  # stop() nulls the attribute while we run
        if ep is None:
            return
        if ep.peer_count() == 0 and self.blocking:
            # blocking mode (≙ the reference's 'blocking' sync stream):
            # wait for a consumer instead of dropping the frame; the
            # reference blocks indefinitely — timeout<=0 matches that
            wait_s = float(self.timeout)
            deadline = (time.monotonic() + wait_s) if wait_s > 0 else None
            with ep.peers_changed:
                while not ep.stop_evt.is_set():
                    if ep.peer_count() or (deadline is not None and
                                           time.monotonic() > deadline):
                        break
                    ep.peers_changed.wait(timeout=0.1)
        if ep.send(payload) == 0 and not self.silent:
            # distinguish the two drop causes: backpressure (peer alive
            # but its stream queue is full) vs genuinely no consumer
            if ep.peer_count():
                logger.warning("%s: peer stream stalled (send queue "
                               "full), frame dropped", self.name)
            else:
                logger.warning("%s: no connected peer, frame dropped",
                               self.name)


@register_element("tensor_src_grpc")
class GrpcSrc(SrcElement):
    """Inbound: receives IDL-serialized tensors frames over gRPC —
    SendTensors service when server, RecvTensors consumer when client —
    and pushes them into the pipeline."""

    # (no 'blocking' knob here: the src is inherently pull-blocking via
    # 'timeout'; an ignored property would mislead, so it is omitted)
    PROPS = {"host": "localhost", "port": 55115, "server": True,
             "idl": "protobuf", "silent": True, "timeout": 10.0}

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._ep: Optional[_Endpoint] = None
        self._queue: List[tc.Frame] = []
        self._qcond = threading.Condition()
        self._caps_sent = False

    @property
    def bound_port(self) -> int:
        return self._ep.bound_port if self._ep else self.port

    def negotiate_src_caps(self) -> Optional[Caps]:
        return None  # caps derive from the first received frame

    def start(self) -> None:
        if self.idl not in _IDL:
            raise ValueError(f"{self.name}: unknown idl {self.idl!r} "
                             "(protobuf|flatbuf)")
        unpack = _IDL[self.idl][1]

        def on_frame(raw: bytes) -> None:
            try:
                frame = unpack(raw)
            except Exception:  # noqa: BLE001 — malformed foreign message
                logger.warning("%s: undecodable %s message dropped",
                               self.name, self.idl)
                return
            with self._qcond:
                self._queue.append(frame)
                self._qcond.notify_all()

        self._ep = _Endpoint(self, self.server, self.host, self.port,
                             self.idl, on_frame=on_frame)
        self._caps_sent = False
        self._ep.open(receiving=True, timeout=float(self.timeout))
        super().start()

    def stop(self) -> None:
        if self._ep is not None:
            self._ep.close()
            self._ep = None
        with self._qcond:
            self._qcond.notify_all()
        super().stop()

    def create(self) -> Optional[Buffer]:
        # timeout<=0 = wait forever, matching the sink's blocking prop
        wait_s = float(self.timeout)
        deadline = (time.monotonic() + wait_s) if wait_s > 0 else None
        with self._qcond:
            while not self._queue:
                if self._stop_evt.is_set() or (
                        deadline is not None
                        and time.monotonic() > deadline):
                    if not self.silent and not self._stop_evt.is_set():
                        logger.warning("%s: no frame within timeout",
                                       self.name)
                    return None
                self._qcond.wait(timeout=0.1)
            frame = self._queue.pop(0)
        if not self._caps_sent:
            self.set_src_caps(_caps_for_frame(frame))
            self._caps_sent = True
        return Buffer([Chunk(a) for a in frame.arrays])
