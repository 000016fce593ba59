"""The port's gRPC bridge (elements/grpc.py) against the JAX package's, on
the CPU.

Mirrors tests/test_grpc.py across packages: a sink and a source on
localhost, for both IDLs (protobuf, flatbuf) and both server roles (the
sink hosts RecvTensors and the source dials in, or the source hosts
SendTensors and the sink streams in), with the JAX package on one side
and the port on the other, and the port on both. Every frame arrives in
order with its bytes, dtypes and shapes, and the caps derived from the
first payload are the JAX package's. Then: an unknown IDL is refused, a
stock grpcio client's hand-encoded ``Tensors`` reaches the port's source,
bfloat16 rides as its bit patterns, and without grpcio the elements stay
registered and ``start()`` names grpcio.

Tolerance: none; every comparison is bitwise.
"""
import socket
import sys
import time

import ml_dtypes
import numpy as np
import pytest
import torch

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as pt

CAPS = ('other/tensors,format=static,num_tensors=2,'
        'types=(string)"float32,uint8",dimensions=(string)"4,2:3"')
PKGS = {"jax": nt, "port": pt}
FRAMES = 3
WAIT_S = 10.0


@pytest.fixture(autouse=True)
def _keep_element_name_counters():
    """Each package names an unnamed element from a process-wide counter;
    this file's lines (often in one package only) leave both counters as
    they found them, so a later file in the same process that compares
    the two packages' generated names sees what it would without this
    one."""
    from nnstreamer_tpu.pipeline.element import Element as NtElement
    from nnstreamer_tpu_torch.pipeline.element import Element
    saved = Element._anon_counter[0], NtElement._anon_counter[0]
    yield
    Element._anon_counter[0], NtElement._anon_counter[0] = saved


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _wait(pred, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return bool(pred())


def _frame(pkg, i):
    return PKGS[pkg].Buffer.from_arrays(
        [np.full(4, float(i) + 0.25, np.float32),
         np.arange(6, dtype=np.uint8).reshape(3, 2) + i])


def _bridge(sink_pkg, src_pkg, idl, sink_server, caps=CAPS, frames=None):
    """Run a sink/source pair over one port; the frames the source's
    appsink got, and that appsink."""
    port = _free_port()
    sink_desc = (f'appsrc name=in caps="{caps}" ! tensor_sink_grpc '
                 f"server={str(sink_server).lower()} port={port} idl={idl}")
    src_desc = (f"tensor_src_grpc server={str(not sink_server).lower()} "
                f"port={port} idl={idl} timeout=10 ! appsink name=out")
    first, second = ((PKGS[sink_pkg], sink_desc), (PKGS[src_pkg], src_desc))
    if not sink_server:
        first, second = second, first
    a = first[0].parse_launch(first[1])
    a.start()
    try:
        b = second[0].parse_launch(second[1])
        b.start()
        try:
            pub, sub = (a, b) if sink_server else (b, a)
            time.sleep(0.2)
            frames = frames or [_frame(sink_pkg, i) for i in range(FRAMES)]
            for f in frames:
                pub["in"].push_buffer(f)
            assert _wait(lambda: len(sub["out"].buffers) >= len(frames))
            pub["in"].end_stream()
        finally:
            b.stop()
    finally:
        a.stop()
    return sub["out"].buffers, sub["out"]


@pytest.mark.parametrize("sink_pkg,src_pkg", [
    ("jax", "port"), ("port", "jax"), ("port", "port")])
@pytest.mark.parametrize("sink_server", [True, False],
                         ids=["sink-server", "src-server"])
@pytest.mark.parametrize("idl", ["protobuf", "flatbuf"])
def test_bridge_across_packages(idl, sink_server, sink_pkg, src_pkg):
    """Three frames, in order, bytes and dtypes equal, caps derived from
    the payload as the JAX package derives them."""
    bufs, sink = _bridge(sink_pkg, src_pkg, idl, sink_server)
    assert len(bufs) == FRAMES
    for i, b in enumerate(bufs):
        want = [np.full(4, float(i) + 0.25, np.float32),
                np.arange(6, dtype=np.uint8).reshape(3, 2) + i]
        got = [np.asarray(c.host()) for c in b.chunks]
        assert [g.dtype for g in got] == [w.dtype for w in want]
        assert [g.tobytes() for g in got] == [w.tobytes() for w in want]
        assert [g.shape for g in got] == [w.shape for w in want]
    cfg = sink.sinkpad.caps.to_config()
    assert [tuple(i.shape) for i in cfg.info] == [(4,), (3, 2)]
    assert [i.type.name for i in cfg.info] == ["FLOAT32", "UINT8"]


@pytest.mark.parametrize("src_pkg", ["jax", "port"])
def test_bfloat16_rides_as_bits(src_pkg):
    """A port sink's CPU bf16 tensor arrives with its bit patterns: as a
    CPU ``torch.bfloat16`` tensor at the port's source, as an ml_dtypes
    bf16 array at the JAX package's."""
    caps = ('other/tensors,format=static,num_tensors=1,'
            'types=(string)bfloat16,dimensions=(string)5')
    vals = torch.tensor([1.5, -2.25, 3.0, 1e-3, 65504.0], dtype=torch.bfloat16)
    frames = [pt.Buffer.from_arrays([vals])]
    bufs, _ = _bridge("port", src_pkg, "protobuf", True, caps=caps,
                      frames=frames)
    (b,) = bufs
    got = b.chunks[0].host()
    want_bits = vals.view(torch.int16).numpy().view(np.uint16)
    if src_pkg == "port":
        assert got.dtype == torch.bfloat16
        bits = got.view(torch.int16).numpy().view(np.uint16)
    else:
        assert got.dtype == ml_dtypes.bfloat16
        bits = np.asarray(got).view(np.uint16)
    np.testing.assert_array_equal(bits, want_bits)


@pytest.mark.parametrize("kind", ["tensor_src_grpc", "tensor_sink_grpc"])
def test_unknown_idl_rejected(kind):
    desc = (f"{kind} idl=capnproto ! fakesink" if kind == "tensor_src_grpc"
            else f'appsrc caps="{CAPS}" ! {kind} idl=capnproto')
    p = pt.parse_launch(desc)
    with pytest.raises(ValueError, match="unknown idl"):
        p.start()
    p.stop()


def test_stock_grpc_client_interop():
    """A stock grpcio client calls
    /nnstreamer.protobuf.TensorService/SendTensors with a hand-encoded
    protobuf ``Tensors`` message (tests/test_grpc.py:92's); the port's
    tensor_src_grpc decodes it byte for byte."""
    import grpc

    port = _free_port()
    sub = pt.parse_launch(
        f"tensor_src_grpc server=true port={port} idl=protobuf timeout=15 "
        "! appsink name=out")
    sub.start()

    def tag(field, wire):
        return bytes([(field << 3) | wire])

    def varint(n):
        out = b""
        while True:
            b7, n = n & 0x7F, n >> 7
            out += bytes([b7 | (0x80 if n else 0)])
            if not n:
                return out

    data = np.array([1.5, -2.0, 3.25, 9.0], np.float32).tobytes()
    tensor = (tag(1, 2) + varint(2) + b"t0"
              + tag(2, 0) + varint(7)                  # NNS_FLOAT32
              + tag(3, 2) + varint(1) + varint(4)      # packed dims [4]
              + tag(4, 2) + varint(len(data)) + data)
    fr = tag(1, 0) + varint(30) + tag(2, 0) + varint(1)
    msg = (tag(1, 0) + varint(1)
           + tag(2, 2) + varint(len(fr)) + fr
           + tag(3, 2) + varint(len(tensor)) + tensor)
    ch = grpc.insecure_channel(f"localhost:{port}")
    try:
        send = ch.stream_unary(
            "/nnstreamer.protobuf.TensorService/SendTensors")
        send(iter([msg]), wait_for_ready=True, timeout=15)
        assert _wait(lambda: sub["out"].buffers, 15)
    finally:
        ch.close()
        sub.stop()
    (b,) = sub["out"].buffers
    np.testing.assert_array_equal(
        b.chunks[0].host(), np.array([1.5, -2.0, 3.25, 9.0], np.float32))
    cfg = sub["out"].sinkpad.caps.to_config()
    assert cfg.rate_n == 30 and cfg.info[0].shape == (4,)


@pytest.mark.parametrize("kind", ["tensor_src_grpc", "tensor_sink_grpc"])
def test_start_without_grpcio_names_it(kind, monkeypatch):
    """Without grpcio the element still parses; start() raises an
    ImportError that names grpcio."""
    monkeypatch.setitem(sys.modules, "grpc", None)
    desc = (f"{kind} server=true port=0 ! fakesink"
            if kind == "tensor_src_grpc"
            else f'appsrc caps="{CAPS}" ! {kind} server=true port=0')
    p = pt.parse_launch(desc)
    with pytest.raises(ImportError, match="grpcio"):
        p.start()
    p.stop()
