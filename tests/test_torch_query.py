"""The port's tensor_query_* (nnstreamer_tpu_torch/elements/query.py)
against the JAX package's, on the CPU.

Cross-package pipelines, each on the same seeded uint8 frames (96x96x3):

* a JAX ``tensor_query_client`` against a port server
  (``tensor_filter framework=torch-cuda accelerator=true:cpu``), at
  ``batch=0`` and ``batch=4``;
* a port client against a JAX server (``framework=jax``);
* a port server with ``batch=4`` and three port clients at once.

The cross-package and ``batch=4`` cases serve one set of MobileNet-v2
variables (width 0.35, 96x96, BatchNorm statistics drawn from a numpy
seed) to both packages through model files, as
tests/test_torch_pipeline.py does: the two zoos draw their random
weights apart, and the zoo's logits (~2e-3) are too small for an
absolute bound to see a bf16 rounding. The other port-only cases, all
compared bitwise, use ``model="zoo://mobilenet_v2?width=0.35&size=96"``.

Replies are compared with the local line (``appsrc ! tensor_filter !
appsink``) of the package whose server computed them, which shows the
link carried them unchanged (raw frames and raw f32 logits):

* ``batch=0`` replies are bitwise equal to that line (one frame a run,
  the same model on the same input), whichever package is the client;
* ``batch=4`` replies agree to ``BATCH_ATOL`` = 1e-5 absolute: a stack
  of 4 runs other convolution blockings than one frame, which moves f32
  logits of magnitude ~1 by summation order only
  (tests/test_torch_mobilenet.py::test_batched_equals_per_frame's
  bound). A bf16 downcast on the link (~4e-3 on logits ~2) fails it,
  and so does another frame's reply (frames lie >= 4e-3 apart).

Separately, the replies are held against the other package's local line
at ``BF16_ATOL`` = 2e-2 absolute with equal top-1, as
tests/test_torch_mobilenet.py bounds the zoo's bf16 path: that bound is
the two models' difference, not the link's.

Lossy ``wire-precision`` replies equal the local logits downcast and
upcast on the host, exactly. ``tensor_fault mode=kill-link`` on the
client and on the serversrc leaves every frame answered once, in order.
"""
import socket
import threading
import time

import jax
import numpy as np
import pytest
import torch

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as pt
from nnstreamer_tpu.elements import filter as nt_filter
from nnstreamer_tpu.elements import query as nt_query
from nnstreamer_tpu.models import zoo as jax_zoo
from nnstreamer_tpu_torch.edge import protocol as pt_protocol
from nnstreamer_tpu_torch.edge import wire as pt_wire
from nnstreamer_tpu_torch.elements import filter as pt_filter
from nnstreamer_tpu_torch.elements import query as pt_query

MODEL = '"zoo://mobilenet_v2?width=0.35&size=96"'
CAPS = ("other/tensors,format=static,num_tensors=1,types=(string)uint8,"
        "dimensions=(string)3:96:96,framerate=(fraction)0/1")
MLP_CAPS = ("other/tensors,format=static,num_tensors=1,"
            "types=(string)float32,dimensions=(string)64,"
            "framerate=(fraction)0/1")
BF16_ATOL = 2e-2
BATCH_ATOL = 1e-5
N = 6


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two torch threads: tier-1 runs six test workers on shared cores."""
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


def _filter(pkg, model=MODEL):
    if pkg is pt:
        return ("tensor_filter name=f framework=torch-cuda "
                f"accelerator=true:cpu model={model}")
    return f"tensor_filter name=f framework=jax model={model}"


def _server(pkg, batch=0, mid="", model=MODEL):
    port = _free_port()
    s = pkg.parse_launch(
        f"tensor_query_serversrc name=s port={port} id={port} "
        f"batch={batch} ! {mid}{_filter(pkg, model)} ! queue "
        f"! tensor_query_serversink id={port}")
    s.start()
    return s, port


def _client(pkg, port, frames, props="", caps=CAPS, mid="", pts0=0):
    """Run one client over ``frames``; returns ([(pts, host)], stats)."""
    c = pkg.parse_launch(
        f"appsrc name=in caps={caps} ! {mid}tensor_query_client name=c "
        f"port={port} timeout=60 max-request=8 {props} ! appsink name=out")
    c.start()
    try:
        for i, f in enumerate(frames):
            c["in"].push_buffer(pkg.Buffer.from_arrays([f], pts=pts0 + i))
        c["in"].end_stream()
        c.wait_eos(120)
        stats = c["c"].stats.snapshot()
        err = c._error
    finally:
        c.stop()
    assert err is None
    return [(b.pts, np.asarray(b.chunks[0].host()))
            for b in c["out"].buffers], stats


def _local(pkg, frames, model=MODEL, caps=CAPS):
    line = pkg.parse_launch(f"appsrc name=in caps={caps} ! "
                            f"{_filter(pkg, model)} ! appsink name=out")
    line.start()
    try:
        for i, f in enumerate(frames):
            line["in"].push_buffer(pkg.Buffer.from_arrays([f], pts=i))
        line["in"].end_stream()
        line.wait_eos(120)
    finally:
        line.stop()
    return [np.asarray(b.chunks[0].host()) for b in line["out"].buffers]


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(2024)
    return [rng.integers(0, 255, (96, 96, 3), np.uint8, endpoint=True)
            for _ in range(N)]


@pytest.fixture(scope="module")
def port_local(frames):
    return _local(pt, frames)


_LOAD_NPZ = """
import numpy as np


def _tree(path):
    flat, tree = np.load(path), {{}}
    for key in flat.files:
        *parts, leaf = key.split("/")
        node = tree
        for part in parts:
            node = node.setdefault(part, {{}})
        node[leaf] = flat[key]
    return tree
"""
_JAX_MODEL_PY = _LOAD_NPZ + """
from nnstreamer_tpu.models import zoo


def get_model():
    apply_fn, _, in_info, out_info = zoo.build(
        "mobilenet_v2", width="0.35", size="96")
    return apply_fn, _tree({npz!r}), in_info, out_info
"""
_PORT_MODEL_PY = _LOAD_NPZ + """
from nnstreamer_tpu_torch.models.convert import mobilenet_params_from_jax
from nnstreamer_tpu_torch.models.mobilenet import MobileNetV2, make_apply
from nnstreamer_tpu_torch.tensors.info import TensorsInfo


def get_model():
    model = MobileNetV2(num_classes=1001, width=0.35)
    model.load_state_dict(mobilenet_params_from_jax(_tree({npz!r})))
    return (make_apply(False), model, TensorsInfo.make("uint8", "3:96:96"),
            TensorsInfo.make("float32", "1001"))
"""


@pytest.fixture(scope="module")
def shared(tmp_path_factory, frames):
    """{package: model file} over one set of variables, and {package:
    that package's local line's logits}."""
    tmp = tmp_path_factory.mktemp("query_models")
    _, variables, _, _ = jax_zoo.build("mobilenet_v2", width="0.35",
                                       size="96")
    rng = np.random.default_rng(31)
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            jax.device_get(variables))[0]:
        key = "/".join(str(k.key) for k in path)
        leaf = np.asarray(leaf)
        if key.endswith("/mean"):
            leaf = rng.normal(0.0, 0.5, leaf.shape).astype(np.float32)
        elif key.endswith("/var"):
            leaf = rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)
        flat[key] = leaf
    npz = tmp / "mobilenet.npz"
    np.savez(npz, **flat)
    models = {}
    for pkg, text in ((nt, _JAX_MODEL_PY), (pt, _PORT_MODEL_PY)):
        models[pkg] = tmp / f"mobilenet_{pkg.__name__}.py"
        models[pkg].write_text(text.format(npz=str(npz)))
    return models, {pkg: _local(pkg, frames, model=str(m))
                    for pkg, m in models.items()}


def _answered_once_in_order(got, n, pts0=0):
    assert [p for p, _ in got] == list(range(pts0, pts0 + n))


def _bitwise(got, want):
    for (_, g), w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


def _close(got, want, atol):
    for (_, g), w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == (1001,)
        np.testing.assert_allclose(g, w, rtol=0, atol=atol)
        assert int(g.argmax()) == int(w.argmax())


def test_frames_are_told_apart_at_batch_atol(shared):
    """A reply of another frame under a frame's pts must fail the
    ``BATCH_ATOL`` check: every two frames' logits lie a hundred times
    further apart (observed ~4.4e-3)."""
    logits = shared[1][pt]
    gaps = [np.abs(a - b).max() for i, a in enumerate(logits)
            for b in logits[i + 1:]]
    assert min(gaps) > 100 * BATCH_ATOL


# -- cross-package pipelines -------------------------------------------------


@pytest.mark.parametrize("batch", [0, 4])
def test_jax_client_against_port_server(frames, shared, batch):
    models, local = shared
    server, port = _server(pt, batch, model=str(models[pt]))
    try:
        got, stats = _client(nt, port, frames)
    finally:
        server.stop()
    _answered_once_in_order(got, N)
    if batch == 0:
        _bitwise(got, local[pt])
    else:
        _close(got, local[pt], BATCH_ATOL)
    _close(got, local[nt], BF16_ATOL)
    assert stats["session_delivered"] == N
    assert stats["session_declared_lost"] == 0


def test_port_client_against_jax_server(frames, shared):
    models, local = shared
    server, port = _server(nt, model=str(models[nt]))
    try:
        got, stats = _client(pt, port, frames)
    finally:
        server.stop()
    _answered_once_in_order(got, N)
    _bitwise(got, local[nt])
    _close(got, local[pt], BF16_ATOL)
    assert stats["session_delivered"] == N


def test_port_batch0_is_bitwise_the_local_line(frames, port_local):
    server, port = _server(pt)
    try:
        got, _ = _client(pt, port, frames)
        compiles = server["f"].fw.compile_count
    finally:
        server.stop()
    _answered_once_in_order(got, N)
    _bitwise(got, port_local)
    assert compiles == 1


def test_port_batch4_server_with_three_port_clients(frames, shared):
    """Three clients stream at once into one ``batch=4`` server: every
    client's replies are its own, once and in order; the filter makes one
    executable for the padded (4, 96, 96, 3) stack all run long."""
    models, local = shared
    server, port = _server(pt, batch=4, model=str(models[pt]))
    results, errors = {}, []

    def run(i):
        try:
            results[i] = _client(pt, port, frames[2 * i:2 * i + 2],
                                 pts0=2 * i)
        except Exception as exc:  # noqa: BLE001 -- reported below
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        compiles = server["f"].fw.compile_count
        invokes = server["f"].stats["buffers"]
    finally:
        server.stop()
    assert not errors
    for i in range(3):
        got, stats = results[i]
        _answered_once_in_order(got, 2, pts0=2 * i)
        _close(got, local[pt][2 * i:2 * i + 2], BATCH_ATOL)
        assert stats["session_delivered"] == 2
    assert compiles == 1
    assert 2 <= invokes <= N   # micro-batches of 1..4 real rows


@pytest.mark.parametrize("props", [
    "wire-codec=zlib", "wire-codec=shuffle-zlib",
    "wire-precision=bf16", "wire-precision=fp16",
    "wire-codec=shuffle-zlib wire-precision=bf16"])
@pytest.mark.parametrize("client_pkg", [nt, pt], ids=["jax", "torch"])
def test_wire_options_over_a_port_server(frames, port_local, client_pkg,
                                         props):
    """Lossless codecs deliver the local line's bytes; a lossy precision
    delivers exactly the local logits downcast and upcast on the host."""
    server, port = _server(pt)
    try:
        got, stats = _client(client_pkg, port, frames[:3], props=props)
    finally:
        server.stop()
    _answered_once_in_order(got, 3)
    for (_, g), w in zip(got, port_local[:3]):
        if "bf16" in props:
            w = pt_wire.bf16_bits_to_f32(pt_wire.f32_to_bf16_bits(w))
        elif "fp16" in props:
            w = w.astype(np.float16).astype(np.float32)
        assert g.dtype == np.float32 and g.tobytes() == w.tobytes()
    assert stats["wire_frames_out"] == 3


# -- kill-link ---------------------------------------------------------------


def _mlp_frames(n):
    rng = np.random.default_rng(7)
    return [rng.standard_normal(64).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("where", ["client", "serversrc"])
def test_kill_link_answers_every_frame_once_in_order(where):
    n = 20
    xs = _mlp_frames(n)
    model = "zoo://mlp"
    want = _local(pt, xs, model=model, caps=MLP_CAPS)
    if where == "serversrc":
        server, port = _server(
            pt, mid="tensor_fault name=k mode=kill-link target=s every=5 ! ",
            model=model)
        mid = ""
    else:
        server, port = _server(pt, model=model)
        mid = "tensor_fault name=k mode=kill-link target=c every=5 ! "
    try:
        got, stats = _client(pt, port, xs, caps=MLP_CAPS, mid=mid)
        sstats = server["s"].stats.snapshot()
    finally:
        server.stop()
    _answered_once_in_order(got, n)
    for (_, g), w in zip(got, want):
        assert g.tobytes() == w.tobytes()
    if where == "client":
        assert stats["link_kills"] == n // 5
    else:
        assert sstats["link_kills"] >= 1
    assert stats["session_delivered"] == n
    assert stats["session_declared_lost"] == 0


def test_frame_replayed_on_a_link_that_dies_at_once_is_not_lost(monkeypatch):
    """The streaming thread reconnects, its replay sends the frame, and
    the new link dies before the send path reads it (twice). The frame
    stays pending and the next replay delivers it: nothing is declared
    lost. The background reconnect is held back 0.3 s so the streaming
    thread is the one that reconnects."""
    n = 8
    xs = _mlp_frames(n)
    model = "zoo://mlp"
    want = _local(pt, xs, model=model, caps=MLP_CAPS)
    client_cls = pt_query.TensorQueryClient
    real_try, real_bg = client_cls._try_endpoint, client_cls._reconnect_bg
    kills = {"left": 2}

    def dying(self, host, port_, timeout):
        # armed by the tensor_fault's kill, on the streaming thread only
        armed = self.stats.snapshot().get("link_kills", 0) >= 1 \
            and not threading.current_thread().name.startswith(
                "qclient-reconn")
        ok = real_try(self, host, port_, timeout)
        if ok and armed and kills["left"]:
            kills["left"] -= 1
            self.kill_link()
            for _ in range(500):
                if self._sock is None:
                    break
                time.sleep(0.01)
        return ok

    def late_bg(self):
        time.sleep(0.3)
        real_bg(self)

    monkeypatch.setattr(client_cls, "_try_endpoint", dying)
    monkeypatch.setattr(client_cls, "_reconnect_bg", late_bg)
    server, port = _server(pt, model=model)
    try:
        got, stats = _client(
            pt, port, xs, caps=MLP_CAPS,
            mid="tensor_fault mode=kill-link target=c every=3 "
                "max-faults=1 ! ")
    finally:
        server.stop()
    assert kills["left"] == 0
    _answered_once_in_order(got, n)
    for (_, g), w in zip(got, want):
        assert g.tobytes() == w.tobytes()
    assert stats["session_delivered"] == n
    assert stats["session_declared_lost"] == 0


def test_new_frame_waits_for_the_replay_of_its_connection(monkeypatch):
    """The background reconnect publishes the new link, then stalls 0.2 s
    before its replay while frames go on arriving 30 ms apart. A frame
    that finds the link up before its replay is left to that replay, so
    the answers still come back in order."""
    n = 20
    xs = _mlp_frames(n)
    model = "zoo://mlp"
    want = _local(pt, xs, model=model, caps=MLP_CAPS)

    class SlowReplay(threading.Thread):
        def start(self):
            super().start()
            if self.name.startswith("qclient-recv") \
                    and threading.current_thread().name.startswith(
                        "qclient-reconn"):
                time.sleep(0.2)

    shim = type(threading)("threading")
    shim.__dict__.update(vars(threading))
    shim.Thread = SlowReplay
    monkeypatch.setattr(pt_query, "threading", shim)
    server, port = _server(
        pt, mid="tensor_fault mode=kill-link target=s every=5 ! ",
        model=model)
    c = pt.parse_launch(
        f"appsrc name=in caps={MLP_CAPS} ! tensor_query_client name=c "
        f"port={port} timeout=60 max-request=8 ! appsink name=out")
    c.start()
    try:
        for i, f in enumerate(xs):
            c["in"].push_buffer(pt.Buffer.from_arrays([f], pts=i))
            time.sleep(0.03)
        c["in"].end_stream()
        c.wait_eos(120)
        stats = c["c"].stats.snapshot()
        err = c._error
    finally:
        c.stop()
        server.stop()
    assert err is None
    got = [(b.pts, np.asarray(b.chunks[0].host()))
           for b in c["out"].buffers]
    _answered_once_in_order(got, n)
    for (_, g), w in zip(got, want):
        assert g.tobytes() == w.tobytes()
    assert stats["session_delivered"] == n
    assert stats["session_declared_lost"] == 0


# -- units: stacking, trimming, demux ---------------------------------------


@pytest.mark.parametrize("nreal", [1, 3, 4])
def test_stack_pads_by_repeating_the_last_frame(nreal):
    rng = np.random.default_rng(nreal)
    rows = [rng.integers(0, 255, (5, 3), np.uint8) for _ in range(nreal)]
    outs = []
    for pkg, mod in ((nt, nt_query), (pt, pt_query)):
        src = pkg.make_element("tensor_query_serversrc", id=3)
        bufs = []
        for i, r in enumerate(rows):
            b = pkg.Buffer.from_arrays([r], pts=i)
            b.extras.update(client_id=i % 2, server_id=3)
            bufs.append(b)
        out = src._stack(bufs, 4)
        outs.append((out.chunks[0].host().tobytes(), out.pts,
                     out.extras["batch_rows"],
                     out.extras["batch_valid_rows"]))
    assert outs[0] == outs[1]
    assert outs[1][3] == nreal


def test_stack_of_bf16_rows_stays_bf16():
    rows = [torch.full((2, 3), float(i)).bfloat16() for i in range(2)]
    bufs = [pt.Buffer.from_arrays([r]) for r in rows]
    out = pt.make_element("tensor_query_serversrc")._stack(bufs, 4)
    got = out.chunks[0].host()
    assert got.dtype == torch.bfloat16 and got.shape == (4, 2, 3)
    assert torch.equal(got[3], rows[1])


def test_trim_padded_rows_follows_the_reference():
    """Host outputs whose leading dim is the padded batch lose the
    padding; anything else passes through, as in the JAX filter."""
    outs = [np.arange(4 * 3, dtype=np.float32).reshape(4, 3),
            np.arange(7, dtype=np.float32),
            np.zeros((4,), np.int32)]
    for nv in (1, 2, 4):
        nbuf = nt.Buffer.from_arrays([np.zeros((4, 2), np.uint8)])
        pbuf = pt.Buffer.from_arrays([np.zeros((4, 2), np.uint8)])
        nbuf.extras["batch_valid_rows"] = pbuf.extras["batch_valid_rows"] \
            = nv
        want = nt_filter.TensorFilter._trim_padded_rows(nbuf, outs)
        got = pt_filter.TensorFilter._trim_padded_rows(pbuf, outs)
        assert [g.shape for g in got] == [w.shape for w in want]
        # CPU tensors are host outputs too
        got_t = pt_filter.TensorFilter._trim_padded_rows(
            pbuf, [torch.from_numpy(o) for o in outs])
        assert [tuple(g.shape) for g in got_t] == [w.shape for w in want]
    plain = pt.Buffer.from_arrays([np.zeros((4, 2), np.uint8)])
    assert pt_filter.TensorFilter._trim_padded_rows(plain, outs) is outs


def test_serversink_answers_real_rows_only():
    """A padded stack that reaches the sink untrimmed (card outputs ship
    padded) still answers the real rows only, each to its client."""
    sink = pt.make_element("tensor_query_serversink", id=951)
    socks = [socket.socketpair() for _ in range(2)]
    try:
        for cid, (a, _) in enumerate(socks):
            pt_query.SERVER_TABLE.add_conn(951, cid, a)
        out = np.arange(4 * 5, dtype=np.float32).reshape(4, 5)
        buf = pt.Buffer.from_arrays([out])
        buf.extras["batch_rows"] = [(1, 951, 10), (0, 951, 11)]
        buf.extras["batch_valid_rows"] = 2
        sink.render(buf)
        for cid, row, pts in ((1, 0, 10), (0, 1, 11)):
            b = socks[cid][1]
            b.settimeout(5)
            kind, meta, payloads = pt_protocol.recv_msg(b)
            assert kind == pt_protocol.MsgKind.RESULT
            assert meta["client_id"] == cid and meta["pts"] == pts
            got = pt_wire.unpack_buffer(meta, payloads).chunks[0].host()
            np.testing.assert_array_equal(got, out[row])
            b.setblocking(False)
            with pytest.raises(BlockingIOError):
                b.recv(1)   # nothing more: no reply for a padded row
    finally:
        pt_query.SERVER_TABLE.close_server(951)
        for a, b in socks:
            a.close()
            b.close()


def test_roi_block_round_trips_like_the_reference():
    nbuf, pbuf = nt.Buffer.from_arrays([np.zeros(2)]), \
        pt.Buffer.from_arrays([np.zeros(2)])
    for b in (nbuf, pbuf):
        b.extras.update(delta_rois=[(0, 1, 2, 3)], delta_grid=(2, 2),
                        delta_tile=16, delta_shape=(32, 32, 3))
    block = pt_query._roi_meta(pbuf)
    assert block == nt_query._roi_meta(nbuf)
    got = pt_query._roi_adopt(pt.Buffer.from_arrays([np.zeros(2)]), block)
    want = nt_query._roi_adopt(nt.Buffer.from_arrays([np.zeros(2)]), block)
    assert got.extras == want.extras
    assert pt_query._roi_meta(pt.Buffer.from_arrays([np.zeros(2)])) is None


def test_client_and_serversrc_caps_declarations_match():
    for pkg in (nt, pt):
        src = pkg.make_element("tensor_query_serversrc")
        assert str(src.static_src_caps()) == \
            "other/tensors,format=flexible"
        assert pkg.make_element("tensor_query_client") \
            .static_transfer({"sink": None}) == {"src": None}


def test_unanswered_requests_are_declared_at_eos():
    """A server that never answers: the client's EOS declares every
    pending request lost, so requests == delivered + declared_lost."""
    lst = socket.socket()
    lst.bind(("localhost", 0))
    lst.listen(1)
    port = lst.getsockname()[1]
    accepted = []

    def mute_server():
        conn, _ = lst.accept()
        accepted.append(conn)
        kind, _meta, _ = pt_protocol.recv_msg(conn)
        assert kind == pt_protocol.MsgKind.CAPS
        pt_protocol.send_msg(conn, pt_protocol.MsgKind.CAPS_ACK,
                             {"caps": "other/tensors,format=flexible",
                              "client_id": 0})

    t = threading.Thread(target=mute_server, daemon=True)
    t.start()
    c = pt.parse_launch(
        f"appsrc name=in caps={MLP_CAPS} ! tensor_query_client name=c "
        f"port={port} timeout=1 max-request=4 ! appsink name=out")
    try:
        c.start()
        for x in _mlp_frames(3):
            c["in"].push_buffer(pt.Buffer.from_arrays([x]))
        c["in"].end_stream()
        c.wait_eos(30)
        st = c["c"].stats.snapshot()
    finally:
        c.stop()
        for conn in accepted:
            conn.close()
        lst.close()
    assert st["session_requests"] == 3
    assert st["session_delivered"] == 0
    assert st["session_declared_lost"] == 3
