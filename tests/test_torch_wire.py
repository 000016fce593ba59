"""The port's wire (nnstreamer_tpu_torch/edge/{protocol,wire,session}.py)
against the JAX package's, on the CPU.

Bytes: ``pack_buffer`` and ``pack_batch`` give meta (as the JSON that
goes on the wire) and payload bytes EQUAL to the JAX package's, for
every TensorType (bfloat16 included) x ``raw|zlib|shuffle-zlib`` x
precision ``none|bf16|fp16``, on seeded numpy inputs of two kinds:
noise (the codecs decline it, payloads ship raw) and a ramp of small
values (the codecs keep their output). Each package unpacks the other's
messages to the same bytes. The JAX side holds bfloat16 in ``ml_dtypes``
arrays, the port in CPU ``torch.bfloat16`` tensors with the same bits.
No tolerance anywhere: every comparison here is exact, bit for bit,
except NaN under ``wire-precision=bf16``, which is held to stay NaN.

Behaviour: where tests/test_wire.py checks behaviour rather than bytes
(``TestNegotiation``, ``TestBatch``, ``TestSocketTransport``,
``TestSessionNegotiation``, ``TestReplayRing``, ``TestSessionReceiver``,
``TestHeartbeat``, ``TestDeltaNegotiation``), each case is one test
parametrised over both packages.

Delta: every stream of ``tools/delta_parity.py`` goes through a port
delta link (single frames and DATA_BATCH): the port packs the JAX
package's bytes for the same frames, each package decodes the other's
to the source bytes, and a port delta link delivers what a raw link
delivers. Exact, bit for bit.
"""
import dataclasses
import json
import socket
import struct
from types import ModuleType

import ml_dtypes
import numpy as np
import pytest
import torch

from nnstreamer_tpu.edge import protocol as nt_protocol
from nnstreamer_tpu.edge import session as nt_session
from nnstreamer_tpu.edge import wire as nt_wire
from nnstreamer_tpu.obs import context as nt_ctx
from nnstreamer_tpu.tensors.buffer import Buffer as NtBuffer
from nnstreamer_tpu.tensors.types import TensorType
from nnstreamer_tpu.utils.atomic import Counters as NtCounters
from nnstreamer_tpu_torch.edge import protocol as pt_protocol
from nnstreamer_tpu_torch.edge import session as pt_session
from nnstreamer_tpu_torch.edge import wire as pt_wire
from nnstreamer_tpu_torch.obs import context as pt_ctx
from nnstreamer_tpu_torch.tensors.buffer import Buffer as PtBuffer
from nnstreamer_tpu_torch.utils.atomic import Counters as PtCounters


@dataclasses.dataclass(frozen=True)
class Pkg:
    wire: ModuleType
    protocol: ModuleType
    session: ModuleType
    Buffer: type
    Counters: type


NT = Pkg(nt_wire, nt_protocol, nt_session, NtBuffer, NtCounters)
PT = Pkg(pt_wire, pt_protocol, pt_session, PtBuffer, PtCounters)
BOTH = pytest.mark.parametrize("pkg", [NT, PT], ids=["jax", "torch"])

# the codecs without per-link state: one packed message per config
STATELESS_CODECS = ("raw", "zlib", "shuffle-zlib")

SHAPE = (16, 33)   # 528 elements: every dtype clears MIN_COMPRESS
_FLOATS = (TensorType.FLOAT16, TensorType.FLOAT32, TensorType.FLOAT64,
           TensorType.BFLOAT16)


def _values(ttype: TensorType, data: str, seed: int = 0):
    """(JAX host value, port host value) of one seeded tensor: the same
    bytes in each package's host convention."""
    rng = np.random.default_rng(100 * int(ttype) + seed)
    n = int(np.prod(SHAPE))
    if ttype in _FLOATS:
        x = (rng.standard_normal(SHAPE).astype(np.float32) if data == "noise"
             else (np.arange(n) % 7).reshape(SHAPE).astype(np.float32) / 2)
        if ttype == TensorType.BFLOAT16:
            nv = x.astype(ml_dtypes.bfloat16)
            pv = torch.from_numpy(nv.view(np.int16).copy()).view(
                torch.bfloat16)
            return nv, pv
        x = x.astype(str(ttype))
        return x, x.copy()
    name = str(ttype)
    info = np.iinfo(name)
    x = (rng.integers(info.min, info.max, SHAPE, dtype=name)
         if data == "noise" else (np.arange(n) % 7).reshape(SHAPE)
         .astype(name))
    return x, x.copy()


def _pbytes(p) -> bytes:
    return p.tobytes() if isinstance(p, np.ndarray) else bytes(p)


def _host(v):
    """(dtype name, bytes) of a host value of either package."""
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            return "bfloat16", v.contiguous().view(torch.int16).numpy() \
                .tobytes()
        v = v.numpy()
    v = np.ascontiguousarray(v)
    return str(v.dtype), v.tobytes()


def _frame(buf):
    return (buf.pts, buf.duration, buf.extras.get("seq"),
            [(_host(c.host()), tuple(c.shape)) for c in buf.chunks])


def _wire_json(meta):
    # what send_msg puts on the wire for this meta
    return json.dumps(meta)


# -- bytes: the port packs what the JAX package packs ------------------------


@pytest.mark.parametrize("data", ["noise", "ramp"])
@pytest.mark.parametrize("precision", pt_wire.PRECISIONS)
@pytest.mark.parametrize("codec", STATELESS_CODECS)
@pytest.mark.parametrize("ttype", list(TensorType), ids=str)
def test_pack_buffer_bytes_equal(ttype, codec, precision, data):
    nv, pv = _values(ttype, data)
    nmeta, npl = nt_wire.pack_buffer(
        NtBuffer.from_arrays([nv], pts=7, duration=3),
        nt_wire.WireConfig(codec, precision))
    pmeta, ppl = pt_wire.pack_buffer(
        PtBuffer.from_arrays([pv], pts=7, duration=3),
        pt_wire.WireConfig(codec, precision))
    assert _wire_json(pmeta) == _wire_json(nmeta)
    assert [_pbytes(p) for p in ppl] == [_pbytes(p) for p in npl]
    # each package unpacks the other's message to the same frame
    assert _frame(pt_wire.unpack_buffer(nmeta, npl)) == \
        _frame(nt_wire.unpack_buffer(nmeta, npl))
    assert _frame(nt_wire.unpack_buffer(pmeta, ppl)) == \
        _frame(pt_wire.unpack_buffer(pmeta, ppl))


@pytest.mark.parametrize("precision", pt_wire.PRECISIONS)
@pytest.mark.parametrize("codec", STATELESS_CODECS)
@pytest.mark.parametrize("ttype", list(TensorType), ids=str)
def test_pack_batch_bytes_equal(ttype, codec, precision):
    kinds = ("noise", "ramp", "noise")
    vals = [_values(ttype, d, seed=i) for i, d in enumerate(kinds)]
    seqs = [41, 42, None]
    nbufs = [NtBuffer.from_arrays([nv], pts=10 * i)
             for i, (nv, _) in enumerate(vals)]
    pbufs = [PtBuffer.from_arrays([pv], pts=10 * i)
             for i, (_, pv) in enumerate(vals)]
    nbufs[1].duration = pbufs[1].duration = 5
    nmeta, npl = nt_wire.pack_batch(nbufs, nt_wire.WireConfig(codec,
                                                             precision),
                                    seqs=seqs)
    pmeta, ppl = pt_wire.pack_batch(pbufs, pt_wire.WireConfig(codec,
                                                             precision),
                                    seqs=seqs)
    assert _wire_json(pmeta) == _wire_json(nmeta)
    assert [_pbytes(p) for p in ppl] == [_pbytes(p) for p in npl]
    want = [_frame(b) for b in nt_wire.unpack_batch(nmeta, npl)]
    assert [_frame(b) for b in pt_wire.unpack_batch(nmeta, npl)] == want
    assert [_frame(b) for b in nt_wire.unpack_batch(pmeta, ppl)] == want


def test_v1_meta_is_buffer_to_wire_in_both():
    nv, pv = _values(TensorType.BFLOAT16, "ramp")
    pbuf = PtBuffer.from_arrays([pv], pts=3)
    assert pt_wire.pack_buffer(pbuf, None)[0] == \
        pt_protocol.buffer_to_wire(pbuf)[0]
    assert pt_protocol.buffer_to_wire(pbuf)[0] == \
        nt_protocol.buffer_to_wire(NtBuffer.from_arrays([nv], pts=3))[0]


def test_multi_chunk_frame_bytes_equal():
    vals = [_values(t, "ramp") for t in (TensorType.UINT8,
                                         TensorType.BFLOAT16,
                                         TensorType.FLOAT32)]
    for codec in STATELESS_CODECS:
        nmeta, npl = nt_wire.pack_buffer(
            NtBuffer.from_arrays([v for v, _ in vals]),
            nt_wire.WireConfig(codec, "bf16"))
        pmeta, ppl = pt_wire.pack_buffer(
            PtBuffer.from_arrays([v for _, v in vals]),
            pt_wire.WireConfig(codec, "bf16"))
        assert _wire_json(pmeta) == _wire_json(nmeta)
        assert [_pbytes(p) for p in ppl] == [_pbytes(p) for p in npl]


@pytest.mark.parametrize("prec", ["bf16", "fp16"])
def test_downcast_special_values(prec):
    """Finite values, +-inf, +-0, the largest normals and subnormals
    downcast to the JAX package's exact bytes; NaN stays NaN."""
    rng = np.random.default_rng(5)
    special = np.array([np.inf, -np.inf, 0.0, -0.0, 3.4e38, -3.4e38,
                        1.17e-38, 1e-40, -3e-39, 1e-45, 65504.0, 6e-8],
                       np.float32)
    x = np.concatenate([rng.standard_normal(300).astype(np.float32) * 100,
                        (rng.standard_normal(100) * 1e-39)
                        .astype(np.float32), special,
                        np.array([np.nan, -np.nan], np.float32)])
    nan = np.isnan(x)
    nmeta, npl = nt_wire.pack_buffer(NtBuffer.from_arrays([x]),
                                     nt_wire.WireConfig(precision=prec))
    pmeta, ppl = pt_wire.pack_buffer(PtBuffer.from_arrays([x.copy()]),
                                     pt_wire.WireConfig(precision=prec))
    assert pmeta == nmeta
    width = np.uint16
    got = np.frombuffer(_pbytes(ppl[0]), width)
    want = np.frombuffer(_pbytes(npl[0]), width)
    np.testing.assert_array_equal(got[~nan], want[~nan])
    for meta, pl in ((pmeta, ppl), (nmeta, npl)):
        back = pt_wire.unpack_buffer(meta, pl).chunks[0].host()
        assert back.dtype == np.float32
        assert np.isnan(back[nan]).all() and not np.isnan(back[~nan]).any()
        np.testing.assert_array_equal(
            back[~nan], nt_wire.unpack_buffer(nmeta, npl).chunks[0]
            .host()[~nan])


def test_bf16_bits_round_to_nearest_even_as_ml_dtypes_does():
    rng = np.random.default_rng(9)
    x = np.concatenate([rng.standard_normal(4096).astype(np.float32) * 1e3,
                        (rng.standard_normal(512) * 1e-38)
                        .astype(np.float32),
                        np.array([np.nan, -np.nan], np.float32)])
    np.testing.assert_array_equal(
        pt_wire.f32_to_bf16_bits(x),
        x.astype(ml_dtypes.bfloat16).view(np.uint16))
    bits = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    finite = ~np.isnan(x)
    np.testing.assert_array_equal(
        pt_wire.bf16_bits_to_f32(bits)[finite],
        bits.view(ml_dtypes.bfloat16).astype(np.float32)[finite])


def test_traced_batch_crosses_both_ways():
    """The trace-extended DATA_BATCH header (fhdr=2): each package
    unpacks the other's, adopting the sender's trace id."""
    vals = [_values(TensorType.FLOAT32, "ramp", seed=i) for i in range(2)]
    nbufs = [NtBuffer.from_arrays([nv], pts=i) for i, (nv, _) in
             enumerate(vals)]
    pbufs = [PtBuffer.from_arrays([pv], pts=i) for i, (_, pv) in
             enumerate(vals)]
    nt_ctx.stamp(nbufs[0])
    pt_ctx.stamp(pbufs[0])
    for pack, bufs, unpack, mod in (
            (nt_wire.pack_batch, nbufs, pt_wire.unpack_batch, pt_ctx),
            (pt_wire.pack_batch, pbufs, nt_wire.unpack_batch, nt_ctx)):
        cfg = (nt_wire if pack is nt_wire.pack_batch else pt_wire) \
            .WireConfig(trace=True)
        meta, pl = pack(bufs, cfg, seqs=[1, 2])
        assert meta["fhdr"] == 2
        out = unpack(meta, pl)
        assert [b.extras["seq"] for b in out] == [1, 2]
        sent = bufs[0].extras[nt_ctx.CTX_KEY]
        assert out[0].extras[mod.CTX_KEY].trace_id == sent.trace_id
        assert mod.CTX_KEY not in out[1].extras   # untraced frame


def test_traced_data_meta_crosses_both_ways():
    nv, pv = _values(TensorType.UINT8, "ramp")
    nbuf, pbuf = NtBuffer.from_arrays([nv]), PtBuffer.from_arrays([pv])
    nt_ctx.stamp(nbuf)
    pt_ctx.stamp(pbuf)
    meta, pl = nt_wire.pack_buffer(nbuf, nt_wire.WireConfig(trace=True))
    got = pt_wire.unpack_buffer(meta, pl)
    assert got.extras[pt_ctx.CTX_KEY].trace_id == \
        nbuf.extras[nt_ctx.CTX_KEY].trace_id
    meta, pl = pt_wire.pack_buffer(pbuf, pt_wire.WireConfig(trace=True))
    got = nt_wire.unpack_buffer(meta, pl)
    assert got.extras[nt_ctx.CTX_KEY].trace_id == \
        pbuf.extras[pt_ctx.CTX_KEY].trace_id


@pytest.mark.parametrize("kind", ["bf16", "u8", "zero-size"])
def test_socket_messages_cross_both_ways(kind):
    """send_msg of one package, recv_msg + unpack of the other: the raw
    path preallocates the destination (bf16: its uint16 bits in the
    port) and lands the same bytes."""
    t = {"bf16": TensorType.BFLOAT16, "u8": TensorType.UINT8,
         "zero-size": None}[kind]
    if t is None:
        nv = np.empty((0, 4), np.float32)
        pv = nv.copy()
    else:
        nv, pv = _values(t, "noise")
    for tx, rx, buf in ((NT, PT, NtBuffer.from_arrays([nv], pts=1)),
                        (PT, NT, PtBuffer.from_arrays([pv], pts=1))):
        a, b = socket.socketpair()
        try:
            meta, payloads = tx.wire.pack_buffer(buf, None)
            tx.protocol.send_msg(a, tx.protocol.MsgKind.DATA, meta,
                                 payloads)
            kind_, rmeta, rpay = rx.protocol.recv_msg(b)
            assert int(kind_) == int(nt_protocol.MsgKind.DATA)
            assert isinstance(rpay[0], np.ndarray) \
                and rpay[0].flags.writeable
            out = rx.wire.unpack_buffer(rmeta, rpay)
            assert _frame(out) == _frame(buf)
        finally:
            a.close()
            b.close()


def test_msg_kinds_are_the_reference_values():
    assert {k.name: int(k) for k in pt_protocol.MsgKind} == \
        {k.name: int(k) for k in nt_protocol.MsgKind}


# -- delta -------------------------------------------------------------------


class TestDeltaNegotiation:
    @BOTH
    def test_peer_wish_never_adopted_without_local_request(self, pkg):
        cfg = pkg.wire.negotiate(pkg.wire.advertise(codec="delta"))
        assert cfg is not None and cfg.codec == "raw"

    @BOTH
    def test_local_request_against_v1_peer_is_plain(self, pkg):
        assert pkg.wire.negotiate(None, codec="delta") is None
        assert pkg.wire.negotiate({"no": "v"}, codec="delta") is None

    @BOTH
    def test_non_delta_meta_has_no_delta_k(self, pkg):
        assert "delta_k" not in pkg.wire.WireConfig("zlib").to_meta()

    @BOTH
    def test_local_request_negotiates_delta_and_its_k(self, pkg):
        cfg = pkg.wire.negotiate(pkg.wire.advertise(), codec="delta",
                                 delta_k=5)
        assert cfg.codec == "delta" and cfg.to_meta()["delta_k"] == 5
        rx = pkg.wire.accept(cfg.to_meta())
        assert rx.codec == "delta" and rx.delta_k == 5

    @BOTH
    def test_peer_without_delta_in_its_codecs_gets_raw(self, pkg):
        old = pkg.wire.advertise()
        old["codecs"] = [c for c in old["codecs"] if c != "delta"]
        assert pkg.wire.negotiate(old, codec="delta").codec == "raw"

    def test_advertisement_and_ack_equal_the_reference(self):
        assert json.dumps(pt_wire.advertise()) == \
            json.dumps(nt_wire.advertise())
        for codec in pt_wire.CODECS:
            n = nt_wire.negotiate(nt_wire.advertise(), codec=codec,
                                  delta_k=7)
            p = pt_wire.negotiate(pt_wire.advertise(), codec=codec,
                                  delta_k=7)
            assert json.dumps(p.to_meta()) == json.dumps(n.to_meta())
        # each package accepts the other's delta ack
        n = nt_wire.negotiate(pt_wire.advertise(), codec="delta")
        assert n.codec == "delta"
        assert pt_wire.accept(n.to_meta()).codec == "delta"
        p = pt_wire.negotiate(nt_wire.advertise(), codec="delta")
        assert nt_wire.accept(p.to_meta()).codec == "delta"

    def test_a_delta_frame_is_a_link_fault_in_the_port(self):
        """A delta frame on a link that did not negotiate delta has no
        receiver reference: unpacking raises and the link reconnects."""
        tx, _ = (nt_wire.negotiate(nt_wire.advertise(), codec="delta"),
                 None)
        arr = np.arange(64, dtype=np.float32)
        meta, pl = nt_wire.pack_buffer(NtBuffer.from_arrays([arr]), tx)
        assert "delta" in meta
        with pytest.raises(ValueError, match="delta"):
            pt_wire.unpack_buffer(meta, pl)
        meta, pl = nt_wire.pack_batch([NtBuffer.from_arrays([arr])], tx)
        with pytest.raises(ValueError, match="delta"):
            pt_wire.unpack_batch(meta, pl)

    @BOTH
    def test_stale_epoch_diff_raises(self, pkg):
        tx = pkg.wire.negotiate(pkg.wire.advertise(), codec="delta")
        rx = pkg.wire.accept(tx.to_meta())
        arr = np.zeros(256, np.float32)
        for i in range(2):
            f = arr.copy()
            f[i] = 1
            meta, pl = pkg.wire.pack_buffer(pkg.Buffer.from_arrays([f]), tx)
        assert "k" not in meta["delta"]
        with pytest.raises(ValueError, match="stale reference"):
            pkg.wire.unpack_buffer(meta, pl, cfg=rx)  # never saw the key


def _delta_parity():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parent.parent / "tools" / \
        "delta_parity.py"
    spec = importlib.util.spec_from_file_location("delta_parity", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


DP = _delta_parity()


def _to_port(buf):
    return PtBuffer.from_arrays([np.asarray(c.host()).copy()
                                 for c in buf.chunks], pts=buf.pts)


def _delta_link(wire, precision):
    tx = wire.negotiate(wire.advertise(), codec="delta",
                        precision=precision, delta_k=DP.DELTA_K)
    return tx, wire.accept(tx.to_meta())


def _no_ts(meta):
    return {k: v for k, v in meta.items() if k != "ts"}


@pytest.mark.parametrize("batch", [1, 4], ids=["frame", "batch"])
@pytest.mark.parametrize("name,gen,precision", DP.BUILTIN,
                         ids=[b[0].split(":")[1] for b in DP.BUILTIN])
def test_delta_parity_stream_bytes_equal(name, gen, precision, batch):
    """One tools/delta_parity.py stream: the port's delta messages equal
    the JAX package's, each decodes the other's, and the delivered bytes
    equal the source's (and a raw link's under lossy precision)."""
    frames = gen()
    ntx, nrx = _delta_link(nt_wire, precision)
    ptx, prx = _delta_link(pt_wire, precision)
    raw = pt_wire.WireConfig("raw", precision)
    stats = PtCounters()
    for i in range(0, len(frames), batch):
        group = frames[i:i + batch]
        if batch == 1:
            nmeta, npl = nt_wire.pack_buffer(group[0], ntx)
            pmeta, ppl = pt_wire.pack_buffer(_to_port(group[0]), ptx,
                                             stats=stats)
            got_pt = [pt_wire.unpack_buffer(nmeta, npl, cfg=prx)]
            got_nt = [nt_wire.unpack_buffer(pmeta, ppl, cfg=nrx)]
            ctrl = [pt_wire.unpack_buffer(*pt_wire.pack_buffer(
                _to_port(group[0]), raw))]
        else:
            seqs = [i + k + 1 for k in range(len(group))]
            nmeta, npl = nt_wire.pack_batch(group, ntx, seqs=seqs)
            pmeta, ppl = pt_wire.pack_batch([_to_port(b) for b in group],
                                            ptx, stats=stats, seqs=seqs)
            got_pt = pt_wire.unpack_batch(nmeta, npl, cfg=prx)
            got_nt = nt_wire.unpack_batch(pmeta, ppl, cfg=nrx)
            ctrl = pt_wire.unpack_batch(*pt_wire.pack_batch(
                [_to_port(b) for b in group], raw, seqs=seqs))
        assert json.dumps(_no_ts(pmeta)) == json.dumps(_no_ts(nmeta))
        assert [_pbytes(p) for p in ppl] == [_pbytes(p) for p in npl]
        want = [[_host(c.host()) for c in b.chunks] for b in ctrl]
        assert [[_host(c.host()) for c in b.chunks] for b in got_pt] == want
        assert [[_host(c.host()) for c in b.chunks] for b in got_nt] == want
        if precision == "none":
            assert want == [[_host(c.host()) for c in b.chunks]
                            for b in group]
    snap = stats.snapshot()
    assert snap["wire_delta_keyframes"] >= 1


def test_delta_parity_streams_ship_diffs():
    """The suite is not vacuous: the port's links ship sparse diffs."""
    stats = PtCounters()
    for _name, gen, precision in DP.BUILTIN:
        tx, rx = _delta_link(pt_wire, precision)
        for b in gen():
            pt_wire.unpack_buffer(*pt_wire.pack_buffer(_to_port(b), tx,
                                                       stats=stats), cfg=rx)
    assert stats["wire_delta_diffs"] > 0
    assert stats["wire_delta_promotions"] > 0


def test_bf16_delta_stream_bytes_equal():
    """bfloat16 frames (ml_dtypes in JAX, CPU torch.bfloat16 in the
    port) diff on their bits: the same messages, NaN and -0.0 included."""
    rng = np.random.default_rng(21)
    base = rng.standard_normal(600).astype(np.float32)
    base[:3] = [np.nan, -0.0, np.inf]
    ntx, _ = _delta_link(nt_wire, "none")
    ptx, prx = _delta_link(pt_wire, "none")
    for i in range(9):
        f = base.copy()
        f[(i * 37) % 600] = i
        f[1] = -0.0 if i % 2 else 0.0
        nv = f.astype(ml_dtypes.bfloat16)
        pv = torch.from_numpy(nv.view(np.int16).copy()).view(torch.bfloat16)
        nmeta, npl = nt_wire.pack_buffer(NtBuffer.from_arrays([nv]), ntx)
        pmeta, ppl = pt_wire.pack_buffer(PtBuffer.from_arrays([pv]), ptx)
        assert json.dumps(pmeta) == json.dumps(nmeta)
        assert [_pbytes(p) for p in ppl] == [_pbytes(p) for p in npl]
        got = pt_wire.unpack_buffer(nmeta, npl, cfg=prx).chunks[0].host()
        assert got.dtype == torch.bfloat16
        assert _host(got) == _host(pv)


def test_delta_trace_blocks_have_the_reference_keys():
    from nnstreamer_tpu.utils.trace import _wire_summary as nt_summary
    from nnstreamer_tpu_torch.utils.trace import _wire_summary as pt_summary
    st = {"wire_frames_out": 5, "wire_delta_keyframes": 2,
          "wire_delta_diffs": 3, "wire_delta_promotions": 1,
          "wire_delta_bytes_saved": 900, "wire_frames_in": 4,
          "wire_delta_keyframes_in": 1, "wire_delta_diffs_in": 3}
    assert pt_summary(st) == nt_summary(st)
    assert pt_summary(st)["delta"]["promotions"] == 1


# -- mirrored behaviour: negotiation ----------------------------------------


class TestNegotiation:
    @BOTH
    def test_v1_peer_means_plain(self, pkg):
        w = pkg.wire
        assert w.negotiate(None) is None
        assert w.negotiate({}) is None  # no version claim
        assert w.negotiate({"v": 1}) is None
        assert w.accept(None) is None
        assert w.accept({"v": 1}) is None

    @BOTH
    def test_peer_wish_adopted_when_local_default(self, pkg):
        cfg = pkg.wire.negotiate(pkg.wire.advertise(codec="zlib",
                                                    precision="fp16"))
        assert cfg.codec == "zlib" and cfg.precision == "fp16"

    @BOTH
    def test_local_request_wins_over_peer_wish(self, pkg):
        cfg = pkg.wire.negotiate(pkg.wire.advertise(codec="zlib"),
                                 codec="shuffle-zlib")
        assert cfg.codec == "shuffle-zlib"

    @BOTH
    def test_unsupported_codec_clamped_to_raw(self, pkg):
        peer = {"v": 2, "codec": "lz99", "codecs": ["raw", "lz99"]}
        cfg = pkg.wire.negotiate(peer)
        assert cfg is not None and cfg.codec == "raw"
        peer = {"v": 2, "codec": "raw", "codecs": ["raw"]}
        assert pkg.wire.negotiate(peer, codec="zlib").codec == "raw"

    @BOTH
    def test_accept_adopts_echoed_choice(self, pkg):
        server_cfg = pkg.wire.negotiate(pkg.wire.advertise(), codec="zlib",
                                        precision="bf16")
        client_cfg = pkg.wire.accept(server_cfg.to_meta())
        assert client_cfg.codec == "zlib"
        assert client_cfg.precision == "bf16"

    @pytest.mark.parametrize("codec", ["zlib", "shuffle-zlib"])
    @pytest.mark.parametrize("precision", ["none", "bf16", "fp16"])
    def test_cross_package_handshake_agrees(self, codec, precision):
        """Each package accepting the other's advertisement chooses the
        same config, and each adopts the other's echo."""
        for acc, con in ((nt_wire, pt_wire), (pt_wire, nt_wire)):
            cfg = acc.negotiate(con.advertise(codec, precision))
            assert (cfg.codec, cfg.precision, cfg.trace) == \
                (codec, precision, True)
            back = con.accept(cfg.to_meta())
            assert (back.codec, back.precision) == (codec, precision)


# -- mirrored behaviour: DATA_BATCH -----------------------------------------


class TestBatch:
    @BOTH
    def test_round_trip_restores_per_frame_meta(self, pkg):
        bufs = [pkg.Buffer.from_arrays(
            [np.full((4, 4), float(i), np.float32)], pts=i * 100)
            for i in range(5)]
        bufs[2].duration = 40
        cfg = pkg.wire.WireConfig("zlib")
        meta, payloads = pkg.wire.pack_batch(bufs, cfg,
                                             seqs=[10, 11, 12, 13, 14])
        assert meta["frames"] == 5 and len(meta["tensors"]) == 1
        out = pkg.wire.unpack_batch(meta, payloads)
        assert len(out) == 5
        for i, b in enumerate(out):
            assert b.pts == i * 100
            assert b.extras["seq"] == 10 + i
            np.testing.assert_array_equal(
                b.chunks[0].host(), np.full((4, 4), float(i), np.float32))
        assert out[2].duration == 40

    @BOTH
    def test_batch_compatible_gates_on_layout(self, pkg):
        a = pkg.Buffer.from_arrays([np.zeros(4, np.float32)])
        b = pkg.Buffer.from_arrays([np.zeros(4, np.float32)])
        c = pkg.Buffer.from_arrays([np.zeros(5, np.float32)])
        d = pkg.Buffer.from_arrays([np.zeros(4, np.int32)])
        assert pkg.wire.batch_compatible(a, b)
        assert not pkg.wire.batch_compatible(a, c)
        assert not pkg.wire.batch_compatible(a, d)


# -- mirrored behaviour: the socket layer -----------------------------------


class TestSocketTransport:
    @BOTH
    def test_round_trip_preallocates_writable_arrays(self, pkg):
        a, b = socket.socketpair()
        try:
            arr = np.arange(1024, dtype=np.float32).reshape(32, 32)
            meta, payloads = pkg.protocol.buffer_to_wire(
                pkg.Buffer.from_arrays([arr], pts=5))
            tx, rx = pkg.Counters(), pkg.Counters()
            sent = pkg.protocol.send_msg(a, pkg.protocol.MsgKind.DATA,
                                         meta, payloads, stats=tx)
            kind, rmeta, rpay = pkg.protocol.recv_msg(b, stats=rx)
            assert kind == pkg.protocol.MsgKind.DATA
            assert isinstance(rpay[0], np.ndarray)
            assert rpay[0].flags.writeable
            out = pkg.protocol.wire_to_buffer(rmeta, rpay)
            np.testing.assert_array_equal(out.chunks[0].host(), arr)
            out.chunks[0].host()[0, 0] = -1.0  # writable end to end
            assert tx.snapshot()["wire_bytes_out"] == sent
            assert rx.snapshot()["wire_bytes_in"] == sent
            assert tx.snapshot()["wire_msgs_out"] == 1
        finally:
            a.close()
            b.close()

    @BOTH
    def test_zero_size_payload_on_the_wire(self, pkg):
        a, b = socket.socketpair()
        try:
            meta, payloads = pkg.protocol.buffer_to_wire(
                pkg.Buffer.from_arrays([np.empty(0, np.uint8)]))
            pkg.protocol.send_msg(a, pkg.protocol.MsgKind.DATA, meta,
                                  payloads)
            _, rmeta, rpay = pkg.protocol.recv_msg(b)
            assert pkg.protocol.wire_to_buffer(rmeta, rpay).chunks[0] \
                .host().shape == (0,)
        finally:
            a.close()
            b.close()

    @BOTH
    def test_payload_length_guard_rejects_before_allocating(self, pkg):
        p = pkg.protocol
        a, b = socket.socketpair()
        try:
            mb = b"{}"
            a.sendall(p._HDR.pack(p.MAGIC, int(p.MsgKind.DATA), len(mb))
                      + mb + struct.pack("<I", 1)
                      + p._PLEN.pack(p.MAX_PAYLOAD + 1))
            with pytest.raises(ValueError, match="exceeds"):
                p.recv_msg(b)
        finally:
            a.close()
            b.close()

    @BOTH
    def test_meta_length_guard(self, pkg):
        p = pkg.protocol
        a, b = socket.socketpair()
        try:
            a.sendall(p._HDR.pack(p.MAGIC, int(p.MsgKind.DATA),
                                  p.MAX_META + 1))
            with pytest.raises(ValueError, match="meta length"):
                p.recv_msg(b)
        finally:
            a.close()
            b.close()

    @BOTH
    def test_bad_magic_is_refused(self, pkg):
        p = pkg.protocol
        a, b = socket.socketpair()
        try:
            a.sendall(p._HDR.pack(0xDEADBEEF, int(p.MsgKind.DATA), 0))
            with pytest.raises(ValueError, match="magic"):
                p.recv_msg(b)
        finally:
            a.close()
            b.close()

    @BOTH
    def test_sendmsg_fallback_path_matches(self, pkg, monkeypatch):
        monkeypatch.setattr(pkg.protocol, "_HAS_SENDMSG", False)
        a, b = socket.socketpair()
        try:
            arr = np.arange(64, dtype=np.int16)
            meta, payloads = pkg.protocol.buffer_to_wire(
                pkg.Buffer.from_arrays([arr]))
            pkg.protocol.send_msg(a, pkg.protocol.MsgKind.DATA, meta,
                                  payloads)
            _, rmeta, rpay = pkg.protocol.recv_msg(b)
            np.testing.assert_array_equal(
                pkg.protocol.wire_to_buffer(rmeta, rpay).chunks[0].host(),
                arr)
        finally:
            a.close()
            b.close()

    def test_sendmsg_fallback_puts_the_same_bytes_on_the_wire(
            self, monkeypatch):
        """The join+sendall fallback sends exactly the vectored path's
        bytes, which are the JAX package's."""
        nv, pv = _values(TensorType.BFLOAT16, "noise")
        got = []
        for fallback in (False, True):
            monkeypatch.setattr(pt_protocol, "_HAS_SENDMSG", not fallback)
            a, b = socket.socketpair()
            try:
                meta, pl = pt_protocol.buffer_to_wire(
                    PtBuffer.from_arrays([pv]))
                n = pt_protocol.send_msg(a, pt_protocol.MsgKind.DATA,
                                         meta, pl)
                got.append(b.recv(n, socket.MSG_WAITALL))
            finally:
                a.close()
                b.close()
        a, b = socket.socketpair()
        try:
            meta, pl = nt_protocol.buffer_to_wire(
                NtBuffer.from_arrays([nv]))
            n = nt_protocol.send_msg(a, nt_protocol.MsgKind.DATA, meta, pl)
            want = b.recv(n, socket.MSG_WAITALL)
        finally:
            a.close()
            b.close()
        assert got == [want, want]


# -- mirrored behaviour: the session layer ----------------------------------


class TestSessionNegotiation:
    @BOTH
    def test_v1_peer_means_no_session(self, pkg):
        s = pkg.session
        assert s.negotiate(None) is None
        assert s.negotiate({}) is None
        assert s.negotiate({"v": 0, "sid": "x"}) is None
        assert s.negotiate({"v": 1}) is None  # no sid
        assert s.accept(None) is None
        assert s.accept({}) is None

    @BOTH
    def test_round_trip_adopts_cadence_and_budget(self, pkg):
        s = pkg.session
        sid = s.new_session_id()
        cfg = s.negotiate(s.advertise(sid, ack_every=4, ack_ms=25.0),
                          ring_bytes=1 << 20)
        assert cfg is not None and cfg.sid == sid
        assert cfg.ack_every == 4 and cfg.ack_ms == 25.0
        assert cfg.ring_bytes == 1 << 20
        echoed = s.accept(cfg.to_meta())
        assert echoed.sid == sid and echoed.ack_every == 4
        assert echoed.ring_bytes == 1 << 20

    @BOTH
    def test_session_ids_are_unique(self, pkg):
        assert len({pkg.session.new_session_id() for _ in range(64)}) == 64

    def test_session_blocks_are_the_reference_blocks(self):
        sid = pt_session.new_session_id()
        adv = pt_session.advertise(sid, 4, 25.0)
        assert adv == nt_session.advertise(sid, 4, 25.0)
        assert pt_session.negotiate(adv, 1 << 20).to_meta() == \
            nt_session.negotiate(adv, 1 << 20).to_meta()


class TestReplayRing:
    @staticmethod
    def _frame(nbytes=256):
        return np.zeros(nbytes, np.uint8)

    @BOTH
    def test_replay_covers_retained_gap_exactly(self, pkg):
        ring = pkg.session.ReplayRing(1 << 20)
        for s in range(1, 11):
            ring.append(s, self._frame())
        replay, lost = ring.replay_from(4)
        assert lost == 0
        assert [s for s, _ in replay] == list(range(4, 11))

    @BOTH
    def test_release_moves_floor_without_declaring_loss(self, pkg):
        ring = pkg.session.ReplayRing(1 << 20)
        for s in range(1, 11):
            ring.append(s, self._frame())
        ring.release(6)
        assert len(ring) == 4
        replay, lost = ring.replay_from(7)
        assert lost == 0 and [s for s, _ in replay] == [7, 8, 9, 10]

    @BOTH
    def test_eviction_is_declared_exactly(self, pkg):
        ring = pkg.session.ReplayRing(1024)  # room for ~4 x 256B frames
        for s in range(1, 11):
            ring.append(s, self._frame(256))
        assert ring.nbytes <= 1024
        evicted = ring.evicted_through
        assert evicted >= 6
        replay, lost = ring.replay_from(1)
        assert lost == evicted
        assert [s for s, _ in replay] == list(range(evicted + 1, 11))

    @BOTH
    def test_newest_frame_survives_even_alone_over_budget(self, pkg):
        ring = pkg.session.ReplayRing(10)
        ring.append(1, self._frame(256))
        ring.append(2, self._frame(256))
        replay, lost = ring.replay_from(1)
        assert [s for s, _ in replay] == [2] and lost == 1


class TestSessionReceiver:
    @staticmethod
    def _cfg(pkg, **kw):
        return pkg.session.SessionConfig(pkg.session.new_session_id(), **kw)

    @BOTH
    def test_dedup_by_watermark(self, pkg):
        r = pkg.session.SessionReceiver(self._cfg(pkg))
        assert r.admit(1) and r.admit(2) and r.admit(3)
        assert not r.admit(2)
        assert not r.admit(3)
        assert r.dup_drops == 2
        assert r.admit(4)
        assert r.last_delivered == 4

    @BOTH
    def test_no_seq_always_passes(self, pkg):
        r = pkg.session.SessionReceiver(self._cfg(pkg))
        assert r.admit(None) and r.admit(None)
        assert r.last_delivered == 0

    @BOTH
    def test_ack_due_by_count(self, pkg):
        r = pkg.session.SessionReceiver(self._cfg(pkg, ack_every=3,
                                                  ack_ms=1e9))
        r.admit(1), r.admit(2)
        assert r.ack_due(now=r._ack_t) is None
        r.admit(3)
        assert r.ack_due(now=r._ack_t) == 3
        r.mark_acked(3)
        assert r.ack_due(now=r._ack_t) is None

    @BOTH
    def test_ack_due_by_silence(self, pkg):
        r = pkg.session.SessionReceiver(self._cfg(pkg, ack_every=100,
                                                  ack_ms=50.0))
        r.admit(1)
        assert r.ack_due(now=r._ack_t + 0.01) is None
        assert r.ack_due(now=r._ack_t + 0.06) == 1

    @BOTH
    def test_reset_adopts_new_seq_space(self, pkg):
        r = pkg.session.SessionReceiver(self._cfg(pkg))
        r.admit(5)
        r.reset(100)
        assert not r.admit(99)
        assert r.admit(101)


class TestHeartbeat:
    @BOTH
    def test_ping_cadence_and_peer_death(self, pkg):
        hb = pkg.session.Heartbeat(1.0, miss_limit=2)
        t0 = hb.last_sent
        assert not hb.due(now=t0 + 0.5)
        assert hb.due(now=t0 + 1.1)
        hb.sent(now=t0 + 1.1)
        assert not hb.peer_dead
        hb.sent(now=t0 + 2.2)
        assert hb.peer_dead

    @BOTH
    def test_pong_and_any_traffic_prove_liveness(self, pkg):
        hb = pkg.session.Heartbeat(1.0, miss_limit=2)
        t0 = hb.last_sent
        hb.sent(now=t0 + 1.0)
        rtt = hb.pong(t0 + 1.0, now=t0 + 1.25)
        assert abs(rtt - 0.25) < 1e-9
        assert hb.outstanding == 0 and hb.pongs == 1
        hb.sent(), hb.heard()
        assert hb.outstanding == 0


# -- import hygiene ----------------------------------------------------------


@pytest.mark.parametrize("modules", [
    "nnstreamer_tpu_torch.edge", "nnstreamer_tpu_torch.obs",
    "nnstreamer_tpu_torch.elements.query",
    "nnstreamer_tpu_torch.elements.edge"])
def test_new_modules_import_no_jax(modules):
    """Each of the among-device modules, imported first in a fresh
    interpreter, loads nothing of JAX, ml_dtypes or the JAX package."""
    import os
    import subprocess
    import sys
    code = (f"import sys, importlib; importlib.import_module({modules!r}); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'ml_dtypes', 'nnstreamer_tpu')]; "
            "assert not bad, bad")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root)
