"""The port's temporal-delta compute skip (nnstreamer_tpu_torch/ops/delta.py,
elements/delta.py) against the JAX package's, on the CPU.

tests/test_delta.py's ``TestTensorDelta`` and ``TestTensorDeltaStitch``
cases run as one test each parametrised over both packages, and the
gate decisions, stats and outputs of the two packages are held equal on
the same seeded streams. ``tile_error`` runs as torch ops on CPU tensors
against the JAX jitted op and the numpy oracle: the blocked mean reduces
in another order, so energies are held to 1e-6 relative (float32
rounding of a 256-term mean) and gate decisions exactly. The device
path (``device=true`` on a chunk on the device) runs here on the CPU by
treating a CPU tensor as device-resident: the same torch ops the card
runs. The pipelines: gate in front of a custom-easy filter, mask into
``tensor_if``, and ``roi`` through ``tensor_query_client`` to a port
``tensor_query_serversrc`` server and back into ``tensor_delta_stitch``,
whose output equals the full-frame oracle byte for byte. Every socket
test takes a free port and a time limit of its own.
"""
import dataclasses
import socket
import time
from types import ModuleType

import numpy as np
import pytest
import torch

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as pt
from nnstreamer_tpu.elements import delta as nt_delta
from nnstreamer_tpu.ops import delta as nt_ops
from nnstreamer_tpu.pipeline import events as nt_events
from nnstreamer_tpu.tensors import buffer as nt_buffer
from nnstreamer_tpu_torch.elements import delta as pt_delta
from nnstreamer_tpu_torch.ops import delta as pt_ops
from nnstreamer_tpu_torch.pipeline import events as pt_events
from nnstreamer_tpu_torch.tensors import buffer as pt_buffer

ENERGY_RTOL = 1e-6


@dataclasses.dataclass(frozen=True)
class Pkg:
    top: ModuleType
    delta: ModuleType
    events: ModuleType
    buffer: ModuleType


NT = Pkg(nt, nt_delta, nt_events, nt_buffer)
PT = Pkg(pt, pt_delta, pt_events, pt_buffer)
BOTH = pytest.mark.parametrize("pkg", [NT, PT], ids=["jax", "torch"])


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _frames(n, shape=(16, 16, 3), patch=8, dtype=np.uint8, seed=0,
            move_every=1):
    """Deterministic moving-patch stream; move_every>1 repeats frames."""
    rng = np.random.default_rng(seed)
    cur = rng.integers(0, 255, shape, dtype, endpoint=True)
    out = [cur.copy()]
    for i in range(1, n):
        if i % move_every == 0:
            cur = cur.copy()
            y = int(rng.integers(0, shape[0] - patch + 1))
            x = int(rng.integers(0, shape[1] - patch + 1))
            cur[y:y + patch, x:x + patch] = rng.integers(
                0, 255, (patch, patch) + shape[2:], dtype, endpoint=True)
        out.append(cur.copy())
    return out


def _feed(pkg, el, arr, pts=None):
    return el.transform(pkg.top.Buffer([pkg.buffer.Chunk(np.asarray(arr))],
                                       pts=pts))


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- tile_error ---------------------------------------------------------------


@pytest.mark.parametrize("tile", [4, 8, 16])
def test_tile_error_matches_jax_and_the_oracle(tile):
    import jax.numpy as jnp
    rng = np.random.default_rng(tile)
    cur = rng.standard_normal((32, 48)).astype(np.float32) * 50
    ref = cur + rng.standard_normal((32, 48)).astype(np.float32)
    want = nt_ops.tile_error_reference(cur, ref, tile)
    assert np.array_equal(pt_ops.tile_error_reference(cur, ref, tile), want)
    got = pt_ops.tile_error(torch.from_numpy(cur), torch.from_numpy(ref),
                            tile).numpy()
    jx = np.asarray(nt_ops.tile_error(jnp.asarray(cur), jnp.asarray(ref),
                                      tile))
    assert got.shape == want.shape == (32 // tile, 48 // tile)
    np.testing.assert_allclose(got, want, rtol=ENERGY_RTOL, atol=0)
    np.testing.assert_allclose(got, jx, rtol=ENERGY_RTOL, atol=0)


def test_tile_error_counts_only_card_runs():
    pt_ops.runs = 0
    pt_ops.tile_error(torch.zeros(8, 8), torch.ones(8, 8), 4)
    assert pt_ops.runs == 0


# -- tensor_delta, mirrored ---------------------------------------------------


class TestTensorDelta:
    @BOTH
    def test_first_frame_goes_out_full(self, pkg):
        d = pkg.delta.TensorDelta(mode="gate")
        out = _feed(pkg, d, np.zeros((8, 8), np.float32))
        assert out is not None
        assert out.extras["delta_full"] == 1
        assert out.extras["delta_changed"] is True
        assert d.stats["delta_keyframes"] == 1

    @BOTH
    def test_gate_drops_static_frames(self, pkg):
        d = pkg.delta.TensorDelta(mode="gate", tile=4)
        a = np.arange(64, dtype=np.float32).reshape(8, 8)
        assert _feed(pkg, d, a) is not None
        assert _feed(pkg, d, a.copy()) is None
        assert _feed(pkg, d, a.copy()) is None
        b = a.copy()
        b[0, 0] += 5
        out = _feed(pkg, d, b)
        assert out is not None and out.extras["delta_changed"] is True
        st = d.stats.snapshot()
        assert st["delta_frames_skipped"] == 2
        assert st["delta_tiles_total"] == 3 * 4
        assert st["delta_tiles_skipped"] == 2 * 4 + 3

    @BOTH
    def test_threshold_suppresses_small_motion(self, pkg):
        d = pkg.delta.TensorDelta(mode="gate", tile=8, threshold=10.0)
        a = np.full((8, 8), 100.0, np.float32)
        assert _feed(pkg, d, a) is not None
        b = a.copy()
        b[0, 0] += 1.0
        assert _feed(pkg, d, b) is None
        c = a.copy()
        c[:] += 20.0
        assert _feed(pkg, d, c) is not None

    @BOTH
    def test_hold_forces_periodic_full_frames(self, pkg):
        d = pkg.delta.TensorDelta(mode="gate", hold=3)
        a = np.zeros((4, 4), np.float32)
        got = [_feed(pkg, d, a.copy()) is not None for _ in range(7)]
        assert got == [True, False, False, True, False, False, True]
        assert d.stats["delta_keyframes"] == 3

    @BOTH
    def test_segment_and_flush_reset_reference(self, pkg):
        d = pkg.delta.TensorDelta(mode="gate")
        a = np.ones((4, 4), np.float32)
        assert _feed(pkg, d, a) is not None
        assert _feed(pkg, d, a.copy()) is None
        d.handle_event(None, pkg.events.SegmentEvent())
        assert _feed(pkg, d, a.copy()) is not None
        assert _feed(pkg, d, a.copy()) is None
        d.handle_event(None, pkg.events.FlushEvent())
        assert _feed(pkg, d, a.copy()) is not None

    @BOTH
    def test_layout_change_forces_full_frame(self, pkg):
        d = pkg.delta.TensorDelta(mode="gate")
        assert _feed(pkg, d, np.zeros((4, 4), np.float32)) is not None
        assert _feed(pkg, d, np.zeros((4, 4), np.float32)) is None
        out = _feed(pkg, d, np.zeros((2, 8), np.float32))
        assert out is not None and out.extras["delta_full"] == 1

    @BOTH
    def test_mask_mode_annotates_never_drops(self, pkg):
        d = pkg.delta.TensorDelta(mode="mask", tile=4)
        a = np.zeros((8, 8), np.float32)
        assert _feed(pkg, d, a).extras["delta_full"] == 1
        out = _feed(pkg, d, a.copy())
        assert out is not None
        assert out.extras["delta_changed"] is False
        assert not out.extras["delta_mask"].any()
        b = a.copy()
        b[0, 0] = 9.0
        out = _feed(pkg, d, b)
        assert out.extras["delta_changed"] is True
        assert out.extras["delta_mask"].sum() == 1
        assert out.extras["delta_grid"] == (2, 2)

    @BOTH
    def test_roi_mode_ships_only_changed_tiles(self, pkg):
        d = pkg.delta.TensorDelta(mode="roi", tile=8)
        frames = _frames(2, shape=(16, 16, 3), patch=8)
        _feed(pkg, d, frames[0])
        out = _feed(pkg, d, frames[1])
        assert out is not None
        crops = _host(out.chunks[0].host())
        rois = out.extras["delta_rois"]
        assert crops.shape[1:] == (8, 8, 3)
        assert 1 <= crops.shape[0] <= 4 and len(rois) == crops.shape[0]
        for k, (i, j) in enumerate(rois):
            np.testing.assert_array_equal(
                crops[k], frames[1][i * 8:(i + 1) * 8, j * 8:(j + 1) * 8])

    @BOTH
    def test_roi_ragged_edges_zero_padded(self, pkg):
        d = pkg.delta.TensorDelta(mode="roi", tile=8)
        a = np.zeros((12, 12), np.float32)
        _feed(pkg, d, a)
        b = a.copy()
        b[10, 10] = 7.0
        out = _feed(pkg, d, b)
        crops = _host(out.chunks[0].host())
        assert crops.shape == (1, 8, 8, 1)
        np.testing.assert_array_equal(crops[0, :4, :4, 0], b[8:, 8:])
        assert (crops[0, 4:, :, 0] == 0).all()
        assert out.extras["delta_shape"] == (12, 12)

    @BOTH
    def test_unknown_mode_rejected(self, pkg):
        with pytest.raises(ValueError, match="unknown mode"):
            pkg.delta.TensorDelta(mode="bogus")


@pytest.mark.parametrize("mode,tile,threshold", [
    ("gate", 8, 0.0), ("gate", 4, 2.0), ("mask", 8, 0.0), ("roi", 8, 1.0)])
def test_decisions_and_outputs_equal_jax(mode, tile, threshold):
    """The same seeded stream through both packages: the same frames
    pass, with the same masks, crops and stats."""
    frames = _frames(12, shape=(24, 32, 3), patch=6, seed=11, move_every=2)
    frames = [f.astype(np.float32) for f in frames]
    dn = nt_delta.TensorDelta(mode=mode, tile=tile, threshold=threshold,
                              hold=5)
    dp = pt_delta.TensorDelta(mode=mode, tile=tile, threshold=threshold,
                              hold=5)
    for f in frames:
        a, b = _feed(NT, dn, f), _feed(PT, dp, f.copy())
        assert (a is None) == (b is None)
        if a is None:
            continue
        for k in ("delta_changed", "delta_full", "delta_grid", "delta_rois"):
            assert a.extras.get(k) == b.extras.get(k)
        if "delta_mask" in a.extras:
            assert np.array_equal(a.extras["delta_mask"],
                                  b.extras["delta_mask"])
        assert _host(b.chunks[0].host()).tobytes() == \
            np.asarray(a.chunks[0].host()).tobytes()
    assert dn.stats.snapshot() == dp.stats.snapshot()


def test_bf16_roi_crops_equal_jax():
    import ml_dtypes
    frames = _frames(3, shape=(16, 16, 3), patch=8, seed=4)
    dn = nt_delta.TensorDelta(mode="roi", tile=8)
    dp = pt_delta.TensorDelta(mode="roi", tile=8)
    for f in frames:
        nv = (f.astype(np.float32) / 7).astype(ml_dtypes.bfloat16)
        pv = torch.from_numpy(nv.view(np.int16).copy()).view(torch.bfloat16)
        a = dn.transform(nt.Buffer([nt_buffer.Chunk(nv)]))
        b = dp.transform(pt.Buffer([pt_buffer.Chunk(pv)]))
        assert (a is None) == (b is None)
        if a is not None:
            got = b.chunks[0].host()
            assert got.dtype == torch.bfloat16
            assert got.view(torch.int16).numpy().tobytes() == \
                np.asarray(a.chunks[0].host()).tobytes()


@pytest.fixture
def cpu_as_device(monkeypatch):
    """A CPU tensor counts as device-resident: the device path's torch
    ops run here."""
    monkeypatch.setattr(pt_buffer, "is_device_tensor",
                        lambda x: isinstance(x, torch.Tensor))


def test_device_detection_matches_host(cpu_as_device):
    """device=true energies agree with the JAX device path within
    ENERGY_RTOL, and the same frames are gated as on the host."""
    import jax
    frames = _frames(8, shape=(32, 32, 3), patch=8, move_every=2)
    host = pt_delta.TensorDelta(mode="gate", tile=8)
    dev = pt_delta.TensorDelta(mode="gate", tile=8, device=True)
    jdev = nt_delta.TensorDelta(mode="gate", tile=8, device=True)
    energies = []
    orig = pt_ops.tile_error

    def spy(cur, ref, tile):
        out = orig(cur, ref, tile)
        energies.append(out.numpy().copy())
        return out

    jenergies = []
    jorig = nt_ops.tile_error

    def jspy(cur, ref, tile):
        out = jorig(cur, ref, tile)
        jenergies.append(np.asarray(out))
        return out

    pt_ops.tile_error, nt_ops.tile_error = spy, jspy
    try:
        for f in frames:
            h = _feed(PT, host, f)
            g = dev.transform(pt.Buffer([pt_buffer.Chunk(
                torch.from_numpy(f.copy()))]))
            j = jdev.transform(nt.Buffer([nt_buffer.Chunk(
                jax.device_put(f))]))
            assert (h is None) == (g is None) == (j is None)
    finally:
        pt_ops.tile_error, nt_ops.tile_error = orig, jorig
    assert len(energies) == len(jenergies) == len(frames) - 1
    for e, je in zip(energies, jenergies):
        np.testing.assert_allclose(e, je, rtol=ENERGY_RTOL, atol=0)
    assert host.stats.snapshot()["delta_frames_skipped"] == \
        dev.stats.snapshot()["delta_frames_skipped"] > 0


def test_host_chunk_after_a_device_chunk(cpu_as_device):
    """A host chunk that follows a device chunk diffs against the
    reference the device chunk left (copied back explicitly)."""
    d = pt_delta.TensorDelta(mode="gate", tile=4, device=True)
    a = np.arange(64, dtype=np.float32).reshape(8, 8)
    assert d.transform(pt.Buffer([pt_buffer.Chunk(torch.from_numpy(a))])) \
        is not None
    assert isinstance(d._ref, torch.Tensor)
    assert _feed(PT, d, a.copy()) is None  # same frame, now on the host
    b = a.copy()
    b[0, 0] += 1
    assert d.transform(pt.Buffer([pt_buffer.Chunk(
        torch.from_numpy(b))])) is not None


class TestTensorDeltaStitch:
    @BOTH
    def test_roi_stitch_equals_full_frame(self, pkg):
        det = pkg.delta.TensorDelta(mode="roi", tile=8, threshold=0.0)
        st = pkg.delta.TensorDeltaStitch()
        frames = _frames(8, shape=(24, 24, 3), patch=8, seed=3)
        for f in frames:
            out = det.transform(pkg.top.Buffer([pkg.buffer.Chunk(f)]))
            if out is None:
                continue
            got = st.transform(out)
            np.testing.assert_array_equal(_host(got.chunks[0].host()), f)
            assert "delta_rois" not in got.extras
        assert st.stats["delta_stitched"] > 0

    @BOTH
    def test_scaled_model_head(self, pkg):
        det = pkg.delta.TensorDelta(mode="roi", tile=8)
        st = pkg.delta.TensorDeltaStitch()
        frames = _frames(5, shape=(16, 16, 3), patch=8, seed=5)
        Chunk = pkg.buffer.Chunk
        for f in frames:
            out = det.transform(pkg.top.Buffer([Chunk(f)]))
            if out is None:
                continue
            if "delta_rois" in out.extras:
                crops = _host(out.chunks[0].host())
                out = out.with_chunks([Chunk(np.ascontiguousarray(
                    crops[:, ::2, ::2, :]))])
            else:
                full = _host(out.chunks[0].host())
                out = out.with_chunks([Chunk(np.ascontiguousarray(
                    full[::2, ::2, :]))])
            got = _host(st.transform(out).chunks[0].host())
            assert got.shape == (8, 8, 3)
            np.testing.assert_array_equal(got, f[::2, ::2, :])

    @BOTH
    def test_full_frame_refreshes_canvas_after_layout_change(self, pkg):
        st = pkg.delta.TensorDeltaStitch()
        a = np.arange(64, dtype=np.float32).reshape(8, 8)
        got = st.transform(pkg.top.Buffer([pkg.buffer.Chunk(a)]))
        np.testing.assert_array_equal(_host(got.chunks[0].host()), a)
        b = np.zeros((4, 4), np.float32)
        got = st.transform(pkg.top.Buffer([pkg.buffer.Chunk(b)]))
        np.testing.assert_array_equal(_host(got.chunks[0].host()), b)


# -- pipelines ------------------------------------------------------------------


CAPS_IMG = ('other/tensors,format=static,num_tensors=1,'
            'types=(string)float32,dimensions=(string)3:16:16')


@BOTH
def test_gate_skips_filter_invokes(pkg):
    invokes = []
    name = f"delta_count_{pkg.top.__name__}"
    pkg.top.filters.register_custom_easy(
        name, lambda x: (invokes.append(1), x * 2)[1])
    pipe = pkg.top.parse_launch(
        f'appsrc name=in caps="{CAPS_IMG}" '
        '! tensor_delta name=d mode=gate tile=8 '
        f'! tensor_filter framework=custom-easy model={name} '
        '! appsink name=out')
    pipe.start()
    frame = np.random.default_rng(0).standard_normal(
        (16, 16, 3)).astype(np.float32)
    for _ in range(6):
        pipe["in"].push_buffer(pkg.top.Buffer.from_arrays([frame.copy()]))
    pipe["in"].end_stream()
    assert pipe.wait_eos(timeout=10)
    stats = pipe["d"].stats.snapshot()
    pipe.stop()
    assert len(pipe["out"].buffers) == 1
    assert len(invokes) == 1
    assert stats["delta_frames_skipped"] == 5


@BOTH
def test_mask_mode_feeds_tensor_if(pkg):
    pipe = pkg.top.parse_launch(
        f'appsrc name=in caps="{CAPS_IMG}" '
        '! tensor_delta name=d mode=mask tile=8 '
        '! tensor_if name=i compared-value=CUSTOM '
        'compared-value-option=delta_changed then=PASSTHROUGH '
        'else=SKIP ! appsink name=out')
    pipe.start()
    frames = _frames(6, shape=(16, 16, 3), dtype=np.uint8, move_every=3,
                     seed=2)
    for f in frames:
        pipe["in"].push_buffer(pkg.top.Buffer.from_arrays(
            [f.astype(np.float32)]))
    pipe["in"].end_stream()
    assert pipe.wait_eos(timeout=10)
    got = len(pipe["out"].buffers)
    pipe.stop()
    assert got == 2


def test_roi_query_path_only_changed_crops_inferred():
    """tensor_delta mode=roi ! tensor_query_client to a port
    tensor_query_serversrc running a custom-easy scale, then
    tensor_delta_stitch: only changed crops cross the link and the
    filter; the stitched stream equals the full-frame oracle exactly."""
    shapes = []
    pt.filters.register_custom_easy(
        "delta_roi_scale_pt",
        lambda x: (shapes.append(np.asarray(x).shape), x * 3)[1])
    port = _free_port()
    server = pt.parse_launch(
        f"tensor_query_serversrc name=src port={port} id={port} "
        "! tensor_filter framework=custom-easy model=delta_roi_scale_pt "
        f"! tensor_query_serversink id={port}")
    server.start()
    client = pt.parse_launch(
        f'appsrc name=in caps="{CAPS_IMG}" '
        '! tensor_delta name=d mode=roi tile=8 '
        f'! tensor_query_client name=qc port={port} timeout=15 '
        '! tensor_delta_stitch name=st ! appsink name=out')
    frames = [f.astype(np.float32) for f in _frames(
        5, shape=(16, 16, 3), patch=8, seed=7)]
    try:
        client.start()
        for f in frames:
            client["in"].push_buffer(pt.Buffer.from_arrays([f.copy()]))
        deadline = time.monotonic() + 20
        while len(client["out"].buffers) < 5 and \
                time.monotonic() < deadline:
            time.sleep(0.02)
        det = client["d"].stats.snapshot()
        got = client["out"].buffers
    finally:
        client["in"].end_stream()
        client.stop()
        server.stop()
    assert len(got) == 5
    for f, b in zip(frames, got):
        np.testing.assert_array_equal(b.chunks[0].host(), f * 3)
    crops = sum(s[0] for s in shapes if len(s) == 4)
    assert crops == det["delta_tiles_total"] - det["delta_tiles_skipped"]
    assert crops < 4 * 4
    assert all(s in ((16, 16, 3),) or s[1:] == (8, 8, 3) for s in shapes)


def test_new_modules_parse_in_the_port():
    """tensor_sparse_enc/dec and tensor_delta/_stitch are elements of
    the port: a line with all four parses and runs."""
    pipe = pt.parse_launch(
        f'appsrc name=in caps="{CAPS_IMG}" ! tensor_sparse_enc '
        '! tensor_sparse_dec ! tensor_delta mode=roi tile=8 '
        '! tensor_delta_stitch ! appsink name=out')
    pipe.start()
    f = np.zeros((16, 16, 3), np.float32)
    pipe["in"].push_buffer(pt.Buffer.from_arrays([f]))
    pipe["in"].end_stream()
    assert pipe.wait_eos(timeout=10)
    pipe.stop()
    assert len(pipe["out"].buffers) == 1
