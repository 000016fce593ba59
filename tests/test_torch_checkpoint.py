"""The port's checkpoint layer (nnstreamer_tpu_torch/checkpoint/,
Pipeline.snapshot/restore/preempt, fault/preempt.py and the elements'
snapshot hooks) against the JAX package's, on the CPU.

Mirrors tests/test_checkpoint.py's ``TestSnapshotStore``,
``TestPipelinePreemptRestore``, ``TestElementRoundTrips`` (the llm
case is in tests/test_torch_llm_disagg.py), ``TestStatefulNoCheckpointRule``,
``TestTrainerResume`` and ``TestPreemptChaos::
test_sigterm_mid_training_resumes_exact_step`` (a child process killed
with SIGTERM mid-training; 80 epochs here, not the reference's 400, so
it runs in tier 1), and adds what only a two-package run shows:

* the same writer and meta give a MANIFEST.json byte-equal to the JAX
  store's, and a snapshot either package's pipeline published passes
  the other package's ``SnapshotStore.verify`` (and a tampered one fails
  there by the same blob name);
* each element's snapshot dict equals the JAX element's on the same
  stream (host arrays compared exactly: the hooks copy frames, they
  compute nothing);
* ``stateful-no-checkpoint`` gives the JAX package's findings.

Inputs are numpy arrays from fixed seeds; every comparison is exact
unless a tolerance is stated beside it.
"""
import json
import os
import pickle
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as pt
from nnstreamer_tpu.analysis import analyze as nt_analyze
from nnstreamer_tpu.checkpoint import SnapshotStore as NtStore
from nnstreamer_tpu.pipeline.element import SinkElement as NtSinkElement
from nnstreamer_tpu.pipeline.registry import \
    register_element as nt_register_element
from nnstreamer_tpu_torch.analysis import Severity, analyze
from nnstreamer_tpu_torch.checkpoint import (MANIFEST, SnapshotError,
                                             SnapshotStore)
from nnstreamer_tpu_torch.filters import register_custom_easy
from nnstreamer_tpu_torch.pipeline.element import SinkElement
from nnstreamer_tpu_torch.pipeline.registry import register_element

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CAPS4 = ('other/tensors,format=static,num_tensors=1,'
         'types=(string)float32,dimensions=(string)4,'
         'framerate=(fraction)0/1')


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module", autouse=True)
def _ckpt_models():
    register_custom_easy("ckpt_double", lambda x: x * 2)
    yield


def _hold_sink(base):
    class _HoldSink(base):
        """Test sink whose rendered frames count as still in flight: the
        degraded preempt path must DECLARE them as abandoned."""

        CHECKPOINTABLE = "the held frame count"

        def __init__(self, name=None, **props):
            super().__init__(name, **props)
            self._held = 0

        def render(self, buf):
            self._held += 1

        def preempt_inflight(self):
            return self._held

        def snapshot_state(self, snap_dir):
            return {"held": self._held} if self._held else None

        def restore_state(self, state, snap_dir):
            self._held = int(state["held"])

    return _HoldSink


def _amnesiac_sink(base):
    class _AmnesiacSink(base):
        """Seeded pipelint defect: declares it cannot survive a restart
        but implements no snapshot hook."""

        RESTART_SAFE = False

        def render(self, buf):
            pass

    return _AmnesiacSink


register_element("ckpt_hold_sink")(_hold_sink(SinkElement))
register_element("ckpt_amnesiac_sink")(_amnesiac_sink(SinkElement))


def _jax_test_elements():
    """The same two elements in the JAX package's registry, unless
    tests/test_checkpoint.py (which registers them at import) was
    collected in this process. Called from tests, after collection, so
    that module's import never meets a name taken here."""
    from nnstreamer_tpu.pipeline.registry import _ELEMENTS as NT_ELEMENTS
    for name, make in (("ckpt_hold_sink", _hold_sink),
                       ("ckpt_amnesiac_sink", _amnesiac_sink)):
        if name not in NT_ELEMENTS:
            nt_register_element(name)(make(NtSinkElement))


# -------------------------------------------------------------- store

def _writer(payload=b"snapshot-bytes " * 64):
    def writer(tmp):
        os.makedirs(os.path.join(tmp, "elements"))
        with open(os.path.join(tmp, "elements", "a.blob"), "wb") as f:
            f.write(payload)
    return writer


def _one_blob_snapshot(root, store_cls=SnapshotStore):
    store = store_cls(str(root), retain=3)
    return store, store.save(_writer(), meta={"kind": "unit"})


class TestSnapshotStore:
    def test_save_publishes_atomically_and_verifies(self, tmp_path):
        store, snap = _one_blob_snapshot(tmp_path / "ckpt")
        assert store.latest() == snap
        assert not [n for n in os.listdir(store.root)
                    if n.startswith(".tmp-")]
        manifest = SnapshotStore.verify(snap)
        assert manifest["meta"] == {"kind": "unit"}
        assert "elements/a.blob" in manifest["files"]

    def test_tampered_blob_rejected_by_name(self, tmp_path):
        _, snap = _one_blob_snapshot(tmp_path / "ckpt")
        path = os.path.join(snap, "elements", "a.blob")
        raw = bytearray(open(path, "rb").read())
        raw[0] ^= 0xFF  # same size, different content
        open(path, "wb").write(bytes(raw))
        with pytest.raises(SnapshotError) as exc:
            SnapshotStore.verify(snap)
        assert exc.value.blob == "elements/a.blob"
        assert "sha256 mismatch" in str(exc.value)

    def test_truncated_blob_rejected_by_name(self, tmp_path):
        _, snap = _one_blob_snapshot(tmp_path / "ckpt")
        path = os.path.join(snap, "elements", "a.blob")
        with open(path, "r+b") as f:
            f.truncate(10)
        with pytest.raises(SnapshotError) as exc:
            SnapshotStore.verify(snap)
        assert exc.value.blob == "elements/a.blob"
        assert "truncated" in str(exc.value)

    def test_missing_blob_rejected_by_name(self, tmp_path):
        _, snap = _one_blob_snapshot(tmp_path / "ckpt")
        os.remove(os.path.join(snap, "elements", "a.blob"))
        with pytest.raises(SnapshotError) as exc:
            SnapshotStore.verify(snap)
        assert exc.value.blob == "elements/a.blob"

    def test_malformed_manifest_rejected(self, tmp_path):
        _, snap = _one_blob_snapshot(tmp_path / "ckpt")
        mpath = os.path.join(snap, MANIFEST)
        open(mpath, "w").write("{not json")
        with pytest.raises(SnapshotError) as exc:
            SnapshotStore.verify(snap)
        assert exc.value.blob == MANIFEST
        open(mpath, "w").write('{"version": 99, "files": {}}')
        with pytest.raises(SnapshotError):
            SnapshotStore.verify(snap)

    def test_retain_n_gc_keeps_newest(self, tmp_path):
        store = SnapshotStore(str(tmp_path / "ckpt"), retain=2)
        for i in range(5):
            store.save(lambda tmp, i=i: open(
                os.path.join(tmp, "x.blob"), "wb").write(bytes([i])))
        snaps = store.snapshots()
        assert len(snaps) == 2
        assert [os.path.basename(s) for s in snaps] == \
            ["snap-00000004", "snap-00000005"]
        assert store.latest() == snaps[-1]

    def test_crashed_tmp_dirs_swept(self, tmp_path):
        root = tmp_path / "ckpt"
        os.makedirs(root / ".tmp-snap-00000001-999")
        _, snap = _one_blob_snapshot(root)
        assert not [n for n in os.listdir(root) if n.startswith(".tmp-")]
        SnapshotStore.verify(snap)

    def test_manifest_byte_equal_to_the_jax_store(self, tmp_path):
        _, ours = _one_blob_snapshot(tmp_path / "port")
        _, theirs = _one_blob_snapshot(tmp_path / "jax", NtStore)
        assert os.path.basename(ours) == os.path.basename(theirs)
        assert open(os.path.join(ours, MANIFEST), "rb").read() == \
            open(os.path.join(theirs, MANIFEST), "rb").read()

    @pytest.mark.parametrize("writer_pkg", ["port", "jax"])
    def test_either_package_verifies_the_others_snapshot(self, tmp_path,
                                                         writer_pkg):
        """A pipeline snapshot (the aggregator's window) published by one
        package passes the other's verify; a tampered blob fails there
        by the same name."""
        pkg = pt if writer_pkg == "port" else nt
        verify = NtStore.verify if writer_pkg == "port" \
            else SnapshotStore.verify
        ckpt = str(tmp_path / "ckpt")
        pipe = pkg.parse_launch(_agg_desc())
        pipe.start()
        _push4(pipe, [1, 2], pkg)
        _wait(lambda: len(pipe["agg"]._window) == 2)
        pipe.preempt(0.5, ckpt)
        snap = (SnapshotStore if writer_pkg == "port" else NtStore)(
            ckpt).latest()
        manifest = verify(snap)
        assert sorted(manifest["files"]) == ["elements/agg.blob"]
        blob = os.path.join(snap, "elements", "agg.blob")
        raw = bytearray(open(blob, "rb").read())
        raw[-1] ^= 0xFF
        open(blob, "wb").write(bytes(raw))
        with pytest.raises(Exception) as exc:
            verify(snap)
        assert exc.value.blob == "elements/agg.blob"


# ----------------------------------------------- pipeline snapshot path

def _agg_desc():
    return (f'appsrc name=in caps="{CAPS4}" '
            '! tensor_aggregator name=agg frames-out=3 frames-flush=3 '
            'frames-dim=0 ! appsink name=out')


def _push4(pipe, values, pkg=pt):
    for v in values:
        pipe["in"].push_buffer(pkg.Buffer.from_arrays(
            [np.full(4, float(v), np.float32)], pts=int(v)))


def _wait(cond, timeout=10):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert cond()


def _blob(ckpt, name, store=SnapshotStore):
    snap = store(ckpt).latest()
    with open(os.path.join(snap, "elements", f"{name}.blob"), "rb") as f:
        return pickle.loads(f.read())


class TestPipelinePreemptRestore:
    def test_aggregator_window_survives_preemption(self, tmp_path):
        ckpt = str(tmp_path / "ckpt")
        pipe = pt.parse_launch(_agg_desc())
        pipe.start()
        _push4(pipe, [1, 2])  # 2 of the 3-frame window
        _wait(lambda: len(pipe["agg"]._window) == 2)
        report = pipe.preempt(0.5, ckpt)
        assert report["snapshot"] and not report["drained"]

        pipe2 = pt.parse_launch(_agg_desc())
        meta = pipe2.restore(ckpt)
        assert meta["preempt"]["drained"] is False
        pipe2.start()
        _push4(pipe2, [3])  # completes the restored window
        pipe2["in"].end_stream()
        pipe2.wait_eos(10)
        out = pipe2["out"].buffers
        pipe2.stop()
        assert len(out) == 1
        np.testing.assert_array_equal(
            out[0].chunks[0].host(),
            np.repeat([1.0, 2.0, 3.0], 4).astype(np.float32))

    def test_restore_rejects_tampered_snapshot(self, tmp_path):
        ckpt = str(tmp_path / "ckpt")
        pipe = pt.parse_launch(_agg_desc())
        pipe.start()
        _push4(pipe, [1, 2])
        _wait(lambda: len(pipe["agg"]._window) == 2)
        pipe.preempt(0.5, ckpt)
        snap = SnapshotStore(ckpt).latest()
        blob = os.path.join(snap, "elements", "agg.blob")
        raw = bytearray(open(blob, "rb").read())
        raw[-1] ^= 0xFF
        open(blob, "wb").write(bytes(raw))

        pipe2 = pt.parse_launch(_agg_desc())
        with pytest.raises(SnapshotError) as exc:
            pipe2.restore(ckpt)
        assert exc.value.blob == "elements/agg.blob"
        # NO partial restore happened: the window is still empty
        assert not pipe2["agg"]._window

    def test_restore_requires_stopped_pipeline(self, tmp_path):
        ckpt = str(tmp_path / "ckpt")
        pipe = pt.parse_launch(_agg_desc())
        pipe.start()
        _push4(pipe, [1])
        _wait(lambda: len(pipe["agg"]._window) == 1)
        pipe.preempt(0.5, ckpt)
        pipe2 = pt.parse_launch(_agg_desc())
        pipe2.start()
        with pytest.raises(RuntimeError, match="before start"):
            pipe2.restore(ckpt)
        pipe2["in"].end_stream()
        pipe2.stop()

    def test_degraded_preempt_declares_abandoned(self, tmp_path):
        ckpt = str(tmp_path / "ckpt")
        desc = f'appsrc name=in caps="{CAPS4}" ! ckpt_hold_sink name=hold'
        pipe = pt.parse_launch(desc)
        pipe.start()
        _push4(pipe, [1, 2, 3])
        _wait(lambda: pipe["hold"]._held == 3)
        # the src never EOSes: a short grace degrades to
        # snapshot-without-drain, with the in-flight count DECLARED
        report = pipe.preempt(0.4, ckpt)
        assert report["drained"] is False
        assert report["abandoned"] == {"hold": 3}
        assert pipe["hold"].stats["preempt_abandoned"] == 3
        snap = SnapshotStore(ckpt).latest()
        meta = SnapshotStore.verify(snap)["meta"]
        assert meta["preempt"]["abandoned"] == {"hold": 3}

        pipe2 = pt.parse_launch(desc)
        pipe2.restore(ckpt)
        assert pipe2["hold"]._held == 3

    def test_preempt_posts_its_messages(self, tmp_path):
        """The bus carries ``preempt`` then ``preempted`` with the
        report, as the JAX pipeline posts them."""
        pipe = pt.parse_launch(_agg_desc())
        pipe.start()
        pipe.bus.drain()
        report = pipe.preempt(0.2, str(tmp_path / "ckpt"))
        kinds = [m.kind for m in pipe.bus.drain()]
        assert kinds.index("preempt") < kinds.index("preempted")
        assert report["grace_s"] == 0.2 and report["used_s"] >= 0


# ------------------------------------------------ element round trips

def _rate_run(pkg):
    """A 30/1 stream into tensor_rate framerate=10/1, three frames in:
    its schedule and gap-fill frame as the snapshot hook records them."""
    pipe = pkg.parse_launch(
        f'appsrc name=in caps="{CAPS4}" ! tensor_rate name=r '
        "framerate=10/1 throttle=false ! appsink name=out")
    pipe.start()
    rng = np.random.default_rng(5)
    for i in range(3):
        pipe["in"].push_buffer(pkg.Buffer.from_arrays(
            [rng.standard_normal(4).astype(np.float32)],
            pts=i * 33_333_333))
    _wait(lambda: pipe["r"].stats["in"] == 3)
    state = pipe["r"].snapshot_state(None)
    pipe["in"].end_stream()
    pipe.stop()
    return state


def _same_state(a, b):
    """Two snapshot dicts equal, arrays by value and dtype. A buffer's
    ``_obs_ctx`` extra (the JAX package's trace context; the port
    records no spans) is left out of the comparison."""
    if isinstance(a, dict):
        a = {k: v for k, v in a.items() if k != "_obs_ctx"}
        b = {k: v for k, v in b.items() if k != "_obs_ctx"}
        assert sorted(a) == sorted(b)
        for k in a:
            _same_state(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_state(x, y)
    elif isinstance(a, np.ndarray):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


class TestElementRoundTrips:
    def test_tensor_rate_schedule(self, tmp_path):
        a = pt.parse_launch(f'appsrc caps="{CAPS4}" '
                            '! tensor_rate name=r framerate=30/1 ! fakesink')
        r = a["r"]
        r._next_ts = 123456
        r._last_in_pts = 99
        r._throttling = True
        r._prev = pt.Buffer.from_arrays([np.full(4, 7.0, np.float32)])
        state = r.snapshot_state(str(tmp_path))

        b = pt.parse_launch(f'appsrc caps="{CAPS4}" '
                            '! tensor_rate name=r framerate=30/1 ! fakesink')
        r2 = b["r"]
        r2.restore_state(state, str(tmp_path))
        assert r2._next_ts == 123456 and r2._last_in_pts == 99
        assert r2._throttling is True
        np.testing.assert_array_equal(r2._prev.chunks[0].host(),
                                      r._prev.chunks[0].host())

    def test_tensor_rate_state_equals_the_jax_elements(self):
        _same_state(_rate_run(pt), _rate_run(nt))

    def test_aggregator_state_equals_the_jax_elements(self, tmp_path):
        states = []
        for pkg, store in ((pt, SnapshotStore), (nt, NtStore)):
            ckpt = str(tmp_path / pkg.__name__)
            pipe = pkg.parse_launch(_agg_desc())
            pipe.start()
            _push4(pipe, [4, 5], pkg)
            _wait(lambda: len(pipe["agg"]._window) == 2)
            pipe.preempt(0.3, ckpt)
            states.append(_blob(ckpt, "agg", store))
        _same_state(*states)
        assert [d["pts"] for d in states[0]["window"]] == [4, 5]

    def test_repo_slot_queue_and_eos(self, tmp_path):
        from nnstreamer_tpu_torch.elements.repo import GLOBAL_REPO
        try:
            GLOBAL_REPO.push(61, pt.Buffer.from_arrays(
                [np.full(4, 1.0, np.float32)]))
            GLOBAL_REPO.push(61, pt.Buffer.from_arrays(
                [np.full(4, 2.0, np.float32)]))
            GLOBAL_REPO.set_eos(61)
            a = pt.parse_launch(f'appsrc caps="{CAPS4}" '
                                '! tensor_reposink name=rs slot-index=61')
            state = a["rs"].snapshot_state(str(tmp_path))
            b = pt.parse_launch(f'appsrc caps="{CAPS4}" '
                                '! tensor_reposink name=rs slot-index=62')
            b["rs"].restore_state(state, str(tmp_path))
            bufs, eos = GLOBAL_REPO.snapshot_slot(62)
            assert eos and len(bufs) == 2
            np.testing.assert_array_equal(bufs[1].chunks[0].host(),
                                          np.full(4, 2.0, np.float32))
        finally:
            GLOBAL_REPO.restore_slot(61, [], False)
            GLOBAL_REPO.restore_slot(62, [], False)

    def test_repo_state_equals_the_jax_elements(self, tmp_path):
        """The same two frames through ``... ! tensor_reposink`` in each
        package: the slot snapshots are equal."""
        from nnstreamer_tpu.elements.repo import GLOBAL_REPO as NT_REPO
        from nnstreamer_tpu_torch.elements.repo import GLOBAL_REPO
        states = []
        for pkg, repo in ((pt, GLOBAL_REPO), (nt, NT_REPO)):
            pipe = pkg.parse_launch(f'appsrc name=in caps="{CAPS4}" '
                                    '! tensor_reposink name=rs '
                                    'slot-index=63')
            try:
                pipe.start()
                _push4(pipe, [6, 7], pkg)
                pipe["in"].end_stream()
                pipe.wait_eos(10)
                states.append(pipe["rs"].snapshot_state(str(tmp_path)))
                pipe.stop()
            finally:
                repo.restore_slot(63, [], False)
        _same_state(*states)
        assert states[0]["eos"] is True and len(states[0]["queue"]) == 2

    def test_repo_cycle_carries_frames_back_to_the_source(self):
        """tensor_reposink ! ... tensor_reposrc: the frames the sink
        renders come out of the source of the same slot in order."""
        from nnstreamer_tpu_torch.elements.repo import GLOBAL_REPO
        try:
            sink = pt.parse_launch(f'appsrc name=in caps="{CAPS4}" '
                                   '! tensor_reposink slot-index=64')
            src = pt.parse_launch(f'tensor_reposrc slot-index=64 '
                                  f'caps="{CAPS4}" ! appsink name=out')
            src.start()
            sink.start()
            _push4(sink, [1, 2, 3])
            sink["in"].end_stream()
            assert src.wait_eos(10)
            got = [float(b.chunks[0].host()[0]) for b in src["out"].buffers]
            sink.stop()
            src.stop()
            assert got == [1.0, 2.0, 3.0]
        finally:
            GLOBAL_REPO.restore_slot(64, [], False)

    def test_edge_replay_ring(self):
        from nnstreamer_tpu_torch.edge.session import ReplayRing
        ring = ReplayRing(budget_bytes=1 << 20)
        for seq in (4, 5, 6):
            ring.append(seq, pt.Buffer.from_arrays(
                [np.full(4, float(seq), np.float32)]))
        frames, evicted = ring.dump()
        ring2 = ReplayRing(budget_bytes=1 << 20)
        ring2.load(frames, evicted)
        assert len(ring2) == 3
        frames2, evicted2 = ring2.dump()
        assert [s for s, _ in frames2] == [4, 5, 6]
        assert evicted2 == evicted

    def test_edge_ring_dump_equals_the_jax_rings(self):
        """The same appends under a budget that evicts: the same
        retained seqs, bytes and eviction watermark in both packages."""
        from nnstreamer_tpu.edge.session import ReplayRing as NtRing
        from nnstreamer_tpu_torch.edge.session import ReplayRing
        dumps = []
        for ring_cls, pkg in ((ReplayRing, pt), (NtRing, nt)):
            ring = ring_cls(budget_bytes=40)
            for seq in range(1, 6):
                ring.append(seq, pkg.Buffer.from_arrays(
                    [np.full(4, float(seq), np.float32)]))
            frames, evicted = ring.dump()
            dumps.append(([s for s, _ in frames], evicted, ring.nbytes))
        assert dumps[0] == dumps[1] == ([4, 5], 3, 32)

    def test_edge_session_state_round_trips_and_resumes(self):
        """A session edgesink and its edgesrc: the edgesink's snapshot
        holds the seq space, the unacked ring and the session's acked
        watermark, the edgesrc's its session id and delivery watermark;
        restored into fresh elements, the edgesrc presents the watermark
        on its first RESUME and the restored publisher replays exactly
        the frames it missed."""
        def publisher(port):
            return pt.parse_launch(
                f'appsrc name=in caps="{CAPS4}" ! edgesink name=p '
                f"port={port} topic=t session=true")

        def subscriber(port):
            return pt.parse_launch(
                f"edgesrc name=s dest-port={port} topic=t session=true "
                "ack-every=1 timeout=15 ! appsink name=out")

        port = _free_port()
        pub, sub = publisher(port), subscriber(port)
        pub.start()
        sub.start()
        _wait(lambda: pub["p"].session_info().get("sessions") == 1)
        _push4(pub, [1, 2, 3])
        _wait(lambda: len(sub["out"].buffers) == 3)
        _wait(lambda: len(pub["p"]._ring) == 0)  # every frame acked
        sub_state = sub["s"].snapshot_state(None)
        sub.stop()
        _push4(pub, [4, 5])  # the subscriber's process-death gap
        _wait(lambda: pub["p"].stats["session_sent"] == 5)
        pub_state = pub["p"].snapshot_state(None)
        pub["in"].end_stream()
        pub.stop()
        assert sub_state == {"sid": sub_state["sid"], "last": 3}
        assert pub_state["next_seq"] == 5
        assert list(pub_state["sessions"]) == [sub_state["sid"]]
        assert [s for s, _ in pub_state["ring"]] == [4, 5]
        assert [float(d["arrays"][0][0]) for _, d in pub_state["ring"]] \
            == [4.0, 5.0]

        # the restarted pair listens on a fresh port: the first
        # publisher's may still be held by the kernel
        port = _free_port()
        pub2, sub2 = publisher(port), subscriber(port)
        pub2["p"].restore_state(pub_state, None)
        sub2["s"].restore_state(sub_state, None)
        pub2.start()
        sub2.start()
        try:
            _wait(lambda: len(sub2["out"].buffers) == 2)
            _push4(pub2, [6])
            _wait(lambda: len(sub2["out"].buffers) == 3)
            got = [float(b.chunks[0].host()[0])
                   for b in sub2["out"].buffers]
            lost = sub2["s"].stats["session_declared_lost"]
        finally:
            sub2.stop()
            pub2["in"].end_stream()
            pub2.stop()
        assert got == [4.0, 5.0, 6.0] and lost == 0

    def test_edgesink_state_equals_the_jax_elements(self):
        """The same stream through an edgesink of each package, one port
        session subscriber that leaves after three acked frames, two
        more frames into its gap: the publishers' snapshots are equal
        (seq space, eviction watermark, the session's acked watermark
        and resume count, the retained frames), bar the session id each
        subscriber minted."""
        states = []
        for pkg in (pt, nt):
            port = _free_port()
            pub = pkg.parse_launch(
                f'appsrc name=in caps="{CAPS4}" ! edgesink name=p '
                f"port={port} topic=t session=true")
            sub = pt.parse_launch(
                f"edgesrc name=s dest-port={port} topic=t session=true "
                "ack-every=1 timeout=15 ! appsink name=out")
            pub.start()
            sub.start()
            try:
                _wait(lambda: pub["p"].session_info().get("sessions") == 1)
                _push4(pub, [1, 2, 3], pkg)
                _wait(lambda: len(sub["out"].buffers) == 3)
                _wait(lambda: len(pub["p"]._ring) == 0)
                sid = sub["s"].snapshot_state(None)["sid"]
                sub.stop()
                _push4(pub, [4, 5], pkg)
                _wait(lambda: pub["p"].stats["session_sent"] == 5)
                state = pub["p"].snapshot_state(None)
            finally:
                sub.stop()
                pub["in"].end_stream()
                pub.stop()
            state["sessions"] = {"sub" if k == sid else k: v
                                 for k, v in state["sessions"].items()}
            states.append(state)
        _same_state(*states)
        assert states[0]["sessions"] == {"sub": {"acked": 3, "resumes": 0}}

    def test_serve_src_ledger_declared_on_restart(self, tmp_path):
        desc = (f"tensor_serve_src name=src port={_free_port()} id=9 "
                "buckets=1,2,4 max-wait-ms=2 "
                "! tensor_filter framework=custom-easy model=ckpt_double "
                "! tensor_serve_sink id=9")
        state = {"ledger": [{"stream": "s1", "seq": 3, "pts": 30}],
                 "sessions": ["s1"]}
        pipe = pt.parse_launch(desc)
        src = pipe["src"]
        src.restore_state(state, str(tmp_path))
        # restored-but-never-started: the state re-emits unchanged
        assert src.snapshot_state(str(tmp_path)) == state
        pipe.start()
        try:
            assert src.scheduler.recovered_ledger == state["ledger"]
            assert src.scheduler.stats["recovered_pending"] == 1
        finally:
            pipe.stop()

    def test_serve_ledger_equals_the_jax_batchers(self):
        """The same admissions, unbatched: the pending ledgers (what a
        preemption records and declares) are equal."""
        from nnstreamer_tpu.serve.batcher import BucketBatcher as NtBatcher
        from nnstreamer_tpu_torch.serve.batcher import BucketBatcher
        ledgers = []
        for cls in (BucketBatcher, NtBatcher):
            b = cls([1, 2, 4], max_wait_s=1.0, max_queue=8)
            for i, stream in enumerate(["a", "b", "a"]):
                b.submit(_request(cls, stream, i))
            ledgers.append(b.ledger())
        assert ledgers[0] == ledgers[1] == [
            {"stream": "a", "seq": 0, "pts": 0},
            {"stream": "b", "seq": 1, "pts": 10},
            {"stream": "a", "seq": 2, "pts": 20}]

    def test_filter_state_reemits_when_never_started(self):
        """tensor_filter delegates its snapshot to the backend; restored
        and never started, it re-emits what it was given, as the JAX
        element does."""
        pipe = pt.parse_launch(
            f'appsrc caps="{CAPS4}" ! tensor_filter name=f '
            "framework=custom-easy model=ckpt_double ! fakesink")
        assert pipe["f"].snapshot_state(None) is None
        pipe["f"].restore_state({"k": 1}, "/nowhere")
        assert pipe["f"].snapshot_state(None) == {"k": 1}


def _request(cls, stream, i):
    mod = sys.modules[cls.__module__]
    return mod.Request(stream, [np.full(4, float(i), np.float32)], seq=i,
                       pts=10 * i)


# ------------------------------------------------------------ pipelint

class TestStatefulNoCheckpointRule:
    def _findings(self, desc):
        _jax_test_elements()
        report = analyze(pt.parse_launch(desc))
        got = [f for f in report.findings
               if f.rule == "stateful-no-checkpoint"]
        want = [f for f in nt_analyze(nt.parse_launch(desc)).findings
                if f.rule == "stateful-no-checkpoint"]
        assert [(f.element, f.severity.name) for f in got] == \
            [(f.element, f.severity.name) for f in want]
        return got

    def test_warns_on_restart_unsafe_without_hook(self):
        got = self._findings(  # pipelint: skip — seeded missing hook
            f'appsrc caps="{CAPS4}" ! ckpt_amnesiac_sink name=x')
        assert len(got) == 1
        assert got[0].severity is Severity.WARNING
        assert got[0].element == "x"

    def test_clean_when_hook_present(self):
        # tensor_rate and tensor_aggregator declare RESTART_SAFE=False
        # but implement snapshot_state: no finding
        assert not self._findings(
            f'appsrc caps="{CAPS4}" ! tensor_rate framerate=30/1 '
            '! tensor_aggregator frames-out=2 ! fakesink')

    def test_trainer_line_is_clean(self):
        assert not self._findings(
            "datareposrc location=x.data json=x.json ! tensor_trainer "
            "name=t ! fakesink")


# ------------------------------------------------------ trainer resume

def _write_dataset(tmp_path, n=16, in_dim=8, classes=4):
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(n, in_dim)).astype(np.float32)
    ys = np.zeros((n, classes), np.float32)
    labels = rng.integers(0, classes, n)
    ys[np.arange(n), labels] = 1.0
    xs += labels[:, None] * 2.0
    data = tmp_path / "train.data"
    with open(data, "wb") as f:
        for x, y in zip(xs, ys):
            f.write(x.tobytes() + y.tobytes())
    index = {
        "gst_caps": ("other/tensors, format=(string)static, "
                     "framerate=(fraction)0/1, num_tensors=(int)2, "
                     f"dimensions=(string){in_dim}.{classes}, "
                     "types=(string)float32.float32"),
        "total_samples": n,
        "sample_size": (in_dim + classes) * 4,
    }
    jpath = tmp_path / "train.json"
    jpath.write_text(json.dumps(index))
    return data, jpath


def _trainer_desc(data, jpath, src_epochs, total_epochs, n=16,
                  framework="torch-cuda accelerator=true:cpu"):
    return (f'datareposrc location={data} json={jpath} is-shuffle=false '
            f'epochs={src_epochs} '
            f'! tensor_trainer name=t framework={framework} '
            'model-config="zoo://mlp?in_dim=8&hidden=16&out_dim=4&lr=0.05" '
            f'num-training-samples={n} epochs={total_epochs} '
            'num-inputs=1 num-labels=1 ! appsink name=out')


class TestTrainerResume:
    def test_resumes_at_exact_epoch(self, tmp_path):
        """Train 3 epochs, snapshot, restore into a 6-epoch run: the
        second run must train EXACTLY epochs 4..6 — no epoch repeated,
        none skipped."""
        data, jpath = _write_dataset(tmp_path)
        ckpt = str(tmp_path / "ckpt")
        pipe = pt.parse_launch(_trainer_desc(data, jpath, 3, 3))
        pipe.start()
        pipe.wait_eos(120)
        report = pipe.preempt(2.0, ckpt)
        assert report["drained"] is True
        state = _blob(ckpt, "t")
        assert state["epoch"] == 3

        pipe2 = pt.parse_launch(_trainer_desc(data, jpath, 3, 6))
        pipe2.restore(ckpt)
        pipe2.start()
        pipe2.wait_eos(120)
        stats = pipe2["out"].buffers
        pipe2.stop()
        epochs = [int(b.pts) for b in stats]
        assert epochs[0] == 4          # resumed AFTER the recorded step
        assert sorted(set(epochs)) == [4, 5, 6]
        assert epochs[-1] == 6         # ran to the new horizon

    def test_resumed_run_equals_the_straight_run(self, tmp_path):
        """Epochs 4-6 after a restore equal a straight 6-epoch run's,
        bitwise on the CPU: the params, the Adam moments and the step
        counts come back exactly."""
        data, jpath = _write_dataset(tmp_path)
        straight = pt.parse_launch(_trainer_desc(data, jpath, 6, 6))
        straight.run(timeout=120)
        want = {int(b.pts): b.chunks[0].host()
                for b in straight["out"].buffers}
        ckpt = str(tmp_path / "ckpt")
        first = pt.parse_launch(_trainer_desc(data, jpath, 3, 3))
        first.start()
        first.wait_eos(120)
        first.preempt(2.0, ckpt)
        second = pt.parse_launch(_trainer_desc(data, jpath, 3, 6))
        second.restore(ckpt)
        second.run(timeout=120)
        for b in second["out"].buffers:
            np.testing.assert_array_equal(b.chunks[0].host(),
                                          want[int(b.pts)])

    def test_snapshot_of_a_restored_never_started_trainer(self, tmp_path):
        """A restored pipeline snapshotted before start re-emits the
        trainer's state and its params file (the JAX element's
        behaviour)."""
        data, jpath = _write_dataset(tmp_path)
        ckpt = str(tmp_path / "ckpt")
        pipe = pt.parse_launch(_trainer_desc(data, jpath, 2, 2))
        pipe.start()
        pipe.wait_eos(120)
        pipe.preempt(2.0, ckpt)
        pipe2 = pt.parse_launch(_trainer_desc(data, jpath, 2, 4))
        pipe2.restore(ckpt)
        again = pipe2.snapshot(str(tmp_path / "again"))
        manifest = SnapshotStore.verify(again)
        assert "elements/t.d/params/params" in manifest["files"]
        assert _blob(str(tmp_path / "again"), "t")["epoch"] == 2


# ------------------------------------------------- chaos (SIGTERM)

def _spawn_py(code):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _read_until(proc, token, count=1, timeout=120):
    """Read child stdout lines until ``token`` appeared ``count`` times;
    returns all lines read."""
    lines = []
    seen = 0
    deadline = time.monotonic() + timeout

    def reader():
        nonlocal seen
        for line in proc.stdout:
            lines.append(line.rstrip("\n"))
            if token in line:
                seen += 1
                if seen >= count:
                    return

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    while t.is_alive() and time.monotonic() < deadline:
        if proc.poll() is not None and seen < count:
            t.join(timeout=1)
            break
        time.sleep(0.05)
    assert seen >= count, \
        f"never saw {count}x {token!r} (exit={proc.poll()}): {lines[-20:]}"
    return lines


def _stop(proc):
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)


class TestPreemptChaos:
    def test_sigterm_mid_training_resumes_exact_step(self, tmp_path):
        """kill -TERM a training process mid-run; the restarted process
        resumes at the exact recorded epoch — every epoch across the two
        lives trains exactly once. Each epoch of the child waits 50 ms
        for its samples (a paced source), so the kill lands mid-run."""
        total = 80
        data, jpath = _write_dataset(tmp_path)
        ckpt = str(tmp_path / "ckpt")
        desc = _trainer_desc(data, jpath, total, total)
        code = (
            "import time\n"
            "from nnstreamer_tpu_torch import parse_launch\n"
            "from nnstreamer_tpu_torch.checkpoint import install_sigterm\n"
            f"pipe = parse_launch({desc!r})\n"
            "src = pipe['datareposrc0'] if 'datareposrc0' in pipe.elements"
            " else [e for e in pipe.elements.values()"
            " if type(e).__name__ == 'DataRepoSrc'][0]\n"
            "create = src.create\n"
            "def paced():\n"
            "    time.sleep(0.05 / 16)\n"
            "    return create()\n"
            "src.create = paced\n"
            f"install_sigterm(pipe, {ckpt!r}, grace_s=2.0, exit_code=0)\n"
            "pipe.start()\n"
            "seen = 0\n"
            "deadline = time.monotonic() + 300\n"
            "while time.monotonic() < deadline:\n"
            "    n = len(pipe['out'].buffers)\n"
            "    while seen < n:\n"
            "        seen += 1\n"
            "        print('epoch-frame', seen, flush=True)\n"
            "    time.sleep(0.005)\n")
        proc = _spawn_py(code)
        try:
            _read_until(proc, "epoch-frame", count=5, timeout=240)
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=60) == 0  # clean preempted exit
        finally:
            _stop(proc)

        snap = SnapshotStore(ckpt).latest()
        assert snap is not None
        k = _blob(ckpt, "t")["epoch"]
        assert 1 <= k < total, f"kill landed outside the run: epoch {k}"

        # restart: feed exactly the REMAINING passes over the data and
        # resume from the snapshot
        pipe = pt.parse_launch(_trainer_desc(data, jpath, total - k, total))
        pipe.restore(ckpt)
        pipe.start()
        pipe.wait_eos(300)
        stats = pipe["out"].buffers
        pipe.stop()
        epochs = [int(b.pts) for b in stats]
        # exactness: the second life trains epochs k+1..total, each
        # exactly once — no repeated and no skipped optimizer updates
        assert epochs[0] == k + 1
        assert sorted(set(epochs)) == list(range(k + 1, total + 1))
        assert epochs[-1] == total
