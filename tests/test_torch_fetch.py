"""The port's coalescing D2H fetch service (tensors/transfer.py, with
its compat façade tensors/fetch.py) on the CPU.

Mirrors tests/test_fetch.py (wrap, resolve, pass-through, mixed frames,
coalescing, stats, per-frame error isolation, Chunk integration,
concurrent resolvers) and InFlightWindow's contract from
tests/test_async.py. ``submit_fetch`` wraps only CUDA tensors; where the
JAX tests fetch CPU ``jax.Array``s, these drive the ``_Downloader``
directly with CPU tensors (``_wrap``). The CUDA copy path (copy stream,
pinned buffers, producer events) is tested on the card in
tests/test_torch_cuda.py.
"""
import threading
import time

import numpy as np
import pytest
import torch

from nnstreamer_tpu_torch.tensors import fetch as F
from nnstreamer_tpu_torch.tensors import transfer as T
from nnstreamer_tpu_torch.tensors.buffer import Buffer, Chunk

BASE = np.arange(12, dtype=np.float32).reshape(3, 4)


def _wrap(tensors):
    """What submit_fetch does for CUDA tensors, for CPU ones: one ticket
    for the frame, submitted to the downloader, one PendingHost each."""
    ticket = F._Ticket(list(tensors))
    F._downloader.submit(ticket)
    return [F.PendingHost(ticket, i, t) for i, t in enumerate(tensors)]


@pytest.fixture
def dev_tensors():
    x = torch.from_numpy(BASE.copy())
    return [x * 2.0, x * 3.0]


class TestSubmitFetch:
    def test_wraps_tensors(self, dev_tensors):
        outs = _wrap(dev_tensors)
        assert all(isinstance(o, F.PendingHost) for o in outs)
        # shape/dtype known without resolving
        assert outs[0].shape == (3, 4)
        assert outs[0].dtype == torch.float32
        assert outs[0].ndim == 2

    def test_resolve_values(self, dev_tensors):
        outs = _wrap(dev_tensors)
        a, b = F.resolve(outs[0]), F.resolve(outs[1])
        np.testing.assert_allclose(a, BASE * 2.0)
        np.testing.assert_allclose(b, BASE * 3.0)
        assert isinstance(a, np.ndarray)

    def test_resolved_copy_is_not_the_source(self, dev_tensors):
        out = F.resolve(_wrap(dev_tensors)[0])
        dev_tensors[0].zero_()
        np.testing.assert_allclose(out, BASE * 2.0)

    def test_bfloat16_resolves_to_cpu_tensor(self):
        src = torch.arange(5, dtype=torch.bfloat16)
        out = F.resolve(_wrap([src])[0])
        assert isinstance(out, torch.Tensor) and out.dtype == torch.bfloat16
        assert torch.equal(out, src)

    @pytest.mark.parametrize("host", [
        np.ones((2, 2), np.float32), torch.ones(2, 2),
        torch.ones(3, dtype=torch.bfloat16), b"\x00\x01"])
    def test_host_data_and_cpu_tensors_pass_through(self, host):
        outs = F.submit_fetch([host])
        assert outs[0] is host

    def test_mixed_host_and_pending(self, dev_tensors):
        host = np.zeros((5,), np.int32)
        ticket = F._Ticket([dev_tensors[0], dev_tensors[1]])
        F._downloader.submit(ticket)
        outs = [F.PendingHost(ticket, 0, dev_tensors[0]), host,
                F.PendingHost(ticket, 1, dev_tensors[1])]
        assert outs[1] is host
        np.testing.assert_allclose(F.resolve(outs[2]), BASE * 3.0)
        np.testing.assert_allclose(F.resolve(outs[0]), BASE * 2.0)

    def test_resolve_identity_on_plain_values(self):
        x = np.ones(3)
        assert F.resolve(x) is x

    def test_many_frames_coalesce(self):
        """Frames submitted while a fetch RPC is in flight share the
        next one; all must land with their own values."""
        pending = [_wrap([torch.full((4,), float(i))]) for i in range(64)]
        for i, outs in enumerate(pending):
            np.testing.assert_allclose(F.resolve(outs[0]),
                                       np.full((4,), float(i)))

    def test_fetch_stats_report_achieved_depth(self, monkeypatch):
        """With a slow link (the copy batch stalled), frames queued
        behind the in-flight RPC share the NEXT one — frames_per_rpc_avg
        > 1 — and the counters add up."""
        real_rpc = F._downloader._rpc
        gate = threading.Event()

        def slow_rpc(tickets, flat):
            gate.wait(5.0)  # hold the first RPC until all frames queue
            return real_rpc(tickets, flat)

        monkeypatch.setattr(F._downloader, "_rpc", slow_rpc)
        F.fetch_stats(reset=True)
        pending = [_wrap([torch.full((4,), float(i))]) for i in range(16)]
        gate.set()
        for i, outs in enumerate(pending):
            np.testing.assert_allclose(F.resolve(outs[0]),
                                       np.full((4,), float(i)))
        stats = F.fetch_stats()
        assert stats["frames"] == 16
        assert stats["arrays"] == 16
        assert stats["rpcs"] < 16
        assert stats["frames_per_rpc_avg"] > 1.0

    def test_facade_reexports_transfer(self):
        assert F.submit_fetch is T.submit_fetch
        assert F.PendingHost is T.PendingHost
        assert F._coalescer is T._downloader


class TestChunkIntegration:
    def test_chunk_resolves_transparently(self, dev_tensors):
        outs = _wrap(dev_tensors)
        c = Chunk(outs[0])
        # shape and dtype visible without blocking
        assert c.shape == (3, 4)
        assert c.dtype == torch.float32
        assert str(c.type) == "float32"
        assert c.nbytes == 48
        h = c.host()
        assert isinstance(h, np.ndarray)
        np.testing.assert_allclose(h, BASE * 2.0)
        # resolution is cached: raw now returns the same ndarray
        assert c.raw is h
        assert not c.is_device

    def test_pending_chunk_keeps_device_residency(self):
        """Until the fetch lands, a pending chunk still behaves as
        device-resident: is_device True, raw/device() return the live
        tensor with no blocking."""
        dev = torch.from_numpy(BASE.copy())
        ticket = F._Ticket([dev])  # not submitted: stays pending
        c = Chunk(F.PendingHost(ticket, 0, dev))
        assert c.is_device
        assert c.raw is dev
        assert c.device("cpu") is dev
        # fetch lands -> settles to the fetched host copy
        ticket._deliver([dev.numpy().copy()])
        assert not c.is_device
        h = c.host()
        assert isinstance(h, np.ndarray)
        np.testing.assert_allclose(h, BASE)

    def test_error_isolated_per_frame(self, dev_tensors):
        """A poisoned array fails only its own frame's ticket; frames
        sharing the coalesced RPC still resolve (per-ticket retry)."""
        class Boom:
            shape, dtype, ndim = (2,), np.float32, 1

            def __array__(self, *a, **k):
                raise RuntimeError("poisoned output")

        good = _wrap([dev_tensors[0]])
        bad_ticket = F._Ticket([Boom()])
        F._coalescer.submit(bad_ticket)
        also_good = _wrap([dev_tensors[1]])
        np.testing.assert_allclose(F.resolve(good[0]), BASE * 2.0)
        np.testing.assert_allclose(F.resolve(also_good[0]), BASE * 3.0)
        with pytest.raises(RuntimeError, match="poisoned"):
            bad_ticket.wait()

    def test_repeated_error_reaches_every_ticket(self, monkeypatch):
        """An error every copy raises (a sticky CUDA error poisons the
        context) is re-raised on retry and reaches each frame; none
        resolves to a value."""
        def sticky(tickets, flat):
            raise RuntimeError("CUDA error: an illegal memory access")

        monkeypatch.setattr(F._downloader, "_rpc", sticky)
        pending = [_wrap([torch.ones(2)]) for _ in range(4)]
        for outs in pending:
            with pytest.raises(RuntimeError, match="illegal memory"):
                F.resolve(outs[0])

    def test_buffer_arrays_resolve(self, dev_tensors):
        buf = Buffer.from_arrays(_wrap(dev_tensors))
        # arrays() never blocks: each entry is either the fetched host
        # copy or the still-live tensor, both directly usable
        arrs = buf.arrays()
        assert all(isinstance(a, (np.ndarray, torch.Tensor)) for a in arrs)
        # host_arrays() is the blocking host boundary
        harrs = buf.host_arrays()
        assert all(isinstance(a, np.ndarray) for a in harrs)
        np.testing.assert_allclose(harrs[0], BASE * 2.0)

    def test_concurrent_resolvers(self, dev_tensors):
        """Many threads blocking on the same ticket all wake correctly."""
        outs = _wrap(dev_tensors)
        results, errs = [], []

        def worker():
            try:
                results.append(F.resolve(outs[0]).sum())
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        ths = [threading.Thread(target=worker) for _ in range(8)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in ths)
        assert not errs
        assert results == [pytest.approx(float((BASE * 2.0).sum()))] * 8


class TestUpload:
    def test_uploads_coalesce_under_link_latency(self):
        T.transfer_stats(reset=True)
        T.set_simulated_rtt_ms(40.0)
        try:
            pending = [T.submit_upload([np.full(4, i, np.float32)], "cpu")
                       for i in range(6)]
            outs = [[T.resolve(x) for x in batch] for batch in pending]
        finally:
            T.set_simulated_rtt_ms(0.0)
        for i, batch in enumerate(outs):
            assert isinstance(batch[0], torch.Tensor)
            np.testing.assert_array_equal(batch[0].numpy(),
                                          np.full(4, i, np.float32))
        st = T.transfer_stats(reset=True)["upload"]
        assert st["rpcs"] >= 1
        assert st["frames_per_rpc_avg"] > 1.0

    def test_download_and_upload_accounted_separately(self):
        T.transfer_stats(reset=True)
        up = T.submit_upload([np.arange(8, dtype=np.float32)], "cpu")
        assert isinstance(up[0], T.PendingDevice)
        arr = T.resolve(up[0])
        down = _wrap([arr])
        np.testing.assert_array_equal(T.resolve(down[0]),
                                      np.arange(8, dtype=np.float32))
        st = T.transfer_stats(reset=True)
        assert st["upload"]["frames"] >= 1
        assert st["download"]["frames"] >= 1


class TestInFlightWindow:
    def test_backpressure_blocks_at_limit(self):
        w = T.InFlightWindow(2)
        t1 = w.acquire()
        t2 = w.acquire()
        assert t1 is not None and t2 is not None
        assert w.acquire(timeout=0.05) is None  # full: caller blocks
        w.release(t1)
        t3 = w.acquire(timeout=1.0)
        assert t3 is not None
        w.release(t2)
        w.release(t3)
        assert w.idle()
        assert w.wait_idle(timeout=1.0)

    def test_report_tracks_occupancy_and_overlap(self):
        w = T.InFlightWindow(4)
        ts = [w.acquire() for _ in range(3)]
        time.sleep(0.02)
        for t in ts:
            w.release(t)
        rep = w.report()
        assert rep["window"] == 4
        assert rep["in_flight_peak"] == 3
        assert rep["in_flight"] == 0
        # 3 frames in flight for the whole span -> ratio ~3
        assert rep["overlap_ratio"] > 1.5

    def test_blocked_acquire_wakes_on_release(self):
        w = T.InFlightWindow(1)
        t0 = w.acquire()
        got = []
        th = threading.Thread(target=lambda: got.append(w.acquire(5.0)))
        th.start()
        time.sleep(0.05)
        w.release(t0)
        th.join(timeout=5)
        assert not th.is_alive()
        assert got and got[0] is not None
        w.release(got[0])
        assert w.report()["blocked_ms"] > 0


def test_coalescer_waits_idle_for_a_batch_in_flight():
    """``wait_idle`` (what the exit hook waits on) returns only once the
    queue is empty and the batch being copied was delivered; the first
    coalescer thread registers the exit hook."""
    import threading

    from nnstreamer_tpu_torch.tensors import transfer

    release, entered = threading.Event(), threading.Event()

    class Held(transfer._Coalescer):
        THREAD_NAME = "test-held"

        def _rpc(self, tickets, flat):
            entered.set()
            assert release.wait(10)
            return list(flat)

    c = Held()
    assert c.wait_idle(0.01)
    ticket = transfer._Ticket([np.ones(3, np.float32)])
    c.submit(ticket)
    assert entered.wait(10)
    assert not c.wait_idle(0.05)          # the batch is in flight
    release.set()
    assert c.wait_idle(10)
    np.testing.assert_array_equal(ticket.wait(), [np.ones(3, np.float32)])
    assert transfer._exit_hook_registered
