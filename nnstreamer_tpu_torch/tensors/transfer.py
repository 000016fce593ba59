"""Bidirectional coalescing host<->device transfer service.

Port of ``nnstreamer_tpu/tensors/transfer.py`` (the one-way fetcher's
historical façade is :mod:`.fetch`). The contracts are the JAX
package's; the device layer is CUDA:

  * **download** — frames enqueue their CUDA outputs with
    :func:`submit_fetch` and leave immediately carrying
    :class:`PendingHost` handles; one fetcher thread drains everything
    queued into one batch of copies per RPC: each tensor into a pinned
    host buffer (``non_blocking=True``) on a dedicated copy stream, then
    one wait on an event recorded after the last copy, then delivery.
    Results are numpy arrays, except bfloat16, which numpy lacks: that
    resolves to a CPU ``torch.Tensor``, as :meth:`..buffer.Chunk.host`
    returns it.
  * **upload** — the symmetric H2D side: :func:`submit_upload` enqueues
    host arrays for a device and returns :class:`PendingDevice`
    handles; one uploader thread drains everything queued per target
    device. Nothing on the port's pipeline path calls it yet.
  * **in-flight window** — :class:`InFlightWindow`, the per-link bound
    on frames between dispatch and completion (``acquire`` blocks the
    dispatching chain thread when the window is full). Nothing on the
    port's pipeline path calls it yet.

Three hazards of the CUDA download, and what the code does about each:

1. Stream order. :func:`submit_fetch` runs on the chain thread right
   after the invoke was enqueued. It records a CUDA event on the
   producer's current stream and stores it in the ticket; the copy
   stream waits on that event before it copies, so a copy never reads an
   output the model has not yet written.
2. Allocator reuse. The output tensor is read on the copy stream. Its
   :class:`PendingHost` keeps it referenced (``dev``, dropped at first
   resolution), and the copy marks it with ``record_stream`` so the
   caching allocator does not hand its memory out again before the copy
   has run.
3. Errors. A failure raised by one batch is retried ticket by ticket,
   so a Python-level fault in one frame fails only that frame. A sticky
   CUDA error poisons the context: every retry raises it again and each
   frame's ticket carries it; nothing is hidden.

Why coalescing: frames queued while a copy batch is in flight share the
next one, and one event wait per batch replaces one synchronize per
frame. The adaptive Nagle-style linger below lets stragglers join without
delaying a lone frame by more than 5% of the measured RPC time.

``transfer_stats()`` reports both directions; ``fetch_stats()`` keeps
the historical download-only contract.

Process exit: the coalescer threads are daemons, and a daemon thread
still inside a torch call when the interpreter finalizes aborts the
process ("terminate called without an active exception"). A program
that exits right after its last frame (``python -m
nnstreamer_tpu_torch``) can leave the last frames' copies in flight, so
the first coalescer thread to start registers an ``atexit`` hook that
waits, up to ``EXIT_WAIT_S``, for both coalescers to go idle.
"""
from __future__ import annotations

import atexit
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..utils import flowmarks as flow

# cap on arrays per RPC so one giant drain can't add unbounded latency
# to the frames queued behind it
_MAX_ARRAYS_PER_RPC = 256

# test/bench hook: added per-RPC latency (seconds) simulating link
# weather. Applied inside the transfer threads only — never on a chain
# thread — so it models the link, not the host. 0.0 = off.
_sim_rtt_s = 0.0
# longest wait at process exit for the transfers in flight to land
EXIT_WAIT_S = 30.0
_exit_hook_registered = False


def set_simulated_rtt_ms(ms: float) -> None:
    """Inject ``ms`` of artificial round-trip latency into every
    transfer RPC (both directions). Bench/test knob for reproducing
    link weather; production leaves it at 0."""
    global _sim_rtt_s
    _sim_rtt_s = max(0.0, float(ms)) / 1e3


def is_device_tensor(x) -> bool:
    """True for a tensor that lives on the card."""
    return isinstance(x, torch.Tensor) and x.device.type == "cuda"


def _host_value(x: Any) -> Any:
    """A host copy in the port's host convention: numpy, or a CPU
    tensor for bfloat16."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.device.type != "cpu":
            x = x.cpu()
        return x if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x)


class _Ticket:
    """One frame's transfer: a list of arrays -> their counterparts on
    the other side of the link. ``ready`` maps each CUDA device of a
    download to the event recorded on its producer stream at submit."""

    __slots__ = ("arrays", "results", "error", "device", "ready", "_evt")

    def __init__(self, arrays: List[Any], device: Any = None,
                 ready: Optional[Dict[torch.device, Any]] = None):
        self.arrays: Optional[List[Any]] = arrays
        self.results: Optional[List[Any]] = None
        self.error: Optional[BaseException] = None
        self.device = device           # upload target; None for download
        self.ready = ready
        self._evt = threading.Event()

    @property
    def done(self) -> bool:
        return self._evt.is_set()

    def _deliver(self, results: Optional[List[Any]],
                 error: Optional[BaseException] = None) -> None:
        self.results = results
        self.error = error
        self.arrays = None  # the transfer thread's refs go; buffer
        self.ready = None   # lifetime is now governed by the handles
        self._evt.set()

    def wait(self) -> List[Any]:
        self._evt.wait()
        if self.error is not None:
            raise self.error
        if self.results is None:
            raise RuntimeError("transfer ticket delivered no results")
        return self.results


class _Coalescer:
    """One direction of the link: a queue of tickets drained by a
    single daemon thread, one batched RPC per drain. Subclasses name
    the thread and provide :meth:`_rpc`."""

    THREAD_NAME = "nns-transfer"

    def __init__(self):
        self._q: List[_Ticket] = []
        self._cv = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        # a grabbed batch is being copied and delivered (under _cv)
        self._busy = False
        # achieved-depth accounting: frames (tickets) per RPC is THE
        # number that says whether the service actually amortizes the
        # link round trip (1.0 = degenerated to frame-at-a-time)
        self._stats = {"rpcs": 0, "frames": 0, "arrays": 0}

    # direction-specific batched transfer; raises to trigger the
    # per-ticket retry isolation in _run
    def _rpc(self, tickets: List[_Ticket], flat: List[Any]) -> List[Any]:
        raise NotImplementedError

    def stats(self, reset: bool = False) -> dict:
        with self._cv:
            out = dict(self._stats)
            if reset:
                self._stats.update(rpcs=0, frames=0, arrays=0)
        out["frames_per_rpc_avg"] = (
            out["frames"] / out["rpcs"] if out["rpcs"] else 0.0)
        return out

    def _account(self, n_tickets: int, n_arrays: int) -> None:
        with self._cv:
            self._stats["rpcs"] += 1
            self._stats["frames"] += n_tickets
            self._stats["arrays"] += n_arrays

    def _ensure_thread(self) -> None:
        global _exit_hook_registered
        if self._thread is None or not self._thread.is_alive():
            if not _exit_hook_registered:
                atexit.register(_quiesce_at_exit)
                _exit_hook_registered = True
            self._thread = threading.Thread(
                target=self._run, name=self.THREAD_NAME, daemon=True)
            self._thread.start()

    def wait_idle(self, timeout: float) -> bool:
        """Wait until no ticket is queued and no batch is in flight;
        False when ``timeout`` seconds pass first."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._q or self._busy:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(left)
        return True

    def submit(self, ticket: _Ticket) -> None:
        with self._cv:
            self._ensure_thread()
            self._q.append(ticket)
            self._cv.notify()

    def _grab_batch(self) -> List[_Ticket]:
        """Pop a device-uniform run of tickets up to the per-RPC array
        cap. Mixed target devices can't share one RPC: the run stops at
        the first ticket bound elsewhere (it leads the next drain)."""
        grab: List[_Ticket] = []
        n = 0
        with self._cv:
            while self._q and n < _MAX_ARRAYS_PER_RPC:
                if grab and self._q[0].device != grab[0].device:
                    break
                t = self._q.pop(0)
                grab.append(t)
                n += len(t.arrays or ())
            self._busy = bool(grab)
        return grab

    def _idle(self) -> None:
        with self._cv:
            self._busy = False
            self._cv.notify_all()

    def _run(self) -> None:
        last_rpc = 0.0
        while True:
            with self._cv:
                while not self._q:
                    self._cv.wait()
            # adaptive linger (Nagle-style): on a slow link, draining the
            # instant the first ticket lands races the pipeline's refill
            # — the consumer frees queue slots only when THIS delivery
            # runs, so tickets submitted a millisecond after the drain
            # wait a whole extra round trip. A pause of 5% of the last
            # RPC (capped 4 ms) lets stragglers join. The worst case is
            # bounded by construction: the pause never exceeds 5% of the
            # measured RPC time, so even a fast link moving big payloads
            # pays <=5% slower cadence, repaid by any batching gain at
            # all; tiny-payload RPCs (the latency-sensitive case) have
            # tiny durations and skip the pause entirely. Skipped when
            # the backlog already fills an RPC — waiting could not
            # deepen that batch, only delay it.
            linger = min(0.004, last_rpc * 0.05)
            if linger > 0.0005:
                with self._cv:
                    backlog = sum(len(t.arrays or ()) for t in self._q)
                if backlog < _MAX_ARRAYS_PER_RPC:
                    time.sleep(linger)
            grab = self._grab_batch()
            if not grab:
                continue
            try:
                last_rpc = self._drain(grab, last_rpc)
            finally:
                self._idle()

    def _drain(self, grab: List[_Ticket], last_rpc: float) -> float:
        """One batched RPC for ``grab`` and the delivery of its results;
        returns the RPC's measured seconds (the linger's estimate)."""
        flat = [a for t in grab for a in (t.arrays or ())]
        t0 = time.perf_counter()
        try:
            if _sim_rtt_s > 0.0:
                time.sleep(_sim_rtt_s)
            results = self._rpc(grab, flat)
            last_rpc = time.perf_counter() - t0
            self._account(len(grab), len(flat))
        except BaseException:  # noqa: BLE001 - isolate per frame below
            # one poisoned array (donated buffer, transient RPC error)
            # must not fail every frame sharing the RPC: retry each
            # ticket alone so only the genuinely bad frame errors out.
            # The failed round trip still cost a full RTT: count it
            # (0 frames delivered) so frames_per_rpc_avg cannot read
            # BETTER than reality on an unhealthy link; account each
            # retry before delivering so a resolve-then-reset caller
            # never sees counts land after its reset. The failed
            # attempt still measured real link time — keep the
            # linger's RPC estimate live through error storms.
            last_rpc = time.perf_counter() - t0
            self._account(0, 0)
            for t in grab:
                t1 = time.perf_counter()
                try:
                    res1 = self._rpc([t], list(t.arrays or []))
                    last_rpc = time.perf_counter() - t1
                    self._account(1, len(t.arrays or ()))
                    t._deliver(res1)
                except BaseException as exc:  # noqa: BLE001
                    self._account(0, 0)
                    t._deliver(None, exc)
            return last_rpc
        i = 0
        for t in grab:
            k = len(t.arrays or ())
            t._deliver(results[i:i + k])
            i += k
        return last_rpc


class _Downloader(_Coalescer):
    """D2H: one batch of pinned, non-blocking copies on a copy stream
    per RPC, and one event wait for the batch. Non-CUDA entries (host
    data, CPU tensors) are copied on the host."""

    THREAD_NAME = "nns-fetch"

    def __init__(self):
        super().__init__()
        self._streams: Dict[torch.device, Any] = {}

    def _copy_stream(self, device: torch.device):
        stream = self._streams.get(device)
        if stream is None:
            stream = self._streams[device] = torch.cuda.Stream(device)
        return stream

    def _rpc(self, tickets: List[_Ticket], flat: List[Any]) -> List[Any]:
        for t in tickets:
            for device, ready in (t.ready or {}).items():
                self._copy_stream(device).wait_event(ready)
        used: Dict[torch.device, Any] = {}
        staged: List[Any] = []
        for a in flat:
            if not is_device_tensor(a):
                staged.append(a.detach().clone()
                              if isinstance(a, torch.Tensor) else a)
                continue
            stream = used[a.device] = self._copy_stream(a.device)
            with torch.cuda.stream(stream):
                host = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
                host.copy_(a, non_blocking=True)
            a.record_stream(stream)
            staged.append(host)
        for stream in used.values():
            copied = torch.cuda.Event()
            copied.record(stream)
            copied.synchronize()  # jitcheck: ok(the fetch service's own thread: this wait is the D2H boundary that fetch_host sanctions; a frame waits only on its ticket)
        return [_host_value(s) for s in staged]


class _Uploader(_Coalescer):
    """H2D: one drain per target device (_grab_batch keeps each drain
    device-uniform), each host array copied to that device."""

    THREAD_NAME = "nns-upload"

    def _rpc(self, tickets: List[_Ticket], flat: List[Any]) -> List[Any]:
        device = tickets[0].device
        return [torch.as_tensor(a).to(device) for a in flat]


_downloader = _Downloader()
_uploader = _Uploader()


def _quiesce_at_exit() -> None:
    """atexit: let the transfers in flight land before the interpreter
    finalizes (see the module's docstring)."""
    for coalescer in (_downloader, _uploader):
        coalescer.wait_idle(EXIT_WAIT_S)


class PendingHost:
    """A CUDA tensor whose host copy is in flight.

    Shape/dtype are known immediately (no sync); :meth:`resolve` blocks
    until the fetcher's copy batch lands. One ticket is shared by every
    output of a frame. ``dev`` keeps the device tensor reachable so
    device-side consumers stay on the card without waiting, and so its
    memory is not reused before the copy; it is dropped at first
    resolution. ``dtype`` is the tensor's ``torch.dtype``.
    """

    __slots__ = ("_ticket", "_index", "dev", "shape", "dtype")

    def __init__(self, ticket: _Ticket, index: int, dev):
        self._ticket = ticket
        self._index = index
        self.dev = dev
        self.shape = tuple(dev.shape)
        self.dtype = dev.dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def done(self) -> bool:
        return self._ticket.done

    def resolve(self) -> Any:
        out = self._ticket.wait()[self._index]
        self.dev = None
        return out


class PendingDevice:
    """A host array whose device copy is in flight — the upload mirror
    of :class:`PendingHost`. ``host`` keeps the source array reachable
    until the upload lands; shape/dtype are free."""

    __slots__ = ("_ticket", "_index", "host", "shape", "dtype")

    def __init__(self, ticket: _Ticket, index: int, host):
        self._ticket = ticket
        self._index = index
        self.host = host
        self.shape = tuple(host.shape)
        self.dtype = host.dtype

    @property
    def done(self) -> bool:
        return self._ticket.done

    def resolve(self) -> Any:
        out = self._ticket.wait()[self._index]
        self.host = None
        return out


def submit_fetch(outputs: Sequence[Any]) -> List[Any]:
    """Enqueue one coalesced fetch for all CUDA outputs of a frame; host
    data and CPU tensors pass through untouched. Returns the outputs
    with CUDA tensors replaced by :class:`PendingHost` handles. Call it
    on the thread (and current stream) that enqueued the outputs' work:
    the fetch waits for an event recorded here on that stream."""
    dev_idx = [i for i, o in enumerate(outputs) if is_device_tensor(o)]
    if not dev_idx:
        return list(outputs)
    arrays = [outputs[i] for i in dev_idx]
    ready: Dict[torch.device, Any] = {}
    for a in arrays:
        if a.device not in ready:
            ready[a.device] = torch.cuda.Event()
            ready[a.device].record(torch.cuda.current_stream(a.device))
    ticket = _Ticket(arrays, ready=ready)
    _downloader.submit(ticket)
    wrapped = list(outputs)
    for slot, i in enumerate(dev_idx):
        wrapped[i] = PendingHost(ticket, slot, outputs[i])
    return wrapped


def submit_upload(inputs: Sequence[Any], device: Any) -> List[Any]:
    """Enqueue one coalesced upload of all host-resident inputs of a
    frame to ``device``; CUDA tensors and pending transfers pass through
    untouched. Returns the inputs with host arrays replaced by
    :class:`PendingDevice` handles. Frames queued while an upload RPC is
    in flight share the next one."""
    host_idx = [i for i, x in enumerate(inputs)
                if not (is_device_tensor(x)
                        or isinstance(x, (PendingHost, PendingDevice)))]
    if not host_idx:
        return list(inputs)
    hosts = [x if isinstance(x, torch.Tensor) else np.asarray(x)
             for x in (inputs[i] for i in host_idx)]
    ticket = _Ticket(list(hosts), device=torch.device(device))
    _uploader.submit(ticket)
    wrapped = list(inputs)
    for slot, i in enumerate(host_idx):
        wrapped[i] = PendingDevice(ticket, slot, hosts[slot])
    return wrapped


def resolve(x: Any) -> Any:
    """Materialize ``x`` if it is a pending transfer; identity
    otherwise."""
    return x.resolve() if isinstance(x, (PendingHost, PendingDevice)) else x


def fetch_host(values: Sequence[Any]) -> List[Any]:
    """Host copies of ``values`` with one copy batch for all of them: the
    CUDA tensors among them join ONE coalesced fetch (pinned copies on
    the copy stream after an event recorded on this thread's stream,
    never a blocking copy each), pending fetches are waited for, host
    data passes. numpy, but bfloat16 (numpy has none) as a CPU tensor."""
    return [_host_value(resolve(v)) for v in submit_fetch(list(values))]


def fetch_stats(reset: bool = False) -> dict:
    """Download-side counters: rpcs / frames / arrays since start (or
    last reset) plus ``frames_per_rpc_avg``, the achieved batching depth.
    (Historical name; the upload mirror is in :func:`transfer_stats`.)"""
    return _downloader.stats(reset=reset)


def transfer_stats(reset: bool = False) -> Dict[str, dict]:
    """Both directions' coalescer counters, keyed ``download`` /
    ``upload``."""
    return {"download": _downloader.stats(reset=reset),
            "upload": _uploader.stats(reset=reset)}


class InFlightWindow:
    """The per-link bound on frames between dispatch and completion.

    ``acquire`` blocks the dispatching chain thread while ``limit``
    frames are in flight — backpressure that propagates into the
    upstream queue element exactly like a slow synchronous invoke
    would, so bounded-queue flow control keeps working under overlap.
    ``release`` is called by the completer once the frame has been
    pushed downstream (or accounted dropped).

    The occupancy/overlap accounting lives here because the window IS
    the overlap: ``overlap_ratio`` is total in-flight frame-seconds
    over the dispatch-to-last-completion wall span — 1.0 means serial
    (no overlap won), ``limit`` means the window ran full depth.

    ``devices`` records how many cards one slot's dispatch spans: a
    window of K means K outstanding dispatches regardless of how wide
    each one is. The value is reporting-only; it never scales the
    limit.
    """

    def __init__(self, limit: int, devices: int = 1):
        self.limit = max(1, int(limit))
        self.devices = max(1, int(devices))
        self._cv = threading.Condition()
        self._inflight = 0
        self._peak = 0
        self._acquires = 0
        self._occupancy_sum = 0       # inflight depth sampled per acquire
        self._blocked_ns = 0
        self._inflight_ns = 0         # sum of per-frame dispatch->release
        self._first_ns: Optional[int] = None
        self._last_ns: Optional[int] = None

    @flow.acquires("window-slot")
    def acquire(self, timeout: Optional[float] = None) -> Optional[int]:
        """Take a window slot; returns the dispatch timestamp (ns) to
        hand back to :meth:`release`, or None on timeout."""
        import time as _time
        t0 = _time.perf_counter_ns()
        with self._cv:
            while self._inflight >= self.limit:
                if not self._cv.wait(timeout):
                    return None
            now = _time.perf_counter_ns()
            self._blocked_ns += now - t0
            self._inflight += 1
            self._acquires += 1
            self._occupancy_sum += self._inflight
            if self._inflight > self._peak:
                self._peak = self._inflight
            if self._first_ns is None:
                self._first_ns = now
            return now

    @flow.settles("window-slot")
    def release(self, t_dispatch_ns: int) -> None:
        import time as _time
        now = _time.perf_counter_ns()
        with self._cv:
            self._inflight -= 1
            self._inflight_ns += now - t_dispatch_ns
            self._last_ns = now
            self._cv.notify_all()

    def idle(self) -> bool:
        with self._cv:
            return self._inflight == 0

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        import time as _time
        deadline = None if timeout is None \
            else _time.monotonic() + timeout
        with self._cv:
            while self._inflight > 0:
                left = None if deadline is None \
                    else deadline - _time.monotonic()
                if left is not None and left <= 0:
                    return False
                if not self._cv.wait(left if left is not None else 1.0):
                    return False
            return True

    def report(self) -> Dict[str, Any]:
        with self._cv:
            span = ((self._last_ns - self._first_ns)
                    if self._first_ns is not None
                    and self._last_ns is not None else 0)
            return {
                "window": self.limit,
                "devices": self.devices,
                "in_flight": self._inflight,
                "in_flight_peak": self._peak,
                "occupancy_avg": round(
                    self._occupancy_sum / self._acquires, 2)
                    if self._acquires else 0.0,
                "overlap_ratio": round(self._inflight_ns / span, 2)
                    if span > 0 else 0.0,
                "blocked_ms": round(self._blocked_ns / 1e6, 2),
            }
