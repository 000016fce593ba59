"""The mesh world: one ``torch.distributed`` group for the process's
device pool, driven from one controller.

JAX's mesh is single-controller: one process, one pipeline, and the mesh
is the pool of devices one ``tensor_filter`` fans out over. The port
keeps that meaning. The process that first builds a mesh is rank 0 and
runs the pipeline as before. When the pool holds more than one device,
rank 0 spawns one follower process per further device (gloo ranks on
the CPU, NCCL ranks with one card each), and the followers execute the
mesh commands rank 0 issues, in the order it issues them.

A command is a function of the port, carried by reference (its module
and name: never a closure), with its arguments pickled. In the
arguments, a :class:`~torch.distributed.device_mesh.DeviceMesh` travels
as its shape (each rank has built the same mesh), an object kept on the
mesh (:func:`keep`) as its handle, and any other tensor as its shape and
dtype only: the follower gets an empty tensor of that shape, and the
command places rank 0's data itself (``distribute_tensor(...,
src_data_rank=0)`` or a broadcast). So followers never draw weights
or read frames of their own. Every rank runs the same function, so the
collectives inside meet.

Rank 0 issues every command through :meth:`World.run`, under one lock:
the chain thread, the in-flight completer, the serve scheduler and a
colocated trainer may all reach the mesh, and two threads issuing
collectives in different orders would deadlock the world. A command
that raises on a follower stops the world (its followers are killed,
so rank 0's pending collective fails instead of waiting) and raises on
rank 0 with the follower's traceback; a command that raises on every
rank alike (an argument check) leaves the world as it was.

The world runs on the cards or on the host CPU, never the one in place
of the other. The caller names the device: a filter or a trainer its
``accelerator`` (``true:cpu`` or ``false`` opt out of the card), the
parallel/ API the world :func:`set_host_devices` chose, else the cards;
asking for the cards where CUDA is missing raises. On the cards the pool
is ``torch.cuda.device_count()``; on the CPU it is the host-device count
:func:`set_host_devices` sets (default 1: the counterpart of
``xla_force_host_platform_device_count``). With a pool of 1 there are
no followers: the group is a one-rank group over a
``HashStore``. There is one world a process, shared by every mesh user;
:func:`retain`/:func:`release` count the users (a filter, a trainer, a
serve scheduler), and the followers are stopped and reaped when the
last one lets go, and at exit.

A follower runs ``python -m nnstreamer_tpu_torch.parallel.follower``
(rank 0 starts them; nothing else should).
"""
from __future__ import annotations

import atexit
import faulthandler
import io
import itertools
import os
import pickle
import queue
import secrets
import signal
import subprocess
import sys
import threading
import time
import traceback
import weakref
from datetime import timedelta
from multiprocessing.connection import Client, Listener, wait
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..utils.log import logger

_LOCK = threading.Lock()
_WORLD: Optional["World"] = None
_HOST_DEVICES = 1
# set_host_devices chose the host CPU for a world whose device the
# caller leaves open (the parallel/ API's)
_HOST_CHOSEN = False
_TLS = threading.local()
# set in a follower process: every call there runs inside a command
_FOLLOWER: Optional["_Follower"] = None

# rank 0 gives up on a follower's answer this long after its own part
# of a command raised (the follower is then stuck in a collective)
_ACK_AFTER_ERROR_S = 10.0
# close() waits this long for a follower it killed (under the world lock)
_KILL_WAIT_S = 5.0
# a collective that waits longer than this fails (gloo/NCCL timeout)
_COLLECTIVE_TIMEOUT = timedelta(seconds=180)


NO_CUDA = ("no CUDA device is available for the mesh world; pass "
           "accelerator=true:cpu (or false) to the element, or call "
           "parallel.mesh.set_host_devices(n) first, to run the mesh on "
           "the CPU")


def set_host_devices(n: Optional[int]) -> None:
    """Run the mesh world on the host CPU with ``n`` devices (one gloo
    rank a device) where the caller names no device; set before the
    world starts, and raises once it has, as the device-count flag of
    the JAX package cannot take effect after its backend started.
    ``None`` restores the default (the cards) once the world is gone."""
    global _HOST_DEVICES, _HOST_CHOSEN
    with _LOCK:
        if n is None:
            if _WORLD is not None:
                raise RuntimeError("set_host_devices(None): the mesh "
                                   "world still runs")
            _HOST_DEVICES, _HOST_CHOSEN = 1, False
            return
        n = int(n)
        if n < 1:
            raise ValueError(f"set_host_devices({n}): need at least 1")
        if _WORLD is not None and (n != _HOST_DEVICES
                                   or _WORLD.device_type != "cpu"):
            raise RuntimeError(
                f"set_host_devices({n}): the mesh world already runs with "
                f"{_WORLD.size} {_WORLD.device_type} device(s); the count "
                "is fixed until shutdown() — or run in a fresh process: "
                "`python -m nnstreamer_tpu_torch.parallel.dryrun <n> --cpu`")
        _HOST_DEVICES, _HOST_CHOSEN = n, True


def host_devices() -> int:
    return _HOST_DEVICES


def device_type() -> str:
    """The mesh world's device type: the running world's (a follower's
    its own), else the one a world started for a caller that names none
    takes: the CPU after :func:`set_host_devices`, else the cards."""
    if _FOLLOWER is not None:
        return _FOLLOWER.device_type
    w = _WORLD
    if w is not None:
        return w.device_type
    return "cpu" if _HOST_CHOSEN else "cuda"


def pool_size(device: Optional[str] = None) -> int:
    """The devices a mesh on ``device`` (default :func:`device_type`)
    may span: the running world's, else the cards or the host count."""
    device = device or device_type()
    w = _WORLD
    if w is not None and w.device_type == device:
        return w.size
    if device == "cuda":
        return torch.cuda.device_count() if torch.cuda.is_available() else 0
    return _HOST_DEVICES


def in_command() -> bool:
    """True on a follower, and on rank 0 inside a command."""
    return _FOLLOWER is not None or getattr(_TLS, "active", False)


def rank() -> int:
    return _FOLLOWER.rank if _FOLLOWER is not None else 0


def local_device() -> torch.device:
    """This rank's device: ``cuda:<rank>`` on the card, else the CPU."""
    if device_type() == "cuda":
        return torch.device("cuda", rank())
    return torch.device("cpu")


def started() -> bool:
    return _WORLD is not None


def world(device: Optional[str] = None) -> "World":
    """Rank 0's world on ``device`` (``"cuda"`` or ``"cpu"``; default
    :func:`device_type`), started at first use. Raises when the world
    runs on the other device, and when the cards are asked for where
    CUDA is missing."""
    global _WORLD
    if _FOLLOWER is not None:
        raise RuntimeError("world() is rank 0's; a follower runs commands")
    want = device or device_type()
    with _LOCK:
        if _WORLD is not None and _WORLD.device_type != want:
            raise RuntimeError(
                f"the mesh world runs on {_WORLD.device_type}; a mesh on "
                f"{want} needs it stopped first")
        if _WORLD is not None and _WORLD.broken:
            logger.warning("mesh world: restarting a broken world (%s)",
                           _WORLD.broken)
            users = _WORLD.users
            _WORLD.close()
            _WORLD = World(_WORLD.size, want)
            _WORLD.users = users
        if _WORLD is None:
            if want == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(NO_CUDA)
            _WORLD = World(pool_size(want), want)
        return _WORLD


def run(fn: Callable, *args, ranks: Optional[int] = None, **kwargs):
    """Run ``fn(*args, **kwargs)`` as a mesh command on the first
    ``ranks`` ranks (default: every rank), or directly where a command
    is already running."""
    if in_command():
        return fn(*args, **kwargs)
    return world().run(fn, args, kwargs, ranks=ranks)


def keep(obj: Any, ranks: int = 0) -> Any:
    """Keep ``obj`` on the mesh under a handle (call inside a command, on
    every rank alike): later commands that get ``obj`` as an argument
    reach each follower's own counterpart. ``ranks`` is the size of the
    mesh it lives on (the ranks later commands on it need)."""
    if _FOLLOWER is not None:
        _FOLLOWER.keep(obj)
    elif _WORLD is not None:
        _WORLD.keep(obj, ranks)
    return obj


def retain(device: Optional[str] = None) -> "World":
    """Count one more user of the mesh world on ``device`` (starting it
    if needed; see :func:`world`)."""
    w = world(device)
    with _LOCK:
        w.users += 1
    return w


def release() -> None:
    """One user less; the last one stops the followers."""
    global _WORLD
    with _LOCK:
        w = _WORLD
        if w is None:
            return
        w.users -= 1
        if w.users > 0:
            return
        _WORLD = None
    w.close()


def shutdown() -> None:
    """Stop the world now, whatever its users: the followers are told to
    leave, reaped, and the process group is destroyed."""
    global _WORLD
    with _LOCK:
        w, _WORLD = _WORLD, None
    if w is not None:
        w.close()


atexit.register(shutdown)


# -- pickling of commands ---------------------------------------------------

class _Pickler(pickle.Pickler):
    def __init__(self, f, world: "World"):
        super().__init__(f, protocol=pickle.HIGHEST_PROTOCOL)
        self.world = world
        self.ranks = 0

    def persistent_id(self, obj):
        from torch.distributed.device_mesh import DeviceMesh
        if isinstance(obj, DeviceMesh):
            self.ranks = max(self.ranks, obj.mesh.numel())
            return ("mesh", tuple(obj.mesh.shape))
        if isinstance(obj, (torch.Tensor, torch.nn.Module)) or \
                hasattr(obj, "__weakref__"):
            found = self.world.handle_of(obj)
            if found is not None:
                hid, ranks = found
                self.ranks = max(self.ranks, ranks)
                return ("handle", hid)
        if isinstance(obj, torch.Tensor):
            from torch.distributed.tensor import DTensor
            if isinstance(obj, DTensor):
                raise ValueError("a DTensor that is not kept on the mesh "
                                 "cannot be a command's argument")
            return ("tensor", tuple(obj.shape), obj.dtype)
        return None


class _Unpickler(pickle.Unpickler):
    def __init__(self, f, follower: "_Follower"):
        super().__init__(f)
        self.follower = follower

    def persistent_load(self, pid):
        kind = pid[0]
        if kind == "mesh":
            from .mesh import cached_mesh
            return cached_mesh(pid[1])
        if kind == "handle":
            return self.follower.objects[pid[1]]
        if kind == "tensor":
            return torch.empty(pid[1], dtype=pid[2], device=local_device())
        raise pickle.UnpicklingError(f"unknown persistent id {pid!r}")


def _free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _backend(device: str) -> str:
    return "cpu:gloo,cuda:nccl" if device == "cuda" else "gloo"


class World:
    """Rank 0's side: the followers, their command channels and the one
    lock every command is issued under."""

    def __init__(self, size: int, device_type: str):
        self.size = max(1, int(size))
        self.device_type = device_type
        self.users = 0
        self._lock = threading.RLock()
        self._seq = 0
        self._keeps = itertools.count()
        self._cur = 0
        # id(obj) -> (handle, ranks); rank 0 holds its objects weakly
        self._handles: Dict[int, Tuple[str, int]] = {}
        self._released: List[str] = []
        self._release_lock = threading.Lock()
        self._procs: List[subprocess.Popen] = []
        self._conns: List[Any] = []
        self._acks: "queue.Queue" = queue.Queue()
        # why the world broke; written by _watch and by the command
        # thread, so only through _break
        self._broken: Optional[str] = None
        self._broken_lock = threading.Lock()
        self._closing = False
        # set while no command runs on rank 0
        self._idle = threading.Event()
        self._idle.set()
        self.executed = [0] * self.size
        self._start()

    # -- start / stop -------------------------------------------------------
    def _start(self) -> None:
        t0 = time.monotonic()
        if self.size == 1:
            dist.init_process_group(_backend(self.device_type),
                                    store=dist.HashStore(),
                                    rank=0, world_size=1,
                                    timeout=_COLLECTIVE_TIMEOUT)
            logger.info("mesh world: 1 rank (%s)", self.device_type)
            return
        port = _free_port()
        key = secrets.token_bytes(16)
        listener = Listener(("127.0.0.1", 0), authkey=key)
        env = dict(os.environ)
        env["OMP_NUM_THREADS"] = "1"
        env["NNS_MESH_AUTHKEY"] = key.hex()
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = root + (os.pathsep + env["PYTHONPATH"]
                                    if env.get("PYTHONPATH") else "")
        host, cport = listener.address
        try:
            for r in range(1, self.size):
                self._procs.append(subprocess.Popen(
                    [sys.executable, "-m", "nnstreamer_tpu_torch.parallel.follower",
                     str(r), str(self.size), str(port), f"{host}:{cport}",
                     self.device_type],
                    env=env, stdin=subprocess.DEVNULL))
            by_rank: Dict[int, Any] = {}
            listener._listener._socket.settimeout(120.0)
            while len(by_rank) < self.size - 1:
                conn = listener.accept()
                by_rank[conn.recv()] = conn
            self._conns = [by_rank[r] for r in range(1, self.size)]
            dist.init_process_group(
                _backend(self.device_type),
                init_method=f"tcp://127.0.0.1:{port}", rank=0,
                world_size=self.size, timeout=_COLLECTIVE_TIMEOUT)
        except BaseException:
            self._kill()
            raise
        finally:
            listener.close()
        threading.Thread(target=self._watch, daemon=True,
                         name="mesh-world-monitor").start()
        logger.info("mesh world: %d ranks (%s), followers up in %.1f s",
                    self.size, self.device_type, time.monotonic() - t0)

    def _watch(self) -> None:
        """Read the followers' answers. An error while rank 0's part of
        the command still runs a moment later kills the followers, so
        rank 0's pending collective fails at once instead of waiting."""
        conns = list(self._conns)
        while conns:
            for conn in wait(conns):
                try:
                    msg = conn.recv()
                except (EOFError, OSError):
                    conns.remove(conn)
                    if self._procs and not self._closing:
                        self._break("a follower left the mesh world")
                        self._acks.put(("lost", -1, -1, None))
                    continue
                self._acks.put(msg)
                if msg[0] == "error" and not self._idle.wait(2.0):
                    self._break(msg[3])
                    self._kill()

    def _break(self, reason: str) -> None:
        """Mark the world broken; the first reason given stays."""
        with self._broken_lock:
            if self._broken is None:
                self._broken = reason

    def _kill(self) -> None:
        for p in self._procs:
            if p.poll() is None:
                try:
                    p.kill()
                except OSError:
                    pass

    def close(self) -> None:
        """Tell the followers to leave, reap them, destroy the group."""
        with self._lock:
            self._closing = True
            for conn in self._conns:
                try:
                    conn.send(("stop",))
                except OSError:
                    pass
            deadline = time.monotonic() + 10.0
            for p in self._procs:
                try:
                    p.wait(timeout=max(0.1, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    p.kill()
                    try:
                        # bounded: a follower stuck in the driver may
                        # not die at once, and the world lock is held
                        p.wait(timeout=_KILL_WAIT_S)
                    except subprocess.TimeoutExpired:
                        logger.warning("mesh follower %d did not exit "
                                       "after SIGKILL", p.pid)
            for conn in self._conns:
                conn.close()
            self._procs, self._conns = [], []
            from .mesh import clear_cached_meshes
            clear_cached_meshes()
            if dist.is_initialized():
                dist.destroy_process_group()
        logger.info("mesh world of %d rank(s) stopped", self.size)

    @property
    def broken(self) -> Optional[str]:
        return self._broken

    # -- handles ------------------------------------------------------------
    def keep(self, obj: Any, ranks: int) -> None:
        if not self._conns:
            return  # no follower to find it: rank 0 holds its own objects
        hid = f"{self._cur}.{next(self._keeps)}"
        self._handles[id(obj)] = (hid, ranks or self.size)
        weakref.finalize(obj, self._dropped, id(obj), hid)

    def _dropped(self, key: int, hid: str) -> None:
        with self._release_lock:
            if self._handles.get(key, (None,))[0] == hid:
                del self._handles[key]
            self._released.append(hid)

    def handle_of(self, obj: Any) -> Optional[Tuple[str, int]]:
        return self._handles.get(id(obj))

    # -- commands -----------------------------------------------------------
    def run(self, fn: Callable, args: Tuple, kwargs: Dict,
            ranks: Optional[int] = None):
        """Issue ``fn`` to the followers that the mesh in its arguments
        spans (or ``ranks``, or all), run it here, and wait for their
        answers."""
        with self._lock:
            if self._broken is not None:
                raise RuntimeError(f"the mesh world is broken: "
                                   f"{self._broken}")
            self._seq += 1
            self._cur = self._seq
            self._keeps = itertools.count()
            targets: List[Any] = []
            if self._conns:
                buf = io.BytesIO()
                p = _Pickler(buf, self)
                p.dump((fn, args, kwargs))
                n = ranks or p.ranks or self.size
                with self._release_lock:
                    released, self._released = self._released, []
                targets = self._conns[:n - 1]
                for conn in self._conns:
                    if conn in targets:
                        conn.send(("run", self._seq, buf.getvalue(),
                                   released))
                    elif released:
                        conn.send(("drop", released))
            _TLS.active = True
            self._idle.clear()
            err: Optional[BaseException] = None
            try:
                out = fn(*args, **kwargs)
            except BaseException as exc:  # noqa: BLE001 — re-raised below
                err = exc
            finally:
                _TLS.active = False
                self._idle.set()
            self.executed[0] += 1
            self._collect(len(targets), err)
            if err is not None:
                raise err
            return out

    def _collect(self, n: int, err: Optional[BaseException]) -> None:
        """Wait for the ``n`` followers' answers to this command. An
        error on every rank alike (an argument check) leaves the world
        as it was; any other mix breaks it."""
        errors: List[str] = []
        deadline = None if err is None else \
            time.monotonic() + _ACK_AFTER_ERROR_S
        got = 0
        while got < n:
            try:
                timeout = None if deadline is None else \
                    max(0.0, deadline - time.monotonic())
                msg = self._acks.get(timeout=timeout)
            except queue.Empty:
                self._break(f"followers did not answer command "
                            f"{self._seq} after rank 0 raised {err!r}")
                break
            if msg[0] == "lost":
                break
            if msg[1] != self._seq:
                continue
            got += 1
            self.executed[msg[2]] += 1
            if msg[0] == "error":
                errors.append(f"rank {msg[2]}: {msg[3]}")
                if err is None:
                    # rank 0 got through: a follower that waits on the
                    # failed one in a collective would never answer
                    break
        if err is not None and len(errors) == n and self._broken is None:
            return
        if errors or got < n:
            self._break("; ".join(errors) or "a follower did not answer")
            self._kill()
            raise RuntimeError(
                f"the mesh world broke in command {self._seq}: "
                f"{self._broken}") from err


# -- the follower -------------------------------------------------------------

class _Follower:
    def __init__(self, rank_: int, device_type: str):
        self.rank = rank_
        self.device_type = device_type
        self.objects: Dict[str, Any] = {}
        self._cur = 0
        self._keeps = itertools.count()

    def keep(self, obj: Any) -> None:
        self.objects[f"{self._cur}.{next(self._keeps)}"] = obj

    def serve(self, conn) -> None:
        while True:
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                return
            if msg[0] == "stop":
                return
            for hid in msg[-1]:
                self.objects.pop(hid, None)
            if msg[0] == "drop":
                continue
            _, seq, blob, _ = msg
            self._cur = seq
            self._keeps = itertools.count()
            try:
                fn, args, kwargs = _Unpickler(io.BytesIO(blob), self).load()
                fn(*args, **kwargs)
                del fn, args, kwargs
            except BaseException:  # noqa: BLE001 — reported to rank 0
                conn.send(("error", seq, self.rank, traceback.format_exc()))
                continue
            conn.send(("ok", seq, self.rank, None))


def follower_main(argv: List[str]) -> int:
    global _FOLLOWER
    rank_, size, port = int(argv[0]), int(argv[1]), int(argv[2])
    host, cport = argv[3].rsplit(":", 1)
    if argv[4] == "cuda":
        torch.cuda.set_device(rank_)
    torch.set_num_threads(1)
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    faulthandler.enable()  # a fatal signal prints the follower's stack
    conn = Client((host, int(cport)),
                  authkey=bytes.fromhex(os.environ["NNS_MESH_AUTHKEY"]))
    conn.send(rank_)
    _FOLLOWER = _Follower(rank_, argv[4])
    dist.init_process_group(_backend(argv[4]),
                            init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank_, world_size=size,
                            timeout=_COLLECTIVE_TIMEOUT)
    try:
        _FOLLOWER.serve(conn)
    finally:
        _FOLLOWER.objects.clear()
        try:
            dist.destroy_process_group()
        except Exception:  # noqa: BLE001 — the world may be gone already
            pass
    return 0

