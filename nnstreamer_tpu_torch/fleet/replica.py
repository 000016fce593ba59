"""Parent-side replica process management.

Port of ``nnstreamer_tpu/fleet/replica.py``: the child is
``python -m nnstreamer_tpu_torch.fleet.replica_main`` and its
``PYTHONPATH`` is the port's repository root, so a replica never
reaches the JAX package.

:class:`ReplicaSpec` describes how to launch one replica of the fleet
(the launch-description template plus checkpoint/cache roots);
:class:`ReplicaProcess` owns one child built from it — spawn, readiness,
preemption (SIGTERM → drain → snapshot → exit 0), and the machine-
readable markers the child prints (see :mod:`.replica_main`).

The process boundary is deliberate: a replica is a *real* unit of
preemptible capacity — its own interpreter, its own CUDA context, its
own snapshot directory. The autoscaler composes these into a fleet.
"""
from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..utils.log import logger


REPLICA_MODULE = "nnstreamer_tpu_torch.fleet.replica_main"


def _repo_root() -> str:
    import nnstreamer_tpu_torch
    return os.path.dirname(os.path.dirname(
        os.path.abspath(nnstreamer_tpu_torch.__file__)))


@dataclass
class ReplicaSpec:
    """How to build one replica. ``desc_template`` is a launch
    description with ``{port}``, ``{ident}``, ``{ckpt}`` and
    ``{version}`` placeholders — e.g.::

        tensor_serve_src name=src port={port} id=7 connect-type=HYBRID
          topic=fleet dest-port=4100 version={version}
          ! tensor_filter framework=torch-cuda model=zoo://mlp
          ! tensor_serve_sink id=7
    """

    desc_template: str
    ckpt_root: str
    grace_s: float = 2.0
    compile_cache: str = ""
    prelude: str = ""
    version: str = ""
    ready_timeout_s: float = 120.0
    env: Dict[str, str] = field(default_factory=dict)


class ReplicaProcess:
    """One live (or resurrectable) replica child process."""

    def __init__(self, spec: ReplicaSpec, ident: str, port: int = 0,
                 version: Optional[str] = None, restore: bool = False):
        self.spec = spec
        self.ident = ident
        self.port = int(port)  # 0 until the child reports its bound port
        self.version = spec.version if version is None else str(version)
        self.restore = bool(restore)
        self.proc: Optional[subprocess.Popen] = None
        self.pid = 0
        self.preempt_report: Optional[Dict] = None
        self._ready = threading.Event()
        self._lines: List[str] = []
        self._llock = threading.Lock()

    # -- identity ----------------------------------------------------------
    @property
    def ckpt_dir(self) -> str:
        return os.path.join(self.spec.ckpt_root, self.ident)

    def key(self, host: str = "localhost") -> str:
        """The router's replica key for this endpoint."""
        return f"{host}:{self.port}"

    # -- lifecycle ---------------------------------------------------------
    def spawn(self) -> "ReplicaProcess":
        desc = self.spec.desc_template.format(
            port=self.port, ident=self.ident, ckpt=self.ckpt_dir,
            version=self.version)
        argv = [sys.executable, "-m", REPLICA_MODULE,
                "--desc", desc, "--ckpt", self.ckpt_dir,
                "--grace-s", str(float(self.spec.grace_s))]
        if self.restore:
            argv.append("--restore")
        if self.spec.compile_cache:
            argv += ["--compile-cache", self.spec.compile_cache]
        if self.spec.prelude:
            argv += ["--prelude", self.spec.prelude]
        root = _repo_root()
        env = dict(os.environ)
        env.setdefault("PYTHONPATH", root)
        if self.spec.compile_cache:
            from .cache import ENV_VAR
            env[ENV_VAR] = self.spec.compile_cache
        env.update(self.spec.env)
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self._ready.clear()
        self.preempt_report = None  # racecheck: ok(reset before this incarnation's reader thread exists; only that reader writes it afterwards)
        self.proc = subprocess.Popen(
            argv, cwd=root, env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        threading.Thread(target=self._reader, args=(self.proc,),
                         name=f"replica-out:{self.ident}",
                         daemon=True).start()
        return self

    def _reader(self, proc: subprocess.Popen) -> None:
        # one reader per child life: parses the stdout markers and keeps
        # a bounded tail for post-mortems
        assert proc.stdout is not None
        for line in proc.stdout:
            line = line.rstrip("\n")
            with self._llock:
                self._lines.append(line)
                if len(self._lines) > 400:
                    del self._lines[:200]
            if line.startswith("replica-ready "):
                for tok in line.split()[1:]:
                    k, _, v = tok.partition("=")
                    if k == "port" and v.isdigit():
                        self.port = int(v)
                    elif k == "pid" and v.isdigit():
                        self.pid = int(v)
                self._ready.set()
            elif line.startswith("replica-preempted "):
                try:
                    self.preempt_report = json.loads(
                        line.split(" ", 1)[1])
                except ValueError:
                    self.preempt_report = {}

    def wait_ready(self, timeout: Optional[float] = None) -> int:
        """Block until the child printed ``replica-ready``; returns its
        bound port. Raises on timeout or child death (with the tail)."""
        deadline = time.monotonic() + (self.spec.ready_timeout_s
                                       if timeout is None else timeout)
        while not self._ready.wait(0.1):
            if self.proc is not None and self.proc.poll() is not None:
                raise RuntimeError(
                    f"replica {self.ident} died before ready "
                    f"(rc={self.proc.returncode}):\n{self.tail()}")
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"replica {self.ident} not ready in time:\n"
                    f"{self.tail()}")
        return self.port

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def ready(self) -> bool:
        """True once the child reported ``replica-ready`` this life."""
        return self._ready.is_set()

    def preempt(self, timeout: float = 30.0) -> Optional[Dict]:
        """SIGTERM → PreemptGuard (drain + snapshot) → exit 0. Returns
        the child's preempt report (None if it died reportless)."""
        if self.proc is None or self.proc.poll() is not None:
            return self.preempt_report
        try:
            self.proc.send_signal(signal.SIGTERM)
        except OSError:
            return self.preempt_report
        try:
            self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            logger.warning("replica %s ignored SIGTERM for %.1fs; killing",
                           self.ident, timeout)
            self.kill()
        return self.preempt_report

    def kill(self) -> None:
        """Unconditional teardown (chaos / cleanup): no drain, no
        snapshot beyond whatever the guard already published."""
        if self.proc is None:
            return
        try:
            self.proc.kill()
            self.proc.wait(timeout=10)
        except (OSError, subprocess.TimeoutExpired):
            pass

    def tail(self, n: int = 40) -> str:
        with self._llock:
            return "\n".join(self._lines[-n:])
