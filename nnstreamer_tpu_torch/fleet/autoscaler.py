"""Autoscaler control plane: the fleet acts on the health it reports.

Port of ``nnstreamer_tpu/fleet/autoscaler.py`` (framework neutral: it
moves processes, not tensors), with every property of the
``tensor_autoscaler`` element.

The :class:`Autoscaler` closes the loop between the telemetry plane and
fleet size. Signals come from two existing sources — the per-replica
occupancy loads the router collects from PONG heartbeats (including the
``queue_delay_us_p95`` tail the scheduler piggybacks), and optionally an
aggregate ``/metrics`` scrape — and actuation uses only existing verbs:

* **scale up** — spawn a :class:`~.replica.ReplicaProcess` (a
  subprocess replica); the persistent compile cache (:mod:`.cache`)
  makes it warm before it REGISTERs;
* **scale down** — *preempt* the least-loaded replica: router
  ``drain_replica()`` settlement first, then SIGTERM → ``PreemptGuard``
  → snapshot → exit 0. Every scale-down exercises the resurrect path's
  write side, not just chaos runs;
* **resurrect** — an unexpectedly dead replica respawns from its own
  snapshot directory at the same endpoint (``--restore``), advertising
  ``restored_sessions`` so the router counts the resurrection.

Replica lifecycle accounting is a conservation identity
(``fleet-replica-lifecycle``, declared in analysis/flow/registry.py)::

    replicas_spawned == replicas_serving + replicas_draining
                        + replicas_retired + replicas_resurrecting

Every transition below moves exactly one unit between the right-hand
terms (or mints a ``spawned`` with its initial state), so the identity
holds at *every* quiescent point — scale-up, scale-down, rollout, and
death included. ``check()`` asserts it over the live snapshot via
:func:`~..analysis.flow.runtime.check_identities`.
"""
from __future__ import annotations

import contextlib
import threading
import time
import weakref
from dataclasses import dataclass
from typing import Dict, List, Optional

from ..pipeline.element import Element
from ..pipeline.registry import register_element
from ..utils.atomic import Counters
from ..utils.log import logger
from .replica import ReplicaProcess, ReplicaSpec

# states of the per-replica lifecycle (the identity's RHS vocabulary)
SERVING = "serving"
DRAINING = "draining"
RESURRECTING = "resurrecting"

# live autoscalers, exposed to obs/metrics.py's render()
_LIVE: "weakref.WeakSet[Autoscaler]" = weakref.WeakSet()


def live_autoscalers() -> List["Autoscaler"]:
    return list(_LIVE)


@dataclass
class AutoscalerConfig:
    """Control-law knobs. ``target_delay_ms`` is the p95 queue-delay
    ceiling; the fleet grows while the tail is above it and shrinks
    (to ``min_replicas``) while under ``low_water`` of it."""

    min_replicas: int = 1
    max_replicas: int = 4
    target_delay_ms: float = 50.0
    low_water: float = 0.3
    interval_s: float = 0.25
    scale_up_cooldown_s: float = 1.0
    scale_down_cooldown_s: float = 3.0
    drain_deadline_ms: float = 2000.0
    metrics_url: str = ""  # "host:port" of a MetricsServer to scrape
    resurrect: bool = True


class Autoscaler:
    """Fleet-size control loop over preemptible subprocess replicas."""

    def __init__(self, spec: ReplicaSpec, router=None,
                 config: Optional[AutoscalerConfig] = None,
                 name: str = "autoscaler",
                 stats: Optional[Counters] = None):
        self.spec = spec
        self.router = router  # FleetRouter or TensorServeRouter element
        self.cfg = config or AutoscalerConfig()
        self.name = name
        self.stats = stats if stats is not None else Counters()
        self.stats.update({
            "replicas_spawned": 0, "replicas_serving": 0,
            "replicas_draining": 0, "replicas_retired": 0,
            "replicas_resurrecting": 0,
            "scale_ups": 0, "scale_downs": 0, "resurrections": 0,
            "rollouts": 0})
        self._replicas: Dict[str, ReplicaProcess] = {}
        self._state: Dict[str, str] = {}
        self._lock = threading.RLock()
        self._next_id = 0
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_up = 0.0
        self._last_down = 0.0
        self._hold = 0
        _LIVE.add(self)

    # -- plumbing ----------------------------------------------------------
    def _router(self):
        # accept the element wrapper or the embeddable core
        return getattr(self.router, "router", self.router)

    def replicas(self) -> Dict[str, str]:
        """ident -> lifecycle state snapshot."""
        with self._lock:
            return dict(self._state)

    def handle(self, ident: str) -> Optional[ReplicaProcess]:
        with self._lock:
            return self._replicas.get(ident)

    def lifecycle(self) -> Dict[str, int]:
        return self.stats.snapshot()

    def check(self) -> None:
        """Assert the replica-lifecycle conservation identity over the
        live counters (raises AssertionError with the breakdown)."""
        from ..analysis.flow.runtime import check_identities
        check_identities(self.stats.snapshot(),
                         names=["fleet-replica-lifecycle"])

    @contextlib.contextmanager
    def hold_scaling(self):
        """Suspend the control law (reaping and resurrection-promotion
        continue). A blue/green rollout holds this while it carries
        surge capacity — otherwise the scale-down path reads the surged
        fleet as surplus and preempts a replica out from under the
        rollout's own ledger."""
        with self._lock:
            self._hold += 1
        try:
            yield
        finally:
            with self._lock:
                self._hold -= 1

    # -- lifecycle transitions (the identity's production sites) -----------
    def spawn_replica(self, version: Optional[str] = None,
                      wait: bool = True) -> str:
        """Scale-up unit: one fresh replica. Counts ``spawned`` +
        ``serving`` (a spawn that dies before ready retires)."""
        with self._lock:
            self._next_id += 1
            ident = f"{self.name}-r{self._next_id}"
            rp = ReplicaProcess(self.spec, ident, version=version)
            self._replicas[ident] = rp
            self._state[ident] = SERVING
            self.stats.add(replicas_spawned=1, replicas_serving=1)
        try:
            rp.spawn()
            if wait:
                rp.wait_ready()
        except Exception:
            rp.kill()
            with self._lock:
                self._replicas.pop(ident, None)
                self._state.pop(ident, None)
                self.stats.add(replicas_serving=-1, replicas_retired=1)
            raise
        logger.info("%s: scaled up: %s on port %d", self.name, ident,
                    rp.port)
        return ident

    def retire_replica(self, ident: str, sync: bool = True) -> bool:
        """Scale-down unit: drain (router settlement) then preempt.
        ``sync=False`` runs the drain+preempt on a worker thread; the
        control loop reaps the exit into ``retired``."""
        with self._lock:
            rp = self._replicas.get(ident)
            if rp is None or self._state.get(ident) != SERVING:
                return False
            self._state[ident] = DRAINING
            self.stats.add(replicas_serving=-1, replicas_draining=1)
        if sync:
            self._drain_and_preempt(rp)
            self._reap(ident, rp)
        else:
            threading.Thread(target=self._drain_and_preempt, args=(rp,),
                             name=f"fleet-drain:{ident}",
                             daemon=True).start()
        return True

    def _drain_and_preempt(self, rp: ReplicaProcess) -> None:
        rt = self._router()
        key = rp.key()
        if rt is not None:
            try:
                rt.drain_replica(key)
                deadline = time.monotonic() + \
                    float(self.cfg.drain_deadline_ms) / 1e3
                while time.monotonic() < deadline:
                    info = rt.report().get(key) or {}
                    if not int(info.get("in_flight", 0)):
                        break  # settlement reached: nothing unsettled
                    time.sleep(0.02)
            except Exception:
                logger.warning("%s: drain of %s failed; preempting anyway",
                               self.name, rp.ident, exc_info=True)
        rp.preempt()

    def _retire_exit(self, ident: str, was: str) -> None:
        """Book one replica's exit into ``retired`` from whichever
        state it died in — the single place the identity's sink term is
        produced."""
        with self._lock:
            if was == SERVING:
                self.stats.add(replicas_serving=-1, replicas_retired=1)
            elif was == DRAINING:
                self.stats.add(replicas_draining=-1, replicas_retired=1)
            elif was == RESURRECTING:
                self.stats.add(replicas_resurrecting=-1,
                               replicas_retired=1)

    def _resurrect(self, ident: str, dead: ReplicaProcess) -> None:
        """Respawn an unexpectedly-dead replica from its snapshot at
        the same endpoint. Counts a NEW ``spawned`` in ``resurrecting``
        until the child reports ready."""
        rp = ReplicaProcess(self.spec, ident, port=dead.port,
                            version=dead.version, restore=True)
        with self._lock:
            self._replicas[ident] = rp
            self._state[ident] = RESURRECTING
            self.stats.add(replicas_spawned=1, replicas_resurrecting=1)
            self.stats.inc("resurrections")
        try:
            rp.spawn()
        except Exception:
            logger.warning("%s: resurrect spawn of %s failed", self.name,
                           ident, exc_info=True)
            with self._lock:
                self._state.pop(ident, None)
                self._replicas.pop(ident, None)
                self.stats.add(replicas_resurrecting=-1,
                               replicas_retired=1)

    def _reap(self, ident: str, rp: ReplicaProcess) -> None:
        """One replica process exited: settle its lifecycle state."""
        with self._lock:
            was = self._state.pop(ident, None)
            self._replicas.pop(ident, None)
        if was is None:
            return
        if was == SERVING and self.cfg.resurrect \
                and not self._stop_evt.is_set():
            # death while serving is NOT the scale-down path: book the
            # corpse retired, then resurrect as a fresh spawned unit
            self._retire_exit(ident, was)
            logger.warning("%s: replica %s died unexpectedly; "
                           "resurrecting from %s", self.name, ident,
                           rp.ckpt_dir)
            self._resurrect(ident, rp)
            return
        self._retire_exit(ident, was)

    # -- signals -----------------------------------------------------------
    def observe(self) -> Dict[str, float]:
        """One control-law input sample: worst per-replica p95 queue
        delay (PONG loads via the router), total reported depth, and —
        when ``metrics_url`` is set — the aggregate p95 from a
        ``/metrics`` scrape (max of the two wins: either signal over
        target means the fleet is late)."""
        p95_us = 0.0
        depth = 0
        rt = self._router()
        if rt is not None:
            try:
                for info in rt.report().values():
                    if info.get("state") not in ("healthy", "suspect"):
                        continue
                    load = info.get("load") or {}
                    d = load.get("queue_delay_us_p95",
                                 load.get("queue_delay_us_p50", 0.0))
                    p95_us = max(p95_us, float(d or 0.0))
                    depth += int(load.get("depth", 0) or 0)
                    depth += int(info.get("in_flight", 0) or 0)
            except Exception:
                logger.warning("%s: router report failed", self.name,
                               exc_info=True)
        if self.cfg.metrics_url:
            p95_us = max(p95_us, self._scrape_p95_us())
        with self._lock:
            serving = sum(1 for s in self._state.values() if s == SERVING)
            resurrecting = sum(1 for s in self._state.values()
                               if s == RESURRECTING)
        return {"p95_ms": p95_us / 1e3, "depth": float(depth),
                "serving": float(serving),
                "resurrecting": float(resurrecting)}

    def _scrape_p95_us(self) -> float:
        from ..obs.metrics import parse as parse_metrics
        from ..obs.server import scrape
        host, _, port = str(self.cfg.metrics_url).rpartition(":")
        try:
            text = scrape(host or "localhost", int(port))
        except (OSError, ValueError):
            return 0.0
        worst = 0.0
        for (mname, labels), val in parse_metrics(text).items():
            if mname == "nns_serve_queue_delay_us" \
                    and ("quantile", "p95") in labels:
                worst = max(worst, float(val))
        return worst

    # -- the control loop --------------------------------------------------
    def step(self, now: Optional[float] = None) -> Dict[str, float]:
        """One deterministic control-loop iteration: reap exits, sample
        signals, act. Public so tests drive the loop without the
        thread; returns the observation it acted on."""
        now = time.monotonic() if now is None else now
        with self._lock:
            snap = list(self._replicas.items())
        for ident, rp in snap:
            with self._lock:
                state = self._state.get(ident)
            if state == RESURRECTING and rp.ready() and rp.alive():
                with self._lock:
                    if self._state.get(ident) == RESURRECTING:
                        self._state[ident] = SERVING
                        self.stats.add(replicas_resurrecting=-1,
                                       replicas_serving=1)
                        logger.info("%s: replica %s resurrected and "
                                    "serving", self.name, ident)
            elif not rp.alive():
                self._reap(ident, rp)
        obs = self.observe()
        with self._lock:
            if self._hold > 0:
                return obs  # a rollout owns fleet shape right now
        cfg = self.cfg
        capacity = obs["serving"] + obs["resurrecting"]
        if obs["p95_ms"] > cfg.target_delay_ms \
                and capacity < cfg.max_replicas \
                and now - self._last_up >= cfg.scale_up_cooldown_s:
            with self._lock:
                self._last_up = now
                self.stats.inc("scale_ups")
            try:
                self.spawn_replica()
            except Exception:
                logger.warning("%s: scale-up failed", self.name,
                               exc_info=True)
        elif obs["p95_ms"] < cfg.low_water * cfg.target_delay_ms \
                and obs["depth"] == 0 \
                and obs["serving"] > cfg.min_replicas \
                and now - max(self._last_up, self._last_down) \
                >= cfg.scale_down_cooldown_s:
            victim = self._least_loaded_serving()
            if victim is not None:
                with self._lock:
                    self._last_down = now
                    self.stats.inc("scale_downs")
                logger.info("%s: scaling down: preempting %s", self.name,
                            victim)
                self.retire_replica(victim, sync=False)
        elif obs["serving"] < cfg.min_replicas and not obs["resurrecting"]:
            # floor repair (a retire raced a death, or startup shortfall)
            try:
                self.spawn_replica()
            except Exception:
                logger.warning("%s: floor-repair spawn failed", self.name,
                               exc_info=True)
        return obs

    def _least_loaded_serving(self) -> Optional[str]:
        rt = self._router()
        report = {}
        if rt is not None:
            try:
                report = rt.report()
            except Exception:
                report = {}

        def load_of(rp: ReplicaProcess) -> float:
            info = report.get(rp.key()) or {}
            load = info.get("load") or {}
            return (float(info.get("in_flight", 0) or 0)
                    + float(load.get("depth", 0) or 0))

        with self._lock:
            serving = [(ident, self._replicas[ident])
                       for ident, s in self._state.items() if s == SERVING]
        if not serving:
            return None
        return min(serving, key=lambda kv: load_of(kv[1]))[0]

    # -- thread lifecycle --------------------------------------------------
    def start(self) -> "Autoscaler":
        self._stop_evt.clear()
        for _ in range(int(self.cfg.min_replicas)):
            self.spawn_replica()
        self._thread = threading.Thread(target=self._loop,
                                        name=f"autoscaler:{self.name}",
                                        daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop_evt.wait(float(self.cfg.interval_s)):
            try:
                self.step()
            except Exception:
                logger.warning("%s: control step failed", self.name,
                               exc_info=True)

    def stop(self) -> None:
        """Quiesce the loop, then preempt every replica through the
        same drain-first scale-down path (identity holds at exit)."""
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        while True:
            with self._lock:
                idents = [i for i, s in self._state.items()
                          if s in (SERVING, RESURRECTING)]
            if not idents:
                break
            for ident in idents:
                with self._lock:
                    rp = self._replicas.get(ident)
                    state = self._state.get(ident)
                if rp is None:
                    continue
                if state == SERVING:
                    self.retire_replica(ident, sync=True)
                else:  # resurrecting: nothing to drain, just preempt
                    rp.preempt()
                    self._reap(ident, rp)
        # whatever is mid-drain on worker threads: wait for the exits
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            with self._lock:
                left = [(i, r) for i, r in self._replicas.items()]
            if not left:
                break
            for ident, rp in left:
                if not rp.alive():
                    self._reap(ident, rp)
            time.sleep(0.05)


@register_element("tensor_autoscaler")
class TensorAutoscaler(Element):
    """Elastic-fleet control element: owns an :class:`Autoscaler` that
    spawns/preempts subprocess replicas built from ``desc-template``,
    steering on the router element named by ``router`` and/or a
    ``metrics-url`` scrape. Pad-less — it is a control-plane element,
    not a dataflow one (launch it beside the router)::

        tensor_serve_router name=rt topic=fleet dest-port=4100
        tensor_autoscaler router=rt min-replicas=1 max-replicas=4
          target-delay-ms=50 desc-template="tensor_serve_src ..."
    """

    PROPS = {
        # the tensor_serve_router element (by name) whose PONG loads
        # feed the control law and whose drain_replica() settles
        # scale-downs; "" = metrics-url only
        "router": "",
        # fleet size bounds (lint rejects min > max)
        "min-replicas": 1, "max-replicas": 4,
        # p95 queue-delay ceiling the fleet defends, and the fraction
        # of it under which capacity is surplus
        "target-delay-ms": 50.0, "low-water": 0.3,
        # control-loop cadence and anti-flap cooldowns
        "interval-ms": 250.0, "scale-up-cooldown-ms": 1000.0,
        "scale-down-cooldown-ms": 3000.0,
        # settlement budget between drain_replica() and SIGTERM
        # (lint rejects <= 0)
        "drain-deadline-ms": 2000.0,
        # optional aggregate signal: "host:port" of a MetricsServer
        "metrics-url": "",
        # replica recipe: launch template ({port}/{ident}/{ckpt}/
        # {version}), snapshot root, preemption grace, compile cache
        "desc-template": "", "ckpt-root": "", "grace-s": 2.0,
        "compile-cache": "",
        # model/config version stamped on spawned replicas (blue/green
        # rollouts spawn the new version, then retire the old ring)
        "version": "",
        # resurrect unexpectedly-dead replicas from their snapshots
        "resurrect": True}

    # conservation identity flowcheck proves statically over this
    # package and check_identities() asserts over live snapshots
    SETTLEMENT_IDENTITY = ("fleet-replica-lifecycle",)

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.autoscaler: Optional[Autoscaler] = None

    def _router_element(self):
        pipe = getattr(self, "pipeline", None)
        if pipe is None or not str(self.router):
            return None
        return pipe.elements.get(str(self.router))

    def start(self) -> None:
        if str(self.desc_template):
            import tempfile
            ckpt_root = str(self.ckpt_root) or tempfile.mkdtemp(
                prefix=f"fleet-{self.name}-")
            spec = ReplicaSpec(
                desc_template=str(self.desc_template),
                ckpt_root=ckpt_root, grace_s=float(self.grace_s),
                compile_cache=str(self.compile_cache),
                version=str(self.version))
            cfg = AutoscalerConfig(
                min_replicas=int(self.min_replicas),
                max_replicas=int(self.max_replicas),
                target_delay_ms=float(self.target_delay_ms),
                low_water=float(self.low_water),
                interval_s=float(self.interval_ms) / 1e3,
                scale_up_cooldown_s=float(self.scale_up_cooldown_ms) / 1e3,
                scale_down_cooldown_s=(
                    float(self.scale_down_cooldown_ms) / 1e3),
                drain_deadline_ms=float(self.drain_deadline_ms),
                metrics_url=str(self.metrics_url),
                resurrect=bool(self.resurrect))
            self.autoscaler = Autoscaler(
                spec, router=self._router_element(), config=cfg,
                name=self.name, stats=self.stats)
            self.autoscaler.start()
        super().start()

    def stop(self) -> None:
        if self.autoscaler is not None:
            self.autoscaler.stop()
            self.autoscaler = None
        super().stop()

    def session_info(self) -> Dict:
        if self.autoscaler is None:
            return {}
        return {"replicas": self.autoscaler.replicas()}
