"""Zero-downtime blue/green rollouts over the autoscaler's fleet.

A copy of ``nnstreamer_tpu/fleet/rollout.py``.

A rollout replaces the serving ring with replicas on a new model
version without ever dropping below the starting capacity and without
losing a frame:

1. **surge**: spawn one replica on the new version (the compile cache
   and ``--restore``-free cold path; ``wait_ready`` + routability mean
   it is warm and dialed before anything is taken away);
2. **steer**: ``drain_replica()`` one old-version replica — the
   consistent-hash ring drops it, so its affinity sessions remap to
   survivors (which now include green capacity) while its in-flight
   requests settle normally;
3. **retire**: preempt the drained replica (SIGTERM → snapshot →
   exit 0) and repeat until no old-version replica serves.

Throughout, the router settlement identity
``router_requests == delivered + shed + orphaned`` keeps holding (the
rollout only uses drain + preempt, both settlement-preserving), and the
fleet's ``replicas_spawned == serving + draining + retired +
resurrecting`` identity books every replacement — the chaos tests and
``chip_smoke.py``'s fleet phase assert both via :func:`~..analysis.flow.runtime.check_identities`.
"""
from __future__ import annotations

import time
from typing import Dict

from ..utils.log import logger
from .autoscaler import SERVING, Autoscaler


class BlueGreenRollout:
    """One fleet-wide version swap, driven step-by-step."""

    def __init__(self, autoscaler: Autoscaler, version: str,
                 routable_timeout_s: float = 30.0):
        self.autoscaler = autoscaler
        self.version = str(version)
        self.routable_timeout_s = float(routable_timeout_s)

    # -- helpers -----------------------------------------------------------
    def _old_serving(self) -> list:
        auto = self.autoscaler
        out = []
        with auto._lock:
            for ident, state in auto._state.items():
                rp = auto._replicas.get(ident)
                if state == SERVING and rp is not None \
                        and rp.version != self.version:
                    out.append(ident)
        return sorted(out)

    def _wait_routable(self, ident: str) -> None:
        """Block until the router holds a healthy link to the new
        replica — green capacity must be *dispatchable* before any blue
        capacity drains (the zero-downtime invariant)."""
        auto = self.autoscaler
        rt = auto._router()
        rp = auto.handle(ident)
        if rt is None or rp is None:
            return
        deadline = time.monotonic() + self.routable_timeout_s
        while time.monotonic() < deadline:
            info = rt.report().get(rp.key()) or {}
            if info.get("state") == "healthy":
                return
            time.sleep(0.05)
        raise TimeoutError(
            f"rollout: green replica {ident} ({rp.key()}) never became "
            f"routable")

    # -- the swap ----------------------------------------------------------
    def run(self) -> Dict:
        """Replace every old-version serving replica, one surge-and-
        retire round at a time. Returns ``{"version", "replaced",
        "spawned"}``."""
        auto = self.autoscaler
        replaced = 0
        spawned = []
        with auto.hold_scaling():
            # the surge replica must not read as scale-down surplus
            for old_ident in self._old_serving():
                green = auto.spawn_replica(version=self.version)
                spawned.append(green)
                self._wait_routable(green)
                ok = auto.retire_replica(old_ident, sync=True)
                logger.info("rollout %s: %s -> %s (%s)", self.version,
                            old_ident, green,
                            "retired" if ok else "missed")
                replaced += 1 if ok else 0
        auto.stats.inc("rollouts")
        return {"version": self.version, "replaced": replaced,
                "spawned": spawned}


def rollout(autoscaler: Autoscaler, version: str,
            routable_timeout_s: float = 30.0) -> Dict:
    """Convenience wrapper: run one blue/green swap to ``version``."""
    return BlueGreenRollout(
        autoscaler, version,
        routable_timeout_s=routable_timeout_s).run()
