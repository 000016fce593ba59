"""Fleet replica child entry: one serve pipeline per process.

Port of ``nnstreamer_tpu/fleet/replica_main.py``::

    python -m nnstreamer_tpu_torch.fleet.replica_main --desc '...' --ckpt DIR

builds the pipeline from a launch description, optionally restores it
from its snapshot directory (the resurrect path), installs the SIGTERM
:class:`~..fault.preempt.PreemptGuard` (preemptible by default — the
autoscaler's scale-down IS a preemption), and parks. The parent-side
:class:`~.replica.ReplicaProcess` drives it entirely through the
process boundary:

* stdout markers — ``replica-ready port=N pid=P`` once serving, and
  ``replica-preempted {json report}`` as the guard's last words, so the
  parent can audit the exact drain/abandoned accounting of every
  scale-down;
* signals — SIGTERM is the one and only scale-down/rollout verb.

The ``--compile-cache`` directory (or an inherited ``NNS_COMPILE_CACHE``
env) installs the fleet's persistent compile cache before the pipeline
is built, so the filter captures its recorded signatures (an eager run
and a CUDA-graph capture each) at open, before the serve src REGISTERs
on the broker — readiness means *warm*.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _bound_port(pipe) -> int:
    for elem in pipe.elements.values():
        port = getattr(elem, "bound_port", None)
        if port:
            return int(port)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="nnstreamer_tpu_torch.fleet.replica_main",
        description="one fleet replica: launch, serve, preempt on SIGTERM")
    ap.add_argument("--desc", required=True,
                    help="pipeline launch description")
    ap.add_argument("--ckpt", required=True,
                    help="snapshot directory (PreemptGuard target; "
                         "--restore resurrects from it)")
    ap.add_argument("--grace-s", type=float, default=2.0,
                    help="preemption grace budget (drain + snapshot)")
    ap.add_argument("--restore", action="store_true",
                    help="restore from the latest snapshot before start")
    ap.add_argument("--compile-cache", default="",
                    help="persistent compile cache root (also inherited "
                         "via NNS_COMPILE_CACHE)")
    ap.add_argument("--prelude", default="",
                    help="python snippet run before parse_launch (e.g. "
                         "register_custom_easy for test filters, or an "
                         "atexit hook that prints counters)")
    args = ap.parse_args(argv)

    if args.compile_cache:
        from . import cache
        cache.install(args.compile_cache)
    if args.prelude:
        # the autoscaler owns both ends of this string; it exists so
        # tests can register custom-easy filters inside the child
        exec(compile(args.prelude, "<replica-prelude>", "exec"), {})

    from .. import parse_launch
    from ..fault.preempt import install_sigterm

    pipe = parse_launch(args.desc)
    if args.restore:
        try:
            pipe.restore(args.ckpt)
        except Exception as exc:  # no/bad snapshot: cold start, say so
            print(f"replica-restore-skipped {exc!r}", flush=True)

    def last_words(report) -> None:
        # machine-readable settlement accounting for the parent: the
        # chaos arm asserts drained/abandoned against router settlement
        print("replica-preempted " + json.dumps(report or {}), flush=True)

    install_sigterm(pipe, args.ckpt, grace_s=float(args.grace_s),
                    exit_code=0, on_done=last_words)
    pipe.start()
    print(f"replica-ready port={_bound_port(pipe)} pid={os.getpid()}",
          flush=True)
    try:
        while True:
            time.sleep(1.0)
    except KeyboardInterrupt:
        pipe.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
