"""Command-line launcher: the gst-launch-1.0 / gst-inspect-1.0 analog.

Port of ``nnstreamer_tpu/__main__.py``. Run a pipeline description
until EOS (on the card unless a filter says ``accelerator=true:cpu``)::

    python -m nnstreamer_tpu_torch 'tensortestsrc caps="..." num-buffers=10 ! \\
        tensor_filter framework=torch-cuda model=zoo://mobilenet_v2 ! fakesink'

Introspection (≙ gst-inspect)::

    python -m nnstreamer_tpu_torch --inspect              # list all elements
    python -m nnstreamer_tpu_torch --inspect tensor_filter  # one element's props
    python -m nnstreamer_tpu_torch --inspect-filters      # filter backends

Static analysis (pipelint)::

    python -m nnstreamer_tpu_torch lint 'tensortestsrc ... ! fakesink'
    python -m nnstreamer_tpu_torch lint --json '<desc>'   # exit 0/1/2

Concurrency analysis (racecheck)::

    python -m nnstreamer_tpu_torch racecheck nnstreamer_tpu_torch/
    python -m nnstreamer_tpu_torch racecheck --json -o build/racecheck.json

Settlement / conservation analysis (flowcheck)::

    python -m nnstreamer_tpu_torch flowcheck nnstreamer_tpu_torch/ \
        --min-acquire-sites 10

Capture/host-sync analysis (jitcheck)::

    python -m nnstreamer_tpu_torch jitcheck nnstreamer_tpu_torch/ \
        --min-hot-sites 20

Each analyzer exits 0 clean, 1 on findings, 2 on a usage error.

Fleet telemetry (scrapes obs metrics endpoints into one table)::

    python -m nnstreamer_tpu_torch top --targets localhost:9100,localhost:9101
    python -m nnstreamer_tpu_torch top --broker localhost:5000 --watch 2

A standalone broker: ``--broker mqtt|discovery [--port N]``.
"""
from __future__ import annotations

import argparse
import json
import sys


def _inspect(name: str | None) -> int:
    from .pipeline.registry import element_names, get_element_class
    if not name:
        for n in element_names():
            print(n)
        return 0
    try:
        cls = get_element_class(name)
    except KeyError:
        print(f"no such element {name!r}", file=sys.stderr)
        return 1
    print(f"{name} ({cls.__module__}.{cls.__name__})")
    doc = (cls.__doc__ or "").strip().splitlines()
    if doc:
        print(f"  {doc[0]}")
    props = {}
    for klass in reversed(cls.__mro__):
        props.update(getattr(klass, "PROPS", {}))
    if props:
        print("  properties:")
        for k, v in sorted(props.items()):
            print(f"    {k:24} default={v!r}")
    for attr, label in (("SINK_TEMPLATES", "sink pads"),
                        ("SRC_TEMPLATES", "src pads")):
        tmpl = getattr(cls, attr, {})
        if tmpl:
            print(f"  {label}:")
            for pname, caps in tmpl.items():
                print(f"    {pname:24} {caps or 'ANY'}")
    return 0


def _inspect_filters() -> int:
    from .filters.registry import _FRAMEWORKS
    for n in sorted(_FRAMEWORKS):
        cls = _FRAMEWORKS[n]
        exts = ",".join(getattr(cls, "EXTENSIONS", ()))
        avail = "" if getattr(cls, "AVAILABLE", True) else "  [unavailable]"
        print(f"{n:20} {exts}{avail}")
    return 0


def _run_broker(kind: str, port: int, timeout: float | None) -> int:
    """Run a standalone broker process (the SSAT cross-process pattern:
    tests launch brokers/servers as real processes)."""
    import time
    if kind == "mqtt":
        from .edge.mqtt import MqttBroker
        broker = MqttBroker(port=port).start()
    else:
        from .edge.broker import DiscoveryBroker
        broker = DiscoveryBroker(port=port).start()
    print(f"broker {kind} listening on {broker.bound_port}", flush=True)
    try:
        deadline = time.monotonic() + timeout if timeout else None
        while deadline is None or time.monotonic() < deadline:
            time.sleep(0.2)
    except KeyboardInterrupt:
        pass
    finally:
        broker.stop()
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    if argv and argv[0] == "lint":
        from .analysis.cli import main as lint_main
        return lint_main(argv[1:])
    if argv and argv[0] == "racecheck":
        from .analysis.concurrency.cli import main as racecheck_main
        return racecheck_main(argv[1:])
    if argv and argv[0] == "flowcheck":
        from .analysis.flow.cli import main as flowcheck_main
        return flowcheck_main(argv[1:])
    if argv and argv[0] == "jitcheck":
        from .analysis.jit.cli import main as jitcheck_main
        return jitcheck_main(argv[1:])
    if argv and argv[0] == "top":
        from .obs.top import main as top_main
        return top_main(argv[1:])
    ap = argparse.ArgumentParser(
        prog="python -m nnstreamer_tpu_torch",
        description="Launch a tensor pipeline (gst-launch analog).")
    ap.add_argument("pipeline", nargs="?", help="pipeline description")
    ap.add_argument("--timeout", type=float, default=None,
                    help="seconds to wait for EOS (default: forever)")
    ap.add_argument("--trace", action="store_true",
                    help="print the tracing report at exit")
    ap.add_argument("--stats", action="store_true",
                    help="print per-element stats at exit")
    ap.add_argument("--inspect", nargs="?", const="", metavar="ELEMENT",
                    help="list elements, or one element's properties")
    ap.add_argument("--inspect-filters", action="store_true",
                    help="list filter backends")
    ap.add_argument("--broker", choices=("mqtt", "discovery"),
                    help="run a standalone broker instead of a pipeline "
                         "(mqtt = MQTT 3.1.1 data broker, discovery = "
                         "query HYBRID registry)")
    ap.add_argument("--port", type=int, default=0,
                    help="broker port (0 = ephemeral, printed to stdout)")
    args = ap.parse_args(argv)

    if args.inspect is not None:
        return _inspect(args.inspect or None)
    if args.inspect_filters:
        return _inspect_filters()
    if args.broker:
        return _run_broker(args.broker, args.port, args.timeout)
    if not args.pipeline:
        ap.print_usage()
        return 2

    from . import parse_launch
    pipe = parse_launch(args.pipeline)
    tracer = pipe.enable_tracing() if args.trace else None
    try:
        pipe.start()
        ok = pipe.wait_eos(args.timeout)
        if not ok:
            print("timeout waiting for EOS", file=sys.stderr)
    except KeyboardInterrupt:
        print("interrupted", file=sys.stderr)
    finally:
        pipe.stop()
    err = [m for m in pipe.bus.drain() if m.kind == "error"]
    for m in err:
        print(f"ERROR: {m.data.get('element')}: {m.data.get('error')}",
              file=sys.stderr)
    if args.stats:
        print(json.dumps(pipe.stats(), indent=2, default=str))
    if tracer is not None:
        print(json.dumps(tracer.report(pipe), indent=2, default=str))
    return 1 if err else 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:   # e.g. `--inspect | head`
        sys.exit(0)
