"""``python -m nnstreamer_tpu_torch flowcheck`` — the settlement lint CLI.

    flowcheck [paths...] [--json] [-o FILE] [-q] [-v]
              [--min-acquire-sites N]

Scans the given files/directories (default: the installed
``nnstreamer_tpu_torch`` package) and reports leak, double-settle,
missing-declared-loss, and identity-break findings. Exit codes:
0 clean, 1 findings, 2 usage error.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Optional

from .passes import analyze_paths

USAGE_ERROR = 2


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="nnstreamer_tpu_torch flowcheck",
        description="static settlement & resource-conservation "
                    "analyzer (acquire/settle leaks, double-settles, "
                    "undeclared losses, identity breaks) for the "
                    "zero-loss accounting model")
    ap.add_argument("paths", nargs="*",
                    help="files or directories to scan (default: the "
                         "nnstreamer_tpu_torch package)")
    ap.add_argument("--json", action="store_true",
                    help="emit machine-readable findings")
    ap.add_argument("-o", "--output", metavar="FILE",
                    help="also write the report (JSON) to FILE")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="suppress output; exit code only")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="list suppressed findings too")
    ap.add_argument("--min-acquire-sites", type=int, default=0,
                    metavar="N",
                    help="fail unless at least N acquire sites are "
                         "modeled (vacuous-coverage guard; default 0)")
    try:
        opts = ap.parse_args(argv)
    except SystemExit as exc:
        # argparse exits 2 on bad flags and 0 on --help: keep both
        return int(exc.code or 0) and USAGE_ERROR

    paths = opts.paths or [str(Path(__file__).resolve().parents[2])]
    for p in paths:
        if not Path(p).exists():
            print(f"flowcheck: no such path: {p}", file=sys.stderr)
            return USAGE_ERROR

    report = analyze_paths(paths,
                           min_acquire_sites=opts.min_acquire_sites)

    if opts.output:
        out = Path(opts.output)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(report.to_json() + "\n", encoding="utf-8")
    if not opts.quiet:
        print(report.to_json() if opts.json
              else report.to_text(verbose=opts.verbose))
    return report.exit_code


if __name__ == "__main__":
    raise SystemExit(main())
