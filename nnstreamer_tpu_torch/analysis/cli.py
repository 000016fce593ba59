"""The pipelint CLI::

    python -m nnstreamer_tpu_torch.analysis.cli "<description>" [--json]

Port of ``nnstreamer_tpu/analysis/cli.py``. Exit codes: 0 clean (info
only), 1 warnings, 2 errors (parse failures included). ``--json``
switches the report to machine-readable output. Nothing is started, so
no model is opened and the card is not touched.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from .findings import Finding, Report, Severity


def lint_description(desc: str) -> Report:
    """Parse + analyze one launch description without starting it."""
    from .. import parse_launch  # full package: registers every element
    from .rules import analyze
    try:
        pipe = parse_launch(desc)
    except ValueError as exc:
        return Report(findings=[Finding(
            "parse", Severity.ERROR, str(exc))])
    return analyze(pipe)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m nnstreamer_tpu_torch.analysis.cli",
        description="Statically analyze a pipeline description: caps/"
                    "shape/dtype inference plus graph lint rules. "
                    "Nothing is executed.")
    ap.add_argument("description", help="gst-launch-style pipeline string")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report on stdout")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress output; exit code only")
    args = ap.parse_args(argv)
    report = lint_description(args.description)
    if not args.quiet:
        print(report.to_json() if args.json else report.to_text())
    return report.exit_code


if __name__ == "__main__":
    sys.exit(main())
