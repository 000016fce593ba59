#!/usr/bin/env python
"""Run the port's pipelint over every pipeline description in the corpus.

The port of ``tools/lint_corpus.py``. The descriptions are the string
literals of ``tests/*.py`` and the code blocks of ``README.md`` and
``Documentation/tutorials/*.md``, read by
:mod:`nnstreamer_tpu_torch.analysis.corpus` (a literal marked
``# pipelint: skip`` is left out), each with its JAX frameworks
rewritten to ``torch-cuda``; every one is linted, as the JAX gate lints
every one. Strings that do not parse as pipelines are skipped and
counted: most literals in the tests are not pipelines at all.

    python3 tools/torch_lint_corpus.py [-v] [--json] [paths ...]

Static: nothing is started, so it needs no card. Exit status 1 if any
description has an error-severity finding, else 0. ``--json`` prints
the result as one JSON line last.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from nnstreamer_tpu_torch.analysis import Severity, analyze  # noqa: E402
from nnstreamer_tpu_torch.analysis.corpus import collect, to_port  # noqa: E402
from nnstreamer_tpu_torch.pipeline.parser import parse_launch  # noqa: E402


def run(paths: Optional[List[Path]] = None, verbose: bool = False) -> Dict:
    """The lint over the corpus; the result as a dict (``rc``, counts,
    ``failures``, ``seconds``)."""
    t0 = time.perf_counter()
    linted = skipped = warned = 0
    failures: List[str] = []
    for where, desc in collect(paths, tutorials=True):
        desc = to_port(desc)
        try:
            pipe = parse_launch(desc)
        except ValueError:
            skipped += 1  # extracted literal is not a real pipeline
            continue
        report = analyze(pipe)
        linted += 1
        if verbose:
            print(f"-- {where}: {desc}")
        for f in report.findings:
            if f.severity >= Severity.ERROR:
                failures.append(f"{where}: {f}\n    {desc}")
            elif f.severity >= Severity.WARNING:
                warned += 1
                if verbose:
                    print(f"   {f}")
    return {"gate": "lint-corpus", "rc": 1 if failures else 0,
            "linted": linted, "skipped": skipped, "warnings": warned,
            "errors": len(failures), "failures": failures,
            "seconds": time.perf_counter() - t0}


def summary(res: Dict) -> str:
    return (f"pipelint corpus: {res['linted']} descriptions linted, "
            f"{res['skipped']} non-pipeline strings skipped, "
            f"{res['warnings']} warnings, {res['errors']} errors")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*", help="files to scan (default: "
                    "tests/*.py, README.md and Documentation/tutorials)")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="print every linted description")
    ap.add_argument("--json", action="store_true",
                    help="print the result as one JSON line last")
    opts = ap.parse_args(argv)
    res = run([Path(p) for p in opts.paths] or None, opts.verbose)
    for line in res["failures"]:
        print(line)
    print(summary(res))
    if opts.json:
        print(json.dumps(res))
    return res["rc"]


if __name__ == "__main__":
    raise SystemExit(main())
