"""Runs a JAX analyzer test module through both packages' analyzers.

``tests/test_racecheck.py`` and ``tests/test_flowcheck.py`` hold every
source corpus of racecheck and flowcheck, inline or as module constants,
each with the assertions that pin its findings. :func:`cases` lists
their tests; :func:`run` runs one of them with the module's analyzer
entry points (``analyze_paths``, ``find_cycles``, the CLI ``main``)
replaced by twins: each twin runs the JAX analyzer and the port's on
the same input, asserts that the two agree — every finding's rule,
file, line and message, the suppressions and the report's counters —
and hands the PORT's result to the test's own assertions. The module is
loaded under a private name; pytest collects the original as usual.
"""
from __future__ import annotations

import contextlib
import importlib.util
import inspect
import io
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

TESTS = Path(__file__).resolve().parent


def load(name: str):
    """``tests/<name>.py`` as a fresh module."""
    spec = importlib.util.spec_from_file_location(
        f"_parity_{name}", TESTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass(frozen=True)
class Case:
    cls: Optional[str]
    name: str

    @property
    def id(self) -> str:
        return f"{self.cls}.{self.name}" if self.cls else self.name


def cases(mod) -> List[Case]:
    """Every test of ``mod``: its ``Test*`` classes' ``test_*`` methods
    and its ``test_*`` functions, in source order."""
    out: List[Case] = []
    for name, obj in vars(mod).items():
        if name.startswith("Test") and inspect.isclass(obj):
            for meth in vars(obj):
                if meth.startswith("test_"):
                    out.append(Case(name, meth))
        elif name.startswith("test_") and inspect.isfunction(obj):
            out.append(Case(None, name))
    return out


def run(mod, case: Case, fixtures: Dict[str, Any],
        twins: Dict[str, Callable], monkeypatch) -> None:
    """Run one test of ``mod`` with ``twins`` patched over its names."""
    for name, fn in twins.items():
        monkeypatch.setattr(mod, name, fn)
    owner = getattr(mod, case.cls)() if case.cls else mod
    fn = getattr(owner, case.name)
    kwargs = {p: fixtures[p] for p in inspect.signature(fn).parameters}
    fn(**kwargs)


def twin(ref_fn: Callable, port_fn: Callable,
         same: Callable[[Any, Any], None]) -> Callable:
    """``port_fn`` checked against ``ref_fn`` on every call."""
    def both(*args, **kwargs):
        ref = ref_fn(*args, **kwargs)
        got = port_fn(*args, **kwargs)
        same(ref, got)
        return got
    return both


def _norm(text: str) -> str:
    """A usage message without the package's name and argparse's line
    wrapping, which follows the name's length."""
    return " ".join(text.replace("nnstreamer_tpu_torch",
                                 "nnstreamer_tpu").split())


def twin_main(ref_main: Callable, port_main: Callable) -> Callable:
    """A CLI ``main`` that runs both packages' CLIs on the same argv:
    the exit codes, the printed reports and any ``-o`` file must agree
    (up to the package's name in usage lines); the port's output is
    what the caller sees."""
    def main(argv):
        argv = list(argv)
        out_file = None
        if "-o" in argv:
            out_file = Path(argv[argv.index("-o") + 1])
        outs = []
        errs = []
        files = []
        codes = []
        for fn in (ref_main, port_main):
            out, err = io.StringIO(), io.StringIO()
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                codes.append(fn(list(argv)))
            outs.append(out.getvalue())
            errs.append(err.getvalue())
            files.append(out_file.read_text()
                         if out_file is not None and out_file.exists()
                         else None)
        assert codes[0] == codes[1], (argv, codes)
        assert outs[0] == outs[1], (argv, outs)
        assert _norm(errs[0]) == _norm(errs[1]), (argv, errs)
        assert files[0] == files[1], (argv, files)
        sys.stdout.write(outs[1])
        sys.stderr.write(errs[1])
        return codes[1]
    return main


def findings_of(report) -> tuple:
    return ([f.to_dict() for f in report.findings],
            [f.to_dict() for f in report.suppressed])
