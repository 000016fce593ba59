"""flowcheck's static half in the port (``nnstreamer_tpu_torch/analysis/
flow``) against the JAX package's, on the CPU.

* Every test of ``tests/test_flowcheck.py`` runs with its analyzer calls
  going through both packages (tests/torch_analyzer_parity.py): the
  findings agree rule, file, line and message, and the test's own
  assertions hold on the port's report.
* Both analyzers agree over both trees.
* The gate (``--min-acquire-sites 10``) is clean on the port, and its
  coverage is real: the port's acquire sites, ownership markers and
  declared identities are modeled as the JAX package's are, and a
  settle taken out of a copy of a port module is reported as a leak.
"""
import subprocess
import sys
from pathlib import Path

import pytest

import torch_analyzer_parity as parity
from nnstreamer_tpu.analysis import flow as nt_flow
from nnstreamer_tpu.analysis.flow.cli import main as nt_main
from nnstreamer_tpu_torch.analysis import flow as pt_flow
from nnstreamer_tpu_torch.analysis.flow.cli import main as pt_main

ROOT = Path(__file__).resolve().parents[1]
PORT_DIR = ROOT / "nnstreamer_tpu_torch"
JAX_DIR = ROOT / "nnstreamer_tpu"

JAX_TESTS = parity.load("test_flowcheck")
CASES = parity.cases(JAX_TESTS)


def _same_report(ref, got):
    assert parity.findings_of(got) == parity.findings_of(ref)
    assert (got.acquire_sites, got.identities_checked, got.num_files,
            got.num_functions) == (ref.acquire_sites,
                                   ref.identities_checked, ref.num_files,
                                   ref.num_functions)
    assert got.exit_code == ref.exit_code


def test_corpus_cases_cover_the_jax_module():
    assert len(CASES) >= 33


@pytest.mark.parametrize("case", CASES, ids=[c.id for c in CASES])
def test_jax_corpus_through_both_analyzers(case, tmp_path, capsys,
                                           monkeypatch):
    parity.run(JAX_TESTS, case, {"tmp_path": tmp_path, "capsys": capsys},
               {"analyze_paths": parity.twin(nt_flow.analyze_paths,
                                             pt_flow.analyze_paths,
                                             _same_report),
                "flowcheck_main": parity.twin_main(nt_main, pt_main)},
               monkeypatch)


@pytest.fixture(scope="module")
def port_report():
    return pt_flow.analyze_paths([str(PORT_DIR)], min_acquire_sites=10)


@pytest.mark.parametrize("tree", ["nnstreamer_tpu", "nnstreamer_tpu_torch"])
def test_both_packages_agree_over_both_trees(tree, port_report):
    ref = nt_flow.analyze_paths([str(ROOT / tree)], min_acquire_sites=10)
    got = port_report if tree == "nnstreamer_tpu_torch" \
        else pt_flow.analyze_paths([str(ROOT / tree)],
                                   min_acquire_sites=10)
    _same_report(ref, got)


def test_gate_is_clean_on_the_port(port_report):
    """``python -m nnstreamer_tpu_torch flowcheck nnstreamer_tpu_torch
    --min-acquire-sites 10`` exits 0."""
    assert port_report.findings == [], port_report.to_text()
    r = subprocess.run([sys.executable, "-m", "nnstreamer_tpu_torch",
                        "flowcheck", "nnstreamer_tpu_torch",
                        "--min-acquire-sites", "10", "-q"],
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def _modules_with_acquires(tree: Path) -> set:
    return {str(p.relative_to(tree)) for p in sorted(tree.rglob("*.py"))
            if pt_flow.scan_paths([str(p)]).acquire_sites}


def test_coverage_matches_the_jax_package(port_report):
    """Not a vacuous pass: every module of the JAX package whose acquire
    sites flowcheck models has its port counterpart modeled too (the
    port adds the mesh world's), and both check the same declared
    identities."""
    ref = nt_flow.analyze_paths([str(JAX_DIR)])
    assert port_report.acquire_sites >= 10
    jax_modules = _modules_with_acquires(JAX_DIR)
    port_modules = _modules_with_acquires(PORT_DIR)
    assert len(jax_modules) >= 9
    assert jax_modules <= port_modules, jax_modules - port_modules
    assert set(port_report.identities_checked) == \
        set(ref.identities_checked)
    assert len(port_report.identities_checked) >= 5


# (port module, the settle taken out of a copy of it): each copy must
# come back with a leak in that module
MUTATIONS = [
    ("fusion/segment.py",
     "                self._overlap.window.release(t_disp)\n"
     "                raise\n",
     "                raise\n"),
    ("elements/filter.py",
     "            self._overlap.window.release(t_disp)\n",
     "            pass\n"),
]


@pytest.mark.parametrize("rel,settle,without", MUTATIONS,
                         ids=[m[0] for m in MUTATIONS])
def test_a_dropped_settle_in_a_port_module_is_a_leak(rel, settle, without,
                                                     tmp_path):
    source = (PORT_DIR / rel).read_text()
    assert settle in source
    clean = tmp_path / "clean" / Path(rel).name
    clean.parent.mkdir()
    clean.write_text(source)
    assert pt_flow.analyze_paths([str(clean)]).findings == []
    broken = tmp_path / "broken" / Path(rel).name
    broken.parent.mkdir()
    broken.write_text(source.replace(settle, without, 1))
    report = pt_flow.analyze_paths([str(broken)])
    assert report.findings, report.to_text()
    assert {(f.rule, f.resource) for f in report.findings} == \
        {(pt_flow.LEAK, "window-slot")}, report.to_text()
    assert report.exit_code == 1
