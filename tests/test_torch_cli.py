"""``python -m nnstreamer_tpu_torch`` — the port's launcher — against the
JAX package's, on the CPU.

Runs tests/test_cli.py's cases against the port's module: the element
list (exactly the JAX package's),
one element's properties, the filter backends, a launched line's stats,
an error's exit code, ``lint`` with the JAX package's exit code for the
same line (0 clean, 1 warnings, 2 errors and parse failures) and its
JSON; then the port's own: ``top`` against a port and a JAX endpoint,
the standalone broker, ``--trace``, and the code analyzers (racecheck,
flowcheck and jitcheck over the port at the JAX Makefile's thresholds,
exit 0). Every launched line runs on the CPU.
"""
import json
import os
import subprocess
import sys

import pytest

from nnstreamer_tpu.analysis.cli import main as nt_lint_main
from nnstreamer_tpu.obs.server import MetricsServer as NtMetricsServer
from nnstreamer_tpu.pipeline.registry import _ELEMENTS as NT_ELEMENTS
from nnstreamer_tpu_torch.filters.registry import _FRAMEWORKS
from nnstreamer_tpu_torch.obs.server import MetricsServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# every element of the JAX package is ported
NOT_PORTED_ELEMENTS = set()
CAPS8 = ('"other/tensors,format=static,num_tensors=1,'
         'types=(string)float32,dimensions=(string)8"')
LINT_CAPS = ('"other/tensors,format=static,num_tensors=1,'
             'types=(string)uint8,dimensions=(string)3:4:4,'
             'framerate=(fraction)0/1"')


def run_cli(*args, timeout=120):
    env = dict(os.environ, NNS_TPU_FLIGHT_DIR="")
    return subprocess.run(
        [sys.executable, "-m", "nnstreamer_tpu_torch", *args],
        capture_output=True, text=True, timeout=timeout, cwd=REPO, env=env)


def test_inspect_lists_elements():
    r = run_cli("--inspect")
    assert r.returncode == 0
    names = r.stdout.split()
    assert "tensor_filter" in names and "tensor_autoscaler" in names
    # the JAX package's own elements (test modules register more)
    reference = {n for n, cls in NT_ELEMENTS.items()
                 if cls.__module__.startswith("nnstreamer_tpu.")}
    assert set(names) == reference - NOT_PORTED_ELEMENTS


def test_inspect_one_element():
    r = run_cli("--inspect", "tensor_filter")
    assert r.returncode == 0
    assert "framework" in r.stdout
    assert "model" in r.stdout


def test_inspect_unknown_element():
    assert run_cli("--inspect", "nope_element").returncode == 1


def test_inspect_filters():
    r = run_cli("--inspect-filters")
    assert r.returncode == 0
    assert [line.split()[0] for line in r.stdout.splitlines()] == \
        sorted(n for n, cls in _FRAMEWORKS.items()
               if cls.__module__.startswith("nnstreamer_tpu_torch."))
    assert "torch-cuda" in r.stdout and "pytorch" in r.stdout


def test_launch_pipeline_with_stats():
    r = run_cli("--stats",
                f"tensortestsrc caps={CAPS8} num-buffers=4 "
                "! queue ! fakesink", timeout=180)
    assert r.returncode == 0, r.stderr
    stats = json.loads(r.stdout)
    sink = [v for k, v in stats.items() if k.startswith("fakesink")][0]
    assert sink["buffers"] == 4


def test_launch_filter_on_the_cpu_with_stats():
    r = run_cli("--stats",
                'tensortestsrc caps="other/tensors,format=static,'
                'num_tensors=1,types=(string)float32,dimensions=(string)64" '
                "num-buffers=3 ! tensor_filter name=f framework=torch-cuda "
                "accelerator=true:cpu model=zoo://mlp?dtype=float32 "
                "! fakesink", timeout=180)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout)["f"]["buffers"] == 3


def test_launch_error_exit_code():
    r = run_cli(f"tensortestsrc caps={CAPS8} num-buffers=1 "
                "! tensor_filter framework=custom-easy model=missing "
                "! fakesink", timeout=180)
    assert r.returncode != 0


def test_trace_prints_the_report():
    r = run_cli("--trace", f"tensortestsrc name=src caps={CAPS8} "
                "num-buffers=3 ! queue name=q ! fakesink name=out")
    assert r.returncode == 0, r.stderr
    rep = json.loads(r.stdout)
    assert rep["out"]["buffers"] == 3 and rep["q"]["queue_level"] == 0


@pytest.mark.parametrize("args,code,text", [
    (["lint", f"tensortestsrc caps={LINT_CAPS} "
      "! tensor_converter ! appsink name=out"], 0,
     "0 error(s), 0 warning(s)"),
    (["lint",  # pipelint: skip — tee branch without a queue
      f"tensortestsrc caps={LINT_CAPS} ! tee name=t "
      "! fakesink t. ! queue ! fakesink"], 1, "t.src_0"),
    (["lint",  # pipelint: skip — intentional caps contradiction
      f"tensortestsrc caps={LINT_CAPS} "
      "! other/tensors,format=sparse ! fakesink"], 2, "caps-inference"),
    (["lint", "tensortestsrc caps=x !"], 2, "dangling '!'"),
    (["lint",  # pipelint: skip — floor above the ceiling
      "tensor_autoscaler name=a router=rt min-replicas=5 "
      "max-replicas=2"], 2, "autoscaler-config"),
], ids=["clean", "warned", "defective", "parse", "autoscaler"])
def test_lint_exit_codes_equal_the_reference(args, code, text):
    r = run_cli(*args)
    assert r.returncode == code, r.stdout + r.stderr
    assert text in r.stdout
    assert nt_lint_main(["--quiet", args[1]]) == code


def test_lint_json_output():
    r = run_cli(  # pipelint: skip — tee branch without a queue
        "lint", "--json", f"tensortestsrc caps={LINT_CAPS} ! tee name=t "
        "! fakesink t. ! queue ! fakesink")
    assert r.returncode == 1
    data = json.loads(r.stdout)
    assert data["exit_code"] == 1
    assert any(f["rule"] == "tee-no-queue" and f["location"] == "t.src_0"
               for f in data["findings"])


@pytest.mark.parametrize("tool,flags", [
    ("racecheck", []),
    ("flowcheck", ["--min-acquire-sites", "10"]),
    ("jitcheck", ["--min-hot-sites", "20"]),
])
def test_unported_analyzers_say_so_and_exit_2(tool, flags):
    """The analyzers this launcher once refused (exit 2, "not ported")
    now run: each gate exits 0 over the port's own tree."""
    r = run_cli(tool, "nnstreamer_tpu_torch/", *flags)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "not ported" not in r.stdout + r.stderr
    assert f"{tool}: 0 finding(s)" in r.stdout


def test_top_reads_a_port_and_a_jax_endpoint():
    ours = MetricsServer(port=0).start()
    theirs = NtMetricsServer(port=0).start()
    try:
        r = run_cli("top", "--json", "--targets",
                    f"localhost:{ours.bound_port},"
                    f"localhost:{theirs.bound_port}")
        assert r.returncode == 0, r.stderr
        rows = json.loads(r.stdout)
        assert [row["endpoint"] for row in rows] == \
            [f"localhost:{ours.bound_port}",
             f"localhost:{theirs.bound_port}"]
        r = run_cli("top", "--targets", f"localhost:{ours.bound_port}")
        assert r.stdout.splitlines()[0].startswith("ENDPOINT")
        assert ours.scrapes == 2 and theirs.scrapes == 1
    finally:
        ours.stop()
        theirs.stop()


def test_standalone_broker():
    r = run_cli("--broker", "discovery", "--port", "0", "--timeout", "0.5")
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("broker discovery listening on ")
