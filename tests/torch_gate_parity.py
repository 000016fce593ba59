"""Shared by the gate tests (``tests/test_torch_gate_*.py``): load a gate
tool by path, start a port gate in a fresh interpreter (as ``make`` runs
a gate: no element another test module registered, no mesh world
another left) while the JAX package's per-description gate runs here
over the same corpus, keyed by description."""
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from nnstreamer_tpu_torch.analysis import corpus

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def flight_dir(tmp_path_factory):
    """Flight dumps of the corpus lines that abort (either package's
    recorder) go to a temporary directory, not into the checkout."""
    old = os.environ.get("NNS_TPU_FLIGHT_DIR")
    os.environ["NNS_TPU_FLIGHT_DIR"] = str(tmp_path_factory.mktemp("flight"))
    yield
    if old is None:
        os.environ.pop("NNS_TPU_FLIGHT_DIR", None)
    else:
        os.environ["NNS_TPU_FLIGHT_DIR"] = old


def tool(name):
    """``tools/<name>.py`` as a module (the tools are scripts, not a
    package)."""
    spec = importlib.util.spec_from_file_location(
        f"_gate_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_devices():
    """The JAX package's device count in this process (conftest.py's 8
    virtual CPU devices): the port gates' mesh lines get as many ranks."""
    import jax
    return jax.device_count()


def start_tool(name, *args, host_devices=1):
    """``tools/<name>.py args...`` in a fresh interpreter, its output
    piped; ``host_devices`` > 1 first sets the port's host pool (a mesh
    line's gloo ranks), as the JAX lines get conftest.py's devices."""
    path = str(ROOT / "tools" / f"{name}.py")
    code = (f"import runpy, sys\nsys.argv = [{path!r}, *{list(args)!r}]\n"
            f"runpy.run_path({path!r}, run_name='__main__')\n")
    if host_devices > 1:
        code = ("from nnstreamer_tpu_torch.parallel.mesh import "
                f"set_host_devices\nset_host_devices({int(host_devices)})\n"
                + code)
    return subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def finish(proc, timeout=1200):
    """(exit code, stdout, stderr) of a started tool."""
    out, err = proc.communicate(timeout=timeout)
    return proc.returncode, out, err


def json_result(proc, timeout=1200):
    """A started gate's ``--json`` result, with its exit code as
    ``exit``."""
    code, out, err = finish(proc, timeout)
    lines = out.strip().splitlines()
    assert lines, err[-3000:]
    res = json.loads(lines[-1])
    res["exit"] = code
    return res


def _jax_ring_loadable():
    """The ring library whole on disk, and the JAX loader able to load it
    (the corpus has ``queue backend=native`` lines). Under parallel test
    workers another process's ``make native`` can be linking the library
    while this one's loader first runs: its ``make`` fails or finds a
    short file, and the JAX loader never tries again in that process
    (its one-shot ``_tried``, nnstreamer_tpu/native/lib.py:60-69), so
    every later native queue there raises. As
    tests/test_torch_pipeline.py's ``ring_library`` does, the library is
    made here until a load succeeds, and a JAX loader that gave up is let
    try once more."""
    import ctypes
    import time

    import nnstreamer_tpu.native.lib as jax_lib
    for _ in range(50):
        subprocess.run(["make", "-C", str(ROOT), "native"],
                       capture_output=True, timeout=120)
        try:
            ctypes.CDLL(jax_lib._LIB_PATH)
            break
        except OSError:
            time.sleep(0.1)
    else:
        pytest.fail(f"{jax_lib._LIB_PATH} never became loadable")
    if jax_lib._lib is None:
        jax_lib._tried = False


def jax_statuses(candidates, check):
    """{description: (where, status, detail)} of the JAX gate's ``check``
    over ``candidates`` ((where, desc, *args) entries, each description
    once, as the JAX gate's loop takes them)."""
    _jax_ring_loadable()
    out = {}
    for where, desc, *args in corpus.distinct(candidates):
        status, detail = check(where, desc, *args)[:2]
        out[desc] = (where, status, detail)
    return out


def port_statuses(res):
    """{description: (where, status, detail)} of a port gate's result."""
    return {desc: (where, status, detail)
            for where, desc, status, detail in res["results"]}


def status_differences(jax, port, allowed=None):
    """Every description the JAX gate ran (any status but ``skipped``)
    whose translated line got another status from the port gate, unless
    ``allowed`` names its JAX location with the expected port status."""
    allowed = allowed or {}
    diffs = []
    for desc, (where, status, detail) in jax.items():
        if status == "skipped":
            continue
        got = port.get(corpus.to_port(desc))
        got_status = got[1] if got else "absent"
        if got_status != status and allowed.get(where) != got_status:
            diffs.append(f"{where}: JAX {status} ({detail}); port "
                         f"{got_status} ({got[2] if got else ''})")
    return diffs
