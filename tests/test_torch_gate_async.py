"""The port's in-flight byte-parity gate against the JAX package's, on
the CPU, over the whole corpus.

``tools/torch_fuse_parity.py --mode async --device cpu`` runs every
runnable description (JAX frameworks rewritten to ``torch-cuda``, mesh
lines on as many gloo ranks as the JAX lines have devices)
unfused with every synchronous filter at ``in-flight=4 reorder=true``
and at ``in-flight=1``, sinks keyed by parse position, and compares
them byte for byte; ``tools/fuse_parity.py``'s ``check_async_parity``
runs the JAX lines the same way. The port gate must exit 0 without
being vacuous, never FAIL, give a reason for every skip, and give every
description the JAX gate runs the JAX gate's status (``async-ok``,
``no-filter``), but for the differences ``ALLOWED`` names (ROADMAP.md C
lists them).
"""
import re

import pytest

from nnstreamer_tpu_torch.analysis import corpus

from torch_gate_parity import flight_dir  # noqa: F401 (autouse)
from torch_gate_parity import (jax_devices, jax_statuses, json_result,
                               port_statuses, start_tool, status_differences,
                               tool)

# JAX location -> the port's status, for a difference named in ROADMAP C.
# Every invoke of these lines fails, on either package (an input the
# model does not take: 4 floats into the 64-input MLP, flexible caps
# that carry no tensor), so both twins reach EOS with empty sinks. The
# JAX gate passes them as "async-ok, 0 buffers identical"; the port gate
# compares only what its filters made and skips them with the loss.
ALLOWED = {
    "tests/test_analysis.py:147": "skipped",
    "tests/test_filter.py:81": "skipped",
    "tests/test_models.py:169": "skipped",
    "tests/test_stress.py:290": "skipped",
    "tests/test_stress.py:408": "skipped",
}


@pytest.fixture(scope="module")
def gates():
    port = start_tool("torch_fuse_parity", "--mode", "async", "--device",
                      "cpu", "--timeout", "600", "--json",
                      host_devices=jax_devices())
    jax = tool("fuse_parity")
    want = jax_statuses(jax.BUILTIN + jax.collect(corpus.default_paths()),
                        jax.check_async_parity)
    return want, json_result(port)


def test_port_async_gate_exits_zero_and_compares(gates):
    _, res = gates
    assert res["exit"] == res["rc"] == 0, res["failures"]
    assert not res["vacuous"] and res["counts"]["async-ok"] >= 4


def test_port_status_is_the_jax_status_per_description(gates):
    want, res = gates
    assert not status_differences(want, port_statuses(res), ALLOWED)
    assert sum(s == "async-ok" for _, s, _ in want.values()) >= 4


def test_every_passing_line_compared_a_buffer(gates):
    """A line passes on the bytes its filters made: none passes on equal
    empty sinks."""
    _, res = gates
    ok = [d for _, _, s, d in res["results"] if s == "async-ok"]
    assert ok and all(
        int(re.search(r"(\d+) buffers identical", d).group(1)) > 0
        for d in ok), ok


def test_every_port_line_passes_or_is_skipped_with_a_reason(gates):
    _, res = gates
    statuses = {s for _, _, s, _ in res["results"]}
    assert statuses <= {"async-ok", "no-filter", "skipped"}
    assert all(detail for _, _, s, detail in res["results"]
               if s == "skipped")


def test_windowed_lines_ran_both_twins(gates):
    """Each ``async-ok`` line ran twice (in-flight 1 and 4)."""
    _, res = gates
    assert res["runs"] >= 2 * res["counts"]["async-ok"]
