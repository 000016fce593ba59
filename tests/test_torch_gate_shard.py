"""The port's sharded-serving byte-parity gate against the JAX
package's, on the CPU, over the whole corpus.

``tools/torch_shard_parity.py --device cpu`` runs every mesh line of
the corpus (JAX frameworks rewritten to ``torch-cuda``) on 8 gloo ranks
against the same line with its mesh specs stripped, and
``tools/shard_parity.py``'s ``check_shard_parity`` runs the JAX lines
on conftest.py's 8 virtual devices. The statuses agree description for
description, and so do the failing cases: today both gates fail on
``builtin:mlp-batch-major``, the ``zoo://mlp`` batch of 8 over
``mesh:8x1x1`` whose one-row blocks sum in another order than the
one-device product (ROADMAP.md C, "Mesh"; the port's
``parallel/sharding.py`` ``batch_sharding`` keeps the JAX placement),
so the port gate exits 1 as the JAX gate does.
"""
import jax
import pytest

from nnstreamer_tpu_torch.analysis import corpus

from torch_gate_parity import flight_dir  # noqa: F401 (autouse)
from torch_gate_parity import (jax_statuses, json_result, port_statuses,
                               start_tool, status_differences, tool)

# JAX location -> the port's status, for a difference named in ROADMAP C
ALLOWED = {}


@pytest.fixture(scope="module")
def gates():
    port = start_tool("torch_shard_parity", "--device", "cpu", "--timeout",
                      "600", "--json")
    jax = tool("shard_parity")
    want = jax_statuses(
        list(jax.BUILTIN)
        + [(w, d, False) for w, d in jax.collect(corpus.default_paths())],
        jax.check_shard_parity)
    jax_rc = int(any(s == "FAIL" for _, s, _ in want.values())
                 or not any(s == "mesh-ok" for _, s, _ in want.values()))
    return want, jax_rc, json_result(port)


def test_port_gate_ran_on_eight_gloo_ranks_and_compared(gates):
    _, _, res = gates
    assert res["world"] == 8 == jax.device_count() and res["device"] == "cpu"
    assert not res["vacuous"] and res["counts"]["mesh-ok"] >= 4
    assert res["rewritten"] == 0


def test_failing_cases_are_the_jax_gates(gates):
    want, jax_rc, res = gates
    jax_fail = {w for w, s, _ in want.values() if s == "FAIL"}
    port_fail = {w for w, _, s, _ in res["results"] if s == "FAIL"}
    assert port_fail == jax_fail == {"builtin:mlp-batch-major"}
    assert res["exit"] == res["rc"] == jax_rc == 1


def test_port_status_is_the_jax_status_per_description(gates):
    want, _, res = gates
    assert not status_differences(want, port_statuses(res), ALLOWED)


def test_builtin_suite_is_the_jax_suite_translated():
    jax, port = tool("shard_parity"), tool("torch_shard_parity")
    assert [(w, corpus.to_port(d), f) for w, d, f in jax.BUILTIN] \
        == port.BUILTIN


@pytest.mark.parametrize("custom,pool,want", [
    ("mesh:8x1x1", 1, "mesh:1x1x1"),
    ("mesh:2x2x2,rules:gpt", 1, "mesh:1x1x1,rules:gpt"),
    ("mesh:8x1x1", 4, "mesh:4x1x1"),
    ("mesh:4x1x1", 4, "mesh:4x1x1"),
    ("mesh:auto", 1, "mesh:auto"),
    ("rules:gpt, mesh:1x1x1", 1, "rules:gpt,mesh:1x1x1"),
])
def test_mesh_specs_are_fitted_to_the_cards(custom, pool, want):
    assert tool("torch_shard_parity")._fit_mesh(custom, pool) == want
