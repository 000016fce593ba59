"""The port's fusion byte-parity gate against the JAX package's, on the
CPU, over the whole corpus.

``tools/torch_fuse_parity.py --device cpu`` runs every runnable
description of ``tests/*.py`` and ``README.md`` (JAX frameworks
rewritten to ``torch-cuda``, mesh lines on as many gloo ranks as the JAX
lines have devices) fused and with ``fuse=false`` and compares
the sinks byte for byte; ``tools/fuse_parity.py``'s ``check_parity``
runs the JAX lines the same way. The port gate must exit 0 without
being vacuous, never FAIL, give a reason for every skip, and give every
description the JAX gate runs the JAX gate's status: ``fused-ok`` where
JAX fused, ``unfused`` where JAX found nothing to fuse. No difference
is allowed today (``ALLOWED`` is empty; ROADMAP.md C lists none).
"""
import re

import pytest

from nnstreamer_tpu_torch.analysis import corpus

from torch_gate_parity import flight_dir  # noqa: F401 (autouse)
from torch_gate_parity import (jax_devices, jax_statuses, json_result,
                               port_statuses, start_tool, status_differences,
                               tool)

# JAX location -> the port's status, for a difference named in ROADMAP C
ALLOWED = {}


@pytest.fixture(scope="module")
def gates():
    port = start_tool("torch_fuse_parity", "--mode", "fuse", "--device",
                      "cpu", "--timeout", "600", "--json",
                      host_devices=jax_devices())
    jax = tool("fuse_parity")
    want = jax_statuses(jax.BUILTIN + jax.collect(corpus.default_paths()),
                        jax.check_parity)
    return want, json_result(port)


def test_port_fuse_gate_exits_zero_and_compares(gates):
    _, res = gates
    assert res["exit"] == res["rc"] == 0, res["failures"]
    assert not res["vacuous"] and res["counts"]["fused-ok"] >= 4
    assert res["lines_run"] == res["counts"]["fused-ok"]


def test_port_status_is_the_jax_status_per_description(gates):
    want, res = gates
    assert not status_differences(want, port_statuses(res), ALLOWED)
    ran = [d for d, (_, s, _) in want.items() if s != "skipped"]
    assert len(ran) >= 100


def test_every_passing_line_compared_a_buffer(gates):
    """A line passes on the bytes its filters made: none passes on equal
    empty sinks."""
    _, res = gates
    ok = [d for _, _, s, d in res["results"] if s == "fused-ok"]
    assert ok and all(
        int(re.search(r"(\d+) buffers identical", d).group(1)) > 0
        for d in ok), ok


def test_every_port_line_passes_or_is_skipped_with_a_reason(gates):
    _, res = gates
    statuses = {s for _, _, s, _ in res["results"]}
    assert statuses <= {"fused-ok", "unfused", "skipped"}
    assert all(detail for _, _, s, detail in res["results"]
               if s == "skipped")


def test_builtin_suite_is_the_jax_suite_translated():
    jax, port = tool("fuse_parity"), tool("torch_fuse_parity")
    assert [(w, corpus.to_port(d)) for w, d in jax.BUILTIN] == port.BUILTIN


# -- the gate's reading of a run: failed invokes, launches a built model
# makes ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def gate():
    return tool("torch_fuse_parity")


class _Backend:
    def __init__(self, module, device):
        import torch
        self.module, self.device = module, torch.device(device)


@pytest.mark.parametrize("attn,layers,device,n", [
    ("pallas", 2, "cuda", 2), ("pallas", 1, "cuda", 1),
    ("stock", 2, "cuda", 0), ("pallas", 2, "cpu", 0)])
def test_hand_attention_is_read_off_the_built_model(gate, attn, layers,
                                                    device, n):
    """One launch a call for each attention module of the built model
    that routes through ``ops.fused_attention``, on the card only."""
    from nnstreamer_tpu_torch.models.vit import ViT
    model = ViT(patch=8, d_model=16, layers=layers, heads=2, classes=3,
                size=16, fused=attn == "pallas")
    assert gate._hand_attention(_Backend(model, device)) == n
    assert gate._hand_attention(None) == 0


def test_read_run_books_losses_and_the_launches_of_completed_calls(gate):
    """A filter's failed invokes and a fused segment's dropped frames are
    losses; the expected launches count a filter's completed invokes
    and a segment's dispatched frames, times each member's modules."""
    from nnstreamer_tpu_torch.models.vit import ViT
    from nnstreamer_tpu_torch.utils.atomic import Counters
    vit = _Backend(ViT(patch=8, d_model=16, layers=3, heads=2, classes=3,
                       size=16, fused=True), "cuda")

    class Filter:
        ELEMENT_NAME = "tensor_filter"

        def __init__(self, fw, invokes, errors=0):
            self.fw, self.invokes = fw, invokes
            self.stats = Counters({"invoke_errors": errors})

    class Decoder:
        ELEMENT_NAME = "tensor_decoder"
        stats = Counters({"buffers": 9})

    class Segment:
        IS_FUSED_SEGMENT = True

        def __init__(self, members, hits, misses, dropped):
            self.members = members
            self.stats = Counters({"jit_hits": hits, "jit_misses": misses,
                                   "dropped": dropped})

    class Pipe:
        def __init__(self, *elements):
            self.elements = {str(i): e for i, e in enumerate(elements)}

    assert gate._read_run(Pipe(
        Filter(vit, 5), Filter(vit, 2, errors=4), Decoder(),
        Filter(_Backend(None, "cuda"), 7),
        Segment([Filter(vit, 0), Decoder()], 5, 1, 2))) \
        == {"lost": 6, "attention": 3 * 5 + 3 * 2 + 3 * 6}


@pytest.mark.parametrize("device,cpu_lost,status,says", [
    ("cpu", None, "skipped", "lost to failed invokes"),
    ("cuda", 4, "skipped", "as many on the CPU"),
    ("cuda", 0, "FAIL", "on the card, 0 on the CPU"),
    ("cuda", "crash", "FAIL", "the CPU run crashed"),
])
def test_lost_frames_skip_a_line_only_where_the_cpu_loses_them(
        gate, device, cpu_lost, status, says):
    """Equal sinks after failed invokes prove nothing: the line is
    skipped, never passed. On the card only if the same line loses as
    many frames on the CPU; a loss the card alone shows fails."""
    def twin(desc, dev, timeout):
        assert dev == "cpu"
        if cpu_lost == "crash":
            raise RuntimeError("boom")
        return {}, [], cpu_lost

    got, detail = gate._lost_verdict("line", (4, 4), device, 1.0, twin)
    assert got == status and says in detail


@pytest.mark.parametrize("out,empty", [
    ({}, True), ({"#0:appsink": []}, True), ({"#0:appsink": [()]}, False)])
def test_a_line_that_compared_no_buffer_is_skipped(gate, out, empty):
    got = gate._nothing_compared(out)
    assert (got == ("skipped", "no buffer reached a sink: nothing "
                    "compared")) if empty else got is None


_CAPS_4X6 = ("other/tensors,format=static,num_tensors=1,types=(string)"
             "float32,dimensions=(string)4:6,framerate=(fraction)0/1")
_CAPS_FLEX = "other/tensors,format=flexible,framerate=(fraction)0/1"


@pytest.mark.parametrize("desc,lost", [
    # tests/test_analysis.py:147 translated: 4 floats a row into the
    # 64-input zoo MLP
    (f"tensortestsrc caps={_CAPS_4X6} ! tensor_filter name=f "  # pipelint: skip (a fixture)
     "framework=torch-cuda model=zoo://mlp input=4 inputtype=float32 "
     "! fakesink", 4),
    # tests/test_filter.py:81 translated: flexible caps, no tensor
    (f"tensortestsrc caps={_CAPS_FLEX} num-buffers=3 pattern=random ! "  # pipelint: skip (a fixture)
     "tensor_filter framework=torch-cuda model=zoo://mlp ! "
     "appsink name=out", 3),
])
def test_a_corpus_line_whose_invokes_fail_is_skipped_not_passed(
        gate, desc, lost):
    """Every invoke of these lines fails on either package and both sinks
    stay empty and equal. The JAX gate calls them ``async-ok`` ("0
    buffers identical"); the port gate skips them with the loss
    (``ALLOWED`` in tests/test_torch_gate_async.py, ROADMAP C)."""
    status, detail = gate.check_async_parity("here", desc, "cpu",
                                             timeout=60.0)
    assert (status, detail) == (
        "skipped", f"{lost} and {lost} frame(s) lost to failed invokes; "
        "nothing of theirs compared")
