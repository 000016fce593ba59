"""The port's corpus lint gate against the JAX package's, on the CPU.

``tools/torch_lint_corpus.py`` runs the port's pipelint over every
description of ``tests/*.py``, ``README.md`` and the tutorials, the JAX
frameworks rewritten to ``torch-cuda``; ``tools/lint_corpus.py`` runs
the JAX pipelint over the same files. Both must find no error, and the
port must lint every description the JAX gate lints. The corpus
extractor of ``nnstreamer_tpu_torch.analysis.corpus`` is a copy of the
JAX gate's, held to it literal for literal. Also here: the port's
element reference, ``Documentation/elements_torch.md``, is what
``tools/torch_gen_element_docs.py`` makes of the registry.
"""
import re
import subprocess
import sys

import pytest

from nnstreamer_tpu_torch.analysis import corpus

from torch_gate_parity import ROOT, finish, json_result, start_tool, tool

# port test files whose parametrised templates are marked
MARKED = ["tests/test_torch_codecs.py", "tests/test_torch_edge.py",
          "tests/test_torch_elements.py", "tests/test_torch_fault.py"]


@pytest.fixture(scope="module")
def lints():
    """Both gates, each in a fresh interpreter (as ``make lint`` runs it:
    no element another test module registered), over the corpus and
    over the files with marked templates: ``(port, jax, port_marked,
    jax_marked)``, the JAX ones as (exit code, stdout)."""
    marked = [str(ROOT / f) for f in MARKED]
    procs = [start_tool("torch_lint_corpus", "--json"),
             start_tool("lint_corpus"),
             start_tool("torch_lint_corpus", "--json", *marked),
             start_tool("lint_corpus", *marked)]
    return (json_result(procs[0]), finish(procs[1])[:2],
            json_result(procs[2]), finish(procs[3])[:2])


@pytest.fixture(scope="module")
def port_lint(lints):
    return lints[0]


@pytest.fixture(scope="module")
def jax_lint(lints):
    return lints[1]


def test_port_lint_gate_finds_no_error(port_lint):
    assert port_lint["exit"] == port_lint["rc"] == 0, \
        "\n".join(port_lint["failures"])
    assert port_lint["errors"] == 0 and port_lint["linted"] > 0


def test_port_lints_no_fewer_descriptions_than_the_jax_gate(port_lint,
                                                            jax_lint):
    _, out = jax_lint
    jax_linted = int(re.search(r"(\d+) descriptions linted", out).group(1))
    assert port_lint["linted"] >= jax_linted


def test_jax_lint_gate_exits_zero(jax_lint):
    """The port's test files no longer break ``make lint``: their
    parametrised templates carry ``# pipelint: skip``."""
    rc, out = jax_lint
    assert rc == 0, out


def test_corpus_is_the_jax_extractors():
    jax = tool("lint_corpus")
    paths = corpus.default_paths(tutorials=True)
    assert corpus.collect(paths) == jax.collect(paths)
    assert corpus.collect(tutorials=True) == jax.collect(paths)


@pytest.mark.parametrize("where", MARKED)
def test_parametrised_templates_lint_clean(lints, where):
    """The templates whose holes the extractor fills with ``1`` (codec
    mode, wire codec, audio and video format, on-error policy) carry
    ``# pipelint: skip``: neither gate finds an error in these files."""
    port, (jax_rc, jax_out) = lints[2], lints[3]
    assert port["exit"] == 0 and port["errors"] == 0, port["failures"]
    assert jax_rc == 0 and where not in jax_out, jax_out
    assert not [d for _, d in corpus.collect([ROOT / where])
                if re.search(r"tensor_decoder mode=1\b|wire-codec=1\b|"
                             r"videoconvert format=1\b|"
                             r"audio/x-raw,format=1|on_error=1\b", d)]


@pytest.mark.parametrize("desc,want", [
    ("tensor_filter framework=jax model=m",
     "tensor_filter framework=torch-cuda model=m"),
    ("tensor_filter framework=jax-tpu name=f",
     "tensor_filter framework=torch-cuda name=f"),
    ("tensor_filter framework=flax", "tensor_filter framework=torch-cuda"),
    ("tensor_filter framework=jaxx", "tensor_filter framework=jaxx"),
    ("tensor_filter framework=pytorch", "tensor_filter framework=pytorch"),
    ("tensor_trainer framework=jax", "tensor_trainer framework=torch-cuda"),
])
def test_to_port_rewrites_only_the_jax_frameworks(desc, want):
    assert corpus.to_port(desc) == want


def test_port_corpus_dedups_after_the_rewrite(tmp_path):
    line = "tensortestsrc {} tensor_filter framework={} model=m {} x"
    src = tmp_path / "lines.py"
    src.write_text("".join(f"{k} = {line.format('!', fw, '!')!r}\n"
                           for k, fw in (("A", "jax"), ("B", "torch-cuda"),
                                         ("C", "jax"))))
    assert len(corpus.collect([src], root=tmp_path)) == 3
    assert corpus.port_corpus([src], root=tmp_path) == [
        ("lines.py:1", line.format("!", "torch-cuda", "!"))]


def test_element_reference_is_the_generators_output():
    """In a fresh interpreter: the registry holds the port's elements
    only, not those a test module registered."""
    code = ("import sys; sys.path.insert(0, 'tools'); "
            "import torch_gen_element_docs as g; sys.stdout.write(g.render())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=300).stdout
    assert (ROOT / "Documentation" / "elements_torch.md").read_text(
        encoding="utf-8") == out, ("Documentation/elements_torch.md is "
                                   "stale: run python3 "
                                   "tools/torch_gen_element_docs.py")



CAPS = ("other/tensors,format=static,num_tensors=1,types=(string)uint8,"
        "dimensions=(string)3:8:8,framerate=(fraction)0/1")


def test_place_puts_every_filter_on_the_cpu():
    import nnstreamer_tpu_torch as pt
    desc = (  # pipelint: skip (a fixture)
        f"tensortestsrc caps={CAPS} device=true num-buffers=2 "
        "! tensor_filter framework=torch-cuda model=zoo://toyseg "
        "name=a ! tensor_filter framework=torch-cuda "
        "model=zoo://toyseg accelerator=true:cpu name=b ! appsink")
    card, host = pt.parse_launch(desc), pt.parse_launch(desc)
    corpus.place(card, "cuda")
    corpus.place(host, "cpu")
    assert (card["a"].accelerator, card["b"].accelerator) == ("", "true:cpu")
    assert host["a"].accelerator == host["b"].accelerator == "true:cpu"
    src = [e for e in host.elements.values()
           if corpus.kind_of(e) == "tensortestsrc"]
    assert [e.device for e in src] == [False]


@pytest.mark.parametrize("desc,reason", [
    # pipelint: skip (a fixture)
    ("appsrc name=i ! appsink", "kind 'appsrc' is not hermetic"),
    # pipelint: skip (a fixture)
    (f"tensortestsrc caps={CAPS} ! tensor_filter framework=torch-cuda "
     "model=m.py ! appsink", "model 'm.py' needs files on disk"),
    # pipelint: skip (a fixture)
    (f"tensortestsrc caps={CAPS} ! tensor_filter framework=pytorch "
     "model=zoo://toyseg ! appsink", "framework 'pytorch' is not the port's"),
    # pipelint: skip (a fixture)
    (f"tensortestsrc caps={CAPS} ! tensor_filter framework=torch-cuda "
     "model=zoo://toyseg ! appsink", None),
])
def test_runnable_names_what_is_not_hermetic(desc, reason):
    import nnstreamer_tpu_torch as pt
    assert corpus.runnable(pt.parse_launch(desc)) == reason


def test_bounded_sources_stop_and_are_not_live():
    import nnstreamer_tpu_torch as pt
    pipe = pt.parse_launch(  # pipelint: skip (a fixture)
        f"tensortestsrc caps={CAPS} is-live=true ! appsink name=out")
    corpus.bound_sources(pipe)
    src = [e for e in pipe.elements.values()
           if corpus.kind_of(e) == "tensortestsrc"][0]
    assert src.num_buffers == corpus.MAX_BUFFERS and not src.is_live
    got = corpus.capture_sinks(pipe)
    pipe.run(timeout=30)
    assert len(got["out"]) == corpus.MAX_BUFFERS
    assert corpus.sink_keys(pipe) == {"out": "#0:appsink"}


def test_chunk_records_compare_bf16_by_its_bits():
    import numpy as np
    import torch
    a = torch.tensor([1.0, 2.0, 3.0], dtype=torch.bfloat16)
    bits = a.view(torch.int16).clone()
    bits[1] += 1  # one ulp
    rec = corpus.chunk_record(a)
    assert rec[:2] == ("bfloat16", (3,)) and len(rec[2]) == 6
    assert corpus.chunk_record(bits.view(torch.bfloat16)) != rec
    assert corpus.chunk_record(a.clone()) == rec
    assert corpus.chunk_record(np.arange(4, dtype=np.int16).reshape(2, 2)) \
        == ("int16", (2, 2), np.arange(4, dtype=np.int16).tobytes())


def test_at_eos_reads_the_run_before_its_backends_close():
    """``run_to_eos``'s hook sees the finished run with its filters'
    backends still open (the fuse gate reads each built model there);
    stop closes them after it."""
    import nnstreamer_tpu_torch as pt
    seg = ("other/tensors,format=static,num_tensors=1,types=(string)"
           "float32,dimensions=(string)8:8,framerate=(fraction)0/1")
    pipe = pt.parse_launch(  # pipelint: skip (a fixture)
        f"tensortestsrc caps={seg} num-buffers=3 ! tensor_filter name=f "
        "framework=torch-cuda model=zoo://toyseg accelerator=true:cpu "
        "! appsink name=out")
    seen = {}

    def read(p):
        seen.update(fw=p["f"].fw is not None, invokes=p["f"].invokes,
                    out=len(p["out"].buffers))
    corpus.run_to_eos(pipe, 60, read)
    assert seen == {"fw": True, "invokes": 3, "out": 3}
    assert pipe["f"].fw is None


def test_a_run_cut_by_its_timeout_is_an_error():
    """The JAX gates compare whatever reached the sinks when the timeout
    cut a run; here the cut run raises, so a slow host cannot read as a
    byte difference (or hide one)."""
    import nnstreamer_tpu_torch as pt
    pipe = pt.parse_launch(  # pipelint: skip (a fixture)
        f"tensortestsrc caps={CAPS} num-buffers=-1 ! appsink name=out")
    with pytest.raises(TimeoutError, match="no EOS within 0.3 s"):
        corpus.run_to_eos(pipe, 0.3)
    assert not pipe.running and pipe["out"].buffers
    done = pt.parse_launch(  # pipelint: skip (a fixture)
        f"tensortestsrc caps={CAPS} num-buffers=3 ! appsink name=out")
    corpus.run_to_eos(done, 30)
    assert len(done["out"].buffers) == 3
