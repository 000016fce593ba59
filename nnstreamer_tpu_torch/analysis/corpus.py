"""The repo's corpus of pipeline descriptions, for the port's check gates.

Port of the extractor in ``tools/lint_corpus.py`` and of the helpers the
JAX parity gates share (``tools/fuse_parity.py``): every gst-launch-style
description in the string literals of ``tests/*.py`` and in the fenced
code blocks of ``README.md`` (python blocks through ``ast``, shell blocks
through a quoted-string regex), f-string holes filled from module-level
string constants where they can be (a hole that fills a caps value gets
flexible caps, any other hole ``1``), docs' elided caps (``...``) made
flexible. A literal whose own lines, or the line above it, carry
``# pipelint: skip`` is left out: that is how a defective fixture or a
parametrised template opts out of the clean-corpus gates.

:func:`to_port` turns a JAX package line into the port's: the JAX
frameworks (``jax``, ``jax-tpu``, ``flax``) become ``torch-cuda``; no
other framework name changes. :func:`port_corpus` is the translated
corpus with duplicates removed after the rewrite (the port's own test
lines often repeat a JAX test line once translated).

The gates' shared helpers: :data:`RUNNABLE` (the element kinds that run
hermetically: no socket, no file, no hardware, no wall clock),
:func:`runnable`, :func:`bound_sources` (unbounded sources capped at
:data:`MAX_BUFFERS`, live sources made non-live), :func:`capture_sinks`
(each sink's chunks as dtype, shape and bytes, read through
``Chunk.host()``), :func:`sink_keys` (sinks by parse position and kind),
:func:`place` (``--device cpu`` puts ``accelerator=true:cpu`` on every
filter; on the card a line keeps what it says), :func:`run_to_eos` (a
run its timeout cut is an error, not a shorter output; a hook reads the
finished run before its backends close) and :func:`mesh_world` (one mesh
world held across a gate's lines).
"""
from __future__ import annotations

import ast
import contextlib
import re
from pathlib import Path
from typing import (Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from .rules import kind_of

ROOT = Path(__file__).resolve().parents[2]

_SKIP_RE = re.compile(r"#\s*pipelint:\s*skip")
# shell-ish quoted string that looks like a pipeline description
_SH_STR_RE = re.compile(r"\"((?:[^\"\\]|\\.)*)\"|'((?:[^'\\]|\\.)*)'", re.S)
# docs elide caps bodies as "..." — substitute real (flexible) caps so
# the elision doesn't read as a malformed-caps error
_ELIDED_CAPS_RE = re.compile(r"caps=\\?[\"'][^\"']*\.\.\.[^\"']*\\?[\"']")
_FLEX_CAPS = "caps=other/tensors,format=flexible,framerate=(fraction)0/1"
# the JAX package's own frameworks, as a whole property value
_JAX_FRAMEWORK_RE = re.compile(r"\bframework=(?:jax-tpu|jax|flax)(?=[\s!]|$)")

# kinds that run hermetically on this host: no sockets, no files, no
# hardware, no wall-clock coupling
RUNNABLE = frozenset({
    "tensortestsrc", "capsfilter", "identity", "queue", "tee",
    "tensor_converter", "tensor_transform", "tensor_filter",
    "tensor_decoder", "tensor_mux", "tensor_demux", "tensor_merge",
    "tensor_crop", "tensor_split", "tensor_aggregator", "tensor_rate",
    "appsink", "fakesink", "tensor_sink",
})
# the port's framework names a corpus line may run under
PORT_FRAMEWORKS = ("", "auto", "torch-cuda")
MAX_BUFFERS = 4  # forced bound for corpus sources left unbounded


def default_paths(root: Path = ROOT, tutorials: bool = False) -> List[Path]:
    """``tests/*.py`` and ``README.md``; the lint adds
    ``Documentation/tutorials/*.md``, as the JAX lint does."""
    paths = sorted(root.glob("tests/*.py")) + [root / "README.md"]
    if tutorials:
        paths += sorted(root.glob("Documentation/tutorials/*.md"))
    return paths


def _literal_text(node: ast.AST, env: Dict[str, str]) -> Optional[str]:
    """The string value of a Constant-str or JoinedStr node; a hole is
    resolved from ``env`` (module-level string constants) when it can
    be, gets flexible caps when it fills a caps value, else ``1``."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr):
        parts: List[str] = []
        for piece in node.values:
            if isinstance(piece, ast.Constant):
                parts.append(str(piece.value))
                continue
            expr = piece.value if isinstance(piece, ast.FormattedValue) \
                else piece
            if isinstance(expr, ast.Name) and expr.id in env:
                parts.append(env[expr.id])
            elif re.search(r"caps=[\"']?$", "".join(parts)):
                parts.append("other/tensors,format=flexible,"
                             "framerate=(fraction)0/1")
            else:
                parts.append("1")
        return "".join(parts)
    return None


def _skipped(lines: List[str], node: ast.AST) -> bool:
    """True if ``# pipelint: skip`` is on the line above the string or on
    any line it spans."""
    last = getattr(node, "end_lineno", node.lineno) or node.lineno
    return any(0 <= ln < len(lines) and _SKIP_RE.search(lines[ln])
               for ln in range(node.lineno - 2, last))


def _from_python(source: str, label: str) -> Iterator[Tuple[str, str]]:
    try:
        tree = ast.parse(source)
    except SyntaxError:
        return
    lines = source.splitlines()
    env = {}  # module-level NAME = "literal" bindings, for f-string holes
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name) \
                and isinstance(stmt.value, ast.Constant) \
                and isinstance(stmt.value.value, str):
            env[stmt.targets[0].id] = stmt.value.value
    inner = {id(piece) for node in ast.walk(tree)
             if isinstance(node, ast.JoinedStr) for piece in node.values}
    for node in ast.walk(tree):
        if id(node) in inner:  # fragment of an f-string, not a string
            continue
        text = _literal_text(node, env)
        if text is None or " ! " not in text or _skipped(lines, node):
            continue
        yield f"{label}:{node.lineno}", " ".join(text.split())


def _from_markdown(source: str, label: str) -> Iterator[Tuple[str, str]]:
    block: List[str] = []
    fence = None
    lineno = 0
    for n, line in enumerate(source.splitlines(), 1):
        if fence is None:
            if line.lstrip().startswith("```"):
                fence, block, lineno = line.lstrip()[3:].strip(), [], n
            continue
        if line.lstrip().startswith("```"):
            body = "\n".join(block)
            found = list(_from_python(body, f"{label}:{lineno}"))
            if found:
                yield from found
            else:  # shell-style block: pull quoted pipeline strings
                body = body.replace("\\\n", " ")  # join continuations
                for m in _SH_STR_RE.finditer(body):
                    text = m.group(1) or m.group(2) or ""
                    if " ! " in text:
                        yield (f"{label}:{lineno}", " ".join(text.split()))
            fence = None
            continue
        block.append(line)


def collect(paths: Optional[Sequence[Path]] = None, root: Path = ROOT,
            tutorials: bool = False) -> List[Tuple[str, str]]:
    """Every ``(where, description)`` the files hold, as written, in file
    order, duplicates kept (``where`` is ``path:line``)."""
    out: List[Tuple[str, str]] = []
    for path in (default_paths(root, tutorials) if paths is None
                 else paths):
        path = Path(path).resolve()
        try:
            label = str(path.relative_to(root))
        except ValueError:
            label = str(path)
        text = path.read_text(encoding="utf-8")
        if path.suffix == ".py":
            out.extend(_from_python(text, label))
        else:
            out.extend((where, _ELIDED_CAPS_RE.sub(_FLEX_CAPS, desc))
                       for where, desc in _from_markdown(text, label))
    return out


def to_port(desc: str) -> str:
    """The port's line for a JAX package line: ``framework=jax``,
    ``jax-tpu`` and ``flax`` become ``framework=torch-cuda``."""
    return _JAX_FRAMEWORK_RE.sub("framework=torch-cuda", desc)


def distinct(candidates) -> list:
    """``candidates`` without a repeated description (the first place it
    appears is kept); an entry is ``(where, desc, ...)``."""
    seen = set()
    out = []
    for entry in candidates:
        if entry[1] not in seen:
            seen.add(entry[1])
            out.append(entry)
    return out


def port_corpus(paths: Optional[Sequence[Path]] = None,
                root: Path = ROOT) -> List[Tuple[str, str]]:
    """The corpus translated by :func:`to_port`, each description once."""
    return distinct((where, to_port(desc))
                    for where, desc in collect(paths, root))


def runnable(pipe) -> Optional[str]:
    """None when every element can run hermetically, else the reason."""
    for e in pipe.elements.values():
        kind = kind_of(e)
        if kind not in RUNNABLE:
            return f"kind {kind!r} is not hermetic"
        if kind == "tensor_filter":
            fw = (str(e.framework) or "").lower()
            model = str(e.model).split(",")[0]
            if not model.startswith("zoo://"):
                return f"model {model!r} needs files on disk"
            if fw not in PORT_FRAMEWORKS:
                return f"framework {fw!r} is not the port's"
    return None


def place(pipe, device: str) -> None:
    """``device="cpu"``: every filter runs on the CPU
    (``accelerator=true:cpu``) and a device-resident source stages on
    the host. ``"cuda"``: the line runs as written."""
    if device != "cpu":
        return
    for e in pipe.elements.values():
        kind = kind_of(e)
        if kind == "tensor_filter":
            e.set_property("accelerator", "true:cpu")
        elif kind == "tensortestsrc" and e.device:
            e.set_property("device", False)


@contextlib.contextmanager
def mesh_world(device: str, ranks: int = 1):
    """Hold the mesh world a gate's lines share, for the whole run; yields
    its size. ``device="cpu"``: ``ranks`` gloo ranks on the host (the
    JAX gates' virtual CPU devices); ``"cuda"``: the machine's cards. The
    world stops, and the host pool is reset, when the last user lets go."""
    from ..parallel import world
    from ..parallel.mesh import set_host_devices
    if device == "cpu":
        set_host_devices(ranks)
    w = world.retain(device)
    try:
        yield w.size
    finally:
        world.release()
        if device == "cpu" and not world.started():
            set_host_devices(None)


def run_to_eos(pipe, timeout: float,
               at_eos: Optional[Callable[[object], None]] = None) -> None:
    """Start, wait for EOS, stop. A run its timeout cut raises
    ``TimeoutError``: its sinks hold part of the stream, and comparing
    them would read as a byte difference. ``at_eos(pipe)`` reads the
    finished run before stop closes its filters' backends."""
    pipe.start()
    try:
        if not pipe.wait_eos(timeout):
            raise TimeoutError(f"no EOS within {timeout:g} s")
        if at_eos is not None:
            at_eos(pipe)
    finally:
        pipe.stop()


def bound_sources(pipe) -> None:
    from ..pipeline.element import SrcElement
    for e in pipe.elements.values():
        if isinstance(e, SrcElement):
            if int(getattr(e, "num_buffers", -1) or -1) <= 0:
                e.set_property("num-buffers", MAX_BUFFERS)
            if bool(getattr(e, "is_live", False)):
                e.set_property("is-live", False)


def chunk_record(host) -> Tuple[str, Tuple[int, ...], bytes]:
    """(dtype, shape, raw bytes) of a chunk read on the host; bf16 comes
    back from ``Chunk.host()`` as a CPU tensor, compared by its bits."""
    if isinstance(host, torch.Tensor):
        t = host.detach().contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        return str(t.dtype).replace("torch.", ""), tuple(t.shape), raw
    a = np.asarray(host)
    return str(a.dtype), tuple(a.shape), np.ascontiguousarray(a).tobytes()


def capture_sinks(pipe) -> Dict[str, List[Tuple]]:
    """Per-sink recorder: wraps each sink's ``render`` so every output —
    not just appsink's — is compared, chunk by chunk."""
    from ..pipeline.element import SinkElement
    got: Dict[str, List[Tuple]] = {}

    def _wrap(sink, rec):
        orig = sink.render

        def render(buf):
            rec.append(tuple(chunk_record(c.host()) for c in buf.chunks))
            return orig(buf)

        sink.render = render

    for name, e in pipe.elements.items():
        if isinstance(e, SinkElement):
            got[name] = []
            _wrap(e, got[name])
    return got


def sink_keys(pipe) -> Dict[str, str]:
    """Sink name -> ``#i:kind`` by parse position: auto-generated names
    come from a process-global counter, so two parses of one line never
    share them."""
    from ..pipeline.element import SinkElement
    sinks = [(n, e) for n, e in pipe.elements.items()
             if isinstance(e, SinkElement)]
    return {name: f"#{i}:{kind_of(e)}" for i, (name, e) in enumerate(sinks)}


def first_difference(want: Dict[str, list], got: Dict[str, list],
                     what: str) -> Optional[str]:
    """None when every sink of ``want`` got the same records in ``got``,
    else a line naming the first sink that differs."""
    for sink in want:
        if got.get(sink) != want[sink]:
            na, nb = len(got.get(sink, [])), len(want[sink])
            return (f"sink {sink!r}: {what} ({na} vs {nb} buffers)")
    return None
