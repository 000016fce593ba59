"""gst-launch-style textual pipeline parser, ported from
``nnstreamer_tpu/pipeline/parser.py`` with the same grammar.

Builds a Pipeline from the same description syntax the reference's users
write (ref: pipelines are constructed with gst_parse_launch throughout the
reference's tests and docs, e.g. tests/nnstreamer_filter_tensorflow2_lite/
runTest.sh). Supported grammar:

    chain    := node (" ! " node)*
    node     := KIND prop*            create element
              | NAME "." [PAD]        reference a named element('s pad)
              | CAPS                  inline caps -> capsfilter
    prop     := KEY "=" VALUE         (VALUE may be quoted)

Branching works like gst-launch: ``tee name=t ! q1 ... t. ! q2 ...`` and
``src ! m.sink_1`` to target a named pad of a mux.

Every parse error reports the token index and the offending token, so a
long description can be debugged without counting whitespace by hand.
"""
from __future__ import annotations

import re
from typing import List, Optional

from .element import Element
from .pad import PadDirection
from .pipeline import Pipeline
from .registry import make_element

_PROP_RE = re.compile(r"^([A-Za-z][\w-]*)=(.*)$", re.S)
_REF_RE = re.compile(r"^([A-Za-z][\w-]*)\.([\w%-]*)$")


def _tokenize(desc: str) -> List[str]:
    toks, cur, quote, qpos = [], [], None, -1
    for pos, ch in enumerate(desc):
        if quote:
            cur.append(ch)
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote, qpos = ch, pos
            cur.append(ch)
        elif ch.isspace():
            if cur:
                toks.append("".join(cur))
                cur = []
        else:
            cur.append(ch)
    if quote:
        raise ValueError(
            f"unterminated {quote} quote starting at character {qpos} "
            f"near {desc[max(0, qpos - 15):qpos + 15]!r}")
    if cur:
        toks.append("".join(cur))
    return toks


def _unquote(v: str) -> str:
    if len(v) >= 2 and v[0] == v[-1] and v[0] in "\"'":
        return v[1:-1]
    return v


def _is_caps_token(tok: str) -> bool:
    head = tok.split(",", 1)[0]
    return "/" in head and "=" not in head


def _free_src_pad(elem: Element):
    for p in elem.src_pads.values():
        if not p.is_linked:
            return p
    return elem.request_pad(PadDirection.SRC)


def _free_sink_pad(elem: Element, padname: Optional[str] = None):
    if padname:
        return elem.get_static_or_request_pad(padname, PadDirection.SINK)
    for p in elem.sink_pads.values():
        if not p.is_linked:
            return p
    return elem.request_pad(PadDirection.SINK)


def parse_launch(desc: str, pipeline: Optional[Pipeline] = None) -> Pipeline:
    pipe = pipeline if pipeline is not None else Pipeline()
    tokens = _tokenize(desc)
    current: Optional[Element] = None
    pending_link = False

    def _err(i: int, message: str) -> ValueError:
        return ValueError(f"token {i} ({tokens[i]!r}): {message}")

    def _rename(i: int, elem: Element, new: str) -> None:
        if new in pipe.elements:
            raise _err(i, f"duplicate element name {new!r}")
        del pipe.elements[elem.name]
        elem.name = new
        pipe.elements[new] = elem

    for i, tok in enumerate(tokens):
        if tok == "!":
            if current is None:
                raise _err(i, "'!' with no upstream element")
            pending_link = True
            continue

        ref = _REF_RE.match(tok)
        if ref and not _is_caps_token(tok):
            name, padname = ref.group(1), ref.group(2) or None
            if name not in pipe.elements:
                raise _err(i, f"reference to unknown element {name!r}")
            target = pipe.elements[name]
            if pending_link:
                _free_src_pad(current).link(_free_sink_pad(target, padname))
                pending_link = False
                current = target
            else:
                current = target  # start a new chain from this element
            continue

        m = _PROP_RE.match(tok)
        if m and not _is_caps_token(tok) and not pending_link and current is not None:
            key, val = m.group(1), _unquote(m.group(2))
            if key == "name":
                _rename(i, current, val)
            else:
                try:
                    current.set_property(key, val)
                except ValueError as exc:
                    raise _err(i, str(exc)) from None
            continue

        # element creation (kind or inline caps)
        if _is_caps_token(tok):
            elem = make_element("capsfilter", caps=_unquote(tok))
        else:
            if m:
                # pipeline-level props: a leading KEY=VALUE before any
                # element configures the Pipeline itself; ``fuse=false``
                # is the fusion opt-out, ``fuse=true`` the default.
                if current is None and m.group(1) == "fuse":
                    pipe.fuse = _unquote(m.group(2)).lower() not in (
                        "false", "0", "no", "off")
                    continue
                raise _err(i, f"property {tok!r} with no element to "
                              f"apply to")
            try:
                elem = make_element(tok)
            except ValueError as exc:
                raise _err(i, str(exc)) from None
        pipe.add(elem)
        if pending_link:
            _free_src_pad(current).link(_free_sink_pad(elem))
            pending_link = False
        current = elem

    if pending_link:
        raise ValueError(
            f"dangling '!' at end of description (token {len(tokens) - 1})")
    return pipe
