#!/usr/bin/env python3
"""Generate Documentation/elements_torch.md from the port's element registry.

The port of ``tools/gen_element_docs.py``: the reference of every element
``nnstreamer_tpu_torch`` registers, produced from the code (PROPS
defaults, pad templates, class docstrings, the declared caps transfer,
the settlement identities) so it cannot drift. Re-run after adding or
changing an element::

    python3 tools/torch_gen_element_docs.py
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

OUT = ROOT / "Documentation" / "elements_torch.md"


def _transfer_doc(cls) -> str:
    """One line describing the element's declared static caps transfer —
    what pipelint's inference engine uses to propagate caps without
    starting the element."""
    from nnstreamer_tpu_torch.pipeline.element import (Element,
                                                       TransformElement)

    def _first_line(func):
        doc = (func.__doc__ or "").strip()
        return " ".join(doc.split("\n\n")[0].split()) if doc else ""

    src_caps = next((k.__dict__["static_src_caps"] for k in cls.__mro__
                     if "static_src_caps" in k.__dict__), None)
    transfer = next((k.__dict__["static_transfer"] for k in cls.__mro__
                     if "static_transfer" in k.__dict__), None)
    if transfer is Element.__dict__["static_transfer"]:
        if not (getattr(cls, "SINK_TEMPLATES", {}) or {}):
            # pure source: output is whatever static_src_caps declares
            if src_caps is not Element.__dict__["static_src_caps"]:
                return (_first_line(src_caps)
                        or "source caps from an override of "
                           "`static_src_caps`")
            return ("source caps from the `caps` property when set, "
                    "else unknown")
        return "identity passthrough (base declaration)"
    if transfer is TransformElement.__dict__.get("static_transfer"):
        return ("pure `transform_caps` on the fixated upstream caps; a "
                "None result is a provable negotiation failure")
    return (_first_line(transfer)
            or "element-specific (see `static_transfer` override)")


def render() -> str:
    """The reference's text, from the live registry."""
    import nnstreamer_tpu_torch  # noqa: F401 — registers all elements
    from nnstreamer_tpu_torch.analysis.flow.registry import \
        identities_by_name
    from nnstreamer_tpu_torch.pipeline.registry import (element_names,
                                                        get_element_class)

    identities = identities_by_name()
    out = ["# Element reference (PyTorch/CUDA port)",
           "",
           "Auto-generated from the element registry of "
           "`nnstreamer_tpu_torch` "
           "(`python3 tools/torch_gen_element_docs.py`). "
           "Every element is usable from the launch CLI: "
           "`python -m nnstreamer_tpu_torch '<element> prop=value ! ...'`; "
           "`python -m nnstreamer_tpu_torch --inspect <element>` prints the "
           "same information live.",
           ""]
    for name in element_names():
        cls = get_element_class(name)
        doc = (cls.__doc__ or "").strip()
        out += [f"## {name}", "", f"`{cls.__module__}.{cls.__name__}`", ""]
        if doc:
            out += [doc, ""]
        out += [f"**Caps transfer (pipelint):** {_transfer_doc(cls)}", ""]
        for iname in getattr(cls, "SETTLEMENT_IDENTITY", ()) or ():
            ident = identities[iname]
            out += [f"**Settlement identity (flowcheck):** "
                    f"`{ident.expression}` — {ident.doc}", ""]
        fusible = getattr(cls, "DEVICE_FUSIBLE", None)
        if fusible:
            out += [f"**Device-fusible (fusion compiler):** {fusible}", ""]
        ckpt = getattr(cls, "CHECKPOINTABLE", None)
        if ckpt:
            out += [f"**Checkpointable (preemption snapshot):** {ckpt}", ""]
        spts = getattr(cls, "SPAN_POINTS", None)
        if spts:
            out += ["**Frame-span points (flight recorder):** "
                    + ", ".join(f"`{s}`" for s in spts), ""]
        if getattr(cls, "STRIPS_META", False):
            out += ["**Strips buffer meta:** output buffers are minted "
                    "fresh — the frame trace context survives only via "
                    "same-thread inheritance (see pipelint's "
                    "`trace-export-stripped` rule)", ""]
        props = {}
        for klass in reversed(cls.__mro__):
            props.update(getattr(klass, "PROPS", {}))
        if props:
            out += ["| property | default |", "|---|---|"]
            out += [f"| `{k}` | `{v!r}` |" for k, v in sorted(props.items())]
            out.append("")
        pads = [f"| {label} | `{pname}` | {caps or 'ANY'} |"
                for attr, label in (("SINK_TEMPLATES", "sink"),
                                    ("SRC_TEMPLATES", "src"))
                for pname, caps in (getattr(cls, attr, {}) or {}).items()]
        if pads:
            out += ["| pad | name | caps |", "|---|---|---|", *pads, ""]
    return "\n".join(out) + "\n"


def main() -> int:
    text = render()
    OUT.write_text(text, encoding="utf-8")
    n = text.count("\n## ")
    print(f"wrote {OUT.relative_to(ROOT)} ({n} elements)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
