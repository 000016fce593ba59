"""Element factory registry.

Port of ``nnstreamer_tpu/pipeline/registry.py`` (≙ the GST_PLUGIN_DEFINE
element registerer, ref: gst/nnstreamer/registerer/nnstreamer.c:91-121).

Elements register by name with the ``@register_element`` decorator; the
launch-string parser instantiates through :func:`make_element`.
"""
from __future__ import annotations

from typing import Dict

_ELEMENTS: Dict[str, type] = {}


def register_element(name: str):
    def deco(cls: type) -> type:
        if name in _ELEMENTS and _ELEMENTS[name] is not cls:
            raise ValueError(f"element name {name!r} already registered")
        _ELEMENTS[name] = cls
        cls.ELEMENT_NAME = name
        return cls
    return deco


# core plumbing elements exempt from the allowlist: the reference's
# element restriction (enable_element_restriction) governs nnstreamer
# elements only — gst core elements (queue, tee, appsrc, ...) are never
# restricted there, so a tensor_*-only allowlist must not break plumbing
_IMPLICIT = frozenset({
    "capsfilter", "queue", "tee", "identity", "appsrc", "appsink",
    "fakesink", "tensortestsrc", "videotestsrc", "audiotestsrc",
    "filesrc", "filesink", "multifilesrc", "multifilesink",
    "videoconvert", "videoscale", "pngdec",
})


def make_element(kind: str, name=None, **props):
    from ..utils.conf import conf
    if kind not in _IMPLICIT and not conf.element_allowed(kind):
        # product element allowlisting (≙ enable_element_restriction,
        # meson_options.txt:52-53)
        raise ValueError(f"element {kind!r} is restricted by configuration")
    try:
        cls = _ELEMENTS[kind]
    except KeyError:
        import difflib
        close = difflib.get_close_matches(kind, _ELEMENTS, n=3, cutoff=0.6)
        hint = (f"did you mean {', '.join(repr(c) for c in close)}?"
                if close else f"known: {sorted(_ELEMENTS)}")
        raise ValueError(f"no such element {kind!r}; {hint}") from None
    return cls(name=name, **props)


def element_names():
    return sorted(_ELEMENTS)


def get_element_class(kind: str) -> type:
    return _ELEMENTS[kind]
