"""Caps: stream capability descriptions + negotiation algebra.

A minimal, GStreamer-compatible caps model for tensor pipelines
(ref: caps handling in gst/nnstreamer/nnstreamer_plugin_api_impl.c —
gst_tensors_config_from_caps / gst_tensor_pad_caps_from_config; grammar in
include/tensor_typedef.h:90-132).

Grammar (reference-compatible subset)::

    other/tensors,format=static,num_tensors=2,
        types=(string)"uint8,float32",dimensions=(string)"3:224:224:1,10:1",
        framerate=(fraction)30/1

* ``(type)`` annotations are accepted and ignored.
* Quoted values may contain commas (multi-tensor types/dimensions lists).
* Int ranges ``[1,256]``, fraction ranges ``[0/1,2147483647/1]``, and
  alternative sets ``{a,b}`` are supported for negotiation templates.
* ``ANY`` caps intersect with everything.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from fractions import Fraction
from typing import Dict, List, Optional, Union

from .info import TensorsConfig, TensorsInfo
from .types import MIMETYPE_TENSORS, TensorFormat

__all__ = ["Caps", "CapsStructure", "IntRange", "FractionRange", "AltSet"]


@dataclass(frozen=True)
class IntRange:
    lo: int
    hi: int

    def __str__(self):
        return f"[{self.lo},{self.hi}]"


@dataclass(frozen=True)
class FractionRange:
    lo: Fraction
    hi: Fraction

    def __str__(self):
        return (f"[{self.lo.numerator}/{self.lo.denominator},"
                f"{self.hi.numerator}/{self.hi.denominator}]")


@dataclass(frozen=True)
class AltSet:
    values: tuple

    def __str__(self):
        return "{" + ",".join(_val_str(v) for v in self.values) + "}"


Value = Union[str, int, Fraction, IntRange, FractionRange, AltSet]


def _val_str(v: Value) -> str:
    if isinstance(v, Fraction):
        return f"{v.numerator}/{v.denominator}"
    if isinstance(v, str) and ("," in v or " " in v):
        return f'"{v}"'
    return str(v)


def _intersect_value(a: Value, b: Value) -> Optional[Value]:
    """Intersection of two field values; None = empty."""
    if isinstance(a, AltSet):
        hits = [r for v in a.values if (r := _intersect_value(v, b)) is not None]
        if not hits:
            return None
        return hits[0] if len(hits) == 1 else AltSet(tuple(hits))
    if isinstance(b, AltSet):
        return _intersect_value(b, a)
    if isinstance(a, IntRange) and isinstance(b, IntRange):
        lo, hi = max(a.lo, b.lo), min(a.hi, b.hi)
        if lo > hi:
            return None
        return lo if lo == hi else IntRange(lo, hi)
    if isinstance(a, IntRange):
        a, b = b, a
    if isinstance(b, IntRange) and isinstance(a, int):
        return a if b.lo <= a <= b.hi else None
    if isinstance(a, FractionRange) and isinstance(b, FractionRange):
        lo, hi = max(a.lo, b.lo), min(a.hi, b.hi)
        if lo > hi:
            return None
        return lo if lo == hi else FractionRange(lo, hi)
    if isinstance(a, FractionRange):
        a, b = b, a
    if isinstance(b, FractionRange) and isinstance(a, Fraction):
        return a if b.lo <= a <= b.hi else None
    return a if a == b else None


def _fixate_value(v: Value) -> Value:
    if isinstance(v, AltSet):
        return _fixate_value(v.values[0])
    if isinstance(v, IntRange):
        return v.lo
    if isinstance(v, FractionRange):
        # prefer a sane default rate inside the range, else the upper bound
        for cand in (Fraction(30, 1), Fraction(0, 1)):
            if v.lo <= cand <= v.hi:
                return cand
        return v.hi
    return v


def _parse_value(tok: str) -> Value:
    tok = tok.strip()
    if len(tok) >= 2 and tok[0] == tok[-1] and tok[0] in "\"'":
        return tok[1:-1]
    if tok.startswith("[") and tok.endswith("]"):
        lo, hi = tok[1:-1].split(",", 1)
        if "/" in lo or "/" in hi:
            return FractionRange(Fraction(lo.strip()), Fraction(hi.strip()))
        return IntRange(int(lo), int(hi))
    if tok.startswith("{") and tok.endswith("}"):
        return AltSet(tuple(_parse_value(t) for t in _split_top(tok[1:-1])))
    if "/" in tok:
        try:
            return Fraction(tok)
        except ValueError:
            return tok
    try:
        return int(tok)
    except ValueError:
        return tok


def _split_top(s: str) -> List[str]:
    """Split on commas not inside quotes/brackets/braces."""
    out, depth, quote, cur = [], 0, None, []
    for ch in s:
        if quote:
            cur.append(ch)
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
            cur.append(ch)
        elif ch in "[{(":
            depth += 1
            cur.append(ch)
        elif ch in "]})":
            depth -= 1
            cur.append(ch)
        elif ch == "," and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur))
    return [t for t in (t.strip() for t in out) if t]


class CapsStructure:
    """One media structure: name + fields."""

    def __init__(self, name: str, fields: Optional[Dict[str, Value]] = None):
        self.name = name
        self.fields: Dict[str, Value] = dict(fields or {})

    def intersect(self, other: "CapsStructure") -> Optional["CapsStructure"]:
        if self.name != other.name:
            return None
        merged: Dict[str, Value] = {}
        for k in set(self.fields) | set(other.fields):
            if k in self.fields and k in other.fields:
                v = _intersect_value(self.fields[k], other.fields[k])
                if v is None:
                    return None
                merged[k] = v
            else:
                merged[k] = self.fields.get(k, other.fields.get(k))
        return CapsStructure(self.name, merged)

    def is_fixed(self) -> bool:
        return not any(
            isinstance(v, (IntRange, FractionRange, AltSet))
            for v in self.fields.values())

    def fixate(self) -> "CapsStructure":
        return CapsStructure(
            self.name, {k: _fixate_value(v) for k, v in self.fields.items()})

    def __str__(self) -> str:
        parts = [self.name]
        for k, v in self.fields.items():
            parts.append(f"{k}={_val_str(v)}")
        return ",".join(parts)

    def __eq__(self, other) -> bool:
        return (isinstance(other, CapsStructure)
                and self.name == other.name and self.fields == other.fields)


class Caps:
    """An ordered list of alternative CapsStructures (preference order)."""

    def __init__(self, structures: "Union[str, List[CapsStructure], None]" = None):
        if structures is None:
            self.structures: List[CapsStructure] = []
            self.any = True
            return
        self.any = False
        if isinstance(structures, str):
            self.structures = _parse_caps(structures)
            if structures.strip() == "ANY":
                self.any = True
        else:
            self.structures = list(structures)

    # -- constructors -----------------------------------------------------
    @classmethod
    def ANY(cls) -> "Caps":
        return cls(None)

    @classmethod
    def from_config(cls, config: TensorsConfig) -> "Caps":
        """TensorsConfig -> fixed caps (ref: gst_tensor_pad_caps_from_config)."""
        fields: Dict[str, Value] = {"format": str(config.format)}
        if config.format == TensorFormat.STATIC and len(config.info):
            fields["num_tensors"] = len(config.info)
            fields["types"] = config.info.types_string()
            fields["dimensions"] = config.info.dims_string()
        fields["framerate"] = Fraction(config.rate_n, config.rate_d or 1)
        return cls([CapsStructure(MIMETYPE_TENSORS, fields)])

    @classmethod
    def template(cls, formats=("static", "flexible", "sparse")) -> "Caps":
        """Pad-template caps: any tensors stream of the given formats."""
        fmt: Value = formats[0] if len(formats) == 1 else AltSet(tuple(formats))
        return cls([CapsStructure(MIMETYPE_TENSORS, {
            "format": fmt,
            "framerate": FractionRange(Fraction(0, 1), Fraction(2 ** 31 - 1, 1)),
        })])

    # -- conversions ------------------------------------------------------
    def to_config(self) -> TensorsConfig:
        """Fixed caps -> TensorsConfig (ref: gst_tensors_config_from_caps)."""
        if self.any or not self.structures:
            raise ValueError("cannot convert non-fixed caps to config")
        s = self.structures[0]
        if s.name != MIMETYPE_TENSORS:
            raise ValueError(f"not a tensors caps: {s.name}")
        fmt = TensorFormat.from_string(str(s.fields.get("format", "static")))
        rate = s.fields.get("framerate", Fraction(0, 1))
        if not isinstance(rate, Fraction):
            rate = Fraction(0, 1)
        info = TensorsInfo()
        if fmt == TensorFormat.STATIC and "dimensions" in s.fields:
            info = TensorsInfo.make(
                str(s.fields["types"]), str(s.fields["dimensions"]))
            n = s.fields.get("num_tensors")
            if isinstance(n, int) and n != len(info):
                raise ValueError("num_tensors mismatch with dimensions list")
        return TensorsConfig(info, fmt, rate.numerator, rate.denominator)

    # -- algebra ----------------------------------------------------------
    def intersect(self, other: "Caps") -> "Caps":
        if self.any:
            return Caps(list(other.structures)) if not other.any else Caps.ANY()
        if other.any:
            return Caps(list(self.structures))
        out = []
        for a in self.structures:
            for b in other.structures:
                r = a.intersect(b)
                if r is not None:
                    out.append(r)
        return Caps(out)

    def can_intersect(self, other: "Caps") -> bool:
        return self.any or other.any or bool(self.intersect(other).structures)

    def is_fixed(self) -> bool:
        return (not self.any and len(self.structures) == 1
                and self.structures[0].is_fixed())

    def fixate(self) -> "Caps":
        if self.any:
            raise ValueError("cannot fixate ANY caps")
        if not self.structures:
            raise ValueError("cannot fixate EMPTY caps")
        return Caps([self.structures[0].fixate()])

    def is_empty(self) -> bool:
        return not self.any and not self.structures

    def __str__(self) -> str:
        if self.any:
            return "ANY"
        if not self.structures:
            return "EMPTY"
        return "; ".join(str(s) for s in self.structures)

    def __eq__(self, other) -> bool:
        return (isinstance(other, Caps) and self.any == other.any
                and self.structures == other.structures)


def _parse_caps(s: str) -> List[CapsStructure]:
    s = s.strip()
    if s in ("ANY", "EMPTY", ""):
        return []
    structures = []
    for struct_str in s.split(";"):
        toks = _split_top(struct_str)
        if not toks:
            continue
        name = toks[0]
        fields: Dict[str, Value] = {}
        for tok in toks[1:]:
            if "=" not in tok:
                raise ValueError(f"bad caps field {tok!r}")
            k, v = tok.split("=", 1)
            v = v.strip()
            if v.startswith("(") and ")" in v:  # drop (type) annotation
                v = v[v.index(")") + 1:]
            fields[k.strip()] = _parse_value(v)
        structures.append(CapsStructure(name, fields))
    return structures
