"""datareposrc / datareposink — MLOps data-repository reader/writer.

Port of ``nnstreamer_tpu/elements/datarepo.py`` (≙
gst/datarepo/gstdatarepo{src,sink}.c): raw fixed-size sample records in a
data file, described by a JSON index with the reference's exact schema
(tests/test_models/data/datarepo/mnist.json)::

    {"gst_caps": "...", "total_samples": N, "sample_size": BYTES}

Reader properties mirror gstdatareposrc.c:140-193: location / json /
start-sample-index / stop-sample-index / epochs / is-shuffle /
tensors-sequence.

Note: datarepo caps join multi-tensor dims/types with "." (not ","),
e.g. ``dimensions=(string)1:1:784:1.1:1:10:1`` — normalized on load.

Samples are host arrays (numpy; a bfloat16 tensor, which numpy lacks, is
a CPU ``torch.Tensor``), read and written byte for byte as the JAX
elements do: the same file and JSON index come out of either package.
``is-shuffle`` permutes each epoch's range with an explicit
``np.random.default_rng(0)``, the JAX element's generator and seed, so
both packages emit the same samples in the same order.
"""
from __future__ import annotations

import json
import os
import re
from typing import List, Optional

import numpy as np
import torch

from ..pipeline.element import SinkElement, SrcElement
from ..pipeline.registry import register_element
from ..tensors.buffer import Buffer, Chunk
from ..tensors.caps import Caps
from ..tensors.info import TensorsConfig
from ..tensors.types import TensorType

_DOT_FIELDS = re.compile(r"(dimensions|types)=(\(string\))?([^,;]*)")


def _normalize_datarepo_caps(caps_str: str) -> str:
    """datarepo joins list values with '.'; our caps grammar uses ','."""
    def fix(m):
        val = m.group(3).strip().strip('"')
        return f"{m.group(1)}=(string)\"{val.replace('.', ',')}\""
    return _DOT_FIELDS.sub(fix, caps_str)


def _denormalize_datarepo_caps(caps: Caps) -> str:
    cfg = caps.to_config()
    dims = cfg.info.dims_string().replace(",", ".")
    types = cfg.info.types_string().replace(",", ".")
    return (f"other/tensors, format=(string)static, "
            f"framerate=(fraction){cfg.rate_n}/{cfg.rate_d}, "
            f"num_tensors=(int){len(cfg.info)}, "
            f"dimensions=(string){dims}, types=(string){types}")


def _raw_bytes(a) -> bytes:
    """A host array's bytes in C order (bfloat16 through its bits)."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.int16).numpy().tobytes()
    return np.ascontiguousarray(a).tobytes()


@register_element("datareposrc")
class DataRepoSrc(SrcElement):
    PROPS = {
        "location": "",
        "json": "",
        "start-sample-index": 0,
        "stop-sample-index": -1,
        "epochs": 1,
        "is-shuffle": True,
        "tensors-sequence": "",   # e.g. "1,0" reorders tensors per sample
        "caps": "",
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._config: Optional[TensorsConfig] = None
        self._fp = None
        self._order: List[int] = []
        self._cursor = 0
        self._epoch = 0
        self._rng = np.random.default_rng(0)
        self._sample_size = 0

    def negotiate_src_caps(self) -> Optional[Caps]:
        with open(self.json) as f:
            index = json.load(f)
        caps = Caps(_normalize_datarepo_caps(index["gst_caps"]))
        self._config = caps.to_config()
        self._total = int(index["total_samples"])
        self._sample_size = int(index["sample_size"])
        expect = self._config.info.total_size_bytes()
        if expect and expect != self._sample_size:
            raise ValueError(
                f"{self.name}: sample_size {self._sample_size} != caps "
                f"total {expect}")
        stop = self.stop_sample_index
        if stop < 0 or stop >= self._total:
            stop = self._total - 1
        self._range = list(range(self.start_sample_index, stop + 1))
        self._new_epoch()
        return caps

    def _new_epoch(self) -> None:
        self._order = list(self._range)
        if self.is_shuffle:
            self._rng.shuffle(self._order)
        self._cursor = 0
        self._epoch += 1

    def create(self) -> Optional[Buffer]:
        if self._cursor >= len(self._order):
            if self._epoch >= self.epochs:
                return None
            self._new_epoch()
        idx = self._order[self._cursor]
        self._cursor += 1
        if self._fp is None:
            self._fp = open(self.location, "rb")
        self._fp.seek(idx * self._sample_size)
        raw = self._fp.read(self._sample_size)
        if len(raw) < self._sample_size:
            return None
        chunks, off = [], 0
        for info in self._config.info:
            nb = info.size_bytes
            if info.type is TensorType.BFLOAT16:
                arr = torch.frombuffer(bytearray(raw[off:off + nb]),
                                       dtype=torch.bfloat16)
            else:
                arr = np.frombuffer(raw[off:off + nb], info.type.np_dtype)
            chunks.append(Chunk(arr.reshape(info.shape)))
            off += nb
        if self.tensors_sequence:
            order = [int(i) for i in self.tensors_sequence.split(",")]
            chunks = [chunks[i] for i in order]
        return Buffer(chunks)

    def stop(self) -> None:
        if self._fp is not None:
            self._fp.close()
            self._fp = None
        super().stop()


@register_element("datareposink")
class DataRepoSink(SinkElement):
    PROPS = {"location": "", "json": ""}

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._fp = None
        self._count = 0
        self._sample_size = 0

    def render(self, buf: Buffer) -> None:
        if self._fp is None:
            self._fp = open(self.location, "wb")
        raw = b"".join(_raw_bytes(c.host()) for c in buf.chunks)
        if self._sample_size == 0:
            self._sample_size = len(raw)
        elif len(raw) != self._sample_size:
            raise ValueError(
                f"{self.name}: variable sample size "
                f"({len(raw)} != {self._sample_size})")
        self._fp.write(raw)
        self._count += 1

    def stop(self) -> None:
        if self._fp is not None:
            self._fp.close()
            self._fp = None
        super().stop()

    def on_eos(self) -> None:
        self._write_json()
        super().on_eos()

    def _write_json(self) -> None:
        if not self.json:
            return
        caps = self.sinkpad.caps
        index = {
            "gst_caps": _denormalize_datarepo_caps(caps) if caps else "",
            "total_samples": self._count,
            "sample_size": self._sample_size,
        }
        with open(self.json, "w") as f:
            json.dump(index, f, indent=2)
