"""Python-script decoder subplugin.

Port of ``nnstreamer_tpu/decoders/python3.py`` (≙ ext/nnstreamer/
tensor_decoder/tensordec-python3.cc): a user .py file (option1)
implements the decoder. The script defines::

    def get_out_caps(config) -> str | Caps    # config: TensorsConfig
    def decode(buf) -> Buffer                 # buf: tensors Buffer

mirroring the converter custom-script hook (converters/registry.py). The
script gets the port's :class:`~..tensors.buffer.Buffer`; ``chunk.host()``
gives it numpy (a bfloat16 chunk: a CPU ``torch.bfloat16`` tensor), as
the JAX package's gives it numpy.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from ..tensors.buffer import Buffer
from ..tensors.caps import Caps
from ..tensors.info import TensorsConfig
from .registry import DecoderPlugin, register_decoder


@register_decoder
class PythonDecoder(DecoderPlugin):
    NAME = "python3"

    def _load(self) -> Dict[str, Any]:
        path = self.option(1)
        if not path:
            raise ValueError("python3 decoder needs option1=<script.py>")
        ns: Dict[str, Any] = {}
        with open(path) as f:
            exec(compile(f.read(), path, "exec"), ns)  # noqa: S102 — user script
        if "decode" not in ns:
            raise ValueError(f"{path}: decoder script must define decode()")
        return ns

    def get_out_caps(self, config: TensorsConfig) -> Caps:
        self._ns = self._load()
        fn = self._ns.get("get_out_caps")
        if fn is None:
            return Caps.ANY()
        out = fn(config)
        return out if isinstance(out, Caps) else Caps(str(out))

    def decode(self, buf: Buffer) -> Optional[Buffer]:
        return self._ns["decode"](buf)
