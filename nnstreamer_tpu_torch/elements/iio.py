"""tensor_src_iio — Linux IIO (industrial I/O) sensor source.

Port of ``nnstreamer_tpu/elements/iio.py``, a copy: the element is host
numpy in both packages. Its chunks are float32 host arrays; a device
filter downstream stages them onto the card.

≙ gst/nnstreamer/elements/gsttensor_srciio.c: enumerates an IIO device
under ``base-dir`` (default /sys/bus/iio/devices) by name or number,
parses its ``scan_elements`` channel descriptions (enable flags, index
order, type strings like ``le:s12/16>>4``), applies per-channel
scale/offset, and streams buffered samples from the character device in
``dev-dir`` as float32 tensors: ``value = (raw + offset) * scale``
(ref :127-129). ``merge-channels-data`` packs all channels into one
(capacity, channels) tensor; otherwise one (capacity, 1) tensor per
enabled channel (ref dims :560-568, :1560-1561).

``base-dir``/``dev-dir`` are properties exactly because the reference
made them properties — tests mount a fake sysfs tree.
"""
from __future__ import annotations

import os
import re
import time
from typing import List, Optional, Tuple

import numpy as np

from ..pipeline.element import SrcElement
from ..pipeline.registry import register_element
from ..tensors.buffer import Buffer, Chunk
from ..tensors.caps import Caps
from ..tensors.info import TensorInfo, TensorsConfig, TensorsInfo
from ..tensors.types import TensorType
from ..utils.log import logger

_TYPE_RE = re.compile(
    r"^(?P<endian>[lb])e:(?P<sign>[su])(?P<bits>\d+)/(?P<storage>\d+)"
    r"(?:X(?P<repeat>\d+))?>>(?P<shift>\d+)$")


class _Channel:
    def __init__(self, name: str, index: int, enabled: bool,
                 endian: str, signed: bool, bits: int, storage: int,
                 shift: int, scale: float, offset: float):
        self.name, self.index, self.enabled = name, index, enabled
        self.endian, self.signed = endian, signed
        self.bits, self.storage, self.shift = bits, storage, shift
        self.scale, self.offset = scale, offset
        self.frame_offset = 0  # aligned byte offset within a scan frame

    @property
    def nbytes(self) -> int:
        return self.storage // 8

    def extract(self, raw: np.ndarray) -> np.ndarray:
        """raw: (n, storage_bytes) uint8 -> float32 values
        (≙ the shift/mask/sign-extend macro, gsttensor_srciio.c:113-130)."""
        dt = np.dtype(f"{'<' if self.endian == 'l' else '>'}u{self.nbytes}")
        vals = raw.view(dt).reshape(-1).astype(np.uint64)
        vals >>= np.uint64(self.shift)
        vals &= np.uint64((1 << self.bits) - 1)
        if self.signed:
            sign_bit = np.uint64(1 << (self.bits - 1))
            signed = vals.astype(np.int64)
            signed = np.where(vals & sign_bit,
                              signed - (1 << self.bits), signed)
            out = signed.astype(np.float32)
        else:
            out = vals.astype(np.float32)
        return (out + self.offset) * self.scale


@register_element("tensor_src_iio")
class TensorSrcIio(SrcElement):
    PROPS = {
        "mode": "continuous",          # continuous | one-shot
        "base-dir": "/sys/bus/iio/devices",
        "dev-dir": "/dev",
        "device": "",                  # device name (in the `name` file)
        "device-number": -1,
        "channels": "auto",            # auto (enabled only) | all
        "buffer-capacity": 1,
        "frequency": 0,                # sampling frequency to request
        "merge-channels-data": True,
        "poll-timeout": 10000,         # ms
        "silent": True,
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._dev_dir_path = ""
        self._dev_node = ""
        self._chans: List[_Channel] = []
        self._frame_bytes = 0
        self._dev_fp = None

    # -- device discovery --------------------------------------------------
    def _find_device(self) -> str:
        base = self.base_dir
        if self.device_number >= 0:
            path = os.path.join(base, f"iio:device{self.device_number}")
            if not os.path.isdir(path):
                raise ValueError(
                    f"{self.name}: no IIO device {self.device_number} "
                    f"under {base}")
            return path
        if not self.device:
            raise ValueError(
                f"{self.name}: set 'device' (name) or 'device-number'")
        for entry in sorted(os.listdir(base)):
            name_file = os.path.join(base, entry, "name")
            if os.path.isfile(name_file):
                with open(name_file) as f:
                    if f.read().strip() == self.device:
                        return os.path.join(base, entry)
        raise ValueError(f"{self.name}: IIO device {self.device!r} "
                         f"not found under {base}")

    @staticmethod
    def _read_value(path: str, default=None):
        try:
            with open(path) as f:
                return f.read().strip()
        except OSError:
            return default

    def _parse_channels(self, dev_path: str) -> List[_Channel]:
        scan = os.path.join(dev_path, "scan_elements")
        if not os.path.isdir(scan):
            raise ValueError(f"{self.name}: {dev_path} has no scan_elements")
        chans = []
        for fname in sorted(os.listdir(scan)):
            if not fname.endswith("_en"):
                continue
            cname = fname[:-3]
            enabled = self._read_value(os.path.join(scan, fname)) == "1"
            if self.channels == "all" and not enabled:
                # channels=all must actually ENABLE the channel (write
                # the _en flag like the reference) — otherwise our frame
                # layout would include channels the kernel won't stream
                try:
                    with open(os.path.join(scan, fname), "w") as f:
                        f.write("1")
                    enabled = True
                except OSError:
                    logger.warning("%s: cannot enable channel %s; "
                                   "skipping it", self.name, cname)
                    continue
            if not enabled:
                continue
            tstr = self._read_value(os.path.join(scan, f"{cname}_type"), "")
            m = _TYPE_RE.match(tstr)
            if not m:
                raise ValueError(
                    f"{self.name}: cannot parse channel type {tstr!r} "
                    f"for {cname}")
            idx = int(self._read_value(
                os.path.join(scan, f"{cname}_index"), "0"))
            # scale/offset live next to the raw value in the device dir
            # (specific name first, then the generic one, ≙ :984-1000)
            generic = re.sub(r"\d+$", "", cname)
            scale = offset = None
            for nm in (cname, generic):
                if scale is None:
                    scale = self._read_value(
                        os.path.join(dev_path, f"{nm}_scale"))
                if offset is None:
                    offset = self._read_value(
                        os.path.join(dev_path, f"{nm}_offset"))
            chans.append(_Channel(
                cname, idx, enabled, m["endian"], m["sign"] == "s",
                int(m["bits"]), int(m["storage"]), int(m["shift"]),
                float(scale) if scale is not None else 1.0,
                float(offset) if offset is not None else 0.0))
        chans.sort(key=lambda c: c.index)
        if not chans:
            raise ValueError(f"{self.name}: no enabled IIO channels")
        return chans

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        dev_path = self._find_device()
        self._chans = self._parse_channels(dev_path)
        # the kernel aligns each scan element to its own storage size and
        # pads the frame to the largest element's alignment
        pos = 0
        for c in self._chans:
            pos = (pos + c.nbytes - 1) // c.nbytes * c.nbytes
            c.frame_offset = pos
            pos += c.nbytes
        maxb = max(c.nbytes for c in self._chans)
        self._frame_bytes = (pos + maxb - 1) // maxb * maxb
        self._dev_node = os.path.join(self.dev_dir,
                                      os.path.basename(dev_path))
        if self.frequency > 0:
            # best-effort request (≙ writing sampling_frequency)
            freq_file = os.path.join(dev_path, "sampling_frequency")
            try:
                with open(freq_file, "w") as f:
                    f.write(str(self.frequency))
            except OSError:
                logger.info("%s: cannot set sampling frequency", self.name)
        if self.mode == "continuous":
            # O_NONBLOCK: a quiet real char device must not park the src
            # thread in an unkillable blocking read (regular files are
            # unaffected); pacing/timeout is handled in _read_frames
            fd = os.open(self._dev_node, os.O_RDONLY | os.O_NONBLOCK)
            self._dev_fp = os.fdopen(fd, "rb", buffering=0)
        self._dev_path = dev_path
        super().start()

    def stop(self) -> None:
        # close the device FIRST so a reader inside _read_frames gets an
        # immediate OSError instead of the join timing out
        fp, self._dev_fp = self._dev_fp, None
        if fp is not None:
            try:
                fp.close()
            except OSError:
                pass
        super().stop()

    # -- caps ---------------------------------------------------------------
    def negotiate_src_caps(self) -> Optional[Caps]:
        cap = int(self.buffer_capacity)
        n_ch = len(self._chans)
        rate = int(self.frequency) or 0
        if self.merge_channels_data:
            infos = TensorsInfo([TensorInfo(None, TensorType.FLOAT32,
                                            (cap, n_ch))])
        else:
            infos = TensorsInfo(
                TensorInfo(c.name, TensorType.FLOAT32, (cap, 1))
                for c in self._chans)
        return Caps.from_config(TensorsConfig(infos, rate_n=rate, rate_d=1))

    # -- data ---------------------------------------------------------------
    def _read_frames(self) -> Tuple[Optional[np.ndarray], bool]:
        want = self._frame_bytes * int(self.buffer_capacity)
        if self.mode == "one-shot":
            # read instantaneous values from in_<ch>_raw sysfs files
            rows = []
            for _ in range(int(self.buffer_capacity)):
                row = []
                for c in self._chans:
                    v = self._read_value(
                        os.path.join(self._dev_path, f"{c.name}_raw"), "0")
                    row.append((float(v) + c.offset) * c.scale)
                rows.append(row)
            return np.asarray(rows, np.float32), True
        data = b""
        deadline = time.monotonic() + self.poll_timeout / 1000.0
        while len(data) < want:
            fp = self._dev_fp
            if fp is None or self._stop_evt.is_set():
                return None, False
            try:
                chunk = fp.read(want - len(data))
            except (BlockingIOError, ValueError, OSError):
                chunk = None  # no data yet (nonblocking) or closing
            if not chunk:
                # b"" is a true EOF (regular file / closed fifo) — terminal
                # even mid-frame; None means no data yet (nonblocking
                # device), so retry until poll-timeout
                if chunk == b"":
                    return None, False
                if time.monotonic() > deadline:
                    return None, False
                time.sleep(0.001)
                continue
            data += chunk
        raw = np.frombuffer(data, np.uint8)
        cols = []
        frames = raw.reshape(int(self.buffer_capacity), self._frame_bytes)
        for c in self._chans:
            off = c.frame_offset
            cols.append(c.extract(
                np.ascontiguousarray(frames[:, off:off + c.nbytes])))
        return np.stack(cols, axis=1), False

    def create(self) -> Optional[Buffer]:
        out = self._read_frames()
        if out is None or out[0] is None:
            return None
        merged, oneshot = out
        if oneshot:
            # pace sysfs polling: configured rate, else a 100 Hz default
            # so an unset frequency doesn't busy-spin on _raw reads
            rate = self.frequency if self.frequency > 0 else 100.0
            time.sleep(int(self.buffer_capacity) / rate)
        if self.merge_channels_data:
            chunks = [Chunk(np.ascontiguousarray(merged))]
        else:
            chunks = [Chunk(np.ascontiguousarray(merged[:, i:i + 1]))
                      for i in range(merged.shape[1])]
        return Buffer(chunks)
