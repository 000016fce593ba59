"""Media-side elements: videotestsrc/audiotestsrc analogs and file IO.

Port of ``nnstreamer_tpu/elements/media.py``: videotestsrc, audiotestsrc,
videoconvert, videoscale, pngdec, jpegdec, filesrc, multifilesrc,
filesink and multifilesink, all numpy on the host as in the JAX package.
The JAX package's ``pngdec``/``jpegdec`` and ``videoscale`` call PIL;
here they call the port's own decoders and Pillow's BILINEAR resize in
numpy (``imaging/``), which give the same bytes without PIL. Sources
declare their caps through the element base's ``static_src_caps``;
videoconvert and videoscale declare their ``static_transfer``.

The reference's pipelines are fed by GStreamer core elements
(videotestsrc, filesrc, multifilesink — e.g. tests/nnstreamer_converter/
runTest.sh uses videotestsrc ! tensor_converter; golden tests diff
multifilesink dumps). These are their tensor-framework counterparts: media
buffers are single-chunk host ndarrays whose caps use media mimetypes
(video/x-raw, audio/x-raw, text/x-raw, application/octet-stream).
"""
from __future__ import annotations

import glob
import os
from typing import List, Optional

import numpy as np
import torch

from ..imaging import decode_image, resize_bilinear
from ..pipeline.element import SinkElement, SrcElement, TransformElement
from ..pipeline.registry import register_element
from ..tensors.buffer import Buffer, Chunk
from ..tensors.caps import Caps

_VIDEO_CHANNELS = {"RGB": 3, "BGR": 3, "RGBA": 4, "BGRx": 4, "GRAY8": 1}


def video_frame_shape(caps: Caps):
    s = caps.structures[0]
    fmt = str(s.fields.get("format", "RGB"))
    h, w = int(s.fields["height"]), int(s.fields["width"])
    c = _VIDEO_CHANNELS.get(fmt)
    if c is None:
        raise ValueError(f"unsupported video format {fmt!r}")
    return (h, w, c), fmt


@register_element("videotestsrc")
class VideoTestSrc(SrcElement):
    """Synthetic video frames (≙ videotestsrc). Patterns: smpte (color
    bars), ball (moving dot), counter, random."""

    PROPS = {"caps": "video/x-raw,format=RGB,width=640,height=480,"
                     "framerate=30/1",
             "pattern": "smpte", "is-live": False, "seed": 0}

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._shape = None
        self._count = 0
        self._dur = None
        self._rng = None

    def negotiate_src_caps(self) -> Optional[Caps]:
        caps = Caps(self.caps).fixate()
        self._shape, _ = video_frame_shape(caps)
        cfg_rate = caps.structures[0].fields.get("framerate")
        if cfg_rate is not None and getattr(cfg_rate, "numerator", 0):
            self._dur = int(1e9 * cfg_rate.denominator / cfg_rate.numerator)
        return caps

    def create(self) -> Optional[Buffer]:
        h, w, c = self._shape
        if self._rng is None:
            self._rng = np.random.default_rng(self.seed)
        if self.pattern == "random":
            frame = self._rng.integers(0, 256, self._shape, np.uint8)
        elif self.pattern == "ball":
            frame = np.zeros(self._shape, np.uint8)
            cy = int((np.sin(self._count / 10.0) * 0.4 + 0.5) * h)
            cx = int((np.cos(self._count / 10.0) * 0.4 + 0.5) * w)
            frame[max(0, cy - 5):cy + 5, max(0, cx - 5):cx + 5] = 255
        elif self.pattern == "counter":
            frame = np.full(self._shape, self._count % 256, np.uint8)
        else:  # smpte-ish vertical bars
            bars = np.array([[255, 255, 255], [255, 255, 0], [0, 255, 255],
                             [0, 255, 0], [255, 0, 255], [255, 0, 0],
                             [0, 0, 255]], np.uint8)
            cols = bars[(np.arange(w) * 7 // max(w, 1)) % 7]
            frame = np.broadcast_to(cols[None, :, :c], (h, w, c)).copy()
        pts = self._count * self._dur if self._dur else self._count
        self._count += 1
        if self.is_live and self._dur:
            import time
            time.sleep(self._dur / 1e9)
        return Buffer([Chunk(frame)], pts=pts, duration=self._dur)


@register_element("audiotestsrc")
class AudioTestSrc(SrcElement):
    """Sine-wave audio frames (≙ audiotestsrc). One buffer =
    ``samplesperbuffer`` frames."""

    PROPS = {"caps": "audio/x-raw,format=S16LE,channels=1,rate=16000",
             "samplesperbuffer": 1024, "freq": 440.0}

    _FORMATS = {"S16LE": np.int16, "U8": np.uint8, "S8": np.int8,
                "F32LE": np.float32}

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._count = 0

    def negotiate_src_caps(self) -> Optional[Caps]:
        return Caps(self.caps).fixate()

    def create(self) -> Optional[Buffer]:
        s = self.srcpad.caps.structures[0]
        rate = int(s.fields.get("rate", 16000))
        ch = int(s.fields.get("channels", 1))
        dt = self._FORMATS[str(s.fields.get("format", "S16LE"))]
        n = self.samplesperbuffer
        t = (np.arange(n) + self._count * n) / rate
        wave = np.sin(2 * np.pi * self.freq * t)
        if np.issubdtype(dt, np.integer):
            info = np.iinfo(dt)
            mid = (info.max + info.min + 1) / 2
            data = (mid + wave * (info.max - mid)).astype(dt)
        else:
            data = wave.astype(dt)
        frame = np.repeat(data[:, None], ch, axis=1)
        pts = int(self._count * n * 1e9 / rate)
        self._count += 1
        return Buffer([Chunk(frame)], pts=pts,
                      duration=int(n * 1e9 / rate))


@register_element("filesrc")
class FileSrc(SrcElement):
    """Whole-file reader: one buffer containing the file bytes
    (``blocksize=-1``) or fixed-size blocks."""

    PROPS = {"location": "", "blocksize": -1, "caps": ""}

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._fp = None

    def negotiate_src_caps(self) -> Optional[Caps]:
        return Caps(self.caps) if self.caps else Caps(
            "application/octet-stream")

    def create(self) -> Optional[Buffer]:
        if self._fp is None:
            self._fp = open(self.location, "rb")
        data = self._fp.read() if self.blocksize < 0 else \
            self._fp.read(self.blocksize)
        if not data:
            self._fp.close()
            self._fp = None
            return None
        return Buffer([Chunk(np.frombuffer(data, np.uint8))])


@register_element("multifilesrc")
class MultiFileSrc(SrcElement):
    """Reads ``location`` as a printf pattern (frame.%03d.raw) or glob."""

    PROPS = {"location": "", "caps": "", "start-index": 0, "stop-index": -1}

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._files: Optional[List[str]] = None
        self._idx = 0

    def negotiate_src_caps(self) -> Optional[Caps]:
        return Caps(self.caps) if self.caps else Caps(
            "application/octet-stream")

    def _resolve(self) -> List[str]:
        if "%" in self.location:
            out, i = [], self.start_index
            while self.stop_index < 0 or i <= self.stop_index:
                path = self.location % i
                if not os.path.exists(path):
                    break
                out.append(path)
                i += 1
            return out
        return sorted(glob.glob(self.location))

    def create(self) -> Optional[Buffer]:
        if self._files is None:
            self._files = self._resolve()
        if self._idx >= len(self._files):
            return None
        with open(self._files[self._idx], "rb") as f:
            data = f.read()
        self._idx += 1
        return Buffer([Chunk(np.frombuffer(data, np.uint8))])


def _host_frame(buf: Buffer) -> np.ndarray:
    """The buffer's one chunk on the host as an ndarray (a chunk on the
    card comes through the buffer's coalesced fetch)."""
    frame = buf.fetch_host()[0]
    return frame.numpy() if isinstance(frame, torch.Tensor) \
        else np.asarray(frame)


@register_element("pngdec")
class PngDec(TransformElement):
    """Decode image buffers into video/x-raw RGB frames (≙ gst pngdec in
    the reference's golden pipelines,
    tests/nnstreamer_filter_tensorflow2_lite/runTest.sh:77). The JAX
    package's element opens any format PIL opens; this one finds the
    format as PIL's ``Image.open`` does (``imaging.sniff``: PIL's plugins
    in PIL's order) and decodes PNG, JPEG, BMP/DIB, PBM/PGM/PPM/PFM, GIF
    (its first frame), TIFF (none, PackBits, LZW, Deflate), ICO/CUR, TGA
    and QOI (``jpegdec`` is the same element). The frame equals PIL's
    ``Image.open(...).convert("RGB")`` (``imaging/``). Any other format
    PIL opens (WebP, JPEG 2000, AVIF, PCX, SGI, ...) raises
    ``NotPortedError`` naming PIL's format; bytes PIL cannot open raise
    ``ValueError``. Output caps are fixed from the first decoded frame,
    as in the JAX element."""

    SINK_TEMPLATES = {"sink": None}
    SRC_TEMPLATES = {"src": "video/x-raw"}

    def on_sink_caps(self, pad, caps) -> None:
        pass  # frame size unknown until the first buffer decodes

    def static_transfer(self, in_caps):
        """Unknown output: frame dims come from the decoded file."""
        return {"src": None}

    def transform(self, buf: Buffer) -> Optional[Buffer]:
        frame = decode_image(_host_frame(buf).tobytes())
        if self.srcpad.caps is None:
            h, w = frame.shape[:2]
            self.set_src_caps(Caps(
                f"video/x-raw,format=RGB,width={w},height={h},"
                "framerate=0/1"))
        return Buffer([Chunk(frame)], pts=buf.pts, duration=buf.duration)


register_element("jpegdec")(PngDec)


@register_element("videoscale")
class VideoScale(TransformElement):
    """Scale video frames to ``width`` x ``height`` with Pillow's
    BILINEAR resize, bit for bit (``imaging/resample.py``; a 4-channel
    frame's last byte is alpha to it, as to PIL). The gst videoscale
    negotiates its target size with a downstream capsfilter; this
    runtime's negotiation is push-based, so the target is given as
    properties instead."""

    SINK_TEMPLATES = {"sink": "video/x-raw"}
    SRC_TEMPLATES = {"src": "video/x-raw"}
    PROPS = {"width": 0, "height": 0}

    def _out_caps(self, caps: Caps) -> Caps:
        (h, w, _), fmt = video_frame_shape(caps)
        out_w = self.width or w
        out_h = self.height or h
        s = caps.structures[0]
        rate = s.fields.get("framerate", "0/1")
        return Caps(
            f"video/x-raw,format={fmt},width={out_w},height={out_h},"
            f"framerate={rate}")

    def on_sink_caps(self, pad, caps) -> None:
        self.set_src_caps(self._out_caps(caps))

    def static_transfer(self, in_caps):
        """Scaled width/height on the declared video caps."""
        caps = in_caps.get("sink")
        if caps is None or not caps.is_fixed():
            return {"src": None}
        return {"src": self._out_caps(caps)}

    def transform(self, buf: Buffer) -> Optional[Buffer]:
        (h, w, _), _ = video_frame_shape(self.srcpad.caps)
        shape = buf.chunks[0].shape
        if shape[0] == h and shape[1] == w:
            return buf
        frame = _host_frame(buf)
        gray = frame.ndim == 3 and frame.shape[-1] == 1
        out = resize_bilinear(frame[..., 0] if gray else frame, w, h)
        if gray:
            out = out[..., None]
        return Buffer([Chunk(out)], pts=buf.pts, duration=buf.duration)


@register_element("videoconvert")
class VideoConvert(TransformElement):
    """Colorspace conversion between the supported raw formats (RGB/BGR/
    RGBA/BGRx/GRAY8). Target format via the ``format`` property (gst
    negotiates with a capsfilter instead)."""

    SINK_TEMPLATES = {"sink": "video/x-raw"}
    SRC_TEMPLATES = {"src": "video/x-raw"}
    PROPS = {"format": ""}

    def _out_caps(self, caps: Caps) -> Caps:
        (h, w, _), fmt = video_frame_shape(caps)
        out_fmt = self.format or fmt
        s = caps.structures[0]
        rate = s.fields.get("framerate", "0/1")
        return Caps(
            f"video/x-raw,format={out_fmt},width={w},height={h},"
            f"framerate={rate}")

    def on_sink_caps(self, pad, caps) -> None:
        self.set_src_caps(self._out_caps(caps))

    def static_transfer(self, in_caps):
        """Converted colorspace format on the declared video caps."""
        caps = in_caps.get("sink")
        if caps is None or not caps.is_fixed():
            return {"src": None}
        return {"src": self._out_caps(caps)}

    def transform(self, buf: Buffer) -> Optional[Buffer]:
        _, in_fmt = video_frame_shape(self.sinkpad.caps)
        _, out_fmt = video_frame_shape(self.srcpad.caps)
        if in_fmt == out_fmt:
            return buf
        frame = buf.chunks[0].host()
        rgb = self._to_rgb(frame, in_fmt)
        out = self._from_rgb(rgb, out_fmt)
        return Buffer([Chunk(out)], pts=buf.pts, duration=buf.duration)

    @staticmethod
    def _to_rgb(frame: np.ndarray, fmt: str) -> np.ndarray:
        if fmt == "RGB":
            return frame
        if fmt == "BGR":
            return frame[..., ::-1]
        if fmt == "RGBA":
            return frame[..., :3]
        if fmt == "BGRx":
            return frame[..., 2::-1]
        if fmt == "GRAY8":
            return np.repeat(frame, 3, axis=-1) if frame.shape[-1] == 1 \
                else np.repeat(frame[..., None], 3, axis=-1)
        raise ValueError(f"unsupported video format {fmt!r}")

    @staticmethod
    def _from_rgb(rgb: np.ndarray, fmt: str) -> np.ndarray:
        if fmt == "RGB":
            return np.ascontiguousarray(rgb)
        if fmt == "BGR":
            return np.ascontiguousarray(rgb[..., ::-1])
        if fmt == "RGBA":
            return np.concatenate(
                [rgb, np.full(rgb.shape[:2] + (1,), 255, np.uint8)], -1)
        if fmt == "BGRx":
            return np.concatenate(
                [rgb[..., ::-1],
                 np.full(rgb.shape[:2] + (1,), 255, np.uint8)], -1)
        if fmt == "GRAY8":
            return np.round(
                rgb @ np.array([0.299, 0.587, 0.114])).astype(
                    np.uint8)[..., None]
        raise ValueError(f"unsupported video format {fmt!r}")


@register_element("filesink")
class FileSink(SinkElement):
    PROPS = {"location": ""}

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._fp = None

    def render(self, buf: Buffer) -> None:
        if self._fp is None:
            self._fp = open(self.location, "wb")
        for c in buf.chunks:
            self._fp.write(c.host().tobytes())

    def stop(self) -> None:
        if self._fp is not None:
            self._fp.close()
            self._fp = None
        super().stop()


@register_element("multifilesink")
class MultiFileSink(SinkElement):
    """One file per buffer: location is a printf pattern (out.%03d.raw) —
    the golden-test workhorse (≙ multifilesink in SSAT runTest.sh dumps)."""

    PROPS = {"location": "out.%03d.raw"}

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._idx = 0

    def render(self, buf: Buffer) -> None:
        with open(self.location % self._idx, "wb") as f:
            for c in buf.chunks:
                f.write(c.host().tobytes())
        self._idx += 1
