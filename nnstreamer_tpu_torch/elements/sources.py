"""Source elements: the deterministic video, audio and tensor test
sources, appsrc and filesrc.

The counterpart of ``nnstreamer_tpu/elements/sources.py`` (videotestsrc /
testsrc, audiotestsrc, tensorsrc, appsrc, filesrc). Frames are born as host
numpy arrays, byte-identical to the reference's patterns; the fused
segment downstream moves them to the device once. ``videotestsrc
device=true`` makes its pattern directly on the pipeline's device instead.
"""

from __future__ import annotations

import queue
import time
from fractions import Fraction
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.elements.base import (
    MediaSpec,
    PropSpec,
    Source,
    Spec,
    parse_bool,
)
from nnstreamer_tpu_torch.tensors.frame import EOS_FRAME, SECOND, Frame
from nnstreamer_tpu_torch.tensors.spec import TensorsSpec


def _frame_pts(index: int, rate: Optional[Fraction]):
    if not rate:
        return None, None
    dur = int(SECOND / rate)
    return index * dur, dur


@registry.element("videotestsrc")
@registry.element("testsrc")
class VideoTestSrc(Source):
    """Deterministic video source.

    Props: width, height, format (RGB/BGR/RGBA/GRAY8), num-frames (-1 =
    endless), framerate ("30/1"), pattern:
    - ``smpte``/``gradient``: per-frame shifted gradient (default)
    - ``solid``: constant fill (``foreground-color``)
    - ``random``: seeded rng (``seed``)
    - ``counter``: every pixel = frame index % 256 (golden-test friendly)

    ``is-live=true`` paces generation at ``framerate`` (a camera's clock);
    ``device=true`` makes each frame on the pipeline's device (one small
    op a frame, the same bytes; ``random`` is drawn on the host and copied
    up); ``stamp-wall=true`` records the generation time in
    ``meta["wall_t0"]`` for sink-side end-to-end latency.
    """

    FACTORY_NAME = "videotestsrc"

    PROPERTIES = {
        "width": PropSpec("int", 320),
        "height": PropSpec("int", 240),
        "format": PropSpec(
            "enum", "RGB", ("RGB", "BGR", "RGBA", "BGRx", "GRAY8")
        ),
        "num-frames": PropSpec("int", 10, desc="-1 = endless"),
        "num-buffers": PropSpec("int", 10, desc="alias of num-frames"),
        "pattern": PropSpec(
            "enum", "gradient",
            ("smpte", "gradient", "solid", "random", "counter"),
        ),
        "framerate": PropSpec("fraction", "30/1"),
        "seed": PropSpec("int", 0, desc="rng seed for pattern=random"),
        "foreground-color": PropSpec("int", 128, desc="pattern=solid fill"),
        "device": PropSpec("bool", False, desc="frames born on the pipeline's device"),
        "stamp-wall": PropSpec("bool", False, desc="record generation wall-clock"),
        "is-live": PropSpec("bool", False, desc="pace generation at framerate"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.width = int(self.get_property("width", 320))
        self.height = int(self.get_property("height", 240))
        self.format = str(self.get_property("format", "RGB"))
        self.num_frames = int(
            self.get_property("num-frames", self.get_property("num-buffers", 10))
        )
        self.pattern = str(self.get_property("pattern", "gradient")).lower()
        if self.pattern not in ("smpte", "gradient", "solid", "random", "counter"):
            raise ValueError(f"{self.name}: unknown pattern {self.pattern!r}")
        self.rate = Fraction(str(self.get_property("framerate", "30/1")))
        self.seed = int(self.get_property("seed", 0))
        self.stamp_wall = parse_bool(self.get_property("stamp-wall", False))
        self.is_live = parse_bool(self.get_property("is-live", False))
        self.on_device = parse_bool(self.get_property("device", False))
        self._t_live0 = None
        self._i = 0
        self._rng = np.random.default_rng(self.seed)
        self._base = None  # pattern base (uint8, wraps mod 256), host or device

    def output_spec(self) -> Spec:
        return MediaSpec(
            "video",
            width=self.width,
            height=self.height,
            format=self.format,
            rate=self.rate,
        )

    def start(self) -> None:
        self._i = 0
        self._t_live0 = None
        self._rng = np.random.default_rng(self.seed)
        c = MediaSpec("video", format=self.format).channels_per_pixel
        h, w = self.height, self.width
        if self.pattern in ("smpte", "gradient"):
            # uint8 addition wraps mod 256, so (base + i) reproduces the
            # per-frame shifted gradient with one vectorized add per frame
            yy, xx = np.meshgrid(
                np.arange(h, dtype=np.uint16),
                np.arange(w, dtype=np.uint16),
                indexing="ij",
            )
            base = (xx + yy)[..., None] + np.arange(c, dtype=np.uint16) * 37
            self._base = (base % 256).astype(np.uint8)
        elif self.pattern == "solid":
            color = int(self.get_property("foreground-color", 128))
            self._base = np.full((h, w, c), color, np.uint8)
        else:
            self._base = None
        if self.on_device and self._base is not None:
            self._base = torch.from_numpy(self._base).to(self.device)

    def generate(self):
        if 0 <= self.num_frames <= self._i:
            return EOS_FRAME
        c = MediaSpec("video", format=self.format).channels_per_pixel
        h, w = self.height, self.width
        shift = self._i % 256
        if self.pattern in ("smpte", "gradient"):
            # uint8 + shift wraps mod 256 in numpy and in torch alike
            img = self._base + (shift if self.on_device else np.uint8(shift))
        elif self.pattern == "solid":
            img = self._base
        elif self.pattern == "random":
            img = self._rng.integers(0, 256, (h, w, c), dtype=np.uint8)
            if self.on_device:
                img = torch.from_numpy(img).to(self.device)
        elif self.on_device:  # counter
            img = torch.full((h, w, c), shift, dtype=torch.uint8, device=self.device)
        else:
            img = np.full((h, w, c), shift, np.uint8)
        pts, dur = _frame_pts(self._i, self.rate)
        if self.is_live and self.rate:
            # frame i is due at t0 + i/rate on the monotonic clock (no drift)
            if self._t_live0 is None:
                self._t_live0 = time.perf_counter()
            delay = self._t_live0 + self._i / float(self.rate) - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
        self._i += 1
        meta = {"media_type": "video"}
        if self.stamp_wall:
            meta["wall_t0"] = time.perf_counter()
        return Frame((img,), pts=pts, duration=dur, meta=meta)


@registry.element("audiotestsrc")
class AudioTestSrc(Source):
    """Deterministic audio source: sine wave chunks of ``samples-per-buffer``
    S16LE samples, ``channels`` interleaved. The sine is computed in
    float64 on the host as the reference computes it, so the int16 bytes
    are the same."""

    FACTORY_NAME = "audiotestsrc"

    PROPERTIES = {
        "rate": PropSpec("int", 16000, desc="sample rate (Hz)"),
        "channels": PropSpec("int", 1),
        "samples-per-buffer": PropSpec("int", 1024),
        "num-buffers": PropSpec("int", 10),
        "freq": PropSpec("float", 440.0, desc="sine frequency (Hz)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.sample_rate = int(self.get_property("rate", 16000))
        self.channels = int(self.get_property("channels", 1))
        self.spb = int(self.get_property("samples-per-buffer", 1024))
        self.num_buffers = int(self.get_property("num-buffers", 10))
        self.freq = float(self.get_property("freq", 440.0))
        self._i = 0

    def output_spec(self) -> Spec:
        return MediaSpec(
            "audio",
            channels=self.channels,
            sample_rate=self.sample_rate,
            sample_format="S16LE",
        )

    def start(self) -> None:
        self._i = 0

    def generate(self):
        if 0 <= self.num_buffers <= self._i:
            return EOS_FRAME
        t0 = self._i * self.spb
        t = (np.arange(self.spb) + t0) / self.sample_rate
        wave = np.sin(2 * np.pi * self.freq * t) * 0.5
        samples = (wave * 32767).astype(np.int16)
        chunk = np.repeat(samples[:, None], self.channels, axis=1)
        pts = int(t0 * SECOND / self.sample_rate)
        dur = int(self.spb * SECOND / self.sample_rate)
        self._i += 1
        return Frame((chunk,), pts=pts, duration=dur, meta={"media_type": "audio"})


@registry.element("appsrc")
class AppSrc(Source):
    """Push frames (or raw arrays) from application code.

    Use ``AppSrc(iterable=...)`` to pull from an iterator, or call
    ``push(frame)`` and ``end_of_stream()`` from any thread.
    """

    FACTORY_NAME = "appsrc"

    PROPERTIES = {
        "dimensions": PropSpec("str", None, desc="output spec dims"),
        "types": PropSpec("str", "float32"),
    }

    def __init__(self, name=None, iterable: Optional[Iterable] = None,
                 spec: Optional[Spec] = None, **props):
        super().__init__(name, **props)
        self._iter: Optional[Iterator] = iter(iterable) if iterable is not None else None
        self._spec = spec
        self._queue: "queue.Queue" = queue.Queue(maxsize=16)

    def output_spec(self) -> Spec:
        if self._spec is not None:
            return self._spec
        dims = self.get_property("dimensions")
        if dims:
            return TensorsSpec.from_strings(dims, self.get_property("types", "float32"))
        raise ValueError(f"{self.name}: appsrc needs spec= or dimensions= property")

    @staticmethod
    def _as_frame(item) -> Frame:
        if isinstance(item, Frame):
            return item
        return Frame(tuple(item) if isinstance(item, (tuple, list)) else (item,))

    def push(self, frame, timeout: Optional[float] = None) -> None:
        self._queue.put(self._as_frame(frame), timeout=timeout)

    def end_of_stream(self) -> None:
        self._queue.put(EOS_FRAME)

    def generate(self):
        if self._iter is not None:
            try:
                return self._as_frame(next(self._iter))
            except StopIteration:
                return EOS_FRAME
        try:
            # bounded wait so the executor's stop event stays responsive
            return self._queue.get(timeout=0.1)
        except queue.Empty:
            return None


@registry.element("filesrc")
class FileSrc(Source):
    """Read a file as one octet buffer (or fixed ``blocksize`` chunks),
    feeding tensor_converter's application/octet-stream path."""

    FACTORY_NAME = "filesrc"

    PROPERTIES = {
        "location": PropSpec("str", "", desc="file path to read"),
        "blocksize": PropSpec("int", 0, desc="0 = whole file in one buffer"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.location = str(self.get_property("location", ""))
        self.blocksize = int(self.get_property("blocksize", 0))
        self._file = None
        self._done = False

    def output_spec(self) -> Spec:
        return MediaSpec("octet")

    def start(self) -> None:
        if not self.location:
            raise ValueError(f"{self.name}: filesrc needs location=")
        self._file = open(self.location, "rb")
        self._done = False

    def stop(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None

    def generate(self):
        if self._done:
            return EOS_FRAME
        data = self._file.read(self.blocksize if self.blocksize > 0 else -1)
        if self.blocksize <= 0:
            self._done = True  # the whole file is one buffer
        if not data:
            self._done = True
            return EOS_FRAME
        arr = np.frombuffer(bytearray(data), dtype=np.uint8)
        return Frame((arr,), meta={"media_type": "octet"})


@registry.element("tensorsrc")
class TensorSrc(Source):
    """Deterministic tensors straight in ``other/tensors`` (no converter
    needed). Props: dimensions, types, pattern (zeros/ones/counter/random),
    num-frames, framerate, seed."""

    FACTORY_NAME = "tensorsrc"

    PROPERTIES = {
        "dimensions": PropSpec("str", "1"),
        "types": PropSpec("str", "float32"),
        "pattern": PropSpec(
            "enum", "counter", ("zeros", "ones", "counter", "random")
        ),
        "num-frames": PropSpec("int", 10),
        "framerate": PropSpec("fraction", None),
        "seed": PropSpec("int", 0),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.spec = TensorsSpec.from_strings(
            str(self.get_property("dimensions", "1")),
            str(self.get_property("types", "float32")),
            rate=self.get_property("framerate"),
        )
        self.num_frames = int(self.get_property("num-frames", 10))
        self.pattern = str(self.get_property("pattern", "counter")).lower()
        if self.pattern not in ("zeros", "ones", "counter", "random"):
            raise ValueError(f"{self.name}: unknown pattern {self.pattern!r}")
        self.seed = int(self.get_property("seed", 0))
        self._i = 0
        self._rng = np.random.default_rng(self.seed)

    def output_spec(self) -> Spec:
        return self.spec

    def start(self) -> None:
        self._i = 0
        self._rng = np.random.default_rng(self.seed)

    def generate(self):
        if 0 <= self.num_frames <= self._i:
            return EOS_FRAME
        tensors = []
        for t in self.spec:
            if self.pattern == "zeros":
                a = np.zeros(t.shape, t.dtype.np_dtype)
            elif self.pattern == "ones":
                a = np.ones(t.shape, t.dtype.np_dtype)
            elif self.pattern == "counter":
                a = np.full(t.shape, self._i, dtype=np.float64).astype(t.dtype.np_dtype)
            else:  # random
                a = self._rng.random(t.shape).astype(t.dtype.np_dtype)
            tensors.append(a)
        pts, dur = _frame_pts(self._i, self.spec.rate)
        self._i += 1
        return Frame(tuple(tensors), pts=pts, duration=dur)
