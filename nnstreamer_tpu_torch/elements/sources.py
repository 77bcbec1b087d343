"""Source elements: the deterministic video and tensor test sources, and
appsrc.

The counterpart of ``nnstreamer_tpu/elements/sources.py`` (videotestsrc /
testsrc, tensorsrc, appsrc). Frames are born as host numpy arrays,
byte-identical to the reference's patterns; the fused segment downstream
moves them to the device once.
"""

from __future__ import annotations

import queue
import time
from fractions import Fraction
from typing import Iterable, Iterator, Optional

import numpy as np

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
    ``stamp-wall=true`` records the generation time in ``meta["wall_t0"]``
    for sink-side end-to-end latency.
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
        self._t_live0 = None
        self._i = 0
        self._rng = np.random.default_rng(self.seed)
        self._base = None  # host pattern base (uint8, wraps mod 256)

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

    def generate(self):
        if 0 <= self.num_frames <= self._i:
            return EOS_FRAME
        c = MediaSpec("video", format=self.format).channels_per_pixel
        h, w = self.height, self.width
        if self.pattern in ("smpte", "gradient"):
            img = self._base + np.uint8(self._i % 256)
        elif self.pattern == "solid":
            img = self._base
        elif self.pattern == "random":
            img = self._rng.integers(0, 256, (h, w, c), dtype=np.uint8)
        else:  # counter
            img = np.full((h, w, c), self._i % 256, np.uint8)
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
