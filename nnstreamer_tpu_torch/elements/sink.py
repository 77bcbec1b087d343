"""Sink elements: tensor_sink (callbacks), appsink, filesink, fakesink.

The counterpart of ``nnstreamer_tpu/elements/sink.py``. Sinks are the
host edge: tensors leave the device here, cast to the negotiated dtypes.
"""

from __future__ import annotations

import queue
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.elements.base import PropSpec, Sink
from nnstreamer_tpu_torch.tensors.frame import Frame


@registry.element("tensor_sink")
class TensorSink(Sink):
    """Collects frames (as numpy) and fires callbacks.

    Props: max-stored (ring of retained frames, default unlimited).
    Callback registration: ``sink.connect("new-data", fn)`` / ``"eos"``.
    Each stored frame's ``meta["render_t"]`` is the host clock
    (``time.perf_counter``) at which it reached the sink.
    """

    FACTORY_NAME = "tensor_sink"

    PROPERTIES = {
        "max-stored": PropSpec("int", 0, desc="retained frames; 0 = all"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.max_stored = int(self.get_property("max-stored", 0))
        self.frames: List[Frame] = []
        self.eos_seen = False
        self._callbacks = {"new-data": [], "eos": []}
        self.rendered = 0

    def connect(self, signal: str, fn: Callable) -> None:
        self._callbacks[signal].append(fn)

    def render(self, frame: Frame) -> None:
        frame = self.host_frame(frame)
        frame = frame.with_meta(render_t=time.perf_counter())
        self.rendered += 1
        self.frames.append(frame)
        if self.max_stored > 0 and len(self.frames) > self.max_stored:
            self.frames.pop(0)
        for fn in self._callbacks["new-data"]:
            fn(frame)

    def on_eos(self) -> None:
        self.eos_seen = True
        for fn in self._callbacks["eos"]:
            fn()


@registry.element("appsink")
class AppSink(Sink):
    """Blocking ``pop()`` for application threads: each frame as numpy."""

    FACTORY_NAME = "appsink"

    PROPERTIES = {
        "max-buffers": PropSpec("int", 0, desc="pop queue bound; 0 = unbounded"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._queue: queue.Queue = queue.Queue(
            maxsize=int(self.get_property("max-buffers", 0)) or 0
        )
        self.eos_seen = False

    def render(self, frame: Frame) -> None:
        self._queue.put(frame.to_host())

    def on_eos(self) -> None:
        self.eos_seen = True
        self._queue.put(None)

    def pop(self, timeout: Optional[float] = None) -> Optional[Frame]:
        """The next frame, or None at EOS."""
        return self._queue.get(timeout=timeout)


@registry.element("filesink")
class FileSink(Sink):
    """Dump raw tensor bytes. location with ``%d`` → one file per frame
    (multifilesink parity, what the golden tests compare)."""

    FACTORY_NAME = "filesink"

    PROPERTIES = {
        "location": PropSpec(
            "str", "", desc="output path; %d = one file per frame"
        ),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.location = str(self.get_property("location", ""))
        if not self.location:
            raise ValueError(f"{self.name}: filesink needs location=")
        self._multi = "%" in self.location
        self._file = None
        self._index = 0
        self.rendered = 0

    def start(self) -> None:
        if not self._multi:
            self._file = open(self.location, "wb")
        self._index = 0

    def render(self, frame: Frame) -> None:
        frame = self.host_frame(frame)
        payload = b"".join(
            np.ascontiguousarray(t).tobytes() for t in frame.tensors
        )
        if self._multi:
            with open(self.location % self._index, "wb") as f:
                f.write(payload)
        else:
            self._file.write(payload)
        self._index += 1
        self.rendered += 1

    def stop(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None


@registry.element("fakesink")
class FakeSink(Sink):
    """Discard frames (keeps a count). Waits for the device work behind
    each frame, so backpressure reflects real compute."""

    FACTORY_NAME = "fakesink"

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.rendered = 0

    def render(self, frame: Frame) -> None:
        for t in frame.tensors:
            if getattr(t, "is_cuda", False):
                torch.cuda.current_stream(t.device).synchronize()
        self.rendered += 1
