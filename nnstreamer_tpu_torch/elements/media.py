"""Real media ingress: encoded video files, still images, V4L2 cameras.

The counterpart of ``nnstreamer_tpu/elements/media.py``. ``cv2`` is
imported when an element starts, never at import, and its absence raises
an ``ElementError`` naming it (the machine with the card has no OpenCV).

Reference: a gst-launch pipeline starts at ``v4l2src`` or ``filesrc !
decodebin`` and ``tensor_converter`` ingests decoded video/x-raw frames
with stride handling (gst/nnstreamer/elements/gsttensor_converter.c:
1046-1270). This framework's analogue decodes on host via OpenCV's
ffmpeg-backed VideoCapture (gated like the reference's meson options) and
emits tight RGB/BGR HWC uint8 frames into the normal video path — the
converter/filter chain downstream is identical to the synthetic-source
case, so a camera pipeline and a videotestsrc pipeline share every
compiled program.

Elements:

- ``videofilesrc location=clip.mp4``: decode a video file (any
  container/codec the image's OpenCV+ffmpeg build supports), or a still
  image (png/jpg/bmp — emitted once, or repeatedly with num-frames=N).
  Props: format=RGB|BGR|GRAY8 (default RGB), loop=true (rewind at EOF),
  framerate override, num-frames cap.
- ``v4l2src device=/dev/video0``: live camera capture through the same
  OpenCV backend. Props: device (path or index), width/height/framerate
  requests, format, num-frames.
"""

from __future__ import annotations

import queue as queue_mod
import threading
from fractions import Fraction
from typing import Callable, Optional

import numpy as np

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.elements.base import (
    ElementError,
    MediaSpec,
    PropSpec,
    Source,
    Spec,
    parse_bool,
)
from nnstreamer_tpu_torch.elements.sources import _frame_pts
from nnstreamer_tpu_torch.tensors.frame import EOS_FRAME, Frame

_IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp", ".tif", ".tiff")


def _require_cv2():
    try:
        import cv2

        return cv2
    except ImportError as exc:
        raise ElementError(
            "opencv (cv2) unavailable; media file/camera sources are gated "
            "(like the reference's meson-gated decodebin path)"
        ) from exc


def _to_format(cv2, bgr: np.ndarray, fmt: str) -> np.ndarray:
    """BGR decode buffer → requested format, tight layout (the stride-
    handling contract: whatever the decoder's layout, the emitted tensor
    is contiguous — the converter never sees padded rows)."""
    if fmt == "BGR":
        out = bgr
    elif fmt == "RGB":
        out = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
    elif fmt == "GRAY8":
        out = cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)[..., None]
    else:
        raise ElementError(f"unsupported format {fmt!r} (RGB/BGR/GRAY8)")
    return np.ascontiguousarray(out)


_EOF = object()


class _DecodeAhead:
    """Decode-ahead thread + bounded frame queue.

    Synchronous decode on the source thread serializes decode with the
    pipeline's per-frame host work — at target rates the decoder must
    run WHILE the previous frame uploads/infers, the role the kernel's
    buffer queue plays for the reference's v4l2src (its converter is
    handed already-queued buffers, gsttensor_converter.c:1046-1270).
    A single dedicated thread pulls frames from ``read_fn`` into a
    bounded FIFO; the source's generate() pops. Order and PTS are
    preserved by construction: one decoder thread + one FIFO means
    frames leave in decode order, and the consumer stamps PTS from its
    own monotone counter — overlap can neither reorder nor re-stamp.

    ``depth`` bounds decoded-but-unconsumed frames (memory AND, for a
    live camera, the staleness window)."""

    def __init__(self, read_fn: Callable[[], Optional[np.ndarray]],
                 depth: int = 8) -> None:
        self._read = read_fn  # returns a decoded frame or None at EOF
        self._q: queue_mod.Queue = queue_mod.Queue(maxsize=max(1, depth))
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._stop_evt.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="decode-ahead"
        )
        self._thread.start()

    def _run(self) -> None:
        while not self._stop_evt.is_set():
            img = self._read()
            item = _EOF if img is None else img
            while True:
                try:
                    self._q.put(item, timeout=0.1)
                    break
                except queue_mod.Full:
                    if self._stop_evt.is_set():
                        return
            if item is _EOF:
                return

    def get(self, timeout: float = 0.1):
        """Next decoded frame; _EOF at end of stream; None when the
        decoder hasn't produced one yet (caller re-polls — the Source
        contract's no-data-yet value)."""
        try:
            return self._q.get(timeout=timeout)
        except queue_mod.Empty:
            return None

    def stop(self) -> bool:
        """Stop the decode thread. Returns True when it actually
        joined — False means it is still blocked inside the decoder
        (e.g. a wedged camera read), and the CALLER MUST NOT release
        the underlying capture handle (a native read racing release()
        is a use-after-free inside the decoder; leaking the handle to
        the daemon thread is the safe failure)."""
        self._stop_evt.set()
        if self._thread is None:
            return True
        # unblock a put() stuck on a full queue, then join
        try:
            while True:
                self._q.get_nowait()
        except queue_mod.Empty:
            pass
        self._thread.join(timeout=5.0)
        joined = not self._thread.is_alive()
        if joined:
            self._thread = None
        return joined


@registry.element("videofilesrc")
class VideoFileSrc(Source):
    """Decode an encoded video (or still image) file into video frames.

    Decoding runs on a decode-ahead thread (prop ``decode-ahead``, the
    queue depth, default 8; 0 = synchronous decode on the source
    thread), overlapping decode with downstream upload/inference."""

    FACTORY_NAME = "videofilesrc"

    PROPERTIES = {
        "location": PropSpec("str", "", desc="video/image file path"),
        "format": PropSpec("enum", "RGB", ("RGB", "BGR", "RGBA", "GRAY8")),
        "loop": PropSpec("bool", False),
        "num-frames": PropSpec("int", -1, desc="-1 = whole file"),
        "decode-ahead": PropSpec("int", 8, desc="0 = synchronous decode"),
        "framerate": PropSpec("fraction", None, desc="override file rate"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.location = str(self.get_property("location", ""))
        self.format = str(self.get_property("format", "RGB")).upper()
        self.loop = parse_bool(self.get_property("loop", False))
        self.num_frames = int(self.get_property("num-frames", -1))
        self.decode_ahead = int(self.get_property("decode-ahead", 8))
        self._rate_override = self.get_property("framerate")
        if not self.location:
            raise ValueError(f"{self.name}: videofilesrc needs location=")
        self._cap = None
        self._ahead: Optional[_DecodeAhead] = None
        self._image: Optional[np.ndarray] = None
        self._i = 0
        # probe at build time so negotiation has real width/height/rate
        # (the reference's decodebin caps become known the same way)
        self._probe()

    def _is_image(self) -> bool:
        return self.location.lower().endswith(_IMAGE_EXTS)

    def _probe(self) -> None:
        cv2 = _require_cv2()
        if self._is_image():
            bgr = cv2.imread(self.location, cv2.IMREAD_COLOR)
            if bgr is None:
                raise ElementError(
                    f"{self.name}: cannot decode image {self.location!r}"
                )
            self._image = _to_format(cv2, bgr, self.format)
            h, w = self._image.shape[:2]
            self._size = (w, h)
            self._rate = (
                Fraction(str(self._rate_override))
                if self._rate_override
                else None
            )
            if self.num_frames < 0:
                self.num_frames = 1
            return
        cap = cv2.VideoCapture(self.location)
        if not cap.isOpened():
            raise ElementError(
                f"{self.name}: cannot open video {self.location!r}"
            )
        w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        fps = cap.get(cv2.CAP_PROP_FPS) or 0.0
        cap.release()
        if w <= 0 or h <= 0:
            raise ElementError(
                f"{self.name}: {self.location!r} reports no frame size"
            )
        self._size = (w, h)
        if self._rate_override:
            self._rate = Fraction(str(self._rate_override))
        else:
            self._rate = (
                Fraction(fps).limit_denominator(1000) if fps > 0 else None
            )

    def output_spec(self) -> Spec:
        w, h = self._size
        return MediaSpec(
            "video", width=w, height=h, format=self.format, rate=self._rate
        )

    def start(self) -> None:
        self._i = 0
        if self._image is None:
            cv2 = _require_cv2()
            self._cap = cv2.VideoCapture(self.location)
            if not self._cap.isOpened():
                raise ElementError(
                    f"{self.name}: cannot open video {self.location!r}"
                )
            if self.decode_ahead > 0:
                cap = self._cap  # bind THIS handle into the thread: if a
                # wedged stop() later orphans it, the orphan keeps
                # reading its own capture and never touches a fresh one
                self._ahead = _DecodeAhead(
                    lambda: self._read_one(cap), depth=self.decode_ahead
                )
                self._ahead.start()

    def stop(self) -> None:
        joined = True
        if self._ahead is not None:
            joined = self._ahead.stop()
            self._ahead = None
        if self._cap is not None:
            if joined:
                self._cap.release()
            # else: the decode thread is still inside read() on its
            # bound handle — leave the native handle to the orphan
            # (release() racing a native read is a use-after-free).
            # Either way drop OUR reference so a later start() opens a
            # fresh capture instead of sharing the wedged one (two
            # native readers on one OpenCV handle is the same race
            # stop() just avoided).
            self._cap = None

    def _read_one(self, cap=None) -> Optional[np.ndarray]:
        """Decode the next frame (loop-rewinding at EOF); runs on the
        decode-ahead thread when enabled (with its bound handle), else
        the source thread (on self._cap)."""
        cv2 = _require_cv2()
        if cap is None:
            cap = self._cap
        ret, bgr = cap.read()
        if not ret:
            if self.loop:
                cap.set(cv2.CAP_PROP_POS_FRAMES, 0)
                ret, bgr = cap.read()
            if not ret:
                return None
        return _to_format(cv2, bgr, self.format)

    def generate(self):
        if 0 <= self.num_frames <= self._i:
            return EOS_FRAME
        if self._image is not None:
            img = self._image
        elif self._ahead is not None:
            img = self._ahead.get()
            if img is None:
                return None  # decoder busy: no data yet, re-poll
            if img is _EOF:
                return EOS_FRAME
        else:
            img = self._read_one()
            if img is None:
                return EOS_FRAME
        pts, dur = _frame_pts(self._i, self._rate)
        self._i += 1
        return Frame((img,), pts=pts, duration=dur, meta={"media_type": "video"})


@registry.element("v4l2src")
class V4l2Src(Source):
    """Live camera capture (V4L2 device or camera index) via OpenCV.

    Capture runs on a decode-ahead thread (prop ``decode-ahead``, queue
    depth, default 4 — small: for a LIVE source the queue depth is also
    the staleness window; 0 = synchronous capture)."""

    FACTORY_NAME = "v4l2src"

    PROPERTIES = {
        "device": PropSpec("str", 0, desc="V4L2 node or camera index"),
        "format": PropSpec("enum", "RGB", ("RGB", "BGR", "RGBA", "GRAY8")),
        "num-frames": PropSpec("int", -1),
        "width": PropSpec("int", 0, desc="0 = camera default"),
        "height": PropSpec("int", 0, desc="0 = camera default"),
        "decode-ahead": PropSpec("int", 4, desc="0 = synchronous capture"),
        "framerate": PropSpec("fraction", None),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        dev = self.get_property("device", 0)
        try:
            self.camera = int(dev)
        except (TypeError, ValueError):
            self.camera = str(dev)
        self.format = str(self.get_property("format", "RGB")).upper()
        self.num_frames = int(self.get_property("num-frames", -1))
        self.req_width = int(self.get_property("width", 0))
        self.req_height = int(self.get_property("height", 0))
        self.decode_ahead = int(self.get_property("decode-ahead", 4))
        self._rate_override = self.get_property("framerate")
        self._cap = None
        self._ahead: Optional[_DecodeAhead] = None
        self._i = 0
        self._probe()

    def _open_cap(self):
        """Open the device and (re)apply the requested capture geometry —
        a released camera reverts to driver defaults, so every reopen
        must re-set the props or frames stop matching the negotiated
        spec."""
        cv2 = _require_cv2()
        cap = cv2.VideoCapture(self.camera)
        if not cap.isOpened():
            raise ElementError(
                f"{self.name}: cannot open camera {self.camera!r}"
            )
        if self.req_width:
            cap.set(cv2.CAP_PROP_FRAME_WIDTH, self.req_width)
        if self.req_height:
            cap.set(cv2.CAP_PROP_FRAME_HEIGHT, self.req_height)
        return cap

    def _probe(self) -> None:
        cv2 = _require_cv2()
        cap = self._open_cap()
        w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        fps = cap.get(cv2.CAP_PROP_FPS) or 0.0
        self._cap = cap  # keep the claim: cameras are exclusive devices
        if w <= 0 or h <= 0:
            cap.release()
            self._cap = None
            raise ElementError(
                f"{self.name}: camera {self.camera!r} reports no frame size"
            )
        self._size = (w, h)
        if self._rate_override:
            self._rate = Fraction(str(self._rate_override))
        else:
            self._rate = (
                Fraction(fps).limit_denominator(1000) if fps > 0 else None
            )

    def output_spec(self) -> Spec:
        w, h = self._size
        return MediaSpec(
            "video", width=w, height=h, format=self.format, rate=self._rate
        )

    def start(self) -> None:
        self._i = 0
        if self._cap is None:
            self._cap = self._open_cap()
        if self.decode_ahead > 0 and self._ahead is None:
            cap = self._cap  # bound handle: an orphaned thread keeps it
            self._ahead = _DecodeAhead(
                lambda: self._read_one(cap), depth=self.decode_ahead
            )
            self._ahead.start()

    def stop(self) -> None:
        joined = True
        if self._ahead is not None:
            joined = self._ahead.stop()
            self._ahead = None
        if self._cap is not None:
            if joined:
                self._cap.release()
            # else: wedged camera read in flight — the orphan thread
            # keeps its bound handle (leak, don't race). Drop our
            # reference regardless so a restart opens a fresh capture
            # rather than sharing the wedged one.
            self._cap = None

    def _read_one(self, cap=None) -> Optional[np.ndarray]:
        cv2 = _require_cv2()
        if cap is None:
            cap = self._cap
        ret, bgr = cap.read()
        if not ret:
            return None
        return _to_format(cv2, bgr, self.format)

    def generate(self):
        if 0 <= self.num_frames <= self._i:
            return EOS_FRAME
        if self._ahead is not None:
            img = self._ahead.get()
            if img is None:
                return None  # capture in flight: no data yet, re-poll
            if img is _EOF:
                return EOS_FRAME
        else:
            img = self._read_one()
            if img is None:
                return EOS_FRAME
        pts, dur = _frame_pts(self._i, self._rate)
        self._i += 1
        return Frame((img,), pts=pts, duration=dur, meta={"media_type": "video"})
