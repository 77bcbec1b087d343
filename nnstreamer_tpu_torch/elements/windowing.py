"""Temporal elements: tensor_aggregator (sliding-window batching) and
tensor_rate (framerate conversion + throttling).

The counterpart of ``nnstreamer_tpu/elements/windowing.py``; the
aggregator concatenates with torch on the pipeline's device. Reference:
gsttensor_aggregator.c (frames-in/out/flush over GstAdapter, semantics
gsttensor_aggregator.md) and gsttensor_rate.c (dup/drop rate conversion +
upstream QoS throttle :27-36). In this runtime backpressure
from bounded queues replaces upstream QoS events; `throttle=true` instead
rate-limits emission.

The aggregator is a micro-batching lever: place it before tensor_filter
to trade latency for a larger batch (along frames-dim, which for NHWC
tensors is the leading axis).
"""

from __future__ import annotations

import time
from fractions import Fraction
from typing import List, Optional, Union

import torch

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.elements.base import HostElement, NegotiationError, PropSpec, Spec
from nnstreamer_tpu_torch.tensors.frame import Frame, SECOND
from nnstreamer_tpu_torch.tensors.spec import TensorSpec, TensorsSpec


@registry.element("tensor_aggregator")
class TensorAggregator(HostElement):
    """Sliding-window frame aggregation.

    Props (reference parity): frames-in (frames per incoming buffer,
    default 1), frames-out (frames per outgoing buffer), frames-flush
    (window advance, default frames-out → tumbling; < frames-out →
    overlapping sliding window), frames-dim (reference innermost-first dim
    index to concat along), concat (reference gsttensor_aggregator.c:221-226;
    false → don't merge along frames-dim, stack the window on a new leading
    axis instead).
    """

    FACTORY_NAME = "tensor_aggregator"

    PROPERTIES = {
        "frames-in": PropSpec("int", 1),
        "frames-out": PropSpec("int", 1),
        "frames-flush": PropSpec("int", 0, desc="0 = frames-out (tumbling)"),
        "frames-dim": PropSpec(
            "int", None, desc="innermost-first dim index to concat along"
        ),
        "concat": PropSpec("bool", True),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.frames_in = int(self.get_property("frames-in", 1))
        self.frames_out = int(self.get_property("frames-out", 1))
        self.frames_flush = int(self.get_property("frames-flush", 0)) or self.frames_out
        self.ref_dim = self.get_property("frames-dim")
        self.concat = str(self.get_property("concat", "true")).lower() not in (
            "false", "0", "no",
        )
        if self.frames_in <= 0 or self.frames_out <= 0 or self.frames_flush <= 0:
            raise ValueError(f"{self.name}: frames-* must be positive")
        self._window: List[Frame] = []
        self._axis: int = 0

    def negotiate(self, in_specs: List[Spec]) -> List[Spec]:
        (spec,) = in_specs
        if not isinstance(spec, TensorsSpec):
            raise NegotiationError(f"{self.name}: needs tensor input")
        rank = spec[0].rank
        self._axis = (
            rank - 1 - int(self.ref_dim) if self.ref_dim is not None else 0
        )
        if not (0 <= self._axis < rank):
            raise NegotiationError(f"{self.name}: frames-dim out of range")
        if self.frames_out % self.frames_in != 0:
            raise NegotiationError(
                f"{self.name}: frames-out {self.frames_out} not a multiple of "
                f"frames-in {self.frames_in}"
            )
        if self.frames_flush % self.frames_in != 0:
            raise NegotiationError(
                f"{self.name}: frames-flush {self.frames_flush} not a multiple "
                f"of frames-in {self.frames_in}"
            )
        factor = self.frames_out // self.frames_in
        outs = []
        for t in spec:
            if t.rank != rank:
                raise NegotiationError(f"{self.name}: mixed ranks unsupported")
            if self.concat:
                shape = list(t.shape)
                shape[self._axis] = shape[self._axis] * factor
            else:
                shape = [factor] + list(t.shape)
            outs.append(TensorSpec(tuple(shape), t.dtype))
        rate = spec.rate * Fraction(self.frames_in, self.frames_flush) if spec.rate else None
        return [TensorsSpec(tuple(outs), spec.format, rate)]

    def process(self, frame: Frame) -> Optional[Frame]:
        self._window.append(frame.to_device(self.device))
        need = self.frames_out // self.frames_in
        if len(self._window) < need:
            return None
        group = self._window[:need]
        tensors = []
        for ti in range(group[0].num_tensors):
            parts = [f.tensors[ti] for f in group]
            tensors.append(
                torch.cat(parts, dim=self._axis)
                if self.concat
                else torch.stack(parts, dim=0)
            )
        first = group[0]
        out = Frame(
            tuple(tensors),
            pts=first.pts,
            duration=(
                first.duration * need if first.duration is not None else None
            ),
            meta=dict(first.meta),
        )
        advance = max(1, self.frames_flush // self.frames_in)
        del self._window[:advance]
        return out

    def stop(self) -> None:
        self._window.clear()


class RateQoS:
    """Shared drop-ahead hint published by tensor_rate, consulted by
    upstream producers (the reference's upstream QoS event,
    gsttensor_rate.c:452, pulled instead of pushed).

    ``next_ts`` only ever increases, so a stale read is conservative: a
    frame judged droppable against an old (smaller) next_ts is also
    dropped by the current one — no lock needed."""

    def __init__(self, enabled: bool = True) -> None:
        self.enabled = enabled
        self.next_ts: Optional[int] = None
        self.skipped_upstream = 0  # producers increment when they skip

    def would_drop(self, pts: Optional[int], duration: Optional[int]) -> bool:
        nt = self.next_ts
        if not self.enabled or nt is None or pts is None:
            return False
        if duration is None:
            return pts < nt
        return pts + duration <= nt


@registry.element("tensor_rate")
class TensorRate(HostElement):
    """Framerate conversion by PTS-based dup/drop, plus optional wall-clock
    throttling (the compute-saving use of reference tensor_rate).

    Props: framerate="15/1" (target), throttle=true|false (sleep to cap
    real-time emission rate), qos=true|false (default true: publish the
    next-needed timestamp upstream so producers skip frames this element
    would drop — the reference's upstream QoS events,
    gsttensor_rate.c:27-36,452).
    """

    FACTORY_NAME = "tensor_rate"

    PROPERTIES = {
        "framerate": PropSpec("fraction", None, desc="target rate"),
        "throttle": PropSpec("bool", False),
        "qos": PropSpec("bool", True),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        fr = self.get_property("framerate")
        self.target: Optional[Fraction] = Fraction(str(fr)) if fr else None
        self.throttle = str(self.get_property("throttle", "false")).lower() in (
            "1", "true", "yes",
        )
        self.qos = RateQoS(
            enabled=str(self.get_property("qos", "true")).lower()
            in ("1", "true", "yes")
        )
        self._next_ts: Optional[int] = None
        self._last_emit_wall = 0.0
        self.dup = 0
        self.drop = 0

    def negotiate(self, in_specs: List[Spec]) -> List[Spec]:
        (spec,) = in_specs
        if not isinstance(spec, TensorsSpec):
            raise NegotiationError(f"{self.name}: needs tensor input")
        if self.target is None:
            raise NegotiationError(f"{self.name}: tensor_rate needs framerate=")
        return [spec.with_rate(self.target)]

    def _throttle_wait(self) -> None:
        if not self.throttle or self.target is None:
            return
        min_gap = float(1 / self.target)
        now = time.monotonic()
        wait = self._last_emit_wall + min_gap - now
        if wait > 0:
            time.sleep(wait)
        self._last_emit_wall = time.monotonic()

    def process(self, frame: Frame) -> Union[Frame, List[Frame], None]:
        if frame.pts is None or self.target is None:
            self._throttle_wait()
            return frame
        out_dur = int(SECOND / self.target)
        if self._next_ts is None:
            self._next_ts = frame.pts
        out: List[Frame] = []
        in_end = frame.pts + (frame.duration or 0)
        # emit one output per target slot covered by this input frame
        while self._next_ts < in_end or (frame.duration is None and self._next_ts <= frame.pts):
            out.append(frame.with_pts(self._next_ts, out_dur))
            self._next_ts += out_dur
            if frame.duration is None:
                break
        self.qos.next_ts = self._next_ts  # publish drop-ahead hint upstream
        if not out:
            self.drop += 1
            return None
        if len(out) > 1:
            self.dup += len(out) - 1
        for _ in out:
            self._throttle_wait()
        return out

    def drop_stats(self) -> dict:
        """Frames removed from the stream, by reason (Executor.totals).
        Includes frames an UPSTREAM producer skipped on this element's
        QoS hint — they were produced (counted) but will never arrive
        here, so without this reason the pipeline balance would report
        a phantom leak."""
        return {
            "rate-drop": self.drop,
            "rate-qos-skip": self.qos.skipped_upstream,
        }

    def create_stats(self) -> dict:
        """Frames this element added to the stream (PTS dup)."""
        return {"rate-dup": self.dup}

    def stop(self) -> None:
        self._next_ts = None
