"""Weighted-fair cross-stream scheduling for the serving plane.

The counterpart of ``nnstreamer_tpu/serving_plane/scheduler.py`` (pure
Python, kept here as the port's own copy). A :class:`ModelPlane`
collects frames from N client streams into one device batch. Plain
drain-in-arrival-order would let one hot stream (a client flooding its
queue) fill every batch while trickle streams wait unboundedly. This
module is deficit round robin one layer down, at the device batcher:

- :class:`PlaneStream` — one attached client stream: a FIFO of pending
  requests plus a weight and the DRR deficit counter.
- :class:`StreamScheduler` — deficit-round-robin collection: each
  collection round credits every backlogged stream ``weight`` slots and
  takes frames while credit lasts, rotating the start stream so no
  stream is structurally first. Consequences the tests pin down:

  * per-stream FIFO: a stream's frames enter batches in submission
    order (each queue pops left);
  * starvation bound: a backlogged stream with weight ``w`` receives at
    least ``floor(w)`` of every ``sum(ceil(weights))``-slot collection
    cycle, no matter how deep another stream's backlog is;
  * work conservation: when only one stream is backlogged it gets the
    whole batch (drain-what's-there, the batching.py discipline).

Callers hold the plane lock around :meth:`StreamScheduler.collect`
(single collector, many submitters); the scheduler itself takes no
locks.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, List, Tuple


class PlaneStream:
    """One client stream attached to a plane.

    Counter discipline: ``admitted`` is incremented by the submitting
    executor thread under the plane lock; ``served``/``errors`` only by
    the plane's service thread. Readers (stats) get GIL-atomic snapshot
    reads, the BatchStats convention.
    """

    __slots__ = ("sid", "weight", "deficit", "q", "admitted", "served",
                 "errors", "inflight", "_admit_ctr", "_serve_ctr")

    def __init__(self, sid: str, weight: float = 1.0) -> None:
        self.sid = sid
        self.weight = max(0.01, float(weight))
        self.deficit = 0.0
        self.q: deque = deque()
        self.admitted = 0
        self.served = 0
        self.errors = 0
        # async tickets outstanding (submitted, not yet collected by the
        # stream's wait_window) — inc under the plane lock at submit,
        # dec at wait-side resolution; 0 under blocking submits between
        # round trips
        self.inflight = 0
        # the plane's per-stream counters on the metrics registry (set at
        # attach when one is on)
        self._admit_ctr = None
        self._serve_ctr = None

    @property
    def backlog(self) -> int:
        return len(self.q)

    def snapshot(self) -> Dict[str, Any]:
        return {
            "weight": self.weight,
            "queued": sum(
                len(getattr(r, "frames", (None,))) for r in self.q
            ),
            "admitted": self.admitted,
            "served": self.served,
            "errors": self.errors,
            "inflight": self.inflight,
        }


class StreamScheduler:
    """Deficit round robin over the attached streams (module docstring
    has the contract)."""

    def __init__(self) -> None:
        self._streams: Dict[str, PlaneStream] = {}
        self._rr = 0  # rotation cursor: collection start stream

    # -- membership (plane lock held) --------------------------------------
    def add(self, stream: PlaneStream) -> None:
        if stream.sid in self._streams:
            raise ValueError(f"stream {stream.sid!r} already attached")
        self._streams[stream.sid] = stream

    def remove(self, stream: PlaneStream) -> List[Any]:
        """Detach; returns the stream's still-queued requests so the
        plane can complete them (closed-stream disposal, never silent
        loss)."""
        self._streams.pop(stream.sid, None)
        pending = list(stream.q)
        stream.q.clear()
        return pending

    def streams(self) -> List[PlaneStream]:
        return list(self._streams.values())

    def __len__(self) -> int:
        return len(self._streams)

    @property
    def backlog(self) -> int:
        """Total queued-but-undispatched FRAMES across streams (the
        cross-stream queue depth metric; requests are windows)."""
        return sum(
            len(getattr(r, "frames", (None,)))
            for s in self._streams.values() for r in s.q
        )

    # -- collection (plane lock held) --------------------------------------
    def _rotation(self) -> List[PlaneStream]:
        streams = list(self._streams.values())
        if not streams:
            return streams
        start = self._rr % len(streams)
        self._rr += 1
        return streams[start:] + streams[:start]

    def collect(self, limit: int, at_least_one: bool = True) -> List[Tuple[PlaneStream, Any]]:
        """Pop requests weighted-fairly across backlogged streams until
        ``limit`` FRAMES are collected; [] when nothing is queued.
        Requests are windows (1..k frames — the submitting executor's
        local micro-batch); a request is atomic, so collection stops
        before a window that would overflow the limit (always taking at
        least one, unless ``at_least_one`` is False: the plane's
        straggler top-up, which must not push a dispatch past its cap).
        Fairness is accounted per request — a stream's window size
        reflects its own backlog, its SLOTS are what the weights bound.
        Never blocks."""
        batch: List[Tuple[PlaneStream, Any]] = []
        frames = 0
        if limit <= 0:
            return batch
        rotation = self._rotation()
        full = False
        while not full:
            progressed = False
            for s in rotation:
                if not s.q:
                    continue
                s.deficit += s.weight
                while s.deficit >= 1.0 and s.q:
                    cost = len(getattr(s.q[0], "frames", (None,)))
                    if (batch or not at_least_one) and frames + cost > limit:
                        full = True
                        break
                    batch.append((s, s.q.popleft()))
                    frames += cost
                    s.deficit -= 1.0
                    progressed = True
                    if frames >= limit:
                        full = True
                        break
                if full:
                    break
            if not progressed and not any(s.q for s in rotation):
                break
            # an unprogressed round with backlog means every deficit is
            # still fractional (weights < 1): keep crediting until one
            # crosses 1 — standard DRR cycles rounds until the batch
            # fills or the queues drain, so weights scale RELATIVE
            # share, never absolute pacing (a lone weight-0.1 stream
            # still fills the whole batch). Bounded: each round adds
            # ≥ 0.01 to every backlogged deficit.
        for s in rotation:
            if not s.q:
                # no banked credit: an idle stream must not burst-claim
                # a whole future batch the moment it wakes up
                s.deficit = 0.0
        return batch
