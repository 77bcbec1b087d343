"""Tracing and profiling: chrome-trace spans and the device profiler.

The counterpart of ``nnstreamer_tpu/trace.py`` (the in-tree stand-in for
GstShark / NNShark / HawkTracer, whose common output is chrome://tracing
JSON):

- ``Tracer``: a lock-protected bounded event buffer; ``span()`` and
  ``complete()`` record "X" (complete) events per element and frame,
  ``instant()`` marks points, ``counter()`` tracks gauges, ``batch()``
  records a batch window, ``fault()`` / ``san()`` the fault layer's and
  the sanitizer's events. ``save()`` atomically writes the Chrome Trace
  Event Format JSON that chrome://tracing and Perfetto load.
- Lanes are labelled: each OS thread gets a stable small tid (first-seen
  order) and ``to_chrome_trace()`` emits ``thread_name`` /
  ``process_name`` metadata, so the viewer shows the node threads' names.
- The buffer is bounded (``max_events``, drop-oldest); ``dropped_events``
  counts what the window lost.
- :func:`merge` folds several processes' trace documents into ONE
  timeline, shifting each by its wall-clock anchor.
- The executor records one span per frame per node when tracing is on
  (pipeline/executor.py ``_Node.stat``).
- ``device_profile(logdir)``: ``torch.profiler`` with CPU and CUDA
  activities around a block, writing a Chrome trace of the host ops and
  the device kernels into ``logdir`` (the reference wraps
  ``jax.profiler.trace`` there). The profiler may drop records of a
  window's edges: read its kernels for presence, never for exact counts.

Enable via ``trace.enable()`` / ``nns-launch --trace out.json``; the env
knob ``NNS_TRACE`` (a path) turns it on too.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

_lock = threading.Lock()
_tracer: Optional["Tracer"] = None

# drop-oldest window: ~100 MB of JSON at worst, hours of steady-state
# pipeline spans — a soak run records a sliding window, not a leak
DEFAULT_MAX_EVENTS = 500_000


class Tracer:
    def __init__(
        self,
        process: Optional[str] = None,
        max_events: int = DEFAULT_MAX_EVENTS,
        pid: Optional[int] = None,
    ) -> None:
        self._lock = threading.Lock()
        self._max = max(1, int(max_events))
        self._events: deque = deque(maxlen=self._max)
        self.dropped_events = 0
        self._t0 = time.perf_counter()
        # wall-clock anchor paired with the perf_counter epoch: merge()
        # uses the DIFFERENCE of anchors across processes, so absolute
        # wall accuracy only needs to hold to NTP-ish precision
        self._wall_t0 = time.time()
        self._pid = os.getpid() if pid is None else int(pid)
        self.process = process or f"pid{self._pid}"
        # stable small tids: ident → 1,2,3... in first-seen order. The
        # old `get_ident() & 0xFFFF` truncation collided unrelated
        # threads into one Perfetto lane.
        self._tids: Dict[int, int] = {}
        self._tid_names: Dict[int, str] = {}

    # -- recording ---------------------------------------------------------
    def _ts_us(self, t: Optional[float] = None) -> float:
        return ((t if t is not None else time.perf_counter()) - self._t0) * 1e6

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)  # GIL-atomic fast path
        if tid is None:
            with self._lock:
                tid = self._tids.get(ident)
                if tid is None:
                    tid = len(self._tids) + 1
                    self._tids[ident] = tid
                    self._tid_names[tid] = threading.current_thread().name
        return tid

    def set_process(self, name: str) -> None:
        """Label this process's lanes (shows as the Perfetto process
        name; merge() keys the combined timeline on it)."""
        self.process = name

    def _append(self, ev: Dict) -> None:
        with self._lock:
            if len(self._events) >= self._max:
                self.dropped_events += 1
            self._events.append(ev)

    def complete(
        self, name: str, cat: str, t_start: float, dur_s: float, args: Optional[Dict] = None
    ) -> None:
        ev = {
            "name": name,
            "cat": cat,
            "ph": "X",
            "ts": self._ts_us(t_start),
            "dur": dur_s * 1e6,
            "pid": self._pid,
            "tid": self._tid(),
        }
        if args:
            ev["args"] = args
        self._append(ev)

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "element", **args):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.complete(name, cat, t0, time.perf_counter() - t0, args or None)

    def batch(
        self, name: str, t_start: float, dur_s: float, *, batch: int,
        bucket: int, wait_s: float, **extra
    ) -> None:
        """Batch-assembly span (micro-batching, pipeline/batching.py):
        one "X" event per batched invoke carrying the batch size, the
        padded bucket it dispatched as, the pad waste that padding cost,
        and how long the collector waited for stragglers — the three
        numbers that explain where batched throughput (or latency) went."""
        waste = 100.0 * (bucket - batch) / bucket if bucket else 0.0
        self.complete(
            name, "batch", t_start, dur_s,
            {
                "batch": batch,
                "bucket": bucket,
                "wait_ms": round(wait_s * 1000.0, 3),
                "pad_waste_pct": round(waste, 2),
                **extra,
            },
        )

    def fault(self, name: str, action: str, exc=None, **extra) -> None:
        """Fault-layer event (pipeline/faults.py): one instant marker per
        retry/drop/route/stall so the timeline shows where the error
        policies worked and what they cost."""
        args = {"action": action, **extra}
        if exc is not None:
            args["error"] = type(exc).__name__
        self.instant(name, cat="fault", **args)

    def san(self, name: str, code: str, **extra) -> None:
        """Sanitizer finding (pipeline/sanitize.py): one instant marker
        per NNS-S diagnostic so spec violations, accounting leaks, lock
        cycles and thread leaks land on the same timeline as the frames
        that caused them."""
        self.instant(name, cat="san", code=code, **extra)

    def instant(self, name: str, cat: str = "event", **args) -> None:
        self._append(
            {
                "name": name, "cat": cat, "ph": "i", "s": "t",
                "ts": self._ts_us(), "pid": self._pid,
                "tid": self._tid(),
                "args": args or {},
            }
        )

    def counter(self, name: str, **values: float) -> None:
        self._append(
            {
                "name": name, "cat": "counter", "ph": "C",
                "ts": self._ts_us(), "pid": self._pid, "tid": 0,
                "args": values,
            }
        )

    # -- output ------------------------------------------------------------
    def events(self) -> List[Dict]:
        with self._lock:
            return list(self._events)

    def _metadata_events(self) -> List[Dict]:
        """Chrome "M" metadata: process_name + one thread_name per lane,
        synthesized at export (not stored) so the recording buffer holds
        only real events and events() stays metadata-free."""
        meta = [{
            "name": "process_name", "ph": "M", "ts": 0, "pid": self._pid,
            "tid": 0, "args": {"name": self.process},
        }]
        with self._lock:
            names = dict(self._tid_names)
        for tid, tname in sorted(names.items()):
            meta.append({
                "name": "thread_name", "ph": "M", "ts": 0,
                "pid": self._pid, "tid": tid, "args": {"name": tname},
            })
        return meta

    def to_chrome_trace(self) -> Dict:
        return {
            "traceEvents": self._metadata_events() + self.events(),
            "displayTimeUnit": "ms",
            "otherData": {
                "process": self.process,
                "pid": self._pid,
                "wall_t0_s": self._wall_t0,
                "dropped_events": self.dropped_events,
            },
        }

    def save(self, path: str) -> None:
        """Atomic write (tmp + rename): a crash mid-dump — or a reader
        polling the file during a soak run — never sees a torn JSON."""
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        os.replace(tmp, path)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped_events = 0


def merge(docs: Sequence[Dict]) -> Dict:
    """Fold several processes' chrome-trace docs into ONE timeline.

    Each doc carries its wall-clock anchor (``otherData.wall_t0_s``);
    events shift by the anchor delta against the earliest doc, so a
    client span and the server span it caused line up on one axis
    (client + tensor_query server traces merge into the end-to-end
    view examples/query_offload.py needed). Docs without an anchor
    merge unshifted. Colliding pids (containers, pid reuse) are
    remapped so lanes never interleave across processes.
    """
    anchors = [
        (d.get("otherData") or {}).get("wall_t0_s") for d in docs
    ]
    known = [a for a in anchors if a is not None]
    base = min(known) if known else 0.0
    events: List[Dict] = []
    processes = []
    assigned_pids: set = set()
    for doc, anchor in zip(docs, anchors):
        shift_us = ((anchor - base) * 1e6) if anchor is not None else 0.0
        other = doc.get("otherData") or {}
        if other.get("process"):
            processes.append(other["process"])
        doc_pids = {
            e.get("pid") for e in doc.get("traceEvents", [])
            if e.get("pid") is not None
        }
        remap = {}
        for pid in sorted(doc_pids, key=str):
            new = pid
            while new in assigned_pids:
                new = (new if isinstance(new, int) else 0) + 100_000
            remap[pid] = new
            assigned_pids.add(new)
        for ev in doc.get("traceEvents", []):
            ev = dict(ev)
            if "ts" in ev:
                ev["ts"] = ev["ts"] + shift_us
            if ev.get("pid") in remap:
                ev["pid"] = remap[ev["pid"]]
            events.append(ev)
    events.sort(key=lambda e: (e.get("ts", 0), e.get("ph") != "M"))
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"merged_processes": processes},
    }


def enable() -> Tracer:
    """Install (or return) the global tracer; executor nodes start
    recording as soon as this exists."""
    global _tracer
    with _lock:
        if _tracer is None:
            _tracer = Tracer()
        return _tracer


def disable() -> None:
    global _tracer
    with _lock:
        _tracer = None


_env_checked = False


def get() -> Optional[Tracer]:
    """Active tracer or None (the hot-path check: one global read).
    The ``NNS_TRACE`` env opt-in is resolved on the FIRST miss only —
    this runs per frame per node at multi-kfps, and an environ lookup
    each call is a measurable slice of the executor's frame budget."""
    t = _tracer
    if t is None:
        global _env_checked
        if not _env_checked:
            _env_checked = True
            if os.environ.get("NNS_TRACE"):
                t = enable()
    return t


@contextlib.contextmanager
def device_profile(logdir: str):
    """``torch.profiler`` over the block, CPU and (when a GPU is present)
    CUDA activities, its Chrome trace written to
    ``logdir/device_profile.json`` when the block ends. The device-side
    complement to the host spans of :class:`Tracer`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(logdir, "device_profile.json"))
