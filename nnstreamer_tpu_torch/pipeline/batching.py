"""Adaptive micro-batching for fused segments and batch-capable filters.

The counterpart of ``nnstreamer_tpu/pipeline/batching.py``: the executor
pipelines frames across nodes, and this layer aggregates the frames queued
at one node into one device program a window, bounding the latency it
adds.

- :class:`BatchConfig` — resolved knobs for one execution node. Stream
  properties (``batching=true``, ``max-batch``, ``batch-timeout-ms``,
  ``batch-buckets`` on ``tensor_filter``) override the executor-level
  defaults of the ``[executor]`` config section (env
  ``NNS_TPU_EXECUTOR_BATCHING`` etc.).
- :class:`BatchCollector` — drains up to ``max-batch`` queued frames from
  a node's inbox. When the inbox is deep it takes what is there and
  returns at once (queue depth is free batch: no added latency under
  load); only when trickle-fed (one frame and an empty inbox) does it wait
  up to ``batch-timeout-ms`` for stragglers.
- :class:`BatchStats` — per-node counters: average batch size, padding
  waste, the collector's wait, surfaced as read-only ``tensor_filter``
  properties and in ``Executor.stats()``.

Window sizes round UP to a bucket ladder (default 1, 2, 4, ..., max-batch)
and pad with replicas of the last frame, so a fused segment builds at most
one program a bucket instead of one a window size. The pad rows are
computed and discarded; ``pad-waste-pct`` reports their share.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Tuple

from nnstreamer_tpu_torch.elements.base import parse_bool
from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.tensors.frame import EOS_FRAME

_log = get_logger("batching")

_POLL_S = 0.05  # bounded waits keep the collector responsive to stop()


def default_buckets(max_batch: int) -> Tuple[int, ...]:
    """Powers of two up to ``max_batch``, always ending exactly at
    ``max_batch`` (max-batch=6 buckets as 1, 2, 4, 6: the cap asked for is
    a real bucket, never overshot)."""
    max_batch = max(1, int(max_batch))
    out: List[int] = []
    b = 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(out)


@dataclass(frozen=True)
class BatchConfig:
    """Resolved micro-batching knobs for one execution node."""

    enabled: bool = False
    max_batch: int = 8
    timeout_ms: float = 1.0
    buckets: Tuple[int, ...] = ()

    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= n (n is already clamped to max_batch)."""
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1] if self.buckets else n

    @property
    def active(self) -> bool:
        return self.enabled and self.max_batch > 1


def _executor_defaults() -> dict:
    """The ``[executor]`` batching defaults (env ``NNS_TPU_EXECUTOR_*``
    over ini). A malformed config value falls back to the built-in default
    with a warning: a typo in an ini line must not fail every pipeline
    (element properties, set on purpose, raise instead)."""
    from nnstreamer_tpu_torch.config import conf

    c = conf()

    def _num(key: str, cast, fallback):
        raw = c.get("executor", key, str(fallback))
        try:
            return cast(raw)
        except ValueError:
            _log.warning("[executor] %s=%r is not a valid %s; using %s",
                         key, raw, cast.__name__, fallback)
            return fallback

    buckets_raw = c.get("executor", "batch_buckets", "").strip()
    try:
        buckets = [int(p) for p in buckets_raw.split(",") if p.strip()]
    except ValueError:
        _log.warning("[executor] batch_buckets=%r is not a comma list of ints; "
                     "using the default ladder", buckets_raw)
        buckets = []
    return {
        "batching": c.get_bool("executor", "batching", False),
        "max-batch": _num("max_batch", int, 8),
        "batch-timeout-ms": _num("batch_timeout_ms", float, 1.0),
        "batch-buckets": buckets,
    }


def _parse_buckets(vals: Optional[List[int]], max_batch: int) -> Tuple[int, ...]:
    if not vals:
        return default_buckets(max_batch)
    kept = sorted({v for v in vals if 1 <= v <= max_batch})
    dropped = sorted(set(vals) - set(kept))
    if dropped:
        # an explicitly configured ladder is not rewritten silently
        _log.warning("batch-buckets entries %s outside [1, max-batch=%d] ignored",
                     dropped, max_batch)
    added = []
    if not kept or kept[-1] != max_batch:
        # full windows need a bucket to run as
        kept.append(max_batch)
        added.append(max_batch)
    if kept[0] != 1:
        # without 1 every lone frame would pad up: trickle traffic stays pad-free
        kept.insert(0, 1)
        added.append(1)
    if added:
        _log.warning("batch-buckets: adding required bucket(s) %s (the ladder spans "
                     "[1, max-batch=%d]); effective ladder %s",
                     sorted(added), max_batch, tuple(kept))
    return tuple(kept)


def resolve_batch_config(elements: Sequence[Any]) -> BatchConfig:
    """Merge element batching properties over the executor default.

    Scans the elements in chain order; for each knob the first element
    that sets it wins. A bad value raises naming the element and the
    property, at plan time."""
    defaults = _executor_defaults()
    enabled: Optional[bool] = None
    max_batch: Optional[int] = None
    timeout_ms: Optional[float] = None
    buckets: Optional[List[int]] = None

    def _coerce(elem, prop: str, fn, raw):
        try:
            return fn(raw)
        except (TypeError, ValueError) as exc:
            raise ValueError(f"{getattr(elem, 'name', elem)}: bad {prop}={raw!r}: {exc}") from exc

    def _int_list(raw) -> List[int]:
        return [int(p) for p in str(raw).split(",") if str(p).strip()]

    for e in elements:
        get = getattr(e, "get_property", None)
        if get is None:
            continue
        if enabled is None and get("batching") is not None:
            enabled = parse_bool(get("batching"))
        if max_batch is None and get("max-batch") is not None:
            max_batch = _coerce(e, "max-batch", int, get("max-batch"))
        if timeout_ms is None and get("batch-timeout-ms") is not None:
            timeout_ms = _coerce(e, "batch-timeout-ms", float, get("batch-timeout-ms"))
        if buckets is None and get("batch-buckets") is not None:
            buckets = _coerce(e, "batch-buckets", _int_list, get("batch-buckets"))
    if enabled is None:
        enabled = defaults["batching"]
    if max_batch is None:
        max_batch = defaults["max-batch"]
    if timeout_ms is None:
        timeout_ms = defaults["batch-timeout-ms"]
    if buckets is None:
        buckets = defaults["batch-buckets"]
    max_batch = max(1, int(max_batch))
    return BatchConfig(
        enabled=bool(enabled),
        max_batch=max_batch,
        timeout_ms=max(0.0, float(timeout_ms)),
        buckets=_parse_buckets(buckets, max_batch),
    )


class BatchStats:
    """Single-writer (the node thread) batching counters; readers see a
    consistent-enough snapshot (GIL-atomic attribute reads)."""

    __slots__ = ("batches", "frames", "padded_rows", "bucket_rows", "wait_ns")

    def __init__(self) -> None:
        self.batches = 0
        self.frames = 0
        self.padded_rows = 0   # pad rows computed and thrown away
        self.bucket_rows = 0   # rows run, padding included
        self.wait_ns = 0       # the collector's straggler wait

    def record(self, n: int, bucket: int, wait_s: float) -> None:
        self.batches += 1
        self.frames += n
        self.bucket_rows += bucket
        self.padded_rows += bucket - n
        self.wait_ns += int(wait_s * 1e9)

    @property
    def avg_batch_size(self) -> float:
        return self.frames / self.batches if self.batches else 0.0

    @property
    def pad_waste_pct(self) -> float:
        """Percent of the rows run that were padding."""
        if not self.bucket_rows:
            return 0.0
        return 100.0 * self.padded_rows / self.bucket_rows

    @property
    def batch_wait_ms(self) -> float:
        """Average straggler wait a window, ms: the latency batching itself
        added (0 under load, where the collector takes what is queued)."""
        if not self.batches:
            return 0.0
        return self.wait_ns / self.batches / 1e6

    def snapshot(self) -> dict:
        return {
            "avg_batch_size": round(self.avg_batch_size, 3),
            "pad_waste_pct": round(self.pad_waste_pct, 2),
            "batch_wait_ms": round(self.batch_wait_ms, 4),
        }


class BatchCollector:
    """Drains up to ``max_batch`` frames a call from a node's inbox.

    :meth:`collect` returns ``(frames, eos, wait_s)``:

    - it blocks for the first frame (honouring the executor's stop event);
    - drains what else is queued, without blocking, up to the cap;
    - only when trickle-fed (one frame and an empty inbox) waits up to
      ``timeout_ms`` for stragglers, then goes with what arrived;
    - an EOS mid-drain ends collection: the partial window is returned
      first and ``eos=True`` on the next call, so in-flight frames leave
      before EOS does.

    ``drop`` is the upstream-QoS predicate: frames a downstream rate
    limiter will drop never take a window slot. ``cap`` is the OOM
    governor's live ceiling (pipeline/device_faults.py ``BucketGovernor.cap``):
    a window holds at most ``min(max_batch, cap())`` frames, re-read per
    window. After the stop event is set, ``collect`` returns
    ``([], True, 0.0)`` with :attr:`stopped` set. :attr:`held` is the
    frame a straggler wait holds (taken from the inbox, not yet in a
    window): the executor's drain counts it as in flight.
    """

    def __init__(
        self,
        inbox: "queue.Queue",
        stop_event: threading.Event,
        config: BatchConfig,
        drop: Optional[Callable[[Any], bool]] = None,
        cap: Optional[Callable[[], int]] = None,
    ) -> None:
        self.inbox = inbox
        self.stop_event = stop_event
        self.config = config
        self.drop = drop
        self.cap = cap
        self.held = 0
        self.stopped = False
        self._pending_eos = False

    def _get(self, deadline: Optional[float] = None):
        """The next item, or None at the deadline or on stop."""
        while not self.stop_event.is_set():
            wait = _POLL_S
            if deadline is not None:
                wait = min(wait, deadline - time.monotonic())
                if wait <= 0:
                    return None
            try:
                return self.inbox.get(timeout=wait)
            except queue.Empty:
                continue
        self.stopped = True
        return None

    def collect(self) -> Tuple[List[Any], bool, float]:
        if self._pending_eos:
            self._pending_eos = False
            return [], True, 0.0
        cfg = self.config
        limit = cfg.max_batch
        if self.cap is not None:
            limit = max(1, min(limit, self.cap()))
        batch: List[Any] = []
        while True:  # the first frame: a plain blocking pop
            item = self._get()
            if item is None or item is EOS_FRAME:
                return [], True, 0.0
            if self.drop is not None and self.drop(item):
                continue
            batch.append(item)
            break
        eos = self._drain_queued(batch, limit)
        wait_s = 0.0
        if not eos and len(batch) == 1 and cfg.timeout_ms > 0.0 and limit > 1:
            # trickle-fed: one bounded wait for stragglers (waiting again
            # after each arrival would make the bound a rolling window)
            t0 = time.perf_counter()
            self.held = 1
            try:
                item = self._get(time.monotonic() + cfg.timeout_ms / 1000.0)
            finally:
                self.held = 0
            if item is not None:
                if item is EOS_FRAME:
                    eos = True
                elif not (self.drop is not None and self.drop(item)):
                    batch.append(item)
                if not eos:
                    eos = self._drain_queued(batch, limit)
            wait_s = time.perf_counter() - t0
        if eos and batch:
            self._pending_eos = True
            return batch, False, wait_s
        return batch, eos, wait_s

    def _drain_queued(self, batch: List[Any], cap: int) -> bool:
        while len(batch) < cap:
            try:
                item = self.inbox.get_nowait()
            except queue.Empty:
                return False
            if item is EOS_FRAME:
                return True
            if self.drop is not None and self.drop(item):
                continue
            batch.append(item)
        return False
