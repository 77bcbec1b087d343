"""Metric primitives: Counter / Gauge / Histogram + the MetricsRegistry.

The counterpart of ``nnstreamer_tpu/obs/metrics.py`` in the port (jax-free there
too, so the port keeps its own copy).

Design constraints (why this is not a prometheus_client dependency):

- **Cheap under the executor's per-frame lock discipline.** The hot-path
  writers are the node service threads, one writer per metric instance
  (the BatchStats/FaultStats single-writer contract): ``observe()`` /
  ``inc()`` are a handful of GIL-atomic attribute ops, no lock taken.
  Readers (the exposition thread, ``Executor.stats()``) get a
  consistent-enough snapshot from GIL-atomic reads, exactly like the
  executor's existing counters.
- **Fixed log-scaled buckets.** A histogram is an integer array over a
  geometric ladder ``lo · growth^i``: ``observe()`` is one ``log`` and
  one list increment, quantiles interpolate log-linearly inside the
  landing bucket, and the worst-case quantile error is bounded by one
  bucket's width (``growth`` − 1, ~19% at the default quarter-octave
  ladder — tails, not means, so that is plenty for p50/p95/p99).
- **Mergeable across nodes/processes.** Two histograms over the same
  ladder merge by summing counts; ``to_dict``/``from_dict`` round-trip
  through JSON so per-process snapshots (the edge/query topology)
  aggregate into one fleet view.

The module-level :func:`enable` / :func:`get` mirror ``trace.py``: one
global registry, resolved by the executor at construction, opt-in via
``NNS_TPU_METRICS`` / ``NNS_TPU_METRICS_PORT`` / ``[executor] metrics``.
"""

from __future__ import annotations

import math
import os
import threading
from typing import Dict, List, Optional, Tuple

# Every metric the package emits, name → help text. The obs self-check
# (analysis/selfcheck.py obs_self_check, mirroring san_self_check) keeps
# this catalog, the emitting code, and docs/observability.md in sync —
# a metric emitted but not cataloged/documented fails the style gate.
METRIC_CATALOG: Dict[str, str] = {
    "nns_element_latency_us": (
        "per-element processing latency per invoke, microseconds "
        "(histogram; one observation per frame, or per batch on "
        "batched service loops)"
    ),
    "nns_element_frames_total": "frames processed per element (counter)",
    "nns_queue_wait_us": (
        "time a frame spent queued in an element's input channel before "
        "the service thread popped it, microseconds (histogram)"
    ),
    "nns_queue_depth": (
        "input-channel depth sampled every 16th frame, frames (histogram)"
    ),
    "nns_batch_size": (
        "frames per batched device invoke (histogram; micro-batching "
        "segments and batchable host filters only)"
    ),
    "nns_fault_events_total": (
        "fault-layer events by action label: retry / drop / route / "
        "route-unlinked (counter)"
    ),
    "nns_edge_requests_total": (
        "tensor_query_client round trips completed (counter)"
    ),
    "nns_edge_rtt_us": (
        "tensor_query_client request round-trip time, microseconds "
        "(histogram; includes serialization and the remote pipeline)"
    ),
    "nns_admission_rejects_total": (
        "query-server admission rejections by reason label: max-clients "
        "/ overload / client-backpressure / rate / malformed (counter)"
    ),
    "nns_deadline_shed_total": (
        "frames dropped at executor dequeue because their client SLO "
        "(deadline_ms meta) already expired, per node (counter)"
    ),
    "nns_client_queue_depth": (
        "admitted-but-unserved requests queued per client at a query "
        "server, by client label (gauge)"
    ),
    "nns_edge_nacks_total": (
        "structured NACKs a tensor_query_client received, by reason "
        "label (counter)"
    ),
    "nns_fleet_failovers_total": (
        "fleet-client requests re-sent to another endpoint after their "
        "first endpoint failed, NACKed draining, or rejected them "
        "(counter; docs/edge-serving.md)"
    ),
    "nns_fleet_hedges_total": (
        "hedged sends a fleet client fired at a second endpoint for "
        "straggling requests (hedge-after-ms; first reply wins, the "
        "loser is deduped by frame_id) (counter; docs/edge-serving.md)"
    ),
    "nns_endpoint_healthy": (
        "1 while a fleet endpoint is in the dispatch rotation, 0 while "
        "ejected (consecutive failures) or draining (rolling restart), "
        "by endpoint label (gauge; docs/edge-serving.md)"
    ),
    "nns_device_faults_total": (
        "device-plane faults classified per element, by kind label: "
        "oom / compile / device_lost / transient (counter; "
        "docs/resilience.md)"
    ),
    "nns_degraded_segments": (
        "1 while a segment serves degraded — device circuit open "
        "(host/eager path) or OOM batch ceiling below the full ladder — "
        "else 0, per element (gauge; docs/resilience.md)"
    ),
    "nns_plane_batch_occupancy": (
        "frames per cross-stream serving-plane dispatch, by plane "
        "label (histogram; occupancy vs plane-max-batch is the "
        "multiplexing win — docs/serving-plane.md)"
    ),
    "nns_plane_queue_depth": (
        "queued-but-undispatched requests across all client streams of "
        "a serving plane, sampled at each dispatch, by plane label "
        "(gauge; docs/serving-plane.md)"
    ),
    "nns_plane_stream_admitted_total": (
        "requests a client stream submitted into its serving plane, by "
        "plane and stream label (counter; docs/serving-plane.md)"
    ),
    "nns_plane_stream_served_total": (
        "requests a serving plane completed back to a client stream, "
        "by plane and stream label (counter; admitted minus served is "
        "the stream's in-flight/errored tail — docs/serving-plane.md)"
    ),
    "nns_plane_inflight_windows": (
        "windows submitted to a serving plane but not yet collected by "
        "their stream's async ticket wait, by plane label (gauge; ~0 "
        "under blocking submits, up to streams × ring-depth when the "
        "async in-flight rings are full — docs/serving-plane.md)"
    ),
    "nns_plane_submit_wait_ms": (
        "time a stream spent BLOCKED per plane window — the full round "
        "trip for blocking submits, the residual ticket wait for async "
        "ones (overlap eats the rest), milliseconds, by plane label "
        "(histogram; docs/serving-plane.md)"
    ),
    "nns_kv_blocks_in_use": (
        "KV-cache blocks currently referenced by live requests in a "
        "paged continuous batcher (gauge; capacity vs kv_blocks is the "
        "paging headroom — docs/llm-serving.md)"
    ),
    "nns_kv_prefix_hits_total": (
        "prompt blocks adopted from the paged KV prefix index instead "
        "of re-prefilled — shared system prompts count once, not per "
        "request (counter; docs/llm-serving.md)"
    ),
    "nns_kv_gather_dispatch_total": (
        "paged step/pump/spec launches that ran the gather→contiguous-"
        "view→scatter oracle (kv_attn=gather) instead of the "
        "block-native arena read — a nonzero rate means the decode "
        "plane is paying the materialized-view round trip (counter; "
        "docs/llm-serving.md)"
    ),
    "nns_kv_migrations_total": (
        "live request migrations through kv/migrate.py spans, by "
        "direction label: out (extracted and shipped to a peer) / in "
        "(adopted from a peer's span) (counter; docs/llm-serving.md "
        "Migration & recovery)"
    ),
    "nns_kv_span_bytes_total": (
        "encoded KV-span bytes, by direction label: out (spans "
        "encoded) / in (spans decoded) — warm migrations strip "
        "prefix-shared block payloads, so out bytes under-count the "
        "resident KV the receiver reconstructs (counter; "
        "docs/llm-serving.md)"
    ),
    "nns_disagg_handoffs_total": (
        "disaggregated prefill→decode request handoffs, by outcome "
        "label: handoff (span shipped to a decode peer) / local "
        "(every peer refused or was unreachable — decoded locally, "
        "tokens never lost) / relayed (finished tokens fetched back "
        "from the peer and delivered) / recovered (peer lost the "
        "handoff — prompt resubmitted locally) (counter; "
        "docs/llm-serving.md Disaggregated serving)"
    ),
    "nns_route_prefix_hits_total": (
        "fleet-client requests routed to the endpoint holding the "
        "longest matching prompt prefix (prefix-route=true) — the "
        "cache-affinity win over plain least-loaded rotation "
        "(counter; docs/edge-serving.md Prefix-aware routing)"
    ),
    "nns_request_resumes_total": (
        "in-flight requests resumed after a disruption, by kind "
        "label: reprefill (no peer accepted the span — deadline-aware "
        "re-prefill from the surviving prefix) / checkpoint (adopted "
        "from an on-disk span checkpoint after a restart) (counter; "
        "docs/llm-serving.md)"
    ),
    "nns_request_ttft_ms": (
        "per-request time to first token, submit → first token "
        "materialized, milliseconds (histogram; the admission SLO — "
        "docs/llm-serving.md)"
    ),
    "nns_request_tpot_ms": (
        "per-request mean time per output token after the first, "
        "milliseconds (histogram; the decode SLO — docs/llm-serving.md)"
    ),
    "nns_transfer_bytes_total": (
        "bytes crossing the host<->device boundary through the "
        "transfer engine, by direction label: h2d (staged uploads) / "
        "d2h (coalesced fetches) — zero d2h between adjacent fused "
        "segments is the resident-handoff invariant (counter; "
        "docs/streaming.md)"
    ),
    "nns_fused_postproc_total": (
        "frames whose pre/post-processing (decode, resize/crop, "
        "normalize) ran fused inside a device segment instead of as a "
        "host node, per element (counter; docs/on-device-ops.md)"
    ),
    "nns_chain_launches_total": (
        "window dispatches of a compiled whole-chain resident program "
        "— one per unrolled window, NOT one per node per frame, per "
        "chain element (counter; docs/chain-analysis.md)"
    ),
    "nns_chain_fallback_total": (
        "windows a compiled chain served through the per-node parity "
        "path after its fallback latched (device fault, unshrinkable "
        "OOM, or compile failure), per chain element (counter; "
        "docs/chain-analysis.md)"
    ),
}

# default ladder: quarter-octave buckets from 1 µs up past 100 s —
# one ladder for every time-valued histogram so they merge freely
DEFAULT_LO = 1.0
DEFAULT_GROWTH = 2.0 ** 0.25
DEFAULT_NBUCKETS = 112


class Counter:
    """Monotonic counter (single-writer increments, GIL-atomic reads)."""

    __slots__ = ("name", "labels", "value")

    kind = "counter"

    def __init__(self, name: str, labels: Dict[str, str]) -> None:
        self.name = name
        self.labels = labels
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def to_dict(self) -> dict:
        return {"type": "counter", "name": self.name,
                "labels": self.labels, "value": self.value}

    def merge(self, other: "Counter") -> None:
        self.value += other.value


class Gauge:
    """Point-in-time value (queue depth now, workers alive, ...)."""

    __slots__ = ("name", "labels", "value")

    kind = "gauge"

    def __init__(self, name: str, labels: Dict[str, str]) -> None:
        self.name = name
        self.labels = labels
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v

    def to_dict(self) -> dict:
        return {"type": "gauge", "name": self.name,
                "labels": self.labels, "value": self.value}

    def merge(self, other: "Gauge") -> None:
        # merging point-in-time gauges across processes: sum (the fleet
        # total is the only aggregate that needs no extra metadata)
        self.value += other.value


class Histogram:
    """Fixed log-scaled-bucket histogram with quantile estimates.

    Bucket ``i`` covers ``[lo·growth^i, lo·growth^(i+1))``; bucket 0
    additionally absorbs values below ``lo`` and the last bucket values
    past the top. ``observe()`` is one ``math.log`` + one list
    increment — single-writer cheap. Quantiles walk the cumulative
    counts and interpolate log-linearly inside the landing bucket,
    clamped to the observed min/max so a one-sample histogram reports
    the sample, not a bucket edge.
    """

    __slots__ = ("name", "labels", "lo", "growth", "counts", "count",
                 "sum", "min", "max", "_inv_log_growth")

    kind = "histogram"

    def __init__(
        self,
        name: str,
        labels: Dict[str, str],
        lo: float = DEFAULT_LO,
        growth: float = DEFAULT_GROWTH,
        nbuckets: int = DEFAULT_NBUCKETS,
    ) -> None:
        if lo <= 0 or growth <= 1.0 or nbuckets < 1:
            raise ValueError(
                f"bad histogram ladder lo={lo} growth={growth} n={nbuckets}"
            )
        self.name = name
        self.labels = labels
        self.lo = float(lo)
        self.growth = float(growth)
        self.counts: List[int] = [0] * int(nbuckets)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._inv_log_growth = 1.0 / math.log(self.growth)

    def _idx(self, v: float) -> int:
        if v < self.lo:
            return 0
        i = int(math.log(v / self.lo) * self._inv_log_growth)
        n = len(self.counts)
        return i if i < n else n - 1

    def observe(self, v: float) -> None:
        self.counts[self._idx(v)] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    # -- reading -----------------------------------------------------------
    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def edge(self, i: int) -> float:
        """Lower edge of bucket ``i`` (upper edge of ``i - 1``)."""
        return self.lo * (self.growth ** i)

    def quantile(self, q: float) -> float:
        """Estimate the ``q``-quantile (0..1) by cumulative walk +
        log-linear interpolation inside the landing bucket."""
        if not self.count:
            return 0.0
        target = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if not c:
                continue
            if cum + c >= target:
                frac = (target - cum) / c
                est = self.edge(i) * (self.growth ** frac)
                return min(max(est, self.min), self.max)
            cum += c
        return self.max

    def percentiles(self) -> Tuple[float, float, float]:
        """(p50, p95, p99) — the live-telemetry tail view."""
        return self.quantile(0.50), self.quantile(0.95), self.quantile(0.99)

    # -- merge / serialization ---------------------------------------------
    def merge(self, other: "Histogram") -> None:
        if (other.lo, other.growth, len(other.counts)) != (
            self.lo, self.growth, len(self.counts)
        ):
            raise ValueError(
                f"cannot merge histograms over different ladders: "
                f"{self.name} ({self.lo},{self.growth},{len(self.counts)}) "
                f"vs ({other.lo},{other.growth},{len(other.counts)})"
            )
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)

    def to_dict(self) -> dict:
        p50, p95, p99 = self.percentiles()
        return {
            "type": "histogram", "name": self.name, "labels": self.labels,
            "lo": self.lo, "growth": self.growth,
            "nbuckets": len(self.counts),
            # sparse: index → count (most of a 112-rung ladder is empty)
            "counts": {
                str(i): c for i, c in enumerate(self.counts) if c
            },
            "count": self.count, "sum": self.sum,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
            "p50": p50, "p95": p95, "p99": p99,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Histogram":
        h = cls(d["name"], dict(d.get("labels", {})), lo=d["lo"],
                growth=d["growth"], nbuckets=d["nbuckets"])
        for i, c in d.get("counts", {}).items():
            h.counts[int(i)] = int(c)
        h.count = int(d["count"])
        h.sum = float(d["sum"])
        h.min = math.inf if d.get("min") is None else float(d["min"])
        h.max = -math.inf if d.get("max") is None else float(d["max"])
        return h


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Name+labels → metric instance, with get-or-create semantics.

    Creation takes the registry lock; the steady-state lookup is one
    dict read (GIL-atomic), so per-frame emitters can re-resolve their
    metric without a lock — though hot paths cache the instance.
    Metric names must be cataloged in :data:`METRIC_CATALOG`: the obs
    self-check keeps code, catalog, and docs in sync.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple, object] = {}

    @staticmethod
    def _key(name: str, labels: Dict[str, str]) -> Tuple:
        return (name,) + tuple(sorted(labels.items()))

    def _get_or_create(self, cls, name: str, labels: Dict[str, str],
                       **kw):
        if name not in METRIC_CATALOG:
            raise KeyError(
                f"unknown metric {name!r}: add it to "
                "obs.metrics.METRIC_CATALOG (and docs/observability.md)"
            )
        key = self._key(name, labels)
        m = self._metrics.get(key)
        if m is None:
            with self._lock:
                m = self._metrics.get(key)
                if m is None:
                    m = cls(name, labels, **kw)
                    self._metrics[key] = m
        if not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {type(m).__name__}"
            )
        return m

    def counter(self, name: str, **labels: str) -> Counter:
        return self._get_or_create(Counter, name, labels)

    def gauge(self, name: str, **labels: str) -> Gauge:
        return self._get_or_create(Gauge, name, labels)

    def histogram(
        self, name: str, lo: float = DEFAULT_LO,
        growth: float = DEFAULT_GROWTH, nbuckets: int = DEFAULT_NBUCKETS,
        **labels: str,
    ) -> Histogram:
        return self._get_or_create(
            Histogram, name, labels, lo=lo, growth=growth, nbuckets=nbuckets
        )

    # -- reading -----------------------------------------------------------
    def metrics(self) -> List[object]:
        with self._lock:
            return list(self._metrics.values())

    def find(self, name: str, **labels: str):
        """The metric registered under (name, labels), or None."""
        return self._metrics.get(self._key(name, labels))

    def to_dict(self) -> dict:
        return {"metrics": [m.to_dict() for m in self.metrics()]}

    def merge_dict(self, snap: dict) -> None:
        """Fold another process's :meth:`to_dict` snapshot into this
        registry (cross-node aggregation for the edge/query topology)."""
        for d in snap.get("metrics", []):
            cls = _KINDS[d["type"]]
            labels = dict(d.get("labels", {}))
            if cls is Histogram:
                mine = self._get_or_create(
                    cls, d["name"], labels, lo=d["lo"], growth=d["growth"],
                    nbuckets=d["nbuckets"],
                )
                mine.merge(Histogram.from_dict(d))
            else:
                mine = self._get_or_create(cls, d["name"], labels)
                mine.value += d["value"]


# -- global opt-in (the trace.py enable/disable/get pattern) ----------------

_lock = threading.Lock()
_registry: Optional[MetricsRegistry] = None


def enable() -> MetricsRegistry:
    """Install (or return) the global registry; executors built after
    this exists record per-element metrics."""
    global _registry
    with _lock:
        if _registry is None:
            _registry = MetricsRegistry()
        return _registry


def disable() -> None:
    global _registry
    with _lock:
        _registry = None


def _configured_on() -> bool:
    """Env/config opt-in: ``NNS_TPU_METRICS`` truthy, a metrics port set
    (either env spelling), or ``[executor] metrics`` in the ini."""
    if os.environ.get("NNS_TPU_METRICS", "").strip().lower() in (
        "1", "true", "yes", "on"
    ):
        return True
    if resolve_port() is not None:
        return True
    from nnstreamer_tpu_torch.config import conf

    return conf().get_bool("executor", "metrics", False)


def resolve_port() -> Optional[int]:
    """Exposition port, or None when off: ``NNS_TPU_METRICS_PORT``
    (the documented direct env knob) outranks the layered
    ``[executor] metrics_port`` (itself env-overridable as
    ``NNS_TPU_EXECUTOR_METRICS_PORT``); 0/unset = off. Malformed values
    read as off with a warning — a typo'd env var must not keep a
    pipeline from starting (the [executor]-defaults discipline)."""
    raw = os.environ.get("NNS_TPU_METRICS_PORT")
    if raw is not None and raw.strip():
        try:
            port = int(raw)
        except ValueError:
            from nnstreamer_tpu_torch.log import get_logger

            get_logger("obs").warning(
                "NNS_TPU_METRICS_PORT=%r is not an int; metrics "
                "endpoint stays off", raw,
            )
            return None
        return port if port > 0 else None
    from nnstreamer_tpu_torch.config import conf

    port = conf().get_int("executor", "metrics_port", 0)
    return port if port > 0 else None


def get() -> Optional[MetricsRegistry]:
    """Active registry or None. Mirrors ``trace.get()``: resolved by the
    executor ONCE at construction (not per frame), so the env/config
    probe on the None path stays off the hot path."""
    r = _registry
    if r is None and _configured_on():
        r = enable()
    return r
