"""Admission control for the multi-tenant query serving plane.

ROADMAP item 5: one ``tensor_query_client`` reconnecting politely is not
a fleet. Before this module the server side accepted unbounded clients
and queued every request forever, so overload manifested as silent
latency collapse. The :class:`AdmissionController` makes the serving
plane say *no* early, fairly, and observably (docs/edge-serving.md):

- **bounded budgets** — a global in-flight cap (queued + executing
  requests), a per-client in-flight cap (per-client backpressure: one
  pipelining client cannot monopolize the server), and a client-count
  cap (``max-clients``).
- **token-bucket rate limiting** — a global requests/second bound with a
  configurable burst; rejects carry a ``retry-after`` hint computed from
  the bucket's actual refill deficit, so well-behaved clients back off
  by exactly as much as needed instead of guessing.
- **priority classes + weighted-fair dequeue** — each request carries an
  integer priority class (lower = more urgent, stamped by the client's
  ``priority`` property); the scheduler drains strictly by class and
  round-robins *clients* inside a class, so one hot client saturating
  its queue cannot starve the others (fair share at equal weights).
- **explicit structured NACKs** — every rejection is a typed wire
  message (edge/serialize.py ``KIND_NACK``) carrying the reason and the
  retry-after hint, never a hang.

Deadline shedding is the executor's half (pipeline/executor.py
``Node.shed_if_expired`` / pipeline/faults.py helpers): requests carry a
client SLO (``deadline_ms`` meta) and an admission timestamp
(``admit_t``, local-only), and nodes drop frames that can no longer meet
the SLO *before* they consume device time, NACKing the client so the
request still reaches a terminal outcome.

Single-writer-ish discipline: ``offer``/``next_ready`` run on the
serversrc's source thread, ``release`` on the serversink's sink thread —
the shared counters and queues are guarded by one short-hold lock (no
blocking calls under it, per the nns-san race rules).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional

from nnstreamer_tpu_torch.obs import metrics as obs_metrics

#: NACK reasons the controller (and the serving layer) can emit; the
#: wire carries the string, clients and dashboards match on it.
REASON_MAX_CLIENTS = "max-clients"
REASON_OVERLOAD = "overload"            # global in-flight budget exhausted
REASON_CLIENT_BACKPRESSURE = "client-backpressure"  # per-client budget
REASON_RATE = "rate"                    # token bucket empty
REASON_MALFORMED = "malformed"          # undecodable request
REASON_DEADLINE = "deadline"            # shed: SLO already missed
REASON_FAILED = "failed"                # admitted, then dropped by a fault policy
REASON_DRAINING = "draining"            # graceful drain: retry ANOTHER endpoint


class Decision(NamedTuple):
    """Outcome of one admission check; ``retry_after_ms`` is the hint a
    NACK carries back to the client (0 = retry immediately/never)."""

    ok: bool
    reason: str = ""
    retry_after_ms: float = 0.0


ACCEPT = Decision(True)


@dataclass(frozen=True)
class AdmissionConfig:
    """Resolved admission knobs for one query server (0 = unbounded)."""

    max_clients: int = 0
    max_inflight: int = 0
    per_client_inflight: int = 0
    rate: float = 0.0          # requests/second, global token bucket
    burst: int = 0             # bucket depth (0 → max(1, ceil(rate)))
    retry_after_ms: float = 50.0  # base hint for budget NACKs
    # idle-slot reclamation for transports without disconnect events
    # (MQTT, SHM): a fully-idle client silent this long may be evicted
    # when the max-clients cap is hit
    idle_evict_s: float = 60.0

    @property
    def active(self) -> bool:
        return bool(
            self.max_clients or self.max_inflight
            or self.per_client_inflight or self.rate
        )

    @classmethod
    def from_element(cls, elem) -> "AdmissionConfig":
        def _num(key: str, cast, fallback):
            raw = elem.get_property(key)
            if raw is None:
                return fallback
            try:
                return cast(raw)
            except (TypeError, ValueError) as exc:
                raise ValueError(
                    f"{elem.name}: bad {key}={raw!r}: {exc}"
                ) from exc

        return cls(
            max_clients=max(0, _num("max-clients", int, 0)),
            max_inflight=max(0, _num("max-inflight", int, 0)),
            per_client_inflight=max(0, _num("per-client-inflight", int, 0)),
            rate=max(0.0, _num("rate", float, 0.0)),
            burst=max(0, _num("rate-burst", int, 0)),
            retry_after_ms=max(0.0, _num("retry-after-ms", float, 50.0)),
        )


class _Client:
    """Per-client admission state (guarded by the controller lock; the
    counter fields are read lock-free by snapshots — GIL-atomic)."""

    __slots__ = ("cid", "queues", "inflight", "admitted", "rejected",
                 "depth_gauge", "last_seen")

    def __init__(self, cid, now: float = 0.0) -> None:
        self.cid = cid
        # priority class -> FIFO of admitted-but-not-yet-served frames
        self.queues: Dict[int, deque] = {}
        self.inflight = 0    # admitted (queued + executing) until release
        self.admitted = 0
        self.rejected = 0
        self.depth_gauge = None  # nns_client_queue_depth handle (lazy)
        self.last_seen = now     # idle-eviction clock (offer/release)

    def queued(self) -> int:
        return sum(len(q) for q in self.queues.values())


class AdmissionController:
    """Server-side admission + weighted-fair request scheduling.

    ``offer(cid, frame)`` admits or rejects one decoded request at
    arrival; admitted frames are queued per (client, priority class).
    ``next_ready()`` is the weighted-fair dequeue the serversrc drives:
    strict priority across classes, round-robin across clients within a
    class. ``release(cid)`` returns one unit of in-flight budget (reply
    sent, or the frame was shed/dead-lettered)."""

    def __init__(self, cfg: AdmissionConfig, name: str = "admission") -> None:
        self.cfg = cfg
        self.name = name
        self._mu = threading.Lock()
        self._clients: Dict[Any, _Client] = {}
        self._inflight_total = 0
        self._ready = 0          # queued frames across all clients
        # round-robin cursor per priority class: the cid served last
        self._rr_last: Dict[int, Any] = {}
        # token bucket (rate > 0): starts full; the clock anchors on the
        # first offer's `now` so tests can inject a deterministic clock
        self._tokens = float(self.cfg.burst or max(1, int(cfg.rate) or 1))
        self._bucket_cap = self._tokens
        self._bucket_t: Optional[float] = None
        # totals (single-writer under _mu; GIL-atomic reads)
        self.admitted_total = 0
        self.rejected_total = 0
        self.released_total = 0
        self.rejected_by_reason: Dict[str, int] = {}
        # registry resolved ONCE at construction (the executor
        # discipline: obs_metrics.get() probes env+config on the None
        # path and must stay off the per-request path)
        self._reg = obs_metrics.get()
        self._reject_ctrs: Dict[str, Any] = {}

    # -- admission ---------------------------------------------------------
    def _refill(self, now: float) -> None:
        """Token-bucket refill (call with ``_mu`` held, rate > 0)."""
        if self._bucket_t is None:
            self._bucket_t = now
            return
        dt = now - self._bucket_t
        if dt > 0:
            self._tokens = min(
                self._bucket_cap, self._tokens + dt * self.cfg.rate
            )
            self._bucket_t = now

    def offer(self, cid, frame, now: Optional[float] = None) -> Decision:
        """Admit (and queue) or reject one request from client ``cid``."""
        cfg = self.cfg
        if now is None:
            now = time.monotonic()
        with self._mu:
            c = self._clients.get(cid)
            if c is None:
                if cfg.max_clients and len(self._clients) >= cfg.max_clients:
                    # transports without disconnect events (MQTT, SHM)
                    # never call client_gone: reclaim the stalest
                    # fully-idle slot before rejecting
                    self._evict_idle(now)
                if cfg.max_clients and len(self._clients) >= cfg.max_clients:
                    return self._reject(None, REASON_MAX_CLIENTS,
                                        cfg.retry_after_ms)
                c = self._clients[cid] = _Client(cid, now)
            c.last_seen = now
            if cfg.max_inflight and self._inflight_total >= cfg.max_inflight:
                return self._reject(c, REASON_OVERLOAD, cfg.retry_after_ms)
            if cfg.per_client_inflight \
                    and c.inflight >= cfg.per_client_inflight:
                return self._reject(c, REASON_CLIENT_BACKPRESSURE,
                                    cfg.retry_after_ms)
            if cfg.rate:
                self._refill(now)
                if self._tokens < 1.0:
                    hint = (1.0 - self._tokens) / cfg.rate * 1000.0
                    return self._reject(c, REASON_RATE,
                                        max(hint, cfg.retry_after_ms))
                self._tokens -= 1.0
            tier = self._tier(frame)
            c.queues.setdefault(tier, deque()).append(frame)
            c.inflight += 1
            c.admitted += 1
            self._inflight_total += 1
            self._ready += 1
            self.admitted_total += 1
            depth = c.queued()
        self._gauge_depth(c, depth)
        return ACCEPT

    @staticmethod
    def _tier(frame) -> int:
        meta = getattr(frame, "meta", None) or {}
        try:
            return int(meta.get("priority", 1))
        except (TypeError, ValueError):
            return 1

    def _reject(self, c: Optional[_Client], reason: str,
                retry_after_ms: float) -> Decision:
        """Record one rejection (call with ``_mu`` held)."""
        self.rejected_total += 1
        self.rejected_by_reason[reason] = (
            self.rejected_by_reason.get(reason, 0) + 1
        )
        if c is not None:
            c.rejected += 1
        ctr = self._reject_ctrs.get(reason)
        if ctr is None and self._reg is not None:
            ctr = self._reject_ctrs[reason] = self._reg.counter(
                "nns_admission_rejects_total",
                element=self.name, reason=reason,
            )
        if ctr is not None:
            ctr.inc()
        return Decision(False, reason, retry_after_ms)

    def count_reject(self, reason: str) -> None:
        """Record a rejection decided OUTSIDE the controller (transport
        connection caps, malformed payloads) so the per-reason totals
        and metrics stay one ledger."""
        with self._mu:
            self._reject(None, reason, 0.0)

    # -- scheduling --------------------------------------------------------
    def has_ready(self) -> bool:
        return self._ready > 0

    def next_ready(self):
        """Weighted-fair pick: strict priority across classes, round-
        robin across clients within a class. Returns a frame (still
        counted in-flight until ``release``) or None."""
        with self._mu:
            if not self._ready:
                return None
            tiers = sorted({
                t for c in self._clients.values()
                for t, q in c.queues.items() if q
            })
            for tier in tiers:
                cids = [
                    cid for cid, c in self._clients.items()
                    if c.queues.get(tier)
                ]
                if not cids:
                    continue
                last = self._rr_last.get(tier)
                if last in cids:
                    i = (cids.index(last) + 1) % len(cids)
                    cids = cids[i:] + cids[:i]
                cid = cids[0]
                c = self._clients[cid]
                frame = c.queues[tier].popleft()
                self._rr_last[tier] = cid
                self._ready -= 1
                depth = c.queued()
                break
            else:  # pragma: no cover - _ready tracked with the queues
                return None
        self._gauge_depth(c, depth)
        return frame

    def flush_ready(self):
        """Graceful-drain flush (docs/edge-serving.md "Running a
        fleet"): pop every queued-but-unserved admitted frame so the
        caller can NACK it ``draining`` — queued requests re-route to
        another endpoint instead of waiting out a dying server. The
        frames stay counted in-flight until the caller's
        ``release(cid)`` (the budget-release path), so the
        accounting ledger never skips a state."""
        with self._mu:
            out = []
            for c in self._clients.values():
                for q in c.queues.values():
                    while q:
                        out.append(q.popleft())
            self._ready = 0
        for frame in out:
            cid = getattr(frame, "meta", {}).get("client_id")
            c = self._clients.get(cid)
            if c is not None:
                self._gauge_depth(c, 0)
        return out

    def _evict_idle(self, now: float) -> None:
        """Reclaim clients with nothing queued or in flight that have
        been silent for ``idle_evict_s`` (call with ``_mu`` held)."""
        horizon = now - self.cfg.idle_evict_s
        for cid in [
            cid for cid, c in self._clients.items()
            if not c.inflight and not c.queued() and c.last_seen <= horizon
        ]:
            del self._clients[cid]

    # -- completion --------------------------------------------------------
    def release(self, cid) -> None:
        """One admitted request reached a terminal outcome (reply sent,
        NACKed after shedding, or dead-lettered): return its budget."""
        with self._mu:
            c = self._clients.get(cid)
            if c is None or c.inflight <= 0:
                return  # duplicate release (shed + late reply): idempotent
            c.inflight -= 1
            self._inflight_total -= 1
            self.released_total += 1

    def client_gone(self, cid) -> None:
        """Connection closed: flush the client's queued requests (their
        replies have nowhere to go) and free its budget and slot."""
        with self._mu:
            c = self._clients.pop(cid, None)
            if c is None:
                return
            queued = c.queued()
            self._ready -= queued
            self._inflight_total -= c.inflight
        self._gauge_depth(c, 0)

    # -- observability -----------------------------------------------------
    def _gauge_depth(self, c: _Client, depth: int) -> None:
        reg = self._reg
        if reg is None:
            return
        if c.depth_gauge is None:
            c.depth_gauge = reg.gauge(
                "nns_client_queue_depth",
                element=self.name, client=str(c.cid),
            )
        c.depth_gauge.set(depth)

    def snapshot(self) -> Dict[str, Any]:
        """Stats for Executor.stats() / nns-top (--clients view)."""
        with self._mu:
            clients = {
                str(cid): {
                    "queued": c.queued(),
                    "inflight": c.inflight,
                    "admitted": c.admitted,
                    "rejected": c.rejected,
                }
                for cid, c in self._clients.items()
            }
            return {
                "admitted": self.admitted_total,
                "rejected": self.rejected_total,
                "released": self.released_total,
                "inflight": self._inflight_total,
                "queued": self._ready,
                "rejected_by_reason": dict(self.rejected_by_reason),
                "clients": clients,
            }
