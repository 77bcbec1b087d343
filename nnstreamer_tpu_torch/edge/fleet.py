"""Fleet endpoint selection for the edge query layer (docs/edge-serving.md).

The counterpart of ``nnstreamer_tpu/edge/fleet.py``. One
``tensor_query_client`` reconnecting politely is not a fleet. Admission
control teaches a *single* server to say no early
(admission NACKs, deadlines); this module teaches the *client* that
servers are interchangeable — ``tensor_query_client hosts=h1:p1,h2:p2``
binds a :class:`FleetEndpoints` selector instead of one socket:

- **health scoring** — per-endpoint consecutive-failure ejection with
  jittered, doubling backoff before a re-probe (the ReplicaSet
  circuit/probe idiom, time-based because endpoint death is observed on
  the wall clock, not a dispatch counter). A ``draining`` NACK from a
  server doing a rolling restart benches the endpoint for exactly its
  ``retry-after`` hint.
- **failover plans** — :meth:`FleetEndpoints.plan` returns the ordered
  endpoints to try for ONE request: a due re-probe first (its request
  falls through to the healthy rotation if the probe fails), then the
  healthy round-robin.
- **reply dedup** — failover re-sends a request that may already be in
  flight on the first server, so delivery stays at-most-once only
  because every reply carries its request's ``frame_id``:
  :class:`ReplyDeduper` remembers delivered ids and drops the late
  duplicate from the loser.
- **hedging** — :class:`HedgeTimer` decides when a straggling request
  earns a second send (``hedge-after-ms``; negative = adaptive, from
  :class:`RttWindow`'s observed p99). Deterministic under an injected
  clock so the tests pin the schedule exactly.
- **prefix-aware routing** — :class:`PrefixRouter` remembers which
  endpoint last served each rolling-CRC prompt-prefix key
  (:func:`prefix_route_keys`, the kv/blocks.py chain at routing
  granularity) so a repeat-prefix LLM request lands on the server whose
  pool already holds its longest cached prefix — cluster-wide prefix
  sharing, not just per-process (docs/llm-serving.md "Disaggregated
  serving").

Everything here is pure selection/accounting logic — no sockets — so the
tier-1 units run with fake clocks; the client element (edge/query.py)
owns the transports.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from nnstreamer_tpu_torch.kv.blocks import roll_hash
from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.obs import metrics as obs_metrics

_log = get_logger("edge.fleet")

#: endpoint states surfaced by snapshots / nns-top --fleet
STATE_HEALTHY = "healthy"
STATE_EJECTED = "ejected"
STATE_DRAINING = "draining"


def parse_hosts(spec: str) -> List[Tuple[str, int]]:
    """``"h1:p1,h2:p2"`` → ``[(h1, p1), ...]`` (the client's ``hosts``
    property). Raises ValueError on malformed entries or duplicates so
    nns-lint (NNS-E005 via PropSpec coercion happens upstream; this is
    the semantic check) and the element constructor fail loudly."""
    out: List[Tuple[str, int]] = []
    seen = set()
    for raw in str(spec).split(","):
        raw = raw.strip()
        if not raw:
            continue
        host, _, port_s = raw.rpartition(":")
        if not host or not port_s.isdigit():
            raise ValueError(
                f"hosts entry {raw!r} is not host:port"
            )
        port = int(port_s)
        if port <= 0:
            raise ValueError(f"hosts entry {raw!r} has a bad port")
        key = (host, port)
        if key in seen:
            raise ValueError(f"hosts entry {raw!r} is listed twice")
        seen.add(key)
        out.append(key)
    if not out:
        raise ValueError(f"hosts={spec!r} names no endpoints")
    return out


class Endpoint:
    """One ``host:port`` dispatch target plus its health bookkeeping.
    All mutation happens through the owning :class:`FleetEndpoints`
    (single client thread by the element contract; snapshots read the
    GIL-atomic counters)."""

    __slots__ = (
        "idx", "host", "port", "healthy", "draining", "consec_fails",
        "fails", "served", "failovers", "inflight", "retry_at", "score",
        "unresolvable", "fail_streak",
    )

    def __init__(self, idx: int, host: str, port: int) -> None:
        self.idx = idx
        self.host = host
        self.port = port
        self.healthy = True
        self.draining = False
        self.consec_fails = 0   # toward ejection (eject_after)
        self.fail_streak = 0    # toward backoff doubling while benched
        self.fails = 0
        self.served = 0
        self.failovers = 0      # requests that failed over AWAY from here
        self.inflight = 0       # sends not yet replied/failed
        self.retry_at = 0.0     # benched until (monotonic); 0 = in rotation
        self.score = 1.0        # EWMA success rate (nns-top --fleet)
        self.unresolvable = False

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.port}"

    def state(self) -> str:
        if self.draining:
            return STATE_DRAINING
        return STATE_HEALTHY if self.healthy else STATE_EJECTED


class FleetEndpoints:
    """Health-scored endpoint selection for one fleet client.

    ``plan()`` yields the ordered endpoints to try for one request,
    ``record_ok`` / ``record_fail`` / ``mark_draining`` feed the scorer.
    ``clock`` and ``rng`` are injectable so the tier-1 units are
    deterministic (fake clock, seeded jitter)."""

    def __init__(
        self,
        targets: Sequence[Tuple[str, int]],
        eject_after: int = 3,
        probe_backoff_ms: float = 100.0,
        backoff_cap_ms: float = 3000.0,
        clock: Callable[[], float] = time.monotonic,
        rng: Optional[random.Random] = None,
        name: str = "fleet",
    ) -> None:
        if not targets:
            raise ValueError("FleetEndpoints needs at least one endpoint")
        self.endpoints = [
            Endpoint(i, h, p) for i, (h, p) in enumerate(targets)
        ]
        self.eject_after = max(1, int(eject_after))
        self.probe_backoff_ms = max(1.0, float(probe_backoff_ms))
        self.backoff_cap_ms = max(
            self.probe_backoff_ms, float(backoff_cap_ms)
        )
        self.clock = clock
        self.name = name
        self._rng = rng if rng is not None else random.Random(0xF1EE7)
        self._rr = 0
        # registry resolved ONCE at construction (the executor
        # discipline): obs_metrics.get() probes env+config on the None
        # path and must stay off the per-request path
        self._reg = obs_metrics.get()
        self._health_gauges: Dict[str, object] = {}

    # -- selection ---------------------------------------------------------
    def plan(self) -> List[Endpoint]:
        """Ordered dispatch plan for ONE request: a due benched endpoint
        is prepended as a re-probe (its request falls through to the
        healthy rotation when the probe fails — the ReplicaSet idiom),
        then the healthy round-robin, least-loaded first: the rotation
        is stably re-ordered by live ``inflight`` so an endpoint
        sitting on slow requests stops collecting new ones while its
        idle peers exist (ties keep the round-robin order, so an idle
        fleet still spreads). Draining endpoints rejoin only when their
        retry-after elapsed and nothing healthier exists."""
        now = self.clock()
        healthy = [
            e for e in self.endpoints if e.healthy and not e.draining
        ]
        benched = [
            e for e in self.endpoints if not (e.healthy and not e.draining)
        ]
        due = [e for e in benched if now >= e.retry_at]
        plan: List[Endpoint] = []
        if due and healthy:
            # probe the longest-benched due endpoint first; a recovered
            # server rejoins within one request of its backoff expiring
            plan.append(min(due, key=lambda e: e.retry_at))
        if healthy:
            start = self._rr % len(healthy)
            self._rr += 1
            rotation = healthy[start:] + healthy[:start]
            # stable: equal-inflight endpoints keep the rotation order
            plan.extend(sorted(rotation, key=lambda e: e.inflight))
        elif due:
            # nothing healthy: give every due endpoint a shot rather
            # than exhausting behind one dead probe target
            plan.extend(sorted(due, key=lambda e: e.retry_at))
        return plan

    def next_retry_in(self) -> float:
        """Seconds until the soonest benched endpoint is probe-eligible
        (0 when something is dispatchable right now) — the caller's
        sleep hint when a whole fleet is benched."""
        now = self.clock()
        if any(e.healthy and not e.draining for e in self.endpoints):
            return 0.0
        waits = [max(0.0, e.retry_at - now) for e in self.endpoints]
        return min(waits) if waits else 0.0

    # -- scoring -----------------------------------------------------------
    def record_ok(self, ep: Endpoint) -> None:
        was_ejected = not ep.healthy
        was_draining = ep.draining
        ep.served += 1
        ep.consec_fails = 0
        ep.fail_streak = 0
        ep.retry_at = 0.0
        ep.draining = False
        ep.unresolvable = False
        ep.score = min(1.0, 0.8 * ep.score + 0.2)
        ep.healthy = True
        if was_ejected:
            _log.warning("%s: endpoint %s recovered; back in rotation",
                         self.name, ep.addr)
        if was_ejected or was_draining:
            # a draining endpoint that recovered must flip the health
            # gauge back to 1 too, not only an ejected one
            self._gauge_health(ep)

    def record_fail(self, ep: Endpoint, unresolvable: bool = False) -> None:
        """One failed send/connect/reply on ``ep``: bench it after
        ``eject_after`` consecutive failures (immediately when the host
        no longer resolves — burning the retry budget on a gone name
        helps nobody) with jittered doubling backoff before a re-probe."""
        ep.fails += 1
        ep.consec_fails += 1
        ep.score = 0.8 * ep.score
        if unresolvable:
            ep.unresolvable = True
        was_healthy = ep.healthy
        if ep.consec_fails >= self.eject_after or unresolvable:
            ep.healthy = False
        if not ep.healthy:
            full_ms = min(
                self.probe_backoff_ms * (2.0 ** min(ep.fail_streak, 16)),
                self.backoff_cap_ms,
            )
            ep.fail_streak += 1
            jitter = 0.5 + 0.5 * self._rng.random()
            ep.retry_at = self.clock() + jitter * full_ms / 1000.0
            if was_healthy:
                _log.warning(
                    "%s: endpoint %s EJECTED after %d consecutive "
                    "failure(s)%s; re-probe in ~%.0f ms",
                    self.name, ep.addr, ep.consec_fails,
                    " (unresolvable)" if unresolvable else "", full_ms,
                )
                self._gauge_health(ep)

    def mark_draining(self, ep: Endpoint, retry_after_ms: float) -> None:
        """The endpoint NACKed ``draining`` (rolling restart): bench it
        for exactly the server's hint — it is not *failing*, it asked
        politely, so no consecutive-failure penalty accrues."""
        was = ep.draining
        ep.draining = True
        ep.retry_at = self.clock() + max(0.0, retry_after_ms) / 1000.0
        if not was:
            _log.info("%s: endpoint %s draining; retry in %.0f ms",
                      self.name, ep.addr, retry_after_ms)
            self._gauge_health(ep)

    # -- observability -----------------------------------------------------
    def _gauge_health(self, ep: Endpoint) -> None:
        reg = self._reg
        if reg is None:
            return
        g = self._health_gauges.get(ep.addr)
        if g is None:
            g = self._health_gauges[ep.addr] = reg.gauge(
                "nns_endpoint_healthy",
                element=self.name, endpoint=ep.addr,
            )
        g.set(1.0 if ep.healthy and not ep.draining else 0.0)

    def healthy_count(self) -> int:
        return sum(
            1 for e in self.endpoints if e.healthy and not e.draining
        )

    def snapshot(self) -> Dict[str, dict]:
        """Per-endpoint rows for ``fleet_stats()`` / nns-top --fleet."""
        return {
            e.addr: {
                "state": e.state(),
                "score": round(e.score, 3),
                "inflight": e.inflight,
                "served": e.served,
                "fails": e.fails,
                "failovers": e.failovers,
                "unresolvable": e.unresolvable,
            }
            for e in self.endpoints
        }


class ReplyDeduper:
    """frame_id-keyed at-most-once delivery across failover/hedging.

    A request re-sent to a second endpoint can be answered twice; only
    the FIRST reply for a frame_id is delivered (``claim`` returns True
    exactly once per id), and late duplicates — which may arrive many
    requests later on a connection the client kept open — are counted
    and dropped. Bounded FIFO memory so an unbounded stream of ids
    cannot grow the set forever."""

    __slots__ = ("capacity", "_seen", "_order", "duplicates")

    def __init__(self, capacity: int = 4096) -> None:
        self.capacity = max(16, int(capacity))
        self._seen: set = set()
        self._order: List[object] = []
        self.duplicates = 0

    def claim(self, frame_id) -> bool:
        """True when ``frame_id`` has not been delivered yet (caller
        delivers it); False for a duplicate (caller drops it)."""
        if frame_id in self._seen:
            self.duplicates += 1
            return False
        self._seen.add(frame_id)
        self._order.append(frame_id)
        if len(self._order) > self.capacity:
            evicted = self._order[: len(self._order) - self.capacity]
            del self._order[: len(self._order) - self.capacity]
            self._seen.difference_update(evicted)
        return True

    def seen(self, frame_id) -> bool:
        return frame_id in self._seen


#: routing granularity for prompt-prefix keys (tokens per key). Coarser
#: than many servers' kv block-size would miss shareable prefixes; finer
#: costs meta bytes for depth no pool can hold. 16 matches the default
#: ``block-size`` of tensor_llm_serversink.
ROUTE_BLOCK = 16


def prefix_route_keys(tokens, block: int = ROUTE_BLOCK,
                      max_blocks: int = 32) -> List[str]:
    """Rolling-CRC keys of a prompt's block-aligned prefixes — the
    kv/blocks.py :func:`~nnstreamer_tpu_torch.kv.blocks.roll_hash` chain at
    routing granularity, one 8-hex-digit key per ``block`` tokens
    (``keys[i]`` covers ``tokens[:(i+1)*block]``). Capped at
    ``max_blocks`` keys: past 512 tokens the routing signal is already
    decisive and meta bytes stop paying for themselves."""
    toks = np.ascontiguousarray(
        list(tokens)[: int(block) * int(max_blocks)], np.int32
    )
    h = 0
    keys: List[str] = []
    for i in range(len(toks) // int(block)):
        h = roll_hash(h, toks[i * block:(i + 1) * block])
        keys.append(f"{h:08x}")
    return keys


class PrefixRouter:
    """Client-side cluster prefix index: which endpoint last served
    each prompt-prefix key.

    ``note(keys, addr)`` records a delivered reply's keys against the
    endpoint that answered; ``best(keys)`` returns the
    ``(addr, depth)`` of the longest recorded prefix of a new request
    (deepest key first), or ``None`` when no endpoint is known to hold
    any of it. The index is advisory — the caller still routes through
    health/draining state and falls back to the least-loaded rotation —
    so a stale entry costs one cold prefill, never correctness. Bounded
    FIFO like :class:`ReplyDeduper`: an unbounded stream of novel
    prompts cannot grow it forever."""

    __slots__ = ("capacity", "_owner", "_order", "prefix_hits")

    def __init__(self, capacity: int = 4096) -> None:
        self.capacity = max(16, int(capacity))
        self._owner: Dict[str, str] = {}
        self._order: List[str] = []
        self.prefix_hits = 0

    def note(self, keys: Sequence[str], addr: str) -> None:
        for k in keys:
            if k not in self._owner:
                self._order.append(k)
            self._owner[k] = addr  # latest server to hold it wins
        if len(self._order) > self.capacity:
            evicted = self._order[: len(self._order) - self.capacity]
            del self._order[: len(self._order) - self.capacity]
            for k in evicted:
                self._owner.pop(k, None)

    def best(self, keys: Sequence[str]) -> Optional[Tuple[str, int]]:
        for depth in range(len(keys), 0, -1):
            addr = self._owner.get(keys[depth - 1])
            if addr is not None:
                return addr, depth
        return None

    def __len__(self) -> int:
        return len(self._owner)


class RttWindow:
    """Rolling window of recent reply RTTs; feeds the adaptive hedge
    threshold (``hedge-after-ms`` < 0 = hedge past the observed p99)."""

    __slots__ = ("_vals", "capacity")

    def __init__(self, capacity: int = 256) -> None:
        self.capacity = max(8, int(capacity))
        self._vals: List[float] = []

    def record(self, rtt_s: float) -> None:
        self._vals.append(float(rtt_s))
        if len(self._vals) > self.capacity:
            del self._vals[: len(self._vals) - self.capacity]

    def __len__(self) -> int:
        return len(self._vals)

    def quantile(self, q: float) -> Optional[float]:
        if len(self._vals) < 8:
            return None  # too few samples to call anything a straggler
        xs = sorted(self._vals)
        i = min(len(xs) - 1, max(0, int(q * len(xs))))
        return xs[i]


class HedgeTimer:
    """When does ONE request earn its hedge? Fixed threshold
    (``after_ms`` > 0), adaptive (``after_ms`` < 0: the RttWindow's p99,
    floored at ``adaptive_floor_ms`` until enough samples exist), or
    never (0, the default). Deterministic under an injected clock —
    the tier-1 hedging test pins the schedule exactly."""

    __slots__ = ("after_ms", "clock", "rtts", "adaptive_floor_ms",
                 "t0", "fired")

    def __init__(
        self,
        after_ms: float,
        clock: Callable[[], float] = time.monotonic,
        rtts: Optional[RttWindow] = None,
        adaptive_floor_ms: float = 50.0,
    ) -> None:
        self.after_ms = float(after_ms)
        self.clock = clock
        self.rtts = rtts
        self.adaptive_floor_ms = float(adaptive_floor_ms)
        self.t0: Optional[float] = None
        self.fired = False

    def arm(self) -> None:
        self.t0 = self.clock()
        self.fired = False

    def threshold_s(self) -> Optional[float]:
        """Current hedge delay in seconds; None = hedging off."""
        if self.after_ms > 0:
            return self.after_ms / 1000.0
        if self.after_ms < 0:
            p99 = self.rtts.quantile(0.99) if self.rtts is not None else None
            if p99 is None:
                return self.adaptive_floor_ms / 1000.0
            return max(p99, self.adaptive_floor_ms / 1000.0)
        return None

    def due(self) -> bool:
        """True exactly while the hedge should fire (once: callers mark
        ``fire()`` after sending the hedge)."""
        if self.fired or self.t0 is None:
            return False
        thr = self.threshold_s()
        if thr is None:
            return False
        return self.clock() - self.t0 >= thr

    def fire(self) -> None:
        self.fired = True
