"""Replica failover: load-balanced dispatch over N copies of one model.

The counterpart of ``nnstreamer_tpu/parallel/replicas.py``, generic over
"a callable that invokes one replica", so it serves the filter's
``replicas=N`` (elements/filter.py) and the plane's ``plane-mode=replicas``
(serving_plane/sharding.py ``ReplicatedProgram``):

- **dispatch** round-robins over the healthy replicas;
- **failover**: a device-classified fault (pipeline/device_faults.py)
  re-dispatches the in-flight call onto the next replica of its plan, so
  nothing is lost to a dying replica; after ``unhealthy_after``
  CONSECUTIVE device faults the replica is benched;
- **recovery**: every ``probe_every`` dispatches while one is benched, one
  call probes a benched replica (rotating among them); success re-admits it;
- **exhaustion**: with no replica healthy and the plan spent,
  :class:`ReplicaExhaustedError` raises with the last fault chained, and
  the caller's error policy disposes of the frame.

An exception that is not a device fault (bad input, user code) propagates
unchanged: it says nothing about a replica's health.

Thread safety: health state changes under a lock; the invokes run outside
it.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.pipeline.device_faults import (
    ReplicaExhaustedError,
    classify_device_fault,
)

_log = get_logger("parallel.replicas")


class Replica:
    """One dispatch target: an invoke callable plus health bookkeeping."""

    __slots__ = ("idx", "invoke", "healthy", "consec_faults", "faults",
                 "served", "fault_kinds")

    def __init__(self, idx: int, invoke: Callable[..., Any]) -> None:
        self.idx = idx
        self.invoke = invoke
        self.healthy = True
        self.consec_faults = 0
        self.faults = 0
        self.served = 0
        self.fault_kinds: Dict[str, int] = {}


class ReplicaSet:
    """Load-balanced dispatch over N replicas with device-fault-driven
    failover (module docstring has the contract)."""

    def __init__(
        self,
        invokes: Sequence[Callable[..., Any]],
        unhealthy_after: int = 3,
        probe_every: int = 64,
        classify: Callable[[BaseException], Optional[str]] =
        classify_device_fault,
    ) -> None:
        if not invokes:
            raise ValueError("ReplicaSet needs at least one replica")
        self.replicas: List[Replica] = [
            Replica(i, fn) for i, fn in enumerate(invokes)
        ]
        self.unhealthy_after = max(1, int(unhealthy_after))
        self.probe_every = max(1, int(probe_every))
        self.classify = classify
        self._lock = threading.Lock()
        self._rr = 0            # round-robin cursor over healthy replicas
        self._probe_rr = 0      # rotation cursor over unhealthy replicas
        self._since_probe = 0   # dispatches since the last recovery probe
        self.failovers = 0      # frames re-dispatched off a faulting replica
        self.exhaustions = 0    # dispatches whose whole plan faulted

    # -- selection ---------------------------------------------------------
    def _next_targets(self) -> List[Replica]:
        """Ordered dispatch plan for ONE frame: healthy replicas from the
        round-robin cursor; every probe_every dispatches an unhealthy
        replica is prepended as a recovery probe (its frame falls
        through to the healthy rotation if the probe fails)."""
        with self._lock:
            healthy = [r for r in self.replicas if r.healthy]
            sick = [r for r in self.replicas if not r.healthy]
            plan: List[Replica] = []
            if not sick:
                # cadence counts dispatches WHILE benched — an idle-high
                # counter would probe a just-benched (still dead) replica
                # on the very next frame instead of probe_every later
                self._since_probe = 0
            else:
                self._since_probe += 1
            if sick and (
                not healthy or self._since_probe >= self.probe_every
            ):
                self._since_probe = 0
                # rotate the probe across sick replicas: always probing
                # the lowest index starves the rest of recovery when it
                # is permanently dead
                start = self._probe_rr % len(sick)
                self._probe_rr += 1
                if healthy:
                    plan.append(sick[start])
                else:
                    # nothing healthy left: give EVERY benched replica a
                    # shot this frame rather than exhausting behind one
                    # dead probe target
                    plan.extend(sick[start:] + sick[:start])
            if healthy:
                start = self._rr % len(healthy)
                self._rr += 1
                plan.extend(healthy[start:] + healthy[:start])
            return plan

    # -- health bookkeeping ------------------------------------------------
    def _record_fault(self, rep: Replica, kind: str) -> None:
        with self._lock:
            rep.faults += 1
            rep.fault_kinds[kind] = rep.fault_kinds.get(kind, 0) + 1
            rep.consec_faults += 1
            if rep.healthy and rep.consec_faults >= self.unhealthy_after:
                rep.healthy = False
                _log.warning(
                    "replica %d UNHEALTHY after %d consecutive device "
                    "fault(s) (last: %s); redistributing its load",
                    rep.idx, rep.consec_faults, kind,
                )

    def _record_ok(self, rep: Replica) -> None:
        with self._lock:
            rep.consec_faults = 0
            rep.served += 1
            if not rep.healthy:
                rep.healthy = True
                _log.warning("replica %d recovered; back in rotation",
                             rep.idx)

    # -- dispatch ----------------------------------------------------------
    def dispatch(self, *args, **kwargs):
        """Invoke one frame on the replica set. Device faults fail over
        to the next target in this frame's plan; raises
        ReplicaExhaustedError (last fault chained) when the plan runs
        dry with nothing healthy left."""
        last: Optional[BaseException] = None
        plan = self._next_targets()
        for n, rep in enumerate(plan):
            try:
                out = rep.invoke(*args, **kwargs)
            except Exception as exc:  # noqa: BLE001 — classified below
                kind = self.classify(exc)
                if kind is None:
                    # not a replica-health signal: the caller's problem
                    raise
                self._record_fault(rep, kind)
                if n + 1 < len(plan):
                    with self._lock:
                        self.failovers += 1
                last = exc
                continue
            self._record_ok(rep)
            return out
        with self._lock:
            self.exhaustions += 1
        raise ReplicaExhaustedError(
            f"all {len(self.replicas)} replicas unhealthy"
            + (f" (last fault: {last})" if last is not None else "")
        ) from last

    # -- observability / warm restart --------------------------------------
    @property
    def healthy_count(self) -> int:
        return sum(1 for r in self.replicas if r.healthy)

    def stats(self) -> Dict[str, Any]:
        return {
            "replicas": len(self.replicas),
            "healthy": self.healthy_count,
            "failovers": self.failovers,
            "exhaustions": self.exhaustions,
            "served": [r.served for r in self.replicas],
            "faults": [r.faults for r in self.replicas],
        }

    def snapshot(self) -> dict:
        return {
            "healthy": [r.healthy for r in self.replicas],
            "failovers": self.failovers,
            "exhaustions": self.exhaustions,
        }

    def restore(self, snap: dict) -> None:
        flags = snap.get("healthy") or []
        for rep, ok in zip(self.replicas, flags):
            rep.healthy = bool(ok)
            rep.consec_faults = 0
        self.failovers = int(snap.get("failovers", 0))
        self.exhaustions = int(snap.get("exhaustions", 0))
