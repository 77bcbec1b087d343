"""Per-element error policies for streaming.

The counterpart of ``nnstreamer_tpu/pipeline/faults.py``. By default any
element error stops the pipeline (the reference's GST_FLOW_ERROR); an
element that declares the fault surface (``FAULT_PROPS``: tensor_filter,
tensor_transform, tensor_converter, tensor_decoder, tensor_chaos) may
instead keep the stream alive:

- ``on-error=stop``: fail fast with the original typed exception (default);
- ``drop``: skip the offending frame, counted;
- ``retry``: re-invoke with jittered exponential backoff (``retry-max``,
  ``retry-backoff-ms``, capped); exhausted retries go to the error pad when
  it is linked, else drop: a retry policy never becomes a delayed crash;
- ``route``: the frame and its exception become an ERROR FRAME on the
  element's error pad (``<name>.src_1``), the dead-letter queue; an
  unlinked pad drops.

:func:`resolve_fault_policy` merges element properties over the
``[executor]`` defaults (``NNS_TPU_EXECUTOR_ON_ERROR`` etc.), the first
element in chain order that sets a knob winning. :class:`FaultGate` applies
one node's policy around its frame work; a batched loop splits a failed
window through it per frame, so one bad frame never discards its
batchmates. :class:`PipelineStallError` is the stall watchdog's typed
report of a hang.

Each retry, drop and route is a trace event (trace.py) and a count in
``nns_fault_events_total`` by action when metrics are on, besides
:class:`FaultStats`. An admitted edge request
(``_nns_srv`` meta) that a policy disposes of or that a deadline sheds is
NACKed to its client and its admission budget released (edge/query.py).
"""

from __future__ import annotations

import random
import time
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

from nnstreamer_tpu_torch.elements.base import ON_ERROR_CHOICES
from nnstreamer_tpu_torch.log import get_logger

_log = get_logger("faults")


class PipelineStallError(RuntimeError):
    """The stall watchdog saw data queued and no node progressing for
    longer than ``watchdog_timeout_ms``. Carries a per-node snapshot
    ({node: {frames, queued}}) that localizes the hang."""

    def __init__(self, timeout_ms: float, snapshot: Dict[str, Dict]) -> None:
        self.timeout_ms = timeout_ms
        self.snapshot = snapshot
        stalled = [
            f"{name}(frames={s['frames']}, queued={s['queued']})"
            for name, s in sorted(snapshot.items()) if any(s["queued"])
        ] or [f"{n}(frames={s['frames']})" for n, s in sorted(snapshot.items())]
        super().__init__(
            f"pipeline made no progress for {timeout_ms:.0f} ms with data queued; "
            f"suspect node(s): {', '.join(stalled)}"
        )


@dataclass(frozen=True)
class FaultPolicy:
    """Resolved error-policy knobs for one execution node."""

    on_error: str = "stop"
    retry_max: int = 3
    backoff_ms: float = 10.0
    backoff_cap_ms: float = 1000.0

    @property
    def active(self) -> bool:
        return self.on_error != "stop"


def _executor_fault_defaults() -> dict:
    """``[executor]`` fault defaults (env ``NNS_TPU_EXECUTOR_*`` outranks
    the ini). A malformed value falls back with a warning."""
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

    on_error = c.get("executor", "on_error", "stop").strip().lower()
    if on_error not in ON_ERROR_CHOICES:
        _log.warning("[executor] on_error=%r not one of %s; using 'stop'",
                     on_error, "/".join(ON_ERROR_CHOICES))
        on_error = "stop"
    return {
        "on-error": on_error,
        "retry-max": _num("retry_max", int, 3),
        "retry-backoff-ms": _num("retry_backoff_ms", float, 10.0),
        "retry-backoff-cap-ms": _num("retry_backoff_cap_ms", float, 1000.0),
        "watchdog-timeout-ms": _num("watchdog_timeout_ms", float, 0.0),
    }


def watchdog_timeout_ms() -> float:
    """The executor's stall-watchdog timeout (0 = off, the default)."""
    return _executor_fault_defaults()["watchdog-timeout-ms"]


def resolve_fault_policy(elements: Sequence[Any]) -> FaultPolicy:
    """Element fault properties over the ``[executor]`` defaults: a
    chain-order scan, the first element that sets a knob wins."""
    defaults = _executor_fault_defaults()
    on_error: Optional[str] = None
    retry_max: Optional[int] = None
    backoff_ms: Optional[float] = None

    def _coerce(elem, prop: str, fn, raw):
        try:
            return fn(raw)
        except (TypeError, ValueError) as exc:
            raise ValueError(f"{getattr(elem, 'name', elem)}: bad {prop}={raw!r}: {exc}") from exc

    for e in elements:
        get = getattr(e, "get_property", None)
        if get is None:
            continue
        if on_error is None and get("on-error") is not None:
            raw = str(get("on-error")).strip().lower()
            if raw not in ON_ERROR_CHOICES:
                raise ValueError(f"{getattr(e, 'name', e)}: on-error={raw!r} not one of "
                                 f"{'/'.join(ON_ERROR_CHOICES)}")
            on_error = raw
        if retry_max is None and get("retry-max") is not None:
            retry_max = _coerce(e, "retry-max", int, get("retry-max"))
        if backoff_ms is None and get("retry-backoff-ms") is not None:
            backoff_ms = _coerce(e, "retry-backoff-ms", float, get("retry-backoff-ms"))
    return FaultPolicy(
        on_error=on_error if on_error is not None else defaults["on-error"],
        retry_max=max(0, int(retry_max if retry_max is not None else defaults["retry-max"])),
        backoff_ms=max(0.0, float(
            backoff_ms if backoff_ms is not None else defaults["retry-backoff-ms"])),
        backoff_cap_ms=max(0.0, float(defaults["retry-backoff-cap-ms"])),
    )


def backoff_s(attempt: int, policy: FaultPolicy, rng: random.Random) -> float:
    """Backoff of the ``attempt``-th retry (0-based): base × 2^attempt ms,
    capped, times a uniform jitter in [0.5, 1.0] so synchronized failures
    do not retry in lockstep."""
    full_ms = min(policy.backoff_ms * (2.0 ** attempt), policy.backoff_cap_ms)
    return (0.5 + 0.5 * rng.random()) * full_ms / 1000.0


def frame_deadline_expired(meta: Dict[str, Any], now: Optional[float] = None) -> bool:
    """True when a frame carries a ``deadline_ms`` budget AND an ``admit_t``
    monotonic admission stamp, and the budget has elapsed. A frame without
    both never expires: shedding is opt-in per request."""
    deadline_ms = meta.get("deadline_ms")
    t0 = meta.get("admit_t")
    if deadline_ms is None or t0 is None:
        return False
    if now is None:
        now = time.monotonic()
    try:
        return (now - float(t0)) * 1000.0 >= float(deadline_ms)
    except (TypeError, ValueError):
        return False


def notify_shed(frame, node_name: str) -> None:
    """A node shed ``frame`` at dequeue (its deadline passed before any
    device time was spent). Record the trace event, and when the frame is
    an admitted edge request (``_nns_srv`` meta) NACK the client and
    release its admission budget, so the request still reaches an end.
    The edge import is lazy: a pipeline that never sheds edge frames never
    loads the query layer."""
    from nnstreamer_tpu_torch import trace

    meta = frame.meta
    tracer = trace.get()
    if tracer is not None:
        tracer.fault(node_name, "deadline-shed", None,
                     frame_id=meta.get("frame_id"), deadline_ms=meta.get("deadline_ms"))
    srv = meta.get("_nns_srv")
    if srv is not None:
        from nnstreamer_tpu_torch.edge.query import nack_for_shed

        nack_for_shed(srv, meta.get("client_id"), frame_id=meta.get("frame_id"))


def notify_drain_flush(frame, node_name: str) -> None:
    """A draining query server flushed ``frame`` from its admitted queue
    before it spent device time (``drain(flush_queued=True)``): record the
    trace event and NACK the client ``draining``, so a fleet client sends
    the request elsewhere; the admission budget is released."""
    from nnstreamer_tpu_torch import trace

    meta = getattr(frame, "meta", None) or {}
    tracer = trace.get()
    if tracer is not None:
        tracer.fault(node_name, "drain-flush", None, frame_id=meta.get("frame_id"))
    srv = meta.get("_nns_srv")
    if srv is not None:
        from nnstreamer_tpu_torch.edge.query import drain_flushed

        drain_flushed(srv, meta.get("client_id"), frame_id=meta.get("frame_id"))


def notify_discard(frame, node_name: str, action: str) -> None:
    """A fault policy disposed of ``frame`` (``drop`` or ``route``). When
    it is an admitted edge request (``_nns_srv`` meta), return its
    admission budget, and for a drop NACK the client (``failed``, or
    ``draining`` while its server drains, which a fleet client re-routes).
    A routed frame gets no NACK: its dead-letter consumer owns it now."""
    meta = getattr(frame, "meta", None)
    if not meta:
        return
    srv = meta.get("_nns_srv")
    if srv is None:
        return
    from nnstreamer_tpu_torch.edge.query import discard_admitted

    discard_admitted(srv, meta.get("client_id"), action, frame_id=meta.get("frame_id"))


def make_error_frame(frame, exc: Exception, element: str):
    """The dead-letter frame: the ORIGINAL input tensors, so a consumer can
    replay or inspect the payload, plus structured error meta."""
    return frame.with_meta(error=True, error_element=element,
                           error_type=type(exc).__name__, error_msg=str(exc))


class FaultStats:
    """One node's fault counters (its thread is the only writer)."""

    __slots__ = ("errors", "dropped", "routed", "routed_unlinked",
                 "retries", "retry_exhausted", "backoff_total_s")

    def __init__(self) -> None:
        self.errors = 0           # raw element failures seen
        self.dropped = 0          # frames a policy consumed (incl. degraded)
        self.routed = 0           # error frames delivered to the error pad
        self.routed_unlinked = 0  # route with no error-pad consumer
        self.retries = 0          # re-invocations
        self.retry_exhausted = 0  # frames whose retry budget ran out
        self.backoff_total_s = 0.0

    def snapshot(self) -> dict:
        return {
            "errors": self.errors,
            "error_dropped": self.dropped,
            "error_routed": self.routed,
            "error_retries": self.retries,
            "error_retry_exhausted": self.retry_exhausted,
            "error_backoff_ms": round(self.backoff_total_s * 1000.0, 3),
        }

    def state(self) -> dict:
        """The warm-restart payload (Executor.snapshot)."""
        return {k: getattr(self, k) for k in self.__slots__ if k != "backoff_total_s"}

    def restore(self, snap: dict) -> None:
        for k in self.__slots__:
            if k in snap:
                setattr(self, k, int(snap[k]))


class FaultGate:
    """Applies one node's :class:`FaultPolicy` around per-frame work.
    ``process(frame, fn)`` returns ``(delivered, result)``: False means the
    policy consumed the frame (dropped or routed) and streaming goes on.
    ``stop`` raises the original exception unchanged; the executor builds a
    gate only for an active policy."""

    def __init__(
        self,
        policy: FaultPolicy,
        name: str,
        stop_event=None,
        route: Optional[Callable[[Any], None]] = None,
        raise_through: Tuple[type, ...] = (),
        stop_exc: Optional[type] = None,
    ) -> None:
        self.policy = policy
        self.name = name
        self.stop_event = stop_event
        self.route = route  # callable(error_frame) when the error pad is linked
        self.raise_through = raise_through
        self.stop_exc = stop_exc
        self.stats = FaultStats()
        # monotonic end of a backoff sleep in progress (0.0 = none): the
        # stall watchdog never takes a node backing off for a hang
        self.backoff_deadline = 0.0
        # a per-node jitter stream with a content-stable seed, so retry
        # timing does not change with PYTHONHASHSEED
        self._rng = random.Random(zlib.crc32(name.encode()))
        # the metrics registry, resolved once (None when metrics are off)
        from nnstreamer_tpu_torch.obs import metrics as obs_metrics

        self._obs_reg = obs_metrics.get()

    def process(self, frame, fn: Callable[[Any], Any]) -> Tuple[bool, Any]:
        policy = self.policy
        attempt = 0
        while True:
            try:
                return True, fn(frame)
            except self.raise_through:
                raise
            except Exception as exc:  # noqa: BLE001 — the policy decides
                self.stats.errors += 1
                if policy.on_error == "retry" and attempt < policy.retry_max:
                    delay = backoff_s(attempt, policy, self._rng)
                    attempt += 1
                    self.stats.retries += 1
                    self.stats.backoff_total_s += delay
                    self._trace("retry", exc, attempt=attempt,
                                backoff_ms=round(delay * 1000.0, 3))
                    self._sleep(delay)
                    continue
                return False, self.dispose(frame, exc, attempt)

    def dispose(self, frame, exc: Exception, attempts: int = 0):
        """The frame failed past any retry budget: drop or route it
        (``stop`` re-raises)."""
        mode = self.policy.on_error
        if mode == "stop":
            raise exc
        if mode == "retry":
            # exhausted: the dead-letter pad when wired, else drop
            self.stats.retry_exhausted += 1
            mode = "route" if self.route is not None else "drop"
        if mode == "route":
            if self.route is not None:
                self.stats.routed += 1
                self._trace("route", exc)
                err = make_error_frame(frame, exc, self.name)
                if frame.meta.get("_nns_srv") is not None:
                    # the admission budget is released here (notify_discard);
                    # a dead-letter consumer replying through the serversink
                    # must not release it a second time
                    err = err.with_meta(_nns_budget_released=True)
                self.route(err)
                notify_discard(frame, self.name, "route")
                return None
            self.stats.routed_unlinked += 1
            self.stats.dropped += 1
            self._trace("route-unlinked", exc)
            _log.warning("%s: on-error=route but the error pad is unlinked; dropping "
                         "frame (%s: %s)", self.name, type(exc).__name__, exc)
            notify_discard(frame, self.name, "drop")
            return None
        self.stats.dropped += 1
        self._trace("drop", exc, attempts=attempts)
        _log.debug("%s: dropped frame after %d attempt(s), %s: %s",
                   self.name, attempts, type(exc).__name__, exc)
        notify_discard(frame, self.name, "drop")
        return None

    def _trace(self, action: str, exc: Exception, **extra) -> None:
        """One fault event: a trace event when tracing is on, and
        ``nns_fault_events_total`` by action when metrics are (cold path:
        one event a retry, drop or route, never a frame)."""
        from nnstreamer_tpu_torch import trace

        tracer = trace.get()
        if tracer is not None:
            tracer.fault(self.name, action, exc, **extra)
        reg = self._obs_reg
        if reg is not None:
            reg.counter("nns_fault_events_total", element=self.name, action=action).inc()

    def _sleep(self, delay: float) -> None:
        """A backoff sleep in short slices that honours the executor's stop
        event: a parked retry never stalls teardown."""
        deadline = time.monotonic() + delay
        self.backoff_deadline = deadline
        try:
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return
                if self.stop_event is not None and self.stop_event.is_set():
                    if self.stop_exc is not None:
                        raise self.stop_exc()
                    return
                time.sleep(min(0.05, remaining))
        finally:
            self.backoff_deadline = 0.0
