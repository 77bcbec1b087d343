"""LlmPlane: continuous batching of the LLM pumps THROUGH a plane.

The counterpart of ``nnstreamer_tpu/serving_plane/llm.py``. Without a
plane every ``tensor_llm_serversink`` owns a private paged batcher: N
serving pipelines mean N model copies. An LlmPlane is the tensor plane's
discipline (plane.py) at TOKEN granularity: every serversink naming
``plane=<name>`` attaches as one client stream of ONE shared paged
``ContinuousBatcher``, and the decode pumps (driven by whichever paired
serversrc thread gets there first) advance every stream's requests in one
slot batch. On CUDA each pump is one replay of the batcher's captured
pump program, with K4 inside.

What each stream keeps:

- **Admission fairness**: queued prompts admit into free batcher
  capacity through the same deficit-round-robin :class:`StreamScheduler`
  the tensor plane uses, so a flooding serversink cannot starve a trickle
  stream out of slots; ``plane-weight`` scales a stream's share.
- **Output routing**: completed generations land on the submitting
  stream's own output deque with its meta intact, so each pipeline's
  serversrc emits only its own generations.

Lifecycle mirrors the tensor plane registry: refcounted by attached
serversink, the first :func:`acquire` builds the batcher (the opener owns
the model props), the last :func:`release` drops it.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.serving_plane.scheduler import (
    PlaneStream,
    StreamScheduler,
)

_log = get_logger("serving_plane.llm")


class LlmPlaneError(RuntimeError):
    """Misuse of a shared LLM plane (config conflict, closed plane)."""


class _PromptReq:
    """One queued-but-unadmitted prompt (cost 1 in the DRR scheduler —
    no ``frames`` attribute, so the shared collect() counts it as one
    slot)."""

    __slots__ = ("prompt", "budget", "kw", "meta")

    def __init__(self, prompt, budget: int, kw: dict, meta: dict) -> None:
        self.prompt = prompt
        self.budget = budget
        self.kw = kw
        self.meta = meta


class LlmStream(PlaneStream):
    """PlaneStream plus the token-serving surfaces: the rid→meta map of
    admitted-but-unfinished requests, the completed-generation output
    deque, and the full rid history (the per-stream request filter)."""

    __slots__ = ("pending", "out", "rids")

    def __init__(self, sid: str, weight: float = 1.0) -> None:
        super().__init__(sid, weight)
        self.pending: Dict[int, dict] = {}
        from collections import deque

        self.out = deque()
        self.rids: set = set()


class LlmPlane:
    """One shared paged ContinuousBatcher serving N serversink streams.

    Locking: ``_lock`` guards queues/maps/deques (submitters + the
    pumping thread), ``_pump_lock`` serializes batcher stepping — many
    serversrc threads may call :meth:`pump`, one steps at a time, the
    rest return quickly and re-poll (their outputs land via the
    stepper's harvest).
    """

    def __init__(self, name: str, cb, pump_tokens: int = 1) -> None:
        self.name = name
        self.cb = cb
        self.pump_tokens = max(1, int(pump_tokens))
        self._sched = StreamScheduler()
        self._lock = threading.Lock()
        self._pump_lock = threading.Lock()
        self._owner: Dict[int, LlmStream] = {}  # live rid -> stream
        self.closed = False
        self.admit_rounds = 0

    # -- streams -----------------------------------------------------------
    def attach(self, sid: str, weight: float = 1.0) -> LlmStream:
        with self._lock:
            if self.closed:
                raise LlmPlaneError(f"llm plane {self.name!r} is closed")
            s = LlmStream(sid, weight)
            self._sched.add(s)
            return s

    def refuse_migration(self, op: str) -> None:
        """Plane-shared batchers refuse the live-migration surface with
        a typed error: the KV arena, slot table, and prefix index are shared across N
        serversink streams, so extracting or adopting a span here would
        move one stream's request through state every sharer co-owns.
        Migration needs a PRIVATE kv-layout=paged batcher."""
        raise LlmPlaneError(
            f"llm plane {self.name!r}: {op} refused — plane-shared "
            "batchers cannot migrate or checkpoint requests; serve "
            "with a private kv-layout=paged batcher instead"
        )

    def detach(self, stream: LlmStream) -> None:
        """Drop a stream: its queued prompts are discarded (the owning
        pipeline is stopping — nobody will pop their generations) and
        its admitted requests are orphaned from the routing table so
        the pump never appends to a dead deque. The batcher finishes
        (and frees) the orphans on its own schedule."""
        with self._lock:
            self._sched.remove(stream)
            for rid in list(self._owner):
                if self._owner[rid] is stream:
                    del self._owner[rid]
            stream.pending.clear()

    # -- submission (serversink render threads) ----------------------------
    def submit(
        self, stream: LlmStream, prompt, budget: int, kw: dict,
        meta: dict,
    ) -> None:
        """Queue one prompt for weighted-fair admission. Submission
        itself never blocks on a free slot — admission control is the
        scheduler's job — but a stream deep past its fair backlog pumps
        the plane (backpressure by doing the work, the serversink
        discipline)."""
        with self._lock:
            if self.closed:
                raise LlmPlaneError(f"llm plane {self.name!r} is closed")
            stream.q.append(_PromptReq(prompt, budget, kw, meta))
            stream.admitted += 1
            self._admit_locked()
        # soft backpressure: past 2× the batcher's slot count queued on
        # THIS stream, drive decode until admission drains the excess
        bound = 2 * max(1, getattr(self.cb, "n_slots", 1))
        while len(stream.q) > bound and not self.closed:
            if not self.pump():
                time.sleep(0.002)

    def _admit_locked(self) -> None:
        """Admit queued prompts into the batcher, one DRR pick at a
        time, until the batcher refuses (slot/watermark full) or the
        queues drain. ``_lock`` held; cb.submit is thread-safe but the
        pick→submit→record sequence must be atomic so the refused pick
        goes back to the FRONT of its stream's queue (FIFO intact)."""
        while True:
            picked = self._sched.collect(1)
            if not picked:
                return
            self.admit_rounds += 1
            s, req = picked[0]
            try:
                rid = self.cb.submit(req.prompt, req.budget, **req.kw)
            except Exception:
                # a poisoned prompt fails ITS request; the stream sees
                # the error as a dropped generation (counted), never a
                # wedged admission loop
                s.errors += 1
                _log.warning(
                    "llm plane %s: submit failed for stream %s",
                    self.name, s.sid, exc_info=True,
                )
                continue
            if rid is None:
                # batcher full: refund the pick (front of queue + the
                # consumed DRR slot) and stop admitting this round
                s.q.appendleft(req)
                s.deficit += 1.0
                return
            s.pending[rid] = req.meta
            s.rids.add(rid)
            self._owner[rid] = s

    # -- decode (serversrc pump threads) -----------------------------------
    def pump(self) -> bool:
        """One decode advance of the shared batcher + harvest: finished
        requests route to their owning stream's output deque, then
        freed capacity admits more queued prompts. Many threads may
        call this; one steps at a time (``_pump_lock``), contenders
        skip — their generations arrive via the stepper's harvest, so
        a skipped pump still reports progress when its stream gained
        output."""
        cb = self.cb
        if cb is None:  # closed under a late pumper
            return False
        if not self._pump_lock.acquire(blocking=False):
            # someone else is stepping; don't stack a second device
            # round trip behind theirs
            return False
        try:
            if self.pump_tokens > 1:
                emitted = cb.step_pump(self.pump_tokens)
            else:
                emitted = cb.step()
            harvested = False
            with self._lock:
                for rid in list(self._owner):
                    toks = cb.result(rid)
                    if toks is None:
                        continue
                    s = self._owner.pop(rid)
                    meta = s.pending.pop(rid, {})
                    s.out.append((toks, meta))
                    s.served += 1
                    harvested = True
                self._admit_locked()
            return bool(emitted) or harvested
        finally:
            self._pump_lock.release()

    def pop(self, stream: LlmStream) -> Optional[Tuple[Any, dict]]:
        with self._lock:
            return stream.out.popleft() if stream.out else None

    def idle_for(self, stream: LlmStream) -> bool:
        """True when the stream has nothing queued, admitted, or
        popped-pending — the serversrc's drain condition (its own eos
        flag ANDed by the caller)."""
        with self._lock:
            return (
                not stream.q and not stream.pending and not stream.out
            )

    # -- observability -----------------------------------------------------
    def stats_for(self, stream: LlmStream) -> Dict[str, Any]:
        """Batcher counters + THIS stream's SLO request rows only
        (``requests``, from the batcher's ledger: sharers never report
        each other's) + the plane-wide sharing surface + this stream's
        counters."""
        cb = self.cb
        if cb is None:  # closed: only the stream-side counters remain
            st: Dict[str, Any] = {"requests": {}}
        else:
            st = cb.stats()
            st["requests"] = {str(rid): row for rid, row in cb.requests().items()
                              if rid in stream.rids}
        with self._lock:
            st["plane"] = self.name
            st["plane_streams"] = len(self._sched)
            st["plane_queued_prompts"] = sum(
                len(s.q) for s in self._sched.streams()
            )
            st["stream_submitted"] = stream.admitted
            st["stream_served"] = stream.served
            st["stream_errors"] = stream.errors
            st["stream_queued"] = len(stream.q)
            st["stream_active"] = len(stream.pending)
        return st

    def close(self) -> None:
        with self._lock:
            self.closed = True
            self._owner.clear()
        self.cb = None  # drop params + KV arena references


# -- process-wide registry (the ModelPlane registry's sibling) --------------

_registry_lock = threading.Lock()
# name -> {"plane", "sig", "refs", "open_lock"}
_planes: Dict[str, Dict[str, Any]] = {}


def acquire(
    name: str,
    sig: tuple,
    opener: Callable[[], Any],
    pump_tokens: int = 1,
) -> LlmPlane:
    """Get-or-create the named LLM plane; refcounted like the tensor
    plane registry. ``sig`` (model + batcher config) must agree across
    sharers — the batcher is ONE object, so a disagreeing sharer would
    silently serve with someone else's model. ``opener()`` builds the
    ContinuousBatcher (first attacher only)."""
    with _registry_lock:
        entry = _planes.get(name)
        if entry is None:
            entry = {"plane": None, "sig": sig, "refs": 0,
                     "pump_tokens": pump_tokens,
                     "open_lock": threading.Lock()}
            _planes[name] = entry
        else:
            if entry["sig"] != sig:
                raise LlmPlaneError(
                    f"llm plane {name!r} already bound to a different "
                    f"model/batcher config, cannot rebind "
                    f"({entry['sig']} vs {sig})"
                )
        entry["refs"] += 1
    try:
        with entry["open_lock"]:
            if entry["plane"] is None:
                entry["plane"] = LlmPlane(
                    name, opener(), pump_tokens=entry["pump_tokens"]
                )
        return entry["plane"]
    except Exception:
        with _registry_lock:
            entry["refs"] -= 1
            if entry["refs"] <= 0 and entry["plane"] is None:
                _planes.pop(name, None)
        raise


def release(name: str, plane: LlmPlane) -> bool:
    """Drop one ref; closes (and unregisters) the plane when the last
    sharer leaves. True when this call actually closed it."""
    with _registry_lock:
        entry = _planes.get(name)
        if entry is None or entry["plane"] is not plane:
            plane.close()
            return True
        entry["refs"] -= 1
        if entry["refs"] > 0:
            return False
        del _planes[name]
    plane.close()
    return True


def get(name: str) -> Optional[LlmPlane]:
    """The live LLM plane registered under ``name`` (introspection), or
    None."""
    entry = _planes.get(name)
    return entry["plane"] if entry else None
