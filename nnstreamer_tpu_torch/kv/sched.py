"""Chunked-prefill admission, the preemption victim rule, per-request SLOs.

The counterpart of ``nnstreamer_tpu/kv/sched.py``:

- **Chunked prefill** (:class:`PrefillJob`): a paged ``submit`` never
  stalls the decode plane on a prefill. The prompt becomes a job; each
  step or pump advances the front job by at most ``prefill_chunks``
  buckets of ``prompt_len`` tokens before decoding, so a decoding
  request's gap between tokens is bounded by one chunk of someone else's
  prompt, however long that prompt is.
- **Preemption by eviction** (:func:`choose_victim`): decode growth that
  finds the pool dry evicts the youngest other request; its blocks are
  freed (shared prefix blocks survive in the pool's cached tier) and it
  re-enters the prefill queue to resume from whatever prefix still
  matches — never an OOM.
- **SLO ledger** (:class:`SLOLedger`): per-request queue / prefill / TTFT
  / TPOT wall stamps, a deadline and a preemption count, surfaced through
  ``ContinuousBatcher.requests()``, ``nns-top --requests`` and the
  ``nns_request_ttft_ms`` / ``nns_request_tpot_ms`` histograms, carried by
  a snapshot and (deadline and preemptions) by a migrated span.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class PrefillJob:
    """One admission working its way through chunked prefill.

    ``tokens`` is the full known context (the prompt for a fresh request;
    prompt + generated tokens but the last for a preempted one being
    re-prefilled — ``known_first`` then carries the pending token, so
    nothing is sampled again and the resumed stream is the original).
    ``base`` is the first position not yet covered (matched prefix tokens
    start it past 0); ``cpos`` tracks chunking progress."""

    slot: int
    req: Any  # models/serving._Request
    tokens: Any  # np.ndarray int32: the full context to (re)prefill
    known_first: Optional[int] = None
    base: int = 0          # positions < base came from the match
    cpos: int = 0          # positions < base + cpos are staged
    stage: Any = None      # (ks, vs) staging cache, built lazily
    logits_row: Any = None  # the final chunk's last-token logits
    matched_full: List[int] = field(default_factory=list)
    matched_partial: Optional[int] = None
    n_partial: int = 0
    resumed: bool = False
    # set by the sharing-degradation fallback: staging restarts without
    # matching again (adopting the same prefix would undo the degrade
    # and livelock the queue head)
    no_rematch: bool = False

    @property
    def fill(self) -> int:
        return int(self.tokens.shape[0])

    def done_staging(self) -> bool:
        return self.base + self.cpos >= self.fill


def choose_victim(slots, active, needy_slot: int) -> Optional[int]:
    """Preemption victim: the youngest (highest rid) active request other
    than the one needing room — it has the least sunk work and the best
    chance of a prefix hit when it comes back (its own prompt blocks just
    went to the cached tier). None when the needy slot is the only
    active one."""
    best = None
    best_rid = -1
    for s, req in enumerate(slots):
        if req is None or not active[s] or s == needy_slot:
            continue
        if req.rid > best_rid:
            best, best_rid = s, req.rid
    return best


@dataclass
class SLORecord:
    rid: int
    t_submit: float
    deadline_s: Optional[float] = None
    t_admit: Optional[float] = None      # prefill done, slot active
    t_first: Optional[float] = None      # first token known
    t_done: Optional[float] = None
    n_tokens: int = 0
    preemptions: int = 0
    # queued | prefilling | decoding | done | migrated (extracted and
    # hosted by a peer: terminal here; the adopting side opens a record of
    # its own that finishes the request)
    state: str = "queued"

    def view(self) -> Dict[str, Any]:
        ttft = tpot = None
        if self.t_first is not None:
            ttft = (self.t_first - self.t_submit) * 1000.0
        if self.t_done is not None and self.t_first is not None and self.n_tokens > 1:
            tpot = ((self.t_done - self.t_first) / (self.n_tokens - 1)) * 1000.0
        queue_ms = None
        if self.t_admit is not None:
            queue_ms = (self.t_admit - self.t_submit) * 1000.0
        out = {
            "state": self.state,
            "queue_ms": queue_ms,
            "ttft_ms": ttft,
            "tpot_ms": tpot,
            "tokens": self.n_tokens,
            "preemptions": self.preemptions,
        }
        if self.deadline_s is not None:
            remaining = self.deadline_s - (time.perf_counter() - self.t_submit)
            out["deadline_s"] = round(remaining, 3)
        return out


class SLOLedger:
    """Bounded per-request SLO accounting: single writer under the
    batcher's state lock; the TTFT / TPOT histograms go to the metrics
    registry resolved once at construction (None: none)."""

    def __init__(self, keep: int = 1024, obs_registry=None):
        self._recs: "OrderedDict[int, SLORecord]" = OrderedDict()
        self._keep = keep
        self._obs = obs_registry
        self.preemptions_total = 0

    def submit(self, rid: int, deadline_s: Optional[float] = None) -> SLORecord:
        rec = SLORecord(rid, time.perf_counter(), deadline_s=deadline_s)
        self._recs[rid] = rec
        while len(self._recs) > self._keep:
            self._recs.popitem(last=False)
        return rec

    def _get(self, rid: int) -> Optional[SLORecord]:
        return self._recs.get(rid)

    def prefilling(self, rid: int) -> None:
        rec = self._get(rid)
        if rec is not None and rec.state == "queued":
            rec.state = "prefilling"

    def admitted(self, rid: int) -> None:
        rec = self._get(rid)
        if rec is not None:
            rec.t_admit = time.perf_counter()
            rec.state = "decoding"

    def first_token(self, rid: int) -> None:
        rec = self._get(rid)
        if rec is not None and rec.t_first is None:
            rec.t_first = time.perf_counter()
            if self._obs is not None:
                self._obs.histogram("nns_request_ttft_ms").observe(
                    max((rec.t_first - rec.t_submit) * 1000.0, 1e-6))

    def record(self, rid: int) -> Optional[SLORecord]:
        """The live record of ``rid`` (a migration reads its deadline and
        preemptions to ship with the span), or None once evicted."""
        return self._get(rid)

    def migrated(self, rid: int) -> None:
        """The request was extracted and is hosted elsewhere: terminal for
        THIS ledger."""
        rec = self._get(rid)
        if rec is not None:
            rec.t_done = time.perf_counter()
            rec.state = "migrated"

    def preempted(self, rid: int) -> None:
        rec = self._get(rid)
        self.preemptions_total += 1
        if rec is not None:
            rec.preemptions += 1
            rec.state = "queued"

    def finished(self, rid: int, n_tokens: int) -> None:
        rec = self._get(rid)
        if rec is None:
            return
        rec.t_done = time.perf_counter()
        rec.n_tokens = n_tokens
        rec.state = "done"
        if rec.t_first is None:  # a one-token request: the first IS the last
            rec.t_first = rec.t_done
        if self._obs is not None and n_tokens > 1:
            tpot = (rec.t_done - rec.t_first) / (n_tokens - 1) * 1000.0
            self._obs.histogram("nns_request_tpot_ms").observe(max(tpot, 1e-6))

    def view(self, extra: Optional[Dict[int, Dict]] = None) -> Dict[int, Dict[str, Any]]:
        out = {}
        for rid, rec in self._recs.items():
            row = rec.view()
            if extra and rid in extra:
                row.update(extra[rid])
            out[rid] = row
        return out

    def snapshot(self) -> dict:
        return {
            "preemptions_total": self.preemptions_total,
            "records": [
                {
                    "rid": r.rid,
                    "t_submit": r.t_submit,
                    "deadline_s": r.deadline_s,
                    "t_admit": r.t_admit,
                    "t_first": r.t_first,
                    "t_done": r.t_done,
                    "n_tokens": r.n_tokens,
                    "preemptions": r.preemptions,
                    "state": r.state,
                }
                for r in self._recs.values()
            ],
        }

    def restore(self, snap: dict) -> None:
        self.preemptions_total = int(snap.get("preemptions_total", 0))
        self._recs = OrderedDict()
        for d in snap.get("records", []):
            rec = SLORecord(int(d["rid"]), float(d["t_submit"]), deadline_s=d.get("deadline_s"))
            rec.t_admit = d.get("t_admit")
            rec.t_first = d.get("t_first")
            rec.t_done = d.get("t_done")
            rec.n_tokens = int(d.get("n_tokens", 0))
            rec.preemptions = int(d.get("preemptions", 0))
            rec.state = str(d.get("state", "queued"))
            self._recs[rec.rid] = rec
