"""Chunked-prefill admission jobs and the preemption victim rule.

The counterpart of the scheduling half of ``nnstreamer_tpu/kv/sched.py``:

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

Not ported yet: the per-request SLO ledger (``SLOLedger``, ``SLORecord``)
and the ``requests()`` view it feeds; they come with the observability
slice. The batcher counts preemptions itself.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional


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
