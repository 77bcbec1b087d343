"""Paged admission for :class:`~nnstreamer_tpu_torch.models.serving.ContinuousBatcher`.

The paged half of ``nnstreamer_tpu/models/serving.py`` (its
``kv_layout="paged"`` methods), kept in a module of its own: the
batcher's decode steps stay in ``serving.py``, and the method names here
are the reference's. With the paged layout the KV cache is a block arena
(``kv/gather.py init_arena``) behind per-slot block tables, owned by a
:class:`~nnstreamer_tpu_torch.kv.blocks.BlockPool`:

- ``submit`` does no device work: it claims a slot and queues a
  :class:`~nnstreamer_tpu_torch.kv.sched.PrefillJob` (``_submit_paged``);
- each step or pump first advances the front job by at most
  ``prefill_chunks`` buckets of ``prompt_len`` tokens
  (``_advance_prefill``), so a decoding slot waits for at most that many
  chunk forwards, whatever the length of someone else's prompt; while
  nothing decodes, the front job runs until it activates;
- a job's first chunk matches its prompt against the pool's prefix index
  and adopts the shared blocks, seeding its stage from them
  (``_prefill_chunk_one``); the last chunk's job allocates the rest,
  lands the staged K/V in one write, registers its prefix and queues the
  activation, unless the pool cannot give every live request one block of
  decode growth besides (the watermark), in which case it waits
  (``_prefill_finalize``);
- before every step or pump each active slot gets blocks for its next
  token writes; a dry pool preempts the youngest other request, which
  frees its blocks and re-enters the queue to resume from whatever
  prefix still matches, its pending token carried over so its stream does
  not change (``_ensure_decode_room_locked``, ``_preempt_locked``).

The arena is updated in place; a step that raises after it began writing
latches the batcher's failure (``_mark_failed``).
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, Optional

import numpy as np
import torch

from nnstreamer_tpu_torch.kv.blocks import BlockPool, NoBlocksError
from nnstreamer_tpu_torch.kv.sched import PrefillJob, choose_victim
from nnstreamer_tpu_torch.models import decode as dec


class PagedAdmission:
    """The paged layout's state and admission methods, mixed into
    ``ContinuousBatcher``, which provides ``_lock``, ``_slots``,
    ``_active``, ``_pending``, ``_new_request``, ``_chunk_step``,
    ``_empty_stage`` and ``_sample1``."""

    def _init_paged(self, n_layers: int, kv: int, hd: int, block_size: int,
                    kv_blocks: Optional[int], prefill_chunks: int, quantized: bool) -> None:
        # kv.gather imports models.serving, which imports this module
        from nnstreamer_tpu_torch.kv import gather as kvg

        self.block_size = block_size
        self._blocks_per_slot = self.max_len // block_size
        if kv_blocks is None:
            # no saving: every slot can reach max_len; memory is saved by
            # setting kv_blocks below this
            kv_blocks = self.n_slots * self._blocks_per_slot
        if kv_blocks < self._blocks_per_slot:
            raise ValueError(
                f"kv_blocks({kv_blocks}) cannot hold even one max_len request "
                f"({self._blocks_per_slot} blocks)"
            )
        from nnstreamer_tpu_torch.obs import metrics as obs_metrics

        self._pool = BlockPool(int(kv_blocks), block_size, obs_registry=obs_metrics.get())
        self._cache = kvg.init_arena(n_layers, int(kv_blocks), block_size, kv, hd, quantized,
                                     self.compute_dtype, self.device)
        self._tables = np.zeros((self.n_slots, self._blocks_per_slot), np.int32)
        self._n_alloc = np.zeros((self.n_slots,), np.int32)
        self._tables_dev = torch.zeros(self._tables.shape, dtype=torch.int32, device=self.device)
        self._tables_dirty = False
        self._seed_stage, self._land_stage = kvg.make_staging_ops(quantized, self.compute_dtype)
        self._copy_block = kvg.make_paged_ops(quantized, self.compute_dtype)[2]
        self._prefill_q: deque = deque()
        self._prefill_chunks = max(1, int(prefill_chunks))
        self._n_prefill_chunk_programs = 0
        self._n_preemptions = 0
        self._n_gather_dispatch = 0
        self._n_migrations_out = 0  # extract_request(remove=True)
        self._n_migrations_in = 0   # adopt_request
        self._n_resumes = 0         # resume_from_span

    def _paged_stats_locked(self) -> Dict[str, Any]:
        st: Dict[str, Any] = dict(self._pool.stats())
        st.update(
            kv_block_size=self.block_size,
            kv_prefill_queue=len(self._prefill_q),
            kv_preemptions=self._n_preemptions,
            # which decode formulation runs (block: the arena attended
            # through the tables; gather: the view oracle) and how many
            # steps or pumps paid the gather round trip (0 under block)
            kv_attn=self._kv_attn,
            kv_gather_dispatches=self._n_gather_dispatch,
            kv_prefill_chunks=self._n_prefill_chunk_programs,
            kv_migrations_out=self._n_migrations_out,
            kv_migrations_in=self._n_migrations_in,
            request_resumes=self._n_resumes,
        )
        return st

    def _submit_paged(self, prompt: np.ndarray, max_new_tokens: int, temperature: float,
                      top_k: int, top_p: float, seed: Optional[int],
                      stop_token: Optional[int],
                      deadline_s: Optional[float] = None) -> Optional[int]:
        """Claim a slot and queue a chunked-prefill job; no device work.
        The prefix match happens when the job starts staging, so queued
        work pins no blocks."""
        with self._lock:
            slot = next((i for i, r in enumerate(self._slots) if r is None), None)
            if slot is None:
                return None
            req = self._new_request(max_new_tokens, temperature, top_k, top_p, seed,
                                    stop_token, fill0=0)
            req.prompt = prompt
            self._slots[slot] = req
            self._slo.submit(req.rid, deadline_s)
            self._prefill_q.append(PrefillJob(slot, req, prompt))
        return req.rid

    def _match_and_adopt_locked(self, job: PrefillJob, matchable: np.ndarray) -> None:
        m = self._pool.match(matchable)
        for b in m.full:
            self._pool.adopt(b)
        if m.partial_block is not None:
            self._pool.adopt(m.partial_block)
        if m.n_tokens:
            self._pool.record_hit_tokens(m.n_tokens)
        job.matched_full = list(m.full)
        job.matched_partial = m.partial_block
        job.n_partial = m.n_partial
        job.base = m.n_tokens

    def _release_match_locked(self, job: PrefillJob) -> None:
        """Drop a job's adopted prefix pins (the sharing-degradation path)."""
        self._pool.free(job.matched_full)
        if job.matched_partial is not None:
            self._pool.free([job.matched_partial])
        job.matched_full = []
        job.matched_partial = None
        job.n_partial = 0
        job.base = 0

    def _advance_prefill(self) -> None:
        """Advance the front job by ≤ ``prefill_chunks`` buckets and
        activate it once staged and affordable. The throttle exists only
        to bound decode stalls: while nothing decodes (no active slot, no
        activation pending) the queue keeps advancing until a job
        activates or the queue drains. Caller holds _step_lock; _lock is
        taken for bookkeeping only."""
        budget = self._prefill_chunks
        while True:
            with self._lock:
                job = self._prefill_q[0] if self._prefill_q else None
                idle = not self._active.any() and not self._pending
            if job is None or (budget <= 0 and not idle):
                return
            with self._lock:
                self._slo.prefilling(job.req.rid)
            if not job.done_staging():
                self._prefill_chunk_one(job)
                budget -= 1
            if job.done_staging():
                if self._prefill_finalize(job):
                    with self._lock:
                        if self._prefill_q and self._prefill_q[0] is job:
                            self._prefill_q.popleft()
                else:
                    return  # blocks not affordable yet (the watermark)

    def _prefill_chunk_one(self, job: PrefillJob) -> None:
        """One ``prompt_len`` bucket of chunked prefill for ``job`` (device
        work; caller holds _step_lock only)."""
        self._n_prefill_chunk_programs += 1
        P = self.prompt_len
        ctx = job.tokens
        t = job.fill
        if job.stage is None:
            if not job.no_rematch:
                with self._lock:
                    # a fresh request matches all but its last token, whose
                    # logits pick the first generated token; a resume (its
                    # pending token known) may match its whole context
                    self._match_and_adopt_locked(
                        job, ctx if job.known_first is not None else ctx[:-1]
                    )
            if (job.base == 0 and job.matched_partial is None and t <= P
                    and job.known_first is None):
                # a bucket-sized fresh prompt: the slot layout's one-program
                # prefill, so the two layouts' K/V are the same values
                padded = np.zeros((1, P), np.int64)
                padded[0, :t] = ctx
                logits, stage, _ = dec.prefill(
                    self.params, torch.as_tensor(padded, device=self.device), self.n_heads, P,
                    compute_dtype=self.compute_dtype,
                )
                job.logits_row = logits[0, t - 1]
                job.stage = stage
                job.cpos = t
                return
            stage = self._empty_stage()
            # the matched prefix K/V seeds the stage, so continuation
            # chunks attend it: every matched block in one write
            seeds = list(job.matched_full)
            if job.matched_partial is not None:
                seeds.append(job.matched_partial)
            if seeds:
                ids = np.zeros((self._stage_len // self.block_size,), np.int32)
                ids[: len(seeds)] = seeds
                stage = self._seed_stage(self._cache, stage, ids, len(seeds))
            job.stage = stage
        if job.done_staging():
            return
        start = job.base + job.cpos
        final = start + P >= t
        logits, stage, n = self._chunk_step(
            ctx[start:], start, job.stage, final and job.known_first is None
        )
        if logits is not None:
            job.logits_row = logits[0, n - 1]
        job.stage = stage
        job.cpos += n

    def _prefill_finalize(self, job: PrefillJob) -> bool:
        """Allocate the job's blocks, land its staged K/V, register its
        prefix and queue the activation. False: not affordable yet under
        the watermark (every live request keeps one block of decode growth
        besides), so the job waits — admission can defer but never starve
        the decode plane."""
        bs = self.block_size
        t = job.fill
        n_blocks = -(-t // bs)
        n_full = len(job.matched_full)
        fresh_needed = n_blocks - n_full  # the copy-on-write block included
        with self._lock:
            n_live = int(self._active.sum())
            if fresh_needed > 0 and self._pool.available() < fresh_needed + n_live:
                if n_live == 0:
                    # nothing decodes, so waiting cannot help
                    if job.matched_full or job.matched_partial is not None:
                        # give back the adopted prefix pins and restart
                        # staging unshared: degrade sharing to progress
                        self._release_match_locked(job)
                        job.stage = None
                        job.cpos = 0
                        job.no_rematch = True
                        return False
                    raise RuntimeError(
                        "kv pool cannot admit a request with nothing decoding: "
                        "kv_blocks too small for the prompt"
                    )
                return False
            try:
                fresh = self._pool.alloc(fresh_needed) if fresh_needed > 0 else []
            except NoBlocksError:
                return False
            if job.matched_partial is not None and fresh:
                self._pool.note_cow()  # the first fresh block is the copy
        blocks = list(job.matched_full) + fresh
        # the staged K/V into the fresh blocks (adopted full blocks hold
        # theirs; the copy-on-write block's copied prefix rides the seeded
        # stage, so one write covers copy and continuation)
        if job.stage is not None:
            if n_blocks > n_full:
                stage_blocks = job.stage[0].shape[2] // bs
                ids = np.zeros((stage_blocks,), np.int32)
                valid = np.zeros((stage_blocks,), bool)
                ids[n_full:n_blocks] = blocks[n_full:n_blocks]
                valid[n_full:n_blocks] = True
                self._land_stage(self._cache, job.stage, ids, valid)
        elif job.matched_partial is not None and fresh:
            # a fully matched resume ending in a partial block: a device
            # copy-on-write alone
            self._copy_block(self._cache, job.matched_partial, blocks[n_full])
        job.stage = None  # release the staging memory
        with self._lock:
            if job.matched_partial is not None:
                # the copy replaced the shared partial block
                self._pool.free([job.matched_partial])
            self._pool.register(job.tokens, blocks)
        req = job.req
        if job.known_first is not None:
            first: Any = int(job.known_first)
        else:
            req.fill0 = t  # sampling is seeded by (seed, fill)
            first = self._sample1(job.logits_row, req)
        job.logits_row = None
        # models.serving imports this module: its pending record is taken here
        from nnstreamer_tpu_torch.models.serving import _PendingInsert

        with self._lock:
            self._pending.append(_PendingInsert(job.slot, None, None, first, t, req,
                                                blocks=blocks, resumed=job.resumed,
                                                hist_row=self._hist_row(job.tokens)))
        return True

    def _ensure_decode_room_locked(self, n: int) -> None:
        """Give every active slot blocks for its next ``n`` token writes,
        preempting the youngest other request when the pool runs dry (its
        blocks free, shared prefix blocks stay cached, and it re-enters
        the prefill queue). Caller holds _lock."""
        bs = self.block_size
        for s, req in enumerate(self._slots):
            if req is None or not self._active[s]:
                continue
            pos = req.fill0 + len(req.tokens) - 1
            last = min(pos + int(n) - 1, self.max_len - 1)
            need = last // bs + 1
            while self._n_alloc[s] < need:
                try:
                    (b,) = self._pool.alloc(1)
                except NoBlocksError:
                    victim = choose_victim(self._slots, self._active, s)
                    if victim is None:
                        raise RuntimeError(
                            "kv pool exhausted with one active request left: kv_blocks "
                            "cannot cover a single stream's growth — raise kv_blocks"
                        ) from None
                    self._preempt_locked(victim)
                    continue
                self._tables[s, self._n_alloc[s]] = b
                self._n_alloc[s] += 1
                self._tables_dirty = True

    def _preempt_locked(self, slot: int) -> None:
        """Evict ``slot``'s request: free its blocks and queue a re-prefill
        of its whole known stream (prompt + generated tokens, the pending
        token carried as ``known_first``), so the resumed stream is the
        original — greedy and sampled, since sampling is seeded by (seed,
        fill)."""
        req = self._slots[slot]
        self._release_blocks_locked(slot)
        self._active[slot] = False
        self._pump_state_dirty = True
        self._n_preemptions += 1
        self._slo.preempted(req.rid)
        context = req.prompt
        if len(req.tokens) > 1:
            context = np.concatenate([req.prompt, np.asarray(req.tokens[:-1], np.int32)])
        self._prefill_q.append(PrefillJob(slot, req, context, known_first=int(req.tokens[-1]),
                                          resumed=True))

    def _release_blocks_locked(self, slot: int) -> None:
        """Drop ``slot``'s block references (shared prefix blocks stay in
        the pool's cached tier) and point its table row at scratch."""
        self._pool.free(self._tables[slot, : self._n_alloc[slot]].tolist())
        self._tables[slot] = 0
        self._n_alloc[slot] = 0
        self._tables_dirty = True

    def _set_table_locked(self, slot: int, blocks) -> None:
        row = np.zeros((self._blocks_per_slot,), np.int32)
        row[: len(blocks)] = blocks
        self._tables[slot] = row
        self._n_alloc[slot] = len(blocks)
        self._tables_dirty = True

    def _tables_device_locked(self) -> torch.Tensor:
        """The device copy of the block tables, copied into its buffer
        (whose address the pump programs hold) only after an allocation,
        preemption, admission or finish changed a row."""
        if self._tables_dirty:
            self._tables_dev.copy_(torch.from_numpy(self._tables))
            self._tables_dirty = False
        return self._tables_dev
