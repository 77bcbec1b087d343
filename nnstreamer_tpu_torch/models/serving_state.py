"""Snapshot / restore and request migration for the serving engine.

The warm-restart and live-migration half of ``nnstreamer_tpu/models/serving.py``,
kept in a module of its own beside ``serving_paged.py`` and
``serving_spec.py`` and mixed into
:class:`~nnstreamer_tpu_torch.models.serving.ContinuousBatcher`:

- :meth:`~ServingState.snapshot` copies the whole serving state to host
  memory (numpy), and :meth:`~ServingState.restore` loads it into a batcher
  of the same configuration, on both layouts and the windowed ring;
- on the paged layout :meth:`~ServingState.extract_request` serializes one
  live request into a :class:`~nnstreamer_tpu_torch.kv.migrate.RequestSpan`
  (its blocks' raw arena bytes), :meth:`~ServingState.adopt_request` lands
  a span into this batcher and continues it, and
  :meth:`~ServingState.resume_from_span` re-prefills it from its tokens
  instead, the one path that recomputes, which the caller chooses.

The pump programs capture the addresses of the device state, so nothing
here rebinds a buffer: restore and adoption copy into the fixed buffers
(the cache or arena, ``_tok``, ``_pos``, the sampling vectors, ``_hist``,
the draft's cache) and mark the host-built pump state and the tables
stale, which the next pump ships. A restore or adoption that is refused
raises its typed error before anything moves.

The SLO ledger (kv/sched.py) rides along: a snapshot carries it whole and
a restore loads it; an extracted span carries its request's remaining
deadline and preemption count, the source's record turns ``migrated``, and
an adopting or resuming batcher opens a record of its own with both.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16", torch.float16: "float16",
                torch.int8: "int8"}


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested tuple in tree order: ``(k, v)``, or
    ``(k8, k_scale, v8, v_scale)`` for an int8 cache (the reference's
    tree-leaves order)."""
    if isinstance(tree, tuple):
        return [leaf for part in tree for leaf in leaves(part)]
    return [tree]


def _host_dtype(t: torch.Tensor) -> np.dtype:
    """The numpy dtype a tensor's host copy has (bfloat16 travels as the
    int16 of its bits: numpy has no bfloat16)."""
    return np.dtype(np.int16) if t.dtype == torch.bfloat16 else np.dtype(
        str(t.dtype).replace("torch.", ""))


def to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` (never a view of a CPU tensor's memory)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.to("cpu", copy=True).numpy()


def from_host(arr: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    """A tensor of ``dtype`` on ``device`` from a :func:`to_host` copy."""
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    return t.view(torch.bfloat16) if dtype == torch.bfloat16 else t


def copy_in(dst: torch.Tensor, arr: np.ndarray) -> None:
    """Write a host copy into ``dst`` in place (its address stays)."""
    src = torch.from_numpy(np.ascontiguousarray(arr))
    (dst.view(torch.int16) if dst.dtype == torch.bfloat16 else dst).copy_(src)


def _tree_host(tree):
    if isinstance(tree, tuple):
        return tuple(_tree_host(t) for t in tree)
    return to_host(tree)


def _tree_cat(trees: List[Any], axis: int):
    """The host trees of a mesh's shards joined along their slot axis."""
    if isinstance(trees[0], tuple):
        return tuple(_tree_cat([t[i] for t in trees], axis) for i in range(len(trees[0])))
    return np.concatenate(trees, axis=axis)


#: the per-slot buffers a snapshot carries, beside the cache (slot axis 0)
_SLOT_VECTORS = ("tok", "pos", "temp", "topk", "topp", "keys", "hist")


def seed_words(seed: int) -> np.ndarray:
    """A request's seed as a span's ``key``: uint32 [2] in
    ``jax.random.PRNGKey``'s layout (high word, low word)."""
    s = int(seed) & ((1 << 64) - 1)
    return np.asarray([s >> 32, s & _M32], np.uint32)


def seed_of_words(key) -> int:
    """The seed a span's ``key`` carries (:func:`seed_words`' inverse)."""
    hi, lo = (int(x) for x in np.asarray(key, np.uint32).reshape(-1)[:2])
    return (hi << 32) | lo


class ServingState:
    """Snapshot / restore and request migration, mixed into
    ``ContinuousBatcher``, which provides the slot state, the device
    buffers, the locks, ``_apply_pending`` and (paged) the pool, the
    tables and ``_release_blocks_locked``."""

    def _settle_pending(self) -> None:
        """Apply the queued admissions (caller holds _step_lock); a raise
        latches the failure, as every in-place device write does."""
        try:
            with torch.no_grad():
                self._apply_pending()
        except Exception as exc:
            self._mark_failed(exc)
            raise

    # -- warm restart ------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """The serving state in host memory: every live request, the device
        state as numpy (the cache or arena, ``tok``, ``pos``, the sampling
        vectors, the seed keys, the token history, and a draft's cache), the
        counters, the finished requests awaiting pickup, the registered
        prefixes, and on the paged layout the block tables and the pool's
        accounting. Pending admissions are applied first; a paged batcher
        must have drained its prefill queue (pump until
        ``kv_prefill_queue`` is 0), so that no half-staged prompt is lost.
        The SLO ledger is in it (``slo``). The snapshot is this package's
        own dict: it does not load into the JAX
        package's batcher."""
        self._check_failed()
        with self._step_lock:
            self._settle_pending()
            with self._lock:
                if self._paged and self._prefill_q:
                    raise RuntimeError(
                        "snapshot with queued prefills: pump until the prefill queue drains first"
                    )
                reqs = [{
                    "slot": s, "rid": req.rid, "budget": req.budget,
                    "temperature": req.temperature, "top_k": req.top_k, "top_p": req.top_p,
                    "stop_token": req.stop_token, "seed": req.seed,
                    "prompt": np.asarray(req.prompt, np.int32).tolist(),
                    "tokens": list(req.tokens), "fill0": req.fill0,
                    "active": bool(self._active[s]),
                } for s, req in enumerate(self._slots) if req is not None]
                device = self._device_host_locked()
                snap = {
                    "layout": "paged" if self._paged else "slot",
                    "n_slots": self.n_slots, "max_len": self.max_len,
                    "windowed": self.windowed,
                    "requests": reqs, "device": device, "next_rid": self._next_rid,
                    "counters": {
                        "n_steps": self._n_steps, "n_tokens": self._n_tokens,
                        "n_spec_rounds": self._n_spec_rounds,
                        "n_spec_accepted": self._n_spec_accepted,
                        "n_spec_columns": self._n_spec_columns,
                    },
                    "done": {rid: list(r.tokens) for rid, r in self._done_pool.items()},
                    "slo": self._slo.snapshot(),
                    "next_prefix": self._next_prefix,
                }
                if self._paged:
                    snap["tables"] = self._tables.copy()
                    snap["n_alloc"] = self._n_alloc.copy()
                    snap["pool"] = self._pool.snapshot()
                    snap["prefixes"] = {pid: (np.asarray(tok).tolist(), list(blks))
                                        for pid, (tok, blks) in self._prefixes.items()}
                else:
                    # the stored K/V (a ring on a windowed batcher): restored
                    # callers keep their prefix ids
                    snap["prefixes"] = {pid: {"kv": _tree_host(kv), "plen": int(plen),
                                              "tokens": np.asarray(tok).tolist()}
                                        for pid, (kv, plen, tok) in self._prefixes.items()}
                return snap

    def _device_host_locked(self) -> Dict[str, Any]:
        """The device state as numpy: the cache (or arena), the per-slot
        buffers and a draft's cache; a mesh's shards joined in slot order."""
        parts = []
        for st, _ in self._slot_states():
            part = {"cache": _tree_host(st._cache),
                    **{name: to_host(getattr(st, "_" + name)) for name in _SLOT_VECTORS}}
            if st._draft is not None:
                part["draft_cache"] = _tree_host(st._draft._cache)
            parts.append(part)
        if len(parts) == 1:
            return parts[0]
        return {k: _tree_cat([p[k] for p in parts], 1 if k.endswith("cache") else 0)
                for k in parts[0]}

    def _restore_pairs(self, dev: Dict[str, Any]) -> List[Tuple[torch.Tensor, np.ndarray]]:
        """(device buffer, host copy) for every device leaf of a snapshot
        (under a mesh, each shard's buffers against their slots' slice),
        each checked for shape and dtype: a mismatch raises before any
        state moves."""
        if len(leaves(self._slot_states()[0][0]._cache)) != len(leaves(dev["cache"])):
            raise ValueError("snapshot geometry mismatch: the cache trees differ "
                             "(int8 against float)")
        if ("draft_cache" in dev) != (self._draft is not None):
            raise ValueError("snapshot geometry mismatch: a draft model on one side only")
        pairs = []
        for st, lo in self._slot_states():
            if self._shards is None:
                rows, cols = slice(None), (slice(None),)
            else:
                rows = slice(lo, lo + st.n)
                cols = (slice(None), rows)
            pairs += [(d, a[cols]) for d, a in zip(leaves(st._cache), leaves(dev["cache"]))]
            pairs += [(getattr(st, "_" + name), dev[name][rows]) for name in _SLOT_VECTORS]
            if st._draft is not None:
                pairs += [(d, a[cols]) for d, a in zip(leaves(st._draft._cache),
                                                       leaves(dev["draft_cache"]))]
        for dst, arr in pairs:
            if tuple(arr.shape) != tuple(dst.shape) or arr.dtype != _host_dtype(dst):
                raise ValueError(
                    f"snapshot geometry mismatch: {arr.dtype} {tuple(arr.shape)} against this "
                    f"batcher's {dst.dtype} {tuple(dst.shape)}"
                )
        return pairs

    def restore(self, snap: Dict[str, Any]) -> None:
        """Load a :meth:`snapshot` into a batcher of the same configuration:
        decoding goes on where the snapshot stopped (the same streams, block
        tables and prefix index). The device state is copied into this
        batcher's own buffers, so programs it captured before replay over
        the restored state. Refused before any state moves: another layout,
        slot count, max_len, window, cache geometry or draft, and, on the
        paged layout, a pool smaller than the snapshot's
        (:class:`~nnstreamer_tpu_torch.kv.blocks.PoolCapacityError`, naming
        what the snapshot could shed to fit). Queued admissions of this
        batcher are dropped: the snapshot's state replaces them."""
        want = "paged" if self._paged else "slot"
        if snap.get("layout") != want:
            raise ValueError(f"snapshot layout {snap.get('layout')!r} does not match this "
                             f"batcher's {want!r}")
        if (snap.get("n_slots") != self.n_slots or snap.get("max_len") != self.max_len
                or bool(snap.get("windowed", False)) != self.windowed):
            raise ValueError("snapshot geometry mismatch")
        if self._paged:
            from nnstreamer_tpu_torch.kv.blocks import PoolCapacityError

            psnap = snap.get("pool", {})
            snap_blocks = int(psnap.get("n_blocks", self._pool.n_blocks))
            if snap_blocks > self._pool.n_blocks:
                refcount = list(psnap.get("refcount", []))
                live = sum(1 for rc in refcount[1:] if rc > 0)
                evictable = ([("cached-block", int(b)) for b in psnap.get("cached", [])]
                             + [("prefix", int(pid), len(blks))
                                for pid, (_tok, blks) in snap.get("prefixes", {}).items()])
                raise PoolCapacityError(
                    f"snapshot was taken with kv_blocks={snap_blocks} ({live} in use) but this "
                    f"batcher has only {self._pool.n_blocks}: restore refused before any state "
                    f"moved; {len(evictable)} evictable candidates (cached prefix blocks / "
                    "registered prefixes) could be shed at the source to fit",
                    needed=snap_blocks, have=self._pool.n_blocks, evictable=evictable,
                )
        from nnstreamer_tpu_torch.models.serving import _Request

        pairs = self._restore_pairs(snap["device"])
        with self._step_lock, self._lock, torch.no_grad():
            for dst, arr in pairs:
                copy_in(dst, arr)
            self._pending = []
            self._slots = [None] * self.n_slots
            self._active = np.zeros((self.n_slots,), bool)
            for d in snap["requests"]:
                req = _Request(int(d["rid"]), int(d["budget"]), temperature=d["temperature"],
                               top_k=d["top_k"], top_p=d["top_p"], stop_token=d["stop_token"],
                               seed=int(d["seed"]), tokens=list(d["tokens"]),
                               fill0=int(d["fill0"]),
                               prompt=np.asarray(d["prompt"], np.int32))
                self._slots[d["slot"]] = req
                self._active[d["slot"]] = bool(d["active"])
            self._next_rid = int(snap["next_rid"])
            c = snap.get("counters", {})
            self._n_steps = int(c.get("n_steps", 0))
            self._n_tokens = int(c.get("n_tokens", 0))
            self._n_spec_rounds = int(c.get("n_spec_rounds", 0))
            self._n_spec_accepted = int(c.get("n_spec_accepted", 0))
            self._n_spec_columns = int(c.get("n_spec_columns", 0))
            self._done_pool = OrderedDict()
            for rid, toks in snap.get("done", {}).items():
                self._done_pool[int(rid)] = _Request(int(rid), 0, tokens=list(toks))
            self._slo.restore(snap.get("slo", {}))
            if self._paged:
                self._prefill_q.clear()
                self._tables = np.asarray(snap["tables"], np.int32).copy()
                self._n_alloc = np.asarray(snap["n_alloc"], np.int32).copy()
                self._tables_dirty = True
                self._pool.restore(snap["pool"])
                self._prefixes = {int(pid): (np.asarray(tok, np.int32), list(blks))
                                  for pid, (tok, blks) in snap.get("prefixes", {}).items()}
            else:
                self._prefixes = {
                    int(pid): (tuple(from_host(a, self.compute_dtype, self.device)
                                     for a in d["kv"]),
                               int(d["plen"]), np.asarray(d["tokens"], np.int32))
                    for pid, d in snap.get("prefixes", {}).items()
                }
            self._next_prefix = int(snap.get("next_prefix", self._next_prefix))
            self._pump_state_dirty = True

    # -- live migration (paged layout) ----------------------------------------
    def _span_leaf_template(self) -> List[Tuple[str, Tuple[int, ...]]]:
        """(dtype name, per-block shape) of each arena leaf in tree order:
        the geometry a span must have to be adopted here."""
        return [(_DTYPE_NAMES[leaf.dtype], (int(leaf.shape[0]),) + tuple(
            int(x) for x in leaf.shape[2:])) for leaf in leaves(self._cache)]

    def extract_request(self, rid: int, remove: bool = True):
        """Serialize request ``rid``'s live state into a
        :class:`~nnstreamer_tpu_torch.kv.migrate.RequestSpan`: the request
        row, the rolling-CRC prefix hashes and each KV block's raw arena
        bytes (an int8 cache ships its quantized payload and scales as they
        are). ``remove=True`` (migration) frees the slot and every block the
        request holds (registered blocks park in the pool's cached tier,
        adoptable by later prompts); ``remove=False`` is the checkpoint's
        read, which changes nothing. Only an actively decoding request has a
        span: :class:`~nnstreamer_tpu_torch.kv.migrate.SpanStateError`
        otherwise, and on the slot layout."""
        from nnstreamer_tpu_torch.kv.blocks import roll_hash
        from nnstreamer_tpu_torch.kv.migrate import (
            BlockRecord,
            RequestSpan,
            SpanStateError,
            block_crc,
        )

        if not self._paged:
            raise SpanStateError("request migration needs kv_layout='paged'")
        self._check_failed()
        with self._step_lock:
            self._settle_pending()
            with self._lock:
                slot = next((s for s, r in enumerate(self._slots)
                             if r is not None and r.rid == rid), None)
                if slot is None or not self._active[slot]:
                    raise SpanStateError(
                        f"request {rid} is not extractable: only an actively decoding request "
                        "has a KV span (settle the prefill queue first — queued/prefilling "
                        "requests re-submit, they do not migrate)"
                    )
                req = self._slots[slot]
                bs = self.block_size
                n_kv = req.fill0 + len(req.tokens) - 1
                n_blocks = -(-n_kv // bs)
                blocks = self._tables[slot, :n_blocks].tolist()
                stream = np.concatenate([np.asarray(req.prompt, np.int32),
                                         np.asarray(req.tokens, np.int32)])[:n_kv]
                ids = torch.as_tensor(blocks, dtype=torch.int64, device=self.device)
                # one gather a leaf: the resident bytes
                raw = [to_host(leaf[:, ids]) for leaf in leaves(self._cache)]
                records, hashes, h = [], [], 0
                for i in range(n_blocks):
                    n_tok = min(bs, n_kv - i * bs)
                    payload = [np.ascontiguousarray(r[:, i]).tobytes() for r in raw]
                    records.append(BlockRecord(n_tok, block_crc(payload), payload))
                    if n_tok == bs:
                        h = roll_hash(h, stream[i * bs:(i + 1) * bs])
                        hashes.append(h)
                # the deadline travels as what is left of it
                rec = self._slo.record(rid)
                deadline = None
                if rec is not None and rec.deadline_s is not None:
                    deadline = rec.deadline_s - (time.perf_counter() - rec.t_submit)
                span = RequestSpan(
                    block_size=bs, leaves=self._span_leaf_template(),
                    cache_dtype=("int8" if self.cache_dtype == "int8"
                                 else _DTYPE_NAMES[self.compute_dtype]),
                    rid=rid, prompt=np.asarray(req.prompt, np.int32).copy(),
                    tokens=list(req.tokens), fill0=int(req.fill0), budget=int(req.budget),
                    temperature=float(req.temperature), top_k=int(req.top_k),
                    top_p=float(req.top_p), stop_token=req.stop_token,
                    key=seed_words(req.seed), deadline_s=deadline,
                    preemptions=rec.preemptions if rec is not None else 0,
                    prefix_hashes=hashes, blocks=records,
                )
                if remove:
                    # every block the request holds, the decode room allocated
                    # ahead of its fill included
                    self._release_blocks_locked(slot)
                    self._active[slot] = False
                    self._pump_state_dirty = True
                    self._slots[slot] = None
                    self._slo.migrated(rid)
                    self._n_migrations_out += 1
                    self._obs_counter("nns_kv_migrations_total", direction="out")
        return span

    def _span_request(self, span):
        """A new request (the next rid) carrying a span's row, and its SLO
        record with the span's deadline and preemptions (caller holds
        _lock)."""
        from nnstreamer_tpu_torch.models.serving import _Request

        rid = self._next_rid
        self._next_rid += 1
        rec = self._slo.submit(rid, span.deadline_s)
        rec.preemptions = int(span.preemptions)
        return _Request(rid, int(span.budget), temperature=float(span.temperature),
                        top_k=int(span.top_k), top_p=float(span.top_p),
                        stop_token=span.stop_token, seed=seed_of_words(span.key),
                        tokens=list(span.tokens), fill0=int(span.fill0),
                        prompt=np.asarray(span.prompt, np.int32))

    def _span_fits(self, span) -> None:
        from nnstreamer_tpu_torch.kv.migrate import SpanCapacityError, SpanFormatError

        if not self._paged:
            raise SpanFormatError("request migration needs kv_layout='paged'")
        self._check_failed()
        if span.fill0 + span.budget > self.max_len:
            raise SpanCapacityError(f"span needs fill0+budget={span.fill0 + span.budget} "
                                    f"positions but max_len={self.max_len}")

    def adopt_request(self, span) -> int:
        """Land a peer's :class:`~nnstreamer_tpu_torch.kv.migrate.RequestSpan`
        here and continue decoding it: full blocks the prefix index already
        holds are shared by refcount (the warm path; a stripped payload they
        do not cover raises ``SpanPayloadMissingError``), the rest land
        their raw payloads into fresh blocks, and the request re-enters
        through the resumed admission with its pending token known, so a
        greedy continuation is the source's stream bit for bit. → the new
        local rid. Refusals (``SpanFormatError``: another block size or
        arena geometry; ``SpanCapacityError``: no slot, no blocks, or
        fill0 + budget past max_len) leave the batcher as it was; nothing
        re-prefills."""
        from nnstreamer_tpu_torch.kv.blocks import NoBlocksError
        from nnstreamer_tpu_torch.kv.migrate import (
            SpanCapacityError,
            SpanFormatError,
            SpanPayloadMissingError,
        )
        from nnstreamer_tpu_torch.models.serving import _PendingInsert

        if self._paged and span.block_size != self.block_size:
            raise SpanFormatError(f"KV span block_size {span.block_size} != this batcher's "
                                  f"{self.block_size}")
        if self._paged and list(span.leaves) != self._span_leaf_template():
            raise SpanFormatError(
                "KV span arena geometry mismatch (layers/heads/dims or cache dtype differ — "
                "migrate between identically configured batchers)"
            )
        self._span_fits(span)
        bs = self.block_size
        n_kv = span.n_kv
        n_blocks = -(-n_kv // bs)
        stream = span.kv_tokens
        cache_leaves = leaves(self._cache)
        with self._step_lock:
            self._settle_pending()
            with self._lock:
                slot = next((i for i, r in enumerate(self._slots) if r is None), None)
                if slot is None:
                    raise SpanCapacityError(f"no free slot ({self.n_slots} occupied)")
                m = self._pool.match(stream)
                n_shared = min(len(m.full), n_blocks)
                shared = list(m.full[:n_shared])
                for i, rec in enumerate(span.blocks):
                    if rec.payload is None and i >= n_shared:
                        raise SpanPayloadMissingError(
                            f"block {i} was stripped by the sender but this pool's prefix "
                            "index does not cover it"
                        )
                # every shipped payload decoded on the host before a block
                # is taken or the arena written: a malformed one changes
                # nothing
                per_leaf = [np.stack([
                    np.frombuffer(span.blocks[i].payload[j], dtype=_host_dtype(leaf)).reshape(sh)
                    for i in range(n_shared, n_blocks)], axis=1) if n_blocks > n_shared else None
                    for j, ((_dt, sh), leaf) in enumerate(zip(span.leaves, cache_leaves))]
                # the shared blocks first, so the allocation cannot reclaim
                # them from the cached tier
                hits0 = self._pool.prefix_hits
                for b in shared:
                    self._pool.adopt(b)
                try:
                    fresh = self._pool.alloc(n_blocks - n_shared) if n_blocks > n_shared else []
                except NoBlocksError:
                    self._pool.free(shared)
                    self._pool.prefix_hits = hits0
                    raise SpanCapacityError(
                        f"pool cannot host the span: needs {n_blocks - n_shared} fresh blocks, "
                        f"{self._pool.available()} available"
                    ) from None
                if n_shared:
                    self._pool.record_hit_tokens(n_shared * bs)
                req = self._span_request(span)
                self._slots[slot] = req
            blocks = shared + fresh
            if fresh:
                try:
                    ids = torch.as_tensor(fresh, dtype=torch.int64, device=self.device)
                    with torch.no_grad():
                        for leaf, vals in zip(cache_leaves, per_leaf):
                            leaf[:, ids] = from_host(vals, leaf.dtype, self.device)
                except Exception as exc:  # the arena was written in place
                    self._mark_failed(exc)
                    raise
            with self._lock:
                self._pool.register(stream, blocks)
                self._pending.append(_PendingInsert(
                    slot, None, None, int(span.tokens[-1]), n_kv, req, blocks=blocks,
                    resumed=True, hist_row=self._hist_row(stream),
                ))
                self._n_migrations_in += 1
            self._settle_pending()
        self._obs_counter("nns_kv_migrations_total", direction="in")
        return req.rid

    def resume_from_span(self, span) -> int:
        """Re-admit a span's request from its tokens alone (the fallback
        when no peer adopts it): the prefix index supplies whatever K/V
        survived in the cached tier, chunked prefill recomputes the rest,
        and the pending token is carried, so the continued stream is the
        original. → the new rid. Raises ``SpanCapacityError`` (no slot,
        or fill0 + budget past max_len) having changed nothing."""
        from nnstreamer_tpu_torch.kv.migrate import SpanCapacityError
        from nnstreamer_tpu_torch.kv.sched import PrefillJob

        self._span_fits(span)
        with self._lock:
            slot = next((i for i, r in enumerate(self._slots) if r is None), None)
            if slot is None:
                raise SpanCapacityError(f"no free slot ({self.n_slots} occupied)")
            req = self._span_request(span)
            self._slots[slot] = req
            context = np.asarray(span.prompt, np.int32)
            if len(span.tokens) > 1:
                context = np.concatenate([context, np.asarray(span.tokens[:-1], np.int32)])
            self._prefill_q.append(PrefillJob(slot, req, context,
                                              known_first=int(span.tokens[-1]), resumed=True))
            self._n_resumes += 1
        self._obs_counter("nns_request_resumes_total", kind="reprefill")
        return req.rid
