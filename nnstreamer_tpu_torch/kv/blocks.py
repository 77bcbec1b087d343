"""BlockPool: ref-counted fixed-size KV blocks in one device arena.

The counterpart of ``nnstreamer_tpu/kv/blocks.py``, with the same
semantics: the same sequence of operations gives the same block ids,
matches and stats as the reference pool. It is host bookkeeping only; the
device ops (block landing, staging, copy-on-write) live in
:mod:`nnstreamer_tpu_torch.kv.gather`.

The paged layout stores every request's K/V in ``block_size``-token blocks
of a single arena per layer, ``[L, n_blocks+1, block_size, KV, Dh]``.
Block 0 is a reserved scratch block: unallocated block-table entries and
inactive write lanes point at it, so reads stay fixed-shape and writes
need no branch.

Per block the pool tracks a reference count (how many live requests map
it), whether it is registered in the **prefix index**, and two reclaim
tiers: ``free`` (unreferenced, unindexed) and ``cached`` (unreferenced
but still indexed, so a later request with the same prompt prefix can
still adopt its content; reclaimed least recently used first — vLLM's
automatic prefix caching).

Prefix sharing: every admitted prompt registers its block-aligned
prefixes under a rolling hash (CRC32 chained block by block, token
content stored for collision-proof verification). A later request whose
prompt starts with the same tokens adopts the matched physical blocks:
full blocks by refcount (read-only share), a final partial block by
**copy-on-write** (:meth:`BlockPool.cow`): the adopter gets a fresh
private copy it may extend, the registered original stays as it was.

With an ``obs_registry`` (obs/metrics.py) the pool sets the
``nns_kv_blocks_in_use`` gauge on every claim and release and counts
``nns_kv_prefix_hits_total``, as the reference's does. Callers (the
batcher) serialize access under their own state lock.
"""

from __future__ import annotations

import zlib
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


class NoBlocksError(RuntimeError):
    """The pool has no free or reclaimable block left. The batcher's
    answer is preemption by eviction (free a victim request's blocks and
    re-prefill it later from whatever prefix survived), never an OOM."""


class PoolCapacityError(ValueError):
    """A snapshot needs more blocks than this pool has (``kv_blocks``
    shrank across a restart). Raised before any state changes;
    ``evictable`` names what the snapshot could shed to fit."""

    def __init__(self, msg: str, needed: int, have: int, evictable=None) -> None:
        super().__init__(msg)
        self.needed = int(needed)
        self.have = int(have)
        self.evictable = list(evictable or [])


def roll_hash(prev: int, tokens: np.ndarray) -> int:
    """Rolling block hash: CRC32 of the block's int32 token bytes chained
    on the previous boundary's hash. Verified against the stored tokens
    on every match, so a collision can never adopt wrong K/V."""
    return zlib.crc32(np.ascontiguousarray(tokens, np.int32).tobytes(), prev & 0xFFFFFFFF)


@dataclass
class _IndexEntry:
    """One registered prefix boundary: ``block`` holds the K/V of
    ``tokens`` (len ≤ block_size; shorter marks a partial entry,
    adoptable only by copy-on-write)."""

    block: int
    tokens: np.ndarray
    parent: int  # rolling hash at the previous boundary
    partial: bool = False


@dataclass
class _Match:
    """Longest indexed prefix of a prompt: ``full`` blocks adoptable by
    refcount, plus an optional partial boundary block (copy-on-write)."""

    n_tokens: int = 0
    full: List[int] = field(default_factory=list)
    partial_block: Optional[int] = None
    n_partial: int = 0


class BlockPool:
    """Host accounting for ``n_blocks`` usable blocks (+ scratch 0)."""

    def __init__(self, n_blocks: int, block_size: int, obs_registry=None):
        if n_blocks < 1:
            raise ValueError("BlockPool needs at least one usable block")
        self.n_blocks = int(n_blocks)
        self.block_size = int(block_size)
        # block ids 1..n_blocks are usable; 0 is the scratch block
        self._refcount = np.zeros(self.n_blocks + 1, np.int32)
        self._free: deque = deque(range(1, self.n_blocks + 1))
        # refcount-0 blocks still serving the prefix index, oldest first
        self._cached: "OrderedDict[int, None]" = OrderedDict()
        self._index: Dict[int, _IndexEntry] = {}
        self._partials: Dict[int, List[int]] = {}  # parent hash → hashes
        self._block_hashes: Dict[int, List[int]] = {}  # block → its keys
        self.prefix_hits = 0  # blocks adopted instead of re-prefilled
        self.prefix_hit_tokens = 0
        self.cow_copies = 0
        self._obs = obs_registry

    # -- capacity ----------------------------------------------------------
    def available(self) -> int:
        """Blocks allocatable right now (free + reclaimable cached)."""
        return len(self._free) + len(self._cached)

    def in_use(self) -> int:
        return self.n_blocks - self.available()

    def _emit_in_use(self) -> None:
        if self._obs is not None:
            self._obs.gauge("nns_kv_blocks_in_use").set(float(self.in_use()))

    # -- alloc / free ------------------------------------------------------
    def alloc(self, n: int = 1) -> List[int]:
        """Claim ``n`` blocks (refcount 1 each), reclaiming cached prefix
        blocks oldest first when the free list runs dry. All or nothing:
        raises :class:`NoBlocksError` having claimed nothing."""
        got: List[int] = []
        try:
            for _ in range(int(n)):
                if self._free:
                    b = self._free.popleft()
                elif self._cached:
                    b, _ = self._cached.popitem(last=False)
                    self._unindex_block(b)
                else:
                    raise NoBlocksError(
                        f"kv pool exhausted: {self.n_blocks} blocks all "
                        "referenced (preempt a request or grow kv_blocks)"
                    )
                self._refcount[b] = 1
                got.append(b)
        except NoBlocksError:
            for b in got:
                self._refcount[b] = 0
                self._free.appendleft(b)
            raise
        self._emit_in_use()
        return got

    def adopt(self, block: int) -> None:
        """Share an indexed block read-only (a prefix hit): bump its
        refcount, pulling it out of the cached tier if idle."""
        if self._refcount[block] == 0:
            self._cached.pop(block, None)
        self._refcount[block] += 1
        self.prefix_hits += 1
        if self._obs is not None:
            self._obs.counter("nns_kv_prefix_hits_total").inc()
        self._emit_in_use()

    def free(self, blocks) -> None:
        """Drop one reference per block; refcount-0 blocks return to the
        free list, or to the cached tier while the prefix index still maps
        them (their content stays adoptable)."""
        for b in blocks:
            if b == 0:
                continue  # scratch is never owned
            if self._refcount[b] <= 0:
                raise ValueError(f"double free of kv block {b}")
            self._refcount[b] -= 1
            if self._refcount[b] == 0:
                if self._block_hashes.get(b):
                    self._cached[b] = None
                    self._cached.move_to_end(b)
                else:
                    self._free.append(b)
        self._emit_in_use()

    def cow(self) -> int:
        """Claim a fresh block for a copy-on-write of a shared partial
        block (the device copy itself is the caller's), counted."""
        (b,) = self.alloc(1)
        self.note_cow()
        return b

    def note_cow(self) -> None:
        """Count a copy-on-write whose block came from a bulk alloc."""
        self.cow_copies += 1

    # -- prefix index ------------------------------------------------------
    def _unindex_block(self, block: int) -> None:
        for h in self._block_hashes.pop(block, []):
            e = self._index.pop(h, None)
            if e is not None and e.partial:
                sibs = self._partials.get(e.parent)
                if sibs is not None:
                    if h in sibs:
                        sibs.remove(h)
                    if not sibs:
                        self._partials.pop(e.parent, None)

    def register(self, tokens: np.ndarray, blocks: List[int]) -> None:
        """Index a prompt's blocks under their rolling prefix hashes: one
        entry per full block boundary (read-only shareable) plus one for
        the trailing partial block, if any (copy-on-write shareable).
        Boundaries already indexed (the matched prefix) are skipped."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        bs = self.block_size
        h = 0
        for i, b in enumerate(blocks):
            chunk = tokens[i * bs: (i + 1) * bs]
            if chunk.size == 0:
                break
            nh = roll_hash(h, chunk)
            partial = chunk.size < bs
            e = self._index.get(nh)
            if e is not None and not np.array_equal(e.tokens, chunk):
                # a hash collision: keep the incumbent (match() verifies
                # token content) and stop chaining — deeper entries would
                # be unreachable through the broken link
                break
            if e is None:
                self._index[nh] = _IndexEntry(b, chunk.copy(), h, partial)
                self._block_hashes.setdefault(b, []).append(nh)
                if partial:
                    self._partials.setdefault(h, []).append(nh)
            if partial:
                break
            h = nh

    def match(self, tokens: np.ndarray) -> _Match:
        """Longest registered prefix of ``tokens``: walks the rolling hash
        block by block verifying token content, then tries the partial
        entries hanging off the last matched boundary. Takes no
        references: callers adopt() what they decide to use."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        bs = self.block_size
        m = _Match()
        h = 0
        i = 0
        while (i + 1) * bs <= tokens.shape[0]:
            chunk = tokens[i * bs: (i + 1) * bs]
            nh = roll_hash(h, chunk)
            e = self._index.get(nh)
            if e is None or e.partial or not np.array_equal(e.tokens, chunk):
                break
            m.full.append(e.block)
            m.n_tokens += bs
            h = nh
            i += 1
        best: Optional[_IndexEntry] = None
        rest = tokens[m.n_tokens:]
        for ph in self._partials.get(h, []):
            e = self._index.get(ph)
            if e is None:
                continue
            n = e.tokens.shape[0]
            if n <= rest.shape[0] and np.array_equal(e.tokens, rest[:n]):
                if best is None or n > best.tokens.shape[0]:
                    best = e
        if best is not None:
            m.partial_block = best.block
            m.n_partial = best.tokens.shape[0]
            m.n_tokens += m.n_partial
        return m

    def record_hit_tokens(self, n: int) -> None:
        self.prefix_hit_tokens += int(n)

    # -- snapshot / restore ------------------------------------------------
    def snapshot(self) -> dict:
        return {
            "n_blocks": self.n_blocks,
            "block_size": self.block_size,
            "refcount": self._refcount.tolist(),
            "free": list(self._free),
            "cached": list(self._cached),
            "index": [
                {"hash": h, "block": e.block, "tokens": e.tokens.tolist(),
                 "parent": e.parent, "partial": e.partial}
                for h, e in self._index.items()
            ],
            "prefix_hits": self.prefix_hits,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "cow_copies": self.cow_copies,
        }

    def restore(self, snap: dict) -> None:
        if snap["n_blocks"] != self.n_blocks or snap["block_size"] != self.block_size:
            raise ValueError(
                "kv pool snapshot shape mismatch: snapshot "
                f"{snap['n_blocks']}x{snap['block_size']} vs pool "
                f"{self.n_blocks}x{self.block_size}"
            )
        self._refcount = np.asarray(snap["refcount"], np.int32).copy()
        self._free = deque(snap["free"])
        self._cached = OrderedDict((b, None) for b in snap["cached"])
        self._index = {}
        self._partials = {}
        self._block_hashes = {}
        for d in snap["index"]:
            e = _IndexEntry(int(d["block"]), np.asarray(d["tokens"], np.int32),
                            int(d["parent"]), bool(d["partial"]))
            self._index[int(d["hash"])] = e
            self._block_hashes.setdefault(e.block, []).append(int(d["hash"]))
            if e.partial:
                self._partials.setdefault(e.parent, []).append(int(d["hash"]))
        self.prefix_hits = int(snap.get("prefix_hits", 0))
        self.prefix_hit_tokens = int(snap.get("prefix_hit_tokens", 0))
        self.cow_copies = int(snap.get("cow_copies", 0))
        self._emit_in_use()

    def stats(self) -> Dict[str, int]:
        return {
            "kv_blocks": self.n_blocks,
            "kv_blocks_in_use": self.in_use(),
            "kv_blocks_free": len(self._free),
            "kv_blocks_cached": len(self._cached),
            "kv_prefix_hits": self.prefix_hits,
            "kv_prefix_hit_tokens": self.prefix_hit_tokens,
            "kv_cow_copies": self.cow_copies,
        }
