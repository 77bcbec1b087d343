"""Live KV-span serialization: one request's paged cache state on the wire.

The counterpart of ``nnstreamer_tpu/kv/migrate.py``, byte for byte on the
wire: a span encoded by either package decodes in the other. A
:class:`RequestSpan` is what a second paged ``ContinuousBatcher`` needs to
continue a generation mid-decode where the source left off:

- the request row: prompt, generated tokens, sampling settings, ``fill0``
  and ``key``, uint32 [2]. The port writes the request's seed there in
  ``jax.random.PRNGKey``'s layout ``[seed >> 32, seed & 0xFFFFFFFF]`` and
  reads it back as the seed its sampler keys by, so greedy continuations
  are exact across packages and sampled ones distribution-exact;
- each block's raw arena bytes, one payload per arena leaf, CRC32-checked:
  an int8 cache ships its quantized payload and scales verbatim, which
  keeps an int8 migration bitwise;
- the rolling-CRC prefix hashes at every full block boundary
  (``kv/blocks.roll_hash``), so a destination can say which prefix blocks
  it holds and the source can strip those payloads
  (:meth:`RequestSpan.strip_shared`): a warm migration ships only the
  unshared suffix;
- the remaining deadline and the preemption count (the port's batcher
  writes None and 0: its SLO ledger comes with the observability slice).

Wire format: ``NNSSPAN1``, a uint32 length, a JSON header (geometry,
request row, per-block CRC records), then the raw leaf bytes of every
block not stripped. Encoded and decoded bytes are counted in :data:`tally`
(the reference also feeds an obs counter, which comes with the
observability slice).
"""

from __future__ import annotations

import json
import struct
import threading
import zlib
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

SPAN_VERSION = 1
_MAGIC = b"NNSSPAN1"
_LEN = struct.Struct("<I")


class SpanError(RuntimeError):
    """Base of the migration failure taxonomy — every refusal a peer or
    codec can produce is a subclass, so callers catch one type and fall
    back to re-prefill (``resume_from_span``)."""


class SpanFormatError(SpanError):
    """Malformed span bytes, or a geometry mismatch between the span and
    the adopting batcher (block size, arena leaf shapes, cache dtype)."""


class SpanCorruptError(SpanError):
    """A block payload failed its CRC32 — the span must not be adopted
    (a corrupt block would silently poison the continued generation)."""


class SpanPayloadMissingError(SpanError):
    """A stripped block's K/V is not covered by the destination's prefix
    index — the sender stripped more than the receiver shares."""


class SpanStateError(SpanError):
    """The request is not in an extractable state (unknown rid, still
    queued/prefilling — settle the prefill queue first, or finished)."""


class SpanCapacityError(SpanError):
    """The destination cannot host the span right now: no free slot, no
    free blocks, or the span would overflow ``max_len``. Retryable —
    the source keeps the request and falls back to local resume."""


class SpanTally:
    """Process-local byte accounting for encoded and decoded spans, so a
    warm migration and a cold one compare in bytes. Thread-safe; the
    module-global :data:`tally` is shared by every batcher in the
    process."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counts = {"out": 0, "in": 0}
        self._bytes = {"out": 0, "in": 0}

    def count(self, direction: str, nbytes: int) -> None:
        with self._lock:
            self._counts[direction] += 1
            self._bytes[direction] += int(nbytes)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {
                "spans_out": self._counts["out"],
                "spans_in": self._counts["in"],
                "bytes_out": self._bytes["out"],
                "bytes_in": self._bytes["in"],
            }

    def reset(self) -> None:
        with self._lock:
            self._counts = {"out": 0, "in": 0}
            self._bytes = {"out": 0, "in": 0}


tally = SpanTally()


def _emit_span_bytes(direction: str, nbytes: int) -> None:
    """Mirror a span encode / decode into the metrics registry (resolved
    an event: migrations are rare control-plane work, not a hot path)."""
    from nnstreamer_tpu_torch.obs import metrics as obs_metrics

    reg = obs_metrics.get()
    if reg is not None:
        reg.counter("nns_kv_span_bytes_total", direction=direction).inc(int(nbytes))


@dataclass
class BlockRecord:
    """One KV block of a span: ``n_tokens`` valid positions, the CRC32
    of its raw leaf bytes, and the payload itself — one ``bytes`` per
    arena leaf, or None when stripped (the destination's prefix index
    already holds this block's content)."""

    n_tokens: int
    crc: int
    payload: Optional[List[bytes]] = None


@dataclass
class RequestSpan:
    """A single request's migratable state (see module docstring)."""

    block_size: int
    # per-block leaf templates: (dtype name, per-block shape) for each
    # arena leaf in jax tree-leaves order — fp caches carry 2 leaves
    # (k, v), int8 caches 4 (k8, k_scale, v8, v_scale)
    leaves: List[Tuple[str, Tuple[int, ...]]]
    cache_dtype: str
    rid: int
    prompt: np.ndarray
    tokens: List[int]
    fill0: int
    budget: int
    temperature: float
    top_k: int
    top_p: float
    stop_token: Optional[int]
    key: np.ndarray  # base PRNG key, uint32 [2]
    deadline_s: Optional[float]  # REMAINING deadline at extraction
    preemptions: int
    prefix_hashes: List[int]  # rolling CRC at each full block boundary
    blocks: List[BlockRecord]
    meta: Dict[str, Any] = field(default_factory=dict)
    version: int = SPAN_VERSION

    @property
    def n_kv(self) -> int:
        """Positions with K/V on the source: the pending token
        ``tokens[-1]`` has not been written yet (the batcher invariant
        ``pos = fill0 + len(tokens) - 1``)."""
        return self.fill0 + len(self.tokens) - 1

    @property
    def kv_tokens(self) -> np.ndarray:
        """The token stream covered by K/V (prompt + generated, minus
        the pending token) — what the destination matches against its
        prefix index and registers after adoption."""
        stream = np.concatenate([
            np.asarray(self.prompt, np.int32),
            np.asarray(self.tokens, np.int32),
        ])
        return stream[: self.n_kv]

    def payload_bytes(self) -> int:
        """Raw K/V bytes this span would ship (stripped blocks cost 0)."""
        return sum(
            sum(len(b) for b in rec.payload)
            for rec in self.blocks if rec.payload is not None
        )

    def strip_shared(self, n_shared_tokens: int) -> "RequestSpan":
        """A copy with payloads dropped for every FULL block entirely
        covered by the destination's ``probe_prefix`` answer — the warm-
        migration diet. CRCs and hashes stay, so the receiver still
        verifies what it adopts locally. Partial blocks never strip:
        the destination shares full blocks only (no CoW over the wire)."""
        bs = self.block_size
        out = []
        for i, rec in enumerate(self.blocks):
            covered = (i + 1) * bs <= int(n_shared_tokens)
            if covered and rec.n_tokens == bs:
                out.append(BlockRecord(rec.n_tokens, rec.crc, None))
            else:
                out.append(rec)
        return replace(self, blocks=out)


def _leaf_nbytes(dtype: str, shape: Tuple[int, ...]) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n * np.dtype(dtype).itemsize


def block_crc(payload: List[bytes]) -> int:
    """CRC32 over a block's concatenated leaf bytes."""
    crc = 0
    for part in payload:
        crc = zlib.crc32(part, crc)
    return crc & 0xFFFFFFFF


def encode_span(span: RequestSpan) -> bytes:
    """Span → wire bytes (magic + JSON header + raw block payloads)."""
    header = {
        "version": span.version,
        "block_size": span.block_size,
        "leaves": [[dt, list(sh)] for dt, sh in span.leaves],
        "cache_dtype": span.cache_dtype,
        "rid": span.rid,
        "prompt": np.asarray(span.prompt, np.int32).tolist(),
        "tokens": [int(t) for t in span.tokens],
        "fill0": span.fill0,
        "budget": span.budget,
        "temperature": span.temperature,
        "top_k": span.top_k,
        "top_p": span.top_p,
        "stop_token": span.stop_token,
        "key": np.asarray(span.key, np.uint32).tolist(),
        "deadline_s": span.deadline_s,
        "preemptions": span.preemptions,
        "prefix_hashes": [int(h) for h in span.prefix_hashes],
        "meta": span.meta,
        "blocks": [
            {
                "n": rec.n_tokens,
                "crc": rec.crc,
                "stripped": rec.payload is None,
            }
            for rec in span.blocks
        ],
    }
    enc = json.dumps(header, separators=(",", ":")).encode()
    parts = [_MAGIC, _LEN.pack(len(enc)), enc]
    for rec in span.blocks:
        if rec.payload is not None:
            parts.extend(rec.payload)
    out = b"".join(parts)
    tally.count("out", len(out))
    _emit_span_bytes("out", len(out))
    return out


def decode_span(data: bytes) -> RequestSpan:
    """Wire bytes → span, CRC-verifying every shipped block. Raises
    :class:`SpanFormatError` on malformed input, :class:`SpanCorruptError`
    on a payload whose CRC32 does not match its header record."""
    if len(data) < len(_MAGIC) + _LEN.size or not data.startswith(_MAGIC):
        raise SpanFormatError("not a KV span (bad magic)")
    off = len(_MAGIC)
    (hlen,) = _LEN.unpack_from(data, off)
    off += _LEN.size
    if len(data) < off + hlen:
        raise SpanFormatError("KV span header truncated")
    try:
        h = json.loads(data[off: off + hlen])
    except (UnicodeDecodeError, json.JSONDecodeError) as exc:
        raise SpanFormatError(f"KV span header not valid JSON: {exc}") \
            from exc
    off += hlen
    if int(h.get("version", 0)) != SPAN_VERSION:
        raise SpanFormatError(
            f"unsupported KV span version {h.get('version')!r}"
        )
    leaves = [(str(dt), tuple(int(d) for d in sh))
              for dt, sh in h["leaves"]]
    lens = [_leaf_nbytes(dt, sh) for dt, sh in leaves]
    records: List[BlockRecord] = []
    for rec in h["blocks"]:
        if rec["stripped"]:
            records.append(BlockRecord(int(rec["n"]), int(rec["crc"])))
            continue
        payload = []
        for n in lens:
            if len(data) < off + n:
                raise SpanFormatError("KV span payload truncated")
            payload.append(data[off: off + n])
            off += n
        got = block_crc(payload)
        if got != int(rec["crc"]):
            raise SpanCorruptError(
                f"KV block payload CRC mismatch: block {len(records)} "
                f"expected {int(rec['crc']):#010x} got {got:#010x}"
            )
        records.append(BlockRecord(int(rec["n"]), int(rec["crc"]), payload))
    if off != len(data):
        raise SpanFormatError(
            f"KV span has {len(data) - off} trailing bytes"
        )
    span = RequestSpan(
        block_size=int(h["block_size"]),
        leaves=leaves,
        cache_dtype=str(h["cache_dtype"]),
        rid=int(h["rid"]),
        prompt=np.asarray(h["prompt"], np.int32),
        tokens=[int(t) for t in h["tokens"]],
        fill0=int(h["fill0"]),
        budget=int(h["budget"]),
        temperature=float(h["temperature"]),
        top_k=int(h["top_k"]),
        top_p=float(h["top_p"]),
        stop_token=(None if h["stop_token"] is None
                    else int(h["stop_token"])),
        key=np.asarray(h["key"], np.uint32),
        deadline_s=(None if h["deadline_s"] is None
                    else float(h["deadline_s"])),
        preemptions=int(h["preemptions"]),
        prefix_hashes=[int(x) for x in h["prefix_hashes"]],
        blocks=records,
        meta=dict(h.get("meta", {})),
    )
    if not span.tokens:
        raise SpanFormatError("KV span has no generated tokens")
    if len(span.blocks) != -(-span.n_kv // span.block_size):
        raise SpanFormatError(
            f"KV span block count {len(span.blocks)} does not cover "
            f"{span.n_kv} positions at block_size {span.block_size}"
        )
    tally.count("in", len(data))
    _emit_span_bytes("in", len(data))
    return span
