"""Disaggregated prefill/decode LLM serving (docs/llm-serving.md
"Disaggregated serving").

The counterpart of ``nnstreamer_tpu/serving_plane/disagg.py``, on the
port's span codec and edge layer; its stats add the shipped spans' bytes
and the seconds of their extraction and of the wire.

Production serving splits compute-bound prefill from latency-bound
decode onto separate workers. Everything the split needs exists
already — the :class:`~nnstreamer_tpu_torch.kv.migrate.
RequestSpan` codec with ``strip_shared``, ``extract_request`` /
``adopt_request`` with bitwise-identical continued decode, and the
``KIND_CTRL`` migration handshake — this module composes them into
ROLES:

- ``tensor_llm_serversink role=prefill decode-peers=h1:p1,h2:p2`` runs
  chunked prefill only. The moment a request turns extractable (prefill
  finalized, first token pending), :class:`DisaggController` extracts
  its KV span, probes each decode peer (one roundtrip answers both
  "how warm" — shared prefix depth — and "how full" — the pool-headroom
  advert), ``strip_shared``s against the winner's coverage, and ships
  the span over the existing CTRL channel. The decode peer adopts it
  straight into its arena: **zero re-prefill** (its
  ``kv_prefill_chunks`` counter stays flat — the acceptance pin).
- ``role=decode`` advertises pool headroom + prefix depth in its probe
  replies, refuses over capacity with a typed retry-after NACK
  (:class:`~nnstreamer_tpu_torch.kv.blocks.PoolCapacityError` taxonomy on the
  wire), and segregates finished handoff generations for the prefill
  side to collect over ``disagg_fetch`` — the DECODE server never
  delivers to the client, so the client's ``frame_id`` dedup sees exactly
  one DELIVER whatever the client retried mid-handoff.

Failure ladder (tokens are never lost):

1. peer refuses/unreachable at handoff → the span re-enters the LOCAL
   arena via ``adopt_request`` (same bytes, zero re-prefill), decode
   continues in place (outcome ``local``);
2. local adopt refused too (races with capacity) → ``resume_from_span``
   re-prefill (the cold fallback);
3. a handed-off generation's peer forgets the rid or stays unreachable
   past the fetch budget → the request re-submits locally from its
   prompt (outcome ``recovered`` — cold, but terminal).

Role placement follows Hermes (PAPERS.md: memory-bounded pipeline
placement across edge devices); span shipping follows StreamTensor
(PAPERS.md: stream tensors between dataflow stages instead of
round-tripping through a host).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.obs import metrics as obs_metrics

_log = get_logger("serving_plane.disagg")


def parse_decode_peers(spec: str,
                       default_llm_id: int = 0) -> List[Tuple[str, int, int]]:
    """``"h1:p1[/llm-id],h2:p2"`` → ``[(host, port, llm_id), ...]`` —
    the ``decode-peers`` property grammar (the ``migrate-to`` target
    grammar, pluralized). Raises ValueError on malformed entries or
    duplicates so the serversink constructor fails loudly."""
    out: List[Tuple[str, int, int]] = []
    seen = set()
    for raw in str(spec).split(","):
        raw = raw.strip()
        if not raw:
            continue
        base, sep, suffix = raw.partition("/")
        llm_id = default_llm_id
        if sep:
            if not suffix.isdigit():
                raise ValueError(
                    f"decode-peers entry {raw!r}: llm-id suffix must be "
                    "an integer"
                )
            llm_id = int(suffix)
        host, _, port_s = base.rpartition(":")
        if not host or not port_s.isdigit() or int(port_s) <= 0:
            raise ValueError(
                f"decode-peers entry {raw!r} is not host:port[/llm-id]"
            )
        key = (host, int(port_s))
        if key in seen:
            raise ValueError(f"decode-peers entry {raw!r} is listed twice")
        seen.add(key)
        out.append((host, int(port_s), llm_id))
    if not out:
        raise ValueError(f"decode-peers={spec!r} names no peers")
    return out


class _Peer:
    """One decode-role target plus its refusal bookkeeping: a peer that
    NACKed or dropped the connection is benched for its retry-after
    hint (or a short default) so a full pool is not hammered every
    pump."""

    __slots__ = ("host", "port", "llm_id", "bench_until", "handoffs",
                 "refusals")

    def __init__(self, host: str, port: int, llm_id: int) -> None:
        self.host = host
        self.port = port
        self.llm_id = llm_id
        self.bench_until = 0.0
        self.handoffs = 0
        self.refusals = 0

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.port}"


class _Handoff:
    """Ledger entry for one generation decoding on a peer: the frame
    meta the prefill server must emit it under (``frame_id``!), plus
    enough of the original request to resubmit locally if the peer
    loses it."""

    __slots__ = ("peer", "remote_rid", "meta", "prompt", "budget",
                 "sample_kw", "next_poll", "fails")

    def __init__(self, peer: _Peer, remote_rid: int, meta: dict,
                 prompt, budget: int, sample_kw: dict) -> None:
        self.peer = peer
        self.remote_rid = remote_rid
        self.meta = meta
        self.prompt = prompt
        self.budget = budget
        self.sample_kw = sample_kw
        self.next_poll = 0.0
        self.fails = 0


class DisaggController:
    """The prefill role's handoff engine, ticked from the owning
    ``_LlmServer.pump()``.

    Each tick: (1) retry any queued local resubmits, (2) OFFLOAD —
    extract every freshly-extractable request, pick the decode peer
    with the deepest shared prefix (pool headroom breaks ties), ship
    the stripped span, (3) RELAY — poll outstanding handoffs over
    ``disagg_fetch`` and append finished generations to the server's
    out queue under their original meta, so the prefill server's OWN
    serversrc delivers them (at-most-once rides the unchanged
    ``frame_id``). Reentrant ticks are skipped (pump runs from both the
    src thread and the sink's backpressure loop)."""

    def __init__(self, peers_spec: str, llm_id: int = 0,
                 poll_s: float = 0.02, probe_timeout_s: float = 2.0,
                 max_fetch_fails: int = 25,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.peers = [
            _Peer(h, p, i) for h, p, i in
            parse_decode_peers(peers_spec, default_llm_id=llm_id)
        ]
        self.poll_s = float(poll_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self.max_fetch_fails = max(1, int(max_fetch_fails))
        self.clock = clock
        self._handoffs: Dict[Tuple[str, int], _Handoff] = {}
        self._resubmit_q: List[_Handoff] = []
        self._tick_lock = threading.Lock()
        self.counts: Dict[str, int] = {}
        # spans shipped: their count, encoded bytes, and the seconds of the
        # extract (the device-to-host copy) and of the wire (probe + send)
        self.spans = {"spans": 0, "bytes": 0, "extract_s": 0.0, "wire_s": 0.0}
        self._reg = obs_metrics.get()
        self._ctrs: Dict[str, object] = {}

    # -- accounting --------------------------------------------------------
    def _count(self, outcome: str) -> None:
        self.counts[outcome] = self.counts.get(outcome, 0) + 1
        reg = self._reg
        if reg is None:
            return
        c = self._ctrs.get(outcome)
        if c is None:
            c = self._ctrs[outcome] = reg.counter(
                "nns_disagg_handoffs_total", outcome=outcome
            )
        c.inc()

    def outstanding(self) -> int:
        return len(self._handoffs) + len(self._resubmit_q)

    def idle(self) -> bool:
        return not self._handoffs and not self._resubmit_q

    def stats(self) -> Dict[str, object]:
        return {
            "outstanding": len(self._handoffs),
            "counts": dict(self.counts),
            "spans": dict(self.spans),
            "peers": {
                p.addr: {"handoffs": p.handoffs, "refusals": p.refusals}
                for p in self.peers
            },
        }

    # -- the pump hook -----------------------------------------------------
    def tick(self, server) -> bool:
        """One offload+relay pass; True when anything moved. Non-
        blocking reentrancy guard: pump() runs concurrently from the
        src thread and the sink's backpressure loop, and a second
        overlapping tick would double-extract."""
        if not self._tick_lock.acquire(blocking=False):
            return False
        try:
            did = self._drain_resubmits(server)
            if not server.draining:
                did |= self._offload(server)
            did |= self._relay(server)
            return did
        finally:
            self._tick_lock.release()

    # -- offload -----------------------------------------------------------
    def _offload(self, server) -> bool:
        with server._lock:
            rids = list(server._pending)
        if not rids:
            return False
        if not any(self.clock() >= p.bench_until for p in self.peers):
            return False  # whole fleet benched: decode locally meanwhile
        parts = server.cb.partials(rids)
        did = False
        for rid in rids:
            toks = parts.get(rid)
            if toks is None or not toks:
                continue  # still prefilling (no first token yet)
            did |= self._handoff_one(server, rid)
        return did

    def _handoff_one(self, server, rid: int) -> bool:
        from nnstreamer_tpu_torch.edge import query as _equery
        from nnstreamer_tpu_torch.edge.transport import TransportError
        from nnstreamer_tpu_torch.kv import migrate as _migrate

        t0 = time.perf_counter()
        try:
            span = server.cb.extract_request(rid)
        except _migrate.SpanError:
            return False  # finished (or re-queued) this instant
        t_extract = time.perf_counter() - t0
        with server._lock:
            meta = dict(server._pending.get(rid) or {})
        span.meta.update(server.span_meta(meta))
        # the decode server segregates this generation for fetch
        # instead of emitting it — the prefill side owns DELIVER
        span.meta["_nns_disagg"] = 1
        now = self.clock()
        best = None  # ((shared, free_blocks), peer, shared)
        for p in self.peers:
            if now < p.bench_until:
                continue
            try:
                shared, advert = _equery.probe_migration_full(
                    p.host, p.port, span.kv_tokens, llm_id=p.llm_id,
                    timeout=self.probe_timeout_s,
                )
            except _equery.MigrationRefused as exc:
                self._bench(p, exc.retry_after_ms)
                continue
            except (TransportError, OSError, ValueError):
                self._bench(p, 250.0)
                continue
            key = (int(shared), int(advert.get("free_blocks", 0) or 0))
            if best is None or key > best[0]:
                best = (key, p, int(shared))
        remote_rid = -1
        peer = None
        wire = b""
        if best is not None:
            _key, peer, shared = best
            try:
                wire = _migrate.encode_span(span.strip_shared(shared))
                remote_rid = _equery.send_migration(
                    peer.host, peer.port, wire, llm_id=peer.llm_id,
                    timeout=self.probe_timeout_s,
                )
            except _equery.MigrationRefused as exc:
                self._bench(peer, exc.retry_after_ms)
                remote_rid = -1
            except (TransportError, OSError, ValueError,
                    _migrate.SpanError):
                self._bench(peer, 250.0)
                remote_rid = -1
        if remote_rid < 0 or peer is None:
            # rung 1/2 of the failure ladder: the span re-enters the
            # LOCAL arena (same bytes, zero re-prefill); cold re-prefill
            # only if even that is refused. Tokens never lost.
            self._readopt(server, rid, span, meta)
            return True
        with server._lock:
            server._pending.pop(rid, None)
            server._sent.pop(rid, None)
        self.spans["spans"] += 1
        self.spans["bytes"] += len(wire)
        self.spans["extract_s"] += t_extract
        self.spans["wire_s"] += time.perf_counter() - t0 - t_extract
        peer.handoffs += 1
        self._handoffs[(peer.addr, remote_rid)] = _Handoff(
            peer, remote_rid, meta,
            np.asarray(span.prompt, np.int32), int(span.budget),
            dict(temperature=float(span.temperature),
                 top_k=int(span.top_k), top_p=float(span.top_p)),
        )
        self._count("handoff")
        return True

    def _bench(self, p: _Peer, retry_after_ms: float) -> None:
        p.refusals += 1
        p.bench_until = self.clock() + max(
            float(retry_after_ms or 0.0), 50.0
        ) / 1000.0

    def _readopt(self, server, rid: int, span, meta: dict) -> None:
        try:
            new_rid = server.cb.adopt_request(span)
        except Exception:
            new_rid = server.cb.resume_from_span(span)
        with server._lock:
            server._pending.pop(rid, None)
            server._pending[new_rid] = meta
        self._count("local")

    # -- relay -------------------------------------------------------------
    def _relay(self, server) -> bool:
        if not self._handoffs:
            return False
        from nnstreamer_tpu_torch.edge import query as _equery
        from nnstreamer_tpu_torch.edge.transport import TransportError

        did = False
        for key, h in list(self._handoffs.items()):
            now = self.clock()
            if now < h.next_poll:
                continue
            h.next_poll = now + self.poll_s
            try:
                toks = _equery.fetch_handoff(
                    h.peer.host, h.peer.port, h.remote_rid,
                    llm_id=h.peer.llm_id, timeout=self.probe_timeout_s,
                )
            except _equery.MigrationRefused as exc:
                if "draining" in exc.reason:
                    # a draining peer still finishes its in-flight
                    # before quiescing — keep polling
                    continue
                # the peer no longer knows the rid: that copy is gone;
                # rung 3 — resubmit locally from the prompt
                _log.warning(
                    "disagg: peer %s lost rid %d (%s); resubmitting "
                    "locally", h.peer.addr, h.remote_rid, exc.reason,
                )
                self._handoffs.pop(key, None)
                self._resubmit_q.append(h)
                did = True
                continue
            except (TransportError, OSError, ValueError):
                h.fails += 1
                if h.fails >= self.max_fetch_fails:
                    _log.warning(
                        "disagg: peer %s unreachable for rid %d after "
                        "%d polls; resubmitting locally",
                        h.peer.addr, h.remote_rid, h.fails,
                    )
                    self._handoffs.pop(key, None)
                    self._resubmit_q.append(h)
                    did = True
                continue
            h.fails = 0
            if toks is None:
                continue  # still decoding on the peer
            self._handoffs.pop(key, None)
            meta = dict(h.meta)
            if server.stream:
                # streaming servers hand off whole generations; the
                # done frame still carries the full token list
                meta = {**meta, "stream": True, "done": True}
            with server._lock:
                server._out.append((list(toks), meta))
            self._count("relayed")
            did = True
        return did

    # -- local resubmit (rung 3) -------------------------------------------
    def _drain_resubmits(self, server) -> bool:
        if not self._resubmit_q:
            return False
        did = False
        kept: List[_Handoff] = []
        for h in self._resubmit_q:
            rid = server.cb.submit(h.prompt, h.budget, **h.sample_kw)
            if rid is None:
                kept.append(h)  # batch full: retry next tick
                continue
            with server._lock:
                server._pending[rid] = dict(h.meta)
            self._count("recovered")
            did = True
        self._resubmit_q = kept
        return did
