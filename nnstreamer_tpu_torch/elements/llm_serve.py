"""tensor_llm_{serversink,serversrc}: continuous-batching LLM serving as
pipeline elements.

The counterpart of ``nnstreamer_tpu/elements/llm_serve.py`` with a private
slot-layout server. The two elements share one server through a table
keyed by ``id``, the reference's pairing pattern for repo and query
elements:

    tensorsrc ... ! tensor_llm_serversink id=0 custom="..." ...
    tensor_llm_serversrc id=0 ! tensor_sink

- ``tensor_llm_serversink`` (a Sink) submits each prompt frame (an int32
  token tensor; per-frame meta ``max_new_tokens``, ``temperature``,
  ``top_k``, ``top_p``, ``seed`` override the defaults). When every slot
  is busy it steps the batcher until one frees: admission backpressure.
- ``tensor_llm_serversrc`` (a Source, on its own thread, so decoding goes
  on while no prompt arrives) steps the batcher and emits one frame per
  completed request: tokens [1, n] int32 with the request frame's meta.
  ``stream=true`` emits one frame per new token, then a done frame. Each
  step or pump is one of the batcher's pump programs, on CUDA a CUDA-graph
  replay (captured on whichever element thread first runs it, under the
  process-wide capture lock the pipeline's segments share).

EOS: the sink's EOS marks the end of submissions; the src drains every
pending request, then ends its stream.

The server runs on the pipeline's device. ``kv-layout=paged`` builds a
paged batcher (block arena, prefix sharing, chunked prefill, preemption),
with ``block-size``, ``kv-blocks``, ``prefill-chunks`` and ``kv-attn``
passed through as the reference passes them; ``serving_stats()`` then
carries the ``kv_*`` counters. ``speculate=k`` (k ≥ 2) pumps with the
batcher's speculative rounds (``spec_step``, or ``spec_pump`` with
``pump`` > 1), ``speculate=auto`` adapts k in 2..8 from an EMA of the
acceptance rate over proposal columns, and ``speculate-model=zoo:<name>``
proposes with a draft model whose options ride in ``custom`` under
``draft_``-prefixed keys (a draft alone implies k = 4).

Span checkpoints (``kv-layout=paged``): ``checkpoint-every-tokens=N``
writes each in-flight request's KV span (``kv/migrate.py``) to
``checkpoint-dir`` every N new tokens, atomically; a server built on a
directory that holds spans adopts them at construction (their K/V lands
in the arena, no prefill runs again) and finishes them, and a finished
request's file is removed. ``drain()`` stops admitting (a submit then
raises ``draining``), settles the prefill queue and lets the kept requests
finish in place.

``plane=<name>`` (``kv-layout=paged`` only) makes the server one client
stream of a shared LLM plane (serving_plane/llm.py): every serversink
naming the plane submits into ONE paged batcher, prompts admit by
weighted-fair scheduling (``plane-weight``), the pumps of whichever
serversrc gets there first advance every stream, and each serversrc emits
only its own stream's generations. A plane-shared batcher refuses
speculation, ``stream=true``, span checkpoints and the migration surface.

Migration and disaggregated serving ride the edge layer's CTRL channel
(edge/query.py). Every private paged server is a migration target of the
serversrcs in its process. ``drain(migrate_to="host:port[/llm-id]")`` (or
the ``migrate-to`` prop) settles the prefill queue, then ships each
in-flight request's KV span to that peer: probe the peer's prefix
coverage, strip the shared blocks, send; a refusing or unreachable peer
leaves the request to resume here by re-prefill. ``role=prefill
decode-peers=h:p,...`` hands every request off to a ``role=decode`` peer
the moment its first token exists (serving_plane/disagg.py): the decode
peer adopts the span with no prefill run again, parks the finished tokens,
and the prefill server fetches and emits them under the request's meta.
The lint's ``kv-memory-bound`` is not ported yet and raises when set.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.config import conf
from nnstreamer_tpu_torch.elements.base import (
    ElementError,
    NegotiationError,
    PropSpec,
    Sink,
    Source,
    Spec,
    parse_bool,
)
from nnstreamer_tpu_torch.tensors.frame import EOS_FRAME, Frame
from nnstreamer_tpu_torch.tensors.spec import TensorFormat, TensorsSpec

_table: Dict[str, "_LlmServer"] = {}
_table_lock = threading.Lock()

def _get_server(srv_id: str, create_kw: Optional[dict] = None) -> "_LlmServer":
    with _table_lock:
        srv = _table.get(srv_id)
        if srv is not None and create_kw is not None and srv.eos:
            # a drained server of an earlier run under the same id: replace
            # it (its props may differ and its eos flag would end the new
            # stream)
            srv = None
        if srv is None:
            if create_kw is None:
                raise ElementError(
                    f"tensor_llm_server id={srv_id}: no serversink created "
                    "the server yet (the sink owns the model props)"
                )
            srv = _table[srv_id] = _LlmServer(**create_kw)
        return srv


def _drop_server(srv_id: str, srv: Optional["_LlmServer"]) -> None:
    """Remove the table entry, but only if it is still ``srv`` (another
    pipeline may have reused the id), and drop ``srv``'s plane ref
    (idempotent: a drained-then-stopped src releases once)."""
    with _table_lock:
        if srv is not None and _table.get(srv_id) is srv:
            _table.pop(srv_id, None)
    if srv is not None:
        srv.release_plane()


def drain_server(srv_id: str, migrate_to: Optional[str] = None) -> Dict:
    """Drain the server registered under ``srv_id`` (:meth:`_LlmServer.drain`)
    → its summary."""
    with _table_lock:
        srv = _table.get(str(srv_id))
    if srv is None:
        raise ElementError(f"tensor_llm_server id={srv_id}: no server registered")
    return srv.drain(migrate_to)


# meta keys that mean nothing outside the submitting process (the
# reference's hop-local set): a span or checkpoint never carries them
_SPAN_META_SKIP = frozenset({
    "client_id", "wall_t0", "admit_t", "_nns_srv", "_nns_budget_released",
})


def _span_meta(meta: dict) -> dict:
    """The JSON-scalar, cross-process subset of a request's frame meta:
    what rides ``RequestSpan.meta`` (and the checkpoint files), so the
    server that adopts a request emits it with its identity (``req``,
    ``frame_id``) intact."""
    return {k: v for k, v in meta.items() if k not in _SPAN_META_SKIP
            and (v is None or isinstance(v, (str, int, float, bool)))}


def _build_batcher(model: str, options: Dict[str, str], n_slots: int, max_len: int,
                   prompt_len: int, cache_dtype: str, attn_impl: str,
                   device: torch.device, kv_kw: Optional[dict] = None,
                   speculate_model: str = ""):
    """Open the zoo model on ``device`` and build its ContinuousBatcher
    (float32 compute, as the reference's element builds it); ``kv_kw``
    carries the paged layout's settings, ``speculate_model`` a draft zoo
    model configured by the ``draft_``-prefixed options (the vocabulary
    is the target's unless given)."""
    from nnstreamer_tpu_torch.models import zoo
    from nnstreamer_tpu_torch.models.serving import ContinuousBatcher

    for name, what in ((model, "model"), (speculate_model or "zoo:", "speculate-model")):
        if not name.startswith("zoo:"):
            raise ElementError(f"tensor_llm_serversink: {what} must be zoo:<name>, got {name!r}")
    target = {k: v for k, v in options.items() if not k.startswith("draft_")}
    m = zoo.get(model[len("zoo:"):], device=device, **target)
    if m.params is None:
        raise ElementError(f"tensor_llm_serversink: {model} is not a language model")
    draft_kw = {}
    if speculate_model:
        d_opts = {k[len("draft_"):]: v for k, v in options.items() if k.startswith("draft_")}
        if "vocab" in options and "vocab" not in d_opts:
            d_opts["vocab"] = options["vocab"]
        dm = zoo.get(speculate_model[len("zoo:"):], device=device, **d_opts)
        draft_kw = dict(draft_params=dm.params, draft_n_heads=int(d_opts.get("n_heads", 8)))
    return ContinuousBatcher(
        m.params, int(options.get("n_heads", 8)), n_slots=n_slots, max_len=max_len,
        prompt_len=prompt_len, cache_dtype=cache_dtype, attn_impl=attn_impl, device=device,
        **(kv_kw or {}), **draft_kw,
    )


class _LlmServer:
    """State shared by the sink (submit) and the src (pump, emit)."""

    def __init__(self, model: str, options: Dict[str, str], n_slots: int, max_len: int,
                 prompt_len: int, default_new: int, device: torch.device,
                 stream: bool = False, pump_tokens: int = 1, cache_dtype: str = "auto",
                 attn_impl: str = "xla", kv_kw: Optional[dict] = None, speculate: int = 0,
                 speculate_model: str = "", srv_id: str = "0", migrate_to: str = "",
                 checkpoint_every_tokens: int = 0, checkpoint_dir: str = "",
                 plane: str = "", plane_weight: float = 1.0, role: str = "",
                 decode_peers: str = ""):
        self._paged = bool(kv_kw) and kv_kw.get("kv_layout") == "paged"
        role, decode_peers = str(role or ""), str(decode_peers or "")
        if role not in ("", "prefill", "decode"):
            raise ElementError(f"tensor_llm_serversink: role={role!r} must be prefill or decode")
        if decode_peers and role != "prefill":
            raise ElementError(
                "tensor_llm_serversink: decode-peers needs role=prefill (only the prefill "
                "role ships spans to decode peers)")
        if role:
            if not self._paged:
                raise ElementError(
                    "tensor_llm_serversink: role=prefill/decode needs kv-layout=paged "
                    "(handoffs are block-table spans)")
            if plane:
                from nnstreamer_tpu_torch.serving_plane.llm import LlmPlaneError

                raise LlmPlaneError(
                    f"llm plane {plane!r}: role= refused — plane-shared batchers cannot "
                    "extract or adopt request spans; serve the role with a private "
                    "kv-layout=paged batcher instead")
        if (migrate_to or checkpoint_dir or checkpoint_every_tokens) and not self._paged:
            # spans are block-table slices: the slot cache has none
            raise ElementError(
                "tensor_llm_serversink: migrate-to / checkpoint-every-tokens / checkpoint-dir "
                "need kv-layout=paged (spans are block-table slices)"
            )
        self.role = role
        self._disagg = None  # DisaggController (prefill role with peers)
        self._disagg_done: Dict[int, list] = {}  # decode role: rid -> parked tokens
        if role == "prefill" and decode_peers:
            # before the batcher: a malformed decode-peers fails without a model load
            from nnstreamer_tpu_torch.serving_plane.disagg import DisaggController

            try:
                self._disagg = DisaggController(
                    decode_peers, llm_id=int(srv_id) if str(srv_id).isdigit() else 0)
            except ValueError as exc:
                raise ElementError(f"tensor_llm_serversink: {exc}") from exc
        self.plane_name = plane
        self._plane = None   # LlmPlane once acquired
        self._stream = None  # this server's LlmStream
        if plane:
            self._check_plane(plane, speculate, speculate_model, stream,
                              checkpoint_every_tokens or checkpoint_dir)
            from nnstreamer_tpu_torch.serving_plane import llm as llm_plane

            # every knob that shapes the batcher: a sharer that disagrees
            # would serve with someone else's model
            sig = (model, tuple(sorted(options.items())), n_slots, max_len, prompt_len,
                   tuple(sorted((kv_kw or {}).items())), cache_dtype, attn_impl,
                   max(1, int(pump_tokens)), str(device))
            self._plane = llm_plane.acquire(
                plane, sig,
                opener=lambda: _build_batcher(model, options, n_slots, max_len, prompt_len,
                                              cache_dtype, attn_impl, device, kv_kw),
                pump_tokens=pump_tokens,
            )
            try:
                self._stream = self._plane.attach(srv_id, plane_weight)
            except ValueError:
                # the same id attached elsewhere in this process
                self._stream = self._plane.attach(f"{srv_id}@{id(self) & 0xffff:04x}",
                                                  plane_weight)
            self.cb = self._plane.cb
        else:
            self.cb = _build_batcher(model, options, n_slots, max_len, prompt_len, cache_dtype,
                                     attn_impl, device, kv_kw, speculate_model)
        self.default_new = default_new
        self.stream = stream
        # pump=N: tokens per step_pump (one read of the host per pump);
        # 1 keeps per-token stepping, the least admission latency. With
        # speculation: spec_pump(rounds=ceil(N / k)), or spec_step at N = 1
        self.pump_tokens = max(1, int(pump_tokens))
        if speculate_model and speculate != -1 and speculate < 2:
            speculate = 4  # a draft exists only to propose the chunks
        # speculate=k pumps with speculative rounds; -1 (auto) adapts k in
        # 2..8 from the acceptance EMA over proposal columns
        self.speculate = speculate
        self._spec_k = 4
        self._acc_ema = 0.5
        self._spec_seen = (0, 0)  # (columns, accepted) at the last adaptation
        self._lock = threading.Lock()
        self._pending: Dict[int, dict] = {}  # rid -> request meta
        self._sent: Dict[int, int] = {}      # rid -> tokens already streamed
        self._out: deque = deque()
        self.eos = False
        self.stopped = False
        self.srv_id = str(srv_id)
        self.migrate_to = str(migrate_to or "")
        self.draining = False
        self._edge_srv = None  # the feeding query serversrc's id, learned at submit
        self._ckpt_every = max(0, int(checkpoint_every_tokens))
        self._ckpt_dir = str(checkpoint_dir or "")
        self._ckpt_seen: Dict[int, int] = {}  # rid -> tokens at its last checkpoint
        # adopted spans: their count, bytes and the seconds adopt_request took
        self.adopted = {"spans": 0, "bytes": 0, "seconds": 0.0}
        # the llm_id the migration handshake routes by: a numeric id, else 0
        # (a process with one LLM server answers for any id)
        self._mig_id = int(self.srv_id) if self.srv_id.isdigit() else 0
        self._mig_registered = False
        if self._plane is None and self._paged:
            # every private paged server is a migration target; migrate-to
            # only says where THIS server ships its spans at drain
            from nnstreamer_tpu_torch.edge import query as equery

            equery.register_migration_handler(self._mig_id, self)
            self._mig_registered = True
        if self._ckpt_dir:
            self._restore_checkpoints()

    def _check_plane(self, plane: str, speculate: int, speculate_model: str, stream: bool,
                     checkpoints) -> None:
        """Refuse, before the plane is acquired, what a plane-shared batcher
        cannot serve."""
        from nnstreamer_tpu_torch.serving_plane.llm import LlmPlaneError

        if not self._paged:
            raise ElementError(
                f"tensor_llm_serversink: plane={plane!r} needs kv-layout=paged (the shared "
                "batcher is the paged arena; slot caches are per-server by construction)"
            )
        if speculate or speculate_model:
            raise ElementError(
                f"tensor_llm_serversink: plane={plane!r} cannot combine with "
                "speculate/speculate-model (the speculation controller state is per-server)"
            )
        if stream:
            raise ElementError(
                f"tensor_llm_serversink: plane={plane!r} cannot combine with stream=true "
                "(per-token routing through a shared plane is not wired)"
            )
        if checkpoints:
            raise LlmPlaneError(
                f"llm plane {plane!r}: checkpoint-every-tokens/checkpoint-dir refused — "
                "plane-shared batchers cannot migrate or checkpoint requests; serve with a "
                "private kv-layout=paged batcher instead"
            )

    def release_plane(self) -> None:
        """Detach from (and drop one ref of) the shared LLM plane when this
        server leaves the pairing table. Idempotent."""
        if self._mig_registered:
            self._mig_registered = False
            from nnstreamer_tpu_torch.edge import query as equery

            equery.unregister_migration_handler(self._mig_id, self)
        with self._lock:
            plane, self._plane = self._plane, None
        if plane is None:
            return
        from nnstreamer_tpu_torch.serving_plane import llm as llm_plane

        if self._stream is not None:
            plane.detach(self._stream)
        llm_plane.release(self.plane_name, plane)
        self.cb = None

    def submit(self, frame: Frame) -> None:
        if frame.meta.get("_nns_srv") is not None:
            # the query serversrc feeding this server: drain() flips its
            # readiness, and a refused submit is NACKed through it
            self._edge_srv = frame.meta.get("_nns_srv")
        if self.draining:
            self._nack_draining(frame)
            return
        prompt = np.asarray(frame.to_host().tensors[0]).reshape(-1).astype(np.int32)
        budget = int(frame.meta.get("max_new_tokens", self.default_new))
        kw = dict(
            temperature=float(frame.meta.get("temperature", 0.0)),
            top_k=int(frame.meta.get("top_k", 0)),
            top_p=float(frame.meta.get("top_p", 1.0)),
        )
        if "seed" in frame.meta:
            kw["seed"] = int(frame.meta["seed"])
        if "deadline_ms" in frame.meta:
            # SLO accounting (requests(), nns-top --requests); shedding an
            # expired frame is the executor's, upstream of this element
            kw["deadline_s"] = float(frame.meta["deadline_ms"]) / 1000.0
        if self._plane is not None:
            # weighted-fair admission into the SHARED batcher; backpressure
            # past the fair backlog pumps inside the plane's submit
            if self.stopped:
                raise ElementError("tensor_llm_serversink: stopped")
            self._plane.submit(self._stream, prompt, budget, kw, dict(frame.meta))
            return
        while True:
            if self.stopped:
                raise ElementError("tensor_llm_serversink: stopped")
            rid = self.cb.submit(prompt, budget, **kw)
            if rid is not None:
                break
            # every slot busy: stepping here is the backpressure. A step
            # that advanced nothing is no error (the src thread may have
            # just freed a slot): retry.
            if not self.pump():
                time.sleep(0.005)
        with self._lock:
            self._pending[rid] = dict(frame.meta)

    def pump(self) -> bool:
        """One step (or pump); harvest finished requests and, when
        streaming, every new token. True if anything advanced. Through a
        plane the shared batcher advances every stream, and this server's
        generations land on its plane stream (:meth:`pop` reads them)."""
        plane = self._plane
        if plane is not None:
            return plane.pump()
        n = self.pump_tokens
        k = self._spec_k if self.speculate == -1 else self.speculate
        if k > 1:
            emitted = (self.cb.spec_pump(rounds=-(-n // k), k=k) if n > 1
                       else self.cb.spec_step(k=k))
            if self.speculate == -1:
                self._adapt_k()
        else:
            emitted = self.cb.step_pump(n) if n > 1 else self.cb.step()
        harvested = False
        finished: List[int] = []
        with self._lock:
            if self.stream:
                parts = self.cb.partials(list(self._pending))
                for rid, meta in self._pending.items():
                    if rid in parts and not self._parks(meta):
                        harvested |= self._stream_new_locked(rid, meta, parts[rid])
            for rid in list(self._pending):
                toks = self.cb.result(rid)
                if toks is None:
                    continue
                meta = self._pending.pop(rid)
                park = self._parks(meta)
                if self.stream and not park:
                    self._stream_new_locked(rid, meta, toks)
                    meta = {**meta, "stream": True, "done": True}
                self._sent.pop(rid, None)
                if park:
                    # a handed-off generation finished here, but the prefill
                    # peer delivers it: park the tokens for its disagg_fetch
                    self._disagg_done[rid] = list(toks)
                else:
                    self._out.append((toks, meta))
                finished.append(rid)
                harvested = True
        if self._ckpt_dir:
            for rid in finished:
                self._ckpt_drop(rid)
            if self._ckpt_every:
                self._checkpoint_tick()
        if self._disagg is not None and not self.stopped:
            # prefill role: hand freshly extractable requests to the decode
            # peers, and queue the finished handoffs fetched back
            harvested |= self._disagg.tick(self)
        return bool(emitted) or harvested

    def _parks(self, meta: dict) -> bool:
        """A decode-role server keeps a handed-off generation for its
        prefill peer instead of emitting it."""
        return self.role == "decode" and bool(meta.get("_nns_disagg"))

    def _stream_new_locked(self, rid: int, meta: dict, toks) -> bool:
        """Queue one frame per token not yet streamed (_lock held)."""
        n0 = self._sent.get(rid, 0)
        for i in range(n0, len(toks)):
            self._out.append(
                ([toks[i]], {**meta, "stream": True, "done": False, "token_index": i})
            )
        self._sent[rid] = len(toks)
        return len(toks) > n0

    def _adapt_k(self) -> None:
        """speculate=auto: move k with an EMA of the acceptance rate over
        the proposal columns offered since the last pump (a rate over
        rounds would saturate on busy batches)."""
        st = self.cb.stats()
        cols, acc = st["spec_columns"], st["spec_accepted_tokens"]
        dc = cols - self._spec_seen[0]
        if dc > 0:
            rate = (acc - self._spec_seen[1]) / dc
            self._acc_ema = 0.7 * self._acc_ema + 0.3 * rate
            self._spec_k = min(8, max(2, 2 + int(round(self._acc_ema * 6))))
            self._spec_seen = (cols, acc)

    # -- migration surface and span checkpoints ---------------------------------
    def _nack_draining(self, frame: Frame) -> None:
        """A submit reaching a draining server: NACK it ``draining`` through
        the query serversrc it came from, so a fleet client re-routes it;
        without an edge hop the typed refusal is the only answer."""
        srv = frame.meta.get("_nns_srv")
        cid = frame.meta.get("client_id")
        if srv is not None and cid is not None:
            from nnstreamer_tpu_torch.edge.query import discard_admitted

            discard_admitted(srv, cid, "nack", frame_id=frame.meta.get("frame_id"),
                             draining=True)
            return
        raise ElementError(
            "tensor_llm_serversink: draining — not accepting new requests "
            "(resubmit to another endpoint)"
        )

    def migration_probe(self, tokens) -> int:
        """How many leading ``tokens`` this server's prefix index covers in
        full blocks: a sender strips those blocks' payloads."""
        from nnstreamer_tpu_torch.kv.migrate import SpanStateError

        if self._plane is not None:
            self._plane.refuse_migration("migrate_probe")
        if self.draining or self.stopped:
            raise SpanStateError(f"tensor_llm_server id={self.srv_id}: draining")
        return int(self.cb.probe_prefix([int(t) for t in tokens]))

    def migration_adopt(self, span_bytes: bytes) -> int:
        """Decode and adopt an incoming KV span: the request continues here
        under the returned rid (bitwise for a greedy one) and this server's
        serversrc emits it with the span's meta."""
        from nnstreamer_tpu_torch.kv import migrate

        if self._plane is not None:
            self._plane.refuse_migration("migrate_span")
        if self.draining or self.stopped:
            raise migrate.SpanStateError(f"tensor_llm_server id={self.srv_id}: draining")
        span = migrate.decode_span(span_bytes)
        t0 = time.perf_counter()
        rid = self.cb.adopt_request(span)  # the span's one host-to-device copy
        dt = time.perf_counter() - t0
        with self._lock:
            self._pending[rid] = dict(span.meta)
            self.adopted["spans"] += 1
            self.adopted["bytes"] += len(span_bytes)
            self.adopted["seconds"] += dt
        return rid

    # the disagg controller stamps a request's meta onto the span it
    # extracts through the filter that drain and checkpoints use
    span_meta = staticmethod(_span_meta)

    def migration_advert(self) -> Dict:
        """What a migration probe's answer carries besides the coverage:
        the role, and for a decode server its pool headroom (free slots,
        and free plus cached blocks, since cached ones are evictable), so
        the prefill side picks a peer in one roundtrip."""
        out: Dict = {"role": self.role}
        if self.role != "decode":
            return out
        st = self.cb.stats()
        out["free_slots"] = int(st.get("slots_free", 0) or 0)
        out["free_blocks"] = (int(st.get("kv_blocks_free", 0) or 0)
                              + int(st.get("kv_blocks_cached", 0) or 0))
        return out

    def disagg_fetch(self, rid: int):
        """The prefill peer's poll for a handed-off generation: its tokens
        (once: the prefill side delivers), None while it decodes, or
        SpanStateError for an rid never seen here (the peer then
        resubmits the prompt)."""
        from nnstreamer_tpu_torch.kv.migrate import SpanStateError

        rid = int(rid)
        with self._lock:
            toks = self._disagg_done.pop(rid, None)
            if toks is not None:
                return toks
            if rid in self._pending:
                return None
        raise SpanStateError(f"tensor_llm_server id={self.srv_id}: rid {rid} unknown")

    def drain(self, migrate_to: Optional[str] = None) -> Dict[str, int]:
        """Stop admitting (a submit is NACKed ``draining``, and the feeding
        query serversrc turns ``draining``), settle the paged prefill queue
        (a span is extractable only once its request decodes), then, with a
        peer (``migrate_to`` "host:port[/llm-id]", else the ``migrate-to``
        prop), ship each in-flight request: extract its span, probe the
        peer's prefix coverage, strip the shared blocks, send. A refusing
        or unreachable peer leaves the request to resume here by
        re-prefill; with no peer the requests finish in place →
        ``{"migrated", "resumed", "completed", "kept"}``. A plane-shared
        batcher refuses (``LlmPlaneError``)."""
        if self._plane is not None:
            self._plane.refuse_migration("drain(migrate_to=...)")
        self.draining = True
        if self._edge_srv is not None:
            from nnstreamer_tpu_torch.edge import query as equery

            equery._set_server_state(self._edge_srv, equery.SRV_DRAINING)
        summary = {"migrated": 0, "resumed": 0, "completed": 0, "kept": 0}
        if self._paged:
            # every queued prefill lands (its request decodes) before any
            # span leaves; completed chunks are never run again
            while (self.cb.stats().get("kv_prefill_queue") or 0) > 0 and not self.stopped:
                if not self.pump():
                    time.sleep(0.002)
        target = self.migrate_to if migrate_to is None else str(migrate_to)
        with self._lock:
            rids = list(self._pending)
        if not target or not rids:
            summary["kept"] = len(rids)
            return summary
        # host:port[/llm-id]: the peer's id defaults to this server's own
        peer_id = self._mig_id
        base, sep, suffix = target.partition("/")
        if sep:
            target = base
            peer_id = int(suffix) if suffix.isdigit() else 0
        host, _, port_s = target.rpartition(":")
        if not host or not port_s.isdigit():
            raise ElementError(
                f"tensor_llm_serversink: migrate-to={target!r} must be host:port[/llm-id]")
        port = int(port_s)
        from nnstreamer_tpu_torch.edge import query as equery
        from nnstreamer_tpu_torch.edge.transport import TransportError
        from nnstreamer_tpu_torch.kv import migrate

        for rid in rids:
            try:
                span = self.cb.extract_request(rid)
            except migrate.SpanError:
                # finished since the settle loop: the pump's harvest owns it
                summary["completed"] += 1
                continue
            with self._lock:
                meta = dict(self._pending.get(rid) or {})
            span.meta.update(_span_meta(meta))
            try:
                shared = equery.probe_migration(host, port, span.kv_tokens, llm_id=peer_id)
                wire = migrate.encode_span(span.strip_shared(shared))
                equery.send_migration(host, port, wire, llm_id=peer_id)
            except (equery.MigrationRefused, TransportError, OSError, ValueError,
                    migrate.SpanError):
                # still whole here: resume by re-prefill of the surviving
                # context (the generated tokens are kept)
                new_rid = self.cb.resume_from_span(span)
                with self._lock:
                    self._pending[new_rid] = self._pending.pop(rid, meta)
                    n_sent = self._sent.pop(rid, None)
                    if n_sent is not None:
                        self._sent[new_rid] = n_sent
                if self._ckpt_dir:
                    self._ckpt_rename(rid, new_rid)
                summary["resumed"] += 1
            else:
                with self._lock:
                    self._pending.pop(rid, None)
                    self._sent.pop(rid, None)
                if self._ckpt_dir:
                    self._ckpt_drop(rid)
                summary["migrated"] += 1
        return summary

    def _checkpoint_tick(self) -> None:
        """Every checkpoint-every-tokens new tokens of a request, write its
        span checkpoint."""
        with self._lock:
            rids = list(self._pending)
        if not rids:
            return
        parts = self.cb.partials(rids)
        for rid in rids:
            n = len(parts.get(rid) or ())
            if n - self._ckpt_seen.get(rid, 0) >= self._ckpt_every and self._write_checkpoint(rid):
                self._ckpt_seen[rid] = n

    def _ckpt_path(self, rid: int) -> str:
        return os.path.join(self._ckpt_dir, f"req-{rid}.span")

    def _write_checkpoint(self, rid: int) -> bool:
        """One request's span (read without removing it) to its file,
        through a temporary file and ``os.replace``: a reader, or the restore
        scan after a crash, sees the old whole file or the new one."""
        from nnstreamer_tpu_torch.kv import migrate

        with self._lock:
            meta = dict(self._pending.get(rid) or {})
        try:
            span = self.cb.extract_request(rid, remove=False)
        except migrate.SpanError:
            return False  # finished or still prefilling at this instant
        span.meta.update(_span_meta(meta))
        path = self._ckpt_path(rid)
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            os.makedirs(self._ckpt_dir, exist_ok=True)
            with open(tmp, "wb") as f:
                f.write(migrate.encode_span(span))
            os.replace(tmp, path)
        except OSError:
            try:
                os.remove(tmp)
            except OSError:
                pass
            return False
        return True

    def _ckpt_drop(self, rid: int) -> None:
        self._ckpt_seen.pop(rid, None)
        try:
            os.remove(self._ckpt_path(rid))
        except OSError:
            pass

    def _ckpt_rename(self, old: int, new: int) -> None:
        """A request changed rid (its adoption at restart): its file follows,
        or the next restart would adopt the old name as a duplicate."""
        self._ckpt_seen[new] = self._ckpt_seen.pop(old, 0)
        try:
            os.replace(self._ckpt_path(old), self._ckpt_path(new))
        except OSError:
            pass

    def _restore_checkpoints(self) -> None:
        """Crash recovery: adopt every span a previous server left in
        checkpoint-dir. The K/V lands in the arena as it is, so no prefill
        runs again; a corrupt or unadoptable file is set aside as
        ``.bad``."""
        from nnstreamer_tpu_torch.kv import migrate

        try:
            names = sorted(os.listdir(self._ckpt_dir))
        except OSError:
            return  # a fresh directory: made at the first checkpoint
        for name in names:
            if not name.endswith(".span"):
                continue
            path = os.path.join(self._ckpt_dir, name)
            try:
                with open(path, "rb") as f:
                    span = migrate.decode_span(f.read())
                rid = self.cb.adopt_request(span)
            except (OSError, migrate.SpanError):
                try:
                    os.replace(path, path + ".bad")
                except OSError:
                    pass
                continue
            with self._lock:
                self._pending[rid] = dict(span.meta)
            # the file stays, under the new rid, until the request finishes
            # or checkpoints again: a crash right after this must not lose it
            old = name[len("req-"):-len(".span")]
            if old.isdigit():
                self._ckpt_rename(int(old), rid)
            else:
                try:
                    os.replace(path, self._ckpt_path(rid))
                except OSError:
                    pass
            self._ckpt_seen[rid] = len(span.tokens)
            self.cb._obs_counter("nns_request_resumes_total", kind="checkpoint")

    def stats(self) -> Dict:
        if self._plane is not None:
            # the shared batcher's counters + this stream's only
            return self._plane.stats_for(self._stream)
        st = self.cb.stats()
        # the SLO rows of nns-top --requests (serving_requests once the
        # executor prefixes the row)
        st["requests"] = {str(rid): row for rid, row in self.cb.requests().items()}
        if self.role:
            st["disagg_role"] = self.role
        if self._disagg is not None:
            st["disagg"] = self._disagg.stats()
        if self.role == "decode":
            with self._lock:
                st["disagg_done_waiting"] = len(self._disagg_done)
        if self.adopted["spans"]:
            st["adopted"] = dict(self.adopted)
        if self.speculate == -1:
            st["spec_k"] = self._spec_k
            st["spec_acceptance_ema"] = self._acc_ema
        elif self.speculate > 1:
            st["spec_k"] = self.speculate
        return st

    def pop(self):
        if self._plane is not None:
            return self._plane.pop(self._stream)
        with self._lock:
            return self._out.popleft() if self._out else None

    @property
    def drained(self) -> bool:
        if self._plane is not None:
            return self.eos and self._plane.idle_for(self._stream)
        if self._disagg is not None and not self._disagg.idle():
            return False  # handed-off generations still decoding on a peer
        with self._lock:
            return self.eos and not self._pending and not self._out and not self._disagg_done


@registry.element("tensor_llm_serversink")
class LlmServerSink(Sink):
    """Submit prompt frames into the paired continuous batcher.

    Props: id (pairing key), model (zoo:transformer_lm), custom (model
    options "k:v,k2:v2"), n-slots, max-len, prompt-len, max-new-tokens
    (per-request default; frame meta ``max_new_tokens`` overrides), stream
    (one frame per new token, then a done frame), pump (tokens per launch
    of ``step_pump``; 1 = per-token steps), speculate (k ≥ 2 or auto:
    speculative rounds), speculate-model (zoo:<draft>, options under
    ``draft_`` keys in custom), cache-dtype (auto | int8),
    attn-impl (xla | pallas; default from ``[llm] attn_impl``), kv-layout
    (slot | paged; default from ``[llm] kv_layout``) and, for paged,
    block-size, kv-blocks (0 = enough for every slot at max-len),
    prefill-chunks and kv-attn (auto | block | gather), each 0 or empty
    deferring to ``[llm]``; checkpoint-every-tokens and checkpoint-dir
    (paged: span checkpoints, see the module); plane and plane-weight
    (paged: one stream of a shared LLM plane, see the module); migrate-to,
    role and decode-peers (paged: migration and disaggregated serving, see
    the module)."""

    FACTORY_NAME = "tensor_llm_serversink"

    # negotiate() builds the shared _LlmServer (a model load) and registers
    # it in the process table: nns-lint's dry run must not
    LINT_SKIP_NEGOTIATE = True

    PROPERTIES = {
        "id": PropSpec("str", "0", desc="pairing key with the serversrc"),
        "model": PropSpec("str", "zoo:transformer_lm"),
        "custom": PropSpec("str", "", desc="model options 'k:v,k2:v2'"),
        "n-slots": PropSpec("int", 4),
        "max-len": PropSpec("int", 256),
        "prompt-len": PropSpec("int", 64),
        "max-new-tokens": PropSpec("int", 16),
        "stream": PropSpec("bool", False),
        "pump": PropSpec("int", 1, desc="tokens per launch"),
        "cache-dtype": PropSpec("str", "auto", desc="auto | int8"),
        "attn-impl": PropSpec("str", "", desc="decode attention: xla | pallas ([llm] default)"),
        "kv-layout": PropSpec("str", "", desc="slot | paged ([llm] default)"),
        "kv-attn": PropSpec("str", "",
                            desc="paged decode path: auto | block | gather ([llm] default)"),
        "block-size": PropSpec("int", 0, desc="tokens per KV block (paged; 0 = [llm])"),
        "kv-blocks": PropSpec("int", 0, desc="arena blocks (paged; 0 = [llm], else auto)"),
        "prefill-chunks": PropSpec("int", 0, desc="prefill buckets per pump (paged; 0 = [llm])"),
        "speculate": PropSpec("str", "0", desc="k, or 'auto'"),
        "speculate-model": PropSpec("str", "", desc="zoo:<draft model>"),
        "checkpoint-every-tokens": PropSpec(
            "int", 0, desc="span checkpoint every N new tokens of a request (paged)"),
        "checkpoint-dir": PropSpec("str", "", desc="where span checkpoints live (paged)"),
        "plane": PropSpec("str", "", desc="attach to the named LLM serving plane (paged)"),
        "plane-weight": PropSpec("float", 1.0, desc="weighted-fair admission share on the plane"),
        "migrate-to": PropSpec(
            "str", "", desc="host:port[/llm-id] a drain ships in-flight KV spans to (paged)"),
        "role": PropSpec("str", "", desc="disaggregated serving: prefill | decode (paged)"),
        "decode-peers": PropSpec(
            "str", "", desc="role=prefill: decode peers h1:p1[/llm-id],h2:p2 to hand off to"),
        "kv-memory-bound": PropSpec(
            "str", "", desc="declared KV memory bound, K/M/G suffixes (nns-lint NNS-W115/W117)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.srv_id = str(self.get_property("id", "0"))
        from nnstreamer_tpu_torch.backends.base import FilterProps

        options = FilterProps(custom=str(self.get_property("custom", ""))).custom_dict()
        cfg = conf()
        kv_layout = str(self.get_property("kv-layout", "")).strip() or cfg.get(
            "llm", "kv_layout", "slot"
        )
        if kv_layout not in ("slot", "paged"):
            raise ValueError(f"{self.name}: unknown kv-layout {kv_layout!r}")
        kv_kw = None
        if kv_layout == "paged":
            kv_kw = dict(
                kv_layout="paged",
                block_size=int(self.get_property("block-size", 0))
                or int(cfg.get("llm", "block_size", "16")),
                kv_blocks=int(self.get_property("kv-blocks", 0))
                or int(cfg.get("llm", "kv_blocks", "0")) or None,
                prefill_chunks=int(self.get_property("prefill-chunks", 0))
                or int(cfg.get("llm", "prefill_chunks", "1")),
                kv_attn=str(self.get_property("kv-attn", "")).strip()
                or cfg.get("llm", "kv_attn", "auto"),
            )
        self._create_kw = dict(
            model=str(self.get_property("model", "zoo:transformer_lm")),
            options=options,
            n_slots=int(self.get_property("n-slots", 4)),
            max_len=int(self.get_property("max-len", 256)),
            prompt_len=int(self.get_property("prompt-len", 64)),
            default_new=int(self.get_property("max-new-tokens", 16)),
            stream=parse_bool(self.get_property("stream", False)),
            pump_tokens=int(self.get_property("pump", 1)),
            cache_dtype=str(self.get_property("cache-dtype", "auto")),
            attn_impl=str(self.get_property("attn-impl", "")).strip() or cfg.get(
                "llm", "attn_impl", "xla"
            ),
            kv_kw=kv_kw,
            speculate=(-1 if str(self.get_property("speculate", "0")) == "auto"
                       else int(self.get_property("speculate", "0"))),
            speculate_model=str(self.get_property("speculate-model", "")),
            srv_id=self.srv_id,
            checkpoint_every_tokens=int(self.get_property("checkpoint-every-tokens", 0)),
            checkpoint_dir=str(self.get_property("checkpoint-dir", "")),
            plane=str(self.get_property("plane", "") or ""),
            plane_weight=float(self.get_property("plane-weight", 1.0)),
            migrate_to=str(self.get_property("migrate-to", "") or ""),
            role=str(self.get_property("role", "") or ""),
            decode_peers=str(self.get_property("decode-peers", "") or ""),
        )
        self._server: Optional[_LlmServer] = None

    def negotiate(self, in_specs: List[Spec]) -> List[Spec]:
        (spec,) = in_specs
        if not isinstance(spec, TensorsSpec):
            raise NegotiationError(f"{self.name}: needs tensor input")
        self._server = _get_server(self.srv_id, dict(self._create_kw, device=self.device))
        return []

    def render(self, frame: Frame) -> None:
        self._server.submit(frame)

    def on_eos(self) -> None:
        if self._server is not None:
            self._server.eos = True

    def stop(self) -> None:
        if self._server is not None:
            self._server.eos = True
            self._server.stopped = True


@registry.element("tensor_llm_serversrc")
class LlmServerSrc(Source):
    """Emit one frame per completed generation: tokens [1, n] int32 with
    the submitting frame's meta."""

    FACTORY_NAME = "tensor_llm_serversrc"

    PROPERTIES = {
        "id": PropSpec("str", "0", desc="pairing key with the serversink"),
        "stream": PropSpec("bool", False),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.srv_id = str(self.get_property("id", "0"))
        self.stream = parse_bool(self.get_property("stream", False))
        # this run's server, held by reference: the id string is reusable
        self._server: Optional[_LlmServer] = None
        self._final_stats: Optional[Dict] = None

    def _acquired(self, srv: Optional[_LlmServer]) -> Optional[_LlmServer]:
        if srv is not None and self.stream:
            srv.stream = True
        return srv

    def start(self) -> None:
        # the sink created the server at negotiation, before any start
        if self._server is None:
            with _table_lock:
                self._server = self._acquired(_table.get(self.srv_id))

    def stop(self) -> None:
        # teardown releases the server (weights and caches must not outlive
        # the pipeline in the table); a final stats snapshot stays readable
        if self._final_stats is None:
            self._final_stats = self.serving_stats()
        _drop_server(self.srv_id, self._server)

    def serving_stats(self) -> Optional[Dict]:
        if self._final_stats is not None:
            return self._final_stats
        return self._server.stats() if self._server is not None else None

    def output_spec(self) -> Spec:
        return TensorsSpec(format=TensorFormat.FLEXIBLE)  # lengths vary per request

    def generate(self):
        srv = self._server
        if srv is None:
            srv = self._server = self._acquired(_get_server(self.srv_id))
        item = srv.pop()
        if item is None:
            if srv.drained:
                self._final_stats = srv.stats()
                _drop_server(self.srv_id, srv)
                return EOS_FRAME
            if not srv.pump():  # decode even while no prompt arrives
                time.sleep(0.002)
            item = srv.pop()
            if item is None:
                return None
        toks, meta = item
        return Frame((np.asarray(toks, np.int32)[None, :],), meta=meta)
