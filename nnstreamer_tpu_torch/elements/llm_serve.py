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
Not ported yet, and raising when set: migration to a peer
(``migrate-to``, ``drain(migrate_to=...)``: they need the edge layer),
disaggregated serving (``role``, ``decode-peers``) and the lint's
``kv-memory-bound``.
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

#: props of the reference that name features not ported yet, with their
#: defaults: setting one to anything else raises
_NOT_PORTED = {
    "migrate-to": ("", "live KV-span migration to a peer, which needs the edge layer "
                       "(ROADMAP A.7)"),
    "role": ("", "disaggregated prefill/decode serving"),
    "decode-peers": ("", "disaggregated prefill/decode serving"),
    "kv-memory-bound": ("", "the lint's declared KV memory bound"),
}


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


def _not_ported_peer(what: str) -> str:
    return (f"tensor_llm_serversink: {what} (live KV-span migration to a peer) is not "
            "ported yet: it needs the edge layer (ROADMAP A.7)")


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
                 plane: str = "", plane_weight: float = 1.0):
        self._paged = bool(kv_kw) and kv_kw.get("kv_layout") == "paged"
        if (migrate_to or checkpoint_dir or checkpoint_every_tokens) and not self._paged:
            # spans are block-table slices: the slot cache has none
            raise ElementError(
                "tensor_llm_serversink: migrate-to / checkpoint-every-tokens / checkpoint-dir "
                "need kv-layout=paged (spans are block-table slices)"
            )
        if migrate_to:
            raise NotImplementedError(_not_ported_peer("migrate-to"))
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
        self.draining = False
        self._ckpt_every = max(0, int(checkpoint_every_tokens))
        self._ckpt_dir = str(checkpoint_dir or "")
        self._ckpt_seen: Dict[int, int] = {}  # rid -> tokens at its last checkpoint
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
        if self.draining:
            raise ElementError(
                "tensor_llm_serversink: draining — not accepting new requests "
                "(resubmit to another endpoint)"
            )
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
                    if rid in parts:
                        harvested |= self._stream_new_locked(rid, meta, parts[rid])
            for rid in list(self._pending):
                toks = self.cb.result(rid)
                if toks is None:
                    continue
                meta = self._pending.pop(rid)
                if self.stream:
                    self._stream_new_locked(rid, meta, toks)
                    meta = {**meta, "stream": True, "done": True}
                self._sent.pop(rid, None)
                self._out.append((toks, meta))
                finished.append(rid)
                harvested = True
        if self._ckpt_dir:
            for rid in finished:
                self._ckpt_drop(rid)
            if self._ckpt_every:
                self._checkpoint_tick()
        return bool(emitted) or harvested

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
        rid = self.cb.adopt_request(span)
        with self._lock:
            self._pending[rid] = dict(span.meta)
        return rid

    def migration_advert(self) -> Dict:
        """What a migration probe's answer carries besides the coverage:
        the server's role (disaggregated roles are not ported, so none)."""
        return {"role": ""}

    def drain(self, migrate_to: Optional[str] = None) -> Dict[str, int]:
        """Stop admitting (a submit raises ``draining``), settle the paged
        prefill queue, and keep the in-flight requests to finish in place →
        ``{"migrated", "resumed", "completed", "kept"}``. Draining to a peer
        (``migrate_to``, or the ``migrate-to`` prop) needs the edge layer
        and raises ``NotImplementedError`` before anything changes. A
        plane-shared batcher refuses (``LlmPlaneError``)."""
        if self._plane is not None:
            self._plane.refuse_migration("drain(migrate_to=...)")
        target = "" if migrate_to is None else str(migrate_to)
        if target:
            raise NotImplementedError(_not_ported_peer("drain(migrate_to=...)"))
        self.draining = True
        if self._paged:
            # every queued prefill lands (its request decodes) before the
            # drain returns; completed chunks are never run again
            while (self.cb.stats().get("kv_prefill_queue") or 0) > 0 and not self.stopped:
                if not self.pump():
                    time.sleep(0.002)
        with self._lock:
            kept = len(self._pending)
        return {"migrated": 0, "resumed": 0, "completed": 0, "kept": kept}

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

    def stats(self) -> Dict:
        if self._plane is not None:
            # the shared batcher's counters + this stream's only
            return self._plane.stats_for(self._stream)
        st = self.cb.stats()
        # the SLO rows of nns-top --requests (serving_requests once the
        # executor prefixes the row)
        st["requests"] = {str(rid): row for rid, row in self.cb.requests().items()}
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
        with self._lock:
            return self.eos and not self._pending and not self._out


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
    (paged: one stream of a shared LLM plane, see the module)."""

    FACTORY_NAME = "tensor_llm_serversink"

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
        **{k: PropSpec(type(v[0]).__name__, v[0], desc=f"{v[1]}: not ported yet")
           for k, v in _NOT_PORTED.items()},
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        for key, (default, what) in _NOT_PORTED.items():
            value = self.get_property(key)
            if value is not None and str(value) != str(default):
                raise NotImplementedError(
                    f"{self.name}: {key}={value} ({what}) is not ported yet"
                )
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
