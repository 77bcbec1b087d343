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
  ``stream=true`` emits one frame per new token, then a done frame.

EOS: the sink's EOS marks the end of submissions; the src drains every
pending request, then ends its stream.

The server runs on the pipeline's device. Not ported yet, and raising when
set: the shared serving plane (``plane``), speculative decoding
(``speculate``, ``speculate-model``), migration and checkpoints
(``migrate-to``, ``checkpoint-*``), disaggregated serving (``role``,
``decode-peers``) and the paged layout (``kv-layout=paged`` and its
``kv-attn``, ``block-size``, ``kv-blocks``, ``prefill-chunks``,
``kv-memory-bound``).
"""

from __future__ import annotations

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
    "plane": ("", "the shared LLM serving plane"),
    "plane-weight": (1.0, "the shared LLM serving plane"),
    "speculate": ("0", "speculative decoding"),
    "speculate-model": ("", "draft-model speculative decoding"),
    "migrate-to": ("", "live KV-span migration"),
    "checkpoint-every-tokens": (0, "span checkpoints"),
    "checkpoint-dir": ("", "span checkpoints"),
    "role": ("", "disaggregated prefill/decode serving"),
    "decode-peers": ("", "disaggregated prefill/decode serving"),
    "kv-attn": ("", "the paged KV layout"),
    "block-size": (0, "the paged KV layout"),
    "kv-blocks": (0, "the paged KV layout"),
    "prefill-chunks": (0, "the paged KV layout"),
    "kv-memory-bound": ("", "the paged KV layout's memory bound"),
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
    pipeline may have reused the id)."""
    with _table_lock:
        if srv is not None and _table.get(srv_id) is srv:
            _table.pop(srv_id, None)


def _build_batcher(model: str, options: Dict[str, str], n_slots: int, max_len: int,
                   prompt_len: int, cache_dtype: str, attn_impl: str,
                   device: torch.device):
    """Open the zoo model on ``device`` and build its ContinuousBatcher
    (float32 compute, as the reference's element builds it)."""
    from nnstreamer_tpu_torch.models import zoo
    from nnstreamer_tpu_torch.models.serving import ContinuousBatcher

    if not model.startswith("zoo:"):
        raise ElementError(f"tensor_llm_serversink: model must be zoo:<name>, got {model!r}")
    m = zoo.get(model[len("zoo:"):], device=device, **options)
    if m.params is None:
        raise ElementError(f"tensor_llm_serversink: {model} is not a language model")
    return ContinuousBatcher(
        m.params, int(options.get("n_heads", 8)), n_slots=n_slots, max_len=max_len,
        prompt_len=prompt_len, cache_dtype=cache_dtype, attn_impl=attn_impl, device=device,
    )


class _LlmServer:
    """State shared by the sink (submit) and the src (pump, emit)."""

    def __init__(self, model: str, options: Dict[str, str], n_slots: int, max_len: int,
                 prompt_len: int, default_new: int, device: torch.device,
                 stream: bool = False, pump_tokens: int = 1, cache_dtype: str = "auto",
                 attn_impl: str = "xla"):
        self.cb = _build_batcher(model, options, n_slots, max_len, prompt_len, cache_dtype,
                                 attn_impl, device)
        self.default_new = default_new
        self.stream = stream
        # pump=N: tokens per step_pump (one read of the host per pump);
        # 1 keeps per-token stepping, the least admission latency
        self.pump_tokens = max(1, int(pump_tokens))
        self._lock = threading.Lock()
        self._pending: Dict[int, dict] = {}  # rid -> request meta
        self._sent: Dict[int, int] = {}      # rid -> tokens already streamed
        self._out: deque = deque()
        self.eos = False
        self.stopped = False

    def submit(self, frame: Frame) -> None:
        prompt = np.asarray(frame.to_host().tensors[0]).reshape(-1).astype(np.int32)
        budget = int(frame.meta.get("max_new_tokens", self.default_new))
        kw = dict(
            temperature=float(frame.meta.get("temperature", 0.0)),
            top_k=int(frame.meta.get("top_k", 0)),
            top_p=float(frame.meta.get("top_p", 1.0)),
        )
        if "seed" in frame.meta:
            kw["seed"] = int(frame.meta["seed"])
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
        streaming, every new token. True if anything advanced."""
        n = self.pump_tokens
        emitted = self.cb.step_pump(n) if n > 1 else self.cb.step()
        harvested = False
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
                harvested = True
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

    def stats(self) -> Dict:
        return self.cb.stats()

    def pop(self):
        with self._lock:
            return self._out.popleft() if self._out else None

    @property
    def drained(self) -> bool:
        with self._lock:
            return self.eos and not self._pending and not self._out


@registry.element("tensor_llm_serversink")
class LlmServerSink(Sink):
    """Submit prompt frames into the paired continuous batcher.

    Props: id (pairing key), model (zoo:transformer_lm), custom (model
    options "k:v,k2:v2"), n-slots, max-len, prompt-len, max-new-tokens
    (per-request default; frame meta ``max_new_tokens`` overrides), stream
    (one frame per new token, then a done frame), pump (tokens per launch
    of ``step_pump``; 1 = per-token steps), cache-dtype (auto | int8),
    attn-impl (xla | pallas; default from ``[llm] attn_impl``), kv-layout
    (slot; default from ``[llm] kv_layout``)."""

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
        "kv-layout": PropSpec("str", "", desc="slot ([llm] default); paged is not ported yet"),
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
        if kv_layout == "paged":
            raise NotImplementedError(
                f"{self.name}: kv-layout=paged (the block arena and kernel K4) is not ported yet"
            )
        if kv_layout != "slot":
            raise ValueError(f"{self.name}: unknown kv-layout {kv_layout!r}")
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
