"""Continuous-batching LLM serving on the slot KV layout.

The counterpart of the slot half of ``nnstreamer_tpu/models/serving.py``:
a fixed batch of ``n_slots`` KV-cache slots, one batched decode step
advancing every active slot per token, and requests joining and leaving
between steps. A request served in a busy batch yields the same greedy
tokens as ``models/decode.generate`` run alone: per-slot positions,
per-slot masks and write gating by ``active`` keep the slots apart.

- Per-slot RoPE positions (``pos`` [B] on the device).
- Cache writes land in place at each active slot's ``pos``; idle slots are
  written back with their own contents, so they never change.
- Prompts up to ``prompt_len`` are right-padded to that bucket and
  prefilled in one forward; longer prompts are prefilled in bucket-sized
  chunks against a staging cache (``decode.verify_chunk``). The pad
  positions are never attended and are overwritten before any mask
  reaches them.
- ``cache_dtype="int8"`` stores the cache quantized (per-token-per-head
  scales, :func:`quantize_kv`), dequantized on the attention read: in the
  K3 kernel when ``attn_impl="pallas"``.
- ``attn_impl`` keeps the reference's names so its pipeline strings run
  unchanged: ``"xla"`` is the inline masked ``cache_attention`` (the
  default), ``"pallas"`` the K3 kernel (``ops/kernels/decode_attention.py``),
  which on CUDA tensors launches the CUDA kernel.
- Sampling (temperature / top-k / top-p) runs on the device with explicit
  ``torch.Generator``s seeded from (request seed, fill level), so a
  request's stream depends only on its seed and its positions, never on
  the batch it shares. Only [B] token ids cross to the host per step.
- Admission: ``submit`` prefills outside the state lock and queues a
  pending insert that the next ``step`` applies, so submitting never waits
  for a decode step, and one read of the host fetches every queued first
  token.

Not ported yet (each raises ``NotImplementedError``): the paged layout,
windowed (ring) caches, draft models and speculative steps, meshes,
prefixes, snapshot/restore and request migration.
"""

from __future__ import annotations

import threading
import time as _time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from nnstreamer_tpu_torch.device import DeviceLike, resolve_device
from nnstreamer_tpu_torch.models import decode as dec
from nnstreamer_tpu_torch.models import transformer as tfm

_MASK63 = (1 << 63) - 1


def _not_ported(what: str):
    return NotImplementedError(f"ContinuousBatcher: {what} is not ported yet")


def quantize_kv(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., H, Dh] float → (int8 of the same shape, float32 scale [..., H]):
    symmetric per-token-per-head scales."""
    t32 = t.float()
    m = torch.clamp(t32.abs().amax(dim=-1), min=1e-8)
    scale = m / 127.0
    q = torch.clamp(torch.round(t32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale[..., None]


def _write_rows(c: torch.Tensor, new: torch.Tensor, wpos: torch.Tensor,
                active: torch.Tensor) -> None:
    """In place: c [B, max_len, ...][b, wpos[b]] ← new[b] where active[b];
    an idle slot's row is written back unchanged."""
    idx = torch.arange(c.shape[0], device=c.device)
    gate = active.view(-1, *([1] * (new.dim() - 1)))
    c[idx, wpos] = torch.where(gate, new.to(c.dtype), c[idx, wpos])


def batched_decode_step(model: tfm.TransformerLM, tok, pos, active, cache, n_heads: int,
                        compute_dtype: torch.dtype = torch.float32, attn_fn=None):
    """One decode step for the whole slot batch.

    tok [B] int, pos [B] int32 (per-slot fill level), active [B] bool →
    (logits [B, V] float32, cache, pos + active). Inactive slots keep
    their cache and pos; their logits are garbage. ``attn_fn(q, ck, cv,
    pos) -> [B,1,H,Dh]`` replaces the inline masked attention (the K3
    kernel); with an int8 cache it receives the quantized entries
    ``(ck8, kscale)`` / ``(cv8, vscale)``. ``cache`` is ``(ck, cv)`` or
    ``((ck8, kscale), (cv8, vscale))``, each [L, B, max_len, KV, Dh]
    (scales [L, B, max_len, KV]), updated in place."""
    quantized = isinstance(cache[0], tuple)
    if quantized:
        (ck8, ksc), (cv8, vsc) = cache
        max_len = ck8.shape[2]
    else:
        ck_all, cv_all = cache
        max_len = ck_all.shape[2]
    x = tfm.embed_lookup(model.embed, tok, compute_dtype)[:, None, :]
    wpos = torch.clamp(pos.long(), 0, max_len - 1)
    mask = None
    for layer, blk in enumerate(model.blocks):
        bsz, _, d = x.shape
        q, k, v = tfm.block_qkv(x, blk, n_heads, pos[:, None])
        if quantized:
            k8, ks = quantize_kv(k[:, 0])
            v8, vs = quantize_kv(v[:, 0])
            _write_rows(ck8[layer], k8, wpos, active)
            _write_rows(ksc[layer], ks, wpos, active)
            _write_rows(cv8[layer], v8, wpos, active)
            _write_rows(vsc[layer], vs, wpos, active)
            lk, lv = (ck8[layer], ksc[layer]), (cv8[layer], vsc[layer])
        else:
            _write_rows(ck_all[layer], k[:, 0], wpos, active)
            _write_rows(cv_all[layer], v[:, 0], wpos, active)
            lk, lv = ck_all[layer], cv_all[layer]
        if attn_fn is not None:
            o = attn_fn(q, lk, lv, pos)
        else:
            if mask is None:
                mask = torch.arange(max_len, device=pos.device)[None, :] <= pos[:, None]
            ck, cv = (dequantize_kv(*lk), dequantize_kv(*lv)) if quantized else (lk, lv)
            o = tfm.cache_attention(q, ck, cv, mask[:, None, :])
        o = o.to(x.dtype).reshape(bsz, 1, -1)
        x = x + F.linear(o, tfm.wt(blk.wo.weight, x.dtype))
        x = tfm.block_ffn(x, blk)
    x = tfm.rmsnorm(x, model.ln_f)
    logits = F.linear(x, tfm.wt(model.head.weight, x.dtype)).float()[:, 0]
    return logits, cache, pos + active.to(pos.dtype)


def _filtered_logits(logits, temp, top_k, top_p):
    """Temperature-scaled, top-k then top-p filtered logits [B, V]: the
    distribution every sampling decision draws from."""
    v = logits.shape[-1]
    scaled = logits / torch.clamp(temp, min=1e-6)[:, None]
    desc = torch.sort(scaled, dim=-1, descending=True).values
    kth = torch.gather(desc, -1, torch.clamp(top_k - 1, 0, v - 1).long()[:, None])
    neg = torch.full_like(scaled, float("-inf"))
    scaled = torch.where((top_k > 0)[:, None] & (scaled < kth), neg, scaled)
    probs = torch.softmax(scaled, dim=-1)
    sp = torch.sort(probs, dim=-1, descending=True).values
    csum = torch.cumsum(sp, dim=-1)
    n_keep = torch.sum(csum < top_p[:, None], dim=-1) + 1
    cutoff = torch.gather(sp, -1, torch.clamp(n_keep - 1, 0, v - 1).long()[:, None])
    return torch.where((top_p < 1.0)[:, None] & (probs < cutoff), neg, scaled)


def sample_seed(seed: int, fill: int) -> int:
    """The generator seed of the token sampled at cache fill ``fill`` of a
    request seeded ``seed`` (a splitmix64 mix of the pair)."""
    z = ((int(seed) & 0xFFFFFFFF) << 32 | (int(fill) & 0xFFFFFFFF)) + 0x9E3779B97F4A7C15
    z &= (1 << 64) - 1
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
    return (z ^ (z >> 31)) & _MASK63


def sample_tokens(logits, temp, top_k, top_p, seeds: List[Optional[int]]) -> torch.Tensor:
    """Per-slot token choice on the logits' device.

    logits [B, V] float32; temp [B] float32 (≤ 0 → greedy); top_k [B]
    (0 → off); top_p [B] float32 (1.0 → off; the nucleus keeps the
    smallest most-probable set with mass ≥ top_p); seeds: one generator
    seed per slot (None for greedy slots) → tok [B] int32. A sampling slot
    draws Gumbel noise from its own ``torch.Generator`` and takes the
    argmax of the filtered logits plus the noise: an exact categorical
    sample."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = _filtered_logits(logits, temp, top_k, top_p)
    noise = torch.zeros_like(scaled)
    for b, seed in enumerate(seeds):
        if seed is None:
            continue
        gen = torch.Generator(device=logits.device)
        gen.manual_seed(seed)
        u = torch.rand(scaled.shape[-1], generator=gen, device=logits.device)
        noise[b] = -torch.log(-torch.log(u))
    sampled = torch.argmax(scaled + noise, dim=-1).to(torch.int32)
    return torch.where(temp > 0, sampled, greedy)


def insert_slot(cache, ks: torch.Tensor, vs: torch.Tensor, slot: int):
    """Write one prefilled request's K/V [L, 1, P, KV, Dh] into cache slot
    ``slot`` in place (quantizing for an int8 cache). Rows past P from a
    previous occupant are harmless: the decode mask only covers rows the
    new occupant has written itself."""
    p = ks.shape[2]
    if isinstance(cache[0], tuple):
        (ck8, ksc), (cv8, vsc) = cache
        k8, kscale = quantize_kv(ks[:, 0])
        v8, vscale = quantize_kv(vs[:, 0])
        ck8[:, slot, :p] = k8
        ksc[:, slot, :p] = kscale
        cv8[:, slot, :p] = v8
        vsc[:, slot, :p] = vscale
    else:
        ck, cv = cache
        ck[:, slot, :p] = ks[:, 0].to(ck.dtype)
        cv[:, slot, :p] = vs[:, 0].to(cv.dtype)
    return cache


@dataclass
class _Request:
    rid: int
    budget: int
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    stop_token: Optional[int] = None
    seed: int = 0
    tokens: List[int] = field(default_factory=list)
    fill0: int = 0  # cache fill at admission; pos = fill0 + len(tokens) - 1

    def finished(self) -> bool:
        """Budget spent, or the stop token was emitted (it stays in the
        output, like an EOS id)."""
        if len(self.tokens) >= self.budget:
            return True
        return bool(self.tokens) and self.tokens[-1] == self.stop_token

    def next_seed(self, ahead: int = 0) -> Optional[int]:
        """Generator seed of the token ``ahead`` steps from now (None when
        greedy): fill level fill0 + len(tokens) + ahead."""
        if self.temperature <= 0:
            return None
        return sample_seed(self.seed, self.fill0 + len(self.tokens) + ahead)


@dataclass
class _PendingInsert:
    """A prefilled request waiting for the next step to splice its K/V
    into the batch cache."""

    slot: int
    ks: torch.Tensor
    vs: torch.Tensor
    first_tok: torch.Tensor  # device int32 scalar, fetched at apply
    fill: int
    req: _Request


class BatcherFailedError(RuntimeError):
    """A step raised after it began updating the cache in place: the
    device state is invalid. Build a new batcher."""


def _dtype(d: Union[str, torch.dtype]) -> torch.dtype:
    if isinstance(d, torch.dtype):
        return d
    try:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[str(d)]
    except KeyError:
        raise ValueError(f"compute dtype {d!r} not supported (float32 or bfloat16)") from None


class ContinuousBatcher:
    """Continuous-batching server over a fixed slot batch (greedy by
    default; per-request temperature/top-k/top-p sampling via submit()).

    ``submit`` may be called at any time from any thread; ``step``
    advances every active slot one token, ``step_pump(n)`` n tokens with
    one read of the host. A finished request frees its slot for the next
    submit. ``device`` (default ``cuda``; raises without a GPU unless
    ``"cpu"``) must be where ``params`` live.

    Failure: the steps update the cache in place, so a step that raises
    leaves the device state invalid; the batcher latches the error and
    every later step/submit raises :class:`BatcherFailedError`."""

    def __init__(
        self,
        params: tfm.TransformerLM,
        n_heads: int,
        n_slots: int = 4,
        max_len: int = 256,
        prompt_len: int = 64,
        compute_dtype: Union[str, torch.dtype] = torch.float32,
        attn_impl: str = "xla",
        keep_results: int = 1024,
        cache_dtype: str = "auto",
        mesh=None,
        windowed: bool = False,
        draft_params=None,
        kv_layout: str = "slot",
        device: DeviceLike = None,
    ):
        if prompt_len > max_len:
            raise ValueError("prompt_len must be ≤ max_len")
        if cache_dtype not in ("auto", "int8"):
            raise ValueError(f"unknown cache_dtype {cache_dtype!r}")
        if kv_layout not in ("slot", "paged"):
            raise ValueError(f"unknown kv_layout {kv_layout!r}")
        if kv_layout == "paged":
            raise _not_ported("kv_layout='paged' (the block arena and kernel K4)")
        for flag, what in (
            (windowed, "windowed=True (the sliding-window ring)"),
            (draft_params is not None, "draft_params (draft models)"),
            (mesh is not None, "mesh= (slot-sharded meshes)"),
        ):
            if flag:
                raise _not_ported(what)
        if attn_impl == "pallas":
            from nnstreamer_tpu_torch.ops.kernels.decode_attention import (
                make_decode_attention,
            )

            attn_fn = make_decode_attention()
        elif attn_impl == "xla":
            attn_fn = None
        else:
            raise ValueError(f"unknown attn_impl {attn_impl!r}")
        self.device = resolve_device(device)
        if params.embed.device != self.device:
            raise ValueError(
                f"params live on {params.embed.device}, the batcher runs on {self.device}"
            )
        self.params = params
        self.n_heads = n_heads
        self.n_slots = n_slots
        self.max_len = max_len
        self.prompt_len = prompt_len
        self.compute_dtype = _dtype(compute_dtype)
        self.cache_dtype = cache_dtype
        self.attn_impl = attn_impl
        self._attn_fn = attn_fn
        self._lock = threading.Lock()       # host state
        self._step_lock = threading.Lock()  # serializes device steps
        self._failed: Optional[BaseException] = None
        self._next_rid = 0
        self._slots: List[Optional[_Request]] = [None] * n_slots
        self._pending: List[_PendingInsert] = []
        # finished requests await pickup; bounded so a caller that never
        # collects cannot grow the host heap without limit
        self._done_pool: "OrderedDict[int, _Request]" = OrderedDict()
        self._keep_results = keep_results

        d = params.d_model
        hd = d // n_heads
        kv = tfm.n_kv_heads_of(params.blocks[0].wqkv.weight, d, n_heads)
        shape = (params.n_layers, n_slots, max_len, kv, hd)
        dev = self.device
        if cache_dtype == "int8":
            self._cache = tuple(
                (torch.zeros(shape, dtype=torch.int8, device=dev),
                 torch.ones(shape[:-1], dtype=torch.float32, device=dev))
                for _ in range(2)
            )
        else:
            self._cache = tuple(
                torch.zeros(shape, dtype=self.compute_dtype, device=dev) for _ in range(2)
            )
        self._tok = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
        self._pos = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
        self._active = np.zeros((n_slots,), bool)
        # chunked prefill stages into a cache padded to a bucket multiple,
        # plus one spare bucket
        self._stage_shape = (params.n_layers, 1, (-(-max_len // prompt_len) + 1) * prompt_len,
                             kv, hd)
        self._n_steps = 0
        self._n_tokens = 0
        self._step_time_s = 0.0

    # -- prefill -------------------------------------------------------------
    def _empty_stage(self):
        return tuple(
            torch.zeros(self._stage_shape, dtype=self.compute_dtype, device=self.device)
            for _ in range(2)
        )

    def _chunk_step(self, tokens: np.ndarray, pos: int, stage, want_logits: bool):
        """One prompt_len bucket of chunked prefill at absolute ``pos``:
        (logits or None, stage, tokens consumed)."""
        P = self.prompt_len
        n = min(P, int(tokens.shape[0]))
        chunk = np.zeros((1, P), np.int64)
        chunk[0, :n] = tokens[:n]
        logits, stage, _ = dec.verify_chunk(
            self.params, torch.as_tensor(chunk, device=self.device), pos, stage,
            self.n_heads, compute_dtype=self.compute_dtype, return_logits=want_logits,
        )
        return logits, stage, n

    def _stage_chunks(self, tokens: np.ndarray, base: int, stage, want_logits: bool):
        """Advance a staging cache with ``tokens`` written at absolute
        positions base .. base + t - 1, one bucket at a time. Returns (the
        final chunk's logits or None, stage)."""
        t = tokens.shape[0]
        cpos = 0
        logits = None
        while cpos < t:
            final = cpos + self.prompt_len >= t
            logits, stage, n = self._chunk_step(
                tokens[cpos:], base + cpos, stage, want_logits and final
            )
            cpos += n
        return logits, stage

    def _sample1(self, logits_row, req: _Request) -> torch.Tensor:
        """The first token, from the prefill's last logits row."""
        if req.temperature <= 0:
            return torch.argmax(logits_row).to(torch.int32)
        dev = logits_row.device
        return sample_tokens(
            logits_row[None, :],
            torch.tensor([req.temperature], dtype=torch.float32, device=dev),
            torch.tensor([req.top_k], dtype=torch.int32, device=dev),
            torch.tensor([req.top_p], dtype=torch.float32, device=dev),
            [req.next_seed()],
        )[0]

    # -- client API ----------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int, temperature: float = 0.0, top_k: int = 0,
               top_p: float = 1.0, seed: Optional[int] = None,
               stop_token: Optional[int] = None, prefix: Optional[int] = None) -> Optional[int]:
        """Claim a free slot for ``prompt`` [T] and prefill it; returns a
        request id, or None when every slot is taken (the caller retries).
        Prompts longer than ``prompt_len`` prefill in bucket-sized chunks.
        Sampling is per request: temperature ≤ 0 is greedy; otherwise a
        softmax sample, optionally top-k and/or top-p filtered, seeded by
        ``seed`` (default: the request id) and the fill level."""
        self._check_failed()
        if prefix is not None:
            raise _not_ported("prefix caching (register_prefix / prefix=)")
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        t = prompt.shape[0]
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be ≥ 1, got {max_new_tokens}")
        if t == 0:
            raise ValueError("empty prompt")
        if t > self.max_len:
            raise ValueError(f"prompt({t}) > max_len {self.max_len}")
        if t + max_new_tokens > self.max_len:
            raise ValueError(
                f"{t}+{max_new_tokens} tokens would overflow max_len={self.max_len}"
            )
        with self._lock:
            # claim only: the slot is owned but inactive while the prefill
            # below runs outside the lock
            slot = next((i for i, r in enumerate(self._slots) if r is None), None)
            if slot is None:
                return None
            rid = self._next_rid
            self._next_rid += 1
            req = _Request(
                rid, max_new_tokens, temperature=temperature, top_k=top_k, top_p=top_p,
                stop_token=stop_token, seed=rid if seed is None else int(seed), fill0=t,
            )
            self._slots[slot] = req
        try:
            P = self.prompt_len
            with torch.no_grad():
                if t <= P:
                    padded = np.zeros((1, P), np.int64)
                    padded[0, :t] = prompt
                    logits, (ks, vs), _ = dec.prefill(
                        self.params, torch.as_tensor(padded, device=self.device),
                        self.n_heads, P, compute_dtype=self.compute_dtype,
                    )
                    logits_row = logits[0, t - 1]
                else:
                    logits, stage = self._stage_chunks(prompt, 0, self._empty_stage(), True)
                    logits_row = logits[0, (t - 1) % P]
                    ks = stage[0][:, :, : self.max_len]
                    vs = stage[1][:, :, : self.max_len]
                first_dev = self._sample1(logits_row, req)
            if max_new_tokens == 1:
                # finishes on its prefill token: nothing to decode
                first = int(first_dev)
                with self._lock:
                    req.tokens.append(first)
                    self._finish(slot)
                return rid
        except Exception:
            # release the claimed slot, or failed prefills would leave
            # every slot claimed and never active
            with self._lock:
                self._slots[slot] = None
            raise
        with self._lock:
            self._pending.append(_PendingInsert(slot, ks, vs, first_dev, t, req))
        return rid

    def _apply_pending(self) -> None:
        """Splice queued admissions into the device state (caller holds
        _step_lock only). Every queued first token comes back in one read."""
        with self._lock:
            batch, self._pending = self._pending, []
        if not batch:
            return
        firsts = torch.stack([p.first_tok.reshape(()) for p in batch]).cpu().numpy()
        with self._lock:
            for p, first in zip(batch, firsts):
                if self._slots[p.slot] is not p.req:
                    continue
                p.req.tokens.append(int(first))
                if p.req.finished():  # a stop token on the prefill token
                    self._finish(p.slot)
                    continue
                insert_slot(self._cache, p.ks, p.vs, p.slot)
                self._tok[p.slot] = int(first)
                self._pos[p.slot] = p.fill
                self._active[p.slot] = True

    def _mark_failed(self, exc: BaseException) -> None:
        if self._failed is None:
            self._failed = exc

    def _check_failed(self) -> None:
        if self._failed is not None:
            raise BatcherFailedError(
                f"batcher is failed: a prior step raised {type(self._failed).__name__}: "
                f"{self._failed}; the cache was updated in place and is invalid — "
                "build a new batcher"
            ) from self._failed

    def _sampling_args(self, active_np, reqs, steps: int):
        """Per-slot temperature/top-k/top-p tensors and, for each of the
        next ``steps`` steps, the slots' generator seeds; None when every
        active slot is greedy."""
        if not any(r is not None and active_np[s] and r.temperature > 0
                   for s, r in enumerate(reqs)):
            return None
        live = [r if (r is not None and active_np[s]) else None for s, r in enumerate(reqs)]
        dev = self.device
        temp = torch.tensor([r.temperature if r else 0.0 for r in live],
                            dtype=torch.float32, device=dev)
        topk = torch.tensor([r.top_k if r else 0 for r in live], dtype=torch.int32, device=dev)
        topp = torch.tensor([r.top_p if r else 1.0 for r in live],
                            dtype=torch.float32, device=dev)
        seeds = [[r.next_seed(i) if r else None for r in live] for i in range(steps)]
        return temp, topk, topp, seeds

    def _decode(self, tok, pos, active, sampling, i: int):
        """One batched step on the device → (new tokens [B], pos')."""
        logits, _, pos2 = batched_decode_step(
            self.params, tok, pos, active, self._cache, self.n_heads,
            self.compute_dtype, attn_fn=self._attn_fn,
        )
        if sampling is None:
            new = torch.argmax(logits, dim=-1).to(torch.int32)
        else:
            temp, topk, topp, seeds = sampling
            new = sample_tokens(logits, temp, topk, topp, seeds[i])
        return torch.where(active, new, tok), pos2

    def step(self) -> Dict[int, int]:
        """Advance every active slot one token; returns {rid: token}."""
        self._check_failed()
        t0 = _time.perf_counter()
        with self._step_lock:
            self._apply_pending()
            with self._lock:
                if not self._active.any():
                    return {}
                active_np = self._active.copy()
                sampling = self._sampling_args(active_np, self._slots, 1)
            try:
                with torch.no_grad():
                    active = torch.as_tensor(active_np, device=self.device)
                    new, pos = self._decode(self._tok, self._pos, active, sampling, 0)
                    toks = new.cpu().numpy()  # [B] ids: the only read of the host
            except Exception as exc:
                self._mark_failed(exc)
                raise
            with self._lock:
                self._tok, self._pos = new, pos
                emitted: Dict[int, int] = {}
                for slot, req in enumerate(self._slots):
                    if req is None or not active_np[slot]:
                        continue
                    req.tokens.append(int(toks[slot]))
                    emitted[req.rid] = int(toks[slot])
                    if req.finished():
                        self._finish(slot)
                self._n_steps += 1
                self._n_tokens += len(emitted)
                self._step_time_s += _time.perf_counter() - t0
                return emitted

    def step_pump(self, n: int = 8) -> Dict[int, List[int]]:
        """Advance every active slot by up to ``n`` tokens with one read of
        the host at the end: budgets and stop tokens are tracked on the
        device, and a slot that finishes mid-pump idles (emits -1) for the
        rest of it. Admissions join at the next pump. Returns {rid: [tokens
        emitted this pump]}."""
        self._check_failed()
        t0 = _time.perf_counter()
        n = int(n)
        with self._step_lock:
            self._apply_pending()
            with self._lock:
                if not self._active.any():
                    return {}
                active_np = self._active.copy()
                sampling = self._sampling_args(active_np, self._slots, n)
                remaining = np.zeros((self.n_slots,), np.int32)
                stop = np.full((self.n_slots,), -1, np.int32)
                for s, req in enumerate(self._slots):
                    if req is not None and active_np[s]:
                        remaining[s] = req.budget - len(req.tokens)
                        if req.stop_token is not None:
                            stop[s] = req.stop_token
            try:
                with torch.no_grad():
                    dev = self.device
                    active = torch.as_tensor(active_np, device=dev)
                    budget = torch.as_tensor(remaining, device=dev)
                    stop_t = torch.as_tensor(stop, device=dev)
                    tok, pos = self._tok, self._pos
                    emits = []
                    for i in range(n):
                        tok, pos = self._decode(tok, pos, active, sampling, i)
                        emits.append(torch.where(active, tok, torch.full_like(tok, -1)))
                        budget = budget - active.to(torch.int32)
                        active = active & (budget > 0) & ~((tok == stop_t) & (stop_t >= 0))
                    emits_np = torch.stack(emits, dim=1).cpu().numpy()  # one [B, n] read
            except Exception as exc:
                self._mark_failed(exc)
                raise
            with self._lock:
                self._tok, self._pos = tok, pos
                out: Dict[int, List[int]] = {}
                n_em = 0
                for s, req in enumerate(self._slots):
                    if req is None or not active_np[s]:
                        continue
                    got = []
                    for t in emits_np[s]:
                        if t < 0:
                            break
                        req.tokens.append(int(t))
                        got.append(int(t))
                        if req.finished():
                            break
                    n_em += len(got)
                    if got:
                        out[req.rid] = got
                    if req.finished():
                        self._finish(s)
                self._n_steps += n
                self._n_tokens += n_em
                self._step_time_s += _time.perf_counter() - t0
                return out

    def _finish(self, slot: int) -> None:
        req = self._slots[slot]
        self._active[slot] = False
        self._done_pool[req.rid] = req
        while len(self._done_pool) > self._keep_results:
            self._done_pool.popitem(last=False)  # evict the oldest uncollected
        self._slots[slot] = None

    def result(self, rid: int) -> Optional[List[int]]:
        """The completed token list of ``rid``, or None while it runs."""
        with self._lock:
            req = self._done_pool.get(rid)
            return list(req.tokens) if req is not None else None

    def partial(self, rid: int) -> Optional[List[int]]:
        """Tokens emitted so far for ``rid`` (running or finished); None for
        an unknown or evicted id."""
        return self.partials([rid]).get(rid)

    def partials(self, rids) -> Dict[int, List[int]]:
        """{rid: tokens so far} for every known rid, in one lock pass."""
        want = set(rids)
        out: Dict[int, List[int]] = {}
        with self._lock:
            for req in self._slots:
                if req is not None and req.rid in want:
                    out[req.rid] = list(req.tokens)
            for rid in want - out.keys():
                if rid in self._done_pool:
                    out[rid] = list(self._done_pool[rid].tokens)
        return out

    def stats(self) -> Dict[str, Any]:
        """Token and step counters and the slot occupancy."""
        with self._lock:
            occupied = sum(r is not None for r in self._slots)
            return {
                "steps": self._n_steps,
                "tokens_emitted": self._n_tokens,
                "tokens_per_step": self._n_tokens / self._n_steps if self._n_steps else 0.0,
                "decode_tok_s": (self._n_tokens / self._step_time_s
                                 if self._step_time_s > 0 else 0.0),
                "slots_occupied": occupied,
                "slots_free": self.n_slots - occupied,
                "results_pending_pickup": len(self._done_pool),
            }

    @property
    def n_free(self) -> int:
        with self._lock:
            return sum(r is None for r in self._slots)

    # -- not ported yet --------------------------------------------------------
    def spec_step(self, *args, **kwargs):
        raise _not_ported("spec_step (speculative decoding)")

    def spec_pump(self, *args, **kwargs):
        raise _not_ported("spec_pump (speculative decoding)")

    def register_prefix(self, *args, **kwargs):
        raise _not_ported("register_prefix (prefix caching)")

    def snapshot(self, *args, **kwargs):
        raise _not_ported("snapshot (warm restart)")

    def restore(self, *args, **kwargs):
        raise _not_ported("restore (warm restart)")

    def extract_request(self, *args, **kwargs):
        raise _not_ported("extract_request (request migration)")

    def adopt_request(self, *args, **kwargs):
        raise _not_ported("adopt_request (request migration)")
