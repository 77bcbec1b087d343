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
- Sampling (temperature / top-k / top-p) runs on the device: Gumbel
  noise from a counter-based hash of (request seed, fill level, vocab
  index), computed with tensor ops (:func:`sample_tokens`), so a
  request's stream depends only on its seed and its positions, never on
  the batch it shares.
- The decode hot loop is one program a pump (the reference's jitted
  ``pump_impl`` / ``paged_pump_impl``): ``step_pump(n)`` runs ``n``
  steps of batched decode, token choice and budget / stop / active
  update over per-slot state that stays on the device between pumps, in
  buffers with fixed addresses; ``step()`` is the ``n = 1`` program. On
  CUDA each (n, greedy or sampling) program is captured once into a CUDA
  graph (``nnstreamer_tpu_torch/capture.py``) and replayed, K3 or K4
  inside it; on the CPU the same program runs eagerly. The host ships the
  pump state only after it changed outside a pump (admission, finish,
  preemption, a per-token step), and reads back one [B, n] token block a
  pump. ``step_eager`` / ``step_pump_eager`` run the body uncaptured:
  the oracle.
- Admission: ``submit`` prefills outside the state lock and queues a
  pending insert that the next ``step`` applies, so submitting never waits
  for a decode step, and one read of the host fetches every queued first
  token.
- ``kv_layout="paged"``: the cache is a block arena behind per-slot block
  tables with prefix sharing, chunked prefill interleaved with decode and
  preemption by eviction (``models/serving_paged.py``, ``kv/``); its
  decode step attends the arena through the tables
  (``kv/block_attn.py``), with ``attn_impl="pallas"`` in the K4 kernel
  (``ops/kernels/paged_attention.py``).

- Speculative decoding (``models/serving_spec.py``): ``spec_step`` and
  ``spec_pump(rounds, k, ngram)`` run whole propose → verify → accept
  rounds as one program each, with n-gram proposals mined from a per-slot
  token history on the device (``_hist``, which every pump and admission
  writes) or from a draft model (``draft_params``, slot layout) whose own
  cache every plain step advances too; ``register_prefix`` prefills a
  shared prefix once for ``submit(prefix=)`` on both layouts.
- ``windowed=True`` (slot layout): max_len becomes a sliding attention
  window over a ring cache. The decode step writes at ``pos % max_len``
  and ``pos`` keeps counting absolute tokens, so RoPE stays exact and the
  ``≤ pos`` liveness mask (K3's too) saturates to the whole ring: each
  token attends the previous max_len. Prompts and generations of any
  length run in the fixed cache; long prompts and prefixes prefill
  through ``decode.windowed_chunk``, the token history is a ring, and
  speculation verifies against the pre-write ring and commits only the
  accepted columns.
- ``snapshot`` / ``restore``: the whole serving state to host memory and
  back into a batcher of the same configuration, written into its fixed
  device buffers. On the paged layout ``extract_request`` /
  ``adopt_request`` / ``resume_from_span`` move one live request as a
  :class:`~nnstreamer_tpu_torch.kv.migrate.RequestSpan` (the reference's
  wire format, ``kv/migrate.py``).
- ``mesh=`` (slot layout): the slot axis is sharded over the mesh's
  ``slots_axis`` (parallel/mesh.py). Each position holds a
  :class:`SlotShard`: its contiguous run of slots' cache (the int8 scales
  with it), per-slot state, token history and draft cache, with the
  weights on its device, its own programs (on CUDA its own CUDA graphs)
  and its own K3 launch counter. Every step, pump and spec pump runs each
  shard's program on its device over its local slots (K3 launched over
  them), and the host gathers the emitted tokens in slot order. Prefill
  runs on the batcher's ``device`` and admission copies each request's
  K/V into its shard. The reference shards the same way (GSPMD over the
  slot axis, its kernel under ``shard_map``), and refuses the paged layout
  with a mesh, as this batcher does.
"""

from __future__ import annotations

import functools
import threading
import time as _time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from nnstreamer_tpu_torch.capture import Captured, capture, replay
from nnstreamer_tpu_torch.device import DeviceLike, resolve_device
from nnstreamer_tpu_torch.models import decode as dec
from nnstreamer_tpu_torch.models import transformer as tfm
from nnstreamer_tpu_torch.models.serving_paged import PagedAdmission
from nnstreamer_tpu_torch.models.serving_spec import SpecDecoding, hist_write_row
from nnstreamer_tpu_torch.models.serving_state import ServingState
from nnstreamer_tpu_torch.ops.kernels import LaunchCounter

_M32 = 0xFFFFFFFF
_M64 = (1 << 64) - 1


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


def write_cols(c: torch.Tensor, new: torch.Tensor, start: torch.Tensor,
               active: torch.Tensor) -> None:
    """In place: c [B, S, ...][b, start[b] + j] ← new[b, j] for the k
    columns of ``new`` [B, k, ...] where active[b]; an idle slot's rows
    are written back unchanged. ``start`` is clamped so that the k
    columns fit, as the reference's ``dynamic_update_slice`` clamps."""
    b, k = new.shape[:2]
    st = torch.clamp(start.long(), 0, c.shape[1] - k)
    idx = st[:, None] + torch.arange(k, device=c.device)[None, :]
    lanes = torch.arange(b, device=c.device)[:, None]
    gate = active.view(-1, 1, *([1] * (new.dim() - 2)))
    c[lanes, idx] = torch.where(gate, new.to(c.dtype), c[lanes, idx])


def batched_decode_step(model: tfm.TransformerLM, tok, pos, active, cache, n_heads: int,
                        compute_dtype: torch.dtype = torch.float32, attn_fn=None,
                        windowed: bool = False):
    """One decode step for the whole slot batch.

    tok [B] int, pos [B] int32 (per-slot fill level), active [B] bool →
    (logits [B, V] float32, cache, pos + active). Inactive slots keep
    their cache and pos; their logits are garbage. ``attn_fn(q, ck, cv,
    pos) -> [B,1,H,Dh]`` replaces the inline masked attention (the K3
    kernel); with an int8 cache it receives the quantized entries
    ``(ck8, kscale)`` / ``(cv8, vscale)``. ``cache`` is ``(ck, cv)`` or
    ``((ck8, kscale), (cv8, vscale))``, each [L, B, max_len, KV, Dh]
    (scales [L, B, max_len, KV]), updated in place.

    ``windowed=True``: the length axis is a ring over the last max_len
    tokens. Writes land at ``pos % max_len``, and nothing else changes:
    the ``≤ pos`` mask (and K3's) saturates to all-live once pos ≥
    max_len, when every row holds one of the last max_len tokens. K rows
    are stored rotated at their absolute positions, so the softmax needs
    only the set of the window's keys, never their ring order."""
    quantized = isinstance(cache[0], tuple)
    if quantized:
        (ck8, ksc), (cv8, vsc) = cache
        max_len = ck8.shape[2]
    else:
        ck_all, cv_all = cache
        max_len = ck_all.shape[2]
    x = tfm.embed_lookup(model.embed, tok, compute_dtype)[:, None, :]
    wpos = pos % max_len if windowed else pos
    mask = None
    for layer, blk in enumerate(model.blocks):
        bsz, _, d = x.shape
        q, k, v = tfm.block_qkv(x, blk, n_heads, pos[:, None])
        if quantized:
            k8, ks = quantize_kv(k)
            v8, vs = quantize_kv(v)
            write_cols(ck8[layer], k8, wpos, active)
            write_cols(ksc[layer], ks, wpos, active)
            write_cols(cv8[layer], v8, wpos, active)
            write_cols(vsc[layer], vs, wpos, active)
            lk, lv = (ck8[layer], ksc[layer]), (cv8[layer], vsc[layer])
        else:
            write_cols(ck_all[layer], k, wpos, active)
            write_cols(cv_all[layer], v, wpos, active)
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


def seed_key(seed: int) -> int:
    """The 32-bit key the device sampler hashes for a request seeded
    ``seed`` (any Python int): the high half of its splitmix64 mix."""
    z = (int(seed) + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return (z ^ (z >> 31)) >> 32


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x · c) mod 2^32 for int64 ``x`` in [0, 2^32) and a 32-bit constant:
    ``c`` in two 16-bit halves, so that no int64 product overflows."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finalizer, a bijection of [0, 2^32), on int64
    tensors."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def gumbel_noise(keys: torch.Tensor, pos: torch.Tensor, vocab: int) -> torch.Tensor:
    """Gumbel noise [B, V] float32 from a counter-based hash of (slot key,
    position, vocab index), computed with tensor ops on the keys' device:
    the same triple always gives the same value, whatever batch it is
    computed in. keys [B] (:func:`seed_key` values), pos [B]."""
    row = _mix32(_mix32(keys.long()) ^ (pos.long() & _M32))
    cols = torch.arange(vocab, dtype=torch.int64, device=keys.device)
    return _gumbel_of_hash(_mix32(_mix32((row[:, None] + cols[None, :]) & _M32)))


def _gumbel_of_hash(h: torch.Tensor) -> torch.Tensor:
    """Gumbel noise float32 from 32-bit hashes ``h`` (int64 in [0, 2^32)).
    The top 23 bits centred in their bin give u in [2^-24, 1 - 2^-24]:
    every value below 2^23 plus one half is exact in float32, so u never
    rounds to 1 (nor reaches 0), and the noise is finite for every hash."""
    u = ((h >> 9).float() + 0.5) * (1.0 / (1 << 23))
    return -torch.log(-torch.log(u))


def sample_tokens(logits, temp, top_k, top_p, keys, pos) -> torch.Tensor:
    """Per-slot token choice on the logits' device, with tensor ops only
    (no host read, so a CUDA graph captures it).

    logits [B, V] float32; temp [B] float32 (≤ 0 → greedy); top_k [B]
    (0 → off); top_p [B] float32 (1.0 → off; the nucleus keeps the
    smallest most-probable set with mass ≥ top_p); keys [B] the slots'
    :func:`seed_key`; pos [B] the cache fill the token is sampled at →
    tok [B] int32. A sampling slot takes the argmax of the filtered logits
    plus :func:`gumbel_noise` keyed by (key, pos): an exact categorical
    sample whose stream depends only on the request's seed and positions
    (the reference keys ``jax.random`` by ``fold_in(key, pos)``)."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = _filtered_logits(logits, temp, top_k, top_p)
    noise = gumbel_noise(keys, pos, scaled.shape[-1])
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
    prompt: Optional[np.ndarray] = None  # the context (paged: what a resume re-prefills)

    def finished(self) -> bool:
        """Budget spent, or the stop token was emitted (it stays in the
        output, like an EOS id)."""
        if len(self.tokens) >= self.budget:
            return True
        return bool(self.tokens) and self.tokens[-1] == self.stop_token


@dataclass
class _PendingInsert:
    """A prefilled request waiting for the next step to splice its K/V
    into the batch cache (slot layout), or to point its table row at its
    landed blocks (paged layout)."""

    slot: int
    ks: Optional[torch.Tensor]
    vs: Optional[torch.Tensor]
    first_tok: Union[torch.Tensor, int]  # device int32 scalar, fetched at apply
    fill: int
    req: _Request
    blocks: Optional[List[int]] = None  # paged: the request's arena blocks
    resumed: bool = False  # paged: a preempted request coming back
    draft_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None  # the draft's K/V
    hist_row: Optional[np.ndarray] = None  # the token history: context, then the first


class _PumpProgram:
    """One entry of the batcher's program cache (the reference jits one
    program per static argument set): a pump of ``n`` decode steps keyed
    (n, sampling), or a spec pump keyed ("spec", rounds, k, g, sampling,
    source). On CUDA ``cap`` holds what the capture made (the graph, the
    output buffer in the graph's pool, the launches one replay stands
    for, the warm-up's launches and host seconds), beside the device
    bytes allocated and reserved across the fill. Elsewhere ``cap`` stays
    None and :meth:`run` runs the body. The program keeps no reference to
    its body, which holds the batcher: a batcher dropped by its owner is
    freed at once, with its cache, not at the next cyclic collection."""

    __slots__ = ("key", "cap", "allocated_bytes", "reserved_bytes", "replays")

    def __init__(self, key: tuple) -> None:
        self.key = key
        self.cap: Optional[Captured] = None
        self.allocated_bytes = 0
        self.reserved_bytes = 0
        self.replays = 0

    def run(self, body) -> torch.Tensor:
        """One run over the batcher's state → the program's output (the
        emitted tokens [B, n], or a spec pump's packed vector): a replay
        of the graph (its buffer, valid until the next replay), or
        ``body`` where nothing was captured."""
        if self.cap is None:
            return body()
        replay(self.cap.graph, self.cap.launches)
        self.replays += 1
        return self.cap.outputs


class SlotShard:
    """One mesh position's run of slots ``[lo, lo + n)``: its device, the
    weights there, the attention fn that counts its own K3 launches
    (``k3_launches``), and (filled by the batcher) its slice of every
    slot-axis buffer, its draft engine and its programs. The pump and spec
    bodies read their state from the holder they are given: the batcher
    itself when unsharded, a shard under a mesh."""

    def __init__(self, index: int, lo: int, n: int, device: torch.device, params,
                 attn_impl: str) -> None:
        self.index, self.lo, self.n = index, lo, n
        self.device = device
        self.params = params
        self.k3_launches = LaunchCounter()
        self._attn_fn = None
        if attn_impl == "pallas":
            from nnstreamer_tpu_torch.ops.kernels.decode_attention import make_decode_attention

            self._attn_fn = make_decode_attention(self.k3_launches)


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


class ContinuousBatcher(PagedAdmission, SpecDecoding, ServingState):
    """Continuous-batching server over a fixed slot batch (greedy by
    default; per-request temperature/top-k/top-p sampling via submit()).

    ``submit`` may be called at any time from any thread; ``step``
    advances every active slot one token, ``step_pump(n)`` n tokens with
    one read of the host, each one pump program (a CUDA-graph replay on
    the card). A finished request frees its slot for the next submit.
    ``device`` (default ``cuda``; raises without a GPU unless ``"cpu"``)
    must be where ``params`` live.

    ``kv_layout="paged"`` keeps the cache as ``kv_blocks`` blocks of
    ``block_size`` tokens (default: enough for every slot at max_len)
    behind per-slot block tables; ``submit`` then only queues the prompt,
    which each step or pump prefills by ≤ ``prefill_chunks`` buckets.
    ``kv_attn`` selects its decode formulation: ``"auto"``/``"block"``
    attend the arena through the tables, ``"gather"`` runs the slot step
    on a gathered contiguous view (the oracle; not with
    ``attn_impl="pallas"``).

    ``draft_params`` (a :class:`TransformerLM` with the target's vocabulary
    and ``draft_n_heads`` heads, slot layout only) makes the speculative
    rounds propose with a draft model instead of n-gram lookup.

    ``windowed=True`` (slot layout only) makes max_len a sliding attention
    window over a ring cache (Mistral's sliding-window attention): prompts
    and generations of any length, each token attending the previous
    max_len.

    ``mesh`` (a :class:`~nnstreamer_tpu_torch.parallel.mesh.Mesh`, slot
    layout only) shards the slots over its ``slots_axis``: ``n_slots`` must
    divide over it, and each position runs its :class:`SlotShard` (see the
    module docstring). ``device`` is where prefill runs and ``params``
    live; a position on another device gets its own copy of the weights.

    Failure: the steps update the cache in place, so a step that raises
    (a failed capture or replay included: nothing falls back to eager
    steps) leaves the device state invalid; the batcher latches the error
    and every later step/submit raises :class:`BatcherFailedError`."""

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
        slots_axis: str = "dp",
        windowed: bool = False,
        draft_params=None,
        draft_n_heads: Optional[int] = None,
        kv_layout: str = "slot",
        block_size: int = 16,
        kv_blocks: Optional[int] = None,
        prefill_chunks: int = 1,
        kv_attn: str = "auto",
        device: DeviceLike = None,
    ):
        if prompt_len > max_len:
            raise ValueError("prompt_len must be ≤ max_len")
        if cache_dtype not in ("auto", "int8"):
            raise ValueError(f"unknown cache_dtype {cache_dtype!r}")
        if kv_layout not in ("slot", "paged"):
            raise ValueError(f"unknown kv_layout {kv_layout!r}")
        if kv_attn not in ("auto", "block", "gather"):
            raise ValueError(f"unknown kv_attn {kv_attn!r}")
        self._paged = kv_layout == "paged"
        self._kv_attn = ""
        if self._paged:
            self._kv_attn = "block" if kv_attn == "auto" else kv_attn
            for flag, why in (
                (windowed, "windowed (ring) caches"),
                (mesh is not None, "mesh-sharded slots"),
                (draft_params is not None, "draft models"),
                (attn_impl not in ("xla", "pallas"), f"attn_impl={attn_impl!r}"),
                (attn_impl == "pallas" and self._kv_attn == "gather",
                 "attn_impl='pallas' with kv_attn='gather' (the paged kernel is "
                 "block-native — drop kv_attn='gather')"),
            ):
                if flag:
                    raise ValueError(
                        f"kv_layout='paged' does not support {why}; use the slot layout"
                    )
            block_size = int(block_size)
            if block_size < 1 or max_len % block_size:
                raise ValueError(f"block_size({block_size}) must divide max_len({max_len})")
            if prompt_len % block_size:
                raise ValueError(
                    f"block_size({block_size}) must divide prompt_len({prompt_len}) so "
                    "staged prefill chunks land on block boundaries"
                )
        elif kv_attn != "auto":
            raise ValueError(
                "kv_attn selects the paged decode formulation; the slot layout has no "
                "block table to attend through"
            )
        if mesh is not None:
            from nnstreamer_tpu_torch.parallel.mesh import Mesh

            if not isinstance(mesh, Mesh):
                raise TypeError(f"mesh= takes a parallel.mesh.Mesh, got {type(mesh).__name__}")
            n_mesh = mesh.axis_size(slots_axis)
            if n_slots % n_mesh:
                raise ValueError(f"n_slots={n_slots} must divide over mesh axis "
                                 f"{slots_axis!r} (size {n_mesh})")
        if attn_impl == "pallas" and self._paged:
            from nnstreamer_tpu_torch.ops.kernels.paged_attention import make_paged_attention

            attn_fn = make_paged_attention()
        elif attn_impl == "pallas":
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
        self.windowed = bool(windowed)
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
        # per-request SLO accounting (kv/sched.py), its histograms on the
        # metrics registry when one is on
        from nnstreamer_tpu_torch.kv.sched import SLOLedger
        from nnstreamer_tpu_torch.obs import metrics as obs_metrics

        self._obs_reg = obs_metrics.get()
        self._slo = SLOLedger(keep=keep_results, obs_registry=self._obs_reg)

        d = params.d_model
        hd = d // n_heads
        kv = tfm.n_kv_heads_of(params.blocks[0].wqkv.weight, d, n_heads)
        shape = (params.n_layers, n_slots, max_len, kv, hd)
        dev = self.device
        self._shards: Optional[List[SlotShard]] = None
        if self._paged:
            self._init_paged(params.n_layers, kv, hd, block_size, kv_blocks, prefill_chunks,
                             cache_dtype == "int8")
            self._alloc_slot_state(self, None, n_slots, max_len)
        elif mesh is None:
            self._alloc_slot_state(self, shape, n_slots, max_len)
        else:
            import copy

            per = n_slots // mesh.axis_size(slots_axis)
            self._shards = []
            for i, sdev in enumerate(mesh.along(slots_axis)):
                sparams = params if sdev == dev else copy.deepcopy(params).to(sdev)
                sh = SlotShard(i, i * per, per, sdev, sparams, attn_impl)
                self._alloc_slot_state(sh, (shape[0], per) + shape[2:], per, max_len)
                self._shards.append(sh)
        self.mesh = mesh
        self._active = np.zeros((n_slots,), bool)
        self._pump_state_dirty = True
        self._host_state_builds = 0
        # chunked prefill stages into a cache padded to a bucket multiple,
        # plus one spare bucket
        self._stage_len = (-(-max_len // prompt_len) + 1) * prompt_len
        self._stage_shape = (params.n_layers, 1, self._stage_len, kv, hd)
        # a windowed request's prefill ring: one slot's cache
        self._ring_shape = (params.n_layers, 1, max_len, kv, hd)
        self._n_steps = 0
        self._n_tokens = 0
        self._step_time_s = 0.0
        self._init_spec(draft_params, draft_n_heads)

    def _alloc_slot_state(self, st, cache_shape: Optional[Tuple[int, ...]], n: int,
                          max_len: int) -> None:
        """Give ``st`` (the batcher, or a shard) the device state of ``n``
        slots on ``st.device``: the cache (``cache_shape``; None: the paged
        arena is the batcher's own) and the per-slot buffers, the pump
        programs' operands. Their addresses are fixed for the batcher's
        life: admission sets a slot's entries and the programs write the
        carried state back in place, so a captured program never reads a
        stale buffer."""
        dev = st.device
        if cache_shape is not None and self.cache_dtype == "int8":
            st._cache = tuple(
                (torch.zeros(cache_shape, dtype=torch.int8, device=dev),
                 torch.ones(cache_shape[:-1], dtype=torch.float32, device=dev))
                for _ in range(2)
            )
        elif cache_shape is not None:
            st._cache = tuple(torch.zeros(cache_shape, dtype=self.compute_dtype, device=dev)
                              for _ in range(2))
        i32 = dict(dtype=torch.int32, device=dev)
        st._tok = torch.zeros((n,), **i32)
        st._pos = torch.zeros((n,), **i32)
        st._temp = torch.zeros((n,), dtype=torch.float32, device=dev)
        st._topk = torch.zeros((n,), **i32)
        st._topp = torch.ones((n,), dtype=torch.float32, device=dev)
        st._keys = torch.zeros((n,), dtype=torch.int64, device=dev)  # seed_key per slot
        # device-carried pump state: budgets left, stop ids and the active
        # mask. The programs compute their next values, so the host rebuilds
        # and ships them only when the dirty flag says a slot changed outside
        # a pump (admission, finish, preemption, a per-token step); a steady
        # pump-only drain ships none (_host_state_builds counts the builds)
        st._active_dev = torch.zeros((n,), dtype=torch.bool, device=dev)
        st._budget_dev = torch.zeros((n,), **i32)
        st._stop_dev = torch.full((n,), -1, **i32)
        # the per-slot token history (-1 padded; hist[pos] the pending
        # token): what the n-gram miner scans. Admission writes a slot's
        # context, every plain and spec program the tokens it emits, so a
        # spec round after plain steps mines the whole context
        st._hist = torch.full((n, max_len), -1, **i32)
        # (n, sampling) or ("spec", rounds, k, g, sampling, source) -> the
        # program (the reference's jit cache); on CUDA every program's graph
        # draws on one memory pool of its holder (replays are serialized by
        # _step_lock and each output is read before the next run), so the
        # pool holds the largest program's intermediates, not their sum
        st._programs = {}
        st._graph_pool = None

    def _slot_states(self) -> List[Tuple[Any, int]]:
        """(state holder, its first slot) of each run of slots: the batcher
        itself unsharded, each shard under a mesh."""
        if self._shards is None:
            return [(self, 0)]
        return [(sh, sh.lo) for sh in self._shards]

    def _slot_state(self, slot: int) -> Tuple[Any, int]:
        """(the holder of ``slot``, its index there)."""
        if self._shards is None:
            return self, slot
        sh = self._shards[slot // self._shards[0].n]
        return sh, slot - sh.lo

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

    def _stage_ring(self, tokens: np.ndarray, base: int = 0, ring=None,
                    want_logits: bool = True):
        """Windowed chunked prefill: advance a W-ring with ``tokens``
        written at absolute positions base .. base + t - 1, one bucket a
        :func:`decode.windowed_chunk` (exact sliding-window attention).
        ``ring`` seeds the cache (a registered prefix's ring, copied, so
        the stored one survives; zeros when None); ``base`` is a bucket
        multiple (register_prefix enforces it), so no chunk wraps the ring
        mid-write. → (the final chunk's logits or None, the ring (ks, vs),
        the last real row's index in that chunk)."""
        P = self.prompt_len
        if ring is None:
            ring = tuple(torch.zeros(self._ring_shape, dtype=self.compute_dtype,
                                     device=self.device) for _ in range(2))
        else:
            ring = (ring[0].clone(), ring[1].clone())
        t = int(tokens.shape[0])
        cpos = 0
        logits = None
        while cpos < t:
            n = min(P, t - cpos)
            chunk = np.zeros((1, P), np.int64)
            chunk[0, :n] = tokens[cpos:cpos + n]
            logits, ring, _ = dec.windowed_chunk(
                self.params, torch.as_tensor(chunk, device=self.device), base + cpos, n, ring,
                self.n_heads, compute_dtype=self.compute_dtype,
                return_logits=want_logits and cpos + n >= t,
            )
            cpos += n
        return logits, ring, (t - 1) % P

    def _sample1(self, logits_row, req: _Request) -> torch.Tensor:
        """The first token, from the prefill's last logits row, sampled at
        fill ``fill0`` as the decode steps sample at theirs."""
        if req.temperature <= 0:
            return torch.argmax(logits_row).to(torch.int32)
        dev = logits_row.device
        return sample_tokens(
            logits_row[None, :],
            torch.tensor([req.temperature], dtype=torch.float32, device=dev),
            torch.tensor([req.top_k], dtype=torch.int32, device=dev),
            torch.tensor([req.top_p], dtype=torch.float32, device=dev),
            torch.tensor([seed_key(req.seed)], dtype=torch.int64, device=dev),
            torch.tensor([req.fill0 + len(req.tokens)], dtype=torch.int32, device=dev),
        )[0]

    def _new_request(self, budget: int, temperature: float, top_k: int, top_p: float,
                     seed: Optional[int], stop_token: Optional[int], fill0: int) -> _Request:
        """A request with the next id (caller holds _lock)."""
        rid = self._next_rid
        self._next_rid += 1
        return _Request(rid, budget, temperature=temperature, top_k=top_k, top_p=top_p,
                        stop_token=stop_token, seed=rid if seed is None else int(seed),
                        fill0=fill0)

    # -- client API ----------------------------------------------------------
    def _obs_counter(self, name: str, **labels) -> None:
        """One count on the metrics registry's counter ``name`` (nothing
        when no registry is on)."""
        reg = getattr(self, "_obs_reg", None)
        if reg is not None:
            reg.counter(name, **labels).inc()

    def submit(self, prompt, max_new_tokens: int, temperature: float = 0.0, top_k: int = 0,
               top_p: float = 1.0, seed: Optional[int] = None,
               stop_token: Optional[int] = None, prefix: Optional[int] = None,
               deadline_s: Optional[float] = None) -> Optional[int]:
        """Claim a free slot for ``prompt`` [T] and prefill it; returns a
        request id, or None when every slot is taken (the caller retries).
        Prompts longer than ``prompt_len`` prefill in bucket-sized chunks;
        a paged batcher only queues the prompt here (see the class).
        Sampling is per request: temperature ≤ 0 is greedy; otherwise a
        softmax sample, optionally top-k and/or top-p filtered, seeded by
        ``seed`` (default: the request id) and the fill level. ``prefix``
        (a :meth:`register_prefix` id) puts the registered tokens before
        ``prompt``: the slot layout starts from their stored K/V, the
        paged layout's prefix index finds their blocks. A windowed batcher
        takes prompts and budgets of any length (its ring keeps the last
        max_len tokens); a prompt longer than prompt_len, or one behind a
        prefix, needs max_len to be a multiple of prompt_len, checked
        before any slot is claimed. ``deadline_s`` is SLO accounting only
        (:meth:`requests`), never an eviction trigger."""
        self._check_failed()
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        t = prompt.shape[0]
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be ≥ 1, got {max_new_tokens}")
        if t == 0:
            raise ValueError("empty prompt")
        pfx = None
        plen = 0
        context = prompt
        if prefix is not None:
            with self._lock:
                pfx = self._prefix_locked(prefix)
            pfx_tokens = pfx[0] if self._paged else pfx[2]
            plen = int(pfx_tokens.shape[0])
            context = np.concatenate([pfx_tokens.astype(np.int64), prompt])
        if (self.windowed and (t > self.prompt_len or pfx is not None)
                and self.max_len % self.prompt_len):
            # ring chunked prefill needs bucket-aligned chunks: a chunk
            # that wrapped mid-write would overwrite live entries
            raise ValueError(
                f"windowed long prompts need max_len({self.max_len}) to be a multiple of "
                f"prompt_len({self.prompt_len}) so prefill chunks never wrap the ring mid-chunk"
            )
        if not self.windowed and plen + t > self.max_len:
            raise ValueError(f"prefix({plen}) + prompt({t}) > max_len {self.max_len}")
        if not self.windowed and plen + t + max_new_tokens > self.max_len:
            raise ValueError(
                f"{plen}+{t}+{max_new_tokens} tokens would overflow max_len={self.max_len} "
                "(windowed=True lifts this: the cache becomes a sliding ring)"
            )
        if self._paged:
            return self._submit_paged(context.astype(np.int32), max_new_tokens, temperature,
                                      top_k, top_p, seed, stop_token, deadline_s)
        fill = plen + t
        with self._lock:
            # claim only: the slot is owned but inactive while the prefill
            # below runs outside the lock
            slot = next((i for i, r in enumerate(self._slots) if r is None), None)
            if slot is None:
                return None
            req = self._new_request(max_new_tokens, temperature, top_k, top_p, seed,
                                    stop_token, fill0=fill)
            req.prompt = context.astype(np.int32)
            rid = req.rid
            self._slots[slot] = req
            self._slo.submit(rid, deadline_s)
        try:
            P = self.prompt_len
            with torch.no_grad():
                if self.windowed and (pfx is not None or t > P):
                    # ring chunked prefill: a registered prefix's ring seeds
                    # it, the prompt continuing at plen (a bucket multiple)
                    logits, (ks, vs), last = self._stage_ring(
                        prompt, plen, pfx[0] if pfx is not None else None)
                    logits_row = logits[0, last]
                elif pfx is not None:
                    # chunked from the prefix's stored K/V at position plen
                    logits, stage = self._stage_chunks(prompt, plen, self._load_prefix(pfx),
                                                       True)
                    logits_row = logits[0, (t - 1) % P]
                    ks = stage[0][:, :, : self.max_len]
                    vs = stage[1][:, :, : self.max_len]
                elif t <= P:
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
            # the draft's K/V of the whole context, outside the state lock
            draft_kv = (self._draft.prefill_tokens(req.prompt)
                        if self._draft is not None else None)
        except Exception:
            # release the claimed slot, or failed prefills would leave
            # every slot claimed and never active
            with self._lock:
                self._slots[slot] = None
            raise
        with self._lock:
            self._pending.append(_PendingInsert(slot, ks, vs, first_dev, fill, req,
                                                draft_kv=draft_kv,
                                                hist_row=self._hist_row(req.prompt)))
        return rid

    def _hist_row(self, context: np.ndarray) -> np.ndarray:
        """A slot's token-history row: the context, -1 after it (the
        first token joins at admission). A windowed context longer than
        the history keeps its last max_len tokens in ring layout (the
        token at absolute position a at a % max_len, as the KV ring)."""
        H = self.max_len
        row = np.full((H,), -1, np.int32)
        n = int(context.shape[0])
        if n <= H or not self.windowed:
            row[:min(n, H)] = context[:H]
        else:
            span = np.arange(n - H, n)
            row[span % H] = context[span]
        return row

    def _apply_pending(self) -> None:
        """Splice queued admissions into the device state (caller holds
        _step_lock only). Every queued first token comes back in one read
        (a resumed paged request's is already known)."""
        with self._lock:
            batch, self._pending = self._pending, []
        if not batch:
            return
        firsts = torch.stack([
            torch.as_tensor(p.first_tok, dtype=torch.int32, device=self.device).reshape(())
            for p in batch
        ]).cpu().numpy()
        with self._lock:
            self._pump_state_dirty = True  # admission changes the pump state
            for p, first in zip(batch, firsts):
                if self._slots[p.slot] is not p.req:
                    continue
                if p.blocks is not None:
                    # the table row first, so a finish below frees the blocks
                    self._set_table_locked(p.slot, p.blocks)
                self._slo.admitted(p.req.rid)
                if not p.resumed:
                    p.req.tokens.append(int(first))
                    self._slo.first_token(p.req.rid)
                    if p.req.finished():  # budget one, or a stop token on it
                        self._finish(p.slot)
                        continue
                st, ls = self._slot_state(p.slot)
                if p.blocks is None:
                    insert_slot(st._cache, p.ks, p.vs, ls)
                if p.draft_kv is not None:
                    st._draft.admit(ls, p.draft_kv)
                if p.hist_row is not None:
                    if p.fill < self.max_len:
                        p.hist_row[p.fill] = first
                    elif self.windowed:
                        p.hist_row[p.fill % self.max_len] = first
                    st._hist[ls].copy_(torch.from_numpy(p.hist_row))
                req = p.req
                st._tok[ls] = int(first)
                st._pos[ls] = p.fill
                st._temp[ls] = req.temperature
                st._topk[ls] = req.top_k
                st._topp[ls] = req.top_p
                st._keys[ls] = seed_key(req.seed)
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

    def _decode_logits(self, st, tok, pos, active, tables):
        """One batched decode step of holder ``st``'s slots on its device →
        (logits [B, V], pos'). The paged layout attends through its device
        block tables."""
        if not self._paged:
            logits, _, pos2 = batched_decode_step(
                st.params, tok, pos, active, st._cache, self.n_heads,
                self.compute_dtype, attn_fn=st._attn_fn, windowed=self.windowed,
            )
        elif self._kv_attn == "gather":
            from nnstreamer_tpu_torch.kv import gather as kvg

            # the oracle: the slot step on a gathered view, the written
            # window scattered back
            view = kvg.gather_cache(self._cache, tables)
            logits, view, pos2 = batched_decode_step(
                self.params, tok, pos, active, view, self.n_heads, self.compute_dtype,
            )
            kvg.scatter_window(self._cache, tables, view, pos, 1, active)
        else:
            from nnstreamer_tpu_torch.kv.block_attn import batched_decode_step_block

            logits, _, pos2 = batched_decode_step_block(
                self.params, tok, pos, active, self._cache, tables, self.n_heads,
                self.compute_dtype, attn_fn=self._attn_fn,
            )
        return logits, pos2

    def _pump_body(self, st, n: int, sampling: bool) -> torch.Tensor:
        """The pump program's body (the reference's ``pump_impl`` /
        ``paged_pump_impl`` scan, unrolled ``n`` times): each step the
        draft's step (with a draft model), the batched decode, the token
        choice, its entry in the token history, then the budget / stop /
        active update, over the device-carried state; the carried state is
        written back into its buffers → the emitted tokens [B, n] int32, -1
        on a lane that was idle. The state is holder ``st``'s (the batcher,
        or one mesh shard's slots). Only device work and no host read: on
        CUDA it is captured, elsewhere (and as the oracle) it runs as it
        is."""
        tok, pos = st._tok, st._pos
        active, budget, stop = st._active_dev, st._budget_dev, st._stop_dev
        tables = self._tables_dev if self._paged else None
        emits = []
        for _ in range(n):
            if st._draft is not None:
                # the draft takes the pending token's K/V in lockstep, so a
                # later spec round proposes from a whole cache
                st._draft.advance_one(tok, pos, active)
            logits, pos2 = self._decode_logits(st, tok, pos, active, tables)
            if sampling:
                # keyed by the fill the token is sampled at, as fold_in(key, pos2)
                new = sample_tokens(logits, st._temp, st._topk, st._topp, st._keys, pos2)
            else:
                new = torch.argmax(logits, dim=-1).to(torch.int32)
            new = torch.where(active, new, tok)
            emits.append(torch.where(active, new, torch.full_like(new, -1)))
            hist_write_row(st._hist, new[:, None], pos2, active.to(torch.int32),
                           wrap=self.windowed)
            budget = budget - active.to(torch.int32)
            active = active & (budget > 0) & ~((new == stop) & (stop >= 0))
            tok, pos = new, pos2
        st._tok.copy_(tok)
        st._pos.copy_(pos)
        st._active_dev.copy_(active)
        st._budget_dev.copy_(budget)
        return torch.stack(emits, dim=1)

    def _program(self, st, key: tuple, body) -> "_PumpProgram":
        """Holder ``st``'s program of ``key``, filled at its first use: on
        CUDA a CUDA graph of ``body`` on ``st``'s device. The warm-up and the
        capture run with every lane idle, so they leave the live state as it
        was: idle slots write back their own cache, history and draft rows,
        idle paged lanes scratch block 0's init values, and tok, pos and
        budget stay. Caller holds _step_lock."""
        prog = st._programs.get(key)
        if prog is None:
            prog = _PumpProgram(key)
            dev = st.device
            if dev.type == "cuda":
                allocated = torch.cuda.memory_allocated(dev)
                reserved = torch.cuda.memory_reserved(dev)
                live = st._active_dev.clone()
                st._active_dev.zero_()
                if st._graph_pool is None:
                    st._graph_pool = torch.cuda.graph_pool_handle()
                prog.cap = capture(body, dev, pool=st._graph_pool)
                st._active_dev.copy_(live)
                prog.allocated_bytes = torch.cuda.memory_allocated(dev) - allocated
                prog.reserved_bytes = torch.cuda.memory_reserved(dev) - reserved
            st._programs[key] = prog
        return prog

    def _admit(self) -> None:
        """The start of every step and pump: advance the paged prefill
        queue, then splice the queued admissions in. Both write the cache
        in place, so a raise latches the failure. Caller holds
        _step_lock."""
        try:
            with torch.no_grad():
                if self._paged:
                    self._advance_prefill()
                self._apply_pending()
        except Exception as exc:
            self._mark_failed(exc)
            raise

    def _pump_state_locked(self) -> None:
        """Bring the device-carried pump state (budgets left, stop ids,
        the active mask) up to date: rebuilt from the host and shipped only
        when the dirty flag is set (reference ``_pump_state_locked``).
        Caller holds _lock."""
        if not self._pump_state_dirty:
            return
        budget = np.zeros((self.n_slots,), np.int32)
        stop = np.full((self.n_slots,), -1, np.int32)
        for s, req in enumerate(self._slots):
            if req is not None and self._active[s]:
                budget[s] = req.budget - len(req.tokens)
                if req.stop_token is not None:
                    stop[s] = req.stop_token
        for st, lo in self._slot_states():
            hi = lo + st._tok.shape[0]
            st._budget_dev.copy_(torch.from_numpy(budget[lo:hi]))
            st._stop_dev.copy_(torch.from_numpy(stop[lo:hi]))
            st._active_dev.copy_(torch.from_numpy(self._active[lo:hi]))
        self._pump_state_dirty = False
        self._host_state_builds += 1

    def _prepare_locked(self, room: int):
        """Ready the device state for one program: (paged) blocks for the
        next ``room`` token writes of every active slot, the tables and
        the pump state shipped if they changed → (the active mask the
        program starts from, whether any active slot samples). Caller
        holds _lock (and _step_lock)."""
        if self._paged:
            if room > 0:
                # may preempt, which marks the pump state and tables dirty
                self._ensure_decode_room_locked(room)
            if self._kv_attn == "gather":
                self._n_gather_dispatch += 1
                self._obs_counter("nns_kv_gather_dispatch_total")
            self._tables_device_locked()
        active_np = self._active.copy()
        sampling = any(r is not None and active_np[s] and r.temperature > 0
                       for s, r in enumerate(self._slots))
        self._pump_state_locked()
        return active_np, sampling

    def _launch(self, key: tuple, body, eager: bool) -> List[np.ndarray]:
        """One run of the program of ``key`` on every holder of slots (a
        replay on CUDA; ``eager`` runs ``body(st)`` instead, the oracle),
        all launched before the first read of the host → each holder's
        output, in slot order. A raise latches the failure: the cache was
        written in place."""
        try:
            with torch.no_grad():
                outs = []
                for st, _ in self._slot_states():
                    run = functools.partial(body, st)
                    outs.append(run() if eager else self._program(st, key, run).run(run))
                return [o.cpu().numpy() for o in outs]
        except Exception as exc:
            self._mark_failed(exc)
            raise

    def _pump(self, n: int, eager: bool):
        """Run ``n`` decode steps of every active slot as one program:
        admissions first, then (paged) blocks for the next ``n`` writes,
        the pump state and tables shipped if they changed, one run of the
        program and ONE [B, n] read of the host. → (the active mask the
        program started from, the emitted tokens [B, n]), or None when no
        slot is active. Caller holds _step_lock."""
        self._admit()
        with self._lock:
            if not self._active.any():
                return None
            active_np, sampling = self._prepare_locked(n)
        outs = self._launch((n, sampling),
                            lambda st: self._pump_body(st, n, sampling), eager)
        return active_np, np.concatenate(outs, axis=0)

    def _harvest_locked(self, active_np, emits_np, steps: int,
                        t0: float) -> Dict[int, List[int]]:
        """Append each slot's emitted tokens to its request up to its
        finish (budget or stop token) → {rid: tokens this run}, finishing
        those requests. ``emits_np`` is [B, n] (a pump: -1 once a lane
        idles) or [B, rounds, k] (a spec pump: each round's row ends at
        its first -1). Caller holds _lock."""
        out: Dict[int, List[int]] = {}
        n_em = 0
        rows_of = emits_np if emits_np.ndim == 3 else emits_np[:, None, :]
        for s, req in enumerate(self._slots):
            if req is None or not active_np[s]:
                continue
            got = []
            for row in rows_of[s]:
                for t in row:
                    if t < 0:
                        break
                    req.tokens.append(int(t))
                    got.append(int(t))
                    if req.finished():
                        break
                if req.finished():
                    break
            n_em += len(got)
            if got:
                out[req.rid] = got
            if req.finished():
                self._finish(s)
        self._n_steps += steps
        self._n_tokens += n_em
        self._step_time_s += _time.perf_counter() - t0
        return out

    def step(self) -> Dict[int, int]:
        """Advance every active slot one token (the n = 1 pump program);
        returns {rid: token}."""
        return self._run(1, eager=False, per_token=True)

    def step_eager(self) -> Dict[int, int]:
        """:meth:`step` with the program's body run eagerly, never
        captured: the oracle a replay is held against."""
        return self._run(1, eager=True, per_token=True)

    def step_pump(self, n: int = 8) -> Dict[int, List[int]]:
        """Advance every active slot by up to ``n`` tokens in one program
        (one CUDA-graph replay on the card) with one read of the host at
        the end: budgets and stop tokens are tracked on the device, and a
        slot that finishes mid-pump idles (emits -1) for the rest of it.
        Admissions join at the next pump. Returns {rid: [tokens emitted
        this pump]}."""
        return self._run(n, eager=False, per_token=False)

    def step_pump_eager(self, n: int = 8) -> Dict[int, List[int]]:
        """:meth:`step_pump` with the program's body run eagerly, never
        captured: the oracle a replay is held against."""
        return self._run(n, eager=True, per_token=False)

    def _run(self, n: int, eager: bool, per_token: bool):
        self._check_failed()
        t0 = _time.perf_counter()
        n = int(n)
        if n < 1:
            raise ValueError(f"step_pump needs n >= 1, got {n}")
        with self._step_lock:
            return self._run_locked(n, eager, per_token, t0)

    def _run_locked(self, n: int, eager: bool, per_token: bool, t0: float):
        """A pump of ``n`` and its harvest; caller holds _step_lock."""
        got = self._pump(n, eager)
        if got is None:
            return {}
        with self._lock:
            out = self._harvest_locked(*got, n, t0)
            if not per_token:
                return out
            # the host-stepped path (reference _plain_step_locked): the
            # pump state rebuilds at the next pump
            self._pump_state_dirty = True
            return {rid: toks[0] for rid, toks in out.items()}

    def _finish(self, slot: int) -> None:
        req = self._slots[slot]
        self._active[slot] = False
        self._pump_state_dirty = True  # the slot leaves the batch
        if self._paged:
            self._release_blocks_locked(slot)
        self._slo.finished(req.rid, len(req.tokens))
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

    def requests(self) -> Dict[int, Dict[str, Any]]:
        """The per-request view behind ``nns-top --requests``: from the SLO
        ledger, each request's state (queued / prefilling / decoding / done
        / migrated), queue / TTFT / TPOT milliseconds, tokens, preemptions
        and deadline headroom; a live one adds its slot and token count,
        and on the paged layout the KV blocks it holds."""
        with self._lock:
            extra: Dict[int, Dict[str, Any]] = {}
            for s, req in enumerate(self._slots):
                if req is None:
                    continue
                row: Dict[str, Any] = {"slot": s, "tokens": len(req.tokens)}
                if self._paged:
                    row["blocks"] = int(self._n_alloc[s])
                extra[req.rid] = row
            return self._slo.view(extra)

    def _program_name(self, key: tuple) -> str:
        """The name of a program: layout, n (a pump) or spec-r<rounds>-
        k<k>-g<g>-<source> (a spec pump), greedy or sampling, cache dtype,
        attn_impl (the first and the last two are the batcher's own)."""
        layout = f"paged-{self._kv_attn}" if self._paged else "slot"
        cache = "int8" if self.cache_dtype == "int8" else str(self.compute_dtype)[6:]
        if key[0] == "spec":
            _, r, k, g, sampling, source = key
            what = f"spec-r{r}-k{k}-g{g}-{source}"
        else:
            n, sampling = key
            what = f"n{n}"
        return "/".join((layout, what, "sampling" if sampling else "greedy", cache,
                         self.attn_impl))

    def stats(self) -> Dict[str, Any]:
        """Token and step counters and the slot occupancy; the programs
        filled, by key (captured or not, replays, the fill's host seconds,
        warm-up launches and device bytes), their total ``build_s`` and
        ``host_state_builds``; the speculative counters (rounds, accepted
        tokens, proposal columns, the acceptance rate, the spec programs
        filled, each fallback of ``spec_step``) and the registered
        prefixes; a paged batcher adds the pool's ``kv_*`` counters."""
        with self._lock:
            occupied = sum(r is not None for r in self._slots)
            programs = {}
            for holder, _ in self._slot_states():
                for p in list(holder._programs.values()):
                    name = self._program_name(p.key)
                    if self._shards is not None:
                        name = f"shard{holder.index}/{name}"
                    programs[name] = {
                        "captured": p.cap is not None, "replays": p.replays,
                        "build_s": p.cap.build_s if p.cap else 0.0,
                        "warmup_launches": p.cap.warmup_launches if p.cap else 0,
                        "allocated_bytes": p.allocated_bytes,
                        "reserved_bytes": p.reserved_bytes,
                    }
            st = {
                "steps": self._n_steps,
                "tokens_emitted": self._n_tokens,
                "tokens_per_step": self._n_tokens / self._n_steps if self._n_steps else 0.0,
                "decode_tok_s": (self._n_tokens / self._step_time_s
                                 if self._step_time_s > 0 else 0.0),
                "slots_occupied": occupied,
                "slots_free": self.n_slots - occupied,
                "results_pending_pickup": len(self._done_pool),
                "programs": programs,
                "programs_filled": len(programs),
                "build_s": sum(p["build_s"] for p in programs.values()),
                "host_state_builds": self._host_state_builds,
                "spec_programs_filled": sum(k[0] == "spec" for h, _ in self._slot_states()
                                            for k in h._programs),
                **self._spec_stats_locked(),
            }
            if self._paged:
                st.update(self._paged_stats_locked())
            if self._shards is not None:
                st["mesh"] = {
                    "devices": len(self._shards),
                    "slots_per_device": self._shards[0].n,
                    "k3_launches": [sh.k3_launches.count for sh in self._shards],
                }
            return st

    @property
    def shards(self) -> Tuple[SlotShard, ...]:
        """The mesh positions' slot shards, in slot order (none unsharded)."""
        return tuple(self._shards or ())

    @property
    def n_free(self) -> int:
        with self._lock:
            return sum(r is None for r in self._slots)
