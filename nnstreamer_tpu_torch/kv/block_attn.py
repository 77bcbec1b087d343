"""Block-native paged decode: attention straight off the arena.

The counterpart of ``nnstreamer_tpu/kv/block_attn.py``, the formulation
the paged batcher runs by default (``ContinuousBatcher(kv_attn="auto" |
"block")``):

- the attention read goes through the block tables inside each layer:
  with ``attn_fn`` (the K4 kernel, ``ops/kernels/paged_attention.py``) the
  arena is attended in place and no view is ever made; without it, the
  inline path takes one layer's transient view (:func:`_take_layer`),
  writes the pending token into it and runs the slot step's masked
  attention on it, so its streams equal the slot layout's exactly;
- the write is :func:`write_fresh_window`: the freshly computed K/V of
  every layer lands in its owning arena block with one indexed write per
  arena leaf after the layer loop, in place (the reference donates the
  arena and returns a new one). Inactive lanes write scratch block 0's
  init values, so scratch stays as it was, and shared or copy-on-write
  blocks are never touched: the write window lies in blocks the request
  owns privately.

:func:`paged_attention_ref` is the plain version of K4 under the
reference's name; :func:`block_attention` dispatches ``impl="auto" |
"jnp" | "pallas"``. :func:`batched_verify_step_block` is the speculative
round's k-column verify on the arena: each layer's view through the
tables, the chunk written into it for the inline masked attention, and the
chunk's K/V landed with one :func:`write_fresh_window` of width k (a window
that crosses a block boundary takes the next table entry).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from nnstreamer_tpu_torch.models import transformer as tfm
from nnstreamer_tpu_torch.models.serving import dequantize_kv, quantize_kv, write_cols
from nnstreamer_tpu_torch.ops.kernels.paged_attention import (
    make_paged_attention,
    plain_paged_attention,
)


def paged_attention_ref(q, ck, cv, tables, pos, fresh_kv, k_scale=None, v_scale=None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """The plain version of K4 under the reference's name and signature:
    q [B,1,H,Dh]; ck/cv one layer's arena [N, bs, KV, Dh] (int8 with
    ``k_scale``/``v_scale`` [N, bs, KV]); tables [B, nb]; pos [B] the
    history length; ``fresh_kv = (fk, fv)`` [B,1,KV,Dh] the pending
    token's K/V, folded last → [B,1,H,Dh] float32."""
    fk, fv = fresh_kv
    return plain_paged_attention(q, ck, cv, tables, pos, fk, fv, k_scale, v_scale, scale)


def _take_layer(layer: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """One layer's arena leaf [N, bs, ...] → the contiguous per-slot view
    [B, nb·bs, ...] through ``tables`` [B, nb] (a new tensor)."""
    b, nb = tables.shape
    t = layer[tables.to(torch.int64)]  # [B, nb, bs, ...]
    return t.reshape((b, nb * layer.shape[1]) + tuple(layer.shape[2:]))


def write_fresh_window(arena, tables: torch.Tensor, fresh, pos: torch.Tensor, width: int,
                       active: torch.Tensor, quantized: bool):
    """Land freshly computed K/V in their owning arena blocks, in place.

    ``fresh`` holds the per-layer stacked values: ``(k, v)`` [L, B, width,
    KV, Dh], or ``(k8, ks, v8, vs)`` (int8 payloads + [L, B, width, KV]
    scales). Token column c of lane b goes to arena block
    ``tables[b, (pos + c) // bs]`` at row ``(pos + c) % bs``: one indexed
    write per arena leaf. Inactive lanes (and columns past the table) are
    routed to scratch block 0 and write its init values (zero payload,
    unit scale); every duplicate target is such a lane, writing the same
    value, so the result does not depend on the write order."""
    first = arena[0][0] if quantized else arena[0]
    bs = first.shape[2]
    nb = tables.shape[1]
    p = pos.to(torch.int64)[:, None] + torch.arange(int(width), device=pos.device)[None, :]
    lb = p // bs                                     # [B, w] logical block
    off = (p % bs).reshape(-1)
    valid = active[:, None] & (lb < nb)
    phys = torch.gather(tables.to(torch.int64), 1, torch.clamp(lb, 0, nb - 1))
    phys = torch.where(valid, phys, torch.zeros_like(phys)).reshape(-1)
    valid = valid.reshape(-1)

    def put(a, rows, fill=0.0):
        # rows [L, B, w, ...] → [L, B·w, ...]
        rows = rows.reshape((rows.shape[0], -1) + tuple(rows.shape[3:]))
        keep = valid.view((1, -1) + (1,) * (rows.dim() - 2))
        a[:, phys, off] = torch.where(keep, rows.to(a.dtype),
                                      torch.full_like(rows, fill, dtype=a.dtype))

    if quantized:
        k8, ks, v8, vs = fresh
        (ka, ksc), (va, vsc) = arena
        put(ka, k8)
        put(ksc, ks, 1.0)
        put(va, v8)
        put(vsc, vs, 1.0)
    else:
        k, v = fresh
        ka, va = arena
        put(ka, k)
        put(va, v)
    return arena


def batched_decode_step_block(model: tfm.TransformerLM, tok, pos, active, arena, tables,
                              n_heads: int, compute_dtype: torch.dtype = torch.float32,
                              attn_fn=None):
    """One decode step for the whole slot batch, straight against the
    block arena: the block-native sibling of
    ``models/serving.batched_decode_step``.

    tok/pos/active [B] as in the slot step; ``arena`` the kv.gather arena
    tree (leaves [L, N+1, bs, ...]), ``tables`` [B, nb] int32 → (logits
    [B, V] float32, arena, pos + active). ``attn_fn(q, k_entry, v_entry,
    tables, pos, (fresh_k, fresh_v)) -> [B,1,H,Dh]`` replaces the inline
    read with the block-table kernel (it receives one layer's arena
    leaves, or ``(payload, scales)`` pairs for int8, and the pending
    token's dequantized K/V); without it each layer takes its view through
    the tables, writes the pending token into it and runs the slot step's
    masked attention. The arena write is one :func:`write_fresh_window`
    after the layer loop, in place."""
    quantized = isinstance(arena[0], tuple)
    if quantized:
        (ka, ksc), (va, vsc) = arena
    else:
        ka, va = arena
    max_len = tables.shape[1] * ka.shape[2]
    x = tfm.embed_lookup(model.embed, tok, compute_dtype)[:, None, :]
    mask = None
    fresh = []
    for layer, blk in enumerate(model.blocks):
        bsz = x.shape[0]
        q, k, v = tfm.block_qkv(x, blk, n_heads, pos[:, None])
        if quantized:
            k8, ks = quantize_kv(k[:, 0])
            v8, vs = quantize_kv(v[:, 0])
            fresh.append((k8, ks, v8, vs))
            if attn_fn is not None:
                o = attn_fn(q, (ka[layer], ksc[layer]), (va[layer], vsc[layer]), tables, pos,
                            (dequantize_kv(k8, ks)[:, None], dequantize_kv(v8, vs)[:, None]))
            else:
                views = []
                for pay, sc, x8, xs in ((ka, ksc, k8, ks), (va, vsc, v8, vs)):
                    pv, sv = _take_layer(pay[layer], tables), _take_layer(sc[layer], tables)
                    write_cols(pv, x8[:, None], pos, active)
                    write_cols(sv, xs[:, None], pos, active)
                    views.append(dequantize_kv(pv, sv))
                ck, cv = views
        else:
            fresh.append((k[:, 0], v[:, 0]))
            if attn_fn is not None:
                o = attn_fn(q, ka[layer], va[layer], tables, pos, (k, v))
            else:
                ck, cv = _take_layer(ka[layer], tables), _take_layer(va[layer], tables)
                write_cols(ck, k, pos, active)
                write_cols(cv, v, pos, active)
        if attn_fn is None:
            if mask is None:
                mask = torch.arange(max_len, device=pos.device)[None, :] <= pos[:, None]
            o = tfm.cache_attention(q, ck, cv, mask[:, None, :])
        o = o.to(x.dtype).reshape(bsz, 1, -1)
        x = x + F.linear(o, tfm.wt(blk.wo.weight, x.dtype))
        x = tfm.block_ffn(x, blk)
    stacked = tuple(torch.stack(leaves)[:, :, None] for leaves in zip(*fresh))
    write_fresh_window(arena, tables, stacked, pos, 1, active, quantized)
    x = tfm.rmsnorm(x, model.ln_f)
    logits = F.linear(x, tfm.wt(model.head.weight, x.dtype)).float()[:, 0]
    return logits, arena, pos + active.to(pos.dtype)


def batched_verify_step_block(model: tfm.TransformerLM, toks, pos, active, arena, tables,
                              n_heads: int, compute_dtype: torch.dtype = torch.float32):
    """Score per-slot k-token chunks in one forward against the block
    arena: the block-native sibling of ``models/serving_spec
    .batched_verify_step`` (the same write-then-mask invariant). toks
    [B, k] → (logits [B, k, V] float32, arena). Each layer attends its
    view through ``tables`` with the chunk written into it; the chunk's
    K/V land in their owning blocks with one :func:`write_fresh_window`
    after the layer loop, in place. The caller keeps pos + k ≤ max_len for
    active lanes and their blocks allocated."""
    quantized = isinstance(arena[0], tuple)
    if quantized:
        (ka, ksc), (va, vsc) = arena
    else:
        ka, va = arena
    max_len = tables.shape[1] * ka.shape[2]
    b, k = toks.shape
    x = tfm.embed_lookup(model.embed, toks, compute_dtype)
    positions = pos[:, None] + torch.arange(k, dtype=pos.dtype, device=pos.device)[None, :]
    mask = torch.arange(max_len, device=pos.device)[None, None, :] <= positions[:, :, None]
    fresh = []
    for layer, blk in enumerate(model.blocks):
        q, kk, v = tfm.block_qkv(x, blk, n_heads, positions)
        if quantized:
            k8, ks = quantize_kv(kk)
            v8, vs = quantize_kv(v)
            fresh.append((k8, ks, v8, vs))
            views = []
            for pay, sc, x8, xs in ((ka, ksc, k8, ks), (va, vsc, v8, vs)):
                pv, sv = _take_layer(pay[layer], tables), _take_layer(sc[layer], tables)
                write_cols(pv, x8, pos, active)
                write_cols(sv, xs, pos, active)
                views.append(dequantize_kv(pv, sv))
            ck, cv = views
        else:
            fresh.append((kk, v))
            ck, cv = _take_layer(ka[layer], tables), _take_layer(va[layer], tables)
            write_cols(ck, kk, pos, active)
            write_cols(cv, v, pos, active)
        o = tfm.cache_attention(q, ck, cv, mask)
        o = o.to(x.dtype).reshape(b, k, -1)
        x = x + F.linear(o, tfm.wt(blk.wo.weight, x.dtype))
        x = tfm.block_ffn(x, blk)
    stacked = tuple(torch.stack(leaves) for leaves in zip(*fresh))
    write_fresh_window(arena, tables, stacked, pos, k, active, quantized)
    x = tfm.rmsnorm(x, model.ln_f)
    return F.linear(x, tfm.wt(model.head.weight, x.dtype)).float(), arena


def block_attention(q, cache_k, cache_v, tables, pos, fresh_kv, impl: str = "auto"):
    """Block-table decode attention with the reference's impl names:
    ``"auto"`` and ``"pallas"`` run K4 (the kernel on CUDA tensors, its
    plain version on CPU tensors), ``"jnp"`` the plain version.
    ``cache_k``/``cache_v`` are one layer's arena leaves [N, bs, KV, Dh],
    or ``(int8 payload, [N, bs, KV] scales)`` pairs."""
    if impl not in ("auto", "jnp", "pallas"):
        raise ValueError(f"block_attention impl {impl!r} not auto/jnp/pallas")
    if impl != "jnp":
        return make_paged_attention()(q, cache_k, cache_v, tables, pos, fresh_kv)
    if isinstance(cache_k, tuple):
        (k8, ks), (v8, vs) = cache_k, cache_v
        return paged_attention_ref(q, k8, v8, tables, pos, fresh_kv, k_scale=ks, v_scale=vs)
    return paged_attention_ref(q, cache_k, cache_v, tables, pos, fresh_kv)

