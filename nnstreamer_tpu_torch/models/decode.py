"""KV-cache autoregressive decoding for the transformer LM family.

The counterpart of ``nnstreamer_tpu/models/decode.py``. Cache k/v are
[L, B, max_len, KV, Dh]; ``pos`` is the fill level. Attention at each step
runs over the whole max_len with a ``<= pos`` mask.

The reference is functional (every step returns a new cache); here the
cache tensors are updated in place, which keeps one copy of a multi-GB
cache on the card, and are returned as well so the signatures match. The
overflow checks that the reference makes only on concrete positions are
made on every call: a write past max_len raises.

Not ported yet: ``windowed_chunk`` (the sliding-window ring) and
``beam_search``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from nnstreamer_tpu_torch.models import transformer as tfm

Cache = Tuple[torch.Tensor, torch.Tensor]


def init_cache(model: tfm.TransformerLM, batch: int, max_len: int, n_heads: int,
               dtype: torch.dtype = torch.float32) -> Cache:
    """Zeroed (k, v) cache [L, B, max_len, KV, Dh] on the model's device."""
    d = model.d_model
    shape = (model.n_layers, batch, max_len,
             tfm.n_kv_heads_of(model.blocks[0].wqkv.weight, d, n_heads), d // n_heads)
    dev = model.embed.device
    return torch.zeros(shape, dtype=dtype, device=dev), torch.zeros(shape, dtype=dtype, device=dev)


def prefill(model: tfm.TransformerLM, tokens: torch.Tensor, n_heads: int, max_len: int,
            compute_dtype: torch.dtype = torch.float32):
    """Run the prompt through the model once, filling a new cache.
    tokens [B, T] (T ≤ max_len) → (logits [B, T, V], (cache_k, cache_v)
    [L, B, max_len, KV, Dh], pos=T)."""
    b, t = tokens.shape
    if t > max_len:
        raise ValueError(f"prompt length {t} > max_len {max_len}")
    x = tfm.embed_lookup(model.embed, tokens, compute_dtype)
    positions = torch.arange(t, device=tokens.device)
    x, (ks, vs) = tfm.apply_layers(model, x, n_heads, positions, return_kv=True)
    x = tfm.rmsnorm(x, model.ln_f)
    logits = F.linear(x, tfm.wt(model.head.weight, x.dtype)).float()
    pad = (0, 0, 0, 0, 0, max_len - t)
    cache_k = F.pad(ks.to(compute_dtype), pad)
    cache_v = F.pad(vs.to(compute_dtype), pad)
    return logits, (cache_k, cache_v), t


def verify_chunk(model: tfm.TransformerLM, tokens: torch.Tensor, pos, cache: Cache,
                 n_heads: int, compute_dtype: torch.dtype = torch.float32,
                 return_logits: bool = True):
    """Score a k-token chunk in one forward against the cache.

    tokens [B, k] → (logits [B, k, V] float32 or None, cache, pos + k).
    Query i sits at absolute position pos + i and attends cache positions
    ≤ pos + i. The chunk's K/V are written in place at pos .. pos + k - 1.
    ``return_logits=False`` (chunked prefill's non-final chunks) skips the
    final norm and the vocab-sized head. pos + k > max_len raises."""
    cache_k, cache_v = cache
    max_len = cache_k.shape[2]
    b, k_len = tokens.shape
    pos = int(pos)
    if pos + k_len > max_len:
        raise ValueError(
            f"verify_chunk: pos({pos}) + k({k_len}) > max_len({max_len}); "
            "the KV cache would overflow"
        )
    x = tfm.embed_lookup(model.embed, tokens, compute_dtype)
    positions = pos + torch.arange(k_len, device=tokens.device)
    mask = torch.arange(max_len, device=tokens.device)[None, :] <= positions[:, None]
    for layer, blk in enumerate(model.blocks):
        q, k, v = tfm.block_qkv(x, blk, n_heads, positions)
        ck, cv = cache_k[layer], cache_v[layer]
        ck[:, pos:pos + k_len] = k.to(ck.dtype)
        cv[:, pos:pos + k_len] = v.to(cv.dtype)
        o = tfm.cache_attention(q, ck, cv, mask[None])
        o = o.to(x.dtype).reshape(b, k_len, -1)
        x = x + F.linear(o, tfm.wt(blk.wo.weight, x.dtype))
        x = tfm.block_ffn(x, blk)
    if not return_logits:
        return None, (cache_k, cache_v), pos + k_len
    x = tfm.rmsnorm(x, model.ln_f)
    logits = F.linear(x, tfm.wt(model.head.weight, x.dtype)).float()
    return logits, (cache_k, cache_v), pos + k_len


def decode_step(model: tfm.TransformerLM, token: torch.Tensor, pos, cache: Cache,
                n_heads: int, compute_dtype: torch.dtype = torch.float32):
    """One token in, one distribution out: token [B], pos (tokens cached)
    → (logits [B, V], cache, pos + 1). A one-token :func:`verify_chunk`."""
    logits, cache, _ = verify_chunk(model, token[:, None], pos, cache, n_heads, compute_dtype)
    return logits[:, 0], cache, int(pos) + 1


def generate(model: tfm.TransformerLM, prompt: torch.Tensor, n_heads: int,
             max_new_tokens: int, max_len: Optional[int] = None, temperature: float = 0.0,
             rng: Optional[torch.Generator] = None,
             compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Greedy (temperature ≤ 0) or sampled generation: prompt [B, T] →
    tokens [B, max_new_tokens]. Sampling draws from ``rng`` (a
    ``torch.Generator`` on the model's device; seed 0 when omitted): the
    same seed gives the same tokens, not the reference's ``jax.random``
    ones."""
    b, t = prompt.shape
    max_len = max_len or (t + max_new_tokens)
    if max_len < t + max_new_tokens:
        raise ValueError(
            f"max_len={max_len} < prompt_len({t}) + max_new_tokens"
            f"({max_new_tokens}); KV cache would overflow"
        )
    if temperature > 0.0 and rng is None:
        rng = torch.Generator(device=prompt.device).manual_seed(0)
    logits, cache, pos = prefill(model, prompt, n_heads, max_len, compute_dtype)
    last = logits[:, -1]
    toks = []
    for i in range(max_new_tokens):
        if temperature <= 0.0:
            tok = torch.argmax(last, dim=-1).to(torch.int32)
        else:
            probs = torch.softmax(last / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=rng)[:, 0].to(torch.int32)
        toks.append(tok)
        if i + 1 < max_new_tokens:  # the last token's distribution is never read
            last, cache, pos = decode_step(model, tok, pos, cache, n_heads, compute_dtype)
    return torch.stack(toks, dim=1)
