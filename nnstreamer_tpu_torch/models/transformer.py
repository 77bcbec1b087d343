"""Decoder-only transformer LM (the ``transformer_lm`` family).

The counterpart of ``nnstreamer_tpu/models/transformer.py``: RMSNorm
pre-norm, RoPE rotating the two halves of each head, grouped-query
attention, a SwiGLU MLP, no biases and an untied output head — the
architecture of Mistral-7B at its published widths (d_model 4096, 32
layers, 32 query and 8 kv heads of 128, FFN 14336, vocab 32000).

The reference keeps the weights as a stacked pytree consumed by
``lax.scan``; here they are a :class:`TransformerLM` module whose blocks
are an ``nn.ModuleList`` (one :class:`Block` a layer). The functions keep
the reference's names and argument order, with the module in place of
``params`` and without the hooks no ported caller uses (``attn_fn``,
``ffn_fn``, ``causal``, ``apply``'s ``positions``), and its cast points:
RMSNorm in float32, then back to the compute dtype; attention outputs
float32, then cast to the compute dtype. Linear weights are
``[cout, cin]`` (``nn.Linear``); ``models/jax_weights.py`` carries the
reference's ``[cin, cout]`` leaves over.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from nnstreamer_tpu_torch.device import DeviceLike

NEG_INF = -1e30


def _not_ported_quantized(w) -> None:
    if isinstance(w, dict) and "w8" in w:
        raise NotImplementedError(
            "weight-only int8 ({'w8', 'scale'} weights, models/quantize.py) is not ported yet"
        )


def wt(w, dtype: torch.dtype) -> torch.Tensor:
    """A weight in the compute dtype (the reference also dequantizes
    ``{"w8", "scale"}`` weights here; those raise until quantize.py is
    ported)."""
    _not_ported_quantized(w)
    return w.to(dtype)


def embed_lookup(embed, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Embedding row gather, then the cast to the compute dtype."""
    _not_ported_quantized(embed)
    return embed[tokens.long()].to(dtype)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    # normalize and apply the float32 weight in float32, then cast back
    x32 = x.float()
    scale = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (x32 * scale * w).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, base: float = 10000.0) -> torch.Tensor:
    """Rotary embedding over the last dim. x [B,T,H,D]; positions [T]
    (shared across the batch) or [B,T] (per slot, the batched decode
    step). Angles in float32."""
    d = x.shape[-1]
    half = d // 2
    freqs = base ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    pos = torch.as_tensor(positions, device=x.device).to(torch.float32)
    if pos.dim() == 1:
        pos = pos[None, :]
    angles = pos[:, :, None] * freqs                   # [B|1, T, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


class Block(nn.Module):
    """One pre-norm block: ``ln1``, the fused ``wqkv`` projection (d_model
    query columns then 2·KV·Dh key/value columns), ``wo``, ``ln2`` and the
    SwiGLU ``w_gate``/``w_up``/``w_down``."""

    def __init__(self, d_model: int, n_heads: int, n_kv_heads: int, d_ff: int,
                 device=None) -> None:
        super().__init__()
        hd = d_model // n_heads
        kw = dict(bias=False, device=device)
        self.ln1 = nn.Parameter(torch.ones(d_model, device=device))
        self.ln2 = nn.Parameter(torch.ones(d_model, device=device))
        self.wqkv = nn.Linear(d_model, d_model + 2 * n_kv_heads * hd, **kw)
        self.wo = nn.Linear(d_model, d_model, **kw)
        self.w_gate = nn.Linear(d_model, d_ff, **kw)
        self.w_up = nn.Linear(d_model, d_ff, **kw)
        self.w_down = nn.Linear(d_ff, d_model, **kw)


class TransformerLM(nn.Module):
    """The weights: ``embed`` [vocab, d], ``blocks`` (an ``nn.ModuleList``
    of :class:`Block`), ``ln_f`` [d] and the untied ``head``. Calling it
    runs :func:`apply` (tokens [B, T] → logits [B, T, vocab] float32)."""

    def __init__(self, vocab: int, d_model: int, n_heads: int, n_layers: int,
                 d_ff: Optional[int] = None, n_kv_heads: Optional[int] = None,
                 device=None) -> None:
        super().__init__()
        kv = n_kv_heads or n_heads
        if n_heads % kv:
            raise ValueError(f"n_heads {n_heads} not divisible by n_kv_heads {kv}")
        self.n_heads = n_heads
        self.embed = nn.Parameter(torch.zeros(vocab, d_model, device=device))
        self.blocks = nn.ModuleList(
            Block(d_model, n_heads, kv, d_ff or 4 * d_model, device=device)
            for _ in range(n_layers)
        )
        self.ln_f = nn.Parameter(torch.ones(d_model, device=device))
        self.head = nn.Linear(d_model, vocab, bias=False, device=device)
        self.requires_grad_(False)  # an inference model: no autograd graphs

    @property
    def n_layers(self) -> int:
        return len(self.blocks)

    @property
    def d_model(self) -> int:
        return self.embed.shape[1]

    @property
    def n_kv_heads(self) -> int:
        return n_kv_heads_of(self.blocks[0].wqkv.weight, self.d_model, self.n_heads)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return apply(self, tokens, self.n_heads)


@torch.no_grad()
def init_params(
    generator: torch.Generator,
    vocab: int = 1024,
    d_model: int = 256,
    n_heads: int = 8,
    n_layers: int = 4,
    d_ff: Optional[int] = None,
    n_kv_heads: Optional[int] = None,
    device: DeviceLike = None,
) -> TransformerLM:
    """Random weights from ``generator``, made on the generator's device
    (a CUDA generator builds a full-width model on the card directly):
    dense weights N(0, 1/cin), the embedding N(0, 0.02²), norms at one —
    the reference's distributions, not its numbers (``jax.random`` bits
    differ; carry the reference's own weights with ``jax_weights``)."""
    dev = torch.device(device) if device is not None else generator.device
    model = TransformerLM(vocab, d_model, n_heads, n_layers, d_ff, n_kv_heads, device=dev)

    def normal_(t: torch.Tensor, std: float) -> None:
        t.normal_(0.0, std, generator=generator)

    normal_(model.embed, 0.02)
    for blk in model.blocks:
        for lin in (blk.wqkv, blk.wo, blk.w_gate, blk.w_up, blk.w_down):
            normal_(lin.weight, math.sqrt(1.0 / lin.in_features))
    normal_(model.head.weight, math.sqrt(1.0 / d_model))
    return model


def n_kv_heads_of(wqkv_weight: torch.Tensor, d_model: int, n_heads: int) -> int:
    """The kv head count from the fused projection's width (d_model query
    columns + 2·KV·Dh key/value columns)."""
    _not_ported_quantized(wqkv_weight)
    hd = d_model // n_heads
    return (wqkv_weight.shape[0] - d_model) // (2 * hd)


def repeat_kv(t: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B,T,KV,Dh] → [B,T,H,Dh]: each kv head serves n_heads/KV query heads."""
    kv = t.shape[2]
    if kv == n_heads:
        return t
    return torch.repeat_interleave(t, n_heads // kv, dim=2)


def dense_attention(q, k, v, causal: bool = True, scale: Optional[float] = None):
    """Single-device attention (the port of
    ``parallel/ring_attention.dense_attention``): q/k/v [B,T,H,D] → float32."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        t_q, t_k = s.shape[-2], s.shape[-1]
        mask = (torch.arange(t_q, device=s.device)[:, None]
                >= torch.arange(t_k, device=s.device)[None, :])
        s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float())


def cache_attention(q, ck, cv, mask):
    """Masked attention against a KV cache without expanding the groups.
    q [B,T,H,Dh], ck/cv [B,S,KV,Dh], mask [B,T,S] bool (or broadcastable)
    → o [B,T,H,Dh] float32."""
    b, t, h, hd = q.shape
    kv = ck.shape[2]
    g = h // kv
    q5 = q.float().reshape(b, t, kv, g, hd)
    s = torch.einsum("btkgd,bskd->bkgts", q5, ck.float()) / (hd ** 0.5)
    s = torch.where(mask[:, None, None, :, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgts,bskd->btkgd", p, cv.float())
    return o.reshape(b, t, h, hd)


def block_qkv(x: torch.Tensor, blk: Block, n_heads: int, positions):
    """Pre-norm + qkv projection + RoPE → q [B,T,H,Dh], k/v [B,T,KV,Dh]."""
    b, t, d = x.shape
    hd = d // n_heads
    kv = n_kv_heads_of(blk.wqkv.weight, d, n_heads)
    y = rmsnorm(x, blk.ln1)
    qkv = F.linear(y, wt(blk.wqkv.weight, y.dtype))
    q = qkv[..., :d]
    k, v = torch.chunk(qkv[..., d:], 2, dim=-1)
    q = rope(q.reshape(b, t, n_heads, hd), positions)
    k = rope(k.reshape(b, t, kv, hd), positions)
    return q, k, v.reshape(b, t, kv, hd)


def block_ffn(x: torch.Tensor, blk: Block) -> torch.Tensor:
    """Post-attention half of a block: pre-norm + SwiGLU MLP."""
    y = rmsnorm(x, blk.ln2)
    gate = F.silu(F.linear(y, wt(blk.w_gate.weight, y.dtype)))
    up = F.linear(y, wt(blk.w_up.weight, y.dtype))
    return x + F.linear(gate * up, wt(blk.w_down.weight, y.dtype))


def block_apply(x, blk: Block, n_heads: int, positions, return_kv: bool = False):
    """One causal block with :func:`dense_attention`; return_kv=True also
    returns this layer's (k, v), the prefill path of the KV-cache decoder."""
    b, t, d = x.shape
    q, k, v = block_qkv(x, blk, n_heads, positions)
    o = dense_attention(q, repeat_kv(k, n_heads), repeat_kv(v, n_heads)).to(x.dtype)
    x = x + F.linear(o.reshape(b, t, d), wt(blk.wo.weight, x.dtype))
    x = block_ffn(x, blk)
    if return_kv:
        return x, (k, v)
    return x


def apply_layers(model: TransformerLM, x, n_heads: int, positions, return_kv: bool = False):
    """Run every block in order; return_kv=True also returns the stacked
    per-layer (k, v) [L,B,T,KV,Dh]."""
    ks, vs = [], []
    for blk in model.blocks:
        out = block_apply(x, blk, n_heads, positions, return_kv)
        if return_kv:
            x, (k, v) = out
            ks.append(k)
            vs.append(v)
        else:
            x = out
    if return_kv:
        return x, (torch.stack(ks), torch.stack(vs))
    return x


def apply(model: TransformerLM, tokens: torch.Tensor, n_heads: int,
          compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """tokens [B, T] int → logits [B, T, vocab] float32 (causal, no cache)."""
    x = embed_lookup(model.embed, tokens, compute_dtype)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = apply_layers(model, x, n_heads, positions)
    x = rmsnorm(x, model.ln_f)
    return F.linear(x, wt(model.head.weight, x.dtype)).float()
