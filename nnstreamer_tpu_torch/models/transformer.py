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
``params``, and the same hooks: ``attn_fn`` and ``causal``
(``attn_fn=None`` is :func:`dense_attention`; ``ops/kernels/flash_attention.py
make_flash_attention`` plugs in the flash kernel, ``parallel/lm.py`` ring
attention or Ulysses), ``ffn_fn`` (the MoE hook, which a :class:`Block`
holding expert weights needs) and ``apply``'s ``positions`` (a sequence
shard's global positions). A :class:`TransformerLM` is an inference model
(no parameter asks for gradients); a training entry point
(``parallel/lm.py``) trains copies of its own. The cast points are
the reference's: RMSNorm in float32, then back to the compute dtype;
attention outputs float32, then cast to the compute dtype. Linear weights
are ``[cout, cin]`` (``nn.Linear``); ``models/jax_weights.py`` carries
the reference's ``[cin, cout]`` leaves over.

Weight-only int8 (``models/quantize.py``) puts a :class:`QuantizedWeight`
(int8 ``w8`` and float32 ``scale`` buffers) where a weight was, as the
reference puts ``{"w8", "scale"}`` where an array was; :func:`wt` and
:func:`embed_lookup` dequantize it at the matmul operand.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from nnstreamer_tpu_torch.device import DeviceLike

NEG_INF = -1e30


class QuantizedWeight(nn.Module):
    """A weight stored as int8 ``w8`` times a float32 ``scale`` that
    broadcasts against it (per output channel for a linear weight, per
    feature for the embedding), both buffers. It stands where the float
    weight stood; :func:`wt` and :func:`embed_lookup` dequantize it."""

    def __init__(self, w8: torch.Tensor, scale: torch.Tensor) -> None:
        super().__init__()
        self.register_buffer("w8", w8)
        self.register_buffer("scale", scale)

    @property
    def shape(self) -> torch.Size:
        return self.w8.shape

    @property
    def device(self) -> torch.device:
        return self.w8.device


def wt(w, dtype: torch.dtype) -> torch.Tensor:
    """A weight in the compute dtype; a :class:`QuantizedWeight`
    dequantizes as ``w8.to(dtype) * scale.to(dtype)``, the reference's
    cast order."""
    if isinstance(w, QuantizedWeight):
        return w.w8.to(dtype) * w.scale.to(dtype)
    return w.to(dtype)


def embed_lookup(embed, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Embedding row gather, then the cast to the compute dtype (a
    quantized table: its rows, then the per-feature scales)."""
    if isinstance(embed, QuantizedWeight):
        return embed.w8[tokens.long()].to(dtype) * embed.scale.to(dtype)
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
    SwiGLU ``w_gate``/``w_up``/``w_down``. With ``n_experts`` > 0 the
    SwiGLU is replaced by mixture-of-experts weights in the reference's
    layouts (``parallel/lm.py init_lm_params``): the router ``moe_gate``
    [D, E], ``moe_w_in`` [E, D, F] and ``moe_w_out`` [E, F, D]; such a
    block runs its FFN through an ``ffn_fn`` (``parallel/moe.py``)."""

    def __init__(self, d_model: int, n_heads: int, n_kv_heads: int, d_ff: int,
                 device=None, n_experts: int = 0, moe_d_ff: Optional[int] = None) -> None:
        super().__init__()
        hd = d_model // n_heads
        kw = dict(bias=False, device=device)
        self.ln1 = nn.Parameter(torch.ones(d_model, device=device))
        self.ln2 = nn.Parameter(torch.ones(d_model, device=device))
        self.wqkv = nn.Linear(d_model, d_model + 2 * n_kv_heads * hd, **kw)
        self.wo = nn.Linear(d_model, d_model, **kw)
        if n_experts > 0:
            f = moe_d_ff or d_ff // 2
            self.moe_gate = nn.Parameter(torch.zeros(d_model, n_experts, device=device))
            self.moe_w_in = nn.Parameter(torch.zeros(n_experts, d_model, f, device=device))
            self.moe_w_out = nn.Parameter(torch.zeros(n_experts, f, d_model, device=device))
            self.w_gate = self.w_up = self.w_down = None
            return
        self.w_gate = nn.Linear(d_model, d_ff, **kw)
        self.w_up = nn.Linear(d_model, d_ff, **kw)
        self.w_down = nn.Linear(d_ff, d_model, **kw)

    @property
    def is_moe(self) -> bool:
        return self.w_gate is None


class TransformerLM(nn.Module):
    """The weights: ``embed`` [vocab, d], ``blocks`` (an ``nn.ModuleList``
    of :class:`Block`), ``ln_f`` [d] and the untied ``head``. Calling it
    runs :func:`apply` (tokens [B, T] → logits [B, T, vocab] float32)."""

    def __init__(self, vocab: int, d_model: int, n_heads: int, n_layers: int,
                 d_ff: Optional[int] = None, n_kv_heads: Optional[int] = None,
                 device=None, n_experts: int = 0, moe_d_ff: Optional[int] = None) -> None:
        super().__init__()
        kv = n_kv_heads or n_heads
        if n_heads % kv:
            raise ValueError(f"n_heads {n_heads} not divisible by n_kv_heads {kv}")
        self.n_heads = n_heads
        self.embed = nn.Parameter(torch.zeros(vocab, d_model, device=device))
        self.blocks = nn.ModuleList(
            Block(d_model, n_heads, kv, d_ff or 4 * d_model, device=device,
                  n_experts=n_experts, moe_d_ff=moe_d_ff)
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
    n_experts: int = 0,
    moe_d_ff: Optional[int] = None,
) -> TransformerLM:
    """Random weights from ``generator``, made on the generator's device
    (a CUDA generator builds a full-width model on the card directly):
    dense weights N(0, 1/cin), the embedding N(0, 0.02²), norms at one —
    the reference's distributions, not its numbers (``jax.random`` bits
    differ; carry the reference's own weights with ``jax_weights``). With
    ``n_experts`` the blocks hold expert weights (:class:`Block`) drawn as
    ``parallel/moe.py init_moe_params`` draws them: router and ``w_in``
    N(0, 1/D), ``w_out`` N(0, 1/F)."""
    dev = torch.device(device) if device is not None else generator.device
    model = TransformerLM(vocab, d_model, n_heads, n_layers, d_ff, n_kv_heads, device=dev,
                          n_experts=n_experts, moe_d_ff=moe_d_ff)

    def normal_(t: torch.Tensor, std: float) -> None:
        t.normal_(0.0, std, generator=generator)

    normal_(model.embed, 0.02)
    for blk in model.blocks:
        for lin in (blk.wqkv, blk.wo, blk.w_gate, blk.w_up, blk.w_down):
            if lin is not None:
                normal_(lin.weight, math.sqrt(1.0 / lin.in_features))
        if blk.is_moe:
            normal_(blk.moe_gate, math.sqrt(1.0 / d_model))
            normal_(blk.moe_w_in, math.sqrt(1.0 / d_model))
            normal_(blk.moe_w_out, math.sqrt(1.0 / blk.moe_w_out.shape[1]))
    normal_(model.head.weight, math.sqrt(1.0 / d_model))
    return model


def n_kv_heads_of(wqkv_weight: torch.Tensor, d_model: int, n_heads: int) -> int:
    """The kv head count from the fused projection's width (d_model query
    columns + 2·KV·Dh key/value columns)."""
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


def block_ffn(x: torch.Tensor, blk: Block, ffn_fn: Optional[Callable] = None) -> torch.Tensor:
    """Post-attention half of a block: pre-norm + SwiGLU MLP, or
    ``ffn_fn(x_normed, blk)`` → [B,T,D] in its place (the MoE hook)."""
    y = rmsnorm(x, blk.ln2)
    if ffn_fn is not None:
        return x + ffn_fn(y, blk).to(x.dtype)
    if blk.is_moe:
        raise ValueError("a block with expert weights needs an ffn_fn (parallel/moe.py)")
    gate = F.silu(F.linear(y, wt(blk.w_gate.weight, y.dtype)))
    up = F.linear(y, wt(blk.w_up.weight, y.dtype))
    return x + F.linear(gate * up, wt(blk.w_down.weight, y.dtype))


def block_apply(x, blk: Block, n_heads: int, positions, attn_fn: Optional[Callable] = None,
                ffn_fn: Optional[Callable] = None, return_kv: bool = False,
                causal: bool = True):
    """One block. ``attn_fn(q, k, v, causal)`` → [B,T,H,Dh] float32
    (default :func:`dense_attention`) gets K/V repeated to H heads;
    ``ffn_fn`` replaces the SwiGLU MLP (:func:`block_ffn`); return_kv=True
    also returns this layer's (k, v), the prefill path of the KV-cache
    decoder; causal=False makes it an encoder block."""
    attn = attn_fn or dense_attention
    b, t, d = x.shape
    q, k, v = block_qkv(x, blk, n_heads, positions)
    o = attn(q, repeat_kv(k, n_heads), repeat_kv(v, n_heads), causal=causal).to(x.dtype)
    x = x + F.linear(o.reshape(b, t, d), wt(blk.wo.weight, x.dtype))
    x = block_ffn(x, blk, ffn_fn)
    if return_kv:
        return x, (k, v)
    return x


def apply_layers(model, x, n_heads: int, positions, attn_fn: Optional[Callable] = None,
                 ffn_fn: Optional[Callable] = None, return_kv: bool = False,
                 causal: bool = True):
    """Run every block of ``model`` (a module with ``blocks``, or a
    sequence of :class:`Block` such as a pipeline stage's slice) in order;
    return_kv=True also returns the stacked per-layer (k, v) [L,B,T,KV,Dh]."""
    ks, vs = [], []
    for blk in getattr(model, "blocks", model):
        out = block_apply(x, blk, n_heads, positions, attn_fn, ffn_fn, return_kv, causal)
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
          attn_fn: Optional[Callable] = None, ffn_fn: Optional[Callable] = None,
          compute_dtype: torch.dtype = torch.float32, positions=None) -> torch.Tensor:
    """tokens [B, T] int → logits [B, T, vocab] float32 (causal, no cache).
    ``positions`` [T] replaces the default arange: a sequence shard passes
    its tokens' global positions, which RoPE needs."""
    x = embed_lookup(model.embed, tokens, compute_dtype)
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = apply_layers(model, x, n_heads, positions, attn_fn, ffn_fn)
    x = rmsnorm(x, model.ln_f)
    return F.linear(x, wt(model.head.weight, x.dtype)).float()
