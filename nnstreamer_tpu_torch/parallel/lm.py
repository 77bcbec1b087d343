"""Sharded long-context LM training: dp × sp × ep over one mesh.

The counterpart of ``nnstreamer_tpu/parallel/lm.py``: the transformer LM
(``models/transformer.py``) trained with

- **dp**: the batch split into one contiguous block a dp position (a
  *row*); each row computes its block at its first position;
- **sp**: q/k/v projected and RoPE'd over the whole sequence, then split
  over the row's sp positions for attention (ring attention or Ulysses),
  the output gathered back;
- **ep** (optional): each ep position of the row holds its slice of every
  layer's experts (``moe_w_in`` / ``moe_w_out`` split on the expert dim)
  and computes their share of the MoE FFN (``parallel/moe.py``);
  everything else is replicated.

The loss is the mean next-token cross entropy over the global batch: the
rows' sums meet on the first position. Gradients flow back through the
same moves; each parameter copy's gradient is then the sum over its
copies (``parallel/spmd.py sync_grads``), and the update is plain SGD,
``p − lr·g``, on every copy. The single-process parts of the reference
run over one process's mesh; a mesh that spans processes is the MobileNet
step's (``parallel/train.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from nnstreamer_tpu_torch.models import transformer as tfm
from nnstreamer_tpu_torch.parallel import moe as moe_mod
from nnstreamer_tpu_torch.parallel.mesh import Mesh, Sharding, replicated
from nnstreamer_tpu_torch.parallel.ring_attention import ring_over
from nnstreamer_tpu_torch.parallel.spmd import (
    ShardedTensor,
    load_state,
    module_at,
    place_state,
    sum_to,
    sync_grads,
)
from nnstreamer_tpu_torch.parallel.ulysses import ulysses_over


def init_lm_params(
    generator: torch.Generator,
    vocab: int = 1024,
    d_model: int = 256,
    n_heads: int = 8,
    n_layers: int = 4,
    d_ff: Optional[int] = None,
    n_experts: int = 0,
    moe_d_ff: Optional[int] = None,
    n_kv_heads: Optional[int] = None,
    device=None,
) -> tfm.TransformerLM:
    """A transformer; with ``n_experts`` > 0 every block holds expert
    weights (``moe_gate`` [D, E], ``moe_w_in`` [E, D, F], ``moe_w_out``
    [E, F, D]) in place of the SwiGLU MLP, F = ``moe_d_ff`` or half the
    dense FFN width, as the reference's."""
    return tfm.init_params(generator, vocab, d_model, n_heads, n_layers, d_ff, n_kv_heads,
                           device, n_experts=n_experts,
                           moe_d_ff=moe_d_ff or (d_ff or 4 * d_model) // 2)


def _row_attn(mesh: Mesh, kind: str, row: int, dp_axis: str, sp_axis: str,
              kv_chunk=None) -> Callable:
    """Row ``row``'s attention over its sp positions."""
    devices = mesh.along(sp_axis, **{dp_axis: row})
    if kind == "ring":
        return ring_over(devices, kv_chunk=kv_chunk)
    return ulysses_over(devices)


def _make_attn_fn(mesh: Mesh, kind: str, dp_axis: str, sp_axis: str, kv_chunk=None) -> Callable:
    """attn(q, k, v, causal) over whole arrays [B, T, H, D]: the batch split
    over the dp rows, each row's sequence over its sp positions."""
    if kind not in ("ring", "ulysses"):
        raise KeyError(kind)
    if kv_chunk is not None and kind != "ring":
        raise ValueError(
            f"kv_chunk applies to attn='ring' only (got attn={kind!r}); "
            "ulysses gathers full sequences per head and has no chunked path"
        )
    Sharding(mesh, (dp_axis, sp_axis))  # both axes of the mesh, or raises
    rows = [_row_attn(mesh, kind, i, dp_axis, sp_axis, kv_chunk)
            for i in range(mesh.axis_size(dp_axis))]

    def attn(q, k, v, causal=True):
        if q.shape[0] % len(rows):
            raise ValueError(f"batch {q.shape[0]} does not divide over {len(rows)} dp rows")
        parts = zip(q.chunk(len(rows)), k.chunk(len(rows)), v.chunk(len(rows)))
        return torch.cat([row(*p, causal=causal) for row, p in zip(rows, parts)], dim=0)

    return attn


def _make_moe_ffn(home: tfm.TransformerLM, ep_models, devices, top_k: int) -> Callable:
    """ffn(y, blk) for the row whose first position runs ``home``: block
    ``blk``'s experts computed at the ep positions (``ep_models``, on
    ``devices``) and summed."""
    by_block = {id(b): [m.blocks[i] for m in ep_models] for i, b in enumerate(home.blocks)}

    def ffn(y, blk):
        pieces = [{"gate": b.moe_gate, "w_in": b.moe_w_in, "w_out": b.moe_w_out}
                  for b in by_block[id(blk)]]
        return moe_mod.moe_ffn_local(y, pieces, devices, top_k)

    return ffn


def loss_fn(model: tfm.TransformerLM, tokens: torch.Tensor, n_heads: int,
            attn_fn: Optional[Callable] = None, ffn_fn: Optional[Callable] = None,
            compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Mean next-token cross entropy over tokens [B, T+1] (inputs [:, :-1])."""
    logits = tfm.apply(model, tokens[:, :-1], n_heads, attn_fn, ffn_fn, compute_dtype)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1).long())


def param_shardings(mesh: Mesh, model: tfm.TransformerLM,
                    ep_axis: Optional[str]) -> Dict[str, Sharding]:
    """Replicated everywhere but the expert weights, whose expert dim (dim
    0 of a block's ``moe_w_in`` / ``moe_w_out``) splits over ``ep_axis``."""
    out = {}
    for name in model.state_dict():
        leaf = name.rsplit(".", 1)[-1]
        out[name] = Sharding(mesh, (ep_axis,)) if ep_axis and leaf.startswith("moe_w") \
            else replicated(mesh)
    return out


class LMTrainStep:
    """``step(params, tokens)`` → (params, loss): one SGD step on tokens
    [B, T+1]. ``params`` is the step's own state (a dict of
    :class:`~.spmd.ShardedTensor` by state-dict name, updated in place) or
    one of the same layout, say a restored checkpoint, which the step
    takes in first."""

    def __init__(self, mesh: Mesh, model: tfm.TransformerLM, n_heads: int, attn: str,
                 dp_axis: str, sp_axis: str, ep_axis: Optional[str], top_k: int,
                 learning_rate: float, compute_dtype: torch.dtype, kv_chunk) -> None:
        if mesh.n_processes > 1:
            raise NotImplementedError("the LM step runs over one process's mesh "
                                      f"(this one spans {mesh.n_processes})")
        if any(isinstance(m, tfm.QuantizedWeight) for m in model.modules()):
            raise ValueError("training a weight-only int8 model: carry the float weights")
        _make_attn_fn(mesh, attn, dp_axis, sp_axis, kv_chunk)  # the reference's checks
        self.mesh, self.n_heads = mesh, n_heads
        self.lr, self.compute_dtype = learning_rate, compute_dtype
        self.shardings = param_shardings(mesh, model, ep_axis)
        self.params = place_state(model, self.shardings)
        is_moe = model.blocks[0].is_moe
        self.rows = []
        for i in range(mesh.axis_size(dp_axis)):
            home = mesh.position(**{dp_axis: i})
            row_model = module_at(model, home, self.params)
            ffn = None
            if is_moe:
                ep = [mesh.position(**{dp_axis: i, ep_axis: e})
                      for e in range(mesh.axis_size(ep_axis))] if ep_axis else [home]
                ep_models = [row_model if p == home else module_at(model, p, self.params)
                             for p in ep]
                ffn = _make_moe_ffn(row_model, ep_models, [mesh.devices[p] for p in ep], top_k)
            self.rows.append((mesh.devices[home], row_model,
                              _row_attn(mesh, attn, i, dp_axis, sp_axis, kv_chunk), ffn))

    def __call__(self, params, tokens) -> Tuple[Dict[str, ShardedTensor], torch.Tensor]:
        if params is not self.params:
            load_state(self.params, params)
        tokens = torch.as_tensor(tokens)
        dp = len(self.rows)
        if tokens.shape[0] % dp:
            raise ValueError(f"batch {tokens.shape[0]} does not divide over {dp} dp rows")
        sums = []
        for (dev, model, attn, ffn), part in zip(self.rows, tokens.chunk(dp)):
            part = part.to(dev)
            logits = tfm.apply(model, part[:, :-1], self.n_heads, attn, ffn, self.compute_dtype)
            sums.append(F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                        part[:, 1:].reshape(-1).long(), reduction="sum"))
        loss = sum_to(sums, self.rows[0][0]) / (tokens.shape[0] * (tokens.shape[1] - 1))
        loss.backward()
        sync_grads(self.params)
        with torch.no_grad():
            for st in self.params.values():
                for _, p in st.local():
                    if p.grad is not None:
                        p.sub_(p.grad * self.lr)
                    p.grad = None
        return self.params, loss.detach()


def make_lm_train_step(
    mesh: Mesh,
    params: tfm.TransformerLM,
    n_heads: int,
    attn: str = "ring",
    dp_axis: str = "dp",
    sp_axis: str = "sp",
    ep_axis: Optional[str] = None,
    top_k: int = 2,
    learning_rate: float = 0.1,
    compute_dtype: torch.dtype = torch.float32,
    kv_chunk=None,
) -> Tuple[LMTrainStep, Dict[str, ShardedTensor]]:
    """(step, sharded params): ``params`` (the model) is copied onto the
    mesh, gradients on, and never changed. ``kv_chunk`` bounds the
    in-position attention score tensor of a long context (ring only)."""
    step = LMTrainStep(mesh, params, n_heads, attn, dp_axis, sp_axis, ep_axis, top_k,
                       learning_rate, compute_dtype, kv_chunk)
    return step, step.params
