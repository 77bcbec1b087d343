"""Ulysses sequence parallelism: an all-to-all head↔sequence re-split.

The counterpart of ``nnstreamer_tpu/parallel/ulysses.py``. Where ring
attention rotates K/V blocks, one all-to-all re-splits
[B, T/n, H, D] → [B, T, H/n, D]: every position then runs *dense*
attention over the whole sequence for its H/n heads, and a second
all-to-all restores the sequence split. Two exchanges in all, at the
cost of holding full-sequence K/V for a head group. The reference's
``all_to_all`` is here a real re-split between the positions' devices
(:func:`seq_to_head`, :func:`head_to_seq`), inside the autograd graph.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from nnstreamer_tpu_torch.parallel.mesh import Mesh, Sharding
from nnstreamer_tpu_torch.parallel.ring_attention import dense_attention


def seq_to_head(blocks: Sequence[torch.Tensor],
                devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """[B, T/n, H, D] a position → [B, T, H/n, D] a position: position p
    gathers head group p of every position's sequence block, in order."""
    n = len(devices)
    return [torch.cat([b.chunk(n, dim=2)[p].to(dev) for b in blocks], dim=1)
            for p, dev in enumerate(devices)]


def head_to_seq(blocks: Sequence[torch.Tensor],
                devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """[B, T, H/n, D] a position → [B, T/n, H, D] a position: the inverse
    of :func:`seq_to_head`."""
    n = len(devices)
    return [torch.cat([b.chunk(n, dim=1)[p].to(dev) for b in blocks], dim=2)
            for p, dev in enumerate(devices)]


def ulysses_attention_local(
    qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor], vs: Sequence[torch.Tensor],
    devices: Sequence[torch.device], causal: bool = True, attn_fn: Optional[Callable] = None,
) -> List[torch.Tensor]:
    """Every position's computation: sequence blocks [B, T/n, H, D] a
    position in, the same layout out (float32). H must divide by n."""
    attn = attn_fn or dense_attention
    n = len(devices)
    h = qs[0].shape[2]
    if h % n:
        raise ValueError(f"ulysses: heads {h} not divisible by axis size {n}")
    q, k, v = (seq_to_head(x, devices) for x in (qs, ks, vs))
    o = [attn(qi, ki, vi, causal=causal).to(qs[0].dtype) for qi, ki, vi in zip(q, k, v)]
    return [x.float() for x in head_to_seq(o, devices)]


def ulysses_over(devices: Sequence[torch.device], causal: bool = True) -> Callable:
    """Whole-array attention over ``devices`` with the Ulysses re-split:
    (q, k, v) [B, T, H, D] → float32 [B, T, H, D] on q's device."""
    devices = list(devices)

    def attn(q, k, v, causal: bool = causal):
        n = len(devices)
        if q.shape[1] % n:
            raise ValueError(f"ulysses: sequence {q.shape[1]} does not divide over {n} positions")
        split = [[t.to(dev) for t, dev in zip(x.chunk(n, dim=1), devices)] for x in (q, k, v)]
        outs = ulysses_attention_local(*split, devices, causal=causal)
        return torch.cat([o.to(q.device) for o in outs], dim=1)

    return attn


def make_ulysses_attention(mesh: Mesh, axis: str = "sp", causal: bool = True) -> Callable:
    """Whole-array entry matching :func:`.ring_attention.make_ring_attention`."""
    Sharding(mesh, (None, axis))  # names an axis of the mesh, or raises
    return ulysses_over(mesh.along(axis), causal=causal)
