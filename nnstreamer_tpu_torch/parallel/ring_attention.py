"""Ring attention: sequence-parallel exact attention over a mesh axis.

The counterpart of ``nnstreamer_tpu/parallel/ring_attention.py``. Q/K/V
are split along the sequence over the positions of a mesh axis: position
``i`` holds global positions ``[i·Tl, (i+1)·Tl)``. K/V blocks rotate
around the ring, one neighbour hop a step (the reference's ``ppermute``;
here a ``.to`` of every block to the next position's device), and each
position accumulates its queries' attention with the online-softmax
recurrence, so the whole [T, T] score matrix never exists. After ``i``
hops position ``my`` holds the block of position ``(my − i) mod n``, the
reference's rotation order, and causal masks come from the blocks'
global offsets. A fully masked block contributes exact zeros and is not
skipped, as in the reference.

The single controller issues every position's work itself, so
:func:`ring_attention_local` takes the lists of per-position blocks; the
ring is ordinary autograd code (the hops are differentiable moves), and
the same path trains. Layouts are [batch, seq_local, heads, head_dim].
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from nnstreamer_tpu_torch.models.transformer import dense_attention  # noqa: F401 (re-export)
from nnstreamer_tpu_torch.parallel.mesh import Mesh, Sharding

NEG_INF = -1e30


def _online_block(q, k, v, mask, m_prev, l_prev, o_prev, scale):
    """One flash-attention accumulation step over a K/V block.

    q [B,Tq,H,D], k/v [B,Tk,H,D], mask [Tq,Tk] True=attend.
    Running stats: m (max) [B,H,Tq], l (denominator) [B,H,Tq],
    o (unnormalized out) [B,Tq,H,D].
    """
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    s = torch.where(mask[None, None, :, :], s, torch.full_like(s, NEG_INF))
    m_blk = torch.amax(s, dim=-1)
    m_new = torch.maximum(m_prev, m_blk)
    # guard exp(-inf - -inf): a still-empty row keeps alpha = 0
    alpha = torch.where(m_prev <= NEG_INF, torch.zeros_like(m_prev), torch.exp(m_prev - m_new))
    p = torch.exp(s - m_new[..., None])
    p = torch.where((m_new <= NEG_INF)[..., None], torch.zeros_like(p), p)
    l_new = l_prev * alpha + torch.sum(p, dim=-1)
    o_new = o_prev * alpha.transpose(1, 2)[..., None] + torch.einsum("bhqk,bkhd->bqhd", p, v)
    return m_new, l_new, o_new


def _online_block_chunked(q, k, v, mask, m_prev, l_prev, o_prev, scale, chunk: int):
    """The same recurrence over K/V in ``chunk``-sized pieces, so the live
    score tensor is [B,H,Tq,chunk] instead of [B,H,Tq,Tk]: the memory
    bound of a long local sequence."""
    tk = k.shape[1]
    if chunk <= 0 or tk % chunk:
        raise ValueError(
            f"ring attention: kv_chunk must be a positive divisor of the "
            f"local sequence ({tk}), got {chunk}"
        )
    m, l, o = m_prev, l_prev, o_prev
    for c in range(tk // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        m, l, o = _online_block(q, k[:, sl], v[:, sl], mask[:, sl], m, l, o, scale)
    return m, l, o


def ring_attention_local(
    qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor], vs: Sequence[torch.Tensor],
    devices: Sequence[torch.device], causal: bool = True, scale: Optional[float] = None,
    kv_chunk: Optional[int] = None,
) -> List[torch.Tensor]:
    """Every position's computation: ``qs[i]``/``ks[i]``/``vs[i]`` are
    position i's contiguous sequence blocks [B, Tl, H, D] on
    ``devices[i]``; returns each position's output block [B, Tl, H, D]
    float32 on its device. ``kv_chunk`` bounds the live score tensor to
    [B, H, Tl, kv_chunk]; None is the whole block."""
    n = len(devices)
    b, tl, h, d = qs[0].shape
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    qf = [q.float() for q in qs]
    stats = []
    for dev in devices:
        stats.append((torch.full((b, h, tl), NEG_INF, dtype=torch.float32, device=dev),
                      torch.zeros((b, h, tl), dtype=torch.float32, device=dev),
                      torch.zeros((b, tl, h, d), dtype=torch.float32, device=dev)))
    kb, vb = list(ks), list(vs)
    for i in range(n):
        for my, dev in enumerate(devices):
            src = (my - i) % n  # after i hops position my holds src's block
            q_pos = my * tl + torch.arange(tl, device=dev)
            k_pos = src * tl + torch.arange(tl, device=dev)
            if causal:
                mask = q_pos[:, None] >= k_pos[None, :]
            else:
                mask = torch.ones((tl, tl), dtype=torch.bool, device=dev)
            kf, vf = kb[my].float(), vb[my].float()
            if kv_chunk is not None and kv_chunk < tl:
                stats[my] = _online_block_chunked(qf[my], kf, vf, mask, *stats[my], scale,
                                                  kv_chunk)
            else:
                stats[my] = _online_block(qf[my], kf, vf, mask, *stats[my], scale)
        if i < n - 1:  # one hop to the next position (the reference's ppermute)
            kb = [kb[(p - 1) % n].to(devices[p]) for p in range(n)]
            vb = [vb[(p - 1) % n].to(devices[p]) for p in range(n)]
    outs = []
    for m, l, o in stats:
        denom = l.transpose(1, 2)[..., None]  # [B,Tq,H,1]
        outs.append(torch.where(denom > 0, o / torch.clamp(denom, min=1e-30),
                                torch.zeros_like(o)))
    return outs


def ring_over(devices: Sequence[torch.device], causal: bool = True,
              kv_chunk: Optional[int] = None) -> Callable:
    """Whole-array attention over the positions ``devices``: (q, k, v)
    [B, T, H, D] → float32 [B, T, H, D] on q's device; the sequence split
    into contiguous blocks, one a position."""
    devices = list(devices)

    def attn(q, k, v, causal: bool = causal):
        n = len(devices)
        if q.shape[1] % n:
            raise ValueError(f"ring attention: sequence {q.shape[1]} does not divide "
                             f"over {n} positions")
        qs = [t.to(dev) for t, dev in zip(q.chunk(n, dim=1), devices)]
        ks = [t.to(dev) for t, dev in zip(k.chunk(n, dim=1), devices)]
        vs = [t.to(dev) for t, dev in zip(v.chunk(n, dim=1), devices)]
        outs = ring_attention_local(qs, ks, vs, devices, causal=causal, kv_chunk=kv_chunk)
        return torch.cat([o.to(q.device) for o in outs], dim=1)

    return attn


def make_ring_attention(mesh: Mesh, axis: str = "sp", causal: bool = True,
                        kv_chunk: Optional[int] = None) -> Callable:
    """Whole-array entry: (q, k, v) [B, T, H, D] split over ``axis``
    (``Sharding(mesh, (None, axis))``; the mesh's other axes at their first
    position) → the attention output gathered back on q's device."""
    Sharding(mesh, (None, axis))  # names an axis of the mesh, or raises
    return ring_over(mesh.along(axis), causal=causal, kv_chunk=kv_chunk)
