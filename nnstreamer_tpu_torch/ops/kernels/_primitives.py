"""The online-softmax attention primitives, as plain PyTorch.

The counterpart of ``nnstreamer_tpu/ops/pallas/_primitives.py``: the one
recurrence the attention kernels (decode, paged decode and flash
prefill) are built from, plus the merge of partial states with which the
split decode kernels combine their history chunks. The CUDA kernels
include the same recurrence as device functions from
``csrc/attn_primitives.cuh``; the functions here are the plain versions
the kernels are held against.

Each takes leading batch dimensions in front of the reference's 2-D
shapes (``q [..., m, d]``, ``k [..., n, d]``), and the numerics are the
reference's: float32 accumulation, the ``m <= NEG_INF`` guards that keep
fully masked prefixes at weight exactly zero, and the ``l > 0`` guard that
zeroes rows nothing attended to.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def scaled_qk(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """Scores ``(q · kᵀ) * scale`` in float32: q [..., m, d], k [..., n, d]
    → [..., m, n]."""
    return torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale


def dequant_rows(x: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Per-row dequantization: payload [..., n, d] × scales [..., n]."""
    return x.float() * scales[..., None]


def mask_dead_columns(s, v, cols, live_len):
    """Scores at columns ``cols >= live_len`` → NEG_INF, and the matching
    V rows → 0. Dead columns get weight exp(NEG_INF - m) = 0, but a stale
    cache row may hold any bytes and 0 * NaN = NaN: zeroing the rows keeps
    the weighted sum clean. ``cols`` indexes the last axis of ``s`` and
    the row axis of ``v``; ``live_len`` broadcasts against both."""
    s = torch.where(cols < live_len, s, torch.full_like(s, NEG_INF))
    v = torch.where(cols.reshape(-1, 1) < live_len, v, torch.zeros_like(v))
    return s, v


def online_softmax_init(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor) -> None:
    """Reset a running (max, denominator, accumulator) in place: the max
    at NEG_INF (the identity of max), the others at zero."""
    m.fill_(NEG_INF)
    l.zero_()
    acc.zero_()


def online_softmax_update(s, v, m_prev, l_prev, acc_prev):
    """One block of the recurrence: scores s [..., m, n] and values
    v [..., n, d] (float32) against the running (m_prev [..., m],
    l_prev [..., m], acc_prev [..., m, d]) → the updated triple."""
    m_new = torch.maximum(m_prev, s.amax(dim=-1))
    zero = torch.zeros_like(m_new)
    alpha = torch.where(m_prev <= NEG_INF, zero, torch.exp(m_prev - m_new))
    m2 = m_new[..., None]
    p = torch.where(m2 <= NEG_INF, torch.zeros_like(s), torch.exp(s - m2))
    l_new = l_prev * alpha + p.sum(dim=-1)
    acc_new = acc_prev * alpha[..., None] + torch.matmul(p, v.float())
    return m_new, l_new, acc_new


def online_softmax_merge(m, l, acc):
    """The state of the union of n disjoint column sets from their states,
    stacked on a split axis: m [..., n], l [..., n], acc [..., n, d] →
    (m [...], l [...], acc [..., d]). Each state is rescaled to the largest
    max with the update's guard, so a state at NEG_INF (nothing attended)
    weighs exactly 0 and a merge of empty states stays (NEG_INF, 0, 0). The
    split decode kernels merge their history chunks with it."""
    m_new = m.amax(dim=-1)
    w = torch.where(m <= NEG_INF, torch.zeros_like(m), torch.exp(m - m_new[..., None]))
    return m_new, (l * w).sum(dim=-1), (acc * w[..., None]).sum(dim=-2)


def online_softmax_finalize(l, acc, dtype=torch.float32):
    """acc / l, with rows nothing attended to (l == 0) exactly zero."""
    l2 = l[..., None]
    out = torch.where(
        l2 > 0, acc / torch.clamp(l2, min=1e-30), torch.zeros_like(acc)
    )
    return out.to(dtype)
