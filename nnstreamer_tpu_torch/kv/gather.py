"""The block arena, its admission-path ops, and the gather/scatter decode
oracle.

The counterpart of ``nnstreamer_tpu/kv/gather.py``. An arena is a tree of
tensors ``[L, N+1, bs, KV, Dh]``: ``(k, v)`` in the compute dtype, or
``((k8, k_scale), (v8, v_scale))`` for int8 with float32 scales
``[L, N+1, bs, KV]``. Block 0 is scratch: it keeps its init values (zero
payloads, unit scales) under every op here.

The reference's ops are functional (jitted, the arena donated and
returned); here every op that writes updates the arena or stage **in
place** and returns it as well, so one copy of a multi-GB arena lives on
the card. Block ids and masks that only the host decides (admission) are
numpy arrays or ints, so landing a prompt costs no read of the device.

- :func:`init_arena` — the zeroed arena.
- :func:`make_paged_ops` — ``write_block`` / ``read_block`` / ``copy_block``
  (copy-on-write's device half).
- :func:`make_staging_ops` — ``seed_stage`` (matched prefix blocks into a
  chunked-prefill stage) and ``land_stage`` (a staged prompt into its
  blocks), each over the whole span at once.
- :func:`gather_cache` / :func:`scatter_window` — the ``kv_attn="gather"``
  oracle: a contiguous per-slot view ``[L, B, nb·bs, ...]`` through the
  block tables, the slot layout's step on it, then the written window
  scattered back. Logical position ``p`` lands at view column ``p``, so
  masks, RoPE positions and reduction orders are the slot layout's.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from nnstreamer_tpu_torch.models.serving import dequantize_kv, quantize_kv


def _tree_map(f: Callable, *trees):
    """Apply ``f`` leaf-wise over matching nested tuples of tensors."""
    if isinstance(trees[0], tuple):
        return tuple(_tree_map(f, *parts) for parts in zip(*trees))
    return f(*trees)


def _first_leaf(tree) -> torch.Tensor:
    while isinstance(tree, tuple):
        tree = tree[0]
    return tree


def init_arena(n_layers: int, n_blocks: int, block_size: int, kv: int, hd: int,
               quantized: bool, compute_dtype: torch.dtype, device=None):
    """The zeroed arena (+1 scratch block at index 0) with the slot
    cache's init values: int8 payloads zero with unit scales, float zeros,
    so scratch and unwritten rows are finite and masked rows weigh exactly
    zero either way."""
    shape = (n_layers, n_blocks + 1, block_size, kv, hd)
    if quantized:
        return tuple(
            (torch.zeros(shape, dtype=torch.int8, device=device),
             torch.ones(shape[:-1], dtype=torch.float32, device=device))
            for _ in range(2)
        )
    return tuple(torch.zeros(shape, dtype=compute_dtype, device=device) for _ in range(2))


def gather_cache(arena, tables: torch.Tensor):
    """Arena leaves [L, N, bs, ...] → contiguous views [L, B, nb·bs, ...]
    through ``tables`` [B, nb] (a new tensor per leaf; the arena is not
    touched). Works for the float and the int8 tree alike."""
    b, nb = tables.shape
    idx = tables.to(device=_first_leaf(arena).device, dtype=torch.int64)

    def g(a):
        t = a[:, idx]  # [L, B, nb, bs, ...]
        return t.reshape((a.shape[0], b, nb * a.shape[2]) + tuple(a.shape[3:]))

    return _tree_map(g, arena)


def scatter_window(arena, tables: torch.Tensor, view, pos: torch.Tensor, width: int,
                   active: torch.Tensor):
    """Write the ``[pos, pos + width)`` token window of the updated
    contiguous ``view`` back into the arena blocks the tables map, in
    place. The window straddles at most ``(width + bs - 2) // bs + 1``
    blocks, one indexed write each. Inactive slots (and block indices past
    the table) are routed to scratch block 0 carrying its own unchanged
    content, so every duplicate write is of identical bytes."""
    blk = _first_leaf(arena).shape[2]
    b, nb = tables.shape
    nblk = (int(width) + blk - 2) // blk + 1
    pos = pos.to(torch.int64)
    tab = tables.to(torch.int64)
    base = pos // blk
    lanes = torch.arange(b, device=pos.device)[:, None]
    for j in range(nblk):
        lb = base + j  # [B] the logical block this pass writes
        safe = torch.clamp(lb, 0, nb - 1)
        valid = active & (lb * blk < pos + width) & (lb < nb)
        phys = torch.gather(tab, 1, safe[:, None])[:, 0]
        phys = torch.where(valid, phys, torch.zeros_like(phys))
        rows_idx = safe[:, None] * blk + torch.arange(blk, device=pos.device)[None, :]

        def put(a, v, phys=phys, valid=valid, rows_idx=rows_idx):
            rows = v[:, lanes, rows_idx]  # [L, B, bs, ...]
            old = a[:, phys]
            keep = valid.view((1, b) + (1,) * (old.dim() - 2))
            a[:, phys] = torch.where(keep, rows.to(a.dtype), old)

        _tree_map(put, arena, view)
    return arena


def make_paged_ops(quantized: bool, compute_dtype: torch.dtype):
    """Per-block admission ops over one arena layout → ``(write_block,
    read_block, copy_block)``:

    - ``write_block(arena, blk, ks, vs)`` — one block of staged K/V
      ``[L, 1, bs, KV, Dh]`` into arena block ``blk``, quantized per token
      per head for an int8 arena (the slot layout's ``quantize_kv``, so
      paged and slot int8 payloads are identical);
    - ``read_block(arena, blk)`` — one block back as compute-dtype
      ``(ks, vs)`` [L, 1, bs, KV, Dh] (dequantized when int8);
    - ``copy_block(arena, src, dst)`` — the device half of copy-on-write.

    The writers update the arena in place and return it."""

    def write_block(arena, blk: int, ks, vs):
        if quantized:
            (ka, ksc), (va, vsc) = arena
            for (pay, sc), x in (((ka, ksc), ks), ((va, vsc), vs)):
                x8, xs = quantize_kv(x[:, 0])
                pay[:, blk] = x8
                sc[:, blk] = xs
            return arena
        ka, va = arena
        ka[:, blk] = ks[:, 0].to(ka.dtype)
        va[:, blk] = vs[:, 0].to(va.dtype)
        return arena

    def read_block(arena, blk: int):
        if quantized:
            (ka, ksc), (va, vsc) = arena
            ks = dequantize_kv(ka[:, blk], ksc[:, blk])
            vs = dequantize_kv(va[:, blk], vsc[:, blk])
        else:
            ka, va = arena
            ks, vs = ka[:, blk], va[:, blk]
        return ks.to(compute_dtype)[:, None], vs.to(compute_dtype)[:, None]

    def copy_block(arena, src: int, dst: int):
        def cp(a):
            a[:, dst] = a[:, src]

        _tree_map(cp, arena)
        return arena

    return write_block, read_block, copy_block


def make_staging_ops(quantized: bool, compute_dtype: torch.dtype):
    """Admission staging over whole spans → ``(seed_stage, land_stage)``
    for a chunked-prefill stage ``(ks, vs)`` [L, 1, S·bs, KV, Dh] in the
    compute dtype; ``ids`` holds one arena block id per stage block:

    - ``seed_stage(arena, stage, ids, n_seed)`` — arena blocks
      ``ids[:n_seed]`` (dequantized when int8) into the stage's leading
      ``n_seed`` blocks: the prefix-seeded prefill source;
    - ``land_stage(arena, stage, ids, valid)`` — every stage block ``i``
      with ``valid[i]`` into arena block ``ids[i]`` (quantized when int8,
      per token per head, so landing block by block changes nothing);
      blocks not valid are not written, so scratch stays as it was.

    Values equal the per-block ops'. Both update their target in place and
    return it."""

    def seed_stage(arena, stage, ids, n_seed: int):
        n = int(n_seed)
        if n == 0:
            return stage
        first = _first_leaf(arena)
        sel = torch.as_tensor(np.asarray(ids[:n], np.int64), device=first.device)
        if quantized:
            (ka, ksc), (va, vsc) = arena
            tk = dequantize_kv(ka[:, sel], ksc[:, sel])  # [L, n, bs, KV, Dh]
            tv = dequantize_kv(va[:, sel], vsc[:, sel])
        else:
            ka, va = arena
            tk, tv = ka[:, sel], va[:, sel]
        bs = first.shape[2]
        for s, t in ((stage[0], tk), (stage[1], tv)):
            s[:, 0, : n * bs] = t.reshape((t.shape[0], n * bs) + tuple(t.shape[3:])).to(s.dtype)
        return stage

    def land_stage(arena, stage, ids, valid):
        ks, vs = stage
        sel = np.nonzero(np.asarray(valid, bool))[0]
        if sel.size == 0:
            return arena
        first = _first_leaf(arena)
        bs = first.shape[2]
        n_stage = ks.shape[2] // bs
        src = torch.as_tensor(sel, device=first.device)
        dst = torch.as_tensor(np.asarray(ids, np.int64)[sel], device=first.device)

        def rows_of(s):  # [L, 1, S·bs, ...] → the selected blocks [L, n, bs, ...]
            return s.reshape((s.shape[0], n_stage, bs) + tuple(s.shape[3:]))[:, src]

        if quantized:
            (ka, ksc), (va, vsc) = arena
            for (pay, sc), s in (((ka, ksc), ks), ((va, vsc), vs)):
                x8, xs = quantize_kv(rows_of(s))
                pay[:, dst] = x8
                sc[:, dst] = xs
            return arena
        ka, va = arena
        ka[:, dst] = rows_of(ks).to(ka.dtype)
        va[:, dst] = rows_of(vs).to(va.dtype)
        return arena

    return seed_stage, land_stage

