"""Decode attention through block tables: the CUDA kernel K4 and its
plain version.

Replaces the Pallas TPU kernel ``nnstreamer_tpu/ops/pallas/paged_attention.py``
(``paged_decode_attention``, body ``_kernel``). The kernel is
``csrc/paged_attention.cu`` (CUDA C++ for ``sm_90a``, built by ``nvcc`` at
first use and bound with ``ctypes``), which splits each slot's history in
chunks across blocks as K3 does (the history loop of ``csrc/attn_tile.cuh``
over the recurrence of ``csrc/attn_primitives.cuh``, the launch plan
``decode_attention.split_plan``), then merges the chunks and folds the
pending token last in a combine kernel; its design and its bound are noted
there.
:func:`plain_paged_attention` is the same function written with the plain
primitives of ``_primitives.py`` (the port of
``nnstreamer_tpu/kv/block_attn.py paged_attention_ref``).

Shapes are the paged serving layout: q [B, 1, H, D]; one layer's arena
``arena_k``/``arena_v`` [N, bs, KV, D] with KV dividing H; block tables
[B, nb] int32; pos [B], the history length (positions 0 .. pos-1 live in
arena blocks, row r at row r % bs of block ``tables[b, r // bs]``, clamped
to the table's reach nb·bs); ``fresh_k``/``fresh_v`` [B, 1, KV, D], the
pending token's K/V at position pos, folded in last → o [B, 1, H, D]
float32. q is float32 or bfloat16; the arena float32, bfloat16, or int8
with per-token-per-head float32 scales [N, bs, KV] (``k_scale`` and
``v_scale`` together); the fresh K/V float32 or q's dtype.

Table entries past a slot's history are never read. Those it does read
are the caller's contract: the kernel does not check them (that would
cost a read of the host), the plain version asserts them on the CPU.

Dispatch is by the device of the tensors, nothing else: a CUDA tensor
launches the kernel (and raises if the launch fails), a CPU tensor takes
the plain version, anything else raises. An unsupported dtype or shape
raises on every device. There is no fallback from the kernel to the plain
version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from nnstreamer_tpu_torch.ops.kernels import LaunchCounter
from nnstreamer_tpu_torch.ops.kernels._primitives import (
    dequant_rows,
    mask_dead_columns,
    online_softmax_finalize,
    online_softmax_init,
    online_softmax_update,
    scaled_qk,
)
from nnstreamer_tpu_torch.ops.kernels.decode_attention import split_plan

#: largest head dim and query heads per kv head the kernel takes
MAX_HEAD_DIM = 256
MAX_GROUP = 32

_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARENA_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

#: launches of the K4 CUDA kernel
paged_decode_attention_launches = LaunchCounter()


def _history(pos, nb: int, bs: int) -> torch.Tensor:
    """Per-slot history length min(max(pos, 0), nb·bs), int64."""
    return torch.clamp(pos.to(torch.int64), min=0, max=nb * bs)


def plain_paged_attention(q, arena_k, arena_v, tables, pos, fresh_k, fresh_v,
                          k_scale=None, v_scale=None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """The plain PyTorch version of the kernel: the live history taken
    through the tables and the primitives' recurrence applied to it at
    once, then the fresh column. Same arguments and result as
    :func:`paged_decode_attention`."""
    b, _, h, d = q.shape
    n_blocks, bs, n_kv = arena_k.shape[:3]
    nb = tables.shape[1]
    g = h // n_kv
    sc = scale if scale is not None else 1.0 / (d ** 0.5)
    hist = _history(pos, nb, bs)
    # table entries past the history are never read: point them at block 0
    live_blk = torch.arange(nb, device=q.device)[None, :] * bs < hist[:, None]
    tab = torch.where(live_blk, tables.to(torch.int64), torch.zeros_like(tables, dtype=torch.int64))
    if tab.device.type == "cpu" and not bool(((tab >= 0) & (tab < n_blocks)).all()):
        raise IndexError(f"a live block-table entry lies outside the arena's {n_blocks} blocks")
    s_len = nb * bs
    qf = q.float()[:, 0].reshape(b, n_kv, g, d)                              # [B, KV, g, D]
    k = arena_k[tab].reshape(b, s_len, n_kv, d).permute(0, 2, 1, 3)          # [B, KV, S, D]
    v = arena_v[tab].reshape(b, s_len, n_kv, d).permute(0, 2, 1, 3)
    if k_scale is not None:
        k = dequant_rows(k, k_scale[tab].reshape(b, s_len, n_kv).permute(0, 2, 1))
        v = dequant_rows(v, v_scale[tab].reshape(b, s_len, n_kv).permute(0, 2, 1))
    s = scaled_qk(qf, k, sc)                                                 # [B, KV, g, S]
    cols = torch.arange(s_len, device=q.device)
    s, v = mask_dead_columns(s, v.float(), cols, hist.view(b, 1, 1, 1))
    m = torch.empty((b, n_kv, g), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    acc = torch.empty((b, n_kv, g, d), dtype=torch.float32, device=q.device)
    online_softmax_init(m, l, acc)
    m, l, acc = online_softmax_update(s, v, m, l, acc)
    # the pending token's column (position pos, always live), folded last
    fk = fresh_k.float()[:, 0][:, :, None, :]                               # [B, KV, 1, D]
    fv = fresh_v.float()[:, 0][:, :, None, :]
    _, l, acc = online_softmax_update(scaled_qk(qf, fk, sc), fv, m, l, acc)
    return online_softmax_finalize(l, acc, torch.float32).reshape(b, 1, h, d)


def _check(q, arena_k, arena_v, tables, pos, fresh_k, fresh_v, k_scale, v_scale) -> None:
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"paged attention q must be [B, 1, H, D], got {tuple(q.shape)}")
    b, _, h, d = q.shape
    if arena_k.dim() != 4 or arena_k.shape != arena_v.shape:
        raise ValueError(
            f"paged attention arenas must be [N, bs, KV, D] and alike, got "
            f"{tuple(arena_k.shape)} and {tuple(arena_v.shape)}"
        )
    n_kv = arena_k.shape[2]
    if arena_k.shape[3] != d:
        raise ValueError(f"arena {tuple(arena_k.shape)} does not match q {tuple(q.shape)}")
    if h % n_kv:
        raise ValueError(f"query heads {h} not divisible by kv heads {n_kv}")
    if h // n_kv > MAX_GROUP or d > MAX_HEAD_DIM or d % 4:
        raise ValueError(
            f"paged attention takes H/KV <= {MAX_GROUP} and D <= {MAX_HEAD_DIM} "
            f"with D % 4 == 0, got H/KV={h // n_kv}, D={d}"
        )
    if tables.dim() != 2 or tables.shape[0] != b or tables.dtype != torch.int32:
        raise ValueError(
            f"block tables must be [{b}, nb] int32, got {tuple(tables.shape)} {tables.dtype}"
        )
    if pos.shape != (b,) or pos.dtype.is_floating_point:
        raise ValueError(f"pos must be [{b}] integers, got {tuple(pos.shape)} {pos.dtype}")
    if q.dtype not in _Q_DTYPES:
        raise TypeError(f"paged attention q must be float32 or bfloat16, got {q.dtype}")
    if arena_k.dtype not in _ARENA_DTYPES or arena_v.dtype != arena_k.dtype:
        raise TypeError(
            f"paged attention arenas must be float32, bfloat16 or int8, got "
            f"{arena_k.dtype} and {arena_v.dtype}"
        )
    for name, f in (("fresh_k", fresh_k), ("fresh_v", fresh_v)):
        if f.shape != (b, 1, n_kv, d):
            raise ValueError(f"{name} must be [{b}, 1, {n_kv}, {d}], got {tuple(f.shape)}")
        if f.dtype not in (torch.float32, q.dtype):
            raise TypeError(f"{name} must be float32 or q's {q.dtype}, got {f.dtype}")
    if fresh_k.dtype != fresh_v.dtype:
        raise TypeError(f"fresh_k {fresh_k.dtype} and fresh_v {fresh_v.dtype} differ")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be passed together")
    quantized = k_scale is not None
    if quantized != (arena_k.dtype == torch.int8):
        raise TypeError("an int8 arena needs k_scale and v_scale; a float arena takes none")
    if quantized:
        for sc in (k_scale, v_scale):
            if sc.shape != arena_k.shape[:3] or sc.dtype != torch.float32:
                raise ValueError(
                    f"scales must be float32 {tuple(arena_k.shape[:3])}, got "
                    f"{tuple(sc.shape)} {sc.dtype}"
                )
    operands = (q, arena_k, arena_v, tables, pos, fresh_k, fresh_v, k_scale, v_scale)
    devices = {t.device for t in operands if t is not None}
    if len(devices) != 1:
        raise ValueError(f"paged attention operands on several devices: {devices}")


@functools.cache
def _kernel_fn():
    """``nns_paged_attention`` from the built library, with its C
    signature (set once, at the first launch)."""
    from nnstreamer_tpu_torch.ops.kernels import _build

    fn = _build.load("paged_attention").nns_paged_attention
    fn.restype = ctypes.c_int
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [
        p, i, p, p, i, p, p, p, p, p, p, i, p, p,
        i, i, i, i, i, i, i, i, ctypes.c_float, p,
    ]
    return fn


def _cuda_paged_attention(q, arena_k, arena_v, tables, pos, fresh_k, fresh_v,
                          k_scale, v_scale, scale) -> torch.Tensor:
    """Launch the kernel on checked CUDA tensors → o [B, 1, H, D] float32,
    still being computed on the current stream."""
    for name, t in (("arena_k", arena_k), ("arena_v", arena_v), ("tables", tables),
                    ("k_scale", k_scale), ("v_scale", v_scale)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"paged attention needs a contiguous {name}")
    if arena_k.data_ptr() % 16 or arena_v.data_ptr() % 16:
        raise ValueError("paged attention needs 16-byte aligned arenas")
    b, _, h, d = q.shape
    bs, n_kv = arena_k.shape[1], arena_k.shape[2]
    q = q.contiguous()
    fresh_k, fresh_v = fresh_k.contiguous(), fresh_v.contiguous()
    pos = pos.to(torch.int32).contiguous()
    fn = _kernel_fn()
    plan = split_plan(tables.shape[1] * bs)
    out = torch.empty((b, 1, h, d), dtype=torch.float32, device=q.device)
    # the chunks' partial states: acc [D], then m and l
    ws = torch.empty((b, h, plan.splits, d + 2), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), _Q_DTYPES[q.dtype], arena_k.data_ptr(), arena_v.data_ptr(),
            _ARENA_DTYPES[arena_k.dtype],
            k_scale.data_ptr() if k_scale is not None else None,
            v_scale.data_ptr() if v_scale is not None else None,
            tables.data_ptr(), pos.data_ptr(), fresh_k.data_ptr(), fresh_v.data_ptr(),
            _Q_DTYPES[fresh_k.dtype], out.data_ptr(), ws.data_ptr(),
            b, tables.shape[1], bs, h, n_kv, d, plan.chunk, plan.splits, float(scale), stream,
        )
    if err != 0:
        raise RuntimeError(f"nns_paged_attention launch failed: cudaError_t {err}")
    paged_decode_attention_launches.add()
    return out


@torch.library.custom_op("nns::paged_decode_attention", mutates_args=())
def _paged_attention_op(q: torch.Tensor, arena_k: torch.Tensor, arena_v: torch.Tensor,
                        tables: torch.Tensor, pos: torch.Tensor, fresh_k: torch.Tensor,
                        fresh_v: torch.Tensor, k_scale: Optional[torch.Tensor],
                        v_scale: Optional[torch.Tensor], scale: float) -> torch.Tensor:
    """K4 on checked operands: the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    args = (q, arena_k, arena_v, tables, pos, fresh_k, fresh_v, k_scale, v_scale, scale)
    if q.is_cuda:
        return _cuda_paged_attention(*args)
    if q.device.type == "cpu":
        return plain_paged_attention(*args)
    raise RuntimeError(
        f"paged attention kernel has no implementation on {q.device} "
        "(CUDA launches the kernel, CPU takes the plain version)"
    )


@_paged_attention_op.register_fake
def _(q, arena_k, arena_v, tables, pos, fresh_k, fresh_v, k_scale, v_scale, scale):
    return q.new_empty(q.shape, dtype=torch.float32)


@_paged_attention_op.register_vmap
def _(info, in_dims, *args):
    """Refused: K4's batch is the slots of a serving step, written out in
    its operands; it has no batching rule, so a vmap that reaches it
    raises (never the dispatcher's per-row loop)."""
    raise NotImplementedError(
        "nns::paged_decode_attention (K4) has no vmap rule: its batch is the slot axis of "
        "its operands; call it on the batched tensors")


def paged_decode_attention(q, arena_k, arena_v, tables, pos, fresh_k, fresh_v,
                           k_scale=None, v_scale=None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """q [B,1,H,D], arena_k/v [N,bs,KV,D] (int8 with ``k_scale``/``v_scale``
    [N,bs,KV]), tables [B,nb] int32, pos [B], fresh_k/v [B,1,KV,D] →
    o [B,1,H,D] float32: the kernel on CUDA tensors, the plain version on
    CPU tensors (the op ``nns::paged_decode_attention``)."""
    _check(q, arena_k, arena_v, tables, pos, fresh_k, fresh_v, k_scale, v_scale)
    sc = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    if q.device.type not in ("cuda", "cpu"):
        raise RuntimeError(
            f"paged attention kernel has no implementation on {q.device} "
            "(CUDA launches the kernel, CPU takes the plain version)"
        )
    return _paged_attention_op(q, arena_k, arena_v, tables, pos, fresh_k, fresh_v,
                               k_scale, v_scale, float(sc))


def make_paged_attention():
    """The ``attn(q, k_entry, v_entry, tables, pos, (fk, fv))`` the
    block-native serving step calls: float arena layers, or the int8
    entries ``(payload, scales)``, dequantized in the kernel; ``fk``/``fv``
    are the pending token's (already dequantized) K/V."""

    def attn(q, cache_k, cache_v, tables, pos, fresh_kv):
        fk, fv = fresh_kv
        if isinstance(cache_k, tuple):
            (k8, ks), (v8, vs) = cache_k, cache_v
            return paged_decode_attention(q, k8, v8, tables, pos, fk, fv, k_scale=ks, v_scale=vs)
        return paged_decode_attention(q, cache_k, cache_v, tables, pos, fk, fv)

    return attn
