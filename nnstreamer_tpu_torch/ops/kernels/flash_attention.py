"""Flash prefill attention: the CUDA kernel K5 and its plain version.

Replaces the Pallas TPU kernel ``nnstreamer_tpu/ops/pallas/flash_attention.py``
(``flash_attention``, body ``_kernel``, blocking ``_blocking``). The kernel
is ``csrc/flash_attention.cu`` (CUDA C++ for ``sm_90a``, built by ``nvcc`` at
first use and bound with ``ctypes``) over the recurrence of
``csrc/attn_primitives.cuh``: wgmma on the tensor cores for 16-bit inputs
(P·V as a two-term split product), 3xTF32 ``mma.sync`` for float32; its
design and its bounds are noted there. :func:`plain_flash_attention` is the
same function written with the plain primitives of ``_primitives.py``, tiled
as the reference tiles it.

Shapes: q, k, v [B, T, H, D] (K/V already repeated to H heads) → o
[B, T, H, D] float32, causal or full attention, scale 1/sqrt(D) unless
given. q, k and v are float32, bfloat16 or float16, all three alike,
widened to float32 before any product (the kernel keeps 2e-5 of that).
The plain version takes any D >= 1; the kernel takes D % 8 == 0 up to 256
(:func:`kernel_takes_head_dim`), and a CUDA call with any other D raises
before a launch.

``block_q`` and ``block_k`` set the plain version's tiles (``_blocking``:
T padded up to a block multiple, padded key columns masked, padded query
rows dropped), which changes only its order of summation: the function is
the same for any value. The kernel picks its own tiles (64 query rows; 64
keys for 16-bit inputs, 32 for float32) and ignores them.

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
import torch.nn.functional as F

from nnstreamer_tpu_torch.ops.kernels import LaunchCounter
from nnstreamer_tpu_torch.ops.kernels._primitives import (
    NEG_INF,
    online_softmax_finalize,
    online_softmax_init,
    online_softmax_update,
    scaled_qk,
)

#: the largest head dim the kernel takes (it takes every multiple of 8 up to it)
MAX_KERNEL_HEAD_DIM = 256

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: launches of the K5 CUDA kernel
flash_attention_launches = LaunchCounter()


def _blocking(t: int, block_q: int, block_k: int):
    """(bq, bk, t_pad, n_q, n_k), the reference's ``_blocking``: T pads up
    to a block multiple; tiny sequences shrink the block (floor 16)."""
    bq = min(block_q, max(t, 16))
    bk = min(block_k, max(t, 16))
    blk = max(bq, bk)
    t_pad = -(-t // blk) * blk
    return bq, bk, t_pad, t_pad // bq, t_pad // bk


def plain_flash_attention(q, k, v, causal: bool = True, scale: Optional[float] = None,
                          block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """The plain PyTorch version of the kernel: the primitives' recurrence
    over key blocks in order, all query blocks at once. A key block is
    skipped where the reference's ``live`` predicate is false (past T, or
    for the query blocks wholly above the diagonal), and masked per element
    elsewhere. Same arguments and result as :func:`flash_attention`."""
    b, t, h, d = q.shape
    sc = scale if scale is not None else 1.0 / (d ** 0.5)
    bq, bk, t_pad, n_q, n_k = _blocking(t, block_q, block_k)

    def to_bh(x):  # [B, T, H, D] → [B, H, t_pad, D] float32, zero rows past T
        return F.pad(x.float().permute(0, 2, 1, 3), (0, 0, 0, t_pad - t))

    qb = to_bh(q).reshape(b, h, n_q, bq, d)
    kb, vb = to_bh(k), to_bh(v)
    m = torch.empty((b, h, n_q, bq), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    acc = torch.empty((b, h, n_q, bq, d), dtype=torch.float32, device=q.device)
    online_softmax_init(m, l, acc)
    rows = torch.arange(t_pad, device=q.device).reshape(n_q, bq, 1)
    for ki in range(n_k):
        k0 = ki * bk
        if k0 >= t:  # this block and every later one hold padding only
            break
        lo = k0 // bq if causal else 0  # the first query block with a live entry
        cols = k0 + torch.arange(bk, device=q.device)
        mask = cols < t
        if causal:
            mask = mask & (rows[lo:] >= cols)
        s = scaled_qk(qb[:, :, lo:], kb[:, :, None, k0:k0 + bk], sc)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m[:, :, lo:], l[:, :, lo:], acc[:, :, lo:] = online_softmax_update(
            s, vb[:, :, None, k0:k0 + bk], m[:, :, lo:], l[:, :, lo:], acc[:, :, lo:]
        )
    out = online_softmax_finalize(l, acc).reshape(b, h, t_pad, d)[:, :, :t]
    return out.permute(0, 2, 1, 3).contiguous()


def _check(q, k, v) -> None:
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"flash attention takes q, k, v [B, T, H, D] of one shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if q.shape[-1] == 0 or q.shape[1] == 0:
        raise ValueError(f"flash attention takes D > 0 and T > 0, got {tuple(q.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash attention takes float32, bfloat16 or float16 q, k, v of one dtype, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError(f"flash attention operands on several devices: "
                         f"{q.device}, {k.device}, {v.device}")


def kernel_takes_head_dim(d: int) -> bool:
    """Whether the CUDA kernel takes head dim ``d``: a multiple of 8 (its
    16-byte loads) up to :data:`MAX_KERNEL_HEAD_DIM`."""
    return 0 < d <= MAX_KERNEL_HEAD_DIM and d % 8 == 0


@functools.cache
def _kernel_fn():
    """``nns_flash_attention`` from the built library, with its C signature
    (set once, at the first launch)."""
    from nnstreamer_tpu_torch.ops.kernels import _build

    fn = _build.load("flash_attention").nns_flash_attention
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    return fn


def _cuda_flash_attention(q, k, v, causal: bool, scale: float) -> torch.Tensor:
    """Launch the kernel on checked CUDA tensors → o [B, T, H, D] float32,
    still being computed on the current stream. Each of q, k, v may be a
    strided view whose last axis is contiguous and whose rows start on a
    16-byte boundary (the kernel's cp.async loads)."""
    b, t_len, h, d = q.shape
    if not kernel_takes_head_dim(d):
        raise ValueError(
            f"the flash attention kernel takes D % 8 == 0 and D <= {MAX_KERNEL_HEAD_DIM}, "
            f"got D {d} (the CPU's plain version takes any D)"
        )
    for name, t in (("q", q), ("k", k), ("v", v)):
        vec = 16 // t.element_size()  # elements in 16 bytes
        if t.stride(-1) != 1 or any(s % vec for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(
                f"flash attention needs {name} with a contiguous last axis, strides that are "
                f"multiples of {vec} elements and a 16-byte aligned start, got strides "
                f"{t.stride()}"
            )
    strides = (ctypes.c_longlong * 9)(*(s for x in (q, k, v) for s in x.stride()[:3]))
    fn = _kernel_fn()
    out = torch.empty((b, t_len, h, d), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _DTYPES[q.dtype], out.data_ptr(),
                 b, t_len, h, d, strides, float(scale), int(causal), stream)
    if err != 0:
        raise RuntimeError(f"nns_flash_attention launch failed: cudaError_t {err}")
    flash_attention_launches.add()
    return out


@torch.library.custom_op("nns::flash_attention", mutates_args=())
def _flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                        scale: float, block_q: int, block_k: int) -> torch.Tensor:
    """K5 on checked operands: the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if q.is_cuda:
        return _cuda_flash_attention(q, k, v, causal, scale)
    if q.device.type == "cpu":
        return plain_flash_attention(q, k, v, causal, scale, block_q, block_k)
    raise RuntimeError(
        f"flash attention kernel has no implementation on {q.device} "
        "(CUDA launches the kernel, CPU takes the plain version)"
    )


@_flash_attention_op.register_fake
def _(q, k, v, causal, scale, block_q, block_k):
    return q.new_empty(q.shape, dtype=torch.float32)


@_flash_attention_op.register_vmap
def _(info, in_dims, q, k, v, causal, scale, block_q, block_k):
    """The vmapped axis folds into B: [V, B, T, H, D] → one launch over
    V·B sequences (an operand the rows share is expanded to them)."""
    ops = []
    for x, d in zip((q, k, v), in_dims[:3]):
        ops.append(x.movedim(d, 0) if d is not None else x.expand((info.batch_size,) + x.shape))
    lead = ops[0].shape[:-3]
    flat = [x.reshape((-1,) + x.shape[-3:]) for x in ops]
    out = _flash_attention_op(*flat, causal, scale, block_q, block_k)
    return out.reshape(lead + out.shape[1:]), 0


def flash_attention(q, k, v, causal: bool = True, scale: Optional[float] = None,
                    block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """q, k, v [B, T, H, D] → o [B, T, H, D] float32: the kernel on CUDA
    tensors, the plain version on CPU tensors (the op ``nns::flash_attention``,
    whose vmap rule folds a vmapped axis into B)."""
    _check(q, k, v)
    sc = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    if q.device.type not in ("cuda", "cpu"):
        raise RuntimeError(
            f"flash attention kernel has no implementation on {q.device} "
            "(CUDA launches the kernel, CPU takes the plain version)"
        )
    return _flash_attention_op(q, k, v, bool(causal), float(sc), int(block_q), int(block_k))


def make_flash_attention(**kwargs):
    """The transformer's ``attn_fn(q, k, v, causal)`` through
    :func:`flash_attention`; ``kwargs`` (``scale``, ``block_q``,
    ``block_k``) go to every call."""

    def attn(q, k, v, causal: bool = True):
        return flash_attention(q, k, v, causal=causal, **kwargs)

    return attn
