"""Single-token decode attention: the CUDA kernel K3 and its plain version.

Replaces the Pallas TPU kernel ``nnstreamer_tpu/ops/pallas/decode_attention.py``
(``decode_attention``, body ``_kernel``). The kernel is
``csrc/decode_attention.cu`` (CUDA C++ for ``sm_90a``, built by ``nvcc`` at
first use and bound with ``ctypes``), which includes the shared recurrence
of ``csrc/attn_primitives.cuh``; its design and its bound are noted there.
:func:`plain_decode_attention` is the same function written with the plain
primitives of ``_primitives.py`` (the port of ``decode_attention_ref``).

Shapes are the serving layout: q [B, 1, H, D], cache [B, S, KV, D] with
KV dividing H (grouped-query attention), pos [B] → o [B, 1, H, D] float32.
Columns 0 .. min(pos[b], S - 1) of slot b are attended. q is float32 or
bfloat16; the cache is float32, bfloat16, or int8 with per-token-per-head
float32 scales [B, S, KV] (``k_scale`` and ``v_scale`` together).

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

#: largest head dim and query heads per kv head the kernel takes
MAX_HEAD_DIM = 256
MAX_GROUP = 32

_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_CACHE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

#: launches of the K3 CUDA kernel
decode_attention_launches = LaunchCounter()


def plain_decode_attention(
    q, cache_k, cache_v, pos, k_scale=None, v_scale=None, scale: Optional[float] = None
) -> torch.Tensor:
    """The plain PyTorch version of the kernel: the primitives' recurrence
    applied to the whole cache at once. Same arguments and result as
    :func:`decode_attention`."""
    b, _, h, d = q.shape
    s_len, n_kv = cache_k.shape[1], cache_k.shape[2]
    g = h // n_kv
    sc = scale if scale is not None else 1.0 / (d ** 0.5)
    qf = q.float()[:, 0].reshape(b, n_kv, g, d)        # [B, KV, g, D]
    k = cache_k.permute(0, 2, 1, 3)                     # [B, KV, S, D]
    v = cache_v.permute(0, 2, 1, 3)
    if k_scale is not None:
        k = dequant_rows(k, k_scale.permute(0, 2, 1))
        v = dequant_rows(v, v_scale.permute(0, 2, 1))
    s = scaled_qk(qf, k, sc)                            # [B, KV, g, S]
    cols = torch.arange(s_len, device=q.device)
    # min(pos + 1, S): a wrapped ring passes absolute positions past S
    live = torch.clamp(pos.to(torch.int64) + 1, max=s_len).view(b, 1, 1, 1)
    s, v = mask_dead_columns(s, v.float(), cols, live)
    m0 = torch.empty((b, n_kv, g), dtype=torch.float32, device=q.device)
    l0 = torch.empty_like(m0)
    acc0 = torch.empty((b, n_kv, g, d), dtype=torch.float32, device=q.device)
    online_softmax_init(m0, l0, acc0)
    _, l, acc = online_softmax_update(s, v, m0, l0, acc0)
    return online_softmax_finalize(l, acc, torch.float32).reshape(b, 1, h, d)


def _check(q, cache_k, cache_v, pos, k_scale, v_scale) -> None:
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"decode attention q must be [B, 1, H, D], got {tuple(q.shape)}")
    b, _, h, d = q.shape
    if cache_k.dim() != 4 or cache_k.shape != cache_v.shape:
        raise ValueError(
            f"decode attention caches must be [B, S, KV, D] and alike, got "
            f"{tuple(cache_k.shape)} and {tuple(cache_v.shape)}"
        )
    if cache_k.shape[0] != b or cache_k.shape[3] != d:
        raise ValueError(f"cache {tuple(cache_k.shape)} does not match q {tuple(q.shape)}")
    n_kv = cache_k.shape[2]
    if h % n_kv:
        raise ValueError(f"query heads {h} not divisible by kv heads {n_kv}")
    if h // n_kv > MAX_GROUP or d > MAX_HEAD_DIM or d % 4:
        raise ValueError(
            f"decode attention takes H/KV <= {MAX_GROUP} and D <= {MAX_HEAD_DIM} "
            f"with D % 4 == 0, got H/KV={h // n_kv}, D={d}"
        )
    if pos.shape != (b,) or pos.dtype.is_floating_point:
        raise ValueError(f"pos must be [{b}] integers, got {tuple(pos.shape)} {pos.dtype}")
    if q.dtype not in _Q_DTYPES:
        raise TypeError(f"decode attention q must be float32 or bfloat16, got {q.dtype}")
    if cache_k.dtype not in _CACHE_DTYPES or cache_v.dtype != cache_k.dtype:
        raise TypeError(
            f"decode attention caches must be float32, bfloat16 or int8, got "
            f"{cache_k.dtype} and {cache_v.dtype}"
        )
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be passed together")
    quantized = k_scale is not None
    if quantized != (cache_k.dtype == torch.int8):
        raise TypeError("an int8 cache needs k_scale and v_scale; a float cache takes none")
    if quantized:
        for sc in (k_scale, v_scale):
            if sc.shape != cache_k.shape[:3] or sc.dtype != torch.float32:
                raise ValueError(
                    f"scales must be float32 {tuple(cache_k.shape[:3])}, got "
                    f"{tuple(sc.shape)} {sc.dtype}"
                )
    devices = {t.device for t in (q, cache_k, cache_v, pos) if t is not None}
    devices |= {t.device for t in (k_scale, v_scale) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"decode attention operands on several devices: {devices}")


@functools.cache
def _kernel_fn():
    """``nns_decode_attention`` from the built library, with its C
    signature (set once, at the first launch)."""
    from nnstreamer_tpu_torch.ops.kernels import _build

    fn = _build.load("decode_attention").nns_decode_attention
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p,
    ]
    return fn


def _cuda_decode_attention(q, cache_k, cache_v, pos, k_scale, v_scale, scale) -> torch.Tensor:
    """Launch the kernel on checked CUDA tensors → o [B, 1, H, D] float32,
    still being computed on the current stream."""
    for name, t in (("cache_k", cache_k), ("cache_v", cache_v),
                    ("k_scale", k_scale), ("v_scale", v_scale)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"decode attention needs a contiguous {name}")
    if cache_k.data_ptr() % 16 or cache_v.data_ptr() % 16:
        raise ValueError("decode attention needs 16-byte aligned caches")
    b, _, h, d = q.shape
    s_len, n_kv = cache_k.shape[1], cache_k.shape[2]
    q = q.contiguous()
    pos = pos.to(torch.int32).contiguous()
    fn = _kernel_fn()
    out = torch.empty((b, 1, h, d), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), _Q_DTYPES[q.dtype], cache_k.data_ptr(), cache_v.data_ptr(),
            _CACHE_DTYPES[cache_k.dtype],
            k_scale.data_ptr() if k_scale is not None else None,
            v_scale.data_ptr() if v_scale is not None else None,
            pos.data_ptr(), out.data_ptr(), b, s_len, h, n_kv, d, float(scale), stream,
        )
    if err != 0:
        raise RuntimeError(f"nns_decode_attention launch failed: cudaError_t {err}")
    decode_attention_launches.add()
    return out


def decode_attention(
    q, cache_k, cache_v, pos, k_scale=None, v_scale=None, scale: Optional[float] = None
) -> torch.Tensor:
    """q [B,1,H,D], cache_k/v [B,S,KV,D] (int8 with ``k_scale``/``v_scale``
    [B,S,KV]), pos [B] → o [B,1,H,D] float32: the kernel on CUDA tensors,
    the plain version on CPU tensors."""
    _check(q, cache_k, cache_v, pos, k_scale, v_scale)
    sc = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    if q.is_cuda:
        return _cuda_decode_attention(q, cache_k, cache_v, pos, k_scale, v_scale, sc)
    if q.device.type == "cpu":
        return plain_decode_attention(q, cache_k, cache_v, pos, k_scale, v_scale, sc)
    raise RuntimeError(
        f"decode attention kernel has no implementation on {q.device} "
        "(CUDA launches the kernel, CPU takes the plain version)"
    )


def make_decode_attention():
    """The ``attn(q, ck, cv, pos)`` the serving step calls: float caches,
    or the int8 cache entries ``(ck8, k_scale)`` / ``(cv8, v_scale)``
    (``models/serving.py quantize_kv`` layout), dequantized in the kernel."""

    def attn(q, cache_k, cache_v, pos):
        if isinstance(cache_k, tuple):
            (k8, ks), (v8, vs) = cache_k, cache_v
            return decode_attention(q, k8, v8, pos, k_scale=ks, v_scale=vs)
        return decode_attention(q, cache_k, cache_v, pos)

    return attn
