"""Bilinear crop/resize/normalize: the CUDA kernel K1 and its plain version.

Replaces the Pallas TPU kernel ``nnstreamer_tpu/ops/pallas/image_kernels.py``
(``_launch_crop``, reached by ``resize_bilinear`` and ``crop_and_resize``).
The kernel is ``csrc/image_kernels.cu`` (CUDA C++ for ``sm_90a``, built by
``nvcc`` at first use and bound with ``ctypes``); its design and its bound
are noted there.

Dispatch is by the device of the image, nothing else: a CUDA tensor
launches the kernel (and raises if the launch fails), a CPU tensor takes
:func:`plain_crop_resize`, anything else raises. There is no fallback from
the kernel to the plain version.

The kernel is the custom op ``nns::crop_resize``: a fake (shapes alone,
for fake-tensor traces) and a vmap rule are registered beside it. Under
``torch.func.vmap`` the rule folds the vmapped axis into the op's boxes,
so a window of B frames is ONE launch: B images with their boxes
(``boxes_per_image`` boxes each), one image shared by B·N boxes, or B·N
full-image resizes. The reference's counterpart is ``jax.vmap`` of its
``pallas_call``.

Numerics: sample centres ``lo + (hi - lo)·(i + 0.5)/out - 0.5``, the
floor-and-clip formulation of ``nnstreamer_tpu/ops/image.py`` (two taps per
axis, indices clipped to the image), interpolation in float32, then the
optional ``·scale + offset`` epilogue, then round-half-to-even and clip
for integer outputs.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from nnstreamer_tpu_torch.ops.kernels import LaunchCounter

_IN_DTYPES = {torch.uint8: 0, torch.float32: 1, torch.bfloat16: 2}

#: launches of the K1 CUDA kernel (both entry points share it)
crop_resize_launches = LaunchCounter()
#: the same launches by entry point: crop_and_resize (boxes given) and
#: resize_bilinear (the full image)
crop_entry_launches = LaunchCounter()
resize_entry_launches = LaunchCounter()


def interp_atol(dtype: torch.dtype, h: int, w: int) -> float:
    """Parity tolerance against the reference's jnp/Pallas versions: they
    round the float32 sample coordinates differently, and at magnitude
    max(h, w) one coordinate ulp moves an O(1) weight by that much. The
    same formula as ``_interp_atol`` in the JAX package."""
    if not dtype.is_floating_point:
        return 1.0
    return max(1e-4, 8 * max(h, w) * 2.0 ** -23)


def _round_clip_cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """float → ``dtype``: integers round half to even and clip to the
    dtype's range (the tensor_crop convention), floats just cast."""
    if not dtype.is_floating_point:
        info = torch.iinfo(dtype)
        x = torch.clamp(torch.round(x), info.min, info.max)
    return x.to(dtype)


def _axis_taps(lo: torch.Tensor, hi: torch.Tensor, out_n: int, in_n: int):
    """[B] interval ends → ([B, out_n] low index, high index, weight)."""
    i = torch.arange(out_n, dtype=torch.float32, device=lo.device)
    t = (hi - lo)[:, None] * (i + 0.5)
    # tensor / tensor: a true division on every device (a scalar divisor
    # may become a multiply by its reciprocal, one ulp off the kernel)
    t = torch.div(t, torch.full_like(t, float(out_n)))
    s = (lo[:, None] + t) - 0.5
    f = torch.floor(s)
    frac = s - f
    i0 = torch.clamp(f, 0, in_n - 1).to(torch.long)
    i1 = torch.clamp(f + 1, 0, in_n - 1).to(torch.long)
    return i0, i1, frac


def plain_crop_resize(
    img: torch.Tensor,
    boxes: Optional[torch.Tensor],
    n: int,
    out_h: int,
    out_w: int,
    scale: Optional[float],
    offset: Optional[float],
    out_dtype: torch.dtype,
    per_image: int = 1,
) -> torch.Tensor:
    """The plain PyTorch version of the kernel, same arguments: ``img`` is
    [H, W, C] shared by all ``n`` boxes, or [n / per_image, H, W, C], box
    b sampling image b // per_image; ``boxes`` [n, 4] float32 pixel (x1,
    y1, x2, y2), None = full image."""
    shared = img.dim() == 3
    h, w, c = img.shape[-3:]
    dev = img.device
    if boxes is None:
        boxes = torch.tensor(
            [[0.0, 0.0, float(w), float(h)]], dtype=torch.float32, device=dev
        ).expand(n, 4)
    y0, y1, wy = _axis_taps(boxes[:, 1], boxes[:, 3], out_h, h)
    x0, x1, wx = _axis_taps(boxes[:, 0], boxes[:, 2], out_w, w)
    src = img[None] if shared else img
    bidx = (
        torch.zeros(n, dtype=torch.long, device=dev) if shared
        else torch.div(torch.arange(n, device=dev), per_image, rounding_mode="floor")
    )[:, None, None]

    def tap(yi, xi):
        return src[bidx, yi[:, :, None], xi[:, None, :]].to(torch.float32)

    wx4 = wx[:, None, :, None]
    wy4 = wy[:, :, None, None]
    top = tap(y0, x0) * (1 - wx4) + tap(y0, x1) * wx4
    bot = tap(y1, x0) * (1 - wx4) + tap(y1, x1) * wx4
    out = top * (1 - wy4) + bot * wy4
    if scale is not None:
        out = out * scale
    if offset is not None:
        out = out + offset
    return _round_clip_cast(out, out_dtype).reshape(n, out_h, out_w, c)


def _kernel_fn():
    """``nns_crop_resize`` from the built library, with its C signature."""
    from nnstreamer_tpu_torch.ops.kernels import _build

    fn = _build.load("image_kernels").nns_crop_resize
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
    ]
    return fn


def _cuda_crop_resize(img, boxes, n, out_h, out_w, scale, offset, out_dtype, per_image=1):
    fn = _kernel_fn()
    h, w, c = img.shape[-3:]
    out = torch.empty((n, out_h, out_w, c), dtype=out_dtype, device=img.device)
    batch_stride = 0 if img.dim() == 3 else h * w * c
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = fn(
            img.data_ptr(), _IN_DTYPES[img.dtype],
            None if boxes is None else boxes.data_ptr(),
            out.data_ptr(), _IN_DTYPES[out_dtype],
            n, h, w, c, out_h, out_w, batch_stride, per_image,
            int(scale is not None), float(scale or 0.0),
            int(offset is not None), float(offset or 0.0),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"nns_crop_resize launch failed: cudaError_t {err}")
    crop_resize_launches.add()
    (resize_entry_launches if boxes is None else crop_entry_launches).add()
    return out


@torch.library.custom_op("nns::crop_resize", mutates_args=())
def _crop_resize_op(
    img: torch.Tensor,
    boxes: Optional[torch.Tensor],
    out_h: int,
    out_w: int,
    scale: Optional[float],
    offset: Optional[float],
    out_dtype: torch.dtype,
    per_image: int,
) -> torch.Tensor:
    """K1 on checked operands: ``img`` [H, W, C] shared by every box or
    [I, H, W, C] with ``per_image`` boxes an image; ``boxes`` [n, 4] (n =
    I·per_image for a batch of images), or None for a full-image resize
    of each of the I images → [n, out_h, out_w, C]. The kernel on a CUDA
    image, the plain version on a CPU one."""
    n = img.shape[0] if boxes is None else boxes.shape[0]
    if img.is_cuda:
        img = img.contiguous()
        boxes = None if boxes is None else boxes.contiguous()
        return _cuda_crop_resize(img, boxes, n, out_h, out_w, scale, offset, out_dtype,
                                 per_image)
    if img.device.type == "cpu":
        return plain_crop_resize(img, boxes, n, out_h, out_w, scale, offset, out_dtype,
                                 per_image)
    raise RuntimeError(
        f"crop/resize kernel has no implementation on {img.device} "
        "(CUDA launches the kernel, CPU takes the plain version)"
    )


@_crop_resize_op.register_fake
def _(img, boxes, out_h, out_w, scale, offset, out_dtype, per_image):
    n = img.shape[0] if boxes is None else boxes.shape[0]
    return img.new_empty((n, out_h, out_w, img.shape[-1]), dtype=out_dtype)


@_crop_resize_op.register_vmap
def _(info, in_dims, img, boxes, out_h, out_w, scale, offset, out_dtype, per_image):
    """The vmapped axis (size B) folded into ONE launch: full-image resizes
    of B·I images; B·N boxes over one shared image (batch stride 0); or B
    images (of I each) with their boxes, box b sampling image b //
    per_image (N boxes an image where the unbatched image was shared)."""
    bsz = info.batch_size
    img_dim, boxes_dim = in_dims[0], in_dims[1]
    if img_dim is not None:
        img = img.movedim(img_dim, 0)
    if boxes is None:
        out = _crop_resize_op(img.reshape((-1,) + img.shape[-3:]), None, out_h, out_w,
                              scale, offset, out_dtype, 1)
        return out.reshape(img.shape[:-3] + out.shape[1:]), 0
    boxes = boxes.movedim(boxes_dim, 0) if boxes_dim is not None else boxes.expand(
        (bsz,) + boxes.shape)
    n = boxes.shape[1]
    flat = boxes.reshape(bsz * n, 4)
    if img_dim is None and img.dim() == 3:
        out = _crop_resize_op(img, flat, out_h, out_w, scale, offset, out_dtype, per_image)
    else:
        if img_dim is None:  # a batch of images each row shares: one copy a row
            img = img.expand((bsz,) + img.shape)
        per = n if img.dim() == 4 else per_image  # a row's one image, or its own batch
        out = _crop_resize_op(img.reshape((-1,) + img.shape[-3:]), flat, out_h, out_w,
                              scale, offset, out_dtype, per)
    return out.reshape((bsz, n) + out.shape[1:]), 0


def _launch_crop(img, boxes, n, out_h, out_w, scale, offset, out_dtype):
    """One home for both entry points: checks, then the op (the kernel on
    CUDA, the plain version on the CPU)."""
    if img.dtype not in _IN_DTYPES or out_dtype not in _IN_DTYPES:
        raise TypeError(
            f"crop/resize takes uint8/float32/bfloat16, got {img.dtype} → {out_dtype}"
        )
    if out_h <= 0 or out_w <= 0:
        raise ValueError(f"output size must be positive, got {out_h}x{out_w}")
    if boxes is not None:
        if boxes.dtype != torch.float32 or boxes.shape != (n, 4):
            raise ValueError(
                f"boxes must be float32 [{n}, 4], got {boxes.dtype} {tuple(boxes.shape)}"
            )
        if boxes.device != img.device:
            raise ValueError(f"boxes on {boxes.device}, image on {img.device}")
    if img.device.type not in ("cuda", "cpu"):
        raise RuntimeError(
            f"crop/resize kernel has no implementation on {img.device} "
            "(CUDA launches the kernel, CPU takes the plain version)"
        )
    return _crop_resize_op(img, boxes, out_h, out_w, scale, offset, out_dtype, 1)


def crop_and_resize(
    image: torch.Tensor,
    boxes: torch.Tensor,
    out_h: int,
    out_w: int,
    scale: Optional[float] = None,
    offset: Optional[float] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """image [H, W, C], boxes [N, 4] pixel (x1, y1, x2, y2) →
    [N, out_h, out_w, C]. ``out_dtype`` defaults to the image dtype, or
    float32 when a ``scale``/``offset`` epilogue is given."""
    if image.dim() != 3:
        raise ValueError(f"crop image must be [H, W, C], got {tuple(image.shape)}")
    if out_dtype is None:
        out_dtype = (
            torch.float32 if (scale is not None or offset is not None) else image.dtype
        )
    return _launch_crop(
        image, boxes.to(torch.float32), boxes.shape[0], out_h, out_w,
        scale, offset, out_dtype,
    )


def resize_bilinear(
    image: torch.Tensor,
    out_h: int,
    out_w: int,
    scale: Optional[float] = None,
    offset: Optional[float] = None,
) -> torch.Tensor:
    """Whole-image resize (+ optional normalize epilogue): [N, H, W, C] or
    [H, W, C] → same rank with H, W replaced. A resize is a crop of the
    full image, one per batch element."""
    squeeze = image.dim() == 3
    img = image[None] if squeeze else image
    if img.dim() != 4:
        raise ValueError(f"resize image must be [N, H, W, C], got {tuple(image.shape)}")
    out_dtype = (
        torch.float32 if (scale is not None or offset is not None) else img.dtype
    )
    out = _launch_crop(
        img, None, img.shape[0], out_h, out_w, scale, offset, out_dtype
    )
    return out[0] if squeeze else out
