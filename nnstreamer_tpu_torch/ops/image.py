"""Image ops: bilinear resize and crop+resize on device tensors.

The counterpart of ``nnstreamer_tpu/ops/image.py``. Every op here goes
through the K1 kernel wrapper (ops/kernels/image_kernels.py): the CUDA
kernel for tensors on the card, its plain PyTorch version for tensors on
the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch

from nnstreamer_tpu_torch.ops.kernels import image_kernels
from nnstreamer_tpu_torch.ops.kernels.image_kernels import _round_clip_cast


def crop_and_resize(image: torch.Tensor, boxes: torch.Tensor, out_h: int, out_w: int):
    """Bilinear crop+resize (TF crop_and_resize semantics, pixel boxes).

    image: [H, W, C]; boxes: [N, 4] (x1, y1, x2, y2) in pixel coordinates
    (degenerate boxes clamp to edge pixels) → [N, out_h, out_w, C], image
    dtype (integers rounded half to even and clipped)."""
    return image_kernels.crop_and_resize(image, boxes, out_h, out_w)


def crop_regions(
    image: torch.Tensor,
    xyxy: torch.Tensor,
    out_h: int,
    out_w: int,
    valid: Optional[torch.Tensor] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Crop+resize with the tensor_crop output conventions: compute in
    float32, zero the rows where ``valid`` is False, then round+clip
    integer outputs. image [H, W, C]; xyxy [N, 4] pixel corners;
    out_dtype defaults to the image dtype."""
    crops = image_kernels.crop_and_resize(
        image, xyxy, out_h, out_w, out_dtype=torch.float32
    )
    if valid is not None:
        crops = torch.where(valid[:, None, None, None], crops, 0.0)
    return _round_clip_cast(crops, image.dtype if out_dtype is None else out_dtype)


def resize_bilinear(image: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Whole-image bilinear resize: [N, H, W, C] or [H, W, C] → same rank
    with the spatial dims replaced, dtype preserved. Same sampling grid as
    crop_and_resize over the full-image box."""
    return image_kernels.resize_bilinear(image, out_h, out_w)
