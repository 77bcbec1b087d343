"""Heatmap post-processing on device tensors: pose keypoints and the
segmentation argmax.

The counterpart of ``nnstreamer_tpu/ops/heatmap.py`` (reference
tensordec-pose.c heatmap-only / heatmap-offset, tensordec-imagesegment.c
tflite-deeplab and snpe-depth): each is a few tensor ops that run where
the tensors are, so a decoder fused behind its model keeps them on the
card. ``torch.argmax`` takes the first maximum, as ``jnp.argmax``.
"""

from __future__ import annotations

import torch


def pose_keypoints_from_heatmap(heatmap: torch.Tensor) -> torch.Tensor:
    """heatmap-only: [H, W, K] score maps → [K, 3] (x, y, score) in grid
    units; the score is the sigmoid of the cell's logit."""
    h, w, k = heatmap.shape
    hm = heatmap.to(torch.float32).reshape(h * w, k)
    idx = torch.argmax(hm, dim=0)
    score = torch.sigmoid(torch.amax(hm, dim=0))
    y = torch.div(idx, w, rounding_mode="floor").to(torch.float32)
    x = (idx % w).to(torch.float32)
    return torch.stack([x, y, score], dim=-1)


def pose_keypoints_with_offsets(heatmap: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """heatmap-offset: the grid argmax and the offsets [H, W, 2K] (first K
    channels y, last K x, the posenet convention) at it → [K, 5] rows
    (grid_x, grid_y, score, off_x, off_y)."""
    k = heatmap.shape[-1]
    base = pose_keypoints_from_heatmap(heatmap)
    ys = base[:, 1].to(torch.long)
    xs = base[:, 0].to(torch.long)
    koff = torch.arange(k, device=heatmap.device)
    off = offsets.to(torch.float32)
    return torch.stack(
        [base[:, 0], base[:, 1], base[:, 2], off[ys, xs, koff + k], off[ys, xs, koff]], dim=-1
    )


def segment_argmax(seg: torch.Tensor) -> torch.Tensor:
    """tflite-deeplab: [H, W, C] class scores → [H, W] uint8 labels; an
    [H, W] map (already argmaxed: snpe-deeplab) passes through as uint8."""
    if seg.dim() == 3 and seg.shape[-1] > 1:
        return torch.argmax(seg.to(torch.float32), dim=-1).to(torch.uint8)
    return seg.reshape(seg.shape[0], seg.shape[1]).to(torch.uint8)


def depth_normalize(depth: torch.Tensor) -> torch.Tensor:
    """snpe-depth: [H, W] float depth → uint8 grey by min-max scaling."""
    d = depth.to(torch.float32).reshape(depth.shape[0], depth.shape[1])
    lo, hi = torch.amin(d), torch.amax(d)
    return ((d - lo) / torch.clamp(hi - lo, min=1e-9) * 255.0).to(torch.uint8)
