"""Detection post-processing on device tensors.

The counterpart of ``nnstreamer_tpu/ops/detection.py`` (reference
tensordec-boundingbox.c): prior-box decode, score thresholding and NMS as
fixed-shape tensor ops, so a decoder fused behind a filter keeps the whole
decode on the card and only the detections tensor leaves it.

Detections are a fixed ``(max_out, 6)`` float32 tensor of
``[x1, y1, x2, y2, class, score]`` rows (normalized [0, 1] coordinates),
with ``score == 0`` marking empty slots.

Greedy NMS runs through the K2 kernel wrapper (ops/kernels/nms.py): the
CUDA kernel for tensors on the card, its plain PyTorch version for tensors
on the CPU. Ranking and packing are torch ops around it, with the JAX
package's tie rules: both argsorts are stable over the negated scores (as
the stable ``jnp.argsort``), and ``torch.argmax`` takes the first maximum
(as ``jnp.argmax``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from nnstreamer_tpu_torch.ops.kernels import nms as nms_kernels

# Reference defaults (tensordec-boundingbox.c:343-361, :125-127)
SSD_THRESHOLD = 0.5
SSD_Y_SCALE = 10.0
SSD_X_SCALE = 10.0
SSD_H_SCALE = 5.0
SSD_W_SCALE = 5.0
SSD_IOU_THRESHOLD = 0.5
YOLOV5_CONF_THRESHOLD = 0.3
YOLOV5_IOU_THRESHOLD = 0.6
OV_CONF_THRESHOLD = 0.8


def true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` as a true float32 division on every device: a Python
    scalar divisor may become a multiply by its reciprocal on CUDA, one
    ulp off. The divisor is filled on the device (no host copy, no sync)."""
    return torch.div(x, torch.full_like(x, float(d)))


def argsort_desc(x: torch.Tensor) -> torch.Tensor:
    """Indices of ``x`` in descending order, ties by index (the stable
    ``jnp.argsort(-x)``)."""
    return torch.argsort(-x, descending=False, stable=True)


def ssd_decode_boxes(
    locations: torch.Tensor,
    priors: torch.Tensor,
    y_scale: float = SSD_Y_SCALE,
    x_scale: float = SSD_X_SCALE,
    h_scale: float = SSD_H_SCALE,
    w_scale: float = SSD_W_SCALE,
) -> torch.Tensor:
    """SSD location offsets [N, 4] (ycenter, xcenter, h, w) against priors
    [4, N] rows (ycenter, xcenter, h, w) → boxes [N, 4] x1, y1, x2, y2."""
    loc = locations.to(torch.float32)
    pr = priors.to(torch.float32)
    ycenter = true_div(loc[:, 0], y_scale) * pr[2] + pr[0]
    xcenter = true_div(loc[:, 1], x_scale) * pr[3] + pr[1]
    h = torch.exp(true_div(loc[:, 2], h_scale)) * pr[2]
    w = torch.exp(true_div(loc[:, 3], w_scale)) * pr[3]
    x1 = xcenter - w / 2.0
    y1 = ycenter - h / 2.0
    return torch.stack([x1, y1, x1 + w, y1 + h], dim=-1)


def iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of [N, 4] x1, y1, x2, y2 boxes → [N, N]."""
    area = torch.clamp(boxes[:, 2] - boxes[:, 0], min=0.0) * torch.clamp(
        boxes[:, 3] - boxes[:, 1], min=0.0
    )
    lt = torch.maximum(boxes[:, None, :2], boxes[None, :, :2])
    rb = torch.minimum(boxes[:, None, 2:], boxes[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area[:, None] + area[None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    max_out: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy class-agnostic NMS with static shapes: boxes [N, 4]
    x1, y1, x2, y2 and scores [N] → (keep_idx [max_out] int32,
    keep_score [max_out] in the scores' dtype); empty slots have score 0
    and index -1."""
    order, sboxes, sscores = rank(boxes, scores)
    alive = nms_kernels.nms_mask(sboxes, sscores, iou_threshold)
    return pack_kept(order, sscores, alive, max_out, scores.dtype)


def rank(boxes: torch.Tensor, scores: torch.Tensor):
    """NMS ranking: (order [N], boxes [N, 4] and scores [N] float32 in
    descending score order, ties by index)."""
    order = argsort_desc(scores)
    return order, boxes.to(torch.float32)[order], scores.to(torch.float32)[order]


def pack_kept(
    order: torch.Tensor,
    sscores: torch.Tensor,
    alive: torch.Tensor,
    max_out: int,
    dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """NMS packing: the alive mask over the ranked candidates → the top
    ``max_out`` survivors as (keep_idx int32, keep_score ``dtype``),
    padded with index -1 and score 0."""
    k = min(max_out, order.shape[0])
    kept = torch.where(alive, sscores, torch.zeros_like(sscores))
    top = argsort_desc(kept)[:k]
    sel_scores = kept[top]
    sel_idx = torch.where(sel_scores > 0, order[top], torch.full_like(top, -1))
    if k < max_out:
        sel_idx = torch.nn.functional.pad(sel_idx, (0, max_out - k), value=-1)
        sel_scores = torch.nn.functional.pad(sel_scores, (0, max_out - k))
    return sel_idx.to(torch.int32), sel_scores.to(dtype)


def _pack_detections(
    boxes: torch.Tensor,
    classes: torch.Tensor,
    keep_idx: torch.Tensor,
    keep_scores: torch.Tensor,
) -> torch.Tensor:
    """Gather kept rows into the fixed [max_out, 6] detections tensor."""
    safe = torch.clamp(keep_idx, min=0).long()
    sel_boxes = boxes[safe]
    sel_cls = classes[safe].to(torch.float32)
    valid = (keep_idx >= 0)[:, None].to(torch.float32)
    rows = torch.cat(
        [sel_boxes, sel_cls[:, None], keep_scores[:, None].to(torch.float32)], dim=-1
    )
    return rows * valid


def ssd_candidates(
    locations: torch.Tensor,
    class_scores: torch.Tensor,
    priors: torch.Tensor,
    threshold: float = SSD_THRESHOLD,
    y_scale: float = SSD_Y_SCALE,
    x_scale: float = SSD_X_SCALE,
    h_scale: float = SSD_H_SCALE,
    w_scale: float = SSD_W_SCALE,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The NMS inputs of the SSD decode: (boxes [N, 4], best class [N],
    score [N], 0 below ``threshold``). Class 0 is background and never
    wins (the reference's label loop starts at 1)."""
    boxes = ssd_decode_boxes(locations, priors, y_scale, x_scale, h_scale, w_scale)
    probs = torch.sigmoid(class_scores.to(torch.float32))
    probs[:, 0] = 0.0  # background
    best = torch.argmax(probs, dim=-1)  # the first maximum, as jnp.argmax
    best_score = torch.amax(probs, dim=-1)
    score = torch.where(best_score >= threshold, best_score, torch.zeros_like(best_score))
    return boxes, best, score


def ssd_postprocess(
    locations: torch.Tensor,
    class_scores: torch.Tensor,
    priors: torch.Tensor,
    threshold: float = SSD_THRESHOLD,
    iou_threshold: float = SSD_IOU_THRESHOLD,
    max_out: int = 100,
    y_scale: float = SSD_Y_SCALE,
    x_scale: float = SSD_X_SCALE,
    h_scale: float = SSD_H_SCALE,
    w_scale: float = SSD_W_SCALE,
) -> torch.Tensor:
    """mobilenet-ssd mode: priors + raw logits [N, num_classes] →
    [max_out, 6] detections."""
    boxes, best, score = ssd_candidates(
        locations, class_scores, priors, threshold, y_scale, x_scale, h_scale, w_scale
    )
    keep_idx, keep_scores = nms(boxes, score, iou_threshold, max_out)
    return _pack_detections(boxes, best, keep_idx, keep_scores)


def ssd_pp_postprocess(
    locations: torch.Tensor,
    classes: torch.Tensor,
    scores: torch.Tensor,
    num: torch.Tensor,
    threshold: float = 0.5,
    max_out: int = 100,
) -> torch.Tensor:
    """mobilenet-ssd-postprocess mode: the model already ran NMS; just
    threshold and repack. locations [N, 4] = (ymin, xmin, ymax, xmax)
    normalized (TFLite detection-postprocess convention). Fewer than
    ``max_out`` rows are padded with empty ones, so the result always has
    the [max_out, 6] shape the decoder declares (the JAX package returns
    [min(N, max_out), 6] here)."""
    loc = locations.to(torch.float32)
    boxes = torch.stack([loc[:, 1], loc[:, 0], loc[:, 3], loc[:, 2]], dim=-1)
    n = loc.shape[0]
    k = min(max_out, n)
    valid = torch.arange(n, device=loc.device) < num.to(torch.int32).reshape(())
    s = scores.to(torch.float32)
    s = torch.where(valid & (s >= threshold), s, torch.zeros_like(s))
    top = argsort_desc(s)[:k]
    keep_idx = torch.where(s[top] > 0, top, torch.full_like(top, -1)).to(torch.int32)
    det = _pack_detections(boxes, classes.to(torch.float32), keep_idx, s[top])
    if k < max_out:
        det = torch.nn.functional.pad(det, (0, 0, 0, max_out - k))
    return det


def yolov5_postprocess(
    pred: torch.Tensor,
    conf_threshold: float = YOLOV5_CONF_THRESHOLD,
    iou_threshold: float = YOLOV5_IOU_THRESHOLD,
    max_out: int = 100,
    scaled: bool = True,
) -> torch.Tensor:
    """yolov5 mode: [N, 5+C] (cx, cy, w, h, objectness, C class scores) →
    [max_out, 6]. ``scaled=False`` applies the sigmoid (raw head outputs);
    coordinates are normalized to [0, 1]."""
    p = pred.to(torch.float32)
    if not scaled:
        p = torch.sigmoid(p)
    cx, cy, w, h = p[:, 0], p[:, 1], p[:, 2], p[:, 3]
    cls_scores = p[:, 5:] * p[:, 4:5]
    best = torch.argmax(cls_scores, dim=-1)
    best_score = torch.amax(cls_scores, dim=-1)
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)
    score = torch.where(
        best_score >= conf_threshold, best_score, torch.zeros_like(best_score)
    )
    keep_idx, keep_scores = nms(boxes, score, iou_threshold, max_out)
    return _pack_detections(boxes, best, keep_idx, keep_scores)


def ov_detection_postprocess(
    pred: torch.Tensor,
    conf_threshold: float = OV_CONF_THRESHOLD,
    max_out: int = 100,
) -> torch.Tensor:
    """ov-person/face-detection: [N, 7] rows (image_id, label, conf,
    x_min, y_min, x_max, y_max), already normalized — threshold and
    repack (reference tensordec-boundingbox.c:121-124)."""
    p = pred.to(torch.float32).reshape(-1, 7)
    boxes = p[:, 3:7]
    score = torch.where(p[:, 2] >= conf_threshold, p[:, 2], torch.zeros_like(p[:, 2]))
    n = p.shape[0]
    k = min(max_out, n)
    top = argsort_desc(score)[:k]
    keep_idx = torch.where(score[top] > 0, top, torch.full_like(top, -1)).to(torch.int32)
    det = _pack_detections(boxes, p[:, 1], keep_idx, score[top])
    if k < max_out:
        det = torch.nn.functional.pad(det, (0, 0, 0, max_out - k))
    return det


def generate_mp_palm_anchors(
    num_layers: int = 4,
    min_scale: float = 1.0,
    max_scale: float = 1.0,
    x_offset: float = 0.5,
    y_offset: float = 0.5,
    strides: Sequence[int] = (8, 16, 16, 16),
    input_size: int = 192,
) -> np.ndarray:
    """SSD-style anchors for mp-palm-detection (reference
    tensordec-boundingbox.c option3 scheme :68-80; mediapipe's
    SsdAnchorsCalculator). Returns [N, 4] (ycenter, xcenter, h, w) on the
    host, computed once at negotiation."""
    if len(strides) < num_layers:
        raise ValueError(
            f"mp-palm anchors: {num_layers} layers need {num_layers} strides, "
            f"got {len(strides)}"
        )
    anchors = []
    layer = 0
    while layer < num_layers:
        # merge consecutive layers with identical strides
        scales = []
        last = layer
        while last < num_layers and strides[last] == strides[layer]:
            if num_layers == 1:
                scale = (min_scale + max_scale) * 0.5
            else:
                scale = min_scale + (max_scale - min_scale) * last / (num_layers - 1.0)
            scales.extend([scale, scale])  # 2 anchors per cell
            last += 1
        fm = int(np.ceil(input_size / strides[layer]))
        for y in range(fm):
            for x in range(fm):
                for _ in scales:
                    anchors.append(((y + y_offset) / fm, (x + x_offset) / fm, 1.0, 1.0))
        layer = last
    return np.asarray(anchors, np.float32)


def mp_palm_postprocess(
    raw_boxes: torch.Tensor,
    raw_scores: torch.Tensor,
    anchors: torch.Tensor,
    score_threshold: float = 0.5,
    iou_threshold: float = 0.3,
    max_out: int = 20,
    input_size: int = 192,
) -> torch.Tensor:
    """mp-palm-detection: raw_boxes [N, 18] (dx, dy, w, h + 7 keypoint
    pairs, pixel units), raw_scores [N] logits, anchors [N, 4] →
    [max_out, 6]."""
    b = raw_boxes.to(torch.float32)
    a = anchors.to(torch.float32)
    cx = true_div(b[:, 0], input_size) + a[:, 1]
    cy = true_div(b[:, 1], input_size) + a[:, 0]
    w = true_div(b[:, 2], input_size)
    h = true_div(b[:, 3], input_size)
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)
    probs = torch.sigmoid(raw_scores.to(torch.float32).reshape(-1))
    score = torch.where(probs >= score_threshold, probs, torch.zeros_like(probs))
    keep_idx, keep_scores = nms(boxes, score, iou_threshold, max_out)
    return _pack_detections(boxes, torch.zeros_like(score), keep_idx, keep_scores)
