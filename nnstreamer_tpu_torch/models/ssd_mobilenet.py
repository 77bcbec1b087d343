"""SSD-MobileNet-v2 detector (300x300, 1917 prior boxes, 91 classes).

The counterpart of ``nnstreamer_tpu/models/ssd_mobilenet.py``, the
topology of the reference's ssd_mobilenet_v2_coco.tflite fixture (Liu et
al. 2016, with the MobileNet-v2 backbone of Sandler et al. 2018): the
backbone taps block 12 (19x19x96) and its head (10x10x1280), four extra
1x1 → 3x3/s2 layers add the 5/3/2/1 maps, and a biased 3x3 box head and
class head on each of the six maps give the two tensors the reference's
``mobilenet-ssd`` decoder mode consumes:

    locations [N, 1917, 4]    (ycenter, xcenter, h, w offsets)
    scores    [N, 1917, C]    raw class logits, class 0 = background

:class:`SSDMobileNetV2PP` adds the decode and NMS inside the model (the
``mobilenet-ssd-postprocess`` layout of TFLite's detection postprocess),
so a ``_pp`` filter reaches the K2 NMS kernel through the model itself.

Weights: random from a ``torch.Generator`` seed, or carried over from the
reference's param tree (:func:`ssd_mobilenet_from_jax`,
:func:`load_jax_npz`).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from nnstreamer_tpu_torch.models import mobilenet_v2
from nnstreamer_tpu_torch.models.jax_weights import (
    conv_bn_paths,
    load_npz,
    state_dict_from_tree,
)
from nnstreamer_tpu_torch.models.nn import ConvBN, conv2d_same
from nnstreamer_tpu_torch.ops import detection as det

# TF object-detection ssd_mobilenet anchor config: 6 layers, scales
# interpolated in [0.2, 0.95], aspect ratios {1, 2, 1/2, 3, 1/3}, the lowest
# layer reduced to 3 boxes, ratio-1 anchors get an extra interpolated scale.
NUM_LAYERS = 6
MIN_SCALE = 0.2
MAX_SCALE = 0.95
FEATURE_MAPS = (19, 10, 5, 3, 2, 1)
ANCHORS_PER_CELL = (3, 6, 6, 6, 6, 6)
NUM_ANCHORS = sum(a * f * f for a, f in zip(ANCHORS_PER_CELL, FEATURE_MAPS))  # 1917
NUM_CLASSES = 91  # COCO + background
INPUT_SIZE = 300

# extra feature layers after the backbone: (mid 1x1 channels, out 3x3/s2 channels)
_EXTRAS: Tuple[Tuple[int, int], ...] = ((256, 512), (128, 256), (128, 256), (64, 128))
_TAP_CHANNELS = (96, 1280)


def generate_anchors() -> np.ndarray:
    """Prior boxes as a [4, NUM_ANCHORS] array of rows (ycenter, xcenter,
    h, w) — the layout of the reference's box-priors.txt."""
    scales = [
        MIN_SCALE + (MAX_SCALE - MIN_SCALE) * i / (NUM_LAYERS - 1)
        for i in range(NUM_LAYERS)
    ] + [1.0]
    boxes: List[Tuple[float, float, float, float]] = []
    for layer, fm in enumerate(FEATURE_MAPS):
        if layer == 0:
            # reduce_boxes_in_lowest_layer: fixed (scale, ratio) triple
            layer_boxes = [(0.1, 1.0), (scales[0], 2.0), (scales[0], 0.5)]
        else:
            layer_boxes = [
                (scales[layer], 1.0),
                (scales[layer], 2.0),
                (scales[layer], 0.5),
                (scales[layer], 3.0),
                (scales[layer], 1.0 / 3.0),
                # interpolated scale anchor at ratio 1
                (math.sqrt(scales[layer] * scales[layer + 1]), 1.0),
            ]
        for y in range(fm):
            for x in range(fm):
                yc = (y + 0.5) / fm
                xc = (x + 0.5) / fm
                for scale, ratio in layer_boxes:
                    r = math.sqrt(ratio)
                    boxes.append((yc, xc, scale / r, scale * r))
    arr = np.asarray(boxes, np.float32).T  # [4, N]
    if arr.shape != (4, NUM_ANCHORS):
        raise AssertionError(f"anchor table has shape {arr.shape}")
    return arr


def write_box_priors(path: str) -> None:
    """Write the anchors in the reference box-priors.txt format: 4 lines
    (ycenter / xcenter / h / w), NUM_ANCHORS space-separated values each."""
    with open(path, "w") as f:
        for row in generate_anchors():
            f.write(" ".join(f"{v:.8f}" for v in row) + "\n")


class HeadConv(nn.Module):
    """A biased 3x3 SAME conv: one SSD box or class head."""

    def __init__(self, cin: int, cout: int, generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        std = math.sqrt(2.0 / (cin * 9))
        w = torch.randn((cout, cin, 3, 3), generator=generator) * std
        self.weight = nn.Parameter(w, requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(cout), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d_same(x, self.weight) + self.bias[:, None, None]


class ExtraLayer(nn.Module):
    """1x1 squeeze → 3x3 stride-2 expand, batch norm and ReLU6 after each.
    The stride-2 convs pad TF ``SAME``: asymmetric (0, 1) on 10 → 5 and
    2 → 1, symmetric on 5 → 3 and 3 → 2."""

    def __init__(self, cin: int, mid: int, cout: int, generator=None) -> None:
        super().__init__()
        self.squeeze = ConvBN(cin, mid, 1, generator=generator)
        self.expand = ConvBN(mid, cout, 3, stride=2, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.expand(self.squeeze(x))


class SSDMobileNetV2(nn.Module):
    """uint8/float NHWC [N, 300, 300, 3] → (locations [N, 1917, 4],
    scores [N, 1917, num_classes]), float32."""

    def __init__(
        self, num_classes: int = NUM_CLASSES, generator: Optional[torch.Generator] = None
    ) -> None:
        super().__init__()
        self.num_classes = num_classes
        # the reference builds its backbone with MobileNet-v2's 1001-class
        # classifier, which SSD never runs; it is kept so the carried-over
        # leaves line up one to one
        self.backbone = mobilenet_v2.MobileNetV2(num_classes=1001, generator=generator)
        extras, cin = [], _TAP_CHANNELS[-1]
        for mid, cout in _EXTRAS:
            extras.append(ExtraLayer(cin, mid, cout, generator))
            cin = cout
        self.extras = nn.ModuleList(extras)
        head_channels = _TAP_CHANNELS + tuple(c for _, c in _EXTRAS)
        self.loc_heads = nn.ModuleList(
            HeadConv(c, a * 4, generator) for c, a in zip(head_channels, ANCHORS_PER_CELL)
        )
        self.cls_heads = nn.ModuleList(
            HeadConv(c, a * num_classes, generator)
            for c, a in zip(head_channels, ANCHORS_PER_CELL)
        )

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        maps = list(self.backbone.features(x))
        y = maps[-1]
        for extra in self.extras:
            y = extra(y)
            maps.append(y)
        n = x.shape[0]
        locs, scores = [], []
        for fmap, lh, ch in zip(maps, self.loc_heads, self.cls_heads):
            # NCHW (channels-last memory) → NHWC rows (y, x, anchor)
            locs.append(lh(fmap).permute(0, 2, 3, 1).reshape(n, -1, 4))
            scores.append(ch(fmap).permute(0, 2, 3, 1).reshape(n, -1, self.num_classes))
        return torch.cat(locs, dim=1), torch.cat(scores, dim=1)


class SSDMobileNetV2PP(nn.Module):
    """Detector + decode + NMS on the device → the 4-tensor TFLite
    detection-postprocess layout that the ``mobilenet-ssd-postprocess``
    decoder mode expects: boxes [max_out, 4] (ymin, xmin, ymax, xmax),
    classes [max_out], scores [max_out], num [1]. Batch 1."""

    def __init__(
        self,
        ssd: SSDMobileNetV2,
        max_out: int = 10,
        threshold: float = 0.001,
        iou_threshold: float = det.SSD_IOU_THRESHOLD,
    ) -> None:
        super().__init__()
        self.ssd = ssd
        self.max_out, self.threshold, self.iou_threshold = max_out, threshold, iou_threshold
        self.register_buffer("priors", torch.from_numpy(generate_anchors()))

    def forward(self, x: torch.Tensor):
        loc, cls = self.ssd(x)
        boxes, best, score = det.ssd_candidates(
            loc[0], cls[0], self.priors, threshold=self.threshold
        )
        keep_idx, keep_scores = det.nms(boxes, score, self.iou_threshold, self.max_out)
        safe = torch.clamp(keep_idx, min=0).long()
        kept = boxes[safe]  # x1, y1, x2, y2
        valid = (keep_idx >= 0) & (keep_scores > 0)
        out_boxes = torch.where(
            valid[:, None],
            torch.stack([kept[:, 1], kept[:, 0], kept[:, 3], kept[:, 2]], dim=-1),
            torch.zeros_like(kept),
        )
        out_classes = torch.where(valid, best[safe], torch.zeros_like(best[safe]))
        out_scores = torch.where(valid, keep_scores, torch.zeros_like(keep_scores))
        num = valid.to(torch.float32).sum().reshape(1)
        return out_boxes, out_classes.to(torch.float32), out_scores, num


# -- weights carried over from the JAX package --------------------------------


def jax_leaf_paths() -> List[Tuple]:
    """Paths of the reference SSD tree's leaves in ``jax.tree_util``
    flatten order: ``backbone`` (MobileNet-v2 with its unused classifier),
    ``cls_heads`` (``b``, ``w``), ``extras`` (``expand`` then ``squeeze``),
    ``loc_heads`` — the ``p{i}`` order of a ``params:<npz>`` file."""
    paths = [("backbone", *p) for p in mobilenet_v2.jax_leaf_paths()]
    paths += [("cls_heads", i, leaf) for i in range(NUM_LAYERS) for leaf in ("b", "w")]
    for i in range(len(_EXTRAS)):
        paths += conv_bn_paths(("extras", i, "expand"))
        paths += conv_bn_paths(("extras", i, "squeeze"))
    paths += [("loc_heads", i, leaf) for i in range(NUM_LAYERS) for leaf in ("b", "w")]
    return paths


def ssd_mobilenet_from_jax(params) -> Dict[str, torch.Tensor]:
    """The reference's SSD param tree (``nnstreamer_tpu.models.
    ssd_mobilenet.init_params``, converted to numpy) → a state dict for
    :class:`SSDMobileNetV2`."""
    if len(params.get("extras", ())) != len(_EXTRAS):
        raise ValueError("not an ssd_mobilenet_v2 tree")
    return state_dict_from_tree(params, jax_leaf_paths())


def load_jax_npz(model: SSDMobileNetV2, path: str) -> None:
    """Overlay leaves ``p{i}`` of an npz (reference tree-flatten order)
    onto ``model``; leaves the file lacks keep their current values."""
    load_npz(model, path, jax_leaf_paths())
