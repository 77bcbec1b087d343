"""YOLOv5-style single-stage detector: the ``yolov5`` decoder mode's model.

The counterpart of ``nnstreamer_tpu/models/yolo.py``: a strided conv stem
to stride 4, then three stages of a stride-2 conv and a residual
bottleneck at strides 8, 16 and 32, and a biased 1×1 detection head a
level with A = 3 anchors a cell (the v5 P3/P4/P5 priors). The decode runs
in the model (YOLOv5 v4+):

    xy = (2σ(t_xy) − 0.5 + grid) · stride / size     (normalized [0, 1])
    wh = (2σ(t_wh))² · anchor / size
    obj, cls = σ(t)

and the levels concatenate to one [B, Σ HᵢWᵢA, 5 + C] float32 tensor
(6300 rows at size 320), which ``tensor_decoder mode=bounding_boxes
option1=yolov5`` thresholds and hands to K2. The grid and anchor
constants are made once a device with numpy's float32 arithmetic.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from nnstreamer_tpu_torch.device import is_fake
from nnstreamer_tpu_torch.models.jax_weights import BIASED, CONV_BN, tree_paths
from nnstreamer_tpu_torch.models.nn import BiasConv, ConvBN, image_input, nhwc

STRIDES = (8, 16, 32)
# anchor (w, h) pixel pairs per level — the familiar v5 P3/P4/P5 priors
ANCHORS = (
    ((10, 13), (16, 30), (33, 23)),
    ((30, 61), (62, 45), (59, 119)),
    ((116, 90), (156, 198), (373, 326)),
)
A = 3  # anchors per cell


def n_rows(size: int) -> int:
    """Total prediction rows for a square ``size`` input."""
    return sum((size // s) ** 2 * A for s in STRIDES)


class Bottleneck(nn.Module):
    """x + conv3x3(conv1x1(x)), batch norm and ReLU6 after each conv."""

    def __init__(self, c: int, generator=None) -> None:
        super().__init__()
        self.c1 = ConvBN(c, c // 2, 1, generator=generator)
        self.c2 = ConvBN(c // 2, c, 3, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.c2(self.c1(x))


class YOLOv5(nn.Module):
    """uint8/float NHWC [B, S, S, 3] (S a multiple of 32) → decoded
    predictions [B, n_rows(S), 5 + num_classes] float32. ``width`` is the
    channel count at stride 4, doubling a stage."""

    def __init__(self, num_classes: int = 80, width: int = 32,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.num_classes = num_classes
        c1, c2, c3, c4 = width, width * 2, width * 4, width * 8
        out_ch = A * (5 + num_classes)
        self.stem = ConvBN(3, c1, 3, stride=2, generator=generator)
        self.stem2 = ConvBN(c1, c1, 3, stride=2, generator=generator)
        self.s8 = ConvBN(c1, c2, 3, stride=2, generator=generator)
        self.b8 = Bottleneck(c2, generator)
        self.s16 = ConvBN(c2, c3, 3, stride=2, generator=generator)
        self.b16 = Bottleneck(c3, generator)
        self.s32 = ConvBN(c3, c4, 3, stride=2, generator=generator)
        self.b32 = Bottleneck(c4, generator)
        self.head8 = BiasConv(c2, out_ch, 1, generator)
        self.head16 = BiasConv(c3, out_ch, 1, generator)
        self.head32 = BiasConv(c4, out_ch, 1, generator)
        self._consts: Dict[Tuple[torch.device, int], List[Tuple[torch.Tensor, ...]]] = {}

    def _decode_consts(self, device: torch.device, size: int):
        """Per level: the cell grid [gh, gw, 1, 2] (x, y), anchor / size
        [A, 2] and stride / size, float32 on ``device`` (made once)."""
        key = (device, size)
        if key not in self._consts:
            levels = []
            for stride, anchors in zip(STRIDES, ANCHORS):
                g = size // stride
                gy, gx = np.meshgrid(np.arange(g, dtype=np.float32),
                                     np.arange(g, dtype=np.float32), indexing="ij")
                grid = np.stack([gx, gy], -1)[:, :, None, :]
                anc = np.asarray(anchors, np.float32) / np.float32(size)
                levels.append((torch.from_numpy(grid).to(device),
                               torch.from_numpy(anc).to(device), stride / size))
            if is_fake(levels[0][0]):
                return levels  # an analyzer's trace keeps nothing
            self._consts[key] = levels
        return self._consts[key]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        size = x.shape[1]
        y = self.stem2(self.stem(image_input(x, self.stem.weight.dtype)))  # stride 4
        feats = []
        for conv, block in ((self.s8, self.b8), (self.s16, self.b16), (self.s32, self.b32)):
            y = block(conv(y))
            feats.append(y)
        rows = []
        heads = (self.head8, self.head16, self.head32)
        for feat, head, (grid, anc, scale) in zip(
                feats, heads, self._decode_consts(x.device, size)):
            t = nhwc(head(feat))
            b, gh, gw, _ = t.shape
            s = torch.sigmoid(t.reshape(b, gh, gw, A, -1).to(torch.float32))
            xy = (2.0 * s[..., 0:2] - 0.5 + grid) * scale
            wh = torch.square(2.0 * s[..., 2:4]) * anc
            rows.append(torch.cat([xy, wh, s[..., 4:]], dim=-1).reshape(b, gh * gw * A, -1))
        return torch.cat(rows, dim=1)


def jax_leaf_paths() -> List[Tuple]:
    """Leaf paths of the reference's ``yolo.init_params`` tree in flatten
    order (the ``p{i}`` order of a ``params:<npz>`` file)."""
    bottleneck = {"c1": CONV_BN, "c2": CONV_BN}
    return tree_paths({
        "stem": CONV_BN, "stem2": CONV_BN,
        "s8": CONV_BN, "b8": bottleneck, "s16": CONV_BN, "b16": bottleneck,
        "s32": CONV_BN, "b32": bottleneck,
        "head8": BIASED, "head16": BIASED, "head32": BIASED,
    })
