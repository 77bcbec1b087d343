"""DeepLab-v3 (MobileNet-v2 backbone): the segmentation model.

The counterpart of ``nnstreamer_tpu/models/deeplab_v3.py`` (the topology
of the reference's deeplabv3_257_mv_gpu.tflite fixture): MobileNet-v2 at
output stride 16 (block 13's stride 2 dropped, the depthwise convs from
there on dilated by 2), a reduced mobile ASPP (a 1×1 branch and an
image-level pooling branch, concatenated and projected), a biased 1×1
classifier, and a bilinear upsample back to the input size:

    uint8 NHWC [N, 257, 257, 3] → class scores [N, 257, 257, 21] float32.

The upsample samples at half-pixel centres with edge clamping, which for
an upsample is ``jax.image.resize(..., "bilinear")``'s grid; it is
``torch.nn.functional.interpolate`` (the reference's resize is XLA's, not
a Pallas kernel).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from nnstreamer_tpu_torch.models import mobilenet_v2
from nnstreamer_tpu_torch.models.jax_weights import BIASED, CONV_BN, tree_paths
from nnstreamer_tpu_torch.models.nn import BiasConv, ConvBN, nhwc

NUM_CLASSES = 21
INPUT_SIZE = 257
_ASPP_CH = 256
_ATROUS_FROM = 13  # the stride-2 160-channel group and beyond run atrous


class DeepLabV3(nn.Module):
    """Class scores of one image batch at its own size, NHWC float32."""

    def __init__(self, num_classes: int = NUM_CLASSES,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        # the reference builds the backbone with MobileNet-v2's classifier
        # (1001 classes), which DeepLab never runs; it is kept so the
        # carried-over leaves line up one to one
        self.backbone = mobilenet_v2.MobileNetV2(num_classes=1001, generator=generator)
        for blk in self.backbone.blocks[_ATROUS_FROM:]:
            blk.dw.stride, blk.dw.dilation = 1, 2
        c = self.backbone.blocks[-1].project.weight.shape[0]  # 320
        self.aspp_conv = ConvBN(c, _ASPP_CH, 1, generator=generator)
        self.aspp_pool = ConvBN(c, _ASPP_CH, 1, generator=generator)
        self.project = ConvBN(2 * _ASPP_CH, _ASPP_CH, 1, generator=generator)
        self.classifier = BiasConv(_ASPP_CH, num_classes, 1, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        size = x.shape[1]
        feat = self.backbone.trunk(x)  # [N, 320, s/16, s/16]
        a = self.aspp_conv(feat)
        pooled = self.aspp_pool(feat.mean(dim=(2, 3), keepdim=True))
        y = self.project(torch.cat([a, pooled.expand_as(a)], dim=1))
        logits = self.classifier(y).to(torch.float32)
        logits = F.interpolate(logits, size=(size, size), mode="bilinear",
                               align_corners=False, antialias=False)
        return nhwc(logits).contiguous()


def jax_leaf_paths() -> List[Tuple]:
    """Leaf paths of the reference's ``deeplab_v3.init_params`` tree in
    flatten order."""
    return tree_paths({
        "backbone": mobilenet_v2.jax_tree(), "aspp_conv": CONV_BN, "aspp_pool": CONV_BN,
        "project": CONV_BN, "classifier": BIASED,
    })
