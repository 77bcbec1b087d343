"""PoseNet (MobileNet-v1 backbone): the multi-output pose model.

The counterpart of ``nnstreamer_tpu/models/posenet.py`` (the topology of
the reference's posenet_mobilenet_v1_100_257x257 fixture): a stride-2 stem,
13 depthwise-separable blocks to stride 32 (a 9×9 grid at 257), and four
1×1 heads, in the order the pose decoder maps them:

    uint8 NHWC [N, 257, 257, 3] → (heatmap [N, 9, 9, 17],
    offsets [N, 9, 9, 34], displacement_fwd [N, 9, 9, 32],
    displacement_bwd [N, 9, 9, 32]), float32 NHWC.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from nnstreamer_tpu_torch.models.jax_weights import BIASED, CONV_BN, SEP_CONV, tree_paths
from nnstreamer_tpu_torch.models.nn import ConvBN, SepConv, image_input, init_dense, nhwc

NUM_KEYPOINTS = 17
INPUT_SIZE = 257
OUTPUT_GRID = 9

# MobileNet-v1 plan: (out_channels, stride) per depthwise-separable block
_V1_BLOCKS: Tuple[Tuple[int, int], ...] = (
    (64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2), (512, 1),
    (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2), (1024, 1),
)
HEADS = ("heatmap", "offsets", "disp_fwd", "disp_bwd")


class PoseNet(nn.Module):
    """The four maps of one image batch; the heads are dense layers
    applied at every cell (the reference's ``einsum("nhwc,cd")``)."""

    def __init__(self, num_keypoints: int = NUM_KEYPOINTS,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.stem = ConvBN(3, 32, 3, stride=2, generator=generator)
        cin, blocks = 32, []
        for cout, stride in _V1_BLOCKS:
            blocks.append(SepConv(cin, cout, stride, generator=generator))
            cin = cout
        self.blocks = nn.ModuleList(blocks)
        widths = (num_keypoints, 2 * num_keypoints,
                  2 * (num_keypoints - 1), 2 * (num_keypoints - 1))
        for name, c in zip(HEADS, widths):
            setattr(self, name, init_dense(cin, c, generator))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        y = self.stem(image_input(x, self.stem.weight.dtype))
        for blk in self.blocks:
            y = blk(y)
        y = nhwc(y)
        return tuple(getattr(self, name)(y).to(torch.float32) for name in HEADS)


def jax_leaf_paths() -> List[Tuple]:
    """Leaf paths of the reference's ``posenet.init_params`` tree in
    flatten order."""
    tree = {"stem": CONV_BN, "blocks": [SEP_CONV] * len(_V1_BLOCKS)}
    tree.update(dict.fromkeys(HEADS, BIASED))
    return tree_paths(tree)
