"""MobileNet-v2 (1001-class, 224x224) — the flagship model of the main path.

The counterpart of ``nnstreamer_tpu/models/mobilenet_v2.py``: stem conv +
17 inverted-residual bottlenecks (expansion / depthwise / projection) +
1x1 conv to 1280 + global average pool + classifier; ReLU6 activations.
The input is a uint8 (or float) NHWC batch, normalized inside the model
as ``(x − 127.5)/127.5`` (or on the ``input_quant`` grid of imported tflite
weights), and the output is float32 logits [N, num_classes].

Weights: random from a ``torch.Generator`` seed (not the JAX package's
weights — the two generators differ), or carried over from the reference's
param tree with :func:`mobilenet_v2_from_jax` / :func:`load_jax_npz`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from nnstreamer_tpu_torch.models.jax_weights import (
    conv_bn_paths,
    load_npz,
    state_dict_from_tree,
)
from nnstreamer_tpu_torch.models.nn import ConvBN, init_dense

# (expansion t, out channels c, repeats n, first stride s) — table 2 of the
# paper (Sandler et al. 2018, arXiv:1801.04381)
_INVERTED_RESIDUAL_CFG: Tuple[Tuple[int, int, int, int], ...] = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


def _make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class InvertedResidual(nn.Module):
    def __init__(self, cin: int, cout: int, t: int, stride: int, generator) -> None:
        super().__init__()
        hidden = cin * t
        self.expand = (
            ConvBN(cin, hidden, 1, generator=generator) if t != 1 else None
        )
        self.dw = ConvBN(hidden, hidden, 3, stride=stride, groups=hidden, generator=generator)
        self.project = ConvBN(hidden, cout, 1, act=False, generator=generator)
        self.residual = stride == 1 and cin == cout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.expand(x) if self.expand is not None else x
        y = self.project(self.dw(y))
        return y + x if self.residual else y


class MobileNetV2(nn.Module):
    """NHWC uint8/float image batch → float32 logits [N, num_classes]."""

    def __init__(
        self, num_classes: int = 1001, width: float = 1.0,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        c_stem = _make_divisible(32 * width)
        self.stem = ConvBN(3, c_stem, 3, stride=2, generator=generator)
        cin = c_stem
        blocks: List[nn.Module] = []
        for t, c, n, s in _INVERTED_RESIDUAL_CFG:
            cout = _make_divisible(c * width)
            for i in range(n):
                blocks.append(
                    InvertedResidual(cin, cout, t, s if i == 0 else 1, generator)
                )
                cin = cout
        self.blocks = nn.ModuleList(blocks)
        c_head = _make_divisible(1280 * width) if width > 1.0 else 1280
        self.head = ConvBN(cin, c_head, 1, generator=generator)
        self.classifier = init_dense(c_head, num_classes, generator)
        # imported tflite weights normalize on the graph's own input grid
        # ((q - zp)·scale); None = the generic (x - 127.5)/127.5
        self.input_quant: Optional[Tuple[float, float]] = None

    def _input(self, x: torch.Tensor) -> torch.Tensor:
        """uint8/float NHWC batch → normalized float32 NCHW view whose
        memory stays channels-last."""
        if x.dtype == torch.uint8:
            x = x.to(torch.float32)
            if self.input_quant is not None:
                scale, zp = self.input_quant
                x = (x - zp) * scale
            else:
                x = (x - 127.5) / 127.5
        else:
            x = x.to(torch.float32)
        return x.permute(0, 3, 1, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.stem(self._input(x))
        for blk in self.blocks:
            y = blk(y)
        y = self.head(y)
        y = y.mean(dim=(2, 3))  # global average pool
        return self.classifier(y)

    def features(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The two maps an SSD head taps (``nnstreamer_tpu/models/
        ssd_mobilenet.py _feature_maps``): the output of block 12 (the
        last stride-16 map, 96 channels; 19x19 at 300x300) and the head's
        output (1280 channels; 10x10 at 300x300), both NCHW."""
        y = self.stem(self._input(x))
        tap = None
        for i, blk in enumerate(self.blocks):
            y = blk(y)
            if i == 12:
                tap = y
        return tap, self.head(y)


# -- weights carried over from the JAX package --------------------------------


def jax_leaf_paths() -> List[Tuple]:
    """Paths of the reference param tree's leaves in ``jax.tree_util``
    flatten order (dict keys sorted, lists in order) — the ``p{i}`` order
    of a ``params:<npz>`` file."""
    blocks = []
    for t, _, n, _ in _INVERTED_RESIDUAL_CFG:
        blocks.extend([t] * n)
    paths: List[Tuple] = []
    for i, t in enumerate(blocks):
        names = ("dw", "expand", "project") if t != 1 else ("dw", "project")
        for name in names:
            paths.extend(conv_bn_paths(("blocks", i, name)))
    paths += [("classifier", "b"), ("classifier", "w")]
    paths += conv_bn_paths(("head",))
    paths += conv_bn_paths(("stem",))
    return paths


def mobilenet_v2_from_jax(params) -> Dict[str, torch.Tensor]:
    """The reference's param tree (nested dicts/lists of arrays, as
    ``nnstreamer_tpu.models.mobilenet_v2.init_params`` returns, converted
    to numpy) → a state dict for :class:`MobileNetV2`."""
    n_blocks = len(params["blocks"])
    if n_blocks != sum(n for _, _, n, _ in _INVERTED_RESIDUAL_CFG):
        raise ValueError(f"not a mobilenet_v2 tree: {n_blocks} blocks")
    return state_dict_from_tree(params, jax_leaf_paths())


def load_jax_npz(model: MobileNetV2, path: str) -> None:
    """Overlay leaves ``p{i}`` of an npz (reference tree-flatten order,
    ``nnstreamer_tpu/models/zoo.py`` ``_load_params_overlay``) onto
    ``model``; leaves the file lacks keep their current values."""
    load_npz(model, path, jax_leaf_paths())
