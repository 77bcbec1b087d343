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

import numpy as np
import torch
from torch import nn

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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.uint8:
            x = x.to(torch.float32)
            if self.input_quant is not None:
                scale, zp = self.input_quant
                x = (x - zp) * scale
            else:
                x = (x - 127.5) / 127.5
        else:
            x = x.to(torch.float32)
        # NHWC → NCHW view whose memory stays channels-last
        y = x.permute(0, 3, 1, 2)
        y = self.stem(y)
        for blk in self.blocks:
            y = blk(y)
        y = self.head(y)
        y = y.mean(dim=(2, 3))  # global average pool
        return self.classifier(y)


# -- weights carried over from the JAX package --------------------------------

_BN_LEAVES = ("bias", "mean", "scale", "var")  # sorted: tree-flatten order


def jax_leaf_paths() -> List[Tuple]:
    """Paths of the reference param tree's leaves in ``jax.tree_util``
    flatten order (dict keys sorted, lists in order) — the ``p{i}`` order
    of a ``params:<npz>`` file."""
    blocks = []
    for t, _, n, _ in _INVERTED_RESIDUAL_CFG:
        blocks.extend([t] * n)

    def conv(prefix):
        return [(*prefix, "bn", k) for k in _BN_LEAVES] + [(*prefix, "w")]

    paths: List[Tuple] = []
    for i, t in enumerate(blocks):
        names = ("dw", "expand", "project") if t != 1 else ("dw", "project")
        for name in names:
            paths.extend(conv(("blocks", i, name)))
    paths += [("classifier", "b"), ("classifier", "w")]
    paths += conv(("head",))
    paths += conv(("stem",))
    return paths


def _state_key(path: Tuple) -> str:
    """Reference param path → key of :class:`MobileNetV2`'s state dict."""
    if path[0] == "classifier":
        return "classifier." + {"w": "weight", "b": "bias"}[path[1]]
    if path[-2] == "bn":
        module, leaf = path[:-2], path[-1]
    else:  # the conv weight "w"
        module, leaf = path[:-1], "weight"
    return ".".join(str(p) for p in module) + "." + leaf


def _convert_leaf(path: Tuple, value: np.ndarray) -> torch.Tensor:
    """Layout carry-over of one leaf: conv HWIO → OIHW (depthwise
    (3,3,1,C) → (C,1,3,3) falls out of the same transpose), dense
    (cin, cout) → (cout, cin); vectors unchanged."""
    a = np.asarray(value, dtype=np.float32)
    if path[-1] == "w" and path[0] == "classifier":
        a = a.T
    elif path[-1] == "w":
        a = a.transpose(3, 2, 0, 1)
    return torch.tensor(np.ascontiguousarray(a))


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def mobilenet_v2_from_jax(params) -> Dict[str, torch.Tensor]:
    """The reference's param tree (nested dicts/lists of arrays, as
    ``nnstreamer_tpu.models.mobilenet_v2.init_params`` returns, converted
    to numpy) → a state dict for :class:`MobileNetV2`."""
    n_blocks = len(params["blocks"])
    if n_blocks != sum(n for _, _, n, _ in _INVERTED_RESIDUAL_CFG):
        raise ValueError(f"not a mobilenet_v2 tree: {n_blocks} blocks")
    return {
        _state_key(path): _convert_leaf(path, _get(params, path))
        for path in jax_leaf_paths()
    }


def load_jax_npz(model: MobileNetV2, path: str) -> None:
    """Overlay leaves ``p{i}`` of an npz (reference tree-flatten order,
    ``nnstreamer_tpu/models/zoo.py`` ``_load_params_overlay``) onto
    ``model``; leaves the file lacks keep their current values."""
    blob = np.load(path, allow_pickle=False)
    state = model.state_dict()
    for i, p in enumerate(jax_leaf_paths()):
        if f"p{i}" not in blob:
            continue
        key = _state_key(p)
        new = _convert_leaf(p, blob[f"p{i}"])
        if tuple(new.shape) != tuple(state[key].shape):
            raise ValueError(
                f"{path}: leaf p{i} ({key}) has shape {tuple(new.shape)}, "
                f"model wants {tuple(state[key].shape)}"
            )
        state[key] = new
    model.load_state_dict(state)
