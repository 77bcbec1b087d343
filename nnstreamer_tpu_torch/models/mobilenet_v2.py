"""MobileNet-v2 (1001-class, 224x224) — the flagship model of the main path.

The counterpart of ``nnstreamer_tpu/models/mobilenet_v2.py``: stem conv +
17 inverted-residual bottlenecks (expansion / depthwise / projection) +
1x1 conv to 1280 + global average pool + classifier; ReLU6 activations.
The input is a uint8 (or float) NHWC batch, normalized inside the model
as ``(x − 127.5)/127.5`` (or on the ``input_quant`` grid of imported tflite
weights), and the output is float32 logits [N, num_classes].

:func:`train_forward` (one device) and :func:`train_trunk` (rows on
several) run the reference's ``apply(train=True)``: batch-norm moments of
the batch (``models/nn.py conv_bn_train``); ``parallel/train.py`` trains
with them.

Weights: random from a ``torch.Generator`` seed (not the JAX package's
weights — the two generators differ), or carried over from the reference's
param tree with :func:`mobilenet_v2_from_jax` / :func:`load_jax_npz`.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from nnstreamer_tpu_torch.models.jax_weights import (
    BIASED,
    CONV_BN,
    load_npz,
    state_dict_from_tree,
    tree_paths,
)
from nnstreamer_tpu_torch.models.nn import (
    ConvBN,
    batch_moments,
    conv_bn_train,
    init_dense,
    normalize_uint8,
)

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

    def _input(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """uint8/float NHWC batch → normalized NCHW view in the compute
        dtype (default: the weights' dtype) whose memory stays channels-last."""
        dtype = dtype or self.stem.weight.dtype
        if x.dtype == torch.uint8:
            if self.input_quant is not None:
                scale, zp = self.input_quant
                x = (x.to(dtype) - zp) * scale
            else:
                x = normalize_uint8(x, dtype)
        else:
            x = x.to(dtype)
        return x.permute(0, 3, 1, 2)

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        """Stem and blocks: the 320-channel map before the head (NCHW)."""
        y = self.stem(self._input(x))
        for blk in self.blocks:
            y = blk(y)
        return y

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.head(self.trunk(x))
        y = y.mean(dim=(2, 3))  # global average pool
        return self.classifier(y).to(torch.float32)

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


# -- train mode (batch-norm moments of the batch) ------------------------------


def train_trunk(rows: Sequence[MobileNetV2], xs: Sequence[torch.Tensor],
                compute_dtype: torch.dtype = torch.float32,
                moments: Callable = batch_moments) -> List[torch.Tensor]:
    """Stem and blocks in train mode over the rows ``xs`` (uint8/float
    NHWC, one a data-parallel position; ``rows[i]`` is row i's copy of the
    model on its device): every batch norm takes the moments of all rows
    together → each row's 320-channel map (NCHW)."""
    ys = conv_bn_train([r.stem for r in rows],
                       [r._input(x, compute_dtype) for r, x in zip(rows, xs)], moments)
    for k in range(len(rows[0].blocks)):
        blks = [r.blocks[k] for r in rows]
        inp = ys
        if blks[0].expand is not None:
            ys = conv_bn_train([b.expand for b in blks], ys, moments)
        ys = conv_bn_train([b.dw for b in blks], ys, moments)
        ys = conv_bn_train([b.project for b in blks], ys, moments)
        if blks[0].residual:
            ys = [y + x for y, x in zip(ys, inp)]
    return ys


def train_forward(model: MobileNetV2, x: torch.Tensor,
                  compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The reference's ``apply(params, x, train=True)`` on one device:
    float32 logits [N, num_classes] with the batch's moments in every
    batch norm."""
    (y,) = train_trunk([model], [x], compute_dtype)
    (h,) = conv_bn_train([model.head], [y])
    pooled = h.mean(dim=(2, 3))
    cls = model.classifier
    return F.linear(pooled, cls.weight.to(pooled.dtype), cls.bias.to(pooled.dtype)).float()


# -- weights carried over from the JAX package --------------------------------


def jax_tree() -> Dict:
    """Skeleton of the reference param tree (leaves None), for
    :func:`~.jax_weights.tree_paths`."""
    blocks = []
    for t, _, n, _ in _INVERTED_RESIDUAL_CFG:
        parts = ("expand", "dw", "project") if t != 1 else ("dw", "project")
        blocks.extend([dict.fromkeys(parts, CONV_BN)] * n)
    return {"stem": CONV_BN, "blocks": blocks, "head": CONV_BN, "classifier": BIASED}


def jax_leaf_paths() -> List[Tuple]:
    """Paths of the reference param tree's leaves in ``jax.tree_util``
    flatten order (dict keys sorted, lists in order) — the ``p{i}`` order
    of a ``params:<npz>`` file."""
    return tree_paths(jax_tree())


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


# -- weights imported from a .tflite file --------------------------------------


def load_tflite_params(path: str) -> MobileNetV2:
    """A :class:`MobileNetV2` (float32, on the CPU) with the weights of a
    mobilenet_v2 1.0 ``.tflite`` file: its conv ops walked in graph order
    (the order the module builds its convs in), each weight and bias
    dequantized exactly off its integer grid (tools/tflite_parse.py), and
    the TFLite-fused biases folded in as identity batch norms (scale
    ``sqrt(1 + eps)``, so that ``rsqrt(var + eps)·scale`` is one and the
    output is ``conv + bias``). The last conv, the 1x1 logits conv, becomes
    the dense classifier. A quantized input tensor's (scale, zero point)
    replaces the generic ``(x - 127.5)/127.5`` (``input_quant``).

    The counterpart of ``nnstreamer_tpu/models/mobilenet_v2.py
    load_tflite_params``, which returns the same weights as a param tree.
    A graph that is not the 1.0 topology raises ``ValueError``."""
    import numpy as np

    from nnstreamer_tpu_torch.tools.tflite_parse import parse

    m = parse(path)
    convs = iter(op for op in m.operators if op.name in ("CONV_2D", "DEPTHWISE_CONV_2D"))
    model = MobileNetV2(num_classes=1, generator=torch.Generator())
    state: Dict[str, torch.Tensor] = {}
    eps = 1e-3  # ConvBN's default

    def bias_of(op, cout: int) -> np.ndarray:
        # -1 is tflite's missing-optional-input sentinel
        if len(op.inputs) > 2 and op.inputs[2] >= 0:
            return m.tensors[op.inputs[2]].dequantized()
        return np.zeros((cout,), np.float32)

    def conv_entry(prefix: str, cin: int, cout: int, dw: bool = False) -> None:
        op = next(convs)
        w = m.tensors[op.inputs[1]].dequantized()
        # tflite conv weights are [O, KH, KW, I], depthwise [1, KH, KW, C]
        w = np.transpose(w, (3, 0, 1, 2) if dw else (0, 3, 1, 2))
        want = (cout, 1 if dw else cin)
        if w.shape[:2] != want:
            raise ValueError(f"{path}: conv channels {w.shape[:2]} != {want} — "
                             "not the mobilenet_v2(1.0) topology")
        c = w.shape[0]
        state[f"{prefix}.weight"] = torch.tensor(np.ascontiguousarray(w, np.float32))
        state[f"{prefix}.scale"] = torch.full((c,), float(np.sqrt(1.0 + eps)))
        state[f"{prefix}.bias"] = torch.tensor(np.asarray(bias_of(op, c), np.float32))
        state[f"{prefix}.mean"] = torch.zeros(c)
        state[f"{prefix}.var"] = torch.ones(c)

    try:
        cin = _make_divisible(32)
        conv_entry("stem", 3, cin)
        k = 0
        for t, c, n, _ in _INVERTED_RESIDUAL_CFG:
            cout = _make_divisible(c)
            for _ in range(n):
                hidden = cin * t
                if t != 1:
                    conv_entry(f"blocks.{k}.expand", cin, hidden)
                conv_entry(f"blocks.{k}.dw", hidden, hidden, dw=True)
                conv_entry(f"blocks.{k}.project", hidden, cout)
                cin = cout
                k += 1
        conv_entry("head", cin, 1280)
        cls = next(convs)  # the 1x1 logits conv == the pooled dense
    except StopIteration:
        raise ValueError(f"{path}: conv walk ended early — not a mobilenet_v2(1.0) graph "
                         "(wrong file or width multiplier)") from None
    leftover = sum(1 for _ in convs)
    if leftover:
        raise ValueError(f"{path}: {leftover} conv ops beyond the mobilenet_v2(1.0) "
                         "topology — refusing a partial import")
    w = m.tensors[cls.inputs[1]].dequantized()  # [classes, 1, 1, 1280]
    w = np.ascontiguousarray(w.reshape(w.shape[0], -1), np.float32)
    model.classifier = nn.Linear(w.shape[1], w.shape[0]).requires_grad_(False)
    state["classifier.weight"] = torch.tensor(w)
    state["classifier.bias"] = torch.tensor(np.asarray(bias_of(cls, w.shape[0]), np.float32))
    model.load_state_dict(state)
    t_in = m.tensors[m.inputs[0]]
    if t_in.quant is not None and t_in.quant.quantized:
        zp = float(t_in.quant.zero_point[0]) if t_in.quant.zero_point.size else 0.0
        model.input_quant = (float(t_in.quant.scale[0]), zp)
    return model.eval()
