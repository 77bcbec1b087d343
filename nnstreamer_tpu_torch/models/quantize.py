"""Post-training int8: the MobileNet-v2 family and the transformer LMs.

**MobileNet-v2** (the counterpart of the MobileNet half of
``nnstreamer_tpu/models/quantize.py``, the reference's
mobilenet_v2_1.0_224_quant.tflite slot): every conv + batch norm folds to
conv + bias (:func:`fold_mobilenet`), then the 1×1 convs (expand, project,
head: most of the FLOPs) are quantized and the stem and depthwise convs
stay float, as in the reference:

- ``int8`` (:func:`quantize_mobilenet`): per-output-channel symmetric int8
  weights and per-tensor symmetric int8 activations whose scales are
  calibrated on seeded uint8 batches (:func:`calibrate_mobilenet`); each
  1×1 conv quantizes its input, contracts s8×s8→s32 and dequantizes. The
  product is exact: ``torch._int_mm`` (a library int8 GEMM) on the card,
  an int32 matmul on the CPU. The reference's product is an XLA
  ``dot_general`` outside any Pallas kernel.
- ``int8w`` (:func:`quantize_mobilenet_weights`): the same int8 weights,
  dequantized at the matmul operand; no activation quantization.

**Transformer LMs** (the LM half of the reference module: ``quantize_weight``,
``quantize_lm_weights``):(``quantize_weight``, ``quantize_lm_weights``): symmetric int8 with one
float32 scale per output channel over the contraction axis, ``scale =
max(max|w|, 1e-8) / 127`` and ``w8 = clip(round(w / scale), -127, 127)``
with round-half-even, the reference's arithmetic step for step. In the
port's ``[cout, cin]`` layout the contraction axis is the last, so a
linear weight's scale is ``[cout, 1]``; the embedding ``[vocab, d]`` keeps
the reference's per-feature scale over its axis -2, ``[1, d]``.

The quantized tensors live on the model as buffers of a
:class:`~.transformer.QuantizedWeight` in the weight's place, and
``transformer.wt`` / ``embed_lookup`` dequantize them at the matmul
operand, so the no-cache forward, decode and serving read int8 weights
unchanged.
"""

from __future__ import annotations

import itertools
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from nnstreamer_tpu_torch.models.mobilenet_v2 import MobileNetV2
from nnstreamer_tpu_torch.models.nn import ConvBN, conv2d_same, image_input, nhwc, relu6
from nnstreamer_tpu_torch.models.transformer import QuantizedWeight, TransformerLM

#: the block linears quantized, as the reference's ``_LM_QUANT_KEYS``
LM_QUANT_KEYS = ("wqkv", "wo", "w_gate", "w_up", "w_down")


@torch.no_grad()
def quantize_weight(w: torch.Tensor, axis: int = -1) -> QuantizedWeight:
    """Symmetric int8 with one scale per slice along ``axis`` (the
    contraction axis: -1 for an ``nn.Linear`` weight, -2 for the
    embedding's per-feature scales)."""
    m = torch.clamp(torch.amax(torch.abs(w.float()), dim=axis, keepdim=True), min=1e-8)
    scale = m / 127.0
    q = torch.clamp(torch.round(w.float() / scale), -127, 127).to(torch.int8)
    return QuantizedWeight(q, scale)


@torch.no_grad()
def quantize_lm_weights(model: TransformerLM) -> TransformerLM:
    """Weight-only int8 for every block linear, the embedding and the head,
    in place (norms stay float32); returns ``model``. The float weights are
    dropped, so a full-width model never holds both copies."""
    for blk in model.blocks:
        for name in LM_QUANT_KEYS:
            _replace_weight(getattr(blk, name), "weight", -1)
    _replace_weight(model.head, "weight", -1)
    _replace_weight(model, "embed", -2)
    return model


def _replace_weight(module: torch.nn.Module, name: str, axis: int) -> None:
    q = quantize_weight(getattr(module, name), axis)
    delattr(module, name)  # a Parameter's slot takes no module until it is gone
    setattr(module, name, q)


# -- the MobileNet-v2 family --------------------------------------------------

Folded = Tuple[torch.Tensor, torch.Tensor]  # (OIHW weight, bias) in float32


@torch.no_grad()
def fold_bn(conv: ConvBN) -> Folded:
    """conv → batch norm ≡ conv(w·inv) + b, with the conv's own folded
    ``inv = rsqrt(var + eps)·scale`` and ``b = bias − mean·inv``
    (:meth:`ConvBN.fold_bn`, inference moments)."""
    return conv.weight * conv.inv[:, None, None, None], conv.shift.clone()


@torch.no_grad()
def fold_mobilenet(model: MobileNetV2) -> Dict:
    """Every conv + batch norm of a float32 :class:`MobileNetV2` folded:
    ``{"stem", "blocks": [{"expand"?, "dw", "project"}], "head"}`` of
    (weight, bias), ``"classifier"`` (weight [O, I], bias), and the
    blocks' ``"strides"`` and ``"residual"`` flags."""
    blocks = []
    for blk in model.blocks:
        fb = {"dw": fold_bn(blk.dw), "project": fold_bn(blk.project)}
        if blk.expand is not None:
            fb["expand"] = fold_bn(blk.expand)
        blocks.append(fb)
    return {
        "stem": fold_bn(model.stem), "blocks": blocks, "head": fold_bn(model.head),
        "classifier": (model.classifier.weight.clone(), model.classifier.bias.clone()),
        "strides": [blk.dw.stride for blk in model.blocks],
        "residual": [blk.residual for blk in model.blocks],
    }


@torch.no_grad()
def _folded_forward(folded: Dict, x: torch.Tensor, collect: List[torch.Tensor]) -> None:
    """float32 forward of the folded model, appending the max |·| of every
    quantization point's input to ``collect`` (the calibration taps)."""
    (sw, sb) = folded["stem"]
    y = relu6(conv2d_same(x, sw, 2) + sb[:, None, None])
    for blk, stride, res in zip(folded["blocks"], folded["strides"], folded["residual"]):
        r = y
        if "expand" in blk:
            collect.append(torch.amax(torch.abs(y)))
            w, b = blk["expand"]
            y = relu6(F.conv2d(y, w) + b[:, None, None])
        w, b = blk["dw"]
        y = relu6(conv2d_same(y, w, stride, groups=y.shape[1]) + b[:, None, None])
        collect.append(torch.amax(torch.abs(y)))
        w, b = blk["project"]
        y = F.conv2d(y, w) + b[:, None, None]
        if res:
            y = y + r
    collect.append(torch.amax(torch.abs(y)))


@torch.no_grad()
def calibrate_mobilenet(folded: Dict, batches: Iterable[torch.Tensor]) -> torch.Tensor:
    """Run uint8 NHWC sample batches through the folded float32 model;
    return the per-quantization-point activation scales [n_points]
    (max |·| / 127)."""
    maxes = None
    for img in batches:
        collect: List[torch.Tensor] = []
        _folded_forward(folded, image_input(img, torch.float32), collect)
        t = torch.stack(collect)
        maxes = t if maxes is None else torch.maximum(maxes, t)
    if maxes is None:
        raise ValueError("calibrate_mobilenet: need at least one calibration batch")
    return torch.clamp(maxes, min=1e-6) / 127.0


def calibration_batches(seed: int, n: int, batch: int, size: int) -> List[np.ndarray]:
    """The zoo's calibration batches: ``n`` uint8 [batch, size, size, 3]
    arrays from ``np.random.default_rng(seed)``, the reference zoo's own."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (batch, size, size, 3), np.uint8) for _ in range(n)]


@torch.no_grad()
def _quantize_w(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 of a 1×1 conv weight [O, I, 1, 1]
    → (w8 [I, O] int8, the reference's shape, scale [O]). w8 is stored
    column-major (the [O, I] rows contiguous), the layout cuBLASLt's int8
    GEMM takes for its second operand."""
    scale = torch.clamp(torch.amax(torch.abs(w), dim=(1, 2, 3)), min=1e-8) / 127.0
    q = torch.clamp(torch.round(w / scale[:, None, None, None]), -127, 127).to(torch.int8)
    return q[:, :, 0, 0].contiguous().t(), scale


def int8_matmul(q: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """Exact s8 [M, K] × s8 [K, N] → s32 [M, N]. On the card
    ``torch._int_mm`` (cuBLASLt), which takes K and N multiples of 8
    (anything else raises here, before a launch), a column-major second
    operand (another layout raises here too) and more than 16 rows (fewer
    are padded with zero rows, and the padding cut off); on the CPU an
    int32 matmul."""
    m, k = q.shape
    n = w8.shape[1]
    if q.is_cuda:
        if k % 8 or n % 8:
            raise ValueError(f"int8 GEMM on CUDA takes K and N multiples of 8, got K {k}, N {n}")
        if w8.stride(0) != 1:
            raise ValueError("int8 GEMM on CUDA takes a column-major [K, N] second operand")
        if m <= 16:
            return torch._int_mm(F.pad(q, (0, 0, 0, 24 - m)), w8)[:m]
        return torch._int_mm(q, w8)
    if q.device.type == "cpu":
        return q.to(torch.int32) @ w8.to(torch.int32)
    raise RuntimeError(f"int8 GEMM has no implementation on {q.device}")


class _Conv1x1Q(nn.Module):
    """One quantized 1×1 conv: ``w8`` [I, O] int8, ``wscale`` [O], ``b``
    [O], and with calibrated activations ``ascale`` (a scalar); all
    float32 whatever the compute dtype."""

    def __init__(self, folded: Folded, ascale: Optional[torch.Tensor]) -> None:
        super().__init__()
        w8, wscale = _quantize_w(folded[0])
        self.register_buffer("w8", w8)
        self.register_buffer("wscale", wscale)
        self.register_buffer("b", folded[1].clone())
        self.register_buffer("ascale", None if ascale is None else ascale.clone())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, _, h, w = x.shape
        xs = nhwc(x).reshape(n * h * w, -1)
        if self.ascale is not None:
            # quantize the input, s8×s8→s32, dequantize: scales in float32
            q = torch.clamp(torch.round(xs.to(torch.float32) / self.ascale), -127, 127)
            acc = int8_matmul(q.to(torch.int8), self.w8)
            out = acc.to(torch.float32) * (self.ascale * self.wscale) + self.b
            out = out.to(x.dtype)
        else:
            # weight-only: dequantize at the operand read
            wd = (self.w8.to(torch.float32) * self.wscale).to(x.dtype)
            out = xs @ wd + self.b.to(x.dtype)
        return out.reshape(n, h, w, -1).permute(0, 3, 1, 2)


class QuantizedMobileNetV2(nn.Module):
    """uint8/float NHWC batch → float32 logits [N, classes] with the 1×1
    convs in int8 (``ascales`` given: the calibrated ``int8`` form) or
    int8 weights alone (``ascales`` None: ``int8w``). The stem, the
    depthwise convs and the pool run in ``compute_dtype``; the classifier
    in float32."""

    def __init__(self, folded: Dict, ascales: Optional[torch.Tensor] = None,
                 compute_dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.compute_dtype = compute_dtype
        self.strides, self.residual = list(folded["strides"]), list(folded["residual"])
        taps = itertools.count()

        def q(fc: Folded) -> _Conv1x1Q:
            return _Conv1x1Q(fc, None if ascales is None else ascales[next(taps)])

        def float_conv(prefix: str, fc: Folded) -> None:
            self.register_buffer(prefix + "_w", fc[0].to(compute_dtype))
            self.register_buffer(prefix + "_b", fc[1].to(compute_dtype))

        float_conv("stem", folded["stem"])
        expands, projects = nn.ModuleList(), nn.ModuleList()
        for i, blk in enumerate(folded["blocks"]):
            expands.append(q(blk["expand"]) if "expand" in blk else nn.Identity())
            float_conv(f"dw{i}", blk["dw"])
            projects.append(q(blk["project"]))
        self.expands, self.projects = expands, projects
        self.head = q(folded["head"])
        self.register_buffer("classifier_w", folded["classifier"][0].clone())
        self.register_buffer("classifier_b", folded["classifier"][1].clone())
        if ascales is not None and next(taps) != len(ascales):
            raise ValueError(f"{len(ascales)} activation scales for a model with fewer taps")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = image_input(x, self.compute_dtype)
        y = relu6(conv2d_same(y, self.stem_w, 2) + self.stem_b[:, None, None])
        for i, (expand, project) in enumerate(zip(self.expands, self.projects)):
            r = y
            if not isinstance(expand, nn.Identity):
                y = relu6(expand(y))
            w, b = getattr(self, f"dw{i}_w"), getattr(self, f"dw{i}_b")
            y = relu6(conv2d_same(y, w, self.strides[i], groups=y.shape[1]) + b[:, None, None])
            y = project(y)
            if self.residual[i]:
                y = y + r
        y = relu6(self.head(y))
        y = y.to(torch.float32).mean(dim=(2, 3))
        return F.linear(y, self.classifier_w, self.classifier_b)


def quantize_mobilenet(folded: Dict, act_scales: torch.Tensor,
                       compute_dtype: torch.dtype = torch.float32) -> QuantizedMobileNetV2:
    """Folded float32 model → the calibrated int8 serving model."""
    return QuantizedMobileNetV2(folded, act_scales, compute_dtype)


def quantize_mobilenet_weights(folded: Dict,
                               compute_dtype: torch.dtype = torch.float32) -> QuantizedMobileNetV2:
    """Folded float32 model → the weight-only int8 serving model (no
    calibration)."""
    return QuantizedMobileNetV2(folded, None, compute_dtype)
