"""Minimal NN primitives shared by the model zoo.

The counterpart of ``nnstreamer_tpu/models/nn.py`` as ``nn.Module``s.
Convolutions are cuDNN convolutions through ``torch.nn.functional.conv2d``
(the JAX package leaves them to XLA); activations are NCHW tensors in the
``channels_last`` memory format, which is the NHWC layout of the
reference in memory.

Two numerics of the reference are kept on purpose:

- TF-style ``SAME`` padding: a stride-2 3×3 conv on an even input pads
  (0, 1) on each axis, not torch's symmetric (1, 1), which would shift
  every output by one pixel;
- batch norm in the reference's form ``x·inv + (bias − mean·inv)`` with
  ``inv = rsqrt(var + eps)·scale`` and ``eps = 1e-3``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 6.0)


def same_padding(n: int, k: int, stride: int, dilation: int = 1) -> Tuple[int, int]:
    """(low, high) padding of one axis under TF ``SAME``."""
    k_eff = (k - 1) * dilation + 1
    out = -(-n // stride)
    total = max((out - 1) * stride + k_eff - n, 0)
    return total // 2, total - total // 2


def conv2d_same(
    x: torch.Tensor, w: torch.Tensor, stride: int = 1, groups: int = 1,
    dilation: int = 1,
) -> torch.Tensor:
    """NCHW conv with TF ``SAME`` padding; ``w`` is OIHW."""
    kh, kw = w.shape[-2:]
    ph = same_padding(x.shape[-2], kh, stride, dilation)
    pw = same_padding(x.shape[-1], kw, stride, dilation)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, w, None, stride, (ph[0], pw[0]), dilation, groups)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, w, None, stride, 0, dilation, groups)


class ConvBN(nn.Module):
    """conv (SAME) → batch norm (inference moments) → optional ReLU6.

    State: ``weight`` [O, I/groups, kh, kw] and the batch-norm vectors
    ``scale``, ``bias``, ``mean``, ``var`` [O] — one-to-one with the
    reference's ``{"w", "bn": {"scale", "bias", "mean", "var"}}``."""

    def __init__(
        self, cin: int, cout: int, k: int, stride: int = 1, groups: int = 1,
        act: bool = True, eps: float = 1e-3,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.stride, self.groups, self.act, self.eps = stride, groups, act, eps
        fan_in = (cin // groups) * k * k
        std = math.sqrt(2.0 / max(fan_in, 1))
        w = torch.randn((cout, cin // groups, k, k), generator=generator) * std
        self.weight = nn.Parameter(w, requires_grad=False)
        self.register_buffer("scale", torch.ones(cout))
        self.register_buffer("bias", torch.zeros(cout))
        self.register_buffer("mean", torch.zeros(cout))
        self.register_buffer("var", torch.ones(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv2d_same(x, self.weight, self.stride, self.groups)
        inv = torch.rsqrt(self.var + self.eps) * self.scale
        shift = self.bias - self.mean * inv
        y = y * inv[:, None, None] + shift[:, None, None]
        return relu6(y) if self.act else y


def init_dense(cin: int, cout: int, generator: Optional[torch.Generator] = None) -> nn.Linear:
    """Dense layer with the reference's init: N(0, 1/cin) weights, zero bias."""
    lin = nn.Linear(cin, cout)
    with torch.no_grad():
        std = math.sqrt(1.0 / max(cin, 1))
        lin.weight.copy_(torch.randn((cout, cin), generator=generator) * std)
        lin.bias.zero_()
    lin.requires_grad_(False)
    return lin
