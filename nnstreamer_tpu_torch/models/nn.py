"""Minimal NN primitives shared by the model zoo.

The counterpart of ``nnstreamer_tpu/models/nn.py`` as ``nn.Module``s.
Convolutions are cuDNN convolutions through ``torch.nn.functional.conv2d``
(the JAX package leaves them to XLA); activations are NCHW tensors in the
``channels_last`` memory format, which is the NHWC layout of the
reference in memory.

A model runs in its ``compute_dtype`` (float32 or bfloat16) the way the
reference's ``cast_params`` does: every float weight and batch-norm vector
is cast (``module.to(dtype)``), the input is normalized in that dtype
(:func:`image_input`), and the outputs are cast back to float32.

Two numerics of the reference are kept on purpose:

- TF-style ``SAME`` padding: a stride-2 3×3 conv on an even input pads
  (0, 1) on each axis, not torch's symmetric (1, 1), which would shift
  every output by one pixel;
- batch norm in the reference's form ``x·inv + (bias − mean·inv)`` with
  ``inv = rsqrt(var + eps)·scale`` and ``eps = 1e-3``. ``inv`` and the
  shift are computed once (:meth:`ConvBN.fold_bn`), not at every call;
  they are not folded into the conv weights, which would round otherwise.

Training (``parallel/train.py``) runs the reference's train-mode batch
norm instead (:func:`conv_bn_train`): the moments of the batch, mean and
biased variance over N, H and W, in the same formula; ``scale`` and
``bias`` train, ``mean`` and ``var`` are read by nothing and get no
gradient. It takes the batch as *rows*, one a data-parallel position,
whose moments are taken together, so a batch split over positions
normalizes as the whole batch would (:func:`batch_moments`).
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 6.0)


COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype_of(name: str) -> torch.dtype:
    """``compute_dtype=`` option → torch dtype (float32 | bfloat16)."""
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {name!r} (float32 | bfloat16)")
    return COMPUTE_DTYPES[name]


def normalize_uint8(x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 [0, 255] → [-1, 1] in ``dtype``: ``(x - 127.5) / 127.5`` (the
    reference's ``mobilenet_v2.normalize_uint8``)."""
    return (x.to(dtype) - 127.5) / 127.5


def image_input(x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8/float NHWC batch → normalized ``dtype`` NCHW view whose memory
    stays channels-last (uint8 normalized, floats only cast)."""
    x = normalize_uint8(x, dtype) if x.dtype == torch.uint8 else x.to(dtype)
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW (channels-last memory) → the reference's NHWC view."""
    return x.permute(0, 2, 3, 1)


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
    reference's ``{"w", "bn": {"scale", "bias", "mean", "var"}}``. The
    per-channel ``inv`` and ``shift`` are derived buffers (not in the
    state dict), refreshed by :meth:`fold_bn` whenever the batch-norm
    vectors change: after ``load_state_dict`` and after a move or cast
    (``.to``), so they are computed on the model's device in its dtype."""

    def __init__(
        self, cin: int, cout: int, k: int, stride: int = 1, groups: int = 1,
        act: bool = True, eps: float = 1e-3,
        generator: Optional[torch.Generator] = None, dilation: int = 1,
    ) -> None:
        super().__init__()
        self.stride, self.groups, self.act, self.eps = stride, groups, act, eps
        self.dilation = dilation  # the atrous rate (DeepLab's output stride)
        self.weight = nn.Parameter(init_conv(cin, cout, k, groups, generator),
                                   requires_grad=False)
        self.register_buffer("scale", torch.ones(cout))
        self.register_buffer("bias", torch.zeros(cout))
        self.register_buffer("mean", torch.zeros(cout))
        self.register_buffer("var", torch.ones(cout))
        self.register_buffer("inv", torch.empty(cout), persistent=False)
        self.register_buffer("shift", torch.empty(cout), persistent=False)
        self.fold_bn()

    @torch.no_grad()
    def fold_bn(self) -> None:
        """``inv = rsqrt(var + eps)·scale`` and ``shift = bias − mean·inv``
        from the current batch-norm vectors: the ops the forward used to
        run at every call, on the same inputs."""
        inv = torch.rsqrt(self.var + self.eps) * self.scale
        self.inv = inv
        self.shift = self.bias - self.mean * inv

    def _apply(self, fn, *args, **kwargs):
        super()._apply(fn, *args, **kwargs)
        self.fold_bn()
        return self

    def _load_from_state_dict(self, *args, **kwargs) -> None:
        super()._load_from_state_dict(*args, **kwargs)
        self.fold_bn()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv2d_same(x, self.weight, self.stride, self.groups, self.dilation)
        y = y * self.inv[:, None, None] + self.shift[:, None, None]
        return relu6(y) if self.act else y


def batch_moments(ys: Sequence[torch.Tensor],
                  reduce: Optional[Callable] = None) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per-channel mean and biased variance over N, H and W of the rows
    ``ys`` (NCHW, each on its device) taken together: the reference's
    ``jnp.mean`` / ``jnp.var`` over the whole batch. The rows' sums meet
    on the first row's device; ``reduce`` adds them up across processes
    (the count as well). → (mean, var) for each row, on its device."""
    home = ys[0].device

    def total(parts):
        out = parts[0].to(home)
        for t in parts[1:]:
            out = out + t.to(home)
        return out

    s = total([y.sum(dim=(0, 2, 3)) for y in ys])
    n = float(sum(y.numel() // y.shape[1] for y in ys))
    if reduce is not None:
        sn = reduce(torch.cat([s, s.new_tensor([n])]))
        s, n = sn[:-1], sn[-1]
    mean = s / n
    ss = total([((y - mean.to(y.device)[:, None, None]) ** 2).sum(dim=(0, 2, 3)) for y in ys])
    if reduce is not None:
        ss = reduce(ss)
    var = ss / n
    return [(mean.to(y.device), var.to(y.device)) for y in ys]


def relu6_train(x: torch.Tensor) -> torch.Tensor:
    """ReLU6 as the reference writes it, ``min(max(x, 0), 6)``: the same
    values as :func:`relu6`, and the same gradient at a tie (x exactly 0
    or 6, as a dead channel's batch norm gives), which ``maximum`` and
    ``minimum`` split evenly where ``clamp`` passes it whole."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_full((), 6.0))


def batch_norm_train(y: torch.Tensor, layer: "ConvBN", mean: torch.Tensor,
                     var: torch.Tensor) -> torch.Tensor:
    """The reference's batch norm with the batch's moments:
    ``y·inv + (bias − mean·inv)``, ``inv = rsqrt(var + eps)·scale``."""
    inv = torch.rsqrt(var + layer.eps) * layer.scale.to(y.dtype)
    return y * inv[:, None, None] + (layer.bias.to(y.dtype) - mean * inv)[:, None, None]


def conv_bn_train(layers: Sequence["ConvBN"], xs: Sequence[torch.Tensor],
                  moments: Callable = batch_moments) -> List[torch.Tensor]:
    """One :class:`ConvBN` in train mode over the rows ``xs``: ``layers[i]``
    is row i's copy of it (on the row's device), the weights cast to the
    rows' dtype, the batch norm on ``moments`` of all rows together."""
    ys = [conv2d_same(x, layer.weight.to(x.dtype), layer.stride, layer.groups, layer.dilation)
          for layer, x in zip(layers, xs)]
    out = [batch_norm_train(y, layer, m, v)
           for y, layer, (m, v) in zip(ys, layers, moments(ys))]
    return [relu6_train(o) for o in out] if layers[0].act else out


def init_conv(cin: int, cout: int, k: int, groups: int = 1,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """OIHW conv weight with the reference's He init: N(0, 2/fan_in)."""
    fan_in = (cin // groups) * k * k
    std = math.sqrt(2.0 / max(fan_in, 1))
    return torch.randn((cout, cin // groups, k, k), generator=generator) * std


class SepConv(nn.Module):
    """Depthwise 3×3 + pointwise 1×1, batch norm and ReLU6 after each (the
    reference's ``sep_conv``: a MobileNet-v1 block). State ``dw.*`` and
    ``pw.*`` as its ``{"dw": {...}, "pw": {...}}``."""

    def __init__(self, cin: int, cout: int, stride: int = 1, dilation: int = 1,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.dw = ConvBN(cin, cin, 3, stride=stride, groups=cin, generator=generator,
                         dilation=dilation)
        self.pw = ConvBN(cin, cout, 1, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pw(self.dw(x))


class BiasConv(nn.Module):
    """A biased SAME conv (no batch norm, no activation): a detection head.
    State ``weight`` [O, I, k, k] and ``bias`` [O], as the reference's
    ``{"w", "b"}``."""

    def __init__(self, cin: int, cout: int, k: int,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.weight = nn.Parameter(init_conv(cin, cout, k, 1, generator), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(cout), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d_same(x, self.weight) + self.bias[:, None, None]


def init_dense(cin: int, cout: int, generator: Optional[torch.Generator] = None) -> nn.Linear:
    """Dense layer with the reference's init: N(0, 1/cin) weights, zero bias."""
    lin = nn.Linear(cin, cout)
    with torch.no_grad():
        std = math.sqrt(1.0 / max(cin, 1))
        lin.weight.copy_(torch.randn((cout, cin), generator=generator) * std)
        lin.bias.zero_()
    lin.requires_grad_(False)
    return lin
