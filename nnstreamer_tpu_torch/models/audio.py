"""Raw-waveform audio classifier (keyword spotting) — the zoo's ``kws``.

The counterpart of ``nnstreamer_tpu/models/audio.py``: an M5-style deep
conv net over the raw waveform (Dai et al., "Very Deep CNNs for Raw
Waveforms"): a long-kernel strided stem (k 80, s 16) then three conv +
pool stages, each conv with batch norm and ReLU6, and a global-mean dense
head. The 1-D convs are 2-D convs with H = 1 (weights [Cout, Cin, 1, K],
the reference's HWIO [1, K, Cin, Cout]) under TF ``SAME`` padding; a pool
is a reshape-mean that drops the remainder, and a clip shorter than the
pool skips it.

``KWS(x)``: int16 PCM (scaled by 1/32768) or float, [B, T, C] or the
converter's unbatched [T, C] (which gains a batch axis), channels mixed to
mono by their mean → float32 logits [B, num_classes].
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from nnstreamer_tpu_torch.models.nn import ConvBN, init_dense

STEM_K = 80
STEM_S = 16


class Conv1dBN(ConvBN):
    """A :class:`~.nn.ConvBN` over a [B, C, 1, T] map: weight [Cout, Cin, 1,
    k], stride on T (H is 1, so the stride there changes nothing), the
    reference's He init N(0, 2/(Cin·k))."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__(cin, cout, 1, stride=stride, generator=generator)
        std = math.sqrt(2.0 / max(cin * k, 1))
        self.weight = nn.Parameter(torch.randn((cout, cin, 1, k), generator=generator) * std,
                                   requires_grad=False)


class KWS(nn.Module):
    """[B, T, C] / [T, C] int16 or float → float32 logits [B, num_classes]."""

    def __init__(self, num_classes: int = 12, width: int = 32,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        c1, c2, c3 = width, width * 2, width * 4
        self.stem = Conv1dBN(1, c1, STEM_K, STEM_S, generator)
        self.c2 = Conv1dBN(c1, c2, 3, generator=generator)
        self.c3 = Conv1dBN(c2, c3, 3, generator=generator)
        self.c4 = Conv1dBN(c3, c3, 3, generator=generator)
        self.head = init_dense(c3, num_classes, generator)

    @staticmethod
    def _block(x: torch.Tensor, conv: Conv1dBN, pool: int = 4) -> torch.Tensor:
        y = conv(x)  # [B, C, 1, T]
        b, c, _, t = y.shape
        if t < pool:  # short clips: the global head pools what remains
            return y
        t4 = (t // pool) * pool
        return torch.mean(y[..., :t4].reshape(b, c, 1, t4 // pool, pool), dim=-1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.stem.weight.dtype
        if x.dim() == 2:
            x = x[None]  # converter audio tensors are [samples, channels]
        if not x.is_floating_point():
            x = x.to(dtype) * (1.0 / 32768.0)
        else:
            x = x.to(dtype)
        x = torch.mean(x, dim=-1, keepdim=True)  # mono mix: [B, T, 1]
        y = x.permute(0, 2, 1)[:, :, None, :]  # [B, 1, 1, T]
        for conv in (self.stem, self.c2, self.c3, self.c4):
            y = self._block(y, conv)
        pooled = torch.mean(y, dim=(2, 3))
        return self.head(pooled).to(torch.float32)
