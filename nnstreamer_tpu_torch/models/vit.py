"""Vision Transformer (ViT) classifier — the zoo's ``vit``.

The counterpart of ``nnstreamer_tpu/models/vit.py``: a patch-embedding
conv (stride = patch, VALID) plus its bias and a fixed 2-D sin/cos
position table, then the port's transformer blocks as an encoder
(``models/transformer.py apply_layers(..., causal=False)``, dense
attention) at zero RoPE positions (angle 0 is the identity, so position
lives in the table alone), RMSNorm ``ln_f``, a mean pool over the tokens
and a dense head. The defaults are ViT-S/16 (d 384, 6 heads, 12 layers,
patch 16, 224², 1001 classes: DeiT-S's widths, Touvron et al. 2021).

``ViT(x)``: uint8 (normalized as ``(x − 127.5)/127.5``) or float NHWC
[N, S, S, 3] → float32 logits [N, num_classes]. State keys: ``patch.*``,
``pos``, ``blocks.{i}.*`` (:class:`~.transformer.Block`), ``ln_f``,
``head.*``; ``models/jax_weights.py load_vit_npz`` carries the
reference's tree over.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from nnstreamer_tpu_torch.models import transformer as tfm
from nnstreamer_tpu_torch.models.nn import image_input, init_conv, init_dense

INPUT_SIZE = 224
PATCH = 16


def sincos_2d(grid: int, d_model: int) -> np.ndarray:
    """Fixed 2-D sin/cos position table [grid*grid, d_model], float32,
    built in numpy as the reference builds it."""
    assert d_model % 4 == 0, "d_model must be divisible by 4 for 2D sincos"
    d4 = d_model // 4
    omega = 1.0 / (10000 ** (np.arange(d4) / d4))
    pos = np.arange(grid)
    out = np.einsum("p,d->pd", pos, omega)
    row = np.concatenate([np.sin(out), np.cos(out)], axis=1)  # [grid, d4*2]
    full = np.concatenate(
        [np.repeat(row, grid, axis=0),  # y component
         np.tile(row, (grid, 1))],  # x component
        axis=1,
    )
    return full.astype(np.float32)


class PatchEmbed(nn.Module):
    """The patch conv: ``weight`` [d, 3, p, p] and ``bias`` [d] (the
    reference's ``{"w", "b"}``), stride p, no padding."""

    def __init__(self, d_model: int, patch: int,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.patch = patch
        self.weight = nn.Parameter(init_conv(3, d_model, patch, 1, generator),
                                   requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(d_model), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight, None, self.patch) + self.bias[:, None, None]


class ViT(nn.Module):
    """NHWC uint8/float image batch → float32 logits [N, num_classes]."""

    def __init__(self, num_classes: int = 1001, d_model: int = 384, n_heads: int = 6,
                 n_layers: int = 12, patch: int = PATCH, size: int = INPUT_SIZE,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        if size % patch:
            raise ValueError(f"vit: size {size} not divisible by patch {patch}")
        self.n_heads = n_heads
        lm = tfm.init_params(generator or torch.Generator(), vocab=1, d_model=d_model,
                             n_heads=n_heads, n_layers=n_layers, device="cpu")
        self.patch = PatchEmbed(d_model, patch, generator)
        self.register_buffer("pos", torch.from_numpy(sincos_2d(size // patch, d_model)))
        self.blocks = lm.blocks
        self.ln_f = lm.ln_f
        self.head = init_dense(d_model, num_classes, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.patch(image_input(x, self.patch.weight.dtype))  # [N, d, gh, gw]
        n, d, gh, gw = y.shape
        tokens = y.permute(0, 2, 3, 1).reshape(n, gh * gw, d) + self.pos.to(y.dtype)
        positions = torch.zeros((gh * gw,), dtype=torch.int32, device=y.device)
        tokens = tfm.apply_layers(self, tokens, self.n_heads, positions, causal=False)
        tokens = tfm.rmsnorm(tokens, self.ln_f)
        pooled = torch.mean(tokens, dim=1)
        return self.head(pooled).to(torch.float32)
