"""Weight-only int8 for the transformer LM family.

The counterpart of the LM half of ``nnstreamer_tpu/models/quantize.py``
(``quantize_weight``, ``quantize_lm_weights``): symmetric int8 with one
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
unchanged. The MobileNet half (BN folding, calibrated int8 activations)
is not ported.
"""

from __future__ import annotations

import torch

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
