"""image_labeling decoder: logits → argmax class index (+ label string).

The counterpart of ``nnstreamer_tpu/decoders/image_labeling.py``
(reference tensordec-labeling.c). Output: one tensor [N] of class indices,
uint32 by spec; on the device the argmax stays int64 (torch's unsigned
32-bit support on CUDA is thin) and the sink casts it at the host edge.
Label strings ride in ``frame.meta["labels"]`` when option1 names a labels
file — a host tail, so only then does the decoder leave the fused segment.
"""

from __future__ import annotations

import os
from typing import List, Optional

import torch

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.decoders.render import load_labels
from nnstreamer_tpu_torch.elements.base import NegotiationError
from nnstreamer_tpu_torch.tensors.frame import Frame
from nnstreamer_tpu_torch.tensors.spec import DType, TensorSpec, TensorsSpec


def _argmax(scores: torch.Tensor) -> torch.Tensor:
    if scores.dim() == 1:
        scores = scores[None, :]
    return torch.argmax(scores.reshape(scores.shape[0], -1), dim=-1)


@registry.decoder_plugin("image_labeling")
class ImageLabelingDecoder:
    def __init__(self) -> None:
        self._labels: Optional[List[str]] = None

    def negotiate(self, in_spec: TensorsSpec, options: dict) -> TensorsSpec:
        if in_spec.num_tensors != 1:
            raise NegotiationError("image_labeling: exactly one score tensor")
        t = in_spec[0]
        if t.rank < 1:
            raise NegotiationError(f"image_labeling: bad score tensor {t}")
        labels_path = options.get("option1", "")
        if labels_path:
            if not os.path.isfile(labels_path):
                raise NegotiationError(
                    f"image_labeling: labels file not found: {labels_path}"
                )
            self._labels = load_labels(labels_path)
        batch = t.shape[0] if t.rank > 1 else 1
        return TensorsSpec.of(
            TensorSpec((batch,), DType.UINT32, name="label_index"),
            rate=in_spec.rate,
        )

    def make_fn(self, in_spec: TensorsSpec, options: dict):
        """The argmax as a fused fn — only without a labels file."""
        if self._labels:
            return None
        return lambda tensors: (_argmax(tensors[0]),)

    def decode(self, frame: Frame, options: dict) -> Frame:
        scores = frame.tensors[0]
        if not isinstance(scores, torch.Tensor):
            scores = torch.as_tensor(scores)
        idx = _argmax(scores)
        out = frame.with_tensors((idx,))
        if self._labels:
            out = out.with_meta(labels=[
                self._labels[i] if i < len(self._labels) else str(i)
                for i in idx.tolist()
            ])
        return out
