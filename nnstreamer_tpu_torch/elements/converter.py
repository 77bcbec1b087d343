"""tensor_converter: media → other/tensors ingress.

The counterpart of ``nnstreamer_tpu/elements/converter.py``, for the
direct video path: HWC uint8 → (1, H, W, C), optionally normalized with
``input-norm=MEAN:STD`` into float32. Both are TensorOps, so they fuse
into the downstream segment: the frame crosses to the device once, at the
segment's entry, and the reshape and normalization run there. A static
tensor stream passes through unchanged.
"""

from __future__ import annotations

from typing import List

import torch

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.elements.base import (
    MediaSpec,
    NegotiationError,
    PropSpec,
    Spec,
    TensorOp,
)
from nnstreamer_tpu_torch.tensors.spec import DType, TensorFormat, TensorSpec, TensorsSpec


@registry.element("tensor_converter")
class TensorConverter(TensorOp):
    FACTORY_NAME = "tensor_converter"

    PROPERTIES = {
        "frames-per-tensor": PropSpec("int", 1, desc="batch N frames"),
        "input-norm": PropSpec(
            "str", None,
            desc="MEAN:STD — fuse (x - MEAN)/STD uint8→float32 "
            "normalization into the ingress (video input)",
        ),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.frames_per_tensor = int(self.get_property("frames-per-tensor", 1))
        if self.frames_per_tensor != 1:
            raise ValueError(
                f"{self.name}: frames-per-tensor={self.frames_per_tensor} "
                "is not ported yet (only 1)"
            )
        raw_norm = self.get_property("input-norm")
        self.input_norm = None
        if raw_norm:
            mean, sep, std = str(raw_norm).partition(":")
            try:
                self.input_norm = (float(mean), float(std)) if sep else None
            except ValueError:
                self.input_norm = None
            if self.input_norm is None:
                raise ValueError(
                    f"{self.name}: input-norm={raw_norm!r} (want MEAN:STD)"
                )
            if self.input_norm[1] == 0.0:
                raise ValueError(f"{self.name}: input-norm STD must be nonzero")
        self._fn = None

    def negotiate(self, in_specs: List[Spec]) -> List[Spec]:
        (spec,) = in_specs
        if isinstance(spec, MediaSpec):
            if spec.media_type != "video":
                raise NegotiationError(
                    f"{self.name}: {spec.media_type} media is not ported yet"
                )
            if spec.width is None or spec.height is None:
                raise NegotiationError(f"{self.name}: video size unknown")
            c = spec.channels_per_pixel
            dtype = DType.FLOAT32 if self.input_norm else DType.UINT8
            out = TensorSpec((1, spec.height, spec.width, c), dtype)
            if self.input_norm:
                mean, std = self.input_norm

                def fn(tensors):
                    x = tensors[0].to(torch.float32)
                    return (((x - mean) / std)[None, ...],)
            else:
                def fn(tensors):
                    return (tensors[0][None, ...],)
            self._fn = fn
            return [TensorsSpec.of(out, rate=spec.rate)]
        if self.input_norm is not None:
            raise NegotiationError(
                f"{self.name}: input-norm applies to video input only, got {spec}"
            )
        if isinstance(spec, TensorsSpec) and spec.format is TensorFormat.STATIC:
            self._fn = lambda tensors: tuple(tensors)
            return [spec]
        raise NegotiationError(f"{self.name}: cannot convert {spec!r}")

    def make_fn(self):
        return self._fn
