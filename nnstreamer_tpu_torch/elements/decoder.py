"""tensor_decoder: tensor → result egress.

The counterpart of ``nnstreamer_tpu/elements/decoder.py``: dispatches to
decoder subplugins by ``mode=`` with ``option1..option9`` strings.
Subplugins are objects with ``negotiate(in_spec, options) -> Spec`` and
``decode(frame, options) -> Frame``; one that also exposes
``make_fn(in_spec, options)`` returning a function over device tensors
fuses into the upstream segment (image_labeling's argmax without a labels
file: the egress payload shrinks to [N] indices on the device).
"""

from __future__ import annotations

from typing import List

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.elements.base import (
    NegotiationError,
    PropSpec,
    Spec,
    TensorOp,
)
from nnstreamer_tpu_torch.tensors.frame import Frame
from nnstreamer_tpu_torch.tensors.spec import TensorsSpec


@registry.element("tensor_decoder")
class TensorDecoder(TensorOp):
    FACTORY_NAME = "tensor_decoder"

    PROPERTIES = dict(
        {"mode": PropSpec("str", None, desc="decoder subplugin name")},
        **{
            f"option{i}": PropSpec("str", "", desc="mode-specific option")
            for i in range(1, 10)
        },
    )

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.mode = str(self.get_property("mode", ""))
        if not self.mode:
            raise ValueError(f"{self.name}: tensor_decoder needs mode=")
        self.options = {
            f"option{i}": str(self.get_property(f"option{i}", "")) for i in range(1, 10)
        }
        self._sub = None
        self._fn = None

    def negotiate(self, in_specs: List[Spec]) -> List[Spec]:
        (spec,) = in_specs
        if not isinstance(spec, TensorsSpec):
            raise NegotiationError(f"{self.name}: needs tensor input, got {spec}")
        sub = registry.get(registry.KIND_DECODER, self.mode)
        self._sub = sub() if isinstance(sub, type) else sub
        out = [self._sub.negotiate(spec, self.options)]
        mk = getattr(self._sub, "make_fn", None)
        self._fn = mk(spec, self.options) if mk is not None else None
        return out

    def is_traceable(self) -> bool:
        return self._fn is not None

    def make_fn(self):
        return self._fn

    def host_process(self, frame: Frame) -> Frame:
        return self._sub.decode(frame, self.options)
