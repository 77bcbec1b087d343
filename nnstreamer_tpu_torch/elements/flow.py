"""Flow elements: tee, queue, capsfilter.

The counterpart of ``nnstreamer_tpu/elements/flow.py``.
"""

from __future__ import annotations

from typing import List, Tuple

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.elements.base import (
    NegotiationError,
    PROPS_ANY,
    PropSpec,
    Routing,
    Spec,
    TensorOp,
)
from nnstreamer_tpu_torch.tensors.frame import Frame
from nnstreamer_tpu_torch.tensors.spec import TensorsSpec


@registry.element("tee")
class Tee(Routing):
    """1→N fan-out. Every branch gets the same frame object and the same
    tensors, with no copy: no ported element writes its input in place."""

    FACTORY_NAME = "tee"
    N_SINKS = 1
    N_SRCS = None  # request pads

    def negotiate(self, in_specs: List[Spec]) -> List[Spec]:
        (spec,) = in_specs
        return [spec] * self._n_srcs

    def receive(self, pad: int, frame: Frame) -> List[Tuple[int, Frame]]:
        return [(i, frame) for i in range(self._n_srcs)]


@registry.element("queue")
class Queue(TensorOp):
    """Explicit buffering boundary: a node and a thread of its own, so the
    two sides of it run in parallel (GStreamer's queue). It never fuses
    with its neighbours, sets the depth of its own input queue
    (``max-size-buffers``), and passes frames on where they are."""

    FACTORY_NAME = "queue"
    DEVICE_PASSTHROUGH = True

    PROPERTIES = {
        "max-size-buffers": PropSpec(
            "int", 64, desc="depth of this element's input queue"
        ),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.queue_size = int(self.get_property("max-size-buffers", 64))

    def negotiate(self, in_specs: List[Spec]) -> List[Spec]:
        return list(in_specs)

    def is_traceable(self) -> bool:
        return False  # a thread boundary by design

    def host_process(self, frame: Frame) -> Frame:
        return frame


@registry.element("capsfilter")
class CapsFilter(TensorOp):
    """Constrain/refine the negotiated spec (gst capsfilter, or a caps
    string between ``!`` in a description).

    Tensor links: dimensions/types/format/framerate are matched and merged
    into the upstream spec. Media links: width/height/format are checked
    against the MediaSpec. The identity at run time: fused on tensor
    links, a host pass-through on media links."""

    FACTORY_NAME = "capsfilter"
    DEVICE_PASSTHROUGH = True

    PROPERTIES = {
        "dimensions": PropSpec("str", None),
        "types": PropSpec("str", "float32"),
        "format": PropSpec("str", None),
        "framerate": PropSpec("fraction", None),
        "media": PropSpec("str", None),
        "width": PropSpec("int", None),
        "height": PropSpec("int", None),
        PROPS_ANY: PropSpec("str", None, desc="raw caps fields pass through"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        dims = self.get_property("dimensions")
        self._constraint = None
        if dims:
            self._constraint = TensorsSpec.from_strings(
                str(dims),
                str(self.get_property("types", "float32")),
                format=str(self.get_property("format", "static")),
                rate=self.get_property("framerate"),
            )

    def negotiate(self, in_specs: List[Spec]) -> List[Spec]:
        (spec,) = in_specs
        if isinstance(spec, TensorsSpec):
            if self._constraint is None:
                return [spec]
            if not spec.is_compatible(self._constraint):
                raise NegotiationError(
                    f"{self.name}: caps mismatch {spec} vs {self._constraint}"
                )
            return [spec.merge(self._constraint)]
        for key in ("width", "height"):
            want = self.get_property(key)
            if want is not None and getattr(spec, key) != int(want):
                raise NegotiationError(
                    f"{self.name}: media {key} {getattr(spec, key)} != {want}"
                )
        want_fmt = self.get_property("format")
        if want_fmt and spec.format != want_fmt:
            raise NegotiationError(
                f"{self.name}: media format {spec.format} != {want_fmt}"
            )
        return [spec]

    def is_traceable(self) -> bool:
        return bool(self.in_specs) and isinstance(self.in_specs[0], TensorsSpec)

    def make_fn(self):
        return lambda tensors: tensors

    def host_process(self, frame: Frame) -> Frame:
        return frame
