"""tensor_stage: a node of its own that moves frames to the device.

The counterpart of ``nnstreamer_tpu/elements/stage.py``. Uploading inside
the filter's node serializes frame N+1's host-to-device copy with frame
N's dispatch; this element moves the upload into its own executor node:
its thread copies frame N+1 up (pinned memory, ``non_blocking=True``, on
the current stream) while the node after it is still dispatching frame N,
and the inbox between them is the double (in general ``queue-size``-deep)
buffer. The copy is asynchronous, so the stage never waits on the wire;
the stream orders it before the work that reads it.

Props: ``device`` (a CUDA device index; default the pipeline's device),
``stamp`` (record ``meta["staged_at"]``, the host clock when the frame
left this node).
"""

from __future__ import annotations

import time
from typing import List

import torch

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.elements.base import HostElement, PropSpec, Spec, parse_bool
from nnstreamer_tpu_torch.pipeline import transfer
from nnstreamer_tpu_torch.tensors.frame import Frame


@registry.element("tensor_stage")
class TensorStage(HostElement):
    """Uploads each frame's tensors to the device; the spec passes through."""

    FACTORY_NAME = "tensor_stage"

    PROPERTIES = {
        "stamp": PropSpec("bool", False, desc="record staged_at meta"),
        "device": PropSpec("int", None, desc="CUDA device index (default the pipeline's)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.stamp = parse_bool(self.get_property("stamp", False))
        self._target = None

    def negotiate(self, in_specs: List[Spec]) -> List[Spec]:
        return list(in_specs)  # the placement changes, the spec does not

    def start(self) -> None:
        idx = self.get_property("device")
        if idx is None:
            self._target = self.device
            return
        i = int(idx)
        n = torch.cuda.device_count()
        if not 0 <= i < n:
            raise ValueError(f"{self.name}: device:{i} out of range ({n} CUDA devices)")
        self._target = torch.device("cuda", i)

    def process(self, frame: Frame) -> Frame:
        target = self._target if self._target is not None else self.device
        out = transfer.stage_frame(frame, target)
        if target.type == "cpu":
            out = out.to_device(target)
        if self.stamp:
            # stamped after the copies are issued (they are asynchronous):
            # when this node handed the frame on
            out = out.with_meta(staged_at=time.perf_counter())
        return out
