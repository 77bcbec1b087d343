"""flexbuf converter subplugin: serialized flex-tensor bytes → tensors.

The counterpart of ``nnstreamer_tpu/converters/flexbuf.py`` (reference
tensor_converter_flexbuf.cc). The wire format is the framework's own
flex-tensor header codec (tensors/meta.py), so
``tensor_decoder mode=flexbuf ! tensor_converter mode=flexbuf`` is the
identity.
"""

from __future__ import annotations

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.tensors.frame import Frame
from nnstreamer_tpu_torch.tensors.meta import decode_frame_tensors, host_bytes
from nnstreamer_tpu_torch.tensors.spec import TensorFormat, TensorsSpec


@registry.converter_plugin("flexbuf")
class FlexbufConverter:
    def negotiate(self, in_spec, props: dict) -> TensorsSpec:
        # per-frame headers carry the shapes: the output is flexible
        return TensorsSpec(format=TensorFormat.FLEXIBLE)

    def convert(self, frame: Frame, props: dict) -> Frame:
        try:
            tensors = decode_frame_tensors(host_bytes(frame.tensors[0]))
        except ValueError as exc:
            raise ValueError(f"flexbuf: undecodable frame: {exc}") from exc
        if not tensors:
            raise ValueError("flexbuf: empty frame")
        return frame.with_tensors(tensors)
