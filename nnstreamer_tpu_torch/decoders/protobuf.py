"""protobuf decoder subplugin: tensors → a serialized ``Tensors`` message.

The counterpart of ``nnstreamer_tpu/decoders/protobuf.py`` (reference
tensordec-protobuf.cc), the inverse of converters/protobuf.py: one uint8
tensor holding the message, each tensor copied to the host once.
"""

from __future__ import annotations

import numpy as np

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.converters.protobuf import serialize_frame
from nnstreamer_tpu_torch.elements.base import MediaSpec
from nnstreamer_tpu_torch.tensors.frame import Frame
from nnstreamer_tpu_torch.tensors.spec import TensorsSpec


@registry.decoder_plugin("protobuf")
class ProtobufDecoder:
    def __init__(self) -> None:
        self._rate = None

    def negotiate(self, in_spec: TensorsSpec, options: dict) -> MediaSpec:
        self._rate = in_spec.rate  # the stream's rate rides in the wire header
        return MediaSpec("octet")

    def decode(self, frame: Frame, options: dict) -> Frame:
        blob = serialize_frame(frame, rate=self._rate)
        return frame.with_tensors((np.frombuffer(blob, dtype=np.uint8),)).with_meta(
            media_type="octet"
        )
