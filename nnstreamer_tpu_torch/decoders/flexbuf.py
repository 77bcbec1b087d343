"""flexbuf decoder subplugin: tensors → serialized flex-tensor bytes.

The counterpart of ``nnstreamer_tpu/decoders/flexbuf.py`` (reference
tensordec-flexbuf.cc), the inverse of the flexbuf converter: one uint8
tensor holding the frame (for filesink or a network sink), each tensor
copied to the host once.
"""

from __future__ import annotations

import numpy as np

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.elements.base import MediaSpec
from nnstreamer_tpu_torch.tensors.frame import Frame
from nnstreamer_tpu_torch.tensors.meta import encode_frame_tensors
from nnstreamer_tpu_torch.tensors.spec import TensorsSpec


@registry.decoder_plugin("flexbuf")
class FlexbufDecoder:
    def negotiate(self, in_spec: TensorsSpec, options: dict) -> MediaSpec:
        return MediaSpec("octet")

    def decode(self, frame: Frame, options: dict) -> Frame:
        blob = encode_frame_tensors(frame.tensors)
        return frame.with_tensors((np.frombuffer(blob, dtype=np.uint8),)).with_meta(
            media_type="octet"
        )
