"""octet_stream decoder: tensors → raw application/octet-stream bytes.

The counterpart of ``nnstreamer_tpu/decoders/octet_stream.py`` (reference
tensordec-octetstream.c): the raw bytes of every tensor, in order, after
one device-to-host copy of each.
"""

from __future__ import annotations

import numpy as np

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.elements.base import MediaSpec
from nnstreamer_tpu_torch.tensors.frame import Frame
from nnstreamer_tpu_torch.tensors.spec import TensorsSpec


@registry.decoder_plugin("octet_stream")
class OctetStreamDecoder:
    def negotiate(self, in_spec: TensorsSpec, options: dict) -> MediaSpec:
        return MediaSpec("octet")

    def decode(self, frame: Frame, options: dict) -> Frame:
        frame = frame.to_host()
        blob = b"".join(np.ascontiguousarray(t).tobytes() for t in frame.tensors)
        return frame.with_tensors((np.frombuffer(blob, dtype=np.uint8),)).with_meta(
            media_type="octet"
        )
