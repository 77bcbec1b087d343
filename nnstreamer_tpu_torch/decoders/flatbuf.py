"""flatbuf decoder subplugin: tensors → a serialized flatbuffer ``Tensors``.

The counterpart of ``nnstreamer_tpu/decoders/flatbuf.py`` (reference
tensordec-flatbuf.cc), the inverse of converters/flatbuf.py (the codec is
there), each tensor copied to the host once.
"""

from __future__ import annotations

import numpy as np

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.converters.flatbuf import encode_flatbuf
from nnstreamer_tpu_torch.elements.base import MediaSpec
from nnstreamer_tpu_torch.tensors.frame import Frame
from nnstreamer_tpu_torch.tensors.spec import TensorsSpec


@registry.decoder_plugin("flatbuf")
class FlatbufDecoder:
    def __init__(self) -> None:
        self._rate = None

    def negotiate(self, in_spec: TensorsSpec, options: dict) -> MediaSpec:
        self._rate = in_spec.rate  # the stream's rate rides in the wire header
        return MediaSpec("octet")

    def decode(self, frame: Frame, options: dict) -> Frame:
        rate = frame.meta.get("rate") or self._rate
        blob = encode_flatbuf(
            frame.tensors, rate=(rate.numerator, rate.denominator) if rate else None
        )
        return frame.with_tensors((np.frombuffer(blob, dtype=np.uint8),)).with_meta(
            media_type="octet"
        )
