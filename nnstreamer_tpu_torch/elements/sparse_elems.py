"""tensor_sparse_enc / tensor_sparse_dec: static ↔ sparse stream format.

The counterpart of ``nnstreamer_tpu/elements/sparse_elems.py``, the same
bytes. Reference: gsttensor_sparseenc.c / gsttensor_sparsedec.c /
gsttensor_sparseutil.c — COO wire compression for sparse tensors (header +
nnz values + uint32 flat indices). Encode/decode run on the host (it is a
wire format for files/network, not a compute format), like the reference.
"""

from __future__ import annotations

from typing import List

import numpy as np

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.elements.base import HostElement, NegotiationError, PropSpec, Spec
from nnstreamer_tpu_torch.tensors.frame import Frame, host_array
from nnstreamer_tpu_torch.tensors.sparse import sparse_decode, sparse_encode
from nnstreamer_tpu_torch.tensors.spec import TensorFormat, TensorsSpec


@registry.element("tensor_sparse_enc")
class TensorSparseEnc(HostElement):
    FACTORY_NAME = "tensor_sparse_enc"

    def negotiate(self, in_specs: List[Spec]) -> List[Spec]:
        (spec,) = in_specs
        if not isinstance(spec, TensorsSpec) or spec.format is not TensorFormat.STATIC:
            raise NegotiationError(f"{self.name}: needs static tensor input")
        return [TensorsSpec(format=TensorFormat.SPARSE, rate=spec.rate)]

    def process(self, frame: Frame) -> Frame:
        encoded = tuple(
            np.frombuffer(bytearray(sparse_encode(host_array(t))), dtype=np.uint8)
            for t in frame.tensors
        )
        return frame.with_tensors(encoded)


@registry.element("tensor_sparse_dec")
class TensorSparseDec(HostElement):
    FACTORY_NAME = "tensor_sparse_dec"

    PROPERTIES = {
        "dimensions": PropSpec("str", None, desc="declared dense out dims"),
        "types": PropSpec("str", "float32"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.dims = self.get_property("dimensions")
        self.types = self.get_property("types", "float32")

    def negotiate(self, in_specs: List[Spec]) -> List[Spec]:
        (spec,) = in_specs
        if not isinstance(spec, TensorsSpec) or spec.format is not TensorFormat.SPARSE:
            raise NegotiationError(f"{self.name}: needs sparse input")
        if self.dims:
            out = TensorsSpec.from_strings(str(self.dims), str(self.types))
            return [out.with_rate(spec.rate)]
        # sparse chunks are self-describing; without declared dims the
        # output is flexible (per-frame shapes)
        return [TensorsSpec(format=TensorFormat.FLEXIBLE, rate=spec.rate)]

    def process(self, frame: Frame) -> Frame:
        tensors = []
        for t in frame.tensors:
            dense, _ = sparse_decode(host_array(t).tobytes())
            tensors.append(dense)
        return frame.with_tensors(tensors)
