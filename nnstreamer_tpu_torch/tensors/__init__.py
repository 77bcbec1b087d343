"""Tensor type system: specs, dim strings, frames (the counterpart of
``nnstreamer_tpu/tensors``)."""

from nnstreamer_tpu_torch.tensors.spec import (  # noqa: F401
    DType,
    TensorFormat,
    TensorSpec,
    TensorsSpec,
    NNS_TENSOR_SIZE_LIMIT,
    NNS_TENSOR_RANK_LIMIT,
)
from nnstreamer_tpu_torch.tensors.frame import Frame  # noqa: F401
