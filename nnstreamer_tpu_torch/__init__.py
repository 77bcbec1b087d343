"""nnstreamer-tpu on PyTorch and CUDA: the tensor stream pipeline framework
of :mod:`nnstreamer_tpu`, ported to one NVIDIA H100.

The JAX package stays the reference. This package mirrors its module
names (``tensors/spec.py``, ``elements/transform.py``, ...) so each
counterpart is easy to find, and imports neither ``jax`` nor
``nnstreamer_tpu``: what it needs from the reference's jax-free modules is
copied here.

Tensors between elements are ``torch.Tensor``s on one ``torch.device``;
numpy arrays appear only at host edges (sources, sinks). Every entry point
(:class:`~nnstreamer_tpu_torch.pipeline.graph.Pipeline`,
:class:`~nnstreamer_tpu_torch.single.SingleShot`, the model zoo and the
CLI) runs on ``cuda`` unless the caller asks for ``cpu``; with no GPU and
no such request it raises. The TPU kernels on the ported path are CUDA C++
kernels under ``csrc/``, built with ``nvcc`` at first use.
"""

__version__ = "0.1.0"

from nnstreamer_tpu_torch.tensors.spec import (  # noqa: F401
    DType,
    TensorFormat,
    TensorSpec,
    TensorsSpec,
)
from nnstreamer_tpu_torch.tensors.frame import Frame  # noqa: F401

__all__ = [
    "DType",
    "TensorFormat",
    "TensorSpec",
    "TensorsSpec",
    "Frame",
    "__version__",
]
