"""Hand-written CUDA kernels of the port (the counterpart of
``nnstreamer_tpu/ops/pallas``): Python wrappers here, sources in
``nnstreamer_tpu_torch/csrc``."""
