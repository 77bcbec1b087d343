"""Hand-written CUDA kernels of the port (the counterpart of
``nnstreamer_tpu/ops/pallas``): Python wrappers here, sources in
``nnstreamer_tpu_torch/csrc``."""

import threading


class LaunchCounter:
    """Kernel launches since the last :meth:`reset` (thread-safe). Each
    wrapper adds one where it launches its kernel, and nowhere else."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.count = 0

    def add(self) -> None:
        with self._lock:
            self.count += 1

    def reset(self) -> None:
        with self._lock:
            self.count = 0
