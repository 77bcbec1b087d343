"""Hand-written CUDA kernels of the port (the counterpart of
``nnstreamer_tpu/ops/pallas``): Python wrappers here, sources in
``nnstreamer_tpu_torch/csrc``."""

import threading
from contextlib import contextmanager
from typing import Dict, Iterator

_local = threading.local()


class LaunchCounter:
    """Kernel launches since the last :meth:`reset` (thread-safe). Each
    wrapper adds one where it launches its kernel, and nowhere else.

    A wrapper called while its thread builds a CUDA graph (inside
    :func:`launch_tally`) records nothing on the device, so its add goes
    to the tally instead; the graph's owner adds the tally back at every
    replay (:meth:`add` with ``n``), which is when the kernels run."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.count = 0

    def add(self, n: int = 1) -> None:
        tally = getattr(_local, "tally", None)
        if tally is not None:
            tally[self] = tally.get(self, 0) + n
            return
        with self._lock:
            self.count += n

    def reset(self) -> None:
        with self._lock:
            self.count = 0


@contextmanager
def launch_tally() -> Iterator[Dict[LaunchCounter, int]]:
    """Count this thread's launches into the yielded dict (counter → adds)
    instead of into the counters, for the duration of the block."""
    prev = getattr(_local, "tally", None)
    _local.tally = tally = {}
    try:
        yield tally
    finally:
        _local.tally = prev
