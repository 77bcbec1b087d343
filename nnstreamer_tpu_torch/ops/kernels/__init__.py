"""Hand-written CUDA kernels of the port (the counterpart of
``nnstreamer_tpu/ops/pallas``): Python wrappers here, sources in
``nnstreamer_tpu_torch/csrc``."""

import threading
from contextlib import contextmanager
from typing import Dict, Iterable, Iterator

_local = threading.local()


class LaunchCounter:
    """Kernel launches since the last :meth:`reset` (thread-safe). Each
    wrapper adds one where it launches its kernel, and nowhere else.

    A wrapper called while its thread builds a CUDA graph (inside
    :func:`launch_tally`) records nothing on the device, so its add goes
    to the tally instead; the graph's owner adds the tally back at every
    replay (:meth:`add` with ``n``), which is when the kernels run.

    Each add is also kept by the thread that made it, so that servers
    sharing a process can read their own launches (:meth:`count_on`)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.count = 0
        self._by_thread: Dict[threading.Thread, int] = {}

    def add(self, n: int = 1) -> None:
        tally = getattr(_local, "tally", None)
        if tally is not None:
            tally[self] = tally.get(self, 0) + n
            return
        me = threading.current_thread()
        with self._lock:
            self.count += n
            self._by_thread[me] = self._by_thread.get(me, 0) + n

    def reset(self) -> None:
        with self._lock:
            self.count = 0
            self._by_thread.clear()

    def count_on(self, threads: Iterable[threading.Thread]) -> int:
        """Launches added on these threads since the last reset."""
        with self._lock:
            return sum(self._by_thread.get(t, 0) for t in threads)


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
