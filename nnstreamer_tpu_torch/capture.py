"""CUDA-graph capture, shared by the fused segments and the serving engine.

The port's counterpart of ``jax.jit``'s compiled program: a function over
tensors with fixed addresses runs once eagerly (the warm-up: kernel builds
and loads, cuDNN's and cuBLAS's algorithm choices, the allocator, constants
made on first use), then is captured into a CUDA graph that each call
replays. Both owners, :class:`~nnstreamer_tpu_torch.pipeline.graph.FusedSegment`
and the serving engine's pumps (``models/serving.py``), go through
:func:`capture`, so one process-wide lock orders every capture: the LLM
element pumps on its own thread while the pipeline's segments capture on
theirs.

Kernel launch counters (:class:`~nnstreamer_tpu_torch.ops.kernels.LaunchCounter`)
count what runs on the device: the warm-up's launches are kept apart, the
capture's are recorded as the tally that :func:`replay` adds back each
time the graph runs.

A capture that fails raises the fn's own exception (never a secondary
error of ``capture_end``), with the capture lock released, the partial
graph and its pool allocations dropped and the caller's stream ordered
after the side stream, so the next eager call runs as before. What a
failed build means for a stream is the executor's decision, not this
module's: with ``device-fallback`` on (the default, as in the reference),
the device circuit (pipeline/device_faults.py) runs the segment's ops
eagerly **on the same device** while the graph cannot be built, each such
frame counted (``eager_invokes``), and probes the build again. The eager
path launches the same hand-written kernels one by one; it is a counted,
user-set recovery policy of the executor, not a kernel fallback: kernel
wrappers still dispatch by device alone and raise on failure, and nothing
ever runs a kernel's plain version or moves a frame to the CPU in its
place.
"""

from __future__ import annotations

import gc
import threading
import time
from typing import Any, Callable, Dict, NamedTuple

import torch

from nnstreamer_tpu_torch.ops.kernels import LaunchCounter, launch_tally

# One capture at a time in the process: a capture on one thread while
# another captures would tie their allocations together.
CAPTURE_LOCK = threading.Lock()


class Captured(NamedTuple):
    """A captured program: the graph, the outputs it writes (in its pool),
    the launches one replay stands for, the warm-up's launches and the
    host seconds of warm-up and capture."""

    graph: "torch.cuda.CUDAGraph"
    outputs: Any
    launches: Dict[LaunchCounter, int]
    warmup_launches: int
    build_s: float


def capture(fn: Callable[[], Any], device: torch.device, pool=None) -> Captured:
    """Warm ``fn`` up once on a side stream, then capture it into a CUDA
    graph. ``fn`` takes no arguments: it reads and writes tensors whose
    addresses stay fixed for the graph's life. A failure raises the fn's
    own exception (module docstring). The capture is thread-local, so other
    threads may go on launching on the card meanwhile; Python's garbage
    collector is off while capturing, since a collection could free
    another graph on this thread, a call that invalidates the capture.

    ``pool`` (a ``torch.cuda.graph_pool_handle()``) lets graphs share one
    memory pool: a later capture reuses what earlier ones freed (their
    intermediates), never their live outputs. So a graph's outputs may lie
    where another graph of the pool keeps intermediates: the owner replays
    one graph of a pool at a time, reads its outputs before the next
    replay, and keeps all state that outlives a replay in buffers made
    outside the captures."""
    t0 = time.perf_counter()
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(cur)
    graph = torch.cuda.CUDAGraph()
    try:
        with CAPTURE_LOCK, torch.cuda.stream(side), torch.inference_mode():
            with launch_tally() as warm:
                fn()
            with launch_tally() as tally:
                gc_on = gc.isenabled()
                gc.disable()
                try:
                    graph.capture_begin(pool=pool, capture_error_mode="thread_local")
                    try:
                        outputs = fn()
                    except BaseException:
                        _end_failed_capture(graph)
                        raise
                    graph.capture_end()
                finally:
                    if gc_on:
                        gc.enable()
    except BaseException:
        # the partial graph's pool goes with it: a probe that builds again
        # starts from a clean pool
        try:
            graph.reset()
        except Exception:  # noqa: BLE001 — the build's own error is the verdict
            pass
        raise
    finally:
        cur.wait_stream(side)
    return Captured(graph, outputs, dict(tally), sum(warm.values()), time.perf_counter() - t0)


def _end_failed_capture(graph: "torch.cuda.CUDAGraph") -> None:
    """End a capture whose fn raised. ``capture_end`` then reports the
    invalidated capture with an error of its own, which would mask the
    fn's: it is dropped here, and the caller re-raises the fn's."""
    try:
        graph.capture_end()
    except Exception:  # noqa: BLE001 — secondary to the fn's exception
        pass


#: CUDA-graph replays in the process (each one ``cudaGraphLaunch``), all owners
graph_replays = LaunchCounter()


def replay(graph: "torch.cuda.CUDAGraph", launches: Dict[LaunchCounter, int]) -> None:
    """Run a captured graph on the current stream and add the launches
    its capture recorded to their counters (and one to ``graph_replays``)."""
    graph.replay()
    graph_replays.add()
    for counter, n in launches.items():
        counter.add(n)
