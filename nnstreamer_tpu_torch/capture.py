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
    addresses stay fixed for the graph's life. A failure raises; no caller
    falls back to eager execution. The capture is thread-local, so other
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
                finally:
                    graph.capture_end()
            finally:
                if gc_on:
                    gc.enable()
    cur.wait_stream(side)
    return Captured(graph, outputs, dict(tally), sum(warm.values()), time.perf_counter() - t0)


#: CUDA-graph replays in the process (each one ``cudaGraphLaunch``), all owners
graph_replays = LaunchCounter()


def replay(graph: "torch.cuda.CUDAGraph", launches: Dict[LaunchCounter, int]) -> None:
    """Run a captured graph on the current stream and add the launches
    its capture recorded to their counters (and one to ``graph_replays``)."""
    graph.replay()
    graph_replays.add()
    for counter, n in launches.items():
        counter.add(n)
