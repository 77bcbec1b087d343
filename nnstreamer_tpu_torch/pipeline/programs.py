"""Per-frame programs and their cache: the port's ``jax.jit`` cache.

One home for the programs of a per-frame function, shared by the fused
segments (:class:`~nnstreamer_tpu_torch.pipeline.graph.FusedSegment`) and
the serving plane (:class:`~nnstreamer_tpu_torch.serving_plane.sharding.VmapProgram`),
so both build, capture and run their programs the same way:

- a program is cached by (signature, batch bucket, fn versions): a new
  shape or dtype, a new bucket, or a same-shape model swap (a ticked fn
  version) makes a new entry from the current fn, so a stale program is
  never served; ``n_traces`` counts the fills;
- a bucket's program runs the per-frame fn over each row of the stacked
  window, so every row runs the per-frame kernels at the per-frame shapes
  and a window's outputs equal the frames' own bit for bit; a window pads
  to its bucket with replicas of its last frame;
- on CUDA each entry is a CUDA graph (:func:`~nnstreamer_tpu_torch.capture.capture`:
  an eager warm-up on a side stream, then the capture, under the
  process-wide capture lock), and a call copies its tensors into the
  graph's input buffers, replays it and clones the outputs out of the
  graph's pool, so a result still in use is never overwritten by the next
  replay. A fn that declared itself uncapturable runs eagerly on CUDA; on
  the CPU every program is the fn itself;
- a program whose build raises (its warm-up or its capture) leaves no
  entry, so the next call builds it again, and the build's own exception
  reaches the caller. The executor's device circuit
  (pipeline/device_faults.py) decides what a failed build means for the
  stream; the cache itself never runs anything in a program's place.

:func:`current_build` tells a fn whether it runs inside a program build,
and which one: on CUDA a graph's warm-up and capture, where the program is
the fn itself (the CPU, an uncapturable fn) each program call. The
``faulty`` fake's ``compile_fail`` reads it, so a broken build is
injectable on both devices with the same circuit transitions.
"""

from __future__ import annotations

import itertools
import threading
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from nnstreamer_tpu_torch.capture import capture, replay

_build_state = threading.local()
_build_ids = itertools.count(1)


def current_build() -> Optional[int]:
    """The id of the program build this thread is inside, or None (an
    eager call, a graph replay)."""
    return getattr(_build_state, "build", None)


@contextmanager
def _building() -> Iterator[None]:
    prev = getattr(_build_state, "build", None)
    _build_state.build = next(_build_ids)
    try:
        yield
    finally:
        _build_state.build = prev


def sig_of(tensors: Sequence[Any]) -> tuple:
    """A frame's program signature: each tensor's shape and dtype."""
    return tuple((tuple(t.shape), t.dtype) for t in tensors)


class Program:
    """One cache entry: the fn (over one frame's tensors, or with a bucket
    over stacked columns, one list entry a row), and on CUDA the graph it
    was captured into, with its static input buffers, its outputs in the
    graph's pool and the launch counts
    (:class:`~nnstreamer_tpu_torch.ops.kernels.LaunchCounter`) one replay
    stands for."""

    __slots__ = ("fn", "graph", "inputs", "outputs", "launches")

    def __init__(self, fn: Callable) -> None:
        self.fn = fn
        self.graph: Optional["torch.cuda.CUDAGraph"] = None
        self.inputs: Tuple[torch.Tensor, ...] = ()
        self.outputs = None
        self.launches: Dict = {}


class ProgramCache:
    """The programs of one per-frame fn on ``device``.

    ``compose()`` gives the CURRENT per-frame fn (called anew at each
    fill), ``versions()`` the fn versions that key the cache, and
    ``uncapturable()`` the names of the parts that declared
    ``CAPTURABLE = False``, recorded at each fill: on CUDA they keep the
    fill's program eager. A failed build raises and leaves no entry."""

    def __init__(
        self,
        device: torch.device,
        compose: Callable[[], Callable],
        versions: Callable[[], tuple] = tuple,
        uncapturable: Callable[[], Tuple[str, ...]] = tuple,
    ) -> None:
        self.device = device
        self._compose = compose
        self._versions = versions
        self._uncapturable = uncapturable
        self._cache: Dict[tuple, Program] = {}
        self._last: Optional[Tuple[tuple, Program]] = None
        self.n_traces = 0
        # build work, kept apart: the warm-ups' kernel launches (out of the
        # launch counters, which count the launches that serve frames) and
        # the host seconds of warm-up and capture
        self.warmup_launches = 0
        self.build_s = 0.0
        self.uncapturable: Tuple[str, ...] = ()
        self.replays = 0  # graph replays served (one a call on CUDA)

    @property
    def captured(self) -> bool:
        """True when a program that was filled is a CUDA graph."""
        return any(p.graph is not None for p in self._cache.values())

    def program_for(self, sig: tuple, bucket: int = 0) -> Program:
        key = (sig, bucket, self._versions())
        last = self._last
        if last is not None and last[0] == key:
            return last[1]
        prog = self._cache.get(key)
        if prog is None:
            composed = self._compose()
            if bucket:
                def rows(cols: Tuple) -> List[Tuple]:
                    return [tuple(composed(tuple(c[j] for c in cols))) for j in range(bucket)]

                prog = Program(rows)
            else:
                prog = Program(lambda tensors: tuple(composed(tensors)))
            self.uncapturable = tuple(self._uncapturable())
            if self.device.type == "cuda" and not self.uncapturable:
                self._capture(prog, sig, bucket)
            self._cache[key] = prog
            self.n_traces += 1
        self._last = (key, prog)
        return prog

    def _capture(self, prog: Program, sig: tuple, bucket: int) -> None:
        """Capture ``prog.fn`` over zeroed static input buffers."""
        inputs = tuple(
            torch.zeros(((bucket,) + shape) if bucket else shape, dtype=dtype, device=self.device)
            for shape, dtype in sig
        )
        with _building():
            cap = capture(lambda: prog.fn(inputs), self.device)
        self.warmup_launches += cap.warmup_launches
        self.build_s += cap.build_s
        prog.graph, prog.inputs, prog.outputs = cap.graph, inputs, cap.outputs
        prog.launches = cap.launches

    def _replay(self, prog: Program) -> None:
        replay(prog.graph, prog.launches)
        self.replays += 1

    def run_one(self, tensors: Sequence[Any]) -> Tuple[Any, ...]:
        """One frame's outputs through its signature's per-frame program."""
        prog = self.program_for(sig_of(tensors))
        if prog.graph is None:
            with _building():
                return prog.fn(tuple(tensors))
        for dst, src in zip(prog.inputs, tensors):
            dst.copy_(src)
        self._replay(prog)
        return tuple(o.clone() for o in prog.outputs)

    def run_rows(self, windows: Sequence[Sequence[Any]], bucket: int) -> List[Tuple[Any, ...]]:
        """The outputs of ``windows`` (frames of one signature, at most
        ``bucket`` of them) through the bucket's program: each tensor index
        stacked on a new leading axis, padded with the last frame."""
        n = len(windows)
        sig = sig_of(windows[0])
        prog = self.program_for(sig, bucket)
        cols = []
        for i in range(len(sig)):
            rows = [w[i] for w in windows]
            rows.extend([rows[-1]] * (bucket - n))
            if prog.graph is None:
                cols.append(torch.stack(rows))
            else:
                torch.stack(rows, out=prog.inputs[i])
        if prog.graph is None:
            with _building():
                return prog.fn(tuple(cols))[:n]
        self._replay(prog)
        return [tuple(o.clone() for o in row) for row in prog.outputs[:n]]

    def warm(self, sig: tuple, bucket: int = 0) -> Program:
        """Build the program of ``(sig, bucket)`` and, where a program is the
        fn itself, run it once on zeros: the counterpart of the reference's
        warm-up call, so a build that fails fails here on both devices."""
        prog = self.program_for(sig, bucket)
        if prog.graph is None:
            zeros = tuple(
                torch.zeros(((bucket,) + shape) if bucket else shape, dtype=dtype,
                            device=self.device)
                for shape, dtype in sig)
            with _building():
                prog.fn(zeros)
        return prog

    def clear(self) -> None:
        """Drop every program (and the graphs' pools with them)."""
        self._cache.clear()
        self._last = None
