"""Per-frame programs and their cache: the port's ``jax.jit`` cache.

One home for the programs of a per-frame function, shared by the fused
segments (:class:`~nnstreamer_tpu_torch.pipeline.graph.FusedSegment`),
the serving plane (:class:`~nnstreamer_tpu_torch.serving_plane.sharding.VmapProgram`)
and the chain program, so all build, capture and run their programs the
same way:

- a program is cached by (signature, batch bucket, fn versions): a new
  shape or dtype, a new bucket, or a same-shape model swap (a ticked fn
  version) makes a new entry from the current fn, so a stale program is
  never served; ``n_traces`` counts the fills;
- a bucket's program is ONE program over a leading axis of B frames:
  ``torch.func.vmap`` of the per-frame fn over the stacked window (the
  reference's ``jax.vmap(composed)``), so a model's convs run at N = B
  and each hand-written kernel on the path launches once a window through
  its op's vmap rule (ops/kernels/). Batched float math may differ from
  the frames' own in the last bits (other conv algorithms at N = B);
  elementwise math is bit for bit. An op that has no batching rule would
  make torch loop over the rows behind the program's back: around every
  batched call torch's vmap fallback warning is on and is an error
  (:func:`vmap_fallback_is_error`), so such an op fails the build. A
  cache made with ``unrolled=True`` (the chain program, as the
  reference's ``_unrolled``) runs the per-frame fn over each row instead,
  bit for bit the frames' own; a window pads to its bucket with replicas
  of its last frame;
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
import warnings
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


#: the message of torch's vmap fallback warning (an op with no batching
#: rule, run row by row)
_FALLBACK_WARNING = ("There is a performance drop because we have not yet implemented the "
                     "batching rule")
_fallback_lock = threading.Lock()
_fallback_depth = 0
_fallback_filter: Optional[tuple] = None


@contextmanager
def vmap_fallback_is_error() -> Iterator[None]:
    """torch's vmap fallback warning on (it is off by default) and raised
    as an error while the block runs: an op with no batching rule fails
    the batched program instead of looping over its rows. The switch and
    the warnings filter are process-wide; nested and concurrent blocks
    share them (the last one out turns them off)."""
    global _fallback_depth, _fallback_filter
    with _fallback_lock:
        if _fallback_depth == 0:
            warnings.filterwarnings("error", message=_FALLBACK_WARNING)
            _fallback_filter = warnings.filters[0]
            torch._C._functorch._set_vmap_fallback_warning_enabled(True)
        _fallback_depth += 1
    try:
        yield
    finally:
        with _fallback_lock:
            _fallback_depth -= 1
            if _fallback_depth == 0:
                torch._C._functorch._set_vmap_fallback_warning_enabled(False)
                if _fallback_filter in warnings.filters:
                    warnings.filters.remove(_fallback_filter)
                    warnings._filters_mutated()
                _fallback_filter = None


#: what torch's vmap raises for a program it cannot batch: an op with no
#: batching rule (the fallback an error), a read of values, a data-dependent
#: shape
_VMAP_REFUSALS = ("vmap:", "vmap fallback", "batching rule", "vmap rule")


def batched(composed: Callable) -> Callable:
    """The batched program of a per-frame fn: stacked columns (each
    tensor index with a leading axis of B frames) → the outputs with the
    same leading axis, as ``torch.func.vmap`` of the fn (in and out dims
    0), with the vmap fallback an error (:func:`vmap_fallback_is_error`).
    A program vmap cannot batch raises
    :class:`~nnstreamer_tpu_torch.pipeline.device_faults.DeviceCompileError`
    (a program that cannot be built: the executor's device circuit takes
    it), never a loop over the rows."""
    vm = torch.func.vmap(lambda *cols: tuple(composed(cols)))

    def program(cols: Tuple) -> Tuple:
        try:
            with vmap_fallback_is_error():
                return tuple(vm(*cols))
        except (UserWarning, RuntimeError) as exc:
            low = str(exc).lower()
            if not any(m in low for m in _VMAP_REFUSALS):
                raise
            from nnstreamer_tpu_torch.pipeline.device_faults import DeviceCompileError

            raise DeviceCompileError(f"the batched program cannot be built: {exc}") from exc

    return program


def sig_of(tensors: Sequence[Any]) -> tuple:
    """A frame's program signature: each tensor's shape and dtype."""
    return tuple((tuple(t.shape), t.dtype) for t in tensors)


class Program:
    """One cache entry: the fn (over one frame's tensors, or with a bucket
    over stacked columns: batched outputs, or for an unrolled cache one
    list entry a row), and on CUDA the graph it
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
    fill's program eager. A failed build raises and leaves no entry.
    ``unrolled`` makes a bucket's program the per-frame fn over each row
    (module docstring) instead of the batched program."""

    def __init__(
        self,
        device: torch.device,
        compose: Callable[[], Callable],
        versions: Callable[[], tuple] = tuple,
        uncapturable: Callable[[], Tuple[str, ...]] = tuple,
        unrolled: bool = False,
    ) -> None:
        self.device = device
        self.unrolled = unrolled
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
            if bucket and self.unrolled:
                def rows(cols: Tuple) -> List[Tuple]:
                    return [tuple(composed(tuple(c[j] for c in cols))) for j in range(bucket)]

                prog = Program(rows)
            elif bucket:
                prog = Program(batched(composed))
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
        ``bucket`` of them) through the bucket's program, one tuple a
        frame: each tensor index stacked on a new leading axis, padded with
        the last frame. A batched program's rows are views of one clone of
        each output."""
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
                outs = prog.fn(tuple(cols))
            return outs[:n] if self.unrolled else _rows_of(outs, n)
        self._replay(prog)
        if self.unrolled:
            return [tuple(o.clone() for o in row) for row in prog.outputs[:n]]
        return _rows_of(tuple(o[:n].clone() for o in prog.outputs), n)

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


def _rows_of(outs: Tuple, n: int) -> List[Tuple]:
    """A batched program's outputs → the first ``n`` rows, one tuple a
    frame."""
    return [tuple(o[j] for o in outs) for j in range(n)]
