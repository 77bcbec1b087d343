"""The device programs a ModelPlane dispatches collected batches to.

The counterpart of the single-device half of
``nnstreamer_tpu/serving_plane/sharding.py``. One interface:
``invoke(windows) -> outs``, where a window is one frame's tensor tuple,
plus ``invoke_one`` for the heterogeneous/per-frame route.

- :class:`VmapProgram`: ONE device. The cross-stream generalization of
  ``FusedSegment.process_batch``, built on the same program cache
  (pipeline/programs.py): one program per (signature, bucket, fn version)
  over the bucket ladder, the per-frame fn run over each row of the
  stacked window, so a batched row is bitwise equal to ``invoke_one`` of
  the same frame. On CUDA each program is a captured CUDA graph and a
  dispatch is one replay.
- :class:`HostProgram`: for a backend with no traceable fn (a host
  script). The plane still shares ONE opened backend across all streams;
  batching goes through the backend's own ``invoke_batched`` when it
  declared ``batchable``, else per frame.
- :class:`ReplicatedProgram` (``mode=replicas``): one program per opened
  backend, round-robin over the visible cards (on one card every replica
  is on ``cuda:0``, each with its own captured programs), behind a
  ``ReplicaSet`` (parallel/replicas.py): a window on a replica that faults
  re-dispatches whole onto the next healthy one, so per-stream FIFO
  survives a replica loss.

``mode=shard`` over more than one device is not ported:
:func:`refuse_unported` raises before any backend opens.

Thread safety: a plane's service thread is the only invoker; the
programs keep no locks of their own (the capture lock orders captures).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch

from nnstreamer_tpu_torch.pipeline.batching import default_buckets
from nnstreamer_tpu_torch.pipeline.programs import ProgramCache, sig_of

Window = Tuple[Any, ...]


def refuse_unported(cfg) -> None:
    """Raise for a plane config the port has no program for, before any
    backend opens: a data-sharded mesh (``shard`` over more than one
    device)."""
    if cfg.mode == "shard" and cfg.devices > 1:
        raise NotImplementedError(
            f"plane-mode=shard over plane-devices={cfg.devices} (a data-sharded "
            "mesh) is not ported yet (ROADMAP A.8)"
        )


class VmapProgram:
    """The per-frame ``fn`` batched over a bucket ladder on ``device``.

    ``fn`` is the backend's traceable fn: ``(tensors tuple) -> tensors
    tuple`` over device tensors. ``capturable`` False (a backend that
    declared ``CAPTURABLE = False``) keeps its programs eager on CUDA.
    ``n_traces`` counts cache fills, so tests bound the programs at one a
    (signature, bucket), the FusedSegment contract."""

    mode = "single"

    def __init__(
        self,
        fn: Callable[[Window], Window],
        buckets: Sequence[int],
        device: torch.device,
        capturable: bool = True,
    ) -> None:
        self.buckets = tuple(buckets)
        self.device = torch.device(device)
        self.programs = ProgramCache(
            self.device, lambda: fn,
            uncapturable=lambda: () if capturable else ("plane",),
        )

    @property
    def n_traces(self) -> int:
        return self.programs.n_traces

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def invoke_one(self, window: Window) -> Window:
        with torch.inference_mode():
            return tuple(self.programs.run_one(window))

    def invoke(self, windows: List[Window]) -> List[Window]:
        n = len(windows)
        if n == 1:
            return [self.invoke_one(windows[0])]
        sig = sig_of(windows[0])
        if any(sig_of(w) != sig for w in windows[1:]):
            # heterogeneous batch (flexible streams): per-frame programs,
            # identical semantics (the FusedSegment parity rule)
            return [self.invoke_one(w) for w in windows]
        cap = self.buckets[-1]
        if n > cap:
            # a batch wider than the top bucket (one oversized window)
            # chunks to the ladder instead of computing a negative pad
            out: List[Window] = []
            for i in range(0, n, cap):
                out.extend(self.invoke(windows[i:i + cap]))
            return out
        with torch.inference_mode():
            return self.programs.run_rows(windows, self.bucket_for(n))

    def close(self) -> None:
        self.programs.clear()


class HostProgram:
    """Per-frame (or host-batched) dispatch for backends with no
    traceable fn: the plane still shares ONE opened backend across all
    streams (the memory win survives), but device batching is the
    backend's own ``invoke_batched`` (when it declared ``batchable``) or
    a per-frame loop."""

    mode = "host"

    def __init__(self, backend) -> None:
        self._backend = backend
        self.n_traces = 0

    def invoke_one(self, window: Window) -> Window:
        return tuple(self._backend.invoke(window))

    def invoke(self, windows: List[Window]) -> List[Window]:
        b = self._backend
        if getattr(b, "batchable", False) and len(windows) > 1:
            sig = sig_of(windows[0])
            if all(sig_of(w) == sig for w in windows[1:]):
                return [tuple(o) for o in b.invoke_batched(windows)]
        return [self.invoke_one(w) for w in windows]

    def close(self) -> None:
        pass


class ReplicatedProgram:
    """K per-replica programs behind a ReplicaSet: load-balanced window
    dispatch with device-fault failover. Failover granularity is one
    collected batch: a batch on a dying replica re-dispatches WHOLE onto
    the next healthy one, frames in order."""

    mode = "replicas"

    def __init__(self, programs: Sequence[Any], unhealthy_after: int = 3,
                 probe_every: int = 64) -> None:
        from nnstreamer_tpu_torch.parallel.replicas import ReplicaSet

        self.programs = list(programs)
        self._rs = ReplicaSet([self._on_device(p) for p in self.programs],
                              unhealthy_after=unhealthy_after, probe_every=probe_every)

    @staticmethod
    def _on_device(prog) -> Callable[[List[Window]], List[Window]]:
        """``prog.invoke`` with the windows moved to its replica's device
        first (a no-op where every replica shares the frames' card)."""
        dev = getattr(prog, "device", None)
        if dev is None:
            return prog.invoke

        def invoke(windows: List[Window]) -> List[Window]:
            return prog.invoke([tuple(t.to(dev) for t in w) for w in windows])

        return invoke

    def invoke(self, windows: List[Window]) -> List[Window]:
        return self._rs.dispatch(windows)

    def invoke_one(self, window: Window) -> Window:
        return self._rs.dispatch([window])[0]

    @property
    def n_traces(self) -> int:
        return sum(getattr(p, "n_traces", 0) for p in self.programs)

    def replica_stats(self) -> Dict[str, Any]:
        return self._rs.stats()

    def close(self) -> None:
        for p in self.programs:
            p.close()


def _program_of(backend, buckets) -> Any:
    """The program of one opened backend, on the backend's device."""
    fn = backend.traceable_fn()
    if fn is None:
        return HostProgram(backend)
    return VmapProgram(fn, buckets, backend.props.device,
                       capturable=bool(getattr(backend, "CAPTURABLE", True)))


def build_plane_program(backends: Sequence[Any], cfg) -> Any:
    """Back a plane with the program its config asks for.

    ``mode=single``, and ``mode=shard`` over one device (the reference's
    own single-device program for a mesh of one): one backend on its
    device, batched when it has a traceable fn, else a
    :class:`HostProgram`. ``mode=replicas``: one program per opened backend
    (``cfg.devices`` of them) on the cards round-robin, behind
    :class:`ReplicatedProgram`. A sharded mesh raises
    (:func:`refuse_unported`)."""
    refuse_unported(cfg)
    buckets = default_buckets(cfg.max_batch)
    if cfg.mode == "replicas":
        return ReplicatedProgram([_program_of(b, buckets) for b in backends],
                                 unhealthy_after=cfg.unhealthy_after,
                                 probe_every=cfg.probe_every)
    return _program_of(backends[0], buckets)
