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

``mode=shard`` over more than one device and ``mode=replicas`` are not
ported: :func:`refuse_unported` raises before any backend opens.

Thread safety: a plane's service thread is the only invoker; the
programs keep no locks of their own (the capture lock orders captures).
"""

from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple

import torch

from nnstreamer_tpu_torch.pipeline.batching import default_buckets
from nnstreamer_tpu_torch.pipeline.programs import ProgramCache, sig_of

Window = Tuple[Any, ...]


def refuse_unported(cfg) -> None:
    """Raise for a plane config the port has no program for, before any
    backend opens: a data-sharded mesh (``shard`` over more than one
    device) and failover replicas."""
    if cfg.mode == "replicas":
        raise NotImplementedError(
            "plane-mode=replicas (failover replicas behind one plane) is not "
            "ported yet (ROADMAP A.6a)"
        )
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


def build_plane_program(backends: Sequence[Any], cfg) -> Any:
    """Back a plane with the program its config asks for.

    ``mode=single``, and ``mode=shard`` over one device (the reference's
    own single-device program for a mesh of one): one backend on its
    device, batched when it has a traceable fn, else a
    :class:`HostProgram`. Other modes raise (:func:`refuse_unported`)."""
    refuse_unported(cfg)
    primary = backends[0]
    fn = primary.traceable_fn()
    if fn is None:
        return HostProgram(primary)
    return VmapProgram(
        fn, default_buckets(cfg.max_batch), primary.props.device,
        capturable=bool(getattr(primary, "CAPTURABLE", True)),
    )
