"""The device programs a ModelPlane dispatches collected batches to.

The counterpart of ``nnstreamer_tpu/serving_plane/sharding.py``. One
interface: ``invoke(windows) -> outs``, where a window is one frame's
tensor tuple, plus ``invoke_one`` for the heterogeneous/per-frame route.

- :class:`VmapProgram`: ONE device. The cross-stream generalization of
  ``FusedSegment.process_batch``, built on the same program cache
  (pipeline/programs.py): one program per (signature, bucket, fn version)
  over the bucket ladder, ``torch.func.vmap`` of the per-frame fn over the
  stacked window (the reference's ``jax.vmap``), so a dispatch's convs run
  at N = B and each kernel launches once a dispatch; a batched row equals
  ``invoke_one`` of the same frame to float32 rounding (bit for bit where
  the math is elementwise). On CUDA each program is a captured CUDA graph
  and a dispatch is one replay. A device-pinned backend gives its fn through
  its ``plane_fn`` hook, so the plane batches on the pinned device.
- :class:`MeshShardedProgram` (``mode=shard``): N positions of a ``dp``
  mesh (parallel/mesh.py), data-parallel. Its bucket ladder is in
  multiples of the mesh size, so every dispatch divides evenly: a window
  is padded with its last frame to the bucket, cut into the positions'
  contiguous blocks, each block run through its position's own batched
  program on its device, and the rows gathered back in frame order. Rows
  are computed independently, so per-frame parity holds as on one device.
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

Thread safety: a plane's service thread is the only invoker; the
programs keep no locks of their own (the capture lock orders captures).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.pipeline.batching import default_buckets
from nnstreamer_tpu_torch.pipeline.programs import ProgramCache, sig_of

_log = get_logger("serving_plane.sharding")

Window = Tuple[Any, ...]


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


class MeshShardedProgram(VmapProgram):
    """Data-sharded plane program over the ``dp`` axis of ``mesh``: bucket
    ladder in multiples of the mesh size (a 3-frame window on a 4-position
    mesh pads to 4). ``fn`` runs on ``device`` (default: the first
    position's), where the outputs are returned; a position on another
    device runs ``fn_on(its device)``, the model with its weights there. A
    one-frame window runs the per-frame program on ``device``, as the
    reference runs its unsharded per-frame program."""

    mode = "shard"

    def __init__(self, fn: Callable[[Window], Window], mesh, max_batch: int = 8,
                 device=None, fn_on: Optional[Callable[[torch.device], Callable]] = None,
                 capturable: bool = True) -> None:
        positions = mesh.along("dp")
        d = len(positions)
        cap = max(d, ((max(1, int(max_batch)) + d - 1) // d) * d)
        buckets: List[int] = []
        b = d
        while b < cap:
            buckets.append(b)
            b *= 2
        buckets.append(cap)
        device = torch.device(device) if device is not None else positions[0]
        super().__init__(fn, buckets, device, capturable)
        self.mesh = mesh
        self.position_programs: List[VmapProgram] = []
        for dev in positions:
            if dev == device:
                pfn = fn
            elif fn_on is not None:
                pfn = fn_on(dev)
            else:
                raise ValueError(f"plane-mode=shard: no fn for mesh position {dev}")
            self.position_programs.append(VmapProgram(pfn, (), dev, capturable))

    @property
    def n_traces(self) -> int:
        return self.programs.n_traces + sum(p.n_traces for p in self.position_programs)

    def invoke(self, windows: List[Window]) -> List[Window]:
        n = len(windows)
        if n == 1:
            return [self.invoke_one(windows[0])]
        sig = sig_of(windows[0])
        if any(sig_of(w) != sig for w in windows[1:]):
            return [self.invoke_one(w) for w in windows]
        cap = self.buckets[-1]
        if n > cap:
            out: List[Window] = []
            for i in range(0, n, cap):
                out.extend(self.invoke(windows[i:i + cap]))
            return out
        bucket = self.bucket_for(n)
        rows = list(windows) + [windows[-1]] * (bucket - n)
        per = bucket // len(self.position_programs)
        outs: List[Window] = []
        with torch.inference_mode():
            for i, prog in enumerate(self.position_programs):
                block = [tuple(t.to(prog.device, non_blocking=True) for t in w)
                         for w in rows[i * per:(i + 1) * per]]
                outs.extend(prog.programs.run_rows(block, per))
            return [tuple(t.to(self.device) for t in w) for w in outs[:n]]

    def stats(self) -> Dict[str, Any]:
        return {"mode": self.mode, "n_traces": self.n_traces,
                "mesh_devices": int(self.mesh.size)}

    def close(self) -> None:
        super().close()
        for p in self.position_programs:
            p.close()


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
    """The program of one opened backend: on its pinned device through
    its ``plane_fn`` hook where it has one (a pin is a fusion barrier, not
    a batching barrier), else its traceable fn on its device."""
    fn, device = _plane_fn(backend)
    if fn is None:
        return HostProgram(backend)
    return VmapProgram(fn, buckets, device,
                       capturable=bool(getattr(backend, "CAPTURABLE", True)))


def _plane_fn(backend) -> Tuple[Optional[Callable], Any]:
    fn = device = None
    hook = getattr(backend, "plane_fn", None)
    if callable(hook):
        fn, device = hook()
    if fn is None:
        fn = backend.traceable_fn()
    return fn, device if device is not None else backend.props.device


def build_plane_program(backends: Sequence[Any], cfg) -> Any:
    """Back a plane with the program its config asks for.

    ``mode=single``: one backend on its device, batched when it has a
    traceable fn, else a :class:`HostProgram`. ``mode=shard``: one backend
    data-sharded over a ``dp`` mesh of ``cfg.devices`` positions of its
    device's kind (a mesh larger than those raises, naming both counts;
    a host-bound backend is served shared but unsharded, with the
    reference's warning). ``mode=replicas``: one program per opened backend
    (``cfg.devices`` of them) on the cards round-robin, behind
    :class:`ReplicatedProgram`."""
    buckets = default_buckets(cfg.max_batch)
    if cfg.mode == "replicas":
        return ReplicatedProgram([_program_of(b, buckets) for b in backends],
                                 unhealthy_after=cfg.unhealthy_after,
                                 probe_every=cfg.probe_every)
    primary = backends[0]
    if cfg.mode != "shard":
        return _program_of(primary, buckets)
    fn, device = _plane_fn(primary)
    if fn is None:
        _log.warning("plane mode=shard needs a traceable backend; %s is host-bound — "
                     "serving shared-but-unsharded", type(primary).__name__)
        return HostProgram(primary)
    from nnstreamer_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(int(cfg.devices), axes=("dp",), devices=torch.device(device).type)
    if device not in mesh.along("dp"):
        _log.warning("plane mode=shard ignores the stage's device pin: the dp mesh "
                     "governs placement")
    return MeshShardedProgram(fn, mesh, max_batch=cfg.max_batch, device=device,
                              fn_on=getattr(primary, "fn_on", None),
                              capturable=bool(getattr(primary, "CAPTURABLE", True)))
