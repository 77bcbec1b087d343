"""Whole-chain programs: one CUDA graph a window of K frames of a chain.

The counterpart of ``nnstreamer_tpu/pipeline/chain_program.py``. A
:class:`~nnstreamer_tpu_torch.pipeline.graph.Chain` (fused segments joined
by device handoffs across queue / capsfilter) runs by default as one node
a segment, each segment replaying its own graph every frame. At full
frame rates the executor is host-bound, so the chain itself becomes the
compile unit:

- :func:`decide_chain` — the eligibility verdict. Its structural checks
  are the reference's, in the same order and with the same reason
  strings. Its hazard pass runs the SAME walkers as nns-xray
  (analysis/xray.py ``segment_hazard``, analysis/costmodel.py
  ``chain_cost``), so the report and the executor never disagree:

  * NNS-W120: a member op that declared itself uncapturable
    (``CAPTURABLE = False``, the predicate the segment's program cache
    records at each fill), or a segment whose fake-tensor trace reads a
    value on the host — its program could not be one CUDA graph; a
    segment that cannot be traced gets no chain program either, as in
    the reference;
  * NNS-W121: :class:`ChainProgram` keys its programs on every member's
    ``fn_version``, so a same-shape model swap builds a new graph (a test
    pins it); the cache-key walker fires only under micro-batching, which
    the structural checks refuse first, so the hazard pass skips it;
  * NNS-W122: a traced output dtype against the last segment's declared
    static out spec, or float64 appearing with no 64-bit input; checked
    again at the first window a program serves (:class:`ChainHazardError`
    latches the per-node path) where the trace could not see it;
  * NNS-W123 is void: nothing is donated (pipeline/transfer.py);
  * NNS-W124: where ``[plane] memory_per_device`` is set, the chain's
    resident bytes (``chain_cost``: parameters + the peak segment's
    in + out + traced op bytes) must fit it, and the window K is halved
    until ``params + transient × K`` does. Unset (the default), the width
    stands.

- :class:`ChainProgram` — ONE program for the whole chain, on the port's
  program cache (pipeline/programs.py): keyed by (frame signature, window
  bucket, every member op's fn version), on CUDA a CUDA graph captured at
  build. The program runs the member segments' per-frame fns in order for
  each of the K frames of a window, the tensors handed from op to op on
  the device: a literal unroll, so its outputs equal the per-node path's
  bit for bit. Windows pad up to a bucket ladder (1, 2, 4, ..., K) with
  replicas of the last frame (poison under the sanitizer); a trailing
  window at EOS takes a smaller bucket.

The per-node path is the oracle: :meth:`ChainProgram.process_frame_fallback`
serves a frame through each member segment's own program in order, the
same hand-written kernels on the same card. The executor's ``_ChainNode``
latches onto it for a device fault; those graphs are built at their first
use, never at start beside the chain's.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Tuple

import torch

from nnstreamer_tpu_torch.analysis.costmodel import chain_cost, configured_device_bound
from nnstreamer_tpu_torch.pipeline.batching import default_buckets
from nnstreamer_tpu_torch.pipeline.graph import is_plumbing
from nnstreamer_tpu_torch.pipeline.programs import ProgramCache, sig_of
from nnstreamer_tpu_torch.pipeline.transfer import resolve_chain_mode, resolve_chain_unroll


class ChainHazardError(RuntimeError):
    """A hazard found when a chain program first served a window (the
    W122 dtype check): the chain latches its per-node path."""


@dataclass(frozen=True)
class ChainDecision:
    """The compile verdict for one chain.

    ``eligible``: a hazard-free chain of two or more segments that one
    program can serve. ``reason``: the first hazard or setting that
    blocks it. ``mode``: the resolved ``chain-mode``. ``unroll``: frames a
    window, already clamped by the device bound. The executor compiles
    exactly when ``eligible and mode == "auto"``."""

    eligible: bool
    reason: Optional[str]
    mode: str
    unroll: int

    @property
    def compiles(self) -> bool:
        return self.eligible and self.mode == "auto"


def _gate_active(seg) -> bool:
    """Would the executor arm a per-frame error-policy gate for this
    segment (the element must declare ``on-error``)?"""
    pol = seg.fault_policy
    if pol is None or not getattr(pol, "active", False):
        return False
    return "on-error" in type(seg.first).property_schema()


def _interior_external_consumer(plan, chain):
    """An element outside the chain that reads an interior handoff (a
    queue between two members that also feeds a sink): the program keeps
    interior values inside, so such a consumer would starve."""
    pipeline = plan.pipeline
    for a, b in zip(chain.segments, chain.segments[1:]):
        member = {id(op) for op in b.ops}
        frontier = [ln.dst for ln in pipeline.out_links(a.last)]
        seen: set = set()
        while frontier:
            e = frontier.pop()
            if id(e) in seen or id(e) in member:
                continue
            seen.add(id(e))
            if is_plumbing(e) and plan.fused_seg(e) is None:
                frontier.extend(ln.dst for ln in pipeline.out_links(e))
                continue
            return e
    return None


def _interior_external_producer(plan, chain):
    """An element outside the chain that feeds an interior member (two
    branches into one queue): the program serves only the chain head's
    input, so the other producer's frames would be lost."""
    pipeline = plan.pipeline
    member = {id(op) for op in chain.ops}
    for seg in chain.segments[1:]:
        frontier = [ln.src for ln in pipeline.in_links(seg.first)]
        seen: set = set()
        while frontier:
            e = frontier.pop()
            if id(e) in seen or id(e) in member:
                continue
            seen.add(id(e))
            if is_plumbing(e) and plan.fused_seg(e) is None:
                frontier.extend(ln.src for ln in pipeline.in_links(e))
                continue
            return e
    return None


def _hazard(chain, cost, bound) -> Optional[str]:
    """The first W120, W122 or W124 finding that blocks the chain program:
    the nns-xray walkers (module docstring). Identity segments run
    nothing. ``cost`` is the chain's :func:`chain_cost` where a device
    ``bound`` is declared, else None. W121 needs micro-batching, which
    :func:`decide_chain` has refused before this pass."""
    import importlib

    # the analysis package re-exports the xray() FUNCTION under its
    # module's name: resolve the module explicitly
    _x = importlib.import_module("nnstreamer_tpu_torch.analysis.xray")
    for seg in chain.segments:
        hazard = _x.segment_hazard(seg)
        if hazard is not None:
            return hazard
    if cost is not None and cost.resident_bytes > bound:
        return (f"NNS-W124 resident {cost.resident_bytes} B over the "
                f"[plane] memory_per_device bound ({bound} B)")
    return None


def _clamp_unroll(cost, bound, unroll: int) -> int:
    """Halve the window until the chain's whole-window working set
    (``params + transient × K``, analysis/costmodel.py ``chain_cost``)
    fits the declared device bound; no bound declared (``cost`` None) =
    the configured width stands."""
    if cost is None:
        return unroll
    per = max(1, cost.transient_bytes)
    while unroll > 1 and cost.params_bytes + per * unroll > bound:
        unroll //= 2
    return unroll


def decide_chain(plan, chain) -> ChainDecision:
    """The verdict for one chain (:class:`ChainDecision`): the cheap
    structural checks first, then the hazard pass."""
    mode = resolve_chain_mode(chain.ops)
    unroll = resolve_chain_unroll(chain.ops)
    if len(chain.segments) < 2:
        return ChainDecision(
            False, "single segment (the per-node path is already one program)", mode, unroll)
    if os.environ.get("NNS_NO_FUSE", "").lower() in ("1", "true", "yes"):
        return ChainDecision(False, "NNS_NO_FUSE per-element oracle active", mode, unroll)
    for seg in chain.segments:
        cfg = seg.batch_config
        if cfg is not None and getattr(cfg, "active", False):
            return ChainDecision(
                False, f"micro-batching active on segment {seg.name}", mode, unroll)
        if _gate_active(seg):
            return ChainDecision(
                False, f"per-frame error policy active on segment {seg.name}", mode, unroll)
    for op in chain.ops:
        if getattr(op, "qos_sources", None):
            return ChainDecision(False, f"upstream QoS wired through {op.name}", mode, unroll)
    if chain.segments[0]._negotiated_sig() is None and not all(
            seg.is_identity() for seg in chain.segments):
        return ChainDecision(False, "flexible input spec at the chain head", mode, unroll)
    ext = _interior_external_consumer(plan, chain)
    if ext is not None:
        return ChainDecision(
            False, f"interior handoff also feeds {getattr(ext, 'name', ext)} outside the chain",
            mode, unroll)
    ext = _interior_external_producer(plan, chain)
    if ext is not None:
        return ChainDecision(
            False, f"interior segment also fed by {getattr(ext, 'name', ext)} outside the chain",
            mode, unroll)
    try:
        bound = configured_device_bound()
        cost = chain_cost(chain, open_backends=True) if bound is not None else None
        hazard = _hazard(chain, cost, bound)
    except Exception as exc:  # noqa: BLE001 — an analysis failure stays safe
        return ChainDecision(False, f"hazard analysis failed ({exc})", mode, unroll)
    if hazard is not None:
        return ChainDecision(False, hazard, mode, unroll)
    return ChainDecision(True, None, mode, _clamp_unroll(cost, bound, unroll))


def _dtype_ok(got: torch.dtype, want) -> bool:
    """The declared dtype, or the device's wide int64 form of an integer
    spec (tensors/frame.py casts it at the host edge)."""
    return got == want.torch_dtype or (want.is_integer and got == torch.int64)


class ChainProgram:
    """ONE program for a whole chain, a window of up to ``unroll`` frames
    a launch (module docstring)."""

    def __init__(self, chain, unroll: int) -> None:
        self.chain = chain
        self.unroll = max(1, int(unroll))
        self.buckets: Tuple[int, ...] = default_buckets(self.unroll)
        seg0 = chain.segments[0]
        self.device = seg0.device
        self.programs = ProgramCache(
            self.device, self._compose,
            versions=lambda: tuple(op.fn_version for op in chain.ops),
            uncapturable=lambda: tuple(op.name for op in chain.ops if not op.CAPTURABLE),
        )
        # windows that launched the program (one graph replay each on CUDA);
        # single writer: the owning node's thread
        self.launches = 0
        # set by the executor when its sanitizer is on: pad rows are poison
        self.sanitize_poison = False
        self._identity: Optional[bool] = None
        self._checked = False

    @property
    def name(self) -> str:
        return self.chain.name

    @property
    def n_traces(self) -> int:
        return self.programs.n_traces

    @property
    def replays(self) -> int:
        return self.programs.replays

    @property
    def captured(self) -> bool:
        return self.programs.captured

    def is_identity(self) -> bool:
        if self._identity is None:
            self._identity = all(seg.is_identity() for seg in self.chain.segments)
        return self._identity

    def _compose(self) -> Callable:
        """Every member op's CURRENT fn chained, collected anew for each
        cache fill (a reloaded member gives its fresh fn)."""
        fns = [op.make_fn() for op in self.chain.ops]

        def composed(tensors: Tuple) -> Tuple:
            for f in fns:
                tensors = tuple(f(tensors))
            return tensors

        return composed

    def bucket_for(self, n: int) -> int:
        n = min(max(1, n), self.unroll)
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def build(self) -> None:
        """Build the full window's program at the negotiated signature
        (on CUDA its graph is captured here); smaller buckets fill at a
        trickle or at EOS. A failed build raises: the node latches its
        per-node path at start, not mid-stream."""
        if self.is_identity():
            return
        sig = self.chain.segments[0]._negotiated_sig()
        if sig is None:
            return
        self.programs.warm(sig, self.unroll if self.unroll > 1 else 0)

    def _check_outputs(self, outs: Tuple) -> None:
        """NNS-W122 at the first window served: the program's output
        dtypes against the last segment's declared static out spec."""
        self._checked = True
        spec = self.chain.last.out_specs[0] if self.chain.last.out_specs else None
        if spec is None or not getattr(spec, "is_static", False):
            return
        got = [t.dtype for t in outs]
        if len(got) != spec.num_tensors or not all(
                _dtype_ok(g, w.dtype) for g, w in zip(got, spec)):
            raise ChainHazardError(
                f"NNS-W122 in chain {self.name}: outputs {got} against the declared "
                f"{[w.dtype.value for w in spec]}")

    def process_window(self, frames) -> Tuple[List[Any], int, bool]:
        """One window through the program → ``(out_frames, rows,
        launched)``: ``rows`` is the bucket run (pad rows included) and
        ``launched`` is False on the paths that run no program (an
        identity chain; a window of mixed signatures, served per frame
        by the per-node path)."""
        n = len(frames)
        if self.is_identity():
            return list(frames), n, False
        frames = [f.to_device(self.device) for f in frames]
        sig = sig_of(frames[0].tensors)
        if n > 1 and any(sig_of(f.tensors) != sig for f in frames[1:]):
            return [self.process_frame_fallback(f) for f in frames], n, False
        bucket = self.bucket_for(n)
        for seg in self.chain.segments:
            for probe in seg.device_probes():
                probe(bucket)  # the chaos injectors see the padded width
        with torch.inference_mode():
            if bucket == 1:
                outs = [self.programs.run_one(frames[0].tensors)]
            else:
                rows = [f.tensors for f in frames]
                if bucket > n:
                    last = rows[-1]
                    if self.sanitize_poison:
                        from nnstreamer_tpu_torch.pipeline.sanitize import poison_like

                        last = tuple(poison_like(t) for t in last)
                    rows = rows + [last] * (bucket - n)
                outs = self.programs.run_rows(rows, bucket)[:n]
        self.launches += 1
        if not self._checked:
            self._check_outputs(outs[0])
        return [f.with_tensors(o) for f, o in zip(frames, outs)], bucket, True

    # -- the per-node path ---------------------------------------------------
    def process_frame_fallback(self, frame):
        """One frame through each member segment's OWN program in chain
        order: what the member nodes would run, bit for bit."""
        f = frame
        for seg in self.chain.segments:
            f = seg.process(f)
        return f

    def process_frame_eager(self, frame):
        """Each member segment's eager path (its ops' kernels one by one
        on the same device): a chain whose program AND members' programs
        both fault still serves."""
        f = frame
        for seg in self.chain.segments:
            f = seg.process_eager(f)
        return f
