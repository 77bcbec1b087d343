"""Pipeline graph: build → negotiate → plan (fuse) → execute.

The counterpart of ``nnstreamer_tpu/pipeline/graph.py``:

    Pipeline.add/link (or pipeline/parse.py from a description string)
    → negotiate(): one topological pass propagating TensorsSpec/MediaSpec
    → compile_plan(): FUSE maximal linear chains of TensorOps into one
      torch callable per segment (:class:`FusedSegment`); routing and
      host elements, and ``queue`` (a thread boundary, as in GStreamer),
      get nodes of their own
    → chains (:meth:`ExecPlan.chains`): maximal runs of fused segments
      joined by device handoffs across queue / capsfilter plumbing; an
      eligible one runs as ONE program a window of frames
      (pipeline/chain_program.py)
    → Executor (pipeline/executor.py): one thread per node, bounded
      per-pad queues, fan-out to every link of a src pad.

Request pads: an element class with ``N_SINKS``/``N_SRCS`` of ``None``
(tee, mux, demux, ...) takes as many pads as it has links, numbered from 0.

A Pipeline lives on one ``torch.device`` (default ``cuda``; without a GPU
it raises unless ``device="cpu"`` was asked for). Every element added to
it takes that device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch

from nnstreamer_tpu_torch.device import DeviceLike, resolve_device
from nnstreamer_tpu_torch.elements.base import (
    Element,
    MediaSpec,
    NegotiationError,
    Routing,
    Spec,
    TensorOp,
)
from nnstreamer_tpu_torch.pipeline.batching import BatchStats, resolve_batch_config
from nnstreamer_tpu_torch.pipeline.device_faults import resolve_device_policy
from nnstreamer_tpu_torch.pipeline.faults import resolve_fault_policy
from nnstreamer_tpu_torch.pipeline.programs import Program, ProgramCache, sig_of
from nnstreamer_tpu_torch.pipeline.transfer import resolve_ring_depth
from nnstreamer_tpu_torch.tensors.frame import Frame
from nnstreamer_tpu_torch.tensors.spec import TensorsSpec


@dataclass(frozen=True)
class Link:
    src: Element
    src_pad: int
    dst: Element
    dst_pad: int


class Pipeline:
    def __init__(self, name: str = "pipeline", device: DeviceLike = None) -> None:
        self.name = name
        self.device = resolve_device(device)
        self.elements: List[Element] = []
        self.links: List[Link] = []
        self._by_name: Dict[str, Element] = {}
        self._negotiated = False
        self._executor = None

    # -- build -------------------------------------------------------------
    def add(self, *elements: Element) -> "Pipeline":
        for e in elements:
            if e in self.elements:
                continue
            if e.name in self._by_name:
                raise ValueError(f"duplicate element name {e.name!r}")
            e.device = self.device
            self.elements.append(e)
            self._by_name[e.name] = e
        return self

    def __getitem__(self, name: str) -> Element:
        return self._by_name[name]

    def link(
        self,
        src: Element,
        dst: Element,
        src_pad: Optional[int] = None,
        dst_pad: Optional[int] = None,
    ) -> "Pipeline":
        self.add(src, dst)
        if src_pad is None:
            src_pad = _next_free({l.src_pad for l in self.links if l.src is src})
        if dst_pad is None:
            dst_pad = _next_free({l.dst_pad for l in self.links if l.dst is dst})
        for l in self.links:
            if l.src is src and l.src_pad == src_pad:
                raise ValueError(f"{src.name} src pad {src_pad} already linked")
            if l.dst is dst and l.dst_pad == dst_pad:
                raise ValueError(f"{dst.name} sink pad {dst_pad} already linked")
        if src.N_SRCS is not None and src_pad >= src.N_SRCS:
            raise ValueError(f"{src.name} has no src pad {src_pad}")
        if dst.N_SINKS is not None and dst_pad >= dst.N_SINKS:
            raise ValueError(f"{dst.name} has no sink pad {dst_pad}")
        self.links.append(Link(src, src_pad, dst, dst_pad))
        return self

    def chain(self, *elements: Element) -> "Pipeline":
        """Link a linear chain e1 ! e2 ! ... (gst-launch `!`)."""
        for a, b in zip(elements, elements[1:]):
            self.link(a, b)
        return self

    def out_links(self, e: Element) -> List[Link]:
        return sorted((l for l in self.links if l.src is e), key=lambda l: l.src_pad)

    def in_links(self, e: Element) -> List[Link]:
        return sorted((l for l in self.links if l.dst is e), key=lambda l: l.dst_pad)

    def n_srcs(self, e: Element) -> int:
        return e.N_SRCS if e.N_SRCS is not None else len(self.out_links(e))

    def n_sinks(self, e: Element) -> int:
        return e.N_SINKS if e.N_SINKS is not None else len(self.in_links(e))

    # -- negotiation -------------------------------------------------------
    def toposort_partial(self) -> Tuple[List[Element], List[Element]]:
        """Kahn's algorithm: (topological order, leftover). A leftover
        element sits in (or behind) a cycle; the static analyzer reads the
        partial form, negotiate() treats a leftover as fatal."""
        indeg = {e: len(self.in_links(e)) for e in self.elements}
        ready = [e for e in self.elements if indeg[e] == 0]
        order: List[Element] = []
        while ready:
            e = ready.pop(0)
            order.append(e)
            for l in self.out_links(e):
                indeg[l.dst] -= 1
                if indeg[l.dst] == 0:
                    ready.append(l.dst)
        ordered = set(order)
        return order, [e for e in self.elements if e not in ordered]

    def _toposort(self) -> List[Element]:
        order, leftover = self.toposort_partial()
        if leftover:
            raise NegotiationError(f"pipeline has a cycle through {[e.name for e in leftover]}")
        return order

    def negotiate(self) -> "Pipeline":
        """One topological pass: propagate specs, validate links (the
        reference's PAUSED-state caps negotiation)."""
        for e in self.elements:
            src_pads = [l.src_pad for l in self.out_links(e)]
            n_srcs = self.n_srcs(e)
            if e.error_pad is not None and e.error_pad not in src_pads:
                n_srcs = e.error_pad  # an unlinked error pad drops its frames
            for n_pads, pads, what in (
                (self.n_sinks(e), [l.dst_pad for l in self.in_links(e)], "sink"),
                (n_srcs, src_pads, "src"),
            ):
                # every pad linked once; request pads numbered 0..n-1
                if pads != list(range(n_pads)):
                    raise NegotiationError(
                        f"{e.name}: {what} pads {pads} linked, want 0..{n_pads - 1}"
                    )
            if isinstance(e, Routing):
                e.set_pad_counts(self.n_sinks(e), self.n_srcs(e))
        for e in self._toposort():
            in_specs: List[Spec] = [l.src.out_specs[l.src_pad] for l in self.in_links(e)]
            try:
                e.fix_negotiation(in_specs)
            except NegotiationError:
                raise
            except Exception as exc:
                raise NegotiationError(f"{e.name}: {exc}") from exc
            if len(e.out_specs) != self.n_srcs(e):
                raise NegotiationError(
                    f"{e.name}: negotiated {len(e.out_specs)} specs for "
                    f"{self.n_srcs(e)} src pads"
                )
        self._wire_qos()
        self._negotiated = True
        return self

    def _wire_qos(self) -> None:
        """Attach each tensor_rate's drop-ahead hint to its upstream linear
        path, so producers there skip frames the rate limiter would drop.
        The walk stops at fan-in and fan-out (a tee's other branches still
        need the frame) and at any element that is not known to keep
        timestamps 1:1 (filter, transform, queue)."""
        from nnstreamer_tpu_torch.elements.filter import TensorFilter
        from nnstreamer_tpu_torch.elements.flow import Queue
        from nnstreamer_tpu_torch.elements.transform import TensorTransform

        passthrough_timing = (TensorFilter, TensorTransform, Queue)
        for e in self.elements:
            qos = getattr(e, "qos", None)
            if qos is None or not qos.enabled:
                continue
            cur = e
            while True:
                ins = self.in_links(cur)
                if len(ins) != 1:
                    break
                up = ins[0].src
                if len(self.out_links(up)) != 1 or not isinstance(up, passthrough_timing):
                    break
                up.add_qos_source(qos)
                cur = up

    # -- plan: fuse linear TensorOp chains ---------------------------------
    def compile_plan(self) -> "ExecPlan":
        if not self._negotiated:
            self.negotiate()
        seg_of: Dict[Element, FusedSegment] = {}
        segments: List[FusedSegment] = []
        for e in self._toposort():
            if not isinstance(e, TensorOp):
                continue
            # a LINKED error pad is a fusion barrier: routing a failed frame
            # needs a per-frame invoke (an unlinked one costs nothing)
            err_routed = e.error_pad is not None and any(
                l.src_pad == e.error_pad for l in self.out_links(e))
            fusable = not err_routed and e.is_traceable()
            ups = self.in_links(e)
            up = ups[0].src if len(ups) == 1 else None
            prev = seg_of.get(up)
            if (
                fusable and prev is not None and prev.fused
                and len(self.out_links(up)) == 1
            ):
                prev.ops.append(e)
                seg_of[e] = prev
            else:
                seg = FusedSegment([e], self.device, fused=fusable)
                segments.append(seg)
                seg_of[e] = seg
        for seg in segments:
            # a bad batching or fault property fails here, naming the element
            seg.postproc_ops = sum(1 for op in seg.ops if _postproc_op(op))
            seg.batch_config = resolve_batch_config(seg.ops)
            seg.fault_policy = resolve_fault_policy(seg.ops)
            seg.device_policy = resolve_device_policy(seg.ops)
            # a fused segment's frame ring takes [executor] ring_depth; a
            # host-path op keeps delivering each frame at once unless it
            # sets ring-depth itself (its invoke cannot overlap itself)
            if seg.fused or seg.first.get_property("ring-depth") is not None:
                seg.ring_depth = resolve_ring_depth(seg.ops)
            for op in seg.ops:
                op.batch_stats = seg.batch_stats
        return ExecPlan(self, segments, seg_of)

    # -- run ---------------------------------------------------------------
    def start(self):
        from nnstreamer_tpu_torch.pipeline.executor import Executor

        if self._executor is not None:
            raise RuntimeError(
                f"pipeline {self.name!r} already started; build a fresh "
                "Pipeline to run again"
            )
        self._executor = Executor(self.compile_plan())
        self._executor.start()
        return self._executor

    def run(self, timeout: Optional[float] = None):
        """Start, wait for EOS (or error), stop. Returns the executor.
        Raises the first element error, or TimeoutError if ``timeout``
        elapses before EOS."""
        ex = self.start()
        completed = ex.wait(timeout)
        ex.stop()
        if ex.errors:
            raise ex.errors[0]
        if not completed:
            raise TimeoutError(
                f"pipeline {self.name!r} did not reach EOS within {timeout}s"
            )
        return ex

    def stop(self) -> None:
        if self._executor is not None:
            self._executor.stop()

    def dump_dot(self, diagnostics=None, specs=None) -> str:
        """Graphviz dump of the elements (factory, name and first
        negotiated src spec) and links (src pad → sink pad), as the
        reference's ``Pipeline.dump_dot`` writes it. ``diagnostics``:
        nns-lint findings painted on their nodes (red = error, orange =
        warning, codes added to the label; pipeline-level codes become the
        graph label). ``specs``: {element name: out specs} shown instead of
        the element's own (nns-lint's dry-run negotiation)."""
        by_elem: Dict[str, list] = {}
        graph_level: List[str] = []
        for d in diagnostics or ():
            if d.element is None:
                graph_level.append(d.code)
            else:
                by_elem.setdefault(d.element, []).append(d)
        lines = [f'digraph "{self.name}" {{', "  rankdir=LR;"]
        if graph_level:
            lines.append(f'  label="{" ".join(sorted(set(graph_level)))}";')
        for e in self.elements:
            out = (specs or {}).get(e.name) or e.out_specs
            spec = f"\\n{out[0]}" if out and out[0] is not None else ""
            style = ""
            diags = by_elem.get(e.name)
            if diags:
                spec += "\\n" + " ".join(sorted({d.code for d in diags}))
                worst = "red" if any(d.severity.value == "error" for d in diags) else "orange"
                style = f', style=filled, fillcolor="{worst}"'
            lines.append(
                f'  "{e.name}" [label="{e.FACTORY_NAME}\\n{e.name}{spec}", shape=box{style}];')
        for l in self.links:
            lines.append(f'  "{l.src.name}" -> "{l.dst.name}" [label="{l.src_pad}→{l.dst_pad}"];')
        lines.append("}")
        return "\n".join(lines)


def _postproc_op(op: TensorOp) -> bool:
    """A member op that is fused pre- or post-processing rather than a
    model invoke: a decoder in a segment (only traceable ones get there),
    an image-mode transform, a normalizing converter. The executor counts
    a segment's frames in ``nns_fused_postproc_total`` when it has one."""
    from nnstreamer_tpu_torch.elements.converter import TensorConverter
    from nnstreamer_tpu_torch.elements.decoder import TensorDecoder
    from nnstreamer_tpu_torch.elements.transform import TensorTransform

    if isinstance(op, TensorDecoder):
        return True
    if isinstance(op, TensorTransform):
        return op.mode in ("resize", "crop-resize")
    if isinstance(op, TensorConverter):
        return getattr(op, "input_norm", None) is not None
    return False


def _next_free(used) -> int:
    pad = 0
    while pad in used:
        pad += 1
    return pad


class FusedSegment:
    """A maximal linear chain of TensorOps run as ONE program per frame.

    The frame's tensors move to the pipeline's device once, at the
    segment's entry (:meth:`Frame.to_device`: pinned host memory,
    ``non_blocking``). A segment with ``fused=False`` holds one
    non-traceable op and calls its ``host_process`` per frame; an op that
    places its frames itself (``DEVICE_PASSTHROUGH``: queue, a converter
    subplugin) gets the frame where it is.

    A fused segment's programs (pipeline/programs.py) are cached by
    (signature, batch bucket, op fn versions), the reference's ``jax.jit``
    cache: a new shape or dtype
    (renegotiation), a new bucket, or a same-shape model swap
    (``reload_model`` ticks the op's ``fn_version``) makes a new entry from
    the ops' current fns, so a stale program is never served;
    ``n_traces`` counts the fills. On CUDA each entry is a CUDA graph: the
    composed fn runs once eagerly on a side stream (the kernels' build and
    load, cuDNN's algorithm choice, the allocator, constants an op makes
    on first use), then is captured, and every frame copies its tensors
    into the graph's input buffers and replays it. Outputs are cloned out
    of the graph's pool, so a frame still in flight downstream is never
    overwritten by the next replay. A segment with an op that declares
    ``CAPTURABLE = False`` runs its composed fn eagerly on CUDA instead; on
    the CPU every program is the composed fn, under the same cache.
    """

    def __init__(self, ops: List[TensorOp], device: torch.device, fused: bool = True) -> None:
        self.ops = ops
        self.device = device
        self.fused = fused
        # (sig, bucket, fn versions) -> program; bucket 0 = one frame. The
        # ops that declared CAPTURABLE = False are read at each fill, with
        # the ops' fns just made: on CUDA they keep the programs eager
        self.programs = ProgramCache(
            device, self._compose,
            versions=lambda: tuple(op.fn_version for op in self.ops),
            uncapturable=lambda: tuple(op.name for op in self.ops if not op.CAPTURABLE),
        )
        self._eager: Optional[Tuple[tuple, Callable]] = None
        self._identity: Optional[bool] = None
        self._host_fn: Optional[Callable] = None  # process_host's composed ops
        self._probes: Optional[list] = None
        # micro-batching (pipeline/batching.py), resolved at plan time;
        # the stats are shared with the ops so tensor_filter can show them
        self.batch_config = None
        self.batch_stats = BatchStats()
        # the error policy (pipeline/faults.py) and the device-resilience
        # policy (pipeline/device_faults.py), resolved at plan time from
        # the ops' properties; the executor builds the node's fault gate,
        # device circuit and OOM governor from them
        self.fault_policy = None
        self.device_policy = None
        # the in-flight frame ring's depth (pipeline/transfer.py), resolved
        # at plan time; pad rows as poison under the sanitizer
        # (pipeline/sanitize.py)
        self.ring_depth = 1
        self.sanitize_poison = False
        # fused pre/post-processing ops (decode, image ops, normalize),
        # counted at plan time for nns_fused_postproc_total
        self.postproc_ops = 0

    @property
    def first(self) -> TensorOp:
        return self.ops[0]

    @property
    def last(self) -> TensorOp:
        return self.ops[-1]

    @property
    def name(self) -> str:
        return "+".join(o.name for o in self.ops)

    @property
    def captured(self) -> bool:
        """True when a program that was filled is a CUDA graph."""
        return self.programs.captured

    @property
    def n_traces(self) -> int:
        return self.programs.n_traces

    @property
    def warmup_launches(self) -> int:
        return self.programs.warmup_launches

    @property
    def build_s(self) -> float:
        return self.programs.build_s

    @property
    def uncapturable(self) -> Tuple[str, ...]:
        return self.programs.uncapturable

    def _compose(self) -> Callable:
        """The ops' CURRENT fns chained (collected anew for each cache
        fill, so a renegotiated or reloaded op gives its fresh fn)."""
        fns = [op.make_fn() for op in self.ops]

        def composed(tensors: Tuple) -> Tuple:
            for f in fns:
                tensors = tuple(f(tensors))
            return tensors

        return composed

    def is_identity(self) -> bool:
        """True when every op declares is_identity(): :meth:`process` then
        hands the frame on without running a program."""
        if self._identity is None:
            self._identity = all(op.is_identity() for op in self.ops)
        return self._identity

    def _negotiated_sig(self) -> Optional[tuple]:
        """The signature the first frame will have, from the negotiated
        input spec: a static tensor spec, or a raw video frame [H, W, C]
        uint8 of known size. None = fill on the first frame."""
        spec = self.first.in_specs[0] if self.first.in_specs else None
        if isinstance(spec, TensorsSpec):
            if not spec.is_static:
                return None
            return tuple((tuple(t.shape), t.dtype.torch_dtype) for t in spec)
        if (
            isinstance(spec, MediaSpec) and spec.media_type == "video"
            and spec.width is not None and spec.height is not None
        ):
            return (((spec.height, spec.width, spec.channels_per_pixel), torch.uint8),)
        return None

    def build(self) -> Optional[Program]:
        """Fill the per-frame program of the negotiated signature before
        the first frame (the PAUSED state's negotiated program); with
        batching active also the max-batch bucket. Other keys (a small
        bucket at EOS, a renegotiation) fill on the node's thread when they
        first come."""
        prog = self.build_frame()
        self.build_batched()
        return prog

    def build_frame(self) -> Optional[Program]:
        """The per-frame program of the negotiated signature (on CUDA its
        graph is captured here)."""
        sig = self._build_sig()
        return None if sig is None else self.programs.program_for(sig)

    def build_batched(self) -> Optional[Program]:
        """With batching active, build and warm the max-batch bucket, the
        program of steady state under load (the reference warms it on
        zeros at build)."""
        cfg = self.batch_config
        sig = self._build_sig()
        if sig is None or cfg is None or not cfg.active:
            return None
        return self.programs.warm(sig, cfg.buckets[-1])

    def _build_sig(self) -> Optional[tuple]:
        if not self.fused or self.is_identity():
            return None
        return self._negotiated_sig()

    def device_probes(self) -> list:
        """The ops' backends' ``device_probe(rows)`` hooks (the ``faulty``
        fake declares one; real backends do not, so this is [])."""
        if self._probes is None:
            self._probes = [
                hook for op in self.ops
                for hook in (getattr(getattr(op, "backend", None), "device_probe", None),)
                if hook is not None
            ]
        return self._probes

    def is_layout_only(self) -> bool:
        """True when every op only re-views its tensors (``is_layout_only``,
        which an identity op is): :meth:`process_host` can then run the
        segment on a host frame."""
        return self.fused and all(op.is_layout_only() for op in self.ops)

    def process_host(self, frame: Frame) -> Frame:
        """A layout-only segment's output computed on the frame where it is
        (host arrays stay host arrays, as views): for a segment whose
        consumers read host bytes, nothing crosses the card."""
        if self._host_fn is None:
            self._host_fn = self._compose()
        return frame.with_tensors(self._host_fn(frame.tensors))

    def process(self, frame: Frame) -> Union[Frame, List[Frame], None]:
        """The segment's output for one frame: a frame, or for an unfused
        op whatever its ``host_process`` returns (a list, or None)."""
        if not (self.first.DEVICE_PASSTHROUGH and not self.fused):
            frame = frame.to_device(self.device)
        with torch.inference_mode():
            if not self.fused:
                return self.first.host_process(frame)
            if self.is_identity():
                return frame
            return frame.with_tensors(self.programs.run_one(frame.tensors))

    def process_eager(self, frame: Frame) -> Frame:
        """The composed ops run eagerly on the segment's device, never
        captured: the oracle a replay is held against, and the path the
        device circuit (pipeline/device_faults.py) serves while the
        segment's graphs cannot be built. The ops' hand-written kernels
        launch here one by one, as in the warm-up; semantics identical to
        :meth:`process`."""
        versions = tuple(op.fn_version for op in self.ops)
        if self._eager is None or self._eager[0] != versions:
            self._eager = (versions, self._compose())
        frame = frame.to_device(self.device)
        with torch.inference_mode():
            return frame.with_tensors(self._eager[1](frame.tensors))

    def process_batch(self, frames: List[Frame], cfg) -> Tuple[List[Frame], int]:
        """ONE program for a window of frames → (output frames in order,
        rows run).

        Stacks each tensor index on a new leading axis and pads up to the
        window's bucket with replicas of the last frame (rows computed and
        discarded: the price of a bounded program count), then runs the
        bucket's batched program, ``torch.func.vmap`` of the composed ops
        (pipeline/programs.py; the reference's ``jax.vmap(composed)``): the
        convs at N = bucket, each kernel once a window. On CUDA the window
        is one replay. A program that vmap cannot batch raises as a failed
        build (the device circuit's), never a loop over the rows. A window
        of mixed signatures runs per frame. An unfused op takes the window
        through ``host_process_batch``."""
        n = len(frames)
        if not self.fused:
            if not self.first.DEVICE_PASSTHROUGH:
                frames = [f.to_device(self.device) for f in frames]
            with torch.inference_mode():
                return self.first.host_process_batch(frames), n
        if self.is_identity():
            return [self.process(f) for f in frames], n
        frames = [f.to_device(self.device) for f in frames]
        sig = sig_of(frames[0].tensors)
        if any(sig_of(f.tensors) != sig for f in frames[1:]):
            return [self.process(f) for f in frames], n
        bucket = cfg.bucket_for(n)
        # the device's capacity boundary (the chaos injectors): probed with
        # the PADDED bucket, the width the program allocates
        for probe in self.device_probes():
            probe(bucket)
        rows = [f.tensors for f in frames]
        if self.sanitize_poison and bucket > n:
            # the sanitizer's pad rows are poison, so a split off by one
            # shows as garbage, never as a plausible replica
            from nnstreamer_tpu_torch.pipeline.sanitize import poison_like

            rows = rows + [tuple(poison_like(t) for t in rows[-1])] * (bucket - n)
        with torch.inference_mode():
            outs = self.programs.run_rows(rows, bucket)[:n]
        return [f.with_tensors(o) for f, o in zip(frames, outs)], bucket


def is_plumbing(e: Element) -> bool:
    """queue and capsfilter: elements that never read tensor bytes, so a
    device handoff rides through them untouched (the class declares
    ``DEVICE_PASSTHROUGH``; a converter subplugin sets it on its instance
    and parses bytes, so it is no plumbing)."""
    return bool(getattr(type(e), "DEVICE_PASSTHROUGH", False))


@dataclass
class Chain:
    """One compile unit: a maximal run of fused segments joined by device
    handoffs. An eligible chain of two or more under ``[executor]
    chain_mode=auto`` runs as ONE program a window of frames
    (pipeline/chain_program.py ``decide_chain`` / ``ChainProgram``);
    anything else runs each segment as its own program, the per-node
    path that the chain is held against."""

    segments: List[FusedSegment]

    @property
    def first(self) -> TensorOp:
        return self.segments[0].first

    @property
    def last(self) -> TensorOp:
        return self.segments[-1].last

    @property
    def name(self) -> str:
        return " => ".join(s.name for s in self.segments)

    @property
    def ops(self) -> List[TensorOp]:
        return [op for s in self.segments for op in s.ops]


@dataclass
class ExecPlan:
    pipeline: Pipeline
    segments: List[FusedSegment]
    seg_of: Dict[Element, FusedSegment]

    def fused_seg(self, e: Element) -> Optional[FusedSegment]:
        seg = self.seg_of.get(e)
        return seg if seg is not None and seg.fused else None

    def _device_successor(self, seg: FusedSegment) -> Optional[FusedSegment]:
        """The one fused segment ``seg`` hands its frames to on the
        device: reachable from ``seg.last`` across only plumbing (queue,
        capsfilter). Anything else on the way (a host-path op, routing, a
        tee's fan-out, a sink) ends the chain, as does reaching two
        different segments."""
        frontier = [l.dst for l in self.pipeline.out_links(seg.last)]
        seen: set = set()
        hit: Optional[FusedSegment] = None
        while frontier:
            e = frontier.pop()
            if id(e) in seen:
                continue
            seen.add(id(e))
            s2 = self.fused_seg(e)
            if s2 is not None and s2 is not seg:
                if hit is not None and hit is not s2:
                    return None
                hit = s2
            elif s2 is None and is_plumbing(e):
                frontier.extend(l.dst for l in self.pipeline.out_links(e))
        return hit

    def chains(self) -> List[Chain]:
        """The compile units (:class:`Chain`) in plan order: every fused
        segment lands in exactly one; a pipeline with no host hop between
        its segments is one chain end to end."""
        fused = [s for s in self.segments if s.fused]
        next_of: Dict[int, FusedSegment] = {}
        has_prev: set = set()
        for seg in fused:
            succ = self._device_successor(seg)
            if succ is not None:
                next_of[id(seg)] = succ
                has_prev.add(id(succ))
        out: List[Chain] = []
        for seg in fused:
            if id(seg) in has_prev:
                continue
            run = [seg]
            while id(run[-1]) in next_of:
                nxt = next_of[id(run[-1])]
                if any(s is nxt for s in run):  # a cycle guard
                    break
                run.append(nxt)
            out.append(Chain(segments=run))
        return out
