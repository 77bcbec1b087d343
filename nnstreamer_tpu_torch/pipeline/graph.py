"""Pipeline graph: build → negotiate → plan (fuse) → execute.

The counterpart of ``nnstreamer_tpu/pipeline/graph.py``:

    Pipeline.add/link (or pipeline/parse.py from a description string)
    → negotiate(): one topological pass propagating TensorsSpec/MediaSpec
    → compile_plan(): FUSE maximal linear chains of TensorOps into one
      torch callable per segment (:class:`FusedSegment`); routing and
      host elements, and ``queue`` (a thread boundary, as in GStreamer),
      get nodes of their own
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
    NegotiationError,
    Routing,
    Spec,
    TensorOp,
)
from nnstreamer_tpu_torch.tensors.frame import Frame


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
    def _toposort(self) -> List[Element]:
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
        if len(order) != len(self.elements):
            cyclic = [e.name for e in self.elements if e not in order]
            raise NegotiationError(f"pipeline has a cycle through {cyclic}")
        return order

    def negotiate(self) -> "Pipeline":
        """One topological pass: propagate specs, validate links (the
        reference's PAUSED-state caps negotiation)."""
        for e in self.elements:
            for n_pads, pads, what in (
                (self.n_sinks(e), [l.dst_pad for l in self.in_links(e)], "sink"),
                (self.n_srcs(e), [l.src_pad for l in self.out_links(e)], "src"),
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
            fusable = e.is_traceable()
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


def _next_free(used) -> int:
    pad = 0
    while pad in used:
        pad += 1
    return pad


class FusedSegment:
    """A maximal linear chain of TensorOps run as ONE callable per frame.

    The frame's tensors move to the pipeline's device once, at the
    segment's entry (:meth:`Frame.to_device`: pinned host memory,
    ``non_blocking``), then every op's fn runs on device tensors under
    ``torch.inference_mode``. A segment with ``fused=False`` holds one
    non-traceable op and calls its ``host_process`` per frame; an op that
    places its frames itself (``DEVICE_PASSTHROUGH``: queue, a converter
    subplugin) gets the frame where it is."""

    def __init__(self, ops: List[TensorOp], device: torch.device, fused: bool = True) -> None:
        self.ops = ops
        self.device = device
        self.fused = fused
        self._fn: Optional[Callable] = None

    @property
    def first(self) -> TensorOp:
        return self.ops[0]

    @property
    def name(self) -> str:
        return "+".join(o.name for o in self.ops)

    def _compose(self) -> Callable:
        fns = [op.make_fn() for op in self.ops]

        def composed(tensors: Tuple) -> Tuple:
            for f in fns:
                tensors = tuple(f(tensors))
            return tensors

        return composed

    def process(self, frame: Frame) -> Union[Frame, List[Frame], None]:
        """The segment's output for one frame: a frame, or for an unfused
        op whatever its ``host_process`` returns (a list, or None)."""
        if not (self.first.DEVICE_PASSTHROUGH and not self.fused):
            frame = frame.to_device(self.device)
        with torch.inference_mode():
            if not self.fused:
                return self.first.host_process(frame)
            if self._fn is None:
                self._fn = self._compose()
            return frame.with_tensors(self._fn(frame.tensors))


@dataclass
class ExecPlan:
    pipeline: Pipeline
    segments: List[FusedSegment]
    seg_of: Dict[Element, FusedSegment]
