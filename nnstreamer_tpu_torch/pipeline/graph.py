"""Pipeline graph: build → negotiate → plan (fuse) → execute.

The counterpart of ``nnstreamer_tpu/pipeline/graph.py``:

    Pipeline.add/link (or pipeline/parse.py from a description string)
    → negotiate(): one topological pass propagating TensorsSpec/MediaSpec
    → compile_plan(): FUSE maximal linear chains of TensorOps into one
      torch callable per segment (:class:`FusedSegment`)
    → Executor (pipeline/executor.py): one thread per node, bounded queues.

A Pipeline lives on one ``torch.device`` (default ``cuda``; without a GPU
it raises unless ``device="cpu"`` was asked for). Every element added to
it takes that device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from nnstreamer_tpu_torch.device import DeviceLike, resolve_device
from nnstreamer_tpu_torch.elements.base import (
    Element,
    NegotiationError,
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
            src_pad = len(self.out_links(src))
        if dst_pad is None:
            dst_pad = len(self.in_links(dst))
        for l in self.links:
            if l.src is src and l.src_pad == src_pad:
                raise ValueError(f"{src.name} src pad {src_pad} already linked")
            if l.dst is dst and l.dst_pad == dst_pad:
                raise ValueError(f"{dst.name} sink pad {dst_pad} already linked")
        if src_pad >= src.N_SRCS:
            raise ValueError(f"{src.name} has no src pad {src_pad}")
        if dst_pad >= dst.N_SINKS:
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
            for n_pads, links, what in (
                (e.N_SINKS, self.in_links(e), "sink"),
                (e.N_SRCS, self.out_links(e), "src"),
            ):
                if len(links) != n_pads:
                    raise NegotiationError(
                        f"{e.name}: {len(links)}/{n_pads} {what} pads linked"
                    )
        for e in self._toposort():
            in_specs: List[Spec] = [l.src.out_specs[l.src_pad] for l in self.in_links(e)]
            try:
                e.fix_negotiation(in_specs)
            except NegotiationError:
                raise
            except Exception as exc:
                raise NegotiationError(f"{e.name}: {exc}") from exc
        self._negotiated = True
        return self

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
            up = ups[0].src if ups else None
            prev = seg_of.get(up)
            if fusable and prev is not None and prev.fused:
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


class FusedSegment:
    """A maximal linear chain of TensorOps run as ONE callable per frame.

    The frame's tensors move to the pipeline's device once, at the
    segment's entry (:meth:`Frame.to_device`: pinned host memory,
    ``non_blocking``), then every op's fn runs on device tensors under
    ``torch.inference_mode``. A segment with ``fused=False`` holds one
    non-traceable op and calls its ``host_process`` per frame."""

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

    def process(self, frame: Frame) -> Frame:
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
