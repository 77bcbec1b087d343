"""Shared static byte and cost estimates for placement, nns-xray and nns-kscope.

The counterpart of ``nnstreamer_tpu/analysis/costmodel.py``: one home for
every "how many bytes" question the static tooling asks, so the placement
planner (serving_plane/placement.py), the chain program
(pipeline/chain_program.py), the chain analyzer (analysis/xray.py) and the
kernel analyzer (analysis/kernels.py) cannot drift apart:

- :func:`parse_bytes` / :func:`params_bytes` / :func:`spec_bytes` /
  :func:`estimate_backend_bytes` / :func:`estimate_stage_bytes` — a
  stage's resident bytes: its weights (a torch module's parameters and
  buffers) plus one in-flight set of input and output activations.
- :func:`trace_program` — a program's ops traced under
  ``torch._subclasses.FakeTensorMode``: each aten op's output dtype and
  bytes, nothing allocated and no kernel launched. Every real tensor the
  program closes over (a model's weights on the card) and every device
  argument is taken to the CPU first, so the kernels' wrappers, which
  dispatch by device, take their plain versions and a fake tensor never
  reaches a launch. An op that reads values (``.item()``, numpy) raises
  under fake mode: the trace records it as a host read.
- :func:`plan_transfer_boundaries` / :func:`predict_frame_transfers` —
  the static mirror of the port's executor: which links move frame bytes
  across the host boundary and how many a frame, so the transfer tally
  has a prediction to be checked against
  (``Executor.transfer_crosscheck``).
- :func:`chain_cost` — per-chain params / activation / transient bytes
  over :meth:`ExecPlan.chains` compile units.
- :class:`KernelCost` and :data:`H100` — a kernel launch's roofline row.

Everything here is arithmetic over negotiated specs, module weights and
fake tensors: nothing is allocated on the device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from nnstreamer_tpu_torch.log import get_logger

_log = get_logger("analysis.costmodel")


def parse_bytes(raw: str) -> int:
    """``"256M"`` → 268435456 (K/M/G binary suffixes; plain ints pass
    through)."""
    s = str(raw).strip()
    if not s:
        raise ValueError("empty byte size")
    mult = 1
    suffix = s[-1].upper()
    if suffix in ("K", "M", "G"):
        mult = {"K": 1 << 10, "M": 1 << 20, "G": 1 << 30}[suffix]
        s = s[:-1]
    return int(float(s) * mult)


def _leaves(tree: Any):
    if isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def params_bytes(tree: Any) -> int:
    """Total bytes of a model's weights: a torch module's parameters and
    buffers, or the tensors and arrays of a nested dict / list."""
    total = 0
    for leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        elif getattr(leaf, "shape", None) is not None:
            dtype = np.dtype(getattr(leaf, "dtype", np.float32))
            total += int(np.prod(leaf.shape, dtype=np.int64)) * dtype.itemsize
    return total


_VIDEO_CHANNELS = {"RGB": 3, "BGR": 3, "RGBA": 4, "BGRA": 4, "GRAY8": 1}


def spec_bytes(spec: Any) -> int:
    """Activation bytes of a TensorsSpec (0 for flexible/None specs). A
    video MediaSpec (a source feeding tensor_converter) is width x height x
    channels."""
    if spec is None:
        return 0
    if getattr(spec, "media_type", None) == "video":
        w = getattr(spec, "width", None)
        h = getattr(spec, "height", None)
        if not w or not h:
            return 0
        return int(w) * int(h) * _VIDEO_CHANNELS.get(getattr(spec, "format", "RGB"), 3)
    if not getattr(spec, "is_static", False):
        return 0
    return sum(int(np.prod(t.shape, dtype=np.int64)) * np.dtype(t.dtype.np_dtype).itemsize
               for t in spec)


def estimate_backend_bytes(backend: Any) -> int:
    """Resident bytes an opened backend will hold on its device: its
    module's weights plus one in-flight set of input/output activations."""
    total = params_bytes(getattr(backend, "module", None))
    try:
        in_spec, out_spec = backend.get_model_info()
    except Exception:  # noqa: BLE001 — shape-polymorphic: activations unknown
        return total
    return total + spec_bytes(in_spec) + spec_bytes(out_spec)


def estimate_stage_bytes(elem: Any) -> int:
    """Per-stage estimate for a tensor_filter element (opens the backend it
    will serve with anyway: no throwaway copy)."""
    return estimate_backend_bytes(elem._ensure_open())


def configured_device_bound() -> Optional[int]:
    """The per-device memory bound of the placement planner: ``[plane]
    memory_per_device`` (bytes, K/M/G suffixes). None: no bound declared."""
    from nnstreamer_tpu_torch.config import conf

    raw = conf().get("plane", "memory_per_device", "")
    if not raw:
        return None
    try:
        return parse_bytes(raw)
    except ValueError:
        _log.warning("[plane] memory_per_device=%r is not a byte size; no bound", raw)
        return None


# -- fake-tensor program traces ---------------------------------------------

@dataclass
class ProgramTrace:
    """What :func:`trace_program` saw: every aten op's (name, output
    dtype, output bytes, whether the output derives from the program's
    inputs — a constant built from host numbers does not), the program's
    output dtypes and bytes, and the first host read (an op that needs
    values: the program cannot be captured into a CUDA graph), or None."""

    ops: List[Tuple[str, torch.dtype, int, bool]] = field(default_factory=list)
    out_dtypes: Tuple[torch.dtype, ...] = ()
    out_bytes: int = 0
    host_read: Optional[str] = None
    #: why the trace stopped short with no hazard: a kernel's plain
    #: version (ops/kernels/) read values, which its kernel never does on
    #: the card (K2's greedy loop); the ops before it are recorded
    partial: str = ""

    @property
    def intermediate_bytes(self) -> int:
        """Bytes of every op output computed from the inputs (a constant
        built from host numbers is made once and kept, not a per-call
        working set)."""
        return sum(op[2] for op in self.ops if op[3])


def _fake_classes():
    from torch._subclasses.fake_tensor import (
        DataDependentOutputException,
        DynamicOutputShapeException,
        FakeTensor,
        FakeTensorMode,
    )
    from torch.utils._python_dispatch import TorchDispatchMode

    return (FakeTensor, FakeTensorMode, TorchDispatchMode,
            (DataDependentOutputException, DynamicOutputShapeException))


def trace_program(fn: Callable, sig) -> ProgramTrace:
    """Trace ``fn(tensors)`` (a fused segment's composed program: a tuple
    of tensors in, a tuple out) at the signature ``sig`` (``((shape,
    dtype), ...)``) on fake CPU tensors (module docstring). Raises what
    the trace raises, except an op that reads values, which ends the trace
    as :attr:`ProgramTrace.host_read`."""
    from torch.utils._pytree import tree_flatten, tree_map

    FakeTensor, FakeTensorMode, TorchDispatchMode, data_dependent = _fake_classes()
    cpu = torch.device("cpu")
    trace = ProgramTrace()
    held: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
    data: Dict[int, torch.Tensor] = {}  # id -> every tensor derived from the inputs

    class _ToCpu(TorchDispatchMode):
        """Every real tensor (a weight, a constant the program made
        earlier) becomes a fake CPU tensor of its shape, stride and dtype,
        every device argument the CPU; each op's outputs are recorded."""

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            def conv(x):
                if isinstance(x, torch.device):
                    return cpu
                if isinstance(x, torch.Tensor) and not isinstance(x, FakeTensor):
                    got = held.get(id(x))
                    if got is None:
                        fake = torch.empty_strided(tuple(x.shape), tuple(x.stride()),
                                                   dtype=x.dtype, device=cpu)
                        got = held[id(x)] = (x, fake)  # x kept: its id stays unique
                    return got[1]
                return x

            args, kwargs = tree_map(conv, (tuple(args), dict(kwargs or {})))
            if "device" in kwargs and kwargs["device"] is not None:
                kwargs["device"] = cpu
            try:
                out = func(*args, **kwargs)
            except data_dependent:
                if trace.host_read is None:
                    trace.host_read = str(func)
                raise
            derived = any(id(a) in data for a in tree_flatten((args, kwargs))[0]
                          if isinstance(a, torch.Tensor))
            for t in tree_flatten(out)[0]:
                if isinstance(t, torch.Tensor):
                    trace.ops.append((str(func), t.dtype, t.numel() * t.element_size(), derived))
                    if derived:
                        data[id(t)] = t
            return out

    with torch.no_grad(), FakeTensorMode(allow_non_fake_inputs=True):
        ins = tuple(torch.empty(tuple(shape), dtype=dtype, device=cpu) for shape, dtype in sig)
        data.update((id(t), t) for t in ins)
        try:
            with _ToCpu():
                outs = tuple(fn(ins))
        except data_dependent as exc:
            where = _kernel_plain_frame(exc)
            if where is not None:
                trace.partial = (f"trace stopped in {where} (a kernel's plain version "
                                 "reads values; the kernel on the card does not)")
                trace.host_read = None
            return trace
        except (RuntimeError, TypeError) as exc:
            # numpy on a fake tensor: a read of values outside aten
            if trace.host_read is None and "numpy" in str(exc).lower():
                trace.host_read = f"numpy() ({exc})"
                return trace
            raise
    trace.out_dtypes = tuple(t.dtype for t in outs)
    trace.out_bytes = sum(t.numel() * t.element_size() for t in outs)
    return trace


def _kernel_plain_frame(exc: BaseException) -> Optional[str]:
    """``module.function`` of the innermost frame of ``exc``'s traceback
    that lies in the kernels' package (ops/kernels/), or None."""
    import os
    import traceback

    kdir = os.path.join("nnstreamer_tpu_torch", "ops", "kernels") + os.sep
    hit = None
    for fr in traceback.extract_tb(exc.__traceback__):
        if kdir in fr.filename:
            hit = f"{os.path.basename(fr.filename)[:-3]}.{fr.name}"
    return hit


def segment_trace(seg) -> Optional[ProgramTrace]:
    """:func:`trace_program` of a fused segment's composed program at its
    negotiated per-frame signature; None when the signature is flexible or
    the segment is not fused. Cached on the segment per op fn versions."""
    if not getattr(seg, "fused", False):
        return None
    sig = seg._negotiated_sig()
    if sig is None:
        return None
    key = (sig, tuple(op.fn_version for op in seg.ops))
    cached = getattr(seg, "_xray_trace", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    tr = trace_program(seg._compose(), sig)
    seg._xray_trace = (key, tr)
    return tr


# -- static transfer prediction ---------------------------------------------
#
# The port's executor (pipeline/executor.py) counts bytes in the transfer
# tally (pipeline/transfer.py) at three places: a node's frame ring starts
# ONE coalesced D2H a frame when every consumer of its pad 0 reads host
# bytes (``_Node._out_wants_host``: a ``WANTS_HOST`` element, or a
# converter subplugin); a sink that reads bytes fetches a frame that still
# holds torch tensors; and on a GPU a per-frame fused segment or a
# compiled chain stages a host frame up. A torch tensor counts as the
# device side on either device, so D2H is counted on the CPU too; staging
# on the CPU moves nothing. The functions below re-derive those decisions
# from the plan, so a run's tally has a prediction.

@dataclass(frozen=True)
class TransferBoundary:
    """One link where frame bytes cross the host boundary."""

    producer: str        # element whose output crosses
    consumer: str        # element(s) whose node triggers the crossing
    direction: str       # "h2d" | "d2h"
    bytes_per_frame: int
    reason: str          # producer-fetch | sink-fetch | stage

    @property
    def node(self) -> str:
        """The element whose executor node moves the bytes (a fetch at
        the producer's ring, else the consumer's own node)."""
        return self.producer if self.reason == "producer-fetch" else self.consumer


def _trace_or_none(seg) -> Optional[ProgramTrace]:
    try:
        return segment_trace(seg)
    except Exception:  # noqa: BLE001 — no trace: the spec's bytes stand
        return None


class _Flow:
    """The executor's nodes over a plan, and what kind of frames each
    element hands on: (torch tensors?, bytes a frame)."""

    def __init__(self, plan) -> None:
        from nnstreamer_tpu_torch.pipeline.chain_program import decide_chain
        from nnstreamer_tpu_torch.pipeline.graph import is_plumbing

        self.plan = plan
        self.pipeline = p = plan.pipeline
        self.head: Dict[int, Any] = {}   # id(element) -> the element heading its node
        self.chain_of: Dict[int, Any] = {}
        for chain in plan.chains():
            try:
                compiles = decide_chain(plan, chain).compiles
            except Exception:  # noqa: BLE001 — the executor would raise at build
                compiles = False
            if not compiles:
                continue
            members = list(chain.ops)
            ids = {id(op) for op in members}
            for seg in chain.segments[:-1]:
                frontier = [l.dst for l in p.out_links(seg.last)]
                while frontier:
                    e = frontier.pop()
                    if id(e) in ids:
                        continue
                    if is_plumbing(e) and plan.fused_seg(e) is None:
                        ids.add(id(e))
                        members.append(e)
                        frontier.extend(l.dst for l in p.out_links(e))
            for e in members:
                self.head[id(e)] = chain.first
                self.chain_of[id(e)] = chain
        for e in p.elements:
            if id(e) in self.head:
                continue
            seg = plan.seg_of.get(e)
            self.head[id(e)] = seg.first if seg is not None else e
        self.memo: Dict[Tuple[int, int], Tuple[bool, int]] = {}

    # -- node structure ------------------------------------------------------
    def same_node(self, a, b) -> bool:
        return self.head[id(a)] is self.head[id(b)]

    def consumers(self, e, pad: int = 0) -> List[Any]:
        """The heads of the nodes that get ``e``'s frames on ``pad`` (the
        executor's ``outs[pad]``), links inside one node left out."""
        return [self.head[id(l.dst)] for l in self.pipeline.out_links(e)
                if l.src_pad == pad and not self.same_node(e, l.dst)]

    def wants_host(self, e) -> bool:
        """``_Node._out_wants_host`` for the node whose output ``e`` is."""
        from nnstreamer_tpu_torch.pipeline.graph import is_plumbing

        cons = self.consumers(e)
        if not cons:
            return False
        for c in cons:
            if getattr(type(c), "WANTS_HOST", False):
                continue
            seg = self.plan.seg_of.get(c)
            if (seg is not None and not seg.fused and id(c) not in self.chain_of
                    and getattr(c, "DEVICE_PASSTHROUGH", False) and not is_plumbing(c)):
                continue
            return False
        return True

    def _batched(self, seg) -> bool:
        cfg = seg.batch_config
        return bool(cfg is not None and getattr(cfg, "active", False)
                    and (seg.fused or seg.first.is_batch_capable()))

    def runs_on_host(self, seg) -> bool:
        return (not self._batched(seg) and seg.is_layout_only()
                and self.wants_host(seg.last))

    def stages(self, e) -> bool:
        """Does ``e``'s node stage each host frame up through the tally?"""
        if self.plan.pipeline.device.type != "cuda":
            return False
        chain = self.chain_of.get(id(e))
        if chain is not None:
            return e is chain.first and not all(s.is_identity() for s in chain.segments)
        seg = self.plan.seg_of.get(e)
        if seg is None or e is not seg.first or not seg.fused:
            return False
        return not (self._batched(seg) or getattr(seg.first, "plane", "")
                    or self.runs_on_host(seg))

    def ring_fetches(self, e) -> bool:
        """Does the node whose output ``e`` is fetch each frame on its
        ring (``_FrameRing.to_host``)?"""
        from nnstreamer_tpu_torch.pipeline.graph import is_plumbing

        chain = self.chain_of.get(id(e))
        if chain is not None:
            return e is chain.last and self.wants_host(e)
        seg = self.plan.seg_of.get(e)
        if seg is None or e is not seg.last:
            return False
        if not seg.fused and getattr(seg.first, "plane", ""):
            return False  # the plane's ticket ring delivers as it is
        if not self.wants_host(e):
            return False
        return seg.fused or is_plumbing(seg.first)

    # -- what flows ----------------------------------------------------------
    def inputs(self, e) -> Tuple[bool, int]:
        """(any input frame holds torch tensors, bytes of pad 0's input)."""
        ins = self.pipeline.in_links(e)
        got = [self.out(l.src, l.src_pad) for l in ins]
        dev = any(d for d, _ in got)
        return dev, (got[0][1] if got else 0)

    def out(self, e, pad: int = 0) -> Tuple[bool, int]:
        """(frames ``e`` hands on over ``pad`` hold torch tensors, bytes a
        frame), after its node's ring (a fetch makes them host arrays)."""
        key = (id(e), pad)
        if key in self.memo:
            return self.memo[key]
        self.memo[key] = (False, 0)  # a cycle guard (lint runs on any graph)
        dev, nb = self._made(e, pad)
        if pad == 0 and dev and self.ring_fetches(e):
            dev = False
        self.memo[key] = (dev, nb)
        return dev, nb

    def _spec_bytes(self, e, pad: int) -> int:
        return spec_bytes(e.out_specs[pad]) if pad < len(e.out_specs) else 0

    def _made(self, e, pad: int) -> Tuple[bool, int]:
        from nnstreamer_tpu_torch.elements.base import Routing, Source, TensorOp

        plan = self.plan
        if isinstance(e, Source):
            return bool(getattr(e, "on_device", False)), self._spec_bytes(e, pad)
        seg = plan.seg_of.get(e)
        if isinstance(e, TensorOp) and seg is not None:
            if seg.fused:
                chain = self.chain_of.get(id(e))
                if seg.is_identity() or (chain is None and self.runs_on_host(seg)):
                    return self.inputs(seg.first)
                tr = _trace_or_none(seg) if e is seg.last else None
                nb = tr.out_bytes if tr is not None and tr.host_read is None else \
                    self._spec_bytes(e, pad)
                return True, nb
            if getattr(type(e), "DEVICE_PASSTHROUGH", False):  # queue, media caps
                return self.inputs(e)
            if getattr(e, "DEVICE_PASSTHROUGH", False):  # a converter subplugin
                return True, self._spec_bytes(e, pad)
            return self._host_op_out(e, pad)
        if isinstance(e, Routing):
            dev, nb = self.inputs(e)
            ins = [l.dst_pad for l in self.pipeline.in_links(e)]
            if len(ins) == 1 and pad < len(e.out_specs) and e.in_specs and \
                    e.out_specs[pad] == e.in_specs[0]:
                return dev, nb  # a frame passed on whole (tee)
            return dev, self._spec_bytes(e, pad)
        if getattr(type(e), "WANTS_HOST", False):
            return False, self._spec_bytes(e, pad)  # its replies are host arrays
        if getattr(e, "FACTORY_NAME", "") == "tensor_stage":
            return True, self.inputs(e)[1]
        dev, nb = self.inputs(e)  # a host element hands its frames on
        return dev, nb if pad == 0 else self._spec_bytes(e, pad)

    def _host_op_out(self, e, pad: int) -> Tuple[bool, int]:
        """A host-path TensorOp gets its frame as torch tensors and hands
        on torch tensors (a host backend's outputs go back to the device),
        except a host decoder whose subplugin renders host arrays."""
        from nnstreamer_tpu_torch import registry
        from nnstreamer_tpu_torch.elements.decoder import TensorDecoder

        nb = self._spec_bytes(e, pad)
        if isinstance(e, TensorDecoder):
            if e.mode == "custom-code":
                return False, nb
            try:
                sub = registry.get(registry.KIND_DECODER, e.mode)
            except KeyError:
                return False, nb
            return bool(getattr(sub, "HOST_DECODE_TENSORS", False)), nb
        return True, nb


def plan_transfer_boundaries(plan) -> List[TransferBoundary]:
    """Every host-boundary crossing the port's executor pays a frame on
    ``plan``'s device (the module's notes above the function)."""
    from nnstreamer_tpu_torch.elements.base import Sink

    flow = _Flow(plan)
    p = plan.pipeline
    out: List[TransferBoundary] = []
    for e in p.elements:
        if flow.stages(e):
            dev, nb = flow.inputs(e)
            if not dev:
                src = ",".join(l.src.name for l in p.in_links(e))
                out.append(TransferBoundary(src, e.name, "h2d", nb, "stage"))
        if flow.ring_fetches(e):
            dev, nb = flow._made(e, 0)
            if dev:
                out.append(TransferBoundary(
                    e.name, ",".join(c.name for c in flow.consumers(e)), "d2h", nb,
                    "producer-fetch"))
        if isinstance(e, Sink) and getattr(type(e), "READS_HOST", True):
            for l in p.in_links(e):
                dev, nb = flow.out(l.src, l.src_pad)
                if dev:
                    out.append(TransferBoundary(l.src.name, e.name, "d2h", nb, "sink-fetch"))
    return out


def predict_frame_transfers(plan) -> Dict[str, int]:
    """Predicted host↔device bytes a frame for a 1:1 pipeline: the static
    counterpart of ``Executor.transfer_totals()`` over frames produced.
    The executor's cross-check weighs each boundary by its own node's
    frame count instead (rate limiters and windows change cardinality)."""
    totals = {"h2d": 0, "d2h": 0}
    for b in plan_transfer_boundaries(plan):
        totals[b.direction] += b.bytes_per_frame
    return totals


# -- per-chain cost model ---------------------------------------------------

@dataclass
class ChainCost:
    """Static memory and transfer cost of one compile-unit chain:

    - ``params_bytes``: the member backends' weights, resident for the
      chain's lifetime.
    - ``activation_bytes``: one in-flight frame's negotiated inputs +
      outputs summed over the chain's segments.
    - ``transient_bytes``: the peak per-segment working set: the widest
      segment's input + output + every traced op's output bytes
      (:func:`trace_program`), times the max micro-batch bucket (an upper
      bound: no buffer reuse modelled).
    - ``boundary_in_bytes`` / ``boundary_out_bytes``: bytes a frame
      entering / leaving the chain at its edges.
    """

    params_bytes: int = 0
    activation_bytes: int = 0
    transient_bytes: int = 0
    boundary_in_bytes: int = 0
    boundary_out_bytes: int = 0
    segments: List[str] = field(default_factory=list)

    @property
    def resident_bytes(self) -> int:
        return self.params_bytes + self.transient_bytes


def _segment_intermediate_bytes(seg) -> int:
    """Bytes of every op output of one segment's traced program; 0 when
    the segment cannot be traced here (its in + out activations count
    all the same)."""
    tr = _trace_or_none(seg)
    return tr.intermediate_bytes if tr is not None else 0


def _op_params(op) -> List[torch.Tensor]:
    """The weights of an op's opened backend: its torch module's
    parameters and buffers (none for a backend without a module)."""
    module = getattr(getattr(op, "backend", None), "module", None)
    if isinstance(module, torch.nn.Module):
        return list(module.parameters()) + list(module.buffers())
    return []


def chain_cost(chain, open_backends: bool = True) -> ChainCost:
    """Static cost of one :class:`~nnstreamer_tpu_torch.pipeline.graph.Chain`.
    ``open_backends=False`` counts the weights of backends already open
    and opens none (no model load); the activation and transient
    arithmetic runs either way."""
    cost = ChainCost(segments=[seg.name for seg in chain.segments])
    seen: set = set()
    for seg in chain.segments:
        in_b = spec_bytes(seg.first.in_specs[0] if seg.first.in_specs else None)
        out_b = spec_bytes(seg.last.out_specs[0] if seg.last.out_specs else None)
        cost.activation_bytes += in_b + out_b
        bucket = 1
        cfg = seg.batch_config
        if cfg is not None and getattr(cfg, "active", False) and cfg.buckets:
            bucket = int(cfg.buckets[-1])
        transient = (in_b + out_b + _segment_intermediate_bytes(seg)) * bucket
        cost.transient_bytes = max(cost.transient_bytes, transient)
        for op in seg.ops:
            if open_backends:
                ensure = getattr(op, "_ensure_open", None)
                if callable(ensure):
                    try:
                        ensure()
                    except Exception:  # noqa: BLE001 — unopenable: no params
                        pass
            for t in _op_params(op):
                if id(t) not in seen:
                    seen.add(id(t))
                    cost.params_bytes += t.numel() * t.element_size()
    first, last = chain.segments[0], chain.segments[-1]
    cost.boundary_in_bytes = spec_bytes(
        first.first.in_specs[0] if first.first.in_specs else None)
    cost.boundary_out_bytes = spec_bytes(
        last.last.out_specs[0] if last.last.out_specs else None)
    return cost


# -- per-kernel roofline cost model (nns-kscope) ----------------------------

@dataclass(frozen=True)
class Card:
    """A card's published peaks (NVIDIA's data sheet, SXM part, dense,
    at the full power limit)."""

    name: str
    hbm_bytes_per_s: float
    flops_per_s: Dict[str, float]


#: NVIDIA H100 SXM: 3.35 TB/s of HBM3; tensor cores 989 TFLOP/s in bf16 /
#: fp16, 495 in TF32, 1979 in int8; 67 TFLOP/s float32 outside them
H100 = Card("H100 SXM", 3.35e12, {
    "bf16": 989e12, "fp16": 989e12, "tf32": 495e12, "int8": 1979e12, "fp32": 67e12})


@dataclass
class KernelCost:
    """Static roofline row of one kernel launch: bytes the function must
    move (each input read once, each output written once), the operations
    it does and the unit that does them (a key of :attr:`Card.flops_per_s`),
    and the least time the card could take: the larger of bytes over the
    memory rate and operations over that unit's peak."""

    hbm_read_bytes: int = 0
    hbm_write_bytes: int = 0
    flops: int = 0
    unit: str = "fp32"

    @property
    def hbm_bytes(self) -> int:
        return self.hbm_read_bytes + self.hbm_write_bytes

    @property
    def arithmetic_intensity(self) -> float:
        """Operations a byte: the roofline's x-axis."""
        return self.flops / self.hbm_bytes if self.hbm_bytes else 0.0

    def bytes_ms(self, card: Card = H100) -> float:
        return self.hbm_bytes / card.hbm_bytes_per_s * 1e3

    def ops_ms(self, card: Card = H100) -> float:
        return self.flops / card.flops_per_s[self.unit] * 1e3

    def bound_ms(self, card: Card = H100) -> float:
        return max(self.bytes_ms(card), self.ops_ms(card))

    def bound_by(self, card: Card = H100) -> str:
        return "bytes" if self.bytes_ms(card) >= self.ops_ms(card) else "operations"
