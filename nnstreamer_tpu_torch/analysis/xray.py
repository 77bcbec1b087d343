"""nns-xray: whole-chain compile-unit inference and program lint.

The counterpart of ``nnstreamer_tpu/analysis/xray.py``. ``nns-lint``
answers "is this pipeline wired right"; this module answers "what will run
as one program on the card, and what will it cost". From a launch string
(or a constructed Pipeline) it compiles the plan the executor would run and
reports at CHAIN granularity (:meth:`ExecPlan.chains`: maximal runs of
fused segments joined by device handoffs across queue / capsfilter):

- **compile units** — which elements land in which chain, what severs the
  chains (NNS-W120), and the executor's own verdict on each chain
  (pipeline/chain_program.py ``decide_chain``; NNS-W125 for an eligible
  chain switched off);
- **program lint** — each segment's composed program traced on fake CPU
  tensors (analysis/costmodel.py :func:`trace_program`: nothing allocated,
  no kernel launched; the kernels' wrappers take their plain versions on a
  CPU tensor) and read for an op that reads values on the host or a member
  that declared ``CAPTURABLE = False`` (NNS-W120: the segment cannot be one
  CUDA graph), silent float64 promotion or output dtype drift (NNS-W122),
  and program-cache key explosions (NNS-W121). NNS-W123 (donation) has no
  counterpart: nothing is donated;
- **cost model** — per-chain params / activation / transient bytes and
  the predicted transfer bytes a frame at every host boundary, checked
  against the declared device bound (NNS-W124) and, at run time, against
  the transfer tally (``Executor.transfer_crosscheck``,
  ``NNS_XRAY_CROSSCHECK``);
- **kernel dispatch** — :func:`dispatch_table` calls each of K1-K5's entry
  points on the requested device and reads its launch counter: the kernel
  engaged on CUDA, the plain version on the CPU (no kill switch exists).

The static predicates (``device_capable`` & co.) are shared with lint's
resident-handoff pass, and the hazard walkers with the chain program's
``_hazard``, so the analyzers and the executor never disagree.

The plan is compiled on the pipeline's device (backends open there, as the
executor would open them); nothing is started. Stateful serving elements
(``LINT_SKIP_NEGOTIATE``) and pipelines whose negotiation fails degrade to
notes-only results with zero diagnostics.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

from nnstreamer_tpu_torch.analysis.costmodel import (
    ChainCost,
    ProgramTrace,
    TransferBoundary,
    chain_cost,
    configured_device_bound,
    plan_transfer_boundaries,
    predict_frame_transfers,
    segment_trace,
)
from nnstreamer_tpu_torch.analysis.diagnostics import Diagnostic, LintReport
from nnstreamer_tpu_torch.device import DeviceLike, NoDeviceError
from nnstreamer_tpu_torch.log import get_logger

_log = get_logger("xray")

# past this many program-cache keys for ONE segment, steady state is still
# capturing graphs (bucket ladders are O(log max-batch))
_CACHE_KEY_BOUND = 32
_WIDE = (torch.float64, torch.complex128)


# -- shared static predicates ------------------------------------------------
# Used by BOTH lint's resident-handoff pass (analysis/lint.py) and the
# chain passes below. Everything reads element and backend CLASSES: no
# backend open, no model load, no negotiation.

def device_capable(e: Any) -> bool:
    """A tensor_filter that will trace into a fused device segment: an
    explicit registered framework whose backend class overrides
    ``traceable_fn``, no fallback-framework, no replica fan-out, no plane."""
    from nnstreamer_tpu_torch import registry
    from nnstreamer_tpu_torch.backends.base import Backend
    from nnstreamer_tpu_torch.elements.filter import TensorFilter

    if not isinstance(e, TensorFilter):
        return False
    fw = e.get_property("framework")
    if not fw or str(fw) == "auto":
        return False
    if e.get_property("fallback-framework") or e.get_property("plane"):
        return False  # a per-frame fusion barrier by design
    try:
        if int(e.get_property("replicas") or 0) > 1:
            return False  # idem
    except (TypeError, ValueError):
        pass
    try:
        cls = registry.get(registry.KIND_FILTER, str(fw))
    except KeyError:
        return False  # an unknown framework has its own diagnostic
    return cls.traceable_fn is not Backend.traceable_fn


def transparent(e: Any) -> bool:
    """Plumbing a device tensor rides through untouched: thread and buffer
    boundaries and fan-out that never read tensor bytes."""
    from nnstreamer_tpu_torch.elements.flow import CapsFilter, Queue, Tee

    return isinstance(e, (Queue, CapsFilter, Tee))


def host_bound(e: Any) -> bool:
    """Elements that read or produce tensor bytes on the host. Routing
    regroups frames without touching bytes; traceable TensorOps fuse into
    the chain."""
    from nnstreamer_tpu_torch import registry
    from nnstreamer_tpu_torch.backends.base import Backend
    from nnstreamer_tpu_torch.elements.base import Routing, TensorOp
    from nnstreamer_tpu_torch.elements.filter import TensorFilter

    if transparent(e) or isinstance(e, Routing):
        return False
    if isinstance(e, TensorFilter):
        fw = e.get_property("framework")
        if not fw or str(fw) == "auto":
            return False  # cannot tell statically; never open here
        try:
            cls = registry.get(registry.KIND_FILTER, str(fw))
        except KeyError:
            return False
        return cls.traceable_fn is Backend.traceable_fn
    if isinstance(e, TensorOp):
        try:
            return not e.is_traceable()
        except Exception:  # noqa: BLE001 — cannot tell without opening
            return False
    return hasattr(e, "host_process") or hasattr(e, "process")


def host_postproc_with_device_path(e: Any) -> bool:
    """NNS-W116's static capability read (no negotiation, no labels load):
    a tensor_decoder that will run on the host (postproc=host, or auto with
    a subplugin that offers no auto-fuse ``make_fn``) while its subplugin
    declares a device decode for these options."""
    from nnstreamer_tpu_torch import registry
    from nnstreamer_tpu_torch.elements.decoder import TensorDecoder

    if not isinstance(e, TensorDecoder):
        return False
    if e.postproc == "device" or e.mode == "custom-code":
        return False
    try:
        cls = registry.get(registry.KIND_DECODER, e.mode)
    except KeyError:
        return False  # an unknown mode has its own diagnostic
    probe = getattr(cls, "device_capable", None)
    if probe is None or not probe(e.options):
        return False
    if e.postproc == "auto" and getattr(cls, "make_fn", None) is not None:
        return False  # auto already fuses this subplugin
    return True


def decoder_will_fuse(e: Any) -> bool:
    """Decoders whose is_traceable() is False only because lint never
    negotiates: postproc=device always fuses (or fails negotiation
    loudly), and auto fuses subplugins that offer a ``make_fn`` for these
    options (image_labeling without labels)."""
    from nnstreamer_tpu_torch import registry
    from nnstreamer_tpu_torch.elements.decoder import TensorDecoder

    if not isinstance(e, TensorDecoder) or e.mode == "custom-code":
        return False
    if e.postproc == "device":
        return True
    if e.postproc != "auto":
        return False
    try:
        cls = registry.get(registry.KIND_DECODER, e.mode)
    except KeyError:
        return False
    if getattr(cls, "make_fn", None) is None:
        return False
    probe = getattr(cls, "device_capable", None)
    return probe is None or bool(probe(e.options))


def reaches_capable(e: Any, links: Callable[[Any], List[Any]]) -> bool:
    """A device-capable filter is reachable from ``e`` across only
    transparent plumbing (the resident handoff's span)."""
    seen = {e}
    frontier = [n for n in links(e) if n not in seen]
    while frontier:
        n = frontier.pop()
        if n in seen:
            continue
        seen.add(n)
        if device_capable(n):
            return True
        if transparent(n):
            frontier.extend(links(n))
    return False


# -- result types ------------------------------------------------------------

@dataclass
class ChainReport:
    """One compile unit's row. ``compiled`` is the executor's OWN verdict
    (pipeline/chain_program.py ``decide_chain``, the function
    ``Executor.__init__`` calls): ``yes (unroll K)``, or ``no:`` and the
    blocking hazard or setting."""

    name: str
    segments: List[str]
    n_ops: int
    cost: ChainCost
    notes: List[str] = field(default_factory=list)
    compiled: str = ""


@dataclass
class XrayResult:
    """Chain analysis outcome: compile units, costs, diagnostics.
    ``degraded`` means the plan could not be compiled here (stateful
    serving elements, absent model files): notes only, by design no
    W120-W125."""

    report: LintReport
    pipeline: Optional[Any] = None
    plan: Optional[Any] = None
    chains: List[ChainReport] = field(default_factory=list)
    boundaries: List[TransferBoundary] = field(default_factory=list)
    predicted: Dict[str, int] = field(default_factory=dict)
    device: str = ""
    dispatch: List[Dict[str, Any]] = field(default_factory=list)
    notes: List[str] = field(default_factory=list)
    errors: List[str] = field(default_factory=list)
    degraded: bool = False

    @property
    def diagnostics(self) -> List[Diagnostic]:
        return self.report.diagnostics

    @property
    def codes(self) -> List[str]:
        return self.report.codes

    @property
    def exit_code(self) -> int:
        if self.errors:
            return 2
        return self.report.exit_code

    def render(self) -> str:
        lines: List[str] = []
        for err in self.errors:
            lines.append(f"error: {err}")
        for note in self.notes:
            lines.append(f"note: {note}")
        lines.append(f"compile units: {len(self.chains)}")
        for ch in self.chains:
            lines.append(f"  chain [{ch.name}]: {ch.n_ops} op(s) in {len(ch.segments)} segment(s)")
            c = ch.cost
            lines.append(
                f"    params {_fmt_bytes(c.params_bytes)}, activations "
                f"{_fmt_bytes(c.activation_bytes)}, peak transient "
                f"{_fmt_bytes(c.transient_bytes)}, boundary in/out "
                f"{_fmt_bytes(c.boundary_in_bytes)}/{_fmt_bytes(c.boundary_out_bytes)} a frame")
            if ch.compiled:
                lines.append(f"    compiled: {ch.compiled}")
            for note in ch.notes:
                lines.append(f"    note: {note}")
        for b in self.boundaries:
            lines.append(
                f"  boundary {b.direction} {b.producer} -> {b.consumer} "
                f"({b.reason}): {_fmt_bytes(b.bytes_per_frame)}/frame")
        if self.predicted:
            lines.append(
                f"predicted transfer a frame on {self.device}: "
                f"h2d={self.predicted['h2d']} d2h={self.predicted['d2h']}")
        for d in self.diagnostics:
            lines.append(str(d))
        if self.dispatch:
            lines.append("kernel dispatch:")
            lines.extend("  " + dispatch_row_text(row) for row in self.dispatch)
        return "\n".join(lines)


def _fmt_bytes(n: int) -> str:
    size = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if size < 1024 or unit == "GiB":
            return f"{int(size)} {unit}" if unit == "B" else f"{size:.1f} {unit}"
        size /= 1024
    return f"{n} B"


# -- program lint --------------------------------------------------------------

def _is_wide(dtype: torch.dtype) -> bool:
    return dtype in _WIDE


def dtype_findings(trace: ProgramTrace, in_dtypes: Tuple[torch.dtype, ...] = (),
                   declared_out: Optional[Tuple] = None) -> List[str]:
    """NNS-W122 walker over a trace: silent float64 / complex128 promotion
    (a wide value computed from the inputs, none of them wide; a constant
    built on the host and cast is no promotion) and traced output dtypes
    against the negotiated ones (``declared_out``: the out spec's
    :class:`~nnstreamer_tpu_torch.tensors.spec.DType` s)."""
    from nnstreamer_tpu_torch.pipeline.chain_program import _dtype_ok

    msgs: List[str] = []
    if not any(_is_wide(d) for d in in_dtypes):
        for name, dtype, _, derived in trace.ops:
            if derived and _is_wide(dtype):
                msgs.append(f"`{name}` produces {str(dtype).replace('torch.', '')} "
                            "with no 64-bit input")
                break  # one promotion site is enough evidence
    if declared_out:
        for i, (got, want) in enumerate(zip(trace.out_dtypes, declared_out)):
            if not _dtype_ok(got, want):
                msgs.append(f"output {i} traces as {str(got).replace('torch.', '')} "
                            f"but negotiated {want.value}")
    return msgs


def uncapturable_ops(seg: Any) -> Tuple[str, ...]:
    """The members of ``seg`` that declared ``CAPTURABLE = False``: the
    predicate the segment's program cache records at each fill."""
    return tuple(seg.programs._uncapturable())


def _declared_out(seg: Any) -> Optional[Tuple]:
    spec = seg.last.out_specs[0] if seg.last.out_specs else None
    if spec is not None and getattr(spec, "is_static", False):
        return tuple(t.dtype for t in spec)
    return None


def segment_hazard(seg: Any) -> Optional[str]:
    """The first W120 / W122 hazard of one fused segment, as the chain
    program's ``_hazard`` reports it, or None. A segment that cannot be
    traced blocks the chain program too, as in the reference."""
    if seg.is_identity():
        return None
    bad = uncapturable_ops(seg)
    if bad:
        return f"NNS-W120 uncapturable op `{bad[0]}` in segment {seg.name}"
    try:
        tr = segment_trace(seg)
    except Exception as exc:  # noqa: BLE001 — untraceable: no program
        return f"segment {seg.name} untraceable ({exc})"
    if tr is None:
        return None
    if tr.host_read is not None:
        return f"NNS-W120 host read `{tr.host_read}` in segment {seg.name}"
    sig = seg._negotiated_sig() or ()
    msgs = dtype_findings(tr, tuple(d for _, d in sig), _declared_out(seg))
    if msgs:
        return f"NNS-W122 in segment {seg.name}: {msgs[0]}"
    return None


def cache_key_finding(seg: Any) -> Optional[str]:
    """NNS-W121: an unbounded or exploding program-cache key space for one
    segment (each key a CUDA graph captured on the hot path)."""
    sig = seg._negotiated_sig()
    cfg = seg.batch_config
    active = bool(cfg is not None and getattr(cfg, "active", False)
                  and getattr(cfg, "buckets", ()))
    if sig is None and active:
        return ("flexible per-frame input spec under micro-batching: every "
                "distinct arriving shape multiplies the bucket ladder "
                f"({len(cfg.buckets)} buckets) into fresh graph captures — "
                "the cache key space is unbounded")
    if sig is not None and active:
        n_keys = len(cfg.buckets) + 1
        if n_keys > _CACHE_KEY_BOUND:
            return (f"{n_keys} program-cache keys for one segment (one a bucket "
                    "and the per-frame program): steady state keeps capturing")
    return None


# -- chain passes ------------------------------------------------------------

def _nearest_segment(plan: Any, e: Any, links: Callable) -> Optional[Any]:
    seen: set = set()
    frontier = list(links(e))
    while frontier:
        n = frontier.pop()
        if id(n) in seen:
            continue
        seen.add(id(n))
        seg = plan.fused_seg(n)
        if seg is not None:
            return seg
        if transparent(n):
            frontier.extend(links(n))
    return None


def _host_split_pass(plan: Any, chains: List[Any], report: LintReport) -> None:
    """NNS-W120 (structural): a host-path tensor op with a fused segment
    on BOTH sides — the two chains around it would be one compile unit if
    the op had a device path. Decoders that W116 pinpoints are left to it:
    one code a boundary."""
    from nnstreamer_tpu_torch.elements.base import Routing, TensorOp

    pipeline = plan.pipeline
    chain_of = {id(seg): ch for ch in chains for seg in ch.segments}

    def ups(e):
        return [ln.src for ln in pipeline.in_links(e)]

    def downs(e):
        return [ln.dst for ln in pipeline.out_links(e)]

    for e in pipeline.elements:
        if not isinstance(e, TensorOp) or plan.fused_seg(e) is not None:
            continue
        if transparent(e) or isinstance(e, Routing):
            continue
        if decoder_will_fuse(e) or host_postproc_with_device_path(e):
            continue  # W116's ground (lint emits it)
        up_seg = _nearest_segment(plan, e, ups)
        down_seg = _nearest_segment(plan, e, downs)
        if up_seg is None or down_seg is None:
            continue
        report.add(
            "NNS-W120", e.name,
            f"host-path op severs the chain: [{chain_of[id(up_seg)].name}] and "
            f"[{chain_of[id(down_seg)].name}] would be ONE compile unit, but every "
            "frame materializes to host and re-stages to the device here",
            "give this op a device-capable framework or traceable path, or "
            "move it outside the device span",
        )


def _segment_pass(seg: Any, report: LintReport, notes: List[str]) -> None:
    if not seg.is_identity():
        bad = uncapturable_ops(seg)
        if bad:
            report.add(
                "NNS-W120", seg.first.name,
                f"op `{bad[0]}` of segment {seg.name} declares CAPTURABLE = False: "
                "its programs stay eager on the card and the chain can never be "
                "one CUDA graph",
                "split the op into a host element of its own, or move it outside "
                "the device span",
            )
        tr = None
        try:
            tr = segment_trace(seg)
        except Exception as exc:  # noqa: BLE001 — the trace is best-effort
            notes.append(f"{seg.name}: trace unavailable ({type(exc).__name__}: {exc})")
        if tr is not None and tr.host_read is not None:
            report.add(
                "NNS-W120", seg.first.name,
                f"host read `{tr.host_read}` inside device segment {seg.name}: the "
                "program waits on the card for a value every frame and cannot be "
                "captured into a CUDA graph",
                "compute in-graph, or split the read into an explicit host element",
            )
        elif tr is not None:
            sig = seg._negotiated_sig() or ()
            for msg in dtype_findings(tr, tuple(d for _, d in sig), _declared_out(seg)):
                report.add(
                    "NNS-W122", seg.first.name,
                    f"segment {seg.name}: {msg}",
                    "pin dtypes explicitly (a cast at the boundary): 64-bit math "
                    "runs far below the float32 rate on the card and doubles "
                    "activation bytes",
                )
            if tr.partial:
                notes.append(f"{seg.name}: {tr.partial}")
    msg = cache_key_finding(seg)
    if msg is not None:
        report.add(
            "NNS-W121", seg.first.name,
            f"segment {seg.name}: {msg}",
            "declare static dimensions upstream (capsfilter / source "
            "dimensions=) or disable batching on this segment",
        )


def _bound_pass(chain: Any, cost: ChainCost, report: LintReport) -> None:
    bound = configured_device_bound()
    if bound is None or cost.resident_bytes <= bound:
        return
    report.add(
        "NNS-W124", chain.first.name,
        f"chain [{chain.name}]: resident {_fmt_bytes(cost.resident_bytes)} (params "
        f"{_fmt_bytes(cost.params_bytes)} + peak transient "
        f"{_fmt_bytes(cost.transient_bytes)} at the max micro-batch bucket) "
        f"exceeds [plane] memory_per_device {_fmt_bytes(bound)}",
        "shrink the max batch bucket, split the chain across devices "
        "(serving_plane placement), or raise the bound",
    )


def _compiled_pass(plan: Any, chain: Any, cr: ChainReport, report: LintReport) -> None:
    """The chain's ``compiled`` column from the executor's own verdict, and
    NNS-W125 for a hazard-free multi-segment chain someone switched off."""
    from nnstreamer_tpu_torch.pipeline.chain_program import decide_chain

    try:
        d = decide_chain(plan, chain)
    except Exception as exc:  # noqa: BLE001 — the verdict is best-effort here
        cr.compiled = f"no: verdict unavailable ({exc})"
        return
    if d.compiles:
        cr.compiled = f"yes (unroll {d.unroll})"
        return
    if d.eligible:  # and therefore mode == "off"
        cr.compiled = "no: chain_mode=off"
        report.add(
            "NNS-W125", chain.first.name,
            f"chain [{chain.name}]: {len(chain.segments)} hazard-free segments are "
            "running with chain_mode=off — every frame crosses one service thread "
            "per node where ONE program (a graph replayed once a window) would "
            "serve it",
            "set [executor] chain_mode=auto (or drop the chain-mode=off property); "
            "keep off only while debugging against the per-node path",
        )
        return
    cr.compiled = f"no: {d.reason}"


# -- entry point -------------------------------------------------------------

def xray(target: Union[str, Any], device: DeviceLike = None,
         open_backends: bool = True) -> XrayResult:
    """Analyze a launch string or a constructed Pipeline at chain
    granularity. A launch string is built on ``device`` (default ``cuda``;
    without a GPU this raises unless ``device="cpu"``), and the plan is
    compiled there: tensor_filter backends open as the executor would open
    them; nothing is started. ``open_backends=False`` opens no backend for
    the params estimate (the plan's own opens still count)."""
    report = LintReport()
    res = XrayResult(report=report)
    if isinstance(target, str):
        from nnstreamer_tpu_torch.pipeline.parse import parse_pipeline

        try:
            pipeline = parse_pipeline(target, device=device)
        except NoDeviceError:
            raise
        except Exception as exc:  # noqa: BLE001 — surfaced as the result
            res.errors.append(f"parse failed: {exc}")
            return res
    else:
        pipeline = target
    res.pipeline = pipeline
    res.device = str(pipeline.device)
    skip = [e.name for e in pipeline.elements if type(e).LINT_SKIP_NEGOTIATE]
    if skip:
        res.degraded = True
        res.notes.append("negotiation skipped (stateful serving elements: "
                         f"{', '.join(skip)}); chain analysis unavailable")
        return res
    try:
        plan = pipeline.compile_plan()
    except Exception as exc:  # noqa: BLE001 — degrade; lint owns the error
        res.degraded = True
        res.notes.append(f"compile_plan failed ({exc}); chain analysis unavailable")
        return res
    res.plan = plan
    chains = plan.chains()
    res.boundaries = plan_transfer_boundaries(plan)
    res.predicted = predict_frame_transfers(plan)
    _host_split_pass(plan, chains, report)
    for chain in chains:
        cost = chain_cost(chain, open_backends=open_backends)
        cr = ChainReport(name=chain.name, segments=[s.name for s in chain.segments],
                         n_ops=len(chain.ops), cost=cost)
        for seg in chain.segments:
            _segment_pass(seg, report, cr.notes)
        _bound_pass(chain, cost, report)
        _compiled_pass(plan, chain, cr, report)
        res.chains.append(cr)
    return res


# -- kernel dispatch table ---------------------------------------------------

def _k1():
    from nnstreamer_tpu_torch.ops.kernels import image_kernels

    return image_kernels


def _probe_crop(dev):
    ik = _k1()
    ik.crop_and_resize(torch.zeros((8, 8, 3), device=dev),
                       torch.tensor([[0.0, 0.0, 4.0, 4.0]], device=dev), 4, 4)


def _probe_resize(dev):
    _k1().resize_bilinear(torch.zeros((8, 8, 3), device=dev), 4, 4)


def _probe_nms(dev):
    from nnstreamer_tpu_torch.ops.kernels import nms

    boxes = torch.tensor([[0.0, 0.0, 4.0, 4.0], [0.0, 0.0, 4.0, 4.0]], device=dev)
    nms.nms_mask(boxes, torch.tensor([0.9, 0.8], device=dev), 0.5)


def _probe_decode(dev):
    from nnstreamer_tpu_torch.ops.kernels import decode_attention

    b, s, h, d = 1, 8, 2, 16
    cache = torch.zeros((b, s, h, d), device=dev)
    decode_attention.decode_attention(torch.zeros((b, 1, h, d), device=dev), cache, cache,
                                      torch.zeros((b,), dtype=torch.int32, device=dev))


def _probe_paged(dev):
    from nnstreamer_tpu_torch.ops.kernels import paged_attention

    b, h, d, bs = 1, 2, 16, 4
    arena = torch.zeros((4, bs, h, d), device=dev)
    fresh = torch.zeros((b, 1, h, d), device=dev)
    paged_attention.paged_decode_attention(
        torch.zeros((b, 1, h, d), device=dev), arena, arena,
        torch.zeros((b, 2), dtype=torch.int32, device=dev),
        torch.zeros((b,), dtype=torch.int32, device=dev), fresh, fresh)


def _probe_flash(dev):
    from nnstreamer_tpu_torch.ops.kernels import flash_attention

    x = torch.zeros((1, 8, 2, 16), device=dev)
    flash_attention.flash_attention(x, x, x, causal=True)


def _counter(module: str, name: str):
    import importlib

    return getattr(importlib.import_module(f"nnstreamer_tpu_torch.ops.kernels.{module}"), name)


#: (entry point, the TPU kernel it replaces, probe, its launch counter)
DISPATCH_PROBES: List[Tuple[str, str, Callable, Tuple[str, str]]] = [
    ("crop_and_resize", "K1", _probe_crop, ("image_kernels", "crop_entry_launches")),
    ("resize_bilinear", "K1", _probe_resize, ("image_kernels", "resize_entry_launches")),
    ("nms_mask", "K2", _probe_nms, ("nms", "nms_launches")),
    ("decode_attention", "K3", _probe_decode, ("decode_attention", "decode_attention_launches")),
    ("paged_decode_attention", "K4", _probe_paged,
     ("paged_attention", "paged_decode_attention_launches")),
    ("flash_attention", "K5", _probe_flash, ("flash_attention", "flash_attention_launches")),
]


def dispatch_table(device: DeviceLike = None, run: bool = True) -> List[Dict[str, Any]]:
    """Which implementation each of K1-K5's entry points engages on
    ``device`` (default ``cuda``; raises without a GPU unless ``"cpu"``):
    the kernel on a CUDA tensor, the plain version on a CPU tensor (the
    wrappers dispatch by device alone; nothing degrades and nothing can
    switch a kernel off). With ``run``, each entry point is called on tiny
    inputs and its launch counter read before and after: ``launches`` > 0
    proves the kernel engaged."""
    from nnstreamer_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    rows: List[Dict[str, Any]] = []
    for op, kernel, probe, (module, name) in DISPATCH_PROBES:
        row: Dict[str, Any] = {"op": op, "kernel": kernel, "device": str(dev),
                               "expected": "kernel" if dev.type == "cuda" else "plain",
                               "engaged": None, "launches": 0, "error": None}
        if run:
            try:
                counter = _counter(module, name)
                before = counter.count
                probe(dev)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                row["launches"] = counter.count - before
                row["engaged"] = "kernel" if row["launches"] > 0 else "plain"
            except Exception as exc:  # noqa: BLE001 — one row a failure
                row["error"] = f"{type(exc).__name__}: {exc}"
        rows.append(row)
    return rows


def dispatch_row_text(row: Dict[str, Any]) -> str:
    text = (f"{row['op']} ({row['kernel']}) on {row['device']}: "
            f"engaged={row['engaged'] or '-'} launches={row['launches']}")
    return text + (f" ({row['error']})" if row.get("error") else "")
