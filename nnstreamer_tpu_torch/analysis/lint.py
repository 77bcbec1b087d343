"""nns-lint: static pipeline analysis — report EVERY problem, start nothing.

The counterpart of ``nnstreamer_tpu/analysis/lint.py``. Take a launch
string (or a constructed Pipeline) and, WITHOUT starting it, run passes
that each append structured
:class:`~nnstreamer_tpu_torch.analysis.diagnostics.Diagnostic` findings:

1. graph structure — unlinked pads, cycles (with the member list),
   unreachable elements, fan-in branches sharing a tee (or another
   fan-out) ancestor with no intervening queue, channel capacity, skewed
   joins;
2. dry-run spec flow — each element's own ``negotiate()`` runs on a CLONE
   in topological order, so every caps mismatch in the graph is reported,
   not just the first, and the user's pipeline object is never mutated;
3. property validation — launch-string properties against the elements'
   ``PROPERTIES`` schemas (unknown names, un-coercible values);
4. resources and deployment — model paths, ``framework=`` / decoder /
   converter names, admission and failover bounds, model sharing, the
   serving plane, KV caches against their declared bound, host nodes that
   split device segments, and kernel requests that would raise on the card
   (NNS-W129, analysis/kernels.py).

The dry run negotiates on the pipeline's device: a ``tensor_filter``
backend opens (a model loads) there, so :func:`lint` takes ``device`` as
the parser does (default ``cuda``; without a GPU it raises unless
``device="cpu"`` is asked for). Pipelines are never executed: no
``start()``, no executor, no sockets.
"""

from __future__ import annotations

import copy
import difflib
import os
from dataclasses import dataclass
from fractions import Fraction
from typing import Any, Dict, List, Optional, Set, Tuple, Union

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.analysis.diagnostics import Diagnostic, LintReport
from nnstreamer_tpu_torch.device import DeviceLike
from nnstreamer_tpu_torch.elements.base import (
    Element,
    PropSpec,
    PROPS_ANY,
    Routing,
    Source,
    parse_bool,
)
from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.pipeline.graph import Pipeline
from nnstreamer_tpu_torch.pipeline.parse import (
    ParseError,
    _make_caps_element,
    _parse_caps,
    scan_description,
)

_log = get_logger("lint")


class _Placeholder(Element):
    """Stand-in for an element that could not be resolved/constructed, so
    the rest of the graph still wires up and gets checked."""

    FACTORY_NAME = "~unresolved"
    N_SINKS = 1
    N_SRCS = 1

    def negotiate(self, in_specs):
        return [None]


@dataclass
class LintResult:
    """LintReport + the (possibly partially constructed) pipeline and the
    dry-run negotiated specs (element name → out specs) for annotation."""

    report: LintReport
    pipeline: Optional[Pipeline]
    negotiated_specs: Dict[str, List[Any]] = None  # type: ignore[assignment]

    @property
    def diagnostics(self) -> List[Diagnostic]:
        return self.report.diagnostics

    @property
    def exit_code(self) -> int:
        return self.report.exit_code

    @property
    def codes(self) -> List[str]:
        return self.report.codes

    def render(self) -> str:
        return self.report.render()


# -- property validation ----------------------------------------------------

_TRUE = ("1", "true", "yes", "on")
_FALSE = ("0", "false", "no", "off")


def coerce_property(ps: PropSpec, value: Any) -> Any:
    """Coerce a raw (usually string) property value per its schema; raise
    ValueError when the value cannot possibly be what the element needs."""
    if ps.type == "str":
        return str(value)
    s = str(value).strip()
    if ps.type == "int":
        return int(s)
    if ps.type == "float":
        return float(s)
    if ps.type == "fraction":
        return Fraction(s)
    if ps.type == "bool":
        if s.lower() in _TRUE:
            return True
        if s.lower() in _FALSE:
            return False
        raise ValueError(f"not a boolean: {value!r}")
    if ps.type == "enum":
        if s.lower() in tuple(c.lower() for c in ps.choices):
            return s
        raise ValueError(
            f"{value!r} not one of {', '.join(ps.choices)}"
        )
    return value  # unknown schema type: accept


def check_properties(
    cls: type, props: Dict[str, Any], elem_label: str, report: LintReport
) -> None:
    """Schema-validate one element's property dict (NNS-W101 / NNS-E005)."""
    schema = cls.property_schema()
    open_schema = PROPS_ANY in schema
    for key, value in props.items():
        norm = key.replace("_", "-")
        ps = schema.get(norm)
        if ps is None:
            if open_schema:
                continue
            known = sorted(k for k in schema if k != PROPS_ANY)
            close = difflib.get_close_matches(norm, known, n=1)
            hint = f"did you mean {close[0]!r}?" if close else (
                f"known properties: {', '.join(known)}"
            )
            report.add(
                "NNS-W101", elem_label,
                f"unknown property {key!r} for {cls.FACTORY_NAME}", hint,
            )
            continue
        try:
            coerce_property(ps, value)
        except (ValueError, ZeroDivisionError) as exc:
            hint = (
                f"default is {ps.default!r}" if ps.default is not None else ""
            )
            if ps.type == "bool":
                # runtime _parse_bool never raises — any unrecognized
                # string silently becomes False, so this is a suspicion,
                # not a predicted failure
                report.add(
                    "NNS-W106", elem_label,
                    f"property {key}={value!r} is not a recognized boolean "
                    "and will silently read as false",
                    hint,
                )
            else:
                report.add(
                    "NNS-E005", elem_label,
                    f"property {key}={value!r} is not a valid {ps.type}: "
                    f"{exc}",
                    hint,
                )


# -- fault-tolerant launch-string build -------------------------------------

def _build_tolerant(
    description: str, report: LintReport, placeholders: Set[str],
    device: DeviceLike = None,
) -> Optional[Pipeline]:
    """parse.parse_pipeline's two passes, but every failure becomes a
    diagnostic and a placeholder so later passes still see the graph."""
    try:
        items = scan_description(description)
    except ParseError as exc:
        report.add("NNS-E009", None, str(exc))
        return None
    # constructing lint elements must not shift the gst-style default
    # numbering (tensor_sink0, ...) of pipelines parsed afterwards — the
    # whole point of lint is to run BEFORE the real parse
    counters_snapshot = dict(Element._instance_counters)
    try:
        return _build_items(items, report, placeholders, device)
    finally:
        Element._instance_counters.clear()
        Element._instance_counters.update(counters_snapshot)


def _build_items(
    items: List[Any],
    report: LintReport,
    placeholders: Set[str],
    device: DeviceLike = None,
) -> Optional[Pipeline]:
    pipeline = Pipeline(device=device)
    instances: List[Optional[Element]] = []
    n_anon = 0

    def placeholder(label: Optional[str], factory: str = "unresolved") -> Element:
        nonlocal n_anon
        # '~' cannot appear in parsed names, so this never collides
        p = _Placeholder(name=label or f"{factory}~{n_anon}")
        n_anon += 1
        placeholders.add(p.name)
        return p

    for item in items:
        if item[0] == "element":
            _, factory, props = item
            cls: Optional[type] = None
            lookup_err: Optional[Tuple[str, str, str]] = None
            try:
                cls = registry.get(registry.KIND_ELEMENT, factory)
            except KeyError:
                # builtin_only: a restricted name must never trigger
                # plugin-file execution just to classify the diagnostic
                if registry.is_restricted(
                    registry.KIND_ELEMENT, factory
                ) and registry.exists(
                    registry.KIND_ELEMENT, factory, builtin_only=True
                ):
                    lookup_err = (
                        "NNS-E010",
                        f"element {factory!r} is restricted by configuration",
                        "[common] restricted_elements blocks it",
                    )
                else:
                    known = registry.available(registry.KIND_ELEMENT)
                    close = difflib.get_close_matches(factory, known, n=1)
                    lookup_err = (
                        "NNS-E004",
                        f"no element factory named {factory!r}",
                        f"did you mean {close[0]!r}?" if close else "",
                    )
            # construct FIRST so diagnostics anchor to the node's actual
            # (possibly auto-generated) name and dot annotation matches
            elem: Optional[Element] = None
            ctor_exc: Optional[Exception] = None
            ctor = dict(props)
            elem_name = ctor.pop("name", None)
            if cls is not None:
                # the port's elements refuse a property their schema lacks;
                # NNS-W101 reports it, and the element is built without it
                # (the reference's elements keep and ignore such a key)
                schema = cls.property_schema()
                if PROPS_ANY not in schema:
                    ctor = {k: v for k, v in ctor.items() if k.replace("_", "-") in schema}
                try:
                    elem = cls(name=elem_name, **ctor)
                except Exception as exc:  # ctor rejected the properties
                    ctor_exc = exc
            if elem is None:
                elem = placeholder(elem_name, factory)
            label = elem.name
            if lookup_err is not None:
                report.add(lookup_err[0], label, lookup_err[1], lookup_err[2])
            if cls is not None:
                n_before = len(report.diagnostics)
                check_properties(cls, props, label, report)
                schema_flagged = any(
                    d.code == "NNS-E005"
                    for d in report.diagnostics[n_before:]
                )
                if ctor_exc is not None and not schema_flagged:
                    # a ctor failure the schema didn't predict: missing
                    # required property, unopenable resource, ... — its
                    # own code, NOT bad-property-value (scripts match on
                    # codes)
                    report.add(
                        "NNS-E011", label,
                        f"{factory} could not be constructed: {ctor_exc}",
                    )
            try:
                pipeline.add(elem)
            except ValueError as exc:  # duplicate name
                report.add("NNS-E009", elem.name, str(exc))
                elem = placeholder(None)
                pipeline.add(elem)
            instances.append(elem)
        elif item[0] == "caps":
            try:
                media, fields = _parse_caps(item[1])
                elem = _make_caps_element(media, fields)
            except (ParseError, ValueError) as exc:
                report.add("NNS-E009", None, f"bad caps {item[1]!r}: {exc}")
                elem = placeholder(None)
            pipeline.add(elem)
            instances.append(elem)
        else:
            instances.append(None)

    # pass 2: wire links, tolerating per-link failures
    prev: Optional[Element] = None
    prev_src_pad: Optional[int] = None
    expect_link = False
    for item, inst in zip(items, instances):
        if item[0] == "bang":
            if prev is None:
                report.add("NNS-E009", None, "'!' with nothing to link from")
            elif expect_link:
                report.add("NNS-E009", None, "duplicate '!'")
            else:
                expect_link = True
        elif item[0] == "ref":
            _, name, kind, pad = item
            try:
                target = pipeline[name]
            except KeyError:
                report.add(
                    "NNS-E009", None,
                    f"reference to unknown element {name!r}",
                )
                prev, prev_src_pad, expect_link = None, None, False
                continue
            if expect_link:
                dst_pad = pad if kind in (None, "sink") else None
                try:
                    pipeline.link(prev, target, src_pad=prev_src_pad,
                                  dst_pad=dst_pad)
                except ValueError as exc:
                    report.add("NNS-E009", target.name, str(exc))
                prev, prev_src_pad, expect_link = None, None, False
            else:
                prev = target
                prev_src_pad = pad if kind in (None, "src") else None
        else:
            if expect_link:
                try:
                    pipeline.link(prev, inst, src_pad=prev_src_pad)
                except ValueError as exc:
                    report.add("NNS-E009", inst.name, str(exc))
                expect_link = False
            prev, prev_src_pad = inst, None
    if expect_link:
        report.add("NNS-E009", None, "pipeline ends with '!'")
    return pipeline


# -- pass 1: graph structure -------------------------------------------------

def _structure_pass(
    pipeline: Pipeline, report: LintReport, placeholders: Set[str]
) -> List[Element]:
    """NNS-E001/W105 unlinked pads, NNS-E002 cycles, NNS-W104 reachability.
    Returns the cycle members (non-empty means the spec pass must skip)."""
    for e in pipeline.elements:
        if e.name in placeholders:
            continue
        ins = len(pipeline.in_links(e))
        outs = len(pipeline.out_links(e))
        if e.N_SINKS is not None and ins < e.N_SINKS:
            report.add(
                "NNS-E001", e.name,
                f"{ins}/{e.N_SINKS} sink pads linked",
                "link an upstream element into it",
            )
        elif e.N_SINKS is None and ins == 0 and not isinstance(e, Source):
            report.add(
                "NNS-E001", e.name,
                f"{e.FACTORY_NAME} has no inputs linked",
                "fan-in elements need at least one linked sink pad",
            )
        err_pad = getattr(e, "error_pad", None)
        out_pads = {l.src_pad for l in pipeline.out_links(e)}
        if err_pad is not None:
            # the dead-letter pad gets its own diagnostic (NNS-W107), and
            # is excluded from the generic unlinked-src count below: an
            # unlinked error pad is a ROUTING mistake (silent drop), not
            # a dangling data output. Only on-error=route REQUIRES the
            # pad; a retry element's pad is optional exhaustion overflow
            if getattr(e, "error_pad_required", False) \
                    and err_pad not in out_pads:
                report.add(
                    "NNS-W107", e.name,
                    "on-error=route but the error pad "
                    f"(src_{err_pad}) is unlinked; dead-lettered frames "
                    "are silently dropped",
                    f"link '{e.name}.src_{err_pad}' to a sink "
                    "(the dead-letter queue)",
                )
            n_data_srcs = e.N_SRCS - 1
            data_outs = len(out_pads - {err_pad})
        else:
            n_data_srcs = e.N_SRCS
            data_outs = outs
        if n_data_srcs is not None and n_data_srcs > 0 \
                and data_outs < n_data_srcs:
            report.add(
                "NNS-W105", e.name,
                f"{data_outs}/{n_data_srcs} src pads linked; unlinked "
                "output is dropped",
                "terminate it into a sink (or fakesink)",
            )
        # explicit pad indices beyond the allocated pad count (e.g.
        # 'mux.sink_5' with one branch linked): pad numbering must be
        # dense, or negotiation indexes out of range at runtime
        n_sinks = pipeline.n_sinks(e)
        for l in pipeline.in_links(e):
            if l.dst_pad >= n_sinks:
                report.add(
                    "NNS-E001", e.name,
                    f"sink pad {l.dst_pad} linked but only pads "
                    f"0..{n_sinks - 1} exist; lower-numbered pads are "
                    "unlinked",
                    "pad numbering must be dense from 0",
                )
        n_srcs = pipeline.n_srcs(e)
        for l in pipeline.out_links(e):
            if l.src_pad >= n_srcs:
                report.add(
                    "NNS-W105", e.name,
                    f"src pad {l.src_pad} linked but only pads "
                    f"0..{n_srcs - 1} exist; lower-numbered pads are "
                    "unlinked",
                    "pad numbering must be dense from 0",
                )
    _, leftover = pipeline.toposort_partial()
    if leftover:
        names = sorted(e.name for e in leftover)
        report.add(
            "NNS-E002", None,
            f"pipeline has a cycle through {names}",
            "use tensor_reposink/tensor_reposrc for feedback loops",
        )
    # placeholders with no inputs may well BE sources (unknown name in
    # the source position): treat them as reachability seeds and never
    # claim "no source" on their account
    seeds = [
        e for e in pipeline.elements
        if isinstance(e, Source)
        or (e.name in placeholders and not pipeline.in_links(e))
    ]
    if not seeds:
        if pipeline.elements:
            report.add(
                "NNS-W104", None,
                "pipeline has no source element; nothing will flow",
            )
    else:
        reached: Set[Element] = set()
        stack = list(seeds)
        while stack:
            e = stack.pop()
            if e in reached:
                continue
            reached.add(e)
            stack.extend(l.dst for l in pipeline.out_links(e))
        in_cycle = set(leftover)
        for e in pipeline.elements:
            if e not in reached and e not in in_cycle \
                    and e.name not in placeholders:
                report.add(
                    "NNS-W104", e.name,
                    f"{e.FACTORY_NAME} is not reachable from any source",
                )
    return leftover


def _queue_free_reach(pipeline: Pipeline, start: Element, goal: Element) -> bool:
    """True if `goal` is reachable from `start` without crossing a queue."""
    from nnstreamer_tpu_torch.elements.flow import Queue

    if isinstance(goal, Queue):
        return False
    seen: Set[Element] = set()
    stack = [start]
    while stack:
        e = stack.pop()
        if e in seen:
            continue
        seen.add(e)
        if e is goal:
            return True
        if isinstance(e, Queue) and e is not start:
            continue  # a queue on the path buffers it: stop this walk
        stack.extend(l.dst for l in pipeline.out_links(e))
    return False


def _branch_ancestors(pipeline: Pipeline, ins) -> List[Set[Element]]:
    """Per-in-link ancestor sets of a fan-in element (one upstream walk,
    shared by the W103/W109/W110 join passes)."""
    out: List[Set[Element]] = []
    for l in ins:
        anc: Set[Element] = set()
        stack = [l.src]
        while stack:
            e = stack.pop()
            if e in anc:
                continue
            anc.add(e)
            stack.extend(ll.src for ll in pipeline.in_links(e))
        out.append(anc)
    return out


def _unqueued_join_scan(
    pipeline: Pipeline, report: LintReport, code: str,
    ancestor_pred, noun, hint: str,
) -> None:
    """The shared blocking-join shape: a fan-in whose branch pair shares
    an ancestor selected by `ancestor_pred`, with at least one branch
    carrying no queue between the ancestor and the fan-in. `noun` labels
    the ancestor in the message (e.g. 'tee')."""
    for m in pipeline.elements:
        ins = pipeline.in_links(m)
        if len(ins) < 2:
            continue
        branch_anc = _branch_ancestors(pipeline, ins)
        flagged: Set[Element] = set()
        for i in range(len(ins)):
            for j in range(i + 1, len(ins)):
                shared = [
                    f for f in branch_anc[i] & branch_anc[j]
                    if ancestor_pred(f) and f not in flagged
                ]
                for fo in shared:
                    bad = [
                        ins[k].dst_pad for k in (i, j)
                        if _queue_free_reach(pipeline, fo, ins[k].src)
                        or ins[k].src is fo
                    ]
                    if bad:
                        flagged.add(fo)
                        pads = ", ".join(f"sink_{p}" for p in bad)
                        report.add(
                            code, m.name,
                            f"branches from {noun(fo)} {fo.name!r} reach "
                            f"{m.name} ({pads}) without an intervening "
                            "queue",
                            hint,
                        )


def _tee_pass(pipeline: Pipeline, report: LintReport) -> None:
    """NNS-W103: fan-in element whose branches share a tee ancestor with at
    least one branch carrying no queue between the tee and the fan-in —
    the tee blocks on the unqueued branch while the fan-in waits for the
    other, the textbook launch-string deadlock."""
    from nnstreamer_tpu_torch.elements.flow import Tee

    _unqueued_join_scan(
        pipeline, report, "NNS-W103",
        lambda f: isinstance(f, Tee),
        lambda f: "tee",
        "insert 'queue' after each tee branch",
    )


# -- nns-san deadlock/capacity pass (graph side of the sanitizer) -----------

#: Codes the graph-level deadlock/capacity analysis can produce
#: (`nns-san --deadlock` filters a full lint run down to these).
DEADLOCK_CODES = frozenset(
    {"NNS-E002", "NNS-W103", "NNS-W108", "NNS-W109", "NNS-W110"}
)


def _capacity_pass(pipeline: Pipeline, report: LintReport) -> None:
    """NNS-W108: bounded channels sized so they cannot do their job. The
    batch channel is the batching element's own input queue
    (``queue-size``): a ``queue`` stays a node of its own in the port, so
    its ``max-size-buffers`` bounds the queue's inbox, never the consumer's
    (the reference eliminates the queue into the consumer's channel)."""
    for e in pipeline.elements:
        qs = getattr(e, "queue_size", None)
        if qs is not None and qs <= 0:
            report.add(
                "NNS-W108", e.name,
                f"queue-size={qs} is non-positive; the executor clamps it "
                "to 1, so every put parks the producer",
                "size the channel for the expected burst",
            )
            continue
        raw = e.get_property("batching")
        if raw is None or not parse_bool(raw):
            continue
        try:
            mb = int(e.get_property("max-batch", 8))
        except (TypeError, ValueError):
            continue  # NNS-E005 already covers the bad value
        depth = e.queue_size
        if mb > depth:
            report.add(
                "NNS-W108", e.name,
                f"max-batch={mb} exceeds the input channel depth "
                f"({depth}); a full batch can never assemble",
                "deepen the input channel (queue-size) above max-batch",
            )


def _fanout_join_pass(pipeline: Pipeline, report: LintReport) -> None:
    """NNS-W109: the NNS-W103 blocking topology generalized to non-tee
    fan-outs (demux/split/crop): a fan-in whose branches share a
    multi-src-pad ancestor with no intervening queue on some branch."""
    from nnstreamer_tpu_torch.elements.flow import Tee

    _unqueued_join_scan(
        pipeline, report, "NNS-W109",
        lambda f: len(pipeline.out_links(f)) >= 2
        and not isinstance(f, Tee),  # tee: NNS-W103's case
        lambda f: f.FACTORY_NAME,
        "insert 'queue' after each fan-out branch",
    )


def _may_drop_frames(e: Element, pipeline: Pipeline) -> Optional[str]:
    """Reason string when `e` drops frames data-dependently, else None."""
    from nnstreamer_tpu_torch.elements.control import TensorIf

    if isinstance(e, TensorIf):
        if "SKIP" in (e.then_action, e.else_action):
            return "tensor_if with a SKIP action"
        return None
    raw = e.get_property("on-error")
    if raw is None:
        return None
    mode = str(raw).strip().lower()
    if mode == "drop":
        return "on-error=drop"
    if mode == "retry":
        err_pad = getattr(e, "error_pad", None)
        routed = err_pad is not None and any(
            l.src_pad == err_pad for l in pipeline.out_links(e)
        )
        if not routed:
            return "on-error=retry with no dead-letter pad linked"
    return None


def _skewed_join_pass(pipeline: Pipeline, report: LintReport) -> None:
    """NNS-W110: a synchronizing fan-in (mux/merge, sync-mode != nosync)
    with a data-dependent frame dropper on a strict subset of branches —
    the join waits forever for counterparts of skipped frames."""
    from nnstreamer_tpu_torch.elements.routing import TensorMerge, TensorMux

    for m in pipeline.elements:
        if not isinstance(m, (TensorMux, TensorMerge)):
            continue
        if str(m.get_property("sync-mode", "slowest")).lower() == "nosync":
            continue
        ins = pipeline.in_links(m)
        if len(ins) < 2:
            continue
        droppers: Dict[int, str] = {}
        for l, anc in zip(ins, _branch_ancestors(pipeline, ins)):
            for e in anc:
                reason = _may_drop_frames(e, pipeline)
                if reason is not None:
                    droppers[l.dst_pad] = f"{e.name} ({reason})"
                    break
        if droppers and len(droppers) < len(ins):
            detail = "; ".join(
                f"sink_{pad}: {who}" for pad, who in sorted(droppers.items())
            )
            report.add(
                "NNS-W110", m.name,
                "synchronizing fan-in has data-dependent droppers on a "
                f"subset of its branches ({detail}); pads fill at "
                "different rates and the sync policy can starve",
                "drop on every branch symmetrically, use sync-mode=nosync,"
                " or dead-letter failures instead of dropping",
            )


def _admission_pass(pipeline: Pipeline, report: LintReport) -> None:
    """NNS-W111: a query server launched without any admission bound —
    every client is accepted and every request queued forever, so
    overload shows up as latency collapse instead of structured NACKs."""
    from nnstreamer_tpu_torch.edge.query import TensorQueryServerSrc

    bounds = ("max-clients", "max-inflight", "per-client-inflight", "rate")
    for e in pipeline.elements:
        if not isinstance(e, TensorQueryServerSrc):
            continue
        bounded = False
        for key in bounds:
            raw = e.get_property(key)
            if raw is None:
                continue
            try:
                if float(raw) > 0:
                    bounded = True
                    break
            except (TypeError, ValueError):
                bounded = True  # NNS-E005 already covers the bad value
                break
        if not bounded:
            report.add(
                "NNS-W111", e.name,
                "no admission bound set; overload degrades as unbounded "
                "queueing and silent latency collapse",
                "set max-clients / max-inflight / per-client-inflight / "
                "rate",
            )


def _fleet_failover_pass(pipeline: Pipeline, report: LintReport) -> None:
    """NNS-W119: single-endpoint-no-failover — a tensor_query_client
    that stamps a per-request SLO (``deadline-ms``) cares about
    tail latency, yet binds exactly ONE endpoint with ``retry-max=0``:
    a dead or draining server is then a terminal error per frame, with
    no reconnect, no failover target, and no hedge."""
    from nnstreamer_tpu_torch.edge.fleet import parse_hosts
    from nnstreamer_tpu_torch.edge.query import TensorQueryClient

    for e in pipeline.elements:
        if not isinstance(e, TensorQueryClient):
            continue
        hosts = e.get_property("hosts")
        if hosts:
            try:
                if len(parse_hosts(hosts)) > 1:
                    continue  # a real fleet: failover targets exist
            except ValueError:
                continue  # NNS-E011 already covers the bad value
        try:
            deadline = float(e.get_property("deadline-ms") or 0.0)
            retry_max = int(e.get_property("retry-max") or 0)
        except (TypeError, ValueError):
            continue  # NNS-E005 already covers the bad value
        if deadline > 0 and retry_max <= 0:
            report.add(
                "NNS-W119", e.name,
                f"deadline-ms={deadline:.0f} with one endpoint and "
                "retry-max=0: an endpoint hiccup is a terminal error "
                "with no failover",
                "bind a fleet (hosts=h1:p1,h2:p2,...) or set retry-max",
            )


def _llm_drain_loss_pass(pipeline: Pipeline, report: LintReport) -> None:
    """NNS-W126: llm-drain-loses-generations — an explicitly tuned
    ``retry-after-ms`` on a query serversrc is the fleet-drain
    contract's fingerprint: the operator expects clients to re-route
    on ``draining`` NACKs during rolling restarts. An LLM serversink
    behind such a serversrc with NO migrate-to peer and NO
    checkpoint-dir turns every one of those drains into lost work —
    the in-flight generations' KV and decoded tokens are abandoned and
    the re-routed requests re-prefill from token zero
   . The explicit-set
    check matters: retry-after-ms DEFAULTS to 50, so only an operator
    who wrote it down has promised drain semantics."""
    from nnstreamer_tpu_torch.edge.query import TensorQueryServerSrc
    from nnstreamer_tpu_torch.elements.llm_serve import LlmServerSink

    if not any(
        isinstance(e, TensorQueryServerSrc)
        and e.get_property("retry-after-ms") is not None
        for e in pipeline.elements
    ):
        return
    for e in pipeline.elements:
        if not isinstance(e, LlmServerSink):
            continue
        if e.get_property("plane"):
            continue  # plane-shared batchers refuse migration by design
        if e.get_property("migrate-to") or e.get_property("checkpoint-dir"):
            continue
        report.add(
            "NNS-W126", e.name,
            "fleet drain is tuned (serversrc retry-after-ms) but this "
            "LLM server can neither migrate nor recover its in-flight "
            "generations: a drain abandons their KV and decoded "
            "tokens, and re-routed clients pay full re-prefill",
            "set migrate-to=host:port (live KV-span migration) and/or "
            "checkpoint-dir (crash recovery); both need "
            "kv-layout=paged",
        )


def _disagg_role_pass(pipeline: Pipeline, report: LintReport) -> None:
    """NNS-W130: prefill-role-no-decode-peer — role=prefill is a
    promise that prefilled requests LEAVE: their KV spans ship to a
    decode peer and this server's pool churns through prompt
    processing only. A
    prefill server with no decode-peers keeps every generation local —
    the colocated behavior the operator explicitly opted out of — and
    with no checkpoint-dir a drain of that unexpected decode load
    abandons it."""
    from nnstreamer_tpu_torch.elements.llm_serve import LlmServerSink

    for e in pipeline.elements:
        if not isinstance(e, LlmServerSink):
            continue
        if str(e.get_property("role") or "") != "prefill":
            continue
        if str(e.get_property("decode-peers") or "").strip():
            continue
        if e.get_property("checkpoint-dir"):
            continue
        report.add(
            "NNS-W130", e.name,
            "role=prefill with no decode-peers: every prefilled "
            "request decodes locally, so the configured "
            "disaggregation never happens and drains abandon the "
            "unexpected local decode load",
            "set decode-peers=host:port[/llm-id],... (KV-span "
            "handoff to the decode tier) or drop role=prefill; "
            "checkpoint-dir at least recovers drains",
        )


def _replica_failover_pass(pipeline: Pipeline, report: LintReport) -> None:
    """NNS-W112: replicas=N promises the stream survives a dying
    replica, but with the default on-error=stop the day EVERY replica is
    down (ReplicaExhaustedError) the whole pipeline dies with it — and
    in a serving pipeline the admitted clients hang instead of getting
    terminal NACKs. A failover deployment needs a disposal policy."""
    from nnstreamer_tpu_torch.elements.filter import TensorFilter
    from nnstreamer_tpu_torch.pipeline.faults import resolve_fault_policy

    for e in pipeline.elements:
        if not isinstance(e, TensorFilter):
            continue
        try:
            n = int(e.get_property("replicas") or 0)
        except (TypeError, ValueError):
            continue  # NNS-E005 already covers the bad value
        if n <= 1:
            continue
        try:
            policy = resolve_fault_policy([e])
        except Exception:  # noqa: BLE001 — bad policy props have their
            continue       # own diagnostics
        if not policy.active:
            report.add(
                "NNS-W112", e.name,
                f"replicas={n} with on-error=stop: replica exhaustion "
                "kills the pipeline instead of disposing frames "
                "(drop/route/retry + NACK for admitted requests)",
                "set on-error=drop|route|retry on the replicated filter",
            )


def _model_sharing_pass(pipeline: Pipeline, report: LintReport) -> None:
    """NNS-W114: duplicate model, no sharing — two+ tensor_filter
    instances naming the same model/framework without a
    ``shared-tensor-filter-key`` or a serving ``plane`` each open their
    own backend: N copies of the weights resident on device where one
    would serve. Replicated filters
    (``replicas=N``) duplicate on purpose and are exempt."""
    from nnstreamer_tpu_torch.elements.filter import TensorFilter

    groups: Dict[tuple, List] = {}
    for e in pipeline.elements:
        if not isinstance(e, TensorFilter):
            continue
        model = str(e.get_property("model") or "").strip()
        if not model:
            continue  # model-less fakes: nothing resident to duplicate
        if str(e.get_property("shared-tensor-filter-key") or "").strip():
            continue
        if str(e.get_property("plane") or "").strip():
            continue
        try:
            if int(e.get_property("replicas") or 0) > 1:
                continue  # deliberate copies (failover)
        except (TypeError, ValueError):
            pass  # NNS-E005 already covers the bad value
        fw = str(e.get_property("framework") or "auto").strip()
        groups.setdefault((fw, model), []).append(e)
    for (fw, model), elems in groups.items():
        if len(elems) < 2:
            continue
        names = ", ".join(e.name for e in elems)
        for e in elems:
            report.add(
                "NNS-W114", e.name,
                f"model {model!r} ({fw}) is opened {len(elems)}x "
                f"without sharing ({names}): {len(elems)} weight "
                "copies resident where one would serve",
                "set one shared-tensor-filter-key on the group, or "
                "serve them through a plane=<name>",
            )


def _plane_async_pass(pipeline: Pipeline, report: LintReport) -> None:
    """NNS-W118: blocking plane submits under a ring
   . Two shapes, both static property reads:

    - a plane filter with ``ring-depth>1`` but ``batching=false``: the
      async ticket ring rides the host WINDOW loop, so disabling the
      local collector forces per-frame blocking submits and the ring
      never engages;
    - two or more streams of the same plane in this pipeline with every
      in-flight depth left at 1 (no ``ring-depth`` and ``[plane]
      inflight = 1``): each stream blocks a full plane round trip per
      window — exactly the multi-stream shape async submits exist for.
    """
    from nnstreamer_tpu_torch.elements.filter import TensorFilter

    def _depth(e) -> Optional[int]:
        raw = e.get_property("ring-depth")
        if raw is None:
            return None
        try:
            return max(1, int(raw))
        except (TypeError, ValueError):
            return None  # NNS-W101/E005 already covers the bad value

    cfg_inflight = 1
    try:
        from nnstreamer_tpu_torch.serving_plane.plane import _plane_defaults

        cfg_inflight = max(1, int(_plane_defaults()["inflight"]))
    except Exception:  # noqa: BLE001 — a broken ini has its own warning
        pass
    groups: Dict[str, List] = {}
    for e in pipeline.elements:
        if not isinstance(e, TensorFilter):
            continue
        if not str(e.get_property("plane") or "").strip():
            continue
        groups.setdefault(str(e.get_property("plane")).strip(), []).append(e)
        depth = _depth(e)
        raw_batching = e.get_property("batching")
        batching_off = (
            raw_batching is not None
            and str(raw_batching).strip().lower() in ("false", "0", "no")
        )
        if depth is not None and depth > 1 and batching_off:
            report.add(
                "NNS-W118", e.name,
                f"ring-depth={depth} with batching=false: the async "
                "in-flight ring rides the window collector, so this "
                "stream still submits per frame, blocking a full plane "
                "round trip each time",
                "drop batching=false (plane filters default the "
                "collector on, window-matched to the plane)",
            )
    for pname, elems in groups.items():
        if len(elems) < 2:
            continue
        depths = [(_depth(e) or cfg_inflight) for e in elems]
        if any(d > 1 for d in depths):
            continue
        names = ", ".join(e.name for e in elems)
        report.add(
            "NNS-W118", elems[0].name,
            f"{len(elems)} streams share plane {pname!r} with every "
            f"in-flight depth at 1 ({names}): each blocks a full plane "
            "round trip per window instead of overlapping submits",
            "set ring-depth=2..3 on the plane filters (or [plane] "
            "inflight = 2) to pipeline submit/compute/delivery",
        )


def _kv_cache_pass(pipeline: Pipeline, report: LintReport) -> None:
    """NNS-W115 + NNS-W117: KV caches that cannot fit their declared
    memory bound (``kv-memory-bound`` prop, or ``[llm] memory_bound``).

    - W115: a slot-layout cache (2 · L · n-slots · max-len · KV · Dh,
      every slot sized for the worst case) exceeds the bound while
      ``kv-layout=paged`` is available.
    - W117: a PAGED element pinned to ``kv-attn=gather``, whose step
      programs materialize the full contiguous per-slot view (slot-
      cache-sized) BESIDE the block arena — the transient footprint
      arena + view exceeds the bound. The block-native default has no
      gathered view, so the fix is simply dropping the pin.

    Static estimates from the element's props and custom model options
    — no model is loaded (the sink is LINT_SKIP_NEGOTIATE for exactly
    that reason)."""
    from nnstreamer_tpu_torch.backends.base import FilterProps
    from nnstreamer_tpu_torch.config import conf
    from nnstreamer_tpu_torch.elements.llm_serve import LlmServerSink
    from nnstreamer_tpu_torch.analysis.costmodel import parse_bytes

    for e in pipeline.elements:
        if not isinstance(e, LlmServerSink):
            continue
        layout = str(e.get_property("kv-layout") or "").strip() or (
            conf().get("llm", "kv_layout", "slot")
        )
        bound_raw = str(e.get_property("kv-memory-bound") or "").strip()
        if not bound_raw:
            bound_raw = conf().get("llm", "memory_bound", "").strip()
        if not bound_raw:
            continue  # no declared bound: nothing to check against
        try:
            bound = parse_bytes(bound_raw)
        except (TypeError, ValueError):
            continue  # NNS-E005-shaped value; not this pass's finding
        opts = FilterProps(
            custom=str(e.get_property("custom") or "")
        ).custom_dict()
        # zoo:transformer_lm defaults (models/zoo.py)
        d_model = int(opts.get("d_model", 256))
        n_layers = int(opts.get("n_layers", 4))
        n_heads = int(opts.get("n_heads", 8)) or 1
        n_kv = int(opts.get("n_kv_heads", n_heads))
        hd = d_model // n_heads
        cache_dtype = str(e.get_property("cache-dtype") or "auto")
        if cache_dtype == "int8":
            per_elem = 1.0 + 4.0 / max(hd, 1)  # int8 payload + scales
        else:
            dt = str(opts.get("compute_dtype", "float32"))
            per_elem = 2.0 if dt == "bfloat16" else 4.0
        n_slots = int(e.get_property("n-slots") or 4)
        max_len = int(e.get_property("max-len") or 256)
        # the slot cache — which is ALSO the gathered view's shape
        view = int(2 * n_layers * n_slots * max_len * n_kv * hd * per_elem)
        if layout == "paged":
            attn = str(e.get_property("kv-attn") or "").strip() or (
                conf().get("llm", "kv_attn", "auto")
            )
            if attn != "gather":
                continue  # block-native: no gathered view to flag
            bs = int(e.get_property("block-size") or 0) or (
                conf().get_int("llm", "block_size", 16)
            ) or 16
            kv_blocks = int(e.get_property("kv-blocks") or 0) or (
                conf().get_int("llm", "kv_blocks", 0)
            )
            if kv_blocks <= 0:  # no-saving auto default (serving.py)
                kv_blocks = n_slots * (-(-max_len // bs))
            arena = int(
                2 * n_layers * (kv_blocks + 1) * bs * n_kv * hd * per_elem
            )
            est = arena + view
            if est <= bound:
                continue
            report.add(
                "NNS-W117", e.name,
                f"kv-attn=gather materializes the contiguous view ≈ "
                f"{view / (1 << 20):.0f} MiB beside the "
                f"{arena / (1 << 20):.0f} MiB block arena every step — "
                f"transient ≈ {est / (1 << 20):.0f} MiB exceeds the "
                f"declared bound {bound_raw}",
                "drop kv-attn=gather (the block-native default attends "
                "the arena directly through the block tables, no "
                "gathered view); keep the gather "
                "oracle for parity debugging only",
            )
            continue
        if view <= bound:
            continue
        report.add(
            "NNS-W115", e.name,
            f"slot-layout KV cache ≈ {view / (1 << 20):.0f} MiB "
            f"(2·L{n_layers}·slots{n_slots}·len{max_len}·kv{n_kv}·"
            f"hd{hd}) exceeds the declared bound {bound_raw} — every "
            "slot is sized for the worst-case request",
            "set kv-layout=paged (block-table arena sized by kv-blocks "
            "to the bound; prefix sharing and chunked prefill come "
            "with it)",
        )


def _resident_handoff_pass(pipeline: Pipeline, report: LintReport) -> None:
    """NNS-W113/W116/W120: a host-bound element between two
    device-capable (traceable) filters forces every frame through host
    memory and back mid-stream — the resident device-to-device segment
    handoff only works across contiguous device
    segments and pure plumbing (queue/capsfilter/tee carry device
    arrays untouched). The predicates live in analysis/xray.py (shared
    with the chain analyzer so the two can never disagree about what
    splits a chain); capability is read STATICALLY from the backend
    class — no backend open, no model load. ONE code per boundary:
    W116 when the split is a decoder with an unused device path (a
    one-property fix), W120 when a host-path tensor op severs a
    compileable chain, W113 for host elements
    outside the tensor-op surface (a structural restructure)."""
    from nnstreamer_tpu_torch.analysis.xray import (
        decoder_will_fuse,
        host_bound,
        host_postproc_with_device_path,
        reaches_capable,
    )
    from nnstreamer_tpu_torch.elements.base import TensorOp

    def ups(e):
        return [ln.src for ln in pipeline.in_links(e)]

    def downs(e):
        return [ln.dst for ln in pipeline.out_links(e)]

    for e in pipeline.elements:
        if not host_bound(e) or decoder_will_fuse(e):
            continue
        if not (reaches_capable(e, ups) and reaches_capable(e, downs)):
            continue
        if host_postproc_with_device_path(e):
            # the specific diagnostic wins: there IS a device path, so
            # the fix is one property, not a pipeline restructure
            report.add(
                "NNS-W116", e.name,
                "fusable decoder runs as a host node between two "
                "device segments: its (large) inputs materialize to "
                "host every frame although the decode has a device "
                "path",
                "set postproc=device to fold the decode into the "
                "adjacent fused segment",
            )
            continue
        if isinstance(e, TensorOp):
            # host-path tensor op (host-backend filter, non-traceable
            # op, device-path-less decoder) severing a chain: the
            # chain-granular diagnostic (nns-xray reports the same
            # boundary with the chains it severs)
            report.add(
                "NNS-W120", e.name,
                "host-path op severs an otherwise compileable chain "
                "of fused segments: frames materialize to host and "
                "re-stage to device here every frame",
                "give this op a device-capable framework/traceable "
                "path, or move it outside the device span",
            )
            continue
        report.add(
            "NNS-W113", e.name,
            "host-bound element between two device-capable filters: "
            "frames materialize to host and back mid-stream, "
            "defeating the resident segment handoff",
            "move the host step before/after the device chain, or "
            "give it a traceable equivalent",
        )


# -- pass 4: resources -------------------------------------------------------

def _resource_pass(
    pipeline: Pipeline, report: LintReport
) -> Set[str]:
    """NNS-E006/E007/E008/W102. Returns names whose negotiate() would fail
    for an already-reported reason (the spec pass skips them)."""
    from nnstreamer_tpu_torch.elements.converter import TensorConverter
    from nnstreamer_tpu_torch.elements.decoder import TensorDecoder
    from nnstreamer_tpu_torch.elements.filter import TensorFilter

    skip: Set[str] = set()
    for e in pipeline.elements:
        if isinstance(e, TensorFilter):
            fw = e.fprops.framework
            if not registry.exists(registry.KIND_FILTER, fw):
                known = registry.available(registry.KIND_FILTER)
                report.add(
                    "NNS-E006", e.name,
                    f"framework={fw!r} names no registered backend",
                    f"available: {', '.join(known)}",
                )
                skip.add(e.name)
            for model in e.fprops.model:
                if model.startswith("zoo:"):
                    continue  # resolved from the in-package model zoo
                if not os.path.exists(model):
                    report.add(
                        "NNS-W102", e.name,
                        f"model file {model!r} does not exist",
                        "the path is resolved at open time, relative to "
                        "the working directory",
                    )
                    skip.add(e.name)
        elif isinstance(e, TensorDecoder):
            if e.mode and e.mode != "custom-code" \
                    and not registry.exists(registry.KIND_DECODER, e.mode):
                known = registry.available(registry.KIND_DECODER)
                report.add(
                    "NNS-E007", e.name,
                    f"mode={e.mode!r} names no registered decoder",
                    f"available: {', '.join(known)}",
                )
                skip.add(e.name)
        elif isinstance(e, TensorConverter):
            mode = e.mode
            if mode and not str(mode).startswith("custom-") \
                    and not registry.exists(registry.KIND_CONVERTER, str(mode)):
                known = registry.available(registry.KIND_CONVERTER)
                report.add(
                    "NNS-E008", e.name,
                    f"mode={mode!r} names no registered converter",
                    f"available: {', '.join(known)}",
                )
                skip.add(e.name)
    return skip


# -- pass 2: dry-run spec flow -----------------------------------------------

def _spec_pass(
    pipeline: Pipeline,
    report: LintReport,
    placeholders: Set[str],
    skip: Set[str],
) -> Dict[str, List[Any]]:
    """Run every element's negotiate() on a shallow CLONE in topological
    order, collecting ALL NegotiationErrors. Returns name → out_specs of
    the clones (for dot annotation). The user's pipeline is untouched and
    nothing is started."""
    order, _ = pipeline.toposort_partial()
    clones: Dict[Element, Element] = {}
    for e in order:
        c = copy.copy(e)
        c.in_specs = []
        c.out_specs = []
        clones[e] = c
    specs_out: Dict[str, List[Any]] = {}
    try:
        for e in order:
            clone = clones[e]
            n_sinks = pipeline.n_sinks(e)
            n_srcs = pipeline.n_srcs(e)
            in_specs: List[Any] = [None] * n_sinks
            for l in pipeline.in_links(e):
                if not (0 <= l.dst_pad < n_sinks):
                    continue  # sparse pad numbering: NNS-E001 already filed
                up = clones.get(l.src)
                if up is not None and l.src_pad < len(up.out_specs):
                    in_specs[l.dst_pad] = up.out_specs[l.src_pad]
            unknown_inputs = n_sinks > 0 and any(s is None for s in in_specs)
            not_linked = len(pipeline.in_links(e)) < n_sinks
            if (
                e.name in placeholders
                or e.name in skip
                or unknown_inputs
                or not_linked
                or type(e).LINT_SKIP_NEGOTIATE
            ):
                clone.out_specs = [None] * n_srcs
                continue
            if isinstance(e, Routing):
                clone.set_pad_counts(n_sinks, n_srcs)
            try:
                clone.fix_negotiation(in_specs)
                if len(clone.out_specs) != n_srcs:
                    raise ValueError(
                        f"negotiated {len(clone.out_specs)} specs for "
                        f"{n_srcs} src pads"
                    )
            except Exception as exc:
                report.add(
                    "NNS-E003", e.name,
                    f"negotiation would fail: {exc}",
                    "check upstream dimensions/types against what this "
                    "element accepts",
                )
                clone.out_specs = [None] * n_srcs
                continue
            specs_out[e.name] = list(clone.out_specs)
    finally:
        for e, clone in clones.items():
            # The only resource negotiate() opens is a tensor_filter
            # backend. Release it IF the clone opened its own; never call
            # a generic clone.stop() — shallow copies share the original's
            # live files/sockets, and stopping them would close resources
            # of a started user pipeline.
            opened = getattr(clone, "backend", None)
            if opened is not None and opened is not getattr(e, "backend", None):
                try:
                    clone.stop()
                except Exception as exc:
                    _log.debug("clone cleanup for %s failed: %s",
                               e.name, exc)
    return specs_out


# -- entry point -------------------------------------------------------------

def lint(target: Union[str, Pipeline], device: DeviceLike = None) -> LintResult:
    """Statically analyze a launch string or a constructed Pipeline.

    Returns a :class:`LintResult`; ``result.exit_code`` follows the
    0/1/2 = clean/warnings/errors contract. The pipeline is never started.
    A launch string is built on ``device`` (default ``cuda``: without a
    GPU this raises :class:`~nnstreamer_tpu_torch.device.NoDeviceError`
    unless ``device="cpu"``); a Pipeline keeps its own device.
    """
    report = LintReport()
    placeholders: Set[str] = set()
    if isinstance(target, str):
        from nnstreamer_tpu_torch.device import resolve_device

        device = resolve_device(device)  # no GPU and no CPU request: raise
        pipeline = _build_tolerant(target, report, placeholders, device)
        if pipeline is None:
            return LintResult(report, None, {})
    else:
        pipeline = target
        for e in pipeline.elements:
            check_properties(type(e), e.props, e.name, report)
    skip = _resource_pass(pipeline, report)
    cyclic = _structure_pass(pipeline, report, placeholders)
    _tee_pass(pipeline, report)
    _capacity_pass(pipeline, report)
    _fanout_join_pass(pipeline, report)
    _skewed_join_pass(pipeline, report)
    _admission_pass(pipeline, report)
    _fleet_failover_pass(pipeline, report)
    _llm_drain_loss_pass(pipeline, report)
    _disagg_role_pass(pipeline, report)
    _replica_failover_pass(pipeline, report)
    _resident_handoff_pass(pipeline, report)
    _model_sharing_pass(pipeline, report)
    _plane_async_pass(pipeline, report)
    _kv_cache_pass(pipeline, report)
    specs: Dict[str, List[Any]] = {}
    if not cyclic:
        specs = _spec_pass(pipeline, report, placeholders, skip)
        # NNS-W129 (nns-kscope): an explicit kernel request that would
        # raise on the card — needs the negotiated specs for the dtypes
        from nnstreamer_tpu_torch.analysis.kernels import kernel_request_pass

        kernel_request_pass(pipeline, report, specs)
    return LintResult(report, pipeline, specs)


def annotated_dot(result: LintResult) -> str:
    """Graphviz dump with diagnostics painted onto the offending nodes and
    the dry-run negotiated specs on the clean ones."""
    if result.pipeline is None:
        return 'digraph "unparseable" {}'
    return result.pipeline.dump_dot(
        diagnostics=result.diagnostics,
        specs=result.negotiated_specs,
    )
