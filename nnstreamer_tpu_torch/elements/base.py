"""Element model: the composable stages of a pipeline.

The counterpart of ``nnstreamer_tpu/elements/base.py``:

- ``negotiate(in_specs) -> out_specs`` runs once at pipeline build time
  over the whole graph (topological order), producing static specs;
- :class:`TensorOp` — 1→1 pure tensor function over torch tensors
  (tensor_converter, tensor_transform, tensor_filter, tensor-math
  decoders). Consecutive TensorOps fuse into one callable per segment
  (pipeline/graph.py).
- :class:`HostElement` — 1→1 per-frame element with its own state
  (tensor_if, tensor_aggregator, tensor_rate, the sparse codecs): a
  fusion barrier.
- :class:`Routing` — N→M element with its own buffering and sync
  (mux, demux, tee, merge, split, join, crop); its pad counts may be
  request pads (``None``), fixed by the links at build time.
- :class:`Source` / :class:`Sink` — stream endpoints.

Media (non-tensor) links carry :class:`MediaSpec`; converters translate
between MediaSpec and TensorsSpec edges.
"""

from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

from nnstreamer_tpu_torch.tensors.frame import Frame
from nnstreamer_tpu_torch.tensors.spec import TensorFormat, TensorsSpec


@dataclass(frozen=True)
class MediaSpec:
    """Spec of a raw-media link (reference caps video/x-raw, audio/x-raw)."""

    media_type: str  # "video" | "audio" | "text" | "octet"
    width: Optional[int] = None
    height: Optional[int] = None
    format: str = "RGB"  # RGB | BGR | RGBA | BGRx | GRAY8
    channels: Optional[int] = None
    sample_rate: Optional[int] = None
    sample_format: str = "S16LE"
    rate: Optional[Fraction] = None  # frames per second

    @property
    def channels_per_pixel(self) -> int:
        return {"RGB": 3, "BGR": 3, "RGBA": 4, "BGRx": 4, "GRAY8": 1}[self.format]


Spec = Union[TensorsSpec, MediaSpec]


class NegotiationError(ValueError):
    """Spec mismatch at pipeline build (reference: caps negotiation failure)."""


class ElementError(RuntimeError):
    pass


# Wildcard key: an element whose PROPERTIES contains PROPS_ANY accepts
# arbitrary extra properties (capsfilter carries raw caps fields).
PROPS_ANY = "*"


@dataclass(frozen=True)
class PropSpec:
    """Declared schema of one element property (GObject GParamSpec
    analogue). type: "str" | "int" | "float" | "bool" | "fraction" |
    "enum"; choices: allowed values when type == "enum"."""

    type: str = "str"
    default: Any = None
    choices: Tuple[str, ...] = ()
    desc: str = ""


def parse_bool(v) -> bool:
    if isinstance(v, str):
        return v.strip().lower() in ("1", "true", "yes", "on")
    return bool(v)


# -- the fault property surface (pipeline/faults.py, device_faults.py) -----
# Declared here so element modules can spread the schema without importing
# the pipeline package.

ON_ERROR_CHOICES = ("stop", "drop", "retry", "route")

#: spread into the PROPERTIES of every element with per-frame error
#: policies; pipeline/faults.py resolves them over the [executor] defaults
FAULT_PROPS: Dict[str, PropSpec] = {
    "on-error": PropSpec(
        "enum", None, ON_ERROR_CHOICES,
        desc="per-frame error policy: stop (default) | drop | retry | route",
    ),
    "retry-max": PropSpec("int", None, desc="retry attempts before degrading (default 3)"),
    "retry-backoff-ms": PropSpec(
        "float", None, desc="base retry backoff, doubled per attempt, jittered (default 10.0)"),
}

#: spread into tensor_filter's PROPERTIES; pipeline/device_faults.py
#: resolves them over the [executor] defaults
DEVICE_PROPS: Dict[str, PropSpec] = {
    "oom-policy": PropSpec(
        "enum", None, ("degrade", "stop"),
        desc="on device OOM: degrade (shrink the batch bucket, remember the safe "
        "ceiling, re-probe after a cooldown) or stop (default degrade)",
    ),
    "device-fallback": PropSpec(
        "bool", None,
        desc="while the segment's CUDA graphs fail (a failed capture, repeated "
        "device faults), run its ops eagerly on the same device, counted, and "
        "probe the graphs for recovery (default true)",
    ),
}


def install_error_pad(elem: "Element") -> None:
    """Expose the dead-letter error pad on ``elem`` when its ``on-error``
    says ``route``, or ``retry`` (whose exhausted frames go to the pad when
    it is linked, else drop). Called from the ``__init__`` of every element
    class that declares :data:`FAULT_PROPS`. The pad is src pad
    ``N_SRCS`` (``src_1``); negotiation gives it a flexible spec, and a
    LINKED error pad keeps the element out of fused segments, since routing
    needs a per-frame invoke."""
    raw = elem.get_property("on-error")
    if raw is None:
        return
    mode = str(raw).strip().lower()
    if mode not in ON_ERROR_CHOICES:
        raise ValueError(
            f"{elem.name}: on-error={raw!r} not one of {'/'.join(ON_ERROR_CHOICES)}")
    if mode not in ("route", "retry"):
        return
    if type(elem).N_SRCS != 1:
        raise ValueError(
            f"{elem.name}: on-error={mode} needs exactly one src pad "
            f"(got N_SRCS={type(elem).N_SRCS})")
    # an instance attribute: only THIS element grows the extra pad
    elem.N_SRCS = 2
    elem.error_pad = 1


class Element:
    """Base element. Subclasses set N_SINKS/N_SRCS (None = request pads,
    decided at link time) and implement negotiate(). ``device`` is the
    pipeline's torch device, assigned when the element is added to a
    :class:`~nnstreamer_tpu_torch.pipeline.graph.Pipeline`."""

    FACTORY_NAME = "element"
    N_SINKS: Optional[int] = 1
    N_SRCS: Optional[int] = 1

    # A host-path node that places its frames itself gets them where they
    # arrive instead of moved to the device first: pure plumbing (queue)
    # never reads tensor bytes; a converter subplugin parses them on the
    # host and moves its output tensors up.
    DEVICE_PASSTHROUGH: bool = False

    # An element that reads its frames' bytes on the host declares this:
    # the node before it then starts ONE coalesced asynchronous D2H a frame
    # at submit and hands it the host copy (pipeline/transfer.py). Any other
    # consumer gets device tensors untouched.
    WANTS_HOST: bool = False

    # the dead-letter error pad (install_error_pad): its src pad index, or None
    error_pad: Optional[int] = None

    PROPERTIES: Dict[str, PropSpec] = {
        "name": PropSpec("str", None, desc="element instance name"),
        "queue-size": PropSpec(
            "int", 64, desc="input queue depth for this element's pads"
        ),
        "silent": PropSpec("bool", True, desc="suppress per-frame logging"),
    }

    _instance_counters: Dict[str, int] = {}

    @classmethod
    def property_schema(cls) -> Dict[str, PropSpec]:
        """Merged property schema over the class MRO (subclass wins)."""
        schema: Dict[str, PropSpec] = {}
        for klass in reversed(cls.__mro__):
            own = klass.__dict__.get("PROPERTIES")
            if own:
                schema.update(own)
        return schema

    def __init__(self, name: Optional[str] = None, **props: Any) -> None:
        if name is None:
            n = Element._instance_counters.get(self.FACTORY_NAME, 0)
            Element._instance_counters[self.FACTORY_NAME] = n + 1
            name = f"{self.FACTORY_NAME}{n}"
        self.name = name
        self.props: Dict[str, Any] = {}
        self.in_specs: List[Spec] = []
        self.out_specs: List[Spec] = []
        self.device = torch.device("cpu")
        self.queue_size = int(props.pop("queue-size", props.pop("queue_size", 64)))
        self.silent = parse_bool(props.pop("silent", True))
        # downstream QoS publishers (tensor_rate's drop-ahead hint):
        # producers consult these and skip frames the limiter would drop
        self.qos_sources: List[Any] = []
        schema = self.property_schema()
        for k, v in props.items():
            if k.replace("_", "-") not in schema and PROPS_ANY not in schema:
                raise ValueError(f"{self.name}: unknown property {k!r}")
            self.set_property(k, v)

    def set_property(self, key: str, value: Any) -> None:
        self.props[key.replace("_", "-")] = value

    def get_property(self, key: str, default: Any = None) -> Any:
        return self.props.get(key.replace("_", "-"), default)

    def negotiate(self, in_specs: List[Spec]) -> List[Spec]:
        """Given upstream specs (one per sink pad), return src-pad specs.
        Raise NegotiationError on mismatch. Called once at build."""
        raise NotImplementedError

    def fix_negotiation(self, in_specs: List[Spec]) -> List[Spec]:
        self.in_specs = list(in_specs)
        outs = list(self.negotiate(list(in_specs)))
        if self.error_pad is not None and len(outs) == self.error_pad:
            # error frames carry the element's input tensors and error meta:
            # a flexible spec, which any sink accepts
            outs.append(TensorsSpec(format=TensorFormat.FLEXIBLE))
        self.out_specs = outs
        return self.out_specs

    def add_qos_source(self, qos: Any) -> None:
        if qos not in self.qos_sources:
            self.qos_sources.append(qos)

    def qos_would_drop(self, frame: Frame) -> bool:
        """True if a downstream rate limiter will certainly drop this
        frame, so the producer may skip its work (the reference's upstream
        QoS event, pulled instead of pushed)."""
        return any(q.would_drop(frame.pts, frame.duration) for q in self.qos_sources)

    def start(self) -> None:
        """Transition to streaming (open devices/models). Idempotent."""

    def stop(self) -> None:
        """Release streaming resources. Idempotent."""

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name!r}>"


class TensorOp(Element):
    """1→1 pure tensor element: contributes a fn over the frame's tensor
    tuple. Consecutive TensorOps fuse into one segment callable."""

    N_SINKS = 1
    N_SRCS = 1

    # Whether the op's fn may be captured into a CUDA graph (the fused
    # segment's program on CUDA, pipeline/graph.py). An op whose fn reads
    # a value back to the host, or allocates by a size the data decides,
    # sets this False; its segment then runs its ops eagerly on CUDA.
    CAPTURABLE: bool = True

    # Bumped whenever make_fn()'s result changes without a shape change
    # (a model hot swap through reload_model): part of the fused
    # segment's program cache key, so a same-shape reload is never served
    # the stale program.
    fn_version: int = 0

    # the node's batching counters (pipeline/batching.py BatchStats),
    # shared at plan time with the segment that runs this op
    batch_stats: Optional[Any] = None

    def make_fn(self) -> Callable[[Tuple[Any, ...]], Tuple[Any, ...]]:
        """The fn (tensors) -> tensors over torch tensors on ``device``,
        for the negotiated specs."""
        raise NotImplementedError

    def is_traceable(self) -> bool:
        """False → the op runs per frame through :meth:`host_process` in a
        segment of its own (a fusion barrier)."""
        return True

    def is_identity(self) -> bool:
        """True → the op's fn is the identity over its tensors (the
        passthrough backend): a segment of only-identity ops hands its
        frames on without running any program."""
        return False

    def is_layout_only(self) -> bool:
        """True → the op's fn only re-views its tensors (a new axis, a
        reshape; no arithmetic, and numpy arrays take it as torch tensors
        do): a segment of only such ops whose consumers all read host bytes
        runs on the host frame, so its frames never cross the card."""
        return self.is_identity()

    def is_batch_capable(self) -> bool:
        """True → the host path may collect a micro-batch and call the
        op's ``host_process_batch`` (a filter with a ``batchable``
        backend). Fused ops batch through their segment instead."""
        return False

    def host_process(self, frame: Frame) -> Union[Frame, List[Frame], None]:
        """Per-frame execution of a non-traceable op: a frame, a list of
        frames, or None (absorbed, e.g. a batching converter mid-batch)."""
        out = self.make_fn()(frame.tensors)
        return frame.with_tensors(out)

    def flush(self) -> List[Frame]:
        """Called at EOS on the host path; emit any buffered frames."""
        return []


class HostElement(Element):
    """1→1 host-path element with per-frame state (fusion barrier). Its
    frames arrive as they were produced: torch tensors on the device
    from a segment, numpy arrays from a source; an element that computes
    on them moves them with :meth:`Frame.to_device` itself."""

    N_SINKS = 1
    N_SRCS = 1

    def process(self, frame: Frame) -> Union[Frame, List[Frame], None]:
        """Process one frame; return 0..n output frames."""
        raise NotImplementedError

    def flush(self) -> List[Frame]:
        """Called at EOS; emit any buffered frames."""
        return []


class Source(Element):
    """Stream source: drives the pipeline from its own thread."""

    N_SINKS = 0
    N_SRCS = 1

    def negotiate(self, in_specs: List[Spec]) -> List[Spec]:
        return [self.output_spec()]

    def output_spec(self) -> Spec:
        raise NotImplementedError

    def generate(self):
        """Return the next Frame, or EOS_FRAME when exhausted."""
        raise NotImplementedError


class Sink(Element):
    """Stream sink: receives frames on its own thread.

    ``sync-window`` (default 1): how many frames the sink may trail the
    device stream. 1 renders each frame as it comes, through one coalesced
    D2H of its tensors; N > 1 collects N frames and fetches the whole
    window's tensors in ONE copy (pipeline/transfer.py ``fetch_window``).
    Order and EOS are unchanged. A sink that never reads tensor bytes
    (``READS_HOST = False``: fakesink) gets its frames untouched."""

    N_SINKS = 1
    N_SRCS = 0

    READS_HOST: bool = True

    PROPERTIES = {
        "sync-window": PropSpec("int", 1, desc="frames the sink may trail the device stream"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.sync_window = max(1, int(self.get_property("sync-window", 1)))

    def negotiate(self, in_specs: List[Spec]) -> List[Spec]:
        return []

    def render(self, frame: Frame) -> None:
        raise NotImplementedError

    def on_eos(self) -> None:
        """EOS notification (reference tensor_sink 'eos' signal)."""

    def host_frame(self, frame: Frame) -> Frame:
        """The frame as numpy, cast to the negotiated input dtypes."""
        spec = self.in_specs[0] if self.in_specs else None
        return frame.to_host(spec if isinstance(spec, TensorsSpec) else None)


class Routing(Element):
    """N→M element owning its buffering/sync semantics (mux, demux, tee,
    merge, split, join, crop). The executor feeds it per pad and forwards
    its (src_pad, frame) emissions; EOS goes downstream once every sink
    pad saw it."""

    N_SINKS: Optional[int] = None
    N_SRCS: Optional[int] = None

    def set_pad_counts(self, n_sinks: int, n_srcs: int) -> None:
        """Called at negotiation once the link counts are known (request
        pads)."""
        self._n_sinks = n_sinks
        self._n_srcs = n_srcs

    def receive(self, pad: int, frame: Frame) -> List[Tuple[int, Frame]]:
        """Handle one input frame on ``pad``; return (src_pad, frame)
        pairs to emit now."""
        raise NotImplementedError

    def eos(self, pad: int) -> List[Tuple[int, Frame]]:
        """Handle EOS on ``pad``; return final emissions."""
        return []
