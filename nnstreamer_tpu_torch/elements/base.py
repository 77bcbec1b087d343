"""Element model: the composable stages of a pipeline.

The counterpart of ``nnstreamer_tpu/elements/base.py``, reduced to what the
image-labeling path needs:

- ``negotiate(in_specs) -> out_specs`` runs once at pipeline build time
  over the whole graph (topological order), producing static specs;
- :class:`TensorOp` — 1→1 pure tensor function over torch tensors
  (tensor_converter, tensor_transform, tensor_filter, tensor-math
  decoders). Consecutive TensorOps fuse into one callable per segment
  (pipeline/graph.py).
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
from nnstreamer_tpu_torch.tensors.spec import TensorsSpec


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


class Element:
    """Base element. Subclasses set N_SINKS/N_SRCS and implement
    negotiate(). ``device`` is the pipeline's torch device, assigned when
    the element is added to a :class:`~nnstreamer_tpu_torch.pipeline.graph.Pipeline`."""

    FACTORY_NAME = "element"
    N_SINKS: int = 1
    N_SRCS: int = 1

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
        schema = self.property_schema()
        for k, v in props.items():
            if k.replace("_", "-") not in schema:
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
        self.out_specs = list(self.negotiate(list(in_specs)))
        return self.out_specs

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

    def make_fn(self) -> Callable[[Tuple[Any, ...]], Tuple[Any, ...]]:
        """The fn (tensors) -> tensors over torch tensors on ``device``,
        for the negotiated specs."""
        raise NotImplementedError

    def is_traceable(self) -> bool:
        """False → the op runs per frame through :meth:`host_process` in a
        segment of its own (a fusion barrier)."""
        return True

    def host_process(self, frame: Frame) -> Frame:
        out = self.make_fn()(frame.tensors)
        return frame.with_tensors(out)


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
    """Stream sink: receives frames on its own thread."""

    N_SINKS = 1
    N_SRCS = 0

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
