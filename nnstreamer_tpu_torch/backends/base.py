"""Backend interface: the pluggable inference engine contract.

The counterpart of ``nnstreamer_tpu/backends/base.py``. The lifecycle maps
the reference's subplugin ABI (nnstreamer_plugin_api_filter.h):

    fw->open / close            → Backend.open / close
    getModelInfo(GET_IN_OUT)    → Backend.get_model_info
    getModelInfo(SET_INPUT)     → Backend.set_input_info
    fw->invoke                  → Backend.invoke

:meth:`Backend.traceable_fn` returns the model as a function over device
tensors, so the pipeline can fuse it with adjacent transform/decoder
stages into one segment.
"""

from __future__ import annotations

import dataclasses
import time
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from nnstreamer_tpu_torch.tensors.frame import Frame
from nnstreamer_tpu_torch.tensors.spec import TensorsSpec


@dataclass
class FilterProps:
    """Filter properties shared by the element and single-shot API."""

    framework: str = "auto"
    model: Tuple[str, ...] = ()
    input_spec: Optional[TensorsSpec] = None  # user override
    output_spec: Optional[TensorsSpec] = None
    custom: str = ""  # backend-specific option string (custom= prop)
    accelerator: str = ""  # the reference's accelerator string; its mesh= clause shards
    invoke_dynamic: bool = False  # input and output shapes may vary per frame
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    options: Dict[str, str] = field(default_factory=dict)

    @property
    def model_path(self) -> str:
        return self.model[0] if self.model else ""

    def custom_dict(self) -> Dict[str, str]:
        """Parse ``key:value,key2:value2`` custom strings."""
        out: Dict[str, str] = {}
        for part in self.custom.split(","):
            part = part.strip()
            if not part:
                continue
            if ":" in part:
                k, v = part.split(":", 1)
                out[k.strip()] = v.strip()
            else:
                out[part] = "true"
        return out


class BackendError(RuntimeError):
    pass


def host_invoke(fn: Callable, tensors: Tuple[Any, ...], device: torch.device) -> Tuple[Any, ...]:
    """Run a host function (numpy in, numpy or tensors out) on a frame's
    tensors: each input crosses to the host once, each output back to
    ``device`` once."""
    outs = fn(Frame(tensors).to_host().tensors)
    return Frame(tuple(outs)).to_device(device).tensors


class Backend(ABC):
    """One loaded model instance inside a filter stage."""

    name: str = "base"

    #: whether invoke_batched() may take a window of frames in one call
    #: (pipeline/batching.py). A backend whose invoke is strictly per
    #: frame, or which keeps state across frames, leaves this False and
    #: keeps per-frame invokes.
    batchable: bool = False

    #: whether invoke() is the identity over its tensors (the passthrough
    #: fake): a fused segment of only identity ops runs no program.
    IS_IDENTITY: bool = False

    #: whether traceable_fn() may be captured into a CUDA graph: False for
    #: a model that reads values back to the host or sizes its work by
    #: the data (an LM's generate loop).
    CAPTURABLE: bool = True

    def __init__(self) -> None:
        self.props: Optional[FilterProps] = None
        self.stats = InvokeStats()

    @abstractmethod
    def open(self, props: FilterProps) -> None:
        """Load the model onto ``props.device``. Reference fw->open."""

    def close(self) -> None:
        """Release resources. Reference fw->close."""

    def reload(self, model_paths: Sequence[str]) -> None:
        """Model swap (reference RELOAD_MODEL): close, then open again on
        ``model_paths`` with the same properties."""
        if self.props is None:
            raise BackendError(f"{self.name}: reload before open")
        self.close()
        self.open(dataclasses.replace(self.props, model=tuple(model_paths)))

    @abstractmethod
    def get_model_info(self) -> Tuple[TensorsSpec, TensorsSpec]:
        """(input_spec, output_spec) after open."""

    def set_input_info(self, in_spec: TensorsSpec) -> TensorsSpec:
        """Renegotiate for a different input shape; returns the new output
        spec. Default: reject unless the input already matches."""
        cur_in, cur_out = self.get_model_info()
        if cur_in.is_compatible(in_spec):
            return cur_out
        raise BackendError(
            f"{self.name}: cannot renegotiate input {cur_in} -> {in_spec}"
        )

    @abstractmethod
    def invoke(self, tensors: Tuple[Any, ...]) -> Tuple[Any, ...]:
        """Run inference on one frame's tensors (on the backend's device)."""

    def traceable_fn(self) -> Optional[Callable[[Tuple[Any, ...]], Tuple[Any, ...]]]:
        """The model as a fn over device tensors, or None for a fusion
        barrier."""
        return None

    def invoke_batched(self, batch: Sequence[Tuple[Any, ...]]) -> List[Tuple[Any, ...]]:
        """Inference on a window of frames' tensors in ONE call (used only
        when ``batchable``). The default chains invoke(); an engine with a
        real batched entry point overrides it."""
        return [tuple(self.invoke(ts)) for ts in batch]

    def invoke_timed(self, tensors: Tuple[Any, ...]) -> Tuple[Any, ...]:
        t0 = time.perf_counter_ns()
        out = self.invoke(tensors)
        self.stats.record(time.perf_counter_ns() - t0)
        return out


class InvokeStats:
    """Sliding-window host-side invoke latency (the reference's 10-invoke
    window). On a GPU an invoke returns once its work is queued, so this is
    the enqueue time, not the device time."""

    WINDOW = 10

    def __init__(self) -> None:
        self.total_invoke_num = 0
        self._recent: List[Tuple[int, int]] = []  # (host clock ns at record, latency ns)

    def record(self, latency_ns: int) -> None:
        self.total_invoke_num += 1
        self._recent.append((time.monotonic_ns(), latency_ns))
        if len(self._recent) > self.WINDOW:
            self._recent.pop(0)

    @property
    def latency_us(self) -> float:
        if not self._recent:
            return 0.0
        return sum(l for _, l in self._recent) / len(self._recent) / 1000.0

    @property
    def throughput_fps(self) -> float:
        """Invokes a second over the recent window (the reference's
        'throughput' property, in plain fps)."""
        if len(self._recent) < 2:
            return 0.0
        span = self._recent[-1][0] - self._recent[0][0]
        return (len(self._recent) - 1) * 1e9 / span if span > 0 else 0.0
