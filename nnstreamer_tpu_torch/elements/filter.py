"""tensor_filter: the inference element.

The counterpart of ``nnstreamer_tpu/elements/filter.py``, plain invoke
path only: one backend per filter, opened on the pipeline's device at
negotiation. A backend that exposes a function over device tensors (the
native ``torch`` backend) fuses into the surrounding segment, so
converter → transform → filter → decoder runs as one callable with the
tensors on the card throughout.

Properties: framework, model, input/inputtype/inputname (input spec
override), custom (backend options ``k:v,k2:v2``).
"""

from __future__ import annotations

from typing import Callable, List, Optional

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.backends.base import Backend, FilterProps
from nnstreamer_tpu_torch.elements.base import (
    NegotiationError,
    PropSpec,
    Spec,
    TensorOp,
)
from nnstreamer_tpu_torch.tensors.spec import TensorsSpec


@registry.element("tensor_filter")
class TensorFilter(TensorOp):
    FACTORY_NAME = "tensor_filter"

    PROPERTIES = {
        "framework": PropSpec("str", "auto", desc="backend subplugin name"),
        "model": PropSpec("str", "", desc="model path(s), comma-separated"),
        "input": PropSpec("str", None, desc="input spec override (dims)"),
        "inputtype": PropSpec("str", "float32"),
        "inputname": PropSpec("str", ""),
        "custom": PropSpec("str", "", desc="backend options 'k:v,k2:v2'"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        models = str(self.get_property("model", ""))
        model_list = tuple(m for m in models.split(",") if m)
        framework = str(self.get_property("framework", "auto"))
        if framework == "auto":
            detected = (
                registry.detect_filter_framework(model_list[0]) if model_list else None
            )
            if detected is None:
                raise ValueError(f"{self.name}: cannot auto-detect framework")
            framework = detected
        in_override = None
        if self.get_property("input"):
            in_override = TensorsSpec.from_strings(
                str(self.get_property("input")),
                str(self.get_property("inputtype", "float32")),
                str(self.get_property("inputname", "")),
            )
        self.fprops = FilterProps(
            framework=framework,
            model=model_list,
            input_spec=in_override,
            custom=str(self.get_property("custom", "")),
        )
        self.backend: Optional[Backend] = None

    def _ensure_open(self) -> Backend:
        if self.backend is None:
            cls = registry.get(registry.KIND_FILTER, self.fprops.framework)
            b: Backend = cls()
            self.fprops.device = self.device
            b.open(self.fprops)
            self.backend = b
        return self.backend

    def stop(self) -> None:
        if self.backend is not None:
            self.backend.close()
            self.backend = None

    def negotiate(self, in_specs: List[Spec]) -> List[Spec]:
        (spec,) = in_specs
        if not isinstance(spec, TensorsSpec):
            raise NegotiationError(
                f"{self.name}: needs other/tensors input (add tensor_converter), got {spec}"
            )
        if not spec.is_static:
            raise NegotiationError(f"{self.name}: flexible input is not ported yet")
        b = self._ensure_open()
        cur_in, _ = b.get_model_info()
        if cur_in.is_compatible(spec):
            _, out = b.get_model_info()
        else:
            out = b.set_input_info(spec)
        return [out.with_rate(spec.rate)]

    def is_traceable(self) -> bool:
        return self._ensure_open().traceable_fn() is not None

    def make_fn(self) -> Callable:
        fn = self._ensure_open().traceable_fn()
        if fn is None:
            raise RuntimeError(f"{self.name}: backend not traceable")
        return fn

    def host_process(self, frame):
        return frame.with_tensors(self._ensure_open().invoke_timed(frame.tensors))
