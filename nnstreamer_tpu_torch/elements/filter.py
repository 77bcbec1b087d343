"""tensor_filter: the inference element.

The counterpart of ``nnstreamer_tpu/elements/filter.py``, plain invoke
path only: one backend per filter, opened on the pipeline's device at
negotiation. A backend that exposes a function over device tensors (the
native ``torch`` backend) fuses into the surrounding segment, so
converter → transform → filter → decoder runs as one callable with the
tensors on the card throughout.

Properties: framework, model, input/inputtype/inputname (input spec
override), custom (backend options ``k:v,k2:v2``), input-combination
(which input tensors the model takes, ``i0,i2``) and output-combination
(the frame out, from model outputs and input tensors: ``o0,i1,o2``),
applied inside the fused callable, and invoke-dynamic (per-frame input
shapes pass the backend's shape check).

A flexible input stream (a converter subplugin's, a host-mode
``tensor_crop``'s) negotiates against the model's own spec; each frame
is checked at invoke, and such a filter runs per frame on the host path,
never fused.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.backends.base import Backend, FilterProps
from nnstreamer_tpu_torch.elements.base import (
    NegotiationError,
    PropSpec,
    parse_bool,
    Spec,
    TensorOp,
)
from nnstreamer_tpu_torch.tensors.spec import TensorsSpec

Combination = Optional[List[Tuple[str, int]]]


def _parse_combination(s: str) -> Combination:
    """``'i0,o1,i2'`` → ``[('i', 0), ('o', 1), ('i', 2)]``; a bare index
    (kind ``''``) means an input in input-combination and a model output
    in output-combination. Empty → None (no rewiring)."""
    s = (s or "").strip()
    if not s:
        return None
    out = []
    for part in s.split(","):
        part = part.strip().lower()
        if not part:
            raise ValueError(f"empty token in combination string {s!r}")
        if part[0] in ("i", "o") and part[1:].isdigit():
            out.append((part[0], int(part[1:])))
        elif part.isdigit():
            out.append(("", int(part)))
        else:
            raise ValueError(f"bad combination token {part!r}")
    return out


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
        "invoke-dynamic": PropSpec("bool", False, desc="input shapes may vary per frame"),
        "input-combination": PropSpec("str", "", desc="model inputs: 'i0,i2'"),
        "output-combination": PropSpec("str", "", desc="frame out: 'o0,i1'"),
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
            invoke_dynamic=parse_bool(self.get_property("invoke-dynamic", False)),
        )
        self.in_combination = _parse_combination(str(self.get_property("input-combination", "")))
        self.out_combination = _parse_combination(
            str(self.get_property("output-combination", "")))
        self.backend: Optional[Backend] = None
        self._flexible_input = False

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
        b = self._ensure_open()
        model_in = self._select_model_inputs_spec(spec)
        self._flexible_input = not model_in.is_static
        if self._flexible_input:
            # per-frame shapes: the model's own spec governs, and each
            # frame is checked at invoke
            try:
                _, out = b.get_model_info()
            except Exception as exc:
                raise NegotiationError(
                    f"{self.name}: flexible input needs a model with a known "
                    f"input spec (or input=/inputtype= properties): {exc}"
                ) from exc
        else:
            try:
                cur_in, _ = b.get_model_info()
            except Exception:
                cur_in = None  # shape-polymorphic: the model info needs the input
            if cur_in is not None and cur_in.is_compatible(model_in):
                _, out = b.get_model_info()
            else:
                out = b.set_input_info(model_in)
        return [self._compose_output_spec(spec, out).with_rate(spec.rate)]

    def _select_model_inputs_spec(self, spec: TensorsSpec) -> TensorsSpec:
        if self.in_combination is None or not spec.is_static:
            # a flexible frame's tensor count is known only at invoke,
            # where the combination is applied and bounds-checked
            return spec
        picks = []
        for kind, idx in self.in_combination:
            if kind == "o":
                raise NegotiationError(f"{self.name}: 'o' not valid in input-combination")
            if idx >= spec.num_tensors:
                raise NegotiationError(f"{self.name}: input-combination index {idx} out of range")
            picks.append(spec[idx])
        return TensorsSpec(tuple(picks), spec.format, spec.rate)

    def _compose_output_spec(self, in_spec: TensorsSpec, model_out: TensorsSpec) -> TensorsSpec:
        if self.out_combination is None:
            return model_out
        outs = []
        for kind, idx in self.out_combination:
            src = in_spec if kind == "i" else model_out
            if idx >= src.num_tensors:
                raise NegotiationError(
                    f"{self.name}: output-combination index {idx} out of range")
            outs.append(src[idx])
        return TensorsSpec(tuple(outs), model_out.format, in_spec.rate)

    def _apply_combinations(self, invoke: Callable) -> Callable:
        """``invoke`` (model inputs → model outputs) wrapped to take and give
        the frame's tensors under the pad combinations."""
        in_comb, out_comb = self.in_combination, self.out_combination
        if in_comb is None and out_comb is None:
            return invoke
        # input tensors the combinations read: checked per frame, since a
        # flexible frame's tensor count is known only here
        reads = [i for _, i in in_comb or ()] + [i for k, i in out_comb or () if k == "i"]
        needed = max(reads, default=-1) + 1

        def fn(tensors: Tuple[Any, ...]) -> Tuple[Any, ...]:
            if len(tensors) < needed:
                raise IndexError(
                    f"{self.name}: combination index {needed - 1} out of range "
                    f"for a frame of {len(tensors)} tensors"
                )
            model_in = tensors if in_comb is None else tuple(tensors[i] for _, i in in_comb)
            model_out = tuple(invoke(model_in))
            if out_comb is None:
                return model_out
            return tuple(tensors[i] if kind == "i" else model_out[i] for kind, i in out_comb)

        return fn

    def is_traceable(self) -> bool:
        if self._flexible_input:
            return False
        return self._ensure_open().traceable_fn() is not None

    def make_fn(self) -> Callable:
        fn = self._ensure_open().traceable_fn()
        if fn is None:
            raise RuntimeError(f"{self.name}: backend not traceable")
        return self._apply_combinations(fn)

    def host_process(self, frame):
        invoke = self._apply_combinations(self._ensure_open().invoke_timed)
        return frame.with_tensors(tuple(invoke(frame.tensors)))
