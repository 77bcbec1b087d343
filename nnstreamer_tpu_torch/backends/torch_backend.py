"""The native backend: models as ``nn.Module``s on the pipeline's device.

The counterpart of ``nnstreamer_tpu/backends/jax_backend.py``: registered
as ``torch``, and also as ``jax`` so the reference's pipeline strings (its
golden pipelines included) run unchanged. Model sources (``model=``):
``zoo:<name>`` from the port's zoo (models/zoo.py), options in the
``custom=`` string (``custom="size:224,num_classes:1001,params:w.npz"``).

The module's function is handed to the fused segment whole
(:meth:`traceable_fn`); convolutions run in cuDNN.

Placement options, taken out of ``custom=`` before the zoo sees it (as the
reference's ``jax_backend.py`` does):

- ``device:N`` pins the filter to ``cuda:N`` (out of range raises before
  any load). The pinned filter is a fusion barrier whose inputs move to
  its card. On the CPU every ``device:N`` is the one CPU device (the
  reference's CPU run has 8 virtual devices).
- ``mesh:<axes>`` (``dp2tp4``): a mesh larger than the devices at hand
  raises "needs N devices"; one that fits raises too, since mesh sharding
  is not ported yet. Neither loads a model; ``device:`` with ``mesh:``
  raises.
"""

from __future__ import annotations

import math
import re
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.backends.base import Backend, BackendError, FilterProps
from nnstreamer_tpu_torch.tensors.spec import DType, TensorSpec, TensorsSpec


def _as_tuple(x) -> Tuple[Any, ...]:
    if isinstance(x, (tuple, list)):
        return tuple(x)
    return (x,)


@registry.filter_backend("torch", "jax")
class TorchBackend(Backend):
    """framework=torch (alias jax): ``zoo:`` models on the given device."""

    name = "torch"

    def __init__(self) -> None:
        super().__init__()
        self.module: Optional[torch.nn.Module] = None
        self._in_spec: Optional[TensorsSpec] = None
        self._out_spec: Optional[TensorsSpec] = None
        self._pinned: Optional[torch.device] = None

    def open(self, props: FilterProps) -> None:
        self.props = props
        path = props.model_path
        options = props.custom_dict()
        self._pinned = self._placement(options, props.device)
        self._device = self._pinned if self._pinned is not None else props.device
        if not path.startswith("zoo:"):
            raise BackendError(
                f"torch: unsupported model source {path!r} (the port loads "
                "zoo:<name> models)"
            )
        from nnstreamer_tpu_torch.models import zoo

        opts = {k: v for k, v in options.items() if k not in ("device", "mesh")}
        try:
            m = zoo.get(path[len("zoo:"):], device=self._device, **opts)
        except (KeyError, ValueError) as exc:
            raise BackendError(f"torch: {exc}") from exc
        self.module = m.module
        self._in_spec = props.input_spec or m.input_spec
        self._out_spec = None

    @staticmethod
    def _placement(options: Dict[str, str], device: torch.device) -> Optional[torch.device]:
        """The device ``device:N`` pins the filter to (None when unpinned);
        refuses ``mesh:`` before anything is loaded."""
        pinned = None
        if "device" in options:
            idx = int(options["device"])
            have = torch.cuda.device_count() if device.type == "cuda" else 1
            if idx < 0 or (device.type == "cuda" and idx >= have):
                raise BackendError(f"torch: device:{idx} out of range (have {have})")
            pinned = torch.device("cuda", idx) if device.type == "cuda" else device
        mesh = options.get("mesh")
        if mesh:
            if pinned is not None:
                raise BackendError("torch: device: and mesh: are exclusive")
            pairs = re.findall(r"([a-z]+)(\d+)", mesh)
            if not pairs or "".join(a + n for a, n in pairs) != mesh:
                raise BackendError(f"torch: bad mesh spec {mesh!r} (want e.g. dp2tp4)")
            n = math.prod(int(k) for _, k in pairs)
            have = torch.cuda.device_count() if device.type == "cuda" else 1
            if n > have:
                raise BackendError(f"torch: mesh {mesh} needs {n} devices, have {have}")
            raise BackendError(
                f"torch: mesh {mesh}: mesh sharding is not ported yet (ROADMAP A.8)"
            )
        return pinned

    def close(self) -> None:
        self.module = None

    def _infer_out_spec(self) -> TensorsSpec:
        """Output spec by running the module once on zeros of the input
        spec (which also warms the device: cuDNN picks its algorithms
        here, not on the first frame)."""
        zeros = tuple(
            torch.zeros(t.shape, dtype=t.dtype.torch_dtype,
                        device=self._device)
            for t in self._in_spec
        )
        with torch.inference_mode():
            outs = _as_tuple(self.module(*zeros))
        return TensorsSpec(tuple(
            TensorSpec(tuple(int(d) for d in o.shape), DType.from_any(o.dtype))
            for o in outs
        ))

    def get_model_info(self) -> Tuple[TensorsSpec, TensorsSpec]:
        if self._in_spec is None:
            raise BackendError("torch: input spec unknown")
        if self._out_spec is None:
            if not self._in_spec.is_static:
                raise BackendError(f"torch: input spec not static: {self._in_spec}")
            self._out_spec = self._infer_out_spec()
        return self._in_spec, self._out_spec

    def set_input_info(self, in_spec: TensorsSpec) -> TensorsSpec:
        if not in_spec.is_static:
            raise BackendError(f"torch: spec must be static, got {in_spec}")
        cur_in = self._in_spec
        if cur_in is not None and (
            cur_in.num_tensors != in_spec.num_tensors
            or any(a.dtype != b.dtype for a, b in zip(cur_in, in_spec))
        ):
            raise BackendError(f"torch: cannot renegotiate input {cur_in} -> {in_spec}")
        self._in_spec = in_spec
        self._out_spec = self._infer_out_spec()
        return self._out_spec

    def invoke(self, tensors: Tuple[Any, ...]) -> Tuple[Any, ...]:
        if self.module is None:
            raise BackendError("torch: backend not open")
        in_spec, _ = self.get_model_info()
        if len(tensors) != in_spec.num_tensors:
            raise BackendError(
                f"torch: expected {in_spec.num_tensors} tensors, got {len(tensors)}"
            )
        if not self.props.invoke_dynamic:
            for t, s in zip(tensors, in_spec):
                if tuple(t.shape) != s.shape:
                    raise BackendError(
                        f"torch: input shape {tuple(t.shape)} != negotiated {s.shape}"
                    )
        if self._pinned is not None:
            tensors = tuple(t.to(self._pinned) for t in tensors)
        with torch.inference_mode():
            return _as_tuple(self.module(*tensors))

    @property
    def CAPTURABLE(self) -> bool:  # noqa: N802 — the Backend attribute, per model
        """A zoo module may declare ``CAPTURABLE = False`` (an LM's generate
        loop or beam search: data-sized loops and reads back)."""
        return bool(getattr(self.module, "CAPTURABLE", True))

    def traceable_fn(self) -> Optional[Callable]:
        module = self.module
        if module is None or self._pinned is not None:
            # a pinned filter is a fusion barrier: fused into a neighbour's
            # segment, its placement would be lost
            return None
        return lambda tensors: _as_tuple(module(*tensors))
