"""The native backend: models as torch programs on the pipeline's device.

The counterpart of ``nnstreamer_tpu/backends/jax_backend.py`` (and of the
reference's TorchScript ``torch_backend.py``): registered as ``torch``,
and also as ``jax`` so the reference's pipeline strings (its golden
pipelines included) run unchanged. Model sources (``model=``):

- ``zoo:<name>`` from the port's zoo (models/zoo.py), options in the
  ``custom=`` string (``custom="size:224,num_classes:1001,params:w.npz"``);
- ``<path>.py``: a script defining ``get_model(options)`` that returns
  ``(fn or nn.Module, input_spec | None)``. A module is moved to the
  filter's device; the model fuses unless it declares ``TRACEABLE =
  False``, which makes it a host node that still gets device tensors;
- ``<path>.tflite``: the graph as the port's own torch program on the
  filter's device (tools/tflite_exec.py), built and run once at ``open``
  on zeros of the graph's input shapes, so an op the program cannot build
  raises :class:`BackendError` there. It fuses: a frame through it is part
  of its segment's one CUDA graph. It never reaches an interpreter;
  ``framework=tflite`` is the host interpreter;
- ``<path>.pt`` / ``<path>.pth``: TorchScript (``torch.jit.load`` onto
  the filter's device). The input spec is required (TorchScript carries
  no static shapes) and the output spec comes from one trial run on
  zeros. A host node: it is not fused, and gets tensors on the device;
- ``<path>.jaxexport`` / ``.stablehlo`` / ``.hlo`` raise: a serialized
  JAX program cannot run in the port.

The module's function is handed to the fused segment whole
(:meth:`traceable_fn`); convolutions run in cuDNN.

Placement options, taken out of ``custom=`` before the model sees them
(as the reference's ``jax_backend.py`` does):

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
import os
import re
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.backends.base import Backend, BackendError, FilterProps
from nnstreamer_tpu_torch.script import load_script_module
from nnstreamer_tpu_torch.tensors.spec import DType, TensorSpec, TensorsSpec

_JAX_PROGRAMS = (".jaxexport", ".stablehlo", ".hlo")


def _as_tuple(x) -> Tuple[Any, ...]:
    if isinstance(x, (tuple, list)):
        return tuple(x)
    return (x,)


def _spec_of(outs) -> TensorsSpec:
    return TensorsSpec(tuple(
        TensorSpec(tuple(int(d) for d in o.shape), DType.from_any(o.dtype)) for o in outs
    ))



@registry.filter_backend("torch", "jax")
class TorchBackend(Backend):
    """framework=torch (alias jax): zoo, script, .tflite and TorchScript
    models on the given device."""

    name = "torch"

    def __init__(self) -> None:
        super().__init__()
        self.module: Optional[torch.nn.Module] = None  # the nn.Module, where there is one
        self._fn: Optional[Callable] = None  # (*tensors) -> tensor | tuple
        self._traceable = True
        self.program = None  # the TFLiteProgram of a .tflite model
        self._in_spec: Optional[TensorsSpec] = None
        self._out_spec: Optional[TensorsSpec] = None
        self._pinned: Optional[torch.device] = None

    def open(self, props: FilterProps) -> None:
        self.props = props
        path = props.model_path
        options = props.custom_dict()
        self._pinned = self._placement(options, props.device)
        self._device = self._pinned if self._pinned is not None else props.device
        self._out_spec = None
        self._traceable = True
        # _replica:<i> tags a filter's or a plane's replica (the chaos
        # injectors read it); it is no model option
        opts = {k: v for k, v in options.items() if k not in ("device", "mesh", "_replica")}
        if path.startswith("zoo:"):
            self._open_zoo(path[len("zoo:"):], opts)
        elif path.endswith(".py"):
            self._open_script(path, opts)
        elif path.endswith(".tflite"):
            self._open_tflite(path)
        elif path.endswith((".pt", ".pth")):
            self._open_torchscript(path)
        elif path.endswith(_JAX_PROGRAMS):
            raise BackendError(
                f"torch: {path!r} is a serialized JAX program, which cannot run in the "
                "port; export the model as a .tflite, a TorchScript .pt or a .py get_model"
            )
        else:
            raise BackendError(f"torch: unsupported model source {path!r}")
        if props.input_spec is not None and props.input_spec != self._in_spec:
            self._in_spec, self._out_spec = props.input_spec, None

    def _open_zoo(self, name: str, opts: Dict[str, str]) -> None:
        from nnstreamer_tpu_torch.models import zoo

        try:
            m = zoo.get(name, device=self._device, **opts)
        except (KeyError, ValueError) as exc:
            raise BackendError(f"torch: {exc}") from exc
        self.module = self._fn = m.module
        self._in_spec = m.input_spec

    def _open_script(self, path: str, opts: Dict[str, str]) -> None:
        """``get_model(options)`` → (fn or nn.Module, input spec or None);
        a module is moved to the filter's device."""
        try:
            script = load_script_module(path, "nns_tpu_torch_model")
        except FileNotFoundError as exc:
            raise BackendError(f"torch: model script not found: {path}") from exc
        get_model = getattr(script, "get_model", None)
        if get_model is None:
            raise BackendError(f"torch: {path} defines no get_model(options)")
        fn, in_spec = get_model(opts)
        if isinstance(fn, torch.nn.Module):
            fn = fn.eval().to(self._device)
            self.module = fn
        self._fn = fn
        self._traceable = bool(getattr(fn, "TRACEABLE", True))
        self._in_spec = in_spec

    def _open_tflite(self, path: str) -> None:
        """The graph as one torch program on the filter's device, run once
        on zeros of its input shapes: an op it cannot build raises here."""
        if not os.path.isfile(path):
            raise BackendError(f"torch: tflite model not found: {path}")
        from nnstreamer_tpu_torch.tools.tflite_exec import TFLiteProgram

        try:
            prog = TFLiteProgram(path, device=self._device)
            zeros = [torch.zeros(s, dtype=DType.from_any(d).torch_dtype, device=self._device)
                     for s, d in zip(prog.input_shapes, prog.input_dtypes)]
            with torch.inference_mode():
                outs = prog.trace(*zeros)
        except NotImplementedError as exc:
            raise BackendError(f"torch: cannot build {path}: {exc}") from exc
        self.program = prog
        self._fn = lambda *ts: tuple(prog.trace(*ts))
        self._in_spec = TensorsSpec(tuple(
            TensorSpec(tuple(int(d) for d in s), DType.from_any(dt))
            for s, dt in zip(prog.input_shapes, prog.input_dtypes)
        ))
        self._out_spec = _spec_of(outs)

    def _open_torchscript(self, path: str) -> None:
        if not os.path.isfile(path):
            raise BackendError(f"torch: model not found: {path}")
        module = torch.jit.load(path, map_location=self._device)
        module.eval()
        self.module = self._fn = module
        self._traceable = False
        self._in_spec = None  # from the caller: TorchScript carries no static shapes

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
        self.module = self._fn = self.program = None

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
            return _spec_of(_as_tuple(self._fn(*zeros)))

    def get_model_info(self) -> Tuple[TensorsSpec, TensorsSpec]:
        if self._in_spec is None:
            raise BackendError("torch: input spec unknown (set input= / input_spec: "
                               "TorchScript and script models may carry no static shapes)")
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
        if self._fn is None:
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
        if self._pinned is not None or not self._traceable:
            # a pinned filter's inputs move to its card; a host node (a
            # TorchScript model) gets its frame on the filter's device
            tensors = tuple(t.to(self._device) for t in tensors)
        with torch.inference_mode():
            return _as_tuple(self._fn(*tensors))

    @property
    def CAPTURABLE(self) -> bool:  # noqa: N802 — the Backend attribute, per model
        """A zoo module may declare ``CAPTURABLE = False`` (an LM's generate
        loop or beam search: data-sized loops and reads back)."""
        return bool(getattr(self._fn, "CAPTURABLE", True))

    def traceable_fn(self) -> Optional[Callable]:
        fn = self._fn
        if fn is None or self._pinned is not None or not self._traceable:
            # a pinned filter is a fusion barrier: fused into a neighbour's
            # segment, its placement would be lost; a host node is one too
            return None
        return lambda tensors: _as_tuple(fn(*tensors))
