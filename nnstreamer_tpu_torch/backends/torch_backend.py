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
  any load; the filter's ``device=`` prop rides this option). The pinned
  filter is a fusion barrier whose inputs move to its card. On the CPU
  every ``device:N`` is the one CPU device (the reference's CPU run has 8
  virtual devices). :meth:`TorchBackend.pin_device` pins an opened
  backend (the placement planner's entry).
- ``mesh:<axes>`` (``dp2tp4``), or the ``mesh=`` clause of
  ``accelerator=`` (``true:gpu:mesh=dp2``): the model runs over a device
  mesh (parallel/mesh.py) as a :class:`~nnstreamer_tpu_torch.parallel.sharded_model.MeshModel`.
  Each input whose dim 0 divides by ``dp`` is split over ``dp`` (any other
  is replicated), and every layer whose output channels divide by ``tp``
  is column-parallel; a model with no such layer shards its inputs only,
  with the reference's warning. A mesh larger than the devices at hand
  raises "needs N devices, have M" before any load (on the CPU the
  positions are ``[mesh] cpu_devices``); ``device:`` with ``mesh:``
  raises. :meth:`TorchBackend.set_shardings` installs input shardings
  programmatically. A mesh-sharded filter is a fusion barrier.
"""

from __future__ import annotations

import math
import os
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.backends.base import Backend, BackendError, FilterProps
from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.script import load_script_module
from nnstreamer_tpu_torch.tensors.spec import DType, TensorSpec, TensorsSpec

_JAX_PROGRAMS = (".jaxexport", ".stablehlo", ".hlo")

_log = get_logger("torch_backend")


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
        self._mesh_spec: Optional[str] = None  # e.g. "dp2tp4" (mesh: option or clause)
        self._in_shardings = None  # set_shardings' input descriptors
        self._base_fn: Optional[Callable] = None  # the model's own fn under a mesh
        self.mesh_model = None  # the MeshModel the mesh runs

    def open(self, props: FilterProps) -> None:
        self.props = props
        path = props.model_path
        options = props.custom_dict()
        mesh_spec = options.get("mesh") or self._parse_accel_mesh(props.accelerator)
        if mesh_spec:
            options["mesh"] = mesh_spec
        self._pinned = self._placement(options, props.device)
        self._mesh_spec = mesh_spec or None
        self._in_shardings = self.mesh_model = self._base_fn = None
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
        self._build_mesh()

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
    def _parse_accel_mesh(accelerator: str) -> Optional[str]:
        """``accelerator=true:gpu:mesh=dp2tp4`` → ``dp2tp4`` (the
        reference's accelerator grammar with its mesh clause)."""
        for part in (accelerator or "").split(":"):
            part = part.strip()
            if part.startswith("mesh="):
                return part[len("mesh="):]
        return None

    @staticmethod
    def _placement(options: Dict[str, str], device: torch.device) -> Optional[torch.device]:
        """The device ``device:N`` pins the filter to (None when unpinned);
        checks ``mesh:`` (its spec, its device count, its exclusion with
        ``device:``) before anything is loaded."""
        from nnstreamer_tpu_torch.parallel.mesh import available_devices
        from nnstreamer_tpu_torch.parallel.sharded_model import parse_mesh_spec

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
            try:
                _, sizes = parse_mesh_spec(mesh)
            except ValueError as exc:
                raise BackendError(f"torch: {exc}") from None
            n = math.prod(sizes)
            have = len(available_devices(device.type))
            if n > have:
                raise BackendError(f"torch: mesh {mesh} needs {n} devices, have {have}")
        return pinned

    def _build_mesh(self) -> None:
        """Run the model over its mesh (see the module docstring): the
        :class:`MeshModel` for the negotiated input spec replaces the
        model's fn. Rebuilt when the input spec changes."""
        if self._mesh_spec is None and self._in_shardings is None:
            return
        if self._in_spec is None or not self._in_spec.is_static:
            return  # built once the input spec is known (set_input_info)
        from nnstreamer_tpu_torch.parallel import mesh as pm
        from nnstreamer_tpu_torch.parallel.sharded_model import MeshModel, parse_mesh_spec

        if self._base_fn is None:
            self._base_fn = self._fn
        if self._in_shardings is not None:
            mesh = self._in_shardings[0].mesh
            in_sh, tp_axis = self._in_shardings, None
        else:
            axes, sizes = parse_mesh_spec(self._mesh_spec)
            try:
                mesh = pm.make_mesh(math.prod(sizes), axes=axes, shape=sizes,
                                    devices=self._device.type)
            except ValueError as exc:
                raise BackendError(f"torch: mesh {self._mesh_spec}: {exc}") from None
            dp = mesh.axis_size("dp")
            in_sh = tuple(
                pm.batch_sharding(mesh, "dp")
                if dp > 1 and len(t.shape) >= 1 and t.shape[0] % dp == 0
                else pm.replicated(mesh)
                for t in self._in_spec)
            tp_axis = "tp" if mesh.axis_size("tp") > 1 else None
            if tp_axis is not None and not isinstance(self.module, torch.nn.Module):
                _log.warning("torch: mesh %s has tp>1 but the model has no nn.Module to "
                             "split; sharding its inputs only", self._mesh_spec)
                tp_axis = None
        zeros = tuple(torch.zeros(t.shape, dtype=t.dtype.torch_dtype, device=self._device)
                      for t in self._in_spec)
        try:
            mm = MeshModel(self._base_fn, self.module, mesh, in_sh, tp_axis, self._device,
                           zeros)
        except ValueError as exc:
            raise BackendError(f"torch: mesh {self._mesh_spec or mesh.shape}: {exc}") from None
        if tp_axis is not None and not mm.split_layers.get(0):
            _log.warning("torch: mesh %s has tp>1 but the model has no column-parallel "
                         "layer; sharding its inputs only", self._mesh_spec)
        self.mesh_model = mm
        self._fn = mm
        self._out_spec = None

    def set_shardings(self, in_shardings) -> None:
        """Install input shardings programmatically (parallel/mesh.py
        descriptors, one an input; the ``mesh:`` option builds the same
        state from a spec string, which these replace): an input whose dim
        0 is split over ``dp`` runs data-parallel over that axis."""
        self._in_shardings = tuple(in_shardings)
        self._mesh_spec = None
        self._build_mesh()

    def pin_device(self, idx: int) -> None:
        """Pin the opened backend to device ``idx`` (the placement
        planner's entry, serving_plane/placement.py), as ``device:N`` does
        at open: ``cuda:idx``, range-checked, or the one CPU device; its
        module moves there. A mesh-sharded backend refuses."""
        if self._mesh_spec or self.mesh_model is not None:
            raise BackendError("torch: device pin and mesh are exclusive")
        dev = self.props.device if self.props is not None else self._device
        pinned = self._placement({"device": str(idx)}, dev)
        if isinstance(self.module, torch.nn.Module) and pinned != self._device:
            self.module.to(pinned)
        self._pinned = self._device = pinned

    def close(self) -> None:
        self.module = self._fn = self.program = self._base_fn = self.mesh_model = None

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
        self._build_mesh()
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
            # TorchScript model) gets its frame on the filter's device (a
            # mesh-sharded one moves its inputs to the mesh itself)
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
        if (fn is None or self._pinned is not None or self.mesh_model is not None
                or not self._traceable):
            # a pinned or mesh-sharded filter is a fusion barrier: fused into
            # a neighbour's segment, its placement would be lost; a host node
            # is one too
            return None
        return lambda tensors: _as_tuple(fn(*tensors))

    def plane_fn(self) -> Tuple[Optional[Callable], Optional[torch.device]]:
        """``(fn, device)`` for the serving plane (serving_plane/sharding.py).
        Where a device pin makes :meth:`traceable_fn` refuse (a pin is a
        fusion barrier, not a batching barrier), the plane builds its own
        program on the pinned device, so ``plane= device=N`` batches there
        and does not degrade to a per-frame host loop. A mesh-sharded
        backend gives (None, None): the plane's ``plane-mode=shard`` is the
        sharded path."""
        fn = self._fn
        if fn is None or self.mesh_model is not None or not self._traceable:
            return None, None
        return (lambda tensors: _as_tuple(fn(*tensors))), self._device

    def fn_on(self, device: torch.device) -> Callable:
        """The model's traceable fn with its weights on ``device`` (a copy of
        the module there; the plane's mesh positions): the fn itself on the
        backend's own device."""
        device = torch.device(device)
        if device == self._device:
            return self.plane_fn()[0]
        if not isinstance(self.module, torch.nn.Module):
            raise BackendError(f"torch: a model with no nn.Module cannot be placed on {device}")
        import copy

        replica = copy.deepcopy(self.module).to(device)
        return lambda tensors: _as_tuple(replica(*tensors))
