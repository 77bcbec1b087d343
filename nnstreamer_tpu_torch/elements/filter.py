"""tensor_filter: the inference element.

The counterpart of ``nnstreamer_tpu/elements/filter.py``: one backend per
filter, opened on the pipeline's device at negotiation, or one stream of a
shared serving plane. A backend that exposes a function over device
tensors (the native ``torch`` backend) fuses into the surrounding segment, so
converter → transform → filter → decoder runs as one callable with the
tensors on the card throughout.

Properties: framework, model, input/inputtype/inputname (input spec
override), output/outputtype/outputname (output spec override, handed to
the backend), custom (backend options ``k:v,k2:v2``), input-combination
(which input tensors the model takes, ``i0,i2``) and output-combination
(the frame out, from model outputs and input tensors: ``o0,i1,o2``),
applied inside the fused callable, and invoke-dynamic (per-frame input
shapes pass the backend's shape check). Micro-batching (batching,
max-batch, batch-timeout-ms, batch-buckets; read-only avg-batch-size,
pad-waste-pct, batch-wait-ms) is resolved at plan time
(pipeline/batching.py): a fused filter batches through its segment, a host
one through ``invoke_batched`` when its backend declares ``batchable``.
``reload_model`` swaps the model under the same specs (``is-updatable`` is
accepted as the reference accepts it).

Serving plane (serving_plane/): ``plane=<name>`` attaches the filter as
one stream of the process-wide plane of that name, which runs ONE opened
backend for all its streams and batches their windows into one device
program (on CUDA one graph replay a dispatch). ``plane-weight`` is the
stream's weighted-fair share; ``plane-max-batch``, ``plane-timeout-ms``,
``plane-mode`` and ``plane-devices`` override the ``[plane]`` defaults
(the first attacher's config binds the plane; a sharer that sets none of
them inherits it). A plane filter is a fusion barrier and a batch-capable
host node: its local collector defaults on, window-matched to the plane,
and each collected window is one plane round trip. ``ring-depth`` (1..32,
default ``[plane] inflight``) is the stream's in-flight window tickets: at
depth > 1 window N+1 submits while N computes. ``plane-mode=replicas``,
``plane-mode=shard`` over more than one device, and ``ring-depth`` without
a plane are not ported and raise at construction.

A flexible input stream (a converter subplugin's, a host-mode
``tensor_crop``'s) negotiates against the model's own spec; each frame
is checked at invoke, and such a filter runs per frame on the host path,
never fused.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.backends.base import Backend, FilterProps
from nnstreamer_tpu_torch.elements.base import (
    NegotiationError,
    PropSpec,
    parse_bool,
    Spec,
    TensorOp,
)
from nnstreamer_tpu_torch.tensors.frame import Frame
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
        "output": PropSpec("str", None, desc="output spec override (dims)"),
        "outputtype": PropSpec("str", "float32"),
        "outputname": PropSpec("str", ""),
        "is-updatable": PropSpec("bool", False, desc="allow reload_model()"),
        "custom": PropSpec("str", "", desc="backend options 'k:v,k2:v2'"),
        "invoke-dynamic": PropSpec("bool", False, desc="input shapes may vary per frame"),
        "input-combination": PropSpec("str", "", desc="model inputs: 'i0,i2'"),
        "output-combination": PropSpec("str", "", desc="frame out: 'o0,i1'"),
        # micro-batching (pipeline/batching.py): per-element overrides of
        # the [executor] defaults. Unset = inherit.
        "batching": PropSpec(
            "bool", None, desc="micro-batch queued frames into one device invoke"
        ),
        "max-batch": PropSpec("int", None, desc="micro-batch frame cap (default 8)"),
        "batch-timeout-ms": PropSpec(
            "float", None,
            desc="straggler wait when trickle-fed (default 1.0; 0 = never wait)",
        ),
        "batch-buckets": PropSpec(
            "str", None,
            desc="comma list of padded batch sizes (default 1,2,4,...,max-batch)",
        ),
        # serving plane (serving_plane/): one stream of a shared plane
        "plane": PropSpec("str", "", desc="attach to the named process-wide serving plane"),
        "plane-weight": PropSpec("float", None, desc="this stream's weighted-fair share"),
        "plane-mode": PropSpec("str", None, desc="single | shard | replicas ([plane] mode)"),
        "plane-devices": PropSpec("int", None, desc="devices backing the plane ([plane] devices)"),
        "plane-max-batch": PropSpec("int", None, desc="cross-stream batch cap ([plane] max_batch)"),
        "plane-timeout-ms": PropSpec(
            "float", None, desc="plane straggler wait when trickle-fed ([plane] timeout_ms)"),
        "ring-depth": PropSpec(
            "int", None, desc="in-flight plane window tickets, 1..32 ([plane] inflight)"),
    }

    # read-only properties: the node's batching counters (pipeline/batching.py)
    READ_ONLY = ("avg-batch-size", "pad-waste-pct", "batch-wait-ms")

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
        out_override = None
        if self.get_property("output"):
            out_override = TensorsSpec.from_strings(
                str(self.get_property("output")),
                str(self.get_property("outputtype", "float32")),
                str(self.get_property("outputname", "")),
            )
        self.fprops = FilterProps(
            framework=framework,
            model=model_list,
            input_spec=in_override,
            output_spec=out_override,
            custom=str(self.get_property("custom", "")),
            invoke_dynamic=parse_bool(self.get_property("invoke-dynamic", False)),
        )
        self.in_combination = _parse_combination(str(self.get_property("input-combination", "")))
        self.out_combination = _parse_combination(
            str(self.get_property("output-combination", "")))
        self.backend: Optional[Backend] = None
        self._flexible_input = False
        self._init_plane()

    # -- serving plane (serving_plane/plane.py) ----------------------------
    def _init_plane(self) -> None:
        """Resolve the plane config and this stream's ticket depth, and
        default the local collector on, window-matched to the plane
        (explicit batching= / max-batch= props still win). What the port
        cannot serve raises here, before any backend opens."""
        self.plane = str(self.get_property("plane", "") or "")
        raw_w = self.get_property("plane-weight")
        self.plane_weight = float(raw_w) if raw_w is not None else 1.0
        self._plane = None          # ModelPlane once acquired
        self._plane_stream = None   # this filter's PlaneStream
        self._plane_cfg = None      # resolved PlaneConfig
        self._plane_last_stats: Dict[str, Any] = {}
        self.plane_inflight = 1     # async ticket depth (1 = blocking)
        raw_rd = self.get_property("ring-depth")
        if not self.plane:
            if raw_rd is not None:
                raise NotImplementedError(
                    f"{self.name}: ring-depth without plane= (the executor's in-flight "
                    "frame ring, pipeline/transfer.py) is not ported yet (ROADMAP A.6b)"
                )
            return
        from nnstreamer_tpu_torch.serving_plane.plane import resolve_plane_config
        from nnstreamer_tpu_torch.serving_plane.sharding import refuse_unported

        self._plane_cfg = resolve_plane_config([self])
        refuse_unported(self._plane_cfg)
        if raw_rd is not None:
            try:
                depth = int(raw_rd)
            except (TypeError, ValueError) as exc:
                raise ValueError(f"{self.name}: bad ring-depth={raw_rd!r}") from exc
            self.plane_inflight = max(1, min(32, depth))
        else:
            self.plane_inflight = self._plane_cfg.inflight
        if self.get_property("batching") is None:
            self.set_property("batching", "true")
        if self.get_property("max-batch") is None:
            self.set_property("max-batch", str(self._plane_cfg.max_batch))
        if self.get_property("batch-timeout-ms") is None:
            self.set_property("batch-timeout-ms", str(self._plane_cfg.timeout_ms))

    def _open_backend(self) -> Backend:
        cls = registry.get(registry.KIND_FILTER, self.fprops.framework)
        b: Backend = cls()
        self.fprops.device = self.device
        b.open(self.fprops)
        return b

    def _acquire_plane(self):
        """Get-or-create the named plane and attach this filter as one
        stream. Reached at negotiation (the plane's backend is the
        model-info surface), so the plane's service thread predates every
        executor start."""
        if self._plane is None:
            from nnstreamer_tpu_torch.serving_plane import plane as plane_mod

            # a sharer that set no plane-* knobs INHERITS the first
            # attacher's bound config instead of colliding with it
            explicit = any(
                self.get_property(k) is not None
                for k in ("plane-max-batch", "plane-timeout-ms", "plane-mode", "plane-devices")
            )
            sig = (self.fprops.framework, self.fprops.model, self.fprops.custom,
                   self.fprops.invoke_dynamic, str(self.fprops.input_spec),
                   str(self.fprops.output_spec), str(self.device))
            self._plane = plane_mod.acquire(
                self.plane, sig, self._plane_cfg, self._open_backend,
                cfg_explicit=explicit,
            )
        if self._plane_stream is None:
            try:
                self._plane_stream = self._plane.attach(self.name, self.plane_weight)
            except ValueError:
                # the same element name in another pipeline of this process
                self._plane_stream = self._plane.attach(
                    f"{self.name}@{id(self) & 0xffff:04x}", self.plane_weight)
        return self._plane

    def plane_stats(self) -> Dict[str, Any]:
        """Plane-wide counters plus THIS stream's admit/serve counters
        (sharers do not report each other's); {} without a plane."""
        if not self.plane:
            return {}
        if self._plane is None:
            return self._plane_last_stats
        d = self._plane.stats()
        s = self._plane_stream
        if s is not None:
            d.update(stream=s.sid, stream_admitted=s.admitted, stream_served=s.served,
                     stream_errors=s.errors)
        return d

    def _plane_window_inputs(self, frames: List[Frame]) -> List[tuple]:
        in_comb = self.in_combination
        return [f.tensors if in_comb is None else tuple(f.tensors[i] for _, i in in_comb)
                for f in frames]

    def _finish_plane_window(self, frames: List[Frame], model_outs, per: int) -> List[Frame]:
        out_comb = self.out_combination
        outs: List[Frame] = []
        for f, model_out in zip(frames, model_outs):
            self.backend.stats.record(per)
            if out_comb is not None:
                model_out = tuple(f.tensors[i] if kind == "i" else model_out[i]
                                  for kind, i in out_comb)
            outs.append(f.with_tensors(tuple(model_out)))
        return outs

    def host_submit_window_async(self, frames: List[Frame]):
        """Submit one collected window to the plane without waiting → a
        ticket for :meth:`host_collect_window`."""
        plane = self._acquire_plane()
        req = plane.submit_window_async(self._plane_stream, self._plane_window_inputs(frames))
        return req, frames

    def host_collect_window(self, ticket) -> List[Frame]:
        """Redeem one ticket (in submission order): the window's frames,
        or its invoke error raised whole."""
        req, frames = ticket
        t0 = time.perf_counter_ns()
        model_outs = self._plane.wait_window(self._plane_stream, req)
        per = (time.perf_counter_ns() - t0) // max(1, len(frames))
        return self._finish_plane_window(frames, model_outs, per)

    # -- lifecycle ---------------------------------------------------------
    def _ensure_open(self) -> Backend:
        if self.backend is None:
            self.backend = self._acquire_plane().backend if self.plane else self._open_backend()
        return self.backend

    def stop(self) -> None:
        if self._plane is not None:
            # the plane owns the backend: this filter drops its stream and
            # its registry ref (the last sharer out closes everything)
            from nnstreamer_tpu_torch.serving_plane import plane as plane_mod

            self._plane_last_stats = self.plane_stats()
            if self._plane_stream is not None:
                self._plane.detach(self._plane_stream)
                self._plane_stream = None
            plane_mod.release(self.plane, self._plane)
            self._plane = None
            self.backend = None
        if self.backend is not None:
            self.backend.close()
            self.backend = None

    @property
    def CAPTURABLE(self) -> bool:  # noqa: N802 — TensorOp's attribute, per backend
        """Whether the backend's fn may be captured into a CUDA graph. Read
        by the segment right after :meth:`make_fn`, which opened the
        backend; reading it never opens one."""
        if self.backend is None:
            raise RuntimeError(f"{self.name}: CAPTURABLE read with no backend open")
        return bool(self.backend.CAPTURABLE)

    def is_identity(self) -> bool:
        """True when the backend is the identity (``IS_IDENTITY``) and no
        pad combination rewires tensors."""
        if self.in_combination is not None or self.out_combination is not None:
            return False
        return bool(self._ensure_open().IS_IDENTITY)

    def reload_model(self, model: str) -> None:
        """Hot swap: reopen the backend on ``model`` (comma-separated
        paths) for the negotiated input, and tick ``fn_version`` so a
        fused segment builds its program anew (same shapes, so the
        signature alone would serve the old one). The output spec must
        stay as negotiated. A plane's model is shared by every stream, so a
        plane filter refuses."""
        if self.plane:
            raise ValueError(
                f"{self.name}: plane={self.plane!r} shares one model among its streams; "
                "a reload through one sharer is refused"
            )
        old_out = list(self.out_specs)
        if self.backend is not None:
            self.backend.close()
            self.backend = None
        self.fprops.model = tuple(m for m in model.split(",") if m)
        if self.in_specs:
            out = self.negotiate(list(self.in_specs))
            if old_out and out != old_out:
                raise NegotiationError(
                    f"{self.name}: reloaded model gives {out[0]}, negotiated {old_out[0]}"
                )
        self.fn_version += 1

    # -- micro-batching (pipeline/batching.py) -----------------------------
    def get_property(self, key: str, default: Any = None) -> Any:
        key = key.replace("_", "-")
        if key in self.READ_ONLY:
            return getattr(self, key.replace("-", "_"))
        return super().get_property(key, default)

    @property
    def avg_batch_size(self) -> float:
        s = self.batch_stats
        return s.avg_batch_size if s is not None else 0.0

    @property
    def pad_waste_pct(self) -> float:
        s = self.batch_stats
        return s.pad_waste_pct if s is not None else 0.0

    @property
    def batch_wait_ms(self) -> float:
        s = self.batch_stats
        return s.batch_wait_ms if s is not None else 0.0

    def is_batch_capable(self) -> bool:
        """The host path may batch only when the backend declared
        ``batchable``; a flexible stream's per-frame shapes cannot share
        one invoke."""
        if self._flexible_input:
            return False
        if self.plane:
            return True  # the local window is the plane's submission unit
        return bool(getattr(self._ensure_open(), "batchable", False))

    def host_process_batch(self, frames: List[Frame]) -> List[Frame]:
        """One invoke_batched() call for the window, the combinations
        applied per frame. A window of mixed shapes runs per frame. Under
        a plane the window is one blocking plane round trip, which the
        plane flattens with other streams' windows into one dispatch; a
        window error raises whole."""
        if self.plane:
            plane = self._acquire_plane()
            t0 = time.perf_counter_ns()
            model_outs = plane.submit_window(self._plane_stream, self._plane_window_inputs(frames))
            per = (time.perf_counter_ns() - t0) // max(1, len(frames))
            return self._finish_plane_window(frames, model_outs, per)
        sig0 = tuple((tuple(t.shape), t.dtype) for t in frames[0].tensors)
        if any(tuple((tuple(t.shape), t.dtype) for t in f.tensors) != sig0 for f in frames[1:]):
            return [self.host_process(f) for f in frames]
        b = self._ensure_open()
        in_comb, out_comb = self.in_combination, self.out_combination
        model_ins = [
            f.tensors if in_comb is None else tuple(f.tensors[i] for _, i in in_comb)
            for f in frames
        ]
        t0 = time.perf_counter_ns()
        model_outs = b.invoke_batched(model_ins)
        per = (time.perf_counter_ns() - t0) // max(1, len(frames))
        outs: List[Frame] = []
        for f, model_out in zip(frames, model_outs):
            b.stats.record(per)
            model_out = tuple(model_out)
            if out_comb is not None:
                model_out = tuple(
                    f.tensors[i] if kind == "i" else model_out[i] for kind, i in out_comb
                )
            outs.append(f.with_tensors(model_out))
        return outs

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
        if self._flexible_input or self.plane:
            # a plane filter dispatches into the shared queue: a fusion barrier
            return False
        return self._ensure_open().traceable_fn() is not None

    def make_fn(self) -> Callable:
        fn = self._ensure_open().traceable_fn()
        if fn is None:
            raise RuntimeError(f"{self.name}: backend not traceable")
        return self._apply_combinations(fn)

    def host_process(self, frame):
        if self.plane:
            return self.host_process_batch([frame])[0]
        invoke = self._apply_combinations(self._ensure_open().invoke_timed)
        return frame.with_tensors(tuple(invoke(frame.tensors)))
