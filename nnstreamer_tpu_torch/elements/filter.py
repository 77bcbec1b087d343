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
and each collected window is one plane round trip. Under ``plane=``,
``ring-depth`` (1..32, default ``[plane] inflight``) is the stream's
in-flight window tickets: at depth > 1 window N+1 submits while N
computes. ``plane-mode=replicas`` opens one backend a replica behind the
plane's failover (serving_plane/sharding.py ``ReplicatedProgram``);
``plane-mode=shard`` splits each window over a ``dp`` mesh of
``plane-devices`` positions (``MeshShardedProgram``).

Placement: ``device=N`` pins the filter to ``cuda:N`` (the one CPU
device on the CPU), range-checked before any load; it rides ``custom=``
as ``device:N``, which the placement planner (serving_plane/placement.py)
sets too. A pinned plane filter still batches through the plane's own
program on its device. ``accelerator=`` is the reference's string: its
``mesh=`` clause (``true:gpu:mesh=dp2tp4``) shards the model over a mesh
as ``custom="mesh:..."`` does (backends/torch_backend.py).

Streaming (pipeline/transfer.py, pipeline/chain_program.py): without a
plane, ``ring-depth`` is the in-flight frame ring of the filter's node
(default ``[executor] ring_depth`` = 2 on a fused segment; 1 delivers each
frame as it is made), and ``chain-mode=off`` keeps the filter's chain on
the per-node path (default ``[executor] chain_mode`` = auto).

Faults (pipeline/faults.py, pipeline/device_faults.py): ``on-error``,
``retry-max`` and ``retry-backoff-ms`` (the per-frame error policy, with
the ``src_1`` error pad under route/retry), ``oom-policy`` and
``device-fallback`` (the OOM ladder and the device circuit of the filter's
segment). ``fallback-framework`` / ``fallback-model`` / ``fallback-after``
/ ``fallback-probe-every`` swap to a fallback backend after consecutive
failures and probe the primary for recovery. ``replicas=N`` opens N
backends (``replica-devices`` pins them to ``cuda:<i>``, range-checked
before any load; on the CPU every index is the one CPU device) behind a
``ReplicaSet`` (parallel/replicas.py) with ``replica-unhealthy-after`` and
``replica-probe-every``. ``shared-tensor-filter-key`` shares one opened
backend among every filter with the key (one weight copy, a reload swaps
it for all). A configured fallback or replicas make the filter a host
node. The conflicting combinations raise at construction.

A flexible input stream (a converter subplugin's, a host-mode
``tensor_crop``'s) negotiates against the model's own spec; each frame
is checked at invoke, and such a filter runs per frame on the host path,
never fused.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.backends.base import Backend, BackendError, FilterProps, InvokeStats
from nnstreamer_tpu_torch.elements.base import (
    DEVICE_PROPS,
    FAULT_PROPS,
    NegotiationError,
    PropSpec,
    parse_bool,
    Spec,
    TensorOp,
    install_error_pad,
)
from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.tensors.frame import Frame
from nnstreamer_tpu_torch.tensors.spec import TensorsSpec

_log = get_logger("filter")

Combination = Optional[List[Tuple[str, int]]]

# the shared-model table: filters with one shared-tensor-filter-key share
# ONE opened backend (one copy of the weights; a reload through any sharer
# swaps the model for all). key -> {"backend", "refs", "sig", "open_lock"}
_shared_lock = threading.Lock()
_shared_backends: Dict[str, Dict] = {}


def _props_signature(p: FilterProps) -> tuple:
    """Everything that shapes an opened backend: sharers must agree on all
    of it, not only the model path."""
    return (p.framework, p.model, p.custom, p.accelerator, p.invoke_dynamic,
            str(p.input_spec), str(p.output_spec), str(p.device))


def _shared_acquire(key: str, props: FilterProps, opener: Callable[[], Backend]) -> Backend:
    sig = _props_signature(props)
    with _shared_lock:
        entry = _shared_backends.get(key)
        if entry is None:
            entry = {"backend": None, "refs": 0, "sig": sig, "open_lock": threading.Lock()}
            _shared_backends[key] = entry
        elif entry["sig"] != sig:
            raise NegotiationError(f"shared-tensor-filter-key={key!r} already bound to "
                                   f"{entry['sig']}, cannot rebind to {sig}")
        entry["refs"] += 1
    try:
        # a lock per key: opens for different keys do not serialize
        with entry["open_lock"]:
            if entry["backend"] is None:
                backend = opener()
                # sharers invoke from their own executor threads, and a
                # stateful host backend is not reentrant
                backend.shared_invoke_lock = threading.Lock()
                entry["backend"] = backend
        return entry["backend"]
    except Exception:
        with _shared_lock:
            entry["refs"] -= 1
            if entry["refs"] <= 0 and entry["backend"] is None:
                _shared_backends.pop(key, None)
        raise


def _shared_release(key: str, backend: Backend) -> bool:
    """Drop one ref; True when the caller should close the backend."""
    with _shared_lock:
        entry = _shared_backends.get(key)
        if entry is None or entry["backend"] is not backend:
            return True  # not (or no longer) shared: the caller owns it
        entry["refs"] -= 1
        if entry["refs"] <= 0:
            del _shared_backends[key]
            return True
        return False


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
        "accelerator": PropSpec(
            "str", "", desc="the reference's accelerator string; mesh=dp2tp4 shards the model"),
        # per-stage placement (serving_plane/placement.py): rides the custom
        # string as device:N, so the explicit prop and the planner share the
        # backend's placement path
        "device": PropSpec(
            "int", None, desc="pin this stage to cuda:N (the one CPU device on the CPU)"),
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
            "int", None,
            desc="in-flight frames of the filter's node, 1..32 ([executor] ring_depth = 2; "
            "1 delivers each frame as it is made); under plane= the stream's in-flight "
            "window tickets ([plane] inflight)"),
        "chain-mode": PropSpec(
            "enum", None, ("auto", "off"),
            desc="whole-chain program for the chain this filter belongs to: auto runs an "
            "eligible chain as one CUDA graph a window, off keeps the per-node path "
            "([executor] chain_mode = auto)"),
        "shared-tensor-filter-key": PropSpec(
            "str", "", desc="filters with one key share one opened backend"),
        # per-frame error policy (pipeline/faults.py) and device resilience
        # (pipeline/device_faults.py)
        **FAULT_PROPS,
        **DEVICE_PROPS,
        # the backend-swap breaker: after fallback-after consecutive
        # failures the fallback backend serves, the primary probed every
        # fallback-probe-every frames
        "fallback-framework": PropSpec("str", "", desc="degraded-mode backend"),
        "fallback-model": PropSpec("str", "", desc="degraded-mode model path(s)"),
        "fallback-after": PropSpec("int", 3, desc="consecutive failures that open the circuit"),
        "fallback-probe-every": PropSpec("int", 64, desc="frames between primary probes"),
        # replica failover (parallel/replicas.py)
        "replicas": PropSpec("int", None, desc="open N backend replicas with failover"),
        "replica-devices": PropSpec(
            "str", "", desc="device indices to pin replicas to (round-robin)"),
        "replica-unhealthy-after": PropSpec(
            "int", 3, desc="consecutive device faults that bench a replica"),
        "replica-probe-every": PropSpec(
            "int", 64, desc="frames between benched-replica recovery probes"),
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
        custom = str(self.get_property("custom", ""))
        dev_raw = self.get_property("device")
        if dev_raw is not None and str(dev_raw).strip() != "":
            try:
                dev_idx = int(dev_raw)
            except (TypeError, ValueError) as exc:
                raise ValueError(f"{self.name}: bad device={dev_raw!r}: {exc}") from exc
            custom = ",".join(x for x in (custom, f"device:{dev_idx}") if x)
        self.fprops = FilterProps(
            framework=framework,
            model=model_list,
            input_spec=in_override,
            output_spec=out_override,
            custom=custom,
            accelerator=str(self.get_property("accelerator", "") or ""),
            invoke_dynamic=parse_bool(self.get_property("invoke-dynamic", False)),
        )
        self.in_combination = _parse_combination(str(self.get_property("input-combination", "")))
        self.out_combination = _parse_combination(
            str(self.get_property("output-combination", "")))
        self.backend: Optional[Backend] = None
        self._flexible_input = False
        self.shared_key = str(self.get_property("shared-tensor-filter-key", "") or "")
        install_error_pad(self)
        self._init_fallback()
        self._init_replicas()
        self._init_plane()
        self._refuse_conflicts()
        # warm-restart state that arrives before the backend or the replica
        # set exists (both open lazily): applied as each comes up
        self._pending_state: Optional[Dict[str, Any]] = None
        # this element's own invokes (sharers of one backend do not report
        # each other's); the backend keeps the per-framework view
        self._elem_stats = InvokeStats()

    def _init_fallback(self) -> None:
        self.fallback_framework = str(self.get_property("fallback-framework", "") or "")
        self.fallback_model = str(self.get_property("fallback-model", "") or "")
        self._fallback_conf = bool(self.fallback_framework or self.fallback_model)
        self.fallback_after = max(1, int(self.get_property("fallback-after", 3)))
        self.fallback_probe_every = max(1, int(self.get_property("fallback-probe-every", 64)))
        self._fb_backend: Optional[Backend] = None
        self._fb_open_error: Optional[Exception] = None
        self._consec_failures = 0
        self._circuit_open = False
        self._since_probe = 0
        self._cb = {"primary_failures": 0, "circuit_opens": 0, "circuit_closes": 0,
                    "fallback_invokes": 0}

    def _init_replicas(self) -> None:
        self.replicas = int(self.get_property("replicas", 0) or 0)
        self.replica_devices = [
            int(d) for d in str(self.get_property("replica-devices", "") or "").split(",")
            if str(d).strip()
        ]
        self.replica_unhealthy_after = max(
            1, int(self.get_property("replica-unhealthy-after", 3)))
        self.replica_probe_every = max(1, int(self.get_property("replica-probe-every", 64)))
        self._replica_set = None  # ReplicaSet, built on the first frame
        self._replica_backends: List[Backend] = []
        self._replica_last_stats: Dict[str, Any] = {}

    def _refuse_conflicts(self) -> None:
        """The combinations the reference refuses, with the same messages."""
        if self.replicas > 1 and self.shared_key:
            raise ValueError(
                f"{self.name}: replicas={self.replicas} cannot combine with "
                "shared-tensor-filter-key (one shared instance vs N independent copies)")
        if self.plane:
            if self.shared_key:
                raise ValueError(
                    f"{self.name}: plane={self.plane!r} cannot combine with "
                    "shared-tensor-filter-key (the plane IS the shared instance)")
            if self.replicas > 1:
                raise ValueError(
                    f"{self.name}: plane={self.plane!r} cannot combine with replicas=N "
                    "(use plane-mode=replicas — the plane replicates its own program)")
            if self._fallback_conf:
                raise ValueError(
                    f"{self.name}: plane={self.plane!r} cannot combine with "
                    "fallback-framework/fallback-model (plane faults dispose per "
                    "stream via on-error)")
        if self.replicas > 1 and self._fallback_conf:
            raise ValueError(
                f"{self.name}: replicas={self.replicas} cannot combine with "
                "fallback-framework/fallback-model (failover replaces the fallback "
                "circuit; use on-error for post-exhaustion disposal)")

    # -- serving plane (serving_plane/plane.py) ----------------------------
    def _init_plane(self) -> None:
        """Resolve the plane config and this stream's ticket depth, and
        default the local collector on, window-matched to the plane
        (explicit batching= / max-batch= props still win)."""
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
            # the executor's in-flight frame ring takes it (pipeline/transfer.py)
            return
        from nnstreamer_tpu_torch.serving_plane.plane import resolve_plane_config

        self._plane_cfg = resolve_plane_config([self])
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

    def _open_backend(self, custom_extra: str = "", device: Optional[torch.device] = None
                      ) -> Backend:
        cls = registry.get(registry.KIND_FILTER, self.fprops.framework)
        b: Backend = cls()
        self.fprops.device = self.device
        props = self.fprops
        if custom_extra or device is not None:
            props = dataclasses.replace(
                props, custom=",".join(x for x in (props.custom, custom_extra) if x),
                device=device if device is not None else props.device)
        b.open(props)
        return b

    def _replica_device(self, i: int) -> torch.device:
        """Replica ``i``'s device: ``cuda:<replica-devices[i % n]>`` on
        CUDA, range-checked before any load; on the CPU (or without
        replica-devices) the filter's device."""
        if not self.replica_devices or self.device.type != "cuda":
            return self.device
        idx = self.replica_devices[i % len(self.replica_devices)]
        n = torch.cuda.device_count()
        if not 0 <= idx < n:
            raise ValueError(f"{self.name}: replica-devices index {idx} out of range "
                             f"({n} CUDA device(s))")
        return torch.device("cuda", idx)

    def _open_replica(self, i: int) -> Backend:
        """Replica ``i``: ``_replica:<i>`` appended to custom (the chaos
        injectors scope device faults to one replica by it) on its device."""
        return self._open_backend(f"_replica:{i}", self._replica_device(i))

    def _acquire_plane(self):
        """Get-or-create the named plane and attach this filter as one
        stream. Reached at negotiation (the plane's backend is the
        model-info surface), so the plane's service thread predates every
        executor start."""
        if self._plane is None:
            from nnstreamer_tpu_torch.serving_plane import plane as plane_mod

            if self._plane_cfg.mode == "shard":
                # a mesh past the positions of this device's kind raises
                # naming both counts, before any backend opens
                from nnstreamer_tpu_torch.parallel.mesh import available_devices

                have = len(available_devices(self.device.type))
                if self._plane_cfg.devices > have:
                    raise ValueError(f"plane-mode=shard needs {self._plane_cfg.devices} "
                                     f"devices, have {have}")

            # a sharer that set no plane-* knobs INHERITS the first
            # attacher's bound config instead of colliding with it
            explicit = any(
                self.get_property(k) is not None
                for k in ("plane-max-batch", "plane-timeout-ms", "plane-mode", "plane-devices")
            )
            sig = (self.fprops.framework, self.fprops.model, self.fprops.custom,
                   self.fprops.accelerator, self.fprops.invoke_dynamic,
                   str(self.fprops.input_spec),
                   str(self.fprops.output_spec), str(self.device))
            def opener(i: int, replicated: bool) -> Backend:
                # a replica carries _replica:<i>, so the chaos injectors'
                # only_replica scopes to one replica of the plane too; the
                # replicas go round-robin over the visible cards
                if not replicated:
                    return self._open_backend()
                dev = self.device
                if dev.type == "cuda":
                    dev = torch.device("cuda", i % torch.cuda.device_count())
                return self._open_backend(f"_replica:{i}", dev)

            self._plane = plane_mod.acquire(
                self.plane, sig, self._plane_cfg, opener, cfg_explicit=explicit,
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
            if self.plane:
                self.backend = self._acquire_plane().backend
            elif self.shared_key:
                self.fprops.device = self.device
                self.backend = _shared_acquire(self.shared_key, self.fprops, self._open_backend)
            elif self.replicas > 1:
                for i in range(self.replicas):  # every pin checked before any load
                    self._replica_device(i)
                # replica 0 doubles as the negotiation backend
                self.backend = self._open_replica(0)
            else:
                self.backend = self._open_backend()
            self._apply_pending_state()
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
            if not self.shared_key or _shared_release(self.shared_key, self.backend):
                self.backend.close()
            self.backend = None
        for b in self._replica_backends[1:]:  # replica 0 IS self.backend
            try:
                b.close()
            except Exception as exc:  # noqa: BLE001 — teardown goes on
                _log.warning("%s: replica close failed: %s", self.name, exc)
        self._replica_backends = []
        if self._replica_set is not None:
            # the counters outlive teardown, for reads after stop
            self._replica_last_stats = self._replica_set.stats()
            self._replica_set = None
        if self._fb_backend is not None:
            self._fb_backend.close()
            self._fb_backend = None

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
        if self.shared_key:
            # the shared instance swaps in place: every sharer sees it
            self._ensure_open().reload(tuple(m for m in model.split(",") if m))
            self.fn_version += 1
            return
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
        if self._flexible_input or self._fallback_conf or self.replicas > 1:
            # the breaker and failover work at frame granularity
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
        lock = getattr(b, "shared_invoke_lock", None)
        t0 = time.perf_counter_ns()
        if lock is not None:
            with lock:
                model_outs = b.invoke_batched(model_ins)
        else:
            model_outs = b.invoke_batched(model_ins)
        per = (time.perf_counter_ns() - t0) // max(1, len(frames))
        outs: List[Frame] = []
        for f, model_out in zip(frames, model_outs):
            b.stats.record(per)
            self._elem_stats.record(per)
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
        self._negotiated_model_in = model_in  # a fallback opens to this spec
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
        self._model_out_spec = out
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
        if self._flexible_input or self.plane or self._fallback_conf or self.replicas > 1:
            # a plane filter dispatches into the shared queue; the breaker
            # and failover swap backends per frame: each a fusion barrier
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
        if self.replicas > 1:
            # a device fault fails the frame over to the next healthy
            # replica; ReplicaExhaustedError goes to the node's on-error
            return self._ensure_replicas().dispatch(frame)
        if not self._fallback_conf:
            return self._invoke(self._ensure_open(), frame)
        # the breaker: consecutive primary failures open it and the
        # fallback serves; a probe every fallback-probe-every frames
        # closes it once the primary recovers
        if self._circuit_open:
            self._since_probe += 1
            if self._since_probe >= self.fallback_probe_every:
                self._since_probe = 0
                try:
                    out = self._invoke(self._ensure_open(), frame)
                except Exception as exc:  # noqa: BLE001 — the probe failed
                    self._cb["primary_failures"] += 1
                    _log.debug("%s: recovery probe failed: %s", self.name, exc)
                else:
                    self._circuit_open = False
                    self._consec_failures = 0
                    self._cb["circuit_closes"] += 1
                    _log.warning("%s: primary backend recovered; circuit closed", self.name)
                    return out
            return self._invoke_fallback(frame)
        try:
            out = self._invoke(self._ensure_open(), frame)
        except Exception:
            self._consec_failures += 1
            self._cb["primary_failures"] += 1
            if self._consec_failures >= self.fallback_after:
                self._circuit_open = True
                self._since_probe = 0
                self._cb["circuit_opens"] += 1
                _log.warning("%s: %d consecutive backend failures; circuit OPEN, serving "
                             "from fallback %s", self.name, self._consec_failures,
                             self.fallback_framework or self.fprops.framework)
                return self._invoke_fallback(frame)
            raise  # below the threshold: the node's on-error decides
        self._consec_failures = 0
        return out

    def _invoke(self, b: Backend, frame: Frame) -> Frame:
        """One frame through backend ``b`` (under a shared backend's lock),
        timed into this element's stats."""
        fn = self._apply_combinations(b.invoke_timed)
        lock = getattr(b, "shared_invoke_lock", None)
        if lock is not None:
            with lock:
                t0 = time.perf_counter_ns()
                out = fn(frame.tensors)
                dt = time.perf_counter_ns() - t0
        else:
            t0 = time.perf_counter_ns()
            out = fn(frame.tensors)
            dt = time.perf_counter_ns() - t0
        self._elem_stats.record(dt)
        return frame.with_tensors(tuple(out))

    @property
    def invoke_stats(self) -> InvokeStats:
        """This element's own invokes (they survive teardown)."""
        return self._elem_stats

    # -- the backend-swap breaker ------------------------------------------
    def _ensure_fallback(self) -> Backend:
        if self._fb_open_error is not None:
            # latched: a misconfigured fallback must not become a model
            # load per frame while the circuit is open
            raise BackendError(f"{self.name}: fallback backend failed to open: "
                               f"{self._fb_open_error}") from self._fb_open_error
        if self._fb_backend is None:
            try:
                self._fb_backend = self._open_fallback()
            except Exception as exc:
                self._fb_open_error = exc
                raise
        return self._fb_backend

    def _open_fallback(self) -> Backend:
        fw = self.fallback_framework or self.fprops.framework
        models = tuple(m for m in self.fallback_model.split(",") if m) or self.fprops.model
        props = dataclasses.replace(self.fprops, framework=fw, model=models, device=self.device)
        b: Backend = registry.get(registry.KIND_FILTER, fw)()
        b.open(props)
        # the swap is invisible downstream only if the fallback keeps the
        # negotiated output spec: checked once, at open
        model_in = getattr(self, "_negotiated_model_in", None)
        if model_in is not None and model_in.is_static:
            try:
                cur_in, fb_out = b.get_model_info()
            except Exception:
                fb_out = b.set_input_info(model_in)
            else:
                if not cur_in.is_compatible(model_in):
                    fb_out = b.set_input_info(model_in)
            want = getattr(self, "_model_out_spec", None)
            if want is not None and not fb_out.is_compatible(want):
                b.close()
                raise BackendError(f"{self.name}: fallback output spec {fb_out} is not "
                                   f"compatible with the negotiated {want}")
        return b

    def _invoke_fallback(self, frame: Frame) -> Frame:
        out = self._invoke(self._ensure_fallback(), frame)
        self._cb["fallback_invokes"] += 1
        return out

    def circuit_stats(self) -> Dict[str, Any]:
        """The breaker's counters (``cb_*`` in Executor.stats); {} without
        a fallback."""
        if not self._fallback_conf:
            return {}
        return {**self._cb, "fallback_active": 1 if self._circuit_open else 0}

    # -- replica failover (parallel/replicas.py) ---------------------------
    def _ensure_replicas(self):
        """Open replicas 1..N-1 beside replica 0 and build the ReplicaSet,
        on the first frame (after negotiation settled the specs). A replica
        that fails to open closes the ones opened before it."""
        if self._replica_set is None:
            from nnstreamer_tpu_torch.parallel.replicas import ReplicaSet

            backends = [self._ensure_open()]
            try:
                for i in range(1, self.replicas):
                    b = self._open_replica(i)
                    backends.append(b)
                    model_in = getattr(self, "_negotiated_model_in", None)
                    if model_in is not None and model_in.is_static:
                        try:
                            cur_in, _ = b.get_model_info()
                        except Exception:
                            cur_in = None
                        if cur_in is None or not cur_in.is_compatible(model_in):
                            b.set_input_info(model_in)
            except Exception:
                for b in backends[1:]:
                    try:
                        b.close()
                    except Exception as exc:  # noqa: BLE001
                        _log.warning("%s: replica close failed: %s", self.name, exc)
                raise
            self._replica_backends = backends
            self._replica_set = ReplicaSet(
                [self._make_replica_invoke(b) for b in backends],
                unhealthy_after=self.replica_unhealthy_after,
                probe_every=self.replica_probe_every,
            )
            self._apply_pending_state()
        return self._replica_set

    def _make_replica_invoke(self, b: Backend):
        dev = b.props.device if b.props is not None else self.device

        def invoke(frame: Frame) -> Frame:
            # the replica's device, and the frame back on the filter's
            out = self._invoke(b, frame.to_device(dev))
            return out if dev == self.device else out.to_device(self.device)

        return invoke

    def replica_stats(self) -> Dict[str, Any]:
        """Failover counters (``rep_*`` in Executor.stats); {} without
        replicas."""
        if self._replica_set is None:
            return self._replica_last_stats
        return self._replica_set.stats()

    # -- warm restart --------------------------------------------------------
    def state_snapshot(self) -> Dict[str, Any]:
        """Executor.snapshot's hook: the backend's own state (a stateful
        backend's), the replica set's health and each other replica's
        state."""
        d: Dict[str, Any] = {}
        hook = getattr(self.backend, "state_snapshot", None)
        if callable(hook):
            d["backend"] = hook()
        if self._replica_set is not None:
            d["replica_set"] = self._replica_set.snapshot()
            reps = []
            for b in self._replica_backends[1:]:
                h = getattr(b, "state_snapshot", None)
                reps.append(h() if callable(h) else None)
            if any(r is not None for r in reps):
                d["replica_backends"] = reps
        return d

    def state_restore(self, snap: Dict[str, Any]) -> None:
        """Restoring into a fresh executor comes before the first frame,
        when the backend or the replica set may not exist yet: what cannot
        apply now is stashed and applied as each comes up."""
        self._pending_state = dict(snap)
        self._apply_pending_state()

    def _apply_pending_state(self) -> None:
        snap = getattr(self, "_pending_state", None)
        if not snap:
            return
        if "backend" in snap and self.backend is not None:
            hook = getattr(self.backend, "state_restore", None)
            if callable(hook):
                hook(snap["backend"])
            del snap["backend"]
        if "replica_set" in snap and self._replica_set is not None:
            self._replica_set.restore(snap["replica_set"])
            del snap["replica_set"]
        if "replica_backends" in snap and self._replica_backends:
            for b, st in zip(self._replica_backends[1:], snap["replica_backends"]):
                h = getattr(b, "state_restore", None)
                if st is not None and callable(h):
                    h(st)
            del snap["replica_backends"]
        if not snap:
            self._pending_state = None
