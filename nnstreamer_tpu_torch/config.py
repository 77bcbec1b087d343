"""Layered configuration: env vars > ini file > hardcoded defaults.

The part of ``nnstreamer_tpu/config.py`` that the port reads: plugin
search paths, the element restriction whitelist, the framework
auto-detect priority, the ``[executor]`` micro-batching, fault-policy,
device-resilience, frame-ring, chain, sanitizer and metrics defaults, the
``[plane]`` serving-plane defaults, the ``[mesh]`` CPU mesh size and the
``[llm]`` serving defaults. Env mapping:
section ``filter`` key ``framework_priority_pt`` is overridden by
``NNS_TPU_FILTER_FRAMEWORK_PRIORITY_PT``. The ini file is read only from
the path in ``NNS_TPU_CONF``.
"""

from __future__ import annotations

import configparser
import os
import threading
from typing import Dict, List, Optional

_DEFAULTS: Dict[str, Dict[str, str]] = {
    "common": {
        "enable_envvar": "true",
        # comma list of allowed elements; empty = all
        "restricted_elements": "",
    },
    "filter": {
        # search paths for out-of-tree backend plugins; colon separated
        "plugin_paths": "",
        # model-extension → backend auto-detection priority: the first
        # registered candidate wins (a .tflite goes to the host interpreter
        # first, as in the reference, then to the port's own program)
        "framework_priority_py": "custom",
        "framework_priority_tflite": "tflite,torch",
        "framework_priority_pt": "torch",
        "framework_priority_pth": "torch",
    },
    "decoder": {"plugin_paths": ""},
    "executor": {
        # micro-batching defaults for fused segments and batchable filters
        # (pipeline/batching.py); tensor_filter's batching=, max-batch=,
        # batch-timeout-ms= and batch-buckets= override them. Env:
        # NNS_TPU_EXECUTOR_BATCHING etc.
        "batching": "false",
        "max_batch": "8",
        "batch_timeout_ms": "1.0",
        # comma list of padded batch sizes; empty = 1,2,4,...,max_batch
        "batch_buckets": "",
        # per-frame error policy (pipeline/faults.py): stop | drop | retry
        # | route; an element's on-error=, retry-max= and
        # retry-backoff-ms= override. Env: NNS_TPU_EXECUTOR_ON_ERROR etc.
        "on_error": "stop",
        "retry_max": "3",
        "retry_backoff_ms": "10.0",
        "retry_backoff_cap_ms": "1000.0",
        # stall watchdog: >0 arms the executor's monitor thread, which
        # turns a hang into a typed PipelineStallError (0 = off)
        "watchdog_timeout_ms": "0",
        # device resilience (pipeline/device_faults.py): the OOM ladder
        # (degrade | stop), the device circuit around a segment's CUDA
        # graphs and its cadence; the filter's oom-policy= and
        # device-fallback= override the first two
        "oom_policy": "degrade",
        "device_fallback": "true",
        "device_fallback_after": "3",
        "device_probe_every": "64",
        "oom_reprobe_ms": "30000.0",
        # the in-flight frame ring (pipeline/transfer.py): frames each
        # device node keeps submitted before it delivers the oldest (H2D
        # of N+1, compute of N and the D2H of N-1 overlap; 1 = deliver
        # each frame as it is made). A filter's ring-depth= overrides.
        # donate is read and has no effect: a CUDA graph copies its
        # inputs into its own static buffers, so there is nothing to
        # donate. Env: NNS_TPU_EXECUTOR_RING_DEPTH etc.
        "ring_depth": "2",
        "donate": "true",
        # whole-chain programs (pipeline/chain_program.py): auto runs every
        # eligible chain of fused segments as ONE CUDA graph a window of
        # chain_unroll frames; off keeps each segment's own program. A
        # member's chain-mode=off overrides.
        "chain_mode": "auto",
        "chain_unroll": "4",
        # the transfer cross-check (analysis/costmodel.py): stop() holds
        # the static transfer prediction to the run's tally and logs the
        # delta; NNS_XRAY_CROSSCHECK is read first
        "xray_crosscheck": "false",
        # the runtime sanitizer (pipeline/sanitize.py); NNS_TPU_SANITIZE
        # is the one-knob env opt-in, read before this key
        "sanitize": "false",
        # live metrics (obs/): metrics turns the per-element histograms
        # on (p50/p95/p99 in Executor.stats and --stats); metrics_port > 0
        # also serves /metrics and /metrics.json from a background thread.
        # NNS_TPU_METRICS / NNS_TPU_METRICS_PORT are read first.
        "metrics": "false",
        "metrics_port": "0",
        # the endpoint's bind address: loopback unless widened on purpose
        "metrics_host": "127.0.0.1",
    },
    "converter": {"plugin_paths": ""},
    "plane": {
        # serving-plane defaults (serving_plane/plane.py); tensor_filter's
        # plane-* properties override. Env: NNS_TPU_PLANE_MAX_BATCH etc.
        "max_batch": "8",
        "timeout_ms": "1.0",
        # single | shard (a dp mesh of plane-devices positions) | replicas
        "mode": "single",
        # devices backing the plane: mesh size (shard) / replica count
        "devices": "1",
        # replica health under mode=replicas (parallel/replicas.py):
        # consecutive device faults that bench a replica, and dispatches
        # between recovery probes of a benched one
        "unhealthy_after": "3",
        "probe_every": "64",
        # a submit with no service inside this window fails typed
        # (service thread dead / program wedged), never hangs a node
        "submit_timeout_s": "30",
        # per-stream in-flight window tickets (1 = blocking submits);
        # tensor_filter ring-depth= outranks it
        "inflight": "1",
        # the device memory a deployment may use, bytes (K/M/G suffixes);
        # empty = no bound. A compiled chain's window is clamped to it
        # (pipeline/chain_program.py)
        "memory_per_device": "",
    },
    "mesh": {
        # the mesh positions the CPU offers when a caller asks for a CPU
        # mesh (parallel/mesh.py): every position is the CPU device, the
        # analogue of the reference's virtual CPU devices. Env:
        # NNS_TPU_MESH_CPU_DEVICES
        "cpu_devices": "1",
    },
    "llm": {
        # continuous-batching LLM serving defaults (tensor_llm_serversink
        # props override). kv_layout: slot (one contiguous worst-case cache
        # per slot) | paged (block arena + per-request block tables with
        # prefix sharing, chunked prefill and preemption by eviction)
        "kv_layout": "slot",
        # decode attention: xla (inline masked attention) | pallas (the
        # decode-attention kernels: K3 on the slot layout, K4 on the paged
        # one; CUDA on the card)
        "attn_impl": "xla",
        # paged decode formulation: auto (= block) | block (attend the
        # arena through the block tables, in-place token writes) | gather
        # (a contiguous view per step: the oracle, xla only)
        "kv_attn": "auto",
        # tokens per KV block (paged); must divide prompt-len and max-len
        "block_size": "16",
        # usable blocks in the arena (paged); empty = enough for every slot
        # at max-len (no saving: size it below that to save memory)
        "kv_blocks": "",
        # prefill buckets advanced per step or pump (paged chunked
        # prefill): bounds how long one prompt can stall decoding slots
        "prefill_chunks": "1",
        # the declared KV memory bound (K/M/G suffixes) nns-lint holds an
        # LLM serversink's KV cache to (NNS-W115 / W117); the element's
        # kv-memory-bound outranks it
        "memory_bound": "",
    },
}

_ENV_PREFIX = "NNS_TPU_"


class Config:
    """Thread-safe layered config with the reference's 3-level priority."""

    def __init__(self, ini_path: Optional[str] = None):
        self._lock = threading.Lock()
        self._parser = configparser.ConfigParser()
        self.load(ini_path)

    def load(self, ini_path: Optional[str] = None) -> None:
        with self._lock:
            self._parser = configparser.ConfigParser()
            path = ini_path or os.environ.get(_ENV_PREFIX + "CONF")
            if path and os.path.isfile(path):
                self._parser.read(path)

    @property
    def env_enabled(self) -> bool:
        raw = self._layered("common", "enable_envvar", use_env=False)
        return raw.strip().lower() in ("1", "true", "yes", "on")

    def _layered(self, section: str, key: str, use_env: bool = True) -> str:
        if use_env:
            env_key = f"{_ENV_PREFIX}{section.upper()}_{key.upper()}"
            if env_key in os.environ:
                return os.environ[env_key]
        if self._parser.has_option(section, key):
            return self._parser.get(section, key)
        return _DEFAULTS.get(section, {}).get(key, "")

    def get(self, section: str, key: str, default: str = "") -> str:
        val = self._layered(section, key, use_env=self.env_enabled)
        return val if val != "" else default

    def get_bool(self, section: str, key: str, default: bool = False) -> bool:
        raw = self.get(section, key, "")
        if raw == "":
            return default
        return raw.strip().lower() in ("1", "true", "yes", "on")

    def get_int(self, section: str, key: str, default: int = 0) -> int:
        raw = self.get(section, key, "")
        try:
            return int(raw) if raw != "" else default
        except ValueError:
            return default

    def get_list(self, section: str, key: str, sep: str = ",") -> List[str]:
        raw = self.get(section, key, "")
        return [p.strip() for p in raw.split(sep) if p.strip()]

    def plugin_paths(self, kind: str) -> List[str]:
        return self.get_list(kind, "plugin_paths", sep=":")

    def framework_priority(self, model_ext: str) -> List[str]:
        return self.get_list("filter", f"framework_priority_{model_ext.lstrip('.')}")


_global: Optional[Config] = None
_global_lock = threading.Lock()


def conf() -> Config:
    """Global config singleton, loaded on first use."""
    global _global
    with _global_lock:
        if _global is None:
            _global = Config()
        return _global
