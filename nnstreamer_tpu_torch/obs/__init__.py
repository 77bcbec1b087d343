"""nns-obs: metrics & live-telemetry subsystem.

The counterpart of ``nnstreamer_tpu/obs/__init__.py`` in the port (jax-free there
too, so the port keeps its own copy).

The reference ecosystem leans on out-of-tree GstShark/NNShark for
per-element telemetry; in-tree ``trace.py`` gives
post-hoc chrome-trace spans, and ``Executor.stats()`` reported only
means. This package is the live half of observability:

- :mod:`nnstreamer_tpu_torch.obs.metrics` — a :class:`MetricsRegistry` of
  Counter/Gauge/Histogram primitives (fixed log-scaled buckets, cheap
  under the executor's per-frame single-writer discipline, mergeable
  across nodes/processes) with p50/p95/p99 quantile estimates.
- :mod:`nnstreamer_tpu_torch.obs.expo` — Prometheus text format and a JSON
  snapshot from a stdlib-http background thread
  (``[executor] metrics_port`` / ``NNS_TPU_METRICS_PORT``, default off)
  plus the one-shot ``nns-launch --metrics out.json`` dump.
- :mod:`nnstreamer_tpu_torch.obs.nns_top` — the ``nns-top`` console script: a
  live per-element table (fps, p50/p99, queue depth, batch avg /
  pad-waste, retry/circuit-breaker state, san_* counters) against the
  JSON endpoint or an in-process executor.

Enable via :func:`enable` / ``NNS_TPU_METRICS=1`` /
``[executor] metrics`` — disabled (the default) the hot path pays one
``None`` attribute check per frame, mirroring ``trace.get()``.
"""

from nnstreamer_tpu_torch.obs.metrics import (  # noqa: F401  (re-export)
    METRIC_CATALOG,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    disable,
    enable,
    get,
)
