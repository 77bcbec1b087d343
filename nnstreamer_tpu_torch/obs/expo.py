"""Metric exposition: Prometheus text format, JSON snapshots, HTTP server.

The counterpart of ``nnstreamer_tpu/obs/expo.py`` in the port (jax-free there
too, so the port keeps its own copy).

Three consumers, one data model (:class:`~.metrics.MetricsRegistry`):

- ``/metrics`` — Prometheus text exposition format 0.0.4 (the scrape
  target). Histograms render cumulative ``_bucket{le=...}`` series over
  the log ladder's upper edges; empty buckets are elided (``le`` labels
  are arbitrary as long as counts stay cumulative), so a 112-rung
  ladder costs lines only where data landed.
- ``/metrics.json`` — the full JSON snapshot: registry dump + the
  executor's per-node stats/totals when wired. ``nns-top`` polls this.
- ``nns-launch --metrics out.json`` — the same snapshot written once at
  EOS (:func:`dump_json`, atomic tmp + rename).

:class:`MetricsServer` is a stdlib ``ThreadingHTTPServer`` on a daemon
background thread, started by the executor when
``[executor] metrics_port`` / ``NNS_TPU_METRICS_PORT`` is set (default
off) and joined on ``Executor.stop()`` — it must never outlive the
pipeline as a leaked thread.
"""

from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.obs.metrics import (
    METRIC_CATALOG,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)

_log = get_logger("obs")


def _label_str(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    parts = []
    for k in sorted(labels):
        v = str(labels[k]).replace("\\", "\\\\").replace('"', '\\"')
        parts.append(f'{k}="{v}"')
    return "{" + ",".join(parts) + "}"


def _fmt(v: float) -> str:
    if v != v or v in (float("inf"), float("-inf")):
        return "NaN" if v != v else ("+Inf" if v > 0 else "-Inf")
    if isinstance(v, int) or float(v).is_integer():
        return str(int(v))
    return repr(float(v))


def to_prometheus(registry: MetricsRegistry) -> str:
    """Render the registry in Prometheus text exposition format."""
    by_name: Dict[str, list] = {}
    for m in registry.metrics():
        by_name.setdefault(m.name, []).append(m)
    out = []
    for name in sorted(by_name):
        group = by_name[name]
        out.append(f"# HELP {name} {METRIC_CATALOG.get(name, '')}")
        out.append(f"# TYPE {name} {group[0].kind}")
        for m in sorted(group, key=lambda m: sorted(m.labels.items())):
            if isinstance(m, (Counter, Gauge)):
                out.append(f"{name}{_label_str(m.labels)} {_fmt(m.value)}")
                continue
            assert isinstance(m, Histogram)
            cum = 0
            for i, c in enumerate(m.counts):
                if not c:
                    continue
                cum += c
                le = _label_str({**m.labels, "le": _fmt(m.edge(i + 1))})
                out.append(f"{name}_bucket{le} {cum}")
            inf = _label_str({**m.labels, "le": "+Inf"})
            out.append(f"{name}_bucket{inf} {m.count}")
            out.append(f"{name}_sum{_label_str(m.labels)} {_fmt(m.sum)}")
            out.append(f"{name}_count{_label_str(m.labels)} {m.count}")
    return "\n".join(out) + "\n"


def snapshot(
    registry: Optional[MetricsRegistry],
    stats: Optional[dict] = None,
    totals: Optional[dict] = None,
    process: Optional[str] = None,
) -> dict:
    """The JSON document ``/metrics.json`` serves and ``--metrics``
    dumps: per-node stats rows (what ``nns-top`` renders) plus the raw
    registry dump (what cross-process aggregation merges)."""
    return {
        "schema": "nns-obs/1",
        "process": process or f"pid{os.getpid()}",
        "time_unix_s": time.time(),
        "nodes": stats or {},
        "totals": totals or {},
        "metrics": registry.to_dict()["metrics"] if registry else [],
    }


def dump_json(path: str, doc: dict) -> None:
    """Atomic snapshot write (tmp + rename): a reader polling the file
    never sees a torn document."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=2)
    os.replace(tmp, path)


class _Handler(BaseHTTPRequestHandler):
    # the server object carries the registry/stats refs (stdlib pattern)
    def do_GET(self) -> None:  # noqa: N802 - stdlib API name
        srv = self.server
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            body = to_prometheus(srv.registry).encode()
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        elif path in ("/metrics.json", "/json"):
            body = json.dumps(srv.snapshot()).encode()
            ctype = "application/json"
        elif path == "/":
            body = (
                b"nns-obs metrics endpoint\n"
                b"  /metrics       Prometheus text format\n"
                b"  /metrics.json  JSON snapshot (nns-top polls this)\n"
            )
            ctype = "text/plain; charset=utf-8"
        else:
            self.send_error(404)
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt: str, *args) -> None:
        _log.debug("http: " + fmt, *args)


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True

    registry: MetricsRegistry
    stats_fn: Optional[Callable[[], dict]]
    totals_fn: Optional[Callable[[], dict]]
    process: Optional[str]

    def snapshot(self) -> dict:
        stats = totals = None
        try:
            if self.stats_fn is not None:
                stats = self.stats_fn()
            if self.totals_fn is not None:
                totals = self.totals_fn()
        except Exception as exc:  # noqa: BLE001 — a dying pipeline must
            # not take the exposition endpoint down with it
            _log.warning("stats snapshot failed: %s", exc)
        return snapshot(self.registry, stats, totals, self.process)


class MetricsServer:
    """Background exposition server. ``port=0`` binds an ephemeral port
    (read it back from ``.port`` — tests and same-host scrapers)."""

    def __init__(
        self,
        registry: MetricsRegistry,
        stats_fn: Optional[Callable[[], dict]] = None,
        totals_fn: Optional[Callable[[], dict]] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        process: Optional[str] = None,
    ) -> None:
        self._httpd = _Server((host, port), _Handler)
        self._httpd.registry = registry
        self._httpd.stats_fn = stats_fn
        self._httpd.totals_fn = totals_fn
        self._httpd.process = process
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="nns-obs-http",
            daemon=True,
        )

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "MetricsServer":
        self._thread.start()
        _log.info("metrics endpoint serving on %s/metrics", self.url)
        return self

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)
