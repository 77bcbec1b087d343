"""nns-top: live per-element console view of a running pipeline.

The counterpart of ``nnstreamer_tpu/obs/nns_top.py`` (``nns-top-torch``
as a console script), over the port's executor and its snapshot format:
a top(1)-style table
refreshed in place, one row per pipeline element —

    ELEMENT        FPS  FRAMES  P50ms  P99ms  Q  BATCH  PAD%  ERR  NOTES

Data sources (pick one):

- ``nns-top http://host:9464`` — poll a live ``/metrics.json`` endpoint
  (``[executor] metrics_port`` / ``NNS_TPU_METRICS_PORT``).
- ``nns-top out.json`` — render a one-shot snapshot file
  (``nns-launch --metrics out.json``), re-reading it each interval.
- in-process: ``nns_top.watch(executor)`` renders the same table from a
  live :class:`~nnstreamer_tpu_torch.pipeline.executor.Executor` without any
  HTTP hop (notebooks, tests).

FPS is computed by differencing ``frames`` between polls when a
previous snapshot exists (the live rate), falling back to each row's
cumulative ``fps`` field (which includes compile/warmup).

``--clients`` switches to the per-client admission view (one row per
query-server client: queued/inflight/admitted/rejected, plus reject
reasons — docs/edge-serving.md).

``--fleet`` switches to the per-endpoint fleet view (one row per
fleet-client endpoint: state/score/inflight/failovers from the health
scorer, plus each query server's drain readiness flag —
docs/edge-serving.md "Running a fleet").

``--models`` switches to the per-plane serving view (one row per
serving plane: mode/devices, attached streams, cross-stream queue
depth, dispatches, batch occupancy — plus a per-stream admit/serve
footer; docs/serving-plane.md).

``--requests`` switches to the per-request LLM serving view (one row
per request of a continuous batcher: state, KV blocks held, queue/
TTFT/TPOT latencies, deadline headroom — docs/llm-serving.md).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.request
from typing import Dict, Optional

_COLUMNS = (
    ("ELEMENT", 22), ("FPS", 8), ("FRAMES", 9), ("P50ms", 8),
    ("P99ms", 8), ("WAITms", 8), ("Q", 5), ("BATCH", 7), ("PAD%", 6),
    ("ERR", 5), ("NOTES", 0),
)


def _num(row: dict, key: str, nd: int = 1) -> str:
    v = row.get(key)
    if v is None:
        return "-"
    return f"{v:.{nd}f}" if isinstance(v, float) else str(v)


def _notes(row: dict) -> str:
    """Compressed per-row flags: retry/circuit-breaker state from
    FaultStats/cb_* counters, admission/shedding counters, sanitizer
    findings, serving counters."""
    notes = []
    if row.get("error_retries"):
        notes.append(f"retry={row['error_retries']}")
    if row.get("error_routed"):
        notes.append(f"routed={row['error_routed']}")
    if row.get("adm_rejected"):
        notes.append(f"rej={row['adm_rejected']}")
    if row.get("adm_inflight"):
        notes.append(f"infl={row['adm_inflight']}")
    if row.get("deadline_shed"):
        notes.append(f"shed={row['deadline_shed']}")
    if row.get("cb_opens"):
        state = "OPEN" if row.get("cb_open") else "closed"
        notes.append(f"cb={state}({row['cb_opens']})")
    if row.get("fused_postproc"):
        # pre/post-processing ops fused into this device segment
        # (docs/on-device-ops.md)
        notes.append("fused-post")
    if row.get("chain_segments"):
        # whole-chain resident program: segments collapsed into one
        # node, one launch per unrolled window; `!` marks a chain
        # serving from the per-node parity path after a fallback latch
        # (docs/chain-analysis.md "Compiled chains")
        mark = "!" if row.get("chain_fallback_windows") else ""
        notes.append(
            f"chain={row['chain_segments']}x{row.get('chain_unroll', 1)}"
            f"{mark}"
        )
    san = {k: v for k, v in row.items() if k.startswith("san_") and v}
    for k, v in sorted(san.items()):
        notes.append(f"{k}={v}")
    serving = {
        k: v for k, v in row.items() if k.startswith("serving_") and v
    }
    if serving:
        notes.append("serving")
    return " ".join(notes)


def render(
    snap: dict,
    prev: Optional[dict] = None,
    interval_s: Optional[float] = None,
) -> str:
    """One table frame from a ``/metrics.json``-shaped snapshot.
    ``prev`` + ``interval_s`` turn cumulative frame counts into live
    rates; without them the cumulative ``fps`` field is shown."""
    nodes: Dict[str, dict] = snap.get("nodes", {})
    prev_nodes = (prev or {}).get("nodes", {})
    lines = []
    head = "".join(
        name.ljust(w) if w else name for name, w in _COLUMNS
    )
    lines.append(head)
    lines.append("-" * max(len(head), 72))
    for name, row in nodes.items():
        if name.startswith("_"):
            continue  # the __pipeline__ totals row is footer material
        fps = row.get("fps")
        if interval_s and name in prev_nodes:
            df = row.get("frames", 0) - prev_nodes[name].get("frames", 0)
            fps = df / interval_s if interval_s > 0 else fps
        depth = row.get("queue_depth")
        cells = [
            name[:21],
            f"{fps:.1f}" if isinstance(fps, (int, float)) else "-",
            str(row.get("frames", "-")),
            _num(row, "latency_p50_ms", 2),
            _num(row, "latency_p99_ms", 2),
            _num(row, "queue_wait_p50_ms", 2),
            str(sum(depth)) if depth else "-",
            _num(row, "avg_batch_size"),
            _num(row, "pad_waste_pct"),
            str(row.get("errors", 0) or "-"),
            _notes(row),
        ]
        lines.append("".join(
            c.ljust(w) if w else c for c, (_, w) in zip(cells, _COLUMNS)
        ))
    totals = snap.get("totals") or {}
    if totals:
        lines.append("")
        lines.append(
            f"produced={totals.get('produced')} "
            f"rendered={totals.get('rendered')} "
            f"dropped={sum((totals.get('dropped') or {}).values())} "
            f"balance={totals.get('balance')}"
        )
    proc = snap.get("process")
    if proc:
        lines.append(f"[{proc}]")
    return "\n".join(lines)


_CLIENT_COLUMNS = (
    ("SERVER", 22), ("CLIENT", 14), ("QUEUED", 8), ("INFLIGHT", 10),
    ("ADMITTED", 10), ("REJECTED", 0),
)


def render_clients(snap: dict) -> str:
    """The ``--clients`` view: one row per (query server, client) from
    the admission controller's per-client counters (docs/
    edge-serving.md), plus a per-server footer with the reject reasons.
    Empty when no node in the snapshot serves an admission-controlled
    fleet."""
    nodes: Dict[str, dict] = snap.get("nodes", {})
    lines = []
    head = "".join(
        name.ljust(w) if w else name for name, w in _CLIENT_COLUMNS
    )
    for name, row in nodes.items():
        clients = row.get("adm_clients")
        if not isinstance(clients, dict):
            continue
        if not lines:
            lines.append(head)
            lines.append("-" * max(len(head), 64))
        for cid, c in sorted(clients.items()):
            cells = [
                name[:21], str(cid)[:13], str(c.get("queued", 0)),
                str(c.get("inflight", 0)), str(c.get("admitted", 0)),
                str(c.get("rejected", 0)),
            ]
            lines.append("".join(
                v.ljust(w) if w else v
                for v, (_, w) in zip(cells, _CLIENT_COLUMNS)
            ))
        footer = []
        reasons = row.get("adm_rejected_by_reason") or {}
        for reason, count in sorted(reasons.items()):
            footer.append(f"{reason}={count}")
        if row.get("adm_rejected_conns"):
            footer.append(f"conn-rejects={row['adm_rejected_conns']}")
        if footer:
            lines.append(f"  {name}: " + " ".join(footer))
    if not lines:
        return "(no admission-controlled query server in this snapshot)"
    return "\n".join(lines)


_FLEET_COLUMNS = (
    ("CLIENT", 20), ("ENDPOINT", 22), ("STATE", 10), ("SCORE", 7),
    ("INFL", 6), ("SERVED", 8), ("FAILS", 7), ("FAILOVER", 0),
)


def render_fleet(snap: dict) -> str:
    """The ``--fleet`` view: one row per (fleet client, endpoint) from
    the client's health scorer (``fleet_endpoints`` in its stats row —
    docs/edge-serving.md "Running a fleet"), plus a per-client footer
    with the failover/hedge/duplicate totals (plus prefix-route hit/
    index counts when the client routes by prompt prefix) — and a row
    per query SERVER advertising its drain readiness flag or its
    disaggregated-serving role with handoff-outcome counts. Empty when
    nothing in the snapshot serves a fleet."""
    nodes: Dict[str, dict] = snap.get("nodes", {})
    lines = []
    head = "".join(
        name.ljust(w) if w else name for name, w in _FLEET_COLUMNS
    )
    for name, row in nodes.items():
        eps = row.get("fleet_endpoints")
        if not isinstance(eps, dict):
            continue
        if not lines:
            lines.append(head)
            lines.append("-" * max(len(head), 72))
        for addr, e in sorted(eps.items()):
            cells = [
                name[:19], str(addr)[:21],
                str(e.get("state", "-"))[:9],
                _num(e, "score", 2),
                str(e.get("inflight", 0)),
                str(e.get("served", 0)),
                str(e.get("fails", 0)),
                str(e.get("failovers", 0))
                + (" unresolvable" if e.get("unresolvable") else ""),
            ]
            lines.append("".join(
                c.ljust(w) if w else c
                for c, (_, w) in zip(cells, _FLEET_COLUMNS)
            ))
        footer = [
            f"healthy={row.get('fleet_healthy', '-')}",
            f"failovers={row.get('fleet_failovers', 0)}",
            f"hedges={row.get('fleet_hedges', 0)}",
            f"dup-replies={row.get('fleet_duplicate_replies', 0)}",
        ]
        if row.get("fleet_stale_replies"):
            footer.append(f"stale={row['fleet_stale_replies']}")
        if row.get("fleet_prefix_hits") is not None:
            # prefix-route=true clients: cache-affinity routing wins
            # and how many prompt prefixes the router currently maps
            footer.append(f"prefix-hits={row['fleet_prefix_hits']}")
            footer.append(f"prefix-index={row.get('fleet_prefix_index', 0)}")
        lines.append(f"  {name}: " + " ".join(footer))
    # server half: the drain/rolling-restart readiness flags
    for name, row in nodes.items():
        readiness = row.get("adm_readiness")
        if readiness is None:
            continue
        extra = (
            f" drain-nacked={row['adm_drain_nacked']}"
            if row.get("adm_drain_nacked") else ""
        )
        lines.append(f"  server {name}: {readiness}{extra}")
    # disaggregated-serving roles (docs/llm-serving.md "Disaggregated
    # serving"): a prefill server's handoff outcomes / a decode
    # server's parked finished handoffs
    for name, row in nodes.items():
        role = row.get("serving_disagg_role")
        if not role:
            continue
        parts = [f"role={role}"]
        counts = (row.get("serving_disagg") or {}).get("counts") or {}
        parts.extend(f"{k}={v}" for k, v in sorted(counts.items()))
        if (row.get("serving_disagg") or {}).get("outstanding"):
            parts.append(
                f"outstanding={row['serving_disagg']['outstanding']}"
            )
        if row.get("serving_disagg_done_waiting"):
            parts.append(
                f"done-waiting={row['serving_disagg_done_waiting']}"
            )
        lines.append(f"  server {name}: " + " ".join(parts))
    if not lines:
        return "(no fleet client in this snapshot)"
    return "\n".join(lines)


_MODEL_COLUMNS = (
    ("PLANE", 16), ("MODE", 10), ("DEV", 5), ("STREAMS", 9),
    ("Q", 5), ("INFL", 6), ("DISP", 8), ("BATCH", 7), ("OCC%", 7),
    ("FRAMES", 0),
)


def render_models(snap: dict) -> str:
    """The ``--models`` view: one row per serving plane from the
    ``plane_*`` stats the attached filters surface (multiple sharers
    report the same plane — deduped by name), plus a per-stream
    admit/serve footer. Empty when nothing in the snapshot serves
    through a plane."""
    nodes: Dict[str, dict] = snap.get("nodes", {})
    lines = []
    head = "".join(
        name.ljust(w) if w else name for name, w in _MODEL_COLUMNS
    )
    seen = set()
    for _name, row in nodes.items():
        pname = row.get("plane_name")
        if not pname or pname in seen:
            continue
        seen.add(pname)
        if not lines:
            lines.append(head)
            lines.append("-" * max(len(head), 64))
        cells = [
            str(pname)[:15],
            str(row.get("plane_mode", "-")),
            str(row.get("plane_devices", "-")),
            str(row.get("plane_streams", "-")),
            str(row.get("plane_queue_depth", "-")),
            # async in-flight windows parked across the plane's stream
            # rings (docs/serving-plane.md); 0/- under blocking submits
            str(row.get("plane_inflight", "-")),
            str(row.get("plane_dispatches", "-")),
            _num(row, "plane_avg_batch"),
            _num(row, "plane_occupancy_pct"),
            str(row.get("plane_frames", "-")),
        ]
        lines.append("".join(
            c.ljust(w) if w else c
            for c, (_, w) in zip(cells, _MODEL_COLUMNS)
        ))
        per_stream = row.get("plane_per_stream")
        if isinstance(per_stream, dict):
            for sid, s in sorted(per_stream.items()):
                lines.append(
                    f"  {str(sid)[:20]}: admitted={s.get('admitted', 0)} "
                    f"served={s.get('served', 0)} "
                    f"queued={s.get('queued', 0)} "
                    f"inflight={s.get('inflight', 0)} "
                    f"errors={s.get('errors', 0)} "
                    f"weight={s.get('weight', 1.0)}"
                )
        reps = row.get("plane_replicas")
        if isinstance(reps, dict):
            lines.append(
                f"  replicas: healthy={reps.get('healthy')}/"
                f"{reps.get('replicas')} "
                f"failovers={reps.get('failovers', 0)} "
                f"exhaustions={reps.get('exhaustions', 0)}"
            )
    if not lines:
        return "(no serving plane in this snapshot)"
    return "\n".join(lines)


_REQUEST_COLUMNS = (
    ("ELEMENT", 20), ("RID", 6), ("STATE", 12), ("BLOCKS", 8),
    ("QUEUEms", 9), ("TTFTms", 9), ("TPOTms", 9), ("TOKENS", 8),
    ("DEADLINE", 0),
)


def render_requests(snap: dict) -> str:
    """The ``--requests`` view: one row per live/recent request of an
    LLM serving element, from the batcher's SLO ledger
    (``serving_requests`` in the element's stats row —
    docs/llm-serving.md). Empty when nothing in the snapshot serves an
    LLM batch."""
    nodes: Dict[str, dict] = snap.get("nodes", {})
    lines = []
    head = "".join(
        name.ljust(w) if w else name for name, w in _REQUEST_COLUMNS
    )

    def _ms(row, key):
        v = row.get(key)
        return f"{v:.1f}" if isinstance(v, (int, float)) else "-"

    for name, row in nodes.items():
        reqs = row.get("serving_requests")
        if not isinstance(reqs, dict) or not reqs:
            continue
        if not lines:
            lines.append(head)
            lines.append("-" * max(len(head), 72))
        for rid in sorted(reqs, key=int):
            r = reqs[rid]
            dl = r.get("deadline_s")
            cells = [
                name[:19], str(rid), str(r.get("state", "-"))[:11],
                str(r.get("blocks", "-")),
                _ms(r, "queue_ms"), _ms(r, "ttft_ms"), _ms(r, "tpot_ms"),
                str(r.get("tokens", "-")),
                (f"{dl:+.1f}s" if isinstance(dl, (int, float)) else "-"),
            ]
            lines.append("".join(
                c.ljust(w) if w else c
                for c, (_, w) in zip(cells, _REQUEST_COLUMNS)
            ))
        pre = row.get("serving_kv_preemptions")
        blocks = row.get("serving_kv_blocks_in_use")
        footer = []
        if blocks is not None:
            footer.append(
                f"blocks={blocks}/{row.get('serving_kv_blocks', '?')}"
            )
        if row.get("serving_kv_attn"):
            # which paged decode path is live: block (arena attended
            # through the tables) or gather (the materialized-view
            # oracle — the dispatch count shows what it is costing)
            footer.append(f"kv-attn={row['serving_kv_attn']}")
            if row.get("serving_kv_gather_dispatches"):
                footer.append(
                    "gather-dispatches="
                    f"{row['serving_kv_gather_dispatches']}"
                )
        if row.get("serving_kv_prefix_hits"):
            footer.append(f"prefix-hits={row['serving_kv_prefix_hits']}")
        if pre:
            footer.append(f"preemptions={pre}")
        # live migration + crash recovery (docs/llm-serving.md
        # "Migration & recovery"): spans shipped out / adopted in, and
        # requests resumed (re-prefill fallback or checkpoint restart);
        # migrated requests also show as state=migrated in the rows
        if row.get("serving_kv_migrations_out") or row.get(
            "serving_kv_migrations_in"
        ):
            footer.append(
                "migrations="
                f"{row.get('serving_kv_migrations_out', 0)}out/"
                f"{row.get('serving_kv_migrations_in', 0)}in"
            )
        if row.get("serving_request_resumes"):
            footer.append(f"resumes={row['serving_request_resumes']}")
        if footer:
            lines.append(f"  {name}: " + " ".join(footer))
    if not lines:
        return "(no LLM serving element in this snapshot)"
    return "\n".join(lines)


def _fetch(source: str) -> dict:
    if source.startswith(("http://", "https://")):
        url = source.rstrip("/")
        if not url.endswith(".json"):
            if url.endswith("/metrics"):
                # the executor logs the /metrics (Prometheus) URL;
                # pasting it here must land on the JSON sibling
                url = url[: -len("/metrics")]
            url += "/metrics.json"
        with urllib.request.urlopen(url, timeout=5) as resp:
            return json.loads(resp.read())
    with open(source) as f:
        return json.load(f)


def snapshot_executor(ex) -> dict:
    """In-process snapshot from a live Executor (no HTTP hop)."""
    from nnstreamer_tpu_torch.obs import expo, metrics

    return expo.snapshot(metrics.get(), ex.stats(), ex.totals())


def watch(ex, interval_s: float = 1.0, iterations: Optional[int] = None,
          out=None) -> None:
    """Render an in-process executor's table every ``interval_s`` until
    the pipeline finishes (or ``iterations`` frames of output)."""
    out = out or sys.stdout
    prev = None
    n = 0
    while iterations is None or n < iterations:
        snap = snapshot_executor(ex)
        out.write("\x1b[2J\x1b[H" if out.isatty() else "")
        out.write(render(snap, prev, interval_s if prev else None) + "\n")
        out.flush()
        if ex.finished or (ex.stop_event.is_set() and ex.errors):
            break
        prev = snap
        n += 1
        time.sleep(interval_s)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nns-top", description=__doc__)
    ap.add_argument(
        "source",
        help="metrics endpoint URL (http://host:port) or snapshot file",
    )
    ap.add_argument("--interval", "-n", type=float, default=1.0,
                    help="refresh period, seconds (default 1)")
    ap.add_argument("--once", action="store_true",
                    help="render one frame and exit (scripting)")
    ap.add_argument("--clients", action="store_true",
                    help="per-client admission view (query servers)")
    ap.add_argument("--fleet", action="store_true",
                    help="per-endpoint fleet view (query clients + "
                    "server readiness)")
    ap.add_argument("--models", action="store_true",
                    help="per-plane serving view (shared model planes)")
    ap.add_argument("--requests", action="store_true",
                    help="per-request LLM serving view (SLO ledger)")
    args = ap.parse_args(argv)

    prev = None
    prev_t = None
    while True:
        try:
            snap = _fetch(args.source)
        except (OSError, ValueError) as exc:
            print(f"nns-top: {args.source}: {exc}", file=sys.stderr)
            return 1
        now = time.monotonic()
        dt = (now - prev_t) if prev_t is not None else None
        if not args.once and sys.stdout.isatty():
            sys.stdout.write("\x1b[2J\x1b[H")
        if args.clients:
            print(render_clients(snap))
        elif args.fleet:
            print(render_fleet(snap))
        elif args.models:
            print(render_models(snap))
        elif args.requests:
            print(render_requests(snap))
        else:
            print(render(snap, prev, dt))
        if args.once:
            return 0
        prev, prev_t = snap, now
        try:
            time.sleep(max(0.1, args.interval))
        except KeyboardInterrupt:
            return 0


if __name__ == "__main__":
    sys.exit(main())
