"""Query elements: request/response pipeline offload across hosts.

The counterpart of ``nnstreamer_tpu/edge/query.py``: the same wire, the
same props, the same admission and fleet decisions. Frames cross the
card once each way: the client declares ``WANTS_HOST`` (its producer
hands it one coalesced host copy), the serversrc emits host arrays that
the first segment stages, and the serversink, a sink, gets its frame
fetched in one copy.

Reference: gst/nnstreamer/tensor_query/ —
- ``tensor_query_client`` (tensor_query_client.c:663-735): sink chain
  serializes the frame, sends to the server, blocks for the reply, pushes
  the reply downstream.
- ``tensor_query_serversrc`` (tensor_query_serversrc.c:299-427): push
  source emitting incoming requests tagged with their ``client_id`` meta
  (the GstMetaQuery analogue, tensor_meta.h:26-31).
- ``tensor_query_serversink`` (tensor_query_serversink.c:241-278): reads
  the ``client_id`` meta and sends the result back to that client.
- serversrc/sink pair through a global id table
  (tensor_query_server.c, hdr :25-73) — here :data:`_server_table`.

Transports (``connect-type``, reference tensor_query_common.c:35-42):
``TCP`` (in-tree native C++ edge library, python fallback), ``MQTT``
(request/reply topics over the broker), ``HYBRID`` (MQTT whois discovery
+ raw TCP bulk) — see query_transports.py. AITT stays vendor-gated like
its meson option.
"""

from __future__ import annotations

import itertools
import os
import random
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from nnstreamer_tpu_torch import registry, trace
from nnstreamer_tpu_torch.obs import metrics as obs_metrics
from nnstreamer_tpu_torch.edge.admission import (
    REASON_DEADLINE,
    REASON_DRAINING,
    REASON_FAILED,
    REASON_MALFORMED,
    REASON_MAX_CLIENTS,
    AdmissionConfig,
    AdmissionController,
)
from nnstreamer_tpu_torch.edge.fleet import (
    FleetEndpoints,
    HedgeTimer,
    PrefixRouter,
    ReplyDeduper,
    RttWindow,
    parse_hosts,
    prefix_route_keys,
)
from nnstreamer_tpu_torch.edge.serialize import (
    ROUTE_META_KEY,
    Ctrl,
    Nack,
    decode_message,
    encode_ctrl,
    encode_message,
    encode_nack,
)
from nnstreamer_tpu_torch.edge.transport import (
    ChaosCounter,
    ChaosTransport,
    TransportError,
    UnresolvableError,
    make_transport,
    resolve_target,
    transport_kind,
)
from nnstreamer_tpu_torch.elements.base import (
    ElementError,
    HostElement,
    NegotiationError,
    PropSpec,
    Sink,
    Source,
    Spec,
)
from nnstreamer_tpu_torch.tensors.frame import EOS, EOS_FRAME, Frame
from nnstreamer_tpu_torch.tensors.spec import TensorFormat, TensorsSpec

# reference QUERY_DEFAULT_TIMEOUT_SEC (tensor_query_common.h:28) is 10 s
DEFAULT_TIMEOUT = 10.0

# serversrc readiness flags (docs/edge-serving.md "Running a fleet"):
# ready → serving; draining → graceful drain in progress (new submits
# NACK `draining`); dead → stopped/not started
SRV_READY = "ready"
SRV_DRAINING = "draining"
SRV_DEAD = "dead"

# serversrc/serversink pairing: id → shared server transport (+ the
# admission controller when one is configured, keyed separately so the
# transport-only consumers stay untouched; + the readiness flag so the
# fault-disposal paths can pick drain-aware NACK reasons)
_server_table: Dict[str, object] = {}
_controller_table: Dict[str, AdmissionController] = {}
_state_table: Dict[str, str] = {}
_server_lock = threading.Lock()


def _register_server(srv_id: str, transport, controller=None) -> None:
    with _server_lock:
        _server_table[srv_id] = transport
        _state_table[srv_id] = SRV_READY
        if controller is not None:
            _controller_table[srv_id] = controller
        else:
            _controller_table.pop(srv_id, None)


def _get_server(srv_id: str):
    with _server_lock:
        return _server_table.get(srv_id)


def _get_controller(srv_id: str) -> Optional[AdmissionController]:
    with _server_lock:
        return _controller_table.get(srv_id)


def server_state(srv_id: str) -> str:
    """The serversrc's readiness flag (ready / draining / dead)."""
    with _server_lock:
        return _state_table.get(srv_id, SRV_DEAD)


def _set_server_state(srv_id: str, state: str) -> None:
    with _server_lock:
        if srv_id in _state_table:
            _state_table[srv_id] = state


def _unregister_server(srv_id: str, transport=None) -> None:
    """Remove the pairing entry — but only if it still belongs to the
    caller (a restarted serversrc may have re-registered the id)."""
    with _server_lock:
        if transport is None or _server_table.get(srv_id) is transport:
            _server_table.pop(srv_id, None)
            _controller_table.pop(srv_id, None)
            _state_table.pop(srv_id, None)


def nack_for_shed(srv_id: str, cid, frame_id=None) -> None:
    """Deadline shed notification (pipeline/faults.py notify_shed): the
    executor dropped an admitted request before it consumed device time;
    tell the client so the request still has a terminal outcome, and
    return the admission budget. Best-effort — a vanished client must
    not poison the shedding node."""
    transport = _get_server(srv_id)
    if transport is not None and cid is not None:
        try:
            transport.send(
                cid, encode_nack(REASON_DEADLINE, 0.0, frame_id=frame_id)
            )
        except (TransportError, OSError):
            pass
    ctrl = _get_controller(srv_id)
    if ctrl is not None and cid is not None:
        ctrl.release(cid)


def discard_admitted(srv_id: str, cid, action: str, frame_id=None,
                     draining: bool = False) -> None:
    """A fault policy disposed of an admitted request (pipeline/faults.py
    notify_discard): return its admission budget — the in-flight slot
    must not stay pinned forever — and, unless the frame was delivered
    to a dead-letter consumer (``action == "route"``), NACK the client
    so the request does not end as a silent client-side timeout. The
    reason is ``failed`` (terminal) normally, but ``draining`` while
    the server is in a graceful drain — the disposal is then a
    restart artifact, not a verdict on the request, and a fleet client
    re-routes it to another endpoint instead of giving up.
    ``draining=True`` forces that reading when the DOWNSTREAM consumer
    is the one draining (an LLM serversink mid-drain behind a
    still-ready serversrc — docs/llm-serving.md)."""
    ctrl = _get_controller(srv_id)
    if ctrl is not None and cid is not None:
        ctrl.release(cid)
    if action == "route":
        return  # the dead-letter consumer owns the request's fate now
    transport = _get_server(srv_id)
    if transport is not None and cid is not None:
        if draining or server_state(srv_id) == SRV_DRAINING:
            reason, hint = REASON_DRAINING, (
                ctrl.cfg.retry_after_ms if ctrl is not None else 50.0
            )
        else:
            reason, hint = REASON_FAILED, 0.0
        try:
            transport.send(
                cid, encode_nack(reason, hint, frame_id=frame_id)
            )
        except (TransportError, OSError):
            pass


def drain_flushed(srv_id: str, cid, frame_id=None) -> None:
    """A draining server flushed a queued admitted request before it
    consumed device time (pipeline/faults.py notify_drain_flush): NACK
    the client ``draining`` — a fleet client re-routes the request to
    another endpoint, so a rolling restart loses nothing — and return
    the admission budget (the usual release path)."""
    ctrl = _get_controller(srv_id)
    transport = _get_server(srv_id)
    if transport is not None and cid is not None:
        hint = ctrl.cfg.retry_after_ms if ctrl is not None else 50.0
        try:
            transport.send(
                cid, encode_nack(REASON_DRAINING, hint, frame_id=frame_id)
            )
        except (TransportError, OSError):
            pass
    if ctrl is not None and cid is not None:
        ctrl.release(cid)


def request_drain(host: str, port: int, connect_type: str = "TCP",
                  topic: str = "nns-query", attempts: int = 3) -> None:
    """Operator helper: ask the query server at ``host:port`` to drain
    gracefully (the ``drain`` control message — rolling restarts without
    dropping admitted work). Fire-and-forget once delivered: the server
    NACKs new submits ``draining`` from the moment the message lands.
    A couple of connect retries absorb transient accept races on a busy
    server; a server that stays unreachable raises."""
    last: Optional[Exception] = None
    for attempt in range(max(1, int(attempts))):
        if attempt:
            time.sleep(0.05 * attempt)
        t = _make_client_transport(str(connect_type).upper(), topic)
        try:
            t.connect(host, port)
            t.send(0, encode_ctrl("drain"))
            return
        except (TransportError, OSError) as exc:
            last = exc
        finally:
            t.close()
    raise TransportError(
        f"cannot deliver drain to {host}:{port}: {last}"
    )


# -- live KV-span migration handshake (docs/llm-serving.md) ----------------
# A draining LLM server re-hosts in-flight generations by asking a peer
# serversrc: ``migrate_probe`` (how many leading tokens does your prefix
# index cover? → strip those payloads) then ``migrate_span`` (the
# kv/migrate.py span bytes riding the CTRL payload). The serversrc
# routes both to the LLM server registered for the requested ``llm_id``
# — the pairing is process-local, like the serversrc/serversink tables.

_migration_table: Dict[int, object] = {}
_migration_lock = threading.Lock()


class MigrationRefused(RuntimeError):
    """The peer answered the migration handshake with ``migrate_nack``:
    the span was NOT adopted (no handler, draining, capacity, corrupt
    span...). The source keeps the request — fall back to local
    re-prefill resume. Capacity refusals carry the peer's
    ``retry_after_ms`` hint (the PoolCapacityError taxonomy on
    the wire) so a disaggregated prefill server can back off instead
    of hammering a full decode pool."""

    def __init__(self, reason: str, retry_after_ms: float = 0.0) -> None:
        super().__init__(reason)
        self.reason = reason
        self.retry_after_ms = float(retry_after_ms)


def register_migration_handler(llm_id: int, handler) -> None:
    """Make an LLM server adoptable-at over this process's serversrcs.
    ``handler`` implements ``migration_probe(tokens) -> int`` and
    ``migration_adopt(span_bytes) -> new_rid`` (raising a
    ``kv.migrate.SpanError`` subclass to refuse)."""
    with _migration_lock:
        _migration_table[int(llm_id)] = handler


def unregister_migration_handler(llm_id: int, handler=None) -> None:
    with _migration_lock:
        if handler is None or _migration_table.get(int(llm_id)) is handler:
            _migration_table.pop(int(llm_id), None)


def _get_migration_handler(llm_id: int):
    with _migration_lock:
        h = _migration_table.get(int(llm_id))
        if h is None and len(_migration_table) == 1:
            # exactly one LLM server in this process — the common fleet
            # layout — so migrate-to=host:port works without the sender
            # guessing the peer's serversink id
            h = next(iter(_migration_table.values()))
        return h


def _ctrl_roundtrip(host: str, port: int, msg: bytes, connect_type: str,
                    topic: str, timeout: float):
    """Send one CTRL message and wait for the CTRL reply (the data
    protocol is fire-and-forget for CTRL; migration needs an answer)."""
    t = _make_client_transport(str(connect_type).upper(), topic)
    try:
        t.connect(host, port)
        t.send(0, msg)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            got = t.recv(timeout=0.1)
            if got is None:
                continue
            _cid, payload = got
            if not payload:
                raise TransportError(
                    "peer closed during migration handshake"
                )
            try:
                reply = decode_message(payload)
            except ValueError:
                continue  # garbage on the reply path: keep waiting
            if isinstance(reply, Ctrl):
                return reply
        raise TransportError(
            f"migration handshake with {host}:{port} timed out"
        )
    finally:
        t.close()


def probe_migration(host: str, port: int, tokens, llm_id: int = 0,
                    connect_type: str = "TCP", topic: str = "nns-query",
                    timeout: float = 5.0) -> int:
    """Ask the peer how many leading ``tokens`` its LLM server's prefix
    index already covers (full blocks only) — the warm-migration diet.
    Raises :class:`MigrationRefused` if the peer cannot host spans."""
    return probe_migration_full(
        host, port, tokens, llm_id=llm_id, connect_type=connect_type,
        topic=topic, timeout=timeout,
    )[0]


def probe_migration_full(host: str, port: int, tokens, llm_id: int = 0,
                         connect_type: str = "TCP",
                         topic: str = "nns-query",
                         timeout: float = 5.0):
    """:func:`probe_migration` plus the peer's full probe-ack meta as a
    dict — ``(shared_tokens, advert)``. Decode-role servers advertise
    ``role`` / ``free_slots`` / ``free_blocks`` there (pool headroom +
    prefix depth in one roundtrip), which the disaggregated prefill
    side uses to pick the handoff target."""
    reply = _ctrl_roundtrip(
        host, port,
        encode_ctrl("migrate_probe", llm_id=int(llm_id),
                    tokens=[int(x) for x in tokens]),
        connect_type, topic, timeout,
    )
    if reply.op != "migrate_probe_ack":
        raise MigrationRefused(
            str(reply.meta.get("reason", reply.op)),
            retry_after_ms=float(reply.meta.get("retry_after_ms", 0) or 0),
        )
    return int(reply.meta.get("shared_tokens", 0)), dict(reply.meta)


def send_migration(host: str, port: int, span_bytes: bytes,
                   llm_id: int = 0, connect_type: str = "TCP",
                   topic: str = "nns-query", timeout: float = 10.0) -> int:
    """Ship an encoded KV span to the peer; returns the rid the
    adopting server continues the generation under. Raises
    :class:`MigrationRefused` when the peer declines (the request is
    still whole on the caller's side — resume it locally)."""
    reply = _ctrl_roundtrip(
        host, port,
        encode_ctrl("migrate_span", payload=span_bytes,
                    llm_id=int(llm_id)),
        connect_type, topic, timeout,
    )
    if reply.op != "migrate_span_ack":
        raise MigrationRefused(
            str(reply.meta.get("reason", reply.op)),
            retry_after_ms=float(reply.meta.get("retry_after_ms", 0) or 0),
        )
    return int(reply.meta.get("rid", -1))


def fetch_handoff(host: str, port: int, rid: int, llm_id: int = 0,
                  connect_type: str = "TCP", topic: str = "nns-query",
                  timeout: float = 5.0):
    """Poll a decode peer for the outcome of a handed-off generation:
    ``None`` while rid is still decoding, else the full token list
    exactly once (the peer forgets the rid on fetch, so the prefill
    side — the only DELIVER path the client knows — cannot
    double-emit). Raises :class:`MigrationRefused` on a nack (rid
    unknown / peer draining): the caller's fallback ladder decides."""
    reply = _ctrl_roundtrip(
        host, port,
        encode_ctrl("disagg_fetch", llm_id=int(llm_id), rid=int(rid)),
        connect_type, topic, timeout,
    )
    if reply.op != "disagg_fetch_ack":
        raise MigrationRefused(
            str(reply.meta.get("reason", reply.op)),
            retry_after_ms=float(reply.meta.get("retry_after_ms", 0) or 0),
        )
    if not int(reply.meta.get("done", 0)):
        return None
    return [int(t) for t in reply.meta.get("tokens", [])]


CONNECT_TYPES = ("TCP", "MQTT", "HYBRID", "SHM")


def _check_connect_type(elem) -> str:
    """Validate and return connect-type (reference
    tensor_query_common.c:35-42; AITT is vendor-gated like its meson
    option)."""
    ct = str(elem.get_property("connect-type", "TCP")).upper()
    if ct not in CONNECT_TYPES:
        raise NegotiationError(
            f"{elem.name}: connect-type={ct} not built in "
            f"(have {'/'.join(CONNECT_TYPES)}; AITT is vendor-gated)"
        )
    return ct


def _make_client_transport(ct: str, topic: str):
    if ct == "MQTT":
        from nnstreamer_tpu_torch.edge.query_transports import MqttQueryTransport

        return MqttQueryTransport(topic)
    if ct == "HYBRID":
        from nnstreamer_tpu_torch.edge.query_transports import HybridClientTransport

        return HybridClientTransport(topic)
    if ct == "SHM":
        from nnstreamer_tpu_torch.edge.query_transports import ShmClientTransport

        return ShmClientTransport()
    return make_transport()


def _make_server_transport(ct: str, topic: str, data_host: str,
                           data_port: int, max_conns: int = 0,
                           retry_after_ms: float = 50.0):
    if ct == "MQTT":
        from nnstreamer_tpu_torch.edge.query_transports import MqttQueryTransport

        return MqttQueryTransport(topic)
    if ct == "HYBRID":
        from nnstreamer_tpu_torch.edge.query_transports import HybridServerTransport

        t = HybridServerTransport(topic, data_host, data_port)
    elif ct == "SHM":
        from nnstreamer_tpu_torch.edge.query_transports import ShmServerTransport

        return ShmServerTransport()
    else:
        # connection caps need the python acceptor's reject path; the
        # native transport still gets request-level admission NACKs
        t = make_transport(prefer_native=not max_conns)
    if max_conns and hasattr(t, "max_conns"):
        t.max_conns = max_conns
        t.reject_payload = encode_nack(REASON_MAX_CLIENTS, retry_after_ms)
    return t


@registry.element("tensor_query_client")
class TensorQueryClient(HostElement):
    """Offload frames to a remote pipeline and emit the replies.

    Props: dest-host (default 127.0.0.1), dest-port, timeout (seconds),
    connect-type=TCP|MQTT|HYBRID (MQTT: dest addresses the broker,
    payloads ride <topic>/req|rep topics; HYBRID: MQTT whois discovery +
    raw TCP bulk — reference tensor_query_common.c:35-42), topic
    (default nns-query). Requests are strictly synchronous request/reply
    per frame (the reference's max-request pipelining knob does not
    apply).

    Reconnect-with-backoff (docs/fault-tolerance.md): ``retry-max`` > 0
    makes CONNECT/SEND failures (unreachable server at start, a dead
    connection discovered while sending) reconnect with the fault
    layer's jittered exponential backoff (``retry-backoff-ms`` base) and
    resend the frame, instead of failing fast. Once a request went out,
    failures keep failing fast — a timeout or a connection lost while
    awaiting the reply may mean the server already processed the
    request, and a resend could double-process it (the dropped
    connection still reconnects for the next frame).

    Overload cooperation (docs/edge-serving.md): ``deadline-ms`` stamps
    a per-request SLO into the wire meta (the server sheds frames that
    can no longer meet it, and NACKs back); ``priority`` picks the
    admission class (lower = more urgent). Admission NACKs (max-clients
    / overload / client-backpressure / rate / malformed) mean the server
    did NOT process the request — the client honors the NACK's
    retry-after hint on its existing ``retry-max`` budget. The
    ``chaos-*`` properties inject deterministic network faults
    (docs/fault-tolerance.md) for testing those paths.

    Fleet mode (docs/edge-serving.md "Running a fleet"): ``hosts=
    h1:p1,h2:p2,...`` replaces the single ``dest-host``/``dest-port``
    binding with a health-scored endpoint fleet (edge/fleet.py):
    consecutive-failure ejection with jittered-backoff re-probes, a
    ``draining`` NACK benches an endpoint for exactly its retry-after
    hint (rolling restarts), and an in-flight request whose endpoint
    dies FAILS OVER to the next healthy endpoint — delivery stays
    at-most-once because replies are deduped by ``frame_id`` (a late
    duplicate from the first server is dropped, never pushed
    downstream). ``hedge-after-ms`` > 0 arms hedged requests: a
    straggling request is re-sent to a second endpoint after the delay,
    first reply wins, the loser's reply is deduped (< 0 adapts the
    threshold to the observed reply p99). Note the failover/hedge
    semantics differ from the single-endpoint path on purpose: a
    re-send may double-*process* on two servers, but never
    double-*delivers* — opt in only when requests are idempotent or the
    duplicate compute is acceptable."""

    FACTORY_NAME = "tensor_query_client"

    # serialization reads the frame's bytes: take one coalesced host copy
    # from the producer instead of a copy per tensor here
    WANTS_HOST = True

    PROPERTIES = {
        "dest-host": PropSpec("str", "127.0.0.1"),
        "dest-port": PropSpec("int", 0, desc="required unless hosts= set"),
        "hosts": PropSpec(
            "str", None,
            desc="fleet endpoints h1:p1,h2:p2,... — overrides dest-host/"
            "dest-port and enables health-scored failover/hedging",
        ),
        "hedge-after-ms": PropSpec(
            "float", 0.0,
            desc="fleet hedging: re-send a straggling request to a "
            "second endpoint after this delay, first reply wins "
            "(0 = off, <0 = adaptive from the observed reply p99)",
        ),
        "prefix-route": PropSpec(
            "bool", False,
            desc="fleet mode: stamp rolling-CRC prompt-prefix keys into "
            "the request meta and prefer the endpoint that last served "
            "the longest matching prefix (cluster-wide KV prefix "
            "sharing; falls back to the least-loaded rotation)",
        ),
        "timeout": PropSpec("float", 10.0, desc="per-request (s)"),
        "connect-type": PropSpec("enum", "TCP", CONNECT_TYPES),
        "topic": PropSpec("str", "nns-query"),
        "retry-max": PropSpec(
            "int", 0, desc="reconnect attempts on transport failure"
        ),
        "retry-backoff-ms": PropSpec(
            "float", 50.0, desc="reconnect backoff base (jittered, doubling)"
        ),
        "deadline-ms": PropSpec(
            "float", 0.0,
            desc="per-request SLO stamped into the wire meta; the server "
            "sheds frames that can no longer meet it (0 = none)",
        ),
        "priority": PropSpec(
            "int", None,
            desc="admission priority class (lower = more urgent; "
            "default 1 server-side)",
        ),
        "chaos-drop-every-n": PropSpec(
            "int", 0,
            desc="chaos harness: sever the connection on every Nth send",
        ),
        "chaos-truncate-every-n": PropSpec(
            "int", 0,
            desc="chaos harness: send a truncated header every Nth send",
        ),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.host = str(self.get_property("dest-host", "127.0.0.1"))
        self.port = int(self.get_property("dest-port", 0))
        self.timeout = float(self.get_property("timeout", DEFAULT_TIMEOUT))
        self.connect_type = "TCP"
        self.topic = str(self.get_property("topic", "nns-query"))
        self.retry_max = max(0, int(self.get_property("retry-max", 0)))
        self.deadline_ms = float(self.get_property("deadline-ms", 0.0))
        raw_prio = self.get_property("priority")
        self.priority = None if raw_prio is None else int(raw_prio)
        self._chaos_drop_n = max(
            0, int(self.get_property("chaos-drop-every-n", 0))
        )
        self._chaos_trunc_n = max(
            0, int(self.get_property("chaos-truncate-every-n", 0))
        )
        self._chaos_counter = ChaosCounter()
        from nnstreamer_tpu_torch.pipeline.faults import FaultPolicy

        self._retry_policy = FaultPolicy(
            on_error="retry",
            retry_max=self.retry_max,
            backoff_ms=float(self.get_property("retry-backoff-ms", 50.0)),
        )
        self._rng = random.Random(0xED6E)  # deterministic jitter stream
        self._transport = None
        # the byte path the last connection took (transport_kind): the
        # python fallback is host transport and is reported, never hidden
        self.transport = "none"
        # fleet mode (docs/edge-serving.md "Running a fleet"): hosts=
        # binds a health-scored endpoint selector instead of one socket
        self.hedge_after_ms = float(self.get_property("hedge-after-ms", 0.0))
        hosts_raw = self.get_property("hosts")
        self._fleet: Optional[FleetEndpoints] = None
        self._ep_transports: Dict[object, object] = {}
        self._dedup: Optional[ReplyDeduper] = None
        self._rtts: Optional[RttWindow] = None
        self.fleet_failovers = 0   # requests re-sent off a failed endpoint
        self.fleet_hedges = 0      # hedge sends fired
        self.stale_replies = 0     # late replies to already-terminal requests
        self._failover_ctr = None
        self._hedge_ctr = None
        self.prefix_route = bool(self.get_property("prefix-route", False))
        self._router: Optional[PrefixRouter] = None
        self._pfx_hit_ctr = None
        if hosts_raw:
            try:
                targets = parse_hosts(hosts_raw)
            except ValueError as exc:
                raise ElementError(f"{self.name}: {exc}") from exc
            self._fleet = FleetEndpoints(
                targets,
                probe_backoff_ms=max(
                    1.0, float(self.get_property("retry-backoff-ms", 50.0))
                ),
                rng=random.Random(0xF1EE7),
                name=self.name,
            )
            self._dedup = ReplyDeduper()
            self._rtts = RttWindow()
            if self.prefix_route:
                self._router = PrefixRouter()
        # distributed correlation (docs/observability.md): every request
        # carries a frame_id that survives the hop via the wire meta
        # blob, so client and server traces merge into one timeline
        self._fid_seq = itertools.count()
        self._fid_prefix = f"{os.getpid():x}.{self.name}"
        # registry resolved ONCE at start() (the executor discipline):
        # obs_metrics.get() probes env+config on the None path, which
        # must stay off the per-frame edge hot path. Standalone callers
        # that skip start() simply record no metrics.
        self._obs_reg = None
        self._rtt_hist = None  # nns_edge_rtt_us histogram handle
        self._nack_ctrs: Dict[str, object] = {}  # reason → counter

    def negotiate(self, in_specs: List[Spec]) -> List[Spec]:
        self.connect_type = _check_connect_type(self)
        if self.port <= 0 and self._fleet is None:
            raise NegotiationError(
                f"{self.name}: dest-port (or hosts=) required"
            )
        # the reply's spec is the remote pipeline's business — flexible
        # (caps compatibility is the user's responsibility, reference
        # tensor_query/README.md)
        return [TensorsSpec(format=TensorFormat.FLEXIBLE)]

    def _build_transport(self, connect_timeout: Optional[float] = None):
        t = _make_client_transport(self.connect_type, self.topic)
        if connect_timeout is not None:
            if not hasattr(t, "connect_timeout") \
                    and self.connect_type == "TCP":
                # the native transport has no bounded connect(): a
                # SYN-blackholed fleet endpoint would stall the request
                # for the OS default (~minutes) and block failover, so
                # fleet connections ride the python transport (same
                # framing, cross-checked in tests) where the clamp works
                t.close()
                t = make_transport(prefer_native=False)
            if hasattr(t, "connect_timeout"):
                t.connect_timeout = connect_timeout
        if self._chaos_drop_n or self._chaos_trunc_n:
            # the counter survives reconnects so the injection schedule
            # stays deterministic across the faults it causes (and, in
            # fleet mode, across endpoints)
            t = ChaosTransport(
                t, self._chaos_counter,
                drop_every_n=self._chaos_drop_n,
                truncate_every_n=self._chaos_trunc_n,
            )
        return t

    def _connect_once(self) -> None:
        # resolve (and validate) connect-type here, not only in start():
        # standalone callers may hit process() without start(), and the
        # property must be honored on that path too
        self.connect_type = _check_connect_type(self)
        if self.connect_type == "TCP":
            # re-resolve on EVERY reconnect attempt: a failed-over DNS
            # record points somewhere new, and an unresolvable name is a
            # DISTINCT terminal failure (UnresolvableError) instead of a
            # retry-max budget burned on a gone host
            resolve_target(self.host, self.port)
        self._transport = self._build_transport()
        try:
            self._transport.connect(self.host, self.port)
        except (TransportError, OSError):
            self._drop_connection()
            raise
        self.transport = transport_kind(self._transport)

    def _drop_connection(self) -> None:
        if self._transport is not None:
            self._transport.close()
            self._transport = None

    def start(self) -> None:
        from nnstreamer_tpu_torch.pipeline.faults import backoff_s

        self._obs_reg = obs_metrics.get()
        if self._fleet is not None:
            self._start_fleet()
            return
        attempt = 0
        while True:
            try:
                self._connect_once()
                return
            except UnresolvableError as exc:
                # terminal, distinct: retrying a name that does not
                # resolve burns the whole budget for nothing
                raise ElementError(
                    f"{self.name}: query server host {self.host!r} is "
                    f"unresolvable: {exc}"
                ) from exc
            except (TransportError, OSError) as exc:
                if attempt >= self.retry_max:
                    raise ElementError(
                        f"{self.name}: cannot reach query server "
                        f"{self.host}:{self.port}"
                        + (f" after {attempt + 1} attempts" if attempt else "")
                        + f": {exc}"
                    ) from exc
                time.sleep(backoff_s(attempt, self._retry_policy, self._rng))
                attempt += 1

    def _start_fleet(self) -> None:
        """Fleet start: at least ONE endpoint must be reachable (the
        rest connect lazily on first dispatch/failover)."""
        from nnstreamer_tpu_torch.pipeline.faults import backoff_s

        self.connect_type = _check_connect_type(self)
        attempt = 0
        while True:
            last_exc = None
            for ep in self._fleet.plan():
                try:
                    self._ep_transport(ep)
                    return
                except UnresolvableError as exc:
                    self._fleet.record_fail(ep, unresolvable=True)
                    last_exc = exc
                except (TransportError, OSError) as exc:
                    self._fleet.record_fail(ep)
                    last_exc = exc
            if attempt >= self.retry_max:
                addrs = ",".join(
                    e.addr for e in self._fleet.endpoints
                )
                raise ElementError(
                    f"{self.name}: no reachable endpoint in fleet "
                    f"[{addrs}]"
                    + (f": {last_exc}" if last_exc is not None else "")
                )
            time.sleep(max(
                backoff_s(attempt, self._retry_policy, self._rng),
                self._fleet.next_retry_in(),
            ))
            attempt += 1

    def _ep_transport(self, ep):
        """Get-or-connect the transport for one fleet endpoint. The
        connect timeout is clamped well under the request timeout so a
        blackholed endpoint cannot eat the whole deadline inside one
        connect; the hostname re-resolves on every (re)connect."""
        t = self._ep_transports.get(ep)
        if t is not None:
            return t
        if self.connect_type == "TCP":
            resolve_target(ep.host, ep.port)
        t = self._build_transport(
            connect_timeout=max(0.2, min(2.0, self.timeout / 2.0))
        )
        try:
            t.connect(ep.host, ep.port)
        except BaseException:
            t.close()
            raise
        self.transport = transport_kind(t)
        self._ep_transports[ep] = t
        return t

    def _close_ep(self, ep) -> None:
        t = self._ep_transports.pop(ep, None)
        if t is not None:
            t.close()

    def stop(self) -> None:
        self._drop_connection()
        for ep in list(self._ep_transports):
            self._close_ep(ep)

    def _stamp_request(self, frame: Frame):
        """Correlation + SLO meta shared by the single-endpoint and
        fleet request paths."""
        fid = frame.meta.get("frame_id")
        if fid is None:
            fid = f"{self._fid_prefix}.{next(self._fid_seq)}"
            frame = frame.with_meta(frame_id=fid)
        if self.deadline_ms > 0 and "deadline_ms" not in frame.meta:
            frame = frame.with_meta(deadline_ms=self.deadline_ms)
        if self.priority is not None and "priority" not in frame.meta:
            frame = frame.with_meta(priority=self.priority)
        if self._router is not None and ROUTE_META_KEY not in frame.meta:
            keys = self._route_keys_of(frame)
            if keys:
                # _wire_meta keeps scalars only, so the key chain rides
                # flattened as one dot-joined hex string
                frame = frame.with_meta(**{ROUTE_META_KEY: ".".join(keys)})
        return frame, fid

    @staticmethod
    def _route_keys_of(frame: Frame) -> List[str]:
        """Rolling-CRC prefix keys of an LLM prompt frame — the first
        tensor when it is integer-typed (token ids); anything else
        (images, floats) routes by load alone."""
        if not frame.tensors:
            return []
        arr = np.asarray(frame.to_host().tensors[0])
        if not np.issubdtype(arr.dtype, np.integer):
            return []
        return prefix_route_keys(arr.ravel())

    def _finish_reply(self, msg, frame: Frame, fid, t_req: float):
        """Trace + metrics + reply normalization shared by both request
        paths."""
        rtt_s = time.perf_counter() - t_req
        if self._rtts is not None:
            self._rtts.record(rtt_s)  # feeds the adaptive hedge p99
        tracer = trace.get()
        if tracer is not None:
            # the client half of the cross-process pair: merge() lines
            # this span up with the server's frame_id-tagged spans
            tracer.complete(
                self.name, "edge", t_req, rtt_s, {"frame_id": fid}
            )
        reg = self._obs_reg
        if reg is not None:
            if self._rtt_hist is None:
                self._rtt_hist = reg.histogram(
                    "nns_edge_rtt_us", element=self.name
                )
            self._rtt_hist.observe(rtt_s * 1e6)
            reg.counter(
                "nns_edge_requests_total", element=self.name
            ).inc()
        reply = msg
        if isinstance(reply, EOS):
            return None
        if reply.meta.get("frame_id") is None:
            reply = reply.with_meta(frame_id=fid)
        return reply.with_pts(frame.pts, frame.duration)

    def process(self, frame: Frame) -> Optional[Frame]:
        from nnstreamer_tpu_torch.pipeline.faults import backoff_s

        if self._fleet is not None:
            return self._process_fleet(frame)
        frame, fid = self._stamp_request(frame)
        data = encode_message(frame)
        t_req = time.perf_counter()
        attempt = 0
        while True:
            sent = False
            try:
                if self._transport is None:
                    # reconnect after a timeout-dropped/failed connection
                    self._connect_once()
                self._transport.send(0, data)
                sent = True
                got = self._transport.recv(timeout=self.timeout)
                if got is None:
                    # In a pipeline this error poisons the stream, matching
                    # the reference's GST_FLOW_ERROR on query timeout. For
                    # standalone (direct process()) callers who catch and
                    # continue, drop the connection first so a reply
                    # arriving *after* the timeout can't be returned for
                    # the NEXT frame (off-by-one desync); the next call
                    # reconnects. Timeouts do NOT ride the reconnect-retry
                    # loop: the server may have received the request, and
                    # a resend could double-process it.
                    self._drop_connection()
                    raise ElementError(
                        f"{self.name}: query timeout after {self.timeout}s"
                    )
                _, payload = got
                if not payload:
                    raise TransportError("server closed the connection")
                msg = decode_message(payload)
                if isinstance(msg, Nack):
                    # a NACK means the server did NOT process the request,
                    # so a resend cannot double-process: honor the
                    # retry-after hint on the existing retry budget.
                    # Reason "deadline" is terminal — the request WAS
                    # admitted and then shed; the budget it consumed is
                    # gone and the reply window with it.
                    self._count_nack(msg.reason)
                    if msg.reason == REASON_DEADLINE:
                        raise ElementError(
                            f"{self.name}: server shed the request "
                            f"(deadline {self.deadline_ms:.0f} ms missed)"
                        )
                    if msg.reason == REASON_FAILED:
                        # the server admitted AND processed the request,
                        # and its fault policy dropped it — a resend
                        # would re-run work that already failed
                        raise ElementError(
                            f"{self.name}: server failed the request "
                            "(dropped by its error policy)"
                        )
                    if attempt >= self.retry_max:
                        raise ElementError(
                            f"{self.name}: server rejected the request "
                            f"({msg.reason}) after {attempt + 1} attempt(s); "
                            f"retry-after hint {msg.retry_after_ms:.0f} ms"
                        )
                    delay = max(
                        msg.retry_after_ms / 1000.0,
                        backoff_s(attempt, self._retry_policy, self._rng),
                    )
                    attempt += 1
                    # reconnect for the retry: a conn-level reject (the
                    # max-clients accept path) NACKs then CLOSES, and a
                    # resend into that dead socket would buffer fine but
                    # fail at recv with sent=True — terminal, wasting
                    # the whole retry budget. The NACK guarantees the
                    # request was not processed, so reconnect+resend is
                    # always safe; the reconnect is wasted only on a
                    # still-healthy connection, and the retry-after
                    # sleep dwarfs the handshake.
                    self._drop_connection()
                    time.sleep(delay)
                    continue
                break
            except UnresolvableError as exc:
                # the satellite bugfix: a reconnect whose target no
                # longer RESOLVES is terminal with a distinct reason —
                # not retry-max spins against a gone name
                self._drop_connection()
                raise ElementError(
                    f"{self.name}: query server host {self.host!r} is "
                    f"unresolvable: {exc}"
                ) from exc
            except (TransportError, OSError) as exc:
                self._drop_connection()
                # the retry loop covers CONNECT/SEND failures only: once
                # the request went out, a lost connection is the timeout
                # case in different clothes — the server may have
                # processed it, and a resend could double-process (the
                # reconnected transport still serves the NEXT frame)
                if sent or attempt >= self.retry_max:
                    raise ElementError(
                        f"{self.name}: query transport failed"
                        + (f" after {attempt + 1} attempts" if attempt else "")
                        + f": {exc}"
                    ) from exc
                time.sleep(backoff_s(attempt, self._retry_policy, self._rng))
                attempt += 1
        return self._finish_reply(msg, frame, fid, t_req)

    # -- fleet request path (docs/edge-serving.md "Running a fleet") -------
    def _process_fleet(self, frame: Frame) -> Optional[Frame]:
        from nnstreamer_tpu_torch.pipeline.faults import backoff_s

        frame, fid = self._stamp_request(frame)
        data = encode_message(frame)
        t_req = time.perf_counter()
        deadline = time.monotonic() + self.timeout
        hedger = HedgeTimer(self.hedge_after_ms, rtts=self._rtts)
        inflight: List = []   # [(endpoint, transport)] holding this request
        tried = set()         # endpoint idx already failed/NACKed this round
        sends = 0
        nack_attempt = 0      # retry budget for whole-fleet rejection rounds
        pending_hint_s = 0.0  # retry-after carried into the next round

        failed_eps = 0        # endpoints that failed/NACKed this request
        # prefix-aware routing: prefer the endpoint that last served the
        # longest recorded prefix of this prompt — advisory only, the
        # health/draining plan still decides who is sendable at all
        route_keys: List[str] = []
        pref_addr = None
        if self._router is not None:
            pfx = frame.meta.get(ROUTE_META_KEY)
            route_keys = str(pfx).split(".") if pfx else []
            best = self._router.best(route_keys) if route_keys else None
            if best is not None:
                pref_addr = best[0]

        def _send_next(is_hedge: bool = False):
            """Send this request to the next endpoint the plan allows;
            returns (sent, last_exc). Counts a failover whenever the
            request lands on an endpoint after another one failed it —
            whether the first failure happened at send time (dead
            socket, unresolvable) or after the request was in flight."""
            nonlocal sends, failed_eps
            last_exc = None
            plan = self._fleet.plan()
            if pref_addr is not None:
                # stable: non-preferred endpoints keep the plan's order
                plan.sort(key=lambda e: e.addr != pref_addr)
            for ep in plan:
                if ep.idx in tried or any(e is ep for e, _t in inflight):
                    continue
                try:
                    tr = self._ep_transport(ep)
                    tr.send(0, data)
                except UnresolvableError as exc:
                    self._fleet.record_fail(ep, unresolvable=True)
                    self._close_ep(ep)
                    tried.add(ep.idx)
                    ep.failovers += 1
                    failed_eps += 1
                    last_exc = exc
                    continue
                except (TransportError, OSError) as exc:
                    self._fleet.record_fail(ep)
                    self._close_ep(ep)
                    tried.add(ep.idx)
                    ep.failovers += 1
                    failed_eps += 1
                    last_exc = exc
                    continue
                ep.inflight += 1
                inflight.append((ep, tr))
                sends += 1
                if is_hedge:
                    self._count_hedge()
                elif failed_eps:
                    self._count_failover()
                if pref_addr is not None and ep.addr == pref_addr \
                        and not is_hedge:
                    self._count_prefix_hit()
                return True, None
            return False, last_exc

        def _drop_inflight(i: int, failed: bool) -> None:
            nonlocal failed_eps
            ep, _tr = inflight.pop(i)
            ep.inflight = max(0, ep.inflight - 1)
            if failed:
                ep.failovers += 1
                failed_eps += 1
                tried.add(ep.idx)

        while True:
            now = time.monotonic()
            if now >= deadline:
                # straggler timeout: every endpoint still holding the
                # request takes a health hit, but the connections stay —
                # the frame_id dedup drops their late replies, so the
                # NEXT request cannot be answered off-by-one
                for ep, _tr in inflight:
                    ep.inflight = max(0, ep.inflight - 1)
                    self._fleet.record_fail(ep)
                self._dedup.claim(fid)  # a late reply must never deliver
                raise ElementError(
                    f"{self.name}: query timeout after {self.timeout}s"
                )
            if not inflight:
                sent, last_exc = _send_next()
                if not sent:
                    if nack_attempt >= self.retry_max:
                        raise ElementError(
                            f"{self.name}: no fleet endpoint accepted the "
                            f"request after {nack_attempt + 1} round(s)"
                            + (f": {last_exc}" if last_exc else "")
                        )
                    delay = max(
                        pending_hint_s,
                        backoff_s(nack_attempt, self._retry_policy,
                                  self._rng),
                        self._fleet.next_retry_in(),
                    )
                    nack_attempt += 1
                    pending_hint_s = 0.0
                    time.sleep(min(delay, max(0.001, deadline - now)))
                    tried.clear()  # a fresh round may retry everyone —
                    failed_eps = 0  # and a same-endpoint resend after a
                    #                 whole-fleet-refused round is a
                    #                 RETRY, not a failover
                    continue
                if sends == 1:
                    hedger.arm()
            # wait for a reply on the in-flight transports; with a
            # hedge outstanding, round-robin short polls keep both live
            got = None
            src = 0
            if len(inflight) == 1:
                ep, tr = inflight[0]
                slice_s = min(0.02, max(0.001, deadline - now))
                try:
                    got = tr.recv(timeout=slice_s)
                except (TransportError, OSError):
                    got = (0, b"")
            else:
                for i, (ep, tr) in enumerate(inflight):
                    try:
                        got = tr.recv(timeout=0.005)
                    except (TransportError, OSError):
                        got = (0, b"")
                    if got is not None:
                        src = i
                        break
            if got is None:
                if hedger.due():
                    hedger.fire()  # one hedge per request, sent or not
                    _send_next(is_hedge=True)
                continue
            ep, tr = inflight[src]
            _cid, payload = got
            if not payload:
                # connection died under the request: fail over
                self._fleet.record_fail(ep)
                self._close_ep(ep)
                _drop_inflight(src, failed=True)
                continue
            try:
                msg = decode_message(payload)
            except ValueError:
                continue  # garbage on the reply path: ignore, keep waiting
            if isinstance(msg, Ctrl):
                continue  # control messages are client→server only
            if isinstance(msg, Nack):
                nfid = msg.frame_id
                if nfid is not None and nfid != fid:
                    self.stale_replies += 1
                    continue  # a NACK for an already-terminal request
                self._count_nack(msg.reason)
                if msg.reason == REASON_DRAINING:
                    # rolling restart: bench for exactly the hint and
                    # re-route — the request was NOT processed
                    self._fleet.mark_draining(ep, msg.retry_after_ms)
                    pending_hint_s = max(
                        pending_hint_s, msg.retry_after_ms / 1000.0
                    )
                    _drop_inflight(src, failed=True)
                    continue
                if msg.reason in (REASON_DEADLINE, REASON_FAILED):
                    # terminal verdicts — but a hedge may still win
                    _drop_inflight(src, failed=True)
                    if inflight:
                        continue
                    if msg.reason == REASON_DEADLINE:
                        raise ElementError(
                            f"{self.name}: server shed the request "
                            f"(deadline {self.deadline_ms:.0f} ms missed)"
                        )
                    raise ElementError(
                        f"{self.name}: server failed the request "
                        "(dropped by its error policy)"
                    )
                # retryable admission NACK (overload / rate / max-clients
                # / client-backpressure / malformed): the natural fleet
                # response is failover; the conn-level reject path also
                # CLOSES, so drop the transport before moving on
                pending_hint_s = max(
                    pending_hint_s, msg.retry_after_ms / 1000.0
                )
                self._close_ep(ep)
                _drop_inflight(src, failed=True)
                continue
            # DATA (or EOS) reply
            rfid = getattr(msg, "meta", {}).get(
                "frame_id"
            ) if not isinstance(msg, EOS) else None
            if rfid is not None and rfid != fid:
                # a late reply to an ALREADY-terminal request (timeout/
                # failover winner already delivered): at-most-once means
                # it is dropped here, never pushed downstream
                if self._dedup.seen(rfid):
                    self._dedup.claim(rfid)  # count the duplicate
                else:
                    self.stale_replies += 1
                continue
            if not self._dedup.claim(fid):
                continue  # hedge loser: the first reply already won
            for e, _t in inflight:
                e.inflight = max(0, e.inflight - 1)
            self._fleet.record_ok(ep)
            if self._router is not None and route_keys:
                # the answering endpoint now holds this prompt's KV
                # prefix — future repeat-prefix requests prefer it
                self._router.note(route_keys, ep.addr)
            return self._finish_reply(msg, frame, fid, t_req)

    def _count_failover(self) -> None:
        self.fleet_failovers += 1
        reg = self._obs_reg
        if reg is None:
            return
        if self._failover_ctr is None:
            self._failover_ctr = reg.counter(
                "nns_fleet_failovers_total", element=self.name
            )
        self._failover_ctr.inc()

    def _count_hedge(self) -> None:
        self.fleet_hedges += 1
        reg = self._obs_reg
        if reg is None:
            return
        if self._hedge_ctr is None:
            self._hedge_ctr = reg.counter(
                "nns_fleet_hedges_total", element=self.name
            )
        self._hedge_ctr.inc()

    def _count_prefix_hit(self) -> None:
        self._router.prefix_hits += 1
        reg = self._obs_reg
        if reg is None:
            return
        if self._pfx_hit_ctr is None:
            self._pfx_hit_ctr = reg.counter(
                "nns_route_prefix_hits_total", element=self.name
            )
        self._pfx_hit_ctr.inc()

    def fleet_stats(self) -> Dict[str, object]:
        """Executor.stats() hook (``fleet_*`` keys; nns-top --fleet)."""
        if self._fleet is None:
            return {}
        out = {
            "endpoints": self._fleet.snapshot(),
            "healthy": self._fleet.healthy_count(),
            "failovers": self.fleet_failovers,
            "hedges": self.fleet_hedges,
            "duplicate_replies": self._dedup.duplicates,
            "stale_replies": self.stale_replies,
        }
        if self._router is not None:
            out["prefix_hits"] = self._router.prefix_hits
            out["prefix_index"] = len(self._router)
        return out

    def _count_nack(self, reason: str) -> None:
        reg = self._obs_reg
        if reg is None:
            return
        ctr = self._nack_ctrs.get(reason)
        if ctr is None:
            ctr = self._nack_ctrs[reason] = reg.counter(
                "nns_edge_nacks_total", element=self.name, reason=reason
            )
        ctr.inc()


@registry.element("tensor_query_serversrc")
class TensorQueryServerSrc(Source):
    """Emit incoming query requests, tagged with client_id meta.

    Props: host (default 127.0.0.1), port (0 = ephemeral; read back via
    ``bound_port``), id (pairing key, default "0"),
    connect-type=TCP|MQTT|HYBRID|SHM, topic (MQTT/HYBRID), data-host/
    data-port (HYBRID TCP data plane, default ephemeral loopback).

    Admission control (docs/edge-serving.md): ``max-clients``,
    ``max-inflight``, ``per-client-inflight``, ``rate``/``rate-burst``
    bound what the server accepts — excess connections and requests get
    an explicit structured NACK (reason + ``retry-after-ms`` hint) on
    the wire instead of queueing forever. Admitted requests are served
    weighted-fair: strict priority classes (the client's ``priority``
    meta, lower = more urgent), round-robin across clients within a
    class, so one hot client cannot starve the rest. Every admitted
    frame is stamped with its admission time so the executor's
    deadline-aware shedder can drop SLO-missed frames before they
    consume device time. A serversrc with NO bound set keeps the legacy
    unbounded behavior (nns-lint NNS-W111 warns).
    """

    FACTORY_NAME = "tensor_query_serversrc"

    PROPERTIES = {
        "host": PropSpec("str", "127.0.0.1"),
        "port": PropSpec("int", 0, desc="0 = ephemeral"),
        "id": PropSpec("str", "0", desc="pairing key with serversink"),
        "connect-type": PropSpec("enum", "TCP", CONNECT_TYPES),
        "topic": PropSpec("str", "nns-query"),
        "data-host": PropSpec("str", "127.0.0.1", desc="HYBRID data plane"),
        "data-port": PropSpec("int", 0, desc="HYBRID data plane"),
        "max-clients": PropSpec(
            "int", 0, desc="admission: concurrent client cap (0 = none)"
        ),
        "max-inflight": PropSpec(
            "int", 0,
            desc="admission: global in-flight request cap (0 = none)",
        ),
        "per-client-inflight": PropSpec(
            "int", 0,
            desc="admission: per-client in-flight cap (0 = none)",
        ),
        "rate": PropSpec(
            "float", 0.0,
            desc="admission: global token-bucket rate, requests/s "
            "(0 = none)",
        ),
        "rate-burst": PropSpec(
            "int", 0, desc="token-bucket depth (0 = max(1, rate))"
        ),
        "retry-after-ms": PropSpec(
            "float", 50.0, desc="base retry-after hint carried by NACKs"
        ),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.host = str(self.get_property("host", "127.0.0.1"))
        self.port = int(self.get_property("port", 0))
        self.srv_id = str(self.get_property("id", "0"))
        self.topic = str(self.get_property("topic", "nns-query"))
        # HYBRID: host/port address the broker; the TCP data plane binds
        # data-host:data-port (default ephemeral on loopback)
        self.data_host = str(self.get_property("data-host", "127.0.0.1"))
        self.data_port = int(self.get_property("data-port", 0))
        self.connect_type = "TCP"
        self.bound_port: Optional[int] = None
        self._transport = None
        self.transport = "none"  # transport_kind of the listening end
        self._adm_cfg = AdmissionConfig.from_element(self)
        self._controller: Optional[AdmissionController] = None
        self.malformed_total = 0  # undecodable requests NACKed
        # readiness flag (docs/edge-serving.md "Running a fleet"):
        # ready / draining / dead — exposed via admission_stats() on the
        # obs endpoint; fleet clients learn "draining" from the NACKs
        self.state = SRV_DEAD
        self.drain_nacked = 0  # new submits NACKed while draining

    def output_spec(self) -> Spec:
        self.connect_type = _check_connect_type(self)
        return TensorsSpec(format=TensorFormat.FLEXIBLE)

    def start(self) -> None:
        self.connect_type = _check_connect_type(self)
        if self._adm_cfg.active:
            self._controller = AdmissionController(
                self._adm_cfg, name=self.name
            )
        self._transport = _make_server_transport(
            self.connect_type, self.topic, self.data_host, self.data_port,
            max_conns=self._adm_cfg.max_clients,
            retry_after_ms=self._adm_cfg.retry_after_ms,
        )
        self.bound_port = self._transport.listen(self.host, self.port)
        self.transport = transport_kind(self._transport)
        self.state = SRV_READY
        _register_server(self.srv_id, self._transport, self._controller)

    def stop(self) -> None:
        self.state = SRV_DEAD
        _unregister_server(self.srv_id, self._transport)
        if self._transport is not None:
            self._transport.close()
            self._transport = None

    # -- graceful drain (docs/edge-serving.md "Running a fleet") -----------
    def drain(self, flush_queued: bool = False) -> None:
        """Stop accepting new work: from now on new submits are NACKed
        with the terminal-after-retry reason ``draining`` (+ the
        ``retry-after-ms`` hint), while already-admitted requests keep
        flowing to their replies (or dead-letter) through the normal
        admission budget-release path. ``flush_queued=True`` additionally
        NACKs the queued-but-unserved admitted backlog so those requests
        re-route NOW instead of waiting out this server. The rolling-
        restart recipe: ``drain()`` → wait for :meth:`drained` →
        ``Executor.drain()`` (quiesce the graph) → stop/restart — zero
        accepted requests lost. Also reachable over the wire via the
        ``drain`` control message (:func:`request_drain`)."""
        self.state = SRV_DRAINING
        _set_server_state(self.srv_id, SRV_DRAINING)
        if flush_queued and self._controller is not None:
            from nnstreamer_tpu_torch.pipeline.faults import notify_drain_flush

            for frame in self._controller.flush_ready():
                notify_drain_flush(frame, self.name)

    def drained(self) -> bool:
        """True once drain() was called and no admitted request remains
        in flight (every accepted request reached its terminal
        outcome)."""
        if self.state != SRV_DRAINING:
            return False
        if self._controller is None:
            return True
        return self._controller.snapshot()["inflight"] == 0

    def _nack_draining(self, cid, frame_id=None) -> None:
        self.drain_nacked += 1
        if self._controller is not None:
            self._controller.count_reject(REASON_DRAINING)
        self._send_nack(
            cid, REASON_DRAINING, self._adm_cfg.retry_after_ms,
            frame_id=frame_id,
        )

    def _trace_in(self, frame, cid) -> None:
        tracer = trace.get()
        if tracer is not None:
            tracer.instant(
                self.name, cat="edge",
                frame_id=frame.meta.get("frame_id"), client_id=cid,
            )

    def _stamp(self, frame, cid):
        """Admission meta: client_id routes the reply, admit_t anchors
        the deadline shedder, _nns_srv lets the shedding node find this
        server to NACK — the latter two are local-only keys that never
        ride the wire (serialize._WIRE_META_SKIP)."""
        return frame.with_meta(
            client_id=cid, admit_t=time.monotonic(), _nns_srv=self.srv_id
        )

    def _send_nack(self, cid, reason: str, retry_after_ms: float,
                   frame_id=None) -> None:
        try:
            self._transport.send(
                cid, encode_nack(reason, retry_after_ms, frame_id=frame_id)
            )
        except (TransportError, OSError):
            pass  # the client vanished; nothing to tell

    def _handle_ctrl(self, cid, msg) -> None:
        """Operator/fleet control ops: ``drain``, and the migration
        handshake routed to the LLM server registered for the
        requested ``llm_id`` (docs/llm-serving.md). Every migrate op
        gets an explicit reply — the sender decides fallback on it."""
        if msg.op == "drain":
            self.drain()
            return
        if msg.op not in ("migrate_probe", "migrate_span", "disagg_fetch"):
            return  # unknown ctrl: ignore (both ends live in-tree)
        # spans must not LAND on a draining endpoint — but disagg_fetch
        # moves finished results OUT, and a draining decode server only
        # quiesces once its parked handoffs are collected
        if self.state == SRV_DRAINING and msg.op != "disagg_fetch":
            reply = encode_ctrl(
                "migrate_nack", reason="draining",
                retry_after_ms=float(self._adm_cfg.retry_after_ms),
            )
        else:
            handler = _get_migration_handler(
                int(msg.meta.get("llm_id", 0) or 0)
            )
            if handler is None:
                reply = encode_ctrl(
                    "migrate_nack", reason="no-migration-handler"
                )
            else:
                try:
                    if msg.op == "migrate_probe":
                        n = handler.migration_probe(
                            msg.meta.get("tokens", [])
                        )
                        # decode-role servers piggyback their pool
                        # headroom advert on the probe ack — one
                        # roundtrip answers "how warm AND how full"
                        advert = getattr(handler, "migration_advert",
                                         None)
                        extra = dict(advert()) if advert else {}
                        extra["shared_tokens"] = int(n)
                        reply = encode_ctrl("migrate_probe_ack", **extra)
                    elif msg.op == "disagg_fetch":
                        fetch = getattr(handler, "disagg_fetch", None)
                        if fetch is None:
                            reply = encode_ctrl(
                                "migrate_nack", reason="no-disagg-role"
                            )
                        else:
                            toks = fetch(int(msg.meta.get("rid", -1)))
                            if toks is None:
                                reply = encode_ctrl(
                                    "disagg_fetch_ack", done=0
                                )
                            else:
                                reply = encode_ctrl(
                                    "disagg_fetch_ack", done=1,
                                    tokens=[int(t) for t in toks],
                                )
                    else:
                        rid = handler.migration_adopt(msg.payload)
                        reply = encode_ctrl(
                            "migrate_span_ack", rid=int(rid)
                        )
                except Exception as exc:  # span taxonomy → wire reason
                    # capacity refusals are retryable, not fatal: NACK
                    # with the admission retry hint instead of letting
                    # the pool error crash the serversrc service loop
                    from nnstreamer_tpu_torch.kv.blocks import PoolCapacityError
                    from nnstreamer_tpu_torch.kv.migrate import SpanCapacityError
                    extra = {}
                    if isinstance(exc, (PoolCapacityError,
                                        SpanCapacityError)):
                        extra["retry_after_ms"] = float(
                            self._adm_cfg.retry_after_ms
                        )
                    reply = encode_ctrl(
                        "migrate_nack",
                        reason=f"{type(exc).__name__}: {exc}",
                        **extra,
                    )
        try:
            self._transport.send(cid, reply)
        except (TransportError, OSError):
            pass  # the migrating peer vanished; it will fall back

    def _handle_incoming(self, cid, payload) -> None:
        """Admission at arrival: decode, admit or NACK, queue."""
        ctrl = self._controller
        if not payload:
            ctrl.client_gone(cid)
            return
        try:
            msg = decode_message(payload)
        except ValueError:
            self.malformed_total += 1
            ctrl.count_reject(REASON_MALFORMED)
            self._send_nack(cid, REASON_MALFORMED, 0.0)
            return
        if isinstance(msg, Ctrl):
            self._handle_ctrl(cid, msg)
            return
        if isinstance(msg, (EOS, Nack)):
            return  # one client's EOS must not stop the server
        if self.state == SRV_DRAINING:
            # graceful drain: new work is refused with an explicit
            # reason + hint so fleet clients re-route immediately
            self._nack_draining(cid, frame_id=msg.meta.get("frame_id"))
            return
        frame = self._stamp(msg, cid)
        decision = ctrl.offer(cid, frame)
        if not decision.ok:
            self._send_nack(
                cid, decision.reason, decision.retry_after_ms,
                frame_id=frame.meta.get("frame_id"),
            )

    def generate(self):
        ctrl = self._controller
        if ctrl is None:
            # unbounded legacy path (nns-lint NNS-W111 warns): still
            # stamps admission meta so deadline shedding works
            got = self._transport.recv(timeout=0.1)
            if got is None:
                return None  # re-poll; executor loops until EOS/stop
            cid, payload = got
            if not payload:
                return None  # client disconnect; keep serving others
            try:
                frame = decode_message(payload)
            except ValueError:
                # one client's garbage must not crash the server for
                # everyone: same structured NACK as the admission path
                self.malformed_total += 1
                self._send_nack(cid, REASON_MALFORMED, 0.0)
                return None
            if isinstance(frame, Ctrl):
                self._handle_ctrl(cid, frame)
                return None
            if isinstance(frame, EOS):
                return None
            if isinstance(frame, Nack):
                return None  # NACKs are server→client only; ignore
            if self.state == SRV_DRAINING:
                self._nack_draining(
                    cid, frame_id=frame.meta.get("frame_id")
                )
                return None
            self._trace_in(frame, cid)
            return self._stamp(frame, cid)
        # drain everything that arrived (admitting or NACKing each),
        # then serve ONE request picked weighted-fair across clients
        got = self._transport.recv(
            timeout=0.0 if ctrl.has_ready() else 0.1
        )
        while got is not None:
            self._handle_incoming(*got)
            got = self._transport.recv(timeout=0.0)
        frame = ctrl.next_ready()
        if frame is None:
            return None
        self._trace_in(frame, frame.meta.get("client_id"))
        return frame

    def admission_stats(self) -> Dict[str, object]:
        """Executor.stats() hook (``adm_*`` keys; nns-top --clients).
        ``readiness`` is the drain/rolling-restart flag the obs endpoint
        exposes (ready / draining / dead)."""
        ctrl = self._controller
        out: Dict[str, object] = {"readiness": self.state}
        if ctrl is not None:
            out.update(ctrl.snapshot())
        if self.drain_nacked:
            out["drain_nacked"] = self.drain_nacked
        if self.malformed_total:
            out["malformed"] = self.malformed_total
        t = self._transport
        rejected_conns = getattr(t, "rejected_conns", 0) if t else 0
        if rejected_conns:
            out["rejected_conns"] = rejected_conns
        return out


@registry.element("tensor_query_serversink")
class TensorQueryServerSink(Sink):
    """Send results back to the requesting client (by client_id meta).

    Props: id (pairing key matching the serversrc, default "0").

    Overload resilience: a reply whose client vanished is counted
    (``reply_failed``) and skipped, never fatal — one dead client must
    not poison the serving pipeline for everyone else. Each rendered (or
    failed) reply releases the request's admission budget.
    """

    FACTORY_NAME = "tensor_query_serversink"

    PROPERTIES = {
        "id": PropSpec("str", "0", desc="pairing key with serversrc"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.srv_id = str(self.get_property("id", "0"))
        self.reply_failed = 0  # replies to vanished clients (skipped)

    def render(self, frame: Frame) -> None:
        frame = self.host_frame(frame)  # the negotiated dtypes on the wire
        transport = _get_server(self.srv_id)
        if transport is None:
            raise ElementError(
                f"{self.name}: no tensor_query_serversrc with id={self.srv_id}"
            )
        cid = frame.meta.get("client_id")
        if cid is None:
            raise ElementError(
                f"{self.name}: frame lacks client_id meta (did it pass "
                "through tensor_query_serversrc?)"
            )
        tracer = trace.get()
        if tracer is not None:
            tracer.instant(
                self.name, cat="edge",
                frame_id=frame.meta.get("frame_id"), client_id=cid,
            )
        try:
            transport.send(cid, encode_message(frame))
        except (TransportError, OSError):
            self.reply_failed += 1
        finally:
            # dead-lettered frames already released their budget at the
            # fault-gate disposal (faults.py route path) — releasing
            # again here would silently loosen the admission caps
            if not frame.meta.get("_nns_budget_released"):
                ctrl = _get_controller(self.srv_id)
                if ctrl is not None:
                    ctrl.release(cid)
