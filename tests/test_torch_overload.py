"""The cases of ``tests/test_overload.py``
(less the NNS-W111 lint case: the lint is not ported) run through the port's edge
layer (``nnstreamer_tpu_torch.edge``) on the CPU, with ephemeral ports and
short timeouts; ``tests/test_torch_edge_interop.py`` holds it against the
reference. The reference's notes follow.

Overload-resilient multi-tenant query serving (docs/edge-serving.md).

Admission caps → structured NACKs, per-client weighted-fair scheduling,
token-bucket rate limiting with honored retry-after hints, deadline-aware
shedding at executor dequeue (with the frame-accounting invariant intact),
the chaos harness's network-fault modes, the shm query transport, and the
NNS-W111 lint. The real multi-client soak (2× offered load + injected
connection faults + a slow-loris) is marked ``slow`` — the tier-1 portion
here stays fast.
"""

import threading
import time

import numpy as np
import pytest

from nnstreamer_tpu_torch.edge.admission import (
    AdmissionConfig,
    AdmissionController,
)
from nnstreamer_tpu_torch.edge.query import (
    TensorQueryClient,
    TensorQueryServerSink,
    TensorQueryServerSrc,
)
from nnstreamer_tpu_torch.edge.serialize import (
    Nack,
    decode_message,
    encode_message,
    encode_nack,
)
from nnstreamer_tpu_torch.edge.transport import PyTransport
from nnstreamer_tpu_torch.elements.base import ElementError
from nnstreamer_tpu_torch.tensors.frame import Frame


def _frame(val: float = 0.0, **meta) -> Frame:
    return Frame((np.full(4, val, np.float32),), meta=meta)


def _req(val: float = 0.0) -> bytes:
    return encode_message(_frame(val))


def _echo_server(src, sink, stop_evt, scale=2.0):
    while not stop_evt.is_set():
        frame = src.generate()
        if frame is None:
            continue
        sink.render(
            frame.with_tensors([np.asarray(t) * scale for t in frame.tensors])
        )


# ------------------------------------------------------------------ wire
def test_nack_wire_roundtrip():
    n = decode_message(encode_nack("overload", 75.5, frame_id="a.b.3"))
    assert isinstance(n, Nack)
    assert n.reason == "overload"
    assert n.retry_after_ms == 75.5
    assert n.frame_id == "a.b.3"
    # reasons without hints decode too
    n2 = decode_message(encode_nack("malformed"))
    assert n2.reason == "malformed" and n2.retry_after_ms == 0.0


# ------------------------------------------------- controller unit tests
def test_admission_global_and_per_client_caps():
    ctrl = AdmissionController(
        AdmissionConfig(max_inflight=3, per_client_inflight=2)
    )
    assert ctrl.offer("a", _frame()).ok
    assert ctrl.offer("a", _frame()).ok
    d = ctrl.offer("a", _frame())
    assert not d.ok and d.reason == "client-backpressure"
    assert ctrl.offer("b", _frame()).ok
    d = ctrl.offer("b", _frame())  # global cap (3) before b's own (2)
    assert not d.ok and d.reason == "overload" and d.retry_after_ms > 0
    # release returns budget; same client admits again
    ctrl.release("a")
    assert ctrl.offer("b", _frame()).ok
    snap = ctrl.snapshot()
    assert snap["rejected_by_reason"] == {
        "client-backpressure": 1, "overload": 1
    }


def test_admission_max_clients_and_client_gone():
    ctrl = AdmissionController(AdmissionConfig(max_clients=2))
    assert ctrl.offer("a", _frame()).ok
    assert ctrl.offer("b", _frame()).ok
    d = ctrl.offer("c", _frame())
    assert not d.ok and d.reason == "max-clients"
    ctrl.client_gone("a")  # slot freed (queued request flushed too)
    assert ctrl.offer("c", _frame()).ok
    assert ctrl.snapshot()["inflight"] == 2  # a's queued request flushed


def test_admission_token_bucket_deterministic():
    ctrl = AdmissionController(AdmissionConfig(rate=10.0, burst=2))
    t0 = 1000.0
    assert ctrl.offer("a", _frame(), now=t0).ok
    assert ctrl.offer("a", _frame(), now=t0).ok
    d = ctrl.offer("a", _frame(), now=t0)  # bucket drained
    assert not d.ok and d.reason == "rate"
    # the hint reflects the actual refill deficit: 1 token at 10/s = 100 ms
    assert 50.0 <= d.retry_after_ms <= 150.0
    # 100 ms later one token refilled
    assert ctrl.offer("a", _frame(), now=t0 + 0.1).ok
    assert not ctrl.offer("a", _frame(), now=t0 + 0.1).ok


def test_fair_share_hot_client_and_priority():
    ctrl = AdmissionController(AdmissionConfig(max_inflight=100))
    for i in range(6):
        assert ctrl.offer("hot", _frame(i)).ok
    assert ctrl.offer("cold", _frame(100.0)).ok
    assert ctrl.offer("cold", _frame(101.0)).ok
    order = [
        float(np.asarray(ctrl.next_ready().tensors[0])[0]) for _ in range(4)
    ]
    # round-robin: the cold client is served within the first rounds,
    # never starved behind the hot client's backlog
    assert 100.0 in order[:2] and 101.0 in order[:4], order
    # strict priority: class 0 preempts the class-1 backlog
    assert ctrl.offer("vip", _frame(7.0, priority=0)).ok
    got = ctrl.next_ready()
    assert float(np.asarray(got.tensors[0])[0]) == 7.0


# ------------------------------------------- server-level NACK round trips
def test_server_nacks_over_per_client_budget():
    src = TensorQueryServerSrc(
        "ov-src1", port=0, id="ov1", **{"per-client-inflight": 2}
    )
    src.start()
    raw = PyTransport()
    try:
        raw.connect("127.0.0.1", src.bound_port)
        for i in range(3):
            raw.send(0, _req(float(i)))
        time.sleep(0.2)  # let the reader thread enqueue all three
        # one generate() drains the transport: 2 admitted, 1 NACKed
        frame = src.generate()
        assert frame is not None and frame.meta.get("client_id") == 1
        assert frame.meta.get("admit_t") is not None
        got = raw.recv(timeout=2)
        assert got is not None
        nack = decode_message(got[1])
        assert isinstance(nack, Nack)
        assert nack.reason == "client-backpressure"
        stats = src.admission_stats()
        assert stats["admitted"] == 2 and stats["rejected"] == 1
    finally:
        raw.close()
        src.stop()


def test_server_nacks_malformed_request():
    src = TensorQueryServerSrc(
        "ov-src2", port=0, id="ov2", **{"max-inflight": 4}
    )
    src.start()
    raw = PyTransport()
    try:
        raw.connect("127.0.0.1", src.bound_port)
        raw.send(0, b"\x02\x00")  # truncated edge header
        time.sleep(0.2)
        assert src.generate() is None
        got = raw.recv(timeout=2)
        nack = decode_message(got[1])
        assert isinstance(nack, Nack) and nack.reason == "malformed"
        assert src.admission_stats()["malformed"] == 1
    finally:
        raw.close()
        src.stop()


def test_connection_cap_rejects_with_nack():
    src = TensorQueryServerSrc(
        "ov-src3", port=0, id="ov3", **{"max-clients": 1}
    )
    src.start()
    c1 = PyTransport()
    c2 = PyTransport()
    try:
        c1.connect("127.0.0.1", src.bound_port)
        c1.send(0, _req())
        time.sleep(0.1)
        assert src.generate() is not None  # c1 is established
        c2.connect("127.0.0.1", src.bound_port)  # over the cap
        got = c2.recv(timeout=2)
        assert got is not None
        nack = decode_message(got[1])
        assert isinstance(nack, Nack) and nack.reason == "max-clients"
        # the over-cap socket is closed after the NACK
        got = c2.recv(timeout=2)
        assert got is not None and got[1] == b""
        assert src.admission_stats()["rejected_conns"] == 1
    finally:
        c1.close()
        c2.close()
        src.stop()


def test_client_honors_retry_after_nack():
    """Rate-limited server: the client retries on the NACK's hint and the
    request eventually completes — no timeout, no raise."""
    src = TensorQueryServerSrc(
        "ov-src4", port=0, id="ov4", **{"rate": 10.0, "rate-burst": 1}
    )
    sink = TensorQueryServerSink("ov-sink4", id="ov4")
    src.start()
    stop_evt = threading.Event()
    t = threading.Thread(
        target=_echo_server, args=(src, sink, stop_evt), daemon=True
    )
    t.start()
    client = TensorQueryClient(
        "ov-c4",
        **{"dest-port": src.bound_port, "timeout": 5, "retry-max": 6},
    )
    try:
        client.start()
        # burst=1: back-to-back requests exhaust the bucket, forcing at
        # least one NACK+retry on the later ones
        for i in range(3):
            reply = client.process(_frame(float(i)))
            np.testing.assert_allclose(
                np.asarray(reply.tensors[0]), np.full(4, 2.0 * i)
            )
        stats = src.admission_stats()
        assert stats["rejected_by_reason"].get("rate", 0) >= 1
    finally:
        stop_evt.set()
        client.stop()
        t.join(timeout=2)
        src.stop()


def test_client_rejected_after_retry_budget():
    """A server whose budget never frees: the client raises a typed
    rejection (terminal outcome), not a timeout."""
    src = TensorQueryServerSrc(
        "ov-src5", port=0, id="ov5", **{"max-inflight": 1}
    )
    src.start()
    # a parked request holds the only budget unit forever (no sink loop)
    raw = PyTransport()
    try:
        raw.connect("127.0.0.1", src.bound_port)
        raw.send(0, _req())
        time.sleep(0.2)
        assert src.generate() is not None
        client = TensorQueryClient(
            "ov-c5",
            **{"dest-port": src.bound_port, "timeout": 5, "retry-max": 1,
               "retry-backoff-ms": 5},
        )
        client.start()
        done = threading.Event()

        def poll():  # keep draining the transport so NACKs flow
            while not done.is_set():
                src.generate()

        poller = threading.Thread(target=poll, daemon=True)
        poller.start()
        with pytest.raises(ElementError, match="rejected.*overload"):
            client.process(_frame())
        done.set()
        client.stop()
        poller.join(timeout=5)
    finally:
        raw.close()
        src.stop()


def test_fault_policy_drop_releases_budget_and_nacks():
    """An admitted request dropped by on-error=drop must release its
    in-flight budget (no permanent pinning) and NACK the client with the
    terminal `failed` reason — never a silent client-side timeout."""
    from nnstreamer_tpu_torch.elements.chaos import TensorChaos
    from nnstreamer_tpu_torch.pipeline.graph import Pipeline

    src = TensorQueryServerSrc(
        "ov-src9", port=0, id="ov9",
        **{"max-inflight": 2, "per-client-inflight": 2},
    )
    bad = TensorChaos("bad9", **{"fail-every-n": 1, "on-error": "drop"})
    sink = TensorQueryServerSink("ov-sink9", id="ov9")
    p = Pipeline("dropall", device="cpu").chain(src, bad, sink)
    p.negotiate()
    ex = p.start()
    client = TensorQueryClient(
        "ov-c9", **{"dest-port": src.bound_port, "timeout": 5}
    )
    try:
        client.start()
        # more requests than the in-flight budget: without the release
        # on disposal the 3rd+ request would be NACKed 'overload'
        for _ in range(4):
            with pytest.raises(ElementError, match="failed the request"):
                client.process(_frame())
        stats = src.admission_stats()
        assert stats["inflight"] == 0, stats  # budget fully returned
        assert not stats["rejected_by_reason"], stats
    finally:
        client.stop()
        p.stop()
    assert not ex.errors, ex.errors


def test_legacy_server_survives_malformed_request():
    """Without admission bounds the serversrc must still NACK garbage
    instead of crashing the serving pipeline for every client."""
    src = TensorQueryServerSrc("ov-src10", port=0, id="ov10")
    src.start()
    raw = PyTransport()
    try:
        raw.connect("127.0.0.1", src.bound_port)
        raw.send(0, b"\x02\x00")  # truncated edge header
        time.sleep(0.2)
        assert src.generate() is None  # consumed, not raised
        nack = decode_message(raw.recv(timeout=2)[1])
        assert isinstance(nack, Nack) and nack.reason == "malformed"
        # the server keeps serving well-formed requests afterwards
        raw.send(0, _req(5.0))
        time.sleep(0.2)
        frame = src.generate()
        assert frame is not None
        assert float(np.asarray(frame.tensors[0])[0]) == 5.0
    finally:
        raw.close()
        src.stop()


def test_conn_nack_retry_recovers_after_slot_frees():
    """A connection-level max-clients NACK closes the socket; the client
    must reconnect for the retry (not resend into the dead socket) and
    succeed once the slot frees."""
    src = TensorQueryServerSrc(
        "ov-src12", port=0, id="ov12", **{"max-clients": 1}
    )
    sink = TensorQueryServerSink("ov-sink12", id="ov12")
    src.start()
    stop_evt = threading.Event()
    t = threading.Thread(
        target=_echo_server, args=(src, sink, stop_evt), daemon=True
    )
    t.start()
    holder = PyTransport()
    try:
        holder.connect("127.0.0.1", src.bound_port)
        holder.send(0, _req())
        holder.recv(timeout=5)  # established + served: holds the slot
        threading.Timer(0.3, holder.close).start()  # slot frees mid-retry
        client = TensorQueryClient(
            "ov-c12",
            **{"dest-port": src.bound_port, "timeout": 5, "retry-max": 10,
               "retry-backoff-ms": 30},
        )
        client.start()
        reply = client.process(_frame(21.0))
        np.testing.assert_allclose(
            np.asarray(reply.tensors[0]), np.full(4, 42.0)
        )
        client.stop()
    finally:
        stop_evt.set()
        holder.close()
        t.join(timeout=2)
        src.stop()


def test_route_dead_letter_reply_releases_budget_once():
    """on-error=route with the dead-letter pad replying through the
    serversink: the budget is released at disposal and NOT again at the
    reply — exact accounting, no cap drift, and the client still gets a
    terminal (error-meta) reply."""
    from nnstreamer_tpu_torch.pipeline.parse import parse_pipeline

    p = parse_pipeline(
        "tensor_query_serversrc name=qs port=0 id=ovr per-client-inflight=2"
        " ! tensor_chaos name=cx fail-every-n=1 on-error=route"
        " ! tensor_query_serversink id=ovr"
        "  cx.src_1 ! tensor_query_serversink id=ovr", device="cpu"
    )
    ex = p.start()
    qs = p["qs"]
    client = TensorQueryClient(
        "ov-c13", **{"dest-port": qs.bound_port, "timeout": 5}
    )
    try:
        client.start()
        for i in range(4):
            reply = client.process(_frame(float(i)))
            assert reply.meta.get("error") is True
            assert reply.meta.get("error_element") == "cx"
        stats = qs.admission_stats()
        assert stats["admitted"] == 4
        assert stats["released"] == 4  # exactly once per request
        assert stats["inflight"] == 0
    finally:
        client.stop()
        p.stop()
    assert not ex.errors, ex.errors


def test_admission_idle_client_eviction():
    """Broker transports never emit disconnects: fully-idle clients are
    evicted when the max-clients cap is hit, instead of pinning slots
    forever."""
    ctrl = AdmissionController(
        AdmissionConfig(max_clients=2, idle_evict_s=30.0)
    )
    t0 = 1000.0
    assert ctrl.offer("a", _frame(), now=t0).ok
    assert ctrl.offer("b", _frame(), now=t0).ok
    # drain and release both: fully idle, but within the horizon
    for _ in range(2):
        ctrl.next_ready()
    ctrl.release("a")
    ctrl.release("b")
    d = ctrl.offer("c", _frame(), now=t0 + 5.0)
    assert not d.ok and d.reason == "max-clients"
    # past the idle horizon both slots reclaim
    assert ctrl.offer("c", _frame(), now=t0 + 31.0).ok


# --------------------------------------------------- deadline shedding
def test_deadline_shed_in_pipeline_accounting(monkeypatch):
    """Expired frames are dropped at dequeue BEFORE the fused program
    runs; accounting (totals + the sanitizer's offered == delivered +
    dropped + routed latch) stays exact under shedding."""
    monkeypatch.setenv("NNS_TPU_SANITIZE", "1")
    from nnstreamer_tpu_torch.elements.filter import TensorFilter
    from nnstreamer_tpu_torch.elements.sink import TensorSink
    from nnstreamer_tpu_torch.elements.sources import AppSrc
    from nnstreamer_tpu_torch.pipeline.graph import Pipeline

    now = time.monotonic()
    frames = []
    for i in range(10):
        if i % 2:
            meta = {"deadline_ms": 60000.0, "admit_t": now}
        else:  # already expired at admission
            meta = {"deadline_ms": 50.0, "admit_t": now - 1.0}
        frames.append(Frame((np.full(4, float(i), np.float32),), meta=meta))
    src = AppSrc("a0", iterable=frames, spec=frames[0].spec())
    filt = TensorFilter(
        "shed-filt", framework="passthrough", input="4", inputtype="float32"
    )
    sink = TensorSink("out")
    p = Pipeline("shed", device="cpu").chain(src, filt, sink)
    p.negotiate()
    ex = p.start()
    assert ex.wait(timeout=30)
    p.stop()
    assert not ex.errors, ex.errors
    assert len(sink.frames) == 5  # only unexpired frames survive
    totals = ex.totals()
    assert totals["dropped"].get("deadline-shed") == 5
    assert totals["balance"] == 0
    assert ex.stats()["shed-filt"]["deadline_shed"] == 5
    assert not ex.sanitizer.codes  # NNS-S002 did NOT fire under shedding
    assert not ex.leaked_threads


def test_deadline_shed_nacks_edge_client():
    """A queued request whose SLO expires behind a slow frame is shed and
    the client receives a terminal `deadline` NACK — never a silent
    timeout."""
    from nnstreamer_tpu_torch.elements.chaos import TensorChaos
    from nnstreamer_tpu_torch.pipeline.graph import Pipeline

    src = TensorQueryServerSrc(
        "ov-src6", port=0, id="ov6", **{"max-inflight": 8}
    )
    slow = TensorChaos("slow6", **{"delay-ms": 300.0})
    sink = TensorQueryServerSink("ov-sink6", id="ov6")
    p = Pipeline("dl", device="cpu").chain(src, slow, sink)
    p.negotiate()
    ex = p.start()
    c1 = TensorQueryClient(
        "ov-c6a", **{"dest-port": src.bound_port, "timeout": 10}
    )
    c2 = TensorQueryClient(
        "ov-c6b",
        **{"dest-port": src.bound_port, "timeout": 10, "deadline-ms": 80},
    )
    try:
        c1.start()
        c2.start()
        # c1's request occupies the slow element for ~300 ms; c2's
        # 80 ms-deadline request queues behind it and must be shed
        t1 = threading.Thread(
            target=lambda: c1.process(_frame(1.0)), daemon=True
        )
        t1.start()
        time.sleep(0.1)
        with pytest.raises(ElementError, match="shed.*deadline"):
            c2.process(_frame(2.0))
        t1.join(timeout=10)
        assert not t1.is_alive()
    finally:
        c1.stop()
        c2.stop()
        p.stop()
    assert sum(
        s.get("deadline_shed", 0) for s in ex.stats().values()
    ) == 1
    assert not ex.errors, ex.errors


# ------------------------------------------------------ chaos net faults
def test_chaos_drop_and_truncate_all_requests_complete():
    src = TensorQueryServerSrc(
        "ov-src7", port=0, id="ov7", **{"max-inflight": 8}
    )
    sink = TensorQueryServerSink("ov-sink7", id="ov7")
    src.start()
    stop_evt = threading.Event()
    t = threading.Thread(
        target=_echo_server, args=(src, sink, stop_evt), daemon=True
    )
    t.start()
    client = TensorQueryClient(
        "ov-c7",
        **{"dest-port": src.bound_port, "timeout": 5, "retry-max": 4,
           "retry-backoff-ms": 5, "chaos-drop-every-n": 3,
           "chaos-truncate-every-n": 4},
    )
    try:
        client.start()
        for i in range(10):
            reply = client.process(_frame(float(i)))
            np.testing.assert_allclose(
                np.asarray(reply.tensors[0]), np.full(4, 2.0 * i)
            )
        # the truncation schedule fired and produced structured NACKs
        assert src.admission_stats().get("malformed", 0) >= 1
    finally:
        stop_evt.set()
        client.stop()
        t.join(timeout=2)
        src.stop()


# --------------------------------------------------------- shm transport
def _shm_available() -> bool:
    from nnstreamer_tpu_torch.edge._build import build_native

    return build_native("nns_shm.cpp") is not None


@pytest.mark.skipif(not _shm_available(), reason="no C++ toolchain")
def test_shm_query_transport_parity_with_tcp():
    """connect-type=SHM serves the same request/reply semantics as TCP
    (values, pts, frame_id meta), minus the sockets."""
    results = {}
    for ct in ("TCP", "SHM"):
        src = TensorQueryServerSrc(
            f"ov-src8{ct}", port=0, id=f"ov8{ct}",
            **{"connect-type": ct, "max-inflight": 4},
        )
        sink = TensorQueryServerSink(f"ov-sink8{ct}", id=f"ov8{ct}")
        src.start()
        stop_evt = threading.Event()
        t = threading.Thread(
            target=_echo_server, args=(src, sink, stop_evt), daemon=True
        )
        t.start()
        client = TensorQueryClient(
            f"ov-c8{ct}",
            **{"dest-port": src.bound_port, "timeout": 5,
               "connect-type": ct},
        )
        try:
            client.start()
            got = []
            for i in range(4):
                r = client.process(
                    Frame((np.full(4, float(i), np.float32),), pts=i * 10)
                )
                got.append((
                    float(np.asarray(r.tensors[0])[0]), r.pts,
                    r.meta.get("frame_id") is not None,
                ))
            results[ct] = got
        finally:
            stop_evt.set()
            client.stop()
            t.join(timeout=2)
            src.stop()
    assert results["SHM"] == results["TCP"]


# ----------------------------------------------------------------- lint
# ------------------------------------------------------------- the soak
@pytest.mark.slow
def test_overload_soak_two_x_capacity_with_faults(monkeypatch):
    """The standing chaos soak (docs/edge-serving.md): N concurrent
    clients at ~2× the admitted capacity against a bounded server with
    backend latency spikes, injected connection drops, and a slow-loris
    connection. Every request reaches a terminal outcome (completed,
    NACKed, or shed — no silent timeouts), accepted-request p99 stays
    bounded, and the run ends with zero leaked threads and zero
    stall-watchdog firings."""
    import socket as socket_mod

    monkeypatch.setenv("NNS_TPU_SANITIZE", "1")
    from nnstreamer_tpu_torch.elements.filter import TensorFilter
    from nnstreamer_tpu_torch.pipeline.executor import Executor
    from nnstreamer_tpu_torch.pipeline.graph import Pipeline

    src = TensorQueryServerSrc(
        "soak-src", port=0, id="soak",
        **{"max-clients": 12, "max-inflight": 8, "per-client-inflight": 2,
           "retry-after-ms": 20},
    )
    filt = TensorFilter(
        framework="faulty", input="4", inputtype="float32",
        custom="latency_spike_ms:40,spike_every_n:7",
    )
    sink = TensorQueryServerSink("soak-sink", id="soak")
    p = Pipeline("soak", device="cpu").chain(src, filt, sink)
    p.negotiate()
    plan = p.compile_plan()
    ex = Executor(plan)
    # watchdog armed well above the worst single invoke (40 ms spike)
    ex.watchdog_timeout_ms = 5000.0
    ex.start()

    n_clients, n_requests = 6, 25
    outcomes = []          # (kind, latency_s)
    outcomes_mu = threading.Lock()

    def run_client(idx: int) -> None:
        props = {
            "dest-port": src.bound_port, "timeout": 8, "retry-max": 8,
            "retry-backoff-ms": 10, "deadline-ms": 4000,
        }
        if idx % 3 == 0:  # a third of the fleet drops connections
            props["chaos-drop-every-n"] = 5
        client = TensorQueryClient(f"soak-c{idx}", **props)
        client.start()
        try:
            for i in range(n_requests):
                t0 = time.perf_counter()
                try:
                    reply = client.process(_frame(float(i)))
                    assert reply is not None
                    kind = "completed"
                except ElementError as exc:
                    msg = str(exc)
                    if "deadline" in msg:
                        kind = "shed"
                    elif "rejected" in msg:
                        kind = "nacked"
                    else:
                        kind = f"error:{msg[:60]}"
                with outcomes_mu:
                    outcomes.append((kind, time.perf_counter() - t0))
        finally:
            client.stop()

    # slow-loris: connects, sends half a length prefix, stalls. It must
    # neither crash the acceptor nor consume admission budget.
    loris = socket_mod.create_connection(
        ("127.0.0.1", src.bound_port), timeout=5
    )
    loris.sendall(b"\xff\xff\xff")

    threads = [
        threading.Thread(target=run_client, args=(i,), daemon=True)
        for i in range(n_clients)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads), "client thread hung"
    loris.close()
    ex.stop()

    # every request reached a terminal outcome, none of them a timeout
    # or an unexpected transport error
    assert len(outcomes) == n_clients * n_requests
    kinds = {}
    for kind, _ in outcomes:
        kinds[kind] = kinds.get(kind, 0) + 1
    unexpected = {
        k: v for k, v in kinds.items()
        if k not in ("completed", "shed", "nacked")
    }
    assert not unexpected, (unexpected, kinds)
    assert kinds.get("completed", 0) >= n_clients * n_requests // 2, kinds

    # accepted-request p99 stays bounded (spikes are 40 ms; generous
    # ceiling absorbs scheduler noise, not queueing collapse)
    lats = sorted(lat for kind, lat in outcomes if kind == "completed")
    p99 = lats[min(len(lats) - 1, int(0.99 * len(lats)))]
    assert p99 < 3.0, f"p99 {p99:.3f}s — latency collapsed under load"

    assert not ex.stalled, "stall watchdog fired during the soak"
    assert not ex.errors, ex.errors
    assert not ex.leaked_threads, ex.leaked_threads
    # the server actually exercised its admission machinery
    stats = src.admission_stats()
    assert stats["admitted"] >= kinds.get("completed", 0)
    # offered == delivered + dropped + routed holds per interior node
    # under shedding (sources have no input channel, so their offered
    # count is structurally 0; forced stop leaves bounded in-flight,
    # never a negative balance)
    checked = 0
    for name, row in ex.stats().items():
        if not row.get("san_offered"):
            continue
        checked += 1
        balance = (
            row["san_offered"] - row["san_delivered"]
            - row["san_routed"] - row.get("deadline_shed", 0)
            - row.get("error_dropped", 0)
        )
        assert balance >= 0, (name, row)
    assert checked >= 2  # the filter node and the serversink saw frames
