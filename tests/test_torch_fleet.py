"""The cases of ``tests/test_fleet.py``
(less the two NNS-W119/W126 lint cases: the lint is not ported) run through the port's edge
layer (``nnstreamer_tpu_torch.edge``) on the CPU, with ephemeral ports and
short timeouts; ``tests/test_torch_edge_interop.py`` holds it against the
reference. The reference's notes follow.

Edge fleet resilience (docs/edge-serving.md "Running a fleet").

Tier-1 block (fast, deterministic — fake clocks where timing matters):
the FleetEndpoints selector (rotation, consecutive-failure ejection,
backoff re-probe, draining), frame_id reply dedup, hedging determinism,
client failover against live endpoint death, graceful drain (NACK path,
drain flush, rolling restart with zero lost requests), the re-resolve/
``unresolvable`` reconnect bugfix, the NNS-W119 lint both ways, and the
shm transport coverage ROADMAP calls unloved (ring wraparound through
the query server pair, reconnect after server restart).

The standing fleet chaos soak — 3 servers × 6 clients at ~2× admission
capacity under ChaosTransport faults while the harness kills one
server, drains another, and restarts both — is marked ``slow``.
"""

import os
import random
import threading
import time

import numpy as np
import pytest

from nnstreamer_tpu_torch.edge.fleet import (
    FleetEndpoints,
    HedgeTimer,
    ReplyDeduper,
    RttWindow,
    parse_hosts,
)
from nnstreamer_tpu_torch.edge.query import (
    TensorQueryClient,
    TensorQueryServerSink,
    TensorQueryServerSrc,
    request_drain,
)
from nnstreamer_tpu_torch.edge.serialize import (
    Ctrl,
    Nack,
    decode_message,
    encode_ctrl,
    encode_message,
)
from nnstreamer_tpu_torch.edge.transport import PyTransport, UnresolvableError
from nnstreamer_tpu_torch.elements.base import ElementError
from nnstreamer_tpu_torch.tensors.frame import Frame


def _frame(val: float = 0.0, **meta) -> Frame:
    return Frame((np.full(4, val, np.float32),), meta=meta)


class FakeClock:
    def __init__(self, t: float = 1000.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class _EchoServer:
    """serversrc/serversink pair with a background echo loop (×2)."""

    def __init__(self, name: str, srv_id: str, port: int = 0, **props):
        props.setdefault("max-inflight", 8)
        self.src = TensorQueryServerSrc(name, port=port, id=srv_id, **props)
        self.sink = TensorQueryServerSink(f"{name}k", id=srv_id)
        self.src.start()
        self.port = self.src.bound_port
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._loop, daemon=True)
        self._t.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            f = self.src.generate()
            if f is None:
                continue
            self.sink.render(
                f.with_tensors([np.asarray(t) * 2.0 for t in f.tensors])
            )

    def stop(self) -> None:
        self._stop.set()
        self._t.join(timeout=2)
        self.src.stop()


# ------------------------------------------------------------- selector units
def test_parse_hosts():
    assert parse_hosts("a:1,b:2") == [("a", 1), ("b", 2)]
    assert parse_hosts(" h:5001 , ") == [("h", 5001)]
    for bad in ("", "noport", "h:", "h:0", "h:x", "a:1,a:1"):
        with pytest.raises(ValueError):
            parse_hosts(bad)


def test_selector_round_robin_and_ejection():
    clk = FakeClock()
    f = FleetEndpoints(
        [("a", 1), ("b", 2), ("c", 3)], eject_after=2,
        probe_backoff_ms=100.0, clock=clk,
    )
    assert [e.addr for e in f.plan()][:1] == ["a:1"]
    assert [e.addr for e in f.plan()][:1] == ["b:2"]  # rotation advanced
    a = f.endpoints[0]
    f.record_fail(a)
    assert a.healthy  # one failure is not ejection
    f.record_fail(a)
    assert not a.healthy and a.state() == "ejected"
    # benched: not in any plan until the backoff elapses
    for _ in range(4):
        assert a not in f.plan()
    clk.advance(0.2)  # > 100 ms jittered backoff
    assert f.plan()[0] is a  # prepended as the re-probe
    f.record_ok(a)
    assert a.healthy and a.consec_fails == 0


def test_selector_backoff_doubles_and_all_benched():
    clk = FakeClock()
    f = FleetEndpoints(
        [("a", 1)], eject_after=1, probe_backoff_ms=100.0, clock=clk,
    )
    a = f.endpoints[0]
    f.record_fail(a)
    first = a.retry_at - clk.t
    assert 0.05 <= first <= 0.1  # jitter in [0.5, 1.0]x of 100 ms
    assert f.plan() == []  # nothing healthy, nothing due
    assert f.next_retry_in() > 0
    clk.advance(first + 0.001)
    assert f.plan() == [a]  # due: every benched endpoint gets a shot
    f.record_fail(a)  # probe failed: backoff doubled
    second = a.retry_at - clk.t
    assert second > first * 1.2


def test_selector_draining_benches_for_hint():
    clk = FakeClock()
    f = FleetEndpoints([("a", 1), ("b", 2)], clock=clk)
    a, b = f.endpoints
    f.mark_draining(a, 500.0)
    assert a.state() == "draining"
    assert all(p is b for p in f.plan())  # only b while a drains
    clk.advance(0.6)
    assert a in f.plan()  # hint elapsed: re-probe allowed
    f.record_ok(a)
    assert a.state() == "healthy"


def test_reply_deduper_bounded():
    d = ReplyDeduper(capacity=16)
    assert d.claim("x") and not d.claim("x")
    assert d.duplicates == 1
    for i in range(40):
        d.claim(i)
    assert not d.seen("x")  # evicted by the FIFO bound
    assert d.seen(39)


def test_hedge_timer_deterministic():
    clk = FakeClock()
    h = HedgeTimer(80.0, clock=clk)
    h.arm()
    assert not h.due()
    clk.advance(0.079)
    assert not h.due()
    clk.advance(0.002)
    assert h.due()
    h.fire()
    assert not h.due()  # one hedge per request
    # off and adaptive modes
    off = HedgeTimer(0.0, clock=clk)
    off.arm()
    clk.advance(10.0)
    assert not off.due()
    rtts = RttWindow()
    auto = HedgeTimer(-1.0, clock=clk, rtts=rtts, adaptive_floor_ms=50.0)
    assert auto.threshold_s() == 0.05  # floor until enough samples
    for _ in range(20):
        rtts.record(0.2)
    assert auto.threshold_s() == pytest.approx(0.2)


# ------------------------------------------------------- client fleet paths
def test_fleet_round_robin_and_failover_on_death():
    a = _EchoServer("fl-a", "fl1a")
    b = _EchoServer("fl-b", "fl1b")
    client = TensorQueryClient(
        "fl-c1",
        **{"hosts": f"127.0.0.1:{a.port},127.0.0.1:{b.port}",
           "timeout": 3, "retry-max": 4, "retry-backoff-ms": 5},
    )
    try:
        client.start()
        for i in range(4):
            r = client.process(_frame(float(i)))
            assert float(np.asarray(r.tensors[0])[0]) == 2.0 * i
        st = client.fleet_stats()
        assert all(e["served"] >= 1 for e in st["endpoints"].values())
        a.stop()  # endpoint death mid-fleet
        for i in range(8):  # enough rotations for 3 consecutive fails
            r = client.process(_frame(float(i)))
            assert float(np.asarray(r.tensors[0])[0]) == 2.0 * i
        st = client.fleet_stats()
        assert st["failovers"] >= 1
        assert st["duplicate_replies"] == 0
        states = {k: v["state"] for k, v in st["endpoints"].items()}
        assert states[f"127.0.0.1:{a.port}"] == "ejected"
    finally:
        client.stop()
        b.stop()


def test_fleet_reprobe_readmits_restarted_server():
    a = _EchoServer("fl2-a", "fl2a")
    b = _EchoServer("fl2-b", "fl2b")
    port_a = a.port
    client = TensorQueryClient(
        "fl-c2",
        **{"hosts": f"127.0.0.1:{port_a},127.0.0.1:{b.port}",
           "timeout": 3, "retry-max": 4, "retry-backoff-ms": 5},
    )
    a2 = None
    try:
        client.start()
        client.process(_frame(1.0))
        a.stop()
        for _ in range(4):  # ejects a
            client.process(_frame(1.0))
        a2 = _EchoServer("fl2-a2", "fl2a2", port=port_a)  # rolling restart
        deadline = time.monotonic() + 3
        while time.monotonic() < deadline:
            client.process(_frame(1.0))
            st = client.fleet_stats()["endpoints"][f"127.0.0.1:{port_a}"]
            if st["state"] == "healthy":
                break
            time.sleep(0.02)
        assert st["state"] == "healthy", st  # re-probe re-admitted it
    finally:
        client.stop()
        b.stop()
        if a2 is not None:
            a2.stop()


def test_hedged_request_first_reply_wins_and_dedup():
    """Server A strags (replies after 250 ms), B echoes instantly: the
    hedge wins on B, and A's late duplicate reply — arriving during a
    LATER request's wait — is dropped by the frame_id dedup, never
    delivered as the wrong answer."""
    def slow_server(tr, delay):
        def loop():
            while True:
                got = tr.recv(timeout=0.1)
                if got is None:
                    continue
                cid, payload = got
                if not payload:
                    return
                f = decode_message(payload)
                if not isinstance(f, Frame):
                    continue

                def reply(cid=cid, f=f):
                    time.sleep(delay)
                    try:
                        tr.send(cid, encode_message(f.with_tensors(
                            [np.asarray(t) * 2.0 for t in f.tensors]
                        )))
                    except Exception:  # noqa: BLE001 — test teardown
                        pass

                threading.Thread(target=reply, daemon=True).start()
        threading.Thread(target=loop, daemon=True).start()

    A = PyTransport()
    B = PyTransport()
    pa, pb = A.listen("127.0.0.1", 0), B.listen("127.0.0.1", 0)
    slow_server(A, 0.25)
    slow_server(B, 0.0)
    client = TensorQueryClient(
        "fl-c3",
        **{"hosts": f"127.0.0.1:{pa},127.0.0.1:{pb}",
           "timeout": 3, "hedge-after-ms": 40},
    )
    try:
        client.start()
        vals = []
        for i in range(3):
            r = client.process(_frame(float(i + 1)))
            vals.append(float(np.asarray(r.tensors[0])[0]))
        time.sleep(0.35)  # let every late A reply land
        client.process(_frame(9.0))
        assert vals == [2.0, 4.0, 6.0]  # every reply matched ITS request
        st = client.fleet_stats()
        assert st["hedges"] >= 1, st
        assert st["duplicate_replies"] >= 1, st
    finally:
        client.stop()
        A.close()
        B.close()


# ------------------------------------------------------------- graceful drain
def test_drain_nacks_new_finishes_inflight():
    """drain(): already-admitted requests complete (zero loss), new
    submits NACK `draining`, the readiness flag flips, and drained()
    latches once the reply path catches up."""
    src = TensorQueryServerSrc(
        "dr-src", port=0, id="dr1", **{"max-inflight": 4}
    )
    sink = TensorQueryServerSink("dr-sink", id="dr1")
    src.start()
    raw = PyTransport()
    try:
        assert src.state == "ready"
        assert src.admission_stats()["readiness"] == "ready"
        raw.connect("127.0.0.1", src.bound_port)
        raw.send(0, encode_message(_frame(3.0, frame_id="req-1")))
        time.sleep(0.15)
        admitted = src.generate()  # in flight now
        assert admitted is not None
        src.drain()
        assert src.state == "draining"
        assert not src.drained()  # one admitted request still in flight
        # a NEW submit is refused with the draining reason + hint
        raw.send(0, encode_message(_frame(4.0, frame_id="req-2")))
        time.sleep(0.15)
        assert src.generate() is None
        nack = decode_message(raw.recv(timeout=2)[1])
        assert isinstance(nack, Nack) and nack.reason == "draining"
        assert nack.retry_after_ms > 0 and nack.frame_id == "req-2"
        # the in-flight request still completes: zero accepted loss
        sink.render(admitted)
        got = decode_message(raw.recv(timeout=2)[1])
        assert isinstance(got, Frame)
        assert got.meta.get("frame_id") == "req-1"
        assert src.drained()
        stats = src.admission_stats()
        assert stats["readiness"] == "draining"
        assert stats["drain_nacked"] == 1
        assert stats["inflight"] == 0
    finally:
        raw.close()
        src.stop()
    assert src.state == "dead"


def test_drain_flush_queued_releases_budget():
    """drain(flush_queued=True): the queued-but-unserved admitted
    backlog is NACKed `draining` and its budget released — the ledger
    (admitted == released + in-flight) stays exact."""
    src = TensorQueryServerSrc(
        "dr2-src", port=0, id="dr2", **{"max-inflight": 8}
    )
    sink = TensorQueryServerSink("dr2-sink", id="dr2")
    src.start()
    raw = PyTransport()
    try:
        raw.connect("127.0.0.1", src.bound_port)
        for i in range(3):
            raw.send(0, encode_message(_frame(float(i), frame_id=f"q{i}")))
        time.sleep(0.2)
        executing = src.generate()  # admits all 3, serves ONE
        assert executing is not None
        src.drain(flush_queued=True)
        reasons = []
        for _ in range(2):  # the two queued requests re-route NOW
            msg = decode_message(raw.recv(timeout=2)[1])
            assert isinstance(msg, Nack)
            reasons.append(msg.reason)
        assert reasons == ["draining", "draining"]
        stats = src.admission_stats()
        assert stats["inflight"] == 1  # only the executing request
        assert not src.drained()
        sink.render(executing)
        assert src.drained()
    finally:
        raw.close()
        src.stop()


def test_drain_control_message_over_the_wire():
    """request_drain() flips a live server to draining without touching
    the process — the rolling-restart trigger an operator (or the soak
    harness) uses."""
    src = TensorQueryServerSrc("dr3-src", port=0, id="dr3")
    src.start()
    try:
        assert isinstance(decode_message(encode_ctrl("drain")), Ctrl)
        request_drain("127.0.0.1", src.bound_port)
        deadline = time.monotonic() + 2
        while src.state != "draining" and time.monotonic() < deadline:
            src.generate()
            time.sleep(0.01)
        assert src.state == "draining"
        # legacy (no admission bounds) path still NACKs new submits
        raw = PyTransport()
        try:
            raw.connect("127.0.0.1", src.bound_port)
            raw.send(0, encode_message(_frame(1.0)))
            got = None
            deadline = time.monotonic() + 3
            while got is None and time.monotonic() < deadline:
                # the queue also carries the drain connection's close
                # event; keep pumping until the NACK lands
                assert src.generate() is None
                got = raw.recv(timeout=0.1)
            assert got is not None
            nack = decode_message(got[1])
            assert isinstance(nack, Nack) and nack.reason == "draining"
        finally:
            raw.close()
    finally:
        src.stop()


def test_rolling_restart_loses_zero_requests():
    """The acceptance pin: drain → restart a fleet server under a live
    request stream; every request completes (failover rides the
    draining NACKs), none lost, and the restarted server rejoins."""
    a = _EchoServer("rr-a", "rr1a")
    b = _EchoServer("rr-b", "rr1b")
    port_a = a.port
    client = TensorQueryClient(
        "rr-c",
        **{"hosts": f"127.0.0.1:{port_a},127.0.0.1:{b.port}",
           "timeout": 3, "retry-max": 6, "retry-backoff-ms": 5},
    )
    a2 = None
    try:
        client.start()
        results = []
        for i in range(4):
            results.append(client.process(_frame(float(i))))
        a.src.drain()          # rolling restart step 1: drain
        deadline = time.monotonic() + 3
        while not a.src.drained() and time.monotonic() < deadline:
            time.sleep(0.01)   # the last reply's budget release races
        assert a.src.drained()
        for i in range(4, 8):  # new submits re-route via draining NACKs
            results.append(client.process(_frame(float(i))))
        a.stop()               # step 2: stop
        a2 = _EchoServer("rr-a2", "rr2a", port=port_a)  # step 3: restart
        for i in range(8, 12):
            results.append(client.process(_frame(float(i))))
        # ZERO lost: every request got its own reply, in order
        assert [float(np.asarray(r.tensors[0])[0]) for r in results] == [
            2.0 * i for i in range(12)
        ]
        assert client.fleet_stats()["duplicate_replies"] == 0
    finally:
        client.stop()
        b.stop()
        if a2 is not None:
            a2.stop()


# ------------------------------------------- unresolvable reconnect bugfix
def test_unresolvable_host_fails_fast_with_distinct_reason():
    """A gone hostname must NOT burn the whole retry-max budget: the
    failure is terminal with a distinct `unresolvable` reason on the
    first attempt."""
    client = TensorQueryClient(
        "ur-c",
        **{"dest-host": "nns-no-such-host.invalid", "dest-port": 9,
           "timeout": 1, "retry-max": 50, "retry-backoff-ms": 200},
    )
    t0 = time.monotonic()
    with pytest.raises(ElementError, match="unresolvable"):
        client.start()
    # 50 retries at 200 ms backoff would take >5 s; fail-fast must not
    assert time.monotonic() - t0 < 3.0


def test_fleet_marks_unresolvable_endpoint_and_serves_on():
    b = _EchoServer("ur-b", "ur1b")
    client = TensorQueryClient(
        "ur-c2",
        **{"hosts": f"nns-no-such-host.invalid:9,127.0.0.1:{b.port}",
           "timeout": 3, "retry-max": 2, "retry-backoff-ms": 5},
    )
    try:
        client.start()
        r = client.process(_frame(5.0))
        assert float(np.asarray(r.tensors[0])[0]) == 10.0
        eps = client.fleet_stats()["endpoints"]
        assert eps["nns-no-such-host.invalid:9"]["unresolvable"]
        assert eps["nns-no-such-host.invalid:9"]["state"] == "ejected"
    finally:
        client.stop()
        b.stop()


def test_resolve_target_unresolvable():
    from nnstreamer_tpu_torch.edge.transport import resolve_target

    assert resolve_target("127.0.0.1", 80) == ("127.0.0.1", 80)
    with pytest.raises(UnresolvableError):
        resolve_target("nns-no-such-host.invalid", 80)


# ----------------------------------------------------------------- the lint
# -------------------------------------------------------------- nns-top
def test_nns_top_fleet_view_renders_endpoints_and_readiness():
    """`nns-top --fleet` renders the client's per-endpoint health rows
    (from the executor's `fleet_*` stats keys) plus each server's drain
    readiness footer."""
    from nnstreamer_tpu_torch.obs.nns_top import render_fleet

    snap = {"nodes": {
        "edge-c0": {
            "fleet_endpoints": {
                "10.0.0.1:5001": {
                    "state": "healthy", "score": 1.0, "inflight": 1,
                    "served": 340, "fails": 2, "failovers": 2,
                },
                "10.0.0.2:5001": {
                    "state": "draining", "score": 0.8, "inflight": 0,
                    "served": 120, "fails": 0, "failovers": 1,
                    "unresolvable": False,
                },
            },
            "fleet_healthy": 1, "fleet_failovers": 3,
            "fleet_hedges": 5, "fleet_duplicate_replies": 1,
        },
        "qsrc": {"adm_readiness": "draining", "adm_drain_nacked": 4},
    }}
    out = render_fleet(snap)
    assert "10.0.0.1:5001" in out and "healthy" in out
    assert "draining" in out and "failovers=3" in out
    assert "hedges=5" in out and "dup-replies=1" in out
    assert "server qsrc: draining drain-nacked=4" in out
    empty = render_fleet({"nodes": {}})
    assert "no fleet client" in empty


def test_executor_stats_carry_fleet_rows():
    """A fleet client inside a real pipeline surfaces its endpoint
    health through Executor.stats() (`fleet_*` keys — what the obs
    endpoint and nns-top --fleet read)."""
    from nnstreamer_tpu_torch.pipeline.parse import parse_pipeline

    b = _EchoServer("ex-b", "exfl1")
    p = parse_pipeline(
        "tensorsrc name=s dimensions=4 types=float32 num-frames=3 ! "
        f"tensor_query_client name=qc hosts=127.0.0.1:{b.port} "
        "timeout=5 ! tensor_sink name=out", device="cpu"
    )
    try:
        ex = p.run(timeout=30)
        assert not ex.errors, ex.errors
        row = ex.stats()["qc"]
        eps = row["fleet_endpoints"]
        assert eps[f"127.0.0.1:{b.port}"]["served"] == 3
        assert row["fleet_healthy"] == 1
        assert len(p["out"].frames) == 3
    finally:
        b.stop()


# ------------------------------------------------- shm transport (unloved)
def _shm_available() -> bool:
    try:
        from nnstreamer_tpu_torch.edge import shm as _shm

        _shm._get_lib()
        return True
    except Exception:  # noqa: BLE001 — toolchain/sanitizer build absent
        return False


def _shm_port() -> int:
    """A server's segment pair (``port`` and ``port + 1``) that no segment
    holds yet: drawn at random, never fixed, so tests in parallel workers
    or in another checkout do not meet on one name."""
    from nnstreamer_tpu_torch.edge.shm import segment_name

    rng = random.SystemRandom()
    while True:
        port = rng.randrange(20000, 60000)
        if not any(os.path.exists(f"/dev/shm{segment_name(port + i)}") for i in (0, 1)):
            return port


@pytest.mark.skipif(not _shm_available(), reason="no C++ toolchain")
def test_shm_query_pair_ring_wraparound():
    """Many messages much larger than capacity/N through the SHM query
    server pair force repeated ring wrap markers on BOTH rings; order
    and content must survive."""
    from nnstreamer_tpu_torch.edge.query_transports import (
        ShmClientTransport,
        ShmServerTransport,
    )

    srv = ShmServerTransport(capacity=8 * 1024)
    port = srv.listen("", _shm_port())
    cli = ShmClientTransport()
    cli.connect("", port)
    msgs = [os.urandom(700) for _ in range(64)]
    errs = []

    def echo():
        try:
            for _ in range(len(msgs)):
                got = srv.recv(timeout=5)
                srv.send(got[0], got[1][::-1])
        except Exception as exc:  # noqa: BLE001 — surfaced below
            errs.append(exc)

    t = threading.Thread(target=echo, daemon=True)
    t.start()
    try:
        for m in msgs:
            cli.send(0, m)
            got = cli.recv(timeout=5)
            assert got is not None and got[1] == m[::-1]
        t.join(timeout=5)
        assert not errs
    finally:
        cli.close()
        srv.close()


@pytest.mark.skipif(not _shm_available(), reason="no C++ toolchain")
def test_shm_server_restart_client_reconnects():
    """ShmServerTransport restart on the same port: the old segments are
    torn down (marked closed + unlinked), a new server claims the names,
    and a reconnecting client resumes request/reply."""
    from nnstreamer_tpu_torch.edge.query_transports import (
        ShmClientTransport,
        ShmServerTransport,
    )

    port = _shm_port()
    srv = ShmServerTransport(capacity=64 * 1024)
    assert srv.listen("", port) == port
    cli = ShmClientTransport()
    cli.connect("", port)
    cli.send(0, b"gen-1")
    got = srv.recv(timeout=5)
    assert got is not None and got == (1, b"gen-1")
    srv.send(1, b"ack-1")
    assert cli.recv(timeout=5)[1] == b"ack-1"
    srv.close()
    # the client sees EOS on the reply ring once the server is gone
    assert cli.recv(timeout=5)[1] == b""
    cli.close()
    # restart: same port must be claimable again (no stale-name wedge)
    srv2 = ShmServerTransport(capacity=64 * 1024)
    assert srv2.listen("", port) == port
    cli2 = ShmClientTransport()
    cli2.connect("", port)
    try:
        cli2.send(0, b"gen-2")
        got = srv2.recv(timeout=5)
        assert got is not None and got[1] == b"gen-2"
        srv2.send(1, b"ack-2")
        assert cli2.recv(timeout=5)[1] == b"ack-2"
    finally:
        cli2.close()
        srv2.close()


# ------------------------------------------------------------- standing soak
@pytest.mark.slow
def test_fleet_chaos_soak_kill_drain_restart(monkeypatch):
    """The standing fleet soak (docs/edge-serving.md "Running a fleet"):
    3 admission-bounded echo servers × 6 fleet clients at ~2× aggregate
    admission capacity, a third of the fleet injecting ChaosTransport
    drops and truncations, while the harness HARD-KILLS one server,
    gracefully DRAINS another, and restarts both. Invariants: every
    request reaches a terminal outcome (reply or terminal NACK — no
    silent timeouts), per-node ``offered == delivered + dropped +
    routed`` latches green under the sanitizer, failover p99 stays
    bounded, and no server leaks threads."""
    monkeypatch.setenv("NNS_TPU_SANITIZE", "1")
    from nnstreamer_tpu_torch.pipeline.parse import parse_pipeline

    def start_server(tag: str, port: int = 0):
        p = parse_pipeline(
            f"tensor_query_serversrc name={tag}-src port={port} id={tag} "
            "max-inflight=4 per-client-inflight=2 retry-after-ms=10 ! "
            "tensor_filter framework=passthrough input=4 "
            "inputtype=float32 ! "
            f"tensor_query_serversink id={tag}", device="cpu"
    )
        ex = p.start()
        return p, ex, p[f"{tag}-src"]

    servers = {}
    execs = []
    for i in range(3):
        p, ex, src = start_server(f"soakf{i}")
        servers[i] = (p, ex, src)
        execs.append(ex)
    ports = {i: servers[i][2].bound_port for i in range(3)}
    hosts = ",".join(f"127.0.0.1:{ports[i]}" for i in range(3))

    n_clients, n_requests = 6, 40
    pace_s = 0.02  # ~2x the 3-server aggregate admission capacity, and
    #                the stream must still be LIVE through the whole
    #                kill/drain/restart choreography below
    outcomes = []
    mu = threading.Lock()

    def run_client(idx: int) -> None:
        props = {
            "hosts": hosts, "timeout": 8, "retry-max": 10,
            "retry-backoff-ms": 10,
        }
        if idx % 3 == 0:  # a third of the fleet injects wire faults
            props["chaos-drop-every-n"] = 7
            props["chaos-truncate-every-n"] = 11
        if idx % 2 == 0:
            props["hedge-after-ms"] = 250
        client = TensorQueryClient(f"soakf-c{idx}", **props)
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
                    if "rejected" in msg or "accepted" in msg:
                        kind = "nacked"
                    else:
                        kind = f"error:{msg[:80]}"
                with mu:
                    outcomes.append((kind, time.perf_counter() - t0))
                time.sleep(pace_s)
        finally:
            with mu:
                outcomes.append(("stats", client.fleet_stats()))
            client.stop()

    threads = [
        threading.Thread(target=run_client, args=(i,), daemon=True)
        for i in range(n_clients)
    ]
    for t in threads:
        t.start()

    # the chaos choreography, against live traffic:
    time.sleep(0.3)
    p0, ex0, _src0 = servers[0]
    p0.stop()                       # HARD kill server 0
    time.sleep(0.3)
    p1, ex1, src1 = servers[1]
    src1.drain(flush_queued=True)   # graceful drain server 1
    deadline = time.monotonic() + 5
    while not src1.drained() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert src1.drained(), src1.admission_stats()
    assert ex1.drain(timeout=10)    # quiesce at a frame boundary
    p1.stop()
    time.sleep(0.3)
    # restart both on their old ports: the fleet re-probes them in
    p0b, ex0b, _ = start_server("soakf0b", port=ports[0])
    p1b, ex1b, _ = start_server("soakf1b", port=ports[1])
    execs += [ex0b, ex1b]

    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads), "client thread hung"

    kinds = {}
    lats = []
    fleet_stats = []
    for kind, val in outcomes:
        if kind == "stats":
            fleet_stats.append(val)
            continue
        kinds[kind] = kinds.get(kind, 0) + 1
        if kind == "completed":
            lats.append(val)
    # every request terminal; nothing timed out or errored unexpectedly
    assert sum(kinds.values()) == n_clients * n_requests, kinds
    unexpected = {
        k: v for k, v in kinds.items() if k not in ("completed", "nacked")
    }
    assert not unexpected, (unexpected, kinds)
    assert kinds.get("completed", 0) >= n_clients * n_requests * 3 // 4, kinds
    # failover p99 bounded: the kill/drain/restart gap never queues into
    # latency collapse (generous ceiling absorbs scheduler noise)
    lats.sort()
    p99 = lats[min(len(lats) - 1, int(0.99 * len(lats)))]
    assert p99 < 5.0, f"p99 {p99:.3f}s — failover gap collapsed"
    # the fleet actually exercised failover, and duplicates never
    # reached a caller (at-most-once held under kill + chaos + hedging)
    assert sum(s["failovers"] for s in fleet_stats) >= 1, fleet_stats
    # surviving/restarted pipelines: accounting + thread hygiene
    for p, ex, _src in (servers[2], (p0b, ex0b, None), (p1b, ex1b, None)):
        p.stop()
    for ex in execs:
        assert not ex.errors, ex.errors
        # the sanitizer's cross-process sweep sees the OTHER still-
        # running servers' threads (several executors share this test
        # process); the per-executor invariant is that none of its OWN
        # node threads outlived its shutdown
        own = {n.name for n in ex.nodes}
        assert not (set(ex.leaked_threads) & own), (
            ex.leaked_threads, own
        )
        for name, row in ex.stats().items():
            if not row.get("san_offered"):
                continue
            balance = (
                row["san_offered"] - row["san_delivered"]
                - row["san_routed"] - row.get("deadline_shed", 0)
                - row.get("error_dropped", 0)
            )
            assert balance >= 0, (name, row)
    # the global invariant: once every pipeline stopped, NO soak thread
    # survives anywhere in the process
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        stragglers = [
            t.name for t in threading.enumerate()
            if t.is_alive() and "soakf" in t.name
        ]
        if not stragglers:
            break
        time.sleep(0.05)
    assert not stragglers, stragglers
