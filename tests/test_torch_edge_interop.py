"""The port's edge layer against the JAX package's, on the CPU.

- Wire bytes: a frame, EOS, NACK and CTRL message encode to the same bytes
  in both packages, and each decodes the other's (exact).
- Host decisions: the admission controller and the fleet selector, fed
  the same event sequence on the same clock, decide alike (exact); the
  prefix-route keys are equal.
- Interop on loopback: a port ``tensor_query_client`` against a reference
  server and the reverse (TCP), MQTT clients against the other package's
  broker, a port ``edgesink`` feeding a reference ``edgesrc`` (TCP and
  SHM), gRPC in both directions and both IDLs.
- The labeling slice split across the wire: a port query server running
  resize, MobileNet-v2 and the labeling decoder, on the reference's
  weights, answers a port client and a reference client with the labels
  of the reference's local pipeline (labels equal; logits within 1e-4 of
  max |logit|, the tolerance of the port's other MobileNet parity tests).
"""

import random
import threading
import time

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from nnstreamer_tpu.edge import admission as jadm
from nnstreamer_tpu.edge import fleet as jfleet
from nnstreamer_tpu.edge import query as jq
from nnstreamer_tpu.edge import serialize as jser
from nnstreamer_tpu.pipeline.parse import parse_pipeline as jparse
from nnstreamer_tpu.tensors.frame import Frame as JFrame
from nnstreamer_tpu_torch.edge import admission as tadm
from nnstreamer_tpu_torch.edge import fleet as tfleet
from nnstreamer_tpu_torch.edge import query as tq
from nnstreamer_tpu_torch.edge import serialize as tser
from nnstreamer_tpu_torch.pipeline.parse import parse_pipeline
from nnstreamer_tpu_torch.tensors.frame import EOS, Frame

RNG = np.random.default_rng(20)

# (tensors, pts, duration, meta): hop-local and non-scalar meta never ride
FRAMES = [
    ((RNG.standard_normal((3, 4)).astype(np.float32),
      RNG.integers(0, 255, (1, 6, 8, 3)).astype(np.uint8)),
     123456789, 1000, {"frame_id": "a.q.0", "req": 3, "deadline_ms": 12.5}),
    ((RNG.integers(-9, 9, (5,)).astype(np.int64),), None, None, {}),
    ((RNG.standard_normal((2, 2)).astype(np.float16),
      RNG.integers(0, 9, (7,)).astype(np.int32)), 0, None,
     {"client_id": 4, "admit_t": 1.0, "_nns_srv": "s", "obj": [1, 2], "ok": True, "n": None}),
]


@pytest.mark.parametrize("i", range(len(FRAMES)))
def test_wire_bytes_equal_both_ways(i):
    tensors, pts, dur, meta = FRAMES[i]
    theirs = jser.encode_message(JFrame(tensors, pts=pts, duration=dur, meta=dict(meta)))
    ours = tser.encode_message(Frame(tensors, pts=pts, duration=dur, meta=dict(meta)))
    assert ours == theirs
    # torch tensors encode as the numpy arrays do
    assert tser.encode_message(Frame(tuple(torch.from_numpy(t) for t in tensors), pts=pts,
                                     duration=dur, meta=dict(meta))) == theirs
    for decoded in (tser.decode_message(theirs), jser.decode_message(ours)):
        assert (decoded.pts, decoded.duration) == (pts, dur)
        assert decoded.meta == jser.decode_message(theirs).meta
        for got, want in zip(decoded.tensors, tensors):
            assert np.asarray(got).dtype == want.dtype
            np.testing.assert_array_equal(np.asarray(got), want)
    # the port's arrays own writable memory: torch shares them safely
    for a in tser.decode_message(theirs).tensors:
        assert a.flags.writeable
        torch.from_numpy(a)


def test_bfloat16_and_control_messages_equal():
    bits = RNG.integers(0, 1 << 16, (3, 5)).astype(np.uint16)
    jbf = bits.view(ml_dtypes.bfloat16)
    tbf = torch.from_numpy(bits.astype(np.int16)).view(torch.bfloat16)
    theirs = jser.encode_message(JFrame((jbf,), pts=7))
    assert tser.encode_message(Frame((tbf,), pts=7)) == theirs
    assert np.array_equal(np.asarray(jser.decode_message(theirs).tensors[0]).view(np.uint16), bits)
    assert tser.encode_message(EOS()) == jser.encode_message(jser.EOS_FRAME)
    assert isinstance(tser.decode_message(jser.encode_message(jser.EOS_FRAME)), EOS)
    for args in (("overload", 75.5, "a.b.3"), ("malformed", 0.0, None)):
        assert tser.encode_nack(*args) == jser.encode_nack(*args)
        n = tser.decode_message(jser.encode_nack(*args))
        assert (n.reason, n.retry_after_ms, n.frame_id) == args
    wire = jser.encode_ctrl("migrate_span", payload=b"\x00span\xff", llm_id=3)
    assert tser.encode_ctrl("migrate_span", payload=b"\x00span\xff", llm_id=3) == wire
    c = tser.decode_message(wire)
    assert (c.op, c.meta["llm_id"], c.payload) == ("migrate_span", 3, b"\x00span\xff")
    for bad in (b"xx", wire[:3], b"\x09" + wire[1:]):
        with pytest.raises(ValueError):
            tser.decode_message(bad)


# -- host decisions ------------------------------------------------------------------------

def _script(seed, n=400):
    r = random.Random(seed)
    ops = []
    for _ in range(n):
        kind = r.choices(["offer", "next", "release", "gone"], [6, 3, 3, 1])[0]
        ops.append((kind, f"c{r.randrange(5)}", r.choice([None, 0, 1, 2]), r.random() * 0.05))
    return ops


@pytest.mark.parametrize("cfg", [
    dict(max_inflight=6, per_client_inflight=2),
    dict(max_clients=3, rate=40.0, burst=3, retry_after_ms=20.0),
    dict(max_inflight=4, per_client_inflight=3, max_clients=4, rate=100.0),
])
def test_admission_decisions_equal(cfg):
    """The same offers, serves, releases and departures on the same clock:
    every decision, the serving order and the snapshots are equal."""
    ours = tadm.AdmissionController(tadm.AdmissionConfig(**cfg))
    theirs = jadm.AdmissionController(jadm.AdmissionConfig(**cfg))
    now = 1000.0
    inflight = {}
    for step, (kind, cid, prio, dt) in enumerate(_script(sum(map(hash, map(str, cfg))) & 0xffff)):
        now += dt
        if kind == "offer":
            meta = {} if prio is None else {"priority": prio}
            meta["frame_id"] = step
            a = ours.offer(cid, Frame((np.zeros(1, np.float32),), meta=dict(meta)), now=now)
            b = theirs.offer(cid, JFrame((np.zeros(1, np.float32),), meta=dict(meta)), now=now)
            assert (a.ok, a.reason, a.retry_after_ms) == (b.ok, b.reason, b.retry_after_ms), step
            if a.ok:
                inflight[cid] = inflight.get(cid, 0) + 1
        elif kind == "next":
            a, b = ours.next_ready(), theirs.next_ready()
            assert (a is None) == (b is None)
            if a is not None:
                assert a.meta["frame_id"] == b.meta["frame_id"]
        elif kind == "release" and inflight.get(cid):
            inflight[cid] -= 1
            ours.release(cid)
            theirs.release(cid)
        elif kind == "gone":
            inflight.pop(cid, None)
            ours.client_gone(cid)
            theirs.client_gone(cid)
        sa, sb = ours.snapshot(), theirs.snapshot()
        assert sa == sb, step


class _Clock:
    def __init__(self):
        self.t = 500.0

    def __call__(self):
        return self.t


def test_fleet_selector_decisions_equal():
    """Plans, ejections, jittered backoffs and drains on the same clock and
    the same random stream are equal in both packages."""
    clocks = (_Clock(), _Clock())
    fleets = [mod.FleetEndpoints([("a", 1), ("b", 2), ("c", 3)], eject_after=2,
                                 probe_backoff_ms=40.0, rng=random.Random(7), clock=clk)
              for mod, clk in zip((tfleet, jfleet), clocks)]
    r = random.Random(3)
    for step in range(300):
        dt = r.random() * 0.03
        for clk in clocks:
            clk.t += dt
        plans = [[e.addr for e in f.plan()] for f in fleets]
        assert plans[0] == plans[1], step
        op, k = r.choice(["ok", "fail", "fail", "drain", "load"]), r.randrange(3)
        for f in fleets:
            ep = f.endpoints[k]
            if op == "ok":
                f.record_ok(ep)
            elif op == "fail":
                f.record_fail(ep)
            elif op == "drain":
                f.mark_draining(ep, 30.0)
            else:
                ep.inflight = (step * 7 + k) % 4
        assert fleets[0].snapshot() == fleets[1].snapshot(), step
        assert fleets[0].next_retry_in() == fleets[1].next_retry_in()


def test_prefix_keys_router_dedup_hedge_equal():
    for n in (0, 15, 16, 40, 100, 257):
        toks = RNG.integers(0, 32000, (n,)).astype(np.int32)
        assert tfleet.prefix_route_keys(toks) == jfleet.prefix_route_keys(toks)
        assert tfleet.prefix_route_keys(list(toks), block=8, max_blocks=4) == \
            jfleet.prefix_route_keys(list(toks), block=8, max_blocks=4)
    routers = (tfleet.PrefixRouter(capacity=16), jfleet.PrefixRouter(capacity=16))
    dedups = (tfleet.ReplyDeduper(capacity=16), jfleet.ReplyDeduper(capacity=16))
    r = random.Random(5)
    for step in range(200):
        keys = tfleet.prefix_route_keys([r.randrange(4) for _ in range(r.randrange(64))])
        addr = f"h:{r.randrange(3)}"
        if r.random() < 0.5:
            for x in routers:
                x.note(keys, addr)
        assert routers[0].best(keys) == routers[1].best(keys), step
        fid = r.randrange(40)
        assert dedups[0].claim(fid) == dedups[1].claim(fid)
    assert dedups[0].duplicates == dedups[1].duplicates and len(routers[0]) == len(routers[1])
    clocks = (_Clock(), _Clock())
    windows = (tfleet.RttWindow(), jfleet.RttWindow())
    timers = [mod.HedgeTimer(-1.0, clock=clk, rtts=w, adaptive_floor_ms=5.0)
              for mod, clk, w in zip((tfleet, jfleet), clocks, windows)]
    for step in range(60):
        rtt = r.random() * 0.02
        for w in windows:
            w.record(rtt)
        assert timers[0].threshold_s() == timers[1].threshold_s()
        for h in timers:
            h.arm()
        for clk in clocks:
            clk.t += 0.01
        assert timers[0].due() == timers[1].due()


# -- interop on loopback ----------------------------------------------------------------------

class _Echo:
    """A serversrc/serversink pair of one package, echoing tensors x2."""

    def __init__(self, mod, name, **props):
        self.src = mod.TensorQueryServerSrc(name, port=0, id=name, **props)
        self.sink = mod.TensorQueryServerSink(f"{name}k", id=name)
        self.src.start()
        self.port = self.src.bound_port
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._loop, daemon=True)
        self._t.start()

    def _loop(self):
        while not self._stop.is_set():
            f = self.src.generate()
            if f is not None:
                self.sink.render(f.with_tensors([np.asarray(t) * 2 for t in f.tensors]))

    def stop(self):
        self._stop.set()
        self._t.join(timeout=2)
        self.src.stop()


@pytest.mark.parametrize("client,server", [("port", "reference"), ("reference", "port"),
                                           ("port", "port")])
def test_query_client_server_across_packages(client, server):
    cmod = tq if client == "port" else jq
    cframe = Frame if client == "port" else JFrame
    srv = _Echo(tq if server == "port" else jq, f"x-{client}-{server}", **{"max-inflight": 4})
    c = cmod.TensorQueryClient(f"xc-{client}-{server}",
                               **{"dest-port": srv.port, "timeout": 5, "deadline-ms": 5000})
    try:
        c.start()
        if client == "port":
            assert c.transport == "native"
        if server == "port":
            assert srv.src.transport == "native"
        for k, (tensors, pts, dur, meta) in enumerate(FRAMES):
            reply = c.process(cframe(tensors, pts=pts, duration=dur, meta=dict(meta)))
            assert reply.pts == pts and reply.meta.get("req") == meta.get("req")
            assert reply.meta["frame_id"] == meta.get("frame_id", reply.meta["frame_id"])
            for got, want in zip(reply.tensors, tensors):
                np.testing.assert_array_equal(np.asarray(got), want * 2)
        if server == "port":
            assert srv.src.admission_stats()["admitted"] == len(FRAMES)
    finally:
        c.stop()
        srv.stop()


@pytest.mark.parametrize("broker_pkg", ["reference", "port"])
def test_mqtt_clients_across_packages(broker_pkg):
    from nnstreamer_tpu.edge import mqtt as jm
    from nnstreamer_tpu_torch.edge import mqtt as tm

    broker = (jm if broker_pkg == "reference" else tm).MqttBroker()
    other = tm if broker_pkg == "reference" else jm
    own = jm if broker_pkg == "reference" else tm
    sub = other.MqttClient("127.0.0.1", broker.port).connect()
    pub = own.MqttClient("127.0.0.1", broker.port).connect()
    sub2 = own.MqttClient("127.0.0.1", broker.port).connect()
    try:
        sub.subscribe("cam/+/frames")
        sub2.subscribe("cam/#")
        time.sleep(0.05)
        big = bytes(RNG.integers(0, 255, 300_000).astype(np.uint8))
        for topic, payload in (("cam/1/frames", b"hello"), ("cam/2/frames", big)):
            pub.publish(topic, payload)
            assert sub.recv(timeout=5) == (topic, payload)
            assert sub2.recv(timeout=5) == (topic, payload)
        pub.publish("cam/3/other", b"x")
        assert sub2.recv(timeout=5) == ("cam/3/other", b"x")
        assert sub.recv(timeout=0.2) is None
    finally:
        for c in (sub, pub, sub2):
            c.close()
        broker.close()


@pytest.mark.parametrize("connect_type", ["TCP", "SHM"])
def test_port_edgesink_feeds_reference_edgesrc(connect_type):
    from nnstreamer_tpu.edge.pubsub import EdgeSrc as JEdgeSrc
    from nnstreamer_tpu_torch.edge.pubsub import EdgeSink

    port = 0 if connect_type == "TCP" else 20000 + random.Random().randrange(20000)
    sink = EdgeSink("x-esink", port=port, **{"connect-type": connect_type})
    sink.start()
    src = JEdgeSrc("x-esrc", **{"dest-port": sink.bound_port, "connect-type": connect_type})
    try:
        assert sink.transport == ("native" if connect_type == "TCP" else "shm")
        src.start()
        if connect_type == "TCP":
            deadline = time.monotonic() + 5
            while sink._transport.peer_count() < 1 and time.monotonic() < deadline:
                time.sleep(0.01)
        for k, (tensors, pts, dur, meta) in enumerate(FRAMES):
            sink.render(Frame(tuple(torch.from_numpy(t) for t in tensors), pts=pts,
                              duration=dur, meta=dict(meta)))
        got = []
        deadline = time.monotonic() + 5
        while len(got) < len(FRAMES) and time.monotonic() < deadline:
            f = src.generate()
            if f is not None:
                got.append(f)
        assert len(got) == len(FRAMES)
        for f, (tensors, pts, _dur, _meta) in zip(got, FRAMES):
            assert f.pts == pts
            for a, b in zip(f.tensors, tensors):
                np.testing.assert_array_equal(np.asarray(a), b)
    finally:
        sink.stop()
        src.stop()


@pytest.mark.parametrize("idl", ["protobuf", "flatbuf"])
@pytest.mark.parametrize("direction", ["port->reference", "reference->port"])
def test_grpc_across_packages(idl, direction):
    """The port's hand-written codecs on the wire of the reference's
    protobuf and flatbuffers runtimes, under the same service names."""
    pytest.importorskip("grpc")
    from nnstreamer_tpu.edge import grpc_bridge as jg
    from nnstreamer_tpu_torch.edge import grpc_bridge as tg

    x = RNG.standard_normal((2, 3)).astype(np.float32)
    if direction == "port->reference":
        src = jg.GrpcTensorSrc("xg-src", server="true", port=0, idl=idl)
        src.start()
        sink = tg.GrpcTensorSink("xg-sink", server="false", port=src.bound_port, idl=idl)
        sink.start()
        frame = Frame((torch.from_numpy(x),))
    else:
        sink = jg.GrpcTensorSink("xg-sink", server="true", port=0, idl=idl)
        sink.start()
        src = tg.GrpcTensorSrc("xg-src", server="false", port=sink.bound_port, idl=idl)
        src.start()
        deadline = time.monotonic() + 5
        while not sink._subscribers and time.monotonic() < deadline:
            time.sleep(0.01)
        frame = JFrame((x,))
    try:
        got = None
        deadline = time.monotonic() + 5
        while got is None and time.monotonic() < deadline:
            sink.render(frame)
            got = src.generate()
        assert got is not None
        np.testing.assert_array_equal(np.asarray(got.tensors[0]), x)
    finally:
        sink.stop()
        src.stop()


def test_grpc_elements_name_grpc_when_it_is_missing(monkeypatch):
    import builtins

    from nnstreamer_tpu_torch.edge import grpc_bridge as tg
    from nnstreamer_tpu_torch.elements.base import ElementError

    real = builtins.__import__

    def no_grpc(name, *a, **kw):
        if name == "grpc":
            raise ImportError("No module named 'grpc'")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_grpc)
    for elem in (tg.GrpcTensorSrc("ng-src", port=0), tg.GrpcTensorSink("ng-sink", port=0)):
        with pytest.raises(ElementError, match="grpc"):
            elem.start()


def test_native_library_builds_apart_from_the_reference():
    import os

    from nnstreamer_tpu_torch.edge import _build

    path = _build.native_lib_path()
    assert path is not None and os.path.isfile(path)
    assert os.path.dirname(path).endswith(os.path.join("build", "torch_native"))
    assert not [n for n in os.listdir(os.path.dirname(path)) if n.endswith(".tmp")]


def test_query_client_after_a_converter_moves_no_frame_bytes():
    """source -> converter -> tensor_query_client: the client wants host
    bytes and the converter only adds an axis, so the converter runs on the
    host frame: the client gets numpy, and the transfer tally stays 0."""
    srv = _Echo(tq, "x-host")
    seen = []
    try:
        p = parse_pipeline(
            "videotestsrc pattern=counter num-frames=3 width=8 height=6 ! tensor_converter ! "
            f"tensor_query_client name=qc dest-port={srv.port} timeout=5 ! tensor_sink name=out",
            device="cpu")
        p.negotiate()
        inner = p["qc"].process
        p["qc"].process = lambda f: (seen.append(type(f.tensors[0])), inner(f))[1]
        ex = p.run(timeout=30)
        assert seen == [np.ndarray] * 3
        assert ex.transfer_totals() == {"h2d": 0, "d2h": 0}
        got = [np.asarray(f.tensors[0]) for f in p["out"].frames]
        assert [g.shape for g in got] == [(1, 6, 8, 3)] * 3
        assert [int(g.max()) for g in got] == [0, 2, 4]  # counter pattern, echoed x2
    finally:
        srv.stop()


# -- the labeling slice across the wire ---------------------------------------------------------

@pytest.fixture(scope="module")
def mobilenet_npz(tmp_path_factory):
    from nnstreamer_tpu.models import mobilenet_v2 as jmobilenet

    jp = jmobilenet.init_params(jax.random.PRNGKey(0), num_classes=16, width=0.5)
    path = tmp_path_factory.mktemp("mbv2") / "w.npz"
    np.savez(path, **{f"p{i}": np.asarray(v) for i, v in enumerate(jax.tree_util.tree_leaves(jp))})
    return str(path)


def _chain(fw, npz, decode):
    return (f"tensor_transform mode=resize option=96:96 ! tensor_filter framework={fw} "
            f'model=zoo:mobilenet_v2 custom="size:96,num_classes:16,width:0.5,params:{npz}"'
            + (" ! tensor_decoder mode=image_labeling" if decode else ""))


SRC = "videotestsrc pattern=gradient width=160 height=96 num-frames=4 ! tensor_converter"


@pytest.mark.parametrize("decode", [True, False], ids=["labels", "logits"])
def test_labeling_slice_across_the_wire(mobilenet_npz, decode):
    """A port query server runs resize -> MobileNet-v2 -> labeling on the
    reference's weights; a port client and a reference client get the
    reference's local pipeline's answers, frame by frame."""
    server = parse_pipeline(
        f"tensor_query_serversrc name=qs port=0 id=lbl{int(decode)} max-inflight=8 ! "
        f"{_chain('torch', mobilenet_npz, decode)} ! tensor_query_serversink id=lbl{int(decode)}",
        device="cpu")
    ex = server.start()
    try:
        port = server["qs"].bound_port
        client = parse_pipeline(
            f"{SRC} ! tensor_query_client name=qc dest-port={port} timeout=30 ! "
            "tensor_sink name=out", device="cpu")
        cex = client.run(timeout=120)
        assert not cex.errors and client["qc"].transport == "native"
        jclient = jparse(f"{SRC} ! tensor_query_client dest-port={port} timeout=30 ! "
                         "tensor_sink name=out")
        jclient.run(timeout=120)
        local = jparse(f"{SRC} ! {_chain('jax', mobilenet_npz, decode)} ! tensor_sink name=out")
        local.run(timeout=300)
        want = [np.asarray(f.tensors[0]) for f in local["out"].frames]
        assert len(want) == 4
        for frames in (client["out"].frames, jclient["out"].frames):
            got = [np.asarray(f.tensors[0]) for f in frames]
            assert len(got) == 4
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and g.shape == w.shape
                if decode:
                    assert np.array_equal(g, w)
                else:
                    np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * float(np.abs(w).max()))
                    assert np.array_equal(g.argmax(-1), w.argmax(-1))
        row = ex.stats()["qs"]
        assert row["adm_admitted"] == 8 and row["adm_readiness"] == "ready"
    finally:
        server.stop()
