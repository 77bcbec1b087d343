"""The cases of ``tests/test_edge.py``
and ``tests/test_faults.py::TestEdgeReconnect`` run through the port's edge
layer (``nnstreamer_tpu_torch.edge``) on the CPU, with ephemeral ports and
short timeouts; ``tests/test_torch_edge_interop.py`` holds it against the
reference. The reference's notes follow.

Distributed edge layer tests (reference: tests/nnstreamer_edge/query/
runTest.sh loopback pipelines, unittest_query.cc / unittest_edge.cc).

Like the reference's strategy, 'multi-node' runs as loopback on one host:
server and client sides talk over 127.0.0.1 with ephemeral ports.
"""

import socket
import threading
import time

import numpy as np
import pytest

from nnstreamer_tpu_torch.edge._build import native_lib_path
from nnstreamer_tpu_torch.edge.serialize import decode_message, encode_message
from nnstreamer_tpu_torch.edge.transport import NativeTransport, PyTransport
from nnstreamer_tpu_torch.tensors.frame import EOS, EOS_FRAME, Frame

HAVE_NATIVE = native_lib_path() is not None


def _impls():
    impls = [PyTransport]
    if HAVE_NATIVE:
        impls.append(NativeTransport)
    return impls


# ------------------------------------------------------------------ transport
@pytest.mark.parametrize("impl", _impls())
def test_transport_roundtrip(impl):
    server = impl()
    client = impl()
    try:
        port = server.listen("127.0.0.1", 0)
        client.connect("127.0.0.1", port)
        client.send(0, b"hello-tensors")
        got = server.recv(timeout=5)
        assert got is not None
        cid, payload = got
        assert payload == b"hello-tensors" and cid >= 1
        server.send(cid, b"reply")
        got = client.recv(timeout=5)
        assert got is not None and got[1] == b"reply"
    finally:
        client.close()
        server.close()


@pytest.mark.skipif(not HAVE_NATIVE, reason="no C++ toolchain")
def test_transport_cross_impl():
    """Native server interoperates with python client (same framing)."""
    server = NativeTransport()
    client = PyTransport()
    try:
        port = server.listen("127.0.0.1", 0)
        client.connect("127.0.0.1", port)
        blob = bytes(range(256)) * 10
        client.send(0, blob)
        got = server.recv(timeout=5)
        assert got is not None and got[1] == blob
        server.send(got[0], blob[::-1])
        got2 = client.recv(timeout=5)
        assert got2 is not None and got2[1] == blob[::-1]
    finally:
        client.close()
        server.close()


@pytest.mark.parametrize("impl", _impls())
def test_transport_broadcast(impl):
    server = impl()
    subs = [impl(), impl()]
    try:
        port = server.listen("127.0.0.1", 0)
        for s in subs:
            s.connect("127.0.0.1", port)
        deadline = time.monotonic() + 5
        while server.peer_count() < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert server.peer_count() == 2
        server.send(0, b"fanout")  # client_id 0 = broadcast
        for s in subs:
            got = s.recv(timeout=5)
            assert got is not None and got[1] == b"fanout"
    finally:
        for s in subs:
            s.close()
        server.close()


# -------------------------------------------------------------- serialization
def test_message_roundtrip():
    f = Frame(
        (np.arange(12, dtype=np.float32).reshape(3, 4),
         np.arange(4, dtype=np.uint8)),
        pts=123456789,
        duration=1000,
    )
    back = decode_message(encode_message(f))
    assert back.pts == 123456789 and back.duration == 1000
    np.testing.assert_array_equal(back.tensors[0], f.tensors[0])
    np.testing.assert_array_equal(back.tensors[1], f.tensors[1])


def test_message_eos():
    assert isinstance(decode_message(encode_message(EOS_FRAME)), EOS)


def test_message_malformed():
    with pytest.raises(ValueError):
        decode_message(b"xx")


# -------------------------------------------------------------- query elements
def _echo_server(src, sink, scale, stop_evt):
    """Minimal server pipeline loop: serversrc → ×scale → serversink."""
    while not stop_evt.is_set():
        frame = src.generate()
        if frame is None:
            continue
        out = frame.with_tensors(
            [np.asarray(t) * scale for t in frame.tensors]
        )
        sink.render(out)


def test_query_client_server_roundtrip():
    from nnstreamer_tpu_torch.edge.query import (
        TensorQueryClient,
        TensorQueryServerSink,
        TensorQueryServerSrc,
    )

    src = TensorQueryServerSrc("qsrc", port=0, id="t1")
    sink = TensorQueryServerSink("qsink", id="t1")
    src.start()
    stop_evt = threading.Event()
    t = threading.Thread(
        target=_echo_server, args=(src, sink, 2.0, stop_evt), daemon=True
    )
    t.start()
    client = TensorQueryClient(
        "qc", **{"dest-host": "127.0.0.1", "dest-port": src.bound_port,
                 "timeout": 5}
    )
    try:
        client.negotiate([Frame((np.zeros(1, np.float32),)).spec()])
        client.start()
        reply = client.process(
            Frame((np.full((2, 3), 3.0, np.float32),), pts=42)
        )
        assert reply is not None
        np.testing.assert_allclose(
            np.asarray(reply.tensors[0]), np.full((2, 3), 6.0)
        )
        assert reply.pts == 42  # reply keeps request timing
        # second round trip on the same connection
        reply2 = client.process(Frame((np.ones(4, np.float32),)))
        np.testing.assert_allclose(np.asarray(reply2.tensors[0]), np.full(4, 2.0))
    finally:
        stop_evt.set()
        client.stop()
        t.join(timeout=2)
        src.stop()


def test_query_multiple_clients_demux():
    """Two clients share one server; replies route by client_id
    (reference GstMetaQuery demultiplexing)."""
    from nnstreamer_tpu_torch.edge.query import (
        TensorQueryClient,
        TensorQueryServerSink,
        TensorQueryServerSrc,
    )

    src = TensorQueryServerSrc("qsrc2", port=0, id="t2")
    sink = TensorQueryServerSink("qsink2", id="t2")
    src.start()
    stop_evt = threading.Event()
    t = threading.Thread(
        target=_echo_server, args=(src, sink, 1.0, stop_evt), daemon=True
    )
    t.start()
    c1 = TensorQueryClient("c1", **{"dest-port": src.bound_port, "timeout": 5})
    c2 = TensorQueryClient("c2", **{"dest-port": src.bound_port, "timeout": 5})
    try:
        c1.start()
        c2.start()
        r1 = c1.process(Frame((np.full(2, 10.0, np.float32),)))
        r2 = c2.process(Frame((np.full(2, 20.0, np.float32),)))
        assert float(np.asarray(r1.tensors[0])[0]) == 10.0
        assert float(np.asarray(r2.tensors[0])[0]) == 20.0
    finally:
        stop_evt.set()
        c1.stop()
        c2.stop()
        t.join(timeout=2)
        src.stop()


def test_query_client_timeout():
    from nnstreamer_tpu_torch.edge.query import TensorQueryClient
    from nnstreamer_tpu_torch.edge.transport import PyTransport
    from nnstreamer_tpu_torch.elements.base import ElementError

    silent = PyTransport()
    port = silent.listen("127.0.0.1", 0)
    client = TensorQueryClient(
        "qt", **{"dest-port": port, "timeout": 0.2}
    )
    try:
        client.start()
        with pytest.raises(ElementError, match="timeout"):
            client.process(Frame((np.zeros(1, np.float32),)))
    finally:
        client.stop()
        silent.close()


# ---------------------------------------------------------------- pub/sub
def test_edge_pubsub_pipeline():
    """edgesink pipeline publishes, edgesrc pipeline receives — both driven
    by the real executor (reference runTest.sh two-process loopback)."""
    from nnstreamer_tpu_torch.edge.pubsub import EdgeSink, EdgeSrc
    from nnstreamer_tpu_torch.elements.sink import TensorSink
    from nnstreamer_tpu_torch.elements.sources import AppSrc
    from nnstreamer_tpu_torch.pipeline.graph import Pipeline

    frames = [
        Frame((np.full((2, 2), float(i), np.float32),), pts=i * 1000)
        for i in range(5)
    ]
    pub_src = AppSrc(
        "app0", iterable=frames,
        spec=frames[0].spec(),
    )
    pub_sink = EdgeSink(
        "esink", port=0, **{"wait-connection": "true",
                            "connection-timeout": 5}
    )
    pub = Pipeline("pub", device="cpu").chain(pub_src, pub_sink)
    pub.negotiate()
    plan = pub.compile_plan()

    # start publisher paused until subscriber connects (wait-connection)
    pub_thread = threading.Thread(target=lambda: pub.run(timeout=10), daemon=True)
    pub_thread.start()
    deadline = time.monotonic() + 5
    while pub_sink.bound_port is None and time.monotonic() < deadline:
        time.sleep(0.01)
    assert pub_sink.bound_port

    sub_src = EdgeSrc("esrc", **{"dest-port": pub_sink.bound_port})
    sub_sink = TensorSink("tsink")
    sub = Pipeline("sub", device="cpu").chain(sub_src, sub_sink)
    sub.negotiate()
    sub.run(timeout=10)
    pub_thread.join(timeout=5)

    received = sub_sink.frames
    assert len(received) == 5
    for i, f in enumerate(received):
        assert float(np.asarray(f.tensors[0])[0, 0]) == float(i)
        assert f.pts == i * 1000


# ------------------------------------------------------------------ gRPC
@pytest.mark.parametrize("idl", ["protobuf", "flatbuf"])
def test_grpc_push_pull(idl):
    """Client-mode sink pushes into a server-mode src (SendTensors path),
    over both IDLs (reference nnstreamer_grpc_{protobuf,flatbuf}.cc)."""
    pytest.importorskip("grpc")
    from nnstreamer_tpu_torch.edge.grpc_bridge import GrpcTensorSink, GrpcTensorSrc

    src = GrpcTensorSrc("gsrc", server="true", port=0, idl=idl)
    src.start()
    sink = GrpcTensorSink("gsink", server="false", port=src.bound_port, idl=idl)
    sink.start()
    try:
        sink.render(Frame((np.arange(6, dtype=np.float32).reshape(2, 3),)))
        got = None
        deadline = time.monotonic() + 5
        while got is None and time.monotonic() < deadline:
            got = src.generate()
        assert got is not None and got is not EOS_FRAME
        np.testing.assert_array_equal(
            np.asarray(got.tensors[0]),
            np.arange(6, dtype=np.float32).reshape(2, 3),
        )
    finally:
        sink.stop()
        src.stop()


@pytest.mark.parametrize("idl", ["protobuf", "flatbuf"])
def test_grpc_serve_stream(idl):
    """Server-mode sink streams to a client-mode src (RecvTensors path),
    over both IDLs."""
    pytest.importorskip("grpc")
    from nnstreamer_tpu_torch.edge.grpc_bridge import GrpcTensorSink, GrpcTensorSrc

    sink = GrpcTensorSink("gsink2", server="true", port=0, idl=idl)
    sink.start()
    src = GrpcTensorSrc("gsrc2", server="false", port=sink.bound_port, idl=idl)
    src.start()
    try:
        # wait for the subscriber's RecvTensors stream to attach
        deadline = time.monotonic() + 5
        while not sink._subscribers and time.monotonic() < deadline:
            time.sleep(0.01)
        assert sink._subscribers
        for i in range(3):
            sink.render(Frame((np.full(2, float(i), np.float32),)))
        got = []
        deadline = time.monotonic() + 5
        while len(got) < 3 and time.monotonic() < deadline:
            f = src.generate()
            if f is not None and f is not EOS_FRAME:
                got.append(f)
        assert len(got) == 3
        assert float(np.asarray(got[2].tensors[0])[0]) == 2.0
    finally:
        sink.stop()
        src.stop()


@pytest.mark.parametrize("impl", _impls())
def test_broadcast_survives_dead_subscriber(impl):
    """One dead subscriber must not kill the publisher (best-effort
    broadcast; the reference's edge pub/sub behaves the same)."""
    server = impl()
    alive = impl()
    dead = impl()
    try:
        port = server.listen("127.0.0.1", 0)
        alive.connect("127.0.0.1", port)
        dead.connect("127.0.0.1", port)
        deadline = time.monotonic() + 5
        while server.peer_count() < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        dead.close()  # subscriber vanishes
        for _ in range(20):  # keep sending until the close is visible
            server.send(0, b"still-alive")
            time.sleep(0.01)
        got = alive.recv(timeout=5)
        assert got is not None and got[1] == b"still-alive"
    finally:
        alive.close()
        server.close()


def test_grpc_idl_mismatch_fails_loudly():
    """A protobuf client against a flatbuf server must error (distinct
    service names), not silently mis-parse — reference behavior."""
    pytest.importorskip("grpc")
    from nnstreamer_tpu_torch.edge.grpc_bridge import GrpcTensorSink, GrpcTensorSrc
    from nnstreamer_tpu_torch.elements.base import ElementError

    src = GrpcTensorSrc("gsrc3", server="true", port=0, idl="flatbuf")
    src.start()
    sink = GrpcTensorSink(
        "gsink3", server="false", port=src.bound_port, idl="protobuf"
    )
    sink.start()
    try:
        with pytest.raises(ElementError):
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                sink.render(Frame((np.zeros(2, np.float32),)))
                time.sleep(0.05)
    finally:
        sink.stop()
        src.stop()


def test_grpc_unknown_idl_rejected():
    pytest.importorskip("grpc")
    from nnstreamer_tpu_torch.edge.grpc_bridge import GrpcTensorSrc
    from nnstreamer_tpu_torch.elements.base import ElementError

    bad = GrpcTensorSrc("gsrc4", server="true", port=0, idl="capnproto")
    with pytest.raises(ElementError, match="unknown idl"):
        bad.start()


def test_grpc_client_unreachable_raises():
    pytest.importorskip("grpc")
    from nnstreamer_tpu_torch.edge.grpc_bridge import GrpcTensorSrc
    from nnstreamer_tpu_torch.elements.base import ElementError

    src = GrpcTensorSrc(
        "gdead", server="false", port=1, **{"connection-timeout": 0.3}
    )
    with pytest.raises(ElementError, match="cannot reach"):
        src.start()


def test_transport_churn_stress():
    """Concurrency stress on the native transport: clients connect, send,
    and vanish while the server broadcasts — exercises the dead-fd
    bookkeeping (fd-reuse race) under churn. Build with
    NNS_EDGE_SANITIZE=thread g++ instrumentation to run it under TSAN."""
    from nnstreamer_tpu_torch.edge.transport import make_transport

    server = make_transport()
    port = server.listen("127.0.0.1", 0)
    stop = threading.Event()

    def broadcaster():
        while not stop.is_set():
            try:
                server.send(0, b"tick" * 64)
            except Exception:
                pass

    bcast = threading.Thread(target=broadcaster, daemon=True)
    bcast.start()

    received = []

    def client_life(i):
        c = make_transport()
        try:
            c.connect("127.0.0.1", port)
            c.send(0, f"hello {i}".encode())
            got = c.recv(timeout=2)
            if got is not None:
                received.append(i)
        finally:
            c.close()

    threads = [threading.Thread(target=client_life, args=(i,)) for i in range(24)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=20)
    stop.set()
    bcast.join(timeout=5)
    # server saw the client messages (some may race with disconnect)
    got_msgs = 0
    while True:
        m = server.recv(timeout=0.2)
        if m is None:
            break
        if m[1]:
            got_msgs += 1
    server.close()
    assert got_msgs >= 12, f"only {got_msgs} of 24 client messages arrived"
    assert len(received) >= 12, f"only {len(received)} clients got a broadcast"


# ---------------------------------------------- reconnect (tests/test_faults.py)
class TestEdgeReconnect:
    def test_client_start_retries_until_server_up(self):
        from nnstreamer_tpu_torch.edge.query import TensorQueryClient
        from nnstreamer_tpu_torch.edge.transport import PyTransport

        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        server = PyTransport()

        def delayed():
            time.sleep(0.3)
            server.listen("127.0.0.1", port)
            got = server.recv(timeout=5)
            if got is not None:
                server.send(got[0], got[1])  # echo

        t = threading.Thread(target=delayed, daemon=True)
        t.start()
        c = TensorQueryClient(
            "c", **{"dest-port": port, "timeout": 5, "retry-max": 8,
                    "retry-backoff-ms": 30}
        )
        c.negotiate([None])
        try:
            c.start()  # server is down for the first ~0.3 s
            from nnstreamer_tpu_torch.tensors.frame import Frame

            f = Frame((np.arange(4, dtype=np.float32),))
            reply = c.process(f)
            np.testing.assert_allclose(
                np.asarray(reply.tensors[0]), f.tensors[0]
            )
        finally:
            c.stop()
            server.close()
            t.join(timeout=2)

    def test_no_retry_fails_fast(self):
        from nnstreamer_tpu_torch.edge.query import TensorQueryClient
        from nnstreamer_tpu_torch.elements.base import ElementError

        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        c = TensorQueryClient("c", **{"dest-port": port, "timeout": 1})
        c.negotiate([None])
        t0 = time.monotonic()
        with pytest.raises(ElementError, match="cannot reach"):
            c.start()
        assert time.monotonic() - t0 < 2.0
