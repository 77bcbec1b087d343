"""The cases of ``tests/test_query_transports.py`` run through the port's edge
layer (``nnstreamer_tpu_torch.edge``) on the CPU, with ephemeral ports and
short timeouts; ``tests/test_torch_edge_interop.py`` holds it against the
reference. The reference's notes follow.

Query connect-type=MQTT / HYBRID loopback tests.

Reference: tensor_query_common.c:35-42 connect types; loopback strategy of
tests/nnstreamer_edge/query/runTest.sh (server + client on localhost, the
broker in-process via the in-tree MqttBroker)."""

import threading

import numpy as np
import pytest

from nnstreamer_tpu_torch.edge.mqtt import MqttBroker
from nnstreamer_tpu_torch.edge.query import (
    TensorQueryClient,
    TensorQueryServerSink,
    TensorQueryServerSrc,
)
from nnstreamer_tpu_torch.tensors.frame import Frame


def _echo_server(src, sink, scale, stop_evt):
    while not stop_evt.is_set():
        frame = src.generate()
        if frame is None:
            continue
        out = frame.with_tensors([np.asarray(t) * scale for t in frame.tensors])
        sink.render(out)


def _roundtrip(connect_type, broker, srv_id, topic, n_clients=1):
    props = {"connect-type": connect_type, "topic": topic}
    src = TensorQueryServerSrc(
        f"qsrc-{srv_id}", host="127.0.0.1", port=broker.port, id=srv_id, **props
    )
    sink = TensorQueryServerSink(f"qsink-{srv_id}", id=srv_id)
    src.output_spec()
    src.start()
    stop_evt = threading.Event()
    t = threading.Thread(
        target=_echo_server, args=(src, sink, 3.0, stop_evt), daemon=True
    )
    t.start()
    clients = [
        TensorQueryClient(
            f"qc-{srv_id}-{i}",
            **{"dest-host": "127.0.0.1", "dest-port": broker.port,
               "timeout": 10, **props},
        )
        for i in range(n_clients)
    ]
    try:
        for c in clients:
            c.start()
        for i, c in enumerate(clients):
            val = 10.0 * (i + 1)
            reply = c.process(Frame((np.full((2, 2), val, np.float32),), pts=7))
            assert reply is not None
            np.testing.assert_allclose(
                np.asarray(reply.tensors[0]), np.full((2, 2), val * 3.0)
            )
            assert reply.pts == 7
        # second round trip per client on the same connection
        for i, c in enumerate(clients):
            reply = c.process(Frame((np.ones(3, np.float32) * (i + 1),)))
            np.testing.assert_allclose(
                np.asarray(reply.tensors[0]), np.full(3, 3.0 * (i + 1))
            )
    finally:
        stop_evt.set()
        for c in clients:
            c.stop()
        t.join(timeout=2)
        src.stop()


@pytest.fixture()
def broker():
    b = MqttBroker()
    yield b
    b.close()


def test_query_mqtt_roundtrip(broker):
    _roundtrip("MQTT", broker, "m1", "q/mqtt1")


def test_query_mqtt_two_clients_demux(broker):
    _roundtrip("MQTT", broker, "m2", "q/mqtt2", n_clients=2)


def test_query_hybrid_roundtrip(broker):
    _roundtrip("HYBRID", broker, "h1", "q/hyb1")


def test_query_hybrid_two_clients_demux(broker):
    _roundtrip("HYBRID", broker, "h2", "q/hyb2", n_clients=2)


def test_hybrid_discovery_fails_without_server(broker):
    from nnstreamer_tpu_torch.edge.query_transports import HybridClientTransport
    from nnstreamer_tpu_torch.edge.transport import TransportError

    tr = HybridClientTransport("q/nobody")
    tr.DISCOVERY_TIMEOUT = 0.8
    with pytest.raises(TransportError, match="whois"):
        tr.connect("127.0.0.1", broker.port)


def test_unknown_connect_type_rejected():
    from nnstreamer_tpu_torch.elements.base import NegotiationError

    src = TensorQueryServerSrc("bad", **{"connect-type": "AITT"})
    with pytest.raises(NegotiationError, match="AITT"):
        src.output_spec()
