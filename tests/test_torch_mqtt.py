"""The cases of ``tests/test_mqtt.py`` run through the port's edge
layer (``nnstreamer_tpu_torch.edge``) on the CPU, with ephemeral ports and
short timeouts; ``tests/test_torch_edge_interop.py`` holds it against the
reference. The reference's notes follow.

MQTT layer tests: protocol codec, in-process broker, mqttsink/mqttsrc
pipelines, SNTP sync (reference: gst/mqtt/*, tests gated on a local broker
via tests/check_broker.sh — our in-repo broker makes them unconditional)."""

import socket
import struct
import threading
import time

import numpy as np
import pytest

from nnstreamer_tpu_torch.edge import ntp
from nnstreamer_tpu_torch.edge.mqtt import MqttBroker, MqttClient, topic_matches
from nnstreamer_tpu_torch.edge.mqtt_elems import MqttSink, MqttSrc
from nnstreamer_tpu_torch.elements.base import ElementError
from nnstreamer_tpu_torch.elements.converter import TensorConverter
from nnstreamer_tpu_torch.elements.sink import TensorSink
from nnstreamer_tpu_torch.elements.sources import VideoTestSrc
from nnstreamer_tpu_torch.pipeline.graph import Pipeline
from nnstreamer_tpu_torch.tensors.frame import Frame


@pytest.fixture
def broker():
    b = MqttBroker()
    yield b
    b.close()


@pytest.fixture(autouse=True)
def _reset_ntp():
    yield
    ntp.reset()


class TestTopicMatch:
    def test_exact_and_wildcards(self):
        assert topic_matches("a/b", "a/b")
        assert not topic_matches("a/b", "a/c")
        assert topic_matches("a/+", "a/b")
        assert not topic_matches("a/+", "a/b/c")
        assert topic_matches("a/#", "a/b/c")
        assert topic_matches("#", "anything/at/all")
        assert not topic_matches("a/#/b", "a/x/b")  # '#' must be last


class TestClientBroker:
    def test_pub_sub_roundtrip(self, broker):
        sub = MqttClient(port=broker.port, client_id="sub").connect()
        pub = MqttClient(port=broker.port, client_id="pub").connect()
        try:
            sub.subscribe("nns/test")
            time.sleep(0.1)  # SUBACK settle
            pub.publish("nns/test", b"hello tensors")
            got = sub.recv(timeout=5)
            assert got == ("nns/test", b"hello tensors")
        finally:
            sub.close()
            pub.close()

    def test_wildcard_subscription(self, broker):
        sub = MqttClient(port=broker.port).connect()
        pub = MqttClient(port=broker.port).connect()
        try:
            sub.subscribe("nns/+/stream")
            time.sleep(0.1)
            pub.publish("nns/cam0/stream", b"x")
            pub.publish("nns/other/topic", b"y")  # not matched
            assert sub.recv(timeout=5) == ("nns/cam0/stream", b"x")
            assert sub.recv(timeout=0.3) is None
        finally:
            sub.close()
            pub.close()

    def test_large_payload(self, broker):
        sub = MqttClient(port=broker.port).connect()
        pub = MqttClient(port=broker.port).connect()
        try:
            sub.subscribe("big")
            time.sleep(0.1)
            blob = bytes(range(256)) * 4096  # 1 MiB: exercises varint length
            pub.publish("big", blob)
            got = sub.recv(timeout=10)
            assert got is not None and got[1] == blob
        finally:
            sub.close()
            pub.close()

    def test_connect_refused(self):
        with pytest.raises(OSError):
            MqttClient(port=1, client_id="x").connect(timeout=1)


class TestMqttElements:
    def test_pipeline_pub_sub(self, broker):
        n = 4
        src_pipe = Pipeline(device="cpu").chain(
            VideoTestSrc(width=8, height=8, **{"num-frames": n}),
            TensorConverter(),
            MqttSink(port=broker.port, **{"pub-topic": "nns/t"}),
        )
        sink = TensorSink()
        recv_pipe = Pipeline(device="cpu").chain(
            MqttSrc(port=broker.port, **{"sub-topic": "nns/t"}), sink
        )
        recv_ex = recv_pipe.start()
        time.sleep(0.3)  # subscription settles before publishing starts
        src_pipe.run(timeout=30)
        assert recv_ex.wait(timeout=30)
        recv_pipe.stop()
        assert sink.rendered == n
        f = sink.frames[0]
        assert f.tensors[0].shape == (1, 8, 8, 3)
        assert "mqtt_sent_time" in f.meta and "mqtt_transit_s" in f.meta

    def test_sink_requires_topic(self):
        with pytest.raises(ValueError, match="pub-topic"):
            MqttSink()

    def test_src_requires_topic(self):
        with pytest.raises(ValueError, match="sub-topic"):
            MqttSrc()

    def test_unreachable_broker_errors(self):
        s = MqttSink(port=1, **{"pub-topic": "x"})
        with pytest.raises(ElementError, match="cannot reach"):
            s.start()


class _FakeSntpServer(threading.Thread):
    """Answers one SNTP query with a fixed clock offset."""

    def __init__(self, offset_s: float) -> None:
        super().__init__(daemon=True)
        self.offset = offset_s
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(("127.0.0.1", 0))
        self.port = self.sock.getsockname()[1]
        self.sock.settimeout(5)

    def run(self) -> None:
        try:
            data, addr = self.sock.recvfrom(48)
        except OSError:
            return
        now = time.time() + self.offset + ntp.NTP_UNIX_DELTA
        resp = bytearray(48)
        resp[0] = (4 << 3) | 4  # VN=4, mode=server
        resp[24:32] = data[40:48]  # originate := client transmit
        for off in (32, 40):  # receive + transmit timestamps
            struct.pack_into(">I", resp, off, int(now))
            struct.pack_into(">I", resp, off + 4, int((now % 1) * (1 << 32)))
        self.sock.sendto(bytes(resp), addr)
        self.sock.close()


class TestNtp:
    def test_offset_measured(self):
        srv = _FakeSntpServer(offset_s=5.0)
        srv.start()
        off = ntp.query_offset("127.0.0.1", port=srv.port, timeout=5)
        assert abs(off - 5.0) < 0.5

    def test_sync_installs_walltime_offset(self):
        srv = _FakeSntpServer(offset_s=-3.0)
        srv.start()
        assert ntp.sync(["127.0.0.1"], port=srv.port, timeout=5)
        assert ntp.is_synced()
        assert abs((ntp.walltime() - time.time()) + 3.0) < 0.5

    def test_sync_unreachable_returns_false(self):
        assert not ntp.sync(["127.0.0.1"], port=1, timeout=0.3)
        assert not ntp.is_synced()


class TestEdgeMqttConnectType:
    def test_edgesink_edgesrc_over_mqtt(self, broker):
        from nnstreamer_tpu_torch.edge.pubsub import EdgeSink, EdgeSrc

        n = 3
        send = Pipeline(device="cpu").chain(
            VideoTestSrc(width=8, height=8, **{"num-frames": n}),
            TensorConverter(),
            EdgeSink(port=broker.port, **{"connect-type": "MQTT", "topic": "e/t"}),
        )
        sink = TensorSink()
        recv = Pipeline(device="cpu").chain(
            EdgeSrc(**{"connect-type": "MQTT", "dest-port": broker.port,
                       "topic": "e/t"}),
            sink,
        )
        ex = recv.start()
        time.sleep(0.3)
        send.run(timeout=30)
        assert ex.wait(timeout=30)
        recv.stop()
        assert sink.rendered == n

    def test_unknown_connect_type_rejected(self):
        from nnstreamer_tpu_torch.edge.pubsub import EdgeSink

        with pytest.raises(ValueError, match="connect-type"):
            EdgeSink(**{"connect-type": "AITT"})


class TestBrokerQoS:
    """QoS 1/2 PUBLISH from external 3.1.1 clients: the broker must strip
    the packet id before fan-out and acknowledge (round-1 advisory fix)."""

    def _raw_connect(self, broker):
        from nnstreamer_tpu_torch.edge import mqtt as m

        sock = socket.create_connection(("127.0.0.1", broker.port), timeout=5)
        var = (
            m._string("MQTT") + bytes([4]) + bytes([0x02])
            + __import__("struct").pack(">H", 60)
        )
        sock.sendall(m._packet(m.CONNECT, 0, var + m._string("raw-qos")))
        ptype, _, payload = m._read_packet(sock)
        assert ptype == m.CONNACK and payload[1] == 0
        return sock

    @pytest.mark.parametrize("qos", [1, 2])
    def test_qos_publish_stripped_and_acked(self, broker, qos):
        import struct

        from nnstreamer_tpu_torch.edge import mqtt as m

        sub = MqttClient(port=broker.port).connect()
        sub.subscribe("qos/t")
        time.sleep(0.1)
        sock = self._raw_connect(broker)
        body = m._string("qos/t") + struct.pack(">H", 77) + b"payload!"
        sock.sendall(m._packet(m.PUBLISH, qos << 1, body))
        # broker acknowledges: PUBACK for qos1, PUBREC for qos2
        ptype, _, ack = m._read_packet(sock)
        assert ptype == (m.PUBACK if qos == 1 else m.PUBREC)
        assert struct.unpack(">H", ack[:2])[0] == 77
        if qos == 2:
            sock.sendall(m._packet(m.PUBREL, 2, struct.pack(">H", 77)))
            ptype, _, comp = m._read_packet(sock)
            assert ptype == m.PUBCOMP
        # subscriber receives the CLEAN payload (no packet-id bytes)
        got = sub.recv(timeout=5)
        assert got == ("qos/t", b"payload!")
        sock.close()
        sub.close()
