"""edgesink / edgesrc: publish/subscribe tensor streams between pipelines.

The counterpart of ``nnstreamer_tpu/edge/pubsub.py``, on the same wire.

Reference: gst/edge/edge_{sink,src}.c — thin wrappers over nnstreamer-edge
pub/sub (TCP default, port 3000, edge_common.h:36-37). edgesink listens and
broadcasts every rendered frame to all connected subscribers; edgesrc
connects and emits whatever arrives. Unlike the query pair there is no
reply path and no client demux.
"""

from __future__ import annotations

from typing import List, Optional

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.edge.mqtt import MqttError
from nnstreamer_tpu_torch.edge.shm import MessageTooLarge
from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.edge.serialize import decode_message, encode_message
from nnstreamer_tpu_torch.edge.transport import TransportError, make_transport, transport_kind
from nnstreamer_tpu_torch.elements.base import (
    parse_bool,
    ElementError,
    NegotiationError,
    PropSpec,
    Sink,
    Source,
    Spec,
)
from nnstreamer_tpu_torch.tensors.frame import EOS, EOS_FRAME, Frame
from nnstreamer_tpu_torch.tensors.spec import TensorFormat, TensorsSpec

DEFAULT_PORT = 3000  # reference edge_common.h:36-37

_log = get_logger("edge.pubsub")


@registry.element("edgesink")
class EdgeSink(Sink):
    """Broadcast frames to all subscribers.

    Props: host (default 127.0.0.1), port (default 3000; 0 = ephemeral,
    read back via ``bound_port``), wait-connection (block first frame until
    a subscriber arrives, default false), connection-timeout (s).
    """

    FACTORY_NAME = "edgesink"

    PROPERTIES = {
        "host": PropSpec("str", "127.0.0.1"),
        "port": PropSpec("int", 3000, desc="0 = ephemeral"),
        "connect-type": PropSpec("enum", "TCP", ("TCP", "MQTT", "SHM")),
        "topic": PropSpec("str", "nns-edge"),
        "wait-connection": PropSpec("bool", False),
        "connection-timeout": PropSpec("float", 10.0),
        "shm-capacity": PropSpec("int", None, desc="SHM ring capacity"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.host = str(self.get_property("host", "127.0.0.1"))
        self.port = int(self.get_property("port", DEFAULT_PORT))
        self.connect_type = str(self.get_property("connect-type", "TCP")).upper()
        # MQTT mode (reference connect-type=MQTT): host/port address the
        # broker, frames publish to ``topic``
        self.topic = str(self.get_property("topic", "nns-edge"))
        self.wait_connection = parse_bool(
            self.get_property("wait-connection", False)
        )
        self.conn_timeout = float(self.get_property("connection-timeout", 10.0))
        self.bound_port: Optional[int] = None
        self._transport = None
        self._mqtt = None
        # the byte path (transport_kind): mqtt, or the transport's own
        self.transport = "mqtt" if self.connect_type == "MQTT" else "none"
        if self.connect_type not in ("TCP", "MQTT", "SHM"):
            raise ValueError(
                f"{self.name}: connect-type={self.connect_type} not built in "
                "(reference HYBRID/AITT are broker-vendor specific)"
            )

    def start(self) -> None:
        if self.connect_type == "MQTT":
            from nnstreamer_tpu_torch.edge.mqtt import MqttClient, MqttError

            try:
                self._mqtt = MqttClient(self.host, self.port).connect()
            except (MqttError, OSError) as exc:
                raise ElementError(
                    f"{self.name}: cannot reach MQTT broker "
                    f"{self.host}:{self.port}: {exc}"
                ) from exc
            return
        if self.connect_type == "SHM":
            from nnstreamer_tpu_torch.edge.shm import DEFAULT_CAPACITY, ShmTransport

            cap = int(self.get_property("shm-capacity", DEFAULT_CAPACITY))
            self._transport = ShmTransport(capacity=cap)
        else:
            self._transport = make_transport()
        self.bound_port = self._transport.listen(self.host, self.port)
        self.transport = transport_kind(self._transport)

    def stop(self) -> None:
        if self._mqtt is not None:
            try:
                self._mqtt.publish(self.topic, encode_message(EOS_FRAME))
            except (MqttError, OSError):
                pass  # broker already gone: teardown must not raise
            self._mqtt.close()
            self._mqtt = None
        if self._transport is not None:
            # subscribers see the stream end explicitly
            try:
                self._transport.send(0, encode_message(EOS_FRAME))
            except (TransportError, OSError):
                pass
            self._transport.close()
            self._transport = None

    def render(self, frame: Frame) -> None:
        frame = self.host_frame(frame)
        if self._mqtt is not None:
            try:
                self._mqtt.publish(self.topic, encode_message(frame))
            except (MqttError, OSError) as exc:
                raise ElementError(
                    f"{self.name}: MQTT publish failed: {exc}"
                ) from exc
            return
        if self.wait_connection and self._transport.peer_count() == 0:
            import time

            deadline = time.monotonic() + self.conn_timeout
            while (
                self._transport.peer_count() == 0
                and time.monotonic() < deadline
            ):
                time.sleep(0.01)
            if self._transport.peer_count() == 0:
                raise ElementError(
                    f"{self.name}: no subscriber within {self.conn_timeout}s"
                )
        try:
            self._transport.send(0, encode_message(frame))  # 0 = broadcast
        except (TransportError, OSError) as exc:
            if isinstance(exc, MessageTooLarge):
                # permanent misconfiguration: EVERY frame would drop —
                # fail the pipeline with the remedy, don't warn forever
                raise ElementError(f"{self.name}: {exc}") from exc
            # best-effort: one dead subscriber must not kill the stream —
            # but dropped frames must be visible, not silent
            _log.warning("%s: frame dropped: %s", self.name, exc)

    def on_eos(self) -> None:
        if self._mqtt is not None:
            try:
                self._mqtt.publish(self.topic, encode_message(EOS_FRAME))
            except (MqttError, OSError):
                pass
        if self._transport is not None:
            try:
                self._transport.send(0, encode_message(EOS_FRAME))
            except (TransportError, OSError):
                pass


@registry.element("edgesrc")
class EdgeSrc(Source):
    """Subscribe to an edgesink and emit its frames.

    Props: dest-host (default 127.0.0.1), dest-port (default 3000),
    connect-type=TCP (sockets), MQTT (broker pub/sub via ``topic``), or
    SHM (same-host native shared-memory ring, native/nns_shm.cpp —
    zero-socket fast path; single consumer).
    """

    FACTORY_NAME = "edgesrc"

    PROPERTIES = {
        "dest-host": PropSpec("str", "127.0.0.1"),
        "dest-port": PropSpec("int", 3000),
        "connect-type": PropSpec("enum", "TCP", ("TCP", "MQTT", "SHM")),
        "topic": PropSpec("str", "nns-edge"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.host = str(self.get_property("dest-host", "127.0.0.1"))
        self.port = int(self.get_property("dest-port", DEFAULT_PORT))
        self.connect_type = str(self.get_property("connect-type", "TCP")).upper()
        self.topic = str(self.get_property("topic", "nns-edge"))
        self._transport = None
        self._mqtt = None
        # the byte path (transport_kind): mqtt, or the transport's own
        self.transport = "mqtt" if self.connect_type == "MQTT" else "none"

    def output_spec(self) -> Spec:
        if self.connect_type not in ("TCP", "MQTT", "SHM"):
            raise NegotiationError(
                f"{self.name}: connect-type={self.connect_type} not built in"
            )
        return TensorsSpec(format=TensorFormat.FLEXIBLE)

    def start(self) -> None:
        if self.connect_type == "MQTT":
            from nnstreamer_tpu_torch.edge.mqtt import MqttClient, MqttError

            try:
                self._mqtt = MqttClient(self.host, self.port).connect()
                self._mqtt.subscribe(self.topic)
            except (MqttError, OSError) as exc:
                raise ElementError(
                    f"{self.name}: cannot reach MQTT broker "
                    f"{self.host}:{self.port}: {exc}"
                ) from exc
            return
        if self.connect_type == "SHM":
            from nnstreamer_tpu_torch.edge.shm import ShmTransport

            self._transport = ShmTransport()
        else:
            self._transport = make_transport()
        try:
            self._transport.connect(self.host, self.port)
        except (TransportError, OSError) as exc:
            raise ElementError(
                f"{self.name}: cannot reach edgesink {self.host}:{self.port}: "
                f"{exc}"
            ) from exc
        self.transport = transport_kind(self._transport)

    def stop(self) -> None:
        if self._mqtt is not None:
            self._mqtt.close()
            self._mqtt = None
        if self._transport is not None:
            self._transport.close()
            self._transport = None

    def generate(self):
        if self._mqtt is not None:
            got = self._mqtt.recv(timeout=0.1)
            if got is None:
                return None
            payload = got[1]
        else:
            got = self._transport.recv(timeout=0.1)
            if got is None:
                return None
            _, payload = got
            if not payload:
                return EOS_FRAME  # publisher went away
        msg = decode_message(payload)
        return EOS_FRAME if isinstance(msg, EOS) else msg
