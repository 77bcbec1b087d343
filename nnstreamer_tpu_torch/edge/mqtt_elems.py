"""mqttsink / mqttsrc: pub/sub tensor streams through an MQTT broker.

Reference: gst/mqtt/mqttsink.c (1406 LoC) / mqttsrc.c (1423) — publish
arbitrary buffers to ``pub-topic``, subscribe on ``sub-topic``, with the
message header carrying the sender's NTP-aligned send time so receivers on
other devices can rebase timestamps (Documentation/synchronization-in-
mqtt-elements.md, gst/mqtt/ntputil.c → edge/ntp.py here).

Message layout: ``<B d q`` (version, sent-walltime epoch-s on the NTP
timescale, reserved) + the edge frame codec (edge/serialize.py — the caps
equivalent travels in the flexible-tensor headers, like the reference
smuggles caps in its message header). Broker: any MQTT 3.1.1 QoS-0 broker;
the in-repo ``edge.mqtt.MqttBroker`` makes tests/demos self-contained.

Received frames carry meta: ``mqtt_sent_time`` (sender walltime) and
``mqtt_transit_s`` (receiver walltime − send time; ≈ network+broker
latency when both ends are NTP-synced).
"""

from __future__ import annotations

import struct
from typing import Optional

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.edge import ntp
from nnstreamer_tpu_torch.edge.mqtt import DEFAULT_PORT, MqttClient, MqttError
from nnstreamer_tpu_torch.edge.serialize import decode_message, encode_message
from nnstreamer_tpu_torch.elements.base import (
    parse_bool,
    ElementError,
    PropSpec,
    Sink,
    Source,
    Spec,
)
from nnstreamer_tpu_torch.tensors.frame import EOS, EOS_FRAME, Frame
from nnstreamer_tpu_torch.tensors.spec import TensorFormat, TensorsSpec

_MSG_HDR = struct.Struct("<Bdq")
_MSG_VERSION = 1


def _wrap(payload: bytes) -> bytes:
    return _MSG_HDR.pack(_MSG_VERSION, ntp.walltime(), 0) + payload


def _unwrap(data: bytes):
    if len(data) < _MSG_HDR.size:
        raise ValueError(f"mqtt message too short: {len(data)}")
    version, sent, _ = _MSG_HDR.unpack_from(data)
    if version != _MSG_VERSION:
        raise ValueError(f"unsupported mqtt message version {version}")
    return sent, data[_MSG_HDR.size :]


def _maybe_ntp_sync(element, enabled: bool) -> None:
    """Best-effort one-shot SNTP sync (reference resyncs periodically; the
    offset is process-global so one sync serves all elements)."""
    if not enabled or ntp.is_synced():
        return
    servers = str(element.get_property("ntp-servers", "pool.ntp.org"))
    ntp.sync([s for s in servers.split(",") if s], timeout=2.0)


@registry.element("mqttsink")
class MqttSink(Sink):
    """Props: host, port (broker), pub-topic (required), ntp-sync (bool),
    ntp-servers (comma list), client-id."""

    FACTORY_NAME = "mqttsink"

    PROPERTIES = {
        "host": PropSpec("str", "127.0.0.1", desc="broker host"),
        "port": PropSpec("int", 1883, desc="broker port"),
        "pub-topic": PropSpec("str", "", desc="required"),
        "ntp-sync": PropSpec("bool", False),
        "ntp-servers": PropSpec("str", "pool.ntp.org", desc="comma list"),
        "client-id": PropSpec("str", ""),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.host = str(self.get_property("host", "127.0.0.1"))
        self.port = int(self.get_property("port", DEFAULT_PORT))
        self.topic = str(self.get_property("pub-topic", ""))
        if not self.topic:
            raise ValueError(f"{self.name}: mqttsink needs pub-topic=")
        self.ntp_sync = parse_bool(self.get_property("ntp-sync", False))
        self._client: Optional[MqttClient] = None

    def start(self) -> None:
        _maybe_ntp_sync(self, self.ntp_sync)
        try:
            self._client = MqttClient(
                self.host, self.port,
                client_id=str(self.get_property("client-id", "")),
            ).connect()
        except (MqttError, OSError) as exc:
            raise ElementError(
                f"{self.name}: cannot reach MQTT broker "
                f"{self.host}:{self.port}: {exc}"
            ) from exc

    def stop(self) -> None:
        client, self._client = self._client, None
        if client is not None:
            try:
                client.publish(self.topic, _wrap(encode_message(EOS_FRAME)))
            except (MqttError, OSError):
                pass
            client.close()

    def render(self, frame: Frame) -> None:
        frame = self.host_frame(frame)
        if self._client is None:
            raise ElementError(f"{self.name}: not started")
        try:
            self._client.publish(self.topic, _wrap(encode_message(frame)))
        except (MqttError, OSError) as exc:
            raise ElementError(f"{self.name}: publish failed: {exc}") from exc

    def on_eos(self) -> None:
        if self._client is not None:
            try:
                self._client.publish(self.topic, _wrap(encode_message(EOS_FRAME)))
            except (MqttError, OSError):
                pass


@registry.element("mqttsrc")
class MqttSrc(Source):
    """Props: host, port (broker), sub-topic (required, wildcards ok),
    ntp-sync, ntp-servers, client-id."""

    FACTORY_NAME = "mqttsrc"

    PROPERTIES = {
        "host": PropSpec("str", "127.0.0.1", desc="broker host"),
        "port": PropSpec("int", 1883, desc="broker port"),
        "sub-topic": PropSpec("str", "", desc="required; wildcards ok"),
        "ntp-sync": PropSpec("bool", False),
        "ntp-servers": PropSpec("str", "pool.ntp.org", desc="comma list"),
        "client-id": PropSpec("str", ""),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.host = str(self.get_property("host", "127.0.0.1"))
        self.port = int(self.get_property("port", DEFAULT_PORT))
        self.topic = str(self.get_property("sub-topic", ""))
        if not self.topic:
            raise ValueError(f"{self.name}: mqttsrc needs sub-topic=")
        self.ntp_sync = parse_bool(self.get_property("ntp-sync", False))
        self._client: Optional[MqttClient] = None

    def output_spec(self) -> Spec:
        return TensorsSpec(format=TensorFormat.FLEXIBLE)

    def start(self) -> None:
        _maybe_ntp_sync(self, self.ntp_sync)
        try:
            self._client = MqttClient(
                self.host, self.port,
                client_id=str(self.get_property("client-id", "")),
            ).connect()
            self._client.subscribe(self.topic)
        except (MqttError, OSError) as exc:
            raise ElementError(
                f"{self.name}: cannot reach MQTT broker "
                f"{self.host}:{self.port}: {exc}"
            ) from exc

    def stop(self) -> None:
        client, self._client = self._client, None
        if client is not None:
            client.close()

    def generate(self):
        got = self._client.recv(timeout=0.1)
        if got is None:
            return None
        _topic, data = got
        try:
            sent, payload = _unwrap(data)
            msg = decode_message(payload)
        except ValueError as exc:
            raise ElementError(f"{self.name}: bad message: {exc}") from exc
        if isinstance(msg, EOS):
            return EOS_FRAME
        now = ntp.walltime()
        return msg.with_meta(mqtt_sent_time=sent, mqtt_transit_s=now - sent)
