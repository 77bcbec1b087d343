"""Query connect-type transports beyond raw TCP: MQTT and HYBRID.

Reference: tensor_query_common.c:35-42 — the query elements accept
connect-type TCP / MQTT / HYBRID (/ AITT, vendor-gated). Semantics:

- ``MQTT``: request/reply payloads ride the broker. Client publishes to
  ``<topic>/req/<client_id>`` and subscribes ``<topic>/rep/<client_id>``;
  the server subscribes ``<topic>/req/+`` and replies on the rep topic of
  the requesting client. dest-host/dest-port address the *broker*.
- ``HYBRID``: MQTT for discovery/control only, raw TCP for bulk tensors
  (the reference's broker-assisted mode). The server listens on an
  ephemeral TCP port and answers ``<topic>/whois`` discovery requests with
  ``host:port``; clients then speak plain TCP.
- ``SHM``: co-located processes skip sockets entirely — request and
  reply each ride one SPSC shared-memory ring (edge/shm.py over
  native/nns_shm.cpp), one memcpy in, one out, no syscall per frame on
  the hot path. Single client by design (the rings are SPSC); the
  ``port`` property keys the segment names.

All adapters expose the same surface as the native TCP transport
(connect/listen/send/recv/close/peer_count) so the query elements stay
transport-agnostic, like the reference elements over nns_edge handles.
Fleet mode (``tensor_query_client hosts=...``, docs/edge-serving.md
"Running a fleet") builds one adapter per endpoint through the same
factory: for MQTT each ``host:port`` names a broker, for SHM the port
keys the ring pair (host ignored) — so failover/hedging compose with
every connect-type, though the health scorer's re-resolve fast-path
(``UnresolvableError``) only applies to the TCP family.
"""

from __future__ import annotations

import itertools
import os
import queue as queue_mod
import threading
import time
from typing import Optional, Tuple

from nnstreamer_tpu_torch.edge.mqtt import MqttClient, MqttError
from nnstreamer_tpu_torch.edge.transport import TransportError, make_transport

_client_seq = itertools.count(1)


class MqttQueryTransport:
    """Request/reply over an MQTT broker, one topic pair per client."""

    def __init__(self, topic: str = "nns-query") -> None:
        self.topic = topic.rstrip("/")
        self._mqtt: Optional[MqttClient] = None
        self._queue: "queue_mod.Queue" = queue_mod.Queue(maxsize=1024)
        self._server = False
        self._cid = f"c{os.getpid()}-{next(_client_seq)}"

    # -- server side -------------------------------------------------------
    def listen(self, host: str, port: int) -> int:
        port = port or 1883
        try:
            self._mqtt = MqttClient(
                host, port, on_message=self._on_message
            ).connect()
        except (MqttError, OSError) as exc:
            raise TransportError(f"cannot reach MQTT broker {host}:{port}: {exc}")
        self._server = True
        self._mqtt.subscribe(f"{self.topic}/req/+")
        return port

    # -- client side -------------------------------------------------------
    def connect(self, host: str, port: int) -> None:
        port = port or 1883
        try:
            self._mqtt = MqttClient(
                host, port, on_message=self._on_message
            ).connect()
        except (MqttError, OSError) as exc:
            raise TransportError(f"cannot reach MQTT broker {host}:{port}: {exc}")
        self._mqtt.subscribe(f"{self.topic}/rep/{self._cid}")

    # -- shared ------------------------------------------------------------
    def _on_message(self, topic: str, payload: bytes) -> None:
        cid = topic.rsplit("/", 1)[-1]
        if self._queue.full():  # drop-oldest backpressure, like the client
            try:
                self._queue.get_nowait()
            except queue_mod.Empty:
                pass
        self._queue.put((cid, payload))

    def send(self, cid, payload: bytes) -> None:
        if self._mqtt is None:
            raise TransportError("mqtt transport not connected")
        if self._server:
            dest = f"{self.topic}/rep/{cid}"
        else:
            dest = f"{self.topic}/req/{self._cid}"
        try:
            self._mqtt.publish(dest, payload)
        except (MqttError, OSError) as exc:
            raise TransportError(f"mqtt publish failed: {exc}")

    def recv(self, timeout: Optional[float] = None) -> Optional[Tuple[str, bytes]]:
        try:
            return self._queue.get(timeout=timeout)
        except queue_mod.Empty:
            return None

    def peer_count(self) -> int:
        return 1 if self._mqtt is not None else 0

    def close(self) -> None:
        if self._mqtt is not None:
            self._mqtt.close()
            self._mqtt = None


class HybridServerTransport:
    """TCP data plane + MQTT discovery: answers whois with host:port.

    ``max_conns``/``reject_payload`` (set by the serversrc's admission
    layer before listen) pass through to the TCP data plane; the python
    transport enforces them, the native one admits at request level
    only."""

    max_conns = 0
    reject_payload = None

    def __init__(self, topic: str = "nns-query", data_host: str = "127.0.0.1",
                 data_port: int = 0) -> None:
        self.topic = topic.rstrip("/")
        self.data_host = data_host
        self.data_port = data_port
        self._tcp = None
        self._disc: Optional[MqttClient] = None
        self._addr = ""

    def listen(self, host: str, port: int) -> int:
        # conn caps need the python transport's acceptor-side rejection
        self._tcp = make_transport(prefer_native=not self.max_conns)
        if self.max_conns:
            self._tcp.max_conns = self.max_conns
            self._tcp.reject_payload = self.reject_payload
        tcp_port = self._tcp.listen(self.data_host, self.data_port)
        self._addr = f"{self.data_host}:{tcp_port}"
        try:
            self._disc = MqttClient(
                host, port or 1883, on_message=self._on_whois
            ).connect()
        except (MqttError, OSError) as exc:
            self._tcp.close()
            self._tcp = None
            raise TransportError(
                f"cannot reach MQTT broker {host}:{port or 1883}: {exc}"
            )
        self._disc.subscribe(f"{self.topic}/whois")
        # announce once proactively for clients that subscribed early
        self._announce()
        return tcp_port

    def _announce(self) -> None:
        try:
            self._disc.publish(f"{self.topic}/host", self._addr.encode())
        except (MqttError, OSError):
            pass  # discovery is best-effort; TCP plane keeps serving

    def _on_whois(self, topic: str, payload: bytes) -> None:
        self._announce()

    @property
    def rejected_conns(self) -> int:
        return getattr(self._tcp, "rejected_conns", 0) if self._tcp else 0

    def send(self, cid, payload: bytes) -> None:
        self._tcp.send(cid, payload)

    def recv(self, timeout: Optional[float] = None):
        return self._tcp.recv(timeout=timeout)

    def peer_count(self) -> int:
        return self._tcp.peer_count() if self._tcp is not None else 0

    def close(self) -> None:
        if self._disc is not None:
            self._disc.close()
            self._disc = None
        if self._tcp is not None:
            self._tcp.close()
            self._tcp = None


class ShmServerTransport:
    """connect-type=SHM server side: two SPSC rings for ONE co-located
    client — ``/nns-shm-<port>`` carries requests (client writes, server
    reads), ``/nns-shm-<port+1>`` carries replies. The server creates
    both segments (it starts first and owns their lifetime: closing
    marks them closed so the client drains then sees EOS)."""

    def __init__(self, capacity: Optional[int] = None) -> None:
        from nnstreamer_tpu_torch.edge.shm import DEFAULT_CAPACITY, ShmTransport

        cap = capacity or DEFAULT_CAPACITY
        self._req = ShmTransport(cap)
        self._rep = ShmTransport(cap)
        self._port = 0

    def listen(self, host: str, port: int) -> int:
        port = port or (os.getpid() % 50000 + 10000)
        self._req.listen(host, port)
        try:
            self._rep.listen(host, port + 1)
        except TransportError:
            self._req.close()
            raise
        self._port = port
        return port

    def send(self, cid, payload: bytes) -> None:
        self._rep.send(0, payload)

    def recv(self, timeout: Optional[float] = None):
        got = self._req.recv(timeout=timeout)
        if got is None:
            return None
        # one fixed client id: the rings are SPSC, so "which client" is
        # structural — 1 keeps the serversink's client_id path uniform
        return (1, got[1])

    def peer_count(self) -> int:
        return self._rep.peer_count()

    def close(self) -> None:
        self._req.close()
        self._rep.close()


class ShmClientTransport:
    """connect-type=SHM client side: opens the server's ring pair
    (requests written to ``<port>``, replies read from ``<port+1>``)."""

    def __init__(self) -> None:
        self._req = None
        self._rep = None

    def connect(self, host: str, port: int) -> None:
        from nnstreamer_tpu_torch.edge.shm import ShmTransport

        req = ShmTransport()
        rep = ShmTransport()
        req.connect(host, port)
        try:
            rep.connect(host, port + 1)
        except TransportError:
            req.close()
            raise
        self._req, self._rep = req, rep

    def send(self, cid, payload: bytes) -> None:
        if self._req is None:
            raise TransportError("shm query transport not connected")
        self._req.send(0, payload)

    def recv(self, timeout: Optional[float] = None):
        if self._rep is None:
            raise TransportError("shm query transport not connected")
        return self._rep.recv(timeout=timeout)

    def peer_count(self) -> int:
        return 1 if self._req is not None else 0

    def close(self) -> None:
        if self._req is not None:
            self._req.close()
            self._req = None
        if self._rep is not None:
            self._rep.close()
            self._rep = None


class HybridClientTransport:
    """Discover the server's TCP address over MQTT, then speak TCP."""

    DISCOVERY_TIMEOUT = 5.0

    def __init__(self, topic: str = "nns-query") -> None:
        self.topic = topic.rstrip("/")
        self._tcp = None

    def connect(self, host: str, port: int) -> None:
        try:
            disc = MqttClient(host, port or 1883).connect()
        except (MqttError, OSError) as exc:
            raise TransportError(
                f"cannot reach MQTT broker {host}:{port or 1883}: {exc}"
            )
        try:
            disc.subscribe(f"{self.topic}/host")
            deadline = time.monotonic() + self.DISCOVERY_TIMEOUT
            addr = None
            while time.monotonic() < deadline:
                try:
                    disc.publish(f"{self.topic}/whois", b"?")
                except (MqttError, OSError) as exc:
                    raise TransportError(f"discovery publish failed: {exc}")
                got = disc.recv(timeout=0.5)
                if got is not None:
                    addr = got[1].decode()
                    break
            if addr is None:
                raise TransportError(
                    f"no query server answered whois on {self.topic!r} "
                    f"within {self.DISCOVERY_TIMEOUT}s"
                )
        finally:
            disc.close()
        h, _, p = addr.rpartition(":")
        if not h or not p.isdigit():
            raise TransportError(
                f"malformed discovery announcement {addr!r} on "
                f"{self.topic}/host (expected host:port)"
            )
        self._tcp = make_transport()
        self._tcp.connect(h, int(p))

    def send(self, cid, payload: bytes) -> None:
        self._tcp.send(cid, payload)

    def recv(self, timeout: Optional[float] = None):
        return self._tcp.recv(timeout=timeout)

    def peer_count(self) -> int:
        return self._tcp.peer_count() if self._tcp is not None else 0

    def close(self) -> None:
        if self._tcp is not None:
            self._tcp.close()
            self._tcp = None
