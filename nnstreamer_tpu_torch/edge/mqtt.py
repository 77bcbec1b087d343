"""Minimal MQTT 3.1.1 client + in-process broker (QoS 0).

Reference: gst/mqtt/mqttsink.c / mqttsrc.c publish/subscribe GstBuffers via
paho-mqtt-c against an external broker (mqttsink.c:29). This framework
vendors the protocol subset those elements actually use — CONNECT/CONNACK,
PUBLISH (QoS 0), SUBSCRIBE/SUBACK with +/# topic filters, PING, DISCONNECT
— as a dependency-free stdlib-socket client, plus a tiny broker so
single-host tests and demos run self-contained (the reference's test suite
skips when no broker is installed, tests/check_broker.sh; ours never has
to). Point the client at any real MQTT 3.1.1 broker (mosquitto, EMQX) for
production fan-out.

Wire format notes (MQTT 3.1.1, OASIS spec): fixed header = packet type
nibble + flags nibble, then varint "remaining length"; strings are
big-endian u16-length-prefixed UTF-8.
"""

from __future__ import annotations

import queue as queue_mod
import socket
import struct
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

CONNECT, CONNACK, PUBLISH, SUBSCRIBE, SUBACK, UNSUBSCRIBE, UNSUBACK = (
    1, 2, 3, 8, 9, 10, 11,
)
PUBACK, PUBREC, PUBREL, PUBCOMP = 4, 5, 6, 7
PINGREQ, PINGRESP, DISCONNECT = 12, 13, 14

DEFAULT_PORT = 1883


class MqttError(RuntimeError):
    pass


# -- encoding helpers -------------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n % 128
        n //= 128
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _string(s: str) -> bytes:
    b = s.encode()
    return struct.pack(">H", len(b)) + b


def _packet(ptype: int, flags: int, payload: bytes) -> bytes:
    return bytes([(ptype << 4) | flags]) + _varint(len(payload)) + payload


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise MqttError("connection closed")
        buf += chunk
    return buf


def _read_packet(sock: socket.socket) -> Tuple[int, int, bytes]:
    head = _read_exact(sock, 1)[0]
    length, mult = 0, 1
    for _ in range(4):
        b = _read_exact(sock, 1)[0]
        length += (b & 0x7F) * mult
        if not (b & 0x80):
            break
        mult *= 128
    else:
        raise MqttError("malformed remaining-length")
    payload = _read_exact(sock, length) if length else b""
    return head >> 4, head & 0x0F, payload


def topic_matches(pattern: str, topic: str) -> bool:
    """MQTT filter match: '+' one level, '#' rest (must be last)."""
    pp = pattern.split("/")
    tp = topic.split("/")
    for i, p in enumerate(pp):
        if p == "#":
            return i == len(pp) - 1
        if i >= len(tp):
            return False
        if p != "+" and p != tp[i]:
            return False
    return len(pp) == len(tp)


# -- client -----------------------------------------------------------------

class MqttClient:
    """QoS-0 client. on_message(topic, payload) runs on the reader thread;
    alternatively recv() pulls from an internal queue."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = DEFAULT_PORT,
        client_id: str = "",
        keepalive: int = 60,
        on_message: Optional[Callable[[str, bytes], None]] = None,
    ) -> None:
        self.host, self.port = host, port
        self.client_id = client_id or f"nns-tpu-{id(self):x}"
        self.keepalive = keepalive
        self.on_message = on_message
        self._sock: Optional[socket.socket] = None
        self._send_lock = threading.Lock()
        self._queue: "queue_mod.Queue" = queue_mod.Queue(maxsize=1024)
        self._reader: Optional[threading.Thread] = None
        self._pinger: Optional[threading.Thread] = None
        self._running = threading.Event()
        self._packet_id = 0

    # -- lifecycle
    def connect(self, timeout: float = 10.0) -> "MqttClient":
        sock = socket.create_connection((self.host, self.port), timeout=timeout)
        sock.settimeout(None)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        var = (
            _string("MQTT") + bytes([4])  # protocol level 3.1.1
            + bytes([0x02])  # clean session
            + struct.pack(">H", self.keepalive)
        )
        sock.sendall(_packet(CONNECT, 0, var + _string(self.client_id)))
        ptype, _, payload = _read_packet(sock)
        if ptype != CONNACK or len(payload) < 2 or payload[1] != 0:
            sock.close()
            raise MqttError(f"CONNACK refused: {payload!r}")
        self._sock = sock
        self._running.set()
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()
        if self.keepalive:
            self._pinger = threading.Thread(target=self._ping_loop, daemon=True)
            self._pinger.start()
        return self

    def close(self) -> None:
        self._running.clear()
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                with self._send_lock:
                    sock.sendall(_packet(DISCONNECT, 0, b""))
            except OSError:
                pass
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            sock.close()
        if self._reader is not None:
            self._reader.join(timeout=2)

    # -- ops
    def publish(self, topic: str, payload: bytes) -> None:
        sock = self._sock
        if sock is None:
            raise MqttError("not connected")
        pkt = _packet(PUBLISH, 0, _string(topic) + payload)
        with self._send_lock:
            sock.sendall(pkt)

    def subscribe(self, topic_filter: str) -> None:
        sock = self._sock
        if sock is None:
            raise MqttError("not connected")
        self._packet_id = (self._packet_id % 0xFFFF) + 1
        payload = struct.pack(">H", self._packet_id) + _string(topic_filter) + bytes([0])
        with self._send_lock:
            sock.sendall(_packet(SUBSCRIBE, 0x02, payload))

    def recv(self, timeout: Optional[float] = None) -> Optional[Tuple[str, bytes]]:
        """Next (topic, payload), or None on timeout."""
        try:
            return self._queue.get(timeout=timeout)
        except queue_mod.Empty:
            return None

    # -- loops
    def _read_loop(self) -> None:
        try:
            while self._running.is_set():
                sock = self._sock
                if sock is None:
                    return
                ptype, _flags, payload = _read_packet(sock)
                if ptype == PUBLISH:
                    tlen = struct.unpack(">H", payload[:2])[0]
                    topic = payload[2 : 2 + tlen].decode()
                    body = payload[2 + tlen :]
                    if self.on_message is not None:
                        self.on_message(topic, body)
                    else:
                        if self._queue.full():  # drop-oldest backpressure
                            try:
                                self._queue.get_nowait()
                            except queue_mod.Empty:
                                pass
                        self._queue.put((topic, body))
                # SUBACK/PINGRESP need no action at QoS 0
        except (MqttError, OSError):
            pass

    def _ping_loop(self) -> None:
        interval = max(self.keepalive / 2.0, 1.0)
        while self._running.is_set():
            time.sleep(interval)
            sock = self._sock
            if sock is None:
                return
            try:
                with self._send_lock:
                    sock.sendall(_packet(PINGREQ, 0, b""))
            except OSError:
                return


# -- broker -----------------------------------------------------------------

class MqttBroker:
    """In-process QoS-0 broker: CONNECT handshake, SUBSCRIBE bookkeeping,
    PUBLISH fan-out with wildcard matching. Port 0 = ephemeral."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self.host = host
        self._listen = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listen.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listen.bind((host, port))
        self._listen.listen(32)
        self.port = self._listen.getsockname()[1]
        self._lock = threading.Lock()
        # sock -> (send_lock, [topic filters])
        self._clients: Dict[socket.socket, Tuple[threading.Lock, List[str]]] = {}
        self._running = threading.Event()
        self._running.set()
        self._acceptor = threading.Thread(target=self._accept_loop, daemon=True)
        self._acceptor.start()

    def close(self) -> None:
        self._running.clear()
        try:
            self._listen.close()
        except OSError:
            pass
        with self._lock:
            socks = list(self._clients)
            self._clients.clear()
        for s in socks:
            try:
                s.close()
            except OSError:
                pass

    def _accept_loop(self) -> None:
        while self._running.is_set():
            try:
                sock, _ = self._listen.accept()
            except OSError:
                return
            threading.Thread(
                target=self._client_loop, args=(sock,), daemon=True
            ).start()

    def _client_loop(self, sock: socket.socket) -> None:
        # All writes to this socket go through send_lock: _fanout delivers
        # PUBLISHes from publisher threads concurrently with the acks sent
        # here, and interleaved sendall calls would corrupt MQTT framing.
        send_lock = threading.Lock()

        def _send(pkt: bytes) -> None:
            with send_lock:
                sock.sendall(pkt)

        try:
            ptype, _, _payload = _read_packet(sock)
            if ptype != CONNECT:
                sock.close()
                return
            with self._lock:
                self._clients[sock] = (send_lock, [])
            _send(_packet(CONNACK, 0, bytes([0, 0])))
            while self._running.is_set():
                ptype, flags, payload = _read_packet(sock)
                if ptype == PUBLISH:
                    qos = (flags >> 1) & 0x3
                    tlen = struct.unpack(">H", payload[:2])[0]
                    topic = payload[2 : 2 + tlen].decode()
                    if qos:
                        # QoS 1/2 publishes carry a packet id after the
                        # topic; strip it before fan-out and acknowledge
                        # (delivery to subscribers stays at-most-once).
                        pid = payload[2 + tlen : 4 + tlen]
                        payload = payload[: 2 + tlen] + payload[4 + tlen :]
                        _send(_packet(PUBACK if qos == 1 else PUBREC, 0, pid))
                    self._fanout(topic, payload, exclude=None)
                elif ptype == PUBREL:
                    _send(_packet(PUBCOMP, 0, payload[:2]))
                elif ptype == SUBSCRIBE:
                    pid = payload[:2]
                    pos, filters = 2, []
                    while pos < len(payload):
                        flen = struct.unpack(">H", payload[pos : pos + 2])[0]
                        filters.append(payload[pos + 2 : pos + 2 + flen].decode())
                        pos += 2 + flen + 1  # + requested QoS byte
                    with self._lock:
                        if sock in self._clients:
                            self._clients[sock][1].extend(filters)
                    _send(_packet(SUBACK, 0, pid + bytes([0] * len(filters))))
                elif ptype == PINGREQ:
                    _send(_packet(PINGRESP, 0, b""))
                elif ptype == DISCONNECT:
                    break
        except (MqttError, OSError):
            pass
        finally:
            with self._lock:
                self._clients.pop(sock, None)
            try:
                sock.close()
            except OSError:
                pass

    def _fanout(self, topic: str, publish_payload: bytes, exclude) -> None:
        pkt = _packet(PUBLISH, 0, publish_payload)
        with self._lock:
            targets = [
                (s, lk)
                for s, (lk, filters) in self._clients.items()
                if s is not exclude and any(topic_matches(f, topic) for f in filters)
            ]
        for s, lk in targets:
            try:
                with lk:
                    s.sendall(pkt)
            except OSError:
                pass  # dead subscriber: its loop cleans up
