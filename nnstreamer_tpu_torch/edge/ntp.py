"""SNTP client: cross-device clock alignment for MQTT pub/sub.

Reference: gst/mqtt/ntputil.c + Documentation/synchronization-in-mqtt-
elements.md — mqttsink stamps messages with an NTP-derived epoch so
mqttsrc on another device can rebase timestamps onto its own clock.
This is a dependency-free SNTPv4 (RFC 4330) unicast query: one 48-byte
UDP exchange → clock offset vs the server. ``walltime()`` returns local
epoch time corrected by the last measured offset; with no server
configured/reachable it falls back to the local clock (same degradation
the reference has when its NTP pool is unreachable).
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from typing import Optional, Sequence

NTP_PORT = 123
# seconds between the NTP epoch (1900) and the unix epoch (1970)
NTP_UNIX_DELTA = 2208988800

_lock = threading.Lock()
_offset: float = 0.0
_synced: bool = False


def query_offset(host: str, port: int = NTP_PORT, timeout: float = 2.0) -> float:
    """One SNTP exchange → (server_time - local_time) in seconds.
    Raises OSError on network failure."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.settimeout(timeout)
    try:
        # LI=0 VN=4 Mode=3 (client)
        pkt = bytearray(48)
        pkt[0] = (4 << 3) | 3
        t1 = time.time()
        origin = t1 + NTP_UNIX_DELTA
        struct.pack_into(">I", pkt, 40, int(origin))
        struct.pack_into(">I", pkt, 44, int((origin % 1) * (1 << 32)))
        sock.sendto(bytes(pkt), (host, port))
        data, _ = sock.recvfrom(48)
        t4 = time.time()
        if len(data) < 48:
            raise OSError(f"short NTP response ({len(data)} bytes)")

        def ts(offset: int) -> float:
            secs, frac = struct.unpack_from(">II", data, offset)
            return secs + frac / (1 << 32) - NTP_UNIX_DELTA

        t2 = ts(32)  # receive timestamp
        t3 = ts(40)  # transmit timestamp
        # RFC 4330 offset: ((t2 - t1) + (t3 - t4)) / 2
        return ((t2 - t1) + (t3 - t4)) / 2.0
    finally:
        sock.close()


def sync(
    servers: Sequence[str] = ("pool.ntp.org",),
    port: int = NTP_PORT,
    timeout: float = 2.0,
) -> bool:
    """Measure and install the global offset from the first reachable
    server. Returns True on success, False if none answered."""
    global _offset, _synced
    for host in servers:
        try:
            off = query_offset(host, port, timeout)
        except OSError:
            continue
        with _lock:
            _offset = off
            _synced = True
        return True
    return False


def set_offset(offset: float) -> None:
    """Install an externally-determined offset (tests; pre-synced hosts)."""
    global _offset, _synced
    with _lock:
        _offset = offset
        _synced = True


def reset() -> None:
    global _offset, _synced
    with _lock:
        _offset = 0.0
        _synced = False


def is_synced() -> bool:
    return _synced


def walltime() -> float:
    """Epoch seconds on the shared (NTP) timescale."""
    with _lock:
        return time.time() + _offset
