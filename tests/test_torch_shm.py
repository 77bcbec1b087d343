"""The cases of ``tests/test_shm.py`` run through the port's edge
layer (``nnstreamer_tpu_torch.edge``) on the CPU, with ephemeral ports and
short timeouts, and shared-memory segment numbers drawn at random for
each test (:func:`_shm_port`: the reference's copies use fixed 41xxx
numbers, and other workers or a second checkout's run may hold segments at
the same time); ``tests/test_torch_edge_interop.py`` holds it against the
reference. The reference's notes follow.

Native shared-memory ring transport tests (native/nns_shm.cpp via
edge/shm.py) — the same-host zero-socket fast path of the among-device
layer. Includes a true cross-process producer (subprocess), wraparound
coverage, and the edgesink/edgesrc connect-type=SHM loopback."""

import os
import random
import subprocess
import sys
import threading

import numpy as np
import pytest

from nnstreamer_tpu_torch.edge.shm import ShmTransport, segment_name
from nnstreamer_tpu_torch.edge.transport import TransportError

def _shm_available() -> bool:
    try:
        from nnstreamer_tpu_torch.edge import shm as _shm

        _shm._get_lib()
        return True
    except Exception:  # build failed or sanitizer .so can't dlopen
        return False


pytestmark = pytest.mark.skipif(
    not _shm_available(),
    reason="native shm lib unavailable (toolchain, or sanitizer build "
           "without LD_PRELOAD)",
)


def _shm_port(span: int = 1) -> int:
    """A segment number that no segment holds yet, for ``span`` numbers
    from it: drawn at random, never from a fixed list, so tests running
    in parallel workers or in another checkout do not meet on one name."""
    rng = random.SystemRandom()
    while True:
        port = rng.randrange(20000, 60000)
        if not any(os.path.exists(f"/dev/shm{segment_name(port + i)}") for i in range(span)):
            return port


def _pair(capacity=64 * 1024):
    prod = ShmTransport(capacity=capacity)
    bound = prod.listen("", _shm_port())
    cons = ShmTransport()
    cons.connect("", bound)
    return prod, cons


def test_roundtrip_and_order(tmp_path):
    prod, cons = _pair()
    try:
        for i in range(32):
            prod.send(0, bytes([i]) * (i + 1))
        for i in range(32):
            cid, payload = cons.recv(timeout=2)
            assert payload == bytes([i]) * (i + 1)
    finally:
        cons.close()
        prod.close()


def test_wraparound_many_messages():
    """Messages much larger than capacity/N force repeated wrap markers."""
    prod, cons = _pair(capacity=8 * 1024)
    msgs = [os.urandom(700) for _ in range(200)]
    errs = []

    def pump():
        try:
            for m in msgs:
                prod.send(0, m, timeout=5)
        except Exception as exc:  # noqa: BLE001
            errs.append(exc)

    t = threading.Thread(target=pump, daemon=True)
    t.start()
    try:
        got = [cons.recv(timeout=5)[1] for _ in range(len(msgs))]
        assert got == msgs
        t.join(timeout=5)
        assert not errs
    finally:
        cons.close()
        prod.close()


def test_reader_count_and_timeout():
    prod = ShmTransport()
    port = prod.listen("", _shm_port())
    try:
        assert prod.peer_count() == 0
        cons = ShmTransport()
        cons.connect("", port)
        assert prod.peer_count() == 1
        assert cons.recv(timeout=0.05) is None  # empty ring times out
        cons.close()
        assert prod.peer_count() == 0
    finally:
        prod.close()


def test_close_drains_then_eos():
    prod, cons = _pair()
    prod.send(0, b"last")
    prod.close()  # marks closed + unlinks
    assert cons.recv(timeout=2) == (0, b"last")
    assert cons.recv(timeout=2) == (0, b"")  # closed + drained
    cons.close()


def test_large_message_grows_reader_buffer():
    prod, cons = _pair(capacity=32 * 1024 * 1024)
    big = os.urandom(9 * 1024 * 1024)  # > initial 4 MB reader buffer
    prod.send(0, big, timeout=10)
    got = cons.recv(timeout=10)
    assert got[1] == big
    cons.close()
    prod.close()


def test_oversized_message_rejected():
    prod, cons = _pair(capacity=8 * 1024)
    with pytest.raises(TransportError):
        prod.send(0, b"x" * (64 * 1024), timeout=1)
    cons.close()
    prod.close()


def test_connect_without_producer_fails():
    t = ShmTransport()
    with pytest.raises(TransportError, match="producer"):
        t.connect("", _shm_port())


def test_cross_process_consumer():
    """A different PROCESS reads the ring this one writes (the real
    deployment shape: two pipelines on one host). Messages are queued
    before the child spawns, so the test is race-free."""
    port = _shm_port()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    prod = ShmTransport()
    prod.listen("", port)
    prod.send(0, b"hello")
    prod.send(0, b"world")
    child = subprocess.run(
        [sys.executable, "-c", (
            f"import sys; sys.path.insert(0, {repo!r})\n"
            "from nnstreamer_tpu_torch.edge.shm import ShmTransport\n"
            "t = ShmTransport()\n"
            f"t.connect('', {port})\n"
            "print(t.recv(timeout=10)[1].decode())\n"
            "print(t.recv(timeout=10)[1].decode())\n"
            "t.close()\n"
        )],
        capture_output=True, text=True, timeout=60,
    )
    assert child.returncode == 0, child.stderr[-400:]
    assert child.stdout.split() == ["hello", "world"]
    prod.close()


def test_edgesink_edgesrc_shm_pipeline():
    """connect-type=SHM end to end through the pipeline elements."""
    from nnstreamer_tpu_torch.edge.pubsub import EdgeSink, EdgeSrc
    from nnstreamer_tpu_torch.tensors.frame import EOS_FRAME, Frame

    sink = EdgeSink(**{"connect-type": "SHM", "port": _shm_port()})
    sink.start()
    src = EdgeSrc(**{"connect-type": "SHM", "dest-port": sink.bound_port})
    src.start()
    try:
        frames = [
            Frame((np.full((2, 2), i, np.float32),), pts=i * 1000)
            for i in range(5)
        ]
        for f in frames:
            sink.render(f)
        got = []
        while len(got) < 5:
            f = src.generate()
            if f is not None and f is not EOS_FRAME:
                got.append(f)
        for sent, rcv in zip(frames, got):
            np.testing.assert_array_equal(
                np.asarray(sent.tensors[0]), np.asarray(rcv.tensors[0])
            )
            assert rcv.pts == sent.pts
        sink.on_eos()
        f = None
        while f is None:
            f = src.generate()
        assert f is EOS_FRAME
    finally:
        src.stop()
        sink.stop()


def test_live_producer_name_not_clobbered():
    """Second producer on the same port must fail (TCP EADDRINUSE
    analogue); after the first closes cleanly the name is reclaimable."""
    a = ShmTransport()
    port = a.listen("", _shm_port())
    b = ShmTransport()
    with pytest.raises(TransportError, match="live producer"):
        b.listen("", port)
    a.close()  # marks closed + unlinks → name free again
    c = ShmTransport()
    assert c.listen("", port) == port
    c.close()


def test_oversized_message_error_names_capacity():
    prod = ShmTransport(capacity=8 * 1024)
    prod.listen("", _shm_port())
    with pytest.raises(TransportError, match="capacity"):
        prod.send(0, b"x" * (5 * 1024))
    prod.close()


def test_edgesink_oversized_frame_fails_loudly():
    """A frame that can NEVER fit the ring is a pipeline error with the
    remedy in the message, not an eternal silent drop."""
    from nnstreamer_tpu_torch.edge.pubsub import EdgeSink
    from nnstreamer_tpu_torch.elements.base import ElementError
    from nnstreamer_tpu_torch.tensors.frame import Frame

    sink = EdgeSink(**{"connect-type": "SHM", "port": _shm_port(),
                       "shm-capacity": 64 * 1024})
    sink.start()
    try:
        big = Frame((np.zeros(128 * 1024, np.uint8),))
        with pytest.raises(ElementError, match="shm-capacity"):
            sink.render(big)
    finally:
        sink.stop()


def test_shm_close_during_traffic_stress():
    """Teardown race: producer closes mid-stream while the consumer is
    blocked in recv — must end with EOS (-1 → (0, b'')) or a clean
    timeout, never a crash/hang. Build with NNS_EDGE_SANITIZE=thread to
    run the ring under TSAN (same story as the edge transport stress)."""
    for round_i in range(6):
        prod, cons = _pair(capacity=16 * 1024)
        stop = threading.Event()
        got = []
        sent = 0

        def consume(c=cons, out=got, st=stop):
            while not st.is_set():
                r = c.recv(timeout=0.2)
                if r is None:
                    continue
                if r[1] == b"":
                    return  # closed + drained
                out.append(r[1])

        t = threading.Thread(target=consume, daemon=True)
        t.start()
        for i in range(50):
            try:
                prod.send(0, os.urandom(256), timeout=1)
                sent += 1
            except TransportError:
                break
        prod.close()  # mark closed + unlink while consumer mid-recv
        stop.set()
        t.join(timeout=5)
        assert not t.is_alive(), "consumer hung through producer close"
        # the stress is only meaningful if traffic actually flowed
        assert sent >= 10, f"round {round_i}: only {sent} sends succeeded"
        assert got, f"round {round_i}: consumer received nothing"
        cons.close()
