"""The port's runtime sanitizer (nnstreamer_tpu_torch/pipeline/sanitize.py)
against the JAX package's (nnstreamer_tpu/pipeline/sanitize.py), on the
CPU: the env / config knob, spec conformance on torch tensors (NNS-S001
fails the stream at the corruption point in both packages), frame
accounting at EOS (NNS-S002, the same leak count), lock order (NNS-S003),
thread leaks (NNS-S004), ``poison_like`` on numpy and torch, and batch pad
rows that never reach a delivered frame.
"""

import threading

import numpy as np
import pytest
import torch

from nnstreamer_tpu import registry as jregistry
from nnstreamer_tpu.elements.base import HostElement as JHostElement
from nnstreamer_tpu.pipeline import sanitize as jsan
from nnstreamer_tpu.pipeline.parse import parse_pipeline as jparse
from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.elements.base import HostElement
from nnstreamer_tpu_torch.pipeline.parse import parse_pipeline
from nnstreamer_tpu_torch.pipeline.sanitize import (
    LockOrderGraph,
    SpecViolationError,
    frame_conforms,
    poison_like,
    sanitize_enabled,
)
from nnstreamer_tpu_torch.tensors.frame import Frame
from nnstreamer_tpu_torch.tensors.spec import TensorsSpec

TIMEOUT = 60
CHAOS_CORRUPT = ("tensorsrc dimensions=4 num-frames=9 ! "
                 "tensor_chaos corrupt-every-n=3 ! tensor_sink name=out")


def tparse(desc):
    return parse_pipeline(desc, device="cpu")


def test_config_knob_and_env(monkeypatch):
    assert not sanitize_enabled() and not jsan.sanitize_enabled()
    monkeypatch.setenv("NNS_TPU_SANITIZE", "1")
    assert sanitize_enabled() and jsan.sanitize_enabled()
    monkeypatch.setenv("NNS_TPU_SANITIZE", "0")
    monkeypatch.setenv("NNS_TPU_EXECUTOR_SANITIZE", "true")
    assert not sanitize_enabled()  # the one-knob env wins
    monkeypatch.delenv("NNS_TPU_SANITIZE")
    assert sanitize_enabled() == jsan.sanitize_enabled() is True


def test_frame_conforms_on_torch_and_numpy():
    spec = TensorsSpec.from_strings("4:2", "float32")
    ok = Frame((torch.zeros(2, 4),))
    assert frame_conforms(ok, spec) is None
    assert frame_conforms(Frame((np.zeros((2, 4), np.float32),)), spec) is None
    assert "shape" in frame_conforms(Frame((torch.zeros(7),)), spec)
    assert "dtype" in frame_conforms(Frame((torch.zeros(2, 4, dtype=torch.float64),)), spec)
    assert "tensors" in frame_conforms(Frame((torch.zeros(2, 4), torch.zeros(1))), spec)
    # an integer spec's wide device form (the labeling argmax) conforms
    u32 = TensorsSpec.from_strings("1", "uint32")
    assert frame_conforms(Frame((torch.zeros(1, dtype=torch.int64),)), u32) is None
    bf = TensorsSpec.from_strings("3", "bfloat16")
    assert frame_conforms(Frame((np.zeros(3, np.uint16),)), bf) is None


def test_plain_run_misses_corruption_sanitized_catches(monkeypatch):
    p = tparse(CHAOS_CORRUPT)
    ex = p.run(timeout=TIMEOUT)
    assert p["out"].rendered == 9 and not ex.errors
    monkeypatch.setenv("NNS_TPU_SANITIZE", "1")
    p = tparse(CHAOS_CORRUPT)
    with pytest.raises(SpecViolationError, match="spec"):
        p.run(timeout=TIMEOUT)
    assert "NNS-S001" in p._executor.sanitizer.codes
    jp = jparse(CHAOS_CORRUPT)
    with pytest.raises(jsan.SpecViolationError):
        jp.run(timeout=TIMEOUT)
    assert p._executor.sanitizer.codes == jp._executor.sanitizer.codes


def test_sanitized_chaos_drop_run_stays_balanced(monkeypatch):
    monkeypatch.setenv("NNS_TPU_SANITIZE", "1")
    desc = ("tensorsrc dimensions=4 num-frames=60 pattern=counter ! "
            "tensor_filter name=f framework=faulty custom=fail_every_n:4 on-error=drop ! "
            "tensor_sink name=out")
    ex = tparse(desc).run(timeout=TIMEOUT)
    jex = jparse(desc).run(timeout=TIMEOUT)
    assert ex.sanitizer.codes == [] == jex.sanitizer.codes
    s, js = ex.stats()["f"], jex.stats()["f"]
    for k in ("san_offered", "san_delivered", "san_routed", "error_dropped"):
        assert s[k] == js[k], k
    assert s["san_offered"] == 60 and s["san_delivered"] + s["error_dropped"] == 60
    assert ex.leaked_threads == []


def _leaky(base):
    class LeakyHost(base):
        """Declares 1:1 but eats every 3rd frame."""

        FACTORY_NAME = "leakyhost"
        SAN_ONE_TO_ONE = True

        def __init__(self, name=None, **props):
            super().__init__(name, **props)
            self._n = 0

        def negotiate(self, in_specs):
            return [in_specs[0]]

        def process(self, frame):
            self._n += 1
            return None if self._n % 3 == 0 else frame

    return LeakyHost


def test_accounting_leak_detected_only_when_sanitized(monkeypatch):
    registry.register(registry.KIND_ELEMENT, "leakyhost", _leaky(HostElement))
    jregistry.register(jregistry.KIND_ELEMENT, "leakyhost", _leaky(JHostElement))
    try:
        desc = "tensorsrc dimensions=4 num-frames=9 ! leakyhost ! tensor_sink name=out"
        ex = tparse(desc).run(timeout=TIMEOUT)
        assert not ex.errors and ex.sanitizer is None
        monkeypatch.setenv("NNS_TPU_SANITIZE", "1")
        ex = tparse(desc).run(timeout=TIMEOUT)
        jex = jparse(desc).run(timeout=TIMEOUT)
        assert ex.sanitizer.codes == jex.sanitizer.codes == ["NNS-S002"]
        (leak,) = ex.sanitizer.findings()
        (jleak,) = jex.sanitizer.findings()
        assert "3 frame(s) leaked" in leak.message
        assert leak.message == jleak.message
    finally:
        registry.unregister(registry.KIND_ELEMENT, "leakyhost")
        jregistry.unregister(jregistry.KIND_ELEMENT, "leakyhost")


def test_thread_leak_reported_at_shutdown(monkeypatch):
    stop_ev = threading.Event()

    class ThreadLeaker(HostElement):
        """start() spawns a service thread; stop() forgets it."""

        FACTORY_NAME = "threadleaker"

        def negotiate(self, in_specs):
            return [in_specs[0]]

        def start(self):
            threading.Thread(target=self._loop, name="leaky-service", daemon=True).start()

        def _loop(self):
            while not stop_ev.wait(0.02):
                pass

        def process(self, frame):
            return frame

    registry.register(registry.KIND_ELEMENT, "threadleaker", ThreadLeaker)
    try:
        monkeypatch.setenv("NNS_TPU_SANITIZE", "1")
        ex = tparse("tensorsrc dimensions=4 num-frames=3 ! threadleaker ! "
                    "tensor_sink name=out").run(timeout=TIMEOUT)
        assert "leaky-service" in ex.leaked_threads
        assert "NNS-S004" in ex.sanitizer.codes
    finally:
        stop_ev.set()
        registry.unregister(registry.KIND_ELEMENT, "threadleaker")


def test_watchdog_thread_joined_on_stop(monkeypatch):
    monkeypatch.setenv("NNS_TPU_EXECUTOR_WATCHDOG_TIMEOUT_MS", "5000")
    monkeypatch.setenv("NNS_TPU_SANITIZE", "1")
    ex = tparse("tensorsrc dimensions=4 num-frames=5 ! tensor_sink name=out").run(timeout=TIMEOUT)
    assert ex._watchdog is not None and not ex._watchdog.is_alive()
    assert "nns-watchdog" not in ex.leaked_threads and ex.sanitizer.codes == []


@pytest.mark.parametrize("graph_cls", [LockOrderGraph, jsan.LockOrderGraph])
def test_lock_order_cycle_detected(graph_cls):
    cycles = []
    g = graph_cls(on_cycle=cycles.append)

    def order(first, second):
        g.acquired(first)
        g.acquired(second)
        g.released(second)
        g.released(first)

    for a, b in (("lock-A", "lock-B"), ("lock-B", "lock-A")):
        t = threading.Thread(target=order, args=(a, b))
        t.start()
        t.join(timeout=5)
    assert len(cycles) == 1 and "lock-A" in cycles[0]


def test_executor_lock_cycle_lands_in_report(monkeypatch):
    monkeypatch.setenv("NNS_TPU_SANITIZE", "1")
    ex = tparse("tensorsrc dimensions=4 num-frames=2 ! tensor_sink name=out").run(timeout=TIMEOUT)
    san = ex.sanitizer
    a, b = san.lock("test-A"), san.lock("test-B")

    def order(first, second):
        with first:
            with second:
                pass

    for x, y in ((a, b), (b, a)):
        t = threading.Thread(target=order, args=(x, y))
        t.start()
        t.join(timeout=5)
    assert san.codes == ["NNS-S003"], [str(d) for d in san.findings()]


def test_poison_values_are_obviously_wrong():
    for mod in (poison_like, jsan.poison_like):
        f = mod(np.zeros((2, 3), np.float32))
        assert f.shape == (2, 3) and np.isnan(f).all()
        i = mod(np.zeros((4,), np.int32))
        assert (i == np.iinfo(np.int32).max).all()
    t = poison_like(torch.zeros(2, 3, dtype=torch.bfloat16))
    assert isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16 and t.isnan().all()
    u = poison_like(torch.zeros(4, dtype=torch.uint8))
    assert (u == 255).all()


def test_batched_pad_poison_does_not_leak_into_frames(monkeypatch):
    monkeypatch.setenv("NNS_TPU_SANITIZE", "1")
    desc = ("tensorsrc dimensions=4 num-frames=5 pattern=counter ! "
            "tensor_filter framework=scaler batching=true max-batch=4 "
            "batch-timeout-ms=2 ! tensor_sink name=out")
    p = tparse(desc)
    ex = p.run(timeout=TIMEOUT)
    assert ex.sanitizer.codes == []
    plan_seg = next(n.seg for n in ex.nodes if getattr(n, "seg", None) is not None)
    assert plan_seg.sanitize_poison
    vals = [np.asarray(f.tensors[0]) for f in p["out"].frames]
    jp = jparse(desc)
    jp.run(timeout=TIMEOUT)
    want = [np.asarray(f.tensors[0]) for f in jp["out"].frames]
    assert len(vals) == 5 and all(np.isfinite(v).all() for v in vals)
    for a, b in zip(vals, want):
        np.testing.assert_array_equal(a, b)
