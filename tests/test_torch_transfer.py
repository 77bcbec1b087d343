"""The transfer engine and the in-flight frame ring of the port
(nnstreamer_tpu_torch/pipeline/transfer.py, pipeline/executor.py) against
the JAX package's (nnstreamer_tpu/pipeline/transfer.py), on the CPU:

- the ring delivers in order at every depth, flushes at EOS, and a
  host-path op keeps its own ``ring-depth``; the counter streams equal
  the reference's exactly (the scaler's x2 is exact in float32);
- the resolvers (``ring-depth`` / ``chain-mode`` / ``chain_unroll``) layer
  element over env over default as the reference's do, value for value;
- the packer's round trip over mixed dtypes (bool and bfloat16 included),
  the lone-tensor and all-host paths, H2D staging's CPU bypass and force;
- zero interior host bytes across a queue between two segments, and
  ``totals()["transfer"]`` equal to the reference's byte counts;
- ``sync-window`` and a ``WANTS_HOST`` consumer (one coalesced fetch a
  frame at the producer), a fault at materialisation disposed of through
  the node's policy, ``inflight()`` counting the ring for ``drain`` and a
  warm restart's balance 0 with frames in rings;
- ``[executor] donate`` is read and has no effect.

Every pipeline runs under the runtime sanitizer (pipeline/sanitize.py), so
in-order delivery and offered == delivered + dropped + routed are checked
at every depth too.
"""

import time

import numpy as np
import pytest
import torch

from nnstreamer_tpu.pipeline import transfer as jtransfer
from nnstreamer_tpu.pipeline.parse import parse_pipeline as jparse
from nnstreamer_tpu_torch.elements.base import HostElement
from nnstreamer_tpu_torch.pipeline import transfer
from nnstreamer_tpu_torch.pipeline.device_faults import DeviceFaultError
from nnstreamer_tpu_torch.pipeline.parse import parse_pipeline
from nnstreamer_tpu_torch.tensors.frame import Frame

TIMEOUT = 60


@pytest.fixture(autouse=True)
def _sanitize(monkeypatch):
    monkeypatch.setenv("NNS_TPU_SANITIZE", "1")


def tparse(desc):
    return parse_pipeline(desc, device="cpu")


def values(frames):
    return [float(np.asarray(f.tensors[0]).ravel()[0]) for f in frames]


def run_both(desc):
    p = tparse(desc)
    ex = p.run(timeout=TIMEOUT)
    jp = jparse(desc)
    jex = jp.run(timeout=TIMEOUT)
    assert not ex.errors and not jex.errors
    assert ex.sanitizer is not None and ex.sanitizer.codes == [], ex.sanitizer.findings()
    return p, ex, jp, jex


# ------------------------------------------------------------ frame ring
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_in_order_delivery_at_every_depth(depth):
    desc = ("tensorsrc dimensions=4 num-frames=50 pattern=counter ! "
            f"tensor_filter name=f framework=scaler ring-depth={depth} ! tensor_sink name=out")
    p, ex, jp, jex = run_both(desc)
    got = values(p["out"].frames)
    assert got == [2.0 * i for i in range(50)] == values(jp["out"].frames)
    assert ex.totals()["balance"] == 0 == jex.totals()["balance"]
    node = next(n for n in ex.nodes if n.name == "f")
    assert node._ring.depth == depth and node.inflight() == 0


def test_ring_deeper_than_stream_flushes_at_eos():
    p, ex, jp, _ = run_both("tensorsrc dimensions=4 num-frames=3 pattern=counter ! "
                            "tensor_filter name=f framework=scaler ring-depth=8 ! "
                            "tensor_sink name=out")
    assert values(p["out"].frames) == values(jp["out"].frames) == [0.0, 2.0, 4.0]
    assert ex.totals()["balance"] == 0


def test_default_depth_is_two_on_a_fused_segment_and_one_on_a_host_op():
    p = tparse("tensorsrc dimensions=4 num-frames=5 pattern=counter ! "
               "tensor_filter name=f framework=scaler ! "
               "tensor_filter name=h framework=hostscaler ! tensor_sink name=out")
    ex = p.run(timeout=TIMEOUT)
    rings = {n.name: n._ring.depth for n in ex.nodes if n._ring is not None}
    assert rings == {"f": 2, "h": 1}
    assert values(p["out"].frames) == [4.0 * i for i in range(5)]


def test_host_node_ring_depth_property():
    desc = ("tensorsrc dimensions=4 num-frames=40 pattern=counter ! "
            "tensor_filter name=f framework=framecounter ring-depth=3 ! tensor_sink name=out")
    p, ex, jp, _ = run_both(desc)
    got = [int(np.asarray(f.tensors[0]).ravel()[0]) for f in p["out"].frames]
    want = [int(np.asarray(f.tensors[0]).ravel()[0]) for f in jp["out"].frames]
    assert got == want == sorted(got) and len(got) == 40
    assert next(n for n in ex.nodes if n.name == "f")._ring.depth == 3


class _Elem:
    def __init__(self, **props):
        self.props = props

    def get_property(self, key):
        return self.props.get(key)


@pytest.mark.parametrize("env,prop", [
    (None, None), (None, 5), (None, 0), (None, 99), (None, "junk"), ("4", None), ("7", 3),
])
def test_ring_depth_resolution_layering(env, prop, monkeypatch):
    if env is not None:
        monkeypatch.setenv("NNS_TPU_EXECUTOR_RING_DEPTH", env)
    e = _Elem(**{"ring-depth": prop})
    assert transfer.resolve_ring_depth([e]) == jtransfer.resolve_ring_depth([e])


@pytest.mark.parametrize("env,props", [
    (None, [None, None]), (None, ["off", None]), (None, [None, "auto"]), ("off", [None]),
    ("off", ["auto"]), ("bogus", [None]), (None, ["bogus"]),
])
def test_chain_mode_resolution_layering(env, props, monkeypatch):
    if env is not None:
        monkeypatch.setenv("NNS_TPU_EXECUTOR_CHAIN_MODE", env)
    elems = [_Elem(**{"chain-mode": v}) for v in props]
    assert transfer.resolve_chain_mode(elems) == jtransfer.resolve_chain_mode(elems)


@pytest.mark.parametrize("env", [None, "8", "0", "99", "x"])
def test_chain_unroll_resolution(env, monkeypatch):
    if env is not None:
        monkeypatch.setenv("NNS_TPU_EXECUTOR_CHAIN_UNROLL", env)
    assert transfer.resolve_chain_unroll([]) == jtransfer.resolve_chain_unroll([])


def test_donate_is_read_and_has_no_effect(monkeypatch):
    """``[executor] donate`` resolves as the reference's does, and the
    stream is the same either way (a graph copies its inputs)."""
    desc = ("tensorsrc dimensions=4 num-frames=12 pattern=counter ! "
            "tensor_filter name=f framework=scaler ! tensor_sink name=out")
    outs = []
    for raw in ("true", "false"):
        monkeypatch.setenv("NNS_TPU_EXECUTOR_DONATE", raw)
        assert transfer.donation_enabled() == jtransfer.donation_enabled() == (raw == "true")
        p = tparse(desc)
        p.run(timeout=TIMEOUT)
        outs.append([np.asarray(f.tensors[0]) for f in p["out"].frames])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------ coalesced D2H
MIXED = [
    torch.arange(12, dtype=torch.float32).reshape(3, 4),
    torch.arange(6, dtype=torch.int32),
    torch.tensor([True, False, True]),
    torch.arange(5, dtype=torch.uint8),
    torch.linspace(-2, 2, 7).to(torch.bfloat16),
    torch.linspace(-1, 1, 4).to(torch.float16).reshape(2, 2),
]


def test_packed_fetch_roundtrip_mixed_dtypes():
    """The packer's bytes split back by dtype and shape bit for bit (bool
    through uint8, bfloat16 as its uint16 bits, as ``Frame.to_host``)."""
    buf = transfer.pack_tensors(MIXED)
    assert buf.dtype == torch.uint8 and buf.numel() == sum(transfer.nbytes([t]) for t in MIXED)
    got = transfer.split_packed(buf.numpy(), [(tuple(t.shape), t.dtype) for t in MIXED])
    for g, t in zip(got, MIXED):
        want = t.view(torch.uint16).numpy() if t.dtype is torch.bfloat16 else t.numpy()
        assert g.dtype == want.dtype and g.shape == want.shape
        np.testing.assert_array_equal(g, want)
    # the reference's packer over the same values gives the same bytes
    import jax.numpy as jnp

    ref = [jnp.asarray(t.float().numpy() if t.dtype is torch.bfloat16 else t.numpy())
           for t in MIXED[:4]]
    jbuf = np.asarray(jtransfer._packer_for(jtransfer._sig_of(ref))(*ref))
    np.testing.assert_array_equal(transfer.pack_tensors(MIXED[:4]).numpy(), jbuf)


def test_frame_fetch_counts_and_materialises_host_tensors():
    base = transfer.tally.snapshot()["d2h_bytes"]
    host = np.ones(3, np.float32)
    out = transfer.FrameFetch([host] + MIXED).start().finish()
    assert out[0] is host
    assert all(isinstance(a, np.ndarray) for a in out)
    assert transfer.tally.snapshot()["d2h_bytes"] - base == transfer.nbytes(MIXED)


def test_fetch_window_all_host_is_a_passthrough():
    frames = [Frame(tensors=(np.arange(4, dtype=np.float32),)) for _ in range(3)]
    base = transfer.tally.snapshot()["d2h_bytes"]
    assert transfer.fetch_window(frames) is frames
    assert transfer.tally.snapshot()["d2h_bytes"] == base


def test_fetch_window_splits_back_per_frame():
    frames = [Frame(tensors=(torch.full((2,), float(i)), torch.tensor([i], dtype=torch.int64)))
              for i in range(4)]
    out = transfer.fetch_window(frames)
    assert [(float(f.tensors[0][0]), int(f.tensors[1][0])) for f in out] == [
        (float(i), i) for i in range(4)]
    assert all(isinstance(t, np.ndarray) for f in out for t in f.tensors)


# ----------------------------------------------------------- H2D staging
def test_stage_frame_cpu_default_is_bypass():
    f = Frame(tensors=(np.ones(4, np.float32),))
    assert transfer.stage_frame(f) is f
    jf = jtransfer.stage_frame(f)
    assert jf is f  # the reference bypasses its CPU backend the same way


def test_stage_frame_force_counts_h2d_and_copies():
    base = transfer.tally.snapshot()["h2d_bytes"]
    src = np.ones(4, np.float32)
    staged = transfer.stage_frame(Frame(tensors=(src,)), force=True)
    assert isinstance(staged.tensors[0], torch.Tensor)
    assert transfer.tally.snapshot()["h2d_bytes"] - base == 16
    src[:] = 7.0  # a private copy: the caller's later write never reaches it
    assert float(staged.tensors[0].sum()) == 4.0


def test_stage_iter_preserves_order():
    arrays = [np.full((2,), i, np.float32) for i in range(20)]
    out = list(transfer.stage_iter(iter(arrays)))
    assert [int(a.ravel()[0]) for a in out] == list(range(20))


# ------------------------------------------------- resident handoff
def test_adjacent_segments_zero_host_materialization():
    """Two segments across a queue hand frames on as tensors: the run's
    D2H bytes equal the one-segment control's (only the sink fetches),
    and both equal the reference's counts for the same streams."""
    n = 40
    src = f"tensorsrc dimensions=4 num-frames={n} pattern=counter ! "
    _, ex1, _, jex1 = run_both(src + "tensor_filter framework=scaler ! tensor_sink name=out")
    control = ex1.transfer_totals()["d2h"]
    assert control == jex1.transfer_totals()["d2h"] == n * 16
    p2, ex2, _, jex2 = run_both(src + "tensor_filter framework=scaler ! queue ! "
                                "tensor_filter framework=scaler ! tensor_sink name=out")
    assert ex2.transfer_totals()["d2h"] == control == jex2.transfer_totals()["d2h"]
    assert values(p2["out"].frames) == [4.0 * i for i in range(n)]


def test_transfer_totals_in_executor_totals():
    _, ex, _, jex = run_both("tensorsrc dimensions=4 num-frames=10 ! "
                             "tensor_filter framework=scaler ! tensor_sink name=out")
    t, jt = ex.totals()["transfer"], jex.totals()["transfer"]
    assert set(t) == set(jt) == {"h2d", "d2h"}
    assert t == jt and t["d2h"] == 160


@pytest.mark.parametrize("window", [1, 3, 4])
def test_sync_window_renders_the_same_stream(window):
    desc = ("tensorsrc dimensions=4 num-frames=10 pattern=counter ! "
            f"tensor_filter framework=scaler ! tensor_sink name=out sync-window={window}")
    p, ex, jp, jex = run_both(desc)
    assert values(p["out"].frames) == values(jp["out"].frames) == [2.0 * i for i in range(10)]
    assert ex.transfer_totals()["d2h"] == jex.transfer_totals()["d2h"] == 160
    assert p["out"].sync_window == window


class _HostReader(HostElement):
    """A consumer that reads host bytes: the node before it fetches."""

    FACTORY_NAME = "test_host_reader"
    WANTS_HOST = True

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.kinds = []

    def negotiate(self, in_specs):
        return list(in_specs)

    def process(self, frame):
        self.kinds.append(type(frame.tensors[0]).__name__)
        return frame


def _reader_pipeline(n, props=""):
    from nnstreamer_tpu_torch.elements.sink import TensorSink
    from nnstreamer_tpu_torch.elements.sources import TensorSrc
    from nnstreamer_tpu_torch.elements.filter import TensorFilter
    from nnstreamer_tpu_torch.pipeline.graph import Pipeline

    src = TensorSrc(dimensions="4", **{"num-frames": str(n), "pattern": "counter"})
    kw = dict(p.split("=") for p in props.split()) if props else {}
    f = TensorFilter(name="f", framework="scaler", **kw)
    reader, sink = _HostReader(name="reader"), TensorSink(name="out")
    p = Pipeline(device="cpu").chain(src, f, reader, sink)
    return p, reader


def test_host_consumer_gets_one_coalesced_fetch_a_frame():
    p, reader = _reader_pipeline(8)
    ex = p.run(timeout=TIMEOUT)
    node = next(n for n in ex.nodes if n.name == "f")
    assert node._out_wants_host() and node._ring.to_host
    assert reader.kinds == ["ndarray"] * 8
    # the producer's fetch, then nothing for the sink (host already)
    assert ex.transfer_totals()["d2h"] == 8 * 16
    assert values(p["out"].frames) == [2.0 * i for i in range(8)]


def test_fault_at_materialisation_goes_to_the_policy(monkeypatch):
    """A fault that surfaces when a coalesced fetch lands (not inside the
    invoke) is counted and disposed of through the node's policy."""
    real = transfer.FrameFetch.finish
    calls = {"n": 0}

    def flaky(self):
        calls["n"] += 1
        if calls["n"] == 3:
            raise DeviceFaultError("injected fetch fault")
        return real(self)

    monkeypatch.setattr(transfer.FrameFetch, "finish", flaky)
    p, _ = _reader_pipeline(8, "on-error=drop")
    ex = p.run(timeout=TIMEOUT)
    assert not ex.errors
    assert values(p["out"].frames) == [2.0 * i for i in range(8) if i != 2]
    s = ex.stats()["f"]
    assert s["error_dropped"] == 1 and ex.totals()["balance"] == 0


def test_fault_at_materialisation_without_a_policy_stops_the_run(monkeypatch):
    def broken(self):
        raise DeviceFaultError("injected fetch fault")

    monkeypatch.setattr(transfer.FrameFetch, "finish", broken)
    p, _ = _reader_pipeline(4)
    with pytest.raises(DeviceFaultError):
        p.run(timeout=TIMEOUT)


def test_inflight_counts_the_ring_and_drain_waits_for_it():
    """A frame parked in a ring is neither queued nor delivered: inflight()
    sees it, and drain() returns only once the idle flush delivered it;
    the warm restart's balance is 0 with frames in rings."""
    from nnstreamer_tpu_torch.elements.sources import AppSrc
    from nnstreamer_tpu_torch.pipeline.executor import _FrameRing

    class _Probe:
        def __init__(self):
            self.pushed = []

        def push_out(self, pad, f):
            self.pushed.append(f)
            return True

        def stat(self, t0):
            pass

    probe = _Probe()
    ring = _FrameRing(probe, 3, False)
    for i in range(2):
        ring.put(Frame(tensors=(np.full(1, i),)))
    assert len(ring) == 2 and probe.pushed == []
    ring.put(Frame(tensors=(np.full(1, 2),)))
    assert len(ring) == 2 and len(probe.pushed) == 1
    assert ring.flush() and len(ring) == 0 and len(probe.pushed) == 3

    p = tparse("appsrc name=src dimensions=4 types=float32 ! "
               "tensor_filter name=f framework=scaler ring-depth=4 ! tensor_sink name=out")
    src = p["src"]
    ex = p.start()
    for i in range(6):
        src.push(np.full((4,), float(i), np.float32))
    src_node = next(n for n in ex.nodes if n.name == "src")
    deadline = time.monotonic() + 10
    while src_node.frames_processed < 6 and time.monotonic() < deadline:
        time.sleep(0.005)  # drain parks the source: let it emit all six first
    assert ex.drain(timeout=10, settle_s=0.1)
    assert ex.inflight() == 0
    snap = ex.snapshot()
    assert snap["nodes"]["f"]["frames"] == 6
    assert values(p["out"].frames) == [2.0 * i for i in range(6)]
    ex.resume()
    src.push(np.full((4,), 6.0, np.float32))
    src.end_of_stream()
    assert ex.wait(TIMEOUT)
    ex.stop()
    assert isinstance(src, AppSrc)
    assert ex.totals()["balance"] == 0 and len(p["out"].frames) == 7
