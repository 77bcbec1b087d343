"""The port's micro-batching (pipeline/batching.py, FusedSegment's batched
programs, the segment node's batched loop) against the JAX package's, on
the CPU: every case runs the same numpy-seeded frames through both.

- the bucket ladder, ``bucket_for``, props over the ``[executor]`` config
  and the env that enables it, bad props failing at plan time naming the
  element and the prop;
- a transform → filter → decode chain bitwise equal batched and
  unbatched, and equal to the reference's outputs; order, metadata and
  timestamps kept; a partial window flushed at EOS; the trickle timeout;
- the program cache: bucket padding bounds ``n_traces``, entries keyed by
  shapes and dtypes, a heterogeneous window run per frame, an
  ``fn_version`` tick (``reload_model``) building a same-shape program
  anew;
- the host path: ``hostscaler`` batching through ``invoke_batched``, a
  host window of mixed shapes per frame, and the non-batchable
  ``framecounter`` kept per frame.
"""

import threading
import time

import numpy as np
import pytest
import torch

from nnstreamer_tpu.elements.filter import TensorFilter as JFilter
from nnstreamer_tpu.pipeline import batching as jbatching
from nnstreamer_tpu.pipeline.parse import parse_pipeline as jax_parse
from nnstreamer_tpu.tensors.frame import Frame as JFrame
from nnstreamer_tpu_torch.elements.filter import TensorFilter
from nnstreamer_tpu_torch.pipeline import batching
from nnstreamer_tpu_torch.pipeline.batching import BatchConfig, default_buckets
from nnstreamer_tpu_torch.pipeline.parse import parse_pipeline
from nnstreamer_tpu_torch.tensors.frame import Frame
from nnstreamer_tpu_torch.tensors.spec import TensorsSpec


# -- config ----------------------------------------------------------------

@pytest.mark.parametrize("max_batch", [1, 2, 3, 6, 8, 16])
def test_default_buckets_ladder(max_batch):
    assert default_buckets(max_batch) == jbatching.default_buckets(max_batch)
    assert default_buckets(max_batch)[-1] == max_batch


def test_bucket_for_rounds_up():
    cfg = BatchConfig(True, 8, 1.0, (1, 2, 4, 8))
    jcfg = jbatching.BatchConfig(True, 8, 1.0, (1, 2, 4, 8))
    got = [cfg.bucket_for(n) for n in range(1, 9)]
    assert got == [jcfg.bucket_for(n) for n in range(1, 9)] == [1, 2, 4, 4, 8, 8, 8, 8]
    assert not BatchConfig(True, 1, 1.0, (1,)).active


PROPS = [
    dict(batching="true", max_batch="4", batch_timeout_ms="0.5"),
    dict(batching="true", max_batch="6", batch_buckets="2,4"),
    dict(batching="true", max_batch="8", batch_buckets="1,3,8,12"),
    dict(batching="false", max_batch="4"),
    dict(),
]


@pytest.mark.parametrize("props", PROPS, ids=range(len(PROPS)))
def test_element_props_over_executor_default(props):
    kw = dict(framework="scaler", custom="factor:2.0", input="4", **props)
    got = batching.resolve_batch_config([TensorFilter(**kw)])
    want = jbatching.resolve_batch_config([JFilter(**kw)])
    assert (got.enabled, got.max_batch, got.timeout_ms, got.buckets) == (
        want.enabled, want.max_batch, want.timeout_ms, want.buckets)


def test_executor_env_default_enables(monkeypatch):
    monkeypatch.setenv("NNS_TPU_EXECUTOR_BATCHING", "true")
    monkeypatch.setenv("NNS_TPU_EXECUTOR_MAX_BATCH", "6")
    monkeypatch.setenv("NNS_TPU_EXECUTOR_BATCH_TIMEOUT_MS", "2.5")
    kw = dict(framework="scaler", custom="factor:2.0", input="4")
    got = batching.resolve_batch_config([TensorFilter(**kw)])
    want = jbatching.resolve_batch_config([JFilter(**kw)])
    assert got.enabled and got.max_batch == 6 and got.buckets == (1, 2, 4, 6)
    assert got == BatchConfig(want.enabled, want.max_batch, want.timeout_ms, want.buckets)
    # an element prop still wins over the env
    off = batching.resolve_batch_config([TensorFilter(batching="false", **kw)])
    assert not off.enabled


@pytest.mark.parametrize("bad,prop", [
    (dict(max_batch="notanint"), "max-batch"),
    (dict(batch_timeout_ms="soon"), "batch-timeout-ms"),
    (dict(batch_buckets="2;4"), "batch-buckets"),
])
def test_bad_batching_property_names_element_and_prop(bad, prop):
    kw = dict(framework="scaler", custom="factor:2.0", input="4", batching="true", **bad)
    f = TensorFilter(name="f0", **kw)
    with pytest.raises(ValueError, match=rf"f0: bad {prop}="):
        batching.resolve_batch_config([f])
    with pytest.raises(ValueError, match=prop):
        jbatching.resolve_batch_config([JFilter(**kw)])


@pytest.mark.parametrize("framework", ["scaler", "hostscaler"])
def test_bad_batching_property_fails_at_plan_time(framework):
    desc = (
        "videotestsrc num-frames=4 width=8 height=8 ! tensor_converter ! "
        f"tensor_filter name=bf framework={framework} custom=factor:2.0 "
        "batching=true max-batch=notanint ! tensor_sink"
    )
    with pytest.raises(ValueError, match=r"bf: bad max-batch.*notanint"):
        parse_pipeline(desc, device="cpu").compile_plan()
    with pytest.raises(ValueError, match=r"max-batch.*notanint"):
        jax_parse(desc).compile_plan()


# -- the chain, batched and unbatched ---------------------------------------

def push_frames(src, frames, delay=0.0, gap=0.0):
    def pump():
        if delay:
            time.sleep(delay)
        for f in frames:
            src.push(f)
            if gap:
                time.sleep(gap)
        src.end_of_stream()

    t = threading.Thread(target=pump, daemon=True)
    t.start()
    return t


def run_port(desc, frames, **push):
    p = parse_pipeline(desc, device="cpu")
    ex = p.start()
    push_frames(p["src"], [Frame(*f) if isinstance(f, tuple) else f for f in frames], **push)
    assert ex.wait(120)
    p.stop()
    assert not ex.errors
    return p, ex


def run_ref(desc, frames):
    p = jax_parse(desc)
    ex = p.start()
    push_frames(p["src"], frames)
    assert ex.wait(300)
    p.stop()
    return p


def sink_arrays(p):
    return [[np.asarray(t) for t in f.tensors] for f in p["out"].frames]


CHAIN = (
    "appsrc name=src dimensions=16:1 types=uint8 ! "
    "tensor_transform mode=typecast option=float32 ! "
    "tensor_filter name=f framework=scaler custom=factor:0.5 {props} ! "
    "{tail}tensor_sink name=out"
)


@pytest.mark.parametrize("tail", ["tensor_decoder mode=image_labeling ! ", ""],
                         ids=["decode", "scores"])
def test_batched_chain_bitwise_equal_unbatched_and_reference(tail):
    """Acceptance: the fused transform → filter (→ decode) chain gives the
    same bits batched and unbatched, in order, and the reference's."""
    rng = np.random.default_rng(14)
    xs = [rng.integers(0, 256, (1, 16)).astype(np.uint8) for _ in range(14)]
    base, _ = run_port(CHAIN.format(props="batching=false", tail=tail), [Frame((x,)) for x in xs])
    batched, ex = run_port(
        CHAIN.format(props="batching=true max-batch=4 batch-timeout-ms=5", tail=tail),
        [Frame((x,)) for x in xs])
    ref = run_ref(CHAIN.format(props="batching=false", tail=tail), [JFrame((x,)) for x in xs])
    a, b, r = sink_arrays(base), sink_arrays(batched), sink_arrays(ref)
    assert len(a) == len(b) == len(r) == 14
    for fa, fb, fr in zip(a, b, r):
        for ta, tb, tr in zip(fa, fb, fr):
            assert ta.dtype == tb.dtype == tr.dtype and ta.shape == tb.shape == tr.shape
            np.testing.assert_array_equal(ta, tb)
            np.testing.assert_array_equal(ta, tr)
    stats = batched["f"].batch_stats
    assert stats.frames == 14 and stats.avg_batch_size >= 1.0
    row = next(v for k, v in ex.stats().items() if "f" in k.split("+"))
    assert {"avg_batch_size", "pad_waste_pct", "batch_wait_ms", "n_traces"} <= set(row)


SCALE = (
    "appsrc name=src dimensions=4 types=float32 ! "
    "tensor_filter name=f framework=scaler custom=factor:2.0 {props} ! tensor_sink name=out"
)


def test_order_and_metadata_preserved_under_batching():
    n = 11
    frames = [((np.full((4,), i, np.float32),), i * 1_000_000, 1_000_000, {"idx": i})
              for i in range(n)]
    p, _ = run_port(SCALE.format(props="batching=true max-batch=4 batch-timeout-ms=10"),
                    [Frame(*f) for f in frames])
    ref = run_ref(SCALE.format(props="batching=true max-batch=4 batch-timeout-ms=10"),
                  [JFrame(*f) for f in frames])
    got = p["out"].frames
    assert len(got) == n
    for i, (f, r) in enumerate(zip(got, ref["out"].frames)):
        assert f.meta["idx"] == i and f.pts == i * 1_000_000 and f.duration == 1_000_000
        np.testing.assert_array_equal(np.asarray(f.tensors[0]), np.asarray(r.tensors[0]))


def test_eos_mid_window_flushes_partial_window():
    """EOS while a window is open (timeout 50 ms, cap 8, 5 frames): the
    partial window flushes, nothing dropped, order kept, then EOS."""
    rng = np.random.default_rng(5)
    xs = [rng.standard_normal(4).astype(np.float32) for _ in range(5)]
    props = "batching=true max-batch=8 batch-timeout-ms=50"
    p, _ = run_port(SCALE.format(props=props), [Frame((x,)) for x in xs], delay=0.05)
    ref = run_ref(SCALE.format(props=props), [JFrame((x,)) for x in xs])
    assert p["out"].eos_seen and len(p["out"].frames) == 5
    for a, b in zip(sink_arrays(p), sink_arrays(ref)):
        np.testing.assert_array_equal(a[0], b[0])


def test_timeout_flush_with_trickle_source():
    """Inter-frame gap (30 ms) far above the timeout (5 ms): every frame
    leaves after at most the timeout, in small windows, and the wait shows
    in batch-wait-ms."""
    rng = np.random.default_rng(6)
    xs = [rng.standard_normal(4).astype(np.float32) for _ in range(4)]
    t0 = time.perf_counter()
    p, _ = run_port(SCALE.format(props="batching=true max-batch=8 batch-timeout-ms=5"),
                    [Frame((x,)) for x in xs], gap=0.03)
    elapsed = time.perf_counter() - t0
    f = p["f"]
    assert f.batch_stats.frames == 4 and f.avg_batch_size < 8
    assert f.get_property("batch-wait-ms") == f.batch_wait_ms > 0.0
    assert f.get_property("avg-batch-size") == f.avg_batch_size
    assert elapsed < 10.0
    for x, got in zip(xs, sink_arrays(p)):
        np.testing.assert_array_equal(got[0], x * np.float32(2.0))


# -- the program cache -------------------------------------------------------

SEGMENT = (
    "tensorsrc dimensions=4 num-frames=1 ! "
    "tensor_transform mode=arithmetic option=add:1.0 ! "
    "tensor_filter framework=scaler custom=factor:2.0 input=4 ! tensor_sink"
)


def make_segment(parse=parse_pipeline, **kw):
    plan = parse(SEGMENT, **kw).compile_plan()
    return next(s for s in plan.segments if len(s.ops) >= 2)


def port_segment():
    return make_segment(device="cpu")


def test_bucket_padding_bounds_traces():
    seg, jseg = port_segment(), make_segment(jax_parse)
    cfg = BatchConfig(True, 8, 0.0, default_buckets(8))
    jcfg = jbatching.BatchConfig(True, 8, 0.0, jbatching.default_buckets(8))
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal(4).astype(np.float32) for _ in range(8)]
    oracle = [seg.process(Frame((x,))).tensors[0] for x in xs]
    for n in (1, 2, 3, 5, 7, 8):
        outs, bucket = seg.process_batch([Frame((x,)) for x in xs[:n]], cfg)
        jouts, jbucket = jseg.process_batch([JFrame((x,)) for x in xs[:n]], jcfg)
        assert bucket == jbucket == cfg.bucket_for(n) and len(outs) == n
        for got, want, ref in zip(outs, oracle, jouts):
            assert torch.equal(got.tensors[0], want)
            np.testing.assert_array_equal(got.tensors[0].numpy(), np.asarray(ref.tensors[0]))
    # buckets 1, 2, 4, 8 and the per-frame program
    assert seg.n_traces == len(cfg.buckets) + 1
    before = seg.n_traces
    seg.process_batch([Frame((x,)) for x in xs[:3]], cfg)
    seg.process_batch([Frame((x,)) for x in xs[:5]], cfg)
    assert seg.n_traces == before
    assert seg.batch_config is not None  # resolved at plan time


@pytest.mark.parametrize("second", [
    np.arange(8, dtype=np.float32),      # a new shape
    np.arange(4, dtype=np.int32),        # a new dtype
    np.arange(4, dtype=np.float64),
], ids=["shape", "int32", "float64"])
def test_segment_cache_keyed_by_shapes_dtypes(second):
    seg, jseg = port_segment(), make_segment(jax_parse)
    f4 = np.arange(4, dtype=np.float32)
    np.testing.assert_array_equal(seg.process(Frame((f4,))).tensors[0].numpy(),
                                  (np.arange(4) + 1.0) * 2.0)
    n = seg.n_traces
    got = seg.process(Frame((second,))).tensors[0]
    want = np.asarray(jseg.process(JFrame((second,))).tensors[0])
    assert seg.n_traces == n + 1
    assert got.shape == second.shape
    np.testing.assert_array_equal(got.numpy().astype(want.dtype), want)
    seg.process(Frame((np.zeros(4, np.float32),)))  # the first signature again: cached
    assert seg.n_traces == n + 1


def test_process_batch_heterogeneous_window_runs_per_frame():
    seg = port_segment()
    cfg = BatchConfig(True, 8, 0.0, default_buckets(8))
    mixed = [Frame((np.arange(4, dtype=np.float32),)), Frame((np.arange(8, dtype=np.float32),))]
    outs, rows = seg.process_batch(mixed, cfg)
    jouts, jrows = make_segment(jax_parse).process_batch(
        [JFrame(f.tensors) for f in mixed], jbatching.BatchConfig(True, 8, 0.0, (1, 2, 4, 8)))
    assert rows == jrows == 2 and len(outs) == 2
    for o, j in zip(outs, jouts):
        np.testing.assert_array_equal(o.tensors[0].numpy(), np.asarray(j.tensors[0]))


def test_fn_version_tick_builds_same_shape_program_anew():
    """A same-shape model swap ticks the op's fn_version, part of the cache
    key: the segment collects make_fn() again instead of serving the old
    program from the signature-matched entry."""
    seg = port_segment()
    f = Frame((np.arange(4, dtype=np.float32),))
    np.testing.assert_array_equal(seg.process(f).tensors[0].numpy(), (np.arange(4) + 1.0) * 2.0)
    filt = seg.ops[-1]
    filt.backend._factor = 3.0
    filt.fn_version += 1  # what reload_model does
    before = seg.n_traces
    np.testing.assert_array_equal(seg.process(f).tensors[0].numpy(), (np.arange(4) + 1.0) * 3.0)
    assert seg.n_traces == before + 1


def test_reload_model_ticks_fn_version():
    desc = ("appsrc name=src dimensions=4 types=float32 ! "
            "tensor_filter name=f framework=torch model=zoo:add custom=const:2.0 ! tensor_sink")
    plan = parse_pipeline(desc, device="cpu").compile_plan()
    (seg,) = plan.segments
    x = np.arange(4, dtype=np.float32)
    assert torch.equal(seg.process(Frame((x,))).tensors[0], torch.from_numpy(x + 2.0))
    filt, old = seg.first, seg.first.backend
    filt.reload_model("zoo:add")
    assert filt.fn_version == 1 and filt.backend is not old
    assert torch.equal(seg.process(Frame((x,))).tensors[0], torch.from_numpy(x + 2.0))
    assert seg.n_traces == 2


# -- the host path -----------------------------------------------------------

HOST = (
    "appsrc name=src dimensions=3:8:8 types=uint8 ! "
    "tensor_filter name=f framework=hostscaler custom=factor:3.0 {props} ! tensor_sink name=out"
)


def test_host_batchable_backend_batches():
    rng = np.random.default_rng(10)
    xs = [rng.integers(0, 80, (8, 8, 3)).astype(np.uint8) for _ in range(10)]
    props = "batching=true max-batch=4 batch-timeout-ms=10"
    p, ex = run_port(HOST.format(props=props), [Frame((x,)) for x in xs], delay=0.05)
    ref = run_ref(HOST.format(props=props), [JFrame((x,)) for x in xs])
    f = p["f"]
    assert f.batch_stats.frames == 10 and f.avg_batch_size >= 1.0
    assert f.pad_waste_pct == 0.0  # the host path never pads
    row = ex.stats()[f.name]
    assert "avg_batch_size" in row and "batch_wait_ms" in row
    for a, b in zip(sink_arrays(p), sink_arrays(ref)):
        np.testing.assert_array_equal(a[0], b[0])


def test_host_batched_calls_fewer_than_frames():
    """The window goes to invoke_batched whole: fewer calls than frames
    when frames are queued (pushed before the pipeline starts)."""
    xs = [np.full((8, 8, 3), i, np.uint8) for i in range(8)]
    p = parse_pipeline(HOST.format(props="batching=true max-batch=8 batch-timeout-ms=20"),
                       device="cpu")
    p.negotiate()
    calls = []
    real = p["f"].backend.invoke_batched
    p["f"].backend.invoke_batched = lambda batch: (calls.append(len(batch)), real(batch))[1]
    for x in xs:
        p["src"].push(Frame((x,)))
    p["src"].end_of_stream()
    p.run(timeout=60)
    assert p["f"].is_batch_capable()
    assert sum(calls) == 8 and len(calls) < 8
    for i, got in enumerate(sink_arrays(p)):
        np.testing.assert_array_equal(got[0], np.full((8, 8, 3), 3 * i, np.uint8))


def test_host_heterogeneous_window_runs_per_frame():
    kw = dict(framework="hostscaler", custom="factor:2.0", input="4", batching="true",
              max_batch="8")
    f, jf = TensorFilter(**kw), JFilter(**kw)
    f.fix_negotiation([TensorsSpec.from_strings("4", "float32")])
    from nnstreamer_tpu.tensors.spec import TensorsSpec as JSpec
    jf.fix_negotiation([JSpec.from_strings("4", "float32")])
    mixed = [np.arange(4, dtype=np.float32), np.arange(8, dtype=np.float32)]
    outs = f.host_process_batch([Frame((torch.from_numpy(m),)) for m in mixed])
    jouts = jf.host_process_batch([JFrame((m,)) for m in mixed])
    assert len(outs) == 2
    for o, j, m in zip(outs, jouts, mixed):
        np.testing.assert_array_equal(np.asarray(o.tensors[0]), m * 2)
        np.testing.assert_array_equal(np.asarray(o.tensors[0]), np.asarray(j.tensors[0]))
    f.stop()
    jf.stop()


def test_host_non_batchable_backend_keeps_per_frame():
    """framecounter keeps state and does not declare batchable: with
    batching=true it stays per frame and counts as the reference does."""
    desc = (
        "tensorsrc dimensions=2 num-frames=6 ! "
        "tensor_filter name=f framework=framecounter input=2 "
        "batching=true max-batch=4 ! tensor_sink name=out"
    )
    p = parse_pipeline(desc, device="cpu")
    p.run(timeout=60)
    ref = jax_parse(desc)
    ref.run(timeout=300)
    assert not p["f"].is_batch_capable()
    counts = [int(np.asarray(f[0]).ravel()[0]) for f in sink_arrays(p)]
    assert counts == [int(np.asarray(f[0]).ravel()[0]) for f in sink_arrays(ref)] == list(range(6))
    assert p["f"].batch_stats.batches == 0
