"""The routing and host-side element surface of the port against the JAX
package: request-pad graphs and the executor's fan-out/fan-in, mux /
demux / split / merge / join, tee / queue / capsfilter, tensor_if /
tensor_crop / tensor_repo, aggregator / rate, the sparse codecs, filesrc /
audiotestsrc / ``videotestsrc device=true`` and the converter's batching,
audio and octet paths.

Three kinds of check:

- the 16 goldens of this surface through ``nnstreamer_tpu_torch.cli
  --device cpu``, byte for byte against ``tests/golden/*.raw`` (the
  multi-source ones several times, so a race shows here as a failure),
  and the FAIL pipeline ``demux_pick_out_of_range``;
- the frame-order cases of ``tests/test_routing.py`` built from both
  packages' element classes on the same numpy-seeded frames: outputs held
  equal exactly (shape, dtype, bytes, pts, duration), besides the
  reference test's own assertions;
- the graph: parsed links equal to the JAX parser's, request pads, queue
  as a thread boundary, fan-in under full queues, EOS after every pad,
  and a tee whose branches share tensors.

Tolerances: exact everywhere, except ``tensor_crop out-size=`` against the
JAX element's compiled program, held to K1's ``interp_atol`` (1 for
uint8): XLA's fused program rounds the sample coordinates differently. The
same element math run by JAX without jit is held exactly.
"""

import os
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from nnstreamer_tpu.elements import base as jbase
from nnstreamer_tpu.elements import control as jcontrol
from nnstreamer_tpu.elements import flow as jflow
from nnstreamer_tpu.elements import routing as jrouting
from nnstreamer_tpu.elements import sink as jsink
from nnstreamer_tpu.elements import sources as jsources
from nnstreamer_tpu.elements import sparse_elems as jsparse
from nnstreamer_tpu.elements import transform as jtransform
from nnstreamer_tpu.elements import windowing as jwindowing
from nnstreamer_tpu.pipeline.graph import Pipeline as JPipeline
from nnstreamer_tpu.pipeline.parse import parse_pipeline as jparse
from nnstreamer_tpu.tensors.frame import Frame as JFrame
from nnstreamer_tpu.tensors.spec import TensorsSpec as JSpec
from nnstreamer_tpu_torch import cli
from nnstreamer_tpu_torch.elements import base as tbase
from nnstreamer_tpu_torch.elements import control as tcontrol
from nnstreamer_tpu_torch.elements import flow as tflow
from nnstreamer_tpu_torch.elements import routing as trouting
from nnstreamer_tpu_torch.elements import sink as tsink
from nnstreamer_tpu_torch.elements import sources as tsources
from nnstreamer_tpu_torch.elements import sparse_elems as tsparse
from nnstreamer_tpu_torch.elements import transform as ttransform
from nnstreamer_tpu_torch.elements import windowing as twindowing
from nnstreamer_tpu_torch.ops.kernels import image_kernels
from nnstreamer_tpu_torch.pipeline.graph import Pipeline as TPipeline
from nnstreamer_tpu_torch.pipeline.parse import parse_pipeline as tparse
from nnstreamer_tpu_torch.tensors.frame import Frame as TFrame
from nnstreamer_tpu_torch.tensors.spec import TensorsSpec as TSpec

from test_golden import FAIL_PIPELINES, FIXTURE_DIR, GOLDEN_DIR, PIPELINES

A1_GOLDENS = [
    "mux_slowest", "mux_basepad", "mux_refresh", "demux_tensorpick",
    "demux_grouped", "split_merge", "if_branch", "if_fill_file", "rate_drop",
    "aggregator_window", "aggregator_overlap", "sparse_roundtrip",
    "converter_batch", "converter_octet", "converter_audio", "videotestsrc_device",
]
# two or three source threads race into a mux: run these several times
MULTI_SOURCE = {"mux_slowest", "mux_basepad", "mux_refresh", "demux_tensorpick",
                "demux_grouped"}
REPEATS = 5
TIMEOUT = 30

J = SimpleNamespace(
    name="jax", Pipeline=JPipeline, parse=jparse, Frame=JFrame, Spec=JSpec,
    NegotiationError=jbase.NegotiationError, TensorSrc=jsources.TensorSrc,
    AppSrc=jsources.AppSrc, Sink=jsink.TensorSink, Mux=jrouting.TensorMux,
    Demux=jrouting.TensorDemux, Merge=jrouting.TensorMerge, Split=jrouting.TensorSplit,
    Join=jrouting.Join, Combiner=jrouting.SyncCombiner, Tee=jflow.Tee,
    Aggregator=jwindowing.TensorAggregator, Rate=jwindowing.TensorRate,
    RateQoS=jwindowing.RateQoS, If=jcontrol.TensorIf, Crop=jcontrol.TensorCrop,
    register_if=jcontrol.register_if_condition,
    unregister_if=jcontrol.unregister_if_condition, REPO=jcontrol.REPO,
    SparseEnc=jsparse.TensorSparseEnc, SparseDec=jsparse.TensorSparseDec,
)
T = SimpleNamespace(
    name="torch", Pipeline=lambda: TPipeline(device="cpu"),
    parse=lambda d: tparse(d, device="cpu"), Frame=TFrame, Spec=TSpec,
    NegotiationError=tbase.NegotiationError, TensorSrc=tsources.TensorSrc,
    AppSrc=tsources.AppSrc, Sink=tsink.TensorSink, Mux=trouting.TensorMux,
    Demux=trouting.TensorDemux, Merge=trouting.TensorMerge, Split=trouting.TensorSplit,
    Join=trouting.Join, Combiner=trouting.SyncCombiner, Tee=tflow.Tee,
    Aggregator=twindowing.TensorAggregator, Rate=twindowing.TensorRate,
    RateQoS=twindowing.RateQoS, If=tcontrol.TensorIf, Crop=tcontrol.TensorCrop,
    register_if=tcontrol.register_if_condition,
    unregister_if=tcontrol.unregister_if_condition, REPO=tcontrol.REPO,
    SparseEnc=tsparse.TensorSparseEnc, SparseDec=tsparse.TensorSparseDec,
)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _assert_frames_equal(got, want):
    """Frame lists equal exactly: count, tensors (shape, dtype, bytes),
    pts and duration."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g.tensors) == len(w.tensors)
        for a, b in zip(g.tensors, w.tensors):
            a, b = _np(a), _np(b)
            assert a.shape == b.shape and a.dtype == b.dtype
            assert np.ascontiguousarray(a).tobytes() == np.ascontiguousarray(b).tobytes()
        assert (g.pts, g.duration) == (w.pts, w.duration)


def both(build):
    """Run ``build(pkg)`` for the JAX package and the port; the port's
    result is held equal to the JAX package's and returned."""
    want, got = build(J), build(T)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_frames_equal(got[k], want[k])
    else:
        _assert_frames_equal(got, want)
    return got


def tsrc(pkg, dims, n, pattern="random", rate=None, seed=0, types="float32", name=None):
    props = {"num-frames": n, "pattern": pattern, "seed": seed}
    if rate:
        props["framerate"] = rate
    return pkg.TensorSrc(name=name, dimensions=dims, types=types, **props)


def seeded(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


# -- the goldens through the port's CLI --------------------------------------

@pytest.mark.parametrize("name", A1_GOLDENS)
def test_a1_golden(name, tmp_path):
    with open(f"{GOLDEN_DIR}/{name}.raw", "rb") as f:
        want = f.read()
    for i in range(REPEATS if name in MULTI_SOURCE else 1):
        out = tmp_path / f"dump{i}.raw"
        desc = PIPELINES[name].format(out=out, fix=FIXTURE_DIR)
        assert cli.main(["--device", "cpu", "-q", "--timeout", str(TIMEOUT), desc]) == 0
        assert out.read_bytes() == want, f"{name}: run {i} differs from the golden"


def test_fail_demux_pick_out_of_range(capsys):
    assert cli.main(["--device", "cpu", "-q", FAIL_PIPELINES["demux_pick_out_of_range"]]) != 0
    err = capsys.readouterr().err
    assert "nns-launch:" in err and "Traceback" not in err and "out of range" in err


@pytest.mark.parametrize("name", A1_GOLDENS)
def test_parse_links_match_jax(name, tmp_path):
    """``t.``, ``name.src_N``, ``name.sink_N`` and forward references give
    the JAX parser's graph: the same elements in order, the same links."""
    desc = PIPELINES[name].format(out=tmp_path / "x.raw", fix=FIXTURE_DIR)

    def links(p):
        idx = {e: i for i, e in enumerate(p.elements)}
        return (
            [e.FACTORY_NAME for e in p.elements],
            sorted((idx[l.src], l.src_pad, idx[l.dst], l.dst_pad) for l in p.links),
        )

    assert links(tparse(desc, device="cpu")) == links(jparse(desc))


# -- TestMux ------------------------------------------------------------------

def test_mux_two_pads():
    def build(pkg):
        a, b = tsrc(pkg, "2", 3, seed=1), tsrc(pkg, "3", 3, seed=2)
        mux, sink = pkg.Mux(**{"sync-mode": "nosync"}), pkg.Sink()
        pkg.Pipeline().link(a, mux).link(b, mux).link(mux, sink).run(timeout=TIMEOUT)
        return sink.frames

    got = both(build)
    assert len(got) == 3 and got[0].num_tensors == 2
    assert got[0].tensors[0].shape == (2,) and got[0].tensors[1].shape == (3,)


def _combine(pkg, mode, option, n_pads, script):
    """Play ``script`` — ("push", pad, pts) / ("eos", pad) — into a
    SyncCombiner; the groups as pts lists, one list a step."""
    comb = pkg.Combiner(mode, option, n_pads)
    out = []
    for step in script:
        if step[0] == "push":
            groups = comb.push(step[1], pkg.Frame((np.zeros(1, np.float32),), pts=step[2]))
        else:
            groups = comb.mark_eos(step[1])
        out.append([[f.pts for f in g] for g in groups])
    return out, comb


def _combine_both(mode, option, n_pads, script):
    want, _ = _combine(J, mode, option, n_pads, script)
    got, comb = _combine(T, mode, option, n_pads, script)
    assert got == want
    return got, comb


def test_slowest_policy_drops_fast_pad():
    ms = 1_000_000
    got, _ = _combine_both("slowest", "", 2, [
        ("push", 1, 0), ("push", 1, 50 * ms), ("push", 0, 100 * ms), ("push", 1, 150 * ms)])
    assert got == [[], [], [], [[100 * ms, 50 * ms]]]


def test_refresh_policy():
    got, _ = _combine_both("refresh", "", 2, [
        ("push", 0, 0), ("push", 1, 0), ("push", 1, 10), ("push", 0, 5), ("eos", 0)])
    assert got == [[], [[0, 0]], [[0, 10]], [[5, 10]], []]


def test_refresh_fast_pad_never_gated():
    script = [("push", 0, 0), ("push", 1, 0)] + [("push", 0, k * 10) for k in range(1, 50)]
    got, comb = _combine_both("refresh", "", 2, script)
    assert got[2:] == [[[k * 10, 0]] for k in range(1, 50)]
    assert all(not q for q in comb.queues)  # nothing buffered


def test_refresh_priming_is_pts_merged():
    got, _ = _combine_both("refresh", "", 2, [
        ("push", 0, 0), ("push", 0, 10), ("push", 0, 20), ("push", 1, 0)])
    assert got[-1] == [[0, 0], [10, 0], [20, 0]]


def test_basepad_slack_window():
    got, _ = _combine_both("basepad", "0:10", 2, [("push", 1, 95), ("push", 0, 100)])
    assert got == [[], [[100, 95]]]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("mode,option", [
    ("nosync", ""), ("slowest", ""), ("basepad", "1"), ("basepad", "0:30"), ("refresh", ""),
])
def test_sync_combiner_random_arrivals(mode, option, seed):
    """Random pad timelines, interleavings and EOS points: the port's
    combiner forms the JAX package's groups, step by step."""
    rng = np.random.default_rng(seed)
    n_pads = 3
    timelines = []
    for _ in range(n_pads):
        period = int(rng.choice([10, 20, 33, 50]))
        n = int(rng.integers(1, 12))
        timelines.append([i * period + int(rng.integers(0, 5)) for i in range(n)])
    pending = [list(t) for t in timelines]
    script = []
    while any(pending) or any(p is not None for p in pending):
        live = [i for i, p in enumerate(pending) if p is not None]
        if not live:
            break
        pad = int(rng.choice(live))
        if pending[pad]:
            script.append(("push", pad, pending[pad].pop(0)))
        else:
            script.append(("eos", pad))
            pending[pad] = None
    _combine_both(mode, option, n_pads, script)


def test_mux_in_description():
    def build(pkg):
        p = pkg.parse(
            "tensorsrc name=s1 dimensions=2 num-frames=2 pattern=random seed=3 ! mux.sink_0 "
            "tensorsrc name=s2 dimensions=2 num-frames=2 pattern=random seed=4 ! mux.sink_1 "
            "tensor_mux name=mux sync-mode=nosync ! tensor_sink name=out"
        )
        p.run(timeout=TIMEOUT)
        return p["out"].frames

    got = both(build)
    assert len(got) == 2 and got[0].num_tensors == 2


# -- TestDemux ----------------------------------------------------------------

def test_demux_default_split():
    def build(pkg):
        src = tsrc(pkg, "2,3", 2, types="float32,float32", seed=5)
        demux, s1, s2 = pkg.Demux(), pkg.Sink(name="d1"), pkg.Sink(name="d2")
        p = pkg.Pipeline()
        p.chain(src, demux)
        p.link(demux, s1, src_pad=0).link(demux, s2, src_pad=1)
        p.run(timeout=TIMEOUT)
        return {"d1": s1.frames, "d2": s2.frames}

    got = both(build)
    assert got["d1"][0].tensors[0].shape == (2,) and got["d2"][0].tensors[0].shape == (3,)


def test_demux_tensorpick_reorder_group():
    def build(pkg):
        src = tsrc(pkg, "2,3,4", 1, types="float32,int32,uint8", seed=6)
        demux, s1, s2 = pkg.Demux(tensorpick="2,0:1"), pkg.Sink(), pkg.Sink()
        p = pkg.Pipeline()
        p.chain(src, demux)
        p.link(demux, s1, src_pad=0).link(demux, s2, src_pad=1)
        p.run(timeout=TIMEOUT)
        return {"a": s1.frames, "b": s2.frames}

    got = both(build)
    assert got["a"][0].tensors[0].shape == (4,) and got["b"][0].num_tensors == 2


# -- TestMergeSplit -------------------------------------------------------------

def test_merge_linear():
    def build(pkg):
        a, b = tsrc(pkg, "2:4", 2, seed=7), tsrc(pkg, "2:4", 2, seed=8)
        merge, sink = pkg.Merge(mode="linear", option="1", **{"sync-mode": "nosync"}), pkg.Sink()
        pkg.Pipeline().link(a, merge).link(b, merge).link(merge, sink).run(timeout=TIMEOUT)
        return sink.frames

    got = both(build)
    assert got[0].tensors[0].shape == (8, 2)  # ref dim 1 of 2:4 is canonical axis 0


def test_split_roundtrip():
    def build(pkg):
        src = tsrc(pkg, "4:2", 1, seed=9)  # canonical (2, 4)
        split, s1, s2 = pkg.Split(tensorseg="1:2,3:2"), pkg.Sink(), pkg.Sink()
        p = pkg.Pipeline()
        p.chain(src, split)
        p.link(split, s1, src_pad=0).link(split, s2, src_pad=1)
        p.run(timeout=TIMEOUT)
        return {"a": s1.frames, "b": s2.frames}

    got = both(build)
    assert got["a"][0].tensors[0].shape == (2, 1) and got["b"][0].tensors[0].shape == (2, 3)


@pytest.mark.parametrize("pkg", [J, T], ids=["jax", "torch"])
def test_split_bad_seg(pkg):
    src = tsrc(pkg, "4:2", 1)
    split = pkg.Split(tensorseg="1:2,1:2")
    p = pkg.Pipeline()
    p.chain(src, split)
    p.link(split, pkg.Sink(), src_pad=0).link(split, pkg.Sink(), src_pad=1)
    with pytest.raises(pkg.NegotiationError, match="tile"):
        p.negotiate()


# -- TestJoin -------------------------------------------------------------------

def test_join_forwards_everything():
    """Join forwards in arrival order, which two source threads race for:
    held as a multiset of frames, each branch's own order kept."""
    def build(pkg):
        a, b = tsrc(pkg, "2", 2, seed=10), tsrc(pkg, "2", 3, seed=11)
        join, sink = pkg.Join(), pkg.Sink()
        pkg.Pipeline().link(a, join).link(b, join).link(join, sink).run(timeout=TIMEOUT)
        return sorted(sink.frames, key=lambda f: _np(f.tensors[0]).tobytes())

    assert len(both(build)) == 5


# -- TestAggregator ---------------------------------------------------------------

@pytest.mark.parametrize("props,n_in,n_out,shape", [
    ({"frames-out": 3}, 6, 2, (3, 3)),                        # tumbling
    ({"frames-out": 3, "frames-flush": 1}, 5, 3, (3, 3)),     # sliding
    ({"frames-out": 2, "frames-dim": "0"}, 4, 2, (1, 6)),     # innermost dim
    ({"frames-out": 4, "frames-in": 2, "frames-flush": 2}, 5, 4, (2, 3)),
    ({"frames-out": 2, "concat": "false"}, 4, 2, (2, 1, 3)),  # stacked
], ids=["tumbling", "sliding", "frames-dim", "frames-in", "concat-false"])
def test_aggregator(props, n_in, n_out, shape):
    def build(pkg):
        src = tsrc(pkg, "3:1", n_in, rate="10/1", seed=12)
        agg, sink = pkg.Aggregator(**props), pkg.Sink()
        pkg.Pipeline().chain(src, agg, sink).run(timeout=TIMEOUT)
        return sink.frames

    got = both(build)
    assert len(got) == n_out and got[0].tensors[0].shape == shape


def test_aggregator_counter_windows():
    def build(pkg):
        src = tsrc(pkg, "1:1", 5, pattern="counter")
        agg, sink = pkg.Aggregator(**{"frames-out": 3, "frames-flush": 1}), pkg.Sink()
        pkg.Pipeline().chain(src, agg, sink).run(timeout=TIMEOUT)
        return sink.frames

    got = both(build)
    assert [list(_np(f.tensors[0]).ravel()) for f in got] == [[0, 1, 2], [1, 2, 3], [2, 3, 4]]


def test_aggregator_concat_false_stacks():
    def run(pkg):
        agg = pkg.Aggregator("agg0", **{"frames-out": 3, "concat": "false"})
        if pkg is T:
            agg.device = torch.device("cpu")
        (out_spec,) = agg.negotiate([pkg.Spec.from_strings("4:2:1", "float32")])
        assert out_spec[0].shape == (3, 1, 2, 4)
        outs = []
        for i in range(3):
            r = agg.process(pkg.Frame((np.full((1, 2, 4), float(i), np.float32),)))
            if r is not None:
                outs.append(r)
        return outs

    got = both(run)
    assert len(got) == 1 and float(_np(got[0].tensors[0])[2, 0, 0, 0]) == 2.0


# -- TestRate ---------------------------------------------------------------------

@pytest.mark.parametrize("n,rate,target,n_out", [
    (10, "10/1", "5/1", 5), (4, "5/1", "10/1", 8), (9, "30/1", "20/1", 6),
])
def test_rate(n, rate, target, n_out):
    def build(pkg):
        src = tsrc(pkg, "2", n, rate=rate, seed=13)
        r, sink = pkg.Rate(framerate=target), pkg.Sink()
        pkg.Pipeline().chain(src, r, sink).run(timeout=TIMEOUT)
        return sink.frames

    got = both(build)
    assert len(got) == n_out


def _pts_script_frames(pkg, seed):
    """Frames with hand-fed, jittered PTS (some without a duration)."""
    rng = np.random.default_rng(seed)
    pts, frames = 0, []
    for i in range(30):
        dur = int(rng.choice([20, 33, 50])) * 1_000_000
        frames.append(pkg.Frame((np.full(2, i, np.float32),), pts=pts,
                                duration=None if i % 7 == 6 else dur))
        pts += dur + int(rng.integers(0, 3)) * 1_000_000
    return frames


@pytest.mark.parametrize("target", ["10/1", "24/1", "60/1"])
def test_rate_dup_drop_and_qos_on_hand_fed_pts(target):
    """tensor_rate's dup/drop and its drop-ahead hint on PTS fed by hand
    (no clock, no sleep): the same outputs, counters and hints."""
    def run(pkg):
        r = pkg.Rate(framerate=target)
        r.negotiate([pkg.Spec.from_strings("2", "float32")])
        outs, hints = [], []
        for f in _pts_script_frames(pkg, 14):
            hints.append((r.qos.would_drop(f.pts, f.duration), r.qos.next_ts))
            got = r.process(f)
            outs += got if isinstance(got, list) else ([got] if got is not None else [])
        hints.append((r.dup, r.drop))
        return outs, hints

    (want, want_hints), (got, got_hints) = run(J), run(T)
    _assert_frames_equal(got, want)
    assert got_hints == want_hints


@pytest.mark.parametrize("pkg", [J, T], ids=["jax", "torch"])
def test_rate_qos_wires_upstream_through_transform_only(pkg):
    """The drop-ahead hint reaches producers on the linear path through
    transforms and queues; it stops at a tee (other branches need the
    frame)."""
    p = pkg.parse(
        "tensorsrc dimensions=2 num-frames=2 framerate=10/1 ! tee name=t "
        "t. ! queue name=q ! tensor_transform name=tr mode=typecast option=float32 ! "
        "tensor_rate name=r framerate=5/1 ! tensor_sink "
        "t. ! tensor_sink"
    )
    p.negotiate()
    qos = p["r"].qos
    assert p["tr"].qos_sources == [qos] and p["q"].qos_sources == [qos]
    assert p["t"].qos_sources == []


def test_producer_skips_frames_the_rate_would_drop():
    """With the hint already past the first frames, the transform's node
    skips them instead of computing them (counted as skipped upstream),
    in both packages alike: the outputs are the same frames."""
    frames = [seeded((2,), i) for i in range(12)]
    dur = 50_000_000
    skipped_below = 5  # frames 0..4 end at or before the hint

    def build(pkg):
        src = pkg.AppSrc(iterable=[pkg.Frame((f,), pts=i * dur, duration=dur)
                                   for i, f in enumerate(frames)],
                         spec=pkg.Spec.from_strings("2", "float32"))
        p = pkg.Pipeline()
        tr = (jtransform if pkg is J else ttransform).TensorTransform(
            mode="arithmetic", option="mul:3")
        r, sink = pkg.Rate(framerate="10/1"), pkg.Sink()
        p.chain(src, tr, r, sink)
        p.negotiate()
        assert tr.qos_sources == [r.qos]
        r.qos.next_ts = skipped_below * dur
        p.run(timeout=TIMEOUT)
        assert r.qos.skipped_upstream >= skipped_below
        return sink.frames

    got = both(build)
    assert got[0].pts == skipped_below * dur
    np.testing.assert_array_equal(got[0].tensors[0], 3 * frames[skipped_below])


# -- TestIf -----------------------------------------------------------------------

def _if_run(pkg, frames, spec, props):
    src = pkg.AppSrc(iterable=[(f,) for f in frames], spec=pkg.Spec.from_strings(*spec))
    tif, sink = pkg.If(**props), pkg.Sink()
    pkg.Pipeline().chain(src, tif, sink).run(timeout=TIMEOUT)
    return sink.frames


def test_if_average_value_branch():
    frames = [np.full((4,), v, np.float32) for v in (1.0, 5.0, 2.0, 9.0)]
    got = both(lambda pkg: _if_run(pkg, frames, ("4", "float32"), {
        "compared-value": "TENSOR_AVERAGE_VALUE", "compared-value-option": "0",
        "operator": "GT", "supplied-value": "3", "then": "PASSTHROUGH", "else": "SKIP"}))
    assert [float(_np(f.tensors[0])[0]) for f in got] == [5.0, 9.0]


def test_if_fill_zero_and_range():
    frames = [np.full((2,), v, np.float32) for v in (1.0, 5.0)]
    got = both(lambda pkg: _if_run(pkg, frames, ("2", "float32"), {
        "compared-value": "A_VALUE", "compared-value-option": "0,0",
        "operator": "RANGE_INCLUSIVE", "supplied-value": "0:3",
        "then": "PASSTHROUGH", "else": "FILL_ZERO"}))
    np.testing.assert_array_equal(_np(got[0].tensors[0]), 1.0)
    np.testing.assert_array_equal(_np(got[1].tensors[0]), 0.0)


def test_if_custom_condition():
    def cond(f):
        return float(_np(f.tensors[0])[0]) % 2 == 0

    for pkg in (J, T):
        pkg.register_if("even_seq", cond)
    try:
        frames = [np.full((1,), v, np.float32) for v in (0, 1, 2, 3)]
        got = both(lambda pkg: _if_run(pkg, frames, ("1", "float32"), {
            "compared-value": "CUSTOM", "compared-value-option": "even_seq"}))
        assert len(got) == 2
    finally:
        for pkg in (J, T):
            pkg.unregister_if("even_seq")


OPERATORS = ["EQ", "NE", "GT", "GE", "LT", "LE", "RANGE_INCLUSIVE", "RANGE_EXCLUSIVE",
             "NOT_IN_RANGE_INCLUSIVE", "NOT_IN_RANGE_EXCLUSIVE"]


@pytest.mark.parametrize("else_action,else_option", [
    ("SKIP", ""), ("FILL_ZERO", ""), ("FILL_VALUES", "7.5"), ("TENSORPICK", "1"),
    ("REPEAT_PREVIOUS_FRAME", ""), ("FILL_WITH_FILE", "octet20.bin"),
    ("FILL_WITH_FILE_RPT", "octet20.bin"),
])
@pytest.mark.parametrize("operator", OPERATORS)
def test_if_operators_and_actions(operator, else_action, else_option):
    """Every operator against every else-action on seeded two-tensor
    frames whose compared values straddle the supplied ones."""
    rng = np.random.default_rng(OPERATORS.index(operator))
    vals = rng.choice([0.0, 1.0, 2.0, 3.0, 4.0], 10)
    frames = [(np.full((2, 3), v, np.float32) + seeded((2, 3), i) * 1e-3 * (i % 2),
               rng.integers(0, 9, (4,)).astype(np.int32)) for i, v in enumerate(vals)]
    supplied = "1:3" if "RANGE" in operator else "2"
    then_action = "TENSORPICK" if else_action == "TENSORPICK" else "PASSTHROUGH"
    props = {"compared-value": "A_VALUE", "compared-value-option": "0:0,0",
             "operator": operator, "supplied-value": supplied,
             "then": then_action, "then-option": else_option if then_action == "TENSORPICK" else "",
             "else": else_action,
             "else-option": (os.path.join(FIXTURE_DIR, else_option)
                             if else_action.startswith("FILL_WITH") else else_option)}
    if then_action == "TENSORPICK":
        props["else"], props["else-option"] = "SKIP", ""

    def run(pkg):
        src = pkg.AppSrc(iterable=[pkg.Frame(f, pts=i) for i, f in enumerate(frames)],
                         spec=pkg.Spec.from_strings("3:2,4", "float32,int32"))
        tif, sink = pkg.If(**props), pkg.Sink()
        pkg.Pipeline().chain(src, tif, sink).run(timeout=TIMEOUT)
        return sink.frames

    both(run)


def test_tensor_if_repeats_previous_output_not_input():
    """REPEAT_PREVIOUS_FRAME resends the previous *output* frame."""
    def run(pkg):
        elem = pkg.If("if0", **{
            "compared-value": "A_VALUE", "compared-value-option": "0:0:0:0,0",
            "operator": "GE", "supplied-value": "10", "then": "PASSTHROUGH",
            "else": "REPEAT_PREVIOUS_FRAME"})
        if pkg is T:
            elem.device = torch.device("cpu")
        return [elem.process(pkg.Frame((np.full((1, 1, 1, 1), v, np.float32),), pts=i))
                for i, v in enumerate((20.0, 5.0, 1.0))]

    got = both(run)
    assert [float(_np(f.tensors[0]).ravel()[0]) for f in got] == [20.0, 20.0, 20.0]


# -- TestCrop ---------------------------------------------------------------------

def test_crop_by_boxes_host_mode():
    img = np.arange(1 * 8 * 8 * 1, dtype=np.float32).reshape(1, 8, 8, 1)
    boxes = np.array([[0, 0, 4, 4], [2, 2, 3, 3], [7, 7, 4, 4], [3, 3, 0, 2]], np.uint32)

    def build(pkg):
        raw = pkg.AppSrc(iterable=[(img,)], spec=pkg.Spec.from_strings("1:8:8:1", "float32"))
        info = pkg.AppSrc(iterable=[(boxes,)], spec=pkg.Spec.from_strings("4:4", "uint32"))
        crop, sink = pkg.Crop(), pkg.Sink()
        p = pkg.Pipeline()
        p.link(raw, crop, dst_pad=0).link(info, crop, dst_pad=1).link(crop, sink)
        p.run(timeout=TIMEOUT)
        return sink.frames

    (f,) = both(build)
    assert [t.shape for t in f.tensors] == [(1, 4, 4, 1), (1, 3, 3, 1), (1, 1, 1, 1)]
    np.testing.assert_array_equal(f.tensors[0], img[:, 0:4, 0:4, :])


def _crop_regions(seed, n, h, w):
    """[n, 4] uint32 x, y, w, h: three zero-size, two past the frame edge."""
    rng = np.random.default_rng(seed)
    xy = np.stack([rng.integers(0, w, n), rng.integers(0, h, n)], 1)
    wh = np.stack([rng.integers(1, w // 2, n), rng.integers(1, h // 2, n)], 1)
    wh[:3] = [[0, 5], [6, 0], [0, 0]]
    xy[3:5] = [[w - 4, h - 3], [w // 2, h - 2]]
    wh[3:5] = [[w // 2, h // 2], [w, h]]
    return np.concatenate([xy, wh], 1).astype(np.uint32)


def _device_crop(pkg, img, boxes, out_size="112:112", k=16):
    crop = pkg.Crop(**{"out-size": out_size, "max-crops": str(k)})
    if pkg is T:
        crop.device = torch.device("cpu")
    else:  # device arrays, as a JAX pipeline hands them over
        img, boxes = jax.numpy.asarray(img), jax.numpy.asarray(boxes)
    crop.set_pad_counts(2, 1)
    h, w, c = img.shape[1:]
    crop.fix_negotiation([pkg.Spec.from_strings(f"{c}:{w}:{h}:1", "uint8"),
                          pkg.Spec.from_strings(f"4:{boxes.shape[0]}", "uint32")])
    assert crop.receive(0, pkg.Frame((img,), pts=5)) == []
    ((pad, out),) = crop.receive(1, pkg.Frame((boxes,), pts=5))
    assert pad == 0 and crop.out_specs[0][0].shape == (k, 112, 112, c)
    return out


@pytest.mark.parametrize("n", [16, 9, 23], ids=["k", "pad", "truncate"])
def test_crop_out_size_matches_jax(n):
    """tensor_crop out-size=112:112 max-crops=16 on the same image and
    regions (zero-size ones and ones past the edge included): exactly the
    JAX element's math run without jit, within K1's tolerance of its
    compiled program; zero-size regions give all-zero rows; the regions
    ride on in meta as int32, padded or cut to K."""
    img = np.random.default_rng(n).integers(0, 256, (1, 90, 120, 3)).astype(np.uint8)
    boxes = _crop_regions(n, n, 90, 120)
    before = image_kernels.crop_resize_launches.count
    got = _device_crop(T, img, boxes)
    assert image_kernels.crop_resize_launches.count == before  # CPU: the plain version
    crops, regions = got.tensors[0], got.meta["crop_regions"]
    assert isinstance(crops, torch.Tensor) and crops.dtype == torch.uint8
    assert isinstance(regions, torch.Tensor) and regions.dtype == torch.int32
    assert got.pts == 5
    with jax.disable_jit():
        eager = _device_crop(J, img, boxes)
    np.testing.assert_array_equal(crops.numpy(), np.asarray(eager.tensors[0]))
    np.testing.assert_array_equal(regions.numpy(), np.asarray(eager.meta["crop_regions"]))
    compiled = np.asarray(_device_crop(J, img, boxes).tensors[0]).astype(np.int16)
    tol = image_kernels.interp_atol(torch.uint8, 90, 120)
    assert np.abs(crops.numpy().astype(np.int16) - compiled).max() <= tol
    assert not crops[:3].any()  # the zero-size regions
    if n < 16:
        assert not crops[n:].any() and not regions[n:].any()
    assert crops[3:min(n, 16)].flatten(1).any(1).all()


def test_crop_out_size_in_a_pipeline():
    """The crop cascade's shape at a small size, described as the chip run
    describes it: tee, two queues, the crop fed by an appsrc, resize, mux,
    demux; the port's sinks equal the JAX package's (crops within K1's
    tolerance of its compiled program, thumbnails exact)."""
    n = 3
    boxes = [_crop_regions(20 + i, 16, 48, 64) for i in range(n)]
    desc = (
        "videotestsrc pattern=gradient width=64 height=48 num-frames={n} ! "
        "tensor_converter ! tee name=t "
        "t. ! queue ! crop.sink_0 "
        "appsrc name=regions dimensions=4:16 types=uint32 ! crop.sink_1 "
        "tensor_crop name=crop out-size=112:112 max-crops=16 ! mux.sink_0 "
        "t. ! queue ! tensor_transform mode=resize option=32:24 ! mux.sink_1 "
        "tensor_mux name=mux sync-mode=slowest ! tensor_demux name=d "
        "d.src_0 ! tensor_sink name=crops d.src_1 ! tensor_sink name=thumbs"
    ).format(n=n)

    def run(pkg):
        p = pkg.parse(desc)
        ex = p.start()
        for i, b in enumerate(boxes):
            p["regions"].push(pkg.Frame((b,), pts=i * 33_333_333, duration=33_333_333))
        p["regions"].end_of_stream()
        assert ex.wait(TIMEOUT)
        ex.stop()
        assert not ex.errors
        return p["crops"].frames, p["thumbs"].frames

    (jc, jt), (tc, tt) = run(J), run(T)
    _assert_frames_equal(tt, jt)
    assert len(tc) == len(jc) == n
    for g, w in zip(tc, jc):
        assert g.tensors[0].shape == (16, 112, 112, 3) and g.pts == w.pts
        assert np.abs(g.tensors[0].astype(np.int16) - w.tensors[0].astype(np.int16)).max() <= 1
        assert not g.tensors[0][:3].any()


# -- TestRepo ---------------------------------------------------------------------

def test_repo_feedback_loop():
    """reposrc → +1 → tee → reposink closes a loop outside the pad graph:
    the state threads through, the same values in both packages."""
    def run(pkg):
        p = pkg.parse(
            "tensor_reposrc slot-index=7 dimensions=1 types=float32 ! "
            "tensor_transform mode=arithmetic option=add:1 ! tee name=t "
            "t. ! tensor_reposink slot-index=7 "
            "t. ! tensor_sink name=out"
        )
        try:
            p.start()
            deadline = time.monotonic() + TIMEOUT
            while p["out"].rendered < 5 and time.monotonic() < deadline:
                time.sleep(0.01)
            p.stop()
            return [float(_np(f.tensors[0])[0]) for f in p["out"].frames[:5]]
        finally:
            pkg.REPO.reset(7)

    want, got = run(J), run(T)
    assert got == want == [1.0, 2.0, 3.0, 4.0, 5.0]


# -- TestSparseElements -------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "uint8", "int16"])
def test_sparse_enc_dec_roundtrip(dtype):
    data = np.zeros((4, 4), dtype)
    data[1, 2], data[3, 0] = 7, 3

    def build(pkg):
        src = pkg.AppSrc(iterable=[(data,)], spec=pkg.Spec.from_strings("4:4", dtype))
        enc, sink = pkg.SparseEnc(), pkg.Sink(name="enc")
        dec, sink2 = pkg.SparseDec(), pkg.Sink(name="dec")
        tee = pkg.Tee()
        p = pkg.Pipeline()
        p.chain(src, enc, tee)
        p.link(tee, sink)
        p.chain(tee, dec, sink2)
        p.run(timeout=TIMEOUT)
        return {"enc": sink.frames, "dec": sink2.frames}

    got = both(build)
    np.testing.assert_array_equal(got["dec"][0].tensors[0], data)


def test_sparse_enc_compresses():
    data = np.zeros((64, 64), np.float32)
    data[0, 0] = 1

    def build(pkg):
        src = pkg.AppSrc(iterable=[(data,)], spec=pkg.Spec.from_strings("64:64", "float32"))
        enc, sink = pkg.SparseEnc(), pkg.Sink()
        pkg.Pipeline().chain(src, enc, sink).run(timeout=TIMEOUT)
        return sink.frames

    assert both(build)[0].tensors[0].nbytes < data.nbytes


# -- graph and executor -----------------------------------------------------------

def test_request_pads_are_numbered_from_zero():
    p = tparse(
        "tensorsrc dimensions=2 num-frames=1 ! mux.sink_0 "
        "tensorsrc dimensions=2 num-frames=1 ! mux.sink_2 "
        "tensor_mux name=mux ! fakesink", device="cpu",
    )
    with pytest.raises(tbase.NegotiationError, match="sink pads"):
        p.negotiate()


def test_queue_splits_fusion():
    """queue is a thread boundary (flow.py): the ops on each side fuse
    among themselves, the queue is a node of its own, and its frames pass
    through untouched."""
    p = tparse(
        "videotestsrc num-frames=2 width=8 height=8 ! tensor_converter ! "
        "tensor_transform mode=typecast option=float32 ! queue ! "
        "tensor_transform mode=arithmetic option=add:1 ! "
        "tensor_transform mode=arithmetic option=mul:2 ! tensor_sink name=out",
        device="cpu",
    )
    plan = p.compile_plan()
    assert [[o.FACTORY_NAME for o in s.ops] for s in plan.segments] == [
        ["tensor_converter", "tensor_transform"], ["queue"],
        ["tensor_transform", "tensor_transform"]]
    assert [s.fused for s in plan.segments] == [True, False, True]
    p.run(timeout=TIMEOUT)
    assert p["out"].rendered == 2


def test_fan_out_and_in_does_not_deadlock():
    """tee → two queues of depth 1 → mux, 200 frames: the mux drains both
    pads in turn, so a full branch never blocks the other."""
    def build(pkg):
        p = pkg.parse(
            "tensorsrc dimensions=4 num-frames=200 framerate=100/1 pattern=random ! tee name=t "
            "t. ! queue max-size-buffers=1 ! mux.sink_0 "
            "t. ! queue max-size-buffers=1 ! "
            "tensor_transform mode=arithmetic option=mul:2 ! mux.sink_1 "
            "tensor_mux name=mux sync-mode=slowest ! tensor_sink name=out"
        )
        p.run(timeout=TIMEOUT)
        return p["out"].frames

    got = both(build)
    assert len(got) == 200
    np.testing.assert_array_equal(got[7].tensors[1], 2 * got[7].tensors[0])


def test_eos_waits_for_every_sink_pad():
    """A join over a short and a long branch: EOS leaves only after both
    pads saw it, so every frame of the long branch arrives."""
    for pkg in (J, T):
        a, b = tsrc(pkg, "2", 2, seed=1), tsrc(pkg, "2", 40, seed=2)
        join, sink = pkg.Join(), pkg.Sink()
        pkg.Pipeline().link(a, join).link(b, join).link(join, sink).run(timeout=TIMEOUT)
        assert sink.rendered == 42 and sink.eos_seen


def test_tee_branches_share_tensors_untouched():
    """Both branches of a tee receive the same tensors; an element on one
    branch that might write in place (a per-channel arithmetic) leaves the
    other branch's frames as the source made them."""
    desc = (
        "videotestsrc pattern=gradient num-frames=3 width=8 height=6 ! tensor_converter ! "
        "tensor_transform mode=typecast option=float32 ! tee name=t "
        "t. ! queue ! tensor_transform mode=arithmetic "
        'option="per-channel:true@0,add:100@0,mul:2@2" ! tensor_sink name=a '
        "t. ! queue ! tensor_sink name=b"
    )

    def build(pkg):
        p = pkg.parse(desc)
        p.run(timeout=TIMEOUT)
        return {"a": p["a"].frames, "b": p["b"].frames}

    got = both(build)
    plain = tparse(
        "videotestsrc pattern=gradient num-frames=3 width=8 height=6 ! tensor_converter ! "
        "tensor_transform mode=typecast option=float32 ! tensor_sink name=b", device="cpu")
    plain.run(timeout=TIMEOUT)
    _assert_frames_equal(got["b"], plain["b"].frames)
    assert not np.array_equal(got["a"][0].tensors[0], got["b"][0].tensors[0])


@pytest.mark.parametrize("caps,ok", [
    ("other/tensors,dimensions=(string)4,types=(string)float32", True),
    ("other/tensors,dimensions=5,types=float32", False),
])
def test_caps_token_builds_a_capsfilter(caps, ok):
    desc = f"tensorsrc dimensions=4 num-frames=2 pattern=random ! {caps} ! tensor_sink name=out"
    if not ok:
        for pkg in (J, T):
            with pytest.raises(pkg.NegotiationError, match="caps mismatch"):
                pkg.parse(desc).negotiate()
        return

    def build(pkg):
        p = pkg.parse(desc)
        p.run(timeout=TIMEOUT)
        return p["out"].frames

    assert len(both(build)) == 2


# -- sources and the converter ------------------------------------------------------

@pytest.mark.parametrize("pattern", ["gradient", "counter", "solid", "random"])
def test_videotestsrc_device_true_matches_host(pattern):
    """``device=true`` makes each frame on the pipeline's device: the same
    bytes as the host pattern and as the JAX package's device source."""
    desc = (f"videotestsrc pattern={pattern} num-frames=3 width=10 height=6 seed=4 "
            "device={dev} ! tensor_converter ! tensor_sink name=out")

    def build(pkg, dev="true"):
        p = pkg.parse(desc.format(dev=dev))
        p.run(timeout=TIMEOUT)
        return p["out"].frames

    got = both(build)
    _assert_frames_equal(got, build(T, "false"))


@pytest.mark.parametrize("channels,spb,fpt", [(1, 64, 1), (2, 32, 1), (2, 16, 3)])
def test_audio_ingress_matches_jax(channels, spb, fpt):
    desc = (f"audiotestsrc samples-per-buffer={spb} num-buffers=7 channels={channels} "
            f"freq=1000 ! tensor_converter frames-per-tensor={fpt} ! tensor_sink name=out")

    def build(pkg):
        p = pkg.parse(desc)
        p.run(timeout=TIMEOUT)
        return p["out"].frames

    got = both(build)
    assert len(got) == 7 // fpt and got[0].tensors[0].shape == (spb * fpt, channels)
    assert got[0].tensors[0].dtype == np.int16


@pytest.mark.parametrize("fpt", [2, 3])
def test_video_frames_per_tensor_matches_jax(fpt):
    desc = ("videotestsrc pattern=random num-frames=7 width=6 height=4 seed=2 ! "
            f"tensor_converter frames-per-tensor={fpt} ! tensor_sink name=out")

    def build(pkg):
        p = pkg.parse(desc)
        p.run(timeout=TIMEOUT)
        return p["out"].frames

    got = both(build)
    assert len(got) == 7 // fpt and got[0].tensors[0].shape == (fpt, 4, 6, 3)


@pytest.mark.parametrize("blocksize,dims,types", [
    (5, "5", "uint8"),
    (10, "2,2:1", "uint8,float32"),   # a float32 after two bytes: unaligned
    (24, "4:1,2", "int16,float64"),
])
def test_octet_ingress_matches_jax(tmp_path, blocksize, dims, types):
    path = tmp_path / "blob.bin"
    path.write_bytes(np.random.default_rng(blocksize).integers(0, 256, 120, np.uint8).tobytes())
    desc = (f"filesrc location={path} blocksize={blocksize} ! tensor_converter "
            f"input-dim={dims} input-type={types} ! tensor_sink name=out")

    def build(pkg):
        p = pkg.parse(desc)
        p.run(timeout=TIMEOUT)
        return p["out"].frames

    assert len(both(build)) == 120 // blocksize


def test_flexible_to_static_after_host_crop():
    """tensor_crop's host mode gives flexible frames; a converter with
    input-dim makes them static again."""
    img = seeded((1, 8, 8, 2), 3)
    boxes = np.array([[1, 2, 3, 3]], np.uint32)

    def build(pkg):
        p = pkg.parse(
            "appsrc name=raw dimensions=2:8:8:1 ! crop.sink_0 "
            "appsrc name=info dimensions=4:1 types=uint32 ! crop.sink_1 "
            "tensor_crop name=crop ! tensor_converter input-dim=2:3:3:1 input-type=float32 ! "
            "tensor_sink name=out"
        )
        p["raw"]._iter = iter([(img,)])
        p["info"]._iter = iter([(boxes,)])
        p.run(timeout=TIMEOUT)
        return p["out"].frames

    (f,) = both(build)
    np.testing.assert_array_equal(f.tensors[0], img[:, 2:5, 1:4, :])
