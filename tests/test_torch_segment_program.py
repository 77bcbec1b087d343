"""The port's compiled fused segment and its batch-norm fold, on the CPU.

- ``ConvBN`` folds batch norm once (``inv``, ``shift`` buffers): on
  reference-shaped trees with numpy-seeded batch-norm vectors,
  MobileNet-v2, SSD and face-detect give the same bits as the per-call
  formula they replace, in float32 and bfloat16, and the buffers follow a
  ``params:`` overlay, a move and a cast.
- ``FusedSegment``: the identity short-circuit, ``process_eager`` equal to
  ``process``, ``build()`` filling exactly the negotiated entry (and the
  max-batch bucket with batching on), the program cache against the JAX
  package's jit cache (``n_traces``), and the launch tally a CUDA graph's
  capture keeps its kernels' counts in.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from nnstreamer_tpu.models import face_pipeline as jfp
from nnstreamer_tpu.models import mobilenet_v2 as jmobilenet
from nnstreamer_tpu.models import ssd_mobilenet as jssd
from nnstreamer_tpu.pipeline.parse import parse_pipeline as jax_parse
from nnstreamer_tpu.tensors.frame import Frame as JFrame
from nnstreamer_tpu_torch.elements import transform as ttransform
from nnstreamer_tpu_torch.models import nn as tnn
from nnstreamer_tpu_torch.models import zoo as tzoo
from nnstreamer_tpu_torch.ops.kernels import LaunchCounter, launch_tally
from nnstreamer_tpu_torch.pipeline.batching import BatchConfig
from nnstreamer_tpu_torch.pipeline.parse import parse_pipeline
from nnstreamer_tpu_torch.tensors.frame import Frame


def seeded_tree(init, seed):
    """A tree of the reference's shapes with numpy-seeded values: convs
    N(0, 2/fan_in), batch-norm scale and var in [0.5, 1.5), the other
    vectors N(0, 0.1), so a fold that reorders an op would show."""
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if len(s.shape) == 4:
            a = rng.standard_normal(s.shape) * np.sqrt(2.0 / np.prod(s.shape[:3]))
        elif len(s.shape) == 2:
            a = rng.standard_normal(s.shape) / np.sqrt(s.shape[0])
        elif name in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, s.shape)
        else:
            a = rng.standard_normal(s.shape) * 0.1
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def save_npz(tree, path):
    leaves = jax.tree_util.tree_leaves(tree)
    np.savez(path, **{f"p{i}": np.asarray(v) for i, v in enumerate(leaves)})
    return str(path)


def per_call_forward(self, x):
    """ConvBN's forward before the fold: inv and shift at every call."""
    y = tnn.conv2d_same(x, self.weight, self.stride, self.groups, self.dilation)
    inv = torch.rsqrt(self.var + self.eps) * self.scale
    shift = self.bias - self.mean * inv
    y = y * inv[:, None, None] + shift[:, None, None]
    return tnn.relu6(y) if self.act else y


MODELS = {
    "mobilenet_v2": (functools.partial(jmobilenet.init_params, num_classes=11, width=0.35),
                     {"num_classes": "11", "width": "0.35", "size": "64"}, 64),
    "ssd_mobilenet_v2": (functools.partial(jssd.init_params, num_classes=5),
                         {"num_classes": "5"}, 300),
    "face_detect": (jfp.init_detect_params, {}, 128),
}


@pytest.fixture(scope="module")
def npz_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("fold")
    return {name: save_npz(seeded_tree(init, 7), d / f"{name}.npz")
            for name, (init, _, _) in MODELS.items()}


def outputs(module, x):
    with torch.inference_mode():
        out = module(x)
    return out if isinstance(out, (tuple, list)) else (out,)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_fold_bit_identical_to_per_call_formula(npz_files, monkeypatch, name, dtype):
    _, opts, size = MODELS[name]
    m = tzoo.get(name, device="cpu", params=npz_files[name], compute_dtype=dtype, **opts)
    x = torch.from_numpy(
        np.random.default_rng(3).integers(0, 256, (1, size, size, 3)).astype(np.uint8))
    folded = outputs(m.module, x)
    convs = [c for c in m.module.modules() if isinstance(c, tnn.ConvBN)]
    assert convs and all(c.inv.dtype == getattr(torch, dtype) for c in convs)
    monkeypatch.setattr(tnn.ConvBN, "forward", per_call_forward)
    per_call = outputs(m.module, x)
    assert len(folded) == len(per_call)
    for a, b in zip(folded, per_call):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_fold_follows_params_overlay_and_cast(npz_files):
    """The buffers are the loaded vectors' fold, not the seeded init's; a
    cast refolds in the new dtype (not a cast of the float32 fold)."""
    _, opts, _ = MODELS["mobilenet_v2"]
    seeded = tzoo.get("mobilenet_v2", device="cpu", **opts).module
    loaded = tzoo.get("mobilenet_v2", device="cpu", params=npz_files["mobilenet_v2"],
                      **opts).module
    pairs = [(a, b) for a, b in zip(seeded.modules(), loaded.modules())
             if isinstance(a, tnn.ConvBN)]
    assert pairs
    for a, b in pairs:
        want = torch.rsqrt(b.var + b.eps) * b.scale
        assert torch.equal(b.inv, want)
        assert torch.equal(b.shift, b.bias - b.mean * want)
        assert not torch.equal(a.inv, b.inv)  # the overlay moved them
    conv = pairs[0][1]
    conv.to(torch.bfloat16)
    v, s = conv.var, conv.scale
    assert conv.inv.dtype == torch.bfloat16
    assert torch.equal(conv.inv, torch.rsqrt(v + conv.eps) * s)
    assert "inv" not in conv.state_dict() and "shift" not in conv.state_dict()


def test_fold_refreshed_by_load_state_dict():
    a = tnn.ConvBN(4, 6, 3, generator=torch.Generator().manual_seed(1))
    state = a.state_dict()
    rng = np.random.default_rng(5)
    for k in ("scale", "var"):
        state[k] = torch.from_numpy(rng.uniform(0.5, 1.5, 6).astype(np.float32))
    for k in ("bias", "mean"):
        state[k] = torch.from_numpy(rng.standard_normal(6).astype(np.float32))
    a.load_state_dict(state)
    inv = torch.rsqrt(state["var"] + a.eps) * state["scale"]
    assert torch.equal(a.inv, inv)
    assert torch.equal(a.shift, state["bias"] - state["mean"] * inv)


# -- the fused segment ------------------------------------------------------

SEGMENT = (
    "tensorsrc dimensions=4 num-frames=1 ! "
    "tensor_transform mode=arithmetic option=add:1.0 ! "
    "tensor_filter framework=scaler custom=factor:2.0 input=4 ! tensor_sink"
)


def segment(parse, desc=SEGMENT, **kw):
    plan = parse(desc, **kw).compile_plan()
    return next(s for s in plan.segments if len(s.ops) >= 2)


def test_identity_segment_short_circuits():
    desc = ("tensorsrc dimensions=4 num-frames=1 ! "
            "tensor_filter framework=passthrough input=4 ! tensor_sink")
    plan = parse_pipeline(desc, device="cpu").compile_plan()
    (seg,) = plan.segments
    assert seg.is_identity() and seg.build() is None
    f = Frame((torch.arange(4, dtype=torch.float32),))
    out = seg.process(f)
    assert out.tensors[0] is f.tensors[0] and seg.n_traces == 0
    outs, rows = seg.process_batch([f, f], BatchConfig(True, 4, 0.0, (1, 2, 4)))
    assert rows == 2 and seg.n_traces == 0
    jplan = jax_parse(desc).compile_plan()
    assert jplan.segments[0].is_identity()


def test_process_eager_equals_process():
    seg = segment(parse_pipeline, device="cpu")
    rng = np.random.default_rng(11)
    for _ in range(3):
        x = rng.standard_normal(4).astype(np.float32)
        got = seg.process(Frame((x,))).tensors[0]
        eager = seg.process_eager(Frame((x,))).tensors[0]
        assert torch.equal(got, eager)
        np.testing.assert_array_equal(got.numpy(), (x + np.float32(1.0)) * np.float32(2.0))
    assert seg.n_traces == 1


def test_process_eager_equals_process_zoo_model():
    desc = ("tensorsrc dimensions=3:32:32:1 types=uint8 num-frames=1 ! "
            "tensor_transform mode=resize option=24:24 ! "
            "tensor_filter framework=torch model=zoo:mobilenet_v2 "
            'custom="num_classes:7,width:0.35,size:24" ! '
            "tensor_decoder mode=image_labeling ! tensor_sink")
    plan = parse_pipeline(desc, device="cpu").compile_plan()
    (seg,) = [s for s in plan.segments if s.fused]
    x = np.random.default_rng(2).integers(0, 256, (1, 32, 32, 3)).astype(np.uint8)
    assert torch.equal(seg.process(Frame((x,))).tensors[0],
                       seg.process_eager(Frame((x,))).tensors[0])


def test_build_fills_the_negotiated_entry_once():
    seg = segment(parse_pipeline, device="cpu")
    assert seg.build() is not None and seg.n_traces == 1
    seg.process(Frame((np.zeros(4, np.float32),)))
    assert seg.n_traces == 1  # the frame's signature is the negotiated one
    assert not seg.captured  # on the CPU every program is the composed fn
    # with batching on, build also fills the max-batch bucket
    seg2 = segment(parse_pipeline, device="cpu")
    seg2.batch_config = BatchConfig(True, 8, 1.0, (1, 2, 4, 8))
    seg2.build()
    assert seg2.n_traces == 2
    frames = [Frame((np.full(4, i, np.float32),)) for i in range(8)]
    outs, rows = seg2.process_batch(frames, seg2.batch_config)
    assert rows == 8 and seg2.n_traces == 2


def test_program_cache_counts_like_the_reference():
    """The same frames and windows through both packages' segments: equal
    outputs and equal n_traces after each step (the port's cache follows
    the jit cache's keys: signature, bucket, fn versions)."""
    seg, jseg = segment(parse_pipeline, device="cpu"), segment(jax_parse)
    cfg = BatchConfig(True, 8, 0.0, (1, 2, 4, 8))
    rng = np.random.default_rng(4)
    frames = [rng.standard_normal(4).astype(np.float32) for _ in range(8)]
    steps = [("frame", 0), ("batch", 3), ("batch", 5), ("batch", 4), ("frame", 1),
             ("batch", 8), ("batch", 1), ("wide", 0)]
    for kind, n in steps:
        if kind == "frame":
            got = [seg.process(Frame((frames[n],))).tensors[0].numpy()]
            want = [np.asarray(jseg.process(JFrame((frames[n],))).tensors[0])]
        elif kind == "wide":
            x = np.arange(8, dtype=np.float32)
            got = [seg.process(Frame((x,))).tensors[0].numpy()]
            want = [np.asarray(jseg.process(JFrame((x,))).tensors[0])]
        else:
            outs, b = seg.process_batch([Frame((f,)) for f in frames[:n]], cfg)
            jouts, jb = jseg.process_batch([JFrame((f,)) for f in frames[:n]], cfg)
            assert b == jb
            got = [o.tensors[0].numpy() for o in outs]
            want = [np.asarray(o.tensors[0]) for o in jouts]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert seg.n_traces == jseg.n_traces, (kind, n)


def test_launch_tally_keeps_capture_counts_apart():
    c = LaunchCounter()
    c.add()
    with launch_tally() as tally:
        c.add()
        c.add()
    assert c.count == 1 and tally == {c: 2}
    c.add(tally[c])  # what a replay adds
    assert c.count == 3
    c.reset()
    assert c.count == 0


def test_launch_counter_keeps_each_threads_adds():
    """Two servers in one process read their own launches: count_on sums
    the adds their threads made, a tally's replay included."""
    import threading

    c = LaunchCounter()

    def work(n, replayed):
        for _ in range(n):
            c.add()
        c.add(replayed)

    a = threading.Thread(target=work, args=(3, 8))
    b = threading.Thread(target=work, args=(2, 4))
    for t in (a, b):
        t.start()
        t.join()
    c.add()
    assert c.count == 18
    assert c.count_on([a]) == 11 and c.count_on([b]) == 6 and c.count_on([a, b]) == 17
    assert c.count_on([threading.current_thread()]) == 1
    c.reset()
    assert c.count == 0 and c.count_on([a, b]) == 0


def test_transform_constants_made_once():
    a = ttransform._const(1.5, torch.float32, torch.device("cpu"))
    assert ttransform._const(1.5, torch.float32, torch.device("cpu")) is a
    assert ttransform._const(-0.0, torch.float32, torch.device("cpu")) is not \
        ttransform._const(0.0, torch.float32, torch.device("cpu"))
    assert ttransform._const(300.7, torch.uint8, torch.device("cpu")).item() == \
        torch.tensor(300.7, dtype=torch.float64).to(torch.uint8).item()


def test_uncapturable_recorded_at_fill_and_stats_open_no_backend():
    """The ops that declare CAPTURABLE = False are read when a program is
    filled (the LM's generate module here) and reported from that record:
    Executor.stats() after stop() reopens no filter's backend."""
    desc = ("tensorsrc dimensions=8:1 types=int32 num-frames=2 ! "
            "tensor_filter name=f framework=torch model=zoo:transformer_lm "
            'custom="vocab:32,d_model:16,n_heads:2,n_layers:1,seqlen:8,generate:2" ! '
            "tensor_sink name=out")
    p = parse_pipeline(desc, device="cpu")
    ex = p.run(timeout=120)
    (seg,) = [s for s in ex.plan.segments if s.fused]
    assert seg.uncapturable == ("f",) and not seg.captured
    assert len(p["out"].frames) == 2
    assert p["f"].backend is None  # closed at stop
    (row,) = [r for r in ex.stats().values() if "n_traces" in r]
    assert row["uncapturable"] == ["f"] and row["captured"] is False
    assert p["f"].backend is None  # stats() read the record, opened nothing
    with pytest.raises(RuntimeError, match="no backend open"):
        p["f"].CAPTURABLE


def test_capturable_segment_records_no_op():
    seg = segment(parse_pipeline, device="cpu")
    seg.build()
    assert seg.uncapturable == ()
