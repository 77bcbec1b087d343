"""Port parity for the batch-axis program (ROADMAP A.1b).

A micro-batched window runs as ONE program over a leading axis of B frames,
``torch.func.vmap`` of the segment's composed ops (pipeline/programs.py), as
the reference's ``jax.jit(jax.vmap(composed))``. The hand-written kernels are
``torch.library`` custom ops whose vmap rules fold the vmapped axis into one
launch (K1, K2, K5); K3 and K4 refuse a vmap. Same numpy-seeded inputs
through both packages, on the CPU, where each kernel's op takes its plain
version and the reference's Pallas kernels run in interpret mode.

Tolerances:
- K1: ``interp_atol`` against the Pallas kernel (its matrix form rounds
  differently), bit for bit against the port's own single-frame calls;
- K2: keep indices and scores equal to the reference's;
- K5: atol 2e-5 against the reference's Pallas kernel (tests/test_torch_flash.py);
- pipelines: float outputs within 1e-4 of max |value| of the reference's
  batched run, labels and detection classes equal;
- the chain program's windows bit for bit its frames (no vmap).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nnstreamer_tpu.models import face_pipeline as jfp
from nnstreamer_tpu.models import mobilenet_v2 as jmobilenet
from nnstreamer_tpu.models import zoo as jzoo
from nnstreamer_tpu.ops.pallas import image_kernels as jik
from nnstreamer_tpu.ops.pallas.flash_attention import flash_attention as jflash
from nnstreamer_tpu.ops.pallas.nms import nms as jnms
from nnstreamer_tpu.pipeline.parse import parse_pipeline as jax_parse
from nnstreamer_tpu_torch.backends import custom as tcustom
from nnstreamer_tpu_torch.models import quantize
from nnstreamer_tpu_torch.models import ssd_mobilenet as tssd
from nnstreamer_tpu_torch.ops import detection as tdet
from nnstreamer_tpu_torch.ops.kernels import decode_attention as tk3
from nnstreamer_tpu_torch.ops.kernels import flash_attention as tk5
from nnstreamer_tpu_torch.ops.kernels import image_kernels as tk1
from nnstreamer_tpu_torch.ops.kernels import nms as tk2
from nnstreamer_tpu_torch.ops.kernels import paged_attention as tk4
from nnstreamer_tpu_torch.pipeline.batching import BatchConfig, default_buckets
from nnstreamer_tpu_torch.pipeline.device_faults import DeviceCompileError
from nnstreamer_tpu_torch.pipeline.parse import parse_pipeline
from nnstreamer_tpu_torch.pipeline.programs import batched
from nnstreamer_tpu_torch.tensors.frame import Frame

REL = 1e-4  # a batched window's float outputs, of max |value|


def _save(tree, path):
    leaves = jax.tree_util.tree_leaves(tree)
    np.savez(path, **{f"p{i}": np.asarray(v) for i, v in enumerate(leaves)})
    return str(path)


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    """The reference's seed-0 weights as params files: MobileNet-v2 (16
    classes, width 0.5), SSD (8 classes) and the face composite's tree."""
    d = tmp_path_factory.mktemp("batch_axis")
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    ssd = jzoo.get("ssd_mobilenet_v2", num_classes="8")
    priors = d / "box-priors.txt"
    tssd.write_box_priors(str(priors))
    return {
        "mobilenet": _save(jmobilenet.init_params(jax.random.PRNGKey(0), num_classes=16,
                                                  width=0.5), d / "mb.npz"),
        "ssd": _save(ssd.params, d / "ssd8.npz"),
        "composite": _save({"detect": jfp.init_detect_params(k1),
                            "landmark": jfp.init_landmark_params(k2)}, d / "comp.npz"),
        "priors": str(priors),
    }


def _boxes(rng, shape, h, w):
    x1 = rng.uniform(-4, w - 2, shape)
    y1 = rng.uniform(-4, h - 2, shape)
    x2 = x1 + rng.uniform(0.0, w / 2, shape)
    y2 = y1 + rng.uniform(0.0, h / 2, shape)
    return np.stack([x1, y1, x2, y2], -1).astype(np.float32)


def _counts():
    return (tk1.crop_entry_launches.count, tk1.resize_entry_launches.count,
            tk2.nms_launches.count, tk5.flash_attention_launches.count)


# -- the kernels' ops under vmap ----------------------------------------------

@pytest.mark.parametrize("case", ["batched-image", "shared-image", "shared-boxes", "resize"])
def test_k1_vmap_matches_jax_vmap(case):
    """K1's op under torch.func.vmap: a batch of images with their boxes,
    one image shared by every row's boxes, one set of boxes over a batch of
    images, and the resize entry over [B, N, H, W, C]; against jax.vmap of
    the reference's Pallas kernel, and bit for bit the port's row by row."""
    rng = np.random.default_rng(31)
    b, n, h, w, c, oh, ow = 3, 5, 20, 28, 3, 7, 9
    imgs = rng.integers(0, 256, (b, h, w, c)).astype(np.uint8)
    boxes = _boxes(rng, (b, n), h, w)
    if case == "resize":
        x = rng.integers(0, 256, (b, 2, h, w, c)).astype(np.uint8)
        got = torch.func.vmap(lambda i: tk1.resize_bilinear(i, oh, ow))(torch.from_numpy(x))
        rows = torch.stack([tk1.resize_bilinear(torch.from_numpy(r), oh, ow) for r in x])
        want = jax.vmap(lambda i: jik.resize_bilinear(i, oh, ow, interpret=True))(jnp.asarray(x))
    else:
        dims = {"batched-image": (0, 0), "shared-image": (None, 0),
                "shared-boxes": (0, None)}[case]
        args = (imgs if dims[0] == 0 else imgs[0], boxes if dims[1] == 0 else boxes[0])

        def one(i, bx):
            return tk1.crop_and_resize(i, bx, oh, ow, scale=1 / 255, offset=-0.5)

        got = torch.func.vmap(one, in_dims=dims)(*(torch.from_numpy(a) for a in args))
        rows = torch.stack([one(*(torch.from_numpy(a[j] if d == 0 else a)
                                  for a, d in zip(args, dims))) for j in range(b)])
        want = jax.vmap(lambda i, bx: jik.crop_and_resize(
            i, bx, oh, ow, scale=1 / 255, offset=-0.5, interpret=True), in_axes=dims)(
            *(jnp.asarray(a) for a in args))
    assert torch.equal(got, rows)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.to(torch.float32).numpy(), want.astype(np.float32), rtol=0,
                               atol=tk1.interp_atol(got.dtype, h, w))


def test_k2_vmap_matches_jax_vmap():
    """The whole NMS (rank, K2's op, pack) vmapped over rows against
    jax.vmap of the reference's Pallas NMS: keep indices and scores equal;
    every row also equals the port's own unbatched call."""
    rng = np.random.default_rng(32)
    b, n = 4, 150
    xy = rng.uniform(0, 60, (b, n, 2))
    wh = rng.uniform(2, 30, (b, n, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = rng.uniform(-0.3, 1.0, (b, n)).astype(np.float32)
    got = torch.func.vmap(lambda bx, s: tdet.nms(bx, s, 0.5, 20))(
        torch.from_numpy(boxes), torch.from_numpy(scores))
    want = jax.vmap(lambda bx, s: jnms(bx, s, 0.5, 20, interpret=True))(
        jnp.asarray(boxes), jnp.asarray(scores))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for j in range(b):
        idx, sc = tdet.nms(torch.from_numpy(boxes[j]), torch.from_numpy(scores[j]), 0.5, 20)
        assert torch.equal(idx, got[0][j]) and torch.equal(sc, got[1][j])


def test_k5_vmap_rule_matches_jax_vmap():
    """K5's vmap rule folds the vmapped axis into B: [V, B, T, H, D]
    against jax.vmap of the reference's flash attention."""
    rng = np.random.default_rng(33)
    q, k, v = (rng.standard_normal((2, 2, 24, 4, 16)).astype(np.float32) for _ in range(3))
    got = torch.func.vmap(lambda a, b_, c: tk5.flash_attention(a, b_, c, causal=True))(
        *(torch.from_numpy(x) for x in (q, k, v)))
    want = jax.vmap(lambda a, b_, c: jflash(
        a, b_, c, causal=True, block_q=16, block_k=16, interpret=True))(
        *(jnp.asarray(x) for x in (q, k, v)))
    assert got.shape == (2, 2, 24, 4, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)
    rows = torch.stack([tk5.flash_attention(*(torch.from_numpy(x[j]) for x in (q, k, v)))
                        for j in range(2)])
    assert torch.equal(got, rows)


def test_int8_gemm_batch_folds_into_m():
    """``torch._int_mm`` has no batching rule: the op writes its batch out,
    one GEMM of B·M rows under vmap, exact."""
    rng = np.random.default_rng(34)
    q = torch.from_numpy(rng.integers(-127, 128, (3, 5, 16)).astype(np.int8))
    w8 = torch.from_numpy(rng.integers(-127, 128, (8, 16)).astype(np.int8)).t()
    got = torch.func.vmap(lambda a: quantize.int8_matmul(a, w8))(q)
    assert got.dtype == torch.int32
    assert torch.equal(got, torch.stack([quantize.int8_matmul(r, w8) for r in q]))
    assert torch.equal(got, q.to(torch.int32) @ w8.to(torch.int32))


def _k3_args():
    rng = np.random.default_rng(35)
    q = torch.from_numpy(rng.standard_normal((2, 1, 4, 16)).astype(np.float32))
    cache = torch.from_numpy(rng.standard_normal((2, 8, 2, 16)).astype(np.float32))
    return q, cache, cache.clone(), torch.tensor([3, 7], dtype=torch.int32)


def _k4_args():
    rng = np.random.default_rng(36)
    q = torch.from_numpy(rng.standard_normal((2, 1, 4, 16)).astype(np.float32))
    arena = torch.from_numpy(rng.standard_normal((5, 4, 2, 16)).astype(np.float32))
    tables = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    fresh = torch.from_numpy(rng.standard_normal((2, 1, 2, 16)).astype(np.float32))
    return q, arena, arena.clone(), tables, torch.tensor([5, 2], dtype=torch.int32), fresh, fresh


@pytest.mark.parametrize("which", ["K3", "K4"])
def test_k3_and_k4_refuse_a_vmap(which):
    """K3 and K4 have no vmap rule: their batch is the slots of a serving
    step; a vmap that reaches them raises (never a loop over the rows), and
    their plain versions still run unbatched."""
    fn, args = ((tk3.decode_attention, _k3_args()) if which == "K3"
                else (tk4.paged_decode_attention, _k4_args()))
    assert fn(*args).shape == (2, 1, 4, 16)
    stacked = tuple(torch.stack([a, a]) for a in args)
    with pytest.raises(NotImplementedError, match="no vmap rule"):
        torch.func.vmap(fn)(*stacked)
    with pytest.raises(DeviceCompileError, match="vmap rule"):
        batched(lambda ts: (fn(*ts),))(stacked)


def test_fakes_give_shapes_and_dtypes():
    """Each kernel op's fake answers a fake-tensor trace with the shapes
    and dtypes the op itself gives, without running the plain version."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    rng = np.random.default_rng(37)
    img = torch.from_numpy(rng.integers(0, 256, (3, 12, 16, 3)).astype(np.uint8))
    boxes = torch.from_numpy(_boxes(rng, (3, 4), 12, 16))
    sboxes = torch.from_numpy(_boxes(rng, (3, 40), 50, 50))
    scores = torch.from_numpy(rng.uniform(0, 1, (3, 40)).astype(np.float32))
    qkv = [torch.from_numpy(rng.standard_normal((1, 8, 2, 8)).astype(np.float32))
           for _ in range(3)]
    q8 = torch.from_numpy(rng.integers(-127, 128, (20, 16)).astype(np.int8))
    w8 = torch.from_numpy(rng.integers(-127, 128, (8, 16)).astype(np.int8)).t()
    calls = [
        lambda: torch.func.vmap(lambda i, b: tk1.crop_and_resize(i, b, 5, 6))(img, boxes),
        lambda: torch.func.vmap(lambda i: tk1.resize_bilinear(i, 5, 6, scale=0.5))(img),
        lambda: torch.func.vmap(lambda b, s: tk2.nms_mask(b, s, 0.5))(sboxes, scores),
        lambda: tk5.flash_attention(*qkv),
        lambda: tk3.decode_attention(*_k3_args()),
        lambda: tk4.paged_decode_attention(*_k4_args()),
        lambda: quantize.int8_matmul(q8, w8),
    ]
    real = [fn() for fn in calls]
    before = _counts()
    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = [fn() for fn in calls]
    assert _counts() == before
    for r, f in zip(real, fake):
        assert (tuple(f.shape), f.dtype) == (tuple(r.shape), r.dtype)


# -- the batched program -------------------------------------------------------

def test_one_batched_program_per_signature_bucket_and_versions():
    """A fused segment's bucket program is the batched program: one per
    (signature, bucket, fn versions), as n_traces counts; a ticked fn
    version builds anew; its rows equal the per-frame program's."""
    plan = parse_pipeline(
        "tensorsrc dimensions=4 num-frames=1 ! tensor_transform mode=arithmetic "
        "option=add:1.0 ! tensor_filter framework=scaler custom=factor:2.0 input=4 ! "
        "tensor_sink", device="cpu").compile_plan()
    seg = next(s for s in plan.segments if len(s.ops) >= 2)
    cfg = BatchConfig(True, 8, 0.0, default_buckets(8))
    rng = np.random.default_rng(38)
    xs = [rng.standard_normal(4).astype(np.float32) for _ in range(8)]
    for n in (2, 3, 5, 8, 7, 4):
        outs, bucket = seg.process_batch([Frame((x,)) for x in xs[:n]], cfg)
        assert bucket == cfg.bucket_for(n)
        for o, x in zip(outs, xs):
            assert torch.equal(o.tensors[0], seg.process(Frame((x,))).tensors[0])
    assert not seg.programs.unrolled
    assert seg.n_traces == 3 + 1  # buckets 2, 4, 8 and the per-frame program
    seg.ops[-1].fn_version += 1
    seg.process_batch([Frame((x,)) for x in xs[:3]], cfg)
    assert seg.n_traces == 5


_FAMILIES = {
    "labeling": "videotestsrc num-frames=1 width=40 height=30 ! tensor_converter ! "
                "tensor_transform mode=resize option=32:32 ! tensor_filter framework=torch "
                "model=zoo:mobilenet_v2 custom=size:32,width:0.5,num_classes:16 ! "
                "tensor_decoder mode=image_labeling ! tensor_sink",
    "int8": "videotestsrc num-frames=1 width=40 height=30 ! tensor_converter ! "
            "tensor_transform mode=resize option=32:32 ! tensor_filter framework=torch "
            "model=zoo:mobilenet_v2 custom=size:32,width:0.5,num_classes:16,quantize:int8 ! "
            "tensor_sink",
    "ssd": "videotestsrc num-frames=1 width=320 height=240 ! tensor_converter ! "
           "tensor_transform mode=resize option=300:300 ! tensor_filter framework=torch "
           "model=zoo:ssd_mobilenet_v2 custom=num_classes:8 ! tensor_decoder "
           "mode=bounding_boxes option1=mobilenet-ssd option3={priors} postproc=device ! "
           "tensor_sink",
    "yolo": 'videotestsrc num-frames=1 width=80 height=60 ! tensor_converter ! '
            'tensor_transform mode=resize option=64:64 ! tensor_filter framework=torch '
            'model=zoo:yolov5 custom="size:64,width:16,num_classes:4" ! tensor_decoder '
            'mode=bounding_boxes option1=yolov5 option3=0.0 postproc=device ! tensor_sink',
    "pose": "videotestsrc num-frames=1 width=257 height=257 ! tensor_converter ! "
            "tensor_filter framework=torch model=zoo:posenet output-combination=o0,o1 ! "
            "tensor_decoder mode=pose_estimation option1=32:32 option2=257:257 "
            "option4=heatmap-offset postproc=device ! tensor_sink",
    "segment": "videotestsrc num-frames=1 width=257 height=257 ! tensor_converter ! "
               "tensor_filter framework=torch model=zoo:deeplab_v3 ! tensor_decoder "
               "mode=image_segment option1=tflite-deeplab postproc=device ! tensor_sink",
    "composite": 'videotestsrc num-frames=1 width=128 height=128 ! tensor_converter ! '
                 'tensor_filter framework=torch model=zoo:face_composite '
                 'custom="threshold:0.0" ! tensor_sink',
    "vit": 'videotestsrc num-frames=1 width=80 height=64 ! tensor_converter ! '
           'tensor_transform mode=resize option=64:64 ! tensor_filter framework=torch '
           'model=zoo:vit custom="size:64,patch:16,d_model:64,n_heads:4,n_layers:2,'
           'num_classes:10" ! tensor_decoder mode=image_labeling ! tensor_sink',
    "lm-flash": 'tensorsrc dimensions=20:1 types=int32 num-frames=1 pattern=counter ! '
                'tensor_filter framework=torch model=zoo:transformer_lm custom="vocab:64,'
                'd_model:32,n_heads:4,n_kv_heads:2,n_layers:2,seqlen:20,attn:flash" ! '
                'tensor_sink',
}


@pytest.mark.parametrize("family", sorted(_FAMILIES))
def test_vmap_fallback_fires_for_no_zoo_segment_family(family, npz):
    """Every fused segment of the zoo's families batches through vmap with
    the fallback warning an error (no op loops over the rows), and each
    batched row is the frame's own to REL (integer outputs equal)."""
    plan = parse_pipeline(_FAMILIES[family].format(priors=npz["priors"]),
                          device="cpu").compile_plan()
    segs = [s for s in plan.segments if s.fused and not s.is_identity()]
    assert segs
    g = torch.Generator().manual_seed(39)
    for seg in segs:
        sig = seg._negotiated_sig()
        fn = seg._compose()
        rows = [tuple((torch.rand(shape, generator=g) * (255 if dt == torch.uint8 else 1)).to(dt)
                      if dt.is_floating_point or dt == torch.uint8
                      else torch.randint(0, 60, shape, generator=g).to(dt)
                      for shape, dt in sig) for _ in range(2)]
        with torch.inference_mode():
            outs = batched(fn)(tuple(torch.stack(c) for c in zip(*rows)))
            for j, row in enumerate(rows):
                for o, w in zip(outs, fn(row)):
                    if w.dtype.is_floating_point:
                        tol = REL * max(1.0, float(w.abs().max()))
                        assert float((o[j] - w).abs().max()) <= tol
                    else:
                        assert torch.equal(o[j], w)


def test_an_op_with_no_batching_rule_fails_the_build():
    """The vmap fallback is an error around a batched build: an op with no
    batching rule, or a read of values, raises DeviceCompileError, never a
    loop over the rows; outside a build the warning stays off."""
    cols = (torch.rand(3, 5),)
    with pytest.raises(DeviceCompileError, match="batching rule"):
        batched(lambda ts: (torch.histc(ts[0]),))(cols)
    with pytest.raises(DeviceCompileError, match="item"):
        batched(lambda ts: (ts[0] * ts[0].sum().item(),))(cols)
    assert torch.equal(batched(lambda ts: (ts[0] * 2,))(cols)[0], cols[0] * 2)
    assert torch.func.vmap(torch.histc)(cols[0]).shape == (3, 100)


def test_a_failed_batched_build_goes_to_the_device_circuit():
    """A segment vmap cannot batch (a traceable fn that reads a value)
    under batching: the failed build opens the device circuit, which
    serves every frame eagerly and counts it; outputs stay right."""
    tcustom.register_custom_easy(
        "readsum", lambda ts: (ts[0] * float(ts[0].sum().item() > -1.0),), traceable=True)
    try:
        desc = ("appsrc name=src dimensions=4 types=float32 ! tensor_filter name=f "
                "framework=custom-easy model=readsum batching=true max-batch=4 "
                "batch-timeout-ms=50 ! tensor_sink name=out")
        p = parse_pipeline(desc, device="cpu")
        ex = p.start()
        xs = [np.full((4,), i, np.float32) for i in range(6)]
        for x in xs:
            p["src"].push(Frame((x,)))
        p["src"].end_of_stream()
        assert ex.wait(60)
        p.stop()
        assert not ex.errors
        got = [np.asarray(f.tensors[0]) for f in p["out"].frames]
        assert len(got) == 6 and all(np.array_equal(g, x) for g, x in zip(got, xs))
        row = ex.stats()["f"]
        assert row["device_circuit_opens"] >= 1 and row["device_eager_invokes"] >= 1
    finally:
        tcustom.unregister_custom_easy("readsum")


def test_chain_program_windows_stay_bit_for_bit_its_frames():
    """The chain program keeps its per-row program (the reference's
    _unrolled): a window of a conv-bearing chain is bit for bit its frames
    one at a time."""
    from nnstreamer_tpu_torch.pipeline.chain_program import ChainProgram

    plan = parse_pipeline(
        "videotestsrc num-frames=1 width=40 height=30 ! tensor_converter ! "
        "tensor_transform mode=resize option=32:32 ! queue ! tensor_filter framework=torch "
        "model=zoo:mobilenet_v2 custom=size:32,width:0.5,num_classes:16 ! tensor_sink",
        device="cpu").compile_plan()
    (chain,) = [c for c in plan.chains() if len(c.segments) > 1]
    prog = ChainProgram(chain, 4)
    assert prog.programs.unrolled
    rng = np.random.default_rng(40)
    frames = [Frame((rng.integers(0, 256, (30, 40, 3)).astype(np.uint8),)) for _ in range(3)]
    outs, rows, launched = prog.process_window(frames)
    assert launched and rows == 4
    for f, o in zip(frames, outs):
        assert torch.equal(o.tensors[0], prog.process_frame_fallback(f).tensors[0])


# -- pipelines against the reference's batched runs ----------------------------

BATCH = "batching=true max-batch=4 batch-timeout-ms=5000"


def _outs(p, i=0):
    return [np.asarray(f.tensors[i]) for f in p["out"].frames]


def _both(desc, jdesc=None):
    """The description through both packages (the port on the CPU): 4
    frames, one window of 4 in each."""
    p = parse_pipeline(desc.format(fw="torch"), device="cpu")
    p.run(timeout=300)
    jp = jax_parse((jdesc or desc).format(fw="jax"))
    jp.run(timeout=600)
    return p, jp


def _close(got, want):
    assert len(got) == len(want) == 4
    tol = REL * max(float(np.abs(w).max()) for w in want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=tol)


def test_labeling_window_matches_reference_batched(npz):
    desc = ("videotestsrc num-frames=4 width=40 height=30 ! tensor_converter ! "
            "tensor_transform mode=resize option=32:32 ! tensor_filter name=f "
            "framework={fw} model=zoo:mobilenet_v2 "
            f'custom="size:32,width:0.5,num_classes:16,params:{npz["mobilenet"]}" {BATCH} ! '
            "tensor_sink name=out")
    p, jp = _both(desc)
    got, want = _outs(p), _outs(jp)
    _close(got, want)
    assert [int(g.argmax()) for g in got] == [int(w.argmax()) for w in want]
    assert p["f"].batch_stats.batches == 1 and p["f"].batch_stats.frames == 4


def test_ssd_device_decode_window_matches_reference_batched(npz):
    desc = ("videotestsrc num-frames=4 width=320 height=240 ! tensor_converter ! "
            "tensor_transform mode=resize option=300:300 ! tensor_filter name=f "
            f'framework={{fw}} model=zoo:ssd_mobilenet_v2 custom="num_classes:8,'
            f'params:{npz["ssd"]}" {BATCH} ! tensor_decoder mode=bounding_boxes '
            f"option1=mobilenet-ssd option3={npz['priors']} postproc=device ! "
            "tensor_sink name=out")
    p, jp = _both(desc)
    got, want = _outs(p), _outs(jp)
    for g, w in zip(got, want):
        assert g.shape == (100, 6)
        kept = w[:, 5] > 0
        assert np.array_equal(g[:, 5] > 0, kept) and np.array_equal(g[:, 4], w[:, 4])
    _close(got, want)


def test_face_composite_window_matches_reference_batched(npz):
    desc = ("videotestsrc num-frames=4 width=128 height=128 ! tensor_converter ! "
            "tensor_filter name=f framework={fw} model=zoo:face_composite "
            f'custom="threshold:0.0,params:{npz["composite"]}" {BATCH} ! '
            "tensor_sink name=out")
    # the reference's composite takes its own seed-0 tree (ROADMAP C)
    jdesc = desc.replace(f',params:{npz["composite"]}', "")
    p, jp = _both(desc, jdesc)
    for i in (0, 1):
        _close(_outs(p, i), _outs(jp, i))


def test_two_streams_through_one_plane_match_the_reference_plane(npz):
    """Two streams on one plane (max-batch 4): each dispatch one batched
    program; logits within REL of the JAX plane's, labels equal."""
    from nnstreamer_tpu_torch.serving_plane import plane as plane_mod

    def desc(plane, fw):
        return " ".join(
            f"videotestsrc pattern={pat} num-frames=4 width=40 height=30 ! tensor_converter ! "
            "tensor_transform mode=resize option=32:32 ! "
            f"tensor_filter framework={fw} model=zoo:mobilenet_v2 plane={plane} "
            f'plane-max-batch=4 custom="size:32,width:0.5,num_classes:16,'
            f'params:{npz["mobilenet"]}" ! tensor_sink name={pat}'
            for pat in ("gradient", "counter"))

    p = parse_pipeline(desc("ba", "torch"), device="cpu")
    p.negotiate()
    prog = plane_mod.get("ba")._ensure_program()
    p.run(timeout=300)
    jp = jax_parse(desc("jba", "jax"))
    jp.run(timeout=600)
    for pat in ("gradient", "counter"):
        got = [np.asarray(f.tensors[0]) for f in p[pat].frames]
        want = [np.asarray(f.tensors[0]) for f in jp[pat].frames]
        _close(got, want)
        assert [int(g.argmax()) for g in got] == [int(w.argmax()) for w in want]
    assert not prog.programs.unrolled and prog.programs.n_traces <= 1 + len(prog.buckets)


def _logits(parse, desc, device=None):
    p = parse(desc, device=device) if device else parse(desc)
    p.run(timeout=600)
    return np.stack([np.asarray(f.tensors[0], np.float32) for f in p["out"].frames])


@pytest.mark.parametrize("cell", ["labeling-720p", "mobilenet-96"])
def test_batched_against_unbatched_in_both_packages(cell, npz, capsys):
    """The difference a batched window makes, in each package on the same
    frames: the port's batched program (convs at N = B) against its
    batching=false run within REL of max |logit| with top-1 equal; the
    JAX package's own vmapped program against its unbatched run is
    printed beside it (the reference for the port's checks that moved
    from bit for bit to REL). labeling-720p: the 720p gradient frames
    through resize 224 and MobileNet-v2 1.0 / 1001 classes (each package
    its own seed-0 weights); mobilenet-96: the plane test's 96² frames and
    the reference's weights in both."""
    if cell == "labeling-720p":
        desc = ("videotestsrc pattern=gradient width=1280 height=720 num-frames=4 ! "
                "tensor_converter ! tensor_transform mode=resize option=224:224 ! "
                "tensor_filter framework={fw} model=zoo:mobilenet_v2 {props} ! "
                "tensor_sink name=out")
    else:
        desc = ("videotestsrc pattern=gradient width=96 height=96 num-frames=4 ! "
                "tensor_converter ! tensor_filter framework={fw} model=zoo:mobilenet_v2 "
                f'custom="size:96,num_classes:16,width:0.5,params:{npz["mobilenet"]}" {{props}} '
                "! tensor_sink name=out")
    window = "batching=true max-batch=4 batch-timeout-ms=5000"
    diffs = {}
    for pkg, parse, dev in (("port", parse_pipeline, "cpu"), ("jax", jax_parse, None)):
        plain = _logits(parse, desc.format(fw="torch" if dev else "jax", props=""), dev)
        win = _logits(parse, desc.format(fw="torch" if dev else "jax", props=window), dev)
        assert plain.shape == win.shape and plain.shape[0] == 4
        diffs[pkg] = (float(np.abs(win - plain).max()), float(np.abs(plain).max()))
        if pkg == "port":
            assert diffs[pkg][0] <= REL * diffs[pkg][1]
            assert np.array_equal(win.argmax(-1), plain.argmax(-1))
    with capsys.disabled():
        print(f"\n{cell}: batched - unbatched max |diff| (max |logit|): "
              + ", ".join(f"{k} {d:.3g} ({m:.4g})" for k, (d, m) in diffs.items()))
