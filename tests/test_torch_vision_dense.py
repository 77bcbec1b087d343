"""Port parity for the dense-prediction families: PoseNet and DeepLab-v3
against the JAX package on its own weights, the heatmap ops, the
pose_estimation and image_segment decoders (host and device decode), the
filter's input-/output-combination, and the ``decoder_pose`` and
``decoder_segment`` goldens through ``nnstreamer_tpu_torch.cli --device
cpu``.

Tolerances:

- float32 models: within 5e-5 of max(1, max |ref|) (another summation
  order through 14-17 conv layers and, for DeepLab, the upsample).
- bfloat16 models: no farther from the reference's bfloat16 output than
  that is from the reference's float32 output.
- heatmap ops and decoders: argmax indices, labels and RGBA canvases
  identical; keypoint coordinates within 1e-5 (float32 arithmetic on the
  same values, divisions in another order).
- the two goldens byte for byte (both are rendered RGBA).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nnstreamer_tpu.elements.decoder import TensorDecoder as JDecoder
from nnstreamer_tpu.models import deeplab_v3 as jdl
from nnstreamer_tpu.models import posenet as jpn
from nnstreamer_tpu.ops import heatmap as jhm
from nnstreamer_tpu.pipeline.parse import parse_pipeline as jax_parse
from nnstreamer_tpu.tensors.frame import Frame as JFrame
from nnstreamer_tpu.tensors.spec import TensorsSpec as JSpec
from nnstreamer_tpu_torch import cli
from nnstreamer_tpu_torch.elements.base import NegotiationError
from nnstreamer_tpu_torch.elements.decoder import TensorDecoder as TDecoder
from nnstreamer_tpu_torch.models import deeplab_v3 as tdl
from nnstreamer_tpu_torch.models import jax_weights
from nnstreamer_tpu_torch.models import posenet as tpn
from nnstreamer_tpu_torch.models import zoo as tzoo
from nnstreamer_tpu_torch.ops import heatmap as thm
from nnstreamer_tpu_torch.pipeline.parse import parse_pipeline
from nnstreamer_tpu_torch.tensors.frame import Frame as TFrame
from nnstreamer_tpu_torch.tensors.spec import TensorsSpec as TSpec

from test_golden import GOLDEN_DIR, PIPELINES

DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def save_npz(tree, path):
    leaves = jax.tree_util.tree_leaves(tree)
    np.savez(path, **{f"p{i}": np.asarray(v) for i, v in enumerate(leaves)})
    return str(path)


def image(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The reference zoo's seed-0 trees (its own eager init, as the goldens
    were made) and their npz files."""
    d = tmp_path_factory.mktemp("weights")
    k = jax.random.PRNGKey(0)
    out = {"posenet": jpn.init_params(k), "deeplab_v3": jdl.init_params(k)}
    return {name: (tree, save_npz(tree, d / f"{name}.npz")) for name, tree in out.items()}


REF = {"posenet": jpn.apply, "deeplab_v3": jdl.apply}


def run_model(trees, name, dtype, x):
    tree, npz = trees[name]
    fn = jax.jit(lambda p, x: REF[name](p, x, compute_dtype=DTYPES[dtype]))
    want = fn(tree, jnp.asarray(x))
    want = [np.asarray(w) for w in (want if isinstance(want, tuple) else (want,))]
    m = tzoo.get(name, device="cpu", params=npz, compute_dtype=dtype)
    with torch.inference_mode():
        got = m.module(torch.from_numpy(x))
    return want, [g.numpy() for g in (got if isinstance(got, tuple) else (got,))]


@pytest.mark.parametrize("name", ["posenet", "deeplab_v3"])
def test_model_float32_matches_jax(trees, name):
    x = image((1, 257, 257, 3), 1)
    want, got = run_model(trees, name, "float32", x)
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and _err(g, w) <= 5e-5 * max(1.0, float(np.abs(w).max()))


@pytest.mark.parametrize("name", ["posenet", "deeplab_v3"])
def test_model_bfloat16_within_reference_drift(trees, name):
    x = image((1, 257, 257, 3), 2)
    want16, got16 = run_model(trees, name, "bfloat16", x)
    want32, _ = run_model(trees, name, "float32", x)
    for g, w16, w32 in zip(got16, want16, want32):
        assert g.shape == w16.shape and g.dtype == np.float32
        assert _err(g, w16) <= _err(w16, w32)


@pytest.mark.parametrize("name,paths", [
    ("posenet", tpn.jax_leaf_paths), ("deeplab_v3", tdl.jax_leaf_paths),
])
def test_leaf_table_takes_every_leaf_once(trees, name, paths):
    tree, _ = trees[name]
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert paths() == [tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p)
                       for p, _ in flat]
    state = tzoo.get(name, device="cpu").module.state_dict()
    keys = [jax_weights.state_key(p) for p in paths()]
    assert sorted(keys) == sorted(state) and len(set(keys)) == len(keys)
    for k, (_, leaf) in zip(keys, flat):
        assert tuple(jax_weights.convert_leaf(np.asarray(leaf)).shape) == tuple(state[k].shape)


# -- heatmap ops ----------------------------------------------------------------

def _heat(seed, h=9, w=9, k=17, ties=False):
    rng = np.random.default_rng(seed)
    heat = rng.standard_normal((h, w, k)).astype(np.float32)
    if ties:  # equal maxima: the first (row-major) wins on both sides
        heat[:, :, :3] = 0.0
        heat[2, 4, 0] = heat[5, 1, 0] = 3.0
    return heat, rng.standard_normal((h, w, 2 * k)).astype(np.float32) * 4


@pytest.mark.parametrize("ties", [False, True])
def test_heatmap_ops_match_jax(ties):
    heat, offs = _heat(3, ties=ties)
    np.testing.assert_allclose(thm.pose_keypoints_from_heatmap(torch.from_numpy(heat)).numpy(),
                               np.asarray(jhm.pose_keypoints_from_heatmap(heat)), atol=1e-6)
    np.testing.assert_allclose(
        thm.pose_keypoints_with_offsets(torch.from_numpy(heat), torch.from_numpy(offs)).numpy(),
        np.asarray(jhm.pose_keypoints_with_offsets(heat, offs)), atol=1e-6)
    seg = np.random.default_rng(4).standard_normal((33, 17, 21)).astype(np.float32)
    seg[0, 0, [2, 5]] = 9.0  # a tie
    np.testing.assert_array_equal(thm.segment_argmax(torch.from_numpy(seg)).numpy(),
                                  np.asarray(jhm.segment_argmax(seg)))
    labels = np.random.default_rng(5).integers(0, 21, (12, 7)).astype(np.float32)
    np.testing.assert_array_equal(thm.segment_argmax(torch.from_numpy(labels)).numpy(),
                                  np.asarray(jhm.segment_argmax(labels)))
    depth = np.random.default_rng(6).uniform(0.5, 9.0, (12, 7)).astype(np.float32)
    np.testing.assert_array_equal(thm.depth_normalize(torch.from_numpy(depth)).numpy(),
                                  np.asarray(jhm.depth_normalize(depth)))


# -- the decoders, host and device ----------------------------------------------

def _decode_both(mode, props, arrays, dims, types):
    """(device outputs, host frames) of the JAX and the port decoder."""
    dev_out, host_out = [], []
    for dec_cls, spec_cls, frame_cls, conv in (
        (JDecoder, JSpec, JFrame, jnp.asarray), (TDecoder, TSpec, TFrame, torch.from_numpy),
    ):
        dev = dec_cls(mode=mode, postproc="device", **props)
        (out_spec,) = dev.fix_negotiation([spec_cls.from_strings(dims, types)])
        assert dev.is_traceable()
        outs = dev.make_fn()(tuple(conv(a) for a in arrays))
        assert tuple(outs[0].shape) == out_spec[0].shape
        dev_out.append(np.asarray(outs[0]))
        host = dec_cls(mode=mode, **props)
        host.fix_negotiation([spec_cls.from_strings(dims, types)])
        host_out.append(host.host_process(frame_cls(tuple(conv(a) for a in arrays))))
    return dev_out, host_out


@pytest.mark.parametrize("mode,labels", [
    ("heatmap-offset", True), ("heatmap-offset", False), ("heatmap-only", True),
])
def test_pose_decoder_matches_jax(tmp_path, mode, labels):
    heat, offs = _heat(7)
    heat[4, 4, :] = 4.0  # every keypoint above the drawing threshold somewhere
    props = dict(option1="96:72", option2="257:257", option4=mode)
    if labels:
        path = tmp_path / "pose.txt"
        path.write_text("\n".join(f"kp{i} {(i + 1) % 17} {(i + 5) % 17}" for i in range(17)))
        props["option3"] = str(path)
    arrays = [heat[None]] + ([offs[None]] if mode == "heatmap-offset" else [])
    dims = "17:9:9:1" + (",34:9:9:1" if mode == "heatmap-offset" else "")
    types = ",".join(["float32"] * len(arrays))
    (jd, td), (jh, th) = _decode_both("pose_estimation", props, arrays, dims, types)
    assert td.shape == (17, 3) and _err(td, jd) <= 1e-5
    assert _err(th.meta["keypoints"], np.asarray(jh.meta["keypoints"])) <= 1e-5
    canvas = th.tensors[0]
    assert canvas.shape == (72, 96, 4) and canvas.any()
    assert canvas.tobytes() == np.asarray(jh.tensors[0]).tobytes()


@pytest.mark.parametrize("mode", ["tflite-deeplab", "snpe-deeplab", "snpe-depth"])
def test_image_segment_decoder_matches_jax(mode):
    rng = np.random.default_rng(8)
    if mode == "tflite-deeplab":
        arr, dims = rng.standard_normal((1, 33, 17, 21)).astype(np.float32), "21:17:33:1"
    elif mode == "snpe-deeplab":
        arr, dims = rng.integers(0, 21, (33, 17)).astype(np.float32), "17:33"
    else:
        arr, dims = rng.uniform(0, 5, (33, 17)).astype(np.float32), "17:33"
    (jd, td), (jh, th) = _decode_both("image_segment", dict(option1=mode), [arr], dims, "float32")
    assert td.dtype == np.uint8 and td.shape == (33, 17)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(th.meta["label_map"], np.asarray(jh.meta["label_map"]))
    assert th.tensors[0].tobytes() == np.asarray(jh.tensors[0]).tobytes()


def test_decoders_refuse_bad_input():
    spec = TSpec.from_strings("17:9:9:1", "float32")
    with pytest.raises(NegotiationError):
        TDecoder(mode="pose_estimation", option4="heatmap-offset").fix_negotiation([spec])
    with pytest.raises(NegotiationError):
        TDecoder(mode="pose_estimation", option4="skeleton").fix_negotiation([spec])
    with pytest.raises(NegotiationError):
        TDecoder(mode="image_segment", option1="snpe-deeplab").fix_negotiation([spec])


# -- the filter's pad combinations ------------------------------------------------

COMBINATION = (
    "tensorsrc dimensions=4 types=float32 pattern=counter num-frames=3 ! mux.sink_0 "
    "tensorsrc dimensions=3 types=float32 pattern=counter num-frames=3 ! mux.sink_1 "
    "tensor_mux name=mux sync-mode=nosync ! "
    'tensor_filter framework={fw} model=zoo:add custom="const:1.5,dims:3" {props} ! '
    "tensor_sink name=out"
)


@pytest.mark.parametrize("props", [
    "input-combination=i1",
    "input-combination=1 output-combination=i0,o0",
    "input-combination=i1 output-combination=o0,i1,i0",
    "input-combination=1 output-combination=0",
])
def test_combinations_match_jax_filter(props):
    got = parse_pipeline(COMBINATION.format(fw="torch", props=props), device="cpu")
    got.run(timeout=60)
    want = jax_parse(COMBINATION.format(fw="jax", props=props))
    want.run(timeout=60)
    g, w = got["out"].frames, want["out"].frames
    assert len(g) == len(w) == 3
    for a, b in zip(g, w):
        assert a.num_tensors == b.num_tensors
        for x, y in zip(a.tensors, b.tensors):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("props", ["input-combination=o0", "input-combination=i5",
                                   "output-combination=o3"])
def test_combinations_out_of_range_fail(props):
    desc = COMBINATION.format(fw="torch", props=props)
    assert cli.main(["--device", "cpu", "-q", desc]) != 0


def test_output_combination_fuses_with_the_decoder(trees):
    """posenet → output-combination=o0,o1 → pose decoder postproc=device is
    one fused segment whose keypoints equal the JAX pipeline's."""
    _, npz = trees["posenet"]
    desc = (
        "videotestsrc pattern=gradient num-frames=1 width=257 height=257 ! tensor_converter ! "
        'tensor_filter framework=torch model=zoo:posenet custom="params:{npz}" '
        "output-combination=o0,o1 ! tensor_decoder mode=pose_estimation option1=32:32 "
        "option2=257:257 option4=heatmap-offset postproc=device ! tensor_sink name=out"
    )
    desc = desc.format(npz=npz)
    p = parse_pipeline(desc, device="cpu")
    plan = p.compile_plan()
    assert [s.fused for s in plan.segments] == [True]
    p.run(timeout=60)
    (frame,) = p["out"].frames
    ref = jax_parse(desc.replace("framework=torch", "framework=jax").replace(
        f'custom="params:{npz}" ', ""))
    ref.run(timeout=120)
    assert _err(frame.tensors[0], ref["out"].frames[0].tensors[0]) <= 1e-4


# -- the goldens through the port's CLI -----------------------------------------

@pytest.mark.parametrize("name,model", [("decoder_pose", "posenet"),
                                        ("decoder_segment", "deeplab_v3")])
def test_golden(trees, tmp_path, name, model):
    desc = PIPELINES[name]
    old = f"model=zoo:{model} "
    assert old in desc
    desc = desc.replace(old, f'model=zoo:{model} custom="params:{trees[model][1]}" ')
    out = tmp_path / "dump.raw"
    assert cli.main(["--device", "cpu", "-q", desc.format(out=out)]) == 0
    with open(f"{GOLDEN_DIR}/{name}.raw", "rb") as f:
        assert out.read_bytes() == f.read()
