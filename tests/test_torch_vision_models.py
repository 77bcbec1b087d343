"""Port parity for the face cascade and YOLOv5: the zoo models of
nnstreamer_tpu_torch against the JAX package's functions on its own
weights (carried over through ``params:<npz>``), numpy-seeded inputs, and
the three face goldens through ``nnstreamer_tpu_torch.cli --device cpu``.

Tolerances:

- float32: within 5e-5 of max(1, max |ref|): XLA's and PyTorch's CPU
  convolutions sum in other orders, up to 10 layers deep; the int32
  regions (pixel coordinates truncated toward zero) within 1.
- bfloat16: the port's output is no farther from the reference's
  bfloat16 output than the reference's bfloat16 output is from its own
  float32 output (each side rounds to 8 mantissa bits at every op, in its
  own order). The detector's rows are compared column by column sorted,
  since a near-tie in bfloat16 may swap two rows of the top-k.
- ``decoder_bbox_ov`` (an RGBA canvas) byte for byte. ``composite_fused``
  as float32 within 1e-5 (the float32 rule at the outputs' scale, 1).
  ``composite_device_crop`` within 2e-4: its crops are uint8, and a crop
  pixel rounded one step the other way at a .5 boundary moves a landmark
  by about 1e-5.
- K1 at the composite's shape (128² f32/bf16 image → 16 × 112²): the
  plain version against the Pallas kernel in interpret mode and the jnp
  path within ``interp_atol``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nnstreamer_tpu.models import face_pipeline as jfp
from nnstreamer_tpu.models import yolo as jyolo
from nnstreamer_tpu.ops import image as jimage
from nnstreamer_tpu.ops.pallas import image_kernels as jik
from nnstreamer_tpu_torch import cli
from nnstreamer_tpu_torch.device import NoDeviceError
from nnstreamer_tpu_torch.models import face_pipeline as tfp
from nnstreamer_tpu_torch.models import jax_weights
from nnstreamer_tpu_torch.models import yolo as tyolo
from nnstreamer_tpu_torch.models import zoo as tzoo
from nnstreamer_tpu_torch.ops.kernels import image_kernels as tik

from test_golden import GOLDEN_DIR, PIPELINES

DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
YOLO = dict(size=64, width=16, num_classes=4)


def save_npz(tree, path):
    leaves = jax.tree_util.tree_leaves(tree)
    np.savez(path, **{f"p{i}": np.asarray(v) for i, v in enumerate(leaves)})
    return str(path)


def image(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


def as_tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The reference zoo's seed-0 trees (its own eager init, as the goldens
    were made) and their npz files."""
    d = tmp_path_factory.mktemp("weights")
    k = jax.random.PRNGKey(0)
    k1, k2 = jax.random.split(k)
    out = {
        "detect": jfp.init_detect_params(k),
        "landmark": jfp.init_landmark_params(k),
        "composite": {"detect": jfp.init_detect_params(k1),
                      "landmark": jfp.init_landmark_params(k2)},
        "yolov5": jyolo.init_params(k, num_classes=YOLO["num_classes"], width=YOLO["width"]),
    }
    return {name: (tree, save_npz(tree, d / f"{name}.npz")) for name, tree in out.items()}


# name → (tree key, zoo options, input shape, reference fn(params, x, dtype))
CASES = {
    "detect-ov": ("detect", {}, (1, 128, 128, 3),
                  lambda p, x, dt: jfp.apply_detect(p, x, compute_dtype=dt)),
    "detect-regions": (
        "detect", {"output": "regions", "frame_size": "1280:720", "threshold": "0.0"},
        (1, 128, 128, 3),
        lambda p, x, dt: jfp.detections_to_regions(
            jfp.apply_detect(p, x, compute_dtype=dt), 1280, 720, 0.0)),
    "detect-regions+image": (
        "detect", {"output": "regions+image", "frame_size": "640:480", "threshold": "0.3"},
        (1, 128, 128, 3),
        lambda p, x, dt: jfp.apply_detect_regions_with_image(
            p, x, 640, 480, threshold=0.3, compute_dtype=dt)),
    "landmark": ("landmark", {"batch": "4"}, (4, 112, 112, 3),
                 lambda p, x, dt: jfp.apply_landmark(p, x, compute_dtype=dt)),
    "composite": ("composite", {"threshold": "0.0"}, (1, 128, 128, 3),
                  lambda p, x, dt: jfp.apply_composite(
                      p["detect"], p["landmark"], x, threshold=0.0, compute_dtype=dt)),
    "composite-thr": ("composite", {"threshold": "0.5"}, (1, 128, 128, 3),
                      lambda p, x, dt: jfp.apply_composite(
                          p["detect"], p["landmark"], x, threshold=0.5, compute_dtype=dt)),
    "yolov5": ("yolov5", {k: str(v) for k, v in YOLO.items()}, (1, 64, 64, 3),
               lambda p, x, dt: jyolo.apply(p, x, num_classes=YOLO["num_classes"],
                                            compute_dtype=dt)),
}
ZOO_NAME = {"detect": "face_detect", "landmark": "face_landmark",
            "composite": "face_composite", "yolov5": "yolov5"}


def run_case(trees, case, dtype, x):
    key, opts, _, ref = CASES[case]
    tree, npz = trees[key]
    want = as_tuple(jax.jit(ref, static_argnums=2)(tree, jnp.asarray(x), DTYPES[dtype]))
    m = tzoo.get(ZOO_NAME[key], device="cpu", params=npz, compute_dtype=dtype, **opts)
    with torch.inference_mode():
        got = as_tuple(m.module(torch.from_numpy(x)))
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def _err(a, b):
    return float(np.abs(a.astype(np.float64) - b.astype(np.float64)).max())


@pytest.mark.parametrize("case", list(CASES))
def test_model_float32_matches_jax(trees, case):
    x = image(CASES[case][2], 1)
    want, got = run_case(trees, case, "float32", x)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        if w.dtype == np.int32:  # pixel regions, truncated toward zero
            assert _err(g, w) <= 1
        elif w.dtype == np.uint8:  # the image, passed through
            np.testing.assert_array_equal(g, w)
        else:
            assert _err(g, w) <= 5e-5 * max(1.0, float(np.abs(w).max()))


@pytest.mark.parametrize("case", list(CASES))
def test_model_bfloat16_within_reference_drift(trees, case):
    x = image(CASES[case][2], 2)
    want16, got16 = run_case(trees, case, "bfloat16", x)
    want32, _ = run_case(trees, case, "float32", x)
    for g, w16, w32 in zip(got16, want16, want32):
        assert g.shape == w16.shape and g.dtype == w16.dtype
        if case.startswith("detect") and w16.ndim == 2:
            g, w16, w32 = (np.sort(a, axis=0) for a in (g, w16, w32))
        drift = _err(w16, w32)
        assert _err(g, w16) <= max(drift, 1e-6), (case, _err(g, w16), drift)


def test_yolov5_rows_at_size_320():
    m = tzoo.get("yolov5", device="cpu", width="8")
    with torch.inference_mode():
        (out,) = as_tuple(m.module(torch.from_numpy(image((1, 320, 320, 3), 3))))
    assert out.shape == (1, tyolo.n_rows(320), 85) == (1, 6300, 85)
    assert tyolo.n_rows(320) == jyolo.n_rows(320)


def test_yolo_slice_matches_jax_pipeline(trees):
    """The YOLO slice end to end at a small size: frames → resize 64 →
    yolov5 (the JAX weights) → bounding_boxes yolov5 postproc=device (the
    port's NMS on the CPU takes K2's plain version, the reference's its
    jnp path): the same detections."""
    desc = (
        "videotestsrc pattern=gradient width=160 height=120 num-frames=2 ! tensor_converter ! "
        "tensor_transform mode=resize option=64:64 ! tensor_filter framework={fw} "
        'model=zoo:yolov5 custom="size:64,width:16,num_classes:4{extra}" ! '
        "tensor_decoder mode=bounding_boxes option1=yolov5 option3=0.1 option5=64:64 "
        "postproc=device ! tensor_sink name=out"
    )
    from nnstreamer_tpu.pipeline.parse import parse_pipeline as jax_parse
    from nnstreamer_tpu_torch.pipeline.parse import parse_pipeline

    port = parse_pipeline(desc.format(fw="torch", extra=f",params:{trees['yolov5'][1]}"),
                          device="cpu")
    port.run(timeout=120)
    ref = jax_parse(desc.format(fw="jax", extra=""))
    ref.run(timeout=120)
    got = [f.tensors[0] for f in port["out"].frames]
    want = [np.asarray(f.tensors[0]) for f in ref["out"].frames]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape == (100, 6) and (w[:, 5] > 0).any()
        np.testing.assert_array_equal(g[:, 4], w[:, 4])
        assert _err(g, w) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_crop_at_composite_shape_matches_reference(dtype):
    """K1's crop entry at face_composite's shape: a normalized 128² image
    (float32 or bfloat16), 16 boxes of a detector's kind (inside, across
    the edge, degenerate) → 16 × 112²; the plain version against the
    Pallas kernel in interpret mode and the jnp path."""
    rng = np.random.default_rng(7)
    img = rng.standard_normal((128, 128, 3)).astype(np.float32)
    xy = rng.uniform(-10, 110, (16, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0, 60, (16, 2))], 1).astype(np.float32)
    boxes[3] = [40, 40, 40, 40]
    jdt = jnp.float32 if dtype is torch.float32 else jnp.bfloat16
    jimg = jnp.asarray(img).astype(jdt)
    got = tik.crop_and_resize(torch.from_numpy(img).to(dtype), torch.from_numpy(boxes), 112, 112)
    assert got.dtype == dtype and got.shape == (16, 112, 112, 3)
    tol = tik.interp_atol(torch.float32, 128, 128)
    if dtype is torch.bfloat16:
        tol = max(tol, 2.0 ** -7 * float(np.abs(img).max()))  # one bfloat16 ulp of the output
    for want in (jik.crop_and_resize(jimg, jnp.asarray(boxes), 112, 112, interpret=True),
                 jimage.crop_and_resize(jimg, jnp.asarray(boxes), 112, 112, impl="jnp")):
        assert _err(got.to(torch.float32).numpy(), np.asarray(want.astype(jnp.float32))) <= tol


# -- the top-k order, the leaves, the options ---------------------------------

def test_top_k_keeps_lax_order_on_ties():
    rng = np.random.default_rng(5)
    x = rng.choice([0.1, 0.5, 0.5, 0.9, 1.0], 64).astype(np.float32)
    x[[3, 9, 40]] = 1.0
    for k in (1, 5, 16, 64):
        v, i = tfp.top_k(torch.from_numpy(x), k)
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


def test_detector_top_k_ties_match_reference(trees):
    """A detector whose head saturates (every confidence 1.0): the rows
    come out in cell order, as ``lax.top_k`` gives them."""
    tree, _ = trees["detect"]
    tree = jax.tree_util.tree_map(lambda a: a, tree)
    tree["head"] = {"w": tree["head"]["w"] * 0.0, "b": jnp.asarray([50.0, 0.1, -0.2, 0.0, 0.3])}
    x = image((1, 128, 128, 3), 4)
    want = np.asarray(jfp.apply_detect(tree, jnp.asarray(x)))
    m = tfp.FaceDetect()
    m.load_state_dict(jax_weights.state_dict_from_tree(
        jax.tree_util.tree_map(np.asarray, tree), tfp.detect_leaf_paths()))
    with torch.inference_mode():
        got = m(torch.from_numpy(x)).numpy()
    assert (want[:, 2] == 1.0).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("key,paths", [
    ("detect", tfp.detect_leaf_paths), ("landmark", tfp.landmark_leaf_paths),
    ("composite", tfp.composite_leaf_paths), ("yolov5", tyolo.jax_leaf_paths),
])
def test_leaf_table_takes_every_leaf_once(trees, key, paths):
    """The port's leaf table is the reference tree's flatten order, each
    path a state-dict entry of the right shape, every entry taken once."""
    tree, npz = trees[key]
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    ref_paths = [tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p) for p, _ in flat]
    assert paths() == ref_paths
    model = tzoo.get(ZOO_NAME[key], device="cpu", **(
        {k: str(v) for k, v in YOLO.items()} if key == "yolov5" else {})).module
    state = model.state_dict()
    keys = [jax_weights.state_key(p) for p in paths()]
    assert sorted(keys) == sorted(state) and len(set(keys)) == len(keys)
    for k, (_, leaf) in zip(keys, flat):
        assert tuple(jax_weights.convert_leaf(np.asarray(leaf)).shape) == tuple(state[k].shape)
    loaded = tzoo.get(ZOO_NAME[key], device="cpu", params=npz, **(
        {k: str(v) for k, v in YOLO.items()} if key == "yolov5" else {})).module.state_dict()
    for k, (_, leaf) in zip(keys, flat):
        np.testing.assert_array_equal(loaded[k].numpy(),
                                      jax_weights.convert_leaf(np.asarray(leaf)).numpy())


def test_composite_params_take_the_whole_tree_detect_first(trees, tmp_path):
    """Departure (ROADMAP C): face_composite's ``params:`` npz is the whole
    {detect, landmark} tree, where the reference overlays the detector
    alone; an npz of the detector alone still overlays the detector alone
    and leaves the landmark net as the seed made it."""
    (tree, whole), (det, det_only) = trees["composite"], trees["detect"]
    full = tzoo.get("face_composite", device="cpu", params=whole).module
    n_det = len(tfp.detect_leaf_paths())
    assert len(tfp.composite_leaf_paths()) == n_det + len(tfp.landmark_leaf_paths())
    np.testing.assert_array_equal(
        full.landmark.fc.weight.numpy(), np.asarray(tree["landmark"]["fc"]["w"]).T)
    seeded = tzoo.get("face_composite", device="cpu", seed="3").module
    part = tzoo.get("face_composite", device="cpu", seed="3", params=det_only).module
    np.testing.assert_array_equal(part.detect.head.weight.numpy(),
                                  np.asarray(det["head"]["w"]).transpose(3, 2, 0, 1))
    for k, v in seeded.landmark.state_dict().items():
        np.testing.assert_array_equal(part.landmark.state_dict()[k].numpy(), v.numpy())


@pytest.mark.parametrize("name", ["face_detect", "face_landmark", "face_composite",
                                  "yolov5", "posenet", "deeplab_v3", "mobilenet_v2"])
def test_zoo_defaults_to_cuda_and_raises_without_it(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoDeviceError):
        tzoo.get(name)
    if name == "mobilenet_v2":
        with pytest.raises(NoDeviceError):
            tzoo.get(name, quantize="int8w")


@pytest.mark.parametrize("name,opts", [
    ("face_detect", {"output": "regions+image"}), ("face_landmark", {}),
    ("face_composite", {}), ("yolov5", {"size": "64", "width": "8"}), ("posenet", {}),
    ("deeplab_v3", {}), ("mobilenet_v2", {"quantize": "int8", "size": "64"}),
    ("mobilenet_v2", {"quantize": "int8w", "size": "64"}),
])
def test_model_state_moves_with_the_module(name, opts):
    """Every tensor a model holds is a parameter or a buffer, so ``.to(device)``
    moves all of it (a plain tensor attribute would stay on the host)."""
    model = tzoo.get(name, device="cpu", **opts).module
    for mod in model.modules():
        loose = [k for k, v in vars(mod).items() if isinstance(v, torch.Tensor)]
        assert not loose, (type(mod).__name__, loose)
    assert {t.device.type for t in (*model.parameters(), *model.buffers())} == {"cpu"}
    model.to("meta")
    assert {t.device.type for t in (*model.parameters(), *model.buffers())} == {"meta"}


@pytest.mark.parametrize("name,opts", [
    ("face_detect", {"output": "boxes"}),  # the reference serves OV rows for it
    ("face_detect", {"stride": "2"}),
    ("yolov5", {"size": "100"}),
    ("posenet", {"compute_dtype": "float16"}),
    ("mobilenet_v2", {"quantize": "int4"}),
    ("mobilenet_v2", {"calib_batches": "3"}),
])
def test_zoo_refuses_unknown_options(name, opts):
    with pytest.raises(ValueError):
        tzoo.get(name, device="cpu", **opts)


# -- the face goldens through the port's CLI ----------------------------------

GOLDEN_WEIGHTS = {
    "decoder_bbox_ov": [("model=zoo:face_detect ",
                         'model=zoo:face_detect custom="params:{detect}" ')],
    "composite_fused": [('custom="threshold:0.0"', 'custom="threshold:0.0,params:{composite}"')],
    "composite_device_crop": [('frame_size:128:128"', 'frame_size:128:128,params:{detect}"'),
                              ('custom="batch:16"', 'custom="batch:16,params:{landmark}"')],
}


@pytest.mark.parametrize("name,atol", [
    ("decoder_bbox_ov", None), ("composite_fused", 1e-5), ("composite_device_crop", 2e-4),
])
def test_face_golden(trees, tmp_path, name, atol):
    desc = PIPELINES[name]
    for old, new in GOLDEN_WEIGHTS[name]:
        assert old in desc
        desc = desc.replace(old, new.format(**{k: v[1] for k, v in trees.items()}))
    out = tmp_path / "dump.raw"
    assert cli.main(["--device", "cpu", "-q", desc.format(out=out)]) == 0
    got = out.read_bytes()
    with open(f"{GOLDEN_DIR}/{name}.raw", "rb") as f:
        want = f.read()
    if atol is None:
        assert got == want
    else:
        g, w = np.frombuffer(got, np.float32), np.frombuffer(want, np.float32)
        assert g.shape == w.shape and _err(g, w) <= atol
