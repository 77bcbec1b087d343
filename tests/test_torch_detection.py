"""Port parity for the detection slice: NMS, the detection functions, the
SSD anchors and model, the bounding_boxes decoder and the slice pipeline
of nnstreamer_tpu_torch against the JAX package, on numpy-seeded inputs.

Tolerances:

- NMS (the plain version a CPU tensor takes, behind the same ranking and
  packing as the CUDA kernel): bit-identical to ``detection.nms(impl=
  "jnp")`` and to the Pallas kernel in interpret mode.
- Detection functions: indices and classes identical; boxes and scores
  within 1e-6, since ``exp`` and ``sigmoid`` may differ by an ulp between
  XLA and PyTorch. The inputs are checked to hold no IoU within 1e-5 of
  the threshold, so such an ulp cannot flip a suppression.
- SSD outputs on carried JAX weights: within 1e-4 of max |x| (XLA's and
  PyTorch's CPU convolutions sum in different orders, 20 layers deep).
- Decoder: the detections as for the functions, the RGBA canvas
  byte-identical.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nnstreamer_tpu.elements.decoder import TensorDecoder as JDecoder
from nnstreamer_tpu.models import ssd_mobilenet as jssd
from nnstreamer_tpu.models import zoo as jzoo
from nnstreamer_tpu.ops import detection as jdet
from nnstreamer_tpu.ops.pallas import registry as kernel_registry
from nnstreamer_tpu.ops.pallas.nms import _boxes_scores as registry_boxes_scores
from nnstreamer_tpu.ops.pallas.nms import nms as pallas_nms
from nnstreamer_tpu.pipeline.parse import parse_pipeline as jax_parse
from nnstreamer_tpu.tensors.frame import Frame as JFrame
from nnstreamer_tpu.tensors.spec import TensorsSpec as JSpec
from nnstreamer_tpu_torch import cli
from nnstreamer_tpu_torch.decoders import render as trender
from nnstreamer_tpu_torch.elements.base import NegotiationError
from nnstreamer_tpu_torch.elements.decoder import TensorDecoder as TDecoder
from nnstreamer_tpu_torch.models import ssd_mobilenet as tssd
from nnstreamer_tpu_torch.models import zoo as tzoo
from nnstreamer_tpu_torch.ops import detection as tdet
from nnstreamer_tpu_torch.ops.kernels import nms as tnms
from nnstreamer_tpu_torch.pipeline.parse import parse_pipeline
from nnstreamer_tpu_torch.tensors.frame import Frame as TFrame
from nnstreamer_tpu_torch.tensors.spec import TensorsSpec as TSpec

SSD_CLASSES = 8  # num_classes of the raw-model cases (keeps the CPU time down)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _iou(boxes):
    return np.asarray(jdet.iou_matrix(jnp.asarray(boxes)))


def _assert_clear_of_threshold(boxes, scores, thr):
    """No IoU between two live candidates within 1e-5 of ``thr``: an ulp
    of exp/sigmoid between the two frameworks then cannot flip a
    suppression."""
    live = np.asarray(scores) > 0
    iou = _iou(np.asarray(boxes))[np.ix_(live, live)]
    assert np.abs(iou - np.float32(thr)).min() > 1e-5


def _center_boxes(p):
    """(cx, cy, w, h, ...) rows → x1, y1, x2, y2."""
    return np.concatenate([p[:, :2] - p[:, 2:4] / 2, p[:, :2] + p[:, 2:4] / 2], -1)


def _palm_boxes(raw, size):
    anchors = jdet.generate_mp_palm_anchors(input_size=size)
    p = np.stack([raw[:, 0] / size + anchors[:, 1], raw[:, 1] / size + anchors[:, 0],
                  raw[:, 2] / size, raw[:, 3] / size], -1)
    return _center_boxes(p)


def _jax_leaves_npz(params, path):
    leaves = jax.tree_util.tree_leaves(params)
    np.savez(path, **{f"p{i}": np.asarray(v) for i, v in enumerate(leaves)})
    return str(path)


# -- NMS -----------------------------------------------------------------------


def _random_case(n, seed, zero_below=0.3):
    rng = np.random.default_rng(seed)
    boxes = rng.random((n, 4)).astype(np.float32)
    boxes[:, 2:] = boxes[:, :2] + rng.random((n, 2)).astype(np.float32)
    scores = rng.random(n).astype(np.float32)
    scores[scores < zero_below] = 0.0
    return boxes, scores


def _nms_inputs():
    cases = []
    for c in kernel_registry.get("nms").tier1_cases():
        boxes, scores = registry_boxes_scores(c.params)
        cases.append(pytest.param(
            np.asarray(boxes), np.asarray(scores), c.params.get("max_out", 8),
            id=f"registry-{c.name}",
        ))
    for n in (40, 200):  # under / over one lane pad (tests/test_ops_device.py)
        cases.append(pytest.param(*_random_case(n, n), 20, id=f"random-n{n}"))
    boxes, scores = _random_case(64, 1, zero_below=0.0)
    scores[40:] = 0.0  # a tail of zero scores: never alive, never kept
    cases.append(pytest.param(boxes, scores, 50, id="zero-score-tail"))
    boxes, _ = _random_case(48, 2)
    ties = np.repeat(np.float32([0.9, 0.6, 0.3, 0.0]), 12)
    cases.append(pytest.param(boxes, ties, 48, id="exact-ties"))
    boxes, scores = _random_case(32, 3, zero_below=0.0)
    boxes[::3, 2] = boxes[::3, 0]  # zero width
    boxes[1::4, 3] = boxes[1::4, 1]  # zero height
    cases.append(pytest.param(boxes, scores, 32, id="degenerate-boxes"))
    return cases


@pytest.mark.parametrize("boxes,scores,max_out", _nms_inputs())
def test_nms_bit_identical_to_jax(boxes, scores, max_out):
    idx, sc = tdet.nms(_t(boxes), _t(scores), 0.5, max_out)
    assert idx.dtype == torch.int32 and sc.dtype == torch.float32
    for ref in (
        jdet.nms(jnp.asarray(boxes), jnp.asarray(scores), 0.5, max_out, impl="jnp"),
        pallas_nms(jnp.asarray(boxes), jnp.asarray(scores), 0.5, max_out, interpret=True),
    ):
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(sc.numpy(), np.asarray(ref[1]))


def test_tie_rules_match_jax():
    """Equal scores keep index order (both argsorts stable over the
    negated scores) and equal class probabilities give the first class
    (torch.argmax's first maximum, as jnp.argmax)."""
    boxes = np.array([[0.1 * i, 0, 0.1 * i + 0.05, 0.05] for i in range(6)], np.float32)
    scores = np.float32([0.5, 0.7, 0.5, 0.7, 0.0, 0.5])
    idx, _ = tdet.nms(_t(boxes), _t(scores), 0.5, 6)
    assert idx.tolist() == [1, 3, 0, 2, 5, -1]
    want, _ = jdet.nms(jnp.asarray(boxes), jnp.asarray(scores), 0.5, 6, impl="jnp")
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want))
    logits = np.zeros((6, 4), np.float32)
    logits[:, 2] = logits[:, 3] = 2.0  # classes 2 and 3 tie
    logits[3, 1] = 2.0  # class 1 ties too on row 3
    priors = np.tile(np.float32([[0.5], [0.5], [0.2], [0.2]]), (1, 6))
    got = tdet.ssd_postprocess(_t(np.zeros((6, 4), np.float32)), _t(logits), _t(priors))
    want = jdet.ssd_postprocess(jnp.zeros((6, 4)), jnp.asarray(logits), jnp.asarray(priors))
    assert set(got.numpy()[:, 4][got.numpy()[:, 5] > 0]) <= {1.0, 2.0}
    np.testing.assert_array_equal(got.numpy()[:, 4], np.asarray(want)[:, 4])


def test_plain_mask_stops_at_live_prefix():
    boxes, scores = _random_case(50, 7)
    order = np.argsort(-scores, kind="stable")
    alive = tnms.plain_nms_mask(_t(boxes[order]), _t(scores[order]), 0.5)
    assert alive.dtype == torch.bool
    assert not alive.numpy()[scores[order] <= 0].any()


# -- detection functions --------------------------------------------------------


def _close(got, want, cls_col=None):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if cls_col is not None:
        np.testing.assert_array_equal(got[:, cls_col], want[:, cls_col])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _ssd_inputs(n=96, classes=5, seed=11):
    rng = np.random.default_rng(seed)
    priors = np.stack([
        rng.uniform(0.2, 0.8, n), rng.uniform(0.2, 0.8, n),
        rng.uniform(0.05, 0.4, n), rng.uniform(0.05, 0.4, n),
    ]).astype(np.float32)
    loc = rng.standard_normal((n, 4)).astype(np.float32)
    logits = rng.standard_normal((n, classes)).astype(np.float32) * 2
    return loc, logits, priors


def test_ssd_decode_boxes_matches_jax():
    loc, _, priors = _ssd_inputs()
    _close(tdet.ssd_decode_boxes(_t(loc), _t(priors)),
           jdet.ssd_decode_boxes(jnp.asarray(loc), jnp.asarray(priors)))
    _close(tdet.ssd_decode_boxes(_t(loc), _t(priors), 8.0, 9.0, 4.0, 3.0),
           jdet.ssd_decode_boxes(jnp.asarray(loc), jnp.asarray(priors), 8.0, 9.0, 4.0, 3.0))


def test_iou_matrix_matches_jax():
    boxes, _ = _random_case(40, 16)
    boxes[3] = boxes[3, [0, 1, 0, 1]]  # a zero-area box
    got = tdet.iou_matrix(_t(boxes)).numpy()
    np.testing.assert_array_equal(got, _iou(boxes))


@pytest.mark.parametrize("threshold,iou", [(0.5, 0.5), (0.3, 0.45)])
def test_ssd_postprocess_matches_jax(threshold, iou):
    loc, logits, priors = _ssd_inputs()
    boxes = np.asarray(jdet.ssd_decode_boxes(jnp.asarray(loc), jnp.asarray(priors)))
    _assert_clear_of_threshold(boxes, np.ones(len(boxes)), iou)
    got = tdet.ssd_postprocess(_t(loc), _t(logits), _t(priors), threshold, iou, 20)
    want = jdet.ssd_postprocess(
        jnp.asarray(loc), jnp.asarray(logits), jnp.asarray(priors),
        threshold=threshold, iou_threshold=iou, max_out=20,
    )
    assert (got.numpy()[:, 5] > 0).sum() > 3
    _close(got, want, cls_col=4)


def test_ssd_pp_postprocess_matches_jax():
    rng = np.random.default_rng(12)
    loc = rng.random((12, 4)).astype(np.float32)
    cls = rng.integers(0, 90, 12).astype(np.float32)
    sco = rng.random(12).astype(np.float32)
    num = np.float32(9.0)
    for max_out in (8, 20):
        got = tdet.ssd_pp_postprocess(
            _t(loc), _t(cls), _t(sco), torch.tensor(num), 0.4, max_out
        )
        want = jdet.ssd_pp_postprocess(
            jnp.asarray(loc), jnp.asarray(cls), jnp.asarray(sco), jnp.asarray(num),
            threshold=0.4, max_out=max_out,
        )
        assert got.shape == (max_out, 6)
        _close(got, _pad_rows(want, max_out), cls_col=4)


def _pad_rows(det, max_out):
    """The JAX package's mobilenet-ssd-postprocess decode returns
    [min(N, max_out), 6] rows where its decoder declares [max_out, 6]; the
    port pads with empty rows."""
    det = np.asarray(det)
    return np.pad(det, ((0, max_out - len(det)), (0, 0)))


@pytest.mark.parametrize("scaled", [True, False])
def test_yolov5_postprocess_matches_jax(scaled):
    rng = np.random.default_rng(13)
    pred = rng.random((60, 9)).astype(np.float32)
    pred[:, 2:4] *= 0.3
    if not scaled:
        pred = (pred - 0.5) * 6
    p = pred if scaled else 1 / (1 + np.exp(-pred))
    _assert_clear_of_threshold(_center_boxes(p), np.ones(60), 0.6)
    got = tdet.yolov5_postprocess(_t(pred), scaled=scaled)
    want = jdet.yolov5_postprocess(jnp.asarray(pred), scaled=scaled)
    _close(got, want, cls_col=4)


def test_ov_detection_postprocess_matches_jax():
    rng = np.random.default_rng(14)
    pred = rng.random((30, 7)).astype(np.float32)
    pred[:, 1] = rng.integers(0, 3, 30)
    for max_out in (100, 5):
        _close(tdet.ov_detection_postprocess(_t(pred), max_out=max_out),
               jdet.ov_detection_postprocess(jnp.asarray(pred), max_out=max_out), cls_col=4)


def test_mp_palm_matches_jax():
    anchors = tdet.generate_mp_palm_anchors(input_size=64)
    np.testing.assert_array_equal(anchors, jdet.generate_mp_palm_anchors(input_size=64))
    np.testing.assert_array_equal(
        tdet.generate_mp_palm_anchors(num_layers=5, min_scale=0.2, max_scale=0.9,
                                      strides=(8, 16, 16, 32, 32), input_size=96),
        jdet.generate_mp_palm_anchors(num_layers=5, min_scale=0.2, max_scale=0.9,
                                      strides=(8, 16, 16, 32, 32), input_size=96),
    )
    n = anchors.shape[0]
    rng = np.random.default_rng(15)
    raw = (rng.standard_normal((n, 18)) * 8).astype(np.float32)
    raw[:, 2:4] = rng.uniform(4, 20, (n, 2))
    scores = rng.standard_normal(n).astype(np.float32)
    _assert_clear_of_threshold(_palm_boxes(raw, 64), np.ones(n), 0.3)
    got = tdet.mp_palm_postprocess(_t(raw), _t(scores), _t(anchors), input_size=64)
    want = jdet.mp_palm_postprocess(
        jnp.asarray(raw), jnp.asarray(scores), jnp.asarray(anchors), input_size=64
    )
    _close(got, want, cls_col=4)
    with pytest.raises(ValueError, match="strides"):
        tdet.generate_mp_palm_anchors(num_layers=5)


# -- SSD anchors and model -------------------------------------------------------


def test_anchors_and_box_priors_identical(tmp_path):
    got = tssd.generate_anchors()
    assert got.shape == (4, 1917) and tssd.NUM_ANCHORS == 1917
    np.testing.assert_array_equal(got, jssd.generate_anchors())
    tssd.write_box_priors(str(tmp_path / "port.txt"))
    jssd.write_box_priors(str(tmp_path / "jax.txt"))
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()


@pytest.fixture(scope="module")
def ssd_zoo(tmp_path_factory):
    """The JAX zoo's 8-class SSD (seed 0) and its weights as a params npz."""
    raw = jzoo.get("ssd_mobilenet_v2", num_classes=str(SSD_CLASSES))
    path = tmp_path_factory.mktemp("ssd") / "ssd8.npz"
    return {"model": raw, "npz": _jax_leaves_npz(raw.params, path)}


def _numpy_ssd_params(seed, num_classes=tssd.NUM_CLASSES):
    """A reference-shaped SSD param tree of numpy-seeded weights: convs
    N(0, 2/fan_in), and batch-norm vectors and head biases away from their
    identity init, so a swapped or misplaced leaf shows."""
    shapes = jax.eval_shape(
        functools.partial(jssd.init_params, num_classes=num_classes), jax.random.PRNGKey(0)
    )
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


def _image(seed=21):
    return np.random.default_rng(seed).integers(0, 256, (1, 300, 300, 3)).astype(np.uint8)


def test_ssd_matches_jax(ssd_zoo):
    tree = jax.tree_util.tree_map(np.asarray, ssd_zoo["model"].params)
    assert len(jax.tree_util.tree_leaves(tree)) == len(tssd.jax_leaf_paths())
    m = tzoo.get(
        "ssd_mobilenet_v2", device="cpu", num_classes=str(SSD_CLASSES),
        params=ssd_zoo["npz"],
    )
    assert m.input_spec[0].shape == (1, 300, 300, 3)
    x = _image()
    with torch.inference_mode():
        loc, cls = (t.numpy() for t in m.module(_t(x)))
    want_loc, want_cls = jax.jit(ssd_zoo["model"].fn)(x)
    assert loc.shape == (1, 1917, 4) and cls.shape == (1, 1917, SSD_CLASSES)
    for got, want in ((loc, want_loc), (cls, want_cls)):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    # the state dict carried directly from the tree is the same model
    direct = tssd.SSDMobileNetV2(num_classes=SSD_CLASSES)
    direct.load_state_dict(tssd.ssd_mobilenet_from_jax(tree))
    for k, v in direct.state_dict().items():
        torch.testing.assert_close(v, m.module.state_dict()[k], rtol=0, atol=0)


def test_ssd_pp_matches_jax(tmp_path):
    """``ssd_mobilenet_v2_pp`` on carried weights (every leaf away from
    its init) against the function behind the JAX zoo's model of that
    name (``apply_postprocessed`` with the zoo's max_out 10, threshold
    0.001): the same num and classes, boxes and scores within 1e-4."""
    params = _numpy_ssd_params(23)
    m = tzoo.get(
        "ssd_mobilenet_v2_pp", device="cpu",
        params=_jax_leaves_npz(params, tmp_path / "ssd91.npz"),
    )
    x = _image(22)
    with torch.inference_mode():
        boxes, classes, scores, num = (t.numpy() for t in m.module(_t(x)))
    priors = jnp.asarray(jssd.generate_anchors())
    ref = jax.jit(lambda p, im: jssd.apply_postprocessed(p, im, priors, max_out=10))
    wb, wc, ws, wn = (np.asarray(t) for t in ref(params, x))
    assert boxes.shape == (10, 4) and classes.shape == (10,) and num.shape == (1,)
    assert wn[0] > 0  # the reference keeps detections, so the rows below are compared
    np.testing.assert_array_equal(num, wn)
    np.testing.assert_array_equal(classes, wc)
    np.testing.assert_allclose(boxes, wb, rtol=0, atol=1e-4)
    np.testing.assert_allclose(scores, ws, rtol=0, atol=1e-4)


def test_zoo_ssd_options(ssd_zoo):
    """compute_dtype=bfloat16 runs the reference's bfloat16 SSD: the port's
    outputs no farther from the reference's bfloat16 outputs than those
    are from its float32 ones; any other dtype, or an unknown option,
    raises."""
    m = tzoo.get("ssd_mobilenet_v2", device="cpu", compute_dtype="bfloat16",
                 num_classes=str(SSD_CLASSES), params=ssd_zoo["npz"])
    x = np.random.default_rng(6).integers(0, 256, (1, 300, 300, 3)).astype(np.uint8)
    with torch.inference_mode():
        got = [t.numpy() for t in m.module(_t(x))]
    params = ssd_zoo["model"].params
    want = {
        dt: [np.asarray(t) for t in jax.jit(lambda p, im, dt=dt: jssd.apply(
            p, im, compute_dtype=dt, num_classes=SSD_CLASSES))(params, x)]
        for dt in (jnp.float32, jnp.bfloat16)
    }
    for g, w16, w32 in zip(got, want[jnp.bfloat16], want[jnp.float32]):
        assert g.dtype == np.float32 and g.shape == w16.shape
        assert np.abs(g - w16).max() <= np.abs(w16 - w32).max()
    with pytest.raises(ValueError, match="compute_dtype"):
        tzoo.get("ssd_mobilenet_v2", device="cpu", compute_dtype="float16")
    with pytest.raises(ValueError, match="unsupported option"):
        tzoo.get("ssd_mobilenet_v2_pp", device="cpu", quantize="int8")


# -- the bounding_boxes decoder ---------------------------------------------------


def _priors_file(tmp_path, priors):
    p = tmp_path / "box-priors.txt"
    p.write_text("\n".join(" ".join(f"{v:.8f}" for v in r) for r in priors))
    return str(p)


def _decoder_case(mode, tmp_path):
    """(options, input arrays, input dim strings) for one mode."""
    rng = np.random.default_rng(len(mode))
    if mode in ("mobilenet-ssd", "tflite-ssd"):
        loc, logits, priors = _ssd_inputs(n=64, classes=5, seed=31)
        boxes = np.asarray(jdet.ssd_decode_boxes(jnp.asarray(loc), jnp.asarray(priors)))
        _assert_clear_of_threshold(boxes, np.ones(64), jdet.SSD_IOU_THRESHOLD)
        labels = tmp_path / "labels.txt"
        labels.write_text("background\nperson\ncar\ndog\nbird\n")
        opts = {"option3": _priors_file(tmp_path, priors) + ":0.4", "option2": str(labels)}
        return opts, [loc[None], logits[None]], "4:64:1,5:64:1"
    if mode in ("mobilenet-ssd-postprocess", "tf-ssd"):
        loc = rng.random((10, 4)).astype(np.float32)
        cls = rng.integers(0, 5, 10).astype(np.float32)
        sco = rng.random(10).astype(np.float32)
        num = np.float32([8.0])
        return {"option3": "0:1:2:3,30"}, [loc, cls, sco, num], "4:10,10,10,1"
    if mode.startswith("ov-"):
        pred = rng.random((20, 7)).astype(np.float32)
        pred[:, 2] = rng.uniform(0.6, 1.0, 20)
        return {}, [pred[None, None]], "7:20:1:1"
    if mode in ("yolov5", "yolov5-pixel"):
        pred = rng.random((40, 8)).astype(np.float32)
        pred[:, 2:4] *= 0.3
        _assert_clear_of_threshold(_center_boxes(pred), np.ones(40), jdet.YOLOV5_IOU_THRESHOLD)
        if mode == "yolov5-pixel":
            pred[:, :4] *= 320
            return ({"option3": "0.3:0.6:pixel", "option5": "320:320"},
                    [pred[None]], "8:40:1")
        return {}, [pred[None]], "8:40:1"
    if mode == "mp-palm-detection":
        n = len(jdet.generate_mp_palm_anchors(input_size=64))
        raw = (rng.standard_normal((n, 18)) * 8).astype(np.float32)
        raw[:, 2:4] = rng.uniform(4, 20, (n, 2))
        scores = rng.standard_normal((n, 1)).astype(np.float32)
        _assert_clear_of_threshold(_palm_boxes(raw, 64), np.ones(n), 0.3)
        return {"option5": "64:64"}, [raw[None], scores[None]], f"18:{n}:1,1:{n}:1"
    raise AssertionError(mode)


DECODER_MODES = [
    "mobilenet-ssd", "tflite-ssd", "mobilenet-ssd-postprocess", "tf-ssd",
    "ov-person-detection", "ov-face-detection", "yolov5", "yolov5-pixel",
    "mp-palm-detection",
]


@pytest.mark.parametrize("mode", DECODER_MODES)
def test_bounding_box_decoder_matches_jax(mode, tmp_path):
    opts, arrays, dims = _decoder_case(mode, tmp_path)
    props = dict(opts, option1=mode.replace("-pixel", ""), option4="96:72")
    dtypes = ",".join(["float32"] * len(arrays))
    dev_out, host_out = [], []
    for dec_cls, spec_cls, frame_cls, conv in (
        (JDecoder, JSpec, JFrame, jnp.asarray), (TDecoder, TSpec, TFrame, _t),
    ):
        dev = dec_cls(mode="bounding_boxes", postproc="device", **props)
        (out_spec,) = dev.fix_negotiation([spec_cls.from_strings(dims, dtypes)])
        assert dev.is_traceable()
        (d,) = dev.make_fn()(tuple(conv(a) for a in arrays))
        dev_out.append(_pad_rows(_np(d), out_spec[0].shape[0]))
        if dec_cls is TDecoder:
            assert out_spec[0].shape == tuple(d.shape)
        host = dec_cls(mode="bounding_boxes", **props)
        (media,) = host.fix_negotiation([spec_cls.from_strings(dims, dtypes)])
        assert (media.width, media.height, media.format) == (96, 72, "RGBA")
        assert not host.is_traceable()
        host_out.append(host.host_process(frame_cls(tuple(arrays))))
    _close(dev_out[1], dev_out[0], cls_col=4)
    assert (dev_out[1][:, 5] > 0).any()
    (jcanvas,), (tcanvas,) = host_out[0].tensors, host_out[1].tensors
    assert tcanvas.dtype == np.uint8 and tcanvas.shape == (72, 96, 4)
    assert tcanvas.tobytes() == np.asarray(jcanvas).tobytes()
    assert tcanvas.any()
    _close(host_out[1].meta["detections"], host_out[0].meta["detections"], cls_col=4)


def test_decoder_postproc_rules(tmp_path):
    from nnstreamer_tpu_torch.tensors.spec import DType, TensorSpec

    spec = TSpec.of(TensorSpec((1, 10), DType.FLOAT32))
    auto = TDecoder(mode="image_labeling")
    auto.fix_negotiation([spec])
    assert auto.is_traceable()  # auto fuses a make_fn
    host = TDecoder(mode="image_labeling", postproc="host")
    host.fix_negotiation([spec])
    assert not host.is_traceable()  # host never fuses
    labels = tmp_path / "labels.txt"
    labels.write_text("a\nb\n")
    dev = TDecoder(mode="image_labeling", postproc="device", option1=str(labels))
    with pytest.raises(NegotiationError, match="no device decode"):
        dev.fix_negotiation([spec])
    with pytest.raises(ValueError, match="postproc"):
        TDecoder(mode="bounding_boxes", postproc="gpu")
    with pytest.raises(NegotiationError, match="expected 2 tensors"):
        TDecoder(mode="bounding_boxes", option1="mobilenet-ssd",
                 option3=_priors_file(tmp_path, np.ones((4, 3)))).fix_negotiation([spec])


def test_draw_text_needs_pil(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "PIL", None)
    det = np.float32([[0.1, 0.1, 0.5, 0.5, 1, 0.9]])
    trender.render_detections(det, 32, 32)  # boxes only: no PIL needed
    with pytest.raises(ImportError, match="Pillow"):
        trender.render_detections(det, 32, 32, labels=["a", "b"])


# -- the slice pipeline -----------------------------------------------------------


SLICE = (
    "videotestsrc pattern=gradient width=160 height=120 num-frames=2 ! "
    "tensor_converter ! tensor_transform mode=resize option=300:300 ! "
    "tensor_filter framework={fw} model=zoo:ssd_mobilenet_v2 "
    'custom="num_classes:{classes}{extra}" ! '
    "tensor_decoder mode=bounding_boxes option1=mobilenet-ssd option3={priors} "
    "postproc=device ! {sink}"
)


def test_detection_slice_matches_jax(ssd_zoo, tmp_path):
    """160x120 frames → resize 300 → SSD (JAX weights) → bounding_boxes
    postproc=device, through the port's CLI and parse_pipeline, against
    the JAX pipeline: one fused segment of 4 ops, the same detections."""
    priors = str(tmp_path / "box-priors.txt")
    tssd.write_box_priors(priors)
    port_desc = SLICE.format(
        fw="torch", classes=SSD_CLASSES, extra=f",params:{ssd_zoo['npz']}",
        priors=priors, sink="{sink}",
    )
    port = parse_pipeline(port_desc.format(sink="tensor_sink name=out"), device="cpu")
    plan = port.compile_plan()
    assert len(plan.segments) == 1 and len(plan.segments[0].ops) == 4
    port.run(timeout=300)
    got = np.stack([f.tensors[0] for f in port["out"].frames])
    dump = tmp_path / "dets.raw"
    assert cli.main(["--device", "cpu", "-q", port_desc.format(
        sink=f"filesink location={dump}")]) == 0
    assert dump.read_bytes() == got.tobytes()
    ref = jax_parse(SLICE.format(
        fw="jax", classes=SSD_CLASSES, extra="", priors=priors, sink="tensor_sink name=out",
    ))
    ref.run(timeout=300)
    want = np.stack([np.asarray(f.tensors[0]) for f in ref["out"].frames])
    assert got.shape == want.shape == (2, 100, 6) and got.dtype == np.float32
    np.testing.assert_array_equal(got[..., 4], want[..., 4])
    # the same anchors kept in the same order; the model's outputs differ
    # by the convolutions' summation order (1e-4 of max |x|, see
    # test_ssd_matches_jax), which the box decode's exp carries through
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
    np.testing.assert_allclose(got[..., 5], want[..., 5], rtol=0, atol=1e-5)
