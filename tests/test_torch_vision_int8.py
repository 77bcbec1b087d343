"""Port parity for the int8 MobileNet-v2 (``quantize:int8`` and
``quantize:int8w``) against the JAX package's ``models/quantize.py`` on
its own weights, and the ``filter_int8`` golden through
``nnstreamer_tpu_torch.cli --device cpu``.

Tolerances:

- folded weights: int8 weights within one step at under 0.1 % of them (a
  folded weight one float32 ulp apart, from ``rsqrt``, at a rounding
  boundary), scales and biases within 2 float32 ulps; the calibrated
  activation scales within 1e-5 relative (the calibration maxima come out
  of convolutions summed in another order, up to 17 blocks deep).
- one quantized 1×1 conv on the same input and scales: within 1e-6 of
  max |ref| (the s8×s8→s32 product is exact on both sides).
- ``int8w`` logits: within 1e-4 of max |ref| in float32; in bfloat16 no
  farther from the reference's bfloat16 logits than those are from its
  float32 ones.
- ``int8`` logits: an activation that lands within a float32 ulp of a
  rounding boundary (x / scale = n + 0.5) may round to the other side in
  one framework: one activation quantum. The quantization points agree
  exactly up to the first such flip, which is one quantum at under 0.1 %
  of the activations. Past it the random-weight network amplifies the
  difference: the reference's own logits move by up to 5 % of max |logit|
  when its stem bias is nudged by 1e-6 (pinned below). So the logits are
  held to 10 % of max |ref|, with the top-1 class equal; the
  ``filter_int8`` golden is held the same way.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nnstreamer_tpu.models import mobilenet_v2 as jmb
from nnstreamer_tpu.models import quantize as jq
from nnstreamer_tpu_torch import cli
from nnstreamer_tpu_torch.models import quantize as tq
from nnstreamer_tpu_torch.models import zoo as tzoo
from nnstreamer_tpu_torch.models.mobilenet_v2 import MobileNetV2, load_jax_npz
from nnstreamer_tpu_torch.models.nn import nhwc

from test_golden import GOLDEN_DIR, PIPELINES

SIZE, CLASSES = 96, 16
OPTS = {"size": str(SIZE), "num_classes": str(CLASSES)}
INT8_REL = 0.10  # of max |logit|: quantum flips (see the module docstring)


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference zoo's seed-0 MobileNet-v2 (16 classes) float tree, its
    npz, and its int8 / int8w trees as the reference zoo builds them."""
    params = jmb.init_params(jax.random.PRNGKey(0), num_classes=CLASSES)
    path = tmp_path_factory.mktemp("weights") / "mobilenet16.npz"
    leaves = jax.tree_util.tree_leaves(params)
    np.savez(path, **{f"p{i}": np.asarray(v) for i, v in enumerate(leaves)})
    folded = jq.fold_mobilenet(params)
    calib = [jnp.asarray(c) for c in tq.calibration_batches(0, 2, 1, SIZE)]
    return {
        "params": params, "npz": str(path), "folded": folded,
        "int8": jq.quantize_mobilenet(folded, jq.calibrate_mobilenet(folded, calib)),
        "int8w": jq.quantize_mobilenet_weights(folded),
    }


def port(ref, quantize, dtype="float32"):
    return tzoo.get("mobilenet_v2", device="cpu", params=ref["npz"], quantize=quantize,
                    compute_dtype=dtype, **OPTS).module


def image(seed, n=1):
    return np.random.default_rng(seed).integers(0, 256, (n, SIZE, SIZE, 3)).astype(np.uint8)


def _quantized_convs(ref_q, model):
    """(reference 1×1 conv dict, port module) pairs in tap order."""
    pairs = []
    for blk, expand, project in zip(ref_q["blocks"], model.expands, model.projects):
        if "expand" in blk:
            pairs.append((blk["expand"], expand))
        pairs.append((blk["project"], project))
    return pairs + [(ref_q["head"], model.head)]


@pytest.mark.parametrize("quantize", ["int8", "int8w"])
def test_quantized_weights_match_reference(ref, quantize):
    model = port(ref, quantize)
    pairs = _quantized_convs(ref[quantize], model)
    assert len(pairs) == 34
    for qc, m in pairs:
        d = np.abs(m.w8.numpy().astype(np.int32) - np.asarray(qc["w8"], np.int32))
        assert d.max() <= 1 and (d > 0).mean() < 1e-3
        np.testing.assert_allclose(m.wscale.numpy(), np.asarray(qc["wscale"]), rtol=2.4e-7)
        assert m.w8.dtype == torch.int8 and m.w8.shape == qc["w8"].shape
        assert _err(m.b, qc["b"]) <= 2.4e-7 * max(1.0, float(np.abs(qc["b"]).max()))
        if quantize == "int8":
            assert abs(float(m.ascale) / float(qc["ascale"]) - 1) <= 1e-5
        else:
            assert m.ascale is None and "ascale" not in qc


def test_quantized_conv_matches_reference(ref):
    """One calibrated 1×1 conv, the same float input and the same scales:
    quantize, the exact s8×s8→s32 product, dequantize."""
    qc = ref["int8"]["blocks"][3]["expand"]
    x = np.random.default_rng(3).standard_normal((2, 6, 5, qc["w8"].shape[0])).astype(np.float32)
    folded = (torch.from_numpy(np.ascontiguousarray(np.asarray(qc["w8"]).T[:, :, None, None]))
              .float(), torch.from_numpy(np.array(qc["b"])))
    conv = tq._Conv1x1Q(folded, torch.tensor(float(qc["ascale"])))
    conv.w8.copy_(torch.from_numpy(np.array(qc["w8"])))
    conv.wscale.copy_(torch.from_numpy(np.array(qc["wscale"])))
    got = conv(torch.from_numpy(x).permute(0, 3, 1, 2))
    want = np.asarray(jq._q_conv1x1(jnp.asarray(x), qc))
    assert _err(nhwc(got).numpy(), want) <= 1e-6 * float(np.abs(want).max())


def test_int8_matmul_is_exact_on_the_cpu():
    """The CPU product (CUDA takes ``torch._int_mm``, checked on the card
    by chip_smoke.py at 9 rows, the last convs' M at size 96)."""
    rng = np.random.default_rng(4)
    for m, k, n in ((9, 320, 1280), (1, 8, 8), (40, 24, 16)):
        a = rng.integers(-127, 128, (m, k)).astype(np.int8)
        b = rng.integers(-127, 128, (k, n)).astype(np.int8)
        got = tq.int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64))


def test_int8_activations_differ_from_one_quantum_flip(ref, monkeypatch):
    """Each quantization point's int8 activations, the reference's (its
    eager forward, recorded) against the port's: equal up to the first
    point that differs, which differs by one quantum at under 0.1 % of its
    activations; then the logits."""
    x = image(5)
    taps_ref, taps_port = [], []
    original = jq._q_conv1x1

    def recording(xx, qc):
        q = jnp.clip(jnp.round(xx.astype(jnp.float32) / qc["ascale"]), -127, 127)
        taps_ref.append(np.asarray(q, np.int32).reshape(-1, xx.shape[-1]))
        return original(xx, qc)

    monkeypatch.setattr(jq, "_q_conv1x1", recording)
    want = np.asarray(jq.apply_int8(ref["int8"], jnp.asarray(x)))
    model = port(ref, "int8")

    def hook(m, args):
        xs = nhwc(args[0]).reshape(-1, args[0].shape[1]).to(torch.float32)
        taps_port.append(torch.clamp(torch.round(xs / m.ascale), -127, 127).to(torch.int32).numpy())

    for _, m in _quantized_convs(ref["int8"], model):
        m.register_forward_pre_hook(hook)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert len(taps_ref) == len(taps_port) == 34
    diffs = [np.abs(a - b) for a, b in zip(taps_port, taps_ref)]
    first = next(i for i, d in enumerate(diffs) if d.any())
    assert first >= 1 and diffs[first].max() == 1 and (diffs[first] > 0).mean() < 1e-3
    assert _err(got, want) <= INT8_REL * float(np.abs(want).max())
    assert got.argmax() == want.argmax()


def test_int8_reference_moves_as_much_under_a_nudge(ref):
    """The reason for the int8 logit tolerance: the reference itself, its
    stem bias nudged by 1e-6 or 3e-7, moves its logits by over 2 % of max
    |logit| on this input (a float32 ulp of difference grows through the
    int8 layers of a random-weight network)."""
    x = jnp.asarray(image(0))
    q, apply = ref["int8"], jax.jit(jq.apply_int8)
    base = np.asarray(apply(q, x))
    moved = max(_err(apply(dict(q, stem={"w": q["stem"]["w"], "b": q["stem"]["b"] + d}), x),
                     base) for d in (1e-6, -1e-6, 3e-7))
    assert moved > 0.02 * float(np.abs(base).max())


@pytest.mark.parametrize("quantize", ["int8", "int8w"])
def test_logits_match_reference(ref, quantize):
    x = image(6, n=1)
    apply = jq.apply_int8 if quantize == "int8" else jq.apply_int8w
    outs = {}
    for dtype in ("float32", "bfloat16"):
        jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
        want = np.asarray(jax.jit(lambda p, x: apply(p, x, compute_dtype=jdt))(
            ref[quantize], jnp.asarray(x)))
        with torch.inference_mode():
            got = port(ref, quantize, dtype)(torch.from_numpy(x)).numpy()
        assert got.shape == want.shape == (1, CLASSES) and got.dtype == np.float32
        outs[dtype] = (got, want)
    (g32, w32), (g16, w16) = outs["float32"], outs["bfloat16"]
    if quantize == "int8w":
        assert _err(g32, w32) <= 1e-4 * float(np.abs(w32).max())
        assert _err(g16, w16) <= _err(w16, w32)
    else:
        assert _err(g32, w32) <= INT8_REL * float(np.abs(w32).max())
        assert _err(g16, w16) <= max(_err(w16, w32), INT8_REL * float(np.abs(w16).max()))


def test_calibration_uses_the_reference_batches(ref):
    """The zoo's calibration batches are the reference zoo's numpy draws,
    and ``calib_batches`` sets their count."""
    rng = np.random.default_rng(0)
    want = [rng.integers(0, 256, (1, SIZE, SIZE, 3), np.uint8) for _ in range(3)]
    for a, b in zip(tq.calibration_batches(0, 3, 1, SIZE), want):
        np.testing.assert_array_equal(a, b)
    m = MobileNetV2(num_classes=CLASSES)
    load_jax_npz(m, ref["npz"])
    folded = tq.fold_mobilenet(m.eval())
    one = tq.calibrate_mobilenet(folded, [torch.from_numpy(want[0])])
    three = tq.calibrate_mobilenet(folded, [torch.from_numpy(w) for w in want])
    assert one.shape == three.shape == (34,) and (three >= one).all()
    with pytest.raises(ValueError):
        tq.calibrate_mobilenet(folded, [])


def test_golden_filter_int8(ref, tmp_path):
    desc = PIPELINES["filter_int8"].replace(
        'num_classes:16"', f'num_classes:16,params:{ref["npz"]}"')
    assert ref["npz"] in desc
    out = tmp_path / "dump.raw"
    assert cli.main(["--device", "cpu", "-q", desc.format(out=out)]) == 0
    with open(f"{GOLDEN_DIR}/filter_int8.raw", "rb") as f:
        want = np.frombuffer(f.read(), np.float32).reshape(2, CLASSES)
    got = np.frombuffer(out.read_bytes(), np.float32).reshape(2, CLASSES)
    assert _err(got, want) <= INT8_REL * float(np.abs(want).max())
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
