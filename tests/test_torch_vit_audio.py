"""Port parity for the last two zoo families: ``zoo:vit`` (a ViT encoder
classifier) and ``zoo:kws`` (an M5-style raw-waveform keyword spotter),
against the JAX package on the reference's own weights (``params:``
npz, leaves ``p{i}`` in tree-flatten order), and both behind the
pipeline elements the port already has.

Tolerances:

- float32 logits: within 1e-4 of max(1, max |ref logit|): another
  summation order through the encoder's matmuls and softmax (ViT), or
  through the 80-tap stem and three convs (kws).
- labels through the pipelines: equal.
- bfloat16: finite, and no farther from the reference's float32 logits
  than 5e-2 of max |logit| (8 significant bits through the stack).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nnstreamer_tpu.models import audio as jaudio
from nnstreamer_tpu.models import vit as jvit
from nnstreamer_tpu.models import zoo as jzoo
from nnstreamer_tpu.pipeline.parse import parse_pipeline as jax_parse
from nnstreamer_tpu_torch.backends.base import BackendError
from nnstreamer_tpu_torch.models import vit as tvit
from nnstreamer_tpu_torch.models import zoo as tzoo
from nnstreamer_tpu_torch.pipeline.parse import parse_pipeline
from nnstreamer_tpu_torch.single import SingleShot

VIT_SMALL = dict(size="64", patch="16", d_model="64", n_heads="4", n_layers="2",
                 num_classes="10")
KWS_SMALL = dict(samples="1024", num_classes="5", width="16")
TOL = 1e-4


def save_npz(tree, path):
    leaves = jax.tree_util.tree_leaves(tree)
    np.savez(path, **{f"p{i}": np.asarray(v) for i, v in enumerate(leaves)})
    return str(path)


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def _scale(ref):
    return max(1.0, float(np.abs(np.asarray(ref)).max()))


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The reference zoo's seed-1 trees at the small sizes, as npz files.
    The kws tree gets non-trivial batch-norm moments, so the port's
    batch norm is held to the reference's formula, not only to identity."""
    d = tmp_path_factory.mktemp("weights")
    vit_tree = jzoo.get("vit", seed="1", **VIT_SMALL).params
    kws_tree = jzoo.get("kws", seed="1", **KWS_SMALL).params
    rng = np.random.default_rng(5)
    kws_tree = jax.tree_util.tree_map(np.asarray, kws_tree)
    for name in ("stem", "c2", "c3", "c4"):
        bn = kws_tree[name]["bn"]
        c = bn["scale"].shape[0]
        bn["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        bn["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
        bn["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
    kws_tree["head"]["b"] = rng.normal(0, 0.1, kws_tree["head"]["b"].shape).astype(np.float32)
    vit_tree = jax.tree_util.tree_map(np.asarray, vit_tree)
    vit_tree["head"]["b"] = rng.normal(0, 0.1, vit_tree["head"]["b"].shape).astype(np.float32)
    vit_tree["patch"]["b"] = rng.normal(0, 0.1, vit_tree["patch"]["b"].shape).astype(np.float32)
    return {"vit": (vit_tree, save_npz(vit_tree, d / "vit.npz")),
            "kws": (kws_tree, save_npz(kws_tree, d / "kws.npz"))}


def _image(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


def _pcm(shape, seed):
    return np.random.default_rng(seed).integers(-(2 ** 15), 2 ** 15, shape).astype(np.int16)


def test_vit_logits_match_reference(weights):
    tree, npz = weights["vit"]
    x = _image((2, 64, 64, 3), 0)
    ref = np.asarray(jax.jit(lambda p, x: jvit.apply(p, x, 4))(tree, x))
    m = tzoo.get("vit", device="cpu", params=npz, batch="2", **VIT_SMALL)
    with torch.no_grad():
        got = m.module(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 10)
    assert _err(got, ref) <= TOL * _scale(ref)
    assert (got.argmax(-1) == ref.argmax(-1)).all()


def test_vit_sincos_table_matches_reference():
    for grid, d in ((4, 64), (14, 384)):
        np.testing.assert_array_equal(tvit.sincos_2d(grid, d),
                                      np.asarray(jvit.sincos_2d(grid, d)))


def test_vit_float_input_and_bf16(weights):
    tree, npz = weights["vit"]
    x = np.random.default_rng(2).uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(jvit.apply(tree, jnp.asarray(x), 4))
    f32 = tzoo.get("vit", device="cpu", params=npz, input_dtype="float32", **VIT_SMALL)
    bf16 = tzoo.get("vit", device="cpu", params=npz, input_dtype="float32",
                    compute_dtype="bfloat16", **VIT_SMALL)
    with torch.no_grad():
        got = f32.module(torch.from_numpy(x)).numpy()
        low = bf16.module(torch.from_numpy(x))
    assert f32.input_spec[0].dtype.value == "float32"
    assert _err(got, ref) <= TOL * _scale(ref)
    assert low.dtype == torch.float32 and torch.isfinite(low).all()
    assert _err(low.numpy(), ref) <= 5e-2 * _scale(ref)


def test_vit_size_must_divide_by_patch():
    with pytest.raises(ValueError, match="not divisible"):
        tzoo.get("vit", device="cpu", size="65", patch="16")
    with pytest.raises(ValueError):
        jzoo.get("vit", size="65", patch="16")
    with pytest.raises(BackendError, match="not divisible"):
        SingleShot(framework="torch", model="zoo:vit", custom="size:40,patch:16",
                   device="cpu").open()


def test_vit_default_is_vit_s16():
    m = tzoo.get("vit", device="cpu", n_layers="1")
    assert tuple(m.input_spec[0].shape) == (1, 224, 224, 3)
    assert m.module.patch.weight.shape == (384, 3, 16, 16)
    assert m.module.pos.shape == (196, 384)
    assert m.module.head.weight.shape == (1001, 384)
    assert m.module.n_heads == 6 and len(m.module.blocks) == 1


def test_kws_logits_match_reference(weights):
    tree, npz = weights["kws"]
    x = _pcm((1024, 1), 3)
    ref = np.asarray(jax.jit(jaudio.apply)(tree, jnp.asarray(x)))
    m = tzoo.get("kws", device="cpu", params=npz, **KWS_SMALL)
    with torch.no_grad():
        got = m.module(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (1, 5)
    assert _err(got, ref) <= TOL * _scale(ref)
    # int16 was normalized (raw magnitudes would blow the logits up ~3e4)
    assert np.abs(got).max() < 1e3


@pytest.mark.parametrize("case", ["stereo", "batched", "short", "float"])
def test_kws_input_rules_match_reference(weights, case):
    tree, npz = weights["kws"]
    x = {
        "stereo": _pcm((1024, 2), 4),
        "batched": _pcm((3, 1024, 1), 5),
        # 200 samples: the stem leaves 13 steps, c2 3 (< the pool of 4,
        # which is skipped), c3 and c4 keep 3
        "short": _pcm((200, 1), 6),
        "float": np.random.default_rng(7).uniform(-1, 1, (1024, 1)).astype(np.float32),
    }[case]
    ref = np.asarray(jaudio.apply(tree, jnp.asarray(x)))
    m = tzoo.get("kws", device="cpu", params=npz, **KWS_SMALL)
    with torch.no_grad():
        got = m.module(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    assert _err(got, ref) <= TOL * _scale(ref)


def test_kws_stereo_is_the_mono_mean(weights):
    _, npz = weights["kws"]
    st = _pcm((512, 2), 8)
    mono = st.astype(np.float32).mean(axis=-1, keepdims=True) / 32768.0
    m = tzoo.get("kws", device="cpu", params=npz, **KWS_SMALL)
    with torch.no_grad():
        a = m.module(torch.from_numpy(st))
        b = m.module(torch.from_numpy(mono))
    torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_kws_bf16_finite_and_specs():
    m = tzoo.get("kws", device="cpu", samples="512", num_classes="3", width="16",
                 compute_dtype="bfloat16")
    with torch.no_grad():
        out = m.module(torch.zeros((512, 1), dtype=torch.int16))
    assert out.shape == (1, 3) and out.dtype == torch.float32 and torch.isfinite(out).all()
    assert tuple(m.input_spec[0].shape) == (512, 1)
    assert m.input_spec[0].dtype.value == "int16"
    batched = tzoo.get("kws", device="cpu", batch="4", channels="2")
    assert tuple(batched.input_spec[0].shape) == (4, 1024, 2)
    with pytest.raises(ValueError, match="unsupported option"):
        tzoo.get("kws", device="cpu", size="3")


def _labels(p):
    p.run(timeout=300)
    return [int(np.asarray(f.tensors[0]).reshape(-1)[0]) for f in p["out"].frames]


def _labels_jax(desc):
    return _labels(jax_parse(desc))


def _labels_port(desc):
    return _labels(parse_pipeline(desc, device="cpu"))


def test_kws_audio_pipeline_labels_match_reference(weights):
    _, npz = weights["kws"]
    desc = (
        "audiotestsrc samples-per-buffer=1024 num-buffers=3 channels=1 ! tensor_converter ! "
        "tensor_filter framework={fw} model=zoo:kws "
        f'custom="samples:1024,num_classes:5,width:16,params:{npz}" ! '
        "tensor_decoder mode=image_labeling ! tensor_sink name=out"
    )
    want = _labels_jax(desc.format(fw="jax"))
    got = _labels_port(desc.format(fw="torch"))
    assert len(got) == 3 and got == want


def test_vit_labeling_pipeline_labels_match_reference(weights):
    _, npz = weights["vit"]
    custom = ",".join(f"{k}:{v}" for k, v in VIT_SMALL.items()) + f",params:{npz}"
    desc = (
        "videotestsrc pattern=gradient width=160 height=120 num-frames=2 ! tensor_converter ! "
        "tensor_transform mode=resize option=64:64 ! "
        f'tensor_filter framework={{fw}} model=zoo:vit custom="{custom}" ! '
        "tensor_decoder mode=image_labeling ! tensor_sink name=out"
    )
    want = _labels_jax(desc.format(fw="jax"))
    got = _labels_port(desc.format(fw="torch"))
    assert len(got) == 2 and got == want
