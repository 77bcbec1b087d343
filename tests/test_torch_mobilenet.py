"""Port parity: MobileNet-v2 of nnstreamer_tpu_torch on weights carried
over from the JAX package (``mobilenet_v2_from_jax`` and the
``params:<npz>`` zoo option) against ``nnstreamer_tpu.models``.

Tolerance: float32 logits within 1e-4 relative to the largest logit
(XLA's and PyTorch's CPU convolutions sum in different orders, 17 blocks
deep), and an identical top-1 class. An even input (64) exercises the
asymmetric (0, 1) SAME padding of the stride-2 convs, odd inputs (63, 33)
the symmetric one.
"""

import numpy as np
import pytest
import torch

import jax

from nnstreamer_tpu.models import mobilenet_v2 as jmobilenet
from nnstreamer_tpu_torch.models import mobilenet_v2 as tmobilenet
from nnstreamer_tpu_torch.models import nn as tnn
from nnstreamer_tpu_torch.models import zoo as tzoo

NUM_CLASSES = 16
WIDTH = 0.5


@pytest.fixture(scope="module")
def jax_params():
    return jmobilenet.init_params(
        jax.random.PRNGKey(0), num_classes=NUM_CLASSES, width=WIDTH
    )


def _close(got, want):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("size", [64, 63])
def test_logits_match_jax(jax_params, size):
    rng = np.random.default_rng(size)
    x = rng.integers(0, 256, (2, size, size, 3)).astype(np.uint8)
    want = np.asarray(jax.jit(jmobilenet.apply)(jax_params, x))
    model = tmobilenet.MobileNetV2(num_classes=NUM_CLASSES, width=WIDTH)
    np_params = jax.tree_util.tree_map(np.asarray, jax_params)
    model.load_state_dict(tmobilenet.mobilenet_v2_from_jax(np_params))
    model = model.eval().to(memory_format=torch.channels_last)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (2, NUM_CLASSES) and got.dtype == np.float32
    _close(got, want)


def test_zoo_loads_jax_npz(jax_params, tmp_path):
    """``params:<npz>`` with leaves p{i} in JAX tree-flatten order — what a
    pipeline string uses to run the reference's weights."""
    leaves = jax.tree_util.tree_leaves(jax_params)
    assert len(leaves) == len(tmobilenet.jax_leaf_paths())
    path = tmp_path / "w.npz"
    np.savez(path, **{f"p{i}": np.asarray(v) for i, v in enumerate(leaves)})
    m = tzoo.get(
        "mobilenet_v2", device="cpu", size="33", num_classes=str(NUM_CLASSES),
        width=str(WIDTH), params=str(path),
    )
    assert m.input_spec[0].shape == (1, 33, 33, 3)
    x = np.random.default_rng(1).integers(0, 256, (1, 33, 33, 3)).astype(np.uint8)
    with torch.inference_mode():
        got = m.module(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jmobilenet.apply)(jax_params, x))
    _close(got, want)


def test_zoo_rejects_unknown_options():
    with pytest.raises(ValueError, match="quantize"):
        tzoo.get("mobilenet_v2", device="cpu", quantize="int8")


@pytest.mark.parametrize("n,k,stride,want", [
    (64, 3, 2, (0, 1)), (63, 3, 2, (1, 1)), (64, 3, 1, (1, 1)), (7, 1, 1, (0, 0)),
])
def test_same_padding_matches_tf(n, k, stride, want):
    assert tnn.same_padding(n, k, stride) == want
