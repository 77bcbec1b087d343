"""The bitmask design of the port's NMS kernel (K2) and its launch plan, on
the CPU.

``plain_nms_bitmask`` is the plain twin of ``csrc/nms.cu``: a mask pass of
64-bit IoU words, then the scan over word blocks. Its alive mask must be
bit-identical to ``plain_nms_mask`` (the plain version the wrapper takes on
the CPU) for any input, and through the port's ranking and packing to the
JAX package's ``detection.nms(impl="jnp")`` and its Pallas kernel in
interpret mode. Tolerance: none, every comparison is exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nnstreamer_tpu.ops import detection as jdet
from nnstreamer_tpu.ops.pallas.nms import _boxes_scores as registry_boxes_scores
from nnstreamer_tpu.ops.pallas.nms import nms as pallas_nms
from nnstreamer_tpu_torch.ops import detection as tdet
from nnstreamer_tpu_torch.ops.kernels import nms as tnms

THR = 0.5


def _random_case(n, seed, zero_below=0.3, spread=1.0):
    rng = np.random.default_rng(seed)
    boxes = rng.random((n, 4)).astype(np.float32)
    boxes[:, 2:] = boxes[:, :2] + (spread * rng.random((n, 2))).astype(np.float32)
    scores = rng.random(n).astype(np.float32)
    scores[scores < zero_below] = 0.0
    return boxes, scores


def _ranked(boxes, scores):
    order, sboxes, sscores = tdet.rank(torch.from_numpy(boxes), torch.from_numpy(scores))
    return order, sboxes, sscores


def _word_bits(words):
    """int64 [w] → bool [64·w]. ``>>`` on a negative int64 is arithmetic,
    so each bit is masked with ``& 1`` after the shift."""
    return ((words[:, None] >> torch.arange(64)) & 1).bool().flatten()


def _cases():
    cases = []
    for n in (0, 1, 63, 64, 65, 127, 129, 200):
        cases.append(pytest.param(*_random_case(n, 10 + n, spread=0.5), id=f"random-n{n}"))
    for name, params in (("registry-n32", {"n": 32}), ("registry-n100", {"n": 100})):
        boxes, scores = registry_boxes_scores(params)
        cases.append(pytest.param(np.array(boxes), np.array(scores), id=name))
    boxes, scores = _random_case(64, 1, zero_below=0.0)
    scores[40:] = 0.0
    cases.append(pytest.param(boxes, scores, id="zero-score-tail"))
    boxes, _ = _random_case(48, 2)
    ties = np.repeat(np.float32([0.9, 0.6, 0.3, 0.0]), 12)
    cases.append(pytest.param(boxes, ties, id="exact-ties"))
    boxes, scores = _random_case(32, 3, zero_below=0.0)
    boxes[::3, 2] = boxes[::3, 0]  # zero width
    boxes[1::4, 3] = boxes[1::4, 1]  # zero height
    cases.append(pytest.param(boxes, scores, id="degenerate-boxes"))
    # IoU exactly thr (inter 1, union 2: kept, since suppression needs > thr),
    # then just above it (suppressed)
    boxes = np.float32([[0, 0, 2, 1], [0, 0, 1, 1], [5, 5, 7, 6], [5, 5, 6.01, 6]])
    cases.append(pytest.param(boxes, np.float32([0.9, 0.8, 0.7, 0.6]), id="iou-equals-thr"))
    return cases


@pytest.mark.parametrize("boxes,scores", _cases())
def test_bitmask_twin_matches_plain_and_reference(boxes, scores):
    order, sboxes, sscores = _ranked(boxes, scores)
    words, alive = tnms.plain_nms_bitmask(sboxes, sscores, THR)
    n = boxes.shape[0]
    assert words.shape == (n, tnms.nms_plan(n).words) and words.dtype == torch.int64
    assert torch.equal(alive, tnms.plain_nms_mask(sboxes, sscores, THR))
    max_out = max(n, 1)
    idx, sc = tdet.pack_kept(order, sscores, alive, max_out)
    refs = [pallas_nms(jnp.asarray(boxes), jnp.asarray(scores), THR, max_out, interpret=True)]
    if n:  # the jnp reference indexes row 0 and cannot take no candidates
        refs.append(jdet.nms(jnp.asarray(boxes), jnp.asarray(scores), THR, max_out, impl="jnp"))
    for ref in refs:
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(sc.numpy(), np.asarray(ref[1]))


def test_iou_equal_to_thr_keeps_its_box():
    boxes = np.float32([[0, 0, 2, 1], [0, 0, 1, 1], [5, 5, 7, 6], [5, 5, 6.01, 6]])
    _, sboxes, sscores = _ranked(boxes, np.float32([0.9, 0.8, 0.7, 0.6]))
    assert tnms.plain_nms_bitmask(sboxes, sscores, THR)[1].tolist() == [True, True, True, False]


def _unranked_cases():
    """Dead candidates inside the live prefix: the mask functions take the
    order they are given, ranked or not."""
    boxes, scores = _random_case(200, 21, zero_below=0.0, spread=0.5)
    scores[64:128] = 0.0  # a whole word block dead, live blocks on both sides
    yield pytest.param(boxes, scores, id="all-dead-word-block")
    boxes, scores = _random_case(150, 22, zero_below=0.0, spread=0.5)
    scores[[3, 40, 63, 64, 100, 149]] = 0.0
    yield pytest.param(boxes, scores, id="dead-in-the-middle")
    boxes, scores = _random_case(130, 23, zero_below=0.5, spread=0.5)
    yield pytest.param(boxes, scores, id="unranked-half-dead")


@pytest.mark.parametrize("boxes,scores", _unranked_cases())
def test_bitmask_twin_on_unranked_inputs(boxes, scores):
    b, s = torch.from_numpy(boxes), torch.from_numpy(scores)
    _, alive = tnms.plain_nms_bitmask(b, s, THR)
    assert torch.equal(alive, tnms.plain_nms_mask(b, s, THR))
    assert not alive[s <= 0].any()


def test_bitmask_words_match_reference_iou_matrix():
    """Bit k of words[i, c] is IoU(i, 64c + k) > thr for 64c + k > i, zero
    elsewhere: the JAX package's iou_matrix on inputs with no IoU within
    1e-5 of thr (the two frameworks may round a division apart)."""
    boxes, scores = _random_case(150, 31, spread=0.5)
    iou = np.asarray(jdet.iou_matrix(jnp.asarray(boxes)))
    assert np.abs(iou - np.float32(THR)).min() > 1e-5
    words, _ = tnms.plain_nms_bitmask(torch.from_numpy(boxes), torch.from_numpy(scores), THR)
    bits = np.stack([_word_bits(w).numpy() for w in words])[:, :150]
    want = (iou > THR) & np.triu(np.ones((150, 150), bool), 1)
    np.testing.assert_array_equal(bits, want)


def test_bitmask_sign_bit_of_a_word():
    """Column 63 is the sign bit of an int64 word: box 63 equal to box 0
    sets it in row 0, and the scan suppresses box 63."""
    boxes, _ = _random_case(65, 41, spread=0.05)
    boxes[63] = boxes[0]
    scores = np.linspace(1.0, 0.5, 65).astype(np.float32)
    b, s = torch.from_numpy(boxes), torch.from_numpy(scores)
    words, alive = tnms.plain_nms_bitmask(b, s, THR)
    assert int(words[0, 0]) < 0 and bool(_word_bits(words[0])[63])
    assert not alive[63] and alive[0]
    assert torch.equal(alive, tnms.plain_nms_mask(b, s, THR))


@pytest.mark.parametrize("n,words,tiles,nbytes", [
    (1, 1, 1, 8), (64, 1, 1, 512), (65, 2, 3, 1040),
    (1917, 30, 465, 460_080), (25_200, 394, 77_815, 79_430_400),
    (32_768, 512, 131_328, 134_217_728),
])
def test_nms_plan(n, words, tiles, nbytes):
    assert tnms.nms_plan(n) == (words, tiles, nbytes)


def test_nms_kernel_refuses_a_bad_workspace_before_a_build():
    before = tnms.nms_launches.count
    with pytest.raises(ValueError, match="workspace"):
        tnms._cuda_nms(torch.zeros((70, 4)), torch.ones(70), THR,
                       words=torch.empty((70, 1), dtype=torch.int64))
    assert tnms.nms_launches.count == before
