"""Port parity: the K1 crop/resize kernel's plain PyTorch version (the path
a CPU tensor takes through nnstreamer_tpu_torch.ops) against the JAX
package's jnp reference and its Pallas kernel in interpret mode, on the
kernel registry's tier-1 shape cases.

Tolerance: ``interp_atol`` (the JAX package's ``_interp_atol`` formula):
1 for integer outputs, else max(1e-4, 8·max(h, w)·2⁻²³). The port and the
jnp reference use the same floor-and-clip arithmetic, so most cases agree
exactly; the Pallas kernel's matrix form rounds differently.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nnstreamer_tpu.ops import image as jimage
from nnstreamer_tpu.ops.pallas import image_kernels as jkernels
from nnstreamer_tpu.ops.pallas import registry as kernel_registry
from nnstreamer_tpu_torch.ops import image as timage
from nnstreamer_tpu_torch.ops.kernels import image_kernels as tkernels

_TORCH = {"float32": torch.float32, "uint8": torch.uint8, "bfloat16": torch.bfloat16}
_JNP = {"float32": jnp.float32, "uint8": jnp.uint8, "bfloat16": jnp.bfloat16}


def _image(rng, shape, dtype):
    if dtype == "uint8":
        return rng.integers(0, 256, shape).astype(np.uint8)
    return rng.standard_normal(shape).astype(np.float32)


def _both(a, dtype):
    """numpy → (jax array, torch tensor) of ``dtype``."""
    return jnp.asarray(a, _JNP[dtype]), torch.from_numpy(a).to(_TORCH[dtype])


def _boxes(rng, n, h, w):
    x1 = rng.uniform(0, w - 1, n)
    y1 = rng.uniform(0, h - 1, n)
    x2 = x1 + rng.uniform(1.0, np.maximum(1.5, w - x1))
    y2 = y1 + rng.uniform(1.0, np.maximum(1.5, h - y1))
    return np.stack([x1, y1, x2, y2], -1).astype(np.float32)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _crop_cases():
    spec = kernel_registry.get("crop_and_resize")
    return [pytest.param(c.params, id=c.name) for c in spec.tier1_cases()]


def _resize_cases():
    spec = kernel_registry.get("resize_bilinear")
    return [
        pytest.param(dict(c.params, dtype=dt), id=f"{c.name}-{dt}")
        for c in spec.tier1_cases()
        for dt in ("float32", "uint8", "bfloat16")
    ]


@pytest.mark.parametrize("params", _crop_cases())
def test_crop_matches_jax(params):
    rng = np.random.default_rng(5)
    n = params.get("n", 4)
    h, w, c = params.get("h", 32), params.get("w", 48), params.get("c", 3)
    oh, ow = params.get("out_h", 8), params.get("out_w", 8)
    dtype = params.get("dtype", "float32")
    scale, offset = params.get("scale"), params.get("offset")
    jimg, timg = _both(_image(rng, (h, w, c), dtype), dtype)
    boxes = _boxes(rng, n, h, w)
    got = tkernels.crop_and_resize(
        timg, torch.from_numpy(boxes), oh, ow, scale=scale, offset=offset
    )
    want = jimage.crop_and_resize(
        jimg.astype(jnp.float32), jnp.asarray(boxes), oh, ow, impl="jnp"
    )
    if scale is not None:
        want = want * scale
    if offset is not None:
        want = want + offset
    if scale is None and offset is None:
        want = jimage._round_clip_cast(want, _JNP[dtype])
    pallas = jkernels.crop_and_resize(
        jimg, jnp.asarray(boxes), oh, ow, scale=scale, offset=offset,
        interpret=True,
    )
    assert got.shape == (n, oh, ow, c)
    assert np.dtype(str(got.dtype).removeprefix("torch.")) == np.dtype(pallas.dtype)
    atol = tkernels.interp_atol(got.dtype, h, w)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=0, atol=atol)
    np.testing.assert_allclose(_f32(got), _f32(pallas), rtol=0, atol=atol)


@pytest.mark.parametrize("params", _resize_cases())
def test_resize_matches_jax(params):
    rng = np.random.default_rng(6)
    n = params.get("n", 2)
    h, w, c = params.get("h", 17), params.get("w", 23), params.get("c", 3)
    oh, ow = params.get("out_h", 8), params.get("out_w", 8)
    dtype = params["dtype"]
    jimg, timg = _both(_image(rng, (n, h, w, c), dtype), dtype)
    got = timage.resize_bilinear(timg, oh, ow)
    want = jimage.resize_bilinear(jimg, oh, ow, impl="jnp")
    pallas = jkernels.resize_bilinear(jimg, oh, ow, interpret=True)
    assert got.shape == (n, oh, ow, c) and got.dtype == _TORCH[dtype]
    atol = tkernels.interp_atol(got.dtype, h, w)
    # same arithmetic as the jnp reference: bit-identical
    np.testing.assert_array_equal(_f32(got), _f32(want))
    np.testing.assert_allclose(_f32(got), _f32(pallas), rtol=0, atol=atol)
    # the rank-3 entry squeezes the batch back out
    one = timage.resize_bilinear(timg[0], oh, ow)
    np.testing.assert_array_equal(_f32(one), _f32(got[0]))


def test_resize_normalize_epilogue():
    """The fused ``·scale + offset`` epilogue (uint8 in, float32 out)
    equals normalizing the reference's float resize."""
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (1, 12, 20, 3)).astype(np.uint8)
    got = tkernels.resize_bilinear(
        torch.from_numpy(img), 7, 9, scale=1 / 255, offset=-0.5
    )
    want = jkernels.resize_bilinear(
        jnp.asarray(img), 7, 9, scale=1 / 255, offset=-0.5, interpret=True
    )
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_crop_edge_boxes():
    """Full-image, subpixel, out-of-range and degenerate boxes."""
    rng = np.random.default_rng(0)
    img = rng.standard_normal((16, 12, 3)).astype(np.float32)
    boxes = np.array(
        [[0, 0, 12, 16], [2.5, 3.5, 9.5, 12.5], [-4, -2, 30, 40], [5, 5, 5, 5]],
        np.float32,
    )
    got = timage.crop_and_resize(torch.from_numpy(img), torch.from_numpy(boxes), 8, 6)
    want = jimage.crop_and_resize(jnp.asarray(img), jnp.asarray(boxes), 8, 6, impl="jnp")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_crop_regions_zeroes_invalid_and_rounds():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (20, 24, 3)).astype(np.uint8)
    boxes = _boxes(rng, 5, 20, 24)
    valid = np.array([True, False, True, True, False])
    got = timage.crop_regions(
        torch.from_numpy(img), torch.from_numpy(boxes), 6, 7,
        valid=torch.from_numpy(valid),
    )
    want = jimage.crop_regions(
        jnp.asarray(img), jnp.asarray(boxes), 6, 7, valid=jnp.asarray(valid),
        impl="jnp",
    )
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got.numpy()[~valid].any()


def test_uint8_rounds_half_to_even():
    """Samples landing exactly halfway: 2.5 → 2 and 1.5 → 2 (round half
    to even, as jnp.round), where round-half-away would give 3 and 2."""
    img = np.array([[[2], [3]], [[1], [2]]], np.uint8)  # 2x2x1
    got = timage.resize_bilinear(torch.from_numpy(img), 2, 1).numpy().ravel()
    want = np.asarray(
        jimage.resize_bilinear(jnp.asarray(img), 2, 1, impl="jnp")
    ).ravel()
    np.testing.assert_array_equal(got, [2, 2])
    np.testing.assert_array_equal(got, want)


def test_rejects_what_the_kernel_does_not_take():
    img = torch.zeros((4, 4, 3), dtype=torch.int32)
    with pytest.raises(TypeError):
        timage.resize_bilinear(img, 2, 2)
    with pytest.raises(ValueError):
        timage.resize_bilinear(torch.zeros((4, 4), dtype=torch.uint8), 2, 2)
    with pytest.raises(ValueError):
        tkernels.crop_and_resize(
            torch.zeros((4, 4, 3)), torch.zeros((2, 3)), 2, 2
        )


def _crop_boxes(fmt, rng):
    if fmt == "xywh-int":
        return np.array([[2, 3, 10, 8], [0, 0, 0, 5], [5, 1, 12, 14]], np.int32)
    if fmt == "xyxy-float":
        return np.array([[1.5, 2.0, 20.0, 15.5], [0, 0, 24, 18]], np.float32)
    det = rng.uniform(0, 1, (3, 7 if fmt == "ov" else 6)).astype(np.float32)
    det[1, 2 if fmt == "ov" else 5] = 0.0  # one row below threshold
    return det


@pytest.mark.parametrize("fmt", ["xywh-int", "xyxy-float", "detections", "ov"])
def test_crop_resize_element_matches_jax(fmt):
    """tensor_transform mode=crop-resize on (image, boxes) frames in every
    box format, against the JAX element's fn (same option, same inputs)."""
    from nnstreamer_tpu.elements.transform import TensorTransform as JT
    from nnstreamer_tpu.tensors.spec import TensorsSpec as JSpec
    from nnstreamer_tpu_torch.elements.transform import TensorTransform as TT
    from nnstreamer_tpu_torch.tensors.spec import TensorsSpec as TSpec

    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, (1, 18, 24, 3)).astype(np.uint8)
    boxes = _crop_boxes(fmt, rng)
    outs = []
    for cls, spec_cls, conv in (
        (JT, JSpec, jnp.asarray), (TT, TSpec, torch.from_numpy),
    ):
        e = cls(mode="crop-resize", option="6:5")
        (out_spec,) = e.fix_negotiation([spec_cls.from_arrays([img, boxes])])
        (got,) = e.make_fn()((conv(img), conv(boxes)))
        assert tuple(got.shape) == out_spec[0].shape == (len(boxes), 6, 5, 3)
        outs.append(np.asarray(got))
    assert outs[1].dtype == np.uint8
    np.testing.assert_array_equal(outs[1], outs[0])
