"""Port parity through the user entry point: the port's CLI
(``nnstreamer_tpu_torch.cli`` with ``--device cpu``) reproduces the JAX
package's golden dumps byte for byte, its resize pipeline matches the JAX
CLI path, the image-labeling slice gives the JAX labels, and broken
pipelines fail with an ``nns-launch:`` diagnostic.

The label goldens were made with the JAX zoo's seeded weights; the port
runs those same weights through ``custom="...,params:<npz>"``.
"""

import numpy as np
import pytest
import torch

import jax

from nnstreamer_tpu.models import mobilenet_v2 as jmobilenet
from nnstreamer_tpu.pipeline.parse import parse_pipeline as jax_parse
from nnstreamer_tpu_torch import cli
from nnstreamer_tpu_torch.ops.kernels.image_kernels import interp_atol
from nnstreamer_tpu_torch.pipeline.parse import parse_pipeline

from test_golden import FAIL_PIPELINES, GOLDEN_DIR, PIPELINES

BYTE_GOLDENS = [
    "converter_video",
    "transform_arith",
    "transform_per_channel",
    "transform_clamp",
    "transform_stand",
    "transform_dimchg",
    "transform_transpose",
]
LABEL_GOLDENS = ["decoder_label", "decoder_label_fused"]


@pytest.fixture(scope="module")
def label_weights(tmp_path_factory):
    """The JAX zoo's mobilenet_v2 weights for the label goldens
    (seed 0, width 1.0, 16 classes) as a params npz."""
    params = jmobilenet.init_params(jax.random.PRNGKey(0), num_classes=16, width=1.0)
    path = tmp_path_factory.mktemp("weights") / "mobilenet_v2_16.npz"
    leaves = jax.tree_util.tree_leaves(params)
    np.savez(path, **{f"p{i}": np.asarray(v) for i, v in enumerate(leaves)})
    return str(path)


def _run_cli(description):
    return cli.main(["--device", "cpu", "-q", description])


@pytest.mark.parametrize("name", BYTE_GOLDENS + LABEL_GOLDENS)
def test_golden(name, tmp_path, request):
    desc = PIPELINES[name]
    if name in LABEL_GOLDENS:
        weights = request.getfixturevalue("label_weights")
        desc = desc.replace('num_classes:16"', f'num_classes:16,params:{weights}"')
        assert weights in desc
    out = tmp_path / "dump.raw"
    assert _run_cli(desc.format(out=out)) == 0
    with open(f"{GOLDEN_DIR}/{name}.raw", "rb") as f:
        want = f.read()
    assert out.read_bytes() == want


def _sink_tensors(pipeline, name="out"):
    return [f.tensors[0] for f in pipeline[name].frames]


@pytest.mark.parametrize("pre", ["", "tensor_transform mode=typecast option=float32 ! "])
def test_resize_pipeline_matches_jax(pre):
    desc = (
        "videotestsrc pattern=gradient width=64 height=48 num-frames=2 ! "
        f"tensor_converter ! {pre}tensor_transform mode=resize option=20:30 ! "
        "tensor_sink name=out"
    )
    port = parse_pipeline(desc, device="cpu")
    port.run(timeout=60)
    ref = jax_parse(desc)
    ref.run(timeout=60)
    got, want = _sink_tensors(port), [np.asarray(t) for t in _sink_tensors(ref)]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape == (1, 20, 30, 3) and g.dtype == w.dtype
        # XLA fuses the reference's arithmetic differently inside a
        # segment: the kernel tolerance (interp_atol) holds for floats
        atol = interp_atol(torch.from_numpy(g).dtype, 48, 64)
        np.testing.assert_allclose(
            g.astype(np.float32), w.astype(np.float32), rtol=0, atol=atol
        )


def test_labeling_slice_matches_jax(label_weights):
    """The slice end to end at a small size: 160x120 frames → resize →
    MobileNet-v2 (JAX weights) → image_labeling, labels as in JAX."""
    desc = (
        "videotestsrc pattern=gradient width=160 height=120 num-frames=3 ! "
        "tensor_converter ! tensor_transform mode=resize option=64:64 ! "
        "tensor_filter framework={fw} model=zoo:mobilenet_v2 "
        'custom="size:64,num_classes:16{extra}" ! '
        "tensor_decoder mode=image_labeling ! tensor_sink name=out"
    )
    port = parse_pipeline(
        desc.format(fw="torch", extra=f",params:{label_weights}"), device="cpu"
    )
    port.run(timeout=120)
    ref = jax_parse(desc.format(fw="jax", extra=""))
    ref.run(timeout=120)
    got = np.concatenate(_sink_tensors(port))
    want = np.concatenate([np.asarray(t) for t in _sink_tensors(ref)])
    assert got.dtype == np.uint32 and got.shape == (3,)
    np.testing.assert_array_equal(got, want)


def test_labels_file_runs_decoder_on_host(tmp_path):
    labels = tmp_path / "labels.txt"
    labels.write_text("\n".join(f"class{i}" for i in range(16)))
    p = parse_pipeline(
        "videotestsrc num-frames=1 width=32 height=32 ! tensor_converter ! "
        'tensor_filter framework=torch model=zoo:mobilenet_v2 custom="size:32,num_classes:16" ! '
        f"tensor_decoder mode=image_labeling option1={labels} ! tensor_sink name=out",
        device="cpu",
    )
    plan = p.compile_plan()
    assert [s.fused for s in plan.segments] == [True, False]
    p.run(timeout=60)
    (frame,) = p["out"].frames
    assert frame.meta["labels"] == [f"class{int(frame.tensors[0][0])}"]


def test_main_path_fuses_into_one_segment():
    p = parse_pipeline(
        "videotestsrc num-frames=1 width=40 height=30 ! tensor_converter ! "
        "tensor_transform mode=resize option=32:32 ! "
        'tensor_filter framework=torch model=zoo:mobilenet_v2 custom="size:32,num_classes:8" ! '
        "tensor_decoder mode=image_labeling ! tensor_sink",
        device="cpu",
    )
    plan = p.compile_plan()
    assert len(plan.segments) == 1 and len(plan.segments[0].ops) == 4


@pytest.mark.parametrize(
    "name", ["unknown_element", "filter_without_converter", "dangling_bang"]
)
def test_expect_fail(name, capsys):
    assert _run_cli(FAIL_PIPELINES[name]) != 0
    err = capsys.readouterr().err
    assert "nns-launch:" in err and "Traceback" not in err


def test_cli_without_gpu_asks_for_device(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = cli.main(["-q", "videotestsrc num-frames=1 ! tensor_converter ! fakesink"])
    err = capsys.readouterr().err
    assert rc == 1 and "nns-launch:" in err and "--device cpu" in err
