"""The port stands alone: importing it loads neither ``jax`` nor
``nnstreamer_tpu``, no source file of it imports either, every entry
point refuses to run quietly on the CPU when it was not asked to, the
kernel wrappers (K1 crop/resize, K2 NMS, K3 decode attention) never fall
back from the kernel to its plain version, and options that are not
ported yet raise instead of running something else.
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

import nnstreamer_tpu_torch
from nnstreamer_tpu_torch.device import NoDeviceError, resolve_device
from nnstreamer_tpu_torch.ops.kernels import _build
from nnstreamer_tpu_torch.ops.kernels import decode_attention as decode_kernels
from nnstreamer_tpu_torch.ops.kernels import image_kernels
from nnstreamer_tpu_torch.ops.kernels import nms as nms_kernels

PKG_DIR = os.path.dirname(nnstreamer_tpu_torch.__file__)
REPO = os.path.dirname(PKG_DIR)
FORBIDDEN = ("jax", "jaxlib", "nnstreamer_tpu")


def test_import_leaves_jax_out():
    code = (
        "import sys\n"
        "import nnstreamer_tpu_torch, nnstreamer_tpu_torch.cli, nnstreamer_tpu_torch.single\n"
        "from nnstreamer_tpu_torch import registry\n"
        "for k in (registry.KIND_ELEMENT, registry.KIND_FILTER, registry.KIND_DECODER):\n"
        "    registry.available(k)\n"
        "import nnstreamer_tpu_torch.models.zoo\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'nnstreamer_tpu'))\n"
        "print(','.join(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, cwd=REPO, env=env,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == ""


def _py_files():
    for root, _, files in os.walk(PKG_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_no_source_imports_jax_or_reference():
    offenders = []
    for path in list(_py_files()) + [os.path.join(REPO, "chip_smoke.py")]:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            offenders += [
                f"{path}:{node.lineno} {n}" for n in names
                if n.split(".")[0] in FORBIDDEN
            ]
    assert offenders == []


@pytest.mark.parametrize(
    "entry",
    ["device", "pipeline", "parse", "single", "zoo", "zoo-ssd", "single-ssd", "zoo-lm",
     "batcher"],
)
def test_entry_points_refuse_cpu_unless_asked(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from nnstreamer_tpu_torch.models import zoo
    from nnstreamer_tpu_torch.models.serving import ContinuousBatcher
    from nnstreamer_tpu_torch.models.transformer import TransformerLM
    from nnstreamer_tpu_torch.pipeline.graph import Pipeline
    from nnstreamer_tpu_torch.pipeline.parse import parse_pipeline
    from nnstreamer_tpu_torch.single import SingleShot

    calls = {
        "device": lambda: resolve_device(),
        "pipeline": lambda: Pipeline(),
        "parse": lambda: parse_pipeline("videotestsrc ! tensor_converter ! fakesink"),
        "single": lambda: SingleShot(framework="torch", model="zoo:mobilenet_v2"),
        "zoo": lambda: zoo.get("mobilenet_v2", size="32"),
        "zoo-ssd": lambda: zoo.get("ssd_mobilenet_v2"),
        "single-ssd": lambda: SingleShot(framework="torch", model="zoo:ssd_mobilenet_v2_pp"),
        "zoo-lm": lambda: zoo.get("transformer_lm", vocab="16", d_model="16", n_heads="2",
                                  n_layers="1"),
        "batcher": lambda: ContinuousBatcher(TransformerLM(16, 16, 2, 1), 2, max_len=8,
                                             prompt_len=4),
    }
    with pytest.raises(NoDeviceError):
        calls[entry]()
    # ... and the same call asked for the CPU runs there
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_wrapper_never_falls_back():
    """A tensor that is neither on the CPU nor on a CUDA card raises; and
    without nvcc the kernel build itself raises instead of handing the work
    to the plain version."""
    before = image_kernels.crop_resize_launches.count
    img = torch.empty((1, 8, 8, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(RuntimeError, match="no implementation"):
        image_kernels.resize_bilinear(img, 4, 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            image_kernels._cuda_crop_resize(
                torch.zeros((1, 8, 8, 3), dtype=torch.uint8), None, 1, 4, 4,
                None, None, torch.uint8,
            )
    assert image_kernels.crop_resize_launches.count == before


def test_kernel_build_is_lazy_and_keyed_by_source():
    """Nothing is built at import; the library name carries the source's
    hash, under the repository's build directory."""
    path = _build.library_path("image_kernels")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libimage_kernels-") and path.suffix == ".so"
    assert (_build.CSRC / "image_kernels.cu").is_file()


def test_nms_wrapper_never_falls_back():
    """The NMS wrapper on a tensor neither on the CPU nor on a CUDA card
    raises and counts no launch; without nvcc the kernel build raises
    instead of handing the work to the plain version."""
    before = nms_kernels.nms_launches.count
    boxes = torch.empty((8, 4), device="meta")
    with pytest.raises(RuntimeError, match="no implementation"):
        nms_kernels.nms_mask(boxes, torch.empty((8,), device="meta"), 0.5)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            nms_kernels._cuda_nms(torch.zeros((8, 4)), torch.ones(8), 0.5)
    assert nms_kernels.nms_launches.count == before


def test_nms_kernel_refuses_more_than_max_n():
    """Past the candidates its shared memory holds, the kernel wrapper
    raises before it builds or launches anything."""
    before = nms_kernels.nms_launches.count
    n = nms_kernels.MAX_N + 1
    assert nms_kernels.MAX_N >= 25200  # a YOLOv5 head at 640x640 fits
    with pytest.raises(ValueError, match="at most"):
        nms_kernels._cuda_nms(torch.zeros((n, 4)), torch.ones(n), 0.5)
    assert nms_kernels.nms_launches.count == before


def test_nms_library_is_keyed_by_source():
    path = _build.library_path("nms")
    assert path.parent == _build.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "torch_kernels")
    assert path.name.startswith("libnms-") and path.suffix == ".so"
    assert (_build.CSRC / "nms.cu").is_file()


def _k3_operands(device, dtype=torch.float32):
    q = torch.zeros((2, 1, 4, 16), device=device)
    cache = torch.zeros((2, 8, 2, 16), dtype=dtype, device=device)
    pos = torch.zeros((2,), dtype=torch.int32, device=device)
    return q, cache, cache, pos


def test_decode_attention_wrapper_never_falls_back():
    """K3 on a tensor neither on the CPU nor on a CUDA card raises and
    counts no launch; without nvcc the kernel build raises instead of
    handing the work to the plain version."""
    before = decode_kernels.decode_attention_launches.count
    with pytest.raises(RuntimeError, match="no implementation"):
        decode_kernels.decode_attention(*_k3_operands("meta"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            decode_kernels._cuda_decode_attention(*_k3_operands("cpu"), None, None, 0.25)
    assert decode_kernels.decode_attention_launches.count == before


@pytest.mark.parametrize("dtype", [torch.float16, torch.int32, torch.float64])
def test_decode_attention_refuses_unsupported_dtypes(dtype):
    before = decode_kernels.decode_attention_launches.count
    with pytest.raises(TypeError):
        decode_kernels.decode_attention(*_k3_operands("cpu", dtype))
    q, cache, _, pos = _k3_operands("cpu", torch.int8)
    with pytest.raises(TypeError, match="int8 cache needs"):  # int8 without its scales
        decode_kernels.decode_attention(q, cache, cache, pos)
    assert decode_kernels.decode_attention_launches.count == before


def test_library_key_covers_included_headers(tmp_path, monkeypatch):
    """An edited header changes the library name of every source that
    includes it, so a stale library is never loaded."""
    for f in ("decode_attention.cu", "attn_primitives.cuh"):
        (tmp_path / f).write_bytes((_build.CSRC / f).read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path("decode_attention")
    with open(tmp_path / "attn_primitives.cuh", "a") as fh:
        fh.write("// edited\n")
    after = _build.library_path("decode_attention")
    assert before != after and after.name.startswith("libdecode_attention-")


@pytest.mark.parametrize(
    "call",
    ["paged", "windowed", "draft", "mesh", "attn-flash", "int8w", "beam", "plane",
     "kv-layout-paged", "speculate"],
)
def test_unported_options_raise(call):
    from nnstreamer_tpu_torch.elements.llm_serve import LlmServerSink
    from nnstreamer_tpu_torch.models import zoo
    from nnstreamer_tpu_torch.models.serving import ContinuousBatcher
    from nnstreamer_tpu_torch.models.transformer import TransformerLM

    lm = TransformerLM(16, 16, 2, 1)

    def batcher(**kw):
        return ContinuousBatcher(lm, 2, max_len=8, prompt_len=4, device="cpu", **kw)

    def lm_zoo(**kw):
        return zoo.get("transformer_lm", device="cpu", vocab="16", d_model="16",
                       n_heads="2", n_layers="1", **kw)

    calls = {
        "paged": lambda: batcher(kv_layout="paged"),
        "windowed": lambda: batcher(windowed=True),
        "draft": lambda: batcher(draft_params=lm),
        "mesh": lambda: batcher(mesh=object()),
        "attn-flash": lambda: lm_zoo(attn="flash"),
        "int8w": lambda: lm_zoo(quantize="int8w"),
        "beam": lambda: lm_zoo(generate="2", decode="beam"),
        "plane": lambda: LlmServerSink(plane="p0"),
        "kv-layout-paged": lambda: LlmServerSink(**{"kv-layout": "paged"}),
        "speculate": lambda: LlmServerSink(speculate="4"),
    }
    with pytest.raises(NotImplementedError, match="not ported"):
        calls[call]()
