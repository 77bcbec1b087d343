"""The port stands alone: importing it loads neither ``jax`` nor
``nnstreamer_tpu`` (nor a protobuf or flatbuffers runtime: its wire codecs
are its own), no source file of it imports any of them, every entry
point refuses to run quietly on the CPU when it was not asked to, the
kernel wrappers (K1 crop/resize, K2 NMS, K3 decode attention, K4 paged
decode attention, K5 flash attention) never fall back from the kernel to
its plain version,
and options that are not ported yet raise instead of running something
else.
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
from nnstreamer_tpu_torch.ops.kernels import flash_attention as flash_kernels
from nnstreamer_tpu_torch.ops.kernels import image_kernels
from nnstreamer_tpu_torch.ops.kernels import nms as nms_kernels
from nnstreamer_tpu_torch.ops.kernels import paged_attention as paged_kernels

PKG_DIR = os.path.dirname(nnstreamer_tpu_torch.__file__)
REPO = os.path.dirname(PKG_DIR)
FORBIDDEN = ("jax", "jaxlib", "nnstreamer_tpu")
# the wire codecs are written by hand: the card's machine has neither runtime
FORBIDDEN_MODULES = ("google.protobuf", "flatbuffers")


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


@pytest.mark.parametrize("module", [
    "nnstreamer_tpu_torch.ops.kernels.flash_attention",
    "nnstreamer_tpu_torch.models.quantize",
    "nnstreamer_tpu_torch.models.decode",
])
def test_slice5_modules_import_alone(module):
    """The flash-attention wrapper, the quantizer and beam search load
    neither jax nor the reference package."""
    code = (
        "import sys\n"
        f"import {module}\n"
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


@pytest.mark.parametrize("module", [
    "nnstreamer_tpu_torch.elements.routing",
    "nnstreamer_tpu_torch.elements.control",
    "nnstreamer_tpu_torch.elements.flow",
    "nnstreamer_tpu_torch.elements.windowing",
    "nnstreamer_tpu_torch.elements.sparse_elems",
    "nnstreamer_tpu_torch.pipeline.executor",
    "nnstreamer_tpu_torch.tensors.meta",
    "nnstreamer_tpu_torch.tensors.sparse",
    "nnstreamer_tpu_torch.converters",
    "nnstreamer_tpu_torch.decoders.protobuf",
    "nnstreamer_tpu_torch.decoders.flatbuf",
    "nnstreamer_tpu_torch.backends.custom",
    "nnstreamer_tpu_torch.backends.fakes",
    "nnstreamer_tpu_torch.script",
])
def test_routing_modules_import_alone(module):
    """The routing and host-side element surface, the executor and the
    wire codecs load neither jax nor the reference package."""
    code = (
        "import sys\n"
        f"import {module}\n"
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


@pytest.mark.parametrize("module", [
    "nnstreamer_tpu_torch.models.face_pipeline",
    "nnstreamer_tpu_torch.models.yolo",
    "nnstreamer_tpu_torch.models.posenet",
    "nnstreamer_tpu_torch.models.deeplab_v3",
    "nnstreamer_tpu_torch.ops.heatmap",
    "nnstreamer_tpu_torch.decoders.pose",
    "nnstreamer_tpu_torch.decoders.image_segment",
])
def test_vision_modules_import_alone(module):
    """The vision families, the heatmap ops and their decoders load
    neither jax nor the reference package."""
    test_routing_modules_import_alone(module)


@pytest.mark.parametrize("module", [
    "nnstreamer_tpu_torch.serving_plane",
    "nnstreamer_tpu_torch.serving_plane.scheduler",
    "nnstreamer_tpu_torch.serving_plane.plane",
    "nnstreamer_tpu_torch.serving_plane.sharding",
    "nnstreamer_tpu_torch.serving_plane.llm",
    "nnstreamer_tpu_torch.pipeline.programs",
])
def test_serving_plane_modules_import_alone(module):
    """The serving plane (scheduler, plane, programs, LLM plane) loads
    neither jax nor the reference package."""
    test_routing_modules_import_alone(module)


@pytest.mark.parametrize("module", [
    "nnstreamer_tpu_torch.pipeline.faults",
    "nnstreamer_tpu_torch.pipeline.device_faults",
    "nnstreamer_tpu_torch.parallel.replicas",
    "nnstreamer_tpu_torch.elements.chaos",
])
def test_fault_modules_import_alone(module):
    """The fault layer (error policies, device resilience, replica
    failover, tensor_chaos) loads neither jax nor the reference package."""
    test_routing_modules_import_alone(module)


def test_source_walk_covers_the_fault_layer():
    files = {os.path.relpath(p, PKG_DIR) for p in _py_files()}
    assert {os.path.join("pipeline", "faults.py"), os.path.join("pipeline", "device_faults.py"),
            os.path.join("parallel", "__init__.py"), os.path.join("parallel", "replicas.py"),
            os.path.join("elements", "chaos.py")} <= files


def test_source_walk_covers_the_serving_plane():
    files = {os.path.relpath(p, PKG_DIR) for p in _py_files()}
    assert {os.path.join("serving_plane", f) for f in (
        "__init__.py", "scheduler.py", "plane.py", "sharding.py", "llm.py")} <= files


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
                or any(n == m or n.startswith(m + ".") for m in FORBIDDEN_MODULES)
            ]
    assert offenders == []


def test_codecs_load_no_protobuf_or_flatbuffers_runtime():
    """The port's converters and decoders, the CLI and the registry's
    every subplugin load neither google.protobuf nor flatbuffers (nor jax
    or the reference package)."""
    code = (
        "import sys\n"
        "import nnstreamer_tpu_torch.cli\n"
        "from nnstreamer_tpu_torch import registry\n"
        "for k in registry.KINDS:\n"
        "    registry.available(k)\n"
        "import nnstreamer_tpu_torch.converters.protobuf, nnstreamer_tpu_torch.converters.flatbuf\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'nnstreamer_tpu', 'flatbuffers') or m.startswith('google.protobuf'))\n"
        "print(','.join(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, cwd=REPO, env=env,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == ""


@pytest.mark.parametrize(
    "entry",
    ["device", "pipeline", "parse", "single", "zoo", "zoo-ssd", "single-ssd", "zoo-lm",
     "batcher", "batcher-paged"],
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
        "batcher-paged": lambda: ContinuousBatcher(TransformerLM(16, 16, 2, 1), 2, max_len=8,
                                                   prompt_len=4, kv_layout="paged",
                                                   block_size=4),
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
    entries = (image_kernels.crop_entry_launches.count,
               image_kernels.resize_entry_launches.count)
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
    assert (image_kernels.crop_entry_launches.count,
            image_kernels.resize_entry_launches.count) == entries


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


@pytest.mark.parametrize("source", ["decode_attention", "paged_attention", "flash_attention"])
def test_library_key_covers_included_headers(tmp_path, monkeypatch, source):
    """An edited header changes the library name of every source that
    includes it, so a stale library is never loaded."""
    for f in [_build.CSRC / f"{source}.cu", *_build.CSRC.glob("*.cuh")]:
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path(source)
    with open(tmp_path / "attn_primitives.cuh", "a") as fh:
        fh.write("// edited\n")
    after = _build.library_path(source)
    assert before != after and after.name.startswith(f"lib{source}-")


def test_flash_attention_wrapper_never_falls_back():
    """K5 on a tensor neither on the CPU nor on a CUDA card raises and
    counts no launch; a view the kernel's vector loads cannot take raises
    before anything is built; without nvcc the kernel build raises instead
    of handing the work to the plain version."""
    before = flash_kernels.flash_attention_launches.count
    meta = torch.empty((1, 8, 2, 16), device="meta")
    with pytest.raises(RuntimeError, match="no implementation"):
        flash_kernels.flash_attention(meta, meta, meta)
    odd = torch.zeros((1, 8, 2, 17))[..., :16]  # rows 17 elements apart
    with pytest.raises(ValueError, match="multiples of 4"):
        flash_kernels._cuda_flash_attention(odd, odd, odd, True, 0.25)
    if not torch.cuda.is_available():
        q = torch.zeros((1, 8, 2, 16))
        with pytest.raises(RuntimeError):
            flash_kernels._cuda_flash_attention(q, q, q, True, 0.25)
    assert flash_kernels.flash_attention_launches.count == before


def _k4_operands(device, dtype=torch.float32):
    q = torch.zeros((2, 1, 4, 16), device=device)
    arena = torch.zeros((5, 4, 2, 16), dtype=dtype, device=device)
    tables = torch.zeros((2, 3), dtype=torch.int32, device=device)
    pos = torch.zeros((2,), dtype=torch.int32, device=device)
    fresh = torch.zeros((2, 1, 2, 16), device=device)
    return q, arena, arena, tables, pos, fresh, fresh


def test_paged_attention_wrapper_never_falls_back():
    """K4 on a tensor neither on the CPU nor on a CUDA card raises and
    counts no launch; without nvcc the kernel build raises instead of
    handing the work to the plain version."""
    before = paged_kernels.paged_decode_attention_launches.count
    with pytest.raises(RuntimeError, match="no implementation"):
        paged_kernels.paged_decode_attention(*_k4_operands("meta"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            paged_kernels._cuda_paged_attention(*_k4_operands("cpu"), None, None, 0.25)
    assert paged_kernels.paged_decode_attention_launches.count == before


@pytest.mark.parametrize("dtype", [torch.float16, torch.int32, torch.float64])
def test_paged_attention_refuses_unsupported_arena_dtypes(dtype):
    before = paged_kernels.paged_decode_attention_launches.count
    with pytest.raises(TypeError):
        paged_kernels.paged_decode_attention(*_k4_operands("cpu", dtype))
    q, arena, _, tables, pos, fk, fv = _k4_operands("cpu", torch.int8)
    with pytest.raises(TypeError, match="int8 arena needs"):  # int8 without its scales
        paged_kernels.paged_decode_attention(q, arena, arena, tables, pos, fk, fv)
    with pytest.raises(ValueError, match="int32"):  # int64 block tables
        paged_kernels.paged_decode_attention(*_k4_operands("cpu")[:3], tables.long(), pos, fk, fv)
    assert paged_kernels.paged_decode_attention_launches.count == before


def test_paged_kernel_with_gather_oracle_raises():
    """The paged kernel is block-native: attn_impl='pallas' with
    kv_attn='gather' is refused, as the reference refuses it."""
    from nnstreamer_tpu_torch.models.serving import ContinuousBatcher
    from nnstreamer_tpu_torch.models.transformer import TransformerLM

    with pytest.raises(ValueError, match="block-native"):
        ContinuousBatcher(TransformerLM(16, 16, 2, 1), 2, max_len=8, prompt_len=4,
                          kv_layout="paged", block_size=4, attn_impl="pallas",
                          kv_attn="gather", device="cpu")


@pytest.mark.parametrize(
    "call",
    ["migrate-to", "drain-to-peer", "role", "mesh", "plane", "kv-memory-bound"],
)
def test_unported_options_raise(call):
    from nnstreamer_tpu_torch.elements.filter import TensorFilter
    from nnstreamer_tpu_torch.elements.llm_serve import LlmServerSink, _LlmServer
    from nnstreamer_tpu_torch.models.serving import ContinuousBatcher
    from nnstreamer_tpu_torch.models.transformer import TransformerLM

    lm = TransformerLM(16, 16, 2, 1)

    def batcher(**kw):
        return ContinuousBatcher(lm, 2, max_len=8, prompt_len=4, device="cpu", **kw)

    def drain_to_peer():
        srv = _LlmServer(model="zoo:transformer_lm",
                         options={"vocab": "16", "d_model": "16", "n_heads": "2",
                                  "n_layers": "1"},
                         n_slots=1, max_len=8, prompt_len=4, default_new=2,
                         device=torch.device("cpu"),
                         kv_kw=dict(kv_layout="paged", block_size=4))
        try:
            return srv.drain(migrate_to="127.0.0.1:1")
        finally:
            srv.release_plane()  # as the element's stop: no longer a migration target

    # ported since (the edge layer): a migrate-to or role prop constructs,
    # and a drain to a peer with nothing in flight keeps nothing
    # ported since (meshes for serving): a slot-sharded batcher over a
    # one-position CPU mesh, and a plane data-sharded over a mesh
    from nnstreamer_tpu_torch.parallel.mesh import make_mesh

    ported = {
        "migrate-to": lambda: LlmServerSink(**{"kv-layout": "paged",
                                               "migrate-to": "127.0.0.1:7000"}),
        "drain-to-peer": drain_to_peer,
        "role": lambda: LlmServerSink(**{"kv-layout": "paged", "role": "prefill"}),
        "mesh": lambda: batcher(mesh=make_mesh(1, axes=("dp",), devices="cpu")),
        "plane": lambda: TensorFilter(framework="scaler", plane="p0",
                                      **{"plane-mode": "shard", "plane-devices": "2"}),
        # ported since (the analysis tooling): the bound nns-lint reads
        "kv-memory-bound": lambda: LlmServerSink(**{"kv-layout": "paged",
                                                     "kv-memory-bound": "64M"}),
    }
    if call in ported:
        got = ported[call]()
        if call == "drain-to-peer":
            assert got == {"migrated": 0, "resumed": 0, "completed": 0, "kept": 0}
        elif call == "mesh":
            assert got.stats()["mesh"] == {"devices": 1, "slots_per_device": 4,
                                           "k3_launches": [0]}
        elif call == "plane":
            assert got._plane_cfg.mode == "shard" and got._plane_cfg.devices == 2
        elif call == "kv-memory-bound":
            assert got.get_property(call) == "64M" and got.LINT_SKIP_NEGOTIATE
        else:
            assert got._create_kw[call.replace("-", "_")] == got.get_property(call)
        return
    raise AssertionError(f"{call}: neither ported nor refused")


@pytest.mark.parametrize("module", [
    "nnstreamer_tpu_torch.tools",
    "nnstreamer_tpu_torch.tools.tflite_parse",
    "nnstreamer_tpu_torch.tools.tflite_exec",
    "nnstreamer_tpu_torch.tools.pbtxt",
    "nnstreamer_tpu_torch.tools.confchk",
    "nnstreamer_tpu_torch.tools.gendoc",
    "nnstreamer_tpu_torch.tools.codegen",
    "nnstreamer_tpu_torch.backends.tflite_backend",
    "nnstreamer_tpu_torch.models.vit",
    "nnstreamer_tpu_torch.models.audio",
])
def test_model_source_modules_import_alone(module):
    """The tools, the TFLite backend and the ViT / keyword-spotting
    families load neither jax, the reference package nor tensorflow."""
    code = (
        "import sys\n"
        f"import {module}\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'nnstreamer_tpu', 'tensorflow',\n"
        "                                    'tflite_runtime', 'ai_edge_litert'))\n"
        "print(','.join(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, cwd=REPO, env=env,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == ""


def test_source_walk_covers_the_tools():
    files = {os.path.relpath(p, PKG_DIR) for p in _py_files()}
    assert {os.path.join("tools", f) for f in (
        "__init__.py", "tflite_parse.py", "tflite_exec.py", "pbtxt.py", "confchk.py",
        "gendoc.py", "codegen.py")} <= files


def test_tflite_under_torch_never_reaches_an_interpreter(tmp_path):
    """A .tflite opened with framework=torch runs as the port's program on
    the filter's device: no interpreter is imported, every constant is on
    that device; framework=tflite with no interpreter importable raises a
    BackendError that says so."""
    path = tmp_path / "m.tflite"
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import chip_smoke\n"
        f"chip_smoke.write_mobilenet_v2_tflite(np, {str(path)!r}, size=32, num_classes=4)\n"
        "for name in ('tensorflow', 'tflite_runtime', 'ai_edge_litert'):\n"
        "    sys.modules[name] = None  # an import of it raises ImportError\n"
        "from nnstreamer_tpu_torch.single import SingleShot\n"
        "from nnstreamer_tpu_torch.backends.base import BackendError\n"
        f"with SingleShot(framework='torch', model={str(path)!r}, device='cpu') as s:\n"
        "    (out,) = s.invoke(np.zeros((1, 32, 32, 3), np.float32))\n"
        "    places = {c.device.type for c in s.backend.program._consts.values()}\n"
        "try:\n"
        f"    SingleShot(framework='tflite', model={str(path)!r}, device='cpu').open()\n"
        "    refused = ''\n"
        "except BackendError as exc:\n"
        "    refused = str(exc)\n"
        "print(tuple(out.shape), sorted(places), 'no TFLite interpreter' in refused)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, cwd=REPO, env=env,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "(1, 4) ['cpu'] True"


@pytest.mark.parametrize("entry", ["zoo-vit", "zoo-kws", "tflite-program", "single-tflite",
                                   "single-script"])
def test_model_source_entry_points_refuse_cpu_unless_asked(entry, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import numpy as np

    import chip_smoke
    from nnstreamer_tpu_torch.models import zoo
    from nnstreamer_tpu_torch.single import SingleShot
    from nnstreamer_tpu_torch.tools.tflite_exec import TFLiteProgram

    path = str(tmp_path / "m.tflite")
    chip_smoke.write_mobilenet_v2_tflite(np, path, size=32, num_classes=4)
    script = tmp_path / "m.py"
    script.write_text("def get_model(options):\n    return (lambda x: x), None\n")
    calls = {
        "zoo-vit": lambda: zoo.get("vit", size="32", n_layers="1"),
        "zoo-kws": lambda: zoo.get("kws"),
        "tflite-program": lambda: TFLiteProgram(path),
        "single-tflite": lambda: SingleShot(framework="torch", model=path),
        "single-script": lambda: SingleShot(framework="torch", model=str(script)),
    }
    with pytest.raises(NoDeviceError):
        calls[entry]()
