"""The port's data-sharded plane program and per-stage placement
(serving_plane/sharding.py ``MeshShardedProgram``,
serving_plane/placement.py, the filter's ``device=`` prop and the
backend's ``plane_fn`` hook) against the JAX package's: the counterparts
of tests/test_plane.py ``TestSharded`` and ``TestPlacement`` and of
``test_device_pin_keeps_plane_batching``.

The JAX package runs on its 8 virtual CPU devices, the port on an
8-position CPU mesh (``NNS_TPU_MESH_CPU_DEVICES=8``); every position of
the port's is the CPU device, and a placed stage is pinned to the one CPU
device (the ``device:N`` departure, ROADMAP C). The same numpy-seeded
windows and frames go through both; rows are held bitwise within the port
and to the JAX package's within float32 rounding.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nnstreamer_tpu.elements.filter import TensorFilter as JFilter
from nnstreamer_tpu.elements.sink import TensorSink as JSink
from nnstreamer_tpu.parallel.mesh import make_mesh as jmake_mesh
from nnstreamer_tpu.pipeline.parse import parse_pipeline as jparse
from nnstreamer_tpu.serving_plane import PlacementError as JPlacementError
from nnstreamer_tpu.serving_plane import place_pipeline as jplace
from nnstreamer_tpu.serving_plane import plan_placement as jplan
from nnstreamer_tpu.serving_plane import sharding as jsharding
from nnstreamer_tpu.serving_plane.placement import parse_bytes as jparse_bytes
from nnstreamer_tpu.tensors.spec import TensorsSpec as JSpec
from nnstreamer_tpu_torch.elements.filter import TensorFilter
from nnstreamer_tpu_torch.elements.sink import TensorSink
from nnstreamer_tpu_torch.parallel.mesh import make_mesh
from nnstreamer_tpu_torch.pipeline.batching import default_buckets
from nnstreamer_tpu_torch.pipeline.parse import parse_pipeline
from nnstreamer_tpu_torch.serving_plane import PlacementError, place_pipeline, plan_placement
from nnstreamer_tpu_torch.serving_plane import plane as plane_mod
from nnstreamer_tpu_torch.serving_plane.sharding import (
    MeshShardedProgram,
    VmapProgram,
    build_plane_program,
)
from nnstreamer_tpu_torch.tensors.spec import TensorsSpec

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _eight_cpu_positions(monkeypatch):
    monkeypatch.setenv("NNS_TPU_MESH_CPU_DEVICES", "8")


def _model(tmp_path, k=2.0):
    """A script model both packages load: ``x * k`` over their arrays."""
    path = tmp_path / "mm.py"
    path.write_text("def get_model(options):\n"
                    f"    return (lambda x: x * {k}), None\n")
    return str(path)


def _windows(n, seed0=0):
    return [np.random.default_rng(seed0 + i).standard_normal((8,)).astype(np.float32)
            for i in range(n)]


# -- the mesh-sharded program (TestSharded) -----------------------------------

def test_mesh_parity_with_single_device():
    w = np.random.default_rng(0).standard_normal((8, 8)).astype(np.float32)
    tw, jw = torch.from_numpy(w), jnp.asarray(w)
    xs = _windows(6)
    single = VmapProgram(lambda ts: (ts[0] @ tw,), default_buckets(8), CPU)
    sharded = MeshShardedProgram(lambda ts: (ts[0] @ tw,),
                                 make_mesh(4, axes=("dp",), devices="cpu"), max_batch=8)
    a = single.invoke([(torch.from_numpy(x),) for x in xs])
    b = sharded.invoke([(torch.from_numpy(x),) for x in xs])
    for (x,), (y,) in zip(a, b):
        assert torch.equal(x, y)
    ref = jsharding.MeshShardedProgram(lambda ts: (ts[0] @ jw,),
                                       jmake_mesh(4, axes=("dp",)), max_batch=8)
    for (y,), (r,) in zip(b, ref.invoke([(x,) for x in xs])):
        np.testing.assert_allclose(y.numpy(), np.asarray(r), rtol=1e-6, atol=1e-6)
    assert sharded.stats() == {"mode": "shard", "n_traces": sharded.n_traces,
                               "mesh_devices": 4}
    assert ref.stats()["mesh_devices"] == 4


def test_oversized_batch_chunks_to_ladder():
    """A batch wider than the top bucket chunks to the ladder instead of
    computing a negative pad."""
    windows = [np.full(4, float(j), np.float32) for j in range(5)]
    progs = (VmapProgram(lambda ts: (ts[0] * 2.0,), default_buckets(4), CPU),
             MeshShardedProgram(lambda ts: (ts[0] * 2.0,),
                                make_mesh(2, axes=("dp",), devices="cpu"), max_batch=4),
             jsharding.MeshShardedProgram(lambda ts: (ts[0] * 2.0,),
                                          jmake_mesh(2, axes=("dp",)), max_batch=4))
    for prog in progs:
        outs = prog.invoke([(torch.from_numpy(w) if isinstance(prog, VmapProgram) else w,)
                            for w in windows])
        assert len(outs) == 5
        for j, (y,) in enumerate(outs):
            assert np.array_equal(np.asarray(y), np.full(4, 2.0 * j, np.float32))


def test_shard_bucket_ladder_multiple_of_mesh():
    for n, max_batch in ((4, 8), (3, 8), (2, 5), (8, 4)):
        prog = MeshShardedProgram(lambda ts: ts, make_mesh(n, axes=("dp",), devices="cpu"),
                                  max_batch=max_batch)
        ref = jsharding.MeshShardedProgram(lambda ts: ts, jmake_mesh(n, axes=("dp",)),
                                           max_batch=max_batch)
        assert prog.buckets == ref.buckets
        assert [prog.bucket_for(k) for k in range(1, 9)] == [ref.bucket_for(k)
                                                            for k in range(1, 9)]
    prog = MeshShardedProgram(lambda ts: ts, make_mesh(4, axes=("dp",), devices="cpu"))
    assert prog.buckets == (4, 8) and prog.bucket_for(3) == 4 and prog.bucket_for(5) == 8


def test_plane_mode_shard_through_the_filter(tmp_path):
    """plane-mode=shard plane-devices=4: the plane's program is the dp
    mesh's, its stats name the positions, and a mesh past the positions
    raises naming both counts before any backend opens."""
    f = TensorFilter(framework="torch", model=_model(tmp_path), input="4",
                     inputtype="float32", plane="shard4",
                     **{"plane-mode": "shard", "plane-devices": "4"})
    try:
        f.negotiate([TensorsSpec.from_strings("4", "float32")])
        pl = f._plane
        outs = pl.submit_window(f._plane_stream, [(torch.full((4,), float(j)),)
                                                  for j in range(3)])
        assert [float(o[0][0]) for o in outs] == [0.0, 2.0, 4.0]
        assert isinstance(pl._program, MeshShardedProgram)
        assert pl.stats()["mesh_devices"] == 4 and pl.stats()["program"] == "shard"
    finally:
        f.stop()
    g = TensorFilter(framework="torch", model=_model(tmp_path), input="4",
                     inputtype="float32", plane="shard16",
                     **{"plane-mode": "shard", "plane-devices": "16"})
    with pytest.raises(ValueError, match="needs 16 devices, have 8"):
        g.negotiate([TensorsSpec.from_strings("4", "float32")])
    assert g.backend is None and plane_mod.get("shard16") is None


# -- placement (TestPlacement) ------------------------------------------------

@pytest.mark.parametrize("args", [
    ([4, 4, 4, 4], 8, 2, None),
    ([2, 2, 2], 8, 4, None),
    ([2, 2, 2], 8, 4, {1: 3}),
    ([3, 5, 2, 6, 1], 8, 3, None),
])
def test_bound_respected(args):
    assert plan_placement(*args) == jplan(*args)
    assert plan_placement([4, 4, 4, 4], 8, 2) == [0, 0, 1, 1]
    assert plan_placement([2, 2, 2], 8, 4) == [0, 0, 0]


@pytest.mark.parametrize("args,match", [
    (([9], 8, 2), "over the per-device"),
    (([4, 4, 4, 4, 4], 8, 2), "fits on no device"),
    (([8, 8], 8, 2, {1: 0}), "pinned"),
    (([1], 8, 0), "at least one device"),
    (([1], 0, 1), "must be positive"),
])
def test_no_fit_raises(args, match):
    with pytest.raises(JPlacementError, match=match) as ref:
        jplan(*args)
    with pytest.raises(PlacementError, match=match) as port:
        plan_placement(*args)
    assert str(port.value) == str(ref.value)


def test_pins_are_hard_constraints():
    plan = plan_placement([2, 2, 2], 8, 4, pinned={1: 3})
    assert plan[1] == 3 and plan == jplan([2, 2, 2], 8, 4, pinned={1: 3})
    with pytest.raises(PlacementError, match="pinned"):
        plan_placement([8, 8], 8, 2, pinned={1: 0})


def test_place_pipeline_splits_and_runs(tmp_path):
    """Each stage ~32 activation bytes: a 50-byte bound puts the second on
    the next device, in both packages; the pipelines give the same frames."""
    model = _model(tmp_path)
    desc = (f"tensorsrc dimensions=4 pattern=counter num-frames=6 ! "
            f"tensor_filter framework=torch model={model} input=4 inputtype=float32 name=f1 ! "
            f"tensor_filter framework=torch model={model} input=4 inputtype=float32 name=f2 ! "
            f"tensor_sink")
    p = parse_pipeline(desc, device="cpu")
    jp = jparse(desc.replace("framework=torch", "framework=jax"))
    placement = place_pipeline(p, per_device_bytes=50, n_devices=2)
    assert placement == jplace(jp, per_device_bytes=50, n_devices=2) == {"f1": 0, "f2": 1}
    assert p["f2"].backend._pinned == CPU and p["f1"].backend._pinned is None
    p.run(timeout=60)
    jp.run(timeout=60)
    outs = [np.asarray(f.tensors[0]) for f in next(
        e for e in p.elements if isinstance(e, TensorSink)).frames]
    refs = [np.asarray(f.tensors[0]) for f in next(
        e for e in jp.elements if isinstance(e, JSink)).frames]
    assert len(outs) == len(refs) == 6
    for j, (a, r) in enumerate(zip(outs, refs)):
        assert np.array_equal(a, r) and np.allclose(a, np.full(4, 4.0 * j, np.float32))


def test_place_pipeline_needs_a_bound(tmp_path, monkeypatch):
    p = parse_pipeline(f"tensorsrc dimensions=4 num-frames=1 ! tensor_filter framework=torch "
                       f"model={_model(tmp_path)} input=4 inputtype=float32 ! tensor_sink",
                       device="cpu")
    monkeypatch.delenv("NNS_TPU_PLANE_MEMORY_PER_DEVICE", raising=False)
    with pytest.raises(PlacementError, match="no memory bound"):
        place_pipeline(p)
    monkeypatch.setenv("NNS_TPU_PLANE_MEMORY_PER_DEVICE", "1K")
    assert place_pipeline(p) == {p.elements[1].name: 0}


def test_device_prop_pins_backend(tmp_path):
    """device= rides the custom string into the backend's placement, as in
    the reference; out of range on CUDA raises before any load."""
    f = TensorFilter(framework="scaler", custom="factor:2.0", device="1")
    jf = JFilter(framework="scaler", custom="factor:2.0", device="1")
    assert "device:1" in f.fprops.custom and f.fprops.custom == jf.fprops.custom
    g = TensorFilter(framework="torch", model=_model(tmp_path), input="4",
                     inputtype="float32", device="3")
    g.negotiate([TensorsSpec.from_strings("4", "float32")])
    assert g.backend._pinned == CPU and g.backend.traceable_fn() is None
    with pytest.raises(ValueError, match="bad device"):
        TensorFilter(framework="scaler", device="x")


def test_parse_bytes():
    from nnstreamer_tpu_torch.serving_plane.placement import parse_bytes

    for raw in ("256M", "2K", "123", "1.5G"):
        assert parse_bytes(raw) == jparse_bytes(raw)
    assert parse_bytes("256M") == 256 << 20


def test_stage_estimate_counts_weights_and_activations():
    """A stage's bytes are its module's parameters and buffers plus one
    set of input and output activations: MobileNet-v2 at 16 classes."""
    from nnstreamer_tpu_torch.analysis.costmodel import estimate_backend_bytes, params_bytes

    f = TensorFilter(framework="torch", model="zoo:mobilenet_v2",
                     custom="size:32,num_classes:16")
    f.negotiate([TensorsSpec.from_strings("3:32:32:1", "uint8")])
    m = f.backend.module
    weights = sum(t.numel() * t.element_size() for t in list(m.parameters()) + list(m.buffers()))
    assert params_bytes(m) == weights
    assert estimate_backend_bytes(f.backend) == weights + 32 * 32 * 3 + 16 * 4


# -- the plane's device pin -------------------------------------------------------

def test_device_pin_keeps_plane_batching(tmp_path):
    """plane= + device=N batches on the pinned device through the plane's
    own program (the plane_fn hook): the pin is a fusion barrier, not a
    batching barrier."""
    model = _model(tmp_path)
    f = TensorFilter(framework="torch", model=model, input="4", inputtype="float32",
                     plane="pin1", device="1")
    jf = JFilter(framework="jax", model=model, input="4", inputtype="float32",
                 plane="jpin1", device="1")
    try:
        f.negotiate([TensorsSpec.from_strings("4", "float32")])
        jf.negotiate([JSpec.from_strings("4", "float32")])
        prog = build_plane_program([f.backend], f._plane_cfg)
        ref = jsharding.build_plane_program([jf.backend], jf._plane_cfg)
        assert isinstance(prog, VmapProgram) and isinstance(ref, jsharding.VmapProgram)
        assert prog.device == CPU and ref._device is jax.devices()[1]
        x = np.arange(4, dtype=np.float32)
        ((out,),) = prog.invoke([(torch.from_numpy(x),)])
        ((jout,),) = ref.invoke([(x,)])
        assert np.array_equal(out.numpy(), x * 2.0) and np.array_equal(np.asarray(jout), x * 2.0)
        outs = prog.invoke([(torch.from_numpy(x + j),) for j in range(3)])
        assert [o[0].tolist() for o in outs] == [((x + j) * 2.0).tolist() for j in range(3)]
        assert prog.n_traces == 2  # the per-frame and the bucket-4 program
    finally:
        f.stop()
        jf.stop()
