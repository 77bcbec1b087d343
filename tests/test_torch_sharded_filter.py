"""The mesh-sharded tensor_filter of the port (``custom="mesh:..."``, the
``accelerator=`` mesh clause and ``set_shardings``; backends/torch_backend.py,
parallel/sharded_model.py) against the JAX package's: the counterparts of
the 8 tests of tests/test_sharded_filter.py.

Both packages load the same MobileNet-v2 weights (the reference's, exported
to an npz for ``params:``) and take the same numpy-seeded frames; the JAX
package runs on its 8 virtual CPU devices and the port on an 8-position CPU
mesh (``NNS_TPU_MESH_CPU_DEVICES=8``). Every sharded output is held to the
JAX package's at the reference's ``rtol=2e-4, atol=2e-4`` (resharded
reductions reorder float adds: parity is numeric, not bitwise).
"""

import numpy as np
import pytest
import torch

import jax

from nnstreamer_tpu.models import mobilenet_v2 as jmobilenet
from nnstreamer_tpu.pipeline.parse import parse_pipeline as jparse
from nnstreamer_tpu.single import SingleShot as JSingleShot
from nnstreamer_tpu_torch.backends.base import BackendError
from nnstreamer_tpu_torch.pipeline.parse import parse_pipeline
from nnstreamer_tpu_torch.single import SingleShot

TOL = dict(rtol=2e-4, atol=2e-4)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _eight_cpu_positions(monkeypatch):
    monkeypatch.setenv("NNS_TPU_MESH_CPU_DEVICES", "8")


@pytest.fixture(scope="module")
def opts(tmp_path_factory):
    """The model options of both packages: the reference's seed-0 weights
    for 16 classes as an npz (leaves ``p{i}`` in tree-flatten order)."""
    jp = jmobilenet.init_params(jax.random.PRNGKey(0), num_classes=16)
    path = tmp_path_factory.mktemp("mbv2") / "w.npz"
    np.savez(path, **{f"p{i}": np.asarray(v)
                      for i, v in enumerate(jax.tree_util.tree_leaves(jp))})
    return f"size:64,batch:8,num_classes:16,params:{path}"


def _frames(batch=8, size=64, n=2):
    rng = np.random.default_rng(7)
    return [rng.integers(0, 255, (batch, size, size, 3), np.uint8) for _ in range(n)]


@pytest.fixture(scope="module")
def jax_outs(opts):
    """The JAX package's unsharded outputs on the frames."""
    with JSingleShot(framework="jax", model="zoo:mobilenet_v2", custom=opts) as s:
        return [np.asarray(s.invoke(f)[0]) for f in _frames()]


def _port(opts, **kw):
    return SingleShot(framework="torch", model="zoo:mobilenet_v2", custom=opts, device="cpu",
                      **kw)


@pytest.mark.parametrize("mesh", ["dp2tp4", "dp8", "tp4"])
def test_mesh_custom_option_parity(mesh, opts, jax_outs):
    frames = _frames()
    with JSingleShot(framework="jax", model="zoo:mobilenet_v2",
                     custom=f"{opts},mesh:{mesh}") as js:
        jax_mesh = [np.asarray(js.invoke(f)[0]) for f in frames[:1]]
    with _port(f"{opts},mesh:{mesh}") as s:
        assert s.backend.mesh_model is not None
        for i, (f, ref) in enumerate(zip(frames, jax_outs)):
            out = s.invoke(f)[0].numpy()
            assert out.shape == ref.shape
            np.testing.assert_allclose(out, ref, **TOL)
            if i < len(jax_mesh):
                np.testing.assert_allclose(out, jax_mesh[i], **TOL)


def test_accelerator_mesh_clause_parity(opts, jax_outs):
    with _port(opts, accelerator="true:gpu:mesh=dp4tp2") as s:
        mm = s.backend.mesh_model
        assert mm.n_rows == 4 and mm.split_layers[0]
        out = s.invoke(_frames()[0])[0].numpy()
    np.testing.assert_allclose(out, jax_outs[0], **TOL)


def test_sharded_params_actually_sharded(opts):
    """tp>1 splits real weights over the positions, as the reference's
    mesh:tp4 shards its leaves: a split layer's parts each hold a quarter
    of its output channels, one part a position, and together the whole
    weight of the unsharded model."""
    with JSingleShot(framework="jax", model="zoo:mobilenet_v2",
                     custom=f"{opts},mesh:tp4") as js:
        jleaves = jax.tree_util.tree_leaves(js.backend._placed_params)
        assert any(not l.sharding.is_fully_replicated for l in jleaves)
    with _port(opts) as plain, _port(f"{opts},mesh:tp4") as s:
        parts = s.backend.mesh_model.column_parts()
        assert parts, "no layer is split under mesh:tp4"
        full = dict(plain.backend.module.named_modules())
        name, ws = max(parts.items(), key=lambda kv: sum(w.numel() for w in kv[1]))
        whole = full[name].weight
        assert len(ws) == 4 and len({w.data_ptr() for w in ws}) == 4
        assert all(w.shape[0] == whole.shape[0] // 4 and w.numel() < whole.numel() for w in ws)
        assert torch.equal(torch.cat(list(ws)), whole)
        assert len(parts) >= 40  # every conv and the classifier: all divide by 4


def test_set_shardings_programmatic(opts, jax_outs):
    """The parallel layer's programmatic entry, with the port's
    descriptors: the batch split over an 8-position dp mesh."""
    from nnstreamer_tpu_torch.backends.base import FilterProps
    from nnstreamer_tpu_torch.backends.torch_backend import TorchBackend
    from nnstreamer_tpu_torch.parallel.mesh import batch_sharding, make_mesh

    mesh = make_mesh(8, axes=("dp",), devices="cpu")
    be = TorchBackend()
    be.open(FilterProps(framework="torch", model=("zoo:mobilenet_v2",), custom=opts,
                        device=CPU))
    x = torch.from_numpy(_frames(n=1)[0])
    ref = be.invoke((x,))[0].numpy()
    be.set_shardings([batch_sharding(mesh, "dp")])
    assert be.mesh_model.n_rows == 8 and be.mesh_model.splits_inputs
    out = be.invoke((x,))[0].numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_allclose(out, jax_outs[0], **TOL)
    assert be.traceable_fn() is None  # a mesh-sharded stage is a fusion barrier


def _pipeline_logits(parse, extra, params, **kw):
    from nnstreamer_tpu_torch.elements.sink import TensorSink

    p = parse(
        "videotestsrc pattern=gradient num-frames=3 width=64 height=64 ! tensor_converter ! "
        "tensor_filter framework=jax model=zoo:mobilenet_v2 "
        f'custom="size:64,num_classes:16,params:{params}{extra}" ! tensor_sink', **kw)
    p.run(timeout=300)
    sink = next(e for e in p.elements if type(e).__name__ == TensorSink.__name__)
    return [np.asarray(f.tensors[0]) for f in sink.frames]


def test_mesh_in_pipeline(opts):
    """TP inference inside a running pipeline: a sharded filter stage,
    against the unsharded port pipeline and the JAX package's."""
    params = opts.split("params:")[1]
    ref = _pipeline_logits(jparse, "", params)
    plain = _pipeline_logits(parse_pipeline, "", params, device="cpu")
    sharded = _pipeline_logits(parse_pipeline, ",mesh:tp4", params, device="cpu")
    assert len(ref) == len(plain) == len(sharded) == 3
    for r, a, b in zip(ref, plain, sharded):
        np.testing.assert_allclose(b, a, **TOL)
        np.testing.assert_allclose(b, r, **TOL)


@pytest.mark.parametrize("extra,msg", [
    ("mesh:bogus", "bad mesh spec"),
    ("mesh:dp64", "needs 64 devices, have 8"),
    ("mesh:dp2,device:0", "device: and mesh: are exclusive"),
])
def test_bad_mesh_options_rejected_like_the_reference(extra, msg, opts):
    """test_bad_mesh_spec_rejected, test_mesh_too_many_devices_rejected and
    test_device_and_mesh_exclusive: both packages raise their backend error."""
    from nnstreamer_tpu.backends.base import BackendError as JBackendError

    with pytest.raises(JBackendError, match=msg.split(",")[0].replace("have 8", "")):
        JSingleShot(framework="jax", model="zoo:mobilenet_v2", custom=f"{opts},{extra}").open()
    with pytest.raises(BackendError, match=msg):
        _port(f"{opts},{extra}").open()
