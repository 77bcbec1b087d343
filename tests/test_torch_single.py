"""SingleShot of the port against the JAX package's on the CPU
(``nnstreamer_tpu/single.py``): a single Frame comes back as a Frame with
the backend's outputs and the frame's meta, tensors as a tuple; the
``output_spec=``, ``accelerator=`` and ``**options`` arguments;
``is_open``, ``set_input_info``, ``reload_model`` and ``throughput_fps``;
on ``framework=scaler`` exactly and on ``zoo:mobilenet_v2`` at ``size:96``
(the reference's weights through ``params:``) within 1e-4 of max |logit|
with top-1 equal.
"""

import numpy as np
import pytest
import torch

import jax

from nnstreamer_tpu.models import mobilenet_v2 as jmobilenet
from nnstreamer_tpu.single import SingleShot as JSingleShot
from nnstreamer_tpu.tensors.frame import Frame as JFrame
from nnstreamer_tpu.tensors.spec import TensorsSpec as JSpec
from nnstreamer_tpu_torch.single import SingleShot
from nnstreamer_tpu_torch.tensors.frame import Frame
from nnstreamer_tpu_torch.tensors.spec import TensorsSpec


def _both(**kw):
    """The same SingleShot through both packages, opened."""
    spec = kw.pop("input_spec", None)
    port = SingleShot(device="cpu", input_spec=TensorsSpec.from_strings(*spec) if spec else None,
                      **kw)
    ref = JSingleShot(input_spec=JSpec.from_strings(*spec) if spec else None, **kw)
    return port.open(), ref.open()


def test_frame_in_frame_out_like_the_reference():
    port, ref = _both(framework="scaler", custom="factor:3", input_spec=("4", "float32"))
    try:
        x = np.arange(4, dtype=np.float32)
        got = port.invoke(Frame((x,), meta={"k": 7}))
        want = ref.invoke(JFrame((x,), meta={"k": 7}))
        assert isinstance(got, Frame) and isinstance(want, JFrame)
        (g,), (w,) = got.tensors, want.tensors
        assert tuple(g.shape) == np.asarray(w).shape == (4,)
        assert np.array_equal(g.numpy(), np.asarray(w)) and got.meta == want.meta == {"k": 7}
        (t,) = port.invoke(x)  # tensors in, a tuple out
        assert torch.equal(t, g)
    finally:
        port.close()
        ref.close()


def test_constructor_arguments_like_the_reference():
    out = ("4", "float32")
    for cls, spec in ((SingleShot, TensorsSpec), (JSingleShot, JSpec)):
        kw = {"device": "cpu"} if cls is SingleShot else {}
        s = cls(framework="scaler", custom="factor:2", input_spec=spec.from_strings(*out),
                output_spec=spec.from_strings(*out), accelerator="true:gpu", k1="v1", **kw)
        assert not s.is_open
        assert str(s.props.output_spec) == str(spec.from_strings(*out))
        assert s.props.options == {"k1": "v1"}
        with s:
            assert s.is_open
            (y,) = s.invoke(np.ones(4, np.float32))
            assert np.array_equal(np.asarray(y), np.full(4, 2.0, np.float32))
        assert not s.is_open


def test_accelerator_mesh_clause_raises_before_any_load(monkeypatch):
    """The mesh clause reaches the backend, which raises for a mesh past the
    devices before the model loads (one CPU position by default); one that
    fits shards the model."""
    from nnstreamer_tpu_torch.backends.base import BackendError
    from nnstreamer_tpu_torch.models import zoo as tzoo

    real_get = tzoo.get
    loads = []
    monkeypatch.setattr(tzoo, "get", lambda *a, **k: (loads.append(a), real_get(*a, **k))[1])
    s = SingleShot(framework="torch", model="zoo:mobilenet_v2", accelerator="true:gpu:mesh=dp2",
                   custom="size:32,num_classes:4", device="cpu")
    assert s.props.accelerator == "true:gpu:mesh=dp2"
    with pytest.raises(BackendError, match="mesh dp2 needs 2 devices, have 1"):
        s.open()
    assert loads == []
    monkeypatch.setenv("NNS_TPU_MESH_CPU_DEVICES", "2")
    with SingleShot(framework="torch", model="zoo:mobilenet_v2",
                    custom="size:32,num_classes:4,batch:2", accelerator="true:gpu:mesh=dp2",
                    device="cpu") as s:
        assert s.backend.mesh_model.n_rows == 2 and s.backend.mesh_model.splits_inputs
        assert loads


def test_set_input_info_and_reload_like_the_reference():
    port, ref = _both(framework="scaler", custom="factor:2", input_spec=("4", "float32"))
    try:
        got = port.set_input_info(TensorsSpec.from_strings("6", "float32"))
        want = ref.set_input_info(JSpec.from_strings("6", "float32"))
        assert got[0].shape == want[0].shape == (6,)
        x = np.arange(6, dtype=np.float32)
        assert np.array_equal(port.invoke(x)[0].numpy(), np.asarray(ref.invoke(x)[0]))
        port.reload_model("")
        ref.reload_model("")
        assert port.is_open and port.input_spec[0].shape == (4,) == ref.input_spec[0].shape
        x = np.arange(4, dtype=np.float32)
        assert np.array_equal(port.invoke(x)[0].numpy(), np.asarray(ref.invoke(x)[0]))
    finally:
        port.close()
        ref.close()


def test_latency_and_throughput():
    port, ref = _both(framework="scaler", input_spec=("4", "float32"))
    try:
        for _ in range(4):
            port.invoke(np.ones(4, np.float32))
            ref.invoke(np.ones(4, np.float32))
        assert port.throughput_fps > 0 and ref.throughput_fps > 0
        assert port.latency_us > 0 and port.backend.stats.total_invoke_num == 4
    finally:
        port.close()
        ref.close()


def test_mobilenet_like_the_reference(tmp_path):
    jp = jmobilenet.init_params(jax.random.PRNGKey(0), num_classes=16, width=0.5)
    path = tmp_path / "w.npz"
    np.savez(path, **{f"p{i}": np.asarray(v) for i, v in enumerate(jax.tree_util.tree_leaves(jp))})
    custom = f"size:96,num_classes:16,width:0.5,params:{path}"
    port, ref = _both(framework="jax", model="zoo:mobilenet_v2", custom=custom)
    try:
        x = np.random.default_rng(0).integers(0, 256, (1, 96, 96, 3)).astype(np.uint8)
        got = port.invoke(Frame((x,)))
        (want,) = ref.invoke(JFrame((x,))).tensors
        want = np.asarray(want)
        (g,) = got.tensors
        assert tuple(g.shape) == want.shape == (1, 16)
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=1e-4 * float(np.abs(want).max()))
        assert g.argmax() == want.argmax()
        port.reload_model("zoo:mobilenet_v2")
        assert torch.equal(port.invoke(x)[0], g)  # the same weights again
    finally:
        port.close()
        ref.close()
