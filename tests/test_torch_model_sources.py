"""The torch backend's model sources besides ``zoo:`` (and fault C.4):
TorchScript ``.pt`` / ``.pth`` through ``framework=torch`` and
``framework=auto`` against the JAX package's torch backend, a ``.py``
``get_model`` script (fused when traceable, a host node when it says it
is not), the refusal of serialized JAX programs, and the auto-detect
priority table (``.py`` → custom, ``.tflite`` → tflite then torch, with
the env override).

Tolerances: TorchScript outputs equal the reference's bit for bit (the
same TorchScript file run by torch on the CPU in both); a script model
equals its own module's eager output bit for bit.
"""

import numpy as np
import pytest
import torch

from nnstreamer_tpu.single import SingleShot as JSingleShot
from nnstreamer_tpu.tensors.spec import TensorsSpec as JSpec
from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.backends.base import BackendError
from nnstreamer_tpu_torch.pipeline.parse import parse_pipeline
from nnstreamer_tpu_torch.single import SingleShot
from nnstreamer_tpu_torch.tensors.spec import TensorsSpec


class Affine(torch.nn.Module):
    def forward(self, x):
        return x * 2.0 + 1.0


class TwoOut(torch.nn.Module):
    def forward(self, x):
        return torch.relu(x), x.sum(dim=-1)


@pytest.fixture(scope="module")
def scripted(tmp_path_factory):
    d = tmp_path_factory.mktemp("ts")
    paths = {}
    for name, mod, ext in (("affine", Affine(), "pt"), ("two", TwoOut(), "pth")):
        path = str(d / f"{name}.{ext}")
        torch.jit.script(mod).save(path)
        paths[name] = path
    return paths


@pytest.mark.parametrize("framework", ["torch", "auto"])
@pytest.mark.parametrize("name", ["affine", "two"])
def test_torchscript_matches_reference(scripted, framework, name):
    """C.4: a .pt / .pth opens through framework=torch and framework=auto,
    as the reference's torch backend opens it."""
    x = np.random.default_rng(0).standard_normal((2, 3)).astype(np.float32)
    with SingleShot(framework=framework, model=scripted[name], device="cpu",
                    input_spec=TensorsSpec.from_strings("3:2", "float32")) as s:
        got = s.invoke(x)
        assert s.props.framework == "torch"
        assert not s.backend.traceable_fn()
        out_spec = s.output_spec
    with JSingleShot(framework=framework, model=scripted[name],
                     input_spec=JSpec.from_strings("3:2", "float32")) as s:
        want = s.invoke(x)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert [tuple(t.shape) for t in out_spec] == [np.asarray(w).shape for w in want]


def test_torchscript_needs_an_input_spec(scripted):
    with SingleShot(framework="torch", model=scripted["affine"], device="cpu") as s:
        with pytest.raises(BackendError, match="input spec unknown"):
            s.invoke(np.zeros((2, 3), np.float32))


def test_torchscript_is_a_host_node_in_a_pipeline(scripted):
    desc = ("tensorsrc dimensions=3:2 pattern=counter num-frames=3 ! "
            f"tensor_filter name=f framework=torch model={scripted['affine']} "
            "input=3:2 inputtype=float32 ! tensor_sink name=out")
    p = parse_pipeline(desc, device="cpu")
    p.run(timeout=60)
    frames = p["out"].frames
    assert len(frames) == 3
    assert not any(seg.fused and any(op.name == "f" for op in getattr(seg, "ops", ()))
                   for seg in p._executor.plan.segments)
    x = np.asarray(frames[0].tensors[0])
    assert x.dtype == np.float32


SCRIPT = '''
import torch


class Net(torch.nn.Module):
    TRACEABLE = {traceable}

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.w = torch.nn.Parameter(torch.randn((4, 4), generator=g), requires_grad=False)

    def forward(self, x):
        return torch.tanh(x.float() @ self.w)


def get_model(options):
    from nnstreamer_tpu_torch.tensors.spec import TensorsSpec

    return Net(), TensorsSpec.from_strings("4:2", "float32")
'''


def _script(tmp_path, traceable):
    path = tmp_path / f"net_{traceable}.py"
    path.write_text(SCRIPT.format(traceable=traceable))
    return str(path)


def _fused_with_filter(p):
    return [seg for seg in p._executor.plan.segments
            if seg.fused and any(op.name == "f" for op in seg.ops)]


@pytest.mark.parametrize("traceable", [True, False])
def test_script_model_fuses_when_traceable(tmp_path, traceable):
    import importlib.util

    path = _script(tmp_path, traceable)
    desc = ("tensorsrc dimensions=4:2 pattern=counter num-frames=3 ! "
            "tensor_transform mode=typecast option=float32 ! "
            f"tensor_filter name=f framework=torch model={path} ! tensor_sink name=out")
    p = parse_pipeline(desc, device="cpu")
    p.run(timeout=60)
    assert bool(_fused_with_filter(p)) == traceable
    spec = importlib.util.spec_from_file_location("net_check", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    net = mod.Net()
    frames = p["out"].frames
    assert len(frames) == 3
    with torch.no_grad():
        src = parse_pipeline("tensorsrc dimensions=4:2 pattern=counter num-frames=3 ! "
                             "tensor_sink name=out", device="cpu")
        src.run(timeout=60)
        for f, s in zip(frames, src["out"].frames):
            want = net(torch.as_tensor(np.asarray(s.tensors[0])).float())
            np.testing.assert_array_equal(np.asarray(f.tensors[0]), want.numpy())


def test_script_model_through_single_shot(tmp_path):
    path = _script(tmp_path, True)
    x = np.random.default_rng(1).standard_normal((2, 4)).astype(np.float32)
    with SingleShot(framework="torch", model=path, device="cpu") as s:
        (got,) = s.invoke(x)
        assert tuple(s.input_spec[0].shape) == (2, 4)
    with pytest.raises(BackendError, match="no get_model"):
        bad = tmp_path / "bad.py"
        bad.write_text("x = 1\n")
        SingleShot(framework="torch", model=str(bad), device="cpu").open()
    with pytest.raises(BackendError, match="not found"):
        SingleShot(framework="torch", model=str(tmp_path / "none.py"), device="cpu").open()
    assert got.shape == (2, 4) and torch.isfinite(got).all()


@pytest.mark.parametrize("ext", ["stablehlo", "jaxexport", "hlo"])
def test_serialized_jax_programs_are_refused(tmp_path, ext):
    path = tmp_path / f"m.{ext}"
    path.write_bytes(b"\0" * 16)
    with pytest.raises(BackendError, match="serialized JAX program"):
        SingleShot(framework="torch", model=str(path), device="cpu").open()


def test_unknown_source_is_refused(tmp_path):
    with pytest.raises(BackendError, match="unsupported model source"):
        SingleShot(framework="torch", model=str(tmp_path / "m.onnx"), device="cpu").open()


def test_auto_detect_priorities(monkeypatch):
    for k in [k for k in __import__("os").environ if k.startswith("NNS_TPU_FILTER_")]:
        monkeypatch.delenv(k)
    assert registry.detect_filter_framework("m.py") == "custom"
    assert registry.detect_filter_framework("m.tflite") == "tflite"
    assert registry.detect_filter_framework("m.pt") == "torch"
    assert registry.detect_filter_framework("m.pth") == "torch"
    monkeypatch.setenv("NNS_TPU_FILTER_FRAMEWORK_PRIORITY_TFLITE", "nosuch,torch")
    assert registry.detect_filter_framework("m.tflite") == "torch"
    monkeypatch.setenv("NNS_TPU_FILTER_FRAMEWORK_PRIORITY_TFLITE", "nosuch")
    assert registry.detect_filter_framework("m.tflite") is None
