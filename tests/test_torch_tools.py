"""Port parity for the rest of ``tools/``: pbtxt, confchk, gendoc and
codegen against the JAX package's tools on the same inputs.

- pbtxt: the text equal to the reference's, byte for byte, on the same
  descriptions (named elements, so instance counters do not enter).
- confchk: the exit code and the warnings and errors equal to the
  reference's on the same ini files (sections both configs know).
- gendoc: every element, backend, decoder and converter the port
  registers has its heading.
- codegen: each scaffold loads through the port's own plugin paths and
  runs.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from nnstreamer_tpu.tools import confchk as jconfchk
from nnstreamer_tpu.tools import pbtxt as jpbtxt
from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.pipeline.parse import parse_pipeline
from nnstreamer_tpu_torch.single import SingleShot
from nnstreamer_tpu_torch.tools import codegen, confchk, gendoc, pbtxt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DESCRIPTIONS = [
    "videotestsrc name=src num-frames=2 width=32 height=24 ! tensor_converter name=conv ! "
    "tensor_sink name=out",
    "videotestsrc name=v num-frames=2 ! tensor_converter name=c ! tee name=t "
    "t. ! queue name=q0 ! mux.sink_0 t. ! queue name=q1 ! mux.sink_1 "
    "tensor_mux name=mux sync-mode=nosync ! tensor_demux name=d "
    "d.src_0 ! tensor_sink name=a d.src_1 ! tensor_sink name=b",
    "videotestsrc name=v num-frames=1 ! tensor_converter name=c ! "
    "tensor_transform name=tr mode=resize option=32:32 ! "
    'tensor_filter name=f framework=jax model=zoo:mobilenet_v2 custom="size:32,num_classes:4" ! '
    "tensor_decoder name=dec mode=image_labeling ! fakesink name=sink",
]


@pytest.mark.parametrize("desc", DESCRIPTIONS, ids=["linear", "tee-mux-demux", "filter"])
def test_pbtxt_equals_reference(desc):
    assert pbtxt.to_pbtxt(desc) == jpbtxt.to_pbtxt(desc)


def _ini(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


@pytest.mark.parametrize("case", ["default", "unknown-keys", "missing-dir", "bad-priority"])
def test_confchk_findings_and_exit_codes_equal_reference(tmp_path, case, monkeypatch):
    for k in list(os.environ):
        if k.startswith("NNS_TPU_"):
            monkeypatch.delenv(k)
    ini = {
        "default": None,
        "unknown-keys": _ini(tmp_path, "bad.ini",
                             "[filter]\nbogus_key = 1\n\n[nosuchsection]\nx = y\n"),
        "missing-dir": _ini(tmp_path, "paths.ini",
                            "[filter]\nplugin_paths = /definitely/not/here\n"),
        "bad-priority": _ini(tmp_path, "prio.ini",
                             "[filter]\nframework_priority_tflite = nosuch\n"),
    }[case]
    want = {"default": 0, "unknown-keys": 1, "missing-dir": 2, "bad-priority": 1}[case]
    _, warnings, errors = confchk.check(ini)
    _, jwarnings, jerrors = jconfchk.check(ini)
    assert (warnings, errors) == (jwarnings, jerrors)
    argv = [ini] if ini else []
    assert confchk.main(argv + ["-q"]) == jconfchk.main(argv + ["-q"]) == want


def test_confchk_reports_the_new_priorities():
    info, _, _ = confchk.check()
    assert "priority .tflite → tflite: available" in info
    assert "priority .tflite → torch: available" in info
    assert "priority .py → custom: available" in info


def test_gendoc_names_every_registered_subplugin():
    text = gendoc.generate()
    for kind in registry.KINDS:
        for name in registry.available(kind):
            assert f"### `{name}`" in text, (kind, name)
    for name in ("tflite", "torch", "jax", "custom"):
        assert f"### `{name}`" in text


def test_codegen_filter_scaffold_runs(tmp_path):
    path = codegen.generate("filter", "my_op", str(tmp_path))
    assert os.path.basename(path) == "my_op.py"
    data = np.arange(6, dtype=np.float32).reshape(2, 3)
    with SingleShot(framework="custom", model=path, device="cpu") as s:
        (out,) = s.invoke(data)
    np.testing.assert_array_equal(out.numpy(), data)
    src = open(path).read()
    assert "import torch" in src and "jax" not in src


def test_codegen_decoder_and_converter_load_through_plugin_paths(tmp_path, monkeypatch):
    dec = codegen.generate("decoder", "my_dec", str(tmp_path))
    conv = codegen.generate("converter", "my_conv", str(tmp_path))
    assert os.path.basename(dec) == "nns_decoder_my_dec.py"
    assert os.path.basename(conv) == "nns_converter_my_conv.py"
    monkeypatch.setenv("NNS_TPU_DECODER_PLUGIN_PATHS", str(tmp_path))
    monkeypatch.setenv("NNS_TPU_CONVERTER_PLUGIN_PATHS", str(tmp_path))
    try:
        p = parse_pipeline(
            "videotestsrc pattern=counter num-frames=2 width=4 height=4 ! tensor_converter ! "
            "tensor_decoder mode=my_dec ! tensor_sink name=out", device="cpu")
        p.run(timeout=60)
        frames = p["out"].frames
        assert len(frames) == 2
        raw = np.asarray(frames[0].tensors[0])
        assert raw.dtype == np.uint8 and raw.size == 4 * 4 * 3
        cls = registry.get(registry.KIND_CONVERTER, "my_conv")
        assert cls.__name__ == "MyConvConverter"
    finally:
        registry.unregister(registry.KIND_DECODER, "my_dec")
        registry.unregister(registry.KIND_CONVERTER, "my_conv")


def test_codegen_rejects_bad_input(tmp_path):
    with pytest.raises(ValueError):
        codegen.generate("filter", "bad-name", str(tmp_path))
    with pytest.raises(ValueError):
        codegen.generate("nope", "ok_name", str(tmp_path))
    codegen.generate("filter", "dup", str(tmp_path))
    with pytest.raises(FileExistsError):
        codegen.generate("filter", "dup", str(tmp_path))


def test_tool_entry_points(tmp_path):
    """Each tool as ``python -m nnstreamer_tpu_torch.tools.<name>``, all
    started at once."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("NNS_TPU_")}
    runs = {
        "pbtxt": ["videotestsrc ! tensor_converter ! tensor_sink"],
        "confchk": ["-q"],
        "gendoc": ["-o", str(tmp_path / "elements.md")],
        "codegen": ["filter", "cli_op", "-o", str(tmp_path)],
    }
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", f"nnstreamer_tpu_torch.tools.{name}", *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO, env=env)
        for name, args in runs.items()}
    out = {name: (p.wait(timeout=120), p.stdout.read()) for name, p in procs.items()}
    assert out["pbtxt"][0] == 0 and 'calculator: "tensor_converter"' in out["pbtxt"][1]
    assert out["confchk"][0] == 0
    assert out["gendoc"][0] == 0 and "### `tensor_filter`" in (tmp_path / "elements.md").read_text()
    assert out["codegen"][0] == 0 and (tmp_path / "cli_op.py").is_file()
