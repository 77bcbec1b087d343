"""The port's element props and CLI against the JAX package's.

- Element props the port used to refuse: ``tensor_sink signal-rate=`` and
  ``sync=``, ``fakesink sync-device=``, ``tensor_transform
  impl=auto|jnp|pallas`` (the element picks K1 or the plain op),
  ``tensor_filter output=`` / ``outputtype=`` / ``outputname=`` and
  ``is-updatable=``: each pipeline string through both CLIs in process,
  comparing the exit code and the sinks' output.
- The CLI in subprocesses (all started at once): ``--timeout`` on a
  pipeline that does not end (rc 0, "Timeout reached after", the sinks'
  counts), ``--inspect`` with and without an element, ``--dot``,
  ``--version``, and no description (rc 2), rc and output against the
  reference's.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from nnstreamer_tpu import cli as jcli
from nnstreamer_tpu.elements.sink import TensorSink as JSink
from nnstreamer_tpu_torch import cli
from nnstreamer_tpu_torch.elements.sink import TensorSink
from nnstreamer_tpu_torch.ops.kernels import image_kernels
from nnstreamer_tpu_torch.pipeline.parse import parse_pipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROP_STRINGS = {
    "sink_signal_rate_sync": (
        "videotestsrc pattern=counter num-frames=3 width=8 height=8 ! tensor_converter ! "
        "tee name=t t. ! queue ! tensor_sink signal-rate=10 sync=true "
        "t. ! queue ! filesink location={out}"
    ),
    "fakesink_sync_device": (
        "videotestsrc pattern=counter num-frames=3 width=8 height=8 ! tensor_converter ! "
        "tee name=t t. ! queue ! fakesink sync-device=false t. ! queue ! filesink location={out}"
    ),
    "transform_impl_auto": (
        "videotestsrc pattern=gradient num-frames=2 width=32 height=24 ! tensor_converter ! "
        "tensor_transform mode=resize option=16:12 impl=auto ! filesink location={out}"
    ),
    "transform_impl_jnp": (
        "videotestsrc pattern=gradient num-frames=2 width=32 height=24 ! tensor_converter ! "
        "tensor_transform mode=resize option=16:12 impl=jnp ! filesink location={out}"
    ),
    "transform_impl_pallas": (
        "videotestsrc pattern=gradient num-frames=2 width=32 height=24 ! tensor_converter ! "
        "tensor_transform mode=resize option=16:12 impl=pallas ! filesink location={out}"
    ),
    "filter_output_override": (
        "tensorsrc dimensions=4 pattern=counter num-frames=3 ! "
        "tensor_filter framework=scaler custom=factor:2.0 output=4 outputtype=float32 "
        "outputname=y is-updatable=true ! filesink location={out}"
    ),
}


@pytest.mark.parametrize("name", sorted(PROP_STRINGS))
def test_prop_strings_through_both_clis(name, tmp_path, capsys):
    outs = {}
    for pkg, main, extra in (("port", cli.main, ["--device", "cpu"]), ("jax", jcli.main, [])):
        out = tmp_path / f"{pkg}.raw"
        rc = main(extra + [PROP_STRINGS[name].format(out=out)])
        err = capsys.readouterr().err
        # the sinks' counts (names carry per-package instance numbers; the
        # port's filesink also counts, the reference's does not)
        rendered = sorted(l.split(":", 1)[1].strip() for l in err.splitlines()
                          if "rendered" in l and not l.strip().startswith("filesink"))
        outs[pkg] = (rc, out.read_bytes(), rendered)
    assert outs["port"] == outs["jax"]
    assert outs["port"][0] == 0 and len(outs["port"][1]) > 0


def test_transform_impl_chooses_the_kernel_or_the_plain_op(monkeypatch):
    """impl=jnp never reaches the K1 wrapper; auto and pallas do."""
    calls = []
    real = image_kernels.resize_bilinear

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(image_kernels, "resize_bilinear", spy)
    got = {}
    for impl in ("auto", "jnp", "pallas"):
        calls.clear()
        p = parse_pipeline(
            "videotestsrc pattern=gradient num-frames=2 width=32 height=24 ! tensor_converter ! "
            f"tensor_transform mode=resize option=16:12 impl={impl} ! tensor_sink name=o",
            device="cpu")
        p.run(timeout=30)
        got[impl] = (len(calls) > 0, [f.tensors[0].tobytes() for f in p["o"].frames])
    assert [got[i][0] for i in ("auto", "jnp", "pallas")] == [True, False, True]
    assert got["auto"][1] == got["jnp"][1] == got["pallas"][1]
    with pytest.raises(ValueError, match="impl"):
        parse_pipeline("videotestsrc ! tensor_converter ! tensor_transform mode=resize "
                       "option=4:4 impl=cuda ! fakesink", device="cpu")


def test_signal_rate_limits_callbacks_like_the_reference():
    """Three frames inside one interval: all stored, one callback."""
    from nnstreamer_tpu.tensors.frame import Frame as JFrame
    from nnstreamer_tpu_torch.tensors.frame import Frame

    counts = []
    for sink, frame in ((TensorSink(**{"signal-rate": "1"}), Frame),
                        (JSink(**{"signal-rate": "1"}), JFrame)):
        n = []
        sink.connect("new-data", lambda f: n.append(1))
        for i in range(3):
            sink.render(frame((np.full(2, i, np.float32),)))
        counts.append((len(sink.frames), len(n), sink.rendered))
    assert counts[0] == counts[1] == (3, 1, 3)


# -- the CLI in subprocesses ----------------------------------------------------

ENDLESS = "videotestsrc num-frames=-1 width=16 height=16 ! tensor_converter ! fakesink"
DOT = "videotestsrc num-frames=2 width=16 height=16 ! tensor_converter ! tensor_sink"
CLI_CASES = {
    "timeout": ["--timeout", "2", ENDLESS],
    "inspect": ["--inspect"],
    "inspect_element": ["--inspect", "tensor_filter"],
    "dot": ["--dot", DOT],
    "version": ["--version"],
    "no_description": [],
}


@pytest.fixture(scope="module")
def cli_runs():
    """Every case through both CLIs, all processes started at once →
    {(case, pkg): (rc, stdout, stderr)}."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    procs = {}
    for case, args in CLI_CASES.items():
        for pkg in ("nnstreamer_tpu_torch", "nnstreamer_tpu"):
            extra = ["--device", "cpu"] if pkg == "nnstreamer_tpu_torch" and case in (
                "timeout", "dot") else []
            procs[(case, pkg)] = subprocess.Popen(
                [sys.executable, "-m", f"{pkg}.cli", *extra, *args], cwd=REPO, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {}
    for key, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=180)
        out[key] = (proc.returncode, stdout, stderr)
    return out


def _pair(cli_runs, case):
    return cli_runs[(case, "nnstreamer_tpu_torch")], cli_runs[(case, "nnstreamer_tpu")]


def test_timeout_on_an_endless_pipeline_exits_zero(cli_runs):
    port, ref = _pair(cli_runs, "timeout")
    for rc, _, err in (port, ref):
        assert rc == 0, err
        assert "Timeout reached after" in err and "fakesink0: rendered" in err
        assert "Traceback" not in err


@pytest.mark.parametrize("case", ["inspect", "inspect_element", "version"])
def test_inspect_and_version_like_the_reference(cli_runs, case):
    port, ref = _pair(cli_runs, case)
    assert port[0] == ref[0] == 0, (port[2], ref[2])
    if case == "inspect":
        for _, out, _ in (port, ref):
            assert out.startswith("Available elements:")
            assert "tensor_filter" in out and "Available filter backends:" in out
    elif case == "inspect_element":
        assert port[1].startswith("Element: tensor_filter\n") and ref[1].startswith(
            "Element: tensor_filter\n")
    else:
        assert port[1].startswith("nns-launch ") and ref[1].startswith("nns-launch ")


def test_dot_like_the_reference(cli_runs):
    port, ref = _pair(cli_runs, "dot")
    assert port[0] == ref[0] == 0 and port[1] == ref[1]
    assert port[1].startswith('digraph "pipeline" {')


def test_no_description_is_a_usage_error(cli_runs):
    port, ref = _pair(cli_runs, "no_description")
    assert port[0] == ref[0] == 2
    for _, _, err in (port, ref):
        assert err.rstrip().endswith("nns-launch: error: pipeline description required")
