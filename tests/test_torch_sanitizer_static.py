"""nns-san's static half in the port (analysis/racecheck.py, san_cli.py,
lint's deadlock pass, the self-checks) against the JAX package's, on the
CPU: the race lint's seeded fixture and waivers (the reference's
TestRaceLint), the port package clean (its executor's frame counter now
changes in ONE method), the graph deadlock / capacity codes through both
packages (TestDeadlockPass; the W108 channel depth is the port's own:
a queue stays a node), the CLI (TestCliAndSelfCheck), and every
self-check of the port passing.
"""

import json
import os
import sys
from collections import Counter

import pytest

from nnstreamer_tpu.analysis import lint as jlint
from nnstreamer_tpu.analysis.racecheck import run_race_lint as jrace
from nnstreamer_tpu_torch.analysis import lint as _lint
from nnstreamer_tpu_torch.analysis.racecheck import run_race_lint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
from test_sanitizer import EXPECTED_SEEDED, FIXTURE  # noqa: E402


def lint(desc):
    return _lint(desc, device="cpu")


# ---------------------------------------------------------------- race lint
def test_seeded_fixture_yields_the_reference_findings():
    report, ref = run_race_lint([FIXTURE]), jrace([FIXTURE])
    assert dict(Counter(d.code for d in report.diagnostics)) == EXPECTED_SEEDED
    assert [(d.code, d.element) for d in report.diagnostics] == [
        (d.code, d.element) for d in ref.diagnostics]
    assert report.exit_code == 2
    for d in report.diagnostics:
        path, _, line = d.element.rpartition(":")
        assert path.endswith("seeded_races.py") and line.isdigit()


def test_waiver_and_condition_wait(tmp_path):
    bad = ("import threading\nimport time\n_lock = threading.Lock()\ndef f():\n"
           "    with _lock:\n        time.sleep(1.0)  # nns-san: ok - startup only\n")
    p = tmp_path / "w.py"
    p.write_text(bad)
    assert run_race_lint([str(p)]).diagnostics == []
    p.write_text(bad.replace("  # nns-san: ok - startup only", ""))
    assert [d.code for d in run_race_lint([str(p)]).diagnostics] == ["NNS-R002"]
    p.write_text("import threading\n_cv = threading.Condition()\ndef f(pred):\n"
                 "    with _cv:\n        _cv.wait()\n")
    assert run_race_lint([str(p)]).diagnostics == []


def test_port_package_is_clean_and_its_frame_counter_has_one_writer(capsys):
    """NNS-R001 flagged ``_Node.stat`` and ``_Node.stat_batch`` (two methods
    doing ``self.frames_processed +=``); both now call ``_Node._advance``."""
    import inspect

    from nnstreamer_tpu_torch.analysis.san_cli import main
    from nnstreamer_tpu_torch.pipeline.executor import _Node

    assert main(["--race", os.path.join(REPO, "nnstreamer_tpu_torch")]) == 0, \
        capsys.readouterr().out
    assert main(["--race"]) == 0  # default: the installed port package
    src = inspect.getsource(_Node)
    assert src.count("self.frames_processed +=") == 1
    assert "self._advance(1)" in inspect.getsource(_Node.stat)
    assert "self._advance(n)" in inspect.getsource(_Node.stat_batch)
    for line in src.splitlines():
        if "frames_processed +=" in line:
            assert "nns-san" not in line and "noqa" not in line


# ------------------------------------------------------------ deadlock pass
@pytest.mark.parametrize("desc,code,fires", [
    ("tensorsrc dimensions=4 ! tensor_sink queue-size=0", "W108", True),
    ("tensorsrc dimensions=4 ! tensor_filter framework=scaler batching=true max-batch=8 "
     "queue-size=4 ! tensor_sink", "W108", True),
    ("tensorsrc dimensions=4,4 num-tensors=2 ! tensor_demux name=d d.src_0 ! mux.sink_0 "
     "d.src_1 ! mux.sink_1 tensor_mux name=mux ! tensor_sink", "W109", True),
    ("tensorsrc dimensions=4,4 num-tensors=2 ! tensor_demux name=d d.src_0 ! queue ! mux.sink_0 "
     "d.src_1 ! queue ! mux.sink_1 tensor_mux name=mux ! tensor_sink", "W109", False),
    ("tensorsrc dimensions=4 ! tee name=t t. ! queue ! tensor_if supplied-value=0.5 ! "
     "mux.sink_0 t. ! queue ! mux.sink_1 tensor_mux name=mux ! tensor_sink", "W110", True),
    ("tensorsrc dimensions=4 ! tee name=t t. ! queue ! tensor_if supplied-value=0.5 ! "
     "mux.sink_0 t. ! queue ! mux.sink_1 tensor_mux name=mux sync-mode=nosync ! tensor_sink",
     "W110", False),
    ("tensorsrc dimensions=4 ! tee name=t t. ! queue ! tensor_if supplied-value=0.5 ! "
     "mux.sink_0 t. ! queue ! tensor_if supplied-value=0.5 ! mux.sink_1 tensor_mux name=mux ! "
     "tensor_sink", "W110", False),
], ids=["w108-nonpositive", "w108-starved", "w109", "w109-queued",
        "w110", "w110-nosync", "w110-symmetric"])
def test_deadlock_codes_match_reference(desc, code, fires):
    ref, port = jlint(desc), lint(desc)
    assert port.codes == ref.codes, (ref.render(), port.render())
    assert (f"NNS-{code}" in port.codes) == fires


def test_w108_reads_the_consumers_own_channel():
    """Departure: the reference eliminates a 1-in/1-out queue into its
    consumer's channel (depth 4 starves max-batch 8); the port keeps the
    queue a node, so the batching filter collects from its own 64-deep
    inbox."""
    desc = ("tensorsrc dimensions=4 ! queue max-size-buffers=4 ! tensor_filter "
            "framework=scaler batching=true max-batch=8 ! tensor_sink")
    assert "NNS-W108" in jlint(desc).codes
    assert "NNS-W108" not in lint(desc).codes
    # and the other way: a wide queue does not widen the filter's own inbox
    desc = ("tensorsrc dimensions=4 ! queue max-size-buffers=32 ! tensor_filter "
            "framework=scaler batching=true max-batch=16 queue-size=8 ! tensor_sink")
    assert "NNS-W108" not in jlint(desc).codes
    assert "NNS-W108" in lint(desc).codes


# --------------------------------------------------------------------- CLI
def test_nns_san_cli(capsys, monkeypatch):
    import torch

    from nnstreamer_tpu_torch.analysis.lint import DEADLOCK_CODES
    from nnstreamer_tpu_torch.analysis.san_cli import main

    assert main(["--json", "--race", FIXTURE]) == 2
    data = json.loads(capsys.readouterr().out)
    assert {d["code"] for d in data["diagnostics"]} == set(EXPECTED_SEEDED)
    assert all(d["where"].endswith(tuple("0123456789")) for d in data["diagnostics"])
    desc = "tensorsrc dimensions=4 bogus=1 ! tensor_sink queue-size=-2"
    assert main(["--json", "--device", "cpu", "--deadlock", desc]) == 1
    codes = {d["code"] for d in json.loads(capsys.readouterr().out)["diagnostics"]}
    assert codes == {"NNS-W108"} and codes <= DEADLOCK_CODES
    assert main(["--strict", "--device", "cpu", "--deadlock",
                 "tensorsrc dimensions=4 ! tensor_sink queue-size=0"]) == 2
    assert main(["--self-check"]) == 0, capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["--deadlock", "tensorsrc dimensions=4 ! tensor_sink"]) == 2


def test_nns_lint_strict_promotes_warnings():
    from nnstreamer_tpu_torch.analysis.cli import main

    assert main(["--device", "cpu", "tensorsrc frobnicate=1 ! tensor_sink"]) == 1
    assert main(["--device", "cpu", "--strict", "tensorsrc frobnicate=1 ! tensor_sink"]) == 2
    assert main(["--device", "cpu", "--strict", "tensorsrc dimensions=4 num-frames=2 ! "
                 "tensor_transform mode=typecast option=float32 ! tensor_sink"]) == 0


# -------------------------------------------------------------- self-checks
@pytest.mark.parametrize("check", ["self_check", "san_self_check", "obs_self_check",
                                   "xray_self_check", "kscope_self_check", "disagg_self_check"])
def test_every_self_check_of_the_port_passes(check):
    from nnstreamer_tpu_torch.analysis import selfcheck

    problems = getattr(selfcheck, check)()
    assert problems == [], "\n".join(problems)


def test_self_checks_catch_drift(monkeypatch):
    """The catalog check is as strict as the reference's: a cataloged code
    with no emitter, and an emitted code with no entry, are both reported."""
    from nnstreamer_tpu_torch.analysis import diagnostics, selfcheck

    cat = dict(diagnostics.CATALOG)
    cat["NNS-W199"] = (diagnostics.Severity.WARNING, "no-such", "never emitted")
    del cat["NNS-W130"]
    monkeypatch.setattr(diagnostics, "CATALOG", cat)
    problems = selfcheck.san_self_check()
    assert "catalog code NNS-W199 has no emitter in the code" in problems
    assert "code NNS-W130 is emitted but not in the catalog" in problems


@pytest.mark.parametrize("check", ["san_self_check", "obs_self_check", "xray_self_check",
                                   "kscope_self_check", "disagg_self_check"])
def test_self_checks_fail_without_the_ports_text(monkeypatch, check):
    """A self-check that reads the README's port section fails when the
    section is missing: it never passes having checked no text."""
    from nnstreamer_tpu_torch.analysis import selfcheck

    monkeypatch.setattr(selfcheck, "_PORT_HEADING", "## No such section")
    problems = getattr(selfcheck, check)()
    assert any("'No such section' section" in p for p in problems), problems
