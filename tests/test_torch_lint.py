"""nns-lint of the port (nnstreamer_tpu_torch/analysis/lint.py) against the
JAX package's, on the CPU: the same launch strings through both packages'
``lint()`` (the port's with ``device="cpu"``), the code sets and the
elements they name equal, case for case:

- the reference's bad-pipeline table (every E and W code it covers), the
  collection, review-regression, never-executes, CLI / dot and
  chain-split-deferral cases of tests/test_lint.py;
- the deployment lints the reference pins in other files: W111
  (test_overload.py), W112 (test_device_faults.py), W113 / W116
  (test_ops_device.py), W114 (test_plane.py), W115 / W117 (test_kv_paged.py,
  test_kv_block_attn.py, the serversink's ``kv-memory-bound`` and
  ``[llm] memory_bound``), W118 (test_plane_async.py), W119 / W126
  (test_fleet.py), W130;
- the documented pipelines (docs/ and examples/, as the reference's sweep
  finds them) lint clean in the port, as tests/test_lint.py holds the
  reference (the reference's own lint of them is not repeated here: its
  SSD case alone takes ~25 s);
- the port's own contract: ``lint`` negotiates on the pipeline's device,
  ``cuda`` unless the CPU is asked for, and without a GPU it raises;
  ``nns-launch --check`` and ``nns-lint-torch`` exit 0 / 1 / 2.
"""

import json
import os
import re
import sys

import pytest

from nnstreamer_tpu.analysis import lint as jlint
from nnstreamer_tpu_torch.analysis import Severity, annotated_dot, lint as _lint
from nnstreamer_tpu_torch.device import NoDeviceError
from nnstreamer_tpu_torch.pipeline.parse import parse_pipeline

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_lint import BAD_PIPELINES, CLEAN, _embedded_pipeline_strings  # noqa: E402


def lint(desc):
    return _lint(desc, device="cpu")


def both(desc):
    """(reference result, port result) of one launch string."""
    return jlint(desc), lint(desc)


def _where(diags):
    """(code, element) pairs, an element's auto-number left out: the two
    packages number unnamed elements with counters of their own."""
    return sorted((d.code, re.sub(r"\d+$", "#", d.element or "")) for d in diags)


def _same(desc):
    ref, port = both(desc)
    assert _where(port.diagnostics) == _where(ref.diagnostics), (ref.render(), port.render())
    return ref, port


def _same_codes(desc):
    ref, port = both(desc)
    assert port.codes == ref.codes, (ref.render(), port.render())
    return port


# ------------------------------------------------------ the bad-pipeline table
@pytest.mark.parametrize("description,expected", BAD_PIPELINES,
                         ids=[", ".join(sorted(e)) for _, e in BAD_PIPELINES])
def test_bad_pipeline_table_matches_reference(description, expected):
    port = _same_codes(description)
    assert expected <= set(port.codes) and port.exit_code != 0


@pytest.mark.parametrize("desc", [
    CLEAN,
    # a LINKED error pad: no W107, no W105 for the extra pad
    "tensorsrc dimensions=4 ! tensor_transform name=t mode=typecast option=float32 "
    "on-error=route ! tensor_sink t.src_1 ! tensor_sink name=dlq",
    "tensorsrc dimensions=4 ! tensor_transform mode=typecast option=float32 "
    "on-error=route ! tensor_sink",
    "videotestsrc num-frames=2 ! tee name=t t. ! queue ! tensor_converter ! mux.sink_0 "
    "t. ! queue ! tensor_converter ! mux.sink_1 tensor_mux name=mux ! tensor_sink",
    # collection: three problems in one run
    "tensorsrc bogus=1 ! frobnicator ! tensor_decoder mode=nope ! tensor_sink",
    # every independent caps mismatch, not the first only
    "tensorsrc name=s1 dimensions=4 ! other/tensors,dimensions=(string)8 ! tensor_sink name=k1 "
    "tensorsrc name=s2 dimensions=2 ! other/tensors,dimensions=(string)9 ! tensor_sink name=k2",
    "videotestsrc num-frames=2 ! tensor_converter ! m.sink_5 tensor_mux name=m ! tensor_sink",
    "videotestsrc pattern=RANDOM num-frames=1 ! tensor_converter ! tensor_sink name=out",
    "tensorsrc dimensions=4 silent=maybe num-frames=1 ! tensor_sink",
    "videofilesrc location=/no/such/clip.mp4 ! tensor_converter ! tensor_sink",
    "frobnicator ! tensor_sink",
    "appsrc dimensions=4 ! tensor_llm_serversink id=lint-probe",
], ids=["clean", "routed-pad", "unrouted-pad", "queued-tee", "collection", "caps-x2",
        "pad-5", "upper-enum", "maybe-bool", "ctor-failure", "unknown-source",
        "llm-not-negotiated"])
def test_cases_name_the_same_codes_and_elements(desc):
    _same(desc)


def test_case_details(tmp_path):
    port = lint("tensorsrc dimensions=4 ! tensor_transform mode=typecast option=float32 "
                "on-error=route ! tensor_sink")
    assert "NNS-W107" in port.codes and "NNS-W105" not in port.codes
    port = lint("tensorsrc ! tensor_decoder mode=nope ! tensor_sink")
    (d,) = [x for x in port.diagnostics if x.code == "NNS-E007"]
    assert d.severity is Severity.ERROR and d.element.startswith("tensor_decoder")
    assert "nope" in d.message and d.hint and d.slug == "unknown-decoder"
    port = lint("videotestsrc num-frames=2 ! tensor_converter ! m.sink_5 "
                "tensor_mux name=m ! tensor_sink")
    assert any(d.element == "m" and "sink pad 5" in d.message for d in port.diagnostics)
    port = lint("tensorsrc dimensions=4 silent=maybe num-frames=1 ! tensor_sink")
    assert port.codes == ["NNS-W106"] and port.exit_code == 1
    port = lint("videofilesrc location=/no/such/clip.mp4 ! tensor_converter ! tensor_sink")
    assert "NNS-E011" in port.codes and "NNS-E005" not in port.codes
    port = lint("frobnicator ! tensor_sink")
    assert not any("no source element" in d.message for d in port.diagnostics)


def test_restricted_element_and_plugin_probe(monkeypatch, tmp_path):
    import nnstreamer_tpu.config as jconfig

    monkeypatch.setenv("NNS_TPU_COMMON_RESTRICTED_ELEMENTS", "tensorsrc,tensor_sink")
    jconfig.reload_conf()
    try:
        _same("tensorsrc dimensions=4 ! tensor_transform mode=typecast option=float32 ! "
              "tensor_sink")
        port = _same("tensorsrc dimensions=4 ! frobnicator ! tensor_sink")
        assert "NNS-E004" in port[1].codes
        # a restricted name never runs a plugin file to classify itself
        trap = tmp_path / "nns_element_evilplugin.py"
        trap.write_text("raise SystemExit('plugin executed during probe')\n")
        monkeypatch.setenv("NNS_TPU_COMMON_RESTRICTED_ELEMENTS", "tensorsrc")
        monkeypatch.setenv("NNS_TPU_ELEMENT_PLUGIN_PATHS", str(tmp_path))
        jconfig.reload_conf()
        assert "NNS-E004" in lint("evilplugin ! tensor_sink").codes
    finally:
        monkeypatch.delenv("NNS_TPU_COMMON_RESTRICTED_ELEMENTS")
        monkeypatch.delenv("NNS_TPU_ELEMENT_PLUGIN_PATHS", raising=False)
        jconfig.reload_conf()


def test_llm_serversink_is_never_negotiated():
    from nnstreamer_tpu_torch.elements import llm_serve

    before = dict(llm_serve._table)
    result = lint("appsrc dimensions=4 ! tensor_llm_serversink id=lint-probe")
    assert dict(llm_serve._table) == before and result.exit_code == 0


# ------------------------------------------------------- the pipeline object
def test_lint_never_starts_mutates_or_renumbers(monkeypatch, tmp_path):
    from nnstreamer_tpu_torch.elements.base import Element
    from nnstreamer_tpu_torch.pipeline.graph import Pipeline

    before = dict(Element._instance_counters)
    lint(CLEAN)
    assert dict(Element._instance_counters) == before
    p = parse_pipeline(CLEAN, device="cpu")
    assert lint(p).exit_code == 0
    assert all(not e.out_specs for e in p.elements) and not p._negotiated
    # a started sink keeps its file: the dry run stops only what it opened
    out = tmp_path / "out.bin"
    fp = parse_pipeline(f"tensorsrc dimensions=4 num-frames=2 ! filesink name=fs location={out}",
                        device="cpu")
    fp.negotiate()
    fp["fs"].start()
    try:
        assert lint(fp).exit_code == 0 and not fp["fs"]._file.closed
    finally:
        fp["fs"].stop()

    def boom(self, *a, **k):
        raise AssertionError("lint must not start anything")

    monkeypatch.setattr(Element, "start", boom)
    monkeypatch.setattr(Pipeline, "start", boom)
    assert lint(CLEAN).exit_code == 0


def test_linted_pipeline_still_runs():
    p = parse_pipeline(CLEAN + " name=out", device="cpu")
    assert lint(p).exit_code == 0
    p.run(timeout=60)
    assert p["out"].rendered == 2


def test_lint_runs_on_cuda_unless_the_cpu_is_asked_for(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoDeviceError):
        _lint(CLEAN)
    assert lint(CLEAN).pipeline.device.type == "cpu"


# ----------------------------------------------------------------- CLI + dot
def test_launch_check_and_nns_lint_exit_codes(capsys, monkeypatch):
    import torch

    from nnstreamer_tpu.analysis.cli import main as jmain
    from nnstreamer_tpu_torch.analysis.cli import main
    from nnstreamer_tpu_torch.cli import main as launch

    for argv, rc in (([CLEAN], 0), (["tensorsrc frobnicate=1 ! tensor_sink"], 1),
                     (["tensorsrc ! tensor_decoder mode=nope ! tensor_sink"], 2)):
        assert launch(["--check", "--device", "cpu"] + argv) == rc
        assert main(["--device", "cpu"] + argv) == rc == jmain(argv)
    assert main(["--device", "cpu", "--strict", "tensorsrc frobnicate=1 ! tensor_sink"]) == 2
    assert "NNS-E007" in capsys.readouterr().out
    assert main(["--device", "cpu", "--json", "tensorsrc ! frobnicator ! tensor_sink"]) == 2
    data = json.loads(capsys.readouterr().out)
    assert data["exit_code"] == 2 and any(d["code"] == "NNS-E004" for d in data["diagnostics"])
    assert launch(["--check", "--device", "cpu", "--dot",
                   "tensorsrc dimensions=4 ! other/tensors,dimensions=(string)8 ! "
                   "tensor_sink"]) == 2
    dot = capsys.readouterr().out
    assert "NNS-E003" in dot and "fillcolor" in dot
    assert launch(["--check", "--device", "cpu", "--quiet", CLEAN]) == 0
    assert capsys.readouterr().out == ""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert launch(["--check", CLEAN]) == 2 and main([CLEAN]) == 2
    assert "--device cpu" in capsys.readouterr().err


def test_dot_annotation_and_self_check():
    from nnstreamer_tpu_torch.analysis.selfcheck import self_check

    assert self_check() == []
    dot = annotated_dot(lint("videotestsrc numframes=2 ! tensor_converter ! tensor_sink"))
    assert "NNS-W101" in dot and "fillcolor" in dot
    assert "NNS-E004" in annotated_dot(lint("tensorsrc dimensions=4 ! frobnicator ! tensor_sink"))
    clean = annotated_dot(lint(CLEAN))
    assert "fillcolor" not in clean and "Tensor[" in clean


# ------------------------------------------- W113 / W116 / W120: one code a boundary
HOST_SPLIT = (
    "videotestsrc device=true num-frames=4 width=16 height=16 ! tensor_converter ! "
    "tensor_filter framework=scaler ! tensor_filter name=hostop framework=hostscaler ! "
    "tensor_filter framework=scaler ! fakesink"
)
YOLO_HOST = (
    "tensorsrc dimensions=25:10 types=float32 num-frames=4 ! tensor_filter framework=scaler ! "
    "tensor_decoder mode=bounding_boxes option1=yolov5{pp} ! {tail}"
)


@pytest.mark.parametrize("desc,want,absent", [
    (HOST_SPLIT, "NNS-W120", ("NNS-W113", "NNS-W116")),
    (YOLO_HOST.format(pp="", tail="tensor_filter framework=scaler ! fakesink"), "NNS-W116",
     ("NNS-W120",)),
    (YOLO_HOST.format(pp=" postproc=device", tail="tensor_filter framework=scaler ! fakesink"),
     None, ("NNS-W116", "NNS-W113")),
    (YOLO_HOST.format(pp="", tail="fakesink"), None, ("NNS-W116",)),
    (YOLO_HOST.format(pp=" postproc=device",
                      tail="tensor_filter framework=scaler ! tensor_sink name=out"),
     None, ("NNS-W116",)),
], ids=["w120", "w116", "postproc-device", "chain-tail", "device-clean"])
def test_chain_split_codes(desc, want, absent):
    port = _same_codes(desc)
    assert (want is None and port.exit_code == 0) or want in port.codes
    assert not set(absent) & set(port.codes)


def test_host_element_between_device_filters_is_w113():
    from nnstreamer_tpu import registry as jreg
    from nnstreamer_tpu.elements.base import Element as JElement
    from nnstreamer_tpu_torch import registry
    from nnstreamer_tpu_torch.elements.base import HostElement

    class JHost(JElement):
        def negotiate(self, in_specs):
            return list(in_specs)

        def host_process(self, frame):
            return frame

    class Host(HostElement):
        FACTORY_NAME = "hostpassthru"

        def negotiate(self, in_specs):
            return list(in_specs)

        def process(self, frame):
            return frame

    jreg.register(jreg.KIND_ELEMENT, "hostpassthru", JHost)
    registry.register(registry.KIND_ELEMENT, "hostpassthru", Host)
    try:
        port = _same_codes(
            "videotestsrc device=true width=16 height=16 ! tensor_converter ! "
            "tensor_filter framework=scaler ! hostpassthru ! tensor_filter framework=scaler ! "
            "fakesink")
        assert "NNS-W113" in port.codes and "NNS-W120" not in port.codes
    finally:
        jreg.unregister(jreg.KIND_ELEMENT, "hostpassthru")
        registry.unregister(registry.KIND_ELEMENT, "hostpassthru")


# ---------------------------------------------------- the deployment lints
SERVER = "tensor_query_serversrc port=5001 {b} ! tensor_query_serversink"
CLIENT = ("tensorsrc dimensions=4 num-frames=4 ! tensor_query_client dest-port=5001 {x} ! "
          "tensor_sink")
DRAIN = ("tensor_query_serversrc id=w6 port=5097 max-clients=4 retry-after-ms=25 ! "
         "tensor_llm_serversink id=w6l model=zoo:transformer_lm kv-layout=paged "
         "block-size=16 kv-blocks=64{extra}")
REPLICA = "tensorsrc dimensions=4 num-frames=10 ! tensor_filter framework=faulty {x} ! tensor_sink"
SHARED = ("tensorsrc dimensions=4 ! tee name=t "
          "t. ! queue ! tensor_filter framework={fw} model=/no/model.bin {fix} name=a ! "
          "tensor_sink "
          "t. ! queue ! tensor_filter framework={fw} model=/no/model.bin {fix} name=b ! "
          "tensor_sink")
PLANE = ("tensorsrc dimensions=4 num-frames=1 ! tensor_filter framework=scaler "
         "custom=factor:2.0 {x} ! tensor_sink")
KV = ("tensorsrc dimensions=4 types=int32 num-frames=1 ! tensor_llm_serversink id=91 "
      "n-slots=64 max-len=2048 {x}")
ROLE = ("tensorsrc dimensions=4 types=int32 num-frames=1 ! tensor_llm_serversink id=93 "
        "kv-layout=paged role=prefill {x}")

DEPLOY = [
    ("W111", SERVER.format(b=""), True), ("W111", SERVER.format(b="max-inflight=8"), False),
    ("W119", CLIENT.format(x="deadline-ms=200"), True),
    ("W119", CLIENT.format(x="deadline-ms=200 retry-max=3"), False),
    ("W119", CLIENT.format(x="deadline-ms=200 hosts=127.0.0.1:5001,127.0.0.1:5002"), False),
    ("W119", CLIENT.format(x=""), False),
    ("W126", DRAIN.format(extra=""), True),
    ("W126", DRAIN.format(extra=" migrate-to=127.0.0.1:7001"), False),
    ("W126", DRAIN.format(extra=" checkpoint-dir=/var/nns/spans"), False),
    ("W126", DRAIN.format(extra=" plane=lp0"), False),
    ("W126", DRAIN.format(extra="").replace("retry-after-ms=25 ", ""), False),
    ("W112", REPLICA.format(x="replicas=2"), True),
    ("W112", REPLICA.format(x="replicas=2 on-error=drop"), False),
    ("W112", REPLICA.format(x=""), False),
    ("W114", SHARED.format(fw="{fw}", fix=""), True),
    ("W114", SHARED.format(fw="{fw}", fix="plane=p"), False),
    ("W114", SHARED.format(fw="{fw}", fix="shared-tensor-filter-key=k"), False),
    ("W118", PLANE.format(x="plane=w1") + " " + PLANE.format(x="plane=w1"), True),
    ("W118", PLANE.format(x="plane=w2 ring-depth=3 batching=false"), True),
    ("W118", PLANE.format(x="plane=w3"), False),
    ("W118", PLANE.format(x="plane=w4 ring-depth=2") + " "
     + PLANE.format(x="plane=w4 ring-depth=2"), False),
    ("W115", KV.format(x="kv-memory-bound=64M"), True),
    ("W115", KV.format(x="kv-memory-bound=64M kv-layout=paged"), False),
    ("W115", KV.format(x=""), False),
    ("W115", KV.format(x="kv-memory-bound=64G"), False),
    ("W117", KV.format(x="kv-layout=paged kv-attn=gather kv-memory-bound=64M"), True),
    ("W117", KV.format(x="kv-layout=paged kv-memory-bound=64M"), False),
    ("W117", KV.format(x="kv-layout=paged kv-attn=gather"), False),
    ("W117", KV.format(x="kv-layout=paged kv-attn=gather kv-memory-bound=64G"), False),
    ("W130", ROLE.format(x=""), True),
    ("W130", ROLE.format(x="decode-peers=127.0.0.1:7001"), False),
    ("W130", ROLE.format(x="checkpoint-dir=/var/nns/spans"), False),
]


@pytest.mark.parametrize("code,desc,fires", DEPLOY,
                         ids=[f"{c}-{'fires' if f else 'quiet'}-{i}"
                              for i, (c, _, f) in enumerate(DEPLOY)])
def test_deployment_lints_match_reference(code, desc, fires):
    ref = jlint(desc.replace("{fw}", "jax"))
    port = lint(desc.replace("{fw}", "torch"))
    assert port.codes == ref.codes, (ref.render(), port.render())
    assert (f"NNS-{code}" in port.codes) == fires
    if fires:
        assert port.exit_code == 1 or "NNS-W102" in port.codes


def test_kv_bound_from_config(monkeypatch):
    """``[llm] memory_bound`` stands in for an element without
    kv-memory-bound, in both packages."""
    import nnstreamer_tpu.config as jconfig

    monkeypatch.setenv("NNS_TPU_LLM_MEMORY_BOUND", "64M")
    jconfig.reload_conf()
    try:
        port = _same_codes(KV.format(x=""))
        assert "NNS-W115" in port.codes
    finally:
        monkeypatch.delenv("NNS_TPU_LLM_MEMORY_BOUND")
        jconfig.reload_conf()


# ------------------------------------------------------- documented pipelines
DOCUMENTED = _embedded_pipeline_strings()


def test_sweep_finds_pipelines():
    assert len(DOCUMENTED) >= 5


@pytest.mark.parametrize("source,description", DOCUMENTED,
                         ids=[f"{s}:{d[:40]}" for s, d in DOCUMENTED])
def test_documented_pipeline_lints_clean(source, description):
    port = lint(description)
    assert port.codes == [] and port.exit_code == 0, f"{source}: {port.render()}"
