"""nns-xray of the port (nnstreamer_tpu_torch/analysis/xray.py, the rest of
analysis/costmodel.py, Executor.transfer_crosscheck) on the CPU:

- compile units: the same chains, segments and W120 / W125 verdicts as the
  JAX package's ``xray()`` on the reference's strings (tests/test_xray.py);
- the transfer model: the port's plan (its executor's semantics: a ring
  fetches for ``WANTS_HOST`` consumers and converter subplugins, a reading
  sink fetches, a per-frame segment or a compiled chain stages on the
  card) held to the run's tally by ``transfer_crosscheck`` with delta 0 on
  every pipeline here, at stop() too under ``NNS_XRAY_CROSSCHECK``; where
  no departure applies, equal to the reference's prediction;
- the program lint over fake-tensor traces: host reads and uncapturable
  ops (W120), float64 promotion and output drift (W122), cache keys
  (W121), the device bound (W124); NNS-W123 has no counterpart;
- the dispatch table on the CPU (every entry point takes its plain
  version; the card's run reads the kernels), the CLI, degraded results.
"""

import importlib
import json
import re

import numpy as np
import pytest
import torch

from nnstreamer_tpu.analysis.xray import xray as jxray
from nnstreamer_tpu_torch.analysis import CATALOG
from nnstreamer_tpu_torch.analysis.costmodel import (
    plan_transfer_boundaries,
    predict_frame_transfers,
    spec_bytes,
    trace_program,
)
from nnstreamer_tpu_torch.analysis.diagnostics import LintReport
from nnstreamer_tpu_torch.pipeline.batching import BatchConfig
from nnstreamer_tpu_torch.pipeline.parse import parse_pipeline

xr = importlib.import_module("nnstreamer_tpu_torch.analysis.xray")

ONE_CHAIN = (
    "videotestsrc device=true num-frames=4 width=16 height=16 ! "
    "tensor_converter ! tensor_filter framework=scaler ! queue ! "
    "tensor_filter framework=scaler ! fakesink"
)
HOST_SPLIT = (
    "videotestsrc device=true num-frames=4 width=16 height=16 ! "
    "tensor_converter ! tensor_filter framework=scaler ! "
    "tensor_filter name=hostop framework=hostscaler ! "
    "tensor_filter framework=scaler ! fakesink"
)
SEG_DESC = ("tensorsrc dimensions=16 types=float32 num-frames=1 ! tensor_filter framework=scaler ! "
            "fakesink")
CHAIN3 = (
    "tensorsrc dimensions=8:8 pattern=counter num-frames=11 ! "
    "tensor_transform mode=arithmetic option=add:1.0 ! queue ! "
    "tensor_transform mode=arithmetic option=mul:2.0 ! queue ! "
    "tensor_transform mode=arithmetic option=add:0.5 ! tensor_sink"
)
FRAME_BYTES = 16 * 16 * 3


def xray(desc, **kw):
    return xr.xray(desc, device="cpu", **kw)


def _seg(desc=SEG_DESC):
    return parse_pipeline(desc, device="cpu").compile_plan().segments[0]


# ------------------------------------------------------- chain inference
@pytest.mark.parametrize("desc", [ONE_CHAIN, HOST_SPLIT, CHAIN3,
                                  ONE_CHAIN.replace("fakesink", "tensor_sink")],
                         ids=["one-chain", "host-split", "three-segments", "reading-sink"])
def test_compile_units_match_reference(desc):
    r, j = xray(desc), jxray(desc)
    assert not r.degraded and not r.errors

    def shape(chains):  # segment names with the auto-numbering left out
        return [[re.sub(r"\d+", "", seg) for seg in c.segments] for c in chains]

    assert shape(r.chains) == shape(j.chains)
    assert [c.n_ops for c in r.chains] == [c.n_ops for c in j.chains]
    assert r.codes == j.codes
    assert [c.cost.activation_bytes for c in r.chains] == [c.cost.activation_bytes
                                                           for c in j.chains]


def test_host_split_names_both_chains():
    r = xray(HOST_SPLIT)
    assert len(r.chains) == 2
    (w120,) = [d for d in r.diagnostics if d.code == "NNS-W120"]
    assert w120.element == "hostop" and all(c.name in w120.message for c in r.chains)


def test_plan_chains_partition_segments():
    plan = parse_pipeline(ONE_CHAIN, device="cpu").compile_plan()
    members = [id(s) for ch in plan.chains() for s in ch.segments]
    assert sorted(members) == sorted(id(s) for s in plan.segments if s.fused)
    assert len(members) == len(set(members))


def test_w125_fires_only_when_configured_off(monkeypatch):
    monkeypatch.setenv("NNS_TPU_EXECUTOR_CHAIN_MODE", "off")
    r, j = xray(CHAIN3), jxray(CHAIN3)
    assert "NNS-W125" in r.codes and r.codes == j.codes
    assert [c.compiled for c in r.chains] == ["no: chain_mode=off"]
    monkeypatch.setenv("NNS_TPU_EXECUTOR_CHAIN_MODE", "auto")
    r = xray(CHAIN3)
    assert "NNS-W125" not in r.codes and [c.compiled for c in r.chains] == ["yes (unroll 4)"]


# ---------------------------------- the transfer model against the tally
CROSSCHECK = [
    ONE_CHAIN, HOST_SPLIT, CHAIN3,
    ONE_CHAIN.replace("fakesink", "tensor_sink"),
    ONE_CHAIN.replace("videotestsrc device=true ", "videotestsrc "),
    "videotestsrc num-frames=3 width=64 height=48 ! tensor_converter ! "
    "tensor_transform mode=resize option=32:32 ! tensor_filter framework=torch "
    "model=zoo:mobilenet_v2 custom=size:32 ! tensor_decoder mode=image_labeling ! tensor_sink",
    "videotestsrc num-frames=3 width=16 height=16 ! tensor_converter ! tee name=t "
    "t. ! queue ! tensor_transform mode=typecast option=float32 ! tensor_sink "
    "t. ! queue ! tensor_sink",
    "tensorsrc dimensions=4:2 num-frames=5 ! tensor_filter framework=scaler "
    "batching=true max-batch=2 ! tensor_sink sync-window=2",
    # the batched program of a labeling window (one vmapped program a window)
    "videotestsrc num-frames=6 width=64 height=48 ! tensor_converter ! "
    "tensor_transform mode=resize option=32:32 ! tensor_filter framework=torch "
    "model=zoo:mobilenet_v2 custom=size:32 batching=true max-batch=4 ! "
    "tensor_decoder mode=image_labeling ! tensor_sink",
    "tensorsrc dimensions=4 num-frames=6 ! tensor_filter framework=scaler ! "
    "tensor_rate framerate=15/1 ! tensor_sink",
    # a host decoder renders host arrays: the sink reads them as they are
    "tensorsrc dimensions=4 num-frames=4 ! tensor_filter framework=scaler ! "
    "tensor_decoder mode=flexbuf ! tensor_sink",
]


@pytest.mark.parametrize("desc", CROSSCHECK, ids=[
    "one-chain", "host-split", "three-segments", "reading-sink", "host-source", "labeling",
    "tee-queues", "batched-window", "labeling-batched", "rate", "host-decoder"])
def test_transfer_crosscheck_has_zero_delta(desc):
    ex = parse_pipeline(desc, device="cpu").run(timeout=120)
    chk = ex.transfer_crosscheck()
    assert chk["delta"] == {"h2d": 0, "d2h": 0}, (chk, plan_transfer_boundaries(ex.plan))
    assert all(c["predicted_interior"] == 0 for c in chk["chains"])


def test_predictions_match_reference_where_no_departure_applies():
    # a sink that reads bytes fetches each frame: the reference's prediction
    for desc in (ONE_CHAIN, ONE_CHAIN.replace("fakesink", "tensor_sink")):
        assert xray(desc).predicted == jxray(desc).predicted
    r = xray(ONE_CHAIN.replace("fakesink", "tensor_sink"))
    (b,) = r.boundaries
    assert (b.direction, b.reason, b.bytes_per_frame) == ("d2h", "sink-fetch", FRAME_BYTES)


def test_host_split_moves_no_tallied_bytes_in_the_port():
    """Departure: the reference fetches a frame to the host for a host-path
    filter (producer-fetch, 768 B); the port fetches only for WANTS_HOST
    consumers and converter subplugins, and hostscaler takes its frame as
    torch tensors, so nothing is tallied (the run agrees)."""
    r, j = xray(HOST_SPLIT), jxray(HOST_SPLIT)
    assert j.predicted == {"h2d": 0, "d2h": FRAME_BYTES}
    assert r.predicted == {"h2d": 0, "d2h": 0} and r.boundaries == []


def test_the_card_stages_a_host_source():
    """On the CPU staging moves nothing; a plan on a CUDA pipeline stages
    the host frame once at the first segment (the reference's TPU view)."""
    desc = ONE_CHAIN.replace("videotestsrc device=true ", "videotestsrc ")
    plan = parse_pipeline(desc, device="cpu").compile_plan()
    assert predict_frame_transfers(plan) == {"h2d": 0, "d2h": 0}
    plan.pipeline.device = torch.device("cuda")
    (b,) = plan_transfer_boundaries(plan)
    assert (b.direction, b.reason, b.bytes_per_frame) == ("h2d", "stage", FRAME_BYTES)
    assert jxray(desc).predicted_tpu == {"h2d": FRAME_BYTES, "d2h": 0}


def test_crosscheck_at_stop(monkeypatch):
    from nnstreamer_tpu_torch.pipeline import transfer

    monkeypatch.setenv("NNS_XRAY_CROSSCHECK", "0")
    assert not transfer.xray_crosscheck_enabled()
    monkeypatch.setenv("NNS_XRAY_CROSSCHECK", "1")
    assert transfer.xray_crosscheck_enabled()
    ex = parse_pipeline(ONE_CHAIN.replace("fakesink", "tensor_sink"), device="cpu").run(timeout=60)
    assert ex.last_crosscheck["measured"]["d2h"] == 4 * FRAME_BYTES
    assert ex.last_crosscheck["delta"] == {"h2d": 0, "d2h": 0}


def test_media_spec_bytes():
    p = parse_pipeline(ONE_CHAIN, device="cpu")
    p.compile_plan()
    src = p.elements[0]
    assert spec_bytes(src.out_specs[0]) == FRAME_BYTES


# ------------------------------------------------------------ program lint
def _trace(fn, shape=(4,), dtype=torch.float32):
    return trace_program(fn, (((shape), dtype),))


def test_trace_records_ops_without_allocating():
    tr = _trace(lambda ts: (torch.sin(ts[0]) * 2.0,), shape=(1 << 20,))
    assert tr.out_dtypes == (torch.float32,) and tr.out_bytes == 4 << 20
    assert tr.host_read is None and tr.intermediate_bytes >= 8 << 20
    assert xr.dtype_findings(tr, (torch.float32,)) == []


def test_dtype_promotion_and_drift_flagged():
    from nnstreamer_tpu_torch.tensors.spec import DType

    tr = _trace(lambda ts: (ts[0].double().sin().float(),))
    msgs = xr.dtype_findings(tr, (torch.float32,))
    assert msgs and "float64" in msgs[0]
    # a wide input excuses wide math
    tr = _trace(lambda ts: (ts[0] + 1.0,), dtype=torch.float64)
    assert xr.dtype_findings(tr, (torch.float64,)) == []
    tr = _trace(lambda ts: (ts[0] * 2.0,))
    msgs = xr.dtype_findings(tr, (torch.float32,), (DType.INT8,))
    assert msgs and "int8" in msgs[0]
    # an integer spec carried as int64 on the device is no drift
    tr = _trace(lambda ts: (ts[0].to(torch.int64),))
    assert xr.dtype_findings(tr, (torch.float32,), (DType.UINT32,)) == []


def test_host_read_fires_w120_and_uncapturable_too(monkeypatch):
    seg = _seg()
    seg._compose = lambda: (lambda ts: (ts[0] * float(ts[0].sum().item()),))
    report = LintReport()
    xr._segment_pass(seg, report, [])
    assert report.codes == ["NNS-W120"] and "host read" in report.diagnostics[0].message
    assert xr.segment_hazard(seg).startswith("NNS-W120 host read")
    seg = _seg()
    monkeypatch.setattr(type(seg.first.backend), "CAPTURABLE", False)
    report = LintReport()
    xr._segment_pass(seg, report, [])
    assert "NNS-W120" in report.codes and "CAPTURABLE" in report.diagnostics[0].message


def test_a_kernels_plain_version_reading_values_is_no_hazard():
    """K2's plain version loops over the data; its kernel reads nothing
    back, and under the trace the op answers with its fake: the trace runs
    through K2 to the decoder's detections with no W120, per frame and
    batched."""
    desc = ("tensorsrc dimensions=25:10 types=float32 num-frames=1 ! tensor_filter "
            "framework=scaler ! tensor_decoder mode=bounding_boxes option1=yolov5 "
            "postproc=device ! tensor_sink")
    seg = _seg(desc)
    tr = xr.segment_trace(seg)
    assert tr.host_read is None and tr.out_dtypes == (torch.float32,)
    assert tr.out_bytes == 100 * 6 * 4
    assert [op[:3] for op in tr.ops if op[0].startswith("nns.nms_mask")] == [
        ("nns.nms_mask.default", torch.bool, 10)]
    batched = xr.segment_trace(seg, 4)
    assert batched.host_read is None and batched.out_bytes == 4 * 100 * 6 * 4
    assert [op[:3] for op in batched.ops if op[0].startswith("nns.nms_mask")] == [
        ("nns.nms_mask.default", torch.bool, 40)]
    assert xray(desc).codes == []


def test_traces_leave_no_fake_tensor_behind():
    r = xray(CHAIN3)
    assert r.codes == [] and r.chains[0].cost.transient_bytes == 3 * 256
    frames = []
    p = parse_pipeline(CHAIN3 + " name=out", device="cpu")
    p.run(timeout=60)
    for f in p["out"].frames:
        frames.append(np.asarray(f.tensors[0]))
    assert len(frames) == 11 and np.isfinite(np.stack(frames)).all()


def test_cache_key_findings():
    seg = _seg()
    seg._negotiated_sig = lambda: None
    seg.batch_config = BatchConfig(enabled=True, max_batch=8, buckets=(1, 2, 4, 8))
    msg = xr.cache_key_finding(seg)
    assert msg is not None and "unbounded" in msg
    report = LintReport()
    xr._segment_pass(seg, report, [])
    assert "NNS-W121" in report.codes
    seg = _seg()
    seg.batch_config = BatchConfig(enabled=True, max_batch=40, buckets=tuple(range(1, 41)))
    assert "41" in xr.cache_key_finding(seg)
    seg.batch_config = BatchConfig(enabled=True, max_batch=8, buckets=(1, 2, 4, 8))
    assert xr.cache_key_finding(seg) is None


def test_donation_code_is_void():
    assert "NNS-W123" not in CATALOG
    src = importlib.import_module("inspect").getsource(xr)
    assert '"NNS-W123"' not in src


def test_w124_resident_bound(monkeypatch):
    monkeypatch.setenv("NNS_TPU_PLANE_MEMORY_PER_DEVICE", "1024")
    r, j = xray(ONE_CHAIN), jxray(ONE_CHAIN)
    assert "NNS-W124" in r.codes and r.codes == j.codes
    (w,) = [d for d in r.diagnostics if d.code == "NNS-W124"]
    assert "memory_per_device" in w.message
    monkeypatch.delenv("NNS_TPU_PLANE_MEMORY_PER_DEVICE")
    assert "NNS-W124" not in xray(ONE_CHAIN).codes


# --------------------------------------------------------------- dispatch
def test_dispatch_table_on_the_cpu_takes_the_plain_versions(monkeypatch):
    rows = xr.dispatch_table("cpu")
    assert [r["kernel"] for r in rows] == ["K1", "K1", "K2", "K3", "K4", "K5"]
    assert all(r["error"] is None and r["engaged"] == r["expected"] == "plain"
               and r["launches"] == 0 for r in rows), rows
    assert all(r["engaged"] is None for r in xr.dispatch_table("cpu", run=False))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(Exception, match="no CUDA device"):
        xr.dispatch_table()


# --------------------------------------------------------------- the CLI
def test_cli(capsys, monkeypatch):
    from nnstreamer_tpu_torch.analysis.xray_cli import main

    assert main(["--device", "cpu", ONE_CHAIN]) == 0
    assert "compile units: 1" in capsys.readouterr().out
    assert main(["--device", "cpu", HOST_SPLIT]) == 1
    assert main(["--device", "cpu", "--strict", HOST_SPLIT]) == 2
    capsys.readouterr()
    assert main(["--device", "cpu", "--json", HOST_SPLIT]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert len(doc["chains"]) == 2 and doc["device"] == "cpu"
    assert any(d["code"] == "NNS-W120" for d in doc["diagnostics"])
    assert main(["--device", "cpu", "--dispatch"]) == 0
    assert "flash_attention (K5) on cpu: engaged=plain" in capsys.readouterr().out
    assert main(["--self-check"]) == 0 and "OK" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main([ONE_CHAIN]) == 2


# ----------------------------------------------------------- degraded mode
def test_degraded_and_error_results():
    r = xray("videotestsrc ! tensor_converter ! tensor_filter framework=torch "
             "model=/does/not/exist.pt ! fakesink")
    assert r.degraded and r.codes == [] and r.exit_code == 0
    assert any("compile_plan failed" in n for n in r.notes)
    r = xray("videotestsrc ! ! fakesink")
    assert r.errors and r.exit_code == 2
    r = xray("appsrc dimensions=4 ! tensor_llm_serversink id=xray-probe")
    assert r.degraded and "stateful serving" in r.notes[0]


BATCHED_LABELING = (
    "videotestsrc num-frames=1 width=64 height=48 ! tensor_converter ! "
    "tensor_transform mode=resize option=32:32 ! tensor_filter framework=torch "
    "model=zoo:mobilenet_v2 custom=size:32 batching=true max-batch=4 ! "
    "tensor_decoder mode=image_labeling ! tensor_sink"
)


def test_a_batched_segment_traces_its_batched_program():
    """A micro-batched segment's bucket program is traced as it runs: the
    vmapped composed ops at the bucket, each op's output the window's
    (B rows), K1 one op for the window; per frame the same ops at N = 1."""
    from nnstreamer_tpu_torch.analysis.costmodel import segment_trace

    seg = _seg(BATCHED_LABELING)
    one, four = segment_trace(seg), segment_trace(seg, 4)
    assert one.host_read is None and four.host_read is None
    assert four.out_dtypes == one.out_dtypes and four.out_bytes == 4 * one.out_bytes

    def k1(tr):
        return [op[2] for op in tr.ops if op[0] == "nns.crop_resize.default"]

    assert k1(one) == [32 * 32 * 3] and k1(four) == [4 * 32 * 32 * 3]
    assert four.intermediate_bytes > 3 * one.intermediate_bytes
    assert segment_trace(seg, 4) is four  # cached per (bucket, fn versions)


def test_transient_bytes_follow_the_batched_program():
    """chain_cost's transient bytes at the max bucket are the batched
    program's own trace plus the window's inputs and outputs; for
    elementwise ops that is the per-frame working set times the bucket."""
    from nnstreamer_tpu_torch.analysis.costmodel import chain_cost, segment_trace

    plan = parse_pipeline(BATCHED_LABELING, device="cpu").compile_plan()
    (chain,) = plan.chains()
    seg = chain.segments[0]
    in_b = spec_bytes(seg.first.in_specs[0])
    out_b = spec_bytes(seg.last.out_specs[0])
    cost = chain_cost(chain)
    assert cost.transient_bytes == (in_b + out_b) * 4 + segment_trace(seg, 4).intermediate_bytes
    desc = ("tensorsrc dimensions=8:8 num-frames=1 ! tensor_transform mode=arithmetic "
            "option=add:1.0 ! tensor_filter framework=scaler batching=true max-batch=4 ! "
            "tensor_sink")
    plan = parse_pipeline(desc, device="cpu").compile_plan()
    (chain,) = plan.chains()
    seg = chain.segments[0]
    per_frame = (spec_bytes(seg.first.in_specs[0]) + spec_bytes(seg.last.out_specs[0])
                 + segment_trace(seg).intermediate_bytes)
    assert chain_cost(chain).transient_bytes == 4 * per_frame


def test_a_batched_program_that_cannot_be_built_is_noted():
    """A segment whose batched program vmap refuses (a read of values)
    gets a note from nns-xray, and its per-frame W120 as before."""
    from nnstreamer_tpu_torch.backends import custom as tcustom

    tcustom.register_custom_easy("xr_hist", lambda ts: (torch.histc(ts[0]),), traceable=True)
    try:
        r = xray("tensorsrc dimensions=16 types=float32 num-frames=1 ! tensor_filter "
                 "framework=custom-easy model=xr_hist batching=true max-batch=4 ! tensor_sink")
        assert any("batched program at bucket 4 cannot be built" in n for n in r.chains[0].notes)
    finally:
        tcustom.unregister_custom_easy("xr_hist")
