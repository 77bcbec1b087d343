"""Whole-chain programs of the port (nnstreamer_tpu_torch/pipeline/chain_program.py
and the executor's chain node) against the JAX package's, on the CPU.

- the reference's 3-segment DESC (three transforms joined by queues, 11
  frames at unroll 4): ONE chain node, the output bit for bit equal to
  ``chain-mode=off`` and to the reference's stream (the constants keep
  float32 exact), one launch a window, the chain rows of ``stats()``;
- the program alone: one launch a window, the trailing window's bucket, a
  trickle's bucket 1, every row equal to the per-node path;
- the ladder: a window OOM shrinks the governor's rung and is retried, a
  device fault latches the per-node path (counted in ``chain_fallback``),
  both under the sanitizer with clean accounting;
- ``decide_chain`` gives the reference's verdict and reason on the same
  plans (single segment, mode off, NNS_NO_FUSE, micro-batching, an error
  policy, upstream QoS, a flexible head, an interior consumer and
  producer); the port's own hazard checks (W120 uncapturable, W121 a
  same-shape model swap builds a new graph, W122 output dtypes, W124 the
  device bound's clamp and its byte count);
- the labeling pipeline with ``! queue !`` before the filter forms one
  2-segment chain in both packages; the port's segments know a raw video
  frame's signature, so the port compiles it where the reference reports
  a flexible head, and its labels and logits equal ``chain-mode=off``.
"""

import numpy as np
import pytest
import torch

from nnstreamer_tpu.pipeline.chain_program import decide_chain as jdecide
from nnstreamer_tpu.pipeline.parse import parse_pipeline as jparse
from nnstreamer_tpu_torch.pipeline import chain_program as cp
from nnstreamer_tpu_torch.pipeline.chain_program import ChainProgram, decide_chain
from nnstreamer_tpu_torch.pipeline.device_faults import DeviceFaultError, DeviceOOMError
from nnstreamer_tpu_torch.pipeline.executor import _ChainNode
from nnstreamer_tpu_torch.pipeline.parse import parse_pipeline
from nnstreamer_tpu_torch.tensors.frame import Frame

TIMEOUT = 120

DESC = (
    "tensorsrc dimensions=8:8 pattern=counter num-frames=11 ! "
    "tensor_transform mode=arithmetic option=add:1.0 ! queue ! "
    "tensor_transform mode=arithmetic option=mul:2.0 ! queue ! "
    "tensor_transform mode=arithmetic option=add:0.5 ! tensor_sink name=out"
)


def _run(monkeypatch, desc, mode, sanitize=False, unroll=None):
    monkeypatch.setenv("NNS_TPU_EXECUTOR_CHAIN_MODE", mode)
    if unroll is not None:
        monkeypatch.setenv("NNS_TPU_EXECUTOR_CHAIN_UNROLL", str(unroll))
    monkeypatch.setenv("NNS_TPU_SANITIZE", "1" if sanitize else "0")
    p = parse_pipeline(desc, device="cpu")
    ex = p.run(timeout=TIMEOUT)
    frames = [[np.asarray(t) for t in f.tensors] for f in p["out"].frames]
    return frames, ex


def _ref_run(monkeypatch, desc, mode):
    monkeypatch.setenv("NNS_TPU_EXECUTOR_CHAIN_MODE", mode)
    p = jparse(desc)
    p.run(timeout=TIMEOUT)
    return [[np.asarray(t) for t in f.tensors] for f in p["out"].frames]


def _chain_nodes(ex):
    return [n for n in ex.nodes if isinstance(n, _ChainNode)]


def _assert_bitwise(a, b):
    assert len(a) == len(b)
    for fa, fb in zip(a, b):
        assert len(fa) == len(fb)
        for ta, tb in zip(fa, fb):
            assert ta.dtype == tb.dtype
            np.testing.assert_array_equal(ta, tb)


def _plan_and_chain(desc):
    p = parse_pipeline(desc, device="cpu")
    p.negotiate()
    plan = p.compile_plan()
    chains = plan.chains()
    assert chains, "pipeline grew no chain"
    return plan, chains[0]


def _ref_plan_and_chain(desc):
    p = jparse(desc)
    p.negotiate()
    plan = p.compile_plan()
    return plan, plan.chains()[0]


# ---------------------------------------------------------------- parity
def test_bitwise_parity_and_windowed_launches(monkeypatch):
    compiled, ex_on = _run(monkeypatch, DESC, "auto")
    d2h_on = ex_on.totals()["transfer"]["d2h"]  # the tally is process-wide: read it now
    oracle, ex_off = _run(monkeypatch, DESC, "off")
    d2h_off = ex_off.totals()["transfer"]["d2h"]
    ref = _ref_run(monkeypatch, DESC, "auto")
    nodes = _chain_nodes(ex_on)
    assert len(nodes) == 1  # three segments and two queues, ONE node
    assert not _chain_nodes(ex_off)
    assert len(compiled) == 11
    _assert_bitwise(compiled, oracle)
    _assert_bitwise(compiled, ref)
    n = nodes[0]
    # ceil(11/4) = 3 windows when the source keeps ahead; a collect that
    # found one frame more is tolerated, one launch a frame is not
    assert 3 <= n.program.launches <= 4
    assert not n.fallback_latched and n.fallback_windows == 0
    s = ex_on.stats()[n.name]
    assert s["chain_segments"] == 3 and s["chain_unroll"] == 4
    assert s["chain_launches"] == n.program.launches and s["chain_fallback"] == 0
    assert ex_on.totals()["balance"] == 0
    assert d2h_on == d2h_off == 11 * 256


def test_sanitized_run_is_clean(monkeypatch):
    frames, ex = _run(monkeypatch, DESC, "auto", sanitize=True)
    assert len(frames) == 11 and _chain_nodes(ex)
    assert _chain_nodes(ex)[0].program.sanitize_poison
    assert ex.sanitizer.codes == [], [str(d) for d in ex.sanitizer.findings()]


def test_member_graphs_are_not_built_at_start(monkeypatch):
    """The chain's program is built at start; the members' own programs
    (the per-node path) only at their first use."""
    _, ex = _run(monkeypatch, DESC, "auto")
    n = _chain_nodes(ex)[0]
    assert n.program.n_traces >= 1
    assert [seg.n_traces for seg in n.chain.segments] == [0, 0, 0]


# --------------------------------------------------------------- program
def _frames(chain, n, start=0):
    sig = chain.segments[0]._negotiated_sig()
    return [Frame(tuple(torch.full(shape, float(i), dtype=dtype) for shape, dtype in sig))
            for i in range(start, start + n)]


def test_one_launch_per_window(monkeypatch):
    monkeypatch.setenv("NNS_TPU_EXECUTOR_CHAIN_MODE", "auto")
    plan, chain = _plan_and_chain(DESC)
    d = decide_chain(plan, chain)
    assert d.compiles, d.reason
    assert d.unroll == 4
    prog = ChainProgram(chain, d.unroll)
    prog.build()
    frames = _frames(chain, 7)
    outs, rows, launched = prog.process_window(frames[:4])
    assert launched and rows == 4 and len(outs) == 4 and prog.launches == 1
    # the EOS tail: 3 frames pad up to the 4-bucket, still ONE launch
    outs2, rows2, launched2 = prog.process_window(frames[4:])
    assert launched2 and rows2 == 4 and len(outs2) == 3 and prog.launches == 2
    assert prog.n_traces == 1  # both windows ran the 4-bucket's program
    for f, out in zip(frames, outs + outs2):
        want = prog.process_frame_fallback(f)
        for ta, tb in zip(out.tensors, want.tensors):
            assert torch.equal(ta, tb)


def test_trickle_window_uses_small_bucket(monkeypatch):
    monkeypatch.setenv("NNS_TPU_EXECUTOR_CHAIN_MODE", "auto")
    _, chain = _plan_and_chain(DESC)
    prog = ChainProgram(chain, 4)
    assert prog.buckets == (1, 2, 4)
    outs, rows, launched = prog.process_window(_frames(chain, 1, 5))
    assert launched and rows == 1 and len(outs) == 1 and prog.launches == 1
    outs, rows, _ = prog.process_window(_frames(chain, 2))
    assert rows == 2 and prog.n_traces == 2
    np.testing.assert_array_equal(outs[1].tensors[0].numpy(),
                                  np.full((8, 8), (1.0 + 1.0) * 2.0 + 0.5, np.float32))


# ------------------------------------------------------------- the ladder
def test_oom_shrinks_window_and_recovers(monkeypatch):
    oracle, _ = _run(monkeypatch, DESC, "off")
    state = {"calls": 0}
    real = ChainProgram.process_window

    def flaky(self, frames):
        state["calls"] += 1
        if state["calls"] == 1:
            raise DeviceOOMError("injected window OOM")
        return real(self, frames)

    monkeypatch.setattr(ChainProgram, "process_window", flaky)
    compiled, ex = _run(monkeypatch, DESC, "auto", sanitize=True)
    _assert_bitwise(compiled, oracle)
    n = _chain_nodes(ex)[0]
    assert not n.fallback_latched
    assert n.bucket_governor is not None and n.bucket_governor.ooms == 1
    assert n.program.launches > 3  # shrunk windows: more launches
    assert ex.sanitizer.codes == []


def test_device_fault_latches_the_per_node_path(monkeypatch):
    oracle, _ = _run(monkeypatch, DESC, "off")

    def broken(self, frames):
        raise DeviceFaultError("injected chain fault")

    monkeypatch.setattr(ChainProgram, "process_window", broken)
    compiled, ex = _run(monkeypatch, DESC, "auto", sanitize=True)
    _assert_bitwise(compiled, oracle)
    n = _chain_nodes(ex)[0]
    assert n.fallback_latched and n.fallback_windows >= 1 and n.program.launches == 0
    s = ex.stats()[n.name]
    assert s["chain_fallback"] == 11 and s["chain_fallback_windows"] == n.fallback_windows
    assert s["device_degraded"] == 1
    # the per-node path ran each member segment's own program
    assert all(seg.n_traces == 1 for seg in n.chain.segments)
    assert ex.sanitizer.codes == [], [str(d) for d in ex.sanitizer.findings()]


def test_device_fault_without_fallback_stops_the_run(monkeypatch):
    def broken(self, frames):
        raise DeviceFaultError("injected chain fault")

    monkeypatch.setattr(ChainProgram, "process_window", broken)
    monkeypatch.setenv("NNS_TPU_EXECUTOR_DEVICE_FALLBACK", "false")
    with pytest.raises(DeviceFaultError):
        _run(monkeypatch, DESC, "auto")


def test_fault_metrics_count_the_fallback(monkeypatch):
    from nnstreamer_tpu_torch.obs import metrics as obs_metrics

    def broken(self, frames):
        raise DeviceFaultError("injected chain fault")

    monkeypatch.setattr(ChainProgram, "process_window", broken)
    reg = obs_metrics.enable()
    try:
        _, ex = _run(monkeypatch, DESC, "auto")
        n = _chain_nodes(ex)[0]
        assert reg.counter("nns_chain_fallback_total", element=n.name).value == n.fallback_windows
        faults = [m for m in reg.metrics()
                  if m.name == "nns_device_faults_total" and m.labels.get("element") == n.name]
        assert sum(m.value for m in faults) == 1
        assert reg.gauge("nns_degraded_segments", element=n.name).value == 1
    finally:
        obs_metrics.disable()


# -------------------------------------------------------------- decisions
def _verdict(d):
    return (d.eligible, d.reason, d.mode, d.unroll, d.compiles)


def _flexible_head_pair():
    """The same flexible-head chain built in both packages (an appsrc
    with a flexible spec, a queue between two transforms)."""
    from nnstreamer_tpu.elements import flow as jflow
    from nnstreamer_tpu.elements import sink as jsink
    from nnstreamer_tpu.elements import sources as jsources
    from nnstreamer_tpu.elements import transform as jtransform
    from nnstreamer_tpu.pipeline.graph import Pipeline as JPipeline
    from nnstreamer_tpu.tensors.spec import TensorFormat as JFormat
    from nnstreamer_tpu.tensors.spec import TensorsSpec as JSpec
    from nnstreamer_tpu_torch.elements import flow, sink, sources, transform
    from nnstreamer_tpu_torch.pipeline.graph import Pipeline
    from nnstreamer_tpu_torch.tensors.spec import TensorFormat, TensorsSpec

    def build(P, src_mod, tr, fl, sk, spec, dev):
        p = P(**dev)
        p.chain(src_mod.AppSrc(spec=spec),
                tr.TensorTransform(mode="typecast", option="float32"), fl.Queue(),
                tr.TensorTransform(mode="arithmetic", option="add:1"), sk.TensorSink())
        p.negotiate()
        plan = p.compile_plan()
        return plan, plan.chains()[0]

    return (build(Pipeline, sources, transform, flow, sink,
                  TensorsSpec(format=TensorFormat.FLEXIBLE), {"device": "cpu"}),
            build(JPipeline, jsources, jtransform, jflow, jsink,
                  JSpec(format=JFormat.FLEXIBLE), {}))


NAMED_DESC = (
    "tensorsrc name=src dimensions=8:8 pattern=counter num-frames=11 ! "
    "tensor_transform name=a mode=arithmetic option=add:1.0 ! queue name=q1 ! "
    "tensor_transform name=b mode=arithmetic option=mul:2.0 ! queue name=q2 ! "
    "tensor_transform name=c mode=arithmetic option=add:0.5 ! tensor_sink name=out"
)

DECISION_PLANS = {
    "single_segment": "tensorsrc name=src dimensions=4 num-frames=1 ! "
                      "tensor_transform name=a mode=arithmetic option=add:1.0 ! "
                      "tensor_sink name=out",
    "three_segments": NAMED_DESC,
    "batching": ("tensorsrc name=src dimensions=4 num-frames=1 ! tensor_filter name=f1 "
                 "framework=scaler batching=true max-batch=4 ! queue name=q ! "
                 "tensor_filter name=f2 framework=scaler ! tensor_sink name=out"),
    "error_policy": ("tensorsrc name=src dimensions=4 num-frames=1 ! tensor_filter name=f1 "
                     "framework=scaler on-error=drop ! queue name=q ! tensor_filter name=f2 "
                     "framework=scaler ! tensor_sink name=out"),
    "qos": ("tensorsrc name=src dimensions=4 num-frames=1 framerate=30/1 ! tensor_filter "
            "name=f1 framework=scaler ! queue name=q ! tensor_filter name=f2 framework=scaler ! "
            "tensor_rate name=r framerate=10/1 ! tensor_sink name=out"),
    "interior_consumer": ("tensorsrc name=src dimensions=4 num-frames=1 ! tensor_filter name=f1 "
                          "framework=scaler ! tee name=t t. ! queue name=q1 ! tensor_filter "
                          "name=f2 framework=scaler ! tensor_sink name=out t. ! queue name=q2 ! "
                          "tensor_sink name=side"),
}


@pytest.mark.parametrize("case", sorted(DECISION_PLANS))
@pytest.mark.parametrize("mode", ["auto", "off"])
def test_decide_chain_matches_the_reference(case, mode, monkeypatch):
    monkeypatch.setenv("NNS_TPU_EXECUTOR_CHAIN_MODE", mode)
    desc = DECISION_PLANS[case]
    p = parse_pipeline(desc, device="cpu")
    p.negotiate()
    plan = p.compile_plan()
    jp = jparse(desc)
    jp.negotiate()
    jplan = jp.compile_plan()
    chains, jchains = plan.chains(), jplan.chains()
    assert [c.name for c in chains] == [c.name for c in jchains]
    for c, jc in zip(chains, jchains):
        assert _verdict(decide_chain(plan, c)) == _verdict(jdecide(jplan, jc)), c.name


def test_no_fuse_oracle_disables_compilation(monkeypatch):
    monkeypatch.setenv("NNS_NO_FUSE", "1")
    plan, chain = _plan_and_chain(DESC)
    d = decide_chain(plan, chain)
    assert not d.eligible and "NNS_NO_FUSE" in d.reason
    monkeypatch.delenv("NNS_NO_FUSE")
    jplan, jchain = _ref_plan_and_chain(DESC)
    monkeypatch.setenv("NNS_NO_FUSE", "1")
    assert _verdict(jdecide(jplan, jchain)) == _verdict(d)


def test_flexible_head_not_eligible():
    (plan, chain), (jplan, jchain) = _flexible_head_pair()
    d, jd = decide_chain(plan, chain), jdecide(jplan, jchain)
    assert not d.eligible and _verdict(d) == _verdict(jd) and "flexible input spec" in d.reason


def test_interior_producer_not_eligible():
    """A second producer into an interior member's queue (built by hand:
    two sources into one queue would not negotiate in a description)."""
    from nnstreamer_tpu_torch.elements import flow, sink, sources, transform
    from nnstreamer_tpu_torch.pipeline.graph import Pipeline

    p = Pipeline(device="cpu")
    a = sources.TensorSrc(dimensions="4", **{"num-frames": "1"})
    t1 = transform.TensorTransform(mode="arithmetic", option="add:1")
    q = flow.Queue()
    t2 = transform.TensorTransform(mode="arithmetic", option="add:1")
    p.chain(a, t1, q, t2, sink.TensorSink())
    plan = p.compile_plan()
    chain = plan.chains()[0]
    assert len(chain.segments) == 2
    # what a second producer into the interior looks like to the walk
    extra = sources.TensorSrc(name="other", dimensions="4")
    p.elements.append(extra)
    from nnstreamer_tpu_torch.pipeline.graph import Link

    p.links.append(Link(extra, 0, t2, 1))
    d = decide_chain(plan, chain)
    assert not d.eligible
    assert d.reason == "interior segment also fed by other outside the chain"


def test_w120_uncapturable_member_blocks_the_chain(monkeypatch):
    from nnstreamer_tpu_torch.elements.transform import TensorTransform

    plan, chain = _plan_and_chain(DESC)
    monkeypatch.setattr(TensorTransform, "CAPTURABLE", False)
    d = decide_chain(plan, chain)
    assert not d.eligible and d.reason.startswith("NNS-W120 uncapturable op `tensor_transform")


def test_w121_same_shape_model_swap_builds_a_new_graph(monkeypatch):
    """The chain's programs are keyed on every member's fn version: a
    same-shape swap (a ticked version) fills a new entry from the new fn."""
    monkeypatch.setenv("NNS_TPU_EXECUTOR_CHAIN_MODE", "auto")
    _, chain = _plan_and_chain(DESC)
    prog = ChainProgram(chain, 4)
    frames = _frames(chain, 4)
    before, _, _ = prog.process_window(frames)
    assert prog.n_traces == 1
    last = chain.ops[-1]
    monkeypatch.setattr(last, "make_fn", lambda: (lambda ts: tuple(t + 100.0 for t in ts)))
    last.fn_version = 1
    after, _, _ = prog.process_window(frames)
    assert prog.n_traces == 2
    for a, b in zip(before, after):
        assert torch.equal(b.tensors[0], a.tensors[0] - 0.5 + 100.0)


def test_w122_output_dtype_hazard_latches_the_per_node_path(monkeypatch):
    """The trace of the widened segment shows the float64 output against
    the declared float32 (nns-xray's walker): the chain is refused before
    it runs. Where the trace cannot see the drift, the first window's check
    latches the per-node path mid-run."""
    import importlib

    from nnstreamer_tpu_torch.elements.transform import TensorTransform

    xr = importlib.import_module("nnstreamer_tpu_torch.analysis.xray")

    real = TensorTransform.make_fn

    def widened(self):
        fn = real(self)
        if self.get_property("option") == "add:0.5":
            return lambda ts: tuple(t.double() for t in fn(ts))
        return fn

    monkeypatch.setattr(TensorTransform, "make_fn", widened)
    plan, chain = _plan_and_chain(DESC)
    d = decide_chain(plan, chain)
    assert not d.eligible and d.reason == (
        f"NNS-W122 in segment {chain.segments[-1].name}: `aten._to_copy.default` produces "
        "float64 with no 64-bit input")
    frames, ex = _run(monkeypatch, DESC, "auto")
    assert not _chain_nodes(ex) and len(frames) == 11
    monkeypatch.setattr(xr, "segment_trace", lambda seg: None)  # a drift no trace shows
    frames, ex = _run(monkeypatch, DESC, "auto")
    n = _chain_nodes(ex)[0]
    assert n.fallback_latched and n.hazard.startswith("NNS-W122 in chain")
    assert ex.stats()[n.name]["chain_hazard"] == n.hazard
    assert len(frames) == 11


def test_w124_bound_clamps_the_window_and_blocks_when_over(monkeypatch):
    """W124 reads analysis/costmodel.chain_cost, as the reference's does:
    params + the peak segment's in + out + traced op bytes, times K. On
    this pipeline the fake-tensor trace counts the reference's jaxpr bytes
    exactly (tolerance 0: each segment's one float32 [8, 8] op; the
    constant built from host numbers is kept, not a working set), so the
    two packages clamp and block at the same bounds."""
    from nnstreamer_tpu.analysis.costmodel import chain_cost as jchain_cost

    plan, chain = _plan_and_chain(DESC)
    jplan, jchain = _ref_plan_and_chain(DESC)
    cost, jcost = cp.chain_cost(chain), jchain_cost(jchain)
    assert cost.params_bytes == jcost.params_bytes == 0
    assert cost.transient_bytes == jcost.transient_bytes == 3 * 256
    per = cost.transient_bytes
    for bound, unroll in ((2 * per, 2), (4 * per, 4), (3 * per, 2), (per, 1)):
        monkeypatch.setenv("NNS_TPU_PLANE_MEMORY_PER_DEVICE", str(bound))
        d, jd = decide_chain(plan, chain), jdecide(jplan, jchain)
        assert d.unroll == unroll and d.eligible
        # the reference reports the flexible head first; its clamp is the same
        assert jd.unroll == unroll
    monkeypatch.setenv("NNS_TPU_PLANE_MEMORY_PER_DEVICE", str(per - 1))
    d, jd = decide_chain(plan, chain), jdecide(jplan, jchain)
    reason = (f"NNS-W124 resident {per} B over the [plane] memory_per_device bound "
              f"({per - 1} B)")
    assert not d.eligible and d.reason == reason
    monkeypatch.setenv("NNS_TPU_PLANE_MEMORY_PER_DEVICE", "1K")
    assert cp.configured_device_bound() == 1024
    monkeypatch.delenv("NNS_TPU_PLANE_MEMORY_PER_DEVICE")
    assert decide_chain(plan, chain).unroll == 4


def test_an_untraceable_segment_blocks_the_chain(monkeypatch):
    """As in the reference: a segment the analyzer cannot trace gets no
    chain program (the per-node path runs), and the reason names it."""
    import importlib

    xr = importlib.import_module("nnstreamer_tpu_torch.analysis.xray")

    def fails(seg):
        raise RuntimeError("no fake kernel")

    monkeypatch.setattr(xr, "segment_trace", fails)
    plan, chain = _plan_and_chain(DESC)
    d = decide_chain(plan, chain)
    assert not d.eligible and d.reason == (
        f"segment {chain.segments[0].name} untraceable (no fake kernel)")
    frames, ex = _run(monkeypatch, DESC, "auto")
    assert not _chain_nodes(ex) and len(frames) == 11


# ---------------------------------------------------- the labeling chain
LABELING = (
    "videotestsrc name=src pattern=gradient num-frames=6 width=64 height=48 ! "
    "tensor_converter name=conv ! tensor_transform name=resize mode=resize option=32:32 ! "
    "queue name=q ! tensor_filter name=f framework={fw} model=zoo:mobilenet_v2 custom=size:32 ! "
    "tensor_decoder name=dec mode=image_labeling ! tensor_sink name=out"
)


def test_labeling_with_a_queue_forms_one_two_segment_chain(monkeypatch):
    monkeypatch.setenv("NNS_TPU_EXECUTOR_CHAIN_MODE", "auto")
    plan, chain = _plan_and_chain(LABELING.format(fw="torch"))
    jplan, jchain = _ref_plan_and_chain(LABELING.format(fw="jax"))
    assert len(plan.chains()) == len(jplan.chains()) == 1
    assert chain.name == jchain.name == "conv+resize => f+dec"
    assert [len(s.ops) for s in chain.segments] == [len(s.ops) for s in jchain.segments] == [2, 2]
    # the port knows a raw video frame's signature at plan time; the
    # reference reads the media head as flexible
    assert decide_chain(plan, chain).compiles
    assert jdecide(jplan, jchain).reason == "flexible input spec at the chain head"


def test_labeling_chain_equals_chain_mode_off(monkeypatch):
    desc = LABELING.format(fw="torch").replace(
        "tensor_decoder mode=image_labeling ! tensor_sink name=out",
        "tee name=t t. ! tensor_decoder mode=image_labeling ! tensor_sink name=out "
        "t. ! tensor_sink name=logits")
    runs = {}
    for mode in ("auto", "off"):
        monkeypatch.setenv("NNS_TPU_EXECUTOR_CHAIN_MODE", mode)
        p = parse_pipeline(LABELING.format(fw="torch"), device="cpu")
        ex = p.run(timeout=TIMEOUT)
        runs[mode] = ([f.meta.get("label") for f in p["out"].frames],
                      [np.asarray(f.tensors[0]) for f in p["out"].frames], ex)
    (la, ta, ex_on), (lb, tb, _) = runs["auto"], runs["off"]
    assert la == lb and len(la) == 6
    for a, b in zip(ta, tb):
        np.testing.assert_array_equal(a, b)
    n = _chain_nodes(ex_on)[0]
    assert n.program.launches <= 6 and n.fallback_frames == 0
    # the tee after the filter ends the chain at the filter's segment
    p = parse_pipeline(desc, device="cpu")
    p.negotiate()
    assert len(p.compile_plan().chains()[0].segments) == 2
