"""The port's device resilience (nnstreamer_tpu_torch/pipeline/device_faults.py,
parallel/replicas.py, the executor's degradation ladder and control
surface) against the JAX package's, on the CPU.

- the classifier: the typed faults by kind, torch's CUDA errors in place of
  XLA's status messages (``torch.OutOfMemoryError`` → oom, a capture error
  → compile, ``torch.AcceleratorError`` and the sticky CUDA errors →
  device_lost, other CUDA errors → transient), and a kernel's nvcc build
  failure → None;
- the OOM governor, the device circuit, the policy resolution and the
  replica set driven through the same sequences in both packages, equal
  state after every step;
- pipelines through both packages (the reference under its runtime
  sanitizer): the OOM ladder, the compile fallback, replica failover and
  the warm restart, with equal outputs and equal counters;
- the labeling slice (videotestsrc → resize → zoo:mobilenet_v2 →
  image_labeling) with a failing build, an OOM-capped batch ladder and
  replicas=2: labels equal to the unfaulted run's, counters equal to the
  reference's.

``compile_fail_first_n`` counts program builds in the port (a graph's
warm-up and capture on the card, a program call on the CPU) where the
reference counts jax traces; on a per-frame segment both are one an
attempt, so the circuit's counters agree.
"""

import time

import numpy as np
import pytest
import torch

import jax

from nnstreamer_tpu.models import mobilenet_v2 as jmobilenet
from nnstreamer_tpu.parallel import replicas as jreplicas
from nnstreamer_tpu.pipeline import device_faults as jdf
from nnstreamer_tpu.pipeline.executor import Executor as JExecutor
from nnstreamer_tpu.pipeline.parse import parse_pipeline as jparse
from nnstreamer_tpu_torch.elements.filter import TensorFilter
from nnstreamer_tpu_torch.parallel.replicas import ReplicaSet
from nnstreamer_tpu_torch.pipeline.device_faults import (
    BucketGovernor,
    DeviceCircuit,
    DeviceCompileError,
    DeviceFaultError,
    DeviceLostError,
    DeviceOOMError,
    ReplicaExhaustedError,
    classify_device_fault,
    resolve_device_policy,
)
from nnstreamer_tpu_torch.pipeline.executor import Executor
from nnstreamer_tpu_torch.pipeline.parse import parse_pipeline
from nnstreamer_tpu_torch.tensors.frame import Frame


@pytest.fixture(autouse=True)
def _sanitize(monkeypatch):
    """The reference runs under its runtime sanitizer: its degradation paths
    keep offered == delivered + dropped + routed per node, or fail at EOS."""
    monkeypatch.setenv("NNS_TPU_SANITIZE", "1")


def both(desc, timeout=60):
    p = parse_pipeline(desc, device="cpu")
    ex = p.run(timeout=timeout)
    jp = jparse(desc)
    jex = jp.run(timeout=timeout)
    return p, ex, jp, jex


def values(frames):
    return [np.asarray(f.tensors[0]).tolist() for f in frames]


def same(ex, jex, node, keys):
    got, want = ex.stats()[node], jex.stats()[node]
    for k in keys:
        assert got.get(k) == want.get(k), (k, got, want)
    return got


CIRCUIT_KEYS = ("frames", "device_degraded", "device_faults", "device_fault_kinds",
                "device_eager_invokes", "device_circuit_opens")
OOM_KEYS = ("frames", "oom_events", "batch_ceiling", "oom_reprobes", "device_degraded")
REPLICA_KEYS = ("frames", "rep_replicas", "rep_healthy", "rep_failovers", "rep_exhaustions",
                "rep_served", "rep_faults")
FAULT_KEYS = ("errors", "error_dropped", "error_routed", "error_retries")


# ------------------------------------------------------------- classifier
class TestClassifier:
    @pytest.mark.parametrize("cls,kind", [
        (DeviceOOMError, "oom"), (DeviceCompileError, "compile"),
        (DeviceLostError, "device_lost"), (DeviceFaultError, "transient"),
    ])
    def test_typed_faults_classify_by_kind(self, cls, kind):
        jcls = getattr(jdf, cls.__name__)
        assert classify_device_fault(cls("x")) == jdf.classify_device_fault(jcls("x")) == kind

    def test_ordinary_errors_are_not_device_faults(self):
        for exc in (ValueError("bad input"), RuntimeError("user code"), KeyError("k")):
            assert classify_device_fault(exc) is None is jdf.classify_device_fault(exc)

    @pytest.mark.parametrize("exc,kind", [
        (torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"), "oom"),
        (torch.cuda.OutOfMemoryError("CUDA out of memory."), "oom"),
        (torch.AcceleratorError("CUDA error: an illegal memory access was encountered"),
         "device_lost"),
        (torch.AcceleratorError("CUDA error: misaligned address"), "device_lost"),
        (RuntimeError("CUDA error: an illegal memory access was encountered"), "device_lost"),
        (RuntimeError("CUDA error: unspecified launch failure"), "device_lost"),
        (RuntimeError("CUDA error: device-side assert triggered"), "device_lost"),
        (RuntimeError("CUDA error: uncorrectable ECC error encountered"), "device_lost"),
        (RuntimeError("CUDA error: operation not permitted when stream is capturing"),
         "compile"),
        (torch.AcceleratorError(
            "CUDA error: operation not permitted when stream is capturing"), "compile"),
        (RuntimeError("CUDA error: too many resources requested for launch"), "transient"),
        (RuntimeError("CUDA driver error: invalid argument"), "transient"),
    ])
    def test_torch_cuda_errors(self, exc, kind):
        assert classify_device_fault(exc) == kind

    def test_kernel_build_failure_is_an_ordinary_error(self):
        """A kernel that nvcc cannot build (ops/kernels/_build.py) reaches the
        element's on-error and never opens the circuit: the eager path would
        launch the same unbuilt kernel. nvcc's own words ("failed to
        compile", paths under /usr/local/cuda) must not match."""
        msg = ("nvcc failed for image_kernels.cu (rc 2):\n"
               "/root/x/image_kernels.cu(12): error: identifier \"foo\" is undefined\n"
               "In file included from /usr/local/cuda/include/cuda_runtime.h:1 failed to "
               "compile; compilation failed, out of memory in the cuda toolkit")
        assert classify_device_fault(RuntimeError(msg)) is None
        assert classify_device_fault(OSError("libcuda.so: cannot open")) is None


# -------------------------------------------------------- bucket governor
def _govs(ladder=(1, 2, 4, 8), cooldown=10.0):
    clock = [0.0]
    return (BucketGovernor(ladder, cooldown_s=cooldown, clock=lambda: clock[0]),
            jdf.BucketGovernor(ladder, cooldown_s=cooldown, clock=lambda: clock[0]), clock)


class TestBucketGovernor:
    """Each case drives both governors through one sequence of calls and
    holds every result and the snapshots equal."""

    @staticmethod
    def drive(steps, cooldown=10.0):
        g, jg, clock = _govs(cooldown=cooldown)
        got = []
        for op, arg in steps:
            if op == "t":
                clock[0] = arg
                continue
            a = getattr(g, op)(*(() if arg is None else (arg,)))
            b = getattr(jg, op)(*(() if arg is None else (arg,)))
            assert a == b, (op, arg, a, b)
            got.append(a)
        assert g.snapshot() == jg.snapshot() and g.degraded == jg.degraded
        return g, got

    def test_oom_halves_to_next_rung_and_remembers(self):
        g, got = self.drive([("cap", None), ("on_oom", 8), ("cap", None), ("on_oom", 4),
                             ("cap", None)])
        assert got == [8, 4, 4, 2, 2] and g.snapshot()["ceiling"] == 2 and g.ooms == 2

    def test_bucket_one_oom_returns_none(self):
        _, got = self.drive([("on_oom", 2), ("on_oom", 1)])
        assert got == [1, None]

    def test_zero_cooldown_disables_reprobe_no_livelock(self):
        steps = [("on_oom", 8)] + [
            s for t in range(5) for s in (("cap", None), ("t", 1000.0 * (t + 1)))]
        _, got = self.drive(steps, cooldown=0.0)
        assert got == [4, 4, 4, 4, 4, 4]

    def test_reprobe_after_cooldown_reclaims_one_rung(self):
        g, got = self.drive([("on_oom", 8), ("cap", None), ("t", 11.0), ("cap", None),
                             ("on_ok", 8)])
        assert got == [4, 4, 8, True] and not g.degraded and g.reprobes == 1

    def test_failed_probe_pushes_cooldown_out(self):
        _, got = self.drive([("on_oom", 8), ("t", 11.0), ("cap", None), ("on_oom", 8),
                             ("cap", None), ("t", 22.0), ("cap", None)])
        assert got == [4, 8, 4, 4, 8]

    def test_narrow_and_non_ladder_widths(self):
        g, got = self.drive([("on_oom", 4), ("t", 11.0), ("cap", None), ("on_ok", 3),
                             ("cap", None), ("on_ok", 6)])
        assert got == [2, 4, False, 4, True] and g.ceiling == 4

    def test_restore_rearms_ceiling_and_cooldown(self):
        g, jg, _ = _govs()
        g.on_oom(8)
        g.on_oom(4)
        g2, jg2, clock2 = _govs()
        g2.restore(g.snapshot())
        jg2.restore(g.snapshot())
        assert g2.snapshot() == jg2.snapshot() and g2.ceiling == 2 and g2.degraded
        assert g2.cap() == jg2.cap() == 2
        clock2[0] = 11.0
        assert g2.cap() == jg2.cap() == 4


# --------------------------------------------------------- device circuit
class TestDeviceCircuit:
    @staticmethod
    def pair(**kw):
        return DeviceCircuit(**kw), jdf.DeviceCircuit(**kw)

    def test_compile_opens_immediately(self):
        c, jc = self.pair(after=3)
        assert c.record_fault("compile") is jc.record_fault("compile") is True
        assert c.snapshot() == jc.snapshot() and c.open and c.opens == 1

    def test_transient_opens_after_consecutive(self):
        c, jc = self.pair(after=3)
        seq = ["transient", "ok", "transient", "transient", "transient"]
        got = []
        for step in seq:
            for circ in (c, jc):
                if step == "ok":
                    circ.record_ok()
            if step != "ok":
                a, b = c.record_fault(step), jc.record_fault(step)
                assert a == b
                got.append(a)
        assert got == [False, False, False, True] and c.snapshot() == jc.snapshot()
        assert c.kinds == {"transient": 4}

    def test_probe_cadence_and_close(self):
        c, jc = self.pair(after=1, probe_every=3)
        c.record_fault("device_lost")
        jc.record_fault("device_lost")
        beats = [c.should_probe() for _ in range(6)]
        assert beats == [jc.should_probe() for _ in range(6)] == [
            False, False, True, False, False, True]
        c.close()
        jc.close()
        assert c.snapshot() == jc.snapshot() and not c.open and c.closes == 1

    def test_snapshot_restore_round_trip(self):
        c = DeviceCircuit(after=1)
        c.record_fault("compile")
        c.eager_invokes = 7
        c2, jc2 = self.pair(after=1)
        c2.restore(c.snapshot())
        jc2.restore(c.snapshot())
        assert c2.snapshot() == jc2.snapshot()
        assert c2.open and c2.kinds == {"compile": 1} and c2.eager_invokes == 7


# ----------------------------------------------------------------- policy
class TestPolicyResolution:
    def test_defaults(self):
        assert resolve_device_policy([]) == jdf.resolve_device_policy([])
        assert resolve_device_policy([])["device-fallback"] is True

    def test_element_overrides_and_env(self, monkeypatch):
        from nnstreamer_tpu.elements.filter import TensorFilter as JFilter

        monkeypatch.setenv("NNS_TPU_EXECUTOR_DEVICE_FALLBACK_AFTER", "7")
        props = dict(framework="passthrough", input="4",
                     **{"oom-policy": "stop", "device-fallback": "false"})
        got = resolve_device_policy([TensorFilter(**props)])
        assert got == jdf.resolve_device_policy([JFilter(**props)])
        assert got["oom-policy"] == "stop" and got["device-fallback"] is False
        assert got["device-fallback-after"] == 7

    def test_invalid_oom_policy_raises(self):
        f = TensorFilter(framework="passthrough", input="4", **{"oom-policy": "panic"})
        with pytest.raises(ValueError, match="oom-policy"):
            resolve_device_policy([f])


# ------------------------------------------------------------ replica set
def _sets(make, **kw):
    """The same replica callables behind both packages' ReplicaSets."""
    return ReplicaSet(make(DeviceLostError), **kw), jreplicas.ReplicaSet(make(jdf.DeviceLostError),
                                                                        **kw)


def _dispatch_both(rs, jrs, x):
    out = []
    for s in (rs, jrs):
        try:
            out.append(("ok", s.dispatch(x)))
        except Exception as exc:  # noqa: BLE001 — compared by class name
            out.append(("err", type(exc).__name__))
    assert out[0] == out[1], out
    return out[0]


class TestReplicaSet:
    def test_round_robin_over_healthy(self):
        seen = []
        rs = ReplicaSet([lambda x, i=i: seen.append(i) or x for i in range(3)])
        for v in range(6):
            rs.dispatch(v)
        assert seen == [0, 1, 2, 0, 1, 2]

    def test_failover_then_bench_then_probe_recovery(self):
        state = {"dead": True}

        def make(lost):
            def flaky(x):
                if state["dead"]:
                    raise lost("gone")
                return ("r0", x)
            return [flaky, lambda x: ("r1", x)]

        rs, jrs = _sets(make, unhealthy_after=2, probe_every=4)
        outs = [_dispatch_both(rs, jrs, i) for i in range(6)]
        assert all(o[1][0] == "r1" for o in outs)
        assert rs.stats() == jrs.stats() and rs.healthy_count == 1
        state["dead"] = False
        outs = [_dispatch_both(rs, jrs, i) for i in range(8)]
        assert rs.stats() == jrs.stats() and rs.healthy_count == 2
        assert any(o[1][0] == "r0" for o in outs)

    def test_non_device_error_propagates_unclassified(self):
        def bad(x):
            raise ValueError("bad input")

        rs = ReplicaSet([bad, lambda x: x])
        with pytest.raises(ValueError):
            rs.dispatch(1)
        assert rs.healthy_count == 2

    def test_exhaustion_raises_with_cause(self):
        def dead(x):
            raise DeviceOOMError("oom")

        rs = ReplicaSet([dead, dead], unhealthy_after=1)
        with pytest.raises(ReplicaExhaustedError) as ei:
            rs.dispatch(1)
        assert isinstance(ei.value.__cause__, DeviceOOMError) and rs.exhaustions == 1

    def test_recovery_not_starved_by_permanently_dead_low_index(self):
        def make(lost):
            calls = {"r1": 0}

            def dead(x):
                raise lost("gone for good")

            def flaky(x):
                calls["r1"] += 1
                if calls["r1"] == 1:
                    raise lost("one-off")
                return ("r1", x)
            return [dead, flaky]

        rs, jrs = _sets(make, unhealthy_after=1, probe_every=4)
        assert _dispatch_both(rs, jrs, 0) == ("err", "ReplicaExhaustedError")
        assert _dispatch_both(rs, jrs, 1) == ("ok", ("r1", 1))
        assert _dispatch_both(rs, jrs, 2) == ("ok", ("r1", 2))
        assert rs.stats() == jrs.stats() and rs.healthy_count == 1

    def test_fresh_bench_waits_full_probe_cadence(self):
        state = {"dead": False}
        calls = {"r0": 0}

        def flaky(x):
            calls["r0"] += 1
            if state["dead"]:
                raise DeviceLostError("gone")
            return ("r0", x)

        rs = ReplicaSet([flaky, lambda x: ("r1", x)], unhealthy_after=1, probe_every=4)
        for v in range(20):
            rs.dispatch(v)
        state["dead"] = True
        rs.dispatch(100)
        benched_at = calls["r0"]
        rs.dispatch(101)
        assert calls["r0"] == benched_at
        for v in range(4):
            rs.dispatch(v)
        assert calls["r0"] == benched_at + 1

    def test_probe_rotates_across_benched_replicas(self):
        probed = {"port": [], "ref": []}

        def make(lost):
            key = "port" if lost is DeviceLostError else "ref"

            def sick(name):
                def f(x):
                    probed[key].append(name)
                    raise lost(name)
                return f
            return [sick("a"), sick("b"), lambda x: x]

        rs, jrs = _sets(make, unhealthy_after=1, probe_every=2)
        for v in range(8):
            _dispatch_both(rs, jrs, v)
        assert probed["port"] == probed["ref"] and set(probed["port"][2:]) == {"a", "b"}

    def test_snapshot_restore(self):
        rs = ReplicaSet([lambda x: x] * 3)
        rs.restore({"healthy": [True, False, True], "failovers": 4, "exhaustions": 1})
        jrs = jreplicas.ReplicaSet([lambda x: x] * 3)
        jrs.restore(rs.snapshot())
        assert rs.snapshot() == jrs.snapshot() and rs.healthy_count == 2


# ----------------------------------------------- OOM degrade (pipelines)
OOM_DESC = ("tensorsrc dimensions=4 num-frames={n} pattern=counter ! "
            "tensor_filter name=f framework=faulty custom={custom},oom_above_rows:2 "
            "batching=true max-batch=8 batch-timeout-ms={t} {extra}! tensor_sink name=out")


class TestOOMDegrade:
    @pytest.mark.parametrize("custom", ["traceable:true", "batchable:true"])
    def test_batched_oom_shrinks_bucket_and_completes(self, custom):
        """The fused (traceable) and the host (batchable) ladders: the
        ceiling settles at the rung the device fits, every frame arrives in
        order. A 200 ms straggler wait fills the first window, so both
        packages see the same OOMs."""
        p, ex, jp, jex = both(OOM_DESC.format(n=100, custom=custom, t=200, extra=""))
        s = same(ex, jex, "f", OOM_KEYS)
        assert s["frames"] == 100 and s["batch_ceiling"] == 2 and s["device_degraded"] == 1
        assert values(p["out"].frames) == values(jp["out"].frames)
        assert ex.totals()["balance"] == 0
        vals = [int(f.tensors[0][0]) for f in p["out"].frames]
        assert vals == sorted(vals) and len(vals) == 100

    def test_oom_policy_stop_keeps_fail_fast(self):
        desc = OOM_DESC.format(n=40, custom="traceable:true", t=2,
                               extra="oom-policy=stop device-fallback=false ")
        with pytest.raises(DeviceOOMError):
            parse_pipeline(desc, device="cpu").run(timeout=60)
        with pytest.raises(jdf.DeviceOOMError):
            jparse(desc).run(timeout=60)


# ------------------------------------------- compile/dispatch fallback
class TestCompileFallback:
    def test_compile_failure_serves_eager_and_surfaces_degraded(self):
        desc = ("tensorsrc dimensions=4 num-frames=50 pattern=counter ! "
                "tensor_filter name=f framework=faulty custom=traceable:true,compile_fail:true ! "
                "tensor_sink name=out")
        p, ex, jp, jex = both(desc)
        s = same(ex, jex, "f", CIRCUIT_KEYS)
        assert values(p["out"].frames) == values(jp["out"].frames)
        assert s["device_degraded"] == 1 and s["device_eager_invokes"] == 50
        assert s["device_circuit_opens"] == 1

    def test_compile_failure_at_build_opens_circuit_before_frames(self):
        """A batched segment builds (and warms) its max-batch program at
        start: a failing build opens the circuit with no frame served."""
        desc = ("tensorsrc name=src dimensions=4 num-frames=0 ! "
                "tensor_filter name=f framework=faulty custom=traceable:true,compile_fail:true "
                "batching=true max-batch=4 batch-timeout-ms=2 ! tensor_sink name=out")
        p, ex, jp, jex = both(desc, timeout=30)
        s, js = ex.stats()["f"], jex.stats()["f"]
        assert s["device_degraded"] == js["device_degraded"] == 1
        assert s["frames"] == js["frames"] == 0
        assert s["device_circuit_opens"] == js["device_circuit_opens"] == 1
        assert s["device_fault_kinds"]["compile"] >= 1 and js["device_fault_kinds"]["compile"] >= 1

    @pytest.mark.parametrize("first_n,probe_every", [(1, 8), (2, 8), (3, 5)])
    def test_probe_closes_circuit_when_compile_recovers(self, monkeypatch, first_n,
                                                        probe_every):
        monkeypatch.setenv("NNS_TPU_EXECUTOR_DEVICE_PROBE_EVERY", str(probe_every))
        desc = ("tensorsrc dimensions=4 num-frames=60 pattern=counter ! "
                "tensor_filter name=f framework=faulty custom=traceable:true,compile_fail:true,"
                f"compile_fail_first_n:{first_n} ! tensor_sink name=out")
        p, ex, jp, jex = both(desc)
        s = same(ex, jex, "f", CIRCUIT_KEYS)
        assert values(p["out"].frames) == values(jp["out"].frames)
        assert len(p["out"].frames) == 60
        assert s["device_degraded"] == 0  # recovered
        assert s["device_eager_invokes"] == first_n * probe_every
        assert ex.stats()["f"]["device_circuit_closes"] == 1

    def test_fallback_off_propagates_to_error_policy(self):
        desc = ("tensorsrc dimensions=4 num-frames=30 pattern=counter ! "
                "tensor_chaos name=c device-fault-kind=device_lost device-fault-every-n=5 "
                "on-error=drop ! tensor_sink name=out")
        p, ex, jp, jex = both(desc)
        s = same(ex, jex, "c", FAULT_KEYS)
        assert s["error_dropped"] == 6 and len(p["out"].frames) == 24
        assert values(p["out"].frames) == values(jp["out"].frames)
        assert ex.totals()["balance"] == 0

    def test_device_fallback_false_stops_with_the_build_fault(self):
        desc = ("tensorsrc dimensions=4 num-frames=5 pattern=counter ! "
                "tensor_filter name=f framework=faulty custom=traceable:true,compile_fail:true "
                "device-fallback=false ! tensor_sink name=out")
        with pytest.raises(DeviceCompileError, match="build 1"):
            parse_pipeline(desc, device="cpu").run(timeout=30)
        with pytest.raises(jdf.DeviceCompileError):
            jparse(desc).run(timeout=30)

    def test_chaos_device_fault_needs_kind(self):
        from nnstreamer_tpu_torch.elements.chaos import TensorChaos

        with pytest.raises(ValueError, match="device-fault-kind"):
            TensorChaos(**{"device-fault-every-n": "5"})


# -------------------------------------------------------- replica failover
class TestReplicaFailover:
    def test_one_replica_lost_stream_survives_with_exact_accounting(self):
        desc = ("tensorsrc dimensions=4 num-frames=100 pattern=counter ! "
                "tensor_filter name=f framework=faulty replicas=2 replica-unhealthy-after=2 "
                "custom=device_lost_at:3,only_replica:0 ! tensor_sink name=out")
        p, ex, jp, jex = both(desc)
        s = same(ex, jex, "f", REPLICA_KEYS)
        assert values(p["out"].frames) == values(jp["out"].frames)
        assert len(p["out"].frames) == 100 and ex.totals()["balance"] == 0
        assert s["rep_healthy"] == 1 and s["rep_failovers"] >= 1 and s["rep_served"][1] > 90

    @pytest.mark.parametrize("policy,tail", [
        ("drop", ""), ("route", "f.src_1 ! tensor_sink name=dlq")])
    def test_exhaustion_disposes_through_error_policy(self, policy, tail):
        desc = ("tensorsrc dimensions=4 num-frames=40 pattern=counter ! "
                "tensor_filter name=f framework=faulty replicas=2 replica-unhealthy-after=1 "
                f"custom=device_lost_at:5 on-error={policy} ! tensor_sink name=out {tail}")
        p, ex, jp, jex = both(desc)
        s = same(ex, jex, "f", REPLICA_KEYS + FAULT_KEYS)
        assert s["rep_healthy"] == 0 and ex.totals()["balance"] == 0
        assert values(p["out"].frames) == values(jp["out"].frames)
        if tail:
            dlq = p["dlq"].frames
            assert len(p["out"].frames) + len(dlq) == 40 and len(dlq) > 0
            assert dlq[0].meta["error_type"] == "ReplicaExhaustedError"
        else:
            assert len(p["out"].frames) + s["error_dropped"] == 40

    def test_partial_replica_open_failure_closes_opened_tail(self):
        f = TensorFilter(framework="framecounter", replicas="3", input="4", inputtype="float32")
        f.device = torch.device("cpu")
        opened, closed = [], []
        orig = f._open_backend

        def tracked(custom_extra="", device=None):
            if len(opened) == 2:
                raise RuntimeError("replica 2 open failed")
            b = orig(custom_extra, device)
            opened.append(b)
            real_close = b.close
            b.close = lambda: (closed.append(b), real_close())
            return b

        f._open_backend = tracked
        with pytest.raises(RuntimeError, match="replica 2"):
            f._ensure_replicas()
        assert closed == [opened[1]]
        assert f._replica_set is None and f._replica_backends == []
        f.stop()
        assert opened[0] in closed

    @pytest.mark.parametrize("props,match", [
        ({"fallback-framework": "passthrough"}, "fallback"),
        ({"shared-tensor-filter-key": "k"}, "replicas"),
    ])
    def test_replicas_reject_conflicts(self, props, match):
        from nnstreamer_tpu.elements.filter import TensorFilter as JFilter

        for cls in (TensorFilter, JFilter):
            with pytest.raises(ValueError, match=match) as ei:
                cls(name="f", framework="framecounter", replicas="2", input="4", **props)
            if cls is TensorFilter:
                msg = str(ei.value)
            else:
                assert str(ei.value) == msg

    def test_replica_devices_are_range_checked_before_any_load(self, monkeypatch):
        """On CUDA a replica-devices index is cuda:<i>, checked before any
        load; on the CPU every index is the one CPU device."""
        f = TensorFilter(framework="passthrough", replicas="2", **{"replica-devices": "0,7"})
        f.device = torch.device("cpu")
        assert f._replica_device(1) == torch.device("cpu")
        f.device = torch.device("cuda")
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        assert f._replica_device(0) == torch.device("cuda", 0)
        with pytest.raises(ValueError, match="index 7 out of range"):
            f._replica_device(1)

    def test_replica_tags_reach_each_backend(self):
        p = parse_pipeline("tensorsrc dimensions=4 num-frames=4 ! "
                           "tensor_filter name=f framework=faulty replicas=3 ! tensor_sink",
                           device="cpu")
        p.negotiate()
        f = p["f"]
        f._ensure_replicas()
        assert [b._replica_idx for b in f._replica_backends] == ["0", "1", "2"]
        f.stop()


# ------------------------------------------------- warm restart round-trip
class TestWarmRestart:
    DESC = ("tensorsrc name=src dimensions=4 num-frames={n} pattern=counter ! "
            "tensor_filter name=f framework=framecounter ! tensor_sink name=out")

    def test_drain_snapshot_resume_in_place(self):
        p = parse_pipeline(self.DESC.format(n=3000), device="cpu")
        ex = p.start()
        time.sleep(0.1)
        assert ex.drain(timeout=15) is True
        snap = ex.snapshot()
        mid = len(p["out"].frames)
        assert snap["elements"]["f"]["backend"]["count"] == mid
        assert snap["nodes"]["f"]["frames"] == mid and ex.inflight() == 0
        ex.resume()
        assert ex.wait(60), ex.errors
        ex.stop()
        vals = [int(f.tensors[0][0]) for f in p["out"].frames]
        assert vals == list(range(3000))
        assert ex.totals()["balance"] == 0
        # the snapshot has the reference's layout, node by node
        jp = jparse(self.DESC.format(n=3))
        jex = jp.run(timeout=30)
        jsnap = jex.snapshot()
        assert set(snap) == set(jsnap) and set(snap["nodes"]) == set(jsnap["nodes"])
        assert set(snap["nodes"]["f"]) == set(jsnap["nodes"]["f"])

    def test_warm_restart_into_fresh_executor(self, tmp_path):
        p1 = parse_pipeline(self.DESC.format(n=5000), device="cpu")
        ex1 = p1.start()
        time.sleep(0.1)
        assert ex1.drain(timeout=15) is True
        path = str(tmp_path / "warm.json")
        snap = ex1.save_snapshot(path)
        n1 = snap["elements"]["f"]["backend"]["count"]
        assert n1 > 0
        ex1.stop()
        p2 = parse_pipeline(self.DESC.format(n=20), device="cpu")
        ex2 = Executor(p2.compile_plan())
        ex2.restore(Executor.read_snapshot(path))
        ex2.start()
        assert ex2.wait(30), ex2.errors
        ex2.stop()
        vals = [int(f.tensors[0][0]) for f in p2["out"].frames]
        assert vals == list(range(n1, n1 + 20))
        assert ex2.stats()["f"]["frames"] == n1 + 20
        # a snapshot the reference wrote restores the port's executor too
        jex = jparse(self.DESC.format(n=5000)).start()
        time.sleep(0.1)
        assert jex.drain(timeout=15) is True
        jpath = str(tmp_path / "jwarm.json")
        j1 = jex.save_snapshot(jpath)["elements"]["f"]["backend"]["count"]
        jex.stop()
        p3 = parse_pipeline(self.DESC.format(n=3), device="cpu")
        ex3 = Executor(p3.compile_plan())
        ex3.restore(JExecutor.read_snapshot(jpath))
        ex3.start()
        assert ex3.wait(30)
        ex3.stop()
        assert [int(f.tensors[0][0]) for f in p3["out"].frames] == [j1, j1 + 1, j1 + 2]

    def test_restart_remembers_oom_ceiling(self):
        desc = OOM_DESC.format(n=60, custom="traceable:true", t=200, extra="")
        p1 = parse_pipeline(desc, device="cpu")
        ex1 = p1.run(timeout=60)
        s1 = ex1.stats()["f"]
        assert s1["oom_events"] >= 1 and s1["batch_ceiling"] == 2
        snap = ex1.snapshot()
        p2 = parse_pipeline(desc, device="cpu")
        ex2 = Executor(p2.compile_plan())
        ex2.restore(snap)
        ex2.start()
        assert ex2.wait(60), ex2.errors
        ex2.stop()
        s2 = ex2.stats()["f"]
        assert len(p2["out"].frames) == 60
        assert s2["oom_events"] == s1["oom_events"] and s2["batch_ceiling"] == 2
        assert p2["f"].backend is None and s2["avg_batch_size"] <= 2.0

    def test_restore_before_first_frame_keeps_replica_health(self):
        f = TensorFilter(framework="faulty", replicas="2", input="4", inputtype="float32")
        f.device = torch.device("cpu")
        f.state_restore({"replica_set": {"healthy": [False, True], "failovers": 7}})
        rs = f._ensure_replicas()
        assert [r.healthy for r in rs.replicas] == [False, True] and rs.failovers == 7
        f.stop()

    def test_replica_backend_state_rides_the_snapshot(self):
        f1 = TensorFilter(framework="framecounter", replicas="2", input="4", inputtype="float32")
        f1.device = torch.device("cpu")
        f1._ensure_replicas()
        f1.backend._count = 5
        f1._replica_backends[1]._count = 3
        snap = f1.state_snapshot()
        f1.stop()
        assert snap["replica_backends"] == [{"count": 3}]
        f2 = TensorFilter(framework="framecounter", replicas="2", input="4", inputtype="float32")
        f2.device = torch.device("cpu")
        f2.state_restore(snap)
        f2._ensure_replicas()
        assert f2.backend._count == 5 and f2._replica_backends[1]._count == 3
        f2.stop()

    def test_restore_section_survives_until_target_builds(self):
        p = parse_pipeline("tensorsrc name=src dimensions=4 num-frames=10 ! "
                           "tensor_filter name=f framework=faulty custom=traceable:true "
                           "batching=true max-batch=8 ! tensor_sink name=out", device="cpu")
        ex = Executor(p.compile_plan())
        n = next(nd for nd in ex.nodes if nd.name == "f")
        n.restore_state({"frames": 4, "governor": {"ceiling": 2, "max": 8, "ooms": 3,
                                                   "reprobes": 0}})
        n._apply_pending_restore()
        assert "governor" in n._pending_restore
        n.bucket_governor = BucketGovernor([1, 2, 4, 8])
        n._apply_pending_restore()
        assert n.bucket_governor.ceiling == 2 and n.bucket_governor.ooms == 3
        assert n._pending_restore is None

    def test_drain_settle_outlasts_slow_invokes(self):
        p = parse_pipeline("tensorsrc name=src dimensions=4 num-frames=400 ! "
                           "tensor_chaos name=c delay-ms=80 delay-every-n=1 ! "
                           "tensor_sink name=out", device="cpu")
        ex = p.start()
        time.sleep(0.9)
        assert ex.drain(timeout=30) is True
        mid = ex.snapshot()["nodes"]["c"]["frames"]
        time.sleep(0.3)
        assert ex.snapshot()["nodes"]["c"]["frames"] == mid == len(p["out"].frames)
        ex.resume()
        ex.stop()

    def test_drain_timeout_returns_false_and_pipeline_survives(self):
        p = parse_pipeline("tensorsrc name=src dimensions=4 num-frames=60 pattern=counter ! "
                           "tensor_chaos name=c delay-ms=20 delay-every-n=1 ! "
                           "tensor_sink name=out", device="cpu")
        ex = p.start()
        assert ex.drain(timeout=0.2) is False
        ex.resume()
        assert ex.wait(60), ex.errors
        ex.stop()
        assert len(p["out"].frames) == 60


# ------------------------------------------------------ the labeling slice
@pytest.fixture(scope="module")
def mobilenet_npz(tmp_path_factory):
    jp = jmobilenet.init_params(jax.random.PRNGKey(0), num_classes=16, width=0.5)
    path = tmp_path_factory.mktemp("mbv2") / "w.npz"
    np.savez(path, **{f"p{i}": np.asarray(v) for i, v in enumerate(jax.tree_util.tree_leaves(jp))})
    return str(path)


SLICE = ("videotestsrc pattern=gradient width=80 height=48 num-frames=24 ! tensor_converter ! "
         "tensor_transform mode=resize option=64:64 ! {faulty}"
         "tensor_filter name=m framework={fw} model=zoo:mobilenet_v2 {props}"
         'custom="size:64,num_classes:16,width:0.5,params:{npz}" ! '
         "tensor_decoder mode=image_labeling ! tensor_sink name=out")


def _first_collect_after(collect, depth, n, timeout_s=60.0):
    """``collect`` whose first call on each collector waits until
    ``depth(collector)`` items are queued (or the node stops)."""

    def gated(self):
        if not getattr(self, "_gate_passed", False):
            self._gate_passed = True
            end = time.monotonic() + timeout_s
            while (depth(self) < n and time.monotonic() < end
                   and not self.stop_event.is_set()):
                time.sleep(0.002)
        return collect(self)

    return gated


class TestLabelingSlice:
    """The card path of the fault group at a small size, through both
    packages: labels equal to the unfaulted run's, counters equal."""

    @staticmethod
    def run(npz, faulty="", props="", fw="torch", env=None):
        desc = SLICE.format(faulty=faulty, props=props, npz=npz, fw=fw)
        if fw == "torch":
            p = parse_pipeline(desc, device="cpu")
        else:
            p = jparse(desc)
        ex = p.run(timeout=300)
        return [int(np.asarray(f.tensors[0]).reshape(-1)[0]) for f in p["out"].frames], ex

    @pytest.fixture(scope="class")
    def plain(self, mobilenet_npz):
        labels, _ = self.run(mobilenet_npz)
        jlabels, _ = self.run(mobilenet_npz, fw="jax")
        assert labels == jlabels and len(labels) == 24
        return labels

    @staticmethod
    def node(ex, name):
        return next(v for k, v in ex.stats().items() if name in k.split("+"))

    def test_compile_fallback(self, mobilenet_npz, plain, monkeypatch):
        monkeypatch.setenv("NNS_TPU_EXECUTOR_DEVICE_PROBE_EVERY", "2")
        faulty = ("tensor_filter name=x framework=faulty "
                  "custom=traceable:true,compile_fail:true,compile_fail_first_n:2 ! ")
        labels, ex = self.run(mobilenet_npz, faulty)
        jlabels, jex = self.run(mobilenet_npz, faulty.replace("name=x", "name=x"), fw="jax")
        assert labels == jlabels == plain
        s, js = self.node(ex, "x"), self.node(jex, "x")
        for k in CIRCUIT_KEYS:
            assert s.get(k) == js.get(k), (k, s, js)
        assert s["device_eager_invokes"] == 4 and s["device_degraded"] == 0
        assert s["device_circuit_closes"] == 1

    def test_oom_ladder(self, mobilenet_npz, plain, monkeypatch):
        """Both packages see the same windows: the batched segment's first
        collect waits until its inbox holds all 24 frames, so the first
        window is 8 rows (OOM at 8, then at 4: ceiling 2) and every later
        window is capped at the ceiling. Otherwise what each collector
        finds queued when it wakes, and so the number of OOMs before the
        ceiling reaches 2, depends on thread timing."""
        from nnstreamer_tpu.pipeline.batching import BatchCollector as JCollector
        from nnstreamer_tpu_torch.pipeline.batching import BatchCollector

        for cls, depth in ((BatchCollector, lambda c: c.inbox.qsize()),
                           (JCollector, lambda c: len(c.chan))):
            monkeypatch.setattr(cls, "collect", _first_collect_after(cls.collect, depth, 24))
        faulty = "tensor_filter name=x framework=faulty custom=traceable:true,oom_above_rows:2 ! "
        props = "batching=true max-batch=8 batch-timeout-ms=200 "
        labels, ex = self.run(mobilenet_npz, faulty, props)
        jlabels, jex = self.run(mobilenet_npz, faulty, props, fw="jax")
        assert labels == jlabels == plain
        s, js = self.node(ex, "x"), self.node(jex, "x")
        for k in OOM_KEYS:
            assert s.get(k) == js.get(k), (k, s, js)
        assert s["batch_ceiling"] == 2 and s["frames"] == 24 and s["oom_events"] == 2

    def test_replicas(self, mobilenet_npz, plain):
        labels, ex = self.run(mobilenet_npz, props="replicas=2 ")
        jlabels, jex = self.run(mobilenet_npz, props="replicas=2 ", fw="jax")
        assert labels == jlabels == plain
        s, js = ex.stats()["m"], jex.stats()["m"]
        for k in REPLICA_KEYS:
            assert s.get(k) == js.get(k), (k, s, js)
        assert s["rep_served"] == [12, 12] and s["rep_healthy"] == 2


def test_drain_waits_for_a_frame_held_in_the_straggler_wait():
    """A batched node's collector holds a lone frame for up to
    batch-timeout-ms waiting for a second: drain counts it as in flight
    and settles only once it is delivered, so a snapshot taken then
    balances (the reference's drain can settle with the frame held)."""
    from nnstreamer_tpu_torch.elements.sources import AppSrc

    p = parse_pipeline("appsrc name=src dimensions=4 types=float32 ! tensor_filter name=f "
                       "framework=scaler batching=true max-batch=8 batch-timeout-ms=400 ! "
                       "tensor_sink name=out", device="cpu")
    ex = p.start()
    assert isinstance(p["src"], AppSrc)
    p["src"].push(Frame((torch.ones(4),)))
    time.sleep(0.1)  # the collector took the frame and waits for a straggler
    assert ex.inflight() == 1
    assert ex.drain(timeout=10, settle_s=0.06) is True
    assert len(p["out"].frames) == 1 and ex.inflight() == 0
    assert ex.totals()["balance"] == 0
    ex.resume()
    p["src"].end_of_stream()
    assert ex.wait(10)
    ex.stop()
