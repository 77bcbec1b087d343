"""The port's per-element error policies (nnstreamer_tpu_torch/pipeline/
faults.py, the executor's fault gate, tensor_chaos, the faulty fake, the
filter's backend-swap breaker) against the JAX package's, on the CPU.

Every pipeline runs through both packages with the same description; the
fakes are deterministic (seeded RNG, invoke counters, a per-node jitter
seed), so the per-frame outputs AND the counters must be equal: errors,
dropped, routed, retries, exhausted, the backoff total, the breaker's
counters and the pipeline totals. The counterpart of tests/test_faults.py
(TestPolicies, TestBackoff, TestBatchSplit, TestStallWatchdog,
TestFallbackCircuitBreaker, TestChaosElement, TestConfigDefaults) and of
tests/test_failures.py's error-propagation case.
"""

import random
import threading
import time

import numpy as np
import pytest

from nnstreamer_tpu.pipeline import faults as jfaults
from nnstreamer_tpu.pipeline.parse import parse_pipeline as jparse
from nnstreamer_tpu.tensors.frame import Frame as JFrame
from nnstreamer_tpu_torch.backends.base import BackendError
from nnstreamer_tpu_torch.elements.base import ElementError
from nnstreamer_tpu_torch.pipeline.executor import Executor
from nnstreamer_tpu_torch.pipeline.faults import (
    FaultPolicy,
    PipelineStallError,
    backoff_s,
    resolve_fault_policy,
)
from nnstreamer_tpu_torch.pipeline.parse import parse_pipeline
from nnstreamer_tpu_torch.tensors.frame import Frame

N_FRAMES = 200
CHAOS_FILTER = "tensor_filter name=f framework=faulty custom=fail_rate:0.2,seed:7"
FAULT_KEYS = ("frames", "errors", "error_dropped", "error_routed", "error_retries",
              "error_backoff_ms")


def _chaos(policy_props, tail="", n=N_FRAMES):
    return (f"tensorsrc dimensions=4 num-frames={n} pattern=counter ! "
            f"{CHAOS_FILTER} {policy_props} ! tensor_sink name=out {tail}")


def both(desc, timeout=60):
    """``desc`` run to EOS through the port (on the CPU) and the reference."""
    p = parse_pipeline(desc, device="cpu")
    ex = p.run(timeout=timeout)
    jp = jparse(desc)
    jex = jp.run(timeout=timeout)
    return p, ex, jp, jex


def values(frames):
    return [np.asarray(f.tensors[0]).tolist() for f in frames]


def same_counters(ex, jex, node, keys=FAULT_KEYS):
    got, want = ex.stats()[node], jex.stats()[node]
    for k in keys:
        assert got.get(k) == want.get(k), (k, got, want)
    return got


def same_totals(ex, jex):
    got, want = ex.totals(), jex.totals()
    for k in ("produced", "rendered", "dropped", "balance"):
        assert got[k] == want[k], (k, got, want)
    return got


class TestPolicies:
    def test_drop_completes_with_exact_accounting(self):
        p, ex, jp, jex = both(_chaos("on-error=drop"))
        assert not ex.errors and not jex.errors
        s = same_counters(ex, jex, "f")
        assert values(p["out"].frames) == values(jp["out"].frames)
        assert s["error_dropped"] > 0
        assert len(p["out"].frames) + s["error_dropped"] == N_FRAMES
        t = same_totals(ex, jex)
        assert t["balance"] == 0 and t["dropped"]["on-error-drop"] == s["error_dropped"]

    def test_retry_delivers_every_frame(self):
        p, ex, jp, jex = both(_chaos("on-error=retry retry-max=8 retry-backoff-ms=0.5"))
        s = same_counters(ex, jex, "f")
        assert values(p["out"].frames) == values(jp["out"].frames)
        assert len(p["out"].frames) == N_FRAMES
        assert s["error_retries"] > 0 and s["error_dropped"] == 0

    def test_route_dead_letters_to_error_pad(self):
        p, ex, jp, jex = both(_chaos("on-error=route", tail="f.src_1 ! tensor_sink name=dlq"))
        same_counters(ex, jex, "f")
        main, dlq = p["out"].frames, p["dlq"].frames
        assert values(main) == values(jp["out"].frames)
        assert values(dlq) == values(jp["dlq"].frames)
        assert len(dlq) > 0 and len(main) + len(dlq) == N_FRAMES
        assert same_totals(ex, jex)["balance"] == 0
        err, jerr = dlq[0], jp["dlq"].frames[0]
        for k in ("error", "error_element", "error_type", "error_msg"):
            assert err.meta[k] == jerr.meta[k]
        assert err.meta["error_type"] == "BackendError"

    def test_route_pad_is_a_fusion_barrier(self):
        """A linked error pad keeps the element out of fused segments; an
        unlinked one (retry with no overflow sink) fuses."""
        desc = ("tensorsrc dimensions=4 num-frames=4 ! "
                "tensor_transform name=t mode=typecast option=float32 on-error={mode} ! "
                "tensor_filter name=g framework=scaler ! tensor_sink{tail}")
        linked = parse_pipeline(desc.format(mode="route", tail=" t.src_1 ! tensor_sink"),
                                device="cpu").compile_plan()
        assert [s.fused for s in linked.segments] == [False, True]
        unlinked = parse_pipeline(desc.format(mode="retry", tail=""), device="cpu").compile_plan()
        assert [[o.name for o in s.ops] for s in unlinked.segments] == [["t", "g"]]

    @pytest.mark.parametrize("props", ["on-error=stop", ""])
    def test_stop_fails_fast_with_original_exception(self, props):
        desc = ("tensorsrc dimensions=4 num-frames=20 pattern=counter ! "
                f"tensor_filter framework=faulty custom=fail_every_n:5 {props} ! tensor_sink")
        with pytest.raises(BackendError, match="injected failure on invoke 5"):
            parse_pipeline(desc, device="cpu").run(timeout=30)
        with pytest.raises(Exception, match="injected failure on invoke 5"):
            jparse(desc).run(timeout=30)

    @pytest.mark.parametrize("tail", ["", "f.src_1 ! tensor_sink name=dlq"])
    def test_retry_exhaustion(self, tail):
        """A permanently failing element: each frame's budget runs out; it
        drops, or with the error pad linked is routed. No crash."""
        desc = ("tensorsrc dimensions=4 num-frames=10 pattern=counter ! "
                "tensor_filter name=f framework=faulty custom=fail_rate:1.0 "
                "on-error=retry retry-max=1 retry-backoff-ms=0.2 ! "
                f"tensor_sink name=out {tail}")
        p, ex, jp, jex = both(desc)
        s = same_counters(ex, jex, "f")
        assert len(p["out"].frames) == 0
        assert ex.stats()["f"]["error_retry_exhausted"] == 10
        if tail:
            assert len(p["dlq"].frames) == len(jp["dlq"].frames) == 10
            assert s["error_routed"] == 10 and s["error_dropped"] == 0
        else:
            assert s["error_dropped"] == 10

    def test_default_stop_propagates_a_callback_error(self):
        """tests/test_failures.py's case: a failing element stops the run
        with its own error, never a hang."""
        from nnstreamer_tpu.backends.custom import register_custom_easy as jreg
        from nnstreamer_tpu.backends.custom import unregister_custom_easy as junreg
        from nnstreamer_tpu_torch.backends.custom import (
            register_custom_easy,
            unregister_custom_easy,
        )

        def boom(tensors):
            raise RuntimeError("injected failure")

        desc = ("tensorsrc dimensions=4 types=float32 num-frames=2 ! "
                "tensor_filter framework=custom-easy model=boom_fn ! tensor_sink")
        register_custom_easy("boom_fn", boom)
        jreg("boom_fn", boom)
        try:
            with pytest.raises(RuntimeError, match="injected failure"):
                parse_pipeline(desc, device="cpu").run(timeout=60)
            with pytest.raises(Exception, match="injected failure"):
                jparse(desc).run(timeout=60)
        finally:
            unregister_custom_easy("boom_fn")
            junreg("boom_fn")


class TestBackoff:
    def test_backoff_bounds_exponential_jittered_capped(self):
        policy = FaultPolicy(on_error="retry", retry_max=10, backoff_ms=10.0,
                             backoff_cap_ms=50.0)
        jpolicy = jfaults.FaultPolicy(on_error="retry", retry_max=10, backoff_ms=10.0,
                                      backoff_cap_ms=50.0)
        rng, jrng = random.Random(1), random.Random(1)
        for attempt in range(8):
            full = min(10.0 * 2 ** attempt, 50.0) / 1000.0
            for _ in range(16):
                d = backoff_s(attempt, policy, rng)
                assert d == jfaults.backoff_s(attempt, jpolicy, jrng)
                assert 0.5 * full <= d <= full

    def test_observed_backoff_within_configured_bounds(self):
        desc = ("tensorsrc dimensions=4 num-frames=40 pattern=counter ! "
                "tensor_filter name=f framework=faulty custom=fail_every_n:4 "
                "on-error=retry retry-max=3 retry-backoff-ms=5 ! tensor_sink name=out")
        p, ex, jp, jex = both(desc)
        s = same_counters(ex, jex, "f")
        assert len(p["out"].frames) == 40 and s["error_retries"] > 0
        assert 2.5 <= s["error_backoff_ms"] / s["error_retries"] <= 5.0


class TestBatchSplit:
    def test_host_batched_window_splits_per_frame(self):
        """One bad frame never discards its batchmates. The windows depend
        on thread timing, so the split's counters are held to the frames
        (each frame fails or passes by its invoke count alone)."""
        desc = ("tensorsrc dimensions=4 num-frames=60 pattern=counter ! "
                "tensor_filter name=f framework=faulty custom=fail_every_n:7,batchable:true "
                "batching=true max-batch=8 on-error=drop ! tensor_sink name=out")
        p, ex, jp, jex = both(desc)
        assert not ex.errors
        s, js = ex.stats()["f"], jex.stats()["f"]
        delivered = len(p["out"].frames)
        assert delivered + s["error_dropped"] == 60 == len(jp["out"].frames) + js["error_dropped"]
        assert 0 < s["error_dropped"] < 60
        assert ex.totals()["balance"] == 0

    def test_fused_batch_split_reruns_per_frame(self):
        desc = ("tensorsrc dimensions=4 num-frames=40 pattern=counter ! "
                "tensor_filter framework=scaler custom=factor:2.0 batching=true max-batch=8 "
                "batch-timeout-ms=5 on-error=drop ! tensor_sink name=out")
        p = parse_pipeline(desc, device="cpu")
        plan = p.compile_plan()
        (seg,) = plan.segments
        orig = seg.process_batch
        calls = {"n": 0}

        def flaky(frames, cfg):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("injected batch failure")
            return orig(frames, cfg)

        seg.process_batch = flaky
        ex = Executor(plan)
        ex.start()
        assert ex.wait(30)
        ex.stop()
        assert not ex.errors
        vals = sorted(int(f.tensors[0][0]) for f in p["out"].frames)
        assert vals == sorted(range(0, 80, 2))  # nothing lost with the failed window
        ref = jparse(desc).run(timeout=30)
        assert sorted(int(np.asarray(f.tensors[0])[0])
                      for f in ref.plan.pipeline["out"].frames) == vals


class TestStallWatchdog:
    def test_hang_becomes_typed_stall_error(self, monkeypatch):
        monkeypatch.setenv("NNS_TPU_EXECUTOR_WATCHDOG_TIMEOUT_MS", "200")
        desc = ("tensorsrc dimensions=4 num-frames=30 pattern=counter ! "
                "tensor_chaos hang-on-frame=5 hang-ms=1200 ! tensor_sink")
        with pytest.raises(PipelineStallError) as ei:
            parse_pipeline(desc, device="cpu").run(timeout=10)
        with pytest.raises(jfaults.PipelineStallError) as jei:
            jparse(desc).run(timeout=10)
        exc = ei.value
        assert exc.timeout_ms == jei.value.timeout_ms == 200
        assert len(exc.snapshot) == len(jei.value.snapshot) == 3
        chaos = next(s for n, s in exc.snapshot.items() if "chaos" in n)
        jchaos = next(s for n, s in jei.value.snapshot.items() if "chaos" in n)
        assert chaos == jchaos and sum(chaos["queued"]) > 0  # the hang is localized

    def test_no_false_positive_on_retry_backoff(self, monkeypatch):
        monkeypatch.setenv("NNS_TPU_EXECUTOR_WATCHDOG_TIMEOUT_MS", "150")
        desc = ("tensorsrc dimensions=4 num-frames=12 pattern=counter ! "
                "tensor_filter name=f framework=faulty custom=fail_every_n:4 "
                "on-error=retry retry-max=2 retry-backoff-ms=250 ! tensor_sink name=out")
        p = parse_pipeline(desc, device="cpu")
        ex = p.run(timeout=30)
        assert not ex.errors and not ex.stalled
        assert len(p["out"].frames) == 12

    def test_no_false_positive_on_healthy_pipeline(self, monkeypatch):
        monkeypatch.setenv("NNS_TPU_EXECUTOR_WATCHDOG_TIMEOUT_MS", "200")
        p = parse_pipeline("tensorsrc dimensions=4 num-frames=50 pattern=counter ! "
                           "tensor_transform mode=typecast option=float32 ! tensor_sink name=out",
                           device="cpu")
        ex = p.run(timeout=30)
        assert not ex.errors and not ex.stalled and len(p["out"].frames) == 50


class TestFallbackCircuitBreaker:
    def test_swap_then_recover(self):
        desc = ("tensorsrc dimensions=4 num-frames=40 pattern=counter ! "
                "tensor_filter name=f framework=faulty custom=fail_first_n:3 "
                "on-error=retry retry-max=4 retry-backoff-ms=0.5 "
                "fallback-framework=passthrough fallback-after=3 fallback-probe-every=8 ! "
                "tensor_sink name=out")
        p, ex, jp, jex = both(desc)
        keys = FAULT_KEYS + ("cb_primary_failures", "cb_circuit_opens", "cb_circuit_closes",
                             "cb_fallback_invokes", "cb_fallback_active")
        s = same_counters(ex, jex, "f", keys)
        assert values(p["out"].frames) == values(jp["out"].frames)
        assert len(p["out"].frames) == 40
        assert s["cb_circuit_opens"] == s["cb_circuit_closes"] == 1
        assert 0 < s["cb_fallback_invokes"] <= 8 and s["cb_fallback_active"] == 0

    def test_fallback_is_fusion_barrier(self):
        desc = ("tensorsrc dimensions=4 num-frames=2 pattern=counter ! "
                "tensor_filter framework=scaler custom=factor:2.0 "
                "fallback-framework=passthrough ! tensor_sink")
        plan = parse_pipeline(desc, device="cpu").compile_plan()
        assert [s.fused for s in plan.segments] == [False]  # one host-path op
        assert jparse(desc).compile_plan().segments == []


class TestChaosElement:
    def test_corruption_drives_downstream_policy(self):
        desc = ("tensorsrc dimensions=4 num-frames=32 pattern=counter ! "
                "tensor_chaos corrupt-every-n=4 ! tensor_filter name=f framework=faulty "
                "custom=strict_shapes:true on-error=drop ! tensor_sink name=out")
        p, ex, jp, jex = both(desc, timeout=30)
        s = same_counters(ex, jex, "f")
        assert values(p["out"].frames) == values(jp["out"].frames)
        assert len(p["out"].frames) == 24 and s["error_dropped"] == 8

    def test_chaos_own_policy_routes(self):
        desc = ("tensorsrc dimensions=4 num-frames=20 pattern=counter ! "
                "tensor_chaos name=c fail-every-n=5 on-error=route ! "
                "tensor_sink name=out c.src_1 ! tensor_sink name=dlq")
        p, ex, jp, jex = both(desc, timeout=30)
        same_counters(ex, jex, "c")
        assert len(p["out"].frames) == 16 and len(p["dlq"].frames) == 4
        assert values(p["dlq"].frames) == values(jp["dlq"].frames)
        assert p["dlq"].frames[0].meta["error_type"] == "ElementError"
        assert issubclass(ElementError, RuntimeError)

    @pytest.mark.parametrize("raise_type,exc", [("value", ValueError), ("runtime", RuntimeError)])
    def test_chaos_raise_type_stops_with_that_class(self, raise_type, exc):
        desc = ("tensorsrc dimensions=4 num-frames=10 pattern=counter ! "
                f"tensor_chaos fail-every-n=3 raise-type={raise_type} ! tensor_sink")
        with pytest.raises(exc, match="injected failure on frame 3"):
            parse_pipeline(desc, device="cpu").run(timeout=30)
        with pytest.raises(exc, match="injected failure on frame 3"):
            jparse(desc).run(timeout=30)


class TestConfigDefaults:
    def test_executor_default_policy_from_env(self, monkeypatch):
        monkeypatch.setenv("NNS_TPU_EXECUTOR_ON_ERROR", "drop")
        monkeypatch.setenv("NNS_TPU_EXECUTOR_RETRY_MAX", "5")
        got, want = resolve_fault_policy([]), jfaults.resolve_fault_policy([])
        assert (got.on_error, got.retry_max, got.backoff_ms, got.backoff_cap_ms) == (
            want.on_error, want.retry_max, want.backoff_ms, want.backoff_cap_ms) == (
            "drop", 5, 10.0, 1000.0)

    def test_element_property_outranks_config(self, monkeypatch):
        from nnstreamer_tpu.elements.transform import TensorTransform as JTransform
        from nnstreamer_tpu_torch.elements.transform import TensorTransform

        monkeypatch.setenv("NNS_TPU_EXECUTOR_ON_ERROR", "drop")
        props = dict(mode="typecast", option="float32", **{"on-error": "retry"})
        assert resolve_fault_policy([TensorTransform(**props)]).on_error == "retry"
        assert jfaults.resolve_fault_policy([JTransform(**props)]).on_error == "retry"

    @pytest.mark.parametrize("elem", ["transform", "converter", "decoder", "filter", "chaos"])
    def test_bad_on_error_value_rejected(self, elem):
        from nnstreamer_tpu_torch import registry

        factory = {"transform": ("tensor_transform", dict(mode="typecast", option="float32")),
                   "converter": ("tensor_converter", {}),
                   "decoder": ("tensor_decoder", dict(mode="image_labeling")),
                   "filter": ("tensor_filter", dict(framework="passthrough")),
                   "chaos": ("tensor_chaos", {})}[elem]
        cls = registry.get(registry.KIND_ELEMENT, factory[0])
        with pytest.raises(ValueError, match="on-error"):
            cls(**factory[1], **{"on-error": "explode"})

    def test_unset_knobs_default_from_the_executor_section(self, monkeypatch):
        monkeypatch.setenv("NNS_TPU_EXECUTOR_RETRY_BACKOFF_MS", "bogus")
        got = resolve_fault_policy([])  # a malformed value falls back
        assert got.backoff_ms == jfaults.resolve_fault_policy([]).backoff_ms == 10.0
        monkeypatch.setenv("NNS_TPU_EXECUTOR_WATCHDOG_TIMEOUT_MS", "75")
        assert Executor(parse_pipeline("tensorsrc dimensions=4 num-frames=1 ! tensor_sink",
                                       device="cpu").compile_plan()).watchdog_timeout_ms == 75


class TestDeadlineShedding:
    @pytest.mark.parametrize("props", ["", "batching=true max-batch=4 batch-timeout-ms=5"])
    def test_expired_frames_are_shed_at_dequeue(self, props):
        """A frame whose ``deadline_ms`` since ``admit_t`` has passed is shed
        before the filter spends time on it, counted; one without both keys
        never expires."""
        desc = ("appsrc name=src dimensions=4 types=float32 ! tensor_filter name=f "
                f"framework=scaler custom=factor:2.0 {props} ! tensor_sink name=out")
        now = time.monotonic()
        metas = [{} if i % 4 == 1 else
                 dict(deadline_ms=0.0 if i % 3 == 0 else 60000.0, admit_t=now)
                 for i in range(12)]
        got = []
        for parse, frame_cls, kw in ((parse_pipeline, Frame, {"device": "cpu"}),
                                     (jparse, JFrame, {})):
            p = parse(desc, **kw)
            ex = p.start()

            def pump(src=p["src"]):
                for i, m in enumerate(metas):
                    src.push(frame_cls((np.full(4, i, np.float32),), meta=dict(m)))
                src.end_of_stream()

            threading.Thread(target=pump, daemon=True).start()
            assert ex.wait(60)
            p.stop()
            got.append((values(p["out"].frames), ex.stats()["f"].get("deadline_shed"),
                        ex.totals()["dropped"], ex.totals()["balance"]))
        assert got[0] == got[1]
        vals, shed, dropped, balance = got[0]
        assert shed == 3 and dropped == {"deadline-shed": 3} and balance == 0
        assert [v[0] for v in vals] == [2.0 * i for i in range(12) if i not in (0, 3, 6)]


class TestCustomCodeDecoder:
    """tensor_decoder mode=custom-code: a registered host callback, through
    both packages; postproc=device and an unregistered name refused."""

    def test_callback_decodes_like_the_reference(self):
        from nnstreamer_tpu.elements.decoder import register_custom_decoder as jreg
        from nnstreamer_tpu.elements.decoder import unregister_custom_decoder as junreg
        from nnstreamer_tpu_torch.elements.decoder import (
            register_custom_decoder,
            unregister_custom_decoder,
        )

        def total(frame, options):
            return frame.with_tensors((np.asarray(frame.tensors[0]).sum(keepdims=True),)
                                      ).with_meta(decoded=options["option2"])

        register_custom_decoder("sum4", total)
        jreg("sum4", total)
        try:
            desc = ("tensorsrc dimensions=4 num-frames=6 pattern=counter ! "
                    "tensor_decoder name=d mode=custom-code option1=sum4 option2=yes ! "
                    "tensor_sink name=out")
            p, ex, jp, jex = both(desc, timeout=30)
            assert values(p["out"].frames) == values(jp["out"].frames) == [
                [4.0 * i] for i in range(6)]
            assert all(f.meta["decoded"] == "yes" for f in p["out"].frames)
        finally:
            assert unregister_custom_decoder("sum4") and junreg("sum4")
        assert not unregister_custom_decoder("sum4")

    @pytest.mark.parametrize("props,match", [
        ("option1=nosuch", "not registered"),
        ("option1=nosuch postproc=device", "postproc=device"),
    ])
    def test_refusals_at_negotiation(self, props, match):
        from nnstreamer_tpu_torch.elements.base import NegotiationError

        desc = ("tensorsrc dimensions=4 num-frames=1 ! "
                f"tensor_decoder mode=custom-code {props} ! tensor_sink")
        with pytest.raises(NegotiationError, match=match):
            parse_pipeline(desc, device="cpu").negotiate()
        with pytest.raises(Exception, match=match):
            jparse(desc).negotiate()
