"""The port's serving plane (nnstreamer_tpu_torch/serving_plane: the DRR
scheduler, ModelPlane, the single-device programs) and its wiring into
tensor_filter and the executor, against the JAX package's on the CPU.

- the scheduler: the same push/collect sequences through both packages'
  schedulers give the same picks (tests/test_plane.py's cases);
- cross-stream batches: bitwise equal to isolated invokes within the
  port, and to the reference plane's outputs through both packages'
  pipelines (``framework=scaler`` exactly; ``zoo:mobilenet_v2`` at
  ``size:96`` on the reference's weights exported to an npz for
  ``params:``, logits within 1e-4 of max |logit| and top-1 equal);
- FIFO, the window round trip, fault isolation with a marker program,
  close giving queued requests a terminal outcome, refcounts, the
  signature and config conflicts, resolution from ``NNS_TPU_PLANE_*``,
  the bad mode, the implicit sharer, default local batching, two
  executors on one plane;
- the async tickets (in-order delivery at depth 1..3, parity with
  blocking submits, in-flight counters), the stall grant (a wedged
  program surfaces fast at depth, a slow one that makes progress does
  not fail), async pipelines in order and equal to blocking ones, and
  ring-depth from ``[plane] inflight``;
- the refusals of what the port has no program for, each before any
  backend opens and naming its queue.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

import jax

from nnstreamer_tpu.elements.filter import TensorFilter as JFilter
from nnstreamer_tpu.elements.sink import TensorSink as JSink
from nnstreamer_tpu.models import mobilenet_v2 as jmobilenet
from nnstreamer_tpu.pipeline.parse import parse_pipeline as jparse
from nnstreamer_tpu.serving_plane import plane as jplane_mod
from nnstreamer_tpu.serving_plane import resolve_plane_config as jresolve
from nnstreamer_tpu.serving_plane.scheduler import PlaneStream as JStream
from nnstreamer_tpu.serving_plane.scheduler import StreamScheduler as JScheduler
from nnstreamer_tpu_torch.backends.base import FilterProps
from nnstreamer_tpu_torch.backends.fakes import ScalerBackend
from nnstreamer_tpu_torch.elements.filter import TensorFilter
from nnstreamer_tpu_torch.elements.sink import TensorSink
from nnstreamer_tpu_torch.pipeline.batching import resolve_batch_config
from nnstreamer_tpu_torch.pipeline.parse import parse_pipeline
from nnstreamer_tpu_torch.serving_plane import ModelPlane, PlaneConfig, resolve_plane_config
from nnstreamer_tpu_torch.serving_plane import plane as plane_mod
from nnstreamer_tpu_torch.serving_plane.plane import PlaneClosedError
from nnstreamer_tpu_torch.serving_plane.scheduler import PlaneStream, StreamScheduler
from nnstreamer_tpu_torch.serving_plane.sharding import HostProgram, VmapProgram
from nnstreamer_tpu_torch.tensors.frame import Frame
from nnstreamer_tpu_torch.tensors.spec import TensorsSpec

CPU = torch.device("cpu")


def _spec(dims="4"):
    return TensorsSpec.from_strings(dims, "float32")


def _scaler(factor=3.0):
    b = ScalerBackend()
    b.open(FilterProps(framework="scaler", model=(), custom=f"factor:{factor}",
                       input_spec=_spec(), device=CPU))
    return b


def _vec(x):
    return torch.as_tensor(np.asarray(x, np.float32))


class _Req:
    def __init__(self, frames):
        self.frames = frames


# -- the scheduler: both packages on the same sequences ----------------------

def _sched_case(name, pkg):
    """Run one of tests/test_plane.py's scheduler sequences through one
    package's classes → what it observes."""
    Stream, Sched = (PlaneStream, StreamScheduler) if pkg == "port" else (JStream, JScheduler)
    sched = Sched()
    if name == "starvation_bound":
        hot, l1, l2 = Stream("hot"), Stream("l1"), Stream("l2")
        for s in (hot, l1, l2):
            sched.add(s)
        for i in range(64):
            hot.q.append(_Req([i]))
        l1.q.append(_Req(["a"]))
        l2.q.append(_Req(["b"]))
        return [(s.sid, r.frames[0]) for s, r in sched.collect(8)]
    if name == "weights_proportional":
        a, b = Stream("a", weight=1.0), Stream("b", weight=2.0)
        sched.add(a)
        sched.add(b)
        for i in range(32):
            a.q.append(_Req([i]))
            b.q.append(_Req([i]))
        return [(s.sid, r.frames[0]) for s, r in sched.collect(9)]
    if name == "fifo_per_stream":
        a = Stream("a")
        sched.add(a)
        for i in range(5):
            a.q.append(_Req([i]))
        return [[r.frames[0] for _, r in sched.collect(3)] for _ in range(2)]
    if name == "window_atomic":
        a, b = Stream("a"), Stream("b")
        sched.add(a)
        sched.add(b)
        a.q.append(_Req([1, 2, 3]))
        b.q.append(_Req([4, 5, 6]))
        got = [r.frames for _, r in sched.collect(4)]
        return got, sched.backlog
    if name == "fractional_weight":
        slow = Stream("slow", weight=0.1)
        sched.add(slow)
        for i in range(8):
            slow.q.append(_Req([i]))
        return [r.frames[0] for _, r in sched.collect(4)]
    if name == "idle_no_credit":
        a, b = Stream("a"), Stream("b")
        sched.add(a)
        sched.add(b)
        for i in range(8):
            a.q.append(_Req([i]))
        sched.collect(8)
        return b.deficit, a.deficit
    if name == "remove_returns_queued":
        a, b = Stream("a"), Stream("b")
        sched.add(a)
        sched.add(b)
        for i in range(3):
            a.q.append(_Req([i]))
        pending = sched.remove(a)
        return [r.frames for r in pending], len(sched), [s.sid for s in sched.streams()]
    raise KeyError(name)


SCHED_CASES = ["starvation_bound", "weights_proportional", "fifo_per_stream", "window_atomic",
               "fractional_weight", "idle_no_credit", "remove_returns_queued"]


@pytest.mark.parametrize("name", SCHED_CASES)
def test_scheduler_matches_reference(name):
    got = _sched_case(name, "port")
    assert got == _sched_case(name, "jax")
    if name == "starvation_bound":
        sids = [s for s, _ in got]
        assert "l1" in sids and "l2" in sids and len(got) == 8
    elif name == "weights_proportional":
        counts = {"a": 0, "b": 0}
        for s, _ in got:
            counts[s] += 1
        assert counts["b"] == 2 * counts["a"]
    elif name == "fifo_per_stream":
        assert got == [[0, 1, 2], [3, 4]]
    elif name == "window_atomic":
        assert sum(len(f) for f in got[0]) == 3 and got[1] == 3
    elif name == "fractional_weight":
        assert len(got) == 4
    elif name == "idle_no_credit":
        assert got[0] == 0.0


def test_top_up_collection_takes_no_window_past_the_limit():
    """The default collection takes at least one window, as the
    reference's; the plane's straggler top-up (at_least_one=False) takes
    none that would overflow."""
    for at_least_one, want in ((True, [[1, 2, 3]]), (False, [])):
        sched = StreamScheduler()
        a = PlaneStream("a")
        sched.add(a)
        a.q.append(_Req([1, 2, 3]))
        assert [r.frames for _, r in sched.collect(2, at_least_one)] == want
    jsched, ja = JScheduler(), JStream("a")
    jsched.add(ja)
    ja.q.append(_Req([1, 2, 3]))
    assert [r.frames for _, r in jsched.collect(2)] == [[1, 2, 3]]


def test_a_dispatch_never_exceeds_max_batch():
    """Three-frame windows from two streams on a max_batch=4 plane: every
    dispatch holds at most 4 frames (one bucket program on the card)."""
    sizes = []

    class Recording(_MarkerProgram):
        def invoke(self, windows):
            sizes.append(len(windows))
            return super().invoke(windows)

    plane = ModelPlane("cap", PlaneConfig(max_batch=4, timeout_ms=5.0), backends=[],
                       program=Recording())
    try:
        streams = [plane.attach(f"s{i}") for i in range(2)]

        def drive(s):
            for j in range(6):
                plane.submit_window(s, [(_vec(np.full(4, j)),)] * 3)

        ts = [threading.Thread(target=drive, args=(s,)) for s in streams]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30)
        assert sum(sizes) == 36 and max(sizes) <= 4
    finally:
        plane.close()


def test_duplicate_stream_id_refused():
    sched = StreamScheduler()
    sched.add(PlaneStream("a"))
    with pytest.raises(ValueError, match="already attached"):
        sched.add(PlaneStream("a"))


# -- plane core ---------------------------------------------------------------

def test_cross_stream_batch_parity_bitwise():
    """Batched cross-stream results are bitwise identical to isolated
    per-frame invokes of the same backend, and batches did form."""
    iso = _scaler(3.0)
    plane = ModelPlane("parity", PlaneConfig(max_batch=8, timeout_ms=1.0), [_scaler(3.0)])
    try:
        streams = [plane.attach(f"s{i}") for i in range(4)]
        frames = {i: [_vec(np.arange(4) + 10 * i + j) for j in range(6)] for i in range(4)}
        outs = {}

        def drive(i, s):
            outs[i] = [plane.submit(s, Frame((x,))).tensors[0] for x in frames[i]]

        ts = [threading.Thread(target=drive, args=(i, s)) for i, s in enumerate(streams)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30)
        assert not any(t.is_alive() for t in ts)
        for i in range(4):
            for x, got in zip(frames[i], outs[i]):
                (want,) = iso.invoke((x,))
                assert torch.equal(got, want) and got.dtype == want.dtype
        st = plane.stats()
        assert st["dispatches"] >= 1 and st["frames"] == 24 and st["program"] == "single"
    finally:
        plane.close()


def test_vmap_program_rows_equal_invoke_one():
    """One dispatch of a window: every row bitwise equal to the plane
    program's own invoke_one of that frame; one program a (signature,
    bucket); an oversized window chunks to the ladder; a mixed window
    runs per frame."""
    b = _scaler(1.5)
    prog = VmapProgram(b.traceable_fn(), (1, 2, 4), CPU)
    rng = np.random.default_rng(3)
    windows = [(_vec(rng.standard_normal(4)),) for _ in range(3)]
    outs = prog.invoke(windows)
    for w, o in zip(windows, outs):
        assert torch.equal(o[0], prog.invoke_one(w)[0])
    assert prog.n_traces == 2  # bucket 4 (three rows padded) and the per-frame program
    big = [(_vec(rng.standard_normal(4)),) for _ in range(9)]
    assert [torch.equal(o[0], b.invoke(w)[0]) for w, o in zip(big, prog.invoke(big))] == [True] * 9
    mixed = [(_vec(np.ones(4)),), (_vec(np.ones(3)),)]
    assert [tuple(o[0].shape) for o in prog.invoke(mixed)] == [(4,), (3,)]


def test_host_program_for_an_untraceable_backend():
    from nnstreamer_tpu_torch.backends.fakes import HostScalerBackend
    from nnstreamer_tpu_torch.serving_plane.sharding import build_plane_program

    b = HostScalerBackend()
    b.open(FilterProps(framework="hostscaler", custom="factor:2.0", input_spec=_spec(), device=CPU))
    prog = build_plane_program([b], PlaneConfig())
    assert isinstance(prog, HostProgram)
    outs = prog.invoke([(_vec(np.arange(4)),), (_vec(np.ones(4)),)])
    assert torch.equal(outs[0][0], _vec(np.arange(4) * 2.0))


def test_per_stream_fifo_order():
    plane = ModelPlane("fifo", PlaneConfig(max_batch=4, timeout_ms=0.5), [_scaler(1.0)])
    try:
        streams = [plane.attach(f"s{i}") for i in range(3)]
        seqs = {}

        def drive(i, s):
            seqs[i] = [float(plane.submit(s, Frame((_vec(np.full(4, 100 * i + j)),))).tensors[0][0])
                       for j in range(20)]

        ts = [threading.Thread(target=drive, args=(i, s)) for i, s in enumerate(streams)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30)
        for i in range(3):
            assert seqs[i] == [100.0 * i + j for j in range(20)]
    finally:
        plane.close()


def test_window_submission_round_trip():
    plane = ModelPlane("win", PlaneConfig(max_batch=8, timeout_ms=0.5), [_scaler(2.0)])
    try:
        s = plane.attach("s0")
        windows = [(_vec(np.arange(4) + j),) for j in range(5)]
        outs = plane.submit_window(s, windows)
        assert len(outs) == 5
        for (x,), (y,) in zip(windows, outs):
            assert torch.equal(y, x * 2.0)
        assert s.admitted == 5 and s.served == 5
    finally:
        plane.close()


class _MarkerProgram:
    """Fails any window holding a frame at or above ``poison``."""

    mode = "single"
    n_traces = 0

    def __init__(self, poison=0.0, below=True):
        self.poison, self.below = poison, below

    def invoke(self, windows):
        outs = []
        for (x,) in windows:
            v = float(x[0])
            if (v < self.poison) if self.below else (v >= self.poison):
                raise RuntimeError("poisoned window")
            outs.append((x * 2.0,))
        return outs

    def invoke_one(self, w):
        return self.invoke([w])[0]


def test_fault_isolates_the_failing_stream():
    """A poisoned frame fails ITS stream's submit; batchmates from other
    streams still serve (the per-window split)."""
    plane = ModelPlane("iso", PlaneConfig(max_batch=8, timeout_ms=2.0), backends=[],
                       program=_MarkerProgram())
    try:
        good, bad = plane.attach("good"), plane.attach("bad")
        results = {}

        def drive_good():
            results["good"] = [plane.submit(good, Frame((_vec(np.full(4, j)),))).tensors[0]
                               for j in range(10)]

        def drive_bad():
            errs = 0
            for _ in range(10):
                try:
                    plane.submit(bad, Frame((_vec(np.full(4, -1.0)),)))
                except RuntimeError:
                    errs += 1
            results["bad_errs"] = errs

        tg, tb = threading.Thread(target=drive_good), threading.Thread(target=drive_bad)
        tg.start()
        tb.start()
        tg.join(30)
        tb.join(30)
        assert results["bad_errs"] == 10 and len(results["good"]) == 10
        for j, a in enumerate(results["good"]):
            assert torch.equal(a, _vec(np.full(4, 2.0 * j)))
        assert bad.errors == 10 and good.errors == 0
    finally:
        plane.close()


def test_close_gives_queued_requests_a_terminal_outcome():
    plane = ModelPlane("det", PlaneConfig(max_batch=8, timeout_ms=1.0), [_scaler(1.0)])
    s = plane.attach("s0")
    req = plane_mod._Req([(torch.zeros(4),)])
    with plane._cond:
        s.q.append(req)
    plane.close()
    assert req.done.wait(2.0)
    assert req.out is not None or isinstance(req.exc, PlaneClosedError)
    with pytest.raises(PlaneClosedError):
        plane.attach("late")


def test_detach_fails_queued_requests_and_reconciles_tickets():
    plane = ModelPlane("dq", PlaneConfig(max_batch=8, timeout_ms=1.0), [_scaler(1.0)])
    try:
        s = plane.attach("s0")
        req = plane_mod._Req([(torch.zeros(4),)])
        with plane._cond:
            s.q.append(req)
            s.inflight, plane._inflight_total = 2, 2
        plane.detach(s)
        assert req.done.is_set() and isinstance(req.exc, PlaneClosedError)
        assert plane._inflight_total == 0 and s.inflight == 0
    finally:
        plane.close()


# -- registry / config / property surface ------------------------------------

def test_refcounted_shared_backend():
    a = TensorFilter(framework="scaler", custom="factor:3", plane="rk1")
    b = TensorFilter(framework="scaler", custom="factor:3", plane="rk1")
    try:
        a.negotiate([_spec()])
        b.negotiate([_spec()])
        assert a.backend is b.backend
        assert plane_mod.get("rk1") is not None
        a.stop()
        assert plane_mod.get("rk1") is not None  # b still holds it
    finally:
        b.stop()
        a.stop()
    assert plane_mod.get("rk1") is None


def test_signature_conflict_rejected():
    a = TensorFilter(framework="scaler", custom="factor:3", plane="rk2")
    a.negotiate([_spec()])
    try:
        b = TensorFilter(framework="scaler", custom="factor:9", plane="rk2")
        with pytest.raises(ValueError, match="already bound"):
            b.negotiate([_spec()])
    finally:
        a.stop()
    assert plane_mod.get("rk2") is None


@pytest.mark.parametrize("prop", ["shared-tensor-filter-key", "replicas", "fallback-framework"])
def test_conflicting_modes_rejected(prop):
    """Both packages refuse plane= with these props for the same conflict,
    with the same message, which names it."""
    msgs = []
    for cls in (TensorFilter, JFilter):
        with pytest.raises(ValueError, match=f"plane='x' cannot combine with {prop.split('-')[0]}"
                           ) as ei:
            cls(name="f", framework="scaler", plane="x",
                **{prop: "2" if prop == "replicas" else "k"})
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def _same_fields(port_cfg, ref_cfg) -> bool:
    """The port's PlaneConfig fields agree with the reference's."""
    return all(getattr(port_cfg, f.name) == getattr(ref_cfg, f.name)
               for f in dataclasses.fields(port_cfg))


def test_resolve_config_element_over_default(monkeypatch):
    props = {"plane-max-batch": "4", "plane-timeout-ms": "0.5", "plane-mode": "shard",
             "plane-devices": "1"}
    cfg = resolve_plane_config([TensorFilter(framework="scaler", plane="cfg", **props)])
    want = jresolve([JFilter(framework="scaler", plane="cfg", **props)])
    assert _same_fields(cfg, want)
    assert cfg.max_batch == 4 and cfg.timeout_ms == 0.5 and cfg.mode == "shard"
    monkeypatch.setenv("NNS_TPU_PLANE_MAX_BATCH", "16")
    monkeypatch.setenv("NNS_TPU_PLANE_TIMEOUT_MS", "2.5")
    got = resolve_plane_config([TensorFilter(framework="scaler", plane="cfg2")])
    want = jresolve([JFilter(framework="scaler", plane="cfg2")])
    assert _same_fields(got, want) and got.max_batch == 16 and got.timeout_ms == 2.5


def test_bad_plane_mode_rejected():
    for cls in (TensorFilter, JFilter):
        with pytest.raises(ValueError, match="plane-mode"):
            cls(framework="scaler", plane="m", **{"plane-mode": "bogus"})


def test_implicit_sharer_inherits_bound_config():
    a = TensorFilter(framework="scaler", custom="factor:3", plane="inh1",
                     **{"plane-max-batch": "32"})
    b = TensorFilter(framework="scaler", custom="factor:3", plane="inh1")
    try:
        a.negotiate([_spec()])
        b.negotiate([_spec()])
        assert a.backend is b.backend
        assert b._plane.cfg.max_batch == 32  # inherited binding
        c = TensorFilter(framework="scaler", custom="factor:3", plane="inh1",
                         **{"plane-max-batch": "4"})
        with pytest.raises(ValueError, match="already bound"):
            c.negotiate([_spec()])
    finally:
        a.stop()
        b.stop()


def test_plane_defaults_local_batching_on():
    from nnstreamer_tpu.pipeline.batching import resolve_batch_config as jresolve_batch

    f = TensorFilter(framework="scaler", plane="d")
    cfg = resolve_batch_config([f])
    want = jresolve_batch([JFilter(framework="scaler", plane="jd")])
    assert cfg.active and want.active
    assert (cfg.max_batch, cfg.timeout_ms, cfg.buckets) == (
        want.max_batch, want.timeout_ms, want.buckets)
    assert f.is_batch_capable() and not f.is_traceable()
    g = TensorFilter(framework="scaler", plane="d2", batching="false")
    assert not resolve_batch_config([g]).active


def test_plane_filter_refuses_a_reload():
    f = TensorFilter(framework="scaler", plane="rl")
    with pytest.raises(ValueError, match="reload"):
        f.reload_model("x")


@pytest.mark.parametrize("props,queue", [
    ({"plane": "r1", "plane-mode": "shard", "plane-devices": "8"}, "A.8"),
    ({"plane": "r2", "plane-mode": "shard", "plane-devices": "2"}, "A.8"),
    ({"ring-depth": "3"}, "A.6b"),
])
def test_unported_plane_modes_raise_before_any_backend_opens(props, queue, monkeypatch):
    opened = []
    monkeypatch.setattr(TensorFilter, "_open_backend", lambda self: opened.append(self))
    if queue == "A.8":
        # ported since: a shard plane constructs; at negotiation a mesh past
        # the CPU's positions (one by default) raises naming both counts,
        # before any backend opens
        f = TensorFilter(framework="torch", model="zoo:mobilenet_v2", **props)
        assert f.plane == props["plane"] and f._plane_cfg.mode == "shard"
        f.device = torch.device("cpu")
        with pytest.raises(ValueError, match=f"needs {props['plane-devices']} devices, have 1"):
            f._acquire_plane()
        assert opened == [] and plane_mod.get(props["plane"]) is None
        return
    if queue == "A.6b":
        # ported since: ring-depth without plane= is the executor's frame
        # ring (pipeline/transfer.py), so the filter constructs, opens no
        # plane, and keeps its ticket depth at 1
        f = TensorFilter(framework="torch", model="zoo:mobilenet_v2", **props)
        assert f.plane == "" and f.plane_inflight == 1 and f.get_property("ring-depth") == "3"
        assert opened == [] and plane_mod.get("") is None
        return
    with pytest.raises(NotImplementedError, match=f"not ported yet \\(ROADMAP {queue}\\)"):
        TensorFilter(framework="torch", model="zoo:mobilenet_v2", **props)
    assert opened == [] and plane_mod.get(props.get("plane", "")) is None


def test_registry_acquire_refuses_before_the_opener(monkeypatch):
    """A shard plane opens ONE backend, which its mesh program spreads, and
    replicas open ``devices`` backends through ``opener(i, replicated)``,
    as the reference's registry does; a failed open closes the ones
    before."""
    for pkg, cfg, want in (
            (plane_mod, PlaneConfig(mode="shard", devices=4), [(0, False)]),
            (jplane_mod, jplane_mod.PlaneConfig(mode="shard", devices=4), [(0, False)]),
            (plane_mod, PlaneConfig(mode="replicas", devices=2), [(0, True), (1, True)]),
            (jplane_mod, jplane_mod.PlaneConfig(mode="replicas", devices=2),
             [(0, True), (1, True)])):
        opened = []

        def opener(i, rep, opened=opened):
            opened.append((i, rep))
            return _scaler(2.0)

        pl = pkg.acquire("r3", ("sig",), cfg, opener)
        try:
            assert opened == want and len(pl.backends) == len(want)
        finally:
            pkg.release("r3", pl)
    closed = []

    def failing(i, rep):
        if i == 1:
            raise RuntimeError("replica 1 open failed")
        b = _scaler(2.0)
        b.close = lambda: closed.append(i)
        return b

    with pytest.raises(RuntimeError, match="replica 1"):
        plane_mod.acquire("r5", ("sig",), PlaneConfig(mode="replicas", devices=2), failing)
    assert closed == [0] and plane_mod.get("r5") is None


def test_replicas_mode_opens_a_backend_a_replica_and_serves(monkeypatch):
    """plane-mode=replicas plane-devices=2 (refused before this slice):
    two backends tagged _replica:<i>, one program each behind the replica
    set, the config signature carrying the health knobs."""
    monkeypatch.setenv("NNS_TPU_PLANE_PROBE_EVERY", "16")
    props = {"plane-mode": "replicas", "plane-devices": "2"}
    f = TensorFilter(framework="scaler", custom="factor:2", plane="rp1", **props)
    jf = JFilter(framework="scaler", plane="jrp1", **props)
    try:
        f.device = torch.device("cpu")
        f.negotiate([_spec()])
        assert f._plane_cfg.signature() == jf._plane_cfg.signature()
        assert f._plane_cfg.probe_every == 16 and f._plane_cfg.unhealthy_after == 3
        pl = f._plane
        assert [b.props.custom.split(",")[-1] for b in pl.backends] == ["_replica:0", "_replica:1"]
        for j in range(4):
            outs = pl.submit_window(f._plane_stream, [(_vec(np.full(4, j)),)])
            assert torch.equal(outs[0][0], _vec(np.full(4, 2.0 * j)))
        reps = pl.stats()["replicas"]
        assert reps["served"] == [2, 2] and reps["healthy"] == 2
        assert pl.stats()["program"] == "replicas"
    finally:
        f.stop()


def test_shard_over_one_device_is_the_single_program():
    f = TensorFilter(framework="scaler", custom="factor:2", plane="sh1",
                     **{"plane-mode": "shard", "plane-devices": "1"})
    try:
        f.negotiate([_spec()])
        outs = f._plane.submit_window(f._plane_stream, [(_vec(np.arange(4)),)])
        assert torch.equal(outs[0][0], _vec(np.arange(4) * 2.0))
        assert isinstance(f._plane._program, VmapProgram)
    finally:
        f.stop()


# -- pipelines through both packages ------------------------------------------

def _run_streams(parse, descs, timeout=60, **kw):
    pipes = [parse(d, **kw) for d in descs]
    execs = [None] * len(pipes)
    errors = []

    def drive(i):
        try:
            execs[i] = pipes[i].run(timeout=timeout)
        except Exception as exc:  # noqa: BLE001 — asserted below
            errors.append((i, exc))

    ts = [threading.Thread(target=drive, args=(i,)) for i in range(len(pipes))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout + 30)
    assert not errors, errors
    return pipes, execs


def _sink_values(pipe, cls):
    sink = next(e for e in pipe.elements if isinstance(e, cls))
    return [np.asarray(f.tensors[0]) for f in sink.frames]


def test_two_executors_one_plane_match_reference():
    def descs(plane):
        return [
            "tensorsrc dimensions=4 pattern=counter num-frames=25 ! "
            f"tensor_filter framework=scaler custom=factor:2.0 plane={plane} plane-max-batch=8 ! "
            "tensor_sink" for _ in range(2)
        ]

    pipes, execs = _run_streams(parse_pipeline, descs("pp1"), device="cpu")
    jpipes, _ = _run_streams(jparse, descs("jpp1"))
    for p, jp in zip(pipes, jpipes):
        got, want = _sink_values(p, TensorSink), _sink_values(jp, JSink)
        assert len(got) == 25
        for j, (a, b) in enumerate(zip(got, want)):
            assert np.array_equal(a, b) and np.array_equal(a, np.full(4, 2.0 * j, np.float32))
    rows = [row for ex in execs for row in ex.stats().values() if "plane_name" in row]
    assert len(rows) == 2 and rows[0]["plane_name"] == "pp1"
    assert rows[0]["plane_frames"] >= 25 and {r["plane_stream_served"] for r in rows} == {25}
    assert plane_mod.get("pp1") is None  # refcount drained


def test_two_streams_in_one_description_share_one_plane():
    """The form the card runs: two streams in ONE description, one plane:
    each stream's frames in order, both served by the one plane."""
    desc = " ".join(
        f"tensorsrc dimensions=4 pattern=counter num-frames=40 ! "
        f"tensor_filter framework=scaler custom=factor:{k}.0 plane=one plane-max-batch=8 "
        f"max-batch=2 ! tensor_sink name=o{k}" for k in (2, 2)
    ).replace("name=o2", "name=oa", 1)
    p = parse_pipeline(desc, device="cpu")
    ex = p.run(timeout=60)
    for name in ("oa", "o2"):
        vals = [float(f.tensors[0][0]) for f in p[name].frames]
        assert vals == [2.0 * j for j in range(40)]
    rows = [r for r in ex.stats().values() if "plane_name" in r]
    assert len(rows) == 2 and {r["plane_stream_served"] for r in rows} == {40}
    assert rows[1]["plane_frames"] == 80


@pytest.fixture(scope="module")
def mobilenet_npz(tmp_path_factory):
    jp = jmobilenet.init_params(jax.random.PRNGKey(0), num_classes=16, width=0.5)
    path = tmp_path_factory.mktemp("mbv2") / "w.npz"
    np.savez(path, **{f"p{i}": np.asarray(v) for i, v in enumerate(jax.tree_util.tree_leaves(jp))})
    return str(path)


def test_mobilenet_plane_matches_reference_plane(mobilenet_npz):
    """Two streams of different patterns through zoo:mobilenet_v2 on one
    plane, both packages: logits within 1e-4 of max |logit|, top-1 equal,
    every frame in order; within the port each batched row (one batched
    program a window, its convs at N = B) is the plane program's invoke_one
    of that frame within 1e-4 of max |logit|, top-1 equal."""
    def desc(plane, fw):
        return " ".join(
            f"videotestsrc pattern={pat} num-frames=4 width=96 height=96 ! tensor_converter ! "
            f"tensor_filter framework={fw} model=zoo:mobilenet_v2 plane={plane} plane-max-batch=2 "
            f'custom="size:96,num_classes:16,width:0.5,params:{mobilenet_npz}" ! '
            f"tensor_sink name={pat}" for pat in ("gradient", "counter")
        )

    p = parse_pipeline(desc("mb", "torch"), device="cpu")
    p.negotiate()
    plane = plane_mod.get("mb")
    rows = []
    inner = None

    def recording(windows):
        outs = inner(windows)
        rows.append((list(windows), outs))
        return outs

    prog = plane._ensure_program()
    inner, prog.invoke = prog.invoke, recording
    p.run(timeout=120)
    jp = jparse(desc("jmb", "jax"))
    jp.run(timeout=300)
    for pat in ("gradient", "counter"):
        got = np.stack([f.tensors[0] for f in p[pat].frames])
        want = np.stack([np.asarray(f.tensors[0]) for f in jp[pat].frames])
        assert got.shape == want.shape == (4, 1, 16)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * float(np.abs(want).max()))
        assert np.array_equal(got.argmax(-1), want.argmax(-1))
    assert sum(len(w) for w, _ in rows) == 8  # every frame through the plane's program

    def same_frame(o, w):
        one = prog.invoke_one(w)[0]
        tol = 1e-4 * float(one.abs().max())
        assert float((o[0] - one).abs().max()) <= tol
        assert torch.equal(o[0].argmax(-1), one.argmax(-1))

    for windows, outs in rows:
        for w, o in zip(windows, outs):
            same_frame(o, w)
    # and a two-frame window built here, whatever the run's timing formed
    frames = [w for windows, _ in rows for w in windows]
    mixed = [frames[0], frames[-1]]
    for w, o in zip(mixed, inner(mixed)):
        same_frame(o, w)


# -- async tickets --------------------------------------------------------------

@pytest.mark.parametrize("depth", [1, 2, 3])
def test_in_order_delivery_at_depth(depth):
    plane = ModelPlane("ord", PlaneConfig(max_batch=8, timeout_ms=0.5), [_scaler(2.0)])
    try:
        s = plane.attach(f"d{depth}")
        ring, got = [], []
        for j in range(12):
            ring.append((j, plane.submit_window_async(s, [(_vec(np.full(4, j)),)])))
            while len(ring) >= depth:
                jj, req = ring.pop(0)
                (out,) = plane.wait_window(s, req)
                got.append((jj, float(out[0][0])))
        while ring:
            jj, req = ring.pop(0)
            (out,) = plane.wait_window(s, req)
            got.append((jj, float(out[0][0])))
        assert got == [(j, 2.0 * j) for j in range(12)]
        assert s.admitted == 12 and s.served == 12
        assert s.inflight == 0 and plane._inflight_total == 0
    finally:
        plane.close()


def test_async_bitwise_parity_with_sync():
    plane = ModelPlane("par", PlaneConfig(max_batch=8, timeout_ms=0.5), [_scaler(1.5)])
    try:
        s1, s2 = plane.attach("sync"), plane.attach("async")
        rng = np.random.default_rng(7)
        windows = [[(_vec(rng.standard_normal(4)),)] for _ in range(10)]
        sync_outs = [plane.submit_window(s1, list(w)) for w in windows]
        reqs = [plane.submit_window_async(s2, list(w)) for w in windows]
        async_outs = [plane.wait_window(s2, r) for r in reqs]
        for a, b in zip(sync_outs, async_outs):
            assert torch.equal(a[0][0], b[0][0])
    finally:
        plane.close()


def test_inflight_counters():
    plane = ModelPlane("infl", PlaneConfig(max_batch=4, timeout_ms=0.0), [_scaler(1.0)])
    try:
        s = plane.attach("s0")
        reqs = [plane.submit_window_async(s, [(torch.zeros(4),)]) for _ in range(3)]
        assert s.inflight == 3 and plane._inflight_total == 3
        assert plane.stats()["inflight"] == 3
        for r in reqs:
            plane.wait_window(s, r)
        assert s.inflight == 0 and plane._inflight_total == 0
        assert s.snapshot()["inflight"] == 0
    finally:
        plane.close()


class _SleepProgram:
    mode = "single"
    n_traces = 0

    def __init__(self, sleep_s):
        self.sleep_s = sleep_s

    def invoke(self, windows):
        time.sleep(self.sleep_s)
        return list(windows)

    def invoke_one(self, w):
        return self.invoke([w])[0]


def test_wedged_service_thread_surfaces_fast_at_depth():
    """A wedged program (no dispatch progress) surfaces after at most ~2x
    submit_timeout_s even with a deep ring."""
    plane = ModelPlane("wedge", PlaneConfig(max_batch=4, timeout_ms=0.0, submit_timeout_s=0.1),
                       backends=[], program=_SleepProgram(1.0))
    s = plane.attach("s0")
    reqs = [plane.submit_window_async(s, [(torch.zeros(4),)]) for _ in range(3)]
    t0 = time.monotonic()
    with pytest.raises(PlaneClosedError):
        plane.wait_window(s, reqs[0])
    assert time.monotonic() - t0 < 1.0
    for r in reqs[1:]:
        with pytest.raises(PlaneClosedError):
            plane.wait_window(s, r)
    plane.close(join_timeout=0.1)


def test_slow_but_progressing_plane_scales_the_grant():
    plane = ModelPlane("slow", PlaneConfig(max_batch=1, timeout_ms=0.0, submit_timeout_s=0.12),
                       backends=[], program=_SleepProgram(0.17))
    try:
        s = plane.attach("s0")
        reqs = [plane.submit_window_async(s, [(torch.zeros(4),)]) for _ in range(3)]
        for r in reqs:
            assert plane.wait_window(s, r) is not None
        assert s.served == 3
    finally:
        plane.close()


def test_async_pipeline_parity_and_order():
    """ring-depth=3 streams deliver every frame, in order, equal to a
    blocking run and to the reference's async run of the same strings."""
    def descs(extra, plane):
        return [
            "tensorsrc dimensions=4 pattern=counter num-frames=30 ! "
            f"tensor_filter framework=scaler custom=factor:2.0 plane={plane} plane-max-batch=8 "
            f"plane-timeout-ms=0.5 {extra} ! tensor_sink" for _ in range(3)
        ]

    async_pipes, async_execs = _run_streams(parse_pipeline, descs("ring-depth=3", "as1"),
                                            device="cpu")
    sync_pipes, _ = _run_streams(parse_pipeline, descs("", "bs1"), device="cpu")
    ref_pipes, _ = _run_streams(jparse, descs("ring-depth=3", "jas1"))
    want = [2.0 * j for j in range(30)]
    for pa, ps, pr in zip(async_pipes, sync_pipes, ref_pipes):
        a = [float(v[0]) for v in _sink_values(pa, TensorSink)]
        assert a == want == [float(v[0]) for v in _sink_values(ps, TensorSink)]
        assert a == [float(v[0]) for v in _sink_values(pr, JSink)]
    for ex in async_execs:
        (row,) = [r for r in ex.stats().values() if "plane_name" in r]
        assert row["plane_stream_served"] == 30 and row["plane_stream_errors"] == 0
    assert plane_mod.get("as1") is None


def test_async_failed_window_raises_through_its_stream_only():
    """A poisoned stream's in-flight window fails and its pipeline raises
    the window's error, while the healthy async stream on the same plane
    delivers everything."""
    cfg = PlaneConfig(max_batch=8, timeout_ms=1.0)
    plane = ModelPlane("fa1", cfg, backends=[_scaler(1.0)],
                       program=_MarkerProgram(poison=90.0, below=False))
    entry = {"plane": plane, "sig": None, "refs": 0, "cfg": cfg, "open_lock": threading.Lock()}
    plane_mod._planes["fa1"] = entry
    orig = plane_mod.acquire

    def acquire_patch(name, sig, cfg2, opener, cfg_explicit=True):
        if name == "fa1":
            with plane_mod._registry_lock:
                entry["refs"] += 1
            return plane
        return orig(name, sig, cfg2, opener, cfg_explicit=cfg_explicit)

    plane_mod.acquire = acquire_patch
    try:
        healthy = parse_pipeline(
            "tensorsrc dimensions=4 pattern=counter num-frames=20 ! tensor_filter framework=scaler "
            "plane=fa1 plane-max-batch=8 ring-depth=2 ! tensor_sink", device="cpu")
        poisoned = parse_pipeline(
            "tensorsrc dimensions=4 pattern=counter num-frames=20 ! "
            "tensor_transform mode=arithmetic option=add:90.0 ! tensor_filter framework=scaler "
            "plane=fa1 plane-max-batch=8 ring-depth=2 ! tensor_sink", device="cpu")
        for p in (healthy, poisoned):
            p.negotiate()  # both attached before either runs
        errors = []

        def run(p):
            try:
                p.run(timeout=60)
            except RuntimeError as exc:
                errors.append(exc)

        ts = [threading.Thread(target=run, args=(p,)) for p in (healthy, poisoned)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(90)
        assert [str(e) for e in errors] == ["poisoned window"]
        assert [float(v[0]) for v in _sink_values(healthy, TensorSink)] == [
            2.0 * j for j in range(20)]
        assert _sink_values(poisoned, TensorSink) == []
    finally:
        plane_mod.acquire = orig
        plane_mod._planes.pop("fa1", None)
        plane.close()


class _OneBadFrame(_MarkerProgram):
    """Fails any window holding the frame whose value is ``bad``, and
    keeps the values of each window it failed."""

    def __init__(self, bad):
        self.bad = bad
        self.failed = []

    def invoke(self, windows):
        vals = [float(x[0]) for (x,) in windows]
        if self.bad in vals:
            self.failed.append(vals)
            raise RuntimeError("poisoned window")
        return [(x * 2.0,) for (x,) in windows]


@pytest.mark.parametrize("depth", [1, 2])
def test_window_failing_at_a_middle_frame_delivers_no_frame_of_it(depth, monkeypatch):
    """Only frame 10 is poisoned. At every ticket depth the window that
    holds it raises whole: the sink gets an in-order prefix that stops
    before that window's first frame."""
    cfg = PlaneConfig(max_batch=4, timeout_ms=1.0)
    prog = _OneBadFrame(10.0)
    plane = ModelPlane("mid", cfg, backends=[_scaler(1.0)], program=prog)
    monkeypatch.setattr(plane_mod, "acquire", lambda name, *a, **k: plane)
    monkeypatch.setattr(plane_mod, "release", lambda name, p: False)
    try:
        pipe = parse_pipeline(
            "tensorsrc dimensions=4 pattern=counter num-frames=20 ! tensor_filter "
            f"framework=scaler plane=mid plane-max-batch=4 ring-depth={depth} ! tensor_sink",
            device="cpu")
        with pytest.raises(RuntimeError, match="poisoned window"):
            pipe.run(timeout=60)
        got = [float(v[0]) for v in _sink_values(pipe, TensorSink)]
        failed_window = prog.failed[-1]
        assert 10.0 in failed_window and len(failed_window) <= 4
        assert got == [2.0 * j for j in range(len(got))]
        assert len(got) <= min(failed_window)
    finally:
        plane.close()


@pytest.mark.parametrize("depth", [1, 2])
def test_window_failing_at_a_middle_frame_drops_only_that_frame(depth, monkeypatch):
    """With on-error=drop the failed window splits per frame through the
    stream's policy (each frame its own plane round trip): only frame 10
    is dropped, counted, and every other frame arrives in order."""
    cfg = PlaneConfig(max_batch=4, timeout_ms=1.0)
    plane = ModelPlane("midd", cfg, backends=[_scaler(1.0)], program=_OneBadFrame(10.0))
    monkeypatch.setattr(plane_mod, "acquire", lambda name, *a, **k: plane)
    monkeypatch.setattr(plane_mod, "release", lambda name, p: False)
    try:
        pipe = parse_pipeline(
            "tensorsrc dimensions=4 pattern=counter num-frames=20 ! tensor_filter name=f "
            f"framework=scaler plane=midd plane-max-batch=4 ring-depth={depth} on-error=drop ! "
            "tensor_sink", device="cpu")
        ex = pipe.run(timeout=60)
        got = [float(v[0]) for v in _sink_values(pipe, TensorSink)]
        assert got == [2.0 * j for j in range(20) if j != 10]
        assert ex.stats()["f"]["error_dropped"] == 1
        assert ex.totals()["dropped"] == {"on-error-drop": 1} and ex.totals()["balance"] == 0
    finally:
        plane.close()


def _injected_plane(monkeypatch, name, program, cfg=None):
    """A plane with a marker program, registered under ``name`` for the
    filters of both packages' pipelines that attach to it."""
    cfg = cfg or PlaneConfig(max_batch=8, timeout_ms=1.0)
    plane = ModelPlane(name, cfg, backends=[_scaler(1.0)], program=program)
    orig = plane_mod.acquire

    def acquire_patch(n, sig, cfg2, opener, cfg_explicit=True):
        if n == name:
            return plane
        return orig(n, sig, cfg2, opener, cfg_explicit=cfg_explicit)

    monkeypatch.setattr(plane_mod, "acquire", acquire_patch)
    monkeypatch.setattr(plane_mod, "release",
                        lambda n, p, _orig=plane_mod.release: False if n == name else _orig(n, p))
    return plane


class _Identity(_MarkerProgram):
    def invoke(self, windows):
        outs = []
        for (x,) in windows:
            if float(x[0]) >= 90.0:
                raise RuntimeError("poisoned window")
            outs.append((x,))
        return outs


def test_fault_policy_disposes_per_stream(monkeypatch):
    """A poisoned stream shares the plane with a healthy one: its own
    on-error=drop disposes of ITS frames with accounting, the healthy
    stream delivers everything (the reference's test_plane.py case)."""
    plane = _injected_plane(monkeypatch, "fp1", _Identity())
    try:
        descs = [
            "tensorsrc dimensions=4 pattern=counter num-frames=20 ! "
            "tensor_filter framework=scaler plane=fp1 plane-max-batch=8 ! tensor_sink",
            "tensorsrc dimensions=4 pattern=counter num-frames=20 ! "
            "tensor_transform mode=arithmetic option=add:90.0 ! tensor_filter framework=scaler "
            "plane=fp1 plane-max-batch=8 on-error=drop name=poisoned ! tensor_sink",
        ]
        pipes, execs = _run_streams(parse_pipeline, descs, device="cpu")
        assert [float(v[0]) for v in _sink_values(pipes[0], TensorSink)] == list(range(20))
        assert _sink_values(pipes[1], TensorSink) == []
        tot = execs[1].totals()
        assert tot["dropped"] == {"on-error-drop": 20} and tot["balance"] == 0
        assert execs[1].stats()["poisoned"]["error_dropped"] == 20
    finally:
        plane.close()


class TestReplicas:
    """mode=replicas through both packages' pipelines."""

    def test_failover_through_plane(self):
        """Two chaos backends, one of which loses its device mid-run: every
        frame still serves (windows fail over whole, in order), and the
        replica set records the failovers."""
        def desc(plane):
            return ("tensorsrc dimensions=4 pattern=counter num-frames=30 ! "
                    'tensor_filter framework=faulty custom="device_lost_at:3,only_replica:1" '
                    f"plane={plane} plane-mode=replicas plane-devices=2 plane-max-batch=4 ! "
                    "tensor_sink")

        pipes, execs = _run_streams(parse_pipeline, [desc("rep1")], device="cpu")
        jpipes, jexecs = _run_streams(jparse, [desc("jrep1")])
        got = [float(v[0]) for v in _sink_values(pipes[0], TensorSink)]
        assert got == [float(v[0]) for v in _sink_values(jpipes[0], JSink)] == list(range(30))
        (row,) = [r for r in execs[0].stats().values() if "plane_name" in r]
        (jrow,) = [r for r in jexecs[0].stats().values() if "plane_name" in r]
        reps, jreps = row["plane_replicas"], jrow["plane_replicas"]
        assert reps["replicas"] == jreps["replicas"] == 2
        assert reps["failovers"] >= 1 and jreps["failovers"] >= 1
        assert reps["healthy"] == jreps["healthy"] == 1

    def test_exhaustion_raises_per_stream(self):
        """Both replicas dead: the stream's own policy (drop) disposes of
        every frame, the pipeline reaches EOS, in both packages."""
        def desc(plane):
            return ("tensorsrc dimensions=4 pattern=counter num-frames=10 ! "
                    'tensor_filter name=f framework=faulty custom="device_lost_at:1" '
                    f"plane={plane} plane-mode=replicas plane-devices=2 plane-max-batch=2 "
                    "on-error=drop retry-backoff-ms=1 ! tensor_sink")

        pipes, execs = _run_streams(parse_pipeline, [desc("rep2")], device="cpu")
        jpipes, jexecs = _run_streams(jparse, [desc("jrep2")])
        assert _sink_values(pipes[0], TensorSink) == []
        assert execs[0].totals()["dropped"] == jexecs[0].totals()["dropped"] == {
            "on-error-drop": 10}


def test_ring_depth_resolves_from_plane_inflight_config(monkeypatch):
    monkeypatch.setenv("NNS_TPU_PLANE_INFLIGHT", "2")
    for cls in (TensorFilter, JFilter):
        assert cls(framework="scaler", plane="cfg1").plane_inflight == 2
        assert cls(framework="scaler", plane="cfg1", **{"ring-depth": "4"}).plane_inflight == 4
        assert cls(framework="scaler", plane="cfg1", **{"ring-depth": "99"}).plane_inflight == 32
    monkeypatch.delenv("NNS_TPU_PLANE_INFLIGHT")
    assert TensorFilter(framework="scaler", plane="cfg1").plane_inflight == 1  # blocking default


@pytest.mark.parametrize("policy", ["drop", "stop"])
def test_a_frame_that_fails_to_stage_is_disposed_by_the_policy(policy, monkeypatch):
    """The plane node moves a window's frames to the device before the
    submit, outside any invoke: a frame that fails there goes to the
    stream's policy (dropped and counted), or stops the run."""
    real = Frame.to_device

    def flaky(self, device):
        if float(self.tensors[0][0]) == 5.0:
            raise RuntimeError("staging failed")
        return real(self, device)

    monkeypatch.setattr(Frame, "to_device", flaky)
    pipe = parse_pipeline(
        "tensorsrc dimensions=4 pattern=counter num-frames=12 ! tensor_filter name=f "
        f"framework=scaler plane=stg plane-max-batch=4 on-error={policy} ! tensor_sink",
        device="cpu")
    if policy == "stop":
        with pytest.raises(RuntimeError, match="staging failed"):
            pipe.run(timeout=60)
        return
    ex = pipe.run(timeout=60)
    got = [float(v[0]) for v in _sink_values(pipe, TensorSink)]
    assert got == [2.0 * j for j in range(12) if j != 5]
    assert ex.stats()["f"]["error_dropped"] == 1 and ex.totals()["balance"] == 0
