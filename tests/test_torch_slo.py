"""The port's SLO ledger (nnstreamer_tpu_torch/kv/sched.py ``SLOLedger``)
against the JAX package's (nnstreamer_tpu/kv/sched.py), on the CPU:

- the ledger's views equal the reference's under a fixed clock, through
  submit / prefilling / admitted / first token / preemption / finish /
  migration, and its snapshot round trip;
- ``ContinuousBatcher.requests()`` on both KV layouts (state, slot,
  tokens, blocks, queue / TTFT / TPOT, deadline) and the TTFT / TPOT
  histograms; a preemption is counted on its request;
- a span carries its request's remaining deadline and preemptions, the
  source's record turns ``migrated`` and the adopting batcher's record
  takes both; a snapshot carries the ledger and a restore loads it;
- the LLM element's and the LLM plane's ``requests`` rows (each stream
  its own), fed by a ``deadline_ms`` meta, and nns-top's requests table.
"""

import numpy as np
import pytest

import jax

from nnstreamer_tpu.kv import sched as jsched
from nnstreamer_tpu.models import transformer as jtfm
from nnstreamer_tpu_torch.kv import sched
from nnstreamer_tpu_torch.models import serving as tsv
from nnstreamer_tpu_torch.models import transformer as ttfm
from nnstreamer_tpu_torch.models.jax_weights import transformer_from_jax
from nnstreamer_tpu_torch.obs import metrics as obs_metrics
from nnstreamer_tpu_torch.obs import nns_top

VOCAB, D_MODEL, N_HEADS, N_LAYERS = 97, 32, 2, 1
PAGED = dict(kv_layout="paged", block_size=16)


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    monkeypatch.setattr(sched.time, "perf_counter", c)
    monkeypatch.setattr(jsched.time, "perf_counter", c)
    return c


def _drive(mod, clock, reg=None):
    led = mod.SLOLedger(keep=3, obs_registry=reg)
    led.submit(0, deadline_s=2.0)
    led.submit(1)
    clock.t += 0.010
    led.prefilling(0)
    clock.t += 0.005
    led.admitted(0)
    led.first_token(0)
    clock.t += 0.020
    led.preempted(0)
    led.prefilling(0)
    led.admitted(0)
    clock.t += 0.030
    led.finished(0, 4)
    led.submit(2)
    led.migrated(2)
    led.submit(3)
    led.finished(3, 1)  # a one-token request: its first token is its last
    return led


def test_ledger_views_equal_the_reference_under_a_fixed_clock(clock):
    led = _drive(sched, clock)
    view, clock.t = led.view(), 100.0  # the same clock, from the same start
    jled = _drive(jsched, clock)
    assert view == jled.view()
    clock.t = 200.0
    assert led.view() == jled.view()
    assert list(led.view()) == [1, 2, 3]  # keep=3 evicts the oldest
    assert led.preemptions_total == jled.preemptions_total == 1
    assert led.snapshot() == jled.snapshot()
    back = sched.SLOLedger()
    back.restore(jled.snapshot())
    assert back.view() == led.view()
    assert led.view()[2]["state"] == "migrated" and led.view()[3]["ttft_ms"] is not None


def test_ledger_histograms(clock):
    reg = obs_metrics.MetricsRegistry()
    led = _drive(sched, clock, reg)
    assert reg.find("nns_request_ttft_ms").count == 1
    assert reg.find("nns_request_tpot_ms").count == 1
    rec = led.record(0)
    assert rec is None  # evicted (keep=3)


@pytest.fixture(scope="module")
def lm():
    jp = jtfm.init_params(jax.random.PRNGKey(5), vocab=VOCAB, d_model=D_MODEL, n_heads=N_HEADS,
                          n_layers=N_LAYERS)
    m = ttfm.TransformerLM(VOCAB, D_MODEL, N_HEADS, N_LAYERS, n_kv_heads=N_HEADS)
    m.load_state_dict(transformer_from_jax(jax.tree_util.tree_map(np.asarray, jp)))
    return m


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(1, VOCAB, (n,)).astype(np.int32)


def _mk(lm, **kw):
    return tsv.ContinuousBatcher(lm, N_HEADS, device="cpu",
                                 **{"n_slots": 2, "max_len": 64, "prompt_len": 16, **kw})


def _drain(cb, rids):
    while any(cb.result(r) is None for r in rids):
        cb.step_pump(1)


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_requests_rows_on_both_layouts(lm, layout):
    reg = obs_metrics.enable()
    try:
        cb = _mk(lm, **(PAGED if layout == "paged" else {}))
        rid = cb.submit(_prompt(6, 1), 4, deadline_s=60.0)
        live = cb.requests()[rid]
        assert live["state"] in ("queued", "prefilling", "decoding")
        assert live["slot"] == 0 and live["deadline_s"] <= 60.0
        if layout == "paged":
            assert "blocks" in live
        _drain(cb, [rid])
        row = cb.requests()[rid]
        assert row["state"] == "done" and row["tokens"] == 4 and row["preemptions"] == 0
        assert row["queue_ms"] is not None and row["ttft_ms"] is not None
        assert row["tpot_ms"] is not None and "slot" not in row
        assert reg.find("nns_request_ttft_ms").count >= 1
        assert reg.find("nns_request_tpot_ms").count >= 1
    finally:
        obs_metrics.disable()


def test_preemption_is_counted_on_its_request(lm):
    cb = _mk(lm, kv_blocks=6, **PAGED)  # 96 tokens: two 50-token requests cannot both grow
    rids = [cb.submit(_prompt(30, 2), 20), cb.submit(_prompt(30, 3), 20)]
    _drain(cb, rids)
    rows = cb.requests()
    assert cb.stats()["kv_preemptions"] >= 1
    assert sum(rows[r]["preemptions"] for r in rids) == cb.stats()["kv_preemptions"]
    assert all(rows[r]["state"] == "done" for r in rids)


def test_spans_and_snapshots_carry_the_ledger(lm):
    src, dst = _mk(lm, **PAGED), _mk(lm, **PAGED)
    rid = src.submit(_prompt(20, 4), 10, deadline_s=30.0)
    while src.stats()["kv_prefill_queue"] or len(src.partials([rid])[rid]) < 3:
        src.step_pump(1)
    # a preemption on record travels with the span
    src._slo.record(rid).preemptions = 2
    span = src.extract_request(rid)
    assert 0.0 < span.deadline_s <= 30.0 and span.preemptions == 2
    assert src.requests()[rid]["state"] == "migrated"
    new = dst.adopt_request(span)
    rec = dst._slo.record(new)
    assert rec.deadline_s == span.deadline_s and rec.preemptions == 2
    row = dst.requests()[new]
    # the row's deadline is the time left, rounded to 1 ms (kv/sched.py, as
    # the reference's): held to the span's at that resolution
    assert row["preemptions"] == 2 and 0.0 < row["deadline_s"] <= round(span.deadline_s, 3)
    snap = dst.snapshot()
    assert snap["slo"]["records"][0]["rid"] == new
    again = _mk(lm, **PAGED)
    again.restore(snap)
    assert again.requests()[new]["preemptions"] == 2
    _drain(again, [new])
    assert again.requests()[new]["state"] == "done"


def test_resume_from_span_opens_a_record(lm):
    src, dst = _mk(lm, **PAGED), _mk(lm, **PAGED)
    rid = src.submit(_prompt(20, 6), 8, deadline_s=10.0)
    while src.stats()["kv_prefill_queue"] or len(src.partials([rid])[rid]) < 2:
        src.step_pump(1)
    span = src.extract_request(rid)
    new = dst.resume_from_span(span)
    assert dst.requests()[new]["state"] in ("queued", "prefilling")
    _drain(dst, [new])
    assert dst.requests()[new]["state"] == "done"


LLM = ("appsrc name=src dimensions=16:1 types=int32 ! tensor_llm_serversink id={i} "
       'custom="vocab:97,d_model:32,n_heads:2,n_layers:1" n-slots=2 max-len=64 prompt-len=16 '
       "max-new-tokens=4 {extra} tensor_llm_serversrc id={i} name=srv ! tensor_sink name=out")


def _llm_run(i, extra="", n=2):
    from nnstreamer_tpu_torch.pipeline.parse import parse_pipeline
    from nnstreamer_tpu_torch.tensors.frame import Frame

    p = parse_pipeline(LLM.format(i=i, extra=extra), device="cpu")
    ex = p.start()
    for k in range(n):
        p["src"].push(Frame((_prompt(16, 10 + k).reshape(1, 16),), meta={"deadline_ms": 5000.0}))
    p["src"].end_of_stream()
    assert ex.wait(120)
    ex.stop()
    assert not ex.errors
    return p, ex


def test_llm_element_rows_and_the_requests_table():
    p, ex = _llm_run(71)
    row = ex.stats()["srv"]
    reqs = row["serving_requests"]
    assert len(reqs) == 2 and all(r["state"] == "done" for r in reqs.values())
    assert all(r.get("deadline_s") is not None for r in reqs.values())
    out = nns_top.render_requests({"nodes": {"srv": row}})
    assert "done" in out and "TTFT" in out.splitlines()[0]


def test_llm_plane_rows_are_per_stream():
    from nnstreamer_tpu_torch.pipeline.parse import parse_pipeline
    from nnstreamer_tpu_torch.tensors.frame import Frame

    desc = " ".join(
        f"appsrc name=src{i} dimensions=16:1 types=int32 ! tensor_llm_serversink id={80 + i} "
        'custom="vocab:97,d_model:32,n_heads:2,n_layers:1" n-slots=4 max-len=64 prompt-len=16 '
        f"max-new-tokens=4 kv-layout=paged plane=slop tensor_llm_serversrc id={80 + i} "
        f"name=srv{i} ! tensor_sink name=out{i}" for i in range(2))
    p = parse_pipeline(desc, device="cpu")
    ex = p.start()
    for i, n in ((0, 2), (1, 1)):
        for k in range(n):
            p[f"src{i}"].push(Frame((_prompt(16, 20 + 3 * i + k).reshape(1, 16),),
                                    meta={"deadline_ms": 9000.0}))
        p[f"src{i}"].end_of_stream()
    assert ex.wait(120)
    ex.stop()
    assert not ex.errors
    rows = [ex.stats()[f"srv{i}"]["serving_requests"] for i in range(2)]
    assert [len(r) for r in rows] == [2, 1]
    assert not set(rows[0]) & set(rows[1])  # a sharer never reports another's
    assert all(r["state"] == "done" for rr in rows for r in rr.values())
