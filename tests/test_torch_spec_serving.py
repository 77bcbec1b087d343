"""Port parity for speculative decoding and registered prefixes in the
serving engine: the device helpers (``models/serving_spec.py``,
``kv/block_attn.py batched_verify_step_block``), ``spec_step`` /
``spec_pump`` on the slot and the paged layout (block and gather), the
draft model, ``register_prefix`` / ``submit(prefix=)``, the token
history the plain pumps now write, and the serving element's
``speculate`` / ``speculate-model``, against the JAX package on the CPU
with numpy-seeded prompts and the JAX weights carried over with
``transformer_from_jax``. The cases of ``tests/test_speculative.py``'s
batcher classes, ``tests/test_serving.py``'s prefix cases,
``tests/test_kv_paged.py::test_register_prefix_paged_matches_slot`` and
the speculative cases of ``tests/test_llm_serve.py``.

Tolerances:

- Greedy token ids: identical. Every reference stream's top-2 margin in
  the JAX no-cache logits is asserted above 1e-4
  (``test_reference_streams_are_not_near_ties``), so a flip would be a
  fault. Acceptance counters (rounds, accepted tokens, proposal columns)
  equal the JAX batcher's on the same schedule.
- Logits of the verify forward: within 1e-4 of max |logit| (float32).
- The rejection sampler: a chi-square statistic over 24 000 first draws
  below the 0.999 quantile (the draws are seeded, so the outcome is fixed).
"""

import gc
import weakref

import numpy as np
import pytest
import torch
from scipy import stats as sstats

import jax
import jax.numpy as jnp

from nnstreamer_tpu.kv import block_attn as jkvb
from nnstreamer_tpu.models import decode as jdec
from nnstreamer_tpu.models import serving as jsv
from nnstreamer_tpu.models import transformer as jtfm
from nnstreamer_tpu_torch.kv import block_attn as tkvb
from nnstreamer_tpu_torch.kv import gather as tkvg
from nnstreamer_tpu_torch.models import serving as tsv
from nnstreamer_tpu_torch.models import serving_spec as tspec
from nnstreamer_tpu_torch.models import transformer as ttfm
from nnstreamer_tpu_torch.models.jax_weights import transformer_from_jax

VOCAB, D_MODEL, N_HEADS, N_KV, N_LAYERS = 97, 64, 4, 2, 2
DRAFT = dict(d_model=32, n_heads=2, n_layers=1)
N_SLOTS, MAX_LEN, PROMPT_LEN, BS = 4, 96, 16, 16
REF_BUDGET = 24
MARGIN = 1e-4
LOGIT_TOL = 1e-4
LAYOUTS = {"slot": {}, "paged": {"kv_layout": "paged", "block_size": BS}}


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(1, VOCAB, (n,)).astype(np.int32)


PFX = {"short": _prompt(5, 300), "one": _prompt(20, 301), "multi": _prompt(40, 302)}
TAILS = {"short": _prompt(3, 310), "one": _prompt(7, 311), "multi": _prompt(5, 312)}

# every prompt the file serves: the reference drains each once
PROMPTS = {
    # periodic prompts the n-gram lookup hits, and plain random ones
    "mix": [np.asarray([7, 8, 9, 7, 8, 9, 7, 8, 9, 7, 8], np.int32),
            np.tile(np.asarray([11, 12, 13], np.int32), 5),
            _prompt(6, 1), _prompt(11, 2)],
    "stop": [np.asarray([5, 6, 5, 6, 5, 6, 5], np.int32)],
    "draft": [_prompt(5, 21), _prompt(20, 22), _prompt(3, 23)],
    # a registered prefix then a tail, as one prompt
    "prefix": [np.concatenate([PFX[n], TAILS[n]]) for n in ("short", "one", "multi")],
    "shared": [np.concatenate([PFX["one"], _prompt(4, 320 + i)]) for i in range(2)],
}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _lm(jp, d_model, n_heads, n_layers, n_kv):
    lm = ttfm.TransformerLM(VOCAB, d_model, n_heads, n_layers, n_kv_heads=n_kv)
    lm.load_state_dict(transformer_from_jax(jax.tree_util.tree_map(np.asarray, jp)))
    return lm


@pytest.fixture(scope="module")
def models():
    """(JAX target, port target, JAX draft, port draft): the draft is
    smaller and seeded apart, for a partial agreement."""
    jp = jtfm.init_params(jax.random.PRNGKey(3), vocab=VOCAB, d_model=D_MODEL,
                          n_heads=N_HEADS, n_layers=N_LAYERS, n_kv_heads=N_KV)
    jd = jtfm.init_params(jax.random.PRNGKey(9), vocab=VOCAB, **DRAFT)
    return (jp, _lm(jp, D_MODEL, N_HEADS, N_LAYERS, N_KV), jd,
            _lm(jd, DRAFT["d_model"], DRAFT["n_heads"], DRAFT["n_layers"], DRAFT["n_heads"]))


def _jax_cb(jp, **kw):
    return jsv.ContinuousBatcher(jp, N_HEADS, n_slots=N_SLOTS, max_len=MAX_LEN,
                                 prompt_len=PROMPT_LEN, **{"attn_impl": "pallas", **kw})


def _port(lm, layout="slot", **kw):
    return tsv.ContinuousBatcher(lm, N_HEADS, n_slots=N_SLOTS, max_len=MAX_LEN,
                                 prompt_len=PROMPT_LEN, device="cpu",
                                 **{"attn_impl": "pallas", **LAYOUTS[layout], **kw})


def _drain(cb, rids, run):
    while any(cb.result(r) is None for r in rids):
        run(cb)
    return [list(cb.result(r)) for r in rids]


def _serve(cb, prompts, budget, run, **kw):
    return _drain(cb, [cb.submit(p, budget, **kw) for p in prompts], run)


def _spec_counters(st, rounds=True):
    """The acceptance counters; without the rounds, which count the
    batch's rounds and so depend on when requests joined (the paged
    layout admits one prefilled request a pump), where the accepted
    tokens and the proposal columns depend only on each stream."""
    keys = ("spec_rounds",) * rounds + ("spec_accepted_tokens", "spec_columns")
    return {k: st[k] for k in keys}


@pytest.fixture(scope="module")
def reference(models):
    """{group: [greedy stream of REF_BUDGET tokens, one a prompt]}: the JAX
    slot batcher (pallas), per-token steps, every prompt of PROMPTS."""
    jp = models[0]
    cb = _jax_cb(jp)
    out = {}
    for group, prompts in PROMPTS.items():
        rids = []
        for p in prompts:
            while (rid := cb.submit(p, REF_BUDGET)) is None:
                cb.step()
            rids.append(rid)
        out[group] = _drain(cb, rids, lambda c: c.step())
    return out


@pytest.fixture(scope="module")
def jax_spec(models):
    """The JAX batcher's speculative runs of the "mix" prompts (budget 20):
    {"step": (tokens, counters) of spec_step(k=4) rounds, "pump": ... of
    spec_pump(rounds=2, k=4), "draft": ... of a draft batcher's
    spec_step(k=4) over the "draft" prompts (budget 10)}."""
    jp, _, jd, _ = models
    out = {}
    for name, run in (("step", lambda c: c.spec_step(k=4)),
                      ("pump", lambda c: c.spec_pump(rounds=2, k=4))):
        cb = _jax_cb(jp)
        toks = _serve(cb, PROMPTS["mix"], 20, run)
        out[name] = (toks, _spec_counters(cb.stats()))
    cb = _jax_cb(jp, attn_impl="xla", draft_params=jd, draft_n_heads=DRAFT["n_heads"])
    toks = _serve(cb, PROMPTS["draft"], 10, lambda c: c.spec_step(k=4))
    out["draft"] = (toks, _spec_counters(cb.stats()))
    return out


def test_reference_streams_are_not_near_ties(models, reference):
    jp = models[0]
    fwd = jax.jit(lambda toks: jtfm.apply(jp, toks, N_HEADS))
    for group, prompts in PROMPTS.items():
        for p, toks in zip(prompts, reference[group]):
            seq = np.zeros((1, MAX_LEN), np.int32)
            seq[0, : len(p) + len(toks) - 1] = np.concatenate([p, toks[:-1]])
            logits = np.asarray(fwd(jnp.asarray(seq)))[0, len(p) - 1: len(p) + len(toks) - 1]
            top2 = np.sort(logits, axis=-1)[:, -2:]
            assert (top2[:, 1] - top2[:, 0]).min() > MARGIN, group
            assert logits.argmax(-1).tolist() == toks


# -- the device helpers --------------------------------------------------------------------


def _close(got, want, tol=LOGIT_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _filled_cache(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("quantized", [False, True])
def test_batched_verify_step_matches_reference(models, quantized):
    """Logits and the written cache of the k-column verify, slot layout:
    per-slot fills, an idle slot, -1 sentinel columns, int8."""
    jp, lm, _, _ = models
    rng = np.random.default_rng(0)
    b, k, L = 3, 4, N_LAYERS
    shape = (L, b, MAX_LEN, N_KV, D_MODEL // N_HEADS)
    ck, cv = _filled_cache(rng, shape), _filled_cache(rng, shape)
    toks = rng.integers(0, VOCAB, (b, k)).astype(np.int32)
    toks[1, 2:] = -1
    pos = np.asarray([5, 40, 91], np.int32)
    active = np.asarray([True, True, False])
    if quantized:
        jcache = tuple(jsv.quantize_kv(jnp.asarray(c)) for c in (ck, cv))
        tcache = tuple(tuple(torch.from_numpy(np.array(x)) for x in q) for q in jcache)
    else:
        jcache = (jnp.asarray(ck), jnp.asarray(cv))
        tcache = (torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy()))
    jl, jc = jsv.batched_verify_step(jp, jnp.asarray(toks), jnp.asarray(pos),
                                     jnp.asarray(active), jcache, N_HEADS)
    tl, tc = tspec.batched_verify_step(lm, torch.from_numpy(toks), torch.from_numpy(pos),
                                       torch.from_numpy(active), tcache, N_HEADS)
    _close(tl.numpy(), jl)
    for got, want in zip(jax.tree_util.tree_leaves(tc), jax.tree_util.tree_leaves(jc)):
        _close(np.asarray(got), want)


@pytest.mark.parametrize("quantized", [False, True])
def test_batched_verify_step_block_matches_reference(models, quantized):
    """The block-native verify on an arena through block tables, a window
    crossing a block boundary and an idle lane: logits and the arena
    against the JAX function, and against the gather formulation."""
    jp, lm, _, _ = models
    rng = np.random.default_rng(1)
    b, k, n_blocks = 3, 4, 20
    tables = np.zeros((b, MAX_LEN // BS), np.int32)
    tables[0, :2] = [3, 7]
    tables[1, :3] = [1, 2, 9]
    tables[2, :1] = [5]
    pos = np.asarray([14, 30, 3], np.int32)  # lane 0 crosses into its 2nd block
    active = np.asarray([True, True, False])
    toks = rng.integers(0, VOCAB, (b, k)).astype(np.int32)
    arena_np = [rng.normal(size=(N_LAYERS, n_blocks + 1, BS, N_KV, D_MODEL // N_HEADS))
                .astype(np.float32) for _ in range(2)]
    for a in arena_np:
        a[:, 0] = 0.0  # scratch keeps its init values
    if quantized:
        jarena = tuple(jsv.quantize_kv(jnp.asarray(a)) for a in arena_np)
        jarena = tuple((q, s.at[:, 0].set(1.0)) for q, s in jarena)

        def tarena():
            return tuple(tuple(torch.from_numpy(np.asarray(x).copy()) for x in q)
                         for q in jarena)
    else:
        jarena = tuple(jnp.asarray(a) for a in arena_np)

        def tarena():
            return tuple(torch.from_numpy(a.copy()) for a in arena_np)
    args = [jnp.asarray(x) for x in (toks, pos, active)]
    jl, ja = jkvb.batched_verify_step_block(jp, *args, jarena, jnp.asarray(tables), N_HEADS)
    targs = [torch.from_numpy(x) for x in (toks, pos, active)]
    tl, ta = tkvb.batched_verify_step_block(lm, *targs, tarena(), torch.from_numpy(tables),
                                            N_HEADS)
    _close(tl.numpy(), jl)
    for got, want in zip(jax.tree_util.tree_leaves(ta), jax.tree_util.tree_leaves(ja)):
        _close(np.asarray(got), want)
    # the gather oracle: the slot verify on a view, the window scattered back
    ga = tarena()
    view = tkvg.gather_cache(ga, torch.from_numpy(tables))
    gl, _ = tspec.batched_verify_step(lm, *targs, view, N_HEADS)
    tkvg.scatter_window(ga, torch.from_numpy(tables), view, targs[1], k, targs[2])
    assert torch.equal(gl, tl)
    for got, want in zip(jax.tree_util.tree_leaves(ga), jax.tree_util.tree_leaves(ta)):
        assert torch.equal(got, want)


def test_ngram_propose_and_hist_ops_match_reference():
    """device_ngram_propose, hist_write_row and spec_emit_hist against the
    JAX functions on random histories with planted repeats, every g and
    k, pads, pos 0 and an idle lane."""
    rng = np.random.default_rng(2)
    b, h = 6, 48
    hist = rng.integers(0, 5, (b, h)).astype(np.int32)
    pos = np.asarray([0, 3, 20, 47, 30, 10], np.int32)
    for i in range(b):
        hist[i, pos[i] + 1:] = -1
    hist[5, 2:6] = -1  # pads inside the context never match
    for g in (1, 2, 3):
        for k in (2, 4, 6):
            want = jsv.device_ngram_propose(jnp.asarray(hist), jnp.asarray(pos), k, g)
            got = tspec.device_ngram_propose(torch.from_numpy(hist), torch.from_numpy(pos), k, g)
            assert got.tolist() == np.asarray(want).tolist(), (g, k)
    row = rng.integers(0, VOCAB, (b, 4)).astype(np.int32)
    start = np.asarray([0, 5, 44, 46, 10, 47], np.int32)
    count = np.asarray([4, 0, 4, 2, 1, 1], np.int32)
    want = jsv.hist_write_row(jnp.asarray(hist), jnp.asarray(row), jnp.asarray(start),
                              jnp.asarray(count))
    got = torch.from_numpy(hist.copy())
    tspec.hist_write_row(got, torch.from_numpy(row), torch.from_numpy(start),
                         torch.from_numpy(count))
    assert got.tolist() == np.asarray(want).tolist()
    toks = rng.integers(0, VOCAB, (b, 4)).astype(np.int32)
    m = np.asarray([1, 2, 4, 3, 0, 1], np.int32)
    final = rng.integers(0, VOCAB, (b,)).astype(np.int32)
    active = np.asarray([True, True, True, True, False, True])
    pos2 = np.asarray([3, 8, 20, 40, 1, 43], np.int32)
    we, wh = jsv.spec_emit_hist(*(jnp.asarray(x) for x in (toks, m, final, active, hist)),
                                jnp.asarray(pos2), False)
    th = torch.from_numpy(hist.copy())
    te = tspec.spec_emit_hist(*(torch.from_numpy(x) for x in (toks, m, final, active)), th,
                              torch.from_numpy(pos2))
    assert te.tolist() == np.asarray(we).tolist() and th.tolist() == np.asarray(wh).tolist()


def test_greedy_spec_accept_matches_reference():
    rng = np.random.default_rng(3)
    b, k, v = 64, 5, 11
    logits = rng.normal(size=(b, k, v)).astype(np.float32)
    greedy = logits.argmax(-1)
    toks = np.where(rng.random((b, k)) < 0.6, np.roll(greedy, 1, axis=1),
                    rng.integers(0, v, (b, k))).astype(np.int32)
    toks[rng.random((b, k)) < 0.1] = -1
    z = np.zeros((b,), np.float32)
    want = jsv.spec_accept(jnp.asarray(logits), jnp.asarray(toks), jnp.asarray(z),
                           jnp.zeros((b,), jnp.int32), jnp.ones((b,)),
                           jnp.zeros((b, 2), jnp.uint32),
                           jnp.zeros((b,), jnp.int32), False)
    got = tspec.spec_accept(torch.from_numpy(logits), torch.from_numpy(toks),
                            torch.from_numpy(z), torch.zeros((b,), dtype=torch.int32),
                            torch.ones((b,)), torch.zeros((b,), dtype=torch.int64),
                            torch.zeros((b,), dtype=torch.int32), False)
    for g, w in zip(got, want):
        assert g.tolist() == np.asarray(w).tolist()
    # a greedy slot in the sampling program decides as in the greedy one
    got_s = tspec.spec_accept(torch.from_numpy(logits), torch.from_numpy(toks),
                              torch.from_numpy(z), torch.zeros((b,), dtype=torch.int32),
                              torch.ones((b,)), torch.arange(b, dtype=torch.int64),
                              torch.zeros((b,), dtype=torch.int32), True)
    for g, w in zip(got_s, want):
        assert g.tolist() == np.asarray(w).tolist()


CHI2_DRAWS = 24000
CHI2_QUANTILE = 0.999


@pytest.mark.parametrize("prop", ["likely", "unlikely", "none"])
@pytest.mark.parametrize("temp,top_k,top_p", [(1.0, 0, 1.0), (0.7, 5, 1.0), (1.3, 0, 0.8)])
def test_rejection_sampler_draws_from_the_filtered_softmax(prop, temp, top_k, top_p):
    """The first emitted token of a sampling round (the proposal if
    accepted, else the residual draw) over 24 000 slots with the same
    logits and different keys: its counts against softmax of the filtered
    logits by a chi-square test at the 0.999 quantile, whether the
    proposal is likely, unlikely or absent; filtered tokens never come."""
    v, k, n = 8, 3, CHI2_DRAWS
    base = torch.log(torch.tensor([0.30, 0.20, 0.15, 0.12, 0.09, 0.07, 0.05, 0.02]))
    target = torch.softmax(tsv._filtered_logits(
        base[None], torch.tensor([temp]), torch.tensor([top_k], dtype=torch.int32),
        torch.tensor([top_p]))[0], dim=-1).numpy().astype(np.float64)
    live = target > 0
    p = {"likely": int(np.argmax(target)), "unlikely": int(np.flatnonzero(live)[-1]),
         "none": -1}[prop]
    logits = base.repeat(n, k, 1)
    toks = torch.tensor([1, p, 2], dtype=torch.int32).repeat(n, 1)
    keys = torch.tensor([tsv.seed_key(s) for s in range(8)], dtype=torch.int64).repeat(n // 8)
    pos = torch.arange(n, dtype=torch.int32) // 8
    m, final = tspec.spec_accept(logits, toks, torch.full((n,), temp),
                                 torch.full((n,), top_k, dtype=torch.int32),
                                 torch.full((n,), top_p), keys, pos, True)
    first = torch.where(m >= 2, toks[:, 1], final).numpy()
    counts = np.bincount(first, minlength=v)
    assert counts[~live].sum() == 0
    expected = target[live] * n
    chi2 = float(((counts[live] - expected) ** 2 / expected).sum())
    assert chi2 < sstats.chi2.ppf(CHI2_QUANTILE, int(live.sum()) - 1), (chi2, counts)


# -- the batcher ------------------------------------------------------------------------------


def _spec_step(k=4, ngram=2):
    return lambda c: c.spec_step(k=k, ngram=ngram)


def _spec_pump(rounds=2, k=4, ngram=2):
    return lambda c: c.spec_pump(rounds=rounds, k=k, ngram=ngram)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_spec_step_equals_reference_and_its_counters(models, reference, jax_spec, layout):
    """spec_step rounds give the reference's greedy streams, and the JAX
    batcher's accepted tokens and proposal columns (and, on the slot
    layout's schedule, its rounds): the device miner proposes what the
    reference's host lookup does."""
    lm = models[1]
    cb = _port(lm, layout)
    toks = _serve(cb, PROMPTS["mix"], 20, _spec_step())
    want, counters = jax_spec["step"]
    assert toks == want == [t[:20] for t in reference["mix"]]
    st = cb.stats()
    slot = layout == "slot"
    assert _spec_counters(st, slot) == _spec_counters(counters, slot)
    assert st["spec_accepted_tokens"] > 0 and st["tokens_emitted"] > st["steps"]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_spec_pump_equals_spec_steps_and_reference(models, reference, jax_spec, layout):
    """A spec pump of 2 rounds is 2 spec_step rounds: the same streams
    and counters, and the JAX spec_pump's (rounds on the slot layout's
    schedule)."""
    lm = models[1]
    cb = _port(lm, layout)
    toks = _serve(cb, PROMPTS["mix"], 20, _spec_pump())
    want, counters = jax_spec["pump"]
    assert toks == want == [t[:20] for t in reference["mix"]]
    slot = layout == "slot"
    assert _spec_counters(cb.stats(), slot) == _spec_counters(counters, slot)
    steps = _port(lm, layout)
    assert _serve(steps, PROMPTS["mix"], 20, _spec_step()) == toks


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_spec_pump_eager_oracle_and_one_program_per_key(models, reference, layout):
    """A drain of spec pumps of 2 and 4 rounds and spec steps fills one
    program per (rounds, k, g, sampling, source), each once; the eager
    oracles fill none and give the same tokens. rounds is floored to a
    power of two (3 runs the 2-round program)."""
    lm = models[1]
    cb = _port(lm, layout)
    rids = [cb.submit(p, 20) for p in PROMPTS["mix"]]
    cb.spec_pump(rounds=2, k=4)
    progs = dict(cb._programs)
    for run in (_spec_pump(4), _spec_pump(3), _spec_step(), _spec_pump(2)):
        run(cb)
    toks = _drain(cb, rids, _spec_pump(2))
    assert toks == [t[:20] for t in reference["mix"]]
    spec_keys = {k for k in cb._programs if k[0] == "spec"}
    # spec_step's round, or its sentinel round when no slot proposes
    assert spec_keys <= {("spec", r, 4, 2, False, "ngram") for r in (1, 2, 4)} | {
        ("spec", 1, 2, 0, False, "none")}
    assert ("spec", 2, 4, 2, False, "ngram") in spec_keys
    assert all(cb._programs[k] is p for k, p in progs.items())
    st = cb.stats()
    assert st["spec_programs_filled"] == len(spec_keys)
    name = "slot" if layout == "slot" else "paged-block"
    assert f"{name}/spec-r2-k4-g2-ngram/greedy/float32/pallas" in st["programs"]
    assert not any(p["captured"] for p in st["programs"].values())
    oracle = _port(lm, layout)
    o_rids = [oracle.submit(p, 20) for p in PROMPTS["mix"]]
    oracle.spec_step_eager(k=4)
    assert _drain(oracle, o_rids, lambda c: c.spec_pump_eager(rounds=2, k=4)) == toks
    assert oracle.stats()["programs_filled"] == 0


def test_paged_block_and_gather_formulations_are_equal(models, reference):
    """kv_attn="gather" runs the verify on a gathered view and scatters
    the k-column window back: the same streams and counters as the
    block-native verify, one gather dispatch a spec run."""
    lm = models[1]
    out = {}
    for kv_attn in ("gather", "block"):
        cb = _port(lm, "paged", attn_impl="xla", kv_attn=kv_attn)
        rids = [cb.submit(p, 20) for p in PROMPTS["mix"]]
        runs = 0
        while any(cb.result(r) is None for r in rids):
            cb.spec_pump(rounds=2, k=4)
            runs += 1
        st = cb.stats()
        out[kv_attn] = ([cb.result(r) for r in rids], _spec_counters(st))
        assert st["kv_gather_dispatches"] == (runs if kv_attn == "gather" else 0)
    assert out["gather"] == out["block"]
    assert out["block"][0] == [t[:20] for t in reference["mix"]]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_pumps_write_the_token_history_as_the_reference(models, reference, layout):
    """The plain pumps and admission now write the per-slot history: after
    a schedule of steps and pumps, the port's history rows equal the JAX
    batcher's on the same schedule, and a spec round after plain steps
    mines them (its streams stay the reference's)."""
    jp, lm = models[:2]
    prompts = PROMPTS["mix"]
    jcb = _jax_cb(jp, **LAYOUTS[layout])
    tcb = _port(lm, layout)
    jr = [jcb.submit(p, 20) for p in prompts]
    tr = [tcb.submit(p, 20) for p in prompts]
    for cb in (jcb, tcb):
        for _ in range(4):
            cb.step()
        cb.step_pump(3)
    assert tcb._hist.tolist() == np.asarray(jcb._hist).tolist()
    assert _drain(tcb, tr, _spec_pump()) == [t[:20] for t in reference["mix"]]
    assert tcb.stats()["spec_accepted_tokens"] > 0
    del jr


def test_stop_token_mid_chunk_and_budget_edge(models, reference):
    """A stop token inside an accepted chunk ends the request there, as a
    plain step does; a budget that ends mid-chunk truncates exactly."""
    lm = models[1]
    (want,) = reference["stop"]
    stop = want[2]
    cut = want[: want.index(stop) + 1]
    for run in (_spec_step(6), _spec_pump(2, 6)):
        cb = _port(lm)
        assert _drain(cb, [cb.submit(PROMPTS["stop"][0], 8, stop_token=stop)], run) == [cut]
        cb = _port(lm)
        assert _serve(cb, PROMPTS["stop"], 3, run) == [want[:3]]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_int8_cache_spec_equals_plain_int8(models, layout):
    """The verify writes the int8 chunk and attends it dequantized, as the
    plain int8 step does: the spec streams equal the JAX int8 plain
    batcher's."""
    jp, lm = models[:2]
    prompts = PROMPTS["mix"][:2]
    want = _serve(_jax_cb(jp, cache_dtype="int8"), prompts, 12, lambda c: c.step())
    cb = _port(lm, layout, cache_dtype="int8")
    assert _serve(cb, prompts, 12, _spec_pump()) == want


def test_no_proposal_rounds_stay_on_the_verify_program(models, reference, monkeypatch):
    """When no slot's n-gram lookup finds anything, a Pallas batcher runs a
    width-2 verify of sentinels (rounds counted, no columns, nothing
    accepted) and an XLA batcher a plain step (no round); both end on the
    reference's tokens, and each fallback is counted."""
    monkeypatch.setattr(tspec, "ngram_lookup", lambda *a, **k: None)
    lm = models[1]
    prompt = PROMPTS["mix"][2]
    want = reference["mix"][2][:10]
    for impl in ("xla", "pallas"):
        cb = _port(lm, attn_impl=impl)
        assert _serve(cb, [prompt], 10, _spec_step()) == [want]
        st = cb.stats()
        if impl == "pallas":
            assert st["spec_rounds"] == st["spec_sentinel_rounds"] > 0
            assert st["spec_columns"] == st["spec_accepted_tokens"] == 0
            assert ("spec", 1, 2, 0, False, "none") in cb._programs
        else:
            assert st["spec_rounds"] == 0 and st["spec_fallback_no_proposal"] > 0


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_spec_pump_tail_runs_spec_steps_of_shrinking_width(models, impl):
    """Near max_len no whole round of k columns fits: spec_pump finishes
    the tail with spec_step rounds whose width shrinks to the room left
    (a 1-round program of k < 4, or the sentinel round), and the stream
    is the JAX model's. No round ever writes past max_len."""
    jp, lm = models[:2]
    p = np.tile(np.asarray([4, 5, 6], np.int32), 20)[:59]
    cb = tsv.ContinuousBatcher(lm, N_HEADS, n_slots=1, max_len=64, prompt_len=PROMPT_LEN,
                               device="cpu", attn_impl=impl)
    got = _serve(cb, [p], 5, _spec_pump(4, 4))
    want = np.asarray(jdec.generate(jp, jnp.asarray(p[None]), N_HEADS, 5))[0].tolist()
    assert got == [want]
    assert any(k[0] == "spec" and k[1] == 1 and (k[2] < 4 or k[5] == "none")
               for k in cb._programs), list(cb._programs)
    assert cb.stats()["spec_fallback_no_room"] == 0


def test_draft_spec_equals_reference_and_its_counters(models, reference, jax_spec):
    """A smaller draft proposes for every slot: the streams are the
    reference's and the counters the JAX draft batcher's."""
    _, lm, _, dlm = models
    cb = _port(lm, attn_impl="xla", draft_params=dlm, draft_n_heads=DRAFT["n_heads"])
    toks = _serve(cb, PROMPTS["draft"], 10, _spec_step())
    want, counters = jax_spec["draft"]
    assert toks == want == [t[:10] for t in reference["draft"]]
    assert _spec_counters(cb.stats()) == counters
    pumped = _port(lm, draft_params=dlm, draft_n_heads=DRAFT["n_heads"])
    assert _serve(pumped, PROMPTS["draft"], 10, _spec_pump()) == toks


def test_self_draft_accepts_everything(models, reference):
    """Draft = target: every proposal is the target's own choice, so every
    round commits all k columns, on spec_step and spec_pump, after plain
    pumps that advanced the draft's cache."""
    lm = models[1]
    p = PROMPTS["draft"][0]
    for run in (_spec_step(), _spec_pump()):
        cb = _port(lm, draft_params=lm, draft_n_heads=N_HEADS)
        rid = cb.submit(p, 18)
        cb.step_pump(3)  # the plain pump steps the draft too
        cb.step()
        assert _drain(cb, [rid], run) == [reference["draft"][0][:18]]
        st = cb.stats()
        assert st["spec_accepted_tokens"] == st["spec_rounds"] * 3 > 0
        assert st["spec_acceptance_rate"] == 1.0


def test_draft_spec_with_sampling_slot_and_prefix(models, reference):
    """A sampling slot beside a greedy one speculates deterministically
    per seed, the greedy slot keeps its stream; a draft prefills the
    whole context of a prefix= request (a self-draft then accepts all)."""
    _, lm, _, dlm = models
    p = PROMPTS["draft"][0]

    def run():
        cb = _port(lm, draft_params=dlm, draft_n_heads=DRAFT["n_heads"])
        rs = cb.submit(p, 8, temperature=0.7, seed=4)
        rg = cb.submit(p, 8)
        return _drain(cb, [rs, rg], _spec_step(3))

    a, b = run(), run()
    assert a == b and a[1] == reference["draft"][0][:8]
    cb = _port(lm, draft_params=lm, draft_n_heads=N_HEADS)
    pid = cb.register_prefix(PFX["one"])
    got = _drain(cb, [cb.submit(TAILS["one"], 8, prefix=pid)], _spec_step())
    assert got == [reference["prefix"][1][:8]]
    st = cb.stats()
    assert st["spec_accepted_tokens"] == st["spec_rounds"] * 3


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_a_dropped_batcher_is_freed_at_once(models, layout):
    """The program cache keeps no reference back to its batcher: once plain
    and spec programs (and, on the slot layout, a draft's) were filled, a
    dropped batcher goes with reference counting alone, so its cache is
    freed at once, not at the next cyclic collection (on the card a
    batcher kept alive that way held its multi-GB cache past its owner)."""
    lm, dlm = models[1], models[3]
    kw = dict(draft_params=dlm, draft_n_heads=DRAFT["n_heads"]) if layout == "slot" else {}
    cb = _port(lm, layout, **kw)
    cb.submit(PROMPTS["mix"][0], 8)
    cb.step_pump(2)
    cb.spec_pump(rounds=2, k=4)
    cb.spec_step(k=3)
    assert len(cb._programs) >= 3
    ref = weakref.ref(cb)
    gc.disable()
    try:
        del cb
        assert ref() is None
    finally:
        gc.enable()


def test_paged_draft_is_refused_as_in_the_reference(models):
    jp, lm, jd, dlm = models
    with pytest.raises(ValueError, match="draft models"):
        _jax_cb(jp, kv_layout="paged", block_size=BS, draft_params=jd)
    with pytest.raises(ValueError, match="draft models"):
        _port(lm, "paged", draft_params=dlm)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_sampling_spec_is_seeded_and_batch_independent(models, reference, layout):
    """Sampling slots speculate: a run is fixed by its seed, a sampled
    stream alone equals the same stream in a full batch of greedy and
    sampling neighbours joined at other times, and a near-zero
    temperature gives the greedy stream through the acceptance path."""
    lm = models[1]
    p = PROMPTS["mix"][0]
    kw = dict(temperature=0.9, top_p=0.9, seed=11)
    alone = _port(lm, layout)
    want = _drain(alone, [alone.submit(p, 16, **kw)], _spec_pump())
    assert alone.stats()["spec_rounds"] > 0
    again = _port(lm, layout)
    assert _drain(again, [again.submit(p, 16, **kw)], _spec_step()) == want
    cb = _port(lm, layout)
    others = [cb.submit(PROMPTS["mix"][1], 24, temperature=0.7, seed=2),
              cb.submit(PROMPTS["mix"][2], 24)]
    cb.spec_pump(rounds=2, k=4)
    rid = cb.submit(p, 16, **kw)
    others.append(cb.submit(PROMPTS["mix"][3], 24, temperature=1.3, top_k=9, seed=11))
    got = _drain(cb, [rid] + others, _spec_pump())
    assert got[0] == want[0] and got[2] == reference["mix"][2][:24]
    tiny = _port(lm, layout)
    assert _drain(tiny, [tiny.submit(p, 12, temperature=1e-6, seed=12)],
                  _spec_pump()) == [reference["mix"][0][:12]]


# -- registered prefixes -------------------------------------------------------------------


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("which", ["short", "one", "multi"])
def test_prefix_equals_the_concatenated_prompt(models, reference, layout, which):
    """submit(prefix=id) gives the tokens of the prefix and the prompt
    submitted as one (the JAX batcher's), for a prefix inside one bucket,
    past one, and over several; on both layouts, under plain pumps and
    spec pumps."""
    lm = models[1]
    want = reference["prefix"][["short", "one", "multi"].index(which)]
    for run in (lambda c: c.step_pump(4), _spec_pump()):
        cb = _port(lm, layout)
        pid = cb.register_prefix(PFX[which])
        assert _drain(cb, [cb.submit(TAILS[which], 12, prefix=pid)], run) == [want[:12]]
        assert cb.stats()["prefixes_registered"] == 1


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_prefix_shared_across_requests(models, reference, layout):
    lm = models[1]
    cb = _port(lm, layout)
    pid = cb.register_prefix(PFX["one"])
    rids = [cb.submit(p[len(PFX["one"]):], 8, prefix=pid) for p in PROMPTS["shared"]]
    assert _drain(cb, rids, lambda c: c.step_pump(4)) == [t[:8] for t in reference["shared"]]
    if layout == "paged":
        assert cb.stats()["kv_prefix_hits"] >= 2


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_prefix_validation_and_unregister(models, layout):
    """An unknown id and a prefix + prompt past max_len raise; unregister
    releases once (the paged pins go back to the pool)."""
    lm = models[1]
    cb = _port(lm, layout)
    with pytest.raises(ValueError, match="unknown prefix"):
        cb.submit(_prompt(4, 310), 2, prefix=99)
    with pytest.raises(ValueError, match="prefix length"):
        cb.register_prefix(np.zeros((0,), np.int32))
    pid = cb.register_prefix(_prompt(80, 311))
    with pytest.raises(ValueError, match="overflow|max_len"):
        cb.submit(_prompt(13, 312), 8, prefix=pid)
    before = cb.stats().get("kv_blocks_in_use")
    assert cb.unregister_prefix(pid)
    assert not cb.unregister_prefix(pid)
    assert cb.stats()["prefixes_registered"] == 0
    if layout == "paged":
        assert cb.stats()["kv_blocks_in_use"] == before - 5


def test_register_prefix_paged_matches_slot(models):
    """A 32-token periodic system prompt registered on both layouts: the
    same tokens, the paged prefix index hit (with and without prefix=),
    and probe_prefix sees its two full blocks."""
    lm = models[1]
    sysp = np.tile(np.arange(1, 10, dtype=np.int32), 4)[:32]
    slot, paged = _port(lm), _port(lm, "paged")
    pa, pb = slot.register_prefix(sysp), paged.register_prefix(sysp)
    hits0 = paged.stats()["kv_prefix_hits"]
    user = _prompt(7, 3)
    a = _drain(slot, [slot.submit(user, 6, prefix=pa)], lambda c: c.step())
    b = _drain(paged, [paged.submit(user, 6, prefix=pb)], lambda c: c.step_pump(4))
    c = _drain(paged, [paged.submit(np.concatenate([sysp, user]), 6)],
               lambda c: c.step_pump(4))
    assert a == b == c
    assert paged.stats()["kv_prefix_hits"] >= hits0 + 2
    assert paged.probe_prefix(np.concatenate([sysp, user])) == 32
    assert slot.probe_prefix(sysp) == 0


# -- the serving element -------------------------------------------------------------------

PIPE_OPTS = "vocab:211,d_model:32,n_heads:2,n_layers:2,seed:5"


@pytest.fixture(scope="module")
def pipe_npz(tmp_path_factory):
    """The JAX zoo's weights for PIPE_OPTS as an npz both packages load
    through ``params:``."""
    jp = jtfm.init_params(jax.random.PRNGKey(5), 211, 32, 2, 2, n_kv_heads=2)
    path = tmp_path_factory.mktemp("lm") / "lm.npz"
    np.savez(path, **{f"p{i}": np.asarray(x)
                      for i, x in enumerate(jax.tree_util.tree_leaves(jp))})
    return jp, str(path)


def _element_run(srv, extra, custom, prompt, budget=8):
    """One prompt through serversink/serversrc on the CPU → (tokens, the
    sink's server)."""
    from nnstreamer_tpu_torch.elements.llm_serve import LlmServerSink, LlmServerSrc
    from nnstreamer_tpu_torch.elements.sink import AppSink
    from nnstreamer_tpu_torch.elements.sources import AppSrc
    from nnstreamer_tpu_torch.pipeline.graph import Pipeline
    from nnstreamer_tpu_torch.tensors.frame import Frame
    from nnstreamer_tpu_torch.tensors.spec import TensorFormat, TensorsSpec

    src = AppSrc(spec=TensorsSpec(format=TensorFormat.FLEXIBLE))
    sink = LlmServerSink(**{"id": srv, "custom": custom, "n-slots": 1, "max-len": 64,
                            "prompt-len": 16, "max-new-tokens": budget, **extra})
    out_sink = AppSink()
    p = Pipeline(device="cpu").chain(src, sink)
    p.chain(LlmServerSrc(**{"id": srv}), out_sink)
    p.start()
    try:
        src.push(Frame((prompt,), meta={"req": "x"}))
        src.end_of_stream()
        f = out_sink.pop(timeout=120)
        assert f is not None, "the server ended before the reply"
        return f.tensors[0][0].tolist(), sink._server
    finally:
        p.stop()


ELEMENT_PROMPT = np.asarray([3, 4, 3, 4, 3, 4, 3], np.int32)


@pytest.mark.parametrize("extra", [{"speculate": "4"}, {"speculate": "3", "pump": "8"},
                                   {"speculate": "auto"}, {"speculate": "auto", "pump": "8"}])
def test_speculate_prop_equals_plain_serving(pipe_npz, extra):
    """speculate=k (spec_step, or spec_pump with pump > 1) and
    speculate=auto give the JAX model's greedy stream; the rounds show in
    the stats, auto's k stays in 2..8 and its EMA moves."""
    jp, path = pipe_npz
    got, srv = _element_run(f"sp-{'-'.join(extra.values())}", extra, f"{PIPE_OPTS},params:{path}",
                            ELEMENT_PROMPT, budget=10)
    want = np.asarray(jdec.generate(jp, jnp.asarray(ELEMENT_PROMPT[None]), 2, 10))[0].tolist()
    assert got == want
    st = srv.stats()
    assert st["spec_rounds"] > 0
    if extra["speculate"] == "auto":
        assert 2 <= srv._spec_k <= 8 and st["spec_k"] == srv._spec_k
        assert srv._acc_ema != 0.5 or st["spec_columns"] == 0
    else:
        assert st["spec_k"] == int(extra["speculate"])


def test_speculate_model_prop_against_the_reference_element(pipe_npz):
    """speculate-model=zoo:transformer_lm with draft_-prefixed options: the
    same tokens as the JAX element given the same description, and as
    plain serving; a self-draft under speculate=auto converges above k 2
    with a perfect acceptance rate."""
    from nnstreamer_tpu.pipeline.parse import parse_pipeline as jparse
    from nnstreamer_tpu_torch.pipeline.parse import parse_pipeline as tparse

    jp, path = pipe_npz
    custom = (f"{PIPE_OPTS},params:{path},"
              "draft_d_model:32,draft_n_layers:1,draft_n_heads:2,draft_seed:9")
    desc = ("tensorsrc dimensions=7:1 types=int32 num-frames=1 pattern=ones ! "
            f'tensor_llm_serversink id={{id}} custom="{custom}" speculate=4 '
            "speculate-model=zoo:transformer_lm max-new-tokens=8 n-slots=1 max-len=64 "
            "prompt-len=16 tensor_llm_serversrc id={id} ! tensor_sink name=out")
    jpipe = jparse(desc.format(id="jdraft"))
    jpipe.run(timeout=120)
    tpipe = tparse(desc.format(id="tdraft"), device="cpu")
    tpipe.run(timeout=120)
    want = np.asarray(jpipe["out"].frames[0].tensors[0])[0].tolist()
    got = np.asarray(tpipe["out"].frames[0].tensors[0])[0].tolist()
    assert got == want == np.asarray(
        jdec.generate(jp, jnp.ones((1, 7), jnp.int32), 2, 8))[0].tolist()
    self_draft = f"{PIPE_OPTS},params:{path}," + ",".join(
        "draft_" + kv for kv in f"{PIPE_OPTS},params:{path}".split(","))
    toks, srv = _element_run("autoconv", {"speculate": "auto",
                                          "speculate-model": "zoo:transformer_lm"},
                             self_draft, np.asarray([3, 4, 5, 6], np.int32), budget=40)
    st = srv.stats()
    assert st["spec_k"] > 2 and st["spec_acceptance_ema"] > 0.5
    assert st["spec_acceptance_rate"] == 1.0
    assert toks == np.asarray(jdec.generate(jp, jnp.asarray([[3, 4, 5, 6]]), 2, 40))[0].tolist()
