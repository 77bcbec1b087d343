"""Port parity for the serving engine's one-program pump: the port's pump
programs (``models/serving.py`` ``_pump_body`` / ``_program``, on the CPU
run eagerly, the same program objects that CUDA captures) against the JAX
``ContinuousBatcher``, on the slot and the paged layout, with
numpy-seeded prompts and JAX weights carried over with
``transformer_from_jax``. The non-speculative cases of
``tests/test_pumps.py``, each on both layouts, plus the device sampler.

Tolerances:

- Tokens: identical. Both sides run ``attn_impl="pallas"`` (the port's K3
  and K4 plain versions on the CPU; the reference's kernels as its own CPU
  tests run them). Every reference stream's top-2 margin in the JAX
  no-cache logits is asserted above 1e-4 (``test_reference_streams_are_not_near_ties``),
  so a flip would be a fault, not summation-order noise. The int8 cache's
  streams are held to the JAX int8 batcher's exactly.
- The sampler: a chi-square statistic over 24 000 draws from a fixed
  8-way distribution below the 0.999 quantile of its distribution (one
  run in a thousand of a correct sampler would fail; the draws are
  seeded, so the outcome is fixed).

Budget: the JAX reference batchers are built once per module (one per
layout and cache dtype) and every prompt of the file drains through them
once; greedy streams do not depend on the batch or the schedule, so each
test takes its prompts' prefixes.
"""

import numpy as np
import pytest
import torch
from scipy import stats as sstats

import jax
import jax.numpy as jnp

from nnstreamer_tpu.models import serving as jsv
from nnstreamer_tpu.models import transformer as jtfm
from nnstreamer_tpu_torch.models import serving as tsv
from nnstreamer_tpu_torch.models import transformer as ttfm
from nnstreamer_tpu_torch.models.jax_weights import transformer_from_jax

VOCAB, D_MODEL, N_HEADS, N_KV, N_LAYERS = 257, 64, 4, 2, 2
N_SLOTS, MAX_LEN, PROMPT_LEN, BS = 4, 96, 16, 16
REF_BUDGET = 40
MARGIN = 1e-4
LAYOUTS = {"slot": {}, "paged": {"kv_layout": "paged", "block_size": BS}}


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(1, VOCAB, (n,)).astype(np.int32)


def _schedule_prompts(seed):
    """The random-schedule case's prompts and budgets."""
    rng = np.random.default_rng(seed)
    prompts = [_prompt(int(rng.integers(4, 15)), 200 + seed * 10 + i) for i in range(6)]
    return prompts, [int(rng.integers(2, 13)) for _ in prompts]


# every prompt the file serves: the reference drains each once
PROMPTS = {
    "four": [_prompt(5 + s, 100 + s) for s in range(4)],
    "stop": [_prompt(5, 7), _prompt(9, 8)],
    "stagger": [_prompt(5, 1), _prompt(7, 2)],
    "steady": [_prompt(5 + s, 130 + s) for s in range(3)] + [_prompt(4, 140)],
    "finish": [_prompt(5, 141), _prompt(6, 142)],
    # longer than prompt_len: the chunked prefill; 8 blocks hold two of them
    "preempt": [_prompt(20 + 3 * s, 150 + s) for s in range(4)],
    **{f"schedule{s}": _schedule_prompts(s)[0] for s in range(3)},
}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The models here are tiny: two intra-op threads leave the cores to
    the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """(JAX params, the port's TransformerLM with the same weights)."""
    jp = jtfm.init_params(jax.random.PRNGKey(7), vocab=VOCAB, d_model=D_MODEL,
                          n_heads=N_HEADS, n_layers=N_LAYERS, n_kv_heads=N_KV)
    lm = ttfm.TransformerLM(VOCAB, D_MODEL, N_HEADS, N_LAYERS, n_kv_heads=N_KV)
    lm.load_state_dict(transformer_from_jax(jax.tree_util.tree_map(np.asarray, jp)))
    return jp, lm


def _drain_steps(cb, rids, step="step"):
    while any(cb.result(r) is None for r in rids):
        getattr(cb, step)()
    return [list(cb.result(r)) for r in rids]


def _drain_pump(cb, rids, n, pump="step_pump"):
    while any(cb.result(r) is None for r in rids):
        getattr(cb, pump)(n)
    return [list(cb.result(r)) for r in rids]


@pytest.fixture(scope="module")
def reference(models):
    """ref(layout, cache_dtype) → {group: [greedy stream of REF_BUDGET
    tokens, one a prompt]}: the JAX batcher of that layout and cache dtype,
    built once, per-token steps, every prompt of PROMPTS."""
    jp, _ = models
    memo = {}

    def ref(layout="slot", cache_dtype="auto"):
        if (layout, cache_dtype) not in memo:
            cb = jsv.ContinuousBatcher(jp, N_HEADS, n_slots=N_SLOTS, max_len=MAX_LEN,
                                       prompt_len=PROMPT_LEN, attn_impl="pallas",
                                       cache_dtype=cache_dtype, **LAYOUTS[layout])
            out = {}
            for group, prompts in PROMPTS.items():
                rids = []
                for p in prompts:
                    while (rid := cb.submit(p, REF_BUDGET)) is None:
                        cb.step()
                    rids.append(rid)
                out[group] = _drain_steps(cb, rids)
            memo[layout, cache_dtype] = out
        return memo[layout, cache_dtype]

    return ref


def _port(lm, layout, **kw):
    return tsv.ContinuousBatcher(lm, N_HEADS, n_slots=N_SLOTS, max_len=MAX_LEN,
                                 prompt_len=PROMPT_LEN, device="cpu",
                                 **{"attn_impl": "pallas", **LAYOUTS[layout], **kw})


def test_reference_streams_are_not_near_ties(models, reference):
    """Every reference token's top-2 margin in the JAX no-cache logits is
    above MARGIN, and the token is their argmax; the paged reference's
    streams are the slot reference's."""
    jp, _ = models
    fwd = jax.jit(lambda toks: jtfm.apply(jp, toks, N_HEADS))
    slot = reference("slot")
    for group, prompts in PROMPTS.items():
        for p, toks in zip(prompts, slot[group]):
            seq = np.zeros((1, MAX_LEN), np.int32)
            seq[0, : len(p) + len(toks) - 1] = np.concatenate([p, toks[:-1]])
            logits = np.asarray(fwd(jnp.asarray(seq)))[0, len(p) - 1: len(p) + len(toks) - 1]
            top2 = np.sort(logits, axis=-1)[:, -2:]
            assert (top2[:, 1] - top2[:, 0]).min() > MARGIN
            assert logits.argmax(-1).tolist() == toks
    assert reference("paged") == slot


@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_pump_equals_steps_and_reference(models, reference, layout, n):
    """A pump of n is n per-token steps: the same tokens, and the JAX
    batcher's greedy tokens."""
    _, lm = models
    a, b = _port(lm, layout), _port(lm, layout)
    prompts = PROMPTS["four"]
    steps = _drain_steps(a, [a.submit(p, 9) for p in prompts])
    pumped = _drain_pump(b, [b.submit(p, 9) for p in prompts], n)
    assert pumped == steps == [t[:9] for t in reference(layout)["four"]]
    assert b.stats()["steps"] % n == 0


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_stop_token_idles_its_slot_on_the_device(models, reference, layout):
    """The stop token ends a stream inside the program: its lane goes idle
    on the device in the pump that emits it, while a neighbour decodes on;
    the tokens after it in that pump are dropped."""
    _, lm = models
    want, other = reference(layout)["stop"]
    stop = want[2]
    cut = want[: want.index(stop) + 1]
    cb = _port(lm, layout)
    r0 = cb.submit(PROMPTS["stop"][0], 12, stop_token=stop)
    r1 = cb.submit(PROMPTS["stop"][1], 30)
    cb.step_pump(1)  # admits both (the first token is the prefill's)
    got = cb.step_pump(8)
    assert cb.result(r0) == cut and got[r0][-1] == stop
    assert not bool(cb._active_dev[0]) and bool(cb._active_dev[1])
    assert len(got[r1]) == 8
    assert _drain_pump(cb, [r1], 8) == [other[:30]]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_staggered_admissions_join_the_next_pump(models, reference, layout):
    _, lm = models
    p0, p1 = PROMPTS["stagger"]
    a, b = _port(lm, layout), _port(lm, layout)
    ra0, rb0 = a.submit(p0, 10), b.submit(p0, 10)
    for _ in range(2):
        a.step()
    b.step_pump(2)
    ra1, rb1 = a.submit(p1, 6), b.submit(p1, 6)
    steps = _drain_steps(a, [ra0, ra1])
    assert _drain_pump(b, [rb0, rb1], 4) == steps
    want = reference(layout)["stagger"]
    assert steps == [want[0][:10], want[1][:6]]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_int8_cache_pump_equals_steps_and_reference(models, reference, layout):
    """Quantization happens inside the program as inside the step: the
    int8 pump equals the int8 per-token steps and the JAX int8 batcher."""
    _, lm = models
    a, b = _port(lm, layout, cache_dtype="int8"), _port(lm, layout, cache_dtype="int8")
    prompts = PROMPTS["four"]
    steps = _drain_steps(a, [a.submit(p, 9) for p in prompts])
    assert _drain_pump(b, [b.submit(p, 9) for p in prompts], 8) == steps
    assert steps == [t[:9] for t in reference(layout, "int8")["four"]]


def _buffers(cb):
    names = ["_tok", "_pos", "_active_dev", "_budget_dev", "_stop_dev", "_temp", "_topk",
             "_topp", "_keys"] + (["_tables_dev"] if cb._paged else [])
    return {name: getattr(cb, name).data_ptr() for name in names}


def _settle(cb):
    """Pumps of one until every claimed slot decodes: the paged layout
    prefills and admits one request a pump."""
    while any(r is not None and not cb._active[s] for s, r in enumerate(cb._slots)):
        cb.step_pump(1)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_steady_pumps_ship_no_host_state(models, reference, layout):
    """The budget / stop / active state is carried on the device between
    pumps: steady pumps rebuild it zero times; a submit, a finish and a
    per-token step each cost exactly one rebuild at the next pump. The
    state buffers and the table buffer keep their addresses, and the
    streams stay the reference's."""
    _, lm = models
    want = reference(layout)["steady"]
    b = _port(lm, layout)
    addrs = _buffers(b)
    prompts = PROMPTS["steady"]
    rids = [b.submit(p, 40) for p in prompts[:3]]
    _settle(b)
    builds = b._host_state_builds
    assert builds >= 1 and b.stats()["host_state_builds"] == builds
    for _ in range(3):
        b.step_pump(4)
    assert b._host_state_builds == builds
    rids.append(b.submit(prompts[3], 30))  # admission: one rebuild
    b.step_pump(4)
    assert b._host_state_builds == builds + 1
    b.step_pump(4)
    assert b._host_state_builds == builds + 1
    b.step()  # a per-token step: one rebuild at the next pump
    b.step_pump(4)
    assert b._host_state_builds == builds + 2
    b.step_pump(4)
    assert b._host_state_builds == builds + 2
    assert _drain_pump(b, rids, 4) == [t[:40] for t in want[:3]] + [want[3][:30]]
    assert _buffers(b) == addrs
    # a finishing request: one rebuild at the next pump
    fin, want = PROMPTS["finish"], reference(layout)["finish"]
    b2 = _port(lm, layout)
    addrs2 = _buffers(b2)
    r2 = [b2.submit(fin[0], 10), b2.submit(fin[1], 40)]
    _settle(b2)
    n = b2._host_state_builds
    while b2.result(r2[0]) is None:
        assert b2._host_state_builds == n
        b2.step_pump(4)
    # its budget ran out inside the pump: the lane idled on the device, from
    # the budget carried over the steady pumps before
    assert not bool(b2._active_dev[0]) and bool(b2._active_dev[1])
    assert b2._host_state_builds == n
    b2.step_pump(4)
    assert b2._host_state_builds == n + 1
    b2.step_pump(4)
    assert b2._host_state_builds == n + 1
    assert _drain_pump(b2, r2, 4) == [want[0][:10], want[1][:40]]
    assert _buffers(b2) == addrs2


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_random_schedules_equal_reference(models, reference, layout, seed):
    """Whatever interleaving of step / step_pump(n) drains the batch, with
    staggered random submissions between them, every stream is the
    reference's per-token stream."""
    _, lm = models
    rng = np.random.default_rng(seed)
    prompts, budgets = _schedule_prompts(seed)
    cb = _port(lm, layout)
    rids = []

    def submit_some(k):
        for _ in range(k):
            if len(rids) < len(prompts):
                rid = cb.submit(prompts[len(rids)], budgets[len(rids)])
                if rid is None:
                    break
                rids.append(rid)

    submit_some(2)
    while len(rids) < len(prompts) or any(cb.result(r) is None for r in rids):
        if rng.integers(0, 2):
            cb.step()
        else:
            cb.step_pump(int(rng.integers(1, 7)))
        submit_some(int(rng.integers(0, 3)))
    want = reference(layout)[f"schedule{seed}"]
    assert [list(cb.result(r)) for r in rids] == [w[:n] for w, n in zip(want, budgets)]


def test_paged_preemption_between_pumps_equals_reference(models, reference):
    """A pool of 8 blocks under four 20-29-token prompts with 40 new tokens
    each: growth before a pump preempts, the victim re-prefills, its lane
    idles meanwhile, and every stream is still the reference's."""
    _, lm = models
    cb = _port(lm, "paged", kv_blocks=8)
    addrs = _buffers(cb)
    rids = [cb.submit(p, REF_BUDGET) for p in PROMPTS["preempt"]]
    assert _drain_pump(cb, rids, 4) == reference("paged")["preempt"]
    st = cb.stats()
    assert st["kv_preemptions"] > 0 and st["kv_blocks_in_use"] == 0
    assert _buffers(cb) == addrs


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_one_program_per_key_over_a_drain(models, reference, layout):
    """A drain of steps and pumps of 2 and 4 fills one program per key,
    each once, and every later run reuses it; a sampling request adds the
    sampling key. On the CPU no program is captured. The eager oracle
    fills none and gives the same tokens."""
    _, lm = models
    cb = _port(lm, layout)
    prompts = PROMPTS["four"]
    rids = [cb.submit(p, 12) for p in prompts]
    cb.step()
    cb.step_pump(2)
    progs = dict(cb._programs)
    for _ in range(3):
        cb.step_pump(4)
        cb.step()
    cb.step_pump(2)
    assert set(cb._programs) == {(1, False), (2, False), (4, False)}
    assert all(cb._programs[k] is p for k, p in progs.items())
    toks = _drain_pump(cb, rids, 4)
    assert toks == [t[:12] for t in reference(layout)["four"]]
    st = cb.stats()
    assert st["programs_filled"] == 3 and len(cb._programs) == 3
    name = "slot" if layout == "slot" else "paged-block"
    assert sorted(st["programs"]) == [f"{name}/n{n}/greedy/float32/pallas" for n in (1, 2, 4)]
    assert not any(p["captured"] for p in st["programs"].values())
    assert st["build_s"] == 0.0
    cb.submit(prompts[0], 5, temperature=0.8, seed=3)
    cb.step_pump(4)
    assert (4, True) in cb._programs and cb.stats()["programs_filled"] == 4
    # the oracle: the body run as it is, no program filled
    oracle = _port(lm, layout)
    o_rids = [oracle.submit(p, 12) for p in prompts]
    oracle.step_eager()
    assert _drain_pump(oracle, o_rids, 4, pump="step_pump_eager") == toks
    assert oracle.stats()["programs_filled"] == 0


def test_gather_oracle_goes_through_the_programs(models, reference):
    """kv_attn="gather" (the view oracle) runs its gather and scatter
    inside the same pump programs, and equals the block-native path and
    the reference; it counts one gather dispatch a step or pump."""
    _, lm = models
    prompts = PROMPTS["four"]
    streams = {}
    for kv_attn in ("gather", "block"):
        cb = _port(lm, "paged", attn_impl="xla", kv_attn=kv_attn)
        rids = [cb.submit(p, 9) for p in prompts]
        cb.step()
        runs = 1
        while any(cb.result(r) is None for r in rids):
            cb.step_pump(4)
            runs += 1
        streams[kv_attn] = [list(cb.result(r)) for r in rids]
        assert set(cb._programs) == {(1, False), (4, False)}
        assert cb.stats()["kv_gather_dispatches"] == (runs if kv_attn == "gather" else 0)
    assert streams["gather"] == streams["block"] == [t[:9] for t in reference("paged")["four"]]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_sampling_pump_equals_steps(models, layout):
    """Sampling slots are keyed by (seed, position): a pumped sampled
    stream equals the per-token one, and a top-k of one is greedy."""
    _, lm = models
    p = PROMPTS["four"][0]
    kw = dict(temperature=0.8, top_k=40, seed=5)
    a, b = _port(lm, layout), _port(lm, layout)
    steps = _drain_steps(a, [a.submit(p, 12, **kw)])
    assert _drain_pump(b, [b.submit(p, 12, **kw)], 8) == steps
    c = _port(lm, layout)
    greedy = _drain_pump(c, [c.submit(p, 12, temperature=0.8, top_k=1, seed=5)], 8)
    d = _port(lm, layout)
    assert greedy == _drain_pump(d, [d.submit(p, 12)], 8) != steps


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_sampled_stream_alone_equals_in_a_full_batch(models, layout):
    """A request's sampled stream depends only on its seed and positions:
    alone in the batcher, or beside three others (sampling and greedy,
    joined at other times), its tokens are the same."""
    _, lm = models
    p = PROMPTS["steady"][0]
    kw = dict(temperature=1.1, top_p=0.9, seed=11)
    alone = _port(lm, layout)
    want = _drain_pump(alone, [alone.submit(p, 20, **kw)], 4)
    cb = _port(lm, layout)
    others = [cb.submit(PROMPTS["four"][0], 30, temperature=0.7, seed=2),
              cb.submit(PROMPTS["four"][1], 30)]
    cb.step_pump(3)
    rid = cb.submit(p, 20, **kw)
    others.append(cb.submit(PROMPTS["four"][2], 30, temperature=1.3, top_k=9, seed=11))
    assert _drain_pump(cb, [rid] + others, 5)[0] == want[0]


CHI2_DRAWS = 24000
CHI2_QUANTILE = 0.999


@pytest.mark.parametrize("temp,top_k,top_p", [(1.0, 0, 1.0), (0.7, 5, 1.0), (1.3, 0, 0.8)])
def test_sampler_frequencies_match_the_filtered_softmax(temp, top_k, top_p):
    """24 000 draws from a fixed 8-way distribution, keyed by 8 seeds ×
    3000 positions: the category counts against softmax(_filtered_logits)
    by a chi-square test at the 0.999 quantile; categories the filter
    removes are never drawn."""
    logits = torch.log(torch.tensor([0.30, 0.20, 0.15, 0.12, 0.09, 0.07, 0.05, 0.02]))
    n = CHI2_DRAWS
    rows = logits.repeat(n, 1)
    temp_t = torch.full((n,), temp)
    topk_t = torch.full((n,), top_k, dtype=torch.int32)
    topp_t = torch.full((n,), top_p)
    keys = torch.tensor([tsv.seed_key(s) for s in range(8)], dtype=torch.int64).repeat(n // 8)
    pos = torch.arange(n, dtype=torch.int32) // 8
    toks = tsv.sample_tokens(rows, temp_t, topk_t, topp_t, keys, pos)
    counts = np.bincount(toks.numpy(), minlength=8)
    probs = torch.softmax(tsv._filtered_logits(rows[:1], temp_t[:1], topk_t[:1], topp_t[:1]),
                          dim=-1)[0].numpy().astype(np.float64)
    live = probs > 0
    assert counts[~live].sum() == 0
    expected = probs[live] * n
    chi2 = float(((counts[live] - expected) ** 2 / expected).sum())
    assert chi2 < sstats.chi2.ppf(CHI2_QUANTILE, int(live.sum()) - 1), (chi2, counts)


def test_gumbel_noise_is_keyed_by_seed_position_and_index_only():
    """The noise of (key, position, index) is the same in any batch and at
    any batch row; other keys or positions give other noise."""
    keys = torch.tensor([tsv.seed_key(s) for s in (0, 1, 2**40, -3)], dtype=torch.int64)
    pos = torch.tensor([0, 7, 7, 4095], dtype=torch.int32)
    full = tsv.gumbel_noise(keys, pos, 50)
    for i in range(4):
        assert torch.equal(tsv.gumbel_noise(keys[i:i + 1], pos[i:i + 1], 50)[0], full[i])
    assert torch.equal(tsv.gumbel_noise(keys.flip(0), pos.flip(0), 50), full.flip(0))
    assert torch.isfinite(full).all()
    assert not torch.equal(full[1], full[2]) and not torch.equal(
        full[0], tsv.gumbel_noise(keys[:1], pos[:1] + 1, 50)[0])
    assert len({tsv.seed_key(s) for s in range(1000)}) == 1000
    assert all(0 <= tsv.seed_key(s) < 2**32 for s in (0, -1, 2**70))


def _unmix32(x: int) -> int:
    """The inverse of ``tsv._mix32`` on one Python int."""

    def unshift(y: int, s: int) -> int:
        out, k = y, s
        while k < 32:
            out ^= y >> k
            k += s
        return out

    x = unshift(x, 16)
    x = (x * pow(0x846CA68B, -1, 2**32)) % 2**32
    x = unshift(x, 15)
    x = (x * pow(0x7FEB352D, -1, 2**32)) % 2**32
    return unshift(x, 16)


def _key_hashing_to(h: int, pos: int, col: int) -> int:
    """A sampler key whose (key, pos, col) noise hash is ``h``: the hash
    is a bijection of row + col, and the row of (mix(key) ^ pos)."""
    row = (_unmix32(_unmix32(h)) - col) % 2**32
    return _unmix32(_unmix32(row) ^ pos)


@pytest.mark.parametrize("h", [0, 1, 0x1FF, 0x200, 0x7FFFFFFF, 0xFFFFFE00, 0xFFFFFEFF, 0xFFFFFFFF])
def test_gumbel_noise_is_finite_at_every_hash(h):
    """The hash → noise map at the ends of its range: u stays inside
    (0, 1) in float32, so neither log reaches 0 or infinity, and the
    noise rises with the hash."""
    hs = torch.tensor([h, max(h - 0x200, 0)], dtype=torch.int64)
    noise = tsv._gumbel_of_hash(hs)
    assert torch.isfinite(noise).all(), (h, noise)
    assert noise[0] >= noise[1]
    x = torch.tensor([12345, 0, 2**32 - 1], dtype=torch.int64)
    assert [_unmix32(int(v)) for v in tsv._mix32(x)] == x.tolist()


@pytest.mark.parametrize("top_k,top_p", [(1, 1.0), (1, 0.5), (0, 1e-6)])
def test_a_one_token_filter_is_greedy_where_the_noise_is_largest(top_k, top_p):
    """A sampling slot whose filter keeps one token (top_k=1, or a tiny
    nucleus) takes the greedy token even at the (key, position, index)
    whose hash is the largest 32-bit value: there the noise is at its
    maximum and still finite, so a filtered-out index (-inf + noise)
    never wins, and a kept one wins only when it is the greedy one."""
    vocab, pos, col = 64, 5, 17
    key = _key_hashing_to(0xFFFFFFFF, pos, col)
    keys = torch.tensor([key, key], dtype=torch.int64)
    poss = torch.tensor([pos, pos], dtype=torch.int32)
    noise = tsv.gumbel_noise(keys, poss, vocab)
    top = tsv._gumbel_of_hash(torch.tensor([0xFFFFFFFF], dtype=torch.int64))[0]
    assert torch.isfinite(noise).all() and int(noise[0].argmax()) == col
    assert torch.equal(noise[0, col], top)
    logits = torch.from_numpy(np.random.default_rng(3).normal(size=(2, vocab)).astype(np.float32))
    logits[0, col] = logits[0].min() - 1.0  # row 0: the largest noise on a filtered index
    logits[1, col] = logits[1].max() + 1.0  # row 1: ... on the greedy one
    toks = tsv.sample_tokens(logits, torch.full((2,), 0.8),
                             torch.full((2,), top_k, dtype=torch.int32),
                             torch.full((2,), top_p), keys, poss)
    assert toks.tolist() == logits.argmax(dim=-1).tolist()
    assert int(toks[1]) == col
