"""Port parity for the sliding-window ring of the serving engine
(``windowed=True``): ``decode.windowed_chunk``, the ring's decode step and
pumps (``models/serving.py``), windowed admission and prefixes, and the
ring's speculation (``models/serving_spec.py``: ``batched_windowed_verify``,
``commit_ring_chunk``, ``draft_windowed_propose``, the ring history),
against the JAX package on the CPU with numpy-seeded prompts and the JAX
weights carried over with ``transformer_from_jax``. The cases of
``tests/test_serving.py``'s ``TestSlidingWindow``, its windowed chunked
prefill and windowed prefix cases, and the windowed cases of
``tests/test_speculative.py``; beside them the ring's pumps against the
JAX ring batcher.

Tolerances:

- Greedy token ids: identical. The ground truth is the JAX package's
  exact sliding-window stream: its batched decode step on an unbounded
  cache with a banded mask, token by token (``sliding``). Every such
  stream's top-2 margin is asserted above 1e-4
  (``test_sliding_streams_are_not_near_ties``), so a flip would be a
  fault. Acceptance counters equal the JAX batcher's where both mine
  the same history (the spec pumps, the drafts).
- The ring helpers' logits and K/V: within 1e-4 of max |value| (float32,
  two summation orders); masks, histories, proposals and commits of the
  same values: exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nnstreamer_tpu.models import decode as jdec
from nnstreamer_tpu.models import serving as jsv
from nnstreamer_tpu.models import transformer as jtfm
from nnstreamer_tpu_torch.models import decode as tdec
from nnstreamer_tpu_torch.models import serving as tsv
from nnstreamer_tpu_torch.models import serving_spec as tspec
from nnstreamer_tpu_torch.models.serving_state import leaves
from nnstreamer_tpu_torch.models import transformer as ttfm
from nnstreamer_tpu_torch.models.jax_weights import transformer_from_jax

VOCAB, D_MODEL, N_HEADS, N_KV, N_LAYERS = 257, 64, 4, 2, 2
DRAFT = dict(d_model=32, n_heads=2, n_layers=1)
MARGIN = 1e-4
TOL = 1e-4
SLIDE_LEN = 128  # the unbounded cache of the sliding-window ground truth


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(1, VOCAB, (n,)).astype(np.int32)


PATTERN = np.asarray([7, 8, 9, 7, 8, 9, 7, 8, 9, 7], np.int32)
PFX16, TAIL6 = _prompt(16, 330), _prompt(6, 331)
PFX48, TAIL5 = _prompt(48, 332), _prompt(5, 333)
PUMP_PROMPTS = [_prompt(5, 100), _prompt(11, 101), _prompt(20, 102),
                np.tile(np.asarray([11, 12, 13], np.int32), 14)]

# (prompt, new tokens, window) of every stream held to the ground truth
CASES = {
    "wrap16": (_prompt(10, 72), 40, 16),
    **{f"chunk{n}": (_prompt(n, 91 + n), 6, 32) for n in (20, 32, 50)},
    "pfx_concat": (np.concatenate([PFX16, TAIL6]), 30, 32),
    "pfx_long": (np.concatenate([PFX48, TAIL5]), 8, 32),
    "spec16": (PATTERN, 30, 16),
    "self_draft": (_prompt(4, 32), 24, 16),
    **{f"pump{i}": (p, 40, 32) for i, p in enumerate(PUMP_PROMPTS)},
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
    """(JAX target, port target, JAX draft, port draft): a grouped-query
    target (KV 2 of 4 heads) and a smaller draft seeded apart."""
    jp = jtfm.init_params(jax.random.PRNGKey(7), vocab=VOCAB, d_model=D_MODEL, n_heads=N_HEADS,
                          n_layers=N_LAYERS, n_kv_heads=N_KV)
    jd = jtfm.init_params(jax.random.PRNGKey(34), vocab=VOCAB, **DRAFT)
    return (jp, _lm(jp, D_MODEL, N_HEADS, N_LAYERS, N_KV), jd,
            _lm(jd, DRAFT["d_model"], DRAFT["n_heads"], DRAFT["n_layers"], DRAFT["n_heads"]))


@pytest.fixture(scope="module")
def sliding(models):
    """{case: (greedy tokens, each one's top-2 logit margin)} under
    exact sliding-window attention: the JAX batched decode step on an
    unbounded cache whose attention is masked to the last W positions,
    token by token (prompt ingestion included); one program for every W."""
    jp = models[0]
    kv, hd = N_KV, D_MODEL // N_HEADS

    def attn(q, ck, cv, pos, w):
        idx = jnp.arange(ck.shape[1])[None, :]
        mask = (idx <= pos[:, None]) & (idx > pos[:, None] - w)
        return jtfm.cache_attention(q, ck, cv, mask[:, None, :])

    step = jax.jit(lambda tok, pos, cache, w: jsv.batched_decode_step(
        jp, tok, pos, jnp.asarray([True]), cache, N_HEADS,
        attn_fn=lambda q, ck, cv, p: attn(q, ck, cv, p, w)))
    out = {}
    for name, (prompt, n_new, w) in CASES.items():
        cache = tuple(jnp.zeros((N_LAYERS, 1, SLIDE_LEN, kv, hd)) for _ in range(2))
        pos = jnp.asarray([0], jnp.int32)
        for t in prompt:
            logits, cache, pos = step(jnp.asarray([int(t)], jnp.int32), pos, cache, w)
        toks, margins = [], []
        for _ in range(n_new):
            row = np.asarray(logits[0])
            top2 = np.sort(row)[-2:]
            toks.append(int(row.argmax()))
            margins.append(float(top2[1] - top2[0]))
            logits, cache, pos = step(jnp.asarray([toks[-1]], jnp.int32), pos, cache, w)
        out[name] = (toks, margins)
    return out


def test_sliding_streams_are_not_near_ties(sliding):
    for name, (toks, margins) in sliding.items():
        assert len(toks) == CASES[name][1]
        assert min(margins) > MARGIN, name


def _port(lm, w, **kw):
    return tsv.ContinuousBatcher(lm, N_HEADS, **{"n_slots": 2, "max_len": w, "prompt_len": 16,
                                                 "windowed": True, "device": "cpu", **kw})


def _serve(cb, prompts, budget, run, **kw):
    rids = [cb.submit(p, budget, **kw) for p in prompts]
    while any(cb.result(r) is None for r in rids):
        run(cb)
    return [list(cb.result(r)) for r in rids]


def _step(cb):
    cb.step()


def _spec_step(k=4, ngram=2):
    return lambda cb: cb.spec_step(k=k, ngram=ngram)


def _counters(st):
    return {k: st[k] for k in ("spec_rounds", "spec_accepted_tokens", "spec_columns")}


# -- the ring helpers ------------------------------------------------------------------------


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


def _ring(rng, w, kv=N_KV, hd=D_MODEL // N_HEADS, b=1):
    return rng.normal(size=(N_LAYERS, b, w, kv, hd)).astype(np.float32)


@pytest.mark.parametrize("pos,valid", [(0, 16), (16, 9), (48, 16), (80, 5)])
def test_windowed_chunk_matches_reference(models, pos, valid):
    """One chunk into a W = 32 ring at fills before and past a wrap, with a
    pad tail: the logits and the ring, against the JAX function; a chunk
    that would wrap mid-write raises."""
    jp, lm, _, _ = models
    rng = np.random.default_rng(pos)
    ring = (_ring(rng, 32), _ring(rng, 32))
    toks = rng.integers(1, VOCAB, (1, 16)).astype(np.int32)
    jl, (jk, jv), jpos = jdec.windowed_chunk(jp, jnp.asarray(toks), pos, valid,
                                              tuple(map(jnp.asarray, ring)), N_HEADS)
    with torch.no_grad():
        tring = tuple(torch.from_numpy(r.copy()) for r in ring)
        tl, (tk, tv), tpos = tdec.windowed_chunk(lm, torch.from_numpy(toks).long(), pos, valid,
                                                 tring, N_HEADS)
    assert tpos == int(jpos) == pos + valid
    _close(tl[:, :valid], np.asarray(jl)[:, :valid])
    _close(tk, jk)
    _close(tv, jv)
    # the pad rows' writes are suppressed: those ring rows keep their values
    wp = pos % 32
    np.testing.assert_array_equal(tk[:, :, wp + valid:wp + 16].numpy(),
                                  ring[0][:, :, wp + valid:wp + 16])
    with pytest.raises(ValueError, match="wraps"):
        tdec.windowed_chunk(lm, torch.from_numpy(toks).long(), 24, 16, tring, N_HEADS)


@pytest.mark.parametrize("quantized", [False, True])
def test_ring_verify_commit_and_draft_match_reference(models, quantized):
    """batched_windowed_verify (logits and chunk K/V; an idle slot, per-slot
    fills before and past the wrap, -1 columns, int8), commit_ring_chunk
    (per-column wrap, n_commit, the idle gate: exact on the same chunk),
    and draft_windowed_propose (proposals exact, chunk K/V close)."""
    jp, lm, _, _ = models
    rng = np.random.default_rng(5)
    W, b, k = 16, 3, 4
    pos = np.asarray([5, 14, 37], np.int32)  # slot 1's chunk crosses the ring's end
    active = np.asarray([True, True, False])
    toks = rng.integers(1, VOCAB, (b, k)).astype(np.int32)
    toks[0, 2:] = -1
    ring = (_ring(rng, W, b=b), _ring(rng, W, b=b))
    if quantized:
        jcache = tuple(jsv.quantize_kv(jnp.asarray(r)) for r in ring)
        tcache = tuple(tuple(torch.from_numpy(np.asarray(x).copy()) for x in c) for c in jcache)
    else:
        jcache = tuple(map(jnp.asarray, ring))
        tcache = tuple(torch.from_numpy(r.copy()) for r in ring)
    jl, jck, jcv = jsv.batched_windowed_verify(jp, jnp.asarray(toks), jnp.asarray(pos),
                                               jnp.asarray(active), jcache, N_HEADS)
    with torch.no_grad():
        tl, tck, tcv = tspec.batched_windowed_verify(
            lm, torch.from_numpy(toks), torch.from_numpy(pos),
            torch.from_numpy(active), tcache, N_HEADS)
    _close(tl, jl)
    _close(tck, jck)
    _close(tcv, jcv)
    m = np.asarray([2, 4, 3], np.int32)
    jout = jsv.commit_ring_chunk(jcache, jck, jcv, jnp.asarray(pos), jnp.asarray(m),
                                 jnp.asarray(active))
    tspec.commit_ring_chunk(tcache, torch.from_numpy(np.array(jck)),
                            torch.from_numpy(np.array(jcv)), torch.from_numpy(pos),
                            torch.from_numpy(m), torch.from_numpy(active))
    for got, want in zip(leaves(tcache), jax.tree_util.tree_leaves(jout)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if not quantized:
        tok = np.asarray([3, 9, 11], np.int32)
        jprops, jdk, jdv = jsv.draft_windowed_propose(jp, jnp.asarray(tok), jnp.asarray(pos),
                                                      jcache, N_HEADS, k)
        with torch.no_grad():  # the ring before the commit above
            tprops, tdk, tdv = tspec.draft_windowed_propose(
                lm, torch.from_numpy(tok), torch.from_numpy(pos),
                tuple(torch.from_numpy(r.copy()) for r in ring), N_HEADS, k)
        np.testing.assert_array_equal(tprops.numpy(), np.asarray(jprops))
        _close(tdk, jdk)
        _close(tdv, jdv)


def test_ring_history_ops_match_reference():
    """hist_write_row(wrap=True) across the ring's end, device_ngram_propose
    on a wrapped ring history, spec_emit_hist's ring write and the ring
    liveness mask: exact against the JAX functions."""
    rng = np.random.default_rng(3)
    H, b = 12, 4
    hist = rng.integers(1, 6, (b, H)).astype(np.int32)
    hist[1, 7:] = -1
    pos = np.asarray([5, 6, 20, 35], np.int32)
    row = rng.integers(1, 6, (b, 4)).astype(np.int32)
    count = np.asarray([4, 2, 3, 0], np.int32)
    want = np.asarray(jsv.hist_write_row(jnp.asarray(hist), jnp.asarray(row), jnp.asarray(pos),
                                         jnp.asarray(count), wrap=True))
    got = torch.from_numpy(hist.copy())
    tspec.hist_write_row(got, torch.from_numpy(row), torch.from_numpy(pos),
                         torch.from_numpy(count), wrap=True)
    np.testing.assert_array_equal(got.numpy(), want)
    for k, g in ((4, 1), (3, 2), (5, 3)):
        jprop = jsv.device_ngram_propose(jnp.asarray(want), jnp.asarray(pos), k, g, wrap=True)
        tprop = tspec.device_ngram_propose(got, torch.from_numpy(pos), k, g, wrap=True)
        np.testing.assert_array_equal(tprop.numpy(), np.asarray(jprop))
    for w in (8, 16):
        rows = np.arange(4, dtype=np.int32)
        jm = jsv._ring_live_mask(jnp.asarray(pos), w, jnp.asarray(rows))
        tm = tspec._ring_live_mask(torch.from_numpy(pos), w, torch.from_numpy(rows))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    toks = np.concatenate([np.full((b, 1), 9, np.int32), row[:, :3]], axis=1)
    m = np.asarray([1, 4, 2, 0], np.int32)
    final = np.asarray([4, 5, 1, 2], np.int32)
    active = np.asarray([True, True, True, False])
    jemit, jhist = jsv.spec_emit_hist(jnp.asarray(toks), jnp.asarray(m), jnp.asarray(final),
                                      jnp.asarray(active), jnp.asarray(hist), jnp.asarray(pos),
                                      True)
    thist = torch.from_numpy(hist.copy())
    temit = tspec.spec_emit_hist(torch.from_numpy(toks), torch.from_numpy(m),
                                 torch.from_numpy(final), torch.from_numpy(active), thist,
                                 torch.from_numpy(pos), True)
    np.testing.assert_array_equal(temit.numpy(), np.asarray(jemit))
    np.testing.assert_array_equal(thist.numpy(), np.asarray(jhist))


# -- TestSlidingWindow --------------------------------------------------------------------------


def test_window_large_enough_matches_plain(models):
    """No wrap: the ring serves the linear cache's tokens."""
    _, lm, _, _ = models
    prompt = _prompt(10, 70)
    outs = [_serve(tsv.ContinuousBatcher(lm, N_HEADS, n_slots=1, max_len=64, prompt_len=16,
                                         device="cpu", **kw), [prompt], 8, _step)
            for kw in ({}, {"windowed": True})]
    assert outs[0] == outs[1]


def test_generation_beyond_cache_length(models):
    """A generation far longer than the cache runs in its fixed memory,
    every token a vocabulary id, the cache's buffers never replaced."""
    _, lm, _, _ = models
    cb = _port(lm, 24, n_slots=1)
    ptrs = [t.data_ptr() for t in cb._cache]
    [toks] = _serve(cb, [_prompt(8, 71)], 60, lambda c: c.step_pump(8))
    assert len(toks) == 60 and all(0 <= t < VOCAB for t in toks)
    assert [t.data_ptr() for t in cb._cache] == ptrs
    assert cb.stats()["tokens_emitted"] == 59


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_ring_matches_sliding_mask_on_unbounded_cache(models, sliding, impl):
    """The post-wrap check: W = 16, 40 new tokens (the ring wraps three
    times), equal to the exact sliding-window stream, with the inline
    attention and with K3's plain version (its ≤ pos mask saturates)."""
    _, lm, _, _ = models
    prompt, n_new, w = CASES["wrap16"]
    got = _serve(_port(lm, w, n_slots=1, attn_impl=impl), [prompt], n_new, _step)
    assert got == [sliding["wrap16"][0]]


# -- windowed chunked prefill and prefixes -------------------------------------------------------


@pytest.mark.parametrize("plen", [20, 32, 50])  # ≤ W, = W, past W
def test_windowed_long_prompt_matches_sliding_reference(models, sliding, plen):
    _, lm, _, _ = models
    prompt, n_new, w = CASES[f"chunk{plen}"]
    got = _serve(_port(lm, w, n_slots=1), [prompt], n_new, _step)
    assert got == [sliding[f"chunk{plen}"][0]]


def test_windowed_chunk_alignment_required(models):
    """An unaligned ring serves bucket-sized prompts; a long one is refused
    before any slot is claimed."""
    _, lm, _, _ = models
    cb = _port(lm, 24, n_slots=1)
    with pytest.raises(ValueError, match="multiple of prompt_len"):
        cb.submit(_prompt(20, 95), 2)
    assert cb.n_free == 1
    assert len(_serve(cb, [_prompt(16, 96)], 30, _step)[0]) == 30


def test_windowed_prefix_validation(models):
    _, lm, _, _ = models
    cb = _port(lm, 32, n_slots=1)
    with pytest.raises(ValueError, match="multiple of prompt_len"):
        cb.register_prefix(_prompt(4, 313))
    assert cb.register_prefix(_prompt(16, 314)) is not None
    with pytest.raises(ValueError, match="multiple of prompt_len"):
        _port(lm, 24, n_slots=1).register_prefix(_prompt(16, 315))


def test_windowed_prefix_matches_concat_prompt(models, sliding):
    """A prefix starts at position 0, so its ring placement is the same for
    every request: prefix= equals the concatenated prompt on a fresh ring,
    through the wraps of the generation, and the sliding-window truth."""
    _, lm, _, _ = models
    prompt, n_new, w = CASES["pfx_concat"]
    cb = _port(lm, w)
    pid = cb.register_prefix(PFX16)
    got = _serve(cb, [TAIL6], n_new, _step, prefix=pid)
    assert got == _serve(_port(lm, w), [prompt], n_new, _step) == [sliding["pfx_concat"][0]]


def test_windowed_prefix_longer_than_window(models, sliding):
    _, lm, _, _ = models
    _, n_new, w = CASES["pfx_long"]
    cb = _port(lm, w, n_slots=1)
    pid = cb.register_prefix(PFX48)
    assert _serve(cb, [TAIL5], n_new, _step, prefix=pid) == [sliding["pfx_long"][0]]


def test_windowed_prefix_with_spec_step(models):
    """prefix × ring × speculation: the spec rounds serve a prefixed ring
    request with the plain steps' tokens, and the JAX batcher's."""
    jp, lm, _, _ = models
    pfx = np.tile(np.asarray([3, 4, 5, 6], np.int32), 4)
    tail = np.asarray([3, 4, 5], np.int32)

    def run(cb, spec):
        pid = cb.register_prefix(pfx)
        return _serve(cb, [tail], 20, _spec_step(ngram=1) if spec else _step, prefix=pid)

    want = run(jsv.ContinuousBatcher(jp, N_HEADS, n_slots=1, max_len=32, prompt_len=16,
                                     windowed=True), False)
    assert run(_port(lm, 32, n_slots=1), True) == run(_port(lm, 32, n_slots=1), False) == want


# -- windowed speculation ------------------------------------------------------------------------


def test_spec_windowed_matches_sliding_reference(models, sliding):
    """Rounds verify against the pre-write ring and commit only the
    accepted columns: the stream is the sliding-window truth through the
    wraps, with proposals accepted."""
    _, lm, _, _ = models
    prompt, n_new, w = CASES["spec16"]
    cb = _port(lm, w, n_slots=1)
    assert _serve(cb, [prompt], n_new, _spec_step()) == [sliding["spec16"][0]]
    assert cb.stats()["spec_rounds"] > 0


def test_spec_windowed_int8_matches_plain(models):
    """ring × int8 × speculation: the verify attends its own columns'
    quantize round trip, so spec rounds give the plain int8 ring's tokens,
    which are the JAX int8 ring's."""
    jp, lm, _, _ = models
    pattern = np.asarray([7, 8, 9, 7, 8, 9, 7, 8], np.int32)
    kw = dict(n_slots=1, cache_dtype="int8")
    want = _serve(jsv.ContinuousBatcher(jp, N_HEADS, max_len=32, prompt_len=16, windowed=True,
                                        **kw), [pattern], 20, _step)
    assert (_serve(_port(lm, 32, **kw), [pattern], 20, _spec_step())
            == _serve(_port(lm, 32, **kw), [pattern], 20, _step) == want)


def test_spec_accepted_in_pallas_windowed_server(models):
    """K3's ring batcher pumped by spec rounds accepts proposals on a
    repetitive stream: several tokens a round, not a silent fallback."""
    _, lm, _, _ = models
    cb = _port(lm, 32, attn_impl="pallas")
    _serve(cb, [np.tile(np.asarray([11, 12, 13], np.int32), 5)], 24, _spec_step())
    st = cb.stats()
    assert st["spec_rounds"] > 0 and st["spec_accepted_tokens"] > 0
    assert st["tokens_emitted"] > st["steps"]


def test_draft_windowed_matches_plain_ring(models):
    """A draft on a ring proposes against its pre-write ring and commits
    only the accepted columns: the plain ring's stream through many wraps,
    with the JAX draft batcher's acceptance counters; its spec_pump runs
    spec_step rounds (one rounds = 1 program), as the reference does."""
    jp, lm, jd, ld = models
    p = _prompt(6, 31)
    dkw = dict(draft_n_heads=DRAFT["n_heads"])
    jcb = jsv.ContinuousBatcher(jp, N_HEADS, n_slots=2, max_len=16, prompt_len=16,
                                windowed=True, draft_params=jd, **dkw)
    want = _serve(jcb, [p], 30, _spec_step())
    cb = _port(lm, 16, draft_params=ld, **dkw)
    assert _serve(cb, [p], 30, _spec_step()) == want == _serve(_port(lm, 16), [p], 30, _step)
    assert _counters(cb.stats()) == _counters(jcb.stats()) and cb.stats()["spec_rounds"] > 0
    pumped = _port(lm, 16, draft_params=ld, **dkw)
    assert _serve(pumped, [p], 30, lambda c: c.spec_pump(4, 4)) == want
    assert {k[:2] for k in pumped._programs if k[0] == "spec"} == {("spec", 1)}
    assert _counters(pumped.stats()) == _counters(jcb.stats())


def test_self_draft_windowed_accepts_everything(models, sliding):
    """Draft = target on a ring: every proposal accepted (the draft ring
    stays in step through the wrapped commits), and the sliding truth."""
    _, lm, _, _ = models
    prompt, n_new, w = CASES["self_draft"]
    cb = _port(lm, w, n_slots=1, draft_params=lm, draft_n_heads=N_HEADS)
    assert _serve(cb, [prompt], n_new, _spec_step()) == [sliding["self_draft"][0]]
    st = cb.stats()
    assert st["spec_accepted_tokens"] == st["spec_rounds"] * 3


def test_spec_windowed_gqa_matches_plain(models):
    """Grouped-query heads (KV 2 of 4) through the ring verify's concat
    attention: spec rounds equal plain ring steps."""
    _, lm, _, _ = models
    pattern = np.tile(np.asarray([5, 9, 11], np.int32), 4)
    assert (_serve(_port(lm, 32, n_slots=1), [pattern], 24, _spec_step(ngram=1))
            == _serve(_port(lm, 32, n_slots=1), [pattern], 24, _step))


def test_spec_windowed_int8_prefix_composes(models):
    """int8 ring × registered prefix × speculation: the plain int8 ring's
    tokens of the same prefixed request."""
    _, lm, _, _ = models
    pfx = np.tile(np.asarray([3, 4, 5, 6], np.int32), 4)

    def run(spec):
        cb = _port(lm, 32, n_slots=1, cache_dtype="int8")
        pid = cb.register_prefix(pfx)
        return _serve(cb, [np.asarray([3, 4, 5], np.int32)], 20,
                      _spec_step(ngram=1) if spec else _step, prefix=pid)

    assert run(True) == run(False)


def test_draft_windowed_int8_composes(models):
    """draft × ring × int8 target cache (the draft's ring stays float): the
    plain int8 ring's tokens."""
    _, lm, _, ld = models
    p = _prompt(5, 35)
    kw = dict(n_slots=1, cache_dtype="int8")
    got = _serve(_port(lm, 16, draft_params=ld, draft_n_heads=DRAFT["n_heads"], **kw), [p], 20,
                 _spec_step(k=3))
    assert got == _serve(_port(lm, 16, **kw), [p], 20, _step)


# -- the ring's pumps against the JAX ring batcher ----------------------------------------------


@pytest.fixture(scope="module")
def jax_ring(models):
    """The JAX ring batcher (W 32, K3) over PUMP_PROMPTS: per-token steps
    → (streams, the token history and fills after 9 steps); its
    spec_pump(2, 4, 2) → (streams, counters)."""
    jp = models[0]

    def mk():
        return jsv.ContinuousBatcher(jp, N_HEADS, n_slots=4, max_len=32, prompt_len=16,
                                     windowed=True, attn_impl="pallas")

    cb = mk()
    rids = [cb.submit(p, 40) for p in PUMP_PROMPTS]
    for _ in range(9):
        cb.step()
    mid = (np.asarray(cb._hist), np.asarray(cb._pos))
    while any(cb.result(r) is None for r in rids):
        cb.step()
    steps = [list(cb.result(r)) for r in rids]
    cb = mk()
    spec = _serve(cb, PUMP_PROMPTS, 40, lambda c: c.spec_pump(2, 4, 2))
    return steps, mid, spec, _counters(cb.stats())


def test_ring_streams_are_the_sliding_truth(sliding, jax_ring):
    assert jax_ring[0] == [sliding[f"pump{i}"][0] for i in range(len(PUMP_PROMPTS))]


@pytest.mark.parametrize("n", [1, 3, 8])
def test_ring_pumps_match_reference(models, jax_ring, n):
    """step_pump(n) on a W = 32 ring with K3 (prompts of 5-42 tokens, 40
    new ones: every slot wraps): the JAX ring batcher's greedy ids, the
    program's body against its eager oracle, and the ring token history
    and fills equal the JAX batcher's after 9 steps."""
    _, lm, _, _ = models
    kw = dict(n_slots=4, attn_impl="pallas")
    cb = _port(lm, 32, **kw)
    rids = [cb.submit(p, 40) for p in PUMP_PROMPTS]
    cb.step()  # admission, and the first token of each
    for _ in range(8 // n):
        cb.step_pump(n)
    if n != 3:
        np.testing.assert_array_equal(cb._hist.numpy(), jax_ring[1][0])
        np.testing.assert_array_equal(cb._pos.numpy(), jax_ring[1][1])
    while any(cb.result(r) is None for r in rids):
        cb.step_pump(n)
    assert [list(cb.result(r)) for r in rids] == jax_ring[0]
    assert sorted(cb._programs) == sorted({(1, False), (n, False)})
    eager = _port(lm, 32, **kw)
    assert _serve(eager, PUMP_PROMPTS, 40, lambda c: c.step_pump_eager(n)) == jax_ring[0]
    assert not eager._programs


def test_ring_spec_pump_matches_reference(models, jax_ring):
    """spec_pump(2, 4, 2) on the ring (n-gram proposals from the ring
    history, no room clamp): the JAX ring spec pump's tokens and
    acceptance counters; the eager oracle equal."""
    _, lm, _, _ = models
    for run in (lambda c: c.spec_pump(2, 4, 2), lambda c: c.spec_pump_eager(2, 4, 2)):
        cb = _port(lm, 32, n_slots=4, attn_impl="pallas")
        assert _serve(cb, PUMP_PROMPTS, 40, run) == jax_ring[2] == jax_ring[0]
        assert _counters(cb.stats()) == jax_ring[3]
    assert jax_ring[3]["spec_accepted_tokens"] > 0
