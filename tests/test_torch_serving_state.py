"""Port parity for the serving engine's state: ``snapshot`` / ``restore`` on
the slot layout, the paged layout and the windowed ring
(``models/serving_state.py``), the KV-span codec (``kv/migrate.py``),
``extract_request`` / ``adopt_request`` / ``resume_from_span``, and the
serving element's span checkpoints and drain (``elements/llm_serve.py``),
against the JAX package on the CPU with numpy-seeded prompts and the JAX
weights carried over with ``transformer_from_jax``. The cases of
``tests/test_kv_migrate.py`` (less the two that read the obs registry and
the SLO ledger, which are not ported), ``tests/test_kv_paged.py::
test_snapshot_restore_block_tables`` and ``tests/test_llm_migrate_element.py``'s
``test_migration_props_need_paged_layout`` and
``test_checkpoint_crash_restart_resumes_bitwise``; beside them the wire
bytes of both packages and spans crossing between them.

Tolerances:

- Greedy token ids: identical. Every reference stream's top-2 margin in
  the JAX no-cache logits is asserted above 1e-4
  (``test_reference_streams_are_not_near_ties``), so a flip would be a
  fault. Restored, adopted and resumed streams equal the uninterrupted
  ones bit for bit, greedy and sampled, within one package; across the
  packages greedy streams equal the source's.
- Span bytes: identical across the packages for the same span.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nnstreamer_tpu.kv import migrate as jmig
from nnstreamer_tpu.models import decode as jdec
from nnstreamer_tpu.models import serving as jsv
from nnstreamer_tpu.models import transformer as jtfm
from nnstreamer_tpu_torch.kv import migrate as tmig
from nnstreamer_tpu_torch.kv.blocks import PoolCapacityError
from nnstreamer_tpu_torch.kv.migrate import (
    BlockRecord,
    RequestSpan,
    SpanCapacityError,
    SpanCorruptError,
    SpanFormatError,
    SpanPayloadMissingError,
    SpanStateError,
    block_crc,
    decode_span,
    encode_span,
)
from nnstreamer_tpu_torch.models import serving as tsv
from nnstreamer_tpu_torch.models import serving_state as tstate
from nnstreamer_tpu_torch.models import transformer as ttfm
from nnstreamer_tpu_torch.models.jax_weights import transformer_from_jax
from nnstreamer_tpu_torch.tensors.frame import Frame

VOCAB, D_MODEL, N_HEADS, N_LAYERS = 211, 32, 2, 1
MARGIN = 1e-4
PAGED = dict(kv_layout="paged", block_size=16)


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(1, VOCAB, (n,)).astype(np.int32)


# every (prompt, budget) whose JAX greedy stream a test holds the port to
STREAMS = {
    "fp": (_prompt(21, 1), 9), "int8": (_prompt(18, 2), 8), "warm": (_prompt(37, 3), 8),
    "resume": (_prompt(19, 4), 9), "snap0": (_prompt(20, 83), 10), "snap1": (_prompt(9, 81), 10),
    "snap2": (_prompt(33, 82), 10), "elem": (_prompt(6, 11), 10),
}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """(JAX params, the port's TransformerLM with the same weights)."""
    jp = jtfm.init_params(jax.random.PRNGKey(11), vocab=VOCAB, d_model=D_MODEL, n_heads=N_HEADS,
                          n_layers=N_LAYERS)
    lm = ttfm.TransformerLM(VOCAB, D_MODEL, N_HEADS, N_LAYERS, n_kv_heads=N_HEADS)
    lm.load_state_dict(transformer_from_jax(jax.tree_util.tree_map(np.asarray, jp)))
    return jp, lm


@pytest.fixture(scope="module")
def reference(models):
    """{name: the JAX package's greedy stream of STREAMS[name]}."""
    jp = models[0]
    return {name: np.asarray(jdec.generate(jp, jnp.asarray(p)[None], N_HEADS, n))[0].tolist()
            for name, (p, n) in STREAMS.items()}


def test_reference_streams_are_not_near_ties(models, reference):
    jp = models[0]
    for name, (p, n) in STREAMS.items():
        toks = reference[name]
        seq = jnp.asarray(np.concatenate([p, np.asarray(toks[:-1], np.int32)])[None])
        logits = np.asarray(jtfm.apply(jp, seq, N_HEADS))[0, len(p) - 1:]
        top2 = np.sort(logits, axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > MARGIN, name
        assert logits.argmax(-1).tolist() == toks


def _mk(lm, **kw):
    return tsv.ContinuousBatcher(lm, N_HEADS, device="cpu",
                                 **{"n_slots": 2, "max_len": 64, "prompt_len": 16, **PAGED,
                                    **kw})


def _jmk(jp, **kw):
    return jsv.ContinuousBatcher(jp, N_HEADS, **{"n_slots": 2, "max_len": 64, "prompt_len": 16,
                                                 **PAGED, **kw})


def _drain(cb, rids):
    while any(cb.result(r) is None for r in rids):
        cb.step_pump(1)
    return [list(cb.result(r)) for r in rids]


def _settle_prefills(cb):
    while cb.stats()["kv_prefill_queue"] > 0:
        cb.step_pump(1)


def _mid_decode(cb, prompt, budget, min_tokens=3, **kw):
    """Submit, settle the prefill, decode a few tokens: the request is
    decoding, the one state that has a span."""
    rid = cb.submit(prompt, budget, **kw)
    _settle_prefills(cb)
    while len(cb.partials([rid]).get(rid, [])) < min_tokens:
        cb.step_pump(1)
    return rid


@pytest.fixture(scope="module")
def src(models):
    return _mk(models[1])


@pytest.fixture(scope="module")
def dst(models):
    return _mk(models[1])


# -- the span codec -----------------------------------------------------------------------------


def _toy_span(mig, n_tokens=20, block_size=8, stripped=()):
    """A hand-built float span of ``mig``'s classes: 2 leaves (k, v)."""
    rng = np.random.default_rng(0)
    leaves = [("float32", (2, block_size, 1, 4)), ("float32", (2, block_size, 1, 4))]
    prompt = rng.integers(1, 100, (n_tokens - 3,)).astype(np.int32)
    blocks = []
    for i in range(-(-n_tokens // block_size)):
        payload = [rng.standard_normal((2, block_size, 1, 4)).astype(np.float32).tobytes()
                   for _ in leaves]
        rec = mig.BlockRecord(min(block_size, n_tokens - i * block_size),
                              mig.block_crc(payload), payload)
        blocks.append(mig.BlockRecord(rec.n_tokens, rec.crc, None) if i in stripped else rec)
    return mig.RequestSpan(
        block_size=block_size, leaves=leaves, cache_dtype="float32", rid=3, prompt=prompt,
        tokens=[7, 8, 9, 5], fill0=n_tokens - 3, budget=10, temperature=0.0, top_k=0,
        top_p=1.0, stop_token=None, key=np.asarray([1, 2], np.uint32), deadline_s=1.5,
        preemptions=1, prefix_hashes=[11, 22], blocks=blocks, meta={"client_id": 4},
    )


def test_span_roundtrip():
    span = _toy_span(tmig)
    got = decode_span(encode_span(span))
    assert got.block_size == span.block_size and got.leaves == span.leaves
    assert got.tokens == span.tokens and got.fill0 == span.fill0 and got.n_kv == span.n_kv
    assert np.array_equal(got.prompt, span.prompt) and np.array_equal(got.key, span.key)
    assert got.deadline_s == span.deadline_s
    assert got.preemptions == 1 and got.prefix_hashes == [11, 22]
    assert got.meta == {"client_id": 4}
    for a, b in zip(got.blocks, span.blocks):
        assert (a.n_tokens, a.crc, a.payload) == (b.n_tokens, b.crc, b.payload)


def test_span_corruption_and_format_rejected():
    span = _toy_span(tmig)
    wire = encode_span(span)
    bad = bytearray(wire)
    bad[-1] ^= 0xFF
    with pytest.raises(SpanCorruptError, match="CRC mismatch"):
        decode_span(bytes(bad))
    with pytest.raises(SpanFormatError, match="bad magic"):
        decode_span(b"not a span at all")
    with pytest.raises(SpanFormatError, match="truncated"):
        decode_span(wire[:-5])
    with pytest.raises(SpanFormatError, match="trailing"):
        decode_span(wire + b"xx")
    with pytest.raises(SpanFormatError, match="version"):
        decode_span(encode_span(dataclasses.replace(span, version=99)))


def test_strip_shared_halves_payload_and_survives_roundtrip():
    span = _toy_span(tmig, n_tokens=20, block_size=8)  # 2 full + 1 partial
    warm = span.strip_shared(16)
    assert warm.blocks[0].payload is None and warm.blocks[1].payload is None
    assert warm.blocks[2].payload is not None  # a partial block never strips
    assert warm.payload_bytes() < span.payload_bytes()
    assert len(encode_span(warm)) < len(encode_span(span))
    got = decode_span(encode_span(warm))
    assert got.blocks[0].payload is None and got.blocks[2].payload == span.blocks[2].payload
    assert span.strip_shared(7).payload_bytes() == span.payload_bytes()


@pytest.mark.parametrize("stripped", [(), (0, 1)])
def test_span_wire_bytes_equal_across_packages(stripped):
    """The same span encodes to the same bytes in both packages (cold and
    stripped), each decodes the other's, and the tallies count them."""
    ours, theirs = _toy_span(tmig, stripped=stripped), _toy_span(jmig, stripped=stripped)
    tmig.tally.reset()
    wire = encode_span(ours)
    assert wire == jmig.encode_span(theirs)
    back = jmig.decode_span(wire)
    assert [r.payload for r in back.blocks] == [r.payload for r in ours.blocks]
    assert decode_span(jmig.encode_span(back)).prefix_hashes == [11, 22]
    assert tmig.tally.snapshot() == {"spans_out": 1, "spans_in": 1, "bytes_out": len(wire),
                                     "bytes_in": len(wire)}


def test_span_key_carries_the_seed_in_prng_key_layout():
    """The seed's two 32-bit words, high first: jax.random.PRNGKey(seed) for
    the seeds it takes without 64-bit mode (below 2**32), and a round trip
    for every 64-bit seed."""
    for seed in (0, 7, 2**31 + 9, 2**32 - 1, 2**32 + 5, 2**40 - 1):
        words = tstate.seed_words(seed)
        if seed < 2**32:
            assert words.tolist() == np.asarray(jax.random.PRNGKey(seed)).tolist()
        assert tstate.seed_of_words(words) == seed


# -- snapshot / restore ----------------------------------------------------------------------------


LAYOUT_KW = {"slot": {"kv_layout": "slot"}, "paged": {}, "ring": {"kv_layout": "slot",
                                                                  "windowed": True,
                                                                  "max_len": 32}}


def _snap_run(lm, kw, sample=False):
    """The snap prompts on a fresh batcher of ``kw``: a snapshot mid-decode
    and the uninterrupted streams after it."""
    cb = _mk(lm, n_slots=3, **kw)
    budget = 40 if kw.get("windowed") else 10
    extra = [dict(temperature=0.9, top_k=20, seed=5), {}, dict(temperature=1.1, seed=2**33)]
    rids = [cb.submit(STREAMS[f"snap{i}"][0], budget, **(extra[i] if sample else {}))
            for i in range(3)]
    for n in (1, 1, 3):
        cb.step_pump(n)
    while cb._paged and cb.stats()["kv_prefill_queue"]:
        cb.step_pump(1)
    snap = cb.snapshot()
    return rids, snap, _drain(cb, rids)


@pytest.mark.parametrize("layout", ["slot", "paged", "ring"])
def test_snapshot_restore_continues_bitwise(models, reference, layout):
    """Mid-decode snapshot → a fresh batcher → restore: the uninterrupted
    streams (the JAX package's greedy ones off the ring; the ring wraps
    here), greedy and sampled."""
    _, lm = models
    kw = LAYOUT_KW[layout]
    for sample in (False, True):
        rids, snap, want = _snap_run(lm, kw, sample)
        assert snap["layout"] == ("paged" if layout == "paged" else "slot")
        b2 = _mk(lm, n_slots=3, **kw)
        b2.restore(snap)
        assert _drain(b2, rids) == want
        if not sample and layout != "ring":
            assert want == [reference[f"snap{i}"] for i in range(3)]


def test_snapshot_restore_block_tables(models):
    """The paged snapshot carries the tables and the pool: the restored
    pool's refcounts, cached tier and prefix index equal the snapshot's,
    and resubmitting a prompt already seen hits the index."""
    _, lm = models
    prompts = [np.tile(_prompt(6, 80 + s), 4)[:20] for s in range(3)]
    cb = _mk(lm, n_slots=4, max_len=96)
    rids = [cb.submit(p, 10) for p in prompts]
    _settle_prefills(cb)
    cb.step_pump(4)
    snap = cb.snapshot()
    assert snap["layout"] == "paged" and "pool" in snap
    ref = _drain(cb, rids)
    b2 = _mk(lm, n_slots=4, max_len=96)
    b2.restore(snap)
    assert b2._pool.snapshot() == snap["pool"]
    np.testing.assert_array_equal(b2._tables, snap["tables"])
    assert _drain(b2, rids) == ref
    hits0 = b2.stats()["kv_prefix_hits"]
    _drain(b2, [b2.submit(prompts[0], 4)])
    assert b2.stats()["kv_prefix_hits"] > hits0


@pytest.mark.parametrize("layout", ["slot", "paged", "ring"])
def test_restore_into_a_batcher_that_already_ran_its_programs(models, layout):
    """A batcher that has run its pump programs takes a restore into its
    fixed buffers (the addresses its programs hold stay), ships the pump
    state once, fills no new program, and continues the snapshot's
    streams."""
    _, lm = models
    kw = LAYOUT_KW[layout]
    rids, snap, want = _snap_run(lm, kw)
    b2 = _mk(lm, n_slots=3, **kw)
    _drain(b2, [b2.submit(_prompt(12, 90), 6), b2.submit(_prompt(5, 91), 4)])
    b2.step_pump(1)
    progs = sorted(b2._programs)
    bufs = [b2._tok, b2._pos, b2._temp, b2._topk, b2._topp, b2._keys, b2._hist,
            *tstate.leaves(b2._cache)] + ([b2._tables_dev] if layout == "paged" else [])
    ptrs = [t.data_ptr() for t in bufs]
    b2.restore(snap)
    builds = b2.stats()["host_state_builds"]
    b2.step_pump(1)
    assert b2.stats()["host_state_builds"] == builds + 1
    assert [t.data_ptr() for t in bufs] == ptrs
    assert _drain(b2, rids) == want
    assert sorted(b2._programs) == progs


def test_restore_refusals_leave_the_batcher_serving(models):
    """Another layout, slot count, window or cache dtype is refused before
    anything moves; a paged snapshot with queued prefills raises."""
    _, lm = models
    _, snap, _ = _snap_run(lm, LAYOUT_KW["slot"])
    for kw, match in (({}, "layout"), ({"kv_layout": "slot", "n_slots": 2}, "geometry"),
                      ({"kv_layout": "slot", "windowed": True}, "geometry"),
                      ({"kv_layout": "slot", "cache_dtype": "int8"}, "geometry")):
        cb = _mk(lm, **{"n_slots": 3, **kw})
        with pytest.raises(ValueError, match=match):
            cb.restore(snap)
        assert len(_drain(cb, [cb.submit(_prompt(7, 12), 3)])[0]) == 3
    cb = _mk(lm)
    cb.submit(_prompt(20, 13), 4)
    with pytest.raises(RuntimeError, match="queued prefills"):
        cb.snapshot()


def test_restore_shrunk_pool_raises_typed_capacity_error(models):
    _, lm = models
    big = _mk(lm, kv_blocks=12)
    rid = big.submit(_prompt(20, 10), 6)
    _settle_prefills(big)
    big.step_pump(2)
    snap = big.snapshot()
    small = _mk(lm, kv_blocks=8)
    with pytest.raises(PoolCapacityError) as ei:
        small.restore(snap)
    assert ei.value.needed == 12 and ei.value.have == 8
    assert isinstance(ei.value.evictable, list)
    assert len(_drain(small, [small.submit(_prompt(10, 11), 3)])[0]) == 3
    assert _drain(big, [rid])[0] is not None


@pytest.mark.parametrize("layout", ["slot", "ring"])
def test_snapshot_keeps_prefixes_counters_and_results(models, layout):
    """Registered prefixes (stored K/V, a ring on the ring), the counters
    and the finished results survive a restore: a prefix= request after it
    is the same as on the source."""
    _, lm = models
    kw = LAYOUT_KW[layout]
    cb = _mk(lm, **kw)
    pid = cb.register_prefix(_prompt(16, 20))
    done = cb.submit(_prompt(4, 21), 3)
    _drain(cb, [done])
    snap = cb.snapshot()
    b2 = _mk(lm, **kw)
    b2.restore(snap)
    assert b2.result(done) == cb.result(done)
    assert b2.stats()["steps"] == cb.stats()["steps"]
    assert b2.stats()["prefixes_registered"] == 1
    tail = _prompt(5, 22)
    assert _drain(b2, [b2.submit(tail, 6, prefix=pid)]) == _drain(cb, [cb.submit(tail, 6,
                                                                                 prefix=pid)])


def test_snapshot_carries_the_draft_cache(models):
    """A draft batcher's snapshot holds the draft's cache: the restored
    speculative rounds accept what the uninterrupted ones accept."""
    _, lm = models
    kw = dict(kv_layout="slot", draft_params=lm, draft_n_heads=N_HEADS)
    cb = _mk(lm, **kw)
    rid = cb.submit(_prompt(9, 30), 16)
    cb.spec_step(4)
    snap = cb.snapshot()
    st0 = cb.stats()["spec_accepted_tokens"]
    while cb.result(rid) is None:
        cb.spec_step(4)
    want = cb.result(rid)
    b2 = _mk(lm, **kw)
    b2.restore(snap)
    while b2.result(rid) is None:
        b2.spec_step(4)
    assert b2.result(rid) == want
    assert b2.stats()["spec_accepted_tokens"] == cb.stats()["spec_accepted_tokens"] > st0
    with pytest.raises(ValueError, match="draft"):
        _mk(lm, kv_layout="slot").restore(snap)


# -- request migration ---------------------------------------------------------------------------


@pytest.mark.parametrize("cache_dtype", ["auto", "int8"])
def test_migrate_greedy_bitwise(models, reference, src, dst, cache_dtype):
    """Extract mid-decode, over the wire, adopt on a second batcher with a
    fresh pool: the uninterrupted stream (the JAX package's), float and
    int8 (the quantized payload and its scales ship as they are)."""
    _, lm = models
    if cache_dtype == "int8":
        src, dst = _mk(lm, cache_dtype="int8"), _mk(lm, cache_dtype="int8")
    name = "fp" if cache_dtype == "auto" else "int8"
    p, n = STREAMS[name]
    [ref] = _drain(src, [src.submit(p, n)])
    rid = _mid_decode(src, p, n)
    out0, in0 = src.stats()["kv_migrations_out"], dst.stats()["kv_migrations_in"]
    in_use0 = src.stats()["kv_blocks_in_use"]
    span = src.extract_request(rid)
    assert src.stats()["kv_migrations_out"] == out0 + 1
    assert src.result(rid) is None and src.n_free == src.n_slots
    assert src.stats()["kv_blocks_in_use"] < in_use0
    assert span.cache_dtype == ("float32" if cache_dtype == "auto" else "int8")
    assert len(span.leaves) == (2 if cache_dtype == "auto" else 4)
    new_rid = dst.adopt_request(decode_span(encode_span(span)))
    assert dst.stats()["kv_migrations_in"] == in0 + 1
    assert dst.stats()["kv_prefill_queue"] == 0  # adopted straight into decode
    assert _drain(dst, [new_rid]) == [ref]
    if cache_dtype == "auto":
        assert ref == reference[name]


def test_migrate_sampled_stream_bitwise_within_the_port(models, src, dst):
    """The span's key carries the seed: a sampled stream adopted by another
    port batcher continues as the uninterrupted one."""
    p = _prompt(12, 40)
    kw = dict(temperature=0.9, top_k=30, seed=2**33 + 3)
    [ref] = _drain(src, [src.submit(p, 9, **kw)])
    rid = _mid_decode(src, p, 9, **kw)
    assert _drain(dst, [dst.adopt_request(src.extract_request(rid))]) == [ref]


def test_warm_migration_ships_fewer_bytes(src, dst):
    """A destination holding the prompt's full blocks: fewer bytes by the
    stripped blocks exactly, the same continued stream, prefix hits."""
    p, n = STREAMS["warm"]
    [ref] = _drain(src, [src.submit(p, n)])
    _drain(dst, [dst.submit(p, n)])  # seeds the destination's prefix index
    rid = _mid_decode(src, p, n)
    span = src.extract_request(rid)
    shared = dst.probe_prefix(span.kv_tokens)
    assert shared >= 32
    tmig.tally.reset()
    cold = encode_span(span)
    warm_span = span.strip_shared(shared)
    warm = encode_span(warm_span)
    assert tmig.tally.snapshot()["bytes_out"] == len(cold) + len(warm)
    stripped = [r for r in warm_span.blocks if r.payload is None]
    assert len(stripped) == shared // 16
    assert span.payload_bytes() - warm_span.payload_bytes() == sum(
        len(b) for r, w in zip(span.blocks, warm_span.blocks) if w.payload is None
        for b in r.payload)
    assert len(cold) - len(warm) > span.payload_bytes() - warm_span.payload_bytes() - 64
    hits0 = dst.stats()["kv_prefix_hits"]
    new_rid = dst.adopt_request(decode_span(warm))
    assert dst.stats()["kv_prefix_hits"] > hits0
    assert _drain(dst, [new_rid]) == [ref]


def test_resume_from_span_parity(src, dst):
    """No peer: a re-prefill from the span's tokens alone continues the
    uninterrupted stream (the pending token carried, nothing re-sampled)."""
    p, n = STREAMS["resume"]
    [ref] = _drain(src, [src.submit(p, n)])
    rid = _mid_decode(src, p, n)
    span = decode_span(encode_span(src.extract_request(rid)))
    res0 = dst.stats()["request_resumes"]
    new_rid = dst.resume_from_span(span)
    assert dst.stats()["request_resumes"] == res0 + 1
    assert _drain(dst, [new_rid]) == [ref]


def test_extract_refusals(models, src):
    with pytest.raises(SpanStateError, match="not extractable"):
        src.extract_request(10**9)
    p = _prompt(8, 5)
    rid = src.submit(p, 4)  # queued: no span yet
    with pytest.raises(SpanStateError, match="settle the prefill"):
        src.extract_request(rid)
    _drain(src, [rid])
    with pytest.raises(SpanStateError):
        src.extract_request(rid)
    flat = _mk(models[1], kv_layout="slot")
    with pytest.raises(SpanStateError, match="paged"):
        flat.extract_request(0)
    assert flat.probe_prefix(p) == 0


def test_adopt_refusals(src, dst):
    rid = _mid_decode(src, _prompt(20, 6), 8)
    span = src.extract_request(rid)
    st0 = dst.stats()
    with pytest.raises(SpanFormatError, match="block_size"):
        dst.adopt_request(dataclasses.replace(span, block_size=32))
    with pytest.raises(SpanFormatError, match="geometry"):
        dst.adopt_request(dataclasses.replace(span, leaves=[("float32", (9, 9))]))
    with pytest.raises(SpanCapacityError, match="max_len"):
        dst.adopt_request(dataclasses.replace(span, budget=1000))
    stripped = span.strip_shared(len(span.blocks) * span.block_size)
    with pytest.raises(SpanPayloadMissingError, match="prefix index"):
        dst.adopt_request(stripped)
    assert {k: dst.stats()[k] for k in ("kv_blocks_in_use", "kv_migrations_in", "slots_free")} \
        == {k: st0[k] for k in ("kv_blocks_in_use", "kv_migrations_in", "slots_free")}
    assert len(_drain(dst, [dst.adopt_request(span)])) == 1


def test_adopt_capacity_refusal(models, src):
    """A pool that cannot host the span refuses it and is left as it was;
    the span is whole and resumes elsewhere."""
    tight = _mk(models[1], kv_blocks=6)
    rid = _mid_decode(src, _prompt(50, 7), 8)
    span = src.extract_request(rid)  # 4 blocks
    r2 = tight.submit(_prompt(50, 9), 8)  # pins 4 of the 6
    _settle_prefills(tight)
    st0 = tight.stats()
    with pytest.raises(SpanCapacityError, match="blocks"):
        tight.adopt_request(span)
    assert {k: tight.stats()[k] for k in ("kv_blocks_in_use", "kv_blocks_free", "slots_free",
                                          "kv_prefix_hits")} \
        == {k: st0[k] for k in ("kv_blocks_in_use", "kv_blocks_free", "slots_free",
                                "kv_prefix_hits")}
    _drain(tight, [r2])
    assert len(_drain(src, [src.resume_from_span(span)])) == 1


@pytest.mark.parametrize("cache_dtype", ["auto", "int8"])
def test_spans_cross_packages(models, cache_dtype):
    """A span the JAX batcher extracts, adopted by the port's, continues to
    the JAX source's greedy stream, and the other way round; the port's
    arena leaves have the JAX package's per-block geometry."""
    jp, lm = models
    p, n = STREAMS["fp"]
    kw = dict(cache_dtype=cache_dtype)
    jsrc, jdst, tsrc, tdst = _jmk(jp, **kw), _jmk(jp, **kw), _mk(lm, **kw), _mk(lm, **kw)
    jref = [list(t) for t in _drain(jsrc, [jsrc.submit(p, n)])]
    jrid = _mid_decode(jsrc, p, n)
    jspan = jsrc.extract_request(jrid)
    assert [tuple(x) for x in jspan.leaves] == tdst._span_leaf_template()
    assert _drain(tdst, [tdst.adopt_request(decode_span(jmig.encode_span(jspan)))]) == jref
    tref = _drain(tsrc, [tsrc.submit(p, n)])
    rid = _mid_decode(tsrc, p, n)
    span = tsrc.extract_request(rid)
    wire = encode_span(span)
    theirs = jmig.decode_span(wire)
    assert jmig.encode_span(theirs) == wire
    assert [list(t) for t in _drain(jdst, [jdst.adopt_request(theirs)])] == tref
    if cache_dtype == "auto":
        assert tref == jref


# -- the serving element ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def npz(models, tmp_path_factory):
    path = tmp_path_factory.mktemp("lm") / "lm.npz"
    np.savez(path, **{f"p{i}": np.asarray(x)
                      for i, x in enumerate(jax.tree_util.tree_leaves(models[0]))})
    return str(path)


_made_servers = []


@pytest.fixture(autouse=True)
def _release_servers():
    """A private paged server stays registered as this process's migration
    target until it is released, as the element's stop releases it: every
    server a test made is released after it, so none answers for a later
    test's peer."""
    yield
    while _made_servers:
        _made_servers.pop().release_plane()


def _server(npz, paged=True, **kw):
    from nnstreamer_tpu_torch.elements.llm_serve import _LlmServer

    srv = _LlmServer(
        model="zoo:transformer_lm",
        options={"vocab": str(VOCAB), "d_model": str(D_MODEL), "n_heads": str(N_HEADS),
                 "n_layers": str(N_LAYERS), "params": npz},
        n_slots=2, max_len=64, prompt_len=16, default_new=10, device=torch.device("cpu"),
        kv_kw=dict(kv_layout="paged", block_size=16) if paged else None, **kw)
    _made_servers.append(srv)
    return srv


def _pump_until(srv, cond, limit=500):
    for _ in range(limit):
        if cond():
            return
        srv.pump()
    raise AssertionError("the server did not get there")


def test_migration_props_need_paged_layout(npz):
    from nnstreamer_tpu_torch.elements.base import ElementError

    for bad in (dict(migrate_to="peer:7000"), dict(checkpoint_dir="/nowhere"),
                dict(checkpoint_every_tokens=4)):
        with pytest.raises(ElementError, match="kv-layout=paged"):
            _server(npz, paged=False, **bad)


def test_peer_migration_names_the_edge_layer(npz):
    """migrate-to and drain(migrate_to=...) run on the edge layer: the prop
    constructs, and a drain to a peer that does not answer resumes the
    in-flight request here by re-prefill (nothing is lost)."""
    from nnstreamer_tpu_torch.edge.transport import PyTransport
    from nnstreamer_tpu_torch.elements.llm_serve import LlmServerSink

    sink = LlmServerSink(**{"kv-layout": "paged", "migrate-to": "127.0.0.1:7000"})
    assert sink._create_kw["migrate_to"] == "127.0.0.1:7000"
    assert _server(npz, migrate_to="127.0.0.1:7000").migrate_to == "127.0.0.1:7000"
    closed = PyTransport()  # a port that is bound, then released: refuses
    port = closed.listen("127.0.0.1", 0)
    closed.close()
    srv = _server(npz)
    srv.submit(Frame((STREAMS["elem"][0],), meta={"req": "m0"}))
    rid = next(iter(srv._pending))
    _pump_until(srv, lambda: len(srv.cb.partials([rid]).get(rid) or ()) >= 2)
    summary = srv.drain(migrate_to=f"127.0.0.1:{port}")
    assert summary == {"migrated": 0, "resumed": 1, "completed": 0, "kept": 0}
    assert srv.draining and list(srv._pending.values()) == [{"req": "m0"}]


def test_checkpoint_crash_restart_resumes_bitwise(npz, reference, tmp_path):
    """Span checkpoints every 2 tokens; the server vanishes without a drain;
    a new one on the same directory adopts the request (nothing queued for
    prefill), finishes it as the uninterrupted run with its identity meta
    (hop-local meta stripped), and reaps the file; a corrupt file is set
    aside."""
    ckpt = tmp_path / "spans"
    prompt = STREAMS["elem"][0]
    srv1 = _server(npz, srv_id="ck1", checkpoint_every_tokens=2, checkpoint_dir=str(ckpt))
    srv1.submit(Frame((prompt,), meta={"req": "c1", "frame_id": "f-c1", "client_id": 42}))
    rid = next(iter(srv1._pending))
    _pump_until(srv1, lambda: len(srv1.cb.partials([rid]).get(rid) or ()) >= 5)
    assert sorted(p.name for p in ckpt.glob("req-*.span")) == [f"req-{rid}.span"]
    del srv1  # no drain, no extraction: only the files survive
    (ckpt / "req-99.span").write_bytes(b"NNSSPAN1 torn")
    srv2 = _server(npz, srv_id="ck2", checkpoint_every_tokens=2, checkpoint_dir=str(ckpt))
    assert srv2._pending and srv2.cb.stats()["kv_prefill_queue"] == 0
    assert (ckpt / "req-99.span.bad").exists()
    _pump_until(srv2, lambda: srv2._out)
    toks, meta = srv2.pop()
    assert meta == {"req": "c1", "frame_id": "f-c1"}
    assert [int(t) for t in toks] == reference["elem"]
    assert not list(ckpt.glob("req-*.span"))
    assert srv2.cb.stats()["kv_migrations_in"] == 1


def test_drain_without_a_peer_finishes_in_place(npz, reference):
    """drain() with no peer: a submit is refused ``draining``, the kept
    request finishes in place with its meta, as the uninterrupted run."""
    from nnstreamer_tpu_torch.elements.base import ElementError
    from nnstreamer_tpu_torch.elements.llm_serve import _table, drain_server

    prompt = STREAMS["elem"][0]
    srv = _server(npz, srv_id="d1")
    _table["d1"] = srv
    try:
        srv.submit(Frame((prompt,), meta={"req": "d1", "frame_id": "f-d1"}))
        assert drain_server("d1") == {"migrated": 0, "resumed": 0, "completed": 0, "kept": 1}
        assert srv.draining and srv.cb.stats()["kv_prefill_queue"] == 0
        with pytest.raises(ElementError, match="draining"):
            srv.submit(Frame((prompt,), meta={}))
        _pump_until(srv, lambda: srv._out)
        toks, meta = srv.pop()
        assert meta == {"req": "d1", "frame_id": "f-d1"}
        assert [int(t) for t in toks] == reference["elem"]
    finally:
        _table.pop("d1", None)


def test_migration_probe_and_adopt_through_the_element(npz, reference):
    """Server A's span, probed against and adopted by server B through the
    element's migration methods: B emits the request with its meta and the
    uninterrupted tokens."""
    prompt = STREAMS["elem"][0]
    a, b = _server(npz, srv_id="ma"), _server(npz, srv_id="mb")
    a.submit(Frame((prompt,), meta={"req": "m1"}))
    rid = next(iter(a._pending))
    _pump_until(a, lambda: len(a.cb.partials([rid]).get(rid) or ()) >= 3)
    span = a.cb.extract_request(rid)
    assert b.migration_probe(span.kv_tokens) == 0
    span.meta.update({"req": "m1"})
    b.migration_adopt(encode_span(span.strip_shared(b.migration_probe(span.kv_tokens))))
    assert b.migration_advert() == {"role": ""}
    _pump_until(b, lambda: b._out)
    toks, meta = b.pop()
    assert meta["req"] == "m1" and [int(t) for t in toks] == reference["elem"]
    b.drain()
    with pytest.raises(SpanStateError, match="draining"):
        b.migration_probe(span.kv_tokens)
