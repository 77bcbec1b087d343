"""Port parity for the paged KV slice: the block pool, the paged-attention
kernel's plain version (K4), the arena ops, the paged batcher and the
paged serving pipeline of nnstreamer_tpu_torch against the JAX package,
on numpy-seeded inputs and JAX weights carried over with
``transformer_from_jax``.

Tolerances:

- K4: 2e-5 for float32 and int8 arenas (two summation orders of float32
  dot products), 2e-2 for bfloat16 (the Pallas kernel's own tolerance).
- Arena ops: float arenas bitwise equal; int8 payloads identical, scales
  within one float32 ulp (``quantize_kv``'s division).
- Tokens: identical. Every greedy token's top-2 margin in the JAX no-cache
  logits is asserted above 1e-4, so a flip would be a fault, not noise.
- The layout invariant (the port's paged ``xla`` streams against its slot
  ``xla`` streams on distinct prompts): exact, greedy and sampled.

Budget: each JAX reference batcher is built once per module and every
trace drains through it, as tests/test_kv_paged.py does.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nnstreamer_tpu.kv import blocks as jblocks
from nnstreamer_tpu.kv import gather as jkvg
from nnstreamer_tpu.kv.block_attn import paged_attention_ref as jpaged_ref
from nnstreamer_tpu.kv.block_attn import write_fresh_window as jwrite_fresh
from nnstreamer_tpu.models import serving as jsv
from nnstreamer_tpu.models import transformer as jtfm
from nnstreamer_tpu.ops.pallas import registry as kernel_registry
from nnstreamer_tpu.ops.pallas.paged_attention import paged_decode_attention as jpaged
from nnstreamer_tpu_torch.kv import blocks as tblocks
from nnstreamer_tpu_torch.kv import block_attn as tkvb
from nnstreamer_tpu_torch.kv import gather as tkvg
from nnstreamer_tpu_torch.models import serving as tsv
from nnstreamer_tpu_torch.models import transformer as ttfm
from nnstreamer_tpu_torch.models.jax_weights import transformer_from_jax
from nnstreamer_tpu_torch.ops.kernels import paged_attention as tpa
from nnstreamer_tpu_torch.pipeline.parse import parse_pipeline

VOCAB, D_MODEL, N_HEADS, N_LAYERS = 257, 64, 4, 2
MAX_LEN, PROMPT_LEN, BS = 96, 16, 16
MARGIN = 1e-4


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The models here are tiny: two intra-op threads leave the cores to
    the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _models(n_kv, seed):
    jp = jtfm.init_params(jax.random.PRNGKey(seed), vocab=VOCAB, d_model=D_MODEL,
                          n_heads=N_HEADS, n_layers=N_LAYERS, n_kv_heads=n_kv)
    lm = ttfm.TransformerLM(VOCAB, D_MODEL, N_HEADS, N_LAYERS, n_kv_heads=n_kv)
    lm.load_state_dict(transformer_from_jax(jax.tree_util.tree_map(np.asarray, jp)))
    return jp, lm


@pytest.fixture(scope="module")
def models():
    """(JAX params, the port's model): 4 heads, 4 kv heads."""
    return _models(N_HEADS, 7)


@pytest.fixture(scope="module")
def gqa_models():
    """The 2-kv-head variant."""
    return _models(2, 11)


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(1, VOCAB, (n,)).astype(np.int32)


def _rep_prompt(n, seed, period=24):
    base = np.random.default_rng(seed).integers(1, VOCAB, (period,))
    return np.tile(base, -(-n // period))[:n].astype(np.int32)


# -- BlockPool ------------------------------------------------------------------------------


def test_pool_alloc_free_refcount_and_exhaustion():
    pool = tblocks.BlockPool(4, 16)
    a = pool.alloc(3)
    assert pool.in_use() == 3 and len(set(a)) == 3 and 0 not in a
    pool.adopt(a[0])  # a second reference
    pool.free([a[0]])
    assert pool.in_use() == 3
    pool.free(a)
    assert pool.in_use() == 0
    pool.alloc(4)
    with pytest.raises(tblocks.NoBlocksError):
        pool.alloc(1)
    with pytest.raises(ValueError):
        pool.free([a[1], a[1], a[1]])  # more frees than references


def test_pool_prefix_index_full_and_partial_match():
    pool = tblocks.BlockPool(8, 4)
    toks = np.arange(10, dtype=np.int32)  # 2 full blocks + a partial of 2
    blocks = pool.alloc(3)
    pool.register(toks, blocks)
    m = pool.match(toks)
    assert m.full == blocks[:2] and m.partial_block == blocks[2]
    assert m.n_partial == 2 and m.n_tokens == 10
    m2 = pool.match(np.arange(16, dtype=np.int32))  # the partial prefixes the rest
    assert m2.n_tokens == 10 and m2.partial_block == blocks[2]
    bad = toks.copy()
    bad[5] = 99  # diverging content stops the walk
    m3 = pool.match(bad)
    assert m3.full == blocks[:1] and m3.n_tokens == 4


def test_pool_cached_tier_reclaim_unindexes():
    pool = tblocks.BlockPool(2, 4)
    toks = np.arange(8, dtype=np.int32)
    blocks = pool.alloc(2)
    pool.register(toks, blocks)
    pool.free(blocks)  # refcount 0 but indexed: cached, still matchable
    assert pool.match(toks).n_tokens == 8
    assert sorted(pool.alloc(2)) == sorted(blocks)  # reclaims the cached blocks
    assert pool.match(toks).n_tokens == 0  # reclaimed = unindexed
    assert pool.snapshot()["index"] == []


def test_pool_cow_counts_and_snapshot_roundtrip():
    pool = tblocks.BlockPool(6, 4)
    toks = np.arange(6, dtype=np.int32)
    blocks = pool.alloc(2)
    pool.register(toks, blocks)
    b = pool.cow()
    assert b not in blocks and pool.cow_copies == 1
    pool2 = tblocks.BlockPool(6, 4)
    pool2.restore(pool.snapshot())
    assert pool2.match(toks).n_tokens == 6
    assert pool2.in_use() == pool.in_use() and pool2.cow_copies == 1


def test_pool_random_ops_match_reference():
    """One seeded sequence of alloc, free, register, match, adopt and cow
    through both pools: the same block ids, matches, errors and stats at
    every step, and the same rolling hashes."""
    rng = np.random.default_rng(0)
    pools = (tblocks.BlockPool(12, 4), jblocks.BlockPool(12, 4))
    owned = []  # block references held (a multiset)
    families = rng.integers(1, 9, (6, 20)).astype(np.int32)  # prompts sharing prefixes

    def apply(pool, op, arg):
        try:
            if op == "alloc":
                return pool.alloc(arg)
            if op == "free":
                return pool.free(arg)
            if op == "register":
                return pool.register(*arg)
            if op == "match":
                m = pool.match(arg)
                return m.n_tokens, m.full, m.partial_block, m.n_partial
            if op == "adopt":
                m = pool.match(arg)
                got = m.full + ([m.partial_block] if m.partial_block is not None else [])
                for b in got:
                    pool.adopt(b)
                return got
            return pool.cow()
        except (tblocks.NoBlocksError, jblocks.NoBlocksError) as exc:
            return type(exc).__name__

    for step in range(400):
        op = str(rng.choice(["alloc", "free", "register", "match", "adopt", "cow"]))
        toks = families[rng.integers(6)][: rng.integers(1, 21)]
        if op == "alloc":
            arg = int(rng.integers(1, 4))
        elif op == "free":
            arg = [owned[i] for i in rng.permutation(len(owned))[: rng.integers(0, 4)]]
        elif op == "register":
            arg = (toks, [owned[i] for i in rng.integers(0, len(owned), -(-len(toks) // 4))]
                   if owned else [])
        else:
            arg = toks
        got = [apply(pool, op, arg) for pool in pools]
        assert got[0] == got[1], (step, op, got)
        if op in ("alloc", "adopt") and isinstance(got[0], list):
            owned += got[0]
        elif op == "cow" and isinstance(got[0], int):
            owned.append(got[0])
        elif op == "free":
            for b in arg:
                owned.remove(b)
        assert pools[0].stats() == pools[1].stats(), step
    assert pools[0].snapshot() == pools[1].snapshot()
    assert pools[0].stats()["kv_prefix_hits"] > 0 and pools[0].stats()["kv_cow_copies"] > 0
    for seed in range(8):
        t = _prompt(seed + 3, seed)
        assert tblocks.roll_hash(seed * 977, t) == jblocks.roll_hash(seed * 977, t)


# -- K4: the plain version against the reference and the Pallas kernel ---------------------


def _k4_inputs(params, seed=3):
    """The kernel registry's case inputs (paged_attention._case_arrays),
    with ``nan`` filling every arena row outside the live histories."""
    rng = np.random.default_rng(seed)
    b, h, d = params.get("b", 2), params.get("h", 4), params.get("d", 16)
    n_kv = params.get("n_kv", h)
    bs, nb = params["bs"], params["nb"]
    n_blocks = params.get("n_blocks", b * nb)
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    tables = rng.permutation(n_blocks)[: b * nb].reshape(b, nb).astype(np.int32)
    pos = np.asarray(params.get("pos", [(i * nb * bs) // max(1, b - 1) for i in range(b)]),
                     np.int32)
    fk = rng.standard_normal((b, 1, n_kv, d)).astype(np.float32)
    fv = rng.standard_normal((b, 1, n_kv, d)).astype(np.float32)
    ks = vs = None
    if params.get("dtype") == "int8":
        ak = rng.integers(-127, 128, (n_blocks, bs, n_kv, d)).astype(np.int8)
        av = rng.integers(-127, 128, (n_blocks, bs, n_kv, d)).astype(np.int8)
        ks = rng.uniform(0.01, 0.1, (n_blocks, bs, n_kv)).astype(np.float32)
        vs = rng.uniform(0.01, 0.1, (n_blocks, bs, n_kv)).astype(np.float32)
    else:
        ak = rng.standard_normal((n_blocks, bs, n_kv, d)).astype(np.float32)
        av = rng.standard_normal((n_blocks, bs, n_kv, d)).astype(np.float32)
    if params.get("nan"):
        live = np.zeros((n_blocks, bs), bool)
        for i in range(b):
            hist = min(int(pos[i]), nb * bs)
            for r in range(hist):
                live[tables[i, r // bs], r % bs] = True
        ak[~live] = np.nan
        av[~live] = np.nan
    return q, ak, av, tables, pos, fk, fv, ks, vs


K4_CASES = [(c.name, c.params) for c in kernel_registry.get("paged_decode_attention").cases
            if c.tier1] + [
    ("bf16", {"b": 2, "h": 4, "n_kv": 2, "bs": 8, "nb": 3, "n_blocks": 8, "pos": [7, 19],
              "dtype": "bfloat16"}),
    # slot 0 holds no history (the fresh column alone), slot 1's pos lies
    # past the table's reach (clamped to nb·bs)
    ("pos0-and-past-table", {"b": 2, "bs": 8, "nb": 3, "n_blocks": 8, "pos": [0, 90]}),
    ("nan-outside-history", {"b": 2, "h": 4, "n_kv": 2, "bs": 8, "nb": 4, "n_blocks": 10,
                             "pos": [5, 27], "nan": True}),
]


@pytest.mark.parametrize("name,params", K4_CASES, ids=[c[0] for c in K4_CASES])
def test_k4_plain_matches_reference_and_pallas(name, params):
    q, ak, av, tables, pos, fk, fv, ks, vs = _k4_inputs(params)
    bf16 = params.get("dtype") == "bfloat16"
    jq, jk, jv = (jnp.asarray(a) for a in (q, ak, av))
    tq, tk, tv = (_t(a) for a in (q, ak, av))
    if bf16:
        jq, jk, jv = (a.astype(jnp.bfloat16) for a in (jq, jk, jv))
        tq, tk, tv = (a.to(torch.bfloat16) for a in (tq, tk, tv))
    kw_j = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)) if ks is not None else {}
    kw_t = dict(k_scale=_t(ks), v_scale=_t(vs)) if ks is not None else {}
    before = tpa.paged_decode_attention_launches.count
    got = tpa.paged_decode_attention(tq, tk, tv, _t(tables), _t(pos), _t(fk), _t(fv), **kw_t)
    assert tpa.paged_decode_attention_launches.count == before  # the CPU runs the plain version
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert torch.isfinite(got).all()
    jt, jpos, jfk, jfv = (jnp.asarray(a) for a in (tables, pos, fk, fv))
    ref = jpaged_ref(jq, jk, jv, jt, jpos, (jfk, jfv), **kw_j)
    pallas = jpaged(jq, jk, jv, jt, jpos, jfk, jfv, interpret=True, **kw_j)
    tol = 2e-2 if bf16 else 2e-5
    for want in (ref, pallas):
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=tol, rtol=0)
    # the reference's name and signature, and the three dispatch names
    if ks is not None:
        entry_k, entry_v = (tk, kw_t["k_scale"]), (tv, kw_t["v_scale"])
    else:
        entry_k, entry_v = tk, tv
    fresh = (_t(fk), _t(fv))
    for impl in ("auto", "pallas", "jnp"):
        alt = tkvb.block_attention(tq, entry_k, entry_v, _t(tables), _t(pos), fresh, impl=impl)
        torch.testing.assert_close(alt, got, rtol=0, atol=0)
    torch.testing.assert_close(
        tkvb.paged_attention_ref(tq, tk, tv, _t(tables), _t(pos), fresh, **kw_t), got,
        rtol=0, atol=0)


def test_k4_plain_refuses_a_table_entry_outside_the_arena():
    q, ak, av, tables, pos, fk, fv, _, _ = _k4_inputs({"bs": 8, "nb": 3, "n_blocks": 8,
                                                       "pos": [20, 3]})
    tables[0, 2] = 8  # live (row 16 of 20), one past the arena
    with pytest.raises(IndexError, match="outside the arena"):
        tpa.paged_decode_attention(*(_t(a) for a in (q, ak, av, tables, pos, fk, fv)))
    tables[0, 2] = 0
    tables[1, 2] = 99  # past slot 1's history: never read
    tpa.paged_decode_attention(*(_t(a) for a in (q, ak, av, tables, pos, fk, fv)))


# -- the arena ops --------------------------------------------------------------------------


def _assert_arena_equal(got, want):
    """Float leaves bitwise; int8 payloads identical and float32 scales
    within one ulp."""
    for g, w in zip(jax.tree_util.tree_leaves(got, is_leaf=lambda x: isinstance(x, torch.Tensor)),
                    jax.tree_util.tree_leaves(want)):
        g, w = _np(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype
        if g.dtype == np.float32 and g.ndim == 4:  # int8 scales [L, N+1, bs, KV]
            assert (np.abs(g - w) <= np.spacing(np.abs(w))).all()
        else:
            np.testing.assert_array_equal(g, w)


def _scratch_pristine(arena, quantized):
    if quantized:
        (k8, ksc), (v8, vsc) = arena
        return all(bool((p[:, 0] == 0).all()) and bool((s[:, 0] == 1).all())
                   for p, s in ((k8, ksc), (v8, vsc)))
    return all(bool((a[:, 0] == 0).all()) for a in arena)


@pytest.mark.parametrize("quantized", [False, True], ids=["float32", "int8"])
def test_arena_ops_match_reference(quantized):
    """init_arena, land_stage, seed_stage, copy_block, write_fresh_window,
    gather_cache and scatter_window give the reference's arenas, and
    scratch block 0 keeps its init values under every write."""
    rng = np.random.default_rng(1)
    L, N, bs, KV, D, B = 2, 9, 4, 2, 8, 3
    S = 4  # stage blocks

    def arenas():
        return (tkvg.init_arena(L, N, bs, KV, D, quantized, torch.float32),
                jkvg.init_arena(L, N, bs, KV, D, quantized, jnp.float32))

    ta, ja = arenas()
    _assert_arena_equal(ta, ja)
    # land a staged prompt: stage blocks 1..3 into arena blocks 7, 2, 5
    stage = [rng.standard_normal((L, 1, S * bs, KV, D)).astype(np.float32) for _ in range(2)]
    ids = np.array([0, 7, 2, 5], np.int32)
    valid = np.array([False, True, True, True])
    t_seed, t_land = tkvg.make_staging_ops(quantized, torch.float32)
    j_seed, j_land = jkvg.make_staging_ops(quantized, jnp.float32)
    t_land(ta, tuple(_t(s) for s in stage), ids, valid)
    ja = j_land(ja, tuple(jnp.asarray(s) for s in stage), jnp.asarray(ids), jnp.asarray(valid))
    _assert_arena_equal(ta, ja)
    assert _scratch_pristine(ta, quantized)
    # seed a stage from three of those blocks
    empty = [np.zeros((L, 1, S * bs, KV, D), np.float32) for _ in range(2)]
    seed_ids = np.array([2, 5, 7, 0], np.int32)
    ts = t_seed(ta, tuple(_t(e) for e in empty), seed_ids, 3)
    js = j_seed(ja, tuple(jnp.asarray(e) for e in empty), jnp.asarray(seed_ids),
                jnp.asarray(3, jnp.int32))
    for g, w in zip(ts, js):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-6, atol=0)
    # the device half of copy-on-write
    t_copy = tkvg.make_paged_ops(quantized, torch.float32)[2]
    j_copy = jkvg.make_paged_ops(quantized, jnp.float32)[2]
    t_copy(ta, 5, 3)
    ja = j_copy(ja, jnp.asarray(5, jnp.int32), jnp.asarray(3, jnp.int32))
    _assert_arena_equal(ta, ja)
    # one decode token per lane, written in place; lane 1 inactive
    tables = np.array([[7, 2, 0], [5, 3, 0], [1, 4, 6]], np.int32)
    pos = np.array([5, 2, 9], np.int32)
    active = np.array([True, False, True])
    k = rng.standard_normal((L, B, 1, KV, D)).astype(np.float32)
    v = rng.standard_normal((L, B, 1, KV, D)).astype(np.float32)
    if quantized:
        jk8, jks = jsv.quantize_kv(jnp.asarray(k))
        jv8, jvs = jsv.quantize_kv(jnp.asarray(v))
        fresh = [np.asarray(x) for x in (jk8, jks, jv8, jvs)]
    else:
        fresh = [k, v]
    tkvb.write_fresh_window(ta, _t(tables), tuple(_t(f) for f in fresh), _t(pos), 1,
                            _t(active), quantized)
    ja = jwrite_fresh(ja, jnp.asarray(tables), tuple(jnp.asarray(f) for f in fresh),
                      jnp.asarray(pos), 1, jnp.asarray(active), quantized)
    _assert_arena_equal(ta, ja)
    assert _scratch_pristine(ta, quantized)
    # the gather oracle: view, a written window, scattered back
    tv = tkvg.gather_cache(ta, _t(tables))
    _assert_arena_equal(tv, jkvg.gather_cache(ja, jnp.asarray(tables)))
    width = 3
    leaves = []
    for leaf in jax.tree_util.tree_leaves(tv, is_leaf=lambda x: isinstance(x, torch.Tensor)):
        a = _np(leaf).copy()
        for b in range(B):
            rows = a[:, b, pos[b]: pos[b] + width]
            a[:, b, pos[b]: pos[b] + width] = (
                rng.integers(-127, 128, rows.shape) if a.dtype == np.int8
                else rng.uniform(0.5, 2.0, rows.shape))
        leaves.append(a)
    if quantized:
        tview = tuple((_t(leaves[i]), _t(leaves[i + 1])) for i in (0, 2))
        jview = tuple((jnp.asarray(leaves[i]), jnp.asarray(leaves[i + 1])) for i in (0, 2))
    else:
        tview, jview = tuple(_t(x) for x in leaves), tuple(jnp.asarray(x) for x in leaves)
    tkvg.scatter_window(ta, _t(tables), tview, _t(pos), width, _t(active))
    ja = jkvg.scatter_window(ja, jnp.asarray(tables), jview, jnp.asarray(pos), width,
                             jnp.asarray(active))
    _assert_arena_equal(ta, ja)
    assert _scratch_pristine(ta, quantized)
    # the per-block ops: one staged block in, then read back
    t_write, t_read, _ = tkvg.make_paged_ops(quantized, torch.float32)
    j_write, j_read, _ = jkvg.make_paged_ops(quantized, jnp.float32)
    blk = [rng.standard_normal((L, 1, bs, KV, D)).astype(np.float32) for _ in range(2)]
    t_write(ta, 6, *(_t(x) for x in blk))
    ja = j_write(ja, jnp.asarray(6, jnp.int32), *(jnp.asarray(x) for x in blk))
    _assert_arena_equal(ta, ja)
    for g, w in zip(t_read(ta, 6), j_read(ja, jnp.asarray(6, jnp.int32))):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-6, atol=0)
    assert _scratch_pristine(ta, quantized)


# -- the paged batcher ----------------------------------------------------------------------

BATCHER = dict(n_slots=3, max_len=MAX_LEN, prompt_len=PROMPT_LEN)
PAGED = dict(kv_layout="paged", block_size=BS)
# the traces drained one after another through one batcher of 9 blocks:
# a long prompt prefilled in four chunks beside a short one; a prompt whose
# extension adopts its full block and copies its partial one on write; and
# three streams that outgrow the pool, so one is preempted and re-prefilled
TRACES = {
    "long-chunked": [(_rep_prompt(60, 12), 8), (_prompt(5, 1), 8)],
    "prefix-cow": [(_rep_prompt(24, 5),), (np.concatenate([_rep_prompt(24, 5), _prompt(8, 2)]),)],
    "tight-preempt": [(_rep_prompt(20, 70 + s), 40) for s in range(3)],
}
POOL_KEYS = ("kv_blocks", "kv_blocks_in_use", "kv_blocks_free", "kv_blocks_cached",
             "kv_prefix_hits", "kv_prefix_hit_tokens", "kv_cow_copies", "kv_block_size",
             "kv_prefill_queue", "kv_preemptions", "kv_prefill_chunks")


def _drain(cb, rids, pump=4):
    while any(cb.result(r) is None for r in rids):
        cb.step_pump(pump)
    return [list(cb.result(r)) for r in rids]


def _run_traces(cb):
    """Every trace through ``cb``: {trace: (streams, pool stats after it)}.
    The prefix trace drains its first request before submitting the
    second, so the second finds the first's blocks registered."""
    out = {}
    for name, reqs in TRACES.items():
        if name == "prefix-cow":
            streams = [_drain(cb, [cb.submit(p, 4)])[0] for (p,) in reqs]
        else:
            streams = _drain(cb, [cb.submit(p, n) for p, n in reqs])
        st = cb.stats()
        out[name] = (streams, {k: st[k] for k in POOL_KEYS})
    return out


def _trace_prompts(name):
    return [r[0] for r in TRACES[name]]


def _no_cache_logits(jp, n_heads, length):
    """The JAX no-cache forward, compiled once for sequences right-padded
    to ``length``: the model is causal, so the logits of the real
    positions do not see the padding."""
    fwd = jax.jit(lambda toks: jtfm.apply(jp, toks, n_heads))

    def logits(seq):
        padded = np.zeros((1, length), np.int32)
        padded[0, : len(seq)] = seq
        return np.asarray(fwd(jnp.asarray(padded)))[0, : len(seq)]

    return logits


def _assert_margins(logits_of, prompt, tokens):
    """Every generated token's top-2 margin in the JAX logits > MARGIN, and
    every token the argmax of the logits it was chosen from."""
    seq = np.concatenate([prompt, np.asarray(tokens[:-1], np.int32)])
    logits = logits_of(seq)[len(prompt) - 1:]
    top2 = np.sort(logits, axis=-1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > MARGIN
    assert logits.argmax(-1).tolist() == list(tokens)


@pytest.fixture(scope="module")
def reference_traces(models):
    """The JAX paged batcher (block-native, xla) drained through every
    trace once, its streams' margins checked once."""
    jp, _ = models
    got = _run_traces(jsv.ContinuousBatcher(jp, N_HEADS, kv_blocks=9, **BATCHER, **PAGED))
    assert got["tight-preempt"][1]["kv_preemptions"] > 0
    assert got["prefix-cow"][1]["kv_cow_copies"] > 0
    logits_of = _no_cache_logits(jp, N_HEADS, MAX_LEN)
    for name, (streams, _) in got.items():
        for p, toks in zip(_trace_prompts(name), streams):
            _assert_margins(logits_of, p, toks)
    return got


@pytest.mark.parametrize(
    "attn_impl,kv_attn", [("xla", "block"), ("xla", "gather"), ("pallas", "auto")]
)
def test_paged_batcher_matches_reference(models, reference_traces, attn_impl, kv_attn):
    """The port's paged batcher gives the JAX paged batcher's greedy tokens
    and the same pool stats after every trace: the chunked prompt, the
    shared prefix with its copy-on-write block, and the preempted and
    re-prefilled stream (its K/V recomputed by a chunk forward)."""
    _, lm = models
    cb = tsv.ContinuousBatcher(lm, N_HEADS, kv_blocks=9, attn_impl=attn_impl, kv_attn=kv_attn,
                               device="cpu", **BATCHER, **PAGED)
    got = _run_traces(cb)
    for name, (streams, stats) in reference_traces.items():
        assert got[name][0] == streams, name
        assert got[name][1] == stats, name
    st = cb.stats()
    assert st["kv_attn"] == ("gather" if kv_attn == "gather" else "block")
    assert (st["kv_gather_dispatches"] > 0) == (kv_attn == "gather")
    assert st["kv_blocks_in_use"] == 0


@pytest.fixture(scope="module")
def reference_int8(gqa_models):
    """The JAX paged int8 batcher on the 2-kv-head model: one chunked and
    two bucket-sized prompts."""
    jp, _ = gqa_models
    cb = jsv.ContinuousBatcher(jp, N_HEADS, cache_dtype="int8", **BATCHER, **PAGED)
    prompts = [_prompt(40, 21), _prompt(7, 22), _prompt(12, 23)]
    streams = _drain(cb, [cb.submit(p, 10) for p in prompts])
    logits_of = _no_cache_logits(jp, N_HEADS, MAX_LEN)
    for p, toks in zip(prompts, streams):
        # near-ties only: an int8 cache's tokens need not be the float
        # forward's argmax
        seq = np.concatenate([p, np.asarray(toks[:-1], np.int32)])
        top2 = np.sort(logits_of(seq)[len(p) - 1:], axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > MARGIN
    return prompts, streams


@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
def test_paged_int8_batcher_matches_reference(gqa_models, reference_int8, attn_impl):
    _, lm = gqa_models
    prompts, want = reference_int8
    cb = tsv.ContinuousBatcher(lm, N_HEADS, cache_dtype="int8", attn_impl=attn_impl,
                               device="cpu", **BATCHER, **PAGED)
    assert _drain(cb, [cb.submit(p, 10) for p in prompts]) == want


def _drive(cb, prompts, n_new, **kw):
    """Submit every prompt (pumping while the slots are full), run to the
    end → the token lists in prompt order."""
    rids, todo = [], list(prompts)
    while todo or any(cb.result(r) is None for r in rids):
        while todo:
            rid = cb.submit(todo[0], n_new, **kw)
            if rid is None:
                break
            rids.append(rid)
            todo.pop(0)
        cb.step_pump(3)
    return [list(cb.result(r)) for r in rids]


@pytest.mark.parametrize(
    "kw,sampling",
    [({}, False), ({}, True), ({"cache_dtype": "int8"}, False)],
    ids=["greedy", "sampled", "int8-greedy"],
)
def test_paged_xla_streams_equal_slot_streams_exactly(gqa_models, kw, sampling):
    """The layout invariant: on distinct prompts (no prefix hit, no
    preemption) the paged layout is only where the cache bytes live. The
    prefill programs, the sampling seeds and the fills are the slot
    layout's, and each layer's view has the slot cache's shape, so the
    streams are equal exactly."""
    _, lm = gqa_models
    rng = np.random.default_rng(31)
    prompts = [rng.integers(1, VOCAB, (int(n),)).astype(np.int32) for n in (5, 33, 16, 3, 21)]
    sample = dict(temperature=0.9, top_k=40, seed=5) if sampling else {}
    slot = _drive(tsv.ContinuousBatcher(lm, N_HEADS, device="cpu", **BATCHER, **kw),
                  prompts, 9, **sample)
    cb = tsv.ContinuousBatcher(lm, N_HEADS, device="cpu", **BATCHER, **PAGED, **kw)
    assert _drive(cb, prompts, 9, **sample) == slot
    st = cb.stats()
    assert st["kv_prefix_hits"] == 0 and st["kv_preemptions"] == 0


def test_paged_batcher_validates_like_reference(models):
    """The reference's constructor checks, and the state and migration
    calls' refusals on a batcher with nothing to move."""
    _, lm = models

    def paged(**kw):
        return tsv.ContinuousBatcher(lm, N_HEADS, device="cpu", **{**BATCHER, **PAGED, **kw})

    with pytest.raises(ValueError, match="block_size"):
        paged(block_size=7)
    with pytest.raises(ValueError, match="kv_blocks"):
        paged(kv_blocks=2)
    with pytest.raises(ValueError, match="kv_attn='gather'"):
        paged(attn_impl="pallas", kv_attn="gather")
    with pytest.raises(ValueError, match="windowed"):
        paged(windowed=True)
    with pytest.raises(ValueError, match="kv_attn"):
        tsv.ContinuousBatcher(lm, N_HEADS, device="cpu", kv_attn="block", **BATCHER)
    cb = paged()
    with pytest.raises(ValueError, match="unknown prefix"):
        cb.submit(_prompt(4, 0), 2, prefix=0)
    from nnstreamer_tpu_torch.kv.migrate import SpanStateError

    with pytest.raises(SpanStateError, match="not extractable"):
        cb.extract_request(0)
    snap = cb.snapshot()
    assert snap["layout"] == "paged" and snap["requests"] == []
    with pytest.raises(ValueError, match="layout"):
        tsv.ContinuousBatcher(lm, N_HEADS, device="cpu", **BATCHER).restore(snap)


# -- the pipeline surface -------------------------------------------------------------------

PIPE_OPTS = "vocab:211,d_model:32,n_heads:2,n_layers:2,seed:5"


def test_llm_serve_paged_pipeline_matches_reference(tmp_path):
    """tests/test_llm_serve.py's paged pipeline through the port on the
    CPU: every generation equals the JAX model's greedy decode alone (its
    no-cache forward, margins asserted), and the paged stats surface
    through serving_stats()."""
    from nnstreamer_tpu_torch.elements.llm_serve import LlmServerSink, LlmServerSrc
    from nnstreamer_tpu_torch.elements.sink import AppSink
    from nnstreamer_tpu_torch.elements.sources import AppSrc
    from nnstreamer_tpu_torch.pipeline.graph import Pipeline
    from nnstreamer_tpu_torch.tensors.frame import Frame
    from nnstreamer_tpu_torch.tensors.spec import TensorFormat, TensorsSpec

    jp = jtfm.init_params(jax.random.PRNGKey(5), 211, 32, 2, 2, n_kv_heads=2)
    path = tmp_path / "lm.npz"
    np.savez(path, **{f"p{i}": np.asarray(x) for i, x in enumerate(jax.tree_util.tree_leaves(jp))})
    rng = np.random.default_rng(1)
    prompts = {f"req{i}": rng.integers(1, 211, (5 + 2 * i,)).astype(np.int32) for i in range(3)}
    src = AppSrc(spec=TensorsSpec(format=TensorFormat.FLEXIBLE))
    sink = LlmServerSink(**{"id": "tkv0", "custom": f"{PIPE_OPTS},params:{path}", "n-slots": 4,
                            "max-len": 64, "prompt-len": 16, "max-new-tokens": 5, "pump": 4,
                            "kv-layout": "paged", "block-size": 16, "kv-blocks": 12})
    out_src = LlmServerSrc(**{"id": "tkv0"})
    out_sink = AppSink()
    p = Pipeline(device="cpu").chain(src, sink)
    p.chain(out_src, out_sink)
    p.start()
    try:
        for name, prompt in prompts.items():
            src.push(Frame((prompt,), meta={"req": name}))
        src.end_of_stream()
        results = {}
        while len(results) < len(prompts):
            f = out_sink.pop(timeout=120)
            assert f is not None, "serving pipeline drained early"
            results[f.meta["req"]] = f.tensors[0][0].tolist()
        st = out_src.serving_stats()
    finally:
        p.stop()
    logits_of = _no_cache_logits(jp, 2, 64)
    for name, prompt in prompts.items():
        assert len(results[name]) == 5, name
        _assert_margins(logits_of, prompt, results[name])
    assert st["kv_blocks"] == 12 and st["kv_blocks_in_use"] == 0
    assert st["kv_attn"] == "block" and st["kv_prefill_chunks"] >= 3
