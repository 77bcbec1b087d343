"""Port parity for the LLM serving slice: the attention primitives, the
decode-attention kernel's plain version (K3), the transformer, KV-cache
decoding, the slot batcher and the LLM elements of nnstreamer_tpu_torch
against the JAX package, on numpy-seeded inputs and JAX weights carried
over with ``transformer_from_jax`` (or ``params:<npz>``).

Tolerances:

- Primitives and K3: 2e-5 for float32 and int8 caches (two summation
  orders of float32 dot products), 2e-2 for bfloat16 (the Pallas kernel's
  own tolerance against its reference).
- Logits and caches: within 1e-5 of max |x| (XLA's and PyTorch's CPU
  matmuls sum in different orders).
- Tokens: identical. A near-tie between the top two logits could flip on
  summation order alone, so every greedy step asserts a top-2 margin above
  1e-4 in the JAX logits: a flip would then be a fault, not noise.
- quantize_kv: int8 payloads identical, scales within one float32 ulp.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nnstreamer_tpu.models import decode as jdec
from nnstreamer_tpu.models import serving as jsv
from nnstreamer_tpu.models import transformer as jtfm
from nnstreamer_tpu.ops.pallas import _primitives as jprim
from nnstreamer_tpu.ops.pallas.decode_attention import (
    decode_attention as jdecode_attention,
    decode_attention_ref,
    make_decode_attention as jmake_decode_attention,
)
from nnstreamer_tpu.ops.pallas import registry as kernel_registry
from nnstreamer_tpu_torch.models import decode as tdec
from nnstreamer_tpu_torch.models import serving as tsv
from nnstreamer_tpu_torch.models import transformer as ttfm
from nnstreamer_tpu_torch.models import zoo as tzoo
from nnstreamer_tpu_torch.models.jax_weights import (
    TRANSFORMER_BLOCK_LEAVES,
    TRANSFORMER_TOP_LEAVES,
    transformer_from_jax,
)
from nnstreamer_tpu_torch.ops.kernels import _primitives as tprim
from nnstreamer_tpu_torch.ops.kernels import decode_attention as tda
from nnstreamer_tpu_torch.pipeline.parse import parse_pipeline

VOCAB, D_MODEL, N_HEADS, N_KV, N_LAYERS = 211, 64, 4, 2, 2
MARGIN = 1e-4


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The models here are tiny: two intra-op threads leave the cores to
    the suite's other workers, some of whose tests are timing-sensitive."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """(JAX params, the port's TransformerLM with the same weights)."""
    jp = jtfm.init_params(jax.random.PRNGKey(5), vocab=VOCAB, d_model=D_MODEL,
                          n_heads=N_HEADS, n_layers=N_LAYERS, n_kv_heads=N_KV)
    lm = ttfm.TransformerLM(VOCAB, D_MODEL, N_HEADS, N_LAYERS, n_kv_heads=N_KV)
    lm.load_state_dict(transformer_from_jax(jax.tree_util.tree_map(np.asarray, jp)))
    return jp, lm


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, VOCAB, (n,)).astype(np.int32) for n in lengths]


def _close(got, want, rel=1e-5):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-30))


def _assert_margins(jp, prompt, tokens):
    """Every generated token's top-2 margin in the JAX logits > MARGIN."""
    seq = np.concatenate([prompt, np.asarray(tokens[:-1], np.int32)])[None]
    logits = np.asarray(jtfm.apply(jp, jnp.asarray(seq), N_HEADS))[0, len(prompt) - 1:]
    top2 = np.sort(logits, axis=-1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > MARGIN


# -- primitives ---------------------------------------------------------------


def test_primitives_match_reference():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((3, 16)).astype(np.float32)
    k = rng.standard_normal((8, 16)).astype(np.float32)
    v = rng.standard_normal((8, 16)).astype(np.float32)
    scales = rng.uniform(0.01, 0.1, (8,)).astype(np.float32)
    _close(tprim.scaled_qk(_t(q), _t(k), 0.25), jprim.scaled_qk(q, k, 0.25), 2e-6)
    _close(tprim.dequant_rows(_t(k), _t(scales)), jprim.dequant_rows(k, scales), 1e-7)
    s = q @ k.T
    cols = np.arange(8)[None, :]
    ts, tv = tprim.mask_dead_columns(_t(s), _t(v), _t(cols), 5)
    js, jv = jprim.mask_dead_columns(s, v, cols, 5)
    np.testing.assert_array_equal(_np(ts), np.asarray(js))
    np.testing.assert_array_equal(_np(tv), np.asarray(jv))
    # init: same buffers as the reference's ref-filling init
    tm, tl, tacc = torch.ones(3), torch.ones(3), torch.ones(3, 16)
    jm, jl, jacc = np.ones(3, np.float32), np.ones(3, np.float32), np.ones((3, 16), np.float32)
    tprim.online_softmax_init(tm, tl, tacc)
    jprim.online_softmax_init(jm, jl, jacc)
    for a, b in ((tm, jm), (tl, jl), (tacc, jacc)):
        np.testing.assert_array_equal(_np(a), b)
    # two blocks of the recurrence, then the finalize
    state_t = (tm, tl, tacc)
    state_j = (jnp.asarray(jm), jnp.asarray(jl), jnp.asarray(jacc))
    for blk in range(2):
        sb = rng.standard_normal((3, 8)).astype(np.float32)
        vb = rng.standard_normal((8, 16)).astype(np.float32)
        state_t = tprim.online_softmax_update(_t(sb), _t(vb), *state_t)
        state_j = jprim.online_softmax_update(sb, vb, *state_j)
        for a, b in zip(state_t, state_j):
            _close(a, b, 2e-6)
    _close(tprim.online_softmax_finalize(state_t[1], state_t[2]),
           jprim.online_softmax_finalize(state_j[1], state_j[2], jnp.float32), 2e-6)


def test_primitives_guards():
    """A row nothing attends to comes out exactly 0, and NaN in a dead V
    row (stale cache bytes) never reaches the output."""
    s = np.array([[0.5, 1.0, 2.0, -1.0], [3.0, 1.0, 0.0, 0.0]], np.float32)
    v = np.ones((4, 8), np.float32)
    v[2:] = np.nan
    cols = np.arange(4)[None, :]
    for live_len, expect in ((0, 0.0), (2, 1.0)):  # 0: no live column at all
        outs = []
        for prim, arr in ((tprim, _t), (jprim, jnp.asarray)):
            sm, vm = prim.mask_dead_columns(arr(s), arr(v), arr(cols), live_len)
            m0 = arr(np.full((2,), jprim.NEG_INF, np.float32))
            l0 = arr(np.zeros((2,), np.float32))
            acc0 = arr(np.zeros((2, 8), np.float32))
            _, l, acc = prim.online_softmax_update(sm, vm, m0, l0, acc0)
            if prim is tprim:
                outs.append(_np(prim.online_softmax_finalize(l, acc)))
            else:
                outs.append(np.asarray(prim.online_softmax_finalize(l, acc, jnp.float32)))
        for out in outs:
            assert np.isfinite(out).all()
            if expect == 0.0:
                assert (out == 0).all()  # nothing attended: exactly 0
            else:
                np.testing.assert_allclose(out, expect, atol=1e-6)
        np.testing.assert_allclose(outs[0], outs[1], atol=1e-6)


# -- K3: the plain version against the reference and the Pallas kernel -------------


def _k3_inputs(params, rng_seed=1):
    """The kernel registry's case inputs (decode_attention._run_case)."""
    rng = np.random.default_rng(rng_seed)
    b, h, d = params.get("b", 3), params.get("h", 4), params.get("d", 16)
    n_kv = params.get("n_kv", h)
    s_len = params["s_len"]
    dtype = params.get("dtype", "float32")
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    pos = np.asarray(
        params.get("pos", [(i * (s_len - 1)) // max(1, b - 1) for i in range(b)]), np.int32
    )
    if dtype == "int8":
        ck = rng.integers(-127, 128, (b, s_len, n_kv, d)).astype(np.int8)
        cv = rng.integers(-127, 128, (b, s_len, n_kv, d)).astype(np.int8)
        ks = rng.uniform(0.01, 0.1, (b, s_len, n_kv)).astype(np.float32)
        vs = rng.uniform(0.01, 0.1, (b, s_len, n_kv)).astype(np.float32)
        return q, ck, cv, pos, ks, vs, dtype
    ck = rng.standard_normal((b, s_len, n_kv, d)).astype(np.float32)
    cv = rng.standard_normal((b, s_len, n_kv, d)).astype(np.float32)
    return q, ck, cv, pos, None, None, dtype


def _k3_check(q, ck, cv, pos, ks, vs, dtype, block_k):
    jcast = jnp.bfloat16 if dtype == "bfloat16" else None
    tcast = torch.bfloat16 if dtype == "bfloat16" else None
    jq, jk, jv = (jnp.asarray(a) for a in (q, ck, cv))
    tq, tk, tv = (_t(a) for a in (q, ck, cv))
    if jcast is not None:
        jq, jk, jv = (a.astype(jcast) for a in (jq, jk, jv))
        tq, tk, tv = (a.to(tcast) for a in (tq, tk, tv))
    kw_j = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)) if ks is not None else {}
    kw_t = dict(k_scale=_t(ks), v_scale=_t(vs)) if ks is not None else {}
    got = tda.decode_attention(tq, tk, tv, _t(pos), **kw_t)
    assert got.dtype == torch.float32 and got.shape == q.shape
    ref = decode_attention_ref(jq, jk, jv, jnp.asarray(pos), **kw_j)
    pallas = jdecode_attention(jq, jk, jv, jnp.asarray(pos), block_k=block_k,
                                  interpret=True, **kw_j)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    for want in (ref, pallas):
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=tol, rtol=0)


@pytest.mark.parametrize(
    "case",
    [c for c in kernel_registry.get("decode_attention").cases if c.params["s_len"] <= 256],
    ids=lambda c: c.name,
)
def test_k3_plain_matches_reference_and_pallas(case):
    *args, dtype = _k3_inputs(case.params)
    _k3_check(*args, dtype, case.params.get("block_k", 128))


@pytest.mark.parametrize("s_len,block_k", [(200, 128), (33, 16)])
def test_k3_plain_wrapped_absolute_pos(s_len, block_k):
    """A wrapped ring passes absolute positions past the cache length: every
    row is live and the clamp keeps the tail masked."""
    q, ck, cv, _, _, _, dtype = _k3_inputs({"b": 2, "h": 2, "s_len": s_len}, 7)
    _k3_check(q, ck, cv, np.asarray([s_len, 3 * s_len + 7], np.int32), None, None, dtype,
              block_k)


def test_k3_plain_gqa_float():
    *args, dtype = _k3_inputs({"b": 3, "h": 8, "n_kv": 2, "s_len": 70, "d": 32}, 3)
    _k3_check(*args, dtype, 32)


def test_make_decode_attention_takes_int8_tuples():
    q, ck, cv, pos, ks, vs, _ = _k3_inputs({"b": 2, "h": 4, "n_kv": 2, "s_len": 48,
                                            "dtype": "int8", "pos": [11, 40]})
    attn = tda.make_decode_attention()
    got = attn(_t(q), (_t(ck), _t(ks)), (_t(cv), _t(vs)), _t(pos))
    want = jmake_decode_attention(interpret=True)(
        jnp.asarray(q), (jnp.asarray(ck), jnp.asarray(ks)), (jnp.asarray(cv), jnp.asarray(vs)),
        jnp.asarray(pos),
    )
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-5, rtol=0)


# -- transformer and KV-cache decoding ---------------------------------------------


def test_weights_carry_over_every_leaf(models):
    jp, lm = models
    leaves = jax.tree_util.tree_leaves(jp)
    assert len(leaves) == len(TRANSFORMER_BLOCK_LEAVES) + len(TRANSFORMER_TOP_LEAVES)
    assert set(transformer_from_jax(jax.tree_util.tree_map(np.asarray, jp))) == set(
        lm.state_dict()
    )
    np.testing.assert_array_equal(_np(lm.embed), np.asarray(jp["embed"]))
    np.testing.assert_array_equal(_np(lm.blocks[1].wqkv.weight),
                                  np.asarray(jp["blocks"]["wqkv"][1]).T)


def test_apply_matches_reference(models):
    jp, lm = models
    toks = np.random.default_rng(2).integers(0, VOCAB, (2, 19)).astype(np.int32)
    _close(ttfm.apply(lm, _t(toks), N_HEADS), jtfm.apply(jp, jnp.asarray(toks), N_HEADS))
    _close(lm(_t(toks)), jtfm.apply(jp, jnp.asarray(toks), N_HEADS))


def test_prefill_decode_verify_match_reference(models):
    jp, lm = models
    toks = np.random.default_rng(3).integers(0, VOCAB, (2, 7)).astype(np.int32)
    tl, (tk, tv), tpos = tdec.prefill(lm, _t(toks), N_HEADS, 16)
    jl, (jk, jv), jpos = jdec.prefill(jp, jnp.asarray(toks), N_HEADS, 16)
    assert tpos == int(jpos) == 7
    for a, b in ((tl, jl), (tk, jk), (tv, jv)):
        _close(a, b)
    nxt = np.asarray([5, 9], np.int32)
    tl, (tk, tv), tpos = tdec.decode_step(lm, _t(nxt), tpos, (tk, tv), N_HEADS)
    jl, (jk, jv), jpos = jdec.decode_step(jp, jnp.asarray(nxt), jpos, (jk, jv), N_HEADS)
    assert tpos == int(jpos) == 8
    for a, b in ((tl, jl), (tk, jk), (tv, jv)):
        _close(a, b)
    chunk = np.random.default_rng(4).integers(0, VOCAB, (2, 3)).astype(np.int32)
    tl, (tk, tv), tpos = tdec.verify_chunk(lm, _t(chunk), tpos, (tk, tv), N_HEADS)
    jl, (jk, jv), jpos = jdec.verify_chunk(jp, jnp.asarray(chunk), jpos, (jk, jv), N_HEADS)
    assert tpos == int(jpos) == 11
    for a, b in ((tl, jl), (tk, jk), (tv, jv)):
        _close(a, b)
    none, _, p2 = tdec.verify_chunk(lm, _t(chunk), tpos, (tk, tv), N_HEADS,
                                    return_logits=False)
    assert none is None and p2 == 14


def test_decode_overflow_checks_raise(models):
    _, lm = models
    with pytest.raises(ValueError, match="max_len"):
        tdec.prefill(lm, torch.zeros((1, 9), dtype=torch.int64), N_HEADS, 8)
    cache = tdec.init_cache(lm, 1, 8, N_HEADS)
    with pytest.raises(ValueError, match="overflow"):
        tdec.verify_chunk(lm, torch.zeros((1, 3), dtype=torch.int64), 6, cache, N_HEADS)
    with pytest.raises(ValueError, match="overflow"):
        tdec.generate(lm, torch.zeros((1, 5), dtype=torch.int64), N_HEADS, 4, max_len=8)


def test_generate_greedy_matches_reference(models):
    jp, lm = models
    for prompt in _prompts(6, (5, 11)):
        want = np.asarray(jdec.generate(jp, jnp.asarray(prompt[None]), N_HEADS, 8))[0]
        got = _np(tdec.generate(lm, _t(prompt[None]), N_HEADS, 8))[0]
        np.testing.assert_array_equal(got, want)
        _assert_margins(jp, prompt, want)


def test_generate_sampled_is_seeded(models):
    _, lm = models
    prompt = _t(_prompts(7, (6,))[0][None])

    def run(seed):
        return tdec.generate(lm, prompt, N_HEADS, 8, temperature=0.9,
                             rng=torch.Generator().manual_seed(seed))

    assert torch.equal(run(3), run(3))
    assert run(3).shape == (1, 8)


# -- serving -------------------------------------------------------------------------


def test_quantize_kv_matches_reference():
    x = np.random.default_rng(8).standard_normal((3, 5, 4, 16)).astype(np.float32) * 3
    x[0, 0, 0] = 0.0  # an all-zero row takes the 1e-8 floor
    tq, ts = tsv.quantize_kv(_t(x))
    jq, js = jsv.quantize_kv(jnp.asarray(x))
    np.testing.assert_array_equal(_np(tq), np.asarray(jq))
    ulp = np.spacing(np.abs(np.asarray(js)))
    assert (np.abs(_np(ts) - np.asarray(js)) <= ulp).all()
    np.testing.assert_allclose(_np(tsv.dequantize_kv(tq, ts)),
                               np.asarray(jsv.dequantize_kv(jq, js)), rtol=1e-6)


def test_filtered_logits_match_reference():
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((5, 50)).astype(np.float32) * 3
    temp = np.array([0.0, 0.7, 1.0, 1.3, 0.5], np.float32)
    top_k = np.array([0, 5, 0, 1, 10], np.int32)
    top_p = np.array([1.0, 1.0, 0.8, 0.5, 0.3], np.float32)
    got = _np(tsv._filtered_logits(_t(logits), _t(temp), _t(top_k), _t(top_p)))
    want = np.asarray(jsv._filtered_logits(*(jnp.asarray(a) for a in (logits, temp, top_k,
                                                                       top_p))))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6)


def _drive(cb, prompts, n_new, pump=1, **kw):
    """Submit every prompt (stepping while the slots are full), run to
    completion → the token lists in prompt order."""
    rids, todo = [], list(prompts)
    while todo or any(cb.result(r) is None for r in rids):
        while todo:
            rid = cb.submit(todo[0], n_new, **kw)
            if rid is None:
                break
            rids.append(rid)
            todo.pop(0)
        cb.step_pump(pump) if pump > 1 else cb.step()
    return [list(cb.result(r)) for r in rids]


@pytest.mark.parametrize(
    "attn_impl,cache_dtype,pump",
    [("xla", "auto", 1), ("pallas", "auto", 3), ("pallas", "int8", 1), ("xla", "int8", 2)],
)
def test_batcher_matches_reference(models, attn_impl, cache_dtype, pump):
    """Four requests through two slots, one prompt longer than prompt_len
    (chunked prefill): the port's greedy tokens equal the JAX batcher's
    (same attn_impl and cache dtype) and, for a float cache, decode.generate
    alone."""
    jp, lm = models
    prompts = _prompts(10, (5, 13, 20, 3))
    kw = dict(n_slots=2, max_len=40, prompt_len=8, attn_impl=attn_impl,
              cache_dtype=cache_dtype)
    got = _drive(tsv.ContinuousBatcher(lm, N_HEADS, device="cpu", **kw), prompts, 6, pump)
    want = _drive(jsv.ContinuousBatcher(jp, N_HEADS, **kw), prompts, 6)
    assert got == want
    if cache_dtype == "auto":
        for prompt, toks in zip(prompts, want):
            alone = np.asarray(jdec.generate(jp, jnp.asarray(prompt[None]), N_HEADS, 6))[0]
            assert toks == alone.tolist()
            _assert_margins(jp, prompt, toks)


def test_batcher_sampling_is_seeded_and_top_k_one_is_greedy(models):
    _, lm = models
    prompts = _prompts(11, (6, 9, 4))

    def run(**kw):
        cb = tsv.ContinuousBatcher(lm, N_HEADS, n_slots=2, max_len=32, prompt_len=8,
                                   device="cpu")
        return _drive(cb, prompts, 7, **kw)

    greedy = run()
    assert run(temperature=0.9, seed=4) == run(temperature=0.9, seed=4)
    assert run(temperature=0.9, top_k=1, seed=4) == greedy
    # the stream depends on (seed, position) only, not on the batch it shares
    cb = tsv.ContinuousBatcher(lm, N_HEADS, n_slots=1, max_len=32, prompt_len=8, device="cpu")
    alone = _drive(cb, prompts[:1], 7, temperature=0.9, seed=4)
    assert alone[0] == run(temperature=0.9, seed=4)[0]


def test_batcher_validates_and_refuses_unported(models):
    _, lm = models
    cb = tsv.ContinuousBatcher(lm, N_HEADS, n_slots=1, max_len=16, prompt_len=8, device="cpu")
    with pytest.raises(ValueError, match="overflow"):
        cb.submit(np.ones(10, np.int32), 8)
    with pytest.raises(NotImplementedError):
        cb.submit(np.ones(3, np.int32), 2, prefix=0)
    rid = cb.submit(np.ones(3, np.int32), 1)  # budget one: done at submit
    assert cb.result(rid) is not None and cb.n_free == 1
    for method in ("spec_step", "spec_pump", "register_prefix", "snapshot", "restore",
                   "extract_request", "adopt_request"):
        with pytest.raises(NotImplementedError):
            getattr(cb, method)()


# -- the elements and the zoo ------------------------------------------------------------

PIPE_OPTS = "vocab:211,d_model:32,n_heads:2,n_layers:2,seed:5"


@pytest.fixture(scope="module")
def pipe_params(tmp_path_factory):
    """The JAX zoo's transformer_lm weights for PIPE_OPTS as an npz of
    leaves p{i}: both packages load it through ``params:``."""
    jp = jtfm.init_params(jax.random.PRNGKey(5), 211, 32, 2, 2, n_kv_heads=2)
    path = tmp_path_factory.mktemp("lm") / "lm.npz"
    np.savez(path, **{f"p{i}": np.asarray(x)
                      for i, x in enumerate(jax.tree_util.tree_leaves(jp))})
    return jp, str(path)


def _alone(jp, prompt, n_new):
    return np.asarray(jdec.generate(jp, jnp.asarray(prompt[None]), 2, n_new))[0].tolist()


def test_zoo_transformer_lm_params_match_reference(pipe_params):
    jp, path = pipe_params
    m = tzoo.get("transformer_lm", device="cpu", **dict(
        kv.split(":") for kv in PIPE_OPTS.split(",")), params=path)
    toks = np.random.default_rng(12).integers(0, 211, (1, 9)).astype(np.int32)
    _close(m.module(_t(toks)), jtfm.apply(jp, jnp.asarray(toks), 2))
    gen = tzoo.get("transformer_lm", device="cpu", params=path, generate="4",
                   **dict(kv.split(":") for kv in PIPE_OPTS.split(",")))
    assert _np(gen.module(_t(toks)))[0].tolist() == _alone(jp, toks[0], 4)


@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
def test_llm_serve_cli_pipeline_matches_reference(pipe_params, attn_impl):
    jp, path = pipe_params
    p = parse_pipeline(
        "tensorsrc dimensions=4:1 types=int32 num-frames=2 pattern=ones ! "
        f'tensor_llm_serversink id=tc-{attn_impl} custom="{PIPE_OPTS},params:{path}" '
        f"max-new-tokens=3 n-slots=2 max-len=32 prompt-len=8 attn-impl={attn_impl} "
        f"tensor_llm_serversrc id=tc-{attn_impl} ! tensor_sink name=out",
        device="cpu",
    )
    p.run(timeout=120)
    frames = p["out"].frames
    assert len(frames) == 2
    want = _alone(jp, np.ones(4, np.int32), 3)
    for f in frames:
        assert f.tensors[0].shape == (1, 3) and f.tensors[0].dtype == np.int32
        assert f.tensors[0][0].tolist() == want


def test_llm_serve_appsrc_roundtrip_matches_reference(pipe_params):
    """appsrc prompts → server pair → appsink: meta rides through, tokens
    equal the JAX decode.generate alone for every request."""
    from nnstreamer_tpu_torch.elements.llm_serve import LlmServerSink, LlmServerSrc
    from nnstreamer_tpu_torch.elements.sink import AppSink
    from nnstreamer_tpu_torch.elements.sources import AppSrc
    from nnstreamer_tpu_torch.pipeline.graph import Pipeline
    from nnstreamer_tpu_torch.tensors.frame import Frame
    from nnstreamer_tpu_torch.tensors.spec import TensorFormat, TensorsSpec

    jp, path = pipe_params
    rng = np.random.default_rng(0)
    prompts = {f"req{i}": rng.integers(1, 211, (4 + 3 * i,)).astype(np.int32)
               for i in range(3)}
    src = AppSrc(spec=TensorsSpec(format=TensorFormat.FLEXIBLE))
    sink = LlmServerSink(**{"id": "ta0", "custom": f"{PIPE_OPTS},params:{path}",
                            "n-slots": 2, "max-len": 64, "prompt-len": 16,
                            "max-new-tokens": 6, "pump": 2})
    out_sink = AppSink()
    p = Pipeline(device="cpu").chain(src, sink)
    p.chain(LlmServerSrc(**{"id": "ta0"}), out_sink)
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
    finally:
        p.stop()
    for name, prompt in prompts.items():
        assert results[name] == _alone(jp, prompt, 6), name
