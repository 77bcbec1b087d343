"""Port parity for weight-only int8 (``models/quantize.py``, LM half) and
beam search (``models/decode.py beam_search``) of nnstreamer_tpu_torch
against the JAX package, on numpy-seeded inputs and JAX weights carried
over with ``transformer_from_jax`` (or ``params:``).

Tolerances:

- ``quantize_weight``: int8 payloads bit-identical, scales within one
  float32 ulp (the same division, in another framework).
- Logits: atol 1e-4 (XLA's and PyTorch's CPU matmuls sum in other
  orders; the dequantized weights are equal).
- Tokens: identical; beam scores within 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nnstreamer_tpu.models import decode as jdec
from nnstreamer_tpu.models import quantize as jqz
from nnstreamer_tpu.models import transformer as jtfm
from nnstreamer_tpu.models import zoo as jzoo
from nnstreamer_tpu.pipeline.parse import parse_pipeline as jax_parse
from nnstreamer_tpu_torch import cli
from nnstreamer_tpu_torch.models import decode as tdec
from nnstreamer_tpu_torch.models import quantize as tqz
from nnstreamer_tpu_torch.models import transformer as ttfm
from nnstreamer_tpu_torch.models import zoo as tzoo
from nnstreamer_tpu_torch.models.jax_weights import transformer_from_jax
from nnstreamer_tpu_torch.models.serving import ContinuousBatcher

from test_golden import GOLDEN_DIR, PIPELINES

VOCAB, D_MODEL, N_HEADS, N_KV, N_LAYERS = 211, 64, 4, 2, 2


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


def _models(seed=5, quantize=False):
    jp = jtfm.init_params(jax.random.PRNGKey(seed), vocab=VOCAB, d_model=D_MODEL,
                          n_heads=N_HEADS, n_layers=N_LAYERS, n_kv_heads=N_KV)
    lm = ttfm.TransformerLM(VOCAB, D_MODEL, N_HEADS, N_LAYERS, n_kv_heads=N_KV)
    lm.load_state_dict(transformer_from_jax(jax.tree_util.tree_map(np.asarray, jp)))
    if quantize:
        jp = jqz.quantize_lm_weights(jp)
        tqz.quantize_lm_weights(lm)
    return jp, lm


@pytest.fixture(scope="module")
def models():
    return _models()


@pytest.fixture(scope="module")
def qmodels():
    return _models(quantize=True)


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(1, VOCAB, (1, n)).astype(np.int32)


# -- quantize_weight -----------------------------------------------------------------------


def _weight_cin_cout(seed):
    """A reference-layout [cin, cout] weight with an all-zero output channel
    and one whose quotients fall on halves (127, 0.5, 1.5, 2.5, -0.5 over a
    scale of exactly 1: round-half-even gives 0, 2, 2, -0)."""
    w = np.random.default_rng(seed).standard_normal((40, 24)).astype(np.float32)
    w[:, 3] = 0.0
    w[:, 7] = 0.0
    w[:5, 7] = [127.0, 0.5, 1.5, 2.5, -0.5]
    return w


def test_quantize_weight_bit_identical_to_reference():
    w = _weight_cin_cout(1)
    want = jqz.quantize_weight(jnp.asarray(w))
    got = tqz.quantize_weight(_t(w.T), axis=-1)  # the port's [cout, cin]
    assert got.w8.dtype == torch.int8 and got.scale.shape == (24, 1)
    np.testing.assert_array_equal(got.w8.numpy().T, np.asarray(want["w8"]))
    np.testing.assert_array_max_ulp(got.scale.numpy().T, np.asarray(want["scale"]), maxulp=1)
    assert got.w8[7, :5].tolist() == [127, 0, 2, 2, 0] and not got.w8[3].any()
    assert float(got.scale[3, 0]) == np.float32(np.float32(1e-8) / np.float32(127.0))


def test_quantize_embedding_keeps_per_feature_scales():
    e = np.random.default_rng(2).standard_normal((VOCAB, D_MODEL)).astype(np.float32)
    e[:, 5] = 0.0
    want = jqz.quantize_weight(jnp.asarray(e))
    got = tqz.quantize_weight(_t(e), axis=-2)
    assert got.scale.shape == (1, D_MODEL)
    np.testing.assert_array_equal(got.w8.numpy(), np.asarray(want["w8"]))
    np.testing.assert_array_max_ulp(got.scale.numpy(), np.asarray(want["scale"]), maxulp=1)


def test_quantize_lm_weights_matches_reference_tree(qmodels):
    """Every quantized leaf of the reference tree against the port's
    buffers (blocks transposed to [cout, cin]); norms stay float32."""
    jp, lm = qmodels
    for i, blk in enumerate(lm.blocks):
        for name in tqz.LM_QUANT_KEYS:
            q = getattr(blk, name).weight
            assert isinstance(q, ttfm.QuantizedWeight)
            np.testing.assert_array_equal(q.w8.numpy().T, np.asarray(jp["blocks"][name]["w8"][i]))
            np.testing.assert_array_max_ulp(q.scale.numpy().T,
                                            np.asarray(jp["blocks"][name]["scale"][i]), maxulp=1)
    np.testing.assert_array_equal(lm.embed.w8.numpy(), np.asarray(jp["embed"]["w8"]))
    np.testing.assert_array_equal(lm.head.weight.w8.numpy().T, np.asarray(jp["head"]["w8"]))
    assert lm.blocks[0].ln1.dtype == torch.float32 and lm.ln_f.dtype == torch.float32
    assert lm.d_model == D_MODEL and lm.n_kv_heads == N_KV
    assert not any(p.dtype != torch.float32 for p in lm.parameters())
    assert {b.dtype for b in lm.buffers()} == {torch.int8, torch.float32}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8w_logits_match_reference(qmodels, dtype):
    jp, lm = qmodels
    toks = _prompt(13, 3)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32,
                                                                           torch.float32)
    want = np.asarray(jtfm.apply(jp, jnp.asarray(toks), N_HEADS, compute_dtype=jdt), np.float32)
    got = ttfm.apply(lm, _t(toks), N_HEADS, compute_dtype=tdt).numpy()
    # bfloat16 rounds at other places in the two frameworks
    atol = 1e-4 if dtype == "float32" else 2e-2 * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def test_int8w_decode_and_serving_read_quantized_weights(qmodels):
    """Greedy decode through the cache and the slot batcher on the int8w
    model give the reference's int8w tokens."""
    jp, lm = qmodels
    prompts = [_prompt(n, 10 + n)[0] for n in (5, 9, 12)]
    want = [np.asarray(jdec.generate(jp, jnp.asarray(p[None]), N_HEADS, 6))[0].tolist()
            for p in prompts]
    assert [tdec.generate(lm, _t(p[None]), N_HEADS, 6)[0].tolist() for p in prompts] == want
    cb = ContinuousBatcher(lm, N_HEADS, n_slots=2, max_len=32, prompt_len=16, device="cpu")
    rids = []
    for p in prompts:
        while (rid := cb.submit(p, 6)) is None:
            cb.step()
        rids.append(rid)
    while any(cb.result(r) is None for r in rids):
        cb.step()
    assert [cb.result(r) for r in rids] == want


@pytest.fixture(scope="module")
def golden_npz(tmp_path_factory):
    """The reference zoo's weights for the filter_lm_int8w golden (seed 0)
    as an npz of leaves p{i}."""
    jp = jtfm.init_params(jax.random.PRNGKey(0), 512, 64, 4, 2)
    path = tmp_path_factory.mktemp("int8w") / "lm.npz"
    np.savez(path, **{f"p{i}": np.asarray(x) for i, x in enumerate(jax.tree_util.tree_leaves(jp))})
    return str(path)


def test_golden_filter_lm_int8w(golden_npz, tmp_path):
    """The filter_lm_int8w golden through the port's CLI (params added)
    and the reference's pipeline: the same tokens, the golden's bytes."""
    desc = PIPELINES["filter_lm_int8w"].replace('seqlen:16"', f'seqlen:16,params:{golden_npz}"')
    assert golden_npz in desc
    out = tmp_path / "port.raw"
    assert cli.main(["--device", "cpu", "-q", desc.format(out=out)]) == 0
    ref_out = tmp_path / "ref.raw"
    jax_parse(desc.format(out=ref_out)).run(timeout=120)
    with open(f"{GOLDEN_DIR}/filter_lm_int8w.raw", "rb") as f:
        golden = f.read()
    assert out.read_bytes() == ref_out.read_bytes() == golden


def test_zoo_quantize_refuses_unknown_scheme():
    with pytest.raises(ValueError, match="int8w"):
        tzoo.get("transformer_lm", device="cpu", vocab="16", d_model="16", n_heads="2",
                 n_layers="1", quantize="int4")


# -- beam search -----------------------------------------------------------------------------


def test_top_k_order_matches_lax_top_k():
    """Ties come lower index first, as jax.lax.top_k gives them."""
    rng = np.random.default_rng(4)
    for n, k in ((64, 8), (1000, 5), (7, 7)):
        x = rng.choice(np.float32([-1.5, 0.0, 0.25, 3.0]), n)
        vals, idx = tdec.top_k_lower_first(_t(x), k)
        jvals, jidx = jax.lax.top_k(jnp.asarray(x), k)
        assert idx.tolist() == np.asarray(jidx).tolist()
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


@pytest.mark.parametrize("quantize", [False, True])
def test_beam_search_matches_reference(models, qmodels, quantize):
    jp, lm = qmodels if quantize else models
    for n, seed in ((7, 1), (11, 2)):
        p = _prompt(n, seed)
        want_toks, want_score = jdec.beam_search(jp, jnp.asarray(p), N_HEADS, 6, beam_width=3)
        got_toks, got_score = tdec.beam_search(lm, _t(p), N_HEADS, 6, beam_width=3)
        assert got_toks.dtype == torch.int32 and got_toks.shape == (1, 6)
        assert got_toks[0].tolist() == np.asarray(want_toks)[0].tolist()
        assert abs(got_score - want_score) <= 1e-4


def test_beam_width_one_is_greedy(models):
    jp, lm = models
    for n, seed in ((5, 3), (14, 4)):
        p = _prompt(n, seed)
        toks, _ = tdec.beam_search(lm, _t(p), N_HEADS, 7, beam_width=1)
        assert toks[0].tolist() == tdec.generate(lm, _t(p), N_HEADS, 7)[0].tolist()
        assert toks[0].tolist() == np.asarray(jdec.generate(jp, jnp.asarray(p), N_HEADS, 7))[0]\
            .tolist()


def test_beam_search_ties_take_the_lower_token(models):
    """A zero head makes every logit equal: every step is a W-way tie, and
    both packages keep the lowest token ids, parent beams in order."""
    jp, lm = models
    jp0 = dict(jp, head=jnp.zeros_like(jp["head"]))
    lm0 = ttfm.TransformerLM(VOCAB, D_MODEL, N_HEADS, N_LAYERS, n_kv_heads=N_KV)
    lm0.load_state_dict(lm.state_dict())
    lm0.head.weight.zero_()
    p = _prompt(6, 5)
    want, want_score = jdec.beam_search(jp0, jnp.asarray(p), N_HEADS, 4, beam_width=3)
    got, got_score = tdec.beam_search(lm0, _t(p), N_HEADS, 4, beam_width=3)
    assert got[0].tolist() == np.asarray(want)[0].tolist() == [0, 0, 0, 0]
    assert abs(got_score - want_score) <= 1e-4


def test_beam_search_serves_one_stream(models):
    _, lm = models
    with pytest.raises(ValueError, match="B=1"):
        tdec.beam_search(lm, _t(np.zeros((2, 4), np.int32)), N_HEADS, 3)


@pytest.fixture(scope="module")
def beam_npz(tmp_path_factory):
    jp = jtfm.init_params(jax.random.PRNGKey(8), VOCAB, D_MODEL, N_HEADS, N_LAYERS,
                          n_kv_heads=N_KV)
    path = tmp_path_factory.mktemp("beam") / "lm.npz"
    np.savez(path, **{f"p{i}": np.asarray(x) for i, x in enumerate(jax.tree_util.tree_leaves(jp))})
    return str(path)


@pytest.mark.parametrize("extra", [{}, {"quantize": "int8w"}])
def test_zoo_decode_beam_matches_reference(beam_npz, extra):
    opts = dict(vocab=str(VOCAB), d_model=str(D_MODEL), n_heads=str(N_HEADS),
                n_kv_heads=str(N_KV), n_layers=str(N_LAYERS), params=beam_npz, generate="5",
                decode="beam", beam_width="3", **extra)
    p = _prompt(10, 6)
    got = tzoo.get("transformer_lm", device="cpu", **opts).module(_t(p))
    want = jzoo.get("transformer_lm", **opts).fn(jnp.asarray(p))
    assert got[0].tolist() == np.asarray(want)[0].tolist()

