"""Port parity for single-stream speculative decoding
(``nnstreamer_tpu_torch/models/speculative.py``) and the zoo's
``decode=ngram``: the same numpy-seeded prompts through the JAX functions
and the port's, with the JAX weights carried over with
``transformer_from_jax``. The cases of ``tests/test_speculative.py``
(draft and n-gram generation, the scanned program, the zoo wiring) plus
the n-gram lookup on random contexts.

Tolerances: token ids and accepted counts identical, after a check that
the JAX model's greedy streams have no near-tie (top-2 margin above 1e-4
in the no-cache logits), so a flip would be a fault.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nnstreamer_tpu.models import decode as jdec
from nnstreamer_tpu.models import speculative as jspec
from nnstreamer_tpu.models import transformer as jtfm
from nnstreamer_tpu.models import zoo as jzoo
from nnstreamer_tpu_torch.models import speculative as tspec
from nnstreamer_tpu_torch.models import transformer as ttfm
from nnstreamer_tpu_torch.models import zoo as tzoo
from nnstreamer_tpu_torch.models.jax_weights import transformer_from_jax

VOCAB, N_HEADS = 211, 4
MARGIN = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pair(seed, d_model, n_heads, n_layers):
    jp = jtfm.init_params(jax.random.PRNGKey(seed), vocab=VOCAB, d_model=d_model,
                          n_heads=n_heads, n_layers=n_layers)
    lm = ttfm.TransformerLM(VOCAB, d_model, n_heads, n_layers)
    lm.load_state_dict(transformer_from_jax(jax.tree_util.tree_map(np.asarray, jp)))
    return jp, lm


@pytest.fixture(scope="module")
def target():
    return _pair(0, 64, N_HEADS, 3)


@pytest.fixture(scope="module")
def draft():
    # smaller and seeded apart: a partial agreement
    return _pair(9, 32, 2, 1)


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(1, VOCAB, (1, n)).astype(np.int32)


PROMPTS = {"p12": _prompt(12, 1), "p8": _prompt(8, 2), "p5": _prompt(5, 3), "p14": _prompt(14, 7),
           "pattern": np.asarray([[7, 11, 13, 7, 11, 13, 7, 11, 13, 7, 11]], np.int32)}
BUDGET = 16


@pytest.fixture(scope="module")
def alone(target):
    """{name: the JAX target's greedy stream of BUDGET tokens}."""
    jp = target[0]
    return {n: np.asarray(jdec.generate(jp, jnp.asarray(p), N_HEADS, BUDGET))[0].tolist()
            for n, p in PROMPTS.items()}


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_reference_streams_are_not_near_ties(target, alone):
    jp = target[0]
    for name, p in PROMPTS.items():
        toks = alone[name]
        seq = jnp.asarray(np.concatenate([p[0], toks[:-1]])[None])
        logits = np.asarray(jtfm.apply(jp, seq, N_HEADS))[0, p.shape[1] - 1:]
        top2 = np.sort(logits, axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > MARGIN, name
        assert logits.argmax(-1).tolist() == toks


@pytest.mark.parametrize("k", [2, 4])
def test_speculative_generate_matches_reference(target, draft, alone, k):
    """The draft-model loop: the target's greedy stream, and the JAX
    loop's acceptance lengths round by round."""
    (jp, lm), (jd, dlm) = target, draft
    p = PROMPTS["p12"]
    toks, lens = tspec.speculative_generate(lm, dlm, _t(p), N_HEADS, BUDGET, draft_n_heads=2,
                                            k=k)
    jtoks, jlens = jspec.speculative_generate(jp, jd, jnp.asarray(p), N_HEADS, BUDGET,
                                              draft_n_heads=2, k=k)
    assert toks[0].tolist() == np.asarray(jtoks)[0].tolist() == alone["p12"]
    assert lens == jlens and len(lens) >= 1


def test_self_draft_accepts_everything(target, alone):
    jp, lm = target
    toks, lens = tspec.speculative_generate(lm, lm, _t(PROMPTS["p8"]), N_HEADS, 12, k=4)
    assert toks[0].tolist() == alone["p8"][:12]
    assert all(a == 3 for a in lens[:-1])


def test_single_token_and_validation(target, draft, alone):
    (_, lm), (_, dlm) = target, draft
    toks, _ = tspec.speculative_generate(lm, dlm, _t(PROMPTS["p5"]), N_HEADS, 1,
                                         draft_n_heads=2, k=2)
    assert toks[0].tolist() == alone["p5"][:1]
    with pytest.raises(ValueError, match="B=1"):
        tspec.speculative_generate(lm, dlm, torch.zeros((2, 4), dtype=torch.int32), N_HEADS, 4)
    with pytest.raises(ValueError, match="k must be"):
        tspec.speculative_generate(lm, dlm, _t(PROMPTS["p5"]), N_HEADS, 4, k=1)
    for fn in (tspec.ngram_speculative_generate, tspec.ngram_generate_scanned):
        with pytest.raises(ValueError, match="B=1"):
            fn(lm, torch.zeros((2, 4), dtype=torch.int32), N_HEADS, 4)
    toks, _ = tspec.ngram_speculative_generate(lm, _t(PROMPTS["p5"]), N_HEADS, 1)
    assert toks[0].tolist() == alone["p5"][:1]


@pytest.mark.parametrize("name", ["p14", "pattern"])
def test_ngram_speculative_generate_matches_reference(target, alone, name):
    """Prompt-lookup speculation: the target's stream and the JAX loop's
    acceptance lengths; on the periodic prompt some lookups land."""
    jp, lm = target
    p = PROMPTS[name]
    toks, lens = tspec.ngram_speculative_generate(lm, _t(p), N_HEADS, BUDGET)
    jtoks, jlens = jspec.ngram_speculative_generate(jp, jnp.asarray(p), N_HEADS, BUDGET)
    assert toks[0].tolist() == np.asarray(jtoks)[0].tolist() == alone[name]
    assert lens == jlens
    if name == "pattern":
        assert max(lens) > 0


@pytest.mark.parametrize("k,g", [(4, 2), (4, 1), (3, 2), (6, 3)])
@pytest.mark.parametrize("name", ["p14", "pattern"])
def test_ngram_generate_scanned_matches_reference(target, alone, name, k, g):
    """The one-program loop: tokens and the accepted total equal the JAX
    program's, and the target's greedy stream."""
    jp, lm = target
    p = PROMPTS[name]
    toks, acc = tspec.ngram_generate_scanned(lm, _t(p), N_HEADS, BUDGET, k=k, g=g)
    jtoks, jacc = jspec.ngram_generate_scanned(jp, jnp.asarray(p), N_HEADS, BUDGET, k=k, g=g)
    assert toks[0].tolist() == np.asarray(jtoks)[0].tolist() == alone[name]
    assert acc == int(jacc)
    if name == "pattern" and g == 1:
        assert acc > 0


def test_zoo_decode_ngram_matches_the_reference_zoo(tmp_path):
    """zoo:transformer_lm decode=ngram runs the scanned program, with
    spec_k and spec_ngram: the JAX zoo's tokens on its own weights (an
    npz of its seed-0 tree loaded through params:); not captured."""
    jp = jtfm.init_params(jax.random.PRNGKey(0), vocab=VOCAB, d_model=32, n_heads=2,
                          n_layers=2)
    path = tmp_path / "lm.npz"
    np.savez(path, **{f"p{i}": np.asarray(x)
                      for i, x in enumerate(jax.tree_util.tree_leaves(jp))})
    prompt = np.random.default_rng(1).integers(1, VOCAB, (1, 20)).astype(np.int32)
    for extra in ({}, {"spec_k": "3", "spec_ngram": "1"}):
        opts = dict(vocab=str(VOCAB), d_model="32", n_heads="2", n_layers="2", seqlen="20",
                    generate="8", decode="ngram", **extra)
        m = tzoo.get("transformer_lm", device="cpu", params=str(path), **opts)
        assert m.module.CAPTURABLE is False
        got = m.module(_t(prompt))
        want = np.asarray(jzoo.get("transformer_lm", **opts).fn(jnp.asarray(prompt)))
        assert got.tolist() == want.tolist()
        k, g = int(extra.get("spec_k", 4)), int(extra.get("spec_ngram", 2))
        direct, _ = jspec.ngram_generate_scanned(jp, jnp.asarray(prompt), 2, 8, k=k, g=g)
        assert got.tolist() == np.asarray(direct).tolist()


def test_ngram_lookup_and_propose_match_reference():
    """The host lookup on random contexts over a small alphabet (many
    repeats), every n-gram and width, and the zero-padded proposal."""
    rng = np.random.default_rng(4)
    for _ in range(200):
        ctx = rng.integers(0, 4, (int(rng.integers(1, 30)),)).astype(np.int32)
        for ngram in (1, 2, 3):
            for k in (1, 3, 5):
                got = tspec.ngram_lookup(ctx, k, ngram)
                want = jspec.ngram_lookup(ctx, k, ngram)
                assert (got is None) == (want is None)
                if got is not None:
                    assert got.tolist() == want.tolist()
                assert tspec.ngram_propose(ctx, k, ngram).tolist() == \
                    jspec.ngram_propose(ctx, k, ngram).tolist()
