"""Port parity for the long-context forward slice: the flash-attention
kernel's plain version (K5), the transformer's restored ``attn_fn`` and
``causal`` hooks, and ``zoo:transformer_lm attn=flash`` of
nnstreamer_tpu_torch against the JAX package, on numpy-seeded inputs and
JAX weights carried over with ``transformer_from_jax`` (or ``params:``).

Tolerances:

- K5: atol 2e-5 against the reference's Pallas kernel in interpret mode
  (and ``dense_attention`` for ``serve-512`` and for float16, which the
  reference's kernel does not take), bfloat16 and float16 inputs included:
  both widen to float32 before any product, so only the summation order
  of float32 dot products differs (the reference's own tolerance,
  ``tests/test_pallas.py``). Head dims: the plain version takes any D.
- Logits, float32 compute: atol 1e-4 (``tests/test_pallas.py``'s for the
  flash-plugged transformer). bfloat16 compute: within 2e-2 of max |logit|
  against the reference (bfloat16 rounds at other places in the two
  frameworks), and within 1e-2 of max |logit| against the port's own dense
  forward (the attention outputs differ in float32 summation order before
  their cast to bfloat16). float16 compute: within 5e-3 (about ten float16
  roundings, 2^-11 each) of max |logit| against the reference, whose flash
  attention degrades to dense attention in float16, and within 2.5e-3
  against the port's own dense forward.
- Tokens: identical.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nnstreamer_tpu.models import decode as jdec
from nnstreamer_tpu.models import transformer as jtfm
from nnstreamer_tpu.models import zoo as jzoo
from nnstreamer_tpu.ops.pallas import registry as kernel_registry
from nnstreamer_tpu.ops.pallas.flash_attention import (
    flash_attention as jflash,
    make_flash_attention as jmake_flash,
)
from nnstreamer_tpu.parallel.ring_attention import dense_attention as jdense
from nnstreamer_tpu_torch.models import transformer as ttfm
from nnstreamer_tpu_torch.models import zoo as tzoo
from nnstreamer_tpu_torch.models.jax_weights import transformer_from_jax
from nnstreamer_tpu_torch.ops.kernels import flash_attention as tfa
from nnstreamer_tpu_torch.pipeline.parse import parse_pipeline
from nnstreamer_tpu_torch.single import SingleShot

VOCAB, D_MODEL, N_HEADS, N_LAYERS = 97, 64, 4, 2


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


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


def _qkv(params, seed=0):
    rng = np.random.default_rng(seed)
    b, t = params.get("b", 1), params["t"]
    h, d = params.get("h", 2), params.get("d", 64)
    return [rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(3)]


# -- K5: the plain version against the reference's Pallas kernel ---------------------------

K5_CASES = [(c.name, c.params) for c in kernel_registry.get("flash_attention").cases] + [
    # a sequence below the 16-row floor, and a ragged T with unequal heads and dims
    ("t5-floor", {"b": 1, "t": 5, "h": 2, "d": 16, "block_q": 16, "block_k": 16}),
    ("t37-ragged-bf16", {"b": 2, "t": 37, "h": 3, "d": 32, "block_q": 16, "block_k": 16,
                         "dtype": "bfloat16", "causal": False}),
    # head dims outside {16, 32, 64, 128, 256}: the kernel's multiples of 8 (8 is
    # the reference's own probe) and an odd one that only the plain version takes
    ("d8", {"b": 1, "t": 16, "h": 1, "d": 8, "block_q": 16, "block_k": 16}),
    ("d24-ragged", {"b": 1, "t": 40, "h": 2, "d": 24, "block_q": 16, "block_k": 16}),
    ("d48-bf16", {"b": 2, "t": 32, "h": 2, "d": 48, "block_q": 16, "block_k": 16,
                  "dtype": "bfloat16"}),
    ("d80-full", {"b": 1, "t": 24, "h": 2, "d": 80, "block_q": 16, "block_k": 16,
                  "causal": False}),
    ("d96", {"b": 1, "t": 48, "h": 2, "d": 96, "block_q": 16, "block_k": 16}),
    ("d12-odd", {"b": 1, "t": 20, "h": 3, "d": 12, "block_q": 16, "block_k": 16}),
    # the widest instances the kernel pads to (128, 256) and one just past 128
    ("d128-bf16-ragged", {"b": 1, "t": 20, "h": 2, "d": 128, "block_q": 16, "block_k": 16,
                          "dtype": "bfloat16"}),
    ("d136", {"b": 1, "t": 16, "h": 1, "d": 136, "block_q": 16, "block_k": 16}),
    ("d256", {"b": 1, "t": 16, "h": 2, "d": 256, "block_q": 16, "block_k": 16}),
    ("d256-bf16-full", {"b": 1, "t": 24, "h": 1, "d": 256, "block_q": 16, "block_k": 16,
                        "dtype": "bfloat16", "causal": False}),
    # float16: the reference's kernel does not take it, so dense_attention on the
    # same float16 inputs (it upcasts to float32) is the reference
    ("f16", {"b": 2, "t": 40, "h": 2, "d": 32, "block_q": 16, "block_k": 16,
             "dtype": "float16"}),
    ("f16-d64-full", {"b": 1, "t": 24, "h": 2, "d": 64, "block_q": 16, "block_k": 16,
                      "dtype": "float16", "causal": False}),
    ("f16-d200", {"b": 1, "t": 20, "h": 2, "d": 200, "block_q": 16, "block_k": 16,
                  "dtype": "float16"}),
]


@pytest.mark.parametrize("name,params", K5_CASES, ids=[c[0] for c in K5_CASES])
def test_k5_plain_matches_reference(name, params):
    q, k, v = _qkv(params)
    causal = params.get("causal", True)
    blocks = dict(block_q=params.get("block_q", 128), block_k=params.get("block_k", 128))
    dtype = params.get("dtype", "float32")
    jq, jk, jv = (jnp.asarray(a).astype(dtype) for a in (q, k, v))
    tq, tk, tv = (_t(a).to(getattr(torch, dtype)) for a in (q, k, v))
    # every multiple of 8 up to 256 runs on the card too; any other D only here
    assert tfa.kernel_takes_head_dim(q.shape[-1]) == (q.shape[-1] % 8 == 0)
    before = tfa.flash_attention_launches.count
    got = tfa.flash_attention(tq, tk, tv, causal=causal, **blocks)
    assert tfa.flash_attention_launches.count == before  # the CPU runs the plain version
    assert got.dtype == torch.float32 and got.shape == tq.shape and got.is_contiguous()
    torch.testing.assert_close(got, tfa.plain_flash_attention(tq, tk, tv, causal, **blocks),
                               rtol=0, atol=0)
    if name == "serve-512" or dtype == "float16":
        # the interpreter would take minutes at serve-512's size; the reference's
        # kernel does not take float16
        want = jax.jit(jdense, static_argnames="causal")(jq, jk, jv, causal=causal)
    else:
        want = jflash(jq, jk, jv, causal=causal, interpret=True, **blocks)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-5, rtol=0)


def test_k5_block_sizes_change_only_the_summation_order():
    q, k, v = (_t(a) for a in _qkv({"b": 2, "t": 100, "h": 2, "d": 32}, seed=4))
    outs = [tfa.plain_flash_attention(q, k, v, True, block_q=bq, block_k=bk)
            for bq, bk in ((16, 16), (32, 16), (128, 128), (16, 64))]
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], rtol=0, atol=2e-6)
    torch.testing.assert_close(outs[0], ttfm.dense_attention(q, k, v), rtol=0, atol=2e-6)


def test_k5_accepts_a_strided_view_on_the_cpu():
    """The transformer hands K5 a V sliced out of the fused projection:
    a view whose last axis is contiguous."""
    rng = np.random.default_rng(8)
    fused = _t(rng.standard_normal((2, 20, 3 * 2 * 16)).astype(np.float32))
    q, k, v = (fused[..., i * 32:(i + 1) * 32].reshape(2, 20, 2, 16) for i in range(3))
    assert not v.is_contiguous()
    got = tfa.flash_attention(q, k, v, causal=True)
    want = tfa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.int32])
def test_k5_refuses_unsupported_dtypes(dtype):
    q = torch.zeros((1, 8, 2, 16), dtype=dtype)
    before = tfa.flash_attention_launches.count
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        tfa.flash_attention(q, q, q)
    assert tfa.flash_attention_launches.count == before


@pytest.mark.parametrize("shapes", [
    ((1, 8, 2, 16), (1, 8, 2, 16), (1, 9, 2, 16)),   # unequal shapes
    ((8, 2, 16),) * 3,                                # not [B, T, H, D]
])
def test_k5_refuses_bad_shapes(shapes):
    q, k, v = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError):
        tfa.flash_attention(q, k, v)


@pytest.mark.parametrize("d", [4, 12, 100, 264, 512])
def test_k5_kernel_path_refuses_other_head_dims_before_a_launch(d):
    """The CUDA path checks D before it builds or launches anything (these
    CPU tensors never reach the card): D % 8 != 0 or D > 256 raises
    ValueError and leaves the launch count as it was. The plain version
    takes the same D."""
    assert not tfa.kernel_takes_head_dim(d)
    q = torch.zeros((1, 8, 2, d))
    before = tfa.flash_attention_launches.count
    with pytest.raises(ValueError, match="D % 8 == 0"):
        tfa._cuda_flash_attention(q, q, q, True, 1.0)
    assert tfa.flash_attention_launches.count == before
    assert tfa.flash_attention(q, q, q).shape == q.shape


# -- the transformer's attn_fn hook --------------------------------------------------------


def _models(n_kv, seed):
    jp = jtfm.init_params(jax.random.PRNGKey(seed), vocab=VOCAB, d_model=D_MODEL,
                          n_heads=N_HEADS, n_layers=N_LAYERS, n_kv_heads=n_kv)
    lm = ttfm.TransformerLM(VOCAB, D_MODEL, N_HEADS, N_LAYERS, n_kv_heads=n_kv)
    lm.load_state_dict(transformer_from_jax(jax.tree_util.tree_map(np.asarray, jp)))
    return jp, lm


@pytest.fixture(scope="module")
def mha():
    return _models(N_HEADS, 3)


@pytest.fixture(scope="module")
def gqa():
    return _models(2, 9)


@pytest.mark.parametrize("kind", ["mha", "gqa"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_transformer_flash_matches_reference(request, kind, dtype):
    """T 24 with 16-row blocks: the reference pads to 32 and masks."""
    jp, lm = request.getfixturevalue(kind)
    toks = np.random.default_rng(3).integers(0, VOCAB, (2, 24)).astype(np.int32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32,
                                                                           torch.float32)
    want = jtfm.apply(jp, jnp.asarray(toks), N_HEADS, compute_dtype=jdt,
                      attn_fn=jmake_flash(interpret=True, block_q=16, block_k=16))
    before = tfa.flash_attention_launches.count
    got = ttfm.apply(lm, _t(toks), N_HEADS, attn_fn=tfa.make_flash_attention(
        block_q=16, block_k=16), compute_dtype=tdt)
    dense = ttfm.apply(lm, _t(toks), N_HEADS, compute_dtype=tdt)
    assert tfa.flash_attention_launches.count == before
    assert got.dtype == torch.float32 and got.shape == (2, 24, VOCAB)
    scale = float(np.abs(np.asarray(want)).max())
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-4, rtol=0)
        np.testing.assert_allclose(_np(got), _np(dense), atol=1e-4, rtol=0)
    else:
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), atol=2e-2 * scale,
                                   rtol=0)
        np.testing.assert_allclose(_np(got), _np(dense), atol=1e-2 * scale, rtol=0)


def test_default_attention_is_unchanged(mha):
    """attn_fn=None is dense_attention, bit for bit, and causal=False turns
    a block into an encoder block (the reference's ViT form)."""
    jp, lm = mha
    rng = np.random.default_rng(5)
    toks = _t(rng.integers(0, VOCAB, (1, 12)).astype(np.int32))
    torch.testing.assert_close(ttfm.apply(lm, toks, N_HEADS),
                               ttfm.apply(lm, toks, N_HEADS, attn_fn=ttfm.dense_attention),
                               rtol=0, atol=0)
    x = rng.standard_normal((1, 12, D_MODEL)).astype(np.float32)
    pos = np.arange(12)
    blk = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"])
    for causal in (True, False):
        want = jtfm.block_apply(jnp.asarray(x), blk, N_HEADS, jnp.asarray(pos), causal=causal)
        got = ttfm.block_apply(_t(x), lm.blocks[0], N_HEADS, _t(pos), causal=causal)
        flash = ttfm.block_apply(_t(x), lm.blocks[0], N_HEADS, _t(pos),
                                 attn_fn=tfa.make_flash_attention(), causal=causal)
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5, rtol=0)
        np.testing.assert_allclose(_np(flash), np.asarray(want), atol=1e-5, rtol=0)


# -- the zoo, SingleShot and the CLI -------------------------------------------------------

ZOO_OPTS = f"vocab:{VOCAB},d_model:{D_MODEL},n_heads:{N_HEADS},n_kv_heads:2,n_layers:2"


@pytest.fixture(scope="module")
def zoo_npz(tmp_path_factory):
    """The JAX zoo's transformer_lm weights for ZOO_OPTS as an npz of leaves
    p{i}: both packages load it through ``params:``."""
    jp = jtfm.init_params(jax.random.PRNGKey(12), VOCAB, D_MODEL, N_HEADS, 2, n_kv_heads=2)
    path = tmp_path_factory.mktemp("flash") / "lm.npz"
    np.savez(path, **{f"p{i}": np.asarray(x)
                      for i, x in enumerate(jax.tree_util.tree_leaves(jp))})
    return str(path)


def _opts(extra=""):
    return dict(kv.split(":") for kv in (ZOO_OPTS + extra).split(","))


def test_zoo_flash_singleshot_matches_reference(zoo_npz):
    toks = np.random.default_rng(21).integers(0, VOCAB, (1, 40)).astype(np.int32)
    ref = jzoo.get("transformer_lm", **_opts(f",seqlen:40,attn:flash,params:{zoo_npz}"))
    want = np.asarray(ref.fn(jnp.asarray(toks)))
    custom = f"{ZOO_OPTS},seqlen:40,attn:flash,params:{zoo_npz}"
    with SingleShot(framework="torch", model="zoo:transformer_lm", custom=custom,
                    device="cpu") as s:
        (got,) = s.invoke(toks)
    np.testing.assert_allclose(_np(got), want, atol=1e-4, rtol=0)


def test_zoo_flash_float16_matches_reference(zoo_npz):
    """compute_dtype=float16 with attn=flash: the reference degrades its flash
    attention to dense attention in float16 (its kernel takes float32 and
    bfloat16); the port runs K5 on the float16 q, k, v (its plain version
    on the CPU)."""
    toks = np.random.default_rng(24).integers(0, VOCAB, (1, 40)).astype(np.int32)
    extra = f",seqlen:40,compute_dtype:float16,params:{zoo_npz}"
    ref = jzoo.get("transformer_lm", **_opts(extra + ",attn:flash"))
    want = np.asarray(ref.fn(jnp.asarray(toks)), np.float32)
    before = tfa.flash_attention_launches.count
    got = tzoo.get("transformer_lm", device="cpu", **_opts(extra + ",attn:flash")).module(
        _t(toks))
    dense = tzoo.get("transformer_lm", device="cpu", **_opts(extra)).module(_t(toks))
    assert tfa.flash_attention_launches.count == before
    assert got.dtype == torch.float32 and got.shape == (1, 40, VOCAB)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(_np(got), want, atol=5e-3 * scale, rtol=0)
    np.testing.assert_allclose(_np(got), _np(dense), atol=2.5e-3 * scale, rtol=0)


def test_zoo_quantize_other_than_int8w_raises_where_the_reference_ignores_it(zoo_npz):
    """A departure kept on purpose: the reference quietly serves float weights
    for quantize=int8 (it knows only int8w); the port refuses it."""
    extra = f",seqlen:16,quantize:int8,params:{zoo_npz}"
    toks = np.random.default_rng(25).integers(0, VOCAB, (1, 16)).astype(np.int32)
    ref = jzoo.get("transformer_lm", **_opts(extra))
    got = np.asarray(ref.fn(jnp.asarray(toks)))
    assert got.dtype == np.float32 and got.shape == (1, 16, VOCAB)
    with pytest.raises(ValueError, match="int8w only"):
        tzoo.get("transformer_lm", device="cpu", **_opts(extra))


def test_cli_flash_pipeline_matches_reference(zoo_npz):
    """``python -m nnstreamer_tpu_torch.cli --device cpu`` runs the
    attn=flash filter to a clean end; the same filter behind an appsrc in
    the port's parser gives the reference zoo's logits on seeded tokens."""
    custom = f"{ZOO_OPTS},seqlen:20,attn:flash,params:{zoo_npz}"
    desc = ("tensorsrc dimensions=20:1 types=int32 num-frames=2 pattern=counter ! "
            f'tensor_filter framework=torch model=zoo:transformer_lm custom="{custom}" ! '
            "tensor_sink")
    proc = subprocess.run([sys.executable, "-m", "nnstreamer_tpu_torch.cli", "--device", "cpu",
                           "-q", desc], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    from nnstreamer_tpu_torch.tensors.frame import Frame

    p = parse_pipeline("appsrc name=src dimensions=20:1 types=int32 ! tensor_filter "
                       f'framework=torch model=zoo:transformer_lm custom="{custom}" ! '
                       "tensor_sink name=out", device="cpu")
    rng = np.random.default_rng(23)
    toks = [rng.integers(0, VOCAB, (1, 20)).astype(np.int32) for _ in range(2)]
    ex = p.start()
    for t in toks:
        p["src"].push(Frame((t,)))
    p["src"].end_of_stream()
    assert ex.wait(120)
    ex.stop()
    assert not ex.errors
    frames = p["out"].frames
    assert len(frames) == 2
    ref = jzoo.get("transformer_lm", **_opts(f",seqlen:20,attn:flash,params:{zoo_npz}"))
    for t, f in zip(toks, frames):
        np.testing.assert_allclose(np.asarray(f.tensors[0]).reshape(1, 20, VOCAB),
                                   np.asarray(ref.fn(jnp.asarray(t))), atol=1e-4, rtol=0)


def test_zoo_flash_generate_equals_dense_generate(zoo_npz):
    """With generate > 0, attn=flash is accepted and unused, as in the
    reference: the tokens are the dense zoo's, and the reference's."""
    toks = _t(np.random.default_rng(22).integers(0, VOCAB, (1, 9)).astype(np.int32))
    flash = tzoo.get("transformer_lm", device="cpu", **_opts(f",attn:flash,generate:5,params:"
                                                             f"{zoo_npz}"))
    dense = tzoo.get("transformer_lm", device="cpu", **_opts(f",generate:5,params:{zoo_npz}"))
    before = tfa.flash_attention_launches.count
    got = flash.module(toks)[0].tolist()
    assert got == dense.module(toks)[0].tolist()
    assert tfa.flash_attention_launches.count == before
    ref = jzoo.get("transformer_lm", **_opts(f",attn:flash,generate:5,params:{zoo_npz}"))
    assert got == np.asarray(ref.fn(jnp.asarray(toks.numpy())))[0].tolist()
    jp = ref.params
    assert got == np.asarray(jdec.generate(jp, jnp.asarray(toks.numpy()), N_HEADS, 5))[0].tolist()


def test_zoo_unknown_attn_raises():
    with pytest.raises(KeyError, match="unknown attn"):
        tzoo.get("transformer_lm", device="cpu", **_opts(",attn:ring"))
