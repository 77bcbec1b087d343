"""The port's training and sequence parallelism (nnstreamer_tpu_torch/parallel/
ring_attention.py, ulysses.py, moe.py, pipeline_parallel.py, lm.py) against
the JAX package's: a counterpart of each of the 22 cases of
tests/test_parallel.py, each also held to the JAX function's output on the
same inputs.

The JAX package runs on its 8 virtual CPU devices and the port on an
8-position CPU mesh (``NNS_TPU_MESH_CPU_DEVICES=8``); inputs are numpy-
seeded, weights the reference's carried over with ``transformer_from_jax``.
Tolerances: ring / Ulysses outputs and gradients 2e-5 (the reference's),
MoE 1e-5, the pipeline 2e-4, the sequence-parallel LM forward 1e-4, the LM
step's losses 1e-5 and every updated parameter 1e-4 of the JAX package's
on the same (2, 2, 2) mesh; bfloat16 compute 2e-2 relative on the loss
(bfloat16 keeps 8 bits of mantissa: ~4e-3 a rounding, summed over a layer).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from nnstreamer_tpu.models import transformer as jtfm
from nnstreamer_tpu.parallel import lm as jlm
from nnstreamer_tpu.parallel import moe as jmoe
from nnstreamer_tpu.parallel import pipeline_parallel as jpp
from nnstreamer_tpu.parallel import ring_attention as jra
from nnstreamer_tpu.parallel import ulysses as julysses
from nnstreamer_tpu.parallel.mesh import make_mesh as jmake_mesh
from nnstreamer_tpu.parallel.mesh import shard_map as jshard_map
from nnstreamer_tpu_torch.models import transformer as tfm
from nnstreamer_tpu_torch.models.jax_weights import transformer_from_jax
from nnstreamer_tpu_torch.parallel import lm, moe
from nnstreamer_tpu_torch.parallel import pipeline_parallel as pp
from nnstreamer_tpu_torch.parallel import ring_attention as ra
from nnstreamer_tpu_torch.parallel import ulysses
from nnstreamer_tpu_torch.parallel.mesh import make_mesh as tmake_mesh


@pytest.fixture(autouse=True)
def _eight_cpu_positions(monkeypatch):
    monkeypatch.setenv("NNS_TPU_MESH_CPU_DEVICES", "8")


def make_mesh(n, **kw):
    return tmake_mesh(n, devices="cpu", **kw)


def _qkv(rng, b=2, t=64, h=8, d=16):
    return tuple(rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(3))


def _t(*arrays, grad=False):
    return [torch.tensor(a, requires_grad=grad) for a in arrays]


def _np(t):
    return t.detach().numpy()


def _lm_model(jp, **kw):
    """The port's LM with the reference's weights ``jp``."""
    m = lm.init_lm_params(torch.Generator().manual_seed(0), **kw)
    m.load_state_dict(transformer_from_jax(jax.tree_util.tree_map(np.asarray, jp)))
    return m


def _sq_loss_grads(attn, q, k, v):
    qt, kt, vt = _t(q, k, v, grad=True)
    (attn(qt, kt, vt) ** 2).sum().backward()
    return [_np(x.grad) for x in (qt, kt, vt)]


def _jax_sq_grads(attn, q, k, v):
    return [np.asarray(g) for g in jax.grad(
        lambda a, b, c: jnp.sum(attn(a, b, c) ** 2), argnums=(0, 1, 2))(q, k, v)]


class TestRingAttention:
    @pytest.mark.parametrize("causal", [True, False])
    def test_matches_dense(self, causal):
        q, k, v = _qkv(np.random.default_rng(0))
        out = _np(ra.make_ring_attention(make_mesh(8, axes=("sp",)), "sp", causal=causal)(
            *_t(q, k, v)))
        np.testing.assert_allclose(out, _np(ra.dense_attention(*_t(q, k, v), causal=causal)),
                                   atol=2e-5)
        ref = jra.make_ring_attention(jmake_mesh(8, axes=("sp",)), "sp", causal=causal)(q, k, v)
        np.testing.assert_allclose(out, np.asarray(ref), atol=2e-5)

    @pytest.mark.parametrize("kv_chunk", [None, 2])
    def test_grad_flows(self, kv_chunk):
        """The ring's hops are autograd moves: gradients equal the dense
        attention's and the JAX ring's (the second case is the reference's
        test_kv_chunked_grad_matches_dense)."""
        q, k, v = (x[:, :16, :2, :8] for x in _qkv(np.random.default_rng(1)))
        ring = ra.make_ring_attention(make_mesh(4, axes=("sp",)), "sp", kv_chunk=kv_chunk)
        got = _sq_loss_grads(ring, q, k, v)
        dense = _sq_loss_grads(lambda *a: ra.dense_attention(*a, causal=True), q, k, v)
        jring = jra.make_ring_attention(jmake_mesh(4, axes=("sp",)), "sp", kv_chunk=kv_chunk)
        for g, gd, gj in zip(got, dense, _jax_sq_grads(jring, q, k, v)):
            assert np.all(np.isfinite(g))
            np.testing.assert_allclose(g, gd, atol=2e-5)
            np.testing.assert_allclose(g, gj, atol=2e-5)

    @pytest.mark.parametrize("causal", [True, False])
    def test_kv_chunked_matches_dense(self, causal):
        q, k, v = _qkv(np.random.default_rng(3))
        out = _np(ra.make_ring_attention(make_mesh(8, axes=("sp",)), "sp", causal=causal,
                                         kv_chunk=2)(*_t(q, k, v)))
        np.testing.assert_allclose(out, _np(ra.dense_attention(*_t(q, k, v), causal=causal)),
                                   atol=2e-5)
        ref = jra.make_ring_attention(jmake_mesh(8, axes=("sp",)), "sp", causal=causal,
                                      kv_chunk=2)(q, k, v)
        np.testing.assert_allclose(out, np.asarray(ref), atol=2e-5)

    def test_kv_chunk_must_divide(self):
        b = np.zeros((1, 6, 1, 4), np.float32)
        args = (np.ones((6, 6), bool), np.full((1, 1, 6), -1e30, np.float32),
                np.zeros((1, 1, 6), np.float32), np.zeros((1, 6, 1, 4), np.float32), 0.5)
        with pytest.raises(ValueError) as ref:
            jra._online_block_chunked(*(jnp.asarray(x) for x in (b, b, b) + args[:4]), 0.5,
                                      chunk=4)
        with pytest.raises(ValueError, match="chunk") as got:
            ra._online_block_chunked(*_t(b, b, b, *args[:4]), 0.5, chunk=4)
        assert str(got.value) == str(ref.value)

    def test_kv_chunk_rejects_nonpositive(self):
        q, k, v = _qkv(np.random.default_rng(4), t=16, h=1, d=4)
        with pytest.raises(ValueError, match="positive divisor") as got:
            ra.make_ring_attention(make_mesh(8, axes=("sp",)), "sp", kv_chunk=0)(*_t(q, k, v))
        with pytest.raises(ValueError) as ref:
            jra.make_ring_attention(jmake_mesh(8, axes=("sp",)), "sp", kv_chunk=0)(q, k, v)
        assert str(got.value) == str(ref.value)

    def test_kv_chunk_rejected_for_ulysses(self):
        with pytest.raises(ValueError, match="ring") as got:
            lm._make_attn_fn(make_mesh(8, axes=("dp", "sp"), shape=(2, 4)), "ulysses", "dp",
                             "sp", kv_chunk=4)
        with pytest.raises(ValueError) as ref:
            jlm._make_attn_fn(jmake_mesh(8, axes=("dp", "sp"), shape=(2, 4)), "ulysses", "dp",
                              "sp", kv_chunk=4)
        assert str(got.value) == str(ref.value)

    def test_fully_masked_rows_are_zero(self):
        """A remote-only position sees fully masked blocks: they add exact
        zeros (the output and its gradient stay finite and equal the JAX
        ring's)."""
        q, k, v = _qkv(np.random.default_rng(2), t=8, h=1, d=4)
        ring = ra.make_ring_attention(make_mesh(8, axes=("sp",)), "sp", causal=True)
        out = _np(ring(*_t(q, k, v)))
        assert np.all(np.isfinite(out))
        ref = jra.make_ring_attention(jmake_mesh(8, axes=("sp",)), "sp", causal=True)(q, k, v)
        np.testing.assert_allclose(out, np.asarray(ref), atol=2e-5)
        # the first position's block against every later block is all masked
        m0, l0, o0 = ra._online_block(
            *_t(q[:, :1], k[:, 1:2], v[:, 1:2]), torch.zeros((1, 1), dtype=torch.bool),
            torch.full((2, 1, 1), ra.NEG_INF), torch.zeros((2, 1, 1)), torch.zeros((2, 1, 1, 4)),
            0.5)
        assert torch.all(l0 == 0) and torch.all(o0 == 0)
        assert all(np.all(np.isfinite(g)) for g in _sq_loss_grads(ring, q, k, v))


class TestUlysses:
    @pytest.mark.parametrize("causal", [True, False])
    def test_matches_dense(self, causal):
        q, k, v = _qkv(np.random.default_rng(3))  # 8 heads over 8 positions
        out = _np(ulysses.make_ulysses_attention(make_mesh(8, axes=("sp",)), "sp",
                                                 causal=causal)(*_t(q, k, v)))
        np.testing.assert_allclose(out, _np(ra.dense_attention(*_t(q, k, v), causal=causal)),
                                   atol=2e-5)
        ref = julysses.make_ulysses_attention(jmake_mesh(8, axes=("sp",)), "sp",
                                              causal=causal)(q, k, v)
        np.testing.assert_allclose(out, np.asarray(ref), atol=2e-5)

    def test_rejects_indivisible_heads(self):
        q, k, v = _qkv(np.random.default_rng(4), h=6)
        with pytest.raises(ValueError, match="heads 6 not divisible by axis size 8") as got:
            ulysses.make_ulysses_attention(make_mesh(8, axes=("sp",)), "sp")(*_t(q, k, v))
        with pytest.raises(Exception) as ref:
            julysses.make_ulysses_attention(jmake_mesh(8, axes=("sp",)), "sp")(q, k, v)
        assert str(got.value) in str(ref.value)

    def test_resplit_gives_each_position_its_heads_over_the_whole_sequence(self):
        """seq_to_head is a real re-split: position p holds heads
        [p·H/n, (p+1)·H/n) of every token, and head_to_seq inverts it;
        the gradient through both equals the dense attention's."""
        q, _, _ = _qkv(np.random.default_rng(5), b=2, t=16, h=8, d=4)
        devs = make_mesh(4, axes=("sp",)).along("sp")
        blocks = list(torch.tensor(q).chunk(4, dim=1))
        heads = ulysses.seq_to_head(blocks, devs)
        assert [tuple(h.shape) for h in heads] == [(2, 16, 2, 4)] * 4
        for p, h in enumerate(heads):
            np.testing.assert_array_equal(_np(h), q[:, :, 2 * p:2 * p + 2])
        back = ulysses.head_to_seq(heads, devs)
        assert [tuple(b.shape) for b in back] == [(2, 4, 8, 4)] * 4
        np.testing.assert_array_equal(_np(torch.cat(back, dim=1)), q)
        q, k, v = (x[:, :16, :4, :8] for x in _qkv(np.random.default_rng(6)))
        uly = ulysses.make_ulysses_attention(make_mesh(4, axes=("sp",)), "sp")
        dense = _sq_loss_grads(lambda *a: ra.dense_attention(*a, causal=True), q, k, v)
        for g, gd in zip(_sq_loss_grads(uly, q, k, v), dense):
            np.testing.assert_allclose(g, gd, atol=2e-5)


class TestMoE:
    def test_ep_matches_dense(self):
        rng = np.random.default_rng(5)
        mp = jmoe.init_moe_params(jax.random.PRNGKey(1), d_model=32, d_ff=64, n_experts=8,
                                  n_layers=1)
        mp0 = jax.tree.map(lambda a: a[0], mp)
        x = rng.standard_normal((2, 16, 32)).astype(np.float32)
        jf = jax.jit(jshard_map(
            functools.partial(jmoe.moe_ffn_local, axis_name="ep", top_k=2),
            mesh=jmake_mesh(8, axes=("ep",)),
            in_specs=(P(), {"gate": P(), "w_in": P("ep"), "w_out": P("ep")}),
            out_specs=P(), check_vma=False))
        ref = np.asarray(jf(jnp.asarray(x), mp0))
        p = {k: torch.tensor(np.asarray(v)) for k, v in mp0.items()}
        dense = _np(moe.moe_ffn_dense(torch.tensor(x), p, top_k=2))
        got = _np(moe.make_moe_ffn(make_mesh(8, axes=("ep",)), "ep", top_k=2)(torch.tensor(x), p))
        np.testing.assert_allclose(got, dense, atol=1e-5)
        np.testing.assert_allclose(got, ref, atol=1e-5)
        np.testing.assert_allclose(dense, np.asarray(jmoe.moe_ffn_dense(jnp.asarray(x), mp0)),
                                   atol=1e-5)

    def test_topk_gate_sparsity(self):
        mp = jmoe.init_moe_params(jax.random.PRNGKey(2), d_model=8, d_ff=16, n_experts=4,
                                  n_layers=1)
        x = np.random.default_rng(6).standard_normal((1, 5, 8)).astype(np.float32)
        probs = _np(moe.gate_probs(torch.tensor(x), torch.tensor(np.asarray(mp["gate"][0])), 2))
        assert np.all((probs > 0).sum(axis=-1) == 2)
        np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-6)
        ref = np.asarray(jmoe.gate_probs(jnp.asarray(x), mp["gate"][0], top_k=2))
        np.testing.assert_allclose(probs, ref, atol=1e-6)


class TestPipelineParallel:
    def test_matches_sequential(self):
        rng = np.random.default_rng(7)
        jp = jtfm.init_params(jax.random.PRNGKey(3), vocab=32, d_model=32, n_heads=4, n_layers=8)
        model = _lm_model(jp, vocab=32, d_model=32, n_heads=4, n_layers=8)
        xs = rng.standard_normal((16, 12, 32)).astype(np.float32)
        positions = torch.arange(12)

        def stage(x_mb, blocks):
            return tfm.apply_layers(blocks, x_mb, 4, positions)

        with torch.no_grad():
            y_seq = _np(tfm.apply_layers(model, torch.tensor(xs), 4, positions))
            fwd = pp.make_pipeline_forward(make_mesh(8, axes=("pp",)), stage, n_microbatches=4)
            y_pp = _np(fwd(model.blocks, torch.tensor(xs)))
        np.testing.assert_allclose(y_pp, y_seq, atol=2e-4)
        ref = jpp.make_pipeline_forward(
            jmake_mesh(8, axes=("pp",)),
            lambda x_mb, sp_: jtfm.apply_layers(sp_, x_mb, 4, jnp.arange(12)),
            n_microbatches=4)(jp["blocks"], jnp.asarray(xs))
        np.testing.assert_allclose(y_pp, np.asarray(ref), atol=2e-4)

    def test_rejects_ragged_microbatch(self):
        jp = jtfm.init_params(jax.random.PRNGKey(4), vocab=16, d_model=16, n_heads=2, n_layers=4)
        model = _lm_model(jp, vocab=16, d_model=16, n_heads=2, n_layers=4)
        fwd = pp.make_pipeline_forward(
            make_mesh(4, axes=("pp",)),
            lambda x, blocks: tfm.apply_layers(blocks, x, 2, torch.arange(4)), n_microbatches=3)
        with pytest.raises(ValueError, match="batch 10 not divisible by 3 microbatches") as got:
            fwd(model.blocks, torch.zeros((10, 4, 16)))
        with pytest.raises(Exception) as ref:
            jpp.make_pipeline_forward(
                jmake_mesh(4, axes=("pp",)),
                lambda x, p: jtfm.apply_layers(p, x, 2, jnp.arange(4)),
                n_microbatches=3)(jp["blocks"], jnp.zeros((10, 4, 16), jnp.float32))
        assert str(got.value) in str(ref.value)

    def test_stages_hold_their_slices_and_layers_must_divide(self):
        jp = jtfm.init_params(jax.random.PRNGKey(4), vocab=16, d_model=16, n_heads=2, n_layers=4)
        model = _lm_model(jp, vocab=16, d_model=16, n_heads=2, n_layers=4)
        devs = make_mesh(2, axes=("pp",)).along("pp")
        stages = pp.stage_slices(list(model.blocks), devs)
        assert [len(s) for s in stages] == [2, 2]
        assert stages[1][0] is model.blocks[2]  # a slice, on its device already: no copy
        with pytest.raises(ValueError, match="4 layers do not divide over 3 stages"):
            pp.stage_slices(list(model.blocks), make_mesh(3, axes=("pp",)).along("pp"))

    def test_stages_are_placed_once_and_gradients_reach_the_callers_layers(self):
        """A slice off its stage's device raises (no copy is made behind
        the caller's back); ``place_stages`` moves each slice in place; a
        backward through the pipeline fills the caller's own parameters'
        gradients, equal to the sequential forward's."""
        from nnstreamer_tpu_torch.parallel.mesh import Mesh

        jp = jtfm.init_params(jax.random.PRNGKey(4), vocab=16, d_model=16, n_heads=2, n_layers=4)
        model = _lm_model(jp, vocab=16, d_model=16, n_heads=2, n_layers=4)
        devs = np.empty((2,), dtype=object)
        devs[:] = [torch.device("cpu"), torch.device("meta")]
        two = Mesh(devs, ("pp",))
        with pytest.raises(ValueError, match="stage 1's layers lie on .*cpu.*place_stages"):
            pp.stage_slices(list(model.blocks), two.along("pp"))
        block2 = model.blocks[2]
        assert pp.place_stages(model, two) is model
        assert model.blocks[2] is block2 and block2.ln1.device.type == "meta"
        assert model.blocks[0].ln1.device.type == "cpu"
        assert pp.stage_slices(list(model.blocks), two.along("pp"))[1][0] is block2

        model = _lm_model(jp, vocab=16, d_model=16, n_heads=2, n_layers=4).requires_grad_(True)
        positions = torch.arange(4)
        x = torch.tensor(np.random.default_rng(5).standard_normal((4, 4, 16)).astype(np.float32))
        fwd = pp.make_pipeline_forward(
            make_mesh(2, axes=("pp",)),
            lambda xb, blocks: tfm.apply_layers(blocks, xb, 2, positions), n_microbatches=2)
        (fwd(model.blocks, x) ** 2).sum().backward()
        piped = [p.grad.clone() for p in model.blocks.parameters()]
        model.zero_grad()
        (tfm.apply_layers(model, x, 2, positions) ** 2).sum().backward()
        for got, want in zip(piped, model.blocks.parameters()):
            # float32, the microbatches summed in another order: within
            # 1e-6 of each leaf's largest gradient
            scale = float(want.grad.abs().max())
            np.testing.assert_allclose(_np(got), _np(want.grad), rtol=0, atol=1e-6 * scale)


TOKS_LM = dict(vocab=64, d_model=32, n_heads=4, n_layers=2)


@pytest.fixture(scope="module")
def moe_steps():
    """The reference's dp × sp × ep step (mesh (2, 2, 2), 4 experts) two
    times on one batch: its losses and its parameters after each step."""
    jp = jlm.init_lm_params(jax.random.PRNGKey(0), n_experts=4, **TOKS_LM)
    jp_np = jax.tree_util.tree_map(np.asarray, jp)
    toks = np.random.default_rng(8).integers(0, 64, (4, 17)).astype(np.int32)
    step, params = jlm.make_lm_train_step(
        jmake_mesh(8, axes=("dp", "sp", "ep"), shape=(2, 2, 2)), jp, n_heads=4, ep_axis="ep")
    losses, states = [], []
    for _ in range(2):
        params, loss = step(params, jnp.asarray(toks))
        losses.append(float(loss))
        states.append(transformer_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return jp_np, toks, losses, states


class TestLMTrainStep:
    def test_dp_sp_ep_step_decreases_loss(self, moe_steps):
        """Two steps on the (2, 2, 2) mesh: each loss within 1e-5 of the JAX
        package's, every updated parameter within 1e-4 of its, the loss
        falling; the caller's model is untouched."""
        jp_np, toks, want_losses, want_states = moe_steps
        model = _lm_model(jp_np, n_experts=4, **TOKS_LM)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        mesh = make_mesh(8, axes=("dp", "sp", "ep"), shape=(2, 2, 2))
        step, params = lm.make_lm_train_step(mesh, model, n_heads=4, ep_axis="ep")
        losses = []
        for want in want_states:
            params, loss = step(params, torch.tensor(toks))
            losses.append(float(loss))
            for name, w in want.items():
                np.testing.assert_allclose(_np(params[name].full()), w.numpy(), atol=1e-4,
                                           err_msg=name)
        np.testing.assert_allclose(losses, want_losses, atol=1e-5)
        assert np.isfinite(losses[0]) and losses[1] < losses[0]
        for k, v in model.state_dict().items():
            assert torch.equal(v, before[k]) and not model.get_parameter(k).requires_grad
        # the experts are pieces: position (i, s, e) holds experts [2e, 2e+2)
        w_in = params["blocks.0.moe_w_in"]
        for idx, piece in w_in.local():
            assert tuple(piece.shape) == (2, 32, 64)
            np.testing.assert_array_equal(_np(piece), _np(w_in.full()[2 * idx[2]:2 * idx[2] + 2]))

    def test_sequence_parallel_forward_matches_dense(self):
        jp = jlm.init_lm_params(jax.random.PRNGKey(1), **TOKS_LM)
        model = _lm_model(jp, **TOKS_LM)
        attn = lm._make_attn_fn(make_mesh(8, axes=("dp", "sp", "ep"), shape=(2, 2, 2)), "ring",
                                "dp", "sp")
        x = np.random.default_rng(9).integers(0, 64, (4, 16)).astype(np.int32)
        with torch.no_grad():
            dense = _np(tfm.apply(model, torch.tensor(x), 4))
            ring = _np(tfm.apply(model, torch.tensor(x), 4, attn_fn=attn))
        np.testing.assert_allclose(ring, dense, atol=1e-4)
        jattn = jlm._make_attn_fn(jmake_mesh(8, axes=("dp", "sp", "ep"), shape=(2, 2, 2)),
                                  "ring", "dp", "sp")
        ref = jax.jit(lambda t: jtfm.apply(jp, t, 4, attn_fn=jattn))(jnp.asarray(x))
        np.testing.assert_allclose(ring, np.asarray(ref), atol=1e-4)

    def test_kv_chunked_train_step_matches_unchunked(self):
        jp = jlm.init_lm_params(jax.random.PRNGKey(3), **TOKS_LM)
        mesh = make_mesh(8, axes=("dp", "sp", "ep"), shape=(2, 2, 2))
        model = _lm_model(jp, **TOKS_LM)
        x = np.random.default_rng(11).integers(0, 64, (4, 16)).astype(np.int32)
        with torch.no_grad():
            dense = _np(tfm.apply(model, torch.tensor(x), 4))
            ring = _np(tfm.apply(model, torch.tensor(x), 4,
                                 attn_fn=lm._make_attn_fn(mesh, "ring", "dp", "sp", kv_chunk=4)))
        np.testing.assert_allclose(ring, dense, atol=1e-4)
        toks = np.random.default_rng(12).integers(0, 64, (4, 17)).astype(np.int32)
        step, params = lm.make_lm_train_step(mesh, model, n_heads=4, kv_chunk=4)
        _, loss = step(params, torch.tensor(toks))
        jstep, jparams = jlm.make_lm_train_step(
            jmake_mesh(8, axes=("dp", "sp", "ep"), shape=(2, 2, 2)), jp, n_heads=4, kv_chunk=4)
        _, jloss = jstep(jparams, jnp.asarray(toks))
        assert np.isfinite(float(loss))
        np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5)

    def test_ulysses_attn_kind(self):
        jp = jlm.init_lm_params(jax.random.PRNGKey(2), vocab=32, d_model=32, n_heads=4,
                                n_layers=1)
        model = _lm_model(jp, vocab=32, d_model=32, n_heads=4, n_layers=1)
        toks = np.random.default_rng(10).integers(0, 32, (2, 17)).astype(np.int32)
        step, params = lm.make_lm_train_step(make_mesh(8, axes=("dp", "sp"), shape=(2, 4)),
                                             model, n_heads=4, attn="ulysses")
        _, loss = step(params, torch.tensor(toks))
        jstep, jparams = jlm.make_lm_train_step(jmake_mesh(8, axes=("dp", "sp"), shape=(2, 4)),
                                                jp, n_heads=4, attn="ulysses")
        _, jloss = jstep(jparams, jnp.asarray(toks))
        assert np.isfinite(float(loss))
        np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5)

    def test_bfloat16_compute(self):
        """compute_dtype=bfloat16 (float32 weights, bfloat16 matmuls): the
        loss within 2e-2 relative of the JAX package's."""
        jp = jlm.init_lm_params(jax.random.PRNGKey(5), **TOKS_LM)
        model = _lm_model(jp, **TOKS_LM)
        toks = np.random.default_rng(13).integers(0, 64, (4, 17)).astype(np.int32)
        step, params = lm.make_lm_train_step(
            make_mesh(8, axes=("dp", "sp", "ep"), shape=(2, 2, 2)), model, n_heads=4,
            compute_dtype=torch.bfloat16)
        _, loss = step(params, torch.tensor(toks))
        jstep, jparams = jlm.make_lm_train_step(
            jmake_mesh(8, axes=("dp", "sp", "ep"), shape=(2, 2, 2)), jp, n_heads=4,
            compute_dtype=jnp.bfloat16)
        _, jloss = jstep(jparams, jnp.asarray(toks))
        assert np.isfinite(float(loss))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-2)


def test_zoo_transformer_lm():
    from nnstreamer_tpu_torch.models import zoo

    m = zoo.get("transformer_lm", vocab="64", d_model="32", n_heads="4", n_layers="1",
                seqlen="8", device="cpu")
    with torch.no_grad():
        out = m.module(torch.zeros((1, 8), dtype=torch.int32))
    assert tuple(out.shape) == (1, 8, 64)
    assert tuple(m.input_spec[0].shape) == (1, 8)
