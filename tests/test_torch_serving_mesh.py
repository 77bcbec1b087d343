"""The slot-sharded ContinuousBatcher of the port (``mesh=``,
models/serving.py ``SlotShard``) against the JAX package's: the
counterparts of the reference's slot-mesh tests (tests/test_serving.py
``test_mesh_*``, tests/test_pumps.py ``test_pump_mesh_*``).

The same weights (the reference's ``init_params``, carried over with
``transformer_from_jax``) and the same numpy-seeded prompts go through the
JAX batcher on an 8-device mesh of its virtual CPU devices and through the
port's on an 8-position CPU mesh (``NNS_TPU_MESH_CPU_DEVICES=8``), one slot
a position. Greedy tokens are held **equal** to the JAX package's mesh run
and to the port's unsharded run: steps, pumps, K3 (``attn_impl="pallas"``,
its plain version on the CPU) on each shard's local slots, int8 caches,
draft speculation, and step pumps with spec pumps on one batcher.
"""

import numpy as np
import pytest

import jax

from nnstreamer_tpu.models import transformer as jtfm
from nnstreamer_tpu.models.serving import ContinuousBatcher as JBatcher
from nnstreamer_tpu.parallel.mesh import make_mesh as jmake_mesh
from nnstreamer_tpu_torch.models import transformer as ttfm
from nnstreamer_tpu_torch.models.jax_weights import transformer_from_jax
from nnstreamer_tpu_torch.models.serving import ContinuousBatcher
from nnstreamer_tpu_torch.parallel.mesh import make_mesh

N_HEADS = 4


@pytest.fixture(autouse=True)
def _eight_cpu_positions(monkeypatch):
    monkeypatch.setenv("NNS_TPU_MESH_CPU_DEVICES", "8")


def _pair(key, **kw):
    jp = jtfm.init_params(jax.random.PRNGKey(key), vocab=257, n_heads=N_HEADS, **kw)
    lm = ttfm.TransformerLM(257, kw["d_model"], N_HEADS, kw["n_layers"])
    lm.load_state_dict(transformer_from_jax(jax.tree_util.tree_map(np.asarray, jp)))
    return jp, lm


@pytest.fixture(scope="module")
def params():
    """(JAX params, the port's TransformerLM with the same weights): the
    reference's test model."""
    return _pair(7, d_model=64, n_layers=2)


@pytest.fixture(scope="module")
def draft():
    return _pair(77, d_model=32, n_layers=1)


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(1, 257, (n,)).astype(np.int32)


def _rep_prompt(n, seed, period=6):
    base = np.random.default_rng(seed).integers(1, 257, (period,))
    return np.tile(base, -(-n // period))[:n].astype(np.int32)


def _meshes():
    return jmake_mesh(8, axes=("dp",)), make_mesh(8, axes=("dp",), devices="cpu")


def _run(cb, prompts, n_new, drive):
    rids = [cb.submit(p, n_new) for p in prompts]
    while any(cb.result(r) is None for r in rids):
        drive(cb)
    return [list(cb.result(r)) for r in rids]


def _three_runs(params, prompts, n_new, drive, **kw):
    """(JAX mesh, port mesh, port unsharded) token lists."""
    (jp, lm), (jmesh, mesh) = params, _meshes()
    want = _run(JBatcher(jp, N_HEADS, mesh=jmesh, **kw), prompts, n_new, drive)
    got = _run(ContinuousBatcher(lm, N_HEADS, mesh=mesh, device="cpu", **kw),
               prompts, n_new, drive)
    plain = _run(ContinuousBatcher(lm, N_HEADS, device="cpu", **kw), prompts, n_new, drive)
    return want, got, plain


@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
def test_mesh_sharded_slots_match_unsharded(params, attn_impl):
    """test_mesh_sharded_slots_match_unsharded / test_mesh_plus_pallas_
    matches_unsharded: each position runs the step (K3 on its local slots
    with pallas) over its slot."""
    prompts = [_prompt(4 + i, 30 + i) for i in range(3)]
    want, got, plain = _three_runs(params, prompts, 5, lambda cb: cb.step(), n_slots=8,
                                   max_len=32, prompt_len=16, attn_impl=attn_impl)
    assert got == want == plain


def test_mesh_requires_divisible_slots(params):
    (jp, lm), (jmesh, mesh) = params, _meshes()
    with pytest.raises(ValueError, match="divide") as ref:
        JBatcher(jp, N_HEADS, n_slots=3, mesh=jmesh)
    with pytest.raises(ValueError, match="divide") as port:
        ContinuousBatcher(lm, N_HEADS, n_slots=3, mesh=mesh, device="cpu")
    assert str(port.value) == str(ref.value)


def test_mesh_refuses_the_paged_layout_like_the_reference(params):
    (jp, lm), (jmesh, mesh) = params, _meshes()
    kw = dict(n_slots=8, max_len=32, prompt_len=16, kv_layout="paged")
    with pytest.raises(ValueError, match="mesh-sharded slots") as ref:
        JBatcher(jp, N_HEADS, mesh=jmesh, **kw)
    with pytest.raises(ValueError, match="mesh-sharded slots") as port:
        ContinuousBatcher(lm, N_HEADS, mesh=mesh, device="cpu", **kw)
    assert str(port.value) == str(ref.value)
    with pytest.raises(TypeError, match="Mesh"):
        ContinuousBatcher(lm, N_HEADS, n_slots=8, mesh=object(), device="cpu")


@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
def test_mesh_with_int8_cache(params, attn_impl):
    """The scale leaves shard with the quantized cache."""
    want, got, plain = _three_runs(params, [_prompt(6, 500)], 5, lambda cb: cb.step(),
                                   n_slots=8, max_len=32, prompt_len=16, cache_dtype="int8",
                                   attn_impl=attn_impl)
    assert got == want == plain


def test_mesh_with_draft_speculation_matches_unsharded(params, draft):
    """Each shard's draft engine proposes over its slots and its spec
    program verifies them."""
    (jp, lm), (jd, ld), (jmesh, mesh) = params, draft, _meshes()
    prompts = [_prompt(4 + i, 60 + i) for i in range(3)]
    kw = dict(n_slots=8, max_len=48, prompt_len=16, draft_n_heads=2)
    spec = lambda cb: cb.spec_step(k=3)  # noqa: E731
    want = _run(JBatcher(jp, N_HEADS, mesh=jmesh, draft_params=jd, **kw), prompts, 6, spec)
    cb = ContinuousBatcher(lm, N_HEADS, mesh=mesh, draft_params=ld, device="cpu", **kw)
    got = _run(cb, prompts, 6, spec)
    assert cb.stats()["spec_rounds"] > 0
    plain = _run(ContinuousBatcher(lm, N_HEADS, draft_params=ld, device="cpu", **kw),
                 prompts, 6, spec)
    assert got == want == plain


def test_pump_mesh_sharded_slots_match_unsharded(params):
    prompts = [_prompt(5 + s, 90 + s) for s in range(8)]
    want, got, plain = _three_runs(params, prompts, 8, lambda cb: cb.step_pump(8),
                                   n_slots=8, max_len=64, prompt_len=16)
    assert got == want == plain


def test_pump_mesh_pallas_spec_pump_compose(params):
    """mesh + K3 step pumps and spec pumps on one batcher keep the exact
    greedy stream; every shard filled its own programs."""
    (jp, lm), (jmesh, mesh) = params, _meshes()
    prompts = [_rep_prompt(10, 60 + s) for s in range(8)]
    kw = dict(n_slots=8, max_len=64, prompt_len=16, attn_impl="pallas")

    def both(cb):
        cb.step_pump(2)
        cb.spec_pump(rounds=2, k=3)

    want = _run(JBatcher(jp, N_HEADS, mesh=jmesh, **kw), prompts, 8, both)
    cb = ContinuousBatcher(lm, N_HEADS, mesh=mesh, device="cpu", **kw)
    got = _run(cb, prompts, 8, both)
    plain = _run(ContinuousBatcher(lm, N_HEADS, n_slots=8, max_len=64, prompt_len=16,
                                   device="cpu"), prompts, 8, lambda c: c.step())
    assert got == want == plain
    st = cb.stats()
    assert st["mesh"]["devices"] == 8 and st["mesh"]["slots_per_device"] == 1
    for i in range(8):
        assert f"shard{i}/slot/n2/greedy/float32/pallas" in st["programs"]
    assert st["spec_programs_filled"] >= 8


def test_mesh_snapshot_restores_into_either_layout(params):
    """A mesh batcher's snapshot is the unsharded one's: it restores into
    a mesh batcher or an unsharded one, and both continue the stream."""
    (_, lm), (_, mesh) = params, _meshes()
    kw = dict(n_slots=8, max_len=64, prompt_len=16, device="cpu")
    src = ContinuousBatcher(lm, N_HEADS, mesh=mesh, **kw)
    rids = [src.submit(_prompt(5 + s, 200 + s), 10) for s in range(3)]
    src.step_pump(3)
    snap = src.snapshot()
    outs = []
    for dst in (src, ContinuousBatcher(lm, N_HEADS, mesh=mesh, **kw),
                ContinuousBatcher(lm, N_HEADS, **kw)):
        if dst is not src:
            dst.restore(snap)
        outs.append(_run_to_end(dst, rids))
    assert outs[0] == outs[1] == outs[2]


def _run_to_end(cb, rids):
    while any(cb.result(r) is None for r in rids):
        cb.step()
    return [cb.result(r) for r in rids]


def test_mesh_of_one_runs_the_shard_path(params):
    """A one-position mesh is a shard of all the slots, not the unsharded
    program: its programs are the shard's."""
    (_, lm) = params
    cb = ContinuousBatcher(lm, N_HEADS, n_slots=4, max_len=32, prompt_len=16, device="cpu",
                           mesh=make_mesh(1, axes=("dp",), devices="cpu"), attn_impl="pallas")
    rid = cb.submit(_prompt(5, 3), 4)
    cb.step_pump(3)
    st = cb.stats()
    assert st["mesh"]["devices"] == 1 and st["mesh"]["slots_per_device"] == 4
    assert list(st["programs"]) == ["shard0/slot/n3/greedy/float32/pallas"]
    assert cb.result(rid) == _run(ContinuousBatcher(lm, N_HEADS, n_slots=4, max_len=32,
                                                    prompt_len=16, device="cpu"),
                                  [_prompt(5, 3)], 4, lambda c: c.step())[0]
