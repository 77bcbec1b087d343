"""Checkpoint / resume of the port (nnstreamer_tpu_torch/parallel/
checkpoint.py): the 4 cases of tests/test_checkpoint.py (host round-trip,
sharded round-trip with the pieces on their positions, resume equal to the
uninterrupted step within 1e-6, ``latest_step``), a restore onto another
mesh factoring, and an orbax directory (the JAX package's format) refused
with the format named. The port writes a format of its own (a manifest
and one raw file a piece); it runs on an 8-position CPU mesh
(``NNS_TPU_MESH_CPU_DEVICES=8``). Round trips are exact.
"""

import os

import numpy as np
import pytest
import torch

import jax

from nnstreamer_tpu.parallel import checkpoint as jckpt
from nnstreamer_tpu.parallel import lm as jlm
from nnstreamer_tpu_torch.models.jax_weights import transformer_from_jax
from nnstreamer_tpu_torch.parallel import checkpoint as ckpt
from nnstreamer_tpu_torch.parallel import lm
from nnstreamer_tpu_torch.parallel.mesh import Sharding
from nnstreamer_tpu_torch.parallel.mesh import make_mesh as tmake_mesh
from nnstreamer_tpu_torch.parallel.spmd import ShardedTensor


@pytest.fixture(autouse=True)
def _eight_cpu_positions(monkeypatch):
    monkeypatch.setenv("NNS_TPU_MESH_CPU_DEVICES", "8")


def make_mesh(n, **kw):
    return tmake_mesh(n, devices="cpu", **kw)


def test_roundtrip_host(tmp_path):
    state = {"w": np.arange(8, dtype=np.float32), "step": np.int32(3),
             "nested": [torch.ones(2, 3, dtype=torch.bfloat16), (1.5, None)]}
    path = str(tmp_path / "c1")
    ckpt.save(path, state)
    back = ckpt.restore(path)
    np.testing.assert_array_equal(back["w"], state["w"])
    assert int(back["step"]) == 3 and back["w"].dtype == np.float32
    assert back["nested"][0].dtype == torch.bfloat16  # numpy has no bfloat16
    assert torch.equal(back["nested"][0], state["nested"][0])
    assert back["nested"][1] == (1.5, None)
    # written under a temporary name and renamed: nothing else is left
    assert os.listdir(tmp_path) == ["c1"]
    with pytest.raises(FileExistsError):
        ckpt.save(path, state, force=False)


def test_roundtrip_sharded(tmp_path):
    mesh = make_mesh(8, axes=("dp",))
    shard = Sharding(mesh, ("dp",))
    w = ShardedTensor.place(torch.arange(16, dtype=torch.float32), shard)
    path = str(tmp_path / "c2")
    ckpt.save(path, {"w": w})
    assert len([n for n in os.listdir(path) if n.endswith(".bin")]) == 8
    back = ckpt.restore(path, like={"w": w}, shardings={"w": shard})["w"]
    assert isinstance(back, ShardedTensor) and back.sharding is shard
    for (i,), piece in back.local():
        assert piece.device == mesh.devices[i]
        np.testing.assert_array_equal(piece.numpy(), [2 * i, 2 * i + 1])
        assert piece is not w.pieces[i]
    np.testing.assert_array_equal(back.full().numpy(), np.arange(16))


def test_restore_onto_another_mesh_factoring(tmp_path):
    """Pieces are reassembled by range: a (2, 4) checkpoint restores onto
    (4, 2) with the split axes swapped, onto a 1-axis mesh, and whole."""
    full = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    src = Sharding(make_mesh(8, axes=("dp", "tp"), shape=(2, 4)), ("dp", "tp"))
    path = str(tmp_path / "c5")
    ckpt.save(path, {"w": ShardedTensor.place(full, src)})
    for sh in (Sharding(make_mesh(8, axes=("dp", "tp"), shape=(4, 2)), ("tp", "dp")),
               Sharding(make_mesh(8, axes=("sp",)), (None, "sp")),
               Sharding(make_mesh(1, axes=("dp",)), ())):
        back = ckpt.restore(path, shardings={"w": sh})["w"]
        for idx, piece in back.local():
            rng = sh.piece_range(idx, full.shape)
            assert torch.equal(piece, full[rng[0][0]:rng[0][1], rng[1][0]:rng[1][1]])
        assert torch.equal(back.full(), full)
    assert torch.equal(ckpt.restore(path, like={"w": full})["w"], full)


def test_resume_training_state(tmp_path):
    """Save mid-training, restore onto the mesh, and the next step equals
    the uninterrupted one (within 1e-6, the reference's)."""
    jp = jlm.init_lm_params(jax.random.PRNGKey(0), vocab=32, d_model=32, n_heads=4, n_layers=1)
    model = lm.init_lm_params(torch.Generator().manual_seed(0), vocab=32, d_model=32,
                              n_heads=4, n_layers=1)
    model.load_state_dict(transformer_from_jax(jax.tree_util.tree_map(np.asarray, jp)))
    mesh = make_mesh(8, axes=("dp", "sp"), shape=(2, 4))
    step, params = lm.make_lm_train_step(mesh, model, n_heads=4)
    toks = torch.tensor(np.random.default_rng(0).integers(0, 32, (2, 17)), dtype=torch.int32)
    params, _ = step(params, toks)
    path = str(tmp_path / "c3")
    ckpt.save(path, params)
    saved = {k: v.full().clone() for k, v in params.items()}

    params_cont, loss_cont = step(params, toks)  # uninterrupted

    restored = ckpt.restore(path, like=saved, shardings=lm.param_shardings(mesh, model, None))
    for k, v in restored.items():
        assert torch.equal(v.full(), saved[k])
    step2, _ = lm.make_lm_train_step(mesh, model, n_heads=4)
    _, loss_res = step2(restored, toks)
    assert float(loss_res) == pytest.approx(float(loss_cont), abs=1e-6)


def test_latest_step(tmp_path):
    assert ckpt.latest_step(str(tmp_path)) is None
    for s in (1, 5, 3):
        ckpt.save(ckpt.step_path(str(tmp_path), s), {"x": np.zeros(1)})
    assert ckpt.latest_step(str(tmp_path)) == 5


def test_orbax_directory_is_refused_naming_the_format(tmp_path):
    """Neither package reads the other's checkpoints: the JAX package's
    orbax directory raises, naming orbax, and a missing one says so."""
    path = str(tmp_path / "orbax")
    jckpt.save(path, {"w": np.arange(4, dtype=np.float32)})
    with pytest.raises(ValueError, match="orbax checkpoint"):
        ckpt.restore(path)
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"))
