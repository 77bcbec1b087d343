"""The port's device meshes (nnstreamer_tpu_torch/parallel/mesh.py) against
the JAX package's ``make_mesh`` on its 8 virtual CPU devices: the same
factoring and the same errors for 1, 2, 4, 6 and 8 devices over one, two
and three axes, on an 8-position CPU mesh (``NNS_TPU_MESH_CPU_DEVICES=8``,
as the reference's conftest gives it 8 devices). A mesh over more than
the configured CPU positions raises; the shardings split a tensor into
per-position pieces and gather it back.
"""

import numpy as np
import pytest
import torch

import jax

from nnstreamer_tpu.parallel.mesh import make_mesh as jmake_mesh
from nnstreamer_tpu_torch.parallel import mesh as pm

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _eight_cpu_positions(monkeypatch):
    monkeypatch.setenv("NNS_TPU_MESH_CPU_DEVICES", "8")


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8])
@pytest.mark.parametrize("axes", [("dp",), ("dp", "tp"), ("dp", "tp", "sp")])
def test_make_mesh_factoring_matches_reference(n, axes):
    ref = jmake_mesh(n, axes=axes)
    got = pm.make_mesh(n, axes=axes, devices="cpu")
    assert got.shape == dict(ref.shape)
    assert got.axis_names == tuple(ref.axis_names)
    assert got.size == ref.size == n
    assert all(d == CPU for d in got.devices.flat)


@pytest.mark.parametrize("kw", [
    dict(n_devices=9),
    dict(n_devices=8, shape=(3, 2)),
    dict(n_devices=4, axes=("dp",), shape=(2,)),
])
def test_make_mesh_errors_match_reference(kw):
    kw = {"axes": ("dp", "tp"), **kw}
    with pytest.raises(ValueError) as ref:
        jmake_mesh(**kw)
    with pytest.raises(ValueError) as got:
        pm.make_mesh(devices="cpu", **kw)
    assert str(got.value) == str(ref.value)


def test_mesh_past_the_configured_cpu_positions_raises(monkeypatch):
    monkeypatch.setenv("NNS_TPU_MESH_CPU_DEVICES", "2")
    assert pm.make_mesh(2, axes=("dp",), devices="cpu").size == 2
    with pytest.raises(ValueError, match="need 4 devices, have 2"):
        pm.make_mesh(4, axes=("dp",), devices="cpu")
    monkeypatch.delenv("NNS_TPU_MESH_CPU_DEVICES")
    assert pm.cpu_positions() == 1
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        pm.make_mesh(2, axes=("dp",), devices="cpu")


def test_default_devices_are_the_cards(monkeypatch):
    """No kind given: the CUDA devices, none on this host, so any mesh
    raises naming the count; a kind other than cuda or cpu raises."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="need 1 devices, have 0"):
        pm.make_mesh(1, axes=("dp",))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    m = pm.make_mesh(axes=("dp",))
    assert [str(d) for d in m.devices.flat] == ["cuda:0", "cuda:1"]
    with pytest.raises(ValueError, match="want cuda or cpu"):
        pm.available_devices("meta")


@pytest.mark.parametrize("spec_of", [
    lambda m: pm.replicated(m),
    lambda m: pm.batch_sharding(m, "dp"),
    lambda m: pm.channel_sharding(m, 3, "tp"),
    lambda m: pm.Sharding(m, ("dp", None, "tp")),
])
def test_shardings_split_and_gather_like_the_reference(spec_of):
    """Each position's piece is the block the reference's NamedSharding
    puts on that device; gather gives the tensor back."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = pm.make_mesh(8, axes=("dp", "tp"), devices="cpu")
    jmesh = jmake_mesh(8, axes=("dp", "tp"))
    sh = spec_of(mesh)
    x = np.arange(4 * 3 * 8, dtype=np.float32).reshape(4, 3, 8)
    pieces = sh.split(torch.from_numpy(x))
    assert pieces.shape == (2, 4)
    jarr = jax.device_put(x, NamedSharding(jmesh, P(*sh.spec)))
    by_device = {s.device: np.asarray(s.data) for s in jarr.addressable_shards}
    for idx in np.ndindex(*pieces.shape):
        assert np.array_equal(pieces[idx].numpy(), by_device[jmesh.devices[idx]])
    assert torch.equal(sh.gather(pieces), torch.from_numpy(x))
    assert sh.is_fully_replicated == jarr.sharding.is_fully_replicated


def test_sharding_refuses_what_does_not_divide():
    mesh = pm.make_mesh(8, axes=("dp", "tp"), devices="cpu")
    with pytest.raises(ValueError, match="does not divide"):
        pm.batch_sharding(mesh, "dp").split(torch.zeros(3, 4))
    with pytest.raises(ValueError, match="not an axis"):
        pm.Sharding(mesh, ("sp",))


def test_along_an_axis():
    mesh = pm.make_mesh(8, axes=("dp", "tp"), devices="cpu")
    assert mesh.axis_size("dp") == 2 and mesh.axis_size("tp") == 4
    assert mesh.axis_size("sp") == 1
    assert len(mesh.along("tp", dp=1)) == 4 and len(mesh.along("sp")) == 1
