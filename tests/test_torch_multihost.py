"""The port's multi-process runtime (nnstreamer_tpu_torch/parallel/
multihost.py on ``torch.distributed``, gloo): the 2 cases of
tests/test_multihost.py with two spawned processes of 2 CPU positions each
(``NNS_TPU_MESH_CPU_DEVICES=2``), one global mesh of 4 over both.

- A sum across the process boundary: each process holds the pieces of its
  two positions and the reduction goes through the autograd-aware
  all-reduce, whose gradient reaches every piece.
- The fresh / resume drill (``parallel/_multihost_worker.py``): MobileNet-v2
  on ``make_mesh(4, ("dp", "tp"))``, (1, 4), so tp spans the processes; a
  step on the reference's 32×32 batch of 2, a checkpoint from both
  processes, a new process set restoring it, the eval loss reproduced
  within 1e-6 and one more step.
- Both layouts a mesh may take across processes, each held to the JAX
  package's step in this process from the same weights and batch: two
  processes of 4 positions make (2, 4), each dp row in one process (the
  batch-norm sums and the loss all-reduced), and two of 2 make (1, 4), tp
  across the processes (the partial logits all-reduced). In float32 this
  gradient is ill-conditioned (the reference's own float32 step lies up
  to 6 % from its float64 step; tests/test_torch_train.py), so the worker
  runs in float64 (``NNS_TPU_DRILL_DTYPE``) against the reference's
  float64 step on (1, 8) / (1, 4) (its (2, 4) step scales the depthwise
  gradients by tp): the loss within 1e-7 relative and every leaf of the
  checkpointed parameters within ``rtol`` of its largest magnitude plus
  1e-14 of the tree's. Both cast the logits to float32, and an ulp that
  rounds the other way moves the gradient: rtol 5e-7 at batch 4 (worst
  leaf 8.3e-8, as tests/test_torch_train.py), 2e-6 at batch 2, where each
  last batch norm normalizes two values (worst leaf 5.7e-7 for the port's
  one-process (1, 4) step, 5.0e-7 across the processes).

Every spawned process has a timeout, as the reference's have.
"""

import os
import re
import socket
import subprocess
import sys

import numpy as np

import pytest
import torch

import jax
import jax.numpy as jnp

from nnstreamer_tpu.models import mobilenet_v2 as jmobilenet
from nnstreamer_tpu.parallel import train as jtrain
from nnstreamer_tpu.parallel.mesh import make_mesh as jmake_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 180

_WORKER = """
import os, sys
sys.path.insert(0, {repo!r})
os.environ["NNS_TPU_MESH_CPU_DEVICES"] = "2"
import torch
from nnstreamer_tpu_torch.parallel import multihost
from nnstreamer_tpu_torch.parallel.mesh import Sharding, make_mesh
from nnstreamer_tpu_torch.parallel.spmd import ShardedTensor, all_reduce, loss_scale, sum_to

pid = int(sys.argv[1])
multihost.initialize({coord!r}, num_processes=2, process_id=pid, device="cpu")
info = multihost.process_info()
assert info == {{"process_index": pid, "process_count": 2, "global_devices": 4,
                 "local_devices": 2}}, info
assert multihost.is_primary() == (pid == 0)

mesh = make_mesh(4, axes=("dp",), devices="cpu")
assert mesh.ranks.tolist() == [0, 0, 1, 1] and mesh.n_processes == 2
full = torch.arange(8 * 4, dtype=torch.float32).reshape(8, 4)
x = ShardedTensor.place(full, Sharding(mesh, ("dp",)), requires_grad=True)
mine = [i for (i,), _ in x.local()]
assert mine == [2 * pid, 2 * pid + 1], mine
# the reduction crosses the process boundary
total = all_reduce(sum_to([p.sum() for _, p in x.local()], "cpu"), mesh)
assert float(total) == float(full.sum()), (float(total), float(full.sum()))
(total * loss_scale(mesh)).backward()
assert all(torch.equal(p.grad, torch.ones_like(p)) for _, p in x.local())
multihost.barrier("done")
print(f"proc{{pid}} ok", flush=True)
multihost.shutdown()
"""


def _free_coord():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    coord = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    return coord


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("NNS_TPU_MESH_CPU_DEVICES", "MASTER_ADDR", "MASTER_PORT",
                        "NNS_TPU_DRILL_DTYPE")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    env.update(extra)
    return env


def _start(cmds, **env):
    return [subprocess.Popen(c, env=_env(**env), stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True, cwd=REPO) for c in cmds]


def _run(cmds):
    """Start every command at once; each must exit 0 within the timeout."""
    return _wait(_start(cmds))


def _wait(procs):
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT_S)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def test_two_process_mesh_psum(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.format(repo=REPO, coord=_free_coord()))
    outs = _run([[sys.executable, str(script), str(i)] for i in range(2)])
    for i, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"proc{i} failed:\n{err[-1200:]}"
        assert f"proc{i} ok" in out


def _spawn_phase(phase, workdir, weights, positions=2, **env):
    coord = _free_coord()
    return _start([[sys.executable, "-m", "nnstreamer_tpu_torch.parallel._multihost_worker",
                    phase, str(i), "2", coord, workdir, str(positions), weights]
                   for i in range(2)], **env)


def _phase_outputs(phase, procs):
    outs = _wait(procs)
    for i, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"{phase} proc{i} failed:\n{err[-1200:]}"
        assert f"proc{i} {phase} ok" in out, out
    return outs


def _weights(tmp_path):
    jp = jmobilenet.init_params(jax.random.PRNGKey(0), num_classes=16)
    weights = str(tmp_path / "w.npz")
    np.savez(weights, **{f"p{i}": np.asarray(v)
                         for i, v in enumerate(jax.tree_util.tree_leaves(jp))})
    return jp, weights


def test_checkpoint_resume_across_host_restart(tmp_path):
    """Two processes train one step over the global mesh and checkpoint
    from both; a new process set restores the state onto the mesh,
    reproduces the recorded eval loss and keeps training."""
    _, weights = _weights(tmp_path)
    _phase_outputs("fresh", _spawn_phase("fresh", str(tmp_path), weights))
    # the simulated restart: new processes and a new coordinator
    _phase_outputs("resume", _spawn_phase("resume", str(tmp_path), weights))


# (positions a process, the worker's batch: 2 images a dp row, the
# reference's mesh for the same batch, the parameters' rtol)
@pytest.mark.parametrize("positions,batch,ref_mesh,rtol",
                         [(4, 4, (1, 8), 5e-7), (2, 2, (1, 4), 2e-6)], ids=["rows", "columns"])
def test_spanning_layouts_match_jax(tmp_path, positions, batch, ref_mesh, rtol):
    """The fresh step over two processes in float64 against the JAX
    package's float64 step: the loss and every checkpointed parameter
    (module docstring)."""
    from nnstreamer_tpu_torch.models import jax_weights, mobilenet_v2
    from nnstreamer_tpu_torch.parallel import checkpoint

    jp, weights = _weights(tmp_path)
    procs = _spawn_phase("fresh", str(tmp_path), weights, positions,
                         NNS_TPU_DRILL_DTYPE="float64")
    try:
        # the worker's batch through the JAX package, meanwhile
        rng = lambda seed: np.random.default_rng(seed)  # noqa: E731
        images = rng(0).integers(0, 255, (batch, 32, 32, 3)).astype(np.uint8)
        labels = rng(1).integers(0, 16, (batch,)).astype(np.int32)
        with jax.enable_x64(True):
            p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), jp)
            step, params, opt = jtrain.make_train_step(
                jmake_mesh(int(np.prod(ref_mesh)), axes=("dp", "tp"), shape=ref_mesh), p64,
                compute_dtype=jnp.float64)
            params, _, want = step(params, opt, jnp.asarray(images), jnp.asarray(labels))
            params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), params)
        outs = _phase_outputs("fresh", procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    losses = [float(re.search(r"fresh ok loss=(\S+)", out).group(1)) for _, out, _ in outs]
    assert losses[0] == losses[1]  # every process holds the replicated loss
    assert abs(losses[0] - float(want)) <= 1e-7 * abs(float(want)), (losses[0], float(want))

    def leaf(a):
        a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T if a.ndim == 2 else a
        return torch.tensor(np.ascontiguousarray(a))

    ref = {jax_weights.state_key(p): leaf(jax_weights._get(params, p))
           for p in mobilenet_v2.jax_leaf_paths()}
    got = checkpoint.restore(str(tmp_path / "pod_ckpt"))["params"]
    assert set(got) == set(ref)
    scale = max(float(v.abs().max()) for v in ref.values())
    for name, want_leaf in ref.items():
        assert got[name].dtype == torch.float64, name
        err = float((got[name] - want_leaf).abs().max())
        assert err <= rtol * float(want_leaf.abs().max()) + 1e-14 * scale, (name, err)


def test_layouts_that_span_processes_are_checked():
    """Meshes tagged with ranks, no process spawned: the MobileNet step
    takes dp rows that each lie in one process or each span every process
    and refuses any other layout; the LM step refuses a mesh that spans
    processes."""
    import pytest
    import torch

    from nnstreamer_tpu_torch.parallel import lm, train
    from nnstreamer_tpu_torch.parallel.mesh import Mesh

    def mesh(ranks, axes=("dp", "tp")):
        ranks = np.array(ranks)
        devs = np.empty(ranks.shape, dtype=object)
        for idx in np.ndindex(*ranks.shape):
            devs[idx] = torch.device("cpu")
        return Mesh(devs, axes, ranks, rank=0)

    assert train._layout(mesh([[0, 0, 0, 0], [1, 1, 1, 1]])) == "rows"
    assert train._layout(mesh([[0, 0, 1, 1]])) == "columns"
    assert train._layout(mesh([[0, 0], [0, 0]])) == "local"
    with pytest.raises(ValueError, match="one process or span every process"):
        train._layout(mesh([[0, 0, 1, 1], [2, 2, 3, 3]]))
    model = lm.init_lm_params(torch.Generator().manual_seed(0), vocab=16, d_model=16,
                              n_heads=2, n_layers=1)
    with pytest.raises(NotImplementedError, match="one process's mesh"):
        lm.make_lm_train_step(mesh([[0, 1]], axes=("dp", "sp")), model, n_heads=2)
