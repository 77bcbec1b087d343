"""Multi-process drill worker: one process of a simulated multi-host run.

Run as::

    python -m nnstreamer_tpu_torch.parallel._multihost_worker \\
        <phase> <pid> <nprocs> <coordinator> <workdir> [positions_per_proc] \\
        [weights.npz]

The counterpart of ``nnstreamer_tpu/parallel/_multihost_worker.py``. Each
process takes ``positions_per_proc`` CPU positions
(``NNS_TPU_MESH_CPU_DEVICES``), joins the gloo group at ``coordinator``
(``host:port``) and builds ONE global dp × tp mesh over every process's
positions: ``make_mesh(4, ("dp", "tp"))`` over two processes of two is
(1, 4), so tp spans the processes.

Phases (the checkpoint / restart drill):

- ``fresh``: one MobileNet-v2 training step (16 classes, 32×32 uint8
  images, the same seeded batch on every process), every process saving
  its pieces of the state; after a barrier the primary records the
  post-step eval loss.
- ``resume``: a new process set restores the checkpoint straight onto the
  mesh, reproduces the recorded eval loss within 1e-6 and takes one more
  finite step.

The weights are the npz's (leaves ``p{i}`` in the reference's tree-flatten
order, ``models/mobilenet_v2.py load_jax_npz``) or, without one, random
from seed 0.

A test hook: ``NNS_TPU_DRILL_DTYPE=float64`` runs the model and the step
in float64, so that a test can hold the step's loss and parameters to a
float64 reference tightly (in float32 this gradient is ill-conditioned;
``tests/test_torch_train.py``).
"""

from __future__ import annotations

import os
import sys


def run_phase(phase: str, pid: int, nprocs: int, coordinator: str, workdir: str,
              positions_per_proc: int = 4, weights: str = "") -> None:
    os.environ["NNS_TPU_MESH_CPU_DEVICES"] = str(positions_per_proc)

    import numpy as np
    import torch

    from nnstreamer_tpu_torch.models import mobilenet_v2
    from nnstreamer_tpu_torch.parallel import checkpoint as ckpt
    from nnstreamer_tpu_torch.parallel import multihost
    from nnstreamer_tpu_torch.parallel.mesh import make_mesh
    from nnstreamer_tpu_torch.parallel.train import make_train_step

    torch.set_num_threads(2)
    multihost.initialize(coordinator_address=coordinator, num_processes=nprocs,
                         process_id=pid, device="cpu")
    info = multihost.process_info()
    if info["process_count"] != nprocs or info["global_devices"] != nprocs * positions_per_proc:
        raise SystemExit(f"process group {info}")

    mesh = make_mesh(info["global_devices"], axes=("dp", "tp"), devices="cpu")
    dp = mesh.shape["dp"]
    batch = max(2 * dp, dp)
    model = mobilenet_v2.MobileNetV2(num_classes=16, generator=torch.Generator().manual_seed(0))
    if weights:
        mobilenet_v2.load_jax_npz(model, weights)
    float_dtype = getattr(torch, os.environ.get("NNS_TPU_DRILL_DTYPE", "float32"))
    model = model.to(float_dtype)

    def host_batch(seed, shape, hi, dtype):
        # the same host data on every process; each takes the rows it holds
        return torch.from_numpy(np.random.default_rng(seed).integers(0, hi, shape).astype(dtype))

    shape = (batch, 32, 32, 3)
    images = host_batch(0, shape, 255, np.uint8)
    labels = host_batch(1, (batch,), 16, np.int32)
    images2 = host_batch(2, shape, 255, np.uint8)
    labels2 = host_batch(3, (batch,), 16, np.int32)

    ckpt_path = os.path.join(workdir, "pod_ckpt")
    loss_file = os.path.join(workdir, "eval_loss.txt")
    step, params, opt_state = make_train_step(mesh, model, compute_dtype=float_dtype)
    if phase == "fresh":
        params, opt_state, loss = step(params, opt_state, images, labels)
        if not np.isfinite(float(loss)):
            raise SystemExit(f"non-finite loss {loss}")
        ckpt.save(ckpt_path, {"params": params})
        l2 = float(step.loss(params, images2, labels2))
        multihost.barrier("fresh-saved")
        if multihost.is_primary():
            with open(loss_file, "w") as f:
                f.write(repr(l2))
        print(f"proc{pid} fresh ok loss={float(loss)!r} eval={l2!r}", flush=True)
    elif phase == "resume":
        # a simulated restart: nothing survives but the checkpoint, restored
        # straight onto this process set's mesh
        restored = ckpt.restore(ckpt_path, like={"params": params},
                                shardings={"params": step.shardings})["params"]
        l2 = float(step.loss(restored, images2, labels2))
        with open(loss_file) as f:
            want = float(f.read())
        if abs(l2 - want) >= 1e-6:
            raise SystemExit(f"restored eval loss {l2!r} != recorded {want!r}")
        params, opt_state, loss = step(restored, opt_state, images2, labels2)
        if not np.isfinite(float(loss)):
            raise SystemExit(f"non-finite resumed loss {loss}")
        print(f"proc{pid} resume ok eval={l2!r} next={float(loss)!r}", flush=True)
    else:
        raise SystemExit(f"unknown phase {phase!r}")
    multihost.shutdown()


if __name__ == "__main__":
    run_phase(
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5],
        int(sys.argv[6]) if len(sys.argv) > 6 else 4,
        sys.argv[7] if len(sys.argv) > 7 else "",
    )
