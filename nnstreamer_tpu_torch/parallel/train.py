"""MobileNet-v2's training step over a dp × tp mesh.

The counterpart of ``nnstreamer_tpu/parallel/train.py``, where one jit's
shardings let GSPMD place the work. Here the step places it itself:

- **dp**: the batch splits into one contiguous block a row (a dp
  position); a row's stem and blocks run at its first position. Batch
  norm takes the *global* batch's moments, as the reference's
  ``jnp.mean`` / ``jnp.var`` do under GSPMD: every row's partial sums
  meet before any row normalizes (``models/nn.py batch_moments``), so
  dp = 2 is the model dp = 1 is.
- **tp**: the head conv is column-parallel (tp position j holds output
  channels [j·1280/tp, (j+1)·1280/tp) of its weight and batch-norm
  vectors, so the batch norm stays local), and the classifier is
  row-parallel (position j holds the matching 1280/tp feature columns
  of its ``nn.Linear`` weight, dim 1; dim 0 of the reference's
  (1280, classes)), the partial logits summed over tp.
- everything else is replicated; the optimizer's momentum buffers lie as
  their parameters do. The update is ``torch.optim.SGD(momentum=0.9)``,
  whose rule is optax's ``sgd(momentum=0.9)`` (the trace starts at zero:
  ``b ← 0.9·b + g``, ``p ← p − lr·b``).

Over a mesh that spans processes (``parallel/multihost.py``), a dp row
either lies in one process (dp split over processes: the batch-norm sums
and the loss are all-reduced) or spans every process (tp split over
processes, dp = 1: the partial logits are all-reduced), as the
reference's two-process drill lays ``make_mesh(4, ("dp", "tp"))`` out.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from nnstreamer_tpu_torch.models import mobilenet_v2
from nnstreamer_tpu_torch.models.nn import batch_moments, conv_bn_train
from nnstreamer_tpu_torch.parallel.mesh import Mesh, Sharding
from nnstreamer_tpu_torch.parallel.spmd import (
    ShardedTensor,
    all_reduce,
    load_state,
    loss_scale,
    module_at,
    place_state,
    sum_to,
    sync_grads,
)


def param_shardings(mesh: Mesh, model: mobilenet_v2.MobileNetV2) -> Dict[str, Sharding]:
    """tp on the head conv's output channels (its weight's dim 0 and its
    batch-norm vectors) and on the classifier's feature columns (its
    weight's dim 1); every other leaf replicated."""
    out = {}
    for name in model.state_dict():
        if name == "classifier.weight":
            spec: Tuple = (None, "tp")
        elif name.startswith("head."):
            spec = ("tp",)
        else:
            spec = ()
        out[name] = Sharding(mesh, spec)
    return out


def loss_fn(model: mobilenet_v2.MobileNetV2, images: torch.Tensor, labels: torch.Tensor,
            compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Mean cross entropy of the train-mode logits, on one device."""
    logits = mobilenet_v2.train_forward(model, images, compute_dtype)
    return F.cross_entropy(logits, labels.long())


def _layout(mesh: Mesh) -> str:
    """"local" (one process), "rows" (each dp row in one process) or
    "columns" (every dp row spans every process)."""
    if set(mesh.axis_names) - {"dp", "tp"}:
        raise ValueError(f"the train step's mesh has axes dp and tp, not {mesh.axis_names}")
    if mesh.n_processes == 1:
        return "local"
    everyone = set(mesh.ranks.flat)
    rows = [{int(mesh.ranks[mesh.position(dp=i, tp=j)]) for j in range(mesh.axis_size("tp"))}
            for i in range(mesh.axis_size("dp"))]
    if all(len(r) == 1 for r in rows):
        return "rows"
    if all(r == everyone for r in rows):
        return "columns"
    raise ValueError("a dp row must lie in one process or span every process")


class TrainStep:
    """``step(params, opt_state, images, labels)`` → (params, opt_state,
    loss): one step on a uint8/float NHWC batch. ``params`` and
    ``opt_state`` are the step's own state (dicts of
    :class:`~.spmd.ShardedTensor` by state-dict name, updated in place), or
    trees of the same layout (a restored checkpoint) which the step takes
    in first."""

    def __init__(self, mesh: Mesh, model: mobilenet_v2.MobileNetV2, learning_rate: float,
                 compute_dtype: torch.dtype) -> None:
        self.mesh, self.compute_dtype = mesh, compute_dtype
        self.layout = _layout(mesh)
        self.shardings = param_shardings(mesh, model)
        self.params = place_state(model, self.shardings)
        self.opt_state = {name: st.zeros_like() for name, st in self.params.items()}
        self.modules = {idx: module_at(model, idx, self.params)
                        for idx in np.ndindex(*mesh.devices.shape) if mesh.is_local(idx)}
        pieces = [(p, self.opt_state[name].pieces[idx])
                  for name, st in self.params.items() for idx, p in st.local()]
        self.opt = torch.optim.SGD([p for p, _ in pieces], lr=learning_rate, momentum=0.9)
        for p, buf in pieces:
            self.opt.state[p]["momentum_buffer"] = buf
        self.dp, self.tp = mesh.axis_size("dp"), mesh.axis_size("tp")
        # each row this process computes, at its first position here
        self.homes = {}
        for i in range(self.dp):
            here = [mesh.position(dp=i, tp=j) for j in range(self.tp)
                    if mesh.is_local(mesh.position(dp=i, tp=j))]
            if here:
                self.homes[i] = here[0]
        reduce = functools.partial(all_reduce, mesh=mesh) if self.layout == "rows" else None
        self.moments = functools.partial(batch_moments, reduce=reduce)

    def forward(self, images, labels) -> torch.Tensor:
        """The loss on the global batch (replicated on every process)."""
        mesh, dtype = self.mesh, self.compute_dtype
        images, labels = torch.as_tensor(images), torch.as_tensor(labels)
        if images.shape[0] % self.dp:
            raise ValueError(f"batch {images.shape[0]} does not divide over {self.dp} dp rows")
        rows = sorted(self.homes)
        dev = {i: mesh.devices[self.homes[i]] for i in rows}
        xs = [images.chunk(self.dp)[i].to(dev[i]) for i in rows]
        trunk = mobilenet_v2.train_trunk([self.modules[self.homes[i]] for i in rows], xs, dtype,
                                         self.moments)
        partial = {i: [] for i in rows}
        for j in range(self.tp):
            col = [(i, mesh.position(dp=i, tp=j)) for i in rows
                   if mesh.is_local(mesh.position(dp=i, tp=j))]
            if not col:
                continue
            heads = conv_bn_train([self.modules[idx].head for _, idx in col],
                                  [trunk[rows.index(i)].to(mesh.devices[idx]) for i, idx in col],
                                  self.moments)
            for (i, idx), h in zip(col, heads):
                w = self.modules[idx].classifier.weight  # [classes, 1280/tp]
                partial[i].append(h.mean(dim=(2, 3)) @ w.to(h.dtype).t())
        sums = []
        for i in rows:
            logits = sum_to(partial[i], dev[i])
            if self.layout == "columns":
                logits = all_reduce(logits, mesh)
            bias = self.modules[self.homes[i]].classifier.bias
            logits = (logits + bias.to(logits.dtype)).float()
            label = labels.chunk(self.dp)[i].to(dev[i]).long()
            sums.append(F.cross_entropy(logits, label, reduction="sum"))
        total = sum_to(sums, dev[rows[0]])
        if self.layout == "rows":
            total = all_reduce(total, mesh)
        return total / images.shape[0]

    def _take(self, params, opt_state=None) -> None:
        if params is not self.params:
            load_state(self.params, params)
        if opt_state is not None and opt_state is not self.opt_state:
            load_state(self.opt_state, opt_state)

    def loss(self, params, images, labels) -> torch.Tensor:
        """The train-mode loss on a batch with ``params`` (taken in as a
        step would), no gradient."""
        self._take(params)
        with torch.no_grad():
            return self.forward(images, labels)

    def __call__(self, params, opt_state, images, labels):
        self._take(params, opt_state)
        loss = self.forward(images, labels)
        (loss * loss_scale(self.mesh)).backward()
        sync_grads(self.params)
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        return self.params, self.opt_state, loss.detach()


def make_train_step(mesh: Mesh, model: mobilenet_v2.MobileNetV2,
                    learning_rate: float = 0.05,
                    compute_dtype: torch.dtype = torch.float32,
                    ) -> Tuple[TrainStep, Dict[str, ShardedTensor], Dict[str, ShardedTensor]]:
    """(step, params, opt_state): ``model``'s weights copied onto the mesh
    (the model itself is never changed), zero momentum buffers beside
    them."""
    step = TrainStep(mesh, model, learning_rate, compute_dtype)
    return step, step.params, step.opt_state
