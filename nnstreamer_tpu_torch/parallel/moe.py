"""Mixture-of-experts FFN with expert parallelism over a mesh axis.

The counterpart of ``nnstreamer_tpu/parallel/moe.py``, in its exact dense
form: the expert weights split over the ``ep`` positions (each holds
E/n experts), every expert sees every token with the gates below the
top-k zeroed, each position computes its experts' contribution weighted
by its slice of the router's probabilities, and one sum over the
positions combines them (the reference's ``psum``; here a sum of the
pieces moved to the tokens' device, inside the autograd graph). No
capacity factor, no dropped tokens, no dispatch. The expert form is the
reference's two matrices: ``w_in`` [E, D, F], SiLU, ``w_out`` [E, F, D].

It plugs into the transformer as ``ffn_fn`` (``models/transformer.py
block_ffn``) in place of the SwiGLU MLP.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Sequence

import torch
import torch.nn.functional as F

from nnstreamer_tpu_torch.parallel.mesh import Mesh, Sharding
from nnstreamer_tpu_torch.parallel.spmd import sum_to


def init_moe_params(generator: torch.Generator, d_model: int, d_ff: int, n_experts: int,
                    n_layers: int = 1) -> Dict[str, torch.Tensor]:
    """Stacked per-layer MoE weights (the reference's leaves ``gate``
    [L, D, E], ``w_in`` [L, E, D, F], ``w_out`` [L, E, F, D]), drawn from
    its distributions on the generator's device: router and ``w_in``
    N(0, 1/D), ``w_out`` N(0, 1/F)."""
    dev = generator.device

    def normal(shape, std):
        return torch.randn(shape, generator=generator, device=dev) * std

    std_in, std_out = math.sqrt(1.0 / d_model), math.sqrt(1.0 / d_ff)
    return {
        "gate": normal((n_layers, d_model, n_experts), std_in),
        "w_in": normal((n_layers, n_experts, d_model, d_ff), std_in),
        "w_out": normal((n_layers, n_experts, d_ff, d_model), std_out),
    }


def gate_probs(x: torch.Tensor, gate_w: torch.Tensor, top_k: int) -> torch.Tensor:
    """Router: [B,T,D] → [B,T,E] probabilities, zero outside the top-k,
    renormalized over the kept experts (a tie at the k-th logit keeps
    every tied expert, as the reference's threshold does)."""
    logits = x.float() @ gate_w.float()
    k = min(top_k, logits.shape[-1])
    thresh = torch.topk(logits, k, dim=-1).values[..., -1:]
    masked = torch.where(logits >= thresh, logits, torch.full_like(logits, -math.inf))
    return torch.softmax(masked, dim=-1)


def _experts(x: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor,
             probs: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    hidden = F.silu(torch.einsum("btd,edf->btef", xf, w_in.float()))
    expert_out = torch.einsum("btef,efd->bted", hidden, w_out.float())
    return torch.einsum("bted,bte->btd", expert_out, probs)


def moe_ffn_local(x: torch.Tensor, pieces: Sequence[Dict[str, torch.Tensor]],
                  devices: Sequence[torch.device], top_k: int = 2) -> torch.Tensor:
    """Every ep position's computation and their sum: ``pieces[e]`` holds
    position e's expert slice (``w_in`` [E/n, D, F], ``w_out`` [E/n, F, D])
    and the whole router ``gate`` [D, E], on ``devices[e]``. x [B,T,D] →
    the combined [B,T,D] float32 on x's device."""
    outs = []
    for e, (p, dev) in enumerate(zip(pieces, devices)):
        xe = x.to(dev)
        e_local = p["w_in"].shape[0]
        probs = gate_probs(xe, p["gate"], top_k)[..., e * e_local:(e + 1) * e_local]
        outs.append(_experts(xe, p["w_in"], p["w_out"], probs))
    return sum_to(outs, x.device)


def moe_ffn_dense(x: torch.Tensor, p: Dict[str, torch.Tensor], top_k: int = 2) -> torch.Tensor:
    """Single-device reference: the same math with every expert in one
    place."""
    return _experts(x, p["w_in"], p["w_out"], gate_probs(x, p["gate"], top_k))


def make_moe_ffn(mesh: Mesh, axis: str = "ep", top_k: int = 2) -> Callable:
    """Whole-array entry: (x, p) with ``p`` one layer's whole weights →
    the MoE output, the experts split over ``axis`` (its positions with
    the mesh's other axes at 0)."""
    devices = mesh.along(axis)
    sh = Sharding(mesh, (axis,))

    def ffn(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
        n = len(devices)
        if p["w_in"].shape[0] % n:
            raise ValueError(f"moe: {p['w_in'].shape[0]} experts do not divide over {n} positions")
        w_in, w_out = sh.split(p["w_in"]), sh.split(p["w_out"])
        at = [mesh.position(**{axis: e}) for e in range(n)]
        pieces = [{"gate": p["gate"].to(d), "w_in": w_in[i], "w_out": w_out[i]}
                  for d, i in zip(devices, at)]
        return moe_ffn_local(x, pieces, devices, top_k)

    return ffn
