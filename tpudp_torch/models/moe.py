"""Mixture-of-Experts MLP — the port of ``tpudp/models/moe.py``.

Switch-style top-1 routing by default, GShard/Mixtral-style top-k
(``top_k >= 2``: choice-major capacity priority, combine weights
renormalized over the chosen experts), with a fixed capacity of
``ceil(capacity_factor * tokens * top_k / num_experts)`` slots an expert,
so every shape is static: dispatch and combine are one-hot einsums and
the experts' FFNs one batched product over the stacked ``(E, ...)``
weights.  The router runs in float32.  A token that finds its expert
full contributes zero (it rides the block's residual).

Expert parallelism: inside :func:`tpudp_torch.mesh.bind_axes` with the
module's ``expert_axis`` bound, the module holds ``E / n`` experts (the
slice of its rank on the axis), one all-to-all over the axis's group
regroups the capacity slots so each rank holds the tokens bound for its
experts, and the reverse all-to-all brings the outputs home
(:func:`tpudp_torch.parallel.collectives.all_to_all_autograd`, its own
gradient).  Unbound, all experts are local: the dense form the EP tests
hold the sharded one to.

The balance metrics (each expert's load fraction and the Switch aux loss
``E * sum(f_e * P_e)``) of the last forward stay on the module as
``moe_load`` and ``moe_aux``, where :func:`collect_moe_aux` finds them,
as flax sows them into ``intermediates``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from tpudp_torch.mesh import axis_group
from tpudp_torch.parallel.collectives import all_to_all_autograd

#: The MoE parameters, flax's names, in the layout flax stores them.
PARAM_NAMES = ("gate", "experts_w1", "experts_b1", "experts_w2",
               "experts_b2")


def collect_moe_aux(model: nn.Module):
    """Mean of the ``moe_aux`` of every MoE layer of ``model``'s last
    forward (0.0 when it has none), the harvest both the default train
    step and the EP rung add to their loss."""
    auxes = [m.moe_aux for m in model.modules()
             if isinstance(m, MoeMlp) and m.moe_aux is not None]
    if not auxes:
        return 0.0
    return sum(auxes) / len(auxes)


class MoeMlp(nn.Module):
    """``(..., d) -> (..., d)``, the flax ``MoeMlp`` with its attributes;
    ``local_experts`` (default ``num_experts``) is the number of experts
    this module holds, ``num_experts / n`` on a rank of an expert axis
    of ``n`` ranks.  Parameters stay float32; the experts compute in
    ``dtype``."""

    def __init__(self, d_model: int, num_experts: int = 8,
                 mlp_ratio: int = 4, capacity_factor: float = 1.25,
                 top_k: int = 1, expert_axis: str | None = None,
                 dtype: torch.dtype = torch.float32,
                 local_experts: int | None = None):
        super().__init__()
        if not 1 <= top_k <= num_experts:
            raise ValueError(f"top_k={top_k} must be in [1, "
                             f"num_experts={num_experts}]")
        self.num_experts, self.top_k = num_experts, top_k
        self.capacity_factor = capacity_factor
        self.expert_axis, self.dtype = expert_axis, dtype
        e, d, f = (local_experts or num_experts), d_model, mlp_ratio * d_model
        self.gate = nn.Parameter(torch.zeros(d, num_experts))
        self.experts_w1 = nn.Parameter(torch.zeros(e, d, f))
        self.experts_b1 = nn.Parameter(torch.zeros(e, f))
        self.experts_w2 = nn.Parameter(torch.zeros(e, f, d))
        self.experts_b2 = nn.Parameter(torch.zeros(e, d))
        self.moe_load = self.moe_aux = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d, e, k = x.shape[-1], self.num_experts, self.top_k
        xt = x.reshape(-1, d)
        t = xt.shape[0]
        group = axis_group(self.expert_axis)
        n = dist.get_world_size(group) if group is not None else 1
        if e % n:
            raise ValueError(f"{e} experts not divisible by expert-axis "
                             f"size {n}")
        if self.experts_w1.shape[0] != e // n:
            raise ValueError(f"this module holds {self.experts_w1.shape[0]} "
                             f"experts; an expert axis of {n} ranks needs "
                             f"{e // n}")
        # --- route (float32) ---
        probs = torch.softmax(xt.float() @ self.gate.float(), dim=-1)
        top_p, top_idx = probs.topk(k, dim=-1)  # (T, k), best first
        weights = top_p / top_p.sum(-1, keepdim=True) if k > 1 else top_p
        onehot_k = F.one_hot(top_idx, e).float()  # (T, k, E)
        # Choice-major queue: every first choice claims a slot before any
        # second choice does.
        capacity = max(int(math.ceil(self.capacity_factor * t * k / e)), 1)
        flat = onehot_k.transpose(0, 1).reshape(k * t, e)
        position = flat.cumsum(0) * flat  # 1-based queue slot
        keep = (position > 0) & (position <= capacity)
        slot = F.one_hot((position.long() - 1).clamp(0, capacity - 1),
                         capacity).float()
        disp_k = (slot * keep[..., None].float()).reshape(k, t, e, capacity)
        dispatch = disp_k.sum(0)  # (T, E, C)
        combine = (disp_k * weights.T[:, :, None, None]).sum(0)
        load = onehot_k.mean((0, 1))
        self.moe_load = load
        self.moe_aux = e * (load * probs.mean(0)).sum()

        expert_in = torch.einsum("tec,td->ecd", dispatch,
                                 xt.float()).to(self.dtype)  # (E, C, d)
        if n > 1:
            # my experts' slots from every peer: (E/n, n * C, d)
            got = all_to_all_autograd(expert_in, group)
            expert_in = got.reshape(n, e // n, capacity, d).transpose(
                0, 1).reshape(e // n, n * capacity, d)
        dt = self.dtype
        h = F.gelu(torch.bmm(expert_in, self.experts_w1.to(dt))
                   + self.experts_b1.to(dt)[:, None], approximate="tanh")
        out = (torch.bmm(h, self.experts_w2.to(dt))
               + self.experts_b2.to(dt)[:, None])
        if n > 1:
            # back to (E, C, d): my tokens' slots, from every expert's rank
            out = out.reshape(e // n, n, capacity, d).transpose(0, 1)
            out = all_to_all_autograd(out.reshape(e, capacity, d), group)
        y = torch.einsum("ecd,tec->td", out.float(), combine)
        return y.to(self.dtype).reshape(x.shape)


def random_params(d_model: int, num_experts: int, mlp_ratio: int,
                  rng: np.random.Generator) -> dict:
    """A flax-layout MoE subtree of float32 numpy weights: normal(0, 0.02)
    gate and expert matrices, small normal biases."""
    f = mlp_ratio * d_model

    def normal(*shape, std=0.02):
        return rng.standard_normal(shape, np.float32) * std

    return {"gate": normal(d_model, num_experts),
            "experts_w1": normal(num_experts, d_model, f),
            "experts_b1": normal(num_experts, f),
            "experts_w2": normal(num_experts, f, d_model),
            "experts_b2": normal(num_experts, d_model)}
