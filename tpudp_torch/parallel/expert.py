"""Expert parallelism for MoE GPT-2 — the port of
``tpudp/parallel/expert.py``.

The mesh is ``(data, expert)`` and every rank is a data-parallel worker:
the token batch shards over the flattened grid (rank r takes rows block
r, as JAX's ``P((data, expert))``), while each MoE layer's stacked
``(E, ...)`` expert weights shard their leading axis over ``expert``, so
this rank holds ``E / n`` experts and the layer's all-to-all over the
``expert`` group (``tpudp_torch.models.moe``, bound by
:func:`tpudp_torch.mesh.bind_axes`) carries the tokens to them and back.

Gradients, as JAX assembles them: shared parameters (attention, norms,
router gate, embeddings) take their mean over the whole mesh; expert
parameters their mean over ``data``, divided by the ``expert`` size (the
other columns contribute exactly zero to these experts, so the division
stands for the missing zero terms of a whole-mesh mean).  The objective
adds ``aux_loss_coef`` times the layers' balance loss; the returned loss
is the cross entropy alone, the mesh's mean.
"""

from __future__ import annotations

import torch.distributed as dist
from torch import nn

from tpudp_torch.mesh import bind_axes
from tpudp_torch.models import gpt2
from tpudp_torch.models.norm import DATA_AXIS
from tpudp_torch.parallel.sharded import (Layout, Leaf, apply_update, axis_of,
                                          cross_entropy, dim_leaf, eval_sums,
                                          from_standard, grads_of, mean_over,
                                          new_state, refuse_skip,
                                          require_gpt2)
from tpudp_torch.train import _codec, with_aux

EXPERT_AXIS = "expert"


def _check(model, mesh, expert_axis):
    require_gpt2(model, "ep")
    cfg = model.config
    if cfg.mlp_impl != "moe" or cfg.expert_axis != expert_axis:
        raise ValueError(f"expert parallelism needs a model built with "
                         f"mlp_impl='moe', expert_axis={expert_axis!r} (got "
                         f"{cfg.mlp_impl!r}, {cfg.expert_axis!r})")
    _, n, _ = axis_of(mesh, expert_axis)
    if cfg.num_experts % n:
        raise ValueError(f"{cfg.num_experts} experts not divisible by "
                         f"expert-axis size {n}")


def make_ep_train_step(model: nn.Module, optimizer, mesh, state, *,
                       data_axis: str = DATA_AXIS,
                       expert_axis: str = EXPERT_AXIS,
                       aux_loss_coef: float = 0.01):
    """DP x EP (JAX's ``make_ep_train_step``): returns ``(ep_state,
    step)``, ``ep_state.model`` this rank's GPT-2 with ``E / n`` experts
    a layer; ``step(state, tokens, targets)`` on this rank's rows."""
    _check(model, mesh, expert_axis)
    refuse_skip(optimizer, "ep")
    cfg = model.config
    egroup, n, e = axis_of(mesh, expert_axis)
    dgroup, dn, _ = axis_of(mesh, data_axis)
    world = dist.group.WORLD
    device = next(model.parameters()).device
    local = gpt2.GPT2(cfg, local_experts=cfg.num_experts // n).to(device)
    leaves = [dim_leaf(name, p, 0, egroup, n, e) if ".moe.experts_" in name
              else Leaf(name, p) for name, p in local.named_parameters()]
    built = from_standard(state, new_state(local, optimizer, leaves,
                                           Layout(leaves, _codec(model))))
    local.requires_grad_(True).train()
    experts = [lf for lf in leaves if lf.group is not None]
    shared = [lf for lf in leaves if lf.group is None]
    size = dn * n

    def step(st, tokens, targets):
        st.optimizer.zero_grad(set_to_none=True)
        with bind_axes({expert_axis: egroup}):
            ce = cross_entropy(local(tokens, train=True), targets)
            with_aux(local, ce, aux_loss_coef).backward()
        grads_of(leaves)
        loss = ce.detach().reshape(1)
        mean_over([lf.local.grad for lf in shared] + [loss], world, size)
        expert_grads = [lf.local.grad for lf in experts]
        mean_over(expert_grads, dgroup, dn)
        for g in expert_grads:
            g /= n
        apply_update(st, optimizer, leaves)
        st.step += 1
        loss = loss.reshape(())
        st.loss_sum += loss
        return st, loss

    return built, step


def make_ep_eval_step(model: nn.Module, mesh, state, *,
                      data_axis: str = DATA_AXIS,
                      expert_axis: str = EXPERT_AXIS):
    """Expert-parallel eval (JAX's ``make_ep_eval_step``): this rank's
    rows through its experts and the all-to-alls, the weighted metrics
    summed over the mesh."""
    egroup, _, _ = axis_of(mesh, expert_axis)
    axis_of(mesh, data_axis)
    world = dist.group.WORLD

    def eval_step(st, tokens, targets, weights):
        with bind_axes({expert_axis: egroup}):
            return eval_sums(st.model, tokens, targets, weights, world)

    return eval_step
