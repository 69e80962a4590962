"""Train, eval and forward steps — the port of ``tpudp/train.py``'s
``make_optimizer``, ``TrainState``, ``init_state``, ``make_train_step``
(its single-device, ``shard_map`` and ``gspmd`` data-parallel branches),
``eval_metrics``, ``make_eval_step`` and ``make_forward_step``.

  * :func:`make_optimizer` returns an :class:`OptimizerSpec`, the
    counterpart of the optax chain: SGD with momentum and the weight
    decay added to the gradient before the momentum trace (exactly
    ``torch.optim.SGD``), or AdamW with optax's defaults; optional
    global-norm clipping by optax's own rule; constant, ``'cosine'`` or
    ``'linear'`` learning-rate schedules by optax's formulas, evaluated at
    optax's step count (0 for the first update); ``compress='int8_ef'``,
    the error-feedback int8 all-reduce that optax runs first in its chain.
  * :func:`init_state` turns the model's gradients on and builds the
    ``torch.optim`` optimizer (and, for ``compress``, this rank's
    error-feedback residuals); :class:`TrainState` carries the model, the
    optimizer, the host step count and a device-resident ``loss_sum``
    that the host reads only when it logs (the step never calls
    ``.item()``).
  * :func:`make_train_step` returns ``step(state, inputs, targets) ->
    (state, loss)``: forward in training mode, mean cross entropy,
    backward, and with a :class:`~tpudp_torch.mesh.Mesh` the sync rung
    (``tpudp_torch.parallel.sync``), the loss and the model's buffers
    (BatchNorm's running statistics) averaged over the ranks, then
    clipping and the optimizer update.  ``sync='auto'`` wraps the model
    in ``DistributedDataParallel(broadcast_buffers=False)``, whose
    bucketed all-reduce overlaps the backward pass.  ``spmd_mode='gspmd'``
    is JAX's partitioned global program: the ``'auto'`` rung over the
    model with every BatchNorm set to ``bn_axis='data'``, so the loss,
    the statistics and the mean gradient are those of one device at the
    global batch.  PyTorch updates the
    parameters and the optimizer state in place where JAX returns new
    ones, so the returned state is the same object, advanced.

``skip_nonfinite=N`` is optax's ``apply_if_finite``: a step whose
gradients hold a NaN or Inf leaves the parameters and the optimizer state
as they were, decided on the device (the step snapshots them and puts
them back with ``torch.where``), until N consecutive bad steps let the
update through.  With a learning-rate schedule the schedule's count lives
on the device beside those counters (``skip["schedule_count"]``) and
advances only on an applied update, as optax's inner state does; the
learning rate is computed from it on the device
(:meth:`OptimizerSpec.lr_tensor`), so the step adds no host sync.

``init_state(track_sdc=True)`` allocates ``TrainState.sdc_fp``, the
in-step silent-data-corruption fingerprint (``tpudp_torch.sdc``): every
step recomputes it after the update, on the device, as JAX's jitted step
does, over the parameters and the optimizer's per-parameter buffers (a
buffer torch has not made yet counts as zeros, as optax's trace starts).  :func:`state_to_jax` and :func:`load_state` carry a
state to and from the JAX package's checkpoint layout
(``tpudp_torch.utils.checkpoint``).

``remat=True`` recomputes the model's forward in the backward
(``torch.utils.checkpoint`` around the whole forward, JAX's
``jax.checkpoint`` around ``apply_model``): the same gradients, bit for
bit, with the activations recomputed instead of kept; BatchNorm's
running statistics move once a step (``tpudp_torch.models.norm.
recomputing``).  ``loss_chunk=N`` (a tied-head LM: GPT-2) takes the
model's final hidden states (``return_hidden=True``) and computes the
cross entropy over N-token chunks (``tpudp_torch.ops.losses``), so the
whole ``(batch * time, vocab)`` logits are never made; the eval and
forward steps take it too.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
import torch.utils.checkpoint

from tpudp_torch.mesh import Mesh
from tpudp_torch.models.norm import DATA_AXIS, BatchNorm
from tpudp_torch.parallel.compress import Int8ErrorFeedback
from tpudp_torch.parallel.sync import get_sync


@dataclass(frozen=True)
class OptimizerSpec:
    """What :func:`make_optimizer` asked for; :func:`init_state` binds it
    to a model's parameters."""

    learning_rate: float
    momentum: float
    weight_decay: float
    schedule: str | None
    warmup_steps: int
    total_steps: int | None
    optimizer: str
    clip_norm: float | None
    compress: str | None = None
    skip_nonfinite: int | None = None

    def lr_at(self, count: int) -> float:
        """The learning rate of update number ``count`` (0-based), by
        optax's schedule formulas."""
        lr = self.learning_rate
        if self.schedule is None:
            return lr
        warm, total = self.warmup_steps, self.total_steps
        if self.schedule == "cosine":
            # warmup_cosine_decay_schedule(0, lr, warm, total): a linear
            # ramp (constant 0 when warm <= 0) joined at `warm` to a
            # cosine decay over total - warm steps.
            if count < warm:
                return _linear(0.0, lr, warm, count)
            decay = total - warm
            c = min(count - warm, decay)
            return lr * 0.5 * (1 + math.cos(math.pi * c / decay))
        # 'linear': join_schedules([linear(0, lr, max(warm, 1)),
        #                           linear(lr, 0, max(total - warm, 1))],
        #                          [warm])
        if count < warm:
            return _linear(0.0, lr, max(warm, 1), count)
        return _linear(lr, 0.0, max(total - warm, 1), count - warm)

    def lr_tensor(self, count: torch.Tensor) -> torch.Tensor:
        """:meth:`lr_at` of a device count, as a float32 device scalar
        (optax computes its schedules in float32)."""
        c = count.to(torch.float32)
        lr = self.learning_rate
        if self.schedule is None:
            return torch.full((), lr, dtype=torch.float32, device=c.device)
        warm, total = self.warmup_steps, self.total_steps
        if self.schedule == "cosine":
            decay = total - warm
            cos = lr * 0.5 * (1 + torch.cos(
                math.pi * (c - warm).clamp(max=decay) / decay))
            return torch.where(c < warm, _linear_t(0.0, lr, warm, c), cos)
        return torch.where(c < warm, _linear_t(0.0, lr, max(warm, 1), c),
                           _linear_t(lr, 0.0, max(total - warm, 1),
                                     c - warm))

    def build(self, params) -> torch.optim.Optimizer:
        params = list(params)
        if self.optimizer == "adamw":
            # skip_nonfinite puts AdamW's count back on the device, so on
            # a card the count must live there (capturable).
            capturable = (self.skip_nonfinite is not None
                          and params[0].device.type == "cuda")
            return torch.optim.AdamW(params, lr=self.lr_at(0),
                                     betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=self.weight_decay,
                                     capturable=capturable)
        return torch.optim.SGD(params, lr=self.lr_at(0),
                               momentum=self.momentum,
                               weight_decay=self.weight_decay)


def _linear(init: float, end: float, steps: int, count: int) -> float:
    """optax ``linear_schedule(init, end, steps)`` at ``count``; a
    non-positive ``steps`` holds ``init``."""
    if steps <= 0:
        return init
    frac = 1 - min(max(count, 0), steps) / steps
    return (init - end) * frac + end


def _linear_t(init: float, end: float, steps: int,
              count: torch.Tensor) -> torch.Tensor:
    """:func:`_linear` of a float32 device count."""
    if steps <= 0:
        return torch.full_like(count, init)
    frac = 1 - count.clamp(0, steps) / steps
    return (init - end) * frac + end


def make_optimizer(learning_rate: float = 0.1, momentum: float = 0.9,
                   weight_decay: float = 1e-4, *, schedule: str | None = None,
                   warmup_steps: int = 0, total_steps: int | None = None,
                   optimizer: str = "sgd", clip_norm: float | None = None,
                   skip_nonfinite: int | None = None,
                   compress: str | None = None) -> OptimizerSpec:
    """The JAX ``make_optimizer`` with the same arguments and defaults
    (``torch.optim.SGD(lr, momentum, weight_decay)``; see the module
    docstring).  ``momentum`` is ignored by AdamW, as in optax.
    ``compress='int8_ef'`` needs a mesh at :func:`init_state` and a step
    built with ``sync='none'``."""
    if schedule not in (None, "cosine", "linear"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if schedule is not None and total_steps is None:
        raise ValueError(f"{schedule} schedule needs total_steps")
    if schedule == "cosine" and total_steps - warmup_steps <= 0:
        raise ValueError(f"cosine schedule needs total_steps "
                         f"({total_steps}) > warmup_steps ({warmup_steps})")
    if clip_norm is not None and clip_norm <= 0:
        raise ValueError(f"clip_norm must be > 0, got {clip_norm}")
    if optimizer not in ("sgd", "adamw"):
        raise ValueError(f"unknown optimizer {optimizer!r}; choose 'sgd' "
                         f"or 'adamw'")
    if compress not in (None, "int8_ef"):
        raise ValueError(f"unknown compress {compress!r}; choose 'int8_ef'")
    if skip_nonfinite is not None:
        if skip_nonfinite < 1:
            raise ValueError(
                f"skip_nonfinite must be >= 1, got {skip_nonfinite}")
        if compress is not None:
            raise ValueError(
                "skip_nonfinite cannot wrap compress='int8_ef': the "
                "compressed ring collective would run inside a per-rank "
                "decision whose predicate (local-gradient finiteness) can "
                "differ across ranks")
    return OptimizerSpec(learning_rate, momentum, weight_decay, schedule,
                         warmup_steps, total_steps, optimizer, clip_norm,
                         compress, skip_nonfinite)


@dataclass
class TrainState:
    """The model, its ``torch.optim`` optimizer, the number of updates
    taken, the cumulative training loss kept on the device, (with
    ``compress``) this rank's error-feedback compressor, and (with
    ``skip_nonfinite``) optax's ``apply_if_finite`` counters as device
    tensors: ``notfinite_count``, ``last_finite``, ``total_notfinite``.
    ``obs_norms`` (with ``track_grad_norm``) is JAX's ``(2,)`` device
    accumulator of ``[sum |g|, sum |g|^2]`` over the steps, ``|g|`` the
    global norm of the synchronized gradients: the step adds to it on
    the device and only ``Trainer.metrics()`` reads it.  It is
    telemetry, not training state: checkpoints leave it out.  ``sdc_fp``
    (with ``track_sdc``) is the ``(2,)`` int64 ``[checksum, count]`` of
    ``tpudp_torch.sdc.fingerprint`` after the latest update (see the
    module docstring); checkpoints leave it out too."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int
    loss_sum: torch.Tensor
    compressor: Int8ErrorFeedback | None = None
    skip: dict | None = None
    # A sharded rung's map between this rank's tensors and the JAX
    # package's global layout (tpudp_torch.parallel.sharded.Layout).
    layout: object | None = None
    obs_norms: torch.Tensor | None = None
    sdc_fp: torch.Tensor | None = None


def init_state(model: torch.nn.Module, optimizer: OptimizerSpec,
               mesh: Mesh | None = None, *,
               track_grad_norm: bool = False,
               track_sdc: bool = False) -> TrainState:
    """Turn on (and leave on) the model's gradients and bind the
    optimizer to its parameters; a ``compress`` optimizer also gets its
    residuals here, for ``mesh``'s ranks.  ``track_grad_norm`` allocates
    the ``obs_norms`` accumulator, ``track_sdc`` the ``sdc_fp``
    fingerprint slot."""
    model.requires_grad_(True).train()
    device = next(model.parameters()).device
    compressor = None
    if optimizer.compress is not None:
        if mesh is None:
            raise ValueError(f"compress={optimizer.compress!r} needs a "
                             "mesh: it replaces the gradient collective")
        compressor = Int8ErrorFeedback(model.parameters())
    return TrainState(model=model,
                      optimizer=optimizer.build(model.parameters()),
                      step=0,
                      loss_sum=torch.zeros((), dtype=torch.float32,
                                           device=device),
                      compressor=compressor,
                      skip=skip_counters(optimizer, device),
                      obs_norms=(torch.zeros(2, dtype=torch.float32,
                                             device=device)
                                 if track_grad_norm else None),
                      sdc_fp=(torch.zeros(2, dtype=torch.int64,
                                          device=device)
                              if track_sdc else None))


def skip_counters(optimizer: OptimizerSpec, device) -> dict | None:
    """optax ``apply_if_finite``'s counters on ``device`` for a
    ``skip_nonfinite`` optimizer (None otherwise)."""
    if optimizer.skip_nonfinite is None:
        return None
    zero = torch.zeros((), dtype=torch.int32, device=device)
    out = {"notfinite_count": zero.clone(),
           "last_finite": torch.ones((), dtype=torch.bool, device=device),
           "total_notfinite": zero.clone()}
    if optimizer.schedule is not None:
        out["schedule_count"] = zero.clone()
    return out


def _codec(model: torch.nn.Module):
    """``(to_jax, from_jax)`` for ``model``'s family: ``to_jax(state_dict)
    -> (params, batch_stats)`` and ``from_jax(params, batch_stats) ->
    state_dict``, the module's ``params_to_jax`` and ``params_from_jax``
    (the families without BatchNorm take and give no statistics)."""
    from tpudp_torch.models import gpt2, llama, resnet, vgg, vit

    for module, cls in ((vgg, vgg.VGG), (resnet, resnet.ResNet)):
        if isinstance(model, cls):
            return module.params_to_jax, module.params_from_jax
    for module, cls in ((gpt2, gpt2.GPT2), (llama, llama.Llama),
                        (vit, vit.ViT)):
        if isinstance(model, cls):
            return ((lambda sd, m=module: (m.params_to_jax(sd), {})),
                    (lambda params, stats, m=module:
                     m.params_from_jax(params)))
    raise TypeError(f"no JAX layout is known for {type(model).__name__}")


def _adamw(opt: torch.optim.Optimizer) -> bool:
    return isinstance(opt, torch.optim.AdamW)


def _opt_buffers(opt) -> tuple:
    """The names of the optimizer's per-parameter buffers (optax's
    per-parameter leaves: SGD's trace, AdamW's mu and nu)."""
    if _adamw(opt):
        return ("exp_avg", "exp_avg_sq")
    return ("momentum_buffer",) if opt.param_groups[0]["momentum"] else ()


def fingerprint_tensors(opt: torch.optim.Optimizer, params) -> list:
    """What the SDC fingerprint covers for ``params``: each parameter and
    its optimizer buffers, a buffer torch has not made yet as its element
    count (zeros add nothing to the checksum).  optax's scalar leaves
    (AdamW's and a schedule's count, ``apply_if_finite``'s counters) are
    left out."""
    out = list(params)
    for key in _opt_buffers(opt):
        for p in params:
            buf = opt.state.get(p, {}).get(key)
            out.append(buf if buf is not None else p.numel())
    return out


def sdc_fingerprint(state: "TrainState") -> torch.Tensor:
    """The single-device (data-parallel) rung's in-step fingerprint of
    ``state``: its model's parameters and optimizer buffers."""
    from tpudp_torch.sdc import fingerprint

    params = list(state.model.parameters())
    return fingerprint(fingerprint_tensors(state.optimizer, params))


def _gather_residuals(comp: Int8ErrorFeedback) -> list[list[torch.Tensor]]:
    """Every rank's residuals, rank by rank, on every rank (one
    all-gather of their concatenation)."""
    flat = torch.cat([e.reshape(-1) for e in comp.error])
    rows = [torch.empty_like(flat)
            for _ in range(dist.get_world_size(comp.group))]
    dist.all_gather(rows, flat, group=comp.group)
    sizes = [e.numel() for e in comp.error]
    return [[piece.reshape(e.shape) for piece, e in
             zip(row.split(sizes), comp.error)] for row in rows]


def _stack_trees(trees: list[dict]) -> dict:
    if isinstance(trees[0], dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def state_to_jax(state: TrainState) -> dict:
    """The checkpoint tree of ``state``, in the JAX package's names and
    layouts: ``step`` (int32, shape ``()``), ``params`` and
    ``batch_stats`` (flax trees, ``params_to_jax`` of the model's
    family), ``opt_state`` and ``loss_sum`` (float32, shape ``()``), as
    tensors on the model's device.  ``opt_state`` is the port's own form,
    keyed and laid out as the parameters: SGD's ``momentum`` (zeros where
    torch has not made a buffer yet, as optax's trace starts), or
    AdamW's ``mu``, ``nu`` and ``count``; with ``skip_nonfinite`` also
    ``notfinite_count``, ``last_finite`` and ``total_notfinite``.  With
    ``compress`` the tree gains ``compress.error``: every rank's
    residuals stacked ``(N, *shape)`` as the JAX package stacks them —
    gathered from the ranks, so every rank must call this.  A sharded
    rung's state (``state.layout``) is gathered to the same global
    layout by its ranks' collectives."""
    if state.layout is not None:
        return state.layout.to_jax(state)
    model, opt = state.model, state.optimizer
    to_jax, _ = _codec(model)
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    params, stats = to_jax(sd)
    named = list(model.named_parameters())

    def per_param(key, fill=torch.zeros_like):
        return to_jax({n: opt.state.get(p, {}).get(key, None)
                       if opt.state.get(p, {}).get(key, None) is not None
                       else fill(p.detach()) for n, p in named})[0]

    opt_state: dict = {}
    if _adamw(opt):
        opt_state["mu"] = per_param("exp_avg")
        opt_state["nu"] = per_param("exp_avg_sq")
        steps = [opt.state.get(p, {}).get("step") for _, p in named]
        count = next((s for s in steps if s is not None), 0)
        opt_state["count"] = torch.tensor(int(count), dtype=torch.int32)
    elif opt.param_groups[0]["momentum"]:
        opt_state["momentum"] = per_param("momentum_buffer")
    if state.skip is not None:
        opt_state.update(state.skip)
    tree = {"step": torch.tensor(state.step, dtype=torch.int32),
            "params": params, "batch_stats": stats, "opt_state": opt_state,
            "loss_sum": state.loss_sum.detach()}
    if state.compressor is not None:
        names = [n for n, _ in named]
        rows = [to_jax(dict(zip(names, row)))[0]
                for row in _gather_residuals(state.compressor)]
        tree["compress"] = {"error": _stack_trees(rows)}
    return tree


def load_state(state: TrainState, tree: dict) -> TrainState:
    """Load a checkpoint tree (:func:`state_to_jax`'s form) into
    ``state`` in place and return it: the model's parameters and
    buffers, the step counter (which the learning-rate schedule reads),
    ``loss_sum``, the optimizer's buffers — created where a fresh torch
    optimizer has none yet, so the next update continues the saved
    trajectory — the ``skip_nonfinite`` counters and, with ``compress``,
    this rank's row of the stacked residuals.  A sharded rung's state
    takes its ranks' shards of the global tree (``state.layout``)."""
    if state.layout is not None:
        state.layout.load(state, tree)
        return state
    model, opt = state.model, state.optimizer
    _, from_jax = _codec(model)
    stats = tree.get("batch_stats", {})
    model.load_state_dict(from_jax(tree["params"], stats))
    state.step = int(tree["step"])
    state.loss_sum.copy_(torch.as_tensor(np.array(tree["loss_sum"])))
    named = list(model.named_parameters())
    ost = tree.get("opt_state", {})

    def per_param(sub):
        sd = from_jax(sub, stats)
        return [sd[n] for n, _ in named]

    if state.step == 0:  # before the first update torch holds no state
        for _, p in named:
            opt.state.pop(p, None)
    else:
        if _adamw(opt):
            group = opt.param_groups[0]
            on_device = group.get("capturable") or group.get("fused")
            for (_, p), mu, nu in zip(named, per_param(ost["mu"]),
                                      per_param(ost["nu"])):
                st = opt.state[p]
                st["step"] = torch.tensor(
                    float(ost["count"]), dtype=torch.float32,
                    device=p.device if on_device else "cpu")
                st["exp_avg"] = torch.empty_like(p).copy_(mu)
                st["exp_avg_sq"] = torch.empty_like(p).copy_(nu)
        elif "momentum" in ost:
            for (_, p), buf in zip(named, per_param(ost["momentum"])):
                opt.state[p]["momentum_buffer"] = \
                    torch.empty_like(p).copy_(buf)
    if state.skip is not None:
        for key, t in state.skip.items():
            t.copy_(torch.as_tensor(np.array(ost[key])))
    if state.compressor is not None:
        err = tree["compress"]["error"]
        world = dist.get_world_size(state.compressor.group)
        r = dist.get_rank(state.compressor.group)
        n = next(iter(_leaves(err))).shape[0]
        if n != world:
            raise ValueError(f"the checkpoint holds residuals of {n} ranks; "
                             f"this run has {world}")
        row = _map_tree(err, lambda t: t[r])
        device = state.compressor.error[0].device
        state.compressor.error = [t.to(device).clone()
                                  for t in per_param(row)]
    return state


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _map_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float) -> None:
    """optax ``clip_by_global_norm`` in place: every gradient becomes
    ``(g / norm) * max_norm`` when the global norm is ``>= max_norm``.
    The decision stays on the device."""
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def _init_optimizer_state(opt: torch.optim.Optimizer,
                          params: list[torch.Tensor]) -> None:
    """Create the state torch makes lazily at a parameter's first update,
    with the values it would start from (zero momentum; AdamW's zero
    moments and count), so that a guarded update can put it back."""
    for group in opt.param_groups:
        for p in group["params"]:
            st = opt.state[p]
            if st or not any(p is q for q in params):
                continue
            if isinstance(opt, torch.optim.AdamW):
                on_device = group.get("capturable") or group.get("fused")
                st["step"] = torch.zeros(
                    (), dtype=torch.float32,
                    device=p.device if on_device else "cpu")
                st["exp_avg"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
                st["exp_avg_sq"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
            elif group["momentum"]:
                st["momentum_buffer"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)


class _FiniteGuard:
    """optax ``apply_if_finite`` around one update, decided on the
    device: built before the update (it reads the gradients and
    snapshots the parameters and the optimizer state), :meth:`finish`
    after it puts them back where the update was rejected and advances
    the counters.  An update applies when the gradients are finite or
    after ``max_errors`` consecutive non-finite ones; with ``group`` (a
    rung whose ranks update shards) the ranks decide together."""

    def __init__(self, state: TrainState, params: list[torch.Tensor],
                 max_errors: int, group=None):
        _init_optimizer_state(state.optimizer, params)
        self.skip = state.skip
        grads = [p.grad for p in params]
        self.finite = torch.stack(
            [torch.isfinite(g).all() for g in grads]).all()
        if group is not None and dist.get_world_size(group) > 1:
            # shards of one update: every rank takes the same decision
            bad = (~self.finite).to(torch.int32)
            dist.all_reduce(bad, group=group)
            self.finite = bad == 0
        self.count = torch.where(
            self.finite, torch.zeros_like(self.skip["notfinite_count"]),
            self.skip["notfinite_count"] + 1)
        self.apply = self.finite | (self.count > max_errors)
        self.tensors = [p.data for p in params] + [
            v for p in params
            for v in state.optimizer.state[p].values()
            if isinstance(v, torch.Tensor)]
        self.saved = [t.clone() for t in self.tensors]

    def finish(self) -> None:
        for t, old in zip(self.tensors, self.saved):
            apply = self.apply.to(t.device)
            t.copy_(torch.where(apply, t, old))
        sk = self.skip
        sk["notfinite_count"].copy_(self.count)
        sk["last_finite"].copy_(self.finite)
        sk["total_notfinite"].add_((~self.finite).to(torch.int32))
        if "schedule_count" in sk:  # the inner state's count: applied only
            sk["schedule_count"].add_(self.apply.to(torch.int32))


def optimizer_update(state: TrainState, spec: OptimizerSpec) -> None:
    """Set the update's learning rate and take it: ``spec.lr_at(
    state.step)``, or — with ``skip_nonfinite`` and a schedule — the
    schedule at the device count of applied updates
    (``skip["schedule_count"]``), computed on the count's device, on the
    host and on a card alike.  SGD then runs its update by hand with
    that tensor rate (torch's SGD reads a tensor learning rate back to
    the host); AdamW takes it as it is (capturable on a card)."""
    opt = state.optimizer
    count = (state.skip or {}).get("schedule_count")
    if count is None:
        lr = spec.lr_at(state.step)
    else:
        lr = spec.lr_tensor(count)
        if not _adamw(opt):
            _sgd_update(opt, lr)
            return
    for group in opt.param_groups:
        group["lr"] = lr
    opt.step()


def _sgd_update(opt: torch.optim.SGD, lr: torch.Tensor) -> None:
    """``torch.optim.SGD``'s update (weight decay added to the gradient,
    then the momentum trace) with a device learning rate."""
    with torch.no_grad():
        for group in opt.param_groups:
            ps = [p for p in group["params"] if p.grad is not None]
            if not ps:
                continue
            d = [p.grad for p in ps]
            if group["weight_decay"]:
                d = torch._foreach_add(d, ps, alpha=group["weight_decay"])
            if group["momentum"]:
                # the finite guard made every buffer before the update
                d = [opt.state[p]["momentum_buffer"].mul_(group["momentum"])
                     .add_(g) for p, g in zip(ps, d)]
            torch._foreach_add_(ps, [g * -lr for g in d])


def batch_stats(model: torch.nn.Module) -> list[torch.Tensor]:
    """The model's floating-point buffers — the counterpart of flax's
    ``batch_stats`` collection (BatchNorm's running statistics)."""
    return [b for b in model.buffers() if b.is_floating_point()]


def _mean_over_ranks(tensors: list[torch.Tensor], mesh: Mesh) -> None:
    """Replace each tensor by its mean over ``mesh``'s ranks, in place,
    with one all-reduce of their concatenation."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat)
    flat /= mesh.size
    for t, piece in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(piece.reshape(t.shape))


def _check_mesh(mesh) -> None:
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a tpudp_torch.mesh.Mesh or None, "
                        f"got {type(mesh).__name__}")


def with_aux(model: torch.nn.Module, ce: torch.Tensor,
             aux_loss_coef: float) -> torch.Tensor:
    """The objective the gradients follow: ``ce`` plus ``aux_loss_coef``
    times the model's MoE balance loss of its last forward (``ce`` alone
    for a model without MoE layers, or a zero coefficient)."""
    if not aux_loss_coef:
        return ce
    from tpudp_torch.models.moe import collect_moe_aux

    aux = collect_moe_aux(model)
    return ce if isinstance(aux, float) else ce + aux_loss_coef * aux


class _Remat(torch.nn.Module):
    """``model`` whose forward is recomputed in the backward (``remat``);
    a module of its own so that DDP wraps it and the recomputation runs
    the model alone."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, x, **kwargs):
        from tpudp_torch.models.norm import remat_contexts

        return torch.utils.checkpoint.checkpoint(
            self.model, x, use_reentrant=False,
            context_fn=lambda: remat_contexts(self.model), **kwargs)


def _check_loss_chunk(model: torch.nn.Module, loss_chunk) -> None:
    """JAX's condition on ``loss_chunk``: a tied-head LM whose forward
    takes ``return_hidden`` (GPT-2; LLaMA's head is untied)."""
    from tpudp_torch.models import gpt2

    if loss_chunk is not None and loss_chunk < 1:
        raise ValueError(f"loss_chunk must be >= 1 (None: the whole "
                         f"logits), got {loss_chunk}")
    if loss_chunk and not isinstance(model, gpt2.GPT2):
        raise ValueError(f"loss_chunk needs the tied-embedding head of a "
                         f"GPT-2 LM; got {type(model).__name__}")


def _chunked_ce(model, hidden, targets, loss_chunk: int) -> torch.Tensor:
    """The mean tied-head cross entropy of ``hidden`` by chunks."""
    from tpudp_torch.ops.losses import chunked_softmax_xent

    wte = model.wte.weight.to(hidden.dtype)
    return chunked_softmax_xent(hidden, wte, targets,
                                loss_chunk) / targets.numel()


def make_train_step(model: torch.nn.Module, optimizer: OptimizerSpec,
                    mesh: Mesh | None = None, sync: str = "allreduce", *,
                    spmd_mode: str = "shard_map", grad_accum: int = 1,
                    remat: bool = False, loss_chunk: int | None = None,
                    aux_loss_coef: float = 0.01):
    """``step(state, inputs, targets) -> (state, loss)``: mean cross
    entropy of ``model(inputs, train=True)`` over every position (images
    with labels ``(B,)``, or ``(B, T)`` tokens with next-token targets).
    ``grad_accum`` splits the batch into that many equal microbatches and
    takes the mean of their gradients (and losses) before the one
    update, as the JAX step does; BatchNorm sees them one after another.

    With ``mesh`` each rank passes its own shard of the global batch; the
    gradients are reduced by ``sync`` (see the module docstring), and the
    returned loss is the mean over ranks.  Without one, ``sync`` is not
    used (JAX's single-device branch).  ``spmd_mode='gspmd'`` with a
    mesh sets every BatchNorm of ``model`` to ``bn_axis='data'`` (for
    good) and runs the ``'auto'`` rung whatever ``sync`` names, as JAX's
    partitioned step ignores it.  ``sync`` names a rung of
    ``SYNC_STRATEGIES`` or is a function of theirs, ``(grads, group) ->
    grads`` (a rung wrapped to time it, say).  ``step.ddp`` is the
    ``DistributedDataParallel`` wrapper of ``sync='auto'`` (else
    ``None``), for its communication hooks.  ``aux_loss_coef`` weighs the
    MoE layers' balance loss (``tpudp_torch.models.moe.collect_moe_aux``)
    into the gradients, as JAX's step does; the returned loss is the
    cross entropy alone, and a dense model has no such term.  ``remat``
    and ``loss_chunk``: the module docstring."""
    _check_mesh(mesh)
    _check_loss_chunk(model, loss_chunk)
    sync_fn = sync if callable(sync) else get_sync(sync)
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    if spmd_mode not in ("shard_map", "gspmd"):
        raise ValueError(f"unknown spmd_mode {spmd_mode!r}")
    if mesh is not None and spmd_mode == "gspmd":
        if optimizer.compress is not None:
            raise ValueError(f"compress={optimizer.compress!r} needs the "
                             "shard_map DP rung (spmd_mode='shard_map')")
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.bn_axis = DATA_AXIS
        sync = "auto"
    if optimizer.compress is not None and mesh is not None and \
            sync != "none":
        raise ValueError(f"compress={optimizer.compress!r} replaces the sync "
                         f"collective; pass sync='none' (got {sync!r})")
    forward = _Remat(model) if remat else model
    ddp = mesh is not None and sync == "auto"
    if ddp:
        from torch.nn.parallel import DistributedDataParallel

        forward = DistributedDataParallel(forward, broadcast_buffers=False)
    stats = batch_stats(model)
    hidden = {"return_hidden": True} if loss_chunk else {}

    def step(state: TrainState, inputs: torch.Tensor,
             targets: torch.Tensor):
        if inputs.shape[0] % grad_accum:
            raise ValueError(f"batch {inputs.shape[0]} does not split into "
                             f"{grad_accum} equal microbatches")
        opt = state.optimizer
        opt.zero_grad(set_to_none=True)
        loss = torch.zeros((), dtype=torch.float32, device=inputs.device)
        micro = list(zip(inputs.chunk(grad_accum),
                         targets.chunk(grad_accum)))
        for i, (x, y) in enumerate(micro):
            # DDP all-reduces the accumulated gradients once, on the last
            # microbatch's backward.
            quiet = ddp and i < len(micro) - 1
            with forward.no_sync() if quiet else contextlib.nullcontext():
                out = forward(x, train=True, **hidden)
                if loss_chunk:
                    ce = _chunked_ce(model, out, y, loss_chunk)
                else:
                    ce = F.cross_entropy(out.reshape(-1, out.shape[-1]),
                                         y.reshape(-1).long())
                with_aux(model, ce, aux_loss_coef).backward()
            loss = loss + ce.detach()
        params = [p for p in model.parameters() if p.grad is not None]
        if grad_accum > 1:
            for p in params:
                p.grad.div_(grad_accum)
            loss = loss / grad_accum
        if mesh is not None:
            if not ddp:
                synced = sync_fn([p.grad for p in params], None)
                for p, g in zip(params, synced):
                    if g is not p.grad:
                        p.grad.copy_(g)
            loss = loss.reshape(1)
            _mean_over_ranks([loss] + stats, mesh)
            loss = loss.reshape(())
        if state.compressor is not None:
            for p, g in zip(params, state.compressor([p.grad
                                                      for p in params])):
                p.grad.copy_(g)
        if state.obs_norms is not None:
            # The synchronized gradients' global norm, before any
            # clipping, as JAX's apply_gradients takes it.
            gn = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(p.grad.float()) for p in params]))
            state.obs_norms += torch.stack([gn, gn * gn])
        guard = None
        if optimizer.skip_nonfinite is not None:
            guard = _FiniteGuard(state, params, optimizer.skip_nonfinite)
        if optimizer.clip_norm is not None:
            clip_by_global_norm([p.grad for p in params], optimizer.clip_norm)
        optimizer_update(state, optimizer)
        if guard is not None:
            guard.finish()
        if state.sdc_fp is not None:
            state.sdc_fp = sdc_fingerprint(state)
        state.step += 1
        state.loss_sum += loss
        return state, loss

    step.ddp = forward if ddp else None
    return step


def eval_metrics(model: torch.nn.Module, inputs: torch.Tensor,
                 labels: torch.Tensor, weights: torch.Tensor,
                 loss_chunk: int | None = None) -> torch.Tensor:
    """Weighted ``(loss_sum, correct, count)`` of one batch as a float32
    3-vector.  ``weights`` is per sample ``(batch,)``; over tokens each
    sample's weight covers its sequence, so ``count`` counts weighted
    positions.  ``loss_chunk`` (a tied-head LM) computes them over token
    chunks without the whole logits
    (``tpudp_torch.ops.losses.chunked_lm_metrics``)."""
    if loss_chunk:
        from tpudp_torch.ops.losses import chunked_lm_metrics

        with torch.no_grad():
            hidden = model(inputs, train=False, return_hidden=True)
            return chunked_lm_metrics(hidden,
                                      model.wte.weight.to(hidden.dtype),
                                      labels, weights, loss_chunk)
    with torch.no_grad():
        logits = model(inputs, train=False).float()
        labels = labels.long()
        per = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                              labels.reshape(-1),
                              reduction="none").reshape(labels.shape)
        w = weights.float().reshape(
            weights.shape + (1,) * (per.ndim - weights.ndim)).expand(
                per.shape)
        correct = (logits.argmax(-1) == labels).float()
        return torch.stack([(per * w).sum(), (correct * w).sum(), w.sum()])


def make_eval_step(model: torch.nn.Module, mesh: Mesh | None = None,
                   loss_chunk: int | None = None):
    """``eval_step(state, images, labels, weights) -> (loss_sum, correct,
    count)``: padded samples weigh 0; with ``mesh`` each rank evaluates
    its shard and the sums are all-reduced over the ranks.
    ``loss_chunk``: chunked tied-head metrics (:func:`eval_metrics`)."""
    _check_mesh(mesh)
    _check_loss_chunk(model, loss_chunk)

    def eval_step(state, images, labels, weights):
        del state  # the model is updated in place
        sums = eval_metrics(model, images, labels, weights, loss_chunk)
        if mesh is not None:
            dist.all_reduce(sums)
        return tuple(sums.unbind())

    return eval_step


def make_forward_step(model: torch.nn.Module, mesh: Mesh | None = None,
                      loss_chunk: int | None = None):
    """The training-mode forward alone, ``forward(state, images) ->
    logits``, for the ``split`` timing mode: the running statistics it
    would update are put back, as JAX discards its mutated
    ``batch_stats``.  Each rank runs its own shard; nothing is reduced.
    With ``loss_chunk`` (a tied-head LM) it is the forward a chunked
    step runs: the final hidden states, no logits."""
    _check_mesh(mesh)
    _check_loss_chunk(model, loss_chunk)
    stats = batch_stats(model)
    hidden = {"return_hidden": True} if loss_chunk else {}

    def forward(state, images):
        del state
        with torch.no_grad():
            saved = [b.clone() for b in stats]
            logits = model(images, train=True, **hidden)
            for b, s in zip(stats, saved):
                b.copy_(s)
        return logits

    return forward


# The sharded rungs' step builders (JAX: tpudp/train.py) live in
# tpudp_torch.parallel.sharded, which imports this module.
_SHARDED = ("make_tp_train_step", "make_fsdp_train_step",
            "make_zero1_train_step", "make_seq_parallel_train_step",
            "make_sp_eval_step", "resolve_state_shardings")


def __getattr__(name: str):
    if name in _SHARDED:
        from tpudp_torch.parallel import sharded

        return getattr(sharded, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
