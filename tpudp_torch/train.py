"""Single-device LM training — the port of ``tpudp/train.py``'s
``make_optimizer``, ``TrainState``, ``init_state`` and the ``mesh is
None`` branch of ``make_train_step``.

  * :func:`make_optimizer` returns an :class:`OptimizerSpec`, the
    counterpart of the optax chain: SGD with momentum and the weight
    decay added to the gradient before the momentum trace (exactly
    ``torch.optim.SGD``), or AdamW with optax's defaults; optional
    global-norm clipping by optax's own rule; constant, ``'cosine'`` or
    ``'linear'`` learning-rate schedules by optax's formulas, evaluated at
    optax's step count (0 for the first update).
  * :func:`init_state` turns the model's gradients on and builds the
    ``torch.optim`` optimizer; :class:`TrainState` carries the model, the
    optimizer, the host step count and a device-resident ``loss_sum``
    that the host reads only when it logs (the step never calls
    ``.item()``).
  * :func:`make_train_step` returns ``step(state, tokens, targets) ->
    (state, loss)``: forward, mean cross entropy, backward, optional
    clipping, the optimizer update, ``loss_sum += loss``.  PyTorch updates
    the parameters and the optimizer state in place where JAX returns new
    ones, so the returned state is the same object, advanced.

Multi-device meshes, ``remat``, chunked losses, skipping non-finite
steps and compressed gradients are later slices: each raises
``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F


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

    def build(self, params) -> torch.optim.Optimizer:
        params = list(params)
        if self.optimizer == "adamw":
            return torch.optim.AdamW(params, lr=self.lr_at(0),
                                     betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=self.weight_decay)
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


def make_optimizer(learning_rate: float = 0.1, momentum: float = 0.9,
                   weight_decay: float = 1e-4, *, schedule: str | None = None,
                   warmup_steps: int = 0, total_steps: int | None = None,
                   optimizer: str = "sgd", clip_norm: float | None = None,
                   skip_nonfinite: int | None = None,
                   compress: str | None = None) -> OptimizerSpec:
    """The JAX ``make_optimizer`` with the same arguments and defaults
    (``torch.optim.SGD(lr, momentum, weight_decay)``; see the module
    docstring).  ``momentum`` is ignored by AdamW, as in optax."""
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
    if skip_nonfinite is not None:
        raise NotImplementedError(
            "skip_nonfinite is not ported yet: ROADMAP.md slice 8 "
            "(robustness: skipping non-finite steps)")
    if compress is not None:
        raise NotImplementedError(
            "compress is not ported yet: ROADMAP.md slice 7 (data-parallel "
            "gradient sync)")
    return OptimizerSpec(learning_rate, momentum, weight_decay, schedule,
                         warmup_steps, total_steps, optimizer, clip_norm)


@dataclass
class TrainState:
    """The model, its ``torch.optim`` optimizer, the number of updates
    taken, and the cumulative training loss kept on the device."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int
    loss_sum: torch.Tensor


def init_state(model: torch.nn.Module, optimizer: OptimizerSpec
               ) -> TrainState:
    """Turn on (and leave on) the model's gradients and bind the
    optimizer to its parameters."""
    model.requires_grad_(True).train()
    device = next(model.parameters()).device
    return TrainState(model=model,
                      optimizer=optimizer.build(model.parameters()),
                      step=0,
                      loss_sum=torch.zeros((), dtype=torch.float32,
                                           device=device))


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float) -> None:
    """optax ``clip_by_global_norm`` in place: every gradient becomes
    ``(g / norm) * max_norm`` when the global norm is ``>= max_norm``.
    The decision stays on the device."""
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def make_train_step(model: torch.nn.Module, optimizer: OptimizerSpec,
                    mesh=None, *, grad_accum: int = 1, remat: bool = False,
                    loss_chunk: int | None = None):
    """``step(state, tokens, targets) -> (state, loss)`` for one device:
    ``(B, T)`` int tokens and next-token targets, mean cross entropy over
    every position.  ``grad_accum`` splits the batch into that many equal
    microbatches and takes the mean of their gradients (and losses)
    before the one update, as the JAX step does."""
    if mesh is not None:
        raise NotImplementedError(
            "a device mesh is not ported yet: ROADMAP.md slice 7 "
            "(data-parallel training over torch.distributed)")
    if remat:
        raise NotImplementedError(
            "remat is not ported yet: ROADMAP.md slice 6b (remat)")
    if loss_chunk is not None:
        raise NotImplementedError(
            "loss_chunk is not ported yet: ROADMAP.md slice 6b (chunked "
            "loss)")
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

    def step(state: TrainState, tokens: torch.Tensor,
             targets: torch.Tensor):
        if tokens.shape[0] % grad_accum:
            raise ValueError(f"batch {tokens.shape[0]} does not split into "
                             f"{grad_accum} equal microbatches")
        opt = state.optimizer
        opt.zero_grad(set_to_none=True)
        loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for x, y in zip(tokens.chunk(grad_accum), targets.chunk(grad_accum)):
            logits = model(x, train=True)
            ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                 y.reshape(-1).long())
            ce.backward()
            loss = loss + ce.detach()
        params = [p for p in model.parameters() if p.grad is not None]
        if grad_accum > 1:
            for p in params:
                p.grad.div_(grad_accum)
            loss = loss / grad_accum
        if optimizer.clip_norm is not None:
            clip_by_global_norm([p.grad for p in params], optimizer.clip_norm)
        for group in opt.param_groups:
            group["lr"] = optimizer.lr_at(state.step)
        opt.step()
        state.step += 1
        state.loss_sum += loss
        return state, loss

    return step
