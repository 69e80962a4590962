"""BatchNorm for the port's convnets (VGG, ResNet): flax's
``BatchNorm(momentum=0.9, epsilon=1e-5, dtype=float32)`` over the
channels of an NCHW tensor, optionally across the ranks.

Training normalizes with the batch's biased variance and updates the
running variance with that same biased variance (``nn.BatchNorm2d``
would use the unbiased one): ``running = 0.9 * running + 0.1 * batch``.
Evaluation normalizes with the running statistics.  A forward that
``torch.utils.checkpoint`` recomputes in the backward (``remat``) runs
inside :func:`recomputing` and leaves the running statistics alone, so
they move once a step, as flax's do under ``jax.checkpoint``
(:func:`remat_contexts` gives the checkpoint's contexts).

``bn_axis='data'`` (the mesh's ranks, as the JAX models name their data
axis) is cross-rank SyncBN: in training the batch statistics are flax's
with ``axis_name`` — ``_compute_stats`` with ``use_fast_variance``: the
mean over the ranks of each rank's ``E[x]`` and ``E[x^2]``, sent as one
all-reduce, then ``var = max(0, E[x^2] - E[x]^2)``, all in float32.  The
all-reduce carries gradients (:class:`_AllReduceMean`: its backward
all-reduces the cotangent, the transpose of JAX's ``pmean``), so each
rank's backward sees every rank's share of the statistics.  It runs over
whatever backend the default process group has (gloo on the CPU, NCCL
on the card).  The port's GSPMD mode sets it on every BatchNorm of the
model (``train.make_train_step(spmd_mode='gspmd')``).
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

MOMENTUM, EPSILON = 0.9, 1e-5  # flax's keep share, as the JAX models set
DATA_AXIS = "data"


@contextlib.contextmanager
def recomputing(model: nn.Module):
    """The running statistics of ``model``'s BatchNorms stay as they are
    inside the block."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.recomputing = True
    try:
        yield
    finally:
        for m in norms:
            m.recomputing = False


def remat_contexts(model: nn.Module):
    """The ``context_fn`` result of ``torch.utils.checkpoint.checkpoint``
    over ``model``: its forward as it is, the recomputation under
    :func:`recomputing`."""
    return contextlib.nullcontext(), recomputing(model)


class _AllReduceMean(torch.autograd.Function):
    """The mean of a tensor over a group's ranks; its backward is the
    mean over the ranks of the cotangent."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad / dist.get_world_size(ctx.group), None


def all_reduce_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable mean of ``x`` over ``group`` (None: the default
    process group)."""
    if not dist.is_initialized():
        raise RuntimeError("a cross-rank BatchNorm (bn_axis='data') needs a "
                           "process group: call "
                           "tpudp_torch.mesh.initialize_distributed first")
    return _AllReduceMean.apply(x, group)


class BatchNorm(nn.Module):
    """flax's BatchNorm over the channels of an NCHW tensor (see the
    module docstring); ``bn_axis`` is None (this rank's batch) or
    ``'data'`` (every rank's of ``group``: None is the default group,
    a sharded rung passes its ``data`` axis's group)."""

    def __init__(self, channels: int, bn_axis: str | None = None,
                 group=None):
        super().__init__()
        if bn_axis not in (None, DATA_AXIS):
            raise ValueError(f"bn_axis must be None or {DATA_AXIS!r}, got "
                             f"{bn_axis!r}")
        self.bn_axis = bn_axis
        self.group = group
        self.recomputing = False  # see recomputing()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def _update_running(self, mean, var) -> None:
        if self.recomputing:
            return
        with torch.no_grad():
            self.running_mean.mul_(MOMENTUM).add_(mean, alpha=1 - MOMENTUM)
            self.running_var.mul_(MOMENTUM).add_(var, alpha=1 - MOMENTUM)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        x = x.float()
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, EPSILON)
        if self.bn_axis is None:
            with torch.no_grad():
                var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self._update_running(mean, var)
            return F.batch_norm(x, None, None, self.weight, self.bias, True,
                                0.0, EPSILON)
        moments = torch.stack([x.mean(dim=(0, 2, 3)),
                               (x * x).mean(dim=(0, 2, 3))])
        mean, mean2 = all_reduce_mean(moments, self.group).unbind()
        var = torch.clamp_min(mean2 - mean * mean, 0.0)
        self._update_running(mean.detach(), var.detach())
        # flax's _normalize: (x - mean) * (rsqrt(var + eps) * scale) + bias
        mul = torch.rsqrt(var + EPSILON) * self.weight
        return ((x - mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None])
