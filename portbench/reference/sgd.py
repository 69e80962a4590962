"""Plain SGD with momentum, and the readings a check compares.

The update is ``torch.optim.SGD``'s: ``d = g + wd * p``; the trace
``m = d`` at the first step and ``m = momentum * m + d`` after; ``p -=
lr * m``.
"""

from __future__ import annotations

import torch


@torch.no_grad()
def sgd_step(params: dict, grads: dict, trace: dict, lr: float,
             momentum: float, weight_decay: float) -> None:
    for name, p in params.items():
        d = grads[name] + weight_decay * p if weight_decay else grads[name]
        if name in trace:
            trace[name].mul_(momentum).add_(d)
        else:
            trace[name] = d.clone()
        p.sub_(lr * trace[name])


def leaf_norms(tensors: dict) -> dict:
    """The float32 norm of each tensor, as Python floats."""
    names = list(tensors)
    if not names:
        return {}
    norms = torch.stack([tensors[n].detach().float().norm() for n in names])
    return dict(zip(names, norms.tolist()))
