"""Profiling helpers — the port of ``tpudp/utils/profiler.py``.

  * :func:`fetch_fence` — the compute barrier: synchronize the stream a
    tensor's work runs on and read one element of it to the host.
  * :func:`measure_collective` — the grad all-reduce wall time: one mean
    all-reduce of a gradient-shaped tree over a process group
    (``tpudp_torch.parallel.collectives.all_reduce``), fenced.
  * :func:`trace` / :func:`step_annotation` — re-exported from
    ``tpudp_torch.obs.tracing``.
"""

from __future__ import annotations

import time
from typing import Any

import torch

from tpudp_torch.obs.tracing import step_annotation, trace  # noqa: F401


def _leaves(tree: Any) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    return []


def fetch_fence(tree: Any) -> None:
    """Wait for the first tensor of ``tree`` (a tensor, a module, or a
    dict / list / tuple of them): its device's current stream is
    synchronized and one element is read to the host."""
    leaves = _leaves(tree)
    if not leaves:
        return
    t = leaves[0]
    if t.device.type == "cuda":
        torch.cuda.current_stream(t.device).synchronize()
    t.detach().reshape(-1)[:1].cpu()


def measure_collective(grad_tree: Any, group=None, *, steps: int = 20,
                       warmup: int = 3) -> dict:
    """Wall-time one mean all-reduce of ``grad_tree`` over ``group`` (the
    default group when None; the identity at one rank).  Returns
    ``{"allreduce_wall_time_s", "bytes", "gbps"}``, where ``gbps`` counts
    the ring's ``2 (n - 1) / n`` of the payload a rank."""
    import torch.distributed as dist

    from tpudp_torch.parallel.collectives import all_reduce

    size = (dist.get_world_size(group)
            if dist.is_available() and dist.is_initialized() else 1)
    tree = [t.detach().clone() for t in _leaves(grad_tree)]

    def once():
        # In place on the copy: a mean of equal values stays put.
        for t in tree:
            if size > 1:
                all_reduce(t, group)
            t.div_(size)

    once()  # warm
    fetch_fence(tree)
    for _ in range(warmup):
        once()
    fetch_fence(tree)
    t0 = time.perf_counter()
    for _ in range(steps):
        once()
    fetch_fence(tree)
    dt = (time.perf_counter() - t0) / steps
    nbytes = sum(t.numel() * t.element_size() for t in tree)
    wire = 2 * (size - 1) / size * nbytes if size > 1 else 0
    return {"allreduce_wall_time_s": dt, "bytes": nbytes,
            "gbps": (wire / dt / 1e9) if dt > 0 else 0.0}
