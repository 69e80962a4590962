"""The gradient-synchronization ladder — the port of
``tpudp/parallel/sync.py``, the reference's core.

Each strategy is a function ``(grads, group) -> grads``: it takes this
rank's gradients (a list of tensors) and a process group (``None``: the
default group) and returns the mean gradient over the group's ranks,
the same on every rank.  The train step calls it between the backward
pass and the optimizer update, where the reference calls its sync.

  none        Part 1 — no collective.
  coordinator Part 2a — all-gather, then every rank takes the mean (the
              JAX package's form of gather-to-rank-0, mean, scatter).
  allreduce   Part 2b — all_reduce(SUM) of each gradient, then / world.
  ring        a hand-rolled single-direction ring all-reduce over one flat
              buffer (``ring_uni`` is the same schedule; ``ring_bidir``
              two counter-rotating half-buffers).
  allreduce_hd / allreduce_a2a  halving-doubling, and all-to-all + a
              local sum + all-gather, over one flat buffer.
  allreduce_bf16  gradients cross the wire as bfloat16 and are restored
              to their dtype after the mean (rounded to bf16 even at
              world size 1).
  allreduce_int8  one flat int8 buffer around the ring, on the shared
              ``+/-(127 // N)`` headroom grid; at world size 1 the
              gradients come back untouched.
  auto        Part 3 — the mean of ``allreduce``; the train step gets it
              from ``DistributedDataParallel``'s bucketed all-reduce,
              overlapped with the backward pass, instead of calling it.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from tpudp_torch.parallel.ring import (a2a_all_reduce, all_reduce_mean_tree,
                                       flatten_tree, hd_all_reduce,
                                       int8_headroom_quantize,
                                       ring_all_reduce, ring_all_reduce_mean)

SyncFn = Callable[[list, object], list]


def sync_none(grads, group=None):
    """Part 1: no synchronization."""
    del group
    return grads


def sync_coordinator(grads, group=None):
    """Part 2a: every rank all-gathers each gradient and takes the mean
    (N times the gradient's bytes land on every rank)."""
    n = dist.get_world_size(group)
    out = []
    for g in grads:
        gathered = g.new_empty((n * g.numel(),))
        dist.all_gather_into_tensor(gathered, g.contiguous().reshape(-1),
                                    group=group)
        out.append(gathered.reshape(n, *g.shape).mean(0))
    return out


def sync_allreduce(grads, group=None):
    """Part 2b: all-reduce(SUM) of each gradient, then divide by the
    world size."""
    n = dist.get_world_size(group)
    out = []
    for g in grads:
        total = g.clone()
        dist.all_reduce(total, group=group)
        out.append(total / n)
    return out


def sync_ring(grads, group=None):
    """The hand-rolled single-direction ring over one flat buffer."""
    return ring_all_reduce_mean(grads, group)


sync_ring_uni = sync_ring  # the JAX package's alias of the same schedule


def sync_ring_bidir(grads, group=None):
    """Two counter-rotating half-buffers around the ring."""
    return ring_all_reduce_mean(grads, group, bidirectional=True)


def sync_allreduce_hd(grads, group=None):
    """Recursive halving-doubling over one flat buffer."""
    return all_reduce_mean_tree(grads, group, hd_all_reduce)


def sync_allreduce_a2a(grads, group=None):
    """All-to-all + local sum + all-gather over one flat buffer."""
    return all_reduce_mean_tree(grads, group, a2a_all_reduce)


def sync_allreduce_bf16(grads, group=None):
    """Gradients all-reduced as bfloat16 (half the wire bytes), divided
    by the world size in bfloat16 and cast back to their dtype."""
    n = dist.get_world_size(group)
    out = []
    for g in grads:
        total = g.to(torch.bfloat16)
        dist.all_reduce(total, group=group)
        out.append((total / n).to(g.dtype))
    return out


def sync_allreduce_int8(grads, group=None):
    """One flat int8 buffer around the ring (a quarter of the fp32 wire
    bytes): a shared scale (MAX all-reduce of the max-abs), values on
    the ``+/-(127 // N)`` grid, exact integer sums, then dequantized to
    the mean.  Lossy; at world size 1 the gradients return untouched."""
    n = dist.get_world_size(group)
    if n == 1:
        return grads
    flat, unflatten = flatten_tree(grads, dtype=torch.float32)
    q, unit = int8_headroom_quantize(flat, group)
    total = ring_all_reduce(q, group)  # int8 on the wire, exact adds
    return unflatten(total.to(torch.float32) * (unit / n))


# 'auto' shares allreduce's math; the train step wraps the model in
# DistributedDataParallel, which schedules it (see the module docstring).
sync_auto = sync_allreduce

# The direction each ring rung runs (evidence rows stamp it).
RING_DIRECTION: dict[str, str] = {
    "ring": "uni",
    "ring_uni": "uni",
    "ring_bidir": "bidir",
}

SYNC_STRATEGIES: dict[str, SyncFn] = {
    "none": sync_none,
    "coordinator": sync_coordinator,
    "allreduce": sync_allreduce,
    "allreduce_bf16": sync_allreduce_bf16,
    "allreduce_int8": sync_allreduce_int8,
    "ring": sync_ring,
    "ring_uni": sync_ring_uni,
    "ring_bidir": sync_ring_bidir,
    "allreduce_hd": sync_allreduce_hd,
    "allreduce_a2a": sync_allreduce_a2a,
    "auto": sync_auto,
}

# The ladder minus 'none', which under data parallelism trains divergent
# replicas: what the example CLIs offer as --sync choices.
EXAMPLE_SYNC_CHOICES = tuple(sorted(set(SYNC_STRATEGIES) - {"none"}))


def get_sync(name: str) -> SyncFn:
    try:
        return SYNC_STRATEGIES[name]
    except KeyError:
        raise ValueError(
            f"unknown sync strategy {name!r}; choose from "
            f"{sorted(SYNC_STRATEGIES)}") from None
