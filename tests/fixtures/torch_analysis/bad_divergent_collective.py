"""Seeded violations for divergent-collective."""

import os

import torch.distributed as dist

from tpudp_torch.parallel import collectives as C


def save(t, group, path):
    if dist.get_rank() == 0:
        dist.all_reduce(t)                    # finding: rank 0 only
    if os.path.exists(path):
        C.all_gather(t, 0, group)             # finding: filesystem
    try:
        t = t / 0
    except ZeroDivisionError:
        dist.barrier()                        # finding: except handler
    first = dist.get_rank() == 0
    if first:
        C.all_reduce(t, group)                # finding: derived flag
