"""The corrected twin: every rank reaches every collective; only host
work is rank-dependent."""

import os

import torch.distributed as dist


def save(t, path):
    dist.all_reduce(t)
    ok = os.path.exists(path)
    if dist.get_rank() == 0:
        print("saved", ok)
    n, r = dist.get_world_size(), dist.get_rank()
    for s in range(n):
        if s < n - 1:
            dist.all_reduce(t)               # uniform: n is the world size
    return r
