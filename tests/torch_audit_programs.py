"""Rank programs for ``tests/test_torch_analysis.py``'s collective
census check, built in the audit's gloo world (``audit.capture_world(
extra=['torch_audit_programs:build'])``): one all-reduce over the
world, and its twin with one collective more."""

import torch
import torch.distributed as dist

from tpudp_torch.parallel import collectives as C


def build(rank, world):
    t = torch.ones(8)
    axes = {id(dist.group.WORLD): "data"}

    def one():
        return C.all_reduce(t.clone(), dist.group.WORLD)

    def two():
        C.all_reduce(t.clone(), dist.group.WORLD)
        return C.all_gather(t.clone(), 0, dist.group.WORLD)

    return {"fixture.reduce@w4": (one, axes),
            "fixture.reduce_gather@w4": (two, axes)}
