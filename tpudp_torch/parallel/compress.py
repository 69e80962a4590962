"""Error-feedback int8 gradient compression — the port of
``tpudp/parallel/compress.py``'s ``int8_ef_allreduce``.

Each rank keeps its own residual (the JAX package stacks the residuals
``(N, *shape)`` and shards them over the mesh; here each process simply
holds its row).  A step quantizes ``g / N + residual`` on the shared
``+/-(127 // N)`` grid, sums the int8 buffer exactly around the ring and
dequantizes the mean; the new residual is what the quantization dropped,
so the time-averaged update tracks the true mean gradient.  It replaces
the sync collective: a train step with ``compress='int8_ef'`` runs
``sync='none'``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tpudp_torch.parallel.ring import (flatten_tree, int8_headroom_quantize,
                                       ring_all_reduce)


class Int8ErrorFeedback:
    """int8-wire ring all-reduce with error feedback over ``group`` for
    gradients shaped like ``params``; call it on a rank's gradients to get
    the compressed mean.  ``error`` holds this rank's float32 residuals."""

    def __init__(self, params, group=None):
        self.group = group
        self.error = [torch.zeros_like(p, dtype=torch.float32)
                      for p in params]

    def __call__(self, grads: list[torch.Tensor]) -> list[torch.Tensor]:
        n = dist.get_world_size(self.group)
        corrected = [g.to(torch.float32) / n + e
                     for g, e in zip(grads, self.error)]
        flat, unflatten = flatten_tree(corrected)
        q, scale = int8_headroom_quantize(flat, self.group)
        total = ring_all_reduce(q, self.group)  # int8 wire, exact adds
        mean = unflatten(total.to(torch.float32) * scale, cast=False)
        self.error = unflatten(flat - q.to(torch.float32) * scale,
                               cast=False)
        return [m.to(g.dtype) for m, g in zip(mean, grads)]
