"""Collectives of the sharded rungs over ``torch.distributed`` groups, and
the autograd functions that carry gradients through them.

Where JAX writes ``lax.psum``, ``all_gather``, ``psum_scatter``,
``all_to_all`` or ``ppermute`` over a mesh axis and lets autodiff
transpose them, the port calls these on the axis's process group
(``MeshND.group``) and gives each the gradient JAX's transpose gives it:

  * :func:`copy_to_group` — identity forward, sum over the group backward
    (the input of a column-parallel layer);
  * :func:`reduce_from_group` — sum over the group forward, identity
    backward (the output of a row-parallel layer);
  * :func:`gather_from_group` — all-gather along a dim forward, this
    rank's slice of the gradient backward (the gathered tensor feeds
    layers every rank runs whole, so its gradient is the same on each);
  * :func:`gather_to_split` — all-gather along a dim forward, a
    reduce-scatter of the gradient backward: the gathered tensor feeds a
    layer split over the group, so each rank's gradient of it is a
    partial sum (``copy_to_group(gather_from_group(x))`` in one
    collective a direction);
  * :func:`all_to_all_autograd` — ``lax.all_to_all`` over dim 0, its own
    transpose;
  * :func:`ring_shift` — ``lax.ppermute`` one step around the group's
    ring, the reverse step backward.

A group of one rank makes every collective the identity, with no call.
Gloo carries CUDA tensors through ``all_reduce`` itself; its other
collectives here (all-gather, reduce-scatter, all-to-all, send and
receive) are staged through pinned host copies on a CUDA tensor, and
each staged call adds one to ``STATS['staged']``.  With
:func:`timing` on, each collective synchronizes the card before and
after itself and adds its wall time to ``STATS['seconds']``.
"""

from __future__ import annotations

import contextlib
import time

import torch
import torch.distributed as dist

#: Collective calls, those staged through the host, and (under
#: :func:`timing`) their wall seconds.
STATS = {"calls": 0, "staged": 0, "seconds": 0.0}
_TIMING = [False]


def reset_stats() -> None:
    STATS.update(calls=0, staged=0, seconds=0.0)


@contextlib.contextmanager
def timing(on: bool = True):
    """Time every collective inside the block (a sync of the card before
    and after each, so the wall time is the collective's own)."""
    saved = _TIMING[0]
    _TIMING[0] = on
    try:
        yield
    finally:
        _TIMING[0] = saved


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _host(t: torch.Tensor) -> torch.Tensor:
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out


@contextlib.contextmanager
def _call(device: torch.device, staged: bool):
    STATS["calls"] += 1
    STATS["staged"] += int(staged)
    if not _TIMING[0]:
        yield
        return
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        STATS["seconds"] += time.perf_counter() - t0


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place; returns it."""
    if dist.get_world_size(group) == 1:
        return t
    with _call(t.device, False):
        dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's tensors concatenated along ``dim``, rank by rank."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    x = t.movedim(dim, 0).contiguous()
    staged = _staged(x, group)
    with _call(t.device, staged):
        src = _host(x) if staged else x
        out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
        dist.all_gather_into_tensor(out, src, group=group)
        if staged:
            out = out.to(t.device, non_blocking=True)
    return out.movedim(0, dim)


def reduce_scatter(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's chunk (along ``dim``) of ``t`` summed over the group."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    x = t.movedim(dim, 0).contiguous()
    staged = _staged(x, group)
    with _call(t.device, staged):
        src = _host(x) if staged else x
        out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
        dist.reduce_scatter_tensor(out, src, group=group)
        if staged:
            out = out.to(t.device, non_blocking=True)
    return out.movedim(0, dim)


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """``t``'s dim 0 in ``n`` equal chunks, chunk j to rank j; returns the
    chunks received, rank by rank, along dim 0."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    x = t.contiguous()
    staged = _staged(x, group)
    with _call(t.device, staged):
        src = _host(x) if staged else x
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=group)
        if staged:
            out = out.to(t.device, non_blocking=True)
    return out


def shift(tensors: list, group, step: int = 1) -> list:
    """Each tensor sent to the rank ``step`` further around the group's
    ring; returns the tensors received from the rank ``step`` behind."""
    n = dist.get_world_size(group)
    if n == 1 or step % n == 0:
        return list(tensors)
    r = dist.get_rank(group)
    dst = dist.get_global_rank(group, (r + step) % n)
    src = dist.get_global_rank(group, (r - step) % n)
    xs = [t.contiguous() for t in tensors]
    staged = _staged(xs[0], group)
    with _call(xs[0].device, staged):
        sends = [_host(x) if staged else x for x in xs]
        recvs = [torch.empty_like(x) for x in sends]
        ops = ([dist.P2POp(dist.isend, x, dst, group) for x in sends]
               + [dist.P2POp(dist.irecv, y, src, group) for y in recvs])
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        if staged:
            recvs = [y.to(xs[0].device, non_blocking=True) for y in recvs]
    return recvs


class PendingSend:
    """An ``isend`` in flight; :meth:`wait` before reusing its buffer."""

    def __init__(self, work, buf):
        self.work, self.buf = work, buf

    def wait(self) -> None:
        self.work.wait()


def send(t: torch.Tensor, dst: int, group) -> PendingSend:
    """Send ``t`` to group rank ``dst`` without waiting for the receiver."""
    x = t.detach().contiguous()
    staged = _staged(x, group)
    with _call(x.device, staged):
        buf = _host(x) if staged else x
        work = dist.isend(buf, dist.get_global_rank(group, dst), group=group)
    return PendingSend(work, buf)


def recv(shape, dtype, device, src: int, group) -> torch.Tensor:
    """Receive a tensor from group rank ``src``."""
    device = torch.device(device)
    staged = device.type == "cuda" and dist.get_backend(group) == "gloo"
    with _call(device, staged):
        buf = torch.empty(shape, dtype=dtype,
                          pin_memory=staged) if staged else torch.empty(
                              shape, dtype=dtype, device=device)
        dist.recv(buf, dist.get_global_rank(group, src), group=group)
        if staged:
            buf = buf.to(device)
    return buf


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.size = dim, group, x.shape[dim]
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        r = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, r * ctx.size, ctx.size), None, None


class _GatherToSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.dim, ctx.group), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, ctx.group), None


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(shift(list(xs), group, 1))

    @staticmethod
    def backward(ctx, *gs):
        return (None,) + tuple(shift(list(gs), ctx.group, -1))


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    if group is None or dist.get_world_size(group) == 1:
        return x
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    if group is None or dist.get_world_size(group) == 1:
        return x
    return _ReduceFromGroup.apply(x, group)


def gather_from_group(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    if group is None or dist.get_world_size(group) == 1:
        return x
    return _GatherFromGroup.apply(x, dim, group)


def gather_to_split(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    if group is None or dist.get_world_size(group) == 1:
        return x
    return _GatherToSplit.apply(x, dim, group)


def all_to_all_autograd(x: torch.Tensor, group) -> torch.Tensor:
    if dist.get_world_size(group) == 1:
        return x
    return _AllToAll.apply(x, group)


def ring_shift(tensors, group) -> tuple:
    """``lax.ppermute`` of ``tensors`` to the next rank of the group's
    ring, with the reverse permute as its gradient."""
    if dist.get_world_size(group) == 1:
        return tuple(tensors)
    return _RingShift.apply(group, *tensors)
