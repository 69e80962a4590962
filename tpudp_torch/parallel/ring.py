"""Hand-rolled all-reduce schedules over ``torch.distributed`` — the port
of ``tpudp/parallel/ring.py``.

The JAX package builds these from ``lax.ppermute`` inside ``shard_map``;
here each hop is a ``dist.batch_isend_irecv`` pair between ranks of a
process group (``group=None``: the default group), with the same chunk
walk, so every rank ends with the same sum JAX computes:

  * :func:`ring_all_reduce` — reduce-scatter then all-gather around the
    ring, one flat zero-padded buffer, single-direction by default (two
    counter-rotating half-buffers with ``bidirectional=True``);
  * :func:`hd_all_reduce` — recursive halving and doubling for
    power-of-two worlds (the single ring, with a warning, otherwise);
  * :func:`a2a_all_reduce` — ``all_to_all_single``, a local sum, then
    ``all_gather_into_tensor``.

Integer buffers add with wraparound, as JAX's do: the int8 rungs rely on
:func:`int8_headroom_quantize`'s ``+/-(127 // N)`` clip to keep every
partial ring sum inside int8.
"""

from __future__ import annotations

import warnings

import torch
import torch.distributed as dist


def _world(group) -> tuple[int, int]:
    """``(size, rank)`` of ``group``."""
    return dist.get_world_size(group), dist.get_rank(group)


def _exchange(group, sends: list[tuple[torch.Tensor, int]],
              recvs: list[tuple[torch.Tensor, int]]) -> None:
    """Post every send and receive (peers are ranks of ``group``) and
    wait for all of them."""
    ops = [dist.P2POp(dist.isend, t, group=group, group_peer=r)
           for t, r in sends]
    ops += [dist.P2POp(dist.irecv, t, group=group, group_peer=r)
            for t, r in recvs]
    for req in dist.batch_isend_irecv(ops):
        req.wait()


def _padded(x: torch.Tensor, multiple: int) -> tuple[torch.Tensor, int]:
    flat = x.reshape(-1)
    pad = (-flat.numel()) % multiple
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat, pad


def ring_all_reduce(x: torch.Tensor, group=None, *,
                    bidirectional: bool = False) -> torch.Tensor:
    """Sum ``x`` over ``group`` around an explicit ring; any shape (the
    flat buffer is zero-padded to a multiple of ``directions * size``)."""
    n, i = _world(group)
    if n == 1:
        return x
    ndir = 2 if bidirectional else 1
    flat, pad = _padded(x, ndir * n)
    # parts[d] is direction d's (n, chunk) buffer; chunk c = parts[d][c].
    parts = list(flat.reshape(ndir, n, -1).clone().unbind(0))
    signs = (1, -1)[:ndir]

    # Reduce-scatter: after step s the chunk received from upstream holds
    # the partial sum of s+1 ranks; after n-1 steps rank i owns direction
    # d's fully reduced chunk (i + sign_d) mod n.
    for s in range(n - 1):
        recvs = [torch.empty_like(parts[d][0]) for d in range(ndir)]
        _exchange(group,
                  [(parts[d][(i - sign * s) % n].contiguous(),
                    (i + sign) % n) for d, sign in enumerate(signs)],
                  [(recvs[d], (i - sign) % n)
                   for d, sign in enumerate(signs)])
        for d, sign in enumerate(signs):
            parts[d][(i - sign * (s + 1)) % n] += recvs[d]

    # All-gather: circulate the reduced chunks around each ring.
    outs = [torch.zeros_like(parts[d]) for d in range(ndir)]
    curs = []
    for d, sign in enumerate(signs):
        own = parts[d][(i + sign) % n].clone()
        outs[d][(i + sign) % n] = own
        curs.append(own)
    for s in range(n - 1):
        recvs = [torch.empty_like(c) for c in curs]
        _exchange(group,
                  [(curs[d], (i + sign) % n) for d, sign in enumerate(signs)],
                  [(recvs[d], (i - sign) % n)
                   for d, sign in enumerate(signs)])
        curs = recvs
        for d, sign in enumerate(signs):
            outs[d][(i - sign * s) % n] = curs[d]

    out = torch.stack(outs).reshape(-1)
    if pad:
        out = out[:flat.numel() - pad]
    return out.reshape(x.shape)


def hd_all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``x`` over ``group`` by recursive halving (reduce-scatter over
    log2(n) pairwise exchanges) and doubling (the mirror all-gather).
    A world that is not a power of two takes the single-direction ring,
    with a warning, as the JAX package does."""
    n, i = _world(group)
    if n == 1:
        return x
    if n & (n - 1):
        warnings.warn(
            f"hd_all_reduce needs a power-of-two axis size (got {n}); "
            "falling back to the single-direction ring (the measured "
            "ring_all_reduce default) — timings labeled 'hd' on this "
            "mesh measure the ring schedule", stacklevel=2)
        return ring_all_reduce(x, group)
    levels = n.bit_length() - 1
    flat, pad = _padded(x, n)
    live = flat
    # Halving: at level k keep the half whose next index bit matches this
    # rank's, send the other to the partner at distance n >> (k + 1), and
    # add what it sends back; rank i ends holding chunk i, fully reduced.
    for k in range(levels):
        partner = i ^ (n >> (k + 1))
        mybit = (i >> (levels - 1 - k)) & 1
        halves = live.reshape(2, -1)
        recv = torch.empty_like(halves[0])
        _exchange(group, [(halves[1 - mybit].contiguous(), partner)],
                  [(recv, partner)])
        live = halves[mybit] + recv
    # Doubling: swap with the same partners in reverse; this rank's half
    # goes first where its bit is 0.
    for k in reversed(range(levels)):
        partner = i ^ (n >> (k + 1))
        mybit = (i >> (levels - 1 - k)) & 1
        recv = torch.empty_like(live)
        _exchange(group, [(live.contiguous(), partner)], [(recv, partner)])
        live = torch.cat([recv, live] if mybit else [live, recv])
    if pad:
        live = live[:flat.numel() - pad]
    return live.reshape(x.shape)


def a2a_all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``x`` over ``group`` as an all-to-all reduce-scatter (each rank
    sums the ``n`` chunk rows it receives) and an all-gather."""
    n, _ = _world(group)
    if n == 1:
        return x
    flat, pad = _padded(x, n)
    chunks = flat.reshape(n, -1).contiguous()
    rows = torch.empty_like(chunks)
    dist.all_to_all_single(rows, chunks, group=group)
    own = rows.sum(0)  # the manual reduction
    out = own.new_empty(n * own.numel())
    dist.all_gather_into_tensor(out, own, group=group)
    if pad:
        out = out[:flat.numel() - pad]
    return out.reshape(x.shape)


def flatten_tree(tensors, dtype=None):
    """Pack a list of tensors into one flat vector; returns ``(flat,
    unflatten)``, where ``unflatten(vec, cast=True)`` slices ``vec`` back
    into the original shapes (and, with ``cast``, dtypes)."""
    tensors = list(tensors)
    shapes = [t.shape for t in tensors]
    dtypes = [t.dtype for t in tensors]
    sizes = [t.numel() for t in tensors]
    flat = torch.cat([t.reshape(-1) if dtype is None
                      else t.reshape(-1).to(dtype) for t in tensors])

    def unflatten(vec, cast: bool = True):
        out = []
        for piece, shape, dt in zip(vec.split(sizes), shapes, dtypes):
            piece = piece.reshape(shape)
            out.append(piece.to(dt) if cast else piece)
        return out

    return flat, unflatten


def int8_headroom_quantize(flat: torch.Tensor, group=None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize a flat float32 buffer onto an int8 grid that is safe to
    ring-sum over ``group``: values clipped to ``+/-(127 // n)``, so the
    worst ring partial sum, ``n`` ranks at the clip with one sign, is at
    most 127.  Returns ``(q, unit)``: ``q`` int8 and ``unit`` (one grid
    tick, a float32 scalar shared by every rank through a MAX
    all-reduce) such that ``q * unit ~= flat``."""
    n, _ = _world(group)
    qmax = 127 // n
    if qmax < 1:
        raise ValueError(
            f"int8 ring compression supports at most 127 devices along the "
            f"reduce axis (got {n}): the +/-(127 // N) headroom grid is "
            f"empty — use allreduce_bf16 or shard the axis")
    maxabs = torch.clamp(flat.abs().max(), min=1e-30)
    dist.all_reduce(maxabs, op=dist.ReduceOp.MAX, group=group)
    unit = maxabs / qmax
    q = torch.clamp(torch.round(flat / unit), -qmax, qmax).to(torch.int8)
    return q, unit


def all_reduce_mean_tree(tensors, group, reduce_fn) -> list[torch.Tensor]:
    """Mean-reduce a list of tensors as one flat buffer through any of the
    sum schedules above: flatten, reduce, divide by the world, unflatten."""
    n, _ = _world(group)
    flat, unflatten = flatten_tree(tensors)
    return unflatten(reduce_fn(flat, group) / n, cast=False)


def ring_all_reduce_mean(tensors, group=None, *,
                         bidirectional: bool = False) -> list[torch.Tensor]:
    """Mean-reduce a list of tensors around the ring as one flat buffer."""
    def reduce_fn(flat, g):
        return ring_all_reduce(flat, g, bidirectional=bidirectional)

    return all_reduce_mean_tree(tensors, group, reduce_fn)
