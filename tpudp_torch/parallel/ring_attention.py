"""Ring attention — the port of ``tpudp/parallel/ring_attention.py``.

The sequence is sharded over a process group (the mesh's ``seq`` axis):
each rank holds one contiguous block of Q, K and V, the K/V blocks travel
the group's ring (:func:`tpudp_torch.parallel.collectives.ring_shift`),
and each rank accumulates its queries' attention with a float32 online
softmax (running max, denominator and accumulator), masking by *global*
positions, so the result equals single-device causal attention.

JAX gets the backward ring from autodiff (the transpose of ``ppermute``
is the reverse ``ppermute``); here ``ring_shift`` is an autograd
function whose backward sends the cotangents one step back, and
everything else is plain differentiable torch.  JAX's ring attention is
plain ``jnp``, so this is plain torch too: it launches no port kernel.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tpudp_torch.parallel.collectives import ring_shift

_NEG_INF = -1e30


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group, *, causal: bool = True) -> torch.Tensor:
    """Blockwise ring attention over ``group``: ``q, k, v`` are this
    rank's ``(batch, t_local, heads, head_dim)`` blocks of a sequence
    laid out rank by rank; returns this rank's output block in ``q``'s
    dtype."""
    n, i = dist.get_world_size(group), dist.get_rank(group)
    b, t, h, dh = q.shape
    q32 = q.float() * dh ** -0.5
    m = torch.full((b, h, t), _NEG_INF, dtype=torch.float32, device=q.device)
    den = torch.zeros((b, h, t), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, t, h, dh), dtype=torch.float32, device=q.device)
    local = torch.arange(t, device=q.device)
    q_pos = i * t + local
    kv = (k, v)
    for s in range(n):
        k_blk, v_blk = kv
        src = (i - s) % n  # the ring origin of the block held now
        logits = torch.einsum("bqhd,bkhd->bhqk", q32, k_blk.float())
        if causal:
            mask = q_pos[:, None] >= (src * t + local)[None, :]
            logits = torch.where(mask, logits, _NEG_INF)
        m_new = torch.maximum(m, logits.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        if causal:
            p = torch.where(mask, p, 0.0)
        den = den * alpha + p.sum(-1)
        o = o * alpha.transpose(1, 2)[..., None] + torch.einsum(
            "bhqk,bkhd->bqhd", p, v_blk.float())
        m = m_new
        if s < n - 1:
            kv = ring_shift(kv, group)
    out = o / den.clamp_min(1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


def dense_causal_attention(q, k, v) -> torch.Tensor:
    """Single-device causal attention in float32 (the oracle of the
    JAX module, ``dense_causal_attention``)."""
    t, dh = q.shape[1], q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k.float()) * dh ** -0.5
    mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    logits = torch.where(mask, logits, _NEG_INF)
    probs = torch.softmax(logits, -1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)
