"""Chunked vocabulary losses for large-vocabulary LM training — the port
of ``tpudp/ops/losses.py``.

The plain LM path makes the whole ``(batch * time, vocab)`` logits
tensor: GPT-2 small at batch 8 and 1,024 tokens holds 8 x 1024 x 50257
float32 logits, about 1.65 GB, live through the softmax backward.
:func:`chunked_softmax_xent` computes the same tied-head cross entropy
over token chunks, each chunk's logits inside a recomputed body
(``torch.utils.checkpoint``, JAX's ``jax.checkpoint`` under
``lax.scan``), so the logits alive at once are one chunk's ``chunk *
vocab``, in the forward and in the backward.
:func:`chunked_lm_metrics` is the eval twin.

These are plain PyTorch operations, not kernels: JAX computes them
outside any Pallas call.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint


def _check(chunk_size: int) -> None:
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")


def _chunk_xent(embedding, hc, tc):
    logits = (hc @ embedding.T).float()
    return F.cross_entropy(logits, tc, reduction="sum")


def chunked_softmax_xent(hidden: torch.Tensor, embedding: torch.Tensor,
                         targets: torch.Tensor,
                         chunk_size: int = 1024) -> torch.Tensor:
    """The SUM of the tied-embedding head's per-token cross entropies,
    float32 (divide by the token count for the mean).

    ``hidden`` ``(..., d_model)`` are the final hidden states (after the
    final LayerNorm), ``embedding`` the ``(vocab, d_model)`` tied table
    (the head is ``h @ embedding.T``, as ``gpt2.lm_head``), ``targets``
    the ``(...)`` labels.  Chunks of ``chunk_size`` tokens (the last
    one ragged) are summed in order; each chunk's logits are recomputed
    in the backward, so the backward's peak matches the forward's.
    Differentiable in ``hidden`` and ``embedding``."""
    _check(chunk_size)
    d = hidden.shape[-1]
    h = hidden.reshape(-1, d)
    t = targets.reshape(-1).long()
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for lo in range(0, h.shape[0], chunk_size):
        total = total + torch.utils.checkpoint.checkpoint(
            _chunk_xent, embedding, h[lo:lo + chunk_size],
            t[lo:lo + chunk_size], use_reentrant=False)
    return total


def chunked_lm_metrics(hidden: torch.Tensor, embedding: torch.Tensor,
                       targets: torch.Tensor, weights: torch.Tensor,
                       chunk_size: int = 1024) -> torch.Tensor:
    """The eval twin: weighted ``(loss_sum, correct, count)`` as a
    float32 3-vector (``tpudp_torch.train.eval_metrics``'s contract)
    without the whole logits.  ``weights`` is per sample ``(batch,)``,
    each sample's weight spread over its tokens as the dense eval does."""
    _check(chunk_size)
    b, d = hidden.shape[0], hidden.shape[-1]
    w = weights.float().reshape((b,) + (1,) * (targets.dim() - 1)).expand(
        targets.shape).reshape(-1)
    h = hidden.reshape(-1, d)
    t = targets.reshape(-1).long()
    loss_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    correct = torch.zeros_like(loss_sum)
    with torch.no_grad():
        for lo in range(0, h.shape[0], chunk_size):
            logits = (h[lo:lo + chunk_size] @ embedding.T).float()
            tc, wc = t[lo:lo + chunk_size], w[lo:lo + chunk_size]
            ce = F.cross_entropy(logits, tc, reduction="none")
            loss_sum = loss_sum + (ce * wc).sum()
            correct = correct + ((logits.argmax(-1) == tc).float()
                                 * wc).sum()
    return torch.stack([loss_sum, correct, w.sum()])
