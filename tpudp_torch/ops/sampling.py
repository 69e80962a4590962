"""Per-row masked token sampling — the port of ``tpudp/ops/sampling.py``'s
``truncate_logits`` and ``sample_tokens``.

Row-wise semantics, as in the JAX op:

  * ``temperature[i] == 0``  -> greedy argmax (top_k/top_p ignored);
  * ``top_k[i] == 0``        -> top-k disabled;
  * ``top_p[i] == 1``        -> nucleus disabled;
  * the nucleus always keeps the highest-probability token, and
    truncation applies after temperature scaling.

Randomness is one ``torch.Generator`` per row instead of a JAX key per
row: a row draws only from its own generator, and only when it samples,
so a request's draws never depend on which other requests share the
batch.  The generators give other numbers than JAX's keys for the same
seed; greedy rows match JAX exactly.
"""

from __future__ import annotations

import torch


def truncate_logits(scaled: torch.Tensor, top_k: torch.Tensor,
                    top_p: torch.Tensor) -> torch.Tensor:
    """Mask ``scaled`` ``(..., vocab)`` outside the per-row top-k set and
    top-p nucleus to -inf (``top_k <= 0`` / ``top_p >= 1`` disable that
    truncation for the row).  Top-k first, then the nucleus over the
    top-k-renormalized distribution; ``scaled >= kth`` keeps ties at the
    k-th value."""
    v = scaled.shape[-1]
    sorted_scaled = torch.sort(scaled, dim=-1, descending=True).values
    kth_idx = (top_k[..., None].long() - 1).clamp(0, v - 1)
    kth = torch.gather(sorted_scaled, -1, kth_idx)
    keep_k = (top_k[..., None] <= 0) | (scaled >= kth)
    masked_k = torch.where(keep_k, scaled, -torch.inf)

    sorted_k = torch.sort(masked_k, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_k, dim=-1), dim=-1)
    preceding = torch.cat([torch.zeros_like(cum[..., :1]), cum[..., :-1]],
                          dim=-1)
    in_nucleus = preceding < top_p[..., None]
    cutoff = torch.where(in_nucleus, sorted_k, torch.inf).amin(
        dim=-1, keepdim=True)
    keep_p = (top_p[..., None] >= 1.0) | (masked_k >= cutoff)
    return torch.where(keep_p, masked_k, -torch.inf)


def sample_tokens(logits: torch.Tensor, temperature, top_k, top_p,
                  generators) -> torch.Tensor:
    """One token per row of ``logits`` ``(n, vocab)`` float32.

    ``temperature``/``top_k``/``top_p`` are ``(n,)`` (numpy or torch);
    ``generators`` holds one ``torch.Generator`` per row on the logits'
    device, or ``None`` for a row that must not draw this call (its
    token is the argmax and its generator stays where it was).  Returns
    ``(n,)`` int64 token ids on the logits' device."""
    dev = logits.device
    temps = torch.as_tensor(temperature, dtype=torch.float32).cpu().tolist()
    toks = torch.argmax(logits, dim=-1)
    rows = [i for i, g in enumerate(generators)
            if g is not None and temps[i] > 0]
    if not rows:
        return toks
    temperature = torch.as_tensor(temperature, dtype=torch.float32,
                                  device=dev)
    top_k = torch.as_tensor(top_k, dtype=torch.int64, device=dev)
    top_p = torch.as_tensor(top_p, dtype=torch.float32, device=dev)
    idx = torch.tensor(rows, device=dev)
    scaled = logits[idx] / temperature[idx, None]
    if bool(((top_k[idx] > 0) | (top_p[idx] < 1.0)).any()):
        scaled = truncate_logits(scaled, top_k[idx], top_p[idx])
    probs = torch.softmax(scaled, dim=-1)
    for j, i in enumerate(rows):
        toks[i] = torch.multinomial(probs[j], 1,
                                    generator=generators[i])[0]
    return toks
