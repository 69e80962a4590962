"""Multi-head attention dispatch — the port of ``tpudp/ops/attention.py``.

One home for the impl-selection rule and the mixed-precision softmax
policy of the transformer models, as in the JAX package:

  * ``'dense'`` — :func:`dense_attention`: einsum scores in ``dtype``,
    masked with the dtype's most negative value, softmax in float32, the
    P.V product in ``dtype``;
  * ``'flash'`` — :func:`tpudp_torch.ops.flash_attention.flash_attention`
    (the K1-K3 kernels) when the token count divides by 128, the dense
    math otherwise: the reference's own contract, not a fallback on
    failure;
  * ``'ring'`` — sequence-parallel ring attention is not ported yet.
"""

from __future__ import annotations

import torch

from tpudp_torch.ops.flash_attention import flash_attention

_IMPLS = ("dense", "flash", "ring")


def dense_attention(q, k, v, *, causal: bool, dtype) -> torch.Tensor:
    """Dense attention over ``(b, t, h, dh)``: scores in ``dtype``,
    masked (when ``causal``) with the dtype's most negative value,
    softmax in float32 — the op order of
    ``tpudp.ops.attention.multihead_attention``."""
    t = q.shape[1]
    lg = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    if causal:
        mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
        lg = lg.masked_fill(~mask, torch.finfo(lg.dtype).min)
    pr = torch.softmax(lg.float(), dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", pr, v)


def multihead_attention(q, k, v, *, causal: bool, impl: str = "dense",
                        dtype=torch.float32) -> torch.Tensor:
    """``(B, T, H, Dh)`` q/k/v -> ``(B, T, H, Dh)`` attention output,
    by the JAX package's dispatch rule (module docstring)."""
    if impl not in _IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; choose from "
                         f"{', '.join(map(repr, _IMPLS))}")
    if impl == "ring":
        raise NotImplementedError(
            "ring attention is not ported yet: ROADMAP.md slice 6b "
            "(ring attention)")
    if impl == "flash" and q.shape[1] % 128 == 0:
        return flash_attention(q, k, v, causal=causal)
    return dense_attention(q, k, v, causal=causal, dtype=dtype)
