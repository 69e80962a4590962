"""Multi-head attention dispatch — the port of ``tpudp/ops/attention.py``.

One home for the impl-selection rule and the mixed-precision softmax
policy of the transformer models, as in the JAX package:

  * ``'dense'`` — :func:`dense_attention`: einsum scores in ``dtype``,
    masked with the dtype's most negative value, softmax in float32, the
    P.V product in ``dtype``;
  * ``'flash'`` — :func:`tpudp_torch.ops.flash_attention.flash_attention`
    (the K1-K3 kernels) when the token count divides by 128, the dense
    math otherwise: the reference's own contract, not a fallback on
    failure.  On a CUDA device the kernels also need a head dim of 32,
    64 or 128 and float32 or bfloat16 inputs; :func:`flash_route`
    sends any other call to the dense math, the JAX package's other
    implementation, decided from the shapes before any launch, and
    counts it in ``dense_routes`` (the plain versions on the CPU take
    every head dim and dtype, so the CPU follows the JAX rule alone);
  * ``'ring'`` — :func:`tpudp_torch.parallel.ring_attention.
    ring_attention` over the process group bound to ``seq_axis``
    (``tpudp_torch.mesh.bind_axes``), and the dense math where the axis
    is unbound (model construction, one device), as in JAX.
"""

from __future__ import annotations

import torch

from tpudp_torch.ops.flash_attention import (_KERNEL_DTYPES,
                                             _KERNEL_HEAD_DIMS,
                                             flash_attention)

_IMPLS = ("dense", "flash", "ring")

#: ``impl='flash'`` calls :func:`flash_route` sent to the dense math
#: because the kernels have no instance for their head dim or dtype.
dense_routes = 0


def flash_route(shape, dtype, device_type: str) -> str:
    """``'flash'`` or ``'dense'`` for an ``impl='flash'`` call on ``(b,
    t, h, dh)`` inputs of ``dtype`` on ``device_type``: dense when ``t %
    128`` (the JAX rule) or, on CUDA, when the kernels do not take the
    head dim or dtype."""
    if shape[1] % 128:
        return "dense"
    if device_type == "cuda" and (shape[-1] not in _KERNEL_HEAD_DIMS
                                  or dtype not in _KERNEL_DTYPES):
        return "dense"
    return "flash"


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
                        dtype=torch.float32,
                        seq_axis: str | None = None) -> torch.Tensor:
    """``(B, T, H, Dh)`` q/k/v -> ``(B, T, H, Dh)`` attention output,
    by the JAX package's dispatch rule (module docstring).  An
    ``impl='flash'`` call whose token count divides by 128 but whose head
    dim or dtype the CUDA kernels lack runs the dense math and adds one
    to the module's ``dense_routes``."""
    if impl not in _IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; choose from "
                         f"{', '.join(map(repr, _IMPLS))}")
    if impl == "ring":
        from tpudp_torch.mesh import axis_group

        group = axis_group(seq_axis)
        if group is not None:
            from tpudp_torch.parallel.ring_attention import ring_attention

            return ring_attention(q, k, v, group, causal=causal)
    if impl == "flash":
        if flash_route(q.shape, q.dtype, q.device.type) == "flash":
            return flash_attention(q, k, v, causal=causal)
        if q.shape[1] % 128 == 0:
            global dense_routes
            dense_routes += 1
    return dense_attention(q, k, v, causal=causal, dtype=dtype)
