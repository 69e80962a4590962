"""Matrix products of the plain references at a stated precision.

``fp32`` is the reference itself: float32 with TF32 off, which
:func:`strict_float32` sets for the duration of a reference run.  The
lower precisions are the controls, the step a later change would be
tempted to take: ``bf16`` rounds both operands to bfloat16 (float32
accumulation), ``fp8`` rounds them to float8 e4m3 with one scale a
tensor (its absolute maximum at 448), in the forward and in both
products of the backward.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

PRECISIONS = ("fp32", "bf16", "fp8")
_E4M3_MAX = 448.0


@contextlib.contextmanager
def strict_float32():
    """TF32 off for matmuls and cuDNN inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale, back in float32."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / _E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = round_fp8(a), round_fp8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = round_fp8(g)
        ga = qg @ qb.transpose(-1, -2)
        gb = qa.transpose(-1, -2) @ qg
        # broadcast batch dims back to each operand's shape
        while ga.dim() > qa.dim():
            ga = ga.sum(0)
        while gb.dim() > qb.dim():
            gb = gb.sum(0)
        return ga, gb


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` in float32 at ``precision``."""
    if precision == "fp32":
        return a @ b
    if precision == "bf16":
        return (a.to(torch.bfloat16) @ b.to(torch.bfloat16)).float()
    if precision == "fp8":
        return _Fp8Matmul.apply(a, b)
    raise ValueError(f"unknown precision {precision!r}")


def conv2d(x, w, b, precision: str, padding: int = 1) -> torch.Tensor:
    """A convolution in float32 at ``precision`` (``fp32`` or ``bf16``)."""
    if precision == "fp32":
        return F.conv2d(x, w, b, padding=padding)
    if precision == "bf16":
        bf = torch.bfloat16
        return F.conv2d(x.to(bf), w.to(bf), b.to(bf), padding=padding).float()
    raise ValueError(f"no {precision!r} convolution in the reference")
