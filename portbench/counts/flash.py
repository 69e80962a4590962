"""Operations and bytes that causal flash attention needs, per call.

The work is what the inputs need, not what a kernel does: no
recomputation in the backward, each input read once and each output
written once.  Shapes are ``(b, t, h, dh)``; ``elem`` is the size in
bytes of q, k, v, o and their gradients; the log-sum-exp is float32.
"""

from __future__ import annotations


def causal_pairs(t: int) -> int:
    """Query-key pairs under a causal mask, the diagonal included."""
    return t * (t + 1) // 2


def forward(b: int, t: int, h: int, dh: int, elem: int) -> tuple[int, int]:
    """``(operations, bytes)`` of ``o = softmax(q k^T) v``: two products
    over the causal pairs; reads q, k, v, writes o and the float32
    log-sum-exp."""
    ops = 2 * (2 * b * h * dh * causal_pairs(t))
    n = b * t * h * dh
    return ops, 3 * n * elem + n * elem + b * h * t * 4


def backward(b: int, t: int, h: int, dh: int, elem: int) -> tuple[int, int]:
    """``(operations, bytes)`` of ``dq, dk, dv``: four products over the
    causal pairs (``q k^T`` is the forward's and is not counted again);
    reads q, k, v, o, do and the log-sum-exp, writes dq, dk, dv."""
    ops = 4 * (2 * b * h * dh * causal_pairs(t))
    n = b * t * h * dh
    return ops, 5 * n * elem + b * h * t * 4 + 3 * n * elem


def bound_seconds(ops: int, nbytes: int, peak_flops: float,
                  peak_bytes: float) -> float:
    """The least time the card could take: the larger of the two."""
    return max(ops / peak_flops, nbytes / peak_bytes)
