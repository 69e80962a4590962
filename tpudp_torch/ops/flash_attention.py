"""Flash attention — the port of ``tpudp/ops/flash_attention.py``.

:func:`flash_attention` takes ``(batch, time, heads, head_dim)`` q, k, v
(the models' layout) and is differentiable through :class:`_Flash`, the
counterpart of the JAX op's ``custom_vjp``: the forward saves ``(q, k,
v, o, lse)``, the backward computes ``delta = rowsum(do * o)`` and runs
the two backward kernels, which recompute the probabilities from the
saved log-sum-exp instead of storing them.

Three kernel wrappers, each with a plain PyTorch version beside it:

  * :func:`flash_fwd` — K1, ``csrc/flash_fwd.cu``: ``(o, lse)``;
  * :func:`flash_dq` — K2, ``csrc/flash_dq.cu``: ``dq``;
  * :func:`flash_dkv` — K3, ``csrc/flash_dkv.cu``: ``(dk, dv)``.

A wrapper given CUDA tensors launches its kernel or raises; given CPU
tensors it runs the plain version, which is what the CPU tests see.
Each counts its launches in ``.launches``.  The kernels read q, k, v and
do through their strides, so the views of the qkv projection the model
passes are never transposed or copied; ``lse`` and ``delta`` are
float32 ``(b, h, t)``; outputs take the inputs' dtypes.  The kernels
pick their route by dtype.  bfloat16 inputs (the training path) go to
the tensor-core kernels, which multiply bf16 operands with float32
accumulation and round the probabilities ``p`` (K1, K3) and ``ds`` (K2,
K3) to bf16 before the products that consume them; the plain versions
keep those in float32, a divergence held within the bf16 tolerance by
``tests/test_torch_flash_attention.py``.  float32 inputs run in float32
throughout on the CUDA cores.  The kernels take head dims 32, 64 and
128; :func:`tpudp_torch.ops.attention.flash_route` sends other head dims
to the dense math before any of them is called.

The kernels choose their own tiles (64 rows, or 64 keys, at a time)
whatever ``block_q`` / ``block_k`` say: the blocks are checked as the
JAX op checks them (clamped to ``time``, which must divide by them), and
only the summation order depends on the tiling.
"""

from __future__ import annotations

import ctypes
import math

import torch

from tpudp_torch.ops import _build

_NEG_INF = -1e30  # the masking value of the TPU kernels
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIMS = (32, 64, 128)


def _scale(dh: int) -> float:
    return 1.0 / math.sqrt(dh)


def _causal_mask(t: int, device) -> torch.Tensor:
    return torch.ones(t, t, dtype=torch.bool, device=device).tril()


def _flash_fwd_plain(q, k, v, causal: bool):
    """The forward kernel's function in plain PyTorch: float32 scores of
    the pre-scaled q against k, masked at ``-1e30``, exponentiated
    against the row max, ``o = (p v) / max(l, 1e-30)`` in q's dtype and
    ``lse = m + log(max(l, 1e-30))`` as float32 ``(b, h, t)``."""
    t = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * _scale(q.shape[-1]),
                     k.float())
    if causal:
        mask = _causal_mask(t, q.device)
        s = s.masked_fill(~mask, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if causal:
        p = p.masked_fill(~mask, 0.0)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float()) / l_safe.transpose(
        1, 2)
    return o.to(q.dtype), (m + torch.log(l_safe))[..., 0]


def _delta(o, do) -> torch.Tensor:
    """``rowsum(do * o)`` in float32, ``(b, h, t)`` — the softmax
    Jacobian's correction term, computed outside the kernels as the JAX
    package computes it outside Pallas."""
    return (do.float() * o.float()).sum(dim=-1).transpose(1, 2).contiguous()


def _probs_and_ds(q, k, v, do, lse, delta, causal: bool):
    """The recomputation both backward kernels share: the pre-scaled q,
    ``p = exp(q k^T - lse)`` (masked to 0) and ``ds = p (do v^T -
    delta)``, all float32 ``(b, h, t, t)``."""
    qs = q.float() * _scale(q.shape[-1])
    p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", qs, k.float())
                  - lse[..., None])
    if causal:
        p = p.masked_fill(~_causal_mask(q.shape[1], q.device), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return qs, p, p * (dp - delta[..., None])


def _dq_plain(q, k, v, do, lse, delta, causal: bool):
    """``dq = scale * ds k``, in q's dtype (K2's function)."""
    _, _, ds = _probs_and_ds(q, k, v, do, lse, delta, causal)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * _scale(q.shape[-1])
    return dq.to(q.dtype)


def _dkv_plain(q, k, v, do, lse, delta, causal: bool):
    """``dk = ds^T (q * scale)`` and ``dv = p^T do``, in k's and v's
    dtypes (K3's function)."""
    qs, p, ds = _probs_and_ds(q, k, v, do, lse, delta, causal)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qs)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _flash_bwd_plain(q, k, v, o, lse, do, causal: bool):
    """``(dq, dk, dv)`` by the backward kernels' recomputation (not by
    autograd of the dense forward), so the check on the card compares
    like with like."""
    delta = _delta(o, do)
    return (_dq_plain(q, k, v, do, lse, delta, causal),
            *_dkv_plain(q, k, v, do, lse, delta, causal))


def _kernel_input(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``x`` checked against ``q`` (device, dtype, shape); returned as it
    is when its head dim is contiguous, no other dim is broadcast (a zero
    stride, which the tensor maps of the bf16 kernels do not take) and
    every row starts on a 16-byte boundary, else as a contiguous copy."""
    if x.device != q.device:
        raise ValueError("flash kernels need every tensor on one CUDA "
                         "device")
    if x.dtype != q.dtype:
        raise TypeError(f"flash kernels take one dtype, got {x.dtype} "
                        f"beside {q.dtype}")
    if x.shape != q.shape:
        raise ValueError(f"shape {tuple(x.shape)} differs from q's "
                         f"{tuple(q.shape)}")
    size = x.element_size()
    if (x.stride(-1) != 1 or x.data_ptr() % 16
            or any(s == 0 or s * size % 16 for s in x.stride()[:3])):
        x = x.contiguous()
    return x


def _check_query(q: torch.Tensor) -> None:
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"flash kernels take float32 or bfloat16, got "
                        f"{q.dtype}")
    if q.dim() != 4 or q.shape[-1] not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernels take (b, t, h, dh) with head dim "
                         f"in {_KERNEL_HEAD_DIMS}, got {tuple(q.shape)}")


def _strides(*tensors) -> ctypes.Array:
    """The (batch, token, head) element strides of each tensor, as the
    host array the launch functions read."""
    flat = [s for x in tensors for s in x.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _launch(name: str, q, pointers, strides, causal: bool) -> None:
    """Launch kernel ``name`` on q's stream: the tensors' data pointers,
    their strides, then the geometry every flash launch takes."""
    b, t, h, dh = q.shape
    code = _build.launcher(name)(
        *pointers, strides, _KERNEL_DTYPES[q.dtype], b, t, h, dh,
        int(causal), _scale(dh),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(name, code)


def flash_fwd(q, k, v, *, causal: bool = True):
    """K1: ``(o, lse)`` for ``(b, t, h, dh)`` q, k, v; ``o`` in q's
    dtype, ``lse`` float32 ``(b, h, t)``.  Launches
    ``csrc/flash_fwd.cu`` on CUDA tensors (the count goes up by one),
    runs the plain version on CPU tensors."""
    if not q.is_cuda:
        return _flash_fwd_plain(q, k, v, causal)
    _check_query(q)
    q, k, v = [_kernel_input(x, q) for x in (q, k, v)]
    b, t, h, _ = q.shape
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    _launch("flash_fwd", q, [x.data_ptr() for x in (q, k, v, o, lse)],
            _strides(q, k, v, o), causal)
    flash_fwd.launches += 1
    return o, lse


def _lse_delta(lse, delta, q):
    b, t, h, _ = q.shape
    for name, x in (("lse", lse), ("delta", delta)):
        if (x.shape != (b, h, t) or x.dtype != torch.float32
                or x.device != q.device):
            raise ValueError(f"{name} must be float32 ({b}, {h}, {t}) on "
                             f"q's device, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    return lse.contiguous(), delta.contiguous()


def flash_dq(q, k, v, do, lse, delta, *, causal: bool = True):
    """K2: ``dq`` in q's dtype from the forward's ``lse`` and ``delta =
    rowsum(do * o)`` (both float32 ``(b, h, t)``).  Launches
    ``csrc/flash_dq.cu`` on CUDA tensors (the count goes up by one),
    runs the plain version on CPU tensors."""
    if not q.is_cuda:
        return _dq_plain(q, k, v, do, lse, delta, causal)
    _check_query(q)
    q, k, v, do = [_kernel_input(x, q) for x in (q, k, v, do)]
    lse, delta = _lse_delta(lse, delta, q)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    _launch("flash_dq", q,
            [x.data_ptr() for x in (q, k, v, do, lse, delta, dq)],
            _strides(q, k, v, do, dq), causal)
    flash_dq.launches += 1
    return dq


def flash_dkv(q, k, v, do, lse, delta, *, causal: bool = True):
    """K3: ``(dk, dv)`` in k's and v's dtype, from the same inputs as
    :func:`flash_dq`.  Launches ``csrc/flash_dkv.cu`` on CUDA tensors
    (the count goes up by one), runs the plain version on CPU tensors."""
    if not q.is_cuda:
        return _dkv_plain(q, k, v, do, lse, delta, causal)
    _check_query(q)
    q, k, v, do = [_kernel_input(x, q) for x in (q, k, v, do)]
    lse, delta = _lse_delta(lse, delta, q)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    _launch("flash_dkv", q,
            [x.data_ptr() for x in (q, k, v, do, lse, delta, dk, dv)],
            _strides(q, k, v, do, dk, dv), causal)
    flash_dkv.launches += 1
    return dk, dv


flash_fwd.launches = 0
flash_dq.launches = 0
flash_dkv.launches = 0

#: Every flash kernel wrapper, by kernel name.
KERNELS = {"flash_fwd": flash_fwd, "flash_dq": flash_dq,
           "flash_dkv": flash_dkv}


class _Flash(torch.autograd.Function):
    """The JAX op's ``custom_vjp``: the forward keeps ``(q, k, v, o,
    lse)``; the backward computes ``delta`` and runs dq, then dk/dv."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_fwd(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        delta = _delta(o, do)
        dq = flash_dq(q, k, v, do, lse, delta, causal=ctx.causal)
        dk, dv = flash_dkv(q, k, v, do, lse, delta, causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, *, causal: bool = True, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """Flash attention over ``(batch, time, heads, head_dim)`` q, k, v;
    returns ``(batch, time, heads, head_dim)`` in q's dtype.

    ``time`` must divide by the block sizes, which are clamped to
    ``time`` when longer (the JAX op's contract).  Differentiable."""
    t = q.shape[1]
    block_q = min(block_q, t)
    block_k = min(block_k, t)
    if t % block_q or t % block_k:
        raise ValueError(f"time {t} not divisible by blocks "
                         f"({block_q},{block_k})")
    return _Flash.apply(q, k, v, causal)
