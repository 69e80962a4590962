"""The port's flash attention (``tpudp_torch.ops.flash_attention``) and
attention dispatch (``tpudp_torch.ops.attention``) against the JAX
package, on the CPU: the plain versions of the forward (K1) and backward
(K2, K3) kernels against the Pallas kernels in interpret mode, and the
autograd gradients of the public op against ``jax.grad``.  Inputs are
made with numpy from a seed and handed to both frameworks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudp.ops.attention import multihead_attention as jax_mha
from tpudp.ops.flash_attention import (_flash_bwd_impl, _flash_fwd_impl,
                                       flash_attention as jax_flash)
from tpudp_torch.ops import attention, flash_attention as fa

B, T, H, DH = 2, 256, 2, 32


def _qkv(seed, b=B, t=T, h=H, dh=DH, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, dh), np.float32) for _ in range(n)]


def _to_bh(x):
    """(b, t, h, dh) numpy -> the JAX kernels' (b * h, t, dh)."""
    b, t, h, dh = x.shape
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, t, dh))


def _from_bh(x, b, h):
    """The JAX kernels' (b * h, t, dh) -> (b, t, h, dh) numpy."""
    x = np.asarray(x, np.float32)
    return x.reshape(b, h, *x.shape[1:]).transpose(0, 2, 1, 3).copy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("blocks", [(64, 64), (128, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_forward_matches_jax_kernel(causal, blocks, dtype):
    """``_flash_fwd_plain`` vs ``_flash_fwd_impl(interpret=True)``: ``o``
    and ``lse`` agree to 2e-5 (float32 math in both, summed in other
    orders).  With bf16 inputs ``lse`` holds 2e-5 and ``o`` is held to
    one bf16 ulp (rtol 2**-7, an ulp's largest relative size): the two
    float32 sums differ in their last bits, and such a value can round
    to either bf16 neighbour."""
    q, k, v = _qkv(1)
    jdt = getattr(jnp, dtype)
    o_want, lse_want = _flash_fwd_impl(
        *(_to_bh(x).astype(jdt) for x in (q, k, v)), causal, *blocks, True)
    tdt = getattr(torch, dtype)
    o, lse = fa._flash_fwd_plain(*(torch.as_tensor(x).to(tdt)
                                   for x in (q, k, v)), causal)
    assert o.dtype == tdt and lse.dtype == torch.float32
    assert lse.shape == (B, H, T)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(lse_want).reshape(B, H, T),
                               atol=2e-5, rtol=2e-5)
    tol = (dict(atol=2e-5, rtol=2e-5) if dtype == "float32"
           else dict(atol=2e-5, rtol=2 ** -7))
    np.testing.assert_allclose(o.float().numpy(), _from_bh(o_want, B, H),
                               **tol)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_matches_jax_kernels(causal):
    """``_flash_bwd_plain`` vs ``_flash_bwd_impl(interpret=True)`` on the
    same q, k, v, do and the JAX forward's ``o`` and ``lse``: dq, dk and
    dv agree to 2e-5 (float32)."""
    q, k, v, do = _qkv(2, n=4)
    o, lse = _flash_fwd_impl(*(_to_bh(x) for x in (q, k, v)), causal, 64,
                             64, True)
    want = _flash_bwd_impl(*(_to_bh(x) for x in (q, k, v)), o, lse,
                           _to_bh(do), causal, 64, 64, True)
    got = fa._flash_bwd_plain(
        *(torch.as_tensor(x) for x in (q, k, v)),
        torch.as_tensor(_from_bh(o, B, H)),
        torch.as_tensor(np.array(lse).reshape(B, H, T)),
        torch.as_tensor(do), causal)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), _from_bh(w, B, H), atol=2e-5,
                                   rtol=2e-5, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_grads_match_jax_grad(causal):
    """Autograd of the port's ``flash_attention`` (the ``_Flash``
    Function over the wrappers, which run their plain versions on CPU
    tensors) vs ``jax.grad`` of the JAX op in interpret mode, through
    the nonlinear loss of tests/test_flash_attention.py: 5e-4."""
    q, k, v = _qkv(3, b=1, t=128, h=2, dh=16)

    def loss_jax(q, k, v):
        o = jax_flash(q, k, v, causal=causal, block_q=64, block_k=64,
                      interpret=True)
        return jnp.sum(o * jnp.cos(o))

    want = jax.grad(loss_jax, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    o = fa.flash_attention(tq, tk, tv, causal=causal, block_q=64, block_k=64)
    (o * torch.cos(o)).sum().backward()
    for g, w, name in zip((tq.grad, tk.grad, tv.grad), want, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-4,
                                   rtol=5e-4, err_msg=name)


def test_blocks_clamp_and_must_divide_time():
    """The JAX op's block contract: blocks longer than ``time`` clamp to
    it (t = 96 with the default 128 blocks runs), and ``time`` must
    divide by them."""
    q, k, v = (torch.as_tensor(x) for x in _qkv(4, t=96))
    o = fa.flash_attention(q, k, v)
    want, _ = fa._flash_fwd_plain(q, k, v, True)
    torch.testing.assert_close(o, want, atol=0, rtol=0)
    with pytest.raises(ValueError, match="not divisible"):
        fa.flash_attention(q, k, v, block_q=64)


def test_wrappers_run_the_plain_version_on_cpu_uncounted():
    """On CPU tensors the wrappers return their plain version's result
    and leave the launch counts alone."""
    q, k, v, do = (torch.as_tensor(x) for x in _qkv(5, t=64, n=4))
    before = {n: fn.launches for n, fn in fa.KERNELS.items()}
    o, lse = fa.flash_fwd(q, k, v, causal=True)
    delta = fa._delta(o, do)
    dq = fa.flash_dq(q, k, v, do, lse, delta, causal=True)
    dk, dv = fa.flash_dkv(q, k, v, do, lse, delta, causal=True)
    for got, want in zip((dq, dk, dv),
                         fa._flash_bwd_plain(q, k, v, o, lse, do, True)):
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert {n: fn.launches for n, fn in fa.KERNELS.items()} == before
    assert set(fa.KERNELS) == {"flash_fwd", "flash_dq", "flash_dkv"}


@pytest.mark.parametrize("causal", [True, False])
def test_dense_attention_matches_jax(causal):
    """``multihead_attention(impl='dense')`` vs the JAX dispatch's dense
    math, float32: 1e-6."""
    q, k, v = _qkv(6, t=40)
    want = jax_mha(*(jnp.asarray(x) for x in (q, k, v)), causal=causal,
                   impl="dense")
    got = attention.multihead_attention(
        *(torch.as_tensor(x) for x in (q, k, v)), causal=causal,
        impl="dense")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


def test_flash_dispatch_follows_the_jax_rule(monkeypatch):
    """``'flash'`` takes the flash op when ``t % 128 == 0`` and the dense
    math otherwise; ``'ring'`` names its ROADMAP item; unknown impls
    raise."""
    calls = []
    real = attention.flash_attention

    def spy(*args, **kwargs):
        calls.append(args[0].shape[1])
        return real(*args, **kwargs)

    monkeypatch.setattr(attention, "flash_attention", spy)
    for t in (128, 96):
        q, k, v = (torch.as_tensor(x) for x in _qkv(7, t=t))
        got = attention.multihead_attention(q, k, v, causal=True,
                                            impl="flash")
        want = attention.dense_attention(q, k, v, causal=True,
                                         dtype=torch.float32)
        torch.testing.assert_close(got, want, atol=2e-6, rtol=0)
    assert calls == [128]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        attention.multihead_attention(q, k, v, causal=True, impl="ring")
    with pytest.raises(ValueError, match="unknown"):
        attention.multihead_attention(q, k, v, causal=True, impl="nope")


@pytest.mark.parametrize("layout", ["projection view", "transposed",
                                    "broadcast", "misaligned rows"])
def test_kernel_input_copies_only_what_the_kernels_cannot_read(layout):
    """The kernels read q, k, v and do through their strides: a view of
    the qkv projection or of a (b, h, t, dh) tensor goes to them as it
    is; a broadcast (zero-stride) tensor, which the bf16 kernels' tensor
    maps cannot step through, and rows off 16-byte boundaries are copied
    to contiguous tensors first, with their values kept."""
    b, t, h, dh = 2, 64, 3, 32
    base = torch.randn(b, t, 3 * h * dh).to(torch.bfloat16)
    q = base[..., :h * dh].reshape(b, t, h, dh)
    x = {"projection view": base[..., h * dh:2 * h * dh].reshape(b, t, h, dh),
         "transposed": torch.randn(b, h, t, dh).to(torch.bfloat16)
         .transpose(1, 2),
         "broadcast": torch.randn(dh).to(torch.bfloat16).expand(b, t, h, dh),
         "misaligned rows": torch.randn(b, t, h, dh + 1).to(torch.bfloat16)
         [..., :dh]}[layout]
    got = fa._kernel_input(x, q)
    assert torch.equal(got, x)
    if layout in ("projection view", "transposed"):
        assert got.data_ptr() == x.data_ptr() and got.stride() == x.stride()
    else:
        assert got.is_contiguous() and got.data_ptr() != x.data_ptr()


def _bf16(x):
    """Round a float32 tensor to bf16 and back, as the kernels round."""
    return x.to(torch.bfloat16).float()


def _tensor_core_forward(q, k, v, causal, tile=64):
    """The bf16 forward kernel's arithmetic on bf16 ``(b, t, h, dh)``
    inputs: float32 scores, the scale applied to them in float32, an
    online softmax over 64-key tiles whose probabilities are rounded to
    bf16 before ``P V`` (the sum ``l`` keeps them in float32), float32
    accumulation; ``o`` in bf16, ``lse`` float32 ``(b, h, t)``."""
    b, t, h, dh = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * fa._scale(dh)
    if causal:
        s = s.masked_fill(~fa._causal_mask(t, q.device), float("-inf"))
    m = torch.full((b, h, t, 1), float("-inf"))
    l = torch.zeros((b, h, t, 1))
    acc = torch.zeros((b, h, t, dh))
    for k0 in range(0, t, tile):
        st = s[..., k0:k0 + tile]
        m_new = torch.maximum(m, st.amax(dim=-1, keepdim=True))
        base = torch.where(torch.isinf(m_new), torch.zeros_like(m_new), m_new)
        alpha = torch.exp(m - base)
        p = torch.exp(st - base)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        vt = v[:, k0:k0 + tile].float()
        acc = acc * alpha + torch.einsum("bhqk,bkhd->bhqd", _bf16(p), vt)
        m = m_new
    l_safe = l.clamp_min(1e-30)
    o = (acc / l_safe).transpose(1, 2).to(torch.bfloat16)
    return o, (m + torch.log(l_safe))[..., 0]


def _tensor_core_backward(q, k, v, do, lse, delta, causal):
    """The bf16 backward's arithmetic (K2's and K3's): ``p`` and ``ds``
    in float32, rounded to bf16 before the products ``p^T do``, ``ds^T
    q`` and ``ds k``, float32 accumulation, the scale applied once in
    float32; ``(dq, dk, dv)`` in bf16."""
    scale = fa._scale(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    p = torch.exp(s * scale - lse[..., None])
    if causal:
        p = p.masked_fill(~fa._causal_mask(q.shape[1], q.device), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", _bf16(ds), k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", _bf16(ds), q.float()) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", _bf16(p), do.float())
    return [x.to(torch.bfloat16) for x in (dq, dk, dv)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("t", [96, 128, 256])
def test_tensor_core_rounding_fits_the_card_tolerance(t, dh, causal):
    """Why the bf16 kernels on the tensor cores still meet the card's
    unchanged bf16 checks: a plain model of their roundings (P and dS to
    bf16 before the products that consume them, float32 accumulation,
    the scale applied in float32) against the plain versions the card
    compares them with, on bf16 N(0, 1) inputs — ``o``, dq, dk and dv
    within atol 2e-2 and rtol 1.6e-2, ``lse`` within 2e-5."""
    q, k, v, do = (torch.as_tensor(x).to(torch.bfloat16)
                   for x in _qkv(10 + t + dh, b=1, t=t, h=2, dh=dh, n=4))
    o_ref, lse_ref = fa._flash_fwd_plain(q, k, v, causal)
    o, lse = _tensor_core_forward(q, k, v, causal)
    bf16_tol = dict(atol=2e-2, rtol=1.6e-2)
    torch.testing.assert_close(o.float(), o_ref.float(), **bf16_tol)
    torch.testing.assert_close(lse, lse_ref, atol=2e-5, rtol=2e-5)
    delta = fa._delta(o_ref, do)
    want = (fa._dq_plain(q, k, v, do, lse_ref, delta, causal),
            *fa._dkv_plain(q, k, v, do, lse_ref, delta, causal))
    got = _tensor_core_backward(q, k, v, do, lse_ref, delta, causal)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        torch.testing.assert_close(g.float(), w.float(), **bf16_tol,
                                   msg=lambda m, name=name: f"{name}: {m}")
