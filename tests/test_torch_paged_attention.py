"""The port's paged-attention op (``tpudp_torch.ops.paged_attention``)
against the JAX op, at the tiny geometry of tests/test_paged_kernel.py.

On the CPU the kernel wrappers run their plain PyTorch version, so this
file pins that plain version to both JAX backends — the bit-exact einsum
path and the Pallas kernels in interpret mode — across the traffic the
CUDA kernels serve: one-token decode, a 3-token window at per-slot
depths, a page-wide prefill chunk at a scalar depth, MHA and grouped
heads, fragmented tables, per-layer and whole-pool pages.  The CUDA
kernels themselves are compared with this plain version on the card
(tests/test_torch_cuda_kernels.py and ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudp.ops.paged_attention import paged_attention as jax_paged_attention
from tpudp_torch.ops import paged_attention as pa

S, M, T, DH, P, LAYERS = 3, 4, 8, 16, 8, 2
FAMILIES = {"mha": (4, 4), "gqa": (4, 2)}  # (query heads, kv heads)
TRAFFIC = {"decode": (1, None), "verify3": (3, None), "prefill": (T, 8)}
# Slots 0 and 1 share prefix pages 0-1 and diverge into private pages;
# slot 2 is shallow; -1 tails sit past every slot's window.
TABLE = np.array([[0, 1, 2, -1], [0, 1, 3, 4], [5, 6, -1, -1]], np.int32)
VECTOR_POS = np.array([17, 26, 4], np.int32)


def _case(family, traffic, seed=0):
    h, kv = FAMILIES[family]
    cur, scalar = TRAFFIC[traffic]
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((LAYERS, P + 1, T, kv, DH), np.float32)
    v = rng.standard_normal((LAYERS, P + 1, T, kv, DH), np.float32)
    q = rng.standard_normal((S, cur, h, DH), np.float32)
    pos = np.int32(scalar) if scalar is not None else VECTOR_POS
    return q, k, v, TABLE, pos


@pytest.mark.parametrize("traffic", list(TRAFFIC))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_plain_matches_jax_einsum_and_interpret_kernel(family, traffic):
    """Plain port vs JAX einsum (same math, other summation order) and
    vs the JAX Pallas kernel in interpret mode (online softmax): fp32,
    atol 1e-5."""
    q, k, v, table, pos = _case(family, traffic)
    grouped = family == "gqa"
    jpages = (jnp.asarray(k[1]), jnp.asarray(v[1]))
    want = np.asarray(jax_paged_attention(
        jnp.asarray(q), jpages, jnp.asarray(table), jnp.asarray(pos),
        dtype=jnp.float32, grouped=grouped))
    want_kernel = np.asarray(jax_paged_attention(
        jnp.asarray(q), jpages, jnp.asarray(table), jnp.asarray(pos),
        dtype=jnp.float32, grouped=grouped, impl="kernel", interpret=True))
    tq = torch.as_tensor(q)
    got = pa.paged_attention(tq, (torch.as_tensor(k[1]),
                                  torch.as_tensor(v[1])),
                             torch.as_tensor(table), torch.as_tensor(pos),
                             dtype=torch.float32, grouped=grouped).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, want_kernel, atol=1e-5, rtol=0)


@pytest.mark.parametrize("traffic", list(TRAFFIC))
def test_kernel_impl_whole_pool_on_cpu_runs_plain(traffic):
    """``impl='kernel'`` with whole-pool ``layer=`` on CPU tensors: the
    wrappers run the plain version on that layer's pages (equal to the
    per-layer einsum call) and count no launch."""
    q, k, v, table, pos = _case("gqa", traffic, seed=1)
    before = {n: fn.launches for n, fn in pa.KERNELS.items()}
    got = pa.paged_attention(torch.as_tensor(q), (torch.as_tensor(k),
                                                  torch.as_tensor(v)),
                             torch.as_tensor(table), torch.as_tensor(pos),
                             dtype=torch.float32, grouped=True,
                             impl="kernel", layer=1)
    want = pa.paged_attention(torch.as_tensor(q), (torch.as_tensor(k[1]),
                                                   torch.as_tensor(v[1])),
                              torch.as_tensor(table), torch.as_tensor(pos),
                              dtype=torch.float32, grouped=True)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert {n: fn.launches for n, fn in pa.KERNELS.items()} == before


def test_dispatch_follows_the_jax_rule(monkeypatch):
    """Vector pos with one token -> decode kernel; a scalar pos or a
    wider window -> window kernel (``paged_attention.py:669-676``)."""
    calls = []
    for name in pa.KERNELS:
        monkeypatch.setattr(pa, name, lambda *a, _n=name, **kw:
                            calls.append(_n))
    for traffic in TRAFFIC:
        q, k, v, table, pos = _case("mha", traffic)
        pa.paged_attention(torch.as_tensor(q), (torch.as_tensor(k[0]),
                                                torch.as_tensor(v[0])),
                           table, pos, dtype=torch.float32, impl="kernel")
    assert calls == ["paged_decode", "paged_window", "paged_window"]


def test_op_validation():
    q, k, v, table, pos = _case("mha", "decode")
    pages = (torch.as_tensor(k[0]), torch.as_tensor(v[0]))
    with pytest.raises(ValueError, match="impl"):
        pa.paged_attention(torch.as_tensor(q), pages, table, pos,
                           dtype=torch.float32, impl="gather")
    with pytest.raises(ValueError, match="kernel-impl only"):
        pa.paged_attention(torch.as_tensor(q), pages, table, pos,
                           dtype=torch.float32, layer=0)
    with pytest.raises(ValueError, match="k_scale, v_scale"):
        pa.paged_attention(torch.as_tensor(q), pages + pages[:1], table,
                           pos, dtype=torch.float32, impl="kernel")
