"""The port's int8 page pool against the JAX package's, at the tiny
geometry of tests/test_paged_kernel.py.

Quantization, pool writes and the dense view are bit-equal to JAX's:
``_quantize_kv`` (float32 and bfloat16 inputs, zero vectors),
``write_token_pages`` over decode rows, a 3-token window, a page-aligned
chunk and every scratch route, per layer and whole-pool, and
``gather_pages``.  Attention over int8 pages — the plain version of the
int8 kernel variants — agrees with the JAX einsum path and the JAX
Pallas kernel in interpret mode at 1e-5.  The int8 ``PagePool`` holds
over 1.9x the tokens per byte of an fp32 one and allocates the same
pages in the same order.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudp.models.gpt2 import GPT2Config as JaxGPT2Config
from tpudp.ops.paged_attention import paged_attention as jax_paged_attention
from tpudp.serve.prefix_cache import PagePool as JaxPagePool
from tpudp_torch.models import generate as gen
from tpudp_torch.models.gpt2 import GPT2Config
from tpudp_torch.ops import paged_attention as pa
from tpudp_torch.serve.prefix_cache import PagePool

# ``tpudp.models`` re-exports the function ``generate`` under the module's
# name, so the module is looked up by its full name.
jax_gen = importlib.import_module("tpudp.models.generate")

S, M, T, DH, P, LAYERS = 3, 4, 8, 16, 8, 2
FAMILIES = {"mha": (4, 4), "gqa": (4, 2)}  # (query heads, kv heads)
TRAFFIC = {"decode": (1, None), "verify3": (3, None), "prefill": (T, 8)}
TABLE = np.array([[0, 1, 2, -1], [0, 1, 3, 4], [5, 6, -1, -1]], np.int32)
VECTOR_POS = np.array([17, 26, 4], np.int32)


def _bits(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32)).view(np.uint32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_equal_to_jax(dtype):
    """Payloads and scales equal JAX's bit for bit: ties round half to
    even in both, a zero vector keeps scale 1, extremes clip to 127."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 7, 3, DH), np.float32) * 3
    x[0, 0, 0] = 0.0                              # zero vector
    x[1, 2, 1] = np.arange(DH) - 7.5              # exact halves after scaling
    x[2, 3, 2, :4] = [127.0, -127.0, 63.5, 0.5]   # ties at scale 1
    x[2, 3, 2, 4:] = 0.0
    jq, js = jax_gen._quantize_kv(jnp.asarray(x, getattr(jnp, dtype)))
    tq, ts = gen._quantize_kv(torch.as_tensor(x).to(getattr(torch, dtype)))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(ts), _bits(js))
    assert ts[0, 0, 0] == 1 and not tq[0, 0, 0].any()


def _pools(seed):
    """Matching int8 pools ``(L, P+1, T, kv, dh)`` on both sides, filled
    with quantized noise so unwritten rows are not all zero."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((2, LAYERS, P + 1, T, 2, DH), np.float32)
    q, s = gen._quantize_kv(torch.as_tensor(base))
    port = gen.Int8Pages(q[0].clone(), q[1].clone(), s[0].clone(),
                         s[1].clone())
    jax_pool = jax_gen.Int8Pages(*(jnp.asarray(b.numpy()) for b in port))
    return port, jax_pool


WRITES = {
    # name: (cur, pos, active) — pos a scalar for the page-aligned chunk
    "decode": (1, np.array([17, 26, 4], np.int32), [True, True, True]),
    "window3": (3, np.array([15, 29, 6], np.int32), [True, False, True]),
    "chunk": (T, np.int32(8), [True, True, False]),
    "chunk_misaligned": (T, np.int32(5), [True, True, True]),
    "past_table": (3, np.array([30, 31, 15], np.int32), [True, True, True]),
}


@pytest.mark.parametrize("whole", [False, True])
@pytest.mark.parametrize("write", list(WRITES))
def test_write_token_pages_bytes_equal_jax(write, whole):
    """Decode rows, a window that crosses a page, a page-aligned chunk
    and the scratch routes (inactive slots, a misaligned chunk, rows past
    the table or on unmapped entries): all four buffers' real pages equal
    JAX's.  The scratch page is left out: where several rows route to one
    scratch row, JAX's sequential writes keep the last and one indexed
    assignment keeps any (its rows are never visible)."""
    cur, pos, active = WRITES[write]
    rng = np.random.default_rng(1)
    k_new = rng.standard_normal((S, cur, 2, DH), np.float32)
    v_new = rng.standard_normal((S, cur, 2, DH), np.float32)
    k_new[0, 0, 1] = 0.0
    port, jax_pool = _pools(2)
    for layer in range(LAYERS):
        if whole:
            jpages, tpages, kw = tuple(jax_pool), tuple(port), dict(
                layer=layer)
        else:
            jpages = tuple(b[layer] for b in jax_pool)
            tpages, kw = gen._layer_pages(port, layer), {}
        jout = jax_gen.write_token_pages(
            jpages, jnp.asarray(k_new), jnp.asarray(v_new),
            jnp.asarray(TABLE), jnp.asarray(pos), jnp.asarray(active), **kw)
        jax_pool = (jax_gen.Int8Pages(*jout) if whole else jax_gen.Int8Pages(
            *(b.at[layer].set(o) for b, o in zip(jax_pool, jout))))
        gen.write_token_pages(tpages, torch.as_tensor(k_new),
                              torch.as_tensor(v_new), torch.as_tensor(TABLE),
                              torch.as_tensor(pos), torch.as_tensor(active),
                              **kw)
    for got, want in zip(port, jax_pool):
        np.testing.assert_array_equal(_bits(got[:, :P]),
                                      _bits(want[:, :P]))


def test_gather_pages_equals_jax():
    """The dequantized dense view through the table, bit for bit, and the
    fp pool's view unchanged."""
    port, jax_pool = _pools(3)
    cfg = JaxGPT2Config(num_heads=2, d_model=2 * DH)
    want = jax_gen.gather_pages(cfg, jax_pool, jnp.asarray(TABLE))
    got = gen.gather_pages(port, torch.as_tensor(TABLE), torch.float32)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    fp = gen.KVCache(torch.randn(2, P + 1, T, 2, DH),
                     torch.randn(2, P + 1, T, 2, DH))
    view = gen.gather_pages(fp, torch.as_tensor(TABLE), torch.float32)
    torch.testing.assert_close(view.k[0, 1, 8:16], fp.k[0, 1], atol=0,
                               rtol=0)


def _case(family, traffic, seed=0):
    """q, an int8 pool (both sides, from the port's quantizer; one all-zero
    vector on a visible page), the table and ``pos``."""
    h, kv = FAMILIES[family]
    cur, scalar = TRAFFIC[traffic]
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((LAYERS, P + 1, T, kv, DH), np.float32)
    v = rng.standard_normal((LAYERS, P + 1, T, kv, DH), np.float32)
    k[:, 0, 3, 0] = v[:, 0, 3, 0] = 0.0
    (k8, ks), (v8, vs) = (gen._quantize_kv(torch.as_tensor(a))
                          for a in (k, v))
    q = rng.standard_normal((S, cur, h, DH), np.float32)
    pos = np.int32(scalar) if scalar is not None else VECTOR_POS
    return q, (k8, v8, ks, vs), TABLE, pos


@pytest.mark.parametrize("traffic", list(TRAFFIC))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_plain_int8_matches_jax_einsum_and_interpret_kernel(family, traffic):
    """The int8 kernels' plain version against JAX's int8 einsum path and
    its Pallas kernel (int8 branch) in interpret mode: fp32, atol 1e-5."""
    q, pages, table, pos = _case(family, traffic)
    grouped = family == "gqa"
    jpages = tuple(jnp.asarray(b[1].numpy()) for b in pages)
    args = (jnp.asarray(q), jpages, jnp.asarray(table), jnp.asarray(pos))
    want = np.asarray(jax_paged_attention(*args, dtype=jnp.float32,
                                          grouped=grouped))
    want_kernel = np.asarray(jax_paged_attention(
        *args, dtype=jnp.float32, grouped=grouped, impl="kernel",
        interpret=True))
    tq = torch.as_tensor(q)
    layer1 = tuple(b[1] for b in pages)
    got = pa.paged_attention(tq, layer1, torch.as_tensor(table),
                             torch.as_tensor(pos), dtype=torch.float32,
                             grouped=grouped).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, want_kernel, atol=1e-5, rtol=0)
    # The kernel impl's int8 wrappers, whole-pool, run the same plain
    # version on CPU tensors and count no launch.
    before = {n: fn.launches for n, fn in pa.KERNELS.items()}
    whole = pa.paged_attention(tq, pages, torch.as_tensor(table),
                               torch.as_tensor(pos), dtype=torch.float32,
                               impl="kernel", layer=1).numpy()
    np.testing.assert_allclose(whole, want, atol=1e-5, rtol=0)
    assert {n: fn.launches for n, fn in pa.KERNELS.items()} == before


def test_int8_dispatch_follows_the_jax_rule(monkeypatch):
    """A 4-tuple of pages routes to the int8 variants by the same rule."""
    calls = []
    for name in pa.KERNELS:
        monkeypatch.setattr(pa, name, lambda *a, _n=name, **kw:
                            calls.append((_n, len(a))))
    for traffic in TRAFFIC:
        q, pages, table, pos = _case("gqa", traffic)
        pa.paged_attention(torch.as_tensor(q), tuple(b[0] for b in pages),
                           table, pos, dtype=torch.float32, impl="kernel")
    assert calls == [("paged_decode_int8", 7), ("paged_window_int8", 7),
                     ("paged_window_int8", 7)]


def test_int8_pool_capacity_and_allocation_order():
    """>= 1.9x the tokens per byte of an fp32 pool (JAX's bound), the
    same page bytes as JAX's int8 pool, and the same page ids handed out
    in the same order through alloc/share/release churn."""
    cfg = GPT2Config(vocab_size=61, num_layers=2, num_heads=2, d_model=32)
    fp = PagePool(cfg, 4, 4)
    q = PagePool(cfg, 4, 4, kv_dtype="int8")
    assert isinstance(q.pages, gen.Int8Pages)
    assert fp.page_bytes() >= 1.9 * q.page_bytes()
    jcfg = JaxGPT2Config(vocab_size=61, num_layers=2, num_heads=2,
                         d_model=32)
    assert q.page_bytes() == JaxPagePool(jcfg, 4, 4,
                                         kv_dtype="int8").page_bytes()
    with pytest.raises(ValueError, match="kv_dtype"):
        PagePool(cfg, 4, 4, kv_dtype="fp8")

    def churn(pool):
        got = [pool.alloc(), pool.alloc()]
        pool.share(got[0])
        pool.release(got[1])
        pool.release(got[0])
        got += [pool.alloc() for _ in range(4)]
        pool.check()
        return got

    assert churn(PagePool(cfg, 4, 4)) == churn(
        PagePool(cfg, 4, 4, kv_dtype="int8")) == [0, 1, 1, 2, 3, None]
