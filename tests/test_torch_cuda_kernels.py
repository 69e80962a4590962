"""The port's CUDA kernels (paged decode and window, fp and int8, paged
tree, flash forward, dq and dk/dv) against their plain PyTorch versions,
on the card.  Every test here carries the ``cuda`` marker and skips without a
card: the kernels have no CPU mode.  The file imports no JAX, so it also
runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda_kernels.py -q
"""

import numpy as np
import pytest
import torch

from tpudp_torch.ops import flash_attention as fa
from tpudp_torch.ops import paged_attention as pa
from tpudp_torch.serve.speculate import TREE_SHAPES

S, T, P, LAYERS = 3, 8, 8, 2
TABLE = np.array([[0, 1, 2, -1], [0, 1, 3, 4], [5, 6, -1, -1]], np.int32)
VECTOR_POS = np.array([17, 26, 4], np.int32)
TRAFFIC = {"decode": (1, None), "verify3": (3, None), "prefill": (T, 8)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("traffic", list(TRAFFIC))
def test_kernel_matches_plain(card, traffic, dtype, dh):
    """Each kernel vs its plain version on the same inputs, whole-pool
    mode, grouped heads (fp32 atol = rtol = 2e-5, only the summation
    order differs; bf16 atol 2e-2 and rtol 1.6e-2, two bf16 ulps: the
    plain path rounds probabilities to bf16 before P.V), and the launch
    counted once."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(5)
    h, kv = 8, 4
    cur, scalar = TRAFFIC[traffic]

    def rand(*shape):
        return torch.as_tensor(rng.standard_normal(shape, np.float32)).to(
            card, dt)

    k, v = rand(LAYERS, P + 1, T, kv, dh), rand(LAYERS, P + 1, T, kv, dh)
    q = rand(S, cur, h, dh)
    pos = torch.as_tensor(np.int32(scalar) if scalar is not None
                          else VECTOR_POS).to(card)
    table = torch.as_tensor(TABLE).to(card)
    kernel = pa.paged_decode if traffic == "decode" else pa.paged_window
    before = kernel.launches
    got = pa.paged_attention(q, (k, v), table, pos, dtype=dt,
                             impl="kernel", layer=1)
    assert kernel.launches == before + 1
    want = pa._einsum_paged(q, (k[1], v[1]), table, pos, dtype=dt,
                            grouped=True)
    tol = (dict(atol=2e-5, rtol=2e-5) if dt == torch.float32
           else dict(atol=2e-2, rtol=1.6e-2))
    torch.testing.assert_close(got.float(), want.float(), **tol)


def _int8_pool(card, rng, kv, dh):
    """An int8 pool (LAYERS, P+1, T, kv, dh) with float32 scales, made by
    the port's quantizer from noise, one all-zero vector included."""
    from tpudp_torch.models.generate import _quantize_kv

    bufs = []
    for _ in range(2):
        x = torch.as_tensor(rng.standard_normal((LAYERS, P + 1, T, kv, dh),
                                                np.float32))
        x[:, 0, 3, 0] = 0.0
        bufs.append(_quantize_kv(x.to(card)))
    (k8, ks), (v8, vs) = bufs
    return k8, v8, ks, vs


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [(4, 4), (8, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("traffic", list(TRAFFIC))
def test_int8_kernel_matches_plain(card, traffic, dtype, heads):
    """Each int8 variant vs its plain version (dequantize, then the
    einsum), whole-pool and per layer, MHA and grouped heads: fp32 atol =
    rtol = 2e-5 (the plain path dequantizes to the same float32 values;
    the kernel takes the key scale out of the dot product); bf16 atol
    2e-2 and rtol 1.6e-2 (the plain path rounds the dequantized K/V and
    the probabilities to bf16, the kernel keeps float32).  One launch
    counted per call."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(8)
    h, kv = heads
    cur, scalar = TRAFFIC[traffic]
    pages = _int8_pool(card, rng, kv, 64)
    q = torch.as_tensor(rng.standard_normal((S, cur, h, 64), np.float32)).to(
        card, dt)
    pos = torch.as_tensor(np.int32(scalar) if scalar is not None
                          else VECTOR_POS).to(card)
    table = torch.as_tensor(TABLE).to(card)
    kernel = (pa.paged_decode_int8 if traffic == "decode"
              else pa.paged_window_int8)
    want = pa._einsum_paged(q, tuple(b[1] for b in pages), table, pos,
                            dtype=dt, grouped=True)
    tol = (dict(atol=2e-5, rtol=2e-5) if dt == torch.float32
           else dict(atol=2e-2, rtol=1.6e-2))
    for layer in (1, None):
        before = kernel.launches
        got = pa.paged_attention(
            q, pages if layer else tuple(b[1] for b in pages), table, pos,
            dtype=dt, impl="kernel", layer=layer)
        assert kernel.launches == before + 1
        torch.testing.assert_close(got.float(), want.float(), **tol)


# K5's edges: (query heads, KV heads, head dim, page tokens, table pages,
# window rows, depth) of one slot at a host-int depth, as the engine's
# prefill passes it: head dim 32, a window of 128 rows a KV head (32
# positions x 4 query heads: four row tiles), depth 0, a depth near 1,000
# keys (several key splits), and a 64-row chunk over 64-token pages.
WINDOW_EDGES = {
    "dh32": (8, 4, 32, 16, 64, 16, 144),
    "rows128": (16, 4, 64, 16, 64, 32, 200),
    "depth0": (12, 3, 64, 16, 64, 16, 0),
    "depth1000": (12, 12, 64, 16, 64, 16, 1000),
    "page64": (12, 3, 64, 64, 16, 64, 320),
}


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [8, 32])
@pytest.mark.parametrize("pool", ["fp", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("edge", list(WINDOW_EDGES))
def test_window_kernel_edges_match_plain(card, monkeypatch, edge, dtype,
                                         pool, rows):
    """K5 and K5-int8 at the edges of their schedule against the plain
    version, whole-pool, at the tolerances above, in row tiles of up to
    8 rows (the schedule's) and 32 (the kernel's widest, four rows a
    warp); each call made twice back to back (a merge ticket left
    unreset by the first would break the second), one launch counted per
    call."""
    from tpudp_torch.models.generate import _quantize_kv

    monkeypatch.setattr(pa, "ROW_TILE_ROWS", rows)
    h, kv, dh, page_tokens, max_pages, cur, depth = WINDOW_EDGES[edge]
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(len(edge) + 7 * dh + depth)
    n_vis = (depth + cur - 1) // page_tokens + 1
    n_pages = n_vis + 4
    table = np.full((1, max_pages), -1, np.int32)
    table[0, :n_vis] = rng.permutation(n_pages)[:n_vis]
    k, v = (torch.as_tensor(rng.standard_normal(
        (LAYERS, n_pages + 1, page_tokens, kv, dh), np.float32)).to(card)
        for _ in range(2))
    if pool == "int8":
        (k8, ks), (v8, vs) = _quantize_kv(k), _quantize_kv(v)
        pages, kernel = (k8, v8, ks, vs), pa.paged_window_int8
    else:
        pages, kernel = (k.to(dt), v.to(dt)), pa.paged_window
    q = torch.as_tensor(rng.standard_normal((1, cur, h, dh),
                                            np.float32)).to(card, dt)
    table = torch.as_tensor(table).to(card)
    sched = pa.window_schedule(1, cur, h, kv, depth + cur,
                               pa._sm_count(q.device))
    if edge == "depth1000":
        assert sched.splits > 1
    want = pa._einsum_paged(q, tuple(buf[1] for buf in pages), table, depth,
                            dtype=dt, grouped=True)
    tol = (dict(atol=2e-5, rtol=2e-5) if dt == torch.float32
           else dict(atol=2e-2, rtol=1.6e-2))
    for _ in range(2):
        before = kernel.launches
        got = pa.paged_attention(q, pages, table, depth, dtype=dt,
                                 impl="kernel", layer=1)
        assert kernel.launches == before + 1
        torch.testing.assert_close(got.float(), want.float(), **tol)


# K4's edges: (query heads, KV heads, head dim, page tokens, table pages,
# per-slot depths; None: an idle slot, its table row all -1): tile edges,
# a slot at the capacity of 1,024 keys beside one at 0, head dims 32 and
# 128, 1, 4 and 8 query heads a KV head, 64-token pages, an idle slot.
DECODE_EDGES = {
    "tile-edges": (12, 12, 64, 16, 64, (0, 31, 32, 63)),
    "capacity": (12, 3, 64, 16, 64, (1023, 0)),
    "dh32": (16, 2, 32, 16, 64, (100, 317, 5)),
    "dh128": (32, 8, 128, 16, 64, (200, 31, 640)),
    "groups8": (16, 2, 64, 16, 64, (150, 999, 64)),
    "page64": (12, 3, 64, 64, 16, (1000, 63, 64)),
    "idle": (12, 12, 64, 16, 64, (300, None, 50)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("max_splits", [pa.DECODE_MAX_SPLITS, 1])
@pytest.mark.parametrize("pool", ["fp", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("edge", list(DECODE_EDGES))
def test_decode_kernel_edges_match_plain(card, monkeypatch, edge, dtype,
                                         pool, max_splits):
    """K4 and K4-int8 at the edges of their schedule against the plain
    version (zeros for an idle slot), whole-pool, at the tolerances
    above, with the key split and without (one split: no merge); each
    call made twice back to back (a merge ticket left unreset by the
    first would break the second), one launch counted per call."""
    from tpudp_torch.models.generate import _quantize_kv

    monkeypatch.setattr(pa, "DECODE_MAX_SPLITS", max_splits)
    h, kv, dh, page_tokens, max_pages, depths = DECODE_EDGES[edge]
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(len(edge) + 7 * dh)
    n_vis = [0 if d is None else d // page_tokens + 1 for d in depths]
    n_pages = sum(n_vis) + 2
    perm = list(rng.permutation(n_pages))
    table = np.full((len(depths), max_pages), -1, np.int32)
    for s, n in enumerate(n_vis):
        table[s, :n] = [perm.pop() for _ in range(n)]
    k, v = (torch.as_tensor(rng.standard_normal(
        (LAYERS, n_pages + 1, page_tokens, kv, dh), np.float32)).to(card)
        for _ in range(2))
    if pool == "int8":
        (k8, ks), (v8, vs) = _quantize_kv(k), _quantize_kv(v)
        pages, kernel = (k8, v8, ks, vs), pa.paged_decode_int8
    else:
        pages, kernel = (k.to(dt), v.to(dt)), pa.paged_decode
    q = torch.as_tensor(rng.standard_normal((len(depths), 1, h, dh),
                                            np.float32)).to(card, dt)
    table = torch.as_tensor(table).to(card)
    pos = torch.tensor([40 if d is None else d for d in depths],
                       dtype=torch.int32, device=card)
    idle = [s for s, d in enumerate(depths) if d is None]
    want = pa._einsum_paged(q, tuple(buf[1] for buf in pages), table, pos,
                            dtype=dt, grouped=True)
    want[idle] = 0.0
    tol = (dict(atol=2e-5, rtol=2e-5) if dt == torch.float32
           else dict(atol=2e-2, rtol=1.6e-2))
    for _ in range(2):
        before = kernel.launches
        got = pa.paged_attention(q, pages, table, pos, dtype=dt,
                                 impl="kernel", layer=1)
        assert kernel.launches == before + 1
        torch.testing.assert_close(got.float(), want.float(), **tol)
        assert not got[idle].any()


@pytest.mark.cuda
def test_int8_wrappers_refuse_what_the_kernels_do_not_take(card):
    rng = np.random.default_rng(9)
    k8, v8, ks, vs = (b[0] for b in _int8_pool(card, rng, 4, 64))
    q = torch.zeros(S, 1, 4, 64, device=card)
    with pytest.raises(TypeError, match="k_scale must be float32"):
        pa.paged_decode_int8(q, k8, v8, ks.double(), vs, TABLE, VECTOR_POS)
    with pytest.raises(TypeError, match="torch.int8"):
        pa.paged_decode_int8(q, k8.float(), v8.float(), ks, vs, TABLE,
                             VECTOR_POS)
    strided = ks.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_decode_int8(q, k8, v8, strided, vs, TABLE, VECTOR_POS)


@pytest.mark.cuda
def test_int8_engine_raises_without_its_kernels(card, monkeypatch, tmp_path):
    """No nvcc and no built library: an int8 kernel engine raises at its
    first step; it never serves through the plain version."""
    from tpudp_torch.models import llama
    from tpudp_torch.ops import _build
    from tpudp_torch.serve import Engine
    from tpudp_torch.utils import compile_cache

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(compile_cache, "_chosen", (None, tmp_path))
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    cfg = llama.LlamaConfig(vocab_size=64, max_seq_len=64, num_layers=1,
                            num_heads=4, num_kv_heads=2, d_model=128)
    eng = Engine(llama.build(cfg, 0, card), num_slots=1, max_len=32,
                 kv_pages=4, kv_dtype="int8")
    assert eng.paged_attn == "kernel"
    eng.submit(np.arange(5, dtype=np.int32), 2)
    with pytest.raises(RuntimeError, match="nvcc"):
        eng.step()


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(card):
    q = torch.zeros(S, 1, 4, 48, device=card)  # head dim 48: no kernel
    pages = torch.zeros(P + 1, T, 4, 48, device=card)
    with pytest.raises(ValueError, match="head dim"):
        pa.paged_decode(q, pages, pages, TABLE, VECTOR_POS)
    q = torch.zeros(S, 1, 4, 64, device=card, dtype=torch.float16)
    pages = torch.zeros(P + 1, T, 4, 64, device=card, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        pa.paged_decode(q, pages, pages, TABLE, VECTOR_POS)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(8))
def test_kernels_match_plain_on_random_geometries(card, seed):
    """Random page sizes (not only powers of two), window widths past one
    32-key tile, batch, head grouping and table layouts with shared,
    stale and unmapped entries, in float32."""
    rng = np.random.default_rng(100 + seed)
    page_tokens = int(rng.choice([4, 8, 12, 16, 32]))
    max_pages = int(rng.integers(2, 12))
    b = int(rng.integers(1, 6))
    kv = int(rng.choice([1, 2, 4]))
    h = kv * int(rng.choice([1, 2, 4]))
    dh = int(rng.choice([32, 64, 128]))
    cur = int(rng.choice([1, 2, 7, 33]))
    scalar = cur > 1 and bool(rng.integers(0, 2))
    t_max = max_pages * page_tokens
    if scalar:
        pos = np.int32(rng.integers(0, max(t_max - cur, 0) + 1))
        last = np.full(b, int(pos) + cur - 1)
    else:
        pos = rng.integers(0, max(t_max - cur, 0) + 1, size=b).astype(
            np.int32)
        last = pos + cur - 1
    n_real = b * max_pages + 2
    perm = list(rng.permutation(n_real))
    table = np.full((b, max_pages), -1, np.int32)
    for s in range(b):
        for i in range(min(int(last[s]), t_max - 1) // page_tokens + 1):
            table[s, i] = table[0, i] if s and i == 0 else perm.pop()
        if perm and rng.integers(0, 2):
            table[s, -1] = max(table[s, -1], perm.pop())  # stale page

    def rand(*shape):
        return torch.as_tensor(rng.standard_normal(shape, np.float32)).to(
            card)

    k, v = rand(LAYERS, n_real + 1, page_tokens, kv, dh), rand(
        LAYERS, n_real + 1, page_tokens, kv, dh)
    q = rand(b, cur, h, dh)
    pos_t = torch.as_tensor(pos).to(card)
    table_t = torch.as_tensor(table).to(card)
    got = pa.paged_attention(q, (k, v), table_t, pos_t, dtype=torch.float32,
                             impl="kernel", layer=LAYERS - 1)
    want = pa._einsum_paged(q, (k[-1], v[-1]), table_t, pos_t,
                            dtype=torch.float32, grouped=True)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", ["fork2x2", "fork3+1", "chain4"])
def test_tree_kernel_matches_plain(card, shape, dtype, dh):
    """K6 against its plain version, whole-pool, grouped heads, with q,
    wk and wv as strided views of one projection and one slot at depth
    0 (window keys only), tolerances as above; the launch counted once."""
    dt = getattr(torch, dtype)
    anc = TREE_SHAPES[shape].ancestors
    t1 = len(anc)
    h, kv = 8, 4
    rng = np.random.default_rng(6)
    k, v = (torch.as_tensor(rng.standard_normal(
        (LAYERS, P + 1, T, kv, dh), np.float32)).to(card, dt)
        for _ in range(2))
    proj = torch.as_tensor(rng.standard_normal(
        (S, t1, (h + 2 * kv) * dh), np.float32)).to(card, dt)
    q, wk, wv = proj.split([h * dh, kv * dh, kv * dh], dim=-1)
    q = q.reshape(S, t1, h, dh)
    wk, wv = wk.reshape(S, t1, kv, dh), wv.reshape(S, t1, kv, dh)
    pos0 = torch.tensor([17, 26, 0], dtype=torch.int32, device=card)
    table = torch.as_tensor(TABLE).to(card)
    before = pa.paged_tree.launches
    got = pa.tree_paged_attention(q, (k, v), table, pos0, wk, wv, anc,
                                  dtype=dt, layer=1)
    assert pa.paged_tree.launches == before + 1
    want = pa._tree_plain(q, k, v, table, pos0, wk, wv, anc, 1)
    tol = (dict(atol=2e-5, rtol=2e-5) if dt == torch.float32
           else dict(atol=2e-2, rtol=1.6e-2))
    torch.testing.assert_close(got.float(), want.float(), **tol)


def _projection(card, b, t, h, dh, dtype, seed):
    """q, k, v as strided views of one (b, t, 3 h dh) projection, and a
    random do."""
    rng = np.random.default_rng(seed)
    qkv = torch.as_tensor(rng.standard_normal((b, t, 3 * h * dh),
                                              np.float32)).to(card, dtype)
    q, k, v = (z.reshape(b, t, h, dh) for z in qkv.chunk(3, dim=-1))
    do = torch.as_tensor(rng.standard_normal((b, t, h, dh),
                                             np.float32)).to(card, dtype)
    return qkv, q, k, v, do


FLASH_TOL = {torch.float32: (dict(atol=2e-5, rtol=2e-5),
                             dict(atol=1e-4, rtol=1e-4)),
             torch.bfloat16: (dict(atol=2e-2, rtol=1.6e-2),
                              dict(atol=2e-2, rtol=1.6e-2))}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 128, 4, 64), (1, 96, 2, 32),
                                   (2, 256, 2, 128), (1, 200, 3, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernels_match_plain(card, causal, dtype, shape):
    """K1 (o, lse), K2 (dq) and K3 (dk, dv) against their plain versions
    on projection views, each launch counted once; t = 96 and t = 200
    leave partial 64-row tiles.  fp32: atol = rtol = 2e-5 forward, 1e-4
    gradients; bf16: atol 2e-2, rtol 1.6e-2; lse always 2e-5."""
    dt = getattr(torch, dtype)
    _, q, k, v, do = _projection(card, *shape, dt, seed=sum(shape))
    before = {n: fn.launches for n, fn in fa.KERNELS.items()}
    o, lse = fa.flash_fwd(q, k, v, causal=causal)
    o_ref, lse_ref = fa._flash_fwd_plain(q, k, v, causal)
    delta = fa._delta(o_ref, do)
    dq = fa.flash_dq(q, k, v, do, lse_ref, delta, causal=causal)
    dk, dv = fa.flash_dkv(q, k, v, do, lse_ref, delta, causal=causal)
    assert {n: fn.launches - before[n] for n, fn in fa.KERNELS.items()} == {
        "flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1}
    fwd_tol, grad_tol = FLASH_TOL[dt]
    torch.testing.assert_close(o.float(), o_ref.float(), **fwd_tol)
    torch.testing.assert_close(lse, lse_ref, atol=2e-5, rtol=2e-5)
    want = (fa._dq_plain(q, k, v, do, lse_ref, delta, causal),
            *fa._dkv_plain(q, k, v, do, lse_ref, delta, causal))
    for got, ref in zip((dq, dk, dv), want):
        assert got.dtype == dt and got.shape == q.shape
        torch.testing.assert_close(got.float(), ref.float(), **grad_tol)


@pytest.mark.cuda
@pytest.mark.parametrize("do_layout", ["transposed", "broadcast"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_autograd_matches_plain_backward(card, causal, dtype,
                                               do_layout):
    """The public op's autograd on the card (kernels forward and
    backward) against the plain backward, with a do that is not
    contiguous: a (b, h, t, dh) tensor seen as (b, t, h, dh), or one
    head-dim row broadcast over batch, time and heads (zero strides)."""
    dt = getattr(torch, dtype)
    qkv, q, k, v, do = _projection(card, 2, 128, 4, 64, dt, 9)
    qkv.requires_grad_(True)
    q, k, v = (z.reshape(2, 128, 4, 64) for z in qkv.chunk(3, dim=-1))
    o = fa.flash_attention(q, k, v, causal=causal)
    if do_layout == "transposed":
        do_s = do.transpose(1, 2).contiguous().transpose(1, 2)
    else:
        do_s = do[:1, :1, :1].expand(do.shape)
    grads = torch.autograd.grad(o, (q, k, v), do_s)
    o_ref, lse_ref = fa._flash_fwd_plain(q.detach(), k.detach(), v.detach(),
                                         causal)
    want = fa._flash_bwd_plain(q.detach(), k.detach(), v.detach(), o_ref,
                               lse_ref, do_s.contiguous(), causal)
    for got, ref in zip(grads, want):
        torch.testing.assert_close(got.float(), ref.float(),
                                   **FLASH_TOL[dt][1])


@pytest.mark.cuda
def test_flash_wrappers_refuse_what_the_kernels_do_not_take(card):
    q = torch.zeros(1, 64, 2, 48, device=card)  # head dim 48: no kernel
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_fwd(q, q, q)
    q = torch.zeros(1, 64, 2, 64, device=card, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_fwd(q, q, q)
    q = torch.zeros(1, 64, 2, 64, device=card)
    with pytest.raises(ValueError, match="one CUDA device"):
        fa.flash_fwd(q, q.cpu(), q)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 2048, 12, 64), (2, 256, 4, 32),
                                   (2, 256, 4, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_autograd_backward_on_the_tensor_cores(card, causal, shape):
    """The bf16 backward through K2 and K3 on the tensor cores, by the
    public op's autograd: at the training path's shape (b 4, t 2048, h
    12, dh 64) and at head dims 32 and 128, against the plain backward at
    the bf16 tolerance, each backward kernel launched once."""
    qkv, q, k, v, do = _projection(card, *shape, torch.bfloat16,
                                   seed=sum(shape))
    qkv.requires_grad_(True)
    q, k, v = (z.reshape(shape) for z in qkv.chunk(3, dim=-1))
    o = fa.flash_attention(q, k, v, causal=causal)
    before = {n: fn.launches for n, fn in fa.KERNELS.items()}
    grads = torch.autograd.grad(o, (q, k, v), do)
    assert {n: fn.launches - before[n] for n, fn in fa.KERNELS.items()} == {
        "flash_fwd": 0, "flash_dq": 1, "flash_dkv": 1}
    o_ref, lse_ref = fa._flash_fwd_plain(q.detach(), k.detach(), v.detach(),
                                         causal)
    want = fa._flash_bwd_plain(q.detach(), k.detach(), v.detach(), o_ref,
                               lse_ref, do, causal)
    for got, ref in zip(grads, want):
        torch.testing.assert_close(got.float(), ref.float(),
                                   **FLASH_TOL[torch.bfloat16][1])


def _tree32():
    """32 nodes, the tree kernel's widest: 7 first steps, 24 second."""
    from tpudp_torch.serve.speculate import TreeShape

    return TreeShape("wide32", (-1,) + (0,) * 7 + tuple(
        1 + i // 3 for i in range(24)))


@pytest.mark.cuda
@pytest.mark.parametrize("whole_pool", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads", [(12, 12, 64), (32, 8, 128), (8, 2, 32)])
@pytest.mark.parametrize("shape", ["fork2x2", "fork3+1", "chain4", "wide32"])
def test_tree_kernel_shared_tile_matches_plain(card, shape, heads, dtype,
                                               whole_pool):
    """K6's shared K/V tile against its plain version: GPT-2's heads, a
    grouped-query shape (4 query heads a KV head, so up to 128 rows read
    one KV head) and head dim 32 at 4 groups, the trees of the engine and
    a 32-node one, per layer and
    whole-pool, slots at depths past several 32-key tiles and at 0, with
    page-table rows that share pages, map a stale page past the visible
    edge and leave the rest unmapped (every visible entry is mapped, as
    the engine guarantees); tolerances as above."""
    dt = getattr(torch, dtype)
    tree = _tree32() if shape == "wide32" else TREE_SHAPES[shape]
    anc = tree.ancestors
    t1 = len(anc)
    h, kv, dh = heads
    rng = np.random.default_rng(t1 + h + dh)
    page_tokens, n_pages = 16, 24
    table = np.full((4, 8), -1, np.int32)
    table[0, :5] = [3, 7, 1, 20, 9]
    table[1, :6] = [3, 7, 11, 12, 13, 14]
    table[2, :4] = [5, 21, 6, 22]  # 22: stale, past the visible edge
    pos0 = np.array([70, 96, 40, 0], np.int32)
    k, v = (torch.as_tensor(rng.standard_normal(
        (LAYERS, n_pages + 1, page_tokens, kv, dh), np.float32)).to(card, dt)
        for _ in range(2))
    proj = torch.as_tensor(rng.standard_normal(
        (4, t1, (h + 2 * kv) * dh), np.float32)).to(card, dt)
    q, wk, wv = proj.split([h * dh, kv * dh, kv * dh], dim=-1)
    q = q.reshape(4, t1, h, dh)
    wk, wv = wk.reshape(4, t1, kv, dh), wv.reshape(4, t1, kv, dh)
    pos0 = torch.as_tensor(pos0).to(card)
    table = torch.as_tensor(table).to(card)
    pages, layer = ((k, v), 1) if whole_pool else ((k[1], v[1]), None)
    before = pa.paged_tree.launches
    got = pa.tree_paged_attention(q, pages, table, pos0, wk, wv, anc,
                                  dtype=dt, layer=layer)
    assert pa.paged_tree.launches == before + 1
    want = pa._tree_plain(q, k, v, table, pos0, wk, wv, anc, 1)
    tol = (dict(atol=2e-5, rtol=2e-5) if dt == torch.float32
           else dict(atol=2e-2, rtol=1.6e-2))
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
def test_head_dim_48_routes_on_the_card(card):
    """Head dim 48, which no kernel takes: a paged engine on the card
    resolves to the kernels, sends every family to the einsum path at
    build time (all four listed as fallbacks), serves the plain engine's
    greedy tokens and launches no kernel; ``impl='flash'`` runs the
    dense math, counted once, with no flash launch, and its autograd
    matches the dense math's."""
    from tpudp_torch.models import gpt2
    from tpudp_torch.ops import attention
    from tpudp_torch.serve import Engine
    from tpudp_torch.serve.engine import PAGED_FAMILIES

    cfg = gpt2.GPT2Config(vocab_size=64, max_seq_len=64, num_layers=1,
                          num_heads=2, d_model=96)
    model = gpt2.build(cfg, 0, card)
    prompts = [np.arange(5, dtype=np.int32), np.arange(9, 20, dtype=np.int32)]
    before = {n: fn.launches for n, fn in pa.KERNELS.items()}
    tokens = {}
    for paged_attn in (None, "einsum"):
        eng = Engine(model, num_slots=2, max_len=32, prefill_chunk=8,
                     kv_pages=8, paged_attn=paged_attn)
        handles = [eng.submit(p, 4) for p in prompts]
        eng.run_until_complete()
        tokens[paged_attn] = [h.tokens for h in handles]
        if paged_attn is None:
            m = eng.metrics()["paged_attn"]
            assert m["resolved"] == "kernel"
            assert m["fallbacks"] == sorted(PAGED_FAMILIES)
    assert tokens[None] == tokens["einsum"]
    assert {n: fn.launches for n, fn in pa.KERNELS.items()} == before

    qkv, q, k, v, do = _projection(card, 2, 128, 2, 48, torch.float32, 4)
    qkv.requires_grad_(True)
    q, k, v = (z.reshape(2, 128, 2, 48) for z in qkv.chunk(3, dim=-1))
    flash_before = {n: fn.launches for n, fn in fa.KERNELS.items()}
    routes = attention.dense_routes
    o = attention.multihead_attention(q, k, v, causal=True, impl="flash")
    assert attention.dense_routes == routes + 1
    grads = torch.autograd.grad(o, (q, k, v), do)
    assert {n: fn.launches for n, fn in fa.KERNELS.items()} == flash_before
    o_ref = attention.dense_attention(q, k, v, causal=True,
                                      dtype=torch.float32)
    want = torch.autograd.grad(o_ref, (q, k, v), do)
    torch.testing.assert_close(o, o_ref, atol=0, rtol=0)
    for got, ref in zip(grads, want):
        torch.testing.assert_close(got, ref, atol=0, rtol=0)
