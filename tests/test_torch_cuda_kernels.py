"""The port's CUDA kernels against their plain PyTorch version, on the
card.  Every test here carries the ``cuda`` marker and skips without a
card: the kernels have no CPU mode.  The file imports no JAX, so it also
runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda_kernels.py -q
"""

import numpy as np
import pytest
import torch

from tpudp_torch.ops import paged_attention as pa

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
