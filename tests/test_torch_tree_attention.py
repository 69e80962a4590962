"""The port's tree-verify attention (``tpudp_torch.ops.paged_attention.
tree_paged_attention`` and its plain version ``_tree_plain``) and tree
forwards (``tpudp_torch.models.generate``) against the JAX package, at
the tiny geometry of tests/test_paged_kernel.py.

On the CPU the K6 wrapper runs its plain version, which is held here to
the JAX tree kernel in interpret mode (fragmented tables, strict
``< pos0`` cache visibility, the ancestor mask over the window); the
CUDA kernel is held to the plain version on the card
(tests/test_torch_cuda_kernels.py and ``chip_smoke.py``).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudp.models.gpt2 import gpt2_small as jax_gpt2_small
from tpudp.ops.paged_attention import \
    tree_paged_attention as jax_tree_paged_attention
from tpudp_torch.models import generate as tgen
from tpudp_torch.models import gpt2
from tpudp_torch.ops import paged_attention as pa
from tpudp_torch.serve.speculate import TREE_SHAPES

jgen = importlib.import_module("tpudp.models.generate")

S, M, T, DH, P, LAYERS = 3, 4, 8, 16, 8, 2
FAMILIES = {"mha": (4, 4), "gqa": (4, 2)}  # (query heads, kv heads)
# Slots 0 and 1 share prefix pages 0-1; slot 2 is shallow; -1 tails.
TABLE = np.array([[0, 1, 2, -1], [0, 1, 3, 4], [5, -1, -1, -1]], np.int32)
POS0 = np.array([17, 26, 4], np.int32)
TINY = dict(vocab_size=61, max_seq_len=96, num_layers=2, num_heads=2,
            d_model=32)


def _case(family, shape, seed=5):
    h, kv = FAMILIES[family]
    t1 = TREE_SHAPES[shape].num_candidates + 1
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((LAYERS, P + 1, T, kv, DH), np.float32)
    v = rng.standard_normal((LAYERS, P + 1, T, kv, DH), np.float32)
    q = rng.standard_normal((S, t1, h, DH), np.float32)
    wk = rng.standard_normal((S, t1, kv, DH), np.float32)
    wv = rng.standard_normal((S, t1, kv, DH), np.float32)
    return q, k, v, wk, wv


def _anc(shape):
    return tuple(tuple(int(b) for b in row)
                 for row in TREE_SHAPES[shape].ancestors)


@pytest.mark.parametrize("shape", ["fork2x2", "fork3+1", "chain4"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_tree_plain_matches_jax_tree_kernel(family, shape):
    """``_tree_plain`` (per layer and whole-pool) vs the JAX tree kernel
    in interpret mode: fp32, atol = rtol = 2e-6 — the summation order
    and the online softmax are the only differences."""
    q, k, v, wk, wv = _case(family, shape)
    anc = _anc(shape)
    want = np.asarray(jax_tree_paged_attention(
        jnp.asarray(q), (jnp.asarray(k[1]), jnp.asarray(v[1])),
        jnp.asarray(TABLE), jnp.asarray(POS0), jnp.asarray(wk),
        jnp.asarray(wv), anc, dtype=jnp.float32, interpret=True))
    tq, twk, twv = map(torch.as_tensor, (q, wk, wv))
    per_layer = pa.tree_paged_attention(
        tq, (torch.as_tensor(k[1]), torch.as_tensor(v[1])),
        torch.as_tensor(TABLE), torch.as_tensor(POS0), twk, twv, anc,
        dtype=torch.float32)
    whole = pa.tree_paged_attention(
        tq, (torch.as_tensor(k), torch.as_tensor(v)), torch.as_tensor(TABLE),
        torch.as_tensor(POS0), twk, twv, anc, dtype=torch.float32, layer=1)
    np.testing.assert_allclose(per_layer.numpy(), want, atol=2e-6,
                               rtol=2e-6)
    torch.testing.assert_close(whole, per_layer, atol=0, rtol=0)


def test_tree_wrapper_on_cpu_runs_plain_and_counts_nothing():
    q, k, v, wk, wv = _case("gqa", "fork2x2")
    before = {n: fn.launches for n, fn in pa.KERNELS.items()}
    args = (torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
            torch.as_tensor(TABLE), torch.as_tensor(POS0),
            torch.as_tensor(wk), torch.as_tensor(wv), _anc("fork2x2"))
    got = pa.paged_tree(*args, layer=0)
    want = pa._tree_plain(*args, 0)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert {n: fn.launches for n, fn in pa.KERNELS.items()} == before


def test_tree_strict_visibility_and_window_only_rows():
    """Cache keys at ``pos0`` and beyond get no weight (node 0's own K/V
    come from the window), and a slot at depth 0 attends its window
    ancestors alone."""
    q, k, v, wk, wv = (torch.as_tensor(a) for a in _case("mha", "chain2"))
    anc = _anc("chain2")
    pos0 = torch.tensor([17, 26, 0])
    base = pa._tree_plain(q, k[0], v[0], TABLE, pos0, wk, wv, anc, None)
    k2, v2 = k[0].clone(), v[0].clone()
    k2[2, 1], v2[2, 1] = 1e3, 1e3  # slot 0's position 17 (page 2, row 1)
    k2[5], v2[5] = 1e3, 1e3        # slot 2's page: all past depth 0
    again = pa._tree_plain(q, k2, v2, TABLE, pos0, wk, wv, anc, None)
    torch.testing.assert_close(again, base, atol=0, rtol=0)
    # Depth 0: node j is the softmax-weighted mean of its ancestors' V.
    lg = torch.einsum("jhd,chd->hjc", q[2], wk[2]) * DH ** -0.5
    mask = torch.as_tensor(anc, dtype=torch.bool)
    pr = torch.softmax(lg.masked_fill(~mask, -torch.inf), dim=-1)
    torch.testing.assert_close(base[2], torch.einsum("hjc,chd->jhd", pr,
                                                     wv[2]))


def test_tree_op_validation():
    q, k, v, wk, wv = (torch.as_tensor(a) for a in _case("mha", "chain2"))
    anc = _anc("chain2")
    int8 = (k[0], v[0], torch.ones(P + 1, T, 4), torch.ones(P + 1, T, 4))
    with pytest.raises(NotImplementedError, match="einsum fallback"):
        pa.tree_paged_attention(q, int8, TABLE, POS0, wk, wv, anc,
                                dtype=torch.float32)
    with pytest.raises(TypeError, match="query dtype"):
        pa.tree_paged_attention(q, (k[0], v[0]), TABLE, POS0, wk, wv, anc,
                                dtype=torch.bfloat16)


@pytest.fixture(scope="module")
def models():
    tree = gpt2.random_params(gpt2.GPT2Config(**TINY), seed=13)
    jmodel = jax_gpt2_small(**TINY)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return jmodel, jparams, gpt2.build(gpt2.GPT2Config(**TINY), 13, "cpu")


@pytest.mark.parametrize("shape", ["fork2x2", "chain2"])
def test_forward_tree_matches_jax(models, shape):
    """``_forward_tree`` over the gathered view and the paged
    ``_forward_tree_paged`` (its wrapper's plain version on the CPU)
    against JAX ``_forward_tree`` on the same view: logits, wk and wv at
    fp32 atol 1e-5; ``gather_pages`` equals JAX's exactly."""
    jmodel, jparams, tmodel = models
    ts = TREE_SHAPES[shape]
    rng = np.random.default_rng(6)
    shape5 = (2, P + 1, T, 2, DH)
    k = rng.standard_normal(shape5, np.float32)
    v = rng.standard_normal(shape5, np.float32)
    tokens = rng.integers(0, 61, size=(S, ts.num_candidates + 1))
    jview = jgen.gather_pages(jmodel.config,
                              jgen.KVCache(jnp.asarray(k), jnp.asarray(v)),
                              jnp.asarray(TABLE))
    want = jgen._forward_tree(jmodel.config, jparams, jnp.asarray(tokens),
                              jview, jnp.asarray(POS0), ts.depths,
                              ts.ancestors)
    pool = tgen.KVCache(torch.as_tensor(k), torch.as_tensor(v))
    view = tgen.gather_pages(pool, torch.as_tensor(TABLE), torch.float32)
    for w, g in zip(jview, view):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with torch.no_grad():
        dense = tgen._forward_tree(tmodel, torch.as_tensor(tokens), view,
                                   torch.as_tensor(POS0), ts.depths,
                                   ts.ancestors)
        paged = tgen._forward_tree_paged(
            tmodel, torch.as_tensor(tokens), pool, torch.as_tensor(TABLE),
            torch.as_tensor(POS0), ts.depths, ts.ancestors)
    for got in (dense, paged):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                       rtol=0)
    # The pool is only read.
    np.testing.assert_array_equal(pool.k.numpy(), k)
    np.testing.assert_array_equal(pool.v.numpy(), v)
