"""Shapes the port's CUDA kernels do not take, against the JAX package,
on the CPU.

JAX's Pallas kernels take any head dim and any tree; the port's kernels
take head dims 32, 64 and 128 and trees of at most 32 nodes.  So the
port decides from the shapes, before any launch, where a call goes
instead: a paged engine at another head dim runs every family on the
einsum path and a tree wider than 32 nodes verifies on it
(``paged_dispatch``, listed in ``metrics()["paged_attn"]["fallbacks"]``),
and ``impl='flash'`` at another head dim runs the dense math on the card
(``flash_route``, counted in ``attention.dense_routes``).  Each route
serves or computes what the JAX package does on the same input.

The kernel engine needs a card; here it is rehearsed on the CPU with the
CPU admitted to ``KERNEL_DEVICES``, where every kernel wrapper runs its
plain version on the CPU tensors it is given.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudp.models.gpt2 import gpt2_small as jax_gpt2_small
from tpudp.ops.attention import multihead_attention as jax_mha
from tpudp.serve import Engine as JaxEngine
from tpudp_torch.models import gpt2
from tpudp_torch.ops import attention
from tpudp_torch.ops import paged_attention as pa
from tpudp_torch.serve import Engine
from tpudp_torch.serve import engine as engine_mod
from tpudp_torch.serve.engine import PAGED_FAMILIES, paged_dispatch

NEW = 8
# 40 nodes: 13 first steps off the root, two continuations each.
WIDE_TREE = (-1,) + (0,) * 13 + tuple(1 + i // 2 for i in range(26))


def _fallbacks(table):
    return sorted(f for f, impl in table.items() if impl != "kernel")


@pytest.mark.parametrize("head_dim", [8, 48, 64])
@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_paged_dispatch_routes_head_dims_without_a_kernel(head_dim,
                                                          kv_dtype):
    """Only a head dim the kernels take (64 here) keeps them; at 8 and 48
    every family goes to the einsum path.  An int8 pool's tree verify is
    einsum at any head dim, as in JAX."""
    table = paged_dispatch("kernel", kv_dtype, head_dim, 5)
    if head_dim == 64:
        assert _fallbacks(table) == (["tree_verify_paged"]
                                     if kv_dtype == "int8" else [])
    else:
        assert table == dict.fromkeys(PAGED_FAMILIES, "einsum")
    assert paged_dispatch("einsum", kv_dtype, head_dim, 5) == \
        dict.fromkeys(PAGED_FAMILIES, "einsum")


@pytest.mark.parametrize("nodes,routed", [(5, False), (32, False),
                                          (33, True), (len(WIDE_TREE), True)])
def test_paged_dispatch_routes_trees_past_the_kernel_cap(nodes, routed):
    """Trees of up to 32 nodes (one 32-bit ancestor mask a row) stay on
    the tree kernel; wider ones verify on the einsum path, and only
    tree verify moves."""
    table = paged_dispatch("kernel", None, 64, nodes)
    assert _fallbacks(table) == (["tree_verify_paged"] if routed else [])
    assert pa.TREE_KERNEL_MAX_NODES == 32


def _model_and_jax(cfg_kw, seed, scale=1.0):
    """The port's GPT-2 and the JAX one on the same random weights (the
    matrices scaled by ``scale``)."""
    tree = gpt2.random_params(gpt2.GPT2Config(**cfg_kw), seed=seed)
    tree = jax.tree_util.tree_map(
        lambda a: a * scale if a.ndim == 2 else a, tree)
    model = gpt2.GPT2(gpt2.GPT2Config(**cfg_kw))
    model.load_state_dict(gpt2.params_from_jax(tree))
    return model, jax_gpt2_small(**cfg_kw), jax.tree_util.tree_map(
        jnp.asarray, tree)


def _prompts(seed, vocab):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, size=16).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, vocab, size=3 + 4 * i)
                               .astype(np.int32)]) for i in range(3)]
    prompts += [np.tile(rng.integers(0, vocab, size=4), 6)[:n]
                .astype(np.int32) for n in (14, 23)]
    return prompts


def _serve(engine, prompts):
    handles = [engine.submit(p, NEW) for p in prompts]
    while engine.queue_depth or engine.slots_in_use:
        engine.step()
        if hasattr(engine, "check_paged"):
            engine.check_paged()
    return [h.tokens for h in handles]


def _kernel_engine_on_cpu(monkeypatch, model, **kw):
    """A kernel engine rehearsed on the CPU: its kernel wrappers run
    their plain versions on the CPU tensors they are given."""
    monkeypatch.setattr(engine_mod, "KERNEL_DEVICES", ("cuda", "cpu"))
    return Engine(model, device="cpu", paged_attn="kernel", **kw)


HD48 = dict(vocab_size=61, max_seq_len=96, num_layers=2, num_heads=2,
            d_model=96)


def test_head_dim_48_engine_serves_the_jax_engines_tokens(monkeypatch):
    """GPT-2 with d 96 over 2 heads (head dim 48, which no kernel takes):
    the default engine and a kernel engine serve the JAX engine's greedy
    tokens; the kernel engine lists all four families as fallbacks and
    launches nothing."""
    model, jmodel, jparams = _model_and_jax(HD48, 31)
    prompts = _prompts(32, HD48["vocab_size"])
    kw = dict(num_slots=2, max_len=48, prefill_chunk=8, kv_pages=12)
    want = _serve(JaxEngine(jmodel, jparams, **kw), prompts)
    assert _serve(Engine(model, device="cpu", **kw), prompts) == want
    before = {n: fn.launches for n, fn in pa.KERNELS.items()}
    eng = _kernel_engine_on_cpu(monkeypatch, model, **kw)
    m = eng.metrics()["paged_attn"]
    assert m["resolved"] == "kernel"
    assert m["dispatch"] == dict.fromkeys(PAGED_FAMILIES, "einsum")
    assert m["fallbacks"] == sorted(PAGED_FAMILIES)
    assert _serve(eng, prompts) == want
    assert {n: fn.launches for n, fn in pa.KERNELS.items()} == before


HD32 = dict(vocab_size=61, max_seq_len=96, num_layers=2, num_heads=2,
            d_model=64)


def test_wide_tree_engine_serves_the_jax_engines_tokens(monkeypatch):
    """A 40-node ``speculate_tree`` (past the tree kernel's 32) at head
    dim 32: the default engine and a kernel engine give the JAX engine's
    greedy tokens and speculation counters; the kernel engine verifies
    trees on the einsum path, listed as its one fallback, and runs the
    other families through the kernel wrappers."""
    model, jmodel, jparams = _model_and_jax(HD32, 41, scale=5.0)
    prompts = _prompts(42, HD32["vocab_size"])
    kw = dict(num_slots=2, max_len=48, prefill_chunk=8, kv_pages=12,
              speculate_k=2, speculate_tree=WIDE_TREE)
    jax_eng = JaxEngine(jmodel, jparams, **kw)
    want = _serve(jax_eng, prompts)
    counters = ("tree_verify_steps", "draft_tokens", "draft_accepted")
    jax_counts = {c: jax_eng.stats[c] for c in counters}
    assert jax_counts["tree_verify_steps"] > 0
    assert jax_counts["draft_accepted"] > 0
    eng = Engine(model, device="cpu", **kw)
    assert _serve(eng, prompts) == want
    assert {c: eng.stats[c] for c in counters} == jax_counts
    eng = _kernel_engine_on_cpu(monkeypatch, model, **kw)
    assert eng.metrics()["paged_attn"]["fallbacks"] == ["tree_verify_paged"]
    assert _serve(eng, prompts) == want
    assert {c: eng.stats[c] for c in counters} == jax_counts


@pytest.mark.parametrize("head_dim", [32, 48, 64, 96, 128])
def test_flash_route_by_head_dim(head_dim):
    """On a CUDA device the flash kernels take head dims 32, 64 and 128
    in float32 and bfloat16; 48 and 96 go to the dense math.  On the CPU
    the plain versions take any head dim, so only the JAX rule (``t %
    128``) routes there."""
    shape = (2, 256, 4, head_dim)
    kernel = head_dim in (32, 64, 128)
    for dtype in (torch.float32, torch.bfloat16):
        assert attention.flash_route(shape, dtype, "cuda") == (
            "flash" if kernel else "dense")
        assert attention.flash_route(shape, dtype, "cpu") == "flash"
        assert attention.flash_route((2, 200, 4, head_dim), dtype,
                                     "cuda") == "dense"
    assert attention.flash_route(shape, torch.float16, "cuda") == "dense"


@pytest.mark.parametrize("causal", [True, False])
def test_flash_at_head_dim_48_matches_jax_flash(causal, monkeypatch):
    """``multihead_attention(impl='flash')`` at head dim 48 equals JAX's
    (its Pallas kernel in interpret mode) within the flash tolerance,
    2e-5 in float32: on the CPU through the flash op's plain versions,
    and through the dense math the card routes it to, counted once."""
    rng = np.random.default_rng(50 + causal)
    q, k, v = (rng.standard_normal((2, 128, 2, 48), np.float32)
               for _ in range(3))
    want = np.asarray(jax_mha(*(jnp.asarray(x) for x in (q, k, v)),
                              causal=causal, impl="flash"))
    tq, tk, tv = (torch.as_tensor(x) for x in (q, k, v))
    got = attention.multihead_attention(tq, tk, tv, causal=causal,
                                        impl="flash")
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    route = attention.flash_route
    monkeypatch.setattr(attention, "flash_route",
                        lambda shape, dtype, _: route(shape, dtype, "cuda"))
    before = attention.dense_routes
    got = attention.multihead_attention(tq, tk, tv, causal=causal,
                                        impl="flash")
    assert attention.dense_routes == before + 1
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
