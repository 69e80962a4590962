"""The port's decode path (``tpudp_torch.models.generate``) and sampling
op (``tpudp_torch.ops.sampling``) against the JAX package, at the tiny
geometry of tests/test_paged_kernel.py (vocab 61, 2 layers, 2 heads,
d 32, pages of 8 tokens).  Weights and inputs come from numpy seeds and
reach the port through ``params_from_jax``."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudp.models.gpt2 import gpt2_small as jax_gpt2_small
from tpudp.ops.sampling import truncate_logits as jax_truncate_logits
from tpudp_torch.models import generate as tgen
from tpudp_torch.models import gpt2
from tpudp_torch.ops.sampling import truncate_logits

# ``tpudp.models`` re-exports the function ``generate`` under the module's
# name, so the module itself comes from the import system.
jgen = importlib.import_module("tpudp.models.generate")

TINY = dict(vocab_size=61, max_seq_len=96, num_layers=2, num_heads=2,
            d_model=32)
T, P, DH = 8, 8, 16
TABLE = np.array([[0, 1, 2, -1], [0, 1, 3, 4], [5, 6, -1, -1]], np.int32)


@pytest.fixture(scope="module")
def models():
    tree = gpt2.random_params(gpt2.GPT2Config(**TINY), seed=11)
    jmodel = jax_gpt2_small(**TINY)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tmodel = gpt2.build(gpt2.GPT2Config(**TINY), 11, "cpu")
    return jmodel, jparams, tmodel


@pytest.fixture(scope="module")
def jax_results():
    """JAX outputs by case, computed once: eager JAX costs seconds per
    forward, and several port variants compare with the same one."""
    return {}


def _pool(seed=0, layers=2):
    rng = np.random.default_rng(seed)
    shape = (layers, P + 1, T, 2, DH)
    return (rng.standard_normal(shape, np.float32),
            rng.standard_normal(shape, np.float32))


def _jax_pool(k, v):
    return jgen.KVCache(jnp.asarray(k), jnp.asarray(v))


def _torch_pool(k, v):
    return tgen.KVCache(torch.tensor(k), torch.tensor(v))


def test_write_token_pages_touches_one_token_row_only():
    """One committed token writes exactly one token row of the page
    holding ``pos``; inactive rows and unmapped pages go to scratch —
    the JAX unit pin, on the port."""
    pages = (torch.full((5, T, 2, 4), 7.0), torch.full((5, T, 2, 4), 7.0))
    table = torch.tensor([[2, 3, -1]], dtype=torch.int32)
    k_new = torch.full((1, 1, 2, 4), 1.5)
    v_new = torch.full((1, 1, 2, 4), 2.5)
    ok, ov = tgen.write_token_pages(
        tuple(p.clone() for p in pages), k_new, v_new, table,
        torch.tensor([13]), torch.ones(1, dtype=torch.bool))
    assert (ok[3, 5] == 1.5).all() and (ov[3, 5] == 2.5).all()
    rest = ok.clone()
    rest[3, 5] = 7.0
    assert (rest == 7.0).all()
    sk, _ = tgen.write_token_pages(
        tuple(p.clone() for p in pages), k_new, v_new, table,
        torch.tensor([13]), torch.zeros(1, dtype=torch.bool))
    assert (sk[:4] == 7.0).all() and (sk[4, 5] == 1.5).all()
    uk, _ = tgen.write_token_pages(
        tuple(p.clone() for p in pages), k_new, v_new, table,
        torch.tensor([18]), torch.ones(1, dtype=torch.bool))
    assert (uk[:4] == 7.0).all() and (uk[4, 2] == 1.5).all()


@pytest.mark.parametrize("case", ["vector3", "chunk", "misaligned_chunk",
                                  "whole_pool"])
def test_write_token_pages_matches_jax(case):
    """Same writes, same pool bytes as the JAX function (exactly: writes
    copy values)."""
    k, v = _pool(seed=1)
    rng = np.random.default_rng(2)
    active = np.array([True, True, False])
    layer = None
    if case == "vector3":
        pos, cur, table = np.array([17, 26, 4], np.int32), 3, TABLE
    elif case in ("chunk", "misaligned_chunk"):
        pos = np.int32(8 if case == "chunk" else 9)
        cur, table, active = T, TABLE[:1], np.array([True])
    else:
        pos, cur, table, layer = np.array([17, 26, 4], np.int32), 1, TABLE, 1
    b = table.shape[0]
    k_new = rng.standard_normal((b, cur, 2, DH), np.float32)
    v_new = rng.standard_normal((b, cur, 2, DH), np.float32)
    if layer is None:
        jpages, tpages = (k[0], v[0]), (k[0].copy(), v[0].copy())
    else:
        jpages, tpages = (k, v), (k.copy(), v.copy())
    want = jgen.write_token_pages(
        tuple(map(jnp.asarray, jpages)), jnp.asarray(k_new),
        jnp.asarray(v_new), jnp.asarray(table), jnp.asarray(pos),
        jnp.asarray(active), layer=layer)
    got = tgen.write_token_pages(
        tuple(map(torch.from_numpy, tpages)), torch.as_tensor(k_new),
        torch.as_tensor(v_new), torch.as_tensor(table),
        torch.as_tensor(pos), torch.as_tensor(active), layer=layer)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("traffic", ["decode", "verify3", "prefill"])
@pytest.mark.parametrize("impl", ["einsum", "kernel"])
def test_forward_paged_matches_jax(models, jax_results, traffic, impl):
    """``_forward_paged`` logits and the written pool against the JAX
    einsum forward (fp32, atol 1e-5).  ``impl='kernel'`` is whole-pool
    mode; on CPU tensors its kernel wrappers run the plain version."""
    jmodel, jparams, tmodel = models
    k, v = _pool(seed=3)
    rng = np.random.default_rng(4)
    if traffic == "prefill":
        table, pos, active = TABLE[:1], np.int32(8), np.array([True])
        tokens = rng.integers(0, 61, size=(1, T))
    else:
        cur = 1 if traffic == "decode" else 3
        table, pos = TABLE, np.array([17, 26, 4], np.int32)
        active = np.array([True, True, False])
        tokens = rng.integers(0, 61, size=(3, cur))
    if traffic not in jax_results:
        jax_results[traffic] = jgen._forward_paged(
            jmodel.config, jparams, jnp.asarray(tokens), _jax_pool(k, v),
            jnp.asarray(table), jnp.asarray(pos), jnp.asarray(active))
    want_logits, want_pool = jax_results[traffic]
    with torch.no_grad():
        logits, pool = tgen._forward_paged(
            tmodel, torch.as_tensor(tokens), _torch_pool(k, v),
            torch.as_tensor(table), torch.as_tensor(pos),
            torch.as_tensor(active), impl=impl)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               atol=1e-5, rtol=0)
    for w, g in zip(want_pool, pool):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("vector", [False, True])
def test_forward_cached_matches_jax(models, vector):
    jmodel, jparams, tmodel = models
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 61, size=(2, 5))
    pos = np.array([3, 11], np.int32) if vector else np.int32(0)
    shape = (2, 2, 24, 2, DH)
    k0 = rng.standard_normal(shape, np.float32)
    v0 = rng.standard_normal(shape, np.float32)
    want_logits, want_cache = jgen._forward_cached(
        jmodel.config, jparams, jnp.asarray(tokens),
        jgen.KVCache(jnp.asarray(k0), jnp.asarray(v0)), jnp.asarray(pos))
    with torch.no_grad():
        logits, cache = tgen._forward_cached(
            tmodel, torch.as_tensor(tokens),
            tgen.KVCache(torch.tensor(k0), torch.tensor(v0)),
            torch.as_tensor(pos))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               atol=1e-5, rtol=0)
    for w, g in zip(want_cache, cache):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)


def test_generate_greedy_matches_jax(models):
    jmodel, jparams, tmodel = models
    prompt = np.random.default_rng(6).integers(0, 61, size=(2, 7))
    want = np.asarray(jgen.generate(jmodel, jparams, jnp.asarray(prompt),
                                    10))
    got = tgen.generate(tmodel, torch.as_tensor(prompt), 10).numpy()
    np.testing.assert_array_equal(got, want)


def test_generate_sampled_reproducible(models):
    _, _, tmodel = models
    prompt = torch.as_tensor(np.random.default_rng(7).integers(0, 61,
                                                               size=(1, 5)))

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return tgen.generate(tmodel, prompt, 12, temperature=0.8, top_k=20,
                             top_p=0.9, generator=g)

    assert torch.equal(run(1), run(1))
    with pytest.raises(ValueError, match="Generator"):
        tgen.generate(tmodel, prompt, 2, temperature=0.8)


def test_truncate_logits_matches_jax():
    """Per-row top-k, top-p and both, with the disabled sentinels mixed
    in: the same kept set and values as the JAX op."""
    rng = np.random.default_rng(8)
    logits = rng.standard_normal((6, 61), np.float32) * 3
    logits[1, :5] = logits[1, 5]  # ties at the k-th value
    top_k = np.array([0, 6, 3, 0, 10, 1], np.int32)
    top_p = np.array([1.0, 1.0, 0.5, 0.3, 0.9, 0.95], np.float32)
    want = np.asarray(jax_truncate_logits(jnp.asarray(logits),
                                          jnp.asarray(top_k),
                                          jnp.asarray(top_p)))
    got = truncate_logits(torch.as_tensor(logits), torch.as_tensor(top_k),
                          torch.as_tensor(top_p)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_array_equal(got[~np.isinf(got)],
                                  want[~np.isinf(want)])
