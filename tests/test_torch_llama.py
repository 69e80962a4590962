"""The port's LLaMA family (``tpudp_torch.models.llama``) against the flax
model of ``tpudp/models/llama.py``, at the tiny geometry of
tests/test_llama.py with grouped-query heads.

The same numpy weights (``llama.random_params``) go into both: full
forward logits (dense, and flash through the kernels' plain versions),
RoPE at shared and per-row positions, the KV-cached greedy ``generate``,
and the tree-verify forward over a dense view and through the block table
agree with JAX at float32 tolerances; the decode cache is ``kv_heads``
wide.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudp.models.llama import Llama as JaxLlama
from tpudp.models.llama import LlamaConfig as JaxLlamaConfig
from tpudp.models.llama import apply_rope as jax_apply_rope
from tpudp_torch.models import generate as gen
from tpudp_torch.models import llama

# ``tpudp.models`` re-exports the function ``generate`` under the module's
# name, so the module is looked up by its full name.
jax_gen = importlib.import_module("tpudp.models.generate")

TINY = dict(vocab_size=61, max_seq_len=160, num_layers=2, num_heads=4,
            num_kv_heads=2, d_model=32)
TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module")
def models():
    tree = llama.random_params(llama.LlamaConfig(**TINY), seed=31)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    model = llama.Llama(llama.LlamaConfig(**TINY))
    model.load_state_dict(llama.params_from_jax(tree))
    return tree, jparams, model


@pytest.mark.parametrize("kv_heads", [None, 2, 1])
def test_forward_logits_match_flax(kv_heads):
    """MHA, GQA and MQA widths: the flax tree's names and shapes map onto
    the port's modules and the logits agree at 2e-5."""
    cfg = dict(TINY, num_kv_heads=kv_heads)
    tree = llama.random_params(llama.LlamaConfig(**cfg), seed=3)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    init = JaxLlama(JaxLlamaConfig(**cfg)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"]
    assert (jax.tree_util.tree_map(np.shape, init)
            == jax.tree_util.tree_map(np.shape, tree))
    tokens = np.random.default_rng(4).integers(0, 61, size=(2, 13))
    want = np.asarray(JaxLlama(JaxLlamaConfig(**cfg)).apply(
        {"params": jparams}, jnp.asarray(tokens)))
    model = llama.build(llama.LlamaConfig(**cfg), 3, "cpu")
    got = model(torch.as_tensor(tokens)).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_flash_forward_matches_flax_flash(models):
    """``attn_impl='flash'`` at a 128-token window: the port's flash op
    (its plain versions on the CPU) against the flax model's flash path
    (the Pallas kernels in interpret mode)."""
    tree, jparams, _ = models
    cfg = dict(TINY, attn_impl="flash")
    tokens = np.random.default_rng(5).integers(0, 61, size=(1, 128))
    want = np.asarray(JaxLlama(JaxLlamaConfig(**cfg)).apply(
        {"params": jparams}, jnp.asarray(tokens)))
    model = llama.Llama(llama.LlamaConfig(**cfg))
    model.load_state_dict(llama.params_from_jax(tree))
    got = model(torch.as_tensor(tokens)).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("per_row", [False, True])
def test_apply_rope_matches_jax(per_row):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 5, 4, 16), np.float32)
    pos = (rng.integers(0, 900, size=(3, 5)) if per_row
           else np.arange(7, 12)).astype(np.int32)
    want = np.asarray(jax_apply_rope(jnp.asarray(x), jnp.asarray(pos)))
    got = llama.apply_rope(torch.as_tensor(x), torch.as_tensor(pos)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_config_validation():
    with pytest.raises(ValueError, match="divisible"):
        llama.LlamaConfig(num_heads=3, num_kv_heads=2, d_model=48)
    with pytest.raises(ValueError, match="even head dim"):
        llama.LlamaConfig(num_heads=16, d_model=48)
    for kv in (0, 5):
        with pytest.raises(ValueError, match="num_kv_heads"):
            llama.LlamaConfig(num_heads=4, num_kv_heads=kv, d_model=32)
    with pytest.raises(NotImplementedError, match="slice 6b"):
        llama.LlamaConfig(attn_impl="ring")
    cfg = llama.LlamaConfig(d_model=768, num_heads=12, num_kv_heads=3,
                            mlp_hidden=2048)
    assert (cfg.kv_heads, cfg.hidden) == (3, 2048)
    assert llama.LlamaConfig(d_model=512).hidden == JaxLlamaConfig(
        d_model=512).hidden == 1408


def test_greedy_generate_matches_jax(models):
    """Prefill plus cached decode steps at KV width: JAX ``generate``'s
    greedy tokens, and a ``(layers, b, len, kv_heads, dh)`` cache."""
    _, jparams, model = models
    prompt = np.random.default_rng(7).integers(0, 61, size=(2, 9))
    want = np.asarray(jax_gen.generate(JaxLlama(JaxLlamaConfig(**TINY)),
                                       jparams, jnp.asarray(prompt), 12))
    got = gen.generate(model, torch.as_tensor(prompt).long(), 12).numpy()
    np.testing.assert_array_equal(got, want)
    cache = gen.KVCache.zeros(model.config, 2, 21)
    assert cache.k.shape == (2, 2, 21, 2, 8)


def test_cached_forward_matches_jax_at_per_row_depths(models):
    """``_forward_cached`` with per-row ``pos`` (the engine's slot
    arena): a 3-token window at depths (9, 4) over a cache prefilled by
    both, logits at 2e-5 and the cache rows written."""
    _, jparams, model = models
    jcfg = JaxLlamaConfig(**TINY)
    rng = np.random.default_rng(8)
    prompt = rng.integers(0, 61, size=(2, 9))
    window = rng.integers(0, 61, size=(2, 3))
    pos = np.array([9, 4], np.int32)
    jcache = jax_gen.KVCache.zeros(jcfg, 2, 16)
    _, jcache = jax_gen._forward_cached(jcfg, jparams, jnp.asarray(prompt),
                                        jcache, 0)
    want, jcache = jax_gen._forward_cached(jcfg, jparams,
                                           jnp.asarray(window), jcache,
                                           jnp.asarray(pos))
    cache = gen.KVCache.zeros(model.config, 2, 16)
    with torch.no_grad():
        gen._forward_cached(model, torch.as_tensor(prompt), cache, 0)
        got, cache = gen._forward_cached(model, torch.as_tensor(window),
                                         cache, torch.as_tensor(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(cache.k[:, 1, :7].numpy(),
                               np.asarray(jcache.k)[:, 1, :7], **TOL)


FORK2X2 = ((0, 1, 1, 2, 2), ((1, 0, 0, 0, 0), (1, 1, 0, 0, 0),
                             (1, 0, 1, 0, 0), (1, 1, 0, 1, 0),
                             (1, 0, 1, 0, 1)))


def test_tree_forwards_match_jax(models):
    """``block_tree`` through ``_forward_tree`` over a dense view, and
    ``_forward_tree_paged`` through a block table holding the same rows,
    against JAX's ``_forward_tree``: logits and the window K/V (RoPE at
    ``pos0 + depth``, per row) at 2e-5."""
    _, jparams, model = models
    jcfg = JaxLlamaConfig(**TINY)
    depths, anc = FORK2X2
    rng = np.random.default_rng(9)
    view_k = rng.standard_normal((2, 2, 16, 2, 8), np.float32)
    view_v = rng.standard_normal((2, 2, 16, 2, 8), np.float32)
    tokens = rng.integers(0, 61, size=(2, 5))
    pos0 = np.array([11, 5], np.int32)
    want = jax_gen._forward_tree(
        jcfg, jparams, jnp.asarray(tokens),
        jax_gen.KVCache(jnp.asarray(view_k), jnp.asarray(view_v)),
        jnp.asarray(pos0), depths, anc)
    with torch.no_grad():
        dense = gen._forward_tree(
            model, torch.as_tensor(tokens),
            gen.KVCache(torch.as_tensor(view_k), torch.as_tensor(view_v)),
            torch.as_tensor(pos0), depths, anc)
        # The same rows as a pool of 8-token pages: slot 0 on pages 3, 0,
        # slot 1 on pages 1, 2 (page 4 is the scratch).
        table = torch.tensor([[3, 0], [1, 2]], dtype=torch.int32)
        pool = torch.zeros((2, 5, 8, 2, 8)), torch.zeros((2, 5, 8, 2, 8))
        for s in range(2):
            for i in range(2):
                for buf, view in zip(pool, (view_k, view_v)):
                    buf[:, table[s, i]] = torch.as_tensor(
                        view[:, s, 8 * i:8 * i + 8])
        paged = gen._forward_tree_paged(model, torch.as_tensor(tokens),
                                        gen.KVCache(*pool), table,
                                        torch.as_tensor(pos0), depths, anc)
    for got in (dense, paged):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_engine_and_draft_model_drafter_take_llama(models):
    """``Engine`` and ``DraftModelDrafter`` take a LLaMA model unchanged:
    speculation with a LLaMA draft model over the paged pool gives the
    plain engine's greedy tokens."""
    from tpudp_torch.serve import DraftModelDrafter, Engine

    _, _, model = models
    draft = llama.build(llama.LlamaConfig(**TINY), 5, "cpu")
    prompts = [np.random.default_rng(10 + i).integers(0, 61, size=7 + 5 * i)
               .astype(np.int32) for i in range(3)]
    plain = Engine(model, device="cpu", num_slots=2, max_len=48,
                   prefill_chunk=8)
    refs = [plain.submit(p, 8) for p in prompts]
    plain.run_until_complete()
    want = [h.tokens for h in refs]
    eng = Engine(model, device="cpu", num_slots=2, max_len=48,
                 prefill_chunk=8, kv_pages=12, speculate_k=2,
                 drafter=DraftModelDrafter(draft))
    handles = [eng.submit(p, 8) for p in prompts]
    eng.run_until_complete()
    assert [h.tokens for h in handles] == want
    assert eng.stats["verify_steps"] > 0
