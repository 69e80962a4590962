"""The port's prefix reuse (``tpudp_torch.serve.prefix_cache``) against
the JAX package's.

The page allocator and radix index, and the dense copy cache
(``PrefixCache``), on identical operation sequences: the same page and
block ids, refcounts, lookups, adoptions, evictions and node counts,
step by step; ``copy_block_in``/``copy_block_out`` give JAX's arrays.
``Engine(prefix_cache_blocks=)`` gives JAX's engine's greedy tokens and
``prefix_*`` stats on shared-prefix traffic, and the cases of
``tests/test_prefix_cache.py`` that hold on the port (a hit stops one
chunk short, multi-turn reuse, sampled draws unchanged, speculation,
cancel mid-prefill, close, eviction churn, containment and publish
faults) run against the port's own ``generate()``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudp.models.gpt2 import GPT2Config as JaxConfig
from tpudp.models.gpt2 import gpt2_small as jax_gpt2_small
from tpudp.serve import Engine as JaxEngine
from tpudp.serve.prefix_cache import PageIndex as JaxIndex
from tpudp.serve.prefix_cache import PagePool as JaxPool
from tpudp.serve.prefix_cache import PrefixCache as JaxCache
from tpudp.serve.prefix_cache import copy_block_in as jax_copy_in
from tpudp.serve.prefix_cache import copy_block_out as jax_copy_out
from tpudp_torch.models import gpt2
from tpudp_torch.models.generate import KVCache, generate
from tpudp_torch.models.gpt2 import GPT2Config
from tpudp_torch.serve import Engine, FinishReason, NgramDrafter
from tpudp_torch.serve.faults import FaultySteps, InjectedFault
from tpudp_torch.serve.prefix_cache import (PageIndex, PagePool, PrefixCache,
                                            copy_block_in, copy_block_out)
from tpudp_torch.utils.watchdog import Watchdog

TINY = dict(vocab_size=61, max_seq_len=96, num_layers=2, num_heads=2,
            d_model=32)
PAGE = 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite's workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(num_pages=6):
    jpool = JaxPool(JaxConfig(**TINY), num_pages, PAGE)
    tpool = PagePool(GPT2Config(**TINY), num_pages, PAGE)
    return (jpool, JaxIndex(jpool)), (tpool, PageIndex(tpool))


def _state(pool, index):
    return (sorted(pool._rc.items()), list(pool._free),
            sorted((n.block, n.refs, n.stamp, n.key)
                   for n in index._by_block.values()),
            index.evictions)


def _script(seed):
    """A random but valid op sequence over one pool and index: allocate
    pages for a few requests' prefixes, adopt them, look prefixes up and
    map the hits (share + pin), release, and evict under pressure."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 61, size=24)
    prompts = [np.concatenate([base[:rng.integers(0, 4) * PAGE],
                               rng.integers(0, 61, size=12)])
               for _ in range(8)]
    return prompts


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pool_and_index_track_jax_op_for_op(seed):
    sides = _pair()
    for prompt in _script(seed):
        results = []
        for pool, index in sides:
            out = []
            nodes = index.lookup(prompt)
            out.append([n.block for n in nodes])
            held = []
            for node in nodes:  # map the hit like an admission
                index.pin(node)
                pool.share(node.block)
                held.append(node.block)
            need = len(prompt) // PAGE - len(nodes)
            for _ in range(need):
                page = pool.alloc()
                while page is None and index.evict_one():
                    page = pool.alloc()
                out.append(page)
                if page is None:
                    break
                held.append(page)
            full = len(prompt) // PAGE
            if len(held) == full:
                out.append(index.adopt(prompt, held))
            for node in nodes:
                index.unpin(node)
            for page in held:
                pool.release(page)
            pool.check(index.tree_refs())
            index.check()
            out.append(_state(pool, index))
            results.append(out)
        assert results[0] == results[1]
    assert sides[1][1].evictions > 0  # the script ran under pressure


def test_pool_refcount_discipline_and_buffers():
    (_, _), (pool, index) = _pair(num_pages=3)
    assert pool.scratch == 3 and pool.free_pages == 3
    assert isinstance(pool.pages.k, torch.Tensor)
    assert pool.pages.k.shape == (2, 4, PAGE, 2, 16)
    assert pool.page_bytes() == 2 * 2 * PAGE * 2 * 16 * 4
    a = pool.alloc()
    pool.share(a)
    pool.release(a)
    assert pool.used_pages == 1
    pool.release(a)
    assert pool.free_pages == 3
    pool.check({})
    with pytest.raises(RuntimeError, match="disagree"):
        pool.alloc()
        pool.check({})
    with pytest.raises(ValueError):
        PagePool(GPT2Config(**TINY), 0, PAGE)


def test_jax_pool_dtype_is_float32():
    # The pools compared above hold the same float32 geometry.
    jpool = JaxPool(JaxConfig(**TINY), 2, PAGE)
    assert jpool.pages.k.dtype == jnp.float32
    assert PagePool(GPT2Config(**TINY), 2, PAGE).pages.k.dtype == \
        torch.float32



# -- the dense copy cache ------------------------------------------------


def _cache_state(cache):
    return (cache.used_blocks, cache.free_blocks, cache.node_count,
            cache.evictions, list(cache._free),
            sorted((n.block, n.refs, n.stamp, n.key)
                   for n in cache._by_block.values()))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prefix_cache_tracks_jax_op_for_op(seed):
    """Random lookup / pin / publish / unpin / flush sequences under a
    small block budget: the same block ids, new-block lists, node counts
    and eviction counts as JAX's ``PrefixCache``, step by step."""
    rng = np.random.default_rng(seed)
    caches = (PrefixCache(GPT2Config(**TINY), 5, PAGE),
              JaxCache(JaxConfig(**TINY), 5, PAGE))
    base = rng.integers(0, 61, size=24)
    pinned: list[list[int]] = [[], []]
    for step in range(60):
        tokens = np.concatenate([base[:rng.integers(0, 4) * PAGE],
                                 rng.integers(0, 61, size=8)])
        op = rng.choice(["lookup", "publish", "publish", "pin", "unpin",
                         "flush"], p=[0.25, 0.35, 0.1, 0.15, 0.1, 0.05])
        outs = []
        for side, cache in enumerate(caches):
            if op == "lookup":
                outs.append(cache.lookup(tokens))
            elif op == "publish":
                outs.append(cache.publish(tokens, len(tokens) // PAGE))
            elif op == "pin":
                got = cache.lookup(tokens)
                cache.pin(got)
                pinned[side].append(got)
                outs.append(got)
            elif op == "unpin" and pinned[side]:
                cache.unpin(pinned[side].pop(0))
            elif op == "flush":
                cache.flush()
                pinned[side] = []
            cache.check()
            outs.append(_cache_state(cache))
        assert outs[: len(outs) // 2] == outs[len(outs) // 2:], (step, op)
    assert caches[0].evictions > 0


def test_prefix_cache_unit_cases_match_jax():
    """JAX's index cases on both caches: publish and lookup round trip,
    LRU eviction of unreferenced leaves, pinned blocks never evicted, an
    insert never evicting its own path; validation messages."""
    for Cache, Cfg in ((PrefixCache, GPT2Config), (JaxCache, JaxConfig)):
        cfg = Cfg(vocab_size=31, max_seq_len=32, num_layers=1,
                  num_heads=1, d_model=8)
        pc = Cache(cfg, 4, 4)
        seq = np.arange(12, dtype=np.int32)
        new = pc.publish(seq, 3)
        assert [start for _, start in new] == [0, 4, 8]
        blocks = [b for b, _ in new]
        assert pc.lookup(seq) == blocks and pc.lookup(seq[:7]) == blocks[:1]
        assert pc.publish(seq, 3) == [] and pc.node_count == 3
        pc = Cache(cfg, 3, 4)
        (a0, _), (a1, _) = pc.publish(np.arange(8, dtype=np.int32), 2)
        (b0, _), = pc.publish(np.arange(8, 16, dtype=np.int32), 1)
        pc.lookup(np.arange(8, dtype=np.int32))
        (c0, _), = pc.publish(np.arange(16, 24, dtype=np.int32), 1)
        assert c0 == b0 and pc.evictions == 1
        pc = Cache(cfg, 1, 4)
        (b0, _), = pc.publish(np.arange(4, dtype=np.int32), 1)
        pc.pin([b0])
        assert pc.publish(np.arange(4, 8, dtype=np.int32), 1) == []
        pc.unpin([b0])
        assert pc.publish(np.arange(4, 8, dtype=np.int32), 1) == [(b0, 0)]
        pc = Cache(cfg, 2, 4)
        assert [s for _, s in pc.publish(np.arange(12, dtype=np.int32),
                                         3)] == [0, 4]
        pc.check()
        for kw, match in (({"num_blocks": 0}, "num_blocks"),
                          ({"block_tokens": 0}, "block_tokens")):
            args = {"num_blocks": 2, "block_tokens": 4, **kw}
            with pytest.raises(ValueError, match=match):
                Cache(cfg, **args)


def test_block_copies_match_jax():
    from tpudp.models.generate import KVCache as JaxKV

    rng = np.random.default_rng(3)
    arena = KVCache(*(torch.from_numpy(rng.standard_normal(
        (2, 3, 16, 2, 16), np.float32)) for _ in range(2)))
    pool = KVCache(*(torch.from_numpy(rng.standard_normal(
        (2, 4, PAGE, 2, 16), np.float32)) for _ in range(2)))

    def jax_of(cache):
        return JaxKV(*(jnp.asarray(t.numpy()) for t in cache))

    want_in = jax_copy_in(jax_of(arena), jax_of(pool), np.int32(2),
                          np.int32(1), np.int32(8))
    want_out = jax_copy_out(jax_of(arena), jax_of(pool), np.int32(3),
                            np.int32(2), np.int32(4))
    got_in = copy_block_in(KVCache(*(t.clone() for t in arena)), pool, 2, 1,
                           8)
    got_out = copy_block_out(arena, KVCache(*(t.clone() for t in pool)), 3,
                             2, 4)
    for got, want in ((got_in, want_in), (got_out, want_out)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.fixture(scope="module")
def engine_setup():
    tree = gpt2.random_params(gpt2.GPT2Config(**TINY), seed=61)
    model = gpt2.GPT2(gpt2.GPT2Config(**TINY))
    model.load_state_dict(gpt2.params_from_jax(tree))
    return (jax_gpt2_small(**TINY), jax.tree_util.tree_map(jnp.asarray, tree),
            model)


def _ref(model, prompt, n):
    return generate(model, torch.as_tensor(prompt[None]).long(),
                    n)[0, prompt.size:].tolist()


def _eng(model, **kw):
    kw.setdefault("num_slots", 1)
    kw.setdefault("max_len", 48)
    kw.setdefault("prefill_chunk", 8)
    kw.setdefault("prefix_cache_blocks", 8)
    return Engine(model, device="cpu", **kw)


PREFIX_STATS = ("prefix_lookups", "prefix_hit_tokens",
                "prefix_published_blocks")


def test_dense_prefix_engine_matches_jax(engine_setup):
    """Shared-prefix traffic over two slots and a 6-block budget (hits,
    publishes, evictions): greedy tokens, ``prefix_*`` stats and the
    cache's block ids and node count equal JAX's engine's, and equal the
    engine without the cache."""
    jmodel, jparams, model = engine_setup
    rng = np.random.default_rng(0)
    shared = rng.integers(0, 61, size=20).astype(np.int32)
    prompts = [np.concatenate([shared[:8 + 4 * (i % 3)],
                               rng.integers(0, 61, size=3 + i)
                               .astype(np.int32)]) for i in range(6)]
    kw = dict(num_slots=2, max_len=48, prefill_chunk=8)
    runs = []
    for eng in (_eng(model, prefix_cache_blocks=6, **kw),
                JaxEngine(jmodel, jparams, prefix_cache_blocks=6, **kw),
                _eng(model, prefix_cache_blocks=0, **kw)):
        handles = []
        for i, p in enumerate(prompts):
            handles.append(eng.submit(p, 5))
            if i % 2:
                eng.run_until_complete()
        eng.run_until_complete()
        runs.append((eng, [h.tokens for h in handles]))
    (port, got), (jeng, want), (cold, plain) = runs
    assert got == want == plain
    assert {k: port.stats[k] for k in PREFIX_STATS} == \
        {k: jeng.stats[k] for k in PREFIX_STATS}
    assert port.stats["prefix_hit_tokens"] > 0
    assert _cache_state(port.prefix_cache)[:5] == \
        _cache_state(jeng.prefix_cache)[:5]
    assert dict(port.stats) == dict(jeng.stats)
    assert not any(k.startswith("prefix") for k in cold.stats)
    assert cold.prefix_cache is None
    with pytest.raises(ValueError, match="mutually exclusive"):
        _eng(model, kv_pages=12)
    with pytest.raises(ValueError, match="prefix_cache_blocks must be"):
        _eng(model, prefix_cache_blocks=-1)


def test_hits_stop_a_chunk_short_and_grow_over_turns(engine_setup):
    _, _, model = engine_setup
    rng = np.random.default_rng(1)
    p = rng.integers(0, 61, size=16).astype(np.int32)
    eng = _eng(model)
    h1 = eng.submit(p, 4)
    eng.run_until_complete()
    chunks = eng.stats["prefill_chunks"]
    h2 = eng.submit(p, 4)
    eng.run_until_complete()
    assert eng.stats["prefix_hit_tokens"] == 8
    assert eng.stats["prefill_chunks"] == chunks + 1
    assert h1.tokens == h2.tokens == _ref(model, p, 4)
    eng = _eng(model, max_len=96, prefix_cache_blocks=16)
    hist, hits = rng.integers(0, 61, size=18).astype(np.int32), []
    for _ in range(3):
        h = eng.submit(hist, 5)
        eng.run_until_complete()
        assert h.tokens == _ref(model, hist, 5)
        hits.append(eng.stats["prefix_hit_tokens"])
        hist = np.concatenate([hist, np.asarray(h.tokens, np.int32),
                               rng.integers(0, 61, size=3).astype(np.int32)])
    assert hits[0] == 0 < hits[1] < hits[2]
    eng.prefix_cache.check()


def test_sampled_draws_and_speculation_unchanged_by_cache(engine_setup):
    _, _, model = engine_setup
    rng = np.random.default_rng(5)
    p = rng.integers(0, 61, size=20).astype(np.int32)

    def tokens_of(blocks, prewarm):
        eng = _eng(model, prefix_cache_blocks=blocks)
        if prewarm:
            eng.submit(p, 2)
            eng.run_until_complete()
        h = eng.submit(p, 8, temperature=0.9, top_k=12, top_p=0.9, seed=7)
        eng.run_until_complete()
        return list(h.tokens)

    cold = tokens_of(0, False)
    assert tokens_of(8, False) == cold and tokens_of(8, True) == cold
    shared = rng.integers(0, 61, size=20).astype(np.int32)
    eng = _eng(model, max_len=64, speculate_k=2, drafter=NgramDrafter())
    for i in range(3):
        q = np.concatenate([shared, rng.integers(0, 61, size=2 + i)
                            .astype(np.int32)])
        h = eng.submit(q, 8)
        eng.run_until_complete()
        assert h.tokens == _ref(model, q, 8)
    assert eng.stats["prefix_hit_tokens"] > 0
    eng.prefix_cache.check()


def test_cancel_close_and_eviction_churn(engine_setup):
    """A request cancelled mid-prefill publishes its prefilled blocks;
    close() publishes nothing; a 2-block budget under churn never serves
    a wrong block."""
    _, _, model = engine_setup
    rng = np.random.default_rng(10)
    p = rng.integers(0, 61, size=24).astype(np.int32)
    eng = _eng(model)
    h = eng.submit(p, 4)
    eng.step()
    eng.step()
    assert h._nfill == 16
    h.cancel()
    assert eng.prefix_cache.used_blocks == 2
    h2 = eng.submit(p, 4)
    eng.run_until_complete()
    assert eng.stats["prefix_hit_tokens"] == 16
    assert h2.tokens == _ref(model, p, 4)
    eng = _eng(model)
    eng.submit(p[:20], 8)
    eng.step()
    eng.close()
    assert eng.prefix_cache.used_blocks == 0
    assert "prefix_published_blocks" not in eng.stats
    eng = _eng(model, num_slots=2, prefix_cache_blocks=2)
    prompts = [rng.integers(0, 61, size=9 + (3 * i) % 12).astype(np.int32)
               for i in range(6)]
    prompts += prompts[:2]
    handles = [eng.submit(q, 4) for q in prompts]
    eng.run_until_complete()
    assert eng.prefix_cache.evictions > 0
    assert eng.prefix_cache.used_blocks <= 2
    for q, hq in zip(prompts, handles):
        assert hq.tokens == _ref(model, q, 4)
    eng.prefix_cache.check()


def test_faults_flush_the_cache_and_keep_parity(engine_setup):
    """A contained step failure flushes the cache (in place) and the
    requeued request is exact; a failed admission copy is contained; a
    failed publish flushes without failing the retirement; a watchdog
    hang surfacing in a publish is contained, not charged to the
    cache."""
    _, _, model = engine_setup
    rng = np.random.default_rng(7)
    shared = rng.integers(0, 61, size=20).astype(np.int32)
    p1, p2 = (np.concatenate([shared, rng.integers(0, 61, size=n)
                              .astype(np.int32)]) for n in (3, 4))
    eng = _eng(model)
    eng.submit(p1, 6)
    eng.run_until_complete()
    hook = FaultySteps(fail_at={eng._device_calls + 4}, kind="decode")
    eng.step_fault_hook = hook
    h2 = eng.submit(p2, 6)
    eng.run_until_complete()
    assert hook.fired and eng.stats["step_failures"] == 1
    assert eng.stats["prefix_flushes"] >= 1
    assert h2.tokens == _ref(model, p2, 6)
    pool = eng.prefix_cache.pool.k
    eng.step_fault_hook = FaultySteps(fail_at=set(range(10_000)),
                                      kind="prefix_in")
    h3 = eng.submit(p1, 6)
    eng.run_until_complete()
    assert h3.finish_reason is FinishReason.COMPLETE
    assert h3.tokens == _ref(model, p1, 6)
    assert eng.prefix_cache.pool.k is pool  # flushed in place
    eng = _eng(model)
    eng.step_fault_hook = FaultySteps(fail_at=set(range(200)),
                                      kind="prefix_out")
    h = eng.submit(p1, 4)
    eng.run_until_complete()
    assert h.ok and eng.stats["prefix_publish_failures"] >= 1
    assert eng.stats["step_failures"] == 0
    assert isinstance(eng.last_step_error, InjectedFault)
    assert eng.prefix_cache.used_blocks == 0
    wd = Watchdog(timeout_s=1000.0, kill=False)
    eng = _eng(model, watchdog=wd, step_timeout_s=1000.0)
    h = eng.submit(p1, 6)
    while not h.tokens:
        eng.step()
    wd._hang_seen.set()
    h.deadline_s = 1e-9
    eng.step()
    assert eng.stats["step_failures"] == 1
    assert "prefix_publish_failures" not in eng.stats
    eng.run_until_complete()
    h2 = eng.submit(p1, 6)
    eng.run_until_complete()
    assert h2.tokens == _ref(model, p1, 6)
