"""The port's page allocator and radix index (``tpudp_torch.serve.
prefix_cache``) against the JAX package's on identical operation
sequences: the same page ids, refcounts, lookups, adoptions and
evictions, step by step."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudp.models.gpt2 import GPT2Config as JaxConfig
from tpudp.serve.prefix_cache import PageIndex as JaxIndex
from tpudp.serve.prefix_cache import PagePool as JaxPool
from tpudp_torch.models.gpt2 import GPT2Config
from tpudp_torch.serve.prefix_cache import PageIndex, PagePool

TINY = dict(vocab_size=61, max_seq_len=96, num_layers=2, num_heads=2,
            d_model=32)
PAGE = 4


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
