"""The port's tenancy (``tpudp_torch.serve.tenancy``, ``Engine(tenants=,
models=)``) against the JAX package, on the CPU.

``TenantScheduler`` admits in JAX's order for the same enqueue, requeue
and pop calls.  A paged engine with co-resident models (two of one KV
geometry sharing a pool, one of another) and a high tier preempting a
low one gives JAX's engine's greedy tokens, preemptions, stats and
tenant counters on the same traffic.  The cases of
``tests/test_tenancy.py`` that hold on the port run against the port's
own ``generate()`` (held to JAX's elsewhere): exact resume after
preemption (greedy and sampled, twice, mid-prefill with the dense prefix
cache, mid-speculation, inside fused decode windows), a preemption storm
with no page leak, per-class shedding, default deadlines, routing and
co-resident validation with JAX's messages, step-fault requeues into the
class queues, drain and close over every class, and ``tenants=None``
keeping the single-queue engine's stats schema.
"""

import collections
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudp.models.gpt2 import gpt2_small as jax_gpt2_small
from tpudp.serve import Engine as JaxEngine
from tpudp.serve import TenantClass as JaxClass
from tpudp.serve import TenantScheduler as JaxScheduler
from tpudp_torch.models import gpt2
from tpudp_torch.models.generate import generate
from tpudp_torch.serve import (Engine, FinishReason, NgramDrafter, QueueFull,
                               TenantClass, TenantScheduler)
from tpudp_torch.serve.engine import _FINISH_COUNTER
from tpudp_torch.serve.faults import FaultySteps, PreemptionStorm

TINY = dict(vocab_size=61, max_seq_len=64, num_layers=2, num_heads=2,
            d_model=32)
SMALL = dict(vocab_size=47, max_seq_len=64, num_layers=1, num_heads=2,
             d_model=24)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite's workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _models(**geometries):
    """name -> (numpy tree, port model) for each ``name=(geometry,
    seed)``."""
    out = {}
    for name, (geom, seed) in geometries.items():
        tree = gpt2.random_params(gpt2.GPT2Config(**geom), seed)
        model = gpt2.GPT2(gpt2.GPT2Config(**geom))
        model.load_state_dict(gpt2.params_from_jax(tree))
        out[name] = (tree, model)
    return out


@pytest.fixture(scope="module")
def models():
    return _models(main=(TINY, 51), twin=(TINY, 53), small=(SMALL, 52))


def _ref(model, prompt, n):
    return generate(model, torch.as_tensor(prompt[None]).long(),
                    n)[0, prompt.size:].tolist()


def _two_tier(model, **kw):
    kw.setdefault("num_slots", 1)
    kw.setdefault("max_len", 32)
    kw.setdefault("prefill_chunk", 8)
    kw.setdefault("tenants", {"low": TenantClass(priority=0),
                              "high": TenantClass(priority=1)})
    return Engine(model, device="cpu", **kw)


# -- the scheduler in isolation, against JAX's -------------------------


class _Queued:
    def __init__(self, tenant, n):
        self.tenant = tenant
        self.n = n


@pytest.mark.parametrize("seed", [0, 1])
def test_scheduler_order_matches_jax(seed):
    """Random enqueue / requeue_front / remove / pop sequences over
    classes of two priorities and unequal weights pop the same requests
    in the same order from both schedulers."""
    rng = np.random.default_rng(seed)
    spec = {"a": dict(weight=3.0), "b": dict(weight=1.0),
            "c": dict(weight=2.0), "hi": dict(priority=1)}
    scheds = (TenantScheduler({k: TenantClass(**v)
                               for k, v in spec.items()}),
              JaxScheduler({k: JaxClass(**v) for k, v in spec.items()}))
    queued = [[], []]
    popped = [[], []]
    for i in range(300):
        op = rng.choice(["enq", "enq", "enq", "pop", "pop", "requeue",
                         "remove"])
        name = rng.choice(list(spec))
        for side, sched in enumerate(scheds):
            if op == "enq":
                r = _Queued(str(name), i)
                sched.enqueue(r)
                queued[side].append(r)
            elif op == "pop":
                r = sched.pop_next()
                popped[side].append(None if r is None else (r.tenant, r.n))
            elif op == "requeue" and popped[side] and popped[side][-1]:
                t, n = popped[side][-1]
                sched.requeue_front(_Queued(t, n))
            elif op == "remove":
                live = [r for r in queued[side]
                        if r in sched._states[r.tenant].queue]
                if live:
                    sched.remove(live[0])
        assert (scheds[0].waiting_by_priority()
                == scheds[1].waiting_by_priority())
        assert scheds[0].depth() == scheds[1].depth()
    assert popped[0] == popped[1]
    assert sum(p is not None for p in popped[0]) > 50


@pytest.mark.parametrize("Class,Sched", [(TenantClass, TenantScheduler),
                                         (JaxClass, JaxScheduler)],
                         ids=["port", "jax"])
def test_stride_shares_tiers_readmits_and_idle_credit(Class, Sched):
    """JAX's four scheduler cases, on both packages: 3:1 weights split
    40 picks 30/10 and priority dominates; virtual time is per tier; a
    resume pops free; an idle class banks no credit."""
    sched = Sched({"a": Class(weight=3.0), "b": Class(weight=1.0)})
    for _ in range(40):
        sched.enqueue(_Queued("a", 0))
        sched.enqueue(_Queued("b", 0))
    picks = [sched.pop_next().tenant for _ in range(40)]
    assert picks.count("a") == 30 and picks.count("b") == 10
    sched = Sched({"hi": Class(priority=1), "a": Class(weight=3.0),
                   "b": Class(weight=1.0)})
    for _ in range(50):
        sched.enqueue(_Queued("b", 0))
    for _ in range(100):
        sched.enqueue(_Queued("hi", 0))
    assert all(sched.pop_next().tenant == "hi" for _ in range(100))
    for _ in range(60):
        sched.enqueue(_Queued("a", 0))
    picks = [sched.pop_next().tenant for _ in range(40)]
    assert picks.count("a") == 30 and picks.count("b") == 10
    sched = Sched({"a": Class(), "b": Class()})
    first = _Queued("a", 0)
    sched.enqueue(first)
    assert sched.pop_next() is first
    sched.requeue_front(first)
    assert sched.pop_next() is first
    for _ in range(8):
        sched.enqueue(_Queued("a", 0))
        sched.enqueue(_Queued("b", 0))
    picks = [sched.pop_next().tenant for _ in range(16)]
    assert picks.count("a") == 8 and sched.pop_next() is None
    sched = Sched({"a": Class(), "b": Class()})
    for _ in range(20):
        sched.enqueue(_Queued("a", 0))
    for _ in range(10):
        sched.pop_next()
    for _ in range(20):
        sched.enqueue(_Queued("b", 0))
    assert [sched.pop_next().tenant for _ in range(10)].count("b") <= 6


# -- the engine against JAX's tenant engine ----------------------------


def _tier_traffic(eng, prompts):
    """Low-tier requests on all three models, three steps, then two
    high-tier requests that preempt; every step checks the pages."""
    low = [("default", prompts[0], 8), ("cheap", prompts[1], 6),
           ("twin", prompts[2], 7), ("default", prompts[3], 5)]
    handles = [eng.submit(p, n, tenant=t) for t, p, n in low]
    for _ in range(3):
        eng.step()
        if isinstance(eng, Engine):
            eng.check_paged()
    handles += [eng.submit(p, 4, tenant="high") for p in prompts[4:6]]
    while eng.queue_depth or eng.slots_in_use:
        eng.step()
        if isinstance(eng, Engine):
            eng.check_paged()
    return handles


TENANTS = {"default": dict(), "cheap": dict(model="small", weight=2.0),
           "twin": dict(model="twin"), "high": dict(priority=1)}


@pytest.fixture(scope="module")
def tier_prompts():
    rng = np.random.default_rng(54)
    prompts = [rng.integers(0, 61, size=n).astype(np.int32)
               for n in (11, 9, 6, 14, 5, 7)]
    prompts[1] %= 47  # the small model's vocabulary
    return prompts


@pytest.fixture(scope="module")
def jax_tiers(models, tier_prompts):
    jmods = {name: (jax_gpt2_small(**geom),
                    jax.tree_util.tree_map(jnp.asarray, models[name][0]))
             for name, geom in (("main", TINY), ("twin", TINY),
                                ("small", SMALL))}
    eng = JaxEngine(*jmods["main"], num_slots=2, max_len=32,
                    prefill_chunk=8, kv_pages=16,
                    tenants={k: JaxClass(**v) for k, v in TENANTS.items()},
                    models={"small": jmods["small"], "twin": jmods["twin"]})
    return eng, _tier_traffic(eng, tier_prompts)


@pytest.mark.parametrize("fuse", [1, 4])
def test_tenant_engine_matches_jax(models, tier_prompts, jax_tiers, fuse):
    jeng, jhandles = jax_tiers
    eng = Engine(models["main"][1], device="cpu", num_slots=2, max_len=32,
                 prefill_chunk=8, kv_pages=16, decode_fuse=fuse,
                 tenants={k: TenantClass(**v) for k, v in TENANTS.items()},
                 models={"small": models["small"][1],
                         "twin": models["twin"][1]})
    handles = _tier_traffic(eng, tier_prompts)
    assert [h.tokens for h in handles] == [h.tokens for h in jhandles]
    assert [h.preemptions for h in handles] == \
        [h.preemptions for h in jhandles]
    assert eng.stats["preempted"] > 0
    assert all(h.finish_reason is FinishReason.COMPLETE for h in handles)
    # Two KV geometries: the twin shares the default model's pool.
    ms = eng._mstates
    assert ms["twin"].pool is ms[None].pool is eng.page_pool
    assert ms["small"].pool is not ms[None].pool
    assert [p["num_pages"] for p in eng.metrics()["page_pools"]] == [8, 8]
    assert ms["twin"].index is not ms[None].index
    for pool in eng._pools():
        assert pool.used_pages == sum(len(m.index._by_block)
                                      for m in ms.values()
                                      if m.pool is pool)
    if fuse == 1:
        assert eng.tenant_stats == jeng.tenant_stats
        assert eng.metrics()["tenants"] == jeng.metrics()["tenants"]
        assert dict(eng.stats) == dict(jeng.stats)
    else:
        assert eng.stats["fused_windows"] > 0
        assert eng.metrics()["fused_window"]["captures"] == 0  # CPU: eager
        windows = [m.window for m in ms.values() if m.window is not None]
        assert windows and len({id(w) for w in windows}) == len(windows)


# -- preemption: exact resume ------------------------------------------


def test_preemption_resumes_bit_identically(models):
    model = models["main"][1]
    rng = np.random.default_rng(0)
    p_lo = rng.integers(0, 61, size=4).astype(np.int32)
    p_hi = rng.integers(0, 61, size=5).astype(np.int32)
    eng = _two_tier(model)
    h_lo = eng.submit(p_lo, 10, tenant="low")
    for _ in range(3):
        eng.step()
    assert h_lo.tokens and not h_lo.done
    h_hi = eng.submit(p_hi, 4, tenant="high")
    eng.step()
    assert h_lo.preemptions == 1 and h_lo._slot is None
    assert not h_lo.done and h_lo.finish_reason is None
    eng.run_until_complete()
    assert h_hi.token_times[-1] < h_lo.token_times[-1]
    assert h_hi.tokens == _ref(model, p_hi, 4)
    assert h_lo.tokens == _ref(model, p_lo, 10)
    st = eng.tenant_stats["low"]
    assert (st["preempted"], st["admitted"], st["readmitted"]) == (1, 1, 1)
    assert eng.slots_in_use == 0 and eng.queue_depth == 0


@pytest.mark.parametrize("fuse", [1, 4])
def test_preempted_sampled_request_keeps_its_generator(models, fuse):
    """The eviction carries the slot's generator state, so a sampled
    request draws the same tokens with and without a preemption — inside
    fused windows too (preemption happens between windows)."""
    model = models["main"][1]
    p = np.random.default_rng(1).integers(0, 61, size=5).astype(np.int32)

    def tokens_of(preempt):
        eng = _two_tier(model, decode_fuse=fuse)
        h = eng.submit(p, 24, temperature=0.9, top_k=12, seed=7,
                       tenant="low")
        for _ in range(3):
            eng.step()
        if preempt:
            eng.submit(p, 2, tenant="high")
        eng.run_until_complete()
        assert h.preemptions == (1 if preempt else 0)
        assert eng.stats["fused_windows"] > 0 or fuse == 1
        return list(h.tokens)

    assert tokens_of(True) == tokens_of(False)


def test_double_preemption_and_cancel(models):
    """One request preempted twice resumes exactly and never spends the
    step-failure requeue; a request cancelled while requeued after a
    preemption retires CANCELLED out of its class queue."""
    model = models["main"][1]
    p = np.random.default_rng(2).integers(0, 61, size=4).astype(np.int32)
    eng = _two_tier(model)
    h = eng.submit(p, 12, tenant="low")
    for _ in range(3):
        eng.step()
    eng.submit(p, 2, tenant="high")
    eng.step()
    while h._slot is None or h._nfill < h._fill.size:
        eng.step()
    eng.submit(p, 2, tenant="high")
    eng.step()
    assert h.preemptions == 2 and not h._requeued
    eng.run_until_complete()
    assert h.tokens == _ref(model, p, 12)
    eng2 = _two_tier(model)
    h2 = eng2.submit(p, 10, tenant="low")
    for _ in range(3):
        eng2.step()
    hi = eng2.submit(p, 3, tenant="high")
    eng2.step()
    assert h2.preemptions == 1 and h2.cancel()
    assert h2.finish_reason is FinishReason.CANCELLED and h2.tokens
    eng2.run_until_complete()
    assert hi.tokens == _ref(model, p, 3)
    assert eng2.queue_depth == 0 and eng2.slots_in_use == 0


def test_preempt_mid_prefill_with_prefix_cache(models):
    """Evicting a request mid-prefill publishes only its chunk-prefilled
    blocks, leaves no pin behind, and its resume copies them back."""
    model = models["main"][1]
    rng = np.random.default_rng(4)
    p_long = rng.integers(0, 61, size=20).astype(np.int32)
    p_hi = rng.integers(0, 61, size=4).astype(np.int32)
    eng = _two_tier(model, max_len=48, prefix_cache_blocks=8)
    h = eng.submit(p_long, 5, tenant="low")
    eng.step()
    assert 0 < h._nfill < h._fill.size
    hi = eng.submit(p_hi, 3, tenant="high")
    eng.step()
    assert h.preemptions == 1
    eng.prefix_cache.check()
    eng.run_until_complete()
    assert eng.stats["prefix_hit_tokens"] > 0
    assert hi.tokens == _ref(model, p_hi, 3)
    assert h.tokens == _ref(model, p_long, 5)
    eng.prefix_cache.check()


def test_preempt_speculating_slot(models):
    model = models["main"][1]
    rng = np.random.default_rng(5)
    p = np.tile(rng.integers(0, 61, size=3), 5)[:12].astype(np.int32)
    p_hi = rng.integers(0, 61, size=4).astype(np.int32)
    eng = _two_tier(model, speculate_k=2,
                    drafter=NgramDrafter(max_ngram=3, min_ngram=2))
    h = eng.submit(p, 10, tenant="low")
    while len(h.tokens) < 3:
        eng.step()
    hi = eng.submit(p_hi, 3, tenant="high")
    eng.step()
    assert h.preemptions == 1
    eng.run_until_complete()
    assert h.tokens == _ref(model, p, 10)
    assert hi.tokens == _ref(model, p_hi, 3)


@pytest.mark.parametrize("fuse", [1, 4])
def test_preemption_storm_no_leak_and_parity(models, fuse):
    """Repeated high-priority bursts into a paged engine whose pool two
    models share: nothing wedges, no page or pin leaks (``check_paged``
    after every step; at the end only index pages remain), and every
    request of either model equals its model's ``generate()``."""
    model, twin = models["main"][1], models["twin"][1]
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 61, size=4 + (i % 3)).astype(np.int32)
               for i in range(6)]
    storm_prompts = [rng.integers(0, 61, size=4).astype(np.int32)
                     for _ in range(4)]
    eng = Engine(model, device="cpu", num_slots=2, max_len=32,
                 prefill_chunk=8, kv_pages=8, decode_fuse=fuse,
                 tenants={"low": TenantClass(queue_limit=8),
                          "twin": TenantClass(model="twin"),
                          "high": TenantClass(priority=1)},
                 models={"twin": twin})
    storm = PreemptionStorm("high", storm_prompts, at_steps=[2, 5, 8, 11],
                            max_new=2, seed=99)
    handles = [eng.submit(p, 6, tenant="low" if i % 2 else "twin")
               for i, p in enumerate(prompts)]
    steps = 0
    while (eng.queue_depth or eng.slots_in_use or not storm.done) \
            and steps < 400:
        eng.step()
        eng.check_paged()
        storm.tick(eng, steps)
        steps += 1
    assert steps < 400 and eng.stats["preempted"] >= 1
    assert eng.slots_in_use == 0 and eng.queue_depth == 0
    ms = eng._mstates
    assert eng.page_pool.used_pages == (len(ms[None].index._by_block)
                                        + len(ms["twin"].index._by_block))
    for i, (p, h) in enumerate(zip(prompts, handles)):
        assert h.tokens == _ref(twin if i % 2 == 0 else model, p, 6)
    assert storm.submitted == 4
    for h in storm.handles:
        assert h.finish_reason is FinishReason.COMPLETE
        assert h.tokens == _ref(model, h.prompt, 2)


# -- per-class bounds, deadlines, routing ------------------------------


def test_per_tenant_queue_limit_and_default_deadline(models):
    model = models["main"][1]
    p = np.random.default_rng(8).integers(0, 61, size=4).astype(np.int32)
    eng = Engine(model, device="cpu", num_slots=1, max_len=32,
                 prefill_chunk=8, tenants={"a": TenantClass(queue_limit=2),
                                           "b": TenantClass(queue_limit=2)})
    eng.submit(p, 2, tenant="a")
    eng.step()
    ha = [eng.submit(p, 2, tenant="a") for _ in range(2)]
    with pytest.raises(QueueFull, match="tenant 'a'"):
        eng.submit(p, 2, tenant="a")
    hb = eng.submit(p, 2, tenant="b")
    assert eng.stats["shed"] == 1
    assert (eng.tenant_stats["a"]["shed"], eng.tenant_stats["b"]["shed"]) \
        == (1, 0)
    eng.run_until_complete()
    assert all(h.finish_reason is FinishReason.COMPLETE for h in ha + [hb])
    total = Engine(model, device="cpu", num_slots=1, max_len=32,
                   prefill_chunk=8, queue_limit=1,
                   tenants={"a": TenantClass(), "b": TenantClass()})
    total.submit(p, 2, tenant="a")
    with pytest.raises(QueueFull, match="queue_limit"):
        total.submit(p, 2, tenant="b")  # the engine's limit is the total
    eng = Engine(model, device="cpu", num_slots=1, max_len=32,
                 prefill_chunk=8,
                 tenants={"slo": TenantClass(default_deadline_s=1e-6),
                          "free": TenantClass()})
    h = eng.submit(p, 4, tenant="slo")
    h2 = eng.submit(p, 4, tenant="slo", deadline_s=60.0)
    assert (h.deadline_s, h2.deadline_s) == (1e-6, 60.0)
    time.sleep(0.002)
    eng.run_until_complete()
    assert h.finish_reason is FinishReason.DEADLINE
    assert h2.finish_reason is FinishReason.COMPLETE
    assert eng.tenant_stats["slo"]["deadline_expired"] == 1


def _error(fn) -> str:
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_routing_and_co_resident_validation_match_jax(models):
    """Each refusal raises ``ValueError`` with JAX's message."""
    tree, model = models["main"]
    jmodel = jax_gpt2_small(**TINY)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    short = dict(TINY, max_seq_len=16)
    stree, smodel = _models(s=(short, 55))["s"]
    jshort = (jax_gpt2_small(**short),
              jax.tree_util.tree_map(jnp.asarray, stree))
    kw = dict(num_slots=1, max_len=32, prefill_chunk=8)
    cases = [
        (dict(models={"m": model}), dict(models={"m": (jmodel, jparams)})),
        (dict(tenants={"t": TenantClass(model="nope")}),
         dict(tenants={"t": JaxClass(model="nope")})),
        (dict(tenants={}), dict(tenants={})),
        (dict(tenants={"t": TenantClass(model="s")}, models={"s": smodel}),
         dict(tenants={"t": JaxClass(model="s")}, models={"s": jshort})),
        (dict(kv_pages=4, prefix_cache_blocks=4),
         dict(kv_pages=4, prefix_cache_blocks=4)),
        (dict(kv_pages=6, tenants={"t": TenantClass(model="s")},
              models={"s": models["small"][1]}),
         dict(kv_pages=6, tenants={"t": JaxClass(model="s")},
              models={"s": (jax_gpt2_small(**SMALL), jax.tree_util.tree_map(
                  jnp.asarray, models["small"][0]))})),
    ]
    for port_kw, jax_kw in cases:
        got = _error(lambda: Engine(model, device="cpu", **kw, **port_kw))
        want = _error(lambda: JaxEngine(jmodel, jparams, **kw, **jax_kw))
        assert got == want
    eng = Engine(model, device="cpu", **kw, tenants={"only": TenantClass()})
    jeng = JaxEngine(jmodel, jparams, **kw, tenants={"only": JaxClass()})
    p = np.zeros(4, np.int32)
    for call in (dict(tenant="other"), dict()):
        assert _error(lambda: eng.submit(p, 2, **call)) == \
            _error(lambda: jeng.submit(p, 2, **call))
    assert _error(lambda: Engine(model, device="cpu", **kw).submit(
        p, 2, tenant="x")) == _error(lambda: JaxEngine(
            jmodel, jparams, **kw).submit(p, 2, tenant="x"))
    for bad in (dict(weight=0.0), dict(queue_limit=0),
                dict(default_deadline_s=-1.0)):
        assert _error(lambda: TenantClass(**bad)) == \
            _error(lambda: JaxClass(**bad))
    with pytest.raises(ValueError, match="tpudp_torch model"):
        Engine(model, device="cpu", **kw, tenants={"t": TenantClass()},
               models={"m": (model, None)})
    eng = Engine(model, device="cpu", **kw,
                 tenants={"default": TenantClass(),
                          "cheap": TenantClass(model="small")},
                 models={"small": models["small"][1]})
    with pytest.raises(ValueError, match="prompt ids"):
        eng.submit(np.asarray([50], np.int32), 2, tenant="cheap")
    eng.submit(np.asarray([50], np.int32), 2)  # in the default's vocab


def test_co_resident_sampled_streams_independent(models):
    model, small = models["main"][1], models["small"][1]
    rng = np.random.default_rng(11)
    p = rng.integers(0, 61, size=5).astype(np.int32)

    def tokens_of(crowded):
        eng = Engine(model, device="cpu", num_slots=3, max_len=32,
                     prefill_chunk=8,
                     tenants={"default": TenantClass(),
                              "cheap": TenantClass(model="small")},
                     models={"small": small})
        if crowded:
            eng.submit(rng.integers(0, 47, size=6).astype(np.int32), 8,
                       temperature=1.1, seed=5, tenant="cheap")
        h = eng.submit(p, 8, temperature=0.9, top_k=12, seed=7)
        eng.run_until_complete()
        return list(h.tokens)

    assert tokens_of(True) == tokens_of(False)


# -- containment, drain and close across classes -----------------------


def test_step_fault_requeues_into_tenant_queues(models):
    model = models["main"][1]
    rng = np.random.default_rng(12)
    pa = rng.integers(0, 61, size=5).astype(np.int32)
    pb = rng.integers(0, 61, size=9).astype(np.int32)
    hook = FaultySteps(fail_at={6})
    eng = Engine(model, device="cpu", num_slots=2, max_len=32,
                 prefill_chunk=8, step_fault_hook=hook,
                 tenants={"a": TenantClass(), "b": TenantClass()})
    ha = eng.submit(pa, 6, tenant="a")
    hb = eng.submit(pb, 5, tenant="b")
    eng.run_until_complete()
    assert hook.fired and eng.stats["step_failures"] == 1
    assert eng.stats["requeued"] >= 1 and eng.stats["errors"] == 0
    assert ha.tokens == _ref(model, pa, 6)
    assert hb.tokens == _ref(model, pb, 5)
    assert sum(eng.tenant_stats[t]["readmitted"] for t in "ab") >= 1


def test_drain_and_close_walk_every_tenant_queue(models):
    model = models["main"][1]
    p = np.random.default_rng(13).integers(0, 61, size=4).astype(np.int32)
    tenants = {"a": TenantClass(), "b": TenantClass(),
               "hi": TenantClass(priority=1)}
    eng = Engine(model, device="cpu", num_slots=1, max_len=32,
                 prefill_chunk=8, tenants=dict(tenants))
    handles = ([eng.submit(p, 3, tenant="a") for _ in range(2)]
               + [eng.submit(p, 3, tenant=t) for t in ("b", "hi")])
    eng.step()
    eng.drain()
    assert eng.closed
    ref = _ref(model, p, 3)
    assert all(h.ok and h.tokens == ref for h in handles)
    eng = Engine(model, device="cpu", num_slots=1, max_len=32,
                 prefill_chunk=8, tenants=dict(tenants))
    h_run = eng.submit(p, 10, tenant="a")
    while not h_run.tokens:
        eng.step()
    queued = ([eng.submit(p, 3, tenant="a")]
              + [eng.submit(p, 3, tenant="b") for _ in range(2)]
              + [eng.submit(p, 3, tenant="hi")])
    eng.close()
    assert h_run.finish_reason is FinishReason.CANCELLED and h_run.tokens
    assert all(h.finish_reason is FinishReason.SHED for h in queued)
    assert eng.queue_depth == 0 and eng.slots_in_use == 0
    assert (eng.stats["shed"], eng.tenant_stats["b"]["shed"],
            eng.tenant_stats["hi"]["shed"]) == (4, 2, 1)


# -- tenancy off --------------------------------------------------------

BASE_STATS = {"submitted", "admitted", "steps", "prefill_chunks",
              "decode_steps", "active_slot_steps", "tokens", "completed",
              "cancelled", "deadline_expired", "shed", "step_failures",
              "requeued", "errors"}
PREFIX_STATS = {"prefix_lookups", "prefix_hit_tokens",
                "prefix_published_blocks"}


def test_stats_schema_pinned_with_tenancy_off(models):
    """``tenants=None``: the engine's stats keys are JAX's pinned schema
    for a workload through every counter-producing path, no tenancy key
    appears, and the handles carry no tenant."""
    model = models["main"][1]
    rng = np.random.default_rng(15)
    p = rng.integers(0, 61, size=4).astype(np.int32)
    eng = Engine(model, device="cpu", num_slots=1, max_len=32,
                 prefill_chunk=8, queue_limit=2)
    eng.submit(p, 2)
    eng.submit(p, 2)
    with pytest.raises(QueueFull):
        eng.submit(p, 2)
    eng.step()
    eng.submit(p, 2).cancel()
    h_dead = eng.submit(p, 2, ttft_deadline_s=1e-7)
    time.sleep(0.001)
    eng.run_until_complete()
    assert h_dead.finish_reason is FinishReason.DEADLINE
    eng.step_fault_hook = FaultySteps(fail_at=set(range(200)),
                                      kind="decode")
    h_err = eng.submit(p, 3)
    eng.run_until_complete()
    assert h_err.finish_reason is FinishReason.ERROR
    assert set(eng.stats) == BASE_STATS
    assert eng.tenant_stats == {} and eng._sched is None
    assert h_err.tenant is None and h_err.preemptions == 0
    assert "tenants" not in eng.metrics()
    pref = Engine(model, device="cpu", num_slots=1, max_len=32,
                  prefill_chunk=8, prefix_cache_blocks=4)
    pref.generate_many([rng.integers(0, 61, size=9).astype(np.int32)], 2)
    assert set(pref.stats) == (BASE_STATS - {
        "cancelled", "deadline_expired", "shed", "step_failures",
        "requeued", "errors"}) | PREFIX_STATS
    assert set(_FINISH_COUNTER) == set(FinishReason)
    counts = collections.Counter(_FINISH_COUNTER.values())
    assert counts["completed"] == 2 and max(counts.values()) == 2


def test_serve_cli_tenants_and_prefix_cache(capsys):
    """``serve_cli --tenants``: the first listed class is the highest
    priority and preempts the lower tier, which submits first; the
    example's parsing errors; ``--prefix-cache-blocks`` on the dense
    arena."""
    from tpudp_torch import serve_cli

    base = ["--device", "cpu", "--layers", "1", "--d-model", "32",
            "--vocab", "61", "--max-new-tokens", "6", "--num-slots", "2"]
    m = serve_cli.main(base + ["--paged", "16", "--tenants", "high:1,low:3"])
    assert m["tenants"]["low"]["submitted"] == 3
    assert m["tenants"]["high"]["completed"] == 1
    assert m["tenants"]["low"]["preempted"] >= 1
    out = capsys.readouterr().out
    assert "tenant=high" in out and "preempted x1" in out
    assert "[serve] tenant low: submitted=3 preempted=" in out
    for bad, message in (("high", "wants name:count pairs"),
                         ("high:0", "bad --tenants entry"),
                         ("a:1,a:2", "duplicate tenant name")):
        with pytest.raises(SystemExit, match=message):
            serve_cli.parse_args(base + ["--tenants", bad])
    m = serve_cli.main(base + ["--prefix-cache-blocks", "8",
                               "--requests", "2"])
    assert m["stats"]["prefix_lookups"] == 2
    assert "prefix hit tokens=" in capsys.readouterr().out


def test_fused_window_fault_resets_the_shared_pool_in_place(models):
    """A step fault inside a fused window of one co-resident model:
    containment resets the pool the two models share once, in place
    (the buffers the windows' graphs hold keep their addresses), clears
    both indexes and tables, and every request of both models resumes
    exactly."""
    model, twin = models["main"][1], models["twin"][1]
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, 61, size=n).astype(np.int32)
               for n in (6, 9, 5, 11)]
    hook = FaultySteps(fail_at=set(range(1000)), kind="fused_decode")
    eng = Engine(model, device="cpu", num_slots=4, max_len=32,
                 prefill_chunk=8, kv_pages=16, decode_fuse=4,
                 step_fault_hook=hook,
                 tenants={"default": TenantClass(),
                          "twin": TenantClass(model="twin")},
                 models={"twin": twin})
    buffers = [buf.data_ptr() for buf in eng.page_pool.pages]
    handles = [eng.submit(p, 10, tenant="twin" if i % 2 else "default")
               for i, p in enumerate(prompts)]
    while not hook.fired:
        eng.step()
    hook.fail_at = set()
    eng.run_until_complete()
    eng.check_paged()
    assert eng.stats["step_failures"] == 1 and eng.stats["errors"] == 0
    assert eng.stats["prefix_flushes"] == 2  # one per model's index
    assert [buf.data_ptr() for buf in eng.page_pool.pages] == buffers
    for i, (p, h) in enumerate(zip(prompts, handles)):
        assert h.tokens == _ref(twin if i % 2 else model, p, 10)
