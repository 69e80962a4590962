"""The port's fused speculation (``Engine(speculate_k=k, decode_fuse=N,
drafter=DraftModelDrafter(m))``) against the JAX engine's, at a tiny
geometry (2 layers, d 64, vocab 256; k 2, N 4), with weights carried
over by ``params_from_jax``.

Greedy tokens, ``draft_accepted``, ``fused_spec_windows`` and
``fused_spec_steps`` equal JAX's, on the dense arena and the paged pool
(einsum, and the kernel dispatch's whole-pool calls on their plain
path).  Sampled tokens and acceptance equal the port's host-drafted
referee (``DraftModelDrafter(bucket=max_len)``, ``decode_fuse=1``).
``verify_rows`` is ``verify_tokens`` at full drafts and the on-device
drafts are the host drafter's.  Off the card the window is its plain
version, an eager loop of the iteration the card captures as a CUDA
graph (tests/test_torch_cuda_spec_fused.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudp.serve import DraftModelDrafter as JaxDraftModelDrafter
from tpudp.serve import Engine as JaxEngine
from tpudp.models.gpt2 import gpt2_small as jax_gpt2_small
from tpudp_torch.models import gpt2
from tpudp_torch.models.generate import KVCache, draft_greedy
from tpudp_torch.ops import sampling
from tpudp_torch.serve import (DraftModelDrafter, Engine, FinishReason,
                               NgramDrafter)
from tpudp_torch.serve.faults import FaultySteps

TARGET = dict(vocab_size=256, max_seq_len=64, num_layers=2, num_heads=2,
              d_model=64)
# Smaller in every width, covering max_len + k positions.
DRAFT = dict(vocab_size=256, max_seq_len=64, num_layers=1, num_heads=2,
             d_model=32)
MAX_LEN, K, FUSE = 48, 2, 4
GEOMETRY = dict(num_slots=2, max_len=MAX_LEN, prefill_chunk=8,
                speculate_k=K)
# Enough tokens that a request spans several windows (a self-drafted
# window commits up to FUSE x (K + 1) = 12 tokens).
PARITY_NEW = 30
COUNTERS = ("fused_spec_windows", "fused_spec_steps", "verify_steps",
            "decode_steps", "draft_tokens", "draft_accepted", "tokens",
            "active_slot_steps")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite's workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(cfg, seed, scale=1.0):
    """One weight tree as a JAX (model, params) and a port model."""
    tree = jax.tree_util.tree_map(
        lambda a: a * scale if a.ndim == 2 else a,
        gpt2.random_params(gpt2.GPT2Config(**cfg), seed=seed))
    model = gpt2.GPT2(gpt2.GPT2Config(**cfg))
    model.load_state_dict(gpt2.params_from_jax(tree))
    return (jax_gpt2_small(**cfg),
            jax.tree_util.tree_map(jnp.asarray, tree)), model


@pytest.fixture(scope="module")
def models():
    """The target (matrices scaled 4-fold, so greedy output loops) and
    two drafters: the target itself (drafts mostly accepted) and a small
    model (mostly rejected)."""
    jtarget, target = _pair(TARGET, 41, scale=4.0)
    jdraft, draft = _pair(DRAFT, 42)
    return {"target": (jtarget, target), "self": (jtarget, target),
            "small": (jdraft, draft)}


def _prompts(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=n).astype(np.int32) for n in (5, 11, 3)]


def _port(models, draft="self", fuse=FUSE, bucket=None, **kw):
    _, target = models["target"]
    _, dmodel = models[draft]
    return Engine(target, device="cpu", decode_fuse=fuse,
                  drafter=DraftModelDrafter(dmodel, bucket=bucket),
                  **GEOMETRY, **kw)


def _serve(eng, prompts, new=10, **kw):
    handles = [eng.submit(p, new, seed=5 + i, **kw)
               for i, p in enumerate(prompts)]
    while eng.queue_depth or eng.slots_in_use:
        eng.step()
        eng.check_paged()
    return handles


@pytest.mark.parametrize("seed", range(3))
def test_verify_rows_equals_verify_tokens(seed):
    """At full drafts and the same generator offsets, the graph-safe
    acceptance gives verify_tokens's tokens and leaves each sampled row's
    generator where verify_tokens does; greedy rows take the argmax
    prefix."""
    torch.manual_seed(seed)
    n, k, v = 6, 3, 40
    logits = torch.randn(n, k + 1, v) * 3
    draft = torch.randint(0, v, (n, k))
    draft[:3] = torch.argmax(logits, -1)[:3, :k]  # accepted prefixes
    draft[1, 1] = (draft[1, 1] + 1) % v
    temps = torch.tensor([0.0, 0.9, 0.0, 0.7, 1.2, 0.5])
    top_k = torch.tensor([0, 12, 0, 0, 5, 0])
    top_p = torch.tensor([1.0, 1.0, 1.0, 0.9, 1.0, 0.8])
    gens = [[torch.Generator().manual_seed(10 * seed + i) for i in range(n)]
            for _ in range(2)]
    want, want_n = sampling.verify_tokens(
        logits, draft, torch.full((n,), k), temps.numpy(), top_k.numpy(),
        top_p.numpy(), gens[0])
    got, got_n = sampling.verify_rows(logits, draft, temps, top_k, top_p,
                                      gens[1])
    assert got_n.tolist() == want_n.tolist()
    assert got.tolist() == want.tolist()
    assert got_n[0] == k + 1 and got_n[2] == k + 1  # greedy, all accepted
    for i in range(n):
        if temps[i] > 0:
            assert torch.equal(gens[0][i].get_state(), gens[1][i].get_state())


@pytest.mark.parametrize("chunk", [48, 16, 5])
def test_draft_greedy_equals_host_drafter(models, chunk):
    """The window's static-shape drafts, prefilled in q-chunks, are the
    host DraftModelDrafter(bucket=max_len)'s."""
    _, dmodel = models["small"]
    rng = np.random.default_rng(1)
    width = MAX_LEN if MAX_LEN % chunk == 0 else 45  # 45 = 9 chunks of 5
    hist = np.zeros((3, width), np.int64)
    contexts = []
    for s, n in enumerate((1, 20, width - K)):
        contexts.append(rng.integers(0, 256, size=n))
        hist[s, :n] = contexts[-1]
    cache = KVCache.zeros(dmodel.config, 3, width + K)
    with torch.no_grad():
        drafts = draft_greedy(dmodel, torch.as_tensor(hist), cache,
                              torch.tensor([c.size - 1 for c in contexts]),
                              K, chunk)
    host = DraftModelDrafter(dmodel, bucket=width)
    assert drafts.tolist() == [host.propose(c, K).tolist()
                               for c in contexts]


@pytest.fixture(scope="module")
def jax_runs(models):
    """The JAX fused engine's greedy tokens and counters, dense and paged
    (einsum), self-drafted."""
    (jmodel, jparams), _ = models["target"]
    runs = {}
    for store, kw in (("dense", {}), ("paged", dict(kv_pages=16,
                                                    paged_attn="einsum"))):
        eng = JaxEngine(jmodel, jparams, decode_fuse=FUSE,
                        drafter=JaxDraftModelDrafter(jmodel, jparams),
                        **GEOMETRY, **kw)
        assert eng._spec_fusable
        handles = _serve(eng, _prompts(), new=PARITY_NEW)
        runs[store] = ([h.tokens for h in handles],
                       [h.draft_accepted for h in handles],
                       {c: eng.stats[c] for c in COUNTERS})
    return runs


@pytest.mark.parametrize("store", ["dense", "paged", "kernel"])
def test_greedy_parity_with_jax(models, jax_runs, store):
    """Tokens, per-request acceptance and the window counters equal the
    JAX fused engine's.  ``kernel`` sends the window's verify forward
    through the kernel dispatch (whole-pool calls of K5's wrapper, which
    runs its plain version on CPU tensors)."""
    kw = {} if store == "dense" else dict(kv_pages=16)
    eng = _port(models, **kw)
    assert eng._spec_fusable
    if store == "kernel":
        eng.paged_attn_dispatch["fused_spec_paged"] = "kernel"
    handles = _serve(eng, _prompts(), new=PARITY_NEW)
    tokens, accepted, counters = jax_runs["paged" if kw else "dense"]
    assert [h.tokens for h in handles] == tokens
    assert [h.draft_accepted for h in handles] == accepted
    assert {c: eng.stats[c] for c in COUNTERS} == counters
    assert counters["fused_spec_windows"] > 0 and counters["draft_accepted"]
    assert eng.metrics()["fused_spec_window"] == {
        "decode_fuse": FUSE, "graph": False, "captures": 0, "replays": 0}


@pytest.mark.parametrize("store,draft", [("dense", "small"),
                                         ("paged", "small"),
                                         ("paged", "self")])
def test_sampled_parity_with_host_drafted(models, store, draft):
    """Sampled streams and acceptance equal the host-drafted engine's
    (same drafter, bucket pinned to max_len, decode_fuse=1): the same
    windows, the same draws from each slot's generator — with drafts
    mostly rejected (``small``) and mostly accepted (``self``)."""
    kw = {} if store == "dense" else dict(kv_pages=16)
    runs = []
    for fused in (True, False):
        eng = (_port(models, draft, **kw) if fused else
               _port(models, draft, fuse=1, bucket=MAX_LEN, **kw))
        assert eng._spec_fusable is fused
        handles = _serve(eng, _prompts(1), new=11, temperature=0.9,
                         top_k=12, top_p=0.9)
        runs.append(([h.tokens for h in handles],
                     [(h.draft_proposed, h.draft_accepted)
                      for h in handles]))
        assert eng.stats["fused_spec_windows" if fused
                         else "verify_steps"] > 0
        assert (eng.stats["draft_accepted"] > 0) == (draft == "self")
    assert runs[0] == runs[1]


def test_eligibility_gates(models):
    """Outside the fusable envelope the host-drafted path runs: an
    n-gram drafter, a draft model short of max_len + k, a tree, and
    decode_fuse=1."""
    _, target = models["target"]
    short = gpt2.build(gpt2.GPT2Config(**{**DRAFT, "max_seq_len": 49}), 3,
                       "cpu")
    cases = [dict(drafter=NgramDrafter(), decode_fuse=FUSE),
             dict(drafter=DraftModelDrafter(short), decode_fuse=FUSE),
             dict(drafter=NgramDrafter(), decode_fuse=FUSE,
                  speculate_tree="chain2"),
             dict(drafter=DraftModelDrafter(target), decode_fuse=1)]
    p = _prompts()[0]
    for kw in cases:
        eng = Engine(target, device="cpu", **GEOMETRY, **kw)
        assert not eng._spec_fusable
        h = eng.submit(p, 6)
        eng.run_until_complete()
        assert h.ok and "fused_spec_windows" not in eng.stats
    assert _port(models)._spec_fusable


def test_quarantine_falls_back_to_fused_decode(models):
    """A drafter quarantined mid-stream demotes the engine to plain fused
    decode windows, not single steps; the sampled request continues as
    the same engine quarantined at the same point continues it."""
    p = _prompts()[0]
    runs = []
    for _ in range(2):
        eng = _port(models, "small")
        h = eng.submit(p, 16, temperature=0.9, top_k=10, seed=13)
        eng.step()
        eng.step()
        assert eng.stats["fused_spec_windows"] > 0 and not h.done
        decode_steps = eng.stats["decode_steps"]
        eng._quarantine_drafter("injected: operator quarantine")
        eng.run_until_complete()
        assert h.finish_reason is FinishReason.COMPLETE
        assert eng.stats["fused_windows"] > 0
        assert eng.stats["decode_steps"] == decode_steps
        runs.append(h.tokens)
    assert runs[0] == runs[1]


def _eos_case(models):
    """A prompt and an EOS id that first appears strictly inside a
    self-drafted window run (not at its start)."""
    plain = Engine(models["target"][1], device="cpu", num_slots=1,
                   max_len=MAX_LEN, prefill_chunk=8)
    for seed in range(20):
        p = np.random.default_rng(100 + seed).integers(
            0, 256, size=6).astype(np.int32)
        ref = plain.generate_many([p], 12)[0][6:].tolist()
        for i, t in enumerate(ref):
            if 3 <= i <= 9 and t not in ref[:i]:
                return p, ref, t, i
    pytest.fail("no prompt with a mid-run first EOS candidate")


@pytest.mark.parametrize("store", ["dense", "paged"])
def test_eos_and_budget_mid_window(models, store):
    """EOS cuts a window inside an iteration's k + 1 tokens: the request
    ends at its first EOS, as the plain engine's; a budget that is not a
    multiple of k + 1 ends a window mid-iteration."""
    p, ref, eos, at = _eos_case(models)
    kw = {} if store == "dense" else dict(kv_pages=16)
    eng = _port(models, **kw)
    h_eos = eng.submit(p, 12, eos_id=eos)
    h_budget = eng.submit(p, 7)
    while eng.queue_depth or eng.slots_in_use:
        eng.step()
        eng.check_paged()
    assert h_eos.finish_reason is FinishReason.EOS
    assert h_eos.tokens == ref[:at + 1]
    assert h_budget.finish_reason is FinishReason.COMPLETE
    assert h_budget.tokens == ref[:7]
    assert eng.stats["fused_spec_windows"] > 0


@pytest.mark.parametrize("store", ["dense", "paged"])
def test_step_fault_mid_window_contained(models, store):
    """A fault at the second fused speculation window is contained: the
    KV store is reset in place, the request requeues once with its
    tokens and finishes with the unfaulted run's tokens; a window after
    the containment (the same window object) gives the unfaulted tokens
    too.  (Greedy: a sampled request resumed at a window's edge draws its
    next token from the re-prefill, not from a verify window, so its
    stream is another sample of the same distribution, in JAX too.)"""
    kw = {} if store == "dense" else dict(kv_pages=16)
    p = _prompts()[1]

    def run(hook):
        eng = _port(models, "small", step_fault_hook=hook, **kw)
        h = eng.submit(p, 14)
        eng.run_until_complete()
        window = eng._spec_window
        g = eng.submit(p, 9, seed=6)  # after the containment, same window
        eng.run_until_complete()
        assert eng._spec_window is window
        eng.check_paged()
        return eng, h, g

    clean_eng, clean, clean2 = run(None)
    hook = FaultySteps(fail_at=set(), kind="fused_spec")
    seen = []

    def second_window(kind, index):
        if kind == "fused_spec":
            seen.append(index)
            if len(seen) == 2:
                hook.fail_at.add(index)
        hook(kind, index)

    eng, h, g = run(second_window)
    assert hook.fired and eng.stats["step_failures"] == 1
    assert eng.stats["requeued"] == 1 and eng.stats["errors"] == 0
    assert h.finish_reason is FinishReason.COMPLETE
    assert h.tokens == clean.tokens and g.tokens == clean2.tokens
    assert eng.stats["fused_spec_windows"] > 0


def test_fuse_stream_equals_jax_ring(models):
    """``fused_stream`` holds JAX's ring over fused speculation windows:
    iteration by iteration, window position by position, slot by slot."""
    (jmodel, jparams), _ = models["target"]
    kw = dict(fuse_stream=True, kv_pages=16)
    eng = _port(models, **kw)
    jeng = JaxEngine(jmodel, jparams, decode_fuse=FUSE, paged_attn="einsum",
                     drafter=JaxDraftModelDrafter(jmodel, jparams),
                     **GEOMETRY, **kw)
    for e in (eng, jeng):
        _serve(e, _prompts()[:2], new=14)
    assert eng.stats["fused_spec_windows"] > 0
    assert list(eng.fused_stream) == list(jeng.fused_stream)
    assert len(eng.fused_stream) > FUSE
