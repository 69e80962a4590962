"""The port's speculative serving engine (``Engine(speculate_k=...,
speculate_tree=...)``) against the JAX engine, at the tiny geometry of
tests/test_torch_engine.py with the random weights scaled up five-fold,
so greedy outputs mix loops (drafts accepted) with varied stretches
(drafts rejected).

Greedy sequence and tree speculation, in the dense arena, the paged pool
and the paged pool under page pressure, give the JAX engine's tokens and
its verify, draft and accept counters exactly.  Beyond parity: a chain
tree is the sequence engine, rejected tree branches leave the pool's
bytes alone, EOS and budgets cut a window, the submit bound reserves the
window, every validation error, a faulty drafter is quarantined without
changing a token, and sampled requests reproduce themselves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudp.models.gpt2 import gpt2_small as jax_gpt2_small
from tpudp.serve import DraftModelDrafter as JaxDraftModelDrafter
from tpudp.serve import Engine as JaxEngine
from tpudp_torch import serve_cli
from tpudp_torch.models import gpt2
from tpudp_torch.models.generate import generate
from tpudp_torch.serve import DraftModelDrafter, Engine, NgramDrafter

TINY = dict(vocab_size=61, max_seq_len=96, num_layers=2, num_heads=2,
            d_model=32)
NEW = 10
KINDS = {"dense": dict(num_slots=2),
         "paged": dict(num_slots=2, kv_pages=12),
         "paged_pressure": dict(num_slots=3, kv_pages=6)}
MODES = {"sequence": dict(speculate_k=2),
         "chain2": dict(speculate_k=2, speculate_tree="chain2"),
         "fork2x2": dict(speculate_k=2, speculate_tree="fork2x2")}
COUNTERS = ("verify_steps", "tree_verify_steps", "draft_tokens",
            "draft_accepted")


def _tree(seed):
    """Random weights with every matrix scaled five-fold."""
    tree = gpt2.random_params(gpt2.GPT2Config(**TINY), seed=seed)
    return jax.tree_util.tree_map(lambda a: a * 5 if a.ndim == 2 else a,
                                  tree)


def _port_model(tree):
    model = gpt2.GPT2(gpt2.GPT2Config(**TINY))
    model.load_state_dict(gpt2.params_from_jax(tree))
    return model


@pytest.fixture(scope="module")
def setup():
    tree = _tree(21)
    rng = np.random.default_rng(22)
    shared = rng.integers(0, 61, size=16).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, 61, size=3 + 4 * i)
                               .astype(np.int32)]) for i in range(3)]
    prompts.append(rng.integers(0, 61, size=9).astype(np.int32))
    prompts += [np.tile(rng.integers(0, 61, size=4), 6)[:n].astype(np.int32)
                for n in (14, 23)]
    jmodel = jax_gpt2_small(**TINY)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    model = _port_model(tree)
    plain = Engine(model, device="cpu", num_slots=2, max_len=48,
                   prefill_chunk=8)
    reference = [plain.submit(p, NEW) for p in prompts]
    plain.run_until_complete()
    return jmodel, jparams, model, prompts, [h.tokens for h in reference]


def _serve(engine, prompts, new=NEW, **kw):
    handles = [engine.submit(p, new, **kw) for p in prompts]
    while engine.queue_depth or engine.slots_in_use:
        engine.step()
        engine.check_paged()
    return [h.tokens for h in handles]


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("kind", list(KINDS))
def test_greedy_speculation_matches_jax_engine(setup, kind, mode):
    jmodel, jparams, model, prompts, reference = setup
    kw = dict(max_len=48, prefill_chunk=8, **KINDS[kind], **MODES[mode])
    jax_eng = JaxEngine(jmodel, jparams, **kw)
    want = _serve(jax_eng, prompts)
    eng = Engine(model, device="cpu", **kw)
    got = _serve(eng, prompts)
    assert got == want
    assert {c: eng.stats[c] for c in COUNTERS} == {
        c: jax_eng.stats[c] for c in COUNTERS}
    steps = "verify_steps" if mode == "sequence" else "tree_verify_steps"
    assert eng.stats[steps] > 0 and 0 < eng.stats["draft_accepted"] < \
        eng.stats["draft_tokens"]
    if mode != "fork2x2":  # the joint tree softmax may break a near-tie
        assert got == reference
    if kind == "paged_pressure":
        assert eng.stats["page_pressure_vacates"] > 0
    if eng.page_pool is not None:
        assert eng.page_pool.used_pages == eng.page_index.node_count
    assert eng.acceptance_rate == (eng.stats["draft_accepted"]
                                   / eng.stats["draft_tokens"])
    assert eng.metrics()["acceptance_rate"] == eng.acceptance_rate


def test_draft_model_speculation_matches_jax_engine(setup):
    """A draft model (the target's vocabulary, other weights) on both
    sides: equal tokens and counters, and the plain engine's tokens."""
    jmodel, jparams, model, prompts, reference = setup
    dtree = _tree(5)
    kw = dict(max_len=48, prefill_chunk=8, num_slots=2, kv_pages=12,
              speculate_k=3)
    jax_eng = JaxEngine(jmodel, jparams, drafter=JaxDraftModelDrafter(
        jax_gpt2_small(**TINY), jax.tree_util.tree_map(jnp.asarray, dtree)),
        **kw)
    want = _serve(jax_eng, prompts[:4], new=8)
    eng = Engine(model, device="cpu",
                 drafter=DraftModelDrafter(_port_model(dtree)), **kw)
    assert _serve(eng, prompts[:4], new=8) == want
    assert [t[:8] for t in reference[:4]] == want
    assert {c: eng.stats[c] for c in COUNTERS} == {
        c: jax_eng.stats[c] for c in COUNTERS}


@pytest.mark.parametrize("kv_pages", [0, 12])
def test_chain_tree_engine_equals_sequence_engine(setup, kv_pages):
    """``speculate_tree='chain2'`` emits the k = 2 sequence engine's
    greedy and sampled streams with the same acceptance, on periodic
    prompts whose drafts are always full."""
    _, _, model, prompts, _ = setup

    def run(tree):
        eng = Engine(model, device="cpu", num_slots=2, max_len=48,
                     prefill_chunk=8, kv_pages=kv_pages, speculate_k=2,
                     speculate_tree="chain2" if tree else None,
                     drafter=NgramDrafter(max_ngram=3, min_ngram=2))
        hs = [eng.submit(prompts[4], NEW, temperature=0.9, top_k=12, seed=9),
              eng.submit(prompts[5], NEW),
              eng.submit(prompts[4][:10], NEW, temperature=1.3, seed=3)]
        eng.run_until_complete()
        return [(h.tokens, h.draft_accepted) for h in hs]

    assert run(True) == run(False)


class _AllWrongDrafter:
    """Every candidate of fork2x2 wrong, both root children distinct, so
    every tree window rejects every branch."""

    def __init__(self, full, vocab):
        self.full = np.asarray(full)
        self.vocab = vocab

    def propose_tree(self, context, shape):
        n = np.asarray(context).size
        t = [int(self.full[n + d]) for d in range(2)]
        return np.array([(t[0] + 1) % self.vocab, (t[1] + 1) % self.vocab,
                         (t[0] + 2) % self.vocab, (t[1] + 2) % self.vocab],
                        np.int32)


def test_rejected_tree_branches_write_zero_pool_bytes(setup):
    """With every candidate rejected, a paged tree window's only real
    pool write is the bonus token's page; rejected depths go to the
    scratch page, also where they would cross into the next page."""
    _, _, model, prompts, _ = setup
    p = prompts[3]
    full = generate(model, torch.as_tensor(p[None]).long(), 20)[0].numpy()
    eng = Engine(model, device="cpu", num_slots=1, max_len=48,
                 prefill_chunk=8, kv_pages=8, speculate_k=2,
                 speculate_tree="fork2x2", drafter=_AllWrongDrafter(full, 61))
    h = eng.submit(p, 12)
    while not h.tokens:
        eng.step()
    ms = eng._mstates[None]
    pages = ms.pool.pages
    scratch = pages.k.shape[1] - 1
    crossed = False
    while not h.done:
        pos0 = int(eng._len[0])
        own = int(ms.table[0, pos0 // 8])
        nxt = int(ms.table[0, (pos0 + 1) // 8])
        before = (pages.k.clone(), pages.v.clone())
        steps = eng.stats["tree_verify_steps"]
        eng.step()
        if eng.stats["tree_verify_steps"] == steps:
            continue
        changed = {i for i in range(scratch + 1)
                   if not (torch.equal(before[0][:, i], pages.k[:, i])
                           and torch.equal(before[1][:, i], pages.v[:, i]))}
        assert changed <= {own, scratch}, (pos0, own, changed)
        if pos0 % 8 == 7 and nxt not in (-1, own):
            assert nxt not in changed
            crossed = True
    assert crossed
    assert h.draft_accepted == 0
    np.testing.assert_array_equal(full[p.size:p.size + 12], h.tokens)


@pytest.mark.parametrize("mode", ["sequence", "fork2x2"])
def test_eos_mid_window_and_short_budgets(setup, mode):
    """EOS inside an accepted window retires the request there, and a
    budget shorter than the window stops at the budget: the plain
    engine's tokens either way."""
    _, _, model, prompts, reference = setup
    spec = dict(speculate_k=3, speculate_tree=None if mode == "sequence"
                else "fork2x2")
    # Request 4 loops on one token; request 2 varies: EOS on a token
    # that first appears mid-stream.
    eos = reference[2][3]
    for new, eos_id in ((1, None), (2, None), (NEW, eos)):
        plain = Engine(model, device="cpu", num_slots=2, max_len=48,
                       prefill_chunk=8)
        want = _serve(plain, prompts[2:5], new=new, eos_id=eos_id)
        for kv_pages in (0, 12):
            eng = Engine(model, device="cpu", num_slots=2, max_len=48,
                         prefill_chunk=8, kv_pages=kv_pages, **spec)
            assert _serve(eng, prompts[2:5], new=new, eos_id=eos_id) == want
    assert want[0][-1] == eos and len(want[0]) < NEW


def test_submit_reserves_the_window(setup):
    _, _, model, _, _ = setup
    eng = Engine(model, device="cpu", max_len=48, prefill_chunk=8,
                 speculate_k=3)
    prompt = np.zeros(30, np.int32)
    eng.submit(prompt, 15)  # 30 + 15 + 3 == 48
    with pytest.raises(ValueError, match="speculate_k"):
        eng.submit(prompt, 16)


class _NoTree:
    def propose(self, context, k):
        return np.zeros(0, np.int32)


@pytest.mark.parametrize("kw,exc,match", [
    (dict(speculate_k=-1), ValueError, "speculate_k must be >= 0"),
    (dict(drafter=NgramDrafter()), ValueError, "requires speculate_k"),
    (dict(speculate_k=2, drafter="vocab"), ValueError, "vocab_size"),
    (dict(speculate_k=48), ValueError, "must exceed speculate_k"),
    (dict(speculate_tree="fork2x2"), ValueError, "requires speculate_k"),
    (dict(speculate_k=1, speculate_tree="fork2x2"), ValueError,
     "max_depth"),
    (dict(speculate_k=2, speculate_tree="fork2x2", drafter=_NoTree()),
     ValueError, "propose_tree"),
    (dict(speculate_k=2, speculate_tree="nope"), ValueError,
     "unknown tree shape"),
    (dict(speculate_k=2, decode_fuse=4), NotImplementedError, "slice 3"),
    (dict(speculate_k=2, drafter_timeout_s=1.0), NotImplementedError,
     "slice 8"),
])
def test_speculation_validation(setup, kw, exc, match):
    _, _, model, _, _ = setup
    if kw.get("drafter") == "vocab":
        other = gpt2.build(gpt2.GPT2Config(**{**TINY, "vocab_size": 64}), 0,
                           "cpu")
        kw = {**kw, "drafter": DraftModelDrafter(other)}
    with pytest.raises(exc, match=match):
        Engine(model, device="cpu", max_len=48, prefill_chunk=8, **kw)


class _Raises:
    def propose(self, context, k):
        raise RuntimeError("drafter bug")

    def propose_tree(self, context, shape):
        raise RuntimeError("drafter bug")


class _OutOfVocab:
    def propose(self, context, k):
        return np.full(k, 10 ** 6, np.int64)

    def propose_tree(self, context, shape):
        return np.full(shape.num_candidates, 10 ** 6, np.int64)


class _Malformed:
    def propose(self, context, k):
        return np.full(k, 1.5)

    def propose_tree(self, context, shape):
        return np.zeros(shape.num_candidates + 1, np.int32)


@pytest.mark.parametrize("tree", [None, "fork2x2"])
@pytest.mark.parametrize("drafter", [_Raises, _OutOfVocab, _Malformed])
def test_faulty_drafter_is_quarantined(setup, drafter, tree):
    _, _, model, prompts, reference = setup
    eng = Engine(model, device="cpu", num_slots=2, max_len=48,
                 prefill_chunk=8, kv_pages=12, speculate_k=2,
                 speculate_tree=tree, drafter=drafter())
    assert _serve(eng, prompts) == reference
    assert eng.stats["drafter_quarantined"] == 1
    assert eng.drafter_quarantine_reason
    assert eng.stats["verify_steps"] == eng.stats["tree_verify_steps"] == 0
    assert eng.stats["draft_accepted"] == 0
    charged = 0 if drafter is _Raises else 2 + (tree is not None) * (
        3 if drafter is _Malformed else 2)
    assert eng.stats["draft_tokens"] == charged


@pytest.mark.parametrize("tree", [None, "fork2x2"])
def test_sampled_requests_reproduce_beside_others(setup, tree):
    """A seeded sampled request draws only from its slot's generator:
    alone and beside greedy and sampled neighbours (which draft, accept
    and sample on their own schedules), paged or dense, its tokens are
    the same.  (A request vacated under page pressure resumes with a
    plain draw at the end of its re-prefill, where the uninterrupted run
    verified a window: its stream then differs, from the same
    distribution — ROADMAP.md, Queue 3.)"""
    _, _, model, prompts, _ = setup

    def run(others, **kw):
        eng = Engine(model, device="cpu", max_len=48, prefill_chunk=8,
                     speculate_k=2, speculate_tree=tree, **kw)
        hs = [eng.submit(p, NEW, temperature=0.9, seed=5 + i)
              if i % 2 else eng.submit(p, NEW)
              for i, p in enumerate(others)]
        target = eng.submit(prompts[4], NEW, temperature=0.2, top_k=20,
                            top_p=0.95, seed=42)
        eng.run_until_complete()
        assert all(h.ok for h in hs)
        return target.tokens, eng

    alone, eng = run([], num_slots=4, kv_pages=24)
    assert eng.stats["draft_accepted"] > 0
    assert run(prompts[:3], num_slots=4, kv_pages=24)[0] == alone
    assert run(prompts[1:4], num_slots=4)[0] == alone  # dense arena


def test_serve_cli_speculation_rehearsal_on_cpu(capsys):
    m = serve_cli.main(["--device", "cpu", "--layers", "2", "--d-model",
                        "64", "--vocab", "256", "--paged", "64",
                        "--requests", "3", "--max-new-tokens", "6",
                        "--speculate-k", "3", "--speculate-tree",
                        "fork2x2"])
    assert m["stats"]["completed"] == 3
    out = capsys.readouterr().out
    assert "tree verify steps=" in out and "draft acceptance=" in out
