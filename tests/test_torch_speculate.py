"""The port's drafters (``tpudp_torch.serve.speculate``) and acceptance
rules (``tpudp_torch.ops.sampling.verify_tokens`` /
``verify_tree_tokens``) against the JAX package.

Drafters and greedy acceptance are exact: the same proposals, tree
tables, emitted tokens, counts and paths as JAX on numpy-seeded inputs.
Sampled acceptance draws from per-row ``torch.Generator``s instead of JAX
keys, so it is held to its own contract: a chain tree is the sequence
rule draw for draw, rejection sampling preserves the target distribution
(a chi-square test), and a row with no drafts draws what
``sample_tokens`` draws from the same generator state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from tpudp.models.gpt2 import gpt2_small as jax_gpt2_small
from tpudp.ops import sampling as jsampling
from tpudp.serve import speculate as jspec
from tpudp_torch.models import gpt2
from tpudp_torch.ops import sampling
from tpudp_torch.serve import speculate

# d_model 48, not the 32 of tests/test_speculate.py: the JAX drafter's
# program is jitted on the model config, so the same config compiled here
# first would hide the compile that file counts when a worker runs both.
TINY = dict(vocab_size=61, max_seq_len=64, num_layers=2, num_heads=2,
            d_model=48)


def _context(kind: str) -> np.ndarray:
    rng = np.random.default_rng(3)
    if kind == "random":  # few repeats: short or no matches
        return rng.integers(0, 12, size=40).astype(np.int32)
    if kind == "periodic":  # a period-5 loop: full-length matches
        return np.tile(rng.integers(0, 61, size=5), 7)[:33].astype(np.int32)
    if kind == "ambiguous":  # one bigram with several continuations
        return np.array([4, 7, 1, 4, 7, 2, 9, 4, 7, 3, 5, 4, 7], np.int32)
    return np.array([5], np.int32)  # too short to match


CONTEXTS = ["random", "periodic", "ambiguous", "single"]


@pytest.mark.parametrize("ngram", [(3, 1), (3, 2), (1, 1)])
@pytest.mark.parametrize("kind", CONTEXTS)
def test_ngram_drafter_matches_jax(kind, ngram):
    ctx = _context(kind)
    mine = speculate.NgramDrafter(*ngram)
    ref = jspec.NgramDrafter(*ngram)
    for k in (1, 2, 4):
        np.testing.assert_array_equal(mine.propose(ctx, k),
                                      ref.propose(ctx, k))
        got = mine._continuations(ctx, k, 3)
        want = ref._continuations(ctx, k, 3)
        assert [c.tolist() for c in got] == [c.tolist() for c in want]
    for name in speculate.TREE_SHAPES:
        got = mine.propose_tree(ctx, speculate.TREE_SHAPES[name])
        want = ref.propose_tree(ctx, jspec.TREE_SHAPES[name])
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(jspec.TREE_SHAPES))
def test_tree_shapes_match_jax(name):
    mine, ref = speculate.TREE_SHAPES[name], jspec.TREE_SHAPES[name]
    for field in ("parents", "depths", "max_depth", "ancestors", "paths",
                  "num_candidates"):
        assert getattr(mine, field) == getattr(ref, field), field
    assert hash(mine) == hash(speculate.tree_shape(mine.parents))
    assert mine == speculate.tree_shape(name)


@pytest.mark.parametrize("spec", ["nope", (0, 0), (-1, 1), (-1, 0, 2)])
def test_tree_shape_errors_match_jax(spec):
    with pytest.raises(ValueError) as want:
        jspec.tree_shape(spec)
    with pytest.raises(ValueError) as got:
        speculate.tree_shape(spec)
    assert str(got.value) == str(want.value)


def test_ngram_drafter_validation():
    for args in ((3, 0), (1, 2)):
        with pytest.raises(ValueError):
            speculate.NgramDrafter(*args)


@pytest.fixture(scope="module")
def draft_models():
    tree = gpt2.random_params(gpt2.GPT2Config(**TINY), seed=31)
    jmodel = jax_gpt2_small(**TINY)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return (jspec.DraftModelDrafter, jmodel, jparams,
            gpt2.build(gpt2.GPT2Config(**TINY), 31, "cpu"))


@pytest.mark.parametrize("bucket", [None, 24, 64])
def test_draft_model_drafter_matches_jax(draft_models, bucket):
    """Greedy drafts of the same weights: power-of-two buckets, a pinned
    bucket and one clamped to ``max_seq_len - k``; contexts longer than
    the cap keep their tail."""
    jdrafter, jmodel, jparams, tmodel = draft_models
    ref = jdrafter(jmodel, jparams, bucket=bucket)
    mine = speculate.DraftModelDrafter(tmodel, bucket=bucket)
    rng = np.random.default_rng(4)
    for n in (5, 17, 70):
        ctx = rng.integers(0, 61, size=n).astype(np.int32)
        np.testing.assert_array_equal(mine.propose(ctx, 3),
                                      ref.propose(ctx, 3))
    assert mine.propose(ctx, 0).size == 0
    with pytest.raises(ValueError, match="bucket"):
        speculate.DraftModelDrafter(tmodel, bucket=0)


def _window_case(n=6, k=3, v=23, seed=0):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((n, k + 1, v)) * 3).astype(np.float32)
    draft = rng.integers(0, v, size=(n, k)).astype(np.int32)
    draft[0] = logits[0, :k].argmax(-1)          # all accepted
    draft[3, :2] = logits[3, :2].argmax(-1)      # accepted, then rejected
    draft[4, 0] = logits[4, 0].argmax(-1)
    n_draft = np.array([k, k, 0, k, 1, 2], np.int32)[:n]
    return logits, draft, n_draft


def _greedy_params(n):
    return np.zeros(n, np.float32), np.zeros(n, np.int32), np.ones(
        n, np.float32)


def test_verify_tokens_greedy_matches_jax():
    logits, draft, n_draft = _window_case()
    temps, top_k, top_p = _greedy_params(6)
    want_tok, want_n = jsampling.verify_tokens(
        jnp.asarray(logits), jnp.asarray(draft), jnp.asarray(n_draft),
        jnp.asarray(temps), jnp.asarray(top_k), jnp.asarray(top_p),
        jnp.zeros((6, 2), jnp.uint32))
    tok, n_emit = sampling.verify_tokens(
        torch.as_tensor(logits), torch.as_tensor(draft),
        torch.as_tensor(n_draft), temps, top_k, top_p, [None] * 6)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(want_tok))
    np.testing.assert_array_equal(n_emit.numpy(), np.asarray(want_n))
    assert set(n_emit.tolist()) == {1, 2, 3, 4}  # every accept depth


@pytest.mark.parametrize("name", list(jspec.TREE_SHAPES))
def test_verify_tree_tokens_greedy_matches_jax(name):
    """Every registered shape, with candidates planted on the argmax
    along different branches so accepts, sibling rescues and rejects all
    occur."""
    shape = speculate.TREE_SHAPES[name]
    n, t1, v = 6, shape.num_candidates + 1, 19
    rng = np.random.default_rng(sorted(jspec.TREE_SHAPES).index(name))
    logits = (rng.standard_normal((n, t1, v)) * 3).astype(np.float32)
    cand = rng.integers(0, v, size=(n, t1 - 1)).astype(np.int32)
    targets = logits.argmax(-1)
    for row in range(n):
        for j in range(1, t1):
            if rng.random() < 0.6:  # plant the parent's argmax
                cand[row, j - 1] = targets[row, shape.parents[j]]
    n_cand = np.array([t1 - 1] * 5 + [0], np.int32)
    temps, top_k, top_p = _greedy_params(n)
    want = jsampling.verify_tree_tokens(
        jnp.asarray(logits), jnp.asarray(cand), shape.parents,
        jnp.asarray(n_cand), jnp.asarray(temps), jnp.asarray(top_k),
        jnp.asarray(top_p), jnp.zeros((n, 2), jnp.uint32))
    got = sampling.verify_tree_tokens(
        torch.as_tensor(logits), torch.as_tensor(cand), shape.parents,
        n_cand, temps, top_k, top_p, [None] * n)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _gens(seeds):
    return [torch.Generator().manual_seed(int(s)) for s in seeds]


def test_chain_tree_equals_verify_tokens_greedy_and_sampled():
    """On a chain-shaped tree the tree rule is the sequence rule: same
    tokens, counts and generator states after, for greedy, sampled,
    truncated and no-draft rows."""
    logits, draft, n_draft = _window_case()
    temps = np.array([0.0, 0.9, 0.0, 1.2, 0.7, 1.0], np.float32)
    top_k = np.array([0, 5, 0, 0, 8, 0], np.int32)
    top_p = np.array([1.0, 0.9, 1.0, 1.0, 1.0, 0.8], np.float32)
    for seed in range(5):
        seq_gens, tree_gens = _gens(range(seed, seed + 6)), _gens(
            range(seed, seed + 6))
        tok, n_emit = sampling.verify_tokens(
            torch.as_tensor(logits), torch.as_tensor(draft),
            torch.as_tensor(n_draft), temps, top_k, top_p, seq_gens)
        ttok, tn, path = sampling.verify_tree_tokens(
            torch.as_tensor(logits), torch.as_tensor(draft),
            speculate.TREE_SHAPES["chain3"].parents, n_draft, temps, top_k,
            top_p, tree_gens)
        assert tn.tolist() == n_emit.tolist()
        live = torch.arange(4)[None] < n_emit[:, None]
        assert torch.equal(torch.where(live, tok, 0),
                           torch.where(live, ttok, 0))
        assert torch.equal(torch.where(live, path, 0),
                           torch.where(live, torch.arange(4)[None], 0))
        for a, b in zip(seq_gens, tree_gens):
            assert torch.equal(a.get_state(), b.get_state())


def _first_token_counts(rule, n=6000, v=8):
    """The first emitted token over ``n`` rows with independent
    generators, for a fixed target distribution and a draft of a low-
    probability token (the sequence rule) or two wrong siblings (a
    fork tree): rejection must not bend the target distribution."""
    p = np.array([0.03, 0.3, 0.2, 0.15, 0.12, 0.1, 0.06, 0.04])
    logits = np.broadcast_to(np.log(p).astype(np.float32), (n, 3, v))
    temps = np.ones(n, np.float32)
    top_k, top_p = np.zeros(n, np.int32), np.ones(n, np.float32)
    gens = _gens(range(n))
    if rule == "sequence":
        tok, _ = sampling.verify_tokens(
            torch.as_tensor(logits.copy()),
            torch.zeros((n, 2), dtype=torch.int64), np.full(n, 2), temps,
            top_k, top_p, gens)
    else:  # fork3+1-like: children 1 (token 0) and 2 (token 6) of the root
        tok, _, _ = sampling.verify_tree_tokens(
            torch.as_tensor(logits.copy()),
            torch.as_tensor(np.tile([0, 6], (n, 1))), (-1, 0, 0),
            np.full(n, 2), temps, top_k, top_p, gens)
    return np.bincount(tok[:, 0].numpy(), minlength=v), p * n


@pytest.mark.parametrize("rule", ["sequence", "tree"])
def test_rejection_sampling_preserves_the_target(rule):
    counts, expected = _first_token_counts(rule)
    chi2, p_value = stats.chisquare(counts, expected)
    assert p_value > 1e-3, (counts, expected, chi2)


@pytest.mark.parametrize("rule", ["sequence", "tree"])
def test_no_draft_row_draws_as_sample_tokens(rule):
    """A sampled row with no drafts draws the same token as
    ``sample_tokens`` on its slot-0 logits from the same generator state,
    and leaves the generator in the same state."""
    rng = np.random.default_rng(9)
    logits = torch.as_tensor(rng.standard_normal((2, 3, 31)).astype(
        np.float32) * 2)
    temps = np.array([0.8, 1.3], np.float32)
    top_k, top_p = np.array([0, 7], np.int32), np.array([0.9, 1.0],
                                                         np.float32)
    for seed in range(6):
        a, b = _gens([seed, seed + 100]), _gens([seed, seed + 100])
        want = sampling.sample_tokens(logits[:, 0], temps, top_k, top_p, a)
        if rule == "sequence":
            got, n_emit = sampling.verify_tokens(
                logits, torch.zeros((2, 2), dtype=torch.int64),
                np.zeros(2), temps, top_k, top_p, b)
        else:
            got, n_emit, _ = sampling.verify_tree_tokens(
                logits, torch.zeros((2, 2), dtype=torch.int64), (-1, 0, 0),
                np.zeros(2), temps, top_k, top_p, b)
        assert n_emit.tolist() == [1, 1]
        assert got[:, 0].tolist() == want.tolist()
        for x, y in zip(a, b):
            assert torch.equal(x.get_state(), y.get_state())


def test_tree_depths_validation_matches_jax():
    assert sampling.tree_depths((-1, 0, 1, 0, 3)) == \
        jsampling.tree_depths((-1, 0, 1, 0, 3))
    for parents in ((0,), (-1, 1), (-1, 0, 5)):
        with pytest.raises(ValueError) as want:
            jsampling.tree_depths(parents)
        with pytest.raises(ValueError) as got:
            sampling.tree_depths(parents)
        assert str(got.value) == str(want.value)
