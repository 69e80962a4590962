"""The port's decode remainder against the JAX package, on the CPU:
``beam_search`` (GPT-2 and LLaMA-GQA, widths 1, 2 and 4, batch 2),
``gpt2_medium``'s configuration, and the engine's
``paged_attn='gather'`` baseline (``scatter_pages``).

Both packages decode from one numpy weight tree (``random_params``
carried across by ``params_from_jax``).  Beam sequences are identical
and scores agree within 2e-5; width 1 is greedy ``generate()``; the
gather engine's greedy tokens equal the einsum engine's and JAX's gather
engine's, with a shared prefix and page-pressure vacates in the traffic.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudp.models.generate import beam_search as jax_beam_search
from tpudp.models.gpt2 import gpt2_medium as jax_gpt2_medium
from tpudp.models.gpt2 import gpt2_small as jax_gpt2_small
from tpudp.models.llama import llama_small as jax_llama_small
from tpudp.serve import Engine as JaxEngine
from tpudp_torch.models import gpt2, llama
from tpudp_torch.models.generate import (KVCache, Int8Pages, beam_search,
                                         gather_pages, generate,
                                         scatter_pages)
from tpudp_torch.serve import Engine

GPT2_TINY = dict(vocab_size=61, max_seq_len=64, num_layers=2, num_heads=2,
                 d_model=32)
LLAMA_GQA = dict(vocab_size=61, max_seq_len=64, num_layers=2, num_heads=4,
                 num_kv_heads=2, d_model=32)
NEW = 6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite's workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(family):
    """(JAX model, JAX params, port model) on one weight tree."""
    if family == "gpt2":
        tree = gpt2.random_params(gpt2.GPT2Config(**GPT2_TINY), seed=41)
        model = gpt2.GPT2(gpt2.GPT2Config(**GPT2_TINY))
        model.load_state_dict(gpt2.params_from_jax(tree))
        jmodel = jax_gpt2_small(**GPT2_TINY)
    else:
        tree = llama.random_params(llama.LlamaConfig(**LLAMA_GQA), seed=42)
        model = llama.Llama(llama.LlamaConfig(**LLAMA_GQA))
        model.load_state_dict(llama.params_from_jax(tree))
        jmodel = jax_llama_small(**LLAMA_GQA)
    return jmodel, jax.tree_util.tree_map(jnp.asarray, tree), model


@pytest.fixture(scope="module", params=["gpt2", "llama_gqa"])
def family(request):
    prompt = np.random.default_rng(43).integers(0, 61, size=(2, 5))
    return (*_pair(request.param), prompt.astype(np.int32))


@pytest.mark.parametrize("width", [1, 2, 4])
def test_beam_search_matches_jax(family, width):
    jmodel, jparams, model, prompt = family
    jseq, jscore = jax_beam_search(jmodel, jparams, jnp.asarray(prompt),
                                   NEW, beam_width=width)
    seq, score = beam_search(model, torch.as_tensor(prompt).long(), NEW,
                             beam_width=width)
    np.testing.assert_array_equal(seq.numpy(), np.asarray(jseq))
    np.testing.assert_allclose(score.numpy(), np.asarray(jscore),
                               rtol=0, atol=2e-5)
    assert seq.dtype == torch.int64 and score.dtype == torch.float32
    if width == 1:
        greedy = generate(model, torch.as_tensor(prompt).long(), NEW)
        np.testing.assert_array_equal(seq.numpy(), greedy.numpy())


def test_beam_score_is_the_sequence_log_probability(family):
    """The best beam's score is the sum of its tokens' log-probabilities
    under one full forward of the returned sequence."""
    _, _, model, prompt = family
    seq, score = beam_search(model, torch.as_tensor(prompt).long(), NEW,
                             beam_width=3)
    with torch.no_grad():
        logp = torch.log_softmax(model(seq).float(), dim=-1)
    n = prompt.shape[1]
    picked = torch.gather(logp[:, n - 1:-1], 2, seq[:, n:, None])[..., 0]
    np.testing.assert_allclose(picked.sum(1).numpy(), score.numpy(),
                               rtol=0, atol=1e-4)


def test_beam_search_validation_matches_jax():
    jmodel, jparams, model = _pair("gpt2")
    prompt = np.zeros((1, 60), np.int32)
    errors = []
    for fn in (lambda: jax_beam_search(jmodel, jparams, jnp.asarray(prompt),
                                       8),
               lambda: beam_search(model, torch.as_tensor(prompt).long(),
                                   8)):
        with pytest.raises(ValueError, match="exceeds max_seq_len") as e:
            fn()
        errors.append(str(e.value))
    for fn in (lambda: jax_beam_search(jmodel, jparams,
                                       jnp.asarray(prompt[:, :4]), 2,
                                       beam_width=0),
               lambda: beam_search(model,
                                   torch.as_tensor(prompt[:, :4]).long(), 2,
                                   beam_width=0)):
        with pytest.raises(ValueError, match="beam_width must be >= 1") as e:
            fn()
        errors.append(str(e.value))
    assert errors[0] == errors[1] and errors[2] == errors[3]
    flash = gpt2.GPT2(gpt2.GPT2Config(**GPT2_TINY, attn_impl="flash"))
    with pytest.raises(ValueError, match="beam_search.. supports dense"):
        beam_search(flash, torch.zeros((1, 4), dtype=torch.long), 2)


def test_gpt2_medium_config_matches_jax():
    want = jax_gpt2_medium().config
    with torch.device("meta"):  # the configuration, no weights allocated
        got = gpt2.gpt2_medium().config
        assert gpt2.gpt2_medium(vocab_size=61).config.vocab_size == 61
    for field in ("vocab_size", "max_seq_len", "num_layers", "num_heads",
                  "d_model", "mlp_ratio", "ln_eps", "attn_impl",
                  "mlp_impl"):
        assert getattr(got, field) == getattr(want, field), field
    assert (got.num_layers, got.d_model, got.num_heads) == (24, 1024, 16)


@pytest.mark.parametrize("int8", [False, True])
def test_scatter_pages_writes_only_the_touched_pages(int8):
    """gather -> write a window into the view -> scatter: the window's
    pages (of an active slot) carry the new rows, every other page and
    the inactive slot's pages are untouched."""
    cfg = gpt2.GPT2Config(**GPT2_TINY)
    gen = torch.Generator().manual_seed(44)
    cls = Int8Pages if int8 else KVCache
    pool = cls.zeros(cfg, 7, 4)
    for buf in pool[:2]:
        buf.copy_(torch.randint(-50, 50, buf.shape, generator=gen)
                  .to(buf.dtype))
    table = torch.tensor([[0, 1, 2], [3, 4, -1]], dtype=torch.int32)
    before = [buf.clone() for buf in pool]
    view = gather_pages(pool, table, torch.float32)
    pos = torch.tensor([3, 2])
    view.k[:, 0, 3:6] = 7.0
    view.k[:, 1, 2:5] = 9.0
    scatter_pages(pool, view, table, pos, 3,
                  torch.tensor([True, False]))
    back = gather_pages(pool, table, torch.float32)
    torch.testing.assert_close(back.k[:, 0, 3:6],
                               torch.full_like(back.k[:, 0, 3:6], 7.0))
    for page in (2, 3, 4, 5):  # slot 0's untouched page, slot 1, spare
        for buf, old in zip(pool, before):
            assert torch.equal(buf[:, page], old[:, page])


@pytest.fixture(scope="module")
def gather_setup():
    jmodel, jparams, model = _pair("gpt2")
    rng = np.random.default_rng(45)
    shared = rng.integers(0, 61, size=16).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, 61, size=3 + 4 * i)
                               .astype(np.int32)]) for i in range(3)]
    prompts.append(rng.integers(0, 61, size=9).astype(np.int32))
    return jmodel, jparams, model, prompts


def _serve(engine, prompts):
    handles = [engine.submit(p, NEW) for p in prompts]
    while engine.queue_depth or engine.slots_in_use:
        engine.step()
        engine.check_paged()
    return [h.tokens for h in handles], engine


@pytest.mark.parametrize("kw", [dict(num_slots=2, kv_pages=12),
                                dict(num_slots=3, kv_pages=6)],
                         ids=["paged", "paged_pressure"])
def test_gather_engine_matches_einsum_and_jax_gather(gather_setup, kw):
    jmodel, jparams, model, prompts = gather_setup
    common = dict(max_len=48, prefill_chunk=8, **kw)
    got, eng = _serve(Engine(model, device="cpu", paged_attn="gather",
                             **common), prompts)
    plain, ref = _serve(Engine(model, device="cpu", paged_attn="einsum",
                               **common), prompts)
    jeng = JaxEngine(jmodel, jparams, paged_attn="gather", **common)
    handles = [jeng.submit(p, NEW) for p in prompts]
    jeng.run_until_complete()
    assert got == plain == [h.tokens for h in handles]
    for key in ("prefix_hit_tokens", "page_pressure_vacates",
                "prefill_chunks", "decode_steps"):
        assert eng.stats[key] == ref.stats[key] == jeng.stats[key], key
    assert eng.metrics()["paged_attn"] == {
        k: v for k, v in jeng.metrics()["paged_attn"].items()}
    assert eng.stats["prefix_hit_tokens"] > 0


def test_gather_needs_pages():
    _, _, model = _pair("gpt2")
    with pytest.raises(ValueError, match="requires kv_pages > 0"):
        Engine(model, device="cpu", paged_attn="gather")
