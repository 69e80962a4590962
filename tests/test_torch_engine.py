"""The port's serving engine (``tpudp_torch.serve.Engine``) against the
JAX package, at the tiny geometry of tests/test_paged_kernel.py.

Greedy outputs of the port's paged and dense engines equal JAX
``generate()`` and JAX ``Engine(kv_pages=12)`` token for token, with a
shared-prefix admission (a table write) and page-pressure vacates in the
traffic.  Over an int8 pool (``kv_dtype="int8"``) the port's GPT-2 and
LLaMA-GQA engines give the JAX int8 engine's greedy tokens, plain and
speculative (sequence and tree), with the fp pool's block tables and
JAX's dispatch table.  Sampled requests reproduce themselves alone or
beside others, vacated or not.  Off the card, nothing falls back
silently: the default device is the card, and the kernels need one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudp.models.generate import generate as jax_generate
from tpudp.models.gpt2 import gpt2_small as jax_gpt2_small
from tpudp.models.llama import llama_small as jax_llama_small
from tpudp.serve import Engine as JaxEngine
from tpudp_torch import serve_cli
from tpudp_torch.models import gpt2, llama
from tpudp_torch.serve import Engine, EngineClosed, QueueFull
from tpudp_torch.serve.engine import PAGED_FAMILIES, paged_dispatch
from tpudp_torch.serve.tenancy import TenantClass

TINY = dict(vocab_size=61, max_seq_len=96, num_layers=2, num_heads=2,
            d_model=32)
LLAMA_GQA = dict(vocab_size=61, max_seq_len=96, num_layers=2, num_heads=4,
                 num_kv_heads=2, d_model=32)
NEW = 6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite's workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    tree = gpt2.random_params(gpt2.GPT2Config(**TINY), seed=21)
    rng = np.random.default_rng(22)
    shared = rng.integers(0, 61, size=16).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, 61, size=3 + 4 * i)
                               .astype(np.int32)]) for i in range(3)]
    prompts.append(rng.integers(0, 61, size=9).astype(np.int32))
    jmodel = jax_gpt2_small(**TINY)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    reference = [np.asarray(jax_generate(jmodel, jparams,
                                         jnp.asarray(p[None]), NEW))
                 [0, p.size:].tolist() for p in prompts]
    model = gpt2.build(gpt2.GPT2Config(**TINY), 21, "cpu")
    return jmodel, jparams, model, prompts, reference


def _serve(engine, prompts, **kw):
    handles = [engine.submit(p, NEW, **kw) for p in prompts]
    while engine.queue_depth or engine.slots_in_use:
        engine.step()
        engine.check_paged()
    return [h.tokens for h in handles]


def test_jax_engine_matches_jax_generate(setup):
    jmodel, jparams, _, prompts, reference = setup
    eng = JaxEngine(jmodel, jparams, num_slots=2, max_len=48,
                    prefill_chunk=8, kv_pages=12)
    handles = [eng.submit(p, NEW) for p in prompts]
    eng.run_until_complete()
    assert [h.tokens for h in handles] == reference


@pytest.mark.parametrize("kind", ["paged", "paged_pressure", "dense"])
def test_greedy_engines_match_jax(setup, kind):
    """Two slots for four requests: the later requests find the shared
    16-token prefix in the page index (table writes).  With 6 pages for
    three slots, page pressure vacates slots, which resume exactly."""
    _, _, model, prompts, reference = setup
    kw = {"paged": dict(num_slots=2, kv_pages=12),
          "paged_pressure": dict(num_slots=3, kv_pages=6),
          "dense": dict(num_slots=2)}[kind]
    eng = Engine(model, device="cpu", max_len=48, prefill_chunk=8, **kw)
    assert _serve(eng, prompts) == reference
    if kind == "paged":
        assert eng.stats["prefix_hit_tokens"] >= 16
        assert eng.paged_attn == "einsum"
    if kind == "paged_pressure":
        assert eng.stats["page_pressure_vacates"] > 0
    eng.check_paged()
    if eng.page_pool is not None:  # only the index holds pages now
        assert eng.page_pool.used_pages == eng.page_index.node_count


def test_sampled_request_reproduces_beside_others(setup):
    """A seeded sampled request draws only from its slot's generator:
    alone, beside greedy and sampled neighbours, and vacated under page
    pressure (its generator state resumes), its tokens are the same."""
    _, _, model, prompts, _ = setup

    def run(others, **kw):
        eng = Engine(model, device="cpu", max_len=48, prefill_chunk=8,
                     **kw)
        hs = [eng.submit(p, NEW, temperature=0.9, seed=5 + i)
              if i % 2 else eng.submit(p, NEW)
              for i, p in enumerate(others)]
        target = eng.submit(prompts[2], NEW, temperature=1.1, top_k=20,
                            top_p=0.95, seed=42)
        eng.run_until_complete()
        assert all(h.ok for h in hs)
        return target.tokens, eng

    alone, _ = run([], num_slots=3, kv_pages=12)
    assert run(prompts[:2], num_slots=3, kv_pages=12)[0] == alone
    pressed, eng = run(prompts[:3], num_slots=3, kv_pages=6)
    assert eng.stats["page_pressure_vacates"] > 0
    assert pressed == alone
    assert run(prompts[:2], num_slots=3)[0] == alone  # dense arena


def test_no_card_and_no_cpu_request_raises(setup, monkeypatch):
    _, _, model, _, _ = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_cli.main(["--layers", "1"])


def test_kernel_backend_needs_the_card(setup):
    _, _, model, _, _ = setup
    with pytest.raises(ValueError, match="CUDA device"):
        Engine(model, device="cpu", kv_pages=12, max_len=48,
               prefill_chunk=8, paged_attn="kernel")
    with pytest.raises(ValueError, match="paged_attn"):
        Engine(model, device="cpu", kv_pages=12, paged_attn="pallas")
    with pytest.raises(ValueError, match="paged_attn='gather' requires"):
        Engine(model, device="cpu", paged_attn="gather")
    eng = Engine(model, device="cpu", max_len=48, prefill_chunk=8,
                 kv_pages=12)
    m = eng.metrics()
    assert m["paged_attn"] == {
        "requested": None, "resolved": "einsum",
        "dispatch": dict.fromkeys(("decode_paged", "verify_paged",
                                   "prefill_paged", "fused_decode_paged",
                                   "fused_spec_paged", "tree_verify_paged"),
                                  "einsum"),
        "fallbacks": []}
    assert set(m["kernel_launches"]) == {
        "paged_decode", "paged_window", "paged_decode_int8",
        "paged_window_int8", "paged_tree"}


#: The ported options: each constructs and is kept (option -> the
#: engine attribute that holds it).  The robustness options came first;
#: the dense prefix cache, tenancy and co-resident models followed, then
#: the obs layer.
PORTED_OPTIONS = {"drafter_timeout_s": "drafter_timeout_s",
                  "step_timeout_s": "_step_timeout_s",
                  "canary_every_s": "canary_every_s",
                  "prefix_cache_blocks": "_prefix_cache_blocks",
                  "tenants": "tenants", "models": "_mstates",
                  "obs": "obs.enabled", "flight_dir": "flight.directory"}


@pytest.mark.parametrize("option,value", [
    ("drafter_timeout_s", 0.5), ("step_timeout_s", 1.0),
    ("prefix_cache_blocks", 8), ("models", {"twin": "the setup's model"}),
    ("tenants", {"default": TenantClass()}), ("canary_every_s", 1.0),
    ("obs", False), ("flight_dir", "flight")])
def test_unported_options_raise(setup, option, value):
    """Every option of JAX's engine is ported now: each constructs and is
    kept (a co-resident model needs tenants routing to it), and so do
    their "off" values and JAX's defaults ``obs=True`` and
    ``flight_dir=None``."""
    import operator

    _, _, model, _, _ = setup
    kw = {option: value}
    if option == "models":
        value = {"twin": model}
        kw = {"models": value, "tenants": {
            "default": TenantClass(), "t": TenantClass(model="twin")}}
    eng = Engine(model, device="cpu", max_len=48, **kw)
    kept = operator.attrgetter(PORTED_OPTIONS[option])(eng)
    if option == "models":
        assert list(kept) == [None, "twin"]
        assert kept["twin"].model is model
    else:
        assert kept == value
    Engine(model, device="cpu", max_len=48, **{option: {
        "drafter_timeout_s": None, "step_timeout_s": None,
        "prefix_cache_blocks": 0, "models": None, "tenants": None,
        "canary_every_s": None, "obs": True, "flight_dir": None}[option]})
    with pytest.raises(TypeError, match="unexpected"):
        Engine(model, device="cpu", no_such_option=1)


@pytest.fixture(scope="module")
def families(setup):
    """Both families' JAX and port models on one weight tree each; the
    LLaMA-GQA matrices are scaled five-fold (as the speculation tests'
    GPT-2) so greedy outputs loop and drafts get accepted."""
    jmodel, jparams, model, prompts, _ = setup
    tree = jax.tree_util.tree_map(
        lambda a: a * 5 if a.ndim == 2 else a,
        llama.random_params(llama.LlamaConfig(**LLAMA_GQA), seed=23))
    lmodel = llama.Llama(llama.LlamaConfig(**LLAMA_GQA))
    lmodel.load_state_dict(llama.params_from_jax(tree))
    rng = np.random.default_rng(24)
    periodic = [np.tile(rng.integers(0, 61, size=4), 6)[:n].astype(np.int32)
                for n in (14, 23)]
    return {"gpt2": (jmodel, jparams, model),
            "llama_gqa": (jax_llama_small(**LLAMA_GQA),
                          jax.tree_util.tree_map(jnp.asarray, tree), lmodel),
            "prompts": prompts + periodic}


SPEC = {"plain": {}, "sequence": dict(speculate_k=2),
        "fork2x2": dict(speculate_k=2, speculate_tree="fork2x2")}
COUNTERS = ("decode_steps", "verify_steps", "tree_verify_steps",
            "draft_tokens", "draft_accepted", "prefix_hit_tokens")


@pytest.mark.parametrize("mode", list(SPEC))
@pytest.mark.parametrize("family", ["gpt2", "llama_gqa"])
def test_int8_engine_matches_jax_int8_engine(families, family, mode):
    """Greedy serving over int8 pages (quantized at the write, read back
    dequantized by the plain attention) against the JAX engine's einsum
    int8 path: tokens equal (the stated tolerance would also take a first
    divergence at a top-2 gap below 1e-4; none occurs here) and the step,
    draft and prefix counters equal, with a shared prefix in the traffic;
    the pool is ``kv_heads`` wide."""
    jmodel, jparams, model = families[family]
    prompts = families["prompts"]
    kw = dict(num_slots=2, max_len=48, prefill_chunk=8, kv_pages=12,
              kv_dtype="int8", **SPEC[mode])
    jax_eng = JaxEngine(jmodel, jparams, paged_attn="einsum", **kw)
    want = _serve(jax_eng, prompts)
    eng = Engine(model, device="cpu", **kw)
    assert _serve(eng, prompts) == want
    assert {c: eng.stats[c] for c in COUNTERS} == {
        c: jax_eng.stats[c] for c in COUNTERS}
    assert eng.stats["prefix_hit_tokens"] >= 16
    if mode != "plain":
        assert eng.stats["draft_accepted"] > 0
    pages = eng.page_pool.pages
    assert pages.k.dtype == torch.int8 and pages.k_scale.dtype == torch.float32
    assert pages.k.shape[-2] == getattr(model.config, "kv_heads", 2)


def test_int8_tables_equal_fp_tables(families):
    """The same traffic on an fp and an int8 pool, in lockstep: identical
    block tables after every step (only page payloads quantize), and the
    int8 pool's page a quarter of the fp32 one's bytes plus scales."""
    _, _, model = families["llama_gqa"]
    engines = [Engine(model, device="cpu", num_slots=3, max_len=48,
                      prefill_chunk=8, kv_pages=7, kv_dtype=kv_dtype)
               for kv_dtype in (None, "int8")]
    for eng in engines:
        for p in families["prompts"]:
            eng.submit(p, NEW)
    while engines[0].queue_depth or engines[0].slots_in_use:
        for eng in engines:
            eng.step()
            eng.check_paged()
        np.testing.assert_array_equal(engines[0]._mstates[None].table,
                                      engines[1]._mstates[None].table)
    assert engines[1].stats["page_pressure_vacates"] > 0
    fp, i8 = (eng.metrics()["page_pools"][0]["page_bytes"]
              for eng in engines)
    assert (fp, i8) == (2 * 2 * 8 * 2 * 8 * 4, 2 * 2 * 8 * 2 * (8 + 4))


def test_int8_dispatch_matches_jax(setup):
    """The per-family dispatch table and its fallbacks, as JAX records
    them: a kernel engine over an int8 pool verifies trees on the einsum
    path, and nothing else falls back.  (The port's kernel engine needs a
    card, so its table is checked through ``paged_dispatch``.)"""
    jmodel, jparams, model, _, _ = setup
    kw = dict(num_slots=2, max_len=48, prefill_chunk=8, kv_pages=12,
              speculate_k=2, speculate_tree="fork2x2")
    for paged_attn, kv_dtype in (("kernel", "int8"), ("kernel", None),
                                 ("einsum", "int8")):
        jm = JaxEngine(jmodel, jparams, paged_attn=paged_attn,
                       kv_dtype=kv_dtype, **kw).metrics()["paged_attn"]
        want = {f: jm["dispatch"][f] for f in PAGED_FAMILIES}
        assert paged_dispatch(paged_attn, kv_dtype) == want
        fallbacks = sorted(f for f, impl in want.items()
                           if paged_attn == "kernel" and impl != "kernel")
        assert fallbacks == jm["fallbacks"]
    m = Engine(model, device="cpu", kv_dtype="int8", **kw).metrics()
    assert m["paged_attn"]["dispatch"] == paged_dispatch("einsum", "int8")
    assert m["paged_attn"]["fallbacks"] == []


@pytest.mark.parametrize("kw,match", [
    (dict(kv_dtype="fp8", kv_pages=12), "kv_dtype must be None or 'int8'"),
    (dict(kv_dtype="int8"), "requires kv_pages")])
def test_kv_dtype_validation(setup, kw, match):
    _, _, model, _, _ = setup
    with pytest.raises(ValueError, match=match):
        Engine(model, device="cpu", max_len=48, prefill_chunk=8, **kw)


def test_admission_control_and_shutdown(setup):
    _, _, model, prompts, reference = setup
    eng = Engine(model, device="cpu", num_slots=1, max_len=48,
                 prefill_chunk=8, kv_pages=12, queue_limit=1)
    first = eng.submit(prompts[0], NEW)
    with pytest.raises(QueueFull):
        eng.submit(prompts[1], NEW)
    assert eng.generate_many([], NEW) == []
    np.testing.assert_array_equal(first.result()[prompts[0].size:],
                                  reference[0])
    held = eng.submit(prompts[1], NEW)
    eng.step()
    assert held.cancel() and not held.cancel()
    eng.close()
    with pytest.raises(EngineClosed):
        eng.submit(prompts[0], NEW)
    eng.check_paged()


def test_serve_cli_rehearsal_on_cpu(capsys):
    m = serve_cli.main(["--device", "cpu", "--layers", "2", "--d-model",
                        "64", "--vocab", "256", "--paged", "64",
                        "--requests", "3", "--max-new-tokens", "4"])
    assert m["stats"]["completed"] == 3
    assert "tokens/s on cpu" in capsys.readouterr().out


def test_serve_cli_llama_int8_rehearsal_on_cpu(capsys):
    m = serve_cli.main(["--device", "cpu", "--family", "llama", "--kv-heads",
                        "2", "--kv-dtype", "int8", "--layers", "2",
                        "--d-model", "64", "--vocab", "256", "--paged", "64",
                        "--requests", "3", "--max-new-tokens", "4"])
    assert m["stats"]["completed"] == 3
    assert m["page_pools"][0]["kv_dtype"] == "int8"
    out = capsys.readouterr().out
    assert "family=llama" in out and "kv_dtype=int8" in out
