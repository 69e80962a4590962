"""The port's fused decode windows (``Engine(decode_fuse=N)``,
``fuse_stream``) against the JAX engine's, at the tiny geometries of
tests/test_torch_engine.py, with weights carried over by
``params_from_jax``.

Greedy tokens are exactly equal to JAX's, and so are the window
counters (``fused_windows``, ``fused_steps``) and the ``decode_steps``
and ``active_slot_steps`` they share with the single-step path, for
GPT-2 and LLaMA-GQA on the dense arena and on paged fp32 and int8
pools, with the ``(slot, token)`` stream in JAX's order.  Sampled
requests give the same tokens windowed as one step at a time: the
window's sampling (``sample_rows``) is the single step's body.  Off the
card the window is its plain version, an eager loop of the iteration
the card captures as a CUDA graph (tests/test_torch_cuda_fused.py).
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
from tpudp.serve.faults import FailingDrafter
from tpudp_torch import serve_cli
from tpudp_torch.models import gpt2, llama
from tpudp_torch.ops import paged_attention as pa
from tpudp_torch.ops import sampling
from tpudp_torch.serve import (DraftModelDrafter, Engine, FinishReason,
                               NgramDrafter)

TINY = dict(vocab_size=61, max_seq_len=96, num_layers=2, num_heads=2,
            d_model=32)
LLAMA_GQA = dict(vocab_size=61, max_seq_len=96, num_layers=2, num_heads=4,
                 num_kv_heads=2, d_model=32)
GEOMETRY = dict(max_len=48, prefill_chunk=8)
STORES = {"dense": {}, "paged": dict(kv_pages=12),
          "int8": dict(kv_pages=12, kv_dtype="int8")}
COUNTERS = ("fused_windows", "fused_steps", "decode_steps",
            "active_slot_steps", "prefill_chunks", "tokens")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite's workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def families():
    """Both families' JAX and port models on one weight tree each (the
    LLaMA-GQA matrices scaled five-fold, as tests/test_torch_engine.py
    does, so its greedy outputs do not collapse to one token)."""
    gtree = gpt2.random_params(gpt2.GPT2Config(**TINY), seed=31)
    gmodel = gpt2.GPT2(gpt2.GPT2Config(**TINY))
    gmodel.load_state_dict(gpt2.params_from_jax(gtree))
    ltree = jax.tree_util.tree_map(
        lambda a: a * 5 if a.ndim == 2 else a,
        llama.random_params(llama.LlamaConfig(**LLAMA_GQA), seed=32))
    lmodel = llama.Llama(llama.LlamaConfig(**LLAMA_GQA))
    lmodel.load_state_dict(llama.params_from_jax(ltree))
    as_jax = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)  # noqa: E731
    return {"gpt2": (jax_gpt2_small(**TINY), as_jax(gtree), gmodel),
            "llama_gqa": (jax_llama_small(**LLAMA_GQA), as_jax(ltree),
                          lmodel)}


def _jax_engine(jmodel, jparams, **kw):
    if kw.get("kv_pages"):
        kw.setdefault("paged_attn", "einsum")
    return JaxEngine(jmodel, jparams, **GEOMETRY, **kw)


def _port_engine(model, **kw):
    return Engine(model, device="cpu", **GEOMETRY, **kw)


def _staggered(eng, prompts, max_new):
    """tests/test_serve_fused.py's traffic: queued work forces single
    steps, an emptied queue lets windows engage."""
    handles = [eng.submit(prompts[0], max_new[0])]
    eng.step()
    eng.step()
    handles.append(eng.submit(prompts[1], max_new[1]))
    handles.append(eng.submit(prompts[2], max_new[2]))
    eng.step()
    handles.append(eng.submit(prompts[3], max_new[3]))
    handles.append(eng.submit(prompts[4], max_new[4]))
    eng.run_until_complete()
    return [h.tokens for h in handles]


@pytest.mark.parametrize("store", list(STORES))
@pytest.mark.parametrize("family", ["gpt2", "llama_gqa"])
def test_greedy_windows_match_jax(families, family, store):
    """Staggered admissions through ``decode_fuse=4``: tokens and the
    window, step and slot-step counters equal the JAX engine's."""
    jmodel, jparams, model = families[family]
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 61, size=n).astype(np.int32)
               for n in (5, 19, 3, 9, 24)]
    max_new = [16, 4, 8, 5, 7]
    kw = dict(num_slots=2, decode_fuse=4, **STORES[store])
    jeng = _jax_engine(jmodel, jparams, **kw)
    eng = _port_engine(model, **kw)
    assert _staggered(eng, prompts, max_new) == _staggered(jeng, prompts,
                                                           max_new)
    assert {c: eng.stats[c] for c in COUNTERS} == {
        c: jeng.stats[c] for c in COUNTERS}
    assert eng.stats["fused_windows"] > 0 and eng.stats["decode_steps"] > 0
    eng.check_paged()


@pytest.mark.parametrize("store", ["dense", "paged", "pressure"])
def test_sampled_windows_match_single_steps(families, store):
    """Sampled requests (temperature, top-k, top-p, per-request seeds)
    beside greedy ones give the same tokens with ``decode_fuse=4`` as
    with 1: with an admission landing between windows, and under page
    pressure, whose vacated requests resume their generator state."""
    _, _, model = families["gpt2"]
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 61, size=n).astype(np.int32)
               for n in (13, 20, 15, 17)]
    kw = {"dense": dict(num_slots=2), "paged": dict(num_slots=2,
                                                    kv_pages=12),
          "pressure": dict(num_slots=3, kv_pages=6)}[store]

    def run(fuse):
        eng = _port_engine(model, decode_fuse=fuse, **kw)
        handles = [eng.submit(p, 9, temperature=0.9, top_k=12, top_p=0.9,
                              seed=7 + i) for i, p in enumerate(prompts[:2])]
        for _ in range(4):
            eng.step()
        handles += [eng.submit(prompts[2], 11, temperature=1.1, seed=3),
                    eng.submit(prompts[3], 10)]
        eng.run_until_complete()
        eng.check_paged()
        return [h.tokens for h in handles], eng.stats

    fused, st = run(4)
    single, _ = run(1)
    assert fused == single
    assert st["fused_windows"] > 0
    if store == "pressure":
        assert st["page_pressure_vacates"] > 0


def test_sample_rows_is_sample_tokens_row_for_row():
    """The window's sampling equals ``sample_tokens`` row for row on
    generators in the same state, and a sampled row leaves its generator
    where ``sample_tokens`` leaves it."""
    rng = np.random.default_rng(9)
    logits = torch.as_tensor(rng.standard_normal((4, 31)).astype(
        np.float32) * 2)
    temps = np.array([0.0, 0.8, 1.3, 0.5], np.float32)
    top_k = np.array([0, 0, 7, 3], np.int64)
    top_p = np.array([1.0, 0.9, 1.0, 0.8], np.float32)
    for seed in range(6):
        a = [torch.Generator().manual_seed(seed + i) for i in range(4)]
        b = [torch.Generator().manual_seed(seed + i) for i in range(4)]
        want = sampling.sample_tokens(logits, temps, top_k, top_p, a)
        got = sampling.sample_rows(logits, torch.as_tensor(temps),
                                   torch.as_tensor(top_k),
                                   torch.as_tensor(top_p), b)
        assert got.tolist() == want.tolist()
        assert got[0] == torch.argmax(logits[0])
        for x, y in zip(a[1:], b[1:]):
            assert torch.equal(x.get_state(), y.get_state())


def test_graph_launches_move_from_capture_to_replays(monkeypatch):
    """The wrappers' calls during a capture run nothing: their counts are
    taken back and added once for every replay."""
    for fn in pa.KERNELS.values():
        monkeypatch.setattr(fn, "launches", 5)
    record = pa.GraphLaunches()
    with record.capturing():
        pa.KERNELS["paged_decode"].launches += 12
    assert record.per_replay == {"paged_decode": 12}
    assert pa.KERNELS["paged_decode"].launches == 5
    record.replayed(3)
    assert pa.KERNELS["paged_decode"].launches == 5 + 36
    with pytest.raises(RuntimeError):  # a capture that fails keeps nothing
        with pa.GraphLaunches().capturing():
            pa.KERNELS["paged_decode"].launches += 12
            raise RuntimeError("capture failed")
    assert pa.KERNELS["paged_decode"].launches == 5 + 36
    assert all(fn.launches == 5 for name, fn in pa.KERNELS.items()
               if name != "paged_decode")


def test_merge_buffer_keeps_what_a_graph_may_hold(monkeypatch):
    """A merge buffer replaced by a larger one stays allocated (a graph
    captured around a launch holds its address); growth at least
    doubles."""
    monkeypatch.setattr(pa, "_merge_buffers", {})
    monkeypatch.setattr(pa, "_retired_buffers", [])
    dev = torch.device("cpu")
    first = pa._merge_buffer(dev, torch.int32, 100)
    assert first.numel() == 4096 and pa._merge_buffer(
        dev, torch.int32, 4096) is first
    grown = pa._merge_buffer(dev, torch.int32, 5000)
    assert grown.numel() == 8192 and pa._retired_buffers == [first]
    assert not grown.any()


def _eos_case(jmodel, jparams):
    """A prompt and an eos id whose first occurrence lands strictly
    inside a 16-iteration window (tests/test_serve_fused.py:93)."""
    for seed in range(4, 40):
        rng = np.random.default_rng(seed)
        p = rng.integers(0, 61, size=5).astype(np.int32)
        ref = np.asarray(jax_generate(jmodel, jparams, jnp.asarray(p[None]),
                                      16))[0, 5:]
        firsts: dict[int, int] = {}
        for i, t in enumerate(ref):
            firsts.setdefault(int(t), i)
        cands = sorted((i, t) for t, i in firsts.items() if 2 <= i <= 10)
        if cands:
            return p, ref, cands[0]
    pytest.fail("no prompt produced a mid-window eos candidate")


@pytest.mark.parametrize("store", ["dense", "paged"])
def test_eos_mid_window(families, store):
    jmodel, jparams, model = families["gpt2"]
    p, ref, (first, eos) = _eos_case(jmodel, jparams)
    kw = dict(num_slots=1, decode_fuse=16, **STORES[store])
    eng = _port_engine(model, **kw)
    h = eng.submit(p, 16, eos_id=eos)
    eng.run_until_complete()
    assert h.finish_reason is FinishReason.EOS
    assert h.tokens == ref[:first + 1].tolist()
    jeng = _jax_engine(jmodel, jparams, **kw)
    jeng.submit(p, 16, eos_id=eos)
    jeng.run_until_complete()
    assert 0 < eng.stats["fused_steps"] < 16
    assert {c: eng.stats[c] for c in COUNTERS} == {
        c: jeng.stats[c] for c in COUNTERS}


@pytest.mark.parametrize("max_new", [9, 10])
def test_budget_on_and_past_a_window_edge(families, max_new):
    """1 prefill-sampled token + 8 or 9 decode tokens at N=4: the budget
    retires the request COMPLETE with exactly its tokens."""
    jmodel, jparams, model = families["gpt2"]
    p = np.random.default_rng(5).integers(0, 61, size=5).astype(np.int32)
    eng = _port_engine(model, num_slots=1, decode_fuse=4, kv_pages=12)
    h = eng.submit(p, max_new)
    eng.run_until_complete()
    assert h.finish_reason is FinishReason.COMPLETE
    assert h.tokens == np.asarray(jax_generate(
        jmodel, jparams, jnp.asarray(p[None]), max_new))[0, 5:].tolist()
    assert eng.stats["fused_windows"] == 2 + (max_new == 10)
    assert eng.stats["fused_steps"] == max_new - 1


def test_prefix_cached_traffic(families):
    """Shared-prefix hits mapped from the page index, then windows:
    tokens and counters equal the JAX paged engine's."""
    jmodel, jparams, model = families["gpt2"]
    rng = np.random.default_rng(11)
    shared = rng.integers(0, 61, size=16).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, 61, size=4)
                               .astype(np.int32)]) for _ in range(3)]
    kw = dict(num_slots=1, decode_fuse=4, kv_pages=12)
    engines = _port_engine(model, **kw), _jax_engine(jmodel, jparams, **kw)
    outs = []
    for eng in engines:
        outs.append([eng.generate_many([p], 8)[0].tolist()
                     for p in prompts])
    port, jeng = engines
    assert outs[0] == outs[1]
    assert port.stats["prefix_hit_tokens"] >= 16
    assert {c: port.stats[c] for c in COUNTERS + ("prefix_hit_tokens",)} \
        == {c: jeng.stats[c] for c in COUNTERS + ("prefix_hit_tokens",)}


def test_ngram_speculative_engine_never_fuses(families):
    """A live n-gram drafter keeps the verify path; once it is
    quarantined the engine fuses, and tokens stay JAX's throughout."""
    jmodel, jparams, model = families["gpt2"]
    rng = np.random.default_rng(12)
    rep = np.tile(rng.integers(0, 61, size=3), 4)[:9].astype(np.int32)
    live = _port_engine(model, num_slots=1, speculate_k=2, decode_fuse=4,
                        drafter=NgramDrafter(max_ngram=3, min_ngram=2))
    out = live.generate_many([rep], 8)
    assert live.stats["fused_windows"] == 0 and live._window is None
    np.testing.assert_array_equal(out[0], np.asarray(jax_generate(
        jmodel, jparams, jnp.asarray(rep[None]), 8))[0])
    kw = dict(num_slots=1, speculate_k=2, decode_fuse=4, kv_pages=12)
    dying = _port_engine(model, drafter=FailingDrafter(
        inner=NgramDrafter(), ok_proposals=1), **kw)
    jdying = _jax_engine(jmodel, jparams, drafter=FailingDrafter(
        inner=NgramDrafter(), ok_proposals=1), **kw)
    out = dying.generate_many([rep], 12)
    jout = jdying.generate_many([rep], 12)
    assert dying.stats["drafter_quarantined"] == 1
    assert dying.stats["fused_windows"] > 0
    np.testing.assert_array_equal(out[0], jout[0])
    assert {c: dying.stats[c] for c in COUNTERS + ("verify_steps",)} == {
        c: jdying.stats[c] for c in COUNTERS + ("verify_steps",)}


def test_fuse_stream_equals_jax_ring(families):
    """``fused_stream`` holds JAX's ring: every in-window commit as
    ``(slot, token)``, iteration by iteration, slots in order."""
    jmodel, jparams, model = families["gpt2"]
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, 61, size=n).astype(np.int32) for n in (5, 7)]
    kw = dict(num_slots=2, decode_fuse=8, fuse_stream=True, kv_pages=12)
    eng, jeng = _port_engine(model, **kw), _jax_engine(jmodel, jparams, **kw)
    handles = [eng.submit(p, n) for p, n in zip(prompts, (9, 6))]
    for p, n in zip(prompts, (9, 6)):
        jeng.submit(p, n)
    eng.run_until_complete()
    jeng.run_until_complete()
    ring = list(eng.fused_stream)
    assert ring == list(jeng.fused_stream)
    assert eng.fused_stream.maxlen == jeng.fused_stream.maxlen == 64
    for slot, h in enumerate(handles):  # the last tokens rode windows
        tapped = [t for s, t in ring if s == slot]
        assert tapped and tapped == h.tokens[-len(tapped):]


def test_decode_fuse_off_builds_nothing(families):
    """``decode_fuse=1``: no window, no ``fused_*`` stat, no stream, the
    metrics of the single-step engine."""
    _, _, model = families["gpt2"]
    p = np.random.default_rng(14).integers(0, 61, size=5).astype(np.int32)
    eng = _port_engine(model, num_slots=2, kv_pages=12)
    eng.generate_many([p, p[:3]], 6)
    assert not any(k.startswith("fused_") for k in eng.stats)
    assert eng.fused_stream is None and eng._window is None
    assert "fused_window" not in eng.metrics()


def test_one_window_per_engine_across_churn(families):
    """The window is built once per engine however many requests churn
    through it (on the card, one capture: tests/test_torch_cuda_fused.py)."""
    _, _, model = families["gpt2"]
    rng = np.random.default_rng(15)
    eng = _port_engine(model, num_slots=3, decode_fuse=5, kv_pages=12)
    eng.generate_many([rng.integers(0, 61, size=4).astype(np.int32)], 6)
    window = eng._window
    assert window is not None
    for i in range(5):
        eng.submit(rng.integers(0, 61, size=3 + 2 * (i % 3)).astype(np.int32),
                   4 + i, temperature=0.5 * (i % 2),
                   top_k=4 if i % 2 else None, seed=i)
        eng.run_until_complete()
    assert eng._window is window and window.captures == 0
    m = eng.metrics()
    assert m["fused_window"] == {"decode_fuse": 5, "graph": False,
                                 "captures": 0, "replays": 0}
    assert m["stats"]["fused_windows"] > 0 and m["stats"]["fused_steps"] > 0
    assert m["paged_attn"]["dispatch"]["fused_decode_paged"] == "einsum"


def test_validation(families):
    _, _, model = families["gpt2"]
    with pytest.raises(ValueError, match="decode_fuse"):
        Engine(model, device="cpu", num_slots=1, decode_fuse=0)
    with pytest.raises(ValueError, match="fuse_stream"):
        Engine(model, device="cpu", num_slots=1, fuse_stream=True)
    # A model drafter that covers max_len + k positions fuses speculation.
    eng = Engine(model, device="cpu", num_slots=1, max_len=48, speculate_k=2,
                 drafter=DraftModelDrafter(model), decode_fuse=4)
    assert eng._spec_fusable
    assert eng.paged_attn_dispatch == {}


def test_fused_stats(families):
    """8 decode tokens in windows of 4: 2 windows, 8 iterations, as in
    JAX (tests/test_serve_fused.py:470)."""
    _, _, model = families["gpt2"]
    p = np.random.default_rng(16).integers(0, 61, size=5).astype(np.int32)
    eng = _port_engine(model, num_slots=1, decode_fuse=4)
    eng.generate_many([p], 9)
    assert eng.stats["fused_windows"] == 2
    assert eng.stats["fused_steps"] == 8
    assert eng.stats["decode_steps"] == 0


def test_serve_cli_decode_fuse_rehearsal_on_cpu(capsys):
    m = serve_cli.main(["--device", "cpu", "--layers", "2", "--d-model",
                        "64", "--vocab", "256", "--paged", "64",
                        "--requests", "3", "--max-new-tokens", "9",
                        "--decode-fuse", "4", "--fuse-stream"])
    assert m["stats"]["completed"] == 3
    assert m["stats"]["fused_windows"] > 0
    assert m["fused_window"]["decode_fuse"] == 4
    out = capsys.readouterr().out
    assert "fused windows=" in out
