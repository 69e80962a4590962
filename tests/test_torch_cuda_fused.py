"""Fused decode windows on the card: one CUDA graph of a decode iteration
(paged attention through K4, K4-int8 over an int8 pool, or the dense
arena), replayed, against the same engine's single steps.  Every test
here carries the ``cuda`` marker and skips without a card.  The file
imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda_fused.py -q
"""

import numpy as np
import pytest
import torch

from tpudp_torch.models import gpt2, llama
from tpudp_torch.ops import paged_attention as pa
from tpudp_torch.serve import Engine

# Head dim 32, which the kernels take: GPT-2 at groups 1, LLaMA at 4.
GPT2 = (gpt2, gpt2.GPT2Config(vocab_size=256, max_seq_len=128, num_layers=2,
                              num_heads=2, d_model=64))
LLAMA = (llama, llama.LlamaConfig(vocab_size=256, max_seq_len=128,
                                  num_layers=2, num_heads=4, num_kv_heads=1,
                                  d_model=128))
# name -> (family, config, KV store): fp32 pages (K4), int8 pages
# (K4-int8), and the dense arena (no kernel).
STORES = {"gpt2_fp32": (*GPT2, dict(kv_pages=64)),
          "llama_int8": (*LLAMA, dict(kv_pages=64, kv_dtype="int8")),
          "gpt2_dense": (*GPT2, {})}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the window is a CUDA graph of the "
                    "kernels, which have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=int(s)).astype(np.int32)
            for s in rng.integers(5, 40, size=n)]


def _serve(engine, prompts, max_new=20):
    """Greedy and sampled requests (every other one at temperature 0.8,
    top-k 40, top-p 0.95, its own seed), all submitted at once."""
    handles = [engine.submit(p, max_new, seed=11 + i,
                             **(dict(temperature=0.8, top_k=40, top_p=0.95)
                                if i % 2 else {}))
               for i, p in enumerate(prompts)]
    engine.run_until_complete()
    engine.check_paged()
    assert all(h.ok for h in handles)
    return [h.tokens for h in handles]


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(STORES))
def test_captured_window_equals_single_steps(card, name):
    """Greedy and sampled tokens of ``decode_fuse=8`` equal those of
    ``decode_fuse=1`` exactly; every window replays the one graph, whose
    iteration launches the paged-decode kernel once a layer over a page
    pool (and none over the dense arena)."""
    family, cfg, store = STORES[name]
    model = family.build(cfg, 3, card)
    kernel = ("paged_decode_int8" if store.get("kv_dtype")
              else "paged_decode")
    per_iteration = cfg.num_layers if store else 0
    runs = {}
    for fuse in (8, 1):
        eng = Engine(model, device=card, num_slots=4, prefill_chunk=16,
                     decode_fuse=fuse, **store)
        before = pa.KERNELS[kernel].launches
        runs[fuse] = _serve(eng, _prompts(6))
        launched = pa.KERNELS[kernel].launches - before
        if fuse == 8:
            w = eng.metrics()["fused_window"]
            assert w["graph"] and w["captures"] == 1
            assert eng.stats["fused_windows"] > 0
            # Two warm-up iterations before the capture launched too.
            assert launched == per_iteration * (
                eng.stats["decode_steps"] + w["replays"] + 2)
        else:
            assert "fused_window" not in eng.metrics()
            assert launched == per_iteration * eng.stats["decode_steps"]
        if store:
            assert eng.metrics()["paged_attn"]["fallbacks"] == (
                ["tree_verify_paged"] if store.get("kv_dtype") else [])
    assert runs[8] == runs[1]


@pytest.mark.cuda
def test_one_capture_per_engine_across_churn(card):
    family, cfg = GPT2
    eng = Engine(family.build(cfg, 4, card), device=card, num_slots=3,
                 prefill_chunk=16, kv_pages=64, decode_fuse=5)
    for i, p in enumerate(_prompts(6, seed=1)):
        eng.submit(p, 4 + 3 * i, temperature=0.5 * (i % 2), seed=i)
        eng.run_until_complete()
    w = eng.metrics()["fused_window"]
    assert w["captures"] == 1 and w["replays"] >= eng.stats["fused_steps"]
    assert eng.stats["fused_windows"] > 1


@pytest.mark.cuda
def test_vacated_sampled_request_resumes_exactly(card):
    """Under page pressure a vacated sampled request resumes its saved
    generator state: the graph's registered generators draw from it."""
    family, cfg = GPT2
    model = family.build(cfg, 5, card)
    prompts = _prompts(6, seed=2)
    runs = {}
    for fuse in (4, 1):
        eng = Engine(model, device=card, num_slots=3, prefill_chunk=16,
                     kv_pages=8, decode_fuse=fuse)
        runs[fuse] = _serve(eng, prompts, max_new=30)
        assert eng.stats["page_pressure_vacates"] > 0
    assert runs[4] == runs[1]


@pytest.mark.cuda
def test_failed_capture_raises(card, monkeypatch):
    """A host sync inside the iteration aborts the capture, and the
    window raises: it never gives way to eager iterations."""
    family, cfg = GPT2
    eng = Engine(family.build(cfg, 6, card), device=card, num_slots=2,
                 prefill_chunk=16, kv_pages=64, decode_fuse=4)
    window = eng._fused_window(eng._mstates[None])
    forward = window.forward

    def syncing_forward(*args):
        logits = forward(*args)
        float(logits.sum())  # a host sync: illegal while capturing
        return logits

    monkeypatch.setattr(window, "forward", syncing_forward)
    eng.submit(_prompts(1, seed=3)[0], 12)
    with pytest.raises(RuntimeError):
        eng.run_until_complete()
    assert window.graph is None and window.captures == 0
    assert "fused_windows" not in eng.stats
