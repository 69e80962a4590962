"""Fused speculation on the card: one CUDA graph of a draft -> verify ->
accept iteration (the draft model's prefill and steps, the target's
``k + 1`` verify window through K5, or K5-int8 over an int8 pool, or the
dense arena), replayed, against the eager host-drafted engine
(``DraftModelDrafter(bucket=max_len)``, ``decode_fuse=1``) on the same
card.  Every test here carries the ``cuda`` marker and skips without a
card.  The file imports no JAX, so it runs where only PyTorch is
installed:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda_spec_fused.py -q
"""

import numpy as np
import pytest
import torch

from tpudp_torch.models import gpt2, llama
from tpudp_torch.ops import paged_attention as pa
from tpudp_torch.serve import DraftModelDrafter, Engine
from tpudp_torch.serve.faults import FaultySteps

# Head dim 32, which the kernels take: GPT-2 at groups 1, LLaMA at 4.
GPT2 = (gpt2, gpt2.GPT2Config(vocab_size=256, max_seq_len=128, num_layers=2,
                              num_heads=2, d_model=64))
LLAMA = (llama, llama.LlamaConfig(vocab_size=256, max_seq_len=128,
                                  num_layers=2, num_heads=4, num_kv_heads=1,
                                  d_model=128))
DRAFT = gpt2.GPT2Config(vocab_size=256, max_seq_len=136, num_layers=1,
                        num_heads=1, d_model=32)
K, FUSE, MAX_LEN = 3, 6, 128
# name -> (family, config, KV store, the verify kernel).
STORES = {"gpt2_fp32": (*GPT2, dict(kv_pages=64), "paged_window"),
          "llama_int8": (*LLAMA, dict(kv_pages=64, kv_dtype="int8"),
                         "paged_window_int8"),
          "gpt2_dense": (*GPT2, {}, None)}


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


def _serve(engine, prompts, max_new=24):
    """Greedy and sampled requests (every other one at temperature 0.9,
    top-k 12, its own seed), all submitted at once."""
    handles = [engine.submit(p, max_new, seed=11 + i,
                             **(dict(temperature=0.9, top_k=12)
                                if i % 2 else {}))
               for i, p in enumerate(prompts)]
    engine.run_until_complete()
    engine.check_paged()
    assert all(h.ok for h in handles)
    return ([h.tokens for h in handles],
            [(h.draft_proposed, h.draft_accepted) for h in handles])


def _engines(model, draft, card, store, fused):
    return Engine(model, device=card, num_slots=4, max_len=MAX_LEN,
                  prefill_chunk=16, speculate_k=K,
                  decode_fuse=FUSE if fused else 1,
                  drafter=DraftModelDrafter(
                      draft, bucket=None if fused else MAX_LEN), **store)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(STORES))
def test_captured_window_equals_host_drafted(card, name):
    """Tokens and acceptance of the captured window equal the host-drafted
    engine's; one capture; the verify kernel launches once a layer per
    replayed iteration (plus the two warm-up iterations)."""
    family, cfg, store, kernel = STORES[name]
    model = family.build(cfg, 3, card)
    draft = gpt2.build(DRAFT, 4, card)
    runs = {}
    for fused in (True, False):
        eng = _engines(model, draft, card, store, fused)
        assert eng._spec_fusable is fused
        before = {n: fn.launches for n, fn in pa.KERNELS.items()}
        runs[fused] = _serve(eng, _prompts(6))
        launched = {n: fn.launches - before[n]
                    for n, fn in pa.KERNELS.items()}
        if fused:
            w = eng.metrics()["fused_spec_window"]
            assert w["graph"] and w["captures"] == 1
            assert eng.stats["fused_spec_windows"] > 0
            if kernel:
                per = cfg.num_layers
                assert launched[kernel] == per * (
                    eng.stats["prefill_chunks"] + eng.stats["verify_steps"]
                    + w["replays"] + 2)
    assert runs[True] == runs[False]


@pytest.mark.cuda
def test_window_after_containment_gives_unfaulted_tokens(card):
    """A fault at a fused speculation window resets the pool in place:
    the captured graph, which holds the pool's address, replays on and
    every request ends with the unfaulted run's greedy tokens."""
    family, cfg, store, _ = STORES["gpt2_fp32"]
    model = family.build(cfg, 5, card)
    draft = gpt2.build(DRAFT, 6, card)
    prompts = _prompts(4, seed=2)

    def run(hook):
        eng = _engines(model, draft, card, dict(store, step_fault_hook=hook),
                       True)
        handles = [eng.submit(p, 30) for p in prompts]
        eng.run_until_complete()
        eng.check_paged()
        return eng, [h.tokens for h in handles]

    _, clean = run(None)
    hook = FaultySteps(fail_at=set(), kind="fused_spec")

    def second_window(kind, index):
        if kind == "fused_spec" and len(hook.fail_at) < 1:
            second_window.seen += 1
            if second_window.seen == 2:
                hook.fail_at.add(index)
        hook(kind, index)

    second_window.seen = 0
    eng, faulted = run(second_window)
    assert hook.fired and eng.stats["step_failures"] == 1
    assert eng.metrics()["fused_spec_window"]["captures"] == 1
    assert faulted == clean
