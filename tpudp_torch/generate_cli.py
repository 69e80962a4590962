"""Generate tokens from a GPT-2 or LLaMA with the port — the counterpart
of ``examples/generate_gpt2.py``: greedy or sampled decoding
(temperature, top-k, top-p), beam search, or N copies of the request
served at once through the continuous-batching engine.

    # Greedy at a tiny size on the CPU (random weights from --seed):
    python -m tpudp_torch.generate_cli --device cpu --layers 2 \\
        --d-model 64 --vocab 256 --seq-len 128 --max-new-tokens 16

    # GPT-2 medium on the card (the default device), beam search:
    python -m tpudp_torch.generate_cli --layers 24 --d-model 1024 \\
        --heads 16 --vocab 50257 --seq-len 1024 --beam 4 \\
        --max-new-tokens 32

    # Eight copies through Engine.generate_many, sampled:
    python -m tpudp_torch.generate_cli --device cpu --concurrent 8 \\
        --temperature 0.8 --top-p 0.9 --seed 7

    # The weights train_cli --save-checkpoint saved, with its widths:
    python -m tpudp_torch.generate_cli --checkpoint-dir ckpt/gpt2 \\
        --layers 12 --d-model 768 --heads 12 --vocab 50257 --seq-len 1024

Without ``--checkpoint-dir`` the weights are ``random_params(--seed)``
(the example initializes flax's from a fixed key): the output shows the
decode path, not a trained model.  With it the params come from the
newest ``step_N`` there, after the example's checks against the flags
(``serve_cli._check_checkpoint``).  The prompt is ``--prompt-ids`` or
the first 8 tokens of the training examples' synthetic corpus.
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from tpudp_torch.models.generate import beam_search, generate
from tpudp_torch.serve import Engine
from tpudp_torch.serve.engine import resolve_device
from tpudp_torch.serve_cli import load_model, model_config
from tpudp_torch.utils.compile_cache import enable_persistent_cache
from tpudp_torch.utils.device_lock import acquire_for_process


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--family", default="gpt2", choices=["gpt2", "llama"],
                   help="decoder family; must match the checkpoint's")
    p.add_argument("--kv-heads", type=int, default=None,
                   help="grouped-query KV heads (llama family; default "
                        "--heads)")
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--d-model", type=int, default=64)
    p.add_argument("--heads", type=int, default=None,
                   help="attention heads (default d_model // 64); with "
                        "--checkpoint-dir it must be the training run's")
    p.add_argument("--vocab", type=int, default=256)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--dtype", choices=["float32", "bfloat16"],
                   default="float32")
    p.add_argument("--checkpoint-dir", type=str, default=None,
                   help="restore params from the newest step_N checkpoint "
                        "there (random weights from --seed without it)")
    p.add_argument("--prompt-ids", type=str, default=None,
                   help="comma-separated token ids (default: the first 8 "
                        "tokens of the synthetic corpus)")
    p.add_argument("--max-new-tokens", type=int, default=16)
    p.add_argument("--temperature", type=float, default=0.0,
                   help="0 = greedy argmax; > 0 samples")
    p.add_argument("--top-k", type=int, default=None)
    p.add_argument("--top-p", type=float, default=None)
    p.add_argument("--seed", type=int, default=0,
                   help="weights' seed and the sampling generator's")
    p.add_argument("--beam", type=int, default=None, metavar="W",
                   help="beam search of width W instead of greedy or "
                        "sampled decoding")
    p.add_argument("--concurrent", type=int, default=None, metavar="N",
                   help="serve N copies of the request at once through "
                        "the engine (sampled copies seeded seed..seed+N-1)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu for a rehearsal)")
    args = p.parse_args(argv)
    check_args(args)
    return args


def check_args(args) -> None:
    """The example's refusals, in its order and with its messages."""
    if args.beam is not None and (args.temperature != 0.0
                                  or args.top_k is not None
                                  or args.top_p is not None):
        raise SystemExit("error: --beam is deterministic max-probability "
                         "search; drop --temperature/--top-k/--top-p")
    if args.concurrent is not None and args.beam is not None:
        raise SystemExit("error: --concurrent serves greedy/sampling "
                         "requests through the batching engine; beam "
                         "search decodes one request at a time — drop "
                         "one of --concurrent/--beam")
    if args.concurrent is not None and args.concurrent < 1:
        raise SystemExit(f"error: --concurrent must be >= 1 (got "
                         f"{args.concurrent})")
    if args.temperature < 0:
        raise SystemExit(f"error: --temperature must be >= 0 (got "
                         f"{args.temperature}); negative values would "
                         "sample an inverted distribution")
    if (args.top_k is not None or args.top_p is not None) \
            and args.temperature == 0.0:
        raise SystemExit("error: --top-k/--top-p shape the SAMPLING "
                         "distribution; set --temperature > 0 (greedy "
                         "argmax ignores them)")
    if args.family != "llama" and args.kv_heads is not None:
        raise SystemExit("error: --kv-heads (GQA) is a llama-family "
                         "option")


def prompt_ids(args) -> list[int]:
    """``--prompt-ids``, or the first 8 tokens of the synthetic corpus;
    exits on ids outside the vocabulary."""
    if args.prompt_ids:
        try:
            ids = [int(x) for x in args.prompt_ids.split(",")]
        except ValueError:
            raise SystemExit(
                f"error: --prompt-ids must be comma-separated integers "
                f"(got {args.prompt_ids!r})") from None
    else:
        rng = np.random.default_rng(0)
        ids = rng.integers(0, args.vocab, size=4096)[:8].tolist()
    if not ids or any(not 0 <= i < args.vocab for i in ids):
        raise SystemExit(f"error: prompt ids must be in [0, {args.vocab})")
    return ids


def main(argv=None) -> dict:
    """Decode once; returns ``{"mode", "prompt", "tokens" (a list, or
    one list a copy with --concurrent), "score" (the beam's
    log-probability, else None), "ms_per_token", "model"}``."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    enable_persistent_cache()
    acquire_for_process(device)
    try:
        cfg = model_config(args, args.heads or max(args.d_model // 64, 1))
    except ValueError as exc:
        raise SystemExit(f"error: {exc}") from None
    model, restored = load_model(args, cfg, device, "generating from")
    if restored:
        print(f"[generate] restored params from {restored}")
    else:
        print(f"[generate] RANDOM-INIT weights from seed {args.seed} (no "
              f"--checkpoint-dir): output demonstrates the decode path, "
              f"not a trained model")
    ids = prompt_ids(args)
    prompt = torch.as_tensor([ids], dtype=torch.long, device=device)
    new = args.max_new_tokens
    out = {"prompt": ids, "score": None, "model": model}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    t0 = time.perf_counter()
    if args.concurrent is not None:
        # A chunk dividing max_seq_len, so the engine's round-down of
        # max_len strands no position generate() would accept.
        engine = Engine(model, device=device, num_slots=args.concurrent,
                        prefill_chunk=math.gcd(16, cfg.max_seq_len))
        seqs = engine.generate_many(
            [np.asarray(ids, np.int32)] * args.concurrent, new,
            temperature=args.temperature, top_k=args.top_k,
            top_p=args.top_p, seed=args.seed)
        sync()
        dt = time.perf_counter() - t0
        mode = ("greedy" if args.temperature == 0 else
                f"T={args.temperature} top_k={args.top_k} "
                f"top_p={args.top_p} seeds={args.seed}..")
        print(f"[generate] concurrent={args.concurrent} {mode} prompt={ids} "
              f"aggregate {args.concurrent * new / dt:.1f} tokens/s on "
              f"{device}")
        out["tokens"] = [s[len(ids):].tolist() for s in seqs]
        for i, toks in enumerate(out["tokens"]):
            print(f"tokens[{i}]:", toks)
    elif args.beam is not None:
        seqs, scores = beam_search(model, prompt, new, beam_width=args.beam)
        sync()
        dt = time.perf_counter() - t0
        mode = f"beam={args.beam}"
        out["score"] = float(scores[0])
        out["tokens"] = seqs[0, len(ids):].tolist()
        print(f"[generate] {mode} logprob={out['score']:.4f} prompt={ids}")
        print("tokens:", out["tokens"])
    else:
        gen = None
        if args.temperature > 0:
            gen = torch.Generator(device=device).manual_seed(args.seed)
        seqs = generate(model, prompt, new, temperature=args.temperature,
                        top_k=args.top_k, top_p=args.top_p, generator=gen)
        sync()
        dt = time.perf_counter() - t0
        mode = ("greedy" if args.temperature == 0 else
                f"T={args.temperature} top_k={args.top_k} "
                f"top_p={args.top_p} seed={args.seed}")
        out["tokens"] = seqs[0, len(ids):].tolist()
        print(f"[generate] {mode} prompt={ids}")
        print("tokens:", out["tokens"])
    out["mode"] = mode
    out["ms_per_token"] = 1e3 * dt / new
    print(f"[generate] {out['ms_per_token']:.3f} ms a new token on {device}")
    return out


if __name__ == "__main__":
    main()
