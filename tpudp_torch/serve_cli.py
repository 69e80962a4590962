"""Serve concurrent GPT-2 requests with the port's engine — the
counterpart of ``examples/serve_gpt2.py``.

    # On the card (the default device), paged KV through the CUDA kernels:
    python -m tpudp_torch.serve_cli --layers 12 --d-model 768 --heads 12 \\
        --vocab 50257 --seq-len 1024 --paged 512

    # CPU rehearsal at a tiny size (plain PyTorch attention):
    python -m tpudp_torch.serve_cli --device cpu --layers 2 --d-model 64 \\
        --vocab 256 --paged 64

Weights are random, drawn from ``--seed``: the output shows the serving
path, not a trained model.  Request 0's tokens stream as they land while
the others decode in the same batched steps.
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from tpudp_torch.models.gpt2 import GPT2Config, build
from tpudp_torch.serve import Engine
from tpudp_torch.serve.engine import resolve_device


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--d-model", type=int, default=64)
    p.add_argument("--heads", type=int, default=None,
                   help="attention heads (default d_model // 64)")
    p.add_argument("--vocab", type=int, default=256)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--dtype", choices=["float32", "bfloat16"],
                   default="float32")
    p.add_argument("--requests", type=int, default=6)
    p.add_argument("--num-slots", type=int, default=3)
    p.add_argument("--prefill-chunk", type=int, default=16)
    p.add_argument("--max-new-tokens", type=int, default=16)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--paged", type=int, default=0, metavar="KV_PAGES",
                   help="paged KV with this many pages of --prefill-chunk "
                        "tokens (0: the dense slot arena)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu for a rehearsal)")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if args.requests < 1:
        p.error("--requests must be >= 1")
    if args.temperature < 0:
        p.error("--temperature must be >= 0")
    if args.paged < 0:
        p.error("--paged must be >= 0")
    return args


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = GPT2Config(vocab_size=args.vocab, max_seq_len=args.seq_len,
                     num_layers=args.layers,
                     num_heads=args.heads or max(args.d_model // 64, 1),
                     d_model=args.d_model, dtype=getattr(torch, args.dtype))
    # A chunk dividing --seq-len, so the engine's round-down of max_len
    # strands no position the flags say exists.
    engine = Engine(build(cfg, args.seed, device), device=device,
                    num_slots=args.num_slots,
                    prefill_chunk=math.gcd(args.prefill_chunk, args.seq_len),
                    kv_pages=args.paged)
    print(f"[serve] RANDOM-INIT weights from seed {args.seed} on "
          f"{engine.device}; paged_attn="
          f"{engine.paged_attn if args.paged else 'dense arena'}")
    rng = np.random.default_rng(args.seed)
    base = rng.integers(0, args.vocab, size=4096)
    t0 = time.perf_counter()
    handles = []
    for i in range(args.requests):
        plen = 4 + (3 * i) % 13
        handles.append(engine.submit(
            base[i * 16:i * 16 + plen].astype(np.int32),
            args.max_new_tokens, temperature=args.temperature,
            seed=args.seed + i))
    streamed = list(handles[0])  # iterating drives the engine
    print(f"[serve] request 0 streamed tokens: {streamed}")
    engine.run_until_complete()
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    dt = time.perf_counter() - t0
    for i, h in enumerate(handles):
        print(f"[serve] request {i} (prompt {h.prompt.size} toks): "
              f"{h.tokens}")
    total = sum(len(h.tokens) for h in handles)
    m = engine.metrics()
    extra = ""
    if args.paged:
        pool = engine.page_pool
        extra = (f" | paged: hit tokens={engine.stats['prefix_hit_tokens']}"
                 f", pool {pool.used_pages}/{pool.num_pages} pages, "
                 f"{engine.stats['page_pressure_vacates']} pressure vacates,"
                 f" kernel launches {m['kernel_launches']}")
    print(f"[serve] {len(handles)} requests, {total} tokens in {dt:.3f}s "
          f"({total / dt:.1f} tokens/s on {engine.device}) | decode steps="
          f"{engine.stats['decode_steps']} prefill chunks="
          f"{engine.stats['prefill_chunks']}{extra}")
    return m


if __name__ == "__main__":
    main()
