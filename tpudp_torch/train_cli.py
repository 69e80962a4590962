"""Train a GPT-2 LM with the port — the counterpart of the single-device
data-parallel path of ``examples/train_gpt2.py``.

    # On the card (the default device), GPT-2 small with flash attention:
    python -m tpudp_torch.train_cli --layers 12 --d-model 768 --heads 12 \\
        --vocab 50257 --seq-len 2048 --batch-size 4 --attn flash

    # CPU rehearsal at a tiny size (the kernels' plain versions):
    python -m tpudp_torch.train_cli --device cpu --layers 2 --d-model 64 \\
        --vocab 256 --seq-len 128 --steps 3 --attn flash

The corpus is the example's deterministic synthetic one (a 4096-token
random base tiled 64 times) and the batches are drawn as the example
draws them; weights are random, from ``--seed``.  SGD with momentum 0.9
and no weight decay, as the example trains.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from tpudp_torch.models.gpt2 import GPT2Config, build
from tpudp_torch.serve.engine import resolve_device
from tpudp_torch.train import init_state, make_optimizer, make_train_step


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--layers", type=int, default=12)
    p.add_argument("--d-model", type=int, default=768)
    p.add_argument("--heads", type=int, default=None,
                   help="attention heads (default d_model // 64)")
    p.add_argument("--vocab", type=int, default=50_257)
    p.add_argument("--seq-len", type=int, default=1024)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--clip-norm", type=float, default=None,
                   help="global-norm gradient clipping")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--dtype", choices=["float32", "bfloat16"],
                   default="bfloat16")
    p.add_argument("--attn", choices=["dense", "flash"], default="dense",
                   help="attention impl (GPT2Config.attn_impl); flash runs "
                        "the K1-K3 kernels when --seq-len divides by 128")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu for a rehearsal)")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    for name in ("steps", "log_every", "batch_size", "seq_len"):
        if getattr(args, name) < 1:
            p.error(f"--{name.replace('_', '-')} must be >= 1")
    return args


def main(argv=None) -> list[float]:
    """Train; print one ``step N: loss L (T tok/s)`` line per log window
    and return the logged window losses."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = GPT2Config(vocab_size=args.vocab, max_seq_len=args.seq_len,
                     num_layers=args.layers,
                     num_heads=args.heads or max(args.d_model // 64, 1),
                     d_model=args.d_model, dtype=getattr(torch, args.dtype),
                     attn_impl=args.attn)
    model = build(cfg, args.seed, device)
    spec = make_optimizer(learning_rate=args.lr, momentum=0.9,
                          weight_decay=0.0, clip_norm=args.clip_norm)
    state = init_state(model, spec)
    step = make_train_step(model, spec)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[gpt2] params={n_params / 1e6:.1f}M device={device} "
          f"attn={args.attn} seq_len={args.seq_len} "
          f"batch={args.batch_size} dtype={args.dtype}")

    rng = np.random.default_rng(0)  # the example's synthetic corpus
    corpus = np.tile(rng.integers(0, args.vocab, size=4096), 64)
    rng = np.random.default_rng(1)

    def sample_batch():
        starts = rng.integers(0, len(corpus) - args.seq_len - 1,
                              args.batch_size)
        toks = np.stack([corpus[s:s + args.seq_len] for s in starts])
        tgts = np.stack([corpus[s + 1:s + args.seq_len + 1] for s in starts])
        return (torch.as_tensor(toks, device=device),
                torch.as_tensor(tgts, device=device))

    losses = []
    prev_cum, t0 = 0.0, time.perf_counter()
    for it in range(1, args.steps + 1):
        state, _ = step(state, *sample_batch())
        if it % args.log_every == 0:
            cum = float(state.loss_sum)  # the one host read per window
            if not np.isfinite(cum):
                raise FloatingPointError(f"training loss is {cum} at step "
                                         f"{it}")
            dt = time.perf_counter() - t0
            tok_s = args.log_every * args.batch_size * args.seq_len / dt
            losses.append((cum - prev_cum) / args.log_every)
            print(f"step {it}: loss {losses[-1]:.4f} ({tok_s:,.0f} tok/s)",
                  flush=True)
            prev_cum, t0 = cum, time.perf_counter()
    return losses


if __name__ == "__main__":
    main()
