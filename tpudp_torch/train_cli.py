"""Train a GPT-2 or LLaMA LM with the port — the counterpart of
``examples/train_gpt2.py``, every parallelism rung from one script.

    # On the card (the default device), GPT-2 small with flash attention:
    python -m tpudp_torch.train_cli --layers 12 --d-model 768 --heads 12 \\
        --vocab 50257 --seq-len 2048 --batch-size 4 --attn flash

    # CPU rehearsal at a tiny size (the kernels' plain versions):
    python -m tpudp_torch.train_cli --device cpu --layers 2 --d-model 64 \\
        --vocab 256 --seq-len 128 --steps 3 --attn flash

    # Train, then save the final state for serve_cli --checkpoint-dir:
    python -m tpudp_torch.train_cli --attn flash --steps 20 \\
        --save-checkpoint ckpt/gpt2

    # The sharded rungs over 4 local gloo ranks on the CPU: the --mesh
    # second axis is the strategy's axis (model / pipe / expert / seq):
    python -m tpudp_torch.train_cli --device cpu --num-devices 4 \\
        --mesh 2x2 --strategy tp --layers 2 --d-model 64 --vocab 256 \\
        --seq-len 64 --steps 3
    ... --mesh 2x2 --strategy pp --microbatches 2
    ... --mesh 4x1 --strategy fsdp          # or zero1
    ... --mesh 2x2 --strategy ep            # MoE, max(2s, 2) experts
    ... --mesh 2x2 --seq-parallel           # ring attention over seq

    # LLaMA (RoPE, RMSNorm, SwiGLU, untied head) with grouped-query
    # attention; tp by llama_tp_rules, sp, fsdp and zero1 as above:
    python -m tpudp_torch.train_cli --family llama --kv-heads 3 \\
        --layers 12 --d-model 768 --heads 12 --vocab 32000 --attn flash

    # The chunked vocabulary loss (the DP path, GPT-2's tied head):
    python -m tpudp_torch.train_cli --attn flash --loss-chunk 1024

    # Train on a local token file, then greedily sample 32 tokens:
    python -m tpudp_torch.train_cli --attn flash --tokens-file tokens.bin \
        --sample 32

The corpus is the example's deterministic synthetic one (a 4096-token
random base tiled 64 times), or with ``--tokens-file`` the file's uint16
tokens modulo ``--vocab``, and the batches are drawn as the example
draws them; weights are random, from ``--seed``.  ``--sample N`` (GPT-2,
the DP path) greedily decodes N tokens after training from the corpus'
first ``min(16, --seq-len)`` tokens with ``models.generate.generate``
(a flash-trained model decodes through a dense-attention twin holding
its weights: decode runs the dense math).  SGD with momentum 0.9
and no weight decay, as the example trains.  ``--save-checkpoint DIR``
checks that DIR is writable before any compute and saves the final state
to ``DIR/step_<steps>`` (``tpudp_torch.utils.checkpoint``);
``--skip-nonfinite N`` skips updates whose gradients are not finite
(``make_optimizer(skip_nonfinite=N)``; dp, zero1 and sp only, as the
example allows).  ``--family llama`` trains a LLaMA (``--kv-heads`` its
KV heads; dp, sp, tp, fsdp and zero1, as the example allows);
``--loss-chunk N`` computes the GPT-2 DP path's cross entropy over
N-token chunks (``make_train_step(loss_chunk=)``).  ``--num-devices N``
spawns N local ranks (gloo on the CPU; NCCL on the card, one card a
rank), and ``--master``,
``--num-nodes`` and ``--rank`` join a multi-process run, as the Parts'
CLI does; every rank draws the same global batches and trains on its
block, and rank 0 prints.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from tpudp_torch.models import gpt2, llama
from tpudp_torch.models.generate import generate
from tpudp_torch.serve.engine import resolve_device
from tpudp_torch.train import init_state, make_optimizer, make_train_step
from tpudp_torch.utils.checkpoint import ensure_writable, save_checkpoint
from tpudp_torch.utils.compile_cache import enable_persistent_cache
from tpudp_torch.utils.device_lock import acquire_for_process

STRATEGY_AXIS = {"tp": "model", "pp": "pipe", "ep": "expert"}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mesh", type=str, default=None,
                   help="'DxS' data x strategy-axis mesh (default: the "
                        "ranks x 1)")
    p.add_argument("--seq-parallel", action="store_true",
                   help="shard the sequence axis + ring attention")
    p.add_argument("--strategy", default="dp",
                   choices=["dp", "tp", "pp", "fsdp", "zero1", "ep"],
                   help="parallelism rung (tpudp_torch.strategy); the "
                        "--mesh second axis is the strategy axis")
    p.add_argument("--microbatches", type=int, default=2,
                   help="pipeline microbatches (--strategy pp)")
    p.add_argument("--family", default="gpt2", choices=["gpt2", "llama"],
                   help="decoder family: gpt2 (learned positions, "
                        "LayerNorm, GELU, tied head) or llama (RoPE, "
                        "RMSNorm, SwiGLU, GQA via --kv-heads, untied "
                        "head); llama supports dp/sp/tp/fsdp/zero1")
    p.add_argument("--kv-heads", type=int, default=None,
                   help="GQA KV-head count (llama; default --heads)")
    p.add_argument("--loss-chunk", type=int, default=None, metavar="N",
                   help="chunked vocabulary loss over N-token chunks "
                        "(the gpt2 family's DP path)")
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
    p.add_argument("--skip-nonfinite", type=int, default=None, metavar="N",
                   help="skip updates whose gradients hold NaN/Inf; after N "
                        "consecutive bad steps the NaN propagates")
    p.add_argument("--sample", type=int, default=0, metavar="N",
                   help="after training, greedily generate N tokens from a "
                        "corpus prompt via the KV-cached decode path")
    p.add_argument("--tokens-file", type=str, default=None,
                   help="train on this file's uint16 tokens (modulo "
                        "--vocab) instead of the synthetic corpus")
    p.add_argument("--save-checkpoint", type=str, default=None,
                   metavar="DIR",
                   help="save the final state to DIR/step_<steps> "
                        "(restorable by serve_cli --checkpoint-dir DIR)")
    p.add_argument("--num-devices", type=int, default=None,
                   help="spawn N local ranks, one process each (default 1)")
    p.add_argument("--master", type=str, default=None,
                   help="rendezvous host of a multi-process run")
    p.add_argument("--num-nodes", type=int, default=None,
                   help="ranks of a multi-process run (with --master)")
    p.add_argument("--rank", type=int, default=None,
                   help="this process's rank (with --master)")
    args = p.parse_args(argv)
    for name in ("steps", "log_every", "batch_size", "seq_len",
                 "microbatches"):
        if getattr(args, name) < 1:
            p.error(f"--{name.replace('_', '-')} must be >= 1")
    check_args(args)
    return args


def mesh_dims(args, world: int) -> tuple[int, int]:
    """``(D, S)`` of ``--mesh DxS`` (default ``(world, 1)``)."""
    if not args.mesh:
        return world, 1
    try:
        d, s = (int(x) for x in args.mesh.split("x"))
    except ValueError:
        raise SystemExit(f"error: --mesh takes DxS, e.g. 2x2 (got "
                         f"{args.mesh!r})") from None
    if d < 1 or s < 1:
        raise SystemExit(f"error: --mesh {args.mesh} needs sizes >= 1")
    return d, s


def check_args(args) -> None:
    """The example's flag checks (``examples/train_gpt2.py``)."""
    if args.seq_parallel and args.strategy != "dp":
        raise SystemExit("error: --seq-parallel is its own rung; drop "
                         "--strategy (or use --strategy dp)")
    if args.family == "llama":
        if args.strategy in ("pp", "ep"):
            raise SystemExit(f"error: --strategy {args.strategy} is a "
                             "gpt2-family path (pipeline stage twins / MoE "
                             "MLP); use --family gpt2")
        if args.loss_chunk is not None:
            raise SystemExit("error: --loss-chunk needs the tied-embedding "
                             "head (gpt2 family)")
        if args.sample:
            raise SystemExit("error: --sample drives the GPT-2 KV-cached "
                             "decode path; use --family gpt2")
    elif args.kv_heads is not None:
        raise SystemExit("error: --kv-heads (GQA) is a llama-family option")
    if args.loss_chunk is not None and (args.strategy != "dp"
                                        or args.seq_parallel):
        raise SystemExit("error: --loss-chunk is a DP-path option")
    if args.loss_chunk is not None and args.loss_chunk < 1:
        raise SystemExit("error: --loss-chunk must be >= 1")
    if args.sample:
        # Refused up front: failing after the training run wastes it.
        if args.seq_parallel:
            raise SystemExit(
                "error: --sample needs the dense DP path (generate() does "
                "not drive ring attention); drop --seq-parallel")
        if args.sample + min(16, args.seq_len) > args.seq_len:
            raise SystemExit(
                f"error: --sample {args.sample} + prompt "
                f"{min(16, args.seq_len)} exceeds --seq-len {args.seq_len} "
                "(the model's position table)")
        if args.strategy != "dp":
            raise SystemExit("error: --sample needs the DP path (generate() "
                             "drives replicated params)")
    if args.skip_nonfinite is not None and args.strategy not in ("dp",
                                                                 "zero1"):
        raise SystemExit("error: --skip-nonfinite supports the dp/zero1 "
                         f"strategies only (got {args.strategy!r})")
    if args.num_devices is not None and args.num_devices < 1:
        raise SystemExit(f"error: --num-devices must be >= 1 (got "
                         f"{args.num_devices})")
    multi_node = args.master is not None or (args.num_nodes or 1) > 1
    if multi_node and (args.num_devices or 1) > 1:
        raise SystemExit("error: --num-devices spawns local ranks; with "
                         "--master/--num-nodes each process is one rank")
    if multi_node and (args.master is None or args.num_nodes is None
                       or args.rank is None):
        raise SystemExit("error: a multi-process run needs --master, "
                         "--num-nodes and --rank")
    world = (args.num_nodes if multi_node else args.num_devices) or 1
    d, s = mesh_dims(args, world)
    if d * s != world:
        raise SystemExit(f"error: --mesh {d}x{s} needs {d * s} ranks; the "
                         f"run has {world} (--num-devices / --num-nodes)")
    if args.strategy == "dp" and not args.seq_parallel and s != 1:
        raise SystemExit(f"error: the dp rung's mesh is 1-D (--mesh "
                         f"{world}x1); --mesh {d}x{s} names a second axis "
                         "for --strategy or --seq-parallel")
    if args.strategy == "pp" and args.layers % s:
        raise SystemExit(f"error: --layers {args.layers} must divide into "
                         f"{s} pipeline stages")
    if (args.batch_size % (d * s if args.strategy in ("fsdp", "zero1",
                                                      "ep") else d)):
        raise SystemExit(f"error: --batch-size {args.batch_size} must split "
                         f"over the mesh's {d}x{s} data ranks")


def main(argv=None) -> list[float] | None:
    """Train; print one ``step N: loss L (T tok/s)`` line per log window
    and return the logged window losses (None where it spawned local
    ranks, which print)."""
    from tpudp_torch.cli import spawn_ranks
    from tpudp_torch.mesh import PORT

    args = parse_args(argv)
    if args.master is not None:
        return train(args, args.rank, args.num_nodes,
                     f"tcp://{args.master}:{PORT}")["losses"]
    local = args.num_devices or 1
    if local == 1:
        return train(args)["losses"]
    if args.device == "cuda" and local > torch.cuda.device_count():
        raise SystemExit(
            f"error: --num-devices {local} needs {local} cards (NCCL takes "
            f"one card a rank; this machine has "
            f"{torch.cuda.device_count()}) — pass --device cpu for gloo "
            "ranks on the CPU")
    if args.save_checkpoint:
        ensure_writable(args.save_checkpoint)
    spawn_ranks(_rank_entry, local, args)
    return None


def _rank_entry(args, rank: int, world: int, init_method: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    try:
        train(args, rank, world, init_method)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _model_config(args, s: int):
    common = dict(vocab_size=args.vocab, max_seq_len=args.seq_len,
                  num_layers=args.layers,
                  num_heads=args.heads or max(args.d_model // 64, 1),
                  d_model=args.d_model, dtype=getattr(torch, args.dtype),
                  attn_impl="ring" if args.seq_parallel else args.attn,
                  seq_axis="seq" if args.seq_parallel else None)
    if args.family == "llama":
        return llama.LlamaConfig(num_kv_heads=args.kv_heads, **common)
    moe = {}
    if args.strategy == "ep":
        moe = dict(mlp_impl="moe", num_experts=max(2 * s, 2),
                   capacity_factor=2.0, expert_axis="expert")
    return gpt2.GPT2Config(**common, **moe)


def _rung(args, model, spec, state, world: int):
    """``(state, step, shard_for, label)`` of the run's rung."""
    from tpudp_torch.mesh import initialize_distributed, make_mesh, \
        make_mesh_nd
    from tpudp_torch.parallel.sharded import rows

    d, s = mesh_dims(args, world)
    if args.strategy == "dp" and not args.seq_parallel and world == 1:
        return (state, make_train_step(model, spec,
                                       loss_chunk=args.loss_chunk),
                (lambda a: a), "dp")
    if world == 1:  # the sharded rungs' mesh: a group of this process
        initialize_distributed(next(model.parameters()).device)
    if args.strategy != "dp":
        from tpudp_torch.parallel.tensor import gpt2_tp_rules, llama_tp_rules
        from tpudp_torch.strategy import build_strategy

        shape = ({"data": d * s} if args.strategy in ("fsdp", "zero1")
                 else {"data": d, STRATEGY_AXIS[args.strategy]: s})
        options = {}
        if args.strategy == "tp":
            options["rules"] = (llama_tp_rules() if args.family == "llama"
                                else gpt2_tp_rules())
        if args.strategy == "pp":
            options["n_microbatches"] = args.microbatches
        built = build_strategy(args.strategy, model, spec,
                               make_mesh_nd(shape), state, donate=False,
                               **options)
        return (built.state, built.train_step, built.shard_for,
                f"{args.strategy} mesh {shape}")
    if args.seq_parallel:
        from tpudp_torch.strategy import build_strategy

        built = build_strategy("sp", model, spec,
                               make_mesh_nd({"data": d, "seq": s}), state)
        return (built.state, built.train_step, built.shard_for,
                f"sp mesh {{'data': {d}, 'seq': {s}}}")
    mesh = make_mesh()
    state = init_state(model, spec, mesh)
    return (state, make_train_step(model, spec, mesh, "allreduce",
                                   loss_chunk=args.loss_chunk),
            lambda a: rows(a, mesh.rank, mesh.size), f"dp over {world} ranks")


def train(args: argparse.Namespace, rank: int = 0, world: int = 1,
          init_method: str | None = None) -> dict:
    """The run of :func:`main` on parsed ``args``, as rank ``rank`` of
    ``world`` (meeting at ``init_method``): ``{"losses", "model",
    "state", "checkpoint"}`` (the saved path, or None)."""
    if args.save_checkpoint:
        ensure_writable(args.save_checkpoint)
    device = resolve_device(args.device)
    if device.type == "cuda" and world > 1:
        device = torch.device("cuda", rank % torch.cuda.device_count())
    enable_persistent_cache()
    acquire_for_process(device)
    if device.type == "cuda" and world > 1:
        torch.cuda.set_device(device)
    if world > 1:
        from tpudp_torch.mesh import initialize_distributed

        initialize_distributed(device, world, rank, init_method=init_method)
    _, s = mesh_dims(args, world)
    cfg = _model_config(args, s)
    family = llama if args.family == "llama" else gpt2
    model = family.build(cfg, args.seed, device)
    spec = make_optimizer(learning_rate=args.lr, momentum=0.9,
                          weight_decay=0.0, clip_norm=args.clip_norm,
                          skip_nonfinite=args.skip_nonfinite)
    n_params = sum(p.numel() for p in model.parameters())
    state, step, shard_for, label = _rung(args, model, spec,
                                          init_state(model, spec), world)
    say = print if rank == 0 else (lambda *a, **k: None)
    say(f"[{args.family}] params={n_params / 1e6:.1f}M device={device} "
        f"attn={cfg.attn_impl} seq_len={args.seq_len} "
        f"batch={args.batch_size} dtype={args.dtype} rung={label}",
        flush=True)

    corpus = load_corpus(args)
    rng = np.random.default_rng(1)

    def sample_batch():
        starts = rng.integers(0, len(corpus) - args.seq_len - 1,
                              args.batch_size)
        toks = np.stack([corpus[s:s + args.seq_len] for s in starts])
        tgts = np.stack([corpus[s + 1:s + args.seq_len + 1] for s in starts])
        return (torch.as_tensor(shard_for(toks), device=device),
                torch.as_tensor(shard_for(tgts), device=device))

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
            say(f"step {it}: loss {losses[-1]:.4f} ({tok_s:,.0f} tok/s)",
                flush=True)
            prev_cum, t0 = cum, time.perf_counter()
    ckpt = None
    if args.save_checkpoint:
        ckpt = save_checkpoint(
            os.path.join(args.save_checkpoint, f"step_{args.steps}"), state)
        say(f"[{args.family}] saved checkpoint {ckpt}", flush=True)
    sample = None
    if args.sample and rank == 0:
        prompt_len = min(16, args.seq_len)
        prompt = torch.as_tensor(corpus[:prompt_len][None], device=device)
        out = generate(decode_twin(state.model), prompt.long(), args.sample)
        sample = out[0, prompt_len:].tolist()
        say(f"[gpt2] greedy sample (prompt {prompt_len} tokens): {sample}",
            flush=True)
    return {"losses": losses, "model": state.model, "state": state,
            "checkpoint": ckpt, "sample": sample}


def load_corpus(args) -> np.ndarray:
    """The example's corpus: ``--tokens-file``'s uint16 tokens modulo
    ``--vocab``, or the synthetic one (a 4096-token random base from
    seed 0, tiled 64 times)."""
    if args.tokens_file:
        corpus = np.fromfile(args.tokens_file, dtype=np.uint16)
        return corpus.astype(np.int64) % args.vocab
    rng = np.random.default_rng(0)
    return np.tile(rng.integers(0, args.vocab, size=4096), 64)


def decode_twin(model):
    """``model`` for ``generate()``: itself with dense attention, else a
    dense-attention twin holding the same weights (decode runs the dense
    math; ``validate_decode_config`` refuses a flash config)."""
    cfg = model.config
    if cfg.attn_impl == "dense":
        return model
    twin = type(model)(dataclasses.replace(cfg, attn_impl="dense"))
    twin.load_state_dict(model.state_dict())
    return twin.to(next(model.parameters()).device)


if __name__ == "__main__":
    main()
