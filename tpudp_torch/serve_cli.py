"""Serve concurrent GPT-2 or LLaMA requests with the port's engine —
the counterpart of ``examples/serve_gpt2.py``.

    # On the card (the default device), paged KV through the CUDA kernels:
    python -m tpudp_torch.serve_cli --layers 12 --d-model 768 --heads 12 \\
        --vocab 50257 --seq-len 1024 --paged 512

    # LLaMA with grouped-query heads over an int8 page pool (the int8
    # kernel variants on the card):
    python -m tpudp_torch.serve_cli --family llama --layers 12 \\
        --d-model 768 --heads 12 --kv-heads 3 --vocab 32000 \\
        --seq-len 1024 --paged 512 --kv-dtype int8

    # CPU rehearsal at a tiny size (plain PyTorch attention):
    python -m tpudp_torch.serve_cli --device cpu --layers 2 --d-model 64 \\
        --vocab 256 --paged 64

    # Speculative decoding: n-gram drafts verified as a token tree (the
    # paged-tree kernel on the card):
    python -m tpudp_torch.serve_cli --device cpu --paged 64 \\
        --speculate-k 3 --speculate-tree fork2x2

    # Fused decode windows of up to 8 iterations (on the card one CUDA
    # graph of a decode iteration, replayed; on the CPU its eager loop):
    python -m tpudp_torch.serve_cli --device cpu --layers 2 --d-model 64 \\
        --vocab 256 --paged 64 --decode-fuse 8 --fuse-stream

    # Tenancy: two classes, the first listed the highest priority; the
    # low tier submits first and is preempted by the high one:
    python -m tpudp_torch.serve_cli --device cpu --paged 64 \
        --tenants high:2,low:6

    # The dense prefix cache (a pool of 32 blocks; not with --paged):
    python -m tpudp_torch.serve_cli --device cpu --prefix-cache-blocks 32

    # Serve the weights train_cli --save-checkpoint saved (the newest
    # step_N under the directory), with the training run's widths:
    python -m tpudp_torch.serve_cli --layers 12 --d-model 768 \
        --vocab 50257 --seq-len 1024 --paged 512 --checkpoint-dir ckpt/gpt2

Without ``--checkpoint-dir`` the weights are random, drawn from
``--seed``: the output shows the serving path, not a trained model.
With it the params come from the newest ``step_N`` there
(``restore_params``, by JAX names, then ``params_from_jax``), after the
checks of ``examples/generate_gpt2.py``: the family by the presence of
``wpe``, the layer count and ``wte``'s shape, ``wk``'s width against
``--kv-heads`` (LLaMA) and ``wpe``'s length against ``--seq-len``
(GPT-2); a mismatch exits with an ``error:`` line naming the checkpoint.
Request 0's tokens stream as they land while the others decode in the
same batched steps.
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from tpudp_torch.models import gpt2, llama
from tpudp_torch.serve import Engine, TenantClass
from tpudp_torch.serve.engine import resolve_device
from tpudp_torch.utils.checkpoint import latest_step_dir, restore_params
from tpudp_torch.utils.compile_cache import enable_persistent_cache
from tpudp_torch.utils.device_lock import acquire_for_process


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--family", choices=["gpt2", "llama"], default="gpt2",
                   help="decoder family")
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--d-model", type=int, default=64)
    p.add_argument("--heads", type=int, default=None,
                   help="attention heads (default d_model // 64, at least "
                        "--kv-heads)")
    p.add_argument("--kv-heads", type=int, default=None,
                   help="grouped-query KV heads (llama family; default "
                        "--heads)")
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
    p.add_argument("--prefix-cache-blocks", type=int, default=0,
                   help="the dense prefix cache: a pool of this many KV "
                        "blocks, so requests sharing a prompt prefix copy "
                        "cached blocks instead of re-prefilling (0: off; "
                        "not with --paged)")
    p.add_argument("--tenants", type=str, default=None,
                   help="comma-separated name:count pairs (e.g. "
                        "high:2,low:6): each name a TenantClass, the first "
                        "listed the highest priority, and that many "
                        "requests submitted into it, lowest tier first "
                        "(overrides --requests)")
    p.add_argument("--kv-dtype", choices=["int8"], default=None,
                   help="store the page pool in int8 with per-vector "
                        "scales (needs --paged)")
    p.add_argument("--speculate-k", type=int, default=0, metavar="K",
                   help="speculative decoding with up to K n-gram draft "
                        "tokens per step (0: off)")
    p.add_argument("--speculate-tree", default=None, metavar="NAME",
                   help="verify drafts as this token tree (chain2, "
                        "chain3, chain4, fork2x2, fork3+1); needs "
                        "--speculate-k >= its depth")
    p.add_argument("--decode-fuse", type=int, default=1, metavar="N",
                   help="run pure-decode iterations as fused windows of up "
                        "to N decode iterations (1: off)")
    p.add_argument("--fuse-stream", action="store_true",
                   help="keep the windows' (slot, token) commits in "
                        "Engine.fused_stream (needs --decode-fuse >= 2)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu for a rehearsal)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint-dir", type=str, default=None,
                   help="serve the params of the newest step_N checkpoint "
                        "there (random weights from --seed without it)")
    args = p.parse_args(argv)
    if args.requests < 1:
        p.error("--requests must be >= 1")
    if args.temperature < 0:
        p.error("--temperature must be >= 0")
    if args.paged < 0:
        p.error("--paged must be >= 0")
    if args.kv_dtype and not args.paged:
        p.error("--kv-dtype requires --paged")
    if args.kv_heads is not None and args.family != "llama":
        p.error("--kv-heads is a llama-family option")
    if args.speculate_k < 0:
        p.error("--speculate-k must be >= 0")
    if args.decode_fuse < 1:
        p.error("--decode-fuse must be >= 1")
    if args.fuse_stream and args.decode_fuse < 2:
        p.error("--fuse-stream requires --decode-fuse >= 2")
    args.tenant_spec = tenant_spec(args.tenants)
    return args


def tenant_spec(text: str | None) -> list[tuple[str, int]]:
    """``--tenants``' ``[(name, count)]``, with the example's errors."""
    spec: list[tuple[str, int]] = []
    for part in text.split(",") if text else ():
        try:
            name, count = part.split(":")
            count = int(count)
        except ValueError:
            raise SystemExit(
                f"error: --tenants wants name:count pairs "
                f"(e.g. high:2,low:6), got {part!r}") from None
        if not name or count < 1:
            raise SystemExit(f"error: bad --tenants entry {part!r}")
        spec.append((name, count))
    if len({n for n, _ in spec}) != len(spec):
        raise SystemExit("error: duplicate tenant name in --tenants")
    return spec


def _check_checkpoint(path: str, params: dict, args, cfg) -> None:
    """``examples/generate_gpt2.py``'s checks of a target-free restore
    against the flags; each mismatch exits naming the checkpoint."""
    is_llama = "wpe" not in params
    if (args.family == "llama") != is_llama:
        raise SystemExit(
            f"error: checkpoint {path} is a "
            f"{'llama' if is_llama else 'gpt2'}-family checkpoint (position "
            f"table {'absent' if is_llama else 'present'}), but --family "
            f"{args.family} was passed — pass the training run's --family")
    n_layers = sum(1 for k in params if k.startswith("h_"))
    wte = tuple(params["wte"]["embedding"].shape)
    if n_layers != cfg.num_layers or wte != (cfg.vocab_size, cfg.d_model):
        raise SystemExit(
            f"error: checkpoint {path} holds {n_layers} layers and wte "
            f"{wte}, but the flags describe {cfg.num_layers} layers / vocab "
            f"{cfg.vocab_size} x d_model {cfg.d_model} — pass the training "
            "run's --layers/--d-model/--vocab")
    if args.family == "llama":
        dh = cfg.d_model // cfg.num_heads
        width = params["h_0"]["attn"]["wk"]["kernel"].shape[1]
        if width != cfg.kv_heads * dh:
            raise SystemExit(
                f"error: checkpoint {path} holds wk width {width} (= "
                f"{width // dh} KV heads at head dim {dh}), but the flags "
                f"describe {cfg.kv_heads} KV heads — pass the training "
                "run's --kv-heads/--heads")
    else:
        wpe = tuple(params["wpe"]["embedding"].shape)
        if wpe[0] < cfg.max_seq_len or wpe[1] != cfg.d_model:
            raise SystemExit(
                f"error: checkpoint {path} holds wpe {wpe}, but the flags "
                f"describe max_seq_len {cfg.max_seq_len} x d_model "
                f"{cfg.d_model} — pass a --seq-len <= the training run's "
                "(positions past the trained table have no embedding) with "
                "its --d-model")


def model_config(args, num_heads: int):
    """The model configuration the flags describe."""
    common = dict(vocab_size=args.vocab, max_seq_len=args.seq_len,
                  num_layers=args.layers, d_model=args.d_model,
                  num_heads=num_heads, dtype=getattr(torch, args.dtype))
    if args.family == "llama":
        return llama.LlamaConfig(num_kv_heads=args.kv_heads, **common)
    return gpt2.GPT2Config(**common)


def load_model(args, cfg, device, what: str = "serving"):
    """A model of ``cfg`` on ``device``: random weights from ``--seed``,
    or the checked params of ``--checkpoint-dir``'s newest ``step_N``.
    Returns ``(model, the checkpoint path or None)``."""
    family = llama if args.family == "llama" else gpt2
    if not args.checkpoint_dir:
        return family.build(cfg, args.seed, device), None
    latest = latest_step_dir(args.checkpoint_dir)
    if not latest:
        raise SystemExit(
            f"error: no step_N checkpoint under {args.checkpoint_dir!r} — "
            f"{what} random weights would be misleading; drop "
            "--checkpoint-dir for an explicit random-init demo")
    params = restore_params(latest)
    _check_checkpoint(latest, params, args, cfg)
    model = (llama.Llama(cfg) if family is llama else gpt2.GPT2(cfg))
    model.load_state_dict(family.params_from_jax(params))
    return model.to(device), latest


def build_model(args, device):
    """The model the flags describe, on ``device`` (:func:`load_model`);
    ``--heads`` defaults to ``d_model // 64``, at least ``--kv-heads``."""
    cfg = model_config(args, args.heads or max(args.d_model // 64,
                                               args.kv_heads or 1))
    return load_model(args, cfg, device)


def request_prompts(args, n: int | None = None) -> list[np.ndarray]:
    """The demo's ``n`` (default ``--requests``) prompts of 4-16 tokens,
    from ``--seed``."""
    rng = np.random.default_rng(args.seed)
    base = rng.integers(0, args.vocab, size=4096)
    return [base[i * 16:i * 16 + 4 + (3 * i) % 13].astype(np.int32)
            for i in range(args.requests if n is None else n)]


def main(argv=None) -> dict:
    """Serve the demo's requests; returns the engine's ``metrics()`` with
    each request's ``tokens`` and ``prompts`` added."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    enable_persistent_cache()
    acquire_for_process(device)
    model, restored = build_model(args, device)
    # A chunk dividing --seq-len, so the engine's round-down of max_len
    # strands no position the flags say exists.
    spec = args.tenant_spec
    # The first listed class gets the highest priority.
    tenants = ({name: TenantClass(priority=len(spec) - 1 - i)
                for i, (name, _) in enumerate(spec)} if spec else None)
    engine = Engine(model, device=device,
                    num_slots=args.num_slots,
                    prefill_chunk=math.gcd(args.prefill_chunk, args.seq_len),
                    kv_pages=args.paged, kv_dtype=args.kv_dtype,
                    prefix_cache_blocks=args.prefix_cache_blocks,
                    speculate_k=args.speculate_k,
                    speculate_tree=args.speculate_tree,
                    decode_fuse=args.decode_fuse,
                    fuse_stream=args.fuse_stream, tenants=tenants)
    weights = (f"restored params from {restored}" if restored else
               f"RANDOM-INIT weights from seed {args.seed}")
    print(f"[serve] family={args.family} {weights} on {engine.device}; "
          f"paged_attn="
          f"{engine.paged_attn if args.paged else 'dense arena'}"
          f"{f', kv_dtype={args.kv_dtype}' if args.kv_dtype else ''}")
    # Without --tenants: --requests unclassed submits.  With it: the
    # lowest tier submits first and takes the slots, then each higher
    # tier arrives and preempts.
    plan = list(reversed(spec)) if spec else [(None, args.requests)]
    prompts = request_prompts(args, sum(n for _, n in plan))
    t0 = time.perf_counter()
    handles = []
    for tname, count in plan:
        for _ in range(count):
            i = len(handles)
            handles.append(engine.submit(
                prompts[i], args.max_new_tokens,
                temperature=args.temperature, seed=args.seed + i,
                tenant=tname))
        if tname is not None:
            engine.step()  # this tier occupies slots before the next
    streamed = list(handles[0])  # iterating drives the engine
    print(f"[serve] request 0 streamed tokens: {streamed}")
    engine.run_until_complete()
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    dt = time.perf_counter() - t0
    for i, h in enumerate(handles):
        tier = f", tenant={h.tenant}" if h.tenant is not None else ""
        pre = f", preempted x{h.preemptions}" if h.preemptions else ""
        print(f"[serve] request {i} (prompt {h.prompt.size} toks{tier}"
              f"{pre}): {h.tokens}")
    for name, st in engine.tenant_stats.items():
        print(f"[serve] tenant {name}: submitted={st['submitted']} "
              f"preempted={st['preempted']} tokens={st['tokens']}")
    total = sum(len(h.tokens) for h in handles)
    m = engine.metrics()
    extra = ""
    if args.paged:
        pool = engine.page_pool
        extra = (f" | paged: hit tokens={engine.stats['prefix_hit_tokens']}"
                 f", pool {pool.used_pages}/{pool.num_pages} pages, "
                 f"{engine.stats['page_pressure_vacates']} pressure vacates,"
                 f" kernel launches {m['kernel_launches']}")
    spec = ""
    if args.speculate_k:
        rate = engine.acceptance_rate
        spec = (f" | verify steps={engine.stats['verify_steps']} tree "
                f"verify steps={engine.stats['tree_verify_steps']} draft "
                f"acceptance="
                f"{'n/a' if rate is None else format(rate, '.2f')}")
    if args.prefix_cache_blocks:
        spec += (f" | prefix hit tokens="
                 f"{engine.stats['prefix_hit_tokens']} (pool "
                 f"{engine.prefix_cache.used_blocks}/"
                 f"{args.prefix_cache_blocks} blocks)")
    fused = ""
    if args.decode_fuse > 1:
        fused = (f" | fused windows={engine.stats['fused_windows']} fused "
                 f"steps={engine.stats['fused_steps']}"
                 f"{' (CUDA graph)' if engine.device.type == 'cuda' else ''}")
        if engine.fused_stream is not None:
            fused += f", stream holds {len(engine.fused_stream)}"
    print(f"[serve] {len(handles)} requests, {total} tokens in {dt:.3f}s "
          f"({total / dt:.1f} tokens/s on {engine.device}) | decode steps="
          f"{engine.stats['decode_steps']} prefill chunks="
          f"{engine.stats['prefill_chunks']}{extra}{spec}{fused}")
    return {**m, "tokens": [h.tokens for h in handles], "prompts": prompts}


if __name__ == "__main__":
    main()
