#!/usr/bin/env python3
"""The paged kernels' schedules on the card, and serving A/B runs.

    python3 chip_window_sweep.py sweep
    python3 chip_window_sweep.py wrappers DIR LABEL
    python3 chip_window_sweep.py serve DIR LABEL

``sweep`` times the paged-window kernel (K5, K5-int8) on the device
clock at ``chip_smoke.py``'s timing shapes — GPT-2 small prefill chunks
at depths 0, 144, 288 and 1,000 and its verify window of 8 slots, and
LLaMA-GQA's over int8 and float32 pools — under several caps of
``window_schedule``'s row tile and key split (``ROW_TILE_ROWS``,
``MAX_SPLITS``, ``BLOCKS_PER_SM``): one line per shape, ``device_ms``
and the row tile x splits of each cap.  Then one-token decode at GPT-2
small's and LLaMA-GQA's decode steps (int8 and float32 pools; 8 slots at
phase 4's decode depths, and at about 1,000 keys) by both block designs:
the paged-decode kernel (K4, K4-int8) under several caps of its key
split (``DECODE_MAX_SPLITS``), and the window kernel at one row under
its own (``MAX_SPLITS``), the other design it was chosen over:
``device_ms``, warps x splits and the largest error against the plain
version of each.

``wrappers`` times the paged-decode wrappers (K4 at GPT-2 small's decode
step, K4-int8 at LLaMA-GQA's over an int8 pool, as ``chip_smoke.py``'s
timing phase does, over 200 calls each) from the checkout at DIR:
``ms``, ``device_ms`` and ``host_ms``, tagged LABEL; run it on two
checkouts in turns (A, B, B, A) in one call to compare their host time
on one card.

``serve`` serves ``chip_smoke.py``'s phase-4 traffic (GPT-2 small on the
kernel engine, twice) and phase 4b's sequence speculation from the
checkout at DIR, then the plain engine once, printing tokens/s and TTFT
p50 tagged LABEL; run it on two checkouts in turns (A, B, B, A) in one
call to compare them on one card.  Needs one CUDA card and ``nvcc``.
"""

from __future__ import annotations

import os
import sys
from types import SimpleNamespace

# (ROW_TILE_ROWS, MAX_SPLITS, BLOCKS_PER_SM): no split, then caps around
# the chosen one.
CAPS = ((32, 16, 8), (16, 16, 8), (8, 1, 8), (8, 8, 8), (8, 16, 4),
        (8, 16, 8), (8, 16, 16), (8, 32, 8), (4, 16, 8))
LLAMA = SimpleNamespace(num_layers=12, num_heads=12, kv_heads=3, d_model=768)
# One-token decode: (kernel, most key splits): K4 without a split, with
# the chosen cap and with fewer or more; then the window kernel at one
# row (the design K4's block was chosen over) without and with its split.
DECODE_CAPS = (("decode", 1), ("decode", 4), ("decode", 8), ("decode", 16),
               ("window", 1), ("window", 16))


def sweep(np, torch, cs, pa) -> None:
    from tpudp_torch.models import gpt2

    cfg = gpt2.GPT2Config()
    prompts = cs.make_prompts(np, 0, cfg.vocab_size)
    decode = [p.size + cs.NEW_TOKENS // 2 for p in prompts]
    cases = {  # name -> (config, depths, rows, scalar depth, pool, kernel)
        "gpt2 prefill 0": (cfg, [0], 16, True, None, "paged_window"),
        "gpt2 prefill 144": (cfg, [144], 16, True, None, "paged_window"),
        "gpt2 prefill 288": (cfg, [288], 16, True, None, "paged_window"),
        "gpt2 prefill 1000": (cfg, [1000], 16, True, None, "paged_window"),
        "gpt2 verify": (cfg, decode, 5, False, None, "paged_window"),
        "llama int8 prefill 144": (LLAMA, [144], 16, True, "int8",
                                   "paged_window_int8"),
        "llama int8 prefill 1000": (LLAMA, [1000], 16, True, "int8",
                                    "paged_window_int8"),
        "llama int8 verify": (LLAMA, decode, 5, False, "int8",
                              "paged_window_int8"),
        "llama fp32 verify": (LLAMA, decode, 5, False, None, "paged_window"),
    }
    sms = pa._sm_count(torch.device("cuda"))
    chosen = (pa.ROW_TILE_ROWS, pa.MAX_SPLITS, pa.BLOCKS_PER_SM)
    for name, (c, depths, cur, scalar, pool, kernel) in cases.items():
        q, pages, table, pos = cs.timing_case(torch, c, depths, cur, scalar,
                                              "cuda", 2, pool)
        fn = pa.KERNELS[kernel]
        layers = pages[0].shape[0]
        n_keys = table.shape[1] * pages[0].shape[2]
        if scalar:  # a host depth, as the wrapper sees it
            n_keys = min(depths[0] + cur, n_keys)
        row = []
        for cap in CAPS:
            pa.ROW_TILE_ROWS, pa.MAX_SPLITS, pa.BLOCKS_PER_SM = cap
            sched = pa.window_schedule(q.shape[0], cur, q.shape[2],
                                       pages[0].shape[3], n_keys, sms)
            _, device_ms, _ = cs.time_ms(torch, lambda i: fn(
                q, *pages, table, pos, layer=i % layers))
            row.append(f"{'/'.join(map(str, cap))}: {device_ms:.4f} "
                       f"({sched.row_tile}x{sched.splits})")
        pa.ROW_TILE_ROWS, pa.MAX_SPLITS, pa.BLOCKS_PER_SM = chosen
        print(f"sweep {name}: " + "  ".join(row), flush=True)
        del pages
    sweep_decode(np, torch, cs, pa, cfg, decode, sms)


def sweep_decode(np, torch, cs, pa, cfg, decode, sms) -> None:
    """K4 and K4-int8, and the window kernel at one row, under
    DECODE_CAPS, at the decode depths and at about 1,000 keys a slot."""
    deep = [1000 - 3 * s for s in range(8)]
    cases = {  # name -> (config, depths, pool, kernel suffix)
        "gpt2 decode": (cfg, decode, None, ""),
        "gpt2 decode 1000": (cfg, deep, None, ""),
        "llama int8 decode": (LLAMA, decode, "int8", "_int8"),
        "llama int8 decode 1000": (LLAMA, deep, "int8", "_int8"),
        "llama fp32 decode": (LLAMA, decode, None, ""),
        "llama fp32 decode 1000": (LLAMA, deep, None, ""),
    }
    chosen = (pa.DECODE_MAX_SPLITS, pa.MAX_SPLITS)
    for name, (c, depths, pool, suffix) in cases.items():
        q, pages, table, pos = cs.timing_case(torch, c, depths, 1, False,
                                              "cuda", 1, pool)
        layers = pages[0].shape[0]
        b, _, h, _ = q.shape
        kv = pages[0].shape[3]
        n_keys = table.shape[1] * pages[0].shape[2]
        want = pa._einsum_paged(q, tuple(buf[0] for buf in pages), table,
                                pos, dtype=q.dtype, grouped=True)
        row = []
        for kernel, max_splits in DECODE_CAPS:
            fn = pa.KERNELS[f"paged_{kernel}{suffix}"]
            if kernel == "decode":
                pa.DECODE_MAX_SPLITS = max_splits
                sched = pa.decode_schedule(b, h, kv, n_keys, sms)
                shape = f"{sched.warps}w x{sched.splits}"
            else:
                pa.MAX_SPLITS = max_splits
                sched = pa.window_schedule(b, 1, h, kv, n_keys, sms)
                shape = f"8w x{sched.splits}"
            err = (fn(q, *pages, table, pos, layer=0) - want).abs().max()
            _, device_ms, _ = cs.time_ms(torch, lambda i: fn(
                q, *pages, table, pos, layer=i % layers))
            row.append(f"{kernel}/{max_splits}: {device_ms:.4f} ({shape}, "
                       f"err {err.item():.1e})")
        pa.DECODE_MAX_SPLITS, pa.MAX_SPLITS = chosen
        print(f"sweep {name}: " + "  ".join(row), flush=True)
        del pages


def wrappers(np, torch, cs, pa, label: str) -> None:
    """K4 at GPT-2 small's decode step and K4-int8 at LLaMA-GQA's, timed
    as ``chip_smoke.py``'s timing phase times them."""
    from tpudp_torch.models import gpt2

    cfg = gpt2.GPT2Config()
    prompts = cs.make_prompts(np, 0, cfg.vocab_size)
    decode = [p.size + cs.NEW_TOKENS // 2 for p in prompts]
    for name, c, pool in (("paged_decode", cfg, None),
                          ("paged_decode_int8", LLAMA, "int8")):
        q, pages, table, pos = cs.timing_case(torch, c, decode, 1, False,
                                              "cuda", 1, pool)
        fn = pa.KERNELS[name]
        layers = pages[0].shape[0]
        ms, device_ms, host_ms = cs.time_ms(torch, lambda i: fn(
            q, *pages, table, pos, layer=i % layers), n=200)
        print(f"wrappers {label} {name}: {ms:.4f} ms (device "
              f"{device_ms:.4f}, host {host_ms:.4f})", flush=True)
        del pages


def serve(np, torch, cs, label: str) -> None:
    from tpudp_torch.models import gpt2
    from tpudp_torch.ops import paged_attention as pa
    from tpudp_torch.serve import Engine, NgramDrafter

    cfg = gpt2.GPT2Config()
    model = gpt2.build(cfg, 0, "cuda")
    prompts = cs.make_prompts(np, 0, cfg.vocab_size)
    work = cs.spec_prompts(np, 0, cfg.vocab_size, prompts)
    cs.serve(torch, Engine, model, prompts, None)  # warm-up
    for _ in range(2):
        _, handles, wall = cs.serve(torch, Engine, model, prompts, None)
        print(f"serve {label} kernel: {cs.serve_summary(handles, wall)}",
              flush=True)
        _, handles, wall, _ = cs.serve_spec(
            torch, Engine, model, work, pa, speculate_k=4,
            drafter=NgramDrafter(max_ngram=3, min_ngram=2))
        print(f"serve {label} sequence: {cs.serve_summary(handles, wall)}",
              flush=True)
    _, handles, wall = cs.serve(torch, Engine, model, prompts, "einsum")
    print(f"serve {label} plain: {cs.serve_summary(handles, wall)}",
          flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in ("sweep", "wrappers", "serve") or (
            argv[0] != "sweep" and len(argv) != 3):
        print(__doc__, file=sys.stderr)
        return 2
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_window_sweep: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(argv[1] if argv[0] != "sweep"
                           else os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke as cs
    from tpudp_torch.ops import _build
    from tpudp_torch.ops import paged_attention as pa

    print(f"device: {cs.device_line()}", flush=True)
    _build.build(("paged_decode", "paged_window"))
    if argv[0] == "sweep":
        sweep(np, torch, cs, pa)
    elif argv[0] == "wrappers":
        wrappers(np, torch, cs, pa, argv[2])
    else:
        serve(np, torch, cs, argv[2])
    return 0


if __name__ == "__main__":
    sys.exit(main())
