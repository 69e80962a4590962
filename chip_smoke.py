#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Runs from the root of a checkout, needs one CUDA card and ``nvcc``, and
imports nothing of JAX or of the JAX package ``tpudp``.  Phases, each of
which fails the run (nonzero exit, no result line) when it fails:

  1. device — the card's name and power limit, as nvidia-smi reports them;
  2. build — every CUDA kernel of the port, from ``tpudp_torch/csrc``,
     one nvcc per source, all started together; then the HGMMA (wgmma)
     instructions in the SASS of the flash forward, dq and dk/dv
     libraries, counted with ``cuobjdump -sass`` — none in any of them
     fails the run (the bf16 flash kernels must run on the tensor cores);
  3. kernels vs plain — each kernel against its plain PyTorch version on
     the same inputs: fragmented block tables (pages shared between
     slots, ``-1`` tails, whole-pool ``layer=`` mode), GPT-2 small's
     heads and a grouped-query shape, decode / prefill / 3-token windows,
     float32 (atol = rtol = 2e-5: only the summation order differs) and
     bfloat16 (atol 2e-2 and rtol 1.6e-2, two bf16 ulps: the plain
     path rounds probabilities to bf16 before P.V, the kernels keep them
     in float32, and both round outputs above 2 to a 1/64 grid); then the
     paged-window kernel at the edges of its schedule (``WINDOW_EDGES``:
     head dim 32, 128 rows a KV head, depth 0, a depth of 1,000 keys
     split across blocks, a 64-row chunk over 64-token pages) in the
     schedule's 8-row tiles and the kernel's widest (32 rows), each case
     called twice back to back so a merge ticket left unreset would show;
  3b. tree kernel vs plain — the paged-tree kernel against its plain
     version on the same fragmented tables, node queries and window K/V
     as strided views of one projection, the trees fork2x2, fork3+1,
     chain4 and a 32-node tree (the kernel's widest), GPT-2 small's heads
     and a grouped-query shape, per-layer and whole-pool, with phase 3's
     tolerances;
  3c. int8 kernels vs plain — the int8 variants of the paged-decode and
     paged-window kernels against their plain version (dequantize, then
     the einsum) on phase 3's fragmented tables over pools quantized by
     the port's ``_quantize_kv`` (one all-zero vector included), GPT-2
     small's heads (12/12) and LLaMA-GQA's (12/3), decode / prefill /
     3-token windows, per-layer and whole-pool, float32 queries (atol =
     rtol = 2e-5: the plain path dequantizes to the same float32 values)
     and bfloat16 queries (phase 3's bf16 tolerance: the plain path
     rounds the dequantized K/V to bf16, the kernels keep float32); then
     the int8 window variant at phase 3's schedule edges; then the
     paged-decode kernel and its int8 variant at the edges of theirs
     (``DECODE_EDGES``: depths 0, 31, 32 and 63, a slot at 1,023 keys
     beside one at 0, head dims 32 and 128, 1, 4 and 8 query heads a KV
     head, 64-token pages, an idle slot whose output must be zeros) over
     float32, bf16 and int8 pools, each case called twice back to back;
  4. main path — GPT-2 small at full width (random weights from --seed,
     float32) served by ``Engine(kv_pages=512)`` on the card, which
     resolves to the CUDA kernels; 8 greedy requests of 17-300 prompt
     tokens, two sharing a 64-token prefix (the second is admitted after
     the first retired, so its prefix is mapped from the page index).
     Both kernels of that path must have launched in that run, the page
     bookkeeping must check, and the tokens must equal the same engine's
     on the plain PyTorch attention — or differ first where the plain
     logits' top-2 gap is below 1e-3 (a near-tie of the random weights).
     Then one scheduler step with 8 slots decoding runs under
     ``torch.profiler`` (wall ms, device kernels, device busy share);
  4b. speculative main path — the same model and engine geometry with
     ``speculate_k=4`` and ``NgramDrafter(max_ngram=3, min_ngram=2)``, then
     with ``speculate_k=2, speculate_tree="fork2x2"``, serving 8 greedy
     requests of 32 new tokens: 4 period-4 tiled prompts of 64-256 tokens
     and 4 of phase 4's prompts, beside the non-speculative kernel and
     plain engines on the same prompts.  Each run must verify windows
     and accept drafts; every verify window and prefill chunk must have
     launched the paged-window kernel once per layer (the sequence run),
     every tree window the paged-tree kernel once per layer (the tree
     run), and every plain decode step the paged-decode kernel; the
     tokens must agree with the plain engine's under phase 4's near-tie
     rule; no kernel engine of phases 4 and 4b may list a fallback in
     ``metrics()["paged_attn"]``;
  4c. LLaMA main path — ``benchmarks/matrix_bench.py``'s ``llama_gqa``
     widths (12 layers, d 768, 12 query heads over 3 KV heads, SwiGLU
     hidden 2048, vocab 32000; context 1024, float32, random weights
     from --seed) served by ``Engine(kv_pages=512, kv_dtype="int8")`` on
     phase 4's traffic, three times: on the int8 kernels, on the plain
     attention over the same int8 pool, and on an fp32 pool through the
     fp kernels at 4 query heads per KV head.  The int8 run must launch
     each int8 kernel once per layer and decode step or prefill chunk
     and no fp kernel, its page bookkeeping must check, and its tokens
     must agree with the plain int8 run's under phase 4's near-tie rule
     (the gap read from the plain int8 prefill); agreement with the fp32
     run, page bytes, tokens/s, TTFT and a profiled decode step on each
     pool are printed, not gated; the fallbacks may name only tree verify
     over int8 (as in JAX);
  4d. routes — the shapes the kernels do not take, served by the kernel
     engine through the einsum path as decided at build time: GPT-2
     small's widths over 16 heads (head dim 48) cut to 2 layers, whose
     engine must list all four paged families in
     ``metrics()["paged_attn"]["fallbacks"]`` and launch no kernel; the
     phase-4 model with a 40-node ``speculate_tree``, which must list
     tree verify alone, verify trees and launch no tree kernel while its
     decode and prefill go through theirs; both serving tokens that agree
     with the plain engine's under phase 4's near-tie rule; and
     ``multihead_attention(impl='flash')`` at head dim 48 routed to the
     dense math (counted once, no flash kernel launched) and equal to
     it;
  5. flash kernels vs plain — the forward (``o``, ``lse``), dq and dk/dv
     kernels against their plain PyTorch versions on q, k, v taken as
     strided views of a ``(b, t, 3 h dh)`` projection and a random ``do``:
     GPT-2 small's heads (h 12, dh 64, b 4) at t 128 and 2048, dh 128 at
     t 256, dh 32 at t 256 (a scale not exact in bf16), t 200 (a partial
     tile at 64 and at 128 rows), and t 96 through the public op with
     its 128 blocks clamped to 96 (its autograd gradients too); causal
     and not, float32 (atol = rtol = 2e-5 forward, 1e-4 gradients;
     ``lse`` always at 2e-5) and bfloat16 (atol 2e-2 and rtol 1.6e-2, two
     bf16 ulps; the tensor-core kernels round P and dS to bf16, the plain
     versions do not; and, since most values of a long causal row are
     far below atol, each 64-token tile's error norm within 1e-2 of the
     reference's norm there);
  6. training main path — GPT-2 small at full width (random weights from
     --seed, bfloat16, context 2048, ``attn_impl='flash'``) trained by
     ``tpudp_torch.train`` with ``make_optimizer(learning_rate=0.01)``
     for 2 warm-up and 8 timed steps at batch 4 x 2048 tokens from a
     numpy seed.  Each flash kernel must launch once per layer and step;
     no call may be routed to the dense math; the same weights and
     batches trained with ``attn_impl='dense'``
     (no flash launch) must give per-step losses within rtol 2e-2 (bf16
     dense scores round otherwise than the kernels' float32 ones).  Each
     run then takes one step split into forward / backward / optimizer
     between CUDA events and one step under ``torch.profiler`` (device
     ms by kernel, the device's busy share);
  7. timing — each kernel at its main path's shapes (the paged-window
     kernel at a prefill chunk and at phase 4b's verify window, each
     record tagged with its ``case``; the schedules of both paged
     kernels printed after) against its byte /
     flop bound, its plain version and one PyTorch library call (a
     yardstick the port never calls: ``scaled_dot_product_attention`` on
     the gathered K/V for the paged kernels — dequantized, with the KV
     heads expanded, for the int8 variants at phase 4c's shapes; for the
     tree kernel the
     gathered cache K/V and the window under a boolean mask; its causal
     forward, and its autograd backward — dq, dk and dv in one — for the
     flash kernels), read three ways in the same run: ``ms`` by CUDA
     events around each call submitted to an idle device (the host's
     submission plus the device time: the reading of every earlier run
     and the one the kernel targets are held to), ``device_ms`` by
     events around each call queued behind a device spin (the device
     time alone), and ``host_ms`` by the host's clock around that queued
     call (its submission).

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
import traceback
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12       # outside the tensor cores
BF16_FLOP_PER_S = 989e12      # tensor cores, dense
NEW_TOKENS = 32  # per request on the main path
REPLACES = {
    "paged_decode": "tpudp/ops/paged_attention.py:161",
    "paged_window": "tpudp/ops/paged_attention.py:319",
    "paged_decode_int8": "tpudp/ops/paged_attention.py:161",
    "paged_window_int8": "tpudp/ops/paged_attention.py:319",
    "paged_tree": "tpudp/ops/paged_attention.py:474",
    "flash_fwd": "tpudp/ops/flash_attention.py:65",
    "flash_dq": "tpudp/ops/flash_attention.py:152",
    "flash_dkv": "tpudp/ops/flash_attention.py:192",
}
# The int8 variants are entry points of their fp kernel's source.
SOURCES = {name: f"tpudp_torch/csrc/{name.removesuffix('_int8')}.cu"
           for name in REPLACES}
# LLaMA-GQA at benchmarks/matrix_bench.py's llama_gqa widths.
LLAMA_GQA = dict(vocab_size=32_000, max_seq_len=1024, num_layers=12,
                 d_model=768, num_heads=12, num_kv_heads=3, mlp_hidden=2048)
# Flash checks: name -> (batch, time, heads, head dim).
FLASH_CASES = {"gpt2-t128": (4, 128, 12, 64), "gpt2-t2048": (4, 2048, 12, 64),
               "dh128-t256": (2, 256, 4, 128), "dh32-t256": (2, 256, 4, 32),
               "t200-partial": (1, 200, 3, 64), "t96-clamped": (2, 96, 4, 64)}
# The largest error a 64-token tile of a bf16 flash output may have
# relative to the reference's norm there: 3x the largest that sound
# kernels read.  On an H100 the tensor-core kernels read 0.0012-0.0033
# over phase 5's cases (o, dq, dk and dv); a plain model of their
# roundings reads 0.0023-0.0030 on the CPU; a forward that drops one key
# tile from the rows past t/2 at t 2048 reads 0.25.
BF16_TILE_REL_ERR = 1e-2
# The sources whose bf16 kernels run on the tensor cores.
WGMMA_SOURCES = ("flash_fwd", "flash_dq", "flash_dkv")
# A tree of 40 nodes (13 first steps, two continuations each): wider than
# the tree kernel's 32.
WIDE_TREE = (-1,) + (0,) * 13 + tuple(1 + i // 2 for i in range(26))
# Device cycles spun ahead of each call timed on the device clock alone
# (about 1 ms at the H100's clocks), long enough for the host to queue
# the call behind them.
SPIN_CYCLES = 2_000_000
TRAIN_BATCH, TRAIN_T = 4, 2048
TRAIN_WARMUP, TRAIN_STEPS = 2, 8


class SmokeFailure(RuntimeError):
    pass


def hgmma_counts(build) -> dict:
    """HGMMA instructions in the SASS of each built WGMMA_SOURCES library,
    by ``cuobjdump -sass``."""
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    counts = {}
    for src in WGMMA_SOURCES:
        sass = subprocess.run([cuobjdump, "-sass",
                               str(build.library_path(src))],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        counts[src] = sum("HGMMA" in line for line in sass.splitlines())
    return counts


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# -- phase 3: kernels vs their plain versions ---------------------------


def fragmented_case(torch, *, b, h, kv, dh, page_tokens, max_pages, cur,
                    scalar_pos, dtype, layers, seed, device, depth=None):
    """A pool and block tables shaped like copy-on-write traffic: slots
    0-3 map the same prefix pages, every slot continues into private
    pages, entries past each slot's window are ``-1`` except for a few
    mapped stale pages, and the pool holds ``layers`` layers (one
    selected by ``layer``, the others noise).  Every entry a query can
    see is mapped, as the engine guarantees.  A scalar depth is drawn
    page-aligned unless ``depth`` gives it."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    t_max = max_pages * page_tokens
    if scalar_pos:
        p0 = int(torch.randint(0, t_max - cur, (1,), generator=g))
        p0 = p0 - p0 % page_tokens if depth is None else depth
        pos = torch.tensor(p0)
        last = torch.full((b,), p0 + cur - 1)
    else:
        pos = torch.randint(0, t_max - cur + 1, (b,), generator=g)
        pos[0] = t_max - cur  # one slot at the table's far end
        last = pos + cur - 1
    n_real = b * (max_pages + 2) + 8
    perm = torch.randperm(n_real, generator=g).tolist()
    shared = [perm.pop() for _ in range(3)]
    table = torch.full((b, max_pages), -1, dtype=torch.int32)
    for s in range(b):
        n_vis = int(last[s]) // page_tokens + 1
        for i in range(n_vis):
            table[s, i] = shared[i] if s < 4 and i < 3 else perm.pop()
        for i in range(n_vis, min(n_vis + 2, max_pages)):
            if s % 2:
                table[s, i] = perm.pop()  # stale mapped page past the edge
    gd = torch.Generator(device=device).manual_seed(seed)
    shape = (layers, n_real + 1, page_tokens, kv, dh)
    k = torch.randn(shape, generator=gd, device=device).to(dtype)
    v = torch.randn(shape, generator=gd, device=device).to(dtype)
    q = torch.randn((b, cur, h, dh), generator=gd, device=device).to(dtype)
    return q, k, v, table.to(device), pos.to(device, torch.int32)


def check_kernels(torch, pa, device) -> list[str]:
    lines = []
    shapes = {"gpt2": dict(h=12, kv=12, dh=64),
              "gqa": dict(h=32, kv=8, dh=128)}
    traffic = {"decode": (1, False), "prefill": (16, True),
               "window3": (3, False)}
    tol = {torch.float32: dict(atol=2e-5, rtol=2e-5),
           torch.bfloat16: dict(atol=2e-2, rtol=1.6e-2)}
    failures = []
    for sname, dims in shapes.items():
        for tname, (cur, scalar) in traffic.items():
            for dtype in (torch.float32, torch.bfloat16):
                for layer in (None, 1):
                    q, k, v, table, pos = fragmented_case(
                        torch, b=8, page_tokens=16, max_pages=64, cur=cur,
                        scalar_pos=scalar, dtype=dtype, layers=2,
                        seed=len(lines), device=device, **dims)
                    kk, vv = (k, v) if layer is not None else (k[0], v[0])
                    pages = (kk, vv)
                    got = pa.paged_attention(q, pages, table, pos,
                                             dtype=dtype, impl="kernel",
                                             layer=layer)
                    sl = (k[layer], v[layer]) if layer is not None else pages
                    want = pa._einsum_paged(q, sl, table, pos, dtype=dtype,
                                            grouped=True)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    t = tol[dtype]
                    ok = torch.allclose(got.float(), want.float(), **t)
                    name = (f"{sname} {tname} {str(dtype)[6:]} "
                            f"{'whole-pool' if layer is not None else 'layer'}")
                    lines.append(f"kernel-check {name}: max_abs_err={err:.3e}"
                                 f" atol={t['atol']} rtol={t['rtol']} "
                                 f"{'ok' if ok else 'MISS'}")
                    if not ok:
                        failures.append(name)
    for line in lines:
        print(line, flush=True)
    if failures:
        raise SmokeFailure(f"kernels disagree with the plain version: "
                           f"{failures}")
    return lines


# K5's edges: name -> (query heads, KV heads, head dim, page tokens,
# table pages, window rows, depth).  One slot at a scalar depth given as a
# host int, as the engine's prefill sends it, so the wrapper's schedule
# splits the keys as on the main path.
WINDOW_EDGES = {
    "dh32": (8, 4, 32, 16, 64, 16, 144),
    "rows128": (16, 4, 64, 16, 64, 32, 200),  # 32 positions x 4 heads
    "depth0": (12, 3, 64, 16, 64, 16, 0),
    "depth1000": (12, 12, 64, 16, 64, 16, 1000),
    "page64": (12, 3, 64, 64, 16, 64, 320),   # a 64-row chunk
}


def check_window_edges(torch, pa, device, int8: bool) -> None:
    """K5 (or K5-int8) at the edges of its schedule, WINDOW_EDGES, in
    whole-pool mode against its plain version at phase 3's tolerances,
    in the schedule's row tiles and in the kernel's widest (32 rows, four
    a warp); each case runs twice back to back, so a merge ticket left
    unreset by the first call would show in the second."""
    tol = {torch.float32: dict(atol=2e-5, rtol=2e-5),
           torch.bfloat16: dict(atol=2e-2, rtol=1.6e-2)}
    label = "kernel-check int8 edge" if int8 else "kernel-check edge"
    failures = []
    seed = 300 + 100 * int8
    row_cap = pa.ROW_TILE_ROWS
    cases = [(name, dims, dtype, rows)
             for rows in (row_cap, pa.TILE_ROWS)
             for name, dims in WINDOW_EDGES.items()
             for dtype in (torch.float32, torch.bfloat16)]
    try:
        for name, dims, dtype, rows in cases:
            h, kv, dh, page_tokens, max_pages, cur, depth = dims
            pa.ROW_TILE_ROWS = rows
            seed += 1
            q, k, v, table, _ = fragmented_case(
                torch, b=1, h=h, kv=kv, dh=dh, page_tokens=page_tokens,
                max_pages=max_pages, cur=cur, scalar_pos=True,
                dtype=torch.float32 if int8 else dtype, layers=2, seed=seed,
                device=device, depth=depth)
            if int8:
                pages = int8_pool(torch, k, v,
                                  (slice(None), int(table[0, 0]), 0, 0))
                q = q.to(dtype)
            else:
                pages = (k, v)
            sched = pa.window_schedule(1, cur, h, kv, depth + cur,
                                       pa._sm_count(q.device))
            want = pa._einsum_paged(q, tuple(buf[1] for buf in pages),
                                    table, depth, dtype=dtype, grouped=True)
            t = tol[dtype]
            for run in (1, 2):
                got = pa.paged_attention(q, pages, table, depth, dtype=dtype,
                                         impl="kernel", layer=1)
                torch.cuda.synchronize()
                err, ok = compare(torch, got, want, t)
                case = f"{name} {str(dtype)[6:]} rows {rows} run {run}"
                print(f"{label} {case}: row_tile={sched.row_tile} splits="
                      f"{sched.splits} grid={sched.grid} max_abs_err="
                      f"{err:.3e} atol={t['atol']} rtol={t['rtol']} "
                      f"{'ok' if ok else 'MISS'}", flush=True)
                if not ok:
                    failures.append(case)
    finally:
        pa.ROW_TILE_ROWS = row_cap
    if failures:
        raise SmokeFailure(f"the {'int8 ' if int8 else ''}window kernel "
                           f"disagrees with its plain version at its "
                           f"edges: {failures}")


# K4's edges: name -> (query heads, KV heads, head dim, page tokens, table
# pages, per-slot depths); an idle slot (its table row all -1) has depth
# None and attends nothing.  Tile edges, one slot near the capacity of
# 1,024 keys beside one at 0, head dims 32 and 128, groups 1, 4 and 8 (two
# row tiles a KV head), 64-token pages, and an idle slot.
DECODE_EDGES = {
    "tile-edges": (12, 12, 64, 16, 64, (0, 31, 32, 63)),
    "capacity": (12, 3, 64, 16, 64, (1023, 0)),
    "dh32": (16, 2, 32, 16, 64, (100, 317, 5)),
    "dh128": (32, 8, 128, 16, 64, (200, 31, 640)),
    "groups8": (16, 2, 64, 16, 64, (150, 999, 64)),
    "page64": (12, 3, 64, 64, 16, (1000, 63, 64)),
    "idle": (12, 12, 64, 16, 64, (300, None, 50)),
}
# An idle slot's depth: the kernel walks its tiles and finds no page.
IDLE_DEPTH = 40


def decode_edge_case(torch, dims, seed, device):
    """Float32 whole-pool inputs (2 layers) for one DECODE_EDGES case: each
    slot maps distinct pages up to its depth, the idle slot none; returns
    ``q, k, v, table, pos`` and the idle slots."""
    h, kv, dh, page_tokens, max_pages, depths = dims
    g = torch.Generator(device="cpu").manual_seed(seed)
    n_pages = sum(d // page_tokens + 1 for d in depths if d is not None) + 2
    perm = torch.randperm(n_pages, generator=g).tolist()
    table = torch.full((len(depths), max_pages), -1, dtype=torch.int32)
    for s, d in enumerate(depths):
        for i in range(0 if d is None else d // page_tokens + 1):
            table[s, i] = perm.pop()
    gd = torch.Generator(device=device).manual_seed(seed)
    shape = (2, n_pages + 1, page_tokens, kv, dh)
    k = torch.randn(shape, generator=gd, device=device)
    v = torch.randn(shape, generator=gd, device=device)
    q = torch.randn((len(depths), 1, h, dh), generator=gd, device=device)
    pos = torch.tensor([IDLE_DEPTH if d is None else d for d in depths],
                       dtype=torch.int32)
    idle = [s for s, d in enumerate(depths) if d is None]
    return q, k, v, table.to(device), pos.to(device), idle


def check_decode_edges(torch, pa, device) -> None:
    """K4 and K4-int8 at the edges of their schedule, DECODE_EDGES, in
    whole-pool mode against the plain version (zeros for an idle slot)
    at phase 3's tolerances, over float32, bf16 and int8 pools (float32
    and bf16 queries); each case runs twice back to back, so a merge
    ticket left unreset by the first call would show in the second."""
    tol = {torch.float32: dict(atol=2e-5, rtol=2e-5),
           torch.bfloat16: dict(atol=2e-2, rtol=1.6e-2)}
    pools = (("fp32", torch.float32), ("bf16", torch.bfloat16),
             ("int8", torch.float32), ("int8", torch.bfloat16))
    failures = []
    seed = 500
    for name, dims in DECODE_EDGES.items():
        for pool, dtype in pools:
            seed += 1
            q, k, v, table, pos, idle = decode_edge_case(torch, dims, seed,
                                                         device)
            if pool == "int8":
                pages = int8_pool(torch, k, v,
                                  (slice(None), int(table[0, 0]), 0, 0))
            else:
                pages = (k.to(dtype), v.to(dtype))
            q = q.to(dtype)
            want = pa._einsum_paged(q, tuple(buf[1] for buf in pages), table,
                                    pos, dtype=dtype, grouped=True)
            want[idle] = 0.0
            t = tol[dtype]
            sched = pa.decode_schedule(q.shape[0], q.shape[2], dims[1],
                                       dims[4] * dims[3],
                                       pa._sm_count(q.device))
            for run in (1, 2):
                got = pa.paged_attention(q, pages, table, pos, dtype=dtype,
                                         impl="kernel", layer=1)
                torch.cuda.synchronize()
                err, ok = compare(torch, got, want, t)
                ok = ok and not got[idle].any()
                case = f"{name} {pool}/{str(dtype)[6:]} run {run}"
                print(f"kernel-check decode edge {case}: row_tile="
                      f"{sched.row_tile} lanes={sched.lanes} splits="
                      f"{sched.splits} grid={sched.grid} max_abs_err="
                      f"{err:.3e} atol={t['atol']} rtol={t['rtol']} "
                      f"{'ok' if ok else 'MISS'}", flush=True)
                if not ok:
                    failures.append(case)
    if failures:
        raise SmokeFailure(f"the decode kernels disagree with their plain "
                           f"version at their edges: {failures}")


def window_views(torch, q, kv, seed):
    """Node queries and window K/V as the tree forward makes them:
    strided views of one ``(b, T+1, (h + 2 kv) dh)`` projection whose
    query part is ``q``."""
    b, t1, h, dh = q.shape
    g = torch.Generator(device=q.device).manual_seed(seed)
    proj = torch.randn((b, t1, (h + 2 * kv) * dh), generator=g,
                       device=q.device).to(q.dtype)
    proj[..., :h * dh] = q.reshape(b, t1, h * dh)
    qv, wk, wv = proj.split([h * dh, kv * dh, kv * dh], dim=-1)
    return (qv.reshape(b, t1, h, dh), wk.reshape(b, t1, kv, dh),
            wv.reshape(b, t1, kv, dh))


def check_tree_kernels(torch, pa, device) -> None:
    """Phase 3b: K6 against ``_tree_plain``.  The fragmented tables map
    every position up to ``pos0 + T``, a superset of the strictly
    visible cache."""
    from tpudp_torch.serve.speculate import TREE_SHAPES, TreeShape

    shapes = {"gpt2": dict(h=12, kv=12, dh=64),
              "gqa": dict(h=32, kv=8, dh=128)}
    tol = {torch.float32: dict(atol=2e-5, rtol=2e-5),
           torch.bfloat16: dict(atol=2e-2, rtol=1.6e-2)}
    # 32 nodes, the kernel's widest: 7 first steps, 24 second, 3 each.
    trees = {name: TREE_SHAPES[name]
             for name in ("fork2x2", "fork3+1", "chain4")}
    trees["wide32"] = TreeShape("wide32", (-1,) + (0,) * 7 + tuple(
        1 + i // 3 for i in range(24)))
    failures = []
    seed = 100
    for sname, dims in shapes.items():
        for tree, shape in trees.items():
            anc = shape.ancestors
            for dtype in (torch.float32, torch.bfloat16):
                for layer in (None, 1):
                    seed += 1
                    q, k, v, table, pos0 = fragmented_case(
                        torch, b=8, page_tokens=16, max_pages=64,
                        cur=len(anc), scalar_pos=False, dtype=dtype,
                        layers=2, seed=seed, device=device, **dims)
                    q, wk, wv = window_views(torch, q, dims["kv"], seed)
                    kk, vv = (k, v) if layer is not None else (k[0], v[0])
                    got = pa.tree_paged_attention(q, (kk, vv), table, pos0,
                                                  wk, wv, anc, dtype=dtype,
                                                  layer=layer)
                    want = pa._tree_plain(q, kk, vv, table, pos0, wk, wv,
                                          anc, layer)
                    torch.cuda.synchronize()
                    err, ok = compare(torch, got, want, tol[dtype])
                    t = tol[dtype]
                    name = (f"{sname} {tree} {str(dtype)[6:]} "
                            f"{'whole-pool' if layer is not None else 'layer'}")
                    print(f"kernel-check tree {name}: max_abs_err={err:.3e} "
                          f"atol={t['atol']} rtol={t['rtol']} "
                          f"{'ok' if ok else 'MISS'}", flush=True)
                    if not ok:
                        failures.append(name)
    if failures:
        raise SmokeFailure(f"the tree kernel disagrees with its plain "
                           f"version: {failures}")


def int8_pool(torch, k, v, zero_at):
    """``(k8, v8, k_scale, v_scale)`` from float32 pages by the port's
    quantizer, with the K and V vectors at index ``zero_at`` zeroed
    first (a zero vector keeps scale 1)."""
    from tpudp_torch.models.generate import _quantize_kv

    k, v = k.clone(), v.clone()
    k[zero_at] = 0.0
    v[zero_at] = 0.0
    (k8, ks), (v8, vs) = _quantize_kv(k), _quantize_kv(v)
    return k8, v8, ks, vs


def check_int8_kernels(torch, pa, device) -> None:
    """Phase 3c: the int8 variants of K4 and K5 against their plain
    version on phase 3's fragmented tables."""
    shapes = {"gpt2": dict(h=12, kv=12, dh=64),
              "llama-gqa": dict(h=12, kv=3, dh=64)}
    traffic = {"decode": (1, False), "prefill": (16, True),
               "window3": (3, False)}
    tol = {torch.float32: dict(atol=2e-5, rtol=2e-5),
           torch.bfloat16: dict(atol=2e-2, rtol=1.6e-2)}
    failures = []
    seed = 200
    for sname, dims in shapes.items():
        for tname, (cur, scalar) in traffic.items():
            for dtype in (torch.float32, torch.bfloat16):
                for layer in (None, 1):
                    seed += 1
                    q, k, v, table, pos = fragmented_case(
                        torch, b=8, page_tokens=16, max_pages=64, cur=cur,
                        scalar_pos=scalar, dtype=torch.float32, layers=2,
                        seed=seed, device=device, **dims)
                    # A visible all-zero vector: slot 0's first key.
                    zero_at = (slice(None), int(table[0, 0]), 0, 0)
                    pool = int8_pool(torch, k, v, zero_at)
                    q = q.to(dtype)
                    sl = tuple(b[1] for b in pool)
                    pages = pool if layer is not None else sl
                    got = pa.paged_attention(q, pages, table, pos,
                                             dtype=dtype, impl="kernel",
                                             layer=layer)
                    want = pa._einsum_paged(q, sl, table, pos, dtype=dtype,
                                            grouped=True)
                    torch.cuda.synchronize()
                    t = tol[dtype]
                    err, ok = compare(torch, got, want, t)
                    name = (f"{sname} {tname} {str(dtype)[6:]} "
                            f"{'whole-pool' if layer is not None else 'layer'}")
                    print(f"kernel-check int8 {name}: max_abs_err={err:.3e} "
                          f"atol={t['atol']} rtol={t['rtol']} "
                          f"{'ok' if ok else 'MISS'}", flush=True)
                    if not ok:
                        failures.append(name)
    if failures:
        raise SmokeFailure(f"the int8 kernels disagree with their plain "
                           f"version: {failures}")


# -- phase 4: the main path ----------------------------------------------


def make_prompts(np, seed: int, vocab: int):
    """Eight prompts of 17-300 tokens; prompts 0 and 7 share their first
    64 tokens."""
    rng = np.random.default_rng(seed)
    lens = [100, 17, 45, 77, 128, 190, 300, 150]
    prompts = [rng.integers(0, vocab, size=n).astype(np.int32)
               for n in lens]
    prompts[7][:64] = prompts[0][:64]
    return prompts


def serve(torch, Engine, model, prompts, paged_attn, kv_dtype=None):
    """Serve the prompts on one engine: 0-6 at once, 7 (prompt 0's
    prefix) once request 0 has retired; the page bookkeeping is checked
    at both points, outside the timing.  Returns the engine, handles and
    wall seconds of the serving."""
    eng = Engine(model, device="cuda", num_slots=8, prefill_chunk=16,
                 kv_pages=512, paged_attn=paged_attn, kv_dtype=kv_dtype)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles = [eng.submit(p, NEW_TOKENS) for p in prompts[:7]]
    while not handles[0].done:
        eng.step()
    wall = time.perf_counter() - t0
    eng.check_paged()
    t0 = time.perf_counter()
    handles.append(eng.submit(prompts[7], NEW_TOKENS))
    eng.run_until_complete()
    torch.cuda.synchronize()
    wall += time.perf_counter() - t0
    eng.check_paged()
    return eng, handles, wall


SERVE_KERNELS = ("paged_decode", "paged_window")  # phase 4's path


def int8_plain_logits(torch, np, model, seq):
    """The last position's logits of ``seq`` prefilled in 16-token
    chunks through a fresh int8 pool on the plain attention, as the plain
    int8 engine prefills."""
    from tpudp_torch.models.generate import Int8Pages, _forward_paged

    dev = model.wte.weight.device
    n_pages = -(-seq.size // 16)
    pool = Int8Pages.zeros(model.config, n_pages + 1, 16, dev)
    table = torch.arange(n_pages, device=dev, dtype=torch.int32)[None]
    active = torch.ones(1, dtype=torch.bool, device=dev)
    padded = np.zeros(n_pages * 16, np.int64)
    padded[:seq.size] = seq
    tokens = torch.as_tensor(padded, device=dev)[None]
    with torch.no_grad():
        for start in range(0, seq.size, 16):
            logits, _ = _forward_paged(model, tokens[:, start:start + 16],
                                       pool, table, start, active)
    return logits[0, (seq.size - 1) % 16]


def agree_with_plain(torch, np, model, prompts, handles, ref, label,
                     kv_dtype=None):
    """Tokens of ``handles`` equal the plain engine's ``ref`` or differ
    first where the plain logits' top-2 gap is below 1e-3 (a near-tie
    of the random weights); raises otherwise.  Over an int8 pool the gap
    is read from the plain int8 prefill of the sequence."""
    from tpudp_torch.models.generate import KVCache, _forward_cached

    for i, (h, r) in enumerate(zip(handles, ref)):
        if h.tokens == r.tokens:
            continue
        t = next((j for j, (a, b) in enumerate(zip(h.tokens, r.tokens))
                  if a != b), min(len(h.tokens), len(r.tokens)))
        seq = np.concatenate([prompts[i], np.asarray(r.tokens[:t])])
        if kv_dtype == "int8":
            last = int8_plain_logits(torch, np, model, seq)
        else:
            cache = KVCache.zeros(model.config, 1, seq.size, "cuda")
            with torch.no_grad():
                logits, _ = _forward_cached(
                    model, torch.as_tensor(seq, device="cuda")[None].long(),
                    cache, 0)
            last = logits[0, -1]
        top2 = torch.topk(last, 2).values
        gap = float(top2[0] - top2[1])
        print(f"{label} request {i}: first differing token {t}, plain "
              f"top-2 gap {gap:.3e}", flush=True)
        if gap >= 1e-3:
            raise SmokeFailure(f"{label} request {i} diverges at token {t} "
                               f"with a top-2 gap of {gap} (not a near-tie)")
    print(f"{label} tokens agree with the plain engine "
          f"({sum(h.tokens == r.tokens for h, r in zip(handles, ref))}/"
          f"{len(handles)} identical)", flush=True)


def serve_summary(handles, wall) -> str:
    n_tok = sum(len(h.tokens) for h in handles)
    ttft = sorted(h.token_times[0] - h.submit_time for h in handles)
    return (f"{len(handles)} requests, {n_tok} tokens in {wall:.3f}s = "
            f"{n_tok / wall:.1f} tokens/s, TTFT p50 "
            f"{1e3 * ttft[len(ttft) // 2]:.1f} ms")


def main_path(torch, np, pa, seed: int):
    from tpudp_torch.models import gpt2
    from tpudp_torch.serve import Engine

    cfg = gpt2.GPT2Config()  # GPT-2 small: 12 x 768, 12 heads, 50257
    model = gpt2.build(cfg, seed, "cuda")
    prompts = make_prompts(np, seed, cfg.vocab_size)

    for fn in pa.KERNELS.values():
        fn.launches = 0
    eng, handles, wall = serve(torch, Engine, model, prompts, None)
    launches = {name: fn.launches for name, fn in pa.KERNELS.items()}
    if eng.paged_attn != "kernel":
        raise SmokeFailure(f"paged_attn resolved to {eng.paged_attn!r}")
    fallbacks = eng.metrics()["paged_attn"]["fallbacks"]
    if fallbacks:
        raise SmokeFailure(f"the main path fell back on {fallbacks}")
    for name in SERVE_KERNELS:
        if launches[name] == 0:
            raise SmokeFailure(f"kernel {name} never launched on the main "
                               f"path")
    if eng.stats["prefix_hit_tokens"] < 64:
        raise SmokeFailure(f"the shared prefix was not mapped: "
                           f"{dict(eng.stats)}")
    if not all(h.ok and len(h.tokens) == NEW_TOKENS for h in handles):
        raise SmokeFailure("a request did not complete")
    n_tok = sum(len(h.tokens) for h in handles)
    print(f"main-path kernel engine: {serve_summary(handles, wall)}, "
          f"launches {launches}, stats {dict(eng.stats)}", flush=True)

    _, ref, ref_wall = serve(torch, Engine, model, prompts, "einsum")
    if any(fn.launches != launches[n] for n, fn in pa.KERNELS.items()):
        raise SmokeFailure("the plain engine launched a kernel")
    print(f"main-path plain engine: {n_tok / ref_wall:.1f} tokens/s",
          flush=True)
    agree_with_plain(torch, np, model, prompts, handles, ref, "main-path")
    profile_decode_step(torch, Engine, model, prompts, "main-path kernel")
    return model, prompts, launches


# -- phase 4b: the speculative main path ----------------------------------


def spec_prompts(np, seed: int, vocab: int, prompts):
    """Four period-4 tiled prompts of 64-256 tokens (the repetitive
    workload of ``benchmarks/serve_bench.py``'s speculation rows) and
    four of phase 4's prompts."""
    rng = np.random.default_rng(seed + 2)
    tiled = [np.tile(rng.integers(0, vocab, size=4), n // 4).astype(np.int32)
             for n in (64, 128, 192, 256)]
    return tiled + [prompts[i] for i in (1, 2, 3, 4)]


def serve_spec(torch, Engine, model, prompts, pa, **kw):
    """Serve all prompts at once (8 greedy requests of NEW_TOKENS) on a
    fresh engine with the kernel counts zeroed just before; returns the
    engine, handles, wall seconds and the counts read just after."""
    eng = Engine(model, device="cuda", num_slots=8, prefill_chunk=16,
                 kv_pages=512, **kw)
    for fn in pa.KERNELS.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles = [eng.submit(p, NEW_TOKENS) for p in prompts]
    eng.run_until_complete()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in pa.KERNELS.items()}
    eng.check_paged()
    if not all(h.ok and len(h.tokens) == NEW_TOKENS for h in handles):
        raise SmokeFailure("a request did not complete")
    return eng, handles, wall, launches


def spec_main_path(torch, np, pa, model, prompts, seed: int) -> dict:
    """Phase 4b: sequence and tree speculation through the kernels,
    beside the non-speculative kernel and plain engines."""
    from tpudp_torch.serve import Engine, NgramDrafter

    cfg = model.config
    work = spec_prompts(np, seed, cfg.vocab_size, prompts)
    base, base_h, base_wall, _ = serve_spec(torch, Engine, model, work, pa)
    print(f"spec-path non-speculative kernel engine: "
          f"{serve_summary(base_h, base_wall)}", flush=True)
    _, ref, ref_wall, plain_launches = serve_spec(
        torch, Engine, model, work, pa, paged_attn="einsum")
    if any(plain_launches.values()):
        raise SmokeFailure("the plain engine launched a kernel")
    print(f"spec-path plain engine: {serve_summary(ref, ref_wall)}",
          flush=True)
    agree_with_plain(torch, np, model, work, base_h, ref,
                     "spec-path non-speculative")
    runs = {"sequence": dict(speculate_k=4),
            "tree": dict(speculate_k=2, speculate_tree="fork2x2")}
    tree_launches = None
    for label, kw in runs.items():
        eng, handles, wall, launches = serve_spec(
            torch, Engine, model, work, pa,
            drafter=NgramDrafter(max_ngram=3, min_ngram=2), **kw)
        st = eng.stats
        steps = st["verify_steps"] if label == "sequence" else \
            st["tree_verify_steps"]
        print(f"spec-path {label} engine: {serve_summary(handles, wall)}, "
              f"acceptance rate {eng.acceptance_rate}, launches "
              f"{launches}, stats {dict(st)}", flush=True)
        if steps == 0 or st["draft_accepted"] == 0:
            raise SmokeFailure(f"the {label} run verified {steps} windows "
                               f"and accepted {st['draft_accepted']} drafts")
        fallbacks = eng.metrics()["paged_attn"]["fallbacks"]
        if fallbacks:
            raise SmokeFailure(f"the {label} run fell back on {fallbacks}")
        want = {name: 0 for name in pa.KERNELS}
        want.update(paged_decode=cfg.num_layers * st["decode_steps"],
                    paged_window=cfg.num_layers * (
                        st["prefill_chunks"] + st["verify_steps"]),
                    paged_tree=cfg.num_layers * st["tree_verify_steps"])
        if launches != want:
            raise SmokeFailure(f"the {label} run launched {launches}, its "
                               f"steps need {want}")
        agree_with_plain(torch, np, model, work, handles, ref,
                         f"spec-path {label}")
        if label == "tree":
            tree_launches = launches["paged_tree"]
    return {"paged_tree": tree_launches}


# -- phase 4c: the LLaMA main path over int8 pages -------------------------


def first_divergence(a, b) -> int | None:
    return next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)


def llama_main_path(torch, np, pa, seed: int) -> dict:
    """Phase 4c: LLaMA-GQA served over an int8 pool through the int8
    kernels, beside the plain attention over int8 and the fp kernels
    over an fp32 pool."""
    from tpudp_torch.models import llama
    from tpudp_torch.serve import Engine

    cfg = llama.LlamaConfig(**LLAMA_GQA)
    model = llama.build(cfg, seed, "cuda")
    n_params = sum(p.numel() for p in model.parameters())
    print(f"llama-path model: {n_params} parameters, "
          f"{4 * n_params / 1e9:.3f} GB in float32", flush=True)
    prompts = make_prompts(np, seed, cfg.vocab_size)
    runs = {}
    for label, paged_attn, kv_dtype in (("int8 kernel", None, "int8"),
                                        ("int8 plain", "einsum", "int8"),
                                        ("fp32 kernel", None, None)):
        for fn in pa.KERNELS.values():
            fn.launches = 0
        eng, handles, wall = serve(torch, Engine, model, prompts,
                                   paged_attn, kv_dtype)
        launches = {name: fn.launches for name, fn in pa.KERNELS.items()}
        if not all(h.ok and len(h.tokens) == NEW_TOKENS for h in handles):
            raise SmokeFailure(f"a request of the {label} run did not "
                               f"complete")
        page_bytes = eng.page_pool.page_bytes()
        print(f"llama-path {label} engine: {serve_summary(handles, wall)}, "
              f"page_bytes {page_bytes}, launches {launches}, stats "
              f"{dict(eng.stats)}, paged_attn {eng.metrics()['paged_attn']}",
              flush=True)
        runs[label] = (eng, handles, launches, page_bytes)
    eng, handles, launches, _ = runs["int8 kernel"]
    st = eng.stats
    want = {name: 0 for name in pa.KERNELS}
    want["paged_decode_int8"] = cfg.num_layers * st["decode_steps"]
    want["paged_window_int8"] = cfg.num_layers * st["prefill_chunks"]
    if eng.paged_attn != "kernel" or launches != want:
        raise SmokeFailure(f"the int8 run ({eng.paged_attn}) launched "
                           f"{launches}, its steps need {want}")
    if any(runs["int8 plain"][2].values()):
        raise SmokeFailure("the plain int8 engine launched a kernel")
    for label, allowed in (("int8 kernel", ["tree_verify_paged"]),
                           ("fp32 kernel", [])):
        fallbacks = runs[label][0].metrics()["paged_attn"]["fallbacks"]
        if fallbacks != allowed:
            raise SmokeFailure(f"the {label} run falls back on {fallbacks}")
    fp_launches = runs["fp32 kernel"][2]
    if not (fp_launches["paged_decode"] and fp_launches["paged_window"]):
        raise SmokeFailure(f"the fp32 run launched {fp_launches}")
    if st["prefix_hit_tokens"] < 64:
        raise SmokeFailure(f"the shared prefix was not mapped: {dict(st)}")
    agree_with_plain(torch, np, model, prompts, handles,
                     runs["int8 plain"][1], "llama-path int8", "int8")
    fp_handles = runs["fp32 kernel"][1]
    same = sum(h.tokens == r.tokens for h, r in zip(handles, fp_handles))
    firsts = [first_divergence(h.tokens, r.tokens)
              for h, r in zip(handles, fp_handles)]
    print(f"llama-path int8 vs fp32 pool: {same}/{len(handles)} requests "
          f"identical, first divergence per request {firsts}; "
          f"page_bytes int8 {runs['int8 kernel'][3]} vs fp32 "
          f"{runs['fp32 kernel'][3]} "
          f"({runs['fp32 kernel'][3] / runs['int8 kernel'][3]:.2f}x tokens "
          f"per byte)", flush=True)
    for label, kv_dtype in (("int8", "int8"), ("fp32", None)):
        profile_decode_step(torch, Engine, model, prompts,
                            f"llama-path {label} kernel", kv_dtype=kv_dtype)
    del model, runs
    torch.cuda.empty_cache()
    return {name: launches[name]
            for name in ("paged_decode_int8", "paged_window_int8")}


# -- phase 4d: shapes the kernels do not take -----------------------------


def routes_path(torch, np, pa, fa, model, prompts, seed: int) -> None:
    """Phase 4d: a head dim and a tree the kernels do not take, served by
    kernel engines whose build-time dispatch sends them to the einsum
    path, and flash attention at head dim 48 routed to the dense math."""
    from tpudp_torch.models import gpt2
    from tpudp_torch.ops import attention
    from tpudp_torch.serve import Engine, NgramDrafter
    from tpudp_torch.serve.engine import PAGED_FAMILIES

    cfg48 = gpt2.GPT2Config(num_layers=2, num_heads=16)  # head dim 48
    model48 = gpt2.build(cfg48, seed, "cuda")
    work = prompts[1:5]
    eng, handles, wall, launches = serve_spec(torch, Engine, model48, work,
                                              pa)
    fallbacks = eng.metrics()["paged_attn"]["fallbacks"]
    print(f"routes head-dim-48 kernel engine: {serve_summary(handles, wall)},"
          f" fallbacks {fallbacks}, launches {launches}", flush=True)
    if (eng.paged_attn != "kernel" or fallbacks != sorted(PAGED_FAMILIES)
            or any(launches.values())):
        raise SmokeFailure(f"the head-dim-48 engine ({eng.paged_attn}) "
                           f"falls back on {fallbacks} and launched "
                           f"{launches}")
    _, ref, _, _ = serve_spec(torch, Engine, model48, work, pa,
                              paged_attn="einsum")
    agree_with_plain(torch, np, model48, work, handles, ref,
                     "routes head-dim-48")
    del model48

    cfg = model.config
    work = spec_prompts(np, seed, cfg.vocab_size, prompts)[:4]
    eng, handles, wall, launches = serve_spec(
        torch, Engine, model, work, pa, speculate_k=2,
        speculate_tree=WIDE_TREE,
        drafter=NgramDrafter(max_ngram=3, min_ngram=2))
    st = eng.stats
    fallbacks = eng.metrics()["paged_attn"]["fallbacks"]
    print(f"routes {len(WIDE_TREE)}-node tree kernel engine: "
          f"{serve_summary(handles, wall)}, fallbacks {fallbacks}, launches "
          f"{launches}, stats {dict(st)}", flush=True)
    want = {name: 0 for name in pa.KERNELS}
    want.update(paged_decode=cfg.num_layers * st["decode_steps"],
                paged_window=cfg.num_layers * (st["prefill_chunks"]
                                               + st["verify_steps"]))
    if (fallbacks != ["tree_verify_paged"] or launches != want
            or st["tree_verify_steps"] == 0):
        raise SmokeFailure(f"the wide-tree engine falls back on {fallbacks},"
                           f" launched {launches} (its steps need {want}) "
                           f"and verified {st['tree_verify_steps']} trees")
    _, ref, _, _ = serve_spec(torch, Engine, model, work, pa,
                              paged_attn="einsum")
    agree_with_plain(torch, np, model, work, handles, ref,
                     f"routes {len(WIDE_TREE)}-node tree")

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn((2, 256, 4, 48), generator=g, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    before = (attention.dense_routes,
              {name: fn.launches for name, fn in fa.KERNELS.items()})
    got = attention.multihead_attention(q, k, v, causal=True, impl="flash",
                                        dtype=torch.bfloat16)
    after = (attention.dense_routes,
             {name: fn.launches for name, fn in fa.KERNELS.items()})
    want = attention.dense_attention(q, k, v, causal=True,
                                     dtype=torch.bfloat16)
    print(f"routes flash head-dim-48: dense routes {before[0]} -> "
          f"{after[0]}, flash launches {after[1]}", flush=True)
    if after != (before[0] + 1, before[1]) or not torch.equal(got, want):
        raise SmokeFailure("flash attention at head dim 48 was not routed "
                           "to the dense math")


# -- phase 5: flash kernels vs their plain versions -----------------------


def projection_views(torch, b, t, h, dh, dtype, seed):
    """q, k, v as the model makes them — strided views of one ``(b, t,
    3 h dh)`` projection — and a random ``do``, from ``seed``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, t, 3 * h * dh), generator=g, device="cuda")
    qkv = qkv.to(dtype)
    q, k, v = (z.reshape(b, t, h, dh) for z in qkv.chunk(3, dim=-1))
    do = torch.randn((b, t, h, dh), generator=g, device="cuda").to(dtype)
    return qkv, q, k, v, do


def compare(torch, got, want, tol):
    """``(max_abs_err, ok)`` of ``got`` against ``want`` in float32."""
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    return err, torch.allclose(got, want, **tol)


def tile_rel_err(torch, got, want, rows=64) -> float:
    """The largest error of a tile of ``rows`` tokens of a ``(b, t, h,
    dh)`` output relative to the reference's size there: the norm of
    ``got - want`` over the tile over the norm of ``want``.  Where the
    rows' values are small (long causal rows at t 2048), an absolute
    tolerance reads a wrong tile as a right one; this does not."""
    got, want = got.float(), want.float()
    err2 = (got - want).square().sum(dim=(0, 2, 3))
    ref2 = want.square().sum(dim=(0, 2, 3))
    tile = torch.arange(got.shape[1], device=got.device) // rows
    n = int(tile[-1]) + 1
    err2, ref2 = (torch.zeros(n, device=got.device).index_add_(0, tile, x)
                  for x in (err2, ref2))
    return (err2 / ref2.clamp_min(1e-30)).sqrt().max().item()


def check_flash_kernels(torch, fa) -> None:
    """K1-K3 against the plain versions on the same inputs; the backward
    kernels take the plain forward's ``o`` and ``lse``, so each kernel is
    held on its own.  Each kernel runs before the plain version of its
    output, so no cached block can hand it the reference's values.  bf16
    outputs are also held to BF16_TILE_REL_ERR by :func:`tile_rel_err`.
    The t = 96 case runs through the public op (128 blocks clamped to 96)
    and its autograd backward as well."""
    fp32 = dict(atol=2e-5, rtol=2e-5)
    tol_fwd = {torch.float32: fp32,
               torch.bfloat16: dict(atol=2e-2, rtol=1.6e-2)}
    tol_grad = {torch.float32: dict(atol=1e-4, rtol=1e-4),
                torch.bfloat16: dict(atol=2e-2, rtol=1.6e-2)}
    failures = []
    seed = 0
    for cname, (b, t, h, dh) in FLASH_CASES.items():
        for causal in (True, False):
            for dtype in (torch.float32, torch.bfloat16):
                seed += 1
                qkv, q, k, v, do = projection_views(torch, b, t, h, dh,
                                                    dtype, seed)
                got = dict(zip(("o", "lse"),
                               fa.flash_fwd(q, k, v, causal=causal)))
                o_ref, lse_ref = fa._flash_fwd_plain(q, k, v, causal)
                delta = fa._delta(o_ref, do)
                got["dq"] = fa.flash_dq(q, k, v, do, lse_ref, delta,
                                        causal=causal)
                got["dk"], got["dv"] = fa.flash_dkv(q, k, v, do, lse_ref,
                                                    delta, causal=causal)
                ref = {"o": o_ref, "lse": lse_ref,
                       "dq": fa._dq_plain(q, k, v, do, lse_ref, delta,
                                          causal)}
                ref["dk"], ref["dv"] = fa._dkv_plain(q, k, v, do, lse_ref,
                                                     delta, causal)
                tols = {"o": tol_fwd[dtype], "lse": fp32,
                        "dq": tol_grad[dtype], "dk": tol_grad[dtype],
                        "dv": tol_grad[dtype]}
                if cname == "t96-clamped":
                    qkv.requires_grad_(True)
                    q, k, v = (z.reshape(b, t, h, dh)
                               for z in qkv.chunk(3, dim=-1))
                    o = fa.flash_attention(q, k, v, causal=causal)
                    got["public o"] = o
                    grads = torch.autograd.grad(o, (q, k, v), do)
                    for key, g in zip(("dq", "dk", "dv"), grads):
                        got[f"autograd {key}"] = g
                    ref["public o"] = ref["o"]
                    bwd = fa._flash_bwd_plain(q.detach(), k.detach(),
                                              v.detach(), o_ref, lse_ref,
                                              do, causal)
                    for key, r in zip(("dq", "dk", "dv"), bwd):
                        ref[f"autograd {key}"] = r
                        tols[f"autograd {key}"] = tol_grad[dtype]
                    tols["public o"] = tol_fwd[dtype]
                torch.cuda.synchronize()
                name = (f"{cname} {'causal' if causal else 'full'} "
                        f"{str(dtype)[6:]}")
                parts = []
                for key, want in ref.items():
                    err, ok = compare(torch, got[key], want, tols[key])
                    part = f"{key}={err:.3e}"
                    if dtype == torch.bfloat16 and key != "lse":
                        rel = tile_rel_err(torch, got[key], want)
                        ok = ok and rel <= BF16_TILE_REL_ERR
                        part += f" (tile rel {rel:.2e})"
                    parts.append(part + ("" if ok else " MISS"))
                    if not ok:
                        failures.append(f"{name} {key}")
                print(f"flash-check {name}: " + " ".join(parts), flush=True)
    if failures:
        raise SmokeFailure(f"flash kernels disagree with the plain version: "
                           f"{failures}")


# -- phase 6: the training main path --------------------------------------


def step_split_ms(torch, F, model, optimizer, x, y) -> dict:
    """One training step taken piece by piece between CUDA events — the
    body of ``make_train_step`` at ``grad_accum=1`` with no clipping:
    ms of forward plus loss, of backward, of the optimizer update."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    optimizer.zero_grad(set_to_none=True)
    ev[0].record()
    logits = model(x, train=True)
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           y.reshape(-1))
    ev[1].record()
    loss.backward()
    ev[2].record()
    optimizer.step()
    ev[3].record()
    ev[3].synchronize()
    return {part: a.elapsed_time(b) for part, a, b in
            zip(("forward", "backward", "optimizer"), ev, ev[1:])}


def kernel_category(name: str) -> str:
    if "tpudp::" in name:
        return name.split("tpudp::")[1].split("<")[0]  # the port's kernels
    low = name.lower()
    if any(tag in low for tag in ("gemm", "nvjet", "xmma", "cutlass")):
        return "matmul"
    return "other"


def profile_call(torch, fn) -> dict | None:
    """Device time of one call of ``fn`` by kernel category (ms), the
    largest kernels outside the port's own and the matmuls, the number
    of device kernels and the device's busy share of the call's wall
    time, from ``torch.profiler``; None when the profiler saw no device
    kernel."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    # Device activity only: GPU-timeline annotations such as
    # "Optimizer.step#SGD.step" span kernels and would count them twice.
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        return None
    by_cat: dict[str, float] = {}
    other: dict[str, float] = {}
    for e in kernels:
        cat = kernel_category(e.name)
        ms = e.time_range.elapsed_us() / 1e3
        by_cat[cat] = by_cat.get(cat, 0.0) + ms
        if cat == "other":
            other[e.name[:70]] = other.get(e.name[:70], 0.0) + ms
    busy_us, edge = 0.0, float("-inf")
    for start, end in sorted((e.time_range.start, e.time_range.end)
                             for e in kernels):
        busy_us += max(0.0, end - max(start, edge))
        edge = max(edge, end)
    return {"wall_ms": wall_us / 1e3, "busy_share": busy_us / wall_us,
            "kernels": len(kernels),
            "device_ms": {k: round(v, 3) for k, v in sorted(
                by_cat.items(), key=lambda kv: -kv[1])},
            "top_other_ms": {k: round(v, 3) for k, v in sorted(
                other.items(), key=lambda kv: -kv[1])[:4]}}


def profile_decode_step(torch, Engine, model, prompts, label, **kw):
    """One scheduler step with all 8 requests decoding (96 new tokens
    each, so none has finished when the last prefill chunk lands), under
    ``torch.profiler``; prints and returns :func:`profile_call`'s dict."""
    eng = Engine(model, device="cuda", num_slots=8, prefill_chunk=16,
                 kv_pages=512, **kw)
    for p in prompts:
        eng.submit(p, 3 * NEW_TOKENS)
    while eng._next_prefill_slot() is not None or eng.queue_depth:
        eng.step()
    eng.step()  # one plain decode step off the clock
    prof = profile_call(torch, eng.step)
    eng.close()
    print(f"{label} decode-step profile (8 slots decoding): "
          + ("profiler saw no device kernel: device time not measured"
             if prof is None else
             f"{prof['wall_ms']:.2f} ms wall, {prof['kernels']} device "
             f"kernels, device busy {100 * prof['busy_share']:.1f}%, device "
             f"ms by kernel {prof['device_ms']}, largest other kernels "
             f"{prof['top_other_ms']}"), flush=True)
    return prof


def train_run(torch, train, gpt2, cfg, seed, batches, kernels) -> dict:
    """Train a fresh ``build(cfg, seed)`` on ``batches``: TRAIN_WARMUP
    steps, then the timed rest; the kernels' launch counts are read right
    after.  Then one step split into forward / backward / optimizer and
    one profiled step, which add launches and updates of their own.
    Returns the per-step losses, the timed steps' wall seconds, the
    run's peak device memory, the counts and the two breakdowns."""
    import torch.nn.functional as F

    model = gpt2.build(cfg, seed, "cuda")
    spec = train.make_optimizer(learning_rate=0.01)
    state = train.init_state(model, spec)
    step = train.make_train_step(model, spec)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for i, (x, y) in enumerate(batches):
        if i == TRAIN_WARMUP:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, loss = step(state, x, y)
        losses.append(loss)
    torch.cuda.synchronize()
    out = {"wall": time.perf_counter() - t0,
           "peak": torch.cuda.max_memory_allocated(),
           "launches": {name: fn.launches for name, fn in kernels.items()},
           "losses": torch.stack(losses).tolist()}
    out["split"] = step_split_ms(torch, F, model, state.optimizer, x, y)
    out["profile"] = profile_call(torch, lambda: step(state, x, y))
    del model, state, step
    torch.cuda.empty_cache()
    return out


def report_run(label: str, run: dict) -> None:
    n_tok = TRAIN_STEPS * TRAIN_BATCH * TRAIN_T
    print(f"main-path {label} training: {TRAIN_WARMUP + TRAIN_STEPS} steps, "
          f"losses {[round(x, 4) for x in run['losses']]}, "
          f"{n_tok / run['wall']:.1f} tokens/s, "
          f"{1e3 * run['wall'] / TRAIN_STEPS:.1f} ms/step, peak "
          f"{run['peak'] / 2**30:.2f} GiB", flush=True)
    split = ", ".join(f"{k} {v:.2f} ms" for k, v in run["split"].items())
    prof = run["profile"]
    prof_text = ("profiler saw no device kernel: device time not measured"
                 if prof is None else
                 f"profiled step {prof['wall_ms']:.1f} ms wall, device busy "
                 f"{100 * prof['busy_share']:.1f}%, device ms by kernel "
                 f"{prof['device_ms']}, largest other kernels "
                 f"{prof['top_other_ms']}")
    print(f"main-path {label} breakdown: {split}; {prof_text}", flush=True)


def train_main_path(torch, np, fa, seed: int) -> dict:
    from tpudp_torch import train
    from tpudp_torch.models import gpt2

    cfg = gpt2.GPT2Config(max_seq_len=TRAIN_T, dtype=torch.bfloat16,
                          attn_impl="flash")  # GPT-2 small widths
    n_steps = TRAIN_WARMUP + TRAIN_STEPS
    rng = np.random.default_rng(seed)
    tokens = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, size=(n_steps, TRAIN_BATCH, TRAIN_T + 1)),
        device="cuda")
    batches = [(tok[:, :-1], tok[:, 1:]) for tok in tokens]

    from tpudp_torch.ops import attention

    for fn in fa.KERNELS.values():
        fn.launches = 0
    routes = attention.dense_routes
    flash = train_run(torch, train, gpt2, cfg, seed, batches, fa.KERNELS)
    launches = flash["launches"]
    if attention.dense_routes != routes:
        raise SmokeFailure(f"{attention.dense_routes - routes} flash calls "
                           f"of the training path went to the dense math")
    for name, n in launches.items():
        if n != cfg.num_layers * n_steps:
            raise SmokeFailure(f"kernel {name} launched {n} times in "
                               f"{n_steps} training steps of "
                               f"{cfg.num_layers} layers")
    report_run("flash", flash)
    print(f"main-path flash launches {launches}", flush=True)

    dense_cfg = gpt2.GPT2Config(max_seq_len=TRAIN_T, dtype=torch.bfloat16,
                                attn_impl="dense")
    for fn in fa.KERNELS.values():
        fn.launches = 0
    dense = train_run(torch, train, gpt2, dense_cfg, seed, batches,
                      fa.KERNELS)
    if any(dense["launches"].values()) or any(
            fn.launches for fn in fa.KERNELS.values()):
        raise SmokeFailure("the dense-attention run launched a flash kernel")
    report_run("dense", dense)
    if not all(np.isfinite(flash["losses"] + dense["losses"])):
        raise SmokeFailure("a training loss is not finite")
    rel = max(abs(a - b) / abs(b)
              for a, b in zip(flash["losses"], dense["losses"]))
    if rel > 2e-2:
        raise SmokeFailure(f"flash and dense training losses differ by "
                           f"{rel:.3e} (rtol 2e-2)")
    print(f"main-path training losses agree with dense attention (max "
          f"relative difference {rel:.3e}, rtol 2e-2)", flush=True)
    return launches


# -- phase 7: timing -------------------------------------------------------


def time_ms(torch, fn, n=50):
    """Three medians of ``n`` single-call timings each, after warm-up:
    ``(ms, device_ms, host_ms)``.  ``ms`` is read by CUDA events around
    the call as the host submits it to an idle device, so it holds the
    host's submission as well as the device time; ``device_ms`` by
    events around the call queued behind a device spin, so it holds the
    device time alone; ``host_ms`` by the host's clock around that queued
    call, the host's time to submit it (and to wait, if the call waits on
    the device).  Where a call's host work outlasts the spin, as the
    plain versions' may, ``device_ms`` holds some of it as well."""
    for _ in range(5):
        fn(0)
    torch.cuda.synchronize()
    times = ([], [], [])
    for spin in (False, True):
        for i in range(n):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            if spin:
                torch.cuda._sleep(SPIN_CYCLES)
            a.record()
            t0 = time.perf_counter()
            fn(i)
            host = time.perf_counter() - t0
            b.record()
            b.synchronize()
            times[spin].append(a.elapsed_time(b))
            if spin:
                times[2].append(1e3 * host)
    return tuple(sorted(x)[n // 2] for x in times)


def timed(prefix, readings) -> dict:
    """``time_ms``'s three readings under record keys: ``{prefix}ms``,
    ``{prefix}device_ms`` and ``{prefix}host_ms``."""
    return dict(zip((f"{prefix}ms", f"{prefix}device_ms", f"{prefix}host_ms"),
                    readings))


def timing_line(r, library: str) -> str:
    name = f"{r['name']} {r['case']}" if "case" in r else r["name"]
    return (f"timing {name}: {r['ms']:.4f} ms (device "
            f"{r['device_ms']:.4f}, host {r['host_ms']:.4f}; bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']}), plain "
            f"{r['plain_ms']:.4f} ms (device {r['plain_device_ms']:.4f}), "
            f"{library} {r['library_ms']:.4f} ms (device "
            f"{r['library_device_ms']:.4f}, host {r['library_host_ms']:.4f})")


def timing_case(torch, cfg, pos_list, cur, scalar, device, seed,
                kv_dtype=None):
    """Whole-pool inputs at the main path's shapes: a (layers, 513, 16,
    kv heads, dh) float32 pool — quantized by the port's quantizer for
    ``kv_dtype="int8"`` — and one table row per slot mapping distinct
    pages up to its depth.  Returns ``q, pages, table, pos`` (``pos`` a
    host int for a scalar depth, else an int32 tensor on the card)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    page_tokens, max_pages, n_pages = 16, 64, 512
    h, dh = cfg.num_heads, cfg.d_model // cfg.num_heads
    kvh = getattr(cfg, "kv_heads", h)
    b = len(pos_list)
    gd = torch.Generator(device=device).manual_seed(seed)
    shape = (cfg.num_layers, n_pages + 1, page_tokens, kvh, dh)
    k = torch.randn(shape, generator=gd, device=device)
    v = torch.randn(shape, generator=gd, device=device)
    perm = torch.randperm(n_pages, generator=g).tolist()
    table = torch.full((b, max_pages), -1, dtype=torch.int32)
    for s, p in enumerate(pos_list):
        for i in range((p + cur - 1) // page_tokens + 1):
            table[s, i] = perm.pop()
    q = torch.randn((b, cur, h, dh), generator=gd, device=device)
    # A prefill chunk's depth is a host int, as the engine passes it.
    pos = (pos_list[0] if scalar
           else torch.tensor(pos_list).to(device, torch.int32))
    pages = ((k, v) if kv_dtype is None
             else int8_pool(torch, k, v, (slice(None), 0, 0, 0)))
    return q, pages, table.to(device), pos


def kernel_record(torch, F, pa, name, q, pages, table, pos, launches):
    """Time kernel ``name``, its plain version and SDPA on the same
    inputs, cycling the layer so successive launches read other pages
    (as a forward does); bound from the bytes and flops these inputs
    need."""
    layers = pages[0].shape[0]
    fn = pa.KERNELS[name]
    b, cur, h, dh = q.shape
    page_tokens, kvh = pages[0].shape[2], pages[0].shape[3]
    pos_v = torch.as_tensor(pos, device=q.device).expand(b)
    pos_l = pos_v.tolist()

    def layer_of(i):
        return tuple(buf[i % layers] for buf in pages)

    ms = time_ms(torch, lambda i: fn(q, *pages, table, pos,
                                     layer=i % layers))
    plain_ms = time_ms(torch, lambda i: pa._einsum_paged(
        q, layer_of(i), table, pos, dtype=q.dtype, grouped=True))
    # SDPA yardstick on K/V gathered (dequantized, KV heads expanded to
    # the query heads) outside the timing to dense rows.
    n_keys = max(pos_l) + cur
    dense_k, dense_v = [], []
    for layer in range(layers):
        kt, vt = pa.page_tiles(layer_of(layer), table, q.dtype)
        for dense, t in ((dense_k, kt), (dense_v, vt)):
            dense.append(t.flatten(1, 2)[:, :n_keys]
                         .repeat_interleave(h // kvh, dim=2)
                         .permute(0, 2, 1, 3).contiguous())
    key_pos = torch.arange(n_keys, device=q.device)
    q_pos = pos_v[:, None] + torch.arange(cur, device=q.device)
    mask = (key_pos <= q_pos[..., None])[:, None]  # (b, 1, cur, n_keys)
    qd = q.permute(0, 2, 1, 3).contiguous()
    library_ms = time_ms(torch, lambda i: F.scaled_dot_product_attention(
        qd, dense_k[i % layers], dense_v[i % layers], attn_mask=mask))
    # What these inputs need: every visible K/V row once (distinct
    # (page, row) pairs over the slots) with its scales over int8 pages,
    # q read once, out written once.
    visible = set()
    flops = 0
    tbl = table.cpu().tolist()
    for s in range(b):
        for key in range(pos_l[s] + cur):
            visible.add((tbl[s][key // page_tokens], key % page_tokens))
        flops += sum(pos_l[s] + j + 1 for j in range(cur)) * h * dh * 4
    row_bytes = dh * pages[0].element_size() + (4 if len(pages) == 4 else 0)
    bytes_ = (len(visible) * kvh * 2 * row_bytes
              + 2 * q.numel() * q.element_size())
    peak = FP32_FLOP_PER_S if q.dtype == torch.float32 else BF16_FLOP_PER_S
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, flops / peak
    err = (fn(q, *pages, table, pos, layer=0).float()
           - pa._einsum_paged(q, layer_of(0), table, pos, dtype=q.dtype,
                              grouped=True).float()).abs().max().item()
    return {"name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": err, **timed("", ms), **timed("plain_", plain_ms),
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            **timed("library_", library_ms)}


def tree_record(torch, F, pa, cfg, pos_list, launches):
    """Time K6, its plain version and SDPA on the gathered cache K/V
    concatenated with the window under a boolean mask, cycling the layer;
    bound from the bytes and flops these inputs need."""
    from tpudp_torch.serve.speculate import TREE_SHAPES

    anc = TREE_SHAPES["fork2x2"].ancestors
    t1 = len(anc)
    q, (k, v), table, pos0 = timing_case(torch, cfg, pos_list, t1, False,
                                         "cuda", seed=3)
    layers, kvh, dh = k.shape[0], k.shape[3], k.shape[4]
    q, wk, wv = window_views(torch, q, kvh, seed=3)
    b, _, h, _ = q.shape
    page_tokens = k.shape[2]
    pos_l = pos0.tolist()
    fn = pa.KERNELS["paged_tree"]
    ms = time_ms(torch, lambda i: fn(q, k, v, table, pos0, wk, wv, anc,
                                     layer=i % layers))
    plain_ms = time_ms(torch, lambda i: pa._tree_plain(
        q, k, v, table, pos0, wk, wv, anc, i % layers))
    # SDPA yardstick on cache K/V gathered (outside the timing) to dense
    # rows, followed by the window's K/V.
    n_keys = max(pos_l)
    wkd, wvd = (w.permute(0, 2, 1, 3) for w in (wk, wv))
    dense_k, dense_v = [], []
    for layer in range(layers):
        kt, vt = pa.page_tiles((k[layer], v[layer]), table, q.dtype)
        dense_k.append(torch.cat([kt.flatten(1, 2)[:, :n_keys]
                                  .permute(0, 2, 1, 3), wkd], 2).contiguous())
        dense_v.append(torch.cat([vt.flatten(1, 2)[:, :n_keys]
                                  .permute(0, 2, 1, 3), wvd], 2).contiguous())
    cache_vis = (torch.arange(n_keys, device=q.device)
                 < pos0[:, None]).expand(b, n_keys)
    anc_t = torch.as_tensor(anc, device=q.device)
    mask = torch.cat([cache_vis[:, None].expand(b, t1, n_keys),
                      anc_t[None].expand(b, t1, t1)], 2)[:, None]
    qd = q.permute(0, 2, 1, 3).contiguous()
    library_ms = time_ms(torch, lambda i: F.scaled_dot_product_attention(
        qd, dense_k[i % layers], dense_v[i % layers], attn_mask=mask))
    # What these inputs need: every strictly visible cache K/V row once
    # (distinct (page, row) pairs), the window K/V, q read once, out
    # written once; 4 dh flops per head and (node, visible key) pair.
    tbl = table.cpu().tolist()
    visible = {(tbl[s][key // page_tokens], key % page_tokens)
               for s in range(b) for key in range(pos_l[s])}
    n_anc = sum(map(sum, anc))
    flops = sum(t1 * pos_l[s] + n_anc for s in range(b)) * h * dh * 4
    bytes_ = (len(visible) * kvh * dh * 2 + 2 * wk.numel()
              + 2 * q.numel()) * k.element_size()
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    err = (fn(q, k, v, table, pos0, wk, wv, anc, layer=0).float()
           - pa._tree_plain(q, k, v, table, pos0, wk, wv, anc, 0).float()
           ).abs().max().item()
    return {"name": "paged_tree", "route": "cuda",
            "source": SOURCES["paged_tree"],
            "replaces": REPLACES["paged_tree"],
            "launches": launches["paged_tree"], "max_abs_err": err,
            **timed("", ms), **timed("plain_", plain_ms),
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            **timed("library_", library_ms)}


def timings(torch, pa, model, prompts, launches):
    import torch.nn.functional as F

    cfg = model.config
    # Decode: the eight slots midway through their completions.
    decode_pos = [p.size + NEW_TOKENS // 2 for p in prompts]
    # The int8 variants at phase 4c's shapes (LLaMA-GQA, int8 pool,
    # float32 queries), then the fp kernels at phase 4's (GPT-2 small).
    llama_cfg = SimpleNamespace(num_layers=12, num_heads=12, kv_heads=3,
                                d_model=768)
    rec = []
    for suffix, case_cfg, kv_dtype in (("_int8", llama_cfg, "int8"),
                                       ("", cfg, None)):
        # Decode: the eight slots midway through their completions.
        q, pages, table, pos = timing_case(torch, case_cfg, decode_pos, 1,
                                           False, "cuda", 1, kv_dtype)
        rec.append(kernel_record(torch, F, pa, "paged_decode" + suffix, q,
                                 pages, table, pos, launches))
        # Prefill: one 16-token chunk of the 300-token prompt at depth 144.
        q, pages, table, pos = timing_case(torch, case_cfg, [144], 16, True,
                                           "cuda", 2, kv_dtype)
        rec.append(kernel_record(torch, F, pa, "paged_window" + suffix, q,
                                 pages, table, pos, launches))
        rec[-1]["case"] = "prefill"
        del pages
    # Sequence verify: phase 4b's k+1 = 5 windows of the eight slots at
    # the decode depths, GPT-2 small over a float32 pool.
    q, pages, table, pos = timing_case(torch, cfg, decode_pos, 5, False,
                                       "cuda", 4)
    rec.append(kernel_record(torch, F, pa, "paged_window", q, pages, table,
                             pos, launches))
    rec[-1]["case"] = "verify"
    del pages
    # Tree verify: fork2x2 windows of the eight slots at phase 4's
    # decode depths.
    rec.append(tree_record(torch, F, pa, cfg, decode_pos, launches))
    for r in rec:
        print(timing_line(r, "sdpa"), flush=True)
    sms = pa._sm_count(torch.device("cuda"))
    for label, args in (("gpt2 decode", (8, 12, 12, 1024)),
                        ("llama-gqa decode", (8, 12, 3, 1024))):
        print(f"schedule paged_decode {label}: "
              f"{pa.decode_schedule(*args, sms=sms)}", flush=True)
    for label, args in (("gpt2 prefill", (1, 16, 12, 12, 160)),
                        ("llama-gqa prefill", (1, 16, 12, 3, 160)),
                        ("gpt2 verify", (8, 5, 12, 12, 1024))):
        print(f"schedule paged_window {label}: "
              f"{pa.window_schedule(*args, sms=sms)}", flush=True)
    return rec


def flash_bound(kind, b, t, h, dh, itemsize, causal):
    """``(bytes, flops)`` the function needs on these shapes: each input
    read once, each output written once; flops over the visible (query,
    key) pairs — 4 dh per pair forward (q k and p v), 6 dh for dq (q k,
    do v and ds k), 8 dh for dk/dv (those less ds k, plus p do and ds q)."""
    pairs = b * h * (t * (t + 1) // 2 if causal else t * t)
    elems = b * t * h * dh * itemsize  # one (b, t, h, dh) tensor
    rows = b * h * t * 4               # one float32 (b, h, t) tensor
    return {"flash_fwd": (4 * elems + rows, 4 * dh * pairs),
            "flash_dq": (5 * elems + 2 * rows, 6 * dh * pairs),
            "flash_dkv": (6 * elems + 2 * rows, 8 * dh * pairs)}[kind]


def flash_timings(torch, fa, launches):
    """K1, K2 and K3 at the training main path's shapes (b 4, t 2048, h
    12, dh 64, bfloat16, causal), on projection views, beside their
    plain versions and SDPA's causal forward / autograd backward."""
    import torch.nn.functional as F

    b, t, h, dh = TRAIN_BATCH, TRAIN_T, 12, 64
    _, q, k, v, do = projection_views(torch, b, t, h, dh, torch.bfloat16, 7)
    o, lse = fa.flash_fwd(q, k, v, causal=True)
    delta = fa._delta(o, do)
    qd, kd, vd = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    dod = do.transpose(1, 2).contiguous()
    sdpa_out = F.scaled_dot_product_attention(qd, kd, vd, is_causal=True)
    sdpa_fwd_ms = time_ms(torch, lambda i: F.scaled_dot_product_attention(
        qd, kd, vd, is_causal=True), n=20)
    sdpa_bwd_ms = time_ms(torch, lambda i: torch.autograd.grad(
        sdpa_out, (qd, kd, vd), dod, retain_graph=True), n=20)
    fns = {
        "flash_fwd": (lambda i: fa.flash_fwd(q, k, v, causal=True),
                      lambda i: fa._flash_fwd_plain(q, k, v, True),
                      sdpa_fwd_ms),
        "flash_dq": (lambda i: fa.flash_dq(q, k, v, do, lse, delta),
                     lambda i: fa._dq_plain(q, k, v, do, lse, delta, True),
                     sdpa_bwd_ms),
        "flash_dkv": (lambda i: fa.flash_dkv(q, k, v, do, lse, delta),
                      lambda i: fa._dkv_plain(q, k, v, do, lse, delta, True),
                      sdpa_bwd_ms),
    }
    records = []
    for name, (kernel, plain, library_ms) in fns.items():
        got = kernel(0)  # before any plain call: see check_flash_kernels
        ms = time_ms(torch, kernel, n=20)
        plain_ms = time_ms(torch, plain, n=10)
        want = plain(0)
        if name == "flash_dq":  # the others return (o, lse), (dk, dv)
            got, want = (got,), (want,)
        err = max((g.float() - w.float()).abs().max().item()
                  for g, w in zip(got, want))
        bytes_, flops = flash_bound(name, b, t, h, dh, 2, True)
        t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
        records.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": err, **timed("", ms), **timed("plain_", plain_ms),
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            **timed("library_", library_ms)})
    for r in records:
        print(timing_line(r, "sdpa forward" if r["name"] == "flash_fwd"
                          else "sdpa backward"), flush=True)
    print(f"timing flash backward (dq + dk/dv kernels): "
          f"{records[1]['ms'] + records[2]['ms']:.4f} ms (device "
          f"{records[1]['device_ms'] + records[2]['device_ms']:.4f}), sdpa "
          f"backward {sdpa_bwd_ms[0]:.4f} ms (device {sdpa_bwd_ms[1]:.4f})",
          flush=True)
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    try:
        import numpy as np
        import torch
    except ImportError as exc:
        print(f"chip_smoke: {exc}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        from tpudp_torch.ops import _build
        from tpudp_torch.ops import flash_attention as fa
        from tpudp_torch.ops import paged_attention as pa
    except ImportError as exc:
        print(f"chip_smoke: the tpudp_torch package is not beside this "
              f"script ({exc})", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        card = device_line()
        print(f"device: {card}", flush=True)
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"python {sys.version.split()[0]}", flush=True)
        t0 = time.perf_counter()
        _build.build()
        print(f"build: {time.perf_counter() - t0:.2f}s for "
              f"{sorted(_build.SIGNATURES)}", flush=True)
        hgmma = hgmma_counts(_build)
        print(f"build: HGMMA instructions in the SASS {hgmma}", flush=True)
        if not all(hgmma.values()):
            raise SmokeFailure(f"a tensor-core flash library has no HGMMA "
                               f"instruction: {hgmma}")
        check_kernels(torch, pa, "cuda")
        check_window_edges(torch, pa, "cuda", int8=False)
        check_tree_kernels(torch, pa, "cuda")
        check_int8_kernels(torch, pa, "cuda")
        check_window_edges(torch, pa, "cuda", int8=True)
        check_decode_edges(torch, pa, "cuda")
        model, prompts, launches = main_path(torch, np, pa, args.seed)
        launches.update(spec_main_path(torch, np, pa, model, prompts,
                                       args.seed))
        launches.update(llama_main_path(torch, np, pa, args.seed))
        routes_path(torch, np, pa, fa, model, prompts, args.seed)
        check_flash_kernels(torch, fa)
        train_launches = train_main_path(torch, np, fa, args.seed)
        records = timings(torch, pa, model, prompts, launches)
        records += flash_timings(torch, fa, train_launches)
    except Exception:  # every phase failure ends the run without a result
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(f"card: {card}")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
