#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Runs from the root of a checkout, needs one CUDA card and ``nvcc``, and
imports nothing of JAX or of the JAX package ``tpudp``.  Phases, each of
which fails the run (nonzero exit, no result line) when it fails:

  1. device — the card's name and power limit, as nvidia-smi reports them;
  2. build — every CUDA kernel of the port, from ``tpudp_torch/csrc``,
     one nvcc per source, all started together;
  3. kernels vs plain — each kernel against its plain PyTorch version on
     the same inputs: fragmented block tables (pages shared between
     slots, ``-1`` tails, whole-pool ``layer=`` mode), GPT-2 small's
     heads and a grouped-query shape, decode / prefill / 3-token windows,
     float32 (atol = rtol = 2e-5: only the summation order differs) and
     bfloat16 (atol 2e-2 and rtol 1.6e-2, two bf16 ulps: the plain
     path rounds probabilities to bf16 before P.V, the kernels keep them
     in float32, and both round outputs above 2 to a 1/64 grid);
  4. main path — GPT-2 small at full width (random weights from --seed,
     float32) served by ``Engine(kv_pages=512)`` on the card, which
     resolves to the CUDA kernels; 8 greedy requests of 17-300 prompt
     tokens, two sharing a 64-token prefix (the second is admitted after
     the first retired, so its prefix is mapped from the page index).
     Every kernel must have launched in that run, the page bookkeeping
     must check, and the tokens must equal the same engine's on the
     plain PyTorch attention — or differ first where the plain logits'
     top-2 gap is below 1e-3 (a near-tie of the random weights);
  5. timing — each kernel at the main path's shapes against its byte /
     flop bound, its plain version and one PyTorch library call
     (``scaled_dot_product_attention`` on the gathered K/V, a yardstick
     the port never calls), with CUDA events.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12       # outside the tensor cores
BF16_FLOP_PER_S = 989e12      # tensor cores, dense
NEW_TOKENS = 32  # per request on the main path
REPLACES = {
    "paged_decode": "tpudp/ops/paged_attention.py:161",
    "paged_window": "tpudp/ops/paged_attention.py:319",
}
SOURCES = {
    "paged_decode": "tpudp_torch/csrc/paged_decode.cu",
    "paged_window": "tpudp_torch/csrc/paged_window.cu",
}


class SmokeFailure(RuntimeError):
    pass


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# -- phase 3: kernels vs their plain versions ---------------------------


def fragmented_case(torch, *, b, h, kv, dh, page_tokens, max_pages, cur,
                    scalar_pos, dtype, layers, seed, device):
    """A pool and block tables shaped like copy-on-write traffic: slots
    0-3 map the same prefix pages, every slot continues into private
    pages, entries past each slot's window are ``-1`` except for a few
    mapped stale pages, and the pool holds ``layers`` layers (one
    selected by ``layer``, the others noise).  Every entry a query can
    see is mapped, as the engine guarantees."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    t_max = max_pages * page_tokens
    if scalar_pos:
        p0 = int(torch.randint(0, t_max - cur, (1,), generator=g))
        p0 -= p0 % page_tokens
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


def serve(torch, Engine, model, prompts, paged_attn):
    """Serve the prompts on one engine: 0-6 at once, 7 (prompt 0's
    prefix) once request 0 has retired; the page bookkeeping is checked
    at both points, outside the timing.  Returns the engine, handles and
    wall seconds of the serving."""
    eng = Engine(model, device="cuda", num_slots=8, prefill_chunk=16,
                 kv_pages=512, paged_attn=paged_attn)
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


def main_path(torch, np, pa, seed: int):
    from tpudp_torch.models import gpt2
    from tpudp_torch.models.generate import KVCache, _forward_cached
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
    for name, n in launches.items():
        if n == 0:
            raise SmokeFailure(f"kernel {name} never launched on the main "
                               f"path")
    if eng.stats["prefix_hit_tokens"] < 64:
        raise SmokeFailure(f"the shared prefix was not mapped: "
                           f"{dict(eng.stats)}")
    if not all(h.ok and len(h.tokens) == NEW_TOKENS for h in handles):
        raise SmokeFailure("a request did not complete")
    n_tok = sum(len(h.tokens) for h in handles)
    ttft = sorted(h.token_times[0] - h.submit_time for h in handles)
    print(f"main-path kernel engine: {len(handles)} requests, {n_tok} "
          f"tokens in {wall:.3f}s = {n_tok / wall:.1f} tokens/s, TTFT p50 "
          f"{1e3 * ttft[len(ttft) // 2]:.1f} ms, launches {launches}, "
          f"stats {dict(eng.stats)}", flush=True)

    _, ref, ref_wall = serve(torch, Engine, model, prompts, "einsum")
    if any(fn.launches != launches[n] for n, fn in pa.KERNELS.items()):
        raise SmokeFailure("the plain engine launched a kernel")
    print(f"main-path plain engine: {n_tok / ref_wall:.1f} tokens/s",
          flush=True)
    for i, (h, r) in enumerate(zip(handles, ref)):
        if h.tokens == r.tokens:
            continue
        t = next(j for j, (a, b) in enumerate(zip(h.tokens, r.tokens))
                 if a != b)
        seq = np.concatenate([prompts[i], np.asarray(r.tokens[:t])])
        cache = KVCache.zeros(cfg, 1, seq.size, "cuda")
        with torch.no_grad():
            logits, _ = _forward_cached(
                model, torch.as_tensor(seq, device="cuda")[None].long(),
                cache, 0)
        top2 = torch.topk(logits[0, -1], 2).values
        gap = float(top2[0] - top2[1])
        print(f"request {i}: first differing token {t}, plain top-2 gap "
              f"{gap:.3e}", flush=True)
        if gap >= 1e-3:
            raise SmokeFailure(f"request {i} diverges at token {t} with a "
                               f"top-2 gap of {gap} (not a near-tie)")
    print(f"main-path tokens agree with the plain engine "
          f"({sum(h.tokens == r.tokens for h, r in zip(handles, ref))}/"
          f"{len(handles)} identical)", flush=True)
    return model, prompts, launches


# -- phase 5: timing -------------------------------------------------------


def time_ms(torch, fn, n=50):
    """Median of ``n`` single-launch CUDA-event timings, after warm-up."""
    for _ in range(5):
        fn(0)
    torch.cuda.synchronize()
    times = []
    for i in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(i)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[n // 2]


def timing_case(torch, cfg, pos_list, cur, scalar, device, seed):
    """Whole-pool inputs at the main path's shapes: a (layers, 513, 16,
    heads, dh) float32 pool, one table row per slot mapping distinct
    pages up to its depth."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    page_tokens, max_pages, n_pages = 16, 64, 512
    h, dh = cfg.num_heads, cfg.d_model // cfg.num_heads
    b = len(pos_list)
    gd = torch.Generator(device=device).manual_seed(seed)
    shape = (cfg.num_layers, n_pages + 1, page_tokens, h, dh)
    k = torch.randn(shape, generator=gd, device=device)
    v = torch.randn(shape, generator=gd, device=device)
    perm = torch.randperm(n_pages, generator=g).tolist()
    table = torch.full((b, max_pages), -1, dtype=torch.int32)
    for s, p in enumerate(pos_list):
        for i in range((p + cur - 1) // page_tokens + 1):
            table[s, i] = perm.pop()
    q = torch.randn((b, cur, h, dh), generator=gd, device=device)
    pos = (torch.tensor(pos_list[0]) if scalar
           else torch.tensor(pos_list)).to(device, torch.int32)
    return q, k, v, table.to(device), pos


def kernel_record(torch, F, pa, name, q, k, v, table, pos, launches):
    """Time kernel ``name``, its plain version and SDPA on the same
    inputs, cycling the layer so successive launches read other pages
    (as a forward does); bound from the bytes and flops these inputs
    need."""
    layers = k.shape[0]
    fn = pa.KERNELS[name]
    b, cur, h, dh = q.shape
    page_tokens = k.shape[2]
    pos_v = pos.expand(b)
    pos_l = pos_v.tolist()
    itemsize = k.element_size()

    ms = time_ms(torch, lambda i: fn(q, k, v, table, pos, layer=i % layers))
    plain_ms = time_ms(torch, lambda i: pa._einsum_paged(
        q, (k[i % layers], v[i % layers]), table, pos, dtype=q.dtype,
        grouped=True))
    # SDPA yardstick on K/V gathered (outside the timing) to dense rows.
    n_keys = max(pos_l) + cur
    dense_k, dense_v = [], []
    for layer in range(layers):
        kt, vt = pa.page_tiles((k[layer], v[layer]), table, q.dtype)
        dense_k.append(kt.flatten(1, 2)[:, :n_keys].permute(0, 2, 1, 3)
                       .contiguous())
        dense_v.append(vt.flatten(1, 2)[:, :n_keys].permute(0, 2, 1, 3)
                       .contiguous())
    key_pos = torch.arange(n_keys, device=q.device)
    q_pos = pos_v[:, None] + torch.arange(cur, device=q.device)
    mask = (key_pos <= q_pos[..., None])[:, None]  # (b, 1, cur, n_keys)
    qd = q.permute(0, 2, 1, 3).contiguous()
    library_ms = time_ms(torch, lambda i: F.scaled_dot_product_attention(
        qd, dense_k[i % layers], dense_v[i % layers], attn_mask=mask))
    # What these inputs need: every visible K/V row once (distinct
    # (page, row) pairs over the slots), q read once, out written once.
    visible = set()
    flops = 0
    tbl = table.cpu().tolist()
    for s in range(b):
        for key in range(pos_l[s] + cur):
            visible.add((tbl[s][key // page_tokens], key % page_tokens))
        flops += sum(pos_l[s] + j + 1 for j in range(cur)) * h * dh * 4
    kvh = k.shape[3]
    bytes_ = (len(visible) * kvh * dh * 2 + 2 * q.numel()) * itemsize
    peak = FP32_FLOP_PER_S if q.dtype == torch.float32 else BF16_FLOP_PER_S
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, flops / peak
    err = (fn(q, k, v, table, pos, layer=0).float()
           - pa._einsum_paged(q, (k[0], v[0]), table, pos, dtype=q.dtype,
                              grouped=True).float()).abs().max().item()
    return {"name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}


def timings(torch, pa, model, prompts, launches):
    import torch.nn.functional as F

    cfg = model.config
    # Decode: the eight slots midway through their completions.
    decode_pos = [p.size + NEW_TOKENS // 2 for p in prompts]
    q, k, v, table, pos = timing_case(torch, cfg, decode_pos, 1, False,
                                      "cuda", seed=1)
    rec = [kernel_record(torch, F, pa, "paged_decode", q, k, v, table,
                         pos, launches)]
    del k, v
    # Prefill: one 16-token chunk of the 300-token prompt at depth 144.
    q, k, v, table, pos = timing_case(torch, cfg, [144], 16, True, "cuda",
                                      seed=2)
    rec.append(kernel_record(torch, F, pa, "paged_window", q, k, v, table,
                             pos, launches))
    for r in rec:
        print(f"timing {r['name']}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f}"
              f" ms by {r['bound_by']}), plain {r['plain_ms']:.4f} ms, "
              f"sdpa {r['library_ms']:.4f} ms", flush=True)
    return rec


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
        check_kernels(torch, pa, "cuda")
        model, prompts, launches = main_path(torch, np, pa, args.seed)
        records = timings(torch, pa, model, prompts, launches)
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
