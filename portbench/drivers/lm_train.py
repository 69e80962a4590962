"""LM training cells: the step that ``train_cli.train`` builds, fed token
batches made on the device from the seed.

Set-up parses ``train_cli``'s flags for the configuration, takes the
build cache and the card lock as ``train`` does, builds the model with
the benchmark's weights, the optimizer and the rung through
``train_cli``'s own functions, then drives the first steps through the
step the window calls and reads them for the check.  The window cycles
the batches, fenced only at its two edges; ``--trace 1`` adds a profiled
sub-window at its end.  Once the window has closed and the program's
state is freed, the plain reference runs over the same weights
and the first batches, and compares.
"""

from __future__ import annotations

import math
import time

import torch

from portbench.harness import common, compare, faults, weights
from portbench.harness.trace import Profiled
from portbench.reference import gpt2 as ref
from portbench.reference.precision import strict_float32
from portbench.reference.sgd import leaf_norms

#: Host ranges whose kernels are flash attention's: ``_Flash``'s forward
#: and its backward node.
RANGES = {"flash": lambda name: name == "_Flash"
          or name.endswith("_FlashBackward")}


def _argv(ctx: common.Ctx) -> list[str]:
    c, t, prog = ctx.config, ctx.traffic, ctx.config["program"]
    argv = ["--layers", c["n_layer"], "--d-model", c["n_embd"],
            "--heads", c["n_head"], "--vocab", c["vocab_size"],
            "--seq-len", t["seq_len"], "--batch-size", t["batch"],
            "--dtype", prog["dtype"], "--attn", prog["attn"],
            "--device", ctx.device.type, "--lr", c["optimizer"]["lr"]]
    return [str(a) for a in argv]


def batches(ctx: common.Ctx, device) -> list:
    """``(tokens, targets)`` of each batch the cell cycles."""
    t = ctx.traffic
    g = weights.generator(ctx.seed, weights.STREAM_TOKENS, device)
    seqs = torch.randint(0, ctx.config["vocab_size"],
                         (t["batches"], t["batch"], t["seq_len"] + 1),
                         generator=g, device=device)
    return [(s[:, :-1].contiguous(), s[:, 1:].contiguous()) for s in seqs]


def _specs(ctx):
    return ref.param_specs(ctx.config, ctx.traffic["seq_len"])


def build(ctx: common.Ctx):
    """``(state, step, feed, spec)``: the program as ``train_cli.train``
    builds it on one card."""
    from tpudp_torch import train_cli
    from tpudp_torch.models import gpt2
    from tpudp_torch.train import init_state, make_optimizer
    from tpudp_torch.utils.compile_cache import enable_persistent_cache
    from tpudp_torch.utils.device_lock import acquire_for_process

    ctx.mark("import_program")
    args = train_cli.parse_args(_argv(ctx))
    device = ctx.device
    enable_persistent_cache()
    acquire_for_process(device)
    ctx.mark("cache_and_lock")
    common.init_device(device)
    ctx.mark("device_context")
    with torch.device("meta"):
        model = gpt2.GPT2(train_cli._model_config(args, 1))
    model = model.to_empty(device=device)
    weights.load_into(model, weights.make(_specs(ctx), ctx.seed, device))
    spec = make_optimizer(learning_rate=args.lr, momentum=0.9,
                          weight_decay=0.0, clip_norm=args.clip_norm,
                          skip_nonfinite=args.skip_nonfinite)
    state, step, shard_for, _ = train_cli._rung(
        args, model, spec, init_state(model, spec), 1)
    step = faults.wrap_step(ctx.fault, step)
    feed = [(shard_for(x), shard_for(y)) for x, y in batches(ctx, device)]
    common.fence(device)
    ctx.mark("model_and_data")
    return state, step, feed, spec


def first_grad(state, spec, ctx) -> dict:
    """Each leaf's first gradient as the optimizer got it, worked out
    from its momentum trace after one step (``g + wd * p0``)."""
    model, opt = state.model, state.optimizer
    bufs = {n: opt.state.get(p, {}).get("momentum_buffer",
                                        torch.zeros_like(p))
            for n, p in model.named_parameters()}
    if spec.weight_decay:
        p0 = weights.make(_specs(ctx), ctx.seed, ctx.device)
        bufs = {n: b - spec.weight_decay * p0[n] for n, b in bufs.items()}
    return leaf_norms(bufs)


def change(model, specs, ctx) -> dict:
    """Each leaf's change from the weights the run started from."""
    p0 = weights.make(specs, ctx.seed, ctx.device)
    now = model.state_dict()
    return leaf_norms({n: now[n] - p0[n] for n in p0})


def run(ctx: common.Ctx) -> dict:
    t = ctx.traffic
    state, step, feed, spec = build(ctx)
    losses, grad = [], None
    for k in range(t["check_steps"]):
        state, loss = step(state, *feed[k])
        losses.append(loss.detach().reshape(()))
        if k == 0:
            grad = first_grad(state, spec, ctx)
    prog = {"losses": torch.stack(losses).tolist(), "grad": grad,
            "change": change(state.model, _specs(ctx), ctx)}
    i = t["check_steps"]
    for _ in range(t["warmup_steps"]):
        state, _ = step(state, *feed[i % len(feed)])
        i += 1
    rec = {"items_per_step": t["batch"] * t["seq_len"],
           "profiled_steps": 0, "trace": None}
    if not ctx.check_only:
        fence = lambda: common.fence(ctx.device)  # noqa: E731
        fence()
        ctx.mark("first_steps")
        stop = common.Stopper(ctx)
        stop.start()
        rec["setup_s"] = stop.t0_wall - ctx.t0_wall
        rec["setup_parts"] = ctx.setup_parts()
        steps = 0
        while True:
            state, _ = step(state, *feed[i % len(feed)])
            i, steps = i + 1, steps + 1
            if stop.over():
                break
        fence()
        rec["window_s"] = time.perf_counter() - stop.t0
        rec["steps"] = steps
        if ctx.trace:
            prof = Profiled(ctx.device)
            prof.start()
            for _ in range(t["profile_steps"]):
                state, _ = step(state, *feed[i % len(feed)])
                i += 1
            prof.stop(fence)
            rec["profiled_steps"] = t["profile_steps"]
            rec["trace"] = prof.summary(RANGES)
        rec["finite"] = math.isfinite(float(state.loss_sum))
    rec["memory_peak_bytes"] = common.memory_peak(ctx.device)
    del state, step, feed, loss
    common.release(ctx.device)
    rec.update(check(ctx, prog))
    return rec


def reference(ctx: common.Ctx, precision: str) -> dict:
    with strict_float32():
        p0 = weights.make(_specs(ctx), ctx.seed, ctx.device)
        first = batches(ctx, ctx.device)[:ctx.traffic["check_steps"]]
        return ref.train(p0, first, ctx.config, precision,
                         ctx.traffic["ref_block_rows"])


def check(ctx: common.Ctx, prog: dict) -> dict:
    """The comparison with the reference, and (calibration only) each
    lower precision's readings as the control."""
    base = reference(ctx, "fp32")
    numbers = compare.training(prog, base)
    correct, shown = compare.judge(numbers, ctx.traffic["limits"])
    out = {"correct": correct, "compared": shown, "numbers": numbers}
    for p in ctx.precisions:
        if p != "fp32":
            out[f"control_{p}"] = compare.training(reference(ctx, p), base)
    return out
