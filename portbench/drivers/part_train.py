"""Part trainer cells: ``Trainer.train_epoch`` as ``cli.run_part`` builds
it, over the port's ``DataLoader`` and ``Prefetcher``.

Set-up makes a CIFAR-10-shaped train set from the seed, builds the
loader, the model (the benchmark's weights) and the Trainer with the
Part's flags, and runs the first epoch's first steps through
``train_epoch``, reading them for the check between the steps.  The
window chains epochs until its time is up, drawing every batch through
a wrapper that times the wait for it; the window's edges are fenced.
Once it has closed and the program's state is freed, the plain
reference recomputes the first batches from the raw images and trains
the same steps, and the two are compared.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench.harness import common, compare, faults, weights
from portbench.harness.trace import Profiled
from portbench.reference import augment
from portbench.reference import vgg as ref
from portbench.reference.precision import strict_float32
from portbench.reference.sgd import leaf_norms

DATA_CHUNK = 5000


def make_dataset(ctx: common.Ctx, device) -> tuple[np.ndarray, np.ndarray]:
    """``(uint8 NHWC images, int32 labels)``: a template a class plus
    normal(0, 48) noise, clipped, drawn on the device from the seed."""
    cfg = ctx.config
    n, s, c = cfg["train_size"], cfg["image_size"], cfg["channels"]
    g = weights.generator(ctx.seed, weights.STREAM_DATA, device)
    templates = torch.randint(0, 256, (cfg["num_classes"], s, s, c),
                              generator=g, device=device).float()
    labels = torch.randint(0, cfg["num_classes"], (n,), generator=g,
                           device=device)
    images = torch.empty((n, s, s, c), dtype=torch.uint8)
    for a in range(0, n, DATA_CHUNK):
        lab = labels[a:a + DATA_CHUNK]
        noise = torch.randn((len(lab), s, s, c), generator=g, device=device)
        images[a:a + len(lab)] = (templates[lab] + 48.0 * noise).clamp(
            0, 255).to(torch.uint8).cpu()
    return images.numpy(), labels.cpu().numpy().astype(np.int32)


class Feed:
    """The loader as the Trainer sees it: each batch drawn through
    :attr:`gate` (False ends the epoch), the wait for it timed, the first
    :attr:`keep` batches' images kept for the check."""

    def __init__(self, inner, fault: str | None, keep: int):
        self.inner, self.fault, self.keep = inner, fault, keep
        self.gate = lambda: True
        self.wait_s, self.drawn, self.kept = 0.0, 0, []

    def set_epoch(self, epoch: int) -> None:
        self.inner.set_epoch(epoch)

    def set_place(self, fn) -> None:
        self.inner.set_place(fn)

    def __len__(self) -> int:
        return len(self.inner)

    def __iter__(self):
        it = iter(self.inner)
        try:
            while self.gate():
                t0 = time.perf_counter()
                batch = next(it, None)
                self.wait_s += time.perf_counter() - t0
                if batch is None:
                    return
                batch = faults.alter_batch(self.fault, batch)
                if len(self.kept) < self.keep:
                    self.kept.append(batch[0])
                self.drawn += 1
                yield batch
        finally:
            it.close()


def build(ctx: common.Ctx):
    """``(trainer, loader)`` as ``cli._run_rank`` builds them for the
    Part, on the benchmark's data and weights."""
    from tpudp_torch import cli
    from tpudp_torch.data.cifar10 import Dataset
    from tpudp_torch.data.loader import DataLoader
    from tpudp_torch.data.prefetch import Prefetcher
    from tpudp_torch.data.sampler import ShardedSampler
    from tpudp_torch.models import vgg
    from tpudp_torch.models.norm import DATA_AXIS
    from tpudp_torch.trainer import Trainer
    from tpudp_torch.utils.compile_cache import enable_persistent_cache
    from tpudp_torch.utils.device_lock import acquire_for_process

    ctx.mark("import_program")
    t, prog = ctx.traffic, ctx.config["program"]
    args = cli.build_parser(f"Part {t['part']}").parse_args(
        ["--device", ctx.device.type, "--seed", str(ctx.seed),
         "--batch-size", str(t["batch"]), "--dtype", prog["dtype"],
         "--model", ctx.config["variant"].lower()])
    device = ctx.device
    enable_persistent_cache()
    acquire_for_process(device)
    ctx.mark("cache_and_lock")
    common.init_device(device)
    ctx.mark("device_context")
    images, labels = make_dataset(ctx, device)
    ctx.mark("data")
    loader = DataLoader(
        Dataset(images, labels), args.batch_size,
        sampler=ShardedSampler(len(images), 1, 0, shuffle=True,
                               seed=args.seed),
        train=True, seed=args.seed, backend=args.data_backend)
    if args.prefetch > 0:
        loader = Prefetcher(loader, depth=args.prefetch)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    with torch.device("meta"):
        model = vgg.VGG(vgg.CONFIGS[args.model.upper()],
                        ctx.config["num_classes"], dtype,
                        bn_axis=DATA_AXIS if args.sync_bn else None)
    model = model.to_empty(device=device)
    weights.load_into(model, weights.make(ref.param_specs(ctx.config),
                                          ctx.seed, device))
    model = model.to(device, memory_format=torch.channels_last)
    trainer = Trainer(model, None, t["sync"], timing_mode=args.timing_mode,
                      spmd_mode=args.spmd_mode or "shard_map",
                      grad_accum=args.grad_accum, remat=args.remat,
                      metrics_jsonl=None, log_fn=lambda line: None,
                      watchdog=None, flight_dir=args.flight_dir,
                      verify_replicas=args.verify_replicas)
    trainer.train_step = faults.wrap_step(ctx.fault, trainer.train_step)
    common.fence(device)
    ctx.mark("model_and_loader")
    return trainer, loader


def first_grad(trainer, ctx) -> dict:
    """Each parameter's first gradient as the optimizer got it: its
    momentum trace after one step less the weight decay's share."""
    opt, wd = trainer.state.optimizer, trainer.optimizer.weight_decay
    p0 = weights.make(ref.param_specs(ctx.config), ctx.seed, ctx.device)
    return leaf_norms({
        n: opt.state.get(p, {}).get("momentum_buffer", torch.zeros_like(p))
        - wd * p0[n] for n, p in trainer.state.model.named_parameters()})


def change(trainer, ctx) -> dict:
    p0 = weights.make(ref.param_specs(ctx.config), ctx.seed, ctx.device)
    now = trainer.state.model.state_dict()
    return leaf_norms({n: now[n] - p0[n] for n in p0})


def run(ctx: common.Ctx) -> dict:
    t = ctx.traffic
    checked = t["check_steps"]
    trainer, loader = build(ctx)
    feed = Feed(loader, ctx.fault, keep=checked)
    sums, prog, logits = [], {}, []
    # the first step's logits, as its forward produced them
    hook = trainer.state.model.register_forward_hook(
        lambda module, args, out: logits.append(out.detach().clone()))

    def setup_gate() -> bool:
        k = feed.drawn  # steps queued so far
        if 1 <= k <= checked and len(sums) < k:
            sums.append(trainer.state.loss_sum.detach().clone())
            if k == 1:
                hook.remove()
                prog["grad"] = first_grad(trainer, ctx)
            if k == checked:
                prog["change"] = change(trainer, ctx)
        return k < checked + t["warmup_steps"]

    feed.gate = setup_gate
    trainer.train_epoch(feed, 0)
    hook.remove()  # where a fault took every step out
    cum = torch.stack(sums).tolist()
    prog["losses"] = [cum[0]] + [b - a for a, b in zip(cum, cum[1:])]
    prog["logits"] = logits[0].cpu() if logits else None
    rec = {"items_per_step": t["batch"], "profiled_steps": 0, "trace": None}
    fence = lambda: common.fence(ctx.device)  # noqa: E731
    if not ctx.check_only:
        fence()
        stop = common.Stopper(ctx)
        phase = {"now": "window"}
        prof = Profiled(ctx.device) if ctx.trace else None

        def window_gate() -> bool:
            if phase["now"] == "window":
                if not stop.over():
                    return True
                fence()
                rec["window_s"] = time.perf_counter() - stop.t0
                rec["steps"], rec["loader_wait_s"] = feed.drawn, feed.wait_s
                if prof is None:
                    phase["now"] = "done"
                    return False
                phase["now"], phase["from"] = "profile", feed.drawn
                prof.start()
                return True
            if phase["now"] == "profile":
                if feed.drawn - phase["from"] < t["profile_steps"]:
                    return True
                prof.stop(fence)
                rec["profiled_steps"] = feed.drawn - phase["from"]
                phase["now"] = "done"
            return False

        feed.gate, feed.wait_s, feed.drawn = window_gate, 0.0, 0
        ctx.mark("first_steps")
        stop.start()
        rec["setup_s"] = stop.t0_wall - ctx.t0_wall
        rec["setup_parts"] = ctx.setup_parts()
        epoch = 1
        while phase["now"] != "done":
            trainer.train_epoch(feed, epoch)
            epoch += 1
        if prof is not None:
            rec["trace"] = prof.summary({})
        rec["finite"] = math.isfinite(float(trainer.state.loss_sum))
    rec["memory_peak_bytes"] = common.memory_peak(ctx.device)
    kept = [b.cpu().numpy() for b in feed.kept]
    if hasattr(loader, "close"):
        loader.close()
    del trainer, loader, feed, sums
    common.release(ctx.device)
    rec.update(check(ctx, prog, kept))
    return rec


def reference(ctx: common.Ctx, precision: str, batches: list) -> dict:
    with strict_float32():
        w0 = weights.make(ref.param_specs(ctx.config), ctx.seed, ctx.device)
        dev = [(torch.from_numpy(x).to(ctx.device),
                torch.from_numpy(y).to(ctx.device)) for x, y in batches]
        return ref.train(w0, dev, ctx.config, precision)


def check(ctx: common.Ctx, prog: dict, kept: list) -> dict:
    """The reference's batches against the ones the data layer fed, its
    steps against the program's; (calibration only) the controls."""
    t = ctx.traffic
    images, labels = make_dataset(ctx, ctx.device)
    batches = augment.batches(images, labels, ctx.seed, 0, t["batch"],
                              t["check_steps"], ctx.config["augment"])
    base = reference(ctx, "fp32", batches)
    numbers = compare.training(prog, base)
    numbers["data"] = max(float(np.abs(k - x).max())
                          for k, (x, _) in zip(kept, batches, strict=True))
    correct, shown = compare.judge(numbers, t["limits"])
    out = {"correct": correct, "compared": shown, "numbers": numbers}
    for p in ctx.precisions:
        if p != "fp32":
            ctl = compare.training(reference(ctx, p, batches), base)
            out[f"control_{p}"] = {**ctl, "data": 0.0}
    return out
