"""Train a Vision Transformer through the port's data-parallel harness —
the port of ``examples/train_vit.py``.

    # CIFAR-geometry ViT-S on the card, synthetic data:
    python -m tpudp_torch.train_vit --steps 30
    # ViT-B at ImageNet geometry through the flash kernels (K1-K3):
    python -m tpudp_torch.train_vit --variant base --image-size 224 \\
        --patch-size 14 --num-classes 1000 --attn flash --batch-size 128
    # on the CPU, tiny:
    python -m tpudp_torch.train_vit --device cpu --steps 2 --batch-size 8 \\
        --train-size 16 --layers 2 --d-model 64 --log-every 1

The example's flags and rules: ``--variant`` picks the depth, heads and
width (tiny 6 x 3 x 192, small 12 x 6 x 384, base 12 x 12 x 768);
``--layers`` and ``--d-model`` override them, and a given ``--d-model``
sets the heads to ``max(1, d_model // 64)``.  The data is the example's
synthetic set (``--image-size`` square uint8 images and
``--num-classes`` labels drawn from ``np.random.default_rng(0)``)
through the port's loader, at CIFAR-10's mean and std at 32x32 and
ImageNet's at any other size.  The weights come from
``vit.random_params(--seed)`` (the JAX example draws them from its
PRNG).  The step is ``make_train_step`` with the ``--sync`` rung on a
one-rank mesh, as the example runs on one chip; the host loads and
copies batch i+1 while the card runs step i.  Each ``step i: loss ...
(... images/s)`` line is timed to a device synchronize.
``--save-checkpoint DIR`` checks that DIR is writable before any compute
and saves the final state to ``DIR/step_<steps>``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from tpudp_torch.data import Prefetcher, device_place
from tpudp_torch.data.loader import DataLoader
from tpudp_torch.mesh import initialize_distributed, make_mesh
from tpudp_torch.models import vit
from tpudp_torch.parallel.sync import EXAMPLE_SYNC_CHOICES
from tpudp_torch.train import init_state, make_optimizer, make_train_step
from tpudp_torch.train_resnet import (IMAGENET_MEAN, IMAGENET_STD,
                                      synthetic_set)
from tpudp_torch.utils.checkpoint import ensure_writable, save_checkpoint

#: ``--variant`` -> (layers, heads, d_model), the example's table.
GEOMETRY = {"tiny": (6, 3, 192), "small": (12, 6, 384),
            "base": (12, 12, 768)}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--variant", choices=sorted(GEOMETRY), default="small")
    p.add_argument("--layers", type=int, default=None,
                   help="override the variant's depth")
    p.add_argument("--d-model", type=int, default=None)
    p.add_argument("--image-size", type=int, default=32)
    p.add_argument("--patch-size", type=int, default=4)
    p.add_argument("--num-classes", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=256,
                   help="GLOBAL batch")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--train-size", type=int, default=2048,
                   help="synthetic train-set size")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--optimizer", choices=["adamw", "sgd"], default="adamw")
    p.add_argument("--sync", choices=EXAMPLE_SYNC_CHOICES,
                   default="allreduce")
    p.add_argument("--attn", choices=["dense", "flash"], default="dense")
    p.add_argument("--dtype", choices=["float32", "bfloat16"],
                   default="bfloat16")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--save-checkpoint", type=str, default=None,
                   metavar="DIR")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the step runs (default cuda: the card)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights")
    return p


def config_of(args, dtype: torch.dtype) -> vit.ViTConfig:
    """The model of the flags, by the example's rules."""
    layers, heads, d_model = GEOMETRY[args.variant]
    if args.d_model is not None:
        d_model, heads = args.d_model, max(1, args.d_model // 64)
    return vit.ViTConfig(
        image_size=args.image_size, patch_size=args.patch_size,
        num_classes=args.num_classes, num_layers=args.layers or layers,
        num_heads=heads, d_model=d_model, dtype=dtype, attn_impl=args.attn)


def main(argv=None) -> dict:
    """Parse flags, train, print the example's lines; returns the run's
    ``{"records": [{"step", "loss", "images_s", "seconds"}, ...],
    "model", "state", "step", "checkpoint"}`` for callers that measure
    it."""
    args = build_parser().parse_args(argv)
    if args.save_checkpoint:
        ensure_writable(args.save_checkpoint)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("error: no CUDA card is available; train_vit runs "
                         "on the card by default — pass --device cpu to run "
                         "on the CPU")
    device = torch.device(args.device)
    initialize_distributed(device)  # one rank, as the example's one chip
    mesh = make_mesh()
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    cfg = config_of(args, dtype)
    model = vit.build(cfg, args.seed, device)
    spec = make_optimizer(learning_rate=args.lr, optimizer=args.optimizer)
    state = init_state(model, spec, mesh)
    step = make_train_step(model, spec, mesh, args.sync, remat=args.remat)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[vit-{args.variant}] params={n_params / 1e6:.1f}M devices="
          f"{mesh.size} tokens={cfg.num_patches} attn={args.attn} "
          f"sync={args.sync} batch={args.batch_size} dtype={args.dtype} "
          f"device={device.type}")
    ds = synthetic_set(args.train_size, args.image_size, args.num_classes)
    # ImageNet normalization away from CIFAR geometry, as the example
    # does; the loader's CIFAR-10 defaults at 32x32.
    norm = {}
    if args.image_size != 32:
        norm = dict(mean=np.asarray(IMAGENET_MEAN, np.float32),
                    std=np.asarray(IMAGENET_STD, np.float32))
    base = DataLoader(ds, args.batch_size, train=True, seed=0, **norm)
    if len(base) == 0:
        raise SystemExit(
            f"error: --train-size {args.train_size} yields zero full batches "
            f"of --batch-size {args.batch_size} (drop_last training loader)")
    loader = Prefetcher(base, depth=2, place=device_place(device))
    records = []
    try:
        it = iter(loader)
        prev_cum, t0 = 0.0, time.perf_counter()
        for i in range(1, args.steps + 1):
            try:
                images, labels, _ = next(it)
            except StopIteration:  # the example's next epoch is numbered i
                loader.set_epoch(i)
                it = iter(loader)
                images, labels, _ = next(it)
            state, _ = step(state, images, labels)
            if i % args.log_every == 0:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)  # the timing edge
                cum = float(state.loss_sum)
                dt = time.perf_counter() - t0
                loss = (cum - prev_cum) / args.log_every
                ips = args.log_every * args.batch_size / dt
                print(f"step {i}: loss {loss:.4f} ({ips:,.1f} images/s)",
                      flush=True)
                records.append({"step": i, "loss": loss, "images_s": ips,
                                "seconds": dt})
                prev_cum, t0 = cum, time.perf_counter()
    finally:
        loader.close()
    ckpt = None
    if args.save_checkpoint:
        ckpt = save_checkpoint(
            os.path.join(args.save_checkpoint, f"step_{args.steps}"), state)
        print(f"[vit] saved checkpoint {ckpt}")
    sys.stdout.flush()
    return {"records": records, "model": model, "state": state,
            "step": step, "checkpoint": ckpt}


if __name__ == "__main__":
    main()
