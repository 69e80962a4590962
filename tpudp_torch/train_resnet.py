"""Train ResNet-50/101/152 at ImageNet geometry through the port's
data-parallel harness — the port of ``examples/train_resnet.py``.

    python -m tpudp_torch.train_resnet --steps 30            # the card
    python -m tpudp_torch.train_resnet --device cpu --steps 2 \\
        --batch-size 16 --train-size 32 --image-size 32 --log-every 1

ImageNet is not downloaded: by default the run trains on the example's
ImageNet-shaped synthetic set (``--image-size`` square uint8 images,
``--num-classes`` labels, drawn from ``np.random.default_rng(0)`` as the
example draws them), through the same loader as CIFAR-10 (the native
crop-flip-normalize when it builds, at ImageNet's mean and std).
``--imagenet-root`` reads a local ``{train,val}/<class>/*.npy`` tree
instead.  The weights come from ``resnet.random_params(--seed)`` (the
JAX example draws them from its PRNG).  The step is ``make_train_step``
with the ``--sync`` rung on a one-rank mesh, as the example runs on one
chip; the host loads and copies batch i+1 (pinned memory, non-blocking)
while the card runs step i.  Each ``step i: loss ... (... images/s)``
line is timed to a device synchronize.  ``--save-checkpoint DIR`` checks
that DIR is writable before any compute and saves the final state to
``DIR/step_<steps>`` (``tpudp_torch.utils.checkpoint``).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from tpudp_torch.data import Prefetcher, device_place
from tpudp_torch.data.cifar10 import Dataset
from tpudp_torch.data.loader import DataLoader
from tpudp_torch.mesh import initialize_distributed, make_mesh
from tpudp_torch.models import resnet
from tpudp_torch.parallel.sync import EXAMPLE_SYNC_CHOICES
from tpudp_torch.train import init_state, make_optimizer, make_train_step
from tpudp_torch.utils.checkpoint import ensure_writable, save_checkpoint

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def load_npy_tree(root: str, split: str, image_size: int) -> Dataset:
    """A ``root/{split}/<class>/*.npy`` tree as one uint8 Dataset: each
    ``.npy`` holds one HWC uint8 image or an ``(N, H, W, 3)`` stack of
    them, already ``image_size`` square; labels follow the sorted class
    directories.  Local files only."""
    split_dir = os.path.join(root, split)
    classes = sorted(d for d in os.listdir(split_dir)
                     if os.path.isdir(os.path.join(split_dir, d)))
    if not classes:
        raise SystemExit(f"no class directories under {split_dir}")
    images, labels = [], []
    for label, cls in enumerate(classes):
        cls_dir = os.path.join(split_dir, cls)
        for fname in sorted(os.listdir(cls_dir)):
            if not fname.endswith(".npy"):
                continue
            arr = np.load(os.path.join(cls_dir, fname))
            if arr.ndim == 3:
                arr = arr[None]
            if arr.shape[1:] != (image_size, image_size, 3):
                raise SystemExit(
                    f"{cls_dir}/{fname}: expected ({image_size}, "
                    f"{image_size}, 3) images, got {arr.shape[1:]}")
            images.append(arr.astype(np.uint8))
            labels.append(np.full(arr.shape[0], label, np.int32))
    if not images:
        raise SystemExit(f"no .npy files under {split_dir}")
    return Dataset(np.concatenate(images), np.concatenate(labels))


def synthetic_set(train_size: int, image_size: int,
                  num_classes: int) -> Dataset:
    """The example's ImageNet-shaped synthetic set, byte for byte."""
    rng = np.random.default_rng(0)
    return Dataset(
        rng.integers(0, 256, size=(train_size, image_size, image_size, 3)
                     ).astype(np.uint8),
        rng.integers(0, num_classes, size=train_size).astype(np.int32))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--depth", type=int, choices=sorted(resnet.STAGES),
                   default=50)
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--batch-size", type=int, default=256,
                   help="GLOBAL batch")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--train-size", type=int, default=2048,
                   help="synthetic train-set size")
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--sync", choices=EXAMPLE_SYNC_CHOICES,
                   default="allreduce")
    p.add_argument("--dtype", choices=["float32", "bfloat16"],
                   default="bfloat16")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--save-checkpoint", type=str, default=None,
                   metavar="DIR")
    p.add_argument("--imagenet-root", type=str, default=None)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the step runs (default cuda: the card)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights")
    return p


def main(argv=None) -> dict:
    """Parse flags, train, print the example's lines; returns the run's
    ``{"records": [{"step", "loss", "images_s", "seconds"}, ...],
    "model", "state", "step", "checkpoint"}`` for callers that measure
    it."""
    args = build_parser().parse_args(argv)
    if args.save_checkpoint:
        ensure_writable(args.save_checkpoint)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("error: no CUDA card is available; train_resnet "
                         "runs on the card by default — pass --device cpu "
                         "to run on the CPU")
    device = torch.device(args.device)
    initialize_distributed(device)  # one rank, as the example's one chip
    mesh = make_mesh()
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    model = resnet.build(args.depth, args.seed, device, args.num_classes,
                         dtype)
    spec = make_optimizer(learning_rate=args.lr)
    state = init_state(model, spec, mesh)
    step = make_train_step(model, spec, mesh, args.sync)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[resnet{args.depth}] params={n_params / 1e6:.1f}M devices="
          f"{mesh.size} sync={args.sync} image={args.image_size} "
          f"batch={args.batch_size} dtype={args.dtype} "
          f"device={device.type}")
    if args.imagenet_root:
        ds = load_npy_tree(args.imagenet_root, "train", args.image_size)
        if int(ds.labels.max()) >= args.num_classes:
            raise SystemExit(
                f"--imagenet-root has {int(ds.labels.max()) + 1} class "
                f"directories but --num-classes is {args.num_classes}")
        print(f"[resnet{args.depth}] loaded {len(ds.images)} images / "
              f"{int(ds.labels.max()) + 1} classes from "
              f"{args.imagenet_root}")
    else:
        ds = synthetic_set(args.train_size, args.image_size,
                           args.num_classes)
    base = DataLoader(ds, args.batch_size, train=True, seed=0,
                      mean=np.asarray(IMAGENET_MEAN, np.float32),
                      std=np.asarray(IMAGENET_STD, np.float32))
    if len(base) == 0:
        raise SystemExit(
            f"error: --train-size {len(ds.images)} yields zero full batches "
            f"of --batch-size {args.batch_size} (drop_last training loader)")
    print(f"[resnet{args.depth}] data={base.banner()}")
    # The next batch is loaded and copied (pinned, non-blocking) on the
    # Prefetcher's thread while the card runs the step.
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
        print(f"[resnet{args.depth}] saved checkpoint {ckpt}")
    sys.stdout.flush()
    return {"records": records, "model": model, "state": state,
            "step": step, "checkpoint": ckpt}


if __name__ == "__main__":
    main()
