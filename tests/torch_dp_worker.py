"""One rank of a data-parallel world of the port, for the CPU tests:

    python tests/torch_dp_worker.py SPEC RANK

``SPEC`` is a JSON file: ``{"world": N, "init": "file://...", "out":
DIR, "jobs": [...]}``.  The rank joins a gloo process group through the
file rendezvous, runs every job and saves ``{job name: result}`` to
``DIR/rank{RANK}.pt``.  Imports torch, numpy and the port only; the
inputs are drawn from numpy seeds by the functions below, which the
tests also call to feed the JAX package the same numbers.
"""

from __future__ import annotations

import json
import os
import sys
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# The narrow VGG of the tests: 32x32 inputs through five pools to 1x1x16.
CFG = (8, "M", 16, "M", "M", "M", "M")
ROWS = 8      # per rank
STEPS = 3
SGD = dict(learning_rate=0.01, momentum=0.9, weight_decay=1e-4)
# The 11 rungs of the sync ladder, and int8 error feedback (sync 'none').
RUNGS = ("none", "coordinator", "allreduce", "allreduce_bf16",
         "allreduce_int8", "ring", "ring_uni", "ring_bidir", "allreduce_hd",
         "allreduce_a2a", "auto")
CASES = RUNGS + ("int8_ef",)
EF_STEPS = 12
GPT2_CFG = dict(vocab_size=61, max_seq_len=32, num_layers=2, num_heads=2,
                d_model=32)
# The tiny ResNet of the JAX package's tests: two one-block stages of
# width 16 on 32x32 inputs, 10 classes.
RESNET_STAGES, RESNET_WIDTH = (1, 1), 16


def vgg_init(seed: int = 11):
    """The flax-layout (params, batch_stats) both frameworks start from."""
    from tpudp_torch.models import vgg

    return vgg.random_params(CFG, seed)


def resnet_init(seed: int = 18):
    """The tiny ResNet's flax-layout (params, batch_stats), each block's
    last BatchNorm scale drawn away from its zero init so that every
    BatchNorm's statistics reach the loss from the first step."""
    from tpudp_torch.models import resnet

    params, stats = resnet.random_params(RESNET_STAGES, seed, 10,
                                         RESNET_WIDTH)
    rng = np.random.default_rng(seed + 1)
    for name, tree in params.items():
        if name.startswith("BottleneckBlock_"):
            scale = tree["BatchNorm_2"]["scale"]
            tree["BatchNorm_2"]["scale"] = rng.uniform(
                0.5, 1.5, scale.shape).astype(np.float32)
    return params, stats


def bn_model(kind: str, bn_axis=None):
    """The port's narrow VGG (``'vgg'``) or tiny ResNet (``'resnet'``)
    with its test weights loaded."""
    from tpudp_torch.models import resnet, vgg

    if kind == "vgg":
        model = vgg.VGG(CFG, bn_axis=bn_axis)
        model.load_state_dict(vgg.params_from_jax(*vgg_init()))
    else:
        model = resnet.ResNet(RESNET_STAGES, 10, RESNET_WIDTH,
                              bn_axis=bn_axis)
        model.load_state_dict(resnet.params_from_jax(*resnet_init()))
    return model


def vgg_batches(world: int, seed: int = 12):
    """``STEPS`` global batches ``(images (world*ROWS, 32, 32, 3), labels)``;
    rank r takes rows ``[r*ROWS, (r+1)*ROWS)``, as device r of a JAX mesh
    does."""
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(world * ROWS, 32, 32, 3)).astype(np.float32),
             rng.integers(0, 10, size=world * ROWS).astype(np.int32))
            for _ in range(STEPS)]


def eval_batch(world: int, seed: int = 13):
    """One global eval batch with a weight mask (zeros mark padding)."""
    rng = np.random.default_rng(seed)
    n = world * ROWS
    weights = (rng.random(n) < 0.75).astype(np.float32)
    return (rng.normal(size=(n, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, size=n).astype(np.int32), weights)


def eval_stats(seed: int = 14):
    """Non-trivial running statistics for the eval check."""
    params, stats = vgg_init()
    rng = np.random.default_rng(seed)
    stats = {k: {"mean": rng.normal(size=v["mean"].shape).astype(np.float32)
                 * 0.1,
                 "var": rng.uniform(0.5, 2.0, size=v["var"].shape)
                 .astype(np.float32)} for k, v in stats.items()}
    return params, stats


def grad_tree(world: int, seed: int = 15):
    """Per-rank gradients of awkward (non-divisible) sizes:
    ``[(world, 7, 13), (world, 5), (world, 3, 3, 2)]`` float32."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(world,) + shape).astype(np.float32)
            for shape in ((7, 13), (5,), (3, 3, 2))]


def gpt2_tree(seed: int = 16):
    from tpudp_torch.models import gpt2

    return gpt2.random_params(gpt2.GPT2Config(**GPT2_CFG), seed)


def gpt2_batches(world: int, seed: int = 17, steps: int = 2):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, GPT2_CFG["vocab_size"],
                       size=(steps, world * 2, GPT2_CFG["max_seq_len"] + 1))
    return [(t[:, :-1], t[:, 1:]) for t in tok]


def shard(a, rank: int, world: int):
    """Rank ``rank``'s contiguous rows of a global batch."""
    n = len(a) // world
    return a[rank * n:(rank + 1) * n]


def job_sync(rank, world):
    """Every rung on this rank's gradients: ``{rung: [outputs]}``, plus the
    int8 ring's sum of identical values at the clip bound and the
    int8 quantizer's outputs."""
    import torch

    from tpudp_torch.parallel import ring, sync

    grads = [torch.as_tensor(g[rank]) for g in grad_tree(world)]
    out = {}
    for name in RUNGS:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = sync.get_sync(name)([g.clone() for g in grads], None)
        out[name] = [g.clone() for g in got]
        out[name + ":warnings"] = [str(w.message) for w in caught]
    qmax = 127 // world
    out["int8_clip_sum"] = ring.ring_all_reduce(
        torch.full((37,), qmax, dtype=torch.int8), None)
    flat = torch.cat([g.reshape(-1) for g in grads])
    out["int8_quantize"] = ring.int8_headroom_quantize(flat, None)
    out["ring_int"] = ring.ring_all_reduce(
        torch.arange(23, dtype=torch.int64) * (rank + 1), None)
    # Error feedback on constant gradients: the updates of EF_STEPS calls
    # summed, and the last residuals.
    from tpudp_torch.parallel.compress import Int8ErrorFeedback

    ef = Int8ErrorFeedback(grads, None)
    acc = [torch.zeros_like(g) for g in grads]
    for _ in range(EF_STEPS):
        for a, u in zip(acc, ef(grads)):
            a += u
    out["ef_sum"], out["ef_error"] = acc, ef.error
    return out


def job_steps(rank, world):
    """Each case: ``STEPS`` train steps of the narrow VGG on this rank's
    rows: ``{case: {"losses", "loss_sum", "units", "state"}}``, where
    ``units`` are the int8 rungs' grid ticks, one a step."""
    import torch

    from tpudp_torch import train
    from tpudp_torch.mesh import make_mesh
    from tpudp_torch.models import vgg

    from tpudp_torch.parallel import compress as compress_mod
    from tpudp_torch.parallel import sync as sync_mod

    mesh = make_mesh()
    params, stats = vgg_init()
    batches = vgg_batches(world)
    # The int8 rungs' grid ticks, one a step, read where they quantize.
    units = []

    def recording(quantize):
        def wrapped(flat, group):
            q, unit = quantize(flat, group)
            units.append(float(unit))
            return q, unit
        return wrapped

    sync_mod.int8_headroom_quantize = recording(
        sync_mod.int8_headroom_quantize)
    compress_mod.int8_headroom_quantize = recording(
        compress_mod.int8_headroom_quantize)
    out = {}
    for case in CASES:
        units.clear()
        model = vgg.VGG(CFG)
        model.load_state_dict(vgg.params_from_jax(params, stats))
        compress = "int8_ef" if case == "int8_ef" else None
        sync = "none" if compress else case
        spec = train.make_optimizer(**SGD, compress=compress)
        state = train.init_state(model, spec, mesh)
        step = train.make_train_step(model, spec, mesh, sync)
        losses = []
        for x, y in batches:
            x, y = (torch.as_tensor(shard(a, rank, world)) for a in (x, y))
            state, loss = step(state, x, y)
            losses.append(float(loss))
        out[case] = {"losses": losses, "units": list(units),
                     "loss_sum": float(state.loss_sum),
                     "state": {k: v.clone()
                               for k, v in model.state_dict().items()}}
    return out


def job_eval(rank, world):
    """Eval sums of the narrow VGG over this rank's shard, all-reduced."""
    import torch

    from tpudp_torch import train
    from tpudp_torch.mesh import make_mesh
    from tpudp_torch.models import vgg

    params, stats = eval_stats()
    model = vgg.VGG(CFG)
    model.load_state_dict(vgg.params_from_jax(params, stats))
    images, labels, weights = (torch.as_tensor(shard(a, rank, world))
                               for a in eval_batch(world))
    step = train.make_eval_step(model, make_mesh())
    return [float(v) for v in step(None, images, labels, weights)]


def job_gpt2(rank, world):
    """Two GPT-2 tiny steps with the all-reduce rung: losses and params."""
    import torch

    from tpudp_torch import train
    from tpudp_torch.mesh import make_mesh
    from tpudp_torch.models import gpt2

    model = gpt2.GPT2(gpt2.GPT2Config(**GPT2_CFG))
    model.load_state_dict(gpt2.params_from_jax(gpt2_tree()))
    spec = train.make_optimizer(learning_rate=0.01)
    mesh = make_mesh()
    state = train.init_state(model, spec, mesh)
    step = train.make_train_step(model, spec, mesh, "allreduce")
    losses = []
    for x, y in gpt2_batches(world):
        x, y = (torch.as_tensor(shard(a, rank, world)) for a in (x, y))
        state, loss = step(state, x, y)
        losses.append(float(loss))
    return {"losses": losses,
            "state": {k: v.clone() for k, v in model.state_dict().items()}}


def job_sync_bn(rank, world):
    """Cross-rank BatchNorm: ``STEPS`` steps of the narrow VGG and the
    tiny ResNet with ``bn_axis='data'`` (the all-reduce rung), the same
    models with each rank's own statistics (first step only), and the
    VGG under ``spmd_mode='gspmd'``: ``{case: {"losses", "state"}}``."""
    import torch

    from tpudp_torch import train
    from tpudp_torch.mesh import make_mesh

    mesh = make_mesh()
    out = {}
    cases = [(kind, mode) for kind in ("vgg", "resnet")
             for mode in ("sync_bn", "local")] + [("vgg", "gspmd")]
    for kind, mode in cases:
        model = bn_model(kind, "data" if mode == "sync_bn" else None)
        spec = train.make_optimizer(**SGD)
        state = train.init_state(model, spec, mesh)
        step = train.make_train_step(
            model, spec, mesh, "auto" if mode == "gspmd" else "allreduce",
            spmd_mode="gspmd" if mode == "gspmd" else "shard_map")
        losses = []
        for x, y in vgg_batches(world)[:1 if mode == "local" else STEPS]:
            x, y = (torch.as_tensor(shard(a, rank, world)) for a in (x, y))
            state, loss = step(state, x, y)
            losses.append(float(loss))
        out[f"{kind}-{mode}"] = {
            "losses": losses,
            "state": {k: v.clone() for k, v in model.state_dict().items()}}
    return out


JOBS = {"sync": job_sync, "steps": job_steps, "eval": job_eval,
        "gpt2": job_gpt2, "sync_bn": job_sync_bn}


def main(spec_path: str, rank: int) -> None:
    import torch
    import torch.distributed as dist

    from tpudp_torch.mesh import initialize_distributed

    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    world = spec["world"]
    initialize_distributed("cpu", num_processes=world, process_id=rank,
                           init_method=spec["init"])
    try:
        results = {job: JOBS[job](rank, world) for job in spec["jobs"]}
        torch.save(results, os.path.join(spec["out"], f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_world(tmp_dir, world: int, jobs, timeout: float = 240.0) -> list:
    """Run ``world`` ranks of this script on ``jobs`` and return each
    rank's results; fails (after killing the ranks) on a timeout or a
    rank's nonzero exit."""
    import subprocess

    import torch

    os.makedirs(tmp_dir, exist_ok=True)
    spec_path = os.path.join(tmp_dir, "spec.json")
    with open(spec_path, "w") as f:
        json.dump({"world": world, "jobs": list(jobs), "out": str(tmp_dir),
                   "init": f"file://{os.path.join(tmp_dir, 'store')}"}, f)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               spec_path, str(r)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        raise AssertionError(f"a rank of the world of {world} did not end "
                             f"within {timeout} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"
    return [torch.load(os.path.join(tmp_dir, f"rank{r}.pt"))
            for r in range(world)]


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
