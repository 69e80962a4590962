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


# -- checkpoints and the supervisor (tests/test_torch_checkpoint.py and
#    tests/test_torch_resilience.py) ----------------------------------------

CKPT_TRAIN, CKPT_TEST, CKPT_EPOCHS = 64, 16, 2  # 4 batches a rank and epoch


def ckpt_loaders(rank: int, world: int, root: str, depth: int = 0):
    """This rank's train and test loaders over the synthetic set: global
    batch 8 x ``world``, shuffled by (seed 3, epoch)."""
    from tpudp_torch.data import (DataLoader, Prefetcher, ShardedSampler,
                                  load_cifar10)

    train_set, test_set, _ = load_cifar10(
        os.path.join(root, "no-data"), synthetic_train_size=CKPT_TRAIN,
        synthetic_test_size=CKPT_TEST)
    train = DataLoader(train_set, 8,
                       sampler=ShardedSampler(len(train_set.images), world,
                                              rank, shuffle=True, seed=3),
                       train=True, seed=3, backend="numpy")
    test = DataLoader(test_set, 8,
                      sampler=ShardedSampler(len(test_set.images), world,
                                             rank, shuffle=False),
                      train=False, backend="numpy")
    if depth:
        train = Prefetcher(train, depth=depth)
    return train, test


def ckpt_trainer(mesh=None, compress=None, **kw):
    """The narrow VGG's Trainer with its test weights (silent unless
    ``log_fn`` is given)."""
    from tpudp_torch.trainer import Trainer

    sync = "none" if compress or mesh is None else "allreduce"
    kw.setdefault("log_fn", lambda line: None)
    return Trainer(bn_model("vgg"), mesh, sync, learning_rate=0.01,
                   log_every=2, compress=compress, **kw)


def state_of(trainer) -> dict:
    """Parameters, buffers and the optimizer's buffers, by name."""
    opt = trainer.state.optimizer
    out = {k: v.detach().clone()
           for k, v in trainer.model.state_dict().items()}
    for name, p in trainer.model.named_parameters():
        for key, value in opt.state.get(p, {}).items():
            if hasattr(value, "clone"):
                out[f"opt:{name}:{key}"] = value.detach().clone()
    if trainer.state.compressor is not None:
        out["residuals"] = [e.clone() for e in trainer.state.compressor.error]
    out["step"] = trainer.state.step
    out["loss_sum"] = float(trainer.state.loss_sum)
    return out


def _dump_then_fail(trainer, root, per_epoch, at_call):
    """A step hook that, right before device call ``at_call``, writes the
    emergency dump of the live state and then raises — an interrupted
    run that left a mid-epoch dump behind."""
    from tpudp_torch.resilience import make_emergency_dump
    from tpudp_torch.training_faults import InjectedTrainingFault

    dump = make_emergency_dump(root, lambda: trainer.state, per_epoch,
                               log=lambda line: None)

    def hook(kind, index):
        if kind == "train" and index == at_call:
            dump()
            raise InjectedTrainingFault(f"interrupted at call {index}")

    return hook


def job_ckpt(rank, world):
    """Resume at world ``world``: 2 epochs uninterrupted, against 1 epoch
    + a checkpoint + a fresh Trainer resuming epoch 2, against a run
    interrupted mid-epoch 1 by an emergency dump and resumed by
    ``auto_resume`` — each plain and with int8 error feedback; then the
    rank vote of ``restore_latest_verified`` under a stale listing."""
    from tpudp_torch.mesh import make_mesh
    from tpudp_torch.resilience import auto_resume
    from tpudp_torch.training_faults import InjectedTrainingFault
    from tpudp_torch.utils import checkpoint as ck

    mesh = make_mesh()
    out = {}
    for compress in (None, "int8_ef"):
        tag = compress or "plain"
        root = os.path.join(os.environ["TPUDP_TEST_OUT"], f"ck-{tag}")
        train, test = ckpt_loaders(rank, world, root)
        a = ckpt_trainer(mesh, compress)
        a.fit(train, test, CKPT_EPOCHS)
        out[f"{tag}:A"] = state_of(a)

        b = ckpt_trainer(mesh, compress)
        b.fit(train, test, 1, epoch_end_fn=lambda e: ck.save_checkpoint(
            os.path.join(root, f"step_{e + 1}"), b.state))
        b2 = ckpt_trainer(mesh, compress)
        _, used, _ = ck.restore_latest_verified(root, b2.state,
                                                log=lambda line: None)
        out[f"{tag}:restored"] = state_of(b2)
        out[f"{tag}:saved"] = state_of(b)
        b2.fit(train, test, CKPT_EPOCHS, start_epoch=int(used[-1]))
        out[f"{tag}:B"] = state_of(b2)

        c = ckpt_trainer(mesh, compress)
        c.step_fault_hook = _dump_then_fail(c, root, len(train), 7)
        try:
            c.fit(train, test, CKPT_EPOCHS)
        except InjectedTrainingFault:
            pass
        c2 = ckpt_trainer(mesh, compress)
        start, skip = auto_resume(c2, root, len(train),
                                  log=lambda line: None)
        out[f"{tag}:resume_at"] = (start, skip)
        c2.fit(train, test, CKPT_EPOCHS, start_epoch=start,
               skip_batches_first_epoch=skip)
        out[f"{tag}:C"] = state_of(c2)

    # The vote: rank 1's listing misses the newest step; every rank must
    # restore the newest step both see.
    root = os.path.join(os.environ["TPUDP_TEST_OUT"], "ck-vote")
    t = ckpt_trainer(mesh)
    for n in (1, 2):
        t.state.step = n
        ck.save_checkpoint(os.path.join(root, f"step_{n}"), t.state)
    real = ck.step_dirs_newest_first
    if rank == 1:
        ck.step_dirs_newest_first = lambda r: real(r)[1:]
    _, used, skipped = ck.restore_latest_verified(root, t.state,
                                                  log=lambda line: None)
    out["vote:used"] = os.path.basename(used)
    out["vote:step"] = t.state.step
    # Rank 1 sees no checkpoint at all: every rank fails, none hangs.
    if rank == 1:
        ck.step_dirs_newest_first = lambda r: []
        ck.latest_step_dir = lambda r: None
    entered = ck.coordinated_any(ck.latest_step_dir(root) is not None)
    try:
        ck.restore_latest_verified(root, t.state, log=lambda line: None)
        out["vote:empty"] = "restored"
    except RuntimeError as e:
        out["vote:empty"] = str(e)
    out["vote:entered"] = entered
    ck.step_dirs_newest_first = real
    out["vote:writers"] = sorted(os.listdir(root))
    return out


def job_resilience(rank, world):
    """The supervisor at world ``world``: an uninterrupted 2-epoch run,
    then runs with a NaN batch on rank 0 alone, a step fault on every
    rank, and a loader fault on every rank, each under
    ``fit(resilience=)`` — the ranks vote each recovery."""
    from tpudp_torch.mesh import make_mesh
    from tpudp_torch.resilience import ResiliencePolicy
    from tpudp_torch.training_faults import (CorruptingLoader, RaisingLoader,
                                             RaisingStep)

    mesh = make_mesh()
    base = os.environ["TPUDP_TEST_OUT"]
    out = {}
    cases = {"clean": {}, "nan": {"nan_at": {5} if rank == 0 else ()},
             "step": {"hook": RaisingStep(fail_at={6})},
             "loader": {"loader_fail": {5}}}
    for case, kw in cases.items():
        root = os.path.join(base, f"res-{case}")
        train, test = ckpt_loaders(rank, world, root)
        if kw.get("nan_at"):
            train = CorruptingLoader(train, nan_at=kw["nan_at"])
        if kw.get("loader_fail"):
            train = RaisingLoader(train, fail_at=kw["loader_fail"])
        t = ckpt_trainer(mesh, step_fault_hook=kw.get("hook"))
        t.fit(train, test, CKPT_EPOCHS,
              resilience=ResiliencePolicy(checkpoint_dir=root))
        res = state_of(t)
        res["stats"] = {k: v for k, v in t.stats.items() if k != "events"}
        res["events"] = [e["kind"] for e in t.stats["events"]]
        out[case] = res
    return out


#: The recovery vote's bound in ``job_lone_fault`` (seconds).
LONE_FAULT_VOTE_TIMEOUT = 3.0


def job_lone_fault(rank, world):
    """A step fault on the last rank alone under ``fit(resilience=)``:
    its peers wait inside the step's all-reduce and never vote, so the
    faulting rank's bounded vote times out and it exits with
    VOTE_TIMEOUT_EXIT; the peers' all-reduce then fails on the closed
    connection and their own vote exits alike.  Returns only if a rank
    was not stopped."""
    from tpudp_torch.mesh import make_mesh
    from tpudp_torch.resilience import ResiliencePolicy
    from tpudp_torch.training_faults import RaisingStep

    root = os.path.join(os.environ["TPUDP_TEST_OUT"], "lone")
    train, test = ckpt_loaders(rank, world, root)
    hook = RaisingStep(fail_at={6}) if rank == world - 1 else None
    t = ckpt_trainer(make_mesh(), step_fault_hook=hook, log_fn=print)
    t.fit(train, test, CKPT_EPOCHS, resilience=ResiliencePolicy(
        checkpoint_dir=root, vote_timeout_s=LONE_FAULT_VOTE_TIMEOUT))
    return {"stats": {k: v for k, v in t.stats.items() if k != "events"}}


# -- the parallel strategies (tests/test_torch_{seq_parallel,moe,
#    tensor_parallel,pipeline,strategies}.py): the JAX tests' tiny GPT-2s --

TP_CFG = dict(vocab_size=64, max_seq_len=32, num_layers=2, num_heads=4,
              d_model=32)
TP_HEADS1_CFG = dict(TP_CFG, num_heads=1)
PP_CFG = dict(vocab_size=64, max_seq_len=32, num_layers=4, num_heads=2,
              d_model=32)
MOE_CFG = dict(vocab_size=64, max_seq_len=32, num_layers=2, num_heads=2,
               d_model=32, mlp_impl="moe", num_experts=4,
               capacity_factor=4.0)  # cf == E: no token drops
SP_CFG = dict(vocab_size=96, max_seq_len=64, num_layers=2, num_heads=2,
              d_model=32)
STRATEGY_SEED = 21
STRATEGY_LR = 0.01
MIN_SIZE = 128  # fsdp/zero1's threshold at these widths (JAX's tests)


def lm_batches(vocab: int, steps: int = 3, batch: int = 8, t: int = 16,
               seed: int = 0):
    """The JAX tests' batches: numpy-seeded tokens, targets rolled by one."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, size=(steps, batch, t)).astype(np.int32)
    return [(x, np.roll(x, -1, axis=1).astype(np.int32)) for x in toks]


def strategy_tree(cfg: dict, seed: int = STRATEGY_SEED,
                  family: str = "gpt2"):
    """The flax-layout weights both packages start a rung from."""
    from tpudp_torch.models import gpt2, llama

    if family == "llama":
        return llama.random_params(llama.LlamaConfig(**cfg), seed)
    return gpt2.random_params(gpt2.GPT2Config(**cfg), seed)


def ring_inputs(b=2, t=64, h=4, dh=16, seed=0):
    """q, k, v and an output cotangent, float32 ``(b, t, h, dh)``."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, t, h, dh)).astype(np.float32)
            for _ in range(4)]


def cpu_tree(tree):
    """A checkpoint tree as detached CPU tensors (what a rank saves)."""
    import torch

    if isinstance(tree, dict):
        return {k: cpu_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()  # no alias of a live tensor
    return tree


def run_rung(name: str, cfg: dict, mesh_shape: dict, options: dict,
             batches, keep: bool = False, family: str = "gpt2",
             opt: dict | None = None, **model_kw) -> dict:
    """One rung through ``build_strategy``: its losses, this rank's
    state bytes beside one device's, and (every rank) the checkpoint
    tree's parameters and optimizer state in the JAX layout (``keep``:
    the built rung too, under ``built``).  ``family`` 'llama' trains a
    LLaMA of ``cfg``; ``opt`` adds to ``make_optimizer``'s arguments."""
    import torch

    from tpudp_torch import train
    from tpudp_torch.mesh import make_mesh_nd
    from tpudp_torch.models import gpt2, llama
    from tpudp_torch.parallel.sharded import state_nbytes
    from tpudp_torch.strategy import build_strategy

    if family == "llama":
        model = llama.Llama(llama.LlamaConfig(**cfg, **model_kw))
        model.load_state_dict(llama.params_from_jax(
            strategy_tree(dict(cfg, **model_kw), family="llama")))
    else:
        model = gpt2.GPT2(gpt2.GPT2Config(**cfg, **model_kw))
        model.load_state_dict(gpt2.params_from_jax(strategy_tree(cfg)))
    spec = train.make_optimizer(learning_rate=STRATEGY_LR, **(opt or {}))
    state = train.init_state(model, spec)
    one = state_nbytes(state)
    built = build_strategy(name, model, spec, make_mesh_nd(mesh_shape),
                           state, **options)
    st, losses = built.state, []
    for x, y in batches:
        st, loss = built.train_step(
            st, torch.as_tensor(built.shard_for(x)),
            torch.as_tensor(built.shard_for(y)))
        losses.append(float(loss))
    tree = train.state_to_jax(st)
    out = {"losses": losses, "params": cpu_tree(tree["params"]),
           "opt_state": cpu_tree(tree["opt_state"]),
           "momentum": cpu_tree(tree["opt_state"].get("momentum")),
           "bytes": state_nbytes(st), "one_device_bytes": one,
           "local_shapes": {k: tuple(v.shape)
                            for k, v in st.model.state_dict().items()}}
    if hasattr(built.train_step, "peak_stash"):
        out["peak_stash"] = built.train_step.peak_stash
    if keep:
        out["built"] = built
    return out


def job_ring(rank, world):
    """Ring attention over the world's ring: this rank's output blocks
    (causal and full) and the causal gradients of q, k and v for the
    seeded output cotangent."""
    import torch
    import torch.distributed as dist

    from tpudp_torch.parallel.ring_attention import ring_attention

    group = dist.group.WORLD
    q, k, v, do = (torch.as_tensor(shard(a.swapaxes(0, 1), rank, world)
                                   .swapaxes(0, 1).copy())
                   for a in ring_inputs())
    out = {}
    for causal in (True, False):
        out[f"o-{causal}"] = ring_attention(q, k, v, group,
                                            causal=causal)
    q, k, v = (x.clone().requires_grad_(True) for x in (q, k, v))
    (ring_attention(q, k, v, group, causal=True) * do).sum().backward()
    out["grads"] = [x.grad for x in (q, k, v)]
    return out


def job_sp(rank, world):
    """DP x SP on a (2, 2) mesh: the rung's 3 steps (SP_CFG, batch 4, t
    64), and a fresh ring model's logits block and eval sums (global
    positions) against the same weights."""
    import torch

    from tpudp_torch.mesh import bind_axes, make_mesh_nd
    from tpudp_torch.models import gpt2
    from tpudp_torch.strategy import build_strategy

    batches = lm_batches(96, steps=3, batch=4, t=64, seed=0)
    out = {"rung": run_rung("sp", SP_CFG, {"data": 2, "seq": 2}, {},
                            batches, attn_impl="ring", seq_axis="seq")}
    mesh = make_mesh_nd({"data": 2, "seq": 2})
    c = gpt2.GPT2Config(**SP_CFG, attn_impl="ring", seq_axis="seq")
    model = gpt2.GPT2(c)
    model.load_state_dict(gpt2.params_from_jax(strategy_tree(SP_CFG)))
    from tpudp_torch import train

    spec = train.make_optimizer(learning_rate=STRATEGY_LR)
    built = build_strategy("sp", model, spec, mesh,
                           train.init_state(model, spec))
    tokens, targets = lm_batches(96, steps=1, batch=4, t=64, seed=3)[0]
    x = torch.as_tensor(built.shard_for(tokens))
    with torch.no_grad(), bind_axes({"seq": mesh.group("seq")}):
        out["logits"] = model(x)
    weights = np.array([1.0, 0.0, 1.0, 1.0], np.float32)
    out["eval"] = [float(v) for v in built.eval_step(
        built.state, x, torch.as_tensor(built.shard_for(targets)),
        torch.as_tensor(built.shard_for(weights)))]
    return out


def job_tp(rank, world):
    """DP x TP on a (2, 2) mesh: 3 steps of TP_CFG, and under ``heads1``
    the same at one head (the axis does not divide it: attention whole
    on every rank)."""
    from tpudp_torch.parallel.tensor import gpt2_tp_rules

    out = run_rung("tp", TP_CFG, {"data": 2, "model": 2},
                   {"rules": gpt2_tp_rules()}, lm_batches(64))
    out["heads1"] = run_rung("tp", TP_HEADS1_CFG, {"data": 2, "model": 2},
                             {"rules": gpt2_tp_rules()}, lm_batches(64))
    return out


def job_fsdp(rank, world):
    """fsdp and zero1 over a 1-D mesh of the world, min_size 128."""
    return {name: run_rung(name, TP_CFG, {"data": world},
                           {"min_size": MIN_SIZE}, lm_batches(64))
            for name in ("fsdp", "zero1")}


def job_pp(rank, world):
    """DP x PP on a (2, 2) mesh, 2 microbatches: gpipe and 1f1b."""
    return {schedule: run_rung("pp", PP_CFG, {"data": 2, "pipe": 2},
                               {"n_microbatches": 2, "schedule": schedule},
                               lm_batches(64))
            for schedule in ("gpipe", "1f1b")}


def job_ep(rank, world):
    """DP x EP on a (2, 2) mesh, no balance loss (JAX's oracle test)."""
    return run_rung("ep", MOE_CFG, {"data": 2, "expert": 2},
                    {"aux_loss_coef": 0.0}, lm_batches(64),
                    expert_axis="expert")


# The 1f1b_mpmd geometries of tests/test_torch_schedule.py in one world
# of 4: name -> (mesh shape, interleave, shard_optimizer).  A leading
# "rep" axis runs independent copies of a smaller pipeline.
SCHEDULE_GEOMETRIES = {
    "pp1-dp1": ({"rep": 4, "data": 1, "pipe": 1}, 1, True),
    "pp2-dp1": ({"rep": 2, "data": 1, "pipe": 2}, 1, True),
    "pp4-dp1": ({"data": 1, "pipe": 4}, 1, True),
    "pp2v2-dp1": ({"rep": 2, "data": 1, "pipe": 2}, 2, True),
    "pp1-dp2": ({"rep": 2, "data": 2, "pipe": 1}, 1, True),
    "pp2-dp2": ({"data": 2, "pipe": 2}, 1, True),
    "pp2v2-dp2": ({"data": 2, "pipe": 2}, 2, True),
    "pp2-dp2-unsharded": ({"data": 2, "pipe": 2}, 1, False),
}
SCHEDULE_EVAL_SEED = 7
# pp2-dp2 again, with remat and with AdamW: name -> (options, optimizer).
SCHEDULE_VARIANTS = {"pp2-dp2-remat": ({"remat": True}, None),
                     "pp2-dp2-adamw": ({}, {"optimizer": "adamw"})}


def job_schedule(rank, world):
    """Every SCHEDULE_GEOMETRIES run of PP_CFG (2 microbatches, 3 steps)
    through ``build_strategy``, the pp2-dp2 state's eval sums on a fresh
    batch, and the Trainer's supervisor on pp2-dp2: a clean 2-epoch fit
    against one whose fifth device call raises."""
    import torch

    from tpudp_torch.mesh import make_mesh_nd
    from tpudp_torch.resilience import ResiliencePolicy
    from tpudp_torch.trainer import Trainer
    from tpudp_torch.training_faults import RaisingStep

    out = {}
    for name, (shape, interleave, shard) in SCHEDULE_GEOMETRIES.items():
        options = {"n_microbatches": 2, "schedule": "1f1b_mpmd",
                   "interleave": interleave, "shard_optimizer": shard}
        out[name] = run_rung("pp", PP_CFG, shape, options, lm_batches(64),
                             keep=name == "pp2-dp2")
    for name, (extra, opt) in SCHEDULE_VARIANTS.items():
        shape, interleave, shard = SCHEDULE_GEOMETRIES["pp2-dp2"]
        options = {"n_microbatches": 2, "schedule": "1f1b_mpmd",
                   "interleave": interleave, "shard_optimizer": shard,
                   **extra}
        out[name] = run_rung("pp", PP_CFG, shape, options, lm_batches(64),
                             opt=opt)
    built = out["pp2-dp2"].pop("built")
    x, y = lm_batches(64, steps=1, seed=SCHEDULE_EVAL_SEED)[0]
    out["eval"] = [float(v) for v in built.eval_step(
        built.state, *(torch.as_tensor(built.shard_for(a)) for a in (x, y)),
        torch.as_tensor(built.shard_for(np.ones(8, np.float32))))]
    root = os.environ["TPUDP_TEST_OUT"]
    for case, hook in (("clean", None), ("fault", RaisingStep(fail_at={5}))):
        model = gpt2_model(PP_CFG)
        trainer = Trainer(model, make_mesh_nd({"data": 2, "pipe": 2}),
                          strategy="pp",
                          strategy_options={"n_microbatches": 2,
                                            "schedule": "1f1b_mpmd"},
                          learning_rate=0.01, log_every=2,
                          log_fn=lambda line: None, step_fault_hook=hook)
        trainer.fit(TokenLoader(), epochs=2, resilience=ResiliencePolicy(
            checkpoint_dir=os.path.join(root, f"mpmd-{case}")))
        from tpudp_torch.train import state_to_jax

        out[f"fit-{case}"] = {
            "params": cpu_tree(state_to_jax(trainer.state)["params"]),
            "step_retries": trainer.stats.get("step_retries", 0),
            "events": [e["kind"] for e in trainer.stats.get("events", [])]}
    return out


def gpt2_model(cfg: dict, seed: int = STRATEGY_SEED, **model_kw):
    """The port's GPT-2 of ``cfg`` with the strategy tests' weights."""
    from tpudp_torch.models import gpt2

    model = gpt2.GPT2(gpt2.GPT2Config(**cfg, **model_kw))
    model.load_state_dict(gpt2.params_from_jax(strategy_tree(cfg, seed)))
    return model


# LLaMA (tests/test_torch_llama_train.py): tests/test_llama.py's tiny
# geometry; name -> (strategy, mesh shape, options, model options).
LLAMA_CFG = dict(vocab_size=64, max_seq_len=64, num_layers=2, num_heads=4,
                 d_model=32)
LLAMA_RUNGS = {
    "tp": ("tp", {"data": 2, "model": 2}, "rules", {}),
    "tp-kv1": ("tp", {"data": 2, "model": 2}, "rules", {"num_kv_heads": 1}),
    "fsdp": ("fsdp", {"data": 4}, {"min_size": MIN_SIZE},
             {"num_kv_heads": 2}),
    "zero1": ("zero1", {"data": 4}, {"min_size": MIN_SIZE},
              {"num_kv_heads": 2}),
    "sp": ("sp", {"data": 2, "seq": 2}, {},
           {"num_kv_heads": 2, "attn_impl": "ring", "seq_axis": "seq"}),
}
LLAMA_SP_BATCH = dict(steps=3, batch=4, t=32, seed=0)


def llama_batches(name: str):
    return (lm_batches(64, **LLAMA_SP_BATCH) if name == "sp"
            else lm_batches(64))


def job_llama(rank, world):
    """Every LLAMA_RUNGS rung of LLAMA_CFG for 3 steps, and the sp
    rung's eval sums on its last batch (weights 1, 0, 1, 1)."""
    import torch

    from tpudp_torch.parallel.tensor import llama_tp_rules

    out = {}
    for name, (strategy, shape, options, model_kw) in LLAMA_RUNGS.items():
        if options == "rules":
            options = {"rules": llama_tp_rules()}
        out[name] = run_rung(strategy, LLAMA_CFG, shape, options,
                             llama_batches(name), keep=name == "sp",
                             family="llama", **model_kw)
    built = out["sp"].pop("built")
    x, y = llama_batches("sp")[-1]
    weights = np.array([1.0, 0.0, 1.0, 1.0], np.float32)
    out["sp-eval"] = [float(v) for v in built.eval_step(
        built.state, *(torch.as_tensor(built.shard_for(a))
                       for a in (x, y, weights)))]
    return out


class TokenLoader:
    """The JAX strategy suite's loader: 4 global batches of 8 x 16
    tokens with unit weights, the same on every rank."""

    def __init__(self, vocab: int = 64, steps: int = 4, seed: int = 0):
        import torch

        self.batches = [
            (torch.as_tensor(x), torch.as_tensor(y),
             torch.ones(8, dtype=torch.float32))
            for x, y in lm_batches(vocab, steps=steps, batch=8, t=16,
                                   seed=seed)]

    def set_epoch(self, epoch):
        pass

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)


# rung -> (mesh shape, model config, model options, strategy options)
TRAINER_RUNGS = {
    "tp": ({"data": 2, "model": 2}, TP_CFG, {}, "rules"),
    "fsdp": ({"data": 4}, TP_CFG, {}, {"min_size": MIN_SIZE}),
    "zero1": ({"data": 4}, TP_CFG, {}, {"min_size": MIN_SIZE}),
    "pp": ({"data": 2, "pipe": 2}, PP_CFG, {}, {"n_microbatches": 2}),
    "ep": ({"data": 2, "expert": 2}, MOE_CFG, {"expert_axis": "expert"}, {}),
    "sp": ({"data": 2, "seq": 2}, TP_CFG,
           {"attn_impl": "ring", "seq_axis": "seq"}, {}),
}
# The rungs of tests/test_torch_sdc.py: TRAINER_RUNGS and 1f1b_mpmd.
SDC_RUNGS = dict(TRAINER_RUNGS, **{
    "pp-mpmd": ({"data": 2, "pipe": 2}, PP_CFG, {},
                {"n_microbatches": 2, "schedule": "1f1b_mpmd"})})


def trainer_rung(name: str, seed: int = STRATEGY_SEED, extra=None, **kw):
    """The port's Trainer on rung ``name`` (TRAINER_RUNGS), weights from
    ``seed``; ``extra`` adds strategy options."""
    from tpudp_torch.mesh import make_mesh_nd
    from tpudp_torch.models import gpt2
    from tpudp_torch.parallel.tensor import gpt2_tp_rules
    from tpudp_torch.trainer import Trainer

    shape, cfg, model_kw, options = SDC_RUNGS[name]
    if options == "rules":
        options = {"rules": gpt2_tp_rules()}
    c = gpt2.GPT2Config(**cfg, **model_kw)
    model = gpt2.GPT2(c)
    model.load_state_dict(gpt2.params_from_jax(strategy_tree(cfg, seed)))
    kw.setdefault("log_fn", lambda line: None)
    return Trainer(model, make_mesh_nd(shape), strategy=name.split("-")[0],
                   strategy_options=dict(options, **(extra or {})),
                   learning_rate=0.01,
                   log_every=2, **kw)


def job_trainer(rank, world):
    """Every rung through the Trainer: fit one epoch with eval (the
    reference's lines), a checkpoint round trip into a Trainer of other
    weights, and a step of the restored state."""
    from tpudp_torch.train import state_to_jax
    from tpudp_torch.utils.checkpoint import (restore_checkpoint,
                                              save_checkpoint)

    root = os.environ["TPUDP_TEST_OUT"]
    out = {}
    for name, (_, cfg, _, _) in TRAINER_RUNGS.items():
        lines = []
        trainer = trainer_rung(name, log_fn=lines.append)
        loader = TokenLoader(cfg["vocab_size"])
        trainer.fit(loader, test_loader=loader, epochs=1)
        loss, acc = trainer.evaluate(loader)
        path = save_checkpoint(os.path.join(root, f"ckpt-{name}"),
                               trainer.state)
        fresh = trainer_rung(name, seed=STRATEGY_SEED + 1)
        restore_checkpoint(path, fresh.state)
        saved, restored = (cpu_tree(state_to_jax(t.state))
                           for t in (trainer, fresh))
        x, y, _ = fresh._device_batch(next(iter(loader)))
        _, loss2 = fresh.train_step(fresh.state, x, y)
        out[name] = {"lines": lines, "eval": (loss, acc),
                     "saved": saved, "restored": restored,
                     "records": trainer.records, "loss2": float(loss2),
                     "metrics": trainer.metrics()}
    # tp's checkpoint (JAX's global layout) resharded into zero1
    other = trainer_rung("zero1", seed=STRATEGY_SEED + 2)
    restore_checkpoint(os.path.join(root, "ckpt-tp"), other.state)
    out["tp->zero1"] = cpu_tree(state_to_jax(other.state))
    return out


# -- the strategies on the card (tests/test_torch_cuda_strategies.py):
#    two gloo ranks on one card, GPT-2 at the flash kernels' shapes --------

CUDA_CFG = dict(vocab_size=512, max_seq_len=256, num_layers=2, num_heads=4,
                d_model=256)


def job_cuda_strategies(rank, world):
    """On the card (TF32 off): tp (1 x world) with flash attention and
    with dense attention, 2 steps each, with the flash launches; the same
    for the MPMD pipeline (pipe = world, 2 microbatches) and for LLaMA
    under tp at one KV head (whole on every rank); fsdp over the world
    with its state bytes beside one rank's."""
    import torch

    from tpudp_torch import train
    from tpudp_torch.mesh import make_mesh_nd
    from tpudp_torch.models import gpt2, llama
    from tpudp_torch.ops import flash_attention as fa
    from tpudp_torch.parallel.sharded import state_nbytes
    from tpudp_torch.parallel.tensor import gpt2_tp_rules, llama_tp_rules
    from tpudp_torch.strategy import build_strategy

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    batches = lm_batches(512, steps=2, batch=4, t=256, seed=6)
    mpmd = {"n_microbatches": 2, "schedule": "1f1b_mpmd"}
    out = {}
    for name, impl, strategy, shape, options in (
            ("tp-flash", "flash", "tp", {"data": 1, "model": world},
             {"rules": gpt2_tp_rules()}),
            ("tp-dense", "dense", "tp", {"data": 1, "model": world},
             {"rules": gpt2_tp_rules()}),
            ("mpmd-flash", "flash", "pp", {"data": 1, "pipe": world}, mpmd),
            ("mpmd-dense", "dense", "pp", {"data": 1, "pipe": world}, mpmd),
            ("llama-tp-flash", "flash", "tp", {"data": 1, "model": world},
             {"rules": llama_tp_rules()}),
            ("llama-tp-dense", "dense", "tp", {"data": 1, "model": world},
             {"rules": llama_tp_rules()}),
            ("fsdp", "flash", "fsdp", {"data": world}, {})):
        if name.startswith("llama"):
            cfg = llama.LlamaConfig(**CUDA_CFG, num_kv_heads=1,
                                    attn_impl=impl)
            model = llama.Llama(cfg)
            model.load_state_dict(llama.params_from_jax(
                llama.random_params(cfg, 7)))
        else:
            cfg = gpt2.GPT2Config(**CUDA_CFG, attn_impl=impl)
            model = gpt2.GPT2(cfg)
            model.load_state_dict(gpt2.params_from_jax(
                gpt2.random_params(cfg, 7)))
        model.cuda()
        spec = train.make_optimizer(learning_rate=0.01)
        state = train.init_state(model, spec)
        built = build_strategy(strategy, model, spec, make_mesh_nd(shape),
                               state, **options)
        for fn in fa.KERNELS.values():
            fn.launches = 0
        st, losses = built.state, []
        for x, y in batches:
            st, loss = built.train_step(
                st, *(torch.as_tensor(built.shard_for(a), device="cuda")
                      for a in (x, y)))
            losses.append(float(loss))
        out[name] = {"losses": losses, "bytes": state_nbytes(st),
                     "launches": {k: fn.launches
                                  for k, fn in fa.KERNELS.items()}}
    # one rank's state after its steps, for the bytes
    cfg = gpt2.GPT2Config(**CUDA_CFG)
    model = gpt2.GPT2(cfg).cuda()
    spec = train.make_optimizer(learning_rate=0.01)
    st = train.init_state(model, spec)
    step = train.make_train_step(model, spec)
    x, y = (torch.as_tensor(a, device="cuda") for a in batches[0])
    st, _ = step(st, x, y)
    out["one_rank_bytes"] = state_nbytes(st)
    return out


# -- ViT (tests/test_torch_dp_train.py, tests/test_torch_tensor_parallel.py)
#    and VGG under vgg_tp_rules (tests/test_torch_tensor_parallel.py) -----

# The JAX parity tests' tiny ViT: 16x16 images in 4x4 patches (16
# tokens), 2 layers, 2 heads, d 32.
VIT_CFG = dict(image_size=16, patch_size=4, num_classes=10, num_layers=2,
               num_heads=2, d_model=32)
VIT_ROWS = 4  # per rank
# vgg_tp_rules' meshes: (2, 2), and (1, 4), where the 10-class
# classifier stays whole (4 does not divide it).
VGG_TP_MESHES = {"dp2-tp2": {"data": 2, "model": 2},
                 "tp4": {"data": 1, "model": 4}}
VGG_TP_WORLD = 2  # global batch: VGG_TP_WORLD * ROWS rows (vgg_batches)


def vit_tree(seed: int = 19):
    """The tiny ViT's flax-layout weights, with biases, LayerNorm
    parameters and ``pos_embed`` drawn away from their inits so that
    every leaf reaches the logits."""
    from tpudp_torch.models import vit

    tree = vit.random_params(vit.ViTConfig(**VIT_CFG), seed)
    rng = np.random.default_rng(seed + 1)

    def perturb(t):
        if isinstance(t, dict):
            return {k: perturb(v) for k, v in t.items()}
        return (t + rng.normal(size=t.shape) * 0.05).astype(np.float32)

    return perturb(tree)


def vit_batches(world: int, steps: int = STEPS, seed: int = 20):
    """``steps`` global batches of ``world * VIT_ROWS`` images (NHWC,
    float32) and labels."""
    rng = np.random.default_rng(seed)
    n, size = world * VIT_ROWS, VIT_CFG["image_size"]
    return [(rng.normal(size=(n, size, size, 3)).astype(np.float32),
             rng.integers(0, 10, size=n).astype(np.int32))
            for _ in range(steps)]


def vit_model(**kw):
    from tpudp_torch.models import vit

    model = vit.ViT(vit.ViTConfig(**VIT_CFG, **kw))
    model.load_state_dict(vit.params_from_jax(vit_tree()))
    return model


class ImageLoader:
    """Global batches of (images, labels, unit weights) as tensors, the
    same on every rank (a strategy's Trainer takes its block), or this
    rank's rows of them (``rank``, ``world``: the DP Trainer)."""

    def __init__(self, batches, rank: int = 0, world: int = 1):
        import torch

        self.batches = [(torch.as_tensor(shard(x, rank, world)),
                         torch.as_tensor(shard(y, rank, world)),
                         torch.ones(len(x) // world, dtype=torch.float32))
                        for x, y in batches]

    def set_epoch(self, epoch):
        pass

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)


def job_vit(rank, world):
    """The tiny ViT under the all-reduce rung (SGD): ``STEPS`` steps of
    this rank's rows through ``make_train_step``, and the same batches
    through ``Trainer(vit, mesh, sync='allreduce')``'s epoch."""
    import torch

    from tpudp_torch import train
    from tpudp_torch.mesh import make_mesh
    from tpudp_torch.trainer import Trainer

    mesh = make_mesh()
    model = vit_model()
    spec = train.make_optimizer(**SGD)
    state = train.init_state(model, spec, mesh)
    step = train.make_train_step(model, spec, mesh, "allreduce")
    losses = []
    for x, y in vit_batches(world):
        x, y = (torch.as_tensor(shard(a, rank, world)) for a in (x, y))
        state, loss = step(state, x, y)
        losses.append(float(loss))
    trainer = Trainer(vit_model(), mesh, "allreduce", log_fn=lambda s: None,
                      log_every=1, **{k: v for k, v in SGD.items()})
    trainer.train_epoch(ImageLoader(vit_batches(world), rank, world))
    return {"losses": losses, "params": cpu_tree(state_to_jax_params(state)),
            "trainer_params": cpu_tree(state_to_jax_params(trainer.state)),
            "trainer_loss_sum": float(trainer.state.loss_sum)}


def state_to_jax_params(state):
    from tpudp_torch import train

    return train.state_to_jax(state)["params"]


def vgg_tp_rung(mesh_shape: dict, seed: int = 11):
    """The narrow VGG (``vgg_init(seed)``) under ``vgg_tp_rules`` on
    ``mesh_shape``, built through ``build_strategy`` with SGD."""
    from tpudp_torch import train
    from tpudp_torch.mesh import make_mesh_nd
    from tpudp_torch.models import vgg
    from tpudp_torch.parallel.tensor import vgg_tp_rules
    from tpudp_torch.strategy import build_strategy

    model = vgg.VGG(CFG)
    model.load_state_dict(vgg.params_from_jax(*vgg_init(seed)))
    spec = train.make_optimizer(**SGD)
    return build_strategy("tp", model, spec, make_mesh_nd(mesh_shape),
                          train.init_state(model, spec),
                          rules=vgg_tp_rules())


def job_vgg_tp(rank, world):
    """Each VGG_TP_MESHES mesh: ``STEPS`` steps of the narrow VGG under
    ``vgg_tp_rules`` on the global batches of ``vgg_batches(
    VGG_TP_WORLD)``, the checkpoint tree (JAX's global layout), the eval
    sums of ``eval_batch`` after the steps, this rank's local shapes,
    and the tree after a checkpoint round trip into a rung of other
    weights; then a Trainer's epoch on the (2, 2) mesh.  Also the tiny
    ViT under fsdp and zero1 over the world (min_size 128)."""
    import torch

    from tpudp_torch import train
    from tpudp_torch.mesh import make_mesh_nd
    from tpudp_torch.models import vgg
    from tpudp_torch.parallel.tensor import vgg_tp_rules
    from tpudp_torch.strategy import build_strategy
    from tpudp_torch.trainer import Trainer
    from tpudp_torch.utils.checkpoint import (restore_checkpoint,
                                              save_checkpoint)

    root = os.environ["TPUDP_TEST_OUT"]
    out = {}
    for name, shape in VGG_TP_MESHES.items():
        built = vgg_tp_rung(shape)
        st, losses = built.state, []
        for x, y in vgg_batches(VGG_TP_WORLD):
            st, loss = built.train_step(
                st, *(torch.as_tensor(built.shard_for(a)) for a in (x, y)))
            losses.append(float(loss))
        images, labels, weights = eval_batch(VGG_TP_WORLD)
        sums = built.eval_step(st, *(torch.as_tensor(built.shard_for(a))
                                     for a in (images, labels, weights)))
        path = save_checkpoint(os.path.join(root, f"vgg-{name}"), st)
        fresh = vgg_tp_rung(shape, seed=31)
        restore_checkpoint(path, fresh.state)
        out[name] = {"losses": losses,
                     "tree": cpu_tree(train.state_to_jax(st)),
                     "restored": cpu_tree(train.state_to_jax(fresh.state)),
                     "eval": [float(v) for v in sums],
                     "local_shapes": {k: tuple(v.shape) for k, v in
                                      st.model.state_dict().items()}}
    model = vgg.VGG(CFG)
    model.load_state_dict(vgg.params_from_jax(*vgg_init()))
    trainer = Trainer(model, make_mesh_nd(VGG_TP_MESHES["dp2-tp2"]),
                      strategy="tp",
                      strategy_options={"rules": vgg_tp_rules()},
                      log_fn=lambda s: None, log_every=1,
                      **{k: v for k, v in SGD.items()})
    trainer.train_epoch(ImageLoader(vgg_batches(VGG_TP_WORLD)))
    out["trainer"] = {"tree": cpu_tree(train.state_to_jax(trainer.state)),
                      "loss_sum": float(trainer.state.loss_sum)}
    for rung in ("fsdp", "zero1"):
        model = vit_model()
        spec = train.make_optimizer(**SGD)
        built = build_strategy(rung, model, spec, make_mesh_nd(
            {"data": world}), train.init_state(model, spec),
            min_size=MIN_SIZE)
        st, losses = built.state, []
        for x, y in vit_batches(world):
            st, loss = built.train_step(
                st, *(torch.as_tensor(built.shard_for(a)) for a in (x, y)))
            losses.append(float(loss))
        out[f"vit-{rung}"] = {"losses": losses,
                              "params": cpu_tree(state_to_jax_params(st))}
    return out


# tp of every family under every rule table, as JAX's make_tp_train_step
# resolves it: name -> (family, table, mesh shape).  ResNet under
# vgg_tp_rules and ViT under gpt2_tp_rules split (at model 4 the ResNet's
# 10-class Dense_0 and the ViT's 2 heads stay whole); a table that splits
# nothing of a family runs replicated (GPT-2's at model 4 too); GPT-2
# under llama_tp_rules and LLaMA under gpt2_tp_rules split the embedding
# only.
TP_CELLS = {
    "resnet-vgg-dp2-tp2": ("resnet", "vgg", {"data": 2, "model": 2}),
    "resnet-vgg-tp4": ("resnet", "vgg", {"data": 1, "model": 4}),
    "vit-gpt2-dp2-tp2": ("vit", "gpt2", {"data": 2, "model": 2}),
    "vit-gpt2-tp4": ("vit", "gpt2", {"data": 1, "model": 4}),
    "gpt2-vgg": ("gpt2", "vgg", {"data": 2, "model": 2}),
    "gpt2-vgg-tp4": ("gpt2", "vgg", {"data": 1, "model": 4}),
    "llama-vgg": ("llama", "vgg", {"data": 2, "model": 2}),
    "vgg-gpt2": ("vgg", "gpt2", {"data": 2, "model": 2}),
    "vgg-llama": ("vgg", "llama", {"data": 2, "model": 2}),
    "resnet-gpt2": ("resnet", "gpt2", {"data": 2, "model": 2}),
    "resnet-llama": ("resnet", "llama", {"data": 2, "model": 2}),
    "vit-llama": ("vit", "llama", {"data": 2, "model": 2}),
    "vit-vgg": ("vit", "vgg", {"data": 2, "model": 2}),
    "gpt2-llama": ("gpt2", "llama", {"data": 2, "model": 2}),
    "llama-gpt2": ("llama", "gpt2", {"data": 2, "model": 2}),
}


def tp_cell_inputs(family: str):
    """``(port model, optimizer arguments, global batches)`` of a
    TP_CELLS family, its weights from the numpy seeds the JAX side
    reads too."""
    from tpudp_torch.models import gpt2, llama, resnet, vgg

    if family == "gpt2":
        model = gpt2.GPT2(gpt2.GPT2Config(**TP_CFG))
        model.load_state_dict(gpt2.params_from_jax(strategy_tree(TP_CFG)))
        return model, dict(learning_rate=STRATEGY_LR), lm_batches(64)
    if family == "llama":
        model = llama.Llama(llama.LlamaConfig(**LLAMA_CFG))
        model.load_state_dict(llama.params_from_jax(
            strategy_tree(LLAMA_CFG, family="llama")))
        return model, dict(learning_rate=STRATEGY_LR), lm_batches(64)
    if family == "vit":
        return vit_model(), SGD, vit_batches(2)
    if family == "vgg":
        model = vgg.VGG(CFG)
        model.load_state_dict(vgg.params_from_jax(*vgg_init()))
    else:
        model = resnet.ResNet(RESNET_STAGES, 10, RESNET_WIDTH)
        model.load_state_dict(resnet.params_from_jax(*resnet_init()))
    return model, SGD, vgg_batches(VGG_TP_WORLD)


def job_tp_cells(rank, world):
    """Every TP_CELLS cell: 3 steps through ``build_strategy('tp')``,
    the checkpoint tree (JAX's global layout) and this rank's local
    shapes."""
    import torch

    from tpudp_torch import train
    from tpudp_torch.mesh import make_mesh_nd
    from tpudp_torch.parallel import tensor
    from tpudp_torch.strategy import build_strategy

    out = {}
    for name, (family, table, shape) in TP_CELLS.items():
        model, opt, batches = tp_cell_inputs(family)
        spec = train.make_optimizer(**opt)
        built = build_strategy(
            "tp", model, spec, make_mesh_nd(shape),
            train.init_state(model, spec),
            rules=getattr(tensor, f"{table}_tp_rules")())
        st, losses = built.state, []
        for x, y in batches:
            st, loss = built.train_step(
                st, *(torch.as_tensor(built.shard_for(a)) for a in (x, y)))
            losses.append(float(loss))
        out[name] = {"losses": losses,
                     "tree": cpu_tree(train.state_to_jax(st)),
                     "module": type(st.model).__name__,
                     "local_shapes": {k: tuple(v.shape) for k, v in
                                      st.model.state_dict().items()}}
    return out


# The two-host disaggregated round: the JAX tests' tiny GPT-2 and prompts.
DISAGG_CFG = dict(vocab_size=61, max_seq_len=96, num_layers=2, num_heads=2,
                  d_model=32)
DISAGG_SEED = 41        # the prompts'
DISAGG_MODEL_SEED = 21  # the weights' (tests/test_torch_disagg.py's)


def disagg_jobs() -> list:
    """The ``(prompt, max_new_tokens)`` pairs rank 0 prefills and stages."""
    rng = np.random.default_rng(DISAGG_SEED)
    return [(rng.integers(0, 61, size=9 + 2 * i).astype(np.int32), 6 + i)
            for i in range(2)]


def job_disagg(rank, world):
    """``DisaggHost.round`` over the gloo world: rank 0 prefills and stages
    each request after its first token, the other ranks decode; rank 0's
    first non-empty transfer is bit-flipped on the wire, so rank 1
    quarantines it (a flight dump under ``flight{rank}``) and the retry
    delivers.  Also the host collectives on fixed inputs."""
    from tpudp_torch.models import gpt2
    from tpudp_torch.serve import Engine
    from tpudp_torch.serve.disagg import DisaggHost
    from tpudp_torch.serve.faults import CorruptPagePayload
    from tpudp_torch.utils import checkpoint as ck

    out = {"blobs": [list(b) for b in
                     ck.gather_host_blobs(bytes(range(rank * 3)))],
           "values": ck.gather_host_values(10 + rank),
           "ok": ck.all_hosts_ok(True, value=7),
           "split": ck.all_hosts_ok(True, value=rank)}
    model = gpt2.build(gpt2.GPT2Config(**DISAGG_CFG), DISAGG_MODEL_SEED,
                       "cpu")
    eng = Engine(model, device="cpu", num_slots=2, max_len=64,
                 prefill_chunk=8, kv_pages=16,
                 flight_dir=os.path.join(os.environ["TPUDP_TEST_OUT"],
                                         f"flight{rank}"))

    class FirstTransferCorrupt:
        """One-shot: bit-flip the first non-empty outgoing transfer."""

        def __init__(self):
            self.inner = CorruptPagePayload(rank=0, at_seqs=range(999))
            self.fired = []

        def on_send(self, rank_, seq, blob):
            if self.fired:
                return blob
            res = self.inner.on_send(rank_, seq, blob)
            self.fired = list(self.inner.fired)
            return res

    host = DisaggHost(eng, rank=rank, n_hosts=world,
                      role="prefill" if rank == 0 else "decode",
                      faults=(FirstTransferCorrupt(),) if rank == 0 else (),
                      retries=2)
    admitted = []
    host.on_admit = lambda src, t, r: admitted.append(r)
    jobs = disagg_jobs()
    staged = set()
    handles = ([eng.submit(p, n) for p, n in jobs] if rank == 0 else [])
    for _ in range(200):
        eng.step()
        for h in handles:
            if (h.id not in staged and h.tokens and not h.done
                    and h._nfill == h._fill.size and h._slot is not None):
                host.stage(1, h)
                staged.add(h.id)
        my_done = (eng.slots_in_use == 0 and eng.queue_depth == 0
                   and host.pending == 0
                   and (rank != 0 or len(staged) == len(jobs)))
        if host.round(done=my_done):
            break
    else:
        raise RuntimeError("the round loop never reached a joint done")
    eng.check_paged()
    out.update(stats=dict(eng.stats), spans=sorted(eng.metrics()["spans"]),
               flight_dumps=eng.flight.dumps,
               admitted=[(r.prompt.tolist(), r.max_new_tokens, r.tokens,
                          r.ok) for r in admitted])
    return out

# -- silent-data-corruption defense and the elastic relaunch
#    (tests/test_torch_sdc.py): worlds of 4 and 2 ranks --------------------

SDC_TRAIN, SDC_BATCH, SDC_EPOCHS = 64, 16, 2  # 4 steps an epoch, windows of 2
# case -> (injector kind, schedule, persist_from options)
SDC_CASES = {
    "clean": None,
    "params": ("params", [(3, 2, 5)], {}),
    "grads": ("grads", [(3, 1, 9)], {}),
    "persistent": ("params", (), {"persist_from": 3, "replica": 1,
                                  "bit": 7}),
}


def save_case(name: str, rank: int, obj) -> None:
    """One case's result of this rank, saved at once (a later case may
    end the process)."""
    import torch

    torch.save(obj, os.path.join(os.environ["TPUDP_TEST_OUT"],
                                 f"{name}-rank{rank}.pt"))


def sdc_loader(rank: int, world: int, root: str):
    """This rank's rows of the global batches of 16 (the contiguous
    layout: the same global batches at any world size)."""
    from tpudp_torch.data import DataLoader, ShardedSampler, load_cifar10

    train_set, _, _ = load_cifar10(os.path.join(root, "no-data"),
                                   synthetic_train_size=SDC_TRAIN,
                                   synthetic_test_size=16)
    return DataLoader(train_set, SDC_BATCH // world,
                      sampler=ShardedSampler(SDC_TRAIN, world, rank,
                                             shuffle=True, seed=3,
                                             batch_contiguous=SDC_BATCH),
                      train=True, seed=3, backend="numpy")


def sdc_injector(case: str):
    from tpudp_torch.sdc import BitFlipGrads, BitFlipParams

    spec = SDC_CASES[case]
    if spec is None:
        return None
    kind, schedule, kw = spec
    return (BitFlipParams if kind == "params" else BitFlipGrads)(
        schedule, **kw)


def sdc_fit(case: str, rank: int, world: int, **policy_kw):
    """The narrow VGG trained 2 epochs under ``sdc_check_every=2`` with
    ``case``'s injector; returns the result record (the error raised, if
    any, by type and replica)."""
    from tpudp_torch.mesh import make_mesh
    from tpudp_torch.resilience import ResiliencePolicy
    from tpudp_torch.sdc import QUARANTINE_MARKER

    root = os.path.join(os.environ["TPUDP_TEST_OUT"], f"sdc-{case}-{world}")
    inj = sdc_injector(case if case in SDC_CASES else "persistent")
    t = ckpt_trainer(make_mesh(), track_sdc_fingerprint=True,
                     sdc_fault_hook=inj)
    error = None
    try:
        t.fit(sdc_loader(rank, world, root), epochs=SDC_EPOCHS,
              resilience=ResiliencePolicy(checkpoint_dir=root,
                                          sdc_check_every=2, **policy_kw))
    except Exception as e:  # the verdicts under test
        error = (type(e).__name__, getattr(e, "replica", None))
    marker = os.path.join(root, QUARANTINE_MARKER)
    res = state_of(t)
    res.update(stats={k: v for k, v in t.stats.items() if k != "events"},
               events=t.stats["events"], error=error,
               fired=list(inj.fired) if inj is not None else [],
               marker=(json.load(open(marker)) if os.path.exists(marker)
                       else None))
    return res


ELASTIC_CFG = dict(vocab_size=64, max_seq_len=32, num_layers=2, num_heads=2,
                   d_model=32)


class ElasticTokens:
    """This rank's rows of 4 global batches of 8 x 16 tokens an epoch,
    drawn per epoch from a seeded order of 32 sequences through
    ``ShardedSampler(batch_contiguous=8)``."""

    def __init__(self, rank: int, world: int, vocab: int = 64):
        from tpudp_torch.data import ShardedSampler

        rng = np.random.default_rng(31)
        self.tokens = rng.integers(0, vocab, size=(32, 17)).astype(np.int64)
        self.sampler = ShardedSampler(32, world, rank, shuffle=True,
                                      seed=5, batch_contiguous=8)
        self.per = 8 // world
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        import torch

        idx = self.sampler.indices(self.epoch)
        for b in range(len(self)):
            rows = self.tokens[idx[b * self.per:(b + 1) * self.per]]
            yield (torch.as_tensor(rows[:, :-1]),
                   torch.as_tensor(rows[:, 1:]),
                   torch.ones(self.per, dtype=torch.float32))

    def __len__(self):
        return len(self.sampler) // self.per


def elastic_loader(strategy: str, rank: int, world: int):
    """dp's ranks read their rows; zero1's read the global batches (the
    rung takes its block)."""
    return (ElasticTokens(rank, world) if strategy == "dp"
            else ElasticTokens(0, 1))


def elastic_trainer(strategy: str):
    from tpudp_torch.mesh import make_mesh
    from tpudp_torch.models import gpt2
    from tpudp_torch.trainer import Trainer

    model = gpt2.GPT2(gpt2.GPT2Config(**ELASTIC_CFG))
    model.load_state_dict(gpt2.params_from_jax(
        strategy_tree(ELASTIC_CFG, STRATEGY_SEED)))
    kw = ({"strategy": "zero1", "strategy_options": {"min_size": MIN_SIZE}}
          if strategy == "zero1" else {})
    return Trainer(model, make_mesh(), learning_rate=0.01, log_every=2,
                   log_fn=lambda line: None, **kw)


def job_elastic_save(rank, world):
    """At ``world`` ranks, DP and zero1: 2 epochs uninterrupted with the
    losses recorded, the state after epoch 1 saved as ``step_1``."""
    from tpudp_torch.train import state_to_jax
    from tpudp_torch.utils.checkpoint import save_checkpoint

    out = {}
    for strategy in ("dp", "zero1"):
        root = os.path.join(os.environ["TPUDP_TEST_OUT"],
                            f"elastic-{strategy}")
        t = elastic_trainer(strategy)
        t.fit(elastic_loader(strategy, rank, world), epochs=2,
              epoch_end_fn=lambda e, t=t, root=root: save_checkpoint(
                  os.path.join(root, "step_1"), t.state) if e == 0 else None)
        out[strategy] = {
            "losses": [r["loss"] for r in t.records
                       if r["kind"] == "train_window"],
            "final": cpu_tree(state_to_jax(t.state)["params"])}
    save_case("elastic_save", rank, out)
    return {}


def job_elastic_resume(rank, world):
    """At ``world`` ranks: a fresh Trainer restores ``step_1`` written at
    another world size through ``restore_newest`` and trains epoch 2."""
    from tpudp_torch.resilience import restore_newest
    from tpudp_torch.train import state_to_jax

    out = {}
    for strategy in ("dp", "zero1"):
        root = os.path.join(os.environ["TPUDP_TEST_OUT"],
                            f"elastic-{strategy}")
        t = elastic_trainer(strategy)
        used, _ = restore_newest(t, root, log=lambda line: None)
        loader = elastic_loader(strategy, rank, world)
        start = t.state.step // len(loader)
        t.fit(loader, epochs=2, start_epoch=start)
        out[strategy] = {
            "used": os.path.basename(used), "start": start,
            "losses": [r["loss"] for r in t.records
                       if r["kind"] == "train_window"],
            "final": cpu_tree(state_to_jax(t.state)["params"])}
    save_case("elastic_resume", rank, out)
    return {}


def job_sdc(rank, world):
    """The SDC matrix at ``world`` ranks, each case saved as it ends: at
    4, clean, a one-shot params flip on rank 2, a one-shot momentum flip
    on rank 1 and, last (rank 1 exits 44), the persistent flip on rank
    1; at 2, the persistent flip (a two-rank tie) with 1 rollback."""
    import sys

    if world == 2:
        save_case("sdc-tie", rank, sdc_fit("tie", rank, world,
                                           max_rollbacks=1))
        return {}
    for case in SDC_CASES:
        save_case(f"sdc-{case}", rank, sdc_fit(case, rank, world))
    # rank 1 has exited: the others leave without a collective teardown
    sys.stdout.flush()
    os._exit(0)


def job_sdc_rungs(rank, world):
    """Every rung through the Trainer with ``track_grad_norm`` and
    ``track_sdc_fingerprint`` (and 1f1b_mpmd at data 2 x pipe 2): one
    epoch, then the slots and the rung's JAX-layout state."""
    from tpudp_torch.train import state_to_jax

    out = {}
    for name in SDC_RUNGS:
        trainer = trainer_rung(name, track_grad_norm=True,
                               track_sdc_fingerprint=True)
        cfg = SDC_RUNGS[name][1]
        trainer.fit(TokenLoader(cfg["vocab_size"]), epochs=1)
        st = trainer.state
        out[name] = {"obs_norms": st.obs_norms.tolist(),
                     "sdc_fp": st.sdc_fp.tolist(),
                     "tree": cpu_tree(state_to_jax(st))}
    out["pp-sdc"] = pp_sdc_fit(rank)
    save_case("sdc_rungs", rank, out)
    return {}


def pp_sdc_fit(rank: int) -> dict:
    """1f1b_mpmd at data 2 x pipe 2 under ``sdc_check_every=2`` with a
    one-shot flip on rank 2 (data 1, pipe 0): the pipe-summed
    fingerprints split 2-2, so the stage groups localize it.  Without
    ``shard_optimizer``, as each replica then updates its own stage
    whole (the sharded update re-gathers the parameters every step, so
    a flip never outlives it there, in JAX alike)."""
    from tpudp_torch.resilience import ResiliencePolicy
    from tpudp_torch.sdc import BitFlipParams

    root = os.path.join(os.environ["TPUDP_TEST_OUT"], "sdc-pp")
    t = trainer_rung("pp-mpmd", extra={"shard_optimizer": False},
                     track_sdc_fingerprint=True,
                     sdc_fault_hook=BitFlipParams([(3, 2, 5)]))
    t.fit(TokenLoader(SDC_RUNGS["pp-mpmd"][1]["vocab_size"]), epochs=2,
          resilience=ResiliencePolicy(checkpoint_dir=root,
                                      sdc_check_every=2))
    return {"stats": {k: v for k, v in t.stats.items() if k != "events"},
            "events": [{k: e.get(k) for k in ("kind", "replicas",
                                               "localized", "step")}
                       for e in t.stats["events"] if e["kind"] != "vote"],
            "fp": t.state.sdc_fp.tolist()}


# -- replica verification (tests/test_torch_consistency.py): a world of 2 --

def consistency_loader(rank: int, world: int, root: str):
    """16 synthetic images, one global batch of 16 an epoch."""
    from tpudp_torch.data import DataLoader, ShardedSampler, load_cifar10

    train_set, _, _ = load_cifar10(os.path.join(root, "no-data"),
                                   synthetic_train_size=16,
                                   synthetic_test_size=8)
    return DataLoader(train_set, 16 // world,
                      sampler=ShardedSampler(16, world, rank, seed=1,
                                             batch_contiguous=16),
                      train=True, seed=1, backend="numpy")


def job_consistency(rank, world):
    """``verify_replicas``, ``verify_across_processes`` and
    ``fingerprint`` on trees every rank holds alike or not, the Trainer's
    post-epoch check on the ``allreduce`` and ``none`` rungs, and the
    fingerprint coverage of a zero1 state."""
    import torch

    from tpudp_torch.mesh import make_mesh
    from tpudp_torch.trainer import Trainer
    from tpudp_torch.utils.consistency import (ReplicaDivergenceError,
                                               fingerprint,
                                               fingerprint_coverage,
                                               state_tree,
                                               verify_across_processes,
                                               verify_replicas)

    def outcome(fn):
        try:
            return ("ok", fn())
        except ReplicaDivergenceError as e:
            return ("raised", str(e))

    last = rank == world - 1
    same = {"w": torch.ones(4, 3), "scalar": 1.5, "b": torch.arange(5.0)}
    div = {"Conv_0": {"kernel": torch.ones(4, 3) * (1.001 if last else 1)}}
    rows = torch.arange(12.0).reshape(4, 3)
    permuted = {"Conv_0": {"kernel": rows.flip(0) if last else rows}}
    out = {"same": outcome(lambda: verify_replicas(same)),
           "div": outcome(lambda: verify_replicas(div)),
           "permuted": outcome(lambda: verify_replicas(permuted)),
           "div_atol": outcome(lambda: verify_replicas(div, atol=0.01)),
           "across_same": outcome(lambda: verify_across_processes(same)),
           "across_div": outcome(lambda: verify_across_processes(div)),
           "fp_same": fingerprint(same).tolist(),
           "fp_div": fingerprint(div).tolist()}
    root = os.environ["TPUDP_TEST_OUT"]
    for sync in ("allreduce", "none"):
        lines = []
        t = Trainer(bn_model("vgg"), make_mesh(), sync, learning_rate=0.1,
                    log_every=1, log_fn=lines.append, verify_replicas=True)
        res = outcome(lambda: t.fit(consistency_loader(rank, world, root),
                                    epochs=1))
        out[sync] = (res[0], res[1] if res[0] == "raised" else
                     [x for x in lines if "replica consistency" in x])
    z = elastic_trainer("zero1")
    z.fit(elastic_loader("zero1", rank, world), epochs=1)
    out["zero1_coverage"] = fingerprint_coverage(state_tree(z.state))
    out["zero1_verify"] = outcome(lambda: verify_replicas(
        {"params": dict(z.state.model.named_parameters())}))
    return out


JOBS = {"sync": job_sync, "steps": job_steps, "eval": job_eval,
        "gpt2": job_gpt2, "sync_bn": job_sync_bn, "ckpt": job_ckpt,
        "resilience": job_resilience, "lone_fault": job_lone_fault,
        "ring": job_ring, "sp": job_sp, "tp": job_tp, "fsdp": job_fsdp,
        "pp": job_pp, "ep": job_ep, "trainer": job_trainer,
        "schedule": job_schedule, "llama": job_llama,
        "cuda_strategies": job_cuda_strategies, "vit": job_vit,
        "vgg_tp": job_vgg_tp, "tp_cells": job_tp_cells,
        "disagg": job_disagg, "sdc": job_sdc,
        "sdc_rungs": job_sdc_rungs, "elastic_save": job_elastic_save,
        "elastic_resume": job_elastic_resume,
        "consistency": job_consistency}


def main(spec_path: str, rank: int) -> None:
    import torch
    import torch.distributed as dist

    from tpudp_torch.mesh import initialize_distributed

    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    world = spec["world"]
    os.environ["TPUDP_TEST_OUT"] = spec["out"]
    initialize_distributed("cpu", num_processes=world, process_id=rank,
                           init_method=spec["init"])
    try:
        results = {job: JOBS[job](rank, world) for job in spec["jobs"]}
        torch.save(results, os.path.join(spec["out"], f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def launch_world(tmp_dir, world: int, jobs, timeout: float = 240.0):
    """Run ``world`` ranks of this script on ``jobs``; returns each rank's
    exit code and output.  Fails (after killing the ranks) when a rank
    does not end within ``timeout``."""
    import subprocess

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
    return [p.returncode for p in procs], logs


def run_world(tmp_dir, world: int, jobs, timeout: float = 240.0) -> list:
    """Run ``world`` ranks of this script on ``jobs`` and return each
    rank's results; fails (after killing the ranks) on a timeout or a
    rank's nonzero exit."""
    import torch

    codes, logs = launch_world(tmp_dir, world, jobs, timeout)
    for r, (code, log) in enumerate(zip(codes, logs)):
        assert code == 0, f"rank {r} exited {code}:\n{log}"
    return [torch.load(os.path.join(tmp_dir, f"rank{r}.pt"))
            for r in range(world)]


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
