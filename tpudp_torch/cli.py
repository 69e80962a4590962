"""The CLI shared by the Part entry points — the port of ``tpudp/cli.py``.

The same flags as the JAX package's, with two changes:

  * ``--platform`` becomes ``--device {cuda,cpu}`` (default ``cuda``; no
    card and no ``--device cpu`` is an error, never a silent CPU run);
  * ``--num-devices N`` spawns N local ranks, one process each (NCCL
    needs one card a rank; gloo runs any number on the CPU), where JAX
    builds a mesh of N local devices.  Each rank loads its own shard of
    the data, as the reference's ``DistributedSampler`` ranks do.

``--master``/``--num-nodes``/``--rank`` join a multi-process run at the
reference's port 6585, one rank a process.  ``--data-backend`` picks
the loader's augment backend (``auto``: the native C++/OpenMP one when
it builds, as in JAX), ``--sync-bn`` builds the model with cross-rank
BatchNorm (the shard_map rungs of Parts 2a, 2b and 3), and
``--spmd-mode gspmd`` runs Part 3 with global-batch BatchNorm.

``--checkpoint-dir`` resumes from the newest verified ``step_N`` there
(an emergency dump preferred, and consumed unless ``--eval-only``) and
saves ``step_<epoch+1>`` after every epoch, in the background with
``--checkpoint-async``, pruned to ``--keep-checkpoints``;
``--eval-only`` restores and evaluates; ``--step-timeout`` arms the
heartbeat watchdog (a hang dumps the state and exits, or under
``--resilience`` is recovered in-process by the supervisor with
``--max-rollbacks`` and ``--spike-factor``); ``--remat`` recomputes
the forward in the backward (``Trainer(remat=True)``);
``--flight-dir`` turns on the flight recorder, ``--metrics-port`` serves
``Trainer.metrics()`` as Prometheus text, and ``--profile-dir`` writes a
``torch.profiler`` Chrome trace of the run (JAX writes an XLA profile);
``--verify-replicas`` checks after each epoch that every rank holds
bit-identical parameters and statistics (``Trainer(verify_replicas=
True)``).
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import sys
import threading
import time

import torch
import torch.distributed as dist

from tpudp_torch.data import (DataLoader, Prefetcher, ShardedSampler,
                              load_cifar10)
from tpudp_torch.mesh import (PORT, free_port, initialize_distributed,
                              make_mesh)
from tpudp_torch.models import vgg
from tpudp_torch.models.norm import DATA_AXIS
from tpudp_torch.obs import trace
from tpudp_torch.resilience import (auto_resume, make_emergency_dump,
                                    restore_newest)
from tpudp_torch.trainer import Trainer
from tpudp_torch.utils.checkpoint import (AsyncCheckpointWriter,
                                          prune_step_dirs, rank,
                                          read_emergency_sentinel,
                                          save_checkpoint)
from tpudp_torch.utils.watchdog import Watchdog

GLOBAL_BATCH_SIZE = 256  # the reference's constant, src/Part 2a/main.py:173

def build_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--master", type=str, default=None,
                   help="coordinator IP for multi-process runs (reference "
                        "--master)")
    p.add_argument("--num-nodes", type=int, default=None,
                   help="number of processes (reference --num-nodes)")
    p.add_argument("--rank", type=int, default=None,
                   help="this process's rank (reference --rank)")
    p.add_argument("--epochs", type=int, default=1,
                   help="epochs to train (reference default 1)")
    p.add_argument("--num-devices", type=int, default=None,
                   help="spawn N local ranks, one process each (default 1)")
    p.add_argument("--batch-size", type=int, default=GLOBAL_BATCH_SIZE,
                   help="GLOBAL batch size (split across ranks)")
    p.add_argument("--data-root", type=str, default="./data")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--timing-mode", choices=["fused", "split"],
                   default="fused")
    p.add_argument("--dtype", choices=["float32", "bfloat16"],
                   default="float32")
    p.add_argument("--model", choices=["vgg11", "vgg13", "vgg16", "vgg19"],
                   default="vgg11", help="VGG variant (reference: VGG-11)")
    p.add_argument("--checkpoint-dir", type=str, default=None)
    p.add_argument("--checkpoint-async", action="store_true")
    p.add_argument("--keep-checkpoints", type=int, default=None,
                   metavar="N")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the ranks run (default cuda: the card; "
                        "on cpu, local ranks split the host's cores "
                        "unless OMP_NUM_THREADS sets each rank's "
                        "threads)")
    p.add_argument("--synthetic-train-size", type=int, default=50_000,
                   help="synthetic-fallback train set size (smoke runs)")
    p.add_argument("--synthetic-test-size", type=int, default=10_000)
    p.add_argument("--data-backend", choices=["auto", "native", "numpy"],
                   default="auto",
                   help="host augmentation backend ('auto': native "
                        "C++/OpenMP when it builds, else numpy)")
    p.add_argument("--eval-only", action="store_true")
    p.add_argument("--sync-bn", action="store_true",
                   help="cross-rank BatchNorm statistics (shard_map rungs "
                        "only)")
    p.add_argument("--spmd-mode", choices=["shard_map", "gspmd"],
                   default=None,
                   help="Part 3 (auto rung) only; 'shard_map' (default) is "
                        "DistributedDataParallel with each rank's own "
                        "BatchNorm statistics, 'gspmd' the same with "
                        "BatchNorm over the global batch (SyncBN "
                        "semantics, as JAX's partitioned program)")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="split each rank's batch into N sequential "
                        "microbatches before the one sync and update")
    p.add_argument("--prefetch", type=int, default=2,
                   help="batches prepared ahead on a background thread, "
                        "copied to the device there; 0 disables")
    p.add_argument("--verify-replicas", action="store_true",
                   help="after each epoch, assert every replicated "
                        "param/BN-stat is bit-identical across ranks "
                        "(torch DDP's parameter-verification analogue; "
                        "catches silent DP desync — "
                        "tpudp_torch/utils/consistency.py)")
    p.add_argument("--metrics-jsonl", type=str, default=None,
                   metavar="PATH",
                   help="append one JSON line per train window / eval / "
                        "epoch to PATH (rank 0 only)")
    p.add_argument("--profile-dir", type=str, default=None,
                   help="write a torch.profiler Chrome trace of the run "
                        "into this directory (trace-<pid>.json)")
    p.add_argument("--step-timeout", type=float, default=None)
    p.add_argument("--resilience", action="store_true")
    p.add_argument("--max-rollbacks", type=int, default=None, metavar="N")
    p.add_argument("--spike-factor", type=float, default=None, metavar="X")
    p.add_argument("--flight-dir", type=str, default=None, metavar="DIR",
                   help="dump the flight recorder (the last train/eval "
                        "spans and recovery events) into flightrec-*.json "
                        "under DIR on watchdog timeouts and recoveries "
                        "(default: the TPUDP_FLIGHT_DIR variable; unset = "
                        "no dumps)")
    p.add_argument("--metrics-port", type=int, default=None, metavar="N",
                   help="serve the live Trainer.metrics() as Prometheus "
                        "text on 127.0.0.1:N/metrics (rank 0; 0 picks a "
                        "free port)")
    return p


def _check_checkpoint_flags(args) -> None:
    """The JAX CLI's validation of the checkpoint and supervisor flags
    (``tpudp/cli.py``), decided from the flags alone."""
    if args.checkpoint_async and not args.checkpoint_dir:
        raise SystemExit(
            "error: --checkpoint-async requires --checkpoint-dir (nothing "
            "would be checkpointed otherwise)")
    if args.keep_checkpoints is not None and args.keep_checkpoints < 1:
        raise SystemExit(f"error: --keep-checkpoints must be >= 1 "
                         f"(got {args.keep_checkpoints})")
    if args.keep_checkpoints and not args.checkpoint_dir:
        raise SystemExit("error: --keep-checkpoints requires "
                         "--checkpoint-dir")
    if args.eval_only and not args.checkpoint_dir:
        raise SystemExit(
            "error: --eval-only requires --checkpoint-dir (there is no "
            "model to evaluate otherwise)")
    if args.resilience and not args.checkpoint_dir:
        raise SystemExit(
            "error: --resilience requires --checkpoint-dir (rollback and "
            "step recovery restore from the step_N series under it)")
    if (args.max_rollbacks is not None or args.spike_factor is not None) \
            and not args.resilience:
        raise SystemExit(
            "error: --max-rollbacks/--spike-factor configure the "
            "--resilience supervisor; pass --resilience too")
    if args.max_rollbacks is not None and args.max_rollbacks < 0:
        raise SystemExit(f"error: --max-rollbacks must be >= 0 "
                         f"(got {args.max_rollbacks})")
    if args.spike_factor is not None and args.spike_factor <= 1.0:
        raise SystemExit(
            f"error: --spike-factor must be > 1.0 (got {args.spike_factor}) "
            "— a window loss always 'exceeds' a sub-unit multiple of the "
            "median and every window would roll back")
    if args.step_timeout is not None and args.step_timeout <= 0:
        raise SystemExit(f"error: --step-timeout must be > 0 "
                         f"(got {args.step_timeout})")


def run_part(sync: str, description: str, *, single_device: bool = False,
             argv=None) -> Trainer | None:
    """Parse flags, join or spawn the ranks, build data, model and
    Trainer, and fit.  Returns this process's Trainer, or None where it
    spawned local ranks (they print; the call returns when all exit)."""
    args = build_parser(description).parse_args(argv)
    _check_checkpoint_flags(args)
    if args.spmd_mode is not None and sync != "auto":
        raise SystemExit(
            "error: --spmd-mode applies only to the Part 3 'auto' rung "
            "(the other Parts' sync strategies are explicit collectives "
            "by definition)")
    if args.sync_bn and (single_device or args.spmd_mode == "gspmd"):
        raise SystemExit(
            "error: --sync-bn needs a shard_map rung (Parts 2a/2b/3) — there "
            "are no ranks to share statistics in single-device mode, and "
            "gspmd already takes them over the global batch")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "error: no CUDA card is available; the Parts run on the card "
            "by default — pass --device cpu to run on the CPU")
    local = args.num_devices or 1
    multi_node = args.master is not None or (args.num_nodes or 1) > 1
    if local < 1:
        raise SystemExit(f"error: --num-devices must be >= 1 (got {local})")
    if multi_node and local > 1:
        raise SystemExit("error: --num-devices spawns local ranks; with "
                         "--master/--num-nodes each process is one rank")
    if (args.resilience and not args.step_timeout and not single_device
            and (local > 1 or multi_node)):
        raise SystemExit(
            "error: --resilience at more than one rank needs --step-timeout "
            "— a rank left inside a collective by a fault only its peer saw "
            "never reaches the recovery vote, and only the watchdog's hard "
            "exit ends it")
    if single_device:
        return _run_rank(args, sync, False, 0, 1, None)
    if multi_node:
        if args.master is None or args.num_nodes is None or args.rank is None:
            raise SystemExit("error: a multi-process run needs --master, "
                             "--num-nodes and --rank")
        return _run_rank(args, sync, True, args.rank, args.num_nodes,
                         f"tcp://{args.master}:{PORT}")
    if local == 1 or dist.is_initialized():
        world = dist.get_world_size() if dist.is_initialized() else 1
        rank = dist.get_rank() if dist.is_initialized() else 0
        return _run_rank(args, sync, True, rank, world, None)
    if args.device == "cuda" and local > torch.cuda.device_count():
        raise SystemExit(
            f"error: --num-devices {local} needs {local} cards (NCCL takes "
            f"one card a rank; this machine has "
            f"{torch.cuda.device_count()}) — pass --device cpu for gloo "
            "ranks on the CPU")
    _spawn(args, sync, local)
    return None


def _spawn(args, sync: str, world: int) -> None:
    """Run ``world`` local ranks of a Part as processes."""
    spawn_ranks(_rank_entry, world, args, sync)


def spawn_ranks(entry, world: int, *head) -> None:
    """Run ``entry(*head, rank, world, init_method)`` in ``world`` local
    processes meeting at a free localhost port; a rank that fails stops
    the others and fails the run."""
    init_method = f"tcp://127.0.0.1:{free_port()}"
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=entry,
                         args=(*head, rank, world, init_method),
                         name=f"tpudp-rank{rank}")
             for rank in range(world)]
    for p in procs:
        p.start()
    failed = None
    try:
        while any(p.is_alive() for p in procs) and failed is None:
            for p in procs:
                p.join(timeout=0.2)
                if p.exitcode not in (None, 0):
                    failed = p
                    break
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join()
    failed = failed or next((p for p in procs if p.exitcode), None)
    if failed is not None:
        raise SystemExit(f"error: {failed.name} failed (exit code "
                         f"{failed.exitcode})")


def _rank_entry(args, sync, rank, world, init_method) -> None:
    """A spawned rank: train, then leave the process group."""
    try:
        _run_rank(args, sync, True, rank, world, init_method)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def make_loaders(args, rank: int, world: int, log=print) -> tuple:
    """This rank's train and test loaders for the parsed ``args``: its
    shard of the data (CIFAR-10 from ``--data-root``, else the synthetic
    stand-in), at the global batch over ``world``, on the
    ``--data-backend``, behind a Prefetcher unless ``--prefetch 0``."""
    if args.batch_size % world:
        raise SystemExit(
            f"error: --batch-size {args.batch_size} must be divisible by the "
            f"rank count ({world}) — every rank takes an equal shard")
    train_set, test_set, synthetic = load_cifar10(
        args.data_root, synthetic_train_size=args.synthetic_train_size,
        synthetic_test_size=args.synthetic_test_size)
    if synthetic:
        log("[tpudp] CIFAR-10 not found on disk; using synthetic stand-in "
            "data")
    log(f"[tpudp] train samples={len(train_set.images)} "
        f"test samples={len(test_set.images)}")
    batch = args.batch_size // world
    train_loader = DataLoader(
        train_set, batch,
        sampler=ShardedSampler(len(train_set.images), world, rank,
                               shuffle=True, seed=args.seed),
        train=True, seed=args.seed, backend=args.data_backend)
    test_loader = DataLoader(
        test_set, batch,
        sampler=ShardedSampler(len(test_set.images), world, rank,
                               shuffle=False),
        train=False, backend=args.data_backend)
    if args.prefetch > 0:
        train_loader = Prefetcher(train_loader, depth=args.prefetch)
        test_loader = Prefetcher(test_loader, depth=args.prefetch)
    return train_loader, test_loader


def _run_rank(args, sync: str, data_parallel: bool, rank: int, world: int,
              init_method: str | None) -> Trainer:
    """One rank's run: with ``data_parallel`` (every Part but Part 1) it
    joins the process group through ``init_method`` and trains over it."""
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    elif world > 1 and not os.environ.get("OMP_NUM_THREADS"):
        # The host's cores split between the local ranks, unless the
        # caller set the threads a process.
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    mesh = None
    if data_parallel:
        initialize_distributed(device, world, rank, init_method=init_method)
        mesh = make_mesh()
    log = print if rank == 0 else (lambda line: None)
    train_loader, test_loader = make_loaders(args, rank, world, log)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    model = vgg.build(vgg.CONFIGS[args.model.upper()], args.seed, device,
                      dtype=dtype,
                      bn_axis=DATA_AXIS if args.sync_bn else None)
    watchdog = None
    if args.step_timeout:
        # Under --resilience the watchdog must not kill: the hang surfaces
        # as StepHangError at the next beat and the supervisor recovers.
        outcome = ("recovering in-process" if args.resilience
                   else "exiting for scheduler restart")
        watchdog = Watchdog(
            timeout_s=args.step_timeout, kill=not args.resilience,
            on_hang=[lambda: print(
                f"[tpudp] FAILURE DETECTED: step exceeded "
                f"{args.step_timeout}s (wedged collective or dead peer); "
                f"{outcome}", flush=True)]).start()
    trainer = Trainer(model, mesh, sync, timing_mode=args.timing_mode,
                      spmd_mode=args.spmd_mode or "shard_map",
                      grad_accum=args.grad_accum, remat=args.remat,
                      metrics_jsonl=args.metrics_jsonl, log_fn=log,
                      watchdog=watchdog, flight_dir=args.flight_dir,
                      verify_replicas=args.verify_replicas)
    metrics_server = None
    if args.metrics_port is not None and rank == 0:
        from tpudp_torch.obs import MetricsServer

        metrics_server = MetricsServer(args.metrics_port, trainer.metrics)
        log(f"[tpudp] metrics endpoint: "
            f"http://127.0.0.1:{metrics_server.port}/metrics")
    log(f"[tpudp] model={args.model} sync={sync} devices={world} "
        f"device={device.type} global_batch={args.batch_size} "
        f"dtype={args.dtype} "
        f"data={getattr(train_loader, 'loader', train_loader).banner()}"
        f"+prefetch{args.prefetch}")
    async_writer = None
    try:
        resume = _Resume(args, trainer, train_loader, watchdog, log)
        async_writer = resume.async_writer
        if args.eval_only:
            if watchdog is not None:
                watchdog.arm()
            try:
                with trace(args.profile_dir):
                    trainer.evaluate(test_loader)
            finally:
                if watchdog is not None:
                    watchdog.disarm()
            return trainer
        resilience = None
        if args.resilience:
            from tpudp_torch.resilience import ResiliencePolicy

            resilience = ResiliencePolicy(
                checkpoint_dir=args.checkpoint_dir,
                spike_factor=args.spike_factor,
                # the epoch-end hook already saves step_{epoch+1}
                save_epoch_checkpoints=False,
                checkpoint_writer=async_writer,
                **({"max_rollbacks": args.max_rollbacks}
                   if args.max_rollbacks is not None else {}))
        with trace(args.profile_dir):
            trainer.fit(train_loader, test_loader, epochs=args.epochs,
                        start_epoch=resume.start_epoch,
                        epoch_end_fn=resume.epoch_end_fn,
                        skip_batches_first_epoch=resume.skip_first,
                        resilience=resilience)
        if args.profile_dir:
            log(f"[tpudp] profiler trace written to {args.profile_dir}")
        if async_writer is not None:
            async_writer = None
            resume.finish()  # join the last epoch's write, then prune
        if resilience is not None:
            st = trainer.stats
            log(f"[tpudp] resilience summary: {st.get('rollbacks', 0)} "
                f"rollbacks, {st.get('step_retries', 0)} step retries, "
                f"{st.get('ckpt_fallbacks', 0)} checkpoint fallbacks, "
                f"{st.get('loader_restarts', 0)} loader restarts")
    finally:
        if async_writer is not None:
            async_writer.close()
        if watchdog is not None:
            watchdog.stop()
        if metrics_server is not None:
            metrics_server.close()
        for loader in (train_loader, test_loader):
            if isinstance(loader, Prefetcher):
                loader.close()
        sys.stdout.flush()
    return trainer


class _Resume:
    """The resume block of ``tpudp/cli.py`` for one rank: after the
    emergency dump's batch-grid check, :func:`auto_resume` restores the
    newest verified ``step_N`` under ``--checkpoint-dir`` or, in
    preference, the dump, consumed and mapped onto the batch grid by its
    step counter (``--eval-only`` restores alike and leaves the dump in
    place); then it builds the
    epoch-end save (synchronous or ``--checkpoint-async``, pruned to
    ``--keep-checkpoints``) and hook the emergency dump (or, under
    ``--resilience``, a hard-exit backstop) onto the watchdog.  Leaves
    ``start_epoch``, ``skip_first``, ``epoch_end_fn`` and
    ``async_writer`` for the caller."""

    def __init__(self, args, trainer: Trainer, train_loader, watchdog, log):
        self.start_epoch = 0
        self.skip_first = 0
        self.epoch_end_fn = None
        self.async_writer = None
        root = args.checkpoint_dir
        if not root:
            return
        per_epoch = len(train_loader)
        if args.eval_only:
            used, from_dump = restore_newest(trainer, root, log=log)
            if used is None:
                raise SystemExit(
                    f"error: --eval-only found no checkpoint under "
                    f"{root!r} — evaluating random weights would report "
                    "meaningless metrics")
            if from_dump:
                log(f"[tpudp] evaluating emergency dump {used} (left in "
                    "place for the next training resume)")
            return
        dumped = (read_emergency_sentinel(root) or {}).get(
            "per_epoch_batches")
        if (dumped is not None and dumped != per_epoch
                and os.path.isdir(os.path.join(root, "emergency"))):
            # tpudp: lint-ok(protocol-early-exit): every host reads
            # the SAME sentinel file and computes the same loader
            # length from the same dataset/--batch-size, so a
            # batch-grid mismatch aborts the whole pod together —
            # no peer proceeds to the voted restore alone.
            raise SystemExit(
                f"error: emergency dump at {os.path.join(root, 'emergency')}"
                f" was written with {dumped} batches/epoch but this "
                f"relaunch has {per_epoch} (different --batch-size or "
                "train-set size) — the dump's step counter cannot be "
                "mapped to a resume position on this batch grid. "
                "Relaunch with the original configuration, or remove "
                "the dump directory to restart the epoch from the last "
                "step_N checkpoint.")
        self.start_epoch, self.skip_first = auto_resume(trainer, root,
                                                        per_epoch, log=log)
        if self.start_epoch or self.skip_first:
            log(f"[tpudp] resuming at epoch {self.start_epoch}"
                + (f": fast-forwarding {self.skip_first}/{per_epoch} "
                   "already-trained batches" if self.skip_first else ""))
        if args.checkpoint_async:
            # Before the dump hook: the dump drains this writer first.
            self.async_writer = AsyncCheckpointWriter()
        if watchdog is not None and not args.resilience:
            save = make_emergency_dump(
                root, lambda: trainer.state, per_epoch,
                async_writer=self.async_writer,
                log=lambda line: print(line, flush=True))

            def emergency_dump() -> None:
                # Bounded: on a wedged device the copy itself can hang,
                # and the dump must never stop the watchdog's exit.
                th = threading.Thread(target=save, daemon=True)
                th.start()
                th.join(timeout=60.0)

            watchdog.on_hang.append(emergency_dump)
        if watchdog is not None and args.resilience:
            watchdog.on_hang.append(_hard_exit_backstop(watchdog,
                                                        args.step_timeout))
        writer = self.async_writer

        def epoch_end_fn(epoch: int) -> None:
            path = os.path.join(root, f"step_{epoch + 1}")
            if writer is not None:
                writer.save(path, trainer.state)
                log(f"[tpudp] checkpoint {path} writing in background")
            else:
                save_checkpoint(path, trainer.state)
                log(f"[tpudp] saved checkpoint {path}")
            self._prune()

        self.epoch_end_fn = epoch_end_fn
        self._root, self._keep, self._log = root, args.keep_checkpoints, log

    def _prune(self) -> None:
        """Rank 0 keeps the newest ``--keep-checkpoints``; the previous
        step's write is durable by now (a sync save, or the writer's
        one-in-flight rule)."""
        if self._keep and rank() == 0:
            for gone in prune_step_dirs(self._root, self._keep):
                self._log(f"[tpudp] pruned old checkpoint {gone}")

    def finish(self) -> None:
        """Join the last background write, then prune once more: an
        in-flight write is not yet part of the series it prunes."""
        if self.async_writer is not None:
            self.async_writer.close()
            self._prune()


def _hard_exit_backstop(watchdog, step_timeout: float):
    """The ``on_hang`` callback of a ``--resilience`` run: ``kill=False``
    recovery only works for stalls that return to a beat, so if the
    supervisor has not re-armed the watchdog within a grace period (a
    wedged collective never returns) the process exits for the
    scheduler.  Each hang has its own generation, so a stale backstop
    never fires during a later hang's recovery."""
    generation = [0]

    def backstop() -> None:
        generation[0] += 1
        mine = generation[0]

        def wait_then_exit() -> None:
            time.sleep(max(step_timeout, 60.0))
            if watchdog._hang_seen.is_set() and generation[0] == mine:
                print("[tpudp] hang NOT recovered in-process (wedged "
                      "collective?); exiting for scheduler restart",
                      flush=True)
                os._exit(42)

        threading.Thread(target=wait_then_exit, daemon=True).start()

    return backstop
