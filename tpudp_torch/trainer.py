"""The epoch loop — the port of ``tpudp/train.py``'s ``Trainer``.

It reproduces the reference's printed metrics and cadence
(``src/Part 2a/main.py:19-145``): the mean training loss every
``log_every`` iterations, the average pass time with the first window
left out, the epoch's wall time, and the test-set summary.

``timing_mode='fused'`` times whole steps: the host queues steps back to
back and synchronizes with the device once a log window, when it reads
the device-resident ``loss_sum``.  ``'split'`` times the training-mode
forward alone before each step (``make_forward_step``) and reports the
rest as the backward, as the JAX Trainer does.

The port's Trainer takes a model already built (the JAX one initializes
its own from ``seed`` and ``input_shape``).  The data-parallel rung
(``strategy='dp'``, ``spmd_mode='shard_map'`` or ``'gspmd'``) and the
sharded rungs (``strategy='tp'``, ``'fsdp'``, ``'zero1'``, ``'pp'``,
``'ep'``, ``'sp'`` with ``strategy_options``, built by
``tpudp_torch.strategy.build_strategy`` over a
``tpudp_torch.mesh.make_mesh_nd`` mesh) are ported, with checkpoint
resume (``fit(start_epoch=, epoch_end_fn=,
skip_batches_first_epoch=)``), the heartbeat ``watchdog``, the
``step_fault_hook`` fault seam, the in-process supervisor
(``fit(resilience=)``, ``tpudp_torch.resilience``), ``remat`` and
``loss_chunk`` (``tpudp_torch.train.make_train_step``), and JAX's
telemetry: spans and counters in :attr:`Trainer.obs`
(``train.window``, ``train.data``, ``train.dispatch``,
``train.fetch_fence``, ``eval``, ``eval.dispatch``, ``eval.fetch``,
``train.epoch``), the flight recorder (``flight_dir``, dumped by the
watchdog and the supervisor) and ``track_grad_norm`` beside every rung,
and JAX's robustness options: ``verify_replicas`` (the replicas compared
across ranks after each epoch, ``tpudp_torch.utils.consistency``),
``track_sdc_fingerprint`` (the in-step ``sdc_fp`` the supervisor's
``sdc_check_every`` reads) and ``sdc_fault_hook`` (``state =
hook(state)`` after each train step: the ``tpudp_torch.sdc`` bit-flip
injectors).

Under a sharded rung every rank's loaders yield the *global* batches,
as JAX's single program reads them, and the rung's ``shard_for`` takes
this rank's block of each.
"""

from __future__ import annotations

import json
import time
from typing import Callable

import numpy as np
import torch

from tpudp_torch.data.prefetch import device_place
from tpudp_torch.mesh import Mesh
from tpudp_torch.obs import FlightRecorder, Recorder, reference_window_lines
from tpudp_torch.train import (init_state, make_eval_step, make_forward_step,
                               make_optimizer, make_train_step)
from tpudp_torch.utils.finite import check_finite

def _refuse_with_strategy(strategy: str, **options) -> None:
    """JAX's refusals beside a sharded rung (``tpudp/train.py``'s
    Trainer): the DP rung's options raise ``ValueError``."""
    if options["compress"] is not None:
        raise ValueError(
            "compress needs the shard_map DP rung with a mesh "
            f"(strategy={strategy!r}, spmd_mode={options['spmd_mode']!r})")
    if options["timing_mode"] == "split":
        raise ValueError(
            "timing_mode='split' reproduces the reference's DP fwd/bwd "
            "split; advanced strategies time fused steps")
    if options["grad_accum"] != 1:
        raise ValueError(
            f"grad_accum is a DP-rung option (strategy={strategy!r})")
    if options["remat"]:
        raise ValueError(
            f"remat is a DP-rung option (strategy={strategy!r}); for pp "
            "pass strategy_options={'remat': True}")
    if options["loss_chunk"]:
        raise ValueError(
            f"loss_chunk is a DP-rung option (strategy={strategy!r})")
    if options["sync"] != "allreduce" or options["spmd_mode"] != "shard_map":
        raise ValueError(
            f"sync={options['sync']!r}/spmd_mode={options['spmd_mode']!r} "
            f"are DP-rung options; strategy={strategy!r} defines its own "
            "collectives")


def fence(device: torch.device) -> None:
    """Wait for the work queued on ``device`` (a no-op on the CPU, whose
    operations finish before they return)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Trainer:
    """Epoch loop with the reference's printed metrics and cadence.

    ``model`` is a built module on its device (a ``tpudp_torch`` VGG or
    GPT-2); ``mesh`` (:func:`tpudp_torch.mesh.make_mesh`) makes the step
    data-parallel over its ranks with the ``sync`` rung, each rank
    feeding its own shard.  Every train window, eval and epoch appends a
    record to :attr:`records` (and, on rank 0, one JSON line to
    ``metrics_jsonl``); a window record carries ``samples_per_sec``
    (this rank's samples over the window's wall time) and
    ``warmup_window`` (the first window of an epoch, which holds the
    warm-up).

    ``flight_dir`` (default: ``TPUDP_FLIGHT_DIR``, else none) is where
    :attr:`flight` dumps the span ring on a watchdog timeout or a
    supervised recovery; ``track_grad_norm`` (every rung JAX updates it on:
dp, tp, fsdp, zero1 and sp) accumulates
    the gradient norm on the device for :meth:`metrics`."""

    def __init__(self, model: torch.nn.Module, mesh: Mesh | None = None,
                 sync: str = "allreduce", *, strategy: str = "dp",
                 strategy_options: dict | None = None,
                 learning_rate: float = 0.1,
                 momentum: float = 0.9, weight_decay: float = 1e-4,
                 spmd_mode: str = "shard_map", timing_mode: str = "fused",
                 log_every: int = 20,
                 log_fn: Callable[[str], None] = print, grad_accum: int = 1,
                 remat: bool = False, loss_chunk: int | None = None,
                 metrics_jsonl: str | None = None,
                 compress: str | None = None, watchdog=None,
                 step_fault_hook: Callable[[str, int], None] | None = None,
                 track_grad_norm: bool = False,
                 verify_replicas: bool = False,
                 track_sdc_fingerprint: bool = False,
                 sdc_fault_hook: Callable | None = None,
                 flight_dir: str | None = None):
        if strategy != "dp":
            _refuse_with_strategy(strategy, sync=sync, spmd_mode=spmd_mode,
                                  timing_mode=timing_mode,
                                  grad_accum=grad_accum, compress=compress,
                                  remat=remat, loss_chunk=loss_chunk)
        if timing_mode not in ("fused", "split"):
            raise ValueError(f"unknown timing_mode {timing_mode!r}")
        if loss_chunk and timing_mode == "split":
            # The split-mode forward is the dense one, logits and all.
            raise ValueError(
                "loss_chunk is incompatible with timing_mode='split' (the "
                "separately-timed forward materializes the full logits)")
        if compress is not None:
            if mesh is None or spmd_mode != "shard_map":
                raise ValueError(
                    "compress needs the shard_map DP rung with a mesh "
                    f"(strategy='dp', spmd_mode={spmd_mode!r})")
            if sync != "none":
                raise ValueError(
                    f"compress={compress!r} replaces the sync collective; "
                    f"pass sync='none' (got sync={sync!r})")
        self.model = model
        self.mesh = mesh
        self.sync = sync
        self.device = next(model.parameters()).device
        self.timing_mode = timing_mode
        self.log_every = log_every
        self.log = log_fn
        self.records: list[dict] = []
        # tpudp_torch.utils.watchdog.Watchdog or None: every train and
        # eval iteration beats it.
        self.watchdog = watchdog
        # Telemetry: window and step spans on a bounded ring, and the
        # flight recorder the watchdog and the supervisor dump.
        self.obs = Recorder(name="train")
        self.flight = FlightRecorder(self.obs, flight_dir,
                                     component="train")
        if watchdog is not None and getattr(watchdog, "flight",
                                            None) is None:
            watchdog.flight = self.flight
        self.track_grad_norm = track_grad_norm
        # The SDC injection seam (tpudp_torch.sdc.BitFlipParams and
        # BitFlipGrads): state = hook(state) after each train step.
        self.sdc_fault_hook = sdc_fault_hook
        self.track_sdc_fingerprint = track_sdc_fingerprint
        # The post-epoch desync check (tpudp_torch.utils.consistency).
        self.verify_replicas = verify_replicas
        # Fault seam (tpudp_torch.training_faults): hook(kind, index)
        # right before each device step; a retried step gets a new index.
        self.step_fault_hook = step_fault_hook
        self._device_calls = 0
        # Recovery counters and events, filled only under fit(resilience=).
        self.stats: dict = {}
        # The active fit's Supervisor, or None: it observes the window
        # losses and guards the batch iterator.
        self._resilience = None
        self.metrics_jsonl = (metrics_jsonl if mesh is None or mesh.rank == 0
                              else None)
        self._last_window_loss: float | None = None
        self.strategy = strategy
        self.optimizer = make_optimizer(learning_rate, momentum, weight_decay,
                                        compress=compress)
        self._shard_for = None
        if strategy == "dp":
            self.state = init_state(model, self.optimizer, mesh,
                                    track_grad_norm=track_grad_norm,
                                    track_sdc=track_sdc_fingerprint)
            self.train_step = make_train_step(model, self.optimizer, mesh,
                                              sync, spmd_mode=spmd_mode,
                                              grad_accum=grad_accum,
                                              remat=remat,
                                              loss_chunk=loss_chunk)
            self.fwd_step = (make_forward_step(model, mesh)
                             if timing_mode == "split" else None)
            self.eval_step = make_eval_step(model, mesh, loss_chunk)
        else:
            from tpudp_torch.strategy import build_strategy

            built = build_strategy(
                strategy, model, self.optimizer, mesh,
                init_state(model, self.optimizer,
                           track_grad_norm=track_grad_norm,
                           track_sdc=track_sdc_fingerprint),
                **(strategy_options or {}))
            self.state = built.state
            self.train_step, self.eval_step = (built.train_step,
                                               built.eval_step)
            self.fwd_step = None
            self._shard_for = built.shard_for
        self._place = device_place(self.device)

    def _device_batch(self, batch) -> tuple:
        """The batch's arrays as tensors on the trainer's device (batches
        a Prefetcher already placed pass through); under a sharded rung,
        this rank's block of each."""
        if all(isinstance(a, torch.Tensor) and a.device == self.device
               for a in batch):
            batch = tuple(batch)
        else:
            batch = self._place(batch)
        if self._shard_for is not None:
            batch = tuple(self._shard_for(a) for a in batch)
        return batch

    def _install_place_hook(self, loader) -> None:
        """Have a loader that takes one (a Prefetcher) copy its batches
        to the device on its own thread, ahead of the steps."""
        if hasattr(loader, "set_place"):
            loader.set_place(self._place)

    def _emit_metrics(self, record: dict) -> None:
        if "loss" in record:
            self._last_window_loss = record["loss"]
        self.records.append(record)
        if self.metrics_jsonl is not None:
            with open(self.metrics_jsonl, "a") as f:
                f.write(json.dumps(record) + "\n")

    def metrics(self) -> dict:
        """JAX's snapshot: optimizer step, cumulative training loss and
        its mean per step, the span rollup and host counters of
        :attr:`obs`, the flight dumps written, the supervisor's numeric
        counters, the last window's loss and, with ``track_grad_norm``,
        the gradient norm's mean and root mean square over the steps
        (this reads the device)."""
        state = self.state
        step = state.step
        loss_sum = float(state.loss_sum)
        out = {"step": step, "loss_sum": loss_sum,
               "loss_mean": loss_sum / max(step, 1),
               "spans": self.obs.summary(),
               "counters": dict(self.obs.counters),
               "flight_dumps": self.flight.dumps,
               "resilience": {k: v for k, v in self.stats.items()
                              if isinstance(v, (int, float))}}
        if self._last_window_loss is not None:
            out["last_window_loss"] = self._last_window_loss
        if state.obs_norms is not None:
            s, s2 = state.obs_norms.tolist()
            out["grad_norm_mean"] = s / max(step, 1)
            out["grad_norm_rms"] = float(np.sqrt(max(s2 / max(step, 1),
                                                     0.0)))
        return out

    def _beat(self) -> None:
        if self.watchdog is not None:
            self.watchdog.beat()

    def _fault_hook(self, kind: str) -> None:
        if self.step_fault_hook is not None:
            self._device_calls += 1
            self.step_fault_hook(kind, self._device_calls)

    def _window_done(self, loss: float, epoch: int, it: int) -> None:
        if self._resilience is not None:
            self._resilience.observe_window_loss(loss, epoch=epoch, it=it)
            # The fingerprint check rides the same window edge (a no-op
            # unless the policy's sdc_check_every is due).
            self._resilience.observe_window_state(self.state, epoch=epoch,
                                                  it=it)

    def train_epoch(self, loader, epoch: int = 0, *,
                    skip_batches: int = 0) -> float:
        """One epoch; returns its mean window loss and prints the
        reference's lines.  ``skip_batches`` fast-forwards a mid-epoch
        resume: the epoch's first K batches are drawn from the loader and
        discarded, so every host RNG ends where an uninterrupted run's
        would, and training goes on with the batches that run had not
        consumed."""
        loader.set_epoch(epoch)
        self._install_place_hook(loader)
        fwd_t = bwd_t = 0.0
        losses = []
        # tpudp: lint-ok(host-sync): the epoch's starting sum, read once
        prev_loss_sum = float(self.state.loss_sum)
        split = self.timing_mode == "split"
        batches = iter(loader)
        if self._resilience is not None:
            batches = self._resilience.guard_batches(loader, epoch, batches)
        try:
            if skip_batches:
                skipped = 0
                for skipped, _ in enumerate(batches, start=1):
                    self._beat()
                    if skipped >= skip_batches:
                        break
                self.log(f"[tpudp] fast-forwarded {skipped} already-trained "
                         f"batches of epoch {epoch} (mid-epoch resume)")
            window_start = time.perf_counter()
            window_samples = 0
            it = 0
            # Allocation-free spans: the data wait an iteration, the
            # dispatch a step, one span a log window.
            win_tok = self.obs.begin("train.window")
            data_tok = self.obs.begin("train.data")
            for it, batch in enumerate(batches, start=1):
                self.obs.end(data_tok)
                images, labels, _ = self._device_batch(batch)
                window_samples += images.shape[0]
                self._fault_hook("train")
                if split:
                    t0 = time.perf_counter()
                    self.fwd_step(self.state, images)
                    fence(self.device)
                    t1 = time.perf_counter()
                    self.state, _ = self.train_step(self.state, images,
                                                    labels)
                    fence(self.device)
                    t2 = time.perf_counter()
                    fwd_t += t1 - t0
                    # the step recomputes the forward; the rest is backward
                    bwd_t += max(t2 - t1 - (t1 - t0), 0.0)
                else:
                    step_tok = self.obs.begin("train.dispatch")
                    self.state, _ = self.train_step(self.state, images,
                                                    labels)
                    self.obs.end(step_tok)
                if self.sdc_fault_hook is not None:
                    self.state = self.sdc_fault_hook(self.state)
                if it % self.log_every == 0:
                    fence_tok = self.obs.begin("train.fetch_fence")
                    fence(self.device)
                    self.obs.end(fence_tok)
                    window_time = time.perf_counter() - window_start
                    # tpudp: lint-ok(host-sync): one read a log window,
                    # after its fence
                    cum = float(self.state.loss_sum)
                    losses.append(check_finite(
                        (cum - prev_loss_sum) / self.log_every, step=it))
                    self._window_done(losses[-1], epoch, it)
                    prev_loss_sum = cum
                    for line in reference_window_lines(
                            it, losses[-1], window_time, self.log_every,
                            fwd_t=fwd_t if split else None,
                            bwd_t=bwd_t if split else None,
                            first_window=it == self.log_every):
                        self.log(line)
                    self.obs.end(win_tok)
                    win_tok = self.obs.begin("train.window")
                    self.obs.count("train.windows")
                    self.obs.count("train.samples", window_samples)
                    self._emit_metrics({
                        "kind": "train_window", "epoch": epoch, "iter": it,
                        "loss": losses[-1],
                        "sec_per_iter": window_time / self.log_every,
                        "samples_per_sec": window_samples / window_time,
                        "warmup_window": it == self.log_every,
                        **({"batches_skipped": skip_batches}
                           if skip_batches else {}),
                    })
                    window_samples = 0
                    fwd_t = bwd_t = 0.0
                    window_start = time.perf_counter()
                self._beat()  # an iteration completed
                data_tok = self.obs.begin("train.data")
            self.obs.end(data_tok)
            self.obs.end(win_tok)
        finally:
            if hasattr(batches, "close"):
                batches.close()  # stops a Prefetcher's worker
        if it % self.log_every:  # the ragged final window
            # tpudp: lint-ok(host-sync): the final window's one read
            cum = float(self.state.loss_sum)
            losses.append(check_finite(
                (cum - prev_loss_sum) / (it % self.log_every), step=it))
            self._window_done(losses[-1], epoch, it)
            self._beat()
        return float(np.mean(losses)) if losses else 0.0

    def evaluate(self, loader, *, epoch: int | None = None
                 ) -> tuple[float, float]:
        """A full test pass; returns ``(average loss per sample,
        accuracy)`` and prints the reference's summary line.  The sums
        stay on the device until the one read at the end; a non-finite
        loss fails with the epoch and batch count."""
        self._install_place_hook(loader)
        sums = torch.zeros(3, dtype=torch.float32, device=self.device)
        it = 0
        eval_tok = self.obs.begin("eval")
        for batch in loader:
            images, labels, weights = self._device_batch(batch)
            self._fault_hook("eval")
            step_tok = self.obs.begin("eval.dispatch")
            sums += torch.stack(self.eval_step(self.state, images, labels,
                                               weights))
            self.obs.end(step_tok)
            it += 1
            self._beat()
        fence_tok = self.obs.begin("eval.fetch")
        # tpudp: lint-ok(host-sync): the pass's one read, at its end
        loss_sum, correct, count = sums.tolist()
        self.obs.end(fence_tok)
        self.obs.end(eval_tok)
        count = max(count, 1.0)
        avg_loss = check_finite(
            loss_sum / count, step=self.state.step, what="eval loss",
            context=(f"epoch {epoch}, " if epoch is not None else "")
            + f"{it} eval batches")
        accuracy = correct / count
        self.log(
            "Test set: Average loss: {:.4f}, Accuracy: {}/{} ({:.0f}%)\n"
            .format(avg_loss, int(correct), int(count), 100.0 * accuracy))
        self._emit_metrics({"kind": "eval", "avg_loss": avg_loss,
                            "accuracy": accuracy, "count": count})
        return avg_loss, accuracy

    def fit(self, train_loader, test_loader=None, epochs: int = 1, *,
            start_epoch: int = 0, epoch_end_fn=None,
            skip_batches_first_epoch: int = 0, resilience=None) -> None:
        """The reference's epoch loop: train, print the epoch's wall
        time, evaluate.  ``start_epoch`` resumes a checkpointed run,
        ``epoch_end_fn(epoch)`` runs after each epoch's eval (the
        checkpoint hook), ``skip_batches_first_epoch`` fast-forwards
        epoch ``start_epoch`` past batches an interrupted run already
        trained (``train_epoch(skip_batches=)``).  With a watchdog the
        loop runs armed: every train and eval iteration beats.
        ``resilience`` (a :class:`tpudp_torch.resilience.ResiliencePolicy`)
        runs the loop under the in-process supervisor, with its counters
        and events in :attr:`stats`."""
        if resilience is not None:
            from tpudp_torch.resilience import Supervisor

            Supervisor(self, resilience).run(
                train_loader, test_loader, epochs, start_epoch,
                epoch_end_fn, skip_batches_first_epoch)
            return
        if self.watchdog is not None:
            self.watchdog.arm()
        try:
            self._fit(train_loader, test_loader, epochs, start_epoch,
                      epoch_end_fn, skip_batches_first_epoch)
        finally:
            if self.watchdog is not None:
                self.watchdog.disarm()

    def _fit(self, train_loader, test_loader, epochs: int, start_epoch: int,
             epoch_end_fn, skip_first: int = 0) -> None:
        for epoch in range(start_epoch, epochs):
            start = time.perf_counter()
            epoch_tok = self.obs.begin("train.epoch")
            skip = skip_first if epoch == start_epoch else 0
            self.train_epoch(train_loader, epoch, skip_batches=skip)
            fence(self.device)
            self.obs.end(epoch_tok)
            epoch_s = time.perf_counter() - start
            self.log("Training time after {} epoch is {}".format(
                epoch + 1, epoch_s))
            self._emit_metrics({"kind": "epoch", "epoch": epoch,
                                "seconds": epoch_s,
                                **({"batches_skipped": skip}
                                   if skip else {})})
            if self.verify_replicas:
                self._verify_replicas()
            if test_loader is not None:
                self.evaluate(test_loader, epoch=epoch)
            if epoch_end_fn is not None:
                epoch_end_fn(epoch)

    def _verify_replicas(self) -> None:
        """JAX's post-epoch check: every replicated parameter and
        statistic bit-identical across the ranks that hold it (every rank
        under dp, the ``data`` axis's ranks under a sharded rung, whose
        module holds this rank's shards), then the cheap cross-rank
        fingerprint; raises ``ReplicaDivergenceError``."""
        from tpudp_torch.models.norm import DATA_AXIS
        from tpudp_torch.utils.checkpoint import world_size
        from tpudp_torch.utils.consistency import (verify_across_processes,
                                                   verify_replicas)

        beat = self.watchdog.beat if self.watchdog is not None else None
        model = self.state.model
        tree = {"params": dict(model.named_parameters()),
                "batch_stats": {k: b for k, b in model.named_buffers()
                                if b.is_floating_point()}}
        group, compare = None, True
        if self.strategy != "dp":
            from tpudp_torch.parallel.sharded import axis_of

            axes = getattr(self.mesh, "shape", {DATA_AXIS: 0})
            compare = DATA_AXIS in axes
            if compare:
                group = axis_of(self.mesh, DATA_AXIS)[0]
        n = verify_replicas(tree, beat=beat, group=group) if compare else 0
        if compare:
            verify_across_processes(tree, group)
        if beat is not None:
            beat()
        if n == 0 and world_size() == 1:
            self.log("[tpudp] replica consistency: nothing to check (no "
                     "leaf has >1 replica on this mesh)")
        else:
            self.log(f"[tpudp] replica consistency OK ({n} replicated "
                     "leaves bit-identical"
                     + (", cross-process fingerprints equal)"
                        if world_size() > 1 else ")"))
