"""In-process fault supervision for ``Trainer.fit`` — the port of
``tpudp/resilience.py``.

Every recovery restores a checkpoint and replays deterministically, so
the final parameters equal an uninterrupted run's bit for bit:

  * **Divergence rollback** — a non-finite window loss
    (``FloatingPointError`` from ``check_finite``) or one beyond
    ``spike_factor`` x the trailing median (:class:`LossSpikeError`)
    restores the newest VERIFIED checkpoint and fast-forwards the data to
    the restored step (``train_epoch(skip_batches=)``: the host RNG
    replays).  Bounded by ``max_rollbacks``, then the original error
    escalates.
  * **Step-fault and hang recovery** — an exception out of the train
    step (or ``StepHangError`` from a ``kill=False`` watchdog) fences the
    device, dumps the live state as the emergency checkpoint, restores
    and verifies it (or falls back to the newest verified checkpoint),
    re-arms the watchdog and goes on in the same process.  A second
    consecutive failure at the same step escalates.
  * **Checkpoint-integrity fallback** — every restore verifies the
    manifest; a corrupt newest checkpoint falls back to the previous
    intact one (``stats["ckpt_fallbacks"]``).
  * **Loader containment** — an exception out of the loader restarts the
    pipeline and replays to the exact batch offset, bounded by
    ``max_loader_restarts`` an epoch.
  * **Silent-data-corruption defense** (``sdc_check_every=N`` with
    ``Trainer(track_sdc_fingerprint=True)``, ``tpudp_torch.sdc``) —
    every N optimizer steps, at the window edge where the host already
    read ``loss_sum``, every rank puts its in-step fingerprint
    ``[checksum, count]`` into one bounded gather (JAX's row adds a
    host's local device vote; a rank holds one replica, so it has
    none); every rank derives the same verdict from the same
    rows (rank keys ``p<rank>``: each rank is one of JAX's hosts) and
    raises :class:`~tpudp_torch.sdc.SdcDetected` in the same round,
    which rides the divergence rollback.  Under pipeline parallelism
    (a ``pipe`` axis) a mismatch also gathers each rank's stage-local
    checksum and votes within the ranks of one stage, as JAX's
    ``vote_shard_groups`` does.  The bit-exact replay grades it: a clean
    re-check past the detection step is a transient flip; the same
    localized rank again is persistent — that rank writes
    :data:`~tpudp_torch.sdc.QUARANTINE_MARKER` and exits
    :data:`~tpudp_torch.sdc.SDC_QUARANTINE_EXIT`, the others raise
    :class:`~tpudp_torch.sdc.SdcPersistentError`.  An unlocalizable
    detection (a two-rank tie) never quarantines; the rollback budget
    bounds it.

Each recovery is a typed event in ``trainer.stats["events"]`` with the
counters ``rollbacks``, ``step_retries``, ``ckpt_fallbacks``,
``loader_restarts``, ``sdc_checks``, ``sdc_detections``,
``sdc_transients`` and ``sdc_quarantines``.  ``Trainer.fit(resilience=None)`` runs no
supervisor at all.

With several ranks every recovery is voted: each rank gathers every
rank's outcome code and vote number over a gloo group of its own (so a
vote never pairs with a step's collective on the default group), the
worst severity wins (:func:`reduce_outcomes`) and all ranks execute the
one agreed action — the restore is the rank-voted verified walk, so
every rank resumes the same step.  The wait is bounded by
``vote_timeout_s``: a peer that never joins (a fault only one rank saw
leaves the others inside the step's collective) or a vote that errors
out ends the process with :data:`VOTE_TIMEOUT_EXIT` for a relaunch into
the coordinated resume, as in JAX.  A rank wedged inside a device
collective never reaches a vote: the CLI's watchdog backstop ends it
(``--step-timeout``, which ``--resilience`` needs at more than one rank).
After every coordinated restore the ranks' state fingerprints must agree
(``tpudp_torch.utils.consistency.verify_across_processes``) before
training goes on.
"""

from __future__ import annotations

import os
import statistics
import sys
import threading
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable

from tpudp_torch.sdc import (QUARANTINE_MARKER, SDC_QUARANTINE_EXIT,
                             SdcDetected, SdcPersistentError)
from tpudp_torch.utils.watchdog import StepHangError

OUTCOME_OK = 0
OUTCOME_STEP_FAULT = 1
OUTCOME_HANG = 2
OUTCOME_DIVERGENCE = 3

OUTCOME_NAMES = {OUTCOME_OK: "ok", OUTCOME_STEP_FAULT: "step_fault",
                 OUTCOME_HANG: "hang", OUTCOME_DIVERGENCE: "divergence"}

#: The exit code of a rank whose recovery vote got no answer (or whose
#: peers voted on another decision): relaunch it into the coordinated
#: resume.  The watchdog's hard exit is 42.
VOTE_TIMEOUT_EXIT = 43


def reduce_outcomes(codes) -> int:
    """The one action for the ranks' outcome codes: worst severity wins."""
    return max(int(c) for c in codes)


class LossSpikeError(RuntimeError):
    """A finite but anomalous window loss: beyond ``spike_factor`` x the
    trailing-median window loss."""

    def __init__(self, loss: float, median: float, step: int):
        super().__init__(
            f"training loss spike at step {step}: {loss:.6g} > "
            f"{median:.6g} trailing median")
        self.loss, self.median, self.step = loss, median, step


class ResilienceExhausted(RuntimeError):
    """A recovery budget ran out; carries the ORIGINAL error, which the
    supervisor re-raises so that escalation looks like the crash it
    contained."""

    def __init__(self, message: str, original: BaseException):
        super().__init__(message)
        self.original = original


@dataclass
class ResiliencePolicy:
    """Knobs of the supervisor (``Trainer.fit``'s ``resilience=``).
    ``checkpoint_dir`` is required: rollback and step recovery restore
    from the ``step_N`` series and the emergency dump under it.
    ``spike_factor=None`` turns spike detection off (NaN windows still
    roll back).  ``save_epoch_checkpoints=False`` is for callers whose
    ``epoch_end_fn`` already saves into the same root (the CLI).
    ``checkpoint_writer`` is the caller's AsyncCheckpointWriter, drained
    before any dump or restore.  ``vote_timeout_s`` (more than one rank)
    bounds the wait at each recovery vote and SDC gather.
    ``sdc_check_every=N`` checks the replicas' fingerprints every N
    optimizer steps (it needs ``Trainer(track_sdc_fingerprint=True)``)."""

    checkpoint_dir: str
    max_rollbacks: int = 3
    spike_factor: float | None = None
    spike_window: int = 8
    spike_min_history: int = 3
    max_step_retries: int = 1
    max_loader_restarts: int = 3
    save_epoch_checkpoints: bool = True
    checkpoint_writer: Any = None
    on_event: Callable[[dict], None] | None = None
    vote_timeout_s: float = 120.0
    sdc_check_every: int | None = None


def make_emergency_dump(checkpoint_dir: str, get_state,
                        per_epoch_batches: int, async_writer=None,
                        log=print) -> Callable[[], None]:
    """The dump shared by the CLI's watchdog ``on_hang`` and the
    supervisor's step recovery: clear the previous dump's sentinel first,
    drain an in-flight async write (two writers in one root can tear
    both), save, then commit the sentinel."""
    from tpudp_torch.utils.checkpoint import (clear_emergency_sentinel,
                                              rank, save_checkpoint,
                                              write_emergency_sentinel)

    def dump() -> None:
        if rank() == 0:
            clear_emergency_sentinel(checkpoint_dir)
        if async_writer is not None:
            async_writer.wait()
        state = get_state()
        path = os.path.join(checkpoint_dir, "emergency")
        save_checkpoint(path, state)
        if rank() == 0:
            write_emergency_sentinel(checkpoint_dir, step=int(state.step),
                                     per_epoch_batches=per_epoch_batches)
        log(f"[tpudp] emergency checkpoint saved to {path}")

    return dump


def restore_newest(trainer, checkpoint_dir: str, *, log=print,
                   on_event=None) -> tuple[str | None, bool]:
    """Restore ``trainer.state`` from ``checkpoint_dir`` as the CLI does —
    the newest verified ``step_N``, then the emergency dump in
    preference — and return ``(the path restored, whether it is the
    dump)``, ``(None, False)`` where there is nothing to restore.  Entry
    into each restore is a collective decision; the dump stays in place
    (:func:`auto_resume` consumes it)."""
    from tpudp_torch.utils.checkpoint import (coordinated_any, emergency_dir,
                                              latest_step_dir,
                                              restore_emergency_voted,
                                              restore_latest_verified)

    used = None
    if coordinated_any(latest_step_dir(checkpoint_dir) is not None):
        _, used, skipped = restore_latest_verified(
            checkpoint_dir, trainer.state, log=log)
        if on_event is not None:
            for rejected, reason in skipped:
                on_event({"kind": "ckpt_fallback", "rejected": rejected,
                          "reason": reason})
        log(f"[tpudp] resumed from {used}"
            + (f" ({len(skipped)} newer checkpoint(s) skipped as corrupt)"
               if skipped else ""))
    if coordinated_any(emergency_dir(checkpoint_dir) is not None):
        # The dump's location is fixed: a rank whose listing is stale
        # takes it from there, and the voted restore decides its fate.
        emerg = os.path.join(checkpoint_dir, "emergency")
        if restore_emergency_voted(checkpoint_dir, emerg, trainer.state,
                                   log=log) is not None:
            log(f"[tpudp] resumed mid-epoch state from emergency dump "
                f"{emerg}")
            return emerg, True
    return used, False


def auto_resume(trainer, checkpoint_dir: str, per_epoch_batches: int, *,
                log=print, on_event=None) -> tuple[int, int]:
    """:func:`restore_newest`, then the dump consumed (rank 0 alone,
    after every rank has read it); returns ``(start_epoch,
    skip_batches)`` from the restored step counter, ``(0, 0)`` where
    nothing was restored."""
    from tpudp_torch.utils.checkpoint import barrier, consume_emergency, rank

    used, from_dump = restore_newest(trainer, checkpoint_dir, log=log,
                                     on_event=on_event)
    if from_dump:
        barrier()  # every rank has read it before rank 0 renames it
        if rank() == 0:
            consume_emergency(checkpoint_dir)
    if used is None:
        return 0, 0
    step = int(trainer.state.step)
    return step // per_epoch_batches, step % per_epoch_batches


class Supervisor:
    """Runs ``Trainer._fit`` under the recovery loop; one instance a
    ``fit`` call, installed as ``trainer._resilience`` so the epoch
    loop's seams (window losses, the guarded batch iterator) report
    here."""

    def __init__(self, trainer, policy: ResiliencePolicy):
        from tpudp_torch.utils.checkpoint import world_size

        if not policy.checkpoint_dir:
            raise ValueError(
                "ResiliencePolicy.checkpoint_dir is required: rollback and "
                "step recovery restore from the step_N series under it")
        if policy.sdc_check_every is not None:
            if policy.sdc_check_every < 1:
                raise ValueError(
                    f"sdc_check_every must be >= 1, got "
                    f"{policy.sdc_check_every}")
            if getattr(trainer.state, "sdc_fp", None) is None:
                raise ValueError(
                    "sdc_check_every requires the in-step fingerprint: "
                    "construct the Trainer with track_sdc_fingerprint="
                    "True so the sdc_fp slot is allocated before the "
                    "step programs are built")
        self.trainer = trainer
        self.policy = policy
        self._multirank = world_size() > 1
        # This rank's stage under pipeline parallelism (the SDC vote's
        # replication groups), else None.
        shape = getattr(getattr(trainer, "mesh", None), "shape", None)
        self._pipe = (trainer.mesh.coords["pipe"]
                      if isinstance(shape, dict) and shape.get("pipe", 1) > 1
                      else None)
        self._vote_seq = 0
        self._vote_group = None
        if self._multirank:
            from torch import distributed as dist

            # Every rank builds its Supervisor in the same fit call.
            self._vote_group = dist.new_group(backend="gloo")
        trainer.stats.update(rollbacks=0, step_retries=0, ckpt_fallbacks=0,
                             loader_restarts=0, events=[], sdc_checks=0,
                             sdc_detections=0, sdc_transients=0,
                             sdc_quarantines=0)
        self._window_losses: deque[float] = deque(maxlen=policy.spike_window)
        self._last_failed_step: int | None = None
        self._consecutive_at_step = 0
        self._per_epoch: int | None = None
        # The last checked optimizer step, and the detection awaiting its
        # post-replay verdict.
        self._sdc_last_check = 0
        self._sdc_pending: dict | None = None

    # -- event log ---------------------------------------------------------
    def record(self, kind: str, **fields) -> None:
        event = {"kind": kind, **fields}
        self.trainer.stats["events"].append(event)
        # Mirrored into the trainer's span ring, so a flight record
        # carries the recovery timeline beside the window spans.
        self.trainer.obs.event("resilience." + kind, **fields)
        if self.policy.on_event is not None:
            self.policy.on_event(event)

    # -- seams the Trainer calls ------------------------------------------
    def observe_window_loss(self, loss: float, *, epoch: int,
                            it: int) -> None:
        """Every completed log window (already finite): raises
        :class:`LossSpikeError` beyond ``spike_factor`` x the trailing
        median; a completed window also clears the same-step failure
        tracking."""
        self._last_failed_step = None
        self._consecutive_at_step = 0
        p = self.policy
        if (p.spike_factor is not None
                and len(self._window_losses) >= p.spike_min_history):
            med = statistics.median(self._window_losses)
            if med > 0 and loss > p.spike_factor * med:
                step = epoch * (self._per_epoch or 0) + it
                self.record("loss_spike", epoch=epoch, it=it, loss=loss,
                            median=med, step=step)
                raise LossSpikeError(loss, med, step)
        self._window_losses.append(loss)

    # -- silent-data-corruption check (tpudp_torch.sdc) --------------------
    def observe_window_state(self, state, *, epoch: int, it: int) -> None:
        """Every completed log window, right after
        :meth:`observe_window_loss` (the host just read ``loss_sum``, so
        reading the 16-byte fingerprint waits for nothing more); gated by
        ``policy.sdc_check_every``.  Each rank holds one replica, so its
        local vote has nothing to compare (JAX's vote over a host's
        devices): the verdict is the gathered rows' — see the module
        docstring.  The post-replay re-check grades a detection: clean
        means transient, the same localized rank again persistent
        (:meth:`_sdc_quarantine`); an unlocalizable detection never
        quarantines."""
        every = self.policy.sdc_check_every
        if every is None:
            return
        gstep = int(state.step)
        if gstep - self._sdc_last_check < every:
            return
        self._sdc_last_check = gstep
        self.trainer.stats["sdc_checks"] += 1
        from tpudp_torch.sdc import localize_minority

        minority, localized, devices = [], True, []
        if self._multirank:
            # JAX's row adds each host's local device vote and whether it
            # localized; a rank holds one replica, so it has none and the
            # row is the fingerprint alone.
            rows = self._sdc_gather([int(v) for v in state.sdc_fp.tolist()])
            h_min, h_maj = localize_minority(
                {f"p{i}": r for i, r in enumerate(rows)})
            minority = sorted(h_min)
            localized = bool(h_min) and bool(h_maj)
            if minority and self._pipe is not None:
                d_min, d_maj = self._vote_stage_groups(state)
                if d_min and d_maj:
                    minority, localized = d_min, True
            devices = list(minority)
        pending = self._sdc_pending
        if not minority:
            if pending is not None and gstep >= pending["step"]:
                # The bit-exact replay re-crossed the detection step clean:
                # a transient flip, repaired by the rollback.
                self.trainer.stats["sdc_transients"] += 1
                self.record("sdc_transient", replicas=pending["minority"],
                            step=pending["step"], cleared_at=gstep)
                self.trainer.log(
                    f"[tpudp] resilience: SDC at step {pending['step']} "
                    f"(replica(s) {pending['minority']}) did not recur "
                    f"through step {gstep} — transient flip, repaired by "
                    "rollback; continuing")
                self._sdc_pending = None
            return
        self.trainer.stats["sdc_detections"] += 1
        self.record("sdc_detected", replicas=minority, step=gstep,
                    epoch=epoch, it=it, localized=localized,
                    devices=devices)
        if (pending is not None and localized and pending["localized"]
                and set(minority) & set(pending["minority"])):
            self._sdc_quarantine(minority, gstep, devices)  # raises/exits
        self._sdc_pending = {"minority": minority, "step": gstep,
                             "localized": localized}
        named = (f"minority replica(s) {minority}" if localized
                 else f"replicas disagree ({minority}) with no strict "
                      "majority — corruption proven, culprit unnamed")
        raise SdcDetected(
            f"silent data corruption at step {gstep}: {named}",
            step=gstep, replica=minority if localized else None)

    def _vote_stage_groups(self, state) -> tuple[list, list]:
        """The raw-byte localization under pipeline parallelism: every
        rank's stage-local checksum (its stage's parameters and optimizer
        buffers, not summed over ``pipe``) in one more bounded gather,
        voted within the ranks of each stage (one replication group);
        ``(minority, majority)`` over ``p<rank>`` keys, a rank minority in
        any group outranking its majority elsewhere."""
        from tpudp_torch.sdc import fingerprint, localize_minority
        from tpudp_torch.train import fingerprint_tensors

        params = list(state.model.parameters())
        raw = fingerprint(fingerprint_tensors(state.optimizer, params))
        rows = self._sdc_gather([int(v) for v in raw.tolist()]
                                + [self._pipe])
        groups: dict = {}
        for i, r in enumerate(rows):
            groups.setdefault(int(r[2]), {})[f"p{i}"] = r[:2]
        minority: set = set()
        majority: set = set()
        for fps in groups.values():
            if len(fps) < 2:
                continue
            g_min, g_maj = localize_minority(fps)
            minority.update(g_min)
            majority.update(g_maj)
        majority -= minority
        return sorted(minority), sorted(majority)

    def _sdc_gather(self, row: list) -> list:
        """This rank's check row gathered from every rank of the vote
        group (:meth:`_bounded_gather`), as uint64 rows: every rank
        reaches it at the same checked step (the cadence is a function
        of the shared step counter)."""
        import numpy as np

        return [np.asarray(r, np.uint64) for r in self._bounded_gather(
            row, "SDC fingerprint gather", "fingerprint gather",
            outcome="sdc_check")]

    def _bounded_gather(self, row: list, what: str, verb: str,
                        **fields) -> list:
        """One all-gather of this rank's int64 ``row`` over the vote
        group, on a thread whose wait is bounded by
        ``policy.vote_timeout_s``; returns every rank's row (lists of
        ints, rank order).  No answer, or a collective that fails here,
        records ``vote_timeout`` (``what`` names the round, ``verb`` the
        failed collective, ``fields`` go into the record) and ends the
        process with :data:`VOTE_TIMEOUT_EXIT`: any peer still inside
        the gather times out the same way."""
        import torch
        from torch import distributed as dist

        result: dict = {}

        def gather() -> None:
            try:
                rows = [torch.zeros(len(row), dtype=torch.int64)
                        for _ in range(dist.get_world_size())]
                # tpudp: lint-ok(protocol-divergent-entry): the except
                # arm IS the bounded-vote mitigation this verifier
                # demands elsewhere — a collective that fails locally
                # (torn TCP, dead peer) is converted to a vote-timeout
                # verdict and a hard exit (43), and any peer still
                # inside the gather times out the same way; nobody is
                # left waiting on this host's rendezvous.
                dist.all_gather(rows, torch.tensor(row, dtype=torch.int64),
                                group=self._vote_group)
                result["rows"] = [r.tolist() for r in rows]
            except BaseException as e:  # gloo raises several types
                result["error"] = e

        th = threading.Thread(target=gather, daemon=True,
                              name="tpudp-bounded-gather")
        th.start()
        th.join(self.policy.vote_timeout_s)
        if "rows" not in result:
            why = (f"{verb} failed: {result['error']!r}"
                   if "error" in result else
                   f"no peer joined within {self.policy.vote_timeout_s}s")
            self._record_vote_exit(
                "vote_timeout", f"{what} got no answer ({why}); a peer is "
                "dead or wedged", **fields, reason=why)
            os._exit(VOTE_TIMEOUT_EXIT)
        return result["rows"]

    def _sdc_quarantine(self, minority, gstep: int, devices=None) -> None:
        """The persistent verdict: the same localized rank diverged again
        after a bit-exact replay.  Record, flight-dump and write the
        marker naming the rank(s) (``{"replicas", "step", "devices",
        "host"}``, written by the named ranks), then the named rank
        exits :data:`SDC_QUARANTINE_EXIT` and every other rank raises
        :class:`SdcPersistentError` (which sends it to the relaunch at
        fewer ranks).  Every rank grades the same gathered rows alike."""
        import json

        from tpudp_torch.utils.checkpoint import rank

        t = self.trainer
        t.stats["sdc_quarantines"] += 1
        self.record("sdc_quarantine", replicas=minority, step=gstep)
        t.flight.dump("sdc_quarantine",
                      extra={"replicas": minority, "step": gstep})
        me = rank()
        mine = [k for k in minority if k.split("/")[0] == f"p{me}"]
        if mine or not self._multirank:
            marker = os.path.join(self.policy.checkpoint_dir,
                                  QUARANTINE_MARKER)
            tmp = f"{marker}.{me}.tmp"
            with open(tmp, "w") as f:
                json.dump({"replicas": minority, "step": gstep,
                           "devices": sorted(devices or []),
                           "host": me}, f)
            os.replace(tmp, marker)
        t.log(f"[tpudp] resilience: SDC on replica(s) {minority} recurred "
              f"after a bit-exact replay (step {gstep}) — persistent bad "
              "chip; quarantining for reduced-geometry relaunch")
        if self._multirank and mine:
            sys.stdout.flush()
            os._exit(SDC_QUARANTINE_EXIT)
        raise SdcPersistentError(
            f"replica(s) {minority} diverged again after a bit-exact "
            f"replay at step {gstep} — persistent silent corruption; "
            "host quarantined", replica=minority)

    def guard_batches(self, loader, epoch: int, base):
        """One epoch's batch iterator with loader containment: an
        exception out of ``next()`` restarts the pipeline and replays the
        draws already consumed (discarded), so the batch sequence and
        every host RNG draw behind it are unchanged.  Bounded an epoch."""
        t = self.trainer
        it, consumed, replay, restarts = base, 0, 0, 0
        try:
            while True:
                try:
                    item = next(it)
                except StopIteration:
                    return
                except StepHangError:
                    raise  # the watchdog's signal, not a loader fault
                except Exception as e:
                    restarts += 1
                    if restarts > self.policy.max_loader_restarts:
                        self.record("loader_escalation", epoch=epoch,
                                    restarts=restarts - 1, error=repr(e))
                        raise ResilienceExhausted(
                            f"loader failed {restarts} times in epoch "
                            f"{epoch}", e) from e
                    t.stats["loader_restarts"] += 1
                    self.record("loader_restart", epoch=epoch,
                                offset=consumed, error=repr(e))
                    t.log(f"[tpudp] resilience: loader failed at batch "
                          f"{consumed} of epoch {epoch} ({e!r}); restarting "
                          "the pipeline and replaying to the exact offset")
                    if hasattr(it, "close"):
                        it.close()
                    if hasattr(loader, "set_epoch"):
                        loader.set_epoch(epoch)
                    it = iter(loader)
                    replay = consumed
                    continue
                if replay:
                    replay -= 1  # a discarded re-draw: the host RNG replays
                    t._beat()
                    continue
                consumed += 1
                yield item
        finally:
            if hasattr(it, "close"):
                it.close()

    # -- recovery ------------------------------------------------------------
    def _fence(self) -> None:
        """Wait for the device work already queued: it completes even
        after the host saw a failure, and must land before a restore."""
        from tpudp_torch.trainer import fence

        fence(self.trainer.device)

    def _resume_position(self) -> tuple[int, int]:
        step = int(self.trainer.state.step)
        return step // self._per_epoch, step % self._per_epoch

    def _restore_verified(self) -> str:
        from tpudp_torch.utils.checkpoint import restore_latest_verified

        if self.policy.checkpoint_writer is not None:
            self.policy.checkpoint_writer.wait()
        _, path, skipped = restore_latest_verified(
            self.policy.checkpoint_dir, self.trainer.state,
            log=self.trainer.log)
        self.trainer.stats["ckpt_fallbacks"] += len(skipped)
        for p, reason in skipped:
            self.record("ckpt_fallback", rejected=p, reason=reason)
        return path

    def _rearm(self) -> None:
        if self.trainer.watchdog is not None:
            self.trainer.watchdog.arm()  # clears a recorded hang

    def _count_step_failure(self, e: BaseException) -> int:
        """Track consecutive failures at one step; escalates ``e`` past
        ``max_step_retries``.  Returns the failed step."""
        failed_step = int(self.trainer.state.step)
        if failed_step == self._last_failed_step:
            self._consecutive_at_step += 1
        else:
            self._consecutive_at_step = 1
        self._last_failed_step = failed_step
        if self._consecutive_at_step > self.policy.max_step_retries:
            self.record("step_escalation", error=repr(e), step=failed_step,
                        consecutive=self._consecutive_at_step)
            self.trainer.log(
                f"[tpudp] resilience: step {failed_step} failed "
                f"{self._consecutive_at_step} consecutive times; escalating")
            raise e
        return failed_step

    def _spend_rollback(self, e: BaseException) -> None:
        stats = self.trainer.stats
        if stats["rollbacks"] >= self.policy.max_rollbacks:
            self.record("rollback_escalation", error=repr(e),
                        rollbacks=stats["rollbacks"])
            self.trainer.log(
                f"[tpudp] resilience: rollback budget "
                f"({self.policy.max_rollbacks}) exhausted; escalating")
            raise e  # escalate with the ORIGINAL error
        stats["rollbacks"] += 1

    def _rollback(self, e: BaseException) -> tuple[int, int]:
        # The black box first: the ring's tail is the window timeline
        # that led to the divergence (a no-op without a flight dir).
        self.trainer.flight.dump("rollback", extra={"error": repr(e)[:500]})
        self._spend_rollback(e)
        self._fence()
        path = self._restore_verified()
        self._window_losses.clear()
        self._rearm()
        epoch, skip = self._resume_position()
        self.record("rollback", error=repr(e), restored=path,
                    step=int(self.trainer.state.step), epoch=epoch,
                    skip=skip)
        self.trainer.log(
            f"[tpudp] resilience: {type(e).__name__} ({e}); rolled back to "
            f"{path} (epoch {epoch}, {skip} batches in) and replaying")
        return epoch, skip

    def _step_recover(self, e: BaseException) -> tuple[int, int]:
        from tpudp_torch.utils.checkpoint import (consume_emergency,
                                                  restore_checkpoint)

        t = self.trainer
        t.flight.dump("step_fault" if not isinstance(e, StepHangError)
                      else "hang", extra={"error": repr(e)[:500]})
        self._fence()
        failed_step = self._count_step_failure(e)
        t.stats["step_retries"] += 1
        dump = make_emergency_dump(
            self.policy.checkpoint_dir, lambda: t.state, self._per_epoch,
            async_writer=self.policy.checkpoint_writer, log=t.log)
        emerg = os.path.join(self.policy.checkpoint_dir, "emergency")
        try:
            dump()
            restore_checkpoint(emerg, t.state, verify=True)
            restored_from = emerg
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as dump_err:
            t.log(f"[tpudp] resilience: emergency dump/restore failed "
                  f"({dump_err!r}); falling back to the newest verified "
                  "checkpoint")
            # tpudp: lint-ok(protocol-order-divergence): single-host
            # path by construction — Supervisor.run routes every
            # multihost fault through _vote/_coordinated_recover, so
            # the dump-vs-fallback arms here never run on a pod and
            # their "collectives" degenerate to process_count()==1
            # identities.
            restored_from = self._restore_verified()
        else:
            try:
                consume_emergency(self.policy.checkpoint_dir)
            except OSError as err:
                t.log(f"[tpudp] WARNING: could not consume emergency dump "
                      f"after recovery: {err}")
        self._rearm()
        epoch, skip = self._resume_position()
        self.record("step_retry", error=repr(e), step=failed_step,
                    hang=isinstance(e, StepHangError),
                    restored=restored_from, epoch=epoch, skip=skip)
        t.log(f"[tpudp] resilience: {type(e).__name__} ({e}); restored "
              f"{restored_from} and continuing in-process at epoch "
              f"{epoch}, {skip} batches in")
        return epoch, skip

    def _vote(self, code: int) -> int:
        """One round of the agreement protocol: gather every rank's
        outcome ``code`` and vote number over the vote group and return
        the worst code, which every rank then executes (the identity at
        one rank).  The wait is bounded by ``policy.vote_timeout_s``; no
        answer, an error or a peer on another vote number ends the
        process with :data:`VOTE_TIMEOUT_EXIT`."""
        if not self._multirank:
            return code
        self._vote_seq += 1
        seq = self._vote_seq
        rows = self._bounded_gather(
            [code, seq], f"recovery vote {seq}", "vote collective", seq=seq,
            outcome=OUTCOME_NAMES.get(code))
        codes, seqs = [r[0] for r in rows], [r[1] for r in rows]
        if any(s != seq for s in seqs):
            self._record_vote_exit("vote_desync", f"vote number desync (local "
                            f"{seq}, ranks {seqs})", seq=seq, seqs=seqs)
            os._exit(VOTE_TIMEOUT_EXIT)
        worst = reduce_outcomes(codes)
        self.record("vote", seq=seq, outcome=OUTCOME_NAMES.get(code),
                    worst=OUTCOME_NAMES.get(worst), codes=codes)
        return worst

    def _record_vote_exit(self, kind: str, why: str, **fields) -> None:
        """Record ``kind``, say why and flush, before the caller's hard
        exit for the relaunch: the ranks no longer agree on one action,
        so no rank may act alone."""
        self.record(kind, **fields)
        self.trainer.log(f"[tpudp] resilience: {why}; hard-exiting for a "
                         f"relaunch (exit {VOTE_TIMEOUT_EXIT})")
        # This process is about to exit because of a peer: its local
        # dump is the only surviving timeline of what it saw.
        self.trainer.flight.dump(kind, extra={"reason": why, **fields})
        sys.stdout.flush()

    def _assert_replicas_agree(self) -> None:
        """After a coordinated restore every rank's state fingerprint
        must agree before training resumes: ranks that restored
        different bytes would train a model that belongs to nobody.
        Raises ``ReplicaDivergenceError``; a no-op at one rank."""
        if not self._multirank:
            return
        from tpudp_torch.utils.consistency import (state_tree,
                                                   verify_across_processes)

        tree = state_tree(self.trainer.state)
        # The telemetry slots are not checkpointed: after a restore each
        # rank's holds its own last value (JAX restores them too).
        tree.pop("obs_norms", None)
        tree.pop("sdc_fp", None)
        verify_across_processes({"state": tree})

    def _coordinated_recover(self, worst: int,
                             e: BaseException | None) -> tuple[int, int]:
        """The voted action on every rank: restore the step every rank
        verifies and replay.  ``e`` is this rank's error (None on a rank
        that voted OK and joins a peer's recovery); the budgets advance in
        lockstep, so an escalation fires on every rank together."""
        t = self.trainer
        original = e if e is not None else RuntimeError(
            "a peer rank faulted; this rank joined the coordinated "
            "recovery")
        # Every rank banks its own black box for the voted recovery.
        t.flight.dump("coordinated_" + str(OUTCOME_NAMES.get(worst)),
                      extra={"error": repr(original)[:500],
                             "worst": OUTCOME_NAMES.get(worst)})
        self._fence()
        if worst == OUTCOME_DIVERGENCE:
            self._spend_rollback(original)
        else:
            self._count_step_failure(original)
            t.stats["step_retries"] += 1
        path = self._restore_verified()
        self._window_losses.clear()
        self._rearm()
        self._assert_replicas_agree()
        if t.flight.enabled:
            # Every rank here is live (it just voted and restored): rank
            # 0 folds the per-rank dumps into flightrec-merged.json.
            from tpudp_torch.obs import coordinated_merge

            coordinated_merge(t.flight.directory)
        epoch, skip = self._resume_position()
        kind = "rollback" if worst == OUTCOME_DIVERGENCE else "step_retry"
        self.record(kind, error=repr(original), restored=path,
                    step=int(t.state.step), epoch=epoch, skip=skip,
                    hang=worst == OUTCOME_HANG, coordinated=True)
        t.log(f"[tpudp] resilience: coordinated "
              f"{OUTCOME_NAMES.get(worst)} recovery "
              f"({type(original).__name__}: {original}); all ranks restored "
              f"{path} (epoch {epoch}, {skip} batches in) and replaying")
        return epoch, skip

    def _ensure_initial_checkpoint(self, start_epoch: int,
                                   skip_first: int) -> None:
        """Save ``step_<start_epoch>`` of the initial state when the series
        is empty, so a rollback has a target before the first epoch ends
        (not on a mid-epoch resume: ``step_N`` means "after epoch N")."""
        from tpudp_torch.utils.checkpoint import (coordinated_any,
                                                  latest_step_dir,
                                                  save_checkpoint)

        if skip_first or coordinated_any(
                latest_step_dir(self.policy.checkpoint_dir) is not None):
            return
        path = os.path.join(self.policy.checkpoint_dir,
                            f"step_{start_epoch}")
        save_checkpoint(path, self.trainer.state)
        self.record("initial_checkpoint", path=path)

    def run(self, train_loader, test_loader, epochs: int, start_epoch: int,
            epoch_end_fn, skip_first: int) -> None:
        t = self.trainer
        self._per_epoch = len(train_loader)
        self._epoch_end_done = start_epoch - 1

        def epoch_end(epoch: int) -> None:
            if epoch_end_fn is not None:
                epoch_end_fn(epoch)
            if self.policy.save_epoch_checkpoints:
                from tpudp_torch.utils.checkpoint import save_checkpoint

                save_checkpoint(os.path.join(self.policy.checkpoint_dir,
                                             f"step_{epoch + 1}"), t.state)
            self._epoch_end_done = max(self._epoch_end_done, epoch)

        os.makedirs(self.policy.checkpoint_dir, exist_ok=True)
        self._ensure_initial_checkpoint(start_epoch, skip_first)
        t._resilience = self
        if t.watchdog is not None:
            t.watchdog.arm()
        cur_start, cur_skip = start_epoch, skip_first
        try:
            while True:
                try:
                    # A fault in an epoch's eval or save restores the state
                    # after that epoch: finish its missed epoch end first.
                    missed = cur_start - 1
                    if (cur_skip == 0 and start_epoch <= missed
                            and missed > self._epoch_end_done):
                        if test_loader is not None:
                            t.evaluate(test_loader, epoch=missed)
                        epoch_end(missed)
                    t._fit(train_loader, test_loader, epochs, cur_start,
                           epoch_end, cur_skip)
                    if self._multirank:
                        worst = self._vote(OUTCOME_OK)
                        if worst != OUTCOME_OK:
                            cur_start, cur_skip = \
                                self._coordinated_recover(worst, None)
                            continue
                    return
                except ResilienceExhausted as e:
                    # tpudp: lint-ok(protocol-early-exit): escalation
                    # fires on EVERY host in the same protocol round —
                    # recovery budgets advance in lockstep (each host
                    # executes each coordinated recovery), so when one
                    # host escalates instead of re-entering the vote
                    # loop, all of them do.
                    raise e.original from e
                except (KeyboardInterrupt, SystemExit):
                    raise
                except SdcPersistentError:
                    # Every rank grades the same gathered rows, so all
                    # leave the loop in the same round (the named rank
                    # already exited SDC_QUARANTINE_EXIT).
                    raise
                except (FloatingPointError, LossSpikeError,
                        SdcDetected) as e:
                    if self._multirank:
                        # tpudp: lint-ok(divergent-collective): this vote
                        # is the mitigation — every rank reaches a vote
                        # each round (clean finishers park at a completion
                        # vote) and the gather is bounded
                        cur_start, cur_skip = self._coordinated_recover(
                            self._vote(OUTCOME_DIVERGENCE), e)
                    else:
                        # tpudp: lint-ok(protocol-order-divergence):
                        # single-host arm of the uniform
                        # `self._multihost` fork — no pod, no
                        # rendezvous; the restore-walk "collectives"
                        # inside _rollback are process_count()==1
                        # identities.
                        cur_start, cur_skip = self._rollback(e)
                except Exception as e:
                    if self._multirank:
                        code = (OUTCOME_HANG if isinstance(e, StepHangError)
                                else OUTCOME_STEP_FAULT)
                        # tpudp: lint-ok(divergent-collective): bounded
                        # vote, the same protocol as the divergence arm
                        cur_start, cur_skip = self._coordinated_recover(
                            self._vote(code), e)
                    else:
                        # tpudp: lint-ok(protocol-order-divergence):
                        # single-host arm, same as the divergence arm's.
                        cur_start, cur_skip = self._step_recover(e)
        finally:
            t._resilience = None
            if t.watchdog is not None:
                t.watchdog.disarm()
            if self._vote_group is not None:
                from torch import distributed as dist

                dist.destroy_process_group(self._vote_group)
                self._vote_group = None
