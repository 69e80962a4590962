"""The port's in-process supervisor (``tpudp_torch.resilience``), fault
injectors (``tpudp_torch.training_faults``) and ``skip_nonfinite``, on the
CPU — the counterpart of ``tests/test_resilience.py``.

Every recovery restores a checkpoint and replays, so the final state is
BIT-equal to an uninterrupted run: the narrow VGG of
``tests/torch_dp_worker.py`` trains 2 epochs of 4 batches of 16
synthetic images (windows of 2) under ``fit(resilience=)`` with a NaN
batch, a loss spike, a raising step, a stalled step under a
``kill=False`` watchdog, or a failing loader behind a Prefetcher; each
budget, once spent, escalates the original error.  At world 2 over gloo
(``job_resilience``, one spawn) the ranks vote each recovery and end
bit-equal to their clean run; a step fault on one rank alone ends both
ranks through the bounded vote instead of hanging.  ``make_optimizer(skip_nonfinite=N)`` is
held to JAX's ``optax.apply_if_finite`` step on the same NaN batch.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_worker as w
from tpudp.models.vgg import VGG as JaxVGG
from tpudp.train import (init_state as jax_init_state,
                         make_optimizer as jax_make_optimizer,
                         make_train_step as jax_make_train_step)
from tpudp_torch import train
from tpudp_torch.data import DataLoader, Prefetcher, load_cifar10
from tpudp_torch.models import vgg
from tpudp_torch.resilience import (OUTCOME_DIVERGENCE, OUTCOME_HANG,
                                    OUTCOME_OK, OUTCOME_STEP_FAULT,
                                    VOTE_TIMEOUT_EXIT, ResiliencePolicy,
                                    Supervisor,
                                    auto_resume, make_emergency_dump,
                                    reduce_outcomes)
from tpudp_torch.training_faults import (CorruptingLoader,
                                         InjectedTrainingFault,
                                         RaisingLoader, RaisingStep,
                                         StallingStep, corrupt_checkpoint)
from tpudp_torch.utils import checkpoint as ck
from tpudp_torch.utils.watchdog import Watchdog


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite's workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _set(tmp_root, n, seed=3):
    train_set, _, _ = load_cifar10(os.path.join(str(tmp_root), "none"),
                                   synthetic_train_size=n,
                                   synthetic_test_size=16)
    return train_set


def _loader(nan_at=(), loader_fail=(), prefetch=False):
    ld = DataLoader(_set("/nonexistent", 64), 16, train=True, seed=2,
                    backend="numpy")
    if nan_at:
        ld = CorruptingLoader(ld, nan_at=nan_at)
    if loader_fail:
        ld = RaisingLoader(ld, fail_at=loader_fail)
    if prefetch:
        ld = Prefetcher(ld, depth=2)
    return ld


def _trainer(hook=None, watchdog=None):
    return w.ckpt_trainer(step_fault_hook=hook, watchdog=watchdog)


def _run(ckpt_dir, *, epochs=2, policy_kw=None, hook=None, watchdog=None,
         spike_at=None, **loader_kw):
    tr = _trainer(hook=hook, watchdog=watchdog)
    if spike_at is not None:
        _spike_after(tr, spike_at)
    pol = (ResiliencePolicy(checkpoint_dir=str(ckpt_dir), spike_factor=4.0,
                            spike_min_history=1, **(policy_kw or {}))
           if ckpt_dir is not None else None)
    tr.fit(_loader(**loader_kw), epochs=epochs, resilience=pol)
    return tr


def _spike_after(tr, call: int) -> None:
    """A finite loss spike on the device: the ``call``-th train step's
    loss is 1e4 too high, once (BatchNorm would normalize away a scaled
    batch, so the spike is put where the window reads the loss)."""
    step, calls = tr.train_step, [0]

    def spiking(state, x, y):
        state, loss = step(state, x, y)
        calls[0] += 1
        if calls[0] == call:
            state.loss_sum += 1e4
        return state, loss

    tr.train_step = spiking


def _final(tr) -> dict:
    return w.state_of(tr)


def _same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor)
        else a[k] == b[k] for k in a)


@pytest.fixture(scope="module")
def clean(tmp_path_factory):
    """The uninterrupted 2-epoch run every recovery must match."""
    return _final(_run(tmp_path_factory.mktemp("clean")))


def test_resilience_none_is_default_and_inert(tmp_path):
    tr = _run(None)
    assert tr.stats == {} and tr._resilience is None
    assert os.listdir(tmp_path) == []


def test_supervised_clean_run_equals_the_unsupervised(clean):
    """The supervisor adds checkpoints, not numerics."""
    assert _same(_final(_run(None)), clean)


def test_nan_window_rolls_back_bit_exact(tmp_path, clean):
    tr = _run(tmp_path, nan_at={5})
    assert tr.stats["rollbacks"] == 1
    assert _same(_final(tr), clean)
    rb = next(e for e in tr.stats["events"] if e["kind"] == "rollback")
    assert "FloatingPointError" in rb["error"]


def test_loss_spike_rolls_back_bit_exact(tmp_path, clean):
    tr = _run(tmp_path, spike_at=6)
    assert tr.stats["rollbacks"] == 1
    assert any(e["kind"] == "loss_spike" for e in tr.stats["events"])
    assert _same(_final(tr), clean)


def test_step_fault_retries_in_process_bit_exact(tmp_path, clean):
    """A raising step takes the emergency-dump path, restores and goes on
    in the same process; the dump is consumed."""
    tr = _run(tmp_path, hook=RaisingStep(fail_at={6}))
    assert tr.stats["step_retries"] == 1
    assert _same(_final(tr), clean)
    assert not os.path.isdir(tmp_path / "emergency")
    assert os.path.isdir(tmp_path / "emergency.restored")
    ev = next(e for e in tr.stats["events"] if e["kind"] == "step_retry")
    assert ev["hang"] is False and ev["restored"].endswith("emergency")


def test_hang_recovers_in_process_and_rearms(tmp_path, clean):
    wd = Watchdog(timeout_s=0.8, kill=False, poll_s=0.05).start()
    try:
        tr = _run(tmp_path, hook=StallingStep({6}, delay_s=1.6),
                  watchdog=wd)
    finally:
        wd.stop()
    hangs = [e for e in tr.stats["events"]
             if e["kind"] == "step_retry" and e["hang"]]
    assert hangs and tr.stats["step_retries"] >= 1
    assert _same(_final(tr), clean)


def test_loader_fault_restarts_at_exact_offset(tmp_path, clean):
    """A failure in the Prefetcher's worker restarts the pipeline and
    replays to the exact batch (draw 5 is batch 1 of epoch 1)."""
    tr = _run(tmp_path, loader_fail={5}, prefetch=True)
    assert tr.stats["loader_restarts"] == 1
    assert _same(_final(tr), clean)
    ev = next(e for e in tr.stats["events"]
              if e["kind"] == "loader_restart")
    assert ev["epoch"] == 1 and ev["offset"] == 1


def test_rollback_budget_exhaustion_escalates_original(tmp_path):
    tr = _trainer()
    with pytest.raises(FloatingPointError, match="non-finite"):
        tr.fit(_loader(nan_at=range(5, 10 ** 6)), epochs=2,
               resilience=ResiliencePolicy(checkpoint_dir=str(tmp_path),
                                           max_rollbacks=2))
    assert tr.stats["rollbacks"] == 2
    assert any(e["kind"] == "rollback_escalation"
               for e in tr.stats["events"])


def test_same_step_second_failure_escalates(tmp_path):
    tr = _trainer(hook=RaisingStep(persist_from=6))
    with pytest.raises(InjectedTrainingFault):
        tr.fit(_loader(), epochs=2,
               resilience=ResiliencePolicy(checkpoint_dir=str(tmp_path)))
    assert tr.stats["step_retries"] == 1
    assert any(e["kind"] == "step_escalation" for e in tr.stats["events"])


def test_loader_budget_exhaustion_escalates_original(tmp_path):
    tr = _trainer()
    with pytest.raises(InjectedTrainingFault):
        tr.fit(_loader(loader_fail=range(5, 10 ** 6)), epochs=2,
               resilience=ResiliencePolicy(checkpoint_dir=str(tmp_path),
                                           max_loader_restarts=2))
    assert tr.stats["loader_restarts"] == 2


def test_eval_fault_replays_missed_epoch_end(tmp_path, clean):
    """A fault in an epoch's eval resumes at the next epoch boundary; the
    supervisor replays the missed eval and epoch end, so that epoch's
    checkpoint is written."""
    test_loader = DataLoader(_set("/nonexistent", 32), 16, train=False,
                             backend="numpy")
    saved = []
    # 4 train batches an epoch: the eval after epoch 0 is device call 5
    tr = _trainer(hook=RaisingStep(fail_at={5}, kind="eval"))
    tr.fit(_loader(), test_loader, epochs=2,
           epoch_end_fn=lambda e: saved.append(e),
           resilience=ResiliencePolicy(checkpoint_dir=str(tmp_path)))
    assert tr.stats["step_retries"] == 1
    assert saved == [0, 1]
    assert (tmp_path / "step_1").is_dir() and (tmp_path / "step_2").is_dir()
    assert _same(_final(tr), clean)


def test_corrupt_newest_checkpoint_falls_back(tmp_path):
    """A flipped newest checkpoint is quarantined and the walk falls back;
    tampered manifests and torn files are rejected the same way, and with
    every dir corrupt the walk refuses loudly."""
    tr = _run(tmp_path)  # step_0..step_2
    corrupt_checkpoint(tmp_path / "step_2", mode="flip")
    fresh = _trainer()
    _, path, skipped = ck.restore_latest_verified(str(tmp_path), fresh.state,
                                                  log=lambda s: None)
    assert path.endswith("step_1") and len(skipped) == 1
    assert fresh.state.step == 4
    assert not (tmp_path / "step_2").is_dir()
    assert (tmp_path / "step_2.corrupt").is_dir()
    assert (tmp_path / "step_2.corrupt.manifest.json").exists()
    _, path, skipped = ck.restore_latest_verified(str(tmp_path), fresh.state,
                                                  log=lambda s: None)
    assert path.endswith("step_1") and skipped == []
    corrupt_checkpoint(tmp_path / "step_1", mode="manifest")
    corrupt_checkpoint(tmp_path / "step_0", mode="truncate")
    with pytest.raises(RuntimeError, match="restorable"):
        ck.restore_latest_verified(str(tmp_path), tr.state,
                                   log=lambda s: None)
    with pytest.raises(FileNotFoundError):
        ck.restore_latest_verified(str(tmp_path / "empty"), tr.state)


def test_in_fit_rollback_survives_corrupt_newest(tmp_path, clean):
    """The supervisor's rollback walks past a corrupt newest checkpoint
    mid-fit (counted in ``ckpt_fallbacks``) and still lands bit-exact."""
    tr = _trainer()
    tr.fit(_loader(), epochs=1,
           resilience=ResiliencePolicy(checkpoint_dir=str(tmp_path)))
    corrupt_checkpoint(tmp_path / "step_1", mode="flip")
    # NaN at draw 2: epoch 1's third batch (a fresh loader's counter)
    tr.fit(_loader(nan_at={2}), epochs=2, start_epoch=1,
           resilience=ResiliencePolicy(checkpoint_dir=str(tmp_path)))
    assert tr.stats["rollbacks"] == 1 and tr.stats["ckpt_fallbacks"] >= 1
    assert _same(_final(tr), clean)


def test_prune_never_deletes_last_verified(tmp_path):
    state = _trainer().state
    ck.save_checkpoint(tmp_path / "step_1", state)
    ck.save_checkpoint(tmp_path / "step_2", state)
    (tmp_path / "step_3").mkdir()  # torn: no state file, no manifest
    (tmp_path / "step_4").mkdir()
    deleted = ck.prune_step_dirs(tmp_path, keep=2)
    assert sorted(os.path.basename(d) for d in deleted) == ["step_1"]
    assert (tmp_path / "step_2").is_dir()
    assert os.path.exists(ck.manifest_path(tmp_path / "step_2"))
    assert not os.path.exists(ck.manifest_path(tmp_path / "step_1"))


def test_outcome_reduction_and_single_rank_vote_identity(tmp_path):
    assert (OUTCOME_OK < OUTCOME_STEP_FAULT < OUTCOME_HANG
            < OUTCOME_DIVERGENCE)
    assert reduce_outcomes([OUTCOME_OK, OUTCOME_OK]) == OUTCOME_OK
    assert reduce_outcomes([OUTCOME_OK, OUTCOME_DIVERGENCE]) == \
        OUTCOME_DIVERGENCE
    assert reduce_outcomes([OUTCOME_HANG, OUTCOME_STEP_FAULT]) == \
        OUTCOME_HANG
    sup = Supervisor(_trainer(), ResiliencePolicy(checkpoint_dir=str(
        tmp_path)))
    assert not sup._multirank
    for code in (OUTCOME_OK, OUTCOME_DIVERGENCE):
        assert sup._vote(code) == code
    assert sup._vote_seq == 0
    assert ck.all_ranks_ok(True) and not ck.all_ranks_ok(False)
    assert ck.coordinated_any(True) and not ck.coordinated_any(False)
    with pytest.raises(ValueError, match="checkpoint_dir"):
        Supervisor(_trainer(), ResiliencePolicy(checkpoint_dir=""))


def test_eval_nan_fails_loudly_with_context():
    tr = _trainer()
    with torch.no_grad():
        for p in tr.model.parameters():
            p.fill_(float("nan"))
    ld = DataLoader(_set("/nonexistent", 32), 16, train=False,
                    backend="numpy")
    with pytest.raises(FloatingPointError) as ei:
        tr.evaluate(ld, epoch=3)
    msg = str(ei.value)
    assert "eval loss" in msg and "epoch 3" in msg and "eval batches" in msg


def test_emergency_dump_waits_for_async_writer(tmp_path, monkeypatch):
    order = []

    class FakeWriter:
        def wait(self):
            order.append("wait")

    class FakeState:
        step = 7

    monkeypatch.setattr(ck, "clear_emergency_sentinel",
                        lambda root: order.append("clear"))
    monkeypatch.setattr(ck, "save_checkpoint",
                        lambda path, state: order.append("save"))
    monkeypatch.setattr(ck, "write_emergency_sentinel",
                        lambda root, step=None, per_epoch_batches=None:
                        order.append("sentinel"))
    make_emergency_dump(str(tmp_path), lambda: FakeState(), 10,
                        async_writer=FakeWriter(), log=lambda s: None)()
    assert order == ["clear", "wait", "save", "sentinel"]


def test_auto_resume_prefers_emergency_and_falls_back(tmp_path):
    tr = _run(tmp_path)  # step_0..step_2 on 4 batches an epoch
    tr.state.step = 6  # as if dumped two batches into epoch 1
    ck.save_checkpoint(tmp_path / "emergency", tr.state)
    ck.write_emergency_sentinel(tmp_path, step=6, per_epoch_batches=4)
    tr2 = _trainer()
    assert auto_resume(tr2, str(tmp_path), 4, log=lambda s: None) == (1, 2)
    assert not (tmp_path / "emergency").is_dir()
    assert (tmp_path / "emergency.restored").is_dir()

    ck.save_checkpoint(tmp_path / "emergency", tr.state)
    ck.write_emergency_sentinel(tmp_path, step=6, per_epoch_batches=4)
    corrupt_checkpoint(tmp_path / "emergency", mode="flip")
    tr3 = _trainer()
    assert auto_resume(tr3, str(tmp_path), 4, log=lambda s: None) == (2, 0)
    assert (tmp_path / "emergency.corrupt").is_dir()
    assert auto_resume(_trainer(), str(tmp_path / "none"), 4) == (0, 0)


# -- world 2 over gloo -----------------------------------------------------

@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return w.run_world(tmp_path_factory.mktemp("res2"), 2, ["resilience"])


@pytest.mark.parametrize("case,counter", [("nan", "rollbacks"),
                                          ("step", "step_retries"),
                                          ("loader", "loader_restarts")])
def test_voted_recovery_is_bit_exact_at_world_2(world2, case, counter):
    """A NaN batch on rank 0 alone (the all-reduced loss carries it to
    both), a step fault on both ranks and a loader fault on both: the
    ranks vote, recover together and end bit-equal to their clean run;
    each counter reads one on each rank."""
    for rank in (0, 1):
        out = world2[rank]["resilience"]
        got, want = dict(out[case]), dict(out["clean"])
        stats, events = got.pop("stats"), got.pop("events")
        want.pop("stats"), want.pop("events")
        assert _same(got, want), (rank, case)
        assert stats[counter] == 1, (rank, case, stats)
        if case != "loader":
            assert "vote" in events


def test_one_rank_step_fault_exits_and_does_not_hang(tmp_path):
    """A step fault on rank 1 alone at world 2: rank 0 waits inside the
    step's all-reduce and never votes.  Rank 1's vote, on a group of its
    own, times out and it exits with VOTE_TIMEOUT_EXIT; rank 0's
    all-reduce then fails on the closed connection and its vote exits
    alike — no rank hangs and no rank recovers alone."""
    codes, logs = w.launch_world(tmp_path, 2, ["lone_fault"], timeout=120)
    assert codes == [VOTE_TIMEOUT_EXIT] * 2, (codes, logs)
    assert (f"recovery vote 1 got no answer (no peer joined within "
            f"{w.LONE_FAULT_VOTE_TIMEOUT}s)") in logs[1], logs[1]
    assert "recovery vote 1 got no answer (vote collective failed" \
        in logs[0], logs[0]


def test_cli_resilience_at_several_ranks_needs_step_timeout(tmp_path):
    """The watchdog's hard exit is what ends a rank wedged in a device
    collective, so ``--resilience`` at more than one rank needs
    ``--step-timeout``; one rank (Part 1) does not."""
    from tpudp_torch import cli

    flags = ["--device", "cpu", "--resilience", "--checkpoint-dir",
             str(tmp_path)]
    for extra in (["--num-devices", "2"],
                  ["--master", "127.0.0.1", "--num-nodes", "2", "--rank",
                   "0"]):
        with pytest.raises(SystemExit, match="needs --step-timeout"):
            cli.run_part("allreduce", "Part 2b", argv=flags + extra)


# -- skip_nonfinite against optax.apply_if_finite --------------------------

def _skip_batches():
    batches = w.vgg_batches(1) + w.vgg_batches(1, seed=40)
    x = [b[0].copy() for b in batches]
    x[1][:] = np.nan  # steps 2, 4 and 5 see NaN gradients
    x[3][:] = np.nan
    x[4][:] = np.nan
    return list(zip(x, [b[1] for b in batches]))


@pytest.mark.parametrize("max_errors", [1, 2])
def test_skip_nonfinite_matches_jax(max_errors):
    """A step whose gradients are not finite leaves params and optimizer
    state untouched (batch statistics, step and loss_sum move on, as in
    JAX), the counters match optax's ``apply_if_finite`` state, and after
    ``max_errors`` consecutive bad steps the NaN goes through."""
    params, stats = w.vgg_init()
    tx = jax_make_optimizer(**w.SGD, skip_nonfinite=max_errors)
    jmodel = JaxVGG(cfg=w.CFG)
    js = jax_init_state(jmodel, tx, input_shape=(1, 32, 32, 3)).replace(
        params=jax.tree.map(jnp.asarray, params),
        batch_stats=jax.tree.map(jnp.asarray, stats))
    js = js.replace(opt_state=tx.init(js.params))
    jstep = jax_make_train_step(jmodel, tx, None, donate=False)
    model = w.bn_model("vgg")
    spec = train.make_optimizer(**w.SGD, skip_nonfinite=max_errors)
    state = train.init_state(model, spec)
    step = train.make_train_step(model, spec)
    for i, (x, y) in enumerate(_skip_batches()):
        before = {k: v.clone() for k, v in model.named_parameters()}
        js, _ = jstep(js, jnp.asarray(x), jnp.asarray(y))
        state, _ = step(state, torch.as_tensor(x), torch.as_tensor(y))
        jo = js.opt_state
        assert int(state.skip["notfinite_count"]) == int(jo.notfinite_count)
        assert int(state.skip["total_notfinite"]) == int(jo.total_notfinite)
        assert bool(state.skip["last_finite"]) == bool(jo.last_finite)
        applied = bool(jo.last_finite) or int(jo.notfinite_count) > \
            max_errors
        got = vgg.params_to_jax(dict(model.named_parameters()))[0]
        pairs = []
        for (kp, a) in jax.tree_util.tree_flatten_with_path(js.params)[0]:
            b = got
            for key in kp:
                b = b[key.key]
            pairs.append((np.asarray(a), b.detach().numpy()))
        # NaN reaches different leaves (XLA's max drops it where torch's
        # ReLU keeps it), but it goes through in both at the same step.
        nan = [np.isnan(a).any() for a, _ in pairs]
        assert any(nan) == any(np.isnan(b).any() for _, b in pairs), i
        if not any(nan):
            for a, b in pairs:
                np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
        if not applied:
            for k, v in model.named_parameters():
                assert torch.equal(v, before[k]), (i, k)
        assert state.step == int(js.step) == i + 1


def test_skip_nonfinite_refusals():
    """JAX's two refusals; a schedule beside ``skip_nonfinite`` (once
    refused) constructs, with optax's inner count on the device."""
    with pytest.raises(ValueError, match="compress"):
        train.make_optimizer(skip_nonfinite=2, compress="int8_ef")
    with pytest.raises(ValueError, match=">= 1"):
        train.make_optimizer(skip_nonfinite=0)
    spec = train.make_optimizer(skip_nonfinite=2, schedule="cosine",
                                total_steps=4)
    jax_make_optimizer(skip_nonfinite=2, schedule="cosine", total_steps=4)
    state = train.init_state(w.bn_model("vgg"), spec)
    assert int(state.skip["schedule_count"]) == 0


def _jax_leaf(tree, name: str):
    """The first leaf of a pytree whose path names ``name``."""
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        if name in jax.tree_util.keystr(path):
            return leaf
    raise KeyError(name)


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
@pytest.mark.parametrize("schedule,warmup", [("cosine", 1), ("linear", 2)])
def test_skip_nonfinite_schedule_matches_optax(schedule, warmup, optimizer):
    """``skip_nonfinite=2`` under a learning-rate schedule: optax's
    ``apply_if_finite`` holds the inner schedule's count back on a skipped
    step, so every later update's learning rate is the schedule at the
    count of APPLIED updates.  The port keeps that count on the device
    (``skip["schedule_count"]``) and computes the rate there: its count
    equals optax's after every step, and the parameters follow JAX's
    trajectory at rtol 1e-5 through three skipped steps (a count
    advanced on a skip would move the cosine rate by 6-40%).  The update
    is the one a card runs: SGD's by hand (``train._sgd_update``: weight
    decay, the momentum trace, the step at the tensor rate) and AdamW's
    with a tensor learning rate.  Each step is also held to plain
    ``torch.optim`` at a float rate, stepped only on the applied updates
    with optax's count (``_ref``), at rtol 1e-5.  Against JAX, AdamW's
    convolution biases are left to that reference: a bias feeding a
    BatchNorm has a gradient of 0 in exact arithmetic, and AdamW turns
    each framework's rounding noise there into a step of about ``lr``
    of either sign."""
    params, stats = w.vgg_init()
    opt = (dict(w.SGD) if optimizer == "sgd" else
           dict(learning_rate=1e-3, weight_decay=1e-4, optimizer="adamw"))
    sched = dict(schedule=schedule, warmup_steps=warmup, total_steps=8)
    kw = dict(opt, skip_nonfinite=2, **sched)
    tx = jax_make_optimizer(**kw)
    jmodel = JaxVGG(cfg=w.CFG)
    js = jax_init_state(jmodel, tx, input_shape=(1, 32, 32, 3)).replace(
        params=jax.tree.map(jnp.asarray, params),
        batch_stats=jax.tree.map(jnp.asarray, stats))
    js = js.replace(opt_state=tx.init(js.params))
    jstep = jax_make_train_step(jmodel, tx, None, donate=False)
    model = w.bn_model("vgg")
    spec = train.make_optimizer(**kw)
    state = train.init_state(model, spec)
    step = train.make_train_step(model, spec)
    # the reference: no skip, the float rate lr_at(step) at the count of
    # applied updates (its own step counter)
    ref = w.bn_model("vgg")
    ref_spec = train.make_optimizer(**opt, **sched)
    ref_state = train.init_state(ref, ref_spec)
    ref_step = train.make_train_step(ref, ref_spec)
    for i, (x, y) in enumerate(_skip_batches()):
        js, _ = jstep(js, jnp.asarray(x), jnp.asarray(y))
        state, _ = step(state, torch.as_tensor(x), torch.as_tensor(y))
        count = int(_jax_leaf(js.opt_state.inner_state, "count"))
        assert int(state.skip["schedule_count"]) == count, i
        if count > ref_state.step:  # an applied update
            ref_state, _ = ref_step(ref_state, torch.as_tensor(x),
                                    torch.as_tensor(y))
        want = dict(ref.named_parameters())
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(),
                                       want[name].detach().numpy(),
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"{name} step {i}")
        got = vgg.params_to_jax(dict(model.named_parameters()))[0]
        for kp, a in jax.tree_util.tree_flatten_with_path(js.params)[0]:
            if optimizer == "adamw" and kp[0].key.startswith("Conv") \
                    and kp[-1].key == "bias":
                continue
            b = got
            for key in kp:
                b = b[key.key]
            np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                       rtol=1e-5, atol=1e-6)
    assert int(state.skip["schedule_count"]) == 3  # 6 steps, 3 skipped
