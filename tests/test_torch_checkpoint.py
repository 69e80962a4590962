"""The port's checkpoints (``tpudp_torch.utils.checkpoint``) and
``state_to_jax``/``load_state``, on the CPU, against the JAX package's
``tpudp/utils/checkpoint.py``.

The JAX package's ``init_state`` for the narrow VGG and the tiny ResNet
(``tests/torch_dp_worker.py``), with drawn statistics, momentum, step
and ``loss_sum``, is carried across and saved by the port: the manifest's entries for params, batch statistics,
step and ``loss_sum`` equal JAX's ``leaf_checksums`` of that state, key
for key, and the momentum's crc32 equals optax's trace's.  GPT-2's
params match the same way through ``restore_params``.  Resume is exact:
a Trainer run of 2 epochs equals 1 epoch, a checkpoint and a fresh
Trainer resuming (momentum, ``loss_sum`` and buffers included), and a run
interrupted mid-epoch by an emergency dump resumes through
``auto_resume`` to the same bits — at world 1 here and at world 2 over
gloo (``job_ckpt``, one spawn for the module), plain and with
``compress='int8_ef'``, whose residuals go back to their ranks; the
rank vote restores the step every rank sees.  The rest mirrors
``tests/test_checkpoint.py``.
"""

import errno
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_worker as w
from tpudp.models.gpt2 import GPT2 as JaxGPT2
from tpudp.models.gpt2 import GPT2Config as JaxGPT2Config
from tpudp.models.resnet import ResNet as JaxResNet
from tpudp.models.vgg import VGG as JaxVGG
from tpudp.train import (init_state as jax_init_state,
                         make_optimizer as jax_make_optimizer)
from tpudp.utils.checkpoint import leaf_checksums as jax_leaf_checksums
from tpudp_torch import train
from tpudp_torch.models import gpt2
from tpudp_torch.resilience import auto_resume
from tpudp_torch.training_faults import InjectedTrainingFault
from tpudp_torch.utils import checkpoint as ck

MODEL_KEYS = (".params", ".batch_stats", ".step", ".loss_sum")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite's workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_state(kind):
    """JAX's ``init_state`` of ``kind``, with numpy-drawn batch
    statistics, momentum, step and loss_sum so that no leaf is trivial;
    as numpy, with its checksums."""
    if kind == "vgg":
        model, (params, stats) = JaxVGG(cfg=w.CFG), w.vgg_init()
    else:
        model = JaxResNet(stage_sizes=w.RESNET_STAGES, num_classes=10,
                          width=w.RESNET_WIDTH)
        params, stats = w.resnet_init()
    rng = np.random.default_rng(8)

    def draw(a):
        return (np.asarray(a) + rng.normal(size=np.shape(a))
                .astype(np.float32) * 0.1)

    tx = jax_make_optimizer(**w.SGD)
    state = jax_init_state(model, tx, input_shape=(1, 32, 32, 3))
    params = jax.tree.map(jnp.asarray, params)
    opt = tx.init(params)
    trace = jax.tree.map(lambda a: jnp.asarray(draw(np.zeros_like(a))),
                         opt[1][0].trace)
    opt = (opt[0], (opt[1][0]._replace(trace=trace),) + opt[1][1:])
    state = state.replace(
        step=jnp.asarray(2, jnp.int32), params=params,
        batch_stats=jax.tree.map(lambda a: jnp.asarray(np.abs(draw(a))),
                                 stats),
        opt_state=opt, loss_sum=jnp.asarray(4.625, jnp.float32))
    return jax.device_get(state), jax_leaf_checksums(state)


@pytest.mark.parametrize("kind", ["vgg", "resnet"])
def test_manifest_equals_jax_leaf_checksums(tmp_path, kind):
    """JAX's state carried across (``load_state``) and saved by the port:
    params, batch statistics, step and loss_sum have JAX's names, dtypes,
    shapes and crc32; the momentum has optax's trace's bytes; and a
    restore gives back what was saved."""
    js, want = _jax_state(kind)
    trace = js.opt_state[1][0].trace
    model = w.bn_model(kind)
    state = train.init_state(model, train.make_optimizer(**w.SGD))
    train.load_state(state, {
        "step": js.step, "params": js.params, "batch_stats": js.batch_stats,
        "opt_state": {"momentum": trace}, "loss_sum": js.loss_sum})
    path = ck.save_checkpoint(tmp_path / "step_2", state)
    got = ck.read_manifest(path)["leaves"]
    assert ck.read_manifest(path)["format"] == 1
    model_keys = {k for k in want if k.startswith(MODEL_KEYS)}
    assert model_keys and {k for k in got if k.startswith(MODEL_KEYS)} \
        == model_keys
    for key in model_keys:
        assert got[key] == want[key], key
    for key, rec in got.items():
        if key.startswith(".opt_state['momentum']"):
            jkey = ".opt_state[1][0].trace" + key[len(
                ".opt_state['momentum']"):]
            assert rec == want[jkey], key
    fresh = train.init_state(w.bn_model(kind), train.make_optimizer(**w.SGD))
    ck.restore_checkpoint(path, fresh, verify=True)
    assert fresh.step == 2
    for (n, a), b in zip(model.state_dict().items(),
                         fresh.model.state_dict().values()):
        assert torch.equal(a, b), n
    for p, q in zip(model.parameters(), fresh.model.parameters()):
        assert torch.equal(state.optimizer.state[p]["momentum_buffer"],
                           fresh.optimizer.state[q]["momentum_buffer"])


def test_gpt2_params_match_through_restore_params(tmp_path):
    """A port-saved GPT-2: ``restore_params`` gives the flax tree by JAX
    names, whose checksums equal JAX's for the same weights."""
    cfg = dict(vocab_size=61, max_seq_len=32, num_layers=2, num_heads=2,
               d_model=32)
    tree = gpt2.random_params(gpt2.GPT2Config(**cfg), 5)
    jstate = jax_init_state(JaxGPT2(JaxGPT2Config(**cfg)),
                            jax_make_optimizer(0.01), input_shape=(1, 8))
    jstate = jstate.replace(params=jax.tree.map(jnp.asarray, tree))
    want = {k: v for k, v in jax_leaf_checksums(jstate).items()
            if k.startswith(".params")}
    model = gpt2.GPT2(gpt2.GPT2Config(**cfg))
    model.load_state_dict(gpt2.params_from_jax(tree))
    state = train.init_state(model, train.make_optimizer(
        learning_rate=0.01, optimizer="adamw"))
    path = ck.save_checkpoint(tmp_path / "step_0", state)
    restored = ck.restore_params(path)
    assert ck.leaf_checksums({"params": restored}) == want
    got = ck.read_manifest(path)["leaves"]
    assert {k: v for k, v in got.items() if k.startswith(".params")} == want
    assert jax.tree.all(jax.tree.map(
        lambda a, b: np.array_equal(a, np.asarray(b)), tree, restored))


def _vgg_run(root, epochs, **fit):
    train_l, test_l = w.ckpt_loaders(0, 1, str(root))
    t = w.ckpt_trainer()
    t.fit(train_l, test_l, epochs, **fit)
    return t, train_l, test_l


def _assert_same(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        elif isinstance(a[k], list):
            assert all(torch.equal(x, y) for x, y in zip(a[k], b[k])), k
        else:
            assert a[k] == b[k], k


def test_resume_is_exact_at_world_1(tmp_path):
    """2 epochs == 1 epoch + step_1 + a fresh Trainer resuming, and ==
    a run cut mid-epoch 1 by an emergency dump, resumed through
    ``auto_resume`` with the fast-forward: parameters, buffers, momentum,
    step and loss_sum bit for bit."""
    a, train_l, test_l = _vgg_run(tmp_path / "a", w.CKPT_EPOCHS)
    want = w.state_of(a)

    root = str(tmp_path / "b")
    b = w.ckpt_trainer()
    b.fit(train_l, test_l, 1, epoch_end_fn=lambda e: ck.save_checkpoint(
        os.path.join(root, f"step_{e + 1}"), b.state))
    b2 = w.ckpt_trainer()
    _, used, skipped = ck.restore_latest_verified(root, b2.state,
                                                  log=lambda s: None)
    assert used.endswith("step_1") and skipped == []
    b2.fit(train_l, test_l, w.CKPT_EPOCHS, start_epoch=1)
    _assert_same(w.state_of(b2), want)

    root = str(tmp_path / "c")
    c = w.ckpt_trainer()
    # 8 train and 2 eval calls an epoch: call 13 is epoch 1's third batch
    c.step_fault_hook = w._dump_then_fail(c, root, len(train_l), 13)
    with pytest.raises(InjectedTrainingFault):
        c.fit(train_l, test_l, w.CKPT_EPOCHS)
    assert ck.emergency_dir(root) is not None
    lines = []
    c2 = w.ckpt_trainer()
    c2.log = lines.append
    start, skip = auto_resume(c2, root, len(train_l), log=lines.append)
    assert (start, skip) == (1, 2)
    assert not os.path.isdir(os.path.join(root, "emergency"))  # consumed
    c2.fit(train_l, test_l, w.CKPT_EPOCHS, start_epoch=start,
           skip_batches_first_epoch=skip)
    assert "[tpudp] fast-forwarded 2 already-trained batches of epoch 1 " \
        "(mid-epoch resume)" in lines
    _assert_same(w.state_of(c2), want)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return w.run_world(tmp_path_factory.mktemp("ckpt2"), 2, ["ckpt"])


@pytest.mark.parametrize("tag", ["plain", "int8_ef"])
@pytest.mark.parametrize("rank", [0, 1])
def test_resume_is_exact_at_world_2(world2, tag, rank):
    """Over two gloo ranks, each rank's resumed runs end bit-equal to its
    uninterrupted run — through step_1 and through a mid-epoch emergency
    dump — and with int8 error feedback every rank gets its own residuals
    back from the stacked ``(2, ...)`` leaves."""
    out = world2[rank]["ckpt"]
    want = out[f"{tag}:A"]
    _assert_same(out[f"{tag}:B"], want)
    _assert_same(out[f"{tag}:C"], want)
    assert out[f"{tag}:resume_at"] == (1, 1)
    _assert_same(out[f"{tag}:restored"], out[f"{tag}:saved"])
    if tag == "int8_ef":
        mine = out[f"{tag}:saved"]["residuals"]
        other = world2[1 - rank]["ckpt"][f"{tag}:saved"]["residuals"]
        assert any(not torch.equal(a, b) for a, b in zip(mine, other))


def test_rank_vote_restores_the_step_every_rank_sees(world2):
    """Rank 1's listing misses step_2: both ranks restore step_1.  Rank 1
    sees no checkpoint: both enter the vote and both fail, none hangs.
    Only rank 0 wrote (no temporary file is left)."""
    for rank in (0, 1):
        out = world2[rank]["ckpt"]
        assert out["vote:used"] == "step_1" and out["vote:step"] == 1
        assert out["vote:entered"] is True
        assert "restorable on every rank" in out["vote:empty"]
    assert world2[0]["ckpt"]["vote:writers"] == [
        "step_1", "step_1.manifest.json", "step_2", "step_2.manifest.json"]


def test_latest_step_dir_ignores_tmp_and_corrupt(tmp_path):
    for name in ("step_3", "step_10", "step_12.corrupt", "step_x",
                 "step_11.tmp", "emergency"):
        (tmp_path / name).mkdir()
    assert ck.latest_step_dir(tmp_path).endswith("step_10")
    assert [os.path.basename(p) for p in
            ck.step_dirs_newest_first(tmp_path)] == ["step_10", "step_3"]
    assert ck.latest_step_dir(tmp_path / "missing") is None


def _small_state(optimizer="sgd", step=0):
    state = train.init_state(w.bn_model("vgg"), train.make_optimizer(
        **w.SGD, optimizer=optimizer))
    state.step = step
    return state


def test_async_writer_roundtrip_and_prune(tmp_path):
    """Async saves land whole (verified restore equals the state as it
    was at ``save()``, though the live state moved on at once); pruning
    to 1 keeps the newest; a writer's error surfaces at the join."""
    state = _small_state()
    frozen = {k: v.clone() for k, v in state.model.state_dict().items()}
    with ck.AsyncCheckpointWriter() as writer:
        writer.save(tmp_path / "step_1", state)
        with torch.no_grad():  # the next step updates in place at once
            for p in state.model.parameters():
                p.add_(1.0)
        writer.save(tmp_path / "step_2", state)
        writer.wait()
        assert writer.last_write_s is not None
    fresh = _small_state()
    ck.restore_checkpoint(tmp_path / "step_1", fresh, verify=True)
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(v, frozen[k]), k
    assert ck.prune_step_dirs(tmp_path, 1) == [str(tmp_path / "step_1")]
    assert sorted(os.listdir(tmp_path)) == ["step_2",
                                            "step_2.manifest.json"]
    (tmp_path / "blocked").write_text("a file where a directory goes")
    writer = ck.AsyncCheckpointWriter()
    writer.save(tmp_path / "blocked", state)
    with pytest.raises(OSError):
        writer.close()


def test_prune_step_dirs(tmp_path):
    state = _small_state()
    for n in range(4):
        ck.save_checkpoint(tmp_path / f"step_{n}", state)
    (tmp_path / "emergency").mkdir()
    deleted = ck.prune_step_dirs(tmp_path, 2)
    assert [os.path.basename(p) for p in deleted] == ["step_0", "step_1"]
    assert sorted(os.listdir(tmp_path)) == [
        "emergency", "step_2", "step_2.manifest.json", "step_3",
        "step_3.manifest.json"]
    with pytest.raises(ValueError):
        ck.prune_step_dirs(tmp_path, 0)


def test_restore_params_ignores_optimizer_structure(tmp_path):
    """The params come back without a target, whatever the optimizer was
    (SGD's momentum or AdamW's two moments and count)."""
    for opt in ("sgd", "adamw"):
        state = _small_state(opt, step=3)
        path = ck.save_checkpoint(tmp_path / f"{opt}/step_3", state)
        params = ck.restore_params(path)
        want, _ = w.vgg_init()
        assert jax.tree.all(jax.tree.map(
            lambda a, b: np.array_equal(a, np.asarray(b)), want, params))
        keys = ck.read_manifest(path)["leaves"]
        assert any(k.startswith(".opt_state['mu']") for k in keys) == (
            opt == "adamw")
    torch.save({"not": torch.zeros(1)}, tmp_path / "bad.pt")
    (tmp_path / "bad").mkdir()
    os.replace(tmp_path / "bad.pt", tmp_path / "bad" / ck.STATE_FILE)
    with pytest.raises(ValueError, match="no 'params'"):
        ck.restore_params(tmp_path / "bad")


def test_adamw_state_round_trips(tmp_path):
    """AdamW's moments and count come back into a fresh optimizer, and
    the next update continues the trajectory bit for bit."""
    x, y = (torch.as_tensor(a) for a in w.vgg_batches(1)[0])
    runs = []
    for resume in (False, True):
        torch.manual_seed(0)
        state = _small_state("adamw")
        step = train.make_train_step(state.model, train.make_optimizer(
            **w.SGD, optimizer="adamw"))
        for _ in range(2):
            state, _ = step(state, x, y)
        if resume:
            path = ck.save_checkpoint(tmp_path / "step_2", state)
            state = _small_state("adamw")
            step = train.make_train_step(state.model, train.make_optimizer(
                **w.SGD, optimizer="adamw"))
            ck.restore_checkpoint(path, state, verify=True)
        state, _ = step(state, x, y)
        runs.append({k: v.clone()
                     for k, v in state.model.state_dict().items()})
    for k in runs[0]:
        assert torch.equal(runs[0][k], runs[1][k]), k


def test_verify_catches_a_flipped_byte(tmp_path):
    from tpudp_torch.training_faults import corrupt_checkpoint

    state = _small_state(step=1)
    path = ck.save_checkpoint(tmp_path / "step_1", state)
    corrupt_checkpoint(path, "flip")
    with pytest.raises(ck.CheckpointCorruptError, match="checksum"):
        ck.restore_checkpoint(path, _small_state(), verify=True)
    path = ck.save_checkpoint(tmp_path / "step_2", state)
    corrupt_checkpoint(path, "manifest")
    with pytest.raises(ck.CheckpointCorruptError, match="checksum"):
        ck.restore_checkpoint(path, _small_state(), verify=True)


def test_force_and_manifest_are_jax_options(tmp_path):
    """``save_checkpoint(path, state, force=True, manifest=True)`` is
    JAX's signature (sync and async): ``force=False`` refuses an
    existing path as orbax does, ``manifest=False`` writes none, and such
    a checkpoint restores with ``verify=True`` vacuously, as JAX's."""
    state = _small_state(step=1)
    path = ck.save_checkpoint(tmp_path / "step_1", state, force=True,
                              manifest=True)
    assert os.path.exists(ck.manifest_path(path))
    with pytest.raises(ValueError, match="already exists"):
        ck.save_checkpoint(path, state, force=False)
    path = ck.save_checkpoint(path, state, manifest=False)  # replaced
    assert not os.path.exists(ck.manifest_path(path))
    assert ck.verify_restored(path, ck.restore_checkpoint(path))[0]
    ck.restore_checkpoint(path, _small_state(), verify=True)
    fresh = ck.save_checkpoint(tmp_path / "new", state, force=False)
    assert os.path.exists(ck.manifest_path(fresh))
    with ck.AsyncCheckpointWriter() as writer:
        a = writer.save(tmp_path / "async", state, manifest=False)
        writer.wait()
        assert not os.path.exists(ck.manifest_path(a))
        with pytest.raises(ValueError, match="already exists"):
            writer.save(a, state, force=False)
        writer.save(a, state, force=True, manifest=True)
    assert os.path.exists(ck.manifest_path(a))


def test_ensure_writable_probe(tmp_path):
    root = ck.ensure_writable(tmp_path / "a" / "b")
    assert os.path.isdir(root) and os.listdir(root) == []
    (tmp_path / "file").write_text("x")
    with pytest.raises(OSError):
        ck.ensure_writable(tmp_path / "file" / "sub")


def test_emergency_sidecars_leave_with_the_dump(tmp_path):
    """Consuming or quarantining a dump moves its manifest with it, so a
    stale manifest is never read against the next dump's bytes."""
    state = _small_state(step=2)
    for action, suffix in ((ck.consume_emergency, ".restored"),
                           (ck.quarantine_emergency, ".corrupt")):
        ck.save_checkpoint(tmp_path / "emergency", state)
        ck.write_emergency_sentinel(tmp_path, step=2, per_epoch_batches=4)
        assert ck.read_emergency_sentinel(tmp_path)["per_epoch_batches"] == 4
        assert ck.emergency_dir(tmp_path) is not None
        action(tmp_path)
        assert not (tmp_path / "emergency.manifest.json").exists()
        assert (tmp_path / f"emergency{suffix}.manifest.json").exists()
        assert ck.read_emergency_sentinel(tmp_path) is None
    (tmp_path / "emergency").mkdir()  # no sentinel, no state file
    assert ck.emergency_dir(tmp_path) is None
    assert (tmp_path / "emergency.truncated").is_dir()


def _flaky(monkeypatch, fails: int, err=errno.EIO):
    calls = {"n": 0}
    real = torch.save

    def save(*a, **k):
        calls["n"] += 1
        if calls["n"] <= fails:
            raise OSError(err, os.strerror(err))
        return real(*a, **k)

    monkeypatch.setattr(ck.torch, "save", save)
    monkeypatch.setattr(ck, "FS_BACKOFF_S", 0.0)
    return calls


def test_retry_fs_recovers_from_transient_eio(monkeypatch):
    monkeypatch.setattr(ck, "FS_BACKOFF_S", 0.0)
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError(errno.EIO, "transient")
        return "ok"

    assert ck._retry_fs(fn) == "ok" and calls["n"] == 3


def test_retry_fs_budget_is_bounded(monkeypatch):
    monkeypatch.setattr(ck, "FS_BACKOFF_S", 0.0)
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        raise OSError(errno.ESTALE, "stale")

    with pytest.raises(OSError):
        ck._retry_fs(fn)
    assert calls["n"] == ck.FS_RETRIES + 1


def test_retry_fs_non_transient_propagates_immediately(monkeypatch):
    monkeypatch.setattr(ck, "FS_BACKOFF_S", 0.0)
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        raise OSError(errno.ENOSPC, "full")

    with pytest.raises(OSError):
        ck._retry_fs(fn)
    assert calls["n"] == 1


def test_save_restore_ride_through_flaky_fs(tmp_path, monkeypatch):
    calls = _flaky(monkeypatch, fails=2)
    state = _small_state(step=1)
    path = ck.save_checkpoint(tmp_path / "step_1", state)
    assert calls["n"] == 3
    fresh = _small_state()
    ck.restore_checkpoint(path, fresh, verify=True)
    assert fresh.step == 1
    assert json.load(open(ck.manifest_path(path)))["format"] == 1


# -- serve_cli --checkpoint-dir ----------------------------------------------

SERVE_GPT2 = ["--layers", "2", "--d-model", "32", "--heads", "2", "--vocab",
              "61", "--seq-len", "64"]
SERVE_LLAMA = ["--family", "llama", "--layers", "2", "--d-model", "32",
               "--heads", "4", "--kv-heads", "2", "--vocab", "61",
               "--seq-len", "64"]


@pytest.fixture(scope="module")
def served_checkpoints(tmp_path_factory):
    """A tiny GPT-2 trained 2 steps by ``train_cli --save-checkpoint`` and
    a tiny LLaMA-GQA state saved by the port."""
    from tpudp_torch import train_cli
    from tpudp_torch.models import llama

    root = tmp_path_factory.mktemp("served")
    gdir = str(root / "gpt2")
    run = train_cli.train(train_cli.parse_args(
        ["--device", "cpu", "--batch-size", "2", "--steps", "2",
         "--log-every", "1", "--save-checkpoint", gdir] + SERVE_GPT2))
    assert run["checkpoint"] == os.path.join(gdir, "step_2")
    cfg = llama.LlamaConfig(vocab_size=61, max_seq_len=64, num_layers=2,
                            num_heads=4, num_kv_heads=2, d_model=32)
    tree = jax.tree.map(lambda a: a * 5 if a.ndim == 2 else a,
                        llama.random_params(cfg, 7))
    model = llama.Llama(cfg)
    model.load_state_dict(llama.params_from_jax(tree))
    ldir = str(root / "llama")
    ck.save_checkpoint(os.path.join(ldir, "step_0"), train.init_state(
        model, train.make_optimizer(0.01)))
    return {"gpt2": gdir, "llama": ldir}


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_serve_cli_checkpoint_tokens_equal_jax_engine(served_checkpoints,
                                                      family, capsys):
    """The restored params, served by ``serve_cli --checkpoint-dir`` on
    the paged engine, give JAX's engine's greedy tokens on the same
    params (read back by ``restore_params``) and prompts."""
    from tpudp.models.gpt2 import gpt2_small as jax_gpt2_small
    from tpudp.models.llama import llama_small as jax_llama_small
    from tpudp.serve import Engine as JaxEngine
    from tpudp_torch import serve_cli

    root = served_checkpoints[family]
    flags = SERVE_GPT2 if family == "gpt2" else SERVE_LLAMA
    out = serve_cli.main(["--device", "cpu", "--paged", "32",
                          "--requests", "3", "--max-new-tokens", "5",
                          "--prefill-chunk", "8", "--checkpoint-dir", root]
                         + flags)
    assert f"restored params from {ck.latest_step_dir(root)}" in \
        capsys.readouterr().out
    params = jax.tree.map(jnp.asarray, ck.restore_params(
        ck.latest_step_dir(root)))
    if family == "gpt2":
        jmodel = jax_gpt2_small(vocab_size=61, max_seq_len=64, num_layers=2,
                                num_heads=2, d_model=32)
    else:
        jmodel = jax_llama_small(vocab_size=61, max_seq_len=64,
                                 num_layers=2, num_heads=4, num_kv_heads=2,
                                 d_model=32)
    eng = JaxEngine(jmodel, params, num_slots=3, prefill_chunk=8,
                    kv_pages=32, paged_attn="einsum")
    handles = [eng.submit(p, 5) for p in out["prompts"]]
    eng.run_until_complete()
    assert out["tokens"] == [h.tokens for h in handles]


SERVE_MISMATCHES = [
    ("gpt2", ["--family", "llama", "--kv-heads", "2"] + SERVE_GPT2[:6]
     + ["--seq-len", "64"], "llama-family|gpt2-family"),
    ("gpt2", ["--layers", "3"] + SERVE_GPT2[2:], "holds 2 layers"),
    ("gpt2", SERVE_GPT2[:-1] + ["128"], "holds wpe"),
    ("gpt2", ["--layers", "2", "--d-model", "32", "--heads", "2",
              "--vocab", "64", "--seq-len", "64"], r"wte \(61, 32\)"),
    ("llama", ["--family", "llama", "--layers", "2", "--d-model", "32",
               "--heads", "4", "--kv-heads", "4", "--vocab", "61",
               "--seq-len", "64"], "wk width"),
    ("llama", SERVE_GPT2, "llama-family checkpoint"),
]


@pytest.mark.parametrize("family,flags,message", SERVE_MISMATCHES,
                         ids=["family", "layers", "seq-len", "vocab",
                              "kv-heads", "gpt2-flags"])
def test_serve_cli_checkpoint_mismatch_exits(served_checkpoints, family,
                                             flags, message):
    from tpudp_torch import serve_cli

    root = served_checkpoints[family]
    with pytest.raises(SystemExit, match=message) as ei:
        serve_cli.main(["--device", "cpu", "--paged", "32",
                        "--checkpoint-dir", root] + flags)
    assert str(ei.value).startswith("error:")
    if "family" not in message:
        assert ck.latest_step_dir(root) in str(ei.value)


def test_serve_cli_empty_checkpoint_dir_exits(tmp_path):
    from tpudp_torch import serve_cli

    with pytest.raises(SystemExit, match="no step_N checkpoint"):
        serve_cli.main(["--device", "cpu", "--checkpoint-dir",
                        str(tmp_path)] + SERVE_GPT2)
