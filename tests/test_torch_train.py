"""The port's single-device training (``tpudp_torch.train``) against the
JAX package's ``make_train_step``, on the CPU.

A tiny GPT-2 (vocab 61, 2 layers, 2 heads, d 32, t 128 — so the flash
dispatch engages; batch 2) starts from one numpy weight tree in both
frameworks and trains on the same numpy token batches.  Per-step losses
and the final parameters agree in float32 within the atol each test
states; the flash attention runs as the JAX package's own tests run it
on the CPU (Pallas interpret mode) and, in the port, as the kernels'
plain versions.  Each JAX step program is built once per module.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpudp.models.gpt2 import gpt2_small as jax_gpt2_small
from tpudp.train import (init_state as jax_init_state,
                         make_optimizer as jax_make_optimizer,
                         make_train_step as jax_make_train_step)
from tpudp_torch import train, train_cli
from tpudp_torch.models import gpt2, llama
from tpudp_torch.models.generate import generate
from tpudp_torch.serve import Engine

CFG = dict(vocab_size=61, max_seq_len=128, num_layers=2, num_heads=2,
           d_model=32)
T, BATCH = 128, 2
SGD = dict(learning_rate=0.01, momentum=0.9, weight_decay=1e-4)
ADAMW = dict(learning_rate=1e-2, weight_decay=1e-2, optimizer="adamw",
             clip_norm=0.5, schedule="cosine", warmup_steps=1, total_steps=4)


def _tree(seed=31):
    return gpt2.random_params(gpt2.GPT2Config(**CFG), seed)


def _batches(seed, n, batch=BATCH):
    tok = np.random.default_rng(seed).integers(0, CFG["vocab_size"],
                                               size=(n, batch, T + 1))
    return [(t[:, :-1], t[:, 1:]) for t in tok]


def _jax_run(tree, batches, opt, attn_impl, grad_accum=1):
    """Train the JAX model from ``tree``: per-step losses and the final
    params carried into a port state dict."""
    model = jax_gpt2_small(**CFG, attn_impl=attn_impl)
    tx = jax_make_optimizer(**opt)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    state = jax_init_state(model, tx, input_shape=(1, T)).replace(
        params=params, opt_state=tx.init(params))
    step = jax_make_train_step(model, tx, None, "none", spmd_mode="single",
                               donate=False, grad_accum=grad_accum)
    losses = []
    for x, y in batches:
        state, loss = step(state, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(loss))
    np.testing.assert_allclose(float(state.loss_sum), sum(losses),
                               rtol=1e-6)
    return losses, gpt2.params_from_jax(jax.device_get(state.params))


def _torch_model(tree, attn_impl):
    model = gpt2.GPT2(gpt2.GPT2Config(**CFG, attn_impl=attn_impl))
    model.load_state_dict(gpt2.params_from_jax(tree))
    return model


def _torch_run(tree, batches, opt, attn_impl, grad_accum=1):
    model = _torch_model(tree, attn_impl)
    spec = train.make_optimizer(**opt)
    state = train.init_state(model, spec)
    step = train.make_train_step(model, spec, grad_accum=grad_accum)
    losses = []
    for x, y in batches:
        state, loss = step(state, torch.as_tensor(x), torch.as_tensor(y))
        losses.append(loss)
    assert state.step == len(batches)
    assert torch.is_tensor(state.loss_sum)
    torch.testing.assert_close(state.loss_sum, torch.stack(losses).sum())
    return [float(x) for x in losses], model.state_dict()


@pytest.fixture(scope="module")
def jax_runs():
    """Every JAX trajectory this module compares against, built once."""
    tree = _tree()
    return {
        "sgd": _jax_run(tree, _batches(1, 3), SGD, "flash"),
        "adamw": _jax_run(tree, _batches(2, 3), ADAMW, "flash"),
        "accum": _jax_run(tree, _batches(3, 2, batch=4), SGD, "dense",
                          grad_accum=2),
    }


@pytest.mark.parametrize("case,opt,attn,accum,seed,n,batch", [
    ("sgd", SGD, "flash", 1, 1, 3, BATCH),
    ("adamw", ADAMW, "flash", 1, 2, 3, BATCH),
    ("accum", SGD, "dense", 2, 3, 2, 4),
])
def test_trajectory_matches_jax(jax_runs, case, opt, attn, accum, seed, n,
                                batch):
    """Per-step losses (atol 2e-5) and final params (atol 1e-4) of the
    port's step against JAX ``make_train_step`` from the same weights and
    batches: SGD (lr 0.01, momentum 0.9, wd 1e-4) through flash
    attention; AdamW with clip_norm 0.5 (the first step's gradient norm
    is 0.63, so the clip engages) and a cosine schedule with one warm-up
    step, through flash; SGD with ``grad_accum=2`` over a batch of 4."""
    want_losses, want_params = jax_runs[case]
    losses, params = _torch_run(_tree(), _batches(seed, n, batch), opt, attn,
                                grad_accum=accum)
    np.testing.assert_allclose(losses, want_losses, atol=2e-5, rtol=0)
    for name, value in params.items():
        np.testing.assert_allclose(value.numpy(), want_params[name].numpy(),
                                   atol=1e-4, rtol=0, err_msg=name)


def test_grad_accum_equals_one_big_batch():
    """Two equal microbatches give the one-shot step's loss and update
    (float32 round-off apart)."""
    tree, batches = _tree(), _batches(4, 1, batch=4)
    one, p_one = _torch_run(tree, batches, SGD, "dense")
    two, p_two = _torch_run(tree, batches, SGD, "dense", grad_accum=2)
    np.testing.assert_allclose(two, one, atol=1e-6, rtol=0)
    for name in p_one:
        torch.testing.assert_close(p_two[name], p_one[name], atol=1e-6,
                                   rtol=0)


@pytest.mark.parametrize("kind,warmup,total", [
    ("cosine", 0, 7), ("cosine", 3, 10), ("linear", 0, 5), ("linear", 2, 6),
    ("linear", 4, 4)])
def test_schedules_match_optax(kind, warmup, total):
    """``lr_at`` equals the optax schedule ``make_optimizer`` builds, at
    every step count of the schedule and past its end."""
    lr = 0.3
    if kind == "cosine":
        sched = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, total)
    else:
        sched = optax.join_schedules(
            [optax.linear_schedule(0.0, lr, max(warmup, 1)),
             optax.linear_schedule(lr, 0.0, max(total - warmup, 1))],
            [warmup])
    spec = train.make_optimizer(lr, schedule=kind, warmup_steps=warmup,
                                total_steps=total)
    for count in range(total + 3):
        assert spec.lr_at(count) == pytest.approx(float(sched(count)),
                                                  rel=1e-6, abs=1e-9)


@pytest.mark.parametrize("scale", [0.1, 10.0])
def test_clip_matches_optax(scale):
    """``clip_by_global_norm`` against optax's rule, below and above the
    bound (float32, 1e-6)."""
    rng = np.random.default_rng(5)
    grads = [rng.standard_normal(s, np.float32) * scale
             for s in ((3, 4), (7,), (2, 2, 2))]
    want, _ = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray(g) for g in grads], None)
    got = [torch.tensor(g) for g in grads]
    train.clip_by_global_norm(got, 1.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=1e-6)


def test_unported_options_name_their_roadmap_item():
    model = _torch_model(_tree(), "dense")
    spec = train.make_optimizer()
    # remat and loss_chunk are ported (tests/test_torch_losses.py); the
    # chunked loss needs GPT-2's tied head, as in JAX.
    train.make_train_step(model, spec, remat=True, loss_chunk=16)
    lm = llama.Llama(llama.LlamaConfig(vocab_size=64, max_seq_len=32,
                                       num_layers=1, num_heads=2,
                                       d_model=32))
    with pytest.raises(ValueError, match="tied-embedding head"):
        train.make_train_step(lm, spec, loss_chunk=16)
    # A mesh is ported (tpudp_torch.mesh.Mesh); anything else is refused.
    with pytest.raises(TypeError, match="Mesh"):
        train.make_train_step(model, spec, object())
    # skip_nonfinite is ported; JAX refuses it beside compress, as here.
    with pytest.raises(ValueError, match="compress"):
        train.make_optimizer(skip_nonfinite=3, compress="int8_ef")
    # compress='int8_ef' is ported: it needs a mesh, and names the rest.
    with pytest.raises(ValueError, match="needs a mesh"):
        train.init_state(model, train.make_optimizer(compress="int8_ef"))
    with pytest.raises(ValueError, match="unknown compress"):
        train.make_optimizer(compress="int4")
    with pytest.raises(ValueError, match="total_steps"):
        train.make_optimizer(schedule="cosine")


def test_train_serve_train_keeps_gradients():
    """Train one step, serve one greedy request through the engine, train
    another: the model still computes gradients, and both losses equal
    an uninterrupted two-step run's."""
    tree, batches = _tree(), _batches(6, 2)
    want, _ = _torch_run(tree, batches, SGD, "dense")
    model = gpt2.build(gpt2.GPT2Config(**CFG), 31, "cpu")
    spec = train.make_optimizer(**SGD)
    state = train.init_state(model, spec)
    step = train.make_train_step(model, spec)
    x, y = (torch.as_tensor(a) for a in batches[0])
    state, first = step(state, x, y)
    engine = Engine(model, device="cpu", num_slots=1, prefill_chunk=8)
    out = engine.submit(np.arange(5, dtype=np.int32), 4).result()
    assert out.shape == (9,)
    assert all(p.requires_grad for p in model.parameters())
    x, y = (torch.as_tensor(a) for a in batches[1])
    state, second = step(state, x, y)
    assert all(p.grad is not None and p.grad.abs().sum() > 0
               for p in model.parameters())
    assert [float(first), float(second)] == want


def test_init_state_turns_gradients_on():
    model = gpt2.build(gpt2.GPT2Config(**CFG), 0, "cpu").requires_grad_(False)
    train.init_state(model, train.make_optimizer())
    assert all(p.requires_grad for p in model.parameters())
    assert model.training


def test_cli_prints_step_lines(capsys):
    """The CPU rehearsal of ``python -m tpudp_torch.train_cli`` prints the
    example's ``step N: loss L (T tok/s)`` lines."""
    losses = train_cli.main(["--device", "cpu", "--layers", "2",
                             "--d-model", "64", "--vocab", "256",
                             "--seq-len", "128", "--steps", "3", "--attn",
                             "flash", "--batch-size", "2", "--log-every",
                             "1"])
    out = capsys.readouterr().out
    lines = re.findall(r"^step (\d+): loss ([\d.]+) \(([\d,]+) tok/s\)$", out,
                       re.M)
    assert [int(n) for n, _, _ in lines] == [1, 2, 3]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert "attn=flash" in out


def test_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["--layers", "1", "--d-model", "32", "--vocab", "16",
                        "--seq-len", "16", "--steps", "1"])


TINY_CLI = ["--device", "cpu", "--layers", "2", "--d-model", "32",
            "--heads", "2", "--vocab", "61", "--seq-len", "64",
            "--batch-size", "2", "--log-every", "1"]


@pytest.mark.parametrize("attn", ["dense", "flash"])
def test_cli_sample_prints_generate_tokens(capsys, attn):
    """``--sample N`` prints JAX's line with the port ``generate()``'s
    greedy tokens from the corpus' first 16 tokens after training (a
    flash-trained model decodes through its dense-attention twin)."""
    args = train_cli.parse_args(TINY_CLI + ["--steps", "2", "--attn", attn,
                                            "--seq-len", "128",
                                            "--sample", "5"])
    run = train_cli.train(args)
    corpus = train_cli.load_corpus(args)
    twin = train_cli.decode_twin(run["model"])
    assert twin.config.attn_impl == "dense"
    want = generate(twin, torch.as_tensor(corpus[:16][None]), 5)[0, 16:]
    assert run["sample"] == want.tolist()
    assert (f"[gpt2] greedy sample (prompt 16 tokens): {want.tolist()}"
            in capsys.readouterr().out)


def test_cli_tokens_file_builds_jax_corpus(tmp_path):
    """``--tokens-file``: the example's corpus rule, uint16 tokens modulo
    the vocabulary; the run trains on it."""
    toks = np.random.default_rng(5).integers(0, 65535, size=600)
    path = tmp_path / "tokens.bin"
    toks.astype(np.uint16).tofile(path)
    args = train_cli.parse_args(TINY_CLI + ["--steps", "1", "--tokens-file",
                                            str(path)])
    corpus = train_cli.load_corpus(args)
    jax_corpus = np.fromfile(path, dtype=np.uint16).astype(np.int32) % 61
    np.testing.assert_array_equal(corpus, jax_corpus)
    assert len(train_cli.train(args)["losses"]) == 1


@pytest.mark.parametrize("extra,match", [
    (["--family", "llama", "--sample", "4"], "use --family gpt2"),
    (["--seq-parallel", "--sample", "4"], "drop --seq-parallel"),
    (["--sample", "49"], r"--sample 49 \+ prompt 16 exceeds --seq-len 64"),
    (["--strategy", "tp", "--sample", "4"], "needs the DP path")])
def test_cli_sample_refusals_match_the_example(extra, match):
    with pytest.raises(SystemExit, match=match):
        train_cli.parse_args(TINY_CLI + extra)
