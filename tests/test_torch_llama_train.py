"""LLaMA training with the port — one device, and under tp (by
``llama_tp_rules``), fsdp, zero1 and sp — against the JAX package's
steps, on the CPU; and ``train_cli --family llama``.

The same numpy weights (``llama.random_params``) and numpy-seeded
batches go into both packages at ``tests/test_llama.py``'s tiny geometry
(vocab 64, 2 layers, 4 heads, d 32).  One device: the train step against
flax's at MHA and one KV head.  One gloo world of 4 ranks
(``tests/torch_dp_worker.py`` job ``llama``): tp on a (2, 2) mesh at 4 KV
heads (``wk``/``wv`` split by KV heads) and at 1 (the axis does not
divide it: ``wk``/``wv`` whole on every rank, their partial gradients
summed over ``model``), fsdp and zero1 over 4 ranks and sp over ``seq
2`` with ring attention and RoPE at global positions — each against
the JAX rung at ``tests/test_tensor_parallel.py``'s tolerances (losses
rtol 2e-4, parameters atol 2e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_worker as w
from tpudp.mesh import make_mesh_nd as jax_make_mesh_nd
from tpudp.models.llama import Llama as JaxLlama
from tpudp.models.llama import LlamaConfig as JaxLlamaConfig
from tpudp.parallel.tensor import llama_tp_rules as jax_llama_tp_rules
from tpudp.train import init_state as jax_init_state
from tpudp.train import make_fsdp_train_step as jax_fsdp_step
from tpudp.train import make_optimizer as jax_make_optimizer
from tpudp.train import make_seq_parallel_train_step as jax_sp_step
from tpudp.train import make_tp_train_step as jax_tp_step
from tpudp.train import make_train_step as jax_make_train_step
from tpudp.train import make_zero1_train_step as jax_zero1_step
from tpudp_torch import train, train_cli
from tpudp_torch.models import llama

LOSS = dict(rtol=2e-4)
PARAM = dict(atol=2e-4, rtol=0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite's workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return [r["llama"] for r in w.run_world(
        tmp_path_factory.mktemp("llama4"), 4, ["llama"])]


def _cfg(model_kw):
    return dict(w.LLAMA_CFG, **model_kw)


def _jax_start(model_kw, tx):
    model = JaxLlama(JaxLlamaConfig(**_cfg(model_kw)))
    state = jax_init_state(model, tx, input_shape=(1, 8))
    params = jax.tree.map(jnp.asarray, w.strategy_tree(
        _cfg(model_kw), family="llama"))
    return model, state.replace(params=params, opt_state=tx.init(params))


def _jax_losses(step, state, batches):
    losses = []
    for x, y in batches:
        state, loss = step(state, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(loss))
    return losses, jax.device_get(state.params)


def _jax_rung(name):
    strategy, shape, options, model_kw = w.LLAMA_RUNGS[name]
    tx = jax_make_optimizer(learning_rate=w.STRATEGY_LR)
    model, state = _jax_start(model_kw, tx)
    mesh = jax_make_mesh_nd(shape, devices=jax.devices()[:4])
    if strategy == "sp":
        step = jax_sp_step(model, tx, mesh, donate=False)
    elif strategy == "tp":
        state, step = jax_tp_step(model, tx, mesh, state,
                                  jax_llama_tp_rules(), donate=False)
    else:
        make = jax_fsdp_step if strategy == "fsdp" else jax_zero1_step
        state, step = make(model, tx, mesh, state, donate=False,
                           min_size=w.MIN_SIZE)
    return _jax_losses(step, state, w.llama_batches(name))


@pytest.mark.parametrize("name", list(w.LLAMA_RUNGS))
def test_rung_matches_jax(world4, name):
    losses, params = _jax_rung(name)
    for r in world4:
        np.testing.assert_allclose(r[name]["losses"], losses, **LOSS)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        np.asarray(b), np.asarray(a), **PARAM), params,
        world4[0][name]["params"])


def test_tp_splits_heads_and_keeps_indivisible_kv_whole(world4):
    split = world4[0]["tp"]["local_shapes"]
    assert split["h.0.attn.wq.weight"] == (16, 32)   # 2 of 4 heads
    assert split["h.0.attn.wk.weight"] == (16, 32)   # 2 of 4 KV heads
    assert split["h.0.attn.wo.weight"] == (32, 16)
    assert split["h.0.gate.weight"] == (64, 32)      # hidden 128 / 2
    assert split["h.0.down.weight"] == (32, 64)
    assert split["wte.weight"] == split["lm_head.weight"] == (32, 32)
    whole = world4[0]["tp-kv1"]["local_shapes"]
    assert whole["h.0.attn.wq.weight"] == (16, 32)
    assert whole["h.0.attn.wk.weight"] == whole["h.0.attn.wv.weight"] == (
        8, 32)  # 1 KV head of 8 dims, on every rank
    for r in world4[1:]:  # the whole leaves stay equal across the ranks
        np.testing.assert_array_equal(
            r["tp-kv1"]["params"]["h_0"]["attn"]["wk"]["kernel"],
            world4[0]["tp-kv1"]["params"]["h_0"]["attn"]["wk"]["kernel"])


@pytest.mark.parametrize("rung", ["fsdp", "zero1"])
def test_data_sharded_rank_bytes(world4, rung):
    r = world4[0][rung]
    total = r["one_device_bytes"]["params"]
    assert 0.24 < r["bytes"]["opt_state"] / total < 0.30
    if rung == "fsdp":
        assert 0.24 < r["bytes"]["params"] / total < 0.30


def test_sp_eval_matches_dense(world4):
    _, _, _, model_kw = w.LLAMA_RUNGS["sp"]
    params = world4[0]["sp"]["params"]
    dense = llama.Llama(llama.LlamaConfig(**dict(_cfg(model_kw),
                                                 attn_impl="dense",
                                                 seq_axis=None)))
    dense.load_state_dict(llama.params_from_jax(params))
    x, y = w.llama_batches("sp")[-1]
    want = train.eval_metrics(dense, torch.as_tensor(x), torch.as_tensor(y),
                              torch.tensor([1.0, 0.0, 1.0, 1.0]))
    for r in world4:
        np.testing.assert_allclose(r["sp-eval"], want.numpy(), rtol=1e-5)


# -- one device ---------------------------------------------------------------

@pytest.mark.parametrize("kv_heads", [None, 1])
def test_train_step_matches_flax(kv_heads):
    model_kw = {"num_kv_heads": kv_heads}
    tx = jax_make_optimizer(learning_rate=w.STRATEGY_LR)
    jmodel, state = _jax_start(model_kw, tx)
    step = jax_make_train_step(jmodel, tx, None, "none", spmd_mode="single",
                               donate=False)
    want, params = _jax_losses(step, state, w.lm_batches(64))
    model = llama.Llama(llama.LlamaConfig(**_cfg(model_kw)))
    model.load_state_dict(llama.params_from_jax(
        w.strategy_tree(_cfg(model_kw), family="llama")))
    spec = train.make_optimizer(learning_rate=w.STRATEGY_LR)
    st = train.init_state(model, spec)
    tstep = train.make_train_step(model, spec)
    got = []
    for x, y in w.lm_batches(64):
        st, loss = tstep(st, torch.as_tensor(x), torch.as_tensor(y))
        got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        np.asarray(b), np.asarray(a), atol=1e-5, rtol=0),
        params, train.state_to_jax(st)["params"])


# -- train_cli ----------------------------------------------------------------

TINY = ["--device", "cpu", "--family", "llama", "--layers", "2",
        "--d-model", "64", "--heads", "4", "--vocab", "128", "--seq-len",
        "32", "--batch-size", "4", "--steps", "4", "--log-every", "2",
        "--dtype", "float32"]


@pytest.mark.parametrize("argv,match", [
    (["--family", "llama", "--strategy", "pp"], "gpt2-family path"),
    (["--family", "llama", "--strategy", "ep"], "gpt2-family path"),
    (["--family", "llama", "--loss-chunk", "8"], "tied-embedding head"),
    (["--kv-heads", "2"], "llama-family option"),
    (["--loss-chunk", "8", "--strategy", "fsdp"], "DP-path option"),
    (["--loss-chunk", "8", "--seq-parallel"], "DP-path option"),
    (["--loss-chunk", "0"], ">= 1"),
], ids=["llama-pp", "llama-ep", "llama-loss-chunk", "gpt2-kv-heads",
        "loss-chunk-strategy", "loss-chunk-sp", "loss-chunk-0"])
def test_train_cli_refusals(argv, match):
    with pytest.raises(SystemExit, match=match):
        train_cli.parse_args(argv)


def test_train_cli_trains_llama(capsys):
    losses = train_cli.main(TINY + ["--kv-heads", "2", "--attn", "flash"])
    out = capsys.readouterr().out
    assert out.splitlines()[0].startswith("[llama] params=")
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert losses[-1] < np.log(128) + 0.5


def test_train_cli_loss_chunk_follows_the_plain_run():
    gpt2 = ["--device", "cpu", "--layers", "2", "--d-model", "64", "--heads",
            "2", "--vocab", "128", "--seq-len", "32", "--batch-size", "4",
            "--steps", "4", "--log-every", "2", "--dtype", "float32"]
    plain = train_cli.main(gpt2)
    chunked = train_cli.main(gpt2 + ["--loss-chunk", "24"])
    np.testing.assert_allclose(chunked, plain, rtol=1e-5)
