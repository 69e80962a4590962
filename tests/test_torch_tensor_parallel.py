"""The port's tensor-parallel, FSDP and ZeRO-1 rungs against the JAX
package's GSPMD rungs, on the CPU.

One gloo world of 4 ranks (``tests/torch_dp_worker.py``, jobs ``tp`` and
``fsdp``) trains the JAX tests' tiny GPT-2 (vocab 64, 4 heads, d 32) for
3 steps: TP on a (2, 2) mesh (Megatron by hand, ``qkv`` split by heads,
``wte`` vocab-split) against ``make_tp_train_step``, FSDP and ZeRO-1
over 4 ranks (min_size 128) against ``make_fsdp_train_step`` /
``make_zero1_train_step``, at ``tests/test_tensor_parallel.py`` and
``tests/test_fsdp.py``'s tolerances (losses rtol 2e-4, parameters atol
2e-4).  Each rank's state bytes show the sharding: FSDP holds about 1/4
of the parameters and of the momentum, ZeRO-1 about 1/4 of the momentum.
The rule tables and FSDP's dim choice are held to JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import torch_dp_worker as w
from tpudp.mesh import make_mesh_nd as jax_make_mesh_nd
from tpudp.models.gpt2 import gpt2_small as jax_gpt2_small
from tpudp.parallel import tensor as jax_tensor
from tpudp.train import init_state as jax_init_state
from tpudp.train import make_fsdp_train_step as jax_fsdp_step
from tpudp.train import make_optimizer as jax_make_optimizer
from tpudp.train import make_tp_train_step as jax_tp_step
from tpudp.train import make_zero1_train_step as jax_zero1_step
from tpudp_torch import train
from tpudp_torch.mesh import MeshND
from tpudp_torch.models import gpt2, llama, vgg
from tpudp_torch.parallel import tensor
from tpudp_torch.parallel.sharded import make_tp_train_step

LOSS = dict(rtol=2e-4)
PARAM = dict(atol=2e-4, rtol=0)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return w.run_world(tmp_path_factory.mktemp("tp4"), 4, ["tp", "fsdp"])


def _jax_state(tx):
    model = jax_gpt2_small(**w.TP_CFG)
    state = jax_init_state(model, tx, input_shape=(1, 8))
    params = jax.tree.map(jnp.asarray, w.strategy_tree(w.TP_CFG))
    return model, state.replace(params=params, opt_state=tx.init(params))


def _jax_run(make, mesh, **kw):
    tx = jax_make_optimizer(learning_rate=w.STRATEGY_LR)
    model, state = _jax_state(tx)
    state, step = make(model, tx, mesh, state, donate=False, **kw)
    losses = []
    for x, y in w.lm_batches(64):
        state, loss = step(state, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(loss))
    return losses, jax.device_get(state.params)


def _check_rung(results, key, losses, params):
    for r in results:
        np.testing.assert_allclose(r[key]["losses"] if key else r["losses"],
                                   losses, **LOSS)
    got = results[0][key]["params"] if key else results[0]["params"]
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        np.asarray(b), np.asarray(a), **PARAM), params, got)


def test_tp_matches_jax_trajectory(world4):
    mesh = jax_make_mesh_nd({"data": 2, "model": 2},
                            devices=jax.devices()[:4])
    losses, params = _jax_run(jax_tp_step, mesh,
                              rules=jax_tensor.gpt2_tp_rules())
    tp = [{"tp": r["tp"]} for r in world4]
    _check_rung(tp, "tp", losses, params)
    shapes = world4[0]["tp"]["local_shapes"]
    assert shapes["h.0.attn.qkv.weight"] == (48, 32)  # 2 of 4 heads' q, k, v
    assert shapes["h.0.attn.proj.weight"] == (32, 16)
    assert shapes["h.0.mlp_fc.weight"] == (64, 32)
    assert shapes["wte.weight"] == (32, 32)  # vocab 64 splits in 2
    assert shapes["wpe.weight"] == (32, 32)


def test_tp_with_indivisible_heads_matches_jax(world4):
    """JAX's fallback rule: at one head the attention stays whole on
    every rank (JAX shards its columns; the numbers agree), the MLP and
    the vocabulary split."""
    mesh = jax_make_mesh_nd({"data": 2, "model": 2},
                            devices=jax.devices()[:4])
    tx = jax_make_optimizer(learning_rate=w.STRATEGY_LR)
    model = jax_gpt2_small(**w.TP_HEADS1_CFG)
    state = jax_init_state(model, tx, input_shape=(1, 8))
    params = jax.tree.map(jnp.asarray, w.strategy_tree(w.TP_HEADS1_CFG))
    state = state.replace(params=params, opt_state=tx.init(params))
    state, step = jax_tp_step(model, tx, mesh, state,
                              jax_tensor.gpt2_tp_rules(), donate=False)
    losses = []
    for x, y in w.lm_batches(64):
        state, loss = step(state, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(loss))
    _check_rung([r["tp"] for r in world4], "heads1", losses,
                jax.device_get(state.params))
    shapes = world4[0]["tp"]["heads1"]["local_shapes"]
    assert shapes["h.0.attn.qkv.weight"] == (96, 32)  # whole
    assert shapes["h.0.mlp_fc.weight"] == (64, 32)    # split
    assert shapes["wte.weight"] == (32, 32)


@pytest.mark.parametrize("rung", ["fsdp", "zero1"])
def test_data_sharded_matches_jax_trajectory(world4, mesh4, rung):
    make = jax_fsdp_step if rung == "fsdp" else jax_zero1_step
    losses, params = _jax_run(make, mesh4, min_size=w.MIN_SIZE)
    fs = [{rung: r["fsdp"][rung]} for r in world4]
    _check_rung(fs, rung, losses, params)


@pytest.mark.parametrize("rung", ["fsdp", "zero1"])
def test_data_sharded_rank_bytes_are_a_quarter(world4, rung):
    """A rank's momentum (and, under fsdp, its parameters) is about 1/N
    of one device's: only leaves under min_size stay whole."""
    r = world4[0]["fsdp"][rung]
    total = r["one_device_bytes"]["params"]
    assert 0.24 < r["bytes"]["opt_state"] / total < 0.30
    if rung == "fsdp":
        assert 0.24 < r["bytes"]["params"] / total < 0.30
    else:  # whole parameters, plus the optimizer's quarter shards
        assert 1.24 < r["bytes"]["params"] / total < 1.30


def _jax_spec(spec):
    return tuple(spec)


def test_rules_are_jax_tables():
    for name in ("gpt2_tp_rules", "llama_tp_rules", "vgg_tp_rules"):
        ours = getattr(tensor, name)("m")
        theirs = getattr(jax_tensor, name)("m")
        assert [(p, s) for p, s in ours] == [
            (p, _jax_spec(s)) for p, s in theirs]
    rules = tensor.gpt2_tp_rules()
    for path in ("params/h_0/attn/qkv/kernel", "params/h_1/attn/proj/kernel",
                 "params/h_0/mlp_fc/bias", "params/h_0/mlp_proj/bias",
                 "params/wte/embedding", "params/ln_f/scale",
                 "opt_state/1/0/trace/h_0/mlp_fc/kernel"):
        assert tensor.spec_for_path(path, rules) == _jax_spec(
            jax_tensor.spec_for_path(path, jax_tensor.gpt2_tp_rules()))


def test_indivisible_dims_fall_back_to_replicated():
    sizes = {"data": 2, "model": 4}
    assert tensor.leaf_sharding("x", (6, 10), ((r"x", (None, "model")),),
                                sizes) is None  # 10 % 4
    assert tensor.leaf_sharding("x", (6, 12), ((r"x", (None, "model")),),
                                sizes) == (1, "model")
    tree = train.state_to_jax(train.init_state(
        gpt2.GPT2(gpt2.GPT2Config(**dict(w.TP_CFG, vocab_size=63))),
        train.make_optimizer()))
    sh = tensor.tree_shardings({"params": tree["params"]},
                               tensor.gpt2_tp_rules(), {"model": 2})
    assert sh["params/wte/embedding"] is None  # vocab 63 stays whole
    assert sh["params/h_0/attn/qkv/kernel"] == (1, "model")


def test_fsdp_dims_match_jax(mesh8):
    tree = {"big": np.zeros((64, 48)), "odd": np.zeros((7, 48)),
            "tiny": np.zeros((4, 4)), "prime": np.zeros((70, 30))}
    want = jax_tensor.fsdp_shardings(jax.tree.map(jnp.asarray, tree), mesh8,
                                     min_size=100)
    got = tensor.fsdp_shardings(tree, 8, min_size=100)
    for k, spec in want.items():
        spec = spec.spec
        dim = next((i for i, a in enumerate(spec) if a is not None), None)
        assert got[k] == (None if dim is None else (dim, "data")), k
    assert got == {"big": (0, "data"), "odd": (1, "data"), "tiny": None,
                   "prime": None}
    z = tensor.zero1_shardings({"params": tree, "opt_state": tree}, 8,
                               min_size=100)
    assert z["params/big"] is None and z["opt_state/big"] == (0, "data")
    assert P("data") == jax_tensor.fsdp_shardings(
        {"big": jnp.zeros((64, 48))}, mesh8, min_size=100)["big"].spec


def _fake_mesh(shape):
    return MeshND(shape=shape, rank=0, coords={a: 0 for a in shape},
                  groups={a: None for a in shape})


def test_tp_refusals():
    spec = train.make_optimizer()
    mesh = _fake_mesh({"data": 1, "model": 2})
    model = gpt2.GPT2(gpt2.GPT2Config(**w.TP_CFG))
    state = train.init_state(model, spec)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_tp_train_step(model, spec, mesh, state, tensor.vgg_tp_rules())
    with pytest.raises(ValueError, match="gpt2_tp_rules"):
        make_tp_train_step(model, spec, mesh, state, tensor.llama_tp_rules())
    lm = llama.Llama(llama.LlamaConfig(vocab_size=64, max_seq_len=32,
                                       num_layers=1, num_heads=4,
                                       d_model=32))
    with pytest.raises(ValueError, match="llama_tp_rules"):
        make_tp_train_step(lm, spec, mesh, train.init_state(lm, spec),
                           tensor.gpt2_tp_rules())
    net = vgg.VGG(w.CFG)
    with pytest.raises(TypeError, match="GPT2"):
        make_tp_train_step(net, spec, mesh, train.init_state(net, spec),
                           tensor.gpt2_tp_rules())
    with pytest.raises(ValueError, match="gpt2_tp_rules"):
        make_tp_train_step(model, spec, mesh, state,
                           ((r"wte", ("model", None)),))
    # JAX's fallback: heads the axis does not divide stay whole
    odd = gpt2.GPT2(gpt2.GPT2Config(**dict(w.TP_CFG, num_heads=1)))
    built, _ = make_tp_train_step(odd, spec, mesh,
                                  train.init_state(odd, spec),
                                  tensor.gpt2_tp_rules())
    assert built.model.splits == {"attn": False, "mlp": True, "vocab": True}
    assert tuple(built.model.h[0].attn.qkv.weight.shape) == (96, 32)
    with pytest.raises(ValueError, match="skip_nonfinite"):
        make_tp_train_step(model, train.make_optimizer(skip_nonfinite=2),
                           mesh, state, tensor.gpt2_tp_rules())


def test_train_reexports_the_rungs_and_resolves_shardings():
    """``tpudp_torch.train`` carries JAX's names for the GSPMD rungs, and
    ``resolve_state_shardings`` reads a state's placement as JAX's rule
    resolution does (the momentum follows its parameter)."""
    from tpudp_torch import train as t
    from tpudp_torch.parallel import sharded

    for name in ("make_tp_train_step", "make_fsdp_train_step",
                 "make_zero1_train_step", "make_seq_parallel_train_step",
                 "make_sp_eval_step", "resolve_state_shardings"):
        assert getattr(t, name) is getattr(sharded, name)
    model = gpt2.GPT2(gpt2.GPT2Config(**w.TP_CFG))
    state = train.init_state(model, train.make_optimizer())
    mesh = _fake_mesh({"data": 2, "model": 2})
    sh = t.resolve_state_shardings(state, mesh, tensor.gpt2_tp_rules())
    assert sh["params/h_0/attn/qkv/kernel"] == (1, "model")
    assert sh["opt_state/momentum/h_0/attn/qkv/kernel"] == (1, "model")
    assert sh["params/wte/embedding"] == (0, "model")
    fs = t.resolve_state_shardings(
        state, _fake_mesh({"data": 4}), lambda tree, mesh:
        tensor.fsdp_shardings(tree, mesh.shape["data"], min_size=w.MIN_SIZE))
    assert fs["params/wte/embedding"] == (0, "data")
    assert fs["params/h_0/ln_1/scale"] is None  # under min_size
