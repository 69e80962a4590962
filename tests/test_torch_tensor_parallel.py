"""The port's tensor-parallel, FSDP and ZeRO-1 rungs against the JAX
package's GSPMD rungs, on the CPU.

One gloo world of 4 ranks (``tests/torch_dp_worker.py``, jobs ``tp``,
``fsdp`` and ``vgg_tp``) trains the JAX tests' tiny GPT-2 (vocab 64, 4
heads, d 32) for
3 steps: TP on a (2, 2) mesh (Megatron by hand, ``qkv`` split by heads,
``wte`` vocab-split) against ``make_tp_train_step``, FSDP and ZeRO-1
over 4 ranks (min_size 128) against ``make_fsdp_train_step`` /
``make_zero1_train_step``, at ``tests/test_tensor_parallel.py`` and
``tests/test_fsdp.py``'s tolerances (losses rtol 2e-4, parameters atol
2e-4).  Each rank's state bytes show the sharding: FSDP holds about 1/4
of the parameters and of the momentum, ZeRO-1 about 1/4 of the momentum.
The rule tables and FSDP's dim choice are held to JAX's.

The same world trains the narrow VGG of ``tests/test_torch_dp_train.py``
under ``vgg_tp_rules`` (each convolution's output channels split over
``model``) on meshes (2, 2) and (1, 4) — at 4 the 10-class classifier
stays whole — against JAX's ``make_tp_train_step`` with the same rules
(the single-device step on the global batch), and the tiny ViT under
fsdp and zero1 against JAX's rungs.

Job ``tp_cells`` runs every family under every rule table as JAX's
``make_tp_train_step`` resolves it: the tiny ResNet under
``vgg_tp_rules`` and the tiny ViT under ``gpt2_tp_rules`` at meshes (2,
2) and (1, 4), each table that splits nothing of a family (replicated
over ``model``), and the two tables that split an embedding only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
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


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite's workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return w.run_world(tmp_path_factory.mktemp("tp4"), 4,
                       ["tp", "fsdp", "vgg_tp", "tp_cells"])


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
    """What JAX's ``make_tp_train_step`` takes, the port takes: another
    family's table splits nothing (the replicated step: the model itself
    on every rank) or the embedding only (``TPGPT2`` / ``TPLlama`` with
    their other sections whole), as a custom table splitting the
    embedding does.  A table splitting part of a section the port splits
    together, or ``skip_nonfinite``, is refused by name."""
    spec = train.make_optimizer()
    mesh = _fake_mesh({"data": 1, "model": 2})
    model = gpt2.GPT2(gpt2.GPT2Config(**w.TP_CFG))
    state = train.init_state(model, spec)
    built, _ = make_tp_train_step(model, spec, mesh, state,
                                  tensor.vgg_tp_rules())
    assert built.model is model  # nothing split: replicated
    built, _ = make_tp_train_step(model, spec, mesh, state,
                                  tensor.llama_tp_rules())
    assert built.model.splits == {"attn": False, "mlp": False,
                                  "vocab": True}
    lm = llama.Llama(llama.LlamaConfig(vocab_size=64, max_seq_len=32,
                                       num_layers=1, num_heads=4,
                                       d_model=32))
    built, _ = make_tp_train_step(lm, spec, mesh,
                                  train.init_state(lm, spec),
                                  tensor.gpt2_tp_rules())
    assert built.model.splits == {"attn": False, "kv": False, "mlp": False,
                                  "vocab": True, "head": False}
    assert tuple(built.model.lm_head.weight.shape) == (64, 32)
    net = vgg.VGG(w.CFG)
    built, _ = make_tp_train_step(net, spec, mesh,
                                  train.init_state(net, spec),
                                  tensor.gpt2_tp_rules())
    assert built.model is net
    built, _ = make_tp_train_step(model, spec, mesh, state,
                                  ((r"wte", ("model", None)),))
    assert built.model.splits["vocab"] and not built.model.splits["attn"]
    with pytest.raises(ValueError, match="attn"):
        make_tp_train_step(model, spec, mesh, state,
                           ((r"attn/qkv/kernel", (None, "model")),))
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


# -- VGG under vgg_tp_rules, and the ViT under fsdp and zero1 ---------------
#
# The same 3 SGD steps of the narrow VGG as JAX's step on the global batch:
# losses rtol 1e-5 and parameters / running statistics / momentum atol
# 2e-5 (float32 in both; the split convolutions, the gathers and SyncBN's
# all-reduce change the summation order only), as
# tests/test_torch_dp_train.py holds the DP rungs of this model.

VGG_TP_LOSS = dict(rtol=1e-5)
VGG_TP_STATE = dict(atol=2e-5, rtol=1e-5)


def _jax_vgg_tp(mesh_shape):
    """JAX's ``strategy='tp'`` step (``make_tp_train_step`` with
    ``vgg_tp_rules()``) on the port's global batches: losses, the final
    state and its eval sums."""
    from tpudp.models.vgg import VGG as JaxVGG
    from tpudp.train import make_eval_step as jax_make_eval_step

    mesh = jax_make_mesh_nd(mesh_shape, devices=jax.devices()[:4])
    params, stats = w.vgg_init()
    model = JaxVGG(cfg=w.CFG)
    tx = jax_make_optimizer(**w.SGD)
    state = jax_init_state(model, tx).replace(
        params=jax.tree.map(jnp.asarray, params),
        batch_stats=jax.tree.map(jnp.asarray, stats))
    state = state.replace(opt_state=tx.init(state.params))
    state, step = jax_tp_step(model, tx, mesh, state,
                              jax_tensor.vgg_tp_rules(), donate=False)
    losses = []
    for x, y in w.vgg_batches(w.VGG_TP_WORLD):
        state, loss = step(state, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(loss))
    state = jax.device_get(state)
    sums = jax_make_eval_step(model, None)(
        state, *(jnp.asarray(a) for a in w.eval_batch(w.VGG_TP_WORLD)))
    return losses, state, [float(v) for v in sums]


def _assert_tree(got, want, **tol):
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        np.asarray(b), np.asarray(a), **tol), want, got)


@pytest.mark.parametrize("mesh_name", sorted(w.VGG_TP_MESHES))
def test_vgg_tp_matches_jax_trajectory(world4, mesh_name):
    """Losses, parameters, BatchNorm running statistics and SGD momentum
    after 3 steps, in JAX's global layout, on every rank; the eval sums
    of the trained rung."""
    losses, state, sums = _jax_vgg_tp(w.VGG_TP_MESHES[mesh_name])
    for r in world4:
        got = r["vgg_tp"][mesh_name]
        np.testing.assert_allclose(got["losses"], losses, **VGG_TP_LOSS)
        _assert_tree(got["tree"]["params"], state.params, **VGG_TP_STATE)
        _assert_tree(got["tree"]["batch_stats"], state.batch_stats,
                     **VGG_TP_STATE)
        _assert_tree(got["tree"]["opt_state"]["momentum"],
                     state.opt_state[1][0].trace, **VGG_TP_STATE)
        np.testing.assert_allclose(got["eval"], sums, rtol=1e-5, atol=1e-5)
        assert int(got["tree"]["step"]) == 3


def test_vgg_tp_local_shapes_and_fallback(world4):
    """Each rank holds its share of the split channels; at model 4 the
    10-class classifier is whole on every rank (10 % 4), at 2 split."""
    two = world4[0]["vgg_tp"]["dp2-tp2"]["local_shapes"]
    four = world4[3]["vgg_tp"]["tp4"]["local_shapes"]
    assert two["convs.0.weight"] == (4, 3, 3, 3)  # 8 channels over 2
    assert two["bns.1.running_var"] == (8,)       # 16 over 2
    assert two["fc.weight"] == (5, 16)
    assert four["convs.1.weight"] == (4, 8, 3, 3)  # whole input channels
    assert four["bns.0.running_mean"] == (2,)
    assert four["fc.weight"] == (10, 16) and four["fc.bias"] == (10,)


@pytest.mark.parametrize("mesh_name", sorted(w.VGG_TP_MESHES))
def test_vgg_tp_checkpoint_is_jax_layout(world4, mesh_name):
    """The saved tree has the single-device model's global shapes (JAX's
    layout) and restores into a rung of other weights exactly."""
    got = world4[0]["vgg_tp"][mesh_name]
    params, stats = w.vgg_init()
    for tree, want in ((got["tree"]["params"], params),
                       (got["tree"]["batch_stats"], stats)):
        jax.tree.map(lambda a, b: np.testing.assert_equal(
            tuple(b.shape), np.shape(a)), want, tree)
    _assert_tree(got["restored"], got["tree"], atol=0, rtol=0)


def test_vgg_tp_trainer_epoch(world4):
    """``Trainer(strategy='tp', strategy_options={'rules':
    vgg_tp_rules()})`` trains the same epoch as the rung it builds."""
    losses, state, _ = _jax_vgg_tp(w.VGG_TP_MESHES["dp2-tp2"])
    for r in world4:
        got = r["vgg_tp"]["trainer"]
        np.testing.assert_allclose(got["loss_sum"], sum(losses), rtol=1e-5)
        _assert_tree(got["tree"]["params"], state.params, **VGG_TP_STATE)


@pytest.mark.parametrize("rung", ["fsdp", "zero1"])
def test_vit_data_sharded_matches_jax(world4, mesh4, rung):
    """The tiny ViT under fsdp and zero1 over 4 ranks: 3 SGD steps'
    losses and parameters against JAX's rungs (no BatchNorm, so the
    rungs need nothing of the model: GSPMD's any-model contract)."""
    from tpudp.models.vit import ViT as JaxViT
    from tpudp.models.vit import ViTConfig as JaxViTConfig

    model = JaxViT(JaxViTConfig(**w.VIT_CFG))
    tx = jax_make_optimizer(**w.SGD)
    state = jax_init_state(model, tx, input_shape=(1, 16, 16, 3))
    params = jax.tree.map(jnp.asarray, w.vit_tree())
    state = state.replace(params=params, opt_state=tx.init(params))
    make = jax_fsdp_step if rung == "fsdp" else jax_zero1_step
    state, step = make(model, tx, mesh4, state, min_size=w.MIN_SIZE,
                       donate=False)
    losses = []
    for x, y in w.vit_batches(4):
        state, loss = step(state, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(loss))
    for r in world4:
        got = r["vgg_tp"][f"vit-{rung}"]
        np.testing.assert_allclose(got["losses"], losses, **LOSS)
        _assert_tree(got["params"], jax.device_get(state.params), **PARAM)


# -- every family under every table (job tp_cells) --------------------------

def _jax_cell(family: str, table: str, shape: dict):
    """JAX's ``make_tp_train_step`` under ``{table}_tp_rules`` on the
    cell's model and batches: losses and the final state."""
    from tpudp.models.llama import Llama as JaxLlama
    from tpudp.models.llama import LlamaConfig as JaxLlamaConfig
    from tpudp.models.resnet import ResNet as JaxResNet
    from tpudp.models.vgg import VGG as JaxVGG
    from tpudp.models.vit import ViT as JaxViT
    from tpudp.models.vit import ViTConfig as JaxViTConfig

    _, opt, batches = w.tp_cell_inputs(family)
    tx = jax_make_optimizer(**opt)
    stats = None
    if family == "gpt2":
        model = jax_gpt2_small(**w.TP_CFG)
        state = jax_init_state(model, tx, input_shape=(1, 8))
        params = w.strategy_tree(w.TP_CFG)
    elif family == "llama":
        model = JaxLlama(JaxLlamaConfig(**w.LLAMA_CFG))
        state = jax_init_state(model, tx, input_shape=(1, 8))
        params = w.strategy_tree(w.LLAMA_CFG, family="llama")
    elif family == "vit":
        model = JaxViT(JaxViTConfig(**w.VIT_CFG))
        state = jax_init_state(model, tx, input_shape=(1, 16, 16, 3))
        params = w.vit_tree()
    elif family == "vgg":
        model = JaxVGG(cfg=w.CFG)
        state = jax_init_state(model, tx)
        params, stats = w.vgg_init()
    else:
        model = JaxResNet(stage_sizes=w.RESNET_STAGES, num_classes=10,
                          width=w.RESNET_WIDTH)
        state = jax_init_state(model, tx)
        params, stats = w.resnet_init()
    params = jax.tree.map(jnp.asarray, params)
    state = state.replace(params=params, opt_state=tx.init(params))
    if stats is not None:
        state = state.replace(batch_stats=jax.tree.map(jnp.asarray, stats))
    mesh = jax_make_mesh_nd(shape, devices=jax.devices()[:4])
    rules = getattr(jax_tensor, f"{table}_tp_rules")()
    state, step = jax_tp_step(model, tx, mesh, state, rules, donate=False)
    losses = []
    for x, y in batches:
        state, loss = step(state, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(loss))
    return losses, jax.device_get(state)


def _check_cell(world4, name, loss_tol, state_tol):
    family, table, shape = w.TP_CELLS[name]
    losses, state = _jax_cell(family, table, shape)
    for r in world4:
        got = r["tp_cells"][name]
        np.testing.assert_allclose(got["losses"], losses, **loss_tol)
        _assert_tree(got["tree"]["params"], state.params, **state_tol)
        if family in ("vgg", "resnet"):
            _assert_tree(got["tree"]["batch_stats"], state.batch_stats,
                         **state_tol)


SPLIT_CELLS = ["resnet-vgg-dp2-tp2", "resnet-vgg-tp4", "vit-gpt2-dp2-tp2",
               "vit-gpt2-tp4"]


@pytest.mark.parametrize("name", SPLIT_CELLS)
def test_resnet_vit_tp_match_jax_trajectory(world4, name):
    """ResNet under ``vgg_tp_rules`` (VGG's tolerances: the channel split
    changes the summation order only) and ViT under ``gpt2_tp_rules``
    (GPT-2's) after 3 steps: losses, parameters and (ResNet) BatchNorm
    running statistics in JAX's global layout, on every rank."""
    tol = (VGG_TP_LOSS, VGG_TP_STATE) if name.startswith("resnet") \
        else (LOSS, PARAM)
    _check_cell(world4, name, *tol)


@pytest.mark.parametrize("name", [n for n in w.TP_CELLS
                                  if n not in SPLIT_CELLS])
def test_unsplit_and_vocab_cells_match_jax(world4, name):
    """A table that splits nothing of a family runs the replicated step
    (the single-device module on every rank), and GPT-2 under
    ``llama_tp_rules`` / LLaMA under ``gpt2_tp_rules`` split the
    embedding only: each agrees with JAX's GSPMD step under that table
    (GPT-2's replicated step at meshes (2, 2) and (1, 4))."""
    family = w.TP_CELLS[name][0]
    conv = family in ("vgg", "resnet")
    _check_cell(world4, name, VGG_TP_LOSS if conv else LOSS,
                VGG_TP_STATE if conv else PARAM)
    module = world4[0]["tp_cells"][name]["module"]
    assert module == {"gpt2-llama": "TPGPT2",
                      "llama-gpt2": "TPLlama"}.get(
        name, {"gpt2": "GPT2", "llama": "Llama", "vgg": "VGG",
               "resnet": "ResNet", "vit": "ViT"}[family])


def _jax_split_dims(family: str, table: str, shape: dict) -> dict:
    """``{jax path: split dim}`` of JAX's resolution of the cell's
    parameters (replicated leaves left out)."""
    from tpudp_torch.parallel import sharded

    model, _, _ = w.tp_cell_inputs(family)
    to_jax, _ = train._codec(model)
    params = jax.tree.map(jnp.asarray, to_jax(model.state_dict())[0])
    mesh = jax_make_mesh_nd(shape, devices=jax.devices()[:4])
    want = jax_tensor.tree_shardings(
        {"params": params}, mesh, getattr(jax_tensor, f"{table}_tp_rules")())
    out = {}
    for path, sh in jax.tree_util.tree_flatten_with_path(want)[0]:
        dim = next((i for i, a in enumerate(tuple(sh.spec))
                    if a is not None), None)
        if dim is not None:
            out["/".join(str(getattr(p, "key", p)) for p in path)] = dim
    assert sharded.resolve_tp(model, getattr(
        tensor, f"{table}_tp_rules")(), shape) is not None
    return out


def test_resnet_vit_layouts_match_jax_resolution(world4):
    """Each rank holds the slices JAX's resolution gives its leaves:
    the ResNet's split convolutions (``stem_conv``, ``Conv_0-2``,
    ``proj_conv``) and ``BatchNorm_0-2`` at ``cout/n`` with ``stem_bn``
    and ``proj_bn`` whole, ``Dense_0`` split at model 2 and whole at 4;
    the ViT's ``qkv``, ``proj``, ``mlp_fc`` and ``mlp_proj`` at model 2,
    its MLP only at 4 (2 heads)."""
    dims = _jax_split_dims("resnet", "vgg", {"data": 2, "model": 2})
    assert "params/stem_conv/kernel" in dims
    assert "params/BottleneckBlock_0/proj_conv/kernel" in dims
    assert "params/stem_bn/scale" not in dims
    assert "params/BottleneckBlock_1/proj_bn/scale" not in dims
    two = world4[0]["tp_cells"]["resnet-vgg-dp2-tp2"]["local_shapes"]
    four = world4[0]["tp_cells"]["resnet-vgg-tp4"]["local_shapes"]
    assert two["stem_conv.weight"] == (8, 3, 7, 7)
    assert four["stem_conv.weight"] == (4, 3, 7, 7)
    assert two["stem_bn.weight"] == four["stem_bn.weight"] == (16,)
    assert two["blocks.1.convs.2.weight"] == (64, 32, 1, 1)
    assert four["blocks.1.bns.1.running_var"] == (8,)
    assert four["blocks.1.proj_conv.weight"] == (32, 64, 1, 1)
    assert four["blocks.1.proj_bn.running_mean"] == (128,)
    assert two["fc.weight"] == (5, 128) and four["fc.weight"] == (10, 128)
    vdims = _jax_split_dims("vit", "gpt2", {"data": 2, "model": 2})
    assert vdims == {f"params/h_{i}/{leaf}": d for i in range(2)
                     for leaf, d in (("attn/qkv/kernel", 1),
                                     ("attn/qkv/bias", 0),
                                     ("attn/proj/kernel", 0),
                                     ("mlp_fc/kernel", 1),
                                     ("mlp_fc/bias", 0),
                                     ("mlp_proj/kernel", 0))}
    v2 = world4[0]["tp_cells"]["vit-gpt2-dp2-tp2"]["local_shapes"]
    v4 = world4[0]["tp_cells"]["vit-gpt2-tp4"]["local_shapes"]
    assert v2["h.0.attn.qkv.weight"] == (48, 32)
    assert v2["h.0.attn.proj.weight"] == (32, 16)
    assert v4["h.0.attn.qkv.weight"] == (96, 32)  # 2 heads over 4: whole
    assert v4["h.1.mlp_fc.weight"] == (32, 32)
    assert v2["head.weight"] == v4["head.weight"] == (10, 32)
