"""The port's MoE MLP and its expert-parallel rung against the JAX
package, on the CPU.

``MoeMlp`` (top-1 and top-2 routing, with and without dropped tokens:
outputs, load fractions and the Switch aux loss) and its gradients are
held to flax's at one rank; a MoE GPT-2 to flax's logits, and the
default train step (with the balance loss) to JAX's; the EP rung on a
(2, 2) gloo world (``tests/torch_dp_worker.py`` job ``ep``) to JAX's
``make_ep_train_step`` at ``tests/test_expert.py``'s rtol 1e-5 / atol
1e-6, with the expert weights really split.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_worker as w
from tpudp.mesh import make_mesh_nd as jax_make_mesh_nd
from tpudp.models.gpt2 import gpt2_small as jax_gpt2_small
from tpudp.models.moe import MoeMlp as JaxMoeMlp
from tpudp.parallel.expert import make_ep_train_step as jax_ep_step
from tpudp.parallel.sync import get_sync
from tpudp.train import _loss_and_updates
from tpudp.train import init_state as jax_init_state
from tpudp.train import make_optimizer as jax_make_optimizer
from tpudp_torch import train
from tpudp_torch.mesh import MeshND
from tpudp_torch.models import gpt2, moe
from tpudp_torch.parallel.expert import make_ep_train_step

EP = dict(rtol=1e-5, atol=1e-6)  # tests/test_expert.py


def _layer(top_k, cf, e=4, d=16, seed=0):
    rng = np.random.default_rng(seed)
    params = moe.random_params(d, e, 4, rng)
    params["gate"] = params["gate"] * 50  # sharp, varied routing
    x = rng.normal(size=(2, 8, d)).astype(np.float32)
    port = moe.MoeMlp(d, e, 4, cf, top_k)
    port.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()},
                         strict=False)
    flax = JaxMoeMlp(num_experts=e, capacity_factor=cf, top_k=top_k)
    return params, x, port, flax


@pytest.mark.parametrize("top_k,cf", [(1, 4.0), (2, 4.0), (1, 0.5),
                                      (2, 0.5)],
                         ids=["top1", "top2", "top1-drops", "top2-drops"])
def test_moe_mlp_matches_flax(top_k, cf):
    params, x, port, flax = _layer(top_k, cf)
    want, inter = flax.apply({"params": params}, jnp.asarray(x),
                             mutable=["intermediates"])
    got = port(torch.as_tensor(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(port.moe_load.numpy(),
                               np.asarray(inter["intermediates"]["moe_load"][0]),
                               rtol=1e-6)
    np.testing.assert_allclose(port.moe_aux.item(),
                               float(inter["intermediates"]["moe_aux"][0]),
                               rtol=1e-5)
    if cf < 1:  # some tokens found their expert full and add nothing
        dropped = (got.abs().sum(-1) == 0).sum().item()
        assert dropped == int((np.abs(np.asarray(want)).sum(-1) == 0).sum())


def test_moe_mlp_gradients_match_flax():
    """d(sum(y * c) + aux)/d(params, x) through routing and capacity."""
    params, x, port, flax = _layer(2, 1.0, seed=3)
    c = np.random.default_rng(4).normal(size=x.shape).astype(np.float32)

    def loss(p, xx):
        y, inter = flax.apply({"params": p}, xx, mutable=["intermediates"])
        return (y * c).sum() + inter["intermediates"]["moe_aux"][0]

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_(True)
    y = port(xt)
    ((y * torch.as_tensor(c)).sum() + port.moe_aux).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-4,
                               atol=1e-6)
    for name in moe.PARAM_NAMES:
        np.testing.assert_allclose(getattr(port, name).grad.numpy(),
                                   np.asarray(gp[name]), rtol=1e-4,
                                   atol=1e-6, err_msg=name)


def test_collect_moe_aux_is_the_layers_mean():
    model = gpt2.GPT2(gpt2.GPT2Config(**w.MOE_CFG))
    model.load_state_dict(gpt2.params_from_jax(w.strategy_tree(w.MOE_CFG)))
    assert moe.collect_moe_aux(model) == 0.0  # no forward yet
    model(torch.as_tensor(w.lm_batches(64, 1)[0][0]))
    auxes = [blk.moe.moe_aux for blk in model.h]
    torch.testing.assert_close(moe.collect_moe_aux(model),
                               sum(auxes) / len(auxes))
    dense = gpt2.GPT2(gpt2.GPT2Config(**w.TP_CFG))
    assert moe.collect_moe_aux(dense) == 0.0


def test_moe_gpt2_matches_flax_and_round_trips():
    tree = w.strategy_tree(w.MOE_CFG)
    tokens = w.lm_batches(64, 1)[0][0]
    want = np.asarray(jax.jit(jax_gpt2_small(**w.MOE_CFG).apply)(
        {"params": tree}, jnp.asarray(tokens)))
    model = gpt2.GPT2(gpt2.GPT2Config(**w.MOE_CFG))
    model.load_state_dict(gpt2.params_from_jax(tree))
    with torch.no_grad():
        got = model(torch.as_tensor(tokens)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    back = gpt2.params_to_jax(model.state_dict())
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a), b.numpy()), tree, back)


def test_default_step_with_balance_loss_matches_jax():
    """The single-device step adds 0.01 x the MoE aux to its objective,
    as JAX's ``_loss_and_updates`` does; the logged loss is the CE."""
    tree = w.strategy_tree(w.MOE_CFG)
    jmodel = jax_gpt2_small(**w.MOE_CFG)
    tx = jax_make_optimizer(learning_rate=w.STRATEGY_LR)
    state = jax_init_state(jmodel, tx, input_shape=(1, 8))
    params = jax.tree.map(jnp.asarray, tree)
    state = state.replace(params=params, opt_state=tx.init(params))
    model = gpt2.GPT2(gpt2.GPT2Config(**w.MOE_CFG))
    model.load_state_dict(gpt2.params_from_jax(tree))
    spec = train.make_optimizer(learning_rate=w.STRATEGY_LR)
    st = train.init_state(model, spec)
    step = train.make_train_step(model, spec)
    jstep = jax.jit(lambda s, x, y: _loss_and_updates(
        jmodel, tx, s, x, y, get_sync("none"), None))
    for x, y in w.lm_batches(64, steps=2):
        state, jl = jstep(state, jnp.asarray(x), jnp.asarray(y))
        st, pl = step(st, torch.as_tensor(x), torch.as_tensor(y))
        np.testing.assert_allclose(float(pl), float(jl), **EP)
    got = train.state_to_jax(st)["params"]["h_0"]["moe"]["gate"].numpy()
    np.testing.assert_allclose(got, np.asarray(state.params["h_0"]["moe"]
                                               ["gate"]), rtol=1e-5,
                               atol=1e-6)


@pytest.fixture(scope="module")
def ep_world(tmp_path_factory):
    return w.run_world(tmp_path_factory.mktemp("ep4"), 4, ["ep"])


def test_ep_matches_jax(ep_world):
    mesh = jax_make_mesh_nd({"data": 2, "expert": 2},
                            devices=jax.devices()[:4])
    model = jax_gpt2_small(**w.MOE_CFG, expert_axis="expert")
    tx = jax_make_optimizer(learning_rate=w.STRATEGY_LR)
    state = jax_init_state(model, tx, input_shape=(1, 8))
    params = jax.tree.map(jnp.asarray, w.strategy_tree(w.MOE_CFG))
    state = state.replace(params=params, opt_state=tx.init(params))
    state, step = jax_ep_step(model, tx, mesh, state, aux_loss_coef=0.0,
                              donate=False)
    losses = []
    for x, y in w.lm_batches(64):
        state, loss = step(state, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(loss))
    want = jax.device_get(state.params)
    for r in ep_world:
        got = r["ep"]
        np.testing.assert_allclose(got["losses"], losses, **EP)
        # this rank holds 2 of the 4 experts a layer
        assert got["local_shapes"]["h.0.moe.experts_w1"] == (2, 32, 128)
    got = ep_world[0]["ep"]["params"]
    for name in ("experts_w1", "experts_b2", "gate"):
        np.testing.assert_allclose(np.asarray(got["h_0"]["moe"][name]),
                                   np.asarray(want["h_0"]["moe"][name]),
                                   atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.asarray(got["wte"]["embedding"]),
                               np.asarray(want["wte"]["embedding"]),
                               atol=1e-5, rtol=0)


def _fake_mesh(shape):
    """A mesh whose groups are never used: the refusals come first."""
    return MeshND(shape=shape, rank=0, coords={a: 0 for a in shape},
                  groups={a: None for a in shape})


def test_ep_refusals():
    cfg = gpt2.GPT2Config(**w.MOE_CFG, expert_axis="expert")
    model = gpt2.GPT2(cfg)
    spec = train.make_optimizer()
    state = train.init_state(model, spec)
    with pytest.raises(ValueError, match="not divisible"):
        make_ep_train_step(model, spec, _fake_mesh({"data": 1, "expert": 8}),
                           state)
    dense = gpt2.GPT2(gpt2.GPT2Config(**w.TP_CFG))
    with pytest.raises(ValueError, match="mlp_impl='moe'"):
        make_ep_train_step(dense, spec, _fake_mesh({"data": 1, "expert": 2}),
                           train.init_state(dense, spec))
    with pytest.raises(ValueError, match="top_k"):
        moe.MoeMlp(16, 4, top_k=5)
