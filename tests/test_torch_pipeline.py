"""The port's pipeline rung (``gpipe`` and ``1f1b``) against the JAX
package's ``make_pp_train_step``, on the CPU.

One gloo world of 4 ranks (``tests/torch_dp_worker.py`` job ``pp``)
trains the JAX pipeline tests' GPT-2 (4 layers, 2 heads, d 32) on a
(data 2, pipe 2) mesh with 2 microbatches for 3 steps under each
schedule: losses at ``tests/test_pipeline.py``'s rtol 1e-5 / atol 1e-6
and the stacked ``blocks`` parameters at its atol 1e-5, each stage
holding its 2 layers; 1f1b keeps at most ``2S - 1`` microbatch inputs.
The stack/unstack relayout and the refusals are held to JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dp_worker as w
from tpudp.mesh import make_mesh_nd as jax_make_mesh_nd
from tpudp.models.gpt2 import gpt2_small as jax_gpt2_small
from tpudp.parallel.pipeline import make_pp_train_step as jax_pp_step
from tpudp.parallel.pipeline import stack_block_params as jax_stack
from tpudp.train import init_state as jax_init_state
from tpudp.train import make_optimizer as jax_make_optimizer
from tpudp_torch import train
from tpudp_torch.mesh import MeshND
from tpudp_torch.models import gpt2
from tpudp_torch.parallel import pipeline
from tpudp_torch.strategy import build_strategy

PP = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return w.run_world(tmp_path_factory.mktemp("pp4"), 4, ["pp"])


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pp_matches_jax_trajectory(world4, schedule):
    mesh = jax_make_mesh_nd({"data": 2, "pipe": 2},
                            devices=jax.devices()[:4])
    model = jax_gpt2_small(**w.PP_CFG)
    tx = jax_make_optimizer(learning_rate=w.STRATEGY_LR)
    state = jax_init_state(model, tx, input_shape=(1, 8))
    params = jax.tree.map(jnp.asarray, w.strategy_tree(w.PP_CFG))
    state = state.replace(params=params, opt_state=tx.init(params))
    state, step = jax_pp_step(model, tx, mesh, state, n_microbatches=2,
                              donate=False, schedule=schedule)
    losses = []
    for x, y in w.lm_batches(64):
        state, loss = step(state, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(loss))
    want = jax.device_get(state.params)
    for rank, r in enumerate(world4):
        got = r["pp"][schedule]
        np.testing.assert_allclose(got["losses"], losses, **PP)
        # stage (rank % 2) holds its 2 of the 4 layers
        assert {k.split(".")[1] for k in got["local_shapes"]
                if k.startswith("h.")} == {"0", "1"}
        if schedule == "1f1b":
            assert 1 <= got["peak_stash"] <= 2 * 2 - 1
    got = world4[0]["pp"][schedule]["params"]
    assert got["blocks"]["attn"]["qkv"]["kernel"].shape == (4, 32, 96)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        np.asarray(b), np.asarray(a), atol=1e-5, rtol=0), want, got)


def test_stack_unstack_roundtrip():
    tree = w.strategy_tree(w.PP_CFG)
    stacked = pipeline.stack_block_params(tree, 4)
    jax.tree.map(np.testing.assert_array_equal, stacked,
                 jax.device_get(jax_stack(jax.tree.map(jnp.asarray, tree),
                                          4)))
    jax.tree.map(np.testing.assert_array_equal,
                 pipeline.unstack_block_params(stacked), tree)


def _fake_mesh(shape):
    return MeshND(shape=shape, rank=0, coords={a: 0 for a in shape},
                  groups={a: None for a in shape})


def _state(cfg):
    model = gpt2.GPT2(gpt2.GPT2Config(**cfg))
    spec = train.make_optimizer()
    return model, spec, train.init_state(model, spec)


def test_pp_refusals():
    model, spec, state = _state(w.PP_CFG)
    with pytest.raises(ValueError, match="not divisible"):
        pipeline.make_pp_train_step(model, spec,
                                    _fake_mesh({"data": 1, "pipe": 8}),
                                    state, n_microbatches=2)
    mesh = _fake_mesh({"data": 1, "pipe": 2})
    with pytest.raises(ValueError, match="unknown schedule"):
        pipeline.make_pp_train_step(model, spec, mesh, state,
                                    n_microbatches=2, schedule="interleaved")
    built = build_strategy("pp", model, spec, mesh, state, n_microbatches=2,
                           schedule="1f1b_mpmd", interleave=2)
    assert built.train_step.partition.layer_order() == (0, 2, 1, 3)
    for extra in ({"mlp_impl": "moe", "num_experts": 2},
                  {"attn_impl": "ring", "seq_axis": "seq"}):
        m, s, st = _state(dict(w.PP_CFG, **extra))
        with pytest.raises(ValueError, match="dense/flash attention"):
            pipeline.make_pp_train_step(m, s, mesh, st, n_microbatches=2)
    with pytest.raises(ValueError, match="skip_nonfinite"):
        pipeline.make_pp_train_step(
            model, train.make_optimizer(skip_nonfinite=2), mesh, state,
            n_microbatches=2)
    with pytest.raises(TypeError, match="GPT2"):
        pipeline.make_pp_train_step(object(), spec, mesh, state,
                                    n_microbatches=2)
