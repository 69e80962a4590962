"""Ring attention and the sequence-parallel rung of the port against the
JAX package, on the CPU.

One gloo world of 4 ranks (``tests/torch_dp_worker.py``, jobs ``ring``
and ``sp``) runs the port; JAX runs the same numbers on the conftest's
virtual devices.  Ring attention's forward (causal and full) and its
gradients (the reverse ring of ``ring_shift``) are held to JAX's ring at
``tests/test_ring_attention.py``'s 2e-5; the DP x SP rung on a (2, 2)
mesh to JAX's ``make_seq_parallel_train_step`` at
``tests/test_seq_parallel.py``'s rtol 5e-4 / atol 1e-5, with its global
positions and its eval sums.  A ring model with its axis unbound runs the
dense math, as in JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import torch_dp_worker as w
from tpudp.mesh import DATA_AXIS
from tpudp.models.gpt2 import gpt2_small as jax_gpt2_small
from tpudp.parallel.ring_attention import (dense_causal_attention,
                                           ring_attention as jax_ring)
from tpudp.train import (init_state as jax_init_state,
                         make_optimizer as jax_make_optimizer,
                         make_seq_parallel_train_step as jax_sp_step,
                         make_sp_eval_step as jax_sp_eval)
from tpudp_torch.models import gpt2
from tpudp_torch.ops import attention
from tpudp_torch.parallel.ring_attention import (
    dense_causal_attention as port_dense_causal)

RING = dict(rtol=2e-5, atol=2e-5)   # tests/test_ring_attention.py
SP = dict(rtol=5e-4, atol=1e-5)     # tests/test_seq_parallel.py


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return w.run_world(tmp_path_factory.mktemp("sp4"), 4, ["ring", "sp"])


@pytest.fixture(scope="module")
def mesh2x2():
    return Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "seq"))


def _blocks(results, key, axis=1):
    return np.concatenate([np.asarray(r[key]) for r in results], axis=axis)


def _jax_ring(mesh4, causal):
    spec = P(None, DATA_AXIS)
    return jax.jit(jax.shard_map(
        lambda q, k, v: jax_ring(q, k, v, DATA_AXIS, causal=causal),
        mesh=mesh4, in_specs=(spec,) * 3, out_specs=spec, check_vma=False))


@pytest.mark.parametrize("causal", [True, False])
def test_ring_forward_matches_jax(world4, mesh4, causal):
    q, k, v, _ = w.ring_inputs()
    want = np.asarray(_jax_ring(mesh4, causal)(q, k, v))
    got = _blocks([r["ring"] for r in world4], f"o-{causal}")
    np.testing.assert_allclose(got, want, **RING)
    if causal:
        np.testing.assert_allclose(
            got, np.asarray(dense_causal_attention(*map(jnp.asarray,
                                                        (q, k, v)))),
            **RING)


def test_ring_gradients_match_jax(world4, mesh4):
    """The backward ring: q, k and v gradients of <out, do> against JAX's
    ring (autodiff's reverse ppermute)."""
    q, k, v, do = (jnp.asarray(a) for a in w.ring_inputs())
    ring = _jax_ring(mesh4, True)
    _, vjp = jax.vjp(ring, q, k, v)
    want = vjp(do)
    for i, name in enumerate("qkv"):
        got = np.concatenate([np.asarray(r["ring"]["grads"][i])
                              for r in world4], axis=1)
        np.testing.assert_allclose(got, np.asarray(want[i]), **RING,
                                   err_msg=f"d{name}")


def test_port_dense_causal_oracle_matches_jax():
    q, k, v, _ = w.ring_inputs(seed=5)
    got = port_dense_causal(*map(torch.as_tensor, (q, k, v))).numpy()
    want = np.asarray(dense_causal_attention(*map(jnp.asarray, (q, k, v))))
    np.testing.assert_allclose(got, want, **RING)


def _jax_sp_state(tx, model):
    state = jax_init_state(model, tx, input_shape=(1, 16), seed=0)
    params = jax.tree.map(jnp.asarray, w.strategy_tree(w.SP_CFG))
    return state.replace(params=params, opt_state=tx.init(params))


def test_sp_matches_jax_trajectory(world4, mesh2x2):
    tx = jax_make_optimizer(learning_rate=w.STRATEGY_LR)
    ring = jax_gpt2_small(attn_impl="ring", seq_axis="seq", **w.SP_CFG)
    state = _jax_sp_state(tx, ring)
    step = jax_sp_step(ring, tx, mesh2x2, donate=False)
    losses = []
    for x, y in w.lm_batches(96, steps=3, batch=4, t=64, seed=0):
        state, loss = step(state, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(loss))
    for r in world4:
        np.testing.assert_allclose(r["sp"]["rung"]["losses"], losses, **SP)
    got = world4[0]["sp"]["rung"]["params"]
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        np.asarray(b), np.asarray(a), **SP), jax.device_get(state.params),
        got)


def test_sp_positions_are_global(world4):
    """Each rank's logits block is the dense model's at global positions
    (a local-vs-global ``wpe`` index would differ on the second half)."""
    tokens, _ = w.lm_batches(96, steps=1, batch=4, t=64, seed=3)[0]
    dense = jax_gpt2_small(**w.SP_CFG)
    want = np.asarray(dense.apply(
        {"params": w.strategy_tree(w.SP_CFG)}, jnp.asarray(tokens)))
    for rank, r in enumerate(world4):
        d, s = divmod(rank, 2)
        block = want[2 * d:2 * d + 2, 32 * s:32 * s + 32]
        np.testing.assert_allclose(np.asarray(r["sp"]["logits"]), block,
                                   rtol=2e-4, atol=2e-4)


def test_sp_eval_matches_jax(world4, mesh2x2):
    tokens, targets = w.lm_batches(96, steps=1, batch=4, t=64, seed=3)[0]
    weights = np.array([1.0, 0.0, 1.0, 1.0], np.float32)
    ring = jax_gpt2_small(attn_impl="ring", seq_axis="seq", **w.SP_CFG)
    tx = jax_make_optimizer(learning_rate=w.STRATEGY_LR)
    want = jax_sp_eval(ring, mesh2x2)(_jax_sp_state(tx, ring),
                                      jnp.asarray(tokens),
                                      jnp.asarray(targets),
                                      jnp.asarray(weights))
    for r in world4:
        np.testing.assert_allclose(r["sp"]["eval"],
                                   [float(x) for x in want], rtol=2e-5)


def test_ring_model_runs_dense_when_unbound():
    """No ``seq`` axis bound (one device, model construction): the ring
    model is the dense one, as JAX's dispatch falls back."""
    tree = w.strategy_tree(w.SP_CFG)
    tokens = torch.as_tensor(w.lm_batches(96, 1, 2, 64, seed=4)[0][0])
    out = {}
    for impl in ("dense", "ring"):
        model = gpt2.GPT2(gpt2.GPT2Config(**w.SP_CFG, attn_impl=impl,
                                          seq_axis="seq"))
        model.load_state_dict(gpt2.params_from_jax(tree))
        with torch.no_grad():
            out[impl] = model(tokens)
    torch.testing.assert_close(out["ring"], out["dense"], rtol=0, atol=0)
    q = torch.randn(1, 16, 2, 8)
    torch.testing.assert_close(
        attention.multihead_attention(q, q, q, causal=True, impl="ring",
                                      seq_axis="seq"),
        attention.dense_attention(q, q, q, causal=True,
                                  dtype=torch.float32))
