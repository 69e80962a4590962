"""The port's MPMD pipeline schedule (``schedule='1f1b_mpmd'``,
``tpudp_torch.parallel.schedule``) against the JAX package's
``tpudp/parallel/schedule.py``, on the CPU.

One gloo world of 4 ranks (``tests/torch_dp_worker.py`` job
``schedule``) trains the JAX schedule tests' GPT-2 (4 layers, 2 heads, d
32, 2 microbatches, 3 steps) at every geometry of
``SCHEDULE_GEOMETRIES``: pipe 1, 2 and 4, interleave 2, data 1 and 2,
with and without the in-step sharded optimizer.  At equal DP the loss
trajectories are bit-equal across the geometries and the parameters
within 1e-7 (JAX's own discipline, ``tests/test_schedule.py``); every
geometry is held to JAX's single-stage ``make_pipeline_train_step`` on
one device at rtol 1e-5 / atol 1e-6 (JAX's tests hold its geometries
bit-exact to that baseline, so its multi-device programs are not
traced here).  The checkpoint tree has JAX's ``pp_state`` shapes, a
rank's momentum is its 1/(PP*DP) of the blocks, the eval twin matches
the dense forward, and a step fault under the Trainer's supervisor
recovers bit-equal to a clean run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_worker as w
from tpudp.mesh import make_mesh_nd as jax_make_mesh_nd
from tpudp.models.gpt2 import gpt2_small as jax_gpt2_small
from tpudp.parallel import schedule as jax_schedule
from tpudp.train import init_state as jax_init_state
from tpudp.train import make_optimizer as jax_make_optimizer
from tpudp.utils.flops import pipeline_bubble_fraction as jax_bubble
from tpudp_torch import train
from tpudp_torch.mesh import MeshND
from tpudp_torch.models import gpt2, llama
from tpudp_torch.parallel import schedule
from tpudp_torch.strategy import build_strategy

TO_JAX = dict(rtol=1e-5, atol=1e-6)
ULP = dict(rtol=0, atol=1e-7)
LAYERS = w.PP_CFG["num_layers"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite's workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _geometry(name):
    shape, interleave, shard = w.SCHEDULE_GEOMETRIES[name]
    return shape["pipe"], shape["data"], interleave, shard


DP1 = [n for n in w.SCHEDULE_GEOMETRIES if _geometry(n)[1] == 1]
DP2 = [n for n in w.SCHEDULE_GEOMETRIES if _geometry(n)[1] == 2]


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return [r["schedule"] for r in w.run_world(
        tmp_path_factory.mktemp("mpmd4"), 4, ["schedule"])]


@pytest.fixture(scope="module")
def jax_baseline():
    """JAX's single-stage MPMD step (pipe 1, data 1) on one device:
    losses and the standard-layout parameters after 3 steps."""
    mesh = jax_make_mesh_nd({"data": 1, "pipe": 1},
                            devices=jax.devices()[:1])
    model = jax_gpt2_small(**w.PP_CFG)
    tx = jax_make_optimizer(learning_rate=w.STRATEGY_LR)
    state = jax_init_state(model, tx, input_shape=(1, 8))
    params = jax.tree.map(jnp.asarray, w.strategy_tree(w.PP_CFG))
    state = state.replace(params=params, opt_state=tx.init(params))
    state, step = jax_schedule.make_pipeline_train_step(
        model, tx, mesh, state, n_microbatches=2, donate=False)
    losses = []
    for x, y in w.lm_batches(64):
        state, loss = step(state, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(loss))
    part = jax_schedule.StagePartition(LAYERS, 1)
    return losses, jax_schedule.unstack_partitioned(
        jax.device_get(state.params), part)


def _params(result, name):
    pp, _, interleave, _ = _geometry(name)
    part = schedule.StagePartition(LAYERS, pp, interleave)
    return schedule.unstack_partitioned(result[name]["params"], part)


# -- placement ----------------------------------------------------------------

@pytest.mark.parametrize("layers,stages,interleave",
                         [(8, 2, 2), (8, 4, 1), (12, 2, 3), (4, 1, 4)])
def test_stage_partition_matches_jax(layers, stages, interleave):
    ours = schedule.StagePartition(layers, stages, interleave)
    theirs = jax_schedule.StagePartition(layers, stages, interleave)
    assert (ours.chunks, ours.layers_per_chunk) == (
        theirs.chunks, theirs.layers_per_chunk)
    assert ours.layer_order() == theirs.layer_order()
    for c in range(ours.chunks):
        assert ours.chunk_layers(c) == theirs.chunk_layers(c)
        assert ours.chunk_stage(c) == theirs.chunk_stage(c)
    for s in range(stages):
        assert ours.stage_chunks(s) == theirs.stage_chunks(s)
        assert ours.stage_layers(s) == theirs.stage_layers(s)
    for m in (1, 4, 7):
        assert ours.ticks(m) == theirs.ticks(m)
        assert ours.bubble_fraction(m) == theirs.bubble_fraction(m)


@pytest.mark.parametrize("stages,m,v", [(1, 4, 1), (4, 4, 1), (4, 4, 2),
                                        (2, 8, 3)])
def test_bubble_fraction_matches_jax(stages, m, v):
    assert schedule.pipeline_bubble_fraction(stages, m, v) == jax_bubble(
        stages, m, v)


def test_stage_partition_rejects_what_jax_rejects():
    for args, match in (((6, 4), "not divisible"),
                        ((8, 2, 3), "not divisible"), ((8, 0), ">= 1")):
        with pytest.raises(ValueError, match=match):
            schedule.StagePartition(*args)
        with pytest.raises(ValueError, match=match):
            jax_schedule.StagePartition(*args)
    with pytest.raises(ValueError, match=">= 1"):
        schedule.pipeline_bubble_fraction(2, 0)


@pytest.mark.parametrize("stages,interleave", [(2, 2), (4, 1), (1, 4)])
def test_stack_partitioned_matches_jax(stages, interleave):
    tree = w.strategy_tree(w.PP_CFG)
    part = schedule.StagePartition(LAYERS, stages, interleave)
    stacked = schedule.stack_partitioned(tree, part)
    jax.tree.map(np.testing.assert_array_equal, stacked, jax.device_get(
        jax_schedule.stack_partitioned(
            jax.tree.map(jnp.asarray, tree),
            jax_schedule.StagePartition(LAYERS, stages, interleave))))
    jax.tree.map(np.testing.assert_array_equal,
                 schedule.unstack_partitioned(stacked, part), tree)


# -- trajectories -------------------------------------------------------------

@pytest.mark.parametrize("name", DP1[1:] + DP2[1:])
def test_loss_trajectory_bitexact_at_equal_dp(world4, name):
    """The losses of every geometry equal (no tolerance) those of pipe 1
    at the same DP, on every rank."""
    base = "pp1-dp1" if name in DP1 else "pp1-dp2"
    for r in world4:
        assert r[name]["losses"] == world4[0][base]["losses"]


@pytest.mark.parametrize("name", DP1[1:] + DP2[1:])
def test_param_trajectory_within_ulp(world4, name):
    base = "pp1-dp1" if name in DP1 else "pp1-dp2"
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        np.asarray(b), np.asarray(a), **ULP),
        _params(world4[0], base), _params(world4[0], name))


@pytest.mark.parametrize("name", list(w.SCHEDULE_GEOMETRIES))
def test_matches_jax_single_stage(world4, jax_baseline, name):
    losses, params = jax_baseline
    np.testing.assert_allclose(world4[0][name]["losses"], losses, **TO_JAX)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        np.asarray(b), np.asarray(a), atol=1e-5, rtol=0),
        params, _params(world4[0], name))


def test_remat_is_bit_equal(world4):
    """``remat=True`` checkpoints each block (JAX's
    ``jax.checkpoint(block_fn)``): the same losses and parameters."""
    for r in world4:
        assert r["pp2-dp2-remat"]["losses"] == r["pp2-dp2"]["losses"]
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a), np.asarray(b)), world4[0]["pp2-dp2"]["params"],
        world4[0]["pp2-dp2-remat"]["params"])


def test_adamw_shards_match_the_one_device_step(world4):
    """AdamW on the 1/DP shards is the one-device AdamW step (the port's,
    held to optax by tests/test_torch_train.py); its ``mu`` and ``nu`` are
    in JAX's ``_opt_shard_layout`` and its count is the step's."""
    model = gpt2.GPT2(gpt2.GPT2Config(**w.PP_CFG))
    model.load_state_dict(gpt2.params_from_jax(w.strategy_tree(w.PP_CFG)))
    spec = train.make_optimizer(learning_rate=w.STRATEGY_LR,
                                optimizer="adamw")
    state = train.init_state(model, spec)
    step = train.make_train_step(model, spec)
    want = []
    for x, y in w.lm_batches(64):
        state, loss = step(state, torch.as_tensor(x), torch.as_tensor(y))
        want.append(float(loss))
    got = world4[0]["pp2-dp2-adamw"]
    np.testing.assert_allclose(got["losses"], want, **TO_JAX)
    part = jax_schedule.StagePartition(LAYERS, 2)
    shapes = jax.eval_shape(
        lambda t: jax_schedule._opt_shard_layout(t, part, 2),
        jax.tree.map(jnp.asarray, w.strategy_tree(w.PP_CFG)))
    for key in ("mu", "nu"):
        jax.tree.map(lambda a, b: np.testing.assert_equal(
            tuple(b.shape), tuple(a.shape)), shapes, got["opt_state"][key])
    assert int(got["opt_state"]["count"]) == 3


def test_dp_replicas_hold_equal_parameters(world4):
    """After the all-gather the replicas of a stage hold the same bits
    (the checkpoint trees every rank gathers are equal)."""
    for name in DP2:
        for r in world4[1:]:
            jax.tree.map(lambda a, b: np.testing.assert_array_equal(
                np.asarray(a), np.asarray(b)),
                world4[0][name]["params"], r[name]["params"])


def test_peak_stash_is_bounded(world4):
    for name in w.SCHEDULE_GEOMETRIES:
        pp, _, interleave, _ = _geometry(name)
        chunks = pp * interleave
        for r in world4:
            assert r[name]["peak_stash"] <= min(2, 2 * chunks - 1)


# -- state layout -------------------------------------------------------------

@pytest.mark.parametrize("name", list(w.SCHEDULE_GEOMETRIES))
def test_checkpoint_tree_has_jax_pp_state_shapes(world4, name):
    pp, dp, interleave, shard = _geometry(name)
    part = jax_schedule.StagePartition(LAYERS, pp, interleave)
    tree = jax.tree.map(jnp.asarray, w.strategy_tree(w.PP_CFG))
    if shard:
        want = jax.eval_shape(
            lambda t: jax_schedule._opt_shard_layout(t, part, dp), tree)
    else:
        want = jax.eval_shape(
            lambda t: jax_schedule.stack_partitioned(t, part), tree)
    got = world4[0][name]["momentum"]
    jax.tree.map(lambda a, b: np.testing.assert_equal(
        tuple(b.shape), tuple(a.shape)), want, got)
    params = jax.eval_shape(
        lambda t: jax_schedule.stack_partitioned(t, part), tree)
    jax.tree.map(lambda a, b: np.testing.assert_equal(
        tuple(b.shape), tuple(a.shape)), params, world4[0][name]["params"])


@pytest.mark.parametrize("name", ["pp2-dp1", "pp4-dp1", "pp1-dp2",
                                  "pp2-dp2", "pp2v2-dp2"])
def test_momentum_is_a_rank_share(world4, name):
    """In-step ZeRO-1: a rank holds 1/(PP*DP) of the blocks' momentum and
    1/DP of the shared parameters' (no padding at these widths)."""
    pp, dp, _, _ = _geometry(name)
    tree = w.strategy_tree(w.PP_CFG)
    shared = sum(a.nbytes for k, v in tree.items()
                 if not k.startswith("h_") for a in jax.tree.leaves(v))
    blocks = sum(a.nbytes for k, v in tree.items() if k.startswith("h_")
                 for a in jax.tree.leaves(v))
    for r in world4:
        assert r[name]["bytes"]["opt_state"] == blocks // (pp * dp) + \
            shared // dp


def test_unsharded_optimizer_keeps_stage_stacked_momentum(world4):
    r = world4[0]["pp2-dp2-unsharded"]
    assert r["bytes"]["opt_state"] == r["bytes"]["params"]


def test_opt_shard_layout_round_trips():
    tree = {k: jax.tree.map(torch.as_tensor, v)
            for k, v in w.strategy_tree(w.PP_CFG).items()}
    part = schedule.StagePartition(LAYERS, 2, 2)
    flat = schedule.opt_shard_layout(tree, part, 3)  # padded to thirds
    want = jax_schedule._opt_shard_layout(
        jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree),
        jax_schedule.StagePartition(LAYERS, 2, 2), 3)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        b.numpy(), np.asarray(a)), want, flat)
    back = schedule._opt_unshard(flat, schedule.stack_partitioned(tree, part),
                                 part)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a.numpy(),
                                                            b.numpy()),
                 tree, back)


# -- eval and the supervisor --------------------------------------------------

def test_eval_step_matches_dense_forward(world4):
    params = _params(world4[0], "pp2-dp2")
    model = gpt2.GPT2(gpt2.GPT2Config(**w.PP_CFG))
    model.load_state_dict(gpt2.params_from_jax(params))
    x, y = w.lm_batches(64, steps=1, seed=w.SCHEDULE_EVAL_SEED)[0]
    want = train.eval_metrics(model, torch.as_tensor(x), torch.as_tensor(y),
                              torch.ones(8))
    for r in world4:
        np.testing.assert_allclose(r["eval"], want.numpy(), rtol=1e-5)
    assert world4[0]["eval"][2] == x.size


def test_stage_fault_recovers_bit_exact(world4):
    for r in world4:
        assert r["fit-clean"]["step_retries"] == 0
        assert r["fit-fault"]["step_retries"] == 1
        assert "step_retry" in r["fit-fault"]["events"]
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(
            np.asarray(a), np.asarray(b)),
            r["fit-clean"]["params"], r["fit-fault"]["params"])


# -- refusals -----------------------------------------------------------------

def _fake_mesh(shape):
    return MeshND(shape=shape, rank=0, coords={a: 0 for a in shape},
                  groups={a: None for a in shape})


def test_mpmd_refusals():
    model = gpt2.GPT2(gpt2.GPT2Config(**w.PP_CFG))
    spec = train.make_optimizer()
    state = train.init_state(model, spec)
    mesh = _fake_mesh({"data": 1, "pipe": 2})
    opts = dict(n_microbatches=2, schedule="1f1b_mpmd")
    with pytest.raises(ValueError, match="not divisible"):
        build_strategy("pp", model, spec, mesh, state, interleave=3, **opts)
    with pytest.raises(ValueError, match="clip_norm"):
        build_strategy("pp", model, train.make_optimizer(clip_norm=1.0),
                       mesh, state, **opts)
    with pytest.raises(ValueError, match="skip_nonfinite"):
        build_strategy("pp", model, train.make_optimizer(skip_nonfinite=2),
                       mesh, state, **opts)
    with pytest.raises(TypeError, match="unknown option"):
        build_strategy("pp", model, spec, mesh, state, zz=1, **opts)
    with pytest.raises(ValueError, match="n_microbatches"):
        build_strategy("pp", model, spec, mesh, state,
                       **dict(opts, n_microbatches=0))
    ring = gpt2.GPT2(gpt2.GPT2Config(**w.PP_CFG, attn_impl="ring",
                                     seq_axis="seq"))
    with pytest.raises(ValueError, match="dense/flash attention"):
        build_strategy("pp", ring, spec, mesh, train.init_state(ring, spec),
                       **opts)
    lm = llama.Llama(llama.LlamaConfig(vocab_size=64, max_seq_len=32,
                                       num_layers=4, num_heads=2,
                                       d_model=32))
    with pytest.raises(ValueError, match="LLaMA model trains under"):
        build_strategy("pp", lm, spec, mesh, train.init_state(lm, spec),
                       **opts)
