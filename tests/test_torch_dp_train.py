"""The port's data-parallel train step (``tpudp_torch.train`` with a
``Mesh``) against the JAX package's ``shard_map`` step, on the CPU.

Worlds of 2 and 4 gloo ranks (``tests/torch_dp_worker.py``, spawned once
per world for the module) train a narrow VGG (``(8, 'M', 16, 'M', 'M',
'M', 'M')``, 8 rows a rank) for 3 steps with each of the 11 rungs of the
sync ladder and with ``compress='int8_ef'``; the JAX step does the same
on ``make_mesh(2)`` and on ``mesh4`` (device r takes the rows rank r
takes).  Parameters, BatchNorm running statistics and per-step losses
agree at ``tests/test_sync.py``'s tolerances, the int8 rungs within
their quantization grid; every rank ends with the same state.  The
eval sums and a GPT-2 tiny step at world 2 are held to JAX likewise, and
so are the tiny ViT's steps under the all-reduce rung at world 2, through
``make_train_step`` and through the Trainer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_worker as w
from tpudp.mesh import make_mesh as jax_make_mesh
from tpudp.models.gpt2 import gpt2_small as jax_gpt2_small
from tpudp.models.vgg import VGG as JaxVGG
from tpudp.parallel.compress import state_partition_specs
from tpudp.train import (init_state as jax_init_state,
                         make_eval_step as jax_make_eval_step,
                         make_optimizer as jax_make_optimizer,
                         make_train_step as jax_make_train_step)
from tpudp_torch.models import gpt2, vgg

# tests/test_sync.py's tolerances for the exact rungs and for bf16.
EXACT = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture(scope="module")
def port_worlds(tmp_path_factory):
    """Each world's per-rank results, from one spawn per world."""
    return {n: w.run_world(tmp_path_factory.mktemp(f"world{n}"), n,
                           ["steps", "eval"]
                           + (["gpt2", "vit"] if n == 2 else []))
            for n in (2, 4)}


@pytest.fixture(scope="module")
def jax_meshes(mesh4):
    return {2: jax_make_mesh(2), 4: mesh4}


def _jax_steps(mesh, case):
    """The JAX step's per-step losses and final (params, batch_stats)."""
    n = mesh.size
    params, stats = w.vgg_init()
    compress = "int8_ef" if case == "int8_ef" else None
    model = JaxVGG(cfg=w.CFG)
    tx = jax_make_optimizer(**w.SGD, compress=compress,
                            compress_devices=n if compress else None)
    state = jax_init_state(model, tx).replace(
        params=jax.tree.map(jnp.asarray, params),
        batch_stats=jax.tree.map(jnp.asarray, stats))
    state = state.replace(opt_state=tx.init(state.params))
    specs = state_partition_specs(state) if compress else None
    step = jax_make_train_step(model, tx, mesh, "none" if compress else case,
                               donate=False, state_specs=specs)
    losses = []
    for x, y in w.vgg_batches(n):
        state, loss = step(state, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(loss))
    return losses, vgg.params_from_jax(jax.device_get(state.params),
                                       jax.device_get(state.batch_stats))


def _tolerance(case, n, units):
    """The case's tolerance on the final state: tests/test_sync.py's exact
    and bf16 ones, and for the int8 rungs their quantization grid.  The
    two frameworks' gradients differ in their last bits, so a value at a
    rounding edge may land one tick away on any rank: the mean moves by
    up to ``unit`` a step (``allreduce_int8``, which divides the total by
    n) or ``n * unit`` (``int8_ef``, which divides before quantizing).
    Three SGD steps with momentum 0.9 carry step t's error with weight
    1 + 0.9 + 0.81 at most."""
    if case == "allreduce_bf16":
        return BF16
    if case in ("allreduce_int8", "int8_ef"):
        per_step = max(units) * (n if case == "int8_ef" else 1)
        return dict(rtol=1e-5, atol=w.SGD["learning_rate"] * 2.71
                    * len(units) * per_step)
    return EXACT


CASE_IDS = [(n, case) for n in (2, 4) for case in w.CASES]


@pytest.mark.parametrize("world,case", CASE_IDS,
                         ids=[f"w{n}-{c}" for n, c in CASE_IDS])
def test_rung_matches_the_jax_step(port_worlds, jax_meshes, world, case):
    """3 steps of one rung at one world size: loss per step, parameters and
    BatchNorm running statistics against JAX; every rank the same."""
    ranks = [r["steps"][case] for r in port_worlds[world]]
    want_losses, want = _jax_steps(jax_meshes[world], case)
    tol = _tolerance(case, world, ranks[0]["units"])
    got = ranks[0]
    loss_tol = EXACT if tol is EXACT else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got["losses"], want_losses, **loss_tol)
    np.testing.assert_allclose(got["loss_sum"], sum(got["losses"]),
                               rtol=1e-6)
    assert set(got["state"]) == set(want)
    for name, value in want.items():
        np.testing.assert_allclose(got["state"][name].numpy(),
                                   value.numpy(), **tol, err_msg=name)
    # Replicas stay bit-identical; without sync only the averaged loss
    # and running statistics are shared (rank 0's parameters are JAX's:
    # out_specs P() returns device 0's).
    for other in ranks[1:]:
        assert other["losses"] == got["losses"]
        for name, value in got["state"].items():
            if case != "none" or "running" in name:
                assert torch.equal(other["state"][name], value), name


@pytest.mark.parametrize("world", [2, 4])
def test_rungs_differ_from_no_sync(port_worlds, world):
    """Guard against a vacuous match: 'none' trains each rank on its own
    rows, so its ranks part ways while every synchronized rung's agree."""
    ranks = [r["steps"] for r in port_worlds[world]]
    a, b = ranks[0]["none"]["state"], ranks[1]["none"]["state"]
    assert not torch.equal(a["convs.0.weight"], b["convs.0.weight"])


@pytest.mark.parametrize("world", [2, 4])
def test_eval_sums_match_jax(port_worlds, jax_meshes, world):
    """Weighted (loss_sum, correct, count) over every rank's shard of one
    batch with padding weights, all-reduced: JAX's psum-ed sums."""
    params, stats = w.eval_stats()
    mesh = jax_meshes[world]
    model = JaxVGG(cfg=w.CFG)
    tx = jax_make_optimizer()
    state = jax_init_state(model, tx).replace(
        params=jax.tree.map(jnp.asarray, params),
        batch_stats=jax.tree.map(jnp.asarray, stats))
    images, labels, weights = w.eval_batch(world)
    want = [float(v) for v in jax_make_eval_step(model, mesh)(
        state, jnp.asarray(images), jnp.asarray(labels),
        jnp.asarray(weights))]
    for rank in port_worlds[world]:
        np.testing.assert_allclose(rank["eval"], want, rtol=1e-5, atol=1e-5)
    assert want[2] == weights.sum()


def test_gpt2_step_matches_jax_at_world_2(port_worlds):
    """Two GPT-2 tiny steps with the all-reduce rung at world 2: losses and
    parameters against JAX's make_train_step on a 2-device mesh."""
    model = jax_gpt2_small(**w.GPT2_CFG)
    tx = jax_make_optimizer(learning_rate=0.01)
    params = jax.tree.map(jnp.asarray, w.gpt2_tree())
    state = jax_init_state(model, tx, input_shape=(1, 32)).replace(
        params=params, opt_state=tx.init(params))
    step = jax_make_train_step(model, tx, jax_make_mesh(2), "allreduce",
                               donate=False)
    losses = []
    for x, y in w.gpt2_batches(2):
        state, loss = step(state, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(loss))
    want = gpt2.params_from_jax(jax.device_get(state.params))
    for rank in port_worlds[2]:
        got = rank["gpt2"]
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5,
                                   atol=1e-5)
        for name, value in want.items():
            np.testing.assert_allclose(got["state"][name].numpy(),
                                       value.numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=name)


def test_vit_allreduce_matches_jax_at_world_2(port_worlds):
    """The tiny ViT (16/4, 2 layers, d 32), 3 SGD steps with the
    all-reduce rung at world 2, against JAX's make_train_step on a
    2-device mesh (losses and parameters at 1e-5); the port's
    ``Trainer(vit, mesh, sync='allreduce')`` trains the same steps."""
    from tpudp.models.vit import ViT as JaxViT
    from tpudp.models.vit import ViTConfig as JaxViTConfig

    model = JaxViT(JaxViTConfig(**w.VIT_CFG))
    tx = jax_make_optimizer(**w.SGD)
    params = jax.tree.map(jnp.asarray, w.vit_tree())
    state = jax_init_state(model, tx, input_shape=(1, 16, 16, 3)).replace(
        params=params, opt_state=tx.init(params))
    step = jax_make_train_step(model, tx, jax_make_mesh(2), "allreduce",
                               donate=False)
    losses = []
    for x, y in w.vit_batches(2):
        state, loss = step(state, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(loss))
    want = jax.device_get(state.params)
    for rank in port_worlds[2]:
        got = rank["vit"]
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got["trainer_loss_sum"], sum(losses),
                                   rtol=1e-5)
        for key in ("params", "trainer_params"):
            jax.tree.map(lambda a, b: np.testing.assert_allclose(
                np.asarray(b), np.asarray(a), rtol=1e-5, atol=1e-5),
                want, got[key])
