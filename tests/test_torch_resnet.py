"""The port's ResNet (``tpudp_torch.models.resnet``) against the flax
model, on the CPU: the same numpy weights through ``params_from_jax``,
the same inputs.

At the JAX package's small test config (``stage_sizes=(1, 1)``, width
16, 32x32 inputs, 10 classes) the train- and eval-mode logits agree with
flax's to 2e-5 in float32 and the running statistics after a train
forward to float32 rounding; three SGD steps at lr 0.01 agree with
JAX's ``make_train_step`` to rtol 1e-5; bfloat16 logits to the VGG
test's two bf16 ulps.  ``random_params`` has flax's tree and shapes, and
ResNet-50/101/152 have flax's parameter counts (from ``jax.eval_shape``
and the meta device: no compute).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_worker as w
from tpudp.models import resnet as jax_resnet
from tpudp.train import (init_state as jax_init_state,
                         make_optimizer as jax_make_optimizer,
                         make_train_step as jax_make_train_step)
from tpudp_torch import train
from tpudp_torch.models import resnet

STAGES, WIDTH = w.RESNET_STAGES, w.RESNET_WIDTH
FWD = dict(atol=2e-5, rtol=2e-5)
STATS = dict(atol=1e-6, rtol=1e-5)
BF16 = dict(atol=2e-2, rtol=1.6e-2)  # tests/test_torch_vgg.py's bf16


def _jax_model(dtype=jnp.float32):
    return jax_resnet.ResNet(stage_sizes=STAGES, num_classes=10,
                             width=WIDTH, dtype=dtype)


def _port_model(params, stats, dtype=torch.float32):
    model = resnet.ResNet(STAGES, 10, WIDTH, dtype=dtype)
    model.load_state_dict(resnet.params_from_jax(params, stats))
    return model


def _x(seed=21, n=8):
    return np.random.default_rng(seed).normal(size=(n, 32, 32, 3)).astype(
        np.float32)


def test_forward_and_running_stats_match_flax():
    params, stats = w.resnet_init()
    x = _x()
    model = _jax_model()
    want, mutated = model.apply({"params": params, "batch_stats": stats},
                                jnp.asarray(x), train=True,
                                mutable=["batch_stats"])
    want_stats = resnet.params_from_jax(params,
                                        jax.device_get(
                                            mutated["batch_stats"]))
    want_eval = model.apply({"params": params,
                             "batch_stats": mutated["batch_stats"]},
                            jnp.asarray(x), train=False)
    port = _port_model(params, stats)
    got = port(torch.as_tensor(x), train=True)
    assert got.dtype == torch.float32 and got.shape == (8, 10)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **FWD)
    state = port.state_dict()
    running = [k for k in state if "running" in k]
    assert len(running) == 2 * 9  # stem + 2 blocks x (3 + projection)
    for name in running:
        np.testing.assert_allclose(state[name].numpy(),
                                   want_stats[name].numpy(), **STATS,
                                   err_msg=name)
    with torch.no_grad():
        got_eval = port(torch.as_tensor(x), train=False)
    np.testing.assert_allclose(got_eval.numpy(), np.asarray(want_eval),
                               **FWD)


def test_three_sgd_steps_match_jax():
    """make_train_step without a mesh against JAX's single-device step:
    per-step losses and every parameter and statistic, rtol 1e-5."""
    params, stats = w.resnet_init()
    model = _jax_model()
    tx = jax_make_optimizer(learning_rate=0.01)
    state = jax_init_state(model, tx, input_shape=(1, 32, 32, 3)).replace(
        params=jax.tree.map(jnp.asarray, params),
        batch_stats=jax.tree.map(jnp.asarray, stats))
    state = state.replace(opt_state=tx.init(state.params))
    jstep = jax_make_train_step(model, tx, None, "none", donate=False)
    port = _port_model(params, stats)
    spec = train.make_optimizer(learning_rate=0.01)
    pstate = train.init_state(port, spec)
    pstep = train.make_train_step(port, spec)
    rng = np.random.default_rng(22)
    for _ in range(3):
        x = _x(int(rng.integers(1 << 30)), 16)
        y = rng.integers(0, 10, size=16).astype(np.int32)
        state, want = jstep(state, jnp.asarray(x), jnp.asarray(y))
        pstate, got = pstep(pstate, torch.as_tensor(x), torch.as_tensor(y))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    want_state = resnet.params_from_jax(jax.device_get(state.params),
                                        jax.device_get(state.batch_stats))
    for name, value in port.state_dict().items():
        np.testing.assert_allclose(value.numpy(),
                                   want_state[name].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_bfloat16_matches_flax_mixed_precision():
    """dtype=bfloat16: convolutions and the head in bf16, BatchNorm, ReLU,
    the residual add and the pools in float32; float32 logits and
    parameters, as in flax."""
    params, stats = w.resnet_init()
    x = _x(23)
    want, _ = _jax_model(jnp.bfloat16).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x),
        train=True, mutable=["batch_stats"])
    port = _port_model(params, stats, torch.bfloat16)
    got = port(torch.as_tensor(x), train=True)
    assert got.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in port.parameters())
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(want, np.float32), **BF16)


def _flax_shapes(model):
    variables = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, 32, 32, 3))))
    return {k: jax.tree.map(lambda a: a.shape, v)
            for k, v in variables.items()}


def test_random_params_have_flax_tree_and_shapes():
    params, stats = resnet.random_params(STAGES, 0, 10, WIDTH)
    want = _flax_shapes(_jax_model())
    assert jax.tree.map(np.shape, params) == want["params"]
    assert jax.tree.map(np.shape, stats) == want["batch_stats"]
    # Each block's last BatchNorm starts at scale zero, as flax's.
    for name in ("BottleneckBlock_0", "BottleneckBlock_1"):
        assert not params[name]["BatchNorm_2"]["scale"].any()
        assert params[name]["BatchNorm_0"]["scale"].all()
    k = params["stem_conv"]["kernel"]
    assert abs(k.std() * np.sqrt(7 * 7 * 3) - 1) < 0.05
    again, _ = resnet.random_params(STAGES, 0, 10, WIDTH)
    np.testing.assert_array_equal(again["stem_conv"]["kernel"], k)
    state = resnet.params_from_jax(params, stats)
    port = resnet.ResNet(STAGES, 10, WIDTH)
    assert set(state) == set(port.state_dict())
    for name, value in port.state_dict().items():
        assert state[name].shape == value.shape, name


@pytest.mark.parametrize("depth", [50, 101, 152])
def test_parameter_counts_equal_flax(depth):
    factory = {50: jax_resnet.ResNet50, 101: jax_resnet.ResNet101,
               152: jax_resnet.ResNet152}[depth]
    want = sum(int(np.prod(s)) for s in jax.tree.leaves(
        _flax_shapes(factory())["params"], is_leaf=lambda a: isinstance(
            a, tuple)))
    with torch.device("meta"):
        model = getattr(resnet, f"ResNet{depth}")()
    got = sum(p.numel() for p in model.parameters())
    assert got == want
    assert {50: 25_557_032, 101: 44_549_160, 152: 60_192_808}[depth] == got


def test_build_puts_the_model_on_its_device():
    model = resnet.build(50, 0, "cpu", num_classes=10, dtype=torch.bfloat16)
    conv = model.blocks[3].convs[1].weight
    assert conv.is_contiguous(memory_format=torch.channels_last)
    assert model.dtype == torch.bfloat16 and model.fc.out_features == 10
    assert not model.blocks[0].bns[2].weight.any()
    assert len(model.blocks) == 16


@pytest.mark.parametrize("branches", ["flax-init", "switched-on"])
def test_resnet50_bfloat16_rounding(branches):
    """ResNet-50's train-mode bfloat16 logits against its own float32
    logits on the CPU (64x64, batch 4).  At flax's init (each block's last
    BatchNorm scale zero) they part by bf16 rounding, 0.0103; with every
    residual branch switched on (those scales 1), train-mode BatchNorm
    over 2x2 maps at batch 4 blows the rounding up to 0.343: that model
    cannot be held to a card-vs-CPU tolerance, so the card's checks hold
    the flax-init one."""
    x = torch.as_tensor(np.random.default_rng(2).normal(
        size=(4, 64, 64, 3)).astype(np.float32))
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        model = resnet.build(50, 3, "cpu", num_classes=1000, dtype=dtype)
        if branches == "switched-on":
            for block in model.blocks:
                torch.nn.init.ones_(block.bns[2].weight)
        with torch.no_grad():
            out.append(model(x, train=True))
    err = float((out[1] - out[0]).norm() / out[0].norm())
    if branches == "flax-init":
        assert err < 0.03
    else:
        assert err > 0.1
