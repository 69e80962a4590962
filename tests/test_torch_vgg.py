"""The port's VGG (``tpudp_torch.models.vgg``) against the flax model:
the same numpy weights through ``params_from_jax``, the same inputs.

Train-mode logits and the running statistics of one forward, and the
eval-mode logits from the updated statistics, agree in float32 to 1e-5
(the frameworks sum convolutions and statistics in other orders); in
bfloat16 to two bf16 ulps.  The running variance follows flax's rule
(the biased batch variance), which ``nn.BatchNorm2d`` would not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudp.models import vgg as jax_vgg
from tpudp_torch.models import vgg

NARROW = (8, "M", 16, "M", "M", "M", "M")
WIDE_TAIL = (8, "M", 16, 16, "M")  # ends at 8x8: flatten order matters


def _flax_step(cfg, params, stats, x, dtype):
    model = jax_vgg.VGG(cfg=cfg, dtype=dtype)
    logits, mutated = model.apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), train=True,
        mutable=["batch_stats"])
    new_stats = jax.device_get(mutated["batch_stats"])
    eval_logits = model.apply({"params": params, "batch_stats": new_stats},
                              jnp.asarray(x), train=False)
    return np.asarray(logits), new_stats, np.asarray(eval_logits)


@pytest.mark.parametrize("cfg", [NARROW, WIDE_TAIL], ids=["narrow", "8x8"])
@pytest.mark.parametrize("seed", [0, 1])
def test_train_step_forward_and_stats_match_flax(cfg, seed):
    params, stats = vgg.random_params(cfg, seed)
    x = np.random.default_rng(seed + 10).normal(
        size=(8, 32, 32, 3)).astype(np.float32)
    want, want_stats, want_eval = _flax_step(cfg, params, stats, x,
                                             jnp.float32)
    model = vgg.VGG(cfg)
    model.load_state_dict(vgg.params_from_jax(params, stats))
    got = model(torch.as_tensor(x), train=True)
    assert got.dtype == torch.float32 and got.shape == (8, 10)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5,
                               rtol=1e-5)
    state = model.state_dict()
    for i, name in enumerate(sorted(want_stats)):
        for ours, theirs in (("running_mean", "mean"),
                             ("running_var", "var")):
            np.testing.assert_allclose(
                state[f"bns.{i}.{ours}"].numpy(),
                want_stats[f"BatchNorm_{i}"][theirs], atol=1e-6, rtol=1e-5)
    with torch.no_grad():
        got_eval = model(torch.as_tensor(x), train=False).numpy()
    np.testing.assert_allclose(got_eval, want_eval, atol=1e-5, rtol=1e-5)


def test_running_variance_is_the_biased_one():
    """At a 1x1 layer with 8 rows the unbiased variance is 8/7 of the
    biased one; the port's update uses the biased, as flax does."""
    bn = vgg.BatchNorm(3)
    x = torch.randn(8, 3, 1, 1) * 3
    bn(x, train=True)
    biased = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * biased)
    torch.testing.assert_close(bn.running_mean, 0.1 * x.mean(dim=(0, 2, 3)))


def test_bfloat16_matches_flax_mixed_precision():
    """dtype=bfloat16: convolutions and the head in bf16, BatchNorm in
    float32, float32 logits and parameters, as in flax."""
    params, stats = vgg.random_params(NARROW, 4)
    x = np.random.default_rng(5).normal(size=(8, 32, 32, 3)).astype(
        np.float32)
    want, want_stats, _ = _flax_step(NARROW, params, stats, x, jnp.bfloat16)
    model = vgg.VGG(NARROW, dtype=torch.bfloat16)
    model.load_state_dict(vgg.params_from_jax(params, stats))
    got = model(torch.as_tensor(x), train=True)
    assert got.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in model.parameters())
    np.testing.assert_allclose(got.detach().numpy(), want, atol=2e-2,
                               rtol=1.6e-2)
    np.testing.assert_allclose(model.bns[1].running_var.numpy(),
                               want_stats["BatchNorm_1"]["var"], rtol=2e-2)


def test_params_from_jax_covers_the_module_exactly():
    params, stats = vgg.random_params(vgg.CONFIGS["VGG11"], 0)
    state = vgg.params_from_jax(params, stats)
    model = vgg.VGG11()
    assert set(state) == set(model.state_dict())
    for name, value in model.state_dict().items():
        assert state[name].shape == value.shape, name
    assert state["fc.weight"].shape == (10, 512)


def test_random_params_have_flax_shapes_and_scales():
    """The port's seeded init has the flax init's tree, shapes and
    lecun-normal scale (variance 1 / fan_in), and is reproducible."""
    cfg = vgg.CONFIGS["VGG11"]
    params, stats = vgg.random_params(cfg, 0)
    ref = jax_vgg.VGG11().init(jax.random.PRNGKey(0),
                               jnp.zeros((1, 32, 32, 3)))
    assert jax.tree.map(np.shape, params) == jax.tree.map(np.shape,
                                                          ref["params"])
    assert jax.tree.map(np.shape, stats) == jax.tree.map(
        np.shape, ref["batch_stats"])
    k = params["Conv_4"]["kernel"]
    assert abs(k.std() * np.sqrt(9 * 256) - 1) < 0.02
    assert np.abs(k).max() <= 2 / 0.8796256610342398 / np.sqrt(9 * 256)
    again, _ = vgg.random_params(cfg, 0)
    np.testing.assert_array_equal(again["Conv_4"]["kernel"], k)


def test_configs_and_factories_match_jax():
    assert vgg.CONFIGS == jax_vgg.CONFIGS
    for name in ("VGG11", "VGG13", "VGG16", "VGG19"):
        model = getattr(vgg, name)(num_classes=7, dtype=torch.bfloat16)
        assert model.cfg == jax_vgg.CONFIGS[name]
        assert model.fc.out_features == 7 and model.dtype == torch.bfloat16


def test_build_puts_convolutions_in_channels_last():
    model = vgg.build(NARROW, 3, "cpu")
    w = model.convs[0].weight
    assert w.is_contiguous(memory_format=torch.channels_last)
    params, stats = vgg.random_params(NARROW, 3)
    torch.testing.assert_close(
        w, vgg.params_from_jax(params, stats)["convs.0.weight"])
