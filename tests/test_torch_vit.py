"""The port's Vision Transformer (``tpudp_torch.models.vit``) and its
trainer (``python -m tpudp_torch.train_vit``) against the JAX package's
``tpudp.models.vit`` and ``examples/train_vit.py``, on the CPU.

Weights are the flax model's own init, drawn away from it by a
numpy-seeded perturbation (so biases and LayerNorm parameters reach the
logits), and carried across by ``vit.params_from_jax``; inputs come from
numpy seeds.  Tolerances, each stated where it is used: float32 logits
atol = rtol = 2e-5; bfloat16 logits (both packages cast the same places)
atol 3e-2 / rtol 2e-2; parameters after one optimizer step atol = rtol
= 2e-5; flash against dense 2e-5 (the JAX test's).
"""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudp.models.vit import ViT as JaxViT
from tpudp.models.vit import ViTConfig as JaxViTConfig
from tpudp.train import init_state as jax_init_state
from tpudp.train import make_optimizer as jax_make_optimizer
from tpudp.train import make_train_step as jax_make_train_step
from tpudp_torch import train
from tpudp_torch.models import vit
from tpudp_torch.ops import attention

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# CIFAR geometry: 32/4 -> 64 tokens (dense under either impl).
CIFAR = dict(image_size=32, patch_size=4, num_classes=10, num_layers=2,
             num_heads=2, d_model=32)
# tests/test_vit.py's flash config: 64/4 -> 256 tokens.
FLASH = dict(image_size=64, patch_size=4, num_classes=10, num_layers=1,
             num_heads=4, d_model=64)
F32 = dict(atol=2e-5, rtol=2e-5)


def _flax_params(cfg: dict, seed: int = 0) -> dict:
    """The flax model's init for ``cfg``, perturbed from ``seed``, as
    float32 numpy."""
    model = JaxViT(JaxViTConfig(**cfg))
    size = cfg["image_size"]
    params = model.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, size, size, 3)))["params"]
    rng = np.random.default_rng(seed + 100)
    return jax.tree.map(lambda a: (np.asarray(a) + rng.normal(
        size=a.shape) * 0.05).astype(np.float32), params)


def _images(cfg: dict, n: int = 4, seed: int = 1) -> np.ndarray:
    size = cfg["image_size"]
    return np.random.default_rng(seed).normal(
        size=(n, size, size, 3)).astype(np.float32)


def _port(cfg: dict, params: dict, **kw) -> vit.ViT:
    model = vit.ViT(vit.ViTConfig(**cfg, **kw))
    model.load_state_dict(vit.params_from_jax(params))
    return model


def _jax_logits(cfg, params, x, **kw):
    model = JaxViT(JaxViTConfig(**cfg, **kw))
    return np.asarray(model.apply({"params": jax.tree.map(jnp.asarray,
                                                          params)},
                                  jnp.asarray(x)), np.float32)


def test_config_validation_matches_jax():
    for kw, match in (({"image_size": 32, "patch_size": 5}, "not divisible"),
                      ({"d_model": 384, "num_heads": 5}, "num_heads"),
                      ({"attn_impl": "ring"}, "attn_impl")):
        with pytest.raises(ValueError, match=match) as ours:
            vit.ViTConfig(**kw)
        with pytest.raises(ValueError) as theirs:
            JaxViTConfig(**kw)
        assert str(ours.value) == str(theirs.value)
    assert vit.vit_base_224().config.num_patches == 256
    assert vit.vit_tiny().config.num_patches == 64
    assert vit.vit_small().config.d_model == 384


def test_tree_layout_and_random_params_match_flax():
    """``random_params`` has the flax init's tree, shapes and
    distributions (lecun-normal kernels, zero biases, unit LayerNorm
    scales, ``pos_embed`` at std 0.02); the round trip through the port
    is exact."""
    flax = _flax_params(CIFAR)
    mine = vit.random_params(vit.ViTConfig(**CIFAR), 3)
    assert jax.tree.structure(flax) == jax.tree.structure(mine)
    jax.tree.map(lambda a, b: np.testing.assert_equal(a.shape, b.shape),
                 flax, mine)
    assert not mine["h_0"]["attn"]["qkv"]["bias"].any()
    assert (mine["ln_f"]["scale"] == 1).all()
    big = vit.random_params(vit.ViTConfig(**dict(CIFAR, d_model=256)), 0)
    qkv = big["h_0"]["attn"]["qkv"]["kernel"]
    assert abs(qkv.std() * np.sqrt(256) - 1) < 0.02  # variance 1/fan_in
    assert abs(big["pos_embed"].std() - 0.02) < 1e-3
    back = vit.params_to_jax(vit.params_from_jax(flax))
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        a, b.numpy()), flax, back)


def test_logits_match_flax_at_cifar_geometry():
    """64 tokens, float32: atol = rtol = 2e-5."""
    params, x = _flax_params(CIFAR), _images(CIFAR)
    got = _port(CIFAR, params)(torch.as_tensor(x)).detach().numpy()
    assert got.dtype == np.float32 and got.shape == (4, 10)
    np.testing.assert_allclose(got, _jax_logits(CIFAR, params, x), **F32)


def test_bf16_logits_match_flax():
    """The mixed-precision policy (bf16 convolution, Dense layers and
    residual stream; float32 LayerNorm, pool and logits) agrees with
    flax's at bf16's resolution: atol 3e-2, rtol 2e-2."""
    params, x = _flax_params(CIFAR), _images(CIFAR)
    got = _port(CIFAR, params, dtype=torch.bfloat16)(torch.as_tensor(x))
    assert got.dtype == torch.float32
    want = _jax_logits(CIFAR, params, x, dtype=jnp.bfloat16)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=3e-2,
                               rtol=2e-2)


def test_flash_matches_dense_at_256_tokens():
    """tests/test_vit.py's flash config: the port's flash route (the
    kernels' plain versions on the CPU) against its dense path and
    against JAX's flash (Pallas interpret mode), at 2e-5."""
    params, x = _flax_params(FLASH), _images(FLASH, n=2)
    routes = attention.dense_routes
    flash = _port(FLASH, params, attn_impl="flash")(torch.as_tensor(x))
    dense = _port(FLASH, params)(torch.as_tensor(x))
    assert attention.dense_routes == routes
    assert attention.flash_route((2, 256, 12, 64), torch.bfloat16,
                                 "cuda") == "flash"  # ViT-B/14 at 224
    assert attention.flash_route((2, 64, 12, 64), torch.bfloat16,
                                 "cuda") == "dense"  # CIFAR's 64 tokens
    np.testing.assert_allclose(flash.detach().numpy(),
                               dense.detach().numpy(), **F32)
    np.testing.assert_allclose(flash.detach().numpy(), _jax_logits(
        FLASH, params, x, attn_impl="flash"), **F32)


def _batches(cfg, steps, seed=2, n=4):
    rng = np.random.default_rng(seed)
    size = cfg["image_size"]
    return [(rng.normal(size=(n, size, size, 3)).astype(np.float32),
             rng.integers(0, cfg["num_classes"], size=n).astype(np.int32))
            for _ in range(steps)]


def _port_steps(cfg, params, opt_kw, batches, remat=False, **model_kw):
    model = _port(cfg, params, **model_kw)
    spec = train.make_optimizer(**opt_kw)
    state = train.init_state(model, spec)
    step = train.make_train_step(model, spec, remat=remat)
    losses = []
    for x, y in batches:
        state, loss = step(state, torch.as_tensor(x), torch.as_tensor(y))
        losses.append(float(loss))
    return losses, vit.params_to_jax(
        {k: v.detach() for k, v in model.state_dict().items()})


@pytest.mark.parametrize("opt_kw", [
    dict(learning_rate=1e-3, optimizer="adamw"),
    dict(learning_rate=0.01, momentum=0.9, weight_decay=1e-4)],
    ids=["adamw", "sgd"])
def test_one_step_matches_jax(opt_kw):
    """One step of each optimizer: the loss and every parameter after
    the update, at 2e-5 (AdamW's first update moves each weight by about
    the learning rate, so the comparison sees its direction).  One
    exception: the key third of each ``qkv`` bias has a zero gradient in
    exact arithmetic (softmax ignores a shift shared by every key), so
    AdamW's first update there is ``lr * g / (|g| + eps)`` of rounding
    noise, anywhere in ``[-lr, lr]``; it is held to that interval."""
    params, batches = _flax_params(CIFAR), _batches(CIFAR, 1)
    losses, got = _port_steps(CIFAR, params, opt_kw, batches)
    model = JaxViT(JaxViTConfig(**CIFAR))
    tx = jax_make_optimizer(**opt_kw)
    state = jax_init_state(model, tx, input_shape=(1, 32, 32, 3))
    jparams = jax.tree.map(jnp.asarray, params)
    state = state.replace(params=jparams, opt_state=tx.init(jparams))
    step = jax_make_train_step(model, tx, None, "none", spmd_mode="single",
                               donate=False)
    state, loss = step(state, *(jnp.asarray(a) for a in batches[0]))
    np.testing.assert_allclose(losses, [float(loss)], **F32)
    want = jax.device_get(state.params)
    if opt_kw.get("optimizer") == "adamw":
        d, lr = CIFAR["d_model"], opt_kw["learning_rate"]
        for i in range(CIFAR["num_layers"]):
            start = params[f"h_{i}"]["attn"]["qkv"]["bias"][d:2 * d]
            for tree in (want, got):
                bias = tree[f"h_{i}"]["attn"]["qkv"]["bias"]
                key = np.asarray(bias)[d:2 * d]
                assert np.abs(key - start).max() <= lr * (1 + 1e-4)
                tree[f"h_{i}"]["attn"]["qkv"]["bias"] = np.concatenate(
                    [np.asarray(bias)[:d], np.asarray(bias)[2 * d:]])
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        np.asarray(b), np.asarray(a), **F32), want, got)


def test_remat_equals_no_remat():
    """``remat=True`` (``--remat``) recomputes the forward in the
    backward: two AdamW steps give the same losses and parameters as
    without it (float32 on the CPU: bit for bit)."""
    params, batches = _flax_params(CIFAR), _batches(CIFAR, 2)
    opt = dict(learning_rate=1e-3, optimizer="adamw")
    plain = _port_steps(CIFAR, params, opt, batches)
    remat = _port_steps(CIFAR, params, opt, batches, remat=True)
    assert plain[0] == remat[0]
    jax.tree.map(lambda a, b: torch.testing.assert_close(a, b, rtol=0,
                                                         atol=0),
                 plain[1], remat[1])


def _cli(args, timeout=300):
    """``python -m tpudp_torch.train_vit args`` in a fresh interpreter
    (it joins a one-rank process group), then the JAX-side modules it
    imported."""
    forbidden = ("jax", "jaxlib", "flax", "optax", "tpudp")
    code = ("import runpy, sys\n"
            f"sys.argv = ['train_vit'] + {args!r}\n"
            "runpy.run_module('tpudp_torch.train_vit', run_name='__main__')\n"
            "print('IMPORTED', sorted(m for m in sys.modules if "
            f"m.split('.')[0] in {forbidden!r}))\n")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_train_vit_cli_on_the_cpu(tmp_path):
    """The example's lines at ``--device cpu`` (2 steps, finite losses,
    no JAX import), the head rule ``max(1, d_model // 64)``, and a
    ``--save-checkpoint`` state that restores into a fresh model."""
    from tpudp_torch.train_vit import build_parser, config_of
    from tpudp_torch.utils.checkpoint import restore_checkpoint

    args = ["--device", "cpu", "--steps", "2", "--batch-size", "8",
            "--train-size", "16", "--layers", "2", "--d-model", "128",
            "--log-every", "1", "--dtype", "float32",
            "--save-checkpoint", str(tmp_path)]
    text = _cli(args)
    assert ("[vit-small] params=0.4M devices=1 tokens=64 attn=dense "
            "sync=allreduce batch=8 dtype=float32 device=cpu") in text
    losses = re.findall(r"^step (\d+): loss (\S+) \([\d,.]+ images/s\)$",
                        text, re.M)
    assert [int(i) for i, _ in losses] == [1, 2]
    assert all(np.isfinite(float(v)) for _, v in losses)
    assert "IMPORTED []" in text
    assert f"[vit] saved checkpoint {tmp_path / 'step_2'}" in text
    cfg = config_of(build_parser().parse_args(args), torch.float32)
    assert (cfg.num_heads, cfg.num_layers, cfg.d_model) == (2, 2, 128)
    model = vit.build(cfg, seed=5, device="cpu")
    state = train.init_state(model, train.make_optimizer(
        learning_rate=1e-3, optimizer="adamw"))
    restore_checkpoint(tmp_path / "step_2", state, verify=True)
    assert state.step == 2
    saved = torch.load(tmp_path / "step_2" / "state.pt", weights_only=True)
    torch.testing.assert_close(
        state.model.head.weight.detach(),
        saved["params"]["head"]["kernel"].T, rtol=0, atol=0)
    assert float(saved["loss_sum"]) == pytest.approx(
        sum(float(v) for _, v in losses), rel=1e-5)
