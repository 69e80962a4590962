"""The PyTorch port's GPT-2 (``tpudp_torch.models.gpt2``) against the JAX
model, plus the port's import hygiene: no module of ``tpudp_torch``
imports JAX or the JAX package."""

import pathlib
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudp.models.gpt2 import gpt2_small as jax_gpt2_small
from tpudp_torch.models import gpt2

ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY = dict(vocab_size=61, max_seq_len=96, num_layers=2, num_heads=2,
            d_model=32)


def test_forward_logits_match_jax():
    """Same numpy weights, same tokens: fp32 logits agree to 1e-5 (the
    two frameworks sum matmuls and LayerNorm statistics in other
    orders)."""
    tree = gpt2.random_params(gpt2.GPT2Config(**TINY), seed=3)
    tokens = np.random.default_rng(4).integers(0, 61, size=(2, 21))
    want = np.asarray(jax_gpt2_small(**TINY).apply(
        {"params": tree}, jnp.asarray(tokens)))
    model = gpt2.GPT2(gpt2.GPT2Config(**TINY))
    model.load_state_dict(gpt2.params_from_jax(tree))
    with torch.no_grad():
        got = model(torch.as_tensor(tokens)).numpy()
    assert got.dtype == np.float32 and got.shape == (2, 21, 61)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_params_from_jax_covers_the_module_exactly():
    cfg = gpt2.GPT2Config(**TINY)
    state = gpt2.params_from_jax(gpt2.random_params(cfg, seed=0))
    model = gpt2.GPT2(cfg)
    assert set(state) == set(model.state_dict())
    for name, value in model.state_dict().items():
        assert state[name].shape == value.shape, name


def test_gpt2_small_defaults_are_gpt2_small():
    cfg = gpt2.gpt2_small().config
    assert (cfg.vocab_size, cfg.max_seq_len, cfg.num_layers,
            cfg.num_heads, cfg.d_model, cfg.ln_eps) == (
                50_257, 1024, 12, 12, 768, 1e-5)


def test_flash_forward_logits_match_jax():
    """``attn_impl='flash'`` at t = 128 (the flash dispatch engages; the
    kernels' plain versions on the CPU) against the JAX model with its
    Pallas kernel in interpret mode: fp32 logits agree to 1e-5."""
    cfg = dict(TINY, max_seq_len=128, attn_impl="flash")
    tree = gpt2.random_params(gpt2.GPT2Config(**cfg), seed=5)
    tokens = np.random.default_rng(6).integers(0, 61, size=(2, 128))
    want = np.asarray(jax_gpt2_small(**cfg).apply(
        {"params": tree}, jnp.asarray(tokens)))
    model = gpt2.GPT2(gpt2.GPT2Config(**cfg))
    model.load_state_dict(gpt2.params_from_jax(tree))
    with torch.no_grad():
        got = model(torch.as_tensor(tokens), train=True).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("field,value", [("attn_impl", "ring"),
                                         ("mlp_impl", "moe")])
def test_later_slices_raise_not_implemented(field, value):
    """Ring attention and the MoE MLP, once refused, are ported: a model
    built with either matches the flax model (ring attention, with no
    ``seq`` axis bound, runs the dense math as JAX's does); unknown
    values still raise."""
    cfg = dict(TINY, **{field: value}, num_experts=4, capacity_factor=4.0)
    tree = gpt2.random_params(gpt2.GPT2Config(**cfg), seed=8)
    tokens = np.random.default_rng(9).integers(0, 61, size=(2, 16))
    want = np.asarray(jax_gpt2_small(**cfg).apply({"params": tree},
                                                  jnp.asarray(tokens)))
    model = gpt2.GPT2(gpt2.GPT2Config(**cfg))
    model.load_state_dict(gpt2.params_from_jax(tree))
    with torch.no_grad():
        got = model(torch.as_tensor(tokens)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="unknown"):
        gpt2.GPT2Config(**{field: "nope"})


def _port_modules():
    pkg = ROOT / "tpudp_torch"
    return sorted(".".join(p.relative_to(ROOT).with_suffix("").parts)
                  .removesuffix(".__init__")
                  for p in pkg.rglob("*.py"))


def test_port_imports_no_jax():
    """In a fresh interpreter, importing every module of the port (and
    ``chip_smoke``) leaves ``jax``, ``flax``, ``optax`` and ``tpudp`` out
    of ``sys.modules``; no source of the port has such an import line."""
    mods = _port_modules() + ["chip_smoke"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'tpudp'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    pattern = re.compile(r"^\s*(import|from) (jax|flax|optax|tpudp)\b",
                         re.M)
    for path in list((ROOT / "tpudp_torch").rglob("*.py")) + [
            ROOT / "chip_smoke.py"]:
        assert not pattern.search(path.read_text()), path
