"""The Vision Transformer in PyTorch — the port's counterpart of
``tpudp/models/vit.py``.

A strided-convolution patch embedding (``patch x patch`` patches to
``d_model``), learned positional embeddings, pre-LN encoder blocks with
bidirectional attention and a tanh-approximated GELU MLP, a final
LayerNorm and a global average pool over the tokens (no CLS token)
into one Linear head.  The token count stays a power of two (64 at CIFAR
32/4, 256 at 224/14), so ``attn_impl='flash'`` runs the K1-K3 kernels at
ImageNet geometry: ``tpudp_torch.ops.attention.multihead_attention``
routes a call to flash only when the token count divides by 128, as the
JAX model's does, and to the dense math otherwise.

Inputs are NHWC ``(B, H, W, 3)`` batches, viewed as NCHW tensors in
``channels_last`` memory for cuDNN, as :mod:`tpudp_torch.models.vgg`
does; the patch grid flattens row-major over the NHWC output ``(B,
H/p, W/p, D)``, as flax reshapes it.

Mixed precision follows flax's exactly, by explicit casts: parameters
stay float32; the patch convolution and every Dense run in ``dtype``
(input, weight and bias cast); the residual stream is in ``dtype``;
LayerNorm (flax's ``epsilon`` 1e-6) computes and returns float32; the
pooled vector is cast to ``dtype`` for the head; the logits come back
float32.  The fused ``qkv`` projection splits into contiguous thirds
``[q | k | v]``, each reshaped ``(b, t, h, d/h)`` (``jnp.split``).

:func:`params_from_jax` / :func:`params_to_jax` carry a flax parameter
tree across (``patch_embed``, ``pos_embed``, ``h_i/{ln_1, attn/{qkv,
proj}, ln_2, mlp_fc, mlp_proj}``, ``ln_f``, ``head``), and
:func:`random_params` draws one of the port's own from a numpy seed with
flax's initializers' distributions.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpudp_torch.models.gpt2 import dense, layer_norm
from tpudp_torch.models.vgg import lecun_normal
from tpudp_torch.ops.attention import multihead_attention

LN_EPS = 1e-6  # flax's LayerNorm default


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 32
    patch_size: int = 4
    num_classes: int = 10
    num_layers: int = 6
    num_heads: int = 6
    d_model: int = 384
    mlp_ratio: int = 4
    dtype: torch.dtype = torch.float32
    attn_impl: str = "dense"  # 'dense' | 'flash'

    def __post_init__(self):
        if self.image_size % self.patch_size:
            raise ValueError(
                f"image_size {self.image_size} not divisible by "
                f"patch_size {self.patch_size}")
        if self.d_model % self.num_heads:
            raise ValueError(
                f"d_model {self.d_model} not divisible by "
                f"num_heads {self.num_heads}")
        if self.attn_impl not in ("dense", "flash"):
            raise ValueError(
                f"unknown attn_impl {self.attn_impl!r}; "
                "choose from 'dense', 'flash'")

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


def vit_tiny(**overrides) -> "ViT":
    """ViT-Ti geometry scaled for CIFAR (32x32, 4x4 patches: 64 tokens)."""
    return ViT(ViTConfig(num_layers=6, num_heads=3, d_model=192,
                         **overrides))


def vit_small(**overrides) -> "ViT":
    return ViT(ViTConfig(num_layers=12, num_heads=6, d_model=384,
                         **overrides))


def vit_base_224(**overrides) -> "ViT":
    """ViT-B at ImageNet geometry with 14x14 patches: 256 tokens, a
    count that divides by 128, so ``attn_impl='flash'`` runs K1-K3."""
    return ViT(ViTConfig(image_size=224, patch_size=14, num_classes=1000,
                         num_layers=12, num_heads=12, d_model=768,
                         **overrides))


class EncoderAttention(nn.Module):
    """Bidirectional multi-head attention, flash-kernel capable."""

    def __init__(self, config: ViTConfig):
        super().__init__()
        self.config = config
        d = config.d_model
        self.qkv = nn.Linear(d, 3 * d)
        self.proj = nn.Linear(d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        b, t, d = x.shape
        h = cfg.num_heads
        qkv = dense(self.qkv, x, cfg.dtype)
        q, k, v = (z.reshape(b, t, h, d // h) for z in qkv.chunk(3, -1))
        out = multihead_attention(q, k, v, causal=False, impl=cfg.attn_impl,
                                  dtype=cfg.dtype)
        return dense(self.proj, out.reshape(b, t, d), cfg.dtype)


class EncoderBlock(nn.Module):
    """``x + attn(ln_1(x))``, then ``+ mlp_proj(gelu(mlp_fc(ln_2(.))))``."""

    def __init__(self, config: ViTConfig):
        super().__init__()
        self.config = config
        d = config.d_model
        self.ln_1 = nn.LayerNorm(d, eps=LN_EPS)
        self.attn = EncoderAttention(config)
        self.ln_2 = nn.LayerNorm(d, eps=LN_EPS)
        self.mlp_fc = nn.Linear(d, config.mlp_ratio * d)
        self.mlp_proj = nn.Linear(config.mlp_ratio * d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.config.dtype
        x = x + self.attn(layer_norm(self.ln_1, x))
        h = F.gelu(dense(self.mlp_fc, layer_norm(self.ln_2, x), dtype),
                   approximate="tanh")  # flax's nn.gelu default
        return x + dense(self.mlp_proj, h, dtype)


class ViT(nn.Module):
    """``(B, H, W, 3)`` float images -> ``(B, num_classes)`` float32
    logits.  ``train`` is taken for the Trainer's contract: there is no
    dropout and no BatchNorm, so both modes compute the same."""

    def __init__(self, config: ViTConfig):
        super().__init__()
        self.config = config
        d, p = config.d_model, config.patch_size
        self.patch_embed = nn.Conv2d(3, d, p, stride=p)
        self.pos_embed = nn.Parameter(torch.zeros(1, config.num_patches, d))
        self.h = nn.ModuleList(EncoderBlock(config)
                               for _ in range(config.num_layers))
        self.ln_f = nn.LayerNorm(d, eps=LN_EPS)
        self.head = nn.Linear(d, config.num_classes)

    def forward(self, images: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        del train
        cfg = self.config
        dt, conv = cfg.dtype, self.patch_embed
        x = images.permute(0, 3, 1, 2).to(dt)  # NHWC memory seen as NCHW
        x = F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt), conv.stride)
        b = x.shape[0]
        # (B, D, H/p, W/p) -> flax's (B, H/p, W/p, D), row-major tokens
        x = x.permute(0, 2, 3, 1).reshape(b, -1, cfg.d_model)
        x = x + self.pos_embed.to(dt)
        for blk in self.h:
            x = blk(x)
        x = layer_norm(self.ln_f, x).mean(dim=1)  # global average pool
        return dense(self.head, x, dt).float()


def params_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """A :class:`ViT` state dict from the flax model's parameter tree
    (numpy or anything ``np.asarray`` takes): the HWIO ``patch_embed``
    kernel becomes an OIHW weight, Dense ``(in, out)`` kernels ``(out,
    in)`` weights, LayerNorm ``scale`` the weight."""
    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    def linear(prefix, p):
        return {f"{prefix}.weight": t(p["kernel"]).T.contiguous(),
                f"{prefix}.bias": t(p["bias"])}

    def norm(prefix, p):
        return {f"{prefix}.weight": t(p["scale"]),
                f"{prefix}.bias": t(p["bias"])}

    state = {"patch_embed.weight": t(params["patch_embed"]["kernel"])
             .permute(3, 2, 0, 1).contiguous(),
             "patch_embed.bias": t(params["patch_embed"]["bias"]),
             "pos_embed": t(params["pos_embed"])}
    i = 0
    while f"h_{i}" in params:
        p = params[f"h_{i}"]
        state.update(norm(f"h.{i}.ln_1", p["ln_1"]))
        state.update(linear(f"h.{i}.attn.qkv", p["attn"]["qkv"]))
        state.update(linear(f"h.{i}.attn.proj", p["attn"]["proj"]))
        state.update(norm(f"h.{i}.ln_2", p["ln_2"]))
        state.update(linear(f"h.{i}.mlp_fc", p["mlp_fc"]))
        state.update(linear(f"h.{i}.mlp_proj", p["mlp_proj"]))
        i += 1
    state.update(norm("ln_f", params["ln_f"]))
    state.update(linear("head", params["head"]))
    return state


def params_to_jax(state: dict) -> dict:
    """The inverse of :func:`params_from_jax`: the flax tree of a
    :class:`ViT` state dict, as contiguous tensors on the state's
    device.  Entries the state lacks are left out (see
    ``vgg.params_to_jax``)."""
    tree: dict = {}

    def put(path, name, fn=lambda t: t):
        if name not in state:
            return
        node = tree
        for scope in path[:-1]:
            node = node.setdefault(scope, {})
        node[path[-1]] = fn(state[name]).contiguous()

    def linear(path, prefix):
        put(path + ("kernel",), f"{prefix}.weight", lambda t: t.T)
        put(path + ("bias",), f"{prefix}.bias")

    def norm(path, prefix):
        put(path + ("scale",), f"{prefix}.weight")
        put(path + ("bias",), f"{prefix}.bias")

    put(("patch_embed", "kernel"), "patch_embed.weight",
        lambda t: t.permute(2, 3, 1, 0))
    put(("patch_embed", "bias"), "patch_embed.bias")
    put(("pos_embed",), "pos_embed")
    i = 0
    while any(k.startswith(f"h.{i}.") for k in state):
        norm((f"h_{i}", "ln_1"), f"h.{i}.ln_1")
        linear((f"h_{i}", "attn", "qkv"), f"h.{i}.attn.qkv")
        linear((f"h_{i}", "attn", "proj"), f"h.{i}.attn.proj")
        norm((f"h_{i}", "ln_2"), f"h.{i}.ln_2")
        linear((f"h_{i}", "mlp_fc"), f"h.{i}.mlp_fc")
        linear((f"h_{i}", "mlp_proj"), f"h.{i}.mlp_proj")
        i += 1
    norm(("ln_f",), "ln_f")
    linear(("head",), "head")
    return tree


def random_params(cfg: ViTConfig, seed: int) -> dict:
    """A flax-layout ViT tree of float32 numpy weights drawn from
    ``seed`` with the flax initializers' distributions: the patch
    convolution's and every Dense kernel from ``lecun_normal``, zero
    biases, LayerNorm scales of one and biases of zero, ``pos_embed``
    from ``normal(0.02)``.  The same tree feeds the flax model and,
    through :func:`params_from_jax`, the port."""
    rng = np.random.default_rng(seed)
    d, p, f = cfg.d_model, cfg.patch_size, cfg.mlp_ratio * cfg.d_model

    def linear(n_in, n_out):
        return {"kernel": lecun_normal(rng, (n_in, n_out), n_in),
                "bias": np.zeros(n_out, np.float32)}

    def norm():
        return {"scale": np.ones(d, np.float32),
                "bias": np.zeros(d, np.float32)}

    tree = {"patch_embed": {"kernel": lecun_normal(rng, (p, p, 3, d),
                                                   p * p * 3),
                            "bias": np.zeros(d, np.float32)},
            "pos_embed": (rng.standard_normal((1, cfg.num_patches, d))
                          * 0.02).astype(np.float32)}
    for i in range(cfg.num_layers):
        tree[f"h_{i}"] = {"ln_1": norm(),
                          "attn": {"qkv": linear(d, 3 * d),
                                   "proj": linear(d, d)},
                          "ln_2": norm(), "mlp_fc": linear(d, f),
                          "mlp_proj": linear(f, d)}
    tree["ln_f"] = norm()
    tree["head"] = linear(d, cfg.num_classes)
    return tree


def build(cfg: ViTConfig, seed: int, device) -> ViT:
    """A :class:`ViT` with :func:`random_params` weights on ``device``,
    its patch convolution's weight in ``channels_last`` memory."""
    model = ViT(cfg)
    model.load_state_dict(params_from_jax(random_params(cfg, seed)))
    return model.to(device, memory_format=torch.channels_last)
