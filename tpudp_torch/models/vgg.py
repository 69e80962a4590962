"""The VGG family in PyTorch — the port's counterpart of
``tpudp/models/vgg.py``.

conv(3x3, pad 1) + BatchNorm + ReLU stacks with ``'M'`` 2x2 max-pool
markers, from the same config table (:data:`CONFIGS`), then a flatten and
one Linear layer.  Inputs are NHWC batches, as the loader yields them
and the flax model takes them; the model views them as NCHW tensors in
``channels_last`` memory (no copy) for cuDNN.

Mixed precision follows the flax model exactly, by explicit casts rather
than ``torch.autocast``: parameters stay float32; each convolution and
the Linear layer run in ``dtype`` (their inputs, weights and biases cast
to it); BatchNorm and ReLU run in float32; the logits come back float32.

:class:`~tpudp_torch.models.norm.BatchNorm` is flax's
``BatchNorm(momentum=0.9, epsilon=1e-5)`` with its rule for the running
variance; ``bn_axis='data'`` makes every one cross-rank SyncBN, as the
JAX model's ``bn_axis`` does.

:func:`params_from_jax` carries a flax ``(params, batch_stats)`` pair
across (HWIO kernels to OIHW, Dense ``(in, out)`` to ``(out, in)``), and
:func:`random_params` draws a flax-layout pair of the port's own from a
numpy seed, with flax's initializers' distributions.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpudp_torch.models.norm import BatchNorm

# The variant table of the JAX model (and of the reference's `_cfg`).
CONFIGS: dict[str, tuple] = {
    "VGG11": (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "VGG13": (64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512,
              512, "M"),
    "VGG16": (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
              "M", 512, 512, 512, "M"),
    "VGG19": (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512,
              512, 512, "M", 512, 512, 512, 512, "M"),
}

class VGG(nn.Module):
    """VGG-style convnet on NHWC ``(B, H, W, C)`` float inputs; returns
    float32 logits ``(B, num_classes)``.  ``train=True`` normalizes with
    the batch's statistics and updates the running ones; ``train=False``
    uses the running statistics (the eval path).  ``bn_axis='data'``
    takes the training statistics over the ranks (SyncBN)."""

    def __init__(self, cfg: Sequence[Any], num_classes: int = 10,
                 dtype: torch.dtype = torch.float32,
                 bn_axis: str | None = None):
        super().__init__()
        self.cfg = tuple(cfg)
        self.dtype = dtype
        convs, bns = [], []
        channels, size = 3, 32  # CIFAR-10's RGB 32x32 images
        for v in self.cfg:
            if v == "M":
                size //= 2
            else:
                convs.append(nn.Conv2d(channels, int(v), 3, padding=1))
                bns.append(BatchNorm(int(v), bn_axis))
                channels = int(v)
        self.convs = nn.ModuleList(convs)
        self.bns = nn.ModuleList(bns)
        self.fc = nn.Linear(channels * size * size, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        dt = self.dtype
        x = x.permute(0, 3, 1, 2).to(dt)  # NHWC memory seen as NCHW
        layer = 0
        for v in self.cfg:
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
                continue
            conv = self.convs[layer]
            x = F.conv2d(x.to(dt), conv.weight.to(dt), conv.bias.to(dt),
                         padding=1)
            x = F.relu(self.bns[layer](x, train))
            layer += 1
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flax's order
        return F.linear(x.to(dt), self.fc.weight.to(dt),
                        self.fc.bias.to(dt)).float()


def _factory(name: str):
    def build_variant(num_classes: int = 10,
                      dtype: torch.dtype = torch.float32,
                      bn_axis: str | None = None) -> VGG:
        return VGG(CONFIGS[name], num_classes, dtype, bn_axis)

    build_variant.__name__ = name
    build_variant.__doc__ = f"A {name} (the JAX package's {name} factory)."
    return build_variant


VGG11 = _factory("VGG11")
VGG13 = _factory("VGG13")
VGG16 = _factory("VGG16")
VGG19 = _factory("VGG19")


def params_from_jax(params: dict, batch_stats: dict) -> dict:
    """A :class:`VGG` state dict from the flax model's ``params`` and
    ``batch_stats`` trees (numpy or anything ``np.asarray`` takes):
    ``Conv_i`` HWIO kernels become OIHW weights, ``Dense_0``'s ``(in,
    out)`` kernel an ``(out, in)`` weight, ``BatchNorm_i``'s ``scale``,
    ``bias``, ``mean`` and ``var`` the port's weight, bias and running
    statistics."""
    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    state = {}
    n_conv = sum(name.startswith("Conv_") for name in params)
    for i in range(n_conv):
        conv, bn = params[f"Conv_{i}"], params[f"BatchNorm_{i}"]
        stats = batch_stats[f"BatchNorm_{i}"]
        state[f"convs.{i}.weight"] = t(conv["kernel"]).permute(
            3, 2, 0, 1).contiguous()
        state[f"convs.{i}.bias"] = t(conv["bias"])
        state[f"bns.{i}.weight"] = t(bn["scale"])
        state[f"bns.{i}.bias"] = t(bn["bias"])
        state[f"bns.{i}.running_mean"] = t(stats["mean"])
        state[f"bns.{i}.running_var"] = t(stats["var"])
    state["fc.weight"] = t(params["Dense_0"]["kernel"]).T.contiguous()
    state["fc.bias"] = t(params["Dense_0"]["bias"])
    return state


def params_to_jax(state: dict) -> tuple[dict, dict]:
    """The inverse of :func:`params_from_jax`: the flax ``(params,
    batch_stats)`` trees of a :class:`VGG` state dict, as contiguous
    tensors on the state's device (OIHW weights become HWIO kernels,
    ``fc.weight`` the ``(in, out)`` ``Dense_0`` kernel).  Entries the
    state lacks are left out, so a dict of one tensor a parameter (an
    optimizer's momentum, say) maps to the parameters' flax layout."""
    params, stats = {}, {}

    def put(tree, scope, key, name, fn=lambda t: t):
        if name in state:
            tree.setdefault(scope, {})[key] = fn(state[name]).contiguous()

    i = 0
    while f"convs.{i}.weight" in state or f"bns.{i}.running_mean" in state:
        put(params, f"Conv_{i}", "kernel", f"convs.{i}.weight",
            lambda t: t.permute(2, 3, 1, 0))
        put(params, f"Conv_{i}", "bias", f"convs.{i}.bias")
        put(params, f"BatchNorm_{i}", "scale", f"bns.{i}.weight")
        put(params, f"BatchNorm_{i}", "bias", f"bns.{i}.bias")
        put(stats, f"BatchNorm_{i}", "mean", f"bns.{i}.running_mean")
        put(stats, f"BatchNorm_{i}", "var", f"bns.{i}.running_var")
        i += 1
    put(params, "Dense_0", "kernel", "fc.weight", lambda t: t.T)
    put(params, "Dense_0", "bias", "fc.bias")
    return params, stats


def lecun_normal(rng: np.random.Generator, shape, fan_in: int
                 ) -> np.ndarray:
    """flax's ``lecun_normal`` drawn from ``rng``: a standard normal
    truncated at two standard deviations, scaled to variance
    ``1 / fan_in``; float32."""
    draw = rng.standard_normal(shape)
    bad = np.abs(draw) > 2
    while bad.any():  # truncate at two standard deviations
        draw[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(draw) > 2
    # flax divides by the truncated normal's standard deviation.
    std = np.sqrt(1.0 / fan_in) / 0.87962566103423978
    return (draw * std).astype(np.float32)


def random_params(cfg: Sequence[Any], seed: int, num_classes: int = 10
                  ) -> tuple[dict, dict]:
    """A flax-layout ``(params, batch_stats)`` pair of float32 numpy
    arrays drawn from ``seed`` with the flax initializers' distributions:
    kernels from :func:`lecun_normal`, zero biases,
    BatchNorm scales of one, running means of zero and variances of one.
    The same pair feeds the flax model and, through
    :func:`params_from_jax`, the port."""
    rng = np.random.default_rng(seed)
    params, stats = {}, {}
    channels, size, i = 3, 32, 0
    for v in cfg:
        if v == "M":
            size //= 2
            continue
        v = int(v)
        params[f"Conv_{i}"] = {"kernel": lecun_normal(
                                   rng, (3, 3, channels, v), 9 * channels),
                               "bias": np.zeros(v, np.float32)}
        params[f"BatchNorm_{i}"] = {"scale": np.ones(v, np.float32),
                                    "bias": np.zeros(v, np.float32)}
        stats[f"BatchNorm_{i}"] = {"mean": np.zeros(v, np.float32),
                                   "var": np.ones(v, np.float32)}
        channels, i = v, i + 1
    flat = channels * size * size
    params["Dense_0"] = {"kernel": lecun_normal(rng, (flat, num_classes),
                                                flat),
                         "bias": np.zeros(num_classes, np.float32)}
    return params, stats


def build(cfg: Sequence[Any], seed: int, device, num_classes: int = 10,
          dtype: torch.dtype = torch.float32,
          bn_axis: str | None = None) -> VGG:
    """A :class:`VGG` with :func:`random_params` weights on ``device``,
    its convolution weights in ``channels_last`` memory."""
    model = VGG(cfg, num_classes, dtype, bn_axis)
    model.load_state_dict(params_from_jax(*random_params(cfg, seed,
                                                         num_classes)))
    return model.to(device, memory_format=torch.channels_last)
