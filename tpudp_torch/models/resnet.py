"""The ResNet family (v1.5 bottleneck) in PyTorch — the port's
counterpart of ``tpudp/models/resnet.py`` (``BASELINE.json``
configs[3]: ResNet-50 on ImageNet-1k under the same DDP harness).

A 7x7/2 stem convolution (padding 3), BatchNorm and ReLU, a 3x3/2
max-pool (padding 1), stages of bottleneck blocks (1x1 -> 3x3, the
stride here: v1.5 -> 1x1 at 4x the width, a 1x1 ``proj_conv`` +
``proj_bn`` on the shortcut where the shape changes, the last
BatchNorm's scale initialized to zero so each block starts as the
identity), a global mean pool and one Linear layer.  Inputs are NHWC
batches, viewed as NCHW tensors in ``channels_last`` memory for cuDNN,
as :mod:`tpudp_torch.models.vgg` does.

Mixed precision follows flax's exactly, by explicit casts: parameters
stay float32; convolutions (no bias) and the Linear layer run in
``dtype``; BatchNorm, ReLU, the residual add and both pools run in
float32; the logits come back float32.  ``bn_axis='data'`` makes every
BatchNorm cross-rank SyncBN (:mod:`tpudp_torch.models.norm`).

:func:`params_from_jax` carries the flax model's ``(params,
batch_stats)`` across (``stem_conv``, ``stem_bn``,
``BottleneckBlock_i/{Conv_0..2, BatchNorm_0..2, proj_conv, proj_bn}``,
``Dense_0``), and :func:`random_params` draws a flax-layout pair of the
port's own from a numpy seed.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpudp_torch.models.norm import BatchNorm
from tpudp_torch.models.vgg import lecun_normal

STAGES = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def _conv(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype
          ) -> torch.Tensor:
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), None, conv.stride,
                    conv.padding)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (stride here) -> 1x1 at ``4 * features``, plus the
    shortcut (projected where the shape changes), then ReLU."""

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32,
                 bn_axis: str | None = None):
        super().__init__()
        self.dtype = dtype
        out = 4 * features
        self.convs = nn.ModuleList([
            nn.Conv2d(in_channels, features, 1, bias=False),
            nn.Conv2d(features, features, 3, stride, padding=1, bias=False),
            nn.Conv2d(features, out, 1, bias=False)])
        self.bns = nn.ModuleList([BatchNorm(features, bn_axis),
                                  BatchNorm(features, bn_axis),
                                  BatchNorm(out, bn_axis)])
        nn.init.zeros_(self.bns[2].weight)  # the residual branch starts at 0
        self.proj_conv = self.proj_bn = None
        if stride != 1 or in_channels != out:
            self.proj_conv = nn.Conv2d(in_channels, out, 1, stride,
                                       bias=False)
            self.proj_bn = BatchNorm(out, bn_axis)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = x
        for i, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            y = bn(_conv(y, conv, self.dtype), train)
            if i < 2:
                y = F.relu(y)
        residual = x
        if self.proj_conv is not None:
            residual = self.proj_bn(_conv(x, self.proj_conv, self.dtype),
                                    train)
        return F.relu(residual + y)


class ResNet(nn.Module):
    """Bottleneck ResNet on NHWC ``(B, H, W, 3)`` float inputs (224x224
    ImageNet geometry); returns float32 logits ``(B, num_classes)``."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 width: int = 64, dtype: torch.dtype = torch.float32,
                 bn_axis: str | None = None):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.dtype = dtype
        self.stem_conv = nn.Conv2d(3, width, 7, 2, padding=3, bias=False)
        self.stem_bn = BatchNorm(width, bn_axis)
        blocks, channels = [], width
        for stage, n in enumerate(self.stage_sizes):
            for block in range(n):
                features = width * 2 ** stage
                stride = 2 if stage > 0 and block == 0 else 1
                blocks.append(BottleneckBlock(channels, features, stride,
                                              dtype, bn_axis))
                channels = 4 * features
        self.blocks = nn.ModuleList(blocks)
        self.fc = nn.Linear(channels, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        dt = self.dtype
        x = x.permute(0, 3, 1, 2)  # NHWC memory seen as NCHW
        x = F.relu(self.stem_bn(_conv(x, self.stem_conv, dt), train))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for block in self.blocks:
            x = block(x, train)
        x = x.mean(dim=(2, 3))  # global average pool, float32
        return F.linear(x.to(dt), self.fc.weight.to(dt),
                        self.fc.bias.to(dt)).float()


def _factory(depth: int):
    def build_variant(num_classes: int = 1000,
                      dtype: torch.dtype = torch.float32,
                      bn_axis: str | None = None) -> ResNet:
        return ResNet(STAGES[depth], num_classes, dtype=dtype,
                      bn_axis=bn_axis)

    build_variant.__name__ = f"ResNet{depth}"
    build_variant.__doc__ = (f"A ResNet-{depth} (the JAX package's "
                             f"ResNet{depth} factory).")
    return build_variant


ResNet50 = _factory(50)
ResNet101 = _factory(101)
ResNet152 = _factory(152)


def params_from_jax(params: dict, batch_stats: dict) -> dict:
    """A :class:`ResNet` state dict from the flax model's ``params`` and
    ``batch_stats`` trees (numpy or anything ``np.asarray`` takes): HWIO
    kernels become OIHW weights, ``Dense_0``'s ``(in, out)`` kernel an
    ``(out, in)`` weight, each BatchNorm's ``scale``, ``bias``, ``mean``
    and ``var`` the port's weight, bias and running statistics."""
    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    state = {}

    def conv(prefix, tree):
        state[f"{prefix}.weight"] = t(tree["kernel"]).permute(
            3, 2, 0, 1).contiguous()

    def bn(prefix, tree, stats):
        state[f"{prefix}.weight"] = t(tree["scale"])
        state[f"{prefix}.bias"] = t(tree["bias"])
        state[f"{prefix}.running_mean"] = t(stats["mean"])
        state[f"{prefix}.running_var"] = t(stats["var"])

    conv("stem_conv", params["stem_conv"])
    bn("stem_bn", params["stem_bn"], batch_stats["stem_bn"])
    i = 0
    while f"BottleneckBlock_{i}" in params:
        name, prefix = f"BottleneckBlock_{i}", f"blocks.{i}"
        p, s = params[name], batch_stats[name]
        for j in range(3):
            conv(f"{prefix}.convs.{j}", p[f"Conv_{j}"])
            bn(f"{prefix}.bns.{j}", p[f"BatchNorm_{j}"], s[f"BatchNorm_{j}"])
        if "proj_conv" in p:
            conv(f"{prefix}.proj_conv", p["proj_conv"])
            bn(f"{prefix}.proj_bn", p["proj_bn"], s["proj_bn"])
        i += 1
    state["fc.weight"] = t(params["Dense_0"]["kernel"]).T.contiguous()
    state["fc.bias"] = t(params["Dense_0"]["bias"])
    return state


def params_to_jax(state: dict) -> tuple[dict, dict]:
    """The inverse of :func:`params_from_jax`: the flax ``(params,
    batch_stats)`` trees of a :class:`ResNet` state dict, as contiguous
    tensors on the state's device.  Entries the state lacks are left
    out (see ``vgg.params_to_jax``)."""
    params, stats = {}, {}

    def put(tree, path, name, fn=lambda t: t):
        if name not in state:
            return
        for scope in path[:-1]:
            tree = tree.setdefault(scope, {})
        tree[path[-1]] = fn(state[name]).contiguous()

    def conv(path, prefix):
        put(params, path + ("kernel",), f"{prefix}.weight",
            lambda t: t.permute(2, 3, 1, 0))

    def bn(path, prefix):
        put(params, path + ("scale",), f"{prefix}.weight")
        put(params, path + ("bias",), f"{prefix}.bias")
        put(stats, path + ("mean",), f"{prefix}.running_mean")
        put(stats, path + ("var",), f"{prefix}.running_var")

    conv(("stem_conv",), "stem_conv")
    bn(("stem_bn",), "stem_bn")
    i = 0
    while any(k.startswith(f"blocks.{i}.") for k in state):
        name, prefix = f"BottleneckBlock_{i}", f"blocks.{i}"
        for j in range(3):
            conv((name, f"Conv_{j}"), f"{prefix}.convs.{j}")
            bn((name, f"BatchNorm_{j}"), f"{prefix}.bns.{j}")
        conv((name, "proj_conv"), f"{prefix}.proj_conv")
        bn((name, "proj_bn"), f"{prefix}.proj_bn")
        i += 1
    put(params, ("Dense_0", "kernel"), "fc.weight", lambda t: t.T)
    put(params, ("Dense_0", "bias"), "fc.bias")
    return params, stats


def random_params(stage_sizes: Sequence[int], seed: int,
                  num_classes: int = 1000, width: int = 64
                  ) -> tuple[dict, dict]:
    """A flax-layout ``(params, batch_stats)`` pair of float32 numpy
    arrays drawn from ``seed`` with flax's initializers' distributions:
    convolution and Dense kernels from ``lecun_normal``, zero biases,
    BatchNorm scales of one (zero for each block's last, as the flax
    block's ``scale_init``), running means of zero and variances of
    one."""
    rng = np.random.default_rng(seed)

    def bn(c, scale=1.0):
        return ({"scale": np.full(c, scale, np.float32),
                 "bias": np.zeros(c, np.float32)},
                {"mean": np.zeros(c, np.float32),
                 "var": np.ones(c, np.float32)})

    def conv(k, cin, cout):
        return {"kernel": lecun_normal(rng, (k, k, cin, cout), k * k * cin)}

    params, stats = {"stem_conv": conv(7, 3, width)}, {}
    params["stem_bn"], stats["stem_bn"] = bn(width)
    channels, i = width, 0
    for stage, n in enumerate(stage_sizes):
        features = width * 2 ** stage
        out = 4 * features
        for block in range(n):
            p, s = {}, {}
            for j, (k, cin, cout) in enumerate(((1, channels, features),
                                                (3, features, features),
                                                (1, features, out))):
                p[f"Conv_{j}"] = conv(k, cin, cout)
                p[f"BatchNorm_{j}"], s[f"BatchNorm_{j}"] = bn(
                    cout, 0.0 if j == 2 else 1.0)
            if block == 0:  # each stage's first block changes the shape
                p["proj_conv"] = conv(1, channels, out)
                p["proj_bn"], s["proj_bn"] = bn(out)
            params[f"BottleneckBlock_{i}"] = p
            stats[f"BottleneckBlock_{i}"] = s
            channels, i = out, i + 1
    params["Dense_0"] = {"kernel": lecun_normal(rng, (channels, num_classes),
                                                channels),
                         "bias": np.zeros(num_classes, np.float32)}
    return params, stats


def build(depth: int, seed: int, device, num_classes: int = 1000,
          dtype: torch.dtype = torch.float32) -> ResNet:
    """A ResNet-``depth`` (50, 101 or 152) with :func:`random_params`
    weights on ``device``, its convolution weights in ``channels_last``
    memory."""
    model = ResNet(STAGES[depth], num_classes, dtype=dtype)
    model.load_state_dict(params_from_jax(*random_params(
        STAGES[depth], seed, num_classes)))
    return model.to(device, memory_format=torch.channels_last)
