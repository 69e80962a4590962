"""VGG for CIFAR-10 in plain PyTorch: the benchmark's reference for the
Part trainers.

3x3 convolutions (padding 1) each followed by BatchNorm over the batch
(biased variance, running statistics kept at momentum 0.9) and ReLU, 2x2
max-pools, a flatten in NHWC order and one Linear head; the mean cross
entropy.  Float32 unless ``precision`` names a control.  Imports nothing
of the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.precision import conv2d, matmul
from portbench.reference.sgd import leaf_norms, sgd_step


def param_specs(cfg: dict) -> list[tuple]:
    """``(name, shape, mean, std, kind)`` of every weight and statistic."""
    specs, c_in, size, i = [], cfg["channels"], cfg["image_size"], 0
    for v in cfg["layers"]:
        if v == "M":
            size //= 2
            continue
        specs += [(f"convs.{i}.weight", (v, c_in, 3, 3), 0.0,
                   math.sqrt(1.0 / (9 * c_in)), "param"),
                  (f"convs.{i}.bias", (v,), 0.0, 0.0, "param"),
                  (f"bns.{i}.weight", (v,), 1.0, 0.0, "param"),
                  (f"bns.{i}.bias", (v,), 0.0, 0.0, "param"),
                  (f"bns.{i}.running_mean", (v,), 0.0, 0.0, "buffer"),
                  (f"bns.{i}.running_var", (v,), 1.0, 0.0, "buffer")]
        c_in, i = v, i + 1
    n_in = c_in * size * size
    return specs + [("fc.weight", (cfg["num_classes"], n_in), 0.0,
                     math.sqrt(1.0 / n_in), "param"),
                    ("fc.bias", (cfg["num_classes"],), 0.0, 0.0, "param")]


def forward(P: dict, S: dict, images: torch.Tensor, cfg: dict,
            precision: str = "fp32") -> torch.Tensor:
    """The float32 logits of NHWC float ``images`` in training mode;
    updates the running statistics ``S`` in place."""
    bn = cfg["batch_norm"]
    keep, eps = bn["momentum"], bn["epsilon"]
    x, i = images.permute(0, 3, 1, 2), 0
    for v in cfg["layers"]:
        if v == "M":
            x = F.max_pool2d(x, 2, 2)
            continue
        x = conv2d(x, P[f"convs.{i}.weight"], P[f"convs.{i}.bias"],
                   precision)
        mean = x.mean(dim=(0, 2, 3))
        var = ((x - mean[:, None, None]) ** 2).mean(dim=(0, 2, 3))
        with torch.no_grad():
            S[f"bns.{i}.running_mean"].mul_(keep).add_((1 - keep) * mean)
            S[f"bns.{i}.running_var"].mul_(keep).add_((1 - keep) * var)
        x = (x - mean[:, None, None]) / torch.sqrt(var + eps)[:, None, None]
        x = F.relu(x * P[f"bns.{i}.weight"][:, None, None]
                   + P[f"bns.{i}.bias"][:, None, None])
        i += 1
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    return matmul(x, P["fc.weight"].t(), precision) + P["fc.bias"]


def train(W0: dict, batches: list, cfg: dict, precision: str = "fp32",
          specs: list | None = None) -> dict:
    """SGD steps over ``batches`` (``(images, labels)``) from ``W0``
    (weights and running statistics).  Returns the losses, the first
    step's logits, the first gradient's norm a leaf and the change of
    every leaf (the statistics among them) after the last step."""
    opt = cfg["optimizer"]
    kinds = {s[0]: s[4] for s in (specs or param_specs(cfg))}
    params = {n: t.detach().clone().requires_grad_(True)
              for n, t in W0.items() if kinds[n] == "param"}
    stats = {n: t.detach().clone() for n, t in W0.items()
             if kinds[n] == "buffer"}
    trace: dict = {}
    losses, first, logits = [], None, None
    for step, (x, y) in enumerate(batches):
        for p in params.values():
            p.grad = None
        out = forward(params, stats, x, cfg, precision)
        if step == 0:
            logits = out.detach().cpu()
        loss = F.cross_entropy(out, y.long(), reduction="sum") / y.numel()
        loss.backward()
        losses.append(float(loss.detach()))
        grads = {n: p.grad for n, p in params.items()}
        if step == 0:
            first = leaf_norms(grads)
        sgd_step(params, grads, trace, opt["lr"], opt["momentum"],
                 opt["weight_decay"])
    now = {**{n: p.detach() for n, p in params.items()}, **stats}
    change = leaf_norms({n: now[n] - W0[n] for n in now})
    return {"losses": losses, "logits": logits, "grad": first,
            "change": change}
