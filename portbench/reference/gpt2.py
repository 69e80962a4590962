"""GPT-2 in plain PyTorch: the benchmark's reference for LM training.

Pre-LN blocks with learned positions, a tanh-approximated GELU MLP, a
tied head and the mean next-token cross entropy, as the source's
``config.json`` describes GPT-2 (without dropout).  Float32 throughout
unless ``precision`` names a control.  Imports nothing of the program.

Weights are named and shaped as ``torch.nn.Linear`` and
``torch.nn.Embedding`` hold them (``(out, in)`` matrices), so that one
set drawn by the benchmark feeds the program and this reference alike.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.precision import matmul
from portbench.reference.sgd import leaf_norms, sgd_step


def param_specs(cfg: dict, positions: int) -> list[tuple]:
    """``(name, shape, mean, std, kind)`` of every weight, in one order."""
    d, v = cfg["n_embd"], cfg["vocab_size"]
    f = cfg.get("n_inner") or 4 * d
    init = cfg["init"]
    m, b = init["matrix_std"], init["bias_std"]
    ls, lb = init["ln_scale_std"], init["ln_shift_std"]

    def ln(prefix):
        return [(f"{prefix}.weight", (d,), 1.0, ls, "param"),
                (f"{prefix}.bias", (d,), 0.0, lb, "param")]

    def linear(prefix, n_in, n_out):
        return [(f"{prefix}.weight", (n_out, n_in), 0.0, m, "param"),
                (f"{prefix}.bias", (n_out,), 0.0, b, "param")]

    specs = [("wte.weight", (v, d), 0.0, m, "param"),
             ("wpe.weight", (positions, d), 0.0, m, "param")]
    for i in range(cfg["n_layer"]):
        p = f"h.{i}"
        specs += ln(f"{p}.ln_1") + linear(f"{p}.attn.qkv", d, 3 * d)
        specs += linear(f"{p}.attn.proj", d, d) + ln(f"{p}.ln_2")
        specs += linear(f"{p}.mlp_fc", d, f) + linear(f"{p}.mlp_proj", f, d)
    return specs + ln("ln_f")


def _linear(x, P, prefix, precision):
    return matmul(x, P[f"{prefix}.weight"].t(), precision) + \
        P[f"{prefix}.bias"]


def _ln(x, P, prefix, eps):
    return F.layer_norm(x, x.shape[-1:], P[f"{prefix}.weight"],
                        P[f"{prefix}.bias"], eps)


def loss_sum(P: dict, tokens: torch.Tensor, targets: torch.Tensor,
             cfg: dict, precision: str = "fp32") -> torch.Tensor:
    """The summed cross entropy of next-token ``targets`` over every
    position of ``tokens`` ``(b, t)``."""
    b, t = tokens.shape
    d, h = cfg["n_embd"], cfg["n_head"]
    dh, eps = d // h, cfg["layer_norm_epsilon"]
    causal = torch.ones(t, t, dtype=torch.bool, device=tokens.device).tril()
    x = P["wte.weight"][tokens] + P["wpe.weight"][:t]
    for i in range(cfg["n_layer"]):
        p = f"h.{i}"
        qkv = _linear(_ln(x, P, f"{p}.ln_1", eps), P, f"{p}.attn.qkv",
                      precision)
        q, k, v = (z.reshape(b, t, h, dh).transpose(1, 2)
                   for z in qkv.split(d, dim=-1))
        s = matmul(q, k.transpose(-1, -2), precision) / math.sqrt(dh)
        a = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
        o = matmul(a, v, precision).transpose(1, 2).reshape(b, t, d)
        x = x + _linear(o, P, f"{p}.attn.proj", precision)
        hid = F.gelu(_linear(_ln(x, P, f"{p}.ln_2", eps), P, f"{p}.mlp_fc",
                             precision), approximate="tanh")
        x = x + _linear(hid, P, f"{p}.mlp_proj", precision)
    logits = matmul(_ln(x, P, "ln_f", eps), P["wte.weight"].t(), precision)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1).long(), reduction="sum")


def train(P0: dict, batches: list, cfg: dict, precision: str = "fp32",
          block_rows: int = 8) -> dict:
    """SGD steps over ``batches`` (``(tokens, targets)`` of the global
    batch) from the weights ``P0``, each batch's loss the mean over all
    its positions, taken ``block_rows`` rows at a time.  Returns the
    losses, the first gradient's norm a leaf and the change of each leaf
    after the last step."""
    opt = cfg["optimizer"]
    params = {n: t.detach().clone().requires_grad_(True)
              for n, t in P0.items()}
    trace: dict = {}
    losses, first = [], None
    for step, (x, y) in enumerate(batches):
        for p in params.values():
            p.grad = None
        total = torch.zeros((), device=x.device)
        for r in range(0, x.shape[0], block_rows):
            part = loss_sum(params, x[r:r + block_rows], y[r:r + block_rows],
                            cfg, precision) / y.numel()
            part.backward()
            total += part.detach()
        losses.append(float(total))
        grads = {n: p.grad for n, p in params.items()}
        if step == 0:
            first = leaf_norms(grads)
        sgd_step(params, grads, trace, opt["lr"], opt["momentum"],
                 opt["weight_decay"])
    change = leaf_norms({n: params[n].detach() - P0[n] for n in params})
    return {"losses": losses, "grad": first, "change": change}
