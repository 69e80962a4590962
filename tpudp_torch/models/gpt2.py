"""GPT-2 in PyTorch — the port's counterpart of ``tpudp/models/gpt2.py``.

Pre-LN blocks, learned positional embeddings, tanh-approximated GELU MLP
and a tied input/output embedding, with the same parameter names as the
flax model (``h_i/attn/qkv``, ``ln_1``, ``mlp_fc`` ...) so that
:func:`params_from_jax` carries a flax tree across one leaf at a time.

Dense and flash attention (``attn_impl``, dispatched by
``tpudp_torch.ops.attention.multihead_attention`` as in the JAX model)
with the dense MLP are ported.  Ring attention and the MoE MLP are a
later slice (ROADMAP.md, Queue 1); asking for them raises
:class:`NotImplementedError` instead of silently running dense math.

LayerNorm runs in float32 and every matmul in ``config.dtype``, exactly
the flax model's policy; the raw-module twins :func:`embed_tokens` and
:func:`lm_head` are what the decode path in ``tpudp_torch.models.
generate`` drives.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpudp_torch.ops.attention import multihead_attention

_LATER = {
    "attn_impl": {"ring": "slice 6b (ring attention)"},
    "mlp_impl": {"moe": "slice 6b (MoE MLP)"},
}


@dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50_257
    max_seq_len: int = 1024
    num_layers: int = 12
    num_heads: int = 12
    d_model: int = 768
    mlp_ratio: int = 4
    ln_eps: float = 1e-5
    dtype: torch.dtype = torch.float32
    attn_impl: str = "dense"
    mlp_impl: str = "dense"

    def __post_init__(self):
        for field, choices in (("attn_impl", ("dense", "flash", "ring")),
                               ("mlp_impl", ("dense", "moe"))):
            value = getattr(self, field)
            if value not in choices:
                raise ValueError(f"unknown {field} {value!r}; choose from "
                                 f"{', '.join(map(repr, choices))}")
            if value in _LATER[field]:
                raise NotImplementedError(
                    f"{field}={value!r} is not ported yet: ROADMAP.md "
                    f"{_LATER[field][value]}")
        if self.d_model % self.num_heads:
            raise ValueError(f"d_model ({self.d_model}) must divide by "
                             f"num_heads ({self.num_heads})")


def gpt2_small(**overrides) -> "GPT2":
    return GPT2(GPT2Config(**overrides))


class CausalSelfAttention(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.qkv = nn.Linear(cfg.d_model, 3 * cfg.d_model)
        self.proj = nn.Linear(cfg.d_model, cfg.d_model)


class Block(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.ln_1 = nn.LayerNorm(cfg.d_model, eps=cfg.ln_eps)
        self.attn = CausalSelfAttention(cfg)
        self.ln_2 = nn.LayerNorm(cfg.d_model, eps=cfg.ln_eps)
        self.mlp_fc = nn.Linear(cfg.d_model, cfg.mlp_ratio * cfg.d_model)
        self.mlp_proj = nn.Linear(cfg.mlp_ratio * cfg.d_model, cfg.d_model)


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """The flax model's LayerNorm: statistics and affine in float32."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                        ln.bias.float(), ln.eps)


def dense(lin: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    """``x @ kernel + bias`` in ``dtype`` (``tpudp``'s ``_dense``)."""
    return F.linear(x.to(dtype), lin.weight.to(dtype), lin.bias.to(dtype))


def mlp(blk: Block, x: torch.Tensor, dtype) -> torch.Tensor:
    h = F.gelu(dense(blk.mlp_fc, layer_norm(blk.ln_2, x), dtype),
               approximate="tanh")
    return dense(blk.mlp_proj, h, dtype)


def embed_tokens(model: "GPT2", tokens: torch.Tensor,
                 positions: torch.Tensor | None = None) -> torch.Tensor:
    """``wte(tokens) + wpe(positions)`` in ``config.dtype``."""
    dtype = model.config.dtype
    if positions is None:
        positions = torch.arange(tokens.shape[-1], device=tokens.device)
    return (model.wte.weight.to(dtype)[tokens]
            + model.wpe.weight.to(dtype)[positions])


def lm_head(model: "GPT2", x: torch.Tensor) -> torch.Tensor:
    """Final LayerNorm plus the tied-embedding head; float32 logits."""
    dtype = model.config.dtype
    x = layer_norm(model.ln_f, x)
    return (x.to(dtype) @ model.wte.weight.to(dtype).T).float()


class GPT2(nn.Module):
    """Decoder-only LM: ``(B, T) int tokens -> (B, T, vocab) float32
    logits``, the twin of the flax ``GPT2.__call__``.  ``train`` is
    accepted for the flax signature's sake: there is no dropout, so
    training and evaluation run the same math."""

    def __init__(self, config: GPT2Config):
        super().__init__()
        self.config = config
        self.wte = nn.Embedding(config.vocab_size, config.d_model)
        self.wpe = nn.Embedding(config.max_seq_len, config.d_model)
        self.h = nn.ModuleList(Block(config)
                               for _ in range(config.num_layers))
        self.ln_f = nn.LayerNorm(config.d_model, eps=config.ln_eps)

    def forward(self, tokens: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        del train
        cfg = self.config
        b, t = tokens.shape
        h, dh = cfg.num_heads, cfg.d_model // cfg.num_heads
        x = embed_tokens(self, tokens)
        for blk in self.h:
            qkv = dense(blk.attn.qkv, layer_norm(blk.ln_1, x), cfg.dtype)
            q, k, v = (z.reshape(b, t, h, dh) for z in qkv.chunk(3, dim=-1))
            out = multihead_attention(q, k, v, causal=True,
                                      impl=cfg.attn_impl, dtype=cfg.dtype)
            x = x + dense(blk.attn.proj, out.reshape(b, t, -1), cfg.dtype)
            x = x + mlp(blk, x, cfg.dtype)
        return lm_head(self, x)


def params_from_jax(np_params: dict) -> dict[str, torch.Tensor]:
    """A ``GPT2`` state dict from a flax GPT-2 parameter tree (numpy or
    any array type ``np.asarray`` accepts).  Dense kernels are stored
    ``(in, out)`` by flax and ``(out, in)`` by ``nn.Linear``, so they are
    transposed; everything else carries across as it is."""
    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    def linear(prefix, p):
        return {f"{prefix}.weight": t(p["kernel"]).T.contiguous(),
                f"{prefix}.bias": t(p["bias"])}

    def norm(prefix, p):
        return {f"{prefix}.weight": t(p["scale"]),
                f"{prefix}.bias": t(p["bias"])}

    state = {"wte.weight": t(np_params["wte"]["embedding"]),
             "wpe.weight": t(np_params["wpe"]["embedding"])}
    state.update(norm("ln_f", np_params["ln_f"]))
    i = 0
    while f"h_{i}" in np_params:
        p = np_params[f"h_{i}"]
        state.update(norm(f"h.{i}.ln_1", p["ln_1"]))
        state.update(norm(f"h.{i}.ln_2", p["ln_2"]))
        state.update(linear(f"h.{i}.attn.qkv", p["attn"]["qkv"]))
        state.update(linear(f"h.{i}.attn.proj", p["attn"]["proj"]))
        state.update(linear(f"h.{i}.mlp_fc", p["mlp_fc"]))
        state.update(linear(f"h.{i}.mlp_proj", p["mlp_proj"]))
        i += 1
    return state


def random_params(cfg: GPT2Config, seed: int) -> dict:
    """A flax-layout GPT-2 tree of float32 numpy weights drawn from
    ``seed``: normal(0, 0.02) matrices and embeddings, small normal
    biases, LayerNorm scales near one.  The same tree feeds the flax
    model and, through :func:`params_from_jax`, the port, so both
    frameworks see identical weights."""
    rng = np.random.default_rng(seed)

    def normal(*shape, std=0.02):
        return (rng.standard_normal(shape, np.float32) * std)

    def norm():
        return {"scale": 1.0 + normal(cfg.d_model, std=0.1),
                "bias": normal(cfg.d_model, std=0.02)}

    def linear(n_in, n_out):
        return {"kernel": normal(n_in, n_out), "bias": normal(n_out)}

    d, f = cfg.d_model, cfg.mlp_ratio * cfg.d_model
    tree = {"wte": {"embedding": normal(cfg.vocab_size, d)},
            "wpe": {"embedding": normal(cfg.max_seq_len, d)},
            "ln_f": norm()}
    for i in range(cfg.num_layers):
        tree[f"h_{i}"] = {"ln_1": norm(), "ln_2": norm(),
                          "attn": {"qkv": linear(d, 3 * d),
                                   "proj": linear(d, d)},
                          "mlp_fc": linear(d, f), "mlp_proj": linear(f, d)}
    return tree


def build(cfg: GPT2Config, seed: int, device) -> GPT2:
    """A GPT-2 with :func:`random_params` weights, on ``device``; its
    parameters keep their gradients, so the same module can be trained
    and served."""
    model = GPT2(cfg)
    model.load_state_dict(params_from_jax(random_params(cfg, seed)))
    return model.to(device)
