"""GPT-2 in PyTorch — the port's counterpart of ``tpudp/models/gpt2.py``.

Pre-LN blocks, learned positional embeddings, tanh-approximated GELU MLP
and a tied input/output embedding, with the same parameter names as the
flax model (``h_i/attn/qkv``, ``ln_1``, ``mlp_fc`` ...) so that
:func:`params_from_jax` carries a flax tree across one leaf at a time.

Dense, flash and ring attention (``attn_impl``, dispatched by
``tpudp_torch.ops.attention.multihead_attention`` as in the JAX model)
and the dense or MoE MLP (``mlp_impl``, ``tpudp_torch.models.moe``).
Ring attention runs over the ``seq_axis`` group bound by
``tpudp_torch.mesh.bind_axes`` (the rung's sequence shard then takes its
global positions, ``rank_on_seq * t`` on), and dense attention where the
axis is unbound, as in JAX; the MoE MLP's experts shard over a bound
``expert_axis``.

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

from tpudp_torch.mesh import axis_group
from tpudp_torch.models.moe import PARAM_NAMES as MOE_PARAMS
from tpudp_torch.models.moe import MoeMlp
from tpudp_torch.models.moe import random_params as moe_random_params
from tpudp_torch.ops.attention import multihead_attention


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
    seq_axis: str | None = None  # mesh axis of ring attention
    mlp_impl: str = "dense"
    num_experts: int = 8
    capacity_factor: float = 1.25
    moe_top_k: int = 1
    expert_axis: str | None = None  # mesh axis of expert parallelism

    def __post_init__(self):
        for field, choices in (("attn_impl", ("dense", "flash", "ring")),
                               ("mlp_impl", ("dense", "moe"))):
            value = getattr(self, field)
            if value not in choices:
                raise ValueError(f"unknown {field} {value!r}; choose from "
                                 f"{', '.join(map(repr, choices))}")
        if self.d_model % self.num_heads:
            raise ValueError(f"d_model ({self.d_model}) must divide by "
                             f"num_heads ({self.num_heads})")


def gpt2_small(**overrides) -> "GPT2":
    return GPT2(GPT2Config(**overrides))


def gpt2_medium(**overrides) -> "GPT2":
    """GPT-2 medium: 24 layers of width 1024, 16 heads."""
    return GPT2(GPT2Config(num_layers=24, num_heads=16, d_model=1024,
                           **overrides))


class CausalSelfAttention(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.qkv = nn.Linear(cfg.d_model, 3 * cfg.d_model)
        self.proj = nn.Linear(cfg.d_model, cfg.d_model)


class Block(nn.Module):
    def __init__(self, cfg: GPT2Config, local_experts: int | None = None):
        super().__init__()
        self.ln_1 = nn.LayerNorm(cfg.d_model, eps=cfg.ln_eps)
        self.attn = CausalSelfAttention(cfg)
        self.ln_2 = nn.LayerNorm(cfg.d_model, eps=cfg.ln_eps)
        if cfg.mlp_impl == "moe":
            self.moe = MoeMlp(cfg.d_model, cfg.num_experts, cfg.mlp_ratio,
                              cfg.capacity_factor, cfg.moe_top_k,
                              cfg.expert_axis, cfg.dtype, local_experts)
        else:
            self.mlp_fc = nn.Linear(cfg.d_model,
                                    cfg.mlp_ratio * cfg.d_model)
            self.mlp_proj = nn.Linear(cfg.mlp_ratio * cfg.d_model,
                                      cfg.d_model)


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """The flax model's LayerNorm: statistics and affine in float32."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                        ln.bias.float(), ln.eps)


def dense(lin: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    """``x @ kernel + bias`` in ``dtype`` (``tpudp``'s ``_dense``)."""
    return F.linear(x.to(dtype), lin.weight.to(dtype), lin.bias.to(dtype))


def mlp(blk: Block, x: torch.Tensor, dtype) -> torch.Tensor:
    """The block's MLP branch on the residual ``x`` (dense or MoE)."""
    if hasattr(blk, "moe"):
        return blk.moe(layer_norm(blk.ln_2, x))
    h = F.gelu(dense(blk.mlp_fc, layer_norm(blk.ln_2, x), dtype),
               approximate="tanh")
    return dense(blk.mlp_proj, h, dtype)


def attention(blk: Block, x: torch.Tensor, cfg: GPT2Config) -> torch.Tensor:
    """The block's attention branch on the residual ``x``."""
    b, t, _ = x.shape
    h, dh = cfg.num_heads, cfg.d_model // cfg.num_heads
    qkv = dense(blk.attn.qkv, layer_norm(blk.ln_1, x), cfg.dtype)
    q, k, v = (z.reshape(b, t, h, dh) for z in qkv.chunk(3, dim=-1))
    out = multihead_attention(q, k, v, causal=True, impl=cfg.attn_impl,
                              dtype=cfg.dtype, seq_axis=cfg.seq_axis)
    return dense(blk.attn.proj, out.reshape(b, t, -1), cfg.dtype)


def block_forward(blk: Block, x: torch.Tensor,
                  cfg: GPT2Config) -> torch.Tensor:
    """One pre-LN block: ``x + attn(ln_1(x))``, then ``+ mlp(ln_2(.))``."""
    x = x + attention(blk, x, cfg)
    return x + mlp(blk, x, cfg.dtype)


def positions_of(cfg: GPT2Config, t: int, device) -> torch.Tensor:
    """This rank's token positions: ``0..t-1``, offset by ``rank_on_seq *
    t`` when ring attention's ``seq_axis`` is bound (the rank holds one
    contiguous block of the sequence)."""
    positions = torch.arange(t, device=device)
    group = axis_group(cfg.seq_axis) if cfg.attn_impl == "ring" else None
    if group is not None:
        positions = positions + torch.distributed.get_rank(group) * t
    return positions


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

    def __init__(self, config: GPT2Config,
                 local_experts: int | None = None):
        super().__init__()
        self.config = config
        self.wte = nn.Embedding(config.vocab_size, config.d_model)
        self.wpe = nn.Embedding(config.max_seq_len, config.d_model)
        self.h = nn.ModuleList(Block(config, local_experts)
                               for _ in range(config.num_layers))
        self.ln_f = nn.LayerNorm(config.d_model, eps=config.ln_eps)

    def forward(self, tokens: torch.Tensor, train: bool = False,
                return_hidden: bool = False) -> torch.Tensor:
        """``return_hidden=True`` returns the ``(B, T, d_model)`` hidden
        states after the final LayerNorm, in ``config.dtype``, and skips
        the head (the chunked loss of ``tpudp_torch.ops.losses`` applies
        it chunk by chunk)."""
        del train
        cfg = self.config
        x = embed_tokens(self, tokens,
                         positions_of(cfg, tokens.shape[-1], tokens.device))
        for blk in self.h:
            x = block_forward(blk, x, cfg)
        if return_hidden:
            return layer_norm(self.ln_f, x).to(cfg.dtype)
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
        if "moe" in p:  # flax's own layout: raw params, not Dense kernels
            state.update({f"h.{i}.moe.{n}": t(p["moe"][n])
                          for n in MOE_PARAMS})
        else:
            state.update(linear(f"h.{i}.mlp_fc", p["mlp_fc"]))
            state.update(linear(f"h.{i}.mlp_proj", p["mlp_proj"]))
        i += 1
    return state


def params_to_jax(state: dict) -> dict:
    """The inverse of :func:`params_from_jax`: the flax GPT-2 tree of a
    ``GPT2`` state dict, as contiguous tensors on the state's device
    (``nn.Linear`` weights transposed back to ``(in, out)`` kernels).
    Entries the state lacks are left out, so a dict of one tensor a
    parameter maps to the parameters' flax layout."""
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

    put(("wte", "embedding"), "wte.weight")
    put(("wpe", "embedding"), "wpe.weight")
    norm(("ln_f",), "ln_f")
    i = 0
    while any(k.startswith(f"h.{i}.") for k in state):
        norm((f"h_{i}", "ln_1"), f"h.{i}.ln_1")
        norm((f"h_{i}", "ln_2"), f"h.{i}.ln_2")
        linear((f"h_{i}", "attn", "qkv"), f"h.{i}.attn.qkv")
        linear((f"h_{i}", "attn", "proj"), f"h.{i}.attn.proj")
        linear((f"h_{i}", "mlp_fc"), f"h.{i}.mlp_fc")
        linear((f"h_{i}", "mlp_proj"), f"h.{i}.mlp_proj")
        for n in MOE_PARAMS:
            put((f"h_{i}", "moe", n), f"h.{i}.moe.{n}")
        i += 1
    return tree


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
                                   "proj": linear(d, d)}}
        if cfg.mlp_impl == "moe":
            tree[f"h_{i}"]["moe"] = moe_random_params(
                d, cfg.num_experts, cfg.mlp_ratio, rng)
        else:
            tree[f"h_{i}"].update(mlp_fc=linear(d, f),
                                  mlp_proj=linear(f, d))
    return tree


def build(cfg: GPT2Config, seed: int, device) -> GPT2:
    """A GPT-2 with :func:`random_params` weights, on ``device``; its
    parameters keep their gradients, so the same module can be trained
    and served."""
    model = GPT2(cfg)
    model.load_state_dict(params_from_jax(random_params(cfg, seed)))
    return model.to(device)
