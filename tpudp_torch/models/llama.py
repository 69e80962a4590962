"""LLaMA-family decoder in PyTorch — the port's counterpart of
``tpudp/models/llama.py``.

RoPE (rotate-half, float32 angles), RMSNorm in float32, a bias-free
SwiGLU MLP, an untied output head and grouped-query attention: with
``num_kv_heads < num_heads`` the K/V projections, the decode cache and
the page pool are ``kv_heads`` wide, and each KV head serves
``num_heads // kv_heads`` query heads (query head ``j`` reads KV head
``j // groups``, ``jnp.repeat`` semantics).  Parameter names follow the
flax model (``wte``, ``h_i/attn/{wq,wk,wv,wo}``, ``h_i/rms_attn``,
``h_i/rms_mlp``, ``h_i/{gate,up,down}``, ``rms_f``, ``lm_head``; the
``h_i`` blocks are ``h.{i}`` here) so :func:`params_from_jax` carries a
flax tree across one leaf at a time.

The training forward broadcasts the KV heads to the query heads and runs
``tpudp_torch.ops.attention.multihead_attention`` (dense, or flash
through the K1-K3 kernels).  The decode twins :func:`block_decode` and
:func:`block_tree` attend the KV-width cache or page pool directly,
grouped, and are what ``tpudp_torch.models.generate`` drives for this
family.  Ring attention is a later slice and raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpudp_torch.ops.attention import multihead_attention
from tpudp_torch.ops.paged_attention import tree_attention


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32_000
    max_seq_len: int = 2048  # the decode bound; RoPE needs no table
    num_layers: int = 8
    num_heads: int = 8
    num_kv_heads: int | None = None  # None -> MHA; < num_heads -> GQA
    d_model: int = 512
    mlp_hidden: int | None = None  # None -> 8/3 d rounded up to 128
    rope_theta: float = 10_000.0
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.float32
    attn_impl: str = "dense"  # 'dense' | 'flash' | 'ring'

    def __post_init__(self):
        if self.attn_impl not in ("dense", "flash", "ring"):
            raise ValueError(f"unknown attn_impl {self.attn_impl!r}; choose "
                             f"from 'dense', 'flash', 'ring'")
        if self.attn_impl == "ring":
            raise NotImplementedError(
                "attn_impl='ring' is not ported yet: ROADMAP.md slice 6b "
                "(ring attention)")
        if self.num_kv_heads is not None and not (
                0 < self.num_kv_heads <= self.num_heads):
            raise ValueError(f"num_kv_heads {self.num_kv_heads} must be in "
                             f"[1, num_heads={self.num_heads}]")
        if self.num_heads % self.kv_heads:
            raise ValueError(f"num_heads {self.num_heads} not divisible by "
                             f"num_kv_heads {self.kv_heads} (GQA groups must "
                             f"be equal-sized)")
        if self.d_model % self.num_heads:
            raise ValueError(f"d_model {self.d_model} not divisible by "
                             f"num_heads {self.num_heads}")
        if (self.d_model // self.num_heads) % 2:
            raise ValueError("RoPE needs an even head dim")

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def hidden(self) -> int:
        if self.mlp_hidden is not None:
            return self.mlp_hidden
        return ((8 * self.d_model) // 3 + 127) // 128 * 128


def llama_small(**overrides) -> "Llama":
    return Llama(LlamaConfig(**overrides))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """Rotate ``x`` ``(B, T, H, Dh)`` by position-dependent angles:
    ``positions`` ``(T,)`` or ``(B, T)``; the head dim's two halves are
    the (real, imaginary) parts of ``Dh / 2`` pairs, pair ``i`` turning
    by ``positions / theta ** (2 i / Dh)``.  Computed in float32, cast
    back to ``x.dtype``."""
    half = x.shape[-1] // 2
    inv_freq = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                             device=x.device)
                                * 2.0 / x.shape[-1]))
    angles = positions.to(torch.float32)[..., None] * inv_freq
    cos = torch.cos(angles)[..., None, :]  # (T, 1, half) or (B, T, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


class RMSNorm(nn.Module):
    """flax ``nn.RMSNorm``'s parameter (``scale``) and epsilon."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))


def rms_norm(norm: RMSNorm, x: torch.Tensor) -> torch.Tensor:
    """RMSNorm in float32, as the flax model computes it."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    return xf * torch.rsqrt(ms + norm.eps) * norm.scale.float()


def dense(lin: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    """``x @ kernel`` in ``dtype``, bias-free (``tpudp``'s ``_dense_nb``)."""
    return F.linear(x.to(dtype), lin.weight.to(dtype))


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        dh = cfg.d_model // cfg.num_heads
        self.wq = nn.Linear(cfg.d_model, cfg.num_heads * dh, bias=False)
        self.wk = nn.Linear(cfg.d_model, cfg.kv_heads * dh, bias=False)
        self.wv = nn.Linear(cfg.d_model, cfg.kv_heads * dh, bias=False)
        self.wo = nn.Linear(cfg.d_model, cfg.d_model, bias=False)


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.rms_attn = RMSNorm(cfg.d_model, cfg.rms_eps)
        self.attn = LlamaAttention(cfg)
        self.rms_mlp = RMSNorm(cfg.d_model, cfg.rms_eps)
        self.gate = nn.Linear(cfg.d_model, cfg.hidden, bias=False)
        self.up = nn.Linear(cfg.d_model, cfg.hidden, bias=False)
        self.down = nn.Linear(cfg.hidden, cfg.d_model, bias=False)


def _qkv(cfg: LlamaConfig, blk: LlamaBlock, x: torch.Tensor, positions):
    """RoPE-rotated ``q`` ``(b, t, h, dh)``, ``k`` and ``v`` ``(b, t, kv,
    dh)`` of one block's attention input."""
    b, t, d = x.shape
    h, kv = cfg.num_heads, cfg.kv_heads
    dh = d // h
    hn = rms_norm(blk.rms_attn, x)
    attn = blk.attn
    q = apply_rope(dense(attn.wq, hn, cfg.dtype).reshape(b, t, h, dh),
                   positions, cfg.rope_theta)
    k = apply_rope(dense(attn.wk, hn, cfg.dtype).reshape(b, t, kv, dh),
                   positions, cfg.rope_theta)
    v = dense(attn.wv, hn, cfg.dtype).reshape(b, t, kv, dh)
    return q, k, v


def _finish_block(cfg: LlamaConfig, blk: LlamaBlock, x: torch.Tensor,
                  out: torch.Tensor) -> torch.Tensor:
    """The attention output projection, residual and SwiGLU MLP."""
    b, t, d = x.shape
    x = x + dense(blk.attn.wo, out.reshape(b, t, d), cfg.dtype)
    hn = rms_norm(blk.rms_mlp, x)
    gate = F.silu(dense(blk.gate, hn, cfg.dtype))
    return x + dense(blk.down, gate * dense(blk.up, hn, cfg.dtype), cfg.dtype)


def embed_tokens(model: "Llama", tokens: torch.Tensor) -> torch.Tensor:
    """``wte(tokens)`` in ``config.dtype`` (positions enter through RoPE
    inside the blocks)."""
    return model.wte.weight.to(model.config.dtype)[tokens]


def lm_head(model: "Llama", x: torch.Tensor) -> torch.Tensor:
    """Final RMSNorm plus the untied head; float32 logits."""
    dtype = model.config.dtype
    x = rms_norm(model.rms_f, x)
    return dense(model.lm_head, x, dtype).float()


def block_decode(cfg: LlamaConfig, blk: LlamaBlock, x: torch.Tensor,
                 k_cache, v_cache, pos, paged=None):
    """One block on ``(b, cur, d)`` new tokens at positions ``pos .. pos
    + cur - 1`` (``pos`` a scalar or ``(b,)`` per-row depths), writing
    the new K/V before attending: into the KV-width dense cache ``(b,
    max_len, kv, dh)``, in place, or with ``paged`` (a ``generate.
    _PagedKV``) into the page pool through the block table, read by the
    grouped paged-attention family.  Returns ``(x, k_cache, v_cache)``."""
    b, cur, d = x.shape
    h, kv = cfg.num_heads, cfg.kv_heads
    dh = d // h
    pos = torch.as_tensor(pos, device=x.device)
    offsets = torch.arange(cur, device=x.device)
    positions = pos[:, None] + offsets if pos.dim() else pos + offsets
    q, k, v = _qkv(cfg, blk, x, positions)
    if paged is not None:
        paged.write(k, v)
        out = paged.attend(q)
    else:
        from tpudp_torch.models.generate import update_cache_rows

        if pos.dim():
            update_cache_rows(k_cache, k, pos)
            update_cache_rows(v_cache, v, pos)
        else:
            p0 = int(pos)
            k_cache[:, p0:p0 + cur] = k
            v_cache[:, p0:p0 + cur] = v
        # Grouped attention over the KV-width cache: query head j reads
        # KV head j // groups without widening the cache.
        max_len = k_cache.shape[1]
        qg = q.reshape(b, cur, kv, h // kv, dh)
        lg = torch.einsum("bqkgd,bmkd->bkgqm", qg, k_cache) * dh ** -0.5
        visible = (torch.arange(max_len, device=x.device)
                   <= positions.expand(b, cur)[..., None])  # (b, cur, max_len)
        lg = lg.masked_fill(~visible[:, None, None],
                            torch.finfo(lg.dtype).min)
        pr = torch.softmax(lg.float(), dim=-1).to(cfg.dtype)
        out = torch.einsum("bkgqm,bmkd->bqkgd", pr, v_cache)
    return _finish_block(cfg, blk, x, out), k_cache, v_cache


def block_tree(cfg: LlamaConfig, blk: LlamaBlock, x: torch.Tensor,
               k_cache, v_cache, pos0, positions, anc, paged=None):
    """One block over a speculative token tree of ``T+1`` nodes ``(b,
    T+1, d)`` — the no-write twin of :func:`block_decode`: q/k rotate at
    ``positions = pos0 + depth``, and each node attends the committed
    cache (positions ``< pos0``, a dense view or, with ``paged``, through
    the block table) jointly with its in-window ancestors-or-self.
    Returns ``(x, k, v)`` with the window's K/V ``(b, T+1, kv, dh)``."""
    q, k, v = _qkv(cfg, blk, x, positions)
    if paged is not None:
        out = paged.attend(q, k, v)
    else:
        out = tree_attention(q, k_cache, v_cache, pos0, k, v, anc,
                             dtype=cfg.dtype)
    return _finish_block(cfg, blk, x, out), k, v


class Llama(nn.Module):
    """Decoder-only LM: ``(B, T) int tokens -> (B, T, vocab) float32
    logits``, the twin of the flax ``Llama.__call__``.  ``train`` is
    accepted for the flax signature's sake (no dropout)."""

    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.config = config
        self.wte = nn.Embedding(config.vocab_size, config.d_model)
        self.h = nn.ModuleList(LlamaBlock(config)
                               for _ in range(config.num_layers))
        self.rms_f = RMSNorm(config.d_model, config.rms_eps)
        self.lm_head = nn.Linear(config.d_model, config.vocab_size,
                                 bias=False)

    def forward(self, tokens: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        del train
        cfg = self.config
        groups = cfg.num_heads // cfg.kv_heads
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        x = embed_tokens(self, tokens)
        for blk in self.h:
            q, k, v = _qkv(cfg, blk, x, positions)
            # Each KV head broadcast to its query group, so every
            # attention backend serves GQA unchanged.
            k = k.repeat_interleave(groups, dim=2)
            v = v.repeat_interleave(groups, dim=2)
            out = multihead_attention(q, k, v, causal=True,
                                      impl=cfg.attn_impl, dtype=cfg.dtype)
            x = _finish_block(cfg, blk, x, out)
        return lm_head(self, x)


def params_from_jax(np_params: dict) -> dict[str, torch.Tensor]:
    """A ``Llama`` state dict from a flax LLaMA parameter tree (numpy or
    any array type ``np.asarray`` accepts).  Dense kernels are stored
    ``(in, out)`` by flax and ``(out, in)`` by ``nn.Linear``, so they are
    transposed; everything else carries across as it is."""
    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    def linear(prefix, p):
        return {f"{prefix}.weight": t(p["kernel"]).T.contiguous()}

    state = {"wte.weight": t(np_params["wte"]["embedding"]),
             "rms_f.scale": t(np_params["rms_f"]["scale"])}
    state.update(linear("lm_head", np_params["lm_head"]))
    i = 0
    while f"h_{i}" in np_params:
        p = np_params[f"h_{i}"]
        for norm in ("rms_attn", "rms_mlp"):
            state[f"h.{i}.{norm}.scale"] = t(p[norm]["scale"])
        for name in ("wq", "wk", "wv", "wo"):
            state.update(linear(f"h.{i}.attn.{name}", p["attn"][name]))
        for name in ("gate", "up", "down"):
            state.update(linear(f"h.{i}.{name}", p[name]))
        i += 1
    return state


def random_params(cfg: LlamaConfig, seed: int) -> dict:
    """A flax-layout LLaMA tree of float32 numpy weights drawn from
    ``seed``: normal(0, 0.02) matrices and embeddings, RMSNorm scales
    near one.  The same tree feeds the flax model and, through
    :func:`params_from_jax`, the port."""
    rng = np.random.default_rng(seed)

    def normal(*shape, std=0.02):
        return rng.standard_normal(shape, np.float32) * std

    def norm():
        return {"scale": 1.0 + normal(cfg.d_model, std=0.1)}

    def linear(n_in, n_out):
        return {"kernel": normal(n_in, n_out)}

    d, f = cfg.d_model, cfg.hidden
    kvd = cfg.kv_heads * (d // cfg.num_heads)
    tree = {"wte": {"embedding": normal(cfg.vocab_size, d)},
            "rms_f": norm(), "lm_head": linear(d, cfg.vocab_size)}
    for i in range(cfg.num_layers):
        tree[f"h_{i}"] = {"rms_attn": norm(), "rms_mlp": norm(),
                          "attn": {"wq": linear(d, d), "wk": linear(d, kvd),
                                   "wv": linear(d, kvd), "wo": linear(d, d)},
                          "gate": linear(d, f), "up": linear(d, f),
                          "down": linear(f, d)}
    return tree


def build(cfg: LlamaConfig, seed: int, device) -> Llama:
    """A LLaMA with :func:`random_params` weights, on ``device``."""
    model = Llama(cfg)
    model.load_state_dict(params_from_jax(random_params(cfg, seed)))
    return model.to(device)
