"""KV-cached decode for GPT-2 — the port of ``tpudp/models/generate.py``'s
dense cache, paged-pool write and read, and ``generate()``.

The decode twins drive the model's own modules (``tpudp_torch.models.
gpt2``) with the flax model's op order: LayerNorm in float32, matmuls in
``config.dtype``, a float32 softmax.  PyTorch runs eagerly, so where JAX
returns new buffers these functions write the KV cache and the page pool
IN PLACE and return the same tensors: a decode step's write is one token
row, never a copy of the pool.

Ported here: the dense ``KVCache`` arena (``_forward_cached``, the
port's own oracle), the paged pool's write (:func:`write_token_pages`)
and read (:class:`_PagedKV` over ``tpudp_torch.ops.paged_attention``),
:func:`_forward_paged` in slice mode (einsum) and whole-pool mode
(kernels), and greedy or sampled :func:`generate`.  int8 pages, the
gather path, tree forwards, beam search and LLaMA are later slices
(ROADMAP.md).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from tpudp_torch.models.gpt2 import (GPT2Config, dense, embed_tokens,
                                     layer_norm, lm_head, mlp)
from tpudp_torch.ops.paged_attention import paged_attention
from tpudp_torch.ops.sampling import truncate_logits


class KVCache(NamedTuple):
    k: torch.Tensor  # (layers, batch, max_len, kv_heads, head_dim)
    v: torch.Tensor

    @classmethod
    def zeros(cls, cfg: GPT2Config, batch: int, max_len: int,
              device="cpu") -> "KVCache":
        shape = (cfg.num_layers, batch, max_len, cfg.num_heads,
                 cfg.d_model // cfg.num_heads)
        return cls(torch.zeros(shape, dtype=cfg.dtype, device=device),
                   torch.zeros(shape, dtype=cfg.dtype, device=device))


def write_token_pages(pages, k_new: torch.Tensor, v_new: torch.Tensor,
                      table: torch.Tensor, pos, active: torch.Tensor,
                      layer: int | None = None):
    """Commit a ``cur``-token window's K/V ``(b, cur, kv, dh)`` into the
    pages holding positions ``[pos, pos + cur)``, in place.

    A scalar ``pos`` with ``cur`` equal to the page size is the
    page-aligned prefill chunk: one whole-page write per slot (a chunk
    that does not start on a page boundary goes to scratch, as in JAX).
    Otherwise every (slot, window position) writes exactly one token row
    of the page containing it.  Writes of inactive slots and of
    positions past the table or on unmapped entries go to the trailing
    scratch page.  ``layer`` selects the stratum of a whole stacked
    pool ``(layers, P + 1, T, ...)``."""
    ix = () if layer is None else (layer,)
    k_buf, v_buf = pages
    page_tokens = k_buf.shape[1 + len(ix)]
    scratch = k_buf.shape[len(ix)] - 1
    n_pages = table.shape[1]
    b, cur = k_new.shape[:2]
    dev = k_buf.device
    pos = torch.as_tensor(pos, device=dev)
    scalar_pos = pos.dim() == 0
    pos = pos.expand(b).long()
    active = torch.as_tensor(active, device=dev)
    table = torch.as_tensor(table, device=dev).long()

    def lookup(p):
        pidx = p // page_tokens
        page = torch.gather(table, 1, pidx.clamp(0, n_pages - 1))
        ok = active[:, None] & (pidx < n_pages) & (page >= 0)
        return ok, page

    if scalar_pos and cur == page_tokens:
        ok, page = lookup(pos[:, None])
        ok = ok[:, 0] & (pos % page_tokens == 0)
        page = torch.where(ok, page[:, 0], scratch)
        k_buf[(*ix, page)] = k_new.to(k_buf.dtype)
        v_buf[(*ix, page)] = v_new.to(v_buf.dtype)
        return pages
    p = pos[:, None] + torch.arange(cur, device=dev)  # (b, cur)
    ok, page = lookup(p)
    page = torch.where(ok, page, scratch)
    off = p % page_tokens
    k_buf[(*ix, page, off)] = k_new.to(k_buf.dtype)
    v_buf[(*ix, page, off)] = v_new.to(v_buf.dtype)
    return pages


def _layer_pages(pool: KVCache, i: int):
    """One layer's ``(k, v)`` page buffers: views, so writes land in the
    pool."""
    return (pool.k[i], pool.v[i])


class _PagedKV:
    """One layer's paged KV store threaded through :func:`_block_decode`:
    ``write`` lands the window's new K/V as page writes, ``attend`` reads
    K/V through the block table inside the attention op.  With
    ``layer`` the store holds the whole stacked pool (the kernels'
    whole-pool mode)."""

    __slots__ = ("cfg", "pages", "table", "pos", "active", "grouped",
                 "impl", "layer")

    def __init__(self, cfg, pages, table, pos, active, *, grouped, impl,
                 layer=None):
        self.cfg = cfg
        self.pages = pages
        self.table = table
        self.pos = pos
        self.active = active
        self.grouped = grouped
        self.impl = impl
        self.layer = layer

    def write(self, k: torch.Tensor, v: torch.Tensor) -> None:
        self.pages = write_token_pages(self.pages, k, v, self.table,
                                       self.pos, self.active,
                                       layer=self.layer)

    def attend(self, q: torch.Tensor) -> torch.Tensor:
        return paged_attention(q, self.pages, self.table, self.pos,
                               dtype=self.cfg.dtype, grouped=self.grouped,
                               impl=self.impl, layer=self.layer)


def update_cache_rows(cache: torch.Tensor, new: torch.Tensor,
                      pos: torch.Tensor) -> torch.Tensor:
    """Write ``new`` ``(b, cur, heads, dh)`` into ``cache``
    ``(b, max_len, heads, dh)`` at per-row start positions ``pos``
    ``(b,)``, in place."""
    b, cur = new.shape[:2]
    rows = torch.arange(b, device=cache.device)[:, None]
    cols = pos.long()[:, None] + torch.arange(cur, device=cache.device)
    cache[rows, cols] = new.to(cache.dtype)
    return cache


def _block_decode(cfg: GPT2Config, blk, x: torch.Tensor,
                  k_cache, v_cache, pos, paged: _PagedKV | None = None):
    """One pre-LN block on ``(b, cur, d)`` new tokens at positions
    ``pos .. pos + cur - 1`` (``pos`` a scalar or a ``(b,)`` vector),
    writing the new K/V before attending: into the dense cache, or with
    ``paged`` into the page pool through the block table."""
    b, cur, d = x.shape
    h = cfg.num_heads
    dh = d // h
    qkv = dense(blk.attn.qkv, layer_norm(blk.ln_1, x), cfg.dtype)
    q, k, v = (z.reshape(b, cur, h, dh) for z in qkv.chunk(3, dim=-1))
    if paged is not None:
        paged.write(k, v)
        out = paged.attend(q)
    else:
        pos = torch.as_tensor(pos, device=x.device)
        if pos.dim():
            update_cache_rows(k_cache, k, pos)
            update_cache_rows(v_cache, v, pos)
            q_pos = pos[:, None] + torch.arange(cur, device=x.device)
        else:
            p0 = int(pos)
            k_cache[:, p0:p0 + cur] = k
            v_cache[:, p0:p0 + cur] = v
            q_pos = (p0 + torch.arange(cur, device=x.device)).expand(b, cur)
        max_len = k_cache.shape[1]
        lg = torch.einsum("bqhd,bkhd->bhqk", q, k_cache) * dh ** -0.5
        visible = (torch.arange(max_len, device=x.device)
                   <= q_pos[..., None])  # (b, cur, max_len)
        lg = lg.masked_fill(~visible[:, None], torch.finfo(lg.dtype).min)
        pr = torch.softmax(lg.float(), dim=-1).to(cfg.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", pr, v_cache)
    x = x + dense(blk.attn.proj, out.reshape(b, cur, d), cfg.dtype)
    return x + mlp(blk, x, cfg.dtype), k_cache, v_cache


def _positions(pos, cur: int, device) -> torch.Tensor:
    pos = torch.as_tensor(pos, device=device)
    offsets = torch.arange(cur, device=device)
    return (pos[:, None] + offsets) if pos.dim() else pos + offsets


def _forward_cached(model, tokens: torch.Tensor, cache: KVCache, pos):
    """Token ids ``(b, cur)`` at position ``pos`` (a scalar, or ``(b,)``
    per-row depths) -> ``(b, cur, vocab)`` float32 logits; the cache is
    written in place and returned."""
    cfg = model.config
    x = embed_tokens(model, tokens, _positions(pos, tokens.shape[1],
                                               tokens.device))
    for i, blk in enumerate(model.h):
        x, _, _ = _block_decode(cfg, blk, x, cache.k[i], cache.v[i], pos)
    return lm_head(model, x), cache


def _forward_paged(model, tokens: torch.Tensor, pool: KVCache,
                   table: torch.Tensor, pos, active: torch.Tensor,
                   impl: str = "einsum"):
    """Page-table-indirected twin of :func:`_forward_cached`; returns
    ``(logits, pool)`` with the pool written in place.

    ``impl='kernel'`` runs whole-pool mode — every layer's store holds
    the stacked pool and passes its layer index to the kernels, so no
    per-layer slice is taken — and ``impl='einsum'`` gives each layer
    its own slice."""
    cfg = model.config
    x = embed_tokens(model, tokens, _positions(pos, tokens.shape[1],
                                               tokens.device))
    whole = impl == "kernel"
    for i, blk in enumerate(model.h):
        store = _PagedKV(cfg, tuple(pool) if whole else _layer_pages(pool, i),
                         table, pos, active, grouped=False, impl=impl,
                         layer=i if whole else None)
        x, _, _ = _block_decode(cfg, blk, x, None, None, pos, paged=store)
    return lm_head(model, x), pool


def validate_decode_config(cfg: GPT2Config, fn_name: str) -> None:
    """Reject configs the decode twins cannot serve faithfully (dense
    attention and dense MLP only, as in the JAX package)."""
    if cfg.attn_impl != "dense" or cfg.mlp_impl != "dense":
        raise ValueError(
            f"{fn_name} supports dense-attention/dense-MLP configs; got "
            f"attn_impl={cfg.attn_impl!r} mlp_impl={cfg.mlp_impl!r}")


@torch.no_grad()
def generate(model, prompt: torch.Tensor, max_new_tokens: int, *,
             temperature: float = 0.0, top_k: int | None = None,
             top_p: float | None = None,
             generator: torch.Generator | None = None) -> torch.Tensor:
    """``(batch, prompt_len + max_new_tokens)`` token ids: one prefill
    of the prompt, then ``max_new_tokens`` cached decode steps, all on
    the device of ``prompt``.  ``temperature=0`` is greedy argmax;
    otherwise softmax sampling from ``generator`` (required), truncated
    to ``top_k`` and/or the ``top_p`` nucleus."""
    cfg = model.config
    validate_decode_config(cfg, "generate()")
    b, prompt_len = prompt.shape
    total = prompt_len + max_new_tokens
    if total > cfg.max_seq_len:
        raise ValueError(f"prompt ({prompt_len}) + max_new_tokens "
                         f"({max_new_tokens}) exceeds max_seq_len "
                         f"({cfg.max_seq_len})")
    if temperature > 0 and generator is None:
        raise ValueError("temperature sampling needs a torch.Generator")
    if (top_k is not None or top_p is not None) and temperature == 0.0:
        raise ValueError("top_k/top_p require temperature > 0 (greedy "
                         "decoding ignores them)")
    dev = prompt.device
    cache = KVCache.zeros(cfg, b, total, dev)
    logits, cache = _forward_cached(model, prompt, cache, 0)
    last = logits[:, -1]
    out = [prompt]
    for i in range(max_new_tokens):
        if temperature == 0.0:
            tok = torch.argmax(last, dim=-1)
        else:
            scaled = last / temperature
            if top_k is not None or top_p is not None:
                scaled = truncate_logits(
                    scaled, torch.full((b,), top_k or 0, device=dev),
                    torch.full((b,), 1.0 if top_p is None else top_p,
                               device=dev))
            tok = torch.multinomial(F.softmax(scaled, dim=-1), 1,
                                    generator=generator)[:, 0]
        out.append(tok[:, None].to(prompt.dtype))
        logits, cache = _forward_cached(model, tok[:, None], cache,
                                        prompt_len + i)
        last = logits[:, -1]
    return torch.cat(out, dim=1)
