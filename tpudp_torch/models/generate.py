"""KV-cached decode for the GPT-2 and LLaMA families — the port of
``tpudp/models/generate.py``'s dense cache, paged-pool write and read,
int8 pages, and ``generate()``.

The decode twins drive the model's own modules (``tpudp_torch.models.
gpt2`` or ``tpudp_torch.models.llama``, chosen by the config's family as
in JAX) with the flax model's op order: norms in float32, matmuls in
``config.dtype``, a float32 softmax.  PyTorch runs eagerly, so where JAX
returns new buffers these functions write the KV cache and the page pool
IN PLACE and return the same tensors: a decode step's write is one token
row, never a copy of the pool.

Ported here: the dense ``KVCache`` arena (``_forward_cached``, the
port's own oracle), the paged pool — fp (``KVCache``) or int8
(:class:`Int8Pages`, quantized at the write by :func:`_quantize_kv`) —
its write (:func:`write_token_pages`) and read (:class:`_PagedKV` over
``tpudp_torch.ops.paged_attention``), :func:`_forward_paged` in slice
mode (einsum) and whole-pool mode (kernels), the speculative tree
forwards (:func:`_forward_tree` over a dense view, :func:`gather_pages`
to make one from the pool, and :func:`_forward_tree_paged` through the
block table), greedy or sampled :func:`generate`, :func:`beam_search`
(one prefill, the cache fanned out to the beams and reordered by parent
beam each step), :func:`draft_greedy`, the fused speculation window's
draft model on static shapes, and the ``impl='gather'`` baseline of
:func:`_forward_paged` (:func:`gather_pages` -> the dense forward ->
:func:`scatter_pages`).  Caches and pools are ``kv_heads`` wide
(LLaMA's GQA).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from tpudp_torch.models import llama
from tpudp_torch.models.gpt2 import (GPT2Config, dense, embed_tokens,
                                     layer_norm, lm_head, mlp)
from tpudp_torch.ops.paged_attention import (paged_attention,
                                             tree_attention,
                                             tree_paged_attention)
from tpudp_torch.ops.sampling import truncate_logits


def _is_llama(cfg) -> bool:
    return isinstance(cfg, llama.LlamaConfig)


def _kv_shape(cfg, batch: int, length: int) -> tuple:
    """``(layers, batch, length, kv_heads, head_dim)``: GQA configs
    (``LlamaConfig.kv_heads < num_heads``) store K/V at KV width."""
    return (cfg.num_layers, batch, length,
            getattr(cfg, "kv_heads", cfg.num_heads),
            cfg.d_model // cfg.num_heads)


class KVCache(NamedTuple):
    k: torch.Tensor  # (layers, batch, max_len, kv_heads, head_dim)
    v: torch.Tensor

    @classmethod
    def zeros(cls, cfg, batch: int, max_len: int,
              device="cpu") -> "KVCache":
        shape = _kv_shape(cfg, batch, max_len)
        return cls(torch.zeros(shape, dtype=cfg.dtype, device=device),
                   torch.zeros(shape, dtype=cfg.dtype, device=device))


class Int8Pages(NamedTuple):
    """A quantized page pool (``Engine(kv_dtype="int8")``): k/v payloads
    in int8 with one float32 scale per (layer, page, token, head) vector,
    read as ``int8 * scale``, behind the same block tables as an fp pool
    (same page ids, same allocation order)."""

    k: torch.Tensor        # (layers, pages, page_tokens, kv_heads, dh) int8
    v: torch.Tensor
    k_scale: torch.Tensor  # (layers, pages, page_tokens, kv_heads) float32
    v_scale: torch.Tensor

    @classmethod
    def zeros(cls, cfg, num_pages: int, page_tokens: int,
              device="cpu") -> "Int8Pages":
        shape = _kv_shape(cfg, num_pages, page_tokens)
        return cls(torch.zeros(shape, dtype=torch.int8, device=device),
                   torch.zeros(shape, dtype=torch.int8, device=device),
                   torch.ones(shape[:-1], device=device),
                   torch.ones(shape[:-1], device=device))


def _quantize_kv(x: torch.Tensor):
    """``(..., dh)`` -> (int8 payload, float32 per-vector scale):
    symmetric absmax, ``scale = max|x| / 127`` (1 for a zero vector, so
    it dequantizes to exact zeros), ``clip(round(x / scale), -127, 127)``
    with round-half-to-even — bit-equal to JAX's ``_quantize_kv``."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def write_token_pages(pages, k_new: torch.Tensor, v_new: torch.Tensor,
                      table: torch.Tensor, pos, active: torch.Tensor,
                      layer: int | None = None):
    """Commit a ``cur``-token window's K/V ``(b, cur, kv, dh)`` into the
    pages holding positions ``[pos, pos + cur)``, in place.  ``pages``
    is ``(k, v)`` fp or the int8 quadruple ``(k, v, k_scale, v_scale)``,
    whose new vectors are quantized here by :func:`_quantize_kv` (the
    window's own attention, which follows the write, reads them back
    quantized, as in JAX).

    A scalar ``pos`` with ``cur`` equal to the page size is the
    page-aligned prefill chunk: one whole-page write per slot (a chunk
    that does not start on a page boundary goes to scratch, as in JAX).
    Otherwise every (slot, window position) writes exactly one token row
    of the page containing it.  Writes of inactive slots and of
    positions past the table or on unmapped entries go to the trailing
    scratch page.  ``layer`` selects the stratum of a whole stacked
    pool ``(layers, P + 1, T, ...)``."""
    ix = () if layer is None else (layer,)
    k_buf = pages[0]
    if len(pages) == 4:
        qk, sk = _quantize_kv(k_new)
        qv, sv = _quantize_kv(v_new)
        new = (qk, qv, sk, sv)
    else:
        new = (k_new, v_new)
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
        index = (*ix, torch.where(ok, page[:, 0], scratch))
    else:
        p = pos[:, None] + torch.arange(cur, device=dev)  # (b, cur)
        ok, page = lookup(p)
        index = (*ix, torch.where(ok, page, scratch), p % page_tokens)
    for buf, val in zip(pages, new):
        buf[index] = val.to(buf.dtype)
    return pages


def _layer_pages(pool, i: int):
    """One layer's page buffers — ``(k, v)`` or the int8 quadruple:
    views, so writes land in the pool."""
    return tuple(buf[i] for buf in pool)


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


def _embed(model, tokens: torch.Tensor, positions) -> torch.Tensor:
    """The family's embedding: GPT-2 adds learned positions, LLaMA's
    enter through RoPE inside the blocks."""
    if _is_llama(model.config):
        return llama.embed_tokens(model, tokens)
    return embed_tokens(model, tokens, positions)


def _head(model, x: torch.Tensor) -> torch.Tensor:
    return (llama.lm_head if _is_llama(model.config) else lm_head)(model, x)


def _decode_block(cfg):
    """The family's one-block decode twin (same signature for both)."""
    return llama.block_decode if _is_llama(cfg) else _block_decode


def _forward_cached(model, tokens: torch.Tensor, cache: KVCache, pos):
    """Token ids ``(b, cur)`` at position ``pos`` (a scalar, or ``(b,)``
    per-row depths) -> ``(b, cur, vocab)`` float32 logits; the cache is
    written in place and returned.  Dispatches on the config's family,
    as the JAX function does."""
    cfg = model.config
    block = _decode_block(cfg)
    x = _embed(model, tokens, _positions(pos, tokens.shape[1],
                                         tokens.device))
    for i, blk in enumerate(model.h):
        x, _, _ = block(cfg, blk, x, cache.k[i], cache.v[i], pos)
    return _head(model, x), cache


def draft_greedy(model, hist: torch.Tensor, cache: KVCache,
                 lens: torch.Tensor, k: int, chunk: int) -> torch.Tensor:
    """``k`` greedy draft tokens ``(S, k)`` int64 per row of a token
    history ``hist`` ``(S, W)`` whose last real token sits at ``lens``
    ``(S,)``, on static shapes with nothing read back to the host — the
    draft half of ``tpudp/serve/engine.py``'s ``_fused_spec_math``.

    The history is prefilled into ``cache`` (at least ``W + k`` wide,
    written in place; nothing in it needs clearing) in causal q-chunks
    of ``chunk`` tokens (``W % chunk == 0``): pad positions past
    ``lens`` sit behind the causal mask, as in the host drafter's padded
    bucket.  Only each row's hidden state at ``lens`` goes through the
    head; then ``k - 1`` cached greedy steps at ``lens + 1 + j``.  The
    drafts are those of ``DraftModelDrafter(bucket=W)`` on each row's
    ``hist[:lens + 1]``."""
    cfg = model.config
    block = _decode_block(cfg)
    s, width = hist.shape
    dev = hist.device
    rows = torch.arange(s, device=dev)
    last = None
    for c in range(width // chunk):
        start = c * chunk
        # Per-row starts made on the device: a host scalar would be
        # copied in (and read back by the dense block), which a CUDA
        # graph cannot hold.
        pos = torch.full((s,), start, dtype=torch.long, device=dev)
        x = _embed(model, hist[:, start:start + chunk],
                   _positions(pos, chunk, dev))
        for i, blk in enumerate(model.h):
            x, _, _ = block(cfg, blk, x, cache.k[i], cache.v[i], pos)
        rel = lens.long() - start
        pick = x[rows, rel.clamp(0, chunk - 1)]
        inside = ((rel >= 0) & (rel < chunk))[:, None]
        last = pick if last is None else torch.where(inside, pick, last)
    tok = torch.argmax(_head(model, last[:, None])[:, 0], dim=-1)
    drafts = [tok]
    for j in range(k - 1):
        logits, _ = _forward_cached(model, drafts[-1][:, None], cache,
                                    lens + 1 + j)
        drafts.append(torch.argmax(logits[:, 0], dim=-1))
    return torch.stack(drafts, dim=1)


def _forward_paged(model, tokens: torch.Tensor, pool,
                   table: torch.Tensor, pos, active: torch.Tensor,
                   impl: str = "einsum"):
    """Page-table-indirected twin of :func:`_forward_cached` over an fp
    (``KVCache``) or int8 (:class:`Int8Pages`) pool; returns ``(logits,
    pool)`` with the pool written in place.

    ``impl='kernel'`` runs whole-pool mode — every layer's store holds
    the stacked pool and passes its layer index to the kernels, so no
    per-layer slice is taken — and ``impl='einsum'`` gives each layer
    its own slice.  LLaMA reads through the grouped (GQA) attention
    family, GPT-2 through the MHA one.  ``impl='gather'`` is JAX's
    baseline: gather the dense view (:func:`gather_pages`), run the dense
    forward on it, and write the touched pages back
    (:func:`scatter_pages`)."""
    cfg = model.config
    if impl == "gather":
        view = gather_pages(pool, table, cfg.dtype)
        logits, view = _forward_cached(model, tokens, view, pos)
        spos = torch.as_tensor(pos, device=tokens.device).long()
        if not spos.dim():
            spos = spos.expand(tokens.shape[0])
        return logits, scatter_pages(pool, view, table, spos,
                                     tokens.shape[1], active)
    block = _decode_block(cfg)
    x = _embed(model, tokens, _positions(pos, tokens.shape[1],
                                         tokens.device))
    whole = impl == "kernel"
    for i, blk in enumerate(model.h):
        store = _PagedKV(cfg, tuple(pool) if whole else _layer_pages(pool, i),
                         table, pos, active, grouped=_is_llama(cfg),
                         impl=impl, layer=i if whole else None)
        x, _, _ = block(cfg, blk, x, None, None, pos, paged=store)
    return _head(model, x), pool


def gather_pages(pool, table: torch.Tensor, dtype) -> KVCache:
    """The logical dense view ``(L, S, M * T, kv, dh)`` in ``dtype`` of a
    page pool ``(L, P + 1, T, kv, dh)`` through the block table ``(S,
    M)``; an int8 pool dequantizes as ``(int8.float() * scale).to(dtype)``,
    JAX's math.  Unmapped entries read the scratch page, whose rows sit
    past every slot's length, where the visibility mask excludes them."""
    scratch = pool.k.shape[1] - 1
    tbl = torch.where(table >= 0, table, scratch).long()

    def grab(buf):
        g = buf[:, tbl]  # (L, S, M, T, ...)
        return g.flatten(2, 3)

    if isinstance(pool, Int8Pages):
        return KVCache(
            (grab(pool.k).float() * grab(pool.k_scale)[..., None]).to(dtype),
            (grab(pool.v).float() * grab(pool.v_scale)[..., None]).to(dtype))
    return KVCache(grab(pool.k).to(dtype), grab(pool.v).to(dtype))


def scatter_pages(pool, view: KVCache, table: torch.Tensor,
                  pos: torch.Tensor, cur: int, active: torch.Tensor):
    """Write back, in place, the pages of the dense ``view`` that a
    ``cur``-token forward at per-slot positions ``pos`` ``(S,)`` touched
    (JAX's ``scatter_pages``): for each of the at most ``(cur + T - 2)
    // T + 1`` pages a window spans, the view's page-sized slice goes to
    the slot's table entry, an int8 pool requantizing it.  Writes of
    inactive slots, of a spare page the window did not reach and of
    unmapped or out-of-table entries go to the scratch page, so no
    shared page is ever written.  Returns the pool."""
    page_tokens = pool.k.shape[2]
    n_pages = table.shape[1]
    scratch = pool.k.shape[1] - 1
    dev = pool.k.device
    table = torch.as_tensor(table, device=dev).long()
    pos = torch.as_tensor(pos, device=dev).long()
    active = torch.as_tensor(active, device=dev)
    rows = torch.arange(table.shape[0], device=dev)[:, None]
    offsets = torch.arange(page_tokens, device=dev)
    first = pos // page_tokens
    last = (pos + cur - 1) // page_tokens
    for j in range((cur + page_tokens - 2) // page_tokens + 1):
        pidx = first + j
        safe = pidx.clamp(0, n_pages - 1)
        page = torch.gather(table, 1, safe[:, None])[:, 0]
        valid = active & (pidx <= last) & (pidx < n_pages) & (page >= 0)
        page = torch.where(valid, page, scratch)
        cols = safe[:, None] * page_tokens + offsets  # (S, T)
        ck, cv = view.k[:, rows, cols], view.v[:, rows, cols]
        if isinstance(pool, Int8Pages):
            (qk, sk), (qv, sv) = _quantize_kv(ck), _quantize_kv(cv)
            new = (qk, qv, sk, sv)
        else:
            new = (ck, cv)
        for buf, val in zip(pool, new):
            buf[:, page] = val.to(buf.dtype)
    return pool


def _block_tree(cfg: GPT2Config, blk, x: torch.Tensor, k_cache, v_cache,
                pos0, anc, paged: "_TreePagedKV | None" = None):
    """One pre-LN block over a speculative token tree of ``T+1`` nodes
    ``(b, T+1, d)`` — the no-write twin of :func:`_block_decode`.
    Sibling nodes share a logical position, so the window K/V stay out
    of the cache: each node attends the committed cache (positions
    ``< pos0``) jointly with its in-window ancestors-or-self (``anc``)
    under one softmax, read from the dense cache rows or, with
    ``paged``, through the block table.  Returns ``(x, k, v)`` with the
    window's K/V ``(b, T+1, kv, dh)`` for the caller to commit."""
    b, t1, d = x.shape
    h = cfg.num_heads
    dh = d // h
    qkv = dense(blk.attn.qkv, layer_norm(blk.ln_1, x), cfg.dtype)
    q, k, v = (z.reshape(b, t1, h, dh) for z in qkv.chunk(3, dim=-1))
    if paged is not None:
        out = paged.attend(q, k, v)
    else:
        out = tree_attention(q, k_cache, v_cache, pos0, k, v, anc,
                             dtype=cfg.dtype)
    x = x + dense(blk.attn.proj, out.reshape(b, t1, d), cfg.dtype)
    return x + mlp(blk, x, cfg.dtype), k, v


def _tree_positions(pos0, depths, device) -> torch.Tensor:
    return (torch.as_tensor(pos0, device=device).long()[:, None]
            + torch.as_tensor(depths, device=device)[None, :])


def _tree_block(cfg, blk, x, k_cache, v_cache, pos0, positions, anc,
                paged=None):
    """The family's tree-block twin; LLaMA's rotates q/k at
    ``positions`` (``pos0 + depth``), GPT-2's embedded them already."""
    if _is_llama(cfg):
        return llama.block_tree(cfg, blk, x, k_cache, v_cache, pos0,
                                positions, anc, paged=paged)
    return _block_tree(cfg, blk, x, k_cache, v_cache, pos0, anc,
                       paged=paged)


def _forward_tree(model, tokens: torch.Tensor, view: KVCache, pos0,
                  depths: tuple, anc):
    """Tree-verify forward: node tokens ``(b, T+1)`` (node 0 = each
    row's last committed token) at positions ``pos0 + depth`` against a
    read-only dense cache view -> ``(logits (b, T+1, vocab), wk, wv)``
    with the window K/V ``(L, b, T+1, kv, dh)``, which the caller
    commits for the accepted nodes only: this forward writes nothing."""
    cfg = model.config
    positions = _tree_positions(pos0, depths, tokens.device)
    x = _embed(model, tokens, positions)
    wk, wv = [], []
    for i, blk in enumerate(model.h):
        x, k_i, v_i = _tree_block(cfg, blk, x, view.k[i], view.v[i], pos0,
                                  positions, anc)
        wk.append(k_i)
        wv.append(v_i)
    return _head(model, x), torch.stack(wk), torch.stack(wv)


class _TreePagedKV:
    """One layer's read-only paged store for the tree-verify forward:
    ``attend`` runs tree attention over the whole stacked pool's layer
    ``layer`` through the block table, jointly with the window K/V —
    which never touch the pages, so there is no ``write``."""

    __slots__ = ("cfg", "pages", "table", "pos0", "anc", "layer")

    def __init__(self, cfg, pages, table, pos0, anc, layer):
        self.cfg = cfg
        self.pages = pages
        self.table = table
        self.pos0 = pos0
        self.anc = anc
        self.layer = layer

    def attend(self, q, k, v):
        return tree_paged_attention(q, self.pages, self.table, self.pos0,
                                    k, v, self.anc, dtype=self.cfg.dtype,
                                    layer=self.layer)


def _forward_tree_paged(model, tokens: torch.Tensor, pool,
                        table: torch.Tensor, pos0, depths: tuple, anc):
    """Paged twin of :func:`_forward_tree`: node queries attend the
    committed cache through the block table (the tree kernel on the
    card, whole-pool ``layer=i`` as in :func:`_forward_paged`'s kernel
    mode; no dense view is gathered).  Returns ``(logits, wk, wv)``; the
    pool is only read."""
    cfg = model.config
    positions = _tree_positions(pos0, depths, tokens.device)
    x = _embed(model, tokens, positions)
    wk, wv = [], []
    for i, blk in enumerate(model.h):
        store = _TreePagedKV(cfg, tuple(pool), table, pos0, anc, layer=i)
        x, k_i, v_i = _tree_block(cfg, blk, x, None, None, pos0, positions,
                                  anc, paged=store)
        wk.append(k_i)
        wv.append(v_i)
    return _head(model, x), torch.stack(wk), torch.stack(wv)


def validate_decode_config(cfg, fn_name: str) -> None:
    """Reject configs the decode twins cannot serve faithfully (dense
    attention and dense MLP only, as in the JAX package; a LLaMA config
    has no ``mlp_impl`` and is dense)."""
    mlp_impl = getattr(cfg, "mlp_impl", "dense")
    if cfg.attn_impl != "dense" or mlp_impl != "dense":
        raise ValueError(
            f"{fn_name} supports dense-attention/dense-MLP configs; got "
            f"attn_impl={cfg.attn_impl!r} mlp_impl={mlp_impl!r}")


def _validate_decode(cfg, prompt, max_new_tokens: int,
                     fn_name: str) -> int:
    """The decode entry points' shared checks; returns the total
    sequence length."""
    validate_decode_config(cfg, fn_name)
    prompt_len = prompt.shape[1]
    total = prompt_len + max_new_tokens
    if total > cfg.max_seq_len:
        raise ValueError(f"prompt ({prompt_len}) + max_new_tokens "
                         f"({max_new_tokens}) exceeds max_seq_len "
                         f"({cfg.max_seq_len})")
    return total


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
    total = _validate_decode(cfg, prompt, max_new_tokens, "generate()")
    b, prompt_len = prompt.shape
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


@torch.no_grad()
def beam_search(model, prompt: torch.Tensor, max_new_tokens: int, *,
                beam_width: int = 4) -> tuple[torch.Tensor, torch.Tensor]:
    """Beam-search decoding over the KV-cached decode path: ``(sequences
    (batch, prompt_len + max_new_tokens), scores (batch,))``, the
    highest-scoring beam of each batch row and its total float32
    log-probability.  One prefill at the prompt's batch ``b``; the cache
    and the last logits are then repeated beam-major to ``b *
    beam_width`` rows, only beam 0 starting live (scores ``[0, -inf,
    ...]``) so the first step picks distinct continuations.  Each step
    takes the top ``beam_width`` of ``score + log_softmax`` over
    ``beam_width * vocab`` candidates, reorders the cache rows by parent
    beam in place, and decodes the winners.  No EOS handling: every beam
    runs ``max_new_tokens`` steps, as in JAX."""
    cfg = model.config
    total = _validate_decode(cfg, prompt, max_new_tokens, "beam_search()")
    if beam_width < 1:
        raise ValueError(f"beam_width must be >= 1, got {beam_width}")
    b, prompt_len = prompt.shape
    w = beam_width
    dev = prompt.device
    cache = KVCache.zeros(cfg, b, total, dev)
    logits, cache = _forward_cached(model, prompt, cache, 0)
    cache = KVCache(cache.k.repeat_interleave(w, dim=1),
                    cache.v.repeat_interleave(w, dim=1))
    last = logits[:, -1].repeat_interleave(w, dim=0)  # (b w, vocab)
    scores = torch.full((b, w), -torch.inf, device=dev)
    scores[:, 0] = 0.0
    new_tokens = torch.zeros((b, w, max_new_tokens), dtype=prompt.dtype,
                             device=dev)
    batch_offset = (torch.arange(b, device=dev) * w)[:, None]
    for i in range(max_new_tokens):
        v = last.shape[-1]
        logprobs = F.log_softmax(last.float(), dim=-1)
        cand = scores[:, :, None] + logprobs.reshape(b, w, v)
        scores, top_idx = torch.topk(cand.reshape(b, w * v), w)
        parent = top_idx // v
        tok = (top_idx % v).to(prompt.dtype)
        gp = (batch_offset + parent).reshape(-1)  # global parent rows
        cache.k.copy_(cache.k[:, gp])
        cache.v.copy_(cache.v[:, gp])
        new_tokens = torch.gather(
            new_tokens, 1, parent[:, :, None].expand(-1, -1,
                                                     max_new_tokens))
        new_tokens[:, :, i] = tok
        logits, cache = _forward_cached(model, tok.reshape(b * w, 1),
                                        cache, prompt_len + i)
        last = logits[:, -1]
    best = torch.argmax(scores, dim=-1)
    rows = torch.arange(b, device=dev)
    return (torch.cat([prompt, new_tokens[rows, best]], dim=1),
            scores[rows, best])
