"""K5's decomposition (``tpudp_torch.ops.paged_attention.window_schedule``)
at the tiny geometry of tests/test_torch_paged_attention.py, on the CPU.

The CUDA window kernel cuts a call into blocks of (row tile, KV head,
slot, key split): each block folds the query rows of one KV head against
an even share of their key tiles into a partial (m, l, acc), and the last
split of a (row tile, KV head, slot) merges the partials.  These tests
hold the schedule that the wrapper hands the kernel (every query row
covered once, one KV head a block, a key tile for every split, the block
counts of the main path's shapes), and a PyTorch model of the kernel's
split-then-merge over that schedule against JAX's window kernel in
interpret mode and against the port's plain version, at 1e-5, over fp32
and int8 pools, scalar and per-slot depths, MHA and grouped heads, one
split and several.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudp.ops.paged_attention import paged_attention as jax_paged_attention
from tpudp_torch.models.generate import _quantize_kv
from tpudp_torch.ops import paged_attention as pa

S, T, DH = 3, 8, 16
M, P, LAYERS = 12, 30, 2  # table rows of 96 keys: three 32-key tiles
FAMILIES = {"mha": (4, 4), "gqa": (4, 2)}  # (query heads, kv heads)
TRAFFIC = {"verify3": (3, None), "prefill": (T, 64)}
VECTOR_POS = np.array([57, 83, 4], np.int32)


def _table():
    """Slots 0 and 1 share prefix pages 0-3 and diverge into private
    pages; slot 2's pages past its verify depth are mapped but not
    visible to that window; -1 tails sit past every slot's window.  Every
    visible entry is mapped, as the engine guarantees."""
    table = np.full((S, M), -1, np.int32)
    table[0, :9] = [0, 1, 2, 3, 4, 5, 6, 7, 8]
    table[1, :11] = [0, 1, 2, 3, 9, 10, 11, 12, 13, 14, 15]
    table[2, :9] = np.arange(16, 25)
    return table


def _blocks(sched):
    """Every block of the grid as (row tile, split, KV head, slot)."""
    x, kv, b = sched.grid
    return [(i // sched.splits, i % sched.splits, h, s)
            for s in range(b) for h in range(kv) for i in range(x)]


def _block_tiles(sched, rt, p0, cur, groups, capacity):
    """Key tiles of block row tile ``rt`` at depth ``p0``: keys 0 .. the
    visibility edge of its last row, within the table."""
    last_row = min((rt + 1) * sched.row_tile, cur * groups) - 1
    limit = min(p0 + last_row // groups, capacity - 1)
    return limit // pa.TILE_KEYS + 1 if limit >= 0 else 0


GEOMETRIES = {  # (b, cur, h, kv, n_keys)
    "gpt2-prefill-144": (1, 16, 12, 12, 160),
    "gpt2-prefill-1000": (1, 16, 12, 12, 1016),
    "gqa-prefill-144": (1, 16, 12, 3, 160),
    "gqa-prefill-1000": (1, 16, 12, 3, 1016),
    "gpt2-verify": (8, 5, 12, 12, 1024),
    "gqa-verify": (8, 5, 12, 3, 1024),
    "wide-window": (1, 32, 16, 4, 40),
    "page64-chunk": (1, 64, 12, 3, 192),
    "depth0": (1, 16, 12, 3, 16),
    "tiny-gqa": (S, 3, 4, 2, 86),
}


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_schedule_covers_every_query_row_once(geometry):
    """For each split, the blocks' rows cover every (slot, window
    position, query head) exactly once; a block's rows all read its KV
    head; a row tile holds at most TILE_ROWS rows."""
    b, cur, h, kv, _ = GEOMETRIES[geometry]
    groups = h // kv
    sched = pa.window_schedule(*GEOMETRIES[geometry])
    assert 1 <= sched.row_tile <= pa.TILE_ROWS
    assert sched.grid == (sched.row_tiles * sched.splits, kv, b)
    seen = {split: [] for split in range(sched.splits)}
    for rt, split, kv_head, s in _blocks(sched):
        rows = sched.rows(rt, cur, groups, kv_head)
        assert 1 <= len(rows) <= sched.row_tile
        assert {head // groups for _, head in rows} == {kv_head}
        seen[split] += [(s, j, head) for j, head in rows]
    want = sorted((s, j, head) for s in range(b) for j in range(cur)
                  for head in range(h))
    for rows in seen.values():
        assert sorted(rows) == want


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_every_split_holds_a_key_tile(geometry):
    """At the depth the schedule was given (the last row sees n_keys
    keys), every split of every block folds at least one key tile, and
    the splits of a block share its tiles out once each, in order."""
    b, cur, h, kv, n_keys = GEOMETRIES[geometry]
    sched = pa.window_schedule(b, cur, h, kv, n_keys)
    capacity = -(-n_keys // pa.TILE_KEYS) * pa.TILE_KEYS
    for rt in range(sched.row_tiles):
        n_tiles = _block_tiles(sched, rt, n_keys - cur, cur, h // kv,
                               capacity)
        assert sched.used(n_tiles) == sched.splits
        shares = [sched.key_tiles(n_tiles, split)
                  for split in range(sched.splits)]
        assert all(len(share) >= 1 for share in shares)
        assert [t for share in shares for t in share] == list(range(n_tiles))


@pytest.mark.parametrize("n_tiles", [0, 1, 4, 10, 11, 32])
def test_depths_on_the_card_use_the_splits_they_fill(n_tiles):
    """A verify window's depths stay on the card, so its schedule is cut
    for the table's capacity; a block whose rows see fewer key tiles uses
    one split a tile (at least one split), the others get none, and the
    tiles are shared out once each, in order."""
    sched = pa.window_schedule(8, 5, 12, 12, 1024)
    assert sched.splits == 11
    used = sched.used(n_tiles)
    assert used == max(1, min(11, n_tiles))
    shares = [sched.key_tiles(n_tiles, split) for split in range(11)]
    assert all(shares[split] for split in range(used) if n_tiles)
    assert not any(shares[used:])
    assert [t for share in shares for t in share] == list(range(n_tiles))


# (grid, splits) at the main path's shapes, on an H100's 132 SMs, in
# row tiles of at most 8 rows: a GPT-2 prefill chunk (b 1 x 16 rows x 12
# heads) at depth 144 and 1,000,
# LLaMA-GQA's (12 query heads over 3 KV heads), and the k+1 = 5 verify
# window of 8 slots, whose depths stay on the card (the table's capacity
# of 64 pages x 16 tokens stands in).
MAIN_PATH_BLOCKS = {
    "gpt2-prefill-144": ((1, 16, 12, 12, 160), (10, 12, 1), 5),
    "gpt2-prefill-1000": ((1, 16, 12, 12, 1016), (32, 12, 1), 16),
    "gqa-prefill-144": ((1, 16, 12, 3, 160), (40, 3, 1), 5),
    "gqa-prefill-1000": ((1, 16, 12, 3, 1016), (128, 3, 1), 16),
    "gpt2-verify": ((8, 5, 12, 12, 1024), (11, 12, 8), 11),
    "gqa-verify": ((8, 5, 12, 3, 1024), (42, 3, 8), 14),
}


@pytest.mark.parametrize("shape", list(MAIN_PATH_BLOCKS))
def test_block_counts_at_main_path_shapes(shape):
    args, grid, splits = MAIN_PATH_BLOCKS[shape]
    sched = pa.window_schedule(*args)
    assert (sched.grid, sched.splits) == (grid, splits)
    assert sched.row_tile <= pa.ROW_TILE_ROWS
    assert sched.splits <= pa.MAX_SPLITS
    assert math.prod(grid) <= pa.BLOCKS_PER_SM * pa.H100_SMS


def test_schedule_without_room_to_split():
    """No SM to spare, or one key tile: one split, no merge."""
    assert pa.window_schedule(1, 16, 12, 12, 1016, sms=1).splits == 1
    assert pa.window_schedule(64, 5, 12, 12, 1024).splits == 1
    assert pa.window_schedule(1, 16, 12, 12, 16).splits == 1  # depth 0


def _pool(kind, kv, rng):
    k = rng.standard_normal((LAYERS, P + 1, T, kv, DH), np.float32)
    v = rng.standard_normal((LAYERS, P + 1, T, kv, DH), np.float32)
    if kind == "fp32":
        return k, v
    (k8, ks), (v8, vs) = (_quantize_kv(torch.as_tensor(x)) for x in (k, v))
    return k8.numpy(), v8.numpy(), ks.numpy(), vs.numpy()


def _split_merge(q, pages, table, pos, sched):
    """The window kernel's arithmetic in PyTorch, block by block: each
    split folds its key tiles of the block's rows into (m, l, acc) — over
    int8 pages the key's scale leaves the dot product and its v_scale
    joins the P.V weight — and the partials merge by their maxima."""
    b, cur, h, dh = q.shape
    page_tokens, kv = pages[0].shape[1:3]
    groups = h // kv
    capacity = table.shape[1] * page_tokens
    scale = dh ** -0.5
    int8 = len(pages) == 4
    pos = torch.as_tensor(pos).expand(b)
    out = torch.zeros_like(q)
    for rt, _, kv_head, s in _blocks(sched)[::sched.splits]:
        rows = sched.rows(rt, cur, groups, kv_head)
        p0 = int(pos[s])
        n_tiles = _block_tiles(sched, rt, p0, cur, groups, capacity)
        limit = min(p0 + rows[-1][0], capacity - 1)
        qr = torch.stack([q[s, j, head] for j, head in rows]) * scale
        parts = []
        for split in range(sched.used(n_tiles)):
            keys = [key for t in sched.key_tiles(n_tiles, split)
                    for key in range(t * pa.TILE_KEYS,
                                     (t + 1) * pa.TILE_KEYS)
                    if key <= limit and table[s, key // page_tokens] >= 0]
            if not keys:
                parts.append((torch.full((len(rows),), -1e30),
                              torch.zeros(len(rows)),
                              torch.zeros(len(rows), dh)))
                continue
            page = table[s, [key // page_tokens for key in keys]].long()
            row = torch.tensor([key % page_tokens for key in keys])
            kk = pages[0][page, row, kv_head].float()
            vv = pages[1][page, row, kv_head].float()
            sc = qr @ kk.T
            if int8:
                sc = sc * pages[2][page, row, kv_head]
            seen = (torch.tensor(keys)[None]
                    <= torch.tensor([p0 + j for j, _ in rows])[:, None])
            sc = sc.masked_fill(~seen, -1e30)
            m = sc.max(dim=1).values
            p = torch.where(seen, torch.exp(sc - m[:, None]),
                            torch.zeros(()))
            w = p * pages[3][page, row, kv_head] if int8 else p
            parts.append((m, p.sum(dim=1), w @ vv))
        m_all = torch.stack([m for m, _, _ in parts]).max(dim=0).values
        l_all = torch.zeros(len(rows))
        acc = torch.zeros(len(rows), dh)
        for m, l, a in parts:
            w = torch.exp(m - m_all)
            l_all = l_all + l * w
            acc = acc + a * w[:, None]
        res = acc / torch.clamp(l_all, min=1e-30)[:, None]
        for i, (j, head) in enumerate(rows):
            out[s, j, head] = res[i]
    return out


@pytest.mark.parametrize("sms", [1, pa.H100_SMS])
@pytest.mark.parametrize("traffic", list(TRAFFIC))
@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("kind", ["fp32", "int8"])
def test_split_merge_model_matches_jax_kernel_and_plain(kind, family,
                                                        traffic, sms):
    """The model of K5's split-then-merge over ``window_schedule``'s
    grid (one split at ``sms=1``, three on an H100's 132) against JAX's
    window kernel in interpret mode and the port's ``_einsum_paged``:
    fp32, atol 1e-5."""
    h, kv = FAMILIES[family]
    cur, scalar = TRAFFIC[traffic]
    rng = np.random.default_rng(sum(map(ord, kind + family + traffic)))
    pages = _pool(kind, kv, rng)
    q = rng.standard_normal((S, cur, h, DH), np.float32)
    table = _table()
    pos = np.int32(scalar) if scalar is not None else VECTOR_POS
    layer_pages = tuple(torch.as_tensor(buf[1]) for buf in pages)
    n_keys = int(np.max(pos)) + cur
    sched = pa.window_schedule(S, cur, h, kv, n_keys, sms=sms)
    assert sched.splits == (1 if sms == 1 else 3)
    got = _split_merge(torch.as_tensor(q), layer_pages,
                       torch.as_tensor(table), pos, sched).numpy()
    want_kernel = np.asarray(jax_paged_attention(
        jnp.asarray(q), tuple(jnp.asarray(buf[1]) for buf in pages),
        jnp.asarray(table), jnp.asarray(pos), dtype=jnp.float32,
        impl="kernel", interpret=True))
    want_plain = pa._einsum_paged(torch.as_tensor(q), layer_pages,
                                  torch.as_tensor(table),
                                  torch.as_tensor(pos), dtype=torch.float32,
                                  grouped=True).numpy()
    np.testing.assert_allclose(got, want_kernel, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, want_plain, atol=1e-5, rtol=0)


def test_host_depth_reads_only_depths_the_host_holds():
    """The schedule's key count comes from a depth the host holds for the
    whole batch (the engine's prefill chunk start), which the kernel then
    takes by value; per-slot depths, and any tensor on the card, give
    none (the table's capacity stands in)."""
    assert pa._host_depth(144) == 144
    assert pa._host_depth(np.int32(1010)) == 1010
    assert pa._host_depth(torch.tensor(7)) == 7
    assert pa._host_depth(torch.tensor([3, 40, 7])) is None
    assert pa._host_depth(np.array([3, 40, 7], np.int32)) is None
