"""K4's decomposition (``tpudp_torch.ops.paged_attention.decode_schedule``)
at the tiny geometry of tests/test_torch_window_schedule.py, on the CPU.

The CUDA decode kernel cuts a call into blocks of (row tile, KV head,
slot, key split): each block owns the query heads that read one KV head,
its key lanes fold key tiles of their own into all of those heads (a
lane's warps split the heads), the lanes' partials merge in shared
memory, and the last split of a (row tile, KV head, slot) merges the
splits' partials.  These tests hold the
schedule that the wrapper hands the kernel (every query head covered
once, one KV head a block, a key tile for every used split and key lane,
the block counts of the main path's shapes), and a PyTorch model of the
kernel's fold, lane merge and split merge over that
schedule against JAX's decode kernel in interpret mode and against the
port's plain version, at 1e-5, over fp32 and int8 pools, MHA and grouped
heads, one split and several; and an idle slot (its table row all -1)
against JAX's kernel, which gives it zeros.
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
FAMILIES = {"mha": (4, 4), "gqa": (4, 2), "gqa8": (8, 1)}  # (h, kv)
DECODE_POS = np.array([57, 83, 4], np.int32)


def _table():
    """Slots 0 and 1 share prefix pages 0-3 and diverge into private
    pages; slot 2's pages past its depth are mapped but not visible; -1
    tails sit past every slot's depth.  Every visible entry is mapped, as
    the engine guarantees."""
    table = np.full((S, M), -1, np.int32)
    table[0, :9] = [0, 1, 2, 3, 4, 5, 6, 7, 8]
    table[1, :11] = [0, 1, 2, 3, 9, 10, 11, 12, 13, 14, 15]
    table[2, :9] = np.arange(16, 25)
    return table


def _blocks(sched):
    """Every block of the grid as (row tile, split, KV head, slot), in
    the order the card numbers them: the split in the grid's slowest
    index (z = split * b + slot)."""
    x, kv, z = sched.grid
    b = z // sched.splits
    return [(rt, i // b, h, i % b)
            for i in range(z) for h in range(kv) for rt in range(x)]


def _n_tiles(pos, capacity):
    """Key tiles of a slot at depth ``pos``: keys 0 .. pos, within the
    table."""
    limit = min(pos, capacity - 1)
    return limit // pa.TILE_KEYS + 1 if limit >= 0 else 0


GEOMETRIES = {  # (b, h, kv, n_keys)
    "gpt2": (8, 12, 12, 1024),
    "llama-gqa": (8, 12, 3, 1024),
    "gqa-32-over-8": (8, 32, 8, 1024),
    "groups8": (2, 16, 2, 1024),
    "groups2": (8, 16, 8, 1024),
    "groups3": (4, 12, 4, 1024),
    "groups5": (2, 10, 2, 1024),
    "groups6": (4, 12, 2, 1024),
    "groups16": (1, 16, 1, 2048),
    "gpt2-one-slot": (1, 12, 12, 1024),
    "wide-batch": (64, 12, 12, 1024),
    "mqa12": (1, 12, 1, 2048),
    "dh-any-deep": (1, 4, 4, 4096),
    "one-tile": (4, 8, 4, 32),
    "tiny-gqa": (S, 4, 2, 96),
}


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_schedule_covers_every_query_head_once(geometry):
    """For each split, the blocks' rows cover every (slot, query head)
    exactly once; a block's rows all read its KV head; a row tile holds
    at most ROWS_PER_WARP heads (one warp can fold them all)."""
    b, h, kv, _ = GEOMETRIES[geometry]
    groups = h // kv
    sched = pa.decode_schedule(*GEOMETRIES[geometry])
    assert 1 <= sched.row_tile <= pa.ROWS_PER_WARP
    assert sched.grid == (sched.row_tiles, kv, sched.splits * b)
    assert len(_blocks(sched)) == math.prod(sched.grid)
    seen = {split: [] for split in range(sched.splits)}
    for rt, split, kv_head, s in _blocks(sched):
        heads = sched.rows(rt, groups, kv_head)
        assert 1 <= len(heads) <= sched.row_tile
        assert {head // groups for head in heads} == {kv_head}
        seen[split] += [(s, head) for head in heads]
    want = sorted((s, head) for s in range(b) for head in range(h))
    for rows in seen.values():
        assert sorted(rows) == want


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_every_used_split_and_lane_holds_a_key_tile(geometry):
    """At the depth the schedule was cut for (the last key of the
    table), the splits a slot uses share its tiles out once each, in
    order, every one of them at least one tile; the key lanes of a split
    share its tiles once each, every lane but those of a share shorter
    than the block has one; a lane has the largest of 1, 2 and 4 warps
    within the row tile, and a block as many lanes as fit in
    DECODE_BLOCK_WARPS warps, up to DECODE_KEY_LANES, as the kernel
    derives them."""
    b, h, kv, n_keys = GEOMETRIES[geometry]
    sched = pa.decode_schedule(b, h, kv, n_keys)
    n_tiles = _n_tiles(n_keys - 1, n_keys)
    used = sched.used(n_tiles)
    shares = [sched.key_tiles(n_tiles, split)
              for split in range(sched.splits)]
    assert all(len(share) >= 1 for share in shares[:used])
    assert not any(shares[used:])
    assert [t for share in shares for t in share] == list(range(n_tiles))
    lanes = sched.lanes
    assert sched.row_warps in (1, 2, 4)
    assert sched.row_warps <= sched.row_tile < 2 * sched.row_warps
    assert lanes == {1: 4, 2: 4, 4: 2}[sched.row_warps]
    assert sched.warps == lanes * sched.row_warps <= pa.DECODE_BLOCK_WARPS
    for split, share in enumerate(shares[:used]):
        tiles = [sched.lane_tiles(n_tiles, split, g) for g in range(lanes)]
        assert sorted(t for ts in tiles for t in ts) == list(share)
        assert sum(map(bool, tiles)) == min(lanes, len(share))


@pytest.mark.parametrize("n_tiles", [0, 1, 4, 5, 10, 11, 32])
def test_depths_on_the_card_use_the_splits_they_fill(n_tiles):
    """A decode step's depths stay on the card, so its schedule is cut
    for the table's capacity; a slot whose keys fill fewer key tiles uses
    one split per key lanes' worth of tiles (at least one split), the
    others get none, and the tiles are shared out once each, in order."""
    sched = pa.decode_schedule(8, 12, 12, 1024)
    assert (sched.lanes, sched.warps, sched.splits) == (4, 4, 8)
    used = sched.used(n_tiles)
    assert used == max(1, min(8, -(-n_tiles // 4)))
    shares = [sched.key_tiles(n_tiles, split) for split in range(8)]
    assert all(shares[split] for split in range(used) if n_tiles)
    assert not any(shares[used:])
    assert [t for share in shares for t in share] == list(range(n_tiles))


# (grid, splits, warps x warps a key lane) at the main path's shapes, on
# an H100's 132 SMs: GPT-2 small's decode step (8 slots x 12 heads: four
# key lanes of one warp), LLaMA-GQA's (12 query heads over 3 KV heads:
# two lanes of four warps, one a head) and phase 3's grouped shape (32
# over 8), all over a table of 64 pages x 16 tokens, whose capacity
# stands in for the depths that stay on the card; then two heads a KV
# head (four lanes of two warps), and 8 heads a KV head (two row tiles).
MAIN_PATH_BLOCKS = {
    "gpt2": ((8, 12, 12, 1024), (1, 12, 64), 8, (4, 1)),
    "llama-gqa": ((8, 12, 3, 1024), (1, 3, 64), 8, (8, 4)),
    "gqa-32-over-8": ((8, 32, 8, 1024), (1, 8, 64), 8, (8, 4)),
    "groups2": ((8, 16, 8, 1024), (1, 8, 64), 8, (8, 2)),
    "groups8": ((2, 16, 2, 1024), (2, 2, 16), 8, (8, 4)),
}


@pytest.mark.parametrize("shape", list(MAIN_PATH_BLOCKS))
def test_block_counts_at_main_path_shapes(shape):
    args, grid, splits, warps = MAIN_PATH_BLOCKS[shape]
    sched = pa.decode_schedule(*args)
    assert (sched.grid, sched.splits) == (grid, splits)
    assert (sched.warps, sched.row_warps) == warps
    assert math.prod(grid) <= pa.BLOCKS_PER_SM * pa.H100_SMS


def test_schedule_without_room_to_split():
    """No SM to spare, or no more key tiles than warps: one split, no
    merge."""
    assert pa.decode_schedule(8, 12, 12, 1024, sms=1).splits == 1
    assert pa.decode_schedule(128, 12, 12, 1024).splits == 1
    assert pa.decode_schedule(8, 12, 12, 4 * pa.TILE_KEYS).splits == 1
    assert pa.decode_schedule(8, 12, 3, 2 * pa.TILE_KEYS).splits == 1
    assert pa.decode_schedule(8, 12, 12, pa.TILE_KEYS).splits == 1


def test_splits_stop_at_the_cap_and_the_card():
    """A deep table splits up to DECODE_MAX_SPLITS ways; a wide batch
    only as far as BLOCKS_PER_SM blocks a SM allow."""
    assert (pa.decode_schedule(8, 12, 12, 8192).splits
            == pa.DECODE_MAX_SPLITS)
    sched = pa.decode_schedule(32, 12, 12, 1024)
    assert sched.splits == pa.BLOCKS_PER_SM * pa.H100_SMS // (32 * 12) == 2


def _pool(kind, kv, rng):
    k = rng.standard_normal((LAYERS, P + 1, T, kv, DH), np.float32)
    v = rng.standard_normal((LAYERS, P + 1, T, kv, DH), np.float32)
    if kind == "fp32":
        return k, v
    (k8, ks), (v8, vs) = (_quantize_kv(torch.as_tensor(x)) for x in (k, v))
    return k8.numpy(), v8.numpy(), ks.numpy(), vs.numpy()


def _fold(state, qr, pages, table_row, kv_head, tile, limit, page_tokens):
    """Fold key tile ``tile`` into one warp's ``(m, l, acc)`` of the rows
    ``qr`` (pre-scaled), as the kernel does: keys past ``limit`` or on
    unmapped pages get no weight; over int8 pages the key's scale leaves
    the dot product and its v_scale joins the P.V weight."""
    m, l, acc = state
    keys = [key for key in range(tile * pa.TILE_KEYS,
                                 (tile + 1) * pa.TILE_KEYS)
            if key <= limit and table_row[key // page_tokens] >= 0]
    if not keys:
        return state
    page = table_row[[key // page_tokens for key in keys]].long()
    row = torch.tensor([key % page_tokens for key in keys])
    sc = qr @ pages[0][page, row, kv_head].float().T
    if len(pages) == 4:
        sc = sc * pages[2][page, row, kv_head]
    m_new = torch.maximum(m, sc.max(dim=1).values)
    alpha = torch.exp(m - m_new)
    p = torch.exp(sc - m_new[:, None])
    l = l * alpha + p.sum(dim=1)
    if len(pages) == 4:
        p = p * pages[3][page, row, kv_head]
    acc = acc * alpha[:, None] + p @ pages[1][page, row, kv_head].float()
    return m_new, l, acc


def _merge(parts):
    """Partials ``(m, l, acc)`` merged by their maxima, in order."""
    m_all = torch.stack([m for m, _, _ in parts]).max(dim=0).values
    l_all = sum(l * torch.exp(m - m_all) for m, l, _ in parts)
    acc = sum(a * torch.exp(m - m_all)[:, None] for m, _, a in parts)
    return m_all, l_all, acc


def _split_merge(q, pages, table, pos, sched):
    """The decode kernel's arithmetic in PyTorch, block by block: each
    key lane folds its key tiles (every lanes-th tile of the split's
    share) into (m, l, acc) for every head of the block, the lanes'
    partials merge, then the splits' partials merge."""
    b, _, h, dh = q.shape
    page_tokens, kv = pages[0].shape[1:3]
    groups = h // kv
    capacity = table.shape[1] * page_tokens
    scale = dh ** -0.5
    out = torch.zeros_like(q)
    for rt, _, kv_head, s in {(rt, 0, kv_head, s)
                              for rt, _, kv_head, s in _blocks(sched)}:
        heads = sched.rows(rt, groups, kv_head)
        limit = min(int(pos[s]), capacity - 1)
        n_tiles = _n_tiles(int(pos[s]), capacity)
        qr = q[s, 0, heads] * scale
        empty = (torch.full((len(heads),), -1e30), torch.zeros(len(heads)),
                 torch.zeros(len(heads), dh))
        parts = []
        for split in range(sched.used(n_tiles)):
            lanes = []
            for g in range(sched.lanes):
                state = empty
                for tile in sched.lane_tiles(n_tiles, split, g):
                    state = _fold(state, qr, pages, table[s], kv_head, tile,
                                  limit, page_tokens)
                lanes.append(state)
            parts.append(_merge(lanes))
        _, l_all, acc = _merge(parts)
        out[s, 0, heads] = acc / torch.clamp(l_all, min=1e-30)[:, None]
    return out


def _jax_kernel(q, pages, table, pos):
    return np.asarray(jax_paged_attention(
        jnp.asarray(q), tuple(jnp.asarray(buf[1]) for buf in pages),
        jnp.asarray(table), jnp.asarray(pos), dtype=jnp.float32,
        impl="kernel", interpret=True))


# (key lanes a block, SMs, most splits): one split of one lane walking
# every tile, three splits of one tile, two splits of one and two tiles
# (one lane each, the second walking two tiles), two splits of one and
# two tiles over two lanes, and the kernel's own lanes (four, the fourth
# idle, in one split; two lanes of four warps at 8 heads a KV head: two
# splits).  The kernel derives its lanes from the row tile; the model
# takes others too, to hold the lane and split merges at more shapes.
SPLITS = {"lanes1-sms1": (1, 1, 8), "lanes1": (1, 132, 8),
          "lanes2": (2, 132, 8), "lanes4": (None, 132, 8),
          "lanes1-splits2": (1, 132, 2)}


@pytest.mark.parametrize("split", list(SPLITS))
@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("kind", ["fp32", "int8"])
def test_split_merge_model_matches_jax_kernel_and_plain(monkeypatch, kind,
                                                        family, split):
    """The model of K4's fold, lane merge and split merge over
    ``decode_schedule``'s grid against JAX's decode kernel in interpret
    mode and the port's ``_einsum_paged``: fp32, atol 1e-5."""
    lanes, sms, max_splits = SPLITS[split]
    monkeypatch.setattr(pa, "DECODE_MAX_SPLITS", max_splits)
    h, kv = FAMILIES[family]
    rng = np.random.default_rng(sum(map(ord, kind + family + split)))
    pages = _pool(kind, kv, rng)
    q = rng.standard_normal((S, 1, h, DH), np.float32)
    table = _table()
    sched = pa.decode_schedule(S, h, kv, M * T, sms=sms)
    if lanes is not None:  # the schedule's splits, cut for `lanes` lanes
        room = pa.BLOCKS_PER_SM * sms // (S * kv * sched.row_tiles)
        splits = max(1, min(-(-3 // lanes), max_splits, room))
        sched = sched._replace(lanes=lanes, splits=splits,
                               grid=(sched.row_tiles, kv, splits * S))
    # one split a key lane's worth of the three tiles, within the cap, or
    # no room
    assert sched.splits == (1 if sms == 1 else
                            min(-(-3 // sched.lanes), max_splits))
    layer_pages = tuple(torch.as_tensor(buf[1]) for buf in pages)
    got = _split_merge(torch.as_tensor(q), layer_pages,
                       torch.as_tensor(table), DECODE_POS, sched).numpy()
    want_plain = pa._einsum_paged(torch.as_tensor(q), layer_pages,
                                  torch.as_tensor(table),
                                  torch.as_tensor(DECODE_POS),
                                  dtype=torch.float32, grouped=True).numpy()
    np.testing.assert_allclose(got, _jax_kernel(q, pages, table, DECODE_POS),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, want_plain, atol=1e-5, rtol=0)


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("kind", ["fp32", "int8"])
def test_idle_slot_gets_zeros_like_jax_kernel(kind, family):
    """A slot whose table row is all -1 (an idle slot) attends nothing:
    the model gives it zeros, as JAX's decode kernel does (l = 0, acc = 0
    -> 0 / 1e-30), and the other slots as before."""
    h, kv = FAMILIES[family]
    rng = np.random.default_rng(11)
    pages = _pool(kind, kv, rng)
    q = rng.standard_normal((S, 1, h, DH), np.float32)
    table = _table()
    table[1] = -1
    sched = pa.decode_schedule(S, h, kv, M * T)
    layer_pages = tuple(torch.as_tensor(buf[1]) for buf in pages)
    got = _split_merge(torch.as_tensor(q), layer_pages,
                       torch.as_tensor(table), DECODE_POS, sched).numpy()
    want = _jax_kernel(q, pages, table, DECODE_POS)
    assert not want[1].any() and not got[1].any()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
