"""Paged attention — queries attend K/V read through a per-slot block
table, one layer at a time; the port of ``tpudp/ops/paged_attention.py``.

Two backends behind :func:`paged_attention`, with the JAX op's layouts:

  * ``impl='einsum'`` — :func:`_einsum_paged`, the plain PyTorch version:
    per-page tiles ``pool[table]`` feed the contraction, the flattened
    ``(pages * page_tokens)`` key axis gets the dense path's visibility
    mask, float32 softmax, and the P.V product.
  * ``impl='kernel'`` — the hand-written CUDA kernels
    (``tpudp_torch/csrc``): a one-token window at per-slot depths goes to
    :func:`paged_decode` (K4, its grid from :func:`decode_schedule`),
    everything else — a prefill chunk at a shared scalar depth, a
    multi-token window at per-slot depths — to :func:`paged_window` (K5,
    its grid from :func:`window_schedule`);
    over an int8 pool to their int8 variants :func:`paged_decode_int8`
    and :func:`paged_window_int8`.  All compute in float32 and are
    bounded by a tolerance against the plain version, as the Pallas
    kernels are.

Tree verify has its own op, :func:`tree_paged_attention`: node queries
attend the committed cache through the table (strict ``< pos0``) and
the in-flight window K/V under the ancestor-or-self mask in one softmax,
through :func:`paged_tree` (K6) and its plain version
:func:`_tree_plain`.

A kernel wrapper given CUDA tensors launches its kernel or raises; given
CPU tensors it runs the plain version, which is what the CPU tests see.
Each wrapper counts its launches in ``.launches`` so a run can show that
its main path went through the kernel.

Pages are ``(k, v)``, each ``(P + 1, T, kv, dh)`` per layer, the
trailing page being the write scratch, or the int8 quadruple ``(k, v,
k_scale, v_scale)``: int8 payloads with float32 ``(P + 1, T, kv)``
per-vector scales, read as ``int8 * scale``.  Whole-pool mode passes
``(L, P + 1, T, ...)`` buffers plus ``layer``, and the kernels index that
layer through strides.  ``table`` is ``(b, M)`` with ``-1`` for unmapped
entries; ``pos`` is ``(b,)`` (row ``j`` of slot ``s`` sees keys ``<=
pos[s] + j``) or a scalar shared by the batch (the prefill window).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from tpudp_torch.ops import _build

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIMS = (32, 64, 128)
#: The most tree nodes K6 takes: one 32-bit ancestor mask a node row.
TREE_KERNEL_MAX_NODES = 32
#: Query rows and keys a block of K5 or K6 folds together
#: (``csrc/paged_common.cuh`` ``kTileRows``, ``kTileKeys``).
TILE_ROWS = TILE_KEYS = 32
#: Streaming multiprocessors of an H100 SXM: the default card of
#: :func:`window_schedule`.
H100_SMS = 132


class WindowSchedule(NamedTuple):
    """How K5 cuts one call.  Block ``(rt * splits + split, kv_head,
    slot)`` folds row tile ``rt`` (:meth:`rows`) of the ``cur * groups``
    rows reading ``kv_head`` against its share of their key tiles
    (:meth:`key_tiles`).  Of a (row tile, KV head, slot)'s ``splits``
    blocks, the first :meth:`used` share the key tiles its rows see, and
    the last of those to finish merges their partials; the others exit
    at once."""

    row_tile: int   # query rows a block, at most TILE_ROWS
    row_tiles: int  # row tiles a (KV head, slot)
    splits: int     # blocks launched for one row tile's keys
    grid: tuple     # (row_tiles * splits, kv, b)

    def rows(self, rt: int, cur: int, groups: int, kv_head: int):
        """``(window position, query head)`` of row tile ``rt``'s rows:
        flattened row ``r`` is position ``r // groups`` at query head
        ``kv_head * groups + r % groups``."""
        end = min((rt + 1) * self.row_tile, cur * groups)
        return [(r // groups, kv_head * groups + r % groups)
                for r in range(rt * self.row_tile, end)]

    def used(self, n_tiles: int) -> int:
        """The splits that fold a block's ``n_tiles`` key tiles (keys
        ``0 ..`` the visibility edge of its last row): one a tile, up to
        ``splits``."""
        return max(1, min(self.splits, n_tiles))

    def key_tiles(self, n_tiles: int, split: int) -> range:
        """The key tiles split ``split`` folds of a block's ``n_tiles``:
        an even share, in order (none past :meth:`used`)."""
        used = self.used(n_tiles)
        if split >= used:
            return range(0)
        return range(split * n_tiles // used, (split + 1) * n_tiles // used)


#: The most query rows of a K5 block (the kernel takes up to TILE_ROWS:
#: fewer rows a block give more blocks, each with a shorter fold), the
#: most key splits K5 launches for a row tile, and the most blocks a SM
#: the splits may bring a call to (PERF.md §6, PR 7: the sweep,
#: ``chip_window_sweep.py``, that chose them).
ROW_TILE_ROWS = 8
MAX_SPLITS = 16
BLOCKS_PER_SM = 8


def window_schedule(b: int, cur: int, h: int, kv: int, n_keys: int,
                    sms: int = H100_SMS) -> WindowSchedule:
    """K5's grid for ``b`` slots of ``cur`` query rows at ``h`` query
    heads over ``kv`` KV heads, whose last row sees at most ``n_keys``
    keys (the table's capacity where the depths stay on the card).

    The ``cur * h / kv`` rows reading one KV head are cut into the fewest
    row tiles of at most :data:`ROW_TILE_ROWS`, of even width.  A prefill
    chunk is one slot, so its (row tile, KV head, slot) blocks are few,
    and a block walks its key tiles in order: so the key range is split
    across up to :data:`MAX_SPLITS` blocks, one a key tile of the block
    that sees the fewest keys (the first row tile), within
    :data:`BLOCKS_PER_SM` blocks a SM of the card's ``sms``.  The kernel
    shares the key tiles a block really sees among as many of its splits
    as there are tiles."""
    groups = h // kv
    n_rows = cur * groups
    row_tiles = -(-n_rows // ROW_TILE_ROWS)
    row_tile = -(-n_rows // row_tiles)
    blocks = b * kv * row_tiles
    first_keys = n_keys - cur + min(cur, (row_tile - 1) // groups + 1)
    key_tiles = max(1, -(-first_keys // TILE_KEYS))
    splits = max(1, min(key_tiles, MAX_SPLITS, BLOCKS_PER_SM * sms // blocks))
    return WindowSchedule(row_tile, row_tiles, splits,
                          (row_tiles * splits, kv, b))


#: The query rows one warp of a K4 block folds (``csrc/paged_common.cuh``
#: ``kRowsPerWarp``): a K4 block's row tile.
ROWS_PER_WARP = 4
#: The warps a K4 block fits its key lanes in and the most key lanes it
#: has (``csrc/paged_decode.cu`` ``kDecodeLanes``), and the most key
#: splits it launches for a (row tile, KV head, slot) (PERF.md §6: the
#: sweep, ``chip_window_sweep.py sweep``, that chose them).
DECODE_BLOCK_WARPS, DECODE_KEY_LANES = 8, 4
DECODE_MAX_SPLITS = 8


class DecodeSchedule(NamedTuple):
    """How K4 cuts one call.  Block ``(rt, kv_head, split * b + slot)``
    folds row tile ``rt`` (:meth:`rows`) of the ``groups`` query heads
    reading ``kv_head`` against its share of the slot's key tiles
    (:meth:`key_tiles`).  Of a (row tile, KV head, slot)'s ``splits``
    blocks, the first :meth:`used` share the tiles the slot sees, and the
    last of those to finish merges their partials; the others exit at
    once.  A block's warps form ``lanes`` key lanes of ``row_warps`` warps
    that fold their tiles side by side (:meth:`lane_tiles`), a lane's
    warp ``j`` folding the row tile's heads ``j, j + row_warps, ...``, and
    the lanes merge in shared memory."""

    row_warps: int  # warps a key lane, sharing its tiles
    lanes: int      # key lanes a block
    row_tile: int   # query heads a block
    row_tiles: int  # row tiles a (KV head, slot)
    splits: int     # blocks launched for one row tile's keys
    grid: tuple     # (row_tiles, kv, splits * b)

    @property
    def warps(self) -> int:
        """Warps a block."""
        return self.lanes * self.row_warps

    def rows(self, rt: int, groups: int, kv_head: int):
        """The query heads of row tile ``rt`` of ``kv_head``'s
        ``groups``."""
        end = min((rt + 1) * self.row_tile, groups)
        return [kv_head * groups + r
                for r in range(rt * self.row_tile, end)]

    def used(self, n_tiles: int) -> int:
        """The splits that fold a slot's ``n_tiles`` key tiles: one per
        ``lanes`` tiles, at least one, up to ``splits``."""
        return max(1, min(self.splits, -(-n_tiles // self.lanes)))

    def key_tiles(self, n_tiles: int, split: int) -> range:
        """The key tiles split ``split`` folds of a slot's ``n_tiles``:
        an even share, in order (none past :meth:`used`)."""
        used = self.used(n_tiles)
        if split >= used:
            return range(0)
        return range(split * n_tiles // used, (split + 1) * n_tiles // used)

    def lane_tiles(self, n_tiles: int, split: int, lane: int) -> range:
        """The key tiles key lane ``lane`` of split ``split`` folds:
        every ``lanes``-th of the split's share, from its ``lane``-th."""
        return self.key_tiles(n_tiles, split)[lane::self.lanes]


def decode_schedule(b: int, h: int, kv: int, n_keys: int,
                    sms: int = H100_SMS) -> DecodeSchedule:
    """K4's grid for ``b`` slots of one query row at ``h`` query heads
    over ``kv`` KV heads, whose rows see at most ``n_keys`` keys (the
    table's capacity: the depths stay on the card).

    The ``h / kv`` query heads reading one KV head are cut into the
    fewest row tiles of at most :data:`ROWS_PER_WARP`, of even width; a
    key lane has the largest of 1, 2 and 4 warps within the row tile, and
    a block as many key lanes as fit in :data:`DECODE_BLOCK_WARPS` warps,
    up to :data:`DECODE_KEY_LANES`, as the kernel derives them; the key
    range is split across up to :data:`DECODE_MAX_SPLITS` blocks, one
    per key lanes' worth of key tiles, within :data:`BLOCKS_PER_SM`
    blocks a SM of the card's ``sms``."""
    groups = h // kv
    row_tiles = -(-groups // ROWS_PER_WARP)
    row_tile = -(-groups // row_tiles)
    row_warps = 1 << (row_tile.bit_length() - 1)
    lanes = min(DECODE_KEY_LANES, DECODE_BLOCK_WARPS // row_warps)
    blocks = b * kv * row_tiles
    key_tiles = max(1, -(-n_keys // TILE_KEYS))
    splits = max(1, min(-(-key_tiles // lanes), DECODE_MAX_SPLITS,
                        BLOCKS_PER_SM * sms // blocks))
    return DecodeSchedule(row_warps, lanes, row_tile, row_tiles, splits,
                          (row_tiles, kv, splits * b))


def page_tiles(pages, table, dtype):
    """Per-slot ``(b, M, T, kv, dh)`` K/V tiles indexed by the block
    table; int8 pages dequantize as ``(int8.float() * scale).to(dtype)``,
    the JAX package's math.  Unmapped entries (``-1``) read the trailing
    scratch page, whose contents only ever land where the visibility mask
    excludes them."""
    scratch = pages[0].shape[0] - 1
    tbl = torch.where(table >= 0, table, scratch).long()
    if len(pages) == 4:
        k8, v8, ks, vs = pages
        return ((k8[tbl].float() * ks[tbl][..., None]).to(dtype),
                (v8[tbl].float() * vs[tbl][..., None]).to(dtype))
    k, v = pages
    return k[tbl].to(dtype), v[tbl].to(dtype)


def _einsum_paged(q, pages, table, pos, *, dtype, grouped):
    """The plain version.  ``q``: ``(b, cur, h, dh)``; ``pos``: ``(b,)``
    per-slot depths or a scalar.  Window row ``j`` attends keys
    ``<= pos + j``; ``grouped`` selects the GQA einsum family (query
    head ``j`` reads KV head ``j // groups``) over GPT-2's MHA family."""
    b, cur, h, dh = q.shape
    table = torch.as_tensor(table, device=q.device)
    kt, vt = page_tiles(pages, table, dtype)  # (b, M, T, kv, dh)
    n_pages, page_tokens, kv = kt.shape[1:4]
    max_len = n_pages * page_tokens
    scale = dh ** -0.5
    pos = torch.as_tensor(pos, device=q.device)
    rows = torch.arange(cur, device=q.device)
    q_pos = (pos[:, None] if pos.dim() else pos) + rows
    q_pos = q_pos.expand(b, cur)
    visible = (torch.arange(max_len, device=q.device)
               <= q_pos[..., None])  # (b, cur, max_len)
    if grouped:
        g = h // kv
        qg = q.reshape(b, cur, kv, g, dh)
        lg = (torch.einsum("bqkgd,bptkd->bkgqpt", qg, kt)
              * scale).reshape(b, kv, g, cur, max_len)
        lg = lg.masked_fill(~visible[:, None, None],
                            torch.finfo(lg.dtype).min)
        pr = torch.softmax(lg.float(), dim=-1).to(dtype)
        out = torch.einsum("bkgqpt,bptkd->bqkgd",
                           pr.reshape(b, kv, g, cur, n_pages, page_tokens),
                           vt)
        return out.reshape(b, cur, h, dh)
    lg = (torch.einsum("bqhd,bpthd->bhqpt", q, kt)
          * scale).reshape(b, h, cur, max_len)
    lg = lg.masked_fill(~visible[:, None], torch.finfo(lg.dtype).min)
    pr = torch.softmax(lg.float(), dim=-1).to(dtype)
    return torch.einsum("bhqpt,bpthd->bqhd",
                        pr.reshape(b, h, cur, n_pages, page_tokens), vt)


def _plain(q, pages, table, pos, layer):
    """A kernel's plain version on the CPU: the GQA einsum family, which
    covers MHA as one head per group."""
    if layer is not None:
        pages = tuple(buf[layer] for buf in pages)
    return _einsum_paged(q, pages, table, pos, dtype=q.dtype, grouped=True)


def _host_depth(pos) -> int | None:
    """``pos`` as an int where it is one depth the host holds for the
    whole batch (the engine's prefill passes its chunk start), else
    ``None``; a tensor on the card is never read back."""
    if isinstance(pos, int):
        return pos
    if isinstance(pos, torch.Tensor) and pos.is_cuda:
        return None
    pos = torch.as_tensor(pos)
    return int(pos) if pos.dim() == 0 else None


def _launch_args(q, pages, table, pos, layer, *, by_value=False):
    """Validate one kernel call and return ``(out, table32, pos32, depth,
    ints, strides, scale_strides)``: the output buffer, the int32 index
    tensors the kernel reads, :func:`_host_depth`, the geometry, the
    element strides and, for an int8 pool, the scale pool's layer offset
    and page/token/head strides (``()`` for fp pages).  With
    ``by_value``, a host depth gives ``pos32 = None``: the caller passes
    ``depth`` to the kernel as an argument."""
    k_pages, v_pages = pages[:2]
    int8 = len(pages) == 4
    if not (q.is_cuda and all(buf.device == q.device for buf in pages)):
        raise ValueError("paged kernels need q and the pages on one CUDA "
                         "device")
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"paged kernels take float32 or bfloat16, got "
                        f"{q.dtype}")
    page_dtype = torch.int8 if int8 else q.dtype
    if k_pages.dtype != page_dtype or v_pages.dtype != page_dtype:
        raise TypeError(f"page dtype ({k_pages.dtype}/{v_pages.dtype}) "
                        f"must be {page_dtype} for {q.dtype} queries"
                        f"{' over an int8 pool' if int8 else ''}")
    if k_pages.shape != v_pages.shape:
        raise ValueError("k and v pages differ in shape")
    whole = layer is not None
    if k_pages.dim() != 4 + whole:
        raise ValueError(f"pages must be {'(L, ' if whole else '('}P+1, T, "
                         f"kv, dh), got {tuple(k_pages.shape)}")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("paged kernels read contiguous page pools")
    scale_strides = ()
    if int8:
        k_scale, v_scale = pages[2:]
        for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
            if sc.dtype != torch.float32 or sc.shape != k_pages.shape[:-1]:
                raise TypeError(f"{name} must be float32 of shape "
                                f"{tuple(k_pages.shape[:-1])}, got {sc.dtype}"
                                f" {tuple(sc.shape)}")
            if not sc.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        scale_strides = ((layer * k_scale.stride(0) if whole else 0),
                         *k_scale.stride()[-3:])
    b, cur, h, dh = q.shape
    page_tokens, kv, pdh = k_pages.shape[-3:]
    if pdh != dh or dh not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {dh} (pages {pdh}): the kernels take "
                         f"{_KERNEL_HEAD_DIMS}")
    if h % kv:
        raise ValueError(f"{h} query heads do not group over {kv} KV heads")
    if q.stride(-1) != 1:
        raise ValueError("q's head dim must be contiguous")
    if whole and not 0 <= layer < k_pages.shape[0]:
        raise IndexError(f"layer {layer} outside a pool of "
                         f"{k_pages.shape[0]} layers")
    table = torch.as_tensor(table).to(q.device, torch.int32).contiguous()
    if table.dim() != 2 or table.shape[0] != b:
        raise ValueError(f"table must be ({b}, M), got {tuple(table.shape)}")
    depth = _host_depth(pos)
    if depth is not None:
        # Filled in on the card or passed by value: a copy from pageable
        # host memory would wait for the stream to drain.
        pos = None if by_value else torch.full(
            (b,), depth, dtype=torch.int32, device=q.device)
    else:
        pos = torch.as_tensor(pos).to(q.device, torch.int32)
        pos = pos.expand(b).contiguous()
    out = torch.empty((b, cur, h, dh), dtype=q.dtype, device=q.device)
    offset = layer * k_pages.stride(0) if whole else 0
    ps, ts, hs = k_pages.stride()[-4:-1]
    ints = (_KERNEL_DTYPES[q.dtype], b, cur, h, kv, dh, table.shape[1],
            page_tokens)
    strides = (q.stride(0), q.stride(1), q.stride(2), offset, ps, ts, hs)
    return out, table, pos, depth, ints, strides, scale_strides


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


_merge_buffers: dict = {}  # by (device, dtype): K4's and K5's split merge


def _merge_buffer(device, dtype, n: int) -> torch.Tensor:
    """At least ``n`` elements of ``dtype`` on ``device`` for K4's and K5's
    key-split merge, made once and kept (grown when a call needs more):
    int32 merge tickets, all 0 between launches, since the block that
    merges a (row tile, KV head, slot) resets its ticket to 0; and the
    float32 scratch of the splits' partials, which a launch writes before
    it reads.  Launches on the device's stream run one after another, so
    each finds the tickets zeroed and the scratch its own."""
    buf = _merge_buffers.get((device, dtype))
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=dtype, device=device)
        _merge_buffers[device, dtype] = buf
    return buf


def _launch(name, q, pages, table, pos, layer):
    """Launch K4 (on :func:`decode_schedule`'s grid; ``cur == 1`` kernels
    take no row count, row stride or host depth) or K5 (on
    :func:`window_schedule`'s, a host depth by value), fp or int8, with
    the key split's scratch and tickets (:func:`_merge_buffer`), on
    validated arguments; count the launch."""
    window = not name.startswith("paged_decode")
    out, table32, pos32, depth, ints, strides, scale_strides = _launch_args(
        q, pages, table, pos, layer, by_value=window)
    _, b, cur, h, kv, _, max_pages, page_tokens = ints
    # Keys the last row sees: from a host depth, else the capacity.
    n_keys = max_pages * page_tokens
    if window:
        if depth is not None:
            n_keys = min(depth + cur, n_keys)
        sched = window_schedule(b, cur, h, kv, n_keys, _sm_count(q.device))
        sched_ints = (sched.row_tile, sched.splits,
                      0 if depth is None else depth)
    else:
        sched = decode_schedule(b, h, kv, n_keys, _sm_count(q.device))
        sched_ints = (sched.row_tile, sched.splits)
        ints = ints[:2] + ints[3:]          # no window length
        strides = strides[:1] + strides[2:]  # no row stride
    part = tickets = None
    if sched.splits > 1:  # (splits, b, cur, h) partial acc, then m, l
        rows = sched.splits * out.numel() // out.shape[-1]
        part = _merge_buffer(q.device, torch.float32,
                             rows * (out.shape[-1] + 2))
        tickets = _merge_buffer(q.device, torch.int32,
                                b * kv * sched.row_tiles)
    ptrs = (part, tickets)
    ints += sched_ints
    code = _build.launcher(name)(
        q.data_ptr(), *(buf.data_ptr() for buf in pages), table32.data_ptr(),
        None if pos32 is None else pos32.data_ptr(), out.data_ptr(),
        *(None if t is None else t.data_ptr() for t in ptrs), *ints,
        *strides, *scale_strides, q.shape[-1] ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(name, code)
    KERNELS[name].launches += 1
    return out


def paged_decode(q, k_pages, v_pages, table, pos, *, layer=None):
    """K4: one-token paged decode.  ``q`` ``(b, 1, h, dh)``; ``pos``
    ``(b,)``.  Launches ``csrc/paged_decode.cu`` on CUDA tensors, once,
    on the grid :func:`decode_schedule` picks for the table's capacity
    (the count goes up by one); runs the plain version on CPU tensors."""
    if q.shape[1] != 1:
        raise ValueError("the paged-decode kernel is a one-token kernel")
    if not q.is_cuda:
        return _plain(q, (k_pages, v_pages), table, pos, layer)
    return _launch("paged_decode", q, (k_pages, v_pages), table, pos, layer)


def paged_window(q, k_pages, v_pages, table, pos, *, layer=None):
    """K5: multi-token paged window.  ``q`` ``(b, cur, h, dh)``; ``pos``
    ``(b,)`` or a scalar (broadcast over the batch).  Launches
    ``csrc/paged_window.cu`` on CUDA tensors, once, on the grid
    :func:`window_schedule` picks (the count goes up by one); a depth
    the host holds, such as the engine's prefill chunk start, goes to
    the kernel by value and sizes the key split.  Runs the plain version
    on CPU tensors."""
    if not q.is_cuda:
        return _plain(q, (k_pages, v_pages), table, pos, layer)
    return _launch("paged_window", q, (k_pages, v_pages), table, pos, layer)


def paged_decode_int8(q, k_pages, v_pages, k_scale, v_scale, table, pos, *,
                      layer=None):
    """K4's int8 variant: :func:`paged_decode` over int8 pages with
    float32 per-vector scales; ``q`` float32 or bf16.  Launches
    ``launch_paged_decode_int8`` of ``csrc/paged_decode.cu`` on CUDA
    tensors (the count goes up by one), runs the plain version —
    dequantize, then the einsum — on CPU tensors."""
    if q.shape[1] != 1:
        raise ValueError("the paged-decode kernel is a one-token kernel")
    pages = (k_pages, v_pages, k_scale, v_scale)
    if not q.is_cuda:
        return _plain(q, pages, table, pos, layer)
    return _launch("paged_decode_int8", q, pages, table, pos, layer)


def paged_window_int8(q, k_pages, v_pages, k_scale, v_scale, table, pos, *,
                      layer=None):
    """K5's int8 variant: :func:`paged_window` over int8 pages with
    float32 per-vector scales.  Launches ``launch_paged_window_int8`` of
    ``csrc/paged_window.cu`` on CUDA tensors (the count goes up by one),
    runs the plain version on CPU tensors."""
    pages = (k_pages, v_pages, k_scale, v_scale)
    if not q.is_cuda:
        return _plain(q, pages, table, pos, layer)
    return _launch("paged_window_int8", q, pages, table, pos, layer)


def tree_attention(q, k_cache, v_cache, pos0, wk, wv, anc, *, dtype):
    """Tree attention over dense cache rows plus an in-flight node
    window, the plain math of the tree-verify forward.  ``q`` ``(b, T+1,
    h, dh)``; ``k_cache``/``v_cache`` ``(b, n_keys, kv, dh)``; ``wk``/
    ``wv`` ``(b, T+1, kv, dh)``; ``anc`` the ``(T+1, T+1)``
    ancestor-or-self mask.  Node ``j`` of slot ``s`` sees cache keys at
    positions ``< pos0[s]`` (strict: node 0's own K/V are in the window,
    not the cache) and window node ``c`` where ``anc[j][c]``, under one
    float32 softmax; query head ``i`` reads KV head ``i // groups``."""
    b, t1, h, dh = q.shape
    kv = wk.shape[2]
    n_keys = k_cache.shape[1]
    kk = torch.cat([k_cache.to(dtype), wk.to(dtype)], dim=1)
    vv = torch.cat([v_cache.to(dtype), wv.to(dtype)], dim=1)
    qg = q.reshape(b, t1, kv, h // kv, dh)
    lg = torch.einsum("bjkgd,btkd->bjkgt", qg, kk) * dh ** -0.5
    pos0 = torch.as_tensor(pos0, device=q.device).reshape(-1, 1)
    cache_vis = torch.arange(n_keys, device=q.device) < pos0  # (b, n_keys)
    anc = torch.as_tensor(anc, dtype=torch.bool, device=q.device)
    vis = torch.cat([cache_vis[:, None].expand(b, t1, n_keys),
                     anc[None].expand(b, t1, t1)], dim=2)
    lg = lg.masked_fill(~vis[:, :, None, None], torch.finfo(lg.dtype).min)
    pr = torch.softmax(lg.float(), dim=-1).to(dtype)
    return torch.einsum("bjkgt,btkd->bjkgd", pr, vv).reshape(b, t1, h, dh)


def _tree_plain(q, k_pages, v_pages, table, pos0, wk, wv, anc, layer):
    """K6's plain version: the slot's cache K/V gathered through the
    block table (``-1`` entries read the scratch page, never visible),
    then :func:`tree_attention`."""
    pages = ((k_pages, v_pages) if layer is None
             else (k_pages[layer], v_pages[layer]))
    table = torch.as_tensor(table, device=q.device)
    kt, vt = page_tiles(pages, table, q.dtype)  # (b, M, T, kv, dh)
    return tree_attention(q, kt.flatten(1, 2), vt.flatten(1, 2), pos0, wk,
                          wv, anc, dtype=q.dtype)


def _ancestor_masks(anc, device) -> torch.Tensor:
    """The ``(T+1, T+1)`` mask as ``(T+1,)`` int32 row bitmasks (bit
    ``c`` of row ``j`` set iff ``anc[j][c]``) on ``device``, built once
    per tree shape and device.  A tuple of tuples (``TreeShape.ancestors``,
    what the engine passes) is the cache key as it is, so a tree step
    pays no conversion on the host."""
    if not (isinstance(anc, tuple) and all(isinstance(r, tuple)
                                           for r in anc)):
        anc = tuple(tuple(row) for row in
                    torch.as_tensor(anc, dtype=torch.bool).tolist())
    return _masks_on(anc, device)


@functools.lru_cache(maxsize=64)
def _masks_on(rows: tuple, device) -> torch.Tensor:
    masks = [sum(1 << c for c, bit in enumerate(row) if bit) for row in rows]
    # Bit 31 is the sign bit of an int32; the kernel reads uint32.
    return torch.tensor([m - (1 << 32) if m >= 1 << 31 else m
                         for m in masks], dtype=torch.int32, device=device)


def paged_tree(q, k_pages, v_pages, table, pos0, wk, wv, anc, *,
               layer=None):
    """K6: tree-verify attention over the slot's cache pages and the
    in-flight window.  ``q`` ``(b, T+1, h, dh)`` with ``T+1 <= 32``;
    ``wk``/``wv`` ``(b, T+1, kv, dh)``, read through their strides (views
    of the qkv projection are taken as they are); ``pos0`` ``(b,)``.
    Launches ``csrc/paged_tree.cu`` on CUDA tensors (the count goes up
    by one), runs the plain version on CPU tensors."""
    if not q.is_cuda:
        return _tree_plain(q, k_pages, v_pages, table, pos0, wk, wv, anc,
                           layer)
    out, table, pos0, _, ints, strides, _ = _launch_args(
        q, (k_pages, v_pages), table, pos0, layer)
    _, b, t1, _, kv, dh, _, _ = ints
    if t1 > TREE_KERNEL_MAX_NODES:
        raise ValueError(f"the tree kernel takes at most "
                         f"{TREE_KERNEL_MAX_NODES} nodes, got {t1}")
    for name, w in (("wk", wk), ("wv", wv)):
        if w.device != q.device or w.dtype != q.dtype:
            raise ValueError(f"{name} must be a {q.dtype} tensor on "
                             f"{q.device}")
        if tuple(w.shape) != (b, t1, kv, dh):
            raise ValueError(f"{name} must be {(b, t1, kv, dh)}, got "
                             f"{tuple(w.shape)}")
        if w.stride(-1) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous")
    if wk.stride() != wv.stride():
        raise ValueError("wk and wv must share their strides")
    masks = _ancestor_masks(anc, q.device)
    if masks.shape != (t1,):
        raise ValueError(f"anc must be ({t1}, {t1})")
    fn = _build.launcher("paged_tree")
    code = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
              table.data_ptr(), pos0.data_ptr(), wk.data_ptr(),
              wv.data_ptr(), masks.data_ptr(), out.data_ptr(), *ints,
              *strides[:3], *wk.stride()[:3], *strides[3:],
              q.shape[-1] ** -0.5,
              torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("paged_tree", code)
    paged_tree.launches += 1
    return out


#: Every ported kernel wrapper, by kernel name.
KERNELS = {"paged_decode": paged_decode, "paged_window": paged_window,
           "paged_decode_int8": paged_decode_int8,
           "paged_window_int8": paged_window_int8, "paged_tree": paged_tree}
for _fn in KERNELS.values():
    _fn.launches = 0


def paged_attention(q, pages, table, pos, *, dtype, grouped: bool = False,
                    impl: str = "einsum", layer: int | None = None):
    """Attention for projected queries ``(b, cur, h, dh)`` over
    table-indirected K/V pages; returns ``(b, cur, h, dh)`` in ``dtype``.

    ``impl='einsum'`` runs :func:`_einsum_paged` on one layer's pages;
    ``impl='kernel'`` dispatches as the JAX op does — a vector ``pos``
    with ``cur == 1`` to :func:`paged_decode`, anything else to
    :func:`paged_window`, or to their int8 variants for a 4-tuple of
    pages — and alone takes ``layer`` (whole-pool mode: ``pages`` are the
    stacked pool)."""
    if impl not in ("einsum", "kernel"):
        raise ValueError(f"unknown paged-attention impl {impl!r}; choose "
                         f"from 'einsum' or 'kernel'")
    if layer is not None and impl != "kernel":
        raise ValueError("whole-pool layer indexing is kernel-impl only")
    if impl == "einsum":
        return _einsum_paged(q, pages, table, pos, dtype=dtype,
                             grouped=grouped)
    if q.dtype != dtype:
        raise TypeError(f"kernel impl computes in the query dtype "
                        f"({q.dtype}), asked for {dtype}")
    if len(pages) not in (2, 4):
        raise ValueError(f"pages are (k, v) or (k, v, k_scale, v_scale), "
                         f"got {len(pages)} buffers")
    decode = torch.as_tensor(pos).dim() > 0 and q.shape[1] == 1
    if len(pages) == 4:
        kernel = paged_decode_int8 if decode else paged_window_int8
    else:
        kernel = paged_decode if decode else paged_window
    return kernel(q, *pages, table, pos, layer=layer)


def tree_paged_attention(q, pages, table, pos0, wk, wv, anc, *, dtype,
                         layer: int | None = None):
    """Tree-verify attention for node queries ``(b, T+1, h, dh)`` over
    table-indirected cache pages (strict ``k_pos < pos0``) jointly with
    the in-flight window ``wk``/``wv`` ``(b, T+1, kv, dh)`` under the
    ancestor-or-self mask ``anc``; the window never enters the pages, so
    rejected branches write nothing.  Runs :func:`paged_tree` (K6 on CUDA
    tensors, its plain version on CPU tensors); ``layer`` is whole-pool
    mode, as for :func:`paged_attention`'s kernels.  fp pools only, as in
    JAX: the engine verifies trees over an int8 pool on its einsum
    fallback."""
    if q.dtype != dtype:
        raise TypeError(f"tree attention computes in the query dtype "
                        f"({q.dtype}), asked for {dtype}")
    if len(pages) != 2:
        raise NotImplementedError(
            "the tree kernel reads fp pages only; over an int8 pool the "
            "engine verifies trees on its einsum fallback (gather_pages + "
            "_forward_tree, Engine.metrics()['paged_attn']['fallbacks'])")
    return paged_tree(q, *pages, table, pos0, wk, wv, anc, layer=layer)
