"""Paged attention — queries attend K/V read through a per-slot block
table, one layer at a time; the port of ``tpudp/ops/paged_attention.py``.

Two backends behind :func:`paged_attention`, with the JAX op's layouts:

  * ``impl='einsum'`` — :func:`_einsum_paged`, the plain PyTorch version:
    per-page tiles ``pool[table]`` feed the contraction, the flattened
    ``(pages * page_tokens)`` key axis gets the dense path's visibility
    mask, float32 softmax, and the P.V product.
  * ``impl='kernel'`` — the hand-written CUDA kernels
    (``tpudp_torch/csrc``): a one-token window at per-slot depths goes to
    :func:`paged_decode` (K4), everything else — a prefill chunk at a
    shared scalar depth, a multi-token window at per-slot depths — to
    :func:`paged_window` (K5).  Both compute in float32 and are bounded
    by a tolerance against the plain version, as the Pallas kernels are.

A kernel wrapper given CUDA tensors launches its kernel or raises; given
CPU tensors it runs the plain version, which is what the CPU tests see.
Each wrapper counts its launches in ``.launches`` so a run can show that
its main path went through the kernel.

Pages are ``(P + 1, T, kv, dh)`` per layer, the trailing page being the
write scratch; whole-pool mode passes ``(L, P + 1, T, kv, dh)`` plus
``layer``, and the kernels index that layer through strides.  ``table``
is ``(b, M)`` with ``-1`` for unmapped entries; ``pos`` is ``(b,)`` (row
``j`` of slot ``s`` sees keys ``<= pos[s] + j``) or a scalar shared by
the batch (the prefill window).  int8 pages are not ported yet (ROADMAP
slice 4).
"""

from __future__ import annotations

import torch

from tpudp_torch.ops import _build

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIMS = (32, 64, 128)


def _fp_pages(pages):
    """``(k, v)``; the int8 quadruple ``(k, v, k_scale, v_scale)`` is not
    ported yet."""
    if len(pages) != 2:
        raise NotImplementedError(
            "int8 page pools are not ported yet: ROADMAP.md slice 4 "
            "(int8 pages with the K4/K5 dequant variants)")
    return pages


def page_tiles(pages, table, dtype):
    """Per-slot ``(b, M, T, kv, dh)`` K/V tiles indexed by the block
    table.  Unmapped entries (``-1``) read the trailing scratch page,
    whose contents only ever land where the visibility mask excludes
    them."""
    k, v = _fp_pages(pages)
    scratch = k.shape[0] - 1
    tbl = torch.where(table >= 0, table, scratch).long()
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


def _plain(q, k_pages, v_pages, table, pos, layer):
    """A kernel's plain version on the CPU: the GQA einsum family, which
    covers MHA as one head per group."""
    pages = ((k_pages, v_pages) if layer is None
             else (k_pages[layer], v_pages[layer]))
    return _einsum_paged(q, pages, table, pos, dtype=q.dtype, grouped=True)


def _launch_args(q, k_pages, v_pages, table, pos, layer):
    """Validate one kernel call and return ``(out, table32, pos32,
    ints, strides)``: the output buffer, the int32 index tensors the
    kernel reads, the geometry and the element strides."""
    if not (q.is_cuda and k_pages.device == q.device
            and v_pages.device == q.device):
        raise ValueError("paged kernels need q and the pages on one CUDA "
                         "device")
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"paged kernels take float32 or bfloat16, got "
                        f"{q.dtype}")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(f"page dtype ({k_pages.dtype}/{v_pages.dtype}) "
                        f"must equal the query dtype ({q.dtype})")
    if k_pages.shape != v_pages.shape:
        raise ValueError("k and v pages differ in shape")
    whole = layer is not None
    if k_pages.dim() != 4 + whole:
        raise ValueError(f"pages must be {'(L, ' if whole else '('}P+1, T, "
                         f"kv, dh), got {tuple(k_pages.shape)}")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("paged kernels read contiguous page pools")
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
    pos = torch.as_tensor(pos).to(q.device, torch.int32)
    pos = pos.expand(b).contiguous()
    out = torch.empty((b, cur, h, dh), dtype=q.dtype, device=q.device)
    offset = layer * k_pages.stride(0) if whole else 0
    ps, ts, hs = k_pages.stride()[-4:-1]
    ints = (_KERNEL_DTYPES[q.dtype], b, cur, h, kv, dh, table.shape[1],
            page_tokens)
    strides = (q.stride(0), q.stride(1), q.stride(2), offset, ps, ts, hs)
    return out, table, pos, ints, strides


def paged_decode(q, k_pages, v_pages, table, pos, *, layer=None):
    """K4: one-token paged decode.  ``q`` ``(b, 1, h, dh)``; ``pos``
    ``(b,)``.  Launches ``csrc/paged_decode.cu`` on CUDA tensors (the
    count goes up by one), runs the plain version on CPU tensors."""
    if q.shape[1] != 1:
        raise ValueError("the paged-decode kernel is a one-token kernel")
    if not q.is_cuda:
        return _plain(q, k_pages, v_pages, table, pos, layer)
    out, table, pos, ints, strides = _launch_args(q, k_pages, v_pages,
                                                  table, pos, layer)
    dtype_code, b, _, h, kv, dh, m, page_tokens = ints
    qs_slot, _, qs_head, offset, ps, ts, hs = strides
    fn = _build.launcher("paged_decode")
    code = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
              table.data_ptr(), pos.data_ptr(), out.data_ptr(), dtype_code,
              b, h, kv, dh, m, page_tokens, qs_slot, qs_head, offset, ps,
              ts, hs, dh ** -0.5, torch.cuda.current_stream(q.device)
              .cuda_stream)
    _build.check("paged_decode", code)
    paged_decode.launches += 1
    return out


def paged_window(q, k_pages, v_pages, table, pos, *, layer=None):
    """K5: multi-token paged window.  ``q`` ``(b, cur, h, dh)``; ``pos``
    ``(b,)`` or a scalar (broadcast over the batch).  Launches
    ``csrc/paged_window.cu`` on CUDA tensors (the count goes up by one),
    runs the plain version on CPU tensors."""
    if not q.is_cuda:
        return _plain(q, k_pages, v_pages, table, pos, layer)
    out, table, pos, ints, strides = _launch_args(q, k_pages, v_pages,
                                                  table, pos, layer)
    fn = _build.launcher("paged_window")
    code = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
              table.data_ptr(), pos.data_ptr(), out.data_ptr(), *ints,
              *strides, q.shape[-1] ** -0.5,
              torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("paged_window", code)
    paged_window.launches += 1
    return out


paged_decode.launches = 0
paged_window.launches = 0

#: Every ported kernel wrapper, by kernel name.
KERNELS = {"paged_decode": paged_decode, "paged_window": paged_window}


def paged_attention(q, pages, table, pos, *, dtype, grouped: bool = False,
                    impl: str = "einsum", layer: int | None = None):
    """Attention for projected queries ``(b, cur, h, dh)`` over
    table-indirected K/V pages; returns ``(b, cur, h, dh)`` in ``dtype``.

    ``impl='einsum'`` runs :func:`_einsum_paged` on one layer's pages;
    ``impl='kernel'`` dispatches as the JAX op does — a vector ``pos``
    with ``cur == 1`` to :func:`paged_decode`, anything else to
    :func:`paged_window` — and alone takes ``layer`` (whole-pool mode:
    ``pages`` are the stacked pool)."""
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
    k_pages, v_pages = _fp_pages(pages)
    vector_pos = torch.as_tensor(pos).dim() > 0
    kernel = paged_decode if vector_pos and q.shape[1] == 1 else paged_window
    return kernel(q, k_pages, v_pages, table, pos, layer=layer)
