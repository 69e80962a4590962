"""Continuous-batching inference engine — the port of the single-model core
of ``tpudp/serve/engine.py``.

Requests share a fixed set of slots.  Each scheduler iteration admits
queued requests into free slots, runs at most one prefill chunk (the
oldest admitted request still prefilling) and then one batched decode
step for every decoding slot.  The host owns all scheduling state:
lengths, last tokens, sampling parameters and, in paged mode, the block
tables; the device runs the forwards.

Two KV stores, as in the JAX engine:

  * **Dense arena** (``kv_pages=0``, the default) — one
    ``(layers, num_slots, max_len, heads, dh)`` ``KVCache``; decode and
    prefill run ``tpudp_torch.models.generate._forward_cached``.
  * **Paged** (``kv_pages > 0``) — one shared refcounted page pool
    (``kv_pages`` pages of ``prefill_chunk`` tokens) plus per-slot block
    tables.  A shared-prefix hit maps the radix index's pages into the
    slot's table (copy-on-write: the first divergent chunk is prefilled
    into a fresh private page); retirement transfers page ownership to
    the index; pages are allocated lazily as slots deepen, and pool
    pressure first evicts cold index leaves, then vacates the most
    recently admitted slot, which later resumes exactly where it was.
    ``paged_attn`` picks the attention backend: ``'kernel'`` — the
    default on a CUDA device — runs decode through the paged-decode
    kernel and prefill chunks through the paged-window kernel;
    ``'einsum'`` — the default on the CPU — runs their plain PyTorch
    version; ``'gather'`` is JAX's baseline (gather the dense view, the
    dense forward, scatter the touched pages back).  Asking for
    ``'kernel'`` on the CPU raises.
    ``kv_dtype='int8'`` stores the pool quantized (int8 payloads, one
    float32 scale per token and KV head, same page ids): the kernels are
    then their int8 variants.  Where the kernels cannot take the
    engine's shapes, a kernel engine runs that family on the einsum
    path, decided at build time by :func:`paged_dispatch` and listed in
    ``metrics()['paged_attn']['fallbacks']``: every family at a head dim
    other than 32, 64 or 128, and tree verify over an int8 pool (as in
    JAX) or over a tree of more than 32 nodes.

The dense prefix cache (``prefix_cache_blocks=N``, dense arena only): a
block pool plus radix index (``tpudp_torch.serve.prefix_cache.
PrefixCache``, blocks of ``prefill_chunk`` tokens).  Admission copies
the longest cached block-aligned prefix of the fill into the slot's
arena rows (one copy a block, in place) and prefills the rest, the final
chunk always; retirement publishes the slot's chunk-prefilled blocks
(new ones copied out of the arena).  A failed publish flushes the cache
and the retirement goes on; containment flushes it too.

Sampling is per slot: greedy rows take the argmax; sampled rows draw
from the slot's own ``torch.Generator``, seeded from the request's
``seed`` and advanced only by that request's own draws, so its output
does not depend on what else shares the batch.  A vacated request keeps
its generator state and resumes with it.

Speculative decoding (``speculate_k=k``): a host-side drafter
(``tpudp_torch.serve.speculate``; ``NgramDrafter`` by default) proposes
up to ``k`` tokens per decoding slot, one ``k + 1`` verify window per
step scores them (in paged kernel mode through the paged-window kernel
at per-slot depths) and the longest agreeing prefix plus the verify
forward's own next token commit; greedy output equals plain decode.
With ``speculate_tree=shape`` the drafter fills a static token tree,
scored by one tree-masked forward (the paged-tree kernel on the card)
whose window K/V stay out of the KV store; only the accepted
root-to-leaf path is committed.  A step where no slot drafted runs the
plain decode step, and a drafter that raises or proposes out-of-vocab
ids is quarantined: the engine decodes without it, outputs unchanged.

Fused decode windows (``decode_fuse=N > 1``): on a pure-decode
iteration (nothing queued, no slot prefilling, no live drafter) the
engine runs up to N decode iterations as one window
(``tpudp_torch.serve.fused``) — on the card one CUDA graph of a whole
decode iteration, replayed with no host sync in between — fetches its
tokens once, and replays their commits through the single-step path's
``_commit``, so stats, retirements and later single steps continue
exactly.  Any other iteration runs the single-step path; host-drafted
speculation wins over fusing.  ``decode_fuse=1``, the default, builds no
window and
is the single-step engine.  ``fuse_stream=True`` adds
:attr:`Engine.fused_stream`, a bounded ring of ``(slot, token)`` in the
order the window's iterations committed them.  JAX's ring is filled by
a callback inside its loop, token by token; the port fills it per
window, after the fetch.  It is observability only, never the commit
path.

Fused speculation (``speculate_k=k``, ``decode_fuse=N > 1`` and a
``DraftModelDrafter`` whose model covers ``max_len + k`` positions,
sequence mode): a pure-decode iteration runs up to N draft -> verify ->
accept iterations as one window (``tpudp_torch.serve.fused.
FusedSpecWindow``) — the draft model refills its own KV store from each
slot's token history on the device, each iteration's ``k + 1`` verify
window runs through the target's paged forward (K5, or K5-int8 over an
int8 pool) — and fetches once.  Its tokens and acceptance counts are
those of the host-drafted engine with ``DraftModelDrafter(bucket=
max_len)`` and ``decode_fuse=1``, greedy and sampled.  Once the drafter
is quarantined the engine runs plain fused decode windows.

Robustness, as in JAX: ``queue_limit`` sheds with :class:`QueueFull`;
``submit(deadline_s=, ttft_deadline_s=)`` retires an expired request
with ``FinishReason.DEADLINE``; every device call goes through one seam
(``_device``: ``step_fault_hook(kind, index)``, then the optional
watchdog's scoped deadline, ``step_timeout_s``); an exception escaping
a step is contained (``_contain_step_failure``): the KV store is reset
in place and each in-flight request requeues once with its tokens and
generator state, a second failure retires it with ``ERROR``.  A drafter
that raises, returns garbage, exceeds ``drafter_timeout_s`` or blocks
past the watchdog's deadline is quarantined.  ``canary_every_s`` runs a
greedy probe request whose tokens are pinned by its first clean run; a
later mismatch (``token_fault_hook`` is the silent-corruption seam)
quarantines the engine.  ``drain()`` finishes accepted work and closes;
``close()`` cancels it.  Containment covers exceptions raised on the
host — hooks, ``StepHangError``, a kernel launch's error code — not a
fault that poisons the CUDA context (an illegal address, a device-side
assert), which no process survives; a failed kernel build
(``_build.BuildError``) or graph capture (``fused.CaptureError``) is a
fault of the program and raises.  JAX's obs spans, events and flight
dumps are a later slice (ROADMAP.md slice 8, obs).

Tenancy (``tenants={name: TenantClass}``, ``tpudp_torch.serve.tenancy``;
``tenants=None`` is the single-queue engine, stats keys included):
per-class bounded queues (``QueueFull``), class-wide default deadlines,
admission by strict priority across classes and stride shares within a
priority, and priority preemption: when a higher-priority request waits
and no slot is free, the lowest-priority in-flight slot (the most
recently admitted among equals) is vacated through the requeue path —
tokens and generator state carried, requeued at the front of its own
class — and resumes exactly.  Preemption and admission happen between
scheduler iterations, so never inside a fused window.

Co-resident models (``models={name: model}``, which needs ``tenants``;
a ``TenantClass(model=name)`` routes its class there): each model has
its own KV store (dense arena, or block table, radix index and dense
prefix cache) and its own fused windows behind the one scheduler, and
each iteration runs one batched decode per model with decoding slots.
Paged models of one KV geometry (layers, KV heads, head dim, dtype)
share one ``PagePool``; distinct geometries split ``kv_pages`` evenly.
JAX's ``models`` maps a name to ``(model, params)``; the port's models
hold their weights, so it maps a name to the model.

The model is a ``tpudp_torch`` GPT-2 or LLaMA (grouped-query heads: the
KV store is ``kv_heads`` wide).
"""

from __future__ import annotations

import collections
import contextlib
import enum
import time

import numpy as np
import torch

from tpudp_torch.models.generate import (KVCache, _forward_cached,
                                         _forward_paged, _forward_tree,
                                         _forward_tree_paged, gather_pages,
                                         update_cache_rows,
                                         validate_decode_config,
                                         write_token_pages)
from tpudp_torch.ops._build import BuildError
from tpudp_torch.ops.paged_attention import (_KERNEL_HEAD_DIMS, KERNELS,
                                             TREE_KERNEL_MAX_NODES)
from tpudp_torch.ops.sampling import (sample_tokens, verify_tokens,
                                      verify_tree_tokens)
from tpudp_torch.serve.fused import CaptureError, FusedSpecWindow, FusedWindow
from tpudp_torch.serve.prefix_cache import (PageIndex, PagePool, PrefixCache,
                                            copy_block_in, copy_block_out)
from tpudp_torch.serve.speculate import NgramDrafter, tree_shape
from tpudp_torch.serve.tenancy import TenantScheduler
from tpudp_torch.utils.watchdog import StepHangError

#: Options of the JAX engine this port does not have yet: name ->
#: (the value that means "off", the ROADMAP.md item that brings it).
_UNPORTED = {
    # The port has no obs layer: True is JAX's default, the engine as
    # the port runs it (no spans or events recorded yet).
    "obs": (True, "Queue 1 item 2 (the obs layer)"),
    "flight_dir": (None, "Queue 1 item 2 (the obs layer)"),
}


#: Device types the kernel backend runs on: the kernels are CUDA's.
KERNEL_DEVICES = ("cuda",)

#: The paged step families, as ``metrics()["paged_attn"]["dispatch"]``
#: names them.
PAGED_FAMILIES = ("decode_paged", "verify_paged", "prefill_paged",
                  "fused_decode_paged", "fused_spec_paged",
                  "tree_verify_paged")


def paged_dispatch(paged_attn: str, kv_dtype: str | None,
                   head_dim: int | None = None,
                   tree_nodes: int | None = None) -> dict:
    """Which impl each paged family runs, decided once at build time from
    the engine's shapes (``tpudp/serve/engine.py``'s
    ``paged_attn_dispatch``).  A kernel engine sends a family to the
    einsum path wherever the kernels cannot take it, as JAX does where a
    feature lacks kernel support: every family at a head dim outside
    ``_KERNEL_HEAD_DIMS`` (32, 64, 128); tree verify over an int8 pool
    (JAX's ``_tree_paged`` raises for int8 pools too) or over a tree of
    more than ``TREE_KERNEL_MAX_NODES`` nodes (the tree kernel keeps one
    32-bit ancestor mask a row).  ``head_dim`` / ``tree_nodes`` None
    leave that check out."""
    table = dict.fromkeys(PAGED_FAMILIES, paged_attn)
    if paged_attn != "kernel":
        return table
    if head_dim is not None and head_dim not in _KERNEL_HEAD_DIMS:
        return dict.fromkeys(PAGED_FAMILIES, "einsum")
    if kv_dtype == "int8" or (tree_nodes is not None
                              and tree_nodes > TREE_KERNEL_MAX_NODES):
        table["tree_verify_paged"] = "einsum"
    return table


class FinishReason(str, enum.Enum):
    """Why a request stopped.  ``COMPLETE``/``EOS`` are success; the rest
    make :meth:`Request.result` raise :class:`RequestFailed`."""

    COMPLETE = "complete"    # max_new_tokens emitted
    EOS = "eos"              # sampled the request's eos_id
    CANCELLED = "cancelled"  # Engine.cancel()/Request.cancel()/close()
    DEADLINE = "deadline"    # deadline_s / ttft_deadline_s expired
    ERROR = "error"          # a step failure exhausted the requeue
    SHED = "shed"            # queued work discarded by Engine.close()


_FINISH_COUNTER = {
    FinishReason.COMPLETE: "completed",
    FinishReason.EOS: "completed",
    FinishReason.CANCELLED: "cancelled",
    FinishReason.DEADLINE: "deadline_expired",
    FinishReason.ERROR: "errors",
    FinishReason.SHED: "shed",
}


class QueueFull(RuntimeError):
    """submit() refused: ``queue_limit`` requests are already waiting."""


class EngineClosed(RuntimeError):
    """submit() called after :meth:`Engine.drain`/:meth:`Engine.close`,
    or on an engine a canary quarantined."""


class RequestFailed(RuntimeError):
    """:meth:`Request.result` on a request that did not finish
    successfully; carries the handle and its ``finish_reason``."""

    def __init__(self, request: "Request"):
        self.request = request
        self.finish_reason = request.finish_reason
        super().__init__(
            f"request {request.id} finished with "
            f"{request.finish_reason.value!r} after "
            f"{len(request.tokens)} of {request.max_new_tokens} tokens")


def _decode_math(forward, state, last_tokens, lengths, active, temps,
                 top_k, top_p, generators):
    """The one decode-step body of the dense and paged engines:
    ``forward`` hides the KV store; sampling draws only for active rows,
    so an idle or still-prefilling slot's generator never moves."""
    logits, state = forward(state, last_tokens[:, None], lengths, active)
    gens = [g if a else None for g, a in zip(generators, active.tolist())]
    toks = sample_tokens(logits[:, 0], temps, top_k, top_p, gens)
    return state, toks


def _sample_row(logits, temp, top_k, top_p, generator):
    """The first token after a finished prefill: one row through the
    decode step's sampling op."""
    return sample_tokens(logits, [temp], [top_k], [top_p], [generator])[0]


class _ModelState:
    """One registered model's serving state (``name`` None: the default
    model): its dense arena and optional dense prefix cache, or its page
    pool (shared with the models of its KV geometry), radix index and
    host-side block table (``(num_slots, max_pages)`` int32, ``-1``
    unmapped); ``slot_nodes[s]`` maps each of slot ``s``'s shared pages
    to the pinned index node behind it.  ``dispatch`` is its paged
    families' impl table; ``window`` and ``spec_window`` its fused
    windows, built at first use.  Every model's arena has the engine's
    slot geometry; only the rows of slots decoding with it hold its
    KV."""

    __slots__ = ("name", "model", "config", "cache", "prefix_cache", "pool",
                 "index", "table", "slot_nodes", "dispatch", "window",
                 "spec_window")

    def __init__(self, name, model):
        self.name = name
        self.model = model
        self.config = model.config
        self.cache = None
        self.prefix_cache = None
        self.pool = None
        self.index = None
        self.table = None
        self.slot_nodes = None
        self.dispatch = {}
        self.window = None
        self.spec_window = None


class Request:
    """Handle returned by :meth:`Engine.submit`.  ``tokens`` grows as the
    engine steps; iterate the handle to stream them, or call
    :meth:`result` for the whole ``prompt + completion``.
    ``token_times`` holds a ``time.perf_counter()`` stamp per token;
    ``draft_proposed``/``draft_accepted`` count this request's drafted
    and accepted tokens (``acceptance_rate`` is their ratio).
    ``finish_reason`` says why it stopped (None until ``done``) and
    ``error`` holds the exception that retired it with ``ERROR``.
    ``tenant`` is its class on a tenant-aware engine (else None) and
    ``preemptions`` counts the times it lost its slot to
    higher-priority work (each resume is exact)."""

    def __init__(self, engine: "Engine", rid: int, prompt: np.ndarray,
                 max_new_tokens: int, temperature: float, top_k: int,
                 top_p: float, seed: int, eos_id: int | None,
                 deadline_s: float | None = None,
                 ttft_deadline_s: float | None = None,
                 tenant: str | None = None):
        self._engine = engine
        self.id = rid
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.top_k = top_k  # 0 = disabled
        self.top_p = top_p  # 1.0 = disabled
        self.seed = seed
        self.eos_id = eos_id
        self.deadline_s = deadline_s
        self.ttft_deadline_s = ttft_deadline_s
        self.tenant = tenant
        self.preemptions = 0
        self._ms = None  # the _ModelState this request decodes with
        self.tokens: list[int] = []
        self.token_times: list[float] = []
        self.submit_time = time.perf_counter()
        self.done = False
        self.finish_reason: FinishReason | None = None
        self.error: BaseException | None = None
        self.draft_proposed = 0
        self.draft_accepted = 0
        self._slot: int | None = None
        self._fill = prompt  # tokens to prefill (prompt, + tokens on resume)
        self._nfill = 0      # fill tokens already in the KV store
        self._order = 0      # admission order (prefill FIFO tiebreak)
        self._resume_key = None  # generator state saved across a vacate
        self._requeued = False   # the one step-failure requeue is spent
        self._canary = False     # the engine's own canary probe

    @property
    def acceptance_rate(self) -> float | None:
        """Accepted / proposed draft tokens of this request (None until
        a drafter has proposed something for it)."""
        if not self.draft_proposed:
            return None
        return self.draft_accepted / self.draft_proposed

    @property
    def cancelled(self) -> bool:
        return self.finish_reason is FinishReason.CANCELLED

    @property
    def ok(self) -> bool:
        return self.finish_reason in (FinishReason.COMPLETE,
                                      FinishReason.EOS)

    def cancel(self) -> bool:
        return self._engine.cancel(self)

    def __iter__(self):
        i = 0
        while True:
            while i >= len(self.tokens) and not self.done:
                self._engine.step()
            if i < len(self.tokens):
                yield self.tokens[i]
                i += 1
            else:
                return

    def result(self) -> np.ndarray:
        """Drive the engine until this request finishes; return the full
        ``prompt + generated`` int32 sequence, or raise
        :class:`RequestFailed`."""
        while not self.done:
            self._engine.step()
        if not self.ok:
            raise RequestFailed(self)
        return np.concatenate([self.prompt,
                               np.asarray(self.tokens, np.int32)])


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device with no card
    present raises instead of falling back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the card by "
            "default — pass device='cpu' to run on the CPU")
    return device


class Engine:
    """Continuous-batching engine over ``num_slots`` slots.

    ``model`` is a ``tpudp_torch`` GPT-2 or LLaMA (dense attention and
    MLP); it is moved to ``device`` (default ``"cuda"``; no card and no
    ``device="cpu"`` raises) and otherwise left as the caller has it —
    its forwards here run under ``torch.no_grad()``, so a model that is
    being trained keeps its gradients.  ``max_len`` bounds ``prompt +
    max_new_tokens`` (default: the model's ``max_seq_len`` rounded down
    to a ``prefill_chunk`` multiple).  ``kv_pages > 0`` selects the paged
    KV store with pages of ``prefill_chunk`` tokens and ``paged_attn``
    its backend (``None`` resolves to ``'kernel'`` on CUDA, ``'einsum'``
    on the CPU); ``kv_dtype='int8'`` quantizes the pool's payloads.
    ``queue_limit`` bounds the submit queue
    (:class:`QueueFull`).  ``speculate_k > 0`` turns on speculative
    decoding with ``drafter`` (default ``NgramDrafter()``) and, with
    ``speculate_tree`` (a ``TREE_SHAPES`` name, a ``TreeShape`` or a
    parents tuple of depth ``<= speculate_k``), tree verify; every
    request then reserves ``speculate_k`` scratch positions of
    ``max_len``.  ``decode_fuse > 1`` runs pure-decode iterations as
    fused windows of up to that many decode iterations (of speculation
    iterations with a model drafter that covers ``max_len +
    speculate_k`` positions), and ``fuse_stream`` (which needs
    ``decode_fuse >= 2``) keeps their commits in :attr:`fused_stream`.

    Robustness: ``drafter_timeout_s`` bounds one ``propose``;
    ``watchdog`` (a started ``tpudp_torch.utils.watchdog.Watchdog``)
    arms a scoped deadline of ``step_timeout_s`` (default: the
    watchdog's) around every device call and every propose;
    ``step_fault_hook(kind, index)`` runs before each device call and
    ``token_fault_hook(slot, token, request) -> token`` at each commit;
    ``canary_every_s`` starts a canary request (``canary_prompt``,
    default tokens 1-8; ``canary_new_tokens`` greedy tokens) that often,
    one at a time.

    ``prefix_cache_blocks > 0`` turns on the dense prefix cache (a pool
    of that many blocks; exclusive with ``kv_pages``), handle
    :attr:`prefix_cache`.  ``tenants={name: TenantClass}`` turns on
    tenancy: ``submit(tenant=)``, per-class queues under the engine's
    total ``queue_limit``, priority preemption, :attr:`tenant_stats`.
    ``models={name: model}`` registers co-resident models (each moved to
    ``device``; they need ``tenants``, and a ``max_seq_len`` of at least
    ``max_len``); :attr:`page_pool`, :attr:`page_index` and
    :attr:`prefix_cache` are the default model's."""

    def __init__(self, model, *, device="cuda", num_slots: int = 8,
                 max_len: int | None = None, prefill_chunk: int = 16,
                 kv_pages: int = 0, paged_attn: str | None = None,
                 kv_dtype: str | None = None,
                 prefix_cache_blocks: int = 0,
                 queue_limit: int | None = None, speculate_k: int = 0,
                 drafter=None, speculate_tree=None, decode_fuse: int = 1,
                 fuse_stream: bool = False,
                 drafter_timeout_s: float | None = None, watchdog=None,
                 step_timeout_s: float | None = None, step_fault_hook=None,
                 token_fault_hook=None,
                 canary_every_s: float | None = None, canary_prompt=None,
                 canary_new_tokens: int = 8, tenants: dict | None = None,
                 models: dict | None = None, **unported):
        for name, value in unported.items():
            if name not in _UNPORTED:
                raise TypeError(f"Engine() got an unexpected keyword "
                                f"argument {name!r}")
            off, item = _UNPORTED[name]
            if value != off:
                raise NotImplementedError(
                    f"Engine({name}=...) is not ported yet: ROADMAP.md "
                    f"{item}")
        cfg = model.config
        validate_decode_config(cfg, "Engine")
        self.device = resolve_device(device)
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {prefill_chunk}")
        if speculate_k < 0:
            raise ValueError(f"speculate_k must be >= 0, got {speculate_k}")
        if decode_fuse < 1:
            raise ValueError(
                f"decode_fuse must be >= 1 (1 disables the fused decode "
                f"window), got {decode_fuse}")
        if fuse_stream and decode_fuse <= 1:
            raise ValueError(
                "fuse_stream requires decode_fuse >= 2 — the stream tap "
                "rides the fused decode window")
        if prefix_cache_blocks < 0:
            raise ValueError(
                f"prefix_cache_blocks must be >= 0 (0 disables prefix "
                f"caching), got {prefix_cache_blocks}")
        if kv_pages < 0:
            raise ValueError(f"kv_pages must be >= 0 (0 keeps the dense "
                             f"slot arena), got {kv_pages}")
        if kv_pages and prefix_cache_blocks:
            raise ValueError(
                "kv_pages (paged attention: slots reference one shared "
                "page pool in place, prefix reuse is a table write) and "
                "prefix_cache_blocks (the dense COPY cache) are mutually "
                "exclusive — paged mode subsumes the copy path")
        if paged_attn not in (None, "einsum", "gather", "kernel"):
            raise ValueError(
                f"paged_attn must be None (auto: 'kernel' on CUDA, "
                f"'einsum' on the CPU), 'einsum' (the plain PyTorch "
                f"version), 'gather' (the gather -> dense -> scatter "
                f"baseline) or 'kernel' (the CUDA kernels); got "
                f"{paged_attn!r}")
        if kv_dtype not in (None, "int8"):
            raise ValueError(
                f"kv_dtype must be None or 'int8', got {kv_dtype!r}")
        if kv_dtype is not None and not kv_pages:
            raise ValueError("kv_dtype requires kv_pages > 0 — quantized KV "
                             "lives in the page pool")
        if paged_attn not in (None, "einsum") and not kv_pages:
            raise ValueError(
                f"paged_attn={paged_attn!r} requires kv_pages > 0 — the "
                f"paged-attention backend choice only exists behind the "
                f"block-table indirection")
        if paged_attn == "kernel" and self.device.type not in KERNEL_DEVICES:
            raise ValueError("paged_attn='kernel' runs the CUDA kernels; "
                             "it needs a CUDA device")
        self.paged_attn_requested = paged_attn
        if paged_attn is None:
            paged_attn = ("kernel" if kv_pages and self.device.type == "cuda"
                          else "einsum")
        if queue_limit is not None and queue_limit < 1:
            raise ValueError(f"queue_limit must be >= 1 (or None for "
                             f"unbounded), got {queue_limit}")
        if drafter is not None and speculate_k == 0:
            raise ValueError("drafter requires speculate_k >= 1 "
                             "(speculation is off at k=0)")
        if speculate_k > 0 and drafter is None:
            drafter = NgramDrafter()
        dcfg = getattr(drafter, "config", None)
        if dcfg is not None and dcfg.vocab_size != cfg.vocab_size:
            raise ValueError(
                f"drafter vocab_size ({dcfg.vocab_size}) must match the "
                f"target model's ({cfg.vocab_size}) — speculation "
                f"requires a shared tokenizer")
        max_len = cfg.max_seq_len if max_len is None else max_len
        if max_len > cfg.max_seq_len:
            raise ValueError(f"max_len ({max_len}) exceeds the model's "
                             f"max_seq_len ({cfg.max_seq_len})")
        # Chunk writes start at multiples of prefill_chunk, so max_len
        # rounds DOWN to a chunk multiple: a final chunk never overruns.
        self.max_len = (max_len // prefill_chunk) * prefill_chunk
        if self.max_len < prefill_chunk:
            raise ValueError(f"max_len ({max_len}) must fit at least one "
                             f"prefill chunk ({prefill_chunk})")
        if speculate_k > 0 and self.max_len <= speculate_k:
            raise ValueError(
                f"max_len ({self.max_len}) must exceed speculate_k "
                f"({speculate_k}) — every request reserves k scratch "
                f"positions for the speculative window")
        self.speculate_tree = None
        if speculate_tree is not None:
            if speculate_k == 0:
                raise ValueError(
                    "speculate_tree requires speculate_k >= 1 — the tree "
                    "rides the speculative window's reserve")
            shape = tree_shape(speculate_tree)
            if shape.max_depth > speculate_k:
                raise ValueError(
                    f"speculate_tree {shape.name!r} max_depth "
                    f"({shape.max_depth}) exceeds speculate_k "
                    f"({speculate_k}) — each request reserves exactly k "
                    f"scratch positions")
            if not hasattr(drafter, "propose_tree"):
                raise ValueError(
                    f"speculate_tree requires a drafter with "
                    f"propose_tree() (e.g. NgramDrafter); "
                    f"{type(drafter).__name__} has none")
            self.speculate_tree = shape
        # Fused speculation: a model drafter inside the fused window, where
        # its model covers the max_len-wide history plus k drafts past it
        # (the host DraftModelDrafter(bucket=max_len)'s geometry, the
        # referee).  Anything else keeps the host-drafted path.
        draft_model = getattr(drafter, "model", None)
        self._spec_fusable = (
            speculate_k > 0 and decode_fuse > 1 and speculate_tree is None
            and dcfg is not None and draft_model is not None
            and dcfg.max_seq_len >= self.max_len + speculate_k)
        if drafter_timeout_s is not None and drafter_timeout_s <= 0:
            raise ValueError(f"drafter_timeout_s must be > 0, got "
                             f"{drafter_timeout_s}")
        if step_timeout_s is not None and step_timeout_s <= 0:
            raise ValueError(
                f"step_timeout_s must be > 0, got {step_timeout_s}")
        if canary_every_s is not None and canary_every_s < 0:
            raise ValueError(
                f"canary_every_s must be >= 0 (0 = a canary in flight "
                f"whenever possible), got {canary_every_s}")
        if canary_new_tokens < 1:
            raise ValueError(
                f"canary_new_tokens must be >= 1, got {canary_new_tokens}")
        self.speculate_k = speculate_k
        self.drafter = drafter
        self._drafter_quarantined = False
        self.drafter_quarantine_reason: str | None = None
        self.model = model.to(self.device)
        if self._spec_fusable:
            draft_model.to(self.device)  # the window drafts on the card
        self.config = cfg
        self.num_slots = num_slots
        self.prefill_chunk = prefill_chunk
        self.queue_limit = queue_limit
        self._paged = kv_pages > 0
        self.kv_pages = kv_pages
        self.kv_dtype = kv_dtype
        self.paged_attn = paged_attn
        self._prefix_cache_blocks = prefix_cache_blocks
        self._max_pages = self.max_len // prefill_chunk  # table width
        self._mstates: dict[str | None, _ModelState] = {}
        self._add_model(None, self.model)
        self.paged_attn_dispatch = self._mstates[None].dispatch
        self.tenants = tenants
        self._sched = None if tenants is None else TenantScheduler(tenants)
        if models:
            if self._sched is None:
                raise ValueError(
                    "models= (co-resident models) requires tenants= — "
                    "requests route to a model through their "
                    "TenantClass(model=name)")
            for mname, m in models.items():
                if not isinstance(mname, str) or not mname:
                    raise ValueError(f"model names must be non-empty "
                                     f"strings, got {mname!r}")
                if not hasattr(m, "config"):
                    raise ValueError(
                        f"models[{mname!r}] must be a tpudp_torch model "
                        f"(the port's models hold their weights: JAX's "
                        f"(model, params) pair is one object here)")
                self._add_model(mname, m.to(self.device))
        if self._sched is not None:
            for tname in self._sched.names:
                route = self._sched.cls(tname).model
                if route is not None and route not in self._mstates:
                    raise ValueError(
                        f"tenants[{tname!r}] routes to unregistered "
                        f"model {route!r} (registered: "
                        f"{sorted(k for k in self._mstates if k)})")
        if self._paged:
            self._build_page_pools()
        self._gens = [torch.Generator(device=self.device)
                      for _ in range(num_slots)]
        self._len = np.zeros(num_slots, np.int64)
        self._last = np.zeros(num_slots, np.int64)
        self._temps = np.zeros(num_slots, np.float32)
        self._topk = np.zeros(num_slots, np.int64)
        self._topp = np.ones(num_slots, np.float32)
        self.decode_fuse = decode_fuse
        self.fused_stream: collections.deque | None = None
        if fuse_stream:
            # A few windows' worth of tokens: overflow drops the oldest.
            self.fused_stream = collections.deque(
                maxlen=max(4 * num_slots * decode_fuse, 64))
        self._slots: list[Request | None] = [None] * num_slots
        self._queue: collections.deque[Request] = collections.deque()
        self._next_id = 0
        self._admitted = 0
        self._accepting = True
        self._closed = False
        self.stats = collections.Counter()
        self.drafter_timeout_s = drafter_timeout_s
        self._watchdog = watchdog
        self._step_timeout_s = step_timeout_s
        self.step_fault_hook = step_fault_hook
        self.token_fault_hook = token_fault_hook
        self._device_calls = 0
        self.last_step_error: BaseException | None = None
        # The serving canary: its reference is pinned by the first clean
        # completion; a later mismatch quarantines the engine.
        self.canary_every_s = canary_every_s
        if canary_prompt is None:
            canary_prompt = np.arange(1, 9, dtype=np.int32) % cfg.vocab_size
        self._canary_prompt = np.asarray(canary_prompt, np.int32)
        self._canary_new_tokens = canary_new_tokens
        self._canary_ref: tuple | None = None
        self._canary_active: Request | None = None
        self._canary_last = -float("inf")  # the first canary starts at once
        self._quarantined = False
        self.quarantine_reason: str | None = None

    # -- model registry ------------------------------------------------

    def _add_model(self, name: str | None, model) -> None:
        """Register one model behind the scheduler: its paged dispatch
        table, or its own dense arena (the engine's slot geometry) and
        dense prefix cache (cached KV is a function of model and tokens,
        so blocks never cross models).  Paged stores are carved once
        every model is registered (:meth:`_build_page_pools`)."""
        cfg = model.config
        if name is not None:
            validate_decode_config(cfg, f"Engine(models[{name!r}])")
            if cfg.max_seq_len < self.max_len:
                raise ValueError(
                    f"models[{name!r}] max_seq_len ({cfg.max_seq_len}) "
                    f"is below the engine arena max_len ({self.max_len}) "
                    f"— co-resident models share the slot geometry")
            dcfg = getattr(self.drafter, "config", None)
            if dcfg is not None and dcfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"drafter vocab_size ({dcfg.vocab_size}) must match "
                    f"co-resident model {name!r}'s ({cfg.vocab_size}) — "
                    f"speculation requires a shared tokenizer")
        ms = _ModelState(name, model)
        if self._paged:
            ms.dispatch = paged_dispatch(
                self.paged_attn, self.kv_dtype, cfg.d_model // cfg.num_heads,
                len(self.speculate_tree.parents)
                if self.speculate_tree is not None else None)
        else:
            ms.cache = KVCache.zeros(cfg, self.num_slots, self.max_len,
                                     self.device)
            if self._prefix_cache_blocks:
                ms.prefix_cache = PrefixCache(cfg, self._prefix_cache_blocks,
                                              self.prefill_chunk,
                                              self.device)
        self._mstates[name] = ms

    def _build_page_pools(self) -> None:
        """Carve ``kv_pages`` across the registered models' KV-geometry
        groups: models of one (layers, kv_heads, head_dim, dtype) share
        one ``PagePool``, distinct geometries split the pages evenly.
        Each model gets its own radix index over its group's pool and its
        own block table."""
        groups: dict[tuple, list[_ModelState]] = {}
        for ms in self._mstates.values():
            cfg = ms.config
            key = (cfg.num_layers, getattr(cfg, "kv_heads", cfg.num_heads),
                   cfg.d_model // cfg.num_heads, str(cfg.dtype))
            groups.setdefault(key, []).append(ms)
        per_group = self.kv_pages // len(groups)
        if per_group < self._max_pages:
            raise ValueError(
                f"kv_pages ({self.kv_pages}) carves to {per_group} pages "
                f"per KV-geometry group ({len(groups)} groups) — below "
                f"the {self._max_pages} pages one max_len "
                f"({self.max_len}) request needs; raise kv_pages")
        for members in groups.values():
            pool = PagePool(members[0].config, per_group,
                            self.prefill_chunk, self.device, self.kv_dtype)
            for ms in members:
                ms.pool = pool
                ms.index = PageIndex(pool)
                ms.table = np.full((self.num_slots, self._max_pages), -1,
                                   np.int32)
                ms.slot_nodes = [dict() for _ in range(self.num_slots)]

    def _pools(self) -> list:
        """The distinct page pools, in model registration order."""
        pools: list = []
        for ms in self._mstates.values():
            if ms.pool is not None and all(p is not ms.pool for p in pools):
                pools.append(ms.pool)
        return pools

    @property
    def page_pool(self):
        """The default model's ``PagePool`` (None unpaged); co-resident
        models of its KV geometry share this object."""
        return self._mstates[None].pool

    @property
    def page_index(self):
        """The default model's radix ``PageIndex`` (None unpaged)."""
        return self._mstates[None].index

    @property
    def prefix_cache(self):
        """The default model's dense ``PrefixCache`` (None when off)."""
        return self._mstates[None].prefix_cache

    @property
    def _window(self) -> FusedWindow | None:
        """The default model's fused decode window (None until built)."""
        return self._mstates[None].window

    @property
    def _spec_window(self) -> FusedSpecWindow | None:
        return self._mstates[None].spec_window

    @property
    def tenant_stats(self) -> dict:
        """Per-tenant counters ``{name: Counter}``: submitted, admitted
        (fresh grants), readmitted (resumes after preemption or a
        requeue), shed, preempted, page_pressure_vacates, tokens, and one
        count per finish reason.  Empty with tenancy off."""
        if self._sched is None:
            return {}
        return {name: self._sched.stats(name) for name in self._sched.names}

    # -- submission ----------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, *,
               temperature: float = 0.0, top_k: int | None = None,
               top_p: float | None = None, seed: int = 0,
               eos_id: int | None = None, deadline_s: float | None = None,
               ttft_deadline_s: float | None = None,
               tenant: str | None = None) -> Request:
        """Queue one generation request; returns its streaming handle.
        ``temperature=0`` is greedy (``top_k``/``top_p`` rejected);
        otherwise softmax sampling truncated to top-k and/or the top-p
        nucleus from a generator seeded with ``seed``.  ``eos_id`` ends
        the request early when sampled (and is included in
        ``tokens``).  ``deadline_s`` bounds the request's wall time from
        submit, ``ttft_deadline_s`` its wait for the first token; an
        expired request retires with ``FinishReason.DEADLINE`` at the
        next step, its tokens kept.  ``tenant`` names the request's class
        on a tenant-aware engine: the class's ``queue_limit`` bounds its
        queue, its ``default_deadline_s`` fills a missing ``deadline_s``
        and its ``model`` routes the request; None resolves to the class
        named ``"default"``.  Raises :class:`EngineClosed` once
        :meth:`drain`/:meth:`close` began and :class:`QueueFull` when
        ``queue_limit`` requests (engine-wide, or the class's) are
        waiting."""
        if not self._accepting:
            raise EngineClosed("Engine.drain()/close() was called; the "
                               "engine no longer accepts work")
        tname = tc = None
        if self._sched is not None:
            tname = self._sched.resolve(tenant)
            tc = self._sched.cls(tname)
        elif tenant is not None:
            raise ValueError(
                "submit(tenant=...) requires Engine(tenants=...) — this "
                "engine has no tenant classes configured")
        if (self.queue_limit is not None
                and self.queue_depth >= self.queue_limit):
            self.stats["shed"] += 1
            if tname is not None:
                self._sched.stats(tname)["shed"] += 1
            raise QueueFull(f"queue_limit ({self.queue_limit}) queued "
                            f"requests already waiting; request refused")
        if tc is not None and self._sched.full(tname):
            self.stats["shed"] += 1
            self._sched.stats(tname)["shed"] += 1
            raise QueueFull(
                f"tenant {tname!r} queue_limit ({tc.queue_limit}) queued "
                f"requests already waiting; request refused (shed)")
        if tc is not None and deadline_s is None:
            deadline_s = tc.default_deadline_s  # the class-wide SLO
        ms = self._mstates[tc.model if tc is not None else None]
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("prompt must hold at least one token")
        vocab = ms.config.vocab_size
        if prompt.min() < 0 or prompt.max() >= vocab:
            raise ValueError(f"prompt ids must be in [0, {vocab})")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if prompt.size + max_new_tokens + self.speculate_k > self.max_len:
            spec = (f" + speculate_k ({self.speculate_k} scratch "
                    f"positions for the verify window)"
                    if self.speculate_k else "")
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens "
                f"({max_new_tokens}){spec} exceeds the arena max_len "
                f"({self.max_len})")
        if temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        if (top_k is not None or top_p is not None) and temperature == 0.0:
            raise ValueError("top_k/top_p require temperature > 0 (greedy "
                             "decoding ignores them)")
        if top_k is not None and top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {top_k}")
        if top_p is not None and not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if eos_id is not None and not 0 <= eos_id < vocab:
            raise ValueError(f"eos_id must be in [0, {vocab})")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        if ttft_deadline_s is not None and ttft_deadline_s <= 0:
            raise ValueError(
                f"ttft_deadline_s must be > 0, got {ttft_deadline_s}")
        r = Request(self, self._next_id, prompt, max_new_tokens,
                    float(temperature), int(top_k or 0),
                    float(1.0 if top_p is None else top_p), seed, eos_id,
                    deadline_s, ttft_deadline_s, tname)
        r._ms = ms
        self._next_id += 1
        if self._sched is not None:
            self._sched.enqueue(r)
            self._sched.stats(tname)["submitted"] += 1
        else:
            self._queue.append(r)
        self.stats["submitted"] += 1
        return r

    def generate_many(self, prompts, max_new_tokens: int, *,
                      temperature: float = 0.0, top_k: int | None = None,
                      top_p: float | None = None, seed: int = 0,
                      eos_id: int | None = None) -> list[np.ndarray]:
        """Submit every prompt (request ``i`` seeded ``seed + i``), run to
        completion, return the full sequences in submission order.  If a
        submit raises, the prompts already queued are cancelled first."""
        handles = []
        try:
            for i, p in enumerate(prompts):
                handles.append(
                    self.submit(p, max_new_tokens, temperature=temperature,
                                top_k=top_k, top_p=top_p, seed=seed + i,
                                eos_id=eos_id))
        except Exception:
            for h in handles:
                self.cancel(h)
            raise
        self.run_until_complete()
        return [h.result() for h in handles]

    # -- scheduling ----------------------------------------------------

    @torch.no_grad()
    def step(self) -> list[tuple[Request, int]]:
        """One scheduler iteration: expire deadlines, preempt
        lower-priority slots for waiting higher-priority work (tenancy),
        admit queued requests into free slots, run at most one prefill
        chunk, then for each model with decoding slots one batched step
        — a tree verify window, a fused speculation window, a sequence
        verify window, a fused decode window or a plain decode step, in
        that order of preference.  Returns the ``(request, token)``
        pairs emitted (a canary's never among them).

        An exception escaping the iteration is contained
        (:meth:`_contain_step_failure`); a closed or quarantined
        engine's step does nothing."""
        emitted: list[tuple[Request, int]] = []
        if self._closed or self._quarantined:
            return emitted
        self._maybe_canary()
        if self._quarantined:
            return emitted  # the canary just condemned this engine
        try:
            self._expire_deadlines()
            if self._sched is not None:
                self._preempt_for_priority()
            self._admit()
            slot = self._next_prefill_slot()
            if slot is not None:
                self._run_prefill_chunk(slot, emitted)
            # Fuse only on pure-decode iterations: nothing queued
            # (admission and preemption must not wait on a slot a window
            # would free) and nothing prefilling (a chunk must not stall
            # behind a window).  Deadlines do not gate fusing: expiry is
            # seen at the window's edge.
            fuse = (self.decode_fuse > 1 and self.queue_depth == 0
                    and self._next_prefill_slot() is None)
            for ms in self._mstates.values():
                active = self._decoding(ms)
                if active.any() and self._paged:
                    # Back every table entry the step writes before
                    # dispatch; page pressure resolves here, on the host.
                    active = self._ensure_decode_pages(ms, active, fuse)
                if not active.any():
                    continue
                if self._speculating:
                    if self.speculate_tree is not None:
                        self._run_verify_tree(ms, active, emitted)
                    elif fuse and self._spec_fusable:
                        self._run_spec_fused(ms, active, emitted)
                    else:
                        self._run_verify(ms, active, emitted)
                elif fuse:
                    self._run_decode_fused(ms, active, emitted)
                else:
                    self._run_decode(ms, active, emitted)
        except (BuildError, CaptureError):
            raise  # a fault of the program, not of a step
        except Exception as exc:  # noqa: BLE001 — containment by design
            self._contain_step_failure(exc)
        self.stats["steps"] += 1
        if self.canary_every_s is not None:
            emitted = [(r, t) for r, t in emitted if not r._canary]
        return emitted

    def cancel(self, request: Request) -> bool:
        """Retire ``request`` now, queued or in flight; False if it had
        already finished."""
        if request.done:
            return False
        if request._slot is not None:
            self._retire(request._slot, FinishReason.CANCELLED)
            return True
        if self._sched is not None:
            self._sched.remove(request)
        else:
            self._queue.remove(request)
        self._finish(request, FinishReason.CANCELLED)
        return True

    def run_until_complete(self) -> None:
        """Drive the engine until every queue and every slot is empty;
        stops early once a canary quarantined the engine (its live
        requests stay in place, unfinished)."""
        while self.queue_depth or any(r is not None for r in self._slots):
            if self._quarantined:
                return
            self.step()

    def drain(self) -> None:
        """Graceful shutdown: stop admission (``submit`` raises
        :class:`EngineClosed`), finish every queued and in-flight
        request, of every tenant class, then close.  Idempotent."""
        self._accepting = False
        self.run_until_complete()
        self._closed = True

    def close(self) -> None:
        """Immediate shutdown: stop admission, retire in-flight requests
        as ``CANCELLED`` (no prefix is published) and queued ones as
        ``SHED``, walking every tenant queue.  Idempotent."""
        self._accepting = False
        if self._sched is not None:
            for r in self._sched.drain_all():
                self._finish(r, FinishReason.SHED)
        while self._queue:
            self._finish(self._queue.popleft(), FinishReason.SHED)
        for s, r in enumerate(self._slots):
            if r is not None:
                self._retire(s, FinishReason.CANCELLED)
        self._closed = True

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def accepting(self) -> bool:
        """False once :meth:`drain`/:meth:`close` has begun (or a canary
        quarantined the engine)."""
        return self._accepting

    @property
    def drafter_quarantined(self) -> bool:
        """True once the drafter is quarantined for good
        (``drafter_quarantine_reason`` says why)."""
        return self._drafter_quarantined

    @property
    def quarantined(self) -> bool:
        """True once a canary mismatch condemned this engine
        (``quarantine_reason`` says why): it admits and steps no more."""
        return self._quarantined

    @property
    def slots_in_use(self) -> int:
        return sum(r is not None for r in self._slots)

    @property
    def queue_depth(self) -> int:
        """Requests submitted and not yet admitted (over every tenant
        class)."""
        if self._sched is not None:
            return self._sched.depth()
        return len(self._queue)

    @property
    def acceptance_rate(self) -> float | None:
        """Engine-wide accepted / proposed draft tokens (None before the
        drafter's first proposal)."""
        if not self.stats["draft_tokens"]:
            return None
        return self.stats["draft_accepted"] / self.stats["draft_tokens"]

    @property
    def _speculating(self) -> bool:
        return bool(self.speculate_k) and not self._drafter_quarantined

    def metrics(self) -> dict:
        """Host counters, occupancy, the attention backend and, per
        ported kernel, its launch count in this process."""
        out = {
            "stats": dict(self.stats),
            "queue_depth": self.queue_depth,
            "slots_in_use": self.slots_in_use,
            "num_slots": self.num_slots,
            "device": str(self.device),
            "kernel_launches": {name: fn.launches
                                for name, fn in KERNELS.items()},
        }
        if self._sched is not None:
            out["tenants"] = {name: dict(c)
                              for name, c in self.tenant_stats.items()}
        if self._paged:
            out["page_pools"] = [
                {"num_pages": p.num_pages, "used_pages": p.used_pages,
                 "free_pages": p.free_pages, "page_bytes": p.page_bytes(),
                 "kv_dtype": p.kv_dtype} for p in self._pools()]
            # The default model's table; a co-resident model's fallbacks
            # (another head dim) are listed too.
            out["paged_attn"] = {
                "requested": self.paged_attn_requested,
                "resolved": self.paged_attn,
                "dispatch": dict(self.paged_attn_dispatch),
                "fallbacks": sorted(
                    {f for ms in self._mstates.values()
                     for f, impl in ms.dispatch.items()
                     if self.paged_attn == "kernel" and impl != "kernel"})}
        if self.stats.get("draft_tokens"):
            out["acceptance_rate"] = self.acceptance_rate
        for key, attr in (("fused_window", "window"),
                          ("fused_spec_window", "spec_window")):
            built = [getattr(ms, attr) for ms in self._mstates.values()
                     if getattr(ms, attr) is not None]
            if built:  # summed over the models' windows
                out[key] = {"decode_fuse": self.decode_fuse,
                            "graph": all(w.graph is not None
                                         for w in built),
                            "captures": sum(w.captures for w in built),
                            "replays": sum(w.replays for w in built)}
        if self.canary_every_s is not None or self._quarantined:
            out["canary"] = {
                "runs": self.stats["canary_runs"],
                "errors": self.stats["canary_errors"],
                "skipped": self.stats["canary_skipped"],
                "mismatch": self.stats["canary_mismatch"],
                "ref_pinned": self._canary_ref is not None,
                "quarantined": self._quarantined,
                "quarantine_reason": self.quarantine_reason}
        return out

    # -- internals -----------------------------------------------------

    def _decoding(self, ms: _ModelState) -> np.ndarray:
        return np.array([r is not None and r._nfill == r._fill.size
                         and r._ms is ms for r in self._slots])

    def _pop_next(self) -> Request | None:
        """The next request to admit: FIFO without tenancy; highest
        priority, then stride, with it."""
        if self._sched is not None:
            return self._sched.pop_next()
        return self._queue.popleft() if self._queue else None

    def _admit(self) -> None:
        for s in range(self.num_slots):
            if self._slots[s] is not None:
                continue
            r = self._pop_next()
            if r is None:
                break
            r._slot = s
            r._order = self._admitted
            self._admitted += 1
            self._slots[s] = r
            self._len[s] = 0
            self._temps[s] = r.temperature
            self._topk[s] = r.top_k
            self._topp[s] = r.top_p
            # A vacated request resumes its own generator state, so its
            # remaining draws are those of an uninterrupted run.
            if r._resume_key is not None:
                self._gens[s].set_state(r._resume_key)
            else:
                self._gens[s].manual_seed(r.seed)
            self.stats["admitted"] += 1
            if r.tenant is not None:
                # A resume is not a fresh grant: the class's admitted
                # share stays the one its weight set.
                self._sched.stats(r.tenant)[
                    "readmitted" if r._resume_key is not None
                    else "admitted"] += 1
            if self._paged:
                self._admit_prefix_paged(r._ms, s, r)
            elif r._ms.prefix_cache is not None:
                self._admit_prefix(r._ms, s, r)

    def _admit_prefix(self, ms: _ModelState, s: int, r: Request) -> None:
        """Dense cache-hit admission: copy the longest cached
        block-aligned prefix of the fill into the slot's arena rows and
        skip that much prefill.  The hit stops one chunk short of the
        fill, so the final chunk's logits feed the next sampling event,
        as a cold run's do.  Hit blocks are pinned during the copies."""
        cache = ms.prefix_cache
        self.stats["prefix_lookups"] += 1
        blocks = cache.lookup(r._fill)
        n_copy = min(len(blocks), (r._fill.size - 1) // self.prefill_chunk)
        hit = n_copy * self.prefill_chunk
        self.stats["prefix_hit_tokens"] += hit
        if not n_copy:
            return
        cache.pin(blocks[:n_copy])
        try:
            for i in range(n_copy):
                self._device("prefix_in", copy_block_in, ms.cache,
                             cache.pool, blocks[i], s,
                             i * self.prefill_chunk)
        finally:
            cache.unpin(blocks[:n_copy])
        r._nfill = hit
        self._len[s] = hit

    def _publish_prefix(self, ms: _ModelState, s: int, r: Request) -> None:
        """Retirement-time publish of the slot's block-aligned
        chunk-prefilled prefix (``r._nfill``; decode and verify KV never
        qualifies): paged, an ownership transfer
        (:meth:`_publish_prefix_paged`); dense, insert-or-ref in the
        cache and a copy out of the arena for each new block.  A failed
        dense publish flushes the cache and the retirement goes on; a
        watchdog hang surfacing in it flushes and re-raises, for the
        step's containment."""
        if self._paged:
            self._publish_prefix_paged(ms, s, r)
            return
        cache = ms.prefix_cache
        n_blocks = min(r._nfill, r._fill.size) // self.prefill_chunk
        if not n_blocks:
            return
        try:
            new = cache.publish(r._fill, n_blocks)
            for block, start in new:
                self._device("prefix_out", copy_block_out, ms.cache,
                             cache.pool, block, s, start)
            self.stats["prefix_published_blocks"] += len(new)
        except StepHangError:
            cache.flush(reallocate=True)
            self.stats["prefix_flushes"] += 1
            raise
        except Exception as exc:  # noqa: BLE001 — publish is best-effort
            cache.flush(reallocate=True)
            self.stats["prefix_flushes"] += 1
            self.stats["prefix_publish_failures"] += 1
            self.last_step_error = exc

    # -- paged attention internals (Engine(kv_pages=N)) ----------------

    def _admit_prefix_paged(self, ms: _ModelState, s: int,
                            r: Request) -> None:
        """Map the longest cached page-aligned prefix of the fill into
        the slot's table: a refcount bump per page, no KV copy.  The hit
        stops one chunk short of the fill, so the final chunk is always
        prefilled — into a fresh private page (copy-on-write)."""
        self.stats["prefix_lookups"] += 1
        nodes = ms.index.lookup(r._fill)
        n_map = min(len(nodes), (r._fill.size - 1) // self.prefill_chunk)
        hit = n_map * self.prefill_chunk
        self.stats["prefix_hit_tokens"] += hit
        if not n_map:
            return
        for i, node in enumerate(nodes[:n_map]):
            ms.index.pin(node)
            ms.pool.share(node.block)
            ms.table[s, i] = node.block
            ms.slot_nodes[s][node.block] = node
        r._nfill = hit
        self._len[s] = hit

    def _publish_prefix_paged(self, ms: _ModelState, s: int,
                              r: Request) -> None:
        """Transfer the slot's chunk-prefilled pages to the radix index
        (host metadata only: the index takes a reference per new page)."""
        n_blocks = min(r._nfill, r._fill.size) // self.prefill_chunk
        if not n_blocks:
            return
        pages = [int(ms.table[s, i]) for i in range(n_blocks)]
        if any(p < 0 for p in pages):  # never expected: prefill allocates
            return
        self.stats["prefix_published_blocks"] += ms.index.adopt(
            r._fill, pages)

    def _release_slot_pages(self, ms: _ModelState, s: int) -> None:
        """Drop every page reference slot ``s`` holds and clear its
        table row."""
        if not self._paged:
            return
        for pidx in range(self._max_pages):
            page = int(ms.table[s, pidx])
            if page < 0:
                continue
            node = ms.slot_nodes[s].pop(page, None)
            if node is not None:
                ms.index.unpin(node)
            ms.pool.release(page)
        ms.table[s] = -1
        ms.slot_nodes[s] = {}

    def _alloc_page(self, ms: _ModelState, protect: int) -> int | None:
        """One exclusive page for slot ``protect``: evict cold index
        leaves first, then vacate the most recently admitted other
        slot.  None only if slot ``protect`` alone cannot be served."""
        while True:
            page = ms.pool.alloc()
            if page is not None:
                return page
            if self._evict_index_page(ms.pool):
                continue
            victim = self._page_pressure_victim(ms.pool, protect)
            if victim is None:
                return None
            self._vacate_for_pages(victim)

    def _evict_index_page(self, pool) -> bool:
        """Evict the least-recently-touched unreferenced leaf over every
        index sharing ``pool`` (each index's own clock, ties to the
        earlier registered model)."""
        coldest = [(node, ms.index) for ms in self._mstates.values()
                   if ms.pool is pool
                   for node in (ms.index._coldest(),) if node is not None]
        if not coldest:
            return False
        node, index = min(coldest, key=lambda c: c[0].stamp)
        index.evict_node(node)
        return True

    def _page_pressure_victim(self, pool, protect: int) -> int | None:
        """Among slots drawing on ``pool`` other than ``protect``: the
        lowest priority under tenancy, then the most recently admitted —
        the least sunk cost, so the oldest request always progresses."""
        victims = [s for s, r in enumerate(self._slots)
                   if r is not None and s != protect
                   and r._ms.pool is pool]
        if not victims:
            return None
        if self._sched is not None:
            return max(victims,
                       key=lambda s: (-self._priority_of(self._slots[s]),
                                      self._slots[s]._order))
        return max(victims, key=lambda s: self._slots[s]._order)

    def _requeue_front(self, r: Request) -> None:
        """Previously admitted work back at the front of its queue (its
        class's, under tenancy)."""
        if self._sched is not None:
            self._sched.requeue_front(r)
        else:
            self._queue.appendleft(r)

    def _vacate_for_pages(self, s: int) -> None:
        """Evict slot ``s`` to free its pages: publish its prefilled
        prefix (the pages stay as evictable cache, so the resume mostly
        maps them back), vacate, and requeue at the front."""
        r = self._slots[s]
        if self._accepting:
            self._publish_prefix_paged(r._ms, s, r)
        self._vacate_slot(s)
        self.stats["page_pressure_vacates"] += 1
        if r.tenant is not None:
            self._sched.stats(r.tenant)["page_pressure_vacates"] += 1
        self._requeue_front(r)

    def _ensure_pages(self, ms: _ModelState, s: int, upto: int) -> bool:
        """Allocate slot ``s``'s table entries covering positions
        ``[0, upto)``.  Returns False iff the pool cannot back the slot
        even alone, which the kv_pages validation rules out: the slot
        then retires with ``ERROR`` instead of writing to the scratch
        page."""
        need = min((upto + self.prefill_chunk - 1) // self.prefill_chunk,
                   self._max_pages)
        for pidx in range(need):
            if ms.table[s, pidx] >= 0:
                continue
            page = self._alloc_page(ms, protect=s)
            if page is None:
                self._retire(s, FinishReason.ERROR, error=RuntimeError(
                    f"page pool exhausted backing slot {s} to position "
                    f"{upto} — kv_pages too small for the admitted "
                    f"workload"))
                return False
            ms.table[s, pidx] = page
        return True

    def _ensure_decode_pages(self, ms: _ModelState, active,
                             fuse: bool = False) -> np.ndarray:
        """Back the pages the step writes for each active slot — its
        next token, the whole ``k + 1`` verify window when speculating,
        the fused speculation window's up to ``N (k + 1)`` commits plus
        the last verify window's ``k`` positions past them, or the fused
        window's tokens up to the request's budget — before dispatch;
        returns the active mask recomputed after any page-pressure
        vacates.  As in the dispatch, a live drafter's window wins over
        fusing: backing only the fused window's positions would send the
        verify window's tail to the scratch page."""
        k = self.speculate_k
        for s in np.nonzero(active)[0]:
            r = self._slots[s]
            if r is None:
                continue
            if self._speculating and fuse and self._spec_fusable:
                ahead = min(r.max_new_tokens - len(r.tokens),
                            self.decode_fuse * (k + 1)) + k
            elif self._speculating:
                ahead = k + 1
            elif fuse:
                ahead = min(r.max_new_tokens - len(r.tokens),
                            self.decode_fuse)
            else:
                ahead = 1
            self._ensure_pages(ms, s, int(self._len[s]) + ahead)
        return self._decoding(ms)

    def check_paged(self) -> None:
        """Table <-> pool <-> index consistency: pool and tree invariants,
        and each allocated page's refcount equal to its holders (one per
        owning index node plus one per table entry mapping it)."""
        if not self._paged:
            return
        for ms in self._mstates.values():
            ms.index.check()
            for s in range(self.num_slots):
                for page, node in ms.slot_nodes[s].items():
                    if ms.index._by_block.get(node.block) is not node:
                        raise RuntimeError(
                            f"slot {s} pins a node the index no longer "
                            f"holds (page {page})")
                    if page not in ms.table[s]:
                        raise RuntimeError(f"slot {s} pins page {page} "
                                           f"absent from its table row")
        for pool in self._pools():
            expected: dict[int, int] = {}
            for ms in self._mstates.values():
                if ms.pool is not pool:
                    continue
                for page in list(ms.index.tree_refs()) + \
                        ms.table[ms.table >= 0].tolist():
                    expected[page] = expected.get(page, 0) + 1
            pool.check(expected)

    # -- the step loop ---------------------------------------------------

    def _finish(self, r: Request, reason: FinishReason,
                error: BaseException | None = None) -> None:
        # JAX's obs event of a finish is not ported (obs, ROADMAP.md).
        r.done = True
        r.finish_reason = reason
        r.error = error
        self.stats[_FINISH_COUNTER[reason]] += 1
        if r.tenant is not None:
            self._sched.stats(r.tenant)[_FINISH_COUNTER[reason]] += 1

    def _deadline_passed(self, r: Request, now: float) -> bool:
        waited = now - r.submit_time
        if r.deadline_s is not None and waited > r.deadline_s:
            return True
        return (r.ttft_deadline_s is not None and not r.tokens
                and waited > r.ttft_deadline_s)

    def _expire_deadlines(self) -> None:
        """Retire every queued or in-flight request whose wall-clock
        budget has run out (``FinishReason.DEADLINE``), before
        admission, so a request dead on arrival never takes a slot."""
        now = time.perf_counter()
        queued = (self._sched.queued() if self._sched is not None
                  else self._queue)
        for r in [r for r in queued if self._deadline_passed(r, now)]:
            if self._sched is not None:
                self._sched.remove(r)
            else:
                self._queue.remove(r)
            self._finish(r, FinishReason.DEADLINE)
        for s, r in enumerate(self._slots):
            if r is not None and self._deadline_passed(r, now):
                self._retire(s, FinishReason.DEADLINE)

    def _guard(self, timeout_s: float | None, name: str):
        """The watchdog's scoped deadline (nothing without a watchdog);
        ``name`` labels the region in a hang report."""
        if self._watchdog is None:
            return contextlib.nullcontext()
        return self._watchdog.step(timeout_s, name=name)

    def _device(self, kind: str, fn, *args, guard_timeout_s=None):
        """Run one device call behind the robustness seams: the fault
        hook (``step_fault_hook(kind, index)``, ``index`` counting every
        device call, so a retried call gets a new one), then ``fn``
        under the watchdog's scoped deadline — ``guard_timeout_s``, or
        ``step_timeout_s`` — named ``kind`` (prefill, sample, decode,
        verify, tree_verify, fused_decode, fused_spec).  A call on the
        card is timed to its fetch, which every caller makes inside
        ``fn``.  JAX wraps each call in an obs span too: not ported
        (obs, ROADMAP.md slice 8)."""
        idx = self._device_calls
        self._device_calls += 1
        with self._guard(guard_timeout_s if guard_timeout_s is not None
                         else self._step_timeout_s, kind):
            if self.step_fault_hook is not None:
                self.step_fault_hook(kind, idx)
            return fn(*args)

    def _reset_stores(self) -> None:
        """Containment's reset of every model's KV store, in place: the
        captured windows hold the addresses of the pools (or arenas), so
        JAX's reallocation would leave their replays reading freed
        memory.  Paged: every page of each shared pool zeroed (int8
        scales back to 1) and freed once, every model's index, table and
        pins cleared; dense: each arena zeroed and its prefix cache
        flushed.  The survivors re-prefill into them, as in JAX."""
        for pool in self._pools():
            pool.reset()
        for ms in self._mstates.values():
            if self._paged:
                ms.index.reset()
                ms.table[:] = -1
                ms.slot_nodes = [dict() for _ in range(self.num_slots)]
                self.stats["prefix_flushes"] += 1
                continue
            ms.cache.k.zero_()
            ms.cache.v.zero_()
            if ms.prefix_cache is not None:
                ms.prefix_cache.flush(reallocate=True)
                self.stats["prefix_flushes"] += 1

    def _contain_step_failure(self, exc: BaseException) -> None:
        """An exception escaped a step: reset the KV store (the failed
        call may have left it half written) and requeue each in-flight
        request once, at the front in admission order, with its tokens
        and generator state: its re-prefill of ``prompt + tokens``
        continues it exactly.  A request failing a second time retires
        with ``ERROR``.  Queued requests are untouched.  JAX's obs event
        and flight-recorder dump here are not ported (obs, ROADMAP.md
        slice 8)."""
        self.stats["step_failures"] += 1
        self.last_step_error = exc
        if self._watchdog is not None:
            self._watchdog.acknowledge()  # handled; the next scope may run
        self._reset_stores()
        survivors: list[Request] = []
        for s in sorted((s for s, r in enumerate(self._slots)
                         if r is not None),
                        key=lambda s: self._slots[s]._order):
            r = self._vacate_slot(s)
            if r._requeued:
                self._finish(r, FinishReason.ERROR, error=exc)
            else:
                r._requeued = True
                survivors.append(r)
                self.stats["requeued"] += 1
        # Admitted work goes back to the front (of its class) in
        # admission order; queue_limit never applies to it (shedding it
        # would turn a transient fault into lost work).
        for r in reversed(survivors):
            self._requeue_front(r)

    def _next_prefill_slot(self) -> int | None:
        """The slot whose next prefill chunk runs: the oldest admitted
        request still prefilling, the highest priority first under
        tenancy (a tier's TTFT must not wait behind a lower tier's
        prompt)."""
        pending = [(-self._priority_of(r) if self._sched else 0, r._order,
                    s) for s, r in enumerate(self._slots)
                   if r is not None and r._nfill < r._fill.size]
        return min(pending)[2] if pending else None

    def _to_device(self, a, dtype=torch.int64) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device, dtype)

    def _run_prefill_chunk(self, s: int, emitted) -> None:
        r = self._slots[s]
        ms = r._ms
        fill = r._fill
        start = r._nfill
        end = min(start + self.prefill_chunk, fill.size)
        buf = np.zeros((1, self.prefill_chunk), np.int64)
        buf[0, :end - start] = fill[start:end]
        tokens = self._to_device(buf)
        if self._paged:
            # Back the chunk's page first (page-pressure vacates only hit
            # OTHER slots), then prefill through the slot's table row.
            if not self._ensure_pages(ms, s, end):
                return  # the slot retired with ERROR
            logits, _ = self._device(
                "prefill", _forward_paged, ms.model, tokens, ms.pool.pages,
                self._to_device(ms.table[s][None], torch.int32), start,
                torch.ones(1, dtype=torch.bool, device=self.device),
                ms.dispatch["prefill_paged"])
        else:
            row = KVCache(ms.cache.k[:, s:s + 1], ms.cache.v[:, s:s + 1])
            logits, _ = self._device("prefill", _forward_cached, ms.model,
                                     tokens, row, start)
        r._nfill = end
        self._len[s] = end
        self.stats["prefill_chunks"] += 1
        if end == fill.size:
            if r.eos_id is not None and r.tokens \
                    and r.tokens[-1] == r.eos_id:
                self._retire(s, FinishReason.EOS)
                return
            if len(r.tokens) >= r.max_new_tokens:
                self._retire(s, FinishReason.COMPLETE)
                return
            # The fill's last-token logits are the request's next
            # sampling event (for a fresh request, its first token).
            tok = self._device(
                "sample", lambda: int(_sample_row(
                    logits[:, end - start - 1], self._temps[s],
                    self._topk[s], self._topp[s], self._gens[s])))
            self._commit(s, tok, emitted)

    def _run_decode(self, ms: _ModelState, active, emitted) -> None:
        lengths = self._to_device(self._len, torch.int32)
        act = self._to_device(active, torch.bool)
        if self._paged:
            table = self._to_device(ms.table, torch.int32)

            def forward(pool, tokens, lens, act):
                return _forward_paged(ms.model, tokens, pool, table, lens,
                                      act,
                                      impl=ms.dispatch["decode_paged"])
            state = ms.pool.pages
        else:
            def forward(cache, tokens, lens, act):
                return _forward_cached(ms.model, tokens, cache, lens)
            state = ms.cache
        toks = self._device("decode", lambda: _decode_math(
            forward, state, self._to_device(self._last_of(active)),
            lengths, act,
            self._temps, self._topk, self._topp,
            self._gens)[1].cpu().numpy())
        self.stats["decode_steps"] += 1
        self.stats["active_slot_steps"] += int(active.sum())
        for s in np.nonzero(active)[0]:
            self._len[s] += 1  # the fed token's KV landed this step
            self._commit(int(s), int(toks[s]), emitted)

    def _window_forward(self, ms: _ModelState, family: str):
        """A fused window's forward over the model's KV store: the paged
        pool through the window's own block table (``family``'s impl), or
        the dense arena."""
        if self._paged:
            impl = ms.dispatch[family]

            def forward(tokens, lens, running, table):
                return _forward_paged(ms.model, tokens, ms.pool.pages,
                                      table, lens, running, impl=impl)[0]
        else:
            def forward(tokens, lens, running, table):
                return _forward_cached(ms.model, tokens, ms.cache, lens)[0]
        return forward

    def _fused_window(self, ms: _ModelState) -> FusedWindow:
        """The model's fused decode window, built at its first use."""
        if ms.window is None:
            ms.window = FusedWindow(
                self._window_forward(ms, "fused_decode_paged"),
                num_slots=self.num_slots, n_steps=self.decode_fuse,
                table_pages=self._max_pages if self._paged else None,
                generators=self._gens, device=self.device)
        return ms.window

    def _spec_fused_window(self, ms: _ModelState) -> FusedSpecWindow:
        """The model's fused speculation window, built at its first use:
        its draft store is allocated once, its graph captured once."""
        if ms.spec_window is None:
            ms.spec_window = FusedSpecWindow(
                self._window_forward(ms, "fused_spec_paged"),
                self.drafter.model, num_slots=self.num_slots,
                n_steps=self.decode_fuse, k=self.speculate_k,
                hist_len=self.max_len,
                table_pages=self._max_pages if self._paged else None,
                generators=self._gens, device=self.device)
        return ms.spec_window

    def _window_values(self, ms: _ModelState, active) -> dict:
        """A window's inputs: the host's per-slot state, each active
        request's remaining budget and EOS id (-1: none), and the block
        table."""
        budgets = np.zeros(self.num_slots, np.int64)
        eos = np.full(self.num_slots, -1, np.int64)
        for s in np.nonzero(active)[0]:
            r = self._slots[s]
            budgets[s] = r.max_new_tokens - len(r.tokens)
            if r.eos_id is not None:
                eos[s] = r.eos_id
        values = dict(last=self._last_of(active), lens=self._len,
                      running=active,
                      temps=self._temps, top_k=self._topk, top_p=self._topp,
                      budgets=budgets, eos=eos)
        if self._paged:
            values["table"] = ms.table
        return values

    def _run_window(self, kind: str, window, values: dict, steps: int,
                    budget_s: float | None):
        """Run one fused window behind the device seam and give the
        generators back their pre-window states (also when the window
        fails): :meth:`_replay_window` hands each slot its post-window
        state just before that slot's commits.  Returns the window's
        outputs and the post-window states."""
        before = [g.get_state() for g in self._gens]
        try:
            out = self._device(kind, window.run, values, steps,
                               guard_timeout_s=budget_s)
            after = [g.get_state() for g in self._gens]
        finally:  # a failed window leaves every slot where it was
            for g, state in zip(self._gens, before):
                g.set_state(state)
        return out, after

    def _replay_window(self, active, out, n_emit, after, emitted) -> None:
        """Commit each active slot's window tokens in order through
        ``_commit`` (retirements, timestamps, publishes and stats as
        single steps would leave them; ``_len`` and ``_last`` advance per
        commit).  Each slot takes its post-window generator state just
        before its own commits, so if containment interrupts the replay,
        every vacated slot's state matches its committed tokens: slots
        already replayed carry the window's state, later ones their
        pre-window state and none of the window's tokens."""
        for s in np.nonzero(active)[0]:
            r = self._slots[s]
            self._gens[s].set_state(after[s])
            for j in range(int(n_emit[s])):
                if self._slots[s] is not r:
                    break  # retired (EOS / budget / cancel) mid-replay
                self._len[s] += 1  # the fed token's KV landed
                self._commit(int(s), int(out[s, j]), emitted)

    def _window_budget_s(self, scale: int) -> float | None:
        """A fused window's watchdog budget: ``step_timeout_s`` times the
        single steps it stands for."""
        if self._step_timeout_s is None:
            return None
        return self._step_timeout_s * scale

    def _run_decode_fused(self, ms: _ModelState, active, emitted) -> None:
        """One fused window: up to ``decode_fuse`` decode iterations, one
        fetch, then the window's commits replayed slot by slot through
        the single-step path's ``_commit`` (:meth:`_replay_window`), so a
        later single step resumes exactly.  The window stops each row at
        its EOS or budget, so the replay's own retirement checks agree
        with it.  The host knows the budgets, so the window runs
        ``min(decode_fuse, largest budget)`` iterations; EOS stops are
        known only after the fetch."""
        values = self._window_values(ms, active)
        (out, n_emit, iters), after = self._run_window(
            "fused_decode", self._fused_window(ms), values,
            min(self.decode_fuse, int(values["budgets"].max())),
            self._window_budget_s(self.decode_fuse))
        self.stats["fused_windows"] += 1
        self.stats["fused_steps"] += iters
        # A row commits once per iteration it ran, so n_emit.sum() is the
        # window's active-slot-step count.
        self.stats["active_slot_steps"] += int(n_emit.sum())
        if self.fused_stream is not None:
            for j in range(int(n_emit.max())):
                self.fused_stream.extend(
                    (int(s), int(out[s, j]))
                    for s in np.nonzero(n_emit > j)[0])
        self._replay_window(active, out, n_emit, after, emitted)

    def _run_spec_fused(self, ms: _ModelState, active, emitted) -> None:
        """One fused speculation window: up to ``decode_fuse`` draft ->
        verify -> accept iterations (the draft model on the device, from
        each slot's token history), one fetch, acceptance charged, then
        the same replay as :meth:`_run_decode_fused`.  Each iteration
        commits at least one token a running row, so the window runs
        ``min(decode_fuse, largest budget)`` iterations."""
        k = self.speculate_k
        values = self._window_values(ms, active)
        hist = np.zeros((self.num_slots, self.max_len), np.int64)
        for s in np.nonzero(active)[0]:
            ctx = self._context(self._slots[s])
            hist[s, :ctx.size] = ctx  # fits: prompt + budget + k <= max_len
        values["hist"] = hist
        # An iteration runs a draft prefill, k - 1 draft steps and a
        # verify window: its budget scales with both.
        o, after = self._run_window(
            "fused_spec", self._spec_fused_window(ms), values,
            min(self.decode_fuse, int(values["budgets"].max())),
            self._window_budget_s(self.decode_fuse * (k + 2)))
        n_win, n_acc = o["n_win"], o["n_acc"]
        self.stats["fused_spec_windows"] += 1
        self.stats["fused_spec_steps"] += int(o["iters"])
        # A row takes part in one verify window per iteration it ran.
        self.stats["active_slot_steps"] += int(n_win.sum())
        self.stats["draft_tokens"] += int(n_win.sum()) * k
        self.stats["draft_accepted"] += int(n_acc.sum())
        for s in np.nonzero(active)[0]:
            r = self._slots[s]
            r.draft_proposed += int(n_win[s]) * k
            r.draft_accepted += int(n_acc[s])
        if self.fused_stream is not None:
            # JAX's tap order: iteration by iteration, window position by
            # position, slot by slot.
            takes = o["takes"]
            starts = np.cumsum(takes, axis=1) - takes
            for i in range(int(n_win.max())):
                for j in range(k + 1):
                    self.fused_stream.extend(
                        (int(s), int(o["out"][s, starts[s, i] + j]))
                        for s in np.nonzero(takes[:, i] > j)[0])
        self._replay_window(active, o["out"], o["n_emit"], after, emitted)

    # -- speculation -----------------------------------------------------

    def _quarantine_drafter(self, reason: str, r: Request | None = None,
                            proposed: int = 0) -> None:
        """Disable a misbehaving drafter for good: drafts were hints, so
        outputs are unchanged and the engine decodes without it from now
        on.  ``proposed`` tokens that came back before the fault are
        charged as proposed and rejected."""
        self._drafter_quarantined = True
        self.drafter_quarantine_reason = reason
        self.stats["drafter_quarantined"] = 1
        if r is not None and proposed:
            r.draft_proposed += proposed
            self.stats["draft_tokens"] += proposed

    # -- the serving canary (silent corruption) ---------------------------

    def _maybe_canary(self) -> None:
        """Drive the canary, once a scheduler iteration: harvest a
        finished canary — its greedy tokens of a fixed prompt pin the
        reference at the first clean completion, and any later
        difference quarantines the engine — then start the next one once
        ``canary_every_s`` has passed.  A canary that fails loudly
        (deadline, ``ERROR``) counts in ``canary_errors``, not as
        corruption."""
        if self.canary_every_s is None or not self._accepting:
            return
        r = self._canary_active
        if r is not None:
            if r.finish_reason is None:
                return  # still decoding: one canary in flight at a time
            self._canary_active = None
            if r.finish_reason is not FinishReason.COMPLETE:
                self.stats["canary_errors"] += 1
            else:
                got = tuple(r.tokens)
                self.stats["canary_runs"] += 1
                if self._canary_ref is None:
                    self._canary_ref = got
                elif got != self._canary_ref:
                    self._quarantine_canary(self._canary_ref, got)
                    return
        if time.monotonic() - self._canary_last < self.canary_every_s:
            return
        self._canary_last = time.monotonic()
        try:
            req = self.submit(self._canary_prompt, self._canary_new_tokens)
        except (QueueFull, ValueError):
            # Saturated (or the prompt does not fit): skip this tick
            # rather than shed real traffic for a probe.
            self.stats["canary_skipped"] += 1
            return
        req._canary = True
        self._canary_active = req

    def _quarantine_canary(self, expected: tuple, got: tuple) -> None:
        """A canary mismatch is evidence of silent corruption under this
        engine: it stops admitting and stepping, and its live requests
        stay in place, unfinished (JAX's cluster migrates them out; the
        port has no cluster yet).  JAX's obs event and flight dump here
        are not ported (obs, ROADMAP.md slice 8)."""
        self._quarantined = True
        self._accepting = False
        self.stats["canary_mismatch"] += 1
        self.stats["quarantined"] = 1
        diff = next((i for i, (a, b) in enumerate(zip(expected, got))
                     if a != b), min(len(expected), len(got)))
        self.quarantine_reason = (
            f"canary token stream diverged from pinned reference at token "
            f"{diff}: expected {list(expected)}, got {list(got)}")

    def _context(self, r: Request) -> np.ndarray:
        return np.concatenate([r.prompt, np.asarray(r.tokens, np.int32)])

    def _checked_draft(self, raw, r: Request, vocab: int,
                       what: str, size: int | None = None):
        """``raw`` as an int32 draft, or None after quarantining the
        drafter for a malformed (non-integer; with ``size``, not exactly
        that many tokens) or out-of-vocab proposal."""
        draft = np.asarray(raw).reshape(-1)
        if (size is not None and draft.size != size) or (
                draft.size and draft.dtype.kind not in "iu"):
            self._quarantine_drafter(
                f"{what} returned a malformed proposal (size {draft.size}, "
                f"dtype {draft.dtype})", r, int(draft.size))
            return None
        if draft.size and (int(draft.min()) < 0
                           or int(draft.max()) >= vocab):
            self._quarantine_drafter(
                f"{what} returned out-of-vocab token ids", r,
                int(draft.size))
            return None
        return draft.astype(np.int32)

    def _timed_propose(self, what: str, r: Request, call):
        """One drafter call behind the time wall: ``(raw, True)``, or
        ``(None, False)`` after quarantining the drafter because the call
        raised, the watchdog's deadline (armed around it under
        ``drafter_timeout_s``, or ``step_timeout_s``) fired while it
        blocked — the fault no timing of a returned call can see — or it
        took longer than ``drafter_timeout_s``."""
        budget = self.drafter_timeout_s
        t0 = time.perf_counter()
        try:
            with self._guard(budget if budget is not None
                             else self._step_timeout_s, f"draft_{what}"):
                raw = call()
        except Exception as exc:  # noqa: BLE001 — isolation by design
            self._quarantine_drafter(
                f"{what}() raised {type(exc).__name__}: {exc}")
            return None, False
        took = time.perf_counter() - t0
        size = int(np.asarray(raw).size) if raw is not None else 0
        if self._watchdog is not None and self._watchdog.acknowledge():
            self._quarantine_drafter(
                f"{what}() exceeded the armed watchdog deadline "
                f"({took:.4f}s elapsed)", r, size)
            return None, False
        if budget is not None and took > budget:
            self._quarantine_drafter(
                f"{what}() took {took:.4f}s (drafter_timeout_s={budget})",
                r, size)
            return None, False
        return raw, True

    def _gather_drafts(self, ms: _ModelState, active, k: int):
        """Host-side proposals ``[(slot, draft)]`` for every decoding
        slot that drafted; None when the drafter raised, blocked, ran
        past ``drafter_timeout_s`` or proposed a malformed or
        out-of-vocab draft (it is quarantined, and the caller runs the
        plain decode step)."""
        proposed = []
        for s in np.nonzero(active)[0]:
            r = self._slots[s]
            context = self._context(r)
            raw, ok = self._timed_propose(
                "propose", r, lambda: np.asarray(
                    self.drafter.propose(context, k)).reshape(-1)[:k])
            if not ok:
                return None
            draft = self._checked_draft(raw, r, ms.config.vocab_size,
                                        "propose()")
            if draft is None:
                return None
            if draft.size:
                proposed.append((int(s), draft))
        return proposed

    def _gather_tree_drafts(self, ms: _ModelState, active, shape):
        """Tree proposals behind the same wall as :meth:`_gather_drafts`:
        a ``propose_tree`` that raises, blocks, runs late or returns
        anything but ``T`` in-vocab integer tokens quarantines the
        drafter (None).  A slot whose drafter has no proposal (None) runs
        the no-candidate path in the window."""
        proposed = []
        for s in np.nonzero(active)[0]:
            r = self._slots[s]
            context = self._context(r)
            raw, ok = self._timed_propose(
                "propose_tree", r,
                lambda: self.drafter.propose_tree(context, shape))
            if not ok:
                return None
            if raw is None:
                continue
            draft = self._checked_draft(raw, r, ms.config.vocab_size,
                                        "propose_tree()",
                                        shape.num_candidates)
            if draft is None:
                return None
            proposed.append((int(s), draft))
        return proposed

    def _last_of(self, active) -> np.ndarray:
        """Each active slot's last token, 0 elsewhere: a batched forward
        feeds every row, and another model's slot may hold a token past
        this model's vocabulary."""
        return np.where(active, self._last, 0)

    def _window_tokens(self, proposed, width: int, active):
        """``(num_slots, width + 1)`` window tokens — each slot's last
        token, then its draft — and the per-slot draft counts; charges
        the proposals to their requests."""
        tokens = np.zeros((self.num_slots, width + 1), np.int64)
        tokens[:, 0] = self._last_of(active)
        n_draft = np.zeros(self.num_slots, np.int64)
        for s, draft in proposed:
            tokens[s, 1:1 + draft.size] = draft
            n_draft[s] = draft.size
            self._slots[s].draft_proposed += int(draft.size)
        return tokens, n_draft

    def _replay(self, active, out, n_emit, n_draft, counter: str,
                emitted) -> None:
        """Commit each active slot's emitted window tokens in order; EOS
        or the budget retires a slot mid-window and drops the rest —
        tokens plain decode would never have produced."""
        self.stats[counter] += 1
        self.stats["active_slot_steps"] += int(active.sum())
        self.stats["draft_tokens"] += int(n_draft.sum())
        for s in np.nonzero(active)[0]:
            r = self._slots[s]
            accepted = int(n_emit[s]) - 1
            r.draft_accepted += accepted
            self.stats["draft_accepted"] += accepted
            for j in range(int(n_emit[s])):
                if self._slots[s] is not r:
                    break  # retired (EOS / budget / cancel) mid-window
                # Each commit lands the K/V of the token fed before it.
                self._len[s] += 1
                self._commit(int(s), int(out[s, j]), emitted)

    def _row_generators(self, active) -> list:
        return [g if a else None for g, a in zip(self._gens, active.tolist())]

    def _run_verify(self, ms: _ModelState, active, emitted) -> None:
        """Draft on the host, verify on the device: up to ``speculate_k``
        proposals per decoding slot ride the window behind the slot's
        last token (one ``k + 1`` forward that writes the window's K/V
        before attending — in paged kernel mode the paged-window kernel
        at per-slot depths) and the accepted prefix plus the window's
        own next token commit in order.  A step where no slot drafted
        runs the plain decode step."""
        k = self.speculate_k
        proposed = self._gather_drafts(ms, active, k)
        if not proposed:  # nothing drafted, or the drafter was just cut
            self._run_decode(ms, active, emitted)
            return
        tokens, n_draft = self._window_tokens(proposed, k, active)

        def verify():
            window = self._to_device(tokens)
            lengths = self._to_device(self._len, torch.int32)
            if self._paged:
                logits, _ = _forward_paged(
                    ms.model, window, ms.pool.pages,
                    self._to_device(ms.table, torch.int32), lengths,
                    self._to_device(active, torch.bool),
                    impl=ms.dispatch["verify_paged"])
            else:
                logits, _ = _forward_cached(ms.model, window, ms.cache,
                                            lengths)
            out, n_emit = verify_tokens(
                logits, window[:, 1:], self._to_device(n_draft),
                self._temps, self._topk, self._topp,
                self._row_generators(active))
            return out.cpu().numpy(), n_emit.cpu().numpy()

        out, n_emit = self._device("verify", verify)
        self._replay(active, out, n_emit, n_draft, "verify_steps", emitted)

    def _run_verify_tree(self, ms: _ModelState, active, emitted) -> None:
        """Draft a token tree on the host, verify it in one tree-masked
        forward that writes nothing, then commit only the accepted
        root-to-leaf path's K/V: path node ``d`` at position ``len + d``
        (in the dense arena unconditionally — past the accepted depth it
        lands beyond the row's length and is overwritten before it is
        visible; in the pool only for ``d <= accepted``, so rejected
        branches and depths write just the scratch page).  Slots without
        a proposal run the no-candidate path; a step where no slot
        drafted runs the plain decode step."""
        shape = self.speculate_tree
        proposed = self._gather_tree_drafts(ms, active, shape)
        if not proposed:
            self._run_decode(ms, active, emitted)
            return
        tokens, n_cand = self._window_tokens(proposed,
                                             shape.num_candidates, active)
        out, n_emit = self._device("tree_verify", self._tree_verify, ms,
                                   active, tokens, n_cand, shape)
        self._replay(active, out, n_emit, n_cand, "tree_verify_steps",
                     emitted)

    def _tree_verify(self, ms: _ModelState, active, tokens, n_cand, shape):
        """The tree verify window's device work: the tree-masked forward,
        acceptance, and the commit of the accepted path's K/V; returns
        ``(out, n_emit)`` as numpy."""
        tokens = self._to_device(tokens)
        lengths = self._to_device(self._len)
        tree = (shape.depths, shape.ancestors)
        if self._paged:
            table = self._to_device(ms.table, torch.int32)
            if ms.dispatch["tree_verify_paged"] == "kernel":
                logits, wk, wv = _forward_tree_paged(
                    ms.model, tokens, ms.pool.pages, table, lengths, *tree)
            else:
                view = gather_pages(ms.pool.pages, table, ms.config.dtype)
                logits, wk, wv = _forward_tree(ms.model, tokens, view,
                                               lengths, *tree)
        else:
            logits, wk, wv = _forward_tree(ms.model, tokens, ms.cache,
                                           lengths, *tree)
        out, n_emit, path = verify_tree_tokens(
            logits, tokens[:, 1:], shape.parents, n_cand, self._temps,
            self._topk, self._topp, self._row_generators(active))
        # Every layer in one write per depth: the KV store viewed with
        # the layer axis behind the position, (pages or slots, position,
        # layers, kv, dh) — int8 scales (pages, position, layers, kv) —
        # takes path node d's (slots, 1, layers, kv, dh); an int8 write
        # quantizes each (layer, KV head) vector, as JAX's per-layer
        # commit does.
        store = ms.pool.pages if self._paged else ms.cache
        views = tuple(b.permute(1, 2, 0, *range(3, b.dim())) for b in store)
        rows = torch.arange(self.num_slots, device=self.device)
        act = self._to_device(active, torch.bool)
        for d in range(path.shape[1]):
            node = path[:, d]
            k_d, v_d = (w[:, rows, node].transpose(0, 1)[:, None]
                        for w in (wk, wv))
            if self._paged:
                write_token_pages(views, k_d, v_d, table, lengths + d,
                                  act & (d < n_emit))
            else:
                update_cache_rows(views[0], k_d, lengths + d)
                update_cache_rows(views[1], v_d, lengths + d)
        return out.cpu().numpy(), n_emit.cpu().numpy()

    def _commit(self, s: int, tok: int, emitted) -> None:
        r = self._slots[s]
        if self.token_fault_hook is not None:
            # The silent-corruption seam (tpudp_torch.serve.faults): a
            # token changed here conditions every later step of the slot,
            # as corrupted logits would.
            tok = int(self.token_fault_hook(s, tok, r))
        r.tokens.append(tok)
        r.token_times.append(time.perf_counter())
        self._last[s] = tok
        emitted.append((r, tok))
        self.stats["tokens"] += 1
        if r.tenant is not None:
            self._sched.stats(r.tenant)["tokens"] += 1
        if r.eos_id is not None and tok == r.eos_id:
            self._retire(s, FinishReason.EOS)
        elif len(r.tokens) >= r.max_new_tokens:
            self._retire(s, FinishReason.COMPLETE)

    def _priority_of(self, r: Request) -> int:
        return self._sched.cls(r.tenant).priority

    def _preempt_for_priority(self) -> None:
        """Evict lower-priority in-flight work that a waiting
        higher-priority request would otherwise wait behind: for each
        queued request in priority order (a snapshot: requests evicted
        here do not count as waiters this pass) take a free slot if one
        is left, else evict the lowest-priority slot strictly below the
        waiter's priority (the most recently admitted among equals).
        Equal priorities never preempt each other, and a pass evicts at
        most ``num_slots`` slots."""
        waiting = self._sched.waiting_by_priority()
        if not waiting:
            return
        free = sum(r is None for r in self._slots)
        for pri, count in waiting:
            for _ in range(count):
                if free:
                    free -= 1
                    continue
                victims = [s for s, r in enumerate(self._slots)
                           if r is not None and self._priority_of(r) < pri]
                if not victims:
                    return
                self._preempt_slot(max(
                    victims, key=lambda s: (-self._priority_of(
                        self._slots[s]), self._slots[s]._order)))

    def _preempt_slot(self, s: int) -> None:
        """Evict slot ``s`` for higher-priority work through the requeue
        path: its prefilled prefix is published first (paged or with the
        dense cache, so the resume mostly maps or copies it back), the
        request keeps its tokens and generator state and goes to the
        front of its class, and its re-prefill of ``prompt + tokens``
        continues it exactly.  Nothing failed: the store stays live and
        the one step-failure requeue is not spent."""
        r = self._slots[s]
        if (self._paged or r._ms.prefix_cache is not None) \
                and self._accepting:
            self._publish_prefix(r._ms, s, r)
        self._vacate_slot(s)
        r.preemptions += 1
        self.stats["preempted"] += 1
        self._sched.stats(r.tenant)["preempted"] += 1
        self._sched.requeue_front(r)

    def _vacate_slot(self, s: int) -> Request:
        """Clear slot ``s`` and prepare its request to resume exactly:
        its generator state is saved and its refill becomes ``prompt +
        tokens``."""
        r = self._slots[s]
        self._release_slot_pages(r._ms, s)
        self._slots[s] = None
        self._len[s] = 0
        self._temps[s] = 0.0
        self._topk[s] = 0
        self._topp[s] = 1.0
        r._slot = None
        r._resume_key = self._gens[s].get_state()
        r._nfill = 0
        r._fill = np.concatenate([r.prompt, np.asarray(r.tokens, np.int32)])
        return r

    def _retire(self, s: int, reason: FinishReason,
                error: BaseException | None = None) -> None:
        r = self._slots[s]
        # No publish once drain()/close() began: no later request reads
        # it.  Every retirement reason qualifies: the prefilled prefix is
        # valid KV whatever stopped the request.
        if (self._paged or r._ms.prefix_cache is not None) \
                and self._accepting:
            self._publish_prefix(r._ms, s, r)
        self._release_slot_pages(r._ms, s)
        r._slot = None
        self._slots[s] = None
        self._len[s] = 0
        self._temps[s] = 0.0
        self._topk[s] = 0
        self._topp[s] = 1.0
        self._finish(r, reason, error)
