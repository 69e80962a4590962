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
    version.  Asking for ``'kernel'`` on the CPU raises.
    ``kv_dtype='int8'`` stores the pool quantized (int8 payloads, one
    float32 scale per token and KV head, same page ids): the kernels are
    then their int8 variants.  Where the kernels cannot take the
    engine's shapes, a kernel engine runs that family on the einsum
    path, decided at build time by :func:`paged_dispatch` and listed in
    ``metrics()['paged_attn']['fallbacks']``: every family at a head dim
    other than 32, 64 or 128, and tree verify over an int8 pool (as in
    JAX) or over a tree of more than 32 nodes.

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

The model is a ``tpudp_torch`` GPT-2 or LLaMA (grouped-query heads: the
KV store is ``kv_heads`` wide).  The JAX engine's fused decode windows
and fused speculation, the dense copy cache, tenancy, co-resident
models, canaries, the watchdog, the drafter timeout and fault hooks are
later slices: each such option raises ``NotImplementedError`` naming its
ROADMAP item.
"""

from __future__ import annotations

import collections
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
from tpudp_torch.ops.paged_attention import (_KERNEL_HEAD_DIMS, KERNELS,
                                             TREE_KERNEL_MAX_NODES)
from tpudp_torch.ops.sampling import (sample_tokens, verify_tokens,
                                      verify_tree_tokens)
from tpudp_torch.serve.prefix_cache import PageIndex, PagePool
from tpudp_torch.serve.speculate import NgramDrafter, tree_shape

#: Options of the JAX engine this port does not have yet: name ->
#: (the value that means "off", the ROADMAP.md item that brings it).
_UNPORTED = {
    "decode_fuse": (1, "slice 3 (decode_fuse: CUDA-graph window, and "
                       "fused speculation with a model drafter)"),
    "fuse_stream": (False, "slice 3 (decode_fuse: CUDA-graph window)"),
    "prefix_cache_blocks": (0, "slice 8 (dense copy prefix cache)"),
    "tenants": (None, "slice 8 (tenancy)"),
    "models": (None, "slice 8 (co-resident models)"),
    "canary_every_s": (None, "slice 8 (robustness: serving canary)"),
    "watchdog": (None, "slice 8 (robustness: watchdog)"),
    "drafter_timeout_s": (None, "slice 8 (robustness: drafter timeout)"),
    "step_timeout_s": (None, "slice 8 (robustness: watchdog)"),
    "step_fault_hook": (None, "slice 8 (robustness: fault hooks)"),
    "token_fault_hook": (None, "slice 8 (robustness: fault hooks)"),
}


#: Device types the kernel backend runs on: the kernels are CUDA's.
KERNEL_DEVICES = ("cuda",)

#: The paged step families, as ``metrics()["paged_attn"]["dispatch"]``
#: names them.
PAGED_FAMILIES = ("decode_paged", "verify_paged", "prefill_paged",
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
    """Why a request stopped.  ``COMPLETE``/``EOS`` are success."""

    COMPLETE = "complete"    # max_new_tokens emitted
    EOS = "eos"              # sampled the request's eos_id
    CANCELLED = "cancelled"  # Engine.cancel()/Request.cancel()/close()
    SHED = "shed"            # queued work discarded by Engine.close()


_FINISH_COUNTER = {
    FinishReason.COMPLETE: "completed",
    FinishReason.EOS: "completed",
    FinishReason.CANCELLED: "cancelled",
    FinishReason.SHED: "shed",
}


class QueueFull(RuntimeError):
    """submit() refused: ``queue_limit`` requests are already waiting."""


class EngineClosed(RuntimeError):
    """submit() called after :meth:`Engine.close`."""


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
    """The model's serving state: its dense arena, or its page pool,
    radix index and host-side block table (``(num_slots, max_pages)``
    int32, ``-1`` unmapped); ``slot_nodes[s]`` maps each of slot ``s``'s
    shared pages to the pinned index node behind it."""

    __slots__ = ("model", "config", "cache", "pool", "index", "table",
                 "slot_nodes")

    def __init__(self, model):
        self.model = model
        self.config = model.config
        self.cache = None
        self.pool = None
        self.index = None
        self.table = None
        self.slot_nodes = None


class Request:
    """Handle returned by :meth:`Engine.submit`.  ``tokens`` grows as the
    engine steps; iterate the handle to stream them, or call
    :meth:`result` for the whole ``prompt + completion``.
    ``token_times`` holds a ``time.perf_counter()`` stamp per token;
    ``draft_proposed``/``draft_accepted`` count this request's drafted
    and accepted tokens (``acceptance_rate`` is their ratio)."""

    def __init__(self, engine: "Engine", rid: int, prompt: np.ndarray,
                 max_new_tokens: int, temperature: float, top_k: int,
                 top_p: float, seed: int, eos_id: int | None):
        self._engine = engine
        self.id = rid
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.top_k = top_k  # 0 = disabled
        self.top_p = top_p  # 1.0 = disabled
        self.seed = seed
        self.eos_id = eos_id
        self._ms = None
        self.tokens: list[int] = []
        self.token_times: list[float] = []
        self.submit_time = time.perf_counter()
        self.done = False
        self.finish_reason: FinishReason | None = None
        self.draft_proposed = 0
        self.draft_accepted = 0
        self._slot: int | None = None
        self._fill = prompt  # tokens to prefill (prompt, + tokens on resume)
        self._nfill = 0      # fill tokens already in the KV store
        self._order = 0      # admission order (prefill FIFO tiebreak)
        self._resume_key = None  # generator state saved across a vacate

    @property
    def acceptance_rate(self) -> float | None:
        """Accepted / proposed draft tokens of this request (None until
        a drafter has proposed something for it)."""
        if not self.draft_proposed:
            return None
        return self.draft_accepted / self.draft_proposed

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
    ``max_len``."""

    def __init__(self, model, *, device="cuda", num_slots: int = 8,
                 max_len: int | None = None, prefill_chunk: int = 16,
                 kv_pages: int = 0, paged_attn: str | None = None,
                 kv_dtype: str | None = None,
                 queue_limit: int | None = None, speculate_k: int = 0,
                 drafter=None, speculate_tree=None, **unported):
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
        if kv_pages < 0:
            raise ValueError(f"kv_pages must be >= 0 (0 keeps the dense "
                             f"slot arena), got {kv_pages}")
        if paged_attn not in (None, "einsum", "kernel"):
            raise ValueError(
                f"paged_attn must be None (auto: 'kernel' on CUDA, "
                f"'einsum' on the CPU), 'einsum' (the plain PyTorch "
                f"version) or 'kernel' (the CUDA kernels); got "
                f"{paged_attn!r}")
        if kv_dtype not in (None, "int8"):
            raise ValueError(
                f"kv_dtype must be None or 'int8', got {kv_dtype!r}")
        if kv_dtype is not None and not kv_pages:
            raise ValueError("kv_dtype requires kv_pages > 0 — quantized KV "
                             "lives in the page pool")
        if paged_attn == "kernel" and not kv_pages:
            raise ValueError("paged_attn='kernel' requires kv_pages > 0 — "
                             "the kernels read through the block table")
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
        self.speculate_k = speculate_k
        self.drafter = drafter
        self._drafter_quarantined = False
        self.drafter_quarantine_reason: str | None = None
        self.model = model.to(self.device)
        self.config = cfg
        self.num_slots = num_slots
        self.prefill_chunk = prefill_chunk
        self.queue_limit = queue_limit
        self._paged = kv_pages > 0
        self.kv_pages = kv_pages
        self.kv_dtype = kv_dtype
        self.paged_attn = paged_attn
        self.paged_attn_dispatch = (
            paged_dispatch(paged_attn, kv_dtype,
                           cfg.d_model // cfg.num_heads,
                           len(self.speculate_tree.parents)
                           if self.speculate_tree is not None else None)
            if self._paged else {})
        self._max_pages = self.max_len // prefill_chunk  # table width
        self._mstates: dict[str | None, _ModelState] = {
            None: _ModelState(self.model)}
        if self._paged:
            self._build_page_pools()
        else:
            self._mstates[None].cache = KVCache.zeros(
                cfg, num_slots, self.max_len, self.device)
        self._gens = [torch.Generator(device=self.device)
                      for _ in range(num_slots)]
        self._len = np.zeros(num_slots, np.int64)
        self._last = np.zeros(num_slots, np.int64)
        self._temps = np.zeros(num_slots, np.float32)
        self._topk = np.zeros(num_slots, np.int64)
        self._topp = np.ones(num_slots, np.float32)
        self._slots: list[Request | None] = [None] * num_slots
        self._queue: collections.deque[Request] = collections.deque()
        self._next_id = 0
        self._admitted = 0
        self._closed = False
        self.stats = collections.Counter()

    def _build_page_pools(self) -> None:
        """One page pool, radix index and block table for the model."""
        if self.kv_pages < self._max_pages:
            raise ValueError(
                f"kv_pages ({self.kv_pages}) is below the "
                f"{self._max_pages} pages one max_len ({self.max_len}) "
                f"request needs; raise kv_pages")
        ms = self._mstates[None]
        ms.pool = PagePool(ms.config, self.kv_pages, self.prefill_chunk,
                           self.device, self.kv_dtype)
        ms.index = PageIndex(ms.pool)
        ms.table = np.full((self.num_slots, self._max_pages), -1, np.int32)
        ms.slot_nodes = [dict() for _ in range(self.num_slots)]

    @property
    def page_pool(self):
        return self._mstates[None].pool

    @property
    def page_index(self):
        return self._mstates[None].index

    # -- submission ----------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, *,
               temperature: float = 0.0, top_k: int | None = None,
               top_p: float | None = None, seed: int = 0,
               eos_id: int | None = None) -> Request:
        """Queue one generation request; returns its streaming handle.
        ``temperature=0`` is greedy (``top_k``/``top_p`` rejected);
        otherwise softmax sampling truncated to top-k and/or the top-p
        nucleus from a generator seeded with ``seed``.  ``eos_id`` ends
        the request early when sampled (and is included in
        ``tokens``)."""
        if self._closed:
            raise EngineClosed("Engine.close() was called; the engine no "
                               "longer accepts work")
        if (self.queue_limit is not None
                and self.queue_depth >= self.queue_limit):
            self.stats["shed"] += 1
            raise QueueFull(f"queue_limit ({self.queue_limit}) queued "
                            f"requests already waiting; request refused")
        ms = self._mstates[None]
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
        r = Request(self, self._next_id, prompt, max_new_tokens,
                    float(temperature), int(top_k or 0),
                    float(1.0 if top_p is None else top_p), seed, eos_id)
        r._ms = ms
        self._next_id += 1
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
        """One scheduler iteration: admit queued requests into free
        slots, run at most one prefill chunk, then one batched step for
        every decoding slot — a tree verify window, a sequence verify
        window or a plain decode step, in that order of preference.
        Returns the ``(request, token)`` pairs emitted."""
        emitted: list[tuple[Request, int]] = []
        if self._closed:
            return emitted
        self._admit()
        slot = self._next_prefill_slot()
        if slot is not None:
            self._run_prefill_chunk(slot, emitted)
        ms = self._mstates[None]
        active = self._decoding(ms)
        if active.any() and self._paged:
            # Back every table entry the step writes before dispatch;
            # page pressure resolves here, on the host.
            active = self._ensure_decode_pages(ms, active)
        if active.any():
            if self._speculating:
                if self.speculate_tree is not None:
                    self._run_verify_tree(ms, active, emitted)
                else:
                    self._run_verify(ms, active, emitted)
            else:
                self._run_decode(ms, active, emitted)
        self.stats["steps"] += 1
        return emitted

    def cancel(self, request: Request) -> bool:
        """Retire ``request`` now, queued or in flight; False if it had
        already finished."""
        if request.done:
            return False
        if request._slot is not None:
            self._retire(request._slot, FinishReason.CANCELLED)
            return True
        self._queue.remove(request)
        self._finish(request, FinishReason.CANCELLED)
        return True

    def run_until_complete(self) -> None:
        """Drive the engine until every queue and every slot is empty."""
        while self.queue_depth or any(r is not None for r in self._slots):
            self.step()

    def close(self) -> None:
        """Stop admission, retire in-flight requests as ``CANCELLED`` (no
        prefix is published) and queued ones as ``SHED``."""
        self._closed = True
        while self._queue:
            self._finish(self._queue.popleft(), FinishReason.SHED)
        for s, r in enumerate(self._slots):
            if r is not None:
                self._retire(s, FinishReason.CANCELLED)

    @property
    def slots_in_use(self) -> int:
        return sum(r is not None for r in self._slots)

    @property
    def queue_depth(self) -> int:
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
        if self._paged:
            p = self.page_pool
            out["page_pools"] = [
                {"num_pages": p.num_pages, "used_pages": p.used_pages,
                 "free_pages": p.free_pages, "page_bytes": p.page_bytes(),
                 "kv_dtype": p.kv_dtype}]
            out["paged_attn"] = {
                "requested": self.paged_attn_requested,
                "resolved": self.paged_attn,
                "dispatch": dict(self.paged_attn_dispatch),
                "fallbacks": sorted(
                    f for f, impl in self.paged_attn_dispatch.items()
                    if self.paged_attn == "kernel" and impl != "kernel")}
        if self.stats.get("draft_tokens"):
            out["acceptance_rate"] = self.acceptance_rate
        return out

    # -- internals -----------------------------------------------------

    def _decoding(self, ms: _ModelState) -> np.ndarray:
        return np.array([r is not None and r._nfill == r._fill.size
                         and r._ms is ms for r in self._slots])

    def _admit(self) -> None:
        for s in range(self.num_slots):
            if self._slots[s] is not None:
                continue
            if not self._queue:
                break
            r = self._queue.popleft()
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
            if self._paged:
                self._admit_prefix_paged(r._ms, s, r)

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
            if ms.index.evict_one():
                continue
            victim = self._page_pressure_victim(ms.pool, protect)
            if victim is None:
                return None
            self._vacate_for_pages(victim)

    def _page_pressure_victim(self, pool, protect: int) -> int | None:
        """The most recently admitted slot other than ``protect``: the
        least sunk cost, so the oldest request always progresses."""
        victims = [s for s, r in enumerate(self._slots)
                   if r is not None and s != protect
                   and r._ms.pool is pool]
        if not victims:
            return None
        return max(victims, key=lambda s: self._slots[s]._order)

    def _vacate_for_pages(self, s: int) -> None:
        """Evict slot ``s`` to free its pages: publish its prefilled
        prefix (the pages stay as evictable cache, so the resume mostly
        maps them back), vacate, and requeue at the front."""
        r = self._slots[s]
        if not self._closed:
            self._publish_prefix_paged(r._ms, s, r)
        self._vacate_slot(s)
        self.stats["page_pressure_vacates"] += 1
        self._queue.appendleft(r)

    def _ensure_pages(self, ms: _ModelState, s: int, upto: int) -> None:
        """Allocate slot ``s``'s table entries covering positions
        ``[0, upto)``; raises if the pool cannot back the slot even
        alone, which the kv_pages validation rules out."""
        need = min((upto + self.prefill_chunk - 1) // self.prefill_chunk,
                   self._max_pages)
        for pidx in range(need):
            if ms.table[s, pidx] >= 0:
                continue
            page = self._alloc_page(ms, protect=s)
            if page is None:
                raise RuntimeError(f"page pool exhausted backing slot {s} "
                                   f"to position {upto}")
            ms.table[s, pidx] = page

    def _ensure_decode_pages(self, ms: _ModelState, active) -> np.ndarray:
        """Back the pages the step writes for each active slot — its
        next token, or the whole ``k + 1`` verify window when speculating
        — before dispatch; returns the active mask recomputed after any
        page-pressure vacates."""
        ahead = self.speculate_k + 1 if self._speculating else 1
        for s in np.nonzero(active)[0]:
            if self._slots[s] is not None:
                self._ensure_pages(ms, s, int(self._len[s]) + ahead)
        return self._decoding(ms)

    def check_paged(self) -> None:
        """Table <-> pool <-> index consistency: pool and tree invariants,
        and each allocated page's refcount equal to its holders (one per
        owning index node plus one per table entry mapping it)."""
        if not self._paged:
            return
        ms = self._mstates[None]
        ms.index.check()
        for s in range(self.num_slots):
            for page, node in ms.slot_nodes[s].items():
                if ms.index._by_block.get(node.block) is not node:
                    raise RuntimeError(f"slot {s} pins a node the index no "
                                       f"longer holds (page {page})")
                if page not in ms.table[s]:
                    raise RuntimeError(f"slot {s} pins page {page} absent "
                                       f"from its table row")
        expected: dict[int, int] = dict(ms.index.tree_refs())
        for page in ms.table[ms.table >= 0].tolist():
            expected[page] = expected.get(page, 0) + 1
        ms.pool.check(expected)

    # -- the step loop ---------------------------------------------------

    def _finish(self, r: Request, reason: FinishReason) -> None:
        r.done = True
        r.finish_reason = reason
        self.stats[_FINISH_COUNTER[reason]] += 1

    def _next_prefill_slot(self) -> int | None:
        pending = [(r._order, s) for s, r in enumerate(self._slots)
                   if r is not None and r._nfill < r._fill.size]
        return min(pending)[1] if pending else None

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
            self._ensure_pages(ms, s, end)
            logits, _ = _forward_paged(
                ms.model, tokens, ms.pool.pages,
                self._to_device(ms.table[s][None], torch.int32), start,
                torch.ones(1, dtype=torch.bool, device=self.device),
                impl=self.paged_attn_dispatch["prefill_paged"])
        else:
            row = KVCache(ms.cache.k[:, s:s + 1], ms.cache.v[:, s:s + 1])
            logits, _ = _forward_cached(ms.model, tokens, row, start)
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
            tok = _sample_row(logits[:, end - start - 1], self._temps[s],
                              self._topk[s], self._topp[s], self._gens[s])
            self._commit(s, int(tok), emitted)

    def _run_decode(self, ms: _ModelState, active, emitted) -> None:
        lengths = self._to_device(self._len, torch.int32)
        act = self._to_device(active, torch.bool)
        if self._paged:
            table = self._to_device(ms.table, torch.int32)

            def forward(pool, tokens, lens, act):
                return _forward_paged(ms.model, tokens, pool, table, lens,
                                      act,
                                      impl=self.paged_attn_dispatch[
                                          "decode_paged"])
            state = ms.pool.pages
        else:
            def forward(cache, tokens, lens, act):
                return _forward_cached(ms.model, tokens, cache, lens)
            state = ms.cache
        _, toks = _decode_math(forward, state, self._to_device(self._last),
                               lengths, act, self._temps, self._topk,
                               self._topp, self._gens)
        toks = toks.cpu().numpy()
        self.stats["decode_steps"] += 1
        self.stats["active_slot_steps"] += int(active.sum())
        for s in np.nonzero(active)[0]:
            self._len[s] += 1  # the fed token's KV landed this step
            self._commit(int(s), int(toks[s]), emitted)

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

    def _gather_drafts(self, ms: _ModelState, active, k: int):
        """Host-side proposals ``[(slot, draft)]`` for every decoding
        slot that drafted; None when the drafter raised or proposed a
        malformed or out-of-vocab draft (it is quarantined, and the
        caller runs the plain decode step)."""
        proposed = []
        for s in np.nonzero(active)[0]:
            r = self._slots[s]
            try:
                raw = np.asarray(self.drafter.propose(self._context(r), k))
                raw = raw.reshape(-1)[:k]
            except Exception as exc:  # noqa: BLE001 — isolation by design
                self._quarantine_drafter(
                    f"propose() raised {type(exc).__name__}: {exc}")
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
        a ``propose_tree`` that raises or returns anything but ``T``
        in-vocab integer tokens quarantines the drafter (None).  A slot
        whose drafter has no proposal (None) runs the no-candidate path
        in the window."""
        proposed = []
        for s in np.nonzero(active)[0]:
            r = self._slots[s]
            try:
                raw = self.drafter.propose_tree(self._context(r), shape)
            except Exception as exc:  # noqa: BLE001 — isolation by design
                self._quarantine_drafter(
                    f"propose_tree() raised {type(exc).__name__}: {exc}")
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

    def _window_tokens(self, proposed, width: int):
        """``(num_slots, width + 1)`` window tokens — each slot's last
        token, then its draft — and the per-slot draft counts; charges
        the proposals to their requests."""
        tokens = np.zeros((self.num_slots, width + 1), np.int64)
        tokens[:, 0] = self._last
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
        out = out.cpu().numpy()
        n_emit = n_emit.cpu().numpy()
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
        tokens, n_draft = self._window_tokens(proposed, k)
        tokens = self._to_device(tokens)
        lengths = self._to_device(self._len, torch.int32)
        if self._paged:
            logits, _ = _forward_paged(
                ms.model, tokens, ms.pool.pages,
                self._to_device(ms.table, torch.int32), lengths,
                self._to_device(active, torch.bool),
                impl=self.paged_attn_dispatch["verify_paged"])
        else:
            logits, _ = _forward_cached(ms.model, tokens, ms.cache, lengths)
        out, n_emit = verify_tokens(
            logits, tokens[:, 1:], self._to_device(n_draft), self._temps,
            self._topk, self._topp, self._row_generators(active))
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
                                             shape.num_candidates)
        tokens = self._to_device(tokens)
        lengths = self._to_device(self._len)
        tree = (shape.depths, shape.ancestors)
        if self._paged:
            table = self._to_device(ms.table, torch.int32)
            if self.paged_attn_dispatch["tree_verify_paged"] == "kernel":
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
        self._replay(active, out, n_emit, n_cand, "tree_verify_steps",
                     emitted)

    def _commit(self, s: int, tok: int, emitted) -> None:
        r = self._slots[s]
        r.tokens.append(tok)
        r.token_times.append(time.perf_counter())
        self._last[s] = tok
        emitted.append((r, tok))
        self.stats["tokens"] += 1
        if r.eos_id is not None and tok == r.eos_id:
            self._retire(s, FinishReason.EOS)
        elif len(r.tokens) >= r.max_new_tokens:
            self._retire(s, FinishReason.COMPLETE)

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

    def _retire(self, s: int, reason: FinishReason) -> None:
        r = self._slots[s]
        if self._paged and not self._closed:
            self._publish_prefix_paged(r._ms, s, r)
        self._release_slot_pages(r._ms, s)
        r._slot = None
        self._slots[s] = None
        self._len[s] = 0
        self._temps[s] = 0.0
        self._topk[s] = 0
        self._topp[s] = 1.0
        self._finish(r, reason)
