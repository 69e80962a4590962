"""Drafters for speculative decoding — the port of
``tpudp/serve/speculate.py``.

A drafter proposes cheap continuation tokens on the host; the engine's
verify step scores ``[last, d_0 .. d_{k-1}]`` in one forward (the k+1
window through the paged-window kernel) and accepts the longest prefix
the target model agrees with (``tpudp_torch.ops.sampling.
verify_tokens``).  Drafts are hints: a wrong, short or empty proposal
changes only the speed, never the greedy output.

  * :class:`NgramDrafter` — prompt-lookup drafting from the request's
    own context; no weights, no device work.
  * :class:`DraftModelDrafter` — a smaller port GPT-2 with the target's
    vocabulary decodes ``k`` greedy tokens through its own cached
    forward on its own device.

A :class:`TreeShape` is the static shape of a speculative token tree
(``Engine(speculate_tree=...)``), verified in one tree-masked forward
(the paged-tree kernel on the card).
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

import numpy as np
import torch

from tpudp_torch.models.generate import (KVCache, _forward_cached,
                                         validate_decode_config)
from tpudp_torch.ops.sampling import tree_depths


@runtime_checkable
class Drafter(Protocol):
    """Anything that proposes up to ``k`` continuation tokens for a
    request's ``context`` (prompt + tokens emitted so far, 1-D int32),
    once per verify step per decoding slot, on the host."""

    def propose(self, context: np.ndarray, k: int) -> np.ndarray:
        ...


class TreeShape:
    """A static speculative token tree: ``parents[j]`` names node j's
    parent (``parents[0] == -1``: node 0 is the row's last committed
    token; candidates are nodes ``1..T`` in topological order).  Carries
    its per-node ``depths``, the ``(T+1, T+1)`` ancestor-or-self matrix
    the tree attention mask is built from, and the root-to-leaf
    ``paths`` drafters fill.  Hashable by its parents; a chain shape
    reproduces the sequence draft exactly."""

    __slots__ = ("name", "parents", "depths", "max_depth", "ancestors",
                 "paths")

    def __init__(self, name: str, parents: tuple):
        self.name = name
        self.parents = tuple(int(p) for p in parents)
        self.depths = tree_depths(self.parents)
        self.max_depth = max(self.depths)
        n = len(self.parents)
        anc = [[False] * n for _ in range(n)]
        for j in range(n):
            a = j
            while a != -1:
                anc[j][a] = True
                a = self.parents[a] if a else -1
        self.ancestors = tuple(tuple(row) for row in anc)
        children = {j: [c for c in range(1, n) if self.parents[c] == j]
                    for j in range(n)}
        leaves = [j for j in range(n) if not children[j]]
        paths = []
        for leaf in leaves:
            path, a = [], leaf
            while a != 0:
                path.append(a)
                a = self.parents[a]
            paths.append(tuple(reversed(path)))
        self.paths = tuple(paths)

    @property
    def num_candidates(self) -> int:
        return len(self.parents) - 1

    def __hash__(self):
        return hash(self.parents)

    def __eq__(self, other):
        return (isinstance(other, TreeShape)
                and self.parents == other.parents)

    def __repr__(self):
        return f"TreeShape({self.name!r}, parents={self.parents})"


def _chain(k: int) -> tuple:
    return (-1,) + tuple(range(k))


#: Named static tree shapes (``Engine(speculate_tree=<name>)``).  A
#: ``chainK`` is the sequence draft as a tree; the branched shapes spend
#: the same window on sibling candidates.
TREE_SHAPES = {
    "chain2": TreeShape("chain2", _chain(2)),
    "chain3": TreeShape("chain3", _chain(3)),
    "chain4": TreeShape("chain4", _chain(4)),
    # 2 branches x depth 2: nodes 1-2 chain off the root, node 3 is a
    # sibling first step with its own continuation node 4.
    "fork2x2": TreeShape("fork2x2", (-1, 0, 1, 0, 3)),
    # main chain of 3 + one sibling at the root.
    "fork3+1": TreeShape("fork3+1", (-1, 0, 1, 2, 0)),
}


def tree_shape(spec) -> TreeShape:
    """Resolve ``Engine(speculate_tree=...)``: a registry name, a
    ``TreeShape``, or a raw parents tuple."""
    if isinstance(spec, TreeShape):
        return spec
    if isinstance(spec, str):
        if spec not in TREE_SHAPES:
            raise ValueError(
                f"unknown tree shape {spec!r} (registered: "
                f"{sorted(TREE_SHAPES)}; or pass a parents tuple)")
        return TREE_SHAPES[spec]
    return TreeShape("custom", tuple(spec))


class NgramDrafter:
    """Prompt-lookup drafting: the last ``n`` tokens (longest match wins,
    ``n`` from ``max_ngram`` down to ``min_ngram``) are searched in the
    earlier context and the continuation of the most recent match is
    proposed."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if min_ngram < 1:
            raise ValueError(f"min_ngram must be >= 1, got {min_ngram}")
        if max_ngram < min_ngram:
            raise ValueError(
                f"max_ngram ({max_ngram}) must be >= min_ngram "
                f"({min_ngram})")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def propose(self, context: np.ndarray, k: int) -> np.ndarray:
        context = np.asarray(context, np.int32).reshape(-1)
        size = context.size
        best = np.zeros(0, np.int32)
        if k < 1 or size < self.min_ngram + 1:
            return best
        for n in range(min(self.max_ngram, size - 1),
                       self.min_ngram - 1, -1):
            pattern = context[size - n:]
            # Candidate starts 0..size-n-1: excludes the suffix itself
            # and guarantees at least one continuation token.
            windows = np.lib.stride_tricks.sliding_window_view(context, n)
            hits = np.nonzero((windows[:size - n] == pattern).all(1))[0]
            if not hits.size:
                continue
            # Most recent match with a full k-token continuation, else
            # the one with the most tokens available: in a short-period
            # loop the newest match hugs the suffix and would cap the
            # proposal at one token.
            avail = size - (hits + n)
            full = hits[avail >= k]
            i = int(full[-1]) if full.size else int(hits[np.argmax(avail)])
            cand = context[i + n:i + n + k]
            if cand.size == k:
                return cand.astype(np.int32)
            if cand.size > best.size:
                best = cand.astype(np.int32)
        return best

    def _continuations(self, context: np.ndarray, k: int,
                       want: int) -> list:
        """Up to ``want`` distinct k-token continuations, most recent
        match first; the first is exactly :meth:`propose`'s, later ones
        come from older matches whose next token differs."""
        context = np.asarray(context, np.int32).reshape(-1)
        size = context.size
        if k < 1 or size < self.min_ngram + 1:
            return []
        out, first_toks = [], set()
        main = self.propose(context, k)
        if main.size:  # path 0 is exactly the sequence draft
            out.append(main)
            first_toks.add(int(main[0]))
        for n in range(min(self.max_ngram, size - 1),
                       self.min_ngram - 1, -1):
            if len(out) >= want:
                break
            pattern = context[size - n:]
            windows = np.lib.stride_tricks.sliding_window_view(context, n)
            hits = np.nonzero((windows[:size - n] == pattern).all(1))[0]
            for i in hits[::-1]:  # most recent match first
                cand = context[i + n:i + n + k]
                head = int(cand[0]) if cand.size else None
                if head is None or head in first_toks:
                    continue
                first_toks.add(head)
                out.append(cand.astype(np.int32))
                if len(out) >= want:
                    break
        return out

    def propose_tree(self, context: np.ndarray,
                     shape: TreeShape) -> np.ndarray | None:
        """Candidate tokens for every node of ``shape`` (``(T,)`` int32,
        node j's token at index j-1), or None when the context has no
        match.  Each root-to-leaf path gets its own continuation; shared
        prefixes keep the first assigner's token, and paths beyond the
        distinct continuations repeat the last one."""
        conts = self._continuations(context, shape.max_depth,
                                    len(shape.paths))
        if not conts:
            return None
        tokens = np.zeros(shape.num_candidates, np.int32)
        assigned = np.zeros(shape.num_candidates, bool)
        for i, path in enumerate(shape.paths):
            cont = conts[min(i, len(conts) - 1)]
            for d, node in enumerate(path):
                if assigned[node - 1] or d >= cont.size:
                    continue
                tokens[node - 1] = cont[d]
                assigned[node - 1] = True
        return tokens


class DraftModelDrafter:
    """Greedy k-token drafting with a smaller port GPT-2 sharing the
    target's vocabulary (the engine checks it), on the draft model's own
    device: one prefill of the context padded to a power-of-two bucket
    (clamped so the window fits the draft model's positions; ``bucket``
    pins it) gives the first draft, then one cached decode step per
    further draft.  Pad positions sit behind the causal mask and each
    decode step overwrites its position before it becomes visible."""

    def __init__(self, model, bucket: int | None = None):
        validate_decode_config(model.config, "DraftModelDrafter")
        if bucket is not None and bucket < 1:
            raise ValueError(f"bucket must be >= 1, got {bucket}")
        self.model = model
        self.config = model.config
        self.bucket = bucket

    @torch.no_grad()
    def propose(self, context: np.ndarray, k: int) -> np.ndarray:
        context = np.asarray(context, np.int32).reshape(-1)
        if k < 1 or context.size == 0:
            return np.zeros(0, np.int32)
        cap = max(self.config.max_seq_len - k, 1)
        length = min(context.size, cap)
        context = context[-length:]
        if self.bucket is not None:
            bucket = min(max(self.bucket, length), cap)
        else:
            bucket = 1
            while bucket < length:
                bucket *= 2
            bucket = min(bucket, cap)
        dev = next(self.model.parameters()).device
        padded = torch.zeros((1, bucket), dtype=torch.int64, device=dev)
        padded[0, :length] = torch.as_tensor(context, device=dev)
        cache = KVCache.zeros(self.config, 1, bucket + k, dev)
        logits, cache = _forward_cached(self.model, padded, cache, 0)
        drafts = [torch.argmax(logits[:, length - 1], dim=-1)]  # (1,) each
        for i in range(k - 1):
            logits, cache = _forward_cached(
                self.model, drafts[-1][:, None], cache,
                torch.tensor([length + i], device=dev))
            drafts.append(torch.argmax(logits[:, 0], dim=-1))
        return torch.cat(drafts).cpu().numpy().astype(np.int32)
