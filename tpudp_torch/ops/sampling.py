"""Per-row masked token sampling and speculative acceptance — the port
of ``tpudp/ops/sampling.py``'s ``truncate_logits``, ``sample_tokens``,
``verify_tokens``, ``tree_depths`` and ``verify_tree_tokens``.

Row-wise semantics, as in the JAX op:

  * ``temperature[i] == 0``  -> greedy argmax (top_k/top_p ignored);
  * ``top_k[i] == 0``        -> top-k disabled;
  * ``top_p[i] == 1``        -> nucleus disabled;
  * the nucleus always keeps the highest-probability token, and
    truncation applies after temperature scaling.

Randomness is one ``torch.Generator`` per row instead of a JAX key per
row: a row draws only from its own generator, and only when it samples,
so a request's draws never depend on which other requests share the
batch.  The generators give other numbers than JAX's keys for the same
seed; greedy rows match JAX exactly.  A speculative window draws one
acceptance uniform per drafted position and then makes the final draw
with the same ``torch.multinomial`` call as :func:`sample_tokens`, so a
row with no drafts moves its generator exactly as a plain decode step
does.
"""

from __future__ import annotations

import torch


def truncate_logits(scaled: torch.Tensor, top_k: torch.Tensor,
                    top_p: torch.Tensor) -> torch.Tensor:
    """Mask ``scaled`` ``(..., vocab)`` outside the per-row top-k set and
    top-p nucleus to -inf (``top_k <= 0`` / ``top_p >= 1`` disable that
    truncation for the row).  Top-k first, then the nucleus over the
    top-k-renormalized distribution; ``scaled >= kth`` keeps ties at the
    k-th value."""
    v = scaled.shape[-1]
    sorted_scaled = torch.sort(scaled, dim=-1, descending=True).values
    kth_idx = (top_k[..., None].long() - 1).clamp(0, v - 1)
    kth = torch.gather(sorted_scaled, -1, kth_idx)
    keep_k = (top_k[..., None] <= 0) | (scaled >= kth)
    masked_k = torch.where(keep_k, scaled, -torch.inf)

    sorted_k = torch.sort(masked_k, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_k, dim=-1), dim=-1)
    preceding = torch.cat([torch.zeros_like(cum[..., :1]), cum[..., :-1]],
                          dim=-1)
    in_nucleus = preceding < top_p[..., None]
    cutoff = torch.where(in_nucleus, sorted_k, torch.inf).amin(
        dim=-1, keepdim=True)
    keep_p = (top_p[..., None] >= 1.0) | (masked_k >= cutoff)
    return torch.where(keep_p, masked_k, -torch.inf)


def sample_tokens(logits: torch.Tensor, temperature, top_k, top_p,
                  generators) -> torch.Tensor:
    """One token per row of ``logits`` ``(n, vocab)`` float32.

    ``temperature``/``top_k``/``top_p`` are ``(n,)`` (numpy or torch);
    ``generators`` holds one ``torch.Generator`` per row on the logits'
    device, or ``None`` for a row that must not draw this call (its
    token is the argmax and its generator stays where it was).  Returns
    ``(n,)`` int64 token ids on the logits' device."""
    dev = logits.device
    temps = torch.as_tensor(temperature, dtype=torch.float32).cpu().tolist()
    toks = torch.argmax(logits, dim=-1)
    rows = [i for i, g in enumerate(generators)
            if g is not None and temps[i] > 0]
    if not rows:
        return toks
    temperature = torch.as_tensor(temperature, dtype=torch.float32,
                                  device=dev)
    top_k = torch.as_tensor(top_k, dtype=torch.int64, device=dev)
    top_p = torch.as_tensor(top_p, dtype=torch.float32, device=dev)
    idx = torch.tensor(rows, device=dev)
    scaled = logits[idx] / temperature[idx, None]
    if bool(((top_k[idx] > 0) | (top_p[idx] < 1.0)).any()):
        scaled = truncate_logits(scaled, top_k[idx], top_p[idx])
    probs = torch.softmax(scaled, dim=-1)
    for j, i in enumerate(rows):
        toks[i] = _draw(probs[j], generators[i])
    return toks


def _draw(probs: torch.Tensor, generator) -> torch.Tensor:
    """The one final draw of every sampling op: one token from ``probs``
    ``(vocab,)``."""
    return torch.multinomial(probs, 1, generator=generator)[0]


class _Rows:
    """The sampled rows of a window and their parameters: per-row
    windows are scaled and truncated with :func:`sample_tokens`'s
    arithmetic (division by a device tensor, the same truncation), so a
    window row and a decode row round alike."""

    def __init__(self, temperature, top_k, top_p, generators, device):
        temps = torch.as_tensor(temperature, dtype=torch.float32)
        self.rows = [i for i, (g, t) in enumerate(zip(generators,
                                                      temps.tolist()))
                     if g is not None and t > 0]
        if self.rows:
            self.temps = temps.to(device)
            self.top_k = torch.as_tensor(top_k, dtype=torch.int64,
                                         device=device)
            self.top_p = torch.as_tensor(top_p, dtype=torch.float32,
                                         device=device)

    def scaled(self, logits, i):
        """Row ``i``'s window ``(W, vocab)``, scaled and truncated."""
        w = logits.shape[1]
        scaled = logits[i] / self.temps[i]
        if bool((self.top_k[i] > 0) | (self.top_p[i] < 1.0)):
            scaled = truncate_logits(scaled, self.top_k[i].expand(w),
                                     self.top_p[i].expand(w))
        return scaled


def _uniforms(n: int, generator, device) -> list:
    """``n`` acceptance uniforms from the row's generator (none for 0)."""
    if not n:
        return []
    return torch.rand(n, generator=generator, device=device).tolist()


def _prob(scaled_row: torch.Tensor, tok: int) -> float:
    """``softmax(scaled_row)[tok]``: one acceptance probability."""
    return float(torch.softmax(scaled_row, dim=-1)[tok])


def verify_tokens(logits: torch.Tensor, draft: torch.Tensor, n_draft,
                  temperature, top_k, top_p, generators):
    """Accept or reject a speculative window per row; emit its tokens.

    ``logits`` ``(n, W, vocab)`` float32 score the window ``[last, d_0 ..
    d_{k-1}]`` (``W = k + 1``), so slot ``j`` predicts the token after
    draft ``j``'s position; ``draft`` ``(n, k)`` holds the proposals,
    ``n_draft`` ``(n,)`` how many are real (0: the row emits one token
    from slot 0, as a decode step would).  Sampling parameters and
    ``generators`` are per row, as in :func:`sample_tokens`.

    Returns ``(tokens (n, W), n_emitted (n,))`` int64 on the logits'
    device: the row emits ``tokens[:n_emitted]``, ``n_emitted - 1``
    accepted drafts and the correction or bonus token.  Greedy rows
    accept the longest draft prefix equal to the target argmax and emit
    the argmax at the first mismatch.  Sampled rows accept ``d_j`` with
    probability ``p_j(d_j)`` (one uniform per drafted position, drawn
    from the row's generator) and on rejection draw from ``p_j`` with
    ``d_j`` masked out — the residual of a point-mass proposal, so the
    target distribution is preserved."""
    n, w, _ = logits.shape
    k = w - 1
    dev = logits.device
    draft = torch.as_tensor(draft, device=dev).long()
    n_draft = torch.as_tensor(n_draft, device=dev).long()
    targets = torch.argmax(logits, dim=-1)  # (n, W)
    ok = (draft == targets[:, :k]) & (torch.arange(k, device=dev)
                                       < n_draft[:, None])
    a = torch.cumprod(ok.long(), dim=1).sum(dim=1)  # accepted prefix
    final = torch.gather(targets, 1, a[:, None])[:, 0]
    sampled = _Rows(temperature, top_k, top_p, generators, dev)
    if sampled.rows:
        n_host = n_draft.cpu().tolist()
        draft_host = draft.cpu().tolist()
        for i in sampled.rows:
            g = generators[i]
            masked = sampled.scaled(logits, i)
            nd, d = n_host[i], draft_host[i]
            u = _uniforms(nd, g, dev)
            ai = 0
            while ai < nd and u[ai] < _prob(masked[ai], d[ai]):
                ai += 1
            row = masked[ai]
            if ai < nd:  # the residual: the rejected draft masked out
                row = row.clone()
                row[d[ai]] = -torch.inf
            a[i] = ai
            final[i] = _draw(torch.softmax(row, dim=-1), g)
    out = torch.where(torch.arange(w, device=dev)[None, :] < a[:, None],
                      torch.cat([draft, torch.zeros_like(draft[:, :1])],
                                dim=1), final[:, None])
    return out, a + 1


def tree_depths(parents: tuple) -> tuple:
    """Depth of every node of a static tree given by ``parents``
    (``parents[0] == -1`` for the root; ``parents[j] < j``: nodes are in
    topological order)."""
    depths = []
    for j, p in enumerate(parents):
        if j == 0:
            if p != -1:
                raise ValueError("parents[0] must be -1 (the root)")
            depths.append(0)
            continue
        if not 0 <= p < j:
            raise ValueError(
                f"parents[{j}] must be in [0, {j}) (topological order), "
                f"got {p}")
        depths.append(depths[p] + 1)
    return tuple(depths)


def verify_tree_tokens(logits: torch.Tensor, cand: torch.Tensor,
                       parents: tuple, n_cand, temperature, top_k, top_p,
                       generators):
    """Accept or reject a speculative token tree per row; emit one
    root-to-leaf path's tokens.

    ``parents`` names each node's parent (node 0 is the row's last
    committed token, nodes ``1..T`` the candidates, whose tokens sit in
    ``cand`` ``(n, T)``); ``logits`` ``(n, T+1, vocab)`` score every
    node; a row with ``n_cand`` 0 runs the plain decode.  From the root,
    each node's children are tried in node-index order.  Greedy rows
    accept the first child equal to the current node's argmax.  Sampled
    rows accept child ``c`` with probability ``p(c)`` under the current
    residual (one uniform per candidate node, drawn from the row's
    generator); a rejected child's mass is zeroed out of the residual
    before the next sibling and before the final draw.  On a chain this
    is :func:`verify_tokens` exactly, draws included.

    Returns ``(tokens (n, D+1), n_emitted (n,), path (n, D+1))`` int64,
    ``D`` the tree's depth: the row emits ``tokens[:n_emitted]``, and
    ``path[d]`` is the accepted node at depth ``d`` (``path[0] == 0``),
    whose K/V the caller commits."""
    n, t1, _ = logits.shape
    depths = tree_depths(parents)
    w = max(depths) + 1
    dev = logits.device
    cand = torch.as_tensor(cand, device=dev).long()
    n_cand = torch.as_tensor(n_cand).cpu().tolist()
    targets = torch.argmax(logits, dim=-1).cpu().tolist()  # (n, T+1)
    cand_host = cand.cpu().tolist()
    sampled = _Rows(temperature, top_k, top_p, generators, dev)
    out = torch.zeros((n, w), dtype=torch.int64)
    path = torch.zeros((n, w), dtype=torch.int64)
    n_emit = torch.ones(n, dtype=torch.int64)
    for i in range(n):
        g = generators[i] if i in sampled.rows else None
        if g is not None:
            masked = sampled.scaled(logits, i)
            res = masked[0]
            u = _uniforms(n_cand[i], g, dev)
        cur, acc_d = 0, 0
        for j in range(1, t1):
            # Node j is in play iff the walk sits at its parent and the
            # row drafted it.
            if cur != parents[j] or j - 1 >= n_cand[i]:
                continue
            tok = cand_host[i][j - 1]
            if g is None:
                accept = tok == targets[i][cur]
            else:
                accept = u[j - 1] < _prob(res, tok)
            if accept:
                cur, acc_d = j, depths[j]
                out[i, acc_d - 1] = tok
                path[i, acc_d] = j
                if g is not None:
                    res = masked[j]
            elif g is not None:
                res = res.clone()
                res[tok] = -torch.inf
        out[i, acc_d] = (targets[i][cur] if g is None
                         else int(_draw(torch.softmax(res, dim=-1), g)))
        n_emit[i] = acc_d + 1
    return out.to(dev), n_emit.to(dev), path.to(dev)
