"""Replica-consistency verification — the port of
``tpudp/utils/consistency.py``, the data-parallel desync detector.

torch DDP checks the model's parameters across processes when it wraps
a model, because the classic data-parallel fault is silent: replicas
drift (a missing gradient sync, a rank applying another update) while
the losses stay finite and plausible.  In the port every rank holds one
replica, so the check compares each leaf across the ranks of a group:

  * :func:`verify_replicas` — bit identity (or ``atol``) of every
    replicated leaf across the group's ranks, by its bytes as JAX
    compares them: one broadcast of the reference rank's leaf, which
    every rank compares with its own, then one all-gather of the
    verdicts; the ranks raise :class:`ReplicaDivergenceError`
    together, naming the first divergent leaf, the rank and the worst
    |diff| as JAX's message does.
  * :func:`verify_across_processes` — the cheap probe: every rank's
    :func:`fingerprint` (sum, sum of squares, size) must agree.
  * :func:`fingerprint` / :func:`fingerprint_coverage` — JAX's
    inclusion rule: a leaf every rank holds whole is included; a shard
    only one rank holds (zero1's optimizer shards, fsdp's parameter
    shards: a :class:`tpudp_torch.parallel.sharded.Leaf` with a group)
    is ``excluded_sharded``; anything not a tensor is
    ``excluded_non_array``.

A tree is a nested dict of tensors (and, for sharded state, ``Leaf``
objects); :func:`state_tree` builds it for a ``TrainState``.  Leaf names
follow JAX's ``keystr``: ``['params']['fc.weight']``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class ReplicaDivergenceError(RuntimeError):
    """Replicas hold different values for the same parameter."""


def _leaf_paths(tree, prefix: str = ""):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaf_paths(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaf_paths(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _sharded(leaf) -> bool:
    from tpudp_torch.parallel.sharded import Leaf

    return isinstance(leaf, Leaf) and leaf.group is not None


def _tensor(leaf):
    from tpudp_torch.parallel.sharded import Leaf

    return leaf.local if isinstance(leaf, Leaf) else leaf


def _group_size(group) -> int:
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


def _gather_device(group) -> torch.device:
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _all_gather(row: torch.Tensor, group) -> torch.Tensor:
    """``row`` of every rank of ``group``, stacked in rank order (on the
    host)."""
    row = row.to(_gather_device(group))
    rows = [torch.empty_like(row) for _ in range(_group_size(group))]
    dist.all_gather(rows, row, group=group)
    return torch.stack(rows).cpu()


def verify_replicas(tree, *, atol: float = 0.0, beat=None,
                    group=None) -> int:
    """Check that every replicated leaf of ``tree`` agrees across the
    ranks of ``group`` (default: every rank); returns the number of
    leaves compared (0 at one rank: nothing to compare).  ``atol=0``
    demands bit identity (NaN equal to NaN); raises
    :class:`ReplicaDivergenceError` naming the first divergent leaf and
    the worst |difference|.  ``beat`` (a watchdog heartbeat) is called
    after each leaf.  Sharded leaves and empty tensors (fsdp's released
    parameters) are skipped."""
    if _group_size(group) < 2:
        return 0
    src = dist.get_global_rank(group, 0) if group is not None else 0
    names, worst = [], []  # a leaf's |diff| here, -1 where it agrees
    for name, leaf in _leaf_paths(tree):
        t = _tensor(leaf)
        if not isinstance(t, torch.Tensor) or _sharded(leaf) \
                or t.numel() == 0:
            continue
        t = t.detach()
        ref = t.clone()
        _broadcast(ref, src, group)
        names.append(name)
        worst.append(-1.0 if torch.equal(ref, t) else _worst(ref, t, atol))
        if beat is not None:
            beat()
    if not names:
        return 0
    table = _all_gather(torch.tensor(worst, dtype=torch.float64), group)
    for i, name in enumerate(names):
        diverged = [r for r in range(table.shape[0]) if table[r, i] >= 0]
        if diverged:
            r = diverged[0]
            raise ReplicaDivergenceError(
                f"replicas diverged at leaf {name}: rank 0 vs rank {r}, "
                f"max |diff|={float(table[r, i]):.3e} (missing gradient "
                f"sync? a rung applying per-rank updates?)")
    return len(names)


def _worst(ref: torch.Tensor, t: torch.Tensor, atol: float) -> float:
    """-1 where ``t`` agrees with ``ref`` (bit for bit but NaN, or within
    ``atol``), else the largest |difference| (a NaN against a number
    counts as infinite)."""
    a, b = ref.double(), t.double()
    if atol == 0.0:
        same = bool(((a == b) | (a.isnan() & b.isnan())).all())
    else:
        same = bool(torch.isclose(b, a, rtol=0.0, atol=atol,
                                  equal_nan=True).all())
    if same:
        return -1.0
    return float((a - b).abs().nan_to_num(nan=float("inf")).max())


def _broadcast(t: torch.Tensor, src: int, group) -> None:
    """``t`` from global rank ``src`` to every rank of ``group``, in
    place (through the host under gloo)."""
    dev = _gather_device(group)
    buf = t if t.device == dev else t.to(dev)
    dist.broadcast(buf, src=src, group=group)
    if buf is not t:
        t.copy_(buf)


def fingerprint(tree) -> torch.Tensor:
    """``[sum, sum of squares, size]`` (float64, on the host) over the
    included leaves of ``tree`` (:func:`fingerprint_coverage`): ranks
    exchange these three numbers instead of the weights.  Unequal
    fingerprints prove divergence; equal ones do not prove equality.
    The sums run on each leaf's own device in float64."""
    sums = torch.zeros(3, dtype=torch.float64)
    for _, leaf in _leaf_paths(tree):
        if _sharded(leaf) or not isinstance(_tensor(leaf), torch.Tensor):
            continue
        a = _tensor(leaf).detach().double()
        sums += torch.stack([a.sum(), (a * a).sum(),
                             torch.tensor(float(a.numel()),
                                          dtype=torch.float64,
                                          device=a.device)]).cpu()
    return sums


def verify_across_processes(tree, group=None) -> None:
    """Every rank's :func:`fingerprint` of ``tree`` must equal rank 0's
    (a no-op at one rank); raises :class:`ReplicaDivergenceError`."""
    if _group_size(group) < 2:
        return
    fps = _all_gather(fingerprint(tree), group)
    for r in range(fps.shape[0]):
        if not torch.equal(fps[r], fps[0]):
            raise ReplicaDivergenceError(
                f"process {r} fingerprint {fps[r].tolist()} != process 0 "
                f"{fps[0].tolist()} — replicas diverged across hosts "
                f"(missing cross-host gradient sync?)")


def fingerprint_coverage(tree) -> dict:
    """Every leaf of ``tree`` by how :func:`fingerprint` (and the
    in-step SDC checksum, which applies the same rule) treats it:
    ``included``, ``excluded_sharded`` (a shard one rank holds) or
    ``excluded_non_array``."""
    out: dict[str, list[str]] = {"included": [], "excluded_sharded": [],
                                 "excluded_non_array": []}
    for path, leaf in _leaf_paths(tree):
        if _sharded(leaf):
            out["excluded_sharded"].append(path)
        elif isinstance(_tensor(leaf), torch.Tensor):
            out["included"].append(path)
        else:
            out["excluded_non_array"].append(path)
    return out


def state_tree(state) -> dict:
    """A ``TrainState`` as this rank holds it, as JAX's TrainState pytree:
    ``step`` and ``loss_sum``, ``params`` (the model's parameters; a
    sharded rung's leaves as ``Leaf`` objects), ``batch_stats`` (the
    floating buffers), ``opt_state`` (the optimizer's per-parameter
    buffers keyed by the parameters' names — a sharded leaf's buffer
    sharded alike — and the ``skip_nonfinite`` counters), the
    ``compress`` residuals (this rank's own: sharded), and ``obs_norms``
    and ``sdc_fp`` where allocated."""
    import torch.distributed as dist

    from tpudp_torch.parallel.sharded import Leaf

    opt = state.optimizer
    if state.layout is not None:
        named = [(lf.name, lf) for lf in state.layout.leaves]
        stats = {k: b for k, b in state.layout.buffers.items()}
    else:
        named = [(n, Leaf(n, p)) for n, p in state.model.named_parameters()]
        stats = {k: b for k, b in state.model.named_buffers()
                 if b.is_floating_point()}
    params, opt_state = {}, {}
    if getattr(state.layout, "shard_params", True) is False:
        # zero1: the module holds every parameter whole on every rank;
        # only the optimizer's tensors are shards.
        params = dict(state.model.named_parameters())
    for name, lf in named:
        if getattr(state.layout, "shard_params", True) is not False:
            params[name] = lf if lf.group is not None else lf.local
        for key, value in opt.state.get(lf.local, {}).items():
            if isinstance(value, torch.Tensor) and value.dim():
                buf = (Leaf(name, value, lf.group) if lf.group is not None
                       else value)
                opt_state.setdefault(key, {})[name] = buf
    if state.skip is not None:
        opt_state.update(state.skip)
    tree = {"step": torch.tensor(state.step), "params": params,
            "batch_stats": stats, "opt_state": opt_state,
            "loss_sum": state.loss_sum}
    if state.compressor is not None:
        group = state.compressor.group or dist.group.WORLD
        tree["compress"] = [Leaf("error", e, group)
                            for e in state.compressor.error]
    for slot in ("obs_norms", "sdc_fp"):
        if getattr(state, slot) is not None:
            tree[slot] = getattr(state, slot)
    return tree
