"""The GSPMD rungs of ``tpudp/train.py`` — tensor parallelism, FSDP,
ZeRO-1 and sequence parallelism — written out by hand over
``torch.distributed`` process groups.

JAX annotates shardings and lets XLA partition the single-device
program; here each rung states its collectives:

  * **tp** (:func:`make_tp_train_step`, mesh ``data x model``): Megatron.
    ``qkv`` and ``mlp_fc`` are column-parallel, ``proj`` and ``mlp_proj``
    row-parallel with their outputs summed over ``model``
    (:func:`~tpudp_torch.parallel.collectives.copy_to_group` /
    :func:`~tpudp_torch.parallel.collectives.reduce_from_group` around
    them); each rank holds ``H/n`` heads and runs attention on them (with
    ``attn_impl='flash'``, through the K1-K3 kernels).  ``qkv`` splits by
    heads — q, k and v each — where JAX's ``P(None, 'model')`` splits the
    fused ``(d, 3d)`` kernel into contiguous column blocks; the
    checkpoint tree gathers back to JAX's global layout.  ``wte`` splits
    over vocab when the axis divides it (JAX's fallback rule): the lookup
    is masked and summed, the tied head's logits gathered before the
    loss.
  * **fsdp** (:func:`make_fsdp_train_step`): each parameter of at least
    ``min_size`` elements is sharded on the dim
    :func:`~tpudp_torch.parallel.tensor.fsdp_dim` picks; a step gathers
    the model (one all-gather), reduce-scatters the gradients as a mean
    (one reduce-scatter) and updates the shards, and the full parameters
    are released between steps.
  * **zero1** (:func:`make_zero1_train_step`): the parameters stay
    whole; the gradients are reduce-scattered by the same rule into the
    sharded optimizer state, and the updated shards all-gathered.
  * **sp** (:func:`make_seq_parallel_train_step`, mesh ``data x seq``):
    every rank holds a ``(batch, seq)`` block of the tokens, ring
    attention runs over ``seq`` (bound by :func:`tpudp_torch.mesh.
    bind_axes`), and the loss and gradients are means over the mesh.

Every rung returns a :class:`tpudp_torch.train.TrainState` whose
``model`` is this rank's module and whose ``layout`` (:class:`Layout`)
maps its tensors to the JAX package's global checkpoint tree, so
``state_to_jax``, ``load_state`` and the checkpoints work unchanged.
The step contract is JAX's: ``step(state, inputs, targets) -> (state,
loss)`` on this rank's block of the global batch (``shard_for``), with
the loss the global batch's mean cross entropy on every rank.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from tpudp_torch.mesh import Mesh, MeshND, bind_axes
from tpudp_torch.models.norm import DATA_AXIS, BatchNorm
from tpudp_torch.parallel import collectives as C
from tpudp_torch.parallel.tensor import (MODEL_AXIS, fsdp_dim, gpt2_tp_rules,
                                         llama_tp_rules, tree_shardings,
                                         vgg_tp_rules)
from tpudp_torch.train import (OptimizerSpec, TrainState, _FiniteGuard,
                               _adamw, _codec, batch_stats, eval_metrics,
                               skip_counters, state_to_jax, with_aux)
from tpudp_torch.utils.checkpoint import _to_cpu

#: The ROADMAP item of the strategies still to port.
LLAMA_ITEM = "Queue 1 item 5 (slice 6b: LLaMA training)"


# -- mesh axes --------------------------------------------------------------

def axis_of(mesh, name: str | None) -> tuple:
    """``(group, size, coordinate)`` of ``mesh``'s axis ``name``; the
    1-D :class:`~tpudp_torch.mesh.Mesh` is the default group's ``data``
    axis.  A missing axis (``name`` None) is ``(None, 1, 0)``."""
    if name is None:
        return None, 1, 0
    if isinstance(mesh, Mesh):
        if name != DATA_AXIS:
            raise ValueError(f"a 1-D Mesh has only the {DATA_AXIS!r} axis; "
                             f"got {name!r}")
        return dist.group.WORLD, mesh.size, mesh.rank
    if not isinstance(mesh, MeshND):
        raise TypeError(f"mesh must be a tpudp_torch.mesh.Mesh or MeshND, "
                        f"got {type(mesh).__name__}")
    group = mesh.group(name)
    return group, mesh.shape[name], mesh.coords[name]


def rows(a, index: int, parts: int, dim: int = 0):
    """Part ``index`` of ``parts`` equal contiguous parts of ``a`` along
    ``dim`` (a rank's block of a global batch)."""
    if a.shape[dim] % parts:
        raise ValueError(f"global dim {dim} of size {a.shape[dim]} does "
                         f"not split into {parts} equal parts")
    n = a.shape[dim] // parts
    return a.narrow(dim, index * n, n) if isinstance(a, torch.Tensor) \
        else np.take(a, range(index * n, (index + 1) * n), axis=dim)


# -- leaves and layouts -----------------------------------------------------

def _same(t):
    return t


@dataclass
class Leaf:
    """One trainable tensor of a rung: ``name`` in the single-device
    model's state dict, this rank's ``local`` tensor (what the optimizer
    updates), the ``group`` it is sharded over (None: replicated), and
    the maps between the global tensor and ``local``."""

    name: str
    local: torch.Tensor
    group: object = None
    scatter: Callable = _same
    gather: Callable = _same


def dim_leaf(name, local, dim: int, group, n: int, r: int) -> Leaf:
    """A leaf split into ``n`` equal contiguous blocks along ``dim``."""
    return Leaf(name, local, group,
                scatter=lambda g: g.chunk(n, dim)[r],
                gather=lambda t: C.all_gather(t, dim, group))


def heads_leaf(name, local, group, n: int, r: int) -> Leaf:
    """GPT-2's fused ``qkv`` weight ``(3d, d)`` or bias ``(3d,)`` split
    by heads: rank r holds its block of q, of k and of v."""
    def scatter(g):
        parts = g.reshape((3, -1) + tuple(g.shape[1:]))
        return parts.chunk(n, 1)[r].reshape((-1,) + tuple(g.shape[1:]))

    def gather(t):
        parts = t.reshape((3, -1) + tuple(t.shape[1:]))
        full = C.all_gather(parts, 1, group)
        return full.reshape((-1,) + tuple(t.shape[1:]))

    return Leaf(name, local, group, scatter=scatter, gather=gather)


def _opt_buffers(opt) -> tuple:
    if _adamw(opt):
        return ("exp_avg", "exp_avg_sq")
    return ("momentum_buffer",) if opt.param_groups[0]["momentum"] else ()


_JAX_OPT_NAMES = {"exp_avg": "mu", "exp_avg_sq": "nu",
                  "momentum_buffer": "momentum"}


class Layout:
    """A rung's map between its ranks' tensors and the JAX package's
    global checkpoint tree (the one-device tree of
    :func:`tpudp_torch.train.state_to_jax`, through ``post`` — the
    pipeline's stacked ``blocks`` — where the JAX rung keeps another
    layout).  ``leaves`` are the optimizer's tensors, in the order every
    rank walks them; ``buffers`` the module's replicated buffers by
    name; ``codec`` the model family's ``(to_jax, from_jax)``;
    ``after_load(state)`` refreshes what derives from the leaves."""

    def __init__(self, leaves: list, codec, *, buffers: dict | None = None,
                 post=None, pre=None, after_load=None):
        self.leaves, self.codec = leaves, codec
        self.buffers = buffers or {}
        self.post, self.pre, self.after_load = post, pre, after_load

    def _global(self, tensors: dict) -> dict:
        return {leaf.name: leaf.gather(tensors[leaf.name].detach())
                for leaf in self.leaves}

    def to_jax(self, state: TrainState) -> dict:
        to_jax, _ = self.codec
        opt = state.optimizer
        sd = self._global({lf.name: lf.local for lf in self.leaves})
        sd.update({k: b.detach() for k, b in self.buffers.items()})
        params, stats = to_jax(sd)
        opt_state: dict = {}
        for key in _opt_buffers(opt):
            local = {lf.name: opt.state.get(lf.local, {}).get(key)
                     for lf in self.leaves}
            local = {k: torch.zeros_like(lf.local) if v is None else v
                     for (k, v), lf in zip(local.items(), self.leaves)}
            opt_state[_JAX_OPT_NAMES[key]] = to_jax(self._global(local))[0]
        if _adamw(opt):
            steps = [opt.state.get(lf.local, {}).get("step")
                     for lf in self.leaves]
            count = next((s for s in steps if s is not None), 0)
            opt_state["count"] = torch.tensor(int(count), dtype=torch.int32)
        if state.skip is not None:
            opt_state.update(state.skip)
        tree = {"step": torch.tensor(state.step, dtype=torch.int32),
                "params": params, "batch_stats": stats,
                "opt_state": opt_state, "loss_sum": state.loss_sum.detach()}
        return self.post(tree) if self.post is not None else tree

    def load(self, state: TrainState, tree: dict) -> None:
        tree = _to_cpu(tree)
        if self.pre is not None:
            tree = self.pre(tree)
        _, from_jax = self.codec
        opt = state.optimizer
        stats = tree.get("batch_stats", {})
        sd = from_jax(tree["params"], stats)
        with torch.no_grad():
            for lf in self.leaves:
                lf.local.copy_(lf.scatter(sd[lf.name]))
            for k, b in self.buffers.items():
                b.copy_(sd[k])
        state.step = int(tree["step"])
        state.loss_sum.copy_(torch.as_tensor(np.array(tree["loss_sum"])))
        ost = tree.get("opt_state", {})
        for lf in self.leaves:
            opt.state.pop(lf.local, None)
        if state.step:
            for key in _opt_buffers(opt):
                glob = from_jax(ost[_JAX_OPT_NAMES[key]], stats)
                for lf in self.leaves:
                    opt.state[lf.local][key] = torch.empty_like(
                        lf.local).copy_(lf.scatter(glob[lf.name]))
            if _adamw(opt):
                group = opt.param_groups[0]
                on_device = group.get("capturable") or group.get("fused")
                for lf in self.leaves:
                    opt.state[lf.local]["step"] = torch.tensor(
                        float(ost["count"]), dtype=torch.float32,
                        device=lf.local.device if on_device else "cpu")
        if state.skip is not None:
            for key, t in state.skip.items():
                t.copy_(torch.as_tensor(np.array(ost[key])))
        if self.after_load is not None:
            self.after_load(state)


def state_nbytes(state: TrainState) -> dict:
    """Bytes this rank holds between steps: ``params`` (every distinct
    parameter tensor: the module's and, where a rung keeps them apart,
    the optimizer's shards) and ``opt_state`` (the optimizer's
    buffers)."""
    seen, params = set(), 0
    tensors = list(state.model.parameters())
    if state.layout is not None:
        tensors += [lf.local for lf in state.layout.leaves]
    for t in tensors:
        if id(t) not in seen:
            seen.add(id(t))
            params += t.numel() * t.element_size()
    opt = sum(v.numel() * v.element_size()
              for st in state.optimizer.state.values()
              for v in st.values() if isinstance(v, torch.Tensor))
    return {"params": params, "opt_state": opt}


def new_state(model: nn.Module, spec: OptimizerSpec, leaves: list,
              layout: Layout) -> TrainState:
    """A TrainState over ``model`` whose optimizer updates the leaves."""
    device = leaves[0].local.device
    return TrainState(model=model,
                      optimizer=spec.build([lf.local for lf in leaves]),
                      step=0,
                      loss_sum=torch.zeros((), dtype=torch.float32,
                                           device=device),
                      skip=skip_counters(spec, device), layout=layout)


def from_standard(state: TrainState, built: TrainState) -> TrainState:
    """``built`` loaded from a single-device-layout ``state`` (its
    parameters, optimizer buffers, step and loss): JAX's rungs take the
    state as it stands, a resumed one too."""
    built.layout.load(built, state_to_jax(state))
    return built


# -- the update -------------------------------------------------------------

def mean_over(tensors: list, group, n: int) -> None:
    """Each tensor replaced by its mean over ``group`` (``n`` ranks),
    with one all-reduce of their concatenation."""
    if n == 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    C.all_reduce(flat, group)
    flat /= n
    for t, piece in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(piece.reshape(t.shape))


def _clip(leaves: list, max_norm: float) -> None:
    """optax ``clip_by_global_norm`` over a rung's leaves: a sharded
    leaf's squares are summed over its group, a replicated one's counted
    once."""
    by_group: dict = {}
    for lf in leaves:
        by_group.setdefault(lf.group, []).append(lf.local.grad)
    total = None
    for group, grads in by_group.items():
        sq = torch.stack([g.float().pow(2).sum() for g in grads]).sum()
        if group is not None:
            C.all_reduce(sq, group)
        total = sq if total is None else total + sq
    norm = total.sqrt()
    keep = norm < max_norm
    for lf in leaves:
        g = lf.local.grad
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def apply_update(state: TrainState, spec: OptimizerSpec, leaves: list,
                 finite_group=None) -> None:
    """Clip, set the step's learning rate and update the leaves (every
    leaf has its gradient); ``finite_group``: the ranks whose
    ``skip_nonfinite`` decisions are taken together."""
    params = [lf.local for lf in leaves]
    guard = None
    if spec.skip_nonfinite is not None:
        guard = _FiniteGuard(state, params, spec.skip_nonfinite,
                             finite_group)
    if spec.clip_norm is not None:
        _clip(leaves, spec.clip_norm)
    for group in state.optimizer.param_groups:
        group["lr"] = spec.lr_at(state.step)
    state.optimizer.step()
    if guard is not None:
        guard.finish()


def refuse_skip(spec: OptimizerSpec, rung: str) -> None:
    if spec.skip_nonfinite is not None:
        raise ValueError(
            f"skip_nonfinite supports the dp, zero1 and sp rungs only (got "
            f"{rung!r}): its decision needs the whole gradient, and {rung}'s "
            "update sees shards")


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor):
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1).long())


def grads_of(leaves: list) -> list:
    """Each leaf's gradient, zeros where the backward left none."""
    for lf in leaves:
        if lf.local.grad is None:
            lf.local.grad = torch.zeros_like(lf.local)
    return [lf.local.grad for lf in leaves]


def _zero_grads(*tensors) -> None:
    for t in tensors:
        t.grad = None


def require_gpt2(model, rung: str) -> None:
    from tpudp_torch.models import gpt2, llama

    if isinstance(model, llama.Llama):
        raise NotImplementedError(
            f"strategy {rung!r} on a LLaMA model is not ported yet: "
            f"ROADMAP.md {LLAMA_ITEM}")
    if not isinstance(model, gpt2.GPT2):
        raise TypeError(f"strategy {rung!r} drives tpudp_torch.models.gpt2."
                        f"GPT2; got {type(model).__name__}")


def eval_sums(model, inputs, labels, weights, group) -> tuple:
    """``(loss_sum, correct, count)`` of this rank's block, summed over
    ``group`` (the ranks holding distinct blocks of the global batch)."""
    sums = eval_metrics(model, inputs, labels, weights)
    if group is not None:
        C.all_reduce(sums, group)
    return tuple(sums.unbind())


# -- fsdp and zero1 ---------------------------------------------------------

def _gather_full(shards: list, dims: list, group, n: int) -> list:
    """The full tensors of ``shards`` (chunks along ``dims``), with one
    all-gather of their concatenation."""
    flat = torch.cat([s.detach().reshape(-1) for s in shards])
    rows_ = C.all_gather(flat, 0, group).reshape(n, -1)
    sizes = [s.numel() for s in shards]
    pieces = [row.split(sizes) for row in rows_]
    return [torch.cat([pieces[j][i].reshape(s.shape) for j in range(n)],
                      dims[i]) for i, s in enumerate(shards)]


def _reduce_scatter_mean(grads: list, dims: list, group, n: int) -> list:
    """This rank's chunk of each gradient's mean over ``group``, with one
    reduce-scatter of their concatenation."""
    chunks = [g.chunk(n, d) for g, d in zip(grads, dims)]
    flat = torch.cat([c[j].reshape(-1) for j in range(n) for c in chunks])
    mine = C.reduce_scatter(flat, 0, group) / n
    shapes = [c[0].shape for c in chunks]
    return [p.reshape(s) for p, s in
            zip(mine.split([math.prod(s) for s in shapes]), shapes)]


class DataSharded(Layout):
    """The layout of fsdp's and zero1's parameters over the ``data``
    group: the module's parameters, and for each one :func:`fsdp_dim`
    shards, this rank's shard (the optimizer's tensor)."""

    def __init__(self, model: nn.Module, group, n: int, r: int,
                 min_size: int, shard_params: bool):
        self.group, self.n = group, n
        self.shard_params = shard_params
        self.params, self.dims, leaves = [], [], []
        self.replicated = []
        for name, p in model.named_parameters():
            dim = fsdp_dim(p.shape, n, min_size)
            if dim is None:
                self.replicated.append(p)
                leaves.append(Leaf(name, p))
                continue
            shard = nn.Parameter(p.detach().chunk(n, dim)[r].clone())
            self.params.append(p)
            self.dims.append(dim)
            leaves.append(dim_leaf(name, shard, dim, group, n, r))
        super().__init__(leaves, _codec(model),
                         buffers={k: b for k, b in model.named_buffers()
                                  if b.is_floating_point()},
                         after_load=lambda state: self.after_update())
        self.shards = [lf.local for lf in leaves if lf.group is not None]

    def materialize(self) -> None:
        """The module's sharded parameters gathered whole."""
        if not self.params:
            return
        full = _gather_full(self.shards, self.dims, self.group, self.n)
        for p, f in zip(self.params, full):
            p.data = f

    def release(self) -> None:
        """Drop the module's gathered copies (fsdp, between steps)."""
        for p in self.params:
            p.data = p.data.new_empty((0,))

    def after_update(self) -> None:
        """After the shards moved: fsdp drops the gathered module, zero1
        gathers the new parameters into it."""
        if self.shard_params:
            self.release()
        else:
            self.materialize()


def _data_sharded_step(model, spec: OptimizerSpec, mesh, state: TrainState,
                       data_axis: str, min_size: int, shard_params: bool,
                       aux_loss_coef: float):
    """The fsdp (``shard_params``) or zero1 rung: ``(state, step)``."""
    group, n, r = axis_of(mesh, data_axis)
    if spec.compress is not None:
        raise ValueError(f"compress={spec.compress!r} needs the shard_map "
                         "DP rung")
    if shard_params:  # zero1's ranks take the skip decision together
        refuse_skip(spec, "fsdp")
    for m in model.modules():
        if isinstance(m, BatchNorm):  # JAX's global program: SyncBN
            m.bn_axis = DATA_AXIS
    sharded = DataSharded(model, group, n, r, min_size, shard_params)
    stats = batch_stats(model)
    built = from_standard(state, new_state(model, spec, sharded.leaves,
                                           sharded))

    def step(st: TrainState, inputs, targets):
        if shard_params:
            sharded.materialize()
        _zero_grads(*model.parameters(), *sharded.shards)
        logits = model(inputs, train=True)
        ce = cross_entropy(logits, targets)
        with_aux(model, ce, aux_loss_coef).backward()
        full = [p.grad if p.grad is not None else torch.zeros_like(p)
                for p in sharded.params]
        if full:
            for shard, g in zip(sharded.shards, _reduce_scatter_mean(
                    full, sharded.dims, group, n)):
                shard.grad = g
        rep = grads_of([Leaf("", p) for p in sharded.replicated])
        loss = ce.detach().reshape(1)
        mean_over(rep + [loss] + stats, group, n)
        apply_update(st, spec, sharded.leaves,
                     None if shard_params else group)
        sharded.after_update()
        st.step += 1
        loss = loss.reshape(())
        st.loss_sum += loss
        return st, loss

    return built, step


def make_fsdp_train_step(model: nn.Module, optimizer: OptimizerSpec, mesh,
                         state: TrainState, *, data_axis: str = DATA_AXIS,
                         min_size: int = 1024, aux_loss_coef: float = 0.01):
    """FSDP / ZeRO-3 (JAX's ``make_fsdp_train_step``): parameters and
    optimizer state sharded over ``data_axis`` by ``fsdp_shardings``;
    returns ``(sharded_state, step)``.  ``state`` is a single-device
    layout :class:`~tpudp_torch.train.TrainState` of ``model`` (from
    ``init_state``); ``model`` becomes the rung's module."""
    return _data_sharded_step(model, optimizer, mesh, state, data_axis,
                              min_size, True, aux_loss_coef)


def make_zero1_train_step(model: nn.Module, optimizer: OptimizerSpec, mesh,
                          state: TrainState, *, data_axis: str = DATA_AXIS,
                          min_size: int = 1024,
                          aux_loss_coef: float = 0.01):
    """ZeRO-1 (JAX's ``make_zero1_train_step``): parameters replicated,
    optimizer state sharded over ``data_axis`` by ``zero1_shardings``;
    returns ``(sharded_state, step)``."""
    return _data_sharded_step(model, optimizer, mesh, state, data_axis,
                              min_size, False, aux_loss_coef)


def data_sharded_eval(mesh, state: TrainState, data_axis: str = DATA_AXIS):
    """Eval of the fsdp and zero1 rungs: the global batch's metrics."""
    group, n, _ = axis_of(mesh, data_axis)
    sharded = state.layout

    def eval_step(st, inputs, labels, weights):
        if sharded.shard_params:
            sharded.materialize()
        try:
            return eval_sums(st.model, inputs, labels, weights,
                             group if n > 1 else None)
        finally:
            if sharded.shard_params:
                sharded.release()

    return eval_step


# -- tp ---------------------------------------------------------------------

class _TPAttention(nn.Module):
    def __init__(self, d: int, n: int):
        super().__init__()
        self.qkv = nn.Linear(d, 3 * d // n)
        self.proj = nn.Linear(d // n, d)


class _TPBlock(nn.Module):
    def __init__(self, cfg, n: int):
        super().__init__()
        from tpudp_torch.models.moe import MoeMlp

        d, f = cfg.d_model, cfg.mlp_ratio * cfg.d_model
        self.ln_1 = nn.LayerNorm(d, eps=cfg.ln_eps)
        self.attn = _TPAttention(d, n)
        self.ln_2 = nn.LayerNorm(d, eps=cfg.ln_eps)
        if cfg.mlp_impl == "moe":  # replicated: JAX's rules leave it whole
            self.moe = MoeMlp(d, cfg.num_experts, cfg.mlp_ratio,
                              cfg.capacity_factor, cfg.moe_top_k, None,
                              cfg.dtype)
        else:
            self.mlp_fc = nn.Linear(d, f // n)
            self.mlp_proj = nn.Linear(f // n, d)


def _row(lin: nn.Linear, x, dtype, group):
    """A row-parallel layer: the partial products summed over the group,
    then the (replicated) bias."""
    y = F.linear(x.to(dtype), lin.weight.to(dtype))
    return C.reduce_from_group(y, group) + lin.bias.to(dtype)


class TPGPT2(nn.Module):
    """This rank's GPT-2 under Megatron tensor parallelism over ``group``
    (``n`` ranks, this one ``r``): the single-device model's parameter
    names with local shapes — ``qkv`` ``(3d/n, d)`` (its heads' q, k and
    v rows), ``proj`` ``(d, d/n)``, ``mlp_fc`` ``(f/n, d)``, ``mlp_proj``
    ``(d, f/n)``, ``wte`` ``(V/n, d)`` when ``vocab_split``."""

    def __init__(self, cfg, group, n: int, r: int, vocab_split: bool):
        super().__init__()
        self.config, self.group, self.n, self.r = cfg, group, n, r
        self.vocab_split = vocab_split
        v = cfg.vocab_size // n if vocab_split else cfg.vocab_size
        self.wte = nn.Embedding(v, cfg.d_model)
        self.wpe = nn.Embedding(cfg.max_seq_len, cfg.d_model)
        self.h = nn.ModuleList(_TPBlock(cfg, n)
                               for _ in range(cfg.num_layers))
        self.ln_f = nn.LayerNorm(cfg.d_model, eps=cfg.ln_eps)

    def _embed(self, tokens):
        dtype = self.config.dtype
        w = self.wte.weight.to(dtype)
        if not self.vocab_split:
            return w[tokens]
        vl = w.shape[0]
        ids = tokens - self.r * vl
        valid = (ids >= 0) & (ids < vl)
        e = w[ids.clamp(0, vl - 1)] * valid[..., None].to(dtype)
        return C.reduce_from_group(e, self.group)

    def forward(self, tokens: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        del train
        from tpudp_torch.models.gpt2 import dense, layer_norm
        from tpudp_torch.ops.attention import multihead_attention

        cfg, g = self.config, self.group
        dtype = cfg.dtype
        b, t = tokens.shape
        hl, dh = cfg.num_heads // self.n, cfg.d_model // cfg.num_heads
        impl = "dense" if cfg.attn_impl == "ring" else cfg.attn_impl
        x = self._embed(tokens) + self.wpe.weight.to(dtype)[
            torch.arange(t, device=tokens.device)]
        for blk in self.h:
            a = C.copy_to_group(layer_norm(blk.ln_1, x), g)
            qkv = dense(blk.attn.qkv, a, dtype)
            q, k, v = (z.reshape(b, t, hl, dh) for z in qkv.chunk(3, -1))
            out = multihead_attention(q, k, v, causal=True, impl=impl,
                                      dtype=dtype)
            x = x + _row(blk.attn.proj, out.reshape(b, t, -1), dtype, g)
            if hasattr(blk, "moe"):
                x = x + blk.moe(layer_norm(blk.ln_2, x))
                continue
            a = C.copy_to_group(layer_norm(blk.ln_2, x), g)
            h = F.gelu(dense(blk.mlp_fc, a, dtype), approximate="tanh")
            x = x + _row(blk.mlp_proj, h, dtype, g)
        hidden = layer_norm(self.ln_f, x).to(dtype)
        w = self.wte.weight.to(dtype)
        if not self.vocab_split:
            return (hidden @ w.T).float()
        local = (C.copy_to_group(hidden, g) @ w.T).float()
        return C.gather_from_group(local, -1, g)


def _tp_leaves(model: TPGPT2, group, n: int, r: int) -> list:
    """The TP module's parameters as leaves of the single-device
    model's names."""
    leaves = []
    for name, p in model.named_parameters():
        if name.endswith("attn.qkv.weight") or name.endswith("attn.qkv.bias"):
            leaves.append(heads_leaf(name, p, group, n, r))
        elif name.endswith("mlp_fc.weight") or name.endswith("mlp_fc.bias"):
            leaves.append(dim_leaf(name, p, 0, group, n, r))
        elif (name.endswith("attn.proj.weight")
              or name.endswith("mlp_proj.weight")):
            leaves.append(dim_leaf(name, p, 1, group, n, r))
        elif name == "wte.weight" and model.vocab_split:
            leaves.append(dim_leaf(name, p, 0, group, n, r))
        else:
            leaves.append(Leaf(name, p))
    return leaves


def _check_rules(model, rules) -> str:
    """The model axis of Megatron's GPT-2 ``rules``; the other tables
    raise."""
    if callable(rules):
        raise ValueError("callable rules are the fsdp and zero1 rungs: use "
                         "make_fsdp_train_step / make_zero1_train_step")
    rules = tuple((p, tuple(s) if s is not None else None)
                  for p, s in rules)
    axes = {a for _, s in rules if s for a in s if a is not None}
    axis = next(iter(axes)) if len(axes) == 1 else MODEL_AXIS
    if rules in (llama_tp_rules(axis), vgg_tp_rules(axis)):
        family = "LLaMA" if rules == llama_tp_rules(axis) else "VGG"
        raise NotImplementedError(
            f"tensor parallelism by the {family} rules is not ported yet: "
            f"ROADMAP.md {LLAMA_ITEM}")
    if rules != gpt2_tp_rules(axis):
        raise ValueError("the port's TP step is Megatron's layout for GPT-2: "
                         "rules must be gpt2_tp_rules(model_axis)")
    require_gpt2(model, "tp")
    return axis


def make_tp_train_step(model: nn.Module, optimizer: OptimizerSpec, mesh,
                       state: TrainState, rules, *,
                       data_axis: str = DATA_AXIS,
                       aux_loss_coef: float = 0.01):
    """DP x TP (JAX's ``make_tp_train_step``) over ``mesh``'s
    ``data_axis`` and the rules' model axis: returns ``(tp_state,
    step)``, ``tp_state.model`` this rank's :class:`TPGPT2`.  ``rules``
    must be :func:`~tpudp_torch.parallel.tensor.gpt2_tp_rules`; the
    LLaMA and VGG tables raise naming their ROADMAP item."""
    axis = _check_rules(model, rules)
    refuse_skip(optimizer, "tp")
    if optimizer.compress is not None:
        raise ValueError(f"compress={optimizer.compress!r} needs the "
                         "shard_map DP rung")
    cfg = model.config
    group, n, r = axis_of(mesh, axis)
    dgroup, dn, _ = axis_of(mesh, data_axis)
    f = cfg.mlp_ratio * cfg.d_model
    if cfg.num_heads % n or f % n:
        raise ValueError(f"tensor parallelism over {n} ranks needs heads "
                         f"({cfg.num_heads}) and MLP width ({f}) divisible "
                         f"by {n}")
    device = next(model.parameters()).device
    local = TPGPT2(cfg, group, n, r, cfg.vocab_size % n == 0).to(device)
    leaves = _tp_leaves(local, group, n, r)
    layout = Layout(leaves, _codec(model))
    built = from_standard(state, new_state(local, optimizer, leaves, layout))
    local.requires_grad_(True).train()

    def step(st: TrainState, inputs, targets):
        _zero_grads(*local.parameters())
        ce = cross_entropy(local(inputs, train=True), targets)
        with_aux(local, ce, aux_loss_coef).backward()
        loss = ce.detach().reshape(1)
        mean_over(grads_of(leaves) + [loss], dgroup, dn)
        apply_update(st, optimizer, leaves)
        st.step += 1
        loss = loss.reshape(())
        st.loss_sum += loss
        return st, loss

    return built, step


def tp_eval(mesh, state: TrainState, data_axis: str = DATA_AXIS):
    """Eval of the tp rung: each model rank of a data row computes the
    row's metrics; the rows' sums are added over ``data``."""
    group, n, _ = axis_of(mesh, data_axis)

    def eval_step(st, inputs, labels, weights):
        return eval_sums(st.model, inputs, labels, weights,
                         group if n > 1 else None)

    return eval_step


# -- sp ---------------------------------------------------------------------

def _check_ring(model, seq_axis: str) -> None:
    require_gpt2(model, "sp")
    cfg = model.config
    if cfg.attn_impl != "ring" or cfg.seq_axis != seq_axis:
        raise ValueError(f"sequence parallelism needs a model built with "
                         f"attn_impl='ring', seq_axis={seq_axis!r} (got "
                         f"{cfg.attn_impl!r}, {cfg.seq_axis!r})")


def make_seq_parallel_train_step(model: nn.Module, optimizer: OptimizerSpec,
                                 mesh, *, data_axis: str = DATA_AXIS,
                                 seq_axis: str = "seq",
                                 aux_loss_coef: float = 0.01):
    """DP x SP (JAX's ``make_seq_parallel_train_step``): ``step(state,
    tokens, targets)`` on this rank's ``(batch, seq)`` block, ring
    attention over ``seq_axis``; the loss is the mean of the local
    tokens, then the mean over the mesh, and the gradients are
    all-reduced over the whole mesh.  The state is the single-device
    one (``init_state``), replicated."""
    _check_ring(model, seq_axis)
    seq_group, _, _ = axis_of(mesh, seq_axis)
    axis_of(mesh, data_axis)
    world = dist.group.WORLD
    n = dist.get_world_size(world)

    def step(st: TrainState, tokens, targets):
        opt = st.optimizer
        opt.zero_grad(set_to_none=True)
        with bind_axes({seq_axis: seq_group}):
            ce = cross_entropy(model(tokens, train=True), targets)
            with_aux(model, ce, aux_loss_coef).backward()
        leaves = [Leaf(name, p) for name, p in model.named_parameters()]
        loss = ce.detach().reshape(1)
        mean_over(grads_of(leaves) + [loss], world, n)
        apply_update(st, optimizer, leaves)
        st.step += 1
        loss = loss.reshape(())
        st.loss_sum += loss
        return st, loss

    return step


def make_sp_eval_step(model: nn.Module, mesh, *, data_axis: str = DATA_AXIS,
                      seq_axis: str = "seq"):
    """Sequence-parallel eval (JAX's ``make_sp_eval_step``): per-token
    metrics of this rank's block, summed over the mesh."""
    _check_ring(model, seq_axis)
    seq_group, _, _ = axis_of(mesh, seq_axis)
    world = dist.group.WORLD

    def eval_step(state, tokens, targets, weights):
        del state
        with bind_axes({seq_axis: seq_group}):
            return eval_sums(model, tokens, targets, weights, world)

    return eval_step


def resolve_state_shardings(state: TrainState, mesh, rules) -> dict:
    """``{path: (dim, axis) or None}`` over the state's checkpoint tree,
    JAX's ``resolve_state_shardings``: ``rules`` is a partition-rule
    table (resolved against ``params`` and ``opt_state``) or a callable
    ``(tree, mesh) -> shardings`` (e.g. over
    :func:`~tpudp_torch.parallel.tensor.fsdp_shardings`).  The JAX
    layout's view of a rung's placement: the TP step shards ``qkv`` by
    heads inside the one ``(dim, axis)`` this reports."""
    tree = state_to_jax(state)
    if callable(rules):
        return rules(tree, mesh)
    sizes = dict(mesh.shape) if isinstance(mesh, MeshND) else {
        DATA_AXIS: mesh.size}
    return tree_shardings({"params": tree["params"],
                           "opt_state": tree["opt_state"]}, rules, sizes)
