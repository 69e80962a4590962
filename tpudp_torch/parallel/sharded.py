"""The GSPMD rungs of ``tpudp/train.py`` — tensor parallelism, FSDP,
ZeRO-1 and sequence parallelism — written out by hand over
``torch.distributed`` process groups.

JAX annotates shardings and lets XLA partition the single-device
program; here each rung states its collectives:

  * **tp** (:func:`make_tp_train_step`, mesh ``data x model``): each
    leaf resolves by JAX's rule (:func:`resolve_tp`).  Where the rules
    split no leaf of the model, the step is replicated over ``model``
    (JAX's GSPMD runs the whole model on every model rank); otherwise it
    is Megatron for GPT-2 (``gpt2_tp_rules``), LLaMA (``llama_tp_rules``)
    and ViT (``gpt2_tp_rules``, :class:`TPViT`), and the channel split
    of VGG and ResNet (``vgg_tp_rules``, :class:`TPVGG`,
    :class:`TPResNet`), on the sections the rules split.
    ``qkv`` / ``wq``, ``mlp_fc`` / ``gate`` and ``up`` are
    column-parallel, ``proj`` / ``wo`` and ``mlp_proj`` / ``down``
    row-parallel with their outputs summed over ``model``
    (:func:`~tpudp_torch.parallel.collectives.copy_to_group` /
    :func:`~tpudp_torch.parallel.collectives.reduce_from_group` around
    them); each rank holds ``H/n`` heads and runs attention on them (with
    ``attn_impl='flash'``, through the K1-K3 kernels).  GPT-2's ``qkv``
    splits by heads — q, k and v each — where JAX's ``P(None, 'model')``
    splits the fused ``(d, 3d)`` kernel into contiguous column blocks;
    the checkpoint tree gathers back to JAX's global layout.  The
    vocabulary (``wte``, LLaMA's ``lm_head``) splits over the axis: the
    lookup is masked and summed, the logits gathered before the loss.
    JAX's fallback rule replicates a leaf whose dim the axis does not
    divide; the port applies it a head at a time: a section whose heads
    (MLP width, vocabulary) the axis does not divide is whole on every
    rank, and LLaMA's ``wk``/``wv`` are whole beside split query heads
    when the axis does not divide the KV heads (their partial gradients
    summed over ``model``).  Under ``vgg_tp_rules`` each rank computes
    its slice of every convolution's output channels; BatchNorm (SyncBN
    over ``data``: JAX's global batch), ReLU and max-pool run on it, and
    the next layer's input is all-gathered over ``model`` with a
    reduce-scatter of its gradient
    (:func:`~tpudp_torch.parallel.collectives.gather_to_split`); the
    classifier is column-parallel, its logits gathered before the loss.
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
import re
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
from tpudp_torch.parallel.tensor import (MODEL_AXIS, fsdp_dim, tree_paths,
                                         tree_shardings)
from tpudp_torch.train import (OptimizerSpec, TrainState, _FiniteGuard,
                               _adamw, _codec, _opt_buffers, batch_stats,
                               eval_metrics, fingerprint_tensors,
                               optimizer_update, skip_counters, state_to_jax,
                               with_aux)
from tpudp_torch.utils.checkpoint import _to_cpu

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


_JAX_OPT_NAMES = {"exp_avg": "mu", "exp_avg_sq": "nu",
                  "momentum_buffer": "momentum"}


class Layout:
    """A rung's map between its ranks' tensors and the JAX package's
    global checkpoint tree (the one-device tree of
    :func:`tpudp_torch.train.state_to_jax`, through ``post`` — the
    pipeline's stacked ``blocks`` — where the JAX rung keeps another
    layout).  ``leaves`` are the optimizer's tensors, in the order every
    rank walks them; ``buffers`` the module's replicated buffers by
    name (or, where a rung shards them, as :class:`Leaf` objects); ``codec``
    the model family's ``(to_jax, from_jax)``; ``after_load(state)``
    refreshes what derives from the leaves."""

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
        sd.update({k: b.gather(b.local.detach()) if isinstance(b, Leaf)
                   else b.detach() for k, b in self.buffers.items()})
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
                if isinstance(b, Leaf):
                    b.local.copy_(b.scatter(sd[k]))
                else:
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
    """optax ``clip_by_global_norm`` over a rung's leaves, by their
    :func:`global_grad_norm`."""
    norm = global_grad_norm(leaves)
    keep = norm < max_norm
    for lf in leaves:
        g = lf.local.grad
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def _by_group(leaves: list) -> dict:
    by_group: dict = {}
    for lf in leaves:
        by_group.setdefault(lf.group, []).append(lf)
    return by_group


def global_grad_norm(leaves: list) -> torch.Tensor:
    """The norm of the global gradient over a rung's leaves (a sharded
    leaf's squares summed over its group, a replicated one's counted
    once), as JAX's GSPMD step takes ``optax.global_norm``."""
    total = None
    for group, lfs in _by_group(leaves).items():
        sq = torch.stack([lf.local.grad.float().pow(2).sum()
                          for lf in lfs]).sum()
        if group is not None:
            C.all_reduce(sq, group)
        total = sq if total is None else total + sq
    return total.sqrt()


def global_fingerprint(opt, leaves: list) -> torch.Tensor:
    """The SDC fingerprint of the global parameters and optimizer buffers
    over a rung's leaves: each rank's partial sums over a sharded leaf
    (and its buffers) added over the leaf's group, a replicated leaf
    counted once.  The wraparound sum does not depend on order or
    layout, so it is the checksum JAX's GSPMD step takes of the global
    arrays."""
    from tpudp_torch.sdc import finish_fingerprint, partial_fingerprint

    total = None
    for group, lfs in _by_group(leaves).items():
        part = partial_fingerprint(fingerprint_tensors(
            opt, [lf.local for lf in lfs]))
        if group is not None:
            C.all_reduce(part, group)
        total = part if total is None else total + part
    return finish_fingerprint(total)


def apply_update(state: TrainState, spec: OptimizerSpec, leaves: list,
                 finite_group=None, track: bool = False) -> None:
    """Clip, set the step's learning rate and update the leaves (every
    leaf has its gradient); ``finite_group``: the ranks whose
    ``skip_nonfinite`` decisions are taken together.  ``track`` (the
    rungs JAX runs through ``_loss_and_updates``: tp, fsdp, zero1, sp)
    adds the global gradient norm to ``obs_norms`` and sets ``sdc_fp``
    to the global fingerprint after the update, where the state has
    them."""
    params = [lf.local for lf in leaves]
    if track and state.obs_norms is not None:
        gn = global_grad_norm(leaves)
        state.obs_norms += torch.stack([gn, gn * gn])
    guard = None
    if spec.skip_nonfinite is not None:
        guard = _FiniteGuard(state, params, spec.skip_nonfinite,
                             finite_group)
    if spec.clip_norm is not None:
        _clip(leaves, spec.clip_norm)
    optimizer_update(state, spec)
    if guard is not None:
        guard.finish()
    if track and state.sdc_fp is not None:
        state.sdc_fp = global_fingerprint(state.optimizer, leaves)


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
    """A GPT-2-family rung's model (a LLaMA model refuses, as JAX's
    example refuses ``--family llama`` there)."""
    from tpudp_torch.models import gpt2, llama

    if isinstance(model, llama.Llama):
        raise ValueError(
            f"strategy {rung!r} is a GPT-2-family path; a LLaMA model "
            "trains under dp, sp, tp, fsdp or zero1")
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
                     None if shard_params else group, track=True)
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
#
# A section of a block (attention, MLP) or the vocabulary splits over the
# model axis when the axis divides its heads (its width, the vocabulary),
# and is whole on every rank otherwise: JAX's fallback rule at the
# granularity of a head.  A whole section runs the single-device math with
# no collective (its group is None).

def _split(size: int, n: int) -> bool:
    return size % n == 0


class _TPAttention(nn.Module):
    def __init__(self, d: int, n: int):
        super().__init__()
        self.qkv = nn.Linear(d, 3 * d // n)
        self.proj = nn.Linear(d // n, d)


class _TPBlock(nn.Module):
    def __init__(self, cfg, na: int, nm: int):
        super().__init__()
        from tpudp_torch.models.moe import MoeMlp

        d, f = cfg.d_model, cfg.mlp_ratio * cfg.d_model
        self.ln_1 = nn.LayerNorm(d, eps=cfg.ln_eps)
        self.attn = _TPAttention(d, na)
        self.ln_2 = nn.LayerNorm(d, eps=cfg.ln_eps)
        if cfg.mlp_impl == "moe":  # replicated: JAX's rules leave it whole
            self.moe = MoeMlp(d, cfg.num_experts, cfg.mlp_ratio,
                              cfg.capacity_factor, cfg.moe_top_k, None,
                              cfg.dtype)
        else:
            self.mlp_fc = nn.Linear(d, f // nm)
            self.mlp_proj = nn.Linear(f // nm, d)


def _row(lin: nn.Linear, x, dtype, group):
    """A row-parallel layer: the partial products summed over the group,
    then the (replicated) bias, if any."""
    y = C.reduce_from_group(F.linear(x.to(dtype), lin.weight.to(dtype)),
                            group)
    return y if lin.bias is None else y + lin.bias.to(dtype)


class _VocabSplit(nn.Module):
    """The embedding lookup and the head of a vocabulary split over
    ``group`` (None: whole on every rank)."""

    #: Suffixes of whole leaves whose gradients are partial sums.
    partial: tuple = ()

    @staticmethod
    def _lookup(w, tokens, group, r: int):
        if group is None:
            return w[tokens]
        vl = w.shape[0]
        ids = tokens - r * vl
        valid = (ids >= 0) & (ids < vl)
        e = w[ids.clamp(0, vl - 1)] * valid[..., None].to(w.dtype)
        return C.reduce_from_group(e, group)

    @staticmethod
    def _logits(hidden, w, group):
        """``hidden @ w.T`` as float32, the vocabulary gathered."""
        local = (C.copy_to_group(hidden, group) @ w.T).float()
        return C.gather_from_group(local, -1, group)


class TPGPT2(_VocabSplit):
    """This rank's GPT-2 under Megatron tensor parallelism over ``group``
    (``n`` ranks, this one ``r``): the single-device model's parameter
    names with local shapes.  Where the axis divides the heads, ``qkv``
    is ``(3d/n, d)`` (its heads' q, k and v rows) and ``proj`` ``(d,
    d/n)``; where it divides the MLP width ``f``, ``mlp_fc`` is ``(f/n,
    d)`` and ``mlp_proj`` ``(d, f/n)``; where it divides the vocabulary,
    ``wte`` is ``(V/n, d)``.  Every other section is whole, and so is a
    section the rules leave whole (``sections`` names those they split:
    ``attn``, ``mlp``, ``vocab``)."""

    def __init__(self, cfg, group, n: int, r: int, sections):
        super().__init__()
        self.config, self.group, self.n, self.r = cfg, group, n, r
        f = cfg.mlp_ratio * cfg.d_model
        na, nm, nv = (n if name in sections and _split(size, n) else 1
                      for name, size in (("attn", cfg.num_heads),
                                         ("mlp", f),
                                         ("vocab", cfg.vocab_size)))
        self.attn_group, self.mlp_group, self.vocab_group = (
            group if k > 1 else None for k in (na, nm, nv))
        self.splits = {"attn": na > 1, "mlp": nm > 1, "vocab": nv > 1}
        v = cfg.vocab_size // nv
        self.wte = nn.Embedding(v, cfg.d_model)
        self.wpe = nn.Embedding(cfg.max_seq_len, cfg.d_model)
        self.h = nn.ModuleList(_TPBlock(cfg, na, nm)
                               for _ in range(cfg.num_layers))
        self.ln_f = nn.LayerNorm(cfg.d_model, eps=cfg.ln_eps)

    def forward(self, tokens: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        del train
        from tpudp_torch.models.gpt2 import dense, layer_norm
        from tpudp_torch.ops.attention import multihead_attention

        cfg, ga, gm = self.config, self.attn_group, self.mlp_group
        dtype = cfg.dtype
        b, t = tokens.shape
        dh = cfg.d_model // cfg.num_heads
        hl = cfg.num_heads // (self.n if self.splits["attn"] else 1)
        impl = "dense" if cfg.attn_impl == "ring" else cfg.attn_impl
        x = self._lookup(self.wte.weight.to(dtype), tokens, self.vocab_group,
                         self.r) + self.wpe.weight.to(dtype)[
            torch.arange(t, device=tokens.device)]
        for blk in self.h:
            a = C.copy_to_group(layer_norm(blk.ln_1, x), ga)
            qkv = dense(blk.attn.qkv, a, dtype)
            q, k, v = (z.reshape(b, t, hl, dh) for z in qkv.chunk(3, -1))
            out = multihead_attention(q, k, v, causal=True, impl=impl,
                                      dtype=dtype)
            x = x + _row(blk.attn.proj, out.reshape(b, t, -1), dtype, ga)
            if hasattr(blk, "moe"):
                x = x + blk.moe(layer_norm(blk.ln_2, x))
                continue
            a = C.copy_to_group(layer_norm(blk.ln_2, x), gm)
            h = F.gelu(dense(blk.mlp_fc, a, dtype), approximate="tanh")
            x = x + _row(blk.mlp_proj, h, dtype, gm)
        hidden = layer_norm(self.ln_f, x).to(dtype)
        return self._logits(hidden, self.wte.weight.to(dtype),
                            self.vocab_group)


def _tp_leaves(model: TPGPT2, group, n: int, r: int) -> list:
    """The TP module's parameters as leaves of the single-device
    model's names."""
    split = model.splits
    leaves = []
    for name, p in model.named_parameters():
        if split["attn"] and name.endswith(("attn.qkv.weight",
                                            "attn.qkv.bias")):
            leaves.append(heads_leaf(name, p, group, n, r))
        elif split["attn"] and name.endswith("attn.proj.weight"):
            leaves.append(dim_leaf(name, p, 1, group, n, r))
        elif split["mlp"] and name.endswith(("mlp_fc.weight",
                                             "mlp_fc.bias")):
            leaves.append(dim_leaf(name, p, 0, group, n, r))
        elif split["mlp"] and name.endswith("mlp_proj.weight"):
            leaves.append(dim_leaf(name, p, 1, group, n, r))
        elif split["vocab"] and name == "wte.weight":
            leaves.append(dim_leaf(name, p, 0, group, n, r))
        else:
            leaves.append(Leaf(name, p))
    return leaves


class _TPLlamaAttention(nn.Module):
    def __init__(self, d: int, dh: int, hq: int, hkv: int):
        super().__init__()
        self.wq = nn.Linear(d, hq * dh, bias=False)
        self.wk = nn.Linear(d, hkv * dh, bias=False)
        self.wv = nn.Linear(d, hkv * dh, bias=False)
        self.wo = nn.Linear(hq * dh, d, bias=False)


class _TPLlamaBlock(nn.Module):
    def __init__(self, cfg, hq: int, hkv: int, f: int):
        super().__init__()
        from tpudp_torch.models.llama import RMSNorm

        d = cfg.d_model
        self.rms_attn = RMSNorm(d, cfg.rms_eps)
        self.attn = _TPLlamaAttention(d, d // cfg.num_heads, hq, hkv)
        self.rms_mlp = RMSNorm(d, cfg.rms_eps)
        self.gate = nn.Linear(d, f, bias=False)
        self.up = nn.Linear(d, f, bias=False)
        self.down = nn.Linear(f, d, bias=False)


class TPLlama(_VocabSplit):
    """This rank's LLaMA under Megatron tensor parallelism over ``group``
    by ``llama_tp_rules`` (``n`` ranks, this one ``r``): ``wq``, ``gate``
    and ``up`` column-parallel, ``wo`` and ``down`` row-parallel, ``wte``
    split over the vocabulary and the untied ``lm_head`` column-parallel
    over it, each where the axis divides its heads (MLP width,
    vocabulary), whole otherwise.  ``wk`` and ``wv`` split by KV heads
    where the axis divides those too; otherwise they are whole on every
    rank beside split query heads, each rank using the KV heads its query
    heads read (so their gradients are partial: :attr:`partial` names
    them, to be summed over ``group``).  A section the rules leave whole
    is whole (``sections`` names those they split: ``attn`` — ``wq`` and
    ``wo`` —, ``kv``, ``mlp``, ``vocab`` — ``wte`` — and ``head``)."""

    def __init__(self, cfg, group, n: int, r: int, sections):
        super().__init__()
        self.config, self.group, self.n, self.r = cfg, group, n, r
        na, nm, nv, nh = (n if name in sections and _split(size, n) else 1
                          for name, size in (("attn", cfg.num_heads),
                                             ("mlp", cfg.hidden),
                                             ("vocab", cfg.vocab_size),
                                             ("head", cfg.vocab_size)))
        nkv = (n if na > 1 and "kv" in sections and _split(cfg.kv_heads, n)
               else 1)
        self.attn_group, self.mlp_group, self.vocab_group, \
            self.head_group = (group if k > 1 else None
                               for k in (na, nm, nv, nh))
        self.splits = {"attn": na > 1, "kv": nkv > 1, "mlp": nm > 1,
                       "vocab": nv > 1, "head": nh > 1}
        hkv, f = cfg.kv_heads // nkv, cfg.hidden // nm
        self.wte = nn.Embedding(cfg.vocab_size // nv, cfg.d_model)
        self.h = nn.ModuleList(_TPLlamaBlock(cfg, cfg.num_heads // na, hkv,
                                             f)
                               for _ in range(cfg.num_layers))
        from tpudp_torch.models.llama import RMSNorm

        self.rms_f = RMSNorm(cfg.d_model, cfg.rms_eps)
        self.lm_head = nn.Linear(cfg.d_model, cfg.vocab_size // nh,
                                 bias=False)
        self.partial = ((".attn.wk.weight", ".attn.wv.weight")
                        if na > 1 and nkv == 1 else ())

    def forward(self, tokens: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        del train
        from tpudp_torch.models.llama import apply_rope, dense, rms_norm
        from tpudp_torch.ops.attention import multihead_attention

        cfg, ga, gm = self.config, self.attn_group, self.mlp_group
        dtype = cfg.dtype
        b, t = tokens.shape
        dh = cfg.d_model // cfg.num_heads
        hl = cfg.num_heads // (self.n if self.splits["attn"] else 1)
        groups = cfg.num_heads // cfg.kv_heads
        impl = "dense" if cfg.attn_impl == "ring" else cfg.attn_impl
        positions = torch.arange(t, device=tokens.device)
        x = self._lookup(self.wte.weight.to(dtype), tokens, self.vocab_group,
                         self.r)
        for blk in self.h:
            a = C.copy_to_group(rms_norm(blk.rms_attn, x), ga)
            q = apply_rope(dense(blk.attn.wq, a, dtype).reshape(b, t, hl, dh),
                           positions, cfg.rope_theta)
            k = apply_rope(dense(blk.attn.wk, a, dtype).reshape(b, t, -1, dh),
                           positions, cfg.rope_theta)
            v = dense(blk.attn.wv, a, dtype).reshape(b, t, -1, dh)
            k = k.repeat_interleave(groups, dim=2)
            v = v.repeat_interleave(groups, dim=2)
            if self.partial:  # whole KV heads: this rank's query heads
                k = k[:, :, self.r * hl:(self.r + 1) * hl]
                v = v[:, :, self.r * hl:(self.r + 1) * hl]
            out = multihead_attention(q, k, v, causal=True, impl=impl,
                                      dtype=dtype)
            x = x + _row(blk.attn.wo, out.reshape(b, t, -1), dtype, ga)
            a = C.copy_to_group(rms_norm(blk.rms_mlp, x), gm)
            gate = F.silu(dense(blk.gate, a, dtype))
            x = x + _row(blk.down, gate * dense(blk.up, a, dtype), dtype, gm)
        hidden = rms_norm(self.rms_f, x).to(dtype)
        return self._logits(hidden, self.lm_head.weight.to(dtype),
                            self.head_group)


def _tp_llama_leaves(model: TPLlama, group, n: int, r: int) -> list:
    """:class:`TPLlama`'s parameters as leaves of the single-device
    model's names."""
    sp = model.splits
    rows = [(sp["attn"], ".attn.wq.weight"), (sp["mlp"], ".gate.weight"),
            (sp["mlp"], ".up.weight"), (sp["head"], "lm_head.weight"),
            (sp["vocab"], "wte.weight"), (sp["kv"], ".attn.wk.weight"),
            (sp["kv"], ".attn.wv.weight")]
    cols = [(sp["attn"], ".attn.wo.weight"), (sp["mlp"], ".down.weight")]
    leaves = []
    for name, p in model.named_parameters():
        dim = next((d for d, table in ((0, rows), (1, cols))
                    for split, suffix in table
                    if split and name.endswith(suffix)), None)
        leaves.append(Leaf(name, p) if dim is None
                      else dim_leaf(name, p, dim, group, n, r))
    return leaves


def _feed(x, sharded: bool, to_split: bool, group):
    """A layer's input over the model axis: a channel-sharded activation
    gathered (its gradient reduce-scattered where the layer is split,
    narrowed where it is whole); a whole one passed to a split layer
    through ``copy_to_group`` (its partial gradients summed)."""
    if sharded:
        return (C.gather_to_split(x, 1, group) if to_split
                else C.gather_from_group(x, 1, group))
    return C.copy_to_group(x, group) if to_split else x


class TPVGG(nn.Module):
    """This rank's VGG under ``vgg_tp_rules`` over ``group`` (``n`` ranks,
    this one ``r``): the single-device model's parameter and buffer
    names with local shapes.  A convolution whose output channels the
    axis divides holds its ``cout/n`` of them (weight, bias, BatchNorm
    scale, bias and running statistics); the classifier holds its
    ``classes/n`` logits where the axis divides them; every other layer
    is whole on every rank (JAX's fallback, leaf by leaf).  BatchNorm is
    SyncBN over ``dgroup`` (``dn`` data ranks) when ``dn > 1``: JAX's
    step normalizes with the global batch's statistics."""

    #: Whole leaves whose gradients are partial sums: none (a whole
    #: layer's gradient is the same on every rank).
    partial: tuple = ()

    def __init__(self, model, group, n: int, r: int, dgroup, dn: int,
                 sections):
        super().__init__()
        self.group, self.n, self.r = group, n, r
        self.cfg, self.dtype = model.cfg, model.dtype
        bn_axis = DATA_AXIS if dn > 1 else None
        convs, bns, self.split = [], [], []
        channels, size = 3, 32  # CIFAR-10's RGB 32x32 images
        for v in self.cfg:
            if v == "M":
                size //= 2
                continue
            split = (n > 1 and _split(int(v), n)
                     and f"Conv_{len(convs)}" in sections)
            local = int(v) // n if split else int(v)
            convs.append(nn.Conv2d(channels, local, 3, padding=1))
            bns.append(BatchNorm(local, bn_axis, dgroup))
            self.split.append(split)
            channels = int(v)
        self.convs = nn.ModuleList(convs)
        self.bns = nn.ModuleList(bns)
        classes = model.fc.out_features
        self.fc_split = n > 1 and _split(classes, n) and "fc" in sections
        self.fc = nn.Linear(channels * size * size,
                            classes // n if self.fc_split else classes)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        dt = self.dtype
        x = x.permute(0, 3, 1, 2).to(dt)  # NHWC memory seen as NCHW
        layer, sharded = 0, False
        for v in self.cfg:
            if v == "M":  # per channel: on the local shard
                x = F.max_pool2d(x, 2, 2)
                continue
            split, conv = self.split[layer], self.convs[layer]
            x = _feed(x, sharded, split, self.group)
            x = F.conv2d(x.to(dt), conv.weight.to(dt), conv.bias.to(dt),
                         padding=1)
            x = F.relu(self.bns[layer](x, train))
            sharded = split
            layer += 1
        x = _feed(x, sharded, self.fc_split, self.group)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flax's order
        logits = F.linear(x.to(dt), self.fc.weight.to(dt),
                          self.fc.bias.to(dt)).float()
        if self.fc_split:
            logits = C.gather_from_group(logits, -1, self.group)
        return logits


def _tp_vgg_leaves(model: TPVGG, group, n: int, r: int) -> tuple:
    """:class:`TPVGG`'s parameters as leaves of the single-device VGG's
    names, and its BatchNorm running statistics by name (leaves where
    their convolution is split): ``(leaves, buffers)``."""
    def of(name, t, split):
        return dim_leaf(name, t, 0, group, n, r) if split else Leaf(name, t)

    leaves = []
    for name, p in model.named_parameters():
        if name.startswith(("convs.", "bns.")):
            leaves.append(of(name, p, model.split[int(name.split(".")[1])]))
        else:
            leaves.append(of(name, p, model.fc_split))
    buffers = {name: of(name, b, model.split[int(name.split(".")[1])])
               for name, b in model.named_buffers()}
    return leaves, buffers


class _TPBottleneck(nn.Module):
    """One bottleneck block of :class:`TPResNet`: the single-device
    block's names, each split convolution ``cout/n`` wide."""

    def __init__(self, blk, split: list, proj_split: bool, n: int, dgroup,
                 bn_axis):
        super().__init__()
        self.split, self.proj_split = split, proj_split
        convs, bns = [], []
        for conv, bn, sp in zip(blk.convs, blk.bns, split):
            cout = conv.out_channels // n if sp else conv.out_channels
            convs.append(nn.Conv2d(conv.in_channels, cout, conv.kernel_size,
                                   conv.stride, conv.padding, bias=False))
            bns.append(BatchNorm(cout, bn_axis, dgroup))
        self.convs, self.bns = nn.ModuleList(convs), nn.ModuleList(bns)
        self.proj_conv = self.proj_bn = None
        if blk.proj_conv is not None:
            p = blk.proj_conv
            self.proj_conv = nn.Conv2d(
                p.in_channels, p.out_channels // n if proj_split
                else p.out_channels, 1, p.stride, bias=False)
            self.proj_bn = BatchNorm(p.out_channels, bn_axis, dgroup)


class TPResNet(nn.Module):
    """This rank's ResNet under ``vgg_tp_rules`` over ``group`` (``n``
    ranks, this one ``r``): the single-device model's parameter and
    buffer names with local shapes.  Every convolution the rules split
    (``stem_conv``, each block's ``Conv_0-2`` and ``proj_conv``, where
    the axis divides its output channels) holds its ``cout/n`` of them,
    with its ``BatchNorm_i`` on the local slice (SyncBN over ``dgroup``
    when ``dn > 1``: JAX's global batch); ``Dense_0`` holds its
    ``classes/n`` logits where the axis divides them.  A block's input
    and output are whole on every rank: the residual adds run on whole
    tensors.  ``stem_bn`` and ``proj_bn`` match no rule, so they stay
    whole: each normalizes its convolution's output gathered whole over
    ``model``, so every rank computes the same statistics and the same
    whole gradients of their parameters.  The stem's max-pool follows
    ``stem_bn`` on the whole tensor; the global mean pool comes before
    ``Dense_0``."""

    #: Whole leaves whose gradients are partial sums: none.
    partial: tuple = ()

    def __init__(self, model, group, n: int, r: int, dgroup, dn: int,
                 sections):
        super().__init__()
        self.group, self.n, self.r = group, n, r
        self.dtype = model.dtype
        bn_axis = DATA_AXIS if dn > 1 else None

        def split(name: str, cout: int) -> bool:
            return n > 1 and _split(cout, n) and name in sections

        stem = model.stem_conv
        self.stem_split = split("stem", stem.out_channels)
        self.stem_conv = nn.Conv2d(
            3, stem.out_channels // n if self.stem_split
            else stem.out_channels, 7, 2, padding=3, bias=False)
        self.stem_bn = BatchNorm(stem.out_channels, bn_axis, dgroup)
        blocks = []
        for i, blk in enumerate(model.blocks):
            sp = [split(f"b{i}.c{j}", c.out_channels)
                  for j, c in enumerate(blk.convs)]
            proj = (blk.proj_conv is not None
                    and split(f"b{i}.proj", blk.proj_conv.out_channels))
            blocks.append(_TPBottleneck(blk, sp, proj, n, dgroup, bn_axis))
        self.blocks = nn.ModuleList(blocks)
        classes = model.fc.out_features
        self.fc_split = split("fc", classes)
        self.fc = nn.Linear(model.fc.in_features,
                            classes // n if self.fc_split else classes)

    def _conv(self, x, conv, sharded: bool, split: bool):
        """``conv`` on ``x`` (channel-sharded or whole), its output this
        rank's slice where ``split``."""
        x = _feed(x.to(self.dtype), sharded, split, self.group)
        return F.conv2d(x, conv.weight.to(self.dtype), None, conv.stride,
                        conv.padding)

    def _whole(self, x, sharded: bool):
        return C.gather_from_group(x, 1, self.group) if sharded else x

    def _block(self, blk: _TPBottleneck, x, train: bool):
        y, sharded = x, False
        for j, (conv, bn) in enumerate(zip(blk.convs, blk.bns)):
            y = bn(self._conv(y, conv, sharded, blk.split[j]), train)
            if j < 2:
                y = F.relu(y)
            sharded = blk.split[j]
        y = self._whole(y, sharded)
        residual = x
        if blk.proj_conv is not None:
            p = self._conv(x, blk.proj_conv, False, blk.proj_split)
            residual = blk.proj_bn(self._whole(p, blk.proj_split), train)
        return F.relu(residual + y)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        dt = self.dtype
        x = x.permute(0, 3, 1, 2)  # NHWC memory seen as NCHW
        y = self._conv(x, self.stem_conv, False, self.stem_split)
        x = F.relu(self.stem_bn(self._whole(y, self.stem_split), train))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for blk in self.blocks:
            x = self._block(blk, x, train)
        x = x.mean(dim=(2, 3))  # global average pool, float32
        if self.fc_split:
            x = C.copy_to_group(x, self.group)
        logits = F.linear(x.to(dt), self.fc.weight.to(dt),
                          self.fc.bias.to(dt)).float()
        if self.fc_split:
            logits = C.gather_from_group(logits, -1, self.group)
        return logits


def _tp_resnet_leaves(model: TPResNet, group, n: int, r: int) -> tuple:
    """:class:`TPResNet`'s parameters as leaves of the single-device
    ResNet's names, and its BatchNorm running statistics by name (leaves
    where their convolution is split): ``(leaves, buffers)``."""
    def split_of(name: str) -> bool:
        parts = name.split(".")
        if parts[0] == "stem_conv":
            return model.stem_split
        if parts[0] == "fc":
            return model.fc_split
        if parts[0] != "blocks" or parts[2] == "proj_bn":
            return False  # stem_bn, proj_bn: whole
        blk = model.blocks[int(parts[1])]
        if parts[2] == "proj_conv":
            return blk.proj_split
        return blk.split[int(parts[3])]

    def of(name, t):
        return (dim_leaf(name, t, 0, group, n, r) if split_of(name)
                else Leaf(name, t))

    leaves = [of(name, p) for name, p in model.named_parameters()]
    buffers = {name: of(name, b) if split_of(name) else b
               for name, b in model.named_buffers()}
    return leaves, buffers


class _TPViTBlock(nn.Module):
    def __init__(self, cfg, na: int, nm: int):
        super().__init__()
        from tpudp_torch.models.vit import LN_EPS

        d, f = cfg.d_model, cfg.mlp_ratio * cfg.d_model
        self.ln_1 = nn.LayerNorm(d, eps=LN_EPS)
        self.attn = _TPAttention(d, na)
        self.ln_2 = nn.LayerNorm(d, eps=LN_EPS)
        self.mlp_fc = nn.Linear(d, f // nm)
        self.mlp_proj = nn.Linear(f // nm, d)


class TPViT(nn.Module):
    """This rank's ViT under Megatron tensor parallelism over ``group``
    (``n`` ranks, this one ``r``): :class:`TPGPT2` without the
    vocabulary.  Where the rules split them (``gpt2_tp_rules``) and the
    axis divides the heads (the MLP width), ``qkv`` is ``(3d/n, d)`` (its
    heads' q, k and v rows) and ``proj`` ``(d, d/n)``, ``mlp_fc`` ``(f/n,
    d)`` and ``mlp_proj`` ``(d, f/n)``; attention runs at the local heads
    (with ``attn_impl='flash'``, through K1-K3, non-causal).
    ``patch_embed``, ``pos_embed``, the LayerNorms and ``head`` are
    whole."""

    partial: tuple = ()

    def __init__(self, cfg, group, n: int, r: int, sections):
        super().__init__()
        self.config, self.group, self.n, self.r = cfg, group, n, r
        from tpudp_torch.models.vit import LN_EPS

        f = cfg.mlp_ratio * cfg.d_model
        na, nm = (n if name in sections and _split(size, n) else 1
                  for name, size in (("attn", cfg.num_heads), ("mlp", f)))
        self.attn_group, self.mlp_group = (group if k > 1 else None
                                           for k in (na, nm))
        self.splits = {"attn": na > 1, "mlp": nm > 1, "vocab": False}
        d, p = cfg.d_model, cfg.patch_size
        self.patch_embed = nn.Conv2d(3, d, p, stride=p)
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.num_patches, d))
        self.h = nn.ModuleList(_TPViTBlock(cfg, na, nm)
                               for _ in range(cfg.num_layers))
        self.ln_f = nn.LayerNorm(d, eps=LN_EPS)
        self.head = nn.Linear(d, cfg.num_classes)

    def forward(self, images: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        del train
        from tpudp_torch.models.gpt2 import dense, layer_norm
        from tpudp_torch.ops.attention import multihead_attention

        cfg, ga, gm = self.config, self.attn_group, self.mlp_group
        dt, conv = cfg.dtype, self.patch_embed
        x = images.permute(0, 3, 1, 2).to(dt)  # NHWC memory seen as NCHW
        x = F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt), conv.stride)
        b = x.shape[0]
        x = x.permute(0, 2, 3, 1).reshape(b, -1, cfg.d_model)
        x = x + self.pos_embed.to(dt)
        t, dh = x.shape[1], cfg.d_model // cfg.num_heads
        hl = cfg.num_heads // (self.n if self.splits["attn"] else 1)
        for blk in self.h:
            a = C.copy_to_group(layer_norm(blk.ln_1, x), ga)
            qkv = dense(blk.attn.qkv, a, dt)
            q, k, v = (z.reshape(b, t, hl, dh) for z in qkv.chunk(3, -1))
            out = multihead_attention(q, k, v, causal=False,
                                      impl=cfg.attn_impl, dtype=dt)
            x = x + _row(blk.attn.proj, out.reshape(b, t, -1), dt, ga)
            a = C.copy_to_group(layer_norm(blk.ln_2, x), gm)
            h = F.gelu(dense(blk.mlp_fc, a, dt), approximate="tanh")
            x = x + _row(blk.mlp_proj, h, dt, gm)
        x = layer_norm(self.ln_f, x).mean(dim=1)  # global average pool
        return dense(self.head, x, dt).float()


# -- rule resolution --------------------------------------------------------
#
# JAX's make_tp_train_step takes any model under any table: each leaf's spec
# is the first matching rule, and a leaf no rule matches, or whose split dim
# the axis does not divide, is replicated.  The port resolves each leaf the
# same way, then runs the hand-written module of the model's family on the
# sections the rules split, or, where they split nothing, the replicated
# step.  A section is the leaves the port splits together; a table that
# splits part of one, or a leaf no module splits, is refused by name.

def _tp_sections(model) -> list:
    """``[(section, path regex)]`` of ``model``'s family over its JAX
    parameter paths (``params/...``)."""
    from tpudp_torch.models import gpt2, llama, resnet, vgg, vit

    if isinstance(model, (gpt2.GPT2, vit.ViT)):
        out = [("attn", r"/h_\d+/attn/(qkv/(kernel|bias)|proj/kernel)$"),
               ("mlp", r"/h_\d+/(mlp_fc/(kernel|bias)|mlp_proj/kernel)$")]
        return out + ([("vocab", r"^params/wte/embedding$")]
                      if isinstance(model, gpt2.GPT2) else [])
    if isinstance(model, llama.Llama):
        return [("attn", r"/attn/w[qo]/kernel$"),
                ("kv", r"/attn/w[kv]/kernel$"),
                ("mlp", r"/(gate|up|down)/kernel$"),
                ("vocab", r"^params/wte/embedding$"),
                ("head", r"^params/lm_head/kernel$")]
    if isinstance(model, vgg.VGG):
        return [(f"Conv_{i}", rf"^params/(Conv_{i}/(kernel|bias)|"
                              rf"BatchNorm_{i}/(scale|bias))$")
                for i in range(len(model.convs))] + [
            ("fc", r"^params/Dense_0/(kernel|bias)$")]
    if isinstance(model, resnet.ResNet):
        out = [("stem", r"^params/stem_conv/kernel$")]
        for i in range(len(model.blocks)):
            blk = rf"^params/BottleneckBlock_{i}/"
            out += [(f"b{i}.c{j}",
                     blk + rf"(Conv_{j}/kernel|BatchNorm_{j}/(scale|bias))$")
                    for j in range(3)]
            out.append((f"b{i}.proj", blk + r"proj_conv/kernel$"))
        return out + [("fc", r"^params/Dense_0/(kernel|bias)$")]
    return []


def _rules_axis(rules) -> str:
    """The model axis ``rules`` split over (``model`` where they name
    none or several)."""
    if callable(rules):
        raise ValueError("callable rules are the fsdp and zero1 rungs: use "
                         "make_fsdp_train_step / make_zero1_train_step")
    axes = {a for _, s in rules if s for a in s if a is not None}
    return next(iter(axes)) if len(axes) == 1 else MODEL_AXIS


def resolve_tp(model, rules, axis_sizes: dict):
    """How the port runs ``model`` under ``rules`` at ``axis_sizes``:
    None where JAX's resolution splits no leaf (the replicated step),
    else the set of the family's sections the rules split (the
    hand-written module's layout).  Raises naming the split leaves no
    module of the port takes."""
    from tpudp_torch.parallel.tensor import spec_for_path

    rules = tuple((p, tuple(s) if s is not None else None)
                  for p, s in rules)
    to_jax, _ = _codec(model)
    tree = {"params": to_jax(model.state_dict())[0]}
    leaves = tree_paths(tree)
    split = {path for path, sh in tree_shardings(tree, rules,
                                                 axis_sizes).items()
             if sh is not None}
    if not split:
        return None
    matched = {path for path, leaf in leaves.items()
               if any(a is not None for a in spec_for_path(
                   path, rules, leaf.dim()))}
    sections, covered, bad = set(), set(), []
    for name, pattern in _tp_sections(model):
        paths = {p for p in leaves if re.search(pattern, p)}
        covered |= paths
        if not paths & split:
            continue
        if paths <= matched:
            sections.add(name)
        else:
            bad.append(f"{name} (the rules split "
                       f"{sorted(paths & split)} but not "
                       f"{sorted(paths - matched)})")
    bad += sorted(split - covered)
    if bad:
        raise ValueError(
            f"the port's tp step for {type(model).__name__} splits whole "
            f"sections of its hand-written layout; these rules split "
            f"leaves it does not take: {', '.join(bad)}")
    return sections


def _replicated_model(model, dgroup, dn: int) -> nn.Module:
    """The replicated tp step's module: the single-device model, its
    BatchNorms SyncBN over ``data`` (JAX's global batch)."""
    if dn > 1:
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.bn_axis, m.group = DATA_AXIS, dgroup
    return model


def make_tp_train_step(model: nn.Module, optimizer: OptimizerSpec, mesh,
                       state: TrainState, rules, *,
                       data_axis: str = DATA_AXIS,
                       aux_loss_coef: float = 0.01):
    """DP x TP (JAX's ``make_tp_train_step``) over ``mesh``'s
    ``data_axis`` and the rules' model axis: returns ``(tp_state,
    step)``.  Each leaf resolves as JAX resolves it
    (:func:`resolve_tp`): where the rules split nothing of ``model``
    (another family's table, say) the step is replicated — the whole
    model on every rank, as JAX's GSPMD runs it; otherwise
    ``tp_state.model`` is this rank's hand-written module on the
    sections the rules split: :class:`TPGPT2` or :class:`TPLlama`
    (Megatron), :class:`TPVGG` or :class:`TPResNet` (the channel split),
    :class:`TPViT`.  The step is JAX's single-device step on the global
    batch: the loss and the gradients are the global batch's means
    (averaged over ``data``)."""
    from tpudp_torch.models import gpt2, llama, resnet, vgg, vit

    axis = _rules_axis(rules)
    refuse_skip(optimizer, "tp")
    if optimizer.compress is not None:
        raise ValueError(f"compress={optimizer.compress!r} needs the "
                         "shard_map DP rung")
    group, n, r = axis_of(mesh, axis)
    dgroup, dn, _ = axis_of(mesh, data_axis)
    sizes = dict(mesh.shape) if isinstance(mesh, MeshND) else {
        DATA_AXIS: mesh.size}
    sizes.setdefault(axis, n)
    sections = resolve_tp(model, rules, sizes)
    device = next(model.parameters()).device
    buffers = None
    if sections is None:
        local = _replicated_model(model, dgroup, dn)
        leaves = [Leaf(name, p) for name, p in local.named_parameters()]
        buffers = {k: b for k, b in local.named_buffers()
                   if b.is_floating_point()}
    elif isinstance(model, vgg.VGG):
        local = TPVGG(model, group, n, r, dgroup, dn, sections).to(
            device, memory_format=torch.channels_last)
        leaves, buffers = _tp_vgg_leaves(local, group, n, r)
    elif isinstance(model, resnet.ResNet):
        local = TPResNet(model, group, n, r, dgroup, dn, sections).to(
            device, memory_format=torch.channels_last)
        leaves, buffers = _tp_resnet_leaves(local, group, n, r)
    elif isinstance(model, llama.Llama):
        local = TPLlama(model.config, group, n, r, sections).to(device)
        leaves = _tp_llama_leaves(local, group, n, r)
    elif isinstance(model, vit.ViT):
        local = TPViT(model.config, group, n, r, sections).to(device)
        leaves = _tp_leaves(local, group, n, r)
    elif isinstance(model, gpt2.GPT2):
        local = TPGPT2(model.config, group, n, r, sections).to(device)
        leaves = _tp_leaves(local, group, n, r)
    else:
        raise TypeError(f"strategy 'tp' splits tpudp_torch's GPT2, Llama, "
                        f"VGG, ResNet and ViT; got {type(model).__name__}")
    suffixes = getattr(local, "partial", ())
    partial = [lf for lf in leaves if suffixes and lf.name.endswith(suffixes)]
    layout = Layout(leaves, _codec(model), buffers=buffers)
    built = from_standard(state, new_state(local, optimizer, leaves, layout))
    local.requires_grad_(True).train()

    def step(st: TrainState, inputs, targets):
        _zero_grads(*local.parameters())
        ce = cross_entropy(local(inputs, train=True), targets)
        with_aux(local, ce, aux_loss_coef).backward()
        grads = grads_of(leaves)
        if partial:  # whole KV projections beside split query heads
            flat = torch.cat([lf.local.grad.reshape(-1) for lf in partial])
            C.all_reduce(flat, group)
            for lf, piece in zip(partial, flat.split(
                    [lf.local.numel() for lf in partial])):
                lf.local.grad.copy_(piece.reshape(lf.local.shape))
        loss = ce.detach().reshape(1)
        mean_over(grads + [loss], dgroup, dn)
        apply_update(st, optimizer, leaves, track=True)
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
    from tpudp_torch.models import gpt2, llama

    if not isinstance(model, (gpt2.GPT2, llama.Llama)):
        raise TypeError(f"strategy 'sp' drives tpudp_torch.models.gpt2."
                        f"GPT2 or llama.Llama; got {type(model).__name__}")
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
        apply_update(st, optimizer, leaves, track=True)
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
