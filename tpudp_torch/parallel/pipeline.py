"""Pipeline parallelism for GPT-2 — the port of
``tpudp/parallel/pipeline.py`` (the ``gpipe`` and ``1f1b`` schedules).

The mesh is ``[data x] pipe``.  Stage s of S owns layers ``[sL/S,
(s+1)L/S)``; the embedding runs on stage 0, the final LayerNorm and the
tied head on the last stage, and every stage keeps a copy of those
shared parameters whose gradients are summed over ``pipe`` (JAX's
structural ``psum``: each stage contributes only what it used, so
nothing counts twice).  Activations go forward and cotangents back by
point-to-point sends between neighbouring stages
(``tpudp_torch.parallel.collectives.send`` / ``recv``: the send is
posted without waiting, so neither schedule can deadlock).

  * ``'gpipe'`` — every microbatch's forward, keeping its autograd
    graph, then every microbatch's backward: all M microbatches'
    activations are live at once.
  * ``'1f1b'`` — JAX's tick schedule: stage s runs microbatch m's
    forward at tick ``s + m`` (without a graph, keeping only its input)
    and its backward at tick ``2(S-1) - s + m``, recomputing the stage's
    forward from the kept input; a stage keeps at most ``2S - 1``
    microbatch inputs, whatever M.  In eager PyTorch this is the MPMD
    schedule of ``tpudp_torch.parallel.schedule`` at one chunk a stage
    with the stage's own optimizer, and it runs there.

``remat=True`` checkpoints each block (``torch.utils.checkpoint``).  The
rung's checkpoint tree is JAX's pipeline layout: the blocks' parameters
(and optimizer buffers) stacked ``(L, ...)`` under ``blocks``
(:func:`stack_block_params`).  The schedule ``'1f1b_mpmd'`` (interleaved
virtual stages, the in-step sharded optimizer) is
``tpudp_torch.parallel.schedule`` too.
"""

from __future__ import annotations

import collections

import torch
import torch.utils.checkpoint
from torch import nn

from tpudp_torch.models import gpt2
from tpudp_torch.models.norm import DATA_AXIS
from tpudp_torch.parallel import collectives as C
from tpudp_torch.parallel.sharded import (Layout, Leaf, apply_update,
                                          axis_of, cross_entropy,
                                          from_standard, grads_of, mean_over,
                                          new_state, refuse_skip)
from tpudp_torch.train import _codec

PIPE_AXIS = "pipe"
SCHEDULES = ("gpipe", "1f1b")


def _stack(xs):
    if isinstance(xs[0], torch.Tensor):
        return torch.stack(xs)
    import numpy as np

    return np.stack(xs)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _zip_map(trees: list, fn):
    if isinstance(trees[0], dict):
        return {k: _zip_map([t[k] for t in trees], fn) for k in trees[0]}
    return fn(trees)


def stack_block_params(params: dict, num_layers: int,
                       prefix: str = "h_") -> dict:
    """The flax GPT-2 tree (``h_0`` .. ``h_{L-1}``) in the pipeline
    layout: one ``blocks`` tree of ``(L, ...)`` leaves beside the shared
    parameters (tensors or numpy arrays)."""
    out = {k: v for k, v in params.items() if not k.startswith(prefix)}
    out["blocks"] = _zip_map([params[f"{prefix}{i}"]
                              for i in range(num_layers)], _stack)
    return out


def unstack_block_params(params_pp: dict, prefix: str = "h_") -> dict:
    """The inverse of :func:`stack_block_params`."""
    blocks = params_pp["blocks"]
    leaf = blocks
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    out = {k: v for k, v in params_pp.items() if k != "blocks"}
    for i in range(leaf.shape[0]):
        out[f"{prefix}{i}"] = _map(blocks, lambda x, i=i: x[i])
    return out


def _is_params_tree(node) -> bool:
    return isinstance(node, dict) and "wte" in node


def _restack(tree: dict, fn) -> dict:
    """``fn`` over the checkpoint tree's parameter-shaped subtrees: the
    parameters and each optimizer buffer (momentum, mu, nu)."""
    out = dict(tree)
    out["params"] = fn(tree["params"])
    out["opt_state"] = {k: fn(v) if _is_params_tree(v) else v
                        for k, v in tree.get("opt_state", {}).items()}
    return out


class PipelineStage(nn.Module):
    """Stage ``stage``'s part of GPT-2: layers ``first .. first + count``
    (local names ``h.0`` ..), and the shared ``wte``, ``wpe`` and
    ``ln_f``."""

    def __init__(self, cfg: gpt2.GPT2Config, first: int, count: int):
        super().__init__()
        self.config, self.first = cfg, first
        self.wte = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.wpe = nn.Embedding(cfg.max_seq_len, cfg.d_model)
        self.h = nn.ModuleList(gpt2.Block(cfg) for _ in range(count))
        self.ln_f = nn.LayerNorm(cfg.d_model, eps=cfg.ln_eps)


class PipeLayout(Layout):
    """The stage's leaves by their single-device names; the blocks'
    global tensors are gathered over ``pipe`` (every stage's layers,
    stacked), the tree stacked into JAX's ``blocks`` layout."""

    def __init__(self, leaves, codec, group, num_layers: int):
        super().__init__(
            leaves, codec,
            post=lambda t: _restack(t, lambda p: stack_block_params(
                p, num_layers)),
            pre=lambda t: (_restack(t, unstack_block_params)
                           if "blocks" in t["params"] else t))
        self.group, self.num_layers = group, num_layers
        self.suffixes = list(dict.fromkeys(
            lf.name.split(".", 2)[2] for lf in leaves
            if lf.name.startswith("h.")))

    def _global(self, tensors: dict) -> dict:
        out = {lf.name: tensors[lf.name].detach() for lf in self.leaves
               if not lf.name.startswith("h.")}
        mine = sorted({int(lf.name.split(".")[1]) for lf in self.leaves
                       if lf.name.startswith("h.")})
        out.update(gather_blocks(
            {f"h.{j}.{sx}": tensors[f"h.{i}.{sx}"].detach()
             for j, i in enumerate(mine) for sx in self.suffixes},
            self.suffixes, len(mine), self.group, range(self.num_layers)))
        return out


def gather_blocks(local: dict, suffixes, count: int, group, order) -> dict:
    """Every stage's block tensors by global name, from this stage's
    ``local`` ones (``h.{j}.{suffix}``, ``j < count``): one all-gather
    over ``group`` a suffix, the stages' layers arriving in ``order``."""
    out = {}
    for suffix in suffixes:
        mine = torch.stack([local[f"h.{j}.{suffix}"] for j in range(count)])
        full = C.all_gather(mine, 0, group)
        for pos, layer in enumerate(order):
            out[f"h.{layer}.{suffix}"] = full[pos]
    return out


def check_model(model) -> None:
    """Pipeline parallelism's model: a GPT-2 of dense or flash attention
    and dense MLP blocks (a LLaMA model refuses, as JAX's example
    refuses ``--family llama --strategy pp``)."""
    from tpudp_torch.models import llama

    if isinstance(model, llama.Llama):
        raise ValueError(
            "pipeline parallelism drives GPT-2's stage twins (embed_tokens "
            "/ lm_head); a LLaMA model trains under dp, sp, tp, fsdp or "
            "zero1")
    if not isinstance(model, gpt2.GPT2):
        raise TypeError("make_pp_train_step drives tpudp_torch.models.gpt2."
                        f"GPT2; got {type(model).__name__}")
    cfg = model.config
    if cfg.attn_impl == "ring" or cfg.mlp_impl != "dense":
        raise ValueError(
            "pipeline parallelism supports dense/flash attention and dense "
            f"MLP blocks; got attn_impl={cfg.attn_impl!r} "
            f"mlp_impl={cfg.mlp_impl!r} (compose PP with SP/EP on separate "
            "mesh axes instead)")


def _check(model, mesh, n_microbatches, pipe_axis, schedule):
    check_model(model)
    cfg = model.config
    _, s, _ = axis_of(mesh, pipe_axis)
    if cfg.num_layers % s:
        raise ValueError(f"{cfg.num_layers} layers not divisible by {s} "
                         "stages")
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}; choose 'gpipe' "
                         "or '1f1b'")
    if n_microbatches < 1:
        raise ValueError(f"n_microbatches must be >= 1, got "
                         f"{n_microbatches}")


def _stage(model, state, optimizer, mesh, pipe_axis):
    """This rank's stage module, its leaves and its state, loaded from
    the single-device ``state``."""
    cfg = model.config
    group, s_count, s = axis_of(mesh, pipe_axis)
    per = cfg.num_layers // s_count
    device = next(model.parameters()).device
    stage = PipelineStage(cfg, s * per, per).to(device)
    leaves = []
    for name, p in stage.named_parameters():
        if name.startswith("h."):
            _, j, rest = name.split(".", 2)
            leaves.append(Leaf(f"h.{s * per + int(j)}.{rest}", p, group))
        else:
            leaves.append(Leaf(name, p))
    layout = PipeLayout(leaves, _codec(model), group, cfg.num_layers)
    built = from_standard(state, new_state(stage, optimizer, leaves, layout))
    stage.requires_grad_(True).train()
    return stage, leaves, built


def apply_blocks(blocks, cfg, x, remat: bool):
    """``blocks`` one after another (``remat``: each under
    ``torch.utils.checkpoint``, JAX's ``jax.checkpoint(block_fn)``)."""
    for blk in blocks:
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                gpt2.block_forward, blk, x, cfg, use_reentrant=False)
        else:
            x = gpt2.block_forward(blk, x, cfg)
    return x


class _Ring:
    """A stage's links to the other stages of ``pipe``: sends are posted
    without waiting (:meth:`drain` waits for them), receives block; a
    stage's link to itself (one stage holding every chunk of the MPMD
    schedule) is a queue a direction (``kind``: ``'fwd'``, ``'bwd'``)."""

    def __init__(self, group, s: int, count: int, shape, dtype, device):
        self.group, self.s, self.count = group, s, count
        self.shape, self.dtype, self.device = shape, dtype, device
        self.queues = {"fwd": collections.deque(),
                       "bwd": collections.deque()}
        self.pending = []

    def send(self, x, dst: int, kind: str) -> None:
        if dst == self.s:
            self.queues[kind].append(x.detach())
        else:
            self.pending.append(C.send(x, dst, self.group))

    def recv(self, src: int, kind: str):
        if src == self.s:
            return self.queues[kind].popleft()
        return C.recv(self.shape, self.dtype, self.device, src, self.group)

    def drain(self) -> None:
        for w in self.pending:
            w.wait()
        self.pending.clear()


def _gpipe(stage, ring: _Ring, tok_mb, tgt_mb, denom, remat) -> torch.Tensor:
    s, last = ring.s, ring.count - 1
    kept, loss = [], torch.zeros((), device=ring.device)
    for toks, tgts in zip(tok_mb, tgt_mb):
        if s == 0:
            x = gpt2.embed_tokens(stage, toks)
        else:
            x = ring.recv(s - 1, "fwd").requires_grad_(True)
        y = apply_blocks(stage.h, stage.config, x, remat)
        if s < last:
            ring.send(y, s + 1, "fwd")
            kept.append((x, y))
        else:
            loss_m = cross_entropy(gpt2.lm_head(stage, y), tgts) * (
                tgts.numel() / denom)
            kept.append((x, loss_m))
            loss = loss + loss_m.detach()
    for x, y in kept:
        if s == last:
            y.backward()
        else:
            y.backward(ring.recv(s + 1, "bwd"))
        if s > 0:
            ring.send(x.grad, s - 1, "bwd")
    ring.drain()
    return loss


def make_pp_train_step(model: nn.Module, optimizer, mesh, state, *,
                       n_microbatches: int, data_axis: str | None = DATA_AXIS,
                       pipe_axis: str = PIPE_AXIS, remat: bool = False,
                       schedule: str = "gpipe"):
    """DP x PP for GPT-2 (JAX's ``make_pp_train_step``): returns
    ``(pp_state, step)``; ``pp_state.model`` is this rank's
    :class:`PipelineStage`.  ``step(state, tokens, targets)`` takes this
    data shard's rows (every stage of a data row the same rows); the
    loss is the global batch's mean cross entropy on every rank.
    ``'1f1b'`` runs the MPMD step (``schedule.make_pipeline_train_step``)
    at ``interleave=1``, ``shard_optimizer=False``; its
    ``step.peak_stash`` is the most microbatch inputs the last step kept
    at once on this stage."""
    _check(model, mesh, n_microbatches, pipe_axis, schedule)
    if schedule == "1f1b":
        from tpudp_torch.parallel.schedule import make_pipeline_train_step

        return make_pipeline_train_step(
            model, optimizer, mesh, state, n_microbatches=n_microbatches,
            data_axis=data_axis, pipe_axis=pipe_axis, remat=remat,
            shard_optimizer=False)
    refuse_skip(optimizer, "pp")
    pipe, s_count, s = axis_of(mesh, pipe_axis)
    dgroup, dn, _ = axis_of(mesh, data_axis)
    stage, leaves, built = _stage(model, state, optimizer, mesh, pipe_axis)
    shared = [lf for lf in leaves if not lf.name.startswith("h.")]
    cfg = model.config

    def step(st, tokens, targets):
        b, t = tokens.shape
        if b % n_microbatches:
            raise ValueError(f"per-data-shard batch {b} not divisible by "
                             f"{n_microbatches} microbatches")
        st.optimizer.zero_grad(set_to_none=True)
        mb = b // n_microbatches
        ring = _Ring(pipe, s, s_count, (mb, t, cfg.d_model), cfg.dtype,
                     tokens.device)
        loss = _gpipe(stage, ring, tokens.split(mb), targets.split(mb),
                      b * t, remat)
        grads = grads_of(leaves)
        loss = loss.reshape(1)
        flat = torch.cat([lf.local.grad.reshape(-1) for lf in shared]
                         + [loss])
        C.all_reduce(flat, pipe)  # the structural psum over pipe
        sizes = [lf.local.numel() for lf in shared] + [1]
        for lf, piece in zip(shared + [None], flat.split(sizes)):
            if lf is None:
                loss = piece.clone()
            else:
                lf.local.grad.copy_(piece.reshape(lf.local.shape))
        mean_over(grads + [loss], dgroup, dn)
        apply_update(st, optimizer, leaves)
        st.step += 1
        loss = loss.reshape(())
        st.loss_sum += loss
        return st, loss

    return built, step


def make_pp_eval_step(model: nn.Module, mesh, state, *, n_microbatches: int,
                      data_axis: str | None = DATA_AXIS,
                      pipe_axis: str = PIPE_AXIS):
    """Pipelined eval with the Trainer's contract (JAX's
    ``make_pp_eval_step``): the GPipe forward, the metrics on the last
    stage, summed over ``pipe`` and ``data``.  ``state`` is the rung's
    (its ``model`` this rank's stage)."""
    from tpudp_torch.train import eval_metrics

    pipe, s_count, s = axis_of(mesh, pipe_axis)
    dgroup, dn, _ = axis_of(mesh, data_axis)
    stage, cfg = state.model, model.config

    def eval_step(st, tokens, targets, weights):
        del st
        b, t = tokens.shape
        mb = b // n_microbatches
        ring = _Ring(pipe, s, s_count, (mb, t, cfg.d_model), cfg.dtype,
                     tokens.device)
        sums = torch.zeros(3, device=tokens.device)
        with torch.no_grad():
            for m in range(n_microbatches):
                rows_ = slice(m * mb, (m + 1) * mb)
                x = (gpt2.embed_tokens(stage, tokens[rows_]) if s == 0
                     else ring.recv(s - 1, "fwd"))
                y = apply_blocks(stage.h, stage.config, x, False)
                if s < s_count - 1:
                    ring.send(y, s + 1, "fwd")
                    continue
                sums += eval_metrics(_Head(stage, y), None, targets[rows_],
                                     weights[rows_])
        ring.drain()
        C.all_reduce(sums, pipe)
        if dn > 1:
            C.all_reduce(sums, dgroup)
        return tuple(sums.unbind())

    return eval_step


class _Head:
    """The last stage's head on hidden states ``y``, called as a model
    (``eval_metrics`` passes its inputs, here unused)."""

    def __init__(self, stage, y):
        self.stage, self.y = stage, y

    def __call__(self, inputs, train=False):
        del inputs, train
        return gpt2.lm_head(self.stage, self.y)
