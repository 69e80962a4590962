"""The MPMD pipeline schedule ``1f1b_mpmd`` — the port of
``tpudp/parallel/schedule.py``: 1F1B with recomputation over
interleaved virtual stages on a ``[data x] pipe`` mesh, with the
optimizer update sharded over the data replicas inside the step.

**Placement** (:class:`StagePartition`).  The ``L`` blocks are cut into
``C = S * V`` chunks of ``L / C`` layers (``S`` stages, ``V =
interleave``); chunk ``c`` lives on stage ``c % S``, so each stage hosts
``V`` virtual stages.  The checkpoint tree stacks the blocks in
:meth:`StagePartition.layer_order` (stage-major, each stage's chunks
chunk-major), so a ``pipe`` slice of the stack is one stage's layers.

**Ticks.**  The forward of microbatch ``m`` on virtual stage ``p`` runs
at tick ``p + m`` and its backward at tick ``2(C-1) - p + m``, the
forward recomputed from the stashed input (a chunk stashes at most
``min(M, 2C-1)`` inputs).  JAX runs every tick on every device in
lockstep, with masks; here each rank runs only its live slots, in tick
order: forward slots, then backward slots, by chunk.  Activations go to
the next virtual stage and cotangents to the previous one by
point-to-point sends (``collectives.send`` / ``recv``; a send is posted
without waiting); from the last stage an activation wraps to stage 0's
next chunk, and a cotangent from stage 0 wraps to the last stage's
previous chunk.  Every message of a tick is consumed at the next tick in
the order it was sent, so no tags are needed.  A single stage hands its
chunks their inputs through queues of its own.

**Numerics** (JAX's discipline, which makes the loss trajectory
bit-exact across pipe degrees at equal DP and M): a microbatch's head
loss is the SUM of its cross entropies, normalised once at the end; a
chunk's gradients accumulate in microbatch order; the embedding-side
and head-side gradients of the shared parameters (the tied ``wte``)
accumulate in separate buffers, added once.  The port adds them on each
stage, sums the shared gradients over ``pipe`` (one stage holds each
side, the others zeros, so the sum is exact) and only then divides by
the token count, so the division happens on the same sum at every pipe
degree.

**The in-step sharded optimizer** (``shard_optimizer=True``): each
gradient leaf (a shared parameter, or one block parameter stacked over
the stage's layers) is flattened and zero-padded to a multiple of DP,
one reduce-scatter over ``data`` (divided by DP) hands each replica its
shard, the optimizer updates a 1/DP slice of the parameters against a
1/DP momentum, and one all-gather rebuilds the parameters.  The shards
lie in the port's tensor layout; the checkpoint tree re-lays them out as
JAX's ``_opt_shard_layout`` (flax layout, flattened and padded per
stage).  The update must be elementwise: ``clip_norm`` (a global norm)
is refused, as is ``skip_nonfinite`` on every pipeline schedule.
``shard_optimizer=False`` keeps the stage's optimizer over its own
parameters, the gradients averaged over ``data`` by one all-reduce.

JAX counts its traces in ``TRACE_COUNTS['pp_1f1b']`` (one per geometry);
an eager program has nothing to count, and the port keeps no such
counter.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from tpudp_torch.models import gpt2
from tpudp_torch.models.norm import DATA_AXIS
from tpudp_torch.parallel import collectives as C
from tpudp_torch.parallel.pipeline import (PIPE_AXIS, PipelineStage, _Head,
                                           _map, _Ring, _stack, _zip_map,
                                           apply_blocks, check_model,
                                           gather_blocks)
from tpudp_torch.parallel.sharded import (Layout, Leaf, _JAX_OPT_NAMES,
                                          _adamw, _opt_buffers, apply_update,
                                          axis_of, mean_over, new_state,
                                          refuse_skip)
from tpudp_torch.train import _codec, fingerprint_tensors, state_to_jax
from tpudp_torch.utils.checkpoint import _to_cpu
from tpudp_torch.utils.flops import pipeline_bubble_fraction  # noqa: F401


@dataclass(frozen=True)
class StagePartition:
    """The placement of ``num_layers`` blocks on ``stages`` pipeline
    stages of ``interleave`` virtual stages each (JAX's
    ``StagePartition``): chunk ``c`` of ``num_layers / chunks`` layers
    lives on stage ``c % stages``."""

    num_layers: int
    stages: int
    interleave: int = 1

    def __post_init__(self):
        if self.stages < 1 or self.interleave < 1:
            raise ValueError(
                f"stages ({self.stages}) and interleave ({self.interleave}) "
                "must be >= 1")
        if self.num_layers % (self.stages * self.interleave):
            raise ValueError(
                f"{self.num_layers} layers not divisible into "
                f"{self.stages} stages x {self.interleave} virtual chunks")

    @property
    def chunks(self) -> int:
        """The virtual stages, ``C = stages * interleave``."""
        return self.stages * self.interleave

    @property
    def layers_per_chunk(self) -> int:
        return self.num_layers // self.chunks

    def chunk_layers(self, chunk: int) -> tuple[int, ...]:
        lo = chunk * self.layers_per_chunk
        return tuple(range(lo, lo + self.layers_per_chunk))

    def chunk_stage(self, chunk: int) -> int:
        return chunk % self.stages

    def stage_chunks(self, stage: int) -> tuple[int, ...]:
        return tuple(stage + v * self.stages for v in range(self.interleave))

    def stage_layers(self, stage: int) -> tuple[int, ...]:
        """The layers ``stage`` hosts, chunk-major."""
        return sum((self.chunk_layers(c) for c in self.stage_chunks(stage)),
                   ())

    def layer_order(self) -> tuple[int, ...]:
        """The checkpoint's stacking order, stage-major (the identity at
        ``interleave == 1``)."""
        return sum((self.stage_layers(s) for s in range(self.stages)), ())

    def ticks(self, n_microbatches: int) -> int:
        """The schedule's length, ``M + 2(C-1)``."""
        return n_microbatches + 2 * (self.chunks - 1)

    def bubble_fraction(self, n_microbatches: int) -> float:
        return pipeline_bubble_fraction(self.stages, n_microbatches,
                                        interleave=self.interleave)


def stack_partitioned(params: dict, part: StagePartition,
                      prefix: str = "h_") -> dict:
    """The flax tree (``h_0`` .. ``h_{L-1}``) in the partition's layout:
    one ``blocks`` tree stacked in :meth:`StagePartition.layer_order`
    beside the shared parameters (tensors or numpy arrays)."""
    out = {k: v for k, v in params.items() if not k.startswith(prefix)}
    out["blocks"] = _zip_map([params[f"{prefix}{i}"]
                              for i in part.layer_order()], _stack)
    return out


def unstack_partitioned(params_pp: dict, part: StagePartition,
                        prefix: str = "h_") -> dict:
    """The inverse of :func:`stack_partitioned`."""
    blocks = params_pp["blocks"]
    out = {k: v for k, v in params_pp.items() if k != "blocks"}
    for pos, layer in enumerate(part.layer_order()):
        out[f"{prefix}{layer}"] = _map(blocks, lambda x, p=pos: x[p])
    return out


def _pad_to(n: int, k: int) -> int:
    return k * math.ceil(n / k) if k > 1 else n


def _padded(flat: torch.Tensor, n: int) -> torch.Tensor:
    return F.pad(flat, (0, n - flat.numel())) if n > flat.numel() else flat


def opt_shard_layout(subtree: dict, part: StagePartition, dp: int) -> dict:
    """One params-shaped optimizer subtree (the momentum, say) of flax
    tensors in JAX's in-step-sharded layout (``_opt_shard_layout``):
    stacked by the partition, then each leaf flattened and zero-padded to
    a multiple of ``dp`` — each stage's part of a block leaf on its own,
    a shared leaf whole."""
    pp = stack_partitioned(subtree, part)

    def flat(x, per_stage: bool):
        rows = x.reshape(part.stages, -1) if per_stage else x.reshape(1, -1)
        n = rows.shape[1]
        return F.pad(rows, (0, _pad_to(n, dp) - n)).reshape(-1)

    out = {k: _map(v, lambda x: flat(x, False)) for k, v in pp.items()
           if k != "blocks"}
    out["blocks"] = _map(pp["blocks"], lambda x: flat(x, True))
    return out


def _opt_unshard(flat_tree: dict, params_pp: dict,
                 part: StagePartition) -> dict:
    """The inverse of :func:`opt_shard_layout`, given the stacked
    parameters for the shapes: the flax tree in the standard layout."""
    def leaf(x, p, per_stage: bool):
        x = torch.as_tensor(x)
        rows = x.reshape(part.stages if per_stage else 1, -1)
        n = p.numel() // rows.shape[0]
        return rows[:, :n].reshape(tuple(p.shape))

    out = {k: _zip_map([v, params_pp[k]], lambda xs: leaf(*xs, False))
           for k, v in flat_tree.items() if k != "blocks"}
    out["blocks"] = _zip_map([flat_tree["blocks"], params_pp["blocks"]],
                             lambda xs: leaf(*xs, True))
    return unstack_partitioned(out, part)


# -- the stage and its layout ----------------------------------------------

class _Stage:
    """This rank's part of the partition: the :class:`PipelineStage`
    module of its ``V * L/C`` layers (local ``h.j`` is global layer
    ``layers[j]``), its chunks, and its parameters grouped as the
    checkpoint's leaves (``units``: a shared parameter, or one block
    parameter over the stage's layers, stacked)."""

    def __init__(self, model, part: StagePartition, s: int, device):
        cfg = model.config
        self.part, self.s, self.cfg = part, s, cfg
        self.layers = part.stage_layers(s)
        self.module = PipelineStage(cfg, self.layers[0],
                                    len(self.layers)).to(device)
        lc = part.layers_per_chunk
        self.chunks = [list(self.module.h[v * lc:(v + 1) * lc])
                       for v in range(part.interleave)]
        self.chunk_params = [[p for blk in ch for p in blk.parameters()]
                             for ch in self.chunks]
        m = self.module
        self.embed_params = [m.wte.weight, m.wpe.weight]
        self.head_params = [m.ln_f.weight, m.ln_f.bias, m.wte.weight]
        self.shared = [(name, p) for name, p in m.named_parameters()
                       if not name.startswith("h.")]
        suffixes = list(dict.fromkeys(
            name.split(".", 2)[2] for name, _ in m.named_parameters()
            if name.startswith("h.")))
        named = dict(m.named_parameters())
        # Each unit: its local names and tensors.
        self.units = [([name], [p]) for name, p in self.shared] + [
            ([f"h.{j}.{suffix}" for j in range(len(self.layers))],
             [named[f"h.{j}.{suffix}"] for j in range(len(self.layers))])
            for suffix in suffixes]
        self.suffixes = suffixes

    def global_name(self, local: str) -> str:
        if not local.startswith("h."):
            return local
        _, j, rest = local.split(".", 2)
        return f"h.{self.layers[int(j)]}.{rest}"


def _unit_flat(tensors) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1) for t in tensors])


def _unit_split(flat: torch.Tensor, tensors) -> list:
    return [piece.reshape(t.shape) for piece, t in
            zip(flat[:sum(t.numel() for t in tensors)].split(
                [t.numel() for t in tensors]), tensors)]


def _slice(tensors, lo: int, hi: int) -> torch.Tensor:
    """Elements ``lo .. hi`` of the tensors' flattened concatenation,
    zero-padded past its end (a copy; the whole is never built)."""
    pieces, start = [], 0
    for t in tensors:
        n = t.numel()
        if start < hi and lo < start + n:
            a, b = max(lo - start, 0), min(hi - start, n)
            pieces.append(t.detach().reshape(-1)[a:b])
        start += n
    flat = torch.cat(pieces) if pieces else tensors[0].new_zeros(0)
    return _padded(flat, hi - lo)


class _Shards:
    """The ``shard_optimizer`` update: for each unit, the optimizer's
    tensor is a placeholder that holds, during an update only, this
    replica's 1/DP slice of the unit's flattened, padded parameters; its
    buffers (the momentum) stay resident at 1/DP."""

    def __init__(self, stage: _Stage, dgroup, dp: int, d: int):
        self.stage, self.dgroup, self.dp, self.d = stage, dgroup, dp, d
        self.sizes = [_pad_to(sum(t.numel() for t in ts), dp) // dp
                      for _, ts in stage.units]
        self.params = [torch.nn.Parameter(ts[0].new_empty(0))
                       for _, ts in stage.units]

    def mine(self, flats: list) -> list:
        """This replica's slice of each unit's padded flat tensor."""
        return [_padded(f, k * self.dp)[self.d * k:(self.d + 1) * k]
                for f, k in zip(flats, self.sizes)]

    def scatter_grads(self, grads: list) -> None:
        """Each placeholder set to this replica's slice of the unit's
        parameters, its gradient to the same slice of the unit's gradient
        summed over ``data`` and divided by DP (one reduce-scatter)."""
        for shard, k, (_, ts) in zip(self.params, self.sizes,
                                     self.stage.units):
            shard.data = _slice(ts, self.d * k, (self.d + 1) * k)
        if self.dp == 1:
            for shard, g in zip(self.params, grads):
                shard.grad = _padded(g, shard.numel())
            return
        rows = torch.cat([_padded(g, k * self.dp).reshape(self.dp, k)
                          for g, k in zip(grads, self.sizes)], 1)
        mine = C.reduce_scatter(rows.reshape(-1), 0, self.dgroup) / self.dp
        for shard, g in zip(self.params, mine.split(self.sizes)):
            shard.grad = g

    def gather(self, tensors: list) -> list:
        """Each unit's whole flat tensor from the replicas' shards of
        ``tensors`` (one all-gather)."""
        if self.dp == 1:
            return list(tensors)
        flat = torch.cat([t.detach().reshape(-1) for t in tensors])
        rows = C.all_gather(flat, 0, self.dgroup).reshape(self.dp, -1)
        return [piece.reshape(-1) for piece in rows.split(self.sizes, 1)]

    def push(self) -> None:
        """The stage's parameters rebuilt from the updated slices, which
        are then let go."""
        with torch.no_grad():
            for full, (_, ts) in zip(self.gather(self.params),
                                     self.stage.units):
                for t, piece in zip(ts, _unit_split(full, ts)):
                    t.copy_(piece)
        for shard in self.params:
            shard.data = shard.data.new_empty(0)
            shard.grad = None


class MpmdLayout(Layout):
    """The map between a ``1f1b_mpmd`` rank's tensors and JAX's
    ``pp_state`` checkpoint tree: the blocks stacked in
    :meth:`StagePartition.layer_order`, and the optimizer's buffers in
    :func:`opt_shard_layout` (``shard_optimizer``) or stacked as the
    parameters.  A standard-layout tree (``h_0`` ..) loads too."""

    def __init__(self, leaves, codec, stage: _Stage, pipe, shards):
        super().__init__(leaves, codec)
        self.stage, self.pipe, self.shards = stage, pipe, shards
        self.part = stage.part

    def _global(self, local: dict) -> dict:
        """``{global name: tensor}`` of every layer from each stage's
        ``{local name: tensor}`` (one all-gather over ``pipe`` a block
        parameter; the stages' layers arrive in ``layer_order``)."""
        st = self.stage
        out = {name: local[name] for name, _ in st.shared}
        out.update(gather_blocks(local, st.suffixes, len(st.layers),
                                 self.pipe, self.part.layer_order()))
        return out

    def _local_buffers(self, opt, key: str) -> dict:
        """``{local name: tensor}`` of the optimizer's buffer ``key``
        (zeros before the first update)."""
        st = self.stage
        if self.shards is None:
            return {name: (opt.state.get(p, {}).get(key)
                           if opt.state.get(p, {}).get(key) is not None
                           else torch.zeros_like(p))
                    for name, p in st.module.named_parameters()}
        bufs = [opt.state.get(s, {}).get(key) for s in self.shards.params]
        bufs = [s.new_zeros(k) if b is None else b for b, s, k in
                zip(bufs, self.shards.params, self.shards.sizes)]
        out = {}
        for full, (names, ts) in zip(self.shards.gather(bufs), st.units):
            out.update(zip(names, _unit_split(full, ts)))
        return out

    def to_jax(self, state) -> dict:
        to_jax, _ = self.codec
        st, opt = self.stage, state.optimizer
        named = {n: p.detach() for n, p in st.module.named_parameters()}
        params = to_jax(self._global(named))[0]
        dp = self.shards.dp if self.shards is not None else 1
        relayout = ((lambda t: opt_shard_layout(t, self.part, dp))
                    if self.shards is not None
                    else (lambda t: stack_partitioned(t, self.part)))
        opt_state: dict = {}
        for key in _opt_buffers(opt):
            glob = self._global(self._local_buffers(opt, key))
            opt_state[_JAX_OPT_NAMES[key]] = relayout(to_jax(glob)[0])
        if _adamw(opt):
            tensors = (self.shards.params if self.shards is not None
                       else [p for _, p in st.module.named_parameters()])
            steps = [opt.state.get(t, {}).get("step") for t in tensors]
            count = next((s for s in steps if s is not None), 0)
            opt_state["count"] = torch.tensor(int(count), dtype=torch.int32)
        return {"step": torch.tensor(state.step, dtype=torch.int32),
                "params": stack_partitioned(params, self.part),
                "batch_stats": {}, "opt_state": opt_state,
                "loss_sum": state.loss_sum.detach()}

    def _standard(self, tree: dict) -> dict:
        """A ``pp_state`` tree in the standard layout (``h_i``)."""
        if "blocks" not in tree["params"]:
            return tree
        params_pp = tree["params"]
        params = unstack_partitioned(params_pp, self.part)
        out = dict(tree, params=params)

        def one(sub):
            if not isinstance(sub, dict) or "blocks" not in sub:
                return sub
            leaf = sub["blocks"]
            ref = params_pp["blocks"]
            while isinstance(leaf, dict):
                key = next(iter(leaf))
                leaf, ref = leaf[key], ref[key]
            if tuple(leaf.shape) == tuple(ref.shape):  # stacked
                return unstack_partitioned(sub, self.part)
            return _opt_unshard(sub, params_pp, self.part)

        out["opt_state"] = {k: one(v)
                            for k, v in tree.get("opt_state", {}).items()}
        return out

    def load(self, state, tree: dict) -> None:
        tree = self._standard(_to_cpu(tree))
        _, from_jax = self.codec
        st, opt = self.stage, state.optimizer
        sd = from_jax(tree["params"], {})
        with torch.no_grad():
            for name, p in st.module.named_parameters():
                p.copy_(sd[st.global_name(name)])
        state.step = int(tree["step"])
        state.loss_sum.copy_(torch.as_tensor(np.array(tree["loss_sum"])))
        tensors = (self.shards.params if self.shards is not None
                   else [p for _, p in st.module.named_parameters()])
        for t in tensors:
            opt.state.pop(t, None)
        if not state.step:
            return
        ost = tree["opt_state"]
        for key in _opt_buffers(opt):
            glob = from_jax(ost[_JAX_OPT_NAMES[key]], {})
            if self.shards is None:
                for name, p in st.module.named_parameters():
                    opt.state[p][key] = torch.empty_like(p).copy_(
                        glob[st.global_name(name)])
                continue
            flats = [torch.cat([glob[st.global_name(n)].reshape(-1)
                                for n in names]).to(ts[0].device)
                     for names, ts in st.units]
            for shard, piece in zip(self.shards.params,
                                    self.shards.mine(flats)):
                opt.state[shard][key] = piece.clone()
        if _adamw(opt):
            group = opt.param_groups[0]
            on_device = group.get("capturable") or group.get("fused")
            for t in tensors:
                opt.state[t]["step"] = torch.tensor(
                    float(ost["count"]), dtype=torch.float32,
                    device=t.device if on_device else "cpu")


# -- the schedule ------------------------------------------------------------

def _zeros(params) -> list:
    return [torch.zeros_like(p, dtype=torch.float32) for p in params]


def _add(acc: list, grads) -> None:
    for a, g in zip(acc, grads):
        a.add_(g)


def onef1b_mpmd_loss_and_grads(stage: _Stage, links: _Ring, tok_mb,
                               tgt_mb, remat: bool, peak: list):
    """This stage's live slots of the ``M + 2(C-1)`` ticks: returns
    ``(loss_sum, chunk_grads, shared_grads)`` — the summed cross
    entropy of the microbatches whose head runs here (zero elsewhere),
    each chunk's parameter gradients and the shared parameters' (``wte``
    ``wpe``, ``ln_f``: embedding side plus head side), all unnormalised
    sums in float32."""
    part, s, cfg = stage.part, stage.s, stage.cfg
    S, V, C_ = part.stages, part.interleave, part.chunks
    M = len(tok_mb)
    mod = stage.module
    stash = [dict() for _ in range(V)]
    held = {}
    gchunk = [_zeros(ps) for ps in stage.chunk_params]
    gembed = _zeros(stage.embed_params)
    ghead = _zeros(stage.head_params)
    loss = torch.zeros((), dtype=torch.float32, device=links.device)
    for tick in range(part.ticks(M)):
        for v in range(V):  # forward slots
            c = v * S + s
            m = tick - c
            if not 0 <= m < M:
                continue
            with torch.no_grad():
                x = (gpt2.embed_tokens(mod, tok_mb[m]) if c == 0
                     else links.recv((s - 1) % S, "fwd"))
                if c == C_ - 1:  # its backward runs this tick
                    held[v] = x
                    peak[0] = max(peak[0], 1)
                    continue
                stash[v][m] = x
                peak[0] = max(peak[0], len(stash[v]))
                links.send(apply_blocks(stage.chunks[v], cfg, x, remat),
                           (s + 1) % S, "fwd")
        for v in range(V):  # backward slots
            c = v * S + s
            m = tick - 2 * (C_ - 1) + c
            if not 0 <= m < M:
                continue
            params = stage.chunk_params[v]
            if c == C_ - 1:
                x = held.pop(v).requires_grad_(True)
                y = apply_blocks(stage.chunks[v], cfg, x, remat)
                loss_m = F.cross_entropy(
                    gpt2.lm_head(mod, y).reshape(-1, cfg.vocab_size),
                    tgt_mb[m].reshape(-1).long(), reduction="sum")
                head = stage.head_params
                grads = torch.autograd.grad(loss_m, params + head + [x])
                _add(ghead, grads[len(params):-1])
                loss = loss + loss_m.detach()
            else:
                dy = links.recv((s + 1) % S, "bwd")
                x = stash[v].pop(m).requires_grad_(True)
                y = apply_blocks(stage.chunks[v], cfg, x, remat)
                grads = torch.autograd.grad(y, params + [x], dy)
            _add(gchunk[v], grads[:len(params)])
            dx = grads[-1]
            if c == 0:  # the embedding's own accumulator
                e = gpt2.embed_tokens(mod, tok_mb[m])
                _add(gembed, torch.autograd.grad(e, stage.embed_params, dx))
            else:
                links.send(dx, (s - 1) % S, "bwd")
    links.drain()
    shared = {}
    for p, g in zip(stage.embed_params, gembed):
        shared[p] = g
    for p, g in zip(stage.head_params, ghead):
        shared[p] = shared[p] + g if p in shared else g
    return loss, gchunk, shared


def _check(model, mesh, n_microbatches, pipe_axis, interleave, optimizer,
           shard_optimizer):
    check_model(model)
    if n_microbatches < 1:
        raise ValueError(f"n_microbatches must be >= 1, got "
                         f"{n_microbatches}")
    refuse_skip(optimizer, "pp")
    if shard_optimizer and optimizer.clip_norm is not None:
        raise ValueError(
            "clip_norm needs the whole gradient's norm, and the in-step "
            "sharded optimizer updates 1/DP shards with an elementwise "
            "transform: pass shard_optimizer=False to clip")
    _, s, _ = axis_of(mesh, pipe_axis)
    return StagePartition(model.config.num_layers, s, interleave)


def make_pipeline_train_step(model, optimizer, mesh, state, *,
                             n_microbatches: int, interleave: int = 1,
                             data_axis: str | None = DATA_AXIS,
                             pipe_axis: str = PIPE_AXIS, remat: bool = False,
                             shard_optimizer: bool = True):
    """The ``1f1b_mpmd`` train step for GPT-2 (JAX's
    ``make_pipeline_train_step``; the module docstring has the schedule)
    from a single-device-layout ``state``: returns ``(pp_state, step)``,
    ``pp_state.model`` this rank's stage module and its checkpoint tree
    JAX's ``pp_state``.  ``step(state, tokens, targets)`` takes this data
    shard's rows and returns the global batch's mean cross entropy on
    every rank; ``step.peak_stash`` is the most inputs one chunk of this
    stage kept at once in the last step, ``step.partition`` the
    :class:`StagePartition`."""
    part = _check(model, mesh, n_microbatches, pipe_axis, interleave,
                  optimizer, shard_optimizer)
    pipe, _, s = axis_of(mesh, pipe_axis)
    dgroup, dp, d = axis_of(mesh, data_axis)
    cfg = model.config
    device = next(model.parameters()).device
    stage = _Stage(model, part, s, device)
    stage.module.requires_grad_(True).train()
    leaves = [Leaf(stage.global_name(name), p,
                   pipe if name.startswith("h.") else None)
              for name, p in stage.module.named_parameters()]
    shards = _Shards(stage, dgroup, dp, d) if shard_optimizer else None
    opt_leaves = ([Leaf(names[0], t, dgroup) for (names, _), t in
                   zip(stage.units, shards.params)]
                  if shards is not None else leaves)
    layout = MpmdLayout(opt_leaves, _codec(model), stage, pipe, shards)
    built = new_state(stage.module, optimizer, opt_leaves, layout)
    layout.load(built, state_to_jax(state))
    peak = [0]

    def step(st, tokens, targets):
        b, t = tokens.shape
        if b % n_microbatches:
            raise ValueError(f"per-data-shard batch {b} not divisible by "
                             f"{n_microbatches} microbatches")
        mb = b // n_microbatches
        links = _Ring(pipe, s, part.stages, (mb, t, cfg.d_model),
                      cfg.dtype, tokens.device)
        peak[0] = 0
        loss, gchunk, shared = onef1b_mpmd_loss_and_grads(
            stage, links, tokens.split(mb), targets.split(mb), remat, peak)
        step.peak_stash = peak[0]
        # The structural sum over pipe: each shared gradient (and the
        # loss) is held by the stages that made it, zeros elsewhere.
        sh = [p for _, p in stage.shared]
        flat = torch.cat([shared[p].reshape(-1) for p in sh]
                         + [loss.reshape(1)])
        C.all_reduce(flat, pipe)
        denom = float(b * t)
        flat = flat / denom
        pieces = flat.split([p.numel() for p in sh] + [1])
        grads = {p: g.reshape(p.shape) for p, g in zip(sh, pieces)}
        for ps, gs in zip(stage.chunk_params, gchunk):
            for p, g in zip(ps, gs):
                grads[p] = g / denom
        loss = pieces[-1].clone()
        if shards is not None:
            shards.scatter_grads([_unit_flat([grads[p] for p in ts])
                                  for _, ts in stage.units])
            mean_over([loss], dgroup, dp)
            apply_update(st, optimizer, opt_leaves)
            shards.push()
        else:
            for lf in leaves:
                lf.local.grad = grads[lf.local].to(lf.local.dtype)
            mean_over([lf.local.grad for lf in leaves] + [loss], dgroup,
                      dp)
            apply_update(st, optimizer, leaves)
        if st.sdc_fp is not None:
            st.sdc_fp = stage_fingerprint(st, leaves, pipe,
                                          shards is None)
        st.step += 1
        loss = loss.reshape(())
        st.loss_sum += loss
        return st, loss

    step.peak_stash = 0
    step.partition = part
    return built, step


def stage_fingerprint(state, leaves: list, pipe, with_opt: bool):
    """JAX's MPMD fingerprint: this stage's parameters (the shared ones
    too, which every stage holds) and, without ``shard_optimizer``, its
    optimizer buffers, summed over ``pipe`` — the whole pipeline's
    checksum on every stage.  The 1/DP-sharded optimizer state is left
    out, as JAX leaves it out."""
    from tpudp_torch.sdc import finish_fingerprint, partial_fingerprint

    params = [lf.local for lf in leaves]
    part = partial_fingerprint(fingerprint_tensors(state.optimizer, params)
                               if with_opt else params)
    C.all_reduce(part, pipe)
    return finish_fingerprint(part)


def make_pipeline_eval_step(model, mesh, state, *, n_microbatches: int,
                            interleave: int = 1,
                            data_axis: str | None = DATA_AXIS,
                            pipe_axis: str = PIPE_AXIS):
    """The eval twin (JAX's ``make_pipeline_eval_step``): the forward
    ticks alone (``M + C - 1``, :func:`pipeline_forward_mpmd`), the
    metrics on the last virtual stage, summed over ``pipe`` and
    ``data``.  ``state`` is the train step's."""
    from tpudp_torch.train import eval_metrics

    pipe, _, _ = axis_of(mesh, pipe_axis)
    dgroup, dp, _ = axis_of(mesh, data_axis)
    stage = state.layout.stage
    cfg = model.config

    def eval_step(st, tokens, targets, weights):
        del st
        b, t = tokens.shape
        mb = b // n_microbatches
        links = _Ring(pipe, stage.s, stage.part.stages,
                      (mb, t, cfg.d_model), cfg.dtype, tokens.device)
        sums = torch.zeros(3, device=tokens.device)
        for m, y in pipeline_forward_mpmd(stage, links, tokens.split(mb)):
            rows_ = slice(m * mb, (m + 1) * mb)
            sums += eval_metrics(_Head(stage.module, y), None,
                                 targets[rows_], weights[rows_])
        C.all_reduce(sums, pipe)
        if dp > 1:
            C.all_reduce(sums, dgroup)
        return tuple(sums.unbind())

    return eval_step


def pipeline_forward_mpmd(stage: _Stage, links: _Ring, tok_mb):
    """The forward ticks (``M + C - 1``) of this stage's live slots,
    without gradients: yields ``(m, hidden)`` for each microbatch whose
    last virtual stage runs here."""
    part, s, cfg = stage.part, stage.s, stage.cfg
    S, V, C_ = part.stages, part.interleave, part.chunks
    M = len(tok_mb)
    with torch.no_grad():
        for tick in range(M + C_ - 1):
            for v in range(V):
                c = v * S + s
                m = tick - c
                if not 0 <= m < M:
                    continue
                x = (gpt2.embed_tokens(stage.module, tok_mb[m]) if c == 0
                     else links.recv((s - 1) % S, "fwd"))
                y = apply_blocks(stage.chunks[v], cfg, x, False)
                if c == C_ - 1:
                    yield m, y
                else:
                    links.send(y, (s + 1) % S, "fwd")
    links.drain()
