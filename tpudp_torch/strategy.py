"""Parallelism strategies as Trainer rungs — the port of
``tpudp/strategy.py``.

:func:`build_strategy` packages a rung's state, train step, eval step
and input rule, so the :class:`~tpudp_torch.trainer.Trainer` drives any
of them through one epoch loop.  Every strategy keeps the contracts::

    train_step(state, inputs, labels)          -> (state, loss)
    eval_step(state, inputs, labels, weights)  -> (loss_sum, correct, count)
    shard_for(global_array)                    -> this rank's block of it

Where JAX's ``shard_for`` names the sharding that places a global batch
on the mesh, the port's returns this rank's block: every rank reads the
same global batches and steps on its own block.

  ============  ===========================  ==========================
  strategy      mesh axes                    options
  ============  ===========================  ==========================
  ``tp``        ``data`` x ``model``         ``rules`` (partition rules)
  ``fsdp``      ``data``                     ``min_size``
  ``zero1``     ``data``                     ``min_size``
  ``pp``        [``data`` x] ``pipe``        ``n_microbatches``, ``remat``,
                                             ``schedule`` (``gpipe`` /
                                             ``1f1b`` / ``1f1b_mpmd``);
                                             under ``1f1b_mpmd`` also
                                             ``interleave``,
                                             ``shard_optimizer``
  ``ep``        ``data`` x ``expert``        ``aux_loss_coef``
  ``sp``        ``data`` x ``seq``           —
  ============  ===========================  ==========================

Build the mesh with :func:`tpudp_torch.mesh.make_mesh_nd` (fsdp and zero1
also take the 1-D :func:`tpudp_torch.mesh.make_mesh`).  ``'dp'`` is the
Trainer's own rung, as in JAX.  pp's ``schedule='1f1b_mpmd'`` is
``tpudp_torch.parallel.schedule`` (interleaved virtual stages,
``interleave`` default 1; the in-step sharded optimizer,
``shard_optimizer`` default True).  ``donate`` is accepted for JAX's
signature: PyTorch updates the state in place either way.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

from tpudp_torch.models.norm import DATA_AXIS
from tpudp_torch.parallel.sharded import axis_of, rows

STRATEGIES = ("dp", "tp", "fsdp", "zero1", "pp", "ep", "sp")


class BuiltStrategy(NamedTuple):
    state: Any
    train_step: Callable
    eval_step: Callable
    shard_for: Callable[[Any], Any]


def _rows_of(mesh, axes: tuple) -> Callable:
    """``shard_for`` of a batch split over ``axes`` (flattened in mesh
    order): this rank's rows."""
    index, parts = 0, 1
    for axis in axes:
        _, n, c = axis_of(mesh, axis)
        index, parts = index * n + c, parts * n

    def shard_for(a):
        return rows(a, index, parts)

    return shard_for


def build_strategy(name: str, model, optimizer, mesh, state, *,
                   donate: bool = True, **options) -> BuiltStrategy:
    """The rung ``name`` built from a single-device-layout ``state``
    (``tpudp_torch.train.init_state(model, optimizer)``) of ``model``;
    ``optimizer`` is the :class:`~tpudp_torch.train.OptimizerSpec`.  See
    the module table for each strategy's options."""
    del donate
    if name == "dp":
        raise ValueError(
            "'dp' is the Trainer's built-in rung (make_train_step / the sync "
            "ladder); build_strategy only packages the advanced rungs "
            f"{tuple(s for s in STRATEGIES if s != 'dp')}")
    if mesh is None:
        raise ValueError(f"strategy {name!r} needs a device mesh")
    builders = {"tp": _build_tp, "fsdp": _build_fsdp,
                "zero1": _build_zero1, "pp": _build_pp, "ep": _build_ep,
                "sp": _build_sp}
    if name not in builders:
        raise ValueError(f"unknown strategy {name!r}; choose from "
                         f"{STRATEGIES}")
    built = builders[name](model, optimizer, mesh, state, options)
    # The telemetry slots ride along; the rungs JAX runs through
    # _loss_and_updates (and 1f1b_mpmd's fingerprint) write them, gpipe,
    # 1f1b and ep leave them as they are, as JAX's steps do.
    built.state.obs_norms = state.obs_norms
    built.state.sdc_fp = state.sdc_fp
    return built


def _build_tp(model, optimizer, mesh, state, options):
    from tpudp_torch.parallel.sharded import make_tp_train_step, tp_eval

    rules = options.pop("rules")
    data_axis = options.pop("data_axis", DATA_AXIS)
    _no_extra(options, "tp")
    st, step = make_tp_train_step(model, optimizer, mesh, state, rules,
                                  data_axis=data_axis)
    return BuiltStrategy(st, step, tp_eval(mesh, st, data_axis),
                         _rows_of(mesh, (data_axis,)))


def _build_data_sharded(name, make_step, model, optimizer, mesh, state,
                        options):
    from tpudp_torch.parallel.sharded import data_sharded_eval

    data_axis = options.pop("data_axis", DATA_AXIS)
    min_size = options.pop("min_size", 1024)
    _no_extra(options, name)
    st, step = make_step(model, optimizer, mesh, state, data_axis=data_axis,
                         min_size=min_size)
    return BuiltStrategy(st, step, data_sharded_eval(mesh, st, data_axis),
                         _rows_of(mesh, (data_axis,)))


def _build_fsdp(model, optimizer, mesh, state, options):
    from tpudp_torch.parallel.sharded import make_fsdp_train_step

    return _build_data_sharded("fsdp", make_fsdp_train_step, model,
                               optimizer, mesh, state, options)


def _build_zero1(model, optimizer, mesh, state, options):
    from tpudp_torch.parallel.sharded import make_zero1_train_step

    return _build_data_sharded("zero1", make_zero1_train_step, model,
                               optimizer, mesh, state, options)


def _build_pp(model, optimizer, mesh, state, options):
    from tpudp_torch.parallel.pipeline import (PIPE_AXIS, make_pp_eval_step,
                                               make_pp_train_step)

    n_microbatches = options.pop("n_microbatches")
    pipe_axis = options.pop("pipe_axis", PIPE_AXIS)
    data_axis = options.pop(
        "data_axis", DATA_AXIS if DATA_AXIS in getattr(mesh, "shape", {})
        else None)
    remat = options.pop("remat", False)
    schedule = options.pop("schedule", "gpipe")
    if schedule in ("1f1b", "1f1b_mpmd"):
        # JAX's lockstep '1f1b' is the MPMD schedule at one chunk a stage
        # with the stage's own optimizer.
        from tpudp_torch.parallel.schedule import (make_pipeline_eval_step,
                                                   make_pipeline_train_step)

        mpmd = schedule == "1f1b_mpmd"
        interleave = options.pop("interleave", 1) if mpmd else 1
        shard_optimizer = (options.pop("shard_optimizer", True) if mpmd
                           else False)
        _no_extra(options, "pp")
        st, step = make_pipeline_train_step(
            model, optimizer, mesh, state, n_microbatches=n_microbatches,
            interleave=interleave, data_axis=data_axis, pipe_axis=pipe_axis,
            remat=remat, shard_optimizer=shard_optimizer)
        eval_step = make_pipeline_eval_step(
            model, mesh, st, n_microbatches=n_microbatches,
            interleave=interleave, data_axis=data_axis, pipe_axis=pipe_axis)
    else:
        _no_extra(options, "pp")
        st, step = make_pp_train_step(model, optimizer, mesh, state,
                                      n_microbatches=n_microbatches,
                                      data_axis=data_axis,
                                      pipe_axis=pipe_axis, remat=remat,
                                      schedule=schedule)
        eval_step = make_pp_eval_step(model, mesh, st,
                                      n_microbatches=n_microbatches,
                                      data_axis=data_axis,
                                      pipe_axis=pipe_axis)
    axes = (data_axis,) if data_axis is not None else ()
    return BuiltStrategy(st, step, eval_step, _rows_of(mesh, axes))


def _build_ep(model, optimizer, mesh, state, options):
    from tpudp_torch.parallel.expert import (EXPERT_AXIS, make_ep_eval_step,
                                             make_ep_train_step)

    data_axis = options.pop("data_axis", DATA_AXIS)
    expert_axis = options.pop("expert_axis", EXPERT_AXIS)
    aux_loss_coef = options.pop("aux_loss_coef", 0.01)
    _no_extra(options, "ep")
    st, step = make_ep_train_step(model, optimizer, mesh, state,
                                  data_axis=data_axis,
                                  expert_axis=expert_axis,
                                  aux_loss_coef=aux_loss_coef)
    eval_step = make_ep_eval_step(model, mesh, st, data_axis=data_axis,
                                  expert_axis=expert_axis)
    return BuiltStrategy(st, step, eval_step,
                         _rows_of(mesh, (data_axis, expert_axis)))


def _build_sp(model, optimizer, mesh, state, options):
    from tpudp_torch.parallel.sharded import (make_seq_parallel_train_step,
                                              make_sp_eval_step)

    data_axis = options.pop("data_axis", DATA_AXIS)
    seq_axis = options.pop("seq_axis", "seq")
    _no_extra(options, "sp")
    step = make_seq_parallel_train_step(model, optimizer, mesh,
                                        data_axis=data_axis,
                                        seq_axis=seq_axis)
    eval_step = make_sp_eval_step(model, mesh, data_axis=data_axis,
                                  seq_axis=seq_axis)
    _, nd, d = axis_of(mesh, data_axis)
    _, ns, s = axis_of(mesh, seq_axis)

    def shard_for(a):
        # token matrices shard (batch, seq); per-sample vectors batch only
        block = rows(a, d, nd)
        return rows(block, s, ns, dim=1) if a.ndim >= 2 else block

    return BuiltStrategy(state, step, eval_step, shard_for)


def _no_extra(options: dict, name: str) -> None:
    if options:
        raise TypeError(
            f"unknown option(s) for strategy {name!r}: {sorted(options)}")
