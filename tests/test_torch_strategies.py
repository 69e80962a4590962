"""Every sharded rung of the port through ``build_strategy`` and the
Trainer, on the CPU (the counterpart of ``tests/test_strategies.py``).

One gloo world of 4 ranks (``tests/torch_dp_worker.py`` job
``trainer``) drives tp, fsdp, zero1, pp, ep and sp through
``Trainer.fit`` with eval: the reference's lines reach the rung, the
eval is finite, and a checkpoint saved by the rung's ranks (rank 0
writing the gathered global tree) restores into a Trainer of other
weights equal leaf for leaf and steps again, and tp's restores into a
zero1 Trainer (resharded: each rank takes its shards of the global
tree).  The checkpoint's parameter names and shapes are the JAX rung's
state's (the stacked ``blocks`` for pp).  ``build_strategy``'s option errors and the
Trainer's refusals beside a strategy are JAX's.
"""

import jax
import numpy as np
import pytest

import torch_dp_worker as w
from tpudp.models.gpt2 import gpt2_small as jax_gpt2_small
from tpudp.parallel.pipeline import stack_block_params as jax_stack
from tpudp.train import init_state as jax_init_state
from tpudp.train import make_optimizer as jax_make_optimizer
from tpudp_torch import train
from tpudp_torch.mesh import MeshND
from tpudp_torch.models import gpt2
from tpudp_torch.parallel.tensor import gpt2_tp_rules
from tpudp_torch.strategy import STRATEGIES, build_strategy
from tpudp_torch.trainer import Trainer

RUNGS = list(w.TRAINER_RUNGS)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return w.run_world(tmp_path_factory.mktemp("trainer4"), 4, ["trainer"])


def _shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}"
        if isinstance(v, dict):
            out.update(_shapes(v, path))
        else:
            out[path] = tuple(np.shape(v))
    return out


def _jax_param_shapes(name):
    _, cfg, model_kw, _ = w.TRAINER_RUNGS[name]
    model_kw = {k: v for k, v in model_kw.items()
                if k not in ("attn_impl", "seq_axis", "expert_axis")}
    params = jax_init_state(jax_gpt2_small(**cfg, **model_kw),
                            jax_make_optimizer(),
                            input_shape=(1, 8)).params
    if name == "pp":
        params = jax_stack(params, cfg["num_layers"])
    return _shapes(jax.device_get(params))


@pytest.mark.parametrize("name", RUNGS)
def test_trainer_drives_rung(world4, name):
    r0 = world4[0]["trainer"][name]
    lines = r0["lines"]
    assert any(x.startswith("Training loss after 2 iterations")
               for x in lines)
    assert any(x.startswith("Training time after 1 epoch") for x in lines)
    assert any(x.startswith("Test set: Average loss") for x in lines)
    loss, acc = r0["eval"]
    assert np.isfinite(loss) and 0.0 <= acc <= 1.0
    windows = [x for x in r0["records"] if x["kind"] == "train_window"]
    assert len(windows) == 2 and all(np.isfinite(x["loss"])
                                     for x in windows)
    assert r0["metrics"]["step"] == 4

    def replicated(m):  # the spans' wall seconds are each rank's own
        return {**m, "spans": {k: v["count"] for k, v in m["spans"].items()}}

    for r in world4:  # every rank reads the same global loss and eval
        assert r["trainer"][name]["eval"] == r0["eval"]
        assert replicated(r["trainer"][name]["metrics"]) == replicated(
            r0["metrics"])
    # the restored state is the saved one, and it steps
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a), np.asarray(b)), r0["saved"], r0["restored"])
    assert np.isfinite(r0["loss2"])
    # rank 0 wrote JAX's global layout
    assert _shapes(r0["saved"]["params"]) == _jax_param_shapes(name)
    assert _shapes(r0["saved"]["opt_state"]["momentum"]) == \
        _jax_param_shapes(name)


def test_checkpoint_reshards_across_rungs(world4):
    """tp's checkpoint, restored into a zero1 Trainer of other weights,
    is the same global state (each rank takes its own shards)."""
    saved = world4[0]["trainer"]["tp"]["saved"]
    for r in world4:
        got = r["trainer"]["tp->zero1"]
        for key in ("params", "opt_state", "step", "loss_sum"):
            jax.tree.map(lambda a, b: np.testing.assert_array_equal(
                np.asarray(a), np.asarray(b)), saved[key], got[key])


def _fake_mesh(shape):
    return MeshND(shape=shape, rank=0, coords={a: 0 for a in shape},
                  groups={a: None for a in shape})


def _model_state(cfg=None):
    model = gpt2.GPT2(gpt2.GPT2Config(**(cfg or w.TP_CFG)))
    spec = train.make_optimizer()
    return model, spec, train.init_state(model, spec)


def test_build_strategy_option_errors():
    model, spec, state = _model_state()
    mesh = _fake_mesh({"data": 1, "model": 2})
    assert STRATEGIES == ("dp", "tp", "fsdp", "zero1", "pp", "ep", "sp")
    with pytest.raises(ValueError, match="built-in rung"):
        build_strategy("dp", model, spec, mesh, state)
    with pytest.raises(ValueError, match="needs a device mesh"):
        build_strategy("tp", model, spec, None, state)
    with pytest.raises(ValueError, match="unknown strategy"):
        build_strategy("zz", model, spec, mesh, state)
    with pytest.raises(KeyError):
        build_strategy("tp", model, spec, mesh, state)  # rules required
    with pytest.raises(KeyError):
        build_strategy("pp", model, spec, _fake_mesh({"pipe": 2}), state)
    for name, opts in (("tp", {"rules": gpt2_tp_rules(), "zz": 1}),
                       ("fsdp", {"min_size": 1, "zz": 1}),
                       ("zero1", {"zz": 1}),
                       ("pp", {"n_microbatches": 2, "zz": 1}),
                       ("ep", {"zz": 1}), ("sp", {"zz": 1})):
        with pytest.raises(TypeError, match="unknown option"):
            build_strategy(name, model, spec, mesh, state, **opts)
    with pytest.raises(ValueError, match="attn_impl='ring'"):
        build_strategy("sp", model, spec, _fake_mesh({"data": 1, "seq": 2}),
                       state)


def test_trainer_refuses_dp_options_beside_a_strategy():
    model, _, _ = _model_state()
    mesh = _fake_mesh({"data": 2})
    for kwargs, match in (({"timing_mode": "split"}, "split"),
                          ({"grad_accum": 2}, "grad_accum"),
                          ({"remat": True}, "remat is a DP-rung option"),
                          ({"loss_chunk": 8}, "loss_chunk"),
                          ({"sync": "ring"}, "DP-rung options"),
                          ({"spmd_mode": "gspmd"}, "DP-rung options"),
                          ({"sync": "none", "compress": "int8_ef"},
                           "compress")):
        with pytest.raises(ValueError, match=match):
            Trainer(model, mesh, strategy="fsdp", **kwargs)
    with pytest.raises(ValueError, match="unknown strategy"):
        Trainer(model, mesh, strategy="zz")
    with pytest.raises(ValueError, match="needs a device mesh"):
        Trainer(model, None, strategy="fsdp")
