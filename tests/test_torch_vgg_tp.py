"""Tensor parallelism of the VGG by ``vgg_tp_rules``
(``tpudp_torch.parallel.sharded.TPVGG``) in one process, on the CPU.

The multi-rank trajectories — meshes (2, 2) and (1, 4) against JAX's
``make_tp_train_step`` with the same rules — run in the gloo world of
``tests/test_torch_tensor_parallel.py`` (job ``vgg_tp``).  Here: the rung
on a one-rank mesh against JAX's on one device and against the port's
single-device step, each rank's slice of a full VGG-11 at meshes whose
other ranks are not there (the layout is local: no collective is
called), the placements against JAX's rule resolution, every model
under every table accepted as JAX accepts it, and ResNet and ViT on one
rank against JAX on one device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_worker as w
from tpudp.mesh import make_mesh_nd as jax_make_mesh_nd
from tpudp.models.vgg import VGG as JaxVGG
from tpudp.parallel import tensor as jax_tensor
from tpudp.train import init_state as jax_init_state
from tpudp.train import make_optimizer as jax_make_optimizer
from tpudp.train import make_tp_train_step as jax_tp_step
from tpudp_torch import train
from tpudp_torch.mesh import MeshND
from tpudp_torch.models import gpt2, llama, resnet, vgg, vit
from tpudp_torch.parallel import sharded, tensor
from tpudp_torch.strategy import build_strategy
from tpudp_torch.trainer import Trainer


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite's workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fake_mesh(shape, coords=None):
    """A mesh of ``shape`` seen from one rank (``coords``) whose axes have
    no process group: enough to build a rung's layout, not to step."""
    return MeshND(shape=shape, rank=0,
                  coords=coords or {a: 0 for a in shape},
                  groups={a: None for a in shape})


def _narrow():
    model = vgg.VGG(w.CFG)
    model.load_state_dict(vgg.params_from_jax(*w.vgg_init()))
    return model


def test_one_rank_mesh_matches_jax_and_the_plain_step():
    """On a (1, 1) mesh the rung is the single-device step: 3 SGD steps'
    losses and parameters equal the port's ``make_train_step`` (1e-6,
    float32, the same ops) and JAX's TP step on one device (1e-5, as
    tests/test_torch_dp_train.py holds this model)."""
    spec = train.make_optimizer(**w.SGD)
    model = _narrow()
    built = build_strategy("tp", model, spec,
                           _fake_mesh({"data": 1, "model": 1}),
                           train.init_state(model, spec),
                           rules=tensor.vgg_tp_rules())
    plain = _narrow()
    pstate = train.init_state(plain, spec)
    pstep = train.make_train_step(plain, spec)
    st, losses, plain_losses = built.state, [], []
    for x, y in w.vgg_batches(1):
        x, y = torch.as_tensor(x), torch.as_tensor(y)
        st, loss = built.train_step(st, x, y)
        pstate, ploss = pstep(pstate, x, y)
        losses.append(float(loss))
        plain_losses.append(float(ploss))
    np.testing.assert_allclose(losses, plain_losses, rtol=1e-6)
    got = train.state_to_jax(st)
    want = train.state_to_jax(pstate)
    for key in ("params", "batch_stats"):
        jax.tree.map(lambda a, b: np.testing.assert_allclose(
            a.numpy(), b.numpy(), atol=1e-6, rtol=1e-6), got[key],
            want[key])

    jmodel = JaxVGG(cfg=w.CFG)
    tx = jax_make_optimizer(**w.SGD)
    params, stats = w.vgg_init()
    jstate = jax_init_state(jmodel, tx).replace(
        params=jax.tree.map(jnp.asarray, params),
        batch_stats=jax.tree.map(jnp.asarray, stats))
    jstate = jstate.replace(opt_state=tx.init(jstate.params))
    mesh = jax_make_mesh_nd({"data": 1, "model": 1},
                            devices=jax.devices()[:1])
    jstate, jstep = jax_tp_step(jmodel, tx, mesh, jstate,
                                jax_tensor.vgg_tp_rules(), donate=False)
    jlosses = []
    for x, y in w.vgg_batches(1):
        jstate, loss = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
        jlosses.append(float(loss))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        b.numpy(), np.asarray(a), atol=1e-5, rtol=1e-5),
        jax.device_get(jstate.params), got["params"])


@pytest.mark.parametrize("n,r", [(2, 1), (4, 3)])
def test_rank_holds_its_channel_slice_of_vgg11(n, r):
    """Rank ``r`` of ``model = n`` holds output channels ``[r c/n, (r+1)
    c/n)`` of every convolution, with their BatchNorm parameters and
    running statistics, and whole input channels; the 10-class
    classifier splits at 2 and is whole at 4 (JAX's fallback)."""
    model = vgg.build(vgg.CONFIGS["VGG11"], seed=3, device="cpu")
    with torch.no_grad():
        for bn in model.bns:
            bn.running_mean.normal_()
    spec = train.make_optimizer()
    built = build_strategy(
        "tp", model, spec,
        _fake_mesh({"data": 2, "model": n}, {"data": 1, "model": r}),
        train.init_state(model, spec), rules=tensor.vgg_tp_rules())
    local, full = built.state.model.state_dict(), model.state_dict()
    assert isinstance(built.state.model, sharded.TPVGG)
    for i, c in enumerate((64, 128, 256, 256, 512, 512, 512, 512)):
        k = c // n
        for name in (f"convs.{i}.weight", f"convs.{i}.bias",
                     f"bns.{i}.weight", f"bns.{i}.running_mean"):
            torch.testing.assert_close(local[name],
                                       full[name][r * k:(r + 1) * k])
        assert local[f"convs.{i}.weight"].shape[1] == \
            full[f"convs.{i}.weight"].shape[1]
    if n == 2:
        torch.testing.assert_close(local["fc.weight"],
                                   full["fc.weight"][5 * r:5 * (r + 1)])
    else:
        torch.testing.assert_close(local["fc.weight"], full["fc.weight"])
    assert built.state.model.split == [True] * 8
    assert built.state.model.fc_split == (n == 2)


def test_placements_match_jax_rule_resolution(mesh8):
    """``resolve_state_shardings`` over a VGG-11 state reads JAX's
    placements (``tree_shardings`` on a (2, 4) mesh): every conv
    kernel's output channels and BatchNorm's parameters over ``model``,
    the classifier replicated (10 % 4), the momentum as its parameter."""
    model = vgg.build(vgg.CONFIGS["VGG11"], seed=3, device="cpu")
    state = train.init_state(model, train.make_optimizer())
    got = train.resolve_state_shardings(
        state, _fake_mesh({"data": 2, "model": 4}), tensor.vgg_tp_rules())
    params, _ = vgg.random_params(vgg.CONFIGS["VGG11"], 3)
    mesh = jax_make_mesh_nd({"data": 2, "model": 4})
    want = jax_tensor.tree_shardings(
        {"params": jax.tree.map(jnp.asarray, params)}, mesh,
        jax_tensor.vgg_tp_rules())
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert flat
    for path, sh in flat:
        key = "/".join(str(getattr(p, "key", p)) for p in path)
        spec = tuple(sh.spec)
        dim = next((i for i, a in enumerate(spec) if a is not None), None)
        assert got[key] == (None if dim is None else (dim, "model")), key
    assert got["params/Conv_0/kernel"] == (3, "model")
    assert got["params/Dense_0/kernel"] is None
    assert got["opt_state/momentum/BatchNorm_2/scale"] == (0, "model")


def test_models_tp_does_not_take_are_refused_by_name():
    """Nothing JAX's ``make_tp_train_step`` accepts raises: a ResNet and
    a ViT under each table (the ResNet's convolutions split under
    ``vgg_tp_rules``, the ViT's Megatron sections under
    ``gpt2_tp_rules``, replicated under the others) and a model handed
    another family's table, through the step, ``build_strategy`` and the
    Trainer.  A table splitting part of a section the port splits
    together is refused naming the section."""
    spec = train.make_optimizer()
    mesh = _fake_mesh({"data": 1, "model": 2})
    net = resnet.ResNet((1, 1), 10, 16)
    tiny_vit = vit.ViT(vit.ViTConfig(**w.VIT_CFG))
    for model, split_by, module in ((net, "vgg", sharded.TPResNet),
                                    (tiny_vit, "gpt2", sharded.TPViT)):
        for table in ("vgg", "gpt2", "llama"):
            rules = getattr(tensor, f"{table}_tp_rules")()
            built, _ = sharded.make_tp_train_step(
                model, spec, mesh, train.init_state(model, spec), rules)
            assert isinstance(built.model, module if table == split_by
                              else type(model))
        built = build_strategy("tp", model, spec, mesh,
                               train.init_state(model, spec),
                               rules=getattr(tensor,
                                             f"{split_by}_tp_rules")())
        assert isinstance(built.state.model, module)
        trainer = Trainer(model, mesh, strategy="tp",
                          strategy_options={"rules": tensor.vgg_tp_rules()},
                          log_fn=lambda s: None)
        assert trainer.strategy is not None
    with pytest.raises(ValueError, match="b0.c1"):
        sharded.make_tp_train_step(
            net, spec, mesh, train.init_state(net, spec),
            ((r"BottleneckBlock_0/Conv_1/kernel",
              (None, None, None, "model")),))
    lm = llama.Llama(llama.LlamaConfig(vocab_size=64, max_seq_len=32,
                                       num_layers=1, num_heads=4,
                                       d_model=32))
    lm_gpt2 = gpt2.GPT2(gpt2.GPT2Config(**w.TP_CFG))
    for model in (lm, lm_gpt2, _narrow()):
        built, _ = sharded.make_tp_train_step(
            model, spec, mesh, train.init_state(model, spec),
            tensor.vgg_tp_rules() if not isinstance(model, vgg.VGG)
            else tensor.llama_tp_rules())
        assert built.model is model
    # the VGG table under its model's own axis name
    model = _narrow()
    built = build_strategy("tp", model, spec,
                           _fake_mesh({"data": 1, "tensor": 2}),
                           train.init_state(model, spec),
                           rules=tensor.vgg_tp_rules("tensor"))
    assert built.state.model.convs[1].weight.shape[0] == 8


@pytest.mark.parametrize("family", ["resnet", "vit"])
def test_one_rank_resnet_vit_tp_matches_jax(family):
    """On a (1, 1) mesh ResNet under ``vgg_tp_rules`` and ViT under
    ``gpt2_tp_rules`` run their hand-written modules with nothing split:
    3 SGD steps' losses and parameters equal JAX's tp step on one device
    (1e-5, float32)."""
    from tpudp.models.resnet import ResNet as JaxResNet
    from tpudp.models.vit import ViT as JaxViT
    from tpudp.models.vit import ViTConfig as JaxViTConfig

    spec = train.make_optimizer(**w.SGD)
    tx = jax_make_optimizer(**w.SGD)
    if family == "resnet":
        model = resnet.ResNet(w.RESNET_STAGES, 10, w.RESNET_WIDTH)
        params, stats = w.resnet_init()
        model.load_state_dict(resnet.params_from_jax(params, stats))
        batches, table = w.vgg_batches(1), "vgg"
        jmodel = JaxResNet(stage_sizes=w.RESNET_STAGES, num_classes=10,
                           width=w.RESNET_WIDTH)
        jstate = jax_init_state(jmodel, tx).replace(
            batch_stats=jax.tree.map(jnp.asarray, stats))
    else:
        model, params = w.vit_model(), w.vit_tree()
        batches, table = w.vit_batches(1), "gpt2"
        jmodel = JaxViT(JaxViTConfig(**w.VIT_CFG))
        jstate = jax_init_state(jmodel, tx, input_shape=(1, 16, 16, 3))
    rules = getattr(tensor, f"{table}_tp_rules")()
    built = build_strategy("tp", model, spec,
                           _fake_mesh({"data": 1, "model": 1}),
                           train.init_state(model, spec), rules=rules)
    assert type(built.state.model).__name__ == (
        "TPResNet" if family == "resnet" else "TPViT")
    st, losses = built.state, []
    for x, y in batches:
        st, loss = built.train_step(st, torch.as_tensor(x),
                                    torch.as_tensor(y))
        losses.append(float(loss))
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jstate.replace(params=jparams, opt_state=tx.init(jparams))
    mesh = jax_make_mesh_nd({"data": 1, "model": 1},
                            devices=jax.devices()[:1])
    jstate, jstep = jax_tp_step(
        jmodel, tx, mesh, jstate,
        getattr(jax_tensor, f"{table}_tp_rules")(), donate=False)
    jlosses = []
    for x, y in batches:
        jstate, loss = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
        jlosses.append(float(loss))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        b.numpy(), np.asarray(a), atol=1e-5, rtol=1e-5),
        jax.device_get(jstate.params), train.state_to_jax(st)["params"])
