"""The port's sync ladder and all-reduce schedules
(``tpudp_torch.parallel.sync``, ``.ring``, ``.compress``) over gloo on
the CPU, against numpy and the JAX package's ``shard_map`` versions.

Worlds of 2, 3 and 4 ranks (``tests/torch_dp_worker.py``, one spawn per
world for the module) run every rung on per-rank gradients of awkward
sizes drawn from a numpy seed; the JAX rungs run on the same numbers
over ``make_mesh(n)``.  Tolerances are ``tests/test_sync.py``'s: exact
rungs rtol 1e-5 / atol 1e-6, bf16 2e-2, int8 within its grid bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_dp_worker as w
from tpudp.mesh import DATA_AXIS, make_mesh as jax_make_mesh
from tpudp.parallel import sync as jax_sync
from tpudp.parallel.compress import int8_ef_allreduce
from tpudp_torch.parallel import ring, sync

EXACT = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=2e-2, atol=2e-2)
WORLDS = (2, 3, 4)
SYNCED = [r for r in w.RUNGS if r != "none"]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {n: w.run_world(tmp_path_factory.mktemp(f"sync{n}"), n, ["sync"])
            for n in WORLDS}


@pytest.fixture(scope="module")
def jax_outputs():
    """JAX's rungs on the same per-device gradients, worlds 2 and 4."""
    out = {}
    for n in (2, 4):
        mesh = jax_make_mesh(n)
        tree = w.grad_tree(n)
        sharded = jax.device_put(tree, NamedSharding(mesh, P(DATA_AXIS)))
        for name in SYNCED:
            fn = jax.jit(jax.shard_map(
                lambda t, f=jax_sync.SYNC_STRATEGIES[name]: f(
                    [g[0] for g in t], DATA_AXIS),
                mesh=mesh, in_specs=P(DATA_AXIS), out_specs=P(),
                check_vma=False))
            out[n, name] = [np.asarray(g) for g in fn(sharded)]
    return out


def _tolerance(name, n):
    if name == "allreduce_bf16":
        return BF16
    if name == "allreduce_int8":
        flat_max = max(float(np.abs(g).max()) for g in w.grad_tree(n))
        return dict(rtol=0, atol=flat_max / (2.0 * (127 // n)) + 1e-6)
    return EXACT


CASES = [(n, name) for n in WORLDS for name in SYNCED]


@pytest.mark.parametrize("world,name", CASES,
                         ids=[f"w{n}-{r}" for n, r in CASES])
def test_rung_leaves_the_mean_on_every_rank(worlds, world, name):
    """Every rank ends with the mean gradient (dtype and shape kept), the
    same bits on each."""
    expected = [g.mean(axis=0) for g in w.grad_tree(world)]
    ranks = [r["sync"][name] for r in worlds[world]]
    for got, want in zip(ranks[0], expected):
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want,
                                   **_tolerance(name, world))
    for other in ranks[1:]:
        assert all(torch.equal(a, b) for a, b in zip(ranks[0], other))


JAX_CASES = [(n, name) for n in (2, 4) for name in SYNCED]


@pytest.mark.parametrize("world,name", JAX_CASES,
                         ids=[f"w{n}-{r}" for n, r in JAX_CASES])
def test_rung_matches_jax(worlds, jax_outputs, world, name):
    """The port's rung against the JAX rung on the same gradients."""
    tol = BF16 if name == "allreduce_bf16" else EXACT
    for got, want in zip(worlds[world][0]["sync"][name],
                         jax_outputs[world, name]):
        np.testing.assert_allclose(got.numpy(), want.reshape(got.shape),
                                   **tol)


@pytest.mark.parametrize("world", WORLDS)
def test_none_leaves_each_ranks_gradients(worlds, world):
    tree = w.grad_tree(world)
    for rank, res in enumerate(worlds[world]):
        for got, g in zip(res["sync"]["none"], tree):
            np.testing.assert_array_equal(got.numpy(), g[rank])


def test_hd_at_world_3_takes_the_ring(worlds):
    """Halving-doubling needs a power-of-two world: at 3 it warns and runs
    the single-direction ring, bit for bit."""
    for res in worlds[3]:
        s = res["sync"]
        assert any("power-of-two" in m for m in s["allreduce_hd:warnings"])
        assert all(torch.equal(a, b) for a, b in zip(s["allreduce_hd"],
                                                     s["ring"]))
    assert not worlds[4][0]["sync"]["allreduce_hd:warnings"]


@pytest.mark.parametrize("world", WORLDS)
def test_int8_ring_partial_sums_never_wrap(worlds, world):
    """n ranks at the +/-(127 // n) clip with one sign sum to at most 127:
    the int8 ring's total is exact."""
    for res in worlds[world]:
        got = res["sync"]["int8_clip_sum"]
        assert got.dtype == torch.int8
        assert (got == world * (127 // world)).all()
        np.testing.assert_array_equal(res["sync"]["ring_int"].numpy(),
                                      np.arange(23) * sum(range(1,
                                                            world + 1)))


@pytest.mark.parametrize("world", [2, 4])
def test_int8_quantizer_matches_jax(worlds, world):
    """The headroom quantizer's grid equals JAX's on the same buffer, and
    its tick (shared by the MAX all-reduce) is JAX's to one ulp."""
    from tpudp.parallel.ring import int8_headroom_quantize

    mesh = jax_make_mesh(world)
    flat = np.stack([np.concatenate([g[r].reshape(-1)
                                     for g in w.grad_tree(world)])
                     for r in range(world)])
    fn = jax.jit(jax.shard_map(
        lambda f: int8_headroom_quantize(f[0], DATA_AXIS), mesh=mesh,
        in_specs=P(DATA_AXIS), out_specs=(P(DATA_AXIS), P()),
        check_vma=False))
    q, unit = fn(jax.device_put(flat, NamedSharding(mesh, P(DATA_AXIS))))
    q = np.asarray(q).reshape(world, -1)
    for r, res in enumerate(worlds[world]):
        got_q, got_unit = res["sync"]["int8_quantize"]
        assert got_q.dtype == torch.int8
        assert abs(int(got_q.abs().max())) <= 127 // world
        np.testing.assert_array_equal(got_q.numpy(), q[r])
        # One float32 ulp: XLA may divide by qmax as a product with its
        # reciprocal.
        np.testing.assert_allclose(float(got_unit), float(unit),
                                   rtol=2 ** -23, atol=0)


@pytest.mark.parametrize("world", [2, 4])
def test_error_feedback_matches_jax(worlds, world):
    """int8 error feedback on constant gradients for 12 steps: the summed
    updates stay within one step's quantization of 12 x the true mean
    (JAX's bound in tests/test_compress.py) and equal the JAX
    transform's, rank by rank; each rank keeps its own residual."""
    tree = w.grad_tree(world)
    mesh = jax_make_mesh(world)
    tx = int8_ef_allreduce(num_devices=world)
    params = [jnp.zeros(g.shape[1:], jnp.float32) for g in tree]
    st = tx.init(params)
    spec = jax.tree.map(lambda _: P(DATA_AXIS), st)
    step = jax.jit(jax.shard_map(
        lambda g, s: tx.update([a[0] for a in g], s), mesh=mesh,
        in_specs=(P(DATA_AXIS), spec), out_specs=(P(), spec),
        check_vma=False))
    sh = NamedSharding(mesh, P(DATA_AXIS))
    g = jax.device_put(tree, sh)
    st = jax.device_put(st, jax.tree.map(lambda _: sh, st))
    acc = [np.zeros(a.shape[1:], np.float32) for a in tree]
    for _ in range(w.EF_STEPS):
        upd, st = step(g, st)
        acc = [a + np.asarray(u).reshape(a.shape) for a, u in zip(acc, upd)]
    bound = max(float(np.abs(a).max()) for a in tree) * 2.0 / (127 // world)
    for r, res in enumerate(worlds[world]):
        got = res["sync"]["ef_sum"]
        for a, want, t in zip(got, acc, tree):
            np.testing.assert_allclose(a.numpy(),
                                       w.EF_STEPS * t.mean(axis=0),
                                       atol=bound)
            np.testing.assert_allclose(a.numpy(), want, rtol=1e-5, atol=1e-5)
        for e, want in zip(res["sync"]["ef_error"], st.error):
            np.testing.assert_allclose(e.numpy(),
                                       np.asarray(want)[r].reshape(e.shape),
                                       rtol=1e-5, atol=1e-6)
    errs = [torch.cat([e.reshape(-1) for e in res["sync"]["ef_error"]])
            for res in worlds[world]]
    assert not torch.equal(errs[0], errs[1])


def test_ladder_names_match_jax():
    assert sorted(sync.SYNC_STRATEGIES) == sorted(jax_sync.SYNC_STRATEGIES)
    assert sync.EXAMPLE_SYNC_CHOICES == jax_sync.EXAMPLE_SYNC_CHOICES
    assert sync.RING_DIRECTION == jax_sync.RING_DIRECTION
    assert sync.sync_ring_uni is sync.sync_ring
    with pytest.raises(ValueError, match="unknown sync strategy"):
        sync.get_sync("nccl")


@pytest.fixture
def world1():
    """A gloo group of this process alone, taken down after the test."""
    from tpudp_torch.mesh import initialize_distributed

    assert not dist.is_initialized()
    initialize_distributed("cpu")
    yield
    dist.destroy_process_group()


def test_world_1_semantics(world1):
    """At world size 1: bf16 still rounds the gradients to bfloat16 (so it
    is not 'none'), int8 returns them untouched, the manual schedules
    return their input, and every exact rung gives the gradients back."""
    g = [torch.tensor([1.0 + 2 ** -10, -3.3]), torch.randn(5, 3)]
    bf = sync.get_sync("allreduce_bf16")(g, None)
    assert torch.equal(bf[0], torch.tensor([1.0, -3.296875]))
    assert sync.get_sync("allreduce_int8")(g, None) is g
    for fn in (ring.ring_all_reduce, ring.hd_all_reduce,
               ring.a2a_all_reduce):
        assert fn(g[1], None) is g[1]
    for name in ("coordinator", "allreduce", "ring", "ring_bidir",
                 "allreduce_hd", "allreduce_a2a", "auto"):
        for got, want in zip(sync.get_sync(name)(g, None), g):
            assert torch.equal(got, want), name


def test_int8_rejects_worlds_past_127(monkeypatch):
    """127 // n == 0 would make the grid tick a division by zero."""
    monkeypatch.setattr(ring, "_world", lambda group: (128, 0))
    with pytest.raises(ValueError, match="at most 127"):
        ring.int8_headroom_quantize(torch.ones(4), None)


def test_flatten_tree_round_trips():
    ts = [torch.randn(3, 4), torch.arange(5, dtype=torch.float64),
          torch.randn(2, 1, 2).to(torch.bfloat16)]
    flat, unflatten = ring.flatten_tree(ts, dtype=torch.float32)
    assert flat.shape == (21,) and flat.dtype == torch.float32
    back = unflatten(flat)
    assert [b.dtype for b in back] == [t.dtype for t in ts]
    assert all(torch.equal(b, t) for b, t in zip(back, ts))
    assert unflatten(flat, cast=False)[2].dtype == torch.float32


def test_step_takes_a_sync_function_and_exposes_ddp(world1):
    """A train step runs a ``(grads, group) -> grads`` function as its
    rung (here the all-reduce rung, wrapped to count its calls) with the
    named rung's result; ``step.ddp`` is the DDP wrapper of 'auto', whose
    comm hooks then see every step's buckets."""
    from torch.distributed.algorithms.ddp_comm_hooks import default_hooks

    from tpudp_torch import train
    from tpudp_torch.mesh import make_mesh
    from tpudp_torch.models import vgg

    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.normal(size=(4, 32, 32, 3)).astype(np.float32))
    y = torch.as_tensor(rng.integers(0, 10, 4))
    calls = []

    def counted(grads, group):
        calls.append(len(grads))
        return sync.sync_allreduce(grads, group)

    def hooked(state, bucket):
        calls.append("bucket")
        return default_hooks.allreduce_hook(state, bucket)

    states = {}
    for rung in ("allreduce", counted, "auto"):
        model = vgg.build(w.CFG, 0, "cpu")
        spec = train.make_optimizer()
        state = train.init_state(model, spec, make_mesh())
        step = train.make_train_step(model, spec, make_mesh(), rung)
        assert (step.ddp is not None) == (rung == "auto")
        if rung == "auto":
            step.ddp.register_comm_hook(None, hooked)
        for _ in range(2):
            state, _ = step(state, x, y)
        states[rung if isinstance(rung, str) else "counted"] = \
            model.state_dict()
    n_params = len(list(model.parameters()))
    assert calls[:2] == [n_params, n_params]
    assert len(calls) > 2 and set(calls[2:]) == {"bucket"}
    for name, value in states["allreduce"].items():
        for other in ("counted", "auto"):
            assert torch.equal(states[other][name], value), (other, name)
