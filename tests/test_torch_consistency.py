"""The port's replica-consistency verification
(``tpudp_torch.utils.consistency``, ``Trainer(verify_replicas=True)``,
``--verify-replicas``) held to ``tpudp.utils.consistency`` on the CPU —
the counterpart of ``tests/test_consistency.py``.

In JAX a replica is a device's shard of one array; in the port it is a
rank's tensor.  The same trees go through JAX on ``make_mesh(2)`` (each
device given its own buffer of an array that claims replication) and
through the port on a gloo world of 2 (each rank its own tensor): one
spawn of ``tests/torch_dp_worker.py``'s ``consistency`` job (~7 s).  The
Trainer's post-epoch check runs the ``allreduce`` rung (passes) and the
``none`` rung (each rank applies its own gradient: raises), as JAX's
test does on the narrow VGG.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_dp_worker as w
from tpudp.data.loader import DataLoader as JaxLoader
from tpudp.mesh import make_mesh as jax_make_mesh
from tpudp.models.vgg import VGG as JaxVGG
from tpudp.train import Trainer as JaxTrainer
from tpudp.train import init_state as jax_init_state
from tpudp.train import make_optimizer as jax_make_optimizer
from tpudp.utils import consistency as jc
from tpudp_torch import train
from tpudp_torch.data import DataLoader, load_cifar10
from tpudp_torch.trainer import Trainer
from tpudp_torch.utils import consistency as pc


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return w.run_world(tmp_path_factory.mktemp("consistency"), 2,
                       ["consistency"])


def _replicated_from(values, mesh):
    """An array claiming replication while each device holds its own
    buffer (JAX's test helper)."""
    return jax.make_array_from_single_device_arrays(
        values[0].shape, NamedSharding(mesh, P()),
        [jax.device_put(v, d) for v, d in zip(values, mesh.devices.flat)])


def _jax_outcome(fn):
    try:
        return ("ok", fn())
    except jc.ReplicaDivergenceError as e:
        return ("raised", str(e))


@pytest.fixture(scope="module")
def jax_results():
    mesh = jax_make_mesh(2)
    same = {"w": _replicated_from([jnp.ones((4, 3))] * 2, mesh),
            "scalar": 1.5,
            "b": _replicated_from([jnp.arange(5.0)] * 2, mesh)}
    div = {"Conv_0": {"kernel": _replicated_from(
        [jnp.ones((4, 3)), jnp.ones((4, 3)) * 1.001], mesh)}}
    rows = jnp.arange(12.0).reshape(4, 3)
    permuted = {"Conv_0": {"kernel": _replicated_from(
        [rows, rows[::-1]], mesh)}}
    return {"same": _jax_outcome(lambda: jc.verify_replicas(same)),
            "div": _jax_outcome(lambda: jc.verify_replicas(div)),
            "permuted": _jax_outcome(lambda: jc.verify_replicas(permuted)),
            "div_atol": _jax_outcome(
                lambda: jc.verify_replicas(div, atol=0.01))}


@pytest.mark.parametrize("case", ["same", "div", "div_atol", "permuted"])
def test_verify_replicas_outcomes_equal_jax(world2, jax_results, case):
    """Consistent replicas pass with JAX's count of compared leaves (the
    scalar is skipped), a replica 1.001x off raises naming the leaf in
    both, and a loose ``atol`` tolerates it.  A replica holding the same
    values in another order (its rows reversed) raises too, with JAX's
    worst |diff|: the leaves' bytes are compared, not a sum that
    ignores order."""
    want = jax_results[case]
    for rank in world2:
        got = rank["consistency"][case]
        assert got[0] == want[0]
        if got[0] == "ok":
            assert got[1] == want[1]
        else:
            assert re.search(r"Conv_0.*kernel", got[1])
            assert re.search(r"Conv_0.*kernel", want[1])
            diff = re.search(r"max \|diff\|=\S+", want[1]).group(0)
            assert diff in got[1]
            if case == "div":
                assert "max |diff|=1.000e-03" in got[1]


def test_verify_across_processes_and_fingerprint(world2):
    """The cheap probe: equal trees pass, a rank whose tree differs makes
    every rank raise; the fingerprint is JAX's (sum, sum of squares,
    size) of the same values."""
    same = {"w": jnp.ones((4, 3)), "scalar": 1.5, "b": jnp.arange(5.0)}
    for rank in world2:
        c = rank["consistency"]
        assert c["across_same"] == ("ok", None)
        assert c["across_div"][0] == "raised"
        assert "process 1 fingerprint" in c["across_div"][1]
        np.testing.assert_array_equal(c["fp_same"], jc.fingerprint(same))
    assert world2[0]["consistency"]["fp_div"] != \
        world2[1]["consistency"]["fp_div"]


def test_trainer_detects_sync_none_desync(world2, tmp_path):
    """End to end: the ``allreduce`` rung passes the post-epoch check and
    logs JAX's line with JAX's count of replicated leaves (the VGG's
    parameters and BatchNorm statistics); the ``none`` rung (each rank
    applies its own gradient) raises ReplicaDivergenceError, as JAX's
    Trainer does.  JAX's single process logs ``(N replicated leaves
    bit-identical)``; the port's ranks are processes, so it adds
    ``cross-process fingerprints equal`` as JAX's multi-host line does."""
    lines = []
    train_set, _, _ = load_cifar10(str(tmp_path / "none"),
                                   synthetic_train_size=16,
                                   synthetic_test_size=8)
    for sync in ("allreduce", "none"):
        jt = JaxTrainer(JaxVGG(cfg=w.CFG), jax_make_mesh(2), sync,
                        learning_rate=0.1, log_every=1, log_fn=lines.append,
                        verify_replicas=True)
        try:
            jt.fit(JaxLoader(train_set, 16, train=True, seed=1), epochs=1)
            jax_none = None
        except jc.ReplicaDivergenceError as e:
            jax_none = str(e)
    jline = next(x for x in lines if "replica consistency OK" in x)
    n = re.search(r"\((\d+) replicated", jline).group(1)
    assert jax_none is not None
    for rank in world2:
        c = rank["consistency"]
        assert c["allreduce"] == ("ok", [
            f"[tpudp] replica consistency OK ({n} replicated leaves "
            "bit-identical, cross-process fingerprints equal)"])
        assert c["none"][0] == "raised"
        assert "replicas diverged at leaf ['params']" in c["none"][1]


def test_single_rank_has_nothing_to_check(tmp_path):
    """At one rank there is no second replica: the check passes and says
    so in JAX's words (JAX's single device alike)."""
    lines, jlines = [], []
    train_set, _, _ = load_cifar10(str(tmp_path / "none"),
                                   synthetic_train_size=16,
                                   synthetic_test_size=8)
    Trainer(w.bn_model("vgg"), log_every=1, log_fn=lines.append,
            verify_replicas=True).fit(
        DataLoader(train_set, 16, train=True, seed=1), epochs=1)
    JaxTrainer(JaxVGG(cfg=w.CFG), None, log_every=1, log_fn=jlines.append,
               verify_replicas=True).fit(
        JaxLoader(train_set, 16, train=True, seed=1), epochs=1)
    want = [x for x in jlines if "replica consistency" in x]
    assert want == [x for x in lines if "replica consistency" in x]
    assert want == ["[tpudp] replica consistency: nothing to check (no "
                    "leaf has >1 replica on this mesh)"]
    assert pc.verify_replicas({"w": torch.ones(3)}) == 0


def test_fingerprint_coverage_has_no_holes():
    """JAX's leaf-coverage regression on the port's TrainState (after one
    step, once torch has made the momentum): every leaf is ``included``
    or ``excluded_sharded`` — nothing the corruption detector cannot
    see — and the step, the fingerprint slot, the parameters and the
    optimizer state are covered, as in JAX's state."""
    spec = train.make_optimizer(**w.SGD)
    model = w.bn_model("vgg")
    state = train.init_state(model, spec, track_sdc=True)
    x, y = w.vgg_batches(1)[0]
    state, _ = train.make_train_step(model, spec)(
        state, torch.as_tensor(x), torch.as_tensor(y))
    cov = pc.fingerprint_coverage(pc.state_tree(state))
    assert cov["excluded_non_array"] == []
    assert cov["excluded_sharded"] == []
    for needle in ("['step']", "['sdc_fp']", "['params']", "['opt_state']"):
        assert any(p.startswith(needle) for p in cov["included"]), needle
    jstate = jax_init_state(JaxVGG(cfg=w.CFG), jax_make_optimizer(),
                            track_sdc=True)
    jcov = jc.fingerprint_coverage(jstate)
    assert jcov["excluded_non_array"] == []
    # the same parameter and momentum leaves (optax's chain adds no
    # per-parameter leaf beyond the trace)
    count = lambda c, key: sum(key in p for p in c["included"])  # noqa
    assert count(cov, "['params']") == count(jcov, ".params")
    assert count(cov, "['opt_state']") == count(jcov, ".opt_state")
    tree = {"dev": torch.ones(4), "host": np.ones(4)}
    cov = pc.fingerprint_coverage(tree)
    assert cov["included"] == ["['dev']"]
    assert cov["excluded_non_array"] == ["['host']"]


def test_zero1_shards_are_excluded_sharded(world2):
    """zero1 at 2 ranks: its parameters, whole on every rank, are
    included (and verify across the ranks); the momentum shards each
    rank alone holds are ``excluded_sharded``, JAX's rule for the 1/N
    optimizer state."""
    for rank in world2:
        c = rank["consistency"]
        cov = c["zero1_coverage"]
        assert cov["excluded_non_array"] == []
        assert any("['params']" in p for p in cov["included"])
        assert not any("['params']" in p for p in cov["excluded_sharded"])
        assert any("['opt_state']" in p for p in cov["excluded_sharded"])
        assert c["zero1_verify"][0] == "ok" and c["zero1_verify"][1] > 0
