"""The port's silent-data-corruption defense (``tpudp_torch.sdc``, the
supervisor's ``sdc_check_every``), the fingerprint and grad-norm slots
beside every rung, and the elastic relaunch, held to the JAX package on
the CPU — the counterpart of ``tests/test_sdc.py`` and
``tests/test_elastic_resume.py``.

The primitives run in this process on the same numpy bytes through both
packages (bit for bit).  The graded response runs JAX's matrix — clean,
a one-shot params flip, a one-shot momentum flip, a persistent flip, the
two-replica tie — through JAX's Trainer on ``make_mesh(4)`` (and
``make_mesh(2)``) and through the port's Trainer on gloo worlds of 4
(and 2) ranks (``tests/torch_dp_worker.py``'s ``sdc`` job: one spawn a
world, the narrow VGG, global batches of 16, windows of 2, a check
every 2 steps).  A replica is a device in JAX's single process
(``p0/d<i>``) and a rank in the port (``p<i>``): the verdicts, counters,
events and marker are compared under that map.  The same world-4 spawn
trains every rung with ``track_grad_norm`` and
``track_sdc_fingerprint`` and saves GPT-2 checkpoints (dp, zero1) that a
world of 2 resumes.  The two spawns take ~25 s of the module's time on
8 cores (one intra-op thread a rank).
"""

import os
import shutil
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_worker as w
from tpudp.data.loader import DataLoader as JaxLoader
from tpudp.mesh import make_mesh as jax_make_mesh
from tpudp.models.gpt2 import gpt2_small as jax_gpt2_small
from tpudp.models.vgg import VGG as JaxVGG
from tpudp.resilience import ResiliencePolicy as JaxPolicy
from tpudp.sdc import BitFlipGrads as JaxBitFlipGrads
from tpudp.sdc import BitFlipParams as JaxBitFlipParams
from tpudp.sdc import flip_bit_on_replica as jax_flip_bit_on_replica
from tpudp.sdc import localize_minority as jax_localize_minority
from tpudp.sdc import np_fingerprint, traced_fingerprint
from tpudp.train import Trainer as JaxTrainer
from tpudp.train import init_state as jax_init_state
from tpudp.train import make_optimizer as jax_make_optimizer
from tpudp.train import make_train_step as jax_make_train_step
from tpudp_torch import sdc, train
from tpudp_torch.data import load_cifar10
from tpudp_torch.models import vgg
from tpudp_torch.resilience import ResiliencePolicy
from tpudp_torch.trainer import Trainer


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite's workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# Primitives, bit for bit
# ---------------------------------------------------------------------------

def _array(dtype: str, seed: int = 11):
    rng = np.random.default_rng(seed)
    if dtype in ("float32", "float16", "float64"):
        return (rng.normal(size=(17, 5)) * 1e3).astype(dtype)
    if dtype == "bfloat16":
        import ml_dtypes

        return rng.normal(size=31).astype(ml_dtypes.bfloat16)
    if dtype == "bool":
        return rng.integers(0, 2, size=9).astype(bool)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, size=23, dtype=dtype)


def _torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


DTYPES = ["float32", "float16", "bfloat16", "float64", "int32", "int64",
          "int16", "int8", "uint8", "bool"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_fingerprint_equals_host_twin_and_traced(dtype):
    """Every dtype width: the port's device checksum equals JAX's host
    twin and its in-step (traced) fingerprint on the same bytes."""
    a = _array(dtype)
    got = sdc.fingerprint([_torch(a)]).numpy().astype(np.uint64)
    assert np.array_equal(got, np_fingerprint([a]))
    assert np.array_equal(sdc.np_fingerprint([a]), np_fingerprint([a]))
    if dtype not in ("float64", "int64"):  # jax runs 32-bit by default
        traced = np.asarray(jax.jit(traced_fingerprint)(
            {"a": jnp.asarray(a)})).astype(np.uint64)
        assert np.array_equal(got, traced)


def test_fingerprint_over_mixed_tensors_sums_mod_2_32():
    arrays = [_array(d, seed=i) for i, d in enumerate(DTYPES)]
    got = sdc.fingerprint([_torch(a) for a in arrays])
    assert np.array_equal(got.numpy().astype(np.uint64),
                          np_fingerprint(arrays))


def test_single_low_mantissa_flip_changes_checksum():
    """One low-mantissa bit of a large tensor of large values: a float
    sum rounds it away, the wraparound u32 bit sum cannot."""
    a = torch.ones(4096) * 1e6
    b = a.clone()
    sdc.flip_bit(b[2026:2027], 0)
    assert float(a.sum()) == float(b.sum())
    assert not torch.equal(sdc.fingerprint([a]), sdc.fingerprint([b]))


@pytest.mark.parametrize("dtype,bit", [("float32", 5), ("float16", 20),
                                       ("uint8", 10), ("float32", 37),
                                       ("float32", 31), ("int16", 15),
                                       ("float64", 63)])
def test_flip_bit_equals_jax_and_is_its_own_inverse(dtype, bit):
    """The bit index wraps to the dtype's width (a real flip, never a
    no-op above the word), the flipped bytes are JAX's, and a second flip
    restores them."""
    a = np.ones(4, dtype)
    t = _torch(a)
    sdc.flip_bit(t, bit)
    if dtype != "float64":
        want = np.asarray(jax_flip_bit_on_replica(jnp.asarray(a), 0, bit))
        assert t.numpy().tobytes() == want.tobytes()
    assert not np.array_equal(t.numpy(), a)
    sdc.flip_bit(t, bit)
    assert t.numpy().tobytes() == a.tobytes()


def test_flip_bit_on_replica_touches_only_that_rank():
    t = torch.ones(4)
    assert not sdc.flip_bit_on_replica(t, 1, 3, rank=0)
    assert torch.equal(t, torch.ones(4))
    assert sdc.flip_bit_on_replica(t, 1, 3, rank=1)
    assert not torch.equal(t, torch.ones(4))


def test_localize_minority_verdicts_equal_jax():
    ok = np.array([7, 4], np.uint64)
    bad = np.array([9, 4], np.uint64)
    agree = {f"d{i}": ok for i in range(3)}
    cases = [{}, agree, dict(agree, d1=bad),
             {"d0": ok, "d1": ok, "d2": bad, "d3": bad},
             {"d0": ok, "d1": bad}]
    for fps in cases:
        assert sdc.localize_minority(fps) == jax_localize_minority(fps)
    assert sdc.localize_minority(dict(agree, d1=bad)) == (["d1"],
                                                         ["d0", "d2"])


# ---------------------------------------------------------------------------
# Injectors
# ---------------------------------------------------------------------------

def _fake_port_state():
    model = torch.nn.Linear(2, 2)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    return types.SimpleNamespace(model=model, optimizer=opt, layout=None)


class _FakeJaxState:
    def __init__(self, params, opt_state=None):
        self.params = params
        self.opt_state = opt_state if opt_state is not None else {}

    def replace(self, **kw):
        return _FakeJaxState(kw.get("params", self.params),
                             kw.get("opt_state", self.opt_state))


def _fake_jax_state():
    return _FakeJaxState({"w": jax.device_put(np.ones(4, np.float32))},
                         {"mu": jax.device_put(np.zeros(4, np.float32))})


@pytest.mark.parametrize("kind,kw,calls", [
    ("params", {"schedule": [(3, 0, 5)]}, 8),
    ("params", {"persist_from": 4, "replica": 0, "bit": 2}, 6),
    ("grads", {"schedule": [(1, 0, 0)]}, 1),
], ids=["one-shot-once-ever", "persistent-every-call", "grads-opt-state"])
def test_injectors_fire_as_jax_and_hit_their_target(kind, kw, calls):
    """The same schedule fires the same ``(step, replica, bit)`` entries
    in both packages (a one-shot entry once ever, ``persist_from`` every
    call from its step); BitFlipParams changes the parameters,
    BitFlipGrads the momentum and not the parameters."""
    kw = dict(kw)
    schedule = kw.pop("schedule", ())
    port_cls = sdc.BitFlipParams if kind == "params" else sdc.BitFlipGrads
    jax_cls = JaxBitFlipParams if kind == "params" else JaxBitFlipGrads
    inj, jinj = port_cls(schedule, **kw), jax_cls(schedule, **kw)
    st, jst = _fake_port_state(), _fake_jax_state()
    before = [p.detach().clone() for p in st.model.parameters()]
    for _ in range(calls):
        st, jst = inj(st), jinj(jst)
    assert inj.fired == jinj.fired and inj.fired
    params_moved = any(not torch.equal(a, b) for a, b in
                       zip(before, st.model.parameters()))
    assert params_moved == (kind == "params")
    if kind == "grads":
        bufs = [st.optimizer.state[p]["momentum_buffer"]
                for p in st.model.parameters()]
        assert any(b.abs().sum() > 0 for b in bufs)


def test_injector_validates_persist_from():
    for cls in (sdc.BitFlipParams, JaxBitFlipParams):
        with pytest.raises(ValueError, match="persist_from"):
            cls(persist_from=-1)


# ---------------------------------------------------------------------------
# The in-step fingerprint equals JAX's sdc_fp on the same bytes
# ---------------------------------------------------------------------------

def _jax_vgg_state(tx, steps: int):
    """JAX's narrow VGG (the worker's weights) after ``steps`` single-device
    steps with ``track_sdc``, and the batches."""
    params, stats = w.vgg_init()
    model = JaxVGG(cfg=w.CFG)
    state = jax_init_state(model, tx, input_shape=(1, 32, 32, 3),
                           track_sdc=True, track_grad_norm=True)
    p = jax.tree.map(jnp.asarray, params)
    state = state.replace(params=p, opt_state=tx.init(p),
                          batch_stats=jax.tree.map(jnp.asarray, stats))
    step = jax_make_train_step(model, tx, None, donate=False)
    for x, y in w.vgg_batches(1)[:steps]:
        state, _ = step(state, jnp.asarray(x), jnp.asarray(y))
    return state


def test_dp_fingerprint_equals_jax_sdc_fp():
    """JAX's state after two steps, loaded into the port's state: the
    port's fingerprint of the parameters and the momentum (laid out as
    torch lays them: transposed kernels, OIHW convolutions) equals JAX's
    in-step ``sdc_fp`` bit for bit — the sum does not depend on layout,
    and the element counts cover the same leaves."""
    tx = jax_make_optimizer(**w.SGD)
    js = _jax_vgg_state(tx, 2)
    trace = js.opt_state[1][0].trace
    spec = train.make_optimizer(**w.SGD)
    model = w.bn_model("vgg")
    state = train.init_state(model, spec, track_sdc=True)
    train.load_state(state, {"step": np.asarray(js.step),
                             "params": jax.device_get(js.params),
                             "batch_stats": jax.device_get(js.batch_stats),
                             "opt_state": {"momentum":
                                           jax.device_get(trace)},
                             "loss_sum": np.asarray(js.loss_sum)})
    got = train.sdc_fingerprint(state).numpy().astype(np.uint64)
    assert np.array_equal(got, np.asarray(js.sdc_fp).astype(np.uint64))
    # and the port's own step recomputes it after every update
    x, y = w.vgg_batches(1)[2]
    step = train.make_train_step(model, spec)
    state, _ = step(state, torch.as_tensor(x), torch.as_tensor(y))
    assert torch.equal(state.sdc_fp, train.sdc_fingerprint(state))
    assert not np.array_equal(state.sdc_fp.numpy().astype(np.uint64), got)


# ---------------------------------------------------------------------------
# The graded response: JAX on mesh(4) / mesh(2) against the port's worlds
# ---------------------------------------------------------------------------

JAX_INJECTORS = {
    "clean": lambda: None,
    "params": lambda: JaxBitFlipParams([(3, 2, 5)]),
    "grads": lambda: JaxBitFlipGrads([(3, 1, 9)]),
    "persistent": lambda: JaxBitFlipParams(persist_from=3, replica=1,
                                           bit=7),
    "tie": lambda: JaxBitFlipParams(persist_from=3, replica=1, bit=7),
}


def _jax_fit(case: str, root: str) -> dict:
    """JAX's Trainer on ``make_mesh(4)`` (the tie: 2) over the same
    synthetic set and global batch as the port's worlds."""
    train_set, _, _ = load_cifar10(os.path.join(root, "none"),
                                   synthetic_train_size=w.SDC_TRAIN,
                                   synthetic_test_size=16)
    inj = JAX_INJECTORS[case]()
    tr = JaxTrainer(JaxVGG(cfg=w.CFG),
                    jax_make_mesh(2 if case == "tie" else 4),
                    learning_rate=0.01, log_every=2, log_fn=lambda s: None,
                    track_sdc_fingerprint=True, sdc_fault_hook=inj)
    error = None
    try:
        tr.fit(JaxLoader(train_set, w.SDC_BATCH, train=True, seed=2,
                         backend="numpy"), epochs=w.SDC_EPOCHS,
               resilience=JaxPolicy(checkpoint_dir=root, sdc_check_every=2,
                                    **({"max_rollbacks": 1}
                                       if case == "tie" else {})))
    except Exception as e:  # the verdicts under test
        error = (type(e).__name__, getattr(e, "replica", None))
    marker = os.path.join(root, "sdc_quarantine.json")
    import json

    return {"stats": {k: v for k, v in tr.stats.items() if k != "events"},
            "events": tr.stats["events"], "error": error,
            "fired": list(inj.fired) if inj is not None else [],
            "marker": (json.load(open(marker)) if os.path.exists(marker)
                       else None)}


def _load(out: str, name: str, world: int) -> list:
    return [torch.load(os.path.join(out, f"{name}-rank{r}.pt"),
                       weights_only=False) if os.path.exists(
                           os.path.join(out, f"{name}-rank{r}.pt")) else None
            for r in range(world)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The port's world of 4 (elastic saves, every rung's slots, then the
    SDC matrix, whose persistent case ends rank 1 with exit 44) and world
    of 2 (the tie, the elastic resume), with JAX's matrix computed in
    this process meanwhile."""
    out4 = str(tmp_path_factory.mktemp("sdc4"))
    out2 = str(tmp_path_factory.mktemp("sdc2"))
    result: dict = {}

    def world4():
        result["w4"] = w.launch_world(out4, 4, ["elastic_save", "sdc_rungs",
                                                "sdc"])

    th = threading.Thread(target=world4)
    th.start()
    jroot = str(tmp_path_factory.mktemp("sdc_jax"))
    jax_runs = {case: _jax_fit(case, os.path.join(jroot, case))
                for case in JAX_INJECTORS}
    th.join()
    codes4, logs4 = result["w4"]
    assert codes4 == [0, 44, 0, 0], "\n".join(logs4)
    for strategy in ("dp", "zero1"):
        shutil.copytree(os.path.join(out4, f"elastic-{strategy}"),
                        os.path.join(out2, f"elastic-{strategy}"))
    codes2, logs2 = w.launch_world(out2, 2, ["sdc", "elastic_resume"])
    assert codes2 == [0, 0], "\n".join(logs2)
    return {"out4": out4, "out2": out2, "jax": jax_runs}


def _key(k: str) -> str:
    """JAX's single-process replica key ``p0/d<i>`` as the port's rank
    key ``p<i>``."""
    return "p" + k.split("/d")[1] if "/d" in k else k


def _mapped(keys):
    return None if keys is None else sorted(_key(k) for k in keys)


def _events(events) -> list:
    """The recovery events both packages record, replica keys mapped;
    the port's multi-rank votes (JAX votes only across hosts) left out."""
    out = []
    for e in events:
        if e["kind"] == "vote":
            continue
        item = {"kind": e["kind"]}
        for k in ("replicas", "step", "localized", "epoch", "it",
                  "cleared_at"):
            if k in e:
                item[k] = (_mapped(e[k]) if k == "replicas" else e[k])
        out.append(item)
    return out


STAT_KEYS = ("rollbacks", "step_retries", "ckpt_fallbacks",
             "loader_restarts", "sdc_checks", "sdc_detections",
             "sdc_transients", "sdc_quarantines")


def _check_against_jax(port_ranks: list, jax_run: dict) -> None:
    for r, res in enumerate(port_ranks):
        if res is None:
            continue
        assert {k: res["stats"][k] for k in STAT_KEYS} == \
            {k: jax_run["stats"][k] for k in STAT_KEYS}, r
        assert _events(res["events"]) == _events(jax_run["events"]), r
        assert res["fired"] == jax_run["fired"]


def test_clean_run_zero_detections(worlds):
    """The false-positive gate, and one check a window (8 steps, a check
    every 2): checks ran, none fired, as in JAX."""
    port = _load(worlds["out4"], "sdc-clean", 4)
    _check_against_jax(port, worlds["jax"]["clean"])
    for res in port:
        assert res["stats"]["sdc_checks"] == 4
        assert res["stats"]["sdc_detections"] == 0
        assert res["error"] is None


@pytest.mark.parametrize("case,victim", [("params", "p2"), ("grads", "p1")])
def test_transient_flip_detected_localized_repaired(worlds, case, victim):
    """One flip on one rank (its parameters, or its momentum): detected at
    the next check, the vote names that rank (JAX names the same
    device), the rollback replays, the verdict is transient, and every
    rank's final state equals the clean run's BIT FOR BIT."""
    port = _load(worlds["out4"], f"sdc-{case}", 4)
    clean = _load(worlds["out4"], "sdc-clean", 4)
    _check_against_jax(port, worlds["jax"][case])
    for res, ref in zip(port, clean):
        det = [e for e in res["events"] if e["kind"] == "sdc_detected"]
        assert [e["replicas"] for e in det] == [[victim]]
        assert res["stats"]["sdc_transients"] == 1
        for k, v in ref.items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(v, res[k]), k
        assert res["loss_sum"] == ref["loss_sum"]


def test_persistent_flip_quarantines(worlds):
    """The same rank diverging again after the bit-exact replay: rank 1
    writes the marker naming itself and exits 44 (the fixture checked the
    exit codes), the other ranks raise SdcPersistentError naming it —
    JAX's single process raises naming the device."""
    port = _load(worlds["out4"], "sdc-persistent", 4)
    jx = worlds["jax"]["persistent"]
    assert port[1] is None  # rank 1 left with SDC_QUARANTINE_EXIT
    _check_against_jax(port, jx)
    assert jx["error"][0] == "SdcPersistentError"
    for r in (0, 2, 3):
        assert port[r]["error"] == ("SdcPersistentError", ["p1"])
        assert port[r]["error"][1] == _mapped(jx["error"][1])
        m = port[r]["marker"]
        assert m["replicas"] == _mapped(jx["marker"]["replicas"]) == ["p1"]
        assert m["step"] == jx["marker"]["step"]
        # the marker's writer: rank 1 (JAX's single process is host 0)
        assert m["host"] == 1 and m["devices"] == ["p1"]


def test_unlocalizable_tie_never_quarantines(worlds):
    """Two ranks disagreeing: corruption proven, culprit unknown — it
    rides the rollback until the budget escalates SdcDetected with no
    replica named, and no marker is written, as in JAX at mesh 2.  The
    injector toggles one bit every step from step 3, so a check reads
    clean when an even number of toggles cancel; with one rollback the
    two checks (steps 4 and 6) each follow an odd number of toggles, so
    the verdicts do not depend on the trained numbers."""
    port = _load(worlds["out2"], "sdc-tie", 2)
    jx = worlds["jax"]["tie"]
    _check_against_jax(port, jx)
    assert jx["error"] == ("SdcDetected", None)
    for res in port:
        assert res["error"] == ("SdcDetected", None)
        assert res["stats"]["rollbacks"] == 1
        assert res["stats"]["sdc_detections"] == 2
        assert res["stats"]["sdc_quarantines"] == 0
        assert res["marker"] is None
        assert all(not e["localized"] for e in res["events"]
                   if e["kind"] == "sdc_detected")


def test_sdc_check_requires_fingerprint_tracking(tmp_path):
    """``sdc_check_every`` without the in-step fingerprint would check
    nothing: both supervisors refuse, and a cadence below 1 too."""
    train_set, _, _ = load_cifar10(str(tmp_path / "none"),
                                   synthetic_train_size=16,
                                   synthetic_test_size=8)
    from tpudp_torch.data import DataLoader

    tr = Trainer(w.bn_model("vgg"), log_every=2, log_fn=lambda s: None)
    with pytest.raises(ValueError, match="track_sdc_fingerprint"):
        tr.fit(DataLoader(train_set, 8, train=True, seed=2), epochs=1,
               resilience=ResiliencePolicy(checkpoint_dir=str(tmp_path),
                                           sdc_check_every=2))
    jt = JaxTrainer(JaxVGG(cfg=w.CFG), None, log_every=2,
                    log_fn=lambda s: None)
    with pytest.raises(ValueError, match="track_sdc_fingerprint"):
        jt.fit(JaxLoader(train_set, 8, train=True, seed=2), epochs=1,
               resilience=JaxPolicy(checkpoint_dir=str(tmp_path),
                                    sdc_check_every=2))
    tr = Trainer(w.bn_model("vgg"), log_every=2, log_fn=lambda s: None,
                 track_sdc_fingerprint=True)
    with pytest.raises(ValueError, match=">= 1"):
        tr.fit(DataLoader(train_set, 8, train=True, seed=2), epochs=1,
               resilience=ResiliencePolicy(checkpoint_dir=str(tmp_path),
                                           sdc_check_every=0))


# ---------------------------------------------------------------------------
# The slots beside every rung
# ---------------------------------------------------------------------------

def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield np.asarray(tree)


@pytest.fixture(scope="module")
def jax_gpt2_norms():
    """JAX's grad-norm accumulator over the 4 TokenLoader batches, from the
    single-device step: the norm JAX's GSPMD rungs (tp, fsdp, zero1, sp)
    take of the global gradient."""
    cfg = w.TP_CFG
    model = jax_gpt2_small(**cfg)
    tx = jax_make_optimizer(learning_rate=0.01)
    tree = jax.tree.map(jnp.asarray, w.strategy_tree(cfg))
    state = jax_init_state(model, tx, input_shape=(1, 16),
                           track_grad_norm=True, track_sdc=True)
    state = state.replace(params=tree, opt_state=tx.init(tree))
    step = jax_make_train_step(model, tx, None, donate=False)
    for x, y in w.lm_batches(cfg["vocab_size"], steps=4, batch=8, t=16,
                             seed=0):
        state, _ = step(state, jnp.asarray(x), jnp.asarray(y))
    return np.asarray(state.obs_norms)


@pytest.mark.parametrize("rung", ["tp", "fsdp", "zero1", "sp"])
def test_sharded_rung_norm_and_fingerprint_are_global(worlds, rung,
                                                      jax_gpt2_norms):
    """tp, fsdp, zero1 and sp (JAX's ``_loss_and_updates`` rungs): every
    rank's ``obs_norms`` is JAX's norm of the global gradient (rtol
    1e-5), and its ``sdc_fp`` is the checksum of the GLOBAL parameters
    and momentum — exactly ``np_fingerprint`` of the rung's JAX-layout
    checkpoint tree, as JAX's GSPMD step takes it of the global arrays."""
    ranks = _load(worlds["out4"], "sdc_rungs", 4)
    for res in ranks:
        got = res[rung]
        np.testing.assert_allclose(got["obs_norms"], jax_gpt2_norms,
                                   rtol=1e-5)
        tree = got["tree"]
        want = np_fingerprint(list(_leaves(tree["params"]))
                              + list(_leaves(tree["opt_state"]
                                             ["momentum"])))
        assert np.array_equal(np.asarray(got["sdc_fp"], np.uint64), want)


def test_mpmd_fingerprint_and_untouched_slots(worlds):
    """1f1b_mpmd (``tpudp/parallel/schedule.py:688-711``): the stage
    checksums of the parameters summed over ``pipe`` — the shared
    embeddings and final norm counted once a stage — with the 1/DP
    momentum shards left out, and no grad norm; gpipe and ep
    (``tpudp/parallel/pipeline.py``, ``expert.py``) touch neither slot,
    which stays zeros as JAX's allocated ones do."""
    for res in _load(worlds["out4"], "sdc_rungs", 4):
        got = res["pp-mpmd"]
        params = got["tree"]["params"]
        shared = {k: v for k, v in params.items() if k != "blocks"}
        stages = w.SDC_RUNGS["pp-mpmd"][0]["pipe"]
        total = np.zeros(2, np.uint64)
        for fp in ([np_fingerprint(list(_leaves(params)))]
                   + [np_fingerprint(list(_leaves(shared)))]
                   * (stages - 1)):
            total = (total + fp) & np.uint64(0xFFFFFFFF)
        assert np.array_equal(np.asarray(got["sdc_fp"], np.uint64), total)
        assert got["obs_norms"] == [0.0, 0.0]
        for rung in ("pp", "ep"):
            assert res[rung]["sdc_fp"] == [0, 0]
            assert res[rung]["obs_norms"] == [0.0, 0.0]


def test_pp_stage_groups_localize_a_flip(worlds):
    """Under 1f1b_mpmd (data 2 x pipe 2, ``shard_optimizer=False``) every
    rank's fingerprint is its data replica's pipeline sum (parameters and
    momentum), so a flip on rank 2 splits the ranks 2-2
    and the fingerprints cannot name it; the raw-byte vote within the
    ranks of each stage (JAX's ``vote_shard_groups``: replication
    groups) localizes it to stage 0's group, ``p0`` and ``p2`` (two
    replicas a group tie, as in JAX), and the replay clears it."""
    for res in _load(worlds["out4"], "sdc_rungs", 4):
        got = res["pp-sdc"]
        det = [e for e in got["events"] if e["kind"] == "sdc_detected"]
        assert [(e["replicas"], e["localized"]) for e in det] == [
            (["p0", "p2"], True)]
        assert got["stats"]["sdc_transients"] == 1
        assert got["stats"]["rollbacks"] == 1
        assert got["stats"]["sdc_quarantines"] == 0


# ---------------------------------------------------------------------------
# The elastic relaunch: 4 ranks -> 2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", ["dp", "zero1"])
def test_checkpoint_at_4_ranks_resumes_at_2(worlds, strategy):
    """A GPT-2 checkpoint saved after epoch 1 at 4 ranks (dp, and zero1
    with its momentum sharded 4 ways) resumes at 2 ranks through
    ``restore_newest`` with ``ShardedSampler(batch_contiguous=8)``: the
    same global batches, so epoch 2's losses equal the uninterrupted
    4-rank run's (rtol 1e-5) and the final parameters agree within
    atol 1e-6 (the all-reduce sums 2 partial gradients instead of 4)."""
    full = _load(worlds["out4"], "elastic_save", 4)[0][strategy]
    for res in _load(worlds["out2"], "elastic_resume", 2):
        got = res[strategy]
        assert got["used"] == "step_1" and got["start"] == 1
        np.testing.assert_allclose(got["losses"], full["losses"][2:],
                                   rtol=1e-5)
        for a, b in zip(_leaves(got["final"]), _leaves(full["final"])):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
