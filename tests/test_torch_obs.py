"""The port's obs layer (``tpudp_torch.obs``) against ``tpudp.obs``, case
for case with tests/test_obs.py: the recorder ring, the exporters
(Chrome trace, JSON snapshots, Prometheus text byte-equal to JAX's), the
flight recorder, the timing surface, the serving engine's spans, events
and zero-sync device counters on the same greedy traffic as JAX's engine,
the flight dumps of containment and of the watchdog, and the Trainer's
spans, ``track_grad_norm`` (against JAX's norms) and rollback dumps.
Tiny geometries, one intra-op thread.
"""

import glob
import json
import os
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudp import obs as jobs
from tpudp.models.gpt2 import gpt2_small as jax_gpt2_small
from tpudp.serve import Engine as JaxEngine
from tpudp_torch import obs
from tpudp_torch.models import gpt2
from tpudp_torch.serve import Engine
from tpudp_torch.serve.engine import OBS_DEVICE_COUNTERS
from tpudp_torch.serve.faults import FaultySteps, SlowSteps
from tpudp_torch.utils.watchdog import StepHangError, Watchdog

TINY = dict(vocab_size=64, max_seq_len=64, num_layers=2, num_heads=2,
            d_model=32)
PROMPTS = [np.arange(1, 9, dtype=np.int32),
           np.arange(3, 11, dtype=np.int32)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- recorder core: the same operations on both packages' recorders --------

def _ring(pkg):
    rec = pkg.Recorder(name="t", capacity=4)
    for i in range(10):
        rec.end(rec.begin(f"s{i}"))
    rec.end(0)  # lapped: dropped, never an error
    return rec


def _disabled(pkg):
    rec = pkg.Recorder(enabled=False)
    tok = rec.begin("x")
    assert tok == pkg.NO_SPAN
    rec.end(tok)
    rec.event("e", a=1)
    rec.count("c")
    with rec.span("s"):
        pass
    return rec


def _semantics(pkg):
    rec = pkg.Recorder(capacity=16)
    with rec.span("outer", tag="v"):
        rec.event("point", a=1)
        rec.count("tokens", 3)
        rec.count("tokens", 2)
    return rec


def _open(pkg):
    rec = pkg.Recorder(capacity=8)
    rec.begin("a")
    rec.end(rec.begin("b"))
    return rec


def _untimed(records):
    return [{k: v for k, v in r.items() if k not in ("t0", "dur")}
            | {"open": r.get("dur", 0) is None} for r in records]


@pytest.mark.parametrize("case", [_ring, _disabled, _semantics, _open],
                         ids=["ring", "disabled", "semantics", "open"])
def test_recorder_matches_jax(case):
    """Snapshots (time fields aside), counters, rollups and the last
    completed record agree with JAX's recorder for the same calls."""
    mine, ref = case(obs), case(jobs)
    assert _untimed(mine.snapshot()) == _untimed(ref.snapshot())
    assert dict(mine.counters) == dict(ref.counters)
    assert {k: v["count"] for k, v in mine.summary().items()} == {
        k: v["count"] for k, v in ref.summary().items()}
    last = mine.last_span()
    ref_last = ref.last_span()
    assert (last and last["name"]) == (ref_last and ref_last["name"])
    assert len(mine) == len(ref)
    if case is _ring:
        assert [r["name"] for r in mine.snapshot()] == [
            "s6", "s7", "s8", "s9"]
    if case is _disabled:
        assert mine.snapshot() == [] and not mine.counters


def test_overhead_budget_for_hot_path_api():
    """begin/end under JAX's budget: 50 us a pair over 20k pairs."""
    rec = obs.Recorder(capacity=1024)
    n = 20_000
    t0 = time.perf_counter()
    for _ in range(n):
        rec.end(rec.begin("hot"))
    per_pair = (time.perf_counter() - t0) / n
    assert per_pair < 50e-6, f"begin/end pair cost {per_pair * 1e6:.1f}us"


# -- exporters -------------------------------------------------------------

def test_chrome_trace_round_trip_and_jax_reads_it():
    rec = obs.Recorder(name="rt", capacity=8)
    with rec.span("win", idx=3):
        rec.event("commit", token=7)
    rec.count("tokens", 11)
    open_tok = rec.begin("open")
    trace = json.loads(json.dumps(obs.to_chrome_trace(rec, pid=2)))
    back = obs.spans_from_chrome_trace(trace)
    orig = rec.snapshot()
    assert len(back) == len(orig)
    for o, b in zip(orig, back):
        assert b["name"] == o["name"] and b["kind"] == o["kind"]
        assert b["t0"] == pytest.approx(o["t0"], abs=1e-9)
        if o["kind"] == "span":
            if o["dur"] is None:
                assert b["dur"] is None
            else:
                assert b["dur"] == pytest.approx(o["dur"], abs=1e-9)
        assert b.get("fields") == o.get("fields")
    assert obs.counters_from_chrome_trace(trace) == {"tokens": 11}
    for ev in trace["traceEvents"]:
        assert ev["ph"] in ("X", "i", "C") and "ts" in ev
    # JAX's parser reads the port's trace the same way
    assert jobs.spans_from_chrome_trace(trace) == back
    assert set(trace) == set(jobs.to_chrome_trace(jobs.Recorder()))
    rec.end(open_tok)


def test_snapshot_json_has_jax_keys():
    rec, jrec = obs.Recorder(name="s"), jobs.Recorder(name="s")
    for r in (rec, jrec):
        r.event("e", x=1)
    doc = json.loads(obs.snapshot_json(rec, extra_field=True))
    jdoc = json.loads(jobs.snapshot_json(jrec, extra_field=True))
    assert set(doc) == set(jdoc)
    assert doc["component"] == "s" and doc["extra_field"] is True
    assert doc["spans"][0]["name"] == "e"


def test_prometheus_text_byte_equal_to_jax():
    snap = {"stats": {"tokens": 42, "ok": True},
            "nested": {"deep": {"v": 1.5}, "n-e.g": -3},
            "big": 123456789, "tiny": 1e-12,
            "skipped": "a string", "also_skipped": None, "list": [1, 2]}
    text = obs.prometheus_text(snap)
    assert text == jobs.prometheus_text(snap)
    assert obs.prometheus_text(snap, "x") == jobs.prometheus_text(snap, "x")
    assert "tpudp_big 123456789\n" in text
    assert "tpudp_stats_ok 1\n" in text
    assert "# TYPE tpudp_stats_tokens gauge" in text
    assert "skipped" not in text


def test_metrics_server_serves_live_snapshot():
    state = {"v": 1}
    srv = obs.MetricsServer(0, lambda: {"counter": state["v"]})
    try:
        url = f"http://127.0.0.1:{srv.port}/metrics"
        body = urllib.request.urlopen(url, timeout=10).read().decode()
        assert "tpudp_counter 1" in body
        state["v"] = 2
        body = urllib.request.urlopen(url, timeout=10).read().decode()
        assert "tpudp_counter 2" in body
    finally:
        srv.close()


# -- flight recorder -------------------------------------------------------

def test_flight_dump_and_merge_match_jax(tmp_path):
    docs = {}
    for name, pkg in (("port", obs), ("jax", jobs)):
        d = tmp_path / name
        rec = pkg.Recorder(name="f")
        with rec.span("region"):
            rec.event("ev", k=1)
        fl = pkg.FlightRecorder(rec, str(d), component="t")
        p1 = fl.dump("first", extra={"why": "test"})
        p2 = fl.dump("second/bad name")
        assert p1 and p2 and fl.dumps == 2
        merged = pkg.merge_dumps(str(d))
        assert pkg.coordinated_merge(str(d)) == merged
        docs[name] = (sorted(os.listdir(d)), json.load(open(p1)),
                      json.load(open(merged)))
    (names, doc, mdoc), (jnames, jdoc, jmdoc) = docs["port"], docs["jax"]
    assert names == jnames  # flightrec-t-h0-000-first.json, ...
    assert set(doc) == set(jdoc)
    assert doc["reason"] == "first" and doc["extra"] == {"why": "test"}
    assert any(s["name"] == "region" for s in doc["spans"])
    assert doc["last_span"] is not None
    assert set(mdoc) == set(jmdoc) and mdoc["merged"] == 2
    assert [r["reason"] for r in mdoc["records"]] == ["first",
                                                      "second/bad name"]


def test_flight_disabled_without_directory(monkeypatch):
    monkeypatch.delenv(obs.FLIGHT_DIR_ENV, raising=False)
    fl = obs.FlightRecorder(obs.Recorder(), None)
    assert not fl.enabled and fl.dump("x") is None
    monkeypatch.setenv(obs.FLIGHT_DIR_ENV, "/tmp/some-dir")
    assert obs.FLIGHT_DIR_ENV == jobs.FLIGHT_DIR_ENV
    assert obs.resolve_flight_dir(None) == "/tmp/some-dir"
    assert obs.resolve_flight_dir("/explicit") == "/explicit"


def test_timing_surface(tmp_path):
    """One timing API: StepTimer fences, ``trace`` writes a Chrome trace
    with the step marks, the collective timer runs at one rank, and the
    profiler module re-exports the obs objects."""
    from tpudp_torch.utils import profiler

    assert profiler.trace is obs.trace
    assert profiler.step_annotation is obs.step_annotation
    timer = obs.StepTimer()
    timer.start()
    x = torch.ones(64, 64) @ torch.ones(64, 64)
    assert timer.stop(x) >= 0 and timer.count == 1
    with obs.trace(str(tmp_path / "prof")):
        for step in range(2):
            with obs.step_annotation(step):
                torch.ones(8).sum()
    [name] = os.listdir(tmp_path / "prof")
    events = json.load(open(tmp_path / "prof" / name))["traceEvents"]
    assert {"train_step#0", "train_step#1"} <= {e.get("name")
                                                for e in events}
    with obs.trace(None):
        pass
    out = profiler.measure_collective([torch.ones(4), torch.ones(2, 3)],
                                      steps=2, warmup=1)
    assert out["bytes"] == 40 and out["gbps"] == 0.0


# -- the serving engine against JAX's ----------------------------------------

@pytest.fixture(scope="module")
def lm():
    tree = gpt2.random_params(gpt2.GPT2Config(**TINY), seed=5)
    jmodel = jax_gpt2_small(**TINY)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    model = gpt2.build(gpt2.GPT2Config(**TINY), 5, "cpu")
    return jmodel, jparams, model


def _records(rec):
    return [(r["kind"], r["name"], r.get("fields"))
            for r in rec.snapshot()]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_engine_events_and_counters_match_jax(lm, paged):
    """The same greedy traffic through both engines: the port records
    JAX's spans and events in JAX's order with JAX's fields, and its
    device counters equal JAX's and its own host stats (the first tokens
    ride the prefill's sample, which the counters leave out)."""
    jmodel, jparams, model = lm
    kw = dict(num_slots=2, max_len=32, prefill_chunk=8)
    if paged:
        kw["kv_pages"] = 8
    jeng = JaxEngine(jmodel, jparams, **kw)
    want = jeng.generate_many(PROMPTS, 8)
    eng = Engine(model, device="cpu", **kw)
    got = eng.generate_many(PROMPTS, 8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert _records(eng.obs) == _records(jeng.obs)
    m, jm = eng.metrics(), jeng.metrics()
    dev = m["device_counters"]
    assert set(dev) == set(OBS_DEVICE_COUNTERS)
    assert dev == jm["device_counters"]
    assert m["device_counters_per_model"] == jm["device_counters_per_model"]
    assert dev["tokens"] == m["stats"]["tokens"] - len(PROMPTS)
    assert dev["slot_steps"] == m["stats"]["active_slot_steps"]
    assert dev["steps"] == m["stats"]["decode_steps"]
    assert dev["eos_exits"] == 0.0
    assert {k: v["count"] for k, v in m["spans"].items()} == {
        k: v["count"] for k, v in jm["spans"].items()}
    assert {"prefill", "sample", "decode"} <= set(m["spans"])
    for key in ("obs_counters", "flight_dumps"):
        assert m[key] == jm[key]
    names = [r["name"] for r in eng.obs.snapshot() if r["kind"] == "event"]
    assert names.count("admit") == 2 and names.count("finish") == 2


def test_engine_obs_off_is_inert_and_parity_neutral(lm):
    _, _, model = lm
    on = Engine(model, device="cpu", num_slots=2, max_len=32,
                prefill_chunk=8).generate_many(PROMPTS, 8)
    eng = Engine(model, device="cpu", num_slots=2, max_len=32,
                 prefill_chunk=8, obs=False)
    outs = eng.generate_many(PROMPTS, 8)
    for o, r in zip(outs, on):
        np.testing.assert_array_equal(o, r)
    assert eng.obs.snapshot() == []
    assert eng.metrics()["device_counters"]["tokens"] > 0


def test_fused_window_counts_eos_exit_on_device(lm):
    """Only the fused window knows the EOS ids on the device: its
    eos_exits counter records an in-window exit, and its counts equal the
    host stats of the window's iterations."""
    _, _, model = lm
    probe = Engine(model, device="cpu", num_slots=1, max_len=32,
                   prefill_chunk=8)
    toks = probe.generate_many([PROMPTS[0]], 8)[0][PROMPTS[0].size:]
    # the first token a decode iteration produces that no earlier step
    # did: the exit happens inside a window
    i = next(i for i in range(1, 7) if toks[i] not in toks[:i])
    eng = Engine(model, device="cpu", num_slots=1, max_len=32,
                 prefill_chunk=8, decode_fuse=4)
    h = eng.submit(PROMPTS[0], 8, eos_id=int(toks[i]))
    eng.run_until_complete()
    assert h.finish_reason.value == "eos" and len(h.tokens) == i + 1
    dev = eng.metrics()["device_counters"]
    assert dev["eos_exits"] == 1.0
    assert dev["steps"] == eng.stats["fused_steps"]
    assert dev["slot_steps"] == eng.stats["active_slot_steps"]
    assert dev["tokens"] == eng.stats["tokens"] - 1


def test_engine_step_fault_dumps_flight_record(tmp_path, lm):
    _, _, model = lm
    hook = FaultySteps(fail_at={5}, kind="decode")
    eng = Engine(model, device="cpu", num_slots=2, max_len=32,
                 prefill_chunk=8, step_fault_hook=hook,
                 flight_dir=str(tmp_path))
    outs = eng.generate_many(PROMPTS, 8)
    assert hook.fired and eng.stats["step_failures"] == 1
    ref = Engine(model, device="cpu", num_slots=2, max_len=32,
                 prefill_chunk=8).generate_many(PROMPTS, 8)
    for o, r in zip(outs, ref):
        np.testing.assert_array_equal(o, r)
    dumps = glob.glob(os.path.join(str(tmp_path), "flightrec-*.json"))
    assert len(dumps) == 1
    assert os.path.basename(dumps[0]).startswith(
        "flightrec-serve-h0-000-step_failure")
    doc = json.load(open(dumps[0]))
    assert doc["reason"] == "step_failure"
    assert "InjectedFault" in doc["extra"]["error"]
    span_names = [s["name"] for s in doc["spans"]]
    assert "decode" in span_names
    assert span_names[-1] == "containment"
    assert doc["last_span"]["name"] == "containment"
    assert eng.metrics()["flight_dumps"] == 1


def test_serve_watchdog_timeout_names_region_and_dumps(tmp_path, lm):
    _, _, model = lm
    wd = Watchdog(timeout_s=0.2, kill=False, poll_s=0.02).start()
    try:
        eng = Engine(model, device="cpu", num_slots=1, max_len=32,
                     prefill_chunk=8, watchdog=wd, step_timeout_s=0.2,
                     step_fault_hook=SlowSteps({4}, 0.8, kind="decode"),
                     flight_dir=str(tmp_path))
        assert wd.flight is eng.flight
        eng.generate_many(PROMPTS[:1], 8)
        assert eng.stats["step_failures"] >= 1
        dumps = sorted(glob.glob(
            os.path.join(str(tmp_path), "flightrec-*.json")))
        docs = [json.load(open(p)) for p in dumps]
        wd_doc = next(d for d in docs
                      if d["reason"].startswith("watchdog_timeout"))
        assert wd_doc["reason"] == "watchdog_timeout_decode"
        assert wd_doc["extra"]["region"] == "decode"
        assert wd_doc["extra"]["armed_for_s"] is not None
        assert wd.last_hang["region"] == "decode"
    finally:
        wd.stop()


def test_watchdog_hang_error_carries_region_and_last_span():
    rec = obs.Recorder(name="w")
    fl = obs.FlightRecorder(rec, None)
    wd = Watchdog(timeout_s=0.1, kill=False, poll_s=0.02,
                  flight=fl).start()
    try:
        rec.end(rec.begin("healthy_step"))
        with wd.step(name="wedged_collective"):
            time.sleep(0.4)
        with pytest.raises(StepHangError) as ei:
            with wd.step(name="next"):
                pass
        msg = str(ei.value)
        assert "wedged_collective" in msg
        assert "healthy_step" in msg
        assert ei.value.hang["region"] == "wedged_collective"
        assert ei.value.hang["last_span"]["name"] == "healthy_step"
    finally:
        wd.stop()


# -- the Trainer -----------------------------------------------------------

NARROW = (8, "M", 16, "M", "M", "M", "M")


def test_trainer_spans_and_grad_norm_match_jax(tmp_path):
    """One epoch of 8 steps on the same weights and batches:
    ``track_grad_norm``'s mean and root mean square equal JAX's, and the
    spans and counters are JAX's."""
    from tpudp.data import DataLoader as JaxLoader
    from tpudp.models.vgg import VGG as JaxVGG
    from tpudp.train import Trainer as JaxTrainer
    from tpudp_torch.data import DataLoader, load_cifar10
    from tpudp_torch.models import vgg
    from tpudp_torch.trainer import Trainer

    train_set, _, _ = load_cifar10(str(tmp_path), synthetic_train_size=64,
                                   synthetic_test_size=8)
    params, stats = vgg.random_params(NARROW, 9)
    jt = JaxTrainer(JaxVGG(cfg=NARROW), None, "none", log_every=2,
                    log_fn=lambda s: None, track_grad_norm=True)
    p = jax.tree.map(jnp.asarray, params)
    jt.state = jt.state.replace(params=p,
                                batch_stats=jax.tree.map(jnp.asarray, stats),
                                opt_state=jt.tx.init(p))
    jt.train_epoch(JaxLoader(train_set, 8, train=True, seed=3), 0)
    model = vgg.VGG(NARROW)
    model.load_state_dict(vgg.params_from_jax(params, stats))
    tr = Trainer(model, log_every=2, log_fn=lambda s: None,
                 track_grad_norm=True)
    tr.train_epoch(DataLoader(train_set, 8, train=True, seed=3), 0)
    m, jm = tr.metrics(), jt.metrics()
    assert m["step"] == jm["step"] == 8
    np.testing.assert_allclose([m["grad_norm_mean"], m["grad_norm_rms"]],
                               [jm["grad_norm_mean"], jm["grad_norm_rms"]],
                               rtol=1e-4)
    assert m["grad_norm_mean"] > 0
    assert set(m) == set(jm)
    assert set(m["spans"]) == set(jm["spans"]) >= {
        "train.window", "train.dispatch", "train.data",
        "train.fetch_fence"}
    assert m["counters"] == jm["counters"] == {"train.windows": 4,
                                               "train.samples": 64}
    off = Trainer(vgg.VGG(NARROW), log_every=2, log_fn=lambda s: None)
    assert off.state.obs_norms is None
    assert "grad_norm_mean" not in off.metrics()


def _ckpt_trainer(flight):
    from tests.torch_dp_worker import ckpt_trainer

    return ckpt_trainer(flight_dir=str(flight))


def _nan_loader():
    from tpudp_torch.data import DataLoader, load_cifar10
    from tpudp_torch.training_faults import CorruptingLoader

    train_set, _, _ = load_cifar10("/nonexistent", synthetic_train_size=64,
                                   synthetic_test_size=16)
    return CorruptingLoader(DataLoader(train_set, 16, train=True, seed=2,
                                       backend="numpy"), nan_at={5})


def test_training_rollback_dumps_flight_record(tmp_path):
    from tpudp_torch.resilience import ResiliencePolicy

    flight = tmp_path / "flight"
    tr = _ckpt_trainer(flight)
    tr.fit(_nan_loader(), epochs=2,
           resilience=ResiliencePolicy(checkpoint_dir=str(tmp_path / "ck")))
    assert tr.stats["rollbacks"] == 1
    dumps = glob.glob(os.path.join(str(flight), "flightrec-*.json"))
    assert len(dumps) == 1
    doc = json.load(open(dumps[0]))
    assert doc["reason"] == "rollback" and doc["component"] == "train"
    assert "FloatingPointError" in doc["extra"]["error"]
    assert "train.window" in [s["name"] for s in doc["spans"]]
    assert "resilience.rollback" in [r["name"] for r in tr.obs.snapshot()]
    assert tr.metrics()["flight_dumps"] == 1


def test_coordinated_rollback_dumps_and_merges(tmp_path):
    """The voted recovery's arm at one rank: every rank banks a dump
    named for the worst outcome, and rank 0 merges after the restore."""
    from tpudp_torch.resilience import (OUTCOME_DIVERGENCE,
                                        ResiliencePolicy, Supervisor)
    from tpudp_torch.utils.checkpoint import save_checkpoint

    flight = tmp_path / "flight"
    ckpt = tmp_path / "ck"
    tr = _ckpt_trainer(flight)
    save_checkpoint(os.path.join(str(ckpt), "step_0"), tr.state)
    sup = Supervisor(tr, ResiliencePolicy(checkpoint_dir=str(ckpt)))
    sup._per_epoch = 4
    epoch, skip = sup._coordinated_recover(
        OUTCOME_DIVERGENCE, FloatingPointError("nan window"))
    assert (epoch, skip) == (0, 0)
    assert tr.stats["rollbacks"] == 1
    dumps = glob.glob(os.path.join(
        str(flight), "flightrec-*coordinated_divergence*"))
    assert len(dumps) == 1
    doc = json.load(open(dumps[0]))
    assert doc["extra"]["worst"] == "divergence"
    assert "FloatingPointError" in doc["extra"]["error"]
    merged = os.path.join(str(flight), "flightrec-merged.json")
    assert json.load(open(merged))["merged"] == 1
