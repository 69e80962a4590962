"""The port's serving robustness layer against the JAX engine's: the
single-model cases of tests/test_serve_robustness.py, each driven by one
scenario function through both packages' ``Engine``, ``faults`` and
``Watchdog`` on one weight tree (``params_from_jax``), whose outcomes
(tokens, finish reasons, counters) must be equal.

Covered: bounded admission, deadlines, drafter quarantine (raising,
malformed, slow, blocking under the watchdog), step-failure containment
(transient, persistent -> ``ERROR``, in a prefill, in a fused decode
window, an unbacked page), the watchdog catching a wedged step, drain
and close, ``generate_many``'s cleanup, cancel from a token iterator,
and the serving canary.  A sampled request requeued by a step fault
resumes exactly (each package against its own unfaulted run: their
generators differ).
"""

import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpudp.serve as jax_serve
import tpudp.serve.faults as jax_faults
import tpudp_torch.serve as port_serve
import tpudp_torch.serve.faults as port_faults
from tpudp.models.gpt2 import gpt2_small as jax_gpt2_small
from tpudp.utils.watchdog import Watchdog as JaxWatchdog
from tpudp_torch.models import gpt2
from tpudp_torch.utils.watchdog import Watchdog as PortWatchdog

TINY = dict(vocab_size=256, max_seq_len=64, num_layers=2, num_heads=2,
            d_model=64)
GEOMETRY = dict(num_slots=2, max_len=32, prefill_chunk=8)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite's workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def sides():
    """Each package's engine factory and robustness modules, on one
    weight tree; both warmed on the geometry's single-step programs."""
    tree = gpt2.random_params(gpt2.GPT2Config(**TINY), seed=7)
    model = gpt2.GPT2(gpt2.GPT2Config(**TINY))
    model.load_state_dict(gpt2.params_from_jax(tree))
    jmodel = jax_gpt2_small(**TINY)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)

    def side(serve, faults, watchdog, make):
        def engine(**kw):
            kw = {**GEOMETRY, **kw}
            return make(**kw)
        return SimpleNamespace(engine=engine, serve=serve, faults=faults,
                               Watchdog=watchdog)

    out = {"jax": side(jax_serve, jax_faults, JaxWatchdog,
                       lambda **kw: jax_serve.Engine(jmodel, jparams, **kw)),
           "port": side(port_serve, port_faults, PortWatchdog,
                        lambda **kw: port_serve.Engine(model, device="cpu",
                                                       **kw))}
    # JAX compiles a program at its first call, which the watchdog
    # scenarios would time: warm the geometries they use.
    loop = np.tile(np.arange(1, 4, dtype=np.int32), 3)
    for x in out.values():
        for kw in ({}, dict(num_slots=1),
                   dict(speculate_k=2, drafter=x.serve.NgramDrafter())):
            x.engine(**kw).generate_many([loop], 4)
    return out


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, 256, size=n).astype(
        np.int32)


def _reference(x, prompt, n):
    return x.engine().generate_many([prompt], n)[0][prompt.size:].tolist()


def _outcome(handles):
    return [(h.finish_reason.value if h.finish_reason else None,
             list(h.tokens)) for h in handles]


def _stats(eng, *names):
    return {n: eng.stats[n] for n in names}


# -- scenarios: each returns what both packages must agree on -----------


def queue_limit_sheds(x):
    p = _prompt(0, 4)
    eng = x.engine(num_slots=1, queue_limit=2)
    h1, h2 = eng.submit(p, 3), eng.submit(p, 3)
    with pytest.raises(x.serve.QueueFull, match="queue_limit"):
        eng.submit(p, 3)
    eng.step()  # admits h1: the queue is under its limit again
    h3 = eng.submit(p, 3)
    eng.run_until_complete()
    return _outcome([h1, h2, h3]), _stats(eng, "shed")


def ttft_deadline_expires_queued(x):
    p = _prompt(1, 4)
    eng = x.engine(num_slots=1)
    h1 = eng.submit(p, 6)
    eng.step()  # h1 takes the only slot
    h2 = eng.submit(p, 3, ttft_deadline_s=1e-6)
    time.sleep(0.002)
    eng.step()
    assert h2.done and h2._slot is None
    with pytest.raises(x.serve.RequestFailed, match="deadline"):
        h2.result()
    eng.run_until_complete()
    return _outcome([h1, h2]), _stats(eng, "deadline_expired")


def deadline_mid_flight(x):
    p1, p2 = _prompt(2, 4), _prompt(3, 9)
    eng = x.engine(num_slots=1)
    h1 = eng.submit(p1, 20, deadline_s=1.5)
    h2 = eng.submit(p2, 4)
    while len(h1.tokens) < 2 and not h1.done:
        eng.step()
    assert not h1.done
    time.sleep(1.6)  # h1's budget runs out mid-flight
    eng.step()
    partial = list(h1.tokens)
    eng.run_until_complete()
    assert h1.tokens == partial and len(partial) >= 2
    assert eng.slots_in_use == 0 and eng.queue_depth == 0
    return (h1.finish_reason.value, _outcome([h2]),
            _stats(eng, "deadline_expired"), partial[:2])


def ttft_deadline_stops_after_first_token(x):
    p = _prompt(4, 4)
    eng = x.engine(num_slots=1)
    h = eng.submit(p, 4, ttft_deadline_s=5.0)
    while not h.tokens:
        eng.step()
    eng.run_until_complete()
    return _outcome([h])


def deadline_validation(x):
    eng = x.engine()
    p = np.zeros(4, np.int32)
    for kw, name in ((dict(deadline_s=0.0), "deadline_s"),
                     (dict(ttft_deadline_s=-1.0), "ttft_deadline_s")):
        with pytest.raises(ValueError, match=name):
            eng.submit(p, 2, **kw)
    for kw, name in ((dict(queue_limit=0), "queue_limit"),
                     (dict(drafter_timeout_s=0.0), "drafter_timeout_s"),
                     (dict(step_timeout_s=-1.0), "step_timeout_s"),
                     (dict(canary_every_s=-1.0), "canary_every_s"),
                     (dict(canary_every_s=1.0, canary_new_tokens=0),
                      "canary_new_tokens")):
        with pytest.raises(ValueError, match=name):
            x.engine(**kw)
    return True


def _spec_run(x, eng, prompts, new):
    handles = [eng.submit(p, n) for p, n in zip(prompts, new)]
    eng.run_until_complete()
    return _outcome(handles)


def raising_drafter(x):
    rng = np.random.default_rng(4)
    prompts = [np.tile(rng.integers(0, 256, size=3), 4)[:9].astype(np.int32)
               for _ in range(3)]
    eng = x.engine(speculate_k=2, drafter=x.faults.FailingDrafter(
        inner=x.serve.NgramDrafter(), ok_proposals=2))
    out = _spec_run(x, eng, prompts, [6, 6, 6])
    assert eng.drafter_quarantined
    assert "InjectedFault" in eng.drafter_quarantine_reason
    verify_steps = eng.stats["verify_steps"]
    out2 = _spec_run(x, eng, prompts[:1], [4])
    assert eng.stats["verify_steps"] == verify_steps  # for good
    return out, out2, _stats(eng, "drafter_quarantined", "verify_steps")


def malformed_drafters(x):
    outs = []
    for mode in x.faults.MalformedDrafter.MODES:
        eng = x.engine(speculate_k=3,
                       drafter=x.faults.MalformedDrafter(mode))
        outs.append(_spec_run(x, eng, [_prompt(5, 5)], [6]))
        assert eng.drafter_quarantined
    eng = x.engine(speculate_k=2,
                   drafter=x.faults.MalformedDrafter("out_of_vocab"))
    h = eng.submit(_prompt(6, 5), 4)
    eng.run_until_complete()
    assert h.draft_proposed > 0 and h.draft_accepted == 0
    assert h.acceptance_rate == 0.0 and eng.acceptance_rate == 0.0
    return outs, h.draft_proposed


def slow_drafter(x):
    eng = x.engine(speculate_k=2, drafter_timeout_s=0.01,
                   drafter=x.faults.SlowDrafter(0.05))
    out = _spec_run(x, eng, [_prompt(7, 5)], [5])
    assert eng.drafter_quarantined
    assert "drafter_timeout_s" in eng.drafter_quarantine_reason
    return out


def blocking_drafter_under_watchdog(x):
    # The deadline also guards every device call, so it sits far above a
    # step's time on a loaded CPU: the one hang is the propose's.
    wd = x.Watchdog(timeout_s=1.0, kill=False, poll_s=0.05).start()
    try:
        eng = x.engine(speculate_k=2, watchdog=wd, step_timeout_s=1.0,
                       drafter=x.faults.SlowDrafter(2.5))
        out = _spec_run(x, eng, [_prompt(18, 5)], [5])
        assert eng.drafter_quarantined
        assert "watchdog deadline" in eng.drafter_quarantine_reason
    finally:
        wd.stop()
    return out, _stats(eng, "step_failures")


def transient_step_fault(x):
    prompts = [_prompt(8, n) for n in (5, 9, 3)]
    hook = x.faults.FaultySteps(fail_at={6})
    eng = x.engine(step_fault_hook=hook)
    out = _spec_run(x, eng, prompts, [6, 5, 7])
    assert eng.slots_in_use == 0 and eng.queue_depth == 0
    return (out, hook.fired,
            _stats(eng, "step_failures", "requeued", "errors"))


def persistent_step_fault(x):
    p = _prompt(10, 4)
    hook = x.faults.FaultySteps(fail_at=set(range(200)), kind="decode")
    eng = x.engine(num_slots=1, step_fault_hook=hook)
    h = eng.submit(p, 6)
    eng.run_until_complete()
    assert isinstance(h.error, x.faults.InjectedFault)
    with pytest.raises(x.serve.RequestFailed, match="error"):
        h.result()
    eng.step_fault_hook = None  # the store was never wedged
    h2 = eng.submit(p, 6)
    eng.run_until_complete()
    return (_outcome([h, h2]),
            _stats(eng, "errors", "requeued", "step_failures"))


def prefill_step_fault(x):
    p = _prompt(11, 20)  # 3 chunks
    hook = x.faults.FaultySteps(fail_at={1}, kind="prefill")
    eng = x.engine(num_slots=1, max_len=48, step_fault_hook=hook)
    h = eng.submit(p, 5)
    eng.run_until_complete()
    return _outcome([h]), _stats(eng, "step_failures", "requeued")


def fused_window_step_fault(x):
    """A fault at the first fused decode window: contained, then the
    same window serves every request to the unfaulted tokens."""
    prompts = [_prompt(20, n) for n in (5, 7)]
    hook = x.faults.FaultySteps(fail_at=set(), kind="fused_decode")

    def first_window(kind, index):
        if kind == "fused_decode" and not hook.fired:
            hook.fail_at.add(index)
        hook(kind, index)

    eng = x.engine(decode_fuse=4, kv_pages=8, step_fault_hook=first_window)
    out = _spec_run(x, eng, prompts, [9, 9])
    eng.check_paged()
    return (out, [k for k, _ in hook.fired],
            _stats(eng, "step_failures", "requeued", "errors"),
            eng.stats["fused_windows"] > 0)


def unbacked_page_is_error(x, monkeypatch):
    """A pool that cannot back a slot (ruled out by kv_pages's
    validation, forced here) retires the request with ERROR instead of
    writing to the scratch page."""
    eng = x.engine(kv_pages=8)
    h1 = eng.submit(_prompt(21, 5), 8)
    eng.step()
    monkeypatch.setattr(eng, "_alloc_page", lambda ms, protect: None)
    h2 = eng.submit(_prompt(22, 12), 4)
    eng.run_until_complete()
    monkeypatch.undo()
    eng.check_paged()
    return (_outcome([h1]), h2.finish_reason.value,
            "page pool exhausted" in str(h2.error), _stats(eng, "errors"))


def drain_and_close(x):
    prompts = [_prompt(12, n) for n in (4, 7, 5)]
    eng = x.engine(num_slots=1)
    handles = [eng.submit(p, 4) for p in prompts]
    eng.step()  # one in flight, two queued
    eng.drain()
    assert eng.closed and not eng.accepting
    with pytest.raises(x.serve.EngineClosed, match="no longer accepts"):
        eng.submit(prompts[0], 2)
    assert eng.step() == []
    eng.drain()  # idempotent
    p = _prompt(13, 4)
    eng2 = x.engine(num_slots=1)
    hs = [eng2.submit(p, 10), eng2.submit(p, 3), eng2.submit(p, 3)]
    while not hs[0].tokens:
        eng2.step()
    eng2.close()
    assert eng2.slots_in_use == 0 and eng2.queue_depth == 0
    with pytest.raises(x.serve.EngineClosed):
        eng2.submit(p, 2)
    eng2.close()
    return (_outcome(handles), [h.finish_reason.value for h in hs],
            _stats(eng2, "shed", "cancelled"))


def generate_many_cleans_up(x):
    good = _prompt(14, 4)
    eng = x.engine()
    with pytest.raises(ValueError, match="prompt"):
        eng.generate_many([good, good, np.zeros(0, np.int32)], 3)
    assert eng.queue_depth == 0 and eng.slots_in_use == 0
    return _stats(eng, "cancelled"), eng.generate_many([good], 3)[0].tolist()


def cancel_from_token_iterator(x):
    p1, p2, p3 = _prompt(15, 4), _prompt(16, 6), _prompt(17, 9)
    eng = x.engine(num_slots=1)
    h1, h2, h3 = eng.submit(p1, 8), eng.submit(p2, 5), eng.submit(p3, 4)
    streamed = []
    for tok in h1:
        streamed.append(tok)
        if len(streamed) == 2:
            assert h2.cancel() is True and h1.cancel() is True
    assert h1.cancelled and streamed == h1.tokens
    eng.run_until_complete()
    return (_outcome([h1, h2, h3]),
            _stats(eng, "cancelled", "completed", "admitted"))


def watchdog_catches_wedged_step(x):
    p = _prompt(16, 4)
    # A deadline far above a step's time on a loaded CPU: the one hang is
    # the stall's.
    wd = x.Watchdog(timeout_s=1.0, kill=False, poll_s=0.05).start()
    try:
        eng = x.engine(num_slots=1, watchdog=wd, step_timeout_s=1.0,
                       step_fault_hook=x.faults.SlowSteps(stall_at={3},
                                                          delay_s=2.5))
        h = eng.submit(p, 6)
        eng.run_until_complete()  # must end: a wedge is the one failure
        assert eng.stats["step_failures"] >= 1 and h.done
        eng.step_fault_hook = None
        h2 = eng.submit(p, 4)
        eng.run_until_complete()
    finally:
        wd.stop()
    return _outcome([h2]), h.ok == (h.finish_reason.value == "complete")


def finish_reasons(x):
    p = _prompt(17, 5)
    ref = _reference(x, p, 8)
    eng = x.engine()
    h_full = eng.submit(p, 8)
    h_eos = eng.submit(p, 8, eos_id=int(ref[2]))
    eng.run_until_complete()
    assert h_full.ok and h_eos.ok and h_eos.result()[-1] == ref[2]
    return _outcome([h_full, h_eos]), _stats(eng, "completed")


def canary_runs_clean(x):
    p = _prompt(0, 4)
    eng = x.engine(canary_every_s=0.0, canary_new_tokens=4)
    hs = [eng.submit(p, 5) for _ in range(3)]
    emitted = []
    while eng.queue_depth or eng.slots_in_use:
        emitted += eng.step()
    for _ in range(40):
        emitted += eng.step()
    m = eng.metrics()["canary"]
    assert m["runs"] >= 2 and m["ref_pinned"]
    assert not any(getattr(r, "_canary", False) for r, _ in emitted)
    return _outcome(hs), (m["mismatch"], m["quarantined"])


def canary_mismatch_quarantines(x):
    inj = x.faults.BitFlipLogits([(5, None, 3)], vocab=256, canary_only=True)
    eng = x.engine(canary_every_s=0.0, canary_new_tokens=4,
                   token_fault_hook=inj)
    live = eng.submit(_prompt(0, 4), 20, seed=7)
    for _ in range(200):
        if eng.quarantined:
            break
        eng.step()
    m = eng.metrics()["canary"]
    assert "canary" in eng.quarantine_reason
    assert live.finish_reason is None and eng.slots_in_use >= 1
    with pytest.raises(x.serve.EngineClosed):
        eng.submit(_prompt(0, 4), 3)
    assert eng.step() == []
    return (m["mismatch"], m["quarantined"], inj.fired,
            eng.quarantine_reason)


def canary_loud_failure(x):
    eng = x.engine(canary_every_s=0.0, canary_new_tokens=4,
                   step_fault_hook=x.faults.FaultySteps(
                       fail_at=set(range(1, 200))))
    for _ in range(30):
        eng.step()
    m = eng.metrics()["canary"]
    return m["errors"] >= 1, m["mismatch"], eng.quarantined


SCENARIOS = [queue_limit_sheds, ttft_deadline_expires_queued,
             deadline_mid_flight, ttft_deadline_stops_after_first_token,
             deadline_validation, raising_drafter, malformed_drafters,
             slow_drafter, blocking_drafter_under_watchdog,
             transient_step_fault, persistent_step_fault,
             prefill_step_fault, fused_window_step_fault,
             unbacked_page_is_error, drain_and_close,
             generate_many_cleans_up, cancel_from_token_iterator,
             watchdog_catches_wedged_step, finish_reasons,
             canary_runs_clean, canary_mismatch_quarantines,
             canary_loud_failure]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_port_matches_jax(sides, scenario, monkeypatch):
    kw = ({"monkeypatch": monkeypatch}
          if "monkeypatch" in scenario.__code__.co_varnames else {})
    got = {name: scenario(x, **kw) for name, x in sides.items()}
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("fuse", [1, 4])
def test_sampled_request_resumes_exactly_after_a_step_fault(sides, fuse):
    """The requeue carries the slot's generator state: a sampled request
    survives a fault at its second decode step, or its second fused
    decode window (the first window's commits took the window's
    generator state), with its unfaulted tokens."""
    x = sides["port"]
    p = _prompt(9, 5)
    kind = "decode" if fuse == 1 else "fused_decode"

    def tokens_of(hook):
        eng = x.engine(num_slots=1, decode_fuse=fuse, step_fault_hook=hook)
        h = eng.submit(p, 14, temperature=0.9, top_k=12, seed=7)
        eng.run_until_complete()
        assert h.ok
        return list(h.tokens), eng.stats["step_failures"]

    hook = x.faults.FaultySteps(fail_at=set(), kind=kind)

    def second(k, index):
        if k == kind and len(second.seen) < 2:
            second.seen.append(index)
            if len(second.seen) == 2:
                hook.fail_at.add(index)
        hook(k, index)

    second.seen = []
    clean, _ = tokens_of(None)
    assert tokens_of(second) == (clean, 1) and hook.fired


def test_bitflip_schedule_equals_jax():
    """The injector's schedule (eligible calls only, one firing, always
    in vocab and different) gives JAX's corruptions call for call."""

    class _R:
        _canary = False

    canary, user = _R(), _R()
    canary._canary = True
    runs = []
    for faults in (jax_faults, port_faults):
        inj = faults.BitFlipLogits([(1, None, 3), (2, 1, 6)], vocab=61,
                                   canary_only=True)
        runs.append([inj(s, t, r) for s, t, r in
                     ((0, 7, user), (0, 7, canary), (2, 7, canary),
                      (1, 60, canary), (1, 60, canary))] + [inj.fired])
    assert runs[0] == runs[1]
    assert runs[1][2] != 7 and runs[1][3] != 60
