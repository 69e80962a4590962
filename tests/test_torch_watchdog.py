"""The port's hang watchdog (``tpudp_torch.utils.watchdog``) beside the
JAX package's (``tpudp/utils/watchdog.py``), on the CPU.

``tests/test_watchdog.py``'s cases run against both implementations
(parametrized ``impl``): the same arming, heartbeats, deadlines,
callbacks, re-arming and acknowledgement give the same observable
outcome.  The port's own cases: its hang record carries the threads'
Python stacks (there is no XLA state to capture), a hang leaves a
restorable emergency dump, a dump without its sentinel or state file is
ignored, and a ``kill=True`` hang ends a child process with code 42.
"""

import os
import subprocess
import sys
import time

import pytest
import torch

import tpudp.utils.watchdog as jax_watchdog
import tpudp_torch.utils.watchdog as port_watchdog
from tpudp_torch.utils import checkpoint as ck

IMPLS = {"port": port_watchdog, "jax": jax_watchdog}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(params=sorted(IMPLS))
def wdm(request):
    return IMPLS[request.param]


def test_fast_steps_never_trip(wdm):
    wd = wdm.Watchdog(timeout_s=0.5, kill=False, poll_s=0.02).start()
    try:
        for _ in range(20):
            with wd.step():
                pass
    finally:
        wd.stop()
    assert not wd._hang_seen.is_set()


def test_hang_detected_and_callbacks_fire(wdm):
    fired = []
    wd = wdm.Watchdog(timeout_s=0.1, kill=False, poll_s=0.02,
                      on_hang=[lambda: fired.append("dump")]).start()
    try:
        with wd.step():
            time.sleep(0.4)
        with pytest.raises(wdm.StepHangError):
            with wd.step():
                pass
    finally:
        wd.stop()
    assert fired == ["dump"]


def test_callback_exception_does_not_break_monitor(wdm):
    def boom():
        raise RuntimeError("cb failed")

    fired = []
    wd = wdm.Watchdog(timeout_s=0.1, kill=False, poll_s=0.02,
                      on_hang=[boom, lambda: fired.append("second")]).start()
    try:
        with wd.step():
            time.sleep(0.4)
    finally:
        wd.stop()
    assert fired == ["second"]


def test_idle_periods_are_not_hangs(wdm):
    wd = wdm.Watchdog(timeout_s=0.1, kill=False, poll_s=0.02).start()
    try:
        time.sleep(0.3)
        with wd.step():
            pass
    finally:
        wd.stop()
    assert not wd._hang_seen.is_set()


def test_heartbeat_mode_covers_slow_gaps(wdm):
    wd = wdm.Watchdog(timeout_s=0.15, kill=False, poll_s=0.02).start()
    try:
        wd.arm()
        for _ in range(5):
            time.sleep(0.05)
            wd.beat()
        assert not wd._hang_seen.is_set()
        time.sleep(0.4)
        with pytest.raises(wdm.StepHangError, match="armed region"):
            wd.beat()
        wd.disarm()
    finally:
        wd.stop()


def test_disarmed_idle_is_not_a_hang(wdm):
    wd = wdm.Watchdog(timeout_s=0.1, kill=False, poll_s=0.02).start()
    try:
        wd.arm()
        wd.beat()
        wd.disarm()
        time.sleep(0.3)
        assert not wd._hang_seen.is_set()
    finally:
        wd.stop()


def test_beat_is_noop_when_unarmed(wdm):
    wd = wdm.Watchdog(timeout_s=0.1, kill=False, poll_s=0.02).start()
    try:
        wd.beat()
        time.sleep(0.3)
        assert not wd._hang_seen.is_set()
        wd.arm()
        wd.disarm()
        wd.beat()
        time.sleep(0.3)
        assert not wd._hang_seen.is_set()
    finally:
        wd.stop()


def test_rearm_after_handled_hang(wdm):
    wd = wdm.Watchdog(timeout_s=0.1, kill=False, poll_s=0.02).start()
    try:
        wd.arm()
        time.sleep(0.4)
        with pytest.raises(wdm.StepHangError):
            wd.beat()
        wd.disarm()
        wd.arm()
        wd.beat()
        assert not wd._hang_seen.is_set()
        wd.disarm()
    finally:
        wd.stop()


def test_scoped_timeout_override_and_acknowledge(wdm):
    wd = wdm.Watchdog(timeout_s=10.0, kill=False, poll_s=0.01).start()
    try:
        with wd.step(timeout_s=0.05):
            time.sleep(0.2)
        assert wd._hang_seen.is_set()
        assert wd.acknowledge() is True
        assert wd.acknowledge() is False
        with wd.step(timeout_s=0.05):
            pass
        with wd.step():
            pass
        with pytest.raises(ValueError, match="timeout_s"):
            wd.step(timeout_s=0.0)
    finally:
        wd.stop()


def test_check_finite(wdm):
    assert wdm.check_finite(1.25) == 1.25
    with pytest.raises(FloatingPointError, match="step 7"):
        wdm.check_finite(float("nan"), step=7)
    with pytest.raises(FloatingPointError):
        wdm.check_finite(float("inf"))


def test_hang_record_carries_python_stacks():
    """The port's hang capture: region, timing and every thread's stack
    (the stalled main thread's shows where it sleeps)."""
    wd = port_watchdog.Watchdog(timeout_s=0.1, kill=False,
                                poll_s=0.02).start()
    try:
        wd.arm("train_epoch")
        time.sleep(0.4)
        with pytest.raises(port_watchdog.StepHangError) as ei:
            wd.beat()
    finally:
        wd.stop()
    hang = ei.value.hang
    assert hang["region"] == "train_epoch" and hang["armed_for_s"] >= 0.1
    assert "MainThread" in hang["stacks"]
    assert "test_hang_record_carries_python_stacks" in \
        hang["stacks"]["MainThread"]


def test_hang_leaves_restorable_emergency_checkpoint(tmp_path):
    """A detected hang dumps the live state to an emergency checkpoint
    that restores bit for bit (the kill=False form of the CLI's wiring)."""
    import torch_dp_worker as w
    from tpudp_torch import train

    state = train.init_state(w.bn_model("vgg"),
                             train.make_optimizer(**w.SGD))
    root = str(tmp_path)

    def dump():
        ck.clear_emergency_sentinel(root)
        ck.save_checkpoint(f"{root}/emergency", state)
        ck.write_emergency_sentinel(root, step=state.step)

    wd = port_watchdog.Watchdog(timeout_s=0.1, kill=False, poll_s=0.02,
                                on_hang=[dump]).start()
    try:
        wd.arm()
        time.sleep(0.4)
        with pytest.raises(port_watchdog.StepHangError):
            wd.beat()
    finally:
        wd.stop()
    path = ck.emergency_dir(root)
    assert path is not None
    fresh = train.init_state(w.bn_model("vgg"),
                             train.make_optimizer(**w.SGD))
    with torch.no_grad():
        for p in fresh.model.parameters():
            p.zero_()
    ck.restore_checkpoint(path, fresh, verify=True)
    for a, b in zip(state.model.state_dict().values(),
                    fresh.model.state_dict().values()):
        assert torch.equal(a, b)


def test_truncated_emergency_dump_is_ignored(tmp_path, capsys):
    """A dump without its sentinel and without a whole state file is
    ignored, moved aside once, and the resume falls back to the series;
    the sentinel (or a whole state file) makes a dump count."""
    root = str(tmp_path)
    os.makedirs(os.path.join(root, "emergency"))
    with open(os.path.join(root, "emergency", "state.pt.tmp"), "w") as f:
        f.write("garbage")
    assert ck.emergency_dir(root) is None
    assert "no completion sentinel" in capsys.readouterr().out
    assert os.path.isdir(os.path.join(root, "emergency.truncated"))
    assert ck.emergency_dir(root) is None
    assert "WARNING" not in capsys.readouterr().out
    os.makedirs(os.path.join(root, "emergency"))
    ck.write_emergency_sentinel(root, step=3)
    assert ck.emergency_dir(root) is not None
    ck.clear_emergency_sentinel(root)
    assert ck.emergency_dir(root) is None
    ck.clear_emergency_sentinel(root)  # idempotent
    os.makedirs(os.path.join(root, "emergency"))
    open(os.path.join(root, "emergency", ck.STATE_FILE), "w").close()
    assert ck.emergency_dir(root) is not None


def test_kill_ends_the_process_with_code_42():
    """``kill=True``: a hang runs the callbacks, then ends the process
    (no Python exception can unwind a wedged collective)."""
    code = ("import time\n"
            "from tpudp_torch.utils.watchdog import Watchdog\n"
            "wd = Watchdog(timeout_s=0.2, poll_s=0.02, on_hang=[lambda: "
            "print('dumped', flush=True)]).start()\n"
            "wd.arm()\n"
            "time.sleep(5)\n"
            "print('not reached')\n")
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=60)
    assert done.returncode == 42
    assert done.stdout.split() == ["dumped"]
