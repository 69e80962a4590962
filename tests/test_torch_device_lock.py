"""The port's card lock (``tpudp_torch/utils/device_lock.py``) against the
JAX package's ``tpu_client_lock`` and ``acquire_for_process`` on the same
scenarios, each package on its own lock file.

A free lock yields True and is released; a lock another open file
description holds (``flock`` makes two opens conflict even in one
process) yields False after the timeout; an inherited holder passes, and
for the port only for the cards it holds; an unopenable lock file yields
True with a warning; ``acquire_for_process`` exits 2 on a busy card,
naming the lock file, is idempotent and skips the CPU; a second
``main``-style call in the holder's process keeps its lock and its
environment.  Then every entry point of the port takes the lock (after
pointing its builds at the compile cache) and, on the CPU, takes none.
"""

import fcntl
import os
import time

import pytest
import torch

from tpudp.utils import device_lock as jax_lock
from tpudp_torch.utils import device_lock

CARD = device_lock.card_key(0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite's workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    """No lock inherited or held by this process, in either package, and
    the port's lock directory under this test's tmp_path."""
    monkeypatch.delenv(jax_lock.HELD_ENV, raising=False)
    monkeypatch.delenv(device_lock.HELD_ENV, raising=False)
    monkeypatch.setenv(device_lock.DIR_ENV, str(tmp_path / "locks"))
    monkeypatch.setattr(jax_lock, "_PROCESS_LOCK", None)
    monkeypatch.setattr(device_lock, "_PROCESS_LOCKS", {})
    yield
    if jax_lock._PROCESS_LOCK is not None:
        jax_lock._PROCESS_LOCK.__exit__(None, None, None)
    for ctx in device_lock._PROCESS_LOCKS.values():
        ctx.__exit__(None, None, None)


@pytest.fixture()
def paths(tmp_path):
    return str(tmp_path / "jax.lock"), str(tmp_path / "torch.lock")


def hold(path):
    """Another open file description holding ``path``'s flock."""
    f = open(path, "w")
    fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
    return f


def free(path) -> bool:
    with open(path, "w") as f:
        try:
            fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            return False
        return True


def test_free_lock_yields_true_and_releases(paths):
    pj, pt = paths
    with jax_lock.tpu_client_lock(path=pj) as a, \
            device_lock.card_lock(0, path=pt) as b:
        assert (a, b) == (True, True)
        assert os.environ[jax_lock.HELD_ENV] == "1"
        assert device_lock.held_cards() == {CARD}
        assert not free(pj) and not free(pt)
    assert free(pj) and free(pt)
    assert jax_lock.HELD_ENV not in os.environ
    assert device_lock.HELD_ENV not in os.environ


@pytest.mark.parametrize("timeout", [0.0, 1.0])
def test_held_lock_yields_false_after_timeout(paths, timeout):
    pj, pt = paths
    holders = [hold(pj), hold(pt)]
    try:
        for ctx in (jax_lock.tpu_client_lock(timeout=timeout, path=pj),
                    device_lock.card_lock(0, timeout=timeout, path=pt)):
            t0 = time.monotonic()
            with ctx as mine:
                assert mine is False
            waited = time.monotonic() - t0
            assert timeout <= waited < timeout + 5.0
    finally:
        for f in holders:
            f.close()


def test_inherited_holder_passes_for_its_cards_only(paths, monkeypatch):
    pj, pt = paths
    holders = [hold(pj), hold(pt)]
    try:
        monkeypatch.setenv(jax_lock.HELD_ENV, "1")
        monkeypatch.setenv(device_lock.HELD_ENV, f"other-card,{CARD}")
        with jax_lock.tpu_client_lock(path=pj) as a, \
                device_lock.card_lock(0, path=pt) as b:
            assert (a, b) == (True, True)
        # JAX's flag covers its one device; the port's names cards, and a
        # holder of another card does not pass for this one.
        monkeypatch.setenv(device_lock.HELD_ENV, "other-card")
        with device_lock.card_lock(0, path=pt) as b:
            assert b is False
    finally:
        for f in holders:
            f.close()


def test_unopenable_lock_file_yields_true_with_a_warning(tmp_path, capsys):
    blocker = tmp_path / "blocker"  # a regular file as the parent
    blocker.write_text("")
    with jax_lock.tpu_client_lock(path=str(blocker / "lock")) as a, \
            device_lock.card_lock(0, path=str(blocker / "lock")) as b:
        assert (a, b) == (True, True)
    err = capsys.readouterr().err
    assert err.count("WITHOUT single-client protection") == 2


def test_acquire_for_process_busy_exits_2_naming_the_file(paths, capsys):
    pj, pt = paths
    holders = [hold(pj), hold(pt)]
    try:
        with pytest.raises(SystemExit) as a:
            jax_lock.acquire_for_process(path=pj, force=True)
        with pytest.raises(SystemExit) as b:
            device_lock.acquire_for_process(0, path=pt)
        assert a.value.code == b.value.code == 2
        err = capsys.readouterr().err
        assert pj in err and pt in err
        assert jax_lock._PROCESS_LOCK is None
        assert device_lock._PROCESS_LOCKS == {}
        assert device_lock.HELD_ENV not in os.environ
    finally:
        for f in holders:
            f.close()


def test_acquire_for_process_is_idempotent_and_holds(paths):
    pj, pt = paths
    for _ in range(2):
        jax_lock.acquire_for_process(path=pj, force=True)
        device_lock.acquire_for_process(0, path=pt)
    assert jax_lock._PROCESS_LOCK is not None
    assert list(device_lock._PROCESS_LOCKS) == [CARD]
    assert not free(pj) and not free(pt)


def test_default_lock_file_is_shared_by_key(tmp_path):
    assert device_lock.lock_dir() == str(tmp_path / "locks")
    assert device_lock.lock_path(0) == str(
        tmp_path / "locks" / f"card-{CARD}.lock")
    device_lock.acquire_for_process(0)
    assert not free(device_lock.lock_path(0))


def test_cpu_device_skips(paths):
    pj, pt = paths
    jax_lock.acquire_for_process(path=pj)  # the suite pins jax to cpu
    device_lock.acquire_for_process("cpu", path=pt)
    device_lock.acquire_for_process(torch.device("cpu"), path=pt)
    device_lock.acquire_for_process(0, skip=True, path=pt)
    assert jax_lock._PROCESS_LOCK is None
    assert device_lock._PROCESS_LOCKS == {}
    assert free(pj) and free(pt)
    device_lock.acquire_for_process("cpu", path=pt, force=True)
    assert not free(pt)


def test_second_main_call_keeps_the_holders_lock_and_env(paths):
    """A CLI's main called again in the holder's process: neither takes
    nor releases the lock, nor clears the environment its children
    inherit."""
    pj, pt = paths
    jax_lock.acquire_for_process(path=pj, force=True)
    device_lock.acquire_for_process(0, path=pt)
    env = (os.environ[jax_lock.HELD_ENV], os.environ[device_lock.HELD_ENV])
    jax_lock.acquire_for_process(path=pj, force=True)
    device_lock.acquire_for_process(0, path=pt)
    with jax_lock.tpu_client_lock(path=pj) as a, \
            device_lock.card_lock(0, path=pt) as b:
        assert (a, b) == (True, True)
    assert (os.environ[jax_lock.HELD_ENV],
            os.environ[device_lock.HELD_ENV]) == env == ("1", CARD)
    assert not free(pj) and not free(pt)


# -- every entry point takes it, after choosing the build directory --------

class Stop(Exception):
    """Ends an entry point right after its lock."""


def _entry_points():
    from tpudp_torch import (cli, generate_cli, serve_cli, train_cli,
                             train_resnet, train_vit)
    from tpudp_torch.parts import part1

    return {"serve_cli": (serve_cli, serve_cli.main),
            "generate_cli": (generate_cli, generate_cli.main),
            "train_cli": (train_cli, train_cli.main),
            "train_resnet": (train_resnet, train_resnet.main),
            "train_vit": (train_vit, train_vit.main),
            "cli.run_part": (cli, part1.main)}


@pytest.mark.parametrize("name", ["serve_cli", "generate_cli", "train_cli",
                                  "train_resnet", "train_vit",
                                  "cli.run_part"])
def test_entry_point_locks_after_the_cache_and_not_on_cpu(name,
                                                          monkeypatch):
    module, main = _entry_points()[name]
    seen = []

    def cache(*a, **kw):
        seen.append("cache")

    def lock(device, *a, **kw):
        seen.append(("lock", torch.device(device).type))
        device_lock.acquire_for_process(device, *a, **kw)
        raise Stop

    monkeypatch.setattr(module, "enable_persistent_cache", cache)
    monkeypatch.setattr(module, "acquire_for_process", lock)
    with pytest.raises(Stop):
        main(["--device", "cpu"])
    assert seen == ["cache", ("lock", "cpu")]
    assert device_lock._PROCESS_LOCKS == {}
    assert device_lock.HELD_ENV not in os.environ
