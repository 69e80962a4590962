"""Hang detection — the port of ``tpudp/utils/watchdog.py``.

A wedged collective (a dead peer, a stuck NCCL ring) never returns, so
the hang must be seen from OUTSIDE the blocked call: :class:`Watchdog`
runs a monitor thread that fires when no progress was reported within
its deadline.  It records what was armed and every thread's Python
stack (the port has no XLA state to capture), runs the registered
callbacks (log, emergency dump) and can end the process so that a
scheduler restarts it into ``--checkpoint-dir``'s resume.  The
divergence check (:func:`check_finite`) lives in
``tpudp_torch.utils.finite`` and is re-exported here.

Arming is two monotonic-clock reads and an Event set or clear; no thread
is started per step.  Every armed region carries a name, so a timeout
explains itself.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from typing import Callable

from tpudp_torch.utils.finite import check_finite

__all__ = ["StepHangError", "Watchdog", "check_finite"]


class StepHangError(RuntimeError):
    """Raised in the main thread when a hang was detected and the watchdog
    was told not to kill the process.  ``hang`` carries the detection
    context (region, arm time, the threads' stacks)."""

    def __init__(self, message: str, hang: dict | None = None):
        super().__init__(message)
        self.hang = hang or {}


def _thread_stacks() -> dict[str, str]:
    """Every live thread's Python stack, by thread name."""
    names = {t.ident: t.name for t in threading.enumerate()}
    return {names.get(ident, str(ident)): "".join(
                traceback.format_stack(frame))
            for ident, frame in sys._current_frames().items()}


class Watchdog:
    """Detects training steps that exceed a wall-clock deadline.

    *Heartbeat* (what the Trainer uses — it covers every blocking host
    call in the monitored region)::

        wd = Watchdog(timeout_s=600, on_hang=[dump_fn], kill=True)
        wd.start(); wd.arm("train_epoch")
        for batch in loader:
            state, loss = train_step(state, *batch)
            wd.beat()             # progress: push the deadline out
        wd.disarm(); wd.stop()

    The deadline is ``timeout_s`` after the last beat.  *Scoped*:
    ``with wd.step(timeout_s=5.0, name="fence"): ...`` arms a deadline
    around one region and hands monitoring back to the heartbeat after.

    ``kill=True`` (default) hard-exits the process (code 42) on a hang —
    no Python exception can unwind a wedged collective.  ``kill=False``
    records the hang and raises :class:`StepHangError` at the next
    ``beat()`` or ``step()``; :meth:`arm` or :meth:`acknowledge` clears
    it.  ``last_hang`` keeps the detection context.

    ``flight`` (a :class:`tpudp_torch.obs.FlightRecorder`, usually
    attached by the engine or trainer that owns the watchdog) is dumped
    by the monitor thread the moment a hang is detected — before the
    callbacks and the kill — and the hang context and message carry the
    last span its recorder saw complete."""

    def __init__(self, timeout_s: float = 300.0, *,
                 on_hang: list[Callable[[], None]] | None = None,
                 kill: bool = True, poll_s: float | None = None,
                 flight=None):
        self.timeout_s = timeout_s
        self.on_hang = list(on_hang or [])
        self.kill = kill
        self.poll_s = poll_s if poll_s is not None else min(timeout_s / 4,
                                                            1.0)
        self.flight = flight  # tpudp_torch.obs.FlightRecorder or None
        self.last_hang: dict | None = None
        self._armed = False
        self._deadline: float | None = None
        self._region: tuple[str, float] | None = None  # (name, armed_at)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._hang_seen = threading.Event()
        self._thread: threading.Thread | None = None

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "Watchdog":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._monitor, daemon=True, name="tpudp-watchdog")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # -- heartbeat -------------------------------------------------------
    def arm(self, name: str = "heartbeat") -> None:
        """Begin monitoring: a hang fires if no :meth:`beat` arrives
        within ``timeout_s``.  Re-arming clears a recorded hang."""
        self._hang_seen.clear()
        with self._lock:
            self._armed = True
            self._region = (name, time.monotonic())
            self._deadline = time.monotonic() + self.timeout_s

    def beat(self) -> None:
        """Record progress.  Raises :class:`StepHangError` (``kill=False``)
        if a hang was detected since the last beat; a no-op while
        disarmed."""
        if not self._armed:
            return
        if self._hang_seen.is_set() and not self.kill:
            raise StepHangError(self._hang_message(), self.last_hang)
        with self._lock:
            self._deadline = time.monotonic() + self.timeout_s

    def disarm(self) -> None:
        with self._lock:
            self._armed = False
            self._deadline = None
            self._region = None

    def acknowledge(self) -> bool:
        """Clear a recorded hang once the caller contained it; returns
        whether one had been recorded."""
        seen = self._hang_seen.is_set()
        self._hang_seen.clear()
        return seen

    # -- hang context ------------------------------------------------------
    def _hang_message(self) -> str:
        hang = self.last_hang or {}
        msg = (f"no progress within {hang.get('timeout_s', self.timeout_s)}s"
               f" in armed region '{hang.get('region', 'unarmed')}'")
        armed_for = hang.get("armed_for_s")
        if armed_for is not None:
            msg += f" (armed {armed_for:.3f}s before detection)"
        last = hang.get("last_span")
        if last:
            msg += (f"; last completed span: {last.get('name')!r}"
                    f" at +{last.get('t0', 0):.3f}s")
        return msg

    def _capture_hang(self) -> dict:
        with self._lock:
            region = self._region
        name, armed_at = region if region is not None else ("unarmed", None)
        now = time.monotonic()
        hang = {"region": name, "timeout_s": self.timeout_s,
                "detected_at_monotonic": now,
                "armed_at_monotonic": armed_at,
                "armed_for_s": (now - armed_at
                                if armed_at is not None else None),
                "last_span": None, "stacks": _thread_stacks()}
        if self.flight is not None:
            try:
                hang["last_span"] = self.flight.recorder.last_span()
            except Exception:
                pass
        return hang

    # -- scoped deadlines --------------------------------------------------
    class _Step:
        def __init__(self, wd: "Watchdog", timeout_s: float | None,
                     name: str):
            self.wd = wd
            self.timeout_s = wd.timeout_s if timeout_s is None else timeout_s
            self.name = name
            self._saved: tuple = (None, None)

        def __enter__(self):
            wd = self.wd
            if wd._hang_seen.is_set() and not wd.kill:
                raise StepHangError(
                    "a previous step exceeded its deadline — "
                    + wd._hang_message(), wd.last_hang)
            with wd._lock:
                self._saved = (wd._deadline, wd._region)
                wd._deadline = time.monotonic() + self.timeout_s
                wd._region = (self.name, time.monotonic())
            return self

        def __exit__(self, *exc):
            wd = self.wd
            with wd._lock:
                deadline, region = self._saved
                if wd._armed and deadline is not None:
                    wd._deadline = time.monotonic() + wd.timeout_s
                    wd._region = region
                else:
                    wd._deadline = None
                    wd._region = None
            return False

    def step(self, timeout_s: float | None = None,
             name: str = "step") -> "_Step":
        """A scoped deadline; ``timeout_s`` overrides the default for this
        one region and ``name`` labels it in the hang report."""
        if timeout_s is not None and timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
        return Watchdog._Step(self, timeout_s, name)

    # -- monitor -----------------------------------------------------------
    def _monitor(self) -> None:
        while not self._stop.wait(self.poll_s):
            with self._lock:
                deadline = self._deadline
            if deadline is not None and time.monotonic() > deadline:
                self.last_hang = self._capture_hang()
                self._hang_seen.set()
                if self.flight is not None:
                    # The black box first: a callback may be the kill
                    # path, and kill=True never returns.
                    try:
                        self.flight.dump(
                            "watchdog_timeout_"
                            + str(self.last_hang.get("region")),
                            extra=self.last_hang)
                    except Exception:
                        pass
                for cb in self.on_hang:
                    try:
                        cb()
                    except Exception:
                        pass
                if self.kill:
                    os._exit(42)
                with self._lock:  # do not fire again until re-armed
                    self._deadline = None
